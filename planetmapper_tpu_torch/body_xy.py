"""
BodyXY: the pixel/backplane render core (port of ``planetmapper_tpu.body_xy``).

This slice ports the constructor, the disc-parameter interface, the
pixel -> angular affine and the fused 26-backplane pipeline
(:func:`BodyXY.generate_backplanes_fused`, which runs
:func:`..pipeline.compute_backplanes`). The backplane registry,
``get_backplane_img``/``map_img`` and the matplotlib transforms are listed
in ROADMAP.md.

Each BodyXY carries the device its pixel pipeline runs on (``device=``;
cuda when a card is present, cpu otherwise).
"""

from __future__ import annotations

import datetime
import math
from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .base import _cache_clearable_result
from .body import Body


class BodyXY(Body):
    """
    An astronomical body imaged at a specific time, with the tangent-plane
    pixel coordinate system ``xy`` defined by disc parameters
    ``(x0, y0, r0, rotation)`` (parity with the reference's ``BodyXY``,
    body_xy.py:114).
    """

    def __init__(
        self,
        target: str,
        utc: str | datetime.datetime | float | None = None,
        observer: str | int = 'EARTH',
        nx: int = 0,
        ny: int = 0,
        *,
        sz: int | None = None,
        device: str | torch.device | None = None,
        **kwargs,
    ) -> None:
        if sz is not None:
            if nx != 0 or ny != 0:
                raise ValueError(
                    '`sz` cannot be used if `nx` and/or `ny` are nonzero'
                )
            nx = sz
            ny = sz

        super().__init__(target, utc, observer, **kwargs)
        self.device = resolve_device(device)

        self._nx: int = nx
        self._ny: int = ny
        self._x0: float = 0
        self._y0: float = 0
        self._r0: float = 10
        self._rotation_radians: float = 0
        self.set_disc_method('default')
        self._default_disc_method = 'manual'

        self.reset_disc_params()

    def __repr__(self) -> str:
        return self._generate_repr(
            'target', 'utc', kwarg_keys=['observer', 'nx', 'ny']
        )

    __hash__ = None  # type: ignore[assignment]  (mutable, unhashable)

    def _get_equality_tuple(self) -> tuple:
        return (
            self._nx, self._ny, self._x0, self._y0, self._r0,
            self._rotation_radians,
            super()._get_equality_tuple(),
        )

    def _get_kwargs(self) -> dict[str, Any]:
        return super()._get_kwargs() | dict(
            nx=self._nx, ny=self._ny, device=self.device
        )

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        return dict(
            nx=0, ny=0, device=None, **super()._get_default_init_kwargs()
        )

    def _copy_options_to_other(self, other) -> None:
        super()._copy_options_to_other(other)
        other.set_disc_params(*self.get_disc_params())
        other.set_disc_method(self.get_disc_method())

    # ------------------------------------------------------------------
    # Pixel <-> angular
    # ------------------------------------------------------------------
    @_cache_clearable_result
    def _get_xy2angular_matrix(self) -> np.ndarray:
        s = self.get_plate_scale_arcsec()
        theta_radians = -self._get_rotation_radians()
        m2 = s * self._rotation_matrix_radians(theta_radians)
        offset = -m2.dot(np.array([self.get_x0(), self.get_y0()]))
        m3 = np.identity(3)
        m3[:2, :2] = m2
        m3[:2, 2] = offset
        return m3

    # ------------------------------------------------------------------
    # Disc parameter interface
    # ------------------------------------------------------------------
    def _invalidate_disc_parameters(self) -> None:
        self._clear_cache()

    def set_disc_params(self, x0=None, y0=None, r0=None, rotation=None):
        """Set multiple disc parameters at once."""
        if x0 is not None:
            self.set_x0(x0)
        if y0 is not None:
            self.set_y0(y0)
        if r0 is not None:
            self.set_r0(r0)
        if rotation is not None:
            self.set_rotation(rotation)

    def adjust_disc_params(self, dx=0, dy=0, dr=0, drotation=0):
        """Adjust disc parameters by offsets."""
        self.set_x0(self.get_x0() + dx)
        self.set_y0(self.get_y0() + dy)
        self.set_r0(self.get_r0() + dr)
        self.set_rotation(self.get_rotation() + drotation)

    def get_disc_params(self) -> tuple[float, float, float, float]:
        """(x0, y0, r0, rotation) tuple."""
        return self.get_x0(), self.get_y0(), self.get_r0(), self.get_rotation()

    def reset_disc_params(self):
        """Reset disc parameters to their initial values."""
        self.set_rotation(0.0)
        if self._test_if_img_size_valid():
            self.centre_disc()
        else:
            self.set_disc_params(x0=0, y0=0, r0=10)
            self.set_disc_method('zero')
        return self.get_disc_method()

    def centre_disc(self) -> None:
        """Centre the disc and make it fill ~90% of the observation."""
        self.set_x0((self._nx - 1) / 2)
        self.set_y0((self._ny - 1) / 2)
        self.set_r0(0.9 * (min(self.get_x0(), self.get_y0())))
        self.set_disc_method('centre_disc')

    def set_x0(self, x0: float) -> None:
        """Set x pixel coordinate of the disc centre."""
        if not math.isfinite(x0):
            raise ValueError('x0 must be finite')
        self._x0 = float(x0)
        self._invalidate_disc_parameters()

    def get_x0(self) -> float:
        """x pixel coordinate of the disc centre."""
        return self._x0

    def set_y0(self, y0: float) -> None:
        """Set y pixel coordinate of the disc centre."""
        if not math.isfinite(y0):
            raise ValueError('y0 must be finite')
        self._y0 = float(y0)
        self._invalidate_disc_parameters()

    def get_y0(self) -> float:
        """y pixel coordinate of the disc centre."""
        return self._y0

    def set_r0(self, r0: float) -> None:
        """Set equatorial radius of the disc in pixels."""
        if not math.isfinite(r0):
            raise ValueError('r0 must be finite')
        if not r0 > 0:
            raise ValueError('r0 must be greater than zero')
        self._r0 = float(r0)
        self._invalidate_disc_parameters()

    def get_r0(self) -> float:
        """Equatorial radius of the disc in pixels."""
        return self._r0

    def _set_rotation_radians(self, rotation: float) -> None:
        self._rotation_radians = float(rotation % (2 * np.pi))
        self._invalidate_disc_parameters()

    def _get_rotation_radians(self) -> float:
        return self._rotation_radians

    def set_rotation(self, rotation: float) -> None:
        """Set the rotation of the disc in degrees."""
        if not math.isfinite(rotation):
            raise ValueError('rotation must be finite')
        self._set_rotation_radians(np.deg2rad(rotation))

    def rotate_north_to_top(self) -> None:
        """Set the rotation so the north pole is at the top of the image."""
        self.set_rotation(-self.north_pole_angle())
        self.set_disc_method('rotate_north_to_top')

    def get_rotation(self) -> float:
        """Rotation of the disc in degrees."""
        return float(np.rad2deg(self._get_rotation_radians()))

    def set_plate_scale_arcsec(self, arcsec_per_px: float) -> None:
        """Set the angular plate scale by changing r0."""
        self.set_r0(self.target_diameter_arcsec / (2 * arcsec_per_px))

    def set_plate_scale_km(self, km_per_px: float) -> None:
        """Set the km plate scale by changing r0."""
        self.set_plate_scale_arcsec(km_per_px / self.km_per_arcsec)

    def get_plate_scale_arcsec(self) -> float:
        """Plate scale in arcsec/pixel."""
        return self.target_diameter_arcsec / (2 * self.get_r0())

    def get_plate_scale_km(self) -> float:
        """Plate scale in km/pixel at the target."""
        return self.get_plate_scale_arcsec() * self.km_per_arcsec

    def set_img_size(self, nx: int | None = None, ny: int | None = None):
        """Set the image dimensions in pixels."""
        nx = self._nx if nx is None else int(nx)
        ny = self._ny if ny is None else int(ny)
        if nx < 0 or ny < 0:
            raise ValueError('nx and ny must be non-negative')
        self._nx = nx
        self._ny = ny
        self._clear_cache()

    def get_img_size(self) -> tuple[int, int]:
        """(nx, ny) image dimensions in pixels."""
        return (self._nx, self._ny)

    def set_disc_method(self, method: str) -> None:
        """Record the method used to find the disc."""
        self._cache['disc method'] = method

    def get_disc_method(self) -> str:
        """Method used to find the disc."""
        return self._cache.get('disc method', self._default_disc_method)

    def _test_if_img_size_valid(self) -> bool:
        return (self._nx > 0) and (self._ny > 0)

    # ------------------------------------------------------------------
    # Fused pipeline (all backplanes in one pass)
    # ------------------------------------------------------------------
    def _get_pipeline_anchors(self) -> dict[str, np.ndarray]:
        anchors = self._stable_cache.get('pipeline anchors')
        if anchors is None:
            from .pipeline import compute_scene_anchors

            anchors = compute_scene_anchors(self)
            self._stable_cache['pipeline anchors'] = anchors
        return anchors

    def generate_backplanes_fused(self) -> dict[str, np.ndarray]:
        """
        Compute every default backplane image in one pass on this body's
        device (the CUDA kernel on a GPU, the float64 PyTorch graph on the
        CPU; see :mod:`..pipeline`). Returns numpy arrays.
        """
        from .pipeline import compute_backplanes

        return compute_backplanes(self)
