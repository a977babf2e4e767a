"""
BodyXY: the pixel/backplane render core (port of ``planetmapper_tpu.body_xy``).

Ported: the constructor, the disc-parameter interface, the pixel
transforms (xy <-> radec, lonlat, km, angular) and image limits, the
backplane registry (:class:`Backplane`, :func:`BodyXY.get_backplane_img`,
:func:`BodyXY.get_backplane_map` and the 26 default backplanes behind
them), the fused 26-backplane pipeline
(:func:`BodyXY.generate_backplanes_fused`, which runs
:func:`..pipeline.compute_backplanes`), the map coordinates
(:func:`BodyXY.generate_map_coordinates`), :func:`BodyXY.map_img`, the
limb, terminator, ring and grid curves in pixels, the matplotlib
transforms and, in :mod:`._body_xy_plotting`, the plots and the
rasterised wireframe overlays (matplotlib is imported by the functions
that draw, never here).

Each BodyXY carries the device its pixel pipeline and its map reprojection
run on (``device=``; cuda by default, which raises without a card, and cpu
only when asked for with ``device='cpu'``). The image chain (pixel rays ->
targvec -> lonlat, illumination, states, limb and ring-plane coordinates)
and the map chain (lonlat -> targvec -> illumination -> obsvec -> RA/Dec ->
x/y and the other map planes) are float64 tensors on that device for a
frame or map of more than ``_device.BULK_ELEMENTS`` pixels or samples (on
the CPU for a smaller one), cached there. Only the public getters
(``get_*_img``, ``get_*_map``) copy a plane to the host, once per cache
entry; ``map_img`` reads the x/y maps where they are.
"""

from __future__ import annotations

import datetime
import math
import os
import weakref
from typing import Any, Callable, Literal, NamedTuple, Protocol, TypedDict

import numpy as np
import torch

from . import host_slots, tracing
from ._device import f64, resolve_device, scene_device
from .base import (
    _as_readonly_view,
    _cache_clearable_result,
    _cache_stable_result,
    _on_tensors,
    _return_readonly_array,
)
from .body import (
    Body,
    _adjust_surface_altitude_decorator,
    _AdjustedSurfaceAltitude,
    _cache_clearable_alt_dependent_result,
)
from .ops.projections import (
    ProjectionTransformer,
    ProjStringError,
    transformer_from_proj_string,
)
from .progress import progress_decorator


class MapKwargs(TypedDict, total=False):
    """Keyword arguments of the mapping functions (see
    :func:`BodyXY.generate_map_coordinates`)."""

    projection: str
    degree_interval: float
    lon: float
    lat: float
    size: int
    lon_coords: np.ndarray
    lat_coords: np.ndarray
    projection_x_coords: np.ndarray
    projection_y_coords: np.ndarray | None
    xlim: tuple[float, float] | None
    ylim: tuple[float, float] | None
    alt: float


class _BackplaneMapGetter(Protocol):
    def __call__(self, **map_kwargs) -> np.ndarray: ...


class Backplane(NamedTuple):
    """
    Backplane registration: ``name`` (used as the FITS EXTNAME),
    ``description``, and the image/map generator functions.
    """

    name: str
    description: str
    get_img: Callable[[], np.ndarray]
    get_map: _BackplaneMapGetter


class BackplaneNotFoundError(Exception):
    pass


class _WeakMethod:
    """
    A body's own getter, held in its backplane registry through a weak
    reference to the body. A bound method there would close a cycle (body,
    registry, method, body), so a dropped body and its device tensors would
    live until the cycle collector next ran; with this one they go with the
    body's last reference.
    """

    __slots__ = ('_ref',)

    def __init__(self, method: Callable) -> None:
        self._ref = weakref.WeakMethod(method)

    def bound(self) -> Callable:
        """The bound method, which holds the body."""
        method = self._ref()
        if method is None:
            raise ReferenceError('the body of this backplane has been freed')
        return method

    def __call__(self, *args, **kwargs):
        return self.bound()(*args, **kwargs)


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

        # resolved first: without a card and without device=, fail before
        # building the scene
        self.device = resolve_device(device)
        super().__init__(target, utc, observer, **kwargs)

        self._nx: int = nx
        self._ny: int = ny
        self._x0: float = 0
        self._y0: float = 0
        self._r0: float = 10
        self._rotation_radians: float = 0
        self.set_disc_method('default')
        self._default_disc_method = 'manual'

        # matplotlib Affine2D transforms, made on first use (update_transform)
        self._mpl_transform_xy2angular_fixed = None
        self._mpl_transform_angular_fixed2xy = None

        self.backplanes: dict[str, Backplane] = {}
        self._register_default_backplanes()

        self.reset_disc_params()

    @classmethod
    def from_body(
        cls, body: Body, nx: int = 0, ny: int = 0, *, sz: int | None = None,
        device: str | torch.device | None = None,
    ):
        """Create a BodyXY with the same parameters as a Body instance."""
        new = cls(**body._get_kwargs(), nx=nx, ny=ny, sz=sz, device=device)
        body._copy_options_to_other(new)
        return new

    def to_body(self) -> Body:
        """Create a Body instance from this BodyXY instance."""
        new = Body(**Body._get_kwargs(self))
        Body._copy_options_to_other(self, new)
        return new

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
    # Coordinate transformations
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

    @_cache_clearable_result
    def _get_angular2xy_matrix(self) -> np.ndarray:
        return np.linalg.inv(self._get_xy2angular_matrix())

    @_on_tensors
    def _xy2obsvec_norm(self, x, y):
        """Image pixels -> unit observer-frame vectors."""
        m = self._get_xy2angular_matrix()
        angular_x, angular_y = (
            float(m[i, 0]) * x + float(m[i, 1]) * y + float(m[i, 2])
            for i in range(2)
        )
        return self._angular2obsvec_norm(angular_x, angular_y)

    @_on_tensors
    def _obsvec2xy(self, obsvec):
        """Observer-frame vectors -> image pixels."""
        angular_x, angular_y = self._obsvec2angular(obsvec)
        m = self._get_angular2xy_matrix()
        return tuple(
            float(m[i, 0]) * angular_x + float(m[i, 1]) * angular_y
            + float(m[i, 2]) for i in range(2)
        )

    # Composite transforms
    def xy2radec(self, x, y):
        """Image pixel coordinates -> RA/Dec."""
        return self._maybe_transform_as_arrays(self._xy2radec, x, y)

    def _xy2radec(self, x, y):
        return self._obsvec2radec(self._xy2obsvec_norm(x, y))

    def radec2xy(self, ra, dec):
        """RA/Dec -> image pixel coordinates."""
        return self._maybe_transform_as_arrays(self._radec2xy, ra, dec)

    def _radec2xy(self, ra, dec):
        return self._obsvec2xy(self._radec2obsvec_norm(ra, dec))

    def xy2lonlat(
        self, x, y, *, not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
    ):
        """Image pixel coordinates -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._xy2lonlat, x, y, not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric,
        )

    def _xy2lonlat(self, x, y, *, not_found_nan, alt, planetocentric):
        return self._obsvec_norm2lonlat(
            self._xy2obsvec_norm(x, y), not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric,
        )

    def lonlat2xy(
        self, lon, lat, *, alt: float = 0.0, not_visible_nan: bool = True,
        planetocentric: bool = False,
    ):
        """Planetographic lonlat -> image pixel coordinates."""
        return self._maybe_transform_as_arrays(
            self._lonlat2xy, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
        )

    def _lonlat2xy(self, lon, lat, *, alt, not_visible_nan, planetocentric):
        return self._obsvec2xy(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            )
        )

    def xy2km(self, x, y):
        """Image pixel coordinates -> target plane km."""
        return self._maybe_transform_as_arrays(self._xy2km, x, y)

    def _xy2km(self, x, y):
        return self._obsvec2km(self._xy2obsvec_norm(x, y))

    def km2xy(self, km_x, km_y):
        """Target plane km -> image pixel coordinates."""
        return self._maybe_transform_as_arrays(self._km2xy, km_x, km_y)

    def _km2xy(self, km_x, km_y):
        return self._obsvec2xy(self._km2obsvec_norm(km_x, km_y))

    def xy2angular(self, x, y, **angular_kwargs):
        """Image pixel coordinates -> relative angular coordinates."""
        return self._maybe_transform_as_arrays(
            self._xy2angular, x, y, **angular_kwargs
        )

    def _xy2angular(self, x, y, **angular_kwargs):
        return self._obsvec2angular(
            self._xy2obsvec_norm(x, y), **angular_kwargs
        )

    def angular2xy(self, angular_x, angular_y, **angular_kwargs):
        """Relative angular coordinates -> image pixel coordinates."""
        return self._maybe_transform_as_arrays(
            self._angular2xy, angular_x, angular_y, **angular_kwargs
        )

    def _angular2xy(self, angular_x, angular_y, **angular_kwargs):
        return self._obsvec2xy(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs)
        )

    def _radec_arrs2xy_arrs(self, ra_arr, dec_arr):
        x, y = self.radec2xy(np.asarray(ra_arr), np.asarray(dec_arr))
        return np.asarray(x), np.asarray(y)

    def _xy2targvec(self, x, y):
        return self._obsvec_norm2targvec(self._xy2obsvec_norm(x, y))

    def _xy_in_image_frame(self, x, y):
        return (
            (x > -0.5) & (x < self._nx - 0.5)
            & (y > -0.5) & (y < self._ny - 0.5)
        )

    # ------------------------------------------------------------------
    # Disc parameter interface
    # ------------------------------------------------------------------
    def _invalidate_disc_parameters(self) -> None:
        self._clear_cache()
        self.update_transform()

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

    def scale_img_size(self, factor: float, *, allow_rounding: bool = False):
        """Scale the image size (and disc parameters) by a factor."""
        if factor <= 0:
            raise ValueError('Scaling factor must be greater than zero')
        nx, ny = self.get_img_size()
        nx_f = nx * factor
        ny_f = ny * factor
        nx_ceil = math.ceil(nx_f)
        ny_ceil = math.ceil(ny_f)
        if not allow_rounding and (nx_ceil != nx_f or ny_ceil != ny_f):
            raise ValueError(
                f'Image size ({nx}, {ny}) cannot be exactly scaled by '
                f'{factor} to an integer number of pixels: new size would be '
                f'({nx_f}, {ny_f}). Use `allow_rounding=True` to allow '
                'rounding of the image size.'
            )
        self.set_img_size(nx_ceil, ny_ceil)
        self.set_r0(self.get_r0() * factor)
        offset = (factor - 1) / 2
        self.set_x0(self.get_x0() * factor + offset)
        self.set_y0(self.get_y0() * factor + offset)

    def add_img_border(self, border: int) -> None:
        """Add (or crop, if negative) a pixel border around the image."""
        border = int(border)
        nx, ny = self.get_img_size()
        self.set_img_size(nx + 2 * border, ny + 2 * border)
        self.set_x0(self.get_x0() + border)
        self.set_y0(self.get_y0() + border)

    def set_disc_method(self, method: str) -> None:
        """Record the method used to find the disc."""
        self._cache['disc method'] = method

    def get_disc_method(self) -> str:
        """Method used to find the disc."""
        return self._cache.get('disc method', self._default_disc_method)

    def add_arcsec_offset(self, dra_arcsec: float = 0, ddec_arcsec: float = 0):
        """Adjust (x0, y0) by RA/Dec offsets in arcseconds."""
        dra = dra_arcsec / 3600
        ddec = ddec_arcsec / 3600
        ra0, dec0 = self.xy2radec(0, 0)
        dx, dy = self.radec2xy(ra0 + dra, dec0 + ddec)
        self.adjust_disc_params(dx=dx, dy=dy)

    def _test_if_img_size_valid(self) -> bool:
        return (self._nx > 0) and (self._ny > 0)

    # ------------------------------------------------------------------
    # Limits
    # ------------------------------------------------------------------
    def _get_xy_corner_coordinates(self) -> list[tuple[float, float]]:
        return [
            (-0.5, -0.5),
            (-0.5, self._ny - 0.5),
            (self._nx - 0.5, -0.5),
            (self._nx - 0.5, self._ny - 0.5),
        ]

    def _get_img_limits(self, func):
        xy_lim = [func(x, y) for x, y in self._get_xy_corner_coordinates()]
        xlim = (min(x for x, _ in xy_lim), max(x for x, _ in xy_lim))
        ylim = (min(y for _, y in xy_lim), max(y for _, y in xy_lim))
        return xlim, ylim

    def get_img_limits_radec(self):
        """((ra_left, ra_right), (dec_min, dec_max)) limits of the image."""
        xlim, ylim = self._get_img_limits(self.xy2radec)
        return (xlim[1], xlim[0]), ylim

    def get_img_limits_km(self):
        """km-coordinate limits of the image."""
        return self._get_img_limits(self.xy2km)

    def get_img_limits_angular(self, **angular_kwargs):
        """Angular-coordinate limits of the image."""
        return self._get_img_limits(
            lambda x, y: self.xy2angular(x, y, **angular_kwargs)
        )

    def get_img_limits_xy(self):
        """Pixel-coordinate limits of the image."""
        return self._get_img_limits(lambda x, y: (x, y))

    # ------------------------------------------------------------------
    # Illumination etc. in xy coordinates
    # ------------------------------------------------------------------
    def limb_xy(self, **kwargs):
        """Pixel-coordinate version of :func:`Body.limb_radec`."""
        return self._radec_arrs2xy_arrs(*self.limb_radec(**kwargs))

    def limb_xy_by_illumination(self, **kwargs):
        """Pixel-coordinate version of limb_radec_by_illumination."""
        ra_day, dec_day, ra_night, dec_night = self.limb_radec_by_illumination(
            **kwargs
        )
        return (
            *self._radec_arrs2xy_arrs(ra_day, dec_day),
            *self._radec_arrs2xy_arrs(ra_night, dec_night),
        )

    def terminator_xy(self, **kwargs):
        """Pixel-coordinate version of terminator_radec."""
        return self._radec_arrs2xy_arrs(*self.terminator_radec(**kwargs))

    def visible_lonlat_grid_xy(self, *args, **kwargs):
        """Pixel-coordinate version of visible_lonlat_grid_radec."""
        return [
            self._radec_arrs2xy_arrs(*rd)
            for rd in self.visible_lonlat_grid_radec(*args, **kwargs)
        ]

    def ring_xy(self, radius: float, **kwargs):
        """Pixel-coordinate version of ring_radec."""
        return self._radec_arrs2xy_arrs(*self.ring_radec(radius, **kwargs))

    # ------------------------------------------------------------------
    # Matplotlib transforms
    # ------------------------------------------------------------------
    def _get_matplotlib_xy2angular_fixed_transform(self):
        import matplotlib.transforms

        if self._mpl_transform_xy2angular_fixed is None:
            self._mpl_transform_xy2angular_fixed = (
                matplotlib.transforms.Affine2D(self._get_xy2angular_matrix())
            )
        return self._mpl_transform_xy2angular_fixed

    def _get_matplotlib_angular_fixed2xy_transform(self):
        import matplotlib.transforms

        if self._mpl_transform_angular_fixed2xy is None:
            self._mpl_transform_angular_fixed2xy = (
                matplotlib.transforms.Affine2D(self._get_angular2xy_matrix())
            )
        return self._mpl_transform_angular_fixed2xy

    def _maybe_get_axis_transform(self, ax):
        import matplotlib.transforms

        return (
            ax.transData
            if ax is not None
            else matplotlib.transforms.IdentityTransform()
        )

    def matplotlib_xy2radec_transform(self, ax=None):
        """Mutable matplotlib transform from xy to radec coordinates."""
        self.update_transform()
        return (
            self._get_matplotlib_xy2angular_fixed_transform()
            + self._get_matplotlib_transform(self.angular2radec, (0.0, 0.0), ax)
        )

    def matplotlib_radec2xy_transform(self, ax=None):
        self.update_transform()
        return (
            self._get_matplotlib_transform(
                self.radec2angular, (self.target_ra, self.target_dec), None
            )
            + self._get_matplotlib_angular_fixed2xy_transform()
            + self._maybe_get_axis_transform(ax)
        )

    def matplotlib_xy2km_transform(self, ax=None):
        self.update_transform()
        return (
            self._get_matplotlib_xy2angular_fixed_transform()
            + self._get_matplotlib_transform(self.angular2km, (0.0, 0.0), ax)
        )

    def matplotlib_km2xy_transform(self, ax=None):
        self.update_transform()
        return (
            self._get_matplotlib_transform(self.km2angular, (0.0, 0.0), None)
            + self._get_matplotlib_angular_fixed2xy_transform()
            + self._maybe_get_axis_transform(ax)
        )

    def matplotlib_xy2angular_transform(self, ax=None, **angular_kwargs):
        self.update_transform()
        f = lambda ax_, ay_: self._obsvec2angular(
            self._angular2obsvec_norm(ax_, ay_), **angular_kwargs
        )
        return (
            self._get_matplotlib_xy2angular_fixed_transform()
            + self._get_matplotlib_transform(f, (0.0, 0.0), ax)
        )

    def matplotlib_angular2xy_transform(self, ax=None, **angular_kwargs):
        self.update_transform()
        f = lambda ax_, ay_: self._obsvec2angular(
            self._angular2obsvec_norm(ax_, ay_), **angular_kwargs
        )
        return (
            self._get_matplotlib_transform(f, (0.0, 0.0), None)
            + self._get_matplotlib_angular_fixed2xy_transform()
            + self._maybe_get_axis_transform(ax)
        )

    def update_transform(self) -> None:
        """
        Refresh the mutable xy matplotlib transforms after disc changes.
        Only transforms already made are refreshed (a new one is made from
        the current disc), so a body that never plots never imports
        matplotlib.
        """
        if self._mpl_transform_xy2angular_fixed is not None:
            self._mpl_transform_xy2angular_fixed.set_matrix(
                self._get_xy2angular_matrix()
            )
        if self._mpl_transform_angular_fixed2xy is not None:
            self._mpl_transform_angular_fixed2xy.set_matrix(
                self._get_angular2xy_matrix()
            )

    # ------------------------------------------------------------------
    # Backplane management
    # ------------------------------------------------------------------
    @staticmethod
    def standardise_backplane_name(name: str) -> str:
        """Standardise a backplane name (strip + upper case)."""
        return name.strip().upper()

    def register_backplane(
        self,
        name: str,
        description: str,
        get_img: Callable[[], np.ndarray],
        get_map: _BackplaneMapGetter,
    ) -> None:
        """Register a new backplane."""
        name = self.standardise_backplane_name(name)
        if name in self.backplanes:
            raise ValueError(f'Backplane named {name!r} is already registered')
        get_img, get_map = (
            _WeakMethod(f) if getattr(f, '__self__', None) is self else f
            for f in (get_img, get_map)
        )
        self.backplanes[name] = Backplane(
            name=name, description=description, get_img=get_img, get_map=get_map
        )

    def backplane_summary_string(self) -> str:
        """Summary of registered backplanes."""
        return '\n'.join(
            f'{bp.name}: {bp.description}' for bp in self.backplanes.values()
        )

    def print_backplanes(self) -> None:
        """Print the backplane summary."""
        print(self.backplane_summary_string())

    def get_backplane(self, name: str) -> Backplane:
        """
        Retrieve a registered backplane by (standardised) name. Its getters
        hold the body, as bound methods do.
        """
        name = self.standardise_backplane_name(name)
        try:
            bp = self.backplanes[name]
        except KeyError as exc:
            raise BackplaneNotFoundError(
                '{n!r} not found. Currently registered backplanes are: {r}.'.format(
                    n=name,
                    r=', '.join([repr(n) for n in self.backplanes.keys()]),
                )
            ) from exc
        return bp._replace(**{
            key: f.bound()
            for key, f in (('get_img', bp.get_img), ('get_map', bp.get_map))
            if isinstance(f, _WeakMethod)
        })

    def get_backplane_img(self, name: str, *, alt: float = 0.0) -> np.ndarray:
        """Generate (a copy of) a backplane image."""
        with _AdjustedSurfaceAltitude(self, alt):
            return (
                self.backplanes[self.standardise_backplane_name(name)]
                .get_img()
                .copy()
            )

    def get_backplane_map(self, name: str, **map_kwargs) -> np.ndarray:
        """Generate (a copy of) a backplane map."""
        return (
            self.backplanes[self.standardise_backplane_name(name)]
            .get_map(**map_kwargs)
            .copy()
        )

    def plot_backplane_img(self, name, ax=None, *, alt=0.0, show=False, **kwargs):
        """Plot a backplane image with the target wireframe."""
        import matplotlib.pyplot as plt

        with _AdjustedSurfaceAltitude(self, alt):
            backplane = self.get_backplane(name)
            ax = self.plot_wireframe_xy(ax, show=False)
            im = ax.imshow(backplane.get_img(), origin='lower', **kwargs)
            plt.colorbar(im, label=backplane.description)
            if show:
                plt.show()
            return ax

    def plot_backplane_map(self, name, ax=None, show=False, **kwargs):
        """Plot a backplane map."""
        import matplotlib.pyplot as plt

        if ax is None:
            fig, ax = plt.subplots()
        backplane = self.get_backplane(name)
        map_kwargs, other_kwargs = _extract_map_kwargs_from_dict(kwargs)
        if 'plot_kwargs' in other_kwargs:
            other_kwargs |= other_kwargs.pop('plot_kwargs')
        im = self.plot_map(
            backplane.get_map(**map_kwargs), ax=ax, **map_kwargs, **other_kwargs
        )
        plt.colorbar(im, label=backplane.description)
        if show:
            plt.show()
        return ax

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

    # ------------------------------------------------------------------
    # Map projection machinery
    # ------------------------------------------------------------------
    @_cache_stable_result
    @_adjust_surface_altitude_decorator
    def generate_map_coordinates(
        self,
        projection: str = 'rectangular',
        *,
        degree_interval: float = 1,
        lon: float = 0,
        lat: float = 0,
        size: int = 100,
        lon_coords=None,
        lat_coords=None,
        projection_x_coords=None,
        projection_y_coords=None,
        xlim: tuple[float, float] | None = None,
        ylim: tuple[float, float] | None = None,
        alt: float = 0.0,
    ):
        """
        Generate map coordinates and the transformer for a projection.
        Returns ``(lons, lats, xx, yy, transformer, info)`` like the
        reference (body_xy.py:2755). Supported projections: 'rectangular',
        'orthographic', 'azimuthal', 'azimuthal equal area', 'manual', or a
        proj string using one of the natively implemented projections.
        """
        info: dict[str, Any]
        west = self.positive_longitude_direction == 'W'
        if projection == 'rectangular':
            lons = np.arange(degree_interval / 2, 360, degree_interval)
            if west:
                lons = lons[::-1]
            lats = np.arange(-90 + degree_interval / 2, 90, degree_interval)
            lons, lats = np.meshgrid(lons, lats)
            xx, yy = lons, lats
            transformer = self._get_default_transformer()
            info = dict(projection=projection, degree_interval=degree_interval)
        elif projection == 'manual':
            lons = lon_coords
            lats = lat_coords
            if lons is None or lats is None:
                raise ValueError(
                    'lon_coords and lat_coords must be provided for manual '
                    'projection'
                )
            lons = np.asarray(lons)
            lats = np.asarray(lats)
            if lons.ndim != lats.ndim:
                raise ValueError(
                    'lon_coords and lat_coords must have the same number of '
                    'dimensions'
                )
            if lons.ndim == 1:
                lons, lats = np.meshgrid(lons, lats)
            if lons.ndim != 2:
                raise ValueError(
                    'lon_coords and lat_coords must be 1D or 2D arrays'
                )
            if lons.shape != lats.shape:
                raise ValueError(
                    'lon_coords and lat_coords must have the same shape'
                )
            xx, yy = lons, lats
            transformer = self._get_default_transformer()
            info = dict(projection=projection)
        elif projection == 'orthographic':
            b = self.r_polar / self.r_eq
            transformer = ProjectionTransformer(
                kind='ortho', a=self.r_eq, b=self.r_polar, lon_0=lon,
                lat_0=lat, to_meter=self.r_eq,
                y_0=self.r_eq * (b - 1) * np.sin(np.radians(lat * 2)),
                west_positive=west,
            )
            lim = max(1, b) * 1.01
            lons, lats, xx, yy = self._grid_from_transformer(
                transformer, np.linspace(-lim, lim, size)
            )
            info = dict(projection=projection, lon=lon, lat=lat, size=size)
        elif projection == 'azimuthal':
            transformer = ProjectionTransformer(
                kind='aeqd', a=self.r_eq, b=self.r_eq, lon_0=lon, lat_0=lat,
                to_meter=self.r_eq * np.pi, west_positive=west,
            )
            lons, lats, xx, yy = self._grid_from_transformer(
                transformer, np.linspace(-1.01, 1.01, size)
            )
            info = dict(projection=projection, lon=lon, lat=lat, size=size)
        elif projection == 'azimuthal equal area':
            transformer = ProjectionTransformer(
                kind='laea', a=self.r_eq, b=self.r_eq, lon_0=lon, lat_0=lat,
                to_meter=self.r_eq * 2, west_positive=west,
            )
            lons, lats, xx, yy = self._grid_from_transformer(
                transformer, np.linspace(-1.01, 1.01, size)
            )
            info = dict(projection=projection, lon=lon, lat=lat, size=size)
        else:
            if projection_x_coords is None:
                raise ValueError('x coords must be provided')
            self._check_proj_string_for_axis(projection)
            transformer = transformer_from_proj_string(projection)
            xs = np.asarray(projection_x_coords)
            ys = (
                xs
                if projection_y_coords is None
                else np.asarray(projection_y_coords)
            )
            if xs.ndim != ys.ndim:
                raise ValueError(
                    'x and y coords must have the same number of dimensions'
                )
            if xs.ndim == 1:
                xx, yy = np.meshgrid(xs, ys)
            elif xs.ndim == 2:
                xx, yy = xs, ys
            else:
                raise ValueError('x and y coords must be 1D or 2D arrays')
            if xx.shape != yy.shape:
                raise ValueError('x and y coords must have the same shape')
            lons, lats = transformer.transform(xx, yy, direction='INVERSE')
            info = dict(
                projection=projection,
                projection_x_coords=projection_x_coords,
                projection_y_coords=projection_y_coords,
            )

        info['xlim'] = xlim
        info['ylim'] = ylim
        lons = np.array(lons, dtype=float)
        lats = np.array(lats, dtype=float)
        xx = np.array(xx, dtype=float)
        yy = np.array(yy, dtype=float)
        if xlim is not None:
            x_arr = xx[0]
            keep = (x_arr >= min(xlim)) & (x_arr <= max(xlim))
            xx, yy = xx[:, keep], yy[:, keep]
            lons, lats = lons[:, keep], lats[:, keep]
        if ylim is not None:
            y_arr = yy[:, 0]
            keep = (y_arr >= min(ylim)) & (y_arr <= max(ylim))
            xx, yy = xx[keep, :], yy[keep, :]
            lons, lats = lons[keep, :], lats[keep, :]

        lons[~np.isfinite(lons)] = np.nan
        lats[~np.isfinite(lats)] = np.nan

        if alt != 0.0:
            info['alt'] = alt
        return (
            _as_readonly_view(lons),
            _as_readonly_view(lats),
            _as_readonly_view(xx),
            _as_readonly_view(yy),
            transformer,
            info,
        )

    def _grid_from_transformer(self, transformer, xs):
        xx, yy = np.meshgrid(xs, xs)
        lons, lats = transformer.transform(xx, yy, direction='INVERSE')
        return lons, lats, xx, yy

    def _get_default_transformer(self):
        return ProjectionTransformer(
            kind='lonlat', a=self.r_eq, b=self.r_polar
        )

    def create_proj_string(self, proj: str, **parameters) -> str:
        """
        Build a proj-style projection string with the body's ``+a``, ``+b``
        and ``+axis`` parameters set automatically (pass None to omit one).
        """
        if 'a' not in parameters:
            parameters['a'] = self.r_eq
        if 'b' not in parameters:
            parameters['b'] = self.r_polar
        if 'axis' not in parameters:
            parameters['axis'] = (
                f'{self.positive_longitude_direction.lower()}nu'
            )
        for k in [k for k, v in parameters.items() if v is None]:
            parameters.pop(k)
        parameters_string = ' '.join(
            f'+{k}={v}' for k, v in parameters.items()
        )
        space = ' ' if parameters_string else ''
        return f'+proj={proj} {parameters_string}{space}+type=crs'

    def _check_proj_string_for_axis(self, projection: str) -> None:
        expected_axis = f'+axis={self.positive_longitude_direction.lower()}nu'
        if expected_axis not in projection:
            raise ProjStringError(
                f'Projection string {projection!r} does not have the '
                f'expected axis orientation {expected_axis!r} for positive '
                f'{self.positive_longitude_direction} coordinates.'
            )

    # ------------------------------------------------------------------
    # Backplane images: float64 tensors where _device.scene_device puts the
    # frame (this body's device for more than BULK_ELEMENTS pixels, else the
    # CPU), cached there; the public getters copy a plane out
    # ------------------------------------------------------------------
    def _make_empty_img(self, nz: int | None = None) -> np.ndarray:
        if not self._test_if_img_size_valid():
            raise ValueError(
                'nx and ny must be positive to create a backplane image'
            )
        shape = (self._ny, self._nx) if nz is None else (self._ny, self._nx, nz)
        return np.full(shape, np.nan)

    def _get_max_pixel_radius(self) -> float:
        return self.get_r0() * max(self.radii) / self.r_eq

    def _pixel_axes(self):
        """The pixel x and y coordinates, float64 tensors on the frame's
        device."""
        device = scene_device(self._nx * self._ny, self.device)
        return (torch.arange(self._nx, dtype=torch.float64, device=device),
                torch.arange(self._ny, dtype=torch.float64, device=device))

    @_cache_clearable_result
    def _get_obsvec_norm_img(self) -> torch.Tensor:
        if not self._test_if_img_size_valid():
            raise ValueError(
                'nx and ny must be positive to create a backplane image'
            )
        return self._xy2obsvec_norm(
            *torch.meshgrid(*self._pixel_axes(), indexing='xy')
        )

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_targvec_img(self) -> torch.Tensor:
        obsvec_norm = self._get_obsvec_norm_img()
        targvec = self._engine.sincpt(
            self.et, self.radii, obsvec_norm, self.target_light_time
        )[0]
        if self._optimize_speed:
            # Behaviour parity with the reference's off-disc short circuit
            # (body_xy.py:3200-3218): pixels beyond r_cutoff from the disc
            # centre are excluded. The cutoff is computed from the current
            # (possibly altitude-adjusted) radii ratio, exactly matching the
            # reference, so altitude-enlarged discs are clipped to the
            # nominal disc radius, as in the reference's regression outputs.
            r_cutoff = self._get_max_pixel_radius() * 1.05 + 1
            xs, ys = self._pixel_axes()
            r2 = (xs - self.get_x0())[None, :] ** 2 + \
                (ys - self.get_y0())[:, None] ** 2
            targvec = torch.where(
                (r2 > r_cutoff**2)[..., None], math.nan, targvec
            )
        return targvec

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_lonlat_img(self) -> torch.Tensor:
        return torch.rad2deg(torch.stack(
            self._targvec2lonlat_radians(self._get_targvec_img()), dim=-1
        ))

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_lonlat_centric_img(self) -> torch.Tensor:
        return torch.stack(
            self._targvec2lonlat_centric(self._get_targvec_img()), dim=-1
        )

    @_cache_clearable_result
    @progress_decorator
    def _get_radec_img(self) -> torch.Tensor:
        return torch.rad2deg(torch.stack(
            self._obsvec2radec_radians(self._get_obsvec_norm_img()), dim=-1
        ))

    @_cache_clearable_result
    def _get_km_xy_img(self) -> torch.Tensor:
        return torch.stack(self._obsvec2km(self._get_obsvec_norm_img()), dim=-1)

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_illumination_gie_img(self) -> torch.Tensor:
        return torch.rad2deg(torch.stack(
            self._illumination_angles_from_targvec_radians(
                self._get_targvec_img()
            ),
            dim=-1,
        ))

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_state_imgs(self):
        """(position, velocity, light time) of each pixel's surface point."""
        return self._states_of(self._get_targvec_img())

    def _states_of(self, targvec):
        finite = torch.isfinite(targvec).all(dim=-1)
        state, lt = self._engine.spkcpt(
            self.et, torch.where(finite[..., None], targvec, 0.0)
        )
        return (
            torch.where(finite[..., None], state[..., :3], math.nan),
            torch.where(finite[..., None], state[..., 3:], math.nan),
            torch.where(finite, lt, math.nan),
        )

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_limb_coordinate_imgs(self) -> torch.Tensor:
        return torch.stack(
            self._limb_coordinates_from_obsvec(self._get_obsvec_norm_img()),
            dim=-1,
        )

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_ring_plane_coordinate_imgs(self) -> torch.Tensor:
        """(radius, longitude, distance) of each pixel's ring-plane point."""
        rings = torch.stack(self._ring_coordinates_from_obsvec(
            self._get_obsvec_norm_img(), only_visible=False
        ), dim=-1)
        distance = self._get_state_imgs()[2] * self.speed_of_light()
        return torch.where(
            (rings[..., 2] > distance)[..., None], math.nan, rings
        )

    @_cache_clearable_alt_dependent_result
    @_return_readonly_array
    def _img_plane(self, getter: str, index: int) -> np.ndarray:
        """Plane ``index`` of an image getter's tensor, copied to the host
        once per disc and altitude."""
        return getattr(self, getter)()[..., index].cpu().numpy()

    # ------------------------------------------------------------------
    # Backplane maps: float64 tensors where _device.scene_device puts the
    # map (this body's device for more than BULK_ELEMENTS samples, else the
    # CPU), cached there; the public getters copy a plane out
    # ------------------------------------------------------------------
    def _make_empty_map(self, nz: int | None = None, **map_kwargs) -> np.ndarray:
        n0, n1 = self._get_lonlat_map(**map_kwargs).shape[:2]
        shape = (n0, n1) if nz is None else (n0, n1, nz)
        return np.full(shape, np.nan)

    @_cache_stable_result
    @_adjust_surface_altitude_decorator
    @_return_readonly_array
    def _get_lonlat_map(self, **map_kwargs) -> np.ndarray:
        lons, lats, *_ = self.generate_map_coordinates(**map_kwargs)
        lonlat_map = np.stack([np.asarray(lons) % 360, np.asarray(lats)],
                              axis=-1)
        lonlat_map[~np.isfinite(lonlat_map)] = np.nan
        return lonlat_map

    def _lonlat_map_tensor(self, **map_kwargs) -> torch.Tensor:
        """The lon/lat map [deg] as float64 on the map's device."""
        lonlats = self._get_lonlat_map(**map_kwargs)
        return f64(lonlats, scene_device(lonlats[..., 0].size, self.device))

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _targvec_map(self, **map_kwargs) -> torch.Tensor:
        lon, lat = torch.deg2rad(self._lonlat_map_tensor(**map_kwargs)).unbind(-1)
        return self._lonlat2targvec_radians(
            lon, lat, alt=0.0, not_visible_nan=False
        )

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _illumf_map(self, **map_kwargs) -> torch.Tensor:
        """Phase, incidence, emission [deg], visible and lit (0 or 1)."""
        phase, incdnc, emissn, visibl, lit = self._illumf_from_targvec_radians(
            self._targvec_map(**map_kwargs)
        )
        return torch.stack([
            torch.rad2deg(phase), torch.rad2deg(incdnc), torch.rad2deg(emissn),
            visibl.to(torch.float64), lit.to(torch.float64),
        ], dim=-1)

    @_cache_stable_result
    @_adjust_surface_altitude_decorator
    def _obsvec_map(self, **map_kwargs) -> torch.Tensor:
        return self._targvec2obsvec(self._targvec_map(**map_kwargs))

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _get_lonlat_centric_map(self, **map_kwargs) -> torch.Tensor:
        return torch.stack(
            self._targvec2lonlat_centric(self._targvec_map(**map_kwargs)),
            dim=-1,
        )

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _radec_map(self, **map_kwargs) -> torch.Tensor:
        visible = self._illumf_map(**map_kwargs)[..., 3] > 0
        ra, dec = self._obsvec2radec_radians(self._obsvec_map(**map_kwargs))
        return torch.rad2deg(torch.stack([
            torch.where(visible, ra, math.nan),
            torch.where(visible, dec, math.nan),
        ], dim=-1))

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _xy_map(self, **map_kwargs) -> torch.Tensor:
        radec_map = self._radec_map(**map_kwargs)
        finite = torch.isfinite(radec_map[..., 0])
        x, y = self._radec2xy(
            torch.where(finite, radec_map[..., 0], 0.0),
            torch.where(finite, radec_map[..., 1], 0.0),
        )
        ok = finite & self._xy_in_image_frame(x, y)
        return torch.stack([torch.where(ok, x, math.nan),
                            torch.where(ok, y, math.nan)], dim=-1)

    @_cache_clearable_alt_dependent_result
    @_return_readonly_array
    def _get_xy_map(self, **map_kwargs) -> np.ndarray:
        """The x/y maps copied to the host once per map and disc."""
        return self._xy_map(**map_kwargs).cpu().numpy()

    @_cache_stable_result
    @_adjust_surface_altitude_decorator
    def _get_km_xy_map(self, **map_kwargs) -> torch.Tensor:
        radec_map = self._radec_map(**map_kwargs)
        finite = torch.isfinite(radec_map[..., 0])
        km = torch.stack(self.radec2km(
            torch.where(finite, radec_map[..., 0], 0.0),
            torch.where(finite, radec_map[..., 1], 0.0),
        ), dim=-1)
        return torch.where(finite[..., None], km, math.nan)

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _get_state_maps(self, **map_kwargs):
        """(position, velocity, light time) of each map sample."""
        return self._states_of(self._targvec_map(**map_kwargs))

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _get_limb_coordinate_maps(self, **map_kwargs) -> torch.Tensor:
        # NOTE: the reference masks limb coordinate maps by the *lit* flag
        # (illumf index 4, body_xy.py:3981), not the visible flag
        lit = self._illumf_map(**map_kwargs)[..., 4] > 0
        limb = torch.stack(self._limb_coordinates_from_obsvec(
            self._obsvec_map(**map_kwargs)
        ), dim=-1)
        return torch.where(lit[..., None], limb, math.nan)

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _get_ring_plane_coordinate_maps(self, **map_kwargs) -> torch.Tensor:
        """(radius, longitude, distance) of each sample's ring-plane point."""
        # NOTE: the reference masks ring plane maps by the *lit* flag
        # (illumf index 4, body_xy.py:4097), not the visible flag
        lit = self._illumf_map(**map_kwargs)[..., 4] > 0
        rings = torch.stack(self._ring_coordinates_from_obsvec(
            self._obsvec_map(**map_kwargs), only_visible=False
        ), dim=-1)
        rings = torch.where(lit[..., None], rings, math.nan)
        distance = self._get_state_maps(**map_kwargs)[2] * \
            self.speed_of_light()
        return torch.where(
            (rings[..., 2] > distance)[..., None], math.nan, rings
        )

    @_cache_stable_result
    @_return_readonly_array
    def _map_plane(self, getter: str, index: int, **map_kwargs) -> np.ndarray:
        """Plane ``index`` of a map getter's tensor, copied to the host once
        per map."""
        return getattr(self, getter)(**map_kwargs)[..., index].cpu().numpy()

    @_cache_clearable_alt_dependent_result
    def _get_map_samples(self, **map_kwargs):
        """The x/y maps' :class:`..ops.interp_device.MapSamples` on this
        body's device (made once per map and disc, from the device maps)."""
        from .ops.interp_device import _device_xy

        xy_map = self._xy_map(**map_kwargs)
        return _device_xy(xy_map[..., 0], xy_map[..., 1], self.device)

    # -- public backplane getters (same names as the reference) ---------
    def get_lon_img(self) -> np.ndarray:
        """Planetographic longitude of each pixel (NaN off-disc)."""
        return self._img_plane('_get_lonlat_img', 0)

    def get_lon_map(self, **map_kwargs) -> np.ndarray:
        """Planetographic longitude map."""
        return self._get_lonlat_map(**map_kwargs)[:, :, 0]

    def get_lat_img(self) -> np.ndarray:
        """Planetographic latitude of each pixel (NaN off-disc)."""
        return self._img_plane('_get_lonlat_img', 1)

    def get_lat_map(self, **map_kwargs) -> np.ndarray:
        """Planetographic latitude map."""
        return self._get_lonlat_map(**map_kwargs)[:, :, 1]

    def get_lon_centric_img(self) -> np.ndarray:
        """Planetocentric longitude of each pixel."""
        return self._img_plane('_get_lonlat_centric_img', 0)

    def get_lon_centric_map(self, **map_kwargs) -> np.ndarray:
        """Planetocentric longitude map."""
        return self._map_plane('_get_lonlat_centric_map', 0, **map_kwargs)

    def get_lat_centric_img(self) -> np.ndarray:
        """Planetocentric latitude of each pixel."""
        return self._img_plane('_get_lonlat_centric_img', 1)

    def get_lat_centric_map(self, **map_kwargs) -> np.ndarray:
        """Planetocentric latitude map."""
        return self._map_plane('_get_lonlat_centric_map', 1, **map_kwargs)

    def get_ra_img(self) -> np.ndarray:
        """Right ascension of each pixel."""
        return self._img_plane('_get_radec_img', 0)

    def get_ra_map(self, **map_kwargs) -> np.ndarray:
        """Right ascension map (NaN where not visible)."""
        return self._map_plane('_radec_map', 0, **map_kwargs)

    def get_dec_img(self) -> np.ndarray:
        """Declination of each pixel."""
        return self._img_plane('_get_radec_img', 1)

    def get_dec_map(self, **map_kwargs) -> np.ndarray:
        """Declination map (NaN where not visible)."""
        return self._map_plane('_radec_map', 1, **map_kwargs)

    @_return_readonly_array
    def get_x_img(self) -> np.ndarray:
        """x pixel coordinate of each pixel."""
        out = self._make_empty_img()
        out[:] = np.arange(self._nx, dtype=float)[None, :]
        return out

    def get_x_map(self, **map_kwargs) -> np.ndarray:
        """Map of x pixel coordinates of each location."""
        return self._get_xy_map(**map_kwargs)[:, :, 0]

    @_return_readonly_array
    def get_y_img(self) -> np.ndarray:
        """y pixel coordinate of each pixel."""
        out = self._make_empty_img()
        out[:] = np.arange(self._ny, dtype=float)[:, None]
        return out

    def get_y_map(self, **map_kwargs) -> np.ndarray:
        """Map of y pixel coordinates of each location."""
        return self._get_xy_map(**map_kwargs)[:, :, 1]

    def get_km_x_img(self) -> np.ndarray:
        """East-West distance in target plane of each pixel."""
        return self._img_plane('_get_km_xy_img', 0)

    def get_km_x_map(self, **map_kwargs) -> np.ndarray:
        """East-West target plane distance map."""
        return self._map_plane('_get_km_xy_map', 0, **map_kwargs)

    def get_km_y_img(self) -> np.ndarray:
        """North-South distance in target plane of each pixel."""
        return self._img_plane('_get_km_xy_img', 1)

    def get_km_y_map(self, **map_kwargs) -> np.ndarray:
        """North-South target plane distance map."""
        return self._map_plane('_get_km_xy_map', 1, **map_kwargs)

    @_return_readonly_array
    def get_angular_x_img(self) -> np.ndarray:
        """East-West angular distance (arcsec) of each pixel."""
        return self.get_km_x_img() / self.km_per_arcsec

    @_return_readonly_array
    def get_angular_x_map(self, **map_kwargs) -> np.ndarray:
        """East-West angular distance map (arcsec)."""
        return self.get_km_x_map(**map_kwargs) / self.km_per_arcsec

    @_return_readonly_array
    def get_angular_y_img(self) -> np.ndarray:
        """North-South angular distance (arcsec) of each pixel."""
        return self.get_km_y_img() / self.km_per_arcsec

    @_return_readonly_array
    def get_angular_y_map(self, **map_kwargs) -> np.ndarray:
        """North-South angular distance map (arcsec)."""
        return self.get_km_y_map(**map_kwargs) / self.km_per_arcsec

    def get_phase_angle_img(self) -> np.ndarray:
        """Phase angle of each pixel in degrees."""
        return self._img_plane('_get_illumination_gie_img', 0)

    def get_phase_angle_map(self, **map_kwargs) -> np.ndarray:
        """Phase angle map in degrees."""
        return self._map_plane('_illumf_map', 0, **map_kwargs)

    def get_incidence_angle_img(self) -> np.ndarray:
        """Incidence angle of each pixel in degrees."""
        return self._img_plane('_get_illumination_gie_img', 1)

    def get_incidence_angle_map(self, **map_kwargs) -> np.ndarray:
        """Incidence angle map in degrees."""
        return self._map_plane('_illumf_map', 1, **map_kwargs)

    def get_emission_angle_img(self) -> np.ndarray:
        """Emission angle of each pixel in degrees."""
        return self._img_plane('_get_illumination_gie_img', 2)

    def get_emission_angle_map(self, **map_kwargs) -> np.ndarray:
        """Emission angle map in degrees."""
        return self._map_plane('_illumf_map', 2, **map_kwargs)

    def _azimuth_from_degrees(self, gie: torch.Tensor) -> np.ndarray:
        """Azimuth [deg] from (phase, incidence, emission) [deg], copied
        to the host."""
        return torch.rad2deg(self._azimuth_angle_from_gie_radians(
            *torch.deg2rad(gie[..., :3]).unbind(-1)
        )).cpu().numpy()

    @_cache_clearable_alt_dependent_result
    @_return_readonly_array
    def get_azimuth_angle_img(self) -> np.ndarray:
        """Azimuth angle of each pixel in degrees."""
        return self._azimuth_from_degrees(self._get_illumination_gie_img())

    @_cache_stable_result
    @_adjust_surface_altitude_decorator
    @_return_readonly_array
    def get_azimuth_angle_map(self, **map_kwargs) -> np.ndarray:
        """Azimuth angle map in degrees."""
        return self._azimuth_from_degrees(self._illumf_map(**map_kwargs))

    def _lst_of(self, lon: torch.Tensor) -> np.ndarray:
        """Local solar time [h] of longitudes [deg] (NaN where lon is),
        copied to the host."""
        finite = torch.isfinite(lon)
        lst = self._lst_hours_from_lons(torch.where(finite, lon, 0.0))
        return torch.where(finite, lst, math.nan).cpu().numpy()

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    @_return_readonly_array
    def get_local_solar_time_img(self) -> np.ndarray:
        """Local solar time of each pixel in local hours."""
        return self._lst_of(self._get_lonlat_img()[..., 0])

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    @_return_readonly_array
    def get_local_solar_time_map(self, **map_kwargs) -> np.ndarray:
        """Local solar time map in local hours."""
        return self._lst_of(self._lonlat_map_tensor(**map_kwargs)[..., 0])

    @_cache_clearable_alt_dependent_result
    @_return_readonly_array
    def get_distance_img(self) -> np.ndarray:
        """Observer distance of each pixel in km."""
        lt = self._get_state_imgs()[2]
        return (lt * self.speed_of_light()).cpu().numpy()

    @_cache_stable_result
    @_return_readonly_array
    def get_distance_map(self, **map_kwargs) -> np.ndarray:
        """Observer distance map in km."""
        lt = self._get_state_maps(**map_kwargs)[2]
        return (lt * self.speed_of_light()).cpu().numpy()

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    @_return_readonly_array
    def get_radial_velocity_img(self) -> np.ndarray:
        """Radial velocity of each pixel in km/s."""
        position, velocity, _lt = self._get_state_imgs()
        return self._radial_velocity_from_state(position, velocity).cpu().numpy()

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    @_return_readonly_array
    def get_radial_velocity_map(self, **map_kwargs) -> np.ndarray:
        """Radial velocity map in km/s."""
        position, velocity, _lt = self._get_state_maps(**map_kwargs)
        return self._radial_velocity_from_state(position, velocity).cpu().numpy()

    @_return_readonly_array
    def get_doppler_img(self) -> np.ndarray:
        """Doppler factor of each pixel."""
        return self.calculate_doppler_factor(self.get_radial_velocity_img())

    @_return_readonly_array
    def get_doppler_map(self, **map_kwargs) -> np.ndarray:
        """Doppler factor map."""
        return self.calculate_doppler_factor(
            self.get_radial_velocity_map(**map_kwargs)
        )

    def get_limb_lon_img(self) -> np.ndarray:
        """Longitude of the closest limb point for each pixel."""
        return self._img_plane('_get_limb_coordinate_imgs', 0)

    def get_limb_lon_map(self, **map_kwargs) -> np.ndarray:
        """Longitude of the closest limb point, mapped."""
        return self._map_plane('_get_limb_coordinate_maps', 0, **map_kwargs)

    def get_limb_lat_img(self) -> np.ndarray:
        """Latitude of the closest limb point for each pixel."""
        return self._img_plane('_get_limb_coordinate_imgs', 1)

    def get_limb_lat_map(self, **map_kwargs) -> np.ndarray:
        """Latitude of the closest limb point, mapped."""
        return self._map_plane('_get_limb_coordinate_maps', 1, **map_kwargs)

    def get_limb_distance_img(self) -> np.ndarray:
        """Distance above the limb for each pixel in km."""
        return self._img_plane('_get_limb_coordinate_imgs', 2)

    def get_limb_distance_map(self, **map_kwargs) -> np.ndarray:
        """Distance above the limb, mapped."""
        return self._map_plane('_get_limb_coordinate_maps', 2, **map_kwargs)

    def get_ring_plane_radius_img(self) -> np.ndarray:
        """Ring plane radius in km for each pixel."""
        return self._img_plane('_get_ring_plane_coordinate_imgs', 0)

    def get_ring_plane_radius_map(self, **map_kwargs) -> np.ndarray:
        """Ring plane radius map in km."""
        return self._map_plane(
            '_get_ring_plane_coordinate_maps', 0, **map_kwargs
        )

    def get_ring_plane_longitude_img(self) -> np.ndarray:
        """Ring plane planetographic longitude for each pixel."""
        return self._img_plane('_get_ring_plane_coordinate_imgs', 1)

    def get_ring_plane_longitude_map(self, **map_kwargs) -> np.ndarray:
        """Ring plane planetographic longitude map."""
        return self._map_plane(
            '_get_ring_plane_coordinate_maps', 1, **map_kwargs
        )

    def get_ring_plane_distance_img(self) -> np.ndarray:
        """Ring plane distance from the observer for each pixel."""
        return self._img_plane('_get_ring_plane_coordinate_imgs', 2)

    def get_ring_plane_distance_map(self, **map_kwargs) -> np.ndarray:
        """Ring plane distance map."""
        return self._map_plane(
            '_get_ring_plane_coordinate_maps', 2, **map_kwargs
        )

    # ------------------------------------------------------------------
    # Mapping (reprojection of observed images)
    # ------------------------------------------------------------------
    def map_img(
        self,
        img,
        *,
        interpolation: (
            Literal['nearest', 'smooth', 'linear', 'quadratic', 'cubic']
            | int
            | tuple[int, int]
        ) = 'linear',
        propagate_nan: bool = True,
        warn_nan: bool = False,
        spline_smoothing: float = 0,
        smooth_oversample_by: int = 5,
        smooth_max_oversampled_img_size: int = 10_000,
        as_numpy: bool = False,
        fetch_dtype=None,
        **map_kwargs,
    ):
        """
        Project an observed image ``(ny, nx)``, or a cube ``(nz, ny, nx)``,
        to a map (see :func:`generate_map_coordinates` for the projection
        options, and the reference documentation for the interpolation
        modes: 'nearest', spline degrees 1-3 ('linear'/'quadratic'/'cubic',
        an int, or a ``(ky, kx)`` tuple whose first degree runs along image
        rows) and the monotonic PCHIP-based 'smooth').

        ``img`` may be a numpy array or a tensor. The result is a
        ``torch.Tensor`` on this body's device (``as_numpy=False``) or a
        numpy array (``as_numpy=True``): float32 for the spline and smooth
        modes, the image's dtype for 'nearest'. ``fetch_dtype`` (a numpy
        dtype such as ``np.float16``) casts the result on the device before
        any copy to the host.

        A body on the CPU also takes the JAX package's host route, with
        ``PLANETMAPPER_TPU_MAP_DEVICE=off``: frame by frame with numpy and
        scipy, the result always a float64 numpy array. A body on the card
        refuses the switch: its image is mapped on the card or not at all.
        """
        spline_k = {'linear': 1, 'quadratic': 2, 'cubic': 3}
        if interpolation in spline_k:
            interpolation = spline_k[interpolation]  # type: ignore[index]
        host_route = os.environ.get(
            'PLANETMAPPER_TPU_MAP_DEVICE', 'on'
        ).lower() in ('off', '0', 'false')
        if host_route and self.device.type != 'cpu':
            raise ValueError(
                'PLANETMAPPER_TPU_MAP_DEVICE=off maps on the host, which only '
                f'a body on the CPU does; this body is on {self.device}: '
                "unset the switch, or build the body with device='cpu'"
            )
        with tracing.span('pm.map.upload'):
            img = host_slots.upload(img, self.device)
        if img.shape[-2:] != (self._ny, self._nx):
            raise ValueError(
                f'The input `img` shape {tuple(img.shape)!r} is inconsistent '
                f'with the body\'s image size (ny={self._ny}, nx={self._nx})'
            )
        if host_route:
            return self._map_img_on_host(
                img.numpy(), interpolation, propagate_nan=propagate_nan,
                warn_nan=warn_nan, spline_smoothing=spline_smoothing,
                smooth_oversample_by=smooth_oversample_by,
                smooth_max_oversampled_img_size=(
                    smooth_max_oversampled_img_size
                ),
                **map_kwargs,
            )
        with tracing.span('pm.map.samples'):
            samples = self._get_map_samples(**map_kwargs)

        from .ops import interp_device, pchip_device

        tracing.count('map.frames', img.shape[0] if img.ndim == 3 else 1)
        if interpolation == 'nearest':
            with tracing.span('pm.map.nearest'):
                if not img.is_floating_point():
                    img = img.to(torch.float64)
                out = interp_device.nearest_interpolation_device(img, samples)
        elif isinstance(interpolation, (int, tuple)):
            with tracing.span('pm.map.to_float64'):
                img = img.to(torch.float64)
            out = interp_device.spline_interpolation_device(
                img, samples,
                interpolation=interpolation, warn_nan=warn_nan,
                propagate_nan=propagate_nan,
                spline_smoothing=spline_smoothing,
            )
        elif interpolation == 'smooth':
            with tracing.span('pm.map.to_float64'):
                img = img.to(torch.float64)
            out = pchip_device.smooth_interpolation_device(
                img, samples,
                propagate_nan=propagate_nan,
                oversample_by=smooth_oversample_by,
                max_oversampled_img_size=smooth_max_oversampled_img_size,
            )
        else:
            raise ValueError(f'Unknown interpolation method {interpolation!r}')
        if fetch_dtype is not None:
            out = out.to(torch.from_numpy(np.empty(0, fetch_dtype)).dtype)
        if as_numpy:
            return out.cpu().numpy()
        return out

    def _map_img_on_host(
        self, img: np.ndarray, interpolation, *, propagate_nan, warn_nan,
        spline_smoothing, smooth_oversample_by,
        smooth_max_oversampled_img_size, **map_kwargs,
    ) -> np.ndarray:
        """The JAX package's host route of ``map_img`` (body_xy.py:720-806)
        for a body on the CPU: a cube frame by frame, each through the host
        modules."""
        if img.ndim == 3:
            return np.array([
                self._map_img_on_host(
                    frame, interpolation, propagate_nan=propagate_nan,
                    warn_nan=warn_nan, spline_smoothing=spline_smoothing,
                    smooth_oversample_by=smooth_oversample_by,
                    smooth_max_oversampled_img_size=(
                        smooth_max_oversampled_img_size
                    ),
                    **map_kwargs,
                )
                for frame in img
            ])
        from .ops import interp

        x_map = self.get_x_map(**map_kwargs)
        y_map = self.get_y_map(**map_kwargs)
        projected = self._make_empty_map(**map_kwargs)
        if interpolation == 'nearest':
            interp.nearest_interpolation(img, x_map, y_map, projected)
        elif isinstance(interpolation, (int, tuple)):
            interp.spline_interpolation(
                img, x_map, y_map, projected,
                interpolation=interpolation, warn_nan=warn_nan,
                propagate_nan=propagate_nan,
                spline_smoothing=spline_smoothing,
            )
        elif interpolation == 'smooth':
            interp.smooth_interpolation(
                img, x_map, y_map, projected,
                propagate_nan=propagate_nan,
                oversample_by=smooth_oversample_by,
                max_oversampled_img_size=smooth_max_oversampled_img_size,
            )
        else:
            raise ValueError(f'Unknown interpolation method {interpolation!r}')
        return projected

    # ------------------------------------------------------------------
    # Default backplane registration (reference body_xy.py:4198-4356)
    # ------------------------------------------------------------------
    def _register_default_backplanes(self) -> None:
        self.register_backplane(
            'LON-GRAPHIC',
            'Planetographic longitude, positive {ew} [deg]'.format(
                ew=self.positive_longitude_direction
            ),
            self.get_lon_img, self.get_lon_map,
        )
        self.register_backplane(
            'LAT-GRAPHIC', 'Planetographic latitude [deg]',
            self.get_lat_img, self.get_lat_map,
        )
        self.register_backplane(
            'LON-CENTRIC', 'Planetocentric longitude [deg]',
            self.get_lon_centric_img, self.get_lon_centric_map,
        )
        self.register_backplane(
            'LAT-CENTRIC', 'Planetocentric latitude [deg]',
            self.get_lat_centric_img, self.get_lat_centric_map,
        )
        self.register_backplane(
            'RA', 'Right ascension [deg]', self.get_ra_img, self.get_ra_map,
        )
        self.register_backplane(
            'DEC', 'Declination [deg]', self.get_dec_img, self.get_dec_map,
        )
        self.register_backplane(
            'PIXEL-X', 'Observation x pixel coordinate [pixels]',
            self.get_x_img, self.get_x_map,
        )
        self.register_backplane(
            'PIXEL-Y', 'Observation y pixel coordinate [pixels]',
            self.get_y_img, self.get_y_map,
        )
        self.register_backplane(
            'KM-X', 'East-West distance in target plane [km]',
            self.get_km_x_img, self.get_km_x_map,
        )
        self.register_backplane(
            'KM-Y', 'North-South distance in target plane [km]',
            self.get_km_y_img, self.get_km_y_map,
        )
        self.register_backplane(
            'ANGULAR-X', 'East-West distance in target plane [arcsec]',
            self.get_angular_x_img, self.get_angular_x_map,
        )
        self.register_backplane(
            'ANGULAR-Y', 'North-South distance in target plane [arcsec]',
            self.get_angular_y_img, self.get_angular_y_map,
        )
        self.register_backplane(
            'PHASE', 'Phase angle [deg]',
            self.get_phase_angle_img, self.get_phase_angle_map,
        )
        self.register_backplane(
            'INCIDENCE', 'Incidence angle [deg]',
            self.get_incidence_angle_img, self.get_incidence_angle_map,
        )
        self.register_backplane(
            'EMISSION', 'Emission angle [deg]',
            self.get_emission_angle_img, self.get_emission_angle_map,
        )
        self.register_backplane(
            'AZIMUTH', 'Azimuth angle [deg]',
            self.get_azimuth_angle_img, self.get_azimuth_angle_map,
        )
        self.register_backplane(
            'LOCAL-SOLAR-TIME', 'Local solar time [local hours]',
            self.get_local_solar_time_img, self.get_local_solar_time_map,
        )
        self.register_backplane(
            'DISTANCE', 'Distance to observer [km]',
            self.get_distance_img, self.get_distance_map,
        )
        self.register_backplane(
            'RADIAL-VELOCITY', 'Radial velocity away from observer [km/s]',
            self.get_radial_velocity_img, self.get_radial_velocity_map,
        )
        self.register_backplane(
            'DOPPLER',
            'Doppler factor, sqrt((1 + v/c)/(1 - v/c)) where v is radial '
            'velocity',
            self.get_doppler_img, self.get_doppler_map,
        )
        self.register_backplane(
            'LIMB-DISTANCE', 'Distance above limb [km]',
            self.get_limb_distance_img, self.get_limb_distance_map,
        )
        self.register_backplane(
            'LIMB-LON-GRAPHIC',
            'Planetographic longitude of closest point on the limb [deg]',
            self.get_limb_lon_img, self.get_limb_lon_map,
        )
        self.register_backplane(
            'LIMB-LAT-GRAPHIC',
            'Planetographic latitude of closest point on the limb [deg]',
            self.get_limb_lat_img, self.get_limb_lat_map,
        )
        self.register_backplane(
            'RING-RADIUS', 'Equatorial (ring) plane radius [km]',
            self.get_ring_plane_radius_img, self.get_ring_plane_radius_map,
        )
        self.register_backplane(
            'RING-LON-GRAPHIC',
            'Equatorial (ring) plane planetographic longitude [deg]',
            self.get_ring_plane_longitude_img,
            self.get_ring_plane_longitude_map,
        )
        self.register_backplane(
            'RING-DISTANCE', 'Equatorial (ring) plane distance to observer [km]',
            self.get_ring_plane_distance_img,
            self.get_ring_plane_distance_map,
        )


def _extract_map_kwargs_from_dict(kwargs_dict: dict):
    """Split kwargs into (map kwargs, other kwargs)."""
    map_keys = set(MapKwargs.__optional_keys__) | set(
        MapKwargs.__required_keys__
    )
    map_kwargs: MapKwargs = {}
    other_kwargs = {}
    for k, v in kwargs_dict.items():
        if k in map_keys:
            map_kwargs[k] = v  # type: ignore[literal-required]
        else:
            other_kwargs[k] = v
    return map_kwargs, other_kwargs


# Plotting methods (plot_wireframe_xy, plot_map_wireframe, plot_img,
# plot_map, wireframe overlays) live in _body_xy_plotting.
from . import _body_xy_plotting  # noqa: E402,F401
