"""
Body: the geometry engine API (port of ``planetmapper_tpu.body``).

This slice ports what a :class:`Body` needs to build its scene and to feed
the fused backplane pipeline: the constructor (scene constants, sub-observer
and sub-solar points, ring plane), the longitude-sign helper, the
lonlat -> radec -> angular transforms that the pipeline anchors use
(through :func:`Body.north_pole_angle`), the angular <-> km matrices, the
illumination and visibility functions the map coordinates use, and the
surface-altitude adjustment of the map getters. The other transforms and
the limb, terminator, ring, local-solar-time, state, occultation and
plotting methods are listed in ROADMAP.md.

Public methods take and return floats or numpy arrays like the JAX
package, on float64 CPU tensors inside. The transforms of the map chain
(:meth:`Body._lonlat2targvec_radians`, :meth:`Body._targvec2obsvec`,
:meth:`Body._illumf_from_targvec_radians`, ``_obsvec2radec_radians``, ...)
have one implementation on float64 tensors: numbers and numpy arrays go in
as CPU tensors and come back as numpy, and tensors come back as tensors on
their device, so that a :class:`BodyXY` keeps its map grids on its own
device (``_device.py``).
"""

from __future__ import annotations

import datetime
import functools
import math
import os
from typing import Any

import numpy as np
import torch

from . import data_loader
from ._device import f64
from .base import (
    BodyBase,
    FloatOrArray,
    NotFoundError,
    SpiceError,
    _cache_stable_result,
    _replace_np_arr_args_with_tuples,
    get_pool,
)
from .core import geometry as geom
from .core.ephemeris import InsufficientDataError
from .core.frames import BodyFrameModel
from .core.scene import SceneEngine


def _unit_from_radec(ra: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """
    Unit vector(s) from RA/Dec radians, float64 tensors on their device. The
    coordinate transforms must invert each other exactly, so every
    radec/rect conversion goes through this pair.
    """
    cos_dec = torch.cos(dec)
    return torch.stack(
        [torch.cos(ra) * cos_dec, torch.sin(ra) * cos_dec, torch.sin(dec)],
        dim=-1,
    )


def _radec_from_unit(v: torch.Tensor):
    """Inverse of :func:`_unit_from_radec`: ``(r, ra, dec)`` radians."""
    r = torch.sqrt(torch.sum(v * v, dim=-1))
    ra = torch.remainder(torch.atan2(v[..., 1], v[..., 0]), 2.0 * np.pi)
    dec = torch.asin(
        torch.clamp(v[..., 2] / torch.where(r > 0, r, 1.0), -1.0, 1.0)
    )
    return r, ra, dec


def _matvec_rows(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """``v @ m.T`` for a host matrix ``m``, written out elementwise (no
    matrix-product kernel: the same roundings on every device)."""
    return torch.stack([
        sum(float(m[i, j]) * v[..., j] for j in range(m.shape[1]))
        for i in range(m.shape[0])
    ], dim=-1)


def lst_quantization_enabled() -> bool:
    """
    Whether LOCAL-SOLAR-TIME values are quantised to whole seconds.

    CSPICE's et2lst returns integer (hr, mn, sc), so the reference's LST
    backplane is inherently quantised; this is reproduced by default for
    output parity. Set ``PLANETMAPPER_TPU_LST_QUANTIZATION=off`` for the
    continuous value (the same switch as the JAX package).
    """
    return os.environ.get(
        'PLANETMAPPER_TPU_LST_QUANTIZATION', 'on'
    ).lower() not in ('off', '0', 'false')


class _AdjustedSurfaceAltitude:
    """
    Context manager temporarily raising the target's surface by ``alt`` km
    (parity with the reference's kernel-pool mutation, body.py:172-230;
    here it swaps the radii attributes, which the geometry takes as
    arguments).
    """

    def __init__(self, body: 'Body', alt: float = 0.0, **kwargs) -> None:
        self.do_adjustment = alt != 0.0 and alt != body._alt_adjustment
        if self.do_adjustment:
            self.body = body
            self.alt = float(alt)
            if not math.isfinite(self.alt):
                raise ValueError(
                    'Cannot adjust surface altitude with non-finite alt value'
                )
            if body._alt_adjustment != 0.0:
                raise ValueError(
                    'Cannot nest _AdjustedSurfaceAltitude context managers '
                    'with alt != 0'
                )

    def __enter__(self) -> None:
        if self.do_adjustment:
            self.original_radii = self.body.radii
            self.change_radii(self.original_radii + self.alt)
            self.body._alt_adjustment = self.alt

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        if self.do_adjustment:
            self.change_radii(self.original_radii)
            self.body._alt_adjustment = 0.0

    def change_radii(self, radii: np.ndarray) -> None:
        """Apply new radii to the body."""
        self.body._assign_radius_values(np.asarray(radii, dtype=float))


def _adjust_surface_altitude_decorator(fn):
    @functools.wraps(fn)
    def decorated(self, *args, **kwargs):
        with _AdjustedSurfaceAltitude(self, **kwargs):
            return fn(self, *args, **kwargs)

    return decorated


def _cache_clearable_alt_dependent_result(fn):
    """
    Like :func:`.base._cache_clearable_result`, keyed also by the surface
    altitude adjustment in force.
    """

    @functools.wraps(fn)
    def decorated(self, *args_in, **kwargs_in):
        args, kwargs = _replace_np_arr_args_with_tuples(args_in, kwargs_in)
        key = (
            fn.__name__, args, frozenset(kwargs.items()), self._alt_adjustment
        )
        if key not in self._cache:
            self._cache[key] = fn(self, *args, **kwargs)
        return self._cache[key]

    return decorated


_ENGINE_CACHE: dict[tuple, SceneEngine] = {}


def _get_engine(
    *,
    target_id: int,
    observer_id: int,
    illumination_source_id: int,
    radii: tuple[float, float, float],
    abcorr: str,
    et_ref: float,
) -> SceneEngine:
    from .core.ephemeris import get_ephemeris

    eph = get_ephemeris()
    bucket = round(et_ref / (30 * 86400.0))  # chains are stable over months
    key = (
        target_id, observer_id, illumination_source_id,
        str(abcorr).strip().upper(), bucket, id(eph),
        len(eph._pool.spk_segments),
    )
    engine = _ENGINE_CACHE.get(key)
    if engine is None:
        engine = SceneEngine(
            eph,
            target_id=target_id,
            observer_id=observer_id,
            illumination_source_id=illumination_source_id,
            radii=radii,
            frame_model=BodyFrameModel.from_pool(get_pool(), target_id),
            abcorr=abcorr,
            et_ref=et_ref,
        )
        _ENGINE_CACHE[key] = engine
    return engine


class Body(BodyBase):
    """
    An astronomical body observed at a specific time (port of
    ``planetmapper_tpu.Body``; parity with the reference's ``Body``,
    body.py:275). Transforms accept floats or numpy arrays.
    """

    def __init__(
        self,
        target: str | int,
        utc: str | datetime.datetime | float | None = None,
        observer: str | int = 'EARTH',
        *,
        aberration_correction: str = 'CN',
        observer_frame: str = 'J2000',
        target_frame: str | None = None,
        illumination_source: str = 'SUN',
        subpoint_method: str = 'INTERCEPT/ELLIPSOID',
        surface_method: str = 'ELLIPSOID',
        **kwargs,
    ) -> None:
        super().__init__(
            target=target,
            utc=utc,
            observer=observer,
            aberration_correction=aberration_correction,
            observer_frame=observer_frame,
            **kwargs,
        )
        self._alt_adjustment = 0.0

        self.illumination_source = illumination_source
        self.subpoint_method = subpoint_method
        self.surface_method = surface_method

        self._target_frame_arg = target_frame
        if target_frame is None:
            self.target_frame = 'IAU_' + self.target
        else:
            self.target_frame = target_frame

        pool = get_pool()
        self._assign_radius_values(
            np.asarray(pool.bodvar(self.target_body_id, 'RADII', 3))
        )

        # Spin sense from the prime meridian rate; positive planetographic
        # longitude direction with the SUN/MOON/EARTH special cases
        # (reference body.py:524-535)
        pm = pool.bodvar(self.target_body_id, 'PM')
        self.prograde = bool(pm[1] >= 0)
        if self.prograde and self.target_body_id not in {10, 301, 399}:
            self.positive_longitude_direction = 'W'
        else:
            self.positive_longitude_direction = 'E'

        from .kernels import naif_ids

        try:
            illum_id = naif_ids.bods2c(
                self.illumination_source, pool.extra_body_names()[0]
            )
        except naif_ids.BodyNotFoundError as exc:
            raise NotFoundError(str(exc)) from exc
        self._illumination_source_id = illum_id

        self._engine = _get_engine(
            target_id=self.target_body_id,
            observer_id=self._observer_body_id,
            illumination_source_id=illum_id,
            radii=tuple(self.radii),
            abcorr=self.aberration_correction,
            et_ref=self.et,
        )
        try:
            self._scene = self._engine.scene_constants(self.et, self.radii)
        except InsufficientDataError as exc:
            from .base import _kernel_error_help_note

            raise SpiceError(
                str(exc) + '\n\n' + _kernel_error_help_note()
            ) from exc

        # Sub-observer point attributes (reference body.py:538-555)
        self._subpoint_targvec = self._scene['subpoint_targvec']
        self._subpoint_et = float(self._scene['subpoint_et'])
        self._subpoint_rayvec = self._scene['subpoint_rayvec']
        self._subpoint_obsvec = self._scene['subpoint_obsvec']
        self.subpoint_distance = float(self._scene['subpoint_distance'])
        self.subpoint_lon, self.subpoint_lat = self._radian_pair2degrees(
            self._lon_east2positive_radians(
                float(self._scene['subpoint_lon_e_rad'])
            ),
            float(self._scene['subpoint_lat_rad']),
        )
        self._subpoint_ra = float(
            np.rad2deg(self._scene['subpoint_ra_rad'])
        )
        self._subpoint_dec = float(
            np.rad2deg(self._scene['subpoint_dec_rad'])
        )

        # Sub-solar point (NaN when the target is the illumination source)
        subsol = self._scene['subsol_targvec']
        if np.all(np.isfinite(subsol)):
            self._subsol_targvec = subsol
            self.subsol_lon, self.subsol_lat = self._radian_pair2degrees(
                self._lon_east2positive_radians(
                    float(self._scene['subsol_lon_e_rad'])
                ),
                float(self._scene['subsol_lat_rad']),
            )
        else:
            self._subsol_targvec = np.full(3, np.nan)
            self.subsol_lon = np.nan
            self.subsol_lat = np.nan

        self.target_diameter_arcsec = float(
            2.0 * 60.0 * 60.0
            * np.rad2deg(np.arcsin(self.r_eq / self.target_distance))
        )
        self.km_per_arcsec = (2.0 * self.r_eq) / self.target_diameter_arcsec

        # Equatorial (ring) plane in obsvec space (reference body.py:582-588)
        self._ring_plane = (
            np.asarray(self._scene['ring_plane_normal'], dtype=float),
            float(self._scene['ring_plane_constant']),
        )

        self.named_ring_data = data_loader.get_ring_radii().get(self.target, {})
        self.ring_radii: set[float] = set()

        self._matrix_km2angular: np.ndarray | None = None
        self._matrix_angular2km: np.ndarray | None = None

        if self.target == 'SATURN':
            for k in ['A', 'B', 'C']:
                for r in self.named_ring_data.get(k, []):
                    self.ring_radii.add(r)

    # ------------------------------------------------------------------
    def _assign_radius_values(self, radii: np.ndarray) -> None:
        self.radii = radii
        self.r_eq = float(radii[0])
        self.r_polar = float(radii[2])
        self.flattening = (self.r_eq - self.r_polar) / self.r_eq

    def __repr__(self) -> str:
        return self._generate_repr('target', 'utc', kwarg_keys=['observer'])

    def _get_equality_tuple(self) -> tuple:
        return (
            self.illumination_source,
            self.subpoint_method,
            self.surface_method,
            self.target_frame,
            super()._get_equality_tuple(),
        )

    def _get_kwargs(self) -> dict[str, Any]:
        return super()._get_kwargs() | dict(
            target_frame=self._target_frame_arg,
            illumination_source=self.illumination_source,
            subpoint_method=self.subpoint_method,
            surface_method=self.surface_method,
        )

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        return dict(
            utc=None,
            observer='EARTH',
            aberration_correction='CN',
            observer_frame='J2000',
            target_frame=None,
            illumination_source='SUN',
            subpoint_method='INTERCEPT/ELLIPSOID',
            surface_method='ELLIPSOID',
            **super()._get_default_init_kwargs(),
        )

    # ------------------------------------------------------------------
    # Longitude sign helpers
    # ------------------------------------------------------------------
    def _lon_east2positive_radians(self, lon_e: float) -> float:
        """East-positive longitude -> the body's positive direction."""
        if self.positive_longitude_direction == 'W':
            return float(np.mod(-lon_e, 2 * np.pi))
        return float(np.mod(lon_e, 2 * np.pi))

    # ------------------------------------------------------------------
    # Core coordinate transformations (all built to/from obsvec)
    # ------------------------------------------------------------------
    def _lonlat2targvec_radians(
        self, lon, lat, *, alt: float, not_visible_nan: bool
    ):
        """
        Planetographic radians -> body-fixed vectors (pgrrec equivalent).
        Float64 tensors in: a tensor on their device out; numbers or numpy
        arrays in: numpy out.
        """
        tensor = isinstance(lon, torch.Tensor)
        if not tensor:
            lon, lat = f64(lon), f64(lat)
        lon_e = -lon if self.positive_longitude_direction == 'W' else lon
        targvec = geom.geodetic_to_rect(
            lon_e, lat, alt, self.r_eq, self.flattening
        )
        bad = ~(torch.isfinite(lon) & torch.isfinite(lat))
        if not math.isfinite(alt):
            bad = torch.ones_like(bad)
        targvec = torch.where(bad[..., None], math.nan, targvec)
        if not_visible_nan:
            visible = torch.as_tensor(
                self._test_if_targvec_visible_batch(
                    targvec, on_surface=(alt == 0.0)
                ),
                device=targvec.device,
            )
            targvec = torch.where(visible[..., None], targvec, math.nan)
        return targvec if tensor else targvec.numpy()

    def _targvec2lonlat_radians(self, targvec):
        """Body-fixed vectors -> planetographic radians (recpgr equivalent)."""
        targvec = np.asarray(targvec, dtype=float)
        lon_e, lat, _alt = geom.rect_to_geodetic(
            f64(targvec), self.r_eq, self.flattening
        )
        lon_e = lon_e.numpy()
        lat = lat.numpy()
        if self.positive_longitude_direction == 'W':
            lon = np.mod(-lon_e, 2 * np.pi)
        else:
            lon = np.mod(lon_e, 2 * np.pi)
        bad = ~np.all(np.isfinite(targvec), axis=-1)
        lon = np.where(bad, np.nan, lon)
        lat = np.where(bad, np.nan, lat)
        if lon.ndim == 0:
            return float(lon), float(lat)
        return lon, lat

    def _sub_consts(self) -> dict:
        return {
            'subpoint_targvec': self._subpoint_targvec,
            'subpoint_rayvec': self._subpoint_rayvec,
            'subpoint_obsvec': self._subpoint_obsvec,
            'subpoint_distance': self.subpoint_distance,
            'subpoint_et': self._subpoint_et,
        }

    def _targvec2obsvec(self, targvec: np.ndarray) -> np.ndarray:
        """
        Body-fixed -> observer-frame vectors with per-point light-time
        retargeting (reference body.py:917-948). A float64 tensor in: a
        tensor on its device out.
        """
        if isinstance(targvec, torch.Tensor):
            return self._engine.targvec2obsvec(targvec, self._sub_consts())
        return self._engine.targvec2obsvec(
            np.asarray(targvec, dtype=float), self._sub_consts()
        ).numpy()

    def _obsvec2targvec(self, obsvec: np.ndarray) -> np.ndarray:
        """Observer-frame -> body-fixed vectors (reference body.py:972-1006)."""
        return self._engine.obsvec2targvec(
            np.asarray(obsvec, dtype=float), self._sub_consts()
        ).numpy()

    def _radec2obsvec_norm_radians(self, ra, dec):
        """RA/Dec radians -> unit observer-frame vectors (tensors or numpy,
        as :meth:`_lonlat2targvec_radians`)."""
        tensor = isinstance(ra, torch.Tensor)
        if not tensor:
            ra, dec = f64(ra), f64(dec)
        bad = ~(torch.isfinite(ra) & torch.isfinite(dec))
        out = torch.where(bad[..., None], math.nan, _unit_from_radec(ra, dec))
        return out if tensor else out.numpy()

    def _radec2obsvec_norm(self, ra, dec) -> np.ndarray:
        return self._radec2obsvec_norm_radians(
            *self._degree_pair2radians(ra, dec)
        )

    def _lonlat2obsvec(
        self, lon, lat, *, alt: float, not_visible_nan: bool,
    ) -> np.ndarray:
        return self._targvec2obsvec(
            self._lonlat2targvec_radians(
                *self._degree_pair2radians(
                    np.asarray(lon, dtype=float), np.asarray(lat, dtype=float)
                ),
                alt=alt,
                not_visible_nan=not_visible_nan,
            ),
        )

    # Public transforms ------------------------------------------------------
    def lonlat2radec(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> RA/Dec for the observer."""
        return self._maybe_transform_as_arrays(
            self._lonlat2radec, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan,
        )

    def _lonlat2radec(self, lon, lat, *, alt, not_visible_nan):
        return self._obsvec2radec(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
            )
        )

    # Angular coordinates ----------------------------------------------------
    @_cache_stable_result
    def _get_obsvec2angular_matrix(
        self, *, origin_ra: float | None = None,
        origin_dec: float | None = None, coordinate_rotation: float = 0.0,
    ) -> np.ndarray:
        if origin_ra is None:
            origin_ra = self.target_ra
        if origin_dec is None:
            origin_dec = self.target_dec
        origin_obsvec = self._radec2obsvec_norm_radians(
            *self._degree_pair2radians(origin_ra, origin_dec)
        )
        _, ra_angle, _ = _radec_from_unit(f64(origin_obsvec))
        ra_matrix = _spice_rotate(float(ra_angle), 3)
        _, _, dec_angle = _radec_from_unit(f64(ra_matrix @ origin_obsvec))
        dec_matrix = _spice_rotate(-float(dec_angle), 2)
        rotation_matrix = _spice_rotate(np.deg2rad(coordinate_rotation), 1)
        return rotation_matrix @ dec_matrix @ ra_matrix

    def _obsvec2angular(self, obsvec, **angular_kwargs):
        """Observer-frame vectors -> angular coordinates [arcsec] (tensors,
        numpy arrays or, for one vector, floats, as they came)."""
        m = self._get_obsvec2angular_matrix(**angular_kwargs)
        tensor = isinstance(obsvec, torch.Tensor)
        v = obsvec if tensor else f64(obsvec)
        _r, x_rad, y_rad = _radec_from_unit(_matvec_rows(m, v))
        x = torch.remainder(-torch.rad2deg(x_rad), 360.0)
        x = torch.where(x > 180.0, x - 360.0, x)
        y = torch.rad2deg(y_rad)
        bad = ~torch.isfinite(v).all(dim=-1)
        x = torch.where(bad, math.nan, x) * 3600.0
        y = torch.where(bad, math.nan, y) * 3600.0
        if tensor:
            return x, y
        if x.ndim == 0:
            return float(x), float(y)
        return x.numpy(), y.numpy()

    def radec2angular(
        self, ra: FloatOrArray, dec: FloatOrArray, *,
        origin_ra: float | None = None, origin_dec: float | None = None,
        coordinate_rotation: float = 0.0,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """RA/Dec -> relative angular coordinates (arcsec)."""
        return self._maybe_transform_as_arrays(
            self._radec2angular, ra, dec, origin_ra=origin_ra,
            origin_dec=origin_dec, coordinate_rotation=coordinate_rotation,
        )

    def _radec2angular(self, ra, dec, **angular_kwargs):
        return self._obsvec2angular(
            self._radec2obsvec_norm(ra, dec), **angular_kwargs
        )

    # km <-> angular ---------------------------------------------------------
    def _get_km2angular_matrix(self) -> np.ndarray:
        if self._matrix_km2angular is None:
            s = 1 / self.km_per_arcsec
            theta_radians = np.deg2rad(self.north_pole_angle())
            self._matrix_km2angular = s * self._rotation_matrix_radians(
                theta_radians
            )
        return self._matrix_km2angular

    def _get_angular2km_matrix(self) -> np.ndarray:
        if self._matrix_angular2km is None:
            self._matrix_angular2km = np.linalg.inv(
                self._get_km2angular_matrix()
            )
        return self._matrix_angular2km

    # ------------------------------------------------------------------
    # Illumination and visibility
    # ------------------------------------------------------------------
    def _illumf_from_targvec_radians(self, targvec):
        """
        (phase, incidence, emission, visible, lit) of body-fixed vectors.
        A float64 tensor in: tensors on the device the scene call ran on
        (``_device.scene_device``); numpy in: numpy out, or numbers for one
        vector.
        """
        tensor = isinstance(targvec, torch.Tensor)
        v = targvec if tensor else f64(targvec)
        if not tensor and v.ndim == 1 and not torch.isfinite(v).all():
            return np.nan, np.nan, np.nan, False, False
        phase, incdnc, emissn, visibl, lit = self._engine.illumf(
            self.et, self.radii, v
        )
        good = torch.isfinite(v).all(dim=-1).to(phase.device)
        out = (
            torch.where(good, phase, math.nan),
            torch.where(good, incdnc, math.nan),
            torch.where(good, emissn, math.nan),
            visibl & good,
            lit & good,
        )
        if tensor:
            return out
        if v.ndim == 1:
            return tuple(t.item() for t in out)
        return tuple(t.numpy() for t in out)

    def _test_if_targvec_visible_batch(self, targvec, *, on_surface: bool):
        if on_surface:
            return self._illumf_from_targvec_radians(targvec)[3]
        targvec = np.asarray(targvec, dtype=float)
        # Off-surface: search for an intercept between the observer->point
        # ray and the surface; if found, the point is visible only when it
        # is in front of the intercept (reference body.py:2131-2150).
        obsvec = self._targvec2obsvec(targvec)
        d = obsvec / np.linalg.norm(obsvec, axis=-1, keepdims=True)
        intercept, _trgepc, found = self._engine.sincpt(
            self.et, self.radii, d, self.target_light_time
        )
        found = found.numpy()
        intercept = intercept.numpy()
        _state_i, lt_i = self._engine.spkcpt(
            self.et, np.where(found[..., None], intercept, 0.0)
        )
        _state_p, lt_p = self._engine.spkcpt(self.et, targvec)
        visible = (~found) | (lt_p.numpy() < lt_i.numpy())
        bad = ~np.all(np.isfinite(targvec), axis=-1)
        visible = np.where(bad, False, visible)
        if targvec.ndim == 1:
            return bool(visible)
        return visible

    # ------------------------------------------------------------------
    # Other
    # ------------------------------------------------------------------
    def north_pole_angle(self) -> float:
        """
        Angle of the north pole vs the positive declination direction, in
        degrees (-180, 180], measured anticlockwise.
        """
        np_x, np_y = self.radec2angular(
            *self.lonlat2radec(0, 90, not_visible_nan=False)
        )
        target_x, target_y = self.radec2angular(self.target_ra, self.target_dec)
        theta = -np.arctan2(target_x - np_x, np_y - target_y)
        theta = np.rad2deg(theta) % 360.0
        if theta > 180:
            theta -= 360
        return float(theta)


def _spice_rotate(angle: float, axis: int) -> np.ndarray:
    """Coordinate rotation matrix (``spice.rotate`` convention)."""
    c, s = math.cos(angle), math.sin(angle)
    if axis == 1:
        return np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    if axis == 2:
        return np.array([[c, 0, -s], [0, 1.0, 0], [s, 0, c]])
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
