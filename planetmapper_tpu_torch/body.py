"""
Body: the geometry engine API (port of ``planetmapper_tpu.body``).

Ported: the constructor (scene constants, sub-observer and sub-solar
points, ring plane), the transforms between lonlat (planetographic and
planetocentric), radec, km, angular and the internal targvec/obsvec
vectors, the illumination angles, azimuth, visibility and illumination
tests of points, the limb coordinates of rays, local solar time,
ring-plane coordinates, the states, radial velocities and distances of
points, and the surface-altitude adjustment. Other bodies, limb and
terminator curves, named rings, lon/lat grids, occultation,
``get_description`` and plotting are listed in ROADMAP.md.

Every transform takes numbers, numpy arrays or float64 tensors
(:func:`.base._on_tensors`). Tensors come back as tensors, on the device
the routing rule of ``_device.py`` gives the call: a bulk call (a map or a
pixel grid) runs on its inputs' device, which keeps a :class:`BodyXY`'s
images and maps on the body's device. Numbers and numpy arrays come back
as numpy arrays, or as numbers for one point.
"""

from __future__ import annotations

import datetime
import functools
import math
import os
from typing import Any, TypedDict

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
    _on_tensors,
    _replace_np_arr_args_with_tuples,
    get_pool,
)
from .core import geometry as geom
from .core.ephemeris import InsufficientDataError
from .core.frames import BodyFrameModel
from .core.scene import SceneEngine


class AngularCoordinateKwargs(TypedDict, total=False):
    """Customisation of the relative angular coordinate system."""

    origin_ra: float | None
    origin_dec: float | None
    coordinate_rotation: float


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
    body.py:275). Transforms accept floats, numpy arrays or tensors.
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
    @_on_tensors
    def _lonlat2targvec_radians(
        self, lon, lat, *, alt: float, not_visible_nan: bool
    ):
        """Planetographic radians -> body-fixed vectors (pgrrec equivalent)."""
        lon_e = -lon if self.positive_longitude_direction == 'W' else lon
        targvec = geom.geodetic_to_rect(
            lon_e, lat, alt, self.r_eq, self.flattening
        )
        bad = ~(torch.isfinite(lon) & torch.isfinite(lat))
        if not math.isfinite(alt):
            bad = torch.ones_like(bad)
        targvec = torch.where(bad[..., None], math.nan, targvec)
        if not_visible_nan:
            visible = self._test_if_targvec_visible_batch(
                targvec, on_surface=(alt == 0.0)
            )
            targvec = torch.where(visible[..., None], targvec, math.nan)
        return targvec

    @_on_tensors
    def _targvec2lonlat_radians(self, targvec):
        """Body-fixed vectors -> planetographic radians (recpgr equivalent)."""
        lon_e, lat, _alt = geom.rect_to_geodetic(
            targvec, self.r_eq, self.flattening
        )
        if self.positive_longitude_direction == 'W':
            lon_e = -lon_e
        bad = ~torch.isfinite(targvec).all(dim=-1)
        return (torch.where(bad, math.nan, torch.remainder(lon_e, 2 * np.pi)),
                torch.where(bad, math.nan, lat))

    def _sub_consts(self) -> dict:
        return {
            'subpoint_targvec': self._subpoint_targvec,
            'subpoint_rayvec': self._subpoint_rayvec,
            'subpoint_obsvec': self._subpoint_obsvec,
            'subpoint_distance': self.subpoint_distance,
            'subpoint_et': self._subpoint_et,
        }

    @_on_tensors
    def _targvec2obsvec(self, targvec):
        """
        Body-fixed -> observer-frame vectors with per-point light-time
        retargeting (reference body.py:917-948).
        """
        return self._engine.targvec2obsvec(targvec, self._sub_consts())

    @_on_tensors
    def _obsvec2targvec(self, obsvec):
        """Observer-frame -> body-fixed vectors (reference body.py:972-1006)."""
        return self._engine.obsvec2targvec(obsvec, self._sub_consts())

    @_on_tensors
    def _rayvec2obsvec(self, rayvec, et):
        """Target-frame ray at epoch ``et`` -> observer frame vector."""
        m = self._engine.frame_model.bodyfixed_to_j2000_matrix(float(et))
        return _matvec_rows(m.numpy(), rayvec)

    @_on_tensors
    def _radec2obsvec_norm_radians(self, ra, dec):
        """RA/Dec radians -> unit observer-frame vectors."""
        bad = ~(torch.isfinite(ra) & torch.isfinite(dec))
        return torch.where(bad[..., None], math.nan, _unit_from_radec(ra, dec))

    def _radec2obsvec_norm(self, ra, dec):
        return self._radec2obsvec_norm_radians(
            *self._degree_pair2radians(ra, dec)
        )

    @_on_tensors
    def _obsvec_norm2targvec(self, obsvec_norm):
        """
        Surface intercepts of rays from the observer (sincpt equivalent).
        One ray raises NotFoundError when it misses; batched rays give NaN
        rows.
        """
        targvec, _trgepc, found = self._engine.sincpt(
            self.et, self.radii, obsvec_norm, self.target_light_time
        )
        if obsvec_norm.ndim == 1 and not bool(found):
            raise NotFoundError(
                'No intercept found between the ray and the target body'
            )
        return targvec

    # Useful composite transforms --------------------------------------------
    def _lonlat2obsvec(
        self, lon, lat, *, alt: float, not_visible_nan: bool,
        planetocentric: bool,
    ):
        if planetocentric:
            lon, lat = self.centric2graphic_lonlat(lon, lat, alt=alt)
        return self._targvec2obsvec(
            self._lonlat2targvec_radians(
                *self._degree_pair2radians(lon, lat),
                alt=alt,
                not_visible_nan=not_visible_nan,
            ),
        )

    @_on_tensors
    def _obsvec_norm2lonlat(
        self, obsvec_norm, *, not_found_nan: bool, alt: float,
        planetocentric: bool,
    ):
        with _AdjustedSurfaceAltitude(self, alt):
            if obsvec_norm.ndim == 1 and not not_found_nan:
                targvec = self._obsvec_norm2targvec(obsvec_norm)  # may raise
            else:
                targvec = self._engine.sincpt(
                    self.et, self.radii, obsvec_norm, self.target_light_time
                )[0]
            lon, lat = self._radian_pair2degrees(
                *self._targvec2lonlat_radians(targvec)
            )
            if planetocentric:
                lon, lat = self.graphic2centric_lonlat(lon, lat, alt=alt)
            return lon, lat

    # Public transforms ------------------------------------------------------
    def lonlat2radec(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True, planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> RA/Dec for the observer."""
        return self._maybe_transform_as_arrays(
            self._lonlat2radec, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
        )

    def _lonlat2radec(self, lon, lat, *, alt, not_visible_nan, planetocentric):
        return self._obsvec2radec(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            )
        )

    def radec2lonlat(
        self, ra: FloatOrArray, dec: FloatOrArray, *,
        not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """RA/Dec -> planetographic lonlat (NaN where missing the disc)."""
        return self._maybe_transform_as_arrays(
            self._radec2lonlat, ra, dec, not_found_nan=not_found_nan,
            alt=alt, planetocentric=planetocentric,
        )

    def _radec2lonlat(self, ra, dec, *, not_found_nan, alt, planetocentric):
        return self._obsvec_norm2lonlat(
            self._radec2obsvec_norm(ra, dec),
            not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric,
        )

    def lonlat2targvec(
        self, lon, lat, *, alt: float = 0.0, not_visible_nan: bool = False,
        planetocentric: bool = False,
    ):
        """Planetographic lonlat -> body-fixed rectangular vector."""
        if planetocentric:
            lon, lat = self.centric2graphic_lonlat(lon, lat, alt=alt)
        return self._lonlat2targvec_radians(
            *self._degree_pair2radians(lon, lat),
            alt=alt, not_visible_nan=not_visible_nan,
        )

    def targvec2lonlat(
        self, targvec, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """Body-fixed rectangular vector -> planetographic lonlat."""
        with _AdjustedSurfaceAltitude(self, alt):
            lon, lat = self._radian_pair2degrees(
                *self._targvec2lonlat_radians(targvec)
            )
            if planetocentric:
                lon, lat = self.graphic2centric_lonlat(lon, lat)
            return lon, lat

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

    @_on_tensors
    def _obsvec2angular(self, obsvec, **angular_kwargs):
        """Observer-frame vectors -> angular coordinates [arcsec]."""
        m = self._get_obsvec2angular_matrix(**angular_kwargs)
        _r, x_rad, y_rad = _radec_from_unit(_matvec_rows(m, obsvec))
        x = torch.remainder(-torch.rad2deg(x_rad), 360.0)
        x = torch.where(x > 180.0, x - 360.0, x)
        y = torch.rad2deg(y_rad)
        bad = ~torch.isfinite(obsvec).all(dim=-1)
        return (torch.where(bad, math.nan, x) * 3600.0,
                torch.where(bad, math.nan, y) * 3600.0)

    @_on_tensors
    def _angular2obsvec_norm(self, angular_x, angular_y, **angular_kwargs):
        """Angular coordinates [arcsec] -> unit observer-frame vectors."""
        vec = _unit_from_radec(
            -torch.deg2rad(angular_x / 3600.0),
            torch.deg2rad(angular_y / 3600.0),
        )
        m = self._get_obsvec2angular_matrix(**angular_kwargs)
        return _matvec_rows(m.T, vec)  # (M^T @ v)^T = v @ M

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

    def angular2radec(
        self, angular_x: FloatOrArray, angular_y: FloatOrArray,
        **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Relative angular coordinates -> RA/Dec."""
        return self._maybe_transform_as_arrays(
            self._angular2radec, angular_x, angular_y, **angular_kwargs
        )

    def _angular2radec(self, angular_x, angular_y, **angular_kwargs):
        return self._obsvec2radec(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs)
        )

    def angular2lonlat(
        self, angular_x: FloatOrArray, angular_y: FloatOrArray, *,
        not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False, **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Relative angular coordinates -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._angular2lonlat, angular_x, angular_y,
            not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric, **angular_kwargs,
        )

    def _angular2lonlat(
        self, angular_x, angular_y, *, not_found_nan, alt, planetocentric,
        **angular_kwargs,
    ):
        return self._obsvec_norm2lonlat(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs),
            not_found_nan=not_found_nan, alt=alt,
            planetocentric=planetocentric,
        )

    def lonlat2angular(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True, planetocentric: bool = False,
        **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> relative angular coordinates."""
        return self._maybe_transform_as_arrays(
            self._lonlat2angular, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
            **angular_kwargs,
        )

    def _lonlat2angular(
        self, lon, lat, *, alt, not_visible_nan, planetocentric,
        **angular_kwargs,
    ):
        return self._obsvec2angular(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            ),
            **angular_kwargs,
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

    @_on_tensors
    def _km2obsvec_norm(self, km_x, km_y):
        km = torch.stack(torch.broadcast_tensors(km_x, km_y), dim=-1)
        ang = _matvec_rows(self._get_km2angular_matrix(), km)
        return self._angular2obsvec_norm(ang[..., 0], ang[..., 1])

    @_on_tensors
    def _obsvec2km(self, obsvec):
        ang = torch.stack(self._obsvec2angular(obsvec), dim=-1)
        return _matvec_rows(self._get_angular2km_matrix(), ang).unbind(-1)

    def km2radec(
        self, km_x: FloatOrArray, km_y: FloatOrArray
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Target-plane km -> RA/Dec."""
        return self._maybe_transform_as_arrays(self._km2radec, km_x, km_y)

    def _km2radec(self, km_x, km_y):
        return self._obsvec2radec(self._km2obsvec_norm(km_x, km_y))

    def radec2km(
        self, ra: FloatOrArray, dec: FloatOrArray
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """RA/Dec -> target-plane km."""
        return self._maybe_transform_as_arrays(self._radec2km, ra, dec)

    def _radec2km(self, ra, dec):
        return self._obsvec2km(self._radec2obsvec_norm(ra, dec))

    def km2lonlat(
        self, km_x: FloatOrArray, km_y: FloatOrArray, *,
        not_found_nan: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Target-plane km -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._km2lonlat, km_x, km_y, not_found_nan=not_found_nan,
            alt=alt, planetocentric=planetocentric,
        )

    def _km2lonlat(self, km_x, km_y, *, not_found_nan, alt, planetocentric):
        return self._obsvec_norm2lonlat(
            self._km2obsvec_norm(km_x, km_y), not_found_nan=not_found_nan,
            alt=alt, planetocentric=planetocentric,
        )

    def lonlat2km(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0,
        not_visible_nan: bool = True, planetocentric: bool = False,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic lonlat -> target-plane km."""
        return self._maybe_transform_as_arrays(
            self._lonlat2km, lon, lat, alt=alt,
            not_visible_nan=not_visible_nan, planetocentric=planetocentric,
        )

    def _lonlat2km(self, lon, lat, *, alt, not_visible_nan, planetocentric):
        return self._obsvec2km(
            self._lonlat2obsvec(
                lon, lat, alt=alt, not_visible_nan=not_visible_nan,
                planetocentric=planetocentric,
            )
        )

    def km2angular(
        self, km_x: FloatOrArray, km_y: FloatOrArray, **angular_kwargs
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Target-plane km -> relative angular coordinates."""
        return self._maybe_transform_as_arrays(
            self._km2angular, km_x, km_y, **angular_kwargs
        )

    def _km2angular(self, km_x, km_y, **angular_kwargs):
        return self._obsvec2angular(
            self._km2obsvec_norm(km_x, km_y), **angular_kwargs
        )

    def angular2km(
        self, angular_x: FloatOrArray, angular_y: FloatOrArray,
        **angular_kwargs,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Relative angular coordinates -> target-plane km."""
        return self._maybe_transform_as_arrays(
            self._angular2km, angular_x, angular_y, **angular_kwargs
        )

    def _angular2km(self, angular_x, angular_y, **angular_kwargs):
        return self._obsvec2km(
            self._angular2obsvec_norm(angular_x, angular_y, **angular_kwargs)
        )

    # ------------------------------------------------------------------
    # Illumination and visibility
    # ------------------------------------------------------------------
    @_on_tensors
    def _illumf_from_targvec_radians(self, targvec):
        """(phase, incidence, emission, visible, lit) of body-fixed vectors."""
        phase, incdnc, emissn, visibl, lit = self._engine.illumf(
            self.et, self.radii, targvec
        )
        good = torch.isfinite(targvec).all(dim=-1)
        return (
            torch.where(good, phase, math.nan),
            torch.where(good, incdnc, math.nan),
            torch.where(good, emissn, math.nan),
            visibl & good,
            lit & good,
        )

    def _illumination_angles_from_targvec_radians(self, targvec):
        phase, incdnc, emissn, _visibl, _lit = (
            self._illumf_from_targvec_radians(targvec)
        )
        return phase, incdnc, emissn

    @_on_tensors
    def illumination_angles_from_lonlat(
        self, lon, lat, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """(phase, incidence, emission) angles in degrees for a lonlat."""
        phase, incdnc, emissn = self._illumination_angles_from_targvec_radians(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )
        return (torch.rad2deg(phase), torch.rad2deg(incdnc),
                torch.rad2deg(emissn))

    @_on_tensors
    def _azimuth_angle_from_gie_radians(
        self, phase_radians, incidence_radians, emission_radians,
    ):
        # Azimuth from the spherical triangle of the three illumination
        # angles (same formula as the reference, body.py:2319-2332)
        a = torch.cos(phase_radians) - torch.cos(emission_radians) * torch.cos(
            incidence_radians
        )
        b = torch.sqrt(1.0 - torch.cos(emission_radians) ** 2) * torch.sqrt(
            1.0 - torch.cos(incidence_radians) ** 2
        )
        return math.pi - torch.acos(a / b)

    @_on_tensors
    def azimuth_angle_from_lonlat(
        self, lon, lat, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """Azimuth angle in degrees for a lonlat."""
        azimuth_radians = self._azimuth_angle_from_gie_radians(
            *self._illumination_angles_from_targvec_radians(
                self.lonlat2targvec(
                    lon, lat, alt=alt, planetocentric=planetocentric
                )
            )
        )
        return torch.rad2deg(azimuth_radians)

    def _test_if_targvec_illuminated(self, targvec):
        return self._illumf_from_targvec_radians(targvec)[4]

    def test_if_lonlat_illuminated(
        self, lon, lat, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """Test if a surface point is illuminated."""
        return self._test_if_targvec_illuminated(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )

    @_on_tensors
    def _test_if_targvec_visible_batch(self, targvec, *, on_surface: bool):
        if on_surface:
            return self._illumf_from_targvec_radians(targvec)[3]
        # Off-surface: search for an intercept between the observer->point
        # ray and the surface; if found, the point is visible only when it
        # is in front of the intercept (reference body.py:2131-2150).
        obsvec = self._targvec2obsvec(targvec)
        d = obsvec / geom.norm(obsvec, keepdim=True)
        intercept, _trgepc, found = self._engine.sincpt(
            self.et, self.radii, d, self.target_light_time
        )
        _state_i, lt_i = self._engine.spkcpt(
            self.et, torch.where(found[..., None], intercept, 0.0)
        )
        _state_p, lt_p = self._engine.spkcpt(self.et, targvec)
        visible = (~found) | (lt_p < lt_i)
        return visible & torch.isfinite(targvec).all(dim=-1)

    def _test_if_targvec_visible(self, targvec, *, on_surface: bool):
        return self._test_if_targvec_visible_batch(
            targvec, on_surface=on_surface
        )

    def test_if_lonlat_visible(
        self, lon, lat, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """Test if a (possibly elevated) surface point is visible."""
        return self._test_if_targvec_visible(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric),
            on_surface=alt == 0.0,
        )

    # ------------------------------------------------------------------
    # Limb
    # ------------------------------------------------------------------
    def limb_coordinates_from_radec(
        self, ra, dec, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """(lon, lat, dist) of the closest point on the limb to an RA/Dec."""
        with _AdjustedSurfaceAltitude(self, alt):
            lon, lat, dist = self._limb_coordinates_from_obsvec(
                self._radec2obsvec_norm(ra, dec)
            )
            if planetocentric:
                lon, lat = self.graphic2centric_lonlat(lon, lat)
            return lon, lat, dist

    @_on_tensors
    def _limb_coordinates_from_obsvec(self, obsvec_norm):
        if obsvec_norm.ndim == 1 and not bool(
            torch.isfinite(obsvec_norm).all()
        ):
            nan = obsvec_norm.new_tensor(math.nan)
            return nan, nan, nan
        device = obsvec_norm.device
        near, dist = geom.nearest_point_on_line(
            torch.zeros(3, dtype=torch.float64, device=device), obsvec_norm,
            f64(self._target_obsvec, device),
        )
        surface = geom.radial_surface_point(
            self._obsvec2targvec(near), f64(self.radii, device)
        )
        lon, lat = self._radian_pair2degrees(
            *self._targvec2lonlat_radians(surface)
        )
        return lon, lat, dist - geom.norm(surface)

    # ------------------------------------------------------------------
    # Local solar time
    # ------------------------------------------------------------------
    def _lst_from_lon(self, lon: float):
        if not math.isfinite(lon):
            return np.nan, np.nan, np.nan, '', ''
        lst = float(self._lst_hours_from_lons(float(lon)))
        total_seconds = int(lst * 3600.0)
        hr = total_seconds // 3600
        mn = (total_seconds % 3600) // 60
        sc = total_seconds % 60
        time_str = f'{hr:02d}:{mn:02d}:{sc:02d}'
        ampm = f'{(hr % 12) or 12:02d}:{mn:02d}:{sc:02d} ' + (
            'A.M.' if hr < 12 else 'P.M.'
        )
        return hr, mn, sc, time_str, ampm

    @_on_tensors
    def _lst_hours_from_lons(self, lon_pgr_deg):
        """
        Numerical local solar time for planetographic longitudes [deg].
        ``et2lst`` equivalent evaluated at et - target light time (matching
        the reference call at body.py:2364-2374). Quantised to whole seconds
        like CSPICE's integer (hr, mn, sc) output.
        """
        et = self.et - self.target_light_time
        sun_lon_e = float(self._engine.solar_longitude(et))
        lon = torch.deg2rad(lon_pgr_deg)
        lon_e = -lon if self.positive_longitude_direction == 'W' else lon
        sign = 1.0 if self.prograde else -1.0
        lst = torch.remainder(
            12.0 + sign * (lon_e - sun_lon_e) * 12.0 / np.pi, 24.0
        )
        if lst_quantization_enabled():
            lst = torch.floor(lst * 3600.0) / 3600.0
        return lst

    def local_solar_time_from_lon(self, lon: float) -> float:
        """Numerical local solar time in 'local hours' for a longitude."""
        hr, mn, sc, _time_str, _ampm = self._lst_from_lon(lon)
        return hr + mn / 60 + sc / 3600

    def local_solar_time_string_from_lon(self, lon: float) -> str:
        """Local solar time as an 'HH:MM:SS' string."""
        return self._lst_from_lon(lon)[3]

    # ------------------------------------------------------------------
    # Rings
    # ------------------------------------------------------------------
    @_on_tensors
    def _ring_coordinates_from_obsvec(self, obsvec, *, only_visible=True):
        device = obsvec.device
        normal, constant = self._ring_plane
        intercept, nxpts = geom.ray_plane_intercept(
            torch.zeros(3, dtype=torch.float64, device=device), obsvec,
            f64(normal, device), f64(constant, device),
        )
        ok = nxpts == 1
        targvec = self._obsvec2targvec(
            torch.where(ok[..., None], intercept, math.nan)
        )
        lon_e, _lat, alt = geom.rect_to_geodetic(
            targvec, self.r_eq, self.flattening
        )
        lon = torch.rad2deg(lon_e)
        if self.positive_longitude_direction == 'W':
            lon = -lon
        lon = torch.remainder(lon, 360.0)
        distance = geom.norm(intercept)
        radius = alt + self.r_eq

        invalid = ~ok | ~torch.isfinite(obsvec).all(dim=-1)
        if only_visible:
            invalid = invalid | (alt < 0)
            # Mask ring points hidden behind the planet: where the ray hits
            # the surface closer than the ring plane
            d = obsvec / geom.norm(obsvec, keepdim=True)
            targvec_surf, _trgepc, found = self._engine.sincpt(
                self.et, self.radii, d, self.target_light_time
            )
            _state, lt_surf = self._engine.spkcpt(
                self.et, torch.where(found[..., None], targvec_surf, 0.0)
            )
            surf_dist = lt_surf * self.speed_of_light()
            invalid = invalid | (found & (surf_dist < distance))
        return (
            torch.where(invalid, math.nan, radius),
            torch.where(invalid, math.nan, lon),
            torch.where(invalid, math.nan, distance),
        )

    def ring_plane_coordinates(self, ra, dec, only_visible: bool = True):
        """(radius, longitude, distance) in the equatorial (ring) plane."""
        return self._ring_coordinates_from_obsvec(
            self._radec2obsvec_norm(ra, dec), only_visible=only_visible
        )

    # ------------------------------------------------------------------
    # State (distance / velocity / doppler)
    # ------------------------------------------------------------------
    @_on_tensors
    def _state_from_targvec(self, targvec):
        state, lt = self._engine.spkcpt(self.et, targvec)
        return state[..., :3], state[..., 3:], lt

    @_on_tensors
    def _radial_velocity_from_state(self, position, velocity):
        phat = position / geom.norm(position, keepdim=True)
        return torch.sum(velocity * phat, dim=-1)

    def _radial_velocity_from_targvec(self, targvec):
        return self._radial_velocity_from_state(
            *self._state_from_targvec(targvec)[:2]
        )

    def radial_velocity_from_lonlat(
        self, lon, lat, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """Radial velocity of a surface point in km/s (+ve away)."""
        return self._radial_velocity_from_targvec(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )

    def distance_from_lonlat(
        self, lon, lat, *, alt: float = 0.0, planetocentric: bool = False,
    ):
        """Observer distance of a surface point in km."""
        _position, _velocity, lt = self._state_from_targvec(
            self.lonlat2targvec(lon, lat, alt=alt, planetocentric=planetocentric)
        )
        return lt * self.speed_of_light()

    # ------------------------------------------------------------------
    # Planetographic <-> planetocentric
    # ------------------------------------------------------------------
    @_on_tensors
    def _targvec2lonlat_centric(self, targvec):
        """Body-fixed vectors -> planetocentric lonlat [deg] (reclat)."""
        _r, lon_c, lat_c = geom.rect_to_latlon_centric(targvec)
        bad = ~torch.isfinite(targvec).all(dim=-1)
        return (torch.rad2deg(torch.where(bad, math.nan, lon_c)),
                torch.rad2deg(torch.where(bad, math.nan, lat_c)))

    def graphic2centric_lonlat(
        self, lon: FloatOrArray, lat: FloatOrArray, *, alt: float = 0.0
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetographic -> planetocentric lonlat."""
        return self._maybe_transform_as_arrays(
            self._graphic2centric_lonlat, lon, lat, alt=alt
        )

    def _graphic2centric_lonlat(self, lon, lat, *, alt):
        return self._targvec2lonlat_centric(
            self.lonlat2targvec(lon, lat, alt=alt)
        )

    def centric2graphic_lonlat(
        self, lon_centric: FloatOrArray, lat_centric: FloatOrArray, *,
        alt: float = 0.0,
    ) -> tuple[FloatOrArray, FloatOrArray]:
        """Planetocentric -> planetographic lonlat."""
        return self._maybe_transform_as_arrays(
            self._centric2graphic_lonlat, lon_centric, lat_centric, alt=alt
        )

    @_on_tensors
    def _centric2graphic_lonlat(self, lon_centric, lat_centric, *, alt):
        lon_c = torch.deg2rad(lon_centric)
        lat_c = torch.deg2rad(lat_centric)
        # latsrf equivalent: radial surface point at the centric direction
        direction = geom.radec_to_rect(torch.ones_like(lon_c), lon_c, lat_c)
        surface = geom.radial_surface_point(
            direction, f64(self.radii, direction.device)
        )
        bad = ~(torch.isfinite(lon_c) & torch.isfinite(lat_c))
        surface = torch.where(bad[..., None], math.nan, surface)
        # the point's lonlat on the surface raised by alt (the reference's
        # targvec2lonlat with alt)
        with _AdjustedSurfaceAltitude(self, alt):
            return self._radian_pair2degrees(
                *self._targvec2lonlat_radians(surface)
            )

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
