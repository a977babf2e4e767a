"""
Body: the geometry engine API (port of ``planetmapper_tpu.body``).

The whole of the JAX package's ``Body``: the constructor (scene constants,
sub-observer and sub-solar points, ring plane), the transforms between
lonlat (planetographic and planetocentric), radec, km, angular and the
internal targvec/obsvec vectors, the illumination angles, azimuth,
visibility and illumination tests of points, the limb coordinates of
rays, local solar time, ring-plane coordinates, the states, radial
velocities and distances of points, the surface-altitude adjustment, the
limb and terminator curves (``SceneEngine.limbpt``/``termpt``), other
bodies of interest and their occultation, named rings, lon/lat grids,
``get_description`` and, in :mod:`._body_plotting`, the wireframe plots
(matplotlib is imported by the functions that draw, never here).

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
from typing import Any, Literal, TypedDict

import numpy as np
import torch

from . import data_loader
from ._device import HOST, f64, scene_device
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
from .basic_body import BasicBody
from .core import geometry as geom
from .core.ephemeris import InsufficientDataError
from .core.frames import BodyFrameModel
from .core.scene import SceneEngine
from .kernels.pool import KernelVarNotFoundError

WireframeComponent = Literal[
    'all', 'grid', 'equator', 'prime_meridian', 'limb', 'limb_illuminated',
    'terminator', 'ring', 'pole', 'coordinate_of_interest_lonlat',
    'coordinate_of_interest_radec', 'other_body_of_interest_marker',
    'other_body_of_interest_label', 'hidden_other_body_of_interest_marker',
    'hidden_other_body_of_interest_label', 'map_boundary',
]


class WireframeKwargs(TypedDict, total=False):
    """Keyword arguments accepted by the wireframe plotting functions."""

    label_poles: bool
    add_title: bool
    grid_interval: float
    grid_lat_limit: float
    planetocentric_grid: bool
    indicate_equator: bool
    indicate_prime_meridian: bool
    formatting: dict[WireframeComponent, dict[str, Any]] | None
    alt: float
    color: str | tuple[float, float, float]
    alpha: float
    zorder: float


class AngularCoordinateKwargs(TypedDict, total=False):
    """Customisation of the relative angular coordinate system."""

    origin_ra: float | None
    origin_dec: float | None
    coordinate_rotation: float


class LonLatGridKwargs(TypedDict, total=False):
    """Keyword arguments of the lon/lat grid generators."""

    npts: int
    lat_limit: float
    alt: float
    planetocentric: bool


def _default_wireframe_formatting():
    """The default formatting of each wireframe component (the JAX
    package's, from the reference body.py:104-137). Needs matplotlib."""
    import matplotlib.patheffects as path_effects

    return {
        'all': dict(color='k'),
        'grid': dict(alpha=0.5, linestyle=':'),
        'equator': dict(linestyle='-'),
        'prime_meridian': dict(linestyle='-'),
        'limb': dict(linewidth=0.5),
        'limb_illuminated': dict(),
        'terminator': dict(linestyle='--'),
        'ring': dict(linewidth=0.5),
        'pole': dict(
            ha='center', va='center', size='small', weight='bold',
            path_effects=[
                path_effects.Stroke(linewidth=3, foreground='w'),
                path_effects.Normal(),
            ],
            clip_on=True,
        ),
        'coordinate_of_interest_lonlat': dict(marker='x'),
        'coordinate_of_interest_radec': dict(marker='+'),
        'other_body_of_interest_marker': dict(marker='+'),
        'other_body_of_interest_label': dict(
            size='small', ha='center', va='center', alpha=0.5, clip_on=True
        ),
        'hidden_other_body_of_interest_marker': dict(alpha=0.333),
        'hidden_other_body_of_interest_label': dict(),
        'map_boundary': dict(),
    }


class _LazyFormattingDict(dict):
    """Defaults are filled on first *read* (not at import: they need
    matplotlib). Every read path must materialise - ``get``/``keys``
    don't call ``__missing__``, and a consumer iterating an
    unmaterialised dict would silently see no formatting (and drop the
    per-plot coordinate transform carried through the same kwargs)."""

    _materialised = False

    def _materialise(self):
        if not self._materialised:
            self._materialised = True
            # setdefault: a user who customised entries before first
            # use keeps their values; only missing components fill in
            for k, v in _default_wireframe_formatting().items():
                self.setdefault(k, v)

    def __missing__(self, key):
        self._materialise()
        if key not in self:
            raise KeyError(key)
        return self[key]

    def get(self, key, default=None):
        self._materialise()
        return dict.get(self, key, default)

    def keys(self):
        self._materialise()
        return dict.keys(self)

    def items(self):
        self._materialise()
        return dict.items(self)

    def values(self):
        self._materialise()
        return dict.values(self)

    def __iter__(self):
        self._materialise()
        return dict.__iter__(self)

    def __contains__(self, key):
        self._materialise()
        return dict.__contains__(self, key)

    def __len__(self):  # also covers bool()
        self._materialise()
        return dict.__len__(self)

    def __eq__(self, other):
        self._materialise()
        return dict.__eq__(self, other)

    __hash__ = None  # type: ignore[assignment]  # dicts are unhashable

    def __repr__(self):
        self._materialise()
        return dict.__repr__(self)

    def copy(self):
        self._materialise()
        return dict(self)


DEFAULT_WIREFRAME_FORMATTING: dict = _LazyFormattingDict()


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


def _host_array(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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

    #: Where the body's bulk curves run (a limb or terminator of more than
    #: ``_device.BULK_ELEMENTS`` points): the host for a Body, its own
    #: device for a BodyXY; an other body of interest takes its creator's.
    device: torch.device = HOST

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
        self.other_bodies_of_interest: list[Body | BasicBody] = []
        self.coordinates_of_interest_lonlat: list[tuple[float, float]] = []
        self.coordinates_of_interest_radec: list[tuple[float, float]] = []

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

    def _copy_options_to_other(self, other) -> None:
        super()._copy_options_to_other(other)
        other.other_bodies_of_interest = self.other_bodies_of_interest.copy()
        other.coordinates_of_interest_lonlat = (
            self.coordinates_of_interest_lonlat.copy()
        )
        other.coordinates_of_interest_radec = (
            self.coordinates_of_interest_radec.copy()
        )
        other.ring_radii = self.ring_radii.copy()

    # ------------------------------------------------------------------
    # Other bodies
    # ------------------------------------------------------------------
    def create_other_body(
        self, other_target: str | int, fallback_to_basic_body: bool = True
    ) -> 'Body | BasicBody':
        """
        Create a Body with identical parameters but a different target, on
        this body's device (a :class:`BasicBody` when the kernels hold no
        radii for it and ``fallback_to_basic_body``).
        """
        try:
            try:
                other = Body(
                    target=other_target,
                    utc=self.utc,
                    observer=self.observer,
                    observer_frame=self.observer_frame,
                    illumination_source=self.illumination_source,
                    aberration_correction=self.aberration_correction,
                    subpoint_method=self.subpoint_method,
                    surface_method=self.surface_method,
                )
                other.device = self.device
                return other
            except KernelVarNotFoundError:
                if not fallback_to_basic_body:
                    raise
                return BasicBody(
                    target=other_target,
                    utc=self.utc,
                    observer=self.observer,
                    observer_frame=self.observer_frame,
                    aberration_correction=self.aberration_correction,
                )
        except NotFoundError as e:
            raise NotFoundError(
                f'{e}\n\nBody name: {other_target!r}'
            ) from e

    def add_other_bodies_of_interest(
        self, *other_targets: str | int, only_visible: bool = False
    ) -> None:
        """Add targets to :attr:`other_bodies_of_interest`."""
        for other_target in other_targets:
            body = self.create_other_body(other_target)
            if only_visible and not self.test_if_other_body_visible(body):
                continue
            if body not in self.other_bodies_of_interest:
                self.other_bodies_of_interest.append(body)

    def _get_all_satellite_bodies(
        self, skip_insufficient_data: bool = False, only_visible: bool = False
    ) -> 'list[Body | BasicBody]':
        from .kernels import naif_ids

        out: list[Body | BasicBody] = []
        id_base = (self.target_body_id // 100) * 100
        for other_target_id in range(id_base + 1, id_base + 99):
            try:
                body = self.create_other_body(other_target_id)
                if only_visible and not self.test_if_other_body_visible(body):
                    continue
                out.append(body)
            except (SpiceError, InsufficientDataError) as exc:
                if isinstance(exc, NotFoundError):
                    continue
                if skip_insufficient_data:
                    continue
                try:
                    naif_ids.bodc2n(other_target_id)
                except naif_ids.BodyNotFoundError:
                    continue
                raise
        return out

    def add_satellites_to_bodies_of_interest(
        self, skip_insufficient_data: bool = False, only_visible: bool = False
    ) -> None:
        """Add all satellites in the target's system (by NAIF ID range)."""
        satellites = self._get_all_satellite_bodies(
            skip_insufficient_data=skip_insufficient_data,
            only_visible=only_visible,
        )
        for satellite in satellites:
            if satellite not in self.other_bodies_of_interest:
                self.other_bodies_of_interest.append(satellite)

    # ------------------------------------------------------------------
    # Rings data helpers
    # ------------------------------------------------------------------
    @staticmethod
    def _standardise_ring_name(name: str) -> str:
        name = name.casefold().strip().removesuffix('ring')
        for a, b in data_loader.get_ring_aliases().items():
            name = name.replace(a, b)
        return name.casefold().strip()

    def ring_radii_from_name(self, name: str) -> list[float]:
        """Ring radii in km for a named ring from :attr:`named_ring_data`."""
        name = self._standardise_ring_name(name)
        for n, radii in self.named_ring_data.items():
            if name == self._standardise_ring_name(n):
                return radii
        raise ValueError(
            f'No rings found named {name!r} in named_ring_data.'
            + '\nValid names: {}'.format(
                [self._standardise_ring_name(n) for n in self.named_ring_data]
            )
        )

    def add_named_rings(self, *names: str) -> None:
        """Add named rings (all by default) to :attr:`ring_radii`."""
        if len(names) == 0:
            names = tuple(self.named_ring_data.keys())
        for name in names:
            self.ring_radii.update(self.ring_radii_from_name(name))

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

    def _targvec_arr2radec_arrs_radians(
        self, targvec_arr
    ) -> tuple[np.ndarray, np.ndarray]:
        """
        RA/Dec radians, as numpy arrays, of body-fixed vectors: a numpy
        array, or a tensor that stays on its device until the copy out.
        """
        ra, dec = self._obsvec2radec_radians(
            self._targvec2obsvec(targvec_arr)
        )
        return _host_array(ra), _host_array(dec)

    def _targvec_arr2radec_arrs(self, targvec_arr):
        return self._radian_pair2degrees(
            *self._targvec_arr2radec_arrs_radians(targvec_arr)
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

    def other_body_los_intercept(
        self, other: 'str | int | Body | BasicBody', *, alt: float = 0.0
    ) -> None | str:
        """
        Line-of-sight intercept classification between the target and
        another body: None / 'hidden' / 'part hidden' / 'transit' /
        'part transit' / 'same'.
        """
        if not isinstance(other, BodyBase):
            other = self.create_other_body(other)

        with _AdjustedSurfaceAltitude(self, alt):
            if isinstance(other, BasicBody):
                try:
                    self.radec2lonlat(
                        other.target_ra, other.target_dec, not_found_nan=False
                    )
                except NotFoundError:
                    return None
                if other.target_distance == self.target_distance:
                    return 'same'
                elif other.target_distance - self.target_distance > 0:
                    return 'hidden'
                else:
                    return 'transit'

            assert isinstance(other, Body)
            if (
                other.target_body_id == self.target_body_id
                or np.allclose(other._target_obsvec, self._target_obsvec)
            ):
                return 'same'
            return self._occultation_classification(other)

    def _occultation_classification(self, other: 'Body') -> None | str:
        """
        Classify disc overlap (``occult`` equivalent): samples each body's
        limb and centre and tests angular containment within the other's
        projected limb.
        """
        n = 180
        ra_s, dec_s = self.limb_radec(npts=n, close_loop=False)
        ra_o, dec_o = other.limb_radec(npts=n, close_loop=False)

        # A point is "inside" a body's disc if the ray towards it
        # intercepts the body's ellipsoid.
        def fraction_overlapping(body: 'Body', ra_arr, dec_arr):
            lon, _lat = body.radec2lonlat(ra_arr, dec_arr)
            return np.mean(np.isfinite(lon))

        other_on_self = fraction_overlapping(self, ra_o, dec_o)
        centre_on_self = np.isfinite(
            self.radec2lonlat(other.target_ra, other.target_dec)[0]
        )
        self_on_other = fraction_overlapping(other, ra_s, dec_s)
        centre_on_other = np.isfinite(
            other.radec2lonlat(self.target_ra, self.target_dec)[0]
        )

        overlaps = (
            other_on_self > 0 or self_on_other > 0
            or centre_on_self or centre_on_other
        )
        if not overlaps:
            return None
        in_front = other.target_distance < self.target_distance
        fully_covered = other_on_self >= 1.0 and self_on_other == 0.0
        if in_front:
            return 'transit' if fully_covered else 'part transit'
        return 'hidden' if fully_covered else 'part hidden'

    def test_if_other_body_visible(
        self, other: 'str | int | Body | BasicBody', **kwargs
    ) -> bool:
        """False only if the other body is fully hidden behind the target."""
        return self.other_body_los_intercept(other, **kwargs) != 'hidden'

    # ------------------------------------------------------------------
    # Limb
    # ------------------------------------------------------------------
    def _rolls(self, npts: int) -> torch.Tensor:
        """The cutting half-planes' roll angles of an ``npts``-point curve,
        on the device of a scene call of that size (``scene_device``)."""
        device = scene_device(npts, self.device)
        return 2 * math.pi * torch.arange(
            npts, dtype=torch.float64, device=device
        ) / npts

    def _limb_targvec(
        self,
        npts: int = 360,
        close_loop: bool = True,
        method: str = 'TANGENT/ELLIPSOID',
        corloc: str = 'ELLIPSOID LIMB',
    ) -> torch.Tensor:
        """
        Limb points in the body-fixed frame (``limbpt`` equivalent): cutting
        half-planes about the observer-target axis with reference vector
        [0, 0, 1], per-point light-time epochs (corloc='ELLIPSOID LIMB').
        A tensor on the device of the call.
        """
        points = self._engine.limbpt(
            self.et, self.radii, self._rolls(npts), self._sub_consts()
        )
        if close_loop:
            points = torch.cat([points, points[:1]])
        return points

    def limb_radec(self, *, alt: float = 0.0, **kwargs):
        """RA/Dec coordinates of the target's limb."""
        with _AdjustedSurfaceAltitude(self, alt):
            return self._targvec_arr2radec_arrs(self._limb_targvec(**kwargs))

    def limb_lonlat(
        self, alt: float = 0.0, *, planetocentric: bool = False, **kwargs
    ):
        """Planetographic lonlat coordinates of the target's limb."""
        with _AdjustedSurfaceAltitude(self, alt):
            lons, lats = self.targvec2lonlat(
                self._limb_targvec(**kwargs), planetocentric=planetocentric
            )
            return _host_array(lons), _host_array(lats)

    def limb_radec_by_illumination(self, *, alt: float = 0.0, **kwargs):
        """Dayside/nightside split of :func:`limb_radec` (NaN-masked)."""
        with _AdjustedSurfaceAltitude(self, alt):
            targvec_arr = self._limb_targvec(**kwargs)
            ra, dec = self._targvec_arr2radec_arrs(targvec_arr)
            lit = _host_array(self._illumf_from_targvec_radians(targvec_arr)[4])
            return (
                np.where(lit, ra, np.nan), np.where(lit, dec, np.nan),
                np.where(lit, np.nan, ra), np.where(lit, np.nan, dec),
            )

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
    # Terminator
    # ------------------------------------------------------------------
    def _terminator_targvec(
        self, *, npts: int, only_visible: bool, close_loop: bool, alt: float,
        method: str, corloc: str,
    ) -> torch.Tensor:
        with _AdjustedSurfaceAltitude(self, alt):
            # the JAX package's test: 'PENUMBRAL' also contains 'UMBRAL'
            umbral = 'UMBRAL' in method.upper()
            targvec_arr = self._engine.termpt(
                self.et, self.radii, self._rolls(npts), self._sub_consts(),
                umbral=umbral,
            )
            if close_loop:
                targvec_arr = torch.cat([targvec_arr, targvec_arr[:1]])
            if only_visible:
                visible = self._test_if_targvec_visible_batch(
                    targvec_arr, on_surface=alt == 0.0
                )
                targvec_arr = torch.where(
                    visible[..., None], targvec_arr, math.nan
                )
            return targvec_arr

    def terminator_radec(
        self, npts: int = 360, *, only_visible: bool = True,
        close_loop: bool = True, alt: float = 0.0,
        method: str = 'UMBRAL/TANGENT/ELLIPSOID',
        corloc: str = 'ELLIPSOID TERMINATOR',
    ):
        """RA/Dec coordinates of the day/night terminator."""
        return self._targvec_arr2radec_arrs(
            self._terminator_targvec(
                npts=npts, only_visible=only_visible, close_loop=close_loop,
                alt=alt, method=method, corloc=corloc,
            )
        )

    def terminator_lonlat(
        self, npts: int = 360, *, only_visible: bool = False,
        close_loop: bool = True, alt: float = 0.0,
        planetocentric: bool = False,
        method: str = 'UMBRAL/TANGENT/ELLIPSOID',
        corloc: str = 'ELLIPSOID TERMINATOR',
    ):
        """Planetographic lonlat coordinates of the terminator."""
        lons, lats = self.targvec2lonlat(
            self._terminator_targvec(
                npts=npts, only_visible=only_visible, close_loop=close_loop,
                alt=alt, method=method, corloc=corloc,
            ),
            planetocentric=planetocentric, alt=alt,
        )
        return _host_array(lons), _host_array(lats)

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

    def ring_radec(
        self, radius: float, npts: int = 360, only_visible: bool = True
    ):
        """RA/Dec arrays of a circular ring of the given radius."""
        lons = np.deg2rad(np.linspace(0, 360, npts))
        alt = radius - self.r_eq
        targvecs = self._lonlat2targvec_radians(
            lons, np.zeros_like(lons), alt=alt, not_visible_nan=only_visible
        )
        ra, dec = self._obsvec2radec_radians(self._targvec2obsvec(targvecs))
        return np.rad2deg(ra), np.rad2deg(dec)

    # ------------------------------------------------------------------
    # Lonlat grid
    # ------------------------------------------------------------------
    def visible_lonlat_grid_radec(
        self, interval: float = 30, **kwargs
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Gridlines of constant lon and lat (for wireframe plotting)."""
        lon_radec = self.visible_lon_grid_radec(
            np.arange(0, 360, interval), **kwargs
        )
        lat_radec = self.visible_lat_grid_radec(
            np.arange(-90, 90, interval), **kwargs
        )
        return lon_radec + lat_radec

    def visible_lon_grid_radec(
        self, lons, npts: int = 60, *, lat_limit: float = 90.0,
        alt: float = 0.0, planetocentric: bool = False,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """RA/Dec lines of constant longitude (invisible points NaN)."""
        lats = np.linspace(-lat_limit, lat_limit, npts)
        out = []
        for lon in lons:
            lon_arr = np.full(npts, lon)
            lat_arr = lats
            if planetocentric:
                lon_arr, lat_arr = self.centric2graphic_lonlat(lon_arr, lats)
            ra, dec = self.lonlat2radec(
                lon_arr, lat_arr, alt=alt, not_visible_nan=True
            )
            out.append((np.asarray(ra), np.asarray(dec)))
        return out

    def visible_lat_grid_radec(
        self, lats, npts: int = 120, *, lat_limit: float = 90.0,
        alt: float = 0.0, planetocentric: bool = False,
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """RA/Dec lines of constant latitude (invisible points NaN)."""
        lons = np.linspace(0, 360, npts)
        out = []
        for lat in lats:
            if abs(lat) > lat_limit:
                continue
            lon_arr = lons
            lat_arr = np.full(npts, lat)
            if planetocentric:
                lon_arr, lat_arr = self.centric2graphic_lonlat(lons, lat_arr)
            ra, dec = self.lonlat2radec(
                lon_arr, lat_arr, alt=alt, not_visible_nan=True
            )
            out.append((np.asarray(ra), np.asarray(dec)))
        return out

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

    def get_description(self, multiline: bool = True) -> str:
        """Human-readable description of the observation."""
        return '{t} ({tid}){alt}{nl}from {o}{nl}at {d}'.format(
            t=self.target,
            tid=self.target_body_id,
            alt=(
                f', alt = {self._alt_adjustment:g} km'
                if self._alt_adjustment != 0.0
                else ''
            ),
            nl=('\n' if multiline else ' '),
            o=self.observer,
            d=self.dtm.strftime('%Y-%m-%d %H:%M %Z'),
        )


def _spice_rotate(angle: float, axis: int) -> np.ndarray:
    """Coordinate rotation matrix (``spice.rotate`` convention)."""
    c, s = math.cos(angle), math.sin(angle)
    if axis == 1:
        return np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    if axis == 2:
        return np.array([[c, 0, -s], [0, 1.0, 0], [s, 0, c]])
    return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])


# Wireframe plotting methods are defined in _body_plotting and attached to
# Body there (kept in a separate module for readability).
from . import _body_plotting  # noqa: E402,F401  (attaches plotting methods)
