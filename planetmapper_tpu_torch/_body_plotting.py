"""
Wireframe plotting for :class:`Body` (port of
``planetmapper_tpu._body_plotting``; API parity with the plotting section
of the reference, body.py:3036-3833), around a declarative artist
pipeline.

A wireframe is a *list of artist specs* produced by
:func:`_wireframe_artists`: each spec names its matplotlib primitive, the
formatting component it draws with, optional overlay components
(equator/prime-meridian emphasis, hidden-body styling) and its geometry
in RA/Dec, as numpy arrays. A single renderer (:func:`_plot_wireframe`)
resolves formatting, converts geometry through the requested coordinate
system and replays the specs onto the axes. The geometry (gridlines,
limb, terminator, rings) comes from the body's batched tensor code on the
device the routing rule gives each call; matplotlib, imported only by the
functions that draw, sees numpy arrays alone.
"""

from __future__ import annotations

import functools
import operator
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Literal

import numpy as np

from .body import (
    DEFAULT_WIREFRAME_FORMATTING,
    Body,
    WireframeComponent,
    _AdjustedSurfaceAltitude,
)


# ---------------------------------------------------------------------------
# Artist specs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class _ArtistSpec:
    """One matplotlib artist of a wireframe, before coordinate mapping."""

    kind: Literal['curve', 'marker', 'label']
    component: str
    ras: Any
    decs: Any
    overlays: tuple[str, ...] = ()
    text: str = ''
    #: curves run through the vectorised transform + wraparound filter;
    #: markers/labels are single points mapped with the scalar transform
    is_curve: bool = field(init=False, default=False)

    def __post_init__(self):
        object.__setattr__(self, 'is_curve', self.kind == 'curve')


def _wireframe_artists(
    body,
    *,
    grid_interval: float,
    grid_lat_limit: float,
    planetocentric_grid: bool,
    indicate_equator: bool,
    indicate_prime_meridian: bool,
    label_poles: bool,
) -> Iterable[_ArtistSpec]:
    """
    Generate every artist of a body wireframe as a spec. Geometry is
    fetched from the batched device paths (`visible_lon_grid_radec`,
    `limb_radec`, `terminator_radec`, `ring_radec`, ...); nothing here
    touches matplotlib.
    """
    lons = np.arange(0, 360, grid_interval)
    lon_curves = body.visible_lon_grid_radec(
        lons, lat_limit=grid_lat_limit, planetocentric=planetocentric_grid
    )
    for lon, (ra, dec) in zip(lons, lon_curves):
        emphasise = lon == 0 and indicate_prime_meridian
        yield _ArtistSpec(
            'curve', 'grid', ra, dec,
            overlays=('prime_meridian',) if emphasise else (),
        )

    lats = [
        float(lat)
        for lat in np.arange(-90, 90, grid_interval)
        if abs(lat) <= grid_lat_limit
    ]
    lat_curves = body.visible_lat_grid_radec(
        lats, lat_limit=grid_lat_limit, planetocentric=planetocentric_grid
    )
    for lat, (ra, dec) in zip(lats, lat_curves):
        emphasise = lat == 0 and indicate_equator
        yield _ArtistSpec(
            'curve', 'grid', ra, dec,
            overlays=('equator',) if emphasise else (),
        )

    yield _ArtistSpec('curve', 'limb', *body.limb_radec())
    yield _ArtistSpec('curve', 'terminator', *body.terminator_radec())
    ra_day, dec_day, _, _ = body.limb_radec_by_illumination()
    yield _ArtistSpec('curve', 'limb_illuminated', ra_day, dec_day)

    for radius in body.ring_radii:
        yield _ArtistSpec('curve', 'ring', *body.ring_radec(radius))

    if label_poles:
        for lon, lat, s in body.get_poles_to_plot():
            ra, dec = body.lonlat2radec(lon, lat, not_visible_nan=False)
            yield _ArtistSpec('label', 'pole', ra, dec, text=s)

    for lon, lat in body.coordinates_of_interest_lonlat:
        if body.test_if_lonlat_visible(lon, lat):
            ra, dec = body.lonlat2radec(lon, lat, not_visible_nan=False)
            yield _ArtistSpec(
                'marker', 'coordinate_of_interest_lonlat', ra, dec
            )
    for ra, dec in body.coordinates_of_interest_radec:
        yield _ArtistSpec(
            'marker', 'coordinate_of_interest_radec', ra, dec
        )

    for other in body.other_bodies_of_interest:
        hidden = not body.test_if_other_body_visible(other)
        name = f'({other.target})' if hidden else other.target
        hide = ('hidden_other_body_of_interest_label',) if hidden else ()
        yield _ArtistSpec(
            'label', 'other_body_of_interest_label',
            other.target_ra, other.target_dec,
            overlays=hide, text=name + '\n',
        )
        hide = ('hidden_other_body_of_interest_marker',) if hidden else ()
        yield _ArtistSpec(
            'marker', 'other_body_of_interest_marker',
            other.target_ra, other.target_dec, overlays=hide,
        )


# ---------------------------------------------------------------------------
# Formatting resolution
# ---------------------------------------------------------------------------
@staticmethod
def _get_wireframe_kw(
    *,
    base_formatting: dict[str, Any] | None = None,
    common_formatting: dict[str, Any] | None = None,
    formatting: dict[WireframeComponent, dict[str, Any]] | None = None,
) -> dict[WireframeComponent, dict[str, Any]]:
    """
    Resolve per-component matplotlib kwargs by folding the formatting
    layers lowest-to-highest precedence: base < package defaults
    ('all' then per-component) < caller common kwargs < caller
    formatting ('all' then per-component).
    """
    formatting = formatting or {}
    common = {
        k: v
        for k, v in (common_formatting or {}).items()
        if k not in ('show', 'dms_ticks')
    }

    def layers(component):
        return (
            base_formatting or {},
            DEFAULT_WIREFRAME_FORMATTING.get('all', {}),
            DEFAULT_WIREFRAME_FORMATTING.get(component, {}),
            common,
            formatting.get('all', {}),
            formatting.get(component, {}),
        )

    components = DEFAULT_WIREFRAME_FORMATTING.keys() | formatting.keys()
    resolved = {
        component: functools.reduce(operator.or_, layers(component), {})
        for component in components
    }
    return defaultdict(dict, resolved)


# ---------------------------------------------------------------------------
# Coordinate helpers
# ---------------------------------------------------------------------------
@staticmethod
def _get_local_affine_transform_matrix(
    coordinate_func: Callable[[float, float], tuple[float, float]],
    location: tuple[float, float],
) -> np.ndarray:
    """
    First-order (affine) approximation of ``coordinate_func`` around
    ``location``, from finite differences along each input axis.
    """
    x0, y0 = location
    origin = np.array(coordinate_func(x0, y0), dtype=float)
    d_dx = np.array(coordinate_func(x0 + 1.0, y0), dtype=float) - origin
    d_dy = np.array(coordinate_func(x0, y0 + 1.0), dtype=float) - origin
    offset = origin - d_dx * x0 - d_dy * y0
    return np.vstack(
        [np.column_stack([d_dx, d_dy, offset]), (0.0, 0.0, 1.0)]
    )


def _get_matplotlib_transform(self, coordinate_func, location, ax):
    import matplotlib.transforms

    transform = matplotlib.transforms.Affine2D(
        self._get_local_affine_transform_matrix(coordinate_func, location)
    )
    return transform + ax.transData if ax else transform


def matplotlib_radec2km_transform(self, ax=None):
    """Affine matplotlib transform from radec to km coordinates."""
    return self._get_matplotlib_transform(
        self.radec2km, (self.target_ra, self.target_dec), ax
    )


def matplotlib_km2radec_transform(self, ax=None):
    return self._get_matplotlib_transform(self.km2radec, (0.0, 0.0), ax)


def matplotlib_radec2angular_transform(self, ax=None, **angular_kwargs):
    return self._get_matplotlib_transform(
        functools.partial(self.radec2angular, **angular_kwargs),
        (self.target_ra, self.target_dec),
        ax,
    )


def matplotlib_angular2radec_transform(self, ax=None, **angular_kwargs):
    return self._get_matplotlib_transform(
        functools.partial(self.angular2radec, **angular_kwargs),
        (0.0, 0.0),
        ax,
    )


def get_poles_to_plot(self) -> list[tuple[float, float, str]]:
    """
    Poles to label when plotting: the visible poles as 'N'/'S', or both
    poles in brackets when neither is visible.
    """
    poles = ((0, 90, 'N'), (0, -90, 'S'))
    visible = [
        (lon, lat, s)
        for lon, lat, s in poles
        if self.test_if_lonlat_visible(lon, lat)
    ]
    return visible or [(lon, lat, f'({s})') for lon, lat, s in poles]


@staticmethod
def _add_nans_for_radec_array_wraparounds(
    ras: Iterable[float], decs: Iterable[float], *, threshold: float = 270.0
) -> tuple[np.ndarray, np.ndarray]:
    """Break plotted curves (with NaN points) where RA wraps 0<->360."""
    ras = np.asarray(list(ras), dtype=float)
    decs = np.asarray(list(decs), dtype=float)
    if ras.size < 2:
        return ras, decs
    with np.errstate(invalid='ignore'):
        breaks = np.flatnonzero(np.abs(np.diff(ras)) > threshold) + 1
    return np.insert(ras, breaks, np.nan), np.insert(decs, breaks, np.nan)


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------
def _make_curve_mapper(coordinate_func, additional_array_func):
    """
    Vectorised radec->plot-coords mapping for curve specs, falling back
    to per-point evaluation for scalar-only ``coordinate_func``s
    (user-supplied functions in ``plot_wireframe_custom``).
    """

    def mapper(ras, decs):
        ras = np.asarray(ras, dtype=float)
        decs = np.asarray(decs, dtype=float)
        try:
            xs, ys = coordinate_func(ras, decs)
            xs = np.asarray(xs, dtype=float)
            ys = np.asarray(ys, dtype=float)
            if xs.shape != ras.shape:
                raise TypeError
        except Exception:
            pairs = [coordinate_func(ra, dec) for ra, dec in zip(ras, decs)]
            xs = np.array([p[0] for p in pairs], dtype=float)
            ys = np.array([p[1] for p in pairs], dtype=float)
        if additional_array_func is not None:
            xs, ys = additional_array_func(xs, ys)
        return np.asarray(xs), np.asarray(ys)

    return mapper


def _plot_wireframe(
    self,
    *,
    coordinate_func: Callable[[float, float], tuple[float, float]],
    scale_factor: float | None,
    transform,
    aspect_adjustable: Literal['box', 'datalim'] | None,
    additional_array_func=None,
    ax=None,
    label_poles: bool = True,
    add_title: bool = True,
    grid_interval: float = 30,
    grid_lat_limit: float = 90,
    planetocentric_grid: bool = False,
    indicate_equator: bool = False,
    indicate_prime_meridian: bool = False,
    formatting: dict[WireframeComponent, dict[str, Any]] | None = None,
    alt: float = 0.0,
    **common_formatting,
):
    """Render the artist specs of a wireframe onto ``ax``."""
    import matplotlib.pyplot as plt
    import matplotlib.transforms

    if ax is None:
        ax = plt.gca()

    if transform is None:
        transform = matplotlib.transforms.IdentityTransform()
    if scale_factor is not None:
        transform += matplotlib.transforms.Affine2D().scale(scale_factor)
    transform += ax.transData

    kw = self._get_wireframe_kw(
        base_formatting=dict(transform=transform),
        common_formatting=common_formatting,
        formatting=formatting,
    )
    curve_map = _make_curve_mapper(coordinate_func, additional_array_func)

    renderers = {
        'curve': lambda xy, fmt, spec: ax.plot(*xy, **fmt),
        'marker': lambda xy, fmt, spec: ax.scatter(*xy, **fmt),
        'label': lambda xy, fmt, spec: ax.text(*xy, spec.text, **fmt),
    }

    with _AdjustedSurfaceAltitude(self, alt):
        for spec in _wireframe_artists(
            self,
            grid_interval=grid_interval,
            grid_lat_limit=grid_lat_limit,
            planetocentric_grid=planetocentric_grid,
            indicate_equator=indicate_equator,
            indicate_prime_meridian=indicate_prime_meridian,
            label_poles=label_poles,
        ):
            fmt = functools.reduce(
                operator.or_,
                (kw[o] for o in spec.overlays),
                dict(kw[spec.component]),
            )
            xy = (
                curve_map(spec.ras, spec.decs)
                if spec.is_curve
                else coordinate_func(spec.ras, spec.decs)
            )
            renderers[spec.kind](xy, fmt, spec)

        if add_title:
            ax.set_title(self.get_description(multiline=True))
        if aspect_adjustable is not None:
            ax.set_aspect(1, adjustable=aspect_adjustable)
    return ax


# ---------------------------------------------------------------------------
# Public coordinate-system variants
# ---------------------------------------------------------------------------
def plot_wireframe_radec(
    self,
    ax=None,
    *,
    scale_factor: float | None = None,
    dms_ticks: bool | None = None,
    add_axis_labels: bool | None = None,
    aspect_adjustable: Literal['box', 'datalim'] | None = 'datalim',
    use_shifted_meridian: bool = False,
    show: bool = False,
    **wireframe_kwargs,
):
    """Wireframe plot in RA/Dec coordinates."""
    import matplotlib.pyplot as plt

    from . import utils

    unscaled = scale_factor is None
    if use_shifted_meridian:
        coordinate_func = lambda ra, dec: ((ra + 180.0) % 360.0 - 180.0, dec)
    else:
        coordinate_func = lambda ra, dec: (ra, dec)

    ax = self._plot_wireframe(
        coordinate_func=coordinate_func,
        scale_factor=scale_factor,
        transform=None,
        aspect_adjustable=None,
        ax=ax,
        additional_array_func=self._add_nans_for_radec_array_wraparounds,
        **wireframe_kwargs,
    )
    utils.format_radec_axes(
        ax,
        self.target_dec,
        dms_ticks=unscaled if dms_ticks is None else dms_ticks,
        add_axis_labels=(
            unscaled if add_axis_labels is None else add_axis_labels
        ),
        aspect_adjustable=aspect_adjustable,
    )
    if show:
        plt.show()
    return ax


def plot_wireframe_km(
    self,
    ax=None,
    *,
    scale_factor: float | None = None,
    add_axis_labels: bool | None = None,
    aspect_adjustable: Literal['box', 'datalim'] | None = 'datalim',
    show: bool = False,
    **wireframe_kwargs,
):
    """Wireframe plot in target-plane km coordinates."""
    import matplotlib.pyplot as plt

    ax = self._plot_wireframe(
        coordinate_func=self.radec2km,
        scale_factor=scale_factor,
        transform=None,
        aspect_adjustable=aspect_adjustable,
        ax=ax,
        **wireframe_kwargs,
    )
    if add_axis_labels or (add_axis_labels is None and scale_factor is None):
        ax.set_xlabel('Projected distance (km)')
        ax.set_ylabel('Projected distance (km)')
        ax.ticklabel_format(style='sci', scilimits=(-3, 3))
    if show:
        plt.show()
    return ax


def plot_wireframe_angular(
    self,
    ax=None,
    *,
    origin_ra: float | None = None,
    origin_dec: float | None = None,
    coordinate_rotation: float = 0.0,
    scale_factor: float | None = None,
    add_axis_labels: bool | None = None,
    aspect_adjustable: Literal['box', 'datalim'] | None = 'datalim',
    show: bool = False,
    **wireframe_kwargs,
):
    """Wireframe plot in relative angular coordinates."""
    import matplotlib.pyplot as plt

    ax = self._plot_wireframe(
        coordinate_func=functools.partial(
            self.radec2angular,
            origin_ra=origin_ra,
            origin_dec=origin_dec,
            coordinate_rotation=coordinate_rotation,
        ),
        scale_factor=scale_factor,
        transform=None,
        aspect_adjustable=aspect_adjustable,
        ax=ax,
        **wireframe_kwargs,
    )
    if add_axis_labels or (add_axis_labels is None and scale_factor is None):
        ax.set_xlabel('Angular distance (arcsec)')
        ax.set_ylabel('Angular distance (arcsec)')
    if show:
        plt.show()
    return ax


def plot_wireframe_custom(
    self,
    ax=None,
    coordinate_func=None,
    *,
    transform=None,
    additional_array_func=None,
    **wireframe_kwargs,
):
    """Wireframe plot in a user-defined coordinate system."""
    return self._plot_wireframe(
        coordinate_func=coordinate_func or (lambda ra, dec: (ra, dec)),
        scale_factor=None,
        transform=transform,
        aspect_adjustable=None,
        ax=ax,
        additional_array_func=additional_array_func,
        **wireframe_kwargs,
    )


def _attach() -> None:
    for name, obj in (
        ('get_poles_to_plot', get_poles_to_plot),
        ('_get_local_affine_transform_matrix',
         _get_local_affine_transform_matrix),
        ('_get_matplotlib_transform', _get_matplotlib_transform),
        ('matplotlib_radec2km_transform', matplotlib_radec2km_transform),
        ('matplotlib_km2radec_transform', matplotlib_km2radec_transform),
        ('matplotlib_radec2angular_transform',
         matplotlib_radec2angular_transform),
        ('matplotlib_angular2radec_transform',
         matplotlib_angular2radec_transform),
        ('_get_wireframe_kw', _get_wireframe_kw),
        ('_plot_wireframe', _plot_wireframe),
        ('_add_nans_for_radec_array_wraparounds',
         _add_nans_for_radec_array_wraparounds),
        ('plot_wireframe_radec', plot_wireframe_radec),
        ('plot_wireframe_km', plot_wireframe_km),
        ('plot_wireframe_angular', plot_wireframe_angular),
        ('plot_wireframe_custom', plot_wireframe_custom),
    ):
        setattr(Body, name, obj)


_attach()
