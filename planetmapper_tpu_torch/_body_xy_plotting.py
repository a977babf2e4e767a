"""
Plotting for :class:`BodyXY` (port of ``planetmapper_tpu._body_xy_plotting``):
pixel-coordinate wireframes, map-projection wireframes, image/map display
helpers and the rasterised wireframe overlays stored in FITS output (the
WIREFRAME HDU). API parity with the plotting sections of the reference
body_xy.py, in the same artist-spec idiom as :mod:`._body_plotting`.
matplotlib is imported by the functions that draw; the curves reach it as
numpy arrays.
"""

from __future__ import annotations

import functools
import io
import math
import operator
from typing import Any, Callable, Literal, NamedTuple

import numpy as np

from .body import _AdjustedSurfaceAltitude
from .body_xy import BodyXY, _extract_map_kwargs_from_dict


def plot_wireframe_xy(
    self,
    ax=None,
    *,
    scale_factor: float | None = None,
    add_axis_labels: bool | None = None,
    aspect_adjustable: Literal['box', 'datalim'] | None = 'box',
    show: bool = False,
    freeze_transform: bool = True,
    **wireframe_kwargs,
):
    """Wireframe plot in image pixel coordinates."""
    import matplotlib.pyplot as plt

    transform = self._get_matplotlib_angular_fixed2xy_transform()
    ax = self._plot_wireframe(
        coordinate_func=self.radec2angular,
        scale_factor=scale_factor,
        transform=transform.frozen() if freeze_transform else transform,
        aspect_adjustable=aspect_adjustable,
        ax=ax,
        **wireframe_kwargs,
    )
    unscaled = scale_factor is None
    if unscaled and self._test_if_img_size_valid():
        ax.set_xlim(-0.5, self._nx - 0.5)
        ax.set_ylim(-0.5, self._ny - 0.5)
    if add_axis_labels or (add_axis_labels is None and unscaled):
        ax.set_xlabel('x (pixels)')
        ax.set_ylabel('y (pixels)')
    if show:
        plt.show()
    return ax


# ---------------------------------------------------------------------------
# Map wireframes: gridline curves + projection furniture as specs
# ---------------------------------------------------------------------------
class _MapCurve(NamedTuple):
    """One gridline of a map wireframe, in lon/lat, pre-projection."""

    lons: np.ndarray
    lats: np.ndarray
    component: str
    overlays: tuple[str, ...] = ()


def _map_grid_curves(
    projection: str,
    grid_interval: float,
    grid_lat_limit: float,
    indicate_equator: bool,
    indicate_prime_meridian: bool,
):
    """Lon/lat gridline curves of a map wireframe (projection-aware:
    azimuthal projections split meridians at the origin pole so each
    half plots as its own curve)."""
    azimuthal = projection in {'azimuthal', 'azimuthal equal area'}
    if azimuthal:
        lat_runs = [
            np.linspace(-grid_lat_limit, 0, 360),
            np.linspace(0, grid_lat_limit, 360),
        ]
    else:
        lat_runs = [np.linspace(-grid_lat_limit, grid_lat_limit, 720)]

    for lon in np.arange(0, 360.0001, grid_interval):
        if lon == 360 or (lon == 0 and projection == 'rectangular'):
            continue
        emphasise = lon == 0 and indicate_prime_meridian
        for lats in lat_runs:
            yield _MapCurve(
                np.full(lats.size, lon), lats, 'grid',
                ('prime_meridian',) if emphasise else (),
            )

    lons = np.linspace(0, 360, 720)
    for lat in np.arange(-90, 90.0001, grid_interval):
        if abs(lat) >= 90 or abs(lat) > grid_lat_limit:
            continue
        emphasise = lat == 0 and indicate_equator
        yield _MapCurve(
            lons, np.full(lons.size, lat), 'grid',
            ('equator',) if emphasise else (),
        )


def _map_boundary_curve(self, projection: str, map_kw_used: dict):
    """Closed outline of the projection's valid domain (None for maps
    that fill their bounding box)."""
    t = np.linspace(0, -2 * np.pi, 100)
    if projection == 'orthographic':
        # The disc outline of an oblate spheroid seen pole-on at `lat`:
        # unit equatorial radius, polar extent from the flattening
        b = self.r_polar / self.r_eq
        theta = math.radians(map_kw_used['lat'])
        semi_minor = math.hypot(
            math.sin(theta), b * math.cos(theta)
        )
        return np.cos(t), semi_minor * np.sin(t)
    if projection in {'azimuthal', 'azimuthal equal area'}:
        return np.cos(t), np.sin(t)
    return None


def _decorate_rectangular_axes(self, ax, grid_interval: float) -> None:
    lon_ticks = np.arange(0, 360.0001, grid_interval)
    lat_ticks = np.arange(-90, 90.0001, grid_interval)
    positive_dir = self.positive_longitude_direction
    ax.set_xlim(*((360, 0) if positive_dir == 'W' else (0, 360)))
    ax.set_ylim(-90, 90)
    ax.set_xlabel(f'Planetographic longitude ({positive_dir})')
    ax.set_ylabel('Planetographic latitude')
    ax.set_xticks(lon_ticks)
    ax.set_xticklabels(
        [f'{t:.0f}°' if t % 90 == 0 else '' for t in lon_ticks]
    )
    ax.set_yticks(lat_ticks)
    ax.set_yticklabels(
        [f'{t:.0f}°' if t % 90 == 0 else '' for t in lat_ticks]
    )


def plot_map_wireframe(
    self,
    ax=None,
    *,
    label_poles: bool = True,
    add_title: bool = True,
    add_axis_labels: bool = True,
    grid_interval: float = 30,
    grid_lat_limit: float = 90,
    indicate_equator: bool = True,
    indicate_prime_meridian: bool = True,
    aspect_adjustable: Literal['box', 'datalim'] | None = 'box',
    formatting=None,
    **map_and_formatting_kwargs,
):
    """Wireframe (gridlines, boundary, pole labels) of a map projection."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()

    map_kwargs, common_formatting = _extract_map_kwargs_from_dict(
        map_and_formatting_kwargs
    )
    if 'common_formatting' in common_formatting:
        common_formatting |= common_formatting.pop('common_formatting')
    kw = self._get_wireframe_kw(
        common_formatting=common_formatting, formatting=formatting
    )

    *_, transformer, map_kw_used = self.generate_map_coordinates(
        **map_kwargs
    )
    projection = map_kw_used['projection']

    if aspect_adjustable is not None:
        ax.set_aspect(1, adjustable=aspect_adjustable)

    for curve in _map_grid_curves(
        projection, grid_interval, grid_lat_limit,
        indicate_equator, indicate_prime_meridian,
    ):
        fmt = functools.reduce(
            operator.or_,
            (kw[o] for o in curve.overlays),
            dict(kw[curve.component]),
        )
        ax.plot(*transformer.transform(curve.lons, curve.lats), **fmt)

    boundary = _map_boundary_curve(self, projection, map_kw_used)
    if boundary is not None:
        ax.plot(*boundary, **kw['map_boundary'])

    if label_poles and projection != 'rectangular':
        for lat, s in ((90, 'N'), (-90, 'S')):
            x, y = transformer.transform(0, lat)
            if math.isfinite(x) and math.isfinite(y):
                ax.text(x, y, s, **kw['pole'])

    if add_axis_labels:
        if projection == 'rectangular':
            self._decorate_rectangular_axes(ax, grid_interval)
        elif projection in {
            'orthographic', 'azimuthal', 'azimuthal equal area'
        }:
            ax.set_xticks([])
            ax.set_yticks([])

    if add_title:
        ax.set_title(self.get_description(multiline=True))
    return ax


_plot_map_wireframe_impl = plot_map_wireframe


# ---------------------------------------------------------------------------
# Image / map display helpers
# ---------------------------------------------------------------------------
class _CoordSystem(NamedTuple):
    """How plot_img handles one choice of ``coordinates=``."""

    wireframe: Callable
    limits: Callable
    transform: Callable  # (self, ax, angular_kwargs) -> mpl transform


_PLOT_IMG_SYSTEMS: dict[str, _CoordSystem] = {
    'xy': _CoordSystem(
        lambda self, kw: self.plot_wireframe_xy,
        lambda self, kw: self.get_img_limits_xy,
        lambda self, ax, kw: ax.transData,
    ),
    'radec': _CoordSystem(
        lambda self, kw: self.plot_wireframe_radec,
        lambda self, kw: self.get_img_limits_radec,
        lambda self, ax, kw: self.matplotlib_xy2radec_transform(ax),
    ),
    'km': _CoordSystem(
        lambda self, kw: self.plot_wireframe_km,
        lambda self, kw: self.get_img_limits_km,
        lambda self, ax, kw: self.matplotlib_xy2km_transform(ax),
    ),
    'angular': _CoordSystem(
        lambda self, kw: functools.partial(
            self.plot_wireframe_angular, **kw
        ),
        lambda self, kw: functools.partial(
            self.get_img_limits_angular, **kw
        ),
        lambda self, ax, kw: self.matplotlib_xy2angular_transform(
            ax, **kw
        ),
    ),
}


def plot_img(
    self,
    img: np.ndarray,
    ax=None,
    *,
    coordinates: Literal['xy', 'radec', 'km', 'angular'] = 'xy',
    wireframe_kwargs: dict[str, Any] | None = None,
    add_wireframe: bool = True,
    angular_kwargs=None,
    zorder: float = 0.0,
    **kwargs,
):
    """Plot an observed image with a wireframe in a chosen coordinate
    system (RGB(A) cubes via imshow, single frames via pcolormesh)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    try:
        system = _PLOT_IMG_SYSTEMS[coordinates]
    except KeyError:
        raise ValueError(f'Unknown coordinates {coordinates!r}') from None
    angular_kwargs = angular_kwargs or {}

    if add_wireframe:
        system.wireframe(self, angular_kwargs)(
            ax=ax, **(wireframe_kwargs or {})
        )
    transform = system.transform(self, ax, angular_kwargs)

    img = np.asarray(img)
    if img.ndim == 3:
        if img.shape[2] == 3:  # RGB -> RGBA for imshow's transform path
            alpha = np.ones_like(img[:, :, :1])
            img = np.concatenate([img, alpha], axis=2)
        ax.relim()
        xlim0, ylim0 = ax.get_xlim(), ax.get_ylim()
        handle = ax.imshow(
            img, origin='lower', transform=transform, zorder=zorder,
            **kwargs,
        )
        # Grow (never shrink) the view to cover the image footprint
        img_xlim, img_ylim = system.limits(self, angular_kwargs)()
        ax.set_xlim(min(xlim0[0], img_xlim[0]), max(xlim0[1], img_xlim[1]))
        ax.set_ylim(min(ylim0[0], img_ylim[0]), max(ylim0[1], img_ylim[1]))
    else:
        handle = ax.pcolormesh(
            self.get_x_img(), self.get_y_img(), img, transform=transform,
            zorder=zorder, **kwargs,
        )
    return handle


def plot_map(
    self,
    map_img: np.ndarray,
    ax=None,
    *,
    wireframe_kwargs: dict[str, Any] | None = None,
    add_wireframe: bool = True,
    **kwargs,
):
    """Plot a mapped image with appropriate extents and gridlines."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    map_kwargs, kwargs = _extract_map_kwargs_from_dict(kwargs)
    _, _, xx, yy, _, _ = self.generate_map_coordinates(**map_kwargs)
    handle = ax.pcolormesh(xx, yy, map_img, **kwargs)
    if add_wireframe:
        self.plot_map_wireframe(
            ax=ax, **(wireframe_kwargs or {}), **map_kwargs
        )
    return handle


def imshow_map(self, *args, **kwargs):
    """Alias for plot_map (backwards compatibility). :meta private:"""
    return self.plot_map(*args, **kwargs)


# ---------------------------------------------------------------------------
# Rasterised overlays (the WIREFRAME HDU in FITS output)
# ---------------------------------------------------------------------------
def _render_figure_to_array(fig, dpi: int, rgba: bool) -> np.ndarray:
    """Rasterise a Figure to a uint8 array, greyscale unless ``rgba``,
    flipped to the FITS row-order convention."""
    import matplotlib.pyplot as plt

    with io.BytesIO() as buf:
        fig.savefig(buf, format='raw', dpi=dpi, transparent=rgba)
        flat = np.frombuffer(buf.getvalue(), dtype=np.uint8)
    width, height = fig.canvas.get_width_height()
    plt.close(fig)
    img = flat.reshape((height, width, 4))
    if not rgba:
        img = np.asarray(img[:, :, :3].mean(axis=-1), dtype=np.uint8)
    return np.flipud(img)


def _get_wireframe_overlay(
    self, *, output_size, dpi, nx, ny, rgba, plot_fn
) -> np.ndarray:
    from matplotlib.figure import Figure

    long_side = (output_size or max(nx, ny)) / dpi
    aspect = min(nx, ny) / max(nx, ny)
    figsize = (
        (long_side, long_side * aspect)
        if nx > ny
        else (long_side * aspect, long_side)
    )
    fig = Figure(figsize=figsize, dpi=dpi, facecolor='w')
    ax = fig.add_axes([0, 0, 1, 1], facecolor='w')
    plot_fn(ax)
    ax.axis('off')
    ax.set_xticks([])
    ax.set_yticks([])
    return _render_figure_to_array(fig, dpi, rgba)


def get_wireframe_overlay_img(
    self, output_size: int | None = 1500, dpi: int = 200, rgba: bool = False,
    **plot_kwargs,
) -> np.ndarray:
    """Rasterised wireframe matching the observation's aspect ratio."""
    return self._get_wireframe_overlay(
        output_size=output_size,
        dpi=dpi,
        nx=self._nx,
        ny=self._ny,
        rgba=rgba,
        plot_fn=lambda ax: self.plot_wireframe_xy(
            ax=ax, add_axis_labels=False, add_title=False,
            **dict(color='k') | plot_kwargs,
        ),
    )


def get_wireframe_overlay_map(
    self, output_size: int | None = 1500, dpi: int = 200, rgba: bool = False,
    **map_and_formatting_kwargs,
) -> np.ndarray:
    """Rasterised wireframe matching the map's aspect ratio."""
    map_kwargs, plot_kwargs = _extract_map_kwargs_from_dict(
        map_and_formatting_kwargs
    )
    _, _, xx, yy, _, _ = self.generate_map_coordinates(**map_kwargs)

    def plot_fn(ax):
        self.plot_map_wireframe(
            ax=ax, add_axis_labels=False, add_title=False,
            **dict(color='k') | plot_kwargs, **map_kwargs,
        )
        # Frame the full map extent, padded by half a grid cell
        half_dx = abs(xx[0][1] - xx[0][0]) / 2
        half_dy = abs(yy[1][0] - yy[0][0]) / 2
        ax.set_xlim(np.nanmin(xx) - half_dx, np.nanmax(xx) + half_dx)
        ax.set_ylim(np.nanmin(yy) - half_dy, np.nanmax(yy) + half_dy)

    return self._get_wireframe_overlay(
        output_size=output_size, dpi=dpi,
        nx=xx.shape[1], ny=yy.shape[0], rgba=rgba, plot_fn=plot_fn,
    )


def _attach() -> None:
    from .body import _adjust_surface_altitude_decorator

    BodyXY.plot_wireframe_xy = plot_wireframe_xy
    BodyXY.plot_map_wireframe = _adjust_surface_altitude_decorator(
        _plot_map_wireframe_impl
    )
    BodyXY._decorate_rectangular_axes = _decorate_rectangular_axes
    BodyXY.plot_img = plot_img
    BodyXY.plot_map = plot_map
    BodyXY.imshow_map = imshow_map
    BodyXY._get_wireframe_overlay = _get_wireframe_overlay
    BodyXY.get_wireframe_overlay_img = get_wireframe_overlay_img
    BodyXY.get_wireframe_overlay_map = get_wireframe_overlay_map


_attach()
