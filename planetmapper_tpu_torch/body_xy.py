"""
BodyXY: the pixel/backplane render core (port of ``planetmapper_tpu.body_xy``).

Ported: the constructor, the disc-parameter interface, the pixel <->
angular affine, the fused 26-backplane pipeline
(:func:`BodyXY.generate_backplanes_fused`, which runs
:func:`..pipeline.compute_backplanes`), the map coordinates
(:func:`BodyXY.generate_map_coordinates`, ``get_x_map``/``get_y_map`` and
the lonlat/targvec/illumination/obsvec/radec maps behind them) and
:func:`BodyXY.map_img`. The backplane registry, the other map getters and
the matplotlib transforms are listed in ROADMAP.md.

Each BodyXY carries the device its pixel pipeline and its map reprojection
run on (``device=``; cuda by default, which raises without a card, and cpu
only when asked for with ``device='cpu'``). The map coordinates (lonlat ->
targvec -> illumination -> obsvec -> RA/Dec -> x/y) are float64 tensors on
that device for a map of more than ``_device.BULK_ELEMENTS`` samples (on
the CPU for a smaller one), cached there; ``get_x_map``/``get_y_map`` copy
them out as numpy arrays, ``map_img`` reads them where they are.
"""

from __future__ import annotations

import datetime
import math
from typing import Any, Literal

import numpy as np
import torch

from ._device import f64, resolve_device, scene_device
from .base import (
    _as_readonly_view,
    _cache_clearable_result,
    _cache_stable_result,
    _return_readonly_array,
)
from .body import (
    Body,
    _adjust_surface_altitude_decorator,
    _cache_clearable_alt_dependent_result,
)
from .ops.projections import (
    ProjectionTransformer,
    ProjStringError,
    transformer_from_proj_string,
)
from .progress import progress_decorator


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

    @_cache_clearable_result
    def _get_angular2xy_matrix(self) -> np.ndarray:
        return np.linalg.inv(self._get_xy2angular_matrix())

    def _obsvec2xy(self, obsvec):
        """Observer-frame vectors -> image pixels (tensors, numpy arrays or,
        for one vector, floats, as :meth:`_obsvec2angular` gives them)."""
        angular_x, angular_y = self._obsvec2angular(obsvec)
        m = self._get_angular2xy_matrix()
        return tuple(
            float(m[i, 0]) * angular_x + float(m[i, 1]) * angular_y
            + float(m[i, 2]) for i in range(2)
        )

    def radec2xy(self, ra, dec):
        """RA/Dec -> image pixel coordinates."""
        return self._maybe_transform_as_arrays(self._radec2xy, ra, dec)

    def _radec2xy(self, ra, dec):
        return self._obsvec2xy(self._radec2obsvec_norm(ra, dec))

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

    def _make_empty_map(self, nz: int | None = None, **map_kwargs) -> np.ndarray:
        n0, n1 = self._get_lonlat_map(**map_kwargs).shape[:2]
        shape = (n0, n1) if nz is None else (n0, n1, nz)
        return np.full(shape, np.nan)

    # -- maps: float64 tensors where _device.scene_device puts the map (this
    # body's device for more than BULK_ELEMENTS samples, else the CPU),
    # cached there; get_x_map and get_y_map copy them out ---------------
    @_cache_stable_result
    @_adjust_surface_altitude_decorator
    @_return_readonly_array
    def _get_lonlat_map(self, **map_kwargs) -> np.ndarray:
        lons, lats, *_ = self.generate_map_coordinates(**map_kwargs)
        lonlat_map = np.stack([np.asarray(lons) % 360, np.asarray(lats)],
                              axis=-1)
        lonlat_map[~np.isfinite(lonlat_map)] = np.nan
        return lonlat_map

    @_cache_stable_result
    @progress_decorator
    @_adjust_surface_altitude_decorator
    def _targvec_map(self, **map_kwargs) -> torch.Tensor:
        lonlats = self._get_lonlat_map(**map_kwargs)
        device = scene_device(lonlats[..., 0].size, self.device)
        lon, lat = f64(np.deg2rad(lonlats), device).unbind(-1)
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

    def get_x_map(self, **map_kwargs) -> np.ndarray:
        """Map of x pixel coordinates of each location."""
        return self._get_xy_map(**map_kwargs)[:, :, 0]

    def get_y_map(self, **map_kwargs) -> np.ndarray:
        """Map of y pixel coordinates of each location."""
        return self._get_xy_map(**map_kwargs)[:, :, 1]

    @_cache_clearable_alt_dependent_result
    def _get_map_samples(self, **map_kwargs):
        """The x/y maps' :class:`..ops.interp_device.MapSamples` on this
        body's device (made once per map and disc, from the device maps)."""
        from .ops.interp_device import _device_xy

        xy_map = self._xy_map(**map_kwargs)
        return _device_xy(xy_map[..., 0], xy_map[..., 1], self.device)

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
        """
        spline_k = {'linear': 1, 'quadratic': 2, 'cubic': 3}
        if interpolation in spline_k:
            interpolation = spline_k[interpolation]  # type: ignore[index]
        if isinstance(img, torch.Tensor):
            img = img.to(self.device)
        else:
            img = torch.as_tensor(np.asarray(img), device=self.device)
        if img.shape[-2:] != (self._ny, self._nx):
            raise ValueError(
                f'The input `img` shape {tuple(img.shape)!r} is inconsistent '
                f'with the body\'s image size (ny={self._ny}, nx={self._nx})'
            )
        samples = self._get_map_samples(**map_kwargs)

        from .ops import interp_device, pchip_device

        if interpolation == 'nearest':
            if not img.is_floating_point():
                img = img.to(torch.float64)
            out = interp_device.nearest_interpolation_device(img, samples)
        elif isinstance(interpolation, (int, tuple)):
            out = interp_device.spline_interpolation_device(
                img.to(torch.float64), samples,
                interpolation=interpolation, warn_nan=warn_nan,
                propagate_nan=propagate_nan,
                spline_smoothing=spline_smoothing,
            )
        elif interpolation == 'smooth':
            out = pchip_device.smooth_interpolation_device(
                img.to(torch.float64), samples,
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
