"""
Observation: observed-data I/O, disc fitting, and FITS export (port of
``planetmapper_tpu.observation``).

Uses the package's self-contained FITS and WCS implementations (``io/``,
numpy only; astropy is not required). The FITS output format (PLANMAP
HIERARCH metadata cards, one ImageHDU per backplane, map WCS cards)
matches the JAX package's, so files are interchangeable between the two
packages.

An Observation is a :class:`BodyXY` and runs where its body runs (the
card unless built with ``device='cpu'``): the disc fits are reductions on
that device (``ops/photometry.py``), ``get_mapped_data`` maps the whole
cube in one ``map_img`` call there (the map kernels on a card body) and
copies it to the host once, and ``save_observation`` walks the per-plane
getters. ``data`` and ``header`` stay numpy and :class:`io.fits.Header`.
Both saves write the WIREFRAME overlay HDU by default
(``include_wireframe=True``), which needs matplotlib to render: without it
they raise the ``ImportError`` before any work and write no file.
``run_gui`` opens the GUI (:mod:`.gui`) on this observation.

While a profiler records (:mod:`.tracing`) the open is the span
``pm.obs.open`` (the file read, the header's keywords, the body, the disc),
and a save's primary HDU ``pm.export.primary`` and each backplane's getter
and array ``pm.export.plane`` (counter ``export.planes``); the file's
encoding and write are :mod:`.io.fits`'s.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Callable, Collection, Literal

import numpy as np
import torch

from . import common, host_slots, tracing, utils
from .base import _cache_stable_result
from .body import (
    _adjust_surface_altitude_decorator,
    _AdjustedSurfaceAltitude,
    _cache_clearable_alt_dependent_result,
)
from .body_xy import BodyXY
from .exceptions import warn
from .io import fits
from .io.wcs import WCS
from .progress import (
    SaveMapProgressHookCLI,
    SaveNavProgressHookCLI,
    progress_decorator,
)


class Observation(BodyXY):
    """
    An actual observation of an astronomical body at a specific time,
    created from a data file (FITS or image) or an array. Disc parameters
    initialise from previous PlanetMapper-format headers, then WCS, then a
    centred disc - see the reference documentation for full semantics.
    """

    FITS_FILE_EXTENSIONS = ('.fits', '.fits.gz')
    """File extensions read as FITS; everything else is read as an image."""
    FITS_KEYWORD = 'PLANMAP'
    """Keyword prefix used for metadata added to output FITS headers."""

    def __init__(
        self,
        path: str | os.PathLike | None = None,
        *,
        data: np.ndarray | None = None,
        header: fits.Header | None = None,
        **kwargs,
    ) -> None:
        for forbidden in ('nx', 'ny', 'sz'):
            if forbidden in kwargs:
                raise TypeError(
                    f'Cannot set {forbidden} for Observation objects'
                )
        with tracing.span('pm.obs.open'):
            self._path_arg = path
            self._data_arg = data
            self._header_arg = header
            self.path: str | None = (
                None if path is None
                else str(os.path.expandvars(os.path.expanduser(path)))
            )
            self.header: fits.Header = None  # type: ignore[assignment]
            self._ingest_source(data, header)
            if self.header is not None:
                self._add_kw_from_header(kwargs, self.header)
            ny, nx = self.data.shape[-2:]
            if self.header is None:
                # defer so self.target/utc exist for the card values
                self.header = fits.Header()
                super().__init__(nx=nx, ny=ny, **kwargs)
                self.header = fits.Header(
                    {'OBJECT': self.target, 'DATE-OBS': self.utc}
                )
            else:
                super().__init__(nx=nx, ny=ny, **kwargs)
            # keep the saved constructor arguments consistent with the
            # normalised attributes (repr/copy round-trips)
            if self._data_arg is not None:
                self._data_arg = self.data
            if self._header_arg is not None:
                self._header_arg = self.header

    def _ingest_source(
        self, data: np.ndarray | None, header: fits.Header | None
    ) -> None:
        """Populate self.data/self.header from the path or array input."""
        if self.path is None:
            if data is None:
                raise ValueError('Either `path` or `data` must be provided')
            self.data = data
            if header is not None:
                self.header = header
        else:
            for arg, name in ((data, 'data'), (header, 'header')):
                if arg is not None:
                    raise ValueError(
                        f'`path` and `{name}` are mutually exclusive'
                    )
            self._load_data_from_path()
        self.data = np.asarray(self.data)
        if self.data.ndim == 2:
            self.data = self.data[np.newaxis, ...]

    def __repr__(self) -> str:
        return self._generate_repr(
            'path',
            formatters={
                'data': self._str_array_formatter,
                'header': self._str_header_formatter,
            },
        )

    @staticmethod
    def _str_array_formatter(array: np.ndarray) -> str:
        return f'<{"x".join(map(str, array.shape))} array>'

    @staticmethod
    def _str_header_formatter(header) -> str:
        return f'<{len(header)} card Header>'

    def to_body_xy(self) -> BodyXY:
        """Create a BodyXY with the same parameters as this observation."""
        new = BodyXY(**BodyXY._get_kwargs(self))
        BodyXY._copy_options_to_other(self, new)
        return new

    def _get_equality_tuple(self) -> tuple:
        finite = np.nan_to_num(self.data)
        nan_mask = np.isnan(self.data)
        return (
            self.path,
            finite.data.tobytes(),
            nan_mask.data.tobytes(),
            tuple(self.header.items()),
            super()._get_equality_tuple(),
        )

    def _get_kwargs(self) -> dict[str, Any]:
        kw = super()._get_kwargs()
        del kw['nx'], kw['ny']
        kw.update(
            path=self._path_arg,
            data=self._data_arg,
            header=self._header_arg,
        )
        return kw

    @classmethod
    def _get_default_init_kwargs(cls) -> dict[str, Any]:
        inherited = super()._get_default_init_kwargs()
        del inherited['nx'], inherited['ny']
        return dict(
            path=None, data=None, header=None, target=None, **inherited
        )

    # ------------------------------------------------------------------
    # Data loading
    # ------------------------------------------------------------------
    def _load_data_from_path(self) -> None:
        assert self.path is not None
        is_fits = self.path.endswith(self.FITS_FILE_EXTENSIONS)
        (self._load_fits_data if is_fits else self._load_image_data)()

    def _load_fits_data(self) -> None:
        assert self.path is not None
        with fits.open(self.path) as hdul:
            hdu_idx = next(
                (i for i, h in enumerate(hdul) if h.data is not None), None
            )
            if hdu_idx is None:
                raise ValueError('No data found in provided FITS file')
            self.data = hdul[hdu_idx].data
            if hdu_idx == 0:
                self.header = hdul[0].header.copy()
            else:
                # merge: primary header as the base, data HDU overrides
                merged = hdul[0].header.copy()
                merged.update(hdul[hdu_idx].header.copy())
                self.header = merged
        if self.data.ndim == 2:
            self.data = np.array([self.data])

    def _load_image_data(self) -> None:
        assert self.path is not None
        import PIL.Image

        with PIL.Image.open(self.path) as handle:
            raw = np.asarray(handle)
        frames = np.flipud(raw)
        self.data = (
            frames[np.newaxis] if frames.ndim == 2
            else np.moveaxis(frames, 2, 0)
        )

    #: init-kwarg <- header-keyword resolution table: each row is
    #: (kwarg, candidate header keywords in priority order, transform).
    @classmethod
    def _header_kw_specs(cls):
        pm = cls._make_fits_kw
        eso_to_earth = lambda v: 'EARTH' if str(v).startswith('ESO-') else v
        return [
            ('target', [pm('TARGET'), 'OBJECT', 'TARGET', 'TARGNAME'], None),
            ('observer', [pm('OBSERVER'), 'TELESCOP'], eso_to_earth),
            ('utc', [pm('UTC-OBS'), 'MJD-AVG', 'EXPMID', 'DATE-AVG'], None),
            ('observer_frame', [pm('OBSERVER-FRAME')], None),
            ('illumination_source', [pm('ILLUMINATION')], None),
            ('aberration_correction', [pm('ABCORR')], None),
            ('subpoint_method', [pm('SUBPOINT-METHOD')], None),
            ('surface_method', [pm('SURFACE-METHOD')], None),
        ]

    @classmethod
    def _add_kw_from_header(cls, kw: dict, header: fits.Header) -> None:
        for key, candidates, transform in cls._header_kw_specs():
            _try_get_header_value(kw, header, key, candidates, transform)
            if key == 'utc' and 'utc' not in kw:
                cls._utc_from_header_fallbacks(kw, header)

    @staticmethod
    def _utc_from_header_fallbacks(kw: dict, header: fits.Header) -> None:
        # exposure midpoint from MJD-BEG/MJD-END, then DATE-OBS+TIME-OBS,
        # then single begin/end timestamps
        try:
            kw['utc'] = (
                float(header['MJD-BEG']) + float(header['MJD-END'])
            ) / 2
            return
        except (KeyError, TypeError, ValueError):
            pass
        try:
            kw['utc'] = f"{header['DATE-OBS']} {header['TIME-OBS']}"
            return
        except KeyError:
            pass
        _try_get_header_value(
            kw, header, 'utc',
            ['DATE-OBS', 'DATE-BEG', 'DATE-END', 'MJD-BEG', 'MJD-END'],
        )

    # API overrides
    def set_img_size(self, nx: int | None = None, ny: int | None = None):
        """:meta private:"""
        raise TypeError('Cannot set image size for Observation objects')

    # Utils
    def get_wavelengths_from_header(
        self, *, check_ctype: bool = True
    ) -> np.ndarray:
        """Wavelength array for a spectral cube from FITS header keywords."""
        return utils.generate_wavelengths_from_header(
            self.header, check_ctype=check_ctype
        )

    # ------------------------------------------------------------------
    # Disc initialisation
    # ------------------------------------------------------------------
    def reset_disc_params(self) -> str:
        """Reset disc parameters: header values, then WCS, then centred."""
        initialisers = (
            (self.disc_from_header, ValueError),
            (
                lambda: self.disc_from_wcs(suppress_warnings=True),
                (ValueError, NotImplementedError),
            ),
        )
        for initialise, failures in initialisers:
            try:
                initialise()
                return self.get_disc_method()
            except failures:  # type: ignore[misc]
                continue
        return super(Observation, self).reset_disc_params()

    def disc_from_header(self) -> None:
        """Set disc parameters from PLANMAP DISC header values."""
        pm = self._make_fits_kw
        if (
            pm('MAP PROJECTION') in self.header
            or pm('DEGREE-INTERVAL') in self.header
        ):
            raise ValueError('FITS header refers to mapped data')
        try:
            disc = [
                self.header[pm(f'DISC {field}')]
                for field in ('X0', 'Y0', 'R0', 'ROT')
            ]
        except KeyError as exc:
            raise ValueError(
                'No disc parameters found in FITS header'
            ) from exc
        self.set_disc_params(*disc)
        self.set_disc_method('header')

    def _get_wcs_from_header(self, suppress_warnings: bool = False) -> WCS:
        del suppress_warnings
        return WCS(self.header).celestial

    @_cache_stable_result
    def _get_disc_params_from_wcs(
        self,
        suppress_warnings: bool = False,
        validate: bool = True,
        use_header_offsets: bool = True,
        distortion_warning_threshold: float | None = 0.25,
    ) -> tuple[float, float, float, float]:
        wcs = self._get_wcs_from_header(suppress_warnings=suppress_warnings)
        if wcs.naxis == 0:
            raise ValueError('No WCS information found in FITS header')
        if validate:
            self._validate_wcs(wcs, distortion_warning_threshold)

        # disc centre: where the WCS puts the target's RA/Dec
        cx, cy = wcs.world_to_pixel_values(self.target_ra, self.target_dec)
        # rotation + plate scale from a one-pixel step along +y
        step_world = wcs.pixel_to_world_values(cx, cy + 1)
        here_world = wcs.pixel_to_world_values(cx, cy)
        rotation = np.rad2deg(np.arctan2(
            step_world[0] - here_world[0], step_world[1] - here_world[1]
        ))
        arcsec_per_px = 3600 * self.angular_dist(*step_world, *here_world)
        radius = self.target_diameter_arcsec / (2 * arcsec_per_px)

        disc = (cx, cy, radius, rotation)
        if use_header_offsets:
            disc = self._shift_disc_by_header_offsets(disc)
        return tuple(float(v) for v in disc)

    def _shift_disc_by_header_offsets(self, disc):
        """Apply stored HIERARCH NAV RA/DEC_OFFSET arcsec adjustments."""
        dra = float(self.header.get('HIERARCH NAV RA_OFFSET', 0.0))
        ddec = float(self.header.get('HIERARCH NAV DEC_OFFSET', 0.0))
        if dra == 0 and ddec == 0:
            return disc
        scratch = self.to_body_xy()
        scratch.set_disc_params(*disc)
        scratch.add_arcsec_offset(dra_arcsec=dra, ddec_arcsec=ddec)
        return scratch.get_disc_params()

    def _validate_wcs(self, wcs: WCS, distortion_warning_threshold) -> None:
        if not all(u == 'deg' for u in wcs.world_axis_units):
            raise ValueError('WCS coordinates are not in degrees')
        if wcs.world_axis_physical_types != ['pos.eq.ra', 'pos.eq.dec']:
            raise ValueError('WCS axes are not RA/Dec coordinates')
        if distortion_warning_threshold is None:
            return
        worst, typical = self._get_max_and_average_wcs_distortion(wcs)
        if worst > distortion_warning_threshold:
            warn(
                f'The WCS contains distortion of up to '
                f'{worst:.3f} pixels (average '
                f'{typical:.3f} pixels), which is not '
                'accounted for by PlanetMapper.',
            )

    def _get_max_and_average_wcs_distortion(self, wcs: WCS):
        if not wcs.has_distortion:
            return 0.0, 0.0
        ny, nx = self.data.shape[1:]
        grid_x, grid_y = np.meshgrid(np.arange(nx), np.arange(ny))
        focal = wcs.pix2foc(grid_x, grid_y, 0)
        shift = np.hypot(focal[0] - grid_x, focal[1] - grid_y)
        return float(shift.max()), float(shift.mean())

    def _apply_wcs_fields(
        self, method: str, fields: str, *args, **kwargs
    ) -> None:
        """Copy the requested subset of WCS-derived disc parameters."""
        params = dict(zip(
            'xyrR', self._get_disc_params_from_wcs(*args, **kwargs)
        ))
        setters = {
            'x': self.set_x0, 'y': self.set_y0,
            'r': self.set_r0, 'R': self.set_rotation,
        }
        for field in fields:
            setters[field](params[field])
        self.set_disc_method(method)

    def disc_from_wcs(
        self,
        suppress_warnings: bool = False,
        validate: bool = True,
        use_header_offsets: bool = True,
        distortion_warning_threshold: float | None = 0.25,
    ) -> None:
        """Set all disc parameters from WCS information in the header."""
        self._apply_wcs_fields(
            'wcs', 'xyrR',
            suppress_warnings=suppress_warnings, validate=validate,
            use_header_offsets=use_header_offsets,
            distortion_warning_threshold=distortion_warning_threshold,
        )

    def position_from_wcs(self, *args, **kwargs) -> None:
        """Set (x0, y0) from WCS information in the header."""
        self._apply_wcs_fields('wcs_position', 'xy', *args, **kwargs)

    def rotation_from_wcs(self, *args, **kwargs) -> None:
        """Set the disc rotation from WCS information in the header."""
        self._apply_wcs_fields('wcs_rotation', 'R', *args, **kwargs)

    def plate_scale_from_wcs(self, *args, **kwargs) -> None:
        """Set the plate scale (r0) from WCS information in the header."""
        self._apply_wcs_fields('wcs_plate_scale', 'r', *args, **kwargs)

    def get_wcs_offset(self, *args, **kwargs):
        """(dx, dy, dr, drotation) between current and WCS disc params."""
        wx, wy, wr, wrot = self._get_disc_params_from_wcs(*args, **kwargs)
        return (
            self.get_x0() - wx,
            self.get_y0() - wy,
            self.get_r0() - wr,
            (self.get_rotation() - wrot) % 360,
        )

    def get_wcs_arcsec_offset(
        self, *args, check_is_position_offset_only: bool = True, **kwargs
    ) -> tuple[float, float]:
        """(dra, ddec) arcsec offsets between current and WCS disc position."""
        dra_arcsec, ddec_arcsec, dr, drotation = (
            self._get_wcs_offsets_for_arcsec(*args, **kwargs)
        )
        if check_is_position_offset_only:
            if abs(dr) > 1e-3:
                raise ValueError(
                    f'r0 is different between WCS and observation (dr={dr})'
                )
            if abs((drotation + 180) % 360 - 180) > 1e-3:
                raise ValueError(
                    f'rotation is different between WCS and observation '
                    f'(drotation={drotation})'
                )
        return dra_arcsec, ddec_arcsec

    def _get_wcs_offsets_for_arcsec(self, *args, **kwargs):
        dx, dy, dr, drotation = self.get_wcs_offset(*args, **kwargs)
        origin = self.xy2radec(0, 0)
        shifted = self.xy2radec(dx, dy)
        to_arcsec = lambda a, b: (a - b) * 3600
        return (
            to_arcsec(shifted[0], origin[0]),
            to_arcsec(shifted[1], origin[1]),
            dr,
            drotation,
        )

    # ------------------------------------------------------------------
    # Disc fitting
    # ------------------------------------------------------------------
    def _get_img_for_fitting(self) -> torch.Tensor:
        """
        The frames' NaN-ignoring sum on this body's device, as float64.
        Floating-point data is summed frame by frame in its own type, the
        order and rounding of ``np.nansum(data, axis=0)``; integer data is
        summed in float64, exact where numpy's integer sum is. A pixel that
        is NaN in every frame sums to 0, as with ``np.nansum``, and a NaN
        left (from inf - inf) becomes the image's minimum. The data is
        uploaded once.
        """
        data = host_slots.upload(self.data, self.device)
        if not data.is_floating_point():
            data = data.to(torch.float64)
        frames = torch.where(torch.isnan(data), 0.0, data)
        img = frames[0]
        for frame in frames[1:]:
            img = img + frame
        img = img.to(torch.float64)
        nan = torch.isnan(img)
        return torch.where(nan, torch.where(nan, math.inf, img).amin(), img)

    def fit_disc_position(self) -> None:
        """Fit (x0, y0) to the brightest part of the data.

        A reduction on this body's device: percentile threshold + first
        moment of the binary mask (:func:`ops.photometry.
        threshold_centroid`); same estimator as the reference
        (observation.py:762-780).
        """
        from .ops.photometry import threshold_centroid

        x0, y0 = threshold_centroid(self._get_img_for_fitting())
        self.set_x0(x0)
        self.set_y0(y0)
        self.set_disc_method('fit_position')

    def fit_disc_radius(self) -> None:
        """
        Fit r0 by annular aperture photometry: the radius where the mean
        aperture brightness decreases the fastest (every radius in one
        batched exact-overlap reduction on this body's device,
        :func:`ops.photometry.circular_aperture_sums`).
        """
        if not self._xy_in_image_frame(self.get_x0(), self.get_y0()):
            raise ValueError(
                'x0 and y0 must be within the image frame to fit the radius'
            )
        from .ops.photometry import circular_aperture_sums

        img = self._get_img_for_fitting()
        centroid = np.array([self.get_x0(), self.get_y0()])

        r_ceil = max(
            int(min(*centroid, *(np.array(img.shape) - centroid))), 2
        )
        if r_ceil > 100:
            r_list = np.linspace(1, r_ceil + 1, 100)
        else:
            r_list = np.array(range(1, r_ceil + 1), dtype=float)

        sums, areas = circular_aperture_sums(
            img, float(centroid[0]), float(centroid[1]), r_list
        )
        val_list = sums / areas

        r_mid = r_list[1:] - 0.5 * (r_list[1] - r_list[0])
        dv_list = np.diff(val_list)
        r0 = r_mid[dv_list.argmin()]
        self.set_r0(r0)
        self.set_disc_method('fit_r0')

    # ------------------------------------------------------------------
    # Mapping
    # ------------------------------------------------------------------
    def get_mapped_data(
        self,
        interpolation: (
            Literal['nearest', 'smooth', 'linear', 'quadratic', 'cubic']
            | int
            | tuple[int, int]
        ) = 'linear',
        *,
        propagate_nan: bool = True,
        spline_smoothing: float = 0,
        smooth_oversample_by: int = 5,
        smooth_max_oversampled_img_size: int = 10_000,
        **map_kwargs,
    ) -> np.ndarray:
        """Project the observed data cube onto a map (cached)."""
        return self._get_mapped_data(
            interpolation=interpolation,
            spline_smoothing=spline_smoothing,
            propagate_nan=propagate_nan,
            smooth_oversample_by=smooth_oversample_by,
            smooth_max_oversampled_img_size=smooth_max_oversampled_img_size,
            **map_kwargs,
        ).copy()

    @_cache_clearable_alt_dependent_result
    @progress_decorator
    def _get_mapped_data(self, **kwargs) -> np.ndarray:
        # One map_img call maps every frame of the cube on this body's
        # device (one upload of the data, one launch of each map kernel),
        # then one float64 copy to the host: the FITS products and the
        # reference API contract are double precision.
        self._update_progress_hook(0.0)
        projected = self.map_img(self.data, as_numpy=False, **kwargs)
        if isinstance(projected, np.ndarray):  # a CPU body's host route
            return projected.astype(np.float64, copy=False)
        return projected.to(torch.float64).cpu().numpy()

    # ------------------------------------------------------------------
    # Output
    # ------------------------------------------------------------------
    def append_to_header(
        self,
        keyword: str,
        value,
        comment: str | None = None,
        hierarch_keyword: bool = True,
        header: fits.Header | None = None,
        truncate_strings: bool = True,
        remove_existing: bool = True,
    ) -> None:
        """Add a (PLANMAP-prefixed by default) card to a FITS header."""
        target = self.header if header is None else header
        key = self._make_fits_kw(keyword) if hierarch_keyword else keyword
        if truncate_strings and isinstance(value, str):
            budget = 80 - len(key) - 4  # card layout: key + "= '" + "'"
            if len(value) > budget:
                value = value[:budget - 3] + '...'
        if remove_existing:
            target.remove(key, ignore_missing=True, remove_all=True)
        target.append(fits.Card(keyword=key, value=value, comment=comment))

    @classmethod
    def _make_fits_kw(cls, keyword: str) -> str:
        return f'HIERARCH {cls.FITS_KEYWORD} {keyword}'

    def _metadata_cards(self):
        """
        The PLANMAP metadata card table: (keyword, value, comment) rows,
        in the order they appear in output files. Card keywords/comments
        are byte-identical to the reference's so the two packages'
        outputs are interchangeable (FITS regression tests compare them
        card by card).
        """
        rows = [
            ('VERSION', common.__version__, 'PlanetMapper version.'),
            ('URL', common.__url__, 'Webpage.'),
            ('DATE',
             datetime.datetime.now().strftime('%Y-%m-%dT%H:%M:%S'),
             'File generation datetime.'),
        ]
        if self.path is not None:
            rows.append(
                ('INFILE', os.path.split(self.path)[1], 'Input file name.')
            )
        rows += [
            ('DISC X0', self.get_x0(),
             '[pixels] x coordinate of disc centre.'),
            ('DISC Y0', self.get_y0(),
             '[pixels] y coordinate of disc centre.'),
            ('DISC R0', self.get_r0(),
             '[pixels] equatorial radius of disc.'),
            ('DISC ROT', self.get_rotation(), '[degrees] rotation of image.'),
            ('DISC METHOD', self.get_disc_method(),
             'Method used to find disc.'),
            ('ALTITUDE-ADJUSTMENT', self._alt_adjustment,
             '[km] Adjustment to surface altitude.'),
            ('UTC-OBS', self.utc, 'UTC date of observation'),
            ('ET-OBS', self.et, 'J2000 ephemeris seconds of observation.'),
            ('TARGET', self.target, 'Target body name used in SPICE.'),
            ('TARGET-ID', self.target_body_id, 'Target body ID from SPICE.'),
            ('SUBPOINT LAT', self.subpoint_lat,
             '[degrees] Sub-observer pgr latitude.'),
            ('SUBPOINT LON', self.subpoint_lon,
             '[degrees] Sub-observer pgr longitude.'),
            ('SUBSOL LAT', self.subsol_lat,
             '[degrees] Sub-solar pgr latitude.'),
            ('SUBSOL LON', self.subsol_lon,
             '[degrees] Sub-solar pgr longitude.'),
            ('LON-DIRECTION', self.positive_longitude_direction,
             'Positive pgr longitude direction.'),
            ('NP-ANGLE', self.north_pole_angle(),
             '[degrees] North pole angle.'),
            ('TARGET RA', self.target_ra, '[degrees] RA of target centre.'),
            ('TARGET DEC', self.target_dec,
             '[degrees] Dec of target centre.'),
            ('TARGET DIAMETER', self.target_diameter_arcsec,
             '[arcsec] Equatorial angular diameter of target.'),
            ('R EQ', self.r_eq, '[km] Target equatorial radius from SPICE.'),
            ('R POLAR', self.r_polar,
             '[km] Target polar radius from SPICE.'),
            ('FLATTENING', self.flattening, 'Flattening of target body.'),
            ('LIGHT-TIME', self.target_light_time,
             '[seconds] Light time to target from SPICE.'),
            ('DISTANCE', self.target_distance,
             '[km] Distance to target from SPICE.'),
            ('OBSERVER', self.observer, 'Observer name used in SPICE.'),
            ('TARGET-FRAME', self.target_frame,
             'Target frame used in SPICE.'),
            ('OBSERVER-FRAME', self.observer_frame,
             'Observer frame used in SPICE.'),
            ('ILLUMINATION', self.illumination_source,
             'Illumination source used in SPICE.'),
            ('ABCORR', self.aberration_correction,
             'Aberration correction used in SPICE.'),
            ('SUBPOINT-METHOD', self.subpoint_method,
             'Subpoint method used in SPICE.'),
            ('SURFACE-METHOD', self.surface_method,
             'Surface intercept method used in SPICE.'),
            ('OPTIMIZATION-USED', self._optimize_speed,
             'Speed optimizations used.'),
        ]
        return rows

    def add_header_metadata(self, header: fits.Header | None = None) -> None:
        """Add the automatically-generated PLANMAP metadata cards."""
        for keyword, value, comment in self._metadata_cards():
            self.append_to_header(keyword, value, comment, header=header)

    def make_filename(
        self, extension: str = '.fits', prefix: str = '', suffix: str = ''
    ) -> str:
        """Filename from the target and date, e.g. JUPITER_2005-01-01T000000.fits."""
        stamp = self.dtm.strftime('%Y-%m-%dT%H%M%S')
        return f'{prefix}{self.target}_{stamp}{suffix}{extension}'

    @progress_decorator
    def save_observation(
        self,
        path: str | os.PathLike,
        *,
        backplanes_to_save: Collection[str] | None = None,
        backplanes_to_skip: Collection[str] = frozenset(),
        include_wireframe: bool = True,
        wireframe_kwargs: dict[str, Any] | None = None,
        show_progress: bool = False,
        print_info: bool = True,
        alt: float = 0.0,
    ) -> None:
        """
        Save a FITS file containing the observed data, all generated
        backplanes (one ImageHDU each) and, with ``include_wireframe``, the
        WIREFRAME overlay image (:func:`get_wireframe_overlay_img`).
        """
        with _AdjustedSurfaceAltitude(self, alt):
            self._run_fits_export(
                path,
                banner='observation',
                hook=SaveNavProgressHookCLI,
                base_steps=10,
                want=self._get_backplane_names_to_save(
                    backplanes_to_save, backplanes_to_skip
                ),
                include_backplanes=True,
                primary=self._navigated_primary_hdu_parts,
                plane=lambda backplane: backplane.get_img(),
                decorate_hdu=None,
                wireframe=(
                    (
                        lambda: self.get_wireframe_overlay_img(
                            **wireframe_kwargs or {}
                        ),
                        'Wireframe image overlay',
                    )
                    if include_wireframe
                    else None
                ),
                show_progress=show_progress,
                print_info=print_info,
            )

    def _navigated_primary_hdu_parts(self, total_steps: int):
        header = self.header.copy()
        self._update_progress_hook(1 / total_steps)
        self.add_header_metadata(header)
        return self.data, header

    def _get_backplane_names_to_save(
        self,
        backplanes_to_save: Collection[str] | None,
        backplanes_to_skip: Collection[str],
    ) -> set[str]:
        std = self.standardise_backplane_name
        wanted = (
            self.backplanes.keys() if backplanes_to_save is None
            else backplanes_to_save
        )
        return {std(n) for n in wanted} - {std(n) for n in backplanes_to_skip}

    @progress_decorator
    @_adjust_surface_altitude_decorator
    def save_mapped_observation(
        self,
        path: str | os.PathLike,
        *,
        interpolation: (
            Literal['nearest', 'smooth', 'linear', 'quadratic', 'cubic']
            | int
            | tuple[int, int]
        ) = 'linear',
        propagate_nan: bool = True,
        spline_smoothing: float = 0,
        smooth_oversample_by: int = 5,
        smooth_max_oversampled_img_size: int = 10_000,
        include_backplanes: bool = True,
        backplanes_to_save: Collection[str] | None = None,
        backplanes_to_skip: Collection[str] = frozenset(),
        include_wireframe: bool = True,
        wireframe_kwargs: dict[str, Any] | None = None,
        show_progress: bool = False,
        print_info: bool = True,
        **map_kwargs,
    ) -> None:
        """
        Save a FITS file containing the mapped observation (and mapped
        backplanes) in the requested projection, with the WIREFRAME map
        overlay (:func:`get_wireframe_overlay_map`) if ``include_wireframe``.
        """
        interp_settings = dict(
            interpolation=interpolation,
            spline_smoothing=spline_smoothing,
            propagate_nan=propagate_nan,
            smooth_oversample_by=smooth_oversample_by,
            smooth_max_oversampled_img_size=smooth_max_oversampled_img_size,
        )
        self._run_fits_export(
            path,
            banner='map',
            hook=lambda: SaveMapProgressHookCLI(len(self.data)),
            base_steps=15,
            want=self._get_backplane_names_to_save(
                backplanes_to_save, backplanes_to_skip
            ),
            include_backplanes=include_backplanes,
            primary=lambda total: self._mapped_primary_hdu_parts(
                total, interp_settings, map_kwargs
            ),
            plane=lambda backplane: backplane.get_map(**map_kwargs),
            decorate_hdu=lambda h: self._add_map_wcs_to_header(
                h, **map_kwargs
            ),
            wireframe=(
                (
                    lambda: self.get_wireframe_overlay_map(
                        **wireframe_kwargs or {}, **map_kwargs
                    ),
                    'Wireframe map overlay',
                )
                if include_wireframe
                else None
            ),
            show_progress=show_progress,
            print_info=print_info,
            pre_primary_message=' Projecting mapped data...',
        )

    def _mapped_primary_hdu_parts(
        self, total_steps: int, interp_settings: dict, map_kwargs: dict
    ):
        data = self.get_mapped_data(**interp_settings, **map_kwargs)
        header = self.header.copy()
        self._update_progress_hook(1 / total_steps)
        self.add_header_metadata(header)
        self._add_map_header_metadata(header, **interp_settings, **map_kwargs)
        self._add_map_wcs_to_header(header, **map_kwargs)
        return data, header

    @staticmethod
    def _about_header(about: str, overlay_kind: str | None = None):
        h = fits.Header([('ABOUT', about)])
        what = 'Wireframe overlay' if overlay_kind else 'Backplane'
        h.add_comment(f'{what} generated by PlanetMapper software.')
        return h

    def _run_fits_export(
        self,
        path: str | os.PathLike,
        *,
        banner: str,
        hook,
        base_steps: int,
        want: set[str],
        include_backplanes: bool,
        primary: Callable,
        plane: Callable,
        decorate_hdu: Callable | None,
        wireframe: tuple[Callable, str] | None,
        show_progress: bool,
        print_info: bool,
        pre_primary_message: str | None = None,
    ) -> None:
        """
        The export engine shared by :meth:`save_observation` and
        :meth:`save_mapped_observation`: progress-hook lifecycle, the
        primary HDU, one ImageHDU per requested backplane, the optional
        WIREFRAME overlay HDU, and the final write. Callers supply the
        flavour-specific pieces as callables (``hook`` makes the progress
        hook, which opens its bar, only when ``show_progress`` asks for it).
        HDU names, card keywords and comment strings are byte-compatible
        with the JAX package's output files.
        """
        path = os.fspath(path)
        if wireframe is not None:
            # the overlay renders with matplotlib: without it, fail before
            # any work rather than after the backplanes
            import matplotlib.figure  # noqa: F401
        if show_progress and self._get_progress_hook() is None:
            print_info = False
            self._set_progress_hook(hook())
        else:
            show_progress = False

        def say(*parts):
            if print_info:
                print(*parts)

        say(f'Saving {banner} to', path)
        total = base_steps + (
            len(self.backplanes) if include_backplanes else 0
        )
        if pre_primary_message:
            say(pre_primary_message)
        with tracing.span('pm.export.primary'):
            data, header = primary(total)
            hdus = [fits.PrimaryHDU(data=data, header=header)]
        if include_backplanes:
            for i, (name, backplane) in enumerate(self.backplanes.items()):
                self._update_progress_hook((i + 1) / total)
                if name not in want:
                    continue
                say(' Creating backplane:', name)
                h = self._about_header(backplane.description)
                if decorate_hdu is not None:
                    decorate_hdu(h)
                with tracing.span('pm.export.plane'):
                    img = np.asarray(plane(backplane))
                tracing.count('export.planes')
                hdus.append(fits.ImageHDU(data=img, header=h, name=name))
        if wireframe is not None:
            say(' Creating wireframe...')
            wf_fn, wf_about = wireframe
            hdus.append(
                fits.ImageHDU(
                    data=wf_fn(),
                    header=self._about_header(wf_about, overlay_kind='wf'),
                    name='WIREFRAME',
                )
            )
        say(' Saving file...')
        utils.check_path(path)
        fits.HDUList(hdus).writeto(path, overwrite=True)
        say('File saved')
        if show_progress:
            self._update_progress_hook(1)
            self._remove_progress_hook()

    def _add_map_header_metadata(
        self, header: fits.Header, *, interpolation, spline_smoothing,
        propagate_nan, smooth_oversample_by, smooth_max_oversampled_img_size,
        **map_kwargs,
    ) -> None:
        info = self.generate_map_coordinates(**map_kwargs)[5]
        mode = (
            str(interpolation) if isinstance(interpolation, tuple)
            else interpolation
        )
        cards = [('MAP INTERPOLATION', mode,
                  'Interpolation method used in mapping.')]
        if interpolation not in {'nearest', 'smooth'}:
            cards += [
                ('MAP SPLINE-SMOOTHING', spline_smoothing,
                 'Interpolation spline smoothing factor used in mapping.'),
                ('MAP PROPAGATE-NAN', propagate_nan,
                 'Propagate NaN pixels to map when mapping.'),
            ]
        elif interpolation == 'smooth':
            cards += [
                ('MAP SMOOTH-OVERSAMPLE-BY', smooth_oversample_by,
                 'Oversampling factor used in map interpolation.'),
                ('MAP SMOOTH-MAX-OVERSAMPLED-IMG-SIZE',
                 smooth_max_oversampled_img_size,
                 'Maximum oversampled image size allowed map interpolation.'),
            ]
        cards.append(('MAP PROJECTION', info['projection'],
                      'Projection used for mapping.'))
        optional = [
            ('degree_interval', 'MAP DEGREE-INTERVAL',
             '[deg] Degree interval in output map.'),
            ('lon', 'MAP LON', 'Central longitude of map projection.'),
            ('lat', 'MAP LAT', 'Central latitude of map projection.'),
            ('size', 'MAP SIZE', 'Size of output map.'),
        ]
        cards += [
            (kw, info[key], comment)
            for key, kw, comment in optional if key in info
        ]
        for kw, value, comment in cards:
            self.append_to_header(kw, value, comment, header=header)

    #: Standard WCS cards per axis, scrubbed before (re)writing map WCS.
    _WCS_AXIS_CARDS = ('CTYPE{n}', 'CUNIT{n}', 'CRPIX{n}', 'CRVAL{n}',
                       'CDELT{n}')

    def _add_map_wcs_to_header(self, header: fits.Header, **map_kwargs) -> None:
        lons, lats, _xx, _yy, _tr, info = self.generate_map_coordinates(
            **map_kwargs
        )
        if info['projection'] == 'rectangular':
            axes = {
                '1': ('Planetographic longitude, positive '
                      + self.positive_longitude_direction,
                      lons[0][0], lons[0][1] - lons[0][0]),
                '2': ('Planetographic latitude',
                      lats[0][0], lats[1][0] - lats[0][0]),
            }
            for n, (ctype, crval, cdelt) in axes.items():
                header[f'CTYPE{n}'] = ctype
                header[f'CUNIT{n}'] = 'deg'
                header[f'CRPIX{n}'] = 1
                header[f'CRVAL{n}'] = crval
                header[f'CDELT{n}'] = cdelt
        else:
            for n in '12':
                for tmpl in self._WCS_AXIS_CARDS:
                    header.remove(
                        tmpl.format(n=n), ignore_missing=True,
                        remove_all=True,
                    )
        # rotation/scale matrices never apply to the map grid
        doomed = {
            f'{kind}{i}_{j}'
            for kind in ('PC', 'CD')
            for i in '12'
            for j in '123'
        } | {
            f'{kind}{j}_{i}'
            for kind in ('PC', 'CD')
            for i in '12'
            for j in '123'
        }
        for key in sorted(doomed):
            header.remove(key, ignore_missing=True, remove_all=True)

    def run_gui(self) -> list[tuple[float, float]]:
        """Run the interactive GUI to fit this observation in place."""
        from .gui import GUI

        gui = GUI(allow_open=False)
        gui.set_observation(self)
        gui.run()
        return gui.click_locations


def _try_get_header_value(
    kw: dict, header, kw_key: str, header_keys: list[str],
    value_fn: Callable[[Any], Any] | None = None,
) -> bool:
    """First matching header keyword wins; no-op if kw_key already set."""
    if kw_key in kw:
        return False
    for candidate in header_keys:
        try:
            raw = header[candidate]
        except KeyError:
            continue
        kw[kw_key] = raw if value_fn is None else value_fn(raw)
        return True
    return False
