"""
General helper utilities (port of ``planetmapper_tpu.utils``): RA/Dec axis
formatting with degree-minute-second ticks, DMS conversions,
warning-filter context managers, normalisation, path creation, and
wavelength-array generation from FITS headers.

The sexagesimal tick machinery is built around a single
:class:`_SexagesimalScale` engine (a data-driven field table shared by the
locator and the formatter).

matplotlib is imported only when a plotting helper is used:
:func:`format_radec_axes` imports it when called, and the two matplotlib
subclasses :class:`DMSFormatter` and :class:`DMSLocator` are built on
first access (the module's ``__getattr__``), so that this module imports
where matplotlib is not installed.
"""

from __future__ import annotations

import math
import os
import pathlib
import warnings
from typing import TYPE_CHECKING, Literal, Sequence

import numpy as np

if TYPE_CHECKING:
    from matplotlib.axes import Axes


def format_radec_axes(
    ax: Axes,
    dec: float,
    dms_ticks: bool = True,
    add_axis_labels: bool = True,
    aspect_adjustable: Literal['box', 'datalim'] | None = 'datalim',
) -> None:
    """
    Format an axis for RA/Dec display: labels, aspect ratio corrected by
    cos(dec), inverted RA axis, and optional DMS tick formatting.
    """
    if add_axis_labels:
        ax.set_xlabel('Right Ascension')
        ax.set_ylabel('Declination')
    if aspect_adjustable is not None:
        ax.set_aspect(
            1 / np.cos(np.deg2rad(dec)), adjustable=aspect_adjustable
        )
    if not ax.xaxis_inverted():
        ax.invert_xaxis()
    if dms_ticks:
        formatter, locator = _dms_tick_classes()
        for axis in (ax.xaxis, ax.yaxis):
            axis.set_major_locator(locator())
            axis.set_major_formatter(formatter())


# ---------------------------------------------------------------------------
# Sexagesimal angle machinery
# ---------------------------------------------------------------------------

#: The three sexagesimal fields: (name, size in degrees, unit glyph).
_FIELDS: tuple[tuple[str, float, str], ...] = (
    ('d', 1.0, '\N{DEGREE SIGN}'),
    ('m', 1.0 / 60.0, '\N{PRIME}'),
    ('s', 1.0 / 3600.0, '\N{DOUBLE PRIME}'),
)


def _split_fields(decimal_degrees: float) -> list[float]:
    """
    Split an angle into sexagesimal field values ``[d, m, s]`` (all
    non-negative; the caller handles sign placement). The seconds field
    keeps the fractional part.
    """
    remainder = abs(decimal_degrees)
    values: list[float] = []
    for _name, size, _glyph in _FIELDS[:-1]:
        whole = math.floor(remainder / size)
        values.append(whole)
        remainder -= whole * size
    values.append(remainder / _FIELDS[-1][1])
    return values


def decimal_degrees_to_dms(decimal_degrees: float) -> tuple[int, int, float]:
    """
    Convert decimal degrees to a ``(degrees, minutes, seconds)`` tuple,
    with the sign carried on the most significant nonzero part.
    """
    d, m, s = _split_fields(decimal_degrees)
    if decimal_degrees < 0:
        # Negate the leading nonzero field so e.g. -0.5 deg -> (0, -30, 0)
        if d:
            d = -d
        elif m:
            m = -m
        else:
            s = -s
    return int(d), int(m), s


def decimal_degrees_to_dms_str(
    decimal_degrees: float, seconds_fmt: str = 'g'
) -> str:
    """Formatted DMS string, e.g. ``'12°34′56″'``."""
    d, m, s = decimal_degrees_to_dms(decimal_degrees)
    seconds = format(s, seconds_fmt)
    whole_digits = len(seconds.partition('.')[0])
    return '{}{}{:02d}{}{}{}{}'.format(
        d, _FIELDS[0][2], m, _FIELDS[1][2],
        '0' * max(0, 2 - whole_digits), seconds, _FIELDS[2][2],
    )


class _SexagesimalScale:
    """
    Decides, for a given view interval, how sexagesimal ticks should be
    placed and rendered. One engine shared by :class:`DMSLocator` and
    :class:`DMSFormatter`:

    - ``unit``: the field whose integer multiples ticks snap to.
    - ``visible``: which fields are rendered per tick label (coarser
      constant fields are hoisted into the axis offset string, finer
      all-zero fields dropped).
    - ``seconds_format``: precision for the seconds field, matched to the
      tick spacing.
    """

    def __init__(self, vmin: float, vmax: float) -> None:
        vmin, vmax = sorted((vmin, vmax))
        self.vmin = vmin
        self.vmax = vmax
        self.span = vmax - vmin

        # Tick unit: the coarsest field with at least one tick interval
        # spanning the view
        self.unit_index = len(_FIELDS) - 1
        for idx, (_n, size, _g) in enumerate(_FIELDS):
            if self.span >= size:
                self.unit_index = idx
                break

        # Fields coarser than the variation are hoisted to the offset;
        # fields much finer than the span are dropped from the labels
        lo = _split_fields(vmin) if math.isfinite(vmin) else [0, 0, 0.0]
        hi = _split_fields(vmax) if math.isfinite(vmax) else [0, 0, 0.0]
        same_sign = (vmin >= 0) == (vmax >= 0)
        self.offset_fields: list[tuple[str, float, str]] = []
        visible = {'d', 'm', 's'}
        if same_sign and math.isfinite(self.span):
            for (name, size, glyph), a, b in zip(_FIELDS[:-1], lo, hi):
                if a == b and self.span <= size / 6.0:
                    visible.discard(name)
                    self.offset_fields.append((name, a, glyph))
                else:
                    break
        if self.span > 10.0:
            visible.discard('m')
        if self.span > 10.0 / 60.0:
            visible.discard('s')
        if not visible:
            visible = {'d', 'm', 's'}
        self.visible = visible

        # Seconds precision from the span (finer views need more digits)
        arcsec_span = self.span * 3600.0
        if arcsec_span < 0.01:
            self.seconds_format = '.3g'
        elif arcsec_span < 0.1:
            self.seconds_format = '.3f'
        elif arcsec_span < 1.0:
            self.seconds_format = '.2f'
        elif arcsec_span < 10.0:
            self.seconds_format = '.1f'
        else:
            self.seconds_format = '02.0f'

    @property
    def unit_size(self) -> float:
        return _FIELDS[self.unit_index][1]

    def offset_string(self) -> str:
        parts = []
        for i, (name, value, glyph) in enumerate(self.offset_fields):
            if value == 0 and not any(
                v for _n, v, _g in self.offset_fields
            ):
                continue
            fmt = '{:+.0f}' if i == 0 else '{:02.0f}'
            sign_value = value if i > 0 else math.copysign(
                value, self.vmin
            )
            parts.append(fmt.format(sign_value) + glyph)
        return ''.join(parts)

    def label(self, decimal_degrees: float) -> str:
        d, m, s = decimal_degrees_to_dms(decimal_degrees)
        shown = []
        if 'd' in self.visible or (m == 0 and s == 0):
            shown.append(f'{d}{_FIELDS[0][2]}')
        if 'm' in self.visible or ('d' not in self.visible and s == 0):
            shown.append(f'{m:02.0f}{_FIELDS[1][2]}')
        if 's' in self.visible:
            shown.append(format(s, self.seconds_format) + _FIELDS[2][2])
        return ''.join(shown)


_DMS_TICK_CLASSES: tuple | None = None


def _dms_tick_classes() -> tuple[type, type]:
    """``(DMSFormatter, DMSLocator)``, defined on the first call (they
    subclass matplotlib's ``Formatter`` and ``Locator``)."""
    global _DMS_TICK_CLASSES
    if _DMS_TICK_CLASSES is not None:
        return _DMS_TICK_CLASSES
    import matplotlib.ticker

    class DMSFormatter(matplotlib.ticker.Formatter):
        """
        Tick formatter displaying angles as degrees/minutes/seconds
        (e.g. 12°34′56″); pairs with :class:`DMSLocator`. Constant leading
        fields are moved into the axis offset string.
        """

        def __init__(self) -> None:
            super().__init__()
            self._scale: _SexagesimalScale | None = None
            self._offset_text = ''

        def _get_scale(self) -> _SexagesimalScale:
            if self._scale is None:
                vmin, vmax = self.axis.get_view_interval()
                self._scale = _SexagesimalScale(vmin, vmax)
            return self._scale

        def __call__(self, x, pos=None) -> str:
            return self._get_scale().label(x)

        def set_locs(self, locs) -> None:
            """:meta private:"""
            vmin, vmax = self.axis.get_view_interval()
            self._scale = _SexagesimalScale(vmin, vmax)
            self._offset_text = self._scale.offset_string()
            super().set_locs(locs)

        def get_offset(self) -> str:
            """:meta private:"""
            return self._offset_text

    class DMSLocator(matplotlib.ticker.Locator):
        """
        Tick locator snapping ticks to whole numbers of the sexagesimal
        field chosen by :class:`_SexagesimalScale`; pairs with
        :class:`DMSFormatter`.
        """

        def __init__(self) -> None:
            super().__init__()
            self._nice = matplotlib.ticker.MaxNLocator(
                steps=[1, 2, 5, 10], nbins=8
            )

        def __call__(self):
            vmin, vmax = self.axis.get_view_interval()
            return self.tick_values(vmin, vmax)

        def tick_values(self, vmin: float, vmax: float) -> np.ndarray:
            """:meta private:"""
            scale = _SexagesimalScale(vmin, vmax)
            unit = scale.unit_size
            ticks = self._nice.tick_values(vmin / unit, vmax / unit)
            return np.asarray(ticks) * unit

    DMSFormatter.__qualname__ = 'DMSFormatter'
    DMSLocator.__qualname__ = 'DMSLocator'
    _DMS_TICK_CLASSES = (DMSFormatter, DMSLocator)
    return _DMS_TICK_CLASSES


def __getattr__(name: str):
    if name == 'DMSFormatter':
        return _dms_tick_classes()[0]
    if name == 'DMSLocator':
        return _dms_tick_classes()[1]
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


# ---------------------------------------------------------------------------
# Warning filters
# ---------------------------------------------------------------------------

class ignore_warnings(warnings.catch_warnings):
    """Context manager to ignore warnings matching the given messages."""

    def __init__(self, *warning_strings: str, **kwargs):
        super().__init__(**kwargs)
        self.warning_strings = warning_strings

    def __enter__(self):
        out = super().__enter__()
        for ws in self.warning_strings:
            warnings.filterwarnings('ignore', ws)
        return out


class filter_fits_comment_warning(warnings.catch_warnings):
    """Hide FITS 'comment will be truncated' warnings while saving."""

    def __enter__(self):
        out = super().__enter__()
        warnings.filterwarnings(
            'ignore', message='Card is too long, comment will be truncated.'
        )
        return out


# ---------------------------------------------------------------------------
# Misc numeric / filesystem helpers
# ---------------------------------------------------------------------------

def normalise(
    values: np.ndarray | Sequence[float],
    top: float = 1.0,
    bottom: float = 0.0,
    single_value: float | None = None,
) -> np.ndarray:
    """Normalise values into the range [bottom, top]."""
    assert top > bottom
    values = np.array(values)
    if single_value is not None and len(set(values)) == 1:
        return np.full(values.shape, single_value)
    vmin = np.nanmin(values)
    vmax = np.nanmax(values)
    if vmax != vmin:
        values = (values - vmin) / (vmax - vmin)
    else:
        values = values - vmin
    return values * (top - bottom) + bottom


def check_path(path: str) -> None:
    """Create the directory tree of a file/directory path if needed."""
    path = os.path.expandvars(os.path.expanduser(path))
    if os.path.isdir(path):
        return
    head, tail = os.path.split(path)
    if '.' in tail:
        # Looks like a file path: only its parent directory is needed
        if head == '' or os.path.isdir(head):
            return
        path = head
    if path == '':
        return
    print(f'Creating directory path "{path}"')
    pathlib.Path(path).mkdir(parents=True, exist_ok=True)


class GetWavelengthsError(ValueError):
    """Raised when wavelengths cannot be derived from a FITS header."""


def generate_wavelengths_from_header(
    header, *, check_ctype: bool = True, axis: int = 3
) -> np.ndarray:
    """
    Wavelength array from NAXISn/CRVALn/CDELTn (or CDn_n)/CRPIXn header
    keywords (e.g. for JWST IFU cubes).
    """
    try:
        if check_ctype and header[f'CTYPE{axis}'] != 'WAVE':
            raise GetWavelengthsError(
                f'Header item CTYPE{axis} = '
                f'{header[f"CTYPE{axis}"]!r} (not \'WAVE\')'
            )
        n = int(header[f'NAXIS{axis}'])
        start = float(header[f'CRVAL{axis}'])
        try:
            step = float(header[f'CDELT{axis}'])
        except KeyError:
            step = float(header[f'CD{axis}_{axis}'])
        try:
            ref_pix = float(header.get(f'CRPIX{axis}', 1))
        except AttributeError:
            ref_pix = 1.0
    except (KeyError, ValueError, TypeError) as e:
        raise GetWavelengthsError(
            'Could not generate wavelength array from FITS Header'
        ) from e
    return (np.arange(n) + ref_pix - 1) * step + start
