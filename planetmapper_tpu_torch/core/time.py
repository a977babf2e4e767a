"""
Time system: UTC <-> ET (Barycentric Dynamical Time, TDB, seconds past J2000).

From-scratch replacement for the SPICE time subsystem used by the reference
(``spice.str2et`` at base.py:815, ``spice.et2utc`` at base.py:494), driven by
the leap-second kernel (LSK) loaded into the kernel pool.

The conversion chain is (see any LSK file's header for the definition):

    ET  = TAI + DELTA_T_A + K sin(E)
    E   = M + EB sin(M)
    M   = M0 + M1 * t        (t = ET seconds past J2000)
    TAI = UTC + DELTA_AT     (DELTA_AT = leap second table lookup)

The periodic term is solved by fixed-point iteration (3 rounds, identical to
machine-precision convergence since the term's amplitude is ~1.7 ms).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

from .timebase import calendar_to_j2000_seconds, j2000_seconds_to_calendar

_MONTHS = {
    'JAN': 1, 'FEB': 2, 'MAR': 3, 'APR': 4, 'MAY': 5, 'JUN': 6,
    'JUL': 7, 'AUG': 8, 'SEP': 9, 'OCT': 10, 'NOV': 11, 'DEC': 12,
}


@dataclass(frozen=True)
class LeapSecondData:
    """Constants from a DELTET leap-second kernel."""

    delta_t_a: float
    k: float
    eb: float
    m0: float
    m1: float
    # (delta_at_value, utc_raw_second_count_of_epoch) pairs, ascending
    leap_table: tuple[tuple[float, float], ...]

    @classmethod
    def from_pool(cls, pool: dict) -> 'LeapSecondData':
        try:
            delta_t_a = float(pool['DELTET/DELTA_T_A'][0])
            k = float(pool['DELTET/K'][0])
            eb = float(pool['DELTET/EB'][0])
            m0, m1 = (float(v) for v in pool['DELTET/M'][:2])
            raw = pool['DELTET/DELTA_AT']
        except KeyError as exc:
            raise KernelDataNotFoundError(
                'No leapseconds (LSK) kernel data found in the kernel pool. '
                'Load a *.tls kernel (e.g. naif0012.tls).'
            ) from exc
        pairs = tuple(
            (float(raw[i]), float(raw[i + 1])) for i in range(0, len(raw), 2)
        )
        return cls(delta_t_a, k, eb, m0, m1, pairs)

    def delta_at(self, utc_raw: float) -> float:
        """
        TAI - UTC at the given raw UTC second count past J2000. Before
        the first table epoch CSPICE uses one second less than the first
        entry (each entry records the count AFTER the leap second at its
        epoch) - matched here for ``et2utc`` parity on pre-1972 dates.
        """
        value = self.leap_table[0][0] - 1.0
        for v, epoch in self.leap_table:
            if utc_raw >= epoch:
                value = v
            else:
                break
        return value

    def _periodic(self, et: float) -> float:
        m = self.m0 + self.m1 * et
        e = m + self.eb * math.sin(m)
        return self.k * math.sin(e)

    def tai_to_et(self, tai: float) -> float:
        et = tai + self.delta_t_a
        for _ in range(3):
            et = tai + self.delta_t_a + self._periodic(et)
        return et

    def et_to_tai(self, et: float) -> float:
        return et - self.delta_t_a - self._periodic(et)

    def utc_raw_to_et(self, utc_raw: float) -> float:
        return self.tai_to_et(utc_raw + self.delta_at(utc_raw))

    def et_to_utc_raw(self, et: float) -> float:
        tai = self.et_to_tai(et)
        # delta_at depends on UTC; iterate the table lookup
        utc = tai - self.delta_at(tai)
        utc = tai - self.delta_at(utc)
        return utc


class KernelDataNotFoundError(Exception):
    """Raised when required data is missing from the kernel pool."""


_ISO_RE = re.compile(
    r'^\s*(\d{4})-(\d{1,2})-(\d{1,2})'
    r'(?:[T ](\d{1,2}):(\d{2})(?::(\d{2}(?:\.\d*)?))?)?'
    r'\s*(?:UTC)?\s*$'
)
_CAL_RE = re.compile(
    r'^\s*(\d{4})[ -]([A-Za-z]{3})[ -](\d{1,2})'
    r'(?:[T ](\d{1,2}):(\d{2})(?::(\d{2}(?:\.\d*)?))?)?'
    r'\s*(?:UTC)?\s*$'
)
_JD_RE = re.compile(r'^\s*JD\s*(\d+(?:\.\d*)?)\s*$', re.IGNORECASE)
_MJD_RE = re.compile(r'^\s*MJD\s*(\d+(?:\.\d*)?)\s*$', re.IGNORECASE)
_DOY_RE = re.compile(
    r'^\s*(\d{4})-(\d{1,3})'
    r'(?:[T ](\d{1,2}):(\d{2})(?::(\d{2}(?:\.\d*)?))?)?'
    r'\s*(?:UTC)?\s*$'
)


def parse_utc_string(utc: str) -> float:
    """
    Parse a UTC time string to a raw second count past J2000 (no leap
    seconds). Accepts the common formats supported by SPICE ``str2et`` that
    appear in practice: ISO dates/datetimes with ``T`` or space separators,
    ``YYYY MON DD hh:mm:ss`` calendar format, day-of-year format, and
    ``JD``/``MJD`` Julian date strings.
    """
    m = _ISO_RE.match(utc)
    if m:
        return calendar_to_j2000_seconds(
            int(m.group(1)), int(m.group(2)), int(m.group(3)),
            int(m.group(4) or 0), int(m.group(5) or 0), float(m.group(6) or 0.0),
        )
    m = _CAL_RE.match(utc)
    if m and m.group(2).upper() in _MONTHS:
        return calendar_to_j2000_seconds(
            int(m.group(1)), _MONTHS[m.group(2).upper()], int(m.group(3)),
            int(m.group(4) or 0), int(m.group(5) or 0), float(m.group(6) or 0.0),
        )
    m = _DOY_RE.match(utc)
    if m and int(m.group(2)) <= 366:
        jan1 = calendar_to_j2000_seconds(int(m.group(1)), 1, 1)
        return (
            jan1
            + (int(m.group(2)) - 1) * 86400.0
            + int(m.group(3) or 0) * 3600.0
            + int(m.group(4) or 0) * 60.0
            + float(m.group(5) or 0.0)
        )
    m = _JD_RE.match(utc)
    if m:
        return (float(m.group(1)) - 2451545.0) * 86400.0
    m = _MJD_RE.match(utc)
    if m:
        return (float(m.group(1)) + 2400000.5 - 2451545.0) * 86400.0
    raise ValueError(f'Cannot parse UTC time string {utc!r}')


def utc_string_to_et(utc: str, lsk: LeapSecondData) -> float:
    """``str2et`` equivalent (reference: base.py:815)."""
    return lsk.utc_raw_to_et(parse_utc_string(utc))


def et_to_utc_string(et: float, lsk: LeapSecondData, precision: int = 6) -> str:
    """
    ``et2utc(et, 'ISOC', precision)`` equivalent (reference: base.py:494).
    """
    utc_raw = lsk.et_to_utc_raw(et)
    # Round to requested precision first so carry propagates correctly.
    scale = 10.0**precision
    utc_raw = round(utc_raw * scale) / scale
    year, month, day, hour, minute, sec = j2000_seconds_to_calendar(utc_raw)
    # Guard against floating point producing sec == 60 after rounding
    if sec >= 60.0 - 0.5 / scale:
        sec = 0.0
        utc_raw += 0.5  # nudge into next minute then recompute
        year, month, day, hour, minute, _ = j2000_seconds_to_calendar(utc_raw)
    if precision > 0:
        sec_str = f'{sec:0{3 + precision}.{precision}f}'
    else:
        sec_str = f'{int(round(sec)):02d}'
    return f'{year:04d}-{month:02d}-{day:02d}T{hour:02d}:{minute:02d}:{sec_str}'
