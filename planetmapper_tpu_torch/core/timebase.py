"""
Calendar arithmetic shared by the time system and the text-kernel parser.

Pure-Python (and numpy-friendly) replacements for the calendar layer of the
SPICE time subsystem (``str2et``/``et2utc`` internals). No external
dependencies; proleptic Gregorian calendar matching SPICE's handling of
modern dates.
"""

from __future__ import annotations

J2000_JD = 2451545.0  # Julian date of the J2000 epoch (2000-01-01T12:00:00)
MJD_OFFSET = 2400000.5  # JD = MJD + MJD_OFFSET
SECONDS_PER_DAY = 86400.0
SPEED_OF_LIGHT_KM_S = 299792.458  # CODATA / value returned by CSPICE clight_c


def julian_day_number(year: int, month: int, day: int) -> int:
    """Julian day number at noon of the given proleptic Gregorian date."""
    a = (14 - month) // 12
    y = year + 4800 - a
    m = month + 12 * a - 3
    return day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 + y // 400 - 32045


def calendar_to_j2000_seconds(
    year: int, month: int, day: int, hour: int = 0, minute: int = 0, sec: float = 0.0
) -> float:
    """
    Seconds past the J2000 epoch of a calendar date, with *no* leap second
    handling (every day is exactly 86400 s). This is the raw count used both
    for pool ``@date`` tokens and as the UTC second count in ``utc2et``.
    """
    jdn = julian_day_number(year, month, day)
    days = jdn - J2000_JD  # offset from noon
    return days * SECONDS_PER_DAY + (hour - 12) * 3600.0 + minute * 60.0 + sec


def j2000_seconds_to_calendar(t: float) -> tuple[int, int, int, int, int, float]:
    """
    Inverse of :func:`calendar_to_j2000_seconds`:
    ``(year, month, day, hour, minute, sec)`` of a raw J2000 second count.
    """
    # Shift so that t=0 -> 2000-01-01T12:00. Work relative to midnight.
    t_mid = t + 12 * 3600.0
    days = int(t_mid // SECONDS_PER_DAY)
    secs = t_mid - days * SECONDS_PER_DAY
    # days is offset from 2000-01-01 (midnight); JDN of 2000-01-01 is 2451545
    jdn = days + 2451545
    year, month, day = jdn_to_calendar(jdn)
    hour = int(secs // 3600.0)
    minute = int((secs - hour * 3600.0) // 60.0)
    sec = secs - hour * 3600.0 - minute * 60.0
    return year, month, day, hour, minute, sec


def jdn_to_calendar(jdn: int) -> tuple[int, int, int]:
    """Proleptic Gregorian calendar date of a Julian day number (at noon)."""
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    return year, month, day
