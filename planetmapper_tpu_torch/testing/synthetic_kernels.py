"""
Synthetic SPICE kernels for tests and smoke runs, written with numpy alone.

:func:`write_synthetic_kernels` writes three files into a directory:

- ``synthetic.tls``: a leap-second kernel with the standard ``DELTET``
  constants and the ``DELTA_AT`` table through 2017-JAN-1;
- ``synthetic.tpc``: a text PCK with the IAU radii, pole and prime meridian
  of Jupiter (including the Jovian nutation-precession terms), the Earth
  and the Sun;
- ``synthetic.bsp``: a little-endian binary DAF/SPK with one type 13
  (Hermite) segment each for the Sun (10), the Earth (399) and Jupiter (599)
  relative to the solar-system barycentre, in J2000, from 2004-12-01 to
  2005-02-01 at a one-hour step.

The orbits are analytic circles about the Sun (Earth at 1 AU in the
ecliptic, Jupiter at 5.2026 AU inclined 1.303 deg); the Sun carries
Jupiter's reflex motion about the barycentre. The phases are chosen so
that on 2005-01-01 Jupiter is about 5.3 AU from the Earth at a phase
angle near 11 deg, so every illumination backplane carries real values.
``seed`` jitters both orbital phases by up to +-0.5 deg.

With ``satellites=True`` the PCK and the SPK also carry two satellites of
Jupiter on circular orbits in its equatorial plane (at the J2000 pole),
sampled every :data:`SATELLITE_STEP_S` seconds relative to Jupiter:

- Io (501), with its IAU radii, pole and prime meridian (and their
  nutation-precession terms), a = 421,700 km, period 1.769 d;
- Amalthea (505), a = 181,366 km, period 0.498 d, with no ``RADII``, so
  that ``Body.create_other_body`` falls back to a ``BasicBody``.

With ``tle=True`` the SPK also carries SPK type 10 (two-line element)
segments about the Earth (399), in the generic-segment layout of
CSPICE's ``spkw10`` (NMETA 17) with the WGS-72 constants of Spacetrack
Report #3 (:data:`TLE_CONSTANTS`):

- the Hubble Space Telescope (-48): an HST-like near-earth series at
  28.47 deg, 15.09 rev/day and e = 2.7e-4, one element set every
  :data:`TLE_STEP_S` seconds across the coverage, each advanced from the
  first by SGP4's secular rates, so that an evaluation blends two sets;
- two deep-space resonant objects for the tests (:data:`DEEP_TLE_IDS`): a
  geosynchronous set (24 h, 1:1 resonance, 0.03 deg: the Lyddane branch)
  and a Molniya set (12 h, 2:1 resonance, e = 0.7), each three element
  sets a week apart about 2005-01-01.

The Sun, Earth and Jupiter segments are the same words whatever the
flags, and the default files are byte for byte those written without them.

The constants are public IAU/NAIF values; nothing is downloaded. These
kernels are not real ephemerides: they exist so that the geometry code
runs on a known scene without network access.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..core.timebase import calendar_to_j2000_seconds

AU_KM = 1.495978707e8
GM_SUN = 1.32712440041e11  # km^3 / s^2
JUPITER_SUN_MASS_RATIO = 1.0 / 1047.3486
OBLIQUITY_DEG = 23.4392911  # J2000 mean obliquity of the ecliptic

#: Hermite window (knot count) written into the type 13 segments
HERMITE_WINDOW = 4
STEP_S = 3600.0
#: Sampling step of the satellite segments: Io moves 0.025 rad a step, so
#: the Hermite window interpolates its orbit to ~1e-12 km
SATELLITE_STEP_S = 600.0

#: The WGS-72 geophysical constants of the type 10 segments: J2, J3, J4,
#: KE [ER^1.5/min], QO, SO, ER [km], AE (Spacetrack Report #3)
TLE_CONSTANTS = (1.082616e-3, -2.53881e-6, -1.65597e-6, 0.0743669161,
                 120.0, 78.0, 6378.135, 1.0)
#: Spacing of the HST element sets
TLE_STEP_S = 2 * 86400.0
#: The HST series' first element set: (B* [1/ER], inclination, node,
#: eccentricity, argument of perigee, mean anomaly [deg], mean motion
#: [rev/day])
HST_ELEMENTS = (1.5e-5, 28.47, 120.0, 2.7e-4, 80.0, 200.0, 15.09)
#: The deep-space test objects: NAIF ID -> elements as HST_ELEMENTS
DEEP_TLE_IDS = {-9001: (0.0, 0.03, 80.0, 2.0e-4, 30.0, 200.0, 1.0027379),
                -9002: (0.0, 63.4, 120.0, 0.7, 270.0, 10.0, 2.0056)}
#: Epochs of the deep-space element sets, days from 2005-01-01
DEEP_TLE_DAYS = (-7.0, 0.0, 7.0)

#: Circular satellite orbits about Jupiter: NAIF ID -> (radius [km],
#: period [days], argument of latitude on 2005-01-01T00:00 TDB [deg])
SATELLITE_ORBITS = {501: (421_700.0, 1.769, 40.0), 505: (181_366.0, 0.498, 200.0)}

_LEAP_SECONDS = (
    (10, '1972-JAN-1'), (11, '1972-JUL-1'), (12, '1973-JAN-1'),
    (13, '1974-JAN-1'), (14, '1975-JAN-1'), (15, '1976-JAN-1'),
    (16, '1977-JAN-1'), (17, '1978-JAN-1'), (18, '1979-JAN-1'),
    (19, '1980-JAN-1'), (20, '1981-JUL-1'), (21, '1982-JUL-1'),
    (22, '1983-JUL-1'), (23, '1985-JUL-1'), (24, '1988-JAN-1'),
    (25, '1990-JAN-1'), (26, '1991-JAN-1'), (27, '1992-JUL-1'),
    (28, '1993-JUL-1'), (29, '1994-JUL-1'), (30, '1996-JAN-1'),
    (31, '1997-JUL-1'), (32, '1999-JAN-1'), (33, '2006-JAN-1'),
    (34, '2009-JAN-1'), (35, '2012-JUL-1'), (36, '2015-JUL-1'),
    (37, '2017-JAN-1'),
)

_LSK_TEXT = """KPL/LSK

Synthetic leap-second kernel: standard DELTET constants.

\\begindata

DELTET/DELTA_T_A = 32.184
DELTET/K = 1.657D-3
DELTET/EB = 1.671D-2
DELTET/M = ( 6.239996D0 1.99096871D-7 )
DELTET/DELTA_AT = ( {table} )

\\begintext
"""

_PCK_TEXT = """KPL/PCK

Synthetic planetary constants: IAU radii and rotation models.

\\begindata

BODY10_RADII = ( 696000.0 696000.0 696000.0 )
BODY10_POLE_RA = ( 286.13 0.0 0.0 )
BODY10_POLE_DEC = ( 63.87 0.0 0.0 )
BODY10_PM = ( 84.176 14.18440 0.0 )

BODY399_RADII = ( 6378.1366 6378.1366 6356.7519 )
BODY399_POLE_RA = ( 0.0 -0.641 0.0 )
BODY399_POLE_DEC = ( 90.0 -0.557 0.0 )
BODY399_PM = ( 190.147 360.9856235 0.0 )

BODY5_NUT_PREC_ANGLES = (
    73.32 91472.9 24.62 45137.2 283.90 4850.7 355.80 1191.3
    119.90 262.1 229.80 64.3 352.25 2382.6 113.35 6070.0
    146.64 182945.8 49.24 90274.4 99.360714 4850.4046
    175.895369 1191.9605 300.323162 262.5475 114.012305 6070.2476
    49.511251 64.3000 )

BODY599_RADII = ( 71492.0 71492.0 66854.0 )
BODY599_POLE_RA = ( 268.056595 -0.006499 0.0 )
BODY599_POLE_DEC = ( 64.495303 0.002413 0.0 )
BODY599_PM = ( 284.95 870.5360000 0.0 )
BODY599_NUT_PREC_RA = ( 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
    0.000117 0.000938 0.001432 0.000030 0.002150 )
BODY599_NUT_PREC_DEC = ( 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0
    0.000050 0.000404 0.000617 -0.000013 0.000926 )

\\begintext
"""

_SATELLITE_PCK_TEXT = """
Io (IAU 2009); Amalthea has no RADII here (a point source).

\\begindata

BODY501_RADII = ( 1829.4 1819.4 1815.7 )
BODY501_POLE_RA = ( 268.05 -0.009 0.0 )
BODY501_POLE_DEC = ( 64.50 0.003 0.0 )
BODY501_PM = ( 200.39 203.4889538 0.0 )
BODY501_NUT_PREC_RA = ( 0.0 0.0 0.094 0.024 )
BODY501_NUT_PREC_DEC = ( 0.0 0.0 0.040 0.011 )
BODY501_NUT_PREC_PM = ( 0.0 0.0 -0.085 -0.022 )

\\begintext
"""

# Ftp validation string of the DAF file record (NAIF DAF Required Reading)
_FTPSTR = b'FTPSTR:\r:\n:\r\n:\r\x00:\x81:\x10\xce:ENDFTP'


def coverage() -> tuple[float, float]:
    """(start, end) of the SPK segments, seconds past J2000."""
    return (
        calendar_to_j2000_seconds(2004, 12, 1),
        calendar_to_j2000_seconds(2005, 2, 1),
    )


def _rot_x(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _rot_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _circular_states(t, *, a_km, u0_deg, node_deg, incl_deg, t_ref):
    """
    Heliocentric J2000 states (n, 6) of a circular orbit with argument of
    latitude ``u0_deg`` at ``t_ref``; position and velocity are exact
    derivatives of each other.
    """
    n = math.sqrt(GM_SUN / a_km**3)
    u = math.radians(u0_deg) + n * (t - t_ref)
    plane_pos = a_km * np.stack([np.cos(u), np.sin(u), np.zeros_like(u)], -1)
    plane_vel = a_km * n * np.stack(
        [-np.sin(u), np.cos(u), np.zeros_like(u)], -1
    )
    to_ecliptic = _rot_z(math.radians(node_deg)) @ _rot_x(math.radians(incl_deg))
    to_j2000 = _rot_x(math.radians(OBLIQUITY_DEG)) @ to_ecliptic
    return np.concatenate(
        [plane_pos @ to_j2000.T, plane_vel @ to_j2000.T], axis=-1
    )


def synthetic_states(t: np.ndarray, seed: int = 0) -> dict[int, np.ndarray]:
    """
    Barycentric J2000 states ``{naif_id: (n, 6)}`` of the Sun, the Earth
    and Jupiter at times ``t`` (seconds past J2000): the analytic model the
    SPK file samples.
    """
    t = np.asarray(t, dtype=np.float64)
    jitter = np.random.default_rng(seed).uniform(-0.5, 0.5, size=2)
    t_ref = calendar_to_j2000_seconds(2005, 1, 1)
    earth = _circular_states(
        t, a_km=AU_KM, u0_deg=100.5 + jitter[0], node_deg=0.0,
        incl_deg=0.0, t_ref=t_ref,
    )
    # Jupiter: ecliptic longitude ~190 deg on 2005-01-01
    node = 100.464
    jupiter = _circular_states(
        t, a_km=5.2026 * AU_KM, u0_deg=190.0 - node + jitter[1],
        node_deg=node, incl_deg=1.303, t_ref=t_ref,
    )
    mu = JUPITER_SUN_MASS_RATIO
    sun = -mu / (1.0 + mu) * jupiter
    return {10: sun, 399: sun + earth, 599: sun + jupiter}


def satellite_states(t: np.ndarray) -> dict[int, np.ndarray]:
    """
    J2000 states ``{naif_id: (n, 6)}`` of the synthetic satellites relative
    to Jupiter at times ``t`` (seconds past J2000): circles in the plane
    normal to Jupiter's J2000 pole (``BODY599_POLE_RA``/``_DEC`` at T = 0).
    """
    t = np.asarray(t, dtype=np.float64)
    ra, dec = math.radians(268.056595), math.radians(64.495303)
    pole = np.array([math.cos(dec) * math.cos(ra),
                     math.cos(dec) * math.sin(ra), math.sin(dec)])
    node = np.cross([0.0, 0.0, 1.0], pole)
    node /= np.linalg.norm(node)
    normal = np.cross(pole, node)
    t_ref = calendar_to_j2000_seconds(2005, 1, 1)
    out = {}
    for body, (a_km, period_days, u0_deg) in SATELLITE_ORBITS.items():
        n = 2.0 * math.pi / (period_days * 86400.0)
        u = (math.radians(u0_deg) + n * (t - t_ref))[..., None]
        pos = a_km * (np.cos(u) * node + np.sin(u) * normal)
        vel = a_km * n * (-np.sin(u) * node + np.cos(u) * normal)
        out[body] = np.concatenate([pos, vel], axis=-1)
    return out


def _type13_words(epochs: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Type 13 payload: states, epochs, epoch directory, window, count."""
    n = epochs.size
    directory = epochs[99::100][: (n - 1) // 100]
    return np.concatenate([
        states.reshape(-1), epochs, directory,
        [float(HERMITE_WINDOW), float(n)],
    ])


def _nutation(t: np.ndarray) -> np.ndarray:
    """
    (n, 4) nutation words of type 10 packets at epochs ``t``: obliquity,
    longitude [rad] and their rates [rad/s], from the 18.6-year lunar-node
    term alone (9.2 and -17.2 arcsec).
    """
    arcsec = math.pi / (180.0 * 3600.0)
    rate = -math.radians(0.0529538) / 86400.0  # the Moon's node [rad/s]
    node = math.radians(125.04) + rate * t
    return np.stack([
        9.2 * arcsec * np.cos(node), -17.2 * arcsec * np.sin(node),
        -9.2 * arcsec * rate * np.sin(node),
        -17.2 * arcsec * rate * np.cos(node),
    ], axis=-1)


def tle_packets(elements, epochs: np.ndarray) -> np.ndarray:
    """
    (n, 14) type 10 packets (CSPICE ``spkw10`` order: NDT20, NDD60, B*,
    inclination, node, eccentricity, argument of perigee, mean anomaly,
    mean motion [rad/min], epoch, then the nutation words) of one object
    with ``elements`` (as :data:`HST_ELEMENTS`) at ``epochs[0]``; the later
    sets advance the node, the perigee and the mean anomaly by SGP4's
    secular rates.
    """
    from ..kernels.sgp4 import sgp4_init_packets

    bstar, incl, node, ecc, argp, mean_anom, rev_day = elements
    deg = math.pi / 180.0
    epochs = np.asarray(epochs, dtype=np.float64)
    first = np.array([[
        0.0, 0.0, bstar, incl * deg, node * deg, ecc, argp * deg,
        mean_anom * deg, rev_day * 2.0 * math.pi / 1440.0, epochs[0],
        0.0, 0.0, 0.0, 0.0,
    ]])
    rates = sgp4_init_packets(np.asarray(TLE_CONSTANTS), first)
    minutes = (epochs - epochs[0]) / 60.0
    packets = np.repeat(first, epochs.size, axis=0)
    twopi = 2.0 * math.pi
    for col, key in ((4, 'nodedot'), (6, 'argpdot'), (7, 'mdot')):
        packets[:, col] = np.mod(first[0, col] + rates[key][0] * minutes,
                                 twopi)
    packets[:, 9] = epochs
    packets[:, 10:] = _nutation(epochs)
    return packets


def _type10_words(packets: np.ndarray) -> np.ndarray:
    """
    Type 10 payload, a generic segment (NAIF "generic segments"): the
    constants, the packets, their epochs as reference values, the
    reference directory (every 100th epoch), then the 17 meta items with
    0-based bases (the parsers read neither directory type).
    """
    n, size = packets.shape
    epochs = packets[:, 9]
    directory = epochs[99::100][: (n - 1) // 100]
    pktbas = len(TLE_CONSTANTS)
    refbas = pktbas + n * size
    rdrbas = refbas + n
    pdrbas = rdrbas + directory.size
    meta = [
        0, len(TLE_CONSTANTS),  # CONBAS, NCON
        rdrbas, directory.size, 0,  # RDRBAS, NRDR, RDRTYP
        refbas, n,  # REFBAS, NREF
        pdrbas, 0, 0,  # PDRBAS, NPDR, PDRTYP
        pktbas, n,  # PKTBAS, NPKT
        pdrbas, 0,  # RSVBAS, NRSV
        size, 0,  # PKTSZ, PKTOFF
        17,  # NMETA
    ]
    return np.concatenate([
        TLE_CONSTANTS, packets.reshape(-1), epochs, directory,
        np.asarray(meta, dtype=np.float64),
    ])


def tle_segments() -> list[tuple]:
    """The type 10 segments that ``tle=True`` adds (see the module's
    docstring), as ``_daf_bytes`` takes them."""
    start, end = coverage()
    epochs = start + TLE_STEP_S * np.arange(
        int(round((end - start) / TLE_STEP_S)) + 1
    )
    segments = [(-48, 399, 1, 10, float(epochs[0]), float(epochs[-1]),
                 'SYNTHETIC HST', _type10_words(
                     tle_packets(HST_ELEMENTS, epochs)))]
    t_ref = calendar_to_j2000_seconds(2005, 1, 1)
    deep_epochs = t_ref + 86400.0 * np.asarray(DEEP_TLE_DAYS)
    for body, elements in DEEP_TLE_IDS.items():
        segments.append(
            (body, 399, 1, 10, float(deep_epochs[0]), float(deep_epochs[-1]),
             f'SYNTHETIC {body}',
             _type10_words(tle_packets(elements, deep_epochs)))
        )
    return segments


def _daf_bytes(segments: list[tuple]) -> bytes:
    """
    Little-endian DAF/SPK bytes: file record, one summary record, one name
    record, then the segment words. ``segments`` holds
    ``(target, center, frame, data_type, start, end, name, words)``.
    """
    nd, ni = 2, 6
    ss = nd + (ni + 1) // 2
    if len(segments) > (128 - 3) // ss:
        raise ValueError('too many segments for one summary record')
    addr = 3 * 128 + 1  # first word of record 4
    summary = np.zeros(128, dtype='<f8')
    summary[2] = len(segments)
    names = bytearray(b' ' * 1024)
    payload = []
    for k, (target, center, frame, dtype, start, end, name, words) in enumerate(
        segments
    ):
        words = np.asarray(words, dtype='<f8')
        a0, a1 = addr, addr + words.size - 1
        addr = a1 + 1
        ints = np.array([target, center, frame, dtype, a0, a1], dtype='<i4')
        summary[3 + k * ss: 3 + (k + 1) * ss] = np.concatenate(
            [[start, end], ints.view('<f8')]
        )
        label = name.encode('ascii')[: 8 * ss].ljust(8 * ss)
        names[k * 8 * ss: (k + 1) * 8 * ss] = label
        payload.append(words)
    free = addr

    record = bytearray(1024)
    record[0:8] = b'DAF/SPK '
    record[8:16] = np.array([nd, ni], dtype='<i4').tobytes()
    record[16:76] = b'synthetic test kernel'.ljust(60)
    record[76:88] = np.array([2, 2, free], dtype='<i4').tobytes()
    record[88:96] = b'LTL-IEEE'
    record[699:699 + len(_FTPSTR)] = _FTPSTR

    data = np.concatenate(payload)
    pad = (-data.size) % 128
    data = np.concatenate([data, np.zeros(pad)]).astype('<f8')
    return bytes(record) + summary.tobytes() + bytes(names) + data.tobytes()


def write_sized_spk(path: str | os.PathLike, mib: int = 32,
                    n_segments: int = 13, seed: int = 0) -> str:
    """
    Write a DAF/SPK of ``n_segments`` type 13 segments (seeded words, not
    an ephemeris) filling about ``mib`` MiB, for timing the DAF readers at
    a planetary ephemeris's size (a de440s-like file: 32 MiB, 14
    segments; one summary record holds 13). Returns the path.
    """
    rng = np.random.default_rng(seed)
    words = mib * 2**20 // 8 // n_segments
    segments = [(k, 0, 1, 13, 0.0, 1.0, f'SIZED {k}', rng.normal(size=words))
                for k in range(1, n_segments + 1)]
    with open(path, 'wb') as f:
        f.write(_daf_bytes(segments))
    return os.fspath(path)


def _epochs(step: float) -> np.ndarray:
    start, end = coverage()
    return start + step * np.arange(int(round((end - start) / step)) + 1)


def write_synthetic_kernels(
    dirpath: str | os.PathLike, seed: int = 0, satellites: bool = False,
    tle: bool = False,
) -> list[str]:
    """
    Write the synthetic LSK, PCK and SPK into ``dirpath`` (created if
    missing) and return their paths; ``satellites`` adds Io and Amalthea,
    ``tle`` the type 10 segments of HST and the deep-space test objects
    (see the module's docstring).
    """
    dirpath = os.fspath(dirpath)
    os.makedirs(dirpath, exist_ok=True)

    table = '\n    '.join(f'{v}, @{d}' for v, d in _LEAP_SECONDS)
    lsk = os.path.join(dirpath, 'synthetic.tls')
    with open(lsk, 'w', encoding='ascii') as f:
        f.write(_LSK_TEXT.format(table=table))

    pck = os.path.join(dirpath, 'synthetic.tpc')
    with open(pck, 'w', encoding='ascii') as f:
        f.write(_PCK_TEXT + (_SATELLITE_PCK_TEXT if satellites else ''))

    epochs = _epochs(STEP_S)
    states = synthetic_states(epochs, seed)
    segments = [
        (body, 0, 1, 13, float(epochs[0]), float(epochs[-1]),
         f'SYNTHETIC {body}', _type13_words(epochs, states[body]))
        for body in (10, 399, 599)
    ]
    if satellites:
        epochs = _epochs(SATELLITE_STEP_S)
        for body, moon in satellite_states(epochs).items():
            segments.append(
                (body, 599, 1, 13, float(epochs[0]), float(epochs[-1]),
                 f'SYNTHETIC {body}', _type13_words(epochs, moon))
            )
    if tle:
        segments.extend(tle_segments())
    spk = os.path.join(dirpath, 'synthetic.bsp')
    with open(spk, 'wb') as f:
        f.write(_daf_bytes(segments))
    return [lsk, pck, spk]
