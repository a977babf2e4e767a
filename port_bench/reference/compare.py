"""
The numbers that decide ``correct``: what the timed path produced against
the reference, each reduced to one number whose limit a cell's
``workloads/<cell>.json`` gives.

- ``plane_gap``: over every plane of every compared frame, the largest gap
  between the program's value and the reference's, in units of that
  plane's bar (the JAX package's per-plane table for its kernel, angles in
  degrees, plus one float32 unit in the last place of the reference value,
  since the planes are stored in float32), and of 100 bars where the
  geometry amplifies rounding (the table's ill-conditioned pixels: grazing
  rays, longitudes near a pole, AZIMUTH near the sub-solar and
  sub-observer points, limb coordinates of rays near the centre).
  Longitudes compare on the circle; LOCAL-SOLAR-TIME modulo its
  one-second bin (values quantised to whole seconds fall to either side
  of a bin edge by rounding).
- ``mask_flips``: pixels whose value is finite on one side and NaN on the
  other, summed over the compared planes and frames.
- ``map_gap``: the largest absolute gap of a map value finite on both
  sides (the maps are float32 of images of unit scale).
- ``map_flips``: map values finite on one side and NaN on the other.
"""

from __future__ import annotations

import numpy as np

#: Absolute bars per plane (the JAX package's table for its kernel);
#: planes not listed are angles in degrees
BARS = {
    'KM-X': 1e-6, 'KM-Y': 1e-6, 'ANGULAR-X': 1e-6, 'ANGULAR-Y': 1e-6,
    'PIXEL-X': 0.0, 'PIXEL-Y': 0.0, 'DISTANCE': 1e-3,
    'RADIAL-VELOCITY': 1e-6, 'DOPPLER': 1e-9, 'LIMB-DISTANCE': 0.02,
    'RING-RADIUS': 1.0, 'RING-DISTANCE': 1e-3, 'LOCAL-SOLAR-TIME': 2.9e-4,
}
ANGLE_BAR = 1e-4
ILL_CONDITIONED_FACTOR = 100.0
LST_BIN = 1.0 / 3600.0
DISC_PLANES = (
    'LON-GRAPHIC', 'LAT-GRAPHIC', 'LON-CENTRIC', 'LAT-CENTRIC',
    'PHASE', 'INCIDENCE', 'EMISSION', 'AZIMUTH',
    'LOCAL-SOLAR-TIME', 'DISTANCE', 'RADIAL-VELOCITY', 'DOPPLER',
)


def ill_conditioned(ref: dict, r_eq: float) -> dict[str, np.ndarray]:
    """Pixels where a plane's value is ill-conditioned in its inputs,
    from the reference planes."""
    with np.errstate(invalid='ignore'):
        emission = ref['EMISSION']
        incidence = ref['INCIDENCE']
        grazing = ~(emission < 75.0)
        polar = ~(np.abs(ref['LAT-GRAPHIC']) < 75.0)
        limb_polar = ~(np.abs(ref['LIMB-LAT-GRAPHIC']) < 60.0)
        caps = (grazing | ~(incidence > 5.0) | ~(incidence < 175.0)
                | ~(emission > 5.0))
        near_centre = np.hypot(ref['KM-X'], ref['KM-Y']) < 0.5 * r_eq
    out = {name: grazing for name in DISC_PLANES}
    for name in ('LON-GRAPHIC', 'LON-CENTRIC', 'LOCAL-SOLAR-TIME'):
        out[name] = grazing | polar
    out['AZIMUTH'] = caps
    for name in ('LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC'):
        out[name] = near_centre | limb_polar
    return out


def planes(got: dict, ref: dict, r_eq: float) -> tuple[float, int, dict]:
    """``(plane_gap, mask_flips, {plane: gap})`` of one frame's planes."""
    ill = ill_conditioned(ref, r_eq)
    gap, flips, each = 0.0, 0, {}
    for name, r in ref.items():
        g = np.asarray(got[name], dtype=np.float64)
        flips += int(np.sum(np.isfinite(g) != np.isfinite(r)))
        both = np.isfinite(g) & np.isfinite(r)
        d = np.abs(g[both] - r[both])
        if 'LON' in name:
            d = np.minimum(d, 360.0 - d)
        if name == 'LOCAL-SOLAR-TIME':
            d = np.minimum(d, np.abs(d - LST_BIN))
        bar = BARS.get(name, ANGLE_BAR) + np.spacing(
            np.abs(r[both]).astype(np.float32)).astype(np.float64)
        if name in ill:
            bar = bar * np.where(ill[name][both], ILL_CONDITIONED_FACTOR, 1.0)
        each[name] = float(np.max(d / bar)) if d.size else 0.0
        gap = max(gap, each[name])
    return gap, flips, each


def maps(got: np.ndarray, ref: np.ndarray) -> tuple[float, int]:
    """``(map_gap, map_flips)`` of maps of the same shape."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    flips = int(np.sum(np.isfinite(got) != np.isfinite(ref)))
    both = np.isfinite(got) & np.isfinite(ref)
    gap = float(np.max(np.abs(got[both] - ref[both]))) if both.any() else 0.0
    return gap, flips
