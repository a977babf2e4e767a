"""
Plane-by-plane comparison of two backplane sets (numpy only).

Used by the tests and by ``chip_smoke.py`` to hold the CUDA kernel against
its plain float64 PyTorch version, and the port against the JAX package.

The kernel tolerances are the JAX package's table for its TPU kernel
(``tests/test_pallas_core.py:673-696``): per-plane absolute bounds (angles
in degrees, 1e-4 unless listed), at most 8 pixels whose NaN mask differs
per plane, and at most 8 LOCAL-SOLAR-TIME pixels a 1-second bin apart.

Longitude planes are compared on the circle (``min(d, 360 - d)``), for
two reasons: a longitude that rounds to either side of the 0/360 seam,
and LON-CENTRIC at ``precision='double'``, where the plain float64 graph
reports (-180, 180] (as the JAX package's ``precision='double'`` graph
does). At the default precision ``'mixed'`` every implementation (the
plain graph on a CPU body, the CUDA kernel, the JAX package's mixed graph
and TPU kernel) reports LON-CENTRIC in [0, 360).
"""

from __future__ import annotations

import numpy as np

#: Absolute tolerances of a kernel against its reference (the JAX
#: package's table); planes not listed are angles in degrees.
KERNEL_TOLERANCE: dict[str, float] = {
    'KM-X': 1e-6, 'KM-Y': 1e-6, 'ANGULAR-X': 1e-6,
    'ANGULAR-Y': 1e-6, 'PIXEL-X': 0.0, 'PIXEL-Y': 0.0,
    'DISTANCE': 1e-3, 'RADIAL-VELOCITY': 1e-6, 'DOPPLER': 1e-9,
    'LIMB-DISTANCE': 0.02, 'RING-RADIUS': 1.0,
    'RING-DISTANCE': 1e-3, 'LOCAL-SOLAR-TIME': 2.9e-4,
}
KERNEL_ANGLE_TOLERANCE = 1e-4
MAX_MASK_FLIPS = 8
MAX_LST_BIN_FLIPS = 8

_LST_HALF_BIN = 0.5 / 3600.0


def kernel_tolerance(name: str) -> float:
    return KERNEL_TOLERANCE.get(name, KERNEL_ANGLE_TOLERANCE)


def as_float32_storage(values) -> np.ndarray:
    """
    ``values`` stored the way the kernels store a plane: rounded to float32
    (and widened back to float64, as the wrappers do for RADIAL-VELOCITY).
    """
    return np.asarray(values).astype(np.float32).astype(np.float64)


def compare_plane(
    name: str, got, ref, *, atol: float, float32_ulps: int = 0,
    exclude=None, max_mask_flips: int = MAX_MASK_FLIPS,
) -> dict:
    """
    Compare one plane. With ``float32_ulps > 0`` the reference is first
    stored as the kernels store a plane (float32) and each bound grows by
    that many float32 units in the last place of the reference value: one
    for two values on either side of a float32 rounding boundary, two when
    ``got`` was also computed in float32 arithmetic. ``exclude`` masks
    pixels out of the value comparison.

    Returns a report dict with ``ok``, ``reason``, ``mask_flips``,
    ``max_abs_err`` (NaN when no pixel is finite in both) and
    ``lst_bin_flips``.
    """
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return dict(ok=False, reason=f'shape {got.shape} != {ref.shape}',
                    mask_flips=-1, max_abs_err=np.nan, lst_bin_flips=0)
    if float32_ulps:
        ref = as_float32_storage(ref)
    mask_flips = int(np.sum(np.isfinite(got) != np.isfinite(ref)))
    both = np.isfinite(got) & np.isfinite(ref)
    if exclude is not None:
        both &= ~np.asarray(exclude, dtype=bool)
    d = np.abs(got[both] - ref[both])
    if 'LON' in name:
        d = np.minimum(d, 360.0 - d)
    bound = np.full(d.shape, atol)
    if float32_ulps:
        bound = bound + float32_ulps * np.spacing(
            np.abs(ref[both]).astype(np.float32)
        )
    lst_flips = 0
    if name == 'LOCAL-SOLAR-TIME':
        lst_flips = int(np.sum(d > _LST_HALF_BIN))
    max_err = float(d.max()) if d.size else float('nan')
    reasons = []
    if mask_flips > max_mask_flips:
        reasons.append(f'{mask_flips} mask flips')
    if d.size and np.any(d > bound):
        k = int(np.argmax(d - bound))
        reasons.append(f'max error {d[k]:.3e} over bound {bound[k]:.3e}')
    if lst_flips > MAX_LST_BIN_FLIPS:
        reasons.append(f'{lst_flips} LST bin flips')
    return dict(
        ok=not reasons, reason='; '.join(reasons), mask_flips=mask_flips,
        max_abs_err=max_err, lst_bin_flips=lst_flips,
    )


def compare_backplanes(
    got: dict, ref: dict, *, tolerance=kernel_tolerance,
    float32_ulps: int = 0, exclude: dict | None = None,
    max_mask_flips: int = MAX_MASK_FLIPS,
) -> dict[str, dict]:
    """
    :func:`compare_plane` for every plane of ``got`` (``ref`` must hold
    each of them); ``tolerance`` maps a plane name to its bound and
    ``exclude`` maps plane names to masks of excluded pixels.
    """
    exclude = exclude or {}
    return {
        name: compare_plane(
            name, got[name], ref[name], atol=tolerance(name),
            float32_ulps=float32_ulps, exclude=exclude.get(name),
            max_mask_flips=max_mask_flips,
        )
        for name in got
    }


def failures(reports: dict[str, dict]) -> dict[str, str]:
    """The planes of a :func:`compare_backplanes` result that failed."""
    return {k: r['reason'] for k, r in reports.items() if not r['ok']}
