"""
The cases of the JAX package's dsk kernel tests
(``tests/test_pallas_core.py``: ``TestDskOnTpu.test_mul_div_sqrt_grade``,
``test_atan2_ds_grade``, ``test_atan2_f32_grade``, ``:538-616``): their
inputs from their seeds at any size (8192 values in those tests), their
float64 references and their grades. ``chip_smoke.py``, the card tests and
the CPU tests share them. numpy only.
"""

from __future__ import annotations

import numpy as np

#: The tests' values: one (8, 1024) block
N_TEST = 8 * 1024

#: Grades: relative for the products, quotients and roots, absolute
#: radians for the angles
GRADES = {'mul': 1e-13, 'div': 1e-13, 'hypot': 1e-13, 'atan2_ds': 5e-12,
          'atan2': 5e-7}
RELATIVE = ('mul', 'div', 'hypot')
#: ``dsk_pairs<atan2_ds>``, native float64, against its plain version, the
#: double-single chain: |hi + lo| in rad, a fifth of the grade and 4x the
#: chain's error against float64 numpy (2.51e-13 on the card at 2048^2)
ATAN2_DS_VS_PLAIN = 1e-12

#: (y, x) edge values: the axes, the origin, the quadrants, -0, a tiny y,
#: NaN in either
EDGES = ((0.0, 1.0), (1.0, 0.0), (0.0, -1.0), (-1.0, 0.0), (0.0, 0.0),
         (1.0, 1.0), (-1.0, -1.0), (1.0, -3.0), (-3.0, 1.0), (1e-30, -1.0),
         (-0.0, 1.0), (-0.0, -1.0), (0.0, -0.0), (np.nan, 1.0),
         (1.0, np.nan))


def on_an_axis(y: float, x: float) -> bool:
    """Whether an :data:`EDGES` pair lies on an axis, at the origin or has a
    NaN: where the zero and NaN conventions fix atan2_ds's words, so that
    the float64 kernel and the double-single chain agree word for word."""
    return y == 0 or x == 0 or bool(np.isnan(y)) or bool(np.isnan(x))


def pair_inputs(op: str, n: int = N_TEST) -> tuple[np.ndarray, np.ndarray]:
    """
    The float64 ``(a, b)`` of a pair op: seed 0, ``a ~ N(0, 1e9)`` and
    ``b = N(0, 1e9) + a`` for ``'mul'``, ``'div'`` and ``'hypot'``; seed 1,
    ``(y, x)`` standard normal for ``'atan2_ds'``.
    """
    if op == 'atan2_ds':
        rng = np.random.default_rng(1)
        x = rng.normal(size=n)
        return rng.normal(size=n), x
    rng = np.random.default_rng(0)
    a = rng.normal(size=n) * 1e9
    return a, rng.normal(size=n) * 1e9 + a


def atan2_inputs(n: int = N_TEST) -> tuple[np.ndarray, np.ndarray]:
    """The float32 ``(y, x)`` of the float32 atan2: seed 2, standard normal
    (x drawn first)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=n).astype(np.float32)
    return rng.normal(size=n).astype(np.float32), x


def reference(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The float64 value of ``op`` on float64 ``a`` and ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if op == 'mul':
        return a * b
    if op == 'div':
        return a / b
    if op == 'hypot':
        return np.sqrt(a * a + b * b)
    return np.arctan2(a, b)


def error(op: str, got: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    """The largest error of ``got`` (float64) against :func:`reference`,
    relative or absolute as :data:`GRADES` is."""
    ref = reference(op, a, b)
    err = np.abs(np.asarray(got, np.float64) - ref)
    if op in RELATIVE:
        err = err / np.abs(ref)
    return float(np.max(err))
