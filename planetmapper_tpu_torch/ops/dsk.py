"""
Kernel-safe double-single (two-float) arithmetic and float32 inverse
trigonometry (port of ``planetmapper_tpu.ops.dsk``).

The JAX module is what its Pallas TPU kernels compute: (hi, lo) float32
pair arithmetic with no float64 anywhere (splits from float64 happen
outside a kernel, :func:`split_f64`), a branch-free polynomial ``atan2`` in
float32 (Mosaic has no inverse-trig lowering) and an extended-precision
:func:`atan2_ds`. Here every function is plain PyTorch, one rounded float32
operation per call, so that it is the plain version of the CUDA kernels of
:mod:`.dsk_kernel` (``csrc/dsk.cu``), which follow it operation by
operation.

The port keeps its own copy of every constant (:data:`_SPLIT`,
:data:`RECIP_MAGIC`, :data:`_ATAN_C`, :data:`_ATAN_DS_C` and its splits,
:data:`_TAN_PI_8`, :data:`_PI_4`, :data:`_PI_2`, :data:`_PI`); a CPU test
holds each, word for word, to the JAX module's and to ``csrc/dsk.cu``'s.

Scalars are Python floats holding float32 values exactly: PyTorch rounds a
Python scalar to the tensor's float32 without changing it.

One choice differs from the JAX module: the float32 seed of :func:`rsqrt`
is ``1 / sqrt(x)``, a square root (:func:`sqrt32`) and a division each
correctly rounded on the CPU and on the card, where the JAX module takes
``lax.rsqrt`` (on XLA:CPU not ``1 / sqrt``: ~29% of float32 seeds differ
by an ulp). The kernel takes the same seed, so that it equals this module
bit for bit; the ds Newton step keeps the grade against the JAX package's
result.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32

# Dekker splitter for float32: 2^12 + 1 (24-bit mantissa -> 12+12 split).
_SPLIT = 4097.0

#: ``RECIP_MAGIC - bits(|x|)`` is a ~5%-accurate float32 reciprocal
RECIP_MAGIC = 0x7EF311C3


def f(x: float) -> float:
    """Python float -> the nearest float32 value, as a Python float."""
    return float(np.float32(x))


def const(x: float) -> tuple[float, float]:
    """Python float -> ds constant pair (split exactly via numpy float64)."""
    hi_ = np.float32(x)
    lo_ = np.float32(np.float64(x) - np.float64(hi_))
    return float(hi_), float(lo_)


def split_f64(x: torch.Tensor):
    """float64 tensor -> (hi, lo) float32 pair, exact (outside a kernel)."""
    hi_ = x.to(F32)
    lo_ = (x - hi_.to(x.dtype)).to(F32)
    return hi_, lo_


def two_sum(a, b):
    """Knuth two-sum: a + b = s + e exactly (no branch, any magnitudes)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Fast two-sum, REQUIRES |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Dekker product: a * b = p + e exactly (|e| <= ulp(p)/2)."""
    p = a * b
    ah = _SPLIT * a
    ah = ah - (ah - a)
    al = a - ah
    bh = _SPLIT * b
    bh = bh - (bh - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(a, b):
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return quick_two_sum(s, e)


def neg(a):
    return -a[0], -a[1]


def sub(a, b):
    return add(a, neg(b))


def add_f(a, b):
    """ds + float32 (a tensor, or a Python float holding a float32 value)."""
    s, e = two_sum(a[0], b)
    e = e + a[1]
    return quick_two_sum(s, e)


def mul(a, b):
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return quick_two_sum(p, e)


def mul_f(a, b):
    """ds * float32 (a tensor of the same shape as the pair)."""
    p, e = two_prod(a[0], b)
    e = e + a[1] * b
    return quick_two_sum(p, e)


def mul_pair(a, c):
    """ds * ds-constant pair (e.g. :func:`const`): the constant's exact split
    keeps an irrational factor at ds grade where a single float32 constant
    would inject its 3e-8 rounding."""
    ones = torch.ones_like(a[0])
    return add(mul_f(a, c[0] * ones), mul_f(a, c[1] * ones))


def sqr(a):
    p, e = two_prod(a[0], a[0])
    e = e + 2.0 * (a[0] * a[1])
    return quick_two_sum(p, e)


def recip_seed(x):
    """
    ~float32-accurate 1/x without a float division: the integer
    exponent-flip seed ``RECIP_MAGIC - bits(|x|)`` (~0.05 relative), then
    three Newton steps (0.05 -> 2.5e-3 -> 6e-6 -> ~2^-24). The JAX package
    avoids a division because fast-math backends lower it approximately;
    the port keeps the seed so that both packages compute the same words.
    Domain: magnitudes in ~[1e-37, 1e37]; x = 0 or inf give garbage finite
    or NaN values (callers clamp); NaN propagates.
    """
    bits = torch.abs(x).view(torch.int32)
    r = (RECIP_MAGIC - bits).view(F32)
    r = torch.where(x < 0, -r, r)
    for _ in range(3):
        r = r * (2.0 - x * r)
    return r


def recip(a):
    """1/a in ds (~2^-47 relative); a = +-0 yields NaN, callers clamp."""
    r0 = recip_seed(a[0])
    ar = mul_f(a, r0)
    d = add_f(neg(ar), 2.0)
    return mul_f(d, r0)


def div(a, b):
    return mul(a, recip(b))


def sqrt32(x):
    """
    Correctly rounded float32 square root on every device: the float64 root
    rounded to float32 (the double rounding is innocuous for a square root,
    53 >= 2 * 24 + 2 bits). ``torch.sqrt`` on large float32 CPU tensors is
    not correctly rounded (a vectorised path, 1 ulp off on ~0.6% of
    values); on the card it is, as is the kernel's ``__fsqrt_rn``.
    """
    return torch.sqrt(x.to(torch.float64)).to(F32)


def rsqrt_seed(x):
    """float32 1/sqrt(x) as ``1 / sqrt(x)``, both correctly rounded (the
    kernel's seed; see the module docstring)."""
    return torch.reciprocal(sqrt32(x))


def rsqrt(a):
    """1/sqrt(a) in ds via a float32 seed + one ds Newton step (~2^-47)."""
    r0 = rsqrt_seed(a[0])
    # r = r0 * (3 - a r0^2) / 2
    ar2 = mul_f(mul_f(a, r0), r0)
    d = add_f(neg(ar2), 3.0)
    return mul_f(mul_f(d, r0), torch.full_like(r0, 0.5))


def sqrt(a):
    """sqrt(a) in ds: 0 -> 0, negative -> NaN (via float32 sqrt of hi)."""
    zero = a[0] == 0.0
    r = rsqrt((torch.where(zero, 1.0, a[0]), a[1]))
    s = mul(a, r)
    return (torch.where(zero, sqrt32(a[0]), s[0]),
            torch.where(zero, 0.0, s[1]))


def hi(a):
    """float32 value of the pair (hi word; |lo| <= ulp(hi)/2 by invariant)."""
    return a[0]


def dot3(ax, ay, az, bx, by, bz):
    """ds dot product of two 3-vectors given per-component pairs."""
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


# ---------------------------------------------------------------------------
# float32 inverse trigonometry

#: Odd polynomial for atan(t) = t + t s P(s), s = t^2, t in [0, 1]: degree-8
#: P fit on Chebyshev nodes with absolute-angle-error weighting (max abs
#: error 1.2e-9 rad in float64; 8.1e-8 rad evaluated in float32).
_ATAN_C = tuple(f(c) for c in (
    -3.333326173e-01,
    1.999758226e-01,
    -1.425504596e-01,
    1.090806998e-01,
    -8.283304255e-02,
    5.601739415e-02,
    -2.933780249e-02,
    9.967789620e-03,
    -1.589621920e-03,
))
_PI_2_F = f(np.pi / 2)
_PI_F = f(np.pi)


def atan2(y, x):
    """
    Branch-free float32 atan2 (4-quadrant), ~1-2 ulp. NaN propagates;
    (0, 0) returns 0 like the hardware convention, and a -0 ``y`` counts as
    +0 (so atan2(-0, -1) is +pi, where ``np.arctan2`` gives -pi).
    """
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi_ = torch.maximum(ax, ay)
    lo_ = torch.minimum(ax, ay)
    # t in [0, 1]; guard 0/0
    t = lo_ / torch.where(hi_ == 0.0, 1.0, hi_)
    s = t * t
    p = torch.full_like(s, _ATAN_C[-1])
    for c in _ATAN_C[-2::-1]:
        p = p * s + c
    r = t + t * (s * p)
    # reflect: t was min/max, so if |y| > |x| the angle is pi/2 - r
    r = torch.where(ay > ax, _PI_2_F - r, r)
    r = torch.where(x < 0.0, _PI_F - r, r)
    r = torch.where(y < 0.0, -r, r)
    # propagate NaN inputs (comparisons above silently take branches)
    nan = torch.isnan(x) | torch.isnan(y)
    return torch.where(nan, float('nan'), r)


def asin(z):
    """float32 arcsin via atan2(z, sqrt(1-z^2)); |z| <= 1 (clipped)."""
    z = torch.clamp(z, -1.0, 1.0)
    return atan2(z, sqrt32(torch.clamp(1.0 - z * z, min=0.0)))


def acos(z):
    """float32 arccos via atan2(sqrt(1-z^2), z); |z| <= 1 (clipped)."""
    z = torch.clamp(z, -1.0, 1.0)
    return atan2(sqrt32(torch.clamp(1.0 - z * z, min=0.0)), z)


# ---------------------------------------------------------------------------
# extended-precision atan2 (ds result, ~2^-45 rad absolute)

#: atan(t) for t in [0, tan(pi/8)]: the odd Taylor terms (-1)^k / (2k + 1)
#: of k = 1..13 (with |t| <= 0.4142, 13 terms reach ~1e-15 relative)
_ATAN_DS_C = tuple((-1.0) ** k / (2 * k + 1) for k in range(1, 14))
_ATAN_DS_PAIRS = tuple(const(c) for c in _ATAN_DS_C)
_TAN_PI_8 = 0.41421356237309503  # tan(pi/8), float64
_TAN_PI_8_F = f(_TAN_PI_8)
_PI_4, _PI_2, _PI = const(math.pi / 4), const(math.pi / 2), const(math.pi)


def _full(c: tuple[float, float], like: torch.Tensor):
    return torch.full_like(like, c[0]), torch.full_like(like, c[1])


def _select(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def atan2_ds(y, x):
    """
    Four-quadrant arctangent of ds pairs with a ds (hi, lo) result, ~2^-45
    rad: an exact octant reduction (swap and sign fixes), the [0, 1] ->
    [0, tan(pi/8)] step atan(t) = pi/4 + atan((t-1)/(t+1)) in ds, then the
    13-term odd Taylor series in ds Horner form.
    """
    xh, xl = x
    yh, yl = y
    ax = (torch.abs(xh), torch.where(xh < 0, -xl, xl))
    ay = (torch.abs(yh), torch.where(yh < 0, -yl, yl))
    swap = ay[0] > ax[0]
    num = _select(swap, ax, ay)
    den = _select(swap, ay, ax)
    den_zero = den[0] == 0.0
    den_safe = (torch.where(den_zero, 1.0, den[0]),
                torch.where(den_zero, 0.0, den[1]))
    t = div(num, den_safe)  # in [0, 1]
    # second reduction: t > tan(pi/8) -> (t - 1)/(t + 1), in [-0.414, 0]
    red = t[0] > _TAN_PI_8_F
    t2 = div(add_f(t, -1.0), add_f(t, 1.0))
    u = _select(red, t2, t)
    s = sqr(u)
    p = _full(_ATAN_DS_PAIRS[-1], s[0])
    for c in _ATAN_DS_PAIRS[-2::-1]:
        p = add(mul(p, s), _full(c, s[0]))
    # atan(u) = u + u * s * p
    r = add(u, mul(u, mul(s, p)))
    r = _select(red, add(r, _full(_PI_4, r[0])), r)
    # undo swap: angle = pi/2 - r
    r = _select(swap, add(_full(_PI_2, r[0]), neg(r)), r)
    # x < 0: angle = pi - r
    r = _select(xh < 0.0, add(_full(_PI, r[0]), neg(r)), r)
    # y < 0: negate
    r = _select(yh < 0.0, neg(r), r)
    nan = torch.isnan(xh) | torch.isnan(yh)
    return torch.where(nan, float('nan'), r[0]), torch.where(
        nan, float('nan'), r[1])
