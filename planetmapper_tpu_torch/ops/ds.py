"""
Double-single ("two-float") arithmetic at the graph level (port of
``planetmapper_tpu.ops.ds``).

A value is a ``(hi, lo)`` tuple of same-shape float32 tensors with the
normalisation invariant ``|lo| <= ulp(hi)/2`` (kept by a trailing
``quick_two_sum`` in every op), carrying ~49 mantissa bits through the
classic error-free transformations (Dekker/Knuth, as in the CUDA/QD
"double-single" libraries). Results round-trip losslessly through
:func:`from_f64` / :func:`to_f64`.

- ``two_prod`` uses Dekker splitting (:func:`.dsk.two_prod`): the 12-bit
  halves' products are exact in float32, so the sequence holds under any
  contraction of a multiply into an FMA.
- Magnitude domain: |x| < ~8e34 (the split constant 2^12+1 must not
  overflow) and |x| > ~1e-37 for the Newton seeds.
- NaN propagates through every op.

The JAX module pins its pairs behind ``lax.optimization_barrier``
(``from_f64``, ``hi``) because XLA's excess-precision and fast-math passes
rewrite float32 chains inside one compiled graph (evaluating them in
float64 and rounding once, or reassociating them), which nulls the
error-free terms. PyTorch runs eagerly: each operation is one call that
rounds its float32 result once, as written, and nothing rewrites a chain
of calls. So the port has no barrier; ``tests/test_torch_dsk.py`` shows the
lo words surviving a cancelling chain.

The error-free transformations, the product, the reciprocal and the
quotient are the same arithmetic as :mod:`.dsk`'s (the JAX package keeps two
copies), so they are taken from there; this module adds the accurate
``add`` (exact under cancellation), the conversions and the graph-level
roots.

On the card and on the CPU the port's pipeline runs native float64
(:mod:`.ds64`, :func:`planetmapper_tpu_torch.pipeline.pick_ds`); this module
is the TPU arithmetic, kept for parity and chosen by
``PLANETMAPPER_TPU_DS=ds``.
"""

from __future__ import annotations

import torch

from .dsk import (add_f, div, mul, mul_f, neg, quick_two_sum, recip,
                  recip_seed, rsqrt_seed, two_prod, two_sum)

__all__ = [
    'two_sum', 'quick_two_sum', 'two_prod', 'const', 'from_f32', 'from_f64',
    'to_f64', 'hi', 'neg', 'add', 'sub', 'add_f', 'sub_f', 'mul', 'mul_f',
    'recip_seed', 'recip', 'div', 'rsqrt', 'sqrt', 'dot3', 'matvec3',
]

F32 = torch.float32


# ---------------------------------------------------------------------------
# ds construction / conversion


def const(x: float, device=None):
    """Python float -> ds constant (0-dim float32 tensors on ``device``;
    exact split via float64 host math)."""
    hi_ = torch.tensor(x, dtype=F32, device=device)
    lo_ = torch.tensor(x - float(hi_), dtype=F32, device=device)
    return hi_, lo_


def from_f32(x):
    return x, torch.zeros_like(x)


def from_f64(x):
    """float64 tensor -> (hi, lo) float32 pair (exact; inverse of
    :func:`to_f64`)."""
    hi_ = x.to(F32)
    lo_ = (x - hi_.to(x.dtype)).to(F32)
    return hi_, lo_


def to_f64(d):
    """(hi, lo) -> float64 tensor (exact: hi and lo are representable)."""
    return d[0].to(torch.float64) + d[1].to(torch.float64)


def hi(d):
    """float32 value of a ds pair: the pair combined in float64 and rounded
    once, which is the hi word (``|lo| <= ulp(hi)/2``)."""
    return to_f64(d).to(F32)


# ---------------------------------------------------------------------------
# arithmetic (neg, add_f, mul, mul_f, recip_seed, recip, div: see .dsk)


def add(a, b):
    """Accurate ds + ds (Knuth two-sum chain; exact under cancellation)."""
    s, e = two_sum(a[0], b[0])
    t, f = two_sum(a[1], b[1])
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return quick_two_sum(s, e)


def sub(a, b):
    return add(a, neg(b))


def sub_f(a, b):
    return add_f(a, -b)


def rsqrt(a):
    """
    1/sqrt(a) in ds: a float32 seed (``1 / sqrt``, correctly rounded on the
    CPU and on the card: :func:`.dsk.rsqrt_seed`), one float32 Newton
    step and one ds Newton step; ~2^-47 relative. a <= 0 or NaN propagates
    NaN (except +0 -> +inf seeds, which the callers clamp).
    """
    x = a[0]
    r0 = rsqrt_seed(x)
    r0 = r0 * (1.5 - 0.5 * x * r0 * r0)  # float32 Newton: seed -> ~1 ulp
    # ds Newton: r = r0 + r0*(1 - a*r0^2)/2
    r0sq = two_prod(r0, r0)
    ar2 = mul(a, r0sq)
    h = mul_f(add_f(neg(ar2), 1.0), torch.full_like(x, 0.5))
    corr = mul_f(h, r0)
    return add_f(corr, r0)


def sqrt(a):
    """sqrt(a) for a >= 0 in ds; 0 -> 0, negative/NaN -> NaN."""
    pos = a[0] > 0.0
    safe = (torch.where(pos, a[0], 1.0), torch.where(pos, a[1], 0.0))
    r = mul(safe, rsqrt(safe))
    zero = torch.zeros_like(a[0])
    nan = torch.full_like(a[0], float('nan'))
    neg_or_nan = ~pos & (a[0] != 0.0)  # negative or NaN (NaN != 0 is True)
    hi_ = torch.where(pos, r[0], torch.where(neg_or_nan, nan, zero))
    lo_ = torch.where(pos, r[1], zero)
    return hi_, lo_


# ---------------------------------------------------------------------------
# 3-vector helpers (components as separate ds values)


def dot3(ax, ay, az, bx, by, bz):
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def matvec3(m, vx, vy, vz):
    """(3, 3) ds matrix (nested tuples) @ ds 3-vector -> 3 ds components."""
    return tuple(
        add(add(mul(m[i][0], vx), mul(m[i][1], vy)), mul(m[i][2], vz))
        for i in range(3)
    )
