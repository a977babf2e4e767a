"""
float64 results from a float32 seed refined by Newton steps in float64
multiplies and adds (port of ``planetmapper_tpu.ops.fastmath``).

The TPU emulates float64, where a division, a square root or a
transcendental costs 10-40 float64 multiplies; these helpers avoid them:

- ``recip64`` / ``rsqrt64`` / ``sqrt64``: a float32 reciprocal or rsqrt seed
  refined by ONE float64 Newton step, which squares the seed's 24-bit error
  to ~2^-48 (~3e-15 relative): ample for every pipeline use, but not full
  float64.
- ``div64``: the quotient with a residual correction (~1 ulp).
- ``norm3_64`` / ``normalize3_64``: 3-vector norms built on the above.

NaN inputs propagate to NaN everywhere. The H100 has native float64
division and square roots, so the port's pipeline does not use these; they
are kept for parity with the JAX package.
"""

from __future__ import annotations

import torch

from .dsk import recip_seed, rsqrt_seed


def recip64(x: torch.Tensor) -> torch.Tensor:
    """1/x in near-float64 accuracy: the division-free float32 seed
    (:func:`.dsk.recip_seed`) and one float64 Newton step. The seed needs |x|
    in ~[1e-37, 1e37]; callers clamp degenerate denominators."""
    r = recip_seed(x.to(torch.float32)).to(torch.float64)
    return r * (2.0 - x * r)


def div64(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den via :func:`recip64` with a final residual correction."""
    r = recip64(den)
    q = num * r
    return q + (num - den * q) * r


def rsqrt64(x: torch.Tensor) -> torch.Tensor:
    """
    1/sqrt(x) in near-float64 accuracy: a float32 seed
    (:func:`.dsk.rsqrt_seed`), one float32 and one float64 Newton step. x is
    clamped to [1e-37, 3e37] CONSISTENTLY (seed and Newton step), so huge x
    gives a finite positive (inaccurate) value rather than inf. Negative x
    and NaN give NaN.
    """
    xc = torch.clamp(x, 1e-37, 3e37)
    seed = xc.to(torch.float32)
    r32 = rsqrt_seed(seed)
    r32 = r32 * (1.5 - 0.5 * seed * r32 * r32)
    r = r32.to(torch.float64)
    r = r * (1.5 - 0.5 * xc * r * r)  # ~3e-15 relative after the f64 step
    return torch.where(x < 0.0, float('nan'), r)  # NaN compares False


def sqrt64(x: torch.Tensor) -> torch.Tensor:
    """
    sqrt(x) for x >= 0 (near-float64 accuracy). 0.0 for x == 0 and for
    negative x (callers mask negatives, as the plain pipeline clamps
    discriminants before its sqrt); NaN propagates.
    """
    pos = x > 0.0
    r = rsqrt64(torch.where(pos, x, 1.0))
    out = torch.where(pos, x * r, 0.0)
    return torch.where(torch.isnan(x), float('nan'), out)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (
        a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    )


def norm3_64(v: torch.Tensor) -> torch.Tensor:
    return sqrt64(dot3(v, v))


def normalize3_64(v: torch.Tensor) -> torch.Tensor:
    return v * rsqrt64(dot3(v, v))[..., None]
