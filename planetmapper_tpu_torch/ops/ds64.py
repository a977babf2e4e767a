"""
Native-float64 backend for the :mod:`.ds` double-single call surface (port
of ``planetmapper_tpu.ops.ds64``).

Double-single (hi, lo) float32 pairs exist because the TPU has no hardware
float64. The H100 and the CPU have it, so this module gives the same call
surface over native float64: a "ds value" is ``(x_float64, zero_float32)``,
the hi word holding the whole float64 value and the lo word identically
zero. Every :mod:`.ds` invariant holds trivially (|lo| <= ulp(hi)/2), the
precision is 2^-53 against double-single's ~2^-49, and code written against
the ds API runs unchanged. :func:`planetmapper_tpu_torch.pipeline.pick_ds`
chooses it on every device of the port.
"""

from __future__ import annotations

import torch

F32 = torch.float32
F64 = torch.float64


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape, dtype=F32, device=x.device)


def const(x: float, device=None):
    """Python float -> ds constant (0-dim tensors on ``device``)."""
    return (torch.tensor(x, dtype=F64, device=device),
            torch.tensor(0.0, dtype=F32, device=device))


def from_f32(x: torch.Tensor):
    return x.to(F64), _zero(x)


def from_f64(x: torch.Tensor):
    """float64 tensor -> ds value (identity on the hi word)."""
    return x, _zero(x)


def to_f64(d) -> torch.Tensor:
    return d[0].to(F64)


def hi(d) -> torch.Tensor:
    """float32 value of a ds pair (one rounding of the exact float64 value)."""
    return d[0].to(F32)


def neg(a):
    return -a[0], a[1]


def add(a, b):
    s = a[0] + b[0]
    return s, _zero(s)


def sub(a, b):
    s = a[0] - b[0]
    return s, _zero(s)


def add_f(a, b):
    """ds + float32."""
    s = a[0] + b.to(F64)
    return s, _zero(s)


def sub_f(a, b):
    return add_f(a, -b)


def mul(a, b):
    p = a[0] * b[0]
    return p, _zero(p)


def mul_f(a, b):
    p = a[0] * b.to(F64)
    return p, _zero(p)


def recip(a):
    return torch.reciprocal(a[0]), _zero(a[0])


def div(a, b):
    return a[0] / b[0], _zero(a[0])


def rsqrt(a):
    """1/sqrt in float64: a square root and a division, both correctly
    rounded on the CPU and on the card (``torch.rsqrt`` on a CUDA tensor
    need not be)."""
    x = a[0].to(F64)
    return torch.reciprocal(torch.sqrt(x)), _zero(a[0])


def sqrt(a):
    """sqrt with the ds convention: 0 -> 0, negative/NaN -> NaN."""
    return torch.sqrt(a[0]), _zero(a[0])


def dot3(ax, ay, az, bx, by, bz):
    return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz))


def matvec3(m, vx, vy, vz):
    """(3, 3) ds matrix (nested tuples) @ ds 3-vector -> 3 ds components."""
    return tuple(
        add(add(mul(m[i][0], vx), mul(m[i][1], vy)), mul(m[i][2], vz))
        for i in range(3)
    )
