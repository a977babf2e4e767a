"""
The map spline evaluator (``csrc/map_spline.cu``), its wrapper and its plain
PyTorch version.

Replaces the TPU kernels ``planetmapper_tpu/ops/map_pallas.py:
_pallas_eval_fn`` (sources up to 640 px) and ``_pallas_eval_windowed_fn``
(larger sources) with one hand-written kernel for Hopper; the source note
in the ``.cu`` file says what bounds it and how it is laid out.

:func:`map_spline` evaluates a bivariate B-spline of degrees ``(ky, kx)``
(1..5 each; FITPACK knots ``ty``, ``tx``; float64 coefficients ``(F, n_cy,
n_cx)``) at the map samples and applies the 4-neighbour NaN rule of
``map_img``. It launches the kernel for CUDA tensors and counts the
launch; a build or launch fault raises. Only CPU tensors take
:func:`map_spline_plain`. Knots described by :func:`uniform_knots` (the
FITPACK s=0 knots of a pixel grid) let the kernel find intervals by
arithmetic and use the cardinal basis; other knots take its binary search.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .cuda_build import CudaLibrary, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int


class _Axis(ctypes.Structure):
    """``MapSplineAxis`` of ``map_spline.cu``: one spline axis."""

    _fields_ = [('origin', ctypes.c_double), ('uniform', _I), ('lo', _I),
                ('hi', _I), ('staged', _I)]


#: Shared memory the wrapper lets both axes' knots take when the kernel
#: searches them; larger knot vectors are read from global memory.
KNOT_STAGE_BYTES = 40 * 1024


def _configure(lib) -> None:
    lib.map_spline_launch.restype = _I
    lib.map_spline_launch.argtypes = [
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P,
        ctypes.c_longlong, _I, ctypes.POINTER(_Axis), ctypes.POINTER(_Axis),
        _P,
    ]
    lib.map_spline_occupancy.restype = _I
    lib.map_spline_occupancy.argtypes = [
        _I, _I, _I, *[ctypes.POINTER(_I)] * 3]


LIBRARY = CudaLibrary('map_spline', 'map_spline.cu', _configure)
load_library = LIBRARY.load
launch_count = LIBRARY.launch_count
reset_launch_count = LIBRARY.reset_launch_count
ptxas_log = LIBRARY.ptxas_log

#: Spline degrees the kernel is compiled for (kx, ky each).
KERNEL_DEGREES = (1, 2, 3, 4, 5)


@dataclass(frozen=True)
class UniformKnots:
    """
    One axis's knots as the kernel's arithmetic path takes them: ``t[j] ==
    origin + j`` exactly on every interior knot, and ``[lo, hi]`` the
    intervals whose 2k supporting knots all obey it (cardinal basis there).
    """

    origin: float
    lo: int
    hi: int


def uniform_knots(t, k: int) -> UniformKnots | None:
    """
    :class:`UniformKnots` of the host knot vector ``t`` of degree ``k``, or
    None when its interior is empty or not spaced exactly 1 (the kernel
    then searches). The FITPACK s=0 knots of a pixel grid always qualify.
    """
    t = np.asarray(t, dtype=np.float64)
    n_t = t.shape[0]
    n_c = n_t - k - 1
    if n_c <= k + 1:
        return None
    origin = float(t[k + 1]) - (k + 1)
    on = t == origin + np.arange(n_t)
    if not on[k + 1:n_c].all():
        return None
    # interval i is uniform when t[i-k+1 .. i+k] are all on the line
    off = np.concatenate([[0], np.cumsum(~on)])
    i = np.arange(k, n_c)
    uniform = i[off[i + k + 1] == off[i - k + 1]]
    lo, hi = (int(uniform[0]), int(uniform[-1])) if uniform.size else (
        n_c, n_c - 1)
    return UniformKnots(origin, lo, hi)


def launch_plan(n_ty: int, n_tx: int, uniform=None):
    """
    ``(axis_y, axis_x, shared_bytes)``: the kernel's two axis descriptors
    for knot counts ``n_ty``, ``n_tx`` and ``uniform`` (a pair of
    :class:`UniformKnots` or None, or None), and the dynamic shared memory
    of the launch (the staged knots).
    """
    described = uniform if uniform is not None else (None, None)
    # searched knots are staged in shared memory; described ones are not
    # (the arithmetic path reads only a few end knots)
    axes = [_Axis(0.0, 0, 0, -1, 1) if u is None else
            _Axis(u.origin, 1, u.lo, u.hi, 0) for u in described]
    knots = sum(n for n, a in zip((n_ty, n_tx), axes) if a.staged)
    if 8 * knots > KNOT_STAGE_BYTES:
        for a in axes:
            a.staged = 0
        knots = 0
    return axes[0], axes[1], 8 * knots


def occupancy(kx: int, ky: int, shared_bytes: int = 0) -> dict[str, int]:
    """
    ``dict(registers, local_bytes, blocks_per_sm)`` of the ``<kx, ky>``
    instance on the current CUDA device: registers and local (spill) bytes
    per thread, and resident blocks of 256 threads per SM at
    ``shared_bytes`` of dynamic shared memory.
    """
    lib = load_library()
    values = [_I() for _ in range(3)]
    check_launch(lib.map_spline_occupancy(kx, ky, shared_bytes, *values),
                 'map spline occupancy')
    return dict(zip(('registers', 'local_bytes', 'blocks_per_sm'),
                    (v.value for v in values)))


def _basis(t: torch.Tensor, k: int, u: torch.Tensor):
    """
    The k+1 non-zero de Boor-Cox basis values at ``u`` (clamped into the
    knot span) and the index of the first coefficient they weight.
    """
    n_t = t.shape[0]
    n_c = n_t - k - 1
    u = torch.minimum(torch.maximum(u, t[k]), t[n_t - k - 1])
    i = (torch.searchsorted(t, u, right=True) - 1).clamp(k, n_c - 1)
    n = [torch.ones_like(u)]
    for d in range(1, k + 1):
        terms = []
        for j in range(d):
            left = t[i + 1 - d + j]
            denom = t[i + 1 + j] - left
            denom = torch.where(denom == 0.0, 1.0, denom)
            terms.append((u - left) / denom)
        new = [n[0] * (1.0 - terms[0])]
        for j in range(1, d):
            new.append(n[j - 1] * terms[j - 1] + n[j] * (1.0 - terms[j]))
        new.append(n[d - 1] * terms[d - 1])
        n = new
    return n, i - k


def neighbour_nan(x, y, nan_grid: torch.Tensor) -> torch.Tensor:
    """
    ``(F, S)`` bool: a NaN among the floor/ceil 4 neighbours of each sample
    (indices clipped to the grid) in each frame of ``nan_grid`` (F, ny, nx).
    """
    ny, nx = nan_grid.shape[-2:]
    x0 = torch.floor(x).long().clamp(0, nx - 1)
    x1 = torch.ceil(x).long().clamp(0, nx - 1)
    y0 = torch.floor(y).long().clamp(0, ny - 1)
    y1 = torch.ceil(y).long().clamp(0, ny - 1)
    g = nan_grid.reshape(nan_grid.shape[0], -1).bool()
    return (
        g[:, y0 * nx + x0] | g[:, y0 * nx + x1]
        | g[:, y1 * nx + x0] | g[:, y1 * nx + x1]
    )


def outside_grid(x, y, ny: int, nx: int) -> torch.Tensor:
    """Samples outside the grid of pixel centres (unclamped coordinates)."""
    return (x < 0.0) | (y < 0.0) | (x > nx - 1) | (y > ny - 1)


def map_spline_plain(x, y, valid, ty, tx, coeffs, nan_grid, *, kx: int,
                     ky: int, propagate_nan: bool,
                     uniform=None) -> torch.Tensor:
    """
    The kernel's function in plain PyTorch (float64, stored float32);
    ``uniform`` is accepted for the kernel's signature and not read.
    """
    n_frames, _, n_cx = coeffs.shape
    by, iy0 = _basis(ty, ky, y)
    bx, ix0 = _basis(tx, kx, x)
    flat = coeffs.reshape(n_frames, -1)
    val = torch.zeros((n_frames, x.shape[0]), dtype=torch.float64,
                      device=x.device)
    for a in range(ky + 1):
        row = torch.zeros_like(val)
        for b in range(kx + 1):
            row = row + bx[b] * flat[:, (iy0 + a) * n_cx + ix0 + b]
        val = val + by[a] * row
    dead = ~valid.bool()
    if propagate_nan:
        ny, nx = nan_grid.shape[-2:]
        dead = dead | outside_grid(x, y, ny, nx)
        dead = dead[None] | neighbour_nan(x, y, nan_grid)
    return torch.where(dead, torch.nan, val).to(torch.float32)


def _check(x, y, valid, ty, tx, coeffs, nan_grid, kx, ky):
    device = x.device
    for name, t in dict(x=x, y=y, valid=valid, ty=ty, tx=tx, coeffs=coeffs,
                        nan_grid=nan_grid).items():
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, x on {device}')
    for name, t in dict(x=x, y=y, ty=ty, tx=tx, coeffs=coeffs).items():
        if t.dtype != torch.float64:
            raise TypeError(f'{name} must be float64, got {t.dtype}')
    if x.ndim != 1 or y.shape != x.shape or valid.shape != x.shape:
        raise ValueError('x, y and valid must be 1-D of one length')
    n_cy = ty.shape[0] - ky - 1
    n_cx = tx.shape[0] - kx - 1
    if coeffs.ndim != 3 or tuple(coeffs.shape[1:]) != (n_cy, n_cx):
        raise ValueError(
            f'coeffs must be (F, {n_cy}, {n_cx}) for {ty.shape[0]} and '
            f'{tx.shape[0]} knots of degrees ({ky}, {kx}), got '
            f'{tuple(coeffs.shape)}'
        )
    if nan_grid.ndim != 3 or nan_grid.shape[0] != coeffs.shape[0]:
        raise ValueError('nan_grid must be (F, ny, nx) with F as coeffs')
    return device


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy if need be)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def map_spline(x, y, valid, ty, tx, coeffs, nan_grid, *, kx: int, ky: int,
               propagate_nan: bool, uniform=None) -> torch.Tensor:
    """
    ``(F, S)`` float32 spline values at the samples ``x``, ``y`` (float64,
    0 where ``valid`` is false) of each frame's coefficients, NaN where the
    sample is not valid or, with ``propagate_nan``, outside the source grid
    or next to one of its NaN pixels (``nan_grid`` (F, ny, nx), bool).

    ``uniform``: ``(y, x)`` :class:`UniformKnots` (either may be None) of
    ``ty`` and ``tx``, from :func:`uniform_knots` on a host copy of the same
    knots; the kernel trusts it (nothing on the card checks it). None: the
    kernel searches the knots.
    """
    device = _check(x, y, valid, ty, tx, coeffs, nan_grid, kx, ky)
    if device.type == 'cpu':
        return map_spline_plain(x, y, valid, ty, tx, coeffs, nan_grid,
                                kx=kx, ky=ky, propagate_nan=propagate_nan)
    if device.type != 'cuda':
        raise ValueError(f'no map spline kernel for device {device}')
    out = torch.empty((coeffs.shape[0], x.shape[0]), dtype=torch.float32,
                      device=device)
    nan_u8 = nan_grid.to(torch.uint8).contiguous()
    launch(
        _aligned(x), _aligned(y), valid.to(torch.uint8).contiguous(),
        ty.contiguous(), tx.contiguous(), coeffs.contiguous(), nan_u8,
        nan_u8.reshape(nan_u8.shape[0], -1).any(dim=1).to(torch.uint8),
        out, kx=kx, ky=ky, propagate_nan=propagate_nan, uniform=uniform,
    )
    return out


def launch(x, y, valid, ty, tx, coeffs, nan_grid, any_nan, out, *,
           kx: int, ky: int, propagate_nan: bool, uniform=None) -> None:
    """
    Launch the kernel on prepared contiguous CUDA buffers (``x`` and ``y``
    16-byte aligned, ``valid``, ``nan_grid`` and the per-frame ``any_nan``
    as uint8, ``out`` (F, S) float32) on the current stream, and count the
    launch. ``uniform`` as for :func:`map_spline`.
    """
    if kx not in KERNEL_DEGREES or ky not in KERNEL_DEGREES:
        raise ValueError(
            f'the map spline kernel takes degrees {KERNEL_DEGREES[0]}..'
            f'{KERNEL_DEGREES[-1]}, got ({ky}, {kx})'
        )
    buffers = (x, y, valid, ty, tx, coeffs, nan_grid, any_nan, out)
    if any(t.device.type != 'cuda' or not t.is_contiguous() for t in buffers):
        raise ValueError('the map spline kernel takes contiguous CUDA tensors')
    if any(t.dtype != torch.uint8 for t in (valid, nan_grid, any_nan)):
        raise TypeError('valid, nan_grid and any_nan must be uint8')
    if x.data_ptr() % 16 or y.data_ptr() % 16 or out.data_ptr() % 8:
        raise ValueError('x and y must be 16-byte aligned, out 8-byte')
    if coeffs[0].numel() >= 2**31 or nan_grid[0].numel() >= 2**31:
        raise ValueError('a frame of 2^31 or more coefficients or pixels')
    n_frames, n_samples = out.shape
    if out.dtype != torch.float32 or n_samples != x.shape[0]:
        raise ValueError('out must be (F, S) float32')
    if n_frames * n_samples == 0:
        return
    axis_y, axis_x, _ = launch_plan(ty.shape[0], tx.shape[0], uniform)
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.map_spline_launch(
            x.data_ptr(), y.data_ptr(), valid.data_ptr(),
            ty.data_ptr(), ty.shape[0], tx.data_ptr(), tx.shape[0],
            kx, ky, coeffs.data_ptr(), nan_grid.data_ptr(),
            any_nan.data_ptr(), nan_grid.shape[-2], nan_grid.shape[-1],
            int(propagate_nan), out.data_ptr(), n_samples, n_frames,
            ctypes.byref(axis_y), ctypes.byref(axis_x), stream,
        )
    check_launch(rc, 'map spline')
    LIBRARY.count_launches()
