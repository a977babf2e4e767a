"""
One axis pass of the 'smooth' mode's PCHIP oversampling
(``csrc/pchip.cu``), its wrapper and its plain PyTorch version.

The port's own kernel for what the JAX package computes in XLA in front of
its TPU 'smooth' sampler (``planetmapper_tpu/ops/pchip_device.py:
_pchip_axis``, run on box rows, then on the columns of the result); the
source note in the ``.cu`` file says what bounds it and how it is laid out.

:func:`pchip_axis` interpolates every line of a ``(F, A, B)`` float64
stack along one axis (``-1``: the rows, ``-2``: the columns) over its
finite cells, scipy's ``PchipInterpolator(extrapolate=False)`` line by
line, and evaluates it at ``linspace(0, n - 1, n_eval)``. It launches the
kernel once for CUDA tensors, whatever the frame count, and counts the
launch; a build or launch fault raises. Only CPU tensors take
:func:`pchip_axis_plain`. The launch's plan is the wrapper's: a block's
lines (:func:`lines_per_block`); it stages a long line in chunks of
:data:`BLOCK_CELLS` over its lines.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _configure(lib) -> None:
    lib.pchip_axis_launch.restype = _I
    lib.pchip_axis_launch.argtypes = [
        _P, _L, _L, _L, _P, _P, _L, _L, _L, _I, _L, _I, _I, _I, _I, _P,
    ]
    lib.pchip_occupancy.restype = _I
    lib.pchip_occupancy.argtypes = [ctypes.POINTER(_I)] * 3
    lib.pchip_layout.restype = None
    lib.pchip_layout.argtypes = [ctypes.POINTER(_I)] * 3
    layout = [_I() for _ in range(3)]
    lib.pchip_layout(*layout)
    if tuple(v.value for v in layout) != (THREADS, BLOCK_CELLS,
                                          ADJACENT_LINES):
        raise RuntimeError('pchip.cu and its wrapper differ in the layout: '
                           f'{[v.value for v in layout]}')


# -fmad=false: the kernel rounds each product as the plain version does
LIBRARY = CudaLibrary('pchip', 'pchip.cu', _configure, flags=('-fmad=false',))
load_library = LIBRARY.load
launch_count = LIBRARY.launch_count
reset_launch_count = LIBRARY.reset_launch_count
ptxas_log = LIBRARY.ptxas_log


#: Threads of a block (``kThreads`` of the source).
THREADS = 256
#: Cells a block stages at once, over all its lines (``kCells``).
BLOCK_CELLS = 1024
#: Lines a block takes when they are adjacent in memory (``kAdjacentLines``).
ADJACENT_LINES = 4


def occupancy() -> dict[str, int]:
    """``dict(registers, local_bytes, blocks_per_sm)`` of the compiled
    kernel's column-pass instance (:data:`ADJACENT_LINES` lines a block) on
    the current CUDA device (blocks of :data:`THREADS`)."""
    lib = load_library()
    values = [_I() for _ in range(3)]
    check_launch(lib.pchip_occupancy(*values), 'PCHIP occupancy')
    return dict(zip(('registers', 'local_bytes', 'blocks_per_sm'),
                    (v.value for v in values)))


def _edge_derivative(h0, d0, h1, d1):
    """scipy PchipInterpolator._edge_case: one-sided three-point estimate
    with the Fritsch-Carlson monotonicity clamps."""
    d = ((2.0 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
    sign_flip = torch.sign(d) != torch.sign(d0)
    over = (torch.sign(d0) != torch.sign(d1)) & (
        torch.abs(d) > 3.0 * torch.abs(d0)
    )
    d = torch.where(sign_flip, 0.0, d)
    return torch.where(over, 3.0 * d0, d)


def _shift(a: torch.Tensor, offset: int, fill) -> torch.Tensor:
    """Shift along the last axis by ``offset`` (+1 = towards higher index)."""
    edge = torch.full_like(a[..., :1], fill)
    if offset > 0:
        return torch.cat([edge, a[..., :-1]], dim=-1)
    return torch.cat([a[..., 1:], edge], dim=-1)


def _pchip_axis(values: torch.Tensor, n_eval: int, k_rep: int):
    """
    PCHIP each row of ``values`` (..., n) over its finite cells and evaluate
    on ``linspace(0, n-1, n_eval)`` (whose step is ``1/k_rep`` of a cell;
    ``n_eval == (n-1)*k_rep + 1``). Rows with fewer than two finite cells
    evaluate to NaN (scipy behaviour), as do positions outside a row's
    finite span (``extrapolate=False``).

    The data-dependent part (each row interpolates over its finite cells
    only, NaN gaps bridged by irregular-spacing monotone cubics) uses
    running max/min of indices for the nearest finite neighbours and
    gathers, where the JAX package used associative scans and static
    repeats.
    """
    n = values.shape[-1]
    device = values.device
    ar = torch.arange(n, device=device).expand(values.shape)
    idx = ar.to(values.dtype)
    finite = torch.isfinite(values)
    v = torch.where(finite, values, 0.0)

    def take(a, i):
        return torch.gather(a, -1, i.clamp(0, n - 1))

    # nearest finite cell at-or-before (f) / at-or-after (b) each cell
    f_i = torch.where(finite, ar, -1).cummax(dim=-1).values
    b_i = torch.where(finite, ar, n).flip(-1).cummin(dim=-1).values.flip(-1)
    # strictly before (p) / strictly after (q)
    p_i = _shift(f_i, 1, -1)
    q_i = _shift(b_i, -1, n)
    pv = p_i >= 0
    nv = q_i < n

    h_prev = torch.where(pv, idx - take(idx, p_i), 1.0)
    d_prev = torch.where(pv, (v - take(v, p_i)) / h_prev, 0.0)
    h_next = torch.where(nv, take(idx, q_i) - idx, 1.0)
    d_next = torch.where(nv, (take(v, q_i) - v) / h_next, 0.0)

    # second-interval data for the one-sided edge stencils: the (h, d) of
    # the neighbouring finite cell's outward interval
    nn_has = nv & take(nv, q_i)
    nn_h = torch.where(nn_has, take(h_next, q_i), h_next)
    nn_d = torch.where(nn_has, take(d_next, q_i), d_next)
    pp_has = pv & take(pv, p_i)
    pp_h = torch.where(pp_has, take(h_prev, p_i), h_prev)
    pp_d = torch.where(pp_has, take(d_prev, p_i), d_prev)

    # Fritsch-Carlson interior derivative (scipy _find_derivatives):
    # weighted harmonic mean where slopes share a sign, else 0
    w1 = 2.0 * h_next + h_prev
    w2 = h_next + 2.0 * h_prev
    same_sign = (d_prev * d_next) > 0.0
    denom = torch.where(
        same_sign,
        w1 / torch.where(d_prev == 0, 1.0, d_prev)
        + w2 / torch.where(d_next == 0, 1.0, d_next),
        1.0,
    )
    d_interior = torch.where(same_sign, (w1 + w2) / denom, 0.0)
    d_first = _edge_derivative(h_next, d_next, nn_h, nn_d)
    d_last = _edge_derivative(h_prev, d_prev, pp_h, pp_d)
    deriv = torch.where(
        pv & nv, d_interior,
        torch.where(nv, d_first, torch.where(pv, d_last, 0.0)),
    )

    # each evaluation position e lies in cell floor(e / k_rep) and
    # ceil(e / k_rep); its segment runs from the nearest finite cell
    # at-or-before the first to the nearest at-or-after the second
    e = torch.arange(n_eval, device=device)
    batch = values.shape[:-1] + (n_eval,)
    lo = f_i.gather(-1, (e // k_rep).expand(batch))
    hi = b_i.gather(-1, ((e + k_rep - 1) // k_rep).expand(batch))
    ok = (lo >= 0) & (hi < n)
    xl, fl, dl = take(idx, lo), take(v, lo), take(deriv, lo)
    xr, fr, dr = take(idx, hi), take(v, hi), take(deriv, hi)

    xs = torch.linspace(0.0, float(n - 1), n_eval, dtype=values.dtype,
                        device=device)
    h = xr - xl
    degenerate = h == 0.0
    h_safe = torch.where(degenerate, 1.0, h)
    t = (xs - xl) / h_safe
    t2 = t * t
    t3 = t2 * t
    hermite = (
        fl * (2.0 * t3 - 3.0 * t2 + 1.0)
        + h_safe * dl * (t3 - 2.0 * t2 + t)
        + fr * (-2.0 * t3 + 3.0 * t2)
        + h_safe * dr * (t3 - t2)
    )
    result = torch.where(degenerate, fl, hermite)
    result = torch.where(ok, result, torch.nan)
    # scipy skips rows with < 2 finite points entirely
    enough = finite.sum(dim=-1, keepdim=True) >= 2
    return torch.where(enough, result, torch.nan)


def pchip_axis_plain(values: torch.Tensor, n_eval: int, k_rep: int,
                     axis: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (see :func:`pchip_axis`)."""
    if axis == -1:
        return _pchip_axis(values, n_eval, k_rep)
    return _pchip_axis(values.transpose(-1, -2), n_eval, k_rep
                       ).transpose(-1, -2)


def _check(values: torch.Tensor, n_eval: int, k_rep: int, axis: int) -> None:
    if values.dtype != torch.float64 or values.ndim != 3:
        raise TypeError('values must be (F, A, B) float64, got '
                        f'{tuple(values.shape)} {values.dtype}')
    if axis not in (-1, -2):
        raise ValueError(f'axis must be -1 or -2, got {axis}')
    n = values.shape[axis]
    if n < 1 or k_rep < 1 or n_eval != (n - 1) * k_rep + 1:
        raise ValueError(f'n_eval={n_eval} is not ({n} - 1) * {k_rep} + 1')


def pchip_axis(values: torch.Tensor, n_eval: int, k_rep: int,
               axis: int) -> torch.Tensor:
    """
    PCHIP along ``axis`` (``-1`` or ``-2``) of ``values`` (F, A, B) float64,
    any strides (the image box is read in place), NaN and inf as missing
    cells: each line evaluated at ``linspace(0, n - 1, n_eval)``, ``n_eval
    == (n - 1) * k_rep + 1``. Returns the ``(F, A, n_eval)`` or ``(F,
    n_eval, B)`` float64 result.
    """
    _check(values, n_eval, k_rep, axis)
    device = values.device
    if device.type == 'cpu':
        return pchip_axis_plain(values, n_eval, k_rep, axis)
    if device.type != 'cuda':
        raise ValueError(f'no PCHIP kernel for device {device}')
    shape = list(values.shape)
    shape[axis] = n_eval
    out = torch.empty(shape, dtype=torch.float64, device=device)
    # the positions the plain version makes, by the same call on the same
    # device (torch.linspace is not i / k_rep in float64)
    xs = torch.linspace(0.0, float(values.shape[axis] - 1), n_eval,
                        dtype=torch.float64, device=device)
    launch(values, xs, out, k_rep=k_rep, axis=axis)
    return out


def lines_per_block(line_stride: int) -> int:
    """A block's lines: :data:`ADJACENT_LINES` when lines are adjacent in
    memory (the columns of a row-major grid: each cell's load and each
    position's store is one 32-byte sector of the block's lines), else 1."""
    return ADJACENT_LINES if line_stride == 1 else 1


def launch(values, xs, out, *, k_rep: int, axis: int) -> None:
    """
    Launch the kernel on CUDA buffers (``values`` at any strides, ``xs``
    and ``out`` as :func:`pchip_axis` makes them) on the current stream,
    and count the launch.
    """
    if any(t.device.type != 'cuda' or t.dtype != torch.float64
           for t in (values, xs, out)):
        raise ValueError('the PCHIP kernel takes float64 CUDA tensors')
    if not xs.is_contiguous():
        raise ValueError('xs must be contiguous')
    line_dim, cell_dim = (1, 2) if axis == -1 else (2, 1)
    n_frames, lines, n = (values.shape[0], values.shape[line_dim],
                          values.shape[cell_dim])
    n_eval = xs.numel()
    if out.shape[0] != n_frames or out.shape[line_dim] != lines or \
            out.shape[cell_dim] != n_eval:
        raise ValueError(f'out {tuple(out.shape)} does not fit values '
                         f'{tuple(values.shape)} and {n_eval} positions')
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.pchip_axis_launch(
            values.data_ptr(), values.stride(0), values.stride(line_dim),
            values.stride(cell_dim), xs.data_ptr(), out.data_ptr(),
            out.stride(0), out.stride(line_dim), out.stride(cell_dim),
            n_frames, lines, n, n_eval, k_rep,
            lines_per_block(values.stride(line_dim)), stream,
        )
    check_launch(rc, 'PCHIP')
    LIBRARY.count_launches()
