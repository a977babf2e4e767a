"""
Least times ("bounds") of the port's kernels on one H100 SXM, counted from
the work of the function each kernel computes, not from the kernel's own
instructions. The counts are plain numbers; the map kernels' are taken
from one call's inputs (:func:`spline_call_bound`, :func:`smooth_call_bound`,
:func:`pchip_call_bound`, :func:`smooth_stage_bound`; tensors on any
device).

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate,
and its arithmetic over the card's peak rate for the type it may run in.

Operation convention: +, -, x, /, sqrt and a compare count 1 each; a fused
multiply-add counts 2 (one multiply, one add); sin, cos, atan2, asin and
acos count :data:`TRANSCENDENTAL_OPS` each; selects (``where``), negation
and copies count 0.
"""

from __future__ import annotations

import torch

from ..ops.map_spline_kernel import _basis, neighbour_nan, outside_grid
from ..ops.pchip_kernel import _pchip_axis

#: H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bandwidth, and FP64 and
#: FP32 outside the tensor cores, where scalar arithmetic runs.
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
FP32_FLOP_PER_S = 67e12

#: Operations counted for one sin, cos, atan2, asin or acos: a polynomial
#: of degree ~9 in Horner form (9 multiply-adds) plus its range reduction.
TRANSCENDENTAL_OPS = 20


def roofline_ms(n_bytes: float, f64_ops: float = 0.0,
                f32_ops: float = 0.0) -> tuple[float, str]:
    """
    ``(ms, 'bytes' or 'operations')``: the larger of the bytes over the HBM
    rate and the operations over their peak rates (float32 and float64
    work added, as if the two pipes never overlapped).
    """
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f64_ops / FP64_FLOP_PER_S + f32_ops / FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


# ---------------------------------------------------------------------------
# backplanes26: the 26 planes of pipeline.fused_backplanes_fn
# ---------------------------------------------------------------------------
#
# The function is that of the plain float64 graph (pipeline.fused_backplanes_fn,
# the fixed reference of every design of the kernel), for a biaxial body
# with optimize_speed and ``n_lt_iters + 1`` intercept evaluations (the
# kernel's contract; the plain graph runs 4). Each step is counted at the
# least work known to compute its outputs at the bars, whichever of the
# plain graph's form and the kernel's is cheaper: the graph's dead values
# (the unused altitude of the surface conversion, the untaken branch of
# vsep) are left out; the ray's sin/cos come from per-column and per-row
# values by angle addition (its two angles are affine in x and y); the
# graphic latitudes and RING-RADIUS take the trig-free Bowring form; the
# illumination angles take atan2(|a x b|, a.b); values that depend on the
# scene alone are folded on the host. rsqrt counts 2 (a root and a
# division). Each step is (ops, transcendentals, float32): float32 marks
# what the kernel may finish in float32 at the kernel table's 1e-4 deg (the
# atan2 of float64 arguments and what follows it, for LAT-GRAPHIC,
# LAT-CENTRIC, RA, DEC, PHASE, INCIDENCE, EMISSION, AZIMUTH,
# LIMB-LON/LAT-GRAPHIC and RING-LON-GRAPHIC); everything else is float64.

#: Work of every pixel of the frame.
BACKPLANE_EVERY_PIXEL = {
    'ray: angle addition of the column and row sin/cos, unit ray': (
        14, 0, False),
    'ray to J2000 (3x3 product)': (15, 0, False),
    'RA/Dec: rho': (4, 0, False),
    'RA/Dec: atan2 x2, wrap, degrees': (4, 2, True),
    'KM-X/Y, ANGULAR-X/Y (affine in x, y)': (16, 0, False),
    'r_cut gate': (6, 0, False),
    'limb: nearest point on the ray': (26, 0, False),
    'limb: obsvec to targvec (rotation at its epoch)': (71, 0, False),
    'limb: radial surface point, LIMB-DISTANCE': (20, 0, False),
    'limb: lon': (4, 1, True),
    'limb: rho': (4, 0, False),
    'limb: graphic lat, trig-free Bowring form': (16, 0, False),
    'limb: graphic lat, atan2, degrees': (1, 1, True),
    'ring: plane intercept': (22, 0, False),
    'ring: obsvec to targvec': (71, 0, False),
    'ring: RING-RADIUS (rho, trig-free exterior Bowring, 3 steps)': (
        87, 0, False),
    'ring: lon': (4, 1, True),
    'ring: RING-DISTANCE, occlusion': (7, 0, False),
}

#: Work of each column and each row of the frame: the ray angles' column
#: and row parts (ra and dec) and their sin and cos.
BACKPLANE_PER_COLUMN = {'ray: column angles, sin/cos': (2, 4, False)}
BACKPLANE_PER_ROW = {'ray: row angles, sin/cos': (4, 4, False)}

#: Work of one intercept evaluation of the light-time loop: epoch, target
#: position, rotation, two 3x3 products, recentred intercept, light time.
BACKPLANE_INTERCEPT_OPS = 112
#: The last evaluation also forms the surface point.
BACKPLANE_SURFACE_POINT_OPS = 6

#: Work of the on-disc chain after the light-time loop, per on-disc pixel.
BACKPLANE_ON_DISC = {
    'final epoch': (2, 0, False),
    'lon_e (feeds LST), LON-GRAPHIC, LON-CENTRIC': (7, 1, False),
    'graphic lat: rho': (4, 0, False),
    'graphic lat, trig-free Bowring form': (16, 0, False),
    'graphic lat, atan2, degrees': (1, 1, True),
    'LAT-CENTRIC: atan2(z, rho), degrees': (1, 1, True),
    'illumination vectors, sun, normal': (125, 0, False),
    'PHASE, INCIDENCE, EMISSION: |a x b| and a.b': (60, 0, False),
    'PHASE, INCIDENCE, EMISSION: atan2, degrees': (3, 3, True),
    'AZIMUTH: tangent-plane projections (dots shared), |a x b|, a.b': (
        32, 0, False),
    'AZIMUTH: atan2, degrees': (2, 1, True),
    'LOCAL-SOLAR-TIME': (10, 0, False),
    'DISTANCE, RADIAL-VELOCITY, DOPPLER': (76, 0, False),
}


def _ops(steps: dict) -> tuple[int, int]:
    f64 = f32 = 0
    for ops, transcendentals, single in steps.values():
        total = ops + transcendentals * TRANSCENDENTAL_OPS
        if single:
            f32 += total
        else:
            f64 += total
    return f64, f32


def backplane_ops(n_lt_iters: int = 2) -> dict[str, tuple[int, int]]:
    """
    ``(f64, f32)`` operations of each kind of work: ``'every'`` pixel,
    what an ``'on_disc'`` pixel adds (its light-time loop included), and
    each ``'column'`` and ``'row'`` of the frame.
    """
    f64, f32 = _ops(BACKPLANE_ON_DISC)
    f64 += (n_lt_iters + 1) * BACKPLANE_INTERCEPT_OPS \
        + BACKPLANE_SURFACE_POINT_OPS
    return {'every': _ops(BACKPLANE_EVERY_PIXEL), 'on_disc': (f64, f32),
            'column': _ops(BACKPLANE_PER_COLUMN),
            'row': _ops(BACKPLANE_PER_ROW)}


#: Bytes the 26 planes take per pixel: 25 float32 planes and
#: RADIAL-VELOCITY in float64, the contract's types.
BACKPLANE_BYTES_PER_PIXEL = 25 * 4 + 8


def backplane_bound(nx: int, ny: int, n_disc: int, *,
                    n_lt_iters: int = 2) -> dict:
    """
    The bound of one backplanes26 launch over an ``nx`` x ``ny`` frame with
    ``n_disc`` on-disc pixels (finite EMISSION): ``dict(ms, bound_by,
    bytes, f64_ops, f32_ops)``. Off-disc pixels are counted without the
    intercept chain (those inside the r_cut circle that miss the disc
    still run it in every design, so the bound stays a lower bound); the
    bytes are the stores of the 26 planes (the scene is a kilobyte).
    """
    if not 0 <= n_disc <= nx * ny:
        raise ValueError(f'n_disc={n_disc} outside [0, {nx * ny}]')
    ops = backplane_ops(n_lt_iters)
    counts = dict(every=nx * ny, on_disc=n_disc, column=nx, row=ny)
    f64 = sum(ops[k][0] * n for k, n in counts.items())
    f32 = sum(ops[k][1] * n for k, n in counts.items())
    n_bytes = BACKPLANE_BYTES_PER_PIXEL * nx * ny
    ms, by = roofline_ms(n_bytes, f64, f32)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f64_ops=f64, f32_ops=f32)


#: Bytes of one frame's packed scene, which the batched kernel reads from
#: device memory (106 float64 values).
BACKPLANE_SCENE_BYTES = 106 * 8


def backplane_batch_bound(nx: int, ny: int, n_discs, *,
                          n_lt_iters: int = 2) -> dict:
    """
    The bound of one batched backplanes26 launch over ``len(n_discs)``
    frames of ``nx`` x ``ny`` with ``n_discs[i]`` on-disc pixels in frame
    ``i``: :func:`backplane_bound`'s work of every frame, and its stores,
    plus the frames' scenes read once from device memory. ``dict(ms,
    bound_by, bytes, f64_ops, f32_ops, frames)``.
    """
    n_discs = [int(n) for n in n_discs]
    if not n_discs:
        raise ValueError('a batch has at least one frame')
    frames = [backplane_bound(nx, ny, n, n_lt_iters=n_lt_iters)
              for n in n_discs]
    f64 = sum(f['f64_ops'] for f in frames)
    f32 = sum(f['f32_ops'] for f in frames)
    n_bytes = sum(f['bytes'] for f in frames) \
        + BACKPLANE_SCENE_BYTES * len(n_discs)
    ms, by = roofline_ms(n_bytes, f64, f32)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f64_ops=f64, f32_ops=f32,
                frames=len(n_discs))


# ---------------------------------------------------------------------------
# map_spline and map_smooth: the map kernels of BodyXY.map_img
# ---------------------------------------------------------------------------
#
# Bytes: what the function must read, once, and its outputs, written once.
# A uint8 validity per sample, and float64 x and y only for the valid
# samples (the others map to NaN unread); float32 per sample and frame out;
# one uint8 any-NaN flag per frame; of the float64 coefficients (or
# oversampled grid values) and of the uint8 NaN grid of the source only
# the entries the samples touch (counted by the caller from the run's
# inputs); the float64 knots whole (a few KB). Dead samples cost only
# their bytes; the NaN rule's compares and selects are not counted.


def map_spline_axis_ops(k: int) -> int:
    """
    Operations of one axis of one live sample at the least known work, a
    uniform interval of the grid: the clamp into the knot span (2
    compares), the interval by arithmetic (subtract, floor, compare), the
    local coordinate (1), and the k+1 cardinal basis values as polynomials
    of degree k in Horner form with k! folded into the coefficients (k
    multiply-adds each).
    """
    return 6 + 2 * k * (k + 1)


def map_spline_frame_ops(kx: int, ky: int) -> int:
    """Operations of one live sample in one frame: the tensor-product sum."""
    return 2 * (ky + 1) * (kx + 2)


def map_sample_bytes(samples: int, valid_samples: int, frames: int) -> int:
    """
    Bytes of one map kernel launch besides its coefficients and NaN grid:
    the validity of every sample, x and y of the valid ones, every value
    out, the any-NaN flag of every frame.
    """
    return samples + 16 * valid_samples + 4 * frames * samples + frames


def map_spline_bound(*, samples: int, valid_samples: int, live_samples: int,
                     live_sample_frames: int, frames: int, coefficients: int,
                     grid_cells: int, knots: int, kx: int, ky: int) -> dict:
    """
    The bound of one map_spline launch: ``samples`` map samples of which
    ``valid_samples`` are valid, ``live_samples`` get a value in some frame
    and ``live_sample_frames`` values are computed over ``frames`` frames;
    ``coefficients`` float64 coefficients that the live values weight and
    ``grid_cells`` NaN-grid cells that the NaN rule reads, both summed over
    the frames; ``knots`` of both axes; degrees ``kx``, ``ky``.
    ``dict(ms, bound_by, bytes, f64_ops)``.
    """
    n_bytes = (map_sample_bytes(samples, valid_samples, frames)
               + 8 * coefficients + grid_cells + 8 * knots)
    ops = (live_samples * (map_spline_axis_ops(kx) + map_spline_axis_ops(ky))
           + live_sample_frames * map_spline_frame_ops(kx, ky))
    ms, by = roofline_ms(n_bytes, f64_ops=ops)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f64_ops=ops)


#: map_smooth: per live sample the two oversampled-grid coordinates and
#: their floors and fractions; per live sample and frame the bilinear sum.
MAP_SMOOTH_SAMPLE_OPS = 6
MAP_SMOOTH_FRAME_OPS = 11


def map_smooth_bound(*, samples: int, valid_samples: int, live_samples: int,
                     live_sample_frames: int, frames: int, grid_values: int,
                     image_cells: int) -> dict:
    """
    The bound of one map_smooth launch: counts as for
    :func:`map_spline_bound`, ``grid_values`` float64 values of the
    oversampled grids that the live values read and ``image_cells`` cells
    of the source's NaN grid that the NaN rule reads, both summed over the
    frames. ``dict(ms, bound_by, bytes, f64_ops)``.
    """
    n_bytes = (map_sample_bytes(samples, valid_samples, frames)
               + 8 * grid_values + image_cells)
    ops = (live_samples * MAP_SMOOTH_SAMPLE_OPS
           + live_sample_frames * MAP_SMOOTH_FRAME_OPS)
    ms, by = roofline_ms(n_bytes, f64_ops=ops)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f64_ops=ops)


def _map_call_counts(x, y, valid, nan_grid, propagate_nan, inside=None):
    """
    What the function of one map kernel call must read, from its inputs:
    ``(counts, live)``, with ``counts`` the keywords ``valid_samples``,
    ``live_samples``, ``live_sample_frames`` and ``grid_cells`` of the
    bounds (``grid_cells``: the NaN-grid cells that the NaN rule reads, the
    floor/ceil neighbours of the valid samples inside the grid, in the
    frames that hold a NaN), and ``live`` (F, S): the values computed.
    """
    n_frames = nan_grid.shape[0]
    checked = valid.bool() if inside is None else valid.bool() & inside
    counts = dict(valid_samples=int(valid.bool().sum()), grid_cells=0)
    live = checked[None].expand(n_frames, -1)
    if propagate_nan:
        ny, nx = nan_grid.shape[-2:]
        checked = checked & ~outside_grid(x, y, ny, nx)
        live = checked[None] & ~neighbour_nan(x, y, nan_grid)
        x0 = torch.floor(x).long().clamp(0, nx - 1)
        x1 = torch.ceil(x).long().clamp(0, nx - 1)
        y0 = torch.floor(y).long().clamp(0, ny - 1)
        y1 = torch.ceil(y).long().clamp(0, ny - 1)
        cells = torch.stack([y0 * nx + x0, y0 * nx + x1, y1 * nx + x0,
                             y1 * nx + x1])
        nan_frames = int(nan_grid.reshape(n_frames, -1).any(1).sum())
        counts['grid_cells'] = nan_frames * _distinct(cells, checked, ny * nx)
    counts['live_samples'] = int(live.any(dim=0).sum())
    counts['live_sample_frames'] = int(live.sum())
    return counts, live


def _distinct(indices, mask, size: int) -> int:
    """Distinct values (all below ``size``) of ``indices`` (n, S) at ``mask``."""
    hit = torch.zeros(size, dtype=torch.bool, device=indices.device)
    hit[indices[:, mask].reshape(-1)] = True
    return int(hit.sum())


def spline_call_bound(args, kw) -> dict:
    """
    :func:`map_spline_bound` of one ``map_spline(*args, **kw)`` call,
    counted from its inputs: the coefficients are those that each frame's
    live values weight.
    """
    x, y, valid, ty, tx, coeffs, nan_grid = args
    kx, ky = kw['kx'], kw['ky']
    counts, live = _map_call_counts(x, y, valid, nan_grid,
                                    kw['propagate_nan'])
    n_frames, n_cy, n_cx = coeffs.shape
    _, iy0 = _basis(ty, ky, y)
    _, ix0 = _basis(tx, kx, x)
    support = torch.stack([(iy0 + a) * n_cx + ix0 + b
                           for a in range(ky + 1) for b in range(kx + 1)])
    touched = sum(_distinct(support, live[f], n_cy * n_cx)
                  for f in range(n_frames))
    return map_spline_bound(
        samples=x.numel(), frames=n_frames, coefficients=touched,
        knots=ty.numel() + tx.numel(), kx=kx, ky=ky, **counts,
    )


def _smooth_call_counts(args, kw) -> dict:
    """The keywords of :func:`map_smooth_bound` for one ``map_smooth(*args,
    **kw)`` call, counted from its inputs (see :func:`smooth_call_bound`)."""
    x, y, valid, grid, nan_img = args
    n_frames, n_ys, n_xs = grid.shape
    yb = (y - kw['iy0']) / kw['y_step']
    xb = (x - kw['ix0']) / kw['x_step']
    inside = (yb >= 0) & (yb <= n_ys - 1) & (xb >= 0) & (xb <= n_xs - 1)
    counts, live = _map_call_counts(x, y, valid, nan_img,
                                    kw['propagate_nan'], inside)
    corner = (torch.floor(yb).clamp(0, n_ys - 2).long() * n_xs
              + torch.floor(xb).clamp(0, n_xs - 2).long())
    corners = torch.stack([corner, corner + 1, corner + n_xs,
                           corner + n_xs + 1])
    touched = sum(_distinct(corners, live[f], n_ys * n_xs)
                  for f in range(n_frames))
    return dict(samples=x.numel(), frames=n_frames, grid_values=touched,
                image_cells=counts.pop('grid_cells'), **counts)


def smooth_call_bound(args, kw) -> dict:
    """
    :func:`map_smooth_bound` of one ``map_smooth(*args, **kw)`` call,
    counted from its inputs: the grid values are the corners that each
    frame's live values read.
    """
    return map_smooth_bound(**_smooth_call_counts(args, kw))


# ---------------------------------------------------------------------------
# pchip: the PCHIP oversampling of the 'smooth' mode, and the smooth stage
# ---------------------------------------------------------------------------
#
# The oversampling is counted as one function, the box in and the grid out:
# the box's cells read once and the oversampled grid written once (the row
# pass's intermediate need not leave the chip). Operations at the least
# known work: per finite cell of a line with two finite cells or more, the
# slope to its neighbour, its derivative (Fritsch-Carlson, or the edge
# estimate) and its interval's cubic coefficients; per position evaluated
# between two finite cells, the cubic in Horner form. Positions on a finite
# cell are copies, and NaN positions cost their store only.

#: Per finite cell: slope (3), derivative (13), interval coefficients (8).
PCHIP_CELL_OPS = 24
#: Per evaluated position: the local coordinate (2), 3 multiply-adds.
PCHIP_POSITION_OPS = 8


def pchip_bound(*, cells: int, grid_values: int, finite_cells: int,
                evaluated: int) -> dict:
    """
    The bound of the oversampling of ``cells`` box cells into
    ``grid_values`` grid values, ``finite_cells`` finite cells (summed over
    both passes' lines that hold two or more) and ``evaluated`` positions
    (both passes). ``dict(ms, bound_by, bytes, f64_ops)``.
    """
    n_bytes = 8 * cells + 8 * grid_values
    ops = finite_cells * PCHIP_CELL_OPS + evaluated * PCHIP_POSITION_OPS
    ms, by = roofline_ms(n_bytes, f64_ops=ops)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f64_ops=ops)


def infill_call_bound(frames: torch.Tensor) -> dict:
    """
    The bound of one ``map_infill`` call on ``frames`` (..., ny, nx)
    float64: each cell read once (8 bytes), its cleaned value (8 bytes)
    and NaN flag (1 byte) written once. ``dict(ms, bound_by, bytes)``.
    """
    n_bytes = 17 * frames.numel()
    ms, by = roofline_ms(n_bytes)
    return dict(ms=ms, bound_by=by, bytes=n_bytes)


def _pchip_pass_counts(lines: torch.Tensor, out: torch.Tensor):
    """``(finite cells, evaluated positions)`` of one pass over the lines
    (..., n) with output ``out`` (..., n_eval): the finite cells of the
    lines with two or more; the finite outputs that are not copies."""
    finite = torch.isfinite(lines)
    enough = finite.sum(dim=-1) >= 2
    cells = int(finite.sum(dim=-1)[enough].sum())
    return cells, int(torch.isfinite(out).sum()) - cells


def pchip_call_bound(box: torch.Tensor, ky_rep: int, kx_rep: int) -> dict:
    """
    :func:`pchip_bound` of the oversampling of ``box`` (F, ny_b, nx_b)
    float64 (rows by ``kx_rep``, then columns by ``ky_rep``; the two
    pchip launches of one smooth call), counted from its values.
    """
    n_frames, ny_b, nx_b = box.shape
    n_xs = (nx_b - 1) * kx_rep + 1
    n_ys = (ny_b - 1) * ky_rep + 1
    rows = _pchip_axis(box, n_xs, kx_rep)
    grid = _pchip_axis(rows.transpose(-1, -2), n_ys, ky_rep)
    row_cells, row_evaluated = _pchip_pass_counts(box, rows)
    col_cells, col_evaluated = _pchip_pass_counts(rows.transpose(-1, -2), grid)
    return pchip_bound(cells=box.numel(), grid_values=grid.numel(),
                       finite_cells=row_cells + col_cells,
                       evaluated=row_evaluated + col_evaluated)


def smooth_stage_bound(box: torch.Tensor, ky_rep: int, kx_rep: int, args,
                       kw) -> dict:
    """
    The bound of the whole 'smooth' stage of one ``map_img`` call, box to
    map, at its least work: the box cells read once (the oversampled grids
    never leave the chip), the validity of every sample and x and y of the
    valid ones, the NaN cells of the image the NaN rule touches, every map
    value written once; the oversampling's operations
    (:func:`pchip_call_bound`) and the sampler's (:func:`smooth_call_bound`)
    on the grids of ``box`` and the ``map_smooth(*args, **kw)`` call.
    """
    pchip = pchip_call_bound(box, ky_rep, kx_rep)
    counts = _smooth_call_counts(args, kw)
    sampler = map_smooth_bound(**counts)
    n_bytes = (8 * box.numel() + counts['image_cells']
               + map_sample_bytes(counts['samples'], counts['valid_samples'],
                                  counts['frames']))
    ops = pchip['f64_ops'] + sampler['f64_ops']
    ms, by = roofline_ms(n_bytes, f64_ops=ops)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f64_ops=ops)


# ---------------------------------------------------------------------------
# dsk: the double-single kernels (csrc/dsk.cu), one bound per kernel and op
# ---------------------------------------------------------------------------
#
# Bytes: each value's float32 words read once and written once, 6 for a
# pair op (a and b in, the result out, each a (hi, lo) pair) and 3 for the
# float32 atan2. Operations: float32, at the least work known to compute
# the result at the JAX tests' grades, the ds blocks in their cheapest
# known forms (Hida/Li/Bailey's QD library): two_prod as a multiply and an
# FMA (3, where Dekker's split takes 17), the "sloppy" ds add and division,
# QD's ds square root (a float32 root and a division, one Newton step);
# atan2_ds as dsk.atan2_ds reduces and sums it (13 ds terms), with the
# branch work counted only for the values that take the branch.

#: float32 operations of the ds building blocks
DS_BLOCK_OPS = dict(
    two_sum=6,
    quick_two_sum=3,
    two_prod=3,       # p = a*b, e = fma(a, b, -p)
    add=11,           # two_sum, the lo words' sum and its add, quick_two_sum
    add_f=10,         # two_sum, the lo word's add, quick_two_sum
    mul=10,           # two_prod, the two cross terms as FMAs, quick_two_sum
    sqr=9,            # two_prod, 2*hi as a multiply and an FMA, quick_two_sum
    div=22,           # QD: q1 = a.hi/b.hi, b*q1, a - b*q1, q2, quick_two_sum
    sqrt=25,          # QD: x = 1/sqrt(a.hi), a.hi*x, a - (a.hi*x)^2, add
)


def _dsk_value_ops() -> dict[str, int]:
    b = DS_BLOCK_OPS
    return {
        'mul': b['mul'],
        'div': b['div'],
        'hypot': 2 * b['sqr'] + b['add'] + b['sqrt'],
        # compares (swap, zero den, tan(pi/8), x < 0, y < 0, 2 NaN tests),
        # t = num/den, s = u^2, the 12-step ds Horner chain, u + u s p
        'atan2_ds': 7 + b['div'] + b['sqr'] + 12 * (b['mul'] + b['add'])
        + 2 * b['mul'] + b['add'],
        # max, min, zero test, t, s, 8 FMAs of the Horner chain, t + t s p
        # (a multiply and an FMA), 3 sign compares, 2 NaN tests
        'atan2': 2 + 1 + 1 + 1 + 16 + 3 + 3 + 2,
    }


#: float32 operations per value of each op, at the least known work
DSK_VALUE_OPS = _dsk_value_ops()
#: what a value that takes a branch adds: atan2_ds's (t-1)/(t+1) reduction
#: (two add_f, a division, pi/4 added), the swap's pi/2 - r and the
#: negative x's pi - r (a ds add each, one subtraction in float32)
DSK_REDUCED_OPS = 2 * DS_BLOCK_OPS['add_f'] + DS_BLOCK_OPS['div'] \
    + DS_BLOCK_OPS['add']
DSK_BRANCH_OPS = {'atan2_ds': DS_BLOCK_OPS['add'], 'atan2': 1}
#: float32 words moved per value
DSK_WORDS = {'mul': 6, 'div': 6, 'hypot': 6, 'atan2_ds': 6, 'atan2': 3}


def atan2_branches(y, x) -> dict[str, int]:
    """
    The branch counts of :func:`dsk_call_bound` for an atan2 (or
    atan2_ds, on the hi words) of ``y`` and ``x`` (float32 tensors or
    arrays): ``swapped`` (|y| > |x|), ``negative_x`` and ``reduced`` (the
    values whose ratio min/max passes tan(pi/8), as the kernel tests it).
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32)
    ay, ax = torch.abs(y), torch.abs(x)
    tiny = torch.finfo(torch.float32).tiny
    t = torch.minimum(ay, ax) / torch.clamp(torch.maximum(ay, ax), min=tiny)
    return dict(swapped=int((ay > ax).sum()), negative_x=int((x < 0).sum()),
                reduced=int((t > 0.41421356237309503).sum()))


def dsk_call_bound(op: str, n: int, *, swapped: int = 0,
                   negative_x: int = 0, reduced: int = 0) -> dict:
    """
    The bound of one call of the dsk kernel of ``op`` (``'mul'``, ``'div'``,
    ``'hypot'``, ``'atan2_ds'``: ``dsk_pairs``; ``'atan2'``: ``dsk_atan2``)
    over ``n`` values, with the branch counts of :func:`atan2_branches` for
    the two atan2 ops (ignored by the others). ``dict(ms, bound_by, bytes,
    f32_ops)``.
    """
    if op not in DSK_WORDS:
        raise ValueError(f'op must be one of {tuple(DSK_WORDS)}, got {op!r}')
    ops = DSK_VALUE_OPS[op] * n
    if op in DSK_BRANCH_OPS:
        ops += DSK_BRANCH_OPS[op] * (swapped + negative_x)
    if op == 'atan2_ds':
        ops += DSK_REDUCED_OPS * reduced
    n_bytes = 4 * DSK_WORDS[op] * n
    ms, by = roofline_ms(n_bytes, f32_ops=ops)
    return dict(ms=ms, bound_by=by, bytes=n_bytes, f32_ops=ops)
