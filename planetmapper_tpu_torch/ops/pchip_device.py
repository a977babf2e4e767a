"""
The 'smooth' (PCHIP) map reprojection on the body's device (port of
``planetmapper_tpu.ops.pchip_device``).

Replicates the reference's monotone-cubic mode (body_xy.py:1704-1853): the
image is cut to the map's padded pixel bounding box, PCHIP-oversampled
separably (rows, then columns, each over its finite cells only), and
sampled bilinearly at the map samples by the hand-written kernel
:func:`.map_smooth_kernel.map_smooth`.

The oversampling is plain float64 PyTorch. The data-dependent part of
PCHIP (each row interpolates over its finite cells only, NaN gaps bridged
by irregular-spacing monotone cubics) uses running max/min of indices for
the nearest finite neighbours and gathers, where the JAX package used
associative scans and static repeats.
"""

from __future__ import annotations

import math

import torch

from .interp_device import MapSamples
from .map_smooth_kernel import map_smooth


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


def smooth_box(limits, ny: int, nx: int, limit_padding: float = 5.0):
    """
    The map's pixel bounding box ``(iy0, iy1, ix0, ix1)`` padded by
    ``limit_padding`` and clipped to the image, or None when no map sample
    is valid.
    """
    if limits is None:
        return None
    xmin, xmax, ymin, ymax = limits
    ix0 = max(0, int(math.ceil(xmin - limit_padding)))
    ix1 = min(nx, int(math.floor(xmax + limit_padding)) + 1)
    iy0 = max(0, int(math.ceil(ymin - limit_padding)))
    iy1 = min(ny, int(math.floor(ymax + limit_padding)) + 1)
    return iy0, iy1, ix0, ix1


def pick_rep(n_box: int, oversample_by: int,
             max_oversampled_img_size: int) -> int:
    """The largest oversampling factor <= ``oversample_by`` that keeps the
    oversampled side within ``max_oversampled_img_size`` (else 1)."""
    for k in range(oversample_by, 1, -1):
        if n_box * k - (k - 1) <= max_oversampled_img_size:
            return k
    return 1


def oversample(frame: torch.Tensor, box, ky_rep: int, kx_rep: int):
    """The PCHIP-oversampled ``(n_ys, n_xs)`` float64 grid of one frame."""
    iy0, iy1, ix0, ix1 = box
    n_xs = (ix1 - ix0 - 1) * kx_rep + 1
    n_ys = (iy1 - iy0 - 1) * ky_rep + 1
    rows = _pchip_axis(frame[iy0:iy1, ix0:ix1], n_xs, kx_rep)
    return _pchip_axis(rows.T, n_ys, ky_rep).T


def smooth_interpolation_device(
    img: torch.Tensor, samples: MapSamples, *, propagate_nan: bool,
    oversample_by: int, max_oversampled_img_size: int,
    limit_padding: float = 5.0,
) -> torch.Tensor:
    """
    'smooth' reprojection of a frame ``(ny, nx)`` or a cube ``(nz, ny,
    nx)`` (float64 on the samples' device). Returns float32 shaped like the
    map (or ``(nz,) + map``).
    """
    cube = img.ndim == 3
    frames = img if cube else img[None]
    ny, nx = frames.shape[-2:]
    out_shape = (frames.shape[0],) + samples.shape
    box = smooth_box(samples.limits, ny, nx, limit_padding)
    nan = torch.full(out_shape, torch.nan, dtype=torch.float32,
                     device=frames.device)
    if (
        box is None
        or box[1] - box[0] < 2 or box[3] - box[2] < 2
        or bool(torch.isnan(frames).all())
    ):
        # no usable sample, a degenerate box (< 2 px on a side: the host
        # path finds < 2 points there) or an all-NaN image
        return nan if cube else nan[0]

    iy0, iy1, ix0, ix1 = box
    ky_rep = pick_rep(iy1 - iy0, oversample_by, max_oversampled_img_size)
    kx_rep = pick_rep(ix1 - ix0, oversample_by, max_oversampled_img_size)
    n_xs = (ix1 - ix0 - 1) * kx_rep + 1
    n_ys = (iy1 - iy0 - 1) * ky_rep + 1
    grids = torch.stack([oversample(f, box, ky_rep, kx_rep) for f in frames])
    vals = map_smooth(
        samples.x, samples.y, samples.valid, grids, torch.isnan(frames),
        iy0=iy0, ix0=ix0,
        y_step=(iy1 - iy0 - 1) / (n_ys - 1) if n_ys > 1 else 1.0,
        x_step=(ix1 - ix0 - 1) / (n_xs - 1) if n_xs > 1 else 1.0,
        propagate_nan=propagate_nan,
    ).reshape(out_shape)
    return vals if cube else vals[0]
