"""
The reference's 'smooth' map: planetmapper's monotone-cubic mode
(``BodyXY.map_img(..., interpolation='smooth')``, upstream body_xy.py:
1704-1853) written plainly, vectorised over planes and lines.

- The box: the image pixels within ``limit_padding`` of the valid samples'
  x and y extent.
- The oversampling factor of each axis (``get_xy_pchip``): the largest of
  ``oversample_by`` down to 2 that keeps the box's ``n * k - (k - 1)``
  positions within ``max_oversampled_img_size``, else 1.
- PCHIP of each line over its finite cells only, as scipy's
  ``PchipInterpolator(extrapolate=False)``: Fritsch-Carlson derivatives
  (the weighted harmonic mean of the neighbouring slopes where they share
  a sign, else 0), the one-sided three-point end rule with its clamps, two
  finite cells a straight line, fewer a NaN line, NaN outside the first and
  last finite cell; the cubic of each interval in its local coordinate.
  Rows first, then the columns of the result.
- The samples: bilinear on the oversampled grid, NaN outside it or beside a
  NaN grid value (``RegularGridInterpolator``, ``fill_value=nan``), and with
  ``propagate_nan`` NaN outside the pixel-centre grid or beside a NaN pixel.

Each step computes in ``dtype``: float64 for the reference, float32 for its
control; a second control keeps the sampler's coordinates in float64 and
computes only the PCHIP grid in float32. Imports numpy and torch only.
"""

from __future__ import annotations

import math

import torch

from . import maps as rm


def box(x, y, ny: int, nx: int, limit_padding: float = 5.0):
    """``(iy0, iy1, ix0, ix1)``: the pixels within ``limit_padding`` of the
    valid samples' extent, or None when no sample is valid."""
    ok = torch.isfinite(x) & torch.isfinite(y)
    if not bool(ok.any()):
        return None
    xs, ys = x[ok], y[ok]

    def span(lo, hi, n):
        cells = torch.arange(n, dtype=torch.float64)
        inside = ((cells >= float(lo) - limit_padding)
                  & (cells <= float(hi) + limit_padding)).nonzero()
        return int(inside[0]), int(inside[-1]) + 1

    iy0, iy1 = span(ys.min(), ys.max(), ny)
    ix0, ix1 = span(xs.min(), xs.max(), nx)
    return iy0, iy1, ix0, ix1


def factor(n: int, oversample_by: int, max_oversampled_img_size: int) -> int:
    """``get_xy_pchip``'s oversampling factor of an axis of ``n`` pixels."""
    for k in range(oversample_by, 1, -1):
        if n * k - (k - 1) <= max_oversampled_img_size:
            return k
    return 1


def _edge(h0, h1, m0, m1):
    """scipy's end rule: the three-point estimate, 0 where it turns against
    the first slope, 3 times that slope where the slopes differ in sign and
    the estimate exceeds it three times."""
    d = ((2.0 * h0 + h1) * m0 - h0 * m1) / (h0 + h1)
    flip = torch.sign(d) != torch.sign(m0)
    over = (torch.sign(m0) != torch.sign(m1)) & (d.abs() > 3.0 * m0.abs())
    return torch.where(flip, 0.0, torch.where(over, 3.0 * m0, d))


def pchip_lines(values: torch.Tensor, k: int) -> torch.Tensor:
    """
    PCHIP of each line of ``values`` (L, n), its cells at 0..n-1, over its
    finite cells, evaluated at the positions ``e / k`` for ``e`` in 0 ..
    ``(n - 1) k``: ``(L, (n - 1) k + 1)``. Positions are counted in whole
    ``1 / k`` steps, so that a position on a cell is that cell exactly.
    """
    lines, n = values.shape
    dtype = values.dtype
    dev = values.device
    finite = torch.isfinite(values)
    m = finite.sum(-1)                                          # (L,)
    # the finite cells of each line first, in order; the rest after them
    order = torch.argsort((~finite).to(torch.int8), dim=-1, stable=True)
    yk = torch.gather(torch.where(finite, values, 0.0), -1, order)
    cell = torch.arange(n, device=dev)
    real = cell[None] < m[:, None]                              # (L, n)
    xk = torch.where(real, order.to(dtype), math.inf)

    # intervals and slopes between consecutive finite cells (the first
    # m - 1 of the n - 1 real)
    h = xk[:, 1:] - xk[:, :-1]
    h = torch.where(cell[None, :-1] < (m - 1)[:, None], h, 1.0)
    s = (yk[:, 1:] - yk[:, :-1]) / h

    # Fritsch-Carlson derivatives at the interior finite cells 1..m-2
    d = torch.zeros_like(yk)
    rows = torch.arange(lines, device=dev)
    last = (m - 1).clamp(min=0)
    first_d = last_d = s[:, 0]
    if n >= 3:
        h0, h1, s0, s1 = h[:, :-1], h[:, 1:], s[:, :-1], s[:, 1:]
        w1 = 2.0 * h1 + h0
        w2 = h1 + 2.0 * h0
        same = (torch.sign(s0) == torch.sign(s1)) & (s0 != 0) & (s1 != 0)
        mean = (w1 / torch.where(same, s0, 1.0)
                + w2 / torch.where(same, s1, 1.0)) / (w1 + w2)
        d[:, 1:-1] = torch.where(same, 1.0 / mean, 0.0)
        # the end cells: the end rule from three finite cells
        i2 = (m - 2).clamp(min=0)
        i3 = (m - 3).clamp(min=0)
        first_d = _edge(h[:, 0], h[:, 1], s[:, 0], s[:, 1])
        last_d = _edge(h[rows, i2], h[rows, i3], s[rows, i2], s[rows, i3])
    # two finite cells: a straight line
    two = m == 2
    d[:, 0] = torch.where(two, s[:, 0], first_d)
    d[rows, last] = torch.where(two, s[:, 0], last_d)

    # each position's interval (scipy's PPoly: the last knot at or before
    # it, at most the last interval), and the interval's cubic in its local
    # coordinate
    e = torch.arange((n - 1) * k + 1, dtype=dtype, device=dev)
    knots = xk * k
    steps = e.expand(lines, -1).contiguous()
    j = torch.searchsorted(knots, steps, right=True) - 1
    j = torch.minimum(j.clamp(min=0), (m - 2).clamp(min=0)[:, None])
    x0 = torch.gather(xk, -1, j)
    hj = torch.gather(h, -1, j)
    sj = torch.gather(s, -1, j)
    y0 = torch.gather(yk, -1, j)
    d0 = torch.gather(d, -1, j)
    d1 = torch.gather(d, -1, j + 1)
    c2 = (3.0 * sj - 2.0 * d0 - d1) / hj
    c3 = (d0 + d1 - 2.0 * sj) / (hj * hj)
    t = (steps - x0 * k) / k
    out = y0 + t * (d0 + t * (c2 + t * c3))
    inside = ((steps >= knots[:, :1])
              & (steps <= torch.gather(knots, -1, last[:, None]))
              & (m >= 2)[:, None])
    return torch.where(inside, out, math.nan)


def oversample(frames: torch.Tensor, bx, ky: int, kx: int) -> torch.Tensor:
    """The PCHIP-oversampled grids ``(F, n_ys, n_xs)`` of the box of
    ``frames`` (F, ny, nx): rows by ``kx``, then columns by ``ky``."""
    iy0, iy1, ix0, ix1 = bx
    cut = frames[:, iy0:iy1, ix0:ix1]
    f, nby, nbx = cut.shape
    rows = pchip_lines(cut.reshape(f * nby, nbx), kx).reshape(f, nby, -1)
    n_xs = rows.shape[-1]
    cols = rows.transpose(1, 2).reshape(f * n_xs, nby)
    return pchip_lines(cols, ky).reshape(f, n_xs, -1).transpose(1, 2)


def smooth(frames: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
           oversample_by: int = 5, max_oversampled_img_size: int = 10_000,
           limit_padding: float = 5.0, propagate_nan: bool = True,
           dtype=torch.float64, coord_dtype=None) -> torch.Tensor:
    """
    'smooth' maps ``(F, S)`` float64 (NaN where no value) of ``frames``
    (F, ny, nx) at the samples ``x``, ``y`` (S,) float64, NaN where
    invalid: the PCHIP grid computed in ``dtype``, the sampler's
    coordinates in ``coord_dtype`` (``dtype`` when None).
    """
    coord_dtype = dtype if coord_dtype is None else coord_dtype
    n_frames, ny, nx = frames.shape
    out_nan = torch.full((n_frames, x.numel()), math.nan, dtype=torch.float64,
                         device=frames.device)
    bx = box(x, y, ny, nx, limit_padding)
    if bx is None or bx[1] - bx[0] < 2 or bx[3] - bx[2] < 2:
        return out_nan
    iy0, iy1, ix0, ix1 = bx
    ky = factor(iy1 - iy0, oversample_by, max_oversampled_img_size)
    kx = factor(ix1 - ix0, oversample_by, max_oversampled_img_size)
    grid = oversample(frames.to(dtype), bx, ky, kx)
    n_ys, n_xs = grid.shape[1:]

    valid = torch.isfinite(x) & torch.isfinite(y)
    gy = ((torch.where(valid, y, 0.0) - iy0) * ky).to(coord_dtype)
    gx = ((torch.where(valid, x, 0.0) - ix0) * kx).to(coord_dtype)
    inside = (gy >= 0) & (gy <= n_ys - 1) & (gx >= 0) & (gx <= n_xs - 1)
    bad = (~(valid & inside))[None].expand(n_frames, -1)
    if propagate_nan:
        bad = bad | rm._nan_rule(x, y, torch.isnan(frames), ny, nx)
    vals = rm._bilinear(grid, gx, gy).double()
    return torch.where(bad | torch.isnan(vals), math.nan, vals)
