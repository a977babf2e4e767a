"""
The 'smooth' (PCHIP) map reprojection on the body's device (port of
``planetmapper_tpu.ops.pchip_device``).

Replicates the reference's monotone-cubic mode (body_xy.py:1704-1853): the
image is cut to the map's padded pixel bounding box, PCHIP-oversampled
separably (rows, then columns, each over its finite cells only) and
sampled bilinearly at the map samples. On a card that is three launches
for a frame or a whole cube: the hand-written kernels
:func:`.pchip_kernel.pchip_axis` (once per axis, every frame at once) and
:func:`.map_smooth_kernel.map_smooth`. :func:`oversample` is the plain
per-frame oversampling. The oversampling is the ``pm.map.pchip`` span and
the sampler the ``pm.map.smooth`` span; ``map.smooth_grid_values`` counts
the oversampled grids' values.
"""

from __future__ import annotations

import math

import torch

from .. import tracing
from .interp_device import MapSamples
from .map_smooth_kernel import map_smooth
from .pchip_kernel import _pchip_axis, pchip_axis


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
    """The PCHIP-oversampled ``(n_ys, n_xs)`` float64 grid of one frame, in
    plain PyTorch."""
    iy0, iy1, ix0, ix1 = box
    n_xs = (ix1 - ix0 - 1) * kx_rep + 1
    n_ys = (iy1 - iy0 - 1) * ky_rep + 1
    rows = _pchip_axis(frame[iy0:iy1, ix0:ix1], n_xs, kx_rep)
    return _pchip_axis(rows.T, n_ys, ky_rep).T


def oversample_frames(frames: torch.Tensor, box, ky_rep: int, kx_rep: int):
    """
    The PCHIP-oversampled ``(F, n_ys, n_xs)`` float64 grids of every frame
    of ``frames`` (F, ny, nx): one :func:`.pchip_kernel.pchip_axis` call per
    axis, the box read in place.
    """
    iy0, iy1, ix0, ix1 = box
    n_xs = (ix1 - ix0 - 1) * kx_rep + 1
    n_ys = (iy1 - iy0 - 1) * ky_rep + 1
    rows = pchip_axis(frames[:, iy0:iy1, ix0:ix1], n_xs, kx_rep, axis=-1)
    return pchip_axis(rows, n_ys, ky_rep, axis=-2)


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
    if box is None or box[1] - box[0] < 2 or box[3] - box[2] < 2:
        # no usable sample, or a degenerate box (< 2 px on a side: the host
        # path finds < 2 points there). An all-NaN frame needs no test: each
        # of its lines has < 2 finite cells, so its grid is all NaN
        nan = torch.full(out_shape, torch.nan, dtype=torch.float32,
                         device=frames.device)
        return nan if cube else nan[0]

    iy0, iy1, ix0, ix1 = box
    ky_rep = pick_rep(iy1 - iy0, oversample_by, max_oversampled_img_size)
    kx_rep = pick_rep(ix1 - ix0, oversample_by, max_oversampled_img_size)
    with tracing.span('pm.map.pchip'):
        grids = oversample_frames(frames, box, ky_rep, kx_rep)
    tracing.count('map.smooth_grid_values', grids.numel())
    n_ys, n_xs = grids.shape[1:]
    with tracing.span('pm.map.smooth'):
        vals = map_smooth(
            samples.x, samples.y, samples.valid, grids, torch.isnan(frames),
            iy0=iy0, ix0=ix0,
            y_step=(iy1 - iy0 - 1) / (n_ys - 1) if n_ys > 1 else 1.0,
            x_step=(ix1 - ix0 - 1) / (n_xs - 1) if n_xs > 1 else 1.0,
            propagate_nan=propagate_nan,
        ).reshape(out_shape)
    return vals if cube else vals[0]
