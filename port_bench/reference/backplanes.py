"""
The reference's 26 backplanes of a frame: the frozen plain per-pixel graph
(:mod:`..vendor.backplanes_plain`) on the reference's own scene
(:mod:`.scene`), in row blocks so that a 2048x2048 frame fits beside
nothing else on the card.

``dtype=torch.float32`` gives the control: the same graph with every
per-pixel value in float32 (the scene's epochs first taken relative to the
sub-observer epoch, in float64, so that float32 holds them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..vendor.backplanes_plain import PLANE_ORDER, fused_backplanes_fn
from . import scene as rs

_GRAPH = fused_backplanes_fn(positive_west=True, prograde=True, have_sun=True)
_EPOCHS = ('et', 'tau0', 'sun_epoch0')


def planes(anchors: dict, xy2angular, disc, nx: int, ny: int, device, *,
           dtype=torch.float64, block_rows: int = 256,
           row0: int = 0) -> dict[str, np.ndarray]:
    """
    The 26 planes (float64 numpy) of ``ny`` rows of a frame from row
    ``row0`` (the whole frame by default) from one epoch's anchors
    (:meth:`.scene.Scene.anchors` indexed at an epoch) and its
    ``xy2angular`` matrix and disc.
    """
    tau0 = anchors['tau0']
    a = {k: (v - tau0 if k in _EPOCHS else v).to(device=device, dtype=dtype)
         for k, v in anchors.items()}
    m = torch.as_tensor(xy2angular, dtype=torch.float64).to(device, dtype)
    d = torch.as_tensor(np.asarray(disc, dtype=np.float64)).to(device, dtype)
    radii = torch.tensor(rs.RADII, dtype=dtype, device=device)
    out = {k: np.empty((ny, nx)) for k in PLANE_ORDER}
    for first in range(0, ny, block_rows):
        n = min(block_rows, ny - first)
        block = _GRAPH(nx, n, m, d, radii, a, row0=float(row0 + first))
        for k in PLANE_ORDER:
            out[k][first:first + n] = block[k].double().cpu().numpy()
    return out


def rows(anchors: dict, xy2angular, disc, nx: int, row_indices, device, *,
         dtype=torch.float64) -> dict[str, np.ndarray]:
    """The 26 planes (float64 numpy, ``(len(row_indices), nx)``) at the
    frame's rows ``row_indices``, a run of consecutive rows a call."""
    row_indices = np.asarray(row_indices)
    out = {k: np.empty((len(row_indices), nx)) for k in PLANE_ORDER}
    start = 0
    while start < len(row_indices):
        stop = start + 1
        while (stop < len(row_indices)
               and row_indices[stop] == row_indices[stop - 1] + 1):
            stop += 1
        block = planes(anchors, xy2angular, disc, nx, stop - start, device,
                       dtype=dtype, row0=int(row_indices[start]))
        for k in PLANE_ORDER:
            out[k][start:stop] = block[k]
        start = stop
    return out
