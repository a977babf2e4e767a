"""
The reference's maps: planetmapper's rectangular lon/lat map of a frame,
its pixel coordinates (the x/y maps) from the reference's own scene, and
the interpolation mode the benchmark's cells use.

- :func:`xy_maps`: each map sample's planetographic lon/lat -> body-fixed
  surface point -> visible or not (the surface normal against the ray to
  the observer at the point's own light-time epoch, as ``illumf``) ->
  observer-frame vector (the offset from the sub-observer point rotated at
  its own epoch) -> RA/Dec -> angular coordinates -> pixel, NaN where not
  visible or outside the frame.
- :func:`linear`: ``'linear'`` is a degree-1 interpolating spline through
  the pixel centres, which is bilinear interpolation; a sample whose four
  neighbouring pixels hold a NaN, or that lies outside the grid of pixel
  centres, is NaN (``propagate_nan``).

The sampler computes in ``dtype``: float64 for the reference, float32 for
its control. Imports numpy and torch only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..vendor import geometry as geom
from . import scene as rs


def lonlat_grid(degree_interval: float):
    """The rectangular map's (lon, lat) [deg] grids, longitudes positive
    west (Jupiter's), decreasing along a row."""
    lons = np.arange(degree_interval / 2, 360, degree_interval)[::-1]
    lats = np.arange(-90 + degree_interval / 2, 90, degree_interval)
    lon, lat = np.meshgrid(lons, lats)
    return lon % 360, lat


def xy_maps(sc: rs.Scene, anchors: dict, xy2angular, nx: int, ny: int,
            degree_interval: float, device) -> tuple[torch.Tensor, ...]:
    """``(x, y)`` float64 maps on ``device`` of one epoch's scene."""
    lon, lat = lonlat_grid(degree_interval)
    f64 = torch.float64
    lon = torch.as_tensor(np.deg2rad(lon), dtype=f64, device=device)
    lat = torch.as_tensor(np.deg2rad(lat), dtype=f64, device=device)
    re, _, rp = rs.RADII
    targvec = geom.geodetic_to_rect(-lon, lat, 0.0, re, (re - rp) / re)
    a = {k: v.to(device) for k, v in anchors.items()}

    # visibility at each point's own epoch (converged light time)
    et = a['et']
    obs_pos = a['obs_pos']
    lt = torch.zeros_like(lon)
    for _ in range(4):
        tau = et - lt
        m = sc.frame.matrix(tau)
        targ = sc.pos(rs.JUPITER, tau)[..., :3] - obs_pos
        point = targ + rs._mv(m.transpose(-1, -2), targvec)
        lt = geom.norm(point) / rs.CLIGHT
    srfvec_bf = rs._mv(m, point)
    normal = geom.surface_normal(targvec, sc.radii.to(device))
    visible = torch.sum(normal * -srfvec_bf, dim=-1) > 0.0

    sub = {k: a[k] for k in ('subpoint_targvec', 'subpoint_rayvec',
                             'subpoint_distance', 'subpoint_obsvec', 'tau0')}
    obsvec = sc.targvec2obsvec(targvec, sub)
    unit = obsvec / geom.norm(obsvec, keepdim=True)
    ax, ay = rs.Scene._angular(a['obsvec2angular'], unit)
    inv = torch.linalg.inv(torch.as_tensor(xy2angular, dtype=f64)).to(device)
    x = inv[0, 0] * ax + inv[0, 1] * ay + inv[0, 2]
    y = inv[1, 0] * ax + inv[1, 1] * ay + inv[1, 2]
    ok = (visible & (x > -0.5) & (x < nx - 0.5)
          & (y > -0.5) & (y < ny - 0.5))
    nan = torch.tensor(math.nan, dtype=f64, device=device)
    return torch.where(ok, x, nan), torch.where(ok, y, nan)


def _nan_rule(x, y, nan_img, ny: int, nx: int):
    """Samples that are NaN in the map: invalid, outside the grid of pixel
    centres, or beside a NaN pixel (``nan_img``: (F, ny, nx) bool)."""
    valid = torch.isfinite(x) & torch.isfinite(y)
    xs = torch.where(valid, x, 0.0)
    ys = torch.where(valid, y, 0.0)
    outside = (xs < 0) | (ys < 0) | (xs > nx - 1) | (ys > ny - 1)
    x0 = torch.floor(xs).long().clamp(0, nx - 1)
    x1 = torch.ceil(xs).long().clamp(0, nx - 1)
    y0 = torch.floor(ys).long().clamp(0, ny - 1)
    y1 = torch.ceil(ys).long().clamp(0, ny - 1)
    near_nan = (nan_img[:, y0, x0] | nan_img[:, y0, x1]
                | nan_img[:, y1, x0] | nan_img[:, y1, x1])
    return (~valid | outside)[None] | near_nan


def _bilinear(grid, gx, gy):
    """Bilinear values of ``grid`` (F, n, m) at fractional indices."""
    n, m = grid.shape[-2:]
    i0 = torch.floor(gy).clamp(0, n - 2)
    j0 = torch.floor(gx).clamp(0, m - 2)
    fy = gy - i0
    fx = gx - j0
    i0, j0 = i0.long(), j0.long()
    v00 = grid[:, i0, j0]
    v01 = grid[:, i0, j0 + 1]
    v10 = grid[:, i0 + 1, j0]
    v11 = grid[:, i0 + 1, j0 + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def linear(frames, x, y, *, dtype=torch.float64) -> torch.Tensor:
    """``'linear'`` maps (F, *map) of ``frames`` (F, ny, nx)."""
    ny, nx = frames.shape[-2:]
    nan_img = torch.isnan(frames)
    bad = _nan_rule(x, y, nan_img, ny, nx)
    grid = torch.nan_to_num(frames.to(dtype), nan=0.0)
    xs = torch.where(torch.isfinite(x), x, 0.0).to(dtype)
    ys = torch.where(torch.isfinite(y), y, 0.0).to(dtype)
    out = _bilinear(grid, xs, ys)
    return torch.where(bad, math.nan, out.double())
