"""
Driver ``map_frames``: a mapped frame per step. Each step passes a host
float32 image from a seeded pool to ``BodyXY.map_img`` in its default
'linear' mode, onto the configuration's map; the result stays on the
device (the default ``as_numpy=False``).

The pool (``pool`` images) is made at set-up: unit normal noise, with
``nan_blocks`` square NaN blocks of ``nan_block_px`` on the disc (a frame's
bad pixels). The steps take the pool's images in a seeded order.

The check compares, once the window has closed, the whole maps of a seeded
sample of the window's steps (``steps_checked``) with the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import program
from port_bench.reference import compare
from port_bench.reference import maps as rm
from port_bench.reference import scene as rs
from port_bench.vendor import bounds

TABLE = 65536


def _pool(ctx) -> list[np.ndarray]:
    cfg, tr = ctx.config, ctx.traffic
    nx, ny = cfg['frame']
    x0, y0, r0, _rot = cfg['disc']
    rng = program.rng(ctx, program.STREAM_POOL)
    pool = []
    for _ in range(tr['pool']):
        img = rng.standard_normal((ny, nx), dtype=np.float32)
        b = tr['nan_block_px']
        for _ in range(tr['nan_blocks']):
            rad = rng.uniform(0, 0.8 * r0)
            ang = rng.uniform(0, 2 * np.pi)
            i = int(y0 + rad * np.sin(ang))
            j = int(x0 + rad * np.cos(ang))
            img[i:i + b, j:j + b] = np.nan
        pool.append(img)
    return pool


def inputs(ctx) -> tuple[list[np.ndarray], np.ndarray]:
    """The pool of images and the order ``(TABLE,)`` in which the steps take
    them, drawn from the seed."""
    pool = _pool(ctx)
    order = program.rng(ctx, program.STREAM_TRAFFIC).integers(len(pool),
                                                               size=TABLE)
    return pool, order


def setup(ctx):
    cfg = ctx.config
    state = type('State', (), {})()
    state.ctx = ctx
    state.pool, state.order = inputs(ctx)
    check_rng = program.rng(ctx, program.STREAM_CHECK)
    state.kept = ctx.Reservoir(ctx.check['steps_checked'], check_rng)
    state.maps = [None] * state.kept.k
    state.scene = rs.Scene(ctx.seed)
    state.et = program.epoch(cfg)
    map_kw = dict(degree_interval=cfg['map']['degree_interval'])
    if ctx.stand_in == 'control':
        state.entry = _control_entry(state)
    else:
        b = program.body(ctx)

        def entry(img):
            with record_function('map_img'):
                return b.map_img(img, **map_kw)

        state.body = b
        state.entry = entry if ctx.stand_in is None else ctx.stand_in(entry)
    for k in (0, 1 % len(state.pool)):  # x/y maps and kernels, then warm
        state.entry(state.pool[k])
    return state


def _reference_xy(state):
    cfg = state.ctx.config
    nx, ny = cfg['frame']
    anchors = {k: v[0] for k, v in state.scene.anchors([state.et]).items()}
    m = rs.xy2angular(cfg['disc'], anchors['diameter_arcsec'][None])[0]
    return rm.xy_maps(state.scene, anchors, m, nx, ny,
                      cfg['map']['degree_interval'], state.ctx.device)


def _reference(state, img, x, y, dtype=torch.float64):
    return rm.linear(torch.as_tensor(img[None], device=x.device).double(),
                     x, y, dtype=dtype)[0]


def _control_entry(state):
    """The reference's sampler in float32, in the program's place."""
    x, y = _reference_xy(state)

    def entry(img):
        return _reference(state, img, x, y, dtype=torch.float32).float()

    return entry


def step(state, i):
    k = int(state.order[i % TABLE])
    out = state.entry(state.pool[k])
    slot = state.kept.offer(i)
    if slot is not None:
        state.maps[slot] = (k, out)


def release(state):
    """Keep the maps the check compares, drop the program."""
    state.maps = [(k, out.cpu()) for k, out in filter(None, state.maps)]
    state.entry = None
    state.body = None


def check(state):
    x, y = _reference_xy(state)
    gap, flips = 0.0, 0
    for k, got in state.maps:
        ref = _reference(state, state.pool[k], x, y)
        g, f = compare.maps(got.numpy().reshape(ref.shape), ref.cpu().numpy())
        gap, flips = max(gap, g), flips + f
    state.counts = _counts(state, x, y)
    return dict(map_gap=gap, map_flips=flips)


def _counts(state, x, y) -> dict:
    """What the map kernel of one step must read and compute, counted
    from the reference's x/y maps and the pool's NaN cells."""
    nx, ny = state.ctx.config['frame']
    nan_img = torch.as_tensor(np.isnan(state.pool[0])[None], device=x.device)
    valid = torch.isfinite(x)
    live = ~rm._nan_rule(x, y, nan_img, ny, nx)[0]
    xs = torch.where(valid, x, 0.0)
    ys = torch.where(valid, y, 0.0)
    x0 = torch.floor(xs).long().clamp(0, nx - 2)
    y0 = torch.floor(ys).long().clamp(0, ny - 2)
    corners = torch.stack([y0 * nx + x0, y0 * nx + x0 + 1,
                           (y0 + 1) * nx + x0, (y0 + 1) * nx + x0 + 1])
    return dict(samples=x.numel(), valid_samples=int(valid.sum()),
                live_samples=int(live.sum()),
                # the coefficients the live values weight; the NaN cells
                # that the valid samples look up
                cells=int(torch.unique(corners[:, live]).numel()),
                nan_cells=int(torch.unique(corners[:, valid]).numel())
                if bool(nan_img.any()) else 0)


def work(state):
    c = state.counts
    nx, ny = state.ctx.config['frame']
    bound = bounds.map_spline_bound(
        samples=c['samples'], valid_samples=c['valid_samples'],
        live_samples=c['live_samples'],
        live_sample_frames=c['live_samples'], frames=1,
        coefficients=c['cells'], grid_cells=c['nan_cells'],
        knots=(nx + 2) + (ny + 2), kx=1, ky=1)
    return {'map_spline': dict(patterns=['map_spline_kernel'],
                               bound_ms_per_launch=bound['ms'])}
