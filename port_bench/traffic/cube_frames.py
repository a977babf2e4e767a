"""
Driver ``cube_frames``: a mapped IFU cube per step. Each step passes a host
float32 cube ``(planes, ny, nx)`` from a seeded pool to ``BodyXY.map_img``
in the mix's ``interpolation`` mode, onto the configuration's map; the
result ``(planes, *map)`` stays on the device (the default
``as_numpy=False``), and the caller holds it until the next step.

The pool holds one cube of each of the configuration's ``bands`` (its
plane count), made at set-up from the seed: a limb-darkened disc (``mu **
limb_darkening`` on the configuration's disc) times a smooth spectrum of
each spaxel (``spectral_terms`` seeded sines over the band, a seeded slope
a spaxel), plus ``noise`` of seeded unit-normal noise; NaN in every plane
outside the field's footprint (``field_arcsec`` turned by
``field_position_angle_deg`` about the frame's centre, by spaxel centre)
and at ``dead_spaxels`` seeded spaxels on the disc. The steps take the
pool's cubes in a seeded order.

The check compares, once the window has closed, every plane of the last
step's map, and ``planes_checked`` seeded planes of a seeded
``steps_checked`` of the window's steps, which the step copies into
device slots made at set-up, with the reference (:mod:`..reference.smooth`
on :mod:`..reference.scene_neptune`'s x/y maps), :data:`PLANE_BLOCK` planes
at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import program
from port_bench.reference import compare
from port_bench.reference import maps as rm
from port_bench.reference import scene as rs
from port_bench.reference import scene_neptune as rn
from port_bench.reference import smooth as rsm
from port_bench.vendor import bounds_smooth as bs
from port_bench.vendor.synthetic_kernels_neptune import write_synthetic_kernels

TABLE = 65536
#: Planes of a cube that the reference maps at once in the check
PLANE_BLOCK = 128
#: The stand-ins that put the reference in the program's place, with the
#: precision of its PCHIP grid and of its sampler's coordinates:
#: ``control`` (``control.py``) all in float32, ``control_pchip`` only the
#: PCHIP oversampling in float32 (the configuration keeps both in float64)
CONTROLS = {'control': (torch.float32, torch.float32),
            'control_pchip': (torch.float32, torch.float64)}


def _footprint(cfg) -> np.ndarray:
    """(ny, nx) bool: the spaxels whose centre lies in the field."""
    nx, ny = cfg['frame']
    w, h = (v / cfg['plate_scale_arcsec'] for v in cfg['field_arcsec'])
    pa = math.radians(cfg['field_position_angle_deg'])
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)
    dx, dy = x - (nx - 1) / 2, y - (ny - 1) / 2
    u = dx * math.cos(pa) + dy * math.sin(pa)
    v = -dx * math.sin(pa) + dy * math.cos(pa)
    return (np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)


def _cube(cfg, tr, planes: int, rng: np.random.Generator) -> np.ndarray:
    nx, ny = cfg['frame']
    x0, y0, r0, _rot = cfg['disc']
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)
    rr = np.hypot(x - x0, y - y0) / r0
    disc = np.sqrt(np.clip(1.0 - rr**2, 0.0, None)) ** tr['limb_darkening']
    t = np.linspace(0.0, 1.0, planes)[:, None, None]
    terms = tr['spectral_terms']
    amp = rng.uniform(0.02, 0.2, terms) / np.arange(1, terms + 1)
    freq = rng.uniform(0.5, 8.0, terms)
    phase = rng.uniform(0, 2 * np.pi, terms)
    spectrum = 1.0 + sum(a * np.sin(2 * np.pi * f * t + p)
                         for a, f, p in zip(amp, freq, phase))
    slope = rng.uniform(-0.2, 0.2, (ny, nx))
    cube = disc * spectrum * (1.0 + slope * (t - 0.5))
    cube += tr['noise'] * rng.standard_normal(cube.shape)
    cube[:, ~_footprint(cfg)] = np.nan
    on_disc = np.flatnonzero(rr.ravel() < 0.8)
    dead = rng.choice(on_disc, tr['dead_spaxels'], replace=False)
    cube.reshape(planes, -1)[:, dead] = np.nan
    return cube.astype(np.float32)


def inputs(ctx) -> tuple[list[np.ndarray], np.ndarray]:
    """The pool of cubes, one a band, and the order ``(TABLE,)`` in which
    the steps take them, drawn from the seed."""
    rng = program.rng(ctx, program.STREAM_POOL)
    pool = [_cube(ctx.config, ctx.traffic, n, rng)
            for n in ctx.config['bands'].values()]
    order = program.rng(ctx, program.STREAM_TRAFFIC).integers(len(pool),
                                                               size=TABLE)
    return pool, order


def _body(ctx):
    """The configuration's BodyXY on the run's device, on the kernels with
    Neptune written from the seed."""
    import planetmapper_tpu_torch as pt

    write_synthetic_kernels(ctx.kernel_dir, ctx.seed)
    pt.clear_kernels()
    pt.set_kernel_path(ctx.kernel_dir)
    cfg = ctx.config
    nx, ny = cfg['frame']
    b = pt.BodyXY(cfg['target'], utc=cfg['utc'], observer=cfg['observer'],
                  nx=nx, ny=ny, device=ctx.device,
                  aberration_correction=cfg['aberration_correction'])
    b.set_disc_params(*cfg['disc'])
    return b


def _map_kw(ctx) -> dict:
    return dict(interpolation=ctx.traffic['interpolation'],
                smooth_oversample_by=ctx.traffic['smooth_oversample_by'],
                degree_interval=ctx.config['map']['degree_interval'])


def setup(ctx):
    state = type('State', (), {})()
    state.ctx = ctx
    state.pool, state.order = inputs(ctx)
    state.check_rng = program.rng(ctx, program.STREAM_CHECK)
    state.kept = ctx.Reservoir(ctx.check['steps_checked'], state.check_rng)
    state.kept_planes = [None] * state.kept.k
    state.traced = []
    state.scene = rn.Scene(ctx.seed)
    state.et = program.epoch(ctx.config)
    if ctx.stand_in in CONTROLS:
        state.entry = _control_entry(state, CONTROLS[ctx.stand_in])
    else:
        b = _body(ctx)
        kw = _map_kw(ctx)

        def entry(cube):
            with record_function('map_img'):
                return b.map_img(cube, **kw)

        state.body = b
        state.entry = entry if ctx.stand_in is None else ctx.stand_in(entry)
    for k in list(range(len(state.pool))) * 2:  # x/y maps and kernels, then warm
        out = state.entry(state.pool[k])
    state.slots = torch.empty(
        (state.kept.k, min(ctx.check['planes_checked'], *map(len, state.pool)))
        + tuple(out.shape[1:]), dtype=torch.float32, device=ctx.device)
    _keep(out, np.arange(state.slots.shape[1]), state.slots[0])
    state.last = None
    return state


def _keep(out, planes, slot):
    torch.index_select(out, 0, torch.as_tensor(planes, device=out.device),
                       out=slot)


def _reference_xy(state):
    cfg = state.ctx.config
    nx, ny = cfg['frame']
    anchors = {k: v[0] for k, v in state.scene.anchors([state.et]).items()}
    m = rs.xy2angular(cfg['disc'], anchors['diameter_arcsec'][None])[0]
    return rn.xy_maps(state.scene, anchors, m, nx, ny,
                      cfg['map']['degree_interval'], state.ctx.device)


def _reference(state, cube, x, y, dtype=torch.float64, coord_dtype=None):
    tr = state.ctx.traffic
    frames = torch.as_tensor(cube, device=x.device).double()
    return rsm.smooth(frames, x.reshape(-1), y.reshape(-1),
                      oversample_by=tr['smooth_oversample_by'], dtype=dtype,
                      coord_dtype=coord_dtype)


def _control_entry(state, dtypes):
    """The reference with its PCHIP grid and its sampler's coordinates in
    ``dtypes``, in the program's place."""
    x, y = _reference_xy(state)

    def entry(cube):
        out = _reference(state, cube, x, y, *dtypes)
        return out.float().reshape((len(cube),) + tuple(x.shape))

    return entry


def step(state, i):
    k = int(state.order[i % TABLE])
    out = state.entry(state.pool[k])
    state.last = (k, out)
    if torch.autograd._profiler_enabled():
        state.traced.append(k)
    slot = state.kept.offer(i)
    if slot is not None:
        planes = np.sort(state.check_rng.choice(
            len(state.pool[k]), state.slots.shape[1], replace=False))
        _keep(out, planes, state.slots[slot])
        state.kept_planes[slot] = (k, planes)


def release(state):
    """Keep the last map and the slots the check compares, drop the
    program."""
    state.entry = None
    state.body = None


def check(state):
    x, y = _reference_xy(state)
    gap, flips = 0.0, 0

    def compare_planes(cube, got):
        nonlocal gap, flips
        for p in range(0, len(cube), PLANE_BLOCK):
            ref = _reference(state, cube[p:p + PLANE_BLOCK], x, y)
            g, f = compare.maps(
                got[p:p + PLANE_BLOCK].reshape(ref.shape).cpu().numpy(),
                ref.cpu().numpy())
            gap, flips = max(gap, g), flips + f

    k, out = state.last
    compare_planes(state.pool[k], out)
    for j in state.kept.filled():
        k, planes = state.kept_planes[j]
        compare_planes(state.pool[k][planes], state.slots[j])
    state.counts = [_counts(state, cube, x.reshape(-1), y.reshape(-1))
                    for cube in state.pool]
    return dict(map_gap=gap, map_flips=flips)


def _distinct(indices, mask, size: int) -> int:
    """Distinct values (all below ``size``) of ``indices`` (n, S) at ``mask``."""
    hit = torch.zeros(size, dtype=torch.bool, device=indices.device)
    hit[indices[:, mask].reshape(-1)] = True
    return int(hit.sum())


def _counts(state, cube, x, y) -> dict:
    """What the two PCHIP launches and the map_smooth launch of a step of
    ``cube`` must read, compute and write, counted from its NaN cells (the
    same in every plane) and the reference's x/y maps, for its planes."""
    tr = state.ctx.traffic
    planes, ny, nx = cube.shape
    iy0, iy1, ix0, ix1 = rsm.box(x, y, ny, nx)
    ky = rsm.factor(iy1 - iy0, tr['smooth_oversample_by'], 10_000)
    kx = rsm.factor(ix1 - ix0, tr['smooth_oversample_by'], 10_000)
    nan_img = torch.as_tensor(np.isnan(cube[:1]), device=x.device)
    cut = torch.where(nan_img, math.nan, 1.0).double()[:, iy0:iy1, ix0:ix1]
    rows = rsm.pchip_lines(cut[0], kx)
    grid = rsm.pchip_lines(rows.T.contiguous(), ky).T

    def finite(lines, out):
        ok = torch.isfinite(lines)
        cells = int(ok.sum(-1)[ok.sum(-1) >= 2].sum())
        return cells, int(torch.isfinite(out).sum()) - cells

    row_cells, row_evaluated = finite(cut[0], rows)
    col_cells, col_evaluated = finite(rows.T, grid.T)

    n_ys, n_xs = grid.shape
    valid = torch.isfinite(x)
    xs = torch.where(valid, x, 0.0)
    ys = torch.where(valid, y, 0.0)
    gy, gx = (ys - iy0) * ky, (xs - ix0) * kx
    inside = (gy >= 0) & (gy <= n_ys - 1) & (gx >= 0) & (gx <= n_xs - 1)
    outside = (xs < 0) | (ys < 0) | (xs > nx - 1) | (ys > ny - 1)
    checked = valid & inside & ~outside
    live = ~rm._nan_rule(x, y, nan_img, ny, nx)[0] & checked
    near = torch.stack([
        yy.long().clamp(0, ny - 1) * nx + xx.long().clamp(0, nx - 1)
        for yy in (torch.floor(ys), torch.ceil(ys))
        for xx in (torch.floor(xs), torch.ceil(xs))])
    corner = (torch.floor(gy).clamp(0, n_ys - 2).long() * n_xs
              + torch.floor(gx).clamp(0, n_xs - 2).long())
    corners = torch.stack([corner, corner + 1, corner + n_xs,
                           corner + n_xs + 1])
    return dict(
        planes=planes, box_cells=(iy1 - iy0) * (ix1 - ix0),
        grid_values=n_ys * n_xs, finite_cells=row_cells + col_cells,
        evaluated=row_evaluated + col_evaluated, samples=x.numel(),
        valid_samples=int(valid.sum()), live_samples=int(live.sum()),
        grid_read=_distinct(corners, live, n_ys * n_xs),
        image_cells=_distinct(near, checked, ny * nx)
        if bool(nan_img.any()) else 0)


def _bounds(c) -> tuple[float, float]:
    """The least ms of a step's oversampling and of its sampler."""
    f = c['planes']
    pchip = bs.pchip_bound(cells=f * c['box_cells'],
                           grid_values=f * c['grid_values'],
                           finite_cells=f * c['finite_cells'],
                           evaluated=f * c['evaluated'])
    sampler = bs.map_smooth_bound(
        samples=c['samples'], valid_samples=c['valid_samples'],
        live_samples=c['live_samples'],
        live_sample_frames=f * c['live_samples'], frames=f,
        grid_values=f * c['grid_read'], image_cells=f * c['image_cells'])
    return pchip['ms'], sampler['ms']


def work(state):
    """The mean bound of the traced steps' cubes."""
    bounds = [_bounds(c) for c in state.counts]
    pchip = float(np.mean([bounds[k][0] for k in state.traced]))
    sampler = float(np.mean([bounds[k][1] for k in state.traced]))
    return {'pchip': dict(patterns=['pchip_axis_kernel'],
                          bound_ms_per_step=pchip),
            'map_smooth': dict(patterns=['map_smooth_kernel'],
                               bound_ms_per_step=sampler)}
