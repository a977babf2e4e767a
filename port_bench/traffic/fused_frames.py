"""
Driver ``fused_frames``: a navigated frame per step. Each step moves the
disc by a seeded offset (``dx_px``, ``dy_px`` in x0 and y0, ``dr_fraction``
of r0) with ``BodyXY.set_disc_params`` and asks for every default
backplane with ``BodyXY.generate_backplanes_fused()`` (numpy planes). The
caller keeps each step's planes until the next step's have come, as a
loop over frames does. Set-up warms the path with ``warmup_steps`` steps:
the first few copies of the planes to numpy land in fresh host pages and
take 4-6 times as long as the later ones.

The check compares, with the reference's planes of the same disc, every
pixel of every plane of the window's last step, and ``rows_checked``
seeded rows of every plane of a seeded sample of the window's steps
(``steps_checked``). A sampled step's rows are copied into slots allocated
at set-up, so that keeping them allocates nothing in the window.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from port_bench import program
from port_bench.reference import backplanes as rb
from port_bench.reference import compare
from port_bench.reference import scene as rs
from port_bench.vendor import bounds

#: Offsets drawn ahead of the window (steps past it reuse them in turn)
TABLE = 65536


def inputs(ctx) -> np.ndarray:
    """The steps' discs ``(TABLE, 4)``, drawn from the seed."""
    tr = ctx.traffic
    x0, y0, r0, rot = ctx.config['disc']
    u = program.rng(ctx, program.STREAM_TRAFFIC).uniform(-1, 1, (TABLE, 3))
    return np.stack([x0 + tr['dx_px'] * u[:, 0], y0 + tr['dy_px'] * u[:, 1],
                     r0 * (1 + tr['dr_fraction'] * u[:, 2]),
                     np.full(TABLE, rot)], axis=1)


def setup(ctx):
    cfg, tr, chk = ctx.config, ctx.traffic, ctx.check
    nx, ny = cfg['frame']
    discs = inputs(ctx)
    state = type('State', (), {})()
    state.ctx, state.discs = ctx, discs
    check_rng = program.rng(ctx, program.STREAM_CHECK)
    state.kept = ctx.Reservoir(chk['steps_checked'], check_rng)
    n_rows = min(chk['rows_checked'], ny)
    state.rows = np.sort(np.stack([check_rng.choice(ny, n_rows, replace=False)
                                   for _ in range(chk['steps_checked'])]), 1)
    state.scene = rs.Scene(ctx.seed)
    state.et = program.epoch(cfg)
    state.body = None
    state.last = None
    if ctx.stand_in == 'control':
        state.entry = _control_entry(state)
    else:
        b = program.body(ctx)

        def entry(disc):
            with record_function('set_disc_params'):
                b.set_disc_params(*disc)
            with record_function('generate_backplanes_fused'):
                return b.generate_backplanes_fused()

        state.body = b
        state.entry = entry if ctx.stand_in is None else ctx.stand_in(entry)
    out = None
    warmup = 1 if ctx.stand_in == 'control' else tr.get('warmup_steps', 2)
    for i in range(warmup):
        out = state.entry(discs[-1 - i])
    state.slots = {k: np.empty((chk['steps_checked'], n_rows, nx), v.dtype)
                   for k, v in out.items()}
    return state


def _control_entry(state):
    """The reference in float32, in the program's place."""
    nx, ny = state.ctx.config['frame']
    anchors = {k: v[0] for k, v in state.scene.anchors([state.et]).items()}

    def entry(disc):
        m = rs.xy2angular(disc, anchors['diameter_arcsec'][None])[0]
        return rb.planes(anchors, m, disc, nx, ny, state.ctx.device,
                         dtype=torch.float32)

    return entry


def step(state, i):
    disc = state.discs[i % TABLE]
    out = state.entry(disc)
    state.last = (i, out)
    slot = state.kept.offer(i)
    if slot is not None:
        for k, v in out.items():
            np.take(np.asarray(v), state.rows[slot], axis=0,
                    out=state.slots[k][slot])


def release(state):
    state.entry = None
    state.body = None


def check(state):
    ctx = state.ctx
    nx, ny = ctx.config['frame']
    anchors = {k: v[0] for k, v in state.scene.anchors([state.et]).items()}
    last, whole = state.last
    state.last = None
    compared = [(last, None, whole)] + [
        (state.kept.steps[slot], state.rows[slot],
         {k: v[slot] for k, v in state.slots.items()})
        for slot in state.kept.filled()]
    gap, flips, worst = 0.0, 0, {}
    for i, rows, got in compared:
        disc = state.discs[i % TABLE]
        m = rs.xy2angular(disc, anchors['diameter_arcsec'][None])[0]
        if rows is None:
            ref = rb.planes(anchors, m, disc, nx, ny, ctx.device)
            state.on_disc_share = float(np.isfinite(ref['EMISSION']).mean())
        else:
            ref = rb.rows(anchors, m, disc, nx, rows, ctx.device)
        g, f, each = compare.planes(got, ref, rs.RADII[0])
        gap, flips = max(gap, g), flips + f
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in each.items()}
        del ref
    state.notes = [f'plane_gap of {k}: {v!r}' for k, v in
                   sorted(worst.items(), key=lambda kv: -kv[1])[:6]]
    return dict(plane_gap=gap, mask_flips=flips)


def work(state):
    nx, ny = state.ctx.config['frame']
    n_disc = int(round(state.on_disc_share * nx * ny))
    bound = bounds.backplane_bound(nx, ny, n_disc)
    return {'kernel1': dict(patterns=['backplanes26_kernel'],
                            bound_ms_per_launch=bound['ms']),
            'd2h_bytes_per_step': nx * ny * bounds.BACKPLANE_BYTES_PER_PIXEL}
