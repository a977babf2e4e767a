"""
What the drivers take from the program under test, the port
``planetmapper_tpu_torch``, and from the reference, in one place: the
kernels written from the seed, the body a cell's configuration describes,
and the seeded streams of a run.
"""

from __future__ import annotations

import numpy as np

from .reference import scene as rs
from .vendor.synthetic_kernels import write_synthetic_kernels

#: Independent seeded streams of one run
STREAM_TRAFFIC, STREAM_CHECK, STREAM_POOL = 1, 2, 3


def rng(ctx, stream: int) -> np.random.Generator:
    return np.random.default_rng([ctx.seed, stream])


def body(ctx):
    """The configuration's BodyXY on the run's device, on kernels written
    from the seed (imported here, so that a stand-in run never loads the
    program)."""
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


def epoch(cfg) -> float:
    """TDB seconds past J2000 of the configuration's UTC."""
    date, clock = cfg['utc'].split('T')
    y, m, d = (int(v) for v in date.split('-'))
    hh, mm, ss = clock.split(':')
    return rs.utc_to_et(y, m, d, int(hh), int(mm), float(ss))
