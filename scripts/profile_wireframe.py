"""
Profile the wireframe's geometry on the host: the artist specs
(``_body_plotting._wireframe_artists``) of ``chip_smoke.py``'s
``[wireframe]`` body (the 2048x2048 frame and disc, Io and Amalthea as
other bodies of interest, a ring and a coordinate of interest), on the
synthetic kernels with the satellites. Every call of a wireframe is under
the bulk threshold, so it runs on CPU tensors whatever the body's device.

Builds the artists once (the engines, caches and first calls), then again
under ``cProfile``, and prints both host-clock times and the functions
with the most cumulative time.

    python3 scripts/profile_wireframe.py [--device cuda] [--top N]
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import planetmapper_tpu_torch as pt  # noqa: E402
from planetmapper_tpu_torch import _body_plotting  # noqa: E402
from planetmapper_tpu_torch.testing.synthetic_kernels import (  # noqa: E402
    write_synthetic_kernels,
)
from planetmapper_tpu_torch.testing.timing import DISC, SIZE, UTC  # noqa: E402

WIREFRAME_KW = dict(grid_interval=30, grid_lat_limit=90,
                    planetocentric_grid=False, indicate_equator=False,
                    indicate_prime_meridian=False, label_poles=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default='cpu')
    parser.add_argument('--top', type=int, default=15)
    args = parser.parse_args()
    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0, satellites=True)
        pt.set_kernel_path(kdir)
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                         device=args.device)
        body.set_disc_params(*DISC)
        body.add_other_bodies_of_interest('IO', 505)
        body.ring_radii.add(129000.0)
        body.coordinates_of_interest_lonlat.append(
            (round(body.subpoint_lon) + 5.0, 10.0))
        for label in ('first', 'profiled'):
            profile = cProfile.Profile() if label == 'profiled' else None
            t0 = time.perf_counter()
            if profile:
                profile.enable()
            specs = list(_body_plotting._wireframe_artists(body,
                                                           **WIREFRAME_KW))
            if profile:
                profile.disable()
            print(f'{label}: {len(specs)} artists in '
                  f'{(time.perf_counter() - t0) * 1e3:.1f} ms on the host '
                  f'({torch.__version__}, body device {body.device})',
                  flush=True)
        pstats.Stats(profile).sort_stats('cumulative').print_stats(args.top)
        pt.clear_kernels()
    return 0


if __name__ == '__main__':
    sys.exit(main())
