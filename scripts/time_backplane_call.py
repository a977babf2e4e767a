#!/usr/bin/env python3
"""
Host-clock time of the port's public backplane call on one NVIDIA GPU.

    python3 scripts/time_backplane_call.py [--tree DIR]

Builds the 2048x2048 Jupiter frame of ``chip_smoke.py`` (synthetic SPICE
kernels written at run time) on the card and times
``pipeline.compute_backplanes(body, as_numpy=False)``, the planes left on
the card, as a caller pays for it: one call followed by a synchronise (the
median of 20), and 50 calls back to back with one synchronise at the end
(per call), each in two turns, beside the card's name and power limit.

The timers and the frame come from this checkout
(``planetmapper_tpu_torch/testing/timing.py``, shared with
``chip_smoke.py``); the package comes from ``--tree`` (default: this
checkout), and only API that every version of the port has is called, so
that another checkout of the repository (for example an older commit
unpacked with ``git archive``) is timed the same way on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def own_timing():
    """This checkout's ``testing/timing.py`` (numpy and torch only),
    loaded by path so that the package itself may come from ``--tree``."""
    path = ROOT / 'planetmapper_tpu_torch' / 'testing' / 'timing.py'
    spec = importlib.util.spec_from_file_location('timing', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', type=Path, default=ROOT,
                        help='checkout whose planetmapper_tpu_torch to time')
    tree = parser.parse_args().tree.resolve()
    timing = own_timing()
    sys.path.insert(0, str(tree))

    import torch

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch import pipeline
    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                         sz=timing.SIZE, device=torch.device('cuda'))
        body.set_disc_params(*timing.DISC)

        def call():
            pipeline.compute_backplanes(body, as_numpy=False)

        # the first call builds and loads the kernel
        one = timing.in_turns({'call': (call, 20)}, timing.host_clock_ms)
        back = timing.in_turns({'call': (call, 50)}, timing.back_to_back_ms)
        pt.clear_kernels()
    size = timing.SIZE
    print(f'{card} | {tree.name}: compute_backplanes(as_numpy=False) at '
          f'{size}x{size}, ms per call (host clock, two turns): one '
          f'synchronised call {one["call"]}; back to back {back["call"]}',
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
