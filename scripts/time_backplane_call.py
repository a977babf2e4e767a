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

It uses only API that every version of the port has, so ``--tree`` can
import the package from another checkout of the repository (for example
an older commit unpacked with ``git archive``) to compare two versions on
one card. Without ``--tree`` it times the checkout it lies in.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SIZE = 2048
DISC = (1024.0, 1024.0, 819.2, 12.3)  # chip_smoke.py's frame


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', type=Path,
                        default=Path(__file__).resolve().parents[1],
                        help='checkout whose planetmapper_tpu_torch to time')
    tree = parser.parse_args().tree.resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
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
        body = pt.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01T00:00:00',
                         sz=SIZE, device=torch.device('cuda'))
        body.set_disc_params(*DISC)

        def call():
            pipeline.compute_backplanes(body, as_numpy=False)

        call()  # builds and loads the kernel
        one, back = [], []
        for _ in range(2):
            samples = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            one.append(float(np.median(samples)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            torch.cuda.synchronize()
            back.append((time.perf_counter() - t0) * 1e3 / 50)
        pt.clear_kernels()
    print(f'{card} | {tree.name}: compute_backplanes(as_numpy=False) at '
          f'{SIZE}x{SIZE}, ms per call (host clock, two turns): one '
          f'synchronised call {one}; back to back {back}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
