#!/usr/bin/env python3
"""
Host-clock time of a cold ``python -m planetmapper_tpu_torch --prewarm``
on one NVIDIA GPU, with the session warm off and on.

    python3 scripts/time_cold_start.py [--pairs N] [--size SIZE]

Writes the synthetic SPICE kernels, runs one untimed ``--prewarm`` (it
builds the kernel libraries into ``build/``, so the timed runs load them),
then ``--pairs`` pairs of fresh subprocesses in turns (off, on, on, off,
...) with ``PLANETMAPPER_TPU_SESSION_WARM=0`` and ``=1``, each timed from
start to exit. Prints every run with its output lines, each setting's
runs, median and spread, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def prewarm(kernel_dir: str, size: int, warm: str) -> tuple[float, str]:
    """Seconds of one ``--prewarm size`` subprocess and its output."""
    env = dict(os.environ, PLANETMAPPER_KERNEL_PATH=kernel_dir,
               PLANETMAPPER_TPU_SESSION_WARM=warm)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'planetmapper_tpu_torch', '--prewarm',
         str(size)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f'--prewarm {size} failed:\n{proc.stdout}\n'
                         f'{proc.stderr}')
    return seconds, '; '.join(proc.stdout.splitlines())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--pairs', type=int, default=4,
                        help='pairs of runs with the warm off and on')
    parser.add_argument('--size', type=int, default=2048,
                        help='image size of the prewarm')
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    if not torch.cuda.is_available():
        print('FAIL: no CUDA device', flush=True)
        return 1
    card = card_line()
    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir)
        seconds, lines = prewarm(kdir, args.size, '0')
        print(f'untimed first run (builds into build/): {seconds:.3f} s; '
              f'{lines}', flush=True)
        turns = ('0', '1', '1', '0') * (args.pairs // 2) + \
            ('0', '1') * (args.pairs % 2)
        runs = {'0': [], '1': []}
        for warm in turns:
            seconds, lines = prewarm(kdir, args.size, warm)
            runs[warm].append(seconds)
            print(f'{card} | cold --prewarm {args.size}, '
                  f'PLANETMAPPER_TPU_SESSION_WARM={warm}: {seconds:.3f} s; '
                  f'{lines}', flush=True)
    for warm, name in (('0', 'off'), ('1', 'on')):
        values = runs[warm]
        print(f'{card} | session warm {name}: {values} s; median '
              f'{statistics.median(values):.3f} s, spread '
              f'{max(values) - min(values):.3f} s', flush=True)
    print(f'{card} | median on - off: '
          f'{statistics.median(runs["1"]) - statistics.median(runs["0"]):.3f}'
          f' s', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
