"""
The control of a cell's check: the reference, computed in float32 (the
precision below the configuration's float64 geometry), put in the
program's place and run through the cell's driver and check, on each of
``--seeds``, in one process. Its numbers are the upper readings that a
cell's limits lie below (``PERF.md`` gives them); the benchmark's own runs
never run it.

    python3 port_bench/control.py --workload jupiter_2048.backplanes \\
        --seeds 11,12,13 --steps 3

Prints one JSON line per seed with the numbers compared and their limits.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, steps: int, *, device: str = 'cuda',
             overrides=None) -> list[dict]:
    """The control's check on each seed: ``[{seed, correct, checks}]``."""
    from port_bench import harness

    out = []
    for seed in seeds:
        result = harness.run_cell(workload, seed, 0.0, False, device=device,
                                  overrides=overrides, stand_in='control',
                                  steps=steps)
        out.append(dict(seed=seed, correct=result['correct'],
                        checks=result['checks']))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True,
                        help='comma-separated seeds')
    parser.add_argument('--steps', type=int, default=3)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print('the control runs on a CUDA device', file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(',')]
    for line in readings(args.workload, seeds, args.steps):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
