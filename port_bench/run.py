"""
The benchmark of ``planetmapper_tpu_torch`` on an NVIDIA GPU: one run of
one cell of ``BENCHMARK.json``.

    python3 port_bench/run.py --workload jupiter_2048.backplanes \\
        --seed 7 --seconds 30 --trace 0

Prints the result as one JSON line, the last of standard output, and each
number the check compared beside its limit as the last lines of standard
error. Exits non-zero, printing no result, without a CUDA device, when
JAX or the JAX package is loaded, or when a run fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# Build and kernel caches stay at fixed paths inside the checkout; a
# library that could load JAX by itself is told not to.
os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(ROOT / 'build' / 'torch_extensions'))
os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'triton'))
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from port_bench import harness

    bench = harness.load_json(ROOT / 'BENCHMARK.json')
    cell = harness.find(bench['workloads'], args.workload, 'workload')
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        print(f'{args.workload} needs {cell["chips"]} CUDA device(s); '
              f'found {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print('modules of JAX or the JAX package were loaded: '
              + ', '.join(loaded), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in harness.summary_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == '__main__':
    sys.exit(main())
