"""Small sizes of the benchmark's cells for the CPU tests, and the
import path of the checkout."""

import sys
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Each configuration cut to a size a CPU test holds: the same scene, a
#: smaller frame with the disc at the same place in it (512^2: the control
#: of the 'linear' map, float32 sample coordinates, errs by what it errs at
#: 2048^2 only from a few hundred pixels on), a coarser map, two warm-up
#: steps
SMALL = {
    'jupiter_2048': {
        'config': {'frame': [512, 512], 'disc': [256.0, 256.0, 150.25, 12.3],
                   'map': {'degree_interval': 2}},
        'traffic': {'warmup_steps': 2}},
}

#: The one seed of the tests that build the port's bodies: the port keeps
#: one scene engine per ephemeris and epoch for the life of a process, and
#: a second kernel set loaded into the same process would be read through
#: the first one's orbits (PERF.md, Open questions)
SEED = 2**31 + 99

CELLS = ('jupiter_2048.backplanes', 'jupiter_2048.map_linear')


def small(workload: str) -> dict:
    return SMALL[workload.split('.')[0]]


def small_ctx(workload: str, seed: int, tmp_path) -> SimpleNamespace:
    """The ``ctx`` a driver's set-up gets, at the small size, on the CPU."""
    from port_bench import harness

    files = harness.cell_files(harness.load_json(ROOT / 'BENCHMARK.json'),
                               workload)
    over = small(workload)
    return SimpleNamespace(
        config=dict(files.config, **over['config']),
        traffic=dict(files.traffic, **over['traffic']), check=files.check,
        seed=seed, device=torch.device('cpu'), cuda=False,
        kernel_dir=str(tmp_path), stand_in=None, Reservoir=harness.Reservoir,
        driver=files.driver,
    )
