#!/usr/bin/env python3
"""
Time of the port's 'smooth' stage and of its x/y maps on one NVIDIA GPU,
for comparing two checkouts of the repository on one card.

    python3 scripts/time_smooth.py [--tree DIR]

Builds the 150x150 Jupiter frame of ``chip_smoke.py`` (synthetic SPICE
kernels written at run time) on the card and maps chip_smoke's seeded
images onto the 720x1440 0.25-degree map with
``BodyXY.map_img(interpolation='smooth')``. It reports, with the timers of
``chip_smoke.py`` (``planetmapper_tpu_torch/testing/timing.py``):

- the body's x/y maps, ``_get_map_samples``: host clock, synchronised, one
  call (the first; they are cached per map and disc);
- the 16-frame cube, ``map_img(cube)`` with the maps left on the card:
  host clock per frame, one synchronised call, median of 10;
- one blocked ``map_img(frame with a NaN block, as_numpy=True)``: host
  clock, median of 10;
- ``map_smooth``'s launch on the inputs ``map_img`` hands its wrapper for
  the clean frame: cold (one launch right after a read of a 128 MB
  buffer, median of 50) and warm (200 back to back), CUDA events, two
  turns; and a cold ``torch.sum`` over as many bytes as those buffers hold.

The timers and images come from this checkout; the package comes from
``--tree`` (default: this checkout), so that another checkout (for example
the parent commit unpacked with ``git archive``) is timed the same way.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
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
    from planetmapper_tpu_torch.ops import map_smooth_kernel as msk
    from planetmapper_tpu_torch.ops import pchip_device
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
    device = torch.device('cuda')
    kw = dict(interpolation='smooth', **timing.MAP_KW)
    calls = []
    wrapper = pchip_device.map_smooth

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapper(*args, **kwargs)

    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                         sz=150, device=device)
        body.set_disc_params(*timing.MAP_BODIES[150])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        body._get_map_samples(**timing.MAP_KW)
        torch.cuda.synchronize()
        xy_ms = (time.perf_counter() - t0) * 1e3
        frame, with_nan, cube = timing.map_images(150, 150)
        pchip_device.map_smooth = recorded
        try:
            body.map_img(frame, **kw)
        finally:
            pchip_device.map_smooth = wrapper
        host = timing.in_turns({
            'cube per frame': (lambda: body.map_img(cube, **kw), 10),
            'blocked frame': (lambda: body.map_img(with_nan, as_numpy=True,
                                                   **kw), 10),
        }, timing.host_clock_ms)
        pt.clear_kernels()
    host['cube per frame'] = [t / cube.shape[0]
                              for t in host['cube per frame']]

    args, launch_kw = calls[0]
    prepared = timing.smooth_launch_buffers(args)
    n_bytes = sum(t.numel() * t.element_size() for t in prepared)
    fns = {
        'map_smooth': lambda: msk.launch(*prepared, **launch_kw),
        f'torch.sum of as many bytes ({n_bytes / 1e6:.2f} MB)':
            timing.sum_yardstick(n_bytes, device),
    }
    flush = timing.l2_flush(device)
    cold = timing.in_turns({k: (fn, 50) for k, fn in fns.items()},
                           lambda fn, n: timing.cold_time_ms(fn, n, flush))
    warm = timing.in_turns({k: (fn, 200) for k, fn in fns.items()},
                           timing.cuda_time_ms)
    result = {
        'x/y maps, first call (host clock)': xy_ms,
        **host,
        **{f'{k}, cold': v for k, v in cold.items()},
        **{f'{k}, warm': v for k, v in warm.items()},
    }
    print(f'{card} | {tree.name}: 150^2 smooth onto the 720x1440 map, ms '
          '(two turns where a list): ' + json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
