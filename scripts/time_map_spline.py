#!/usr/bin/env python3
"""
Device time of the port's map spline kernel on one NVIDIA GPU, cold and
warm, at the three map_spline calls that ``chip_smoke.py`` times.

    python3 scripts/time_map_spline.py [--tree DIR]

Builds the 150x150 and 1024x1024 Jupiter frames of ``chip_smoke.py``
(synthetic SPICE kernels written at run time) on the card, maps the same
seeded images onto the 720x1440 0.25-degree map through ``BodyXY.map_img``
('linear' and 'cubic' from 150^2, 'cubic' with a NaN block from 1024^2),
records the inputs ``map_img`` hands the kernel's wrapper, and times the
kernel's launch on them with the timers of ``chip_smoke.py``
(``planetmapper_tpu_torch/testing/timing.py``, CUDA events, two turns):

- cold: one launch right after a read of a 128 MB buffer (larger than the
  50 MB L2), the events around the launch alone, median of 50;
- warm: 200 launches back to back between two events, queued behind a
  device-side sleep, per launch.

Where the tree's wrapper takes knot descriptors (``uniform``), it also
times the kernel's search path on the same inputs (``uniform=None``). As
a yardstick of what one launch of this size costs, it times the same ways
one ``torch.sum`` over as many bytes as the call's buffers hold (each
input read once, each output written once).

The timers and frames come from this checkout; the package comes from
``--tree`` (default: this checkout), so that another checkout of the
repository (for example an older commit unpacked with ``git archive``) is
timed the same way on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ((150, 'linear', False), (150, 'cubic', False), (1024, 'cubic', True))


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
    from planetmapper_tpu_torch.ops import interp_device
    from planetmapper_tpu_torch.ops import map_spline_kernel as msp
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

    calls = {}
    wrapper = interp_device.map_spline

    def recorded(*args, **kwargs):
        calls[current] = (args, kwargs)
        return wrapper(*args, **kwargs)

    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        interp_device.map_spline = recorded
        try:
            for size, disc in timing.MAP_BODIES.items():
                body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                                 sz=size, device=device)
                body.set_disc_params(*disc)
                # chip_smoke.py's images
                frame, with_nan, _ = timing.map_images(size, size)
                for case in CASES:
                    if case[0] == size:
                        current = case
                        body.map_img(with_nan if case[2] else frame,
                                     interpolation=case[1], **timing.MAP_KW)
        finally:
            interp_device.map_spline = wrapper
        pt.clear_kernels()
    torch.cuda.synchronize()

    fns = {}
    for case in CASES:
        args, kw = calls[case]
        prepared = timing.spline_launch_buffers(args)
        name = f'{case[0]}^2 {case[1]}' + (' with_nan' if case[2]
                                            else ' frame')
        paths = {'': kw}
        if 'uniform' in kw:
            paths[' (search path)'] = dict(kw, uniform=None)
        for suffix, path_kw in paths.items():
            def fn(prepared=prepared, path_kw=path_kw):
                msp.launch(*prepared, **path_kw)
            fns[name + suffix] = fn
        # a yardstick, not the kernel: one library launch (torch.sum) that
        # reads as many bytes as the call's buffers hold
        n_bytes = sum(t.numel() * t.element_size() for t in prepared)
        fns[name + ' (torch.sum of as many bytes)'] = torch.ones(
            n_bytes // 4, device=device).sum
    flush = timing.l2_flush(device)
    cold = timing.in_turns({k: (fn, 50) for k, fn in fns.items()},
                           lambda fn, n: timing.cold_time_ms(fn, n, flush))
    warm = timing.in_turns({k: (fn, 200) for k, fn in fns.items()},
                           timing.cuda_time_ms)
    results = {k: {'cold': cold[k], 'warm': warm[k]} for k in fns}
    print(f'{card} | {tree.name}: map_spline ms per launch on the 720x1440 '
          'map (CUDA events, two turns each): ' + json.dumps(results),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
