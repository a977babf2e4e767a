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

``--cell`` times instead the kernel on the benchmark's
``jupiter_2048.map_linear`` call (a 2048x2048 frame of its traffic, 4 NaN
blocks of 3 px, mapped in 'linear' onto the 720x1440 map) by its device
time in a ``torch.profiler`` trace, as the benchmark's
``map_spline_roofline`` reads it:

- ``map_img``: each launch of 200 ``map_img`` calls of the tree's
  package (the stages in front of the kernel as that tree runs them);
- with this checkout's package, the launch alone on the inputs of one
  such call, 100 times after each of: a 128 MB read (the L2 holds clean
  lines), a 128 MB write (up to 50 MB of dirty lines, which the launch
  writes back as it evicts them), ``map_infill`` writing the call's
  coefficients and NaN grid, the stages that wrote them before the
  infill kernel (the plain infill, the two float64 products by the
  identity inverses into the coefficient buffer and the wrapper's copy of
  the bool NaN grid to uint8), those stages then a 128 MB read, and
  nothing (back to back), in two turns.
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


def own_module(name: str = 'timing'):
    """This checkout's ``testing/<name>.py`` (``timing``, ``infill_cases``:
    numpy and torch only), loaded by path so that the package itself may
    come from ``--tree``."""
    path = ROOT / 'planetmapper_tpu_torch' / 'testing' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: The benchmark's map_linear cell (port_bench/configs/jupiter_2048.json)
CELL_SIZE = 2048
CELL_DISC = (1024.0, 1024.0, 601.0, 12.3)
CELL_MAP = dict(degree_interval=0.25)


def kernel_us(prof, pattern: str = 'map_spline_kernel') -> list[float]:
    """Device time of each launch of the kernels named ``pattern`` in a
    ``torch.profiler`` trace, us."""
    return [(e.end_ns() - e.start_ns()) * 1e-3
            for e in prof.profiler.kineto_results.events()
            if pattern in e.name() and 'CUDA' in str(e.device_type())]


def profiled_us(fn, reps: int) -> list[float]:
    """The kernel's launches in a trace of ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_us(prof)


def summary(times: list[float]) -> dict:
    import numpy as np

    return dict(launches=len(times), median_us=float(np.median(times)),
                mean_us=float(np.mean(times)))


def cell(tree, timing, card, device) -> int:
    """``--cell``: see the module's note."""
    import torch

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch.ops import interp_device
    from planetmapper_tpu_torch.ops import map_spline_kernel as msp
    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    frame = own_module('infill_cases').map_linear_frame(seed=0)[0]
    img = frame.astype('float32')  # the traffic's frames are float32
    calls = []
    wrapper = interp_device.map_spline

    def recorded(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapper(*args, **kwargs)

    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                         sz=CELL_SIZE, device=device)
        body.set_disc_params(*CELL_DISC)
        for _ in range(3):  # x/y maps, kernels, then warm
            body.map_img(img, **CELL_MAP)
        steps = summary(profiled_us(lambda: body.map_img(img, **CELL_MAP),
                                    200))
        print(f'{card} | {tree.name}: map_spline_kernel in 200 map_img calls '
              f'of the map_linear frame: {json.dumps(steps)}', flush=True)
        interp_device.map_spline = recorded
        try:
            body.map_img(img, **CELL_MAP)
        finally:
            interp_device.map_spline = wrapper
        pt.clear_kernels()
    try:
        from planetmapper_tpu_torch.ops import map_infill_kernel as mik
    except ImportError:
        return 0  # a tree without the infill kernel: map_img alone

    args, kw = calls[-1]
    prepared = timing.spline_launch_buffers(args)
    coeffs, nan_u8 = prepared[5], prepared[6]
    frames = torch.from_numpy(frame[None]).to(device)
    finite = torch.empty(1, dtype=torch.int32, device=device)
    eye = torch.eye(CELL_SIZE, dtype=torch.float64, device=device)
    big = torch.empty(timing.FLUSH_BYTES // 4, device=device)
    want = (coeffs.clone(), nan_u8.clone())

    def infill_kernel():
        mik.launch(frames, coeffs, nan_u8.view(torch.bool), finite)

    def plain_stages():
        cleaned = frames.clone()
        cleaned[0], nans = mik.infill_plain(frames[0])
        torch.matmul(eye, torch.matmul(cleaned, eye.T), out=coeffs)
        nan_u8.copy_(nans)

    stages = {
        'a 128 MB read': big.sum,
        'a 128 MB write': lambda: big.fill_(1.0),
        'map_infill': infill_kernel,
        'plain infill and identity products': plain_stages,
        'plain infill and identity products, then a 128 MB read':
            lambda: (plain_stages(), big.sum()),
        'nothing (back to back)': lambda: None,
    }
    for name, stage in stages.items():
        stage()
        if not (torch.equal(coeffs, want[0]) and
                torch.equal(nan_u8, want[1])):
            print(f'FAIL: after {name!r} the launch has other inputs')
            return 1
    times = {name: [] for name in stages}
    for turn in (list(stages), list(stages)[::-1]):
        for name in turn:
            def step(stage=stages[name]):
                stage()
                msp.launch(*prepared, **kw)
            times[name] += profiled_us(step, 50)
    print(f'{card} | {tree.name}: map_spline_kernel launched alone on the '
          'inputs of one map_linear call, 100 times after each stage (two '
          'turns of 50): ' + json.dumps(
              {k: summary(v) for k, v in times.items()}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', type=Path, default=ROOT,
                        help='checkout whose planetmapper_tpu_torch to time')
    parser.add_argument('--cell', action='store_true',
                        help="the benchmark's map_linear call instead")
    options = parser.parse_args()
    tree = options.tree.resolve()
    timing = own_module()
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
    if options.cell:
        return cell(tree, timing, card, device)

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
