#!/usr/bin/env python3
"""
Device time of layouts of the port's map smooth kernel on one NVIDIA GPU,
at the 150x150 'smooth' frame and 16-frame cube of ``chip_smoke.py``.

    python3 scripts/time_map_smooth_variants.py [--parent DIR]

``scripts/map_smooth_layouts.cu``, beside this script, fixes the kernel's
layout at compile time (samples per thread, frames whose corners are in
flight at once, a persistent grid, resident blocks asked of ptxas;
``MAP_SMOOTH_*``); the package's ``csrc/map_smooth.cu`` hard-codes the kept
one. This script builds each layout of :data:`VARIANTS` and the package's
kernel with nvcc (one process each, at once), records
the inputs ``BodyXY.map_img(interpolation='smooth')`` hands the kernel's
wrapper for chip_smoke's clean frame and its cube onto the 720x1440
0.25-degree map (synthetic SPICE kernels written at run time), checks each
layout's output against the plain version, and times each launch with the
timers of ``chip_smoke.py`` (``planetmapper_tpu_torch/testing/timing.py``,
CUDA events, two turns): cold (one launch right after a read of a 128 MB
buffer, median of 50) and warm (200 back to back). Prints registers and
resident blocks per SM of each layout. ``--parent DIR`` adds the kernel
source of another checkout (for example the parent commit unpacked with
``git archive``; its C launch function must take the same arguments).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: name: (samples a thread, frames in flight, persistent grid, min blocks)
VARIANTS = {
    's1 f1': (1, 1, 0, 1),
    's1 f1 6 blocks': (1, 1, 0, 6),
    's1 f1 8 blocks': (1, 1, 0, 8),
    's1 f2': (1, 2, 0, 1),
    's1 f4': (1, 4, 0, 1),
    's2 f1 4 blocks': (2, 1, 0, 4),
    's2 f2 persistent': (2, 2, 1, 1),
}


def main() -> int:
    import argparse
    import ctypes

    import numpy as np
    import torch

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch.ops import cuda_build
    from planetmapper_tpu_torch.ops import map_smooth_kernel as msk
    from planetmapper_tpu_torch.ops import pchip_device
    from planetmapper_tpu_torch.testing import timing
    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--parent', type=Path, default=None,
                        help='checkout whose csrc/map_smooth.cu to add')
    parent = parser.parse_args().parent
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device('cuda')
    study = Path(__file__).resolve().parent / 'map_smooth_layouts.cu'
    libraries = {
        name: cuda_build.CudaLibrary(
            'map_smooth_' + name.replace(' ', '_'), study,
            msk._configure, flags=(
                f'-DMAP_SMOOTH_SAMPLES={s}', f'-DMAP_SMOOTH_FRAMES={f}',
                f'-DMAP_SMOOTH_PERSISTENT={pers}',
                f'-DMAP_SMOOTH_MIN_BLOCKS={blocks}'))
        for name, (s, f, pers, blocks) in VARIANTS.items()
    }
    libraries['package'] = msk.LIBRARY
    if parent is not None:
        def configure_launch(lib):
            lib.map_smooth_launch.restype = ctypes.c_int
            lib.map_smooth_launch.argtypes = \
                msk.LIBRARY.load().map_smooth_launch.argtypes

        libraries['parent'] = cuda_build.CudaLibrary(
            'map_smooth_parent', (parent.resolve() / 'planetmapper_tpu_torch'
                                  / 'csrc' / 'map_smooth.cu'),
            configure_launch)
    cuda_build.build_all(list(libraries.values()))

    calls = {}
    wrapper = pchip_device.map_smooth

    def recorded(*args, **kwargs):
        calls[current] = (args, kwargs)
        return wrapper(*args, **kwargs)

    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                         sz=150, device=device)
        body.set_disc_params(*timing.MAP_BODIES[150])
        frame, _, cube = timing.map_images(150, 150)
        pchip_device.map_smooth = recorded
        try:
            for current, img in (('frame', frame), ('cube', cube)):
                body.map_img(img, interpolation='smooth', **timing.MAP_KW)
        finally:
            pchip_device.map_smooth = wrapper
        pt.clear_kernels()

    def launcher(lib, prepared, kw):
        x, y, valid, grid, nan_img, any_nan, out = prepared
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = lib.map_smooth_launch(
                x.data_ptr(), y.data_ptr(), valid.data_ptr(),
                grid.data_ptr(), grid.shape[1], grid.shape[2],
                float(kw['iy0']), float(kw['ix0']), float(kw['y_step']),
                float(kw['x_step']), nan_img.data_ptr(), any_nan.data_ptr(),
                nan_img.shape[-2], nan_img.shape[-1],
                int(kw['propagate_nan']), out.data_ptr(), x.shape[0],
                grid.shape[0], stream)
            cuda_build.check_launch(rc, 'map smooth variant')
        return launch

    occupancy, fns = {}, {}
    for name, library in libraries.items():
        lib = library.load()
        if hasattr(lib, 'map_smooth_occupancy'):
            values = [ctypes.c_int() for _ in range(3)]
            cuda_build.check_launch(
                lib.map_smooth_occupancy(*map(ctypes.byref, values)), name)
            occupancy[name] = [v.value for v in values]
        for case, (args, kw) in calls.items():
            prepared = timing.smooth_launch_buffers(args)
            launch = launcher(lib, prepared, kw)
            launch()
            got = prepared[-1].cpu().numpy()
            ref = msk.map_smooth_plain(*args, **kw).cpu().numpy()
            if not np.array_equal(np.isnan(got), np.isnan(ref)):
                print(f'FAIL: {name} {case}: NaN mask differs')
                return 1
            fns[f'{name} | {case}'] = launch
    flush = timing.l2_flush(device)
    cold = timing.in_turns({k: (fn, 50) for k, fn in fns.items()},
                           lambda fn, n: timing.cold_time_ms(fn, n, flush))
    warm = timing.in_turns({k: (fn, 200) for k, fn in fns.items()},
                           timing.cuda_time_ms)
    print(f'{card} | map_smooth layouts: registers, local bytes, blocks of '
          '256 per SM: ' + json.dumps(occupancy), flush=True)
    print(f'{card} | map_smooth layouts, ms per launch on the 720x1440 map '
          '(CUDA events, two turns each): ' + json.dumps(
              {k: {'cold': cold[k], 'warm': warm[k]} for k in fns}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
