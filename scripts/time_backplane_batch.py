#!/usr/bin/env python3
"""
Device time of kernel 1's routes for a batch of frames (``csrc/
backplanes.cu``) on one NVIDIA GPU, in turns with another checkout's
kernel.

    python3 scripts/time_backplane_batch.py [--parent DIR]

A batch takes, by the frame's size (``ops/backplanes_kernel.py``
``frame_route`` and ``batch_plan``), one launch of the single-frame kernel
a frame, or the batched kernel in the single-frame kernel's 32x8 tiles or
in linear blocks of 256 consecutive pixels of one frame. At each case of
:data:`CASES` (chip_smoke.py's 8 disc sets at 2048x2048 and at smaller
frames, 26 planes: the sizes about the route's threshold,
``FRAME_LAUNCH_PIXELS``, and the layouts'; bench.py:343's 1000 epochs at
50x50, all 26 planes and EMISSION and LON-GRAPHIC), on synthetic SPICE
kernels written at run time, this script checks each batched layout
(``TILE_FILL`` forcing it) against the single-frame launches bit for bit,
and times the three routes in turns (CUDA events over calls queued behind a
device-side sleep, and for the time series one call after an L2 flush too;
``planetmapper_tpu_torch/testing/timing.py``). A route's time is the
kernel's launches alone (``impl._launch``) on scenes packed once, and for
the linear blocks uploaded once; the wrapper's whole call, ``impl.frames``
by the default route, which packs the scenes and uploads them where the
linear blocks read them, is timed beside them. It prints each build's
registers, spills and resident blocks per SM.

``--parent DIR`` adds another checkout's ``csrc/backplanes.cu`` (one with
this C interface, for example the parent commit unpacked with ``git
archive``): built beside this one's and timed in every case in turns with
it, through this checkout's wrapper.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: (frames, size, planes) of the timed cases: chip_smoke's disc sweep at
#: 2048^2 and smaller frames of it, and bench.py:343's time series
CASES = [(8, 2048, None), (8, 1024, None), (8, 896, None), (8, 768, None),
         (8, 640, None), (8, 512, None), (8, 448, None), (8, 384, None),
         (8, 300, None), (8, 256, None), (8, 200, None), (8, 100, None),
         (200, 128, None), (1000, 64, ('EMISSION', 'LON-GRAPHIC')),
         (1000, 50, None), (1000, 50, ('EMISSION', 'LON-GRAPHIC'))]

#: The batched kernel's layouts, by the TILE_FILL that forces each
LAYOUTS = {'tiles': 0.0, 'linear blocks': 2.0}


def main() -> int:

    import numpy as np
    import torch

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch import pipeline
    from planetmapper_tpu_torch.ops import backplanes_kernel as bk
    from planetmapper_tpu_torch.ops import cuda_build
    from planetmapper_tpu_torch.parallel import timeseries
    from planetmapper_tpu_torch.testing import timing
    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--parent', type=Path, default=None,
                        help='checkout whose kernel to time in turns with '
                             "this one's")
    parent = parser.parse_args().parent
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device('cuda', torch.cuda.current_device())
    libraries = {'this checkout': bk.LIBRARY}
    if parent is not None:
        libraries['parent'] = cuda_build.CudaLibrary(
            'backplanes26_parent',
            parent.resolve() / 'planetmapper_tpu_torch' / 'csrc'
            / 'backplanes.cu', bk._configure)
    cuda_build.build_all(list(libraries.values()))
    loaded = {name: library.load() for name, library in libraries.items()}
    tile_fill, tile_pixels = bk.TILE_FILL, bk.TILE_PIXELS

    def use(lib, fill=tile_fill):
        bk.LIBRARY._lib = lib
        bk.TILE_FILL = fill
        # forced tiles (fill 0) take frames of any size
        bk.TILE_PIXELS = tile_pixels if fill else 0

    for name, library in libraries.items():
        for line in library.ptxas_log().splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}')
        use(loaded[name])
        for layout, which in (('single frame', None),
                              ('batched, linear blocks', 'linear'),
                              ('batched, tiles', 'tiles')):
            occ = bk.occupancy(which)
            print(f'[build] {name}: {layout} {occ["registers"]} registers, '
                  f'{occ["local_bytes"]} bytes of local memory, '
                  f'{occ["blocks_per_sm"]} blocks per SM')
    use(loaded['this checkout'])

    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        cases = {}
        for n, size, planes in CASES:
            body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                             sz=size, device=device)
            scale = size / timing.SIZE
            x0, y0, r0 = (v * scale for v in timing.DISC[:3])
            body.set_disc_params(x0, y0, r0, timing.DISC[3])
            if n <= 8:
                # chip_smoke.py's disc sweep
                step = (np.arange(n) - (n - 1) / 2) / 100.0
                discs = np.stack([x0 + 2 * r0 * step, y0 - r0 * step,
                                  r0 * (1 + step),
                                  timing.DISC[3] + 500 * step], axis=1)
                xys = []
                for disc in discs:
                    body.set_disc_params(*disc)
                    xys.append(np.array(body._get_xy2angular_matrix()))
                _, _, radii, anchors = pipeline.pipeline_inputs(body)
                frames = (np.array(xys), discs, radii, anchors)
            else:
                body.set_disc_params(size / 2, size / 2, size * 0.4, 0.0)
                ets = body.et + 60.0 * np.arange(n)
                anchors, xy = timeseries._batched_pipeline_inputs(body, ets)
                frames = (xy, np.broadcast_to(body.get_disc_params(), (n, 4)),
                          np.asarray(body.radii), anchors)
            impl, _ = pipeline.select_pipeline_impl(body, size, size,
                                                    planes=planes)
            label = f'{n} x {size}^2, {planes or "26 planes"}'
            cases[label] = (impl, size, frames)
        pt.clear_kernels()

    flush = timing.l2_flush(device)
    for label, (impl, size, frames) in cases.items():
        n = len(frames[0])
        scenes = bk.pack_scenes(*frames)
        scenes_dev = torch.from_numpy(scenes).to(device)

        def call(frame_launches, lib, fill=tile_fill):
            use(lib, fill)
            linear = not (frame_launches or bk.batch_plan(n, size,
                                                          size).tiles)
            return impl._launch(scenes_dev if linear else scenes, size, size,
                                device=device, frame_launches=frame_launches)

        def whole_call():
            use(loaded['this checkout'])
            return impl.frames(size, size, *frames, device=device)

        reference = call(True, loaded['this checkout'])
        runs = {'this checkout: the call (impl.frames)': (whole_call, 5)}
        for name, lib in loaded.items():
            runs[f'{name}: single-frame launches'] = (
                lambda lib=lib: call(True, lib), 5)
            for layout, fill in LAYOUTS.items():
                out = call(False, lib, fill)
                for k, plane in reference.items():
                    if not torch.equal(torch.nan_to_num(out[k]),
                                       torch.nan_to_num(plane)):
                        print(f'FAIL: {name} {label}: {k} in {layout} '
                              'differs from the single-frame launches')
                        return 1
                runs[f'{name}: batched, {layout}'] = (
                    lambda lib=lib, fill=fill: call(False, lib, fill), 5)
        del reference, out
        use(loaded['this checkout'])
        plan = bk.batch_plan(n, size, size)
        print(f'[plan] {label}: the route takes '
              + ('single-frame launches' if bk.frame_route(size, size) else
                 f'the batched kernel in '
                 f'{"tiles" if plan.tiles else "linear blocks"}, '
                 f'{len(plan.launches)} launch(es)'), flush=True)
        times = timing.in_turns(runs, timing.cuda_time_ms)
        print(f'[time] {card} | {label}: device ms per call (CUDA events, '
              f'two turns): {json.dumps(times)}', flush=True)
        if n > 8:
            # the time series' call after an L2 flush (its scenes cold)
            cold = timing.in_turns(
                {k: (fn, 20) for k, (fn, _) in runs.items()
                 if 'batched' in k},
                lambda fn, reps: timing.cold_time_ms(fn, reps, flush))
            print(f'[time] {card} | {label}: device ms of one call after '
                  f'the L2 flush (median of 20, two turns): '
                  f'{json.dumps(cold)}', flush=True)
        use(loaded['this checkout'])
        for name in loaded:
            alone = np.mean(times[f'{name}: single-frame launches'])
            for layout in LAYOUTS:
                batch = np.mean(times[f'{name}: batched, {layout}'])
                print(f'[time] {card} | {label}: {name}: batched in {layout} '
                      f'{batch:.4f} ms ({batch / n * 1e3:.3f} us a frame), '
                      f'single-frame launches {alone:.4f} ms; batched / '
                      f'single {batch / alone:.4f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
