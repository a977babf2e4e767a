#!/usr/bin/env python3
"""
Device time of the batched backplane kernel (``csrc/backplanes.cu``
``backplanes26_batch_kernel``) against single-frame launches on one NVIDIA
GPU, for ways of reading each frame's scene.

    python3 scripts/time_backplane_batch.py [--parent DIR]

The single-frame kernel reads its scene as constant-bank operands of its
parameters. A batched block reads its frame's scene from memory instead,
and where it keeps the loaded values costs registers. This script builds
the package's source and variants of it (text substitutions in a copy
under ``build/``; one nvcc process each, all at once) in
:data:`VARIANTS`, prints each build's registers, spills and resident
blocks per SM, checks that each variant's batched launch equals the
single-frame launches of ``run_batch(frame_launches=True)`` bit for bit,
and times both routes (CUDA events, two turns;
``planetmapper_tpu_torch/testing/timing.py``) at the cases of
:data:`CASES`: chip_smoke.py's 8 disc sets at 2048x2048 and at smaller
frames (26 planes; the size that picks the route,
``ops/backplanes_kernel.FRAME_LAUNCH_PIXELS``), and bench.py:343's 1000
epochs at 50x50 (EMISSION and LON-GRAPHIC), on synthetic SPICE kernels
written at run time. ``--parent DIR`` times the single-frame kernel of
another checkout (for example the parent commit unpacked with ``git
archive``) in turns with this one's at 2048x2048.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_GLOBAL = '        return __ldg(s + i);'
_FRAME_SCENE = '        const GlobalScene sc{scenes + (size_t)f * SCENE_SIZE};'
_STAGED = """        __shared__ double staged[SCENE_SIZE];
        const int t = threadIdx.y * kBlockX + threadIdx.x;
        if (t < SCENE_SIZE) staged[t] = scenes[(size_t)f * SCENE_SIZE + t];
        __syncthreads();
        const GlobalScene sc{staged};"""

#: name: [(text of csrc/backplanes.cu, its replacement), ...]
VARIANTS = {
    'global, __ldg (package)': [],
    'global, volatile ld.global.nc': [
        (_GLOBAL, '        double v;\n        asm volatile("ld.global.nc.f64 '
                  '%0, [%1];" : "=d"(v) : "l"(s + i));\n        return v;')],
    'shared, staged': [
        (_GLOBAL, '        return s[i];'), (_FRAME_SCENE, _STAGED)],
    'shared, staged, volatile reads': [
        (_GLOBAL, '        return ((const volatile double*)s)[i];'),
        (_FRAME_SCENE, _STAGED)],
    # the single-frame kernel's plane stride read from its parameters, as
    # its kFrameOfBatch instance reads it, on the main path too
    'single: stride from the parameters': [
        ('kFrameOfBatch ? (size_t)p.plane_stride\n'
         '                                   : (size_t)p.nx * (size_t)p.ny);',
         '(size_t)p.plane_stride);')],
}

#: Variants whose batched kernel is the package's (not timed as batches)
SINGLE_ONLY = ('single: stride from the parameters',)

#: (frames, size, planes) of the timed cases: chip_smoke's disc sweep at
#: 2048^2 and smaller frames of it, and bench.py:343's time series
CASES = [(8, 2048, None), (8, 1024, None), (8, 512, None), (8, 256, None),
         (1000, 50, ('EMISSION', 'LON-GRAPHIC'))]


def variant_source(name: str, directory: Path) -> Path:
    from planetmapper_tpu_torch.ops.cuda_build import CSRC

    text = (CSRC / 'backplanes.cu').read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f'{name}: {old!r} is not in backplanes.cu once')
        text = text.replace(old, new)
    stem = ''.join(c if c.isalnum() else '_' for c in name)
    path = directory / f'backplanes_{stem}.cu'
    path.write_text(text)
    return path


def _configure_single(lib) -> None:
    """The single-frame launch alone (another checkout's library)."""
    lib.backplanes26_launch.restype = ctypes.c_int
    lib.backplanes26_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]


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
                        help='checkout whose single-frame kernel to time in '
                             'turns with this one at 2048x2048')
    parent = parser.parse_args().parent
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device('cuda', torch.cuda.current_device())
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libraries = {
        name: cuda_build.CudaLibrary(
            'backplanes26_' + str(i), variant_source(name, cuda_build.BUILD_DIR),
            bk._configure)
        for i, name in enumerate(VARIANTS)
    }
    singles = {'this checkout': libraries['global, __ldg (package)']}
    singles.update({name: libraries[name] for name in SINGLE_ONLY})
    if parent is not None:
        singles['parent'] = cuda_build.CudaLibrary(
            'backplanes26_parent',
            parent.resolve() / 'planetmapper_tpu_torch' / 'csrc'
            / 'backplanes.cu', _configure_single)
    cuda_build.build_all(list(libraries.values()) + [
        library for name, library in singles.items() if name == 'parent'])
    for name, library in libraries.items():
        for line in library.ptxas_log().splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}')
        values = [ctypes.c_int() for _ in range(3)]
        cuda_build.check_launch(
            library.load().backplanes26_occupancy(1, *values), 'occupancy')
        print(f'[build] {name}: batched kernel {values[0].value} registers, '
              f'{values[1].value} bytes of local memory, {values[2].value} '
              'blocks per SM')

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
                scenes = bk.pack_scenes(np.array(xys), discs,
                                        np.asarray(body.radii),
                                        body._get_pipeline_anchors())
            else:
                body.set_disc_params(size / 2, size / 2, size * 0.4, 0.0)
                ets = body.et + 60.0 * np.arange(n)
                anchors, xy = timeseries._batched_pipeline_inputs(body, ets)
                scenes = bk.pack_scenes(
                    xy, np.broadcast_to(body.get_disc_params(), (n, 4)),
                    np.asarray(body.radii), anchors)
            label = f'{n} x {size}^2, {planes or "26 planes"}'
            cases[label] = (body, planes, scenes)
        pt.clear_kernels()

    for label, (case_body, planes, scenes) in cases.items():
        nx, ny = case_body.get_img_size()
        if nx == timing.SIZE:
            # the single-frame kernel of both checkouts on one scene
            impl, _ = pipeline.select_pipeline_impl(case_body, nx, ny)
            scene = np.ascontiguousarray(scenes[0])

            def single(lib):
                bk.LIBRARY._lib = lib
                impl.run(scene, nx, ny, device)

            times = timing.in_turns(
                {name: (lambda lib=library.load(): single(lib), 50)
                 for name, library in singles.items()}, timing.cuda_time_ms)
            print(f'[time] {card} | single-frame kernel at {nx}x{ny}, 26 '
                  f'planes, in turns (CUDA events, 50 back to back): '
                  f'{json.dumps(times)}')
        impl, _ = pipeline.select_pipeline_impl(case_body, nx, ny,
                                                planes=planes)
        scenes_dev = torch.from_numpy(scenes).to(device)
        bk.LIBRARY._lib = libraries['global, __ldg (package)'].load()
        frames = impl.run_batch(scenes, nx, ny, device, frame_launches=True)

        def frame_route(lib=bk.LIBRARY._lib):
            bk.LIBRARY._lib = lib
            impl.run_batch(scenes, nx, ny, device, frame_launches=True)

        runs = {'single-frame launches': (frame_route, 5)}
        for name, library in libraries.items():
            if name in SINGLE_ONLY:
                continue
            bk.LIBRARY._lib = library.load()
            out = impl.run_batch(scenes_dev, nx, ny, device,
                                 frame_launches=False)
            for k, plane in frames.items():
                if not torch.equal(torch.nan_to_num(out[k]),
                                   torch.nan_to_num(plane)):
                    print(f'FAIL: {name} {label}: batched {k} differs from '
                          'the single-frame launches')
                    return 1

            def batched(lib=library.load()):
                bk.LIBRARY._lib = lib
                impl.run_batch(scenes_dev, nx, ny, device,
                               frame_launches=False)

            runs[f'{name}: batched'] = (batched, 5)
        times = timing.in_turns(runs, timing.cuda_time_ms)
        print(f'[time] {card} | {label}: device ms per call (CUDA events, '
              f'two turns): {json.dumps(times)}')
        alone = np.mean(times['single-frame launches'])
        for name in libraries:
            if name in SINGLE_ONLY:
                continue
            batch = np.mean(times[f'{name}: batched'])
            print(f'[time] {card} | {label}: {name}: batched {batch:.4f} ms '
                  f'({batch / len(scenes) * 1e3:.3f} us a frame), '
                  f'single-frame launches {alone:.4f} ms; batched / single '
                  f'{batch / alone:.4f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
