#!/usr/bin/env python3
"""
Device time of the batched backplane kernel (``csrc/backplanes.cu``
``backplanes26_batch_kernel``) against single-frame launches on one NVIDIA
GPU, for candidate designs of it and another checkout's.

    python3 scripts/time_backplane_batch.py [--parent DIR]

The package's batched kernel reads each frame's scene from memory with
``__ldg`` and takes, by the frame's width (``ops/backplanes_kernel.py
batch_plan``), the single-frame kernel's 32x8 tiles or linear blocks of
256 consecutive pixels of one frame with a ray per pixel. This script
builds the package's source and the candidates of :data:`VARIANTS` (text
substitutions in a copy under ``build/``; one nvcc process each, all at
once): the scenes in a ``__constant__`` bank of 77 (one device-to-device
copy and one launch a chunk), the scenes in a 32 KB
``__grid_constant__`` parameter block of 38 (one launch a chunk, copied
from the host), and the linear blocks' ray trigonometry from tables of
the block's rows and columns. It prints each build's registers, spills
and resident blocks per SM in both layouts, checks that each candidate's
batched launch equals the single-frame launches of
``run_batch(frame_launches=True)`` bit for bit, and times all of them,
with the package's kernel also forced into each layout (``TILE_FILL``),
in turns (CUDA events back to back, and for the time series one call
after an L2 flush too; ``planetmapper_tpu_torch/testing/timing.py``) at
the cases of :data:`CASES`: chip_smoke.py's 8 disc sets at 2048x2048 and
at smaller frames (26 planes; the sizes about the route's threshold,
``ops/backplanes_kernel.FRAME_LAUNCH_PIXELS``, and the layouts'), and
bench.py:343's 1000 epochs at 50x50 (all 26 planes, and EMISSION and
LON-GRAPHIC), on synthetic SPICE kernels written at run time.
``--parent DIR`` adds another checkout's kernels (for example the parent
commit unpacked with ``git archive``): its batched kernel in every case,
its single-frame kernel in turns with this one's at 2048x2048.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_LINEAR_SCENE = '    const GlobalScene sc{scenes + f * SCENE_SIZE};'
_ANCHOR = '// kFrameOfBatch: the frame is one of a batch\'s'
_LINEAR_LAUNCH = '    backplanes26_batch_kernel<<<(unsigned)blocks, threads, 0,\n'
_CONST = """__constant__ double c_scenes[77 * SCENE_SIZE];

// A chunk's frame in the constant bank.
struct ConstScene {
    int base;
    __device__ __forceinline__ double operator[](int i) const {
        return c_scenes[base + i];
    }
};

"""
_BLOCK_TABLES = """\
// The ray tables of a batched block, whose pixels are [p0, p1) of one
// frame in row-major order: column (c0 + s) mod nx in column slot s (the
// pixel p0 + j takes slot j mod nx; min(nx, p1 - p0) slots), row r0 + s in
// row slot s. The same arguments and sincospi calls as build_ray_tables,
// so every entry equals the single-frame kernel's.
template <class Sc>
__device__ __forceinline__ void build_batch_tables(const Sc& sc,
                                                   const BatchParams& p,
                                                   int p0, int p1,
                                                   BatchTables& tab) {
    const int nx = p.nx;
    const int r0 = p0 / nx;
    const int c0 = p0 - r0 * nx;
    const int n_cols = min(nx, p1 - p0);
    const int n_rows = (p1 - 1) / nx - r0 + 1;
    for (int u = threadIdx.x; u < 2 * (n_cols + n_rows); u += blockDim.x) {
        if (u < 2 * n_cols) {
            const int k = u >= n_cols;  // 0: ra, 1: dec
            const int s = u - k * n_cols;
            const int c = c0 + s < nx ? c0 + s : c0 + s - nx;
            const double x = (double)c;
            double sv, cv;
            sincospi((k ? sc[S_RAY + 3] : sc[S_RAY + 0]) * x, &sv, &cv);
            tab.col[2 * k][s] = sv;
            tab.col[2 * k + 1][s] = cv;
        } else {
            const int v = u - 2 * n_cols;
            const int k = v >= n_rows;
            const int s = v - k * n_rows;
            const double y = (double)(r0 + s) + p.row0;
            const double arg = k ? sc[S_RAY + 4] * y + sc[S_RAY + 5]
                                 : sc[S_RAY + 1] * y + sc[S_RAY + 2];
            double sv, cv;
            sincospi(arg, &sv, &cv);
            tab.row[2 * k][s] = sv;
            tab.row[2 * k + 1][s] = cv;
        }
    }
}

"""

#: name: ([(text of csrc/backplanes.cu, its replacement[, times]), ...],
#: frames a launch at most, where the linear blocks read their scenes
#: ('device' or 'host'), where the tiles read theirs)
VARIANTS = {
    'package: linear blocks by __ldg, tiles by parameters': (
        [], None, 'device', 'host'),
    'linear blocks from a constant bank of 77': ([
        (_ANCHOR, _CONST + _ANCHOR),
        (_LINEAR_SCENE, '    const ConstScene sc{local * SCENE_SIZE};'),
        (_LINEAR_LAUNCH, """    if (count > 77) return (int)cudaErrorInvalidValue;
    cudaMemcpyToSymbolAsync(c_scenes, scenes + first * SCENE_SIZE,
                            (size_t)count * SCENE_SIZE * sizeof(double), 0,
                            cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
""" + _LINEAR_LAUNCH)], 77, 'device', 'host'),
    'linear blocks by parameters, 38 a launch': ([
        (_LINEAR_SCENE, '    const BlockScene sc{scenes, local};'),
        ('                          const double* __restrict__ scenes,\n',
         '                          const __grid_constant__ SceneBlock '
         'scenes,\n'),
        (_LINEAR_LAUNCH, """    if (count > kBlockScenes) {
        return (int)cudaErrorInvalidValue;
    }
    SceneBlock block;
    memcpy(block.s, scenes + first * SCENE_SIZE,
           (size_t)count * SCENE_SIZE * sizeof(double));
""" + _LINEAR_LAUNCH),
        ('(cudaStream_t)stream>>>(out, rv_out, scenes,\n',
         '(cudaStream_t)stream>>>(out, rv_out, block,\n')], 38, 'host',
        'host'),
    'tiles by __ldg': ([
        ('                                const __grid_constant__ SceneBlock '
         'scenes,\n',
         '                                const double* __restrict__ scenes,'
         '\n'),
        ('    const BlockScene sc{scenes, (int)blockIdx.z};',
         '    const GlobalScene sc{scenes + f * SCENE_SIZE};'),
        ("""    SceneBlock block;
    memcpy(block.s, scenes + first * SCENE_SIZE,
           (size_t)count * SCENE_SIZE * sizeof(double));
""", ''),
        ('(cudaStream_t)stream>>>(out, rv_out,\n'
         '                                                              block, '
         'p);',
         '(cudaStream_t)stream>>>(out, rv_out,\n'
         '                                                              scenes,'
         ' p);')], None, 'device', 'device'),
    'linear blocks with tables of their rows and columns': ([
        (_ANCHOR, _BLOCK_TABLES + _ANCHOR),
        ("""    const int j = threadIdx.x;
    const int pix = p0 + j;
    if (pix >= p1) return;
    const int row = pix / p.nx;
    const int col = pix - row * p.nx;
    pixel_tables(sc, p, col, row, j, tab);
    backplanes_pixel(sc, p, tab, j, j, col, row, out, rv_out,
""", """    build_batch_tables(sc, p, p0, p1, tab);
    __syncthreads();
    const int j = threadIdx.x;
    const int pix = p0 + j;
    if (pix >= p1) return;
    const int row = pix / p.nx;
    const int col = pix - row * p.nx;
    backplanes_pixel(sc, p, tab, j < p.nx ? j : j % p.nx, row - p0 / p.nx,
                     col, row, out, rv_out,
""")], None, 'device', 'host'),
}

#: (frames, size, planes) of the timed cases: chip_smoke's disc sweep at
#: 2048^2 and smaller frames of it, and bench.py:343's time series
CASES = [(8, 2048, None), (8, 1024, None), (8, 896, None), (8, 768, None),
         (8, 640, None), (8, 512, None), (8, 448, None), (8, 384, None),
         (8, 300, None), (8, 256, None), (8, 200, None), (8, 100, None),
         (200, 128, None), (1000, 64, ('EMISSION', 'LON-GRAPHIC')),
         (1000, 50, None), (1000, 50, ('EMISSION', 'LON-GRAPHIC'))]


def variant_source(name: str, directory: Path) -> Path:
    from planetmapper_tpu_torch.ops.cuda_build import CSRC

    text = (CSRC / 'backplanes.cu').read_text()
    for old, new, *count in VARIANTS[name][0]:
        if text.count(old) != (count[0] if count else 1):
            raise RuntimeError(f'{name}: {old!r} is not in backplanes.cu '
                               f'{count[0] if count else 1} time(s)')
        text = text.replace(old, new)
    stem = ''.join(c if c.isalnum() else '_' for c in name)
    path = directory / f'backplanes_{stem}.cu'
    path.write_text(text)
    return path


def _configure_parent(lib) -> None:
    """Another checkout's launches: its batched one takes a whole batch
    (no launch plan)."""
    lib.backplanes26_launch.restype = ctypes.c_int
    lib.backplanes26_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.backplanes26_launch_batch.restype = ctypes.c_int
    lib.backplanes26_launch_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]


class Library:
    """
    A library as the wrapper calls it (``backplanes26_launch_batch`` for
    linear blocks on device scenes, ``backplanes26_launch_batch_tiles`` on
    host scenes), each entry's scenes pointer mapped to the copy the
    library's kernel reads (``scenes``: ``{pointer: pointer}``); ``whole``
    calls another checkout's single batched launch, which takes the batch
    in one call on device scenes (at the plan's first launch).
    """

    def __init__(self, lib, scenes=None, whole=False):
        self.lib, self.scenes, self.whole = lib, scenes or {}, whole

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def _launch(self, name, scenes, out, rv, nx, ny, n, first, count, *rest):
        scenes = self.scenes.get(scenes, scenes)
        if self.whole:
            if first:
                return 0  # launched whole at the plan's first launch
            rest = rest[1:] if name == 'backplanes26_launch_batch' else rest
            return self.lib.backplanes26_launch_batch(scenes, out, rv, nx,
                                                      ny, n, *rest)
        return getattr(self.lib, name)(scenes, out, rv, nx, ny, n, first,
                                       count, *rest)

    def backplanes26_launch_batch(self, *args):
        return self._launch('backplanes26_launch_batch', *args)

    def backplanes26_launch_batch_tiles(self, *args):
        return self._launch('backplanes26_launch_batch_tiles', *args)


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
                        help='checkout whose kernels to time in turns with '
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
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libraries = {
        name: cuda_build.CudaLibrary(
            'backplanes26_' + str(i), variant_source(name, cuda_build.BUILD_DIR),
            bk._configure)
        for i, name in enumerate(VARIANTS)
    }
    package = libraries[
        'package: linear blocks by __ldg, tiles by parameters']
    builds = list(libraries.values())
    if parent is not None:
        parent_library = cuda_build.CudaLibrary(
            'backplanes26_parent',
            parent.resolve() / 'planetmapper_tpu_torch' / 'csrc'
            / 'backplanes.cu', _configure_parent)
        builds.append(parent_library)
    cuda_build.build_all(builds)
    for name, library in [*libraries.items()] + (
            [('parent', parent_library)] if parent is not None else []):
        for line in library.ptxas_log().splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}')
        for layout, which in (('linear blocks', 1), ('tiles', 2)):
            if name == 'parent':
                break
            values = [ctypes.c_int() for _ in range(3)]
            cuda_build.check_launch(
                library.load().backplanes26_occupancy(which, *values),
                'occupancy')
            print(f'[build] {name}: batched kernel in {layout} '
                  f'{values[0].value} registers, {values[1].value} bytes of '
                  f'local memory, {values[2].value} blocks per SM')

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

    tile_fill, tile_pixels = bk.TILE_FILL, bk.TILE_PIXELS
    plan = bk.batch_plan

    flush = timing.l2_flush(device)

    def use(lib, per_launch=None, fill=tile_fill):
        bk.LIBRARY._lib = lib
        # a candidate's chunk of frames a launch
        bk.batch_plan = functools.partial(plan, frames_per_launch=per_launch)
        bk.TILE_FILL = fill
        # forced tiles (fill 0) take frames of any size
        bk.TILE_PIXELS = tile_pixels if fill else 0

    for label, (case_body, planes, scenes) in cases.items():
        nx, ny = case_body.get_img_size()
        if nx == timing.SIZE and parent is not None:
            # the single-frame kernel of both checkouts on one scene
            impl, _ = pipeline.select_pipeline_impl(case_body, nx, ny)
            scene = np.ascontiguousarray(scenes[0])

            def single(lib):
                use(lib)
                impl.run(scene, nx, ny, device)

            times = timing.in_turns({
                name: (lambda lib=library.load(): single(lib), 50)
                for name, library in (('this checkout', package),
                                      ('parent', parent_library))},
                timing.cuda_time_ms)
            print(f'[time] {card} | single-frame kernel at {nx}x{ny}, 26 '
                  f'planes, in turns (CUDA events, 50 back to back): '
                  f'{json.dumps(times)}', flush=True)
        impl, _ = pipeline.select_pipeline_impl(case_body, nx, ny,
                                                planes=planes)
        scenes_dev = torch.from_numpy(scenes).to(device)
        use(package.load())
        frames = impl.run_batch(scenes, nx, ny, device, frame_launches=True)

        def frame_route(lib=package.load()):
            use(lib)
            impl.run_batch(scenes, nx, ny, device, frame_launches=True)

        runs = {'single-frame launches': (frame_route, 5)}
        # the pointers the wrapper hands each entry (device scenes to the
        # linear blocks, host scenes to the tiles), to the copy a
        # candidate's kernel reads
        to_host = {scenes_dev.data_ptr(): scenes.ctypes.data}
        to_device = {scenes.ctypes.data: scenes_dev.data_ptr()}
        batched = {}
        for name, library in libraries.items():
            _, per_launch, linear, tiles = VARIANTS[name]
            batched[name] = (Library(library.load(), {
                **(to_host if linear == 'host' else {}),
                **(to_device if tiles == 'device' else {})}), per_launch)
        # the package's kernel in each layout, whatever the plan picks
        for layout, fill in (('tiles', 0.0), ('linear blocks', 2.0)):
            batched[f'package in {layout}'] = (package.load(), None, fill)
        if parent is not None:
            batched['parent'] = (Library(parent_library.load(), to_device,
                                         whole=True), None)

        def given(n=len(scenes)):
            # the scenes as the main paths hand them to the plan's entry
            return scenes if bk.batch_plan(n, nx, ny).tiles else scenes_dev

        for name, (lib, per_launch, *fill) in batched.items():
            use(lib, per_launch, *fill)
            out = impl.run_batch(given(), nx, ny, device,
                                 frame_launches=False)
            for k, plane in frames.items():
                if not torch.equal(torch.nan_to_num(out[k]),
                                   torch.nan_to_num(plane)):
                    print(f'FAIL: {name} {label}: batched {k} differs from '
                          'the single-frame launches')
                    return 1

            def batch(lib=lib, per_launch=per_launch, fill=fill):
                use(lib, per_launch, *fill)
                impl.run_batch(given(), nx, ny, device,
                               frame_launches=False)

            runs[f'{name}: batched'] = (batch, 5)
        times = timing.in_turns(runs, timing.cuda_time_ms)
        print(f'[time] {card} | {label}: device ms per call (CUDA events, '
              f'two turns): {json.dumps(times)}', flush=True)
        if len(scenes) > 8:
            # the time series' kernel after an L2 flush (its scenes cold)
            cold = timing.in_turns(
                {k: (fn, 20) for k, (fn, _) in runs.items()
                 if k != 'single-frame launches'},
                lambda fn, n: timing.cold_time_ms(fn, n, flush))
            print(f'[time] {card} | {label}: device ms of one call after '
                  f'the L2 flush (median of 20, two turns): '
                  f'{json.dumps(cold)}', flush=True)
        use(package.load())
        alone = np.mean(times['single-frame launches'])
        for name in batched:
            batch = np.mean(times[f'{name}: batched'])
            print(f'[time] {card} | {label}: {name}: batched {batch:.4f} ms '
                  f'({batch / len(scenes) * 1e3:.3f} us a frame), '
                  f'single-frame launches {alone:.4f} ms; batched / single '
                  f'{batch / alone:.4f}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
