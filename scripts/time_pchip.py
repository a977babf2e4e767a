#!/usr/bin/env python3
"""
Device time of the PCHIP oversampling (``csrc/pchip.cu``) on one NVIDIA
GPU: the package's design, candidates of it and another checkout's kernel,
in turns, on the inputs of the map path.

    python3 scripts/time_pchip.py [--parent DIR]

Records the two ``pchip_axis`` calls (box rows, then the columns of the
result) that ``BodyXY.map_img(interpolation='smooth')`` makes onto the
720x1440 0.25-degree map in three cases: the 150x150 frame, the 150x150
16-frame cube (chip_smoke.py's map body and seeded images) and the
1024x1024 8-frame cube of chip_smoke.py's ``[observation]`` phase (its
seeded cube with the bright disc), on synthetic SPICE kernels written at
run time. Every design in :data:`VARIANTS` (text substitutions of the
package's source, built under ``build/`` with the package's flags; one
nvcc process each, all at once) and, with ``--parent DIR``, another
checkout's ``csrc/pchip.cu`` (for example the parent commit unpacked with
``git archive``; its own launch signature) is held bit for bit against
``pchip_axis_plain`` on both passes, and both passes are timed with a cold
L2 (one call after a 128 MB read, median of 50) and back to back (warm),
CUDA events, two turns (``planetmapper_tpu_torch/testing/timing.py``),
beside the bound (``testing/bounds.pchip_call_bound``). Each build's
registers, spills and resident blocks are printed.
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

#: Both passes in one cooperative launch: the row pass's blocks (a line
#: each), a grid-wide barrier, the column pass's blocks (four adjacent
#: lines each); the intermediate stays in the L2 between them.
_FUSED = r'''
__global__ void __launch_bounds__(kThreads)
pchip_fused_kernel(const __grid_constant__ Params rows,
                   const __grid_constant__ Params cols) {
    __shared__ Lines s;
    for (int64_t g = blockIdx.x; g < rows.n_lines; g += gridDim.x) {
        pchip_lines<1>(rows, g, s);
        __syncthreads();
    }
    cooperative_groups::this_grid().sync();
    const int64_t n_cols = (cols.n_lines + kAdjacentLines - 1)
                           / kAdjacentLines;
    for (int64_t g = blockIdx.x; g < n_cols; g += gridDim.x) {
        pchip_lines<kAdjacentLines>(cols, g, s);
        __syncthreads();
    }
}
'''

_FUSED_ENTRY = r'''
int pchip_fused_launch(
        const double* in, long long in_frame, long long in_line,
        long long in_cell, const double* xs, double* out, long long out_frame,
        long long out_line, long long out_pos, int n_frames, long long lines,
        int n, int n_eval, int k_rep, int lines_per_block,
        const double* in2, long long in2_frame, long long in2_line,
        long long in2_cell, const double* xs2, double* out2,
        long long out2_frame, long long out2_line, long long out2_pos,
        long long lines2, int n2, int n2_eval, int k2_rep,
        int lines2_per_block, void* stream) {
    Params rows, cols;
    if (!fill_params(&rows, in, in_frame, in_line, in_cell, xs, out,
                     out_frame, out_line, out_pos, n_frames, lines, n,
                     n_eval, k_rep, lines_per_block)
        || !fill_params(&cols, in2, in2_frame, in2_line, in2_cell, xs2, out2,
                        out2_frame, out2_line, out2_pos, n_frames, lines2, n2,
                        n2_eval, k2_rep, lines2_per_block)
        || lines_per_block != 1 || lines2_per_block != kAdjacentLines) {
        return (int)cudaErrorInvalidValue;
    }
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pchip_fused_kernel,
                                                  kThreads, 0);
    long long groups = (rows.n_lines + lines_per_block - 1) / lines_per_block;
    const long long groups2 =
        (cols.n_lines + lines2_per_block - 1) / lines2_per_block;
    if (groups2 > groups) groups = groups2;
    const long long most = (long long)sms * per_sm;
    const unsigned grid = (unsigned)(groups < most ? groups : most);
    void* args[] = {&rows, &cols};
    cudaLaunchCooperativeKernel((const void*)pchip_fused_kernel, grid,
                                kThreads, args, 0, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
'''

#: Programmatic dependent launch (Hopper): a launch may start while the
#: kernel before it on the stream finishes; its blocks wait for that
#: kernel's memory before reading.
_PDL_KERNEL = ("""    __shared__ Lines s;
    pchip_lines<L>(p, blockIdx.x, s);""", """    __shared__ Lines s;
    asm volatile("griddepcontrol.launch_dependents;");
    asm volatile("griddepcontrol.wait;" ::: "memory");
    pchip_lines<L>(p, blockIdx.x, s);""")
_PDL_LAUNCH = ("""    if (lines_per_block == 1) {
        pchip_axis_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    } else {
        pchip_axis_kernel<kAdjacentLines>
            <<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    }""", """    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(kThreads);
    config.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attribute;
    attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attribute.val.programmaticStreamSerializationAllowed = 1;
    config.attrs = &attribute;
    config.numAttrs = 1;
    if (lines_per_block == 1) {
        cudaLaunchKernelEx(&config, pchip_axis_kernel<1>, p);
    } else {
        cudaLaunchKernelEx(&config, pchip_axis_kernel<kAdjacentLines>, p);
    }""")

#: name: [(text of csrc/pchip.cu, its replacement), ...]
VARIANTS = {
    'two launches (package)': [],
    'two launches, 128 threads a block': [
        ('constexpr int kThreads = 256;', 'constexpr int kThreads = 128;')],
    'two launches, 512 cells a block': [
        ('constexpr int kCells = 1024;', 'constexpr int kCells = 512;')],
    'one cooperative launch, both passes': [
        ('#include <stdint.h>',
         '#include <stdint.h>\n\n#include <cooperative_groups.h>'),
        ('}  // namespace\n', _FUSED + '\n}  // namespace\n'),
        ('}  // extern "C"', _FUSED_ENTRY + '\n}  // extern "C"')],
    'two launches, the second a programmatic dependent launch': [
        _PDL_KERNEL, _PDL_LAUNCH],
    'two launches, 8 adjacent lines a block': [
        ('constexpr int kAdjacentLines = 4;',
         'constexpr int kAdjacentLines = 8;')],
    'two launches, a position a thread in both passes': [
        ('            if constexpr (L == 1) {',
         '            if constexpr (true) {')],
    'two launches, a cell a thread in both passes': [
        ('            if constexpr (L == 1) {',
         '            if constexpr (false) {')],
}
FUSED = ('one cooperative launch, both passes',)
#: Designs built from another checkout's source (``--parent``): its
#: segment walk with more adjacent lines a block
PARENT_VARIANTS = {
    f'parent, {n} adjacent lines a block': [
        ('constexpr int kAdjacentLines = 4;',
         f'constexpr int kAdjacentLines = {n};')]
    for n in (8, 16, 32)
}
#: lines a block takes when they are adjacent, where not the package's
ADJACENT = {'two launches, 8 adjacent lines a block': 8}

#: (label, map body size, frames) of the timed cases
CASES = [('150^2 frame', 150, 1), ('150^2 16-frame cube', 150, 16),
         ('1024^2 8-frame cube (observation)', 1024, 8)]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PASS = [_P, _L, _L, _L, _P, _P, _L, _L, _L, _I, _L, _I, _I, _I]


def variant_source(name: str, directory: Path, base: Path | None = None
                   ) -> Path:
    from planetmapper_tpu_torch.ops.cuda_build import CSRC

    text = (base or CSRC / 'pchip.cu').read_text()
    for old, new in (VARIANTS if base is None else PARENT_VARIANTS)[name]:
        if isinstance(old, tuple):  # the span from one text to another
            start, end = text.index(old[0]), text.index(old[1])
            old = text[start:end]
        if text.count(old) != 1:
            raise RuntimeError(f'{name}: {old!r} is not in pchip.cu once')
        text = text.replace(old, new)
    stem = ''.join(c if c.isalnum() else '_' for c in name)
    path = directory / f'pchip_{stem}.cu'
    path.write_text(text)
    return path


def _configure(lib) -> None:
    lib.pchip_axis_launch.restype = _I
    lib.pchip_axis_launch.argtypes = _PASS + [_I, _P]
    if hasattr(lib, 'pchip_fused_launch'):
        lib.pchip_fused_launch.restype = _I
        lib.pchip_fused_launch.argtypes = (
            _PASS + [_I] + [a for i, a in enumerate(_PASS) if i != 9]
            + [_I, _P])
    lib.pchip_occupancy.restype = _I
    lib.pchip_occupancy.argtypes = [ctypes.POINTER(_I)] * 3


def _configure_parent(lib) -> None:
    """The parent design's launch: no lines_per_block (it picks its own)."""
    lib.pchip_axis_launch.restype = _I
    lib.pchip_axis_launch.argtypes = _PASS + [_P]


def pass_args(values, xs, out, k_rep: int, axis: int) -> list:
    """A pass's arguments of ``pchip_axis_launch`` before lines_per_block
    (as ``ops/pchip_kernel.launch`` passes them)."""
    line_dim, cell_dim = (1, 2) if axis == -1 else (2, 1)
    return [values.data_ptr(), values.stride(0), values.stride(line_dim),
            values.stride(cell_dim), xs.data_ptr(), out.data_ptr(),
            out.stride(0), out.stride(line_dim), out.stride(cell_dim),
            values.shape[0], values.shape[line_dim], values.shape[cell_dim],
            xs.numel(), k_rep]


def main() -> int:
    import numpy as np
    import torch

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch.ops import cuda_build, pchip_device
    from planetmapper_tpu_torch.ops import pchip_kernel as pk
    from planetmapper_tpu_torch.testing import bounds, timing
    from planetmapper_tpu_torch.testing.observation_files import disc_cube
    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--parent', type=Path, default=None,
                        help="checkout whose csrc/pchip.cu to time in turns "
                             "with this one's designs")
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
    flags = pk.LIBRARY.flags[len(cuda_build.NVCC_FLAGS):]
    libraries = {
        name: cuda_build.CudaLibrary(
            f'pchip_{i}', variant_source(name, cuda_build.BUILD_DIR),
            _configure, flags=flags)
        for i, name in enumerate(VARIANTS)
    }
    if parent is not None:
        source = (parent.resolve() / 'planetmapper_tpu_torch' / 'csrc'
                  / 'pchip.cu')
        libraries['parent'] = cuda_build.CudaLibrary(
            'pchip_parent', source, _configure_parent, flags=flags)
        for i, name in enumerate(PARENT_VARIANTS):
            libraries[name] = cuda_build.CudaLibrary(
                f'pchip_parent_{i}',
                variant_source(name, cuda_build.BUILD_DIR, source),
                _configure_parent, flags=flags)
    cuda_build.build_all(list(libraries.values()))
    for name, library in libraries.items():
        for line in library.ptxas_log().splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}')
        if not name.startswith('parent'):
            values = [_I() for _ in range(3)]
            cuda_build.check_launch(library.load().pchip_occupancy(*values),
                                    'occupancy')
            print(f'[build] {name}: {values[0].value} registers, '
                  f'{values[1].value} bytes of local memory, '
                  f'{values[2].value} resident blocks per SM')

    # the two pchip_axis calls of each case's smooth map_img
    recorded = {}
    wrapper = pchip_device.pchip_axis
    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        for label, size, frames in CASES:
            body = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC,
                             sz=size, device=device)
            disc = timing.MAP_BODIES[size]
            body.set_disc_params(*disc)
            frame, _, cube = timing.map_images(size, size)
            if frames == 1:
                img = frame
            elif size == 1024:
                img = disc_cube(cube, disc)
            else:
                img = cube
            calls = []

            def record(*args, calls=calls, **kwargs):
                calls.append((args, kwargs))
                return wrapper(*args, **kwargs)

            pchip_device.pchip_axis = record
            try:
                body.map_img(img, interpolation='smooth', **timing.MAP_KW)
            finally:
                pchip_device.pchip_axis = wrapper
            recorded[label] = calls
        pt.clear_kernels()

    flush = timing.l2_flush(device)
    stream = lambda: torch.cuda.current_stream(device).cuda_stream  # noqa
    for label, calls in recorded.items():
        (box, n_xs, kx_rep), _ = calls[0]
        (rows_in, n_ys, ky_rep), _ = calls[1]
        xs_rows = torch.linspace(0.0, box.shape[-1] - 1.0, n_xs,
                                 dtype=torch.float64, device=device)
        xs_cols = torch.linspace(0.0, rows_in.shape[-2] - 1.0, n_ys,
                                 dtype=torch.float64, device=device)
        ref_rows = pk.pchip_axis_plain(box, n_xs, kx_rep, -1)
        ref_grid = pk.pchip_axis_plain(ref_rows, n_ys, ky_rep, -2)
        runs, passes = {}, {}
        for name, library in libraries.items():
            lib = library.load()
            rows = torch.empty_like(rows_in)
            grid = torch.empty((box.shape[0], n_ys, n_xs),
                               dtype=torch.float64, device=device)
            row_args = pass_args(box, xs_rows, rows, kx_rep, -1)
            col_args = pass_args(rows, xs_cols, grid, ky_rep, -2)
            if name in FUSED:
                def run(lib=lib, r=row_args, c=col_args):
                    cuda_build.check_launch(lib.pchip_fused_launch(
                        *r, pk.lines_per_block(r[2]),
                        *[a for i, a in enumerate(c) if i != 9],
                        pk.lines_per_block(c[2]), stream()), name)
            else:
                # the parent's launch picks its own lines a block
                adjacent = None if name.startswith('parent') else \
                    ADJACENT.get(name, pk.ADJACENT_LINES)

                def one(args, lib=lib, adjacent=adjacent):
                    extra = [] if adjacent is None else [
                        adjacent if args[2] == 1 else 1]
                    cuda_build.check_launch(lib.pchip_axis_launch(
                        *args, *extra, stream()), name)

                def run(one=one, r=row_args, c=col_args):
                    one(r)
                    one(c)

                if name == 'two launches (package)' or name.startswith(
                        'parent'):
                    passes[f'{name}: rows'] = (lambda f=one, a=row_args:
                                               f(a), 200)
                    passes[f'{name}: columns'] = (lambda f=one, a=col_args:
                                                  f(a), 200)
            run()
            torch.cuda.synchronize()
            for what, got, ref in (('rows', rows, ref_rows),
                                   ('grid', grid, ref_grid)):
                if not (torch.equal(torch.isnan(got), torch.isnan(ref))
                        and torch.equal(torch.nan_to_num(got),
                                        torch.nan_to_num(ref))):
                    print(f'FAIL: {name} {label}: {what} differs from '
                          'pchip_axis_plain')
                    return 1
            runs[name] = (run, 50)
        cold = timing.in_turns(
            runs, lambda fn, n: timing.cold_time_ms(fn, n, flush))
        warm = timing.in_turns({k: (fn, 200) for k, (fn, _) in runs.items()},
                               timing.cuda_time_ms)
        bound = bounds.pchip_call_bound(box, ky_rep, kx_rep)
        print(f'[pchip] {card} | {label}: box {tuple(box.shape)} to grid '
              f'{(box.shape[0], n_ys, n_xs)}, k_rep ({ky_rep}, {kx_rep}); '
              f'both passes, ms per call, cold L2 (median of 50, two turns): '
              f'{json.dumps(cold)}; back to back (two turns): '
              f'{json.dumps(warm)}; bound {bound["ms"] * 1e3:.3f} us '
              f'({bound["bound_by"]}, {bound["bytes"]} bytes)', flush=True)
        print(f'[pchip] {card} | {label}: each pass alone, back to back '
              f'(ms, two turns): '
              f'{json.dumps(timing.in_turns(passes, timing.cuda_time_ms))}',
              flush=True)
        for name in runs:
            c, w = np.mean(cold[name]), np.mean(warm[name])
            print(f'[pchip] {card} | {label}: {name}: {c * 1e3:.2f} us cold '
                  f'({bound["ms"] / c:.1%} of the bound), {w * 1e3:.2f} us '
                  f'warm ({bound["ms"] / w:.1%})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
