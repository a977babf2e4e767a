"""
Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's six kernel libraries (``planetmapper_tpu_torch/csrc/
*.cu``) with nvcc, one process each, all at once, and prints each kernel
instance's registers and spills, and the resident blocks of the
backplane kernels (single-frame, batched in linear blocks and in tiles),
the PCHIP kernel, map_smooth and map_infill. Then, on Jupiter seen
from the Earth on 2005-01-01 (synthetic SPICE kernels written at run time):

- backplanes: drives ``pipeline.compute_backplanes`` on a 2048x2048 BodyXY
  and holds the backplane kernel against its plain float64 PyTorch version
  on the card: at the full frame, and at a ragged, a row-offset, an
  un-gated, a triaxial and a plane-subset case; times both at 2048x2048
  on the card, and the main path's call by the host clock.
- batch: ``pipeline.compute_backplanes_batch`` of 8 disc sets at
  2048x2048 (frames this large take one single-frame launch each), each
  frame bit for bit against a single call; the batched kernel forced on
  the same frames (in 32x8 tiles), bit for bit with the single-frame
  launches and against its plain version, and at 640x640 and 768x768 (the
  two sides of the route's threshold) bit for bit with single-frame
  launches; both routes by device time and the entry point against 8
  synchronised single calls, in turns.
- timeseries: ``parallel.backplane_time_series`` of bench.py:343's 1000
  epochs at 50x50 (one launch of the batched kernel, in linear blocks),
  the call split into the anchors, the kernel's call and the copy out; 3
  epochs against per-body calls; the 1000 frames with all 26 planes
  bit for bit with 1000 single-frame launches, against the plain version
  and timed beside the bound; 8 epochs at 2048x2048.
- sharded: a 4-entry mesh of the one card, ``sharded_backplanes`` at
  2048x2048 and ``sharded_map_img`` from the 1024x1024 frame, bit for bit
  with the unsharded calls; fit: ``fit_disc_gradient`` on the
  1024x1024 8-frame observation cube against its disc.
- map: computes each body's x/y maps on the card (timed, its device
  checked, held against a CPU body's) and drives ``BodyXY.map_img`` onto
  the 720x1440 0.25-degree map of the JAX package's map benchmark
  (bench.py:160-293), from a 150x150 frame in every mode (spline degree 5
  included) and from a 1024x1024 frame in 'linear', 'cubic' and degree 4,
  frames and cubes, with and without a NaN block (one launch each of the
  NaN infill and the spline kernel a spline ``map_img``); holds every
  output of the four map kernels (infill, spline, PCHIP, smooth) against
  their plain versions on the same inputs, and small maps against the
  host scipy reference; times the kernels with a cold L2 (after a read of
  a buffer larger than it) and back to back (warm), the infill on the
  benchmark's 2048x2048 ``map_linear`` frame, their plain versions,
  ``grid_sample`` and ``torch.sum`` as yardsticks and blocked ``map_img``
  calls.
- planes: times the 26 ``get_backplane_img`` calls on a fresh 2048x2048
  body (the image chain on the card, float64) and holds them against the
  same body's kernel 1 planes by the JAX package's fused-vs-per-plane
  rule; times the 26 ``get_backplane_map`` calls on the 720x1440 map; and
  holds a 256x256 card body's 26 image getters and its 26 180x360 map
  getters against a CPU body's, each with its peak device memory.
- observation: writes the map benchmark's 1024x1024 8-frame cube (a bright
  disc added) as a FITS file with a TAN WCS, with the port's writer; on a
  card ``Observation`` of it, times the open and the disc from the WCS,
  ``fit_disc_position``, ``fit_disc_radius``, ``save_observation`` (27
  HDUs) and ``save_mapped_observation`` onto the 720x1440 map in 'linear'
  and 'smooth', with peak memory and file sizes; counts the map kernels'
  launches on that path (one infill a spline map); reads the files back (HDU names, data), holds
  the saved backplanes against kernel 1 and the mapped HDUs against
  ``map_img`` bit for bit; saves again from a fresh Observation of the
  file, with ``save_observation``'s time split between the plane getters,
  their host copies and the FITS write, and with every call of the four
  map kernels held against its plain version on the same inputs; and
  holds a 128x128 4-frame card Observation's three files against a CPU
  Observation's, card by card. The saves pass ``include_wireframe=False``:
  the overlay renders with matplotlib, which the card host lacks.
- wireframe: on a 2048x2048 card BodyXY and a CPU BodyXY, each with Io and
  Amalthea (a ``BasicBody``) as other bodies of interest, a ring and a
  lon/lat coordinate of interest, builds the wireframe's artist specs
  (``_body_plotting._wireframe_artists``: grid, limb, terminator,
  illuminated limb, ring, markers and labels), maps every curve to pixels
  and holds the card body's to the CPU body's; runs an 8192-point limb and
  terminator on the card (above the bulk threshold: the engine's tensors
  are on the card), holds them to the CPU body's and the limb to the card's
  own ``sincpt`` (rays nudged 2% of the disc radius inside each limb point
  hit, outside miss, in one call of 2 x 8192 rays); times the artists, the
  two curves and ``add_satellites_to_bodies_of_interest`` with the phase's
  peak device memory. Nothing is rendered (no matplotlib on the card host;
  the rasters are held to the JAX package by the CPU tests).
- dsk: runs the three cases of the JAX package's dsk kernel tests
  (``tests/test_pallas_core.py:538-616``: ds mul, div, hypot and atan2_ds
  on 8192 pairs, float32 atan2 on 8192 values) through the two dsk kernels
  (``csrc/dsk.cu``), holds each output to its test's grade against float64
  numpy and to its plain version on the card word for word (atan2_ds,
  native float64 in the kernel: within 1e-12 rad of its plain version, the
  ds chain, and word for word with ``torch.atan2`` in float64 on the same
  values), again at 2048x2048 values, and the edge pairs through both
  kernels; times each op at both sizes with a cold L2 and back to
  back beside its bound, its plain version and one PyTorch call (the
  float64 op over the same bytes for the pairs, ``torch.atan2`` in
  float32).
- cli: ``cli.main(['--prewarm', '512', '1024', '2048'])`` in this process
  (the libraries built or loaded; per size one backplane kernel launch,
  at least one map spline launch and one infill launch, counted from 0),
  the 2048x2048 planes against kernel 1's plain version; then on each
  prewarm body a cubic 1-degree ``map_img`` of a seeded source with a NaN
  block, every map infill and spline call held against its plain version
  (the 512x512 source is the
  TPU's kernel 2 work, the 1024x1024 and 2048x2048 ones kernel 3's) with
  the wrapper's launch plan logged; ``python -m planetmapper_tpu_torch
  --version``; one cold ``--prewarm 2048`` subprocess, timed start to
  exit (``scripts/time_cold_start.py`` times it with the session warm off
  and on).
- gui: ``GUI(allow_open=False)`` over a card ``Observation`` of the
  [observation] phase's 1024x1024 8-frame file; every disc-finding routine
  of the registry (reset, centre, rotate north, the four WCS routines, the
  position, radius and gradient fits) run as its button runs it, timed,
  each disc bit for bit with the direct call on a fresh Observation of the
  file; click coordinates (values, JSON and formatted strings) on and off
  the disc against a CPU Observation's GUI. Nothing is drawn; whether the
  host has tkinter and matplotlib is logged.
- tle: synthetic kernels with the SPK type 10 segments (HST, -48);
  ``BodyXY('Jupiter', observer='HST')`` at 2048x2048 on the card, its
  scalar ephemeris calls timed, HST's distance from the Earth's centre
  checked, ``compute_backplanes`` (one kernel 1 launch) against its plain
  version, a 256x256 card body's planes against a 256x256 CPU body's;
  which DAF reader read the SPK, and both readers' parse times on it and
  on a 32 MiB SPK of 13 segments (a planetary ephemeris's size).

Prints the card's name and power limit, one JSON line describing each
kernel, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, without that line, when a phase fails or no CUDA device exists.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import planetmapper_tpu_torch as pt
from planetmapper_tpu_torch import _body_plotting, pipeline
from planetmapper_tpu_torch._device import BULK_ELEMENTS, f64
from planetmapper_tpu_torch.io import fits as pt_fits
from planetmapper_tpu_torch.ops import backplanes_kernel as bk
from planetmapper_tpu_torch.ops import cuda_build, dsk, interp, interp_device
from planetmapper_tpu_torch.ops import dsk_kernel as dskk
from planetmapper_tpu_torch.ops import map_infill_kernel as mik
from planetmapper_tpu_torch.ops import map_smooth_kernel as msk
from planetmapper_tpu_torch.ops import map_spline_kernel as msp
from planetmapper_tpu_torch.ops import pchip_device
from planetmapper_tpu_torch.ops import pchip_kernel as pk
from planetmapper_tpu_torch.testing import (bounds, compare, dsk_cases,
                                            infill_cases)
from planetmapper_tpu_torch.testing.observation_files import (
    disc_cube,
    read_fits,
    write_observation,
)
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    AU_KM,
    write_sized_spk,
    write_synthetic_kernels,
)
from planetmapper_tpu_torch.testing.timing import (
    DISC,
    MAP_BODIES,
    MAP_CUBE_FRAMES,
    MAP_KW,
    MAP_SHAPE,
    SIZE,
    UTC,
    back_to_back_ms,
    cold_time_ms,
    cuda_time_ms,
    host_clock_ms,
    in_turns,
    l2_flush,
    map_images,
    smooth_launch_buffers,
    spline_launch_buffers,
    sum_yardstick,
)

RAGGED = (1000, 700, (503.3, 341.7, 300.0, 12.3))  # nx, ny, disc
BAND = (217, 333)  # row0, rows
SUBSETS = [  # one per section of the kernel (tests/test_pallas_core.py:99)
    ('LON-GRAPHIC', 'LOCAL-SOLAR-TIME'),
    ('RA', 'KM-X', 'PIXEL-Y'),
    ('PHASE', 'INCIDENCE', 'EMISSION'),
    ('AZIMUTH',),
    ('DISTANCE', 'DOPPLER'),
    ('LIMB-DISTANCE', 'RING-RADIUS'),
    ('LAT-CENTRIC', 'ANGULAR-Y', 'RING-LON-GRAPHIC'),
]
LIMB_PLANES = ('LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC')
ANGLE_PLANES = (  # degrees
    'LON-GRAPHIC', 'LAT-GRAPHIC', 'LON-CENTRIC', 'LAT-CENTRIC', 'RA', 'DEC',
    'PHASE', 'INCIDENCE', 'EMISSION', 'AZIMUTH', 'LIMB-LON-GRAPHIC',
    'LIMB-LAT-GRAPHIC', 'RING-LON-GRAPHIC',
)
FLAGS = dict(positive_west=True, prograde=True, have_sun=True)

#: Jupiter's radii scaled to a triaxial body inside the kernel's geodetic
#: range (pipeline._kernel_geodetic_iters: 4 Bowring steps)
TRIAXIAL_SCALE = (1.0, 0.98, 0.935)

#: The map benchmark (MAP_* and map_images in testing/timing.py).
#: Kernel against plain version: the JAX package's own TPU bars relative
#: to max(scale, 1) (tests/test_pallas_core.py:727-732, :775-780, :812-817)
MAP_BARS = {('spline', 150): 3e-5, ('spline', 1024): 5e-5,
            # the [cli] phase's prewarm sources: 512^2 under the TPU's
            # 640 px gate (kernel 2, :727-732's bar), 2048^2 past it
            # (kernel 3, :775-780's bar)
            ('spline', 512): 3e-5, ('spline', 2048): 5e-5,
            ('smooth', 150): 1e-4,
            # the JAX package states one bar for its smooth sampler, at
            # any frame size: the [observation] phase's 1024^2 cube
            ('smooth', 1024): 1e-4}
#: The map_spline instances the main path runs most, as (kx, ky):
#: 'linear', 'cubic' and (3, 1)
MAIN_SPLINE_DEGREES = ((1, 1), (3, 3), (1, 3))


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0]


def to_numpy(out: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def one_frame(impl, nx, ny, inputs, device, row0=0.0) -> dict:
    """One frame of ``impl.frames`` (kernel 1's or the plain graph's) from
    a body's host inputs (``pipeline.pipeline_inputs``), as tensors."""
    xy2angular, disc, radii, anchors = inputs
    out = impl.frames(nx, ny, xy2angular[None], disc[None], radii, anchors,
                      device=device, row0=row0)
    return {k: v[0] for k, v in out.items()}


def centre_pixel(shape, disc, row0=0.0) -> dict[str, np.ndarray]:
    """The pixel of a frame of ``shape`` (rows from ``row0``) whose ray
    passes through the target centre, for each limb plane."""
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    centre = np.hypot(xx - disc[0], yy + row0 - disc[1]) < 0.5
    return {name: centre for name in LIMB_PLANES}


def check_against_plain(label, got, ref, disc, row0=0.0) -> dict:
    """
    The kernel's planes against the plain float64 version's, at the JAX
    package's kernel table (testing/compare.py), with the reference stored
    in float32 as the kernel stores it. The one pixel whose ray passes
    through the target centre (when a pixel centre sits on the disc
    centre) is left out of the limb planes: its limb coordinates are
    undefined and both versions return rounding noise there.
    """
    shape = next(iter(got.values())).shape
    reports = compare.compare_backplanes(
        got, ref, float32_ulps=1, exclude=centre_pixel(shape, disc, row0),
    )
    log(f'[{label}] per plane (max_abs_err, mask_flips, lst_bin_flips): '
        + json.dumps({
            k: (r['max_abs_err'], r['mask_flips'], r['lst_bin_flips'])
            for k, r in reports.items()
        }))
    bad = compare.failures(reports)
    if bad:
        raise SmokeFailure(f'{label}: kernel differs from plain version: {bad}')
    log(f'[{label}] kernel matches the plain version on {len(reports)} planes')
    return reports


def build_phase() -> None:
    libraries = [bk.LIBRARY, mik.LIBRARY, msp.LIBRARY, msk.LIBRARY,
                 pk.LIBRARY, dskk.LIBRARY]
    t0 = time.perf_counter()
    cuda_build.build_all(libraries)
    log(f'[build] {len(libraries)} nvcc builds in parallel + load '
        f'{time.perf_counter() - t0:.1f} s; nvcc per library: '
        + ', '.join(f'{lib.name} {lib.build_seconds:.1f} s'
                    for lib in libraries))
    for library in libraries:
        entry, spills = '', ''
        for line in library.ptxas_log().splitlines():
            if 'Compiling entry function' in line:
                # the template arguments <kx, ky> or <op> in the mangled
                # name
                degrees = re.search(r'ILi(\d)ELi(\d)E', line)
                op = re.search(r'(dsk_pairs|dsk_atan2)(?:ILi(\d)E)?', line)
                entry = f'<kx={degrees[1]}, ky={degrees[2]}> ' if degrees \
                    else ''
                if 'backplanes26_batch_kernelILb0E' in line:
                    entry = 'batched, linear blocks '
                elif 'backplanes26_batch_kernelILb1E' in line:
                    entry = 'batched, tiles '
                elif 'backplanes26_kernelILb1E' in line:
                    entry = 'frame of a batch '
                elif 'pchip_axis_kernelILi1E' in line:
                    entry = 'a line a block '
                elif 'pchip_axis_kernelILi4E' in line:
                    entry = '4 adjacent lines a block '
                if op:
                    entry = (f'{op[1]}<{dskk.OPS[int(op[2])]}> ' if op[2]
                             else f'{op[1]} ')
            elif 'spill' in line:
                spills = line.split(',', 1)[-1].strip()
            elif 'registers' in line:
                log(f'[build] {library.name} {entry}ptxas: '
                    f'{line.split(":", 1)[-1].strip()}; {spills}')
    occ = bk.occupancy()
    for name, kernel in (
            ('backplanes26', occ),
            ('backplanes26_batch, linear blocks', bk.occupancy('linear')),
            ('backplanes26_batch, tiles', bk.occupancy('tiles')),
            ('pchip_axis, 4 adjacent lines a block', pk.occupancy())):
        log(f'[build] {name} on {torch.cuda.get_device_name(0)}: '
            f'{kernel["registers"]} registers, {kernel["local_bytes"]} bytes '
            f'of local memory per thread, {kernel["blocks_per_sm"]} resident '
            'blocks of 256 threads per SM')
    smooth = msk.occupancy()
    log(f'[build] map_smooth: {smooth["registers"]} registers, '
        f'{smooth["local_bytes"]} bytes of local memory per thread, '
        f'{smooth["blocks_per_sm"]} resident blocks of 256 threads per SM')
    infill = mik.occupancy()
    log(f'[build] map_infill (stencil, selection): {infill["registers"]} '
        f'registers, {infill["local_bytes"]} bytes of local memory per '
        f'thread, {infill["blocks_per_sm"]} resident blocks per SM')
    return occ


def spline_occupancy(calls) -> None:
    """Registers, local bytes and blocks per SM of the main map_spline
    instances, at the shared memory of the main path's launches."""
    seen = set()
    for label, kind, args, kw, _ in calls.calls:
        degrees = (kw.get('kx'), kw.get('ky'))
        if kind != 'spline' or degrees not in MAIN_SPLINE_DEGREES or \
                degrees in seen:
            continue
        seen.add(degrees)
        ty, tx, coeffs = args[3], args[4], args[5]
        *_, smem = msp.launch_plan(ty.numel(), tx.numel(), kw.get('uniform'))
        occ = msp.occupancy(*degrees, smem)
        log(f'[build] map_spline <kx={degrees[0]}, ky={degrees[1]}> ({label}, '
            f'{smem} bytes of shared memory): {occ["registers"]} registers, '
            f'{occ["local_bytes"]} bytes of local memory per thread, '
            f'{occ["blocks_per_sm"]} resident blocks of 256 threads per SM')


def main_path_phase(device, size=SIZE, disc=DISC):
    """compute_backplanes on the full frame, checked and held to the plain."""
    t0 = time.perf_counter()
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                     device=device)
    body.set_disc_params(*disc)
    inputs = pipeline.pipeline_inputs(body)
    log(f'[scene] BodyXY + anchors {time.perf_counter() - t0:.2f} s on '
        f'{body.device}; Jupiter at {body.target_distance / AU_KM:.3f} AU')
    _, use_pallas = pipeline.select_pipeline_impl(body, size, size)
    log(f'[main] selected implementation: '
        f'{"CUDA kernel" if use_pallas else "plain graph"}')

    if device.type == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_count()
    t0 = time.perf_counter()
    main_out = pipeline.compute_backplanes(body)
    main_ms = (time.perf_counter() - t0) * 1e3
    launches = bk.launch_count()
    peak = torch.cuda.max_memory_allocated() if device.type == 'cuda' else 0
    log(f'[main] compute_backplanes {main_ms:.1f} ms (first call), kernel '
        f'launches {launches}, peak device memory {peak / 2**20:.1f} MiB')

    if set(main_out) != set(bk.PLANE_ORDER):
        raise SmokeFailure(f'main path returned {sorted(main_out)}')
    if any(plane.shape != (size, size) for plane in main_out.values()):
        raise SmokeFailure('main path returned planes of the wrong shape')
    frac = float(np.isfinite(main_out['EMISSION']).mean())
    phase = float(np.nanmean(main_out['PHASE']))
    log(f'[main] on-disc fraction {frac:.4f}, mean phase {phase:.3f} deg')
    # pi r0^2 (rp / re) / size^2 of the frame, and the synthetic scene's
    # ~11 deg phase angle
    expected = np.pi * disc[2] ** 2 * (66854.0 / 71492.0) / size**2
    if abs(frac - expected) > 0.01 or not 2.0 < phase < 15.0:
        raise SmokeFailure('main path output is not the expected disc')
    for name in ('RA', 'DEC', 'KM-X', 'PIXEL-X'):
        if not np.isfinite(main_out[name]).all():
            raise SmokeFailure(f'{name} has non-finite values')

    plain = pipeline.fused_backplanes_fn(**FLAGS)
    reports = check_against_plain(
        f'main {size}x{size}', main_out,
        to_numpy(one_frame(plain, size, size, inputs, device)), disc,
    )
    n_disc = int(np.isfinite(main_out['EMISSION']).sum())
    return body, inputs, launches, peak, reports, n_disc


def cases_phase(device) -> None:
    """Ragged shape, row0 band, optimize_speed off, plane subsets."""
    nx, ny, disc = RAGGED
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=nx, ny=ny,
                     device=device)
    body.set_disc_params(*disc)
    inputs = pipeline.pipeline_inputs(body)
    row0, rows = BAND
    full = None
    for speed in (True, False):
        kern = bk.build_backplanes_kernel(
            optimize_speed=speed, lst_quant=True, **FLAGS,
        )
        plain = pipeline.fused_backplanes_fn(optimize_speed=speed, **FLAGS)
        frame = to_numpy(one_frame(kern, nx, ny, inputs, device))
        check_against_plain(
            f'ragged {nx}x{ny} optimize_speed={speed}', frame,
            to_numpy(one_frame(plain, nx, ny, inputs, device)), disc,
        )
        band = to_numpy(one_frame(kern, nx, rows, inputs, device,
                                   float(row0)))
        check_against_plain(
            f'row0={row0} band optimize_speed={speed}', band,
            to_numpy(one_frame(plain, nx, rows, inputs, device, float(row0))),
            disc,
            row0=row0,
        )
        for name, plane in band.items():
            if not np.array_equal(plane, frame[name][row0:row0 + rows],
                                  equal_nan=True):
                raise SmokeFailure(f'row0 band differs from the frame: {name}')
        log(f'[row0] band equals rows {row0}:{row0 + rows} of the frame '
            f'(optimize_speed={speed})')
        if speed:
            full = frame
    triaxial_case(nx, ny, disc, inputs, device)
    for planes in SUBSETS:
        sub = to_numpy(one_frame(bk.build_backplanes_kernel(
            optimize_speed=True, lst_quant=True, planes=planes, **FLAGS,
        ), nx, ny, inputs, device))
        if set(sub) != set(planes):
            raise SmokeFailure(f'subset {planes} returned {sorted(sub)}')
        for name in planes:
            if not np.array_equal(sub[name], full[name], equal_nan=True):
                raise SmokeFailure(f'subset {planes}: {name} differs')
    log(f'[subsets] {len(SUBSETS)} subsets equal the full set exactly')


def triaxial_case(nx, ny, disc, inputs, device) -> None:
    """A triaxial body (4 Bowring steps) against the robust plain graph."""
    xy2angular, disc_t, radii, anchors = inputs
    radii = radii * np.array(TRIAXIAL_SCALE)
    inputs = (xy2angular, disc_t, radii, anchors)

    # _kernel_geodetic_iters reads only a body's radii
    shape = type('Shape', (), {'radii': radii})()
    iters = pipeline._kernel_geodetic_iters(shape)
    if iters != 4:
        raise SmokeFailure(f'triaxial radii take {iters} Bowring steps')
    kern = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, geodetic_iters=iters, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(
        optimize_speed=True, robust_geodetic=True, **FLAGS,
    )
    launches = bk.launch_count()
    got = to_numpy(one_frame(kern, nx, ny, inputs, device))
    if bk.launch_count() != launches + 1:
        raise SmokeFailure('the triaxial case launched no kernel')
    check_against_plain(
        f'triaxial radii x {TRIAXIAL_SCALE} {nx}x{ny}', got,
        to_numpy(one_frame(plain, nx, ny, inputs, device)), disc,
    )


def timing_phase(body, inputs, card: str) -> dict[str, float]:
    """
    The kernel and its plain version at the full frame; the main path's
    call as a caller pays for it; one blocked call with the copy out.

    - device time (CUDA events, calls queued behind a device-side sleep):
      the kernel alone, on a packed scene, and the plain float64 graph;
    - one synchronised call (host clock, median): the kernel alone on a
      packed scene; the kernel's call, ``impl.frames``, which packs the
      scene first; the main path, ``compute_backplanes(body,
      as_numpy=False)``, which also reads the inputs from the body;
    - the main path back to back (host clock, one synchronise at the end);
    - the packing alone (host clock): whole, and the frame part over the
      shared part that the kernel keeps.
    """
    kern = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(**FLAGS)
    device = body.device
    xy2angular, disc, radii, anchors = inputs
    scene = bk.pack_scenes(xy2angular[None], disc[None], radii, anchors)

    def kernel():
        kern._launch(scene, SIZE, SIZE, device=device)

    def main_path():
        pipeline.compute_backplanes(body, as_numpy=False)

    device_ms = in_turns(
        {'kernel': (kernel, 50),
         'plain': (lambda: one_frame(plain, SIZE, SIZE, inputs, device), 5)},
        cuda_time_ms)
    call_ms = in_turns({
        'kernel': (kernel, 20),
        'kernel\'s call': (lambda: one_frame(kern, SIZE, SIZE, inputs,
                                             device), 20),
        'main path': (main_path, 20),
    }, host_clock_ms)
    back_ms = in_turns({'main path': (main_path, 50)}, back_to_back_ms)
    reps = 500
    pack_us = {}
    for name, shared in (('whole', None), ('frame part', scene[0])):
        t0 = time.perf_counter()
        for _ in range(reps):
            bk.pack_scenes(xy2angular[None], disc[None], radii, anchors,
                           shared=shared)
        pack_us[name] = (time.perf_counter() - t0) * 1e6 / reps
    log(f'[time] {card} | {SIZE}x{SIZE} device ms per call (CUDA events, '
        f'two turns): {json.dumps(device_ms)}')
    log(f'[time] {card} | {SIZE}x{SIZE} ms of one synchronised call (host '
        f'clock, median of 20, two turns): {json.dumps(call_ms)}')
    log(f'[time] {card} | {SIZE}x{SIZE} main path back to back (host clock '
        f'per call over 50, two turns): {json.dumps(back_ms)}; pack_scenes '
        f'of one frame, us per call (host clock, {reps} calls): '
        f'{json.dumps(pack_us)}')
    prep = np.mean(call_ms['main path']) - np.mean(call_ms['kernel'])
    log(f'[time] {card} | the main path\'s call takes {prep * 1e3:.1f} us '
        'more than the kernel alone, both synchronised')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.compute_backplanes(body)
    log(f'[time] {card} | one blocked compute_backplanes (planes to numpy) '
        f'{(time.perf_counter() - t0) * 1e3:.2f} ms')
    return {name: float(np.mean(t)) for name, t in device_ms.items()}


# ---------------------------------------------------------------------------
# [batch], [timeseries], [sharded], [fit]: the batch entry and parallel/
# ---------------------------------------------------------------------------

#: The disc sweep of [batch]: 8 disc sets about the main path's disc
BATCH_FRAMES = 8
#: [batch]: frame sizes on each side of the route's threshold
#: (ops/backplanes_kernel.FRAME_LAUNCH_PIXELS)
ROUTE_SIZES = (640, 768)
#: bench.py:343's time series: 1000 epochs 60 s apart of a 50x50 frame
SERIES = dict(frames=1000, size=50, step_s=60.0, names=('EMISSION',
                                                        'LON-GRAPHIC'))
#: [fit]: the 1024^2 8-frame cube's disc, and the start of the fit
FIT_START = (+3.0, -2.5, 1.03)  # dx0, dy0 [px], r0 factor
FIT_STEPS = 150
#: [sharded]: the map source frame of sharded_map_img (with its NaN block)
SHARDED_MAP_SIZE = 1024


def sweep_discs(disc, n=BATCH_FRAMES) -> np.ndarray:
    """``n`` disc sets about ``disc``: shifted, scaled and rotated."""
    step = (np.arange(n, dtype=np.float64) - (n - 1) / 2) / 100.0
    return np.stack([disc[0] + 2.0 * disc[2] * step,
                     disc[1] - disc[2] * step, disc[2] * (1.0 + step),
                     disc[3] + 500.0 * step], axis=1)


def affines(body, discs) -> np.ndarray:
    """The xy2angular matrices of ``discs`` on ``body`` (its disc is
    restored after)."""
    keep = body.get_disc_params()
    out = []
    for disc in discs:
        body.set_disc_params(*disc)
        out.append(np.array(body._get_xy2angular_matrix()))
    body.set_disc_params(*keep)
    return np.stack(out)


def equal_planes(got: dict, ref: dict) -> list[str]:
    """The names of the planes of ``got`` that differ from ``ref``'s in any
    bit (NaN equal to NaN)."""
    return [k for k in ref
            if not torch.equal(torch.isnan(got[k]), torch.isnan(ref[k]))
            or not torch.equal(torch.nan_to_num(got[k]),
                               torch.nan_to_num(ref[k]))]


def route_checks(device) -> None:
    """
    [batch]: on each side of the route's threshold (ROUTE_SIZES), the disc
    sweep's frames through the batched kernel and through single-frame
    launches, bit for bit (26 planes); the route and layout each size
    takes.
    """
    for size in ROUTE_SIZES:
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                         device=device)
        scale = size / SIZE
        disc = (*(v * scale for v in DISC[:3]), DISC[3])
        body.set_disc_params(*disc)
        discs = sweep_discs(disc)
        _, _, radii, anchors = pipeline.pipeline_inputs(body)
        impl, _ = pipeline.select_pipeline_impl(body, size, size)
        sweep = (size, size, affines(body, discs), discs, radii, anchors)
        frames = impl.frames(*sweep, device=device, frame_launches=True)
        batched = impl.frames(*sweep, device=device, frame_launches=False)
        bad = equal_planes(batched, frames)
        if bad:
            raise SmokeFailure(f'{size}x{size}: the batched kernel differs '
                               f'from the single-frame launches in {bad}')
        plan = bk.batch_plan(BATCH_FRAMES, size, size)
        log(f'[batch] {BATCH_FRAMES}x{size}x{size}: the batched kernel '
            f'({"tiles" if plan.tiles else "linear blocks"}) equals the '
            'single-frame launches bit for bit (26 planes); the route takes '
            + ('single-frame launches' if bk.frame_route(size, size)
               else 'the batched kernel'))


def batch_phase(body, card: str) -> None:
    """
    [batch]: compute_backplanes_batch of the disc sweep at 2048x2048, all
    26 planes (frames this large take one single-frame launch each, in one
    call); each frame bit for bit against a single call; the batched
    kernel forced on the same scenes, bit for bit with the single-frame
    launches, frame 0 against the plain version; both routes by device time
    and the entry point against 8 synchronised single calls by host clock,
    in turns; the call's peak memory.
    """
    discs = sweep_discs(body.get_disc_params())
    xys = affines(body, discs)
    keep = body.get_disc_params()
    device = body.device
    frame_route = bk.frame_route(SIZE, SIZE)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_batch_launch_count()
    bk.reset_launch_count()
    t0 = time.perf_counter()
    out = pipeline.compute_backplanes_batch(body, xys, discs, as_numpy=False)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = (bk.launch_count(), bk.batch_launch_count())
    peak = (torch.cuda.max_memory_allocated() - live) / 2**20
    if launches != ((BATCH_FRAMES, 0) if frame_route else (0, 1)):
        raise SmokeFailure(f'compute_backplanes_batch made {launches} '
                           '(single-frame, batched) launches')
    if set(out) != set(bk.PLANE_ORDER) or any(
            v.shape != (BATCH_FRAMES, SIZE, SIZE) for v in out.values()):
        raise SmokeFailure('compute_backplanes_batch returned the wrong '
                           'planes or shapes')
    log(f'[batch] compute_backplanes_batch of {BATCH_FRAMES} discs at '
        f'{SIZE}x{SIZE}: (single-frame, batched) launches {launches}, '
        f'first call {first_ms:.1f} ms, peak {peak:.1f} MiB above what was '
        'allocated before')
    for i, disc in enumerate(discs):
        body.set_disc_params(*disc)
        single = pipeline.compute_backplanes(body, as_numpy=False)
        bad = equal_planes({k: v[i] for k, v in out.items()}, single)
        if bad:
            raise SmokeFailure(f'batch frame {i} differs from a single call '
                               f'in {bad}')
    log(f'[batch] each of the {BATCH_FRAMES} frames equals its single '
        'compute_backplanes call bit for bit (26 planes)')

    # the batched kernel on the same scenes, against the single-frame ones
    impl, _ = pipeline.select_pipeline_impl(body, SIZE, SIZE)
    _, _, radii, anchors = pipeline.pipeline_inputs(body)
    sweep = (SIZE, SIZE, xys, discs, radii, anchors)
    batched = impl.frames(*sweep, device=device, frame_launches=False)
    bad = equal_planes(batched, out)
    if bad:
        raise SmokeFailure(f'the batched kernel differs from the '
                           f'single-frame launches in {bad}')
    plan = bk.batch_plan(BATCH_FRAMES, SIZE, SIZE)
    log(f'[batch] the batched kernel on the {BATCH_FRAMES} scenes '
        f'({"tiles" if plan.tiles else "linear blocks"}, {len(plan.launches)} '
        'launch) equals the single-frame launches bit for bit (26 planes)')
    route_checks(device)
    body.set_disc_params(*discs[0])
    plain = pipeline.fused_backplanes_fn(**FLAGS)
    check_against_plain('batch frame 0', to_numpy(
        {k: v[0] for k, v in batched.items()}),
        to_numpy(one_frame(plain, SIZE, SIZE, pipeline.pipeline_inputs(body),
                           device)), discs[0])
    del out, batched

    scenes = bk.pack_scenes(xys, discs, radii, anchors)
    device_ms = in_turns({
        'batched kernel': (lambda: impl._launch(
            scenes, SIZE, SIZE, device=device, frame_launches=False), 10),
        'single-frame launches': (lambda: impl._launch(
            scenes, SIZE, SIZE, device=device, frame_launches=True), 10),
        'plain, frame by frame': (
            lambda: plain.frames(*sweep, device=device), 1),
    }, cuda_time_ms)

    def entry_batch():
        pipeline.compute_backplanes_batch(body, xys, discs, as_numpy=False)

    def entry_singles():
        for disc in discs:
            body.set_disc_params(*disc)
            pipeline.compute_backplanes(body, as_numpy=False)
            torch.cuda.synchronize()

    host_ms = in_turns({'compute_backplanes_batch': (entry_batch, 10),
                        f'{BATCH_FRAMES} synchronised single calls':
                            (entry_singles, 10)}, host_clock_ms)
    body.set_disc_params(*keep)
    per_frame = {k: [t / BATCH_FRAMES for t in v]
                 for k, v in device_ms.items()}
    ratio = np.mean(device_ms['batched kernel']) / np.mean(
        device_ms['single-frame launches'])
    log(f'[batch] {card} | {BATCH_FRAMES}x{SIZE}x{SIZE} device ms per call '
        f'(CUDA events, two turns): {json.dumps(device_ms)}; per frame '
        f'{json.dumps(per_frame)}; batched kernel / single-frame launches '
        f'{ratio:.4f}')
    log(f'[batch] {card} | host ms of one synchronised call (median of 10, '
        f'two turns): {json.dumps(host_ms)}')


def timeseries_phase(device, card: str) -> dict:
    """
    [timeseries]: bench.py:343's 1000 epochs at 50x50 (EMISSION and
    LON-GRAPHIC), the call timed as a user makes it and split into the
    anchors (CPU tensors), the packing, the kernel (device time) and the
    copy out; 3 epochs held against per-body compute_backplanes; the same
    1000 frames with all 26 planes (the kernels line: every 100th frame
    against the plain version, the kernel's times beside the bound, and
    the kernel's call, which packs and uploads the scenes); 8 epochs at
    2048x2048 with all planes, frame 0 against the body's own call.
    """
    from planetmapper_tpu_torch.parallel import (
        backplane_time_series,
        timeseries,
    )

    size, n = SERIES['size'], SERIES['frames']
    names = SERIES['names']
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                     device=device)
    body.set_disc_params(size / 2, size / 2, size * 0.4, 0.0)
    ets = body.et + SERIES['step_s'] * np.arange(n)
    backplane_time_series(body, ets, names=names, as_numpy=False)  # warm
    torch.cuda.synchronize()
    bk.reset_batch_launch_count()
    t0 = time.perf_counter()
    cube = backplane_time_series(body, ets + 30.0, names=names,
                                 as_numpy=False)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = bk.batch_launch_count()
    t0 = time.perf_counter()
    host = {k: v.cpu().numpy() for k, v in cube.items()}
    copy_ms = (time.perf_counter() - t0) * 1e3
    if launches != 1:
        raise SmokeFailure(f'the time series made {launches} batched '
                           'launches, not one')
    if set(host) != set(names) or any(
            v.shape != (n, size, size) for v in host.values()):
        raise SmokeFailure('the time series has the wrong planes or shapes')
    if not all(np.isfinite(v).any(axis=(1, 2)).all() for v in host.values()):
        raise SmokeFailure('a time-series frame has no finite value')

    # its parts, each timed alone (host clock; the kernel by CUDA events)
    t0 = time.perf_counter()
    anchors, xys = timeseries._batched_pipeline_inputs(body, ets + 30.0)
    anchors_ms = (time.perf_counter() - t0) * 1e3
    discs = np.broadcast_to(np.asarray(body.get_disc_params()), (n, 4))
    radii = np.asarray(body.radii, dtype=np.float64)
    series = (size, size, xys, discs, radii, anchors)
    t0 = time.perf_counter()
    scenes = bk.pack_scenes(xys, discs, radii, anchors)
    pack_ms = (time.perf_counter() - t0) * 1e3
    impl, _ = pipeline.select_pipeline_impl(body, size, size,
                                            planes=tuple(names))
    scenes_dev = torch.from_numpy(scenes).to(device)
    kernel_ms = in_turns({'kernel': (lambda: impl._launch(
        scenes_dev, size, size, device=device), 20)},
        cuda_time_ms)['kernel']
    log(f'[timeseries] {card} | {n} epochs at {size}x{size} ({names}): the '
        f'call {call_ms:.1f} ms ({call_ms / n * 1e3:.2f} us a frame; '
        f'{launches} launch), the copy to numpy {copy_ms:.2f} ms; alone: '
        f'anchors and affines {anchors_ms:.1f} ms on '
        f'{pt._device.scene_device(n, device)} ({anchors_ms / n * 1e3:.2f} '
        f'us a frame), pack_scenes {pack_ms:.2f} ms, kernel {kernel_ms} ms '
        '(CUDA events, two turns)')

    # 3 epochs against per-body compute_backplanes
    for i in range(3):
        et = float(ets[i] + 30.0)
        single = timeseries._body_at_time(body, et)
        ref = pipeline.compute_backplanes(single, names=list(names))
        got = {k: host[k][i] for k in names}
        check_against_plain(f'time series epoch {i} vs its own body', got,
                            ref, body.get_disc_params())

    # the kernels line: the 1000 frames with all 26 planes, bit for bit
    # against single-frame launches
    full, _ = pipeline.select_pipeline_impl(body, size, size)
    every = full.frames(*series, device=device)
    bad = equal_planes(every, full.frames(*series, device=device,
                                          frame_launches=True))
    if bad:
        raise SmokeFailure(f'the {n} batched frames differ from single-frame '
                           f'launches in {bad}')
    plan = bk.batch_plan(n, size, size)
    log(f'[timeseries] the {n} frames with 26 planes through the batched '
        f'kernel ({"tiles" if plan.tiles else "linear blocks"} of '
        f'{plan.threads} threads, {plan.blocks_per_frame} blocks a frame, '
        f'{len(plan.launches)} launch) equal {n} single-frame launches bit '
        'for bit')
    plain = pipeline.fused_backplanes_fn(**FLAGS)

    def plain_frame(i):
        out = plain.frames(size, size, xys[i:i + 1], discs[i:i + 1], radii,
                           {k: v[i:i + 1] for k, v in anchors.items()},
                           device=device)
        return {k: v[0] for k, v in out.items()}

    errors = []
    for i in range(0, n, 100):
        reports = check_against_plain(
            f'time series frame {i}, 26 planes',
            to_numpy({k: v[i] for k, v in every.items()}),
            to_numpy(plain_frame(i)), discs[i])
        errors.append(max(reports[k]['max_abs_err'] for k in ANGLE_PLANES
                          if np.isfinite(reports[k]['max_abs_err'])))
    n_discs = torch.isfinite(every['EMISSION']).sum(dim=(1, 2)).tolist()
    del every
    full_ms = in_turns({
        'kernel': (lambda: full._launch(scenes_dev, size, size,
                                        device=device), 20),
        'kernel\'s call': (lambda: full.frames(*series, device=device), 20),
        'plain': (lambda: plain.frames(*series, device=device), 1),
    }, cuda_time_ms)
    bound = bounds.backplane_batch_bound(size, size, n_discs)
    log(f'[timeseries] {card} | backplanes26_batch, {n} frames of '
        f'{size}x{size}, 26 planes: device ms per call (CUDA events, two '
        f'turns) {json.dumps(full_ms)}; bound {bound["ms"]:.4f} ms '
        f'({bound["bound_by"]}: {bound["bytes"]} bytes, {bound["f64_ops"]} '
        f'FP64 + {bound["f32_ops"]} FP32 operations, {sum(n_discs)} on-disc '
        f'pixels); kernel at {bound["ms"] / np.mean(full_ms["kernel"]):.1%} '
        'of it')

    # 8 epochs at 2048^2, all planes
    big = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                    device=device)
    big.set_disc_params(*DISC)
    big_ets = big.et + SERIES['step_s'] * np.arange(BATCH_FRAMES)
    backplane_time_series(big, big_ets, as_numpy=False)  # warm
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_batch_launch_count()
    bk.reset_launch_count()
    t0 = time.perf_counter()
    cube = backplane_time_series(big, big_ets, as_numpy=False)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3
    big_launches = (bk.launch_count(), bk.batch_launch_count())
    peak = (torch.cuda.max_memory_allocated() - live) / 2**20
    if big_launches != (BATCH_FRAMES, 0) or set(cube) != set(bk.PLANE_ORDER):
        raise SmokeFailure('the 2048^2 time series is not one single-frame '
                           'launch a frame of 26 planes')
    check_against_plain(f'time series {SIZE}x{SIZE} epoch 0 vs its body',
                        to_numpy({k: v[0] for k, v in cube.items()}),
                        pipeline.compute_backplanes(big), DISC)
    log(f'[timeseries] {card} | {BATCH_FRAMES} epochs at {SIZE}x{SIZE}, 26 '
        f'planes: {big_ms:.1f} ms ((single-frame, batched) launches '
        f'{big_launches}), peak {peak:.1f} MiB')
    return dict(launches=launches, ms=float(np.mean(full_ms['kernel'])),
                plain_ms=float(np.mean(full_ms['plain'])), bound=bound,
                max_abs_err=float(max(errors)))


def sharded_phase(device, card: str) -> None:
    """
    [sharded]: a 4-entry mesh of the one card: sharded_backplanes at
    2048x2048 and sharded_map_img from the 1024x1024 frame onto the
    720x1440 map ('linear' and 'cubic'), each equal to the unsharded
    result.
    """
    from planetmapper_tpu_torch.parallel import (
        make_mesh,
        sharded_backplanes,
        sharded_map_img,
    )

    mesh = make_mesh(4, device=device)
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                     device=device)
    body.set_disc_params(*DISC)
    full = pipeline.compute_backplanes(body, as_numpy=False)
    launches = bk.launch_count()
    sharded, ms, _ = synchronised(lambda: sharded_backplanes(body, mesh))
    if bk.launch_count() - launches != 4:
        raise SmokeFailure('sharded_backplanes did not launch kernel 1 once '
                           'per mesh entry')
    bad = equal_planes(sharded, full)
    if bad or sharded['EMISSION'].device.type != device.type:
        raise SmokeFailure(f'sharded_backplanes differs from the unsharded '
                           f'frame in {bad}')
    log(f'[sharded] {card} | sharded_backplanes on {mesh}: {ms:.2f} ms, 4 '
        f'launches of {SIZE // 4} rows, equal to compute_backplanes bit for '
        'bit')
    size = SHARDED_MAP_SIZE
    mbody = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                      device=device)
    mbody.set_disc_params(*MAP_BODIES[size])
    img = map_images(size, size)[1]
    for mode in ('linear', 'cubic'):
        ref = mbody.map_img(img, interpolation=mode, as_numpy=True,
                            **MAP_KW)
        got, ms, _ = synchronised(lambda: sharded_map_img(
            mbody, img, mesh, interpolation=mode, **MAP_KW))
        if got.shape != MAP_SHAPE or not np.array_equal(
                got, ref.astype(np.float64), equal_nan=True):
            raise SmokeFailure(f'sharded_map_img {mode} differs from map_img')
        log(f'[sharded] {card} | sharded_map_img {mode} from {size}^2 onto '
            f'{MAP_SHAPE}: {ms:.2f} ms, equal to map_img bit for bit')


def fit_phase(device, card: str) -> None:
    """
    [fit]: fit_disc_gradient on a card Observation of the [observation]
    1024x1024 8-frame cube, from a disc off the truth, 150 Adam steps;
    the time and the recovered disc against the truth.
    """
    from planetmapper_tpu_torch.parallel import fit_disc_gradient

    truth = MAP_BODIES[OBS_SIZE]
    with tempfile.TemporaryDirectory(prefix='fit_') as tmp:
        path = os.path.join(tmp, 'observation_1024.fits')
        cube = disc_cube(map_images(OBS_SIZE, OBS_SIZE)[2], truth)
        write_observation(path, cube, truth, UTC)
        obs = pt.Observation(path, device=device)
    dx, dy, scale = FIT_START
    start = (truth[0] + dx, truth[1] + dy, truth[2] * scale, truth[3])
    obs.set_disc_params(*start)
    fitted, ms, peak = synchronised(
        lambda: fit_disc_gradient(obs, n_steps=FIT_STEPS))
    # the cube's disc is a circle of radius r0; the render is the body's
    # ellipse, whose area equals the circle's at r0 / sqrt(rp / re)
    radii = np.asarray(obs.radii)
    r0_equal_area = truth[2] / np.sqrt(radii[2] / radii[0])
    err = [fitted[0] - truth[0], fitted[1] - truth[1],
           fitted[2] / r0_equal_area - 1.0]
    log(f'[fit] {card} | fit_disc_gradient, {FIT_STEPS} steps on the '
        f'{OBS_SIZE}^2 {cube.shape[0]}-frame cube: {ms:.1f} ms '
        f'({ms / FIT_STEPS:.3f} ms a step), peak {peak:.1f} MiB; from '
        f'{start[:3]} to ({fitted[0]:.3f}, {fitted[1]:.3f}, {fitted[2]:.3f})'
        f', truth {truth[:3]} (r0 of the ellipse of the same area '
        f'{r0_equal_area:.3f}): x0 {err[0]:+.3f} px, y0 {err[1]:+.3f} px, '
        f'r0 {err[2]:+.4%}')
    if abs(err[0]) > 1.0 or abs(err[1]) > 1.0 or abs(err[2]) > 0.01 \
            or obs.get_disc_method() != 'fit_gradient':
        raise SmokeFailure('fit_disc_gradient did not recover the disc')


# ---------------------------------------------------------------------------
# map_img on the 720x1440 map
# ---------------------------------------------------------------------------

class KernelCalls:
    """
    Records every call of the four map kernel wrappers made by ``map_img``
    (their inputs and outputs), so that each output can be held against
    the plain version on the same inputs. Wraps the names the device
    modules call; the wrappers themselves, and their launch counts, are
    untouched.
    """

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def recording(self, label):
        originals = (interp_device.map_spline, pchip_device.map_smooth,
                     pchip_device.pchip_axis, interp_device.map_infill)

        def wrap(kind, fn):
            def recorded(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.calls.append((label, kind, args, kwargs, out))
                return out
            return recorded

        interp_device.map_spline = wrap('spline', originals[0])
        pchip_device.map_smooth = wrap('smooth', originals[1])
        pchip_device.pchip_axis = wrap('pchip', originals[2])
        interp_device.map_infill = wrap('infill', originals[3])
        try:
            yield
        finally:
            (interp_device.map_spline, pchip_device.map_smooth,
             pchip_device.pchip_axis, interp_device.map_infill) = originals


def map_runs():
    """(size, label, interpolation, image key) of the map main path."""
    runs = []
    for mode in ('nearest', 'linear', 'cubic', (3, 1), 'smooth'):
        for key in ('frame', 'with_nan'):
            runs.append((150, mode, key))
    for mode in ('linear', 'cubic', 'smooth'):
        runs.append((150, mode, 'cube'))
    for mode in ('linear', 'cubic'):
        runs.append((1024, mode, 'with_nan'))
        runs.append((1024, mode, 'cube'))
    # spline degrees 5 and 4: the kernel has instances for degrees 1..5
    runs += [(150, 5, 'with_nan'), (1024, 4, 'with_nan')]
    return [(size, f'{size}^2 {mode} {key}', mode, key)
            for size, mode, key in runs]


def compare_pchip_with_plain(label, args, kwargs, out,
                             phase='map') -> float:
    """The PCHIP kernel against its plain version on the same inputs: the
    same float64 values bit for bit (both round every operation alike)."""
    ref = pk.pchip_axis_plain(*args, **kwargs)
    flips = int((torch.isnan(out) != torch.isnan(ref)).sum())
    both = ~torch.isnan(ref)
    err = float((out[both] - ref[both]).abs().max()) if both.any() else 0.0
    log(f'[{phase}] {label}: pchip kernel (axis {kwargs["axis"]}, '
        f'{tuple(out.shape)}) vs plain: mask flips {flips}, max_abs_err '
        f'{err:.3e} (bar 0: bit for bit), {int(both.sum())} finite values')
    if out.dtype != torch.float64 or flips or err != 0.0:
        raise SmokeFailure(f'{label}: pchip kernel differs from plain')
    return err


def compare_infill_with_plain(label, args, out, phase='map') -> float:
    """The infill kernel against its plain version on the same frames (on
    the host): cleaned, the NaN grid and the finite counts bit for bit
    (torch.equal, as the card tests)."""
    frames = args[0]
    ref = mik.map_infill_plain(frames.cpu())
    got = [t.cpu() for t in out]
    equal = [g.dtype == r.dtype and torch.equal(g, r)
             for g, r in zip(got, ref)]
    err = float((got[0] - ref[0]).abs().max())
    partial = int((ref[2] < frames.shape[-2] * frames.shape[-1]).sum())
    log(f'[{phase}] {label}: infill kernel ({tuple(frames.shape)}, '
        f'{partial} frame(s) with a non-finite cell, '
        f'{int((~torch.isfinite(frames)).sum())} non-finite cells) vs plain: '
        f'cleaned, nans, finite equal {equal}, max_abs_err {err:.3e} (bar 0: '
        'bit for bit)')
    if not all(equal) or err != 0.0:
        raise SmokeFailure(f'{label}: infill kernel differs from plain')
    return err


def compare_with_plain(label, kind, size, args, kwargs, out,
                       phase='map') -> float:
    if kind == 'pchip':
        return compare_pchip_with_plain(label, args, kwargs, out, phase)
    if kind == 'infill':
        return compare_infill_with_plain(label, args, out, phase)
    plain_fn = msp.map_spline_plain if kind == 'spline' else \
        msk.map_smooth_plain
    ref = plain_fn(*args, **kwargs).cpu().numpy()
    got = out.cpu().numpy()
    if got.shape != ref.shape or got.dtype != np.float32:
        raise SmokeFailure(f'{label}: {kind} kernel returned {got.shape} '
                           f'{got.dtype}, plain {ref.shape}')
    flips = int((np.isnan(got) != np.isnan(ref)).sum())
    both = ~np.isnan(ref)
    err = float(np.max(np.abs(got[both] - ref[both]))) if both.any() else 0.0
    scale = float(np.max(np.abs(ref[both]))) if both.any() else 0.0
    ulps = 0.0
    if both.any():
        ulps = float(np.max(
            np.abs(got[both].astype(np.float64) - ref[both])
            / np.spacing(np.maximum(np.abs(ref[both]), np.float32(1e-6)))
        ))
    bar = MAP_BARS[(kind, size)]
    log(f'[{phase}] {label}: {kind} kernel vs plain: mask flips {flips}, '
        f'max_abs_err {err:.3e} (bar {bar * max(scale, 1.0):.3e}), '
        f'max {ulps:.1f} float32 ulps, {int(both.sum())} finite values')
    if flips or err > bar * max(scale, 1.0):
        raise SmokeFailure(f'{label}: {kind} kernel differs from plain')
    return err


def small_map_check(device) -> None:
    """map_img on the card against the host scipy reference, small map."""
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=150,
                     device=device)
    body.set_disc_params(*MAP_BODIES[150])
    _, img, _ = map_images(150, 1)
    kw = dict(degree_interval=5)
    x_map, y_map = body.get_x_map(**kw), body.get_y_map(**kw)
    for mode in ('linear', 'cubic', 'smooth'):
        got = body.map_img(img, interpolation=mode, as_numpy=True, **kw)
        ref = np.full(x_map.shape, np.nan)
        if mode == 'smooth':
            interp.smooth_interpolation(
                img, x_map, y_map, ref, propagate_nan=True, oversample_by=5,
                max_oversampled_img_size=10_000,
            )
        else:
            interp.spline_interpolation(
                img, x_map, y_map, ref, interpolation=3 if mode == 'cubic'
                else 1, warn_nan=False, propagate_nan=True,
                spline_smoothing=0,
            )
        both = ~np.isnan(ref)
        err = float(np.max(np.abs(got[both] - ref[both])))
        if not np.array_equal(np.isnan(got), np.isnan(ref)) or err > 2e-5 * \
                max(float(np.max(np.abs(ref[both]))), 1.0):
            raise SmokeFailure(f'small {mode} map differs from the host '
                               f'scipy reference by {err}')
        log(f'[map] 36x72 {mode} map_img vs host scipy reference: same NaN '
            f'mask, max_abs_err {err:.3e}')


def xy_against_cpu_body(body, size, disc) -> None:
    """The x/y, illumination and RA/Dec maps of a card body against a CPU
    body's on a 180x360 map (bulk: it runs on the card), flips counted."""
    cpu = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                    device='cpu')
    cpu.set_disc_params(*disc)
    kw = dict(degree_interval=1)
    report = {}
    # the bars of tests/test_torch_cuda.py::test_cuda_body_map_chain_...:
    # x/y to 8 ulps of an RA between 256 and 512 deg, in pixels
    ra_ulp_px = 2.0**-44 * 3600.0 / body.get_plate_scale_arcsec()
    bars = {'_illumf_map': 1e-8, '_radec_map': 1e-9, '_xy_map': 8 * ra_ulp_px}
    for name, bar in bars.items():
        got = getattr(body, name)(**kw)
        if got.device.type != body.device.type:
            raise SmokeFailure(f'{name} of the 180x360 map on {got.device}')
        a, b = got.cpu().numpy(), getattr(cpu, name)(**kw).numpy()
        flips = int((np.isfinite(a) != np.isfinite(b)).sum())
        if name == '_illumf_map':
            flips += int((a[..., 3:] != b[..., 3:]).sum())
            a, b = a[..., :3], b[..., :3]
        both = np.isfinite(a) & np.isfinite(b)
        err = float(np.max(np.abs(a[both] - b[both])))
        report[name] = (flips, err)
        if flips > a[..., 0].size // 10**4 or err > bar:
            raise SmokeFailure(f'{name}: card vs CPU body: {flips} mask '
                               f'flips, max_abs_err {err:.3e} (bar {bar})')
    log(f'[map] {size}^2 body, 180x360 map, card vs CPU body (mask flips, '
        f'max_abs_err): {json.dumps(report)}; bars {json.dumps(bars)} (deg, '
        'deg, px)')


def map_phase(device):
    """map_img main path: run, count launches, check against plain."""
    bodies, images = {}, {}
    for size, disc in MAP_BODIES.items():
        t0 = time.perf_counter()
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                         device=device)
        body.set_disc_params(*disc)
        built = time.perf_counter() - t0
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        samples = body._get_map_samples(**MAP_KW)
        torch.cuda.synchronize()
        xy_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - live) / 2**20
        where = {body._xy_map(**MAP_KW).device.type, samples.x.device.type}
        log(f'[map] {size}^2 body: BodyXY {built:.2f} s; x/y maps '
            f'{samples.shape} ({float(samples.valid.float().mean()):.4f} '
            f'valid) {xy_ms:.1f} ms on {"/".join(sorted(where))} (lonlat -> '
            'targvec -> illumination -> obsvec -> RA/Dec -> x/y in float64, '
            'MapSamples and limits; host clock, synchronised), peak device '
            f'memory of the chain {peak:.1f} MiB above what was allocated')
        if where != {device.type}:
            raise SmokeFailure(f'the x/y maps ran on {where}, not {device}')
        if samples.shape != MAP_SHAPE:
            raise SmokeFailure(f'map shape {samples.shape}')
        xy_against_cpu_body(body, size, disc)
        bodies[size] = body
        frame, with_nan, cube = map_images(size, size)
        images[size] = dict(frame=frame, with_nan=with_nan, cube=cube)

    runs = map_runs()
    calls = KernelCalls()
    outputs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for lib in (mik, msp, msk, pk):
        lib.reset_launch_count()
    t0 = time.perf_counter()
    for size, label, mode, key in runs:
        with calls.recording(label):
            outputs[label] = bodies[size].map_img(
                images[size][key], interpolation=mode, **MAP_KW
            )
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {'map_infill': mik.launch_count(),
                'map_spline': msp.launch_count(),
                'map_smooth': msk.launch_count(),
                'pchip_axis': pk.launch_count()}
    peak = torch.cuda.max_memory_allocated()
    log(f'[map] {len(runs)} map_img calls {elapsed:.2f} s (first calls), '
        f'kernel launches {launches}, peak device memory '
        f'{peak / 2**20:.1f} MiB')
    spline_runs = sum(m not in ('nearest', 'smooth') for *_, m, _ in runs)
    expected = {
        # one launch a spline map_img, frame or cube
        'map_infill': spline_runs,
        'map_spline': spline_runs,
        'map_smooth': sum(m == 'smooth' for *_, m, _ in runs),
        # one launch per axis, for frames and cubes alike
        'pchip_axis': 2 * sum(m == 'smooth' for *_, m, _ in runs),
    }
    if launches != expected:
        raise SmokeFailure(f'map_img launched {launches}, expected {expected}')

    for size, label, mode, key in runs:
        out = outputs[label]
        want = ((MAP_CUBE_FRAMES[size],) if key == 'cube' else ()) + MAP_SHAPE
        if tuple(out.shape) != want or out.device.type != device.type:
            raise SmokeFailure(f'{label}: map of shape {tuple(out.shape)} on '
                               f'{out.device}')
        first = (out[0] if key == 'cube' else out).cpu().numpy()
        frac = float(np.isfinite(first).mean())
        # half of the 0.25-deg map is on the visible hemisphere
        if not 0.4 < frac < 0.6:
            raise SmokeFailure(f'{label}: finite fraction {frac:.4f}')
    errors = {'spline': 0.0, 'smooth': 0.0, 'pchip': 0.0, 'infill': 0.0}
    for label, kind, args, kwargs, out in calls.calls:
        size = int(label.split('^')[0])
        err = compare_with_plain(label, kind, size, args, kwargs, out)
        errors[kind] = max(errors[kind], err)
    small_map_check(device)
    return bodies, images, calls, launches, errors, peak


def time_pair(name, kernel, plain, library, flush, reps=(200, 10, 200, 50),
              phase='map-time'):
    """
    Kernel, plain version and library yardstick, in turns after warm-up:
    back to back (warm L2) for all three, and one call after an L2 flush
    (cold) for the kernel and the yardstick. ``kernel`` and ``library`` in
    the result are the cold times.
    """
    runs = {'kernel': (kernel, reps[0]), 'plain': (plain, reps[1])}
    if library is not None:
        runs['library'] = (library, reps[2])
    warm = in_turns(runs, cuda_time_ms)
    cold = in_turns({k: (fn, reps[3]) for k, (fn, _) in runs.items()
                     if k != 'plain'},
                    lambda fn, n: cold_time_ms(fn, n, flush))
    log(f'[{phase}] {name}: ms per call (two turns each), back to back: '
        + json.dumps(warm) + f'; cold L2 (median of {reps[3]}): '
        + json.dumps(cold))
    out = {f'{k}_warm': float(np.mean(v)) for k, v in warm.items()}
    out.update({k: float(np.mean(v)) for k, v in cold.items()})
    out['plain'] = out.pop('plain_warm')
    out.setdefault('library', None)
    return out


def normalised_grid(u, v, n_u, n_v):
    """grid_sample coordinates (align_corners=True) of grid positions."""
    g = torch.stack([2.0 * u / (n_u - 1) - 1.0, 2.0 * v / (n_v - 1) - 1.0],
                    dim=-1)
    return g.reshape(1, *MAP_SHAPE, 2)


def cube_pchip(by_label):
    """Both pchip launches of the 150^2 16-frame smooth cube, on its
    recorded inputs (new outputs)."""
    rows_args, _ = by_label[('150^2 smooth cube', 'pchip', -1)]
    cols_args, _ = by_label[('150^2 smooth cube', 'pchip', -2)]
    box, n_xs, kx_rep = rows_args
    rows_in, n_ys, ky_rep = cols_args
    device = box.device
    xs_rows = torch.linspace(0.0, box.shape[-1] - 1.0, n_xs,
                             dtype=torch.float64, device=device)
    xs_cols = torch.linspace(0.0, rows_in.shape[-2] - 1.0, n_ys,
                             dtype=torch.float64, device=device)
    rows_out = torch.empty_like(rows_in)
    grid = torch.empty((box.shape[0], n_ys, n_xs), dtype=torch.float64,
                       device=device)

    def launches():
        pk.launch(box, xs_rows, rows_out, k_rep=kx_rep, axis=-1)
        pk.launch(rows_out, xs_cols, grid, k_rep=ky_rep, axis=-2)
    return launches


def pchip_timing(by_label, smooth_args, smooth_kw, smooth_t, flush, card):
    """
    The PCHIP oversampling of the 150^2 smooth frame (its two launches,
    rows then columns, on the recorded inputs) cold and warm, its plain
    version, its bound; the whole smooth stage (the two launches and
    map_smooth) against its bound; cold torch.sum yardsticks over the
    sampler's buffers, the sampler's counted bytes and the stage's.
    """
    label = '150^2 smooth frame'
    rows_args, rows_kw = by_label[(label, 'pchip', -1)]
    cols_args, cols_kw = by_label[(label, 'pchip', -2)]
    box, n_xs, kx_rep = rows_args
    rows_in, n_ys, ky_rep = cols_args
    device = box.device
    xs_rows = torch.linspace(0.0, box.shape[-1] - 1.0, n_xs,
                             dtype=torch.float64, device=device)
    xs_cols = torch.linspace(0.0, rows_in.shape[-2] - 1.0, n_ys,
                             dtype=torch.float64, device=device)
    rows_out = torch.empty_like(rows_in)
    grid = torch.empty((box.shape[0], n_ys, n_xs), dtype=torch.float64,
                       device=device)

    def kernel():
        pk.launch(box, xs_rows, rows_out, k_rep=kx_rep, axis=-1)
        pk.launch(rows_out, xs_cols, grid, k_rep=ky_rep, axis=-2)

    def plain():
        pk.pchip_axis_plain(*rows_args, **rows_kw)
        pk.pchip_axis_plain(*cols_args, **cols_kw)

    t = time_pair(f'{card} | pchip_axis x2 (rows, columns) 150^2 smooth '
                  f'frame: box {tuple(box.shape)} to grid '
                  f'{tuple(grid.shape)}', kernel, plain, None, flush)
    passes = in_turns({
        'rows': (lambda: pk.launch(box, xs_rows, rows_out, k_rep=kx_rep,
                                   axis=-1), 200),
        'columns': (lambda: pk.launch(rows_out, xs_cols, grid, k_rep=ky_rep,
                                      axis=-2), 200),
        '16-frame cube, both': (cube_pchip(by_label), 50),
    }, cuda_time_ms)
    log(f'[map-time] {card} | pchip_axis launches back to back (ms per call, '
        'two turns): ' + json.dumps(passes))
    bound = bounds.pchip_call_bound(box, ky_rep, kx_rep)
    t['bound'], t['bound_by'] = bound['ms'], bound['bound_by']
    stage = bounds.smooth_stage_bound(box, ky_rep, kx_rep, smooth_args,
                                      smooth_kw)
    sampler_buffers = sum(b.numel() * b.element_size()
                          for b in smooth_launch_buffers(smooth_args))
    sizes = {
        "map_smooth's buffers": sampler_buffers,
        "map_smooth's counted bytes": bounds.smooth_call_bound(
            smooth_args, smooth_kw)['bytes'],
        "the smooth stage's counted bytes": stage['bytes'],
    }
    yard = in_turns({k: (sum_yardstick(n, device), 50)
                     for k, n in sizes.items()},
                    lambda fn, n: cold_time_ms(fn, n, flush))
    log(f'[map-time] {card} | torch.sum yardsticks, one launch after the L2 '
        'flush (ms, median of 50, two turns): ' + json.dumps(
            {f'{k} ({n / 1e6:.2f} MB)': yard[k] for k, n in sizes.items()}))
    stage_ms = t['kernel'] + smooth_t['kernel']
    log(f'[map-time] {card} | the smooth stage of the 150^2 frame on the '
        f'card, cold: pchip {t["kernel"] * 1e3:.2f} us + map_smooth '
        f'{smooth_t["kernel"] * 1e3:.2f} us = {stage_ms * 1e3:.2f} us '
        f'against its bound {stage["ms"] * 1e3:.2f} us ({stage["bound_by"]}, '
        f'{stage["bytes"] / 1e6:.2f} MB, {stage["f64_ops"]} operations): '
        f'{stage["ms"] / stage_ms:.1%}')
    return t


#: The infill's timed call: the benchmark's map_linear frame
INFILL_TIMED = '2048^2 map_linear frame: map_infill'


def infill_timing(device, flush, card) -> dict:
    """
    map_infill on the benchmark's ``map_linear`` frame (2048x2048, 4 NaN
    blocks of 3 px: the 3x3 means and a median selection), held bit for
    bit against its plain version, then cold and warm beside its bound and
    its plain version on the card (back to back).
    """
    frames = torch.from_numpy(infill_cases.map_linear_frame(seed=0)).to(
        device)
    compare_infill_with_plain(INFILL_TIMED, (frames,),
                              mik.map_infill(frames), phase='map-time')
    t = time_pair(f'{card} | {INFILL_TIMED} {tuple(frames.shape)}',
                  lambda: mik.map_infill(frames),
                  lambda: mik.map_infill_plain(frames), None, flush)
    bound = bounds.infill_call_bound(frames)
    t['bound'], t['bound_by'] = bound['ms'], bound['bound_by']
    return t


def map_timing_phase(bodies, images, calls, card):
    """Kernels, plain versions, yardsticks; cubes per frame; blocked calls."""
    spline_occupancy(calls)
    by_label = {(label, kind, kwargs.get('axis')): (args, kwargs)
                for label, kind, args, kwargs, _ in calls.calls}
    results = {}
    grid_sample = torch.nn.functional.grid_sample
    device = next(iter(bodies.values())).device
    flush = l2_flush(device)
    for label in ('150^2 linear frame', '150^2 cubic frame',
                  '1024^2 cubic with_nan'):
        args, kw = by_label[(label, 'spline', None)]
        x, y, valid, ty, tx, coeffs, nan_grid = args
        prepared = spline_launch_buffers(args)
        library = None
        if kw['kx'] == kw['ky'] == 1:
            # s=0, k=1: the coefficients are the image; no NaN rules
            ny, nx = coeffs.shape[1:]
            grid = normalised_grid(x, y, nx, ny)
            image = coeffs[:1, None]
            library = (lambda: grid_sample(image, grid, mode='bilinear',
                                           padding_mode='border',
                                           align_corners=True))
        t = time_pair(
            f'{card} | map_spline {label} 720x1440',
            lambda: msp.launch(*prepared, **kw),
            lambda: msp.map_spline_plain(*args, **kw), library, flush,
        )
        bound = bounds.spline_call_bound(args, kw)
        t['bound'], t['bound_by'] = bound['ms'], bound['bound_by']
        results[label] = t
    args, kw = by_label[('150^2 smooth frame', 'smooth', None)]
    x, y, valid, grid_os, nan_img = args
    prepared = smooth_launch_buffers(args)
    n_ys, n_xs = grid_os.shape[1:]
    coords = normalised_grid((x - kw['ix0']) / kw['x_step'],
                             (y - kw['iy0']) / kw['y_step'], n_xs, n_ys)
    image = grid_os[:, None]
    t = time_pair(
        f'{card} | map_smooth 150^2 smooth frame 720x1440 (oversampled '
        f'{n_ys}x{n_xs})',
        lambda: msk.launch(*prepared, **kw),
        lambda: msk.map_smooth_plain(*args, **kw),
        lambda: grid_sample(image, coords, mode='bilinear',
                            padding_mode='border', align_corners=True),
        flush,
    )
    bound = bounds.smooth_call_bound(args, kw)
    t['bound'], t['bound_by'] = bound['ms'], bound['bound_by']
    results['150^2 smooth frame'] = t
    results['150^2 smooth frame: pchip'] = pchip_timing(by_label, args, kw,
                                                        t, flush, card)
    results[INFILL_TIMED] = infill_timing(device, flush, card)
    log(f'[map-time] {card} | grid_sample yardstick: float64 in and out, '
        'without the NaN rules; cubic and the PCHIP oversampling have no '
        'one-call counterpart (none)')
    for label, t in results.items():
        log(f'[map-time] {card} | {label}: bound {t["bound"] * 1e3:.2f} us '
            f'({t["bound_by"]}); kernel {t["kernel"] * 1e3:.2f} us cold, '
            f'{t["kernel_warm"] * 1e3:.2f} us warm: '
            f'{t["bound"] / t["kernel"]:.1%} of the bound cold, '
            f'{t["bound"] / t["kernel_warm"]:.1%} warm')

    for size, mode in ((150, 'linear'), (150, 'cubic'), (150, 'smooth'),
                       (1024, 'linear'), (1024, 'cubic')):
        cube = images[size]['cube']
        body = bodies[size]
        body.map_img(cube, interpolation=mode, **MAP_KW)
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        body.map_img(cube, interpolation=mode, **MAP_KW)
        torch.cuda.synchronize()
        per_frame = (time.perf_counter() - t0) / cube.shape[0] * 1e3
        peak = (torch.cuda.max_memory_allocated() - live) / 2**20
        log(f'[map-time] {card} | {size}^2 {cube.shape[0]}-frame cube '
            f'{mode}: {per_frame:.3f} ms per frame (host clock, numpy cube '
            f'in, maps left on the card); peak device memory of the call '
            f'{peak:.1f} MiB above what was allocated before it')
    for size, mode in ((150, 'nearest'), (150, 'linear'), (150, 'cubic'),
                       (150, (3, 1)), (150, 'smooth'), (1024, 'linear'),
                       (1024, 'cubic')):
        img = images[size]['with_nan']
        t0 = time.perf_counter()
        bodies[size].map_img(img, interpolation=mode, as_numpy=True,
                             **MAP_KW)
        log(f'[map-time] {card} | one blocked {size}^2 map_img({mode!r}, '
            f'as_numpy=True) {(time.perf_counter() - t0) * 1e3:.2f} ms '
            '(host clock)')
    return results


# ---------------------------------------------------------------------------
# [planes]: the per-plane getters (get_backplane_img / get_backplane_map)
# ---------------------------------------------------------------------------

#: The card-against-CPU frame: the main path's scene, frame and disc
#: scaled by 1/8; and a 180x360 map (both bulk: they run on the card)
SMALL = SIZE // 8
SMALL_DISC = (*(v / 8 for v in DISC[:3]), DISC[3])
SMALL_MAP = dict(degree_interval=1)


def time_getters(body, names, fetch) -> tuple[dict, dict, float]:
    """
    ``fetch(body, name)`` of every name in turn on the card, each
    synchronised (host clock): the planes, ``{name: (ms, peak MiB)}`` with
    each call's peak device memory above what was allocated before the
    first, and the total ms.
    """
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    out, times = {}, {}
    t_all = time.perf_counter()
    for name in names:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[name] = fetch(body, name)
        torch.cuda.synchronize()
        times[name] = ((time.perf_counter() - t0) * 1e3,
                       (torch.cuda.max_memory_allocated() - live) / 2**20)
    return out, times, (time.perf_counter() - t_all) * 1e3


def log_times(label, times, total, card) -> float:
    peak = max(mib for _, mib in times.values())
    log(f'[planes] {card} | {label}: {total:.1f} ms for all '
        f'{len(times)} (host clock, each synchronised), peak device memory '
        f'{peak:.1f} MiB above what was allocated before; per getter (ms, '
        'peak MiB): ' + json.dumps(
            {k: (round(ms, 2), round(mib, 1)) for k, (ms, mib) in
             times.items()}))
    return peak


def planes_against_fused(planes, fused, size) -> dict:
    """The JAX package's fused-vs-per-plane rule (testing/compare.py
    compare_with_fused, tests/test_pipeline.py:26-81)."""
    # the pixel whose ray passes through the target centre is left out of
    # the limb planes, as in check_against_plain
    reports = compare.compare_with_fused(planes, fused,
                                         centre_pixel((size, size), DISC))
    log(f'[planes] {size}x{size} get_backplane_img vs compute_backplanes '
        '(kernel 1): per plane (largest excess over the bar, mask flips, '
        'flips off the disc boundary, LST bin flips): ' + json.dumps({
            k: (f'{r["max_excess"]:.3e}', r['flips'], r['off_boundary'],
                r['lst_bin_flips']) for k, r in reports.items()}))
    bad = compare.failures(reports)
    if bad:
        raise SmokeFailure(f'per-plane getters differ from kernel 1: {bad}')
    return reports


def planes_against_cpu(label, got, ref, tolerance, ill,
                       exclude=None, phase='planes') -> dict:
    """A card body's planes against a CPU body's (testing/compare.py
    compare_per_plane)."""
    reports = compare.compare_per_plane(got, ref, tolerance, ill, exclude)
    log(f'[{phase}] {label}, card vs CPU body: per plane (max_abs_err where '
        'well conditioned, max_abs_err, bar, mask flips, LST bin flips): '
        + json.dumps({k: (f'{r["max_abs_err_conditioned"]:.3e}',
                          f'{r["max_abs_err"]:.3e}', f'{r["bar"]:.1e}',
                          r['mask_flips'], r['lst_bin_flips'])
                      for k, r in reports.items()}))
    bad = compare.failures(reports)
    if bad:
        raise SmokeFailure(f'{label}: card body differs from CPU body: {bad}')
    return reports


def card_and_cpu_bodies(device):
    bodies = {}
    for where in (device, torch.device('cpu')):
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SMALL,
                         device=where)
        body.set_disc_params(*SMALL_DISC)
        bodies[where.type] = body
    return bodies['cuda'], bodies['cpu']


def planes_phase(device, card: str) -> dict:
    """
    The 26 image getters on a fresh 2048^2 card body (timed, peak memory)
    against its kernel 1 planes; the 26 map getters on the 720x1440 map
    (timed); a 256^2 card body's 26 image getters and 26 180x360 map
    getters against a CPU body's.
    """
    names = list(bk.PLANE_ORDER)
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                     device=device)
    body.set_disc_params(*DISC)
    if list(body.backplanes) != names:
        raise SmokeFailure(f'registered backplanes {list(body.backplanes)}')
    images, img_times, img_ms = time_getters(
        body, names, lambda b, n: b.get_backplane_img(n))
    img_peak = log_times(f'{SIZE}x{SIZE} get_backplane_img, fresh body',
                         img_times, img_ms, card)
    chain = {name: getattr(body, name)().device.type
             for name in ('_get_targvec_img', '_get_illumination_gie_img',
                          '_get_limb_coordinate_imgs')}
    if set(chain.values()) != {device.type}:
        raise SmokeFailure(f'the image chain ran on {chain}')
    fused = pipeline.compute_backplanes(body)
    reports = planes_against_fused(images, fused, SIZE)

    maps, map_times, map_ms = time_getters(
        body, names, lambda b, n: b.get_backplane_map(n, **MAP_KW))
    map_peak = log_times(f'{MAP_SHAPE[0]}x{MAP_SHAPE[1]} get_backplane_map',
                         map_times, map_ms, card)
    if body._get_state_maps(**MAP_KW)[0].device.type != device.type:
        raise SmokeFailure('the map chain did not run on the card')
    if any(m.shape != MAP_SHAPE for m in maps.values()):
        raise SmokeFailure('a map getter returned the wrong shape')
    frac = float(np.isfinite(maps['RA']).mean())
    if not 0.4 < frac < 0.6:  # the visible hemisphere
        raise SmokeFailure(f'RA map finite fraction {frac:.4f}')

    card_body, cpu_body = card_and_cpu_bodies(device)
    ref = {n: cpu_body.get_backplane_img(n) for n in names}
    yy, xx = np.mgrid[0:SMALL, 0:SMALL]
    offset = np.hypot(xx - SMALL_DISC[0], yy - SMALL_DISC[1]) / SMALL_DISC[2]
    small_img = planes_against_cpu(
        f'{SMALL}x{SMALL} images',
        {n: card_body.get_backplane_img(n) for n in names}, ref,
        compare.per_plane_tolerance(cpu_body, angle=compare.F64_CARD_ANGLE,
                                    pixel=0.0),
        compare.per_plane_ill_conditioned(ref, offset),
        centre_pixel((SMALL, SMALL), SMALL_DISC))
    ref = {n: cpu_body.get_backplane_map(n, **SMALL_MAP) for n in names}
    # the ray to a surface point at emission e passes R sin(e) from the
    # centre of a sphere of radius R
    emission_offset = np.abs(np.sin(np.radians(ref['EMISSION'])))
    small_map = planes_against_cpu(
        '180x360 maps',
        {n: card_body.get_backplane_map(n, **SMALL_MAP) for n in names}, ref,
        # x/y: 8 ulps of an RA between 256 and 512 deg in pixels, the bar
        # of xy_against_cpu_body
        compare.per_plane_tolerance(
            cpu_body, angle=compare.F64_CARD_ANGLE,
            pixel=8 * 2.0**-44 * 3600.0 / cpu_body.get_plate_scale_arcsec()),
        compare.per_plane_ill_conditioned(ref, emission_offset))
    return dict(img_ms=img_ms, img_peak=img_peak, map_ms=map_ms,
                map_peak=map_peak, fused=reports, small_img=small_img,
                small_map=small_map)


# ---------------------------------------------------------------------------
# [observation]: Observation with FITS in and FITS out
# ---------------------------------------------------------------------------

#: The observation file: the map benchmark's 1024x1024 8-frame cube with
#: its NaN block, a bright disc added on MAP_BODIES[1024]
OBS_SIZE = 1024
#: The card-against-CPU file: 128x128, 4 frames, the disc scaled by 1/8,
#: mapped onto the 180x360 map
OBS_SMALL = 128
OBS_SMALL_FRAMES = 4
OBS_SMALL_DISC = (*(v / 8 for v in MAP_BODIES[OBS_SIZE][:3]),
                  MAP_BODIES[OBS_SIZE][3])
#: Headers card by card (testing/compare.py compare_headers); the disc,
#: the metadata and the map WCS come from host computations on both
#: bodies
OBS_HEADER_BARS = dict(angle=compare.F64_CARD_ANGLE, pixel=1e-9,
                       relative=1e-12)
#: The card's mapped data against the CPU body's (the plain versions of
#: the map kernels): the kernel-vs-plain bars of MAP_BARS
OBS_MAP_BARS = {'linear': MAP_BARS[('spline', 150)],
                'smooth': MAP_BARS[('smooth', 150)]}


def synchronised(fn):
    """``(result, ms, peak MiB)`` of one call on the card: host clock to
    the end of a synchronise, and the peak device memory above what was
    allocated before it."""
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            (torch.cuda.max_memory_allocated() - live) / 2**20)


class ExportClock:
    """
    Splits the host-clock time of ``save_observation``: the 26 plane
    getters (each synchronised), the host copies inside them that go
    through ``BodyXY._img_plane`` (timed after a synchronise of the plane
    they copy; the other getters copy inside themselves and count as
    getters), and the FITS encoding and write (``HDUList.writeto``).
    """

    def __init__(self):
        self.ms = dict(getters=0.0, copies=0.0, fits=0.0)

    @contextlib.contextmanager
    def timing(self, obs):
        img_plane = pt.BodyXY._img_plane
        writeto = pt_fits.HDUList.writeto
        registry = dict(obs.backplanes)
        ms = self.ms

        def timed_img_plane(body, getter, index):
            getattr(body, getter)()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = img_plane(body, getter, index)
            ms['copies'] += (time.perf_counter() - t0) * 1e3
            return out

        def timed_getter(get_img):
            def timed():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = get_img()
                torch.cuda.synchronize()
                ms['getters'] += (time.perf_counter() - t0) * 1e3
                return out
            return timed

        def timed_writeto(hdul, *args, **kwargs):
            t0 = time.perf_counter()
            writeto(hdul, *args, **kwargs)
            ms['fits'] += (time.perf_counter() - t0) * 1e3

        pt.BodyXY._img_plane = timed_img_plane
        pt_fits.HDUList.writeto = timed_writeto
        obs.backplanes = {name: bp._replace(get_img=timed_getter(bp.get_img))
                          for name, bp in registry.items()}
        try:
            yield
        finally:
            pt.BodyXY._img_plane = img_plane
            pt_fits.HDUList.writeto = writeto
            obs.backplanes = registry


def check_observation_file(label, path, planes) -> list:
    """The HDU names of a saved file (the JAX package's: the primary HDU,
    then the 26 default backplanes in registry order); its data."""
    names, headers, data = read_fits(path)
    if names != [''] + list(planes):
        raise SmokeFailure(f'{label}: HDU names {names}')
    return headers, data


def observation_run(device, path, card):
    """The main path on the 1024^2 file, each step synchronised: the open
    and the disc from the WCS, the two disc fits, save_observation and
    save_mapped_observation in 'linear' and 'smooth'. The map kernels'
    counts are set to 0 before the open and read after the last save."""
    disc = MAP_BODIES[OBS_SIZE]
    out = os.path.dirname(path)
    paths = {'nav': os.path.join(out, 'nav_1024.fits'),
             'linear': os.path.join(out, 'map_linear_1024.fits'),
             'smooth': os.path.join(out, 'map_smooth_1024.fits')}
    steps = {}

    def step(name, fn):
        out, ms, peak = synchronised(fn)
        steps[name] = (ms, peak)
        return out

    for lib in (mik, msp, msk, pk):
        lib.reset_launch_count()
    obs = step('open + disc_from_wcs',
               lambda: pt.Observation(path, device=device))
    wcs_disc = obs.get_disc_params()
    # the WCS was made from 1-pixel steps of the disc's RA/Dec (TAN); the
    # WCS route measures the rotation on RA and Dec degrees, and the plate
    # scale as the arccos of the cosine of a one-pixel step (~2e-7 rad
    # here, whose float64 rounding is ~0.3% of it), as the JAX package
    # does: within 0.01 px, 1% of r0 and 0.2 deg of the disc
    offsets = np.abs(np.subtract(wcs_disc, disc))
    if obs.get_disc_method() != 'wcs' or obs.device.type != device.type or \
            max(offsets[:2]) > 0.01 or offsets[2] > 1e-2 * disc[2] or \
            offsets[3] > 0.2:
        raise SmokeFailure(f'the WCS disc {wcs_disc} ({obs.get_disc_method()}'
                           f') on {obs.device}, expected {disc}')
    step('fit_disc_position', obs.fit_disc_position)
    step('fit_disc_radius', obs.fit_disc_radius)
    fitted = obs.get_disc_params()
    log(f'[observation] fitted disc (fit_disc_position, fit_disc_radius) '
        f'{json.dumps(fitted[:3])} beside the WCS disc '
        f'{json.dumps(wcs_disc[:3])}')
    # the disc is a step of 8 x 5 on noise of sd 8**0.5; the fit reports
    # the middle of the radius step with the steepest fall of the mean,
    # the radii being (r_ceil / 99) px apart: within two steps of r0
    r_step = int(min(*wcs_disc[:2], OBS_SIZE - wcs_disc[0],
                     OBS_SIZE - wcs_disc[1])) / 99
    if max(abs(fitted[0] - wcs_disc[0]), abs(fitted[1] - wcs_disc[1])) > 0.5 \
            or abs(fitted[2] - wcs_disc[2]) > 2 * r_step:
        raise SmokeFailure(f'the fitted disc {fitted} is not the WCS disc')
    obs.disc_from_wcs()
    step('save_observation', lambda: obs.save_observation(
        paths['nav'], include_wireframe=False, print_info=False))
    for mode in ('linear', 'smooth'):
        step(f'save_mapped_observation {mode}',
             lambda: obs.save_mapped_observation(
                 paths[mode], interpolation=mode, include_wireframe=False,
                 print_info=False, **MAP_KW))
    launches = {'map_infill': mik.launch_count(),
                'map_spline': msp.launch_count(),
                'pchip_axis': pk.launch_count(),
                'map_smooth': msk.launch_count()}
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    for name, (ms, peak) in steps.items():
        size = {'save_observation': sizes['nav'],
                'save_mapped_observation linear': sizes['linear'],
                'save_mapped_observation smooth': sizes['smooth']}.get(name)
        log(f'[observation] {card} | {name}: {ms:.1f} ms (host clock, '
            f'synchronised), peak device memory {peak:.1f} MiB above what '
            'was allocated before' + (f', file {size / 2**20:.1f} MiB'
                                      if size else ''))
    log(f'[observation] kernel launches in the run: {json.dumps(launches)}')
    # one infill launch a spline map_img, as one map_spline launch
    if min(launches.values()) < 1 or \
            launches['map_infill'] != launches['map_spline']:
        raise SmokeFailure(f'the observation path launched {launches}')
    return obs, paths, steps, launches


def instrumented_run(obs, path, card) -> tuple[dict, dict]:
    """
    The saves again, on a fresh Observation of the same file (the first
    one's planes and maps are cached): save_observation under
    :class:`ExportClock`, and save_mapped_observation with the map
    kernels' calls recorded and each held against its plain version on
    the same inputs. Its files are deleted as soon as written.
    """
    again = pt.Observation(path, device=obs.device)
    if again.get_disc_params() != obs.get_disc_params():
        raise SmokeFailure('a second open gave another WCS disc')
    scratch = os.path.join(os.path.dirname(path), 'instrumented.fits')
    clock, calls, ms = ExportClock(), KernelCalls(), {}
    with clock.timing(again):
        _, ms['save_observation'], _ = synchronised(
            lambda: again.save_observation(scratch, include_wireframe=False,
                                           print_info=False))
    os.remove(scratch)
    for mode in ('linear', 'smooth'):
        with calls.recording(f'{OBS_SIZE}^2 {MAP_CUBE_FRAMES[OBS_SIZE]}-frame '
                             f'observation {mode}'):
            _, ms[f'save_mapped_observation {mode}'], _ = synchronised(
                lambda: again.save_mapped_observation(
                    scratch, interpolation=mode, include_wireframe=False,
                    print_info=False, **MAP_KW))
        os.remove(scratch)
        if not np.array_equal(again.get_mapped_data(mode, **MAP_KW),
                              obs.get_mapped_data(mode, **MAP_KW),
                              equal_nan=True):
            raise SmokeFailure(f'{mode}: the second run mapped another cube')
    kinds = sorted(kind for _, kind, *_ in calls.calls)
    if kinds != ['infill', 'pchip', 'pchip', 'smooth', 'spline']:
        raise SmokeFailure(f'the mapped saves called {kinds}')
    errors = {'spline': 0.0, 'smooth': 0.0, 'pchip': 0.0, 'infill': 0.0}
    for label, kind, args, kwargs, out in calls.calls:
        err = compare_with_plain(label, kind, OBS_SIZE, args, kwargs, out,
                                 phase='observation')
        errors[kind] = max(errors[kind], err)
    nav_ms = ms['save_observation']
    log(f'[observation] {card} | second run, instrumented (a fresh '
        'Observation of the same file): ' + ', '.join(
            f'{k} {v:.1f} ms' for k, v in ms.items()))
    log(f'[observation] {card} | its save_observation {nav_ms:.1f} ms: the '
        f'26 plane getters {clock.ms["getters"]:.1f} ms (of which host '
        f'copies through _img_plane {clock.ms["copies"]:.1f} ms), FITS '
        f'encoding and write {clock.ms["fits"]:.1f} ms, the rest (header '
        'metadata, HDUs) '
        f'{nav_ms - clock.ms["getters"] - clock.ms["fits"]:.1f} ms')
    return errors, dict(ms=ms, split=clock.ms)


def observation_checks(obs, paths, cube) -> dict:
    """The saved files: HDU names, the data, the backplanes against kernel
    1 (TOLS) and the mapped data against map_img bit for bit."""
    names = list(bk.PLANE_ORDER)
    _, data = check_observation_file('save_observation', paths['nav'], names)
    if not np.array_equal(data[0], cube, equal_nan=True):
        raise SmokeFailure('the saved primary HDU is not the observed cube')
    planes = dict(zip(names, data[1:]))
    fused = pipeline.compute_backplanes(obs)
    reports = compare.compare_with_fused(
        planes, fused,
        centre_pixel((OBS_SIZE, OBS_SIZE), obs.get_disc_params()))
    log(f'[observation] {OBS_SIZE}x{OBS_SIZE} saved backplane HDUs vs '
        'compute_backplanes (kernel 1): per plane (largest excess over the '
        'bar, mask flips, flips off the disc boundary, LST bin flips): '
        + json.dumps({k: (f'{r["max_excess"]:.3e}', r['flips'],
                          r['off_boundary'], r['lst_bin_flips'])
                      for k, r in reports.items()}))
    bad = compare.failures(reports)
    if bad:
        raise SmokeFailure(f'saved backplanes differ from kernel 1: {bad}')
    for mode in ('linear', 'smooth'):
        headers, data = check_observation_file(
            f'save_mapped_observation {mode}', paths[mode], names)
        ref = obs.map_img(obs.data, interpolation=mode, as_numpy=True,
                          **MAP_KW).astype(np.float64)
        if data[0].shape != (MAP_CUBE_FRAMES[OBS_SIZE],) + MAP_SHAPE or \
                not np.array_equal(data[0], ref, equal_nan=True):
            raise SmokeFailure(f'{mode}: the mapped HDU is not map_img(cube)')
        if headers[0]['PLANMAP MAP INTERPOLATION'] != mode:
            raise SmokeFailure(f'{mode}: header {headers[0]}')
        frac = float(np.isfinite(data[0][0]).mean())
        log(f'[observation] save_mapped_observation {mode}: mapped HDU '
            f'{data[0].shape} equals map_img(cube) bit for bit; finite '
            f'fraction of frame 0 {frac:.4f}')
    return reports


def small_observations(device, tmp):
    """The 128^2 4-frame file on a card Observation and a CPU one, each
    saved navigated and mapped ('linear' with the backplanes, 'smooth'
    without) onto the 180x360 map."""
    path = os.path.join(tmp, 'observation_128.fits')
    rng = np.random.default_rng(OBS_SMALL)
    cube = disc_cube(rng.normal(size=(OBS_SMALL_FRAMES, OBS_SMALL,
                                      OBS_SMALL)), OBS_SMALL_DISC)
    cube[1, 40:44, 60:63] = np.nan
    write_observation(path, cube, OBS_SMALL_DISC, UTC)
    files, bodies = {}, {}
    for label, where in (('card', device), ('cpu', torch.device('cpu'))):
        obs = pt.Observation(path, device=where)
        bodies[label] = obs
        for kind, kw in (('nav', None), ('linear', True), ('smooth', False)):
            out = os.path.join(tmp, f'small_{kind}_{label}.fits')
            if kw is None:
                obs.save_observation(out, include_wireframe=False,
                                     print_info=False)
            else:
                obs.save_mapped_observation(
                    out, interpolation=kind, include_backplanes=kw,
                    include_wireframe=False, print_info=False, **SMALL_MAP)
            files[kind, label] = read_fits(out)
    return files, bodies['cpu']


def small_observation_checks(device, tmp) -> dict:
    """A card Observation's files against a CPU Observation's: headers card
    by card (but the date), backplane HDUs at the card-vs-CPU bars of the
    [planes] phase, the mapped data at the map kernels' bars against their
    plain versions."""
    files, cpu = small_observations(device, tmp)
    report = {}
    for kind in ('nav', 'linear', 'smooth'):
        (names, headers, data), (ref_names, ref_headers, ref_data) = (
            files[kind, 'card'], files[kind, 'cpu'])
        if names != ref_names:
            raise SmokeFailure(f'small {kind}: HDU names {names}')
        for name, got, ref in zip(names, headers, ref_headers):
            problems = compare.compare_headers(got, ref, **OBS_HEADER_BARS)
            if problems:
                raise SmokeFailure(f'small {kind} {name!r} header: {problems}')
        if kind == 'nav':
            ok = np.array_equal(data[0], ref_data[0], equal_nan=True)
            primary = dict(equal=ok)
        else:
            primary = compare.compare_map(data[0], ref_data[0],
                                          OBS_MAP_BARS[kind])
            ok = primary['ok']
        if not ok:
            raise SmokeFailure(f'small {kind}: primary HDU {primary}')
        report[kind] = dict(primary=primary, cards=len(headers[0]))
        if len(names) == 1:
            continue
        planes = dict(zip(names[1:], data[1:]))
        refs = dict(zip(names[1:], ref_data[1:]))
        if kind == 'nav':
            yy, xx = np.mgrid[0:OBS_SMALL, 0:OBS_SMALL]
            offset = np.hypot(xx - OBS_SMALL_DISC[0], yy - OBS_SMALL_DISC[1]) \
                / OBS_SMALL_DISC[2]
            pixel = 0.0
            exclude = centre_pixel((OBS_SMALL, OBS_SMALL), OBS_SMALL_DISC)
        else:
            offset = np.abs(np.sin(np.radians(refs['EMISSION'])))
            pixel = 8 * 2.0**-44 * 3600.0 / cpu.get_plate_scale_arcsec()
            exclude = None
        report[kind]['planes'] = planes_against_cpu(
            f'{OBS_SMALL}x{OBS_SMALL} Observation {kind} HDUs', planes, refs,
            compare.per_plane_tolerance(cpu, angle=compare.F64_CARD_ANGLE,
                                        pixel=pixel),
            compare.per_plane_ill_conditioned(refs, offset), exclude,
            phase='observation')
    log(f'[observation] {OBS_SMALL}x{OBS_SMALL} {OBS_SMALL_FRAMES}-frame '
        'card Observation vs CPU Observation: headers equal card by card '
        '(but PLANMAP DATE); primary HDUs: ' + json.dumps(
            {k: v['primary'] for k, v in report.items()}))
    return report


def observation_phase(device, card: str) -> dict:
    """
    [observation]: write the 1024^2 8-frame FITS observation with the
    port's writer, drive the main path on a card Observation (timed), check
    the files it wrote, save again instrumented (the export split, the map
    kernels against their plain versions), and hold a small card
    Observation's files against a CPU Observation's.
    """
    with tempfile.TemporaryDirectory(prefix='observation_') as tmp:
        path = os.path.join(tmp, 'observation_1024.fits')
        cube = disc_cube(map_images(OBS_SIZE, OBS_SIZE)[2],
                         MAP_BODIES[OBS_SIZE])
        t0 = time.perf_counter()
        write_observation(path, cube, MAP_BODIES[OBS_SIZE], UTC)
        log(f'[observation] wrote {cube.shape} float64 with a TAN WCS '
            f'({os.path.getsize(path) / 2**20:.1f} MiB) in '
            f'{(time.perf_counter() - t0) * 1e3:.1f} ms')
        obs, paths, steps, launches = observation_run(device, path, card)
        reports = observation_checks(obs, paths, cube)
        errors, instrumented = instrumented_run(obs, path, card)
        small = small_observation_checks(device, tmp)
    return dict(steps=steps, launches=launches, errors=errors,
                instrumented=instrumented, fused=reports, small=small)


# ---------------------------------------------------------------------------
# [wireframe]: the wireframe's geometry on a card body
# ---------------------------------------------------------------------------

#: Points of the bulk limb and terminator (above _device.BULK_ELEMENTS, so
#: the scene calls run on the body's device)
WIREFRAME_NPTS = 8192
#: The wireframe's options (the plot functions' defaults)
WIREFRAME_KW = dict(grid_interval=30, grid_lat_limit=90,
                    planetocentric_grid=False, indicate_equator=False,
                    indicate_prime_meridian=False, label_poles=True)
#: Bars: the CPU tests' (tests/test_torch_curves.py) for the artists, which
#: run on CPU tensors on both bodies; card against CPU for the bulk curves
#: (compare.F64_CARD_ANGLE, the [planes] phase's angle bar, and the limb
#: points' 1e-6 km)
ARTIST_BARS = dict(deg=compare.F64_ANGLE, px=2e-9)
BULK_BARS = dict(deg=compare.F64_CARD_ANGLE, km=1e-6)


def wireframe_bodies(device):
    """A card and a CPU BodyXY of the main path's frame and disc, each with
    Io and Amalthea (a BasicBody), a ring and a coordinate of interest."""
    bodies = []
    for where in (device, torch.device('cpu')):
        body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                         device=where)
        body.set_disc_params(*DISC)
        body.add_other_bodies_of_interest('IO', 505)
        body.ring_radii.add(129000.0)
        body.coordinates_of_interest_lonlat.append(
            (round(body.subpoint_lon) + 5.0, 10.0))
        bodies.append(body)
    kinds = [type(o).__name__ for o in bodies[0].other_bodies_of_interest]
    if kinds != ['Body', 'BasicBody']:
        raise SmokeFailure(f'[wireframe] other bodies {kinds}')
    return bodies


def artists_in_xy(body) -> list[tuple]:
    """The wireframe's artist specs with every position mapped to pixels."""
    out = []
    for spec in _body_plotting._wireframe_artists(body, **WIREFRAME_KW):
        x, y = body.radec2xy(np.asarray(spec.ras, dtype=float),
                             np.asarray(spec.decs, dtype=float))
        out.append((spec.kind, spec.component, spec.overlays, spec.text,
                    np.atleast_1d(spec.ras), np.atleast_1d(spec.decs),
                    np.atleast_1d(x), np.atleast_1d(y)))
    return out


def check_curves(label, got, ref, bar, period=None, flips=None) -> float:
    """compare.compare_curve, failing the run; adds the NaN flips to
    ``flips`` (a one-entry list)."""
    report = compare.compare_curve(got, ref, bar, period=period)
    if not report['ok']:
        raise SmokeFailure(f'[wireframe] {label}: {report}')
    if flips is not None:
        flips[0] += report['mask_flips']
    return report['max_abs_err']


def check_artists(card_artists, cpu_artists) -> dict:
    """The card body's artists against the CPU body's: the same specs in the
    same order, RA/Dec and pixels within the CPU tests' bars."""
    if [a[:4] for a in card_artists] != [a[:4] for a in cpu_artists]:
        raise SmokeFailure('[wireframe] the artist specs differ')
    errors = dict(deg=0.0, px=0.0)
    for got, ref in zip(card_artists, cpu_artists):
        label = f'{got[0]} {got[1]}'
        for unit, g, r, period in (('deg', got[4], ref[4], 360.0),
                                   ('deg', got[5], ref[5], None),
                                   ('px', got[6], ref[6], None),
                                   ('px', got[7], ref[7], None)):
            errors[unit] = max(errors[unit], check_curves(
                label, g, r, ARTIST_BARS[unit], period))
    return errors


@contextlib.contextmanager
def engine_devices(engine):
    """Record the device of every limbpt/termpt result of ``engine``."""
    seen = []
    originals = {name: getattr(engine, name) for name in ('limbpt', 'termpt')}

    def spy(name):
        def call(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            seen.append((name, out.device.type, tuple(out.shape)))
            return out
        return call

    for name in originals:
        setattr(engine, name, spy(name))
    try:
        yield seen
    finally:
        for name in originals:
            delattr(engine, name)


def bulk_curves(body) -> tuple[dict, list]:
    """The 8192-point limb and terminator (RA/Dec, host arrays) and the
    devices their engine calls ran on."""
    with engine_devices(body._engine) as seen:
        curves = dict(limb=body.limb_radec(npts=WIREFRAME_NPTS),
                      terminator=body.terminator_radec(npts=WIREFRAME_NPTS))
    return curves, seen


def limb_against_sincpt(body, ra_limb, dec_limb) -> int:
    """Rays nudged 2% of the way to the disc centre from each limb point
    hit the surface, rays nudged 2% outwards miss (tests/test_golden_parity
    .py:682-697), in one bulk radec2lonlat call on the body's device."""
    ra, dec = ra_limb[:-1], dec_limb[:-1]
    eps = np.concatenate([np.full(ra.size, 0.02), np.full(ra.size, -0.02)])
    ra_t = np.tile(ra, 2) + eps * (body.target_ra - np.tile(ra, 2))
    dec_t = np.tile(dec, 2) + eps * (body.target_dec - np.tile(dec, 2))
    lon, _ = body.radec2lonlat(f64(ra_t, body.device), f64(dec_t, body.device))
    if lon.device.type != body.device.type:
        raise SmokeFailure(f'[wireframe] sincpt ran on {lon.device}')
    hit = torch.isfinite(lon).cpu().numpy()
    wrong = int((hit != (eps > 0)).sum())
    if wrong:
        raise SmokeFailure(f'[wireframe] limb vs sincpt: {wrong} of '
                           f'{hit.size} rays on the wrong side')
    return hit.size


def wireframe_phase(device, card: str) -> dict:
    """
    [wireframe]: the wireframe's artist specs on a card body against a CPU
    body's, the bulk limb and terminator on the card against the CPU
    body's and the limb against the card's sincpt, timed with the phase's
    peak device memory. No rendering: the card host has no matplotlib.
    """
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    card_body, cpu_body = wireframe_bodies(device)

    t0 = time.perf_counter()
    card_artists = artists_in_xy(card_body)
    torch.cuda.synchronize()
    times['artists'] = (time.perf_counter() - t0) * 1e3
    errors = check_artists(card_artists, artists_in_xy(cpu_body))

    t0 = time.perf_counter()
    card_curves, seen = bulk_curves(card_body)
    torch.cuda.synchronize()
    times['limb + terminator'] = (time.perf_counter() - t0) * 1e3
    want = [('limbpt', device.type, (WIREFRAME_NPTS, 3)),
            ('termpt', device.type, (WIREFRAME_NPTS, 3))]
    if seen != want or 3 * WIREFRAME_NPTS <= BULK_ELEMENTS:
        raise SmokeFailure(f'[wireframe] bulk curves ran as {seen}')
    cpu_curves, cpu_seen = bulk_curves(cpu_body)
    if {d for _, d, _ in cpu_seen} != {'cpu'}:
        raise SmokeFailure(f'[wireframe] CPU body ran on {cpu_seen}')
    flips = [0]
    for name in card_curves:
        for axis, period in ((0, 360.0), (1, None)):
            errors['bulk deg'] = max(errors.get('bulk deg', 0.0), check_curves(
                f'{name} {WIREFRAME_NPTS}', card_curves[name][axis],
                cpu_curves[name][axis], BULK_BARS['deg'], period, flips))
    limb_card = card_body._limb_targvec(npts=WIREFRAME_NPTS).cpu().numpy()
    limb_cpu = cpu_body._limb_targvec(npts=WIREFRAME_NPTS).numpy()
    errors['km'] = float(np.max(np.abs(limb_card - limb_cpu)))
    if not errors['km'] <= BULK_BARS['km']:
        raise SmokeFailure(f'[wireframe] limb points {errors["km"]:.3e} km')
    rays = limb_against_sincpt(card_body, *card_curves['limb'])

    scan = card_body.copy()
    t0 = time.perf_counter()
    scan.add_satellites_to_bodies_of_interest(skip_insufficient_data=True)
    torch.cuda.synchronize()
    times['add_satellites_to_bodies_of_interest'] = (
        time.perf_counter() - t0) * 1e3
    found = [o.target for o in scan.other_bodies_of_interest]
    if found != ['IO', 'AMALTHEA']:
        raise SmokeFailure(f'[wireframe] satellites {found}')
    peak = (torch.cuda.max_memory_allocated() - live) / 2**20
    curves = sum(a[0] == 'curve' for a in card_artists)
    log(f'[wireframe] {card} | {len(card_artists)} artists ({curves} curves) '
        f'on a {SIZE}x{SIZE} card body {times["artists"]:.1f} ms, held to a '
        f'CPU body\'s (max {errors["deg"]:.3e} deg, {errors["px"]:.3e} px); '
        f'{WIREFRAME_NPTS}-point limb + terminator on the card '
        f'{times["limb + terminator"]:.1f} ms ({seen}), RA/Dec within '
        f'{errors["bulk deg"]:.3e} deg of the CPU body\'s ({flips[0]} NaN '
        f'flips), limb points within {errors["km"]:.3e} km, {rays} rays '
        'against sincpt on the card; add_satellites_to_bodies_of_interest '
        f'{times["add_satellites_to_bodies_of_interest"]:.1f} ms; peak '
        f'{peak:.1f} MiB')
    log('[wireframe] no rendering: the card host has no matplotlib (the '
        'overlays and the WIREFRAME HDU are held to the JAX package byte '
        'for byte by tests/test_torch_plotting.py and '
        'tests/test_torch_observation.py on the CPU)')
    return dict(times=times, errors=errors, peak=peak)


# ---------------------------------------------------------------------------
# [cli], [gui], [tle]: the shells and SPK type 10
# ---------------------------------------------------------------------------

PREWARM_SIZES = (512, 1024, 2048)
REPO = os.path.dirname(os.path.abspath(__file__))


class LineClock:
    """A stdout stand-in that keeps each line written, with the launch
    counts of kernel 1, the map spline and the map infill kernels at the
    time it was written."""

    def __init__(self):
        self.lines = []
        self._buffer = ''

    def write(self, text):
        self._buffer += text
        while '\n' in self._buffer:
            line, self._buffer = self._buffer.split('\n', 1)
            self.lines.append((line, bk.launch_count(),
                               msp.LIBRARY.launch_count(),
                               mik.launch_count()))
        return len(text)

    def flush(self):
        pass


def prewarm_subprocess(kernel_dir) -> tuple[float, list[str]]:
    """Host-clock seconds of one cold ``python -m planetmapper_tpu_torch
    --prewarm 2048`` (start to exit) and its output lines."""
    env = dict(os.environ, PLANETMAPPER_KERNEL_PATH=kernel_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'planetmapper_tpu_torch', '--prewarm', '2048'],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f'--prewarm 2048 subprocess failed:\n'
                           f'{proc.stdout}\n{proc.stderr}')
    return seconds, proc.stdout.splitlines()


def prewarm_source(size: int) -> np.ndarray:
    """A seeded ``size`` x ``size`` source with a NaN block near its centre,
    for the map kernel's comparison after ``--prewarm`` (which maps
    zeros)."""
    img = np.random.default_rng(size).normal(size=(size, size))
    img[size // 2 - 40: size // 2 - 36, size // 2 + 30: size // 2 + 35] = \
        np.nan
    return img


def spline_plan(args, kwargs) -> str:
    """The map spline wrapper's launch plan for one recorded call: how each
    axis finds its knot interval and the launch's shared memory."""
    ty, tx, coeffs = args[3], args[4], args[5]
    axis_y, axis_x, shared = msp.launch_plan(ty.shape[0], tx.shape[0],
                                             kwargs.get('uniform'))

    def how(axis):
        if axis.uniform:
            return 'arithmetic (unit-spaced knots)'
        return 'search, knots in ' + ('shared' if axis.staged else 'global') \
            + ' memory'

    return (f'coefficients {tuple(coeffs.shape)}, degrees (ky, kx) = '
            f'({kwargs["ky"]}, {kwargs["kx"]}); y {how(axis_y)}, x '
            f'{how(axis_x)}; {shared} B shared')


def prewarm_map_checks(bodies) -> float:
    """On each prewarm body, a cubic 1-degree ``map_img`` of
    :func:`prewarm_source`; its map infill call held bit for bit against
    its plain version, its map spline call at ``MAP_BARS``. The largest
    errors ``{kind: error}``."""
    worst = {'spline': 0.0, 'infill': 0.0}
    for body in bodies:
        size = body.get_img_size()[0]
        recorder = KernelCalls()
        with recorder.recording(f'cli {size}^2'):
            body.map_img(prewarm_source(size), interpolation='cubic',
                         degree_interval=1, as_numpy=False)
        torch.cuda.synchronize()
        kinds = [c[1] for c in recorder.calls]
        if kinds != ['infill', 'spline']:
            raise SmokeFailure(f'cubic map_img of {size}^2 made the calls '
                               f'{kinds}')
        for label, kind, args, kwargs, out in recorder.calls:
            if kind == 'spline':
                log(f'[cli] {label} cubic map_img onto the 180x360 map: '
                    f'{spline_plan(args, kwargs)}')
            worst[kind] = max(worst[kind], compare_with_plain(
                f'{label} cubic', kind, size, args, kwargs, out,
                phase='cli'))
        del recorder
    return worst


def cli_phase(device, kernel_dir, card: str) -> dict:
    """
    [cli]: ``cli.main(['--prewarm', '512', '1024', '2048'])`` in this
    process (kernel 1 and the map infill kernel launched once a size, the
    map spline kernel at least once a size), the 2048^2 planes held against
    kernel 1's plain version; the map infill and spline kernels on each
    prewarm body held against their plain versions
    (:func:`prewarm_map_checks`); ``python -m
    planetmapper_tpu_torch --version``; one cold ``--prewarm 2048``
    subprocess.
    """
    from planetmapper_tpu_torch import cli

    seen = []
    compute = pipeline.compute_backplanes

    def recording(body, **kw):
        out = compute(body, **kw)
        seen.append((body, out))
        return out

    clock = LineClock()
    bk.reset_launch_count()
    msp.LIBRARY.reset_launch_count()
    mik.reset_launch_count()
    pipeline.compute_backplanes = recording
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(clock):
            cli.main(['--prewarm', *map(str, PREWARM_SIZES)])
    finally:
        pipeline.compute_backplanes = compute
    total = time.perf_counter() - t0
    torch.cuda.synchronize()
    for line, *_ in clock.lines:
        log(f'[cli] {line}')
    launches = dict(backplanes26=bk.launch_count(),
                    map_spline=msp.LIBRARY.launch_count(),
                    map_infill=mik.launch_count())
    log(f'[cli] {card} | cli.main --prewarm {" ".join(map(str, PREWARM_SIZES))}'
        f' {total:.3f} s in this process; launches {json.dumps(launches)}')
    # each size's launches: the counts at its map line less those at the
    # line before it
    marks = [counts for line, *counts in clock.lines
             if 'map reprojection' in line]
    per_size, last = {}, (0, 0, 0)
    for size, counts in zip(PREWARM_SIZES, marks):
        per_size[size] = dict(zip(('backplanes26', 'map_spline',
                                   'map_infill'),
                                  np.subtract(counts, last).tolist()))
        last = counts
    log(f'[cli] launches per size: {json.dumps(per_size)}')
    if len(marks) != len(PREWARM_SIZES) or any(
            n['backplanes26'] != 1 or n['map_spline'] < 1
            or n['map_infill'] != 1 for n in per_size.values()):
        raise SmokeFailure(f'--prewarm launched {per_size}')
    bodies = [b for b, _ in seen]
    if [b.get_img_size() for b in bodies] != [
            (size, size) for size in PREWARM_SIZES] or any(
            b.device.type != device.type for b in bodies):
        raise SmokeFailure(f'--prewarm did not run its bodies on {device}')
    body, out = seen[-1]
    size = PREWARM_SIZES[-1]
    plain = pipeline.fused_backplanes_fn(**FLAGS)
    check_against_plain(f'cli {size}x{size}', to_numpy(out),
                        to_numpy(one_frame(plain, size, size,
                                           pipeline.pipeline_inputs(body),
                                           device)),
                        body.get_disc_params())
    del seen, out, body
    errors = prewarm_map_checks(bodies)
    del bodies

    proc = subprocess.run(
        [sys.executable, '-m', 'planetmapper_tpu_torch', '--version'],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    if proc.returncode != 0 or proc.stdout.strip() != \
            f'planetmapper_tpu_torch {pt.__version__}':
        raise SmokeFailure(f'--version: {proc.stdout!r} {proc.stderr!r}')
    log(f'[cli] python -m planetmapper_tpu_torch --version: '
        f'{proc.stdout.strip()}')
    seconds, lines = prewarm_subprocess(kernel_dir)
    log(f'[cli] {card} | cold subprocess --prewarm 2048: {seconds:.3f} s; '
        + '; '.join(lines))
    return dict(launches=launches, per_size=per_size, cold=seconds,
                errors=errors)


#: The registry routines [gui] runs, each from gui_start on the GUI's
#: Observation and on a fresh Observation of the file (the 'header' row
#: needs PLANMAP cards, which the file lacks)
GUI_ROUTINES = (
    'Reset all disc parameters', 'Centre disc in image',
    'Rotate north to top', 'Use WCS position, rotation & scale',
    'Use WCS position', 'Use WCS rotation', 'Use WCS plate scale',
    'Fit disc position', 'Fit disc radius', 'Fit disc (gradient descent)',
)


def gui_start(disc) -> tuple:
    """The disc the user has nudged to before each routine: ``disc`` (the
    file's) moved and enlarged as the [fit] phase's start (FIT_START). From
    a disc also turned by 1.7 deg, the gradient fit returns NaN and
    fit_disc_radius 3.55 px on this cube, in both packages (ROADMAP Queue
    3)."""
    dx, dy, scale = FIT_START
    return (disc[0] + dx, disc[1] + dy, disc[2] * scale, disc[3])


def gui_clicks(disc, size) -> tuple:
    """Click pixels: on the disc, near its limb, off it."""
    x0, y0, r0, _ = disc
    return ((x0 + 0.0008 * r0, y0 + 0.046 * r0), (x0 - 0.79 * r0, y0),
            (0.03 * size, 0.97 * size))


def gui_direct_call(obs, label):
    """The Observation method a registry row stands for."""
    wcs = dict(suppress_warnings=True, validate=False,
               use_header_offsets=False)
    from planetmapper_tpu_torch.parallel import fit_disc_gradient

    return {
        'Reset all disc parameters': obs.reset_disc_params,
        'Centre disc in image': obs.centre_disc,
        'Rotate north to top': obs.rotate_north_to_top,
        'Use WCS position, rotation & scale':
            lambda: obs.disc_from_wcs(**wcs),
        'Use WCS position': lambda: obs.position_from_wcs(**wcs),
        'Use WCS rotation': lambda: obs.rotation_from_wcs(**wcs),
        'Use WCS plate scale': lambda: obs.plate_scale_from_wcs(**wcs),
        'Fit disc position': obs.fit_disc_position,
        'Fit disc radius': obs.fit_disc_radius,
        'Fit disc (gradient descent)': lambda: fit_disc_gradient(obs),
    }[label]


def click_checks(card_gui, cpu_gui, clicks) -> None:
    """Click coordinates (their values, the JSON and formatted strings) of
    the card GUI against the CPU GUI's at the card-vs-CPU bars."""
    distance = cpu_gui.get_observation().target_distance
    for xy in clicks:
        got = card_gui._get_coords_for_location(*xy)
        ref = cpu_gui._get_coords_for_location(*xy)
        if set(got) != set(ref):
            raise SmokeFailure(f'click {xy}: keys {sorted(got)} against '
                               f'{sorted(ref)}')
        worst = {}
        for key, value in ref.items():
            bar = (compare.F64_POSITION_RELATIVE * distance
                   if key in ('limb_distance', 'ring_radius')
                   else compare.F64_CARD_ANGLE)
            worst[key] = abs(got[key] - value)
            if not worst[key] <= bar:
                raise SmokeFailure(f'click {xy} {key}: {got[key]} against '
                                   f'{value} (bar {bar})')
        strings = (card_gui.make_click_json_string(got),
                   card_gui.make_click_formatted_string(
                       card_gui.get_click_coords_formatted_strings(got)))
        if strings != (cpu_gui.make_click_json_string(ref),
                       cpu_gui.make_click_formatted_string(
                           cpu_gui.get_click_coords_formatted_strings(ref))):
            raise SmokeFailure(f'click {xy}: strings differ: {strings}')
        log(f'[gui] click {xy} ({"on" if "lon" in got else "off"} the disc): '
            f'{strings[0]}; largest difference from the CPU GUI '
            f'{max(worst.values()):.3e}')


def gui_phase(device, card: str) -> dict:
    """
    [gui]: the GUI without a window over the [observation] phase's
    1024^2 8-frame card Observation: every disc-finding routine of the
    registry timed, each disc bit for bit with the direct call on a fresh
    Observation of the file; click coordinates against a CPU Observation's
    GUI. Nothing is drawn.
    """
    import importlib.util

    from planetmapper_tpu_torch import gui as pt_gui

    log('[gui] planetmapper_tpu_torch.gui imported; on this host tkinter '
        f'{"is" if importlib.util.find_spec("tkinter") else "is not"} '
        'installed, matplotlib '
        f'{"is" if importlib.util.find_spec("matplotlib") else "is not"}')
    times = {}
    with tempfile.TemporaryDirectory(prefix='gui_') as tmp:
        path = os.path.join(tmp, 'observation_1024.fits')
        cube = disc_cube(map_images(OBS_SIZE, OBS_SIZE)[2],
                         MAP_BODIES[OBS_SIZE])
        write_observation(path, cube, MAP_BODIES[OBS_SIZE], UTC)
        g = pt_gui.GUI(allow_open=False)
        g.set_observation(pt.Observation(path, device=device))
        routines = {label: fn for rows in g.disc_finding_routines.values()
                    for fn, label, _, _ in rows}
        start = gui_start(MAP_BODIES[OBS_SIZE])
        for label in GUI_ROUTINES:
            obs = g.get_observation()
            obs.set_disc_params(*start)
            button = g.make_disc_finding_fn(routines[label])
            _, times[label], _ = synchronised(button)
            direct = pt.Observation(path, device=device)
            direct.set_disc_params(*start)
            synchronised(gui_direct_call(direct, label))
            got, ref = obs.get_disc_params(), direct.get_disc_params()
            if got != ref:
                raise SmokeFailure(f'[gui] {label}: {got} against the '
                                   f'direct call\'s {ref}')
            log(f'[gui] {card} | {label}: {times[label]:.1f} ms; disc '
                f'{tuple(round(v, 4) for v in got)} bit for bit with the '
                'direct call')
        cpu_gui = pt_gui.GUI(allow_open=False, device='cpu')
        cpu_gui.set_observation(pt.Observation(path, device='cpu'))
        for gui in (g, cpu_gui):
            gui.get_observation().set_disc_params(*MAP_BODIES[OBS_SIZE])
        click_checks(g, cpu_gui, gui_clicks(MAP_BODIES[OBS_SIZE], OBS_SIZE))
    return times


#: [tle]: the HST frame (the main path's size and disc) and the card-vs-CPU
#: pair
TLE_SMALL = 256
TLE_SMALL_DISC = (*(v / 8 for v in DISC[:3]), DISC[3])


def daf_readers(paths) -> dict:
    """Which DAF reader ``daf.read_daf`` takes, and the two readers' parse
    times (median of 20, ms) on each of ``paths``, each checked against the
    other word for word."""
    from planetmapper_tpu_torch.kernels import daf, daf_native

    t0 = time.perf_counter()
    lib = daf_native._get_lib()
    build_ms = (time.perf_counter() - t0) * 1e3
    if lib is None:
        raise SmokeFailure('the native DAF reader did not build')
    reader = 'native C++' if daf_native.native_requested() else 'pure Python'
    times = {}
    for path in paths:
        out = {}
        for name, fn in (('native', daf_native.read_daf_native),
                         ('python', daf.read_daf_python)):
            runs = []
            for _ in range(20):
                t0 = time.perf_counter()
                parsed = fn(path)
                runs.append((time.perf_counter() - t0) * 1e3)
            out[name] = (float(np.median(runs)), parsed)
        native, python = out['native'][1], out['python'][1]
        if native is None or native.summaries != python.summaries or \
                not np.array_equal(native._data, python._data):
            raise SmokeFailure(f'the native DAF reader differs from the '
                               f'Python parser on {path}')
        name = os.path.basename(path)
        times[name] = dict(native=out['native'][0], python=out['python'][0])
        log(f'[tle] {name} ({os.path.getsize(path)} bytes, '
            f'{len(python.summaries)} segments): parse '
            f'{out["native"][0]:.4f} ms native against '
            f'{out["python"][0]:.4f} ms pure Python (median of 20), word '
            'for word equal')
    log(f'[tle] read_daf takes the {reader} reader (the native library '
        f'built or loaded in {build_ms:.1f} ms)')
    return dict(reader=reader, times=times)


def tle_phase(device, card: str) -> dict:
    """
    [tle]: Jupiter seen from HST (SPK type 10, SGP4) on the card: the
    scalar ephemeris calls timed, the observer's distance from the Earth's
    centre, ``compute_backplanes`` at 2048^2 (one kernel 1 launch, held
    against its plain version), a 256^2 card body's planes against a
    256^2 CPU body's; which DAF reader parsed the kernel.
    """
    from planetmapper_tpu_torch.core.ephemeris import get_ephemeris

    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_tle_') as kdir:
        files = write_synthetic_kernels(kdir, seed=0, satellites=True,
                                        tle=True)
        pt.clear_kernels()
        pt.set_kernel_path(kdir)
        readers = daf_readers(
            [files[2], write_sized_spk(os.path.join(kdir, 'sized.bsp'))])
        t0 = time.perf_counter()
        body = pt.BodyXY('Jupiter', observer='HST', utc=UTC, sz=SIZE,
                         device=device)
        body.set_disc_params(*DISC)
        build_ms = (time.perf_counter() - t0) * 1e3
        eph = get_ephemeris()
        et = f64(body.et)
        t0 = time.perf_counter()
        hst = eph.position_fn(-48, 399, body.et)(et)
        geometric_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        state, lt = eph.state_function(599, -48, body.aberration_correction,
                                       body.et)(et)
        apparent_ms = (time.perf_counter() - t0) * 1e3
        radius = float(torch.linalg.vector_norm(hst[:3]))
        log(f'[tle] {card} | BodyXY(Jupiter, observer=HST, {SIZE}x{SIZE}) '
            f'{build_ms:.1f} ms; HST about the Earth (type 10, two SGP4 '
            f'sets blended) {geometric_ms:.3f} ms on {hst.device}: '
            f'{radius:.3f} km from the centre, '
            f'{float(torch.linalg.vector_norm(hst[3:])):.4f} km/s; Jupiter '
            f'from HST ({body.aberration_correction}) {apparent_ms:.3f} ms: '
            f'{float(torch.linalg.vector_norm(state[:3])) / AU_KM:.6f} AU')
        if not 6500.0 < radius < 7500.0:
            raise SmokeFailure(f'HST is {radius} km from the Earth\'s centre')
        bk.reset_launch_count()
        out, main_ms, peak = synchronised(
            lambda: pipeline.compute_backplanes(body, as_numpy=False))
        launches = bk.launch_count()
        log(f'[tle] {card} | compute_backplanes of the HST frame '
            f'{main_ms:.1f} ms, kernel launches {launches}, peak '
            f'{peak:.1f} MiB')
        if launches != 1:
            raise SmokeFailure(f'the HST frame launched kernel 1 {launches} '
                               'times')
        plain = pipeline.fused_backplanes_fn(**FLAGS)
        check_against_plain(f'tle {SIZE}x{SIZE}', to_numpy(out),
                            to_numpy(one_frame(
                                plain, SIZE, SIZE,
                                pipeline.pipeline_inputs(body), device)),
                            DISC)
        del out
        card_body, cpu_body = (
            pt.BodyXY('Jupiter', observer='HST', utc=UTC, sz=TLE_SMALL,
                      device=where)
            for where in (device, torch.device('cpu'))
        )
        for b in (card_body, cpu_body):
            b.set_disc_params(*TLE_SMALL_DISC)
        check_against_plain(
            f'tle {TLE_SMALL}x{TLE_SMALL} card body against CPU body',
            to_numpy(pipeline.compute_backplanes(card_body, as_numpy=False)),
            pipeline.compute_backplanes(cpu_body), TLE_SMALL_DISC,
        )
        pt.clear_kernels()
    return dict(readers, build_ms=build_ms, geometric_ms=geometric_ms,
                apparent_ms=apparent_ms, main_ms=main_ms, radius=radius)


# ---------------------------------------------------------------------------
# [dsk]: the double-single kernels of ops/dsk.py (csrc/dsk.cu)
# ---------------------------------------------------------------------------

#: The value counts: the JAX tests' (8, 1024) block, and the main path's
#: 2048x2048 frame, where the bytes and the work outweigh the launch
DSK_SIZES = (dsk_cases.N_TEST, SIZE * SIZE)
#: The yardstick of each pair op: the float64 op over the same values, the
#: same bytes (two float32 words are the 8 bytes of one float64)
DSK_FLOAT64 = {'mul': torch.mul, 'div': torch.div, 'hypot': torch.hypot,
               'atan2_ds': torch.atan2}
DSK_OPS = (*dskk.OPS, 'atan2')


def dsk_inputs(n: int, device) -> dict:
    """Each op's case at ``n`` values: its numpy inputs and, on the card,
    its ds pairs (float32 ``y``, ``x`` for atan2)."""
    cases = {}
    for op in dskk.OPS:
        a64, b64 = dsk_cases.pair_inputs(op, n)
        cases[op] = (a64, b64,
                     dsk.split_f64(torch.from_numpy(a64).to(device)),
                     dsk.split_f64(torch.from_numpy(b64).to(device)))
    y, x = dsk_cases.atan2_inputs(n)
    cases['atan2'] = (y, x, torch.from_numpy(y).to(device),
                      torch.from_numpy(x).to(device))
    return cases


def dsk_run(cases) -> dict:
    """The path: every case through the wrappers, as a user calls them."""
    outs = {op: dskk.pairs(op, cases[op][2], cases[op][3])
            for op in dskk.OPS}
    outs['atan2'] = (dskk.atan2(cases['atan2'][2], cases['atan2'][3]),)
    torch.cuda.synchronize()
    return outs


def words_differing(got, ref) -> int:
    """Float32 words of ``got`` that differ from ``ref`` (NaN matching NaN
    whatever its payload)."""
    return sum(int(((g.view(torch.int32) != r.view(torch.int32))
                    & ~(torch.isnan(g) & torch.isnan(r))).sum())
               for g, r in zip(got, ref))


def dsk_check(n: int, cases, outs) -> dict[str, float]:
    """
    Each op's kernel output against float64 numpy at its JAX test's grade,
    and against its plain version on the card on the same inputs: word for
    word (NaN matching NaN), but for atan2_ds, whose kernel takes native
    float64 and its plain version the ds chain: NaN where the plain version
    has NaN, within dsk_cases.ATAN2_DS_VS_PLAIN, and word for word with
    torch.atan2 in float64 on the same hi + lo, split
    (dsk_kernel.atan2_ds_native). The largest |kernel - plain| (hi + lo in
    float64) of each op.
    """
    errors = {}
    for op in DSK_OPS:
        a64, b64, a, b = cases[op]
        plain = ((dskk.atan2_plain(a, b),) if op == 'atan2'
                 else dskk.pairs_plain(op, a, b))
        got = outs[op]
        words = words_differing(got, plain)
        value = sum(t.double() for t in got)
        ref = sum(t.double() for t in plain)
        both_nan = torch.isnan(value) & torch.isnan(ref)
        errors[op] = float(torch.where(both_nan, 0.0,
                                       torch.abs(value - ref)).max())
        grade = dsk_cases.error(op, value.cpu().numpy(), a64, b64)
        log(f'[dsk] {op} at {n} values: error {grade:.3e} against float64 '
            f'numpy (grade {dsk_cases.GRADES[op]:g}, '
            f'{"relative" if op in dsk_cases.RELATIVE else "rad"}); '
            f'{words} of {2 * n if op != "atan2" else n} words differ from '
            f'the plain version on the card (max |kernel - plain| '
            f'{errors[op]:.3e})')
        if not grade < dsk_cases.GRADES[op]:
            raise SmokeFailure(f'dsk {op} at {n} values: error {grade} '
                               f'above the grade {dsk_cases.GRADES[op]}')
        if op != 'atan2_ds':
            if words or not errors[op] == 0.0:
                raise SmokeFailure(f'dsk {op} at {n} values: {words} words '
                                   'differ from the plain version (bar: bit '
                                   'for bit)')
            continue
        nan_flips = int((torch.isnan(value) != torch.isnan(ref)).sum())
        native = words_differing(got, dskk.atan2_ds_native(a, b))
        log(f'[dsk] atan2_ds at {n} values: {nan_flips} NaN positions '
            'differ from the plain version (bar 0), max |kernel - plain| '
            f'{errors[op]:.3e} (bar {dsk_cases.ATAN2_DS_VS_PLAIN:g} rad); '
            f'{native} of {2 * n} words differ from torch.atan2 in float64 '
            'on the card, split (bar 0)')
        if nan_flips or not errors[op] <= dsk_cases.ATAN2_DS_VS_PLAIN \
                or native:
            raise SmokeFailure(f'dsk atan2_ds at {n} values: {nan_flips} NaN '
                               f'flips, |kernel - plain| {errors[op]}, '
                               f'{native} words off the float64 atan2')
    return errors


def dsk_edge_check(device) -> None:
    """
    dsk_cases.EDGES through both kernels, against their plain versions on
    the card: dsk_atan2 word for word; dsk_pairs<atan2_ds> word for word on
    the axes, at the origin and at NaN (the port's zero and NaN
    conventions), within dsk_cases.ATAN2_DS_VS_PLAIN elsewhere.
    """
    y64, x64 = (np.array(v) for v in zip(*dsk_cases.EDGES))
    y, x = (dsk.split_f64(torch.from_numpy(v).to(device)) for v in (y64, x64))
    got = dskk.pairs('atan2_ds', y, x)
    plain = dskk.pairs_plain('atan2_ds', y, x)
    axes = [i for i, e in enumerate(dsk_cases.EDGES)
            if dsk_cases.on_an_axis(*e)]
    on_axes = words_differing([t[axes] for t in got],
                              [t[axes] for t in plain])
    value, ref = (t[0].double() + t[1].double() for t in (got, plain))
    nan = torch.isnan(ref)
    off = float(torch.abs(value - ref)[~nan].max())
    y32, x32 = (torch.from_numpy(v.astype(np.float32)).to(device)
                for v in (y64, x64))
    f32_words = words_differing([dskk.atan2(y32, x32)],
                                [dskk.atan2_plain(y32, x32)])
    torch.cuda.synchronize()
    log(f'[dsk] the {len(dsk_cases.EDGES)} edge pairs: atan2_ds {on_axes} '
        f'words differ from the plain version at the {len(axes)} on the '
        f'axes, at the origin and at NaN (bar 0), max |kernel - plain| '
        f'{off:.3e} rad; atan2 {f32_words} words differ (bar 0)')
    if on_axes or f32_words or not torch.equal(torch.isnan(value), nan) \
            or not off <= dsk_cases.ATAN2_DS_VS_PLAIN:
        raise SmokeFailure('dsk edge pairs differ from the plain versions')


def dsk_timers(op: str, case):
    """(kernel, plain, float64 or float32 yardstick, branch counts) of one
    op's case: the kernel on buffers made once, as its wrapper makes them."""
    _, _, a, b = case
    if op == 'atan2':
        out = torch.empty_like(a)
        return (lambda: dskk.launch_atan2(a, b, out),
                lambda: dskk.atan2_plain(a, b),
                lambda: torch.atan2(a, b), bounds.atan2_branches(a, b))
    oh, ol = torch.empty_like(a[0]), torch.empty_like(a[0])
    a64 = a[0].double() + a[1].double()
    b64 = b[0].double() + b[1].double()
    library = DSK_FLOAT64[op]
    branches = (bounds.atan2_branches(a[0], b[0]) if op == 'atan2_ds'
                else {})
    return (lambda: dskk.launch_pairs(op, *a, *b, oh, ol),
            lambda: dskk.pairs_plain(op, a, b),
            lambda: library(a64, b64), branches)


def dsk_phase(device, card: str) -> dict:
    """
    The three cases of the JAX dsk tests through the kernels (the launches
    counted), held to their grades and plain versions at 8192 and 2048^2
    values, each op timed at both sizes.
    """
    small = dsk_inputs(DSK_SIZES[0], device)
    dskk.reset_launch_count()
    outs = dsk_run(small)
    launches = {k: dskk.launch_count(k) for k in dskk.KERNELS}
    log(f'[dsk] launches on the path (the three cases at {DSK_SIZES[0]} '
        f'values): {json.dumps(launches)}')
    if not all(launches.values()):
        raise SmokeFailure(f'a dsk kernel was not launched: {launches}')
    errors = dsk_check(DSK_SIZES[0], small, outs)
    dsk_edge_check(device)
    large = dsk_inputs(DSK_SIZES[1], device)
    for op, err in dsk_check(DSK_SIZES[1], large, dsk_run(large)).items():
        errors[op] = max(errors[op], err)
    flush = l2_flush(device)
    times = {}
    for n, cases in zip(DSK_SIZES, (small, large)):
        for op in DSK_OPS:
            kernel, plain, library, branches = dsk_timers(op, cases[op])
            t = time_pair(f'{card} | dsk {op} {n} values', kernel, plain,
                          library, flush, phase='dsk-time')
            bound = bounds.dsk_call_bound(op, n, **branches)
            t.update(bound=bound['ms'], bound_by=bound['bound_by'],
                     bytes=bound['bytes'], f32_ops=bound['f32_ops'])
            times[(op, n)] = t
            yardstick = ('torch.atan2 float32' if op == 'atan2'
                         else f'float64 {DSK_FLOAT64[op].__name__}')
            log(f'[dsk-time] {card} | {op} {n} values: bound '
                f'{bound["ms"] * 1e3:.3f} us ({bound["bound_by"]}: '
                f'{bound["bytes"]} bytes, {bound["f32_ops"]} FP32 '
                f'operations); kernel {t["kernel"] * 1e3:.2f} us cold, '
                f'{t["kernel_warm"] * 1e3:.2f} us warm ('
                f'{bound["ms"] / t["kernel"]:.1%} / '
                f'{bound["ms"] / t["kernel_warm"]:.1%} of the bound); plain '
                f'{t["plain"] * 1e3:.1f} us; '
                f'{yardstick} '
                f'{t["library"] * 1e3:.2f} us cold, '
                f'{t["library_warm"] * 1e3:.2f} us warm: kernel / yardstick '
                f'{t["kernel"] / t["library"]:.2f} cold, '
                f'{t["kernel_warm"] / t["library_warm"]:.2f} warm')
    return dict(launches=launches, errors=errors, times=times)


def dsk_entry(name: str, ops, launches: int, errors: dict, times: dict,
              replaces: str) -> dict:
    """The kernels-line entry of one dsk kernel: its ops at 2048^2 values,
    their cold times, plain times and yardsticks added, and the bound of
    the ops' bytes and operations together."""
    n = DSK_SIZES[1]
    runs = [times[(op, n)] for op in ops]
    ms, bound_by = bounds.roofline_ms(sum(t['bytes'] for t in runs),
                                      f32_ops=sum(t['f32_ops'] for t in runs))
    return dict(
        name=name,
        route='cuda',
        source='planetmapper_tpu_torch/csrc/dsk.cu',
        replaces=replaces,
        launches=launches,
        max_abs_err=max(errors[op] for op in ops),
        ms=sum(t['kernel'] for t in runs),
        plain_ms=sum(t['plain'] for t in runs),
        bound_ms=ms,
        bound_by=bound_by,
        library_ms=sum(t['library'] for t in runs),
    )


def main() -> int:
    t_start = time.perf_counter()
    card = card_line()
    log(f'card: {card}')
    if not torch.cuda.is_available():
        log('FAIL: torch.cuda.is_available() is False')
        return 1
    device = torch.device('cuda')
    log(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)}')
    try:
        occupancy = build_phase()
        with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
            write_synthetic_kernels(kdir, seed=0, satellites=True)
            pt.set_kernel_path(kdir)
            body, inputs, launches, peak, reports, n_disc = main_path_phase(
                device
            )
            if launches < 1:
                raise SmokeFailure('compute_backplanes launched no kernel')
            cases_phase(device)
            card = card_line()
            bp_times = timing_phase(body, inputs, card)
            bp_bound = bounds.backplane_bound(SIZE, SIZE, n_disc)
            log(f'[time] {card} | backplanes26 bound {bp_bound["ms"]:.4f} ms '
                f'({bp_bound["bound_by"]}: {bp_bound["f64_ops"]} FP64 + '
                f'{bp_bound["f32_ops"]} FP32 operations, {bp_bound["bytes"]} '
                f'bytes; {n_disc} on-disc pixels); kernel at '
                f'{bp_bound["ms"] / bp_times["kernel"]:.1%} of it; '
                f'{occupancy["registers"]} registers, '
                f'{occupancy["blocks_per_sm"]} blocks per SM')
            log(f'[memory] {card} | peak device memory of the main path '
                f'{peak / 2**20:.1f} MiB')
            t_par = time.perf_counter()
            batch_phase(body, card_line())
            series = timeseries_phase(device, card_line())
            sharded_phase(device, card_line())
            fit_phase(device, card_line())
            log(f'[parallel] the [batch], [timeseries], [sharded] and [fit] '
                f'phases {time.perf_counter() - t_par:.1f} s')
            t_map = time.perf_counter()
            bodies, images, calls, map_launches, map_errors, map_peak = \
                map_phase(device)
            map_times = map_timing_phase(bodies, images, calls, card_line())
            log(f'[memory] {card} | peak device memory of the map path '
                f'{map_peak / 2**20:.1f} MiB (its {len(map_runs())} outputs '
                'and the recorded kernel inputs held for the comparisons '
                'included)')
            log(f'[map] phase {time.perf_counter() - t_map:.1f} s')
            t_planes = time.perf_counter()
            planes = planes_phase(device, card_line())
            log(f'[planes] {card} | all 26 get_backplane_img on a fresh '
                f'{SIZE}x{SIZE} body {planes["img_ms"]:.1f} ms (peak '
                f'{planes["img_peak"]:.1f} MiB) against kernel 1\'s '
                f'{bp_times["kernel"]:.4f} ms for the same frame; all 26 '
                f'get_backplane_map {planes["map_ms"]:.1f} ms (peak '
                f'{planes["map_peak"]:.1f} MiB); phase '
                f'{time.perf_counter() - t_planes:.1f} s')
            t_obs = time.perf_counter()
            observation = observation_phase(device, card_line())
            steps = observation['steps']
            log(f'[observation] {card} | Observation export time (the '
                'first, uninstrumented run; include_wireframe=False: the '
                'overlay renders with matplotlib, which the card host '
                'lacks): '
                f'save_observation {steps["save_observation"][0]:.1f} ms, '
                'save_mapped_observation linear '
                f'{steps["save_mapped_observation linear"][0]:.1f} ms, '
                'smooth '
                f'{steps["save_mapped_observation smooth"][0]:.1f} ms, peak '
                f'{max(peak for _, peak in steps.values()):.1f} MiB; map '
                'kernel launches on the path '
                f'{json.dumps(observation["launches"])}; phase '
                f'{time.perf_counter() - t_obs:.1f} s')
            for kind, err in observation['errors'].items():
                map_errors[kind] = max(map_errors[kind], err)
            t_wf = time.perf_counter()
            wireframe_phase(device, card_line())
            log(f'[wireframe] phase {time.perf_counter() - t_wf:.1f} s')
            t_cli = time.perf_counter()
            cli_out = cli_phase(device, kdir, card_line())
            for kind, err in cli_out['errors'].items():
                map_errors[kind] = max(map_errors[kind], err)
            log(f'[cli] phase {time.perf_counter() - t_cli:.1f} s')
            t_gui = time.perf_counter()
            gui_phase(device, card_line())
            log(f'[gui] phase {time.perf_counter() - t_gui:.1f} s')
            t_tle = time.perf_counter()
            tle_phase(device, card_line())
            log(f'[tle] phase {time.perf_counter() - t_tle:.1f} s')
            pt.clear_kernels()
        t_dsk = time.perf_counter()
        dsk_out = dsk_phase(device, card_line())
        log(f'[dsk] phase {time.perf_counter() - t_dsk:.1f} s')
    except SmokeFailure as exc:
        log(f'FAIL: {exc}')
        return 1
    angle_err = max(
        reports[k]['max_abs_err'] for k in ANGLE_PLANES
        if np.isfinite(reports[k]['max_abs_err'])
    )
    spline_t = map_times['150^2 linear frame']
    smooth_t = map_times['150^2 smooth frame']
    pchip_t = map_times['150^2 smooth frame: pchip']
    infill_t = map_times[INFILL_TIMED]
    log(f'[done] {time.perf_counter() - t_start:.1f} s; max_abs_err: '
        f'backplanes26 the largest angle error [deg] of the {SIZE}x{SIZE} '
        'main path, backplanes26_batch that of every 100th frame of the '
        '[timeseries] 1000 scenes, the map kernels the largest value error '
        'of every map_img call; ms, plain_ms, library_ms, bound_ms: '
        f'backplanes26 at {SIZE}x{SIZE}, backplanes26_batch the 1000 '
        f'{SERIES["size"]}x{SERIES["size"]} scenes of [timeseries] with '
        'all 26 planes (plain_ms the plain graph frame by frame; launches '
        'those of the 1000-epoch series), map_spline the 150^2 linear '
        'frame, map_smooth the 150^2 smooth frame onto the 720x1440 map '
        'and pchip_axis its two launches (rows, columns; bound: the box to '
        'the grid), map_infill the benchmark\'s 2048^2 map_linear frame '
        '(max_abs_err 0: every call bit for bit with its plain version; '
        'ms_warm its warm time); the map '
        'kernels\' ms and library_ms with a cold L2, their plain_ms back to '
        'back; dsk_pairs its four ops and dsk_atan2 its one at 2048x2048 '
        'values (ms, plain_ms and library_ms the ops\' added, cold and back '
        'to back as the map kernels\'; library_ms the float64 op over the '
        'same bytes, torch.atan2 in float32; bound_ms of their bytes and '
        'operations together; max_abs_err |kernel - plain| of hi + lo, at '
        'both sizes)')
    print(json.dumps({'kernels': [
        dict(
            name='backplanes26',
            route='cuda',
            source='planetmapper_tpu_torch/csrc/backplanes.cu',
            replaces='planetmapper_tpu/ops/pallas_pipeline.py:262',
            launches=launches,
            max_abs_err=float(angle_err),
            ms=bp_times['kernel'],
            plain_ms=bp_times['plain'],
            bound_ms=bp_bound['ms'],
            bound_by=bp_bound['bound_by'],
            library_ms=None,
        ),
        dict(
            name='backplanes26_batch',
            route='cuda',
            source='planetmapper_tpu_torch/csrc/backplanes.cu',
            replaces='planetmapper_tpu/ops/pallas_pipeline.py:262',
            launches=series['launches'],
            max_abs_err=series['max_abs_err'],
            ms=series['ms'],
            plain_ms=series['plain_ms'],
            bound_ms=series['bound']['ms'],
            bound_by=series['bound']['bound_by'],
            library_ms=None,
        ),
        dict(
            name='map_spline',
            route='cuda',
            source='planetmapper_tpu_torch/csrc/map_spline.cu',
            replaces='planetmapper_tpu/ops/map_pallas.py:268 and '
                     'planetmapper_tpu/ops/map_pallas.py:628',
            launches=map_launches['map_spline'],
            max_abs_err=map_errors['spline'],
            ms=spline_t['kernel'],
            plain_ms=spline_t['plain'],
            bound_ms=spline_t['bound'],
            bound_by=spline_t['bound_by'],
            library_ms=spline_t['library'],
        ),
        dict(
            name='map_smooth',
            route='cuda',
            source='planetmapper_tpu_torch/csrc/map_smooth.cu',
            replaces='planetmapper_tpu/ops/smooth_pallas.py:208',
            launches=map_launches['map_smooth'],
            max_abs_err=map_errors['smooth'],
            ms=smooth_t['kernel'],
            plain_ms=smooth_t['plain'],
            bound_ms=smooth_t['bound'],
            bound_by=smooth_t['bound_by'],
            library_ms=smooth_t['library'],
        ),
        dict(
            name='pchip_axis',
            route='cuda',
            source='planetmapper_tpu_torch/csrc/pchip.cu',
            # the XLA oversampling in front of the TPU smooth sampler (no
            # pallas_call of its own)
            replaces='planetmapper_tpu/ops/pchip_device.py:89',
            launches=map_launches['pchip_axis'],
            max_abs_err=map_errors['pchip'],
            ms=pchip_t['kernel'],
            plain_ms=pchip_t['plain'],
            bound_ms=pchip_t['bound'],
            bound_by=pchip_t['bound_by'],
            library_ms=pchip_t['library'],
        ),
        dict(
            name='map_infill',
            route='cuda',
            source='planetmapper_tpu_torch/csrc/map_infill.cu',
            # the XLA NaN infill in front of the spline solve (no
            # pallas_call of its own)
            replaces='planetmapper_tpu/ops/interp_device.py:611',
            launches=map_launches['map_infill'],
            max_abs_err=map_errors['infill'],
            ms=infill_t['kernel'],
            ms_warm=infill_t['kernel_warm'],
            plain_ms=infill_t['plain'],
            bound_ms=infill_t['bound'],
            bound_by=infill_t['bound_by'],
            library_ms=None,
        ),
        dsk_entry('dsk_pairs', dskk.OPS, dsk_out['launches']['dsk_pairs'],
                  dsk_out['errors'], dsk_out['times'],
                  'tests/test_pallas_core.py:538'),
        dsk_entry('dsk_atan2', ('atan2',), dsk_out['launches']['dsk_atan2'],
                  dsk_out['errors'], dsk_out['times'],
                  'tests/test_pallas_core.py:596'),
    ]}))
    print(f'card: {card}')
    print(json.dumps({
        'ok': True,
        'device': {
            'platform': 'gpu',
            'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == '__main__':
    sys.exit(main())
