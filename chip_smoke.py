"""
Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the backplane kernel (``planetmapper_tpu_torch/csrc/backplanes.cu``)
with nvcc, drives the port's main path - ``pipeline.compute_backplanes`` on
a 2048x2048 BodyXY of Jupiter seen from the Earth on 2005-01-01 (synthetic
SPICE kernels written at run time) - and holds the kernel against its plain
float64 PyTorch version on the card: at the full frame, and at a ragged,
a row-offset, an un-gated and a plane-subset case. Then it times the
kernel and the plain version at 2048x2048.

Prints the card's name and power limit, one JSON line describing each
kernel, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, without that line, when a phase fails or no CUDA device exists.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import planetmapper_tpu_torch as pt
from planetmapper_tpu_torch import pipeline
from planetmapper_tpu_torch._device import f64
from planetmapper_tpu_torch.ops import backplanes_kernel as bk
from planetmapper_tpu_torch.testing import compare
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    AU_KM,
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
SIZE = 2048
DISC = (1024.0, 1024.0, 819.2, 12.3)  # the JAX package's bench.py frame
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


def pipeline_args(body, device):
    return (
        f64(body._get_xy2angular_matrix(), device),
        f64(np.asarray(body.get_disc_params()), device),
        f64(np.asarray(body.radii), device),
        pipeline._device_anchors(body),
    )


def check_against_plain(label, got, ref, disc, row0=0.0) -> dict:
    """
    The kernel's planes against the plain float64 version's, at the JAX
    package's kernel table (testing/compare.py), with the reference stored
    in float32 as the kernel stores it. The one pixel whose ray passes
    through the target centre (when a pixel centre sits on the disc
    centre) is left out of the limb planes: its limb coordinates are
    undefined and both versions return rounding noise there.
    """
    ny, nx = next(iter(got.values())).shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    centre = np.hypot(xx - disc[0], yy + row0 - disc[1]) < 0.5
    reports = compare.compare_backplanes(
        got, ref, float32_ulps=1,
        exclude={name: centre for name in LIMB_PLANES},
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
    t0 = time.perf_counter()
    bk.load_library()
    log(f'[build] nvcc + load {time.perf_counter() - t0:.1f} s')
    for line in bk.ptxas_log().splitlines():
        if any(w in line for w in ('registers', 'spill', 'Compiling')):
            log(f'[build] ptxas: {line.strip()}')


def main_path_phase(device, size=SIZE, disc=DISC):
    """compute_backplanes on the full frame, checked and held to the plain."""
    t0 = time.perf_counter()
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=size,
                     device=device)
    body.set_disc_params(*disc)
    args = pipeline_args(body, device)
    log(f'[scene] BodyXY + anchors {time.perf_counter() - t0:.2f} s on '
        f'{body.device}; Jupiter at {body.target_distance / AU_KM:.3f} AU')
    _, use_kernel = pipeline.select_pipeline_impl(body, size, size)
    log(f'[main] selected implementation: '
        f'{"CUDA kernel" if use_kernel else "plain graph"}')

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
        f'main {size}x{size}', main_out, to_numpy(plain(size, size, *args)),
        disc,
    )
    return body, args, launches, peak, reports


def cases_phase(device) -> None:
    """Ragged shape, row0 band, optimize_speed off, plane subsets."""
    nx, ny, disc = RAGGED
    body = pt.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=nx, ny=ny,
                     device=device)
    body.set_disc_params(*disc)
    args = pipeline_args(body, device)
    row0, rows = BAND
    full = None
    for speed in (True, False):
        kern = bk.build_backplanes_kernel(
            optimize_speed=speed, lst_quant=True, **FLAGS,
        )
        plain = pipeline.fused_backplanes_fn(optimize_speed=speed, **FLAGS)
        frame = to_numpy(kern(nx, ny, *args))
        check_against_plain(
            f'ragged {nx}x{ny} optimize_speed={speed}', frame,
            to_numpy(plain(nx, ny, *args)), disc,
        )
        band = to_numpy(kern(nx, rows, *args, row0=float(row0)))
        check_against_plain(
            f'row0={row0} band optimize_speed={speed}', band,
            to_numpy(plain(nx, rows, *args, row0=float(row0))), disc,
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
    for planes in SUBSETS:
        sub = to_numpy(bk.build_backplanes_kernel(
            optimize_speed=True, lst_quant=True, planes=planes, **FLAGS,
        )(nx, ny, *args))
        if set(sub) != set(planes):
            raise SmokeFailure(f'subset {planes} returned {sorted(sub)}')
        for name in planes:
            if not np.array_equal(sub[name], full[name], equal_nan=True):
                raise SmokeFailure(f'subset {planes}: {name} differs')
    log(f'[subsets] {len(SUBSETS)} subsets equal the full set exactly')


def cuda_time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timing_phase(body, args, card: str) -> tuple[float, float]:
    """Kernel and plain version at the full frame, in turns; blocked call."""
    kern = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(**FLAGS)
    scene = bk.scene_scalars(*args)
    out = torch.empty((len(bk.PLANE_ORDER), SIZE, SIZE),
                      dtype=torch.float32, device=scene.device)
    runs = {
        'kernel': (lambda: kern.launch(scene, out, SIZE, SIZE), 50),
        'kernel with scene prep': (lambda: kern(SIZE, SIZE, *args), 50),
        'plain': (lambda: plain(SIZE, SIZE, *args), 5),
    }
    for fn, _ in runs.values():
        fn()  # warm-up
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    for order in (('plain', 'kernel', 'kernel with scene prep'),
                  ('kernel with scene prep', 'kernel', 'plain')):
        for name in order:
            fn, reps = runs[name]
            times[name].append(cuda_time_ms(fn, reps))
    log(f'[time] {card} | {SIZE}x{SIZE} ms per call (two turns each): '
        + json.dumps(times))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.compute_backplanes(body)
    log(f'[time] {card} | one blocked compute_backplanes (planes to numpy) '
        f'{(time.perf_counter() - t0) * 1e3:.2f} ms')
    return float(np.mean(times['kernel'])), float(np.mean(times['plain']))


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
        build_phase()
        with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
            write_synthetic_kernels(kdir, seed=0)
            pt.set_kernel_path(kdir)
            body, args, launches, peak, reports = main_path_phase(device)
            if launches < 1:
                raise SmokeFailure('compute_backplanes launched no kernel')
            cases_phase(device)
            card = card_line()
            kernel_ms, plain_ms = timing_phase(body, args, card)
            log(f'[memory] {card} | peak device memory of the main path '
                f'{peak / 2**20:.1f} MiB')
            pt.clear_kernels()
    except SmokeFailure as exc:
        log(f'FAIL: {exc}')
        return 1
    angle_err = max(
        reports[k]['max_abs_err'] for k in ANGLE_PLANES
        if np.isfinite(reports[k]['max_abs_err'])
    )
    log(f'[done] {time.perf_counter() - t_start:.1f} s; max_abs_err is the '
        f'largest angle error [deg] of the {SIZE}x{SIZE} main path')
    print(json.dumps({'kernels': [dict(
        name='backplanes26',
        route='cuda',
        source='planetmapper_tpu_torch/csrc/backplanes.cu',
        replaces='planetmapper_tpu/ops/pallas_pipeline.py:262',
        launches=launches,
        max_abs_err=float(angle_err),
        ms=kernel_ms,
        plain_ms=plain_ms,
    )]}))
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
