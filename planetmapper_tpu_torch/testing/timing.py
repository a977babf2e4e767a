"""
The card timers and the benchmark frames that ``chip_smoke.py`` and the
``scripts/time_*.py`` scripts share.

It imports numpy and torch only, nothing of the package, so that a script
can load this file from its own checkout while it imports the package of
another checkout (``--tree``) to time two versions the same way.
"""

from __future__ import annotations

import time

import numpy as np
import torch

#: Jupiter from the Earth at this epoch, on synthetic SPICE kernels
UTC = '2005-01-01T00:00:00'
#: The backplane frame: the JAX package's bench.py frame
SIZE = 2048
DISC = (1024.0, 1024.0, 819.2, 12.3)

#: The map benchmark of the JAX package: a 720x1440 rectangular map at
#: 0.25 deg (bench.py:168) from a 150x150 frame (bench.py:163-167; the
#: regime of TPU kernel 2) and a 1024x1024 frame (bench.py:245-249;
#: kernel 3), as frames and as cubes (bench.py:252, :278).
MAP_KW = dict(degree_interval=0.25)
MAP_SHAPE = (720, 1440)
MAP_BODIES = {150: (75.0, 75.0, 60.0, 12.3), 1024: (512.0, 512.0, 409.6, 12.3)}
MAP_CUBE_FRAMES = {150: 16, 1024: 8}
#: NaN blocks: tests/test_pallas_core.py:712 for 150x150, one on the
#: 1024x1024 disc
NAN_BLOCK = {150: (slice(40, 44), slice(50, 53)),
             1024: (slice(400, 404), slice(500, 503))}
#: A buffer larger than the card's 50 MB L2, read before each cold launch
#: (a read leaves clean lines; a write would leave up to 50 MB of dirty
#: lines whose write-back the timed launch would pay)
FLUSH_BYTES = 128 * 2**20


def map_images(size: int, seed: int):
    """``(frame, with_nan, cube)``: seeded images of one map source size."""
    rng = np.random.default_rng(seed)
    frame = rng.normal(size=(size, size))
    with_nan = frame.copy()
    with_nan[NAN_BLOCK[size]] = np.nan
    cube = rng.normal(size=(MAP_CUBE_FRAMES[size], size, size))
    cube[1][NAN_BLOCK[size]] = np.nan
    return frame, with_nan, cube


def spline_launch_buffers(args) -> tuple:
    """
    The buffers of ``map_spline_kernel.launch`` for the arguments ``(x, y,
    valid, ty, tx, coeffs, nan_grid)`` of one ``map_spline`` call, as its
    wrapper prepares them (uint8 masks, per-frame any-NaN flags, output).
    """
    x, y, valid, ty, tx, coeffs, nan_grid = args
    nan_u8 = nan_grid.to(torch.uint8).contiguous()
    return (x, y, valid.to(torch.uint8), ty, tx, coeffs, nan_u8,
            nan_u8.reshape(nan_u8.shape[0], -1).any(1).to(torch.uint8),
            torch.empty((coeffs.shape[0], x.numel()), dtype=torch.float32,
                        device=x.device))


def smooth_launch_buffers(args) -> tuple:
    """
    The buffers of ``map_smooth_kernel.launch`` for the arguments ``(x, y,
    valid, grid, nan_img)`` of one ``map_smooth`` call, as its wrapper
    prepares them.
    """
    x, y, valid, grid, nan_img = args
    nan_u8 = nan_img.to(torch.uint8).contiguous()
    return (x, y, valid.to(torch.uint8), grid.contiguous(), nan_u8,
            nan_u8.reshape(nan_u8.shape[0], -1).any(1).to(torch.uint8),
            torch.empty((grid.shape[0], x.numel()), dtype=torch.float32,
                        device=x.device))


def sum_yardstick(n_bytes: int, device):
    """A yardstick, not a kernel of the port: one library launch
    (``torch.sum``) that reads ``n_bytes``."""
    return torch.ones(max(int(n_bytes) // 4, 1), device=device).sum


def l2_flush(device):
    """A call that evicts the L2: a read of :data:`FLUSH_BYTES`."""
    buffer = torch.ones(FLUSH_BYTES // 4, device=device)
    return buffer.sum


def cuda_time_ms(fn, reps: int) -> float:
    """
    Device time per call of ``fn`` over ``reps`` calls (CUDA events). A
    device-side sleep first lets the host queue the calls ahead of the
    card, so that short kernels are timed back to back and not at the rate
    the host launches them.
    """
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_time_ms(fn, reps: int, flush) -> float:
    """
    Device time of one call of ``fn`` right after ``flush()`` has evicted
    the L2 (CUDA events around the call alone), the median of ``reps``
    calls queued behind a device-side sleep.
    """
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def host_clock_ms(fn, reps: int) -> float:
    """
    What a caller waiting for one call of ``fn`` pays: the host-clock time
    from the call to the end of a synchronise after it, the median of
    ``reps`` calls (host work, launches and device time together).
    """
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def back_to_back_ms(fn, reps: int) -> float:
    """Host-clock time per call of ``reps`` calls and one synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def in_turns(runs: dict, timer) -> dict[str, list[float]]:
    """
    ``timer(fn, reps)`` of every run ``{name: (fn, reps)}`` after a
    warm-up, in two turns (the second in reverse order).
    """
    for fn, _ in runs.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for name in turn:
            fn, reps = runs[name]
            times[name].append(timer(fn, reps))
    return times
