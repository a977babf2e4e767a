#!/usr/bin/env python3
"""
The copy of 26 backplanes of 2048x2048 to the host, three ways, on one
NVIDIA GPU.

    python3 scripts/time_d2h_copy.py [--reps N]

The planes are kernel 1's two device allocations: a (25, 2048, 2048)
float32 stack and the float64 RADIAL-VELOCITY (453 MB). Each way is timed
as a caller pays for it, on the host clock, the copy's device time by CUDA
events, beside the card's name, power limit and PCIe link:

- ``pageable``: 26 ``.cpu().numpy()`` copies into fresh arrays, the last
  step's arrays held until the next step's have come;
- ``pinned``: one ``copy_(non_blocking=True)`` an allocation into a buffer
  from ``torch.empty(..., pin_memory=True)``, one synchronise;
- ``registered``: the same into an anonymous mapping page-locked with
  ``cudaHostRegister`` (``planetmapper_tpu_torch.host_slots._pin``, the
  slots of ``compute_backplanes``).

The allocation of each page-locked buffer (first and second of one size)
and its release are timed too.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from planetmapper_tpu_torch.host_slots import _pin as registered  # noqa: E402

SIZE = 2048
N_F32 = 25


def smi(query: str) -> str:
    return subprocess.run(
        ['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def pinned_torch(n_bytes: int) -> torch.Tensor:
    return torch.empty(n_bytes, dtype=torch.uint8, pin_memory=True)


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--reps', type=int, default=30)
    reps = parser.parse_args().reps
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    dev = torch.device('cuda')
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(smi('name,power.limit'), '| PCIe gen current/max, width:',
          smi('pcie.link.gen.current,pcie.link.gen.max,'
              'pcie.link.width.current'))
    g = torch.Generator(device=dev).manual_seed(0)
    stack = torch.rand((N_F32, SIZE, SIZE), generator=g, device=dev)
    rv = torch.rand((SIZE, SIZE), generator=g, device=dev,
                    dtype=torch.float64)
    planes = list(stack) + [rv]
    f32_bytes = stack.numel() * 4
    n_bytes = f32_bytes + rv.numel() * 8
    stream = torch.cuda.current_stream(dev)
    results = {}

    def pageable():
        return [p.cpu().numpy() for p in planes]

    def into(slot):
        def copy():
            slot[:f32_bytes].view(torch.float32).view(stack.shape).copy_(
                stack, non_blocking=True)
            slot[f32_bytes:].view(torch.float64).view(rv.shape).copy_(
                rv, non_blocking=True)
            stream.synchronize()
        return copy

    for name, alloc in (('pinned', pinned_torch), ('registered', registered)):
        a, first_ms = timed(lambda: alloc(n_bytes))
        b, second_ms = timed(lambda: alloc(n_bytes))
        print(f'{name}: allocation of {n_bytes} B, first {first_ms:.1f} ms, '
              f'second {second_ms:.1f} ms', flush=True)
        results[name] = (into(a), into(b))
        del a, b

    torch.cuda.synchronize()
    for turn in range(2):
        for name in ('pageable', 'pinned', 'registered'):
            host, dev_ms = [], []
            held = None
            for i in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                if name == 'pageable':
                    out = pageable()
                else:
                    out = results[name][i % 2]()
                end.record()
                end.synchronize()
                host.append(1e3 * (time.perf_counter() - t0))
                dev_ms.append(start.elapsed_time(end))
                held = out  # the caller holds the last step's planes
            del held
            med = statistics.median(dev_ms)
            print(f'turn {turn} {name}: host ms median '
                  f'{statistics.median(host):.3f} (min {min(host):.3f}, max '
                  f'{max(host):.3f}); device ms median {med:.3f}, '
                  f'{n_bytes / med / 1e6:.2f} GB/s', flush=True)
    for name in ('pinned', 'registered'):
        t0 = time.perf_counter()
        results.pop(name)
        print(f'{name}: release of two buffers '
              f'{1e3 * (time.perf_counter() - t0):.1f} ms', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
