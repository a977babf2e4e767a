#!/usr/bin/env python3
"""
The upload of a host array to one NVIDIA GPU: ``map_img``'s route through
the page-locked ring (``planetmapper_tpu_torch.host_slots.upload``) against
the plain pageable copy (``torch.as_tensor(array, device=...)``), in turns.

    python3 scripts/time_upload.py [--reps N]

Each source is one of 8 arrays of its size, taken in turn, so that a large
one is read from host memory as a map cell's pool frames are. Printed,
beside the card's name and power limit and the host's threads:

- ``stage``: the host copy into page-locked memory in the ring's chunks
  (one ``copy_`` a chunk, as the ring makes it) with PyTorch's intra-op
  threads set to 1, 2, 4 and 8 (``torch.set_num_threads``; the ring uses
  the process's setting);
- ``dma``: the copy of page-locked memory to the card, by CUDA events;
- ``upload``: the helper and the pageable copy, each ended by a synchronise
  (the host clock of a caller that waits for the card), and the helper's
  own return (its bytes staged, the last copies in flight), at the frame of
  ``jupiter_2048.map_linear`` and the three band cubes of
  ``neptune_mrs.cube_smooth``;
- ``sweep``: the helper at chunk sizes of 2-16 MiB and 2 or 4 chunks, on
  the frame, the largest cube and a 48 MiB cube, beside the pageable copy;
- ``crossover``: the helper and the pageable copy from 64 KiB to 4 MiB.

Times are medians over ``--reps`` calls, in ms, and rates in GB/s (1e9 B).
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from planetmapper_tpu_torch import host_slots  # noqa: E402

MIB = 1 << 20
FRAME = (2048, 2048)
CUBES = [(1050, 41, 40), (1213, 41, 40), (1400, 41, 40)]
#: A cube past the ring (48 MiB: 12 planes of 1024^2)
LARGE = (12, 1024, 1024)
POOL = 8


def smi(query: str) -> str:
    return subprocess.run(
        ['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def pool(shape, seed=0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(POOL)]


def median_ms(times: list[float]) -> float:
    return 1e3 * statistics.median(times)


def gbps(n_bytes: int, ms: float) -> float:
    return n_bytes / ms / 1e6


def stage(srcs, pinned, reps, threads) -> float:
    """The host copy of each source into ``pinned``, a ``copy_`` a chunk,
    on ``threads`` intra-op threads."""
    torch.set_num_threads(threads)
    flat = [torch.from_numpy(s.reshape(-1).view(np.uint8)) for s in srcs]
    times = []
    for r in range(reps):
        src = flat[r % len(flat)]
        t0 = time.perf_counter()
        for a, b in host_slots.chunk_plan(src.numel()):
            pinned[a:b].copy_(src[a:b])
        times.append(time.perf_counter() - t0)
    return median_ms(times)


def dma(pinned, dev, reps) -> float:
    out = torch.empty(pinned.numel(), dtype=torch.uint8, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        start.record()
        out.copy_(pinned, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return median_ms(times)


def turns(srcs, dev, reps) -> dict[str, float]:
    """The helper and the pageable copy in turns; each to the card's end,
    and the helper's own return."""
    t = {'helper': [], 'helper_return': [], 'pageable': []}
    for r in range(reps):
        src = srcs[r % len(srcs)]
        for way in (('helper', 'pageable') if r % 2 else
                    ('pageable', 'helper')):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if way == 'helper':
                host_slots.upload(src, dev)
                t['helper_return'].append(time.perf_counter() - t0)
            else:
                torch.as_tensor(src, device=dev)
            torch.cuda.synchronize()
            t[way].append(time.perf_counter() - t0)
    return {k: median_ms(v) for k, v in t.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--reps', type=int, default=60)
    reps = parser.parse_args().reps
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    dev = torch.device('cuda')
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(smi('name,power.limit'))
    default_threads = torch.get_num_threads()
    print(f'host: os.cpu_count {os.cpu_count()}, affinity '
          f'{len(os.sched_getaffinity(0))}, torch threads {default_threads}, '
          f'ring {host_slots.RING_CHUNKS} x {host_slots.CHUNK_BYTES // MIB} '
          f'MiB, MIN_STAGED_BYTES {host_slots.MIN_STAGED_BYTES}')
    frames = pool(FRAME)
    n = frames[0].nbytes
    pinned = host_slots._pin(n)

    print(f'[stage] {n} B in {host_slots.CHUNK_BYTES // MIB} MiB chunks')
    for threads in (1, 2, 4, 8):
        ms = stage(frames, pinned, reps, threads)
        print(f'  threads {threads}: {ms:.4f} ms {gbps(n, ms):.2f} GB/s')
    torch.set_num_threads(default_threads)

    ms = dma(pinned, dev, reps)
    print(f'[dma] {n} B page-locked to the card: {ms:.4f} ms '
          f'{gbps(n, ms):.2f} GB/s')
    ms = dma(pinned[:host_slots.CHUNK_BYTES], dev, reps)
    print(f'[dma] one chunk ({host_slots.CHUNK_BYTES} B): {ms:.4f} ms '
          f'{gbps(host_slots.CHUNK_BYTES, ms):.2f} GB/s')

    for shape in [FRAME] + CUBES:
        srcs = pool(shape, seed=1)
        nb = srcs[0].nbytes
        host_slots.upload(srcs[0], dev)  # pins the ring
        got = host_slots.upload(srcs[1], dev)
        ok = torch.equal(got.cpu(), torch.from_numpy(srcs[1]))
        t = turns(srcs, dev, reps)
        print(f'[upload] {shape} {nb} B (bytes equal: {ok}): helper '
              f'{t["helper"]:.4f} ms {gbps(nb, t["helper"]):.2f} GB/s '
              f'(returns {t["helper_return"]:.4f}) | pageable '
              f'{t["pageable"]:.4f} ms {gbps(nb, t["pageable"]):.2f} GB/s')

    inputs = {'frame': frames, 'cube': pool(CUBES[-1], seed=2),
              'large': pool(LARGE, seed=4)}
    kept = host_slots.UPLOADS
    for chunk_mib in (2, 4, 8, 16):
        for n_chunks in (2, 4):
            host_slots.UPLOADS = host_slots.UploadRing(n_chunks,
                                                       chunk_mib * MIB)
            line = []
            for name, srcs in inputs.items():
                host_slots.upload(srcs[0], dev)
                t = turns(srcs, dev, reps // 2)
                line.append(f'{name} {t["helper"]:.4f} ms (returns '
                            f'{t["helper_return"]:.4f}; '
                            f'{t["helper"] / t["pageable"]:.3f} of pageable '
                            f'{t["pageable"]:.4f})')
            print(f'[sweep] {n_chunks} x {chunk_mib} MiB: ' + ' | '.join(line))
    host_slots.UPLOADS = kept

    floor = host_slots.MIN_STAGED_BYTES
    host_slots.MIN_STAGED_BYTES = 0
    for kib in (64, 256, 512, 1024, 1536, 2048, 3072, 4096):
        srcs = pool((kib * 256,), seed=3)
        t = turns(srcs, dev, reps)
        print(f'[crossover] {kib} KiB: helper {t["helper"]:.4f} ms | '
              f'pageable {t["pageable"]:.4f} ms')
    host_slots.MIN_STAGED_BYTES = floor
    print(smi('name,power.limit'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
