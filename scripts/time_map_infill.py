#!/usr/bin/env python3
"""
Device time of the spline modes' NaN infill (``csrc/map_infill.cu``) on one
NVIDIA GPU, beside its bound and beside what it replaced, in turns.

    python3 scripts/time_map_infill.py

Cases (``testing/infill_cases.py`` and ``testing/timing.py``): the
benchmark's ``map_linear`` frame (2048x2048, 4 NaN blocks of 3 px: the
infill and a median selection), the same frame with no NaN (the stencil
pass alone), and the 1024x1024 8-frame cube of ``chip_smoke.py``'s map
phase (one frame with a NaN block). For each, in two turns, CUDA events:

- ``kernel``: :func:`map_infill` (its allocations and its one launch),
  cold (one call after a 128 MB read, median of 30) and back to back;
- ``frame_loop``: the stages the kernel replaced on a degree-1 map: a
  clone of the cube, :func:`infill_plain` on each frame with a
  non-finite cell (a boolean index, a sort, pads, 18 slice adds) after a
  host read of the frames' flags, and the product by both identity
  inverses, back to back;
- ``host``: the host clock from the call to the end of a synchronise,
  median of 30, for both.

The bound (each input byte read once, each output byte written once, at
3.35 TB/s): 8 bytes read and 8 + 1 written a cell. The kernel is held bit
for bit against :func:`map_infill_plain` on every case first; its
registers, spills and resident blocks are printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

def main() -> int:
    import numpy as np
    import torch

    from planetmapper_tpu_torch.ops import map_infill_kernel as mik
    from planetmapper_tpu_torch.testing import bounds, infill_cases, timing

    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device')
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    device = torch.device('cuda')
    frame = infill_cases.map_linear_frame(seed=0)
    cases = {
        'map_linear 2048^2': frame,
        'finite 2048^2': np.nan_to_num(frame),
        '1024^2 8-frame cube': timing.map_images(1024, 1024)[2],
    }
    mik.load_library()
    print(f'{card} | map_infill occupancy (stencil, select): '
          f'{mik.occupancy()}', flush=True)
    print(mik.ptxas_log(), flush=True)
    flush = timing.l2_flush(device)
    results = {}
    for name, host in cases.items():
        frames = torch.from_numpy(host).to(device)
        got = mik.map_infill(frames)
        ref = mik.map_infill_plain(torch.from_numpy(host))
        for g, r in zip(got, ref):
            if not torch.equal(g.cpu(), r):
                print(f'FAIL: {name}: the kernel differs from its plain '
                      'version')
                return 1
        n = host.shape[-1]
        eye = torch.eye(n, dtype=torch.float64, device=device)

        def frame_loop(frames=frames, eye=eye):
            finite = torch.isfinite(frames.reshape(frames.shape[0], -1))
            partial = ~finite.all(dim=1).cpu().numpy()
            cleaned = frames.clone()
            nans = torch.zeros(frames.shape, dtype=torch.bool, device=device)
            for i in np.flatnonzero(partial):
                cleaned[i], nans[i] = mik.infill_plain(frames[i])
            return eye @ (cleaned @ eye.T)

        def kernel(frames=frames):
            return mik.map_infill(frames)

        fns = {'kernel': kernel, 'frame_loop': frame_loop}
        warm = timing.in_turns({k: (fn, 20) for k, fn in fns.items()},
                               timing.cuda_time_ms)
        cold = timing.in_turns({'kernel': (kernel, 30)},
                               lambda fn, r: timing.cold_time_ms(fn, r, flush))
        host_ms = timing.in_turns({k: (fn, 30) for k, fn in fns.items()},
                                  timing.host_clock_ms)
        bound_ms = bounds.infill_call_bound(frames)['ms']
        kernel_ms = float(np.mean(cold['kernel']))
        results[name] = dict(
            bound_ms=bound_ms, kernel_cold_ms=cold['kernel'],
            kernel_warm_ms=warm['kernel'], frame_loop_ms=warm['frame_loop'],
            host_ms=host_ms, share_of_bound_cold=bound_ms / kernel_ms,
        )
        print(f'{card} | {name}: ' + json.dumps(results[name]), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
