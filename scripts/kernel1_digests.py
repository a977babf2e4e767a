#!/usr/bin/env python3
"""
SHA-256 digests of kernel 1's planes at the port's entry points on one
NVIDIA GPU, to hold a change of kernel 1's wrapper or routes bit for bit
to another checkout:

    python3 scripts/kernel1_digests.py [--tree DIR] > digests.json

The calls: ``compute_backplanes`` at 2048x2048; ``compute_backplanes_batch``
of a disc sweep at 8 x 2048^2, 8 x 640^2 and 1000 x 50^2;
``sharded_backplanes`` on a 4-entry mesh of the card at 2048x2048; and
``backplane_time_series`` of bench.py:343's 1000 epochs at 50x50; all 26
planes, on synthetic SPICE kernels written at run time. A plane's digest
covers its dtype, shape and bytes. ``--tree DIR`` imports the package of
another checkout (for example the parent commit unpacked with ``git
archive`` into an ignored directory), which builds into its own
``build/``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: (frames, size) of the compute_backplanes_batch calls
BATCHES = [(8, 2048), (8, 640), (1000, 50)]


def digest(planes: dict) -> dict[str, str]:
    out = {}
    for name, plane in planes.items():
        value = plane.detach().cpu().numpy() if hasattr(plane, 'detach') \
            else plane
        h = hashlib.sha256(f'{value.dtype} {value.shape}'.encode())
        h.update(value.tobytes())
        out[name] = h.hexdigest()[:24]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tree', type=Path, default=ROOT,
                        help='checkout whose package to import')
    tree = parser.parse_args().tree.resolve()
    sys.path.insert(0, str(tree))

    import numpy as np
    import torch

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch import pipeline
    from planetmapper_tpu_torch.parallel import (
        backplane_time_series,
        make_mesh,
        sharded_backplanes,
    )
    from planetmapper_tpu_torch.testing import timing
    from planetmapper_tpu_torch.testing.synthetic_kernels import (
        write_synthetic_kernels,
    )

    if Path(pt.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f'imported {pt.__file__}, not from {tree}')
    if not torch.cuda.is_available():
        print('FAIL: needs a CUDA device', file=sys.stderr)
        return 1
    device = torch.device('cuda')

    def body(size):
        b = pt.BodyXY('Jupiter', observer='EARTH', utc=timing.UTC, sz=size,
                      device=device)
        scale = size / timing.SIZE
        b.set_disc_params(*(v * scale for v in timing.DISC[:3]),
                          timing.DISC[3])
        return b

    out = {}
    with tempfile.TemporaryDirectory(prefix='synthetic_kernels_') as kdir:
        write_synthetic_kernels(kdir, seed=0)
        pt.set_kernel_path(kdir)
        full = body(timing.SIZE)
        out['compute_backplanes 2048^2'] = digest(
            pipeline.compute_backplanes(full))
        for n, size in BATCHES:
            b = body(size)
            x0, y0, r0, rot = b.get_disc_params()
            step = np.linspace(-0.035, 0.035, n)
            discs = np.stack([x0 + 2 * r0 * step, y0 - r0 * step,
                              r0 * (1 + step), rot + 500 * step], axis=1)
            xys = []
            for disc in discs:
                b.set_disc_params(*disc)
                xys.append(np.array(b._get_xy2angular_matrix()))
            b.set_disc_params(x0, y0, r0, rot)
            planes = pipeline.compute_backplanes_batch(
                b, np.array(xys), discs, as_numpy=False)
            out[f'compute_backplanes_batch {n} x {size}^2'] = digest(planes)
            del planes
        out['sharded_backplanes 4 entries 2048^2'] = digest(
            sharded_backplanes(full, make_mesh(4, device=device)))
        series = body(50)
        series.set_disc_params(25.0, 25.0, 20.0, 0.0)
        out['backplane_time_series 1000 x 50^2'] = digest(
            backplane_time_series(series, series.et + 60.0 * np.arange(1000),
                                  as_numpy=False))
        pt.clear_kernels()
    torch.cuda.synchronize()
    json.dump(out, sys.stdout, indent=1)
    print()
    return 0


if __name__ == '__main__':
    sys.exit(main())
