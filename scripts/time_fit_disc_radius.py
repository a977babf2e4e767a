"""
Time the disc-radius fit of ``Observation.fit_disc_radius`` at the map
benchmark's 1024x1024 frame (the 8-frame cube of ``chip_smoke.py``'s
``[observation]`` phase, a bright disc on MAP_BODIES[1024]):

- the port's aperture sums, all 100 radii in one batched reduction on the
  card (``ops/photometry.circular_aperture_sums``), and the whole
  ``fit_disc_radius`` of a card ``Observation`` (host clock, synchronised,
  median of 5 after a warm-up);
- the JAX package's aperture sums on the same image and radii: a numpy loop
  over the radii on the host CPU (``planetmapper_tpu/ops/photometry.py``,
  numpy only, loaded from its file without importing the JAX package,
  which needs jax), timed once, and the largest relative difference of the
  two sets of sums.

    python3 scripts/time_fit_disc_radius.py [--jax-radii N]

``--jax-radii N`` times the host loop over the first N radii only.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import planetmapper_tpu_torch as pt  # noqa: E402
from planetmapper_tpu_torch.ops import photometry  # noqa: E402
from planetmapper_tpu_torch.testing.observation_files import (  # noqa: E402
    disc_cube,
    write_observation,
)
from planetmapper_tpu_torch.testing.synthetic_kernels import (  # noqa: E402
    write_synthetic_kernels,
)
from planetmapper_tpu_torch.testing.timing import (  # noqa: E402
    MAP_BODIES,
    UTC,
    host_clock_ms,
    map_images,
)

SIZE = 1024


def host_photometry():
    """The JAX package's photometry module, loaded from its file."""
    path = os.path.join(ROOT, 'planetmapper_tpu', 'ops', 'photometry.py')
    spec = importlib.util.spec_from_file_location('host_photometry', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--jax-radii', type=int, default=100)
    args = parser.parse_args()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    disc = MAP_BODIES[SIZE]
    cube = disc_cube(map_images(SIZE, SIZE)[2], disc)
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_kernels(tmp, seed=0)
        pt.set_kernel_path(tmp)
        path = os.path.join(tmp, 'observation.fits')
        write_observation(path, cube, disc, UTC)
        obs = pt.Observation(path, device='cuda')
        x0, y0 = obs.get_x0(), obs.get_y0()
        img = obs._get_img_for_fitting()
        # the radii of fit_disc_radius for this disc
        r_ceil = int(min(x0, y0, SIZE - x0, SIZE - y0))
        radii = np.linspace(1, r_ceil + 1, 100)
        sums, _ = photometry.circular_aperture_sums(img, x0, y0, radii)
        sums_ms = host_clock_ms(
            lambda: photometry.circular_aperture_sums(img, x0, y0, radii), 5)

        def fit():
            obs.set_disc_params(x0, y0)
            obs.fit_disc_radius()

        fit()
        fit_ms = host_clock_ms(fit, 5)
        torch.cuda.synchronize()
        print(f'{card} | {SIZE}x{SIZE} frame, {len(radii)} radii: the '
              f'port\'s circular_aperture_sums on the card {sums_ms:.2f} ms; '
              f'Observation.fit_disc_radius {fit_ms:.2f} ms, r0 '
              f'{obs.get_r0():.3f} px (host clock, synchronised, median of 5)',
              flush=True)
        host = host_photometry()
        host_img = img.cpu().numpy()
        n = args.jax_radii
        t0 = time.perf_counter()
        host_sums, _ = host.circular_aperture_sums(host_img, x0, y0,
                                                   radii[:n])
        host_s = time.perf_counter() - t0
        diff = float(np.max(np.abs(host_sums - sums[:n]) / np.abs(host_sums)))
        print(f'{card} | the JAX package\'s circular_aperture_sums (numpy '
              f'loop on the host CPU) over {n} of the radii: {host_s:.2f} s '
              f'({host_s / n * 1e3:.1f} ms per radius); largest relative '
              f'difference from the port\'s sums {diff:.2e}', flush=True)
        pt.clear_kernels()
    return 0


if __name__ == '__main__':
    sys.exit(main())
