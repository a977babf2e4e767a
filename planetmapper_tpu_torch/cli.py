"""
Command line interface (parity with the reference's console script).

``planetmapper-tpu-torch [file]`` (or ``python -m planetmapper_tpu_torch``)
launches the GUI, optionally opening an observation immediately;
``--version`` prints the version. ``--precision`` selects the backplane
pipeline's numeric mode, and ``--prewarm`` builds the CUDA kernel
libraries and runs the main path once per image size on the card.
"""

from __future__ import annotations

import argparse


def main(args: list[str] | None = None) -> None:
    """CLI entry point. :meta private:"""
    from . import common

    parser = argparse.ArgumentParser(
        prog='planetmapper-tpu-torch',
        description=(
            'planetmapper_tpu_torch: the PyTorch/CUDA package for '
            'visualising, navigating and mapping Solar System observations. '
            'Run with no arguments to launch the graphical interface.'
        ),
    )
    parser.add_argument(
        'file_path',
        nargs='?',
        default=None,
        help='open the GUI with this FITS/image file loaded',
    )
    parser.add_argument(
        '-v', '--version',
        action='version',
        version=f'planetmapper_tpu_torch {common.__version__}',
        help='print the version number and exit',
    )
    parser.add_argument(
        '--precision',
        choices=('mixed', 'double'),
        default=None,
        help='numeric mode for the fused backplane pipeline',
    )
    parser.add_argument(
        '--prewarm',
        nargs='*',
        metavar='SIZE',
        default=None,
        help=(
            'build the CUDA kernel libraries into the build directory and '
            'run the backplane kernel and the map reprojection once on the '
            'card for each image size (default: 512 1024 2048), then exit. '
            'Later sessions load the built libraries instead of running '
            'nvcc. Needs a CUDA device. Combine with --target/--observer.'
        ),
    )
    parser.add_argument(
        '--target',
        default='JUPITER',
        help='target body for --prewarm',
    )
    parser.add_argument(
        '--observer',
        default='EARTH',
        help='observer body for --prewarm',
    )
    options = parser.parse_args(args)

    if options.precision is not None:
        from . import pipeline

        pipeline.DEFAULT_PRECISION = options.precision

    if options.prewarm is not None:
        sizes = [int(s) for s in options.prewarm] or [512, 1024, 2048]
        _prewarm(options.target, options.observer, sizes)
        return

    print(f'Launching planetmapper_tpu_torch {common.__version__}', flush=True)
    from . import gui

    gui._run_gui_from_cli(options.file_path)


def _prewarm(target: str, observer: str, sizes: list[int], *,
             device=None) -> None:
    """
    Cold-start prewarm on the card: build (or load) the kernel libraries
    of the main path, then for each image size run ``compute_backplanes``
    (the backplane kernel) and a cubic ``map_img`` at 1 degree (the map
    spline kernel), synchronised, printing each step's time. Raises
    without a CUDA device. ``device`` is for tests (``'cpu'`` runs the
    plain versions); the CLI never passes it. :meta private:
    """
    import datetime
    import time

    import numpy as np
    import torch

    from . import BodyXY
    from ._device import resolve_device
    from .ops import cuda_build
    from .pipeline import compute_backplanes

    device = resolve_device(device)

    def synchronise() -> None:
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    if device.type == 'cuda':
        from .ops import backplanes_kernel, map_infill_kernel
        from .ops import map_smooth_kernel, map_spline_kernel, pchip_kernel

        libraries = [backplanes_kernel.LIBRARY, map_infill_kernel.LIBRARY,
                     map_spline_kernel.LIBRARY, map_smooth_kernel.LIBRARY,
                     pchip_kernel.LIBRARY]
        t0 = time.time()
        cuda_build.build_all(libraries)
        print(
            f'prewarm: {len(libraries)} kernel libraries built or loaded in '
            f'{time.time() - t0:.3f}s',
            flush=True,
        )
    # Any epoch covered by the loaded kernels works
    utc = datetime.datetime(2005, 1, 1)
    for size in sizes:
        t0 = time.time()
        body = BodyXY(target, observer=observer, utc=utc, sz=size,
                      device=device)
        body.set_disc_params(size / 2, size / 2, size * 0.4, 0.0)
        compute_backplanes(body, as_numpy=False)
        synchronise()
        print(
            f'prewarm {target}/{observer} {size}x{size}: backplane kernel '
            f'ran in {time.time() - t0:.3f}s',
            flush=True,
        )
        t0 = time.time()
        img = np.zeros((size, size))
        body.map_img(img, interpolation='cubic', degree_interval=1)
        synchronise()
        print(
            f'prewarm {size}x{size}: map reprojection ran in '
            f'{time.time() - t0:.3f}s',
            flush=True,
        )
    print(f'kernel build directory: {cuda_build.BUILD_DIR}', flush=True)
