"""
planetmapper_tpu_torch: the PyTorch/CUDA port of planetmapper_tpu.

This package mirrors ``planetmapper_tpu`` module for module. Each
:class:`BodyXY` carries the device it runs on: ``cuda`` by default (it
raises without a card), the CPU only when built with ``device='cpu'``.
The per-pixel backplane pipeline and the map reprojection run there, as
hand-written CUDA kernels on an NVIDIA GPU (``csrc/*.cu``) or as their
plain PyTorch versions on the CPU. Scene geometry (ephemerides, frames,
light-time loops) is float64 PyTorch code routed by one rule
(``_device.call_device``): a call with an argument of more than 4096
elements - a frame's pixel rays, a map's samples - runs on its inputs'
device, so a card body's per-plane images and maps stay on the card;
smaller calls (the scalar API, the scene constants, the anchors) run on
CPU tensors.

Ported so far: ``Body`` (point transforms, per-point physics, limb and
terminator curves, other bodies, rings, grids, wireframe plots),
``BodyXY`` (disc parameters, the pixel transforms, the backplane registry
with the 26 per-plane image and map getters, the fused 26-backplane
pipeline, the map coordinates, ``map_img``, the plots and the wireframe
overlays), ``BasicBody``, ``Observation`` (FITS and image input, disc
fitting on the body's device, ``save_observation`` and
``save_mapped_observation`` with their WIREFRAME HDU), the FITS/WCS
readers and writer (:mod:`.io`), :mod:`.utils`, the kernel-path functions,
:mod:`.pipeline`, :mod:`.parallel`, the SPICE kernels of SPK types 2, 3,
5, 9, 10 (SGP4), 13 and 17, the command line (``python -m
planetmapper_tpu_torch``, :mod:`.cli`), the GUI (:func:`run_gui`,
:mod:`.gui`) and :mod:`.kernel_downloader`. matplotlib and tkinter are
imported only by the functions that draw or open a window.
"""

from __future__ import annotations

from . import pipeline
from .base import BodyBase, SpiceBase
from .basic_body import BasicBody
from .body import (
    DEFAULT_WIREFRAME_FORMATTING,
    AngularCoordinateKwargs,
    Body,
    LonLatGridKwargs,
    WireframeComponent,
    WireframeKwargs,
)
from .body_xy import Backplane, BackplaneNotFoundError, BodyXY, MapKwargs
from .common import (
    CITATION_BIBTEX,
    CITATION_DOI,
    CITATION_STRING,
    __version__,
)
from .kernels.pool import (
    clear_kernels,
    get_kernel_path,
    load_kernels,
    prevent_kernel_loading,
    set_kernel_path,
    sort_kernel_paths,
)
from .observation import Observation

__all__ = [
    'run_gui',
    'set_kernel_path',
    'get_kernel_path',
    'load_kernels',
    'clear_kernels',
    'prevent_kernel_loading',
    'sort_kernel_paths',
    'SpiceBase',
    'BodyBase',
    'Body',
    'Backplane',
    'BackplaneNotFoundError',
    'BodyXY',
    'BasicBody',
    'Observation',
    'AngularCoordinateKwargs',
    'WireframeKwargs',
    'WireframeComponent',
    'DEFAULT_WIREFRAME_FORMATTING',
    'LonLatGridKwargs',
    'MapKwargs',
    'base',
    'gui',
    'utils',
    'kernel_downloader',
    'data_loader',
    'pipeline',
    'CITATION_STRING',
    'CITATION_DOI',
    'CITATION_BIBTEX',
    '__version__',
]

#: The ported submodules, imported on first access (as in the JAX package)
_SUBMODULES = {
    'base', 'body', 'basic_body', 'body_xy', 'progress', 'data_loader',
    'common', 'exceptions', 'pipeline', 'core', 'kernels', 'ops', 'testing',
    'observation', 'utils', 'io', 'parallel', 'kernel_downloader', 'cli',
}


def __getattr__(name: str):
    # The GUI module loads tkinter and matplotlib only when a window is
    # built; without tkinter, using it raises an informative error (the
    # reference's mock-module pattern)
    if name in ('gui', 'run_gui'):
        import importlib

        try:
            gui = importlib.import_module('.gui', __name__)
        except ImportError as e:
            from ._mock_gui_no_tk import get_mocks as _get_mocks

            gui_mock, run_gui_mock = _get_mocks(e)
            return gui_mock if name == 'gui' else run_gui_mock
        return gui if name == 'gui' else gui.run_gui
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f'.{name}', __name__)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
