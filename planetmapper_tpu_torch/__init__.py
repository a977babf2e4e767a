"""
planetmapper_tpu_torch: the PyTorch/CUDA port of planetmapper_tpu.

This package mirrors ``planetmapper_tpu`` module for module. Scene geometry
(SPICE kernels, ephemerides, frames, per-scene anchors) runs as float64
PyTorch code on CPU tensors; the per-pixel backplane pipeline and the map
reprojection run on the device chosen for each :class:`BodyXY` -
hand-written CUDA kernels on an NVIDIA GPU (``csrc/*.cu``), or their plain
PyTorch versions on CPU tensors.

Ported so far: ``Body``, ``BodyXY`` (disc parameters, the fused
26-backplane pipeline, the map coordinates and ``map_img``), the
kernel-path functions and :mod:`.pipeline`. The rest of the JAX package's
API is listed in ROADMAP.md.
"""

from __future__ import annotations

from . import pipeline
from .body import Body
from .body_xy import BodyXY
from .common import __version__
from .kernels.pool import (
    clear_kernels,
    get_kernel_path,
    load_kernels,
    prevent_kernel_loading,
    set_kernel_path,
)

__all__ = [
    'Body',
    'BodyXY',
    'set_kernel_path',
    'get_kernel_path',
    'load_kernels',
    'clear_kernels',
    'prevent_kernel_loading',
    'pipeline',
    '__version__',
]
