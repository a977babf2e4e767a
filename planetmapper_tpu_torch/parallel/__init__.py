"""
Parallel and batched execution: device meshes, row-sharded backplanes and
maps, gradient disc fitting, time series through the batched backplane
kernel, and several processes on ``torch.distributed`` (port of
``planetmapper_tpu.parallel``).
"""

from .fit import fit_disc_gradient, make_training_step
from .multihost import (
    frame_sharding,
    initialize_distributed,
    make_multihost_mesh,
    pixel_row_sharding,
)
from .sharding import make_mesh, sharded_backplanes, sharded_map_img
from .timeseries import backplane_time_series

__all__ = [
    'make_mesh',
    'sharded_backplanes',
    'sharded_map_img',
    'fit_disc_gradient',
    'make_training_step',
    'backplane_time_series',
    'initialize_distributed',
    'make_multihost_mesh',
    'frame_sharding',
    'pixel_row_sharding',
]
