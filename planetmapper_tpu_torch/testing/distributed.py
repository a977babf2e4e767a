"""
A worker of a process group for the tests of :mod:`..parallel.multihost`:
each process computes its block of a time series on a process-spanning
mesh, and rank 0 writes the gathered cube. It imports nothing of JAX, so
a spawned process starts light.
"""

from __future__ import annotations

import numpy as np


def time_series_worker(rank: int, world_size: int, init_method: str,
                       kernel_path: str, body_kwargs: dict, disc,
                       times, names, out_path: str) -> None:
    """
    Join the gloo process group at ``init_method`` as ``rank``, build a CPU
    BodyXY (``body_kwargs``, ``disc``) on the SPICE kernels at
    ``kernel_path``, compute :func:`..parallel.backplane_time_series` of
    ``times`` over :func:`..parallel.make_multihost_mesh`, and (rank 0)
    save the planes to ``out_path`` with ``np.savez``.
    """
    import torch.distributed as dist

    import planetmapper_tpu_torch as pt
    from planetmapper_tpu_torch.parallel import (
        backplane_time_series,
        frame_sharding,
        initialize_distributed,
        make_multihost_mesh,
    )

    initialize_distributed(init_method, world_size, rank, backend='gloo')
    try:
        pt.set_kernel_path(kernel_path)
        body = pt.BodyXY(**body_kwargs, device='cpu')
        body.set_disc_params(*disc)
        mesh = make_multihost_mesh(device='cpu')
        if mesh.shape != {'frames': world_size, 'px': 1}:
            raise RuntimeError(f'unexpected mesh {mesh}')
        out = backplane_time_series(body, times, names=names,
                                    mesh=frame_sharding(mesh))
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
