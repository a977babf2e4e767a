"""
Several processes: initialisation, process-spanning meshes and placements
(port of ``planetmapper_tpu.parallel.multihost``, on ``torch.distributed``).

The geometry pipeline's parallel axes map onto hardware like this:

- **frames / ephemeris times** (JWST-cube style batches) split across
  processes: each frame is independent, so the only traffic is gathering
  the results (``all_gather``: gloo on CPU tensors, NCCL on cards);
- **pixel rows** split across each process's devices, which need no
  communication at all.

In one process everything below degrades to the local devices, so the same
code runs from a laptop to a cluster of GPU hosts.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .sharding import Mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> None:
    """
    Initialise ``torch.distributed`` (a no-op in one process, or when it is
    initialised already).

    With no arguments the configuration comes from the environment that
    ``torchrun`` sets: ``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``. ``coordinator_address`` (``host:port``, or an init-method
    URL such as ``tcp://...`` or ``file://...``), ``num_processes`` and
    ``process_id`` override them. The backend is NCCL when CUDA is
    available, gloo otherwise, unless ``backend`` names one.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get('WORLD_SIZE', '1'))
    if process_id is None:
        process_id = int(os.environ.get('RANK', '0'))
    if coordinator_address is None and 'MASTER_ADDR' in os.environ:
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:"
            f"{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes <= 1:
        return
    if coordinator_address is None:
        raise ValueError(
            f'{num_processes} processes need a coordinator address '
            '(MASTER_ADDR and MASTER_PORT, or coordinator_address=)'
        )
    if '://' not in coordinator_address:
        coordinator_address = f'tcp://{coordinator_address}'
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(
            int(os.environ.get('LOCAL_RANK', process_id))
            % torch.cuda.device_count()
        )
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=num_processes, rank=process_id,
    )


def _process_count() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_multihost_mesh(
    axis_names: tuple[str, str] = ('frames', 'px'), *, device=None,
) -> Mesh:
    """
    A 2-D mesh with one row per process and, in each row, that process's
    devices (its CUDA devices; ``device='cpu'``: its CPU): frames or time
    batches split across processes, pixel rows across each process's
    devices. One process gets a ``1 x local devices`` mesh with the same
    axis names, so calling code is the same either way. In a process group
    on cards, each process takes the card ``torch.cuda.current_device()``
    names (:func:`initialize_distributed` sets it from ``LOCAL_RANK``).
    """
    from .._device import resolve_device

    device = resolve_device(device)
    n = _process_count()
    if device.type != 'cuda':
        local = [device]
    elif n > 1:
        local = [torch.device('cuda', torch.cuda.current_device())]
    else:
        local = [torch.device('cuda', i)
                 for i in range(torch.cuda.device_count())]
    return Mesh([local] * n, axis_names, processes=n)


@dataclass(frozen=True)
class NamedSharding:
    """
    A placement of an array's axes on a mesh's axes (the counterpart of
    ``jax.sharding.NamedSharding``): ``spec[i]`` names the mesh axis that
    splits the array's axis ``i``, or None.
    """

    mesh: Mesh
    spec: tuple


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """The leading (frame/time) axis on the mesh's first (process) axis."""
    return NamedSharding(mesh, (mesh.axis_names[0],))


def pixel_row_sharding(mesh: Mesh) -> NamedSharding:
    """Image rows on the mesh's second (per-process device) axis."""
    return NamedSharding(mesh, (None, mesh.axis_names[1]))
