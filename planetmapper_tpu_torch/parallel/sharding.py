"""
Device meshes and row-sharded execution of the geometry pipelines (port of
``planetmapper_tpu.parallel.sharding``).

The reference's implicit parallel axes are pixels, map cells, cube
wavelengths and ephemeris times. Here they become blocks of work placed on
the entries of a :class:`Mesh`, a small grid of torch devices with named
axes (the counterpart of ``jax.sharding.Mesh``):

- ``px``: the pixel-row axis of backplane images. The geometry pass needs
  no communication: each entry runs the single-frame pipeline that
  :func:`..pipeline.select_pipeline_impl` selects (the CUDA kernel, or the
  plain float64 graph) on its block of rows through ``row0``.
- ``data`` / ``frames``: the frame or time axis of cubes and time series
  (:mod:`.timeseries`, :mod:`.fit`).

A mesh may list one device several times, as the JAX package's tests run
an 8-device mesh of views of one CPU: one card, or the CPU, then runs the
blocks in turn. Blocks on several cards run on each card's current stream
and are gathered onto the mesh's first device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class Mesh:
    """
    A grid of torch devices with named axes. ``devices`` is an object array
    of :class:`torch.device` (an entry may repeat), ``axis_names`` one name
    per axis, ``shape`` the size of each named axis. ``processes`` is the
    number of processes its first axis spans
    (:func:`.multihost.make_multihost_mesh`; 1 for a mesh of this process's
    devices), and row ``r`` of such a mesh holds process ``r``'s devices.
    """

    def __init__(self, devices, axis_names, processes: int = 1) -> None:
        arr = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        self.devices.reshape(-1)[:] = flat
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f'{len(self.axis_names)} axis names for a mesh of shape '
                f'{self.devices.shape}'
            )
        self.processes = int(processes)
        if self.processes > 1 and self.devices.shape[0] != self.processes:
            raise ValueError('the first axis of a multi-process mesh must '
                             'span its processes')

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def entries(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, the other axes at index 0."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        return (f'Mesh(shape={self.shape}, devices='
                f'{[str(d) for d in self.devices.reshape(-1)]}, '
                f'processes={self.processes})')


def make_mesh(n_devices: int | None = None, axis_names=('px',), *,
              device=None) -> Mesh:
    """
    A mesh over this host's CUDA devices (``device='cpu'``: the CPU), all
    on the first axis (any further axes of size 1). ``n_devices`` takes the
    first ``n_devices`` devices, repeating them in turn when it exceeds
    their count, so one card (or the CPU) can hold a mesh of several
    entries.
    """
    from .._device import resolve_device

    device = resolve_device(device)
    if device.type == 'cuda':
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f'a mesh needs at least one device, got {n}')
    chosen = [devices[i % len(devices)] for i in range(n)]
    shape = (n,) + (1,) * (len(axis_names) - 1)
    arr = np.empty(n, dtype=object)
    arr[:] = chosen
    return Mesh(arr.reshape(shape), axis_names)


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _gather(blocks: list[dict], device: torch.device, dim: int = 0) -> dict:
    """Each name's blocks concatenated along ``dim`` on ``device`` (a lone
    block as it is: a cube of 2048^2 frames is gigabytes)."""
    if len(blocks) == 1:
        return {k: v.to(device) for k, v in blocks[0].items()}
    return {
        k: torch.cat([b[k].to(device) for b in blocks], dim=dim)
        for k in blocks[0]
    }


class _Placement:
    """
    Blocks of (frames x rows) of a cube on the entries of a mesh:
    ``frames_axis`` and ``rows_axis`` name the mesh axes that split them
    (None: not split); entries along other axes are replicas and idle.
    """

    def __init__(self, mesh, frames_axis, rows_axis) -> None:
        for axis in (frames_axis, rows_axis):
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(f'{axis!r} is not an axis of {mesh}')
        if mesh.processes > 1 and frames_axis != mesh.axis_names[0]:
            raise ValueError('a multi-process mesh splits the frames over '
                             'its first (process) axis')
        self.mesh = mesh
        self.frames_axis = frames_axis
        self.rows_axis = rows_axis

    def _count(self, axis) -> int:
        return 1 if axis is None else self.mesh.shape[axis]

    def tasks(self, n_frames: int, ny: int, rank: int) -> list[tuple]:
        """``(device, frame block, row block, frames, row0, rows)`` of the
        blocks this process computes."""
        names = self.mesh.axis_names
        f_blk = -(-n_frames // self._count(self.frames_axis))
        r_blk = -(-ny // self._count(self.rows_axis))
        out = []
        for idx in np.ndindex(self.mesh.devices.shape):
            split = {names[k]: i for k, i in enumerate(idx)}
            fi = split.pop(self.frames_axis, 0)
            ri = split.pop(self.rows_axis, 0)
            if any(split.values()):
                continue  # a replica
            if self.mesh.processes > 1 and idx[0] != rank:
                continue
            f0, r0 = fi * f_blk, ri * r_blk
            f1, r1 = min(n_frames, f0 + f_blk), min(ny, r0 + r_blk)
            if f0 < f1 and r0 < r1:
                out.append((self.mesh.devices[idx], fi, ri, slice(f0, f1),
                            r0, r1 - r0))
        return out

    def compute(self, run, n_frames: int, ny: int, rank: int) -> dict:
        """Every block of this process through ``run(device, frames,
        row0, rows)``, assembled (and gathered across processes)."""
        tasks = self.tasks(n_frames, ny, rank)
        first = tasks[0][0]
        by_frames: dict[int, list] = {}
        for device, fi, ri, frames, row0, rows in tasks:
            by_frames.setdefault(fi, []).append(
                (ri, run(device, frames, row0, rows)))
        blocks = []
        for fi in sorted(by_frames):
            rows = [out for _, out in sorted(by_frames[fi],
                                             key=lambda t: t[0])]
            blocks.append(_gather(rows, first, dim=1))
        local = _gather(blocks, first)
        if self.mesh.processes == 1:
            return local
        import torch.distributed as dist

        on_card = dist.get_backend() == 'nccl'
        out = {}
        for k, v in local.items():
            v = v.contiguous() if on_card else v.cpu().contiguous()
            parts = [torch.empty_like(v) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, v)
            out[k] = torch.cat(parts).to(first)
        return out


def _placement(mesh, device) -> _Placement:
    """The placement of a cube's frames by ``mesh``: None (all on
    ``device``), a mesh (frames over its first axis) or a
    :class:`.multihost.NamedSharding` (frames and rows by its spec)."""
    from .multihost import NamedSharding

    if mesh is None:
        return _Placement(Mesh([device], ('frames',)), None, None)
    if isinstance(mesh, NamedSharding):
        spec = tuple(mesh.spec) + (None, None)
        return _Placement(mesh.mesh, spec[0], spec[1])
    return _Placement(mesh, mesh.axis_names[0], None)


def sharded_backplanes(body, mesh: Mesh | None = None, *, use_pallas=None,
                       interpret: bool = False,
                       trace_only: bool = False) -> dict[str, Any]:
    """
    All default backplanes with the pixel-row axis split across the mesh's
    first axis: entry ``i`` runs the pipeline that
    :func:`..pipeline.select_pipeline_impl` selects on rows ``[i * block,
    (i + 1) * block)`` (``block = ceil(ny / n)``; the last block is padded
    past the frame, as in the JAX package, and the padding trimmed), on its
    own device. Returns tensors on the mesh's first device.

    ``use_pallas``/``interpret`` are :func:`..pipeline.
    select_pipeline_impl`'s: ``None`` selects by the body's device,
    ``True`` forces the CUDA kernel, ``interpret=True`` takes the plain
    graph on any device. ``trace_only=True`` runs nothing and returns the
    padded ``(n * block, nx)`` outputs' shapes and dtypes as tensors on
    PyTorch's ``meta`` device (the JAX package's ``eval_shape``).
    """
    from .. import pipeline

    if mesh is None:
        mesh = make_mesh(device=body.device)
    axis = mesh.axis_names[0]
    entries = mesh.entries(axis)
    nx, ny = body.get_img_size()
    if nx <= 0 or ny <= 0:
        raise ValueError('nx and ny must be positive to generate backplanes')
    ny_blk = -(-ny // len(entries))
    ny_padded = ny_blk * len(entries)
    impl, use_pallas = pipeline.select_pipeline_impl(
        body, nx, ny_blk, use_pallas=use_pallas, interpret=interpret
    )
    xy2angular, disc, radii, anchors = pipeline.pipeline_inputs(body)

    def block(dev, row0=0.0):
        out = impl.frames(nx, ny_blk, xy2angular[None], disc[None], radii,
                          anchors, device=dev, row0=row0)
        return {k: v[0] for k, v in out.items()}

    if trace_only:
        if use_pallas:
            from ..ops.backplanes_kernel import PLANE_ORDER

            dtypes = {name: torch.float64 if name == 'RADIAL-VELOCITY'
                      else torch.float32 for name in PLANE_ORDER}
        else:
            dtypes = {k: v.dtype for k, v in block('meta').items()}
        return {k: torch.empty((ny_padded, nx), dtype=dtype, device='meta')
                for k, dtype in dtypes.items()}
    blocks = [block(dev, float(i * ny_blk)) for i, dev in enumerate(entries)]
    out = _gather(blocks, entries[0])
    if ny_padded != ny:
        out = {k: v[:ny] for k, v in out.items()}
    return out


def sharded_map_img(
    body, img, mesh: Mesh | None = None, *, interpolation='linear',
    propagate_nan: bool = True, warn_nan: bool = False,
    as_numpy: bool = True, **map_kwargs,
):
    """
    Map-project an image with the MAP ROW axis split across the mesh's
    first axis: each entry solves the (small, replicated) spline
    coefficient system of the frame on its device and evaluates its block
    of map rows with the ``map_spline`` kernel (on CPU tensors its plain
    version), with no communication; the map's rows are padded with NaN
    samples to a multiple of the entries, as in the JAX package. Equals
    :meth:`BodyXY.map_img` for the spline interpolation modes
    (``'linear'``/``'quadratic'``/``'cubic'``, an int or an ``(order_y,
    order_x)`` tuple). Returns a float64 numpy array (``as_numpy``), else
    the float32 map on the mesh's first device.
    """
    from ..ops import interp_device as idev

    aliases = {'linear': 1, 'quadratic': 2, 'cubic': 3}
    if isinstance(interpolation, str):
        if interpolation not in aliases:
            raise ValueError(
                f'sharded_map_img takes the spline modes, not '
                f'{interpolation!r}'
            )
        interpolation = aliases[interpolation]
    if mesh is None:
        mesh = make_mesh(device=body.device)
    entries = mesh.entries(mesh.axis_names[0])
    n_shard = len(entries)

    xy = body._xy_map(**map_kwargs)
    my, mx = xy.shape[:2]
    my_pad = _pad_to_multiple(my, n_shard)
    if my_pad != my:
        fill = torch.full((my_pad - my, mx, 2), torch.nan,
                          dtype=xy.dtype, device=xy.device)
        xy = torch.cat([xy, fill])
    my_blk = my_pad // n_shard

    img = torch.as_tensor(np.asarray(img) if not isinstance(
        img, torch.Tensor) else img)
    if img.shape != (body._ny, body._nx):
        raise ValueError(
            f'The input `img` shape {tuple(img.shape)!r} is inconsistent '
            f"with the body's image size (ny={body._ny}, nx={body._nx})"
        )
    blocks = []
    for i, dev in enumerate(entries):
        rows = xy[i * my_blk:(i + 1) * my_blk]
        samples = idev._device_xy(rows[..., 0], rows[..., 1], dev)
        blocks.append({'map': idev.spline_interpolation_device(
            img.to(dev, torch.float64), samples,
            # the frame's NaN warning once, not once per block
            interpolation=interpolation, warn_nan=warn_nan and i == 0,
            propagate_nan=propagate_nan, spline_smoothing=0,
        )})
    out = _gather(blocks, entries[0])['map'][:my]
    if as_numpy:
        return out.cpu().numpy().astype(np.float64)
    return out
