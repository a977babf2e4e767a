"""
The NaN infill of the spline map modes (``csrc/map_infill.cu``), its
wrapper and its plain PyTorch version.

The port's own kernel for what the JAX package computes in XLA in front of
its spline solve (``planetmapper_tpu/ops/interp_device.py:
_infill_device``); the source note in the ``.cu`` file says what bounds it
and how it is laid out.

:func:`map_infill` takes a float64 frame ``(ny, nx)`` or cube ``(nz, ny,
nx)`` and returns ``(cleaned, nans, finite)``: the grid the collocation
solve takes (:func:`infill_plain`'s rule on every frame; a frame with no
non-finite cell passes through), ``isnan`` of the input, and each frame's
int32 count of finite cells. It
launches the kernel once for CUDA tensors, whatever the frame count, reads
nothing back to the host, and counts the launch; a build or launch fault
raises. Only CPU tensors take :func:`map_infill_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaLibrary, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _configure(lib) -> None:
    lib.map_infill_launch.restype = _I
    lib.map_infill_launch.argtypes = [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P]
    lib.map_infill_workspace_bytes.restype = _L
    lib.map_infill_workspace_bytes.argtypes = [_I, _L]
    lib.map_infill_occupancy.restype = _I
    lib.map_infill_occupancy.argtypes = [ctypes.POINTER(_I)] * 3


# -fmad=false: the kernel rounds as the plain version does
LIBRARY = CudaLibrary('map_infill', 'map_infill.cu', _configure,
                      flags=('-fmad=false',))
load_library = LIBRARY.load
launch_count = LIBRARY.launch_count
reset_launch_count = LIBRARY.reset_launch_count
ptxas_log = LIBRARY.ptxas_log


def occupancy() -> dict[str, tuple[int, int]]:
    """``dict(registers, local_bytes, blocks_per_sm)`` of the stencil and
    the selection kernels (in that order) on the current CUDA device."""
    lib = load_library()
    values = [(_I * 2)() for _ in range(3)]
    check_launch(lib.map_infill_occupancy(*values), 'map infill occupancy')
    return dict(zip(('registers', 'local_bytes', 'blocks_per_sm'),
                    (tuple(v) for v in values)))


def infill_plain(frame: torch.Tensor):
    """
    The reference's NaN infill (body_xy.py:1871-1904, :func:`..interp.
    replace_nans_with_interpolated_values`) of one frame: non-finite cells
    with a finite cell in their clipped 3x3 neighbourhood take the
    neighbourhood mean; the others take the frame's median of finite
    values (0 if it has none). Returns ``(cleaned, nan_grid)``; the
    propagation grid is ``isnan`` (infinities are infilled for the solve
    but not propagated, reference body_xy.py:1668).
    """
    finite = torch.isfinite(frame)
    values = torch.sort(frame[finite]).values
    n = values.numel()
    if n:
        # the mean of the two middle values, as np.nanmedian (torch's
        # nanmedian returns the lower one)
        med = (values[(n - 1) // 2] + values[n // 2]) / 2
    else:
        med = torch.zeros((), dtype=frame.dtype, device=frame.device)
    z = torch.nn.functional.pad(torch.where(finite, frame, 0.0), (1, 1, 1, 1))
    g = torch.nn.functional.pad(finite.to(frame.dtype), (1, 1, 1, 1))
    ny, nx = frame.shape
    s = torch.zeros_like(frame)
    cnt = torch.zeros_like(frame)
    for dy in range(3):
        for dx in range(3):
            s = s + z[dy:dy + ny, dx:dx + nx]
            cnt = cnt + g[dy:dy + ny, dx:dx + nx]
    nb_mean = s / torch.where(cnt > 0, cnt, 1.0)
    cleaned = torch.where(
        finite, frame, torch.where(cnt > 0, nb_mean, med)
    )
    return cleaned, torch.isnan(frame)


def map_infill_plain(frames: torch.Tensor):
    """The kernel's function in plain PyTorch (see :func:`map_infill`):
    :func:`infill_plain` on each frame that has a non-finite cell."""
    cube = frames.reshape((-1,) + frames.shape[-2:])
    n_frames = cube.shape[0]
    finite = torch.isfinite(cube).reshape(n_frames, -1).sum(
        dim=1, dtype=torch.int32)
    nans = torch.isnan(frames)
    cleaned = frames
    cells = cube.shape[-2] * cube.shape[-1]
    partial = (finite < cells).nonzero().flatten().tolist()
    if partial:
        cleaned = cube.clone()
        for i in partial:
            cleaned[i] = infill_plain(cube[i])[0]
        cleaned = cleaned.reshape(frames.shape)
    return cleaned, nans, finite.reshape(frames.shape[:-2])


def _check(frames: torch.Tensor) -> None:
    if frames.dtype != torch.float64 or frames.ndim not in (2, 3):
        raise TypeError('frames must be (ny, nx) or (nz, ny, nx) float64, '
                        f'got {tuple(frames.shape)} {frames.dtype}')
    if frames.shape[-2] * frames.shape[-1] >= 2**31:
        raise ValueError('a frame of 2^31 or more cells')


def map_infill(frames: torch.Tensor):
    """
    ``(cleaned, nans, finite)`` of a float64 frame or cube (see the
    module's note): ``cleaned`` float64 and ``nans`` bool shaped like
    ``frames``; ``finite`` int32, one a frame (shape
    ``frames.shape[:-2]``).
    """
    _check(frames)
    device = frames.device
    if device.type == 'cpu':
        return map_infill_plain(frames)
    if device.type != 'cuda':
        raise ValueError(f'no map infill kernel for device {device}')
    frames = frames.contiguous()
    cleaned = torch.empty_like(frames)
    nans = torch.empty(frames.shape, dtype=torch.bool, device=device)
    finite = torch.empty(frames.shape[:-2], dtype=torch.int32, device=device)
    launch(frames, cleaned, nans, finite)
    return cleaned, nans, finite


def launch(frames, cleaned, nans, finite) -> None:
    """
    Launch the kernel on contiguous CUDA buffers as :func:`map_infill`
    makes them, with its workspace, on the current stream, and count the
    launch.
    """
    buffers = (frames, cleaned, nans, finite)
    if any(t.device.type != 'cuda' or not t.is_contiguous() for t in buffers):
        raise ValueError('the map infill kernel takes contiguous CUDA tensors')
    ny, nx = frames.shape[-2:]
    n_frames = frames.shape[0] if frames.ndim == 3 else 1
    if cleaned.shape != frames.shape or nans.shape != frames.shape or \
            finite.numel() != n_frames:
        raise ValueError('the outputs do not fit the frames')
    if cleaned.dtype != torch.float64 or nans.dtype != torch.bool or \
            finite.dtype != torch.int32:
        raise TypeError('cleaned must be float64, nans bool and finite int32')
    lib = load_library()
    workspace = torch.empty(
        lib.map_infill_workspace_bytes(n_frames, ny * nx),
        dtype=torch.uint8, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.map_infill_launch(
            frames.data_ptr(), cleaned.data_ptr(), nans.data_ptr(),
            finite.data_ptr(), workspace.data_ptr(),
            workspace.numel(), n_frames, ny, nx, stream,
        )
    check_launch(rc, 'map infill')
    LIBRARY.count_launches()
