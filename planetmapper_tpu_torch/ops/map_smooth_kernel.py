"""
The smooth-mode sampler (``csrc/map_smooth.cu``), its wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``planetmapper_tpu/ops/smooth_pallas.py:
_smooth_eval_fn`` with a hand-written kernel for Hopper; the source note in
the ``.cu`` file says what bounds it and how it is laid out.

:func:`map_smooth` samples the PCHIP-oversampled grids ``(F, n_ys, n_xs)``
bilinearly at the map samples, with scipy's RegularGridInterpolator NaN
rule on that grid and, with ``propagate_nan``, the 4-neighbour rule on the
original image. It launches the kernel for CUDA tensors and counts the
launch; a build or launch fault raises. Only CPU tensors take
:func:`map_smooth_plain`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import CudaLibrary, check_launch
from .map_spline_kernel import _aligned, neighbour_nan, outside_grid

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def _configure(lib) -> None:
    lib.map_smooth_occupancy.restype = _I
    lib.map_smooth_occupancy.argtypes = [_P, _P, _P]
    lib.map_smooth_launch.restype = _I
    lib.map_smooth_launch.argtypes = [
        _P, _P, _P, _P, _I, _I, _D, _D, _D, _D, _P, _P, _I, _I, _I, _P,
        ctypes.c_longlong, _I, _P,
    ]


LIBRARY = CudaLibrary('map_smooth', 'map_smooth.cu', _configure)
load_library = LIBRARY.load
launch_count = LIBRARY.launch_count
reset_launch_count = LIBRARY.reset_launch_count
ptxas_log = LIBRARY.ptxas_log


def occupancy() -> dict[str, int]:
    """Registers and local bytes per thread, resident blocks of 256 per SM."""
    lib = load_library()
    values = [ctypes.c_int() for _ in range(3)]
    check_launch(lib.map_smooth_occupancy(*map(ctypes.byref, values)),
                 'map smooth occupancy')
    return dict(zip(('registers', 'local_bytes', 'blocks_per_sm'),
                    (v.value for v in values)))


def map_smooth_plain(x, y, valid, grid, nan_img, *, iy0: float, ix0: float,
                     y_step: float, x_step: float,
                     propagate_nan: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch (float64, stored float32)."""
    n_frames, n_ys, n_xs = grid.shape
    yb = (y - iy0) / y_step
    xb = (x - ix0) / x_step
    inside = (yb >= 0.0) & (yb <= n_ys - 1) & (xb >= 0.0) & (xb <= n_xs - 1)
    dead = ~(valid.bool() & inside)
    if propagate_nan:
        ny, nx = nan_img.shape[-2:]
        dead = dead | outside_grid(x, y, ny, nx)
        dead = dead[None] | neighbour_nan(x, y, nan_img)
    iy = torch.floor(yb).clamp(0, n_ys - 2)
    ix = torch.floor(xb).clamp(0, n_xs - 2)
    fy = yb - iy
    fx = xb - ix
    corner = iy.long() * n_xs + ix.long()
    flat = grid.reshape(n_frames, -1)
    g00 = flat[:, corner]
    g01 = flat[:, corner + 1]
    g10 = flat[:, corner + n_xs]
    g11 = flat[:, corner + n_xs + 1]
    val = (1.0 - fx) * ((1.0 - fy) * g00 + fy * g10) + fx * (
        (1.0 - fy) * g01 + fy * g11
    )
    dead = dead | torch.isnan(val)  # any NaN corner, whatever its weight
    return torch.where(dead, torch.nan, val).to(torch.float32)


def map_smooth(x, y, valid, grid, nan_img, *, iy0: float, ix0: float,
               y_step: float, x_step: float,
               propagate_nan: bool) -> torch.Tensor:
    """
    ``(F, S)`` float32 bilinear samples of each oversampled ``grid``
    (float64, NaN included) at the map samples ``x``, ``y`` (float64, 0
    where ``valid`` is false) given in original-image pixels: sample
    coordinate ``(y - iy0) / y_step`` on the grid's rows, likewise for x.
    ``nan_img`` (F, ny, nx) is the original image's NaN grid.
    """
    device = x.device
    for name, t in dict(y=y, valid=valid, grid=grid, nan_img=nan_img).items():
        if t.device != device:
            raise ValueError(f'{name} is on {t.device}, x on {device}')
    for name, t in dict(x=x, y=y, grid=grid).items():
        if t.dtype != torch.float64:
            raise TypeError(f'{name} must be float64, got {t.dtype}')
    if x.ndim != 1 or y.shape != x.shape or valid.shape != x.shape:
        raise ValueError('x, y and valid must be 1-D of one length')
    if grid.ndim != 3 or min(grid.shape[1:]) < 2:
        raise ValueError(f'grid must be (F, >=2, >=2), got {tuple(grid.shape)}')
    if nan_img.ndim != 3 or nan_img.shape[0] != grid.shape[0]:
        raise ValueError('nan_img must be (F, ny, nx) with F as grid')
    kw = dict(iy0=float(iy0), ix0=float(ix0), y_step=float(y_step),
              x_step=float(x_step))
    if device.type == 'cpu':
        return map_smooth_plain(x, y, valid, grid, nan_img,
                                propagate_nan=propagate_nan, **kw)
    if device.type != 'cuda':
        raise ValueError(f'no map smooth kernel for device {device}')
    out = torch.empty((grid.shape[0], x.shape[0]), dtype=torch.float32,
                      device=device)
    nan_u8 = nan_img.to(torch.uint8).contiguous()
    launch(
        _aligned(x), _aligned(y), valid.to(torch.uint8).contiguous(),
        grid.contiguous(), nan_u8,
        nan_u8.reshape(nan_u8.shape[0], -1).any(dim=1).to(torch.uint8),
        out, propagate_nan=propagate_nan, **kw,
    )
    return out


def launch(x, y, valid, grid, nan_img, any_nan, out, *, iy0: float,
           ix0: float, y_step: float, x_step: float,
           propagate_nan: bool) -> None:
    """
    Launch the kernel on prepared contiguous CUDA buffers (``x``, ``y``
    16-byte aligned, ``valid``, ``nan_img`` and the per-frame ``any_nan`` as
    uint8, ``out`` (F, S) float32; each frame of ``grid`` and ``nan_img``
    below 2^31 values) on the current stream, and count the launch.
    """
    frame = max(math.prod(grid.shape[1:]), math.prod(nan_img.shape[1:]))
    if frame >= 2**31:  # the kernel's offsets in a frame are 32-bit
        raise ValueError('a grid or an image of 2^31 values or more')
    buffers = (x, y, valid, grid, nan_img, any_nan, out)
    if any(t.device.type != 'cuda' or not t.is_contiguous() for t in buffers):
        raise ValueError('the map smooth kernel takes contiguous CUDA tensors')
    if any(t.dtype != torch.uint8 for t in (valid, nan_img, any_nan)):
        raise TypeError('valid, nan_img and any_nan must be uint8')
    n_frames, n_samples = out.shape
    if out.dtype != torch.float32 or n_samples != x.shape[0]:
        raise ValueError('out must be (F, S) float32')
    if x.data_ptr() % 16 or y.data_ptr() % 16 or out.data_ptr() % 8:
        raise ValueError('x and y must be 16-byte aligned, out 8-byte')
    if n_frames * n_samples == 0:
        return
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.map_smooth_launch(
            x.data_ptr(), y.data_ptr(), valid.data_ptr(), grid.data_ptr(),
            grid.shape[1], grid.shape[2], iy0, ix0, y_step, x_step,
            nan_img.data_ptr(), any_nan.data_ptr(), nan_img.shape[-2],
            nan_img.shape[-1], int(propagate_nan), out.data_ptr(), n_samples,
            n_frames, stream,
        )
    check_launch(rc, 'map smooth')
    LIBRARY.count_launches()
