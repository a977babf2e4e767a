"""
The double-single kernels (``csrc/dsk.cu``), their wrappers and their plain
PyTorch versions.

Replaces the TPU kernels of the JAX package's ``ops/dsk.py`` tests,
``tests/test_pallas_core.py`` ``TestDskOnTpu._run_pairs`` (``:538``) and
``test_atan2_f32_grade`` (``:596``), with hand-written kernels for Hopper;
the source note in the ``.cu`` file says what bounds them.

- :func:`pairs` computes one ds operation of :data:`OPS` elementwise on
  two (hi, lo) float32 pairs: ``'mul'`` :func:`.dsk.mul`, ``'div'``
  :func:`.dsk.div`, ``'hypot'`` ``dsk.sqrt(dsk.add(dsk.sqr(a),
  dsk.sqr(b)))`` and ``'atan2_ds'`` :func:`.dsk.atan2_ds` (``a`` the y
  pair, ``b`` the x pair), as the JAX tests compose them.
- :func:`atan2` computes the float32 :func:`.dsk.atan2`.

On CUDA tensors each launches its kernel once and counts the launch; a
build or launch fault raises. Only CPU tensors take the plain versions
(:func:`pairs_plain`, :func:`atan2_plain`). The kernel computes
``'atan2_ds'`` in native float64 (:func:`atan2_ds_native` transcribes it);
its plain version stays the double-single chain of :func:`.dsk.atan2_ds`,
which the kernel meets within 1e-12 rad. The other ops equal their plain
versions bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from . import dsk
from .cuda_build import CudaLibrary, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: The ops of ``dsk_pairs``, in the order of the kernel's ``Op`` enum
OPS = ('mul', 'div', 'hypot', 'atan2_ds')

#: The kernels of the library, each with its launch count
KERNELS = ('dsk_pairs', 'dsk_atan2')


def _configure(lib) -> None:
    lib.dsk_pairs_launch.restype = _I
    lib.dsk_pairs_launch.argtypes = [_I, _P, _P, _P, _P, _P, _P, _L, _P]
    lib.dsk_atan2_launch.restype = _I
    lib.dsk_atan2_launch.argtypes = [_P, _P, _P, _L, _P]


# -fmad=false: the kernels round each product as the plain versions do
LIBRARY = CudaLibrary('dsk', 'dsk.cu', _configure, flags=('-fmad=false',))
load_library = LIBRARY.load
ptxas_log = LIBRARY.ptxas_log
#: the launch counter of each kernel (the library holds two, so its own
#: counter stays unused)
COUNTERS = {kernel: f'{LIBRARY.counter}.{kernel}' for kernel in KERNELS}


def launch_count(kernel: str) -> int:
    """Launches of ``kernel`` (one of :data:`KERNELS`) so far in this
    process (plain-version calls excluded)."""
    return tracing.counts().get(COUNTERS[kernel], 0)


def reset_launch_count() -> None:
    tracing.reset(*COUNTERS.values())


def _count(kernel: str) -> None:
    tracing.count(COUNTERS[kernel])


def pairs_plain(op: str, a, b):
    """The function of ``dsk_pairs<op>`` in plain PyTorch (:mod:`.dsk`)."""
    if op == 'mul':
        return dsk.mul(a, b)
    if op == 'div':
        return dsk.div(a, b)
    if op == 'hypot':
        return dsk.sqrt(dsk.add(dsk.sqr(a), dsk.sqr(b)))
    if op == 'atan2_ds':
        return dsk.atan2_ds(a, b)
    raise ValueError(f'op must be one of {OPS}, got {op!r}')


def atan2_ds_native(y, x):
    """
    ``dsk_pairs<atan2_ds>`` as the kernel computes it, in plain PyTorch: each
    pair added exactly in float64, a zero of either sign taken as +0 (the
    port's convention: ``atan2(-0, -1) = pi``), one float64 atan2, the
    result split into a (hi, lo) float32 pair. The CPU tests hold it to
    the plain version and to float64 numpy, and the card tests and
    ``chip_smoke.py`` hold the kernel to it; no route of the port calls it.
    """
    y64, x64 = (p[0].double() + p[1].double() for p in (y, x))
    y64 = torch.where(y64 == 0, 0.0, y64)
    x64 = torch.where(x64 == 0, 0.0, x64)
    r = torch.atan2(y64, x64)
    hi = r.float()
    return hi, (r - hi.double()).float()


def atan2_plain(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The function of ``dsk_atan2`` in plain PyTorch (:func:`.dsk.atan2`)."""
    return dsk.atan2(y, x)


def _check(*tensors: torch.Tensor) -> None:
    shape, device = tensors[0].shape, tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'the dsk kernels take float32, got {t.dtype}')
        if t.shape != shape or t.device != device:
            raise ValueError(
                'the dsk kernels take tensors of one shape on one device, '
                f'got {tuple(t.shape)} on {t.device} and {tuple(shape)} on '
                f'{device}'
            )
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no dsk kernel for device {device}')


def pairs(op: str, a, b):
    """
    ``dsk_pairs<op>`` on the pairs ``a = (hi, lo)`` and ``b`` (float32, one
    shape): the (hi, lo) result, float32 of that shape.
    """
    if op not in OPS:
        raise ValueError(f'op must be one of {OPS}, got {op!r}')
    _check(*a, *b)
    if a[0].device.type == 'cpu':
        return pairs_plain(op, a, b)
    ins = [t.contiguous() for t in (*a, *b)]
    out = (torch.empty_like(ins[0]), torch.empty_like(ins[0]))
    if ins[0].numel():
        launch_pairs(op, *ins, *out)
    return out


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dsk_atan2`` on ``y`` and ``x`` (float32, one shape)."""
    _check(y, x)
    if y.device.type == 'cpu':
        return atan2_plain(y, x)
    y, x = y.contiguous(), x.contiguous()
    out = torch.empty_like(y)
    if y.numel():
        launch_atan2(y, x, out)
    return out


def _launch_check(tensors) -> None:
    for t in tensors:
        if t.device.type != 'cuda' or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.numel() != tensors[0].numel():
            raise ValueError('the dsk kernels take contiguous float32 CUDA '
                             'tensors of one size')


def launch_pairs(op: str, ah, al, bh, bl, oh, ol) -> None:
    """Launch ``dsk_pairs<op>`` on contiguous float32 CUDA buffers of one
    size on the current stream, and count the launch."""
    tensors = (ah, al, bh, bl, oh, ol)
    _launch_check(tensors)
    lib = load_library()
    with torch.cuda.device(oh.device):
        stream = torch.cuda.current_stream(oh.device).cuda_stream
        rc = lib.dsk_pairs_launch(OPS.index(op),
                                  *(t.data_ptr() for t in tensors),
                                  oh.numel(), stream)
    check_launch(rc, f'dsk_pairs<{op}>')
    _count('dsk_pairs')


def launch_atan2(y, x, out) -> None:
    """Launch ``dsk_atan2`` on contiguous float32 CUDA buffers of one size
    on the current stream, and count the launch."""
    _launch_check((y, x, out))
    lib = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.dsk_atan2_launch(y.data_ptr(), x.data_ptr(), out.data_ptr(),
                                  out.numel(), stream)
    check_launch(rc, 'dsk_atan2')
    _count('dsk_atan2')
