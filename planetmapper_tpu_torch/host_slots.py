"""
Page-locked host memory reused by the copies between the host and the card:
two "slots" for the planes that :func:`.pipeline.compute_backplanes` copies
off the card, and a ring of chunks through which :func:`upload` copies a
host array onto it. The two share :func:`_pin`, not their sizes.

Slots:

A copy into page-locked memory runs at the link's DMA rate and touches no
fresh host page; a ``.cpu()`` copy into pageable memory is staged by the
driver and lands in pages the host allocator hands out anew. A slot is
allocated on first use, at the size one call's planes take, and reused by
later calls of that size.

- A slot is lent out only while no array from its last loan survives. Each
  loan is a :class:`Lease`, at the end of the chain of numpy bases of
  every array cut from it and of every view of those arrays, and the slot
  keeps only a weak reference to it: the slot is free exactly when the caller holds nothing of it, as
  the reference counts of the arrays say, whatever the caller does.
- At most :data:`MAX_SLOTS` slots exist. Asking for a new size drops the
  free slots of another size; where every slot is lent out, :meth:`take`
  returns None and the caller copies as before. Two is what a loop over
  frames needs: it holds the last frame's planes until the next frame's
  have come.
- A lock guards the choice, as the GUI computes in threads.

The upload ring (:class:`UploadRing`, used by :func:`upload`):

- :data:`RING_CHUNKS` chunks of :data:`CHUNK_BYTES`, pinned together at
  first use and kept for the process: the size of an input never decides
  theirs, so no later upload pins memory.
- An input's bytes go through the chunks in turn (:func:`chunk_plan`): wait
  for the last copy that read the chunk to end, copy the bytes into it on
  the host (PyTorch's copy, spread over its intra-op threads), then one
  asynchronous copy from the chunk to the card on the current stream. The
  host copy of a chunk overlaps the card's copy of the one before, and
  later work on the stream is ordered after every chunk's copy.
- :func:`upload` returns once every byte is in the chunks, so the caller
  may change its array at once. An input under :data:`MIN_STAGED_BYTES`,
  one not C-contiguous, one already on a card, or one bound for the CPU
  takes the plain copy.
"""

from __future__ import annotations

import mmap
import threading
import weakref

import numpy as np
import torch

from . import tracing

#: The slots kept at most (of the newest size)
MAX_SLOTS = 2
#: The upload ring's chunks, and the bytes of each
RING_CHUNKS = 4
CHUNK_BYTES = 8 << 20
#: The least input that goes through the ring; a smaller one takes the
#: plain copy
MIN_STAGED_BYTES = 2 << 20
#: ``cudaHostRegisterPortable``
_REGISTER_PORTABLE = 1


def _pin(n_bytes: int) -> torch.Tensor:
    """
    ``n_bytes`` of page-locked host memory (a uint8 tensor): an anonymous
    mapping registered with CUDA (``cudaHostRegister``, portable to every
    device), unregistered and unmapped once the tensor is freed. On an H100
    host it took 97 ms for 453 MB against 113-122 ms from
    ``torch.empty(..., pin_memory=True)``, whose cache would also keep it
    past a slot's drop, rounded up to a power of two; both copy at the
    same rate (``scripts/time_d2h_copy.py``).
    """
    array = np.frombuffer(mmap.mmap(-1, n_bytes), dtype=np.uint8)
    cudart = torch.cuda.cudart()
    address = array.ctypes.data
    rc = cudart.cudaHostRegister(address, n_bytes, _REGISTER_PORTABLE)
    if int(rc) != 0:
        raise RuntimeError(f'cudaHostRegister of {n_bytes} B failed: {rc}')
    # at exit the process's mappings go with it: no call into CUDA then
    weakref.finalize(array, cudart.cudaHostUnregister, address).atexit = False
    return torch.from_numpy(array)


class Lease:
    """One loan of a slot: the base of the arrays cut from it. It keeps the
    slot's memory alive and exposes it to numpy (``np.asarray(lease)``)."""

    def __init__(self, slot: 'Slot'):
        self.tensor = slot.tensor
        self.__array_interface__ = slot.array.__array_interface__


class Slot:
    """A page-locked buffer and a weak reference to its current loan."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.array = tensor.numpy()
        self.nbytes = tensor.numel()
        self._lease = lambda: None

    def busy(self) -> bool:
        return self._lease() is not None

    def lend(self) -> Lease:
        lease = Lease(self)
        self._lease = weakref.ref(lease)
        return lease


class HostSlots:
    """The pool: at most :data:`MAX_SLOTS` slots, lent one loan at a time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.slots: list[Slot] = []

    def take(self, n_bytes: int) -> Lease | None:
        """A loan of a free slot of ``n_bytes`` (allocated if fewer than
        :data:`MAX_SLOTS` exist), or None where every slot is lent out or
        page-locked memory cannot be had."""
        with self._lock:
            self.slots = [s for s in self.slots
                          if s.nbytes == n_bytes or s.busy()]
            for slot in self.slots:
                if slot.nbytes == n_bytes and not slot.busy():
                    return slot.lend()
            if len(self.slots) >= MAX_SLOTS:
                return None
            try:
                slot = Slot(_pin(n_bytes))
            except (RuntimeError, OSError):
                return None
            self.slots.append(slot)
            return slot.lend()


#: The process's pool, used by :func:`.pipeline.compute_backplanes`
SLOTS = HostSlots()


def chunk_plan(n_bytes: int, chunk_bytes: int = CHUNK_BYTES
               ) -> list[tuple[int, int]]:
    """The ``[start, stop)`` byte ranges, in order, in which ``n_bytes`` go
    through chunks of ``chunk_bytes``."""
    return [(a, min(a + chunk_bytes, n_bytes))
            for a in range(0, n_bytes, chunk_bytes)]


class UploadRing:
    """``n_chunks`` page-locked chunks of ``chunk_bytes``, each with the
    event of the last copy to the card that read it."""

    def __init__(self, n_chunks: int = RING_CHUNKS,
                 chunk_bytes: int = CHUNK_BYTES):
        self.n_chunks = n_chunks
        self.chunk_bytes = chunk_bytes
        self.chunks: list[torch.Tensor] = []
        self._events: list = [None] * n_chunks
        self._lock = threading.Lock()

    def ready(self) -> bool:
        """Whether the chunks are pinned, pinning them at the first call;
        False where page-locked memory cannot be had."""
        with self._lock:
            if not self.chunks:
                try:
                    self.chunks = [_pin(self.chunk_bytes)
                                   for _ in range(self.n_chunks)]
                except (RuntimeError, OSError):
                    return False
            return True

    def copy(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy the host bytes ``src`` into the card's bytes ``dst`` (flat
        uint8 tensors of one length) through the chunks, on the current
        stream; returns once every byte of ``src`` is in a chunk."""
        stream = torch.cuda.current_stream(dst.device)
        with self._lock:
            for i, (a, b) in enumerate(chunk_plan(src.numel(),
                                                  self.chunk_bytes)):
                k = i % self.n_chunks
                event = self._events[k]
                if event is not None and not event.query():
                    tracing.count('map.upload_waits')
                    event.synchronize()
                chunk = self.chunks[k][:b - a]
                with tracing.span('pm.map.upload.stage'):
                    chunk.copy_(src[a:b])
                dst[a:b].copy_(chunk, non_blocking=True)
                self._events[k] = stream.record_event()


#: The process's upload ring, used by :func:`upload`
UPLOADS = UploadRing()


def _staged_source(img, device: torch.device) -> torch.Tensor | None:
    """``img`` as a CPU tensor sharing its memory, where it goes to the card
    through the ring; None where it takes the plain copy."""
    if device.type != 'cuda' or img.nbytes < MIN_STAGED_BYTES:
        return None
    if not isinstance(img, torch.Tensor):
        try:
            img = torch.from_numpy(img)
        except (TypeError, ValueError):  # negative strides; a dtype or a
            return None                  # byte order torch lacks
    if img.device.type != 'cpu' or not img.is_contiguous():
        return None
    return img.detach()


def upload(img, device: torch.device) -> torch.Tensor:
    """
    ``img`` (an array or a tensor) as a tensor on ``device``, of its shape
    and dtype: through the ring (:class:`UploadRing`) where it is a
    C-contiguous host array of at least :data:`MIN_STAGED_BYTES` bound for a
    card whose chunks could be pinned (``map.upload_staged``), else by
    ``torch.as_tensor`` or ``Tensor.to`` (``map.upload_plain``). Counts the
    bytes in ``map.upload_bytes``.
    """
    if not isinstance(img, torch.Tensor):
        img = np.asarray(img)
    src = _staged_source(img, device)
    if src is not None and UPLOADS.ready():
        out = torch.empty(src.shape, dtype=src.dtype, device=device)
        UPLOADS.copy(src.reshape(-1).view(torch.uint8),
                     out.view(-1).view(torch.uint8))
        tracing.count('map.upload_staged')
    else:
        out = (img.to(device) if isinstance(img, torch.Tensor)
               else torch.as_tensor(img, device=device))
        tracing.count('map.upload_plain')
    tracing.count('map.upload_bytes', out.nbytes)
    return out
