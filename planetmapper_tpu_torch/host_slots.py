"""
Two reused page-locked host buffers ("slots") for the planes that
:func:`.pipeline.compute_backplanes` copies off the card.

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
"""

from __future__ import annotations

import mmap
import threading
import weakref

import numpy as np
import torch

#: The slots kept at most (of the newest size)
MAX_SLOTS = 2
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
