"""
Background CUDA session warm-up.

A process's first CUDA call creates the CUDA context: it loads the
driver's modules, maps the card's memory and starts PyTorch's caching
allocator, a cost of its own that is paid once per process whatever runs
first. A daemon thread started at the first
:class:`~planetmapper_tpu_torch.SpiceBase` construction pays it while the
main thread reads the SPICE kernels and builds the scene: it creates the
context, runs one 128-element reduction on the card and synchronises.
Only a body on a CUDA device starts it (the JAX package's CPU backends
skip it likewise): a CPU session on a card host creates no CUDA context.

It does nothing else. In particular it never builds or loads a kernel
library: an ``nvcc`` build on a second thread would race the main
thread's build of the same library into ``build/``.

A process that forks after CUDA is initialised cannot use CUDA in the
child. The port starts its processes with ``spawn``
(``torch.multiprocessing.spawn`` in ``parallel/multihost.py``'s tests and
``testing/distributed.py``), so the thread does not get in their way; a
program that forks should set ``PLANETMAPPER_TPU_SESSION_WARM=0``.

Disable with ``PLANETMAPPER_TPU_SESSION_WARM=0``. ``scripts/
time_cold_start.py`` times a cold ``--prewarm`` with it off and on.
"""

from __future__ import annotations

import os
import threading

import torch

_lock = threading.Lock()
_thread: threading.Thread | None = None
_started = False


def _session_warm(device: torch.device) -> None:  # pragma: no cover
    try:
        x = torch.ones(128, dtype=torch.float32, device=device)
        (x * 2.0).sum()
        torch.cuda.synchronize(device)
    except Exception:
        pass  # best-effort: the first real CUDA call pays the init instead


def start_session_warm(device=None) -> None:
    """Start the one-time session warm thread for a body on ``device``
    (idempotent; nothing starts unless ``device`` is a CUDA device and a
    card is present)."""
    global _started, _thread
    if _started or device is None:
        return
    device = torch.device(device)
    if device.type != 'cuda':
        return
    with _lock:
        if _started:
            return
        _started = True
    if os.environ.get('PLANETMAPPER_TPU_SESSION_WARM', '1') == '0' or \
            not torch.cuda.is_available():
        return
    _thread = threading.Thread(
        target=_session_warm, args=(device,),
        name='planetmapper-session-warm', daemon=True,
    )
    _thread.start()


def wait_for_session(timeout: float | None = None) -> None:
    """Block until the session warm (if started) completes. Callers
    that time their own first computation (benchmarks) use this to
    separate the CUDA context's creation from their own time."""
    t = _thread
    if t is not None:
        t.join(timeout)
