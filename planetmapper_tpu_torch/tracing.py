"""
The port's spans and counters: the only instrumentation of the package.

- :func:`span` names a stage of a call. While a ``torch.profiler`` records,
  it is a ``torch.profiler.record_function``: the span lands on the
  profiler's own timeline, beside the CUDA kernels and copies the stage
  enqueues and on the same clock, and its parent is the span that encloses
  it on the same thread. While none records, it costs one
  ``torch.autograd._profiler_enabled()`` check and returns a shared
  do-nothing context: no ``record_function`` is entered and nothing is
  allocated. There is no switch: tracing is on exactly while a profiler
  records. Every name starts with ``pm.`` (``pm.<layer>.<stage>``), so that
  no span shares its name with a device operation.
- :func:`count` adds to a named counter, always, and, while a profiler
  records, to its traced tally as well. :func:`counts` and
  :func:`traced_counts` read the two tallies, :func:`reset` clears them.
  The kernels' launch counts are counters (``launches.<library>``, e.g.
  ``launches.backplanes26``, ``launches.map_spline``; the batched
  backplane kernel ``launches.backplanes26_batch``; the dsk kernels
  ``launches.dsk.<kernel>``), read by the wrappers' ``launch_count``
  functions. :func:`resident_pages` reads the process's resident set while
  a profiler records, for counters of pages a stage touches first.

To trace a call, run it under a profiler::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        body.generate_backplanes_fused()
    print(prof.key_averages().table(sort_by='cpu_time_total'))
    print(tracing.traced_counts())
"""

from __future__ import annotations

import contextlib
import threading

import torch

#: Whether a profiler records (PyTorch's own flag, read on every call)
recording = torch.autograd._profiler_enabled

#: The context :func:`span` returns while no profiler records
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_totals: dict[str, int] = {}
_traced: dict[str, int] = {}


def span(name: str):
    """A context manager naming a stage ``name`` (``pm.<layer>.<stage>``) of
    a call on the profiler's timeline while one records; else nothing."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to its traced tally while a
    profiler records)."""
    traced = recording()
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
        if traced:
            _traced[name] = _traced.get(name, 0) + n


def counts() -> dict[str, int]:
    """Every counter's total so far in this process."""
    with _lock:
        return dict(_totals)


def traced_counts() -> dict[str, int]:
    """The part of each counter counted while a profiler recorded."""
    with _lock:
        return dict(_traced)


def resident_pages() -> int | None:
    """The process's resident set in pages while a profiler records
    (``/proc/self/statm``); None while none records, or without that file.
    Its growth over a stage counts the pages the stage touched first: one
    minor page fault each, on hosts whose kernel counts no faults too."""
    if not recording():
        return None
    try:
        with open('/proc/self/statm', 'rb') as f:
            return int(f.read().split()[1])
    except OSError:
        return None


def reset(*names: str) -> None:
    """Clear both tallies of the counters ``names``, or of every counter."""
    with _lock:
        for tally in (_totals, _traced):
            if names:
                for name in names:
                    tally.pop(name, None)
            else:
                tally.clear()
