"""
What the readers of the program's own spans share. The port records its
stages as ``pm.<layer>.<stage>`` spans on the profiler's timeline (its
``tracing`` module) while a profiler records; ``tracing.Trace`` keeps them
among its host spans, on the clock of the device's operations.

A reader of program spans returns None when the trace holds none of its
spans: a control run, a stand-in, or a program without them.
"""

from __future__ import annotations

from .tracing import _clip, _length, _merge


def intervals(trace, prefix: str) -> list:
    """The union of the window's spans whose name starts with ``prefix``,
    clipped to the window, as sorted ``[start, end]`` intervals (a span
    inside another counts once)."""
    lo, hi = trace.window
    return _merge(_clip([(s, e) for s, e, name in trace.spans
                         if name.startswith(prefix)], lo, hi))


def busy_within(trace, spans: list) -> float:
    """Seconds of the merged ``spans`` in which the device runs an
    operation (a kernel, a copy or a fill: ``trace.busy``)."""
    seconds, j = 0.0, 0
    busy = trace.busy
    for start, end in spans:
        while j < len(busy) and busy[j][1] <= start:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < end:
            seconds += min(end, busy[k][1]) - max(start, busy[k][0])
            k += 1
    return seconds


def idle_within(trace, spans: list) -> float:
    """Seconds of the merged ``spans`` in which the device runs nothing."""
    return total(spans) - busy_within(trace, spans)


def total(spans: list) -> float:
    """Seconds the merged ``spans`` cover."""
    return _length(spans)


def per_step(trace, seconds: float):
    """``seconds`` over the traced steps, in ms; None without a step."""
    steps = getattr(trace, 'steps', 0)
    return 1e3 * seconds / steps if steps else None
