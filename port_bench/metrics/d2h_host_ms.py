"""``d2h_host_ms``: per traced step, the time inside the program's copy of
the planes to numpy (the ``pm.pipeline.to_numpy`` spans) in which the
device runs nothing: the part of the copy whose pace the host sets
(allocations, first touches of the arrays' pages, Python between the
planes), not the DMA."""

from port_bench import spans


def read(ctx):
    trace = ctx.window.trace
    copy = spans.intervals(trace, 'pm.pipeline.to_numpy')
    if not copy:
        return None
    return spans.per_step(trace, spans.idle_within(trace, copy))
