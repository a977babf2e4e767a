"""``export_kernels``: per traced step, the device kernels that start
inside the program's ``pm.export.plane`` spans (each backplane's getter and
its array in ``save_observation``): the launches of the getters' float64
chains. None where the trace holds no such span, or no kernel."""

import bisect

from port_bench import spans


def read(ctx):
    trace = ctx.window.trace
    planes = spans.intervals(trace, 'pm.export.plane')
    if not planes or not trace.kernels:
        return None
    steps = getattr(trace, 'steps', 0)
    if not steps:
        return None
    starts = sorted(k[0] for k in trace.kernels)
    n = sum(bisect.bisect_left(starts, end) - bisect.bisect_left(starts, start)
            for start, end in planes)
    return n / steps
