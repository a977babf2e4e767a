"""``export_idle_ms``: per traced step, the time inside the program's
``pm.export.plane`` spans (each backplane's getter and its array in
``save_observation``) in which the device runs nothing: the host-paced part
of the getters' float64 chains. None where the trace holds no such span (a
control run, a stand-in, or a program without them)."""

from port_bench import spans


def read(ctx):
    trace = ctx.window.trace
    planes = spans.intervals(trace, 'pm.export.plane')
    if not planes:
        return None
    return spans.per_step(trace, spans.idle_within(trace, planes))
