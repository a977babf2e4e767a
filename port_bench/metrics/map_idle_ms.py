"""``map_idle_ms``: per traced step, the time inside the program's map
stages (the ``pm.map.*`` spans: upload, samples, float64 copy, flags, NaN
infill, solve, spline) in which the device runs nothing: host work between
the map path's launches and copies."""

from port_bench import spans


def read(ctx):
    trace = ctx.window.trace
    stages = spans.intervals(trace, 'pm.map.')
    if not stages:
        return None
    return spans.per_step(trace, spans.idle_within(trace, stages))
