"""``scene_us``: per traced step, the host time of the program's scene
stages (the ``pm.scene.*`` spans: the inputs of the fused pipeline, the
xy2angular after a new disc and the cached anchors, and the packing of the
kernel's scene), in microseconds."""

from port_bench import spans


def read(ctx):
    trace = ctx.window.trace
    scene = spans.intervals(trace, 'pm.scene.')
    if not scene:
        return None
    ms = spans.per_step(trace, spans.total(scene))
    return None if ms is None else 1e3 * ms
