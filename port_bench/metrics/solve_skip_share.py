"""``solve_skip_share``: the share, in %, of the traced per-frame axis
products of the spline modes' collocation solve that the program skipped
because the axis's inverse is the identity (the program's counters
``map.solve_skipped`` and ``map.solves``, counted while the profiler
records). 100 where every mapped axis is of degree 1 ('linear'); None
where the program keeps no such counters, or was not loaded (a
stand-in)."""

import sys


def read(ctx):
    tracing = sys.modules.get('planetmapper_tpu_torch.tracing')
    if tracing is None:
        return None
    counts = tracing.traced_counts()
    skipped = counts.get('map.solve_skipped', 0)
    products = skipped + counts.get('map.solves', 0)
    if not products:
        return None
    return 100.0 * skipped / products
