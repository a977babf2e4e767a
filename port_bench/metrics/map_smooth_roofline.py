"""``map_smooth_roofline``: the share of its roofline that
``csrc/map_smooth.cu``'s launches reach in the traced window: the least
time of the sampling that the cell's driver counts for them
(``work['map_smooth']``) over their device time."""

from port_bench.tracing import roofline_share


def read(ctx):
    return roofline_share(ctx, 'map_smooth')
