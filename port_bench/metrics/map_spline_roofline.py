"""``map_spline_roofline``: the share of its roofline that
``csrc/map_spline.cu``'s launches reach in the traced window: the least
time of the work the cell's driver counts for them
(``work['map_spline']``) over their device time."""

from port_bench.tracing import roofline_share


def read(ctx):
    return roofline_share(ctx, 'map_spline')
