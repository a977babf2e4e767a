"""``pchip_roofline``: the share of its roofline that ``csrc/pchip.cu``'s
launches (the rows' and the columns' pass of each 'smooth' call) reach in
the traced window: the least time of the oversampling that the cell's
driver counts for them (``work['pchip']``) over their device time."""

from port_bench.tracing import roofline_share


def read(ctx):
    return roofline_share(ctx, 'pchip')
