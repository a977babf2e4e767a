"""``kernel1_roofline``: the share of its roofline that kernel 1's launches
(``csrc/backplanes.cu``, single-frame) reach in the traced window: the
least time of the work the cell's driver counts for them
(``work['kernel1']``) over their device time."""

from port_bench.tracing import roofline_share


def read(ctx):
    return roofline_share(ctx, 'kernel1')
