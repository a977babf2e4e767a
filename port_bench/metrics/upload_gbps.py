"""``upload_gbps``: the rate, in GB/s (1e9 B), at which the program's
``map_img`` took its inputs to the card: the traced bytes of the program's
counter ``map.upload_bytes`` over the host time of its ``pm.map.upload``
spans in the traced window (the staging's ``pm.map.upload.stage`` spans
lie inside them). None where the program keeps no such counter or no such
span, or was not loaded (a stand-in)."""

import sys

from port_bench import spans


def read(ctx):
    tracing = sys.modules.get('planetmapper_tpu_torch.tracing')
    if tracing is None:
        return None
    n_bytes = tracing.traced_counts().get('map.upload_bytes', 0)
    seconds = spans.total(spans.intervals(ctx.window.trace, 'pm.map.upload'))
    if not n_bytes or not seconds:
        return None
    return n_bytes / seconds / 1e9
