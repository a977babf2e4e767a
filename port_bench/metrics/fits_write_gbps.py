"""``fits_write_gbps``: the rate, in GB/s (1e9 B), at which the program's
FITS writer encoded and wrote its files: the traced bytes of the program's
counter ``fits.bytes_written`` (what ``HDUList.writeto`` handed to the
file) over the host time of its ``pm.fits.encode`` and ``pm.fits.write``
spans in the traced window. None where the program keeps no such counter or
no such span, or was not loaded (a stand-in)."""

import sys

from port_bench import spans


def read(ctx):
    tracing = sys.modules.get('planetmapper_tpu_torch.tracing')
    if tracing is None:
        return None
    n_bytes = tracing.traced_counts().get('fits.bytes_written', 0)
    seconds = spans.total(spans.intervals(ctx.window.trace, 'pm.fits.'))
    if not n_bytes or not seconds:
        return None
    return n_bytes / seconds / 1e9
