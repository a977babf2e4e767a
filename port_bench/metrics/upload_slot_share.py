"""``upload_slot_share``: the share, in %, of the traced uploads of a
``map_img`` input that went through the program's ring of page-locked
chunks (the program's counters ``map.upload_staged`` and
``map.upload_plain``, counted while the profiler records). 100 where every
input is a C-contiguous host array of the ring's least size; None where the
program keeps no such counters, or was not loaded (a stand-in)."""

import sys


def read(ctx):
    tracing = sys.modules.get('planetmapper_tpu_torch.tracing')
    if tracing is None:
        return None
    counts = tracing.traced_counts()
    staged = counts.get('map.upload_staged', 0)
    uploads = staged + counts.get('map.upload_plain', 0)
    if not uploads:
        return None
    return 100.0 * staged / uploads
