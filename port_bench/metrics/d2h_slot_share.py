"""``d2h_slot_share``: the share, in %, of the traced copies of the planes
to numpy that went into one of the program's reused page-locked host slots
(the program's counters ``pipeline.copy_slot_hits`` and
``pipeline.copy_slot_misses``, counted while the profiler records). 100
where the caller drops each step's planes in time for a slot to be free;
None where the program keeps no such counters, or was not loaded (a
stand-in)."""

import sys


def read(ctx):
    tracing = sys.modules.get('planetmapper_tpu_torch.tracing')
    if tracing is None:
        return None
    counts = tracing.traced_counts()
    hits = counts.get('pipeline.copy_slot_hits', 0)
    copies = hits + counts.get('pipeline.copy_slot_misses', 0)
    if not copies:
        return None
    return 100.0 * hits / copies
