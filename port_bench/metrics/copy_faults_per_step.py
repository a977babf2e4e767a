"""``copy_faults_per_step``: per traced step, the first-touch page faults
of the program's copy of the planes to numpy: the pages the copy newly made
resident (the program's counter ``pipeline.copy_fresh_pages``, the growth
of the process's resident set over the copy, counted only while the
profiler records; read so because a sandboxed kernel such as gVisor
reports no page faults). Near 0 where the arrays reuse the host
allocator's pages, about one a 4 KiB page of the planes where it takes
pages afresh. None where the program keeps no such counter, or was not
loaded (a stand-in)."""

import sys


def read(ctx):
    tracing = sys.modules.get('planetmapper_tpu_torch.tracing')
    if tracing is None:
        return None
    pages = tracing.traced_counts().get('pipeline.copy_fresh_pages')
    steps = getattr(ctx.window.trace, 'steps', 0)
    if pages is None or not steps:
        return None
    return pages / steps
