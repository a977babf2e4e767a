"""``d2h_rate``: GB/s of the window's device-to-host copies (the planes'
copy to numpy): the bytes the steps copied out over the copies' device
time. The bytes are the profiler's where it records them, else the
driver's count of a step's planes (``work['d2h_bytes_per_step']``)."""


def read(ctx):
    copies = ctx.window.trace.copies('DtoH')
    seconds = sum(e - s for s, e, *_ in copies)
    n_bytes = sum(op[3] for op in copies)
    if not n_bytes and 'd2h_bytes_per_step' in ctx.work:
        n_bytes = ctx.work['d2h_bytes_per_step'] * ctx.window.trace.steps
    if not copies or seconds <= 0 or n_bytes <= 0:
        return None
    return n_bytes / seconds / 1e9
