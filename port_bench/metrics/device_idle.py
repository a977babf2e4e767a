"""``device_idle``: the share of the window, in %, in which no kernel runs
on the device (copies and fills do not count as busy)."""


def read(ctx):
    trace = ctx.window.trace
    if not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.kernel_busy_s / trace.window_s)
