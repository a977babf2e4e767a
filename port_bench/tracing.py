"""
The traced run's reading of ``torch.profiler``'s trace over the window:
device operations (kernels, copies, fills) and the benchmark's own spans
(``record_function`` around the window, each step, the calls into the
program and the synchronise), and the per-layer metrics read from them by
the readers in ``metrics/``.
"""

from __future__ import annotations

from . import harness

#: The benchmark's span around the measured window
WINDOW = 'window'
#: The profiler's activity types of operations on the device
DEVICE_OPS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _merge(intervals):
    """Union of ``(start, end)`` intervals, sorted."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _activity(e) -> str:
    """The profiler's activity type of an event (from its device and name
    where the installed PyTorch does not give the type)."""
    if hasattr(e, 'activity_type'):
        return str(e.activity_type())
    cuda = 'CUDA' in str(e.device_type())
    if e.is_user_annotation():
        return 'gpu_user_annotation' if cuda else 'user_annotation'
    if not cuda:
        return 'cpu_op'
    if e.name().startswith('Memcpy'):
        return 'gpu_memcpy'
    if e.name().startswith('Memset'):
        return 'gpu_memset'
    return 'kernel'


class Trace:
    """The window's device operations and host spans, in seconds."""

    def __init__(self, prof):
        ops, spans = [], []
        window = None
        for e in prof.profiler.kineto_results.events():
            start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            kind = _activity(e)
            if kind == 'user_annotation':
                spans.append((start, end, e.name()))
                if e.name() == WINDOW:
                    window = (start, end)
            elif kind in DEVICE_OPS:
                ops.append((start, end, e.name(), int(e.nbytes() or 0), kind))
        # a span's mirror on the device's timeline is no operation
        names = {name for *_, name in spans}
        ops = [op for op in ops if op[2] not in names]
        if window is None:
            raise RuntimeError('the trace holds no window span')
        lo, hi = window
        self.window = window
        self.window_s = hi - lo
        self.ops = [op for op in ops if op[1] > lo and op[0] < hi]
        self.kernels = [op for op in self.ops if op[4] == 'kernel']
        self.spans = [s for s in spans if s[2] != WINDOW]
        self.busy = _merge(_clip([(s, e) for s, e, *_ in self.ops], lo, hi))
        self.busy_s = _length(self.busy)
        self.kernel_busy_s = _length(
            _merge(_clip([(s, e) for s, e, *_ in self.kernels], lo, hi)))

    def matching(self, patterns) -> list:
        """The kernels whose name holds any of ``patterns``."""
        return [k for k in self.kernels if any(p in k[2] for p in patterns)]

    def copies(self, kind: str) -> list:
        """Copies whose name holds ``kind`` ('DtoH', 'HtoD', 'DtoD')."""
        return [op for op in self.ops
                if op[4] == 'gpu_memcpy' and kind in op[2]]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the innermost benchmark span on the host."""
        totals = {}
        for start, end, name, *_ in self.ops:
            totals[name[:160]] = totals.get(name[:160], 0.0) + (end - start)
        device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return dict(device_ops=[[k, v] for k, v in device_ops],
                    idle_gaps=[[self.label(g), g[1] - g[0]] for g in gaps])

    def label(self, gap) -> str:
        """The innermost benchmark span covering the gap's middle."""
        mid = 0.5 * (gap[0] + gap[1])
        covering = [s for s in self.spans if s[0] <= mid <= s[1]]
        if not covering:
            return 'outside any step'
        return min(covering, key=lambda s: s[1] - s[0])[2]


def per_layer(bench: dict, workload: str, ctx) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in harness.metrics_for(bench['per_layer'], workload):
        reader = harness.load_module(
            harness.HERE / 'metrics' / f'{m["name"]}.py',
            f'port_bench_metric_{m["name"].replace(".", "_")}')
        value = reader.read(ctx)
        if value is not None:
            out[m['name']] = dict(value=float(value), unit=m['unit'])
    return out


def roofline_share(ctx, key: str):
    """
    A kernel's share of its roofline, in %: the least time of the work
    that its launches in the window did, over the time they took on the
    device. ``ctx.work[key]`` gives ``patterns`` (kernel names) and either
    ``bound_ms_per_launch`` or ``bound_ms_per_step``.
    """
    work = ctx.work.get(key)
    if work is None:
        return None
    kernels = ctx.window.trace.matching(work['patterns'])
    if not kernels:
        return None
    device_s = sum(e - s for s, e, *_ in kernels)
    if 'bound_ms_per_launch' in work:
        bound_s = work['bound_ms_per_launch'] * 1e-3 * len(kernels)
    else:
        bound_s = work['bound_ms_per_step'] * 1e-3 * ctx.window.trace.steps
    return 100.0 * bound_s / device_s
