"""
The readers of the program's own spans and counters (``spans.py`` and
``scene_us``, ``d2h_host_ms``, ``copy_faults_per_step``, ``map_idle_ms``):
each against a hand-built trace with a known answer, each None without
what it reads, and each reported by a traced run of its cell on the CPU at
the small size (where no device operation runs: every span is idle).
"""

import sys
from types import SimpleNamespace

import pytest

from conftest import SEED, small
from port_bench import harness, spans
from port_bench.tracing import Trace

PROGRAM_METRICS = {'jupiter_2048.backplanes': ('scene_us', 'd2h_host_ms',
                                               'copy_faults_per_step'),
                   'jupiter_2048.map_linear': ('map_idle_ms',)}


def _trace(span_list, busy, steps, window=(0.0, 10.0)):
    """A window's trace from its spans ``(start, end, name)``, the device's
    busy intervals and the traced steps, in seconds."""
    trace = Trace.__new__(Trace)
    trace.window = window
    trace.window_s = window[1] - window[0]
    trace.spans = list(span_list)
    trace.busy = [list(iv) for iv in busy]
    trace.steps = steps
    return trace


def _ctx(trace):
    return SimpleNamespace(window=SimpleNamespace(trace=trace), work={})


def _read(name, ctx):
    reader = harness.load_module(harness.HERE / 'metrics' / f'{name}.py',
                                 f'test_metric_{name}')
    return reader.read(ctx)


#: Two steps of the backplanes cell: the scene's two stages (a packing span
#: nested in another counts once), kernel 1, and the copy to numpy with
#: device work on part of it; a span outside the window
BACKPLANES = _trace([
    (-1.0, -0.5, 'pm.scene.inputs'),
    (1.0, 1.0002, 'pm.scene.inputs'),
    (1.0003, 1.0004, 'pm.scene.pack'),
    (1.0003, 1.0005, 'pm.kernel1.launch'),
    (1.001, 1.051, 'pm.pipeline.to_numpy'),
    (2.0, 2.0001, 'pm.scene.inputs'),
    (2.0002, 2.0003, 'pm.scene.pack'),
    (2.0002, 2.00025, 'pm.scene.pack'),
    (2.001, 2.041, 'pm.pipeline.to_numpy'),
    (0.9, 2.1, 'step'),
], busy=[(1.0004, 1.0007), (1.002, 1.050), (2.003, 2.011), (2.012, 2.040)],
    steps=2)

#: Two map steps: the upload busy with its copy, a sync, host work between
MAP = _trace([
    (1.0, 1.004, 'pm.map.upload'),
    (1.004, 1.0045, 'pm.map.samples'),
    (1.005, 1.006, 'pm.map.flags'),
    (1.006, 1.008, 'pm.map.infill'),
    (1.008, 1.009, 'pm.map.solve'),
    (1.009, 1.0095, 'pm.map.spline'),
    (0.99, 1.01, 'map_img'),
    (3.0, 3.004, 'pm.map.upload'),
    (3.004, 3.006, 'pm.map.spline'),
], busy=[(1.0005, 1.004), (1.0055, 1.0065), (1.008, 1.009), (3.0, 3.005)],
    steps=2)


def test_intervals_merge_a_prefix_and_clip_to_the_window():
    assert spans.intervals(BACKPLANES, 'pm.scene.') == [
        [1.0, 1.0002], [1.0003, 1.0004], [2.0, 2.0001], [2.0002, 2.0003]]
    assert spans.intervals(BACKPLANES, 'pm.map.') == []
    trace = _trace([(9.5, 11.0, 'pm.x')], [], 1)
    assert spans.intervals(trace, 'pm.') == [[9.5, 10.0]]


def test_busy_and_idle_within_spans():
    iv = [[0.0, 1.0], [2.0, 3.0]]
    trace = _trace([], [(0.5, 2.5), (2.75, 4.0)], 1)
    assert spans.busy_within(trace, iv) == pytest.approx(1.25)
    assert spans.idle_within(trace, iv) == pytest.approx(0.75)
    assert spans.total(iv) == pytest.approx(2.0)
    assert spans.per_step(_trace([], [], 0), 1.0) is None


def test_scene_us():
    # (0.2 + 0.1 + 0.1 + 0.1) ms of scene stages over 2 steps
    assert _read('scene_us', _ctx(BACKPLANES)) == pytest.approx(250.0)


def test_d2h_host_ms():
    # step 1: 50 ms of copy, 48 busy; step 2: 40 ms, 8 + 28 busy
    assert _read('d2h_host_ms', _ctx(BACKPLANES)) == pytest.approx(3.0)


def test_map_idle_ms():
    # step 1: 9 ms of stages (the gap between the samples and the flags is
    # no stage), 3.5 + 1 + 1 busy; step 2: 6 ms, 5 busy
    assert _read('map_idle_ms', _ctx(MAP)) == pytest.approx(2.25)


def test_copy_faults_per_step(monkeypatch):
    program = SimpleNamespace(
        traced_counts=lambda: {'pipeline.copy_fresh_pages': 212_000,
                               'launches.backplanes26': 2})
    monkeypatch.setitem(sys.modules, 'planetmapper_tpu_torch.tracing', program)
    assert _read('copy_faults_per_step', _ctx(BACKPLANES)) == 106_000
    program.traced_counts = lambda: {'launches.backplanes26': 2}
    assert _read('copy_faults_per_step', _ctx(BACKPLANES)) is None
    monkeypatch.delitem(sys.modules, 'planetmapper_tpu_torch.tracing')
    assert _read('copy_faults_per_step', _ctx(BACKPLANES)) is None


@pytest.mark.parametrize('name', ['scene_us', 'd2h_host_ms', 'map_idle_ms'])
def test_a_span_reader_without_its_spans_is_none(name):
    """A control run or a program without the spans: the benchmark's own
    spans and device work only."""
    trace = _trace([(1.0, 1.05, 'step'), (1.0, 1.04, 'map_img'),
                    (1.0, 1.04, 'generate_backplanes_fused')],
                   [(1.001, 1.039)], 1)
    assert _read(name, _ctx(trace)) is None


@pytest.mark.parametrize('workload', list(PROGRAM_METRICS))
def test_a_traced_run_reports_the_program_metrics(workload):
    result = harness.run_cell(workload, SEED, 0.0, True, device='cpu',
                              overrides=small(workload), steps=2)
    for name in PROGRAM_METRICS[workload]:
        assert result['metrics'][name]['value'] >= 0
