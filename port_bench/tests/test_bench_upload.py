"""
The readers of the program's upload counters and spans
(``upload_slot_share``, ``upload_gbps``) against hand-set counters and a
hand-built trace with a known answer, and None where the program keeps no
such counters or spans (an older program) or was not loaded.
"""

import sys
from types import SimpleNamespace

import pytest

from port_bench import harness
from port_bench.tracing import Trace


def _read(name, ctx):
    reader = harness.load_module(harness.HERE / 'metrics' / f'{name}.py',
                                 f'test_metric_{name}')
    return reader.read(ctx)


def _ctx(span_list):
    trace = Trace.__new__(Trace)
    trace.window = (0.0, 10.0)
    trace.window_s = 10.0
    trace.spans = list(span_list)
    trace.busy = []
    trace.steps = 2
    return SimpleNamespace(window=SimpleNamespace(trace=trace), work={})


#: Two uploads: 1 ms and 2 ms, the first with two staging spans inside it
UPLOADS = [(1.0, 1.001, 'pm.map.upload'),
           (1.0002, 1.0004, 'pm.map.upload.stage'),
           (1.0005, 1.0008, 'pm.map.upload.stage'),
           (1.001, 1.002, 'pm.map.samples'),
           (3.0, 3.002, 'pm.map.upload'),
           (0.9, 3.1, 'map_img')]


def test_upload_slot_share(monkeypatch):
    counts = {'map.upload_staged': 3, 'map.upload_plain': 1,
              'map.upload_bytes': 10}
    program = SimpleNamespace(traced_counts=lambda: counts)
    monkeypatch.setitem(sys.modules, 'planetmapper_tpu_torch.tracing', program)
    ctx = _ctx(UPLOADS)
    assert _read('upload_slot_share', ctx) == 75.0
    del counts['map.upload_plain']
    assert _read('upload_slot_share', ctx) == 100.0
    program.traced_counts = lambda: {'map.frames': 2}
    assert _read('upload_slot_share', ctx) is None
    monkeypatch.delitem(sys.modules, 'planetmapper_tpu_torch.tracing')
    assert _read('upload_slot_share', ctx) is None


def test_upload_gbps(monkeypatch):
    counts = {'map.upload_bytes': 33_554_432, 'map.upload_staged': 2}
    program = SimpleNamespace(traced_counts=lambda: counts)
    monkeypatch.setitem(sys.modules, 'planetmapper_tpu_torch.tracing', program)
    # 32 MiB in 3 ms of upload spans (the stages inside count once)
    assert _read('upload_gbps', _ctx(UPLOADS)) == pytest.approx(
        33_554_432 / 3e-3 / 1e9)
    assert _read('upload_gbps', _ctx(UPLOADS[3:4])) is None
    program.traced_counts = lambda: {'map.frames': 2}
    assert _read('upload_gbps', _ctx(UPLOADS)) is None
    monkeypatch.delitem(sys.modules, 'planetmapper_tpu_torch.tracing')
    assert _read('upload_gbps', _ctx(UPLOADS)) is None
