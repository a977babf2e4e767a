"""
The reader of the program's slot counters (``d2h_slot_share``) against
hand-set counters with a known answer, and None where the program keeps no
such counters (a CPU body, an older program) or was not loaded.
"""

import sys
from types import SimpleNamespace

from port_bench import harness


def _read(ctx):
    reader = harness.load_module(harness.HERE / 'metrics' / 'd2h_slot_share.py',
                                 'test_metric_d2h_slot_share')
    return reader.read(ctx)


def test_d2h_slot_share(monkeypatch):
    ctx = SimpleNamespace(window=SimpleNamespace(trace=None), work={})
    counts = {'pipeline.copy_slot_hits': 9, 'pipeline.copy_slot_misses': 3,
              'launches.backplanes26': 12}
    program = SimpleNamespace(traced_counts=lambda: counts)
    monkeypatch.setitem(sys.modules, 'planetmapper_tpu_torch.tracing', program)
    assert _read(ctx) == 75.0
    del counts['pipeline.copy_slot_misses']
    assert _read(ctx) == 100.0
    counts['pipeline.copy_slot_misses'] = 3
    del counts['pipeline.copy_slot_hits']
    assert _read(ctx) == 0.0
    program.traced_counts = lambda: {'launches.backplanes26': 2}
    assert _read(ctx) is None
    monkeypatch.delitem(sys.modules, 'planetmapper_tpu_torch.tracing')
    assert _read(ctx) is None
