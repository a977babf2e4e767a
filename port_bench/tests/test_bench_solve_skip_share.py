"""
The reader of the program's solve counters (``solve_skip_share``) against
hand-set counters with a known answer, and None where the program keeps no
such counters (an older program, a map with no spline solve) or was not
loaded.
"""

import sys
from types import SimpleNamespace

from port_bench import harness


def _read(ctx):
    reader = harness.load_module(
        harness.HERE / 'metrics' / 'solve_skip_share.py',
        'test_metric_solve_skip_share')
    return reader.read(ctx)


def test_solve_skip_share(monkeypatch):
    ctx = SimpleNamespace(window=SimpleNamespace(trace=None), work={})
    counts = {'map.solve_skipped': 6, 'map.solves': 2,
              'launches.map_spline': 4}
    program = SimpleNamespace(traced_counts=lambda: counts)
    monkeypatch.setitem(sys.modules, 'planetmapper_tpu_torch.tracing', program)
    assert _read(ctx) == 75.0
    del counts['map.solves']
    assert _read(ctx) == 100.0
    counts['map.solves'] = 3
    del counts['map.solve_skipped']
    assert _read(ctx) == 0.0
    program.traced_counts = lambda: {'launches.map_spline': 2}
    assert _read(ctx) is None
    monkeypatch.delitem(sys.modules, 'planetmapper_tpu_torch.tracing')
    assert _read(ctx) is None
