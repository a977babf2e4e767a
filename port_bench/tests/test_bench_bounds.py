"""The roofline arithmetic against hand counts at each cell's shapes."""

from types import SimpleNamespace

import pytest

import conftest  # noqa: F401  (the checkout's import path)
from port_bench import tracing
from port_bench.traffic import map_frames
from port_bench.vendor import bounds

HBM = 3.35e12


def test_kernel1_at_2048():
    # 25 float32 planes and RADIAL-VELOCITY in float64: 108 bytes a pixel
    b = bounds.backplane_bound(2048, 2048, 2_000_000)
    assert b['bytes'] == 108 * 2048 * 2048 == 452_984_832
    assert b['bound_by'] == 'bytes'
    assert b['ms'] == pytest.approx(452_984_832 / HBM * 1e3)
    assert b['ms'] == pytest.approx(0.13522, rel=1e-4)


def test_map_spline_by_hand():
    b = bounds.map_spline_bound(
        samples=10, valid_samples=6, live_samples=5, live_sample_frames=5,
        frames=1, coefficients=8, grid_cells=3, knots=8, kx=1, ky=1)
    # validity 10, x and y of 6 valid 96, 10 float32 out, 1 flag, 8
    # coefficients, 3 NaN cells, 8 knots
    assert b['bytes'] == 10 + 96 + 40 + 1 + 64 + 3 + 64
    # per live sample 2 axes of 6 + 2k(k+1) = 10; per value 2(k+1)(k+2) = 12
    assert b['f64_ops'] == 5 * 20 + 5 * 12


def test_map_linear_cell_by_hand():
    counts = dict(samples=720 * 1440, valid_samples=400_000,
                  live_samples=399_000, cells=420_000, nan_cells=4_000)
    state = SimpleNamespace(counts=counts, ctx=SimpleNamespace(
        config={'frame': [2048, 2048]}))
    work = map_frames.work(state)['map_spline']
    # validity, x and y of the valid samples, the float32 map, one flag,
    # the live samples' coefficients, the NaN cells, both axes' knots
    n_bytes = (720 * 1440 + 16 * 400_000 + 4 * 720 * 1440 + 1
               + 8 * 420_000 + 4_000 + 8 * 2 * 2050)
    assert work['patterns'] == ['map_spline_kernel']
    assert work['bound_ms_per_launch'] == pytest.approx(n_bytes / HBM * 1e3)


def test_roofline_share_is_bound_over_device_time():
    trace = SimpleNamespace(matching=lambda p: [(0.0, 2e-3, 'k'), (1.0, 1.002, 'k')],
                            steps=2)
    ctx = SimpleNamespace(work={'kernel1': dict(patterns=['k'],
                                                bound_ms_per_launch=0.5)},
                          window=SimpleNamespace(trace=trace, steps=2))
    assert tracing.roofline_share(ctx, 'kernel1') == pytest.approx(25.0)
    ctx.work = {}
    assert tracing.roofline_share(ctx, 'kernel1') is None


def test_idle_and_busy_from_intervals():
    assert tracing._merge([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert tracing._length(tracing._clip([(0, 3), (5, 6)], 1, 5.5)) == 2.5
