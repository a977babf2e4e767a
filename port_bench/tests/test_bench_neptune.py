"""
The ``neptune_mrs.cube_smooth`` cell on the CPU at a small size (the
deployment's 40 x 41 frame, 8-10 planes a band, a 10 degree map): its
driver, the check that decides ``correct`` (the sound program passes; the
control and each fault planted under the timed path do not), the counts
behind its roofline readers, and what a traced run reads. On a card, the
control at the cell's own size comes out not correct on three seeds.
"""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED
from port_bench import control, harness, program
from port_bench.reference import scene_neptune as rn
from port_bench.traffic import cube_frames

CELL = 'neptune_mrs.cube_smooth'
SMALL = {'config': {'bands': {'1A': 8, '1B': 9, '1C': 10},
                    'map': {'degree_interval': 10}}}


def _ctx(seed, tmp_path):
    files = harness.cell_files(harness.load_json(ROOT / 'BENCHMARK.json'),
                               CELL)
    return SimpleNamespace(
        config=dict(files.config, **SMALL['config']), traffic=files.traffic,
        check=files.check, seed=seed, device=torch.device('cpu'), cuda=False,
        kernel_dir=str(tmp_path), stand_in=None, Reservoir=harness.Reservoir)


def _run(stand_in=None, steps=4, trace=False):
    return harness.run_cell(CELL, SEED, 0.0, trace, device='cpu',
                            overrides=SMALL, stand_in=stand_in, steps=steps)


def test_same_seed_same_cubes_other_seed_other_cubes(tmp_path):
    big = 2**31 + 977
    a, order_a = cube_frames.inputs(_ctx(big, tmp_path))
    b, order_b = cube_frames.inputs(_ctx(big, tmp_path))
    c, order_c = cube_frames.inputs(_ctx(big + 1, tmp_path))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(order_a, order_b)
    assert not np.array_equal(np.nan_to_num(a[0]), np.nan_to_num(c[0]))
    assert set(np.unique(order_a)) == {0, 1, 2}


def test_cubes_have_the_bands_the_footprint_and_dead_spaxels(tmp_path):
    ctx = _ctx(5, tmp_path)
    pool, _ = cube_frames.inputs(ctx)
    assert [len(c) for c in pool] == [8, 9, 10]
    footprint = cube_frames._footprint(ctx.config)
    x0, y0, r0, _ = ctx.config['disc']
    for cube in pool:
        assert cube.dtype == np.float32 and cube.shape[1:] == (41, 40)
        nan = np.isnan(cube)
        assert (nan == nan[0]).all()  # the same spaxels in every plane
        assert nan[0][~footprint].all()
        dead = nan[0] & footprint
        i, j = np.nonzero(dead)
        assert len(i) == 2 and (np.hypot(i - y0, j - x0) < 0.8 * r0).all()
        assert np.isfinite(cube[:, footprint & ~dead]).all()
    # the turned field's bounding box fits the frame with a margin
    rows, cols = np.nonzero(footprint)
    assert rows.min() >= 1 and cols.min() >= 1
    assert rows.max() <= 39 and cols.max() <= 38
    assert 0.4 < footprint.mean() < 0.45  # 24.6 x 28.5 of 40 x 41


def test_the_sound_program_is_correct():
    result = _run()
    assert result['correct'], result['checks']
    assert result['checks']['map_flips']['value'] == 0


def _altered(entry):
    """A map +1e-3."""
    return lambda cube: entry(cube) + 1e-3


def _half_left_out(entry):
    """Half of the planes left NaN."""
    def broken(cube):
        out = entry(cube).clone()
        out[out.shape[0] // 2:] = math.nan
        return out

    return broken


def _block_altered(entry):
    """One 8 x 32 block altered by 1e-3 at the last plane's last finite
    values."""
    def broken(cube):
        out = entry(cube).clone()
        i, j = (int(v) for v in torch.isfinite(out[-1]).nonzero()[-1])
        out[-1, max(i - 7, 0):i + 1, max(j - 31, 0):j + 1] += 1e-3
        return out

    return broken


@pytest.mark.parametrize('fault', [_altered, _half_left_out, _block_altered],
                         ids=['answer_altered', 'half_left_out', 'block_altered'])
def test_a_fault_is_not_correct(fault):
    assert not _run(stand_in=fault)['correct']


def test_the_control_is_not_correct():
    readings = control.readings(CELL, [SEED, SEED + 1], 3, device='cpu',
                                overrides=SMALL)
    assert not any(r['correct'] for r in readings)
    # by the gap alone: the float32 reference flips no value
    assert all(r['checks']['map_flips']['value'] == 0 for r in readings)


def _pchip_control(seeds, device='cuda', overrides=None):
    return [harness.run_cell(CELL, seed, 0.0, False, device=device,
                             overrides=overrides, stand_in='control_pchip',
                             steps=3) for seed in seeds]


def test_the_float32_pchip_alone_is_not_correct():
    """The reference with only its PCHIP grid in float32 (the sampler's
    coordinates in float64): not correct, by the gap alone."""
    for result in _pchip_control([SEED, SEED + 1], 'cpu', SMALL):
        assert not result['correct']
        assert result['checks']['map_flips']['value'] == 0


def test_a_traced_run_reads_the_idle_metric_and_counts_the_work():
    """On the CPU the trace holds the program's map spans, the smooth
    stage's among them, and no kernel: ``map_idle_ms`` reads, the device's
    idle share and the roofline readers find nothing."""
    result = _run(steps=3, trace=True)
    assert result['correct']
    assert result['metrics']['map_idle_ms']['value'] > 0
    assert 'device_idle' not in result['metrics']
    assert 'pchip_roofline' not in result['metrics']
    assert 'map_smooth_roofline' not in result['metrics']


def test_counts_and_bounds_of_the_cell(tmp_path):
    """The counts behind the two roofline readers against what the
    shapes give: the box and grid of the 1 degree map at r0 = 8.79, every
    plane with the same NaN cells, both passes' finite cells."""
    ctx = _ctx(SEED, tmp_path)
    ctx.config['map'] = {'degree_interval': 1}
    state = SimpleNamespace(ctx=ctx, scene=rn.Scene(SEED),
                            et=program.epoch(ctx.config),
                            pool=cube_frames.inputs(ctx)[0])
    x, y = cube_frames._reference_xy(state)
    c = cube_frames._counts(state, state.pool[0], x.reshape(-1), y.reshape(-1))
    assert c['planes'] == 8 and c['samples'] == 180 * 360
    # the disc spans about 2 r0 = 17.6 px; the box pads it by 5 a side
    assert 26 <= math.isqrt(c['box_cells']) <= 30
    assert c['grid_values'] > 20 * c['box_cells']
    assert 0 < c['live_samples'] < c['valid_samples'] < c['samples']
    # the rows' pass reads at most the box, the columns' at most 5 times it
    assert 0 < c['finite_cells'] < 6 * c['box_cells']
    assert 0 < c['evaluated'] < c['grid_values'] + 5 * c['box_cells']
    assert 0 < c['grid_read'] <= c['grid_values']
    assert 0 < c['image_cells'] <= 41 * 40
    pchip_ms, sampler_ms = cube_frames._bounds(c)
    hbm = 3.35e12
    # the oversampling is bound by bytes: the box in and the grid out
    assert pchip_ms >= 8 * 8 * (c['box_cells'] + c['grid_values']) / hbm * 1e3
    # the sampler: validity, x and y, the float32 maps, one flag a plane
    least = (c['samples'] + 16 * c['valid_samples'] + 4 * 8 * c['samples'] + 8
             + 8 * 8 * c['grid_read'] + 8 * c['image_cells'])
    assert sampler_ms == pytest.approx(max(least / hbm * 1e3,
                                           (6 * c['live_samples']
                                            + 11 * 8 * c['live_samples'])
                                           / 34e12 * 1e3))
    state.counts = [c, c, c]
    state.traced = [0, 1, 2, 0]
    work = cube_frames.work(state)
    assert work['pchip']['patterns'] == ['pchip_axis_kernel']
    assert work['map_smooth']['patterns'] == ['map_smooth_kernel']
    assert work['pchip']['bound_ms_per_step'] == pytest.approx(pchip_ms)


@pytest.mark.cuda
def test_the_control_fails_at_the_cell_size_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the control at the cell size')
    readings = control.readings(CELL, [11, 12, 13], 3)
    assert not any(r['correct'] for r in readings)
    assert not any(r['correct'] for r in _pchip_control([11, 12, 13]))


def test_the_neptune_reference_loads_neither_jax_nor_the_program():
    from test_bench_imports import JAX, _top_level_modules

    loaded = _top_level_modules(
        'import port_bench.reference.scene_neptune, '
        'port_bench.reference.smooth, port_bench.vendor.bounds_smooth, '
        'port_bench.vendor.synthetic_kernels_neptune')
    assert not loaded & (JAX | {'planetmapper_tpu_torch'})
