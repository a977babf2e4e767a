"""
The ``nirc2_1024.save_observation`` cell on the CPU at a small size (a 64^2
frame, 2 files, the disc scaled with the frame): its driver, the check that
decides ``correct`` (the sound program passes; the control and each fault
planted in a saved file do not), the run directory's size, the plain FITS
reader and writer against the program's, and what a traced run reads. On a
card, the control at the cell's own size comes out not correct on three
seeds.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED
from port_bench import control, harness
from port_bench.reference import fits_plain
from port_bench.traffic import save_frames

CELL = 'nirc2_1024.save_observation'
SIZE = 64
SMALL = {'config': {'frame': [SIZE, SIZE],
                    'disc': [32.0, 32.0, 469.0 * SIZE / 1024, 0.0],
                    'disc_jitter_px': 16.0 * SIZE / 1024, 'files': 2},
         'traffic': {'warmup_steps': 1}}


def _ctx(seed, tmp_path):
    files = harness.cell_files(harness.load_json(ROOT / 'BENCHMARK.json'),
                               CELL)
    return SimpleNamespace(
        config=dict(files.config, **SMALL['config']),
        traffic=dict(files.traffic, **SMALL['traffic']), check=files.check,
        seed=seed, device=torch.device('cpu'), cuda=False,
        kernel_dir=str(tmp_path), stand_in=None, Reservoir=harness.Reservoir)


def _run(stand_in=None, steps=3, trace=False):
    return harness.run_cell(CELL, SEED, 0.0, trace, device='cpu',
                            overrides=SMALL, stand_in=stand_in, steps=steps)


def test_same_seed_same_files_other_seed_other_files(tmp_path):
    big = 2**31 + 977
    a = save_frames.inputs(_ctx(big, tmp_path))
    b = save_frames.inputs(_ctx(big, tmp_path))
    c = save_frames.inputs(_ctx(big + 1, tmp_path))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    assert not np.array_equal(a[0], c[0])


def test_the_sequence_of_the_deployment(tmp_path):
    """8 files 120 s apart, each disc within 16 px of the frame's centre,
    r0 469 px and rotation 0; a float32 frame of the disc plus noise."""
    files = harness.cell_files(harness.load_json(ROOT / 'BENCHMARK.json'),
                               CELL)
    cfg = files.config
    dates = save_frames.dates(cfg)
    assert len(dates) == 8
    assert [(d - dates[0]).total_seconds() for d in dates] == \
        [120.0 * k for k in range(8)]
    ets = [save_frames.epoch(d) for d in dates]
    assert np.allclose(np.diff(ets), 120.0, atol=1e-6)
    ctx = _ctx(5, tmp_path)
    ctx.config = dict(cfg, frame=[SIZE, SIZE])
    discs, frames, order = save_frames.inputs(ctx)
    assert discs.shape == (8, 4) and set(np.unique(order)) == set(range(8))
    assert (np.abs(discs[:, :2] - 512.0) <= 16.0).all()
    assert (discs[:, 2] == 469.0).all() and (discs[:, 3] == 0.0).all()
    assert frames.shape == (8, 1, SIZE, SIZE) and frames.dtype == np.float32


def test_the_port_opens_the_plain_writers_file(tmp_path):
    """The input file as ``fits_plain`` writes it: the port's Observation
    reads the same frame, the cards by value, the date and the disc."""
    import planetmapper_tpu_torch as pt
    from port_bench.vendor.synthetic_kernels import write_synthetic_kernels

    ctx = _ctx(SEED, tmp_path)
    discs, frames, _ = save_frames.inputs(ctx)
    date = save_frames.dates(ctx.config)[1]
    cards = save_frames.header_cards(ctx.config, 1, date, discs[1])
    path = tmp_path / 'frame.fits'
    fits_plain.write(path, [(cards, frames[1])])
    assert path.stat().st_size % 2880 == 0
    write_synthetic_kernels(tmp_path / 'kernels', SEED)
    pt.clear_kernels()
    pt.set_kernel_path(tmp_path / 'kernels')
    obs = pt.Observation(path, observer='EARTH', device='cpu')
    np.testing.assert_array_equal(obs.data, frames[1])
    for keyword, value, _ in cards:
        key = f'HIERARCH {keyword}' if ' ' in keyword else keyword
        assert obs.header[key] == value
    assert obs.utc.startswith('2005-01-01T00:02:00')
    assert obs.et == pytest.approx(save_frames.epoch(date), abs=1e-6)
    assert obs.get_disc_method() == 'header'
    assert obs.get_disc_params() == tuple(float(v) for v in discs[1])


def test_the_plain_reader_reads_the_ports_file(tmp_path):
    """A file of the port's writer: the same data, names and card values
    (HIERARCH, strings with quotes, booleans, integers, comments)."""
    from planetmapper_tpu_torch.io import fits

    rng = np.random.default_rng(3)
    header = fits.Header([('OBJECT', "O'Brien"), ('FLAG', True),
                          ('COUNT', 7), ('SMALL', 1.5e-12)])
    header['HIERARCH PLANMAP DISC X0'] = 511.123456789
    header.add_comment('a comment')
    cube = rng.standard_normal((2, 5, 7)).astype(np.float32)
    plane = rng.standard_normal((5, 7))
    plane[1, 2] = np.nan
    path = tmp_path / 'port.fits'
    fits.HDUList([fits.PrimaryHDU(data=cube, header=header),
                  fits.ImageHDU(data=plane, name='EMISSION')]).writeto(path)
    hdus = fits_plain.read(path)
    assert [h.name for h in hdus] == ['', 'EMISSION']
    np.testing.assert_array_equal(hdus[0].data, cube)
    assert hdus[0].data.dtype == np.float32
    np.testing.assert_array_equal(hdus[1].data, plane)
    assert hdus[1].structure['BITPIX'] == -64
    assert hdus[0].get('OBJECT') == "O'Brien"
    assert hdus[0].get('FLAG') is True and hdus[0].get('COUNT') == 7
    assert hdus[0].get('SMALL') == 1.5e-12
    assert hdus[0].get('PLANMAP DISC X0') == 511.123456789
    assert hdus[0].get('COMMENT') == 'a comment'


def test_the_plain_writer_round_trips(tmp_path):
    data = np.arange(12, dtype=np.float64).reshape(3, 4) / 7
    cards = [('NAME', 'value', 'a comment'), ('PLANMAP DISC R0', 469.0, None),
             ('EXTNAME', 'KM-X', None)]
    path = tmp_path / 'plain.fits'
    n = fits_plain.write(path, [([('OBJECT', 'JUPITER', None)], None),
                                (cards, data)])
    assert n == path.stat().st_size == 3 * 2880
    hdus = fits_plain.read(path)
    assert hdus[0].data is None and hdus[1].name == 'KM-X'
    assert hdus[1].cards == cards
    np.testing.assert_array_equal(hdus[1].data, data)


def test_the_sound_program_is_correct():
    result = _run()
    assert result['correct'], result['checks']
    checks = {k: v['value'] for k, v in result['checks'].items()}
    assert checks['hdus_missing'] == checks['data_changed'] == 0
    assert checks['disc_card_gap'] == 0


def _rewritten(entry, alter):
    """The program's save, then its file read back, altered by ``alter``
    (on the HDUs) and written again."""
    def broken(k, out):
        entry(k, out)
        hdus = fits_plain.read(out)
        hdus = alter(hdus) or hdus
        fits_plain.write(out, [(h.cards, h.data) for h in hdus])

    return broken


def _plane(hdus, name):
    return next(h for h in hdus if h.name == name)


def _emission_altered(hdus):
    """EMISSION +1 deg."""
    _plane(hdus, 'EMISSION').data += 1.0


def _block_altered(hdus):
    """An 8x32 block at the frame's last pixel of ANGULAR-X (finite
    everywhere), by 1e-3 arcsec."""
    _plane(hdus, 'ANGULAR-X').data[-8:, -32:] += 1e-3


def _hdu_left_out(hdus):
    return [h for h in hdus if h.name != 'LAT-GRAPHIC']


def _half_rows_nan(hdus):
    """The second half of ANGULAR-X's rows NaN."""
    data = _plane(hdus, 'ANGULAR-X').data
    data[data.shape[0] // 2:] = np.nan


def _primary_ulp(hdus):
    """One value of the primary HDU moved by one unit in the last place."""
    data = hdus[0].data
    data[0, 10, 20] = np.nextafter(data[0, 10, 20], np.float32(np.inf))


def _disc_card_altered(hdus):
    """``PLANMAP DISC X0`` moved by one unit in the last place."""
    hdus[0].cards = [
        (key, np.nextafter(value, np.inf) if key == 'PLANMAP DISC X0'
         else value, comment) for key, value, comment in hdus[0].cards]


FAULTS = {
    'emission_altered': (_emission_altered, 'plane_gap'),
    'block_altered': (_block_altered, 'plane_gap'),
    'hdu_left_out': (_hdu_left_out, 'hdus_missing'),
    'half_rows_nan': (_half_rows_nan, 'mask_flips'),
    'primary_ulp': (_primary_ulp, 'data_changed'),
    'disc_card_altered': (_disc_card_altered, 'disc_card_gap'),
}


@pytest.mark.parametrize('fault', FAULTS)
def test_a_fault_is_not_correct(fault):
    alter, caught_by = FAULTS[fault]
    result = _run(stand_in=lambda entry: _rewritten(entry, alter))
    assert not result['correct']
    check = result['checks'][caught_by]
    assert check['value'] > check['limit'], result['checks']


def test_the_control_is_not_correct():
    readings = control.readings(CELL, [SEED, SEED + 1], 3, device='cpu',
                                overrides=SMALL)
    assert not any(r['correct'] for r in readings)
    # by the planes: the float32 reference writes every HDU and card
    for r in readings:
        assert r['checks']['plane_gap']['value'] > \
            r['checks']['plane_gap']['limit']
        assert r['checks']['hdus_missing']['value'] == 0
        assert r['checks']['data_changed']['value'] == 0


def test_the_run_directory_holds_at_most_the_kept_files_and_two():
    """Over 7 steps (the reservoir of 4 takes some steps late) the run
    directory never holds more saved files than ``steps_checked`` + 2, and
    is gone after the run."""
    seen = {'most': 0, 'dir': None}

    def watched(entry):
        def run(k, out):
            entry(k, out)
            folder = os.path.dirname(out)
            seen['dir'] = folder
            saved = [n for n in os.listdir(folder)
                     if not n.startswith('frame_')]
            seen['most'] = max(seen['most'], len(saved))
        return run

    result = _run(stand_in=watched, steps=7)
    assert result['correct']
    steps_checked = harness.load_json(
        ROOT / 'port_bench' / 'workloads' / f'{CELL}.json')['steps_checked']
    assert 1 <= seen['most'] <= steps_checked + 2
    assert not os.path.exists(seen['dir'])


def test_a_traced_run_reads_the_export_and_fits_metrics():
    """On the CPU the trace holds the program's export and FITS spans and
    no kernel: ``export_idle_ms`` and ``fits_write_gbps`` read, the kernel
    count and the device's idle share find nothing."""
    result = _run(steps=2, trace=True)
    assert result['correct']
    metrics = result['metrics']
    assert metrics['export_idle_ms']['value'] > 0
    assert metrics['fits_write_gbps']['value'] > 0
    assert 'export_kernels' not in metrics and 'device_idle' not in metrics


def test_the_plain_fits_module_loads_neither_jax_nor_the_program():
    from test_bench_imports import JAX, _top_level_modules

    loaded = _top_level_modules('import port_bench.reference.fits_plain')
    assert not loaded & (JAX | {'planetmapper_tpu_torch', 'torch'})


@pytest.mark.cuda
def test_the_control_fails_at_the_cell_size_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the control at the cell size')
    readings = control.readings(CELL, [11, 12, 13], 3)
    assert not any(r['correct'] for r in readings)
