"""
The port's spans and counters (``planetmapper_tpu_torch.tracing``): with no
profiler recording a span enters no ``record_function`` and the traced
tally stays empty; under ``torch.profiler`` the stages of
``compute_backplanes``, of a 'linear' ``map_img`` and of an
``Observation``'s open and ``save_observation`` land on the profiler's
timeline, each inside the span that encloses it; the kernels' launch counts
read through their wrappers' functions are the registry's counters. The
``cuda``-marked cases run on a card (this file imports no JAX:
``python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -q``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import planetmapper_tpu_torch as tpm
from planetmapper_tpu_torch import host_slots, pipeline, tracing
from planetmapper_tpu_torch.ops import backplanes_kernel as bk
from planetmapper_tpu_torch.ops import dsk_kernel
from planetmapper_tpu_torch.ops import map_infill_kernel
from planetmapper_tpu_torch.ops import map_smooth_kernel as msk
from planetmapper_tpu_torch.ops import map_spline_kernel as msp
from planetmapper_tpu_torch.ops import pchip_kernel as pk
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
SIZE = 64
DISC = (32.0, 31.0, 20.0, 12.3)
MAP = dict(degree_interval=10)


@pytest.fixture(scope='module')
def kernel_path(tmp_path_factory):
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0)
    previous, source = tpm.get_kernel_path(return_source=True)
    tpm.clear_kernels()
    tpm.set_kernel_path(path)
    yield path
    tpm.clear_kernels()
    tpm.set_kernel_path(previous if source == 'set_kernel_path()' else None)


def _body(device):
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=SIZE,
                      ny=SIZE, device=device)
    body.set_disc_params(*DISC)
    return body


@pytest.fixture(scope='module')
def body(kernel_path):
    return _body('cpu')


@pytest.fixture(scope='module')
def frame():
    """A seeded frame with a NaN block, so that the infill runs."""
    img = np.random.default_rng(5).uniform(0.0, 1.0, (SIZE, SIZE))
    img[40:44, 20:25] = np.nan
    return img.astype(np.float32)


class _Entered(Exception):
    pass


class _RaisingRecordFunction:
    def __init__(self, *args, **kwargs):
        raise _Entered('record_function entered with no profiler recording')


def _spans(prof) -> list[tuple[float, float, str]]:
    """The trace's ``(start, end, name)`` of every span, in microseconds."""
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.name.startswith('pm.') or e.name == 'outer']


def _inside(spans, name, parent) -> list[tuple[float, float, str]]:
    """The spans ``name``, each asserted to lie inside one ``parent``."""
    found = [s for s in spans if s[2] == name]
    parents = [s for s in spans if s[2] == parent]
    assert found, f'no span {name}'
    for start, end, _ in found:
        assert any(p0 <= start and end <= p1 for p0, p1, _ in parents), \
            f'{name} outside {parent}'
    return found


def test_span_off_enters_no_record_function(monkeypatch, body, frame):
    """With no profiler recording, neither a span nor a whole call of the
    traced paths enters ``record_function``, and a span is the one shared
    do-nothing context."""
    assert not tracing.recording()
    monkeypatch.setattr(torch.profiler, 'record_function',
                        _RaisingRecordFunction)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function',
                        _RaisingRecordFunction)
    with tracing.span('pm.test.off'):
        pass
    assert tracing.span('pm.a') is tracing.span('pm.b')
    planes = pipeline.compute_backplanes(body)
    assert set(planes) == set(bk.PLANE_ORDER)
    out = body.map_img(frame, **MAP)
    assert torch.isfinite(out).any()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(_Entered):
            with tracing.span('pm.test.on'):
                pass


def test_untraced_counts_grow_and_traced_stay_empty():
    tracing.reset('test.untraced')
    tracing.count('test.untraced')
    tracing.count('test.untraced', 2)
    assert tracing.counts()['test.untraced'] == 3
    assert 'test.untraced' not in tracing.traced_counts()


def test_traced_tally_counts_only_inside_the_profiler_window():
    tracing.reset('test.window')
    tracing.count('test.window')
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        tracing.count('test.window', 5)
    tracing.count('test.window', 7)
    assert tracing.counts()['test.window'] == 13
    assert tracing.traced_counts()['test.window'] == 5
    tracing.reset('test.window')
    assert 'test.window' not in tracing.counts()
    assert 'test.window' not in tracing.traced_counts()


def test_reset_clears_both_tallies():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count('test.reset')
    assert tracing.traced_counts()['test.reset'] == 1
    saved = tracing.counts()
    tracing.reset()
    assert tracing.counts() == {} and tracing.traced_counts() == {}
    for name, n in saved.items():  # other tests' counters, put back
        tracing.count(name, n)


def test_compute_backplanes_spans_under_the_profiler(body):
    """The scene inputs and the copy to numpy inside the call's span, and
    the copy's fresh pages in the traced tally."""
    tracing.reset('pipeline.copy_fresh_pages')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('outer'):
            planes = pipeline.compute_backplanes(body)
    assert set(planes) == set(bk.PLANE_ORDER)
    spans = _spans(prof)
    assert len(_inside(spans, 'pm.pipeline.compute_backplanes', 'outer')) == 1
    _inside(spans, 'pm.scene.inputs', 'pm.pipeline.compute_backplanes')
    _inside(spans, 'pm.pipeline.to_numpy', 'pm.pipeline.compute_backplanes')
    pages = tracing.traced_counts()['pipeline.copy_fresh_pages']
    assert pages >= 0
    assert tracing.counts()['pipeline.copy_fresh_pages'] == pages
    # untraced, the copy reads no resident set
    pipeline.compute_backplanes(body)
    assert tracing.counts()['pipeline.copy_fresh_pages'] == pages


def test_resident_pages_only_while_a_profiler_records():
    assert tracing.resident_pages() is None
    with profile(activities=[ProfilerActivity.CPU]):
        before = tracing.resident_pages()
        block = np.ones(4 * 2**20 // 8)  # 4 MiB, touched
        after = tracing.resident_pages()
    assert isinstance(before, int) and after >= before
    assert float(block[-1]) == 1.0


@pytest.mark.parametrize('resident, fresh', [((100, 160), 60),
                                             ((100, 90), 0)])
def test_copy_counts_the_growth_of_the_resident_set(monkeypatch, resident,
                                                    fresh):
    """The copy counts the pages it newly made resident, none where the
    resident set shrank over it."""
    reads = iter(resident)
    monkeypatch.setattr(tracing, 'resident_pages', lambda: next(reads))
    tracing.reset('pipeline.copy_fresh_pages')
    out = pipeline._to_numpy({'A': torch.zeros(2, 3)})
    assert out['A'].shape == (2, 3)
    assert tracing.counts()['pipeline.copy_fresh_pages'] == fresh


def test_map_img_spans_under_the_profiler(body, frame):
    """A 'linear' map_img of a frame with a NaN block: the upload, the
    samples, the float64 copy, the flags, the infill, the solve and the
    spline, each once and inside the call."""
    body.map_img(frame, **MAP)  # the x/y maps, outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('outer'):
            out = body.map_img(frame, **MAP)
    assert torch.isfinite(out).any()
    spans = _spans(prof)
    for name in ('pm.map.upload', 'pm.map.samples', 'pm.map.to_float64',
                 'pm.map.flags', 'pm.map.infill', 'pm.map.solve',
                 'pm.map.spline'):
        assert len(_inside(spans, name, 'outer')) == 1
    order = [s[2] for s in sorted(spans) if s[2] != 'outer']
    assert order == ['pm.map.upload', 'pm.map.samples', 'pm.map.to_float64',
                     'pm.map.flags', 'pm.map.infill', 'pm.map.solve',
                     'pm.map.spline']


def test_map_img_of_a_finite_frame_infills_no_frame(body, frame,
                                                   monkeypatch):
    """A finite frame is passed through: no frame's infill runs. The
    stage's span stays, as every stage's does (on a card the infill kernel
    runs on every frame and finds on the device that none needs it)."""
    body.map_img(frame, **MAP)

    def no_infill(frame):
        raise AssertionError('a finite frame was infilled')

    monkeypatch.setattr(map_infill_kernel, 'infill_plain', no_infill)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body.map_img(np.nan_to_num(frame), **MAP)
    names = {s[2] for s in _spans(prof)}
    assert {'pm.map.flags', 'pm.map.infill', 'pm.map.solve',
            'pm.map.spline'} <= names


def test_map_img_counts_the_solves_it_skips(body, frame):
    """'linear' skips both axes' products of each frame, 'cubic' runs
    both; the traced tally counts them while the profiler records."""
    body.map_img(frame, **MAP)
    tracing.reset('map.solves', 'map.solve_skipped')
    cube = np.stack([frame, frame[::-1]])
    with profile(activities=[ProfilerActivity.CPU]):
        body.map_img(cube, **MAP)
        body.map_img(frame, interpolation='cubic', **MAP)
    traced = tracing.traced_counts()
    assert traced['map.solve_skipped'] == 4
    assert traced['map.solves'] == 2


UPLOAD_COUNTERS = ('map.upload_staged', 'map.upload_plain',
                   'map.upload_bytes', 'map.upload_waits')


def _upload_counts(run) -> dict[str, int]:
    """The upload counters' traced tallies over ``run()`` under a
    profiler, and its program spans."""
    tracing.reset(*UPLOAD_COUNTERS)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()
    traced = tracing.traced_counts()
    return {n: traced.get(n, 0) for n in UPLOAD_COUNTERS}, _spans(prof)


def test_map_img_counts_its_upload(body, frame):
    """A CPU body takes the plain copy: one upload, the frame's bytes, no
    staging span; the untraced tally counts it too."""
    body.map_img(frame, **MAP)
    counted, spans = _upload_counts(lambda: body.map_img(frame, **MAP))
    assert counted == {'map.upload_staged': 0, 'map.upload_plain': 1,
                       'map.upload_bytes': frame.nbytes,
                       'map.upload_waits': 0}
    assert 'pm.map.upload.stage' not in {s[2] for s in spans}
    body.map_img(torch.from_numpy(frame), **MAP)
    assert tracing.counts()['map.upload_plain'] == 2


def test_launch_counts_read_the_registry():
    """The wrappers' launch counts are the registry's counters, and a reset
    clears the one counter only."""
    tracing.reset(msp.LIBRARY.counter, bk.BATCH_COUNTER)
    tracing.count(msp.LIBRARY.counter, 3)
    tracing.count(bk.BATCH_COUNTER, 2)
    assert msp.launch_count() == 3 and msp.LIBRARY.launch_count() == 3
    assert bk.batch_launch_count() == 2
    msp.reset_launch_count()
    assert msp.launch_count() == 0 and bk.batch_launch_count() == 2
    bk.reset_batch_launch_count()
    assert bk.batch_launch_count() == 0
    dsk_kernel.reset_launch_count()
    dsk_kernel._count('dsk_atan2')
    assert dsk_kernel.launch_count('dsk_atan2') == 1
    assert dsk_kernel.launch_count('dsk_pairs') == 0
    assert tracing.counts()['launches.dsk.dsk_atan2'] == 1
    dsk_kernel.reset_launch_count()
    assert {lib.LIBRARY.counter for lib in (bk, msp, msk, pk)} == {
        'launches.backplanes26', 'launches.map_spline', 'launches.map_smooth',
        'launches.pchip'}


EXPORT_COUNTERS = ('export.planes', 'fits.hdus_written',
                   'fits.bytes_written')


@pytest.fixture(scope='module')
def observation_file(kernel_path, tmp_path_factory):
    """A one-frame file whose header names the target, the date and the
    disc (the ``PLANMAP DISC`` cards), as a navigated instrument file."""
    from planetmapper_tpu_torch.io import fits

    header = fits.Header([('OBJECT', 'JUPITER'),
                          ('DATE-OBS', '2005-01-01T00:02:00'),
                          ('TELESCOP', 'Keck II'), ('INSTRUME', 'NIRC2')])
    for key, value in zip(('X0', 'Y0', 'R0', 'ROT'), DISC):
        header[f'HIERARCH PLANMAP DISC {key}'] = value
    data = np.random.default_rng(7).standard_normal((1, SIZE, SIZE))
    path = tmp_path_factory.mktemp('observation') / 'frame.fits'
    fits.HDUList([fits.PrimaryHDU(data=data.astype(np.float32),
                                  header=header)]).writeto(path)
    return path


def _save(path, out):
    obs = tpm.Observation(path, observer='EARTH', device='cpu')
    obs.save_observation(out, include_wireframe=False, print_info=False)
    return obs


def test_save_observation_spans_and_counters_under_the_profiler(
        observation_file, tmp_path):
    """An open and a save under a profiler: one ``pm.obs.open``, the
    primary HDU's parts, a ``pm.export.plane`` a backplane, and an encode
    and a write a HDU, each write after its encode; the traced counters
    count the 26 planes, the 27 HDUs and every byte of the file."""
    tracing.reset(*EXPORT_COUNTERS)
    out = tmp_path / 'saved.fits'
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('outer'):
            obs = _save(observation_file, out)
    assert obs.get_disc_method() == 'header'
    spans = _spans(prof)
    assert len(_inside(spans, 'pm.obs.open', 'outer')) == 1
    assert len(_inside(spans, 'pm.export.primary', 'outer')) == 1
    planes = _inside(spans, 'pm.export.plane', 'outer')
    assert len(planes) == len(obs.backplanes) == 26
    encodes = sorted(_inside(spans, 'pm.fits.encode', 'outer'))
    writes = sorted(_inside(spans, 'pm.fits.write', 'outer'))
    assert len(encodes) == len(writes) == 27
    for (_, encoded, _), (written, _, _) in zip(encodes, writes):
        assert encoded <= written
    assert max(s[1] for s in planes) <= encodes[0][0]
    traced = tracing.traced_counts()
    assert traced['export.planes'] == 26
    assert traced['fits.hdus_written'] == 27
    assert traced['fits.bytes_written'] == out.stat().st_size
    assert out.stat().st_size % 2880 == 0


def test_save_observation_records_nothing_without_a_profiler(
        monkeypatch, observation_file, tmp_path):
    """Untraced, the open and the save enter no ``record_function`` and
    leave the traced tallies as they were; the counters still count."""
    assert not tracing.recording()
    monkeypatch.setattr(torch.profiler, 'record_function',
                        _RaisingRecordFunction)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function',
                        _RaisingRecordFunction)
    tracing.reset(*EXPORT_COUNTERS)
    out = tmp_path / 'untraced.fits'
    _save(observation_file, out)
    traced = tracing.traced_counts()
    assert not set(EXPORT_COUNTERS) & set(traced)
    counts = tracing.counts()
    assert counts['export.planes'] == 26
    assert counts['fits.hdus_written'] == 27
    assert counts['fits.bytes_written'] == out.stat().st_size


@pytest.fixture(scope='module')
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_kernel1_spans_and_launch_count_on_the_card(kernel_path, device):
    """On the card: the scene's packing and kernel 1's launch inside the
    call's span, and the launch counted where ``launch_count`` reads."""
    card = _body(device)
    pipeline.compute_backplanes(card)  # builds and loads the library
    before = bk.launch_count()
    assert tracing.counts()['launches.backplanes26'] == before
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('outer'):
            pipeline.compute_backplanes(card)
        torch.cuda.synchronize()
    assert bk.launch_count() == before + 1
    assert tracing.traced_counts()['launches.backplanes26'] >= 1
    spans = _spans(prof)
    for name in ('pm.scene.inputs', 'pm.scene.pack', 'pm.kernel1.launch',
                 'pm.pipeline.to_numpy'):
        _inside(spans, name, 'pm.pipeline.compute_backplanes')


@pytest.mark.cuda
def test_map_spline_launch_counted_on_the_card(kernel_path, device, frame):
    card = _body(device)
    card.map_img(frame, **MAP)
    before = msp.launch_count()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        card.map_img(frame, **MAP)
        torch.cuda.synchronize()
    assert msp.launch_count() == before + 1
    assert tracing.counts()['launches.map_spline'] == before + 1
    assert {'pm.map.upload', 'pm.map.infill', 'pm.map.spline'} <= {
        s[2] for s in _spans(prof)}


@pytest.mark.cuda
def test_map_img_stages_its_upload_on_the_card(kernel_path, device):
    """A card body stages a host frame of several chunks: one staged upload,
    its bytes, a ``pm.map.upload.stage`` span a chunk inside
    ``pm.map.upload``; a frame already on the card takes the plain copy."""
    card = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=2048,
                      ny=1536, device=device)
    card.set_disc_params(1024.0, 768.0, 500.0, 12.3)
    img = np.random.default_rng(6).standard_normal((1536, 2048)).astype(
        np.float32)
    card.map_img(img, **MAP)
    counted, spans = _upload_counts(lambda: card.map_img(img, **MAP))
    torch.cuda.synchronize()
    assert counted['map.upload_staged'] == 1
    assert counted['map.upload_plain'] == 0
    assert counted['map.upload_bytes'] == img.nbytes
    stages = _inside(spans, 'pm.map.upload.stage', 'pm.map.upload')
    assert len(stages) == len(host_slots.chunk_plan(img.nbytes))
    on_card = torch.as_tensor(img, device=device)
    counted, _ = _upload_counts(lambda: card.map_img(on_card, **MAP))
    assert counted['map.upload_plain'] == 1
    assert counted['map.upload_staged'] == 0
