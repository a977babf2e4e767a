"""
The 'smooth' map of an IFU cube and a second body, Neptune, on the port's
normal path, held to the benchmark's plain reference (``port_bench/``: the
synthetic kernels with Neptune, its scene worked out from the analytic
orbit and pck00010's constants, and upstream's 'smooth' mode written
plainly in float64), on the CPU at the ``neptune_mrs`` deployment's frame
(40 x 41 spaxels, Neptune's disc centred, NaN outside the field's footprint
and at two dead spaxels) with 8 planes and a 10 degree map. Neptune's
scene and x/y maps are also held to the JAX package's ``BodyXY`` on the
same kernel files. Also the smooth and nearest branches' spans and the map
counters under a CPU profiler. The test cubes are made here.

The reference's PCHIP is checked against scipy's ``PchipInterpolator``
where scipy is installed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import planetmapper_tpu_torch as tpm
from planetmapper_tpu_torch import tracing
from planetmapper_tpu_torch.ops import pchip_device
from planetmapper_tpu_torch.pipeline import compute_scene_anchors
from port_bench.reference import scene as rs
from port_bench.reference import scene_neptune as rn
from port_bench.reference import smooth as rsm
from port_bench.vendor.synthetic_kernels_neptune import (
    write_synthetic_kernels,
)

BENCH = Path(__file__).resolve().parents[1] / 'port_bench'
UTC = '2005-01-01T00:00:00'
#: One seed for every body of this file: the port keeps one scene engine
#: per ephemeris and epoch for a process's life (PERF.md, Open questions)
SEED = 0
#: The deployment, as the benchmark runs it
CONFIG = json.loads((BENCH / 'configs' / 'neptune_mrs.json').read_text())
NX, NY = CONFIG['frame']
DISC = tuple(CONFIG['disc'])
MAP = dict(degree_interval=10)
PLANES = 8


@pytest.fixture(scope='module')
def kernel_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp('synthetic_kernels_neptune')
    write_synthetic_kernels(path, SEED)
    return path


@pytest.fixture(scope='module')
def neptune(kernel_dir):
    path = kernel_dir
    previous, source = tpm.get_kernel_path(return_source=True)
    tpm.clear_kernels()
    tpm.set_kernel_path(path)
    body = tpm.BodyXY('NEPTUNE', observer='EARTH', utc=UTC, nx=NX, ny=NY,
                      device='cpu', aberration_correction='CN')
    body.set_disc_params(*DISC)
    yield body
    tpm.clear_kernels()
    tpm.set_kernel_path(previous if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def reference(neptune):
    scene = rn.Scene(SEED)
    anchors = {k: v[0] for k, v in scene.anchors([neptune.et]).items()}
    return scene, anchors


def _footprint() -> np.ndarray:
    """(ny, nx) bool: the spaxels whose centre lies in the field, turned
    by its position angle about the frame's centre."""
    w, h = (v / CONFIG['plate_scale_arcsec'] for v in CONFIG['field_arcsec'])
    pa = math.radians(CONFIG['field_position_angle_deg'])
    y, x = np.mgrid[0:NY, 0:NX].astype(np.float64)
    dx, dy = x - (NX - 1) / 2, y - (NY - 1) / 2
    u = dx * math.cos(pa) + dy * math.sin(pa)
    v = -dx * math.sin(pa) + dy * math.cos(pa)
    return (np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)


def _cube(seed: int, planes: int = PLANES) -> np.ndarray:
    """A limb-darkened disc times a smooth spectrum per spaxel plus 1%
    noise; NaN outside the turned field and at two spaxels on the disc."""
    rng = np.random.default_rng(seed)
    x0, y0, r0, _ = DISC
    y, x = np.mgrid[0:NY, 0:NX].astype(np.float64)
    rr = np.hypot(x - x0, y - y0) / r0
    disc = np.sqrt(np.clip(1.0 - rr**2, 0.0, None)) ** 0.5
    t = np.linspace(0.0, 1.0, planes)[:, None, None]
    amp, freq, phase = (rng.uniform(lo, hi, 6) for lo, hi in
                        ((0.02, 0.2), (0.5, 8.0), (0.0, 2 * np.pi)))
    spectrum = 1.0 + np.sin(2 * np.pi * freq * t + phase).dot(amp)[..., None]
    slope = rng.uniform(-0.2, 0.2, (NY, NX))
    cube = disc * spectrum * (1.0 + slope * (t - 0.5))
    cube += 0.01 * rng.standard_normal(cube.shape)
    cube[:, ~_footprint()] = np.nan
    dead = rng.choice(np.flatnonzero(rr.ravel() < 0.8), 2, replace=False)
    cube.reshape(planes, -1)[:, dead] = np.nan
    return cube.astype(np.float32)


# --------------------------------------------------------------------------
# Neptune's scene against the reference
# --------------------------------------------------------------------------

SCENE_KEYS = ('tau0', 'rot0', 'rot1', 'rot2', 'targ_pos0', 'targ_vel0',
              'obs_pos', 'obs_vel', 'target_lt', 'target_obsvec',
              'subpoint_targvec', 'subpoint_rayvec', 'subpoint_obsvec',
              'subpoint_distance', 'obsvec2angular')


@pytest.mark.parametrize('key', SCENE_KEYS)
def test_scene_values_match_the_reference(neptune, reference, key):
    """Each per-scene value within 1e-10 of its size, as the Jupiter
    scene is held."""
    value = np.asarray(compute_scene_anchors(neptune)[key])
    scale = max(np.max(np.abs(value)), 1e-300)
    err = np.max(np.abs(reference[1][key].numpy() - value))
    assert err <= 1e-10 * scale, (key, err, scale)


def test_the_prime_meridian_term_is_in_the_rotation(neptune, reference):
    """Neptune's rotation leaves out no nutation-precession term: the
    reference without the prime meridian's term differs from the port by
    far more than the bar above."""
    scene, anchors = reference
    frame = rn.NeptuneFrame()
    frame.nut_pm = torch.zeros_like(frame.nut_pm)
    without = frame.matrix(anchors['tau0'][None])[0].numpy()
    rot0 = np.asarray(compute_scene_anchors(neptune)['rot0'])
    assert np.max(np.abs(without - rot0)) > 1e-6
    assert np.max(np.abs(anchors['rot0'].numpy() - rot0)) < 1e-12


def test_subpoint_and_diameter(neptune, reference):
    _, anchors = reference
    lon = math.degrees(math.atan2(-float(anchors['subpoint_targvec'][1]),
                                  float(anchors['subpoint_targvec'][0])))
    assert abs((neptune.subpoint_lon - lon % 360 + 180) % 360 - 180) < 1.0
    diameter = float(anchors['diameter_arcsec'])
    assert 2.28 < diameter < 2.29
    assert DISC[2] == pytest.approx(diameter / (2 * 0.13), rel=1e-3)


@pytest.mark.parametrize('axis', ['x', 'y'])
def test_xy_maps_match_the_reference(neptune, reference, axis):
    """The pixel coordinates of the map's samples, each at its own
    light-time epoch: the same visible samples, within 1e-10 of the
    frame's size."""
    scene, anchors = reference
    m = rs.xy2angular(DISC, anchors['diameter_arcsec'][None])[0]
    np.testing.assert_allclose(m.numpy(), neptune._get_xy2angular_matrix(),
                               rtol=1e-12, atol=1e-15)
    x, y = rn.xy_maps(scene, anchors, m, NX, NY, 10, 'cpu')
    ref = (x if axis == 'x' else y).numpy()
    got = (neptune.get_x_map if axis == 'x' else neptune.get_y_map)(**MAP)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isfinite(got).sum() > 100
    assert np.nanmax(np.abs(got - ref)) <= 1e-10 * max(NX, NY)


# --------------------------------------------------------------------------
# Neptune's scene and x/y maps against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope='module')
def jax_neptune(kernel_dir, neptune):
    """The JAX package's BodyXY of the same scene on the same kernel files
    (imported here, so that the card's tests below need no JAX)."""
    jpm = pytest.importorskip('planetmapper_tpu')
    previous, source = jpm.get_kernel_path(return_source=True)
    jpm.clear_kernels()
    jpm.set_kernel_path(kernel_dir)
    body = jpm.BodyXY('NEPTUNE', observer='EARTH', utc=UTC, nx=NX, ny=NY,
                      aberration_correction='CN')
    body.set_disc_params(*DISC)
    yield body
    jpm.clear_kernels()
    jpm.set_kernel_path(previous if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def jax_anchors(jax_neptune):
    from planetmapper_tpu import pipeline as j_pipeline

    return j_pipeline.compute_scene_anchors(jax_neptune)


@pytest.mark.parametrize('key', SCENE_KEYS)
def test_scene_values_match_jax(neptune, jax_anchors, key):
    """Each per-scene value, the rotation with Neptune's nutation terms
    among them, within 1e-10 of its size of the JAX package's."""
    value = np.asarray(compute_scene_anchors(neptune)[key])
    ref = np.asarray(jax_anchors[key], dtype=np.float64)
    scale = max(np.max(np.abs(ref)), 1e-300)
    err = np.max(np.abs(ref - value))
    assert err <= 1e-10 * scale, (key, err, scale)


def test_subpoint_and_target_match_jax(neptune, jax_neptune):
    for attr in ('subpoint_lon', 'subpoint_lat', 'target_ra', 'target_dec',
                 'target_distance', 'subsol_lon', 'subsol_lat'):
        ref = float(getattr(jax_neptune, attr))
        assert getattr(neptune, attr) == pytest.approx(ref, rel=1e-10,
                                                        abs=1e-10), attr


@pytest.mark.parametrize('axis', ['x', 'y'])
def test_xy_maps_match_jax(neptune, jax_neptune, axis):
    """The same visible samples, within 3e-15 rad of sky angle, the bar
    the Jupiter maps are held to (2e-9 px at 0.31 arcsec/px,
    ``test_torch_map.py``): some 14 ulps of the 4.5e9 km vectors that the
    two packages' light-time solutions round differently."""
    getter = 'get_x_map' if axis == 'x' else 'get_y_map'
    bar_px = 3e-15 * math.degrees(3600) / CONFIG['plate_scale_arcsec']
    ref = np.asarray(getattr(jax_neptune, getter)(**MAP))
    got = getattr(neptune, getter)(**MAP)
    assert got.shape == ref.shape == (18, 36)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isfinite(ref).sum() > 100
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar_px,
                               equal_nan=True)


# --------------------------------------------------------------------------
# The 'smooth' stage against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize('seed', [1, 2])
def test_box_and_oversampled_grids_match_the_reference(neptune, seed):
    """The padded box, the oversampling factors and the PCHIP grids of a
    cube (rows, then columns), to float64 rounding."""
    samples = neptune._get_map_samples(**MAP)
    box = pchip_device.smooth_box(samples.limits, NY, NX)
    x = torch.as_tensor(neptune.get_x_map(**MAP)).reshape(-1)
    y = torch.as_tensor(neptune.get_y_map(**MAP)).reshape(-1)
    assert box == rsm.box(x, y, NY, NX)
    iy0, iy1, ix0, ix1 = box
    ky = pchip_device.pick_rep(iy1 - iy0, 5, 10_000)
    kx = pchip_device.pick_rep(ix1 - ix0, 5, 10_000)
    assert (ky, kx) == (rsm.factor(iy1 - iy0, 5, 10_000),
                        rsm.factor(ix1 - ix0, 5, 10_000)) == (5, 5)
    frames = torch.as_tensor(_cube(seed)).double()
    got = pchip_device.oversample_frames(frames, box, ky, kx)
    ref = rsm.oversample(frames, box, ky, kx)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(torch.isnan(got), torch.isnan(ref))
    assert torch.isnan(ref).any() and torch.isfinite(ref).any()
    both = torch.isfinite(ref)
    assert torch.max(torch.abs(got[both] - ref[both])) <= 1e-13


@pytest.mark.parametrize('propagate_nan', [True, False])
@pytest.mark.parametrize('seed', [3, 4])
def test_smooth_map_of_a_cube_matches_the_reference(neptune, seed,
                                                    propagate_nan):
    """``map_img(cube, 'smooth')`` against the reference on the port's own
    x/y maps: every value the float32 rounding of the reference's float64
    value, to float64 rounding, and no value finite on one side only."""
    cube = _cube(seed)
    got = neptune.map_img(cube, interpolation='smooth',
                          propagate_nan=propagate_nan, **MAP).numpy()
    assert got.shape == (PLANES, 18, 36) and got.dtype == np.float32
    x = torch.as_tensor(neptune.get_x_map(**MAP)).reshape(-1)
    y = torch.as_tensor(neptune.get_y_map(**MAP)).reshape(-1)
    ref = rsm.smooth(torch.as_tensor(cube).double(), x, y,
                     propagate_nan=propagate_nan).reshape(got.shape).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    both = np.isfinite(ref)
    bar = 0.5 * np.spacing(np.abs(ref[both]).astype(np.float32)) + 1e-12
    assert np.all(np.abs(got[both] - ref[both]) <= bar)
    if propagate_nan:  # the dead spaxels' samples
        assert np.isnan(got).sum() > np.isnan(x.numpy()).sum() * PLANES


def test_smooth_map_against_the_reference_scene(neptune, reference):
    """The whole path, the reference's own x/y maps and all: as the
    benchmark's check compares, the largest gap within a float32 rounding
    of values of unit scale, no flip."""
    scene, anchors = reference
    m = rs.xy2angular(DISC, anchors['diameter_arcsec'][None])[0]
    x, y = rn.xy_maps(scene, anchors, m, NX, NY, 10, 'cpu')
    cube = _cube(5)
    got = neptune.map_img(cube, interpolation='smooth', **MAP).numpy()
    ref = rsm.smooth(torch.as_tensor(cube).double(), x.reshape(-1),
                     y.reshape(-1)).reshape(got.shape).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    both = np.isfinite(ref)
    assert np.max(np.abs(got[both] - ref[both])) < 2.5e-7


def test_an_all_nan_cube_maps_to_nan(neptune):
    cube = np.full((2, NY, NX), np.nan, dtype=np.float32)
    assert torch.isnan(neptune.map_img(cube, interpolation='smooth',
                                       **MAP)).all()
    x = torch.as_tensor(neptune.get_x_map(**MAP)).reshape(-1)
    y = torch.as_tensor(neptune.get_y_map(**MAP)).reshape(-1)
    assert torch.isnan(rsm.smooth(torch.as_tensor(cube).double(), x, y)).all()


@pytest.mark.parametrize('k', [1, 2, 5])
@pytest.mark.parametrize('kind', ['random', 'monotone', 'flat_runs'])
def test_reference_pchip_lines_match_scipy(k, kind):
    """Lines with NaN cells (none, some, all but one or two) against
    ``PchipInterpolator(extrapolate=False)`` on their finite cells."""
    interpolate = pytest.importorskip('scipy.interpolate')
    rng = np.random.default_rng([k, ('random', 'monotone', 'flat_runs').index(kind)])
    lines = []
    for n in (2, 3, 4, 7, 12, 29):
        for _ in range(6):
            v = rng.standard_normal(n)
            if kind == 'monotone':
                v = np.cumsum(np.abs(v))
            elif kind == 'flat_runs':
                v = np.round(v)
            v[rng.random(n) < 0.3] = np.nan
            lines.append(v)
    for v in lines:
        n = v.size
        got = rsm.pchip_lines(torch.as_tensor(v[None]), k)[0].numpy()
        positions = np.arange((n - 1) * k + 1) / k
        finite = np.isfinite(v)
        if finite.sum() < 2:
            ref = np.full(positions.shape, np.nan)
        else:
            ref = interpolate.PchipInterpolator(
                np.arange(n)[finite], v[finite], extrapolate=False)(positions)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        ok = np.isfinite(ref)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-13, atol=1e-13)


# --------------------------------------------------------------------------
# Spans and counters of the smooth and nearest branches
# --------------------------------------------------------------------------


def _spans(prof) -> list[tuple[float, float, str]]:
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.name.startswith('pm.') or e.name == 'outer']


def _traced(run):
    """The spans' names in order and the traced tallies of the map
    counters over ``run()`` under a CPU profiler."""
    names = ('map.frames', 'map.smooth_grid_values')
    tracing.reset(*names)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function('outer'):
            run()
    spans = _spans(prof)
    (outer,) = [s for s in spans if s[2] == 'outer']
    inner = sorted(s for s in spans if s[2] != 'outer')
    assert all(outer[0] <= s[0] and s[1] <= outer[1] for s in inner)
    counted = tracing.traced_counts()
    return [s[2] for s in inner], {n: counted.get(n, 0) for n in names}


def test_smooth_spans_and_counters_under_the_profiler(neptune):
    """A smooth cube: the float64 copy, the oversampling and the sampler,
    each once, after the upload and the samples; the planes and the
    oversampled grid counted."""
    cube = _cube(6)
    neptune.map_img(cube, interpolation='smooth', **MAP)  # the x/y maps
    order, counted = _traced(
        lambda: neptune.map_img(cube, interpolation='smooth', **MAP))
    assert order == ['pm.map.upload', 'pm.map.samples', 'pm.map.to_float64',
                     'pm.map.pchip', 'pm.map.smooth']
    iy0, iy1, ix0, ix1 = pchip_device.smooth_box(
        neptune._get_map_samples(**MAP).limits, NY, NX)
    grid = ((iy1 - iy0 - 1) * 5 + 1) * ((ix1 - ix0 - 1) * 5 + 1)
    assert counted == {'map.frames': PLANES,
                       'map.smooth_grid_values': PLANES * grid}
    assert tracing.counts()['map.frames'] == PLANES


@pytest.mark.parametrize('dtype', [np.float32, np.int16])
def test_nearest_span_and_frames_counter(neptune, dtype):
    """The nearest branch, its float64 copy of an integer cube inside it,
    and a single frame counted as one plane."""
    frame = _cube(7)[0]
    frame = np.nan_to_num(frame * 100).astype(dtype)
    neptune.map_img(frame, interpolation='nearest', **MAP)
    order, counted = _traced(
        lambda: neptune.map_img(frame, interpolation='nearest', **MAP))
    assert order == ['pm.map.upload', 'pm.map.samples', 'pm.map.nearest']
    assert counted == {'map.frames': 1, 'map.smooth_grid_values': 0}


def test_counters_count_without_a_profiler(neptune):
    tracing.reset('map.frames', 'map.smooth_grid_values')
    cube = _cube(8, planes=3)
    neptune.map_img(cube, interpolation='smooth', **MAP)
    neptune.map_img(cube[0], interpolation='linear', **MAP)
    assert tracing.counts()['map.frames'] == 4
    assert tracing.counts()['map.smooth_grid_values'] > 0
    assert 'map.frames' not in tracing.traced_counts()


# --------------------------------------------------------------------------
# On a card (``python -m pytest tests/test_torch_smooth_cube.py -m cuda
# --noconftest -q``; this file imports no JAX)
# --------------------------------------------------------------------------


@pytest.fixture(scope='module')
def card(neptune):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    body = tpm.BodyXY('NEPTUNE', observer='EARTH', utc=UTC, nx=NX, ny=NY,
                      device='cuda', aberration_correction='CN')
    body.set_disc_params(*DISC)
    return body


@pytest.mark.cuda
def test_smooth_cube_on_the_card_matches_the_reference(card):
    """A 1050-plane cube (band 1A's) onto the 1 degree map by the PCHIP and
    sampler kernels: the float32 rounding of the reference's values, to
    float64 rounding, on the card's own x/y maps."""
    cube = _cube(9, planes=1050)
    got = card.map_img(cube, interpolation='smooth', degree_interval=1)
    assert got.device.type == 'cuda' and got.shape == (1050, 180, 360)
    got = got.cpu().numpy()
    x = torch.as_tensor(card.get_x_map(degree_interval=1)).reshape(-1)
    y = torch.as_tensor(card.get_y_map(degree_interval=1)).reshape(-1)
    for p in range(0, 1050, 150):
        ref = rsm.smooth(torch.as_tensor(cube[p:p + 150]).double().cuda(),
                         x.cuda(), y.cuda()).reshape(-1, 180, 360).cpu().numpy()
        part = got[p:p + 150]
        np.testing.assert_array_equal(np.isnan(part), np.isnan(ref))
        both = np.isfinite(ref)
        bar = 0.5 * np.spacing(np.abs(ref[both]).astype(np.float32)) + 1e-12
        assert np.all(np.abs(part[both] - ref[both]) <= bar)


@pytest.mark.cuda
def test_smooth_spans_hold_the_kernels_on_the_card(card):
    """The two PCHIP launches inside ``pm.map.pchip``, the sampler's inside
    ``pm.map.smooth``, each counted."""
    from planetmapper_tpu_torch.ops import map_smooth_kernel, pchip_kernel

    cube = _cube(10, planes=64)
    card.map_img(cube, interpolation='smooth', **MAP)
    pchips, samplers = pchip_kernel.launch_count(), map_smooth_kernel.launch_count()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        card.map_img(cube, interpolation='smooth', **MAP)
        torch.cuda.synchronize()
    assert pchip_kernel.launch_count() == pchips + 2
    assert map_smooth_kernel.launch_count() == samplers + 1
    names = {s[2] for s in _spans(prof)}
    assert {'pm.map.to_float64', 'pm.map.pchip', 'pm.map.smooth'} <= names


@pytest.mark.cuda
def test_band_cubes_staged_map_as_the_plain_upload(card, monkeypatch):
    """The cell's three band cubes (1050, 1213, 1400 planes) in turn, twice:
    each 'smooth' map the same bits as from the cube uploaded by
    ``torch.as_tensor``, every cube through the upload ring, and the ring
    pinned once, its chunk count, whatever the cube's size."""
    from planetmapper_tpu_torch import host_slots

    pins = []
    pin = host_slots._pin
    monkeypatch.setattr(host_slots, '_pin',
                        lambda n: pins.append(n) or pin(n))
    monkeypatch.setattr(host_slots, 'UPLOADS', host_slots.UploadRing())
    kw = dict(interpolation='smooth', degree_interval=1)
    staged = tracing.counts().get('map.upload_staged', 0)
    for i, planes in enumerate((1050, 1213, 1400) * 2):
        cube = _cube(20 + i, planes=planes)
        ref = card.map_img(torch.as_tensor(cube, device='cuda'), **kw)
        got = card.map_img(cube, **kw)
        cube[...] = 0.0
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert tracing.counts()['map.upload_staged'] - staged == 6
    assert pins == [host_slots.CHUNK_BYTES] * host_slots.RING_CHUNKS
