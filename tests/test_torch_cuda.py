"""
The port's CUDA kernels (backplanes, map spline, PCHIP, map smooth, the
double-single dsk kernels) against their plain PyTorch versions, a CUDA
body's map chain and its per-plane image and map getters against a CPU
body's, and the per-plane getters against the backplane kernel, on the
card. Every test here carries the ``cuda`` marker and skips without a CUDA
device; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the repository's conftest imports JAX, which a GPU host
running only the port need not have. For the same reason this file, unlike
the other ``test_torch_*`` files, imports torch but not jax: it holds the
kernel against the port's own plain version, not against the JAX package.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import planetmapper_tpu_torch as tpm
from planetmapper_tpu_torch import host_slots, pipeline, tracing
from planetmapper_tpu_torch._device import f64
from planetmapper_tpu_torch.ops import backplanes_kernel as bk
from planetmapper_tpu_torch.ops import dsk, dsk_kernel
from planetmapper_tpu_torch.ops import interp_device, pchip_device
from planetmapper_tpu_torch.ops import map_infill_kernel as mik
from planetmapper_tpu_torch.ops import map_smooth_kernel as msk
from planetmapper_tpu_torch.ops import map_spline_kernel as msp
from planetmapper_tpu_torch.ops import pchip_kernel as pk
from planetmapper_tpu_torch.ops.cuda_build import check_launch
from planetmapper_tpu_torch.testing import (compare, dsk_cases,
                                            infill_cases, observation_files)
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    write_synthetic_kernels,
)

pytestmark = pytest.mark.cuda

FLAGS = dict(positive_west=True, prograde=True, have_sun=True)


@pytest.fixture(scope='module')
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def kernel_path(tmp_path_factory, device):
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0)
    previous, source = tpm.get_kernel_path(return_source=True)
    tpm.clear_kernels()
    tpm.set_kernel_path(path)
    yield path
    tpm.clear_kernels()
    tpm.set_kernel_path(previous if source == 'set_kernel_path()' else None)


def _body(nx, ny, disc, device):
    """A card body of ``disc`` and its host inputs (``pipeline_inputs``)."""
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01T00:00:00',
                      nx=nx, ny=ny, device=device)
    body.set_disc_params(*disc)
    return body, pipeline.pipeline_inputs(body)


def _numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _frame(impl, nx, ny, inputs, device, row0=0.0):
    """One frame of ``impl.frames`` on the host inputs of one body, as
    numpy (ny, nx) planes."""
    xy2angular, disc, radii, anchors = inputs
    out = impl.frames(nx, ny, xy2angular[None], disc[None], radii, anchors,
                      device=device, row0=row0)
    return {k: v[0].cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize('nx, ny, disc', [
    (128, 64, (64.3, 32.3, 28.8, 12.3)),
    (100, 70, (50.3, 34.7, 30.0, 200.0)),
    (333, 257, (120.6, 140.2, 90.0, 45.0)),
])
@pytest.mark.parametrize('optimize_speed', [True, False])
def test_kernel_matches_plain_version(
    kernel_path, device, nx, ny, disc, optimize_speed
):
    _, inputs = _body(nx, ny, disc, device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=optimize_speed, lst_quant=True, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(optimize_speed=optimize_speed, **FLAGS)
    before = bk.launch_count()
    got = _frame(kernel, nx, ny, inputs, device)
    torch.cuda.synchronize()
    assert bk.launch_count() == before + 1
    assert got['EMISSION'].dtype == np.float32
    assert got['RADIAL-VELOCITY'].dtype == np.float64
    reports = compare.compare_backplanes(
        got, _frame(plain, nx, ny, inputs, device), float32_ulps=1,
    )
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(got['EMISSION']).sum() > 100


def test_row0_band_equals_full_frame(kernel_path, device):
    nx, ny = 100, 70
    _, inputs = _body(nx, ny, (50.3, 34.7, 30.0, 12.3), device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    full = _frame(kernel, nx, ny, inputs, device)
    top = _frame(kernel, nx, 29, inputs, device)
    bottom = _frame(kernel, nx, ny - 29, inputs, device, row0=29.0)
    for name, plane in full.items():
        assert np.array_equal(
            np.concatenate([top[name], bottom[name]]), plane, equal_nan=True
        ), name


def test_subsets_equal_full_set(kernel_path, device):
    nx, ny = 128, 64
    _, inputs = _body(nx, ny, (64.3, 32.3, 28.8, 12.3), device)
    full = _frame(bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    ), nx, ny, inputs, device)
    for planes in [('LON-GRAPHIC', 'LOCAL-SOLAR-TIME'), ('AZIMUTH',),
                   ('DISTANCE', 'DOPPLER', 'RING-DISTANCE')]:
        sub = _frame(bk.build_backplanes_kernel(
            optimize_speed=True, lst_quant=True, planes=planes, **FLAGS,
        ), nx, ny, inputs, device)
        assert set(sub) == set(planes)
        for name in planes:
            assert np.array_equal(sub[name], full[name], equal_nan=True), name


def test_triaxial_kernel_matches_robust_plain_graph(kernel_path, device):
    nx, ny, disc = 100, 70, (50.3, 34.7, 30.0, 12.3)
    _, (xy2angular, disc, radii, anchors) = _body(nx, ny, disc, device)
    # Jupiter scaled to a triaxial body inside the kernel's geodetic range
    radii = radii * np.array([1.0, 0.98, 0.935])
    shape = type('Shape', (), {'radii': radii})()
    assert pipeline._kernel_geodetic_iters(shape) == 4
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, geodetic_iters=4, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(robust_geodetic=True, **FLAGS)
    inputs = (xy2angular, disc, radii, anchors)
    before = bk.launch_count()
    got = _frame(kernel, nx, ny, inputs, device)
    torch.cuda.synchronize()
    assert bk.launch_count() == before + 1
    reports = compare.compare_backplanes(
        got, _frame(plain, nx, ny, inputs, device), float32_ulps=1,
    )
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(got['LAT-GRAPHIC']).sum() > 100


def test_scene_from_device_tensors_equals_host_packing(kernel_path, device,
                                                       monkeypatch):
    """A frame over the kernel's kept shared part (another disc's) equals
    the frame packed whole, and compute_backplanes, bit for bit."""
    body, inputs = _body(96, 80, (47.6, 40.2, 30.0, 12.3), device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    monkeypatch.setattr(bk, '_last_packed', None)
    whole = _frame(kernel, 96, 80, inputs, device)
    xy2angular, disc, radii, anchors = inputs
    kernel.frames(96, 80, xy2angular[None], disc[None] + 1.0, radii,
                  anchors, device=device)
    assert bk._last_packed[0] is anchors
    cached = _frame(kernel, 96, 80, inputs, device)
    main = pipeline.compute_backplanes(body)
    for name, plane in whole.items():
        assert np.array_equal(plane, cached[name], equal_nan=True), name
        assert np.array_equal(plane, main[name], equal_nan=True), name


def test_compute_backplanes_launches_kernel(kernel_path, device):
    """The default card body takes one launch for every plane; at
    'double' it takes the plain graph and launches nothing, and its
    planes are the plain graph's own."""
    body, inputs = _body(96, 80, (47.6, 40.2, 30.0, 12.3), device)
    bk.reset_launch_count()
    out = pipeline.compute_backplanes(body)
    assert bk.launch_count() == 1
    assert set(out) == set(bk.PLANE_ORDER)
    body._pipeline_precision = 'double'
    double = pipeline.compute_backplanes(body)
    assert bk.launch_count() == 1  # 'double' pins the plain graph
    assert set(double) == set(bk.PLANE_ORDER)
    plain = pipeline.fused_backplanes_fn(
        precision='double', optimize_speed=bool(body._optimize_speed),
        robust_geodetic=pipeline._robust_geodetic(body), **FLAGS)
    plain = _frame(plain, 96, 80, inputs, device)
    for name, plane in plain.items():
        assert np.array_equal(double[name], plane, equal_nan=True), name


# ---------------------------------------------------------------------------
# The copy to numpy through the page-locked host slots, at 2048^2
# ---------------------------------------------------------------------------

SLOT_SIZE = 2048


@pytest.fixture
def slot_body(kernel_path, device, monkeypatch):
    """A 2048^2 card body, and a fresh pool of slots."""
    monkeypatch.setattr(host_slots, 'SLOTS', host_slots.HostSlots())
    body, _ = _body(SLOT_SIZE, SLOT_SIZE, (1024.0, 1024.0, 601.0, 12.3),
                    device)
    return body


def _dither(body, i):
    body.set_disc_params(1024.0 + 3.0 * i, 1024.0 - 2.0 * i,
                         601.0 * (1 + 0.01 * i), 12.3)


def _assert_same_bytes(got, ref):
    assert list(got) == list(ref)
    for name, plane in ref.items():
        assert got[name].dtype == plane.dtype, name
        assert got[name].shape == plane.shape, name
        assert np.array_equal(got[name].view(np.uint8),
                              plane.view(np.uint8)), name


@pytest.mark.parametrize('names', [
    None, ('LON-GRAPHIC', 'EMISSION', 'RADIAL-VELOCITY', 'DOPPLER')])
def test_slot_copy_equals_the_pageable_copy_bit_for_bit(slot_body, names):
    fn = pipeline.get_fused_pipeline(slot_body, SLOT_SIZE, SLOT_SIZE,
                                     planes=names)
    planes = fn(*pipeline.pipeline_inputs(slot_body))
    ref = {k: v.cpu().numpy() for k, v in planes.items()}
    got = pipeline._to_host_slot(planes)
    for plane in got.values():
        while isinstance(plane, np.ndarray):
            plane = plane.base
        assert isinstance(plane, host_slots.Lease)
    _assert_same_bytes(got, ref)
    _assert_same_bytes(pipeline.compute_backplanes(slot_body, names=names),
                       ref)


def test_held_results_are_never_overwritten(slot_body):
    """Three calls' results held, with different discs: the third and a
    fourth fall back, and nothing held changes."""
    held, copies = [], []
    start = tracing.counts()
    for i in range(4):
        _dither(slot_body, i)
        held.append(slot_body.generate_backplanes_fused())
        copies.append({k: v.copy() for k, v in held[-1].items()})
    for i, (planes, copy) in enumerate(zip(held, copies)):
        _assert_same_bytes(planes, copy)
        assert not any(np.shares_memory(planes['EMISSION'], other['EMISSION'])
                       for other in held[i + 1:])
    assert not np.array_equal(held[0]['EMISSION'], held[1]['EMISSION'],
                              equal_nan=True)
    now = tracing.counts()
    assert [now.get(f'pipeline.copy_slot_{k}', 0)
            - start.get(f'pipeline.copy_slot_{k}', 0)
            for k in ('hits', 'misses')] == [2, 2]


def test_a_loop_that_drops_its_results_reuses_the_slots(slot_body):
    """``planes = body.generate_backplanes_fused()`` in a loop: every call
    takes a slot, and from the third the two slots are reused in turn."""
    start = tracing.counts().get('pipeline.copy_slot_hits', 0)
    addresses = []
    planes = None
    for i in range(6):
        _dither(slot_body, i)
        planes = slot_body.generate_backplanes_fused()
        addresses.append(planes['LON-GRAPHIC'].ctypes.data)
    assert tracing.counts().get('pipeline.copy_slot_hits', 0) - start == 6
    assert len(host_slots.SLOTS.slots) == 2
    assert addresses[0] != addresses[1]
    assert addresses[2:] == addresses[:2] * 2
    del planes


# ---------------------------------------------------------------------------
# map_img's upload through the page-locked ring, against the plain copy
# ---------------------------------------------------------------------------

UPLOAD_COUNTERS = ('map.upload_staged', 'map.upload_plain')


@pytest.fixture
def ring(monkeypatch):
    """A fresh upload ring; yields the sizes of its page-locked
    allocations."""
    pins = []
    pin = host_slots._pin
    monkeypatch.setattr(host_slots, '_pin',
                        lambda n: pins.append(n) or pin(n))
    monkeypatch.setattr(host_slots, 'UPLOADS', host_slots.UploadRing())
    return pins


def _same_bits(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got.reshape(-1).view(torch.uint8),
                       ref.reshape(-1).view(torch.uint8))


def _routes(run) -> tuple[int, int]:
    """The staged and plain uploads of ``run()``."""
    start = tracing.counts()
    run()
    now = tracing.counts()
    return tuple(now.get(n, 0) - start.get(n, 0) for n in UPLOAD_COUNTERS)


def _linear_frame(seed):
    """The map_linear cell's frame: normal noise, 4 NaN blocks of 3 px on
    the disc."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((SLOT_SIZE, SLOT_SIZE), dtype=np.float32)
    for i, j in rng.integers(600, 1400, (4, 2)):
        img[i:i + 3, j:j + 3] = np.nan
    return img


@pytest.fixture(scope='module')
def frame_body(kernel_path, device):
    body, _ = _body(SLOT_SIZE, SLOT_SIZE, (1024.0, 1024.0, 601.0, 12.3),
                    device)
    return body


def test_staged_frame_maps_as_the_plain_upload(frame_body, device, ring):
    """The map_linear cell's frame: 'linear' onto the 0.25 degree map, the
    same bits as from the frame uploaded by ``torch.as_tensor``; the map
    is unchanged when the caller overwrites its array at once."""
    kw = dict(degree_interval=0.25)
    for seed in (0, 1):
        img = _linear_frame(seed)
        plain = torch.as_tensor(img, device=device)
        assert _routes(lambda: frame_body.map_img(plain, **kw)) == (0, 1)
        ref = frame_body.map_img(plain, **kw)
        got = frame_body.map_img(img, **kw)
        img[...] = np.nan
        _same_bits(got, ref)
    assert _routes(lambda: frame_body.map_img(img, **kw)) == (1, 0)
    assert ring == [host_slots.CHUNK_BYTES] * host_slots.RING_CHUNKS


@pytest.mark.parametrize('layout', ['fortran', 'strided', 'tensor'])
def test_other_layouts_map_as_the_plain_upload(frame_body, device, ring,
                                               layout):
    """A Fortran-ordered frame and a strided view take the plain copy; a
    CPU tensor takes the ring, as an array does."""
    kw = dict(degree_interval=1)
    img = _linear_frame(2)
    src = {'fortran': np.asfortranarray(img),
           'strided': np.stack([img, img], axis=-1)[..., 0],
           'tensor': torch.from_numpy(img)}[layout]
    ref = frame_body.map_img(torch.as_tensor(img, device=device), **kw)
    routes = _routes(lambda: _same_bits(frame_body.map_img(src, **kw), ref))
    assert routes == ((1, 0) if layout == 'tensor' else (0, 1))


CHUNK = host_slots.CHUNK_BYTES
RING = host_slots.RING_CHUNKS * CHUNK
#: A body of 683 x 89 pixels, an odd number of bytes a uint8 plane
ODD = (683, 89)


@pytest.mark.parametrize('n_bytes', [CHUNK - 1, CHUNK, 2 * RING,
                                     3 * CHUNK + 12345])
def test_upload_moves_every_byte(device, ring, n_bytes):
    """One byte under a chunk, a chunk, two whole rings and an odd
    remainder: the bytes on the card are the source's."""
    src = np.random.default_rng(n_bytes).integers(0, 256, n_bytes, np.uint8)
    got = []
    assert _routes(lambda: got.append(host_slots.upload(src, device))) == (
        1, 0)
    _same_bits(got[0].cpu(), torch.from_numpy(src))


@pytest.mark.parametrize('nx, ny, planes, dtype', [
    (256, 256, CHUNK // 2**18 - 1, np.float32),  # under a chunk
    (256, 256, CHUNK // 2**18, np.float32),  # a chunk
    (256, 256, 2 * RING // 2**18, np.float32),  # two whole rings
    (*ODD, (CHUNK // (ODD[0] * ODD[1]) + 1) | 1, np.uint8),  # odd remainder
])
def test_cube_sizes_map_as_the_plain_upload(kernel_path, device, ring, nx,
                                            ny, planes, dtype):
    """Cubes under a chunk, of a chunk, of two whole rings and of a chunk and
    an odd remainder: their 'nearest' maps the same bits as from the cube
    uploaded by ``torch.as_tensor``."""
    body, _ = _body(nx, ny, (nx / 2, ny / 2, ny / 3, 0.0), device)
    rng = np.random.default_rng(planes)
    cube = (rng.integers(0, 256, (planes, ny, nx)).astype(dtype)
            if dtype == np.uint8 else
            rng.standard_normal((planes, ny, nx), dtype=dtype))
    kw = dict(interpolation='nearest', degree_interval=10)
    ref = body.map_img(torch.as_tensor(cube, device=device), **kw)
    assert _routes(lambda: _same_bits(body.map_img(cube, **kw), ref)) == (
        1, 0)
    assert ring == [CHUNK] * host_slots.RING_CHUNKS


# ---------------------------------------------------------------------------
# The batched backplane kernel and the meshes of parallel/
# ---------------------------------------------------------------------------

def _sweep(body, n):
    """``n`` disc sets about the body's disc and their xy2angular
    matrices."""
    x0, y0, r0, rot = body.get_disc_params()
    discs, xys = [], []
    for i in range(n):
        disc = (x0 + 0.7 * i, y0 - 0.4 * i, r0 * (1 + 0.02 * i), rot + 7 * i)
        body.set_disc_params(*disc)
        discs.append(disc)
        xys.append(np.array(body._get_xy2angular_matrix()))
    body.set_disc_params(x0, y0, r0, rot)
    return np.array(xys), np.array(discs)


def _equal(got, ref):
    assert set(got) == set(ref)
    for name, plane in ref.items():
        assert torch.equal(torch.isnan(got[name]), torch.isnan(plane)), name
        assert torch.equal(torch.nan_to_num(got[name]),
                           torch.nan_to_num(plane)), name


@pytest.mark.parametrize('planes', [None, ('EMISSION', 'RADIAL-VELOCITY',
                                           'RING-RADIUS', 'LIMB-DISTANCE')])
@pytest.mark.parametrize('row0', [0.0, 17.0])
@pytest.mark.parametrize('frame_launches', [False, True])
def test_batched_kernel_equals_single_launches(kernel_path, device, planes,
                                               row0, frame_launches):
    """Both routes of a batch (the batched kernel, and one single-frame
    launch a frame from one C call) at a ragged shape and a plane subset,
    frame by frame."""
    nx, ny = 101, 67
    body, _ = _body(nx, ny, (50.3, 30.7, 28.0, 12.3), device)
    xys, discs = _sweep(body, 5)
    _, _, radii, anchors = pipeline.pipeline_inputs(body)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, planes=planes, **FLAGS,
    )
    before = (bk.launch_count(), bk.batch_launch_count())
    got = kernel.frames(nx, ny, xys, discs, radii, anchors, device=device,
                        row0=row0, frame_launches=frame_launches)
    torch.cuda.synchronize()
    assert (bk.launch_count(), bk.batch_launch_count()) == (
        (before[0] + 5, before[1]) if frame_launches
        else (before[0], before[1] + 1))
    for i in range(len(discs)):
        single = kernel.frames(nx, ny, xys[i:i + 1], discs[i:i + 1], radii,
                               anchors, device=device, row0=row0)
        _equal({k: v[i] for k, v in got.items()},
               {k: v[0] for k, v in single.items()})
    if planes is not None:
        assert tuple(got) == tuple(n for n in bk.PLANE_ORDER if n in planes)
    assert got[next(iter(got))].shape == (5, ny, nx)


def test_batched_kernel_walks_frames_past_the_grid_z_limit(kernel_path,
                                                            device):
    _, (xy2angular, disc, radii, anchors) = _body(
        5, 3, (2.0, 1.0, 1.5, 0.0), device)
    n = 65535 + 40
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True,
        planes=('EMISSION', 'RADIAL-VELOCITY', 'RA'), **FLAGS,
    )
    got = kernel.frames(5, 3, np.repeat(xy2angular[None], n, axis=0),
                        np.repeat(disc[None], n, axis=0), radii, anchors,
                        device=device)
    single = kernel.frames(5, 3, xy2angular[None], disc[None], radii,
                           anchors, device=device)
    for name, plane in single.items():
        every = got[name].reshape(n, -1)
        ref = plane.reshape(1, -1).expand_as(every)
        assert torch.equal(torch.isnan(every), torch.isnan(ref)), name
        assert torch.equal(torch.nan_to_num(every), torch.nan_to_num(ref)), \
            name


@pytest.mark.parametrize('n, size, tiles', [
    (1, 50, False), (77, 50, False), (78, 50, False), (1000, 50, False),
    (40, 130, False), (40, 200, True), (2, 2048, True),
])
def test_batched_kernel_at_main_path_sizes(kernel_path, device, n, size,
                                           tiles):
    """The time series' 50x50 frames at 1, 77, 78 and 1000 epochs and 40
    of 130x130 (linear blocks: 78% of the tiles' lanes), 40 of 200x200
    (tiles, 89%: two launches of 38 and 2) and two 2048x2048 frames, bit
    for bit with single-frame launches, in the launches of the plan."""
    body, _ = _body(size, size, (size / 2, size / 2, size * 0.4, 12.3),
                    device)
    ets = body.et + 60.0 * np.arange(n)
    from planetmapper_tpu_torch.parallel import timeseries

    anchors, xys = timeseries._batched_pipeline_inputs(body, ets)
    frames = (xys, np.broadcast_to(body.get_disc_params(), (n, 4)),
              np.asarray(body.radii), anchors)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    before = bk.batch_launch_count()
    got = kernel.frames(size, size, *frames, device=device,
                        frame_launches=False)
    torch.cuda.synchronize()
    plan = bk.batch_plan(n, size, size)
    assert plan.tiles == tiles
    assert bk.batch_launch_count() == before + len(plan.launches)
    _equal(got, kernel.frames(size, size, *frames, device=device,
                              frame_launches=True))


@pytest.mark.parametrize('fill', [0.0, 2.0])
def test_batched_kernel_in_either_layout_equals_single_launches(
        kernel_path, device, monkeypatch, fill):
    """The tiles (fill 0, no least size) and the linear blocks (fill 2) on a
    ragged frame, row-offset, with a plane subset: each bit for bit with
    single-frame launches."""
    monkeypatch.setattr(bk, 'TILE_FILL', fill)
    monkeypatch.setattr(bk, 'TILE_PIXELS', 0)
    nx, ny = 101, 67
    body, _ = _body(nx, ny, (50.3, 30.7, 28.0, 12.3), device)
    xys, discs = _sweep(body, 3)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True,
        planes=('EMISSION', 'RADIAL-VELOCITY', 'LON-GRAPHIC', 'RA'), **FLAGS,
    )
    frames = (xys, discs, np.asarray(body.radii),
              body._get_pipeline_anchors())
    assert bk.batch_plan(3, nx, ny).tiles == (fill == 0.0)
    _equal(kernel.frames(nx, ny, *frames, device=device, row0=9.0,
                         frame_launches=False),
           kernel.frames(nx, ny, *frames, device=device, row0=9.0,
                         frame_launches=True))


def test_batched_kernel_matches_plain_version(kernel_path, device):
    nx, ny = 128, 64
    body, (_, _, radii, anchors) = _body(
        nx, ny, (64.3, 32.3, 28.8, 12.3), device)
    xys, discs = _sweep(body, 3)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(**FLAGS)
    got = kernel.frames(nx, ny, xys, discs, radii, anchors, device=device)
    ref = plain.frames(nx, ny, xys, discs, radii, anchors, device=device)
    for i in range(3):
        reports = compare.compare_backplanes(
            _numpy({k: v[i] for k, v in got.items()}),
            _numpy({k: v[i] for k, v in ref.items()}), float32_ulps=1,
        )
        assert not compare.failures(reports), compare.failures(reports)


def test_compute_backplanes_batch_is_one_launch(kernel_path, device):
    body, _ = _body(96, 80, (47.6, 40.2, 30.0, 12.3), device)
    xys, discs = _sweep(body, 4)
    bk.reset_launch_count()
    bk.reset_batch_launch_count()
    out = pipeline.compute_backplanes_batch(body, xys, discs,
                                            as_numpy=False)
    assert (bk.batch_launch_count(), bk.launch_count()) == (1, 0)
    for i, disc in enumerate(discs):
        body.set_disc_params(*disc)
        _equal({k: v[i] for k, v in out.items()},
               pipeline.compute_backplanes(body, as_numpy=False))


def test_mesh_of_one_card_matches_unsharded(kernel_path, device):
    """sharded_backplanes and sharded_map_img on 4 entries of cuda:0."""
    from planetmapper_tpu_torch.parallel import (
        make_mesh,
        sharded_backplanes,
        sharded_map_img,
    )

    mesh = make_mesh(4, device=device)
    body, _ = _body(90, 75, (44.6, 37.2, 30.0, 12.3), device)
    bk.reset_launch_count()
    sharded = sharded_backplanes(body, mesh)
    assert bk.launch_count() == 4
    _equal(sharded, pipeline.compute_backplanes(body, as_numpy=False))
    img = np.random.default_rng(3).normal(size=(75, 90))
    img[20:23, 30:32] = np.nan
    for mode in ('linear', 'cubic'):
        ref = body.map_img(img, interpolation=mode, as_numpy=True,
                           degree_interval=5)
        got = sharded_map_img(body, img, mesh, interpolation=mode,
                              degree_interval=5)
        np.testing.assert_array_equal(got, ref.astype(np.float64))


def test_time_series_is_one_launch_on_the_card(kernel_path, device):
    from planetmapper_tpu_torch.parallel import (
        backplane_time_series,
        make_mesh,
    )

    body, _ = _body(40, 30, (20.0, 15.0, 11.0, 0.0), device)
    ets = body.et + 60.0 * np.arange(8)
    bk.reset_batch_launch_count()
    out = backplane_time_series(body, ets, names=['EMISSION', 'RA'],
                                as_numpy=False)
    assert bk.batch_launch_count() == 1
    assert out['EMISSION'].shape == (8, 30, 40)
    assert out['EMISSION'].device.type == 'cuda'
    meshed = backplane_time_series(body, ets, names=['EMISSION', 'RA'],
                                   mesh=make_mesh(4, device=device),
                                   as_numpy=False)
    assert bk.batch_launch_count() == 1 + 4
    _equal(meshed, out)


# ---------------------------------------------------------------------------
# Map kernels
# ---------------------------------------------------------------------------

def _map_case(n, frames, nan, seed, device, my=72, mx=144):
    """Seeded frames (n x n) and a smooth map-like field of samples."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(frames, n, n))
    if nan:
        img[:, n // 4:n // 4 + 4, n // 3:n // 3 + 3] = np.nan
        img[0, n // 2, n // 2] = np.inf
    yy, xx = np.meshgrid(np.linspace(-3, n + 2, my),
                         np.linspace(-3, n + 2, mx), indexing='ij')
    x_map = xx + 2 * np.sin(yy / 7.0)
    y_map = yy + 2 * np.cos(xx / 9.0)
    x_map[rng.uniform(size=x_map.shape) < 0.05] = np.nan
    samples = interp_device._device_xy(x_map, y_map, device)
    return f64(img, device), samples


def _assert_within_one_ulp(got, ref):
    got = got.cpu().numpy()
    ref = ref.cpu().numpy()
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    finite = ~np.isnan(ref)
    assert finite.sum() > 100
    # both compute in float64 and store float32; nvcc's fused multiply-adds
    # may move a rounding by one float32 ulp (taken at no less than 1e-6,
    # where float64 rounding of O(1) terms is no longer below it)
    ulp = np.spacing(np.maximum(np.abs(ref[finite]), np.float32(1e-6)))
    err = np.abs(got[finite] - ref[finite]) / ulp
    assert np.all(err <= 1), (float(err.max()), int((err > 1).sum()))


def _assert_within_map_bar(got, ref):
    """
    A map from the card against a map from the CPU whose x/y maps were
    computed on each device: the same NaN mask, and values within two
    float32 ulps of the map's largest value (2^-22 of it; the port holds
    its maps to one such ulp against the host scipy reference,
    tests/test_torch_map.py F32_BAR). The x/y maps differ by a few ulps of
    an RA (below 1e-8 px, test_cuda_body_map_chain_matches_cpu_body), which
    moves a value by its gradient times that: far below the map's scale,
    not below one ulp of a value near zero.
    """
    got = got.cpu().numpy()
    ref = ref.cpu().numpy()
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    finite = ~np.isnan(ref)
    assert finite.sum() > 100
    scale = max(float(np.abs(ref[finite]).max()), 1.0)
    err = float(np.abs(got[finite] - ref[finite]).max())
    assert err <= 2.0**-22 * scale, (err, scale)


@pytest.mark.parametrize('kxy', [(1, 1), (2, 2), (3, 3), (3, 1), (4, 4),
                                 (5, 1), (1, 5)])
@pytest.mark.parametrize('nan', [False, True])
@pytest.mark.parametrize('n, frames', [(150, 1), (150, 3), (700, 2)])
def test_map_spline_matches_plain_version(device, kxy, nan, n, frames):
    ky, kx = kxy
    img, samples = _map_case(n, frames, nan, n + frames, device)
    ty, tx, ainv_y, ainv_x = interp_device._device_solver(
        n, n, kx, ky, device
    )
    cleaned, nans, _ = mik.map_infill(img)
    coeffs = interp_device._collocation_solve(cleaned, ainv_y, ainv_x)
    # the main path's uniform-knot path, and the search path on the same
    # knots
    for uniform in (interp_device._grid_uniform_knots(n, n, kx, ky), None):
        for propagate_nan in (True, False):
            args = (samples.x, samples.y, samples.valid, ty, tx, coeffs,
                    nans)
            kw = dict(kx=kx, ky=ky, propagate_nan=propagate_nan)
            before = msp.launch_count()
            got = msp.map_spline(*args, uniform=uniform, **kw)
            torch.cuda.synchronize()
            assert msp.launch_count() == before + 1
            _assert_within_one_ulp(got, msp.map_spline_plain(*args, **kw))


def _assert_infill_equal(got, ref):
    """The kernel's three outputs against the plain version's, bit for bit
    (cleaned holds no NaN; torch.equal takes -0.0 == 0.0, which matters
    only where the plain version's sort puts zeros of both signs in the
    middle)."""
    names = ('cleaned', 'nans', 'finite')
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.equal(g.cpu(), r.cpu()), name


@pytest.mark.parametrize('case', infill_cases.RULE_CASES
                         + infill_cases.SELECT_CASES + ('map_linear',))
def test_map_infill_matches_plain_version(device, case):
    for seed in (0, 1):
        cube = torch.from_numpy(infill_cases.infill_case(case, seed))
        before = mik.launch_count()
        got = mik.map_infill(cube.to(device))
        torch.cuda.synchronize()
        assert mik.launch_count() == before + 1
        _assert_infill_equal(got, mik.map_infill_plain(cube))


def test_map_infill_takes_a_cube_in_one_launch(device):
    cube = np.concatenate([infill_cases.infill_case(case)[:, :12, :9]
                           for case in infill_cases.RULE_CASES])
    frames = torch.from_numpy(cube)
    mik.reset_launch_count()
    got = mik.map_infill(frames.to(device))
    torch.cuda.synchronize()
    assert mik.launch_count() == 1
    assert tracing.counts()['launches.map_infill'] == 1
    _assert_infill_equal(got, mik.map_infill_plain(frames))
    # a frame is the cube of one
    one = mik.map_infill(frames[1].to(device))
    _assert_infill_equal(one, mik.map_infill_plain(frames[1]))
    occupancy = mik.occupancy()
    print('map_infill occupancy (stencil, select):', occupancy)
    assert occupancy['local_bytes'] == (0, 0)


@pytest.mark.parametrize('interpolation', [1, 3])
def test_spline_map_with_the_defaults_never_waits_on_the_card(
        device, interpolation):
    n = 150
    img, samples = _map_case(n, 3, True, 7, device)
    kw = dict(interpolation=interpolation, warn_nan=False,
              propagate_nan=True, spline_smoothing=0)
    interp_device.spline_interpolation_device(img, samples, **kw)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        out = interp_device.spline_interpolation_device(img, samples, **kw)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert out.shape == (3,) + samples.shape
    assert torch.isfinite(out).any()


@pytest.mark.parametrize('kxy', [(3, 3), (1, 1), (5, 1)])
def test_map_spline_fitpack_knots_match_plain_version(device, kxy):
    # spline_smoothing > 0: FITPACK's adaptive knots and no descriptor,
    # the kernel's search path
    ky, kx = kxy
    n = 150
    _, samples = _map_case(n, 1, False, 5, device)
    yy, xx = np.mgrid[0:n, 0:n]
    host = np.sin(xx / 17.0) * np.cos(yy / 23.0) + 0.01 * \
        np.random.default_rng(5).normal(size=(n, n))
    host[37:41, 50:53] = np.nan
    ty, tx, c = interp_device._fitpack_coeffs(host, kx, ky, 1.0, False)
    assert msp.uniform_knots(ty, ky) is None or \
        msp.uniform_knots(tx, kx) is None
    args = (samples.x, samples.y, samples.valid, f64(ty, device),
            f64(tx, device),
            f64(c.reshape(1, len(ty) - ky - 1, len(tx) - kx - 1), device),
            torch.from_numpy(np.isnan(host)[None]).to(device))
    for propagate_nan in (True, False):
        kw = dict(kx=kx, ky=ky, propagate_nan=propagate_nan)
        before = msp.launch_count()
        got = msp.map_spline(*args, **kw)
        torch.cuda.synchronize()
        assert msp.launch_count() == before + 1
        _assert_within_one_ulp(got, msp.map_spline_plain(*args, **kw))


def _pchip_rows(n: int, lines: int, seed: int) -> np.ndarray:
    """Lines of n cells: clean, NaN gaps (one across most of the line),
    one finite cell, all NaN, inf, monotone, flat steps."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(lines, n)) * 10.0
    rows[1::9, :][:, rng.uniform(size=n) < 0.3] = np.nan
    rows[2::9, 3:n - 4] = np.nan
    rows[3::9, :] = np.nan
    rows[3::9, n // 2] = 1.5
    rows[4::9, :] = np.nan
    rows[5::9, :n // 3] = np.inf
    rows[6::9] = np.cumsum(np.abs(rows[6::9]), axis=1)
    rows[7::9] = np.repeat(rows[7::9, :(n + 2) // 3], 3, axis=1)[:, :n]
    return rows


def _assert_pchip_equal(got, ref):
    # built with -fmad=false, the kernel rounds as the plain version does
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert got.shape == ref.shape and got.dtype == np.float64
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isfinite(ref).sum() > 10
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('k_rep', [1, 2, 3, 4, 5])
@pytest.mark.parametrize('axis', [-1, -2])
def test_pchip_kernel_matches_plain_version(device, k_rep, axis):
    # three frames of 41 lines; the lines along `axis` of a strided view
    frames = np.stack([_pchip_rows(23, 41, 10 * k_rep + f) for f in range(3)])
    if axis == -2:
        frames = frames.transpose(0, 2, 1).copy()
    values = f64(np.pad(frames, ((0, 0), (2, 1), (3, 2))), device)
    view = values[:, 2:-1, 3:-2]
    n = view.shape[axis]
    n_eval = (n - 1) * k_rep + 1
    before = pk.launch_count()
    got = pk.pchip_axis(view, n_eval, k_rep, axis)
    torch.cuda.synchronize()
    assert pk.launch_count() == before + 1
    _assert_pchip_equal(got, pk.pchip_axis_plain(view, n_eval, k_rep, axis))


@pytest.mark.parametrize('n', [2, 5, 3000])
def test_pchip_kernel_walks_long_lines_in_segments(device, n):
    # 3000 cells: three chunks of 1024 a block, NaN gaps across them
    rows = _pchip_rows(n, 36, n)
    if n > 100:
        rows[0, 100:1500] = np.nan
        rows[9, 5:2990] = np.nan
        rows[10, :] = np.nan
        rows[10, [7, 2999]] = 2.0
    values = f64(rows[None], device)
    for k_rep in (1, 5):
        n_eval = (n - 1) * k_rep + 1
        got = pk.pchip_axis(values, n_eval, k_rep, -1)
        _assert_pchip_equal(got, pk.pchip_axis_plain(values, n_eval, k_rep,
                                                     -1))


@pytest.mark.parametrize('k_rep', [1, 3, 5])
def test_pchip_kernel_chunks_long_columns(device, k_rep):
    """
    Columns of 3000 cells, four adjacent a block: twelve chunks of 256
    cells, each with its two finite cells carried from before and the two
    found after it (NaN gaps across several chunks, a column whose only
    finite cells lie in its first and last chunks), and rows of a strided
    view (one line a block, three chunks of 1024).
    """
    rows = _pchip_rows(3000, 45, 50 + k_rep)
    rows[0, 100:1500] = np.nan
    rows[9, 5:2990] = np.nan
    rows[10, :] = np.nan
    rows[10, [7, 2999]] = 2.0
    rows[18, 250:770] = np.nan  # across the second and third chunks
    cube = np.stack([rows.T, rows[::-1].T])  # (2, 3000, 45)
    values = f64(np.pad(cube, ((0, 0), (0, 0), (1, 2))), device)
    for axis, view in ((-2, values[:, :, 1:-2]),
                       (-1, values[:, :, 1:-2].transpose(1, 2))):
        n = view.shape[axis]
        n_eval = (n - 1) * k_rep + 1
        before = pk.launch_count()
        got = pk.pchip_axis(view, n_eval, k_rep, axis)
        torch.cuda.synchronize()
        assert pk.launch_count() == before + 1
        _assert_pchip_equal(got, pk.pchip_axis_plain(view, n_eval, k_rep,
                                                     axis))


@pytest.mark.parametrize('propagate_nan', [True, False])
@pytest.mark.parametrize('nan, frames', [(False, 1), (True, 1), (False, 3),
                                         (True, 3), (True, 16)])
def test_map_smooth_matches_plain_version(device, propagate_nan, nan, frames):
    n = 150
    img, samples = _map_case(n, frames, nan, 7 * frames, device)
    box = pchip_device.smooth_box(samples.limits, n, n)
    iy0, iy1, ix0, ix1 = box
    grids = pchip_device.oversample_frames(img, box, 5, 5)
    _assert_pchip_equal(grids, torch.stack([
        pchip_device.oversample(f, box, 5, 5) for f in img
    ]))
    args = (samples.x, samples.y, samples.valid, grids, torch.isnan(img))
    kw = dict(iy0=iy0, ix0=ix0, y_step=0.2, x_step=0.2,
              propagate_nan=propagate_nan)
    before = msk.launch_count()
    got = msk.map_smooth(*args, **kw)
    torch.cuda.synchronize()
    assert msk.launch_count() == before + 1
    _assert_within_one_ulp(got, msk.map_smooth_plain(*args, **kw))


def _map_bodies(device):
    """The 150^2 test body on the CPU and on the card."""
    bodies = {}
    for where in ('cpu', device):
        body = tpm.BodyXY('Jupiter', observer='EARTH',
                          utc='2005-01-01T00:00:00', sz=150, device=where)
        body.set_disc_params(75.0, 75.0, 60.0, 12.3)
        bodies[torch.device(where).type] = body
    return bodies


def test_map_img_launches_map_kernels(kernel_path, device):
    bodies = _map_bodies(device)
    img = np.random.default_rng(0).normal(size=(150, 150))
    img[40:44, 50:53] = np.nan
    cube = np.stack([img, img[::-1], np.full_like(img, np.nan)])
    for interpolation, libs in (('cubic', [msp]), ((3, 1), [msp]),
                                (4, [msp]), (5, [msp]), ((5, 1), [msp]),
                                ((1, 5), [msp]), ('smooth', [msk, pk])):
        for source in (img, cube):
            for lib in (msp, msk, pk):
                lib.reset_launch_count()
            got = bodies['cuda'].map_img(source, interpolation=interpolation,
                                         degree_interval=2)
            # one launch per kernel (the PCHIP kernel: one per axis),
            # whatever the frame count
            assert got.device.type == 'cuda'
            assert [lib.launch_count() for lib in libs] == \
                [2 if lib is pk else 1 for lib in libs]
            ref = bodies['cpu'].map_img(source, interpolation=interpolation,
                                        degree_interval=2)
            # the x/y maps come from two devices (the kernels alone, on
            # the same inputs, are held to one ulp of each value above)
            _assert_within_map_bar(got, ref)


@pytest.mark.parametrize('interpolation', ['linear', 'quadratic', 'cubic'])
def test_spline_maps_on_the_card_match_cpu_body(kernel_path, device,
                                                interpolation):
    bodies = _map_bodies(device)
    img = np.random.default_rng(3).normal(size=(150, 150))
    img[40:44, 50:53] = np.nan  # its middle cells take the median
    img[90, 20] = np.inf
    cube = np.stack([img, img[::-1], np.full_like(img, np.nan)])
    for source in (img, cube):
        mik.reset_launch_count()
        got = bodies['cuda'].map_img(source, interpolation=interpolation,
                                     degree_interval=2)
        assert mik.launch_count() == 1
        ref = bodies['cpu'].map_img(source, interpolation=interpolation,
                                    degree_interval=2)
        _assert_within_map_bar(got, ref)


def test_cuda_body_map_chain_matches_cpu_body(kernel_path, device):
    bodies = _map_bodies(device)
    kw = dict(degree_interval=0.5)  # 360 x 720 samples
    # the same float64 chain on both devices; CUDA's transcendental
    # functions and the order of its sums differ from the CPU's in the
    # last ulps, which the strict NaN tests (visible: dot > 0; inside the
    # frame: x > -0.5 ...) may turn into mask flips at grazing and edge
    # samples: counted, and at most 1 in 10^4 samples
    got = bodies['cuda']._xy_map(**kw)
    assert got.device.type == 'cuda'
    flips = {}
    # bars: 1e-9 deg for RA/Dec; 1e-8 deg for the illumination angles, the
    # port's f64 parity bar at grazing samples (1e-9 deg at well-conditioned
    # ones, tests/test_torch_pipeline.py); 8 ulps of an RA between 256 and
    # 512 deg for x/y, in pixels at the frame's plate scale (5.3e-9 px at
    # 0.31 arcsec/px)
    ra_ulp_px = 2.0**-44 * 3600.0 / bodies['cuda'].get_plate_scale_arcsec()
    for name, bar in (('_illumf_map', 1e-8), ('_radec_map', 1e-9),
                      ('_xy_map', 8 * ra_ulp_px)):
        a = getattr(bodies['cuda'], name)(**kw).cpu().numpy()
        b = getattr(bodies['cpu'], name)(**kw).numpy()
        both = np.isfinite(a) & np.isfinite(b)
        flips[name] = int((np.isfinite(a) != np.isfinite(b)).sum())
        assert flips[name] <= a.size // 10**4, flips
        assert both.sum() > a.size // 4
        if name == '_illumf_map':  # the visible and lit flags
            flag_flips = int((a[..., 3:] != b[..., 3:]).sum())
            assert flag_flips <= a[..., 0].size // 10**4
            a, b, both = a[..., :3], b[..., :3], both[..., :3]
        np.testing.assert_allclose(a[both], b[both], rtol=0, atol=bar)
    print('mask flips against the CPU body:', flips)


def test_map_img_makes_no_host_copy_of_the_xy_maps(kernel_path, device):
    body = _map_bodies(device)['cuda']
    kw = dict(degree_interval=2)
    body.map_img(np.ones((150, 150)), interpolation='smooth', **kw)
    samples = body._get_map_samples(**kw)
    assert {t.device.type for t in (samples.x, samples.y, samples.valid)} \
        == {'cuda'}
    # every cached map is a tensor on the card; the only host map is the
    # lon/lat grid the chain starts from
    cached = list(body._cache.items()) + list(body._stable_cache.items())
    maps = [v for _, v in cached if isinstance(v, torch.Tensor)]
    assert len(maps) == 5 and all(v.device.type == 'cuda' for v in maps)
    assert [key[0] for key, v in cached
            if isinstance(v, np.ndarray) and v.size > 9] == ['_get_lonlat_map']


def test_card_body_refuses_the_host_map_route(kernel_path, device,
                                              monkeypatch):
    # PLANETMAPPER_TPU_MAP_DEVICE=off is the host route of a CPU body only:
    # a card body raises, launches nothing and copies nothing to the host
    body = _map_bodies(device)['cuda']
    monkeypatch.setenv('PLANETMAPPER_TPU_MAP_DEVICE', 'off')
    for lib in (msp, msk, pk):
        lib.reset_launch_count()
    img = torch.ones((150, 150), dtype=torch.float64, device=device)
    for interpolation in ('nearest', 'cubic', 'smooth'):
        with pytest.raises(ValueError, match="device='cpu'"):
            body.map_img(img, interpolation=interpolation, degree_interval=2)
    assert [lib.launch_count() for lib in (msp, msk, pk)] == [0, 0, 0]
    assert not body._cache


def test_host_branch_s0_knots_take_the_uniform_path(device, monkeypatch):
    # a source larger than the device-solve limit (the limit lowered here):
    # the host FITPACK branch at s=0 describes its unit-spaced knots
    n, kx, ky = 150, 3, 1
    img, samples = _map_case(n, 1, True, 11, device)
    seen = []
    wrapper = interp_device.map_spline

    def recorded(*args, **kw):
        seen.append(kw['uniform'])
        return wrapper(*args, **kw)

    monkeypatch.setattr(interp_device, 'map_spline', recorded)
    monkeypatch.setattr(interp_device, '_DEVICE_SOLVE_MAX', n - 1)
    kw = dict(interpolation=(ky, kx), warn_nan=False, propagate_nan=True,
              spline_smoothing=0.0)
    before = msp.launch_count()
    got = interp_device.spline_interpolation_device(img[0], samples, **kw)
    torch.cuda.synchronize()
    assert msp.launch_count() == before + 1
    assert seen[0] == interp_device._grid_uniform_knots(n, n, kx, ky)
    assert None not in seen[0]
    host = interp_device.MapSamples(samples.x.cpu(), samples.y.cpu(),
                                    samples.valid.cpu(), samples.shape,
                                    samples.limits)
    ref = interp_device.spline_interpolation_device(img[0].cpu(), host, **kw)
    _assert_within_one_ulp(got, ref)


@pytest.mark.parametrize('n_ty', [2000, 5200])
def test_map_spline_searches_knots_in_or_out_of_shared_memory(device, n_ty):
    # knots without a descriptor: both axes staged in shared memory up to
    # KNOT_STAGE_BYTES (2000 + 30 knots), read from global memory above it
    # (5200 + 30)
    kx, ky, n = 3, 3, 150
    rng = np.random.default_rng(n_ty)

    def clamped(n_t, k):
        inner = np.sort(rng.uniform(0.0, n - 1.0, n_t - 2 * (k + 1)))
        return np.concatenate([[0.0] * (k + 1), inner, [n - 1.0] * (k + 1)])

    ty, tx = clamped(n_ty, ky), clamped(30, kx)
    staged = 8 * (n_ty + 30) <= msp.KNOT_STAGE_BYTES
    ay, ax, _ = msp.launch_plan(n_ty, 30)
    assert (ay.staged, ax.staged) == (staged, staged)
    _, samples = _map_case(n, 1, False, 9, device)
    coeffs = rng.normal(size=(1, n_ty - ky - 1, 30 - kx - 1))
    nans = np.zeros((1, n, n), dtype=bool)
    nans[0, 60:63, 70:72] = True
    args = (samples.x, samples.y, samples.valid, f64(ty, device),
            f64(tx, device), f64(coeffs, device),
            torch.from_numpy(nans).to(device))
    for propagate_nan in (True, False):
        kw = dict(kx=kx, ky=ky, propagate_nan=propagate_nan)
        before = msp.launch_count()
        got = msp.map_spline(*args, **kw)
        torch.cuda.synchronize()
        assert msp.launch_count() == before + 1
        _assert_within_one_ulp(got, msp.map_spline_plain(*args, **kw))


# ---------------------------------------------------------------------------
# The limb and terminator curves (the wireframe's geometry)
# ---------------------------------------------------------------------------

#: Points of a bulk curve (its (n, 3) tensors exceed _device.BULK_ELEMENTS)
BULK_CURVE = 8192
CURVE_TERMINATOR = dict(only_visible=True, close_loop=True, alt=0.0,
                        method='UMBRAL/TANGENT/ELLIPSOID',
                        corloc='ELLIPSOID TERMINATOR')


@pytest.mark.parametrize('curve', ['limb', 'terminator'])
def test_bulk_curves_run_on_card_and_match_cpu_body(kernel_path, device,
                                                    curve):
    """An 8192-point limb or terminator of a card body runs on the card
    and holds to a CPU body's: body-fixed points within 1e-6 km, RA/Dec
    within the card-vs-CPU angle bar, NaN masks as the CPU tests'."""
    card, cpu = _plane_bodies(device, *PLANES_FRAME)
    if curve == 'limb':
        got = card._limb_targvec(npts=BULK_CURVE)
        ref = cpu._limb_targvec(npts=BULK_CURVE)
    else:
        got = card._terminator_targvec(npts=BULK_CURVE, **CURVE_TERMINATOR)
        ref = cpu._terminator_targvec(npts=BULK_CURVE, **CURVE_TERMINATOR)
    assert got.device.type == 'cuda' and ref.device.type == 'cpu'
    got, ref = got.cpu().numpy(), ref.numpy()
    for axis in range(3):
        report = compare.compare_curve(got[:, axis], ref[:, axis], 1e-6)
        assert report['ok'], report
    method = f'{curve}_radec'
    for g, r, period in zip(getattr(card, method)(npts=BULK_CURVE),
                            getattr(cpu, method)(npts=BULK_CURVE),
                            (360.0, None)):
        report = compare.compare_curve(g, r, compare.F64_CARD_ANGLE,
                                       period=period)
        assert report['ok'], report


def test_small_curves_and_artists_run_on_the_host(kernel_path, device):
    """A 360-point curve (and so the whole wireframe) of a card body runs
    on CPU tensors: the same words as a CPU body's."""
    from planetmapper_tpu_torch import _body_plotting

    card, cpu = _plane_bodies(device, *PLANES_FRAME)
    assert card._limb_targvec().device.type == 'cpu'
    for got, ref in zip(card.terminator_xy(), cpu.terminator_xy()):
        np.testing.assert_array_equal(got, ref)
    kw = dict(grid_interval=30, grid_lat_limit=90, planetocentric_grid=False,
              indicate_equator=False, indicate_prime_meridian=False,
              label_poles=True)
    got = list(_body_plotting._wireframe_artists(card, **kw))
    ref = list(_body_plotting._wireframe_artists(cpu, **kw))
    assert [(s.kind, s.component) for s in got] == \
        [(s.kind, s.component) for s in ref]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.ras, r.ras)
        np.testing.assert_array_equal(g.decs, r.decs)


# ---------------------------------------------------------------------------
# The per-plane getters (get_backplane_img / get_backplane_map)
# ---------------------------------------------------------------------------

#: A frame of more than 4096 pixels (the bulk route: the image chain runs
#: on the card) and a map of more than 4096 samples
PLANES_FRAME = (96, 64, (47.3, 31.8, 26.0, 12.3))
PLANES_MAP = dict(degree_interval=2)


def _plane_bodies(device, nx, ny, disc):
    bodies = {}
    for where in ('cpu', device):
        body = tpm.BodyXY('Jupiter', observer='EARTH',
                          utc='2005-01-01T00:00:00', nx=nx, ny=ny,
                          device=where)
        body.set_disc_params(*disc)
        bodies[torch.device(where).type] = body
    return bodies['cuda'], bodies['cpu']


def _ray_offset(nx, ny, disc):
    yy, xx = np.mgrid[0:ny, 0:nx]
    return np.hypot(xx - disc[0], yy - disc[1]) / disc[2]


def test_cuda_body_image_getters_match_cpu_body(kernel_path, device):
    nx, ny, disc = PLANES_FRAME
    card, cpu = _plane_bodies(device, nx, ny, disc)
    names = list(bk.PLANE_ORDER)
    ref = {n: cpu.get_backplane_img(n) for n in names}
    got = {n: card.get_backplane_img(n) for n in names}
    assert card._get_targvec_img().device.type == 'cuda'
    reports = compare.compare_per_plane(
        got, ref,
        compare.per_plane_tolerance(cpu, angle=compare.F64_CARD_ANGLE,
                                    pixel=0.0),
        compare.per_plane_ill_conditioned(ref, _ray_offset(nx, ny, disc)),
    )
    assert not compare.failures(reports), compare.failures(reports)
    print('mask flips against the CPU body:',
          {k: r['mask_flips'] for k, r in reports.items()})


def test_cuda_body_map_getters_match_cpu_body(kernel_path, device):
    card, cpu = _plane_bodies(device, *PLANES_FRAME)
    names = list(bk.PLANE_ORDER)
    ref = {n: cpu.get_backplane_map(n, **PLANES_MAP) for n in names}
    got = {n: card.get_backplane_map(n, **PLANES_MAP) for n in names}
    assert card._get_state_maps(**PLANES_MAP)[0].device.type == 'cuda'
    # x/y: 8 ulps of an RA between 256 and 512 deg, in pixels (as above)
    pixel = 8 * 2.0**-44 * 3600.0 / cpu.get_plate_scale_arcsec()
    reports = compare.compare_per_plane(
        got, ref,
        compare.per_plane_tolerance(cpu, angle=compare.F64_CARD_ANGLE,
                                    pixel=pixel),
        compare.per_plane_ill_conditioned(
            ref, np.abs(np.sin(np.radians(ref['EMISSION'])))),
    )
    assert not compare.failures(reports), compare.failures(reports)


def test_backplane_img_matches_compute_backplanes_on_card(kernel_path,
                                                          device):
    # the JAX package's fused-vs-per-plane rule (tests/test_pipeline.py
    # TOLS and _compare) against kernel 1
    nx, ny, disc = 333, 257, (120.6, 140.2, 90.0, 45.0)
    body, _ = _plane_bodies(device, nx, ny, disc)
    planes = {n: body.get_backplane_img(n) for n in bk.PLANE_ORDER}
    before = bk.launch_count()
    fused = pipeline.compute_backplanes(body)
    assert bk.launch_count() == before + 1
    reports = compare.compare_with_fused(planes, fused)
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(planes['EMISSION']).sum() > 10_000


def test_image_chain_leaves_no_host_tensor(kernel_path, device):
    body, _ = _plane_bodies(device, *PLANES_FRAME)
    for name in bk.PLANE_ORDER:
        body.get_backplane_img(name)
    tensors, host = [], []
    for key, value in body._cache.items():
        for v in (value if isinstance(value, tuple) else (value,)):
            if isinstance(v, torch.Tensor):
                tensors.append(v)
            elif isinstance(v, np.ndarray) and v.size > 9:
                host.append(key[0])
    # every cached step of the chain is a float64 tensor on the card; the
    # only host arrays are the getters' copies of a plane
    assert len(tensors) >= 12
    assert all(t.device.type == 'cuda' and t.dtype == torch.float64
               for t in tensors)
    assert set(host) == {'_img_plane', 'get_azimuth_angle_img',
                         'get_local_solar_time_img', 'get_distance_img',
                         'get_radial_velocity_img'}


# ---------------------------------------------------------------------------
# Observation: a card Observation against a CPU one
# ---------------------------------------------------------------------------

#: 96x64, 3 frames: a bulk frame; a bulk 90x180 map (both run on the card)
OBS_FRAME = (96, 64, (47.3, 31.8, 25.6, 12.3))
OBS_MAP = dict(degree_interval=2)


@pytest.fixture(scope='module')
def observations(kernel_path, device, tmp_path_factory):
    """The same FITS observation on the card and on the CPU."""
    nx, ny, disc = OBS_FRAME
    noise = np.random.default_rng(4).normal(size=(3, ny, nx))
    cube = observation_files.disc_cube(noise, disc)
    cube[1, 10:13, 20:24] = np.nan
    path = str(tmp_path_factory.mktemp('observation') / 'obs.fits')
    observation_files.write_observation(path, cube, disc,
                                        '2005-01-01T00:00:00')
    return (tpm.Observation(path, device=device),
            tpm.Observation(path, device='cpu'))


@pytest.mark.parametrize('mapped', [False, True])
def test_observation_files_card_match_cpu(observations, tmp_path, mapped):
    card, cpu = observations
    files = {}
    for label, obs in (('card', card), ('cpu', cpu)):
        path = tmp_path / f'{label}.fits'
        if mapped:
            obs.save_mapped_observation(path, include_wireframe=False,
                                        print_info=False, **OBS_MAP)
        else:
            obs.save_observation(path, include_wireframe=False,
                                 print_info=False)
        files[label] = observation_files.read_fits(path)
    (names, headers, data), (ref_names, ref_headers, ref_data) = (
        files['card'], files['cpu'])
    assert names == ref_names == [''] + list(bk.PLANE_ORDER)
    # the disc, the metadata and the map WCS are host computations on both
    for got, ref in zip(headers, ref_headers):
        assert not compare.compare_headers(
            got, ref, angle=compare.F64_CARD_ANGLE, pixel=1e-9,
            relative=1e-12)
    if mapped:
        # float64 copies of float32 maps: the casts back are exact
        got, ref = (torch.from_numpy(d[0].astype(np.float32))
                    for d in (data, ref_data))
        _assert_within_map_bar(got, ref)
        offset = np.abs(np.sin(np.radians(ref_data[names.index('EMISSION')])))
        pixel = 8 * 2.0**-44 * 3600.0 / cpu.get_plate_scale_arcsec()
    else:
        np.testing.assert_array_equal(data[0], ref_data[0])
        offset = _ray_offset(*OBS_FRAME)
        pixel = 0.0
    refs = dict(zip(names[1:], ref_data[1:]))
    reports = compare.compare_per_plane(
        dict(zip(names[1:], data[1:])), refs,
        compare.per_plane_tolerance(cpu, angle=compare.F64_CARD_ANGLE,
                                    pixel=pixel),
        compare.per_plane_ill_conditioned(refs, offset),
    )
    assert not compare.failures(reports), compare.failures(reports)


def test_get_mapped_data_launches_map_kernels(observations):
    # copies: the mapped data is cached per observation
    card, cpu = (o.copy() for o in observations)
    for interpolation, libs in (('linear', [msp]), ('cubic', [msp]),
                                ('smooth', [msk, pk])):
        for lib in (msp, msk, pk):
            lib.reset_launch_count()
        got = card.get_mapped_data(interpolation, **OBS_MAP)
        # the cube in one launch of each kernel (the PCHIP kernel: one
        # per axis)
        assert [lib.launch_count() for lib in libs] == \
            [2 if lib is pk else 1 for lib in libs]
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert got.shape == (3, 90, 180)
        ref = cpu.get_mapped_data(interpolation, **OBS_MAP)
        _assert_within_map_bar(torch.from_numpy(got.astype(np.float32)),
                               torch.from_numpy(ref.astype(np.float32)))


def test_disc_fits_run_on_the_card(observations, monkeypatch):
    from planetmapper_tpu_torch.ops import photometry

    card, cpu = (o.copy() for o in observations)
    devices = []
    for name in ('circular_aperture_sums', 'threshold_centroid'):
        original = getattr(photometry, name)

        def recorded(img, *args, _original=original):
            devices.append(img.device.type)
            return _original(img, *args)
        monkeypatch.setattr(photometry, name, recorded)
    for obs in (card, cpu):
        obs.fit_disc_position()
        obs.fit_disc_radius()
    assert devices == ['cuda', 'cuda', 'cpu', 'cpu']
    # the same centroid (exact moments of the same mask) and the same
    # radius of steepest decline
    np.testing.assert_allclose(card.get_disc_params(), cpu.get_disc_params(),
                               rtol=0, atol=1e-9)
    assert card.get_disc_method() == 'fit_r0'


# ---------------------------------------------------------------------------
# The dsk kernels (csrc/dsk.cu)
# ---------------------------------------------------------------------------

def _assert_bitwise(got, ref):
    """Built with -fmad=false, an FMA two_prod and the plain version's
    seeds, the kernels equal their plain versions word for word (NaN
    matches NaN whatever its payload)."""
    for g, r in zip(got, ref):
        g, r = g.cpu(), r.cpu()
        nan = torch.isnan(r)
        assert torch.equal(torch.isnan(g), nan)
        assert torch.equal(g[~nan].view(torch.int32),
                           r[~nan].view(torch.int32))


def _assert_atan2_ds_bar(got, ref, edges=()):
    """The kernel takes native float64 and its plain version the ds chain:
    NaN where the plain version has NaN, |hi + lo - plain| <= the bar,
    and of the ``edges`` (pairs of dsk_cases.EDGES that the inputs start
    with) those on the axes, at the origin and at NaN word for word: the
    port's zero conventions."""
    value = (got[0].double() + got[1].double()).cpu()
    want = (ref[0].double() + ref[1].double()).cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(value), nan)
    assert torch.equal(torch.isnan(got[1]).cpu(), nan)
    assert float((value - want)[~nan].abs().max()) <= \
        dsk_cases.ATAN2_DS_VS_PLAIN
    axes = [i for i, e in enumerate(edges) if dsk_cases.on_an_axis(*e)]
    _assert_bitwise([t[axes] for t in got], [t[axes] for t in ref])


def _assert_matches_plain(op, got, ref, edges=()):
    if op == 'atan2_ds':
        _assert_atan2_ds_bar(got, ref, edges)
    else:
        _assert_bitwise(got, ref)


def _edge_pairs(op: str, n: int):
    """The op's case inputs at n values (a ragged count), with the edge
    values in front."""
    a, b = dsk_cases.pair_inputs(op, n)
    edges = np.array(dsk_cases.EDGES)
    if op != 'atan2_ds':
        edges = edges * 1e9
    return np.concatenate([edges[:, 0], a]), np.concatenate([edges[:, 1], b])


@pytest.mark.parametrize('op', dsk_kernel.OPS)
@pytest.mark.parametrize('n', [dsk_cases.N_TEST, 1000_003])
def test_dsk_pairs_matches_plain_version(device, op, n):
    a64, b64 = _edge_pairs(op, n)
    a = dsk.split_f64(torch.from_numpy(a64).to(device))
    b = dsk.split_f64(torch.from_numpy(b64).to(device))
    before = dsk_kernel.launch_count('dsk_pairs')
    got = dsk_kernel.pairs(op, a, b)
    torch.cuda.synchronize()
    assert dsk_kernel.launch_count('dsk_pairs') == before + 1
    assert all(t.device.type == 'cuda' for t in got)
    _assert_matches_plain(op, got, dsk_kernel.pairs_plain(op, a, b),
                          dsk_cases.EDGES)
    k = len(dsk_cases.EDGES)
    value = (got[0].double() + got[1].double()).cpu().numpy()[k:]
    assert dsk_cases.error(op, value, a64[k:], b64[k:]) < \
        dsk_cases.GRADES[op]


@pytest.mark.parametrize('n', [dsk_cases.N_TEST, 1000_003])
def test_dsk_atan2_ds_is_the_float64_atan2(device, n):
    """dsk_pairs<atan2_ds> against torch.atan2 in float64 on the card, on
    the same hi + lo with zeros taken as +0, split into a pair
    (dsk_kernel.atan2_ds_native): word for word."""
    y64, x64 = _edge_pairs('atan2_ds', n)
    y = dsk.split_f64(torch.from_numpy(y64).to(device))
    x = dsk.split_f64(torch.from_numpy(x64).to(device))
    got = dsk_kernel.pairs('atan2_ds', y, x)
    _assert_bitwise(got, dsk_kernel.atan2_ds_native(y, x))


#: Values of a misaligned view: above the kernels' 2^17-value floor of the
#: vector loop, so that the alignment alone sends it to the scalar loop
VIEW_VALUES = 2**17 + 4


def _short_or_misaligned(op: str, count, device):
    """The op's inputs (edges in front) on the card: ``count`` values in
    fresh buffers, or for 'view' the contiguous views t[1:] of
    VIEW_VALUES + 1 values, 4 bytes past a 16-byte boundary."""
    n = VIEW_VALUES + 1 if count == 'view' else count
    if op == 'atan2':
        y, x = dsk_cases.atan2_inputs(n)
        edges = np.array(dsk_cases.EDGES, dtype=np.float32)
        a = (torch.from_numpy(np.concatenate([edges[:, 0], y])[:n]),)
        b = (torch.from_numpy(np.concatenate([edges[:, 1], x])[:n]),)
    else:
        a64, b64 = _edge_pairs(op, n)
        a = dsk.split_f64(torch.from_numpy(a64[:n]))
        b = dsk.split_f64(torch.from_numpy(b64[:n]))
    a, b = ([t.to(device) for t in p] for p in (a, b))
    if count == 'view':
        a, b = ([t[1:] for t in p] for p in (a, b))
        assert all(t.is_contiguous() and t.data_ptr() % 16 == 4
                   for t in (*a, *b))
    return tuple(a), tuple(b)


@pytest.mark.parametrize('count', ['view', 1, 3, 5])
@pytest.mark.parametrize('op', [*dsk_kernel.OPS, 'atan2'])
def test_dsk_kernels_on_misaligned_views_and_short_counts(device, op,
                                                          count):
    """The scalar loop: every value of a call whose pointers are not
    16-byte aligned (a view t[1:], inputs through the wrapper and outputs
    through the launch function), and of a short call; each against its
    plain version, launched and counted. (The vector loop's tail, n % 4
    values, runs in the tests at 1000_003 + 15 values.)"""
    a, b = _short_or_misaligned(op, count, device)
    kernel = 'dsk_atan2' if op == 'atan2' else 'dsk_pairs'
    before = dsk_kernel.launch_count(kernel)
    if op == 'atan2':
        got = (dsk_kernel.atan2(a[0], b[0]),)
        plain = (dsk_kernel.atan2_plain(a[0], b[0]),)
    else:
        got = dsk_kernel.pairs(op, a, b)
        plain = dsk_kernel.pairs_plain(op, a, b)
    torch.cuda.synchronize()
    assert dsk_kernel.launch_count(kernel) == before + 1
    front = dsk_cases.EDGES[1:] if count == 'view' else \
        dsk_cases.EDGES[:count]
    _assert_matches_plain(op, got, plain, front)
    if count == 'view':
        # misaligned outputs too: views of fresh buffers, one value in
        out = [torch.full((t.numel() + 1,), -7.0, device=device)[1:]
               for t in got]
        if op == 'atan2':
            dsk_kernel.launch_atan2(a[0], b[0], *out)
        else:
            dsk_kernel.launch_pairs(op, *a, *b, *out)
        torch.cuda.synchronize()
        _assert_bitwise(out, got)


@pytest.mark.parametrize('n', [dsk_cases.N_TEST, 1000_003])
def test_dsk_atan2_matches_plain_version(device, n):
    y, x = dsk_cases.atan2_inputs(n)
    edges = np.array(dsk_cases.EDGES, dtype=np.float32)
    y = torch.from_numpy(np.concatenate([edges[:, 0], y])).to(device)
    x = torch.from_numpy(np.concatenate([edges[:, 1], x])).to(device)
    before = dsk_kernel.launch_count('dsk_atan2')
    got = dsk_kernel.atan2(y, x)
    torch.cuda.synchronize()
    assert dsk_kernel.launch_count('dsk_atan2') == before + 1
    _assert_bitwise([got], [dsk_kernel.atan2_plain(y, x)])
    k = len(dsk_cases.EDGES)
    assert dsk_cases.error('atan2', got[k:].cpu().numpy(),
                           y[k:].cpu().numpy(), x[k:].cpu().numpy()) < \
        dsk_cases.GRADES['atan2']


def test_dsk_faults_raise(device):
    a = dsk.split_f64(torch.ones(8, dtype=torch.float64, device=device))
    lib = dsk_kernel.load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    out = torch.empty(8, device=device)
    # an op the kernel does not have: the launch function refuses it
    rc = lib.dsk_pairs_launch(7, *(t.data_ptr() for t in (*a, *a)),
                              out.data_ptr(), out.data_ptr(), 8, stream)
    with pytest.raises(RuntimeError, match='cudaError'):
        check_launch(rc, 'dsk_pairs')
    # a host tensor among CUDA ones, and a strided buffer, raise
    with pytest.raises(ValueError):
        dsk_kernel.pairs('mul', a, (a[0].cpu(), a[1].cpu()))
    with pytest.raises(ValueError):
        dsk_kernel.launch_atan2(a[0][::2], a[0][::2], out[::2])
    # no fallback: a CUDA call launches, or raises
    before = dsk_kernel.launch_count('dsk_pairs')
    dsk_kernel.pairs('div', a, a)
    assert dsk_kernel.launch_count('dsk_pairs') == before + 1


# ---------------------------------------------------------------------------
# The shells and SPK type 10 on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tle_kernel_path(tmp_path_factory, device):
    """Synthetic kernels with the type 10 segments (HST, -48)."""
    path = tmp_path_factory.mktemp('synthetic_kernels_tle')
    write_synthetic_kernels(path, seed=0, tle=True)
    previous, source = tpm.get_kernel_path(return_source=True)
    tpm.clear_kernels()
    tpm.set_kernel_path(path)
    yield path
    tpm.clear_kernels()
    tpm.set_kernel_path(previous if source == 'set_kernel_path()' else None)


def test_hst_body_kernel_planes_match_cpu_body(tle_kernel_path, device):
    """Jupiter seen from HST (the observer on the type 10 chain): the card
    body's kernel 1 planes against a CPU body's plain version."""
    disc = (64.3, 60.7, 50.2, 33.0)
    bodies = [tpm.BodyXY('Jupiter', observer='HST',
                         utc='2005-01-01T00:00:00', nx=128, ny=120,
                         device=d) for d in (device, 'cpu')]
    for body in bodies:
        body.set_disc_params(*disc)
    before = bk.launch_count()
    got = _numpy(pipeline.compute_backplanes(bodies[0], as_numpy=False))
    assert bk.launch_count() == before + 1
    ref = pipeline.compute_backplanes(bodies[1])
    reports = compare.compare_backplanes(got, ref, float32_ulps=1)
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(got['EMISSION']).sum() > 1000


def test_prewarm_runs_the_kernels_on_the_card(kernel_path, device, capsys):
    """``--prewarm 64``: the libraries built or loaded, kernel 1 and the map
    infill and spline kernels launched, the steps' lines printed."""
    from planetmapper_tpu_torch import cli

    before = bk.launch_count(), msp.launch_count(), mik.launch_count()
    cli.main(['--prewarm', '64'])
    assert bk.launch_count() == before[0] + 1
    assert msp.launch_count() > before[1]
    assert mik.launch_count() == before[2] + 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('prewarm: 5 kernel libraries built or loaded')
    assert lines[1].startswith('prewarm JUPITER/EARTH 64x64: backplane')
    assert lines[2].startswith('prewarm 64x64: map reprojection ran in')
    assert lines[3].startswith('kernel build directory: ')
