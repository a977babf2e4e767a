"""
The port's CUDA kernels (backplanes, map spline, map smooth) against their
plain PyTorch versions, on the card. Every test here carries the ``cuda``
marker and skips without a CUDA device; on a machine with one:

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
from planetmapper_tpu_torch import pipeline
from planetmapper_tpu_torch._device import f64
from planetmapper_tpu_torch.ops import backplanes_kernel as bk
from planetmapper_tpu_torch.ops import interp_device, pchip_device
from planetmapper_tpu_torch.ops import map_smooth_kernel as msk
from planetmapper_tpu_torch.ops import map_spline_kernel as msp
from planetmapper_tpu_torch.testing import compare
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
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01T00:00:00',
                      nx=nx, ny=ny, device=device)
    body.set_disc_params(*disc)
    *values, anchors = pipeline.pipeline_inputs(body)
    return body, (*(f64(v, device) for v in values),
                  pipeline.anchors_from_numpy(anchors, device))


def _numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize('nx, ny, disc', [
    (128, 64, (64.3, 32.3, 28.8, 12.3)),
    (100, 70, (50.3, 34.7, 30.0, 200.0)),
    (333, 257, (120.6, 140.2, 90.0, 45.0)),
])
@pytest.mark.parametrize('optimize_speed', [True, False])
def test_kernel_matches_plain_version(
    kernel_path, device, nx, ny, disc, optimize_speed
):
    _, args = _body(nx, ny, disc, device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=optimize_speed, lst_quant=True, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(optimize_speed=optimize_speed, **FLAGS)
    before = bk.launch_count()
    got = _numpy(kernel(nx, ny, *args))
    torch.cuda.synchronize()
    assert bk.launch_count() == before + 1
    assert got['EMISSION'].dtype == np.float32
    assert got['RADIAL-VELOCITY'].dtype == np.float64
    reports = compare.compare_backplanes(
        got, _numpy(plain(nx, ny, *args)), float32_ulps=1,
    )
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(got['EMISSION']).sum() > 100


def test_row0_band_equals_full_frame(kernel_path, device):
    nx, ny = 100, 70
    _, args = _body(nx, ny, (50.3, 34.7, 30.0, 12.3), device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    full = _numpy(kernel(nx, ny, *args))
    top = _numpy(kernel(nx, 29, *args))
    bottom = _numpy(kernel(nx, ny - 29, *args, row0=29.0))
    for name, plane in full.items():
        assert np.array_equal(
            np.concatenate([top[name], bottom[name]]), plane, equal_nan=True
        ), name


def test_subsets_equal_full_set(kernel_path, device):
    nx, ny = 128, 64
    _, args = _body(nx, ny, (64.3, 32.3, 28.8, 12.3), device)
    full = _numpy(bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )(nx, ny, *args))
    for planes in [('LON-GRAPHIC', 'LOCAL-SOLAR-TIME'), ('AZIMUTH',),
                   ('DISTANCE', 'DOPPLER', 'RING-DISTANCE')]:
        sub = _numpy(bk.build_backplanes_kernel(
            optimize_speed=True, lst_quant=True, planes=planes, **FLAGS,
        )(nx, ny, *args))
        assert set(sub) == set(planes)
        for name in planes:
            assert np.array_equal(sub[name], full[name], equal_nan=True), name


def test_triaxial_kernel_matches_robust_plain_graph(kernel_path, device):
    nx, ny, disc = 100, 70, (50.3, 34.7, 30.0, 12.3)
    _, (xy2angular, disc_t, radii, anchors) = _body(nx, ny, disc, device)
    # Jupiter scaled to a triaxial body inside the kernel's geodetic range
    radii = radii * f64([1.0, 0.98, 0.935], device)
    shape = type('Shape', (), {'radii': radii.cpu().numpy()})()
    assert pipeline._kernel_geodetic_iters(shape) == 4
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, geodetic_iters=4, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(robust_geodetic=True, **FLAGS)
    args = (xy2angular, disc_t, radii, anchors)
    before = bk.launch_count()
    got = _numpy(kernel(nx, ny, *args))
    torch.cuda.synchronize()
    assert bk.launch_count() == before + 1
    reports = compare.compare_backplanes(
        got, _numpy(plain(nx, ny, *args)), float32_ulps=1,
    )
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(got['LAT-GRAPHIC']).sum() > 100


def test_scene_from_device_tensors_equals_host_packing(kernel_path, device):
    body, args = _body(96, 80, (47.6, 40.2, 30.0, 12.3), device)
    host = pipeline.pipeline_inputs(body)
    np.testing.assert_array_equal(bk.pack_scene(*args), bk.pack_scene(*host))
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    from_tensors = _numpy(kernel(96, 80, *args))
    from_host = _numpy(kernel.run(bk.pack_scene(*host), 96, 80, device))
    for name, plane in from_tensors.items():
        assert np.array_equal(plane, from_host[name], equal_nan=True), name


def test_compute_backplanes_launches_kernel(kernel_path, device):
    body, _ = _body(96, 80, (47.6, 40.2, 30.0, 12.3), device)
    bk.reset_launch_count()
    out = pipeline.compute_backplanes(body)
    assert bk.launch_count() == 1
    assert set(out) == set(bk.PLANE_ORDER)
    body._pipeline_precision = 'double'
    pipeline.compute_backplanes(body)
    assert bk.launch_count() == 1  # 'double' pins the plain graph


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
    assert np.all(np.abs(got[finite] - ref[finite]) <= ulp)


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
    cleaned = img.clone()
    nans = torch.zeros(img.shape, dtype=torch.bool, device=device)
    for i in range(frames):
        cleaned[i], nans[i] = interp_device._infill_device(img[i])
    coeffs = ainv_y @ (cleaned @ ainv_x.T)
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


@pytest.mark.parametrize('propagate_nan', [True, False])
@pytest.mark.parametrize('nan, frames', [(False, 1), (True, 1), (True, 3)])
def test_map_smooth_matches_plain_version(device, propagate_nan, nan, frames):
    n = 150
    img, samples = _map_case(n, frames, nan, 7 * frames, device)
    box = pchip_device.smooth_box(samples.limits, n, n)
    iy0, iy1, ix0, ix1 = box
    grids = torch.stack([
        pchip_device.oversample(f, box, 5, 5) for f in img
    ])
    args = (samples.x, samples.y, samples.valid, grids, torch.isnan(img))
    kw = dict(iy0=iy0, ix0=ix0, y_step=0.2, x_step=0.2,
              propagate_nan=propagate_nan)
    before = msk.launch_count()
    got = msk.map_smooth(*args, **kw)
    torch.cuda.synchronize()
    assert msk.launch_count() == before + 1
    _assert_within_one_ulp(got, msk.map_smooth_plain(*args, **kw))


def test_map_img_launches_map_kernels(kernel_path, device):
    bodies = {}
    for where in ('cpu', device):
        body = tpm.BodyXY('Jupiter', observer='EARTH',
                          utc='2005-01-01T00:00:00', sz=150, device=where)
        body.set_disc_params(75.0, 75.0, 60.0, 12.3)
        bodies[torch.device(where).type] = body
    img = np.random.default_rng(0).normal(size=(150, 150))
    img[40:44, 50:53] = np.nan
    for interpolation, lib in (('cubic', msp), ((3, 1), msp), (4, msp),
                               (5, msp), ((5, 1), msp), ((1, 5), msp),
                               ('smooth', msk)):
        lib.reset_launch_count()
        got = bodies['cuda'].map_img(img, interpolation=interpolation,
                                     degree_interval=2)
        assert got.device.type == 'cuda' and lib.launch_count() == 1
        ref = bodies['cpu'].map_img(img, interpolation=interpolation,
                                    degree_interval=2)
        _assert_within_one_ulp(got, ref)


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
