"""
The port's ``BodyXY.map_img`` against the JAX package's, on the synthetic
SPICE kernels (Jupiter from the Earth on 2005-01-01, a 150x150 frame):

- map coordinates of every projection and the x/y maps;
- the cached collocation solve state (knots and inverses);
- whole-body ``map_img`` in every mode, with and without NaN/inf pixels,
  for frames and a cube holding an all-NaN frame;
- the plain versions of the two map kernels against the JAX package's TPU
  kernels run in interpret mode, one map tile each;
- the NaN infill against the host implementation (median of an even count
  of finite pixels);
- the 'smooth' stage's PCHIP oversampling: a cube at once equals frame by
  frame, and the work split of ``csrc/pchip.cu`` (chunks, the neighbour
  scans over the threads' runs, one derivative per finite cell, one
  position a thread), transcribed into Python, equals the plain version
  bit for bit;
- the map chain of a body on another device (PyTorch's ``meta`` device)
  keeps every map on that device;
- the spline kernel's uniform-knot path, transcribed from
  ``csrc/map_spline.cu`` into numpy (its interval by the 1.5 * 2^52 shift,
  its cardinal polynomials from the integer recurrence), against the plain
  version's basis, the knot descriptors the device path hands the
  kernel, and the interval its search finds on other knots.

Inputs come from a numpy seed and pass to both packages as numpy arrays.
The kernels themselves against their plain versions on the card are
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import math
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu_torch import tracing
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu.ops import interp as j_interp
from planetmapper_tpu.ops import interp_device as j_idev
from planetmapper_tpu.ops import map_pallas as j_map_pallas
from planetmapper_tpu.ops import pchip_device as j_pchip
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.ops import interp as t_interp
from planetmapper_tpu_torch.ops import interp_device as t_idev
from planetmapper_tpu_torch.ops import (
    map_infill_kernel,
    map_smooth_kernel,
    map_spline_kernel,
    pchip_kernel,
)
from planetmapper_tpu_torch.ops import pchip_device as t_pchip
from planetmapper_tpu_torch.testing import infill_cases
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
SIZE = 150
DISC = (75.0, 75.0, 60.0, 12.3)
MAP = dict(degree_interval=5)  # a 36x72 map, half of it on the disc

#: The JAX package's own device-vs-host bars for the spline and smooth
#: modes (tests/test_shells.py: TestDeviceSolveInterp, smooth
#: test_matches_host), relative to the map's largest value when above 1:
#: its CPU path evaluates in float32 (coefficients and coordinates), the
#: port in float64.
JAX_BAR = 2e-5
#: The port against the host scipy reference (both float64, the port
#: stores float32): the float32 rounding of the port's result.
F32_BAR = 2.0**-23


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def bodies(tmp_path_factory):
    """The same BodyXY in both packages, on the synthetic kernels."""
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0)
    previous = {
        pkg: pkg.get_kernel_path(return_source=True) for pkg in (jpm, tpm)
    }
    for pkg, pool_mod in ((jpm, j_pool), (tpm, t_pool)):
        pkg.clear_kernels()
        pkg.set_kernel_path(path)
        pool_mod.load_spice_kernels()
    j_body = jpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE)
    t_body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                        device='cpu')
    for body in (j_body, t_body):
        body.set_disc_params(*DISC)
    yield j_body, t_body
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


def _image(nan_block: bool, seed: int = 0) -> np.ndarray:
    img = np.random.default_rng(seed).normal(size=(SIZE, SIZE))
    if nan_block:
        img[40:44, 50:53] = np.nan  # as tests/test_pallas_core.py:712
        img[70:73, 90:92] = np.nan
        img[80, 60] = np.inf
    return img


def _assert_parity(got, ref, bar):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    both = ~np.isnan(ref)
    assert both.any()
    scale = max(float(np.max(np.abs(ref[both]))), 1.0)
    assert np.max(np.abs(got[both] - ref[both])) <= bar * scale


# ---------------------------------------------------------------------------
# (a) Map coordinates
# ---------------------------------------------------------------------------

def _projection_kwargs(body, name):
    # two map shapes (24x48, 31x31), so the JAX package compiles its map
    # programs twice, not once per projection
    return {
        'rectangular': dict(degree_interval=7.5),
        'orthographic': dict(projection='orthographic', lon=40.0, lat=-20.0,
                             size=31),
        'azimuthal': dict(projection='azimuthal', lon=10.0, lat=35.0,
                          size=31),
        'azimuthal equal area': dict(projection='azimuthal equal area',
                                     lon=300.0, lat=5.0, size=31),
        'manual': dict(projection='manual',
                       lon_coords=np.linspace(3.0, 357.0, 48),
                       lat_coords=np.linspace(-85.0, 85.0, 24)),
        'proj string': dict(
            projection=body.create_proj_string('ortho', lon_0=20, lat_0=10),
            projection_x_coords=np.linspace(-8e4, 8e4, 31),
        ),
    }[name]


@pytest.mark.parametrize('name', [
    'rectangular', 'orthographic', 'azimuthal', 'azimuthal equal area',
    'manual', 'proj string',
])
def test_map_coordinates_match_jax(bodies, name):
    j_body, t_body = bodies
    kwargs = _projection_kwargs(j_body, name)
    assert _projection_kwargs(t_body, name).get('projection') == \
        kwargs.get('projection')
    j_out = j_body.generate_map_coordinates(**kwargs)
    t_out = t_body.generate_map_coordinates(**kwargs)
    for j_arr, t_arr in zip(j_out[:4], t_out[:4]):
        np.testing.assert_array_equal(t_arr, np.asarray(j_arr))
    assert t_out[5] == j_out[5]
    for getter in ('get_x_map', 'get_y_map'):
        ref = np.asarray(getattr(j_body, getter)(**kwargs))
        got = getattr(t_body, getter)(**kwargs)
        assert got.shape == ref.shape
        assert np.array_equal(np.isnan(got), np.isnan(ref)), getter
        assert np.isfinite(ref).sum() > 20
        # the x/y maps come from RA/Dec maps held in degrees, where the two
        # packages' float64 rounding differs in the last ulps; one ulp of an
        # RA near 250 deg (2.8e-14 deg) is 3.3e-10 px at this frame's
        # 0.31 arcsec/px, so 1e-9 px would hold them to 3 ulps
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-9,
                                   equal_nan=True)


def test_lonlat_map_and_empty_map(bodies):
    j_body, t_body = bodies
    np.testing.assert_array_equal(
        t_body._get_lonlat_map(**MAP), np.asarray(j_body._get_lonlat_map(**MAP))
    )
    assert t_body._make_empty_map(**MAP).shape == (36, 72)
    assert t_body._make_empty_map(3, **MAP).shape == (36, 72, 3)
    assert t_body.create_proj_string('moll') == \
        j_body.create_proj_string('moll')
    with pytest.raises(Exception, match='axis'):
        t_body.generate_map_coordinates(
            '+proj=ortho +type=crs', projection_x_coords=np.zeros(3)
        )


# ---------------------------------------------------------------------------
# (b) Collocation solve state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('ny, nx, kx, ky', [
    (21, 17, 1, 1), (30, 26, 2, 2), (12, 40, 3, 3), (25, 19, 1, 3),
])
def test_grid_spline_solver_matches_jax(ny, nx, kx, ky):
    ref = j_idev._grid_spline_solver(ny, nx, kx, ky)
    got = t_idev._grid_spline_solver(ny, nx, kx, ky)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=1e-12)


@pytest.mark.parametrize('ny, nx', [(8, 8), (12, 9), (21, 17), (64, 64),
                                    (150, 150), (1024, 1024), (2048, 2048)])
def test_degree_one_inverses_are_the_identity(ny, nx):
    # the skip's precondition at the sizes the tests and the benchmark map
    _, _, ainv_y, ainv_x = t_idev._grid_spline_solver(ny, nx, 1, 1)
    assert np.array_equal(ainv_y, np.eye(ny))
    assert np.array_equal(ainv_x, np.eye(nx))
    solver = t_idev._device_solver(ny, nx, 1, 1, torch.device('cpu'))
    assert solver[2] is None and solver[3] is None


def _spline_samples(n: int, seed: int) -> t_idev.MapSamples:
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-2, n + 1, 30),
                         np.linspace(-2, n + 1, 50), indexing='ij')
    x_map = xx + np.sin(yy / 5.0)
    y_map = yy + np.cos(xx / 7.0)
    x_map[rng.uniform(size=x_map.shape) < 0.05] = np.nan
    return t_idev._device_xy(x_map, y_map, torch.device('cpu'))


def _spline_frames(n: int, seed: int) -> np.ndarray:
    img = np.random.default_rng(seed).normal(size=(3, n, n))
    img[:, 10:13, 20:23] = np.nan
    img[1, 5, 5] = np.inf
    img[2] = np.nan
    return img


@pytest.mark.parametrize('cube', [False, True])
@pytest.mark.parametrize('propagate_nan', [True, False])
def test_degree_one_map_equals_the_map_with_the_products(cube,
                                                         propagate_nan):
    n = 40
    img = _spline_frames(n, 4)
    samples = _spline_samples(n, 4)
    got = t_idev.spline_interpolation_device(
        _t(img if cube else img[0]), samples, interpolation=1,
        warn_nan=False, propagate_nan=propagate_nan,
        spline_smoothing=0,
    )
    frames = _t(img if cube else img[:1])
    ty, tx, ainv_y, ainv_x = t_idev._grid_spline_solver(n, n, 1, 1)
    cleaned, nans, finite = map_infill_kernel.map_infill(frames)
    coeffs = _t(ainv_y) @ (cleaned @ _t(ainv_x).T)
    want = map_spline_kernel.map_spline(
        samples.x, samples.y, samples.valid, _t(ty), _t(tx), coeffs, nans,
        kx=1, ky=1, propagate_nan=propagate_nan,
    )
    if not propagate_nan:
        want = torch.where((finite == 0)[:, None], torch.nan, want)
    want = want.reshape((-1,) + samples.shape)
    # the same values, a zero's sign aside (np.array_equal: -0.0 == 0.0)
    assert np.array_equal(got.numpy(), (want if cube else want[0]).numpy(),
                          equal_nan=True)
    assert torch.isfinite(got).any()
    if cube:
        assert torch.isnan(got[2]).all()


@pytest.mark.parametrize('interpolation, solves, skipped', [
    (1, 0, 2), ((1, 3), 1, 1), ((3, 1), 1, 1), (2, 2, 0), (3, 2, 0),
])
def test_solve_counters_count_each_frames_axis_products(interpolation,
                                                        solves, skipped):
    n = 24
    frames = _spline_frames(n, 5)
    tracing.reset('map.solves', 'map.solve_skipped')
    t_idev.spline_interpolation_device(
        _t(frames), _spline_samples(n, 5), interpolation=interpolation,
        warn_nan=False, propagate_nan=True, spline_smoothing=0,
    )
    counts = tracing.counts()
    assert counts.get('map.solves', 0) == solves * len(frames)
    assert counts.get('map.solve_skipped', 0) == skipped * len(frames)


# ---------------------------------------------------------------------------
# (c) Whole-body map_img
# ---------------------------------------------------------------------------

MODES = ['nearest', 1, 2, 3, (3, 1), 4, (5, 1), (1, 5), 'smooth']


@pytest.mark.parametrize('interpolation', MODES)
@pytest.mark.parametrize('propagate_nan', [True, False])
@pytest.mark.parametrize('nan_block', [False, True])
def test_map_img_matches_jax(bodies, interpolation, propagate_nan, nan_block):
    j_body, t_body = bodies
    img = _image(nan_block)
    kwargs = dict(interpolation=interpolation, propagate_nan=propagate_nan,
                  **MAP)
    ref = np.asarray(j_body.map_img(img, **kwargs))
    got = t_body.map_img(img, **kwargs)
    assert isinstance(got, torch.Tensor) and got.device.type == 'cpu'
    assert got.dtype == (
        torch.float64 if interpolation == 'nearest' else torch.float32
    )
    assert ref.dtype == got.numpy().dtype
    if interpolation == 'nearest':
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    _assert_parity(got, ref, JAX_BAR)
    if interpolation != 'smooth':
        host = np.full(ref.shape, np.nan)
        t_interp.spline_interpolation(
            img, t_body.get_x_map(**MAP), t_body.get_y_map(**MAP), host,
            interpolation=interpolation, warn_nan=False,
            propagate_nan=propagate_nan, spline_smoothing=0,
        )
        _assert_parity(got, host, F32_BAR)


@pytest.mark.parametrize('interpolation', MODES)
@pytest.mark.parametrize('propagate_nan', [True, False])
def test_map_img_cube_matches_jax(bodies, interpolation, propagate_nan):
    j_body, t_body = bodies
    cube = np.stack([_image(False, 1), _image(True, 2),
                     np.full((SIZE, SIZE), np.nan)])
    kwargs = dict(interpolation=interpolation, propagate_nan=propagate_nan,
                  as_numpy=True, **MAP)
    ref = np.asarray(j_body.map_img(cube, **kwargs))
    got = t_body.map_img(cube, **kwargs)
    assert isinstance(got, np.ndarray) and got.shape == (3, 36, 72)
    assert np.isnan(got[2]).all()
    if interpolation == 'nearest':
        np.testing.assert_array_equal(got, ref)
    else:
        _assert_parity(got, ref, JAX_BAR)
    for i in range(2):  # each frame as the cube maps it
        frame = t_body.map_img(cube[i], **kwargs)
        np.testing.assert_array_equal(frame, got[i])


def test_map_img_smoothing_and_options(bodies):
    j_body, t_body = bodies
    img = _image(True, 3)
    kwargs = dict(interpolation='cubic', spline_smoothing=5.0, **MAP)
    ref = np.asarray(j_body.map_img(img, **kwargs))
    got = t_body.map_img(img, as_numpy=True, **kwargs)
    _assert_parity(got, ref, JAX_BAR)
    half = t_body.map_img(img, fetch_dtype=np.float16, **MAP)
    assert half.dtype == torch.float16
    with pytest.raises(ValueError, match='inconsistent'):
        t_body.map_img(img[:-1], **MAP)
    with pytest.raises(ValueError, match='Unknown interpolation'):
        t_body.map_img(img, interpolation='bicubic', **MAP)


def test_map_img_on_cpu_launches_no_kernel(bodies):
    _, t_body = bodies
    libraries = (map_spline_kernel, map_smooth_kernel, pchip_kernel)
    for lib in libraries:
        lib.reset_launch_count()
    cube = np.stack([_image(True), _image(False, 1)])
    for interpolation in ('cubic', 'smooth'):
        t_body.map_img(_image(True), interpolation=interpolation, **MAP)
        t_body.map_img(cube, interpolation=interpolation, **MAP)
    assert [lib.launch_count() for lib in libraries] == [0, 0, 0]


def test_map_chain_stays_on_the_bodys_device(bodies):
    # PyTorch's meta device stands in for the card: any step that made a
    # CPU tensor or a host array inside the chain would fail to mix with it
    _, t_body = bodies
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SIZE,
                      device='meta')
    body.set_disc_params(*DISC)
    bulk = dict(degree_interval=2)  # 90 x 180 samples, above BULK_ELEMENTS
    assert 90 * 180 > tpm._device.BULK_ELEMENTS >= 36 * 72
    for getter in ('_targvec_map', '_illumf_map', '_obsvec_map',
                   '_radec_map', '_xy_map'):
        got = getattr(body, getter)(**bulk)
        assert got.device.type == 'meta' and got.dtype == torch.float64
        # a small map takes the host, as a scalar scene call
        assert getattr(body, getter)(**MAP).device.type == 'cpu'
    assert body._xy_map(**bulk).shape == (90, 180, 2)
    # the CPU body's maps are host tensors, copied out by the getters
    assert t_body._xy_map(**bulk).device.type == 'cpu'
    np.testing.assert_array_equal(t_body.get_x_map(**bulk),
                                  t_body._xy_map(**bulk)[..., 0].numpy())
    # one host copy per map and disc serves both getters
    assert t_body._get_xy_map(**bulk) is t_body._get_xy_map(**bulk)


def _transform_cases(t_body, rng):
    """(transform, arguments) pairs of the map chain, on numpy arrays."""
    lon = rng.uniform(0.0, 2 * np.pi, 7)
    lat = rng.uniform(-1.4, 1.4, 7)
    lat[3] = np.nan
    targvec = t_body._lonlat2targvec_radians(lon, lat, alt=0.0,
                                             not_visible_nan=False)
    obsvec = t_body._targvec2obsvec(targvec)
    ra, dec = t_body._obsvec2radec_radians(obsvec)
    return {
        'lonlat2targvec': (lambda a, b: t_body._lonlat2targvec_radians(
            a, b, alt=0.0, not_visible_nan=True), (lon, lat)),
        'illumf': (t_body._illumf_from_targvec_radians, (targvec,)),
        'obsvec2radec': (t_body._obsvec2radec_radians, (obsvec,)),
        'radec2obsvec': (t_body._radec2obsvec_norm_radians, (ra, dec)),
        'obsvec2angular': (t_body._obsvec2angular, (obsvec,)),
        'obsvec2xy': (t_body._obsvec2xy, (obsvec,)),
    }


@pytest.mark.parametrize('name', ['lonlat2targvec', 'illumf', 'obsvec2radec',
                                  'radec2obsvec', 'obsvec2angular',
                                  'obsvec2xy'])
def test_transform_takes_numpy_and_tensors_alike(bodies, name):
    # one implementation on tensors: numpy in gives numpy out with the
    # tensor path's values, and one vector gives numbers
    _, t_body = bodies
    fn, args = _transform_cases(t_body, np.random.default_rng(3))[name]
    got_np = fn(*args)
    got_t = fn(*(torch.from_numpy(np.array(a)) for a in args))
    listed = isinstance(got_np, tuple)
    got_np, got_t = (got_np, got_t) if listed else ((got_np,), (got_t,))
    for a, b in zip(got_np, got_t):
        assert isinstance(a, np.ndarray) and isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(a, b.numpy())
    one = fn(*(a[0] for a in args))
    if listed:
        assert all(isinstance(v, (float, bool)) for v in one)
        for v, a in zip(one, got_np):
            np.testing.assert_array_equal(v, a[0])
    else:
        np.testing.assert_array_equal(one, got_np[0][0])


def test_one_non_finite_vector_gives_nan(bodies):
    _, t_body = bodies
    ra, dec = t_body._obsvec2radec_radians([np.inf, 1.0, 0.0])
    assert math.isnan(ra) and math.isnan(dec)
    *angles, visible, lit = t_body._illumf_from_targvec_radians(
        [np.nan, 1.0, 0.0])
    assert all(math.isnan(v) for v in angles)
    assert (visible, lit) == (False, False)


@pytest.mark.parametrize('big', ['grid', 'image'])
def test_map_smooth_refuses_a_frame_of_2_31_values(big):
    # the kernel's offsets in one frame are 32-bit; the shapes alone are
    # checked, so tensors on the meta device stand in for the card's
    side = 46341  # side**2 > 2**31
    small = (2, 2)
    meta = dict(device='meta')
    grid = torch.empty((1, *((side, side) if big == 'grid' else small)),
                       dtype=torch.float64, **meta)
    nan_img = torch.empty((1, *((side, side) if big == 'image' else small)),
                          dtype=torch.uint8, **meta)
    xy = torch.empty(4, dtype=torch.float64, **meta)
    with pytest.raises(ValueError, match='2.31'):
        map_smooth_kernel.launch(
            xy, xy, torch.empty(4, dtype=torch.uint8, **meta), grid, nan_img,
            torch.empty(1, dtype=torch.uint8, **meta),
            torch.empty((1, 4), **meta), iy0=0.0, ix0=0.0, y_step=1.0,
            x_step=1.0, propagate_nan=True)


# ---------------------------------------------------------------------------
# (d) Plain kernel versions against the JAX TPU kernels (interpret mode)
# ---------------------------------------------------------------------------

def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize('kxy', [(1, 1), (2, 2), (3, 3), (3, 1)])
@pytest.mark.parametrize('propagate_nan', [True, False])
def test_map_spline_plain_matches_pallas_kernel(kxy, propagate_nan):
    import scipy.interpolate

    ky, kx = kxy
    rng = np.random.default_rng(3)
    ny_i, nx_i = 20, 24
    img = rng.normal(size=(ny_i, nx_i))
    nans = rng.uniform(size=img.shape) < 0.05
    x = rng.uniform(-3, 26, 400)
    y = rng.uniform(-3, 22, 400)
    valid = rng.uniform(size=400) > 0.05
    x[~valid] = 0.0
    y[~valid] = 0.0
    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(ny_i), np.arange(nx_i), img, kx=ky, ky=kx, s=0
    )
    ty, tx = spline.get_knots()
    c2 = spline.get_coeffs().reshape(len(ty) - ky - 1, len(tx) - kx - 1)
    ev = j_map_pallas.make_pallas_eval(kx, ky, False, propagate_nan,
                                       interpret=True)
    ref = np.asarray(ev(
        jnp.asarray(ty), jnp.asarray(tx), jnp.asarray(c2, jnp.float32),
        jnp.asarray(nans, jnp.float32), jnp.asarray(y), jnp.asarray(x),
        jnp.asarray(valid),
    ))
    got = map_spline_kernel.map_spline(
        _t(x), _t(y), _t(valid, torch.bool), _t(ty), _t(tx), _t(c2[None]),
        _t(nans[None], torch.bool), kx=kx, ky=ky, propagate_nan=propagate_nan,
    )[0].numpy()
    _assert_parity(got, ref, JAX_BAR)


def test_map_spline_plain_matches_windowed_pallas_kernel():
    # a source past the 128^2 window, one 32x64 map tile
    ny_i = nx_i = 160
    kx = ky = 3
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(60, 90, 32), np.linspace(40, 100, 64),
                         indexing='ij')
    x_map = xx + 3 * np.sin(yy / 20.0)
    y_map = yy + 2 * np.cos(xx / 30.0)
    x_map[0, :4] = np.nan
    img = rng.normal(size=(ny_i, nx_i))
    img[70:73, 60:70] = np.nan
    ty, tx, ainv_y, ainv_x = j_idev._grid_spline_solver(ny_i, nx_i, kx, ky)
    valid = np.isfinite(x_map) & np.isfinite(y_map)
    xs = np.where(valid, x_map, 0.0).ravel()
    ys = np.where(valid, y_map, 0.0).ravel()
    plan = j_map_pallas.WindowPlan(
        kx=kx, ky=ky, propagate_nan=True, win=128, tile_h=32, tile_w=64,
        my=32, mx=64, n_cy=ny_i, n_cx=nx_i, ny_i=ny_i, nx_i=nx_i,
    )
    by, bx, aux, oyx, onyx, fits = j_map_pallas.stage_windowed(
        plan, ty, tx, jnp.asarray(ys), jnp.asarray(xs),
        jnp.asarray(valid.ravel()),
    )
    assert bool(fits)
    cleaned, nans = j_idev._infill_device(jnp, jnp.asarray(img))
    c2 = ainv_y @ (np.asarray(cleaned) @ np.asarray(ainv_x).T)
    ev = j_map_pallas.make_pallas_eval_windowed(plan, batched=False,
                                                interpret=True)
    ref = np.asarray(jax.jit(lambda *a: ev(*a))(
        jnp.asarray(c2, jnp.float32), jnp.asarray(nans, jnp.float32),
        by, bx, aux, oyx, onyx,
    ))
    got = map_spline_kernel.map_spline(
        _t(xs), _t(ys), _t(valid.ravel(), torch.bool), _t(ty), _t(tx),
        _t(c2[None]), _t(np.isnan(img)[None], torch.bool), kx=kx, ky=ky,
        propagate_nan=True,
    )[0].numpy()
    _assert_parity(got, ref, JAX_BAR)


@pytest.mark.parametrize('propagate_nan', [True, False])
def test_map_smooth_plain_matches_pallas_kernel(monkeypatch, propagate_nan):
    rng = np.random.default_rng(11)
    ny_i, nx_i = 30, 26
    img = rng.normal(size=(ny_i, nx_i))
    img[rng.uniform(size=img.shape) < 0.05] = np.nan
    # one 32x64 map tile; sorted coordinates keep its footprint local
    x_map = np.sort(rng.uniform(-2, nx_i + 2, (32, 64)), axis=1)
    y_map = np.sort(rng.uniform(-2, ny_i + 2, (32, 64)), axis=0)
    x_map[0, :3] = np.nan
    kwargs = dict(propagate_nan=propagate_nan, oversample_by=5,
                  max_oversampled_img_size=10000)
    monkeypatch.setenv('PLANETMAPPER_TPU_SMOOTH_PALLAS', 'force')
    j_pchip._SMOOTH_STAGED_CACHE.clear()
    ref = j_pchip.smooth_interpolation_device(img, x_map, y_map, **kwargs)
    assert j_pchip._SMOOTH_STAGED_CACHE, 'the Pallas sampler did not run'
    samples = t_idev._device_xy(x_map, y_map, torch.device('cpu'))
    got = t_pchip.smooth_interpolation_device(_t(img), samples, **kwargs)
    _assert_parity(got.numpy(), ref, JAX_BAR)
    host = np.full(x_map.shape, np.nan)
    t_interp.smooth_interpolation(img, x_map, y_map, host, **kwargs)
    _assert_parity(got.numpy(), host, JAX_BAR)


def _pchip_lines(n: int, seed: int) -> np.ndarray:
    """Rows of n cells: clean, NaN gaps (one across most of the row), a
    single finite cell, all NaN, inf, and monotone runs with flat steps."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(9, n)) * 10.0
    rows[1, rng.uniform(size=n) < 0.3] = np.nan
    rows[2, 3:n - 4] = np.nan
    rows[3, :] = np.nan
    rows[3, n // 2] = 1.5
    rows[4, :] = np.nan
    rows[5, :n // 3] = np.inf
    rows[6] = np.cumsum(np.abs(rows[6]))
    rows[7] = np.repeat(rng.normal(size=(n + 2) // 3), 3)[:n]
    rows[8, [0, 1, n - 1]] = np.nan
    return rows


@pytest.mark.parametrize('k_rep', [1, 2, 3, 4, 5])
def test_batched_oversampling_equals_per_frame(k_rep):
    # 18 rows of the cases above per frame; the all-NaN and one-cell rows
    # give the column pass NaN gaps, and a column of the box is NaN but one
    cube = np.stack([np.vstack([_pchip_lines(21, s), _pchip_lines(21, s + 3)])
                     for s in range(3)])
    cube[:, :-2, 6] = np.nan
    cube = torch.from_numpy(cube)
    box = (1, 17, 1, 21)
    got = t_pchip.oversample_frames(cube, box, k_rep, 6 - k_rep)
    for frame, grid in zip(cube, got):
        ref = t_pchip.oversample(frame, box, k_rep, 6 - k_rep)
        assert torch.equal(torch.isnan(grid), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(grid), torch.nan_to_num(ref))
    assert torch.isnan(got).any() and torch.isfinite(got).any()


def _sign(x: float) -> float:
    return float(int(x > 0) - int(x < 0))


def _edge(h0, d0, h1, d1):
    d = ((2.0 * h0 + h1) * d0 - h0 * d1) / (h0 + h1)
    over = _sign(d0) != _sign(d1) and abs(d) > 3.0 * abs(d0)
    if _sign(d) != _sign(d0):
        d = 0.0
    return 3.0 * d0 if over else d


_NONE = (-1, 0.0)


def _derivative(pp, p, c, q, qq):
    """``derivative`` of ``csrc/pchip.cu``: cells are (index, value)."""
    h_prev = c[0] - p[0] if p[0] >= 0 else 1.0
    d_prev = (c[1] - p[1]) / h_prev if p[0] >= 0 else 0.0
    h_next = q[0] - c[0] if q[0] >= 0 else 1.0
    d_next = (q[1] - c[1]) / h_next if q[0] >= 0 else 0.0
    if p[0] >= 0 and q[0] >= 0:
        if not d_prev * d_next > 0.0:
            return 0.0
        w1 = 2.0 * h_next + h_prev
        w2 = h_next + 2.0 * h_prev
        return (w1 + w2) / (w1 / d_prev + w2 / d_next)
    if q[0] >= 0:
        h = qq[0] - q[0] if qq[0] >= 0 else h_next
        d = (qq[1] - q[1]) / h if qq[0] >= 0 else d_next
        return _edge(h_next, d_next, h, d)
    if p[0] >= 0:
        h = p[0] - pp[0] if pp[0] >= 0 else h_prev
        d = (p[1] - pp[1]) / h if pp[0] >= 0 else d_prev
        return _edge(h_prev, d_prev, h, d)
    return 0.0


def _scan_runs(finite, threads: int):
    """
    The kernel's scans of one line's slots: ``threads`` threads each take a
    run of slots, the runs' last and first finite slots are scanned across
    32-lane warps (shuffles) and across the line's warps (their totals),
    and each thread fills its run. Returns (prev, next): the nearest
    finite slot at or before / at or after each slot (-1 when none).
    """
    n = len(finite)
    run = -(-n // threads)
    spans = [(min(t * run, n), min(t * run + run, n)) for t in range(threads)]
    last = [max([i for i in range(lo, hi) if finite[i]], default=-1)
            for lo, hi in spans]
    first = [min([i for i in range(lo, hi) if finite[i]], default=n)
             for lo, hi in spans]
    prev, nxt = [0] * n, [0] * n
    for t, (lo, hi) in enumerate(spans):
        w0 = t - t % 32
        # lanes before this one in its warp, then the earlier warps' totals
        r = max([max(last[w0:t], default=-1)] + last[:w0])
        q = min([min(first[t + 1:w0 + 32], default=n)] + first[w0 + 32:])
        for i in range(lo, hi):
            r = i if finite[i] else r
            prev[i] = r
        for i in range(hi - 1, lo - 1, -1):
            q = i if finite[i] else q
            nxt[i] = q if q < n else -1
    return prev, nxt


def _pchip_kernel_line(line, xs, k: int, chunk: int, threads: int = 256,
                       by_cell: bool = False) -> np.ndarray:
    """
    One line through ``pchip_lines`` of ``csrc/pchip.cu``, transcribed:
    chunk by chunk of ``chunk`` cells, the slots [b0, b1, the chunk, a0,
    a1] (the two finite cells carried from before the chunk, the two found
    after it), the nearest finite slots (:func:`_scan_runs`), each finite
    slot's derivative once, and every position whose floor cell lies in the
    chunk: a position a thread, stepped ``threads`` positions at a time
    (its cell and remainder carried, not divided; the row pass), or
    ``by_cell``, a cell a thread, its k positions from one interval (the
    column pass).
    """
    n, n_eval = len(line), len(xs)
    out = np.full(n_eval, -1.0)  # every position must be written
    carry = [_NONE, _NONE]
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        m = b - a
        ahead = [(i, float(line[i])) for i in range(b, n)
                 if math.isfinite(line[i])][:2]
        slots = carry + [(i, float(line[i])) for i in range(a, b)] + (
            ahead + [_NONE, _NONE])[:2]
        value = [c[1] if c[0] >= 0 else math.nan for c in slots]
        finite = [math.isfinite(v) for v in value]
        prev, nxt = _scan_runs(finite, threads)
        n_slots = m + 4

        def cell(i):
            return _NONE if i < 0 else slots[i]

        deriv = {}
        for i in range(1, m + 3):
            if not finite[i]:
                continue
            pv = prev[i - 1]
            pp = prev[pv - 1] if pv >= 1 else -1
            nx = nxt[i + 1]
            qq = nxt[nx + 1] if nx >= 0 and nx + 1 < n_slots else -1
            deriv[i] = _derivative(cell(pp), cell(pv), cell(i), cell(nx),
                                   cell(qq))
        def position(i0, i1, e):
            if i0 < 0 or i1 < 0:
                return math.nan
            if i0 == i1:  # NaN if the only finite cell
                return (value[i0] if prev[i0 - 1] >= 0 or nxt[i0 + 1] >= 0
                        else math.nan)
            xl = float(slots[i0][0])
            h = float(slots[i1][0]) - xl
            d0, d1 = deriv[i0], deriv[i1]
            t = (float(xs[e]) - xl) / h
            t2 = t * t
            t3 = t2 * t
            return (value[i0] * (2.0 * t3 - 3.0 * t2 + 1.0)
                    + h * d0 * (t3 - 2.0 * t2 + t)
                    + value[i1] * (-2.0 * t3 + 3.0 * t2)
                    + h * d1 * (t3 - t2))

        e0, n_pos = a * k, min(b * k, n_eval) - a * k
        for first in range(threads):
            if by_cell:
                for c in range(a + first, b, threads):
                    at = c - a + 2
                    out[c * k] = position(prev[at], nxt[at], c * k)
                    if c < n - 1:
                        for q in range(1, k):
                            out[c * k + q] = position(prev[at], nxt[at + 1],
                                                      c * k + q)
                continue
            cl, rest = divmod(e0 + first, k)
            for pos in range(first, n_pos, threads):
                at = cl - a + 2
                out[e0 + pos] = position(prev[at], nxt[at + (rest != 0)],
                                         e0 + pos)
                cl += threads // k
                rest += threads % k
                if rest >= k:
                    rest -= k
                    cl += 1
        last = prev[m + 1]
        if b < n and last >= 2:
            carry = [cell(prev[last - 1]), slots[last]]
    return out


@pytest.mark.parametrize('k_rep', [1, 2, 3, 4, 5])
def test_pchip_kernel_walk_matches_plain_version(k_rep):
    # one chunk (a block's 1024 cells of a row, 256 of a column), and
    # chunks of a few cells: gaps cross chunks and the scans' runs, chunks
    # without a finite cell, one-cell chunks; 256 threads a line and a
    # position a thread (a row pass), 64 and a cell a thread (a column
    # pass), and both ways at other sizes
    for n, seed in ((41, k_rep), (7, 10 + k_rep), (2, 20)):
        rows = _pchip_lines(n, seed)
        n_eval = (n - 1) * k_rep + 1
        ref = pchip_kernel._pchip_axis(torch.from_numpy(rows), n_eval,
                                       k_rep).numpy()
        xs = torch.linspace(0.0, n - 1.0, n_eval, dtype=torch.float64)
        for chunk, threads, by_cell in (
                (1024, 256, False), (256, 64, True), (13, 64, True),
                (13, 64, False), (5, 4, True), (2, 256, False),
                (1, 3, False), (1, 3, True)):
            got = np.stack([_pchip_kernel_line(r, xs.numpy(), k_rep, chunk,
                                               threads, by_cell)
                            for r in rows])
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('k_rep', [1, 5])
def test_pchip_kernel_chunks_long_lines(k_rep):
    # 3000 cells: three chunks of a row pass's 1024 cells, twelve of a
    # column pass's 256; NaN gaps across several chunks, a line whose only
    # two finite cells lie in the first and last chunks
    n = 3000
    rows = _pchip_lines(n, 30 + k_rep)
    rows[0, 100:1500] = np.nan
    rows[2, 5:2990] = np.nan
    rows[4, [7, 2999]] = 2.0
    n_eval = (n - 1) * k_rep + 1
    ref = pchip_kernel._pchip_axis(torch.from_numpy(rows), n_eval,
                                   k_rep).numpy()
    xs = torch.linspace(0.0, n - 1.0, n_eval, dtype=torch.float64).numpy()
    for line in (1, 4):
        stride = 1 if line == 4 else n
        assert pchip_kernel.lines_per_block(stride) == line
        chunk = pchip_kernel.BLOCK_CELLS // line
        assert n // chunk in (2, 11)  # chunks: 3 of a row, 12 of a column
        got = np.stack([_pchip_kernel_line(r, xs, k_rep, chunk,
                                           pchip_kernel.THREADS // line,
                                           by_cell=line > 1)
                        for r in rows[[0, 2, 4, 1, 8]]])
        np.testing.assert_array_equal(got, ref[[0, 2, 4, 1, 8]])


# ---------------------------------------------------------------------------
# (e) NaN infill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['even', 'all-nan'])
def test_infill_matches_host(case):
    rng = np.random.default_rng(8)
    img = rng.normal(size=(12, 9))
    if case == 'even':
        img[0, :3] = np.nan
        img[5:8, 2:7] = np.nan  # its centre takes the median
        img[11, 8] = np.nan
        img[2, 2] = -np.inf
        assert np.isfinite(img).sum() % 2 == 0
    else:
        img[:] = np.nan
    ref = j_interp.replace_nans_with_interpolated_values(img, False)
    cleaned, nans = map_infill_kernel.infill_plain(_t(img))
    np.testing.assert_allclose(cleaned.numpy(), ref, rtol=0, atol=1e-12)
    assert np.array_equal(nans.numpy(), np.isnan(img))
    j_cleaned, _ = j_idev._infill_device(jnp, jnp.asarray(img))
    np.testing.assert_allclose(cleaned.numpy(), np.asarray(j_cleaned),
                               rtol=0, atol=1e-12)
    # the wrapper on a CPU tensor is the plain version, bit for bit
    got = map_infill_kernel.map_infill(_t(img))
    assert torch.equal(got[0], cleaned) and torch.equal(got[1], nans)


@pytest.mark.parametrize('case', infill_cases.RULE_CASES
                         + infill_cases.SELECT_CASES)
def test_map_infill_wrapper_matches_plain_frame_by_frame(case):
    cube = infill_cases.infill_case(case)
    cleaned, nans, finite = map_infill_kernel.map_infill(_t(cube))
    assert cleaned.dtype == torch.float64 and cleaned.shape == cube.shape
    for i, frame in enumerate(cube):
        ref, ref_nans = map_infill_kernel.infill_plain(_t(frame))
        assert torch.equal(cleaned[i], ref), i
        assert torch.equal(nans[i], ref_nans)
        host = j_interp.replace_nans_with_interpolated_values(frame, False)
        np.testing.assert_allclose(cleaned[i].numpy(), host, rtol=0,
                                   atol=1e-12)
    assert np.array_equal(nans.numpy(), np.isnan(cube))
    assert finite.dtype == torch.int32
    assert finite.tolist() == np.isfinite(cube).sum(axis=(1, 2)).tolist()
    # a frame with no non-finite cell passes through
    if case == 'all_finite':
        assert torch.equal(cleaned, _t(cube))
    # a frame is the cube of one
    one = map_infill_kernel.map_infill(_t(cube[-1]))
    assert torch.equal(one[0], cleaned[-1]) and one[2].shape == ()


def _cu_constant(name: str) -> int:
    """A ``constexpr`` integer of ``csrc/map_infill.cu``."""
    source = (Path(map_infill_kernel.__file__).parents[1] / 'csrc'
              / 'map_infill.cu').read_text()
    found = re.search(rf'constexpr (?:int|long long) {name} = (\d+);', source)
    return int(found.group(1))


def test_selection_passes_cover_every_digit_and_the_next_bucket():
    # csrc/map_infill.cu launches a fixed number of selection passes: one
    # a digit of a 64-bit key, and one more for the upper middle value
    # where it is the least key of a later bucket (the card tests' one_ulp
    # case, which takes them all, holds the kernel to its plain version)
    digit_bits = _cu_constant('kDigitBits')
    assert _cu_constant('kSelectPasses') == -(-64 // digit_bits) + 1


# ---------------------------------------------------------------------------
# (f) The spline kernel's uniform-knot path
# ---------------------------------------------------------------------------

def _cardinal_polys(k: int) -> list[list[int]]:
    """
    ``cardinal_polys`` of ``csrc/map_spline.cu`` transcribed: k! times the
    k+1 basis polynomials (coefficients of x^0..x^k, x = u - t[i]) on a
    uniform interval, by P_d[j] = (x + d - j) P_{d-1}[j-1] + (1 + j - x)
    P_{d-1}[j] in integers.
    """
    p = [[1]]
    for d in range(1, k + 1):
        q = [[0] * (d + 1) for _ in range(d + 1)]
        for j in range(d + 1):
            for m in range(d + 1):
                v = 0
                if j >= 1:
                    prev = p[j - 1] + [0] * (d + 1 - len(p[j - 1]))
                    v += (d - j) * prev[m] + (prev[m - 1] if m else 0)
                if j < d:
                    prev = p[j] + [0] * (d + 1 - len(p[j]))
                    v += (1 + j) * prev[m] - (prev[m - 1] if m else 0)
                q[j][m] = v
        p = q
    return p


def _de_boor_cox_polys(k: int) -> list[list[Fraction]]:
    """
    The k+1 basis polynomials of de Boor-Cox (the plain version's
    recurrence) on unit-spaced knots, in exact rational arithmetic.
    """
    def mul(a, b):
        out = [Fraction(0)] * (len(a) + len(b) - 1)
        for i, p in enumerate(a):
            for j, q in enumerate(b):
                out[i + j] += p * q
        return out

    def add(a, b):
        n = max(len(a), len(b))
        a = a + [Fraction(0)] * (n - len(a))
        b = b + [Fraction(0)] * (n - len(b))
        return [p + q for p, q in zip(a, b)]

    n = [[Fraction(1)]]
    for d in range(1, k + 1):
        # term_j = (u - t[i+1-d+j]) / (t[i+1+j] - t[i+1-d+j]), x = u - t[i]
        terms = [[Fraction(d - 1 - j, d), Fraction(1, d)] for j in range(d)]
        rest = [[1 - t[0], -t[1]] for t in terms]  # 1 - term_j
        new = [mul(n[0], rest[0])]
        for j in range(1, d):
            new.append(add(mul(n[j - 1], terms[j - 1]), mul(n[j], rest[j])))
        new.append(mul(n[d - 1], terms[d - 1]))
        n = new
    return [p + [Fraction(0)] * (k + 1 - len(p)) for p in n]


@pytest.mark.parametrize('k', [1, 2, 3, 4, 5])
def test_cardinal_polynomials_of_the_kernel_are_de_boor_cox(k):
    exact = _de_boor_cox_polys(k)
    polys = _cardinal_polys(k)
    for j in range(k + 1):
        assert [Fraction(c, math.factorial(k)) for c in polys[j]] == exact[j]
        # the mirror image the kernel evaluates the rows below k/2 by
        x = np.linspace(0.0, 1.0, 11)
        row = np.polynomial.Polynomial([float(c) for c in exact[j]])
        mirror = np.polynomial.Polynomial([float(c) for c in exact[k - j]])
        np.testing.assert_allclose(row(x), mirror(1.0 - x), rtol=0,
                                   atol=1e-14)


#: 1.5 * 2^52 and the largest |u| of the kernel's uniform path
_SHIFT = 6755399441055744.0
_MAX_UNIFORM = 2.0**30


def _uniform_interval(u: np.ndarray, origin: float):
    """``uniform_interval`` of ``csrc/map_spline.cu``: (i, t_i)."""
    m = (u - origin) + _SHIFT
    i = (m.view(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(
        np.int32).astype(np.int64)  # the low word of m
    t_i = origin + (m - _SHIFT)
    down = u < t_i
    return np.where(down, i - 1, i), np.where(down, t_i - 1.0, t_i)


def _kernel_axis(t: np.ndarray, k: int, desc, u: np.ndarray):
    """
    numpy transcription of ``axis_basis`` in ``csrc/map_spline.cu`` for a
    uniform axis: the interval of the unclamped coordinate by the shift,
    the cardinal basis (coefficients / k!, Horner, mirror rows in 1 - x)
    on [lo, hi]; elsewhere ``span_basis``: the clamp into the span, the
    interval by the shift, the clip, and de Boor-Cox. Returns (first
    coefficient index, (k+1, n) basis).
    """
    n_t = t.shape[0]
    n_c = n_t - k - 1
    polys = _cardinal_polys(k)
    coeffs = [[c / math.factorial(k) for c in row] for row in polys]
    i, t_i = _uniform_interval(u, desc.origin)
    cardinal = (np.abs(u) < _MAX_UNIFORM) & (i >= desc.lo) & (i <= desc.hi)
    x = u - t_i
    n = np.empty((k + 1, u.shape[0]))
    for j in range(k + 1):
        row, v = (j, x) if j >= k - j else (k - j, 1.0 - x)
        h = np.full_like(v, coeffs[row][k])
        for m in range(k - 1, -1, -1):
            h = h * v + coeffs[row][m]  # a fused multiply-add in the kernel
        n[j] = h
    first = i - k
    span = ~cardinal
    if span.any():
        us = np.minimum(np.maximum(u[span], t[k]), t[n_t - k - 1])
        ie = np.clip(_uniform_interval(us, desc.origin)[0], k, n_c - 1)
        b = [np.ones_like(us)]
        for d in range(1, k + 1):
            terms = []
            for j in range(d):
                left = t[ie + 1 - d + j]
                denom = t[ie + 1 + j] - left
                terms.append((us - left) / np.where(denom == 0.0, 1.0, denom))
            new = [b[0] * (1.0 - terms[0])]
            for j in range(1, d):
                new.append(b[j - 1] * terms[j - 1] + b[j] * (1.0 - terms[j]))
            new.append(b[d - 1] * terms[d - 1])
            b = new
        n[:, span] = np.stack(b)
        first[span] = ie - k
    return first, n, cardinal


@pytest.mark.parametrize('size', [20, 150])
@pytest.mark.parametrize('k', [1, 2, 3, 4, 5])
def test_uniform_knot_path_matches_plain_basis(k, size):
    t = t_idev._grid_spline_solver(size, size, k, k)[1]
    desc = map_spline_kernel.uniform_knots(t, k)
    assert desc is not None and desc.lo <= desc.hi
    u = np.concatenate([
        t, np.nextafter(t, -np.inf), np.nextafter(t, np.inf),  # every knot
        [0.0, size - 1.0, -0.0, -1e-300, -3.0, size + 2.0, 1e300, -3e9],
        np.linspace(-3.0, size + 2.0, 20_001),  # a dense grid and outside
    ])
    first, basis, cardinal = _kernel_axis(t, k, desc, u)
    ref, ref_first = map_spline_kernel._basis(torch.from_numpy(t), k,
                                              torch.from_numpy(u))
    np.testing.assert_array_equal(first, ref_first.numpy())
    # the cardinal polynomials against the divided differences: values in
    # [0, 1], a few float64 ulps of 1 apart
    np.testing.assert_allclose(basis, torch.stack(ref).numpy(), rtol=0,
                               atol=4 * np.finfo(np.float64).eps)
    assert cardinal.mean() > (0.1 if size == 20 else 0.85)
    assert not cardinal[(u < 0.0) | (u > size - 1.0)].any()


@pytest.mark.parametrize('ny, nx, kx, ky', [
    (21, 17, 1, 1), (30, 26, 2, 2), (12, 40, 3, 3), (25, 19, 1, 3),
    (40, 33, 4, 5), (13, 150, 5, 4), (2048, 7, 3, 1),
])
def test_grid_uniform_knots_describe_the_solver_knots(ny, nx, kx, ky):
    ty, tx, _, _ = t_idev._grid_spline_solver(ny, nx, kx, ky)
    descs = t_idev._grid_uniform_knots(ny, nx, kx, ky)
    for t, k, desc in ((ty, ky, descs[0]), (tx, kx, descs[1])):
        n_t = t.shape[0]
        n_c = n_t - k - 1
        if n_c <= k + 1:  # no interior knot: the kernel searches
            assert desc is None
            continue
        assert desc is not None
        # t[j] == origin + j exactly on the interior, spacing exactly 1
        j = np.arange(k + 1, n_c)
        np.testing.assert_array_equal(t[j], desc.origin + j)
        assert desc.origin * 2 == int(desc.origin * 2)
        for i in range(k, n_c):
            support = np.arange(i - k + 1, i + k + 1)
            on_line = bool((t[support] == desc.origin + support).all())
            assert (desc.lo <= i <= desc.hi) == on_line, i
        # the k intervals at each end take de Boor-Cox, none for k = 1
        if n_c >= 3 * k + 1:
            assert (desc.lo, desc.hi) == ((1, n_c - 1) if k == 1 else
                                          (2 * k, n_c - 1 - k))


def test_uniform_knots_refuses_other_knots():
    t = np.array([0.0] * 4 + [2.0, 3.5, 5.0, 6.0] + [7.0] * 4)
    assert map_spline_kernel.uniform_knots(t, 3) is None
    assert map_spline_kernel.uniform_knots(np.array([0.0] * 4 + [3.0] * 4),
                                           3) is None
    # a source a FITPACK spline with smoothing fits: adaptive knots
    import scipy.interpolate
    img = np.add.outer(np.arange(30.0), np.arange(26.0)) ** 2 / 100.0
    ty, _ = scipy.interpolate.RectBivariateSpline(
        np.arange(30), np.arange(26), img, kx=3, ky=3, s=5.0,
    ).get_knots()
    assert len(ty) < 34 and map_spline_kernel.uniform_knots(ty, 3) is None


def _kernel_search_first(t: np.ndarray, k: int, u: np.ndarray) -> np.ndarray:
    """
    numpy transcription of ``span_basis`` in ``csrc/map_spline.cu`` for
    knots without a descriptor: u clamped into the span, #{t <= u} by
    bisection, the interval clipped to [k, n_c - 1]. Returns the first
    coefficient index.
    """
    n_t = t.shape[0]
    uc = np.minimum(np.maximum(u, t[k]), t[n_t - k - 1])
    lo = np.zeros(u.shape, dtype=np.int64)
    hi = np.full(u.shape, n_t)
    while (lo < hi).any():
        mid = (lo + hi) >> 1
        searching = lo < hi
        below = t[np.minimum(mid, n_t - 1)] <= uc
        lo = np.where(searching & below, mid + 1, lo)
        hi = np.where(searching & ~below, mid, hi)
    return np.clip(lo - 1, k, n_t - k - 2) - k


@pytest.mark.parametrize('k', [1, 3, 5])
def test_knot_search_matches_plain_interval(k):
    import scipy.interpolate
    rng = np.random.default_rng(k)
    img = np.add.outer(np.arange(40.0), np.arange(33.0)) ** 2 / 100.0
    img += rng.normal(scale=0.5, size=img.shape)
    fitted = scipy.interpolate.RectBivariateSpline(
        np.arange(40), np.arange(33), img, kx=k, ky=k, s=40.0,
    ).get_knots()
    # FITPACK's adaptive knots, and clamped vectors of odd and even
    # lengths with repeated interior knots
    vectors = list(fitted)
    for n_t in (15, 16, 17, 64):
        inner = np.sort(rng.integers(1, 9, size=n_t - 2 * (k + 1))) * 1.5
        vectors.append(np.concatenate([[0.0] * (k + 1), inner,
                                       [14.0] * (k + 1)]))
    for t in vectors:
        if t.shape[0] < 2 * (k + 1):
            continue
        u = np.concatenate([
            t, np.nextafter(t, -np.inf), np.nextafter(t, np.inf),
            np.linspace(t[0] - 3.0, t[-1] + 3.0, 2001), [-1e300, 1e300],
        ])  # finite: the wrapper's x and y are 0 where not valid
        _, ref_first = map_spline_kernel._basis(torch.from_numpy(t), k,
                                                torch.from_numpy(u))
        np.testing.assert_array_equal(_kernel_search_first(t, k, u),
                                      ref_first.numpy())


@pytest.mark.parametrize('kxy, smoothing', [
    ((3, 3), 0.0), ((1, 5), 0.0), ((3, 3), 2.0),
])
def test_host_branch_describes_its_knots(monkeypatch, kxy, smoothing):
    # sources larger than _DEVICE_SOLVE_MAX take the host FITPACK branch:
    # at s=0 its knots are the unit-spaced grid knots and reach the kernel
    # described, as from the device solve, so both take its arithmetic path
    ky, kx = kxy
    n = 30
    img = torch.from_numpy(_image(True)[:n, :n].copy())
    rng = np.random.default_rng(3)
    x_map = rng.uniform(-1.0, n, (12, 16))
    y_map = rng.uniform(-1.0, n, (12, 16))
    x_map[0, :3] = np.nan
    samples = t_idev._device_xy(x_map, y_map, torch.device('cpu'))
    seen = []
    wrapper = t_idev.map_spline

    def recorded(*args, **kw):
        seen.append((args, kw))
        return wrapper(*args, **kw)

    monkeypatch.setattr(t_idev, 'map_spline', recorded)
    kw = dict(interpolation=kxy, warn_nan=False, propagate_nan=True,
              spline_smoothing=smoothing)
    monkeypatch.setattr(t_idev, '_DEVICE_SOLVE_MAX', n - 1)
    got = t_idev.spline_interpolation_device(img, samples, **kw)
    (args, call_kw), = seen
    ty, tx = args[3].numpy(), args[4].numpy()
    assert call_kw['uniform'] == (map_spline_kernel.uniform_knots(ty, ky),
                                  map_spline_kernel.uniform_knots(tx, kx))
    if smoothing:
        return
    assert call_kw['uniform'] == t_idev._grid_uniform_knots(n, n, kx, ky)
    assert None not in call_kw['uniform']
    monkeypatch.setattr(t_idev, '_DEVICE_SOLVE_MAX', n)
    ref = t_idev.spline_interpolation_device(img, samples, **kw).numpy()
    assert seen[1][1]['uniform'] == call_kw['uniform']
    got = got.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isfinite(got).sum() > 100
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_launch_plan_stages_searched_knots_that_fit():
    desc = t_idev._grid_uniform_knots(150, 150, 3, 3)
    plan = map_spline_kernel.launch_plan
    ay, ax, shared = plan(154, 154, desc)
    assert (ay.uniform, ay.staged, ax.uniform, ax.staged, shared) == (
        1, 0, 1, 0, 0)
    assert (ay.origin, ay.lo, ay.hi) == (desc[0].origin, desc[0].lo,
                                         desc[0].hi)
    ay, ax, shared = plan(154, 40, (desc[0], None))
    assert (ay.staged, ax.uniform, ax.staged, shared) == (0, 0, 1, 8 * 40)
    # searched knots up to 40 KB for both axes (2054 each at the 2048-px
    # device-solve limit) are staged; more are read from global memory
    ay, ax, shared = plan(2054, 2054)
    assert (ay.staged, ax.staged, shared) == (1, 1, 8 * 4108)
    ay, ax, shared = plan(5000, 200)
    assert (ay.uniform, ay.staged, ax.uniform, ax.staged, shared) == (
        0, 0, 0, 0, 0)
    assert 8 * 5200 > map_spline_kernel.KNOT_STAGE_BYTES >= 8 * 4108
