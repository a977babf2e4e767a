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
  of finite pixels).

Inputs come from a numpy seed and pass to both packages as numpy arrays.
The kernels themselves against their plain versions on the card are
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu.ops import interp as j_interp
from planetmapper_tpu.ops import interp_device as j_idev
from planetmapper_tpu.ops import map_pallas as j_map_pallas
from planetmapper_tpu.ops import pchip_device as j_pchip
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.ops import interp as t_interp
from planetmapper_tpu_torch.ops import interp_device as t_idev
from planetmapper_tpu_torch.ops import map_smooth_kernel, map_spline_kernel
from planetmapper_tpu_torch.ops import pchip_device as t_pchip
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


# ---------------------------------------------------------------------------
# (c) Whole-body map_img
# ---------------------------------------------------------------------------

MODES = ['nearest', 1, 2, 3, (3, 1), 'smooth']


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
    for lib in (map_spline_kernel, map_smooth_kernel):
        lib.reset_launch_count()
    for interpolation in ('cubic', 'smooth'):
        t_body.map_img(_image(True), interpolation=interpolation, **MAP)
    assert map_spline_kernel.launch_count() == 0
    assert map_smooth_kernel.launch_count() == 0


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
    cleaned, nans = t_idev._infill_device(_t(img))
    np.testing.assert_allclose(cleaned.numpy(), ref, rtol=0, atol=1e-12)
    assert np.array_equal(nans.numpy(), np.isnan(img))
    j_cleaned, _ = j_idev._infill_device(jnp, jnp.asarray(img))
    np.testing.assert_allclose(cleaned.numpy(), np.asarray(j_cleaned),
                               rtol=0, atol=1e-12)
