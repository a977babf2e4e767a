"""
The port's ``parallel/`` package against the JAX package's, on the
synthetic SPICE kernels (Jupiter from the Earth on 2005-01-01), on CPU
tensors and the JAX package on the CPU (its virtual 8-device mesh):

- the batched anchors and ``xy2angular`` of a time series against
  per-body ``compute_scene_anchors`` and against JAX's
  ``_batched_pipeline_inputs``;
- ``backplane_time_series``: the cases of ``tests/test_parallel.py``
  (the 36.27 deg/h rotation, the disc-change regression, a 4-entry mesh)
  and the JAX package's series, and the frame and row placements;
- ``sharded_backplanes`` on 4 entries against the unsharded frame (bit for
  bit) and JAX's on ``make_mesh(4)``; ragged rows; ``trace_only``;
- ``sharded_map_img`` against the port's ``map_img`` (bit for bit) and
  JAX's ``sharded_map_img``;
- ``make_training_step`` against the optax step, with and without a mesh;
  ``fit_disc_gradient`` recovers a disc;
- ``initialize_distributed`` in one process, the process-spanning mesh and
  placements, and a two-process gloo group gathering a time series equal
  to one process's.

Inputs come from a numpy seed and pass to both packages as numpy arrays.
The batched kernel itself is held to single launches on the card in
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax  # noqa: F401  (the JAX package under test runs on it)
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu.parallel as jpar
import planetmapper_tpu_torch as tpm
import planetmapper_tpu_torch.parallel as tpar
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu.parallel import timeseries as j_timeseries
from planetmapper_tpu_torch import pipeline as t_pipeline
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.parallel import timeseries as t_timeseries
from planetmapper_tpu_torch.parallel.sharding import Mesh
from planetmapper_tpu_torch.testing import compare
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
TIMES = ['2005-01-01T00:00:00', '2005-01-01T01:00:00', '2005-01-01T02:00:00']


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def kernel_path(tmp_path_factory):
    """Synthetic kernels as both packages' kernel path, restored after."""
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0)
    previous = {
        pkg: pkg.get_kernel_path(return_source=True) for pkg in (jpm, tpm)
    }
    for pkg, pool_mod in ((jpm, j_pool), (tpm, t_pool)):
        pkg.clear_kernels()
        pkg.set_kernel_path(path)
        pool_mod.load_spice_kernels()
    yield path
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


def _bodies(nx, ny, disc):
    """(JAX BodyXY, port CPU BodyXY) of the same scene and disc."""
    j_body = jpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=nx, ny=ny)
    t_body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=nx, ny=ny,
                        device='cpu')
    for body in (j_body, t_body):
        body.set_disc_params(*disc)
    return j_body, t_body


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_equal(got, ref):
    assert set(got) == set(ref)
    for name, plane in ref.items():
        np.testing.assert_array_equal(np.asarray(got[name]), plane,
                                      err_msg=name)


def _assert_mixed_parity(port, jax_out):
    """The port's float64 planes against the JAX package's mixed-precision
    graph, which computes and stores float32: two float32 ulps over the
    kernel table (as tests/test_torch_pipeline.py's mixed comparison)."""
    reports = compare.compare_backplanes(_numpy(jax_out), _numpy(port),
                                         float32_ulps=2)
    assert not compare.failures(reports), compare.failures(reports)


def test_exports_match_jax():
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name
    assert tpm.parallel is tpar  # the package's lazy submodules


# ---------------------------------------------------------------------------
# Time series
# ---------------------------------------------------------------------------

#: Batched anchors against per-body ones: the per-body path takes the
#: target's apparent position from ``spkezr`` and the camera through RA/Dec
#: in degrees, the batched pass in-graph (the JAX package's per_time), so
#: the values agree to rounding of 1e9 km vectors, not bit for bit. rot0:
#: one ulp of Jupiter's prime-meridian angle (~3e4 rad in 2005) is 3.6e-12
#: rad, and XLA's vmapped graph rounds it apart from the eager one.
ANCHOR_TOLERANCE = dict(
    rot0=1e-11, obsvec2angular=1e-12, solar_lon_e=1e-10,
    et=1e-9, tau0=1e-9, sun_epoch0=1e-9, target_lt=1e-9,
)


def _anchor_bar(key, value):
    scale = np.abs(value).max()
    if key in ('rot1', 'rot2', 'angular2km', 'ring_plane_normal',
               'ring_plane_constant'):
        # built from 1e9 -> 1e5 km differences: ~1e-12 relative
        return 1e-10 * scale
    if key in ANCHOR_TOLERANCE:
        return ANCHOR_TOLERANCE[key]
    # km, km/s; body-fixed vectors of 1e9 km carry rot0's bar times their
    # length (2.9e-3 km measured for subpoint_rayvec against XLA)
    return max(1e-6, 1e-11 * scale)


def test_batched_inputs_match_per_body_and_jax(kernel_path):
    j_body, t_body = _bodies(40, 32, (19.6, 15.2, 12.0, 30.0))
    ets = t_timeseries._ets_from_times(t_body, TIMES)
    np.testing.assert_array_equal(
        ets, j_timeseries._ets_from_times(j_body, TIMES))
    anchors, xy2angular = t_timeseries._batched_pipeline_inputs(t_body, ets)
    j_anchors, j_xy2angular = j_timeseries._batched_pipeline_inputs(
        j_body, ets)
    assert set(anchors) == set(t_pipeline.ANCHOR_SHAPES)
    assert xy2angular.shape == (3, 3, 3)
    for i, utc in enumerate(TIMES):
        single = t_timeseries._body_at_time(t_body, utc)
        ref = t_pipeline.compute_scene_anchors(single)
        for key, value in ref.items():
            np.testing.assert_allclose(
                anchors[key][i], value, rtol=0,
                atol=_anchor_bar(key, value), err_msg=f'{key} at {utc}')
        np.testing.assert_allclose(
            xy2angular[i], single._get_xy2angular_matrix(), rtol=1e-12,
            atol=0)
    for key, value in j_anchors.items():
        np.testing.assert_allclose(
            anchors[key], np.asarray(value), rtol=0,
            atol=_anchor_bar(key, np.asarray(value)), err_msg=key)
    np.testing.assert_allclose(xy2angular, np.asarray(j_xy2angular),
                               rtol=1e-12, atol=0)


def test_time_series_three_epochs(kernel_path):
    """tests/test_parallel.py's batched-times case, and the JAX series."""
    j_body, t_body = _bodies(12, 10, (6, 5, 4, 0.0))
    names = ['EMISSION', 'LON-GRAPHIC']
    out = tpar.backplane_time_series(t_body, TIMES, names=names)
    assert list(out) == sorted(names)
    assert out['EMISSION'].shape == (3, 10, 12)
    fused = t_body.generate_backplanes_fused()
    # the JAX test's bar: the frame through the batched anchors against
    # the body's own
    np.testing.assert_allclose(out['EMISSION'][0], fused['EMISSION'],
                               atol=5e-5, equal_nan=True)
    # Jupiter rotates ~36.27 deg of W longitude per hour
    lon0, lon1 = out['LON-GRAPHIC'][0], out['LON-GRAPHIC'][1]
    both = np.isfinite(lon0) & np.isfinite(lon1)
    d = np.mod((lon1 - lon0)[both] + 180, 360) - 180
    assert np.median(d) == pytest.approx(36.27, abs=0.05)
    ref = jpar.backplane_time_series(j_body, TIMES, names=names)
    for i in range(3):
        _assert_mixed_parity({k: v[i] for k, v in out.items()},
                             {k: np.asarray(v)[i] for k, v in ref.items()})


def test_time_series_disc_change(kernel_path):
    """tests/test_parallel.py's regression: the disc is read per call."""
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=12, ny=12,
                      device='cpu')
    body.set_disc_params(6, 6, 5, 0.0)
    times = [body.et, body.et + 60.0]
    tpar.backplane_time_series(body, times, names=['EMISSION'])
    body.set_disc_params(5.0, 5.0, 4.0, 20.0)
    out = tpar.backplane_time_series(body, times, names=['EMISSION'])
    ref = body.generate_backplanes_fused()['EMISSION']
    assert np.array_equal(np.isnan(out['EMISSION'][0]), np.isnan(ref))
    interior = np.isfinite(ref) & (ref < 85.0)
    np.testing.assert_allclose(out['EMISSION'][0][interior], ref[interior],
                               atol=1e-4)


def test_time_series_on_meshes_equals_one_device(kernel_path):
    """A 4-entry mesh (frames), a frame placement and a row placement of a
    process-spanning mesh in one process: the same cube bit for bit."""
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=8, ny=9,
                      device='cpu')
    body.set_disc_params(4, 4, 3, 0.0)
    times = [f'2005-01-01T0{i}:00:00' for i in range(5)]
    ref = tpar.backplane_time_series(body, times, names=['EMISSION', 'RA'])
    mesh = tpar.make_mesh(4, axis_names=('data',), device='cpu')
    assert mesh.shape == {'data': 4}
    rows = Mesh([['cpu'] * 4], ('frames', 'px'))
    for placement in (mesh, tpar.frame_sharding(rows),
                      tpar.pixel_row_sharding(rows)):
        out = tpar.backplane_time_series(body, times, names=['EMISSION', 'RA'],
                                         mesh=placement)
        _assert_equal(out, ref)
    on_device = tpar.backplane_time_series(body, times, names=['EMISSION'],
                                           as_numpy=False)
    assert isinstance(on_device['EMISSION'], torch.Tensor)


# ---------------------------------------------------------------------------
# Row-sharded backplanes and maps
# ---------------------------------------------------------------------------

def test_sharded_backplanes_match_unsharded_and_jax(kernel_path):
    j_body, t_body = _bodies(16, 12, (8, 6, 5, 10.0))
    mesh = tpar.make_mesh(4, device='cpu')
    sharded = tpar.sharded_backplanes(t_body, mesh)
    _assert_equal(sharded, t_pipeline.compute_backplanes(t_body))
    forced = tpar.sharded_backplanes(t_body, mesh, use_pallas=False,
                                     interpret=True)
    _assert_equal(forced, t_pipeline.compute_backplanes(t_body))
    ref = jpar.sharded_backplanes(j_body, jpar.make_mesh(4))
    _assert_mixed_parity(sharded, ref)
    with pytest.raises(ValueError, match='CUDA device'):
        tpar.sharded_backplanes(t_body, mesh, use_pallas=True)


def test_sharded_backplanes_ragged_rows_and_trace_only(kernel_path):
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=10, ny=7,
                      device='cpu')
    body.set_disc_params(5, 3.5, 3, 0.0)
    mesh = tpar.make_mesh(8, device='cpu')
    sharded = tpar.sharded_backplanes(body, mesh)
    assert sharded['EMISSION'].shape == (7, 10)
    # blocks of one or three 10-pixel rows: PyTorch's CPU kernels take a
    # vector's tail through their scalar functions, which may round an
    # atan2 or a root one ulp apart from the vectorised ones (the card's
    # kernel is per pixel and equal bit for bit, tests/test_torch_cuda.py)
    full = t_pipeline.compute_backplanes(body)
    three = tpar.sharded_backplanes(body, tpar.make_mesh(3, device='cpu'))
    for out in (sharded, three):
        for name, plane in full.items():
            got = out[name].numpy()
            np.testing.assert_array_equal(np.isnan(got), np.isnan(plane))
            np.testing.assert_allclose(got, plane, rtol=1e-14, atol=1e-12,
                                       equal_nan=True, err_msg=name)
    traced = tpar.sharded_backplanes(body, tpar.make_mesh(3, device='cpu'),
                                     trace_only=True)
    assert set(traced) == set(sharded)
    for name, value in traced.items():
        # the padded program's outputs: 3 blocks of ceil(7 / 3) rows
        assert value.device.type == 'meta'
        assert tuple(value.shape) == (9, 10)
        assert value.dtype == sharded[name].dtype, name


@pytest.mark.parametrize('interpolation', ['linear', 'cubic'])
def test_sharded_map_img_matches_map_img_and_jax(kernel_path, interpolation):
    j_body, t_body = _bodies(20, 16, (10, 8, 7, 15.0))
    rng = np.random.default_rng(5)
    img = rng.normal(size=(16, 20)).cumsum(axis=0)
    img[4, 7] = np.nan
    kwargs = {'projection': 'rectangular', 'degree_interval': 10}
    mesh = tpar.make_mesh(4, device='cpu')
    sharded = tpar.sharded_map_img(t_body, img, mesh,
                                   interpolation=interpolation, **kwargs)
    reference = t_body.map_img(img, interpolation=interpolation,
                               as_numpy=True, **kwargs)
    assert sharded.shape == reference.shape == (18, 36)  # rows padded
    assert sharded.dtype == np.float64
    np.testing.assert_array_equal(sharded, reference.astype(np.float64))
    ref = jpar.sharded_map_img(j_body, img, jpar.make_mesh(4),
                               interpolation=interpolation, **kwargs)
    np.testing.assert_array_equal(np.isnan(sharded), np.isnan(ref))
    # the JAX package's float32 spline bar, 2e-5 of the image's scale
    bar = 2e-5 * np.nanmax(np.abs(img))
    np.testing.assert_allclose(np.nan_to_num(sharded), np.nan_to_num(ref),
                               rtol=0, atol=bar)


# ---------------------------------------------------------------------------
# The gradient disc fit
# ---------------------------------------------------------------------------

def _fit_data(nx, ny, truth):
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=nx, ny=ny,
                      device='cpu')
    body.set_disc_params(*truth, 0.0)
    emission = np.asarray(body.get_backplane_img('EMISSION'))
    return np.where(np.isfinite(emission), 1.0, 0.0)


def test_training_step_matches_optax(kernel_path):
    """20 Adam steps from the same start: torch.optim.Adam against optax's
    adam on the JAX package's render, float64 both."""
    j_body, t_body = _bodies(16, 16, (8.6, 7.4, 6.0, 10.0))
    data = np.zeros((2, 16, 16))
    data[:, 4:12, 3:12] = 1.0
    data[1, 5, 5] = np.nan
    j_step, j_params, j_state = jpar.make_training_step(j_body, data)
    t_step, t_params, t_state = tpar.make_training_step(t_body, data)
    np.testing.assert_array_equal(t_step.data.numpy(), np.asarray(j_step.data))
    np.testing.assert_array_equal(t_params.detach().numpy(),
                                  np.asarray(j_params))
    for i in range(20):
        j_params, j_state, j_loss = j_step(j_params, j_state)
        t_params, t_state, t_loss = t_step(t_params, t_state)
        assert float(t_loss) == pytest.approx(float(j_loss), rel=1e-9), i
    # Adam's normalised steps carry the renders' rounding differences
    # (~1e-15 relative) through 20 updates of lr 0.05
    np.testing.assert_allclose(t_params.detach().numpy(),
                               np.asarray(j_params), rtol=0, atol=1e-9)


def test_training_step_on_a_mesh_equals_one_device(kernel_path):
    """Frames over the first axis and rows over the second of a 2x2 mesh:
    the loss is the blocks' partial sums, so the same step to rounding."""
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=16, ny=16,
                      device='cpu')
    body.set_disc_params(8, 8, 6, 0.0)
    data = np.zeros((4, 16, 16))
    data[:, 4:12, 4:12] = 1.0
    mesh = Mesh([['cpu', 'cpu'], ['cpu', 'cpu']], ('data', 'px'))
    step, params, state = tpar.make_training_step(body, data, mesh=mesh)
    ref_step, ref_params, ref_state = tpar.make_training_step(body, data)
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state)
        ref_params, ref_state, ref_loss = ref_step(ref_params, ref_state)
        assert float(loss) == pytest.approx(float(ref_loss), rel=1e-12)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] <= losses[0]
    np.testing.assert_allclose(params.detach().numpy(),
                               ref_params.detach().numpy(), rtol=0,
                               atol=1e-10)


def test_fit_disc_gradient_recovers_disc(kernel_path):
    """tests/test_parallel.py's case: a disc recovered from a mask."""
    truth = (15.0, 13.0, 9.0)
    data = _fit_data(30, 26, truth)
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=30, ny=26,
                      device='cpu')
    body.set_disc_params(truth[0] + 2.5, truth[1] - 2.0, truth[2] * 1.3, 0.0)
    x0, y0, r0, _rot = tpar.fit_disc_gradient(body, data, n_steps=200,
                                              learning_rate=0.1)
    assert x0 == pytest.approx(truth[0], abs=0.3)
    assert y0 == pytest.approx(truth[1], abs=0.3)
    assert r0 == pytest.approx(truth[2], abs=0.3)
    assert body.get_disc_params()[:3] == pytest.approx((x0, y0, r0))
    assert body.get_disc_method() == 'fit_gradient'


# ---------------------------------------------------------------------------
# Several processes
# ---------------------------------------------------------------------------

def test_initialize_distributed_single_process_noop(monkeypatch):
    import torch.distributed as dist

    for name in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR', 'MASTER_PORT'):
        monkeypatch.delenv(name, raising=False)
    tpar.initialize_distributed()
    monkeypatch.setenv('WORLD_SIZE', '1')
    tpar.initialize_distributed()
    assert not dist.is_initialized()
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='coordinator'):
        tpar.initialize_distributed()


def test_multihost_mesh_and_shardings():
    mesh = tpar.make_multihost_mesh(device='cpu')
    assert mesh.axis_names == ('frames', 'px')
    assert mesh.shape == {'frames': 1, 'px': 1}
    assert mesh.processes == 1
    assert tpar.frame_sharding(mesh).spec[0] == 'frames'
    assert tpar.pixel_row_sharding(mesh).spec[1] == 'px'
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if not torch.cuda.is_available():
            tpar.make_mesh()


def test_two_processes_gather_the_time_series(kernel_path, tmp_path):
    """A gloo group of two processes (a file:// rendezvous under tmp_path,
    so that parallel test workers share no port): each computes its two of
    four epochs, all_gather assembles them, equal to one process's."""
    from planetmapper_tpu_torch.testing.distributed import time_series_worker

    body_kwargs = dict(target='Jupiter', observer='EARTH', utc=UTC, nx=9,
                       ny=8)
    disc = (4.5, 4.0, 3.0, 10.0)
    body = tpm.BodyXY(**body_kwargs, device='cpu')
    body.set_disc_params(*disc)
    times = [body.et + 60.0 * i for i in range(4)]
    names = ['EMISSION', 'LON-GRAPHIC', 'RADIAL-VELOCITY']
    out_path = tmp_path / 'series.npz'
    context = torch.multiprocessing.spawn(
        time_series_worker,
        args=(2, f'file://{tmp_path / "rendezvous"}', str(kernel_path),
              body_kwargs, disc, times, names, str(out_path)),
        nprocs=2, join=False,
    )
    for _ in range(60):
        if context.join(timeout=5):
            break
    else:
        for process in context.processes:
            process.kill()
        pytest.fail('the process group did not finish in 300 s')
    assert all(not p.is_alive() for p in context.processes)
    got = dict(np.load(out_path))
    _assert_equal(got, tpar.backplane_time_series(body, times, names=names))
