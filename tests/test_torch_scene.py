"""
The PyTorch port's scene layer against the JAX package, on the synthetic
SPICE kernels written by ``planetmapper_tpu_torch.testing``:

- importing the port, its exports and its lazy submodules (the GUI, the
  CLI and SGP4 among them) pulls in neither JAX, matplotlib nor tkinter;
- the synthetic kernels load with the JAX package's own readers and
  reproduce the analytic states they were written from;
- SPK evaluators, apparent states (``spkezr``), IAU frame rotations and the
  scene constants agree with the JAX float64 functions on identical inputs;
- the rule that sends bulk scene calls to their inputs' device and keeps
  scalar calls on the host (PyTorch's ``meta`` device stands in for the
  card).

Inputs come from a numpy seed and pass to both packages as numpy arrays.
"""

from __future__ import annotations

import subprocess
import sys

import jax  # noqa: F401  (the JAX package under test runs on it)
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu.core import ephemeris as j_eph
from planetmapper_tpu.core import frames as j_frames
from planetmapper_tpu.core import scene as j_scene
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu.kernels import spk as j_spk
from planetmapper_tpu_torch import _device
from planetmapper_tpu_torch.core import ephemeris as t_eph
from planetmapper_tpu_torch.core import frames as t_frames
from planetmapper_tpu_torch.core import scene as t_scene
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.kernels import spk as t_spk
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    HST_ELEMENTS,
    TLE_CONSTANTS,
    TLE_STEP_S,
    coverage,
    synthetic_states,
    tle_packets,
    write_synthetic_kernels,
)

JUPITER, EARTH, SUN = 599, 399, 10
ET_2005 = 157809664.1839331  # 2005-01-01T00:00:00 UTC as TDB seconds


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def kernel_files(tmp_path_factory):
    """Synthetic kernels as both packages' kernel path, pools loaded."""
    path = tmp_path_factory.mktemp('synthetic_kernels')
    files = write_synthetic_kernels(path, seed=0)
    previous = {
        pkg: pkg.get_kernel_path(return_source=True) for pkg in (jpm, tpm)
    }
    for pkg, pool_mod in ((jpm, j_pool), (tpm, t_pool)):
        pkg.clear_kernels()
        pkg.set_kernel_path(path)
        pool_mod.load_spice_kernels()
    yield files
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


@pytest.mark.parametrize('blocked', [False, True])
def test_import_pulls_in_no_jax_or_matplotlib(blocked):
    """Importing every module (the plotting ones, ``parallel``, the GUI,
    the CLI and SGP4 too) loads no JAX, no optax, no matplotlib, no tkinter
    and no PIL; with matplotlib made
    unimportable the package still imports, and a CPU BodyXY still builds
    and moves its disc (its matplotlib transforms are made on first use
    only)."""
    code = (
        ('sys_block = __import__("sys")\n'
         'sys_block.modules["matplotlib"] = None\n' if blocked else '')
        + 'import sys, tempfile, planetmapper_tpu_torch as pt\n'
        'from planetmapper_tpu_torch.ops import (cuda_build, ds, ds64,\n'
        '    dsk, dsk_kernel, fastmath, interp, interp_device,\n'
        '    map_smooth_kernel, map_spline_kernel, pchip_device,\n'
        '    photometry, projections)\n'
        'from planetmapper_tpu_torch import observation, utils\n'
        'from planetmapper_tpu_torch import _body_plotting, _body_xy_plotting\n'
        'from planetmapper_tpu_torch.io import fits, wcs\n'
        'from planetmapper_tpu_torch.parallel import (fit, multihost,\n'
        '    sharding, timeseries)\n'
        'from planetmapper_tpu_torch import (gui, cli, kernel_downloader,\n'
        '    _session_warm, _assets, _mock_gui_no_tk)\n'
        'from planetmapper_tpu_torch.kernels import sgp4, daf_native\n'
        'parallel = [getattr(pt.parallel, n) for n in pt.parallel.__all__]\n'
        'exports = [getattr(pt, name) for name in pt.__all__]\n'
        'lazy = [getattr(pt, name) for name in sorted(pt._SUBMODULES)]\n'
        'assert not pt.DEFAULT_WIREFRAME_FORMATTING._materialised\n'
        'from planetmapper_tpu_torch.testing.synthetic_kernels import '
        'write_synthetic_kernels\n'
        'with tempfile.TemporaryDirectory() as d:\n'
        '    write_synthetic_kernels(d)\n'
        '    pt.set_kernel_path(d)\n'
        '    b = pt.BodyXY("Jupiter", "2005-01-01", sz=16, device="cpu")\n'
        '    b.set_disc_params(8, 8, 5, 10)\n'
        '    b.limb_xy(npts=12)\n'
        '    pt.clear_kernels()\n'
        'bad = [m for m in ("jax", "optax", "matplotlib", "PIL",\n'
        '                   "tkinter", "planetmapper_tpu") '
        'if sys.modules.get(m) is not None]\n'
        'print(bad)\n'
        'sys.exit(1 if bad else 0)\n'
    )
    proc = subprocess.run(
        [sys.executable, '-c', code], capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# The synthetic kernels, read by the JAX package
# ---------------------------------------------------------------------------

def test_spk_loads_with_jax_readers(kernel_files):
    from planetmapper_tpu.kernels.daf import read_daf_python

    spk = kernel_files[2]
    daf = read_daf_python(spk)
    assert (daf.nd, daf.ni) == (2, 6)
    segments = j_spk.parse_spk_file(spk)
    assert [(s.target, s.center, s.frame_id, s.data_type) for s in segments] \
        == [(SUN, 0, 1, 13), (EARTH, 0, 1, 13), (JUPITER, 0, 1, 13)]
    start, end = coverage()
    assert all(s.start_et == start and s.end_et == end for s in segments)


@pytest.mark.parametrize('body', [SUN, EARTH, JUPITER])
def test_jax_evaluators_return_written_states(kernel_files, body):
    segment = next(
        s for s in j_spk.parse_spk_file(kernel_files[2]) if s.target == body
    )
    data = segment.data
    rng = np.random.default_rng(body)
    knots = data.epochs[rng.integers(10, data.epochs.size - 10, 16)]
    between = knots + rng.uniform(0.0, 3600.0, knots.size)
    eph = j_eph.Ephemeris(j_pool.KernelPool())
    for t in (knots, between):
        state = np.asarray(eph.segment_state(segment, t))
        truth = synthetic_states(t)[body]
        # positions to 1e-6 km; velocities (the Hermite interpolant's
        # derivative) to 1e-9 km/s
        np.testing.assert_allclose(state[:, :3], truth[:, :3], rtol=0, atol=1e-6)
        np.testing.assert_allclose(state[:, 3:], truth[:, 3:], rtol=0, atol=1e-9)


def test_text_kernels_load_with_jax_readers(kernel_files):
    from planetmapper_tpu.core.time import LeapSecondData, utc_string_to_et
    from planetmapper_tpu.kernels.textkernel import load_text_kernel

    pool = {}
    for path in kernel_files[:2]:
        load_text_kernel(path, pool)
    assert pool['BODY599_RADII'] == [71492.0, 71492.0, 66854.0]
    assert len(pool['BODY5_NUT_PREC_ANGLES']) == 30
    assert len(pool['BODY599_NUT_PREC_RA']) == 15
    lsk = LeapSecondData.from_pool(pool)
    assert lsk.leap_table[-1][0] == 37.0
    et = utc_string_to_et('2005-01-01T00:00:00', lsk)
    # TDB - UTC = 32 leap seconds + 32.184 s + the ~1.7 ms periodic term
    assert et - 1826.5 * 86400.0 == pytest.approx(64.184, abs=2e-3)
    assert et == pytest.approx(ET_2005, abs=1e-6)


# ---------------------------------------------------------------------------
# SPK evaluators (seeded segment payloads of every ported type)
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(7)
    t0 = ET_2005
    cheb = {}
    for ncomp in (3, 6):
        coeffs = rng.normal(size=(4, ncomp, 9)) * np.logspace(7, -1, 9)
        coeffs[:, 3:] *= 1e-5  # type 3 velocity components [km/s]
        cheb[ncomp] = dict(
            init=t0 - 2e5, intlen=1e5,
            mids=t0 - 2e5 + 5e4 + 1e5 * np.arange(4),
            radii=np.full(4, 5e4), coeffs=coeffs,
        )
    epochs = t0 + 600.0 * np.arange(40)
    states = synthetic_states(epochs)[JUPITER]
    return {
        'type2': ('ChebyshevData', cheb[3]),
        'type3': ('ChebyshevData', cheb[6]),
        'type5': ('TwoBodyData', dict(
            gm=1.32712440041e11, epochs=epochs[::8],
            states=synthetic_states(epochs[::8])[EARTH],
        )),
        'type9': ('LagrangeData', dict(
            group=7, hermite=False, epochs=epochs, states=states,
        )),
        'type13': ('LagrangeData', dict(
            group=4, hermite=True, epochs=epochs, states=states,
        )),
        'type17': ('EquinoctialData', dict(
            epoch=t0, a=4.2e5, h=0.01, k=-0.004, mean_lon=1.3, p=0.02,
            q=-0.01, periapse_rate=2e-8, mean_lon_rate=4e-5,
            node_rate=-1e-8, ra_pole=4.6, dec_pole=1.1,
        )),
    }


@pytest.mark.parametrize('kind', sorted(_payloads()))
def test_segment_states_match_jax(kind):
    cls_name, fields = _payloads()[kind]
    data_type = int(kind.removeprefix('type'))
    j_seg = j_spk.SpkSegment(1, 0, 1, data_type, 0.0, 0.0,
                             getattr(j_spk, cls_name)(**fields))
    t_seg = t_spk.SpkSegment(1, 0, 1, data_type, 0.0, 0.0,
                             getattr(t_spk, cls_name)(**fields))
    t = ET_2005 + np.random.default_rng(3).uniform(100.0, 1.9e4, 11)
    j_state = np.asarray(
        j_eph.Ephemeris(j_pool.KernelPool()).segment_state(j_seg, t)
    )
    t_state = t_eph.Ephemeris(t_pool.KernelPool()).segment_state(
        t_seg, t
    ).numpy()
    np.testing.assert_allclose(t_state[:, :3], j_state[:, :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_state[:, 3:], j_state[:, 3:], rtol=0, atol=1e-9)


def test_tle_segments_raise_not_implemented():
    """Type 10 segments evaluate (they raised before SGP4 was ported):
    the synthetic HST series' bracketing-set blend against the JAX
    package's, inside, at and outside the element sets' epochs."""
    epochs = ET_2005 + TLE_STEP_S * np.arange(4)
    data = dict(constants=np.asarray(TLE_CONSTANTS), epochs=epochs,
                packets=tle_packets(HST_ELEMENTS, epochs))
    j_seg = j_spk.SpkSegment(-48, 399, 1, 10, 0.0, 1.0, j_spk.TleData(**data))
    t_seg = t_spk.SpkSegment(-48, 399, 1, 10, 0.0, 1.0, t_spk.TleData(**data))
    t = np.concatenate([
        epochs[0] + np.random.default_rng(5).uniform(-4e4, 3.5 * TLE_STEP_S,
                                                     9),
        epochs,
    ])
    j_state = np.asarray(
        j_eph.Ephemeris(j_pool.KernelPool()).segment_state(j_seg, t)
    )
    t_state = t_eph.Ephemeris(t_pool.KernelPool()).segment_state(
        t_seg, t
    ).numpy()
    np.testing.assert_allclose(t_state[:, :3], j_state[:, :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_state[:, 3:], j_state[:, 3:], rtol=0, atol=1e-9)
    assert np.all(np.abs(np.linalg.norm(t_state[:, :3], axis=1) - 6915) < 30)


# ---------------------------------------------------------------------------
# Apparent states, frames, scene constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('abcorr', ['NONE', 'LT+S', 'CN', 'XCN'])
def test_spkezr_matches_jax(kernel_files, abcorr):
    et = ET_2005 + np.array([0.0, 3.7e3, -8.1e4])
    j_state, j_lt = j_eph.get_ephemeris().spkezr(JUPITER, EARTH, et, abcorr)
    t_state, t_lt = t_eph.get_ephemeris().spkezr(JUPITER, EARTH, et, abcorr)
    np.testing.assert_allclose(
        t_state[:, :3].numpy(), np.asarray(j_state)[:, :3], rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        t_state[:, 3:].numpy(), np.asarray(j_state)[:, 3:], rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(t_lt.numpy(), np.asarray(j_lt), rtol=1e-14)


def test_frame_rotations_match_jax(kernel_files):
    j_model = j_frames.BodyFrameModel.from_pool(j_pool.get_pool(), JUPITER)
    t_model = t_frames.BodyFrameModel.from_pool(t_pool.get_pool(), JUPITER)
    assert t_model.nut_angles.shape == (15, 2)  # nutation terms exercised
    et = ET_2005 + np.random.default_rng(5).uniform(-3e6, 3e6, 9)
    for name in ('j2000_to_bodyfixed_matrix', 'bodyfixed_to_j2000_matrix'):
        j_m = np.asarray(getattr(j_model, name)(et))
        t_m = getattr(t_model, name)(et).numpy()
        np.testing.assert_allclose(t_m, j_m, rtol=0, atol=1e-12)
    j_d = np.asarray(j_model.bodyfixed_to_j2000_matrix_deriv(ET_2005))
    t_d = t_model.bodyfixed_to_j2000_matrix_deriv(ET_2005).numpy()
    np.testing.assert_allclose(t_d, j_d, rtol=0, atol=1e-12 * np.abs(j_d).max())


def test_scene_constants_match_jax(kernel_files):
    radii = (71492.0, 71492.0, 66854.0)
    kw = dict(
        target_id=JUPITER, observer_id=EARTH, illumination_source_id=SUN,
        radii=radii, abcorr='CN', et_ref=ET_2005,
    )
    j_engine = j_scene.SceneEngine(
        j_eph.get_ephemeris(),
        frame_model=j_frames.BodyFrameModel.from_pool(
            j_pool.get_pool(), JUPITER
        ),
        **kw,
    )
    t_engine = t_scene.SceneEngine(
        t_eph.get_ephemeris(),
        frame_model=t_frames.BodyFrameModel.from_pool(
            t_pool.get_pool(), JUPITER
        ),
        **kw,
    )
    j_out = j_engine.scene_constants(ET_2005, radii)
    t_out = t_engine.scene_constants(ET_2005, radii)
    assert set(t_out) == set(j_out)
    for key, j_value in j_out.items():
        j_value = np.asarray(j_value, dtype=np.float64)
        if key in ('ring_plane_normal', 'ring_plane_constant'):
            # the plane comes from (north pole - centre) obsvecs, a
            # 1e9 -> 1e5 km cancellation: ~1e-12 relative in both packages
            tol = 1e-10 * np.abs(j_value).max()
        elif key.endswith('_rad'):
            # angles [rad] of points known to 1e-6 km on a 7e4 km body
            tol = 1e-6 / radii[0]
        elif key.endswith('_et') or key == 'target_lt':
            tol = 1e-9  # epochs [s]
        else:
            tol = 1e-6  # positions [km], velocities [km/s]
        np.testing.assert_allclose(
            t_out[key], j_value, rtol=0, atol=tol, err_msg=key
        )
    j_lon = float(j_engine.solar_longitude(ET_2005))
    t_lon = float(t_engine.solar_longitude(ET_2005))
    assert t_lon == pytest.approx(j_lon, abs=1e-11)


def test_scene_batched_functions_match_jax(kernel_files):
    """sincpt / illumf / spkcpt / targvec<->obsvec on seeded points."""
    radii = np.array([71492.0, 71492.0, 66854.0])
    kw = dict(
        target_id=JUPITER, observer_id=EARTH, illumination_source_id=SUN,
        radii=tuple(radii), abcorr='CN', et_ref=ET_2005,
    )
    j_engine = j_scene.SceneEngine(
        j_eph.get_ephemeris(),
        frame_model=j_frames.BodyFrameModel.from_pool(
            j_pool.get_pool(), JUPITER
        ),
        **kw,
    )
    t_engine = t_scene.SceneEngine(
        t_eph.get_ephemeris(),
        frame_model=t_frames.BodyFrameModel.from_pool(
            t_pool.get_pool(), JUPITER
        ),
        **kw,
    )
    sub = {
        k: v for k, v in j_engine.scene_constants(ET_2005, radii).items()
        if k in ('subpoint_targvec', 'subpoint_rayvec', 'subpoint_obsvec',
                 'subpoint_distance', 'subpoint_et')
    }
    sub = {k: np.asarray(v) for k, v in sub.items()}
    rng = np.random.default_rng(11)
    lon = rng.uniform(-1.0, 1.0, 12) + 2.6
    lat = rng.uniform(-1.2, 1.2, 12)
    targvec = np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        -1,
    ) * radii
    target_lt = float(np.linalg.norm(sub['subpoint_rayvec'])) / 299792.458

    j_obs = np.asarray(j_engine.targvec2obsvec(targvec, sub))
    t_obs = t_engine.targvec2obsvec(targvec, sub).numpy()
    np.testing.assert_allclose(t_obs, j_obs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        t_engine.obsvec2targvec(j_obs, sub).numpy(),
        np.asarray(j_engine.obsvec2targvec(j_obs, sub)), rtol=0, atol=1e-6,
    )

    rays = j_obs / np.linalg.norm(j_obs, axis=-1, keepdims=True)
    j_hit = j_engine.sincpt(ET_2005, radii, rays, target_lt)
    t_hit = t_engine.sincpt(ET_2005, radii, rays, target_lt)
    assert np.array_equal(np.asarray(j_hit[2]), t_hit[2].numpy())
    np.testing.assert_allclose(
        t_hit[0].numpy(), np.asarray(j_hit[0]), rtol=0, atol=1e-5
    )

    j_ill = j_engine.illumf(ET_2005, radii, targvec)
    t_ill = t_engine.illumf(ET_2005, radii, targvec)
    for j_v, t_v in zip(j_ill[:3], t_ill[:3]):
        np.testing.assert_allclose(t_v.numpy(), np.asarray(j_v), rtol=0,
                                   atol=1e-11)
    for j_v, t_v in zip(j_ill[3:], t_ill[3:]):
        assert np.array_equal(t_v.numpy(), np.asarray(j_v))

    j_state, j_lt = j_engine.spkcpt(ET_2005, targvec)
    t_state, t_lt = t_engine.spkcpt(ET_2005, targvec)
    np.testing.assert_allclose(
        t_state.numpy()[:, :3], np.asarray(j_state)[:, :3], rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(
        t_state.numpy()[:, 3:], np.asarray(j_state)[:, 3:], rtol=0, atol=1e-9
    )
    np.testing.assert_allclose(t_lt.numpy(), np.asarray(j_lt), rtol=1e-14)


def test_scene_tensors_stay_float64_on_cpu(kernel_files):
    state, lt = t_eph.get_ephemeris().spkezr(JUPITER, EARTH, ET_2005)
    assert state.dtype == torch.float64 and state.device.type == 'cpu'
    assert lt.dtype == torch.float64


META = torch.device('meta')
CPU = torch.device('cpu')


@pytest.mark.parametrize('n_elements, device, want', [
    (1, META, CPU), (4096, META, CPU), (4097, META, META),
    (720 * 1440 * 3, META, META), (10**6, CPU, CPU),
])
def test_scene_device_routes_bulk_calls_only(n_elements, device, want):
    # the JAX package's threshold (core/ephemeris.py _SMALL_CALL_ELEMENTS)
    assert _device.BULK_ELEMENTS == j_eph._SMALL_CALL_ELEMENTS == 4096
    assert _device.scene_device(n_elements, device) == want


@pytest.mark.parametrize('args, want', [
    ((np.zeros((5000, 3)),), CPU),                      # host arrays stay
    ((1.0, torch.zeros((10, 3), device=META)), CPU),    # a scalar call
    ((1.0, torch.zeros((2000, 3), device=META)), META),
    ((np.zeros(3), torch.zeros(5000, device=META)), META),
])
def test_call_device_of_scene_arguments(args, want):
    assert _device.call_device(*args) == want


def test_bulk_scene_calls_run_on_their_inputs_device(kernel_files):
    engine = t_scene.SceneEngine(
        t_eph.get_ephemeris(), target_id=JUPITER, observer_id=EARTH,
        illumination_source_id=SUN, radii=(71492.0, 71492.0, 66854.0),
        frame_model=t_frames.BodyFrameModel.from_pool(t_pool.get_pool(),
                                                      JUPITER),
        abcorr='CN', et_ref=ET_2005,
    )
    radii = np.array([71492.0, 71492.0, 66854.0])
    sub = {k: np.asarray(v) for k, v in engine.scene_constants(
        ET_2005, radii).items() if k.startswith('subpoint_')}
    # (a small meta tensor would be copied to the host, which meta cannot)
    bulk = torch.zeros((3000, 3), dtype=torch.float64, device=META)
    for targvec, want in ((bulk, META), (np.ones((3000, 3)), CPU)):
        outs = [*engine.illumf(ET_2005, radii, targvec),
                engine.targvec2obsvec(targvec, sub),
                engine.obsvec2targvec(targvec, sub),
                *engine.spkcpt(ET_2005, targvec),
                *engine.sincpt(ET_2005, radii, targvec, 1.0)]
        assert {t.device for t in outs} == {want}
        assert all(t.dtype in (torch.float64, torch.bool) for t in outs)
