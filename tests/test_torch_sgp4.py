"""
The port's SPK type 10 (two-line elements, SGP4) against the JAX package's
``kernels/sgp4.py`` and against Spacetrack Report #3:

- the STR#3 verification vectors of objects 88888 (near-earth) and 11801
  (deep space) at the JAX package's few-metre bars
  (``tests/test_kernels.py`` ``TestSgp4``);
- the element-set initialisation (host numpy in both packages) equal
  exactly;
- ``sgp4_propagate`` and ``tle_state_j2000_at_index`` on a grid of times
  for a near-earth set (the synthetic HST series) and the deep-space
  resonant sets (24 h: the Lyddane branch of ``_dpper``; 12 h, e = 0.7),
  and a packet gather of mixed near-earth and deep-space sets, at 1e-6 km
  and 1e-9 km/s;
- the synthetic kernels' type 10 segments read by both packages' parsers,
  word for word, and evaluated through ``segment_state`` (the bracketing
  sets' blend) against the JAX package's;
- a 64x64 ``BodyXY`` seen from HST through ``compute_backplanes`` against
  the JAX package's at the float64 pipeline bars of
  ``test_torch_pipeline.py``;
- the time derivative through ``torch.func.jvp`` of the blended position
  against JAX's ``jvp`` of the same function.
"""

from __future__ import annotations

import datetime
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu.core import ephemeris as j_eph
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu.kernels import sgp4 as j_sgp4
from planetmapper_tpu.kernels import spk as j_spk
from planetmapper_tpu_torch.core import ephemeris as t_eph
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.kernels import sgp4 as t_sgp4
from planetmapper_tpu_torch.kernels import spk as t_spk
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    DEEP_TLE_DAYS,
    DEEP_TLE_IDS,
    HST_ELEMENTS,
    TLE_CONSTANTS,
    TLE_STEP_S,
    coverage,
    tle_packets,
    write_synthetic_kernels,
)
from test_torch_pipeline import assert_f64_parity

#: Port against the JAX package (float64 both; the bars of
#: test_torch_scene.py's segment tests)
KM = 1e-6
KM_S = 1e-9
#: WGS-72 constants of STR#3 (the JAX test's)
STR3_CONSTANTS = np.array([
    1.082616e-3, -2.53881e-6, -1.65597e-6,
    0.0743669161, 120.0, 78.0, 6378.135, 1.0,
])
UTC = '2005-01-01T00:00:00'
ET_2005 = 157809664.1839331  # 2005-01-01T00:00:00 UTC as TDB seconds


def _tle_epoch_to_et(yy_doy: float) -> float:
    """TLE YYDDD.ddd epoch -> seconds past J2000 (the JAX test's
    convention: UTC taken as TDB)."""
    yy = int(yy_doy // 1000)
    doy = yy_doy - yy * 1000
    year = 1900 + yy if yy >= 57 else 2000 + yy
    offset = datetime.datetime(year, 1, 1) - datetime.datetime(2000, 1, 1, 12)
    return offset.total_seconds() + (doy - 1.0) * 86400.0


def _str3_packet(epoch_yydoy, bstar, incl_deg, node_deg, ecc, argp_deg,
                 m_deg, n_revday):
    deg = math.pi / 180.0
    return np.array([[
        0.0, 0.0, bstar, incl_deg * deg, node_deg * deg, ecc,
        argp_deg * deg, m_deg * deg, n_revday * 2.0 * math.pi / 1440.0,
        _tle_epoch_to_et(epoch_yydoy), 0.0, 0.0, 0.0, 0.0,
    ]])


STR3 = {
    '88888': _str3_packet(80275.98708465, 0.66816e-4, 72.8435, 115.9689,
                          0.0086731, 52.6988, 110.5714, 16.05824518),
    '11801': _str3_packet(80230.29629788, 0.14311e-1, 46.7916, 230.4354,
                          0.7318036, 47.4722, 10.4117, 2.28537848),
}


def _propagate(packet, t_minutes, constants=STR3_CONSTANTS):
    params = t_sgp4.sgp4_init_packets(constants, packet)
    c = t_sgp4.Sgp4Constants(*constants)
    et = torch.tensor([packet[0, 9] + t_minutes * 60.0], dtype=torch.float64)
    return t_sgp4.sgp4_propagate(c, params, et).numpy()[0]


def test_str3_near_earth_88888():
    s0 = _propagate(STR3['88888'], 0.0)
    np.testing.assert_allclose(
        s0[:3], [2328.97048951, -5995.22076416, 1719.97067261],
        rtol=0, atol=5e-3,
    )
    np.testing.assert_allclose(
        s0[3:], [2.91207230, -0.98341546, -7.09081703], rtol=0, atol=5e-6,
    )
    s360 = _propagate(STR3['88888'], 360.0)
    np.testing.assert_allclose(
        s360[:3], [2456.10705566, -6071.93853760, 1222.89727783],
        rtol=0, atol=5e-3,
    )


def test_str3_deep_space_11801():
    params = t_sgp4.sgp4_init_packets(STR3_CONSTANTS, STR3['11801'])
    assert params['_has_deep'] and params['deep'][0] == 1.0
    s0 = _propagate(STR3['11801'], 0.0)
    np.testing.assert_allclose(
        s0[:3], [7473.37066650, 428.95261765, 5828.74786377],
        rtol=0, atol=1e-2,
    )
    np.testing.assert_allclose(
        s0[3:], [5.10715413, 6.44468284, -0.18613096], rtol=0, atol=1e-5,
    )
    s360 = _propagate(STR3['11801'], 360.0)
    np.testing.assert_allclose(
        s360[:3], [-3305.22537232, 32410.86328125, -24697.17675781],
        rtol=0, atol=5e-2,
    )


def _sets():
    """name -> (constants, packets): the STR#3 sets, the synthetic HST
    series (four sets) and the deep-space test objects (three sets each),
    and a mixed near-earth/deep-space segment."""
    constants = np.asarray(TLE_CONSTANTS)
    hst_epochs = ET_2005 + TLE_STEP_S * np.arange(4)
    deep_epochs = ET_2005 + 86400.0 * np.asarray(DEEP_TLE_DAYS)
    out = {name: (STR3_CONSTANTS, pk) for name, pk in STR3.items()}
    out['hst'] = (constants, tle_packets(HST_ELEMENTS, hst_epochs))
    for body, elements in DEEP_TLE_IDS.items():
        out[f'deep{body}'] = (constants, tle_packets(elements, deep_epochs))
    out['mixed'] = (constants, np.concatenate(
        [out['hst'][1][:2], out['deep-9001'][1][:1],
         out['deep-9002'][1][2:]]))
    return out


@pytest.mark.parametrize('name', sorted(_sets()))
def test_init_parameters_equal_jax(name):
    constants, packets = _sets()[name]
    got = t_sgp4.sgp4_init_packets(constants, packets)
    ref = j_sgp4.sgp4_init_packets(constants, packets)
    assert set(got) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_resonance_classes_of_the_deep_sets():
    """The deep-space test objects reach both resonance classes (and the
    integrator's masked steps), and the GEO set takes the Lyddane branch."""
    sets = _sets()
    geo = t_sgp4.sgp4_init_packets(*sets['deep-9001'])
    molniya = t_sgp4.sgp4_init_packets(*sets['deep-9002'])
    assert (geo['irez'] == 1.0).all() and (molniya['irez'] == 2.0).all()
    assert (geo['inclo'] < 0.2).all() and (molniya['inclo'] > 0.2).all()
    assert geo['_ds_max_steps'] > 8 and molniya['_ds_max_steps'] > 8


def _times(packets, n=25):
    """A grid of times from a day before the first set's epoch to a day
    after the last, plus each epoch."""
    epochs = packets[:, 9]
    grid = np.linspace(epochs.min() - 86400.0, epochs.max() + 86400.0, n)
    return np.sort(np.concatenate([grid, epochs]))


@pytest.mark.parametrize('name', sorted(_sets()))
def test_propagate_matches_jax(name):
    """``sgp4_propagate`` of each set (TEME) on the time grid."""
    constants, packets = _sets()[name]
    c_j = j_sgp4.Sgp4Constants(*constants)
    c_t = t_sgp4.Sgp4Constants(*constants)
    ets = _times(packets)
    for k in range(packets.shape[0]):
        one = packets[k:k + 1]
        ref = np.asarray(j_sgp4.sgp4_propagate(
            c_j, dict(j_sgp4.sgp4_init_packets(constants, one)), ets))
        got = t_sgp4.sgp4_propagate(
            c_t, t_sgp4.sgp4_init_packets(constants, one), torch.tensor(ets)
        ).numpy()
        np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=0, atol=KM)
        np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=0, atol=KM_S)


@pytest.mark.parametrize('name', sorted(_sets()))
def test_j2000_state_at_index_matches_jax(name):
    """``tle_state_j2000_at_index`` with a per-time packet index (every set
    of the segment on every time of the grid)."""
    constants, packets = _sets()[name]
    ets = _times(packets)
    idx = np.arange(ets.size) % packets.shape[0]
    ref = np.asarray(j_sgp4.tle_state_j2000_at_index(
        constants, j_sgp4.sgp4_init_packets(constants, packets), idx, ets))
    got = t_sgp4.tle_state_j2000_at_index(
        constants, t_sgp4.sgp4_init_packets(constants, packets),
        torch.from_numpy(idx), torch.tensor(ets),
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=0, atol=KM)
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=0, atol=KM_S)


def test_teme_rotation_matches_jax():
    rng = np.random.default_rng(11)
    et = ET_2005 + rng.uniform(-3e8, 3e8, 16)
    dpsi = rng.uniform(-8e-5, 8e-5, 16)
    deps = rng.uniform(-4e-5, 4e-5, 16)
    ref = np.asarray(j_sgp4.teme_to_j2000_matrix(et, dpsi, deps))
    got = t_sgp4.teme_to_j2000_matrix(
        torch.tensor(et), torch.tensor(dpsi), torch.tensor(deps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# The synthetic kernels' type 10 segments
# ---------------------------------------------------------------------------

def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def tle_kernels(tmp_path_factory):
    """Synthetic kernels with the type 10 segments as both packages'
    kernel path; restored afterwards."""
    path = tmp_path_factory.mktemp('synthetic_kernels_tle')
    files = write_synthetic_kernels(path, seed=0, tle=True)
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


def _type10(segments):
    return {s.target: s for s in segments if s.data_type == 10}


def test_default_kernels_have_no_type10(tmp_path):
    files = write_synthetic_kernels(tmp_path, seed=0)
    assert not _type10(t_spk.parse_spk_file(files[2]))


def test_both_parsers_read_the_type10_segments(tle_kernels):
    t_segs = _type10(t_spk.parse_spk_file(tle_kernels[2]))
    j_segs = _type10(j_spk.parse_spk_file(tle_kernels[2]))
    assert sorted(t_segs) == sorted(j_segs) == sorted([-48, *DEEP_TLE_IDS])
    start, end = coverage()
    assert (t_segs[-48].start_et, t_segs[-48].end_et) == (start, end)
    for body, seg in t_segs.items():
        ref = j_segs[body]
        assert (seg.center, seg.frame_id) == (ref.center, ref.frame_id) == \
            (399, 1)
        for field in ('constants', 'epochs', 'packets'):
            np.testing.assert_array_equal(getattr(seg.data, field),
                                          getattr(ref.data, field))
        np.testing.assert_array_equal(seg.data.epochs,
                                      seg.data.packets[:, 9])
        np.testing.assert_array_equal(seg.data.constants, TLE_CONSTANTS)
    hst = t_segs[-48].data
    assert hst.packets.shape == (int(round((end - start) / TLE_STEP_S)) + 1,
                                 14)


@pytest.mark.parametrize('body', [-48, *DEEP_TLE_IDS])
def test_segment_state_matches_jax(tle_kernels, body):
    """The bracketing sets' blend of each type 10 segment, across its
    coverage and at its element sets' epochs."""
    t_seg = _type10(t_spk.parse_spk_file(tle_kernels[2]))[body]
    j_seg = _type10(j_spk.parse_spk_file(tle_kernels[2]))[body]
    rng = np.random.default_rng(abs(body))
    t = np.concatenate([
        rng.uniform(t_seg.start_et, t_seg.end_et, 24),
        t_seg.data.epochs[:6],
    ])
    ref = np.asarray(
        j_eph.Ephemeris(j_pool.KernelPool()).segment_state(j_seg, t))
    got = t_eph.Ephemeris(t_pool.KernelPool()).segment_state(
        t_seg, torch.tensor(t)).numpy()
    np.testing.assert_allclose(got[:, :3], ref[:, :3], rtol=0, atol=KM)
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=0, atol=KM_S)
    radius = np.linalg.norm(got[:, :3], axis=1)
    if body == -48:
        assert (6500.0 < radius).all() and (radius < 7500.0).all()


def test_blended_position_derivative_matches_jax(tle_kernels):
    """``torch.func.jvp`` of the HST segment's blended position (the
    light-time chain differentiates it so) against JAX's ``jvp``, between
    element-set epochs. At an epoch the blend's weight sits on a corner of
    its clip to [0, 1], where the two packages take different one-sided
    derivatives (JAX's ``clip`` halves a tie's derivative, ``torch.clamp``
    passes it whole): 1.06e-6 km/s apart there on this segment."""
    t_seg = _type10(t_spk.parse_spk_file(tle_kernels[2]))[-48]
    j_seg = _type10(j_spk.parse_spk_file(tle_kernels[2]))[-48]
    t = t_seg.data.epochs[3] + np.array([-5e3, 0.5, 123.4, 4e4])
    t_engine = t_eph.Ephemeris(t_pool.KernelPool())
    j_engine = j_eph.Ephemeris(j_pool.KernelPool())
    _, got = torch.func.jvp(
        lambda e: t_engine.segment_state(t_seg, e)[..., :3],
        (torch.tensor(t),), (torch.ones(4, dtype=torch.float64),),
    )
    _, ref = jax.jvp(
        lambda e: j_engine.segment_state(j_seg, e)[..., :3],
        (jnp.asarray(t),), (jnp.ones(4),),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=KM_S)


def test_hst_body_backplanes_match_jax(tle_kernels):
    """A 64x64 BodyXY of Jupiter seen from HST: the observer's state comes
    through the type 10 chain, and compute_backplanes matches the JAX
    package's double-precision planes at the float64 pipeline bars."""
    disc = (31.7, 32.4, 25.3, 17.0)
    j_body = jpm.BodyXY('Jupiter', observer='HST', utc=UTC, sz=64)
    t_body = tpm.BodyXY('Jupiter', observer='HST', utc=UTC, sz=64,
                        device='cpu')
    for body in (j_body, t_body):
        body.set_disc_params(*disc)
    assert t_body.observer == 'HST'
    np.testing.assert_allclose(t_body.target_distance, j_body.target_distance,
                               rtol=1e-13, atol=0)
    j_body._pipeline_precision = 'double'
    ref = {k: np.asarray(v) for k, v in
           jpm.pipeline.compute_backplanes(j_body).items()}
    got = tpm.pipeline.compute_backplanes(t_body)
    assert np.isfinite(got['EMISSION']).sum() > 1000
    assert_f64_parity(got, ref, disc, own_anchors=True)
