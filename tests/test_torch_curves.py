"""
The port's limb and terminator curves, other bodies, rings and grids
against the JAX package, on the synthetic SPICE kernels with the
satellites (Jupiter from the Earth on 2005-01-01; Io with its radii and
Amalthea without, ``testing/synthetic_kernels.py``).

Bars:

- ``SceneEngine.limbpt``/``termpt`` body-fixed points within 1e-6 km (the
  limb point is ill-conditioned along the line of sight: 4e-7 km measured
  on a 71,492 km body, while its RA/Dec agree to 1e-13 deg);
- curves in RA/Dec within 1e-9 deg, in pixels within 2e-9 px (the x/y map
  bar of ``tests/test_torch_map.py``), in lon/lat within 1e-9 deg, a
  longitude's bar scaled by 1/cos(lat) up to 100x (a limb passes near the
  pole, where longitude is ill-conditioned: 2e-9 deg measured at 87 deg);
  NaN masks equal but for at most 8 points, each at the visibility
  threshold (``testing/compare.compare_curve``);
- every ``other_body_los_intercept`` class the synthetic orbits reach,
  at epochs where the JAX package gives it, equal; the satellite scan,
  named rings and ``get_description`` equal.

A bulk (8192-point) limb and terminator take the bulk branch of the device
rule on a ``meta`` body and are held to the JAX package on a CPU body.
"""

from __future__ import annotations

import math

import jax  # noqa: F401  (the JAX package under test runs on it)
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.testing import compare
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    SATELLITE_STEP_S,
    coverage,
    satellite_states,
    synthetic_states,
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
SZ = 64
DISC = (31.4, 30.2, 24.6, 17.0)
KM_BAR = 1e-6
DEG_BAR = compare.F64_ANGLE
PX_BAR = 2e-9
BULK = 8192


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def kernels(tmp_path_factory):
    """Both packages on the synthetic kernels with the satellites."""
    path = tmp_path_factory.mktemp('synthetic_kernels')
    files = write_synthetic_kernels(path, seed=0, satellites=True)
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


@pytest.fixture(scope='module')
def bodies(kernels):
    """The same BodyXY in both packages (the port's on the CPU)."""
    j_body = jpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SZ)
    t_body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SZ,
                        device='cpu')
    for body in (j_body, t_body):
        body.set_disc_params(*DISC)
    return j_body, t_body


def _assert_curve(got, ref, bar, **kw):
    report = compare.compare_curve(got, ref, bar, **kw)
    assert report['ok'], report


def _lon_scale(lat):
    """A longitude's conditioning: 1/cos(lat), at most 100x."""
    cos = np.abs(np.cos(np.deg2rad(np.nan_to_num(np.asarray(lat)))))
    return np.minimum(1.0 / np.maximum(cos, 1e-300),
                      compare.ILL_CONDITIONED_FACTOR)


def _assert_lonlat(got, ref):
    (lon_g, lat_g), (lon_r, lat_r) = got, ref
    _assert_curve(lon_g, lon_r, DEG_BAR, period=360.0,
                  scale=_lon_scale(lat_r))
    _assert_curve(lat_g, lat_r, DEG_BAR)


# ---------------------------------------------------------------------------
# The synthetic satellites
# ---------------------------------------------------------------------------

def test_satellites_leave_the_planets_bit_for_bit(tmp_path):
    """The Sun, Earth and Jupiter segments hold the same words with and
    without the satellites, and the satellites' segments are relative to
    Jupiter; the default files are byte for byte the ones written before
    the satellites existed (their SHA-256 pinned)."""
    import hashlib

    from planetmapper_tpu_torch.kernels import spk

    plain_files = write_synthetic_kernels(tmp_path / 'a')
    digests = [hashlib.sha256(open(f, 'rb').read()).hexdigest()[:16]
               for f in plain_files]
    assert digests == ['237dc8567f36eaef', '02f6220c6123dfe3',
                       'c6651824845543ee']
    plain = spk.parse_spk_file(plain_files[2])
    moons = spk.parse_spk_file(
        write_synthetic_kernels(tmp_path / 'b', satellites=True)[2])
    assert [(s.target, s.center) for s in moons] == [
        (10, 0), (399, 0), (599, 0), (501, 599), (505, 599)]
    for a, b in zip(plain, moons[:3]):
        assert (a.target, a.start_et, a.end_et) == (b.target, b.start_et,
                                                    b.end_et)
        np.testing.assert_array_equal(a.data.epochs, b.data.epochs)
        np.testing.assert_array_equal(a.data.states, b.data.states)


@pytest.mark.parametrize('body', [501, 505])
def test_satellite_segments_interpolate_their_orbits(kernels, body):
    """Between the samples the Hermite window stays on the analytic orbit
    within 1e-6 km (the bar of the body-fixed points)."""
    from planetmapper_tpu_torch.core.ephemeris import Ephemeris
    from planetmapper_tpu_torch.kernels import spk

    segment = next(s for s in spk.parse_spk_file(kernels[2])
                   if s.target == body)
    start, _ = coverage()
    t = start + SATELLITE_STEP_S * (np.arange(200) + 0.37) + 86400.0
    state = Ephemeris(t_pool.KernelPool()).segment_state(
        segment, torch.from_numpy(t))
    ref = satellite_states(t)[body]
    np.testing.assert_allclose(state[:, :3].numpy(), ref[:, :3], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(state[:, 3:].numpy(), ref[:, 3:], rtol=0,
                               atol=1e-9)
    assert set(synthetic_states(t)) == {10, 399, 599}


# ---------------------------------------------------------------------------
# Repairs: copies carry the options
# ---------------------------------------------------------------------------

def _decorate(body):
    body.ring_radii.add(100000.0)
    body.add_other_bodies_of_interest('IO', 505)
    body.coordinates_of_interest_lonlat.append((10.0, -20.0))
    body.coordinates_of_interest_radec.append((199.5, -6.9))


def _options(body):
    return (sorted(body.ring_radii),
            [(type(o).__name__, o.target) for o in
             body.other_bodies_of_interest],
            list(body.coordinates_of_interest_lonlat),
            list(body.coordinates_of_interest_radec))


@pytest.mark.parametrize('how', ['copy', 'replace', 'to_body', 'from_body',
                                 'body copy'])
def test_copies_carry_rings_bodies_and_coordinates(bodies, how):
    results = []
    for pkg, body in zip((jpm, tpm), bodies):
        source = body.copy()
        if how == 'body copy':
            source = source.to_body()
        _decorate(source)
        if how in ('copy', 'body copy'):
            new = source.copy()
        elif how == 'replace':
            new = source.replace(observer='EARTH')
        elif how == 'to_body':
            new = source.to_body()
        else:
            kw = dict(device='cpu') if pkg is tpm else {}
            new = pkg.BodyXY.from_body(source.to_body(), sz=SZ, **kw)
        # the lists are copies, not the same objects
        new.ring_radii.add(1.0)
        new.coordinates_of_interest_lonlat.append((0.0, 0.0))
        assert 1.0 not in source.ring_radii
        results.append(_options(new))
    assert results[1] == results[0]
    assert results[1][0] == [1.0, 100000.0]
    assert [name for _, name in results[1][1]] == ['IO', 'AMALTHEA']


# ---------------------------------------------------------------------------
# SceneEngine.limbpt / termpt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('curve', ['limb', 'umbral', 'penumbral'])
@pytest.mark.parametrize('npts', [360, 7])
def test_limbpt_termpt_match_jax(bodies, curve, npts):
    j_body, t_body = bodies
    if curve == 'limb':
        ref = np.asarray(j_body._limb_targvec(npts=npts))
        got = t_body._limb_targvec(npts=npts)
    else:
        kw = dict(npts=npts, only_visible=False, close_loop=True, alt=0.0,
                  method=f'{curve.upper()}/TANGENT/ELLIPSOID',
                  corloc='ELLIPSOID TERMINATOR')
        ref = np.asarray(j_body._terminator_targvec(**kw))
        got = t_body._terminator_targvec(**kw)
    assert got.dtype == torch.float64 and got.device.type == 'cpu'
    assert got.shape == ref.shape == (npts + 1, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=KM_BAR)
    # the points lie on the surface
    radii = np.asarray(t_body.radii)
    np.testing.assert_allclose(
        np.sum((got.numpy() / radii) ** 2, axis=-1), 1.0, atol=1e-12)


def test_source_radius_and_engine_inputs(bodies):
    _, t_body = bodies
    assert t_body._engine._source_radius() == 696000.0
    rolls = np.linspace(0, 2 * np.pi, 5)
    out = t_body._engine.limbpt(t_body.et, t_body.radii, rolls,
                                t_body._sub_consts())
    assert isinstance(out, torch.Tensor) and out.shape == (5, 3)


# ---------------------------------------------------------------------------
# Curves
# ---------------------------------------------------------------------------

RADEC_CURVES = {
    'limb_radec': dict(),
    'limb_radec npts=100 open': dict(npts=100, close_loop=False),
    'limb_radec alt': dict(alt=2000.0),
    'terminator_radec': dict(),
    'terminator_radec all': dict(only_visible=False, npts=90),
    'terminator_radec penumbral': dict(method='PENUMBRAL/TANGENT/ELLIPSOID'),
}


@pytest.mark.parametrize('name', list(RADEC_CURVES))
def test_radec_curves_match_jax(bodies, name):
    j_body, t_body = bodies
    method = name.split()[0]
    kw = RADEC_CURVES[name]
    got = getattr(t_body, method)(**kw)
    ref = getattr(j_body, method)(**kw)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray)
        _assert_curve(g, r, DEG_BAR)


def test_limb_by_illumination_matches_jax(bodies):
    j_body, t_body = bodies
    got = t_body.limb_radec_by_illumination()
    ref = j_body.limb_radec_by_illumination()
    for g, r in zip(got, ref):
        _assert_curve(g, r, DEG_BAR)
    # both halves are lit and unlit points of one limb
    assert np.isfinite(got[0]).any() and np.isfinite(got[2]).any()
    np.testing.assert_array_equal(np.isfinite(got[0]), np.isnan(got[2]))


@pytest.mark.parametrize('name', ['limb', 'limb centric', 'limb alt',
                                  'terminator', 'terminator visible',
                                  'terminator centric alt'])
def test_lonlat_curves_match_jax(bodies, name):
    """(The JAX package converts these curves point by point, so they are
    held at 120 points.)"""
    j_body, t_body = bodies
    centric = 'centric' in name
    if name.startswith('limb'):
        kw = dict(planetocentric=centric, npts=120)
        if 'alt' in name:
            kw['alt'] = 1500.0
        got, ref = t_body.limb_lonlat(**kw), j_body.limb_lonlat(**kw)
    else:
        kw = dict(planetocentric=centric, npts=120,
                  only_visible='visible' in name,
                  alt=800.0 if 'alt' in name else 0.0)
        got = t_body.terminator_lonlat(**kw)
        ref = j_body.terminator_lonlat(**kw)
    _assert_lonlat(got, ref)


@pytest.mark.parametrize('name', ['limb_xy', 'limb_xy_by_illumination',
                                  'terminator_xy', 'ring_xy',
                                  'visible_lonlat_grid_xy'])
def test_xy_curves_match_jax(bodies, name):
    j_body, t_body = bodies
    args = (129000.0,) if name == 'ring_xy' else ()
    got = getattr(t_body, name)(*args)
    ref = getattr(j_body, name)(*args)
    if name == 'visible_lonlat_grid_xy':
        got = [a for xy in got for a in xy]
        ref = [a for xy in ref for a in xy]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _assert_curve(g, r, PX_BAR)


# ---------------------------------------------------------------------------
# Rings and grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('radius, npts, only_visible', [
    (129000.0, 360, True), (226000.0, 50, False), (71492.0, 90, True),
])
def test_ring_radec_matches_jax(bodies, radius, npts, only_visible):
    j_body, t_body = bodies
    got = t_body.ring_radec(radius, npts=npts, only_visible=only_visible)
    ref = j_body.ring_radec(radius, npts=npts, only_visible=only_visible)
    for g, r in zip(got, ref):
        _assert_curve(g, r, DEG_BAR)


def test_named_rings_match_jax(bodies):
    results = []
    for body in bodies:
        new = body.copy()
        names = list(new.named_ring_data)
        radii = {n: new.ring_radii_from_name(n) for n in names}
        aliases = {n: new.ring_radii_from_name(f' {n.upper()} ')
                   for n in names}
        with pytest.raises(ValueError, match='No rings found'):
            new.ring_radii_from_name('not a ring')
        new.add_named_rings(names[0])
        one = sorted(new.ring_radii)
        new.add_named_rings()
        results.append((names, radii, aliases, one, sorted(new.ring_radii)))
    assert results[1] == results[0]
    assert results[1][0]  # Jupiter has named rings in the data files


@pytest.mark.parametrize('planetocentric', [False, True])
@pytest.mark.parametrize('kw', [dict(), dict(interval=45, npts=31,
                                             lat_limit=60.0, alt=300.0)])
def test_lonlat_grids_match_jax(bodies, planetocentric, kw):
    j_body, t_body = bodies
    got = t_body.visible_lonlat_grid_radec(planetocentric=planetocentric,
                                           **kw)
    ref = j_body.visible_lonlat_grid_radec(planetocentric=planetocentric,
                                           **kw)
    assert len(got) == len(ref) > 0
    for (ra_g, dec_g), (ra_r, dec_r) in zip(got, ref):
        _assert_curve(ra_g, ra_r, DEG_BAR, period=360.0)
        _assert_curve(dec_g, dec_r, DEG_BAR)
    lons = t_body.visible_lon_grid_radec([0, 90], npts=11)
    lats = t_body.visible_lat_grid_radec([-95, 0], npts=11, lat_limit=80)
    assert len(lons) == 2 and len(lats) == 1


@pytest.mark.parametrize('alt', [0.0, 250.0])
@pytest.mark.parametrize('multiline', [True, False])
def test_get_description_matches_jax(bodies, multiline, alt):
    from planetmapper_tpu.body import _AdjustedSurfaceAltitude as j_alt
    from planetmapper_tpu_torch.body import _AdjustedSurfaceAltitude as t_alt

    j_body, t_body = bodies
    with j_alt(j_body, alt), t_alt(t_body, alt):
        assert t_body.get_description(multiline) == \
            j_body.get_description(multiline)


# ---------------------------------------------------------------------------
# Other bodies
# ---------------------------------------------------------------------------

#: (epoch, other body, the JAX package's class there): every class the
#: synthetic orbits reach, each at an epoch inside its window (found by
#: stepping both bodies' orbits 2 minutes at a time)
LOS_CASES = [
    ('2005-01-01T00:00:00', 'IO', None),
    ('2005-01-01T18:47:00', 'IO', 'part hidden'),
    ('2005-01-01T19:10:00', 'IO', 'hidden'),
    ('2005-01-02T16:01:00', 'IO', 'part transit'),
    ('2005-01-02T17:00:00', 'IO', 'transit'),
    ('2005-01-01T00:00:00', 'JUPITER', 'same'),
    ('2005-01-01T00:00:00', 505, None),
    ('2005-01-01T01:00:00', 505, 'hidden'),
    ('2005-01-01T06:30:00', 505, 'transit'),
]


@pytest.mark.parametrize('utc, other, expected', LOS_CASES)
def test_other_body_los_intercept_matches_jax(kernels, utc, other, expected):
    j_body = jpm.Body('Jupiter', utc)
    t_body = tpm.Body('Jupiter', utc)
    assert j_body.other_body_los_intercept(other) == expected
    assert t_body.other_body_los_intercept(other) == expected
    t_other = t_body.create_other_body(other)
    assert t_body.other_body_los_intercept(t_other) == expected
    assert t_body.test_if_other_body_visible(t_other) == \
        j_body.test_if_other_body_visible(other) == (expected != 'hidden')


def test_create_other_body_matches_jax(bodies):
    j_body, t_body = bodies
    for other in ('IO', 501, 505, 'AMALTHEA'):
        got, ref = t_body.create_other_body(other), j_body.create_other_body(
            other)
        assert type(got).__name__ == type(ref).__name__
        assert (got.target, got.target_body_id) == (ref.target,
                                                    ref.target_body_id)
        np.testing.assert_allclose((got.target_ra, got.target_dec),
                                   (ref.target_ra, ref.target_dec), rtol=0,
                                   atol=DEG_BAR)
    io = t_body.create_other_body('IO')
    assert io.device == t_body.device
    with pytest.raises(tpm.base.NotFoundError, match='Body name'):
        t_body.create_other_body('NOT A BODY')
    with pytest.raises(t_pool.KernelVarNotFoundError):
        t_body.create_other_body(505, fallback_to_basic_body=False)


def test_satellite_scan_matches_jax(bodies):
    j_body, t_body = bodies
    from planetmapper_tpu.base import SpiceError as JSpiceError

    # Europa (502) is a named satellite with no data: the scan stops there
    # unless told to skip, in both packages
    with pytest.raises(JSpiceError):
        j_body.copy()._get_all_satellite_bodies()
    with pytest.raises(tpm.base.SpiceError):
        t_body.copy()._get_all_satellite_bodies()
    for kw in (dict(), dict(only_visible=True)):
        lists = []
        for body in bodies:
            new = body.copy()
            new.add_satellites_to_bodies_of_interest(
                skip_insufficient_data=True, **kw)
            new.add_satellites_to_bodies_of_interest(
                skip_insufficient_data=True, **kw)  # no duplicates
            lists.append([(type(o).__name__, o.target)
                          for o in new.other_bodies_of_interest])
        assert lists[1] == lists[0] == [('Body', 'IO'),
                                        ('BasicBody', 'AMALTHEA')]


def test_add_other_bodies_only_visible(kernels):
    utc = LOS_CASES[2][0]  # Io hidden
    lists = []
    for pkg in (jpm, tpm):
        body = pkg.Body('Jupiter', utc)
        body.add_other_bodies_of_interest('IO', 505, only_visible=True)
        body.add_other_bodies_of_interest(505)
        lists.append([o.target for o in body.other_bodies_of_interest])
    assert lists[1] == lists[0] == ['AMALTHEA']


# ---------------------------------------------------------------------------
# The bulk route
# ---------------------------------------------------------------------------

def test_bulk_curves_run_on_the_bodys_device(bodies):
    """An 8192-point limb and terminator on a ``meta`` body (standing in for
    the card) run there, with no host tensor mixed in; on a plain Body they
    run on the host."""
    _, t_body = bodies
    meta = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=SZ,
                      device='meta')
    limb = meta._limb_targvec(npts=BULK)
    term = meta._terminator_targvec(
        npts=BULK, only_visible=True, close_loop=True, alt=0.0,
        method='UMBRAL/TANGENT/ELLIPSOID', corloc='ELLIPSOID TERMINATOR')
    assert limb.device.type == term.device.type == 'meta'
    assert limb.shape == term.shape == (BULK + 1, 3)
    small = meta._limb_targvec(npts=360)
    assert small.device.type == 'cpu'
    assert t_body.to_body()._limb_targvec(npts=BULK).device.type == 'cpu'
    other = meta.create_other_body('IO')
    assert other.device == torch.device('meta')
    assert other._limb_targvec(npts=BULK).device.type == 'meta'


@pytest.mark.parametrize('name', ['limb_radec', 'terminator_radec'])
def test_bulk_curves_match_jax(bodies, name):
    j_body, t_body = bodies
    got = getattr(t_body, name)(npts=BULK)
    ref = getattr(j_body, name)(npts=BULK)
    for g, r in zip(got, ref):
        assert g.shape == (BULK + 1,)
        _assert_curve(g, r, DEG_BAR)
    assert math.isfinite(float(np.nanmax(got[0])))
