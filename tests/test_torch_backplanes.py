"""
The port's per-plane backplanes and per-point Body/BodyXY API against the
JAX package, on the synthetic SPICE kernels (Jupiter from the Earth on
2005-01-01, a 64x96 frame, so that the image chain takes the bulk route,
and a 24x48 map):

- the 26 image getters and the 26 map getters through ``get_backplane_img``
  and ``get_backplane_map``, one case per plane name; float64 against
  float64 at the bars of ``testing/compare.py`` (``per_plane_tolerance``:
  1e-9 deg for angles, 1e-13 of the target distance for positions and
  distances, 1e-9 km/s, LOCAL-SOLAR-TIME equal but for counted floor
  flips; 100x where the geometry is ill-conditioned; NaN masks equal but
  on the disc boundary);
- the point transforms and the per-point physics with numpy arrays,
  tensors and one point alike;
- the registry (names, descriptions, errors, ``alt=``, read-only returns),
  the host route of ``map_img`` (``PLANETMAPPER_TPU_MAP_DEVICE=off``), the
  image and map chains on PyTorch's ``meta`` device, the package's exports
  and ``BasicBody``.

Inputs come from a numpy seed and pass to both packages as numpy arrays.
"""

from __future__ import annotations

import contextlib
import io
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
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
NX, NY = 96, 64
MAP = dict(degree_interval=7.5)  # 24 x 48 samples
NAMES = [
    'LON-GRAPHIC', 'LAT-GRAPHIC', 'LON-CENTRIC', 'LAT-CENTRIC', 'RA', 'DEC',
    'PIXEL-X', 'PIXEL-Y', 'KM-X', 'KM-Y', 'ANGULAR-X', 'ANGULAR-Y', 'PHASE',
    'INCIDENCE', 'EMISSION', 'AZIMUTH', 'LOCAL-SOLAR-TIME', 'DISTANCE',
    'RADIAL-VELOCITY', 'DOPPLER', 'LIMB-DISTANCE', 'LIMB-LON-GRAPHIC',
    'LIMB-LAT-GRAPHIC', 'RING-RADIUS', 'RING-LON-GRAPHIC', 'RING-DISTANCE',
]
#: Map pixels: the x/y maps' bar of tests/test_torch_map.py (they come
#: from RA/Dec maps in degrees)
MAP_PIXEL_BAR = 2e-9


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
    j_body = jpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY)
    t_body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY,
                        device='cpu')
    rng = np.random.default_rng(7)
    disc = ((NX - 1) / 2 + rng.uniform(-2, 2), (NY - 1) / 2 + rng.uniform(-2, 2),
            26.0 + rng.uniform(-1, 1), rng.uniform(0, 360))
    for body in (j_body, t_body):
        body.set_disc_params(*disc)
    yield j_body, t_body
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


@pytest.fixture(scope='module')
def jax_images(bodies):
    j_body, _ = bodies
    return {name: np.asarray(j_body.get_backplane_img(name)) for name in NAMES}


@pytest.fixture(scope='module')
def jax_maps(bodies):
    j_body, _ = bodies
    return {name: np.asarray(j_body.get_backplane_map(name, **MAP))
            for name in NAMES}


@pytest.fixture(scope='module')
def meta_body(bodies):
    """The port's body on PyTorch's ``meta`` device, which stands in for the
    card: any step that made a CPU tensor or a host array inside a chain
    would fail to mix with it."""
    _, t_body = bodies
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY,
                      device='meta')
    body.set_disc_params(*t_body.get_disc_params())
    return body


def _tolerance(body, pixel):
    return compare.per_plane_tolerance(body, angle=compare.F64_ANGLE,
                                       pixel=pixel)


def _ray_offset(body):
    """Each pixel's ray distance from the target centre [target radii]."""
    x0, y0, r0, _ = body.get_disc_params()
    yy, xx = np.mgrid[0:NY, 0:NX]
    return np.hypot(xx - x0, yy - y0) / r0


def _assert_plane(name, got, ref, tolerance, ill):
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == ref.shape
    report = compare.compare_per_plane({name: got}, {name: ref}, tolerance,
                                       ill)[name]
    assert report['ok'], report['reason']
    assert np.isfinite(ref).sum() > 100


# ---------------------------------------------------------------------------
# The 52 getters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', NAMES)
def test_image_getter_matches_jax(bodies, jax_images, name):
    _, t_body = bodies
    got = t_body.get_backplane_img(name)
    ill = compare.per_plane_ill_conditioned(jax_images, _ray_offset(t_body))
    _assert_plane(name, got, jax_images[name], _tolerance(t_body, 0.0), ill)
    # the registered getter returns a read-only view of one host copy
    getter = t_body.get_backplane(name).get_img
    assert not getter().flags.writeable and got.flags.writeable
    if name not in ('PIXEL-X', 'PIXEL-Y', 'ANGULAR-X', 'ANGULAR-Y',
                    'DOPPLER'):
        assert np.shares_memory(getter(), getter())


@pytest.mark.parametrize('name', NAMES)
def test_map_getter_matches_jax(bodies, jax_maps, name):
    _, t_body = bodies
    got = t_body.get_backplane_map(name, **MAP)
    # the ray to a surface point at emission e passes R sin(e) from the
    # centre of a sphere of radius R
    ill = compare.per_plane_ill_conditioned(
        jax_maps, np.abs(np.sin(np.radians(jax_maps['EMISSION']))))
    _assert_plane(name, got, jax_maps[name],
                  _tolerance(t_body, MAP_PIXEL_BAR), ill)
    assert got.shape == (24, 48)
    getter = t_body.get_backplane(name).get_map
    assert not getter(**MAP).flags.writeable and got.flags.writeable


def test_quirks_of_the_reference_hold(bodies):
    """The reference's masks, ported as they are."""
    _, t_body = bodies
    lit = t_body._illumf_map(**MAP)[..., 4].numpy() > 0
    visible = t_body._illumf_map(**MAP)[..., 3].numpy() > 0
    # limb and ring maps are masked by the lit flag, not the visible flag
    assert (lit & ~visible).any()
    for name in ('LIMB-DISTANCE', 'RING-LON-GRAPHIC'):
        plane = t_body.get_backplane_map(name, **MAP)
        assert not np.isfinite(plane[~lit]).any()
        assert np.isfinite(plane[lit & ~visible]).any()
    # ring images hide points farther than the surface behind them
    rings = t_body.get_ring_plane_distance_img()
    surface = t_body.get_distance_img()
    both = np.isfinite(rings) & np.isfinite(surface)
    assert both.any() and np.all(rings[both] <= surface[both])


# ---------------------------------------------------------------------------
# Point transforms and per-point physics
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def points(bodies):
    """
    Seeded pixels, 9 on the disc and 3 off it, where every output is well
    conditioned (:func:`compare.per_plane_ill_conditioned`; emission and
    incidence between 10 and 70 deg, and an azimuth between 10 and 170 deg:
    at this 11 deg phase angle most of the disc reads 160-180 deg, where
    acos amplifies rounding),
    and their RA/Dec, km, angular and lonlat coordinates; the lonlat of an
    off-disc pixel is replaced by one on the far side.
    """
    j_body, _ = bodies
    rng = np.random.default_rng(11)
    x0, y0, r0, _ = j_body.get_disc_params()
    radius = np.concatenate([rng.uniform(0.5, 0.8, 1000),
                             rng.uniform(1.3, 1.7, 100)])
    theta = rng.uniform(0, 2 * np.pi, radius.size)
    x = x0 + r0 * radius * np.cos(theta)
    y = y0 + r0 * radius * np.sin(theta)
    lon, lat = (np.asarray(v) for v in j_body.xy2lonlat(x, y))
    phase, inc, emi = (np.asarray(v) for v in
                       j_body.illumination_angles_from_lonlat(lon, lat))
    azimuth = np.asarray(j_body.azimuth_angle_from_lonlat(lon, lat))
    limb_lat = np.asarray(j_body.limb_coordinates_from_radec(
        *j_body.xy2radec(x, y))[1])
    with np.errstate(invalid='ignore'):
        limb_ok = radius * np.cos(np.radians(limb_lat)) >= 0.55
        on_disc = ((emi > 10) & (emi < 70) & (inc > 10) & (inc < 70)
                   & (azimuth > 10) & (azimuth < 170) & (np.abs(lat) < 60))
    keep = np.concatenate([np.flatnonzero(on_disc & limb_ok)[:9],
                           np.flatnonzero(np.isnan(lon) & limb_ok)[:3]])
    assert keep.size == 12
    x, y, lon, lat = x[keep], y[keep], lon[keep], lat[keep]
    far = ~np.isfinite(lon)
    lon[far] = (j_body.subpoint_lon + 180 + rng.uniform(-20, 20, far.sum()))
    lat[far] = rng.uniform(-30, 30, far.sum())
    return dict(
        xy=(x, y),
        radec=tuple(np.asarray(v) for v in j_body.xy2radec(x, y)),
        km=tuple(np.asarray(v) for v in j_body.xy2km(x, y)),
        angular=tuple(np.asarray(v) for v in j_body.xy2angular(x, y)),
        lonlat=(lon % 360, lat),
    ), far


ANGULAR_KW = dict(origin_ra=None, origin_dec=None, coordinate_rotation=33.0)

#: name -> (call, input points, kind of each output): 'deg' angles, 'km'
#: positions, 'arcsec', 'px', 'kms' velocities, 'h' hours, 'bool', 'vec'
#: body-fixed vectors [km]
TRANSFORMS = {
    'radec2lonlat': (lambda b, u, v: b.radec2lonlat(u, v), 'radec',
                     ('deg', 'deg')),
    'radec2lonlat centric alt': (
        lambda b, u, v: b.radec2lonlat(u, v, alt=300.0, planetocentric=True),
        'radec', ('deg', 'deg')),
    'lonlat2radec centric': (
        lambda b, u, v: b.lonlat2radec(u, v, planetocentric=True), 'lonlat',
        ('deg', 'deg')),
    'lonlat2targvec': (lambda b, u, v: b.lonlat2targvec(u, v), 'lonlat',
                       ('vec',)),
    'angular2radec': (lambda b, u, v: b.angular2radec(u, v, **ANGULAR_KW),
                      'angular', ('deg', 'deg')),
    'angular2lonlat': (lambda b, u, v: b.angular2lonlat(u, v), 'angular',
                       ('deg', 'deg')),
    'lonlat2angular': (lambda b, u, v: b.lonlat2angular(u, v, **ANGULAR_KW),
                       'lonlat', ('arcsec', 'arcsec')),
    'radec2angular': (lambda b, u, v: b.radec2angular(u, v, **ANGULAR_KW),
                      'radec', ('arcsec', 'arcsec')),
    'km2radec': (lambda b, u, v: b.km2radec(u, v), 'km', ('deg', 'deg')),
    'radec2km': (lambda b, u, v: b.radec2km(u, v), 'radec', ('km', 'km')),
    'km2lonlat': (lambda b, u, v: b.km2lonlat(u, v), 'km', ('deg', 'deg')),
    'lonlat2km': (lambda b, u, v: b.lonlat2km(u, v), 'lonlat', ('km', 'km')),
    'km2angular': (lambda b, u, v: b.km2angular(u, v), 'km',
                   ('arcsec', 'arcsec')),
    'angular2km': (lambda b, u, v: b.angular2km(u, v), 'angular',
                   ('km', 'km')),
    'graphic2centric': (
        lambda b, u, v: b.graphic2centric_lonlat(u, v, alt=200.0), 'lonlat',
        ('deg', 'deg')),
    'centric2graphic': (
        lambda b, u, v: b.centric2graphic_lonlat(u, v, alt=200.0), 'lonlat',
        ('deg', 'deg')),
    'xy2radec': (lambda b, u, v: b.xy2radec(u, v), 'xy', ('deg', 'deg')),
    'radec2xy': (lambda b, u, v: b.radec2xy(u, v), 'radec', ('px', 'px')),
    'xy2lonlat': (lambda b, u, v: b.xy2lonlat(u, v), 'xy', ('deg', 'deg')),
    'lonlat2xy': (lambda b, u, v: b.lonlat2xy(u, v), 'lonlat', ('px', 'px')),
    'xy2km': (lambda b, u, v: b.xy2km(u, v), 'xy', ('km', 'km')),
    'km2xy': (lambda b, u, v: b.km2xy(u, v), 'km', ('px', 'px')),
    'xy2angular': (lambda b, u, v: b.xy2angular(u, v, **ANGULAR_KW), 'xy',
                   ('arcsec', 'arcsec')),
    'angular2xy': (lambda b, u, v: b.angular2xy(u, v), 'angular',
                   ('px', 'px')),
    'illumination angles': (
        lambda b, u, v: b.illumination_angles_from_lonlat(u, v), 'lonlat',
        ('deg', 'deg', 'deg')),
    'azimuth': (lambda b, u, v: b.azimuth_angle_from_lonlat(u, v), 'lonlat',
                ('deg',)),
    'illuminated': (lambda b, u, v: b.test_if_lonlat_illuminated(u, v),
                    'lonlat', ('bool',)),
    'visible': (lambda b, u, v: b.test_if_lonlat_visible(u, v), 'lonlat',
                ('bool',)),
    'visible alt': (
        lambda b, u, v: b.test_if_lonlat_visible(u, v, alt=2000.0), 'lonlat',
        ('bool',)),
    'limb coordinates': (
        lambda b, u, v: b.limb_coordinates_from_radec(u, v), 'radec',
        ('deg', 'deg', 'km')),
    'ring plane': (lambda b, u, v: b.ring_plane_coordinates(u, v), 'radec',
                   ('km', 'deg', 'km')),
    'ring plane all': (
        lambda b, u, v: b.ring_plane_coordinates(u, v, only_visible=False),
        'radec', ('km', 'deg', 'km')),
    'radial velocity': (lambda b, u, v: b.radial_velocity_from_lonlat(u, v),
                        'lonlat', ('kms',)),
    'distance': (lambda b, u, v: b.distance_from_lonlat(u, v), 'lonlat',
                 ('km',)),
}


def _bars(t_body):
    position = compare.F64_POSITION_RELATIVE * t_body.target_distance
    return dict(deg=compare.F64_ANGLE, km=position, vec=position,
                arcsec=position / t_body.km_per_arcsec, px=MAP_PIXEL_BAR,
                kms=compare.F64_VELOCITY, bool=0.0)


def _outputs(out, n):
    return tuple(out)[:n] if n > 1 else (out,)


def _assert_close(got, ref, bar, kind):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if kind == 'bool':
        np.testing.assert_array_equal(got, ref)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    d = np.abs(got - ref)
    if kind == 'deg':  # longitudes on the circle
        d = np.minimum(d, 360.0 - d)
    bar = np.asarray(bar).reshape(np.shape(bar) + (1,) * (d.ndim - np.ndim(bar)))
    finite = np.isfinite(d)
    assert np.all(d[finite] <= np.broadcast_to(bar, d.shape)[finite]), d


@pytest.mark.parametrize('name', sorted(TRANSFORMS))
def test_point_transform_matches_jax(bodies, points, name):
    j_body, t_body = bodies
    call, inputs, kinds = TRANSFORMS[name]
    coordinates, far_side = points
    u, v = coordinates[inputs]
    bars = _bars(t_body)
    if inputs == 'lonlat':  # the far side is grazing (emission > 75 deg)
        bars = {k: np.where(far_side, compare.ILL_CONDITIONED_FACTOR * b, b)
                for k, b in bars.items()}
    got = _outputs(call(t_body, u, v), len(kinds))
    ref = _outputs(call(j_body, u, v), len(kinds))
    assert all(isinstance(g, np.ndarray) for g in got)
    for g, r, kind in zip(got, ref, kinds):
        _assert_close(g, r, bars[kind], kind)
    assert any(g.any() if g.dtype == bool else np.isfinite(g).any()
               for g in got)
    # tensors in: tensors out, the numpy path's values
    got_t = _outputs(call(t_body, torch.from_numpy(u), torch.from_numpy(v)),
                     len(kinds))
    for g, t in zip(got, got_t):
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), g)
    # one point in: numbers (a vector for targvec) out, the batch's first
    one = _outputs(call(t_body, float(u[0]), float(v[0])), len(kinds))
    one_ref = _outputs(call(j_body, float(u[0]), float(v[0])), len(kinds))
    for o, o_ref, g, kind in zip(one, one_ref, got, kinds):
        if kind == 'vec':
            assert isinstance(o, np.ndarray) and o.shape == (3,)
        else:
            assert isinstance(o, (float, bool, np.floating, np.bool_))
        np.testing.assert_array_equal(o, g[0])
        _assert_close(o, o_ref, np.asarray(bars[kind]).flat[0], kind)


def test_scalar_only_methods_match_jax(bodies):
    j_body, t_body = bodies
    for lon in (0.0, 17.3, 123.456, 359.9, math.nan):
        for method in ('local_solar_time_from_lon',
                       'local_solar_time_string_from_lon'):
            got = getattr(t_body, method)(lon)
            want = getattr(j_body, method)(lon)
            if isinstance(want, float) and math.isnan(want):
                assert math.isnan(got)
            else:
                assert got == want
    targvec = t_body.lonlat2targvec(40.0, 20.0)
    for alt in (0.0, 100.0):
        np.testing.assert_allclose(
            t_body.targvec2lonlat(targvec, alt=alt, planetocentric=True),
            j_body.targvec2lonlat(targvec, alt=alt, planetocentric=True),
            rtol=0, atol=compare.F64_ANGLE)
    with pytest.raises(tpm.base.NotFoundError, match='No intercept'):
        t_body.radec2lonlat(t_body.target_ra + 1.0, t_body.target_dec,
                            not_found_nan=False)
    assert math.isnan(t_body.radec2lonlat(t_body.target_ra + 1.0,
                                          t_body.target_dec)[0])
    ray = t_body._radec2obsvec_norm(t_body.target_ra, t_body.target_dec)
    np.testing.assert_allclose(t_body._xy2targvec(*t_body.radec2xy(
        t_body.target_ra, t_body.target_dec)), t_body._obsvec_norm2targvec(ray),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        t_body._rayvec2obsvec(np.array([1.0, 2.0, 3.0]), t_body.et),
        j_body._rayvec2obsvec(np.array([1.0, 2.0, 3.0]), j_body.et),
        rtol=0, atol=1e-14)


def test_bodyxy_helpers_match_jax(bodies):
    j_body, t_body = bodies
    for method in ('get_img_limits_radec', 'get_img_limits_km',
                   'get_img_limits_xy'):
        np.testing.assert_allclose(getattr(t_body, method)(),
                                   getattr(j_body, method)(), rtol=1e-12)
    np.testing.assert_allclose(t_body.get_img_limits_angular(**ANGULAR_KW),
                               j_body.get_img_limits_angular(**ANGULAR_KW),
                               rtol=1e-12)
    bodies_out = []
    for body in (j_body.copy(), t_body.copy()):
        body.scale_img_size(1.5)
        body.add_img_border(3)
        body.add_arcsec_offset(0.4, -0.7)
        bodies_out.append((body.get_img_size(), body.get_disc_params()))
        with pytest.raises(ValueError, match='allow_rounding'):
            body.scale_img_size(1.01)
    assert bodies_out[0][0] == bodies_out[1][0]
    np.testing.assert_allclose(bodies_out[1][1], bodies_out[0][1], rtol=1e-12)
    plain = t_body.to_body()
    assert type(plain) is tpm.Body and plain.target == t_body.target
    assert repr(plain) == repr(j_body.to_body())
    again = tpm.BodyXY.from_body(plain, 20, 10, device='cpu')
    assert again.get_img_size() == (20, 10) and again.device.type == 'cpu'
    assert again.target_distance == t_body.target_distance


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax(bodies):
    j_body, t_body = bodies
    assert list(t_body.backplanes) == list(j_body.backplanes) == NAMES
    assert t_body.backplane_summary_string() == \
        j_body.backplane_summary_string()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        t_body.print_backplanes()
    assert printed.getvalue() == t_body.backplane_summary_string() + '\n'
    assert t_body.standardise_backplane_name(' emission ') == 'EMISSION'
    assert t_body.get_backplane(' emission ').name == 'EMISSION'
    np.testing.assert_array_equal(t_body.get_backplane_img(' emission '),
                                  t_body.get_emission_angle_img())
    errors = []
    for body, module in ((j_body, jpm.body_xy), (t_body, tpm.body_xy)):
        with pytest.raises(module.BackplaneNotFoundError) as exc:
            body.get_backplane('no such plane')
        errors.append(str(exc.value))
        with pytest.raises(ValueError, match='already registered') as dup:
            body.register_backplane(' phase', 'x', body.get_x_img,
                                    body.get_x_map)
        errors.append(str(dup.value))
        with pytest.raises(KeyError):
            body.get_backplane_img('NO-SUCH-PLANE')
    assert errors[:2] == errors[2:]
    assert tpm.MapKwargs.__optional_keys__ == jpm.MapKwargs.__optional_keys__
    kw = dict(degree_interval=2, lon=3, cmap='x', alt=1.0)
    assert tpm.body_xy._extract_map_kwargs_from_dict(kw) == \
        jpm.body_xy._extract_map_kwargs_from_dict(kw)


def test_registered_backplane_is_served(bodies):
    _, t_body = bodies
    body = t_body.copy()
    body.register_backplane('twice-x', 'twice the x coordinate',
                            lambda: 2 * body.get_x_img(),
                            lambda **kw: 2 * body.get_x_map(**kw))
    np.testing.assert_array_equal(body.get_backplane_img('TWICE-X'),
                                  2 * body.get_x_img())
    assert 'TWICE-X: twice the x coordinate' in body.backplane_summary_string()


@pytest.mark.parametrize('name', ['LON-GRAPHIC', 'EMISSION', 'DISTANCE',
                                  'LIMB-DISTANCE', 'RING-RADIUS'])
def test_backplane_img_at_altitude_matches_jax(bodies, jax_images, name):
    j_body, t_body = bodies
    got = t_body.get_backplane_img(name, alt=800.0)
    ref = np.asarray(j_body.get_backplane_img(name, alt=800.0))
    ill = compare.per_plane_ill_conditioned(jax_images, _ray_offset(t_body))
    # the raised surface reaches pixels the nominal one misses; the
    # conditioning masks are the nominal surface's, so those are held at
    # the grazing bar
    edge = np.isnan(jax_images['EMISSION']) & np.isfinite(ref)
    ill = {k: v | edge for k, v in ill.items()}
    _assert_plane(name, got, ref, _tolerance(t_body, 0.0), ill)
    assert t_body._alt_adjustment == 0.0
    if name != 'RING-RADIUS':
        assert not np.array_equal(got, t_body.get_backplane_img(name),
                                  equal_nan=True)


# ---------------------------------------------------------------------------
# map_img's host route, the chains on another device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('interpolation', ['nearest', 'linear', 'cubic',
                                           'smooth'])
def test_map_img_host_route(bodies, monkeypatch, interpolation):
    j_body, t_body = bodies
    rng = np.random.default_rng(5)
    cube = rng.normal(size=(2, NY, NX))
    cube[1, 20:23, 40:44] = np.nan
    device = t_body.map_img(cube[1], interpolation=interpolation, **MAP)
    monkeypatch.setenv('PLANETMAPPER_TPU_MAP_DEVICE', 'off')
    host = t_body.map_img(torch.from_numpy(cube[1]),
                          interpolation=interpolation, **MAP)
    host_cube = t_body.map_img(cube, interpolation=interpolation, **MAP)
    ref = np.asarray(j_body.map_img(cube, interpolation=interpolation, **MAP))
    assert isinstance(host, np.ndarray) and host.dtype == np.float64
    assert host_cube.shape == (2, 24, 48)
    np.testing.assert_array_equal(host_cube[1], host)
    # the JAX package's own host route: the same host modules on x/y maps
    # within MAP_PIXEL_BAR of each other
    np.testing.assert_array_equal(np.isnan(host_cube), np.isnan(ref))
    np.testing.assert_allclose(host_cube, ref, rtol=0, atol=1e-7)
    # the device route stores float32 (tests/test_torch_map.py F32_BAR)
    device = device.numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isnan(device), np.isnan(host))
    finite = np.isfinite(host)
    scale = max(np.abs(host[finite]).max(), 1.0)
    assert np.abs(device[finite] - host[finite]).max() <= 2.0**-23 * scale
    with pytest.raises(ValueError, match='inconsistent'):
        t_body.map_img(cube[0, :-1], interpolation=interpolation, **MAP)


def test_map_img_host_route_refused_off_the_cpu(meta_body, monkeypatch):
    # a body off the CPU never maps on the host, whatever the switch says
    monkeypatch.setenv('PLANETMAPPER_TPU_MAP_DEVICE', 'off')
    img = np.zeros((NY, NX))
    for arg in (img, torch.from_numpy(img)):
        with pytest.raises(ValueError, match="device='cpu'"):
            meta_body.map_img(arg, **MAP)


IMAGE_CHAIN =('_get_obsvec_norm_img', '_get_targvec_img', '_get_lonlat_img',
               '_get_lonlat_centric_img', '_get_radec_img', '_get_km_xy_img',
               '_get_illumination_gie_img', '_get_limb_coordinate_imgs',
               '_get_ring_plane_coordinate_imgs')
MAP_CHAIN = ('_targvec_map', '_illumf_map', '_obsvec_map', '_radec_map',
             '_xy_map', '_get_lonlat_centric_map', '_get_km_xy_map',
             '_get_limb_coordinate_maps', '_get_ring_plane_coordinate_maps')


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


def test_chains_stay_on_the_bodys_device(meta_body):
    body = meta_body
    assert NX * NY > tpm._device.BULK_ELEMENTS
    for name in IMAGE_CHAIN + ('_get_state_imgs',):
        for t in _tensors(getattr(body, name)()):
            assert t.device.type == 'meta' and t.dtype == torch.float64
            assert t.shape[:2] == (NY, NX)
    bulk = dict(degree_interval=2)  # 90 x 180 samples
    for name in MAP_CHAIN + ('_get_state_maps',):
        for t in _tensors(getattr(body, name)(**bulk)):
            assert t.device.type == 'meta' and t.dtype == torch.float64
            assert t.shape[:2] == (90, 180)
    # a frame of 4096 pixels or fewer takes the host, as a scalar call
    small = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, sz=64,
                       device='meta')
    assert 64 * 64 <= tpm._device.BULK_ELEMENTS
    for name in IMAGE_CHAIN:
        assert getattr(small, name)().device.type == 'cpu'


def test_mixed_arguments_run_on_the_tensors_device(meta_body):
    # a numpy argument beside a bulk tensor is only broadcast by the public
    # transform; the transforms it reaches run the call on the tensor's
    # device (the routing rule, chosen in one place)
    n = NX * NY
    x = np.linspace(10.0, 80.0, n)
    y = torch.full((n,), 30.0, dtype=torch.float64, device='meta')
    for out in (meta_body.xy2radec(x, y), meta_body.xy2lonlat(x, y),
                meta_body.xy2km(x, y[:1]), meta_body.radec2lonlat(x, y)):
        for t in out:
            assert isinstance(t, torch.Tensor) and t.device.type == 'meta'
            assert t.shape == (n,) and t.dtype == torch.float64


def test_getters_copy_each_plane_once(bodies):
    _, t_body = bodies
    for getter in (t_body.get_lat_img, t_body.get_distance_img,
                   t_body.get_azimuth_angle_img):
        assert getter() is getter()
    for getter in (t_body.get_lat_centric_map, t_body.get_distance_map,
                   t_body.get_local_solar_time_map):
        assert getter(**MAP) is getter(**MAP)
    # the image chain's caches hold tensors, not host arrays
    cached = [v for k, v in t_body._cache.items()
              if isinstance(k, tuple) and k[0] in IMAGE_CHAIN]
    assert cached and all(isinstance(v, torch.Tensor) for v in cached)


# ---------------------------------------------------------------------------
# Exports and BasicBody
# ---------------------------------------------------------------------------

#: The JAX package's exports whose modules are not ported (none since the
#: GUI, the CLI and the kernel downloader were ported)
NOT_PORTED = set()


def test_exports_match_jax():
    assert set(jpm.__all__) - set(tpm.__all__) == NOT_PORTED
    for name in tpm.__all__:
        assert getattr(tpm, name) is not None, name
    for name in ('body', 'basic_body', 'body_xy', 'base', 'core', 'kernels',
                 'ops', 'progress', 'common', 'exceptions', 'data_loader',
                 'observation', 'utils', 'io', 'gui', 'kernel_downloader',
                 'cli'):
        assert getattr(tpm, name).__name__ == f'planetmapper_tpu_torch.{name}'
    assert tpm.Observation is tpm.observation.Observation
    assert tpm.run_gui is tpm.gui.run_gui
    assert tpm.BodyBase is tpm.base.BodyBase
    for name in ('AngularCoordinateKwargs', 'WireframeKwargs',
                 'LonLatGridKwargs'):
        assert getattr(tpm, name).__optional_keys__ == \
            getattr(jpm, name).__optional_keys__, name
    assert tpm.WireframeComponent == jpm.WireframeComponent
    paths = ['b/naif0012.tls', 'a/pck00010.tpc', 'a/de430.bsp']
    assert tpm.sort_kernel_paths(paths) == jpm.sort_kernel_paths(paths)
    assert tpm.CITATION_STRING and tpm.CITATION_BIBTEX.startswith('@')


def test_basic_body_matches_jax(bodies):
    j_body, t_body = bodies
    got = tpm.BasicBody('Jupiter', UTC, 'EARTH')
    ref = jpm.BasicBody('Jupiter', UTC, 'EARTH')
    assert repr(got) == repr(ref)
    for attr in ('target', 'observer', 'utc', 'target_body_id', 'et'):
        assert getattr(got, attr) == getattr(ref, attr), attr
    for attr, bar in (('target_ra', 1e-10), ('target_dec', 1e-10),
                      ('target_distance', 1e-13 * ref.target_distance),
                      ('target_light_time', 1e-13 * ref.target_light_time)):
        assert abs(getattr(got, attr) - getattr(ref, attr)) <= bar, attr
    assert got.target_ra == t_body.target_ra
    assert got == tpm.BasicBody('Jupiter', UTC) and got != t_body
    assert got.dtm == ref.dtm
    rng = np.random.default_rng(2)
    obsvec = rng.normal(size=(5, 3)) * 1e8
    np.testing.assert_allclose(got._obsvec2radec(obsvec),
                               ref._obsvec2radec(obsvec), rtol=0, atol=1e-12)
    assert got.angular_dist(10.0, 20.0, 11.0, 21.0) == pytest.approx(
        ref.angular_dist(10.0, 20.0, 11.0, 21.0), abs=1e-12)
    assert got.calculate_doppler_factor(12.5) == \
        ref.calculate_doppler_factor(12.5)
    basic = tpm.BasicBody('Jupiter', UTC, illumination_source='SUN')
    assert basic == got
