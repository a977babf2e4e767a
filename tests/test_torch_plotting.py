"""
The port's plotting (``_body_plotting``, ``_body_xy_plotting`` and the
matplotlib transforms of ``Body`` and ``BodyXY``) against the JAX package,
on the synthetic SPICE kernels with the satellites (Jupiter from the Earth
on 2005-01-01, a 64x48 frame, Io and Amalthea as other bodies of interest,
a ring and a coordinate of interest of each kind).

Bars:

- the wireframe's artist specs: the same kinds, components, overlays and
  texts in the same order; coordinates within 1e-9 deg, NaN masks as in
  ``tests/test_torch_curves.py`` (``testing/compare.compare_curve``);
- ``_get_wireframe_kw``: the same resolved formatting;
- the rasterised overlays (``get_wireframe_overlay_img``/``_map``): equal
  byte for byte;
- the matplotlib transforms' matrices within 1e-11 of their largest entry:
  each is a local affine fit by finite differences of 1 arcsec (or 1 km, 1
  deg) through the unit-vector transforms, where a 1-arcsec difference of
  two unit vectors keeps ~1e-16 / 4.8e-6 = 2e-11 of relative rounding;
  1.5e-12 measured between the packages;
- every artist the plot functions draw (lines, markers, texts, meshes,
  images, titles, limits): the same artists and styles, data within 1e-9
  relative (1e-9 absolute near zero), NaN masks equal.

matplotlib runs on the Agg backend; no window opens.
"""

from __future__ import annotations

import jax  # noqa: F401  (the JAX package under test runs on it)
import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import planetmapper_tpu as jpm  # noqa: E402
import planetmapper_tpu_torch as tpm  # noqa: E402
from planetmapper_tpu.kernels import pool as j_pool  # noqa: E402
from planetmapper_tpu_torch.kernels import pool as t_pool  # noqa: E402
from planetmapper_tpu_torch.testing import compare  # noqa: E402
from planetmapper_tpu_torch.testing.synthetic_kernels import (  # noqa: E402
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
NX, NY = 64, 48
DISC = (33.1, 22.4, 19.3, 24.0)
DEG_BAR = compare.F64_ANGLE
MATRIX_BAR = 1e-11
DATA_RTOL = 1e-9
MAP = dict(degree_interval=10)
ORTHO = dict(projection='orthographic', lon=30.0, lat=-20.0, size=40)


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def bodies(tmp_path_factory):
    """The same decorated BodyXY in both packages (the port's on the CPU)."""
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0, satellites=True)
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
    # one coordinate of interest on the visible disc, one behind it
    front = (round(j_body.subpoint_lon) + 5.0, 10.0)
    for body in (j_body, t_body):
        body.set_disc_params(*DISC)
        body.add_other_bodies_of_interest('IO', 505)
        body.ring_radii.add(129000.0)
        body.coordinates_of_interest_lonlat.extend(
            [front, (front[0] + 180.0, 0.0)])
        body.coordinates_of_interest_radec.append(
            (body.target_ra + 0.001, body.target_dec - 0.001))
    yield j_body, t_body
    plt.close('all')
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


# ---------------------------------------------------------------------------
# Artist specs and formatting
# ---------------------------------------------------------------------------

WIREFRAME_OPTIONS = {
    'default': dict(grid_interval=30, grid_lat_limit=90,
                    planetocentric_grid=False, indicate_equator=False,
                    indicate_prime_meridian=False, label_poles=True),
    'emphasised': dict(grid_interval=45, grid_lat_limit=60,
                       planetocentric_grid=True, indicate_equator=True,
                       indicate_prime_meridian=True, label_poles=False),
}


@pytest.mark.parametrize('options', list(WIREFRAME_OPTIONS))
def test_wireframe_artist_specs_match_jax(bodies, options):
    from planetmapper_tpu import _body_plotting as j_plotting
    from planetmapper_tpu_torch import _body_plotting as t_plotting

    j_body, t_body = bodies
    kw = WIREFRAME_OPTIONS[options]
    got = list(t_plotting._wireframe_artists(t_body, **kw))
    ref = list(j_plotting._wireframe_artists(j_body, **kw))
    assert [(s.kind, s.component, s.overlays, s.text, s.is_curve)
            for s in got] == [(s.kind, s.component, s.overlays, s.text,
                               s.is_curve) for s in ref]
    assert {s.component for s in got} >= {
        'grid', 'limb', 'terminator', 'limb_illuminated', 'ring',
        'coordinate_of_interest_lonlat', 'coordinate_of_interest_radec',
        'other_body_of_interest_label', 'other_body_of_interest_marker'}
    for g, r in zip(got, ref):
        if g.is_curve:
            assert isinstance(g.ras, np.ndarray)
            for a, b, period in ((g.ras, r.ras, 360.0), (g.decs, r.decs, None)):
                report = compare.compare_curve(a, np.asarray(b), DEG_BAR,
                                               period=period)
                assert report['ok'], (g.component, report)
        else:
            np.testing.assert_allclose([g.ras, g.decs],
                                       [float(r.ras), float(r.decs)],
                                       rtol=0, atol=DEG_BAR)


def _normalise(value):
    """Formatting values comparable across the packages (path effects are
    objects made by each package)."""
    if isinstance(value, list):
        return [(type(v).__name__, getattr(v, '_gc', None),
                 getattr(v, '_offset', None)) for v in value]
    return value


@pytest.mark.parametrize('layers', [
    dict(),
    dict(base_formatting=dict(zorder=3, color='g'),
         common_formatting=dict(color='r', linewidth=2, show=True,
                                dms_ticks=False),
         formatting={'all': dict(alpha=0.7), 'limb': dict(color='b'),
                     'pole': dict(size='large')}),
])
def test_wireframe_kw_matches_jax(bodies, layers):
    j_body, t_body = bodies
    got = t_body._get_wireframe_kw(**layers)
    ref = j_body._get_wireframe_kw(**layers)
    assert sorted(got) == sorted(ref)
    for component in ref:
        assert {k: _normalise(v) for k, v in got[component].items()} == \
            {k: _normalise(v) for k, v in ref[component].items()}, component
    assert got['not a component'] == ref['not a component'] == {}
    assert tpm.DEFAULT_WIREFRAME_FORMATTING.keys() == \
        jpm.DEFAULT_WIREFRAME_FORMATTING.keys()


def test_poles_and_wraparound_breaks_match_jax(bodies):
    j_body, t_body = bodies
    assert t_body.get_poles_to_plot() == j_body.get_poles_to_plot()
    ras = np.array([358.0, 359.5, 0.5, 1.0, np.nan, 359.0, 1.0])
    decs = np.arange(ras.size, dtype=float)
    got = t_body._add_nans_for_radec_array_wraparounds(ras, decs)
    ref = j_body._add_nans_for_radec_array_wraparounds(ras, decs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------------------
# The rasterised overlays (the WIREFRAME HDU)
# ---------------------------------------------------------------------------

OVERLAYS = {
    'img': ('get_wireframe_overlay_img', dict(output_size=200)),
    'img rgba': ('get_wireframe_overlay_img',
                 dict(output_size=120, rgba=True, color='r',
                      grid_interval=45)),
    'map': ('get_wireframe_overlay_map', dict(output_size=200, **MAP)),
    'map orthographic': ('get_wireframe_overlay_map',
                         dict(output_size=150, **ORTHO)),
}


@pytest.mark.parametrize('name', list(OVERLAYS))
def test_wireframe_overlays_match_jax_byte_for_byte(bodies, name):
    j_body, t_body = bodies
    method, kw = OVERLAYS[name]
    got = getattr(t_body, method)(**kw)
    ref = getattr(j_body, method)(**kw)
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert (got < 128).any()  # something was drawn


# ---------------------------------------------------------------------------
# Matplotlib transforms
# ---------------------------------------------------------------------------

TRANSFORMS = [
    ('matplotlib_radec2km_transform', {}),
    ('matplotlib_km2radec_transform', {}),
    ('matplotlib_radec2angular_transform', {}),
    ('matplotlib_radec2angular_transform',
     dict(origin_ra=199.6, origin_dec=-6.9, coordinate_rotation=30.0)),
    ('matplotlib_angular2radec_transform', {}),
    ('matplotlib_xy2radec_transform', {}),
    ('matplotlib_radec2xy_transform', {}),
    ('matplotlib_xy2km_transform', {}),
    ('matplotlib_km2xy_transform', {}),
    ('matplotlib_xy2angular_transform', {}),
    ('matplotlib_xy2angular_transform', dict(coordinate_rotation=-15.0)),
    ('matplotlib_angular2xy_transform', dict(origin_ra=199.6)),
]


def _assert_matrix_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=MATRIX_BAR * np.abs(ref).max())


@pytest.mark.parametrize('name, kw', TRANSFORMS,
                         ids=[f'{n}-{i}' for i, (n, _) in
                              enumerate(TRANSFORMS)])
def test_matplotlib_transforms_match_jax(bodies, name, kw):
    j_body, t_body = bodies
    _assert_matrix_close(getattr(t_body, name)(**kw).get_matrix(),
                         getattr(j_body, name)(**kw).get_matrix())


def test_transforms_follow_the_disc(bodies):
    """The xy transforms are mutable: a disc change updates one already
    made, in both packages (the port makes it on first use only)."""
    fresh = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY,
                       device='cpu')
    assert fresh._mpl_transform_xy2angular_fixed is None
    results = []
    for body in (b.copy() for b in bodies):
        fixed = body._get_matplotlib_xy2angular_fixed_transform()
        before = fixed.get_matrix().copy()
        body.adjust_disc_params(dx=1.5, dr=-2.0, drotation=7.0)
        after = body._get_matplotlib_xy2angular_fixed_transform()
        assert after is fixed
        _assert_matrix_close(after.get_matrix(),
                             body._get_xy2angular_matrix())
        assert not np.allclose(before, after.get_matrix())
        results.append(after.get_matrix())
    _assert_matrix_close(results[1], results[0])


# ---------------------------------------------------------------------------
# The plot functions' artists
# ---------------------------------------------------------------------------

def _artists(ax) -> list[tuple]:
    """What an axes shows, as comparable tuples."""
    from matplotlib.collections import QuadMesh

    out = []
    for line in ax.get_lines():
        out.append(('line', line.get_xydata(),
                    (line.get_color(), line.get_linestyle(),
                     line.get_linewidth(), line.get_alpha(),
                     line.get_marker()),
                    line.get_transform().get_affine().get_matrix()))
    for c in ax.collections:
        if isinstance(c, QuadMesh):
            out.append(('mesh', np.asarray(c.get_array(), dtype=float),
                        c.get_coordinates()))
        else:
            out.append(('points', c.get_offsets(), (c.get_alpha(),)))
    for t in ax.texts:
        out.append(('text', np.asarray(t.get_position(), dtype=float),
                    (t.get_text(), t.get_fontsize(), t.get_alpha())))
    for im in ax.get_images():
        out.append(('image', np.asarray(im.get_array(), dtype=float)))
    out.append(('frame', np.array([*ax.get_xlim(), *ax.get_ylim()]),
                (ax.get_title(), ax.get_xlabel(), ax.get_ylabel())))
    return out


def _assert_artists_equal(got, ref):
    assert [a[0] for a in got] == [a[0] for a in ref]
    for g, r in zip(got, ref):
        for a, b in zip(g[1:], r[1:]):
            if isinstance(b, tuple):
                assert a == b, (g[0], a, b)
                continue
            a = np.asarray(a, dtype=float)
            b = np.asarray(b, dtype=float)
            assert a.shape == b.shape, g[0]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
            ok = ~np.isnan(b)
            np.testing.assert_allclose(
                a[ok], b[ok], rtol=DATA_RTOL,
                atol=DATA_RTOL * max(1.0, float(np.abs(b[ok]).max(initial=0))),
                err_msg=g[0])


def _img(body):
    return body.get_backplane_img('EMISSION')


PLOTS = {
    'wireframe_radec': lambda b, ax: b.plot_wireframe_radec(ax),
    'wireframe_radec shifted': lambda b, ax: b.plot_wireframe_radec(
        ax, use_shifted_meridian=True, dms_ticks=False),
    'wireframe_km': lambda b, ax: b.plot_wireframe_km(
        ax, indicate_equator=True, formatting={'limb': dict(color='r')}),
    'wireframe_angular': lambda b, ax: b.plot_wireframe_angular(
        ax, origin_ra=199.6, coordinate_rotation=20.0, alt=500.0),
    'wireframe_xy': lambda b, ax: b.plot_wireframe_xy(ax, grid_interval=45),
    'wireframe_custom': lambda b, ax: b.plot_wireframe_custom(
        ax, coordinate_func=lambda ra, dec: (2 * ra, dec - 1),
        add_title=False),
    'map_wireframe': lambda b, ax: b.plot_map_wireframe(ax, **MAP),
    'map_wireframe orthographic': lambda b, ax: b.plot_map_wireframe(
        ax, color='b', **ORTHO),
    'img xy': lambda b, ax: b.plot_img(_img(b), ax),
    'img radec': lambda b, ax: b.plot_img(_img(b), ax, coordinates='radec'),
    'img km': lambda b, ax: b.plot_img(_img(b), ax, coordinates='km',
                                       add_wireframe=False),
    'img angular': lambda b, ax: b.plot_img(
        _img(b), ax, coordinates='angular',
        angular_kwargs=dict(coordinate_rotation=10.0)),
    'img rgb': lambda b, ax: b.plot_img(
        np.stack([_img(b) / 90.0] * 3, axis=-1), ax, coordinates='radec'),
    'map': lambda b, ax: b.plot_map(b.get_backplane_map('LAT-GRAPHIC', **MAP),
                                    ax, **MAP),
    'backplane_img': lambda b, ax: b.plot_backplane_img('INCIDENCE', ax),
    'backplane_map': lambda b, ax: b.plot_backplane_map('PHASE', ax, **ORTHO),
}


@pytest.mark.parametrize('name', list(PLOTS))
def test_plot_functions_match_jax(bodies, name):
    results = []
    for body in bodies:
        fig, ax = plt.subplots()
        out = PLOTS[name](body, ax)
        assert out is not None
        results.append(_artists(ax))
        plt.close(fig)
    _assert_artists_equal(results[1], results[0])
    assert len(results[1]) > 1


def test_plot_img_rejects_unknown_coordinates(bodies):
    _, t_body = bodies
    fig, ax = plt.subplots()
    with pytest.raises(ValueError, match='Unknown coordinates'):
        t_body.plot_img(_img(t_body), ax, coordinates='lonlat')
    plt.close(fig)
    assert t_body.imshow_map.__doc__
