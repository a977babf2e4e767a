"""
The PyTorch port's backplane pipeline against the JAX package, on the
synthetic SPICE kernels (Jupiter from the Earth on 2005-01-01):

- the scene anchors of both packages agree (rot1/rot2 from autodiff);
- on identical numpy anchors the port's plain float64 graph matches the
  JAX package's ``precision='double'`` graph, for a biaxial and a triaxial
  shape, with and without ``optimize_speed``;
- it matches the JAX package's TPU kernel run in interpret mode at the
  kernel tolerance table;
- the whole slice (``BodyXY.generate_backplanes_fused``) matches the JAX
  package's, against both of its graphs;
- on CPU tensors the CUDA kernel's wrapper runs the plain version and
  launches nothing;
- a BodyXY without ``device=`` needs a card, and LON-CENTRIC lies in
  [0, 360) on a CPU body at the default precision, as in the JAX package;
- the kernel's host scene packing and its bound's operation count, and
  the map kernels' bounds;
- the copy to numpy through the page-locked host slots (the slots ordinary
  host tensors here): the same arrays as a ``.cpu()`` a plane, a slot lent
  again only once no array from it survives, the fallback and its counter,
  a new size, and the paths that keep the old copy.
- the upload ring of ``map_img`` (its chunks ordinary host tensors and its
  events stand-ins here): the chunk plan covers every byte once and in
  order, the route an input takes, the bytes through a ring smaller than
  the input, a wait counted only where a chunk's last copy has not ended,
  the chunks pinned once whatever the sizes, and the plain route counted.

The kernel itself against its plain version on the card is
``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import math
import threading
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu import pipeline as j_pipeline
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu_torch import host_slots, tracing
from planetmapper_tpu_torch import pipeline as t_pipeline
from planetmapper_tpu_torch._device import f64, resolve_device
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.ops import backplanes_kernel, interp_device
from planetmapper_tpu_torch.testing import bounds, compare
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    AU_KM,
    write_synthetic_kernels,
)

NX, NY = 64, 48
UTC = '2005-01-01T00:00:00'

#: Float64-against-float64 bounds (port graph vs JAX graph): angles in
#: degrees, distances in km. The two programs round differently (XLA
#: contracts multiply-adds into FMAs, PyTorch's CPU kernels do not), which
#: leaves ~1e-7 km of disagreement in the 1e9 km vectors of the intercept.
F64_TOLERANCE = {
    'PIXEL-X': 0.0, 'PIXEL-Y': 0.0, 'KM-X': 1e-6, 'KM-Y': 1e-6,
    'ANGULAR-X': 1e-9, 'ANGULAR-Y': 1e-9, 'LOCAL-SOLAR-TIME': 1e-9,
    'DISTANCE': 1e-6, 'RADIAL-VELOCITY': 1e-9, 'DOPPLER': 1e-12,
    'LIMB-DISTANCE': 1e-6, 'RING-RADIUS': 1e-6, 'RING-DISTANCE': 1e-6,
}
F64_ANGLE_TOLERANCE = 1e-9
#: An exact >= test (the intercept discriminant at the limb) may flip on
#: rounding for a pixel whose ray grazes the surface.
F64_MAX_MASK_FLIPS = 2


def f64_tolerance(name: str) -> float:
    return F64_TOLERANCE.get(name, F64_ANGLE_TOLERANCE)


def _ill_conditioned(
    ref: dict, disc, *, own_anchors: bool = False
) -> dict[str, np.ndarray]:
    """
    Pixels where a plane's value is ill-conditioned in its inputs
    (:func:`compare.ill_conditioned`; rays passing near the target centre:
    inside half the disc radius) and, with ``own_anchors`` (each package
    computed its own anchors), the ring planes: the ring-plane anchor is a
    1e9 -> 1e5 km difference that the two packages round apart at ~1e-12
    relative.
    """
    ny, nx = ref['EMISSION'].shape
    yy, xx = np.mgrid[0:ny, 0:nx]
    near_centre = np.hypot(xx - disc[0], yy - disc[1]) < disc[2] / 2
    out = compare.ill_conditioned(ref, near_centre)
    if own_anchors:
        everywhere = np.ones_like(near_centre)
        for name in ('RING-RADIUS', 'RING-LON-GRAPHIC', 'RING-DISTANCE'):
            out[name] = everywhere
    return out


def assert_f64_parity(
    got: dict, ref: dict, disc, *, own_anchors: bool = False
) -> None:
    """The port's float64 output against the JAX float64 output."""
    ill = _ill_conditioned(ref, disc, own_anchors=own_anchors)
    everywhere = compare.compare_backplanes(
        got, ref,
        tolerance=lambda n: (
            f64_tolerance(n) * compare.ILL_CONDITIONED_FACTOR
        ),
        max_mask_flips=F64_MAX_MASK_FLIPS,
    )
    conditioned = compare.compare_backplanes(
        got, ref, tolerance=f64_tolerance, exclude=ill,
        max_mask_flips=F64_MAX_MASK_FLIPS,
    )
    assert not compare.failures(everywhere), compare.failures(everywhere)
    assert not compare.failures(conditioned), compare.failures(conditioned)
    assert all(
        r['lst_bin_flips'] == 0 for r in conditioned.values()
    ), 'LOCAL-SOLAR-TIME bins differ'


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def bodies(tmp_path_factory):
    """(JAX BodyXY, port BodyXY) of the same scene and seeded disc."""
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
    t_body = tpm.BodyXY(
        'Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY, device='cpu'
    )
    rng = np.random.default_rng(0)
    disc = (
        (NX - 1) / 2 + rng.uniform(-2.0, 2.0),
        (NY - 1) / 2 + rng.uniform(-2.0, 2.0),
        19.0 + rng.uniform(-1.0, 1.0),
        rng.uniform(0.0, 360.0),
    )
    for body in (j_body, t_body):
        body.set_disc_params(*disc)
    yield j_body, t_body
    for pkg in (jpm, tpm):
        _restore_kernel_path(pkg, previous[pkg])


def _inputs(body):
    return (
        np.asarray(body._get_xy2angular_matrix()),
        np.asarray(body.get_disc_params(), dtype=np.float64),
        np.asarray(body.radii, dtype=np.float64),
    )


def _run_jax(impl, nx, ny, xy2angular, disc, radii, anchors):
    out = jax.jit(lambda *a: impl(nx, ny, *a))(xy2angular, disc, radii, anchors)
    return {k: np.asarray(v) for k, v in out.items()}


def _run_port(impl, nx, ny, xy2angular, disc, radii, anchors, row0=0.0):
    out = impl(
        nx, ny, f64(xy2angular), f64(disc), f64(radii),
        t_pipeline.anchors_from_numpy(anchors, 'cpu'), row0=row0,
    )
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Scene and anchors
# ---------------------------------------------------------------------------

def test_jax_bodyxy_builds_on_synthetic_kernels(bodies):
    j_body, _ = bodies
    assert 4.0 < j_body.target_distance / AU_KM < 6.0
    anchors = j_body._get_pipeline_anchors()
    to_sun = anchors['sun_pos0'] - anchors['targ_pos0']
    to_obs = anchors['obs_pos'] - anchors['targ_pos0']
    phase = np.degrees(np.arccos(
        to_sun @ to_obs / np.linalg.norm(to_sun) / np.linalg.norm(to_obs)
    ))
    assert 2.0 < phase < 15.0
    assert np.isfinite(j_body.subsol_lon) and np.isfinite(j_body.subpoint_lon)


def test_scene_anchors_match_jax(bodies):
    j_body, t_body = bodies
    j_anchors = j_pipeline.compute_scene_anchors(j_body)
    t_anchors = t_pipeline.compute_scene_anchors(t_body)
    assert set(t_anchors) == set(j_anchors) == set(t_pipeline.ANCHOR_SHAPES)
    for key, j_value in j_anchors.items():
        j_value = np.asarray(j_value, dtype=np.float64)
        scale = np.abs(j_value).max()
        if key in ('rot1', 'rot2'):
            tol = 1e-10 * scale
        elif key in ('rot0', 'obsvec2angular'):
            tol = 1e-12
        elif key in ('angular2km', 'ring_plane_normal',
                     'ring_plane_constant'):
            # built from 1e9 -> 1e5 km differences of obsvecs: ~1e-12
            # relative in both packages
            tol = 1e-10 * scale
        elif key == 'solar_lon_e':
            tol = 1e-10  # rad
        elif key in ('et', 'tau0', 'sun_epoch0', 'target_lt'):
            tol = 1e-9  # s
        else:
            tol = 1e-6  # km, km/s
        np.testing.assert_allclose(
            t_anchors[key], j_value, rtol=0, atol=tol, err_msg=key
        )


def test_body_transforms_match_jax(bodies):
    """The Body transforms the anchors use, on seeded points."""
    j_body, t_body = bodies
    rng = np.random.default_rng(4)
    lon = rng.uniform(0.0, 360.0, 16)
    lat = rng.uniform(-80.0, 80.0, 16)
    for not_visible_nan in (False, True):
        j_radec = j_body.lonlat2radec(lon, lat, not_visible_nan=not_visible_nan)
        t_radec = t_body.lonlat2radec(lon, lat, not_visible_nan=not_visible_nan)
        for j_v, t_v in zip(j_radec, t_radec):
            # 1e-10 deg of sky = 1.4e-3 km at 5 AU
            np.testing.assert_allclose(t_v, j_v, rtol=0, atol=1e-10)
    assert np.isnan(t_radec[0]).any() and np.isfinite(t_radec[0]).any()
    ra, dec = j_radec
    keep = np.isfinite(ra)
    np.testing.assert_allclose(
        t_body.radec2angular(ra[keep], dec[keep]),
        j_body.radec2angular(ra[keep], dec[keep]), rtol=0, atol=1e-9,
    )
    assert t_body.north_pole_angle() == pytest.approx(
        j_body.north_pole_angle(), abs=1e-10
    )
    np.testing.assert_allclose(
        t_body._get_xy2angular_matrix(), j_body._get_xy2angular_matrix(),
        rtol=1e-13, atol=0,
    )


def test_anchors_from_numpy_shapes_and_device(bodies):
    j_body, _ = bodies
    anchors = t_pipeline.anchors_from_numpy(j_body._get_pipeline_anchors(), 'cpu')
    for key, value in anchors.items():
        assert value.dtype == torch.float64 and value.device.type == 'cpu'
        assert tuple(value.shape) == t_pipeline.ANCHOR_SHAPES[key], key
    bad = dict(j_body._get_pipeline_anchors(), rot0=np.eye(2))
    with pytest.raises(ValueError, match='rot0'):
        t_pipeline.anchors_from_numpy(bad, 'cpu')


# ---------------------------------------------------------------------------
# The plain float64 graph against the JAX float64 graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('optimize_speed', [True, False])
@pytest.mark.parametrize('shape', ['biaxial', 'triaxial'])
def test_plain_graph_matches_jax_double_graph(bodies, shape, optimize_speed):
    j_body, _ = bodies
    xy2angular, disc, radii = _inputs(j_body)
    robust = shape == 'triaxial'
    if robust:
        radii = np.array([71492.0, 70000.0, 66854.0])
    anchors = j_body._get_pipeline_anchors()
    kw = dict(
        positive_west=True, prograde=True, have_sun=True,
        optimize_speed=optimize_speed, robust_geodetic=robust,
    )
    ref = _run_jax(
        j_pipeline.fused_backplanes_fn(precision='double', **kw),
        NX, NY, xy2angular, disc, radii, anchors,
    )
    got = _run_port(
        t_pipeline.fused_backplanes_fn(**kw),
        NX, NY, xy2angular, disc, radii, anchors,
    )
    assert set(got) == set(backplanes_kernel.PLANE_ORDER) == set(ref)
    assert np.isfinite(got['EMISSION']).sum() > 100
    assert np.isfinite(got['RING-RADIUS']).sum() > 100
    assert_f64_parity(got, ref, disc)


def test_plain_graph_row0_bands_equal_full_frame(bodies):
    j_body, _ = bodies
    xy2angular, disc, radii = _inputs(j_body)
    anchors = j_body._get_pipeline_anchors()
    impl = t_pipeline.fused_backplanes_fn(
        positive_west=True, prograde=True, have_sun=True,
    )
    full = _run_port(impl, NX, NY, xy2angular, disc, radii, anchors)
    top = _run_port(impl, NX, 20, xy2angular, disc, radii, anchors)
    bottom = _run_port(
        impl, NX, NY - 20, xy2angular, disc, radii, anchors, row0=20.0
    )
    for name, plane in full.items():
        np.testing.assert_array_equal(
            np.concatenate([top[name], bottom[name]]), plane, err_msg=name
        )


# ---------------------------------------------------------------------------
# The plain graph against the JAX TPU kernel (interpret mode)
# ---------------------------------------------------------------------------

def test_plain_graph_matches_jax_kernel_interpret(bodies):
    from planetmapper_tpu.ops.pallas_pipeline import build_pallas_pipeline

    j_body, _ = bodies
    nx, ny = 128, 64  # one kernel tile
    rng = np.random.default_rng(1)
    saved = j_body.get_disc_params()
    j_body.set_disc_params(
        nx / 2 + rng.uniform(-1, 1), ny / 2 + rng.uniform(-1, 1),
        ny * 0.45, 12.3,
    )
    try:
        xy2angular, disc, radii = _inputs(j_body)
    finally:
        j_body.set_disc_params(*saved)
    anchors = j_body._get_pipeline_anchors()
    kernel = build_pallas_pipeline(
        positive_west=True, prograde=True, have_sun=True,
        optimize_speed=True, lst_quant=True, interpret=True,
    )
    ref = _run_jax(kernel, nx, ny, xy2angular, disc, radii, anchors)
    got = _run_port(
        t_pipeline.fused_backplanes_fn(
            positive_west=True, prograde=True, have_sun=True,
        ),
        nx, ny, xy2angular, disc, radii, anchors,
    )
    # The TPU kernel computes its state, illumination and angular chains
    # in float32 (up to ~4 float32 roundings deep) and stores float32: the
    # port's float64 values are stored the same way and the table's
    # bounds grow by four float32 ulps. Longitudes of grazing (emission
    # > 80 deg) or polar (|lat| > 80 deg) pixels are left out: under
    # XLA:CPU the interpret-mode kernel's double-single chains lose their
    # low words (planetmapper_tpu/pipeline.py pick_ds), and that ~1e-3 km
    # position noise grows past 1e-4 deg of longitude there.
    rough = ~(np.abs(got['LAT-GRAPHIC']) < 80.0) | ~(got['EMISSION'] < 80.0)
    reports = compare.compare_backplanes(
        ref, got, float32_ulps=4,
        exclude={'LON-GRAPHIC': rough, 'LON-CENTRIC': rough},
    )
    assert not compare.failures(reports), compare.failures(reports)
    on_disc = np.isfinite(got['LAT-GRAPHIC'])
    assert (rough & on_disc).sum() < 0.1 * on_disc.sum()
    assert np.isfinite(ref['EMISSION']).sum() > 1000


# ---------------------------------------------------------------------------
# The whole slice: BodyXY.generate_backplanes_fused
# ---------------------------------------------------------------------------

def test_generate_backplanes_fused_matches_jax_double(bodies):
    j_body, t_body = bodies
    j_body._pipeline_precision = 'double'
    try:
        ref = j_body.generate_backplanes_fused()
    finally:
        del j_body._pipeline_precision
    got = t_body.generate_backplanes_fused()
    assert set(got) == set(ref)
    assert all(v.shape == (NY, NX) for v in got.values())
    assert_f64_parity(got, ref, t_body.get_disc_params(), own_anchors=True)


def test_generate_backplanes_fused_matches_jax_mixed(bodies):
    j_body, t_body = bodies
    ref = j_body.generate_backplanes_fused()
    got = t_body.generate_backplanes_fused()
    # the JAX mixed graph computes and stores float32 (RADIAL-VELOCITY
    # widened to float64): two float32 ulps over the table, as above
    reports = compare.compare_backplanes(ref, got, float32_ulps=2)
    assert not compare.failures(reports), compare.failures(reports)


# ---------------------------------------------------------------------------
# Selection and the kernel wrapper on the CPU
# ---------------------------------------------------------------------------

def test_kernel_wrapper_runs_plain_version_on_cpu(bodies):
    """On a CPU body the selected impl is the plain graph: one frame of its
    ``frames`` equals the graph's own call word for word; the kernel's
    ``frames`` refuses the CPU and launches nothing."""
    _, t_body = bodies
    xy2angular, disc, radii, anchors = t_pipeline.pipeline_inputs(t_body)
    backplanes_kernel.reset_launch_count()
    impl, use_pallas = t_pipeline.select_pipeline_impl(t_body, NX, NY)
    assert not use_pallas
    got = impl.frames(NX, NY, xy2angular[None], disc[None], radii, anchors,
                      device='cpu')
    plain = _run_port(
        t_pipeline.fused_backplanes_fn(
            positive_west=True, prograde=True, have_sun=True,
            precision='mixed',
        ),
        NX, NY, xy2angular, disc, radii, anchors,
    )
    assert set(got) == set(backplanes_kernel.PLANE_ORDER)
    for name, plane in plain.items():
        assert got[name].shape == (1, NY, NX)
        np.testing.assert_array_equal(got[name][0].numpy(), plane,
                                      err_msg=name)
    wrapper = backplanes_kernel.build_backplanes_kernel(
        positive_west=True, prograde=True, have_sun=True,
        optimize_speed=True, lst_quant=True,
        planes=('LON-GRAPHIC', 'RING-RADIUS', 'RA'),
    )
    with pytest.raises(ValueError, match='no backplane kernel'):
        wrapper.frames(NX, NY, xy2angular[None], disc[None], radii, anchors,
                       device='cpu')
    assert backplanes_kernel.launch_count() == 0


def test_selection_takes_plain_graph_on_cpu(bodies):
    _, t_body = bodies
    backplanes_kernel.reset_launch_count()
    impl, use_pallas = t_pipeline.select_pipeline_impl(t_body, NX, NY)
    assert not use_pallas
    full = t_pipeline.compute_backplanes(t_body)
    subset = t_pipeline.compute_backplanes(
        t_body, names=['EMISSION', 'LON-GRAPHIC']
    )
    assert list(subset) == ['LON-GRAPHIC', 'EMISSION']
    for name, plane in subset.items():
        np.testing.assert_array_equal(plane, full[name])
    t_pipeline.wait_for_steady_state(t_body)  # no-op off the card
    _, checksum = t_pipeline.compute_backplanes(t_body, with_checksum=True)
    assert torch.isfinite(checksum)
    assert backplanes_kernel.launch_count() == 0
    with pytest.raises(ValueError, match='unknown planes'):
        t_pipeline.compute_backplanes(t_body, names=['NO-SUCH-PLANE'])


def test_forced_kernel_refuses_pathological_shape():
    class Fake:
        radii = np.asarray([1000.0, 400.0, 300.0])
        device = torch.device('cpu')

    assert t_pipeline._kernel_geodetic_iters(Fake()) is None
    with pytest.raises(ValueError, match='evolute'):
        t_pipeline.select_pipeline_impl(Fake(), 128, 64, use_pallas=True)
    assert t_pipeline._kernel_geodetic_iters(
        type('B', (), {'radii': np.array([1050.0, 840.0, 537.0])})()
    ) == 4


# ---------------------------------------------------------------------------
# Device default, LON-CENTRIC range, scene packing, the kernel's bound
# ---------------------------------------------------------------------------

def test_body_without_device_needs_a_card(bodies, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device(None)
    body = tpm.BodyXY(
        'Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY, device='cpu'
    )
    assert body.device == torch.device('cpu')
    assert resolve_device('cpu') == torch.device('cpu')


def test_lon_centric_range_matches_jax_mixed(bodies):
    """
    At the default precision both packages report LON-CENTRIC in [0, 360)
    on a CPU body, compared directly (not on the circle); 'double' keeps
    (-180, 180] in both.
    """
    j_body, t_body = bodies
    for body in bodies:  # both at the default precision, 'mixed'
        assert not hasattr(body, '_pipeline_precision')
    got = t_pipeline.compute_backplanes(t_body)['LON-CENTRIC']
    want = j_pipeline.compute_backplanes(j_body)['LON-CENTRIC']
    t_body._pipeline_precision = 'double'
    try:
        signed = t_pipeline.compute_backplanes(t_body)['LON-CENTRIC']
    finally:
        del t_body._pipeline_precision
    on_disc = np.isfinite(signed)
    assert (signed[on_disc] < 0.0).sum() > 100  # negative longitudes in view
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for lon in (got, want):
        assert np.all((lon[on_disc] >= 0.0) & (lon[on_disc] < 360.0))
    # the JAX mixed graph's float32 chain: the kernel table's 1e-4 deg
    # plus two float32 ulps (as test_generate_backplanes_fused_matches_jax_mixed)
    bound = 1e-4 + 2 * np.spacing(np.abs(want[on_disc]).astype(np.float32))
    assert np.all(np.abs(got[on_disc] - want[on_disc]) <= bound)
    np.testing.assert_allclose(
        got[on_disc], np.mod(signed[on_disc], 360.0), rtol=0, atol=1e-12
    )


def test_pack_scene_from_numpy_and_tensors(bodies):
    """One frame packed from the body's host values: float64 and finite,
    the same words over its own shared part and through the kernel's
    cache; a solar_lon_e outside [-pi, pi] is refused."""
    _, t_body = bodies
    xy2angular, disc, radii, anchors = t_pipeline.pipeline_inputs(t_body)
    scenes = backplanes_kernel.pack_scenes(xy2angular[None], disc[None],
                                           radii, anchors)
    assert scenes.dtype == np.float64
    assert scenes.shape == (1, backplanes_kernel.SCENE_SIZE)
    assert np.isfinite(scenes).all()
    np.testing.assert_array_equal(
        backplanes_kernel.pack_scenes(xy2angular[None], disc[None], radii,
                                      anchors, shared=scenes[0]), scenes)
    np.testing.assert_array_equal(
        backplanes_kernel._scenes(xy2angular[None], disc[None], radii,
                                  anchors), scenes)
    bad = dict(anchors, solar_lon_e=np.float64(4.0))
    with pytest.raises(ValueError, match='solar_lon_e'):
        backplanes_kernel.pack_scenes(xy2angular[None], disc[None], radii,
                                      bad)


# ---------------------------------------------------------------------------
# The batch entry: N disc sets over one body's anchors
# ---------------------------------------------------------------------------

BATCH_NX, BATCH_NY = 48, 40


@pytest.fixture(scope='module')
def batch_bodies(bodies):
    """(JAX BodyXY, port BodyXY) of 48x40 and three seeded disc sets with
    their xy2angular matrices (the bodies keep their first disc)."""
    j_body = jpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=BATCH_NX,
                        ny=BATCH_NY)
    t_body = tpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=BATCH_NX,
                        ny=BATCH_NY, device='cpu')
    rng = np.random.default_rng(7)
    discs = np.stack([
        23.5 + rng.uniform(-2.0, 2.0, 3), 19.5 + rng.uniform(-2.0, 2.0, 3),
        14.0 + rng.uniform(-1.0, 1.0, 3), rng.uniform(0.0, 360.0, 3),
    ], axis=1)
    xys = []
    for disc in discs:
        t_body.set_disc_params(*disc)
        xys.append(np.array(t_body._get_xy2angular_matrix()))
    for body in (j_body, t_body):
        body.set_disc_params(*discs[0])
    return j_body, t_body, np.array(xys), discs


def test_compute_backplanes_batch_matches_jax_and_single_calls(batch_bodies):
    j_body, t_body, xys, discs = batch_bodies
    got = t_pipeline.compute_backplanes_batch(t_body, xys, discs)
    assert set(got) == set(backplanes_kernel.PLANE_ORDER)
    assert all(v.shape == (3, BATCH_NY, BATCH_NX) for v in got.values())
    # both packages' float64 graphs, at the float64 parity bars of
    # assert_f64_parity (the JAX mixed graph's float32 chains would only
    # bound the comparison by their own rounding)
    for body in (j_body, t_body):
        body._pipeline_precision = 'double'
    try:
        ref = j_pipeline.compute_backplanes_batch(j_body, xys, discs)
        double = t_pipeline.compute_backplanes_batch(t_body, xys, discs)
    finally:
        for body in (j_body, t_body):
            del body._pipeline_precision
    assert '__CHECKSUM__' not in ref and set(ref) == set(got)
    for i, disc in enumerate(discs):
        assert_f64_parity({k: v[i] for k, v in double.items()},
                          {k: np.asarray(v)[i] for k, v in ref.items()},
                          disc, own_anchors=True)
        t_body.set_disc_params(*disc)
        single = t_pipeline.compute_backplanes(t_body)
        for name, plane in single.items():
            np.testing.assert_array_equal(got[name][i], plane, err_msg=name)
    t_body.set_disc_params(*discs[0])
    on_device = t_pipeline.compute_backplanes_batch(t_body, xys, discs,
                                                    as_numpy=False)
    assert isinstance(on_device['EMISSION'], torch.Tensor)
    with pytest.raises(ValueError, match=r'\(N, 4\)'):
        t_pipeline.compute_backplanes_batch(t_body, xys, discs[:2])


def test_pack_scenes_equals_pack_scene_word_for_word(batch_bodies):
    """Packing over a shared part packed earlier (from another frame) equals
    packing both parts word for word, with shared anchors and with each
    frame's own; each frame of a batch equals the frame packed alone."""
    _, t_body, xys, discs = batch_bodies
    _, _, radii, anchors = t_pipeline.pipeline_inputs(t_body)
    scenes = backplanes_kernel.pack_scenes(xys, discs, radii, anchors)
    assert scenes.shape == (3, backplanes_kernel.SCENE_SIZE)
    shared = backplanes_kernel.pack_scenes(xys[2:], discs[2:], radii,
                                           anchors)[0]
    np.testing.assert_array_equal(
        backplanes_kernel.pack_scenes(xys, discs, radii, anchors,
                                      shared=shared), scenes)
    for i in range(3):
        np.testing.assert_array_equal(
            scenes[i], backplanes_kernel.pack_scenes(
                xys[i:i + 1], discs[i:i + 1], radii, anchors)[0])
    # per-frame anchors (a time series): each frame its own
    from planetmapper_tpu_torch.parallel import timeseries

    ets = t_body.et + 3600.0 * np.arange(3)
    series, series_xys = timeseries._batched_pipeline_inputs(t_body, ets)
    per_frame = backplanes_kernel.pack_scenes(series_xys, discs, radii,
                                              series)
    for i in range(3):
        own = {k: v[i] for k, v in series.items()}
        alone = backplanes_kernel.pack_scenes(
            series_xys[i:i + 1], discs[i:i + 1], radii, own)
        np.testing.assert_array_equal(per_frame[i], alone[0])
        other = backplanes_kernel.pack_scenes(
            series_xys[i - 1:i] if i else series_xys[1:2],
            discs[i - 1:i] if i else discs[1:2], radii, own)[0]
        np.testing.assert_array_equal(
            backplanes_kernel.pack_scenes(series_xys[i:i + 1],
                                          discs[i:i + 1], radii, own,
                                          shared=other), alone)
    with pytest.raises(ValueError, match='rot0'):
        backplanes_kernel.pack_scenes(
            xys, discs, radii, dict(anchors, rot0=np.zeros((2, 3, 3))))


def test_batch_wrapper_runs_plain_version_on_cpu(batch_bodies):
    """On the CPU ``frames`` of N frames equals each frame alone word for
    word, with shared anchors and with a time series' own; the kernel's
    ``frames`` refuses the CPU."""
    _, t_body, xys, discs = batch_bodies
    _, _, radii, anchors = t_pipeline.pipeline_inputs(t_body)
    backplanes_kernel.reset_launch_count()
    backplanes_kernel.reset_batch_launch_count()
    impl, use_pallas = t_pipeline.select_pipeline_impl(t_body, BATCH_NX,
                                                       BATCH_NY)
    assert not use_pallas
    from planetmapper_tpu_torch.parallel import timeseries

    series, series_xys = timeseries._batched_pipeline_inputs(
        t_body, t_body.et + 3600.0 * np.arange(3))
    for affines, values in ((xys, anchors), (series_xys, series)):
        got = impl.frames(BATCH_NX, BATCH_NY, affines, discs, radii, values,
                          device='cpu')
        assert all(v.shape == (3, BATCH_NY, BATCH_NX) for v in got.values())
        for i in range(3):
            own = {k: v[i] if np.ndim(v) > np.ndim(anchors[k]) else v
                   for k, v in values.items()}
            single = impl.frames(BATCH_NX, BATCH_NY, affines[i:i + 1],
                                 discs[i:i + 1], radii, own, device='cpu')
            for name, plane in single.items():
                torch.testing.assert_close(got[name][i], plane[0], rtol=0,
                                           atol=0, equal_nan=True)
    assert backplanes_kernel.launch_count() == 0
    assert backplanes_kernel.batch_launch_count() == 0
    wrapper = backplanes_kernel.build_backplanes_kernel(
        positive_west=True, prograde=True, have_sun=True,
        optimize_speed=True, lst_quant=True,
        planes=('EMISSION', 'RADIAL-VELOCITY', 'RA'),
    )
    with pytest.raises(ValueError, match='no backplane kernel'):
        wrapper.frames(BATCH_NX, BATCH_NY, xys, discs, radii, anchors,
                       device='cpu')


def test_shared_scene_is_packed_again_for_other_radii(batch_bodies,
                                                      monkeypatch):
    """The kernel keeps its last scene: a call on the same anchors and
    radii packs only its frame parts (none for the lone frame packed last),
    and one whose radii (a raised surface) or anchors differ packs them
    whole; a time series' per-frame anchors are never kept."""
    from planetmapper_tpu_torch.body import _AdjustedSurfaceAltitude
    from planetmapper_tpu_torch.parallel import timeseries

    _, t_body, xys, discs = batch_bodies
    calls = []
    pack = backplanes_kernel.pack_scenes

    def spy(*args, shared=None):
        calls.append('frame parts' if shared is not None else 'whole')
        return pack(*args, shared=shared)

    monkeypatch.setattr(backplanes_kernel, 'pack_scenes', spy)
    monkeypatch.setattr(backplanes_kernel, '_last_packed', None)
    scenes = backplanes_kernel._scenes
    _, _, radii, anchors = t_pipeline.pipeline_inputs(t_body)
    first = scenes(xys, discs, radii, anchors)
    np.testing.assert_array_equal(
        scenes(xys[1:], discs[1:], radii, anchors), first[1:])
    lone = scenes(xys[:1], discs[:1], radii, anchors)
    assert scenes(xys[:1], discs[:1], radii, anchors) is lone
    np.testing.assert_array_equal(lone, first[:1])
    assert calls == ['whole', 'frame parts', 'frame parts']
    with _AdjustedSurfaceAltitude(t_body, alt=100.0):
        raised_radii = t_pipeline.pipeline_inputs(t_body)[2]
    np.testing.assert_array_equal(raised_radii, radii + 100.0)
    raised = scenes(xys, discs, raised_radii, anchors)
    np.testing.assert_array_equal(
        raised, pack(xys, discs, raised_radii, anchors))
    assert not np.array_equal(raised, first)
    np.testing.assert_array_equal(scenes(xys, discs, radii, anchors), first)
    np.testing.assert_array_equal(
        scenes(xys, discs, radii, dict(anchors)), first)
    assert calls[3:] == ['whole'] * 3
    kept = backplanes_kernel._last_packed
    series, series_xys = timeseries._batched_pipeline_inputs(
        t_body, t_body.et + 3600.0 * np.arange(3))
    np.testing.assert_array_equal(
        scenes(series_xys, discs, radii, series),
        pack(series_xys, discs, radii, series))
    assert backplanes_kernel._last_packed is kept


def _plan_pixels(n, nx, ny, plan):
    """Each launch's pixels as the batched kernel maps its blocks (the
    tiles' or the linear blocks'), as (launch, flat indices into the
    (N, ny, nx) batch, per block and thread; -1 where masked)."""
    size = nx * ny
    for first, count in plan.launches:
        if plan.tiles:
            tx, ty = backplanes_kernel.TILE
            assert plan.blocks_per_frame == -(-nx // tx) * -(-ny // ty)
            assert count <= backplanes_kernel.BLOCK_SCENES
            col = (np.arange(-(-nx // tx))[:, None] * tx
                   + np.arange(tx))[None, :, None, :]
            row = (np.arange(-(-ny // ty))[:, None] * ty
                   + np.arange(ty))[:, None, :, None]
            frame = first + np.arange(count)[:, None, None, None, None]
            live = (col < nx) & (row < ny)
            pix = np.where(live, frame * size + row * nx + col, -1)
            yield first, count, pix.reshape(count * plan.blocks_per_frame,
                                            -1)
        else:
            assert count * plan.blocks_per_frame <= \
                backplanes_kernel.MAX_GRID_X
            block = np.arange(count * plan.blocks_per_frame)
            local = block // plan.blocks_per_frame
            p0 = (block - local * plan.blocks_per_frame) * plan.threads
            p1 = np.minimum(p0 + plan.threads, size)
            pix = p0[:, None] + np.arange(plan.threads)
            # a frame's blocks are full but its last, whose live lanes lead
            yield first, count, np.where(
                pix < p1[:, None], (first + local)[:, None] * size + pix, -1)


@pytest.mark.parametrize('n, nx, ny, per_launch', [
    (1, 50, 50, None), (77, 50, 50, None), (78, 50, 50, None),
    (1000, 50, 50, None), (1000, 50, 50, 77), (78, 50, 50, 77),
    (65535 + 40, 5, 3, None), (65535 + 40, 32, 8, None), (3, 101, 67, None),
    (80, 128, 128, None),
    (2, 1, 300, None), (4, 7, 1, None), (8, 256, 256, None),
    (8, 300, 300, None), (3, 1000, 700, 1), (2, 2048, 2048, None),
])
def test_batched_launch_plan_covers_every_pixel_once(n, nx, ny, per_launch):
    """
    The batched kernel's launch plan, with its block-to-pixel maps
    transcribed: every (frame, row, column) once, the ragged blocks masked,
    launches cut at ``per_launch`` frames (77: the constant-bank
    candidate's chunk) and at the launches' limits (38 frames a tiled
    launch, their scenes in its parameters; 65535 + 40 frames of linear
    blocks in one launch), the layout by the tiles' lane fill.
    """
    plan = backplanes_kernel.batch_plan(n, nx, ny, per_launch)
    size = nx * ny
    fill = size / (-(-nx // 32) * 32 * -(-ny // 8) * 8)
    assert plan.tiles == (fill >= backplanes_kernel.TILE_FILL
                          and size >= backplanes_kernel.TILE_PIXELS)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= \
        backplanes_kernel.BATCH_THREADS
    assert plan.tiles or plan.threads == backplanes_kernel.BATCH_THREADS \
        or plan.threads >= size
    launches = plan.launches
    assert [first for first, _ in launches] == list(
        range(0, n, launches[0][1]))
    assert sum(count for _, count in launches) == n
    if per_launch:
        assert all(count <= per_launch for _, count in launches)
    seen = np.zeros(n * size, dtype=np.int64)
    for first, count, pix in _plan_pixels(n, nx, ny, plan):
        assert pix.shape == (count * plan.blocks_per_frame, plan.threads)
        np.add.at(seen, pix[pix >= 0], 1)
    assert np.all(seen == 1)


@pytest.mark.parametrize('size, route, tiles', [
    (50, False, False), (64, False, False), (100, False, False),
    (128, False, True), (130, False, False), (200, False, True),
    (256, False, True), (640, False, True), (768, True, True),
    (1024, True, True), (2048, True, True),
])
def test_batch_route_and_layout_by_frame_size(size, route, tiles):
    """Frames of FRAME_LAUNCH_PIXELS or more take one single-frame launch
    each; smaller ones the batched kernel, in tiles where they fill the
    lanes."""
    assert backplanes_kernel.frame_route(size, size) == route
    assert backplanes_kernel.batch_plan(8, size, size).tiles == tiles


def test_select_pipeline_impl_takes_the_jax_keywords(batch_bodies):
    """use_pallas forces the kernel (off CUDA it raises); interpret takes
    the plain graph at the kernel's conventions on any device."""
    _, t_body, _, _ = batch_bodies
    with pytest.raises(ValueError, match='CUDA device'):
        t_pipeline.select_pipeline_impl(t_body, 16, 16, use_pallas=True)
    impl, use_pallas = t_pipeline.select_pipeline_impl(
        t_body, BATCH_NX, BATCH_NY, use_pallas=True, interpret=True)
    assert not use_pallas and callable(impl)  # the plain graph's own call
    t_body._pipeline_precision = 'double'
    try:
        _, use_pallas = t_pipeline.select_pipeline_impl(
            t_body, BATCH_NX, BATCH_NY, interpret=True)
        lon = impl(BATCH_NX, BATCH_NY, *(
            f64(v) for v in t_pipeline.pipeline_inputs(t_body)[:3]),
            t_pipeline.anchors_from_numpy(
                t_body._get_pipeline_anchors(), 'cpu'))['LON-CENTRIC']
    finally:
        del t_body._pipeline_precision
    assert not use_pallas
    finite = lon[torch.isfinite(lon)]
    assert bool(((finite >= 0.0) & (finite < 360.0)).all())


# ---------------------------------------------------------------------------
# The copy to numpy: page-locked host slots (the page-locked allocation
# swapped for an ordinary host tensor)
# ---------------------------------------------------------------------------

@pytest.fixture
def slots(monkeypatch):
    """A fresh pool whose slots are ordinary host tensors; yields a function
    giving the slot counters' growth since the fixture began."""
    monkeypatch.setattr(host_slots, '_pin',
                        lambda n: torch.empty(n, dtype=torch.uint8))
    monkeypatch.setattr(host_slots, 'SLOTS', host_slots.HostSlots())
    names = ('pipeline.copy_slot_hits', 'pipeline.copy_slot_misses')
    start = tracing.counts()

    def grown():
        now = tracing.counts()
        return tuple(now.get(n, 0) - start.get(n, 0) for n in names)

    return grown


def _kernel_planes(ny, nx, seed, planes=None):
    """Planes laid out as kernel 1 returns them: the requested float32
    planes views of one stack, RADIAL-VELOCITY a float64 tensor of its own,
    in PLANE_ORDER."""
    order = backplanes_kernel.PLANE_ORDER
    requested = order if planes is None else [n for n in order if n in planes]
    gen = torch.Generator().manual_seed(seed)
    f32 = [n for n in requested if n != 'RADIAL-VELOCITY']
    out = dict(zip(f32, torch.randn((len(f32), ny, nx), generator=gen)))
    if 'RADIAL-VELOCITY' in requested:
        out['RADIAL-VELOCITY'] = torch.randn((ny, nx), generator=gen,
                                             dtype=torch.float64)
    return {n: out[n] for n in requested}


def _in_slot(arrays, slot):
    """Whether every array lies in the slot's memory."""
    start = slot.array.ctypes.data
    return all(start <= a.ctypes.data < start + slot.nbytes
               for a in arrays.values())


def _lease_of(array):
    """The object at the end of an array's chain of bases."""
    while isinstance(array, np.ndarray):
        array = array.base
    return array


def _assert_same_copy(got, ref):
    assert list(got) == list(ref)
    for name, plane in ref.items():
        assert got[name].dtype == plane.dtype, name
        assert got[name].shape == plane.shape, name
        np.testing.assert_array_equal(got[name], plane, err_msg=name)


@pytest.mark.parametrize('planes, n_copies', [
    (None, 2), (('EMISSION', 'RADIAL-VELOCITY', 'LON-GRAPHIC'), 2),
    (('RADIAL-VELOCITY',), 1), (('RING-RADIUS',), 1),
])
def test_slot_copy_equals_the_fresh_copy(slots, planes, n_copies):
    """One copy per device allocation; the same keys, order, dtypes, shapes
    and values as one ``.cpu()`` a plane, for all 26 planes and subsets."""
    kernel = _kernel_planes(NY, NX, 0, planes)
    copies, _, n_bytes = t_pipeline._slot_plan(kernel)
    assert len(copies) == n_copies
    assert n_bytes >= sum(v.nbytes for v in kernel.values())
    got = t_pipeline._to_host_slot(kernel)
    assert all(isinstance(_lease_of(v), host_slots.Lease)
               for v in got.values())
    _assert_same_copy(got, t_pipeline._to_numpy(kernel))
    assert slots() == (1, 0)


def test_slot_copy_of_the_plain_graph_equals_the_fresh_copy(bodies, slots):
    """The plain graph's planes (separate float64 tensors, PIXEL-X a
    broadcast view): one copy a plane, the same arrays."""
    _, t_body = bodies
    out = t_pipeline.compute_backplanes(t_body, as_numpy=False)
    assert len(t_pipeline._slot_plan(out)[0]) == len(out)
    _assert_same_copy(t_pipeline._to_host_slot(out),
                      t_pipeline._to_numpy(out))


def test_slot_is_reused_only_after_every_array_from_it_is_gone(slots):
    first = t_pipeline._to_host_slot(_kernel_planes(NY, NX, 1))
    second = t_pipeline._to_host_slot(_kernel_planes(NY, NX, 2))
    slot_a, slot_b = host_slots.SLOTS.slots
    assert _in_slot(first, slot_a) and _in_slot(second, slot_b)
    # a view of one plane keeps the whole slot
    kept = first['EMISSION'][2:5, ::3]
    kept_values = kept.copy()
    del first
    third = t_pipeline._to_host_slot(_kernel_planes(NY, NX, 3))
    assert not _in_slot(third, slot_a)
    np.testing.assert_array_equal(kept, kept_values)
    del kept, second
    fourth = t_pipeline._to_host_slot(_kernel_planes(NY, NX, 4))
    assert host_slots.SLOTS.slots == [slot_a, slot_b]
    assert _in_slot(fourth, slot_a)
    _assert_same_copy(fourth, t_pipeline._to_numpy(_kernel_planes(NY, NX, 4)))
    assert slots() == (3, 1)


def test_both_slots_held_falls_back_and_counts_it(slots):
    held = [t_pipeline._to_host_slot(_kernel_planes(NY, NX, i))
            for i in range(3)]
    assert slots() == (2, 1)
    assert len(host_slots.SLOTS.slots) == 2
    # the fallback's arrays are its own, and the held ones are unchanged
    assert not any(_in_slot(held[2], s) for s in host_slots.SLOTS.slots)
    for i, planes in enumerate(held):
        _assert_same_copy(planes,
                          t_pipeline._to_numpy(_kernel_planes(NY, NX, i)))
    # threads asking at once get at most the two slots
    del held
    leases = []
    threads = [threading.Thread(
        target=lambda: leases.append(host_slots.SLOTS.take(64)))
        for _ in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert sum(lease is not None for lease in leases) == 2
    assert len(host_slots.SLOTS.slots) == 2


def test_a_new_size_drops_the_free_slots_of_the_old(slots):
    small = t_pipeline._to_host_slot(_kernel_planes(NY, NX, 0))
    t_pipeline._to_host_slot(_kernel_planes(NY, NX, 1))  # dropped at once
    old = host_slots.SLOTS.slots[0].nbytes
    large = t_pipeline._to_host_slot(_kernel_planes(2 * NY, NX, 2))
    new = host_slots.SLOTS.slots[1].nbytes
    # the held slot of the old size stays until its arrays are gone
    assert [s.nbytes for s in host_slots.SLOTS.slots] == [old, new]
    del small
    t_pipeline._to_host_slot(_kernel_planes(2 * NY, NX, 3))
    assert [s.nbytes for s in host_slots.SLOTS.slots] == [new, new]
    _assert_same_copy(large,
                      t_pipeline._to_numpy(_kernel_planes(2 * NY, NX, 2)))
    assert slots() == (4, 0)


def test_cpu_bodies_and_the_batch_keep_the_fresh_copy(bodies, batch_bodies,
                                                      slots, monkeypatch):
    """Planes on the host and the batch entry never reach a slot."""
    def refuse(planes):
        raise AssertionError('copied into a slot')

    monkeypatch.setattr(t_pipeline, '_to_host_slot', refuse)
    _, t_body = bodies
    _, b_body, xys, discs = batch_bodies
    for out in (t_pipeline.compute_backplanes(t_body),
                t_body.generate_backplanes_fused(),
                t_pipeline.compute_backplanes_batch(b_body, xys, discs)):
        assert not any(isinstance(_lease_of(v), host_slots.Lease)
                       for v in out.values())
    assert host_slots.SLOTS.slots == [] and slots() == (0, 0)


# ---------------------------------------------------------------------------
# The upload ring of map_img (its chunks ordinary host tensors, its events
# stand-ins that end when waited on)
# ---------------------------------------------------------------------------

CHUNK = host_slots.CHUNK_BYTES
RING = host_slots.RING_CHUNKS * CHUNK


@pytest.mark.parametrize('n_bytes', [
    0, 1, CHUNK - 1, CHUNK, CHUNK + 1, RING, 2 * RING, 3 * CHUNK + 12345])
def test_chunk_plan_covers_every_byte_once_in_order(n_bytes):
    plan = host_slots.chunk_plan(n_bytes)
    assert [a for a, _ in plan] == list(range(0, n_bytes, CHUNK))
    assert all(b - a == CHUNK for a, b in plan[:-1])
    assert all(0 < b - a <= CHUNK for a, b in plan)
    covered = np.zeros(n_bytes, dtype=int)
    for a, b in plan:
        covered[a:b] += 1
    assert np.all(covered == 1)


_BIG = (1024, 1024)  # 4 MiB of float32


@pytest.mark.parametrize('make, staged', [
    (lambda: np.ones(_BIG, np.float32), True),
    (lambda: torch.ones(_BIG), True),  # a CPU tensor takes the same route
    (lambda: np.ones(host_slots.MIN_STAGED_BYTES, np.uint8), True),
    (lambda: np.ones(host_slots.MIN_STAGED_BYTES - 1, np.uint8), False),
    (lambda: np.ones(_BIG, np.float32)[:, ::2], False),  # not contiguous
    (lambda: np.asfortranarray(np.ones(_BIG, np.float32)), False),
    (lambda: np.ones(_BIG, np.float32)[::-1], False),  # negative strides
    (lambda: np.ones(_BIG, '>f4'), False),  # a byte order torch lacks
    (lambda: torch.ones(_BIG).t(), False),
    (lambda: torch.ones(_BIG, device='meta'), False),  # not on the host
])
def test_upload_route_follows_the_input(make, staged):
    img = make()
    src = host_slots._staged_source(img, torch.device('cuda'))
    assert (src is not None) == staged
    if staged:
        assert src.data_ptr() == (img.data_ptr() if torch.is_tensor(img)
                                  else img.ctypes.data)
    assert host_slots._staged_source(img, torch.device('cpu')) is None


class _Event:
    """A copy's stand-in event: it ends when waited on."""

    def __init__(self, log):
        self.done = False
        log.append(self)

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.fixture
def ring(monkeypatch):
    """A ring of 3 chunks of 64 B, ordinary host tensors; yields the ring
    and the events its copies recorded."""
    events = []
    stream = SimpleNamespace(record_event=lambda: _Event(events))
    monkeypatch.setattr(torch.cuda, 'current_stream', lambda device: stream)
    pins = []
    monkeypatch.setattr(host_slots, '_pin', lambda n: pins.append(n) or
                        torch.empty(n, dtype=torch.uint8))
    ring = host_slots.UploadRing(3, 64)
    ring.pins, ring.events = pins, events
    tracing.reset('map.upload_waits')
    return ring


@pytest.mark.parametrize('n_bytes, waits', [
    (63, 0), (64, 0), (192, 0), (5 * 64 + 7, 3)])
def test_ring_copies_every_byte_and_waits_on_reuse(ring, n_bytes, waits):
    """The bytes through a ring of 192 B; a chunk used again in one call
    waits for its last copy. Events of another call have ended (a caller's
    synchronise): no wait."""
    assert ring.ready()
    for seed in (0, 1):
        src = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8,
                            generator=torch.Generator().manual_seed(seed))
        dst = torch.zeros(n_bytes, dtype=torch.uint8)
        ring.copy(src, dst)
        assert torch.equal(dst, src)
        assert len(ring.events) == len(host_slots.chunk_plan(n_bytes, 64))
        for event in ring.events:
            event.done = True
        ring.events.clear()
    assert tracing.counts().get('map.upload_waits', 0) == 2 * waits
    assert ring.pins == [64] * 3


def test_ring_waits_on_a_copy_still_running(ring):
    ring.ready()
    src = torch.arange(64, dtype=torch.uint8)
    ring.copy(src, torch.zeros(64, dtype=torch.uint8))
    (first,) = ring.events
    assert not first.done
    ring.copy(src, torch.zeros(64, dtype=torch.uint8))
    assert first.done
    assert tracing.counts()['map.upload_waits'] == 1


def test_ring_is_pinned_once_and_a_failure_is_not_ready(ring, monkeypatch):
    assert ring.ready() and ring.ready()
    assert ring.pins == [64] * 3

    def refuse(n):
        raise RuntimeError('cudaHostRegister failed')

    monkeypatch.setattr(host_slots, '_pin', refuse)
    assert not host_slots.UploadRing(3, 64).ready()


def test_upload_to_the_host_is_the_plain_copy_counted():
    names = ('map.upload_staged', 'map.upload_plain', 'map.upload_bytes')
    tracing.reset(*names)
    img = np.ones(_BIG, np.float32)
    out = host_slots.upload(img, torch.device('cpu'))
    assert out.data_ptr() == img.ctypes.data
    tensor = torch.ones(3, 5, dtype=torch.float64)
    assert host_slots.upload(tensor, torch.device('cpu')) is tensor
    counts = tracing.counts()
    assert [counts.get(n, 0) for n in names] == [0, 2, img.nbytes + 120]


@pytest.mark.parametrize('frames', [1, 3, 1000])
def test_backplane_batch_bound_counts_every_frame(frames):
    rng = np.random.default_rng(frames)
    n_discs = rng.integers(0, 50 * 50, frames)
    got = bounds.backplane_batch_bound(50, 50, n_discs)
    singles = [bounds.backplane_bound(50, 50, int(n)) for n in n_discs]
    assert got['frames'] == frames
    assert got['f64_ops'] == sum(s['f64_ops'] for s in singles)
    assert got['f32_ops'] == sum(s['f32_ops'] for s in singles)
    assert got['bytes'] == sum(s['bytes'] for s in singles) + 848 * frames
    assert (got['ms'], got['bound_by']) == bounds.roofline_ms(
        got['bytes'], got['f64_ops'], got['f32_ops'])
    with pytest.raises(ValueError):
        bounds.backplane_batch_bound(50, 50, [])


@pytest.mark.parametrize('nx, ny, n_disc', [
    (2048, 2048, 1_970_000), (1000, 700, 0), (64, 48, 957),
])
def test_backplane_bound_counts_the_function(nx, ny, n_disc):
    ops = bounds.backplane_ops()
    # pinned: every pixel 379 FP64 + 113 FP32 operations, an on-disc pixel
    # 694 + 127 more (3 intercept evaluations), each column 82 and each row
    # 84 FP64 (the ray's sin/cos tables), at 20 per transcendental
    assert ops == {'every': (379, 113), 'on_disc': (694, 127),
                   'column': (82, 0), 'row': (84, 0)}
    got = bounds.backplane_bound(nx, ny, n_disc)
    assert got['f64_ops'] == 379 * nx * ny + 694 * n_disc + 82 * nx + 84 * ny
    assert got['f32_ops'] == 113 * nx * ny + 127 * n_disc
    assert got['bytes'] == 108 * nx * ny
    t_ops = got['f64_ops'] / 34e12 + got['f32_ops'] / 67e12
    t_bytes = got['bytes'] / 3.35e12
    assert got['ms'] == pytest.approx(max(t_ops, t_bytes) * 1e3, rel=1e-12)
    assert got['bound_by'] == ('operations' if t_ops > t_bytes else 'bytes')
    one_more_iter = bounds.backplane_bound(nx, ny, n_disc, n_lt_iters=3)
    assert one_more_iter['f64_ops'] == got['f64_ops'] + 112 * n_disc
    with pytest.raises(ValueError):
        bounds.backplane_bound(nx, ny, nx * ny + 1)
    # the dsk test kernels' block of 8192 values: 6 float32 words a value
    # for a pair op, 10 FP32 operations a ds product
    assert bounds.dsk_call_bound('mul', 8192) == dict(
        ms=4 * 6 * 8192 / 3.35e12 * 1e3, bound_by='bytes',
        bytes=4 * 6 * 8192, f32_ops=10 * 8192)


#: The 720x1440 map of chip_smoke.py and its three timed map_spline calls:
#: (source side, kx = ky, frames), about half the samples on the disc
MAP_SAMPLES = 720 * 1440


@pytest.mark.parametrize('n, k, frames', [
    (150, 1, 1), (150, 3, 1), (1024, 3, 1), (150, 3, 16), (150, 5, 1),
])
def test_map_bounds_count_the_function(n, k, frames):
    valid = MAP_SAMPLES // 2
    live = valid - 1000
    disc = 4 * n * n // 5  # the coefficients and cells under the disc
    kw = dict(samples=MAP_SAMPLES, valid_samples=valid, live_samples=live,
              live_sample_frames=live * frames, frames=frames,
              coefficients=frames * disc, grid_cells=disc,
              knots=2 * (n + k + 1), kx=k, ky=k)
    got = bounds.map_spline_bound(**kw)
    # pinned: per live sample and axis the cardinal basis in Horner form
    # and 6 operations around it; per live sample and frame the sum
    assert bounds.map_spline_axis_ops(1) == 10
    assert bounds.map_spline_axis_ops(3) == 30
    assert bounds.map_spline_frame_ops(1, 1) == 12
    assert bounds.map_spline_frame_ops(3, 1) == 20
    assert bounds.map_spline_frame_ops(1, 3) == 24
    # 1 B of validity per sample, x and y of the valid ones, every value
    # out, a flag per frame, the coefficients and cells read, the knots
    n_bytes = (MAP_SAMPLES + 16 * valid + 4 * frames * MAP_SAMPLES + frames
               + 8 * frames * disc + disc + 16 * (n + k + 1))
    ops = live * (2 * (6 + 2 * k * (k + 1)) + frames * 2 * (k + 1) * (k + 2))
    assert got['bytes'] == n_bytes and got['f64_ops'] == ops
    t_bytes, t_ops = n_bytes / 3.35e12, ops / 34e12
    assert got['ms'] == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert got['bound_by'] == ('bytes' if t_bytes >= t_ops else 'operations')
    if frames == 1 and k <= 3:  # chip_smoke's timed calls
        assert got['bound_by'] == 'bytes'
    # a sample that is not valid costs its validity and its values only
    fewer = bounds.map_spline_bound(**dict(kw, valid_samples=valid - 1))
    assert got['bytes'] - fewer['bytes'] == 16
    smooth = bounds.map_smooth_bound(
        samples=MAP_SAMPLES, valid_samples=valid, live_samples=live,
        live_sample_frames=live * frames, frames=frames,
        grid_values=frames * 611 * 641, image_cells=disc,
    )
    assert smooth['bytes'] == (MAP_SAMPLES + 16 * valid + 4 * frames
                               * MAP_SAMPLES + frames + 8 * frames * 611 * 641
                               + disc)
    assert smooth['f64_ops'] == live * (6 + 11 * frames)
    assert smooth['bound_by'] == 'bytes'


def _map_call(seed, n=12, frames=2, n_samples=60):
    """Samples over and around an n x n source, a NaN in frame 1 only."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, n + 1.0, n_samples)
    y = rng.uniform(-2.0, n + 1.0, n_samples)
    x[:10] = np.round(x[:10])  # on pixel centres: floor == ceil
    valid = rng.uniform(size=n_samples) < 0.8
    x[~valid] = y[~valid] = 0.0
    nan_grid = np.zeros((frames, n, n), dtype=bool)
    nan_grid[1, 5, 6] = True
    return x, y, valid, nan_grid


def _expected_reads(x, y, valid, nan_grid, propagate_nan, inside):
    """Brute force: the valid samples, each frame's live samples, and the
    NaN-grid cells the NaN rule reads."""
    frames, ny, nx = nan_grid.shape
    checked = valid & inside
    live = np.repeat(checked[None], frames, axis=0)
    cells = 0
    if propagate_nan:
        checked &= (x >= 0) & (y >= 0) & (x <= nx - 1) & (y <= ny - 1)
        near = set()
        for s in np.flatnonzero(checked):
            for r in {math.floor(y[s]), math.ceil(y[s])}:
                for c in {math.floor(x[s]), math.ceil(x[s])}:
                    near.add((r, c))
                    live[:, s] &= ~nan_grid[:, r, c]
            live[:, s] &= checked[s]
        live &= checked[None]
        cells = len(near) * int(nan_grid.reshape(frames, -1).any(1).sum())
    return int(valid.sum()), live, cells


@pytest.mark.parametrize('propagate_nan', [True, False])
@pytest.mark.parametrize('k', [1, 3])
def test_spline_call_bound_counts_what_is_read(k, propagate_nan):
    n = 12
    x, y, valid, nan_grid = _map_call(k, n, n_samples=40)
    t, _, _, _ = interp_device._grid_spline_solver(n, n, k, k)
    n_c = t.shape[0] - k - 1
    args = tuple(torch.from_numpy(a) for a in (
        x, y, valid, t, t, np.zeros((2, n_c, n_c)), nan_grid))
    got = bounds.spline_call_bound(
        args, dict(kx=k, ky=k, propagate_nan=propagate_nan))
    n_valid, live, cells = _expected_reads(
        x, y, valid, nan_grid, propagate_nan, np.ones_like(valid))

    def first(u):  # the first coefficient each sample weights
        u = np.clip(u, t[k], t[-k - 1])
        return np.clip(np.searchsorted(t, u, side='right') - 1, k,
                       n_c - 1) - k

    ix, iy = first(x), first(y)
    coefficients = sum(
        len({(iy[s] + a, ix[s] + b) for s in np.flatnonzero(live[f])
             for a in range(k + 1) for b in range(k + 1)})
        for f in range(2))
    want = bounds.map_spline_bound(
        samples=x.size, valid_samples=n_valid,
        live_samples=int(live.any(0).sum()),
        live_sample_frames=int(live.sum()), frames=2,
        coefficients=coefficients, grid_cells=cells, knots=2 * t.size,
        kx=k, ky=k)
    assert got == want
    assert 0 < coefficients < 2 * n_c * n_c
    assert (cells > 0) == propagate_nan


@pytest.mark.parametrize('propagate_nan', [True, False])
def test_smooth_call_bound_counts_what_is_read(propagate_nan):
    x, y, valid, nan_grid = _map_call(7)
    kw = dict(iy0=1.0, ix0=-1.0, y_step=0.5, x_step=0.5,
              propagate_nan=propagate_nan)
    n_ys, n_xs = 17, 23
    yb = (y - kw['iy0']) / kw['y_step']
    xb = (x - kw['ix0']) / kw['x_step']
    inside = (yb >= 0) & (yb <= n_ys - 1) & (xb >= 0) & (xb <= n_xs - 1)
    args = tuple(torch.from_numpy(a) for a in (
        x, y, valid, np.zeros((2, n_ys, n_xs)), nan_grid))
    got = bounds.smooth_call_bound(args, kw)
    n_valid, live, cells = _expected_reads(
        x, y, valid, nan_grid, propagate_nan, inside)
    iy = np.clip(np.floor(yb), 0, n_ys - 2).astype(int)
    ix = np.clip(np.floor(xb), 0, n_xs - 2).astype(int)
    values = sum(
        len({(iy[s] + a, ix[s] + b) for s in np.flatnonzero(live[f])
             for a in (0, 1) for b in (0, 1)})
        for f in range(2))
    want = bounds.map_smooth_bound(
        samples=x.size, valid_samples=n_valid,
        live_samples=int(live.any(0).sum()),
        live_sample_frames=int(live.sum()), frames=2, grid_values=values,
        image_cells=cells)
    assert got == want
    assert 0 < values < 2 * n_ys * n_xs


def _pass_counts(finite_lines, k):
    """Brute force, one PCHIP pass: (finite cells, evaluated positions,
    finite outputs per line) of lines given by their finiteness."""
    cells = evaluated = 0
    outputs = []
    for line in finite_lines:
        idx = np.flatnonzero(line)
        out = np.zeros((len(line) - 1) * k + 1, dtype=bool)
        if idx.size >= 2:
            cells += idx.size
            out[idx[0] * k:idx[-1] * k + 1] = True
            evaluated += (idx[-1] - idx[0]) * k + 1 - idx.size
        outputs.append(out)
    return cells, evaluated, np.array(outputs)


@pytest.mark.parametrize('ky, kx', [(1, 1), (5, 5), (2, 4), (3, 1)])
def test_pchip_call_bound_counts_the_function(ky, kx):
    rng = np.random.default_rng(ky * 10 + kx)
    box = rng.normal(size=(2, 9, 12))
    box[0, rng.uniform(size=(9, 12)) < 0.2] = np.nan
    box[0, 3] = np.nan        # an all-NaN row
    box[1, 5, 1:] = np.inf    # a row with one finite cell
    box[1, :, 7] = np.nan     # a NaN column
    got = bounds.pchip_call_bound(torch.from_numpy(box), ky, kx)
    cells = evaluated = 0
    for frame in np.isfinite(box):
        c, e, rows = _pass_counts(frame, kx)
        c2, e2, _ = _pass_counts(rows.T, ky)
        cells, evaluated = cells + c + c2, evaluated + e + e2
    n_grid = 2 * (8 * ky + 1) * (11 * kx + 1)
    # the box read once and the grid written once; per finite cell 24 and
    # per evaluated position 8 operations
    assert (bounds.PCHIP_CELL_OPS, bounds.PCHIP_POSITION_OPS) == (24, 8)
    assert got == bounds.pchip_bound(cells=box.size, grid_values=n_grid,
                                     finite_cells=cells, evaluated=evaluated)
    assert got['bytes'] == 8 * box.size + 8 * n_grid
    assert got['f64_ops'] == 24 * cells + 8 * evaluated
    assert got['bound_by'] == 'bytes' and 0 < evaluated


def test_smooth_stage_bound_counts_box_to_map():
    x, y, valid, nan_grid = _map_call(3)
    rng = np.random.default_rng(3)
    box = rng.normal(size=(2, 6, 8))
    box[1, 2, 3] = np.nan
    kw = dict(iy0=1.0, ix0=-1.0, y_step=0.5, x_step=0.5, propagate_nan=True)
    grid = np.zeros((2, 11, 15))
    args = tuple(torch.from_numpy(a) for a in (x, y, valid, grid, nan_grid))
    box_t = torch.from_numpy(box)
    got = bounds.smooth_stage_bound(box_t, 2, 2, args, kw)
    pchip = bounds.pchip_call_bound(box_t, 2, 2)
    sampler = bounds.smooth_call_bound(args, kw)
    # the sampler's bytes without the grid values it reads: the grids stay
    # on the chip, the box is read instead
    yb, xb = (y - 1.0) / 0.5, (x + 1.0) / 0.5
    inside = (yb >= 0) & (yb <= 10) & (xb >= 0) & (xb <= 14)
    _, _, cells = _expected_reads(x, y, valid, nan_grid, True, inside)
    assert got['bytes'] == (8 * box.size + x.size + 16 * int(valid.sum())
                            + 4 * 2 * x.size + 2 + cells)
    assert got['f64_ops'] == pchip['f64_ops'] + sampler['f64_ops']
    assert got['bound_by'] == 'bytes'
