"""
The port's ``Observation``, FITS and WCS I/O, photometry and ``utils``
against the JAX package, on the synthetic SPICE kernels (Jupiter from the
Earth on 2005-01-01).

Inputs come from a numpy seed: a 3-frame 48x64 cube (not square, so that
an nx/ny swap shows) holding a bright disc on noise with a NaN block,
written as FITS by the JAX package's ``io.fits`` under header variants
(plain ``OBJECT``/``DATE-OBS``, TAN and SIN WCS, a PLANMAP header from a
JAX ``save_observation``, the data in HDU 1, a 2D image with MJD dates, an
empty file) and as a PNG.

Bars:

- FITS: the two writers give the same bytes for the same HDUs, and each
  package reads the other's files to equal data and headers;
- WCS: pixel to world within 1e-12 deg, world to pixel within 1e-9 px;
- photometry: aperture sums within 1e-12 relative, centroids within 1e-12
  px;
- disc parameters within 1e-9 px or deg; ``fit_disc_position`` on float32
  data within 1e-5 px, the float32 rounding of the JAX package's moment
  sums (the port takes them in float64);
- backplane HDUs at the per-plane bars of ``tests/test_torch_backplanes.py``
  (``testing/compare.compare_per_plane``);
- mapped data at ``tests/test_torch_map.py``'s bars against the JAX CPU
  path (2e-5 of the largest value; 'nearest' equal);
- headers card by card except the ``PLANMAP DATE`` of the write: keywords,
  comments, strings and integers equal, disc cards within 1e-9 px or deg,
  angles within 1e-9 deg and other numbers within 1e-12 relative
  (``testing/compare.compare_headers``).
"""

from __future__ import annotations

import gc
import gzip
import os
import subprocess
import sys
import unittest.mock as mock
import weakref

import jax  # noqa: F401  (the JAX package under test runs on it)
import numpy as np
import pytest
import torch

import planetmapper_tpu as jpm
import planetmapper_tpu_torch as tpm
from planetmapper_tpu import utils as j_utils
from planetmapper_tpu.io import fits as j_fits
from planetmapper_tpu.io import wcs as j_wcs
from planetmapper_tpu.kernels import pool as j_pool
from planetmapper_tpu.ops import photometry as j_phot
from planetmapper_tpu_torch import utils as t_utils
from planetmapper_tpu_torch.io import fits as t_fits
from planetmapper_tpu_torch.io import wcs as t_wcs
from planetmapper_tpu_torch.kernels import pool as t_pool
from planetmapper_tpu_torch.ops import photometry as t_phot
from planetmapper_tpu_torch.testing import compare, observation_files
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    write_synthetic_kernels,
)

UTC = '2005-01-01T00:00:00'
NZ, NY, NX = 3, 48, 64
DISC = (30.3, 22.8, 15.2, 20.0)
MAP = dict(degree_interval=10)  # 18 x 36
ORTHO = dict(projection='orthographic', lon=30.0, lat=-10.0, size=21)
#: Bars (see the module docstring)
WCS_DEG = 1e-12
WCS_PX = 1e-9
PHOT_RELATIVE = 1e-12
CENTROID_PX = 1e-12
#: fit_disc_position on float32 data: the JAX package sums its moments in
#: float32 (a relative rounding of ~1e-7 on a 30 px centroid; 9e-7 px
#: measured on the 64x48 cube), the port in float64
F32_CENTROID_PX = 1e-5
DISC_BAR = 1e-9
MAP_BAR = 2e-5
HEADER_BARS = dict(angle=compare.F64_ANGLE, pixel=DISC_BAR, relative=1e-12)
#: The x/y map planes' bar of tests/test_torch_map.py
MAP_PIXEL_BAR = 2e-9
#: The planes saved at alt=500 km (in registry order)
ALT_PLANES = ['LAT-GRAPHIC', 'EMISSION', 'DISTANCE', 'LIMB-DISTANCE',
              'RING-RADIUS']


def _restore_kernel_path(pkg, previous):
    path, source = previous
    pkg.clear_kernels()
    pkg.set_kernel_path(path if source == 'set_kernel_path()' else None)


@pytest.fixture(scope='module')
def kernels(tmp_path_factory):
    """Both packages on the synthetic kernels; restored afterwards."""
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


def _cube(seed: int = 3) -> np.ndarray:
    """A bright disc on noise in each frame, and a NaN block in frame 1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:NY, 0:NX]
    disc = np.hypot(xx - DISC[0], (yy - DISC[1]) / 0.94) < DISC[2]
    cube = rng.normal(size=(NZ, NY, NX)) + 10.0 * disc * \
        np.arange(1, NZ + 1)[:, None, None]
    cube[1, 20:23, 40:44] = np.nan
    return cube


def _wcs_cards(projection: str) -> list[tuple[str, object]]:
    """A celestial WCS that puts the target at DISC, from a JAX BodyXY
    (``testing/observation_files.wcs_cards``)."""
    body = jpm.BodyXY('Jupiter', observer='EARTH', utc=UTC, nx=NX, ny=NY)
    body.set_disc_params(*DISC)
    return observation_files.wcs_cards(body, projection)


BASE_CARDS = [('OBJECT', 'JUPITER'), ('DATE-OBS', UTC),
              ('TELESCOP', 'ESO-VLT-U4')]
VARIANTS = ['plain', 'tan', 'sin', 'planmap', 'hdu1', 'mjd2d', 'png']


@pytest.fixture(scope='module')
def files(kernels, tmp_path_factory):
    """The input files, each written by the JAX package."""
    root = tmp_path_factory.mktemp('observations')
    cube = _cube()
    paths = {name: str(root / f'{name}.fits') for name in VARIANTS}

    def write(name, hdus):
        j_fits.HDUList(hdus).writeto(paths[name], overwrite=True)

    write('plain', [j_fits.PrimaryHDU(cube, j_fits.Header(BASE_CARDS))])
    for name, proj in (('tan', 'TAN'), ('sin', 'SIN')):
        header = j_fits.Header(BASE_CARDS + _wcs_cards(proj))
        write(name, [j_fits.PrimaryHDU(cube, header)])
    write('hdu1', [
        j_fits.PrimaryHDU(None, j_fits.Header(
            [('OBJECT', 'JUPITER'), ('TELESCOP', 'EARTH')])),
        j_fits.ImageHDU(cube, j_fits.Header([('DATE-OBS', UTC)]),
                        name='SCI'),
    ])
    mjd = 53371.0  # 2005-01-01T00:00 UTC
    write('mjd2d', [j_fits.PrimaryHDU(cube[0], j_fits.Header([
        ('OBJECT', 'JUPITER'), ('MJD-BEG', mjd - 0.01),
        ('MJD-END', mjd + 0.01)]))])
    paths['empty'] = str(root / 'empty.fits')
    j_fits.HDUList([j_fits.PrimaryHDU(None, j_fits.Header(BASE_CARDS))]) \
        .writeto(paths['empty'])
    # a navigated file from the JAX package: the PLANMAP header variant
    nav = jpm.Observation(paths['tan'])
    nav.set_disc_params(*DISC)
    nav.save_observation(paths['planmap'], include_wireframe=False,
                         backplanes_to_save=['EMISSION'], print_info=False)
    import PIL.Image

    paths['png'] = str(root / 'rgb.png')
    rgb = np.random.default_rng(5).integers(0, 255, (NY, NX, 3), np.uint8)
    PIL.Image.fromarray(rgb).save(paths['png'])
    return paths


def _kwargs(variant):
    return dict(target='JUPITER', utc=UTC) if variant == 'png' else {}


@pytest.fixture(scope='module')
def observations(files):
    """``{variant: (JAX Observation, port Observation)}``, on their
    initial discs."""
    return {
        v: (jpm.Observation(files[v], **_kwargs(v)),
            tpm.Observation(files[v], device='cpu', **_kwargs(v)))
        for v in VARIANTS
    }


@pytest.fixture(scope='module')
def navigated(observations):
    """The TAN observation in both packages at DISC."""
    j_obs, t_obs = observations['tan']
    j_nav, t_nav = j_obs.copy(), t_obs.copy()
    for obs in (j_nav, t_nav):
        obs.set_disc_params(*DISC)
    return j_nav, t_nav


def _assert_disc_close(got, ref):
    np.testing.assert_allclose(got.get_disc_params(), ref.get_disc_params(),
                               rtol=0, atol=DISC_BAR)
    assert got.get_disc_method() == ref.get_disc_method()


# ---------------------------------------------------------------------------
# FITS
# ---------------------------------------------------------------------------

def _hdus(module, dtype: str):
    rng = np.random.default_rng(11)
    cards = [('OBJECT', 'JUPITER'), ('EXPTIME', 12.5), ('NCOMBINE', 3),
             ('HIERARCH PLANMAP DISC X0', 30.25), ('FLAG', True),
             ('LONGSTR', 'x' * 100)]
    if dtype == 'int16 scaled':
        data = rng.integers(-300, 300, (NY, NX)).astype(np.int16)
        cards += [('BSCALE', 0.5), ('BZERO', 10.0)]
    elif dtype == 'uint16':
        data = rng.integers(0, 65535, (NZ, NY, NX)).astype(np.uint16)
    else:
        data = rng.normal(size=(NZ, NY, NX)).astype(dtype)
        data[0, 3, 4] = np.nan
    header = module.Header(cards)
    header.add_comment('a comment card')
    extension = module.ImageHDU(data[..., :7].copy(), module.Header(
        [('ABOUT', 'plane')]), name='PLANE')
    return module.HDUList([module.PrimaryHDU(data, header), extension])


@pytest.mark.parametrize('dtype', ['int16 scaled', 'uint16', 'float32',
                                   'float64'])
@pytest.mark.parametrize('suffix', ['.fits', '.fits.gz'])
def test_fits_bytes_equal_and_read_both_ways(tmp_path, dtype, suffix):
    paths = {}
    for name, module in (('jax', j_fits), ('port', t_fits)):
        paths[name] = str(tmp_path / f'{name}{suffix}')
        _hdus(module, dtype).writeto(paths[name])
    raw = {}
    for name, path in paths.items():
        opener = gzip.open if suffix.endswith('.gz') else open
        with opener(path, 'rb') as f:
            raw[name] = f.read()
    assert len(raw['port']) % 2880 == 0
    assert raw['port'] == raw['jax']
    for reader, writer in ((t_fits, 'jax'), (j_fits, 'port'),
                           (t_fits, 'port')):
        with reader.open(paths[writer], memmap=True) as got, \
                j_fits.open(paths['jax']) as ref:
            assert [h.name for h in got] == ['', 'PLANE']
            for g, r in zip(got, ref):
                assert g.data.dtype == r.data.dtype
                np.testing.assert_array_equal(g.data, r.data)
                assert list(g.header.items()) == list(r.header.items())
    if dtype == 'int16 scaled':
        with t_fits.open(paths['port']) as got:
            assert got[0].data.dtype == np.float64
            assert 'BSCALE' not in got[0].header


def test_header_cards_and_hierarch():
    for module in (j_fits, t_fits):
        header = module.Header()
        header['HIERARCH PLANMAP DISC METHOD'] = 'wcs'
        header.append(module.Card('DATE-OBS', UTC, 'a date'))
        header.remove('NOPE', ignore_missing=True)
    assert t_fits.Header.fromstring(header.tostring()).tostring() == \
        j_fits.Header.fromstring(header.tostring()).tostring()
    assert t_fits.Header.fromstring(header.tostring())[
        'PLANMAP DISC METHOD'] == 'wcs'


# ---------------------------------------------------------------------------
# WCS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('projection', ['TAN', 'SIN'])
def test_wcs_matches_jax(kernels, projection):
    header = dict(_wcs_cards(projection))
    got, ref = t_wcs.WCS(header).celestial, j_wcs.WCS(header).celestial
    assert got.naxis == ref.naxis == 2
    assert got.world_axis_units == ref.world_axis_units
    assert got.world_axis_physical_types == ref.world_axis_physical_types
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-5, NX + 5, 200), rng.uniform(-5, NY + 5, 200)
    world = got.pixel_to_world_values(x, y)
    for a, b in zip(world, ref.pixel_to_world_values(x, y)):
        np.testing.assert_allclose(a, b, rtol=0, atol=WCS_DEG)
    pixels = got.world_to_pixel_values(*world)
    for a, b in zip(pixels, ref.world_to_pixel_values(*world)):
        np.testing.assert_allclose(a, b, rtol=0, atol=WCS_PX)
    np.testing.assert_allclose(pixels[0], x, rtol=0, atol=WCS_PX)


# ---------------------------------------------------------------------------
# Photometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('centre', [(30.3, 22.8), (31.5, 23.5), (0.4, 46.9)])
def test_circular_aperture_sums_match_jax(centre, monkeypatch):
    img = np.nan_to_num(np.nansum(_cube(), axis=0))
    radii = np.arange(1.0, 24.0)
    ref_sums, ref_areas = j_phot.circular_aperture_sums(img, *centre, radii)
    for chunk in (t_phot.CHUNK_ELEMENTS, 700):  # one block; many
        monkeypatch.setattr(t_phot, 'CHUNK_ELEMENTS', chunk)
        sums, areas = t_phot.circular_aperture_sums(
            torch.from_numpy(img), *centre, radii)
        np.testing.assert_array_equal(areas, ref_areas)
        np.testing.assert_allclose(sums, ref_sums, rtol=PHOT_RELATIVE,
                                   atol=0)
    frac = t_phot.circular_aperture_fractions((NY, NX), *centre, 7.3)
    np.testing.assert_allclose(
        frac.numpy(), j_phot.circular_aperture_fractions((NY, NX), *centre,
                                                         7.3),
        rtol=0, atol=PHOT_RELATIVE * np.pi * 7.3**2)


def test_threshold_centroid_matches_jax():
    img = np.nan_to_num(np.nansum(_cube(), axis=0))
    got = t_phot.threshold_centroid(torch.from_numpy(img))
    ref = j_phot.threshold_centroid(img)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CENTROID_PX)


def test_threshold_centroid_above_the_quantile_limit():
    """4097x4096 values: more than torch.quantile's 2^24, which is why the
    port sorts once; the reference is numpy's linear percentile."""
    ny, nx = 4097, 4096
    img = np.zeros((ny, nx))
    img[1000:1700, 300:2500] = 1.0 + np.arange(2200) / 2200.0
    img[3000:3003, 100:4000] = 7.0
    img.reshape(-1)[:: 9973] = -1.0
    tensor = torch.from_numpy(img)
    with pytest.raises(RuntimeError):
        torch.quantile(tensor.reshape(-1), 0.05)
    got = t_phot.threshold_centroid(tensor)
    lo, hi = np.percentile(img, [5.0, 95.0])
    mask = img > 0.5 * (lo + hi)
    ys, xs = np.nonzero(mask)
    np.testing.assert_allclose(got, (xs.mean(), ys.mean()), rtol=0,
                               atol=CENTROID_PX)


# ---------------------------------------------------------------------------
# Observation: loading, header keywords and the initial disc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', VARIANTS)
def test_observation_loads_like_jax(observations, variant):
    j_obs, t_obs = observations[variant]
    assert isinstance(t_obs.data, np.ndarray)
    np.testing.assert_array_equal(t_obs.data, j_obs.data)
    assert t_obs.data.dtype == j_obs.data.dtype
    assert list(t_obs.header.items()) == list(j_obs.header.items())
    for attr in ('target', 'observer', 'utc', 'et', 'observer_frame',
                 'aberration_correction'):
        assert getattr(t_obs, attr) == getattr(j_obs, attr), attr
    assert t_obs.get_img_size() == j_obs.get_img_size() == (NX, NY)
    _assert_disc_close(t_obs, j_obs)
    assert t_obs.get_disc_method() == {
        'plain': 'centre_disc', 'tan': 'wcs', 'sin': 'wcs',
        'planmap': 'header', 'hdu1': 'centre_disc', 'mjd2d': 'centre_disc',
        'png': 'centre_disc'}[variant]
    assert t_obs.device == torch.device('cpu')


def test_observation_from_arrays_and_errors(kernels, files):
    data = _cube()
    j_obs = jpm.Observation(data=data, target='JUPITER', utc=UTC)
    t_obs = tpm.Observation(data=data, target='JUPITER', utc=UTC,
                            device='cpu')
    assert list(t_obs.header.items()) == list(j_obs.header.items())
    _assert_disc_close(t_obs, j_obs)
    with pytest.raises(ValueError, match='No data found'):
        tpm.Observation(files['empty'], device='cpu')
    with pytest.raises(ValueError, match='must be provided'):
        tpm.Observation(device='cpu')
    with pytest.raises(ValueError, match='mutually exclusive'):
        tpm.Observation(files['plain'], data=data, device='cpu')
    for forbidden in ('nx', 'ny', 'sz'):
        with pytest.raises(TypeError):
            tpm.Observation(files['plain'], device='cpu', **{forbidden: 4})
    with pytest.raises(TypeError):
        t_obs.set_img_size(4, 4)


def test_repr_copy_equality_and_to_body_xy(observations):
    j_obs, t_obs = observations['tan']
    # the JAX package's repr, with the device among the keywords
    assert repr(t_obs) == repr(j_obs).replace(
        "target='JUPITER', ", "target='JUPITER', device=device(type='cpu'), ")
    assert repr(t_obs).startswith(f'Observation({t_obs.path!r}')
    copy = t_obs.copy()
    assert copy == t_obs and copy.device == t_obs.device
    _assert_disc_close(copy, t_obs)
    other = t_obs.copy()
    other.set_x0(1.0)
    assert other != t_obs
    body = t_obs.to_body_xy()
    assert type(body) is tpm.BodyXY and body.device == t_obs.device
    assert body.get_img_size() == (NX, NY)
    _assert_disc_close(body, t_obs)


# ---------------------------------------------------------------------------
# Observation: the disc from WCS and the disc fits
# ---------------------------------------------------------------------------

def test_wcs_disc_methods_match_jax(observations):
    j_obs, t_obs = (o.copy() for o in observations['sin'])
    for method in ('position_from_wcs', 'rotation_from_wcs',
                   'plate_scale_from_wcs', 'disc_from_wcs'):
        for obs in (j_obs, t_obs):
            obs.set_disc_params(10.0, 11.0, 12.0, 13.0)
            getattr(obs, method)(suppress_warnings=True)
        _assert_disc_close(t_obs, j_obs)
    np.testing.assert_allclose(t_obs.get_disc_params()[:3], DISC[:3],
                               rtol=0, atol=0.05)
    for obs in (j_obs, t_obs):
        obs.adjust_disc_params(dx=0.4, dy=-0.3)
    np.testing.assert_allclose(t_obs.get_wcs_offset(), j_obs.get_wcs_offset(),
                               rtol=0, atol=DISC_BAR)
    np.testing.assert_allclose(t_obs.get_wcs_arcsec_offset(),
                               j_obs.get_wcs_arcsec_offset(), rtol=0,
                               atol=1e-9)


def test_wcs_header_offsets_shift_the_disc(files, kernels):
    with j_fits.open(files['tan']) as hdul:
        header = hdul[0].header.copy()
        data = hdul[0].data
    header['HIERARCH NAV RA_OFFSET'] = 0.3
    header['HIERARCH NAV DEC_OFFSET'] = -0.2
    j_obs = jpm.Observation(data=data, header=header)
    t_obs = tpm.Observation(data=data, header=header, device='cpu')
    assert t_obs.get_disc_method() == 'wcs'
    _assert_disc_close(t_obs, j_obs)


def test_fit_disc_position_and_radius_match_jax(navigated):
    j_obs, t_obs = (o.copy() for o in navigated)
    for obs in (j_obs, t_obs):
        obs.fit_disc_position()
    _assert_disc_close(t_obs, j_obs)
    np.testing.assert_allclose(t_obs.get_disc_params()[:2], DISC[:2],
                               rtol=0, atol=0.5)
    for obs in (j_obs, t_obs):
        obs.fit_disc_radius()
    _assert_disc_close(t_obs, j_obs)
    assert t_obs.get_disc_method() == 'fit_r0'
    assert abs(t_obs.get_r0() - DISC[2]) < 1.5
    t_obs.set_x0(-3.0)
    with pytest.raises(ValueError, match='within the image frame'):
        t_obs.fit_disc_radius()


@pytest.mark.parametrize('dtype', [np.float32, np.uint16])
def test_fit_disc_on_narrow_data_matches_jax(kernels, dtype):
    # the frames are summed in the data's type, as np.nansum does: the
    # image the fits see equals the JAX package's bit for bit (a float64
    # sum of float32 frames does not)
    cube = _cube(seed=8) * 100 + 500
    if dtype == np.uint16:
        cube = np.nan_to_num(cube)
    cube = cube.astype(dtype)
    j_obs = jpm.Observation(data=cube, target='JUPITER', utc=UTC)
    t_obs = tpm.Observation(data=cube, target='JUPITER', utc=UTC,
                            device='cpu')
    ref = np.asarray(j_obs._get_img_for_fitting(), dtype=np.float64)
    got = t_obs._get_img_for_fitting()
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)
    # the port takes the moments in float64; the JAX package in the
    # image's type, so for float32 data its centroid carries the float32
    # rounding of its moment sums (F32_CENTROID_PX). On the same float64
    # image the two estimators agree at CENTROID_PX.
    np.testing.assert_allclose(
        t_phot.threshold_centroid(got), j_phot.threshold_centroid(ref),
        rtol=0, atol=CENTROID_PX)
    for obs in (j_obs, t_obs):
        obs.fit_disc_position()
    bar = F32_CENTROID_PX if dtype == np.float32 else DISC_BAR
    np.testing.assert_allclose(t_obs.get_disc_params()[:2],
                               j_obs.get_disc_params()[:2], rtol=0, atol=bar)
    for obs in (j_obs, t_obs):
        obs.set_disc_params(*DISC)
        obs.fit_disc_radius()
    _assert_disc_close(t_obs, j_obs)


# ---------------------------------------------------------------------------
# Observation: mapped data and the FITS exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('interpolation', ['nearest', 'linear', 'cubic',
                                           'smooth'])
def test_get_mapped_data_matches_jax(navigated, interpolation):
    j_obs, t_obs = navigated
    ref = j_obs.get_mapped_data(interpolation, **MAP)
    got = t_obs.get_mapped_data(interpolation, **MAP)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == (NZ, 18, 36)
    if interpolation == 'nearest':
        np.testing.assert_array_equal(got, ref)
    else:
        report = compare.compare_map(got, ref, MAP_BAR)
        assert report['ok'], report
    assert np.isfinite(got).sum() > 100
    got[:] = 0  # a copy: the cached map is untouched
    assert np.isfinite(t_obs.get_mapped_data(interpolation, **MAP)).any()


def _plane_bars(body, ref, image: bool):
    """The per-plane bars and ill-conditioned pixels (testing/compare.py)
    from a full set of reference planes."""
    if image:
        x0, y0, r0, _ = body.get_disc_params()
        yy, xx = np.mgrid[0:NY, 0:NX]
        offset = np.hypot(xx - x0, yy - y0) / r0
        pixel = 0.0
    else:
        # the ray to a surface point at emission e passes R sin(e) from
        # the centre of a sphere of radius R
        offset = np.abs(np.sin(np.radians(ref['EMISSION'])))
        pixel = MAP_PIXEL_BAR
    return (compare.per_plane_tolerance(body, angle=compare.F64_ANGLE,
                                        pixel=pixel),
            compare.per_plane_ill_conditioned(ref, offset))


def _planes(path, module=j_fits):
    with module.open(path) as hdul:
        return {h.name: h.data for h in hdul[1:]}


def _assert_files_match(got_path, ref_path, body, *, image: bool,
                        full: dict, mapped_bar=None):
    """A port file against a JAX file: HDU names, every header card by
    card, the primary data (equal, or within ``mapped_bar``) and the
    backplane HDUs at the per-plane bars, conditioned on ``full``, the JAX
    package's planes of the same body and map."""
    with t_fits.open(got_path) as got, j_fits.open(ref_path) as ref:
        assert [h.name for h in got] == [h.name for h in ref]
        for g, r in zip(got, ref):
            problems = compare.compare_headers(g.header, r.header,
                                               **HEADER_BARS)
            assert not problems, (g.name, problems)
        if mapped_bar is None:
            np.testing.assert_array_equal(got[0].data, ref[0].data)
        else:
            report = compare.compare_map(got[0].data, ref[0].data,
                                         mapped_bar)
            assert report['ok'], report
    planes, refs = _planes(got_path, t_fits), _planes(ref_path)
    tolerance, ill = _plane_bars(body, full, image)
    reports = compare.compare_per_plane(planes, refs, tolerance, ill)
    assert not compare.failures(reports), compare.failures(reports)


@pytest.fixture(scope='module')
def saved(navigated, tmp_path_factory):
    """Each package's save_observation of the navigated observation: the
    default backplanes, a chosen set, and planes at alt=500 km."""
    root = tmp_path_factory.mktemp('saved')
    paths = {}
    cases = {'default': {},
             'custom': dict(backplanes_to_save=['emission', 'LAT-GRAPHIC',
                                                'RA', 'DISTANCE'],
                            backplanes_to_skip=['ra']),
             'alt': dict(backplanes_to_save=ALT_PLANES, alt=500.0)}
    for case, kw in cases.items():
        for name, obs in zip(('jax', 'port'), navigated):
            paths[case, name] = str(root / f'{name}_{case}.fits')
            obs.save_observation(paths[case, name], include_wireframe=False,
                                 print_info=False, **kw)
    return paths


@pytest.mark.parametrize('case', ['default', 'custom', 'alt'])
def test_save_observation_matches_jax(navigated, saved, case):
    _, t_obs = navigated
    # at alt=500 km the disc is larger: pixels off the alt=0 disc count as
    # ill-conditioned (NaN emission), a stricter bar nowhere
    _assert_files_match(saved[case, 'port'], saved[case, 'jax'], t_obs,
                        image=True, full=_planes(saved['default', 'jax']))
    with t_fits.open(saved[case, 'port']) as hdul:
        names = [h.name for h in hdul]
        header = hdul[0].header
    assert header['PLANMAP DISC METHOD'] == 'manual'
    assert header['PLANMAP ALTITUDE-ADJUSTMENT'] == (
        500.0 if case == 'alt' else 0.0)
    assert t_obs._alt_adjustment == 0.0
    assert names == [''] + {
        'default': list(t_obs.backplanes),
        'custom': ['LAT-GRAPHIC', 'EMISSION', 'DISTANCE'],
        'alt': ALT_PLANES}[case]


@pytest.mark.parametrize('projection', ['rectangular', 'orthographic'])
def test_save_mapped_observation_matches_jax(navigated, tmp_path,
                                             projection):
    kw = MAP if projection == 'rectangular' else ORTHO
    skip = ['RING-RADIUS', 'RING-LON-GRAPHIC', 'RING-DISTANCE']
    paths = {}
    for name, obs in zip(('jax', 'port'), navigated):
        paths[name] = str(tmp_path / f'{name}.fits')
        obs.save_mapped_observation(paths[name], include_wireframe=False,
                                    print_info=False,
                                    backplanes_to_skip=skip, **kw)
    _assert_files_match(paths['port'], paths['jax'], navigated[1],
                        image=False, full=_planes(paths['jax']),
                        mapped_bar=MAP_BAR)
    with t_fits.open(paths['port']) as hdul:
        assert hdul[0].header['PLANMAP MAP PROJECTION'] == projection
        assert len(hdul) == 1 + 26 - len(skip)


def test_round_trip_through_both_packages(navigated, saved, kernels):
    _, t_nav = navigated
    for path in (saved['default', 'port'], saved['default', 'jax']):
        for obs in (tpm.Observation(path, device='cpu'),
                    jpm.Observation(path)):
            assert obs.get_disc_method() == 'header'
            np.testing.assert_allclose(obs.get_disc_params(),
                                       t_nav.get_disc_params(), rtol=0,
                                       atol=DISC_BAR)
            np.testing.assert_array_equal(obs.data, t_nav.data)


def test_a_dropped_observation_goes_with_its_last_reference(files, tmp_path):
    """The backplane registry holds the body's own getters weakly, so an
    Observation opened, saved and dropped is freed with its cached tensors
    when its last reference goes, with the cycle collector off; a backplane
    taken by ``get_backplane`` holds its body, as a bound method does."""
    out = str(tmp_path / 'saved.fits')

    def open_and_save():
        obs = tpm.Observation(files['tan'], device='cpu')
        obs.set_disc_params(*DISC)
        obs.save_observation(out, include_wireframe=False, print_info=False)
        tensors = [t for v in obs._cache.values()
                   for t in (v if isinstance(v, tuple) else (v,))
                   if isinstance(t, torch.Tensor)]
        assert tensors
        return weakref.ref(obs), [weakref.ref(t) for t in tensors]

    open_and_save()  # the first call in a process may import lazily
    gc.collect()
    gc.disable()
    try:
        obs, tensors = open_and_save()
        assert obs() is None
        assert all(t() is None for t in tensors)
        emission = tpm.Observation(files['tan'], device='cpu') \
            .get_backplane('EMISSION')
        assert emission.get_img().shape == (NY, NX)
    finally:
        gc.enable()


def test_make_filename_and_wavelengths(observations, kernels):
    j_obs, t_obs = observations['plain']
    for kw in ({}, dict(extension='.png', prefix='a_', suffix='_b')):
        assert t_obs.make_filename(**kw) == j_obs.make_filename(**kw)
    assert t_obs.make_filename() == 'JUPITER_2005-01-01T000000.fits'
    header = t_fits.Header([('CTYPE3', 'WAVE'), ('NAXIS3', 5),
                            ('CRVAL3', 1.5), ('CDELT3', 0.01),
                            ('CRPIX3', 2)])
    cube = np.zeros((5, NY, NX))
    t_obs = tpm.Observation(data=cube, header=header, target='JUPITER',
                            utc=UTC, device='cpu')
    np.testing.assert_array_equal(
        t_obs.get_wavelengths_from_header(),
        j_utils.generate_wavelengths_from_header(header))
    header['CTYPE3'] = 'FREQ'
    with pytest.raises(t_utils.GetWavelengthsError):
        t_obs.get_wavelengths_from_header()
    assert t_obs.get_wavelengths_from_header(check_ctype=False).shape == (5,)


def test_append_to_header_matches_jax(observations):
    j_obs, t_obs = (o.copy() for o in observations['plain'])
    for obs in (j_obs, t_obs):
        obs.append_to_header('LONG', 'y' * 120, 'a long string')
        obs.append_to_header('COUNT', 3, hierarch_keyword=False)
        obs.add_header_metadata()
    assert not compare.compare_headers(t_obs.header, j_obs.header,
                                       **HEADER_BARS)


def test_gui_raises_before_any_file(navigated, tmp_path):
    """``run_gui`` (it raised before the GUI was ported) builds the GUI
    as the JAX package does, with the GUI class mocked: no window, no
    file."""
    _, t_obs = navigated
    with mock.patch('planetmapper_tpu_torch.gui.GUI') as mock_gui:
        instance = mock_gui.return_value
        instance.click_locations = [(1.0, 2.0)]
        out = t_obs.run_gui()
    mock_gui.assert_called_once_with(allow_open=False)
    instance.set_observation.assert_called_once_with(t_obs)
    instance.run.assert_called_once_with()
    assert out == [(1.0, 2.0)]
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize('mapped', [False, True])
def test_default_saves_write_the_wireframe(navigated, tmp_path, mapped):
    """``include_wireframe`` left at its default: both packages write the
    WIREFRAME HDU last, its raster equal byte for byte, its header card by
    card."""
    paths = {}
    for name, obs in zip(('jax', 'port'), navigated):
        paths[name] = str(tmp_path / f'{name}.fits')
        save = obs.save_mapped_observation if mapped else obs.save_observation
        save(paths[name], print_info=False, backplanes_to_save=['EMISSION'],
             **(MAP if mapped else {}))
    with t_fits.open(paths['port']) as got, j_fits.open(paths['jax']) as ref:
        assert [h.name for h in got] == [h.name for h in ref] == [
            '', 'EMISSION', 'WIREFRAME']
        wf, wf_ref = got['WIREFRAME'], ref['WIREFRAME']
        assert wf.data.dtype == wf_ref.data.dtype == np.uint8
        np.testing.assert_array_equal(wf.data, wf_ref.data)
        assert (wf.data < 128).any()
        problems = compare.compare_headers(wf.header, wf_ref.header,
                                           **HEADER_BARS)
        assert not problems, problems
        assert wf.header['ABOUT'] == ('Wireframe map overlay' if mapped
                                      else 'Wireframe image overlay')


@pytest.mark.parametrize('mapped', [False, True])
def test_default_saves_without_matplotlib_raise_before_any_file(
        navigated, tmp_path, monkeypatch, mapped):
    """Without matplotlib the default save raises its ImportError and
    writes nothing; ``include_wireframe=False`` still saves."""
    import sys

    for name in [n for n in sys.modules if n.split('.')[0] == 'matplotlib']:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    _, t_obs = navigated
    save = t_obs.save_mapped_observation if mapped else t_obs.save_observation
    kw = dict(print_info=False, backplanes_to_save=['EMISSION'],
              **(MAP if mapped else {}))
    with pytest.raises(ImportError):
        save(tmp_path / 'sub' / 'never.fits', **kw)
    assert not (tmp_path / 'sub').exists()
    save(tmp_path / 'plain.fits', include_wireframe=False, **kw)
    with t_fits.open(tmp_path / 'plain.fits') as hdul:
        assert [h.name for h in hdul] == ['', 'EMISSION']


def test_observation_copies_carry_rings_bodies_and_coordinates(navigated):
    _, t_obs = navigated
    obs = t_obs.copy()
    obs.ring_radii.add(120000.0)
    obs.coordinates_of_interest_lonlat.append((1.0, 2.0))
    obs.coordinates_of_interest_radec.append((3.0, 4.0))
    obs.other_bodies_of_interest.append(obs.create_other_body('SUN'))
    for new in (obs.copy(), obs.to_body_xy(), obs.to_body()):
        assert new.ring_radii == {120000.0}
        assert new.coordinates_of_interest_lonlat == [(1.0, 2.0)]
        assert new.coordinates_of_interest_radec == [(3.0, 4.0)]
        assert [o.target for o in new.other_bodies_of_interest] == ['SUN']
        assert new.other_bodies_of_interest is not obs.other_bodies_of_interest


@pytest.mark.parametrize('mapped', [False, True])
def test_save_with_progress_bar(navigated, tmp_path, capsys, mapped):
    _, t_obs = navigated
    obs = t_obs.copy()
    save = obs.save_mapped_observation if mapped else obs.save_observation
    save(tmp_path / 'out.fits', include_wireframe=False,
         backplanes_to_save=['EMISSION'], show_progress=True,
         **(MAP if mapped else {}))
    assert obs._get_progress_hook() is None
    assert 'Saving' not in capsys.readouterr().out  # the bar is on stderr
    with t_fits.open(tmp_path / 'out.fits') as hdul:
        assert [h.name for h in hdul] == ['', 'EMISSION']


def test_save_progress_weights_match_jax():
    """The save bars' parts: the JAX package's weights, keyed by the
    port's names of the same steps (each a method of the port)."""
    from planetmapper_tpu import progress as j_progress
    from planetmapper_tpu_torch import progress as t_progress

    for name in ('NAVIGATION_SAVE_WEIGHTS', 'MAP_SAVE_WEIGHTS'):
        got, ref = (getattr(m, name) for m in (t_progress, j_progress))
        assert list(got.values()) == list(ref.values())
        assert all(hasattr(tpm.Observation, key) for key in got)


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_utils_match_jax(tmp_path):
    for value in (12.5824, -0.5, -12.0001, 0.0, 359.99999):
        assert t_utils.decimal_degrees_to_dms(value) == \
            j_utils.decimal_degrees_to_dms(value)
        assert t_utils.decimal_degrees_to_dms_str(value, '.3f') == \
            j_utils.decimal_degrees_to_dms_str(value, '.3f')
    for vmin, vmax in ((10.0, 10.001), (-1.0, 2.0), (0.2, 0.21)):
        got, ref = (m._SexagesimalScale(vmin, vmax) for m in (t_utils,
                                                              j_utils))
        assert (got.unit_index, got.visible, got.offset_string()) == \
            (ref.unit_index, ref.visible, ref.offset_string())
        assert got.label(vmin) == ref.label(vmin)
    values = [3.0, 1.0, np.nan, 5.0]
    np.testing.assert_array_equal(t_utils.normalise(values, top=2.0),
                                  j_utils.normalise(values, top=2.0))
    np.testing.assert_array_equal(
        t_utils.normalise([2, 2], single_value=0.5), [0.5, 0.5])
    target = tmp_path / 'a' / 'b' / 'file.fits'
    t_utils.check_path(str(target))
    assert target.parent.is_dir()
    import matplotlib.ticker

    assert issubclass(t_utils.DMSFormatter, matplotlib.ticker.Formatter)
    assert issubclass(t_utils.DMSLocator, matplotlib.ticker.Locator)
    ticks = t_utils.DMSLocator().tick_values(10.0, 10.01)
    np.testing.assert_allclose(ticks,
                               j_utils.DMSLocator().tick_values(10.0, 10.01))
    with pytest.raises(AttributeError):
        t_utils.NotAThing  # noqa: B018


def test_utils_imports_without_matplotlib():
    code = (
        'import sys\n'
        'sys.modules["matplotlib"] = None\n'
        'from planetmapper_tpu_torch import utils\n'
        'print(utils.decimal_degrees_to_dms_str(1.5))\n'
        'try:\n'
        '    utils.DMSFormatter\n'
        'except ImportError:\n'
        '    print("no matplotlib")\n'
    )
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split('\n')[1] == 'no matplotlib'
