"""
The CUDA backplane kernel against its plain float64 PyTorch version, on the
card. Every test here carries the ``cuda`` marker and skips without a CUDA
device; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the repository's conftest imports JAX, which a GPU host
running only the port need not have. For the same reason this file, unlike
the other ``test_torch_*`` files, imports torch but not jax: it holds the
kernel against the port's own plain version, not against the JAX package.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import planetmapper_tpu_torch as tpm
from planetmapper_tpu_torch import pipeline
from planetmapper_tpu_torch._device import f64
from planetmapper_tpu_torch.ops import backplanes_kernel as bk
from planetmapper_tpu_torch.testing import compare
from planetmapper_tpu_torch.testing.synthetic_kernels import (
    write_synthetic_kernels,
)

pytestmark = pytest.mark.cuda

FLAGS = dict(positive_west=True, prograde=True, have_sun=True)


@pytest.fixture(scope='module')
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.fixture(scope='module')
def kernel_path(tmp_path_factory, device):
    path = tmp_path_factory.mktemp('synthetic_kernels')
    write_synthetic_kernels(path, seed=0)
    previous, source = tpm.get_kernel_path(return_source=True)
    tpm.clear_kernels()
    tpm.set_kernel_path(path)
    yield path
    tpm.clear_kernels()
    tpm.set_kernel_path(previous if source == 'set_kernel_path()' else None)


def _body(nx, ny, disc, device):
    body = tpm.BodyXY('Jupiter', observer='EARTH', utc='2005-01-01T00:00:00',
                      nx=nx, ny=ny, device=device)
    body.set_disc_params(*disc)
    args = (
        f64(body._get_xy2angular_matrix(), device),
        f64(np.asarray(body.get_disc_params()), device),
        f64(np.asarray(body.radii), device),
        pipeline._device_anchors(body),
    )
    return body, args


def _numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize('nx, ny, disc', [
    (128, 64, (64.3, 32.3, 28.8, 12.3)),
    (100, 70, (50.3, 34.7, 30.0, 200.0)),
    (333, 257, (120.6, 140.2, 90.0, 45.0)),
])
@pytest.mark.parametrize('optimize_speed', [True, False])
def test_kernel_matches_plain_version(
    kernel_path, device, nx, ny, disc, optimize_speed
):
    _, args = _body(nx, ny, disc, device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=optimize_speed, lst_quant=True, **FLAGS,
    )
    plain = pipeline.fused_backplanes_fn(optimize_speed=optimize_speed, **FLAGS)
    before = bk.launch_count()
    got = _numpy(kernel(nx, ny, *args))
    torch.cuda.synchronize()
    assert bk.launch_count() == before + 1
    assert got['EMISSION'].dtype == np.float32
    assert got['RADIAL-VELOCITY'].dtype == np.float64
    reports = compare.compare_backplanes(
        got, _numpy(plain(nx, ny, *args)), float32_ulps=1,
    )
    assert not compare.failures(reports), compare.failures(reports)
    assert np.isfinite(got['EMISSION']).sum() > 100


def test_row0_band_equals_full_frame(kernel_path, device):
    nx, ny = 100, 70
    _, args = _body(nx, ny, (50.3, 34.7, 30.0, 12.3), device)
    kernel = bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )
    full = _numpy(kernel(nx, ny, *args))
    top = _numpy(kernel(nx, 29, *args))
    bottom = _numpy(kernel(nx, ny - 29, *args, row0=29.0))
    for name, plane in full.items():
        assert np.array_equal(
            np.concatenate([top[name], bottom[name]]), plane, equal_nan=True
        ), name


def test_subsets_equal_full_set(kernel_path, device):
    nx, ny = 128, 64
    _, args = _body(nx, ny, (64.3, 32.3, 28.8, 12.3), device)
    full = _numpy(bk.build_backplanes_kernel(
        optimize_speed=True, lst_quant=True, **FLAGS,
    )(nx, ny, *args))
    for planes in [('LON-GRAPHIC', 'LOCAL-SOLAR-TIME'), ('AZIMUTH',),
                   ('DISTANCE', 'DOPPLER', 'RING-DISTANCE')]:
        sub = _numpy(bk.build_backplanes_kernel(
            optimize_speed=True, lst_quant=True, planes=planes, **FLAGS,
        )(nx, ny, *args))
        assert set(sub) == set(planes)
        for name in planes:
            assert np.array_equal(sub[name], full[name], equal_nan=True), name


def test_compute_backplanes_launches_kernel(kernel_path, device):
    body, _ = _body(96, 80, (47.6, 40.2, 30.0, 12.3), device)
    bk.reset_launch_count()
    out = pipeline.compute_backplanes(body)
    assert bk.launch_count() == 1
    assert set(out) == set(bk.PLANE_ORDER)
    body._pipeline_precision = 'double'
    pipeline.compute_backplanes(body)
    assert bk.launch_count() == 1  # 'double' pins the plain graph
