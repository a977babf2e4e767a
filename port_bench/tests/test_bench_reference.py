"""
The reference against the port on the CPU at a small frame: the scene's
per-epoch values, the 26 planes, the x/y maps and the 'linear' map. This
test imports the port; the reference does not.
"""

import numpy as np
import pytest
import torch

from conftest import SEED
from port_bench.reference import backplanes as rb
from port_bench.reference import compare
from port_bench.reference import maps as rm
from port_bench.reference import scene as rs
from port_bench.vendor.synthetic_kernels import write_synthetic_kernels

@pytest.fixture(scope='module')
def bodies(tmp_path_factory):
    import planetmapper_tpu_torch as pt

    kernels = tmp_path_factory.mktemp('kernels')
    write_synthetic_kernels(kernels, SEED)
    pt.clear_kernels()
    pt.set_kernel_path(str(kernels))
    frame = pt.BodyXY('JUPITER', utc='2005-01-01T00:00:00', sz=64,
                      device='cpu')
    frame.set_disc_params(32.0, 31.0, 25.6, 12.3)
    scene = rs.Scene(SEED)
    anchors = {k: v[0] for k, v in scene.anchors([frame.et]).items()}
    return frame, scene, anchors


def test_epoch(bodies):
    frame, _, _ = bodies
    assert rs.utc_to_et(2005, 1, 1) == frame.et


def test_scene_values(bodies):
    from planetmapper_tpu_torch.pipeline import compute_scene_anchors

    frame, _, anchors = bodies
    for key, value in compute_scene_anchors(frame).items():
        value = np.asarray(value)
        scale = max(np.max(np.abs(value)), 1e-300)
        err = np.max(np.abs(anchors[key].numpy() - value))
        assert err <= 1e-10 * scale, (key, err, scale)


def test_planes(bodies):
    frame, _, anchors = bodies
    m = rs.xy2angular(frame.get_disc_params(), anchors['diameter_arcsec'][None])[0]
    np.testing.assert_allclose(m.numpy(), frame._get_xy2angular_matrix(),
                               rtol=1e-12, atol=1e-12)
    ref = rb.planes(anchors, m, frame.get_disc_params(), 64, 64, 'cpu')
    got = frame.generate_backplanes_fused()
    gap, flips, _ = compare.planes(got, ref, rs.RADII[0])
    assert flips == 0 and gap < 0.1
    some = rb.rows(anchors, m, frame.get_disc_params(), 64, [3, 4, 30, 63], 'cpu')
    for key, plane in some.items():
        np.testing.assert_array_equal(plane, ref[key][[3, 4, 30, 63]])


def test_control_is_far_from_the_reference(bodies):
    frame, _, anchors = bodies
    m = rs.xy2angular(frame.get_disc_params(), anchors['diameter_arcsec'][None])[0]
    ref = rb.planes(anchors, m, frame.get_disc_params(), 64, 64, 'cpu')
    low = rb.planes(anchors, m, frame.get_disc_params(), 64, 64, 'cpu',
                    dtype=torch.float32)
    gap, _flips, _ = compare.planes(low, ref, rs.RADII[0])
    assert gap > 1000


def test_linear_map(bodies):
    frame, scene, anchors = bodies
    m = rs.xy2angular(frame.get_disc_params(), anchors['diameter_arcsec'][None])[0]
    x, y = rm.xy_maps(scene, anchors, m, 64, 64, 2, 'cpu')
    got_x = frame.get_x_map(degree_interval=2)
    got_y = frame.get_y_map(degree_interval=2)
    np.testing.assert_array_equal(np.isnan(got_x), np.isnan(x.numpy()))
    assert np.nanmax(np.abs(got_x - x.numpy())) < 1e-8
    assert np.nanmax(np.abs(got_y - y.numpy())) < 1e-8
    img = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
    img[30:33, 20:23] = np.nan
    got = frame.map_img(img, degree_interval=2).numpy()
    ref = rm.linear(torch.as_tensor(img[None]).double(), x, y)[0]
    gap, flips = compare.maps(got, ref.numpy())
    assert flips == 0 and gap < 1e-6
    assert np.isnan(got).sum() > np.isnan(got_x).sum()  # the block's samples
