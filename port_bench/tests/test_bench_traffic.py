"""The traffic generators repeat for a seed and differ across seeds."""

import numpy as np
import pytest

from conftest import CELLS, small_ctx


def _inputs(workload, seed, tmp_path):
    ctx = small_ctx(workload, seed, tmp_path)
    out = ctx.driver.inputs(ctx)
    if isinstance(out, tuple):  # a pool and an order
        pool, order = out
        return np.concatenate([np.concatenate([p.ravel() for p in pool]),
                               order.astype(np.float64)])
    return out


@pytest.mark.parametrize('workload', CELLS)
def test_same_seed_same_inputs_other_seed_other_inputs(workload, tmp_path):
    big = 2**31 + 977
    a = _inputs(workload, big, tmp_path)
    b = _inputs(workload, big, tmp_path)
    c = _inputs(workload, big + 1, tmp_path)
    np.testing.assert_array_equal(a, b)
    assert a.shape == c.shape
    assert not np.array_equal(np.nan_to_num(a), np.nan_to_num(c))


def test_pool_images_have_their_nan_cells(tmp_path):
    ctx = small_ctx('jupiter_2048.map_linear', 5, tmp_path)
    pool, _ = ctx.driver.inputs(ctx)
    assert all(np.isnan(img).any() and img.dtype == np.float32 for img in pool)
    x0, y0, r0, _ = ctx.config['disc']
    for img in pool:
        i, j = np.nonzero(np.isnan(img))
        # the bad-pixel blocks lie on the disc
        assert (np.hypot(i - y0, j - x0) < r0).all()
