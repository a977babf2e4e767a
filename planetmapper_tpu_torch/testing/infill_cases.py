"""
Seeded frames for the NaN infill of the spline map modes
(``ops/map_infill_kernel.py``): the cases the CPU tests, the card's tests
and ``scripts/time_map_infill.py`` share. Each is a float64 cube ``(nz,
ny, nx)`` as numpy.

- the rules: a 3x3 NaN block (its centre has no finite neighbour and
  takes the median) with an even and an odd count of finite values,
  infinities, NaNs on the edges and corners, an all-NaN frame, an
  all-finite frame, and a cube of mixed frames;
- the median's selection (``csrc/map_infill.cu``): frames of more values
  than one block sorts, whose middle values lie in one digit bucket after
  another: noise around 0, values near 1000, four repeated values, two
  values one ulp apart, two values of opposite sign, and signed zeros,
  subnormals and values near the largest double;
- ``map_linear``: a 2048x2048 float32 frame of unit noise with 4 NaN
  blocks of 3 px on a disc of radius 601 px at the centre, as the
  benchmark's ``jupiter_2048.map_linear`` cell maps.
"""

from __future__ import annotations

import numpy as np

RULE_CASES = ('block_even', 'block_odd', 'inf', 'edges', 'all_nan',
              'all_finite', 'cube')
SELECT_CASES = ('noise', 'offset', 'repeated', 'one_ulp', 'two_signs',
                'extremes')


def _block(frame, i, j, size=3, value=np.nan):
    frame[i:i + size, j:j + size] = value


def _rule_case(name: str, rng) -> np.ndarray:
    frame = rng.normal(size=(12, 9))
    if name == 'block_even':
        frame[0, :3] = np.nan
        frame[5:8, 2:7] = np.nan  # the middle row's cells take the median
        frame[11, 8] = np.nan
        frame[2, 2] = -np.inf
        assert np.isfinite(frame).sum() % 2 == 0
    elif name == 'block_odd':
        _block(frame, 5, 2)
        frame[0, :2] = np.nan
        assert np.isfinite(frame).sum() % 2 == 1
    elif name == 'inf':
        _block(frame, 4, 4, value=np.inf)
        frame[0, 0] = -np.inf
        frame[7, 1] = np.inf
        frame[9, 6] = np.nan
    elif name == 'edges':
        frame[0, :] = np.nan
        frame[:, -1] = np.nan
        frame[-2:, :2] = np.nan  # the corner cell has no finite neighbour
        frame[5, 0] = np.nan
    elif name == 'all_nan':
        frame[:] = np.nan
    elif name == 'cube':
        block = frame.copy()
        _block(block, 2, 3)
        return np.stack([frame, block, np.full_like(frame, np.nan)])
    return frame[None]


def _select_case(name: str, rng) -> np.ndarray:
    ny, nx = 96, 100
    n = ny * nx
    if name == 'noise':
        values = rng.normal(size=n)
    elif name == 'offset':
        values = 1000.0 + 1e-3 * rng.normal(size=n)
    elif name == 'repeated':
        values = rng.integers(0, 4, size=n).astype(np.float64)
    elif name == 'one_ulp':
        values = np.where(np.arange(n) < n // 2, 1.0, np.nextafter(1.0, 2.0))
    elif name == 'two_signs':
        values = np.where(np.arange(n) < n // 2, -1.0, 1.0)
    else:  # 'extremes'
        pool = np.array([-0.0, 0.0, 5e-324, -5e-324, 2.2e-308, 1.7e308,
                         -1.7e308, -1.0, 3.0])
        values = pool[rng.integers(0, pool.size, size=n)]
    frame = values.reshape(ny, nx)
    _block(frame, 40, 50)
    frame[3, 4] = np.nan  # an isolated NaN: its neighbours' mean
    if name in ('one_ulp', 'two_signs'):
        # the middle pair straddles the two values: the lower middle is the
        # last key of its bucket, the upper one another bucket's least
        finite = np.flatnonzero(np.isfinite(frame))
        half = finite.size // 2
        frame.flat[finite[:half]] = values[0]
        frame.flat[finite[half:]] = values[-1]
        if finite.size % 2:
            frame.flat[finite[-1]] = np.nan
    return frame[None]


def map_linear_frame(seed: int, size: int = 2048, r0: float = 601.0,
                     blocks: int = 4, block_px: int = 3) -> np.ndarray:
    """A frame of the benchmark's ``map_linear`` traffic, float64."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((size, size), dtype=np.float32)
    c = size / 2
    for _ in range(blocks):
        rad = rng.uniform(0, 0.8 * r0)
        ang = rng.uniform(0, 2 * np.pi)
        _block(img, int(c + rad * np.sin(ang)), int(c + rad * np.cos(ang)),
               block_px)
    return img.astype(np.float64)[None]


def infill_case(name: str, seed: int = 0) -> np.ndarray:
    """The case ``name`` (of :data:`RULE_CASES`, :data:`SELECT_CASES` or
    ``'map_linear'``) as a float64 cube ``(nz, ny, nx)``."""
    rng = np.random.default_rng(seed)
    if name in RULE_CASES:
        return _rule_case(name, rng)
    if name in SELECT_CASES:
        return _select_case(name, rng)
    if name == 'map_linear':
        return map_linear_frame(seed)
    raise ValueError(f'no infill case {name!r}')
