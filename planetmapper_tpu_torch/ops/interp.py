"""
Host image -> map interpolation for :func:`BodyXY.map_img` (the port's copy
of ``planetmapper_tpu.ops.interp``, numpy and scipy only).

Behavioural parity with the reference's interpolation modes
(body_xy.py:1414-1904) - nearest, spline degrees 1-3, and the monotonic
PCHIP-based 'smooth' mode - with the reference's per-cell Python loops
replaced by vectorised gathers and masked evaluations. The port's
``map_img`` runs :mod:`.interp_device` and :mod:`.pchip_device`; from here
it uses :func:`replace_nans_with_interpolated_values` (the smoothing
``spline_smoothing > 0`` branch), and the tests use the rest as an
independent host reference.
"""

from __future__ import annotations


import numpy as np
import scipy.interpolate
import scipy.ndimage


def nearest_interpolation(img, x_map, y_map, projected) -> None:
    """Nearest-pixel gather (reference body_xy.py:1633-1649)."""
    valid = np.isfinite(x_map)
    x_idx = np.where(valid, np.round(x_map), 0).astype(int)
    y_idx = np.where(valid, np.round(y_map), 0).astype(int)
    x_idx = np.clip(x_idx, 0, img.shape[1] - 1)
    y_idx = np.clip(y_idx, 0, img.shape[0] - 1)
    projected[valid] = img[y_idx[valid], x_idx[valid]]


def spline_interpolation(
    img, x_map, y_map, projected, *, interpolation, warn_nan: bool,
    propagate_nan: bool, spline_smoothing: float,
) -> None:
    """RectBivariateSpline evaluation (reference body_xy.py:1651-1702)."""
    if isinstance(interpolation, int):
        kx = ky = interpolation
    else:
        kx, ky = interpolation

    nans = np.isnan(img)
    if np.all(nans):
        return

    cleaned = replace_nans_with_interpolated_values(img, warn_nan)
    interpolator = scipy.interpolate.RectBivariateSpline(
        np.arange(img.shape[0]),
        np.arange(img.shape[1]),
        cleaned,
        kx=kx,
        ky=ky,
        s=spline_smoothing,
    )
    valid = np.isfinite(x_map)
    if propagate_nan:
        valid = valid & ~should_propagate_nan_to_map(
            x_map, y_map, nans, img.shape
        )
    projected[valid] = interpolator.ev(y_map[valid], x_map[valid])


def smooth_interpolation(
    img, x_map, y_map, projected, *, propagate_nan: bool, oversample_by: int,
    max_oversampled_img_size: int, limit_padding: float = 5.0,
) -> None:
    """
    PCHIP oversampling followed by linear interpolation (the monotonic
    'smooth' mode, reference body_xy.py:1704-1853).
    """
    nans = np.isnan(img)
    if np.all(nans):
        return

    xlim = (np.nanmin(x_map), np.nanmax(x_map))
    ylim = (np.nanmin(y_map), np.nanmax(y_map))

    def get_xy_pchip(original, limits):
        original = original[
            (original >= limits[0] - limit_padding)
            & (original <= limits[1] + limit_padding)
        ]
        old_size = len(original)
        for oversample_to_use in range(oversample_by, 1, -1):
            new_size = old_size * oversample_to_use - (oversample_to_use - 1)
            if new_size <= max_oversampled_img_size:
                return np.linspace(original[0], original[-1], new_size)
        return original.astype(float)

    xs_original = np.arange(img.shape[1])
    ys_original = np.arange(img.shape[0])
    xs_pchip = get_xy_pchip(xs_original, xlim)
    ys_pchip = get_xy_pchip(ys_original, ylim)

    pchip_img = _pchip_grid_interp2d(
        xs_original=xs_original, ys_original=ys_original, img=img,
        xs=xs_pchip, ys=ys_pchip, xlim=xlim, ylim=ylim,
        limit_padding=limit_padding,
    )
    interpolator = scipy.interpolate.RegularGridInterpolator(
        (ys_pchip, xs_pchip), pchip_img, bounds_error=False,
        fill_value=np.nan, method='linear',
    )
    valid = np.isfinite(x_map)
    if propagate_nan:
        valid = valid & ~should_propagate_nan_to_map(
            x_map, y_map, nans, img.shape
        )
    projected[valid] = interpolator((y_map[valid], x_map[valid]))


def _pchip_grid_interp2d(
    *, xs_original, ys_original, img, xs, ys, xlim, ylim, limit_padding
):
    """
    Separable grid-to-grid PCHIP: interpolate each row along x, then each
    oversampled column along y (reference body_xy.py:1791-1853). PCHIP is
    local so restricting to the padded limits loses nothing.
    """
    intermediate = np.full((len(ys_original), len(xs)), np.nan, dtype=np.float64)
    x_mask = (xs_original >= xlim[0] - limit_padding) & (
        xs_original <= xlim[1] + limit_padding
    )
    for i, y in enumerate(ys_original):
        if y < ylim[0] - limit_padding or y > ylim[1] + limit_padding:
            continue
        mask = np.isfinite(img[i]) & x_mask
        if np.sum(mask) < 2:
            continue
        interpolator = scipy.interpolate.PchipInterpolator(
            xs_original[mask], img[i, mask], extrapolate=False
        )
        intermediate[i] = interpolator(xs)
    final = np.full((len(ys), len(xs)), np.nan, dtype=np.float64)
    y_mask = (ys_original >= ylim[0] - limit_padding) & (
        ys_original <= ylim[1] + limit_padding
    )
    for j, x in enumerate(xs):
        if x < xlim[0] - limit_padding or x > xlim[1] + limit_padding:
            continue
        mask = np.isfinite(intermediate[:, j]) & y_mask
        if np.sum(mask) < 2:
            continue
        interpolator = scipy.interpolate.PchipInterpolator(
            ys_original[mask], intermediate[mask, j], extrapolate=False
        )
        final[:, j] = interpolator(ys)
    return final


def should_propagate_nan_to_map(x_map, y_map, nans, img_shape) -> np.ndarray:
    """
    Vectorised 4-neighbour NaN / convex-hull test: a map cell becomes NaN
    when any surrounding integer pixel is NaN or the sample point is outside
    the grid of pixel centres (reference body_xy.py:1855-1866).
    """
    ny, nx = img_shape
    with np.errstate(invalid='ignore'):
        outside = (
            (x_map < 0.0) | (y_map < 0.0)
            | (x_map > nx - 1) | (y_map > ny - 1)
        )
        x = np.where(np.isfinite(x_map), x_map, 0.0)
        y = np.where(np.isfinite(y_map), y_map, 0.0)
        x0 = np.clip(np.floor(x).astype(int), 0, nx - 1)
        x1 = np.clip(np.ceil(x).astype(int), 0, nx - 1)
        y0 = np.clip(np.floor(y).astype(int), 0, ny - 1)
        y1 = np.clip(np.ceil(y).astype(int), 0, ny - 1)
    neighbour_nan = (
        nans[y0, x0] | nans[y0, x1] | nans[y1, x0] | nans[y1, x1]
    )
    return outside | neighbour_nan


def replace_nans_with_interpolated_values(img, warn_nan: bool) -> np.ndarray:
    """
    Replace NaNs with the 3x3 mean of surrounding good pixels (other NaNs
    get the global median), preparing the image for spline interpolation
    (reference body_xy.py:1871-1904).
    """
    bad = ~np.isfinite(img)
    if warn_nan and np.any(bad):
        print('Warning, image contains NaN values which will be corrected')
    cleaned = img.astype(float, copy=True)
    if np.any(np.isinf(img)):
        img = np.nan_to_num(img, nan=np.nan, posinf=np.nan, neginf=np.nan)
    if np.all(bad):
        median = 0.0
    else:
        median = np.nanmedian(img)
    cleaned[bad] = median
    to_fix = bad & ~scipy.ndimage.uniform_filter(bad, size=3)
    for i, j in np.argwhere(to_fix):
        cleaned[i, j] = np.nanmean(
            img[max(i - 1, 0): i + 2, max(j - 1, 0): j + 2]
        )
    return cleaned
