"""
Image -> map reprojection on the body's device for :func:`BodyXY.map_img`
('nearest' and the spline modes; port of ``planetmapper_tpu.ops.
interp_device``).

- ``nearest``: one gather per sample (plain PyTorch: there is no TPU kernel
  behind it in the JAX package either).
- spline degrees 1-5 with ``spline_smoothing=0`` (the default) and sources
  up to :data:`_DEVICE_SOLVE_MAX` px: the NaN infill of every frame
  (:func:`.map_infill_kernel.map_infill`, one hand-written kernel on a card)
  and the collocation solve ``C = Ainv_y @ cleaned @ Ainv_x.T`` run in
  float64 on the device against the cached inverses of
  :func:`_grid_spline_solver` (a plain matrix product, as the JAX package
  leaves it to XLA; an axis whose inverse is exactly the identity, degree
  1, takes no product: its coefficients are the cleaned pixels), then the
  hand-written kernel :func:`.map_spline_kernel.map_spline` evaluates every
  frame, told by :func:`_grid_uniform_knots` that the knots are
  unit-spaced. With the default options nothing of it waits on the card.
- ``spline_smoothing > 0`` or larger sources: scipy's FITPACK solves each
  frame on the host, and the same kernel evaluates it, told by
  :func:`.map_spline_kernel.uniform_knots` whether the knots are
  unit-spaced (at s=0 they are; the adaptive knots of s > 0 are searched).

The NaN conventions are the reference's (body_xy.py:1855-1904): a sample is
NaN when any of its 4 surrounding integer pixels is NaN or it is outside
the grid of pixel centres; non-finite pixels are infilled with 3x3 means
(else the frame's median) before the solve.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from .map_infill_kernel import map_infill
from .map_spline_kernel import map_spline, uniform_knots

#: Largest source side solved on the device (dense inverses of the two
#: collocation matrices); larger sources take the host FITPACK branch, as
#: in the JAX package (interp_device.py:265).
_DEVICE_SOLVE_MAX = 2048


@dataclass(frozen=True)
class MapSamples:
    """
    The map sample coordinates on a device: float64 ``x``, ``y`` flattened
    in map order (0 where not ``valid``), the map ``shape``, and the
    ``limits`` ``(nanmin x, nanmax x, nanmin y, nanmax y)`` of the maps
    (None when no sample is valid).
    """

    x: torch.Tensor
    y: torch.Tensor
    valid: torch.Tensor
    shape: tuple[int, ...]
    limits: tuple[float, float, float, float] | None


def _device_xy(x_map, y_map, device: torch.device) -> MapSamples:
    """
    :class:`MapSamples` of x/y maps (numpy arrays, or float64 tensors on any
    device), on ``device``; no host copy of tensors already there. The
    limits cost one synchronising copy of 4 values.
    """
    x_map = torch.as_tensor(x_map, dtype=torch.float64, device=device)
    y_map = torch.as_tensor(y_map, dtype=torch.float64, device=device)
    valid = torch.isfinite(x_map) & torch.isfinite(y_map)
    x = torch.where(valid, x_map, 0.0)
    y = torch.where(valid, y_map, 0.0)
    inf = torch.full_like(x, torch.inf)
    limits = torch.stack([
        torch.where(valid, x, inf).min(), torch.where(valid, x, -inf).max(),
        torch.where(valid, y, inf).min(), torch.where(valid, y, -inf).max(),
    ]).tolist() if valid.numel() else [torch.inf]
    return MapSamples(
        x=x.ravel(), y=y.ravel(), valid=valid.ravel(),
        shape=tuple(x_map.shape),
        limits=tuple(limits) if math.isfinite(limits[0]) else None,
    )


@functools.lru_cache(maxsize=None)
def _grid_spline_solver(ny: int, nx: int, kx: int, ky: int):
    """
    FITPACK knots of the s=0 interpolating spline on the regular ``(ny,
    nx)`` pixel grid and the dense inverses of the two 1-D B-spline
    collocation matrices, as numpy arrays ``(ty, tx, ainv_y, ainv_x)``.
    ``C = ainv_y @ img @ ainv_x.T`` then reproduces scipy's
    ``RectBivariateSpline(s=0)`` coefficients to rounding error.
    """
    import scipy.interpolate

    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(ny), np.arange(nx), np.zeros((ny, nx)), kx=ky, ky=kx, s=0
    )
    ty, tx = spline.get_knots()
    ay = scipy.interpolate.BSpline.design_matrix(
        np.arange(ny, dtype=float), ty, ky, extrapolate=False
    ).toarray()
    ax = scipy.interpolate.BSpline.design_matrix(
        np.arange(nx, dtype=float), tx, kx, extrapolate=False
    ).toarray()
    return ty, tx, np.linalg.inv(ay), np.linalg.inv(ax)


@functools.lru_cache(maxsize=None)
def _grid_uniform_knots(ny: int, nx: int, kx: int, ky: int):
    """
    ``(y, x)`` :class:`.map_spline_kernel.UniformKnots` of the knots of
    :func:`_grid_spline_solver`, read from its numpy copies (no device
    sync): FITPACK's s=0 knots of a pixel grid are spaced exactly 1 inside
    the clamped ends, so the kernel finds intervals by arithmetic.
    """
    ty, tx, _, _ = _grid_spline_solver(ny, nx, kx, ky)
    return uniform_knots(ty, ky), uniform_knots(tx, kx)


@functools.lru_cache(maxsize=16)
def _device_solver(ny: int, nx: int, kx: int, ky: int,
                   device: torch.device):
    """
    :func:`_grid_spline_solver` as float64 tensors on ``device``, each
    inverse None where it is exactly the identity (a degree-1 axis: its
    coefficients are the pixels, and :func:`_collocation_solve` skips its
    product).
    """
    ty, tx, ainv_y, ainv_x = _grid_spline_solver(ny, nx, kx, ky)
    return (
        torch.from_numpy(ty).to(device), torch.from_numpy(tx).to(device),
        *(None if np.array_equal(a, np.eye(a.shape[0]))
          else torch.from_numpy(a).to(device) for a in (ainv_y, ainv_x)),
    )


def _collocation_solve(cleaned: torch.Tensor, ainv_y, ainv_x):
    """
    ``ainv_y @ (cleaned @ ainv_x.T)`` of the frames ``cleaned``, without
    the product of an axis whose inverse is None (the identity); counts
    each frame's products run (``map.solves``) and skipped
    (``map.solve_skipped``).
    """
    coeffs = cleaned
    n_frames = cleaned.shape[0]
    for ainv, right in ((ainv_x, True), (ainv_y, False)):
        if ainv is None:
            tracing.count('map.solve_skipped', n_frames)
            continue
        coeffs = torch.matmul(coeffs, ainv.T) if right else \
            torch.matmul(ainv, coeffs)
        tracing.count('map.solves', n_frames)
    return coeffs


def _fitpack_coeffs(img, kx, ky, spline_smoothing, warn_nan):
    """Host-side FITPACK solve (reference body_xy.py:1673-1680)."""
    import scipy.interpolate

    from .interp import replace_nans_with_interpolated_values

    cleaned = replace_nans_with_interpolated_values(img, warn_nan)
    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(img.shape[0]),
        np.arange(img.shape[1]),
        cleaned,
        kx=ky,  # scipy's first axis is our y
        ky=kx,
        s=spline_smoothing,
    )
    ty, tx = spline.get_knots()
    c = spline.get_coeffs()
    return ty, tx, c


def spline_interpolation_device(
    img: torch.Tensor, samples: MapSamples, *, interpolation,
    warn_nan: bool, propagate_nan: bool, spline_smoothing: float,
) -> torch.Tensor:
    """
    Spline reprojection of a frame ``(ny, nx)`` or a cube ``(nz, ny, nx)``
    (float64 on the samples' device). Returns float32 shaped like the map
    (or ``(nz,) + map``).
    """
    if isinstance(interpolation, int):
        kx = ky = interpolation
    else:
        # reference semantics (RectBivariateSpline with scipy's first axis
        # = image rows): tuple[0] is the degree along image ROWS
        ky, kx = interpolation
    cube = img.ndim == 3
    frames = img if cube else img[None]
    ny, nx = frames.shape[-2:]
    device = frames.device

    if spline_smoothing == 0 and max(ny, nx) <= _DEVICE_SOLVE_MAX:
        with tracing.span('pm.map.flags'):
            if warn_nan:  # the one read of the card, for the print
                finite = torch.isfinite(frames.reshape(frames.shape[0], -1))
                for ok in finite.all(dim=1).tolist():
                    if not ok:
                        print(
                            'Warning, image contains NaN values which will '
                            'be corrected'
                        )
        ty, tx, ainv_y, ainv_x = _device_solver(ny, nx, kx, ky, device)
        with tracing.span('pm.map.infill'):
            cleaned, nans, finite = map_infill(frames)
        with tracing.span('pm.map.solve'):
            coeffs = _collocation_solve(cleaned, ainv_y, ainv_x)
        with tracing.span('pm.map.spline'):
            vals = map_spline(
                samples.x, samples.y, samples.valid, ty, tx, coeffs,
                nans.view(torch.uint8), kx=kx, ky=ky,
                propagate_nan=propagate_nan,
                uniform=_grid_uniform_knots(ny, nx, kx, ky),
            )
        if not propagate_nan:
            # host semantics: a frame with no finite values maps to NaN
            vals = torch.where((finite == 0)[:, None], torch.nan, vals)
    else:
        # host FITPACK branch (smoothing picks knots per frame)
        host = frames.cpu().numpy()
        vals = torch.full((frames.shape[0], samples.x.shape[0]), torch.nan,
                          dtype=torch.float32, device=device)
        for i, frame in enumerate(host):
            if np.all(np.isnan(frame)):
                continue
            ty, tx, c = _fitpack_coeffs(
                frame, kx, ky, spline_smoothing, warn_nan
            )
            n_cy, n_cx = len(ty) - ky - 1, len(tx) - kx - 1
            vals[i] = map_spline(
                samples.x, samples.y, samples.valid,
                torch.from_numpy(ty).to(device),
                torch.from_numpy(tx).to(device),
                torch.from_numpy(c.reshape(1, n_cy, n_cx)).to(device),
                torch.from_numpy(np.isnan(frame)[None]).to(device),
                kx=kx, ky=ky, propagate_nan=propagate_nan,
                uniform=(uniform_knots(ty, ky), uniform_knots(tx, kx)),
            )[0]
    vals = vals.reshape((frames.shape[0],) + samples.shape)
    return vals if cube else vals[0]


def nearest_interpolation_device(img: torch.Tensor,
                                 samples: MapSamples) -> torch.Tensor:
    """
    Nearest-pixel gather (reference body_xy.py:1633-1649) of a frame or a
    cube, in the image's dtype; NaN where the sample is not valid.
    """
    ny, nx = img.shape[-2:]
    xi = torch.round(samples.x).long().clamp(0, nx - 1)
    yi = torch.round(samples.y).long().clamp(0, ny - 1)
    flat = img.reshape(img.shape[:-2] + (ny * nx,))
    out = torch.where(samples.valid, flat[..., yi * nx + xi], torch.nan)
    return out.reshape(img.shape[:-2] + samples.shape)
