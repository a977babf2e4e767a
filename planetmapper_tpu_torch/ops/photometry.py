"""
Aperture photometry and the threshold centroid of ``Observation``'s disc
fits (port of ``planetmapper_tpu.ops.photometry``), as float64 PyTorch on
the image's device.

Exact circular-aperture photometry in closed form: the overlap area of a
circle and each pixel is the 4-corner inclusion-exclusion of the
quarter-plane area ``F(x, y) = A(x) + A(y) - pi r^2 + D(x, y)`` of the
disc, where, with the aperture circle of radius r at the origin,

    A(x) = x*sqrt(r^2 - x^2) + r^2*(asin(x/r) + pi/2)

is the area ``{u <= x}`` (a circular cap) and ``D(x, y)`` the area ``{u >=
x, v >= y}``: for a corner strictly inside the circle a right triangle
against the chord plus a circular segment, for corners outside a full, cap
or zero case by quadrant.

The JAX package evaluates the four corners of every pixel once per radius,
in a host loop over up to 100 radii. Here ``F`` is evaluated once on the
``(ny + 1, nx + 1)`` grid of pixel corners, for a batch of radii at a time
(neighbouring pixels share corners, and a corner's coordinates are the
same float64 values as the JAX package's), and each pixel's fraction is the
difference of its four corners: one batched reduction, chunked so that no
step holds more than :data:`CHUNK_ELEMENTS` values per temporary.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: Largest (radii x corner rows x corner columns) block evaluated at once:
#: 32 MiB per float64 temporary, ~0.5 GiB for the ~15 of ``D(x, y)``
CHUNK_ELEMENTS = 2**22


def _cap_area(x, r):
    """A(x): area of the disc with u <= x (x clipped to [-r, r])."""
    x = torch.minimum(torch.maximum(x, -r), r)
    return x * torch.sqrt(torch.clamp_min(r * r - x * x, 0.0)) + r * r * (
        torch.asin(torch.clamp(x / r, -1.0, 1.0)) + math.pi / 2.0
    )


def _corner_area(x, y, r, area_x):
    """D(x, y): area of the disc with u >= x and v >= y, given ``area_x``,
    the cap area :func:`_cap_area` of ``x``."""
    x = torch.minimum(torch.maximum(x, -r), r)
    y = torch.minimum(torch.maximum(y, -r), r)
    full = math.pi * r * r
    inside = x * x + y * y < r * r

    sx = torch.sqrt(torch.clamp_min(r * r - x * x, 0.0))  # chord at u=x
    sy = torch.sqrt(torch.clamp_min(r * r - y * y, 0.0))
    # Inside-corner region: triangle (x,y),(x,sx),(sy,y) + circular segment
    # between (x, sx) and (sy, y)
    tri = 0.5 * (sx - y) * (sy - x)
    theta = torch.atan2(sx, x) - torch.atan2(y, sy)
    segment = 0.5 * r * r * (theta - torch.sin(theta))
    d_in = tri + segment

    cap_x = full - area_x  # area{u >= x}
    cap_y = full - _cap_area(y, r)  # area{v >= y}
    d_out = torch.where(
        (x >= 0) & (y >= 0),
        0.0,
        torch.where(
            (x < 0) & (y < 0),
            torch.clamp_min(cap_x + cap_y - full, 0.0),
            torch.where(x < 0, cap_y, cap_x),
        ),
    )
    return torch.where(inside, d_in, d_out)


def _corner_coordinates(n: int, centre: float, device) -> torch.Tensor:
    """Pixel edges ``k - 0.5 - centre`` for k = 0..n: the JAX package's
    ``xs - 0.5 - x0`` and ``xs + 0.5 - x0``, bit for bit."""
    return torch.arange(n + 1, dtype=torch.float64, device=device) - 0.5 \
        - centre


def _fractions(x, y, r, area_x):
    """Overlap fractions of the pixels between the corners ``x`` (last
    axis) and ``y`` (the axis before it) with the circle of radius ``r``,
    given the cap areas ``area_x`` of ``x``: the 4-corner
    inclusion-exclusion of ``F(x, y)``, in the JAX package's order."""
    quarter = (area_x + _cap_area(y, r) - math.pi * r * r
               + _corner_area(x, y, r, area_x))
    return (quarter[..., 1:, 1:] - quarter[..., :-1, 1:]
            - quarter[..., 1:, :-1] + quarter[..., :-1, :-1]).clamp(0.0, 1.0)


def circular_aperture_sums(
    img: torch.Tensor, x0: float, y0: float, radii
) -> tuple[np.ndarray, np.ndarray]:
    """
    Exact-overlap circular aperture photometry: ``(sums, areas)`` (numpy
    float64) for apertures of the given radii centred at ``(x0, y0)``, on
    ``img``'s device in float64.
    """
    radii = np.atleast_1d(np.asarray(radii, dtype=float))
    img = img.to(torch.float64)
    device = img.device
    ny, nx = img.shape
    xc = _corner_coordinates(nx, float(x0), device).view(1, 1, nx + 1)
    yc = _corner_coordinates(ny, float(y0), device).view(1, ny + 1, 1)
    r_all = torch.as_tensor(radii, dtype=torch.float64, device=device)
    n_r = max(1, min(len(radii), CHUNK_ELEMENTS // ((ny + 1) * (nx + 1))))
    rows = max(1, min(ny, CHUNK_ELEMENTS // (n_r * (nx + 1)) - 1))
    sums = []
    for i in range(0, len(radii), n_r):
        r = r_all[i:i + n_r].view(-1, 1, 1)
        area_x = _cap_area(xc, r)
        total = torch.zeros(r.shape[0], dtype=torch.float64, device=device)
        for a in range(0, ny, rows):
            b = min(ny, a + rows)
            frac = _fractions(xc, yc[:, a:b + 1], r, area_x)
            total += (img[a:b] * frac).sum(dim=(1, 2))
        sums.append(total)
    return torch.cat(sums).cpu().numpy(), np.pi * radii * radii


def circular_aperture_fractions(
    shape: tuple[int, int], x0: float, y0: float, r: float,
    device: torch.device | str = 'cpu',
) -> torch.Tensor:
    """Exact overlap fraction of each pixel with the circular aperture."""
    ny, nx = shape
    xc = _corner_coordinates(nx, float(x0), device).view(1, nx + 1)
    yc = _corner_coordinates(ny, float(y0), device).view(ny + 1, 1)
    r = torch.tensor(float(r), dtype=torch.float64, device=device)
    return _fractions(xc, yc, r, _cap_area(xc, r))


def _percentile(ordered: torch.Tensor, percent: float) -> torch.Tensor:
    """The ``percent`` percentile of sorted values with linear
    interpolation between the two nearest ranks, as ``jnp.percentile``
    computes it (``torch.quantile`` refuses more than 2^24 values)."""
    q = percent / 100.0 * (ordered.numel() - 1)
    low, high = math.floor(q), math.ceil(q)
    high_weight = q - low
    return ordered[low] * (1.0 - high_weight) + ordered[high] * high_weight


def threshold_centroid(img: torch.Tensor) -> tuple[float, float]:
    """
    Centroid ``(x0, y0)`` of the above-threshold pixels, on ``img``'s
    device in float64.

    The threshold is the mid-point of the image's 5th and 95th percentiles
    and the centroid is the first moment of the binary mask ``img >
    threshold`` - the disc-position estimator of the reference's
    ``fit_disc_position`` (reference observation.py:762-780, which used
    ``scipy.ndimage.center_of_mass``). The moments are sums of whole
    pixel indices, exact in float64.
    """
    img = img.to(torch.float64)
    ordered = torch.sort(img.reshape(-1)).values
    threshold = 0.5 * (_percentile(ordered, 5.0) + _percentile(ordered, 95.0))
    mask = img > threshold
    ny, nx = img.shape
    xs = torch.arange(nx, dtype=torch.float64, device=img.device)
    ys = torch.arange(ny, dtype=torch.float64, device=img.device)
    columns = mask.sum(dim=0).to(torch.float64)
    rows = mask.sum(dim=1).to(torch.float64)
    total = columns.sum()
    x0, y0 = torch.stack([(columns * xs).sum() / total,
                          (rows * ys).sum() / total]).cpu().tolist()
    return x0, y0
