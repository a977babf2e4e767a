"""
SPK ephemeris segment parsing and float64 PyTorch evaluation.

Segments are parsed once into dense numpy coefficient arrays (the parsers
are the JAX package's, unchanged); evaluation is a PyTorch function of time,
batched over leading axes and differentiable with ``torch.func`` (record
lookup is a closed-form index computation for Chebyshev types).

Supported SPK data types (covering the planetary/satellite/spacecraft kernels
used in practice):

- Type 2: Chebyshev position (velocity = analytic Chebyshev derivative)
- Type 3: Chebyshev position and velocity
- Type 5:  discrete two-body-propagated states
- Type 9/13: Lagrange / Hermite interpolation of discrete states
- Type 10: Space Command two-line elements (SGP4), see ``sgp4.py``
- Type 17: equinoctial elements
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .daf import read_daf


class SpkError(ValueError):
    pass


@dataclass
class SpkSegment:
    """Common SPK segment metadata (one DAF array)."""

    target: int
    center: int
    frame_id: int
    data_type: int
    start_et: float
    end_et: float
    data: Any  # type-specific parsed payload
    source: str = ''

    def covers(self, et: float) -> bool:
        # Small tolerance absorbs last-ulp differences at segment boundaries
        # (kernels are often cut at exactly the epoch of interest).
        eps = 1e-3
        return self.start_et - eps <= et <= self.end_et + eps


@dataclass
class ChebyshevData:
    """Payload of type 2/3 segments."""

    init: float
    intlen: float
    mids: np.ndarray  # (nrec,)
    radii: np.ndarray  # (nrec,)
    coeffs: np.ndarray  # (nrec, ncomp, degree+1); ncomp 3 (type 2) or 6 (type 3)


@dataclass
class EquinoctialData:
    """Payload of type 17 segments (CSPICE ``spkw17`` layout)."""

    epoch: float
    a: float
    h: float
    k: float
    mean_lon: float
    p: float
    q: float
    periapse_rate: float  # d(longitude of periapse)/dt [rad/s]
    mean_lon_rate: float  # d(mean longitude)/dt [rad/s]
    node_rate: float  # d(node)/dt [rad/s]
    ra_pole: float
    dec_pole: float


@dataclass
class TwoBodyData:
    """Payload of type 5 segments: discrete states + GM."""

    gm: float
    epochs: np.ndarray  # (n,)
    states: np.ndarray  # (n, 6)


@dataclass
class LagrangeData:
    """Payload of type 9 (Lagrange) / 13 (Hermite) segments."""

    group: int  # number of knot points per interpolation window
    hermite: bool
    epochs: np.ndarray  # (n,)
    states: np.ndarray  # (n, 6)


@dataclass
class TleData:
    """Payload of type 10 segments: packed two-line element sets."""

    constants: np.ndarray  # J2, J3, J4, KE, QO, SO, ER, AE
    epochs: np.ndarray  # (n,) packet epochs, TDB s past J2000
    packets: np.ndarray  # (n, pktsz)


def _parse_type_2_3(words: np.ndarray, data_type: int) -> ChebyshevData:
    init, intlen, rsize, n = words[-4:]
    rsize = int(rsize)
    n = int(n)
    ncomp = 3 if data_type == 2 else 6
    degree = (rsize - 2) // ncomp
    records = words[: rsize * n].reshape(n, rsize)
    mids = records[:, 0].copy()
    radii = records[:, 1].copy()
    coeffs = records[:, 2:].reshape(n, ncomp, degree).copy()
    return ChebyshevData(float(init), float(intlen), mids, radii, coeffs)


def _parse_type_17(words: np.ndarray) -> EquinoctialData:
    if len(words) < 12:
        raise SpkError('Type 17 segment too short')
    (epoch, a, h, k, mean_lon, p, q, prate, mlrate, nrate, rapol, decpol) = (
        float(v) for v in words[:12]
    )
    return EquinoctialData(
        epoch, a, h, k, mean_lon, p, q, prate, mlrate, nrate, rapol, decpol
    )


def _parse_type_5(words: np.ndarray) -> TwoBodyData:
    # Layout (spkw05): states (6n), epochs (n), epoch directory (n//100),
    # GM, n.
    n = int(words[-1])
    gm = float(words[-2])
    states = words[: 6 * n].reshape(n, 6).copy()
    epochs = words[6 * n : 7 * n].copy()
    return TwoBodyData(gm, epochs, states)


def _parse_type_9_13(words: np.ndarray, data_type: int) -> LagrangeData:
    n = int(words[-1])
    trailer = int(words[-2])
    # The penultimate trailer word differs between the types: type 9
    # stores the polynomial DEGREE (window = degree + 1 points), type 13
    # stores the Hermite WINDOW SIZE directly (spkw13 converts its odd
    # degree argument d to (d + 1) / 2 points before writing; the
    # resulting Hermite polynomial has degree 2 * window - 1).
    hermite = data_type == 13
    group = trailer if hermite else trailer + 1
    states = words[: 6 * n].reshape(n, 6).copy()
    epochs = words[6 * n : 7 * n].copy()
    return LagrangeData(group, hermite, epochs, states)


_NMETA = 17


def _parse_type_10(words: np.ndarray) -> TleData:
    # Generic segment layout (NAIF "generic segments" spec): the final NMETA
    # words are meta items; bases are 0-based offsets from segment start.
    nmeta = int(words[-1])
    if nmeta != _NMETA:
        raise SpkError(f'Unexpected generic segment NMETA {nmeta}')
    meta = [int(v) for v in words[-nmeta:]]
    (conbas, ncon, _rdrbas, _nrdr, _rdrtyp, refbas, nref, _pdrbas, _npdr,
     _pdrtyp, pktbas, npkt, _rsvbas, _nrsv, pktsz, pktoff, _n) = meta
    constants = words[conbas : conbas + ncon].copy()
    epochs = words[refbas : refbas + nref].copy()
    # Each packet allocation is pktoff leading words (the packet epoch)
    # followed by pktsz data words.
    stride = pktsz + pktoff
    packets = words[pktbas : pktbas + npkt * stride].reshape(npkt, stride)
    packets = packets[:, pktoff:].copy()
    return TleData(constants, epochs, packets)


def parse_spk_file(path: str) -> list[SpkSegment]:
    """Parse every segment of an SPK file into evaluatable payloads."""
    daf = read_daf(path)
    segments: list[SpkSegment] = []
    for summary in daf.summaries:
        start_et, end_et = summary.doubles
        target, center, frame_id, data_type, addr0, addr1 = summary.integers
        words = np.asarray(daf.words(addr0, addr1), dtype=np.float64)
        if data_type in (2, 3):
            data = _parse_type_2_3(words, data_type)
        elif data_type == 17:
            data = _parse_type_17(words)
        elif data_type == 5:
            data = _parse_type_5(words)
        elif data_type in (9, 13):
            data = _parse_type_9_13(words, data_type)
        elif data_type == 10:
            data = _parse_type_10(words)
        else:
            # Unsupported type: record it so errors are informative at use time
            data = None
        segments.append(
            SpkSegment(
                target=target,
                center=center,
                frame_id=frame_id,
                data_type=data_type,
                start_et=start_et,
                end_et=end_et,
                data=data,
                source=path,
            )
        )
    return segments


# ---------------------------------------------------------------------------
# PyTorch evaluation (float64)
# ---------------------------------------------------------------------------

def _time(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float64)
    return torch.as_tensor(t, dtype=torch.float64)


def _table(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=torch.float64, device=like.device)


def chebyshev_state(data: ChebyshevData, t):
    """
    Evaluate a type 2/3 Chebyshev segment at (scalar or batched) time ``t``.
    Returns a (..., 6) state [km, km/s]. The record index is computed in
    closed form from the uniform record spacing.
    """
    t = _time(t)
    nrec, ncomp, deg = data.coeffs.shape
    idx = torch.clamp(
        torch.floor((t - data.init) / data.intlen).to(torch.int64),
        0, nrec - 1,
    )
    mid = _table(data.mids, t)[idx]
    radius = _table(data.radii, t)[idx]
    coeffs = _table(data.coeffs, t)[idx]  # (..., ncomp, deg)
    s = (t - mid) / radius  # (...,)

    # Chebyshev polynomials and derivatives by recurrence (deg is static)
    tk = [torch.ones_like(s), s]
    dk = [torch.zeros_like(s), torch.ones_like(s)]
    for k in range(2, deg):
        tk.append(2.0 * s * tk[k - 1] - tk[k - 2])
        dk.append(2.0 * tk[k - 1] + 2.0 * s * dk[k - 1] - dk[k - 2])
    T = torch.stack(tk[:deg], dim=-1)  # (..., deg)
    D = torch.stack(dk[:deg], dim=-1)

    pos = torch.einsum('...cd,...d->...c', coeffs[..., :3, :], T)
    if ncomp == 6:
        vel = torch.einsum('...cd,...d->...c', coeffs[..., 3:, :], T)
    else:
        vel = torch.einsum(
            '...cd,...d->...c', coeffs[..., :3, :], D
        ) / radius[..., None]
    return torch.cat([pos, vel], dim=-1)


def equinoctial_position(data: EquinoctialData, t):
    """
    Position [km] of a type 17 (equinoctial elements) segment at time ``t``,
    in the segment's inertial frame (CSPICE ``eqncpv`` propagation). The
    caller takes the velocity with ``torch.func.jacfwd``, so it is exactly
    consistent with the position model.
    """
    t = _time(t)
    dt = t - data.epoch

    # Precess eccentricity vector (h, k) and node (p, q): longitude of
    # periapse precesses at periapse_rate, the node at node_rate, and
    # (h, k) encode e and longitude of periapse directly
    prec = data.periapse_rate * dt
    h = data.h * torch.cos(prec) + data.k * torch.sin(prec)
    k = data.k * torch.cos(prec) - data.h * torch.sin(prec)
    nprec = data.node_rate * dt
    p = data.p * torch.cos(nprec) + data.q * torch.sin(nprec)
    q = data.q * torch.cos(nprec) - data.p * torch.sin(nprec)

    ml = data.mean_lon + data.mean_lon_rate * dt

    # Solve equinoctial Kepler equation: ml = F + h cos F - k sin F
    F = ml
    for _ in range(10):
        f_val = F + h * torch.cos(F) - k * torch.sin(F) - ml
        f_der = 1.0 - h * torch.sin(F) - k * torch.cos(F)
        F = F - f_val / f_der

    b = 1.0 / (1.0 + torch.sqrt(1.0 - h * h - k * k))
    sf, cf = torch.sin(F), torch.cos(F)
    x = data.a * ((1.0 - h * h * b) * cf + h * k * b * sf - k)
    y = data.a * ((1.0 - k * k * b) * sf + h * k * b * cf - h)

    d = 1.0 + p * p + q * q
    fhat = torch.stack(
        [(1.0 - p * p + q * q) / d, 2.0 * p * q / d, -2.0 * p / d], dim=-1
    )
    ghat = torch.stack(
        [2.0 * p * q / d, (1.0 + p * p - q * q) / d, 2.0 * q / d], dim=-1
    )
    r_plane = x[..., None] * fhat + y[..., None] * ghat

    # Rotate from the equatorial (pole-defined) frame to the inertial frame.
    # Plane frame: z along pole (ra, dec); x along ascending node of the
    # plane on the inertial equator (at RA + 90 deg).
    m = _pole_plane_to_inertial_matrix(data.ra_pole, data.dec_pole)
    return r_plane @ _table(m, t).T


def _pole_plane_to_inertial_matrix(ra: float, dec: float) -> np.ndarray:
    """Rotation taking vectors in the pole-equator frame to the inertial frame."""
    ca, sa = math.cos(ra + math.pi / 2), math.sin(ra + math.pi / 2)
    cd, sd = math.cos(math.pi / 2 - dec), math.sin(math.pi / 2 - dec)
    # M = Rz(-(ra+pi/2)) @ Rx(-(pi/2-dec)): columns are the plane frame's
    # basis vectors expressed in the inertial frame.
    rz = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cd, -sd], [0.0, sd, cd]])
    return rz @ rx


def lagrange_state(data: LagrangeData, t):
    """
    Evaluate a type 9 (Lagrange) or type 13 (Hermite) segment at time ``t``
    over a fixed-size interpolation window gathered around the bracketing
    epoch.

    Returns the full ``(..., 6)`` state for type 9 (velocity knots are
    interpolated directly, matching spke09) and the ``(..., 3)``
    position for type 13 (whose velocity is the Hermite interpolant's
    exact derivative - the caller differentiates with ``torch.func.jvp``).
    """
    t = _time(t)
    epochs = _table(data.epochs, t)
    states = _table(data.states, t)
    n = data.epochs.shape[0]
    group = max(2, min(data.group, n))
    i1 = torch.searchsorted(epochs, t.detach().contiguous())
    first = torch.clamp(i1 - (group + 1) // 2, 0, n - group)
    offsets = torch.arange(group, device=t.device)
    idx = first[..., None] + offsets
    ts = epochs[idx]  # (..., group)
    ss = states[idx]  # (..., group, 6)

    if not data.hermite:
        # Lagrange interpolation of the FULL state: CSPICE spke09
        # interpolates the stored velocity knots directly (the
        # derivative of the position interpolant is a different,
        # generally worse, estimate), so type 9 returns (..., 6)
        result = 0.0
        for j in range(group):
            lj = torch.ones_like(t)
            for m in range(group):
                if m == j:
                    continue
                lj = lj * (t - ts[..., m]) / (ts[..., j] - ts[..., m])
            result = result + lj[..., None] * ss[..., j, :]
        return result
    # Hermite interpolation of position using position+velocity knots;
    # realised by divided differences on doubled nodes.
    result = [
        _hermite_eval(ts, ss[..., c], ss[..., c + 3], t) for c in range(3)
    ]
    return torch.stack(result, dim=-1)


def _hermite_eval(ts, ys, dys, t):
    """Hermite interpolation via Newton divided differences on doubled nodes."""
    group = ts.shape[-1]
    # Doubled nodes z and divided difference table
    z = torch.repeat_interleave(ts, 2, dim=-1)
    n2 = 2 * group
    fz = torch.repeat_interleave(ys, 2, dim=-1)
    # First-order differences: alternate derivative / standard
    d1 = []
    for i in range(n2 - 1):
        if i % 2 == 0:
            d1.append(dys[..., i // 2])
        else:
            d1.append(
                (fz[..., i + 1] - fz[..., i]) / (z[..., i + 1] - z[..., i])
            )
    prev = torch.stack(d1, dim=-1)
    coefs = [fz[..., 0], prev[..., 0]]
    for order in range(2, n2):
        cur = (prev[..., 1:] - prev[..., :-1]) / (
            z[..., order:] - z[..., : n2 - order]
        )
        coefs.append(cur[..., 0])
        prev = cur
    # Horner evaluation of the Newton form
    result = coefs[-1]
    for i in range(n2 - 2, -1, -1):
        result = result * (t - z[..., i]) + coefs[i]
    return result
