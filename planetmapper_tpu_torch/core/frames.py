"""
Body-fixed reference frames (IAU rotation models) as closed-form float64
PyTorch functions of time.

Port of ``planetmapper_tpu.core.frames`` (the replacement for CSPICE's
``pxform``/``pxfrm2``/``tisbod`` machinery, e.g. the per-point light-time
retargeting at reference body.py:917-1006). The IAU orientation model comes
from text PCK constants (``BODYnnn_POLE_RA/POLE_DEC/PM`` plus the system
``NUT_PREC`` terms):

    ra  = ra0 + ra1*T + ra2*T^2 + sum_i a_i * sin(theta_i(T))      [deg]
    dec = dec0 + dec1*T + dec2*T^2 + sum_i d_i * cos(theta_i(T))   [deg]
    w   = w0 + w1*d + w2*d^2 + sum_i w_i * sin(theta_i(T))         [deg]
    theta_i(T) = theta0_i + theta1_i * T                           [deg]

with T = TDB Julian centuries past J2000 and d = TDB days past J2000.
Coordinates transform to the body-fixed frame via

    r_bf = Rz(w) Rx(pi/2 - dec) Rz(pi/2 + ra) r_J2000

The rotation's exact time derivatives come from ``torch.func.jacfwd``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import f64
from ..kernels.pool import KernelPool, KernelVarNotFoundError

DEG = math.pi / 180.0
DAY = 86400.0
CENTURY = 36525.0 * DAY


@dataclass(frozen=True)
class BodyFrameModel:
    """IAU rotation model constants for one body (all angles in degrees)."""

    body_id: int
    pole_ra: tuple[float, float, float]
    pole_dec: tuple[float, float, float]
    pm: tuple[float, float, float]
    nut_angles: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    nut_ra: np.ndarray = field(default_factory=lambda: np.zeros(0))
    nut_dec: np.ndarray = field(default_factory=lambda: np.zeros(0))
    nut_pm: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @classmethod
    def from_pool(cls, pool: KernelPool, body_id: int) -> 'BodyFrameModel':
        def fetch(item: str, default=None):
            try:
                return pool.bodvar(body_id, item)
            except KernelVarNotFoundError:
                if default is not None:
                    return default
                raise

        def coeffs3(item: str) -> tuple[float, float, float]:
            arr = fetch(item)
            out = [0.0, 0.0, 0.0]
            for i, v in enumerate(arr[:3]):
                out[i] = float(v)
            return tuple(out)  # type: ignore[return-value]

        pole_ra = coeffs3('POLE_RA')
        pole_dec = coeffs3('POLE_DEC')
        pm = coeffs3('PM')

        # Nutation-precession angles live under the system barycenter ID
        # (e.g. BODY5_NUT_PREC_ANGLES for the Jovian system).
        system_id = body_id // 100 if body_id >= 100 else body_id
        angles = None
        try:
            angles = pool.bodvar(system_id, 'NUT_PREC_ANGLES')
        except KernelVarNotFoundError:
            pass
        zero = np.zeros(0)
        nut_ra = fetch('NUT_PREC_RA', zero)
        nut_dec = fetch('NUT_PREC_DEC', zero)
        nut_pm = fetch('NUT_PREC_PM', zero)

        if angles is None or (
            len(nut_ra) == 0 and len(nut_dec) == 0 and len(nut_pm) == 0
        ):
            return cls(body_id, pole_ra, pole_dec, pm)

        nut_angles = np.asarray(angles, dtype=np.float64).reshape(-1, 2)
        n = nut_angles.shape[0]

        def pad(arr) -> np.ndarray:
            arr = np.asarray(arr, dtype=np.float64)
            if arr.size < n:
                arr = np.concatenate([arr, np.zeros(n - arr.size)])
            return arr[:n]

        return cls(
            body_id, pole_ra, pole_dec, pm,
            nut_angles=nut_angles,
            nut_ra=pad(nut_ra), nut_dec=pad(nut_dec), nut_pm=pad(nut_pm),
        )

    # -- evaluation -----------------------------------------------------------
    def euler_angles(self, et):
        """(ra, dec, w) in radians at TDB time(s) ``et`` [s past J2000]."""
        et = f64(et) if not isinstance(et, torch.Tensor) else et
        T = et / CENTURY
        d = et / DAY
        ra = self.pole_ra[0] + self.pole_ra[1] * T + self.pole_ra[2] * T**2
        dec = self.pole_dec[0] + self.pole_dec[1] * T + self.pole_dec[2] * T**2
        w = self.pm[0] + self.pm[1] * d + self.pm[2] * d**2
        if self.nut_angles.shape[0]:
            dev = et.device
            theta = (
                f64(self.nut_angles[:, 0], dev)
                + f64(self.nut_angles[:, 1], dev) * T[..., None]
            ) * DEG
            ra = ra + torch.sum(f64(self.nut_ra, dev) * torch.sin(theta), dim=-1)
            dec = dec + torch.sum(
                f64(self.nut_dec, dev) * torch.cos(theta), dim=-1
            )
            w = w + torch.sum(f64(self.nut_pm, dev) * torch.sin(theta), dim=-1)
        return ra * DEG, dec * DEG, w * DEG

    def j2000_to_bodyfixed_matrix(self, et):
        """Rotation matrix: r_bodyfixed = M @ r_J2000. Shape (..., 3, 3)."""
        ra, dec, w = self.euler_angles(et)
        return (
            _rotmat(w, 3)
            @ _rotmat(math.pi / 2.0 - dec, 1)
            @ _rotmat(math.pi / 2.0 + ra, 3)
        )

    def bodyfixed_to_j2000_matrix(self, et):
        return torch.swapaxes(self.j2000_to_bodyfixed_matrix(et), -1, -2)

    def rotate_j2000_to_bodyfixed(self, et, v):
        """
        Apply the J2000 -> body-fixed rotation to vectors ``v`` (..., 3)
        at per-element epochs ``et`` (...) without materialising
        ``(..., 3, 3)`` matrices: three successive axis rotations on the
        vector components.
        """
        ra, dec, w = self.euler_angles(et)
        return _apply_euler_313(ra, dec, w, v, inverse=False)

    def rotate_bodyfixed_to_j2000(self, et, v):
        """Inverse of :func:`rotate_j2000_to_bodyfixed` (same rationale)."""
        ra, dec, w = self.euler_angles(et)
        return _apply_euler_313(ra, dec, w, v, inverse=True)

    def bodyfixed_to_j2000_matrix_deriv(self, et):
        """d/dt of :func:`bodyfixed_to_j2000_matrix` (exact, via jacfwd)."""
        return torch.func.jacfwd(self.bodyfixed_to_j2000_matrix)(f64(et))


def _apply_euler_313(ra, dec, w, v, *, inverse: bool):
    """
    Apply ``R3(w) R1(pi/2 - dec) R3(pi/2 + ra)`` (the IAU body-frame
    rotation, SPICE rotation convention) - or its transpose - to vectors
    ``v`` componentwise. Equivalent to composing the :func:`_rotmat`
    matrices, but with no (..., 3, 3) temporaries.
    """
    vx = v[..., 0]
    vy = v[..., 1]
    vz = v[..., 2]
    sra = torch.sin(ra)
    cra = torch.cos(ra)
    sdec = torch.sin(dec)
    cdec = torch.cos(dec)
    sw = torch.sin(w)
    cw = torch.cos(w)
    if not inverse:
        # R3(pi/2 + ra): cos -> -sin(ra), sin -> cos(ra)
        x1 = -sra * vx + cra * vy
        y1 = -cra * vx - sra * vy
        # R1(pi/2 - dec): cos -> sin(dec), sin -> cos(dec)
        y2 = sdec * y1 + cdec * vz
        z2 = -cdec * y1 + sdec * vz
        # R3(w)
        out_x = cw * x1 + sw * y2
        out_y = -sw * x1 + cw * y2
        out_z = z2
    else:
        # Transpose: R3(-(pi/2 + ra)) R1(-(pi/2 - dec)) R3(-w)
        x1 = cw * vx - sw * vy
        y1 = sw * vx + cw * vy
        y2 = sdec * y1 - cdec * vz
        z2 = cdec * y1 + sdec * vz
        out_x = -sra * x1 - cra * y2
        out_y = cra * x1 - sra * y2
        out_z = z2
    return torch.stack([out_x, out_y, out_z], dim=-1)


def _rotmat(angle, axis: int):
    """SPICE-convention coordinate rotation matrix (batched)."""
    angle = f64(angle) if not isinstance(angle, torch.Tensor) else angle
    c = torch.cos(angle)
    s = torch.sin(angle)
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    if axis == 1:
        rows = [[one, zero, zero], [zero, c, s], [zero, -s, c]]
    elif axis == 2:
        rows = [[c, zero, -s], [zero, one, zero], [s, zero, c]]
    else:
        rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pxfrm2(model: BodyFrameModel, et_from, et_to):
    """
    Position transformation from the body-fixed frame at ``et_from`` to
    J2000 at ``et_to``... J2000 is inertial, so this is simply the
    body-fixed->J2000 matrix at ``et_from``; the two-epoch form mirrors the
    CSPICE call signature used by the reference (body.py:940-946) where the
    'to' frame is the (inertial) observer frame.
    """
    del et_to
    return model.bodyfixed_to_j2000_matrix(et_from)
