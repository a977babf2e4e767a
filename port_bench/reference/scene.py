"""
The reference's scene: Jupiter seen from the Earth, worked out in float64
PyTorch from the benchmark's analytic orbits and constants
(:mod:`..vendor.synthetic_kernels`), never from the kernel files, the
port's readers or its caches.

The quantities and their definitions are those of SPICE as planetmapper
uses them ('CN' aberration correction, sub-observer point by
INTERCEPT/ELLIPSOID, the IAU rotation model, ``et2lst``'s apparent sun),
each computed here from the closed-form orbits. :func:`anchors` returns
every epoch's per-scene values with the keys of the plain per-pixel graph
(:mod:`..vendor.backplanes_plain`); :func:`xy2angular` the pixel -> arcsec
affine of a disc.

Imports numpy and torch only.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from ..vendor import geometry as geom
from ..vendor import synthetic_kernels as sk

CLIGHT = 299792.458  # km/s
DEG = math.pi / 180.0
DAY = 86400.0
CENTURY = 36525.0 * DAY
SUN, EARTH, JUPITER = 10, 399, 599
F64 = torch.float64


def _text_kernel_values(text: str) -> dict[str, list[float]]:
    """``NAME = value`` and ``NAME = ( values )`` assignments of a text
    kernel's data blocks (dates, ``@...``, left out)."""
    values = {}
    for name, body in re.findall(r'(\S+)\s*=\s*(\([^)]*\)|\S+)', text):
        values[name] = [float(v.replace('D', 'E'))
                        for v in body.strip('()').replace(',', ' ').split()
                        if not v.startswith('@')]
    return values


PCK = _text_kernel_values(sk._PCK_TEXT)
LSK = _text_kernel_values(sk._LSK_TEXT.replace('{table}', ''))


def utc_to_et(year: int, month: int, day: int, hour: int = 0,
              minute: int = 0, sec: float = 0.0) -> float:
    """TDB seconds past J2000 of a UTC date (the LSK's ``DELTET`` chain)."""
    raw = sk.calendar_to_j2000_seconds(year, month, day, hour, minute, sec)
    delta_at = 0.0
    for value, date in sk._LEAP_SECONDS:
        y, mon, d = date.split('-')
        epoch = sk.calendar_to_j2000_seconds(
            int(y), ['JAN', 'JUL'].index(mon) * 6 + 1, int(d))
        if raw >= epoch:
            delta_at = float(value)
    tai = raw + delta_at
    k = LSK['DELTET/K'][0]
    eb = LSK['DELTET/EB'][0]
    m0, m1 = LSK['DELTET/M']
    et = tai + LSK['DELTET/DELTA_T_A'][0]
    for _ in range(3):
        m = m0 + m1 * et
        et = tai + LSK['DELTET/DELTA_T_A'][0] + k * math.sin(m + eb * math.sin(m))
    return et


def _rot_x(a: float) -> torch.Tensor:
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[1.0, 0, 0], [0, c, -s], [0, s, c]], dtype=F64)


def _rot_z(a: float) -> torch.Tensor:
    c, s = math.cos(a), math.sin(a)
    return torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1.0]], dtype=F64)


class Orbits:
    """Barycentric J2000 states of the Sun, the Earth and Jupiter: the
    circles that the benchmark's SPK samples, evaluated at any epoch."""

    def __init__(self, seed: int):
        jitter = np.random.default_rng(seed).uniform(-0.5, 0.5, size=2)
        self.t_ref = sk.calendar_to_j2000_seconds(2005, 1, 1)
        node = 100.464
        self.orbits = {
            EARTH: (sk.AU_KM, 100.5 + float(jitter[0]), 0.0, 0.0),
            JUPITER: (5.2026 * sk.AU_KM, 190.0 - node + float(jitter[1]),
                      node, 1.303),
        }
        self.mu = sk.JUPITER_SUN_MASS_RATIO

    def _heliocentric(self, body: int, t: torch.Tensor) -> torch.Tensor:
        a_km, u0_deg, node_deg, incl_deg = self.orbits[body]
        n = math.sqrt(sk.GM_SUN / a_km**3)
        u = math.radians(u0_deg) + n * (t - self.t_ref)
        zero = torch.zeros_like(u)
        pos = a_km * torch.stack([torch.cos(u), torch.sin(u), zero], -1)
        vel = a_km * n * torch.stack([-torch.sin(u), torch.cos(u), zero], -1)
        m = (_rot_x(math.radians(sk.OBLIQUITY_DEG))
             @ _rot_z(math.radians(node_deg)) @ _rot_x(math.radians(incl_deg)))
        m = m.to(t.device)
        return torch.cat([pos @ m.T, vel @ m.T], dim=-1)

    def state(self, body: int, t: torch.Tensor) -> torch.Tensor:
        """(..., 6) position [km] and velocity [km/s] at TDB ``t``."""
        jupiter = self._heliocentric(JUPITER, t)
        sun = -self.mu / (1.0 + self.mu) * jupiter
        if body == SUN:
            return sun
        if body == JUPITER:
            return sun + jupiter
        return sun + self._heliocentric(EARTH, t)


class JupiterFrame:
    """The IAU_JUPITER rotation model of the benchmark's PCK."""

    def __init__(self):
        self.ra = PCK['BODY599_POLE_RA']
        self.dec = PCK['BODY599_POLE_DEC']
        self.pm = PCK['BODY599_PM']
        self.angles = torch.tensor(PCK['BODY5_NUT_PREC_ANGLES'],
                                   dtype=F64).reshape(-1, 2)
        n = self.angles.shape[0]

        def padded(key):
            v = PCK.get(key, [])
            return torch.tensor(v + [0.0] * (n - len(v)), dtype=F64)[:n]

        self.nut_ra = padded('BODY599_NUT_PREC_RA')
        self.nut_dec = padded('BODY599_NUT_PREC_DEC')

    def matrix(self, t: torch.Tensor) -> torch.Tensor:
        """J2000 -> body-fixed, (..., 3, 3):
        R3(W) R1(pi/2 - dec) R3(pi/2 + ra)."""
        T = t / CENTURY
        d = t / DAY
        theta = (self.angles[:, 0].to(t.device)
                 + self.angles[:, 1].to(t.device) * T[..., None]) * DEG
        ra = (self.ra[0] + self.ra[1] * T + self.ra[2] * T**2
              + torch.sum(self.nut_ra.to(t.device) * torch.sin(theta), -1))
        dec = (self.dec[0] + self.dec[1] * T + self.dec[2] * T**2
               + torch.sum(self.nut_dec.to(t.device) * torch.cos(theta), -1))
        w = self.pm[0] + self.pm[1] * d + self.pm[2] * d**2
        return (rotation(w * DEG, 3) @ rotation(math.pi / 2 - dec * DEG, 1)
                @ rotation(math.pi / 2 + ra * DEG, 3))


def rotation(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """SPICE's ``rotate``: the frame rotated by ``angle`` about ``axis``."""
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rows = {1: [[one, zero, zero], [zero, c, s], [zero, -s, c]],
            2: [[c, zero, -s], [zero, one, zero], [s, zero, c]],
            3: [[c, s, zero], [-s, c, zero], [zero, zero, one]]}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _mv(m, v):
    return torch.einsum('...ij,...j->...i', m, v)


def _stelab(pos, vbyc):
    """SPICE's stellar aberration: ``pos`` rotated towards ``vbyc`` by the
    aberration angle."""
    u = pos / geom.norm(pos, keepdim=True)
    h = torch.linalg.cross(u, vbyc)
    sinphi = geom.norm(h, keepdim=True)
    phi = torch.asin(torch.clamp(sinphi, -1.0, 1.0))
    axis = h / torch.where(sinphi > 0, sinphi, torch.ones_like(sinphi))
    return (pos * torch.cos(phi) + torch.linalg.cross(axis, pos) * torch.sin(phi)
            + axis * torch.sum(axis * pos, -1, keepdim=True)
            * (1.0 - torch.cos(phi)))


RADII = PCK['BODY599_RADII']


class Scene:
    """Jupiter from the Earth on the orbits of ``seed``: every epoch's
    per-scene values, vectorised over a leading axis of epochs."""

    def __init__(self, seed: int):
        self.orbits = Orbits(seed)
        self.frame = JupiterFrame()
        self.radii = torch.tensor(RADII, dtype=F64)

    def pos(self, body, t):
        return self.orbits.state(body, t)

    def anchors(self, et) -> dict[str, torch.Tensor]:
        """The per-scene values (CPU float64 tensors with a leading axis
        of epochs) at TDB epochs ``et``."""
        et = torch.as_tensor(np.asarray(et, dtype=np.float64))
        radii = self.radii
        obs = self.pos(EARTH, et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]

        # apparent target centre, converged Newtonian light time ('CN')
        lt = torch.zeros_like(et)
        for _ in range(4):
            targ = self.pos(JUPITER, et - lt)
            lt = geom.norm(targ[..., :3] - obs_pos) / CLIGHT
        target_obsvec = targ[..., :3] - obs_pos
        target_lt = lt

        # sub-observer point, INTERCEPT/ELLIPSOID: the ray re-aimed at the
        # centre at each refined epoch
        lt = target_lt
        for _ in range(4):
            tau = et - lt
            targ_pos = self.pos(JUPITER, tau)[..., :3] - obs_pos
            d = targ_pos / geom.norm(targ_pos, keepdim=True)
            rot = self.frame.matrix(tau)
            o_bf = -_mv(rot, targ_pos)
            s, _found = geom.ray_ellipsoid_intercept(o_bf, _mv(rot, d), radii)
            sub_targvec = o_bf + s[..., None] * _mv(rot, d)
            lt = s / CLIGHT
        tau0 = et - lt
        sub_rayvec = sub_targvec - o_bf
        sub_distance = geom.norm(sub_rayvec)
        sub_obsvec = _mv(self.frame.matrix(tau0).transpose(-1, -2), sub_rayvec)
        sub = dict(subpoint_targvec=sub_targvec, subpoint_rayvec=sub_rayvec,
                   subpoint_distance=sub_distance, subpoint_obsvec=sub_obsvec,
                   tau0=tau0)

        # equatorial (ring) plane through the centre, its normal towards
        # the north pole
        np_obsvec = self.targvec2obsvec(
            torch.tensor([0.0, 0.0, RADII[2]], dtype=F64), sub)
        normal, constant = geom.plane_from_normal_point(
            np_obsvec - target_obsvec, target_obsvec)

        # the frame and its first two time derivatives at tau0
        def matrix(t):
            return self.frame.matrix(t)

        def d1(t):
            return torch.func.jvp(matrix, (t,), (torch.ones_like(t),))[1]

        def d2(t):
            return torch.func.jvp(d1, (t,), (torch.ones_like(t),))[1]

        targ0 = self.pos(JUPITER, tau0)
        lt_s = torch.zeros_like(tau0)
        for _ in range(4):
            sun = self.pos(SUN, tau0 - lt_s)
            lt_s = geom.norm(sun[..., :3] - targ0[..., :3]) / CLIGHT
        sun_epoch = tau0 - lt_s
        sun = self.pos(SUN, sun_epoch)

        # et2lst's sun: apparent (LT+S) from the centre at et - lt
        t_lst = et - target_lt
        targ_lst = self.pos(JUPITER, t_lst)
        lt_s = torch.zeros_like(t_lst)
        for _ in range(4):
            sun_vec = self.pos(SUN, t_lst - lt_s)[..., :3] - targ_lst[..., :3]
            lt_s = geom.norm(sun_vec) / CLIGHT
        sun_vec = _stelab(sun_vec, targ_lst[..., 3:] / CLIGHT)
        sun_bf = _mv(self.frame.matrix(t_lst), sun_vec)
        solar_lon = torch.atan2(sun_bf[..., 1], sun_bf[..., 0])

        # the camera: J2000 -> (angular x, angular y) about the target
        t_norm = target_obsvec / geom.norm(target_obsvec, keepdim=True)
        _r, ra_angle, _d = geom.rect_to_radec(t_norm)
        m_ra = rotation(ra_angle, 3)
        _r, _a, dec_angle = geom.rect_to_radec(_mv(m_ra, t_norm))
        m_ang = rotation(-dec_angle, 2) @ m_ra

        distance = target_lt * CLIGHT
        diameter_arcsec = 2.0 * 3600.0 * torch.rad2deg(
            torch.arcsin(radii[0] / distance))
        km_per_arcsec = 2.0 * radii[0] / diameter_arcsec
        np_x, np_y = self._angular(m_ang, np_obsvec)
        t_x, t_y = self._angular(m_ang, t_norm)
        theta = -torch.atan2(t_x - np_x, np_y - t_y)  # north-pole angle
        c, s = torch.cos(theta), torch.sin(theta)
        angular2km = torch.stack([torch.stack([c, -s], -1),
                                  torch.stack([s, c], -1)], -2) \
            * km_per_arcsec[..., None, None]

        return dict(
            et=et, tau0=tau0,
            rot0=matrix(tau0), rot1=d1(tau0), rot2=d2(tau0),
            targ_pos0=targ0[..., :3], targ_vel0=targ0[..., 3:],
            obs_pos=obs_pos, obs_vel=obs_vel,
            sun_pos0=sun[..., :3], sun_vel0=sun[..., 3:], sun_epoch0=sun_epoch,
            target_lt=target_lt, target_obsvec=target_obsvec,
            subpoint_targvec=sub_targvec, subpoint_rayvec=sub_rayvec,
            subpoint_obsvec=sub_obsvec, subpoint_distance=sub_distance,
            ring_plane_normal=normal, ring_plane_constant=constant,
            solar_lon_e=solar_lon, obsvec2angular=m_ang,
            angular2km=angular2km, diameter_arcsec=diameter_arcsec,
        )

    def targvec2obsvec(self, targvec, sub):
        """Body-fixed -> observer-frame vectors, each offset from the
        sub-observer point rotated at its own light-time epoch."""
        off = targvec - sub['subpoint_targvec']
        dist_offset = (geom.norm(sub['subpoint_rayvec'] + off)
                       - sub['subpoint_distance'])
        tau = sub['tau0'] - dist_offset / CLIGHT
        m = self.frame.matrix(tau).transpose(-1, -2)
        return sub['subpoint_obsvec'] + _mv(m, off)

    @staticmethod
    def _angular(m_ang, v):
        """Observer-frame vectors -> angular coordinates [arcsec]."""
        _r, xr, yr = geom.rect_to_radec(_mv(m_ang, v))
        x = torch.remainder(-torch.rad2deg(xr), 360.0)
        x = torch.where(x > 180.0, x - 360.0, x)
        return x * 3600.0, torch.rad2deg(yr) * 3600.0


def xy2angular(disc, diameter_arcsec) -> torch.Tensor:
    """
    The pixel -> angular [arcsec] affine (3x3, over a leading axis of
    epochs) of a disc ``(x0, y0, r0, rotation [deg])``: the plate scale
    puts the equatorial diameter across ``2 r0`` pixels.
    """
    x0, y0, r0, rotation_deg = (float(v) for v in disc)
    scale = diameter_arcsec / (2.0 * r0)
    a = -math.radians(rotation_deg)
    c, s = math.cos(a), math.sin(a)
    m = torch.zeros(scale.shape + (3, 3), dtype=F64)
    m[..., 0, 0] = scale * c
    m[..., 0, 1] = scale * s
    m[..., 1, 0] = -scale * s
    m[..., 1, 1] = scale * c
    m[..., 0, 2] = -(m[..., 0, 0] * x0 + m[..., 0, 1] * y0)
    m[..., 1, 2] = -(m[..., 1, 0] * x0 + m[..., 1, 1] * y0)
    m[..., 2, 2] = 1.0
    return m
