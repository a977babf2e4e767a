"""
The reference's scene of Neptune seen from the Earth, worked out in float64
PyTorch from the analytic orbits and constants of
:mod:`..vendor.synthetic_kernels_neptune`, never from the kernel files, the
port's readers or its caches.

The definitions are :mod:`.scene`'s (SPICE's as planetmapper uses them:
'CN' light time, the sub-observer point by INTERCEPT/ELLIPSOID, the IAU
rotation model), for body 899: its circle beside the frozen Sun and Earth,
and IAU_NEPTUNE with the nutation-precession terms of its pole and prime
meridian (``BODY8_NUT_PREC_ANGLES``). :meth:`Scene.anchors` returns the
per-scene values a map needs, under the keys of :meth:`.scene.Scene.anchors`;
:func:`xy_maps` the pixel coordinates of a rectangular map's samples, each
at its own light-time epoch, as :func:`.maps.xy_maps` does for Jupiter.

Imports numpy and torch only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..vendor import geometry as geom
from ..vendor import synthetic_kernels as sk
from ..vendor import synthetic_kernels_neptune as skn
from . import maps as rm
from . import scene as rs
from .scene import CENTURY, CLIGHT, DAY, DEG, EARTH, F64, SUN, _mv, rotation

NEPTUNE = skn.NEPTUNE
PCK = rs._text_kernel_values(skn.PCK_TEXT)
RADII = PCK['BODY899_RADII']


class Orbits(rs.Orbits):
    """The frozen writer's Sun, Earth and Jupiter, and Neptune's circle
    about the Sun."""

    def __init__(self, seed: int):
        super().__init__(seed)
        self.orbits[NEPTUNE] = (skn.NEPTUNE_A_AU * sk.AU_KM,
                                skn.neptune_phase_deg(seed),
                                skn.NEPTUNE_NODE_DEG, skn.NEPTUNE_INCL_DEG)

    def state(self, body: int, t: torch.Tensor) -> torch.Tensor:
        if body == NEPTUNE:
            return super().state(SUN, t) + self._heliocentric(NEPTUNE, t)
        return super().state(body, t)


class NeptuneFrame:
    """IAU_NEPTUNE: ra, dec and the prime meridian w, each with its
    nutation-precession series in the system's angles."""

    def __init__(self):
        self.ra = PCK['BODY899_POLE_RA']
        self.dec = PCK['BODY899_POLE_DEC']
        self.pm = PCK['BODY899_PM']
        self.angles = torch.tensor(PCK['BODY8_NUT_PREC_ANGLES'],
                                   dtype=F64).reshape(-1, 2)
        n = self.angles.shape[0]

        def padded(key):
            v = PCK[key]
            return torch.tensor(v + [0.0] * (n - len(v)), dtype=F64)[:n]

        self.nut_ra = padded('BODY899_NUT_PREC_RA')
        self.nut_dec = padded('BODY899_NUT_PREC_DEC')
        self.nut_pm = padded('BODY899_NUT_PREC_PM')

    def matrix(self, t: torch.Tensor) -> torch.Tensor:
        """J2000 -> body-fixed, (..., 3, 3):
        R3(W) R1(pi/2 - dec) R3(pi/2 + ra)."""
        T = t / CENTURY
        d = t / DAY
        dev = t.device
        theta = (self.angles[:, 0].to(dev)
                 + self.angles[:, 1].to(dev) * T[..., None]) * DEG
        sin, cos = torch.sin(theta), torch.cos(theta)
        ra = (self.ra[0] + self.ra[1] * T + self.ra[2] * T**2
              + torch.sum(self.nut_ra.to(dev) * sin, -1))
        dec = (self.dec[0] + self.dec[1] * T + self.dec[2] * T**2
               + torch.sum(self.nut_dec.to(dev) * cos, -1))
        w = (self.pm[0] + self.pm[1] * d + self.pm[2] * d**2
             + torch.sum(self.nut_pm.to(dev) * sin, -1))
        return (rotation(w * DEG, 3) @ rotation(math.pi / 2 - dec * DEG, 1)
                @ rotation(math.pi / 2 + ra * DEG, 3))


class Scene(rs.Scene):
    """Neptune from the Earth on the orbits of ``seed``, vectorised over a
    leading axis of epochs."""

    target = NEPTUNE

    def __init__(self, seed: int):
        self.orbits = Orbits(seed)
        self.frame = NeptuneFrame()
        self.radii = torch.tensor(RADII, dtype=F64)

    def anchors(self, et) -> dict[str, torch.Tensor]:
        """The per-scene values of a map (CPU float64 tensors with a
        leading axis of epochs) at TDB epochs ``et``."""
        et = torch.as_tensor(np.asarray(et, dtype=np.float64))
        obs = self.pos(EARTH, et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]

        # apparent target centre, converged Newtonian light time ('CN')
        lt = torch.zeros_like(et)
        for _ in range(4):
            targ = self.pos(NEPTUNE, et - lt)
            lt = geom.norm(targ[..., :3] - obs_pos) / CLIGHT
        target_obsvec = targ[..., :3] - obs_pos
        target_lt = lt

        # sub-observer point, INTERCEPT/ELLIPSOID
        for _ in range(4):
            tau = et - lt
            targ_pos = self.pos(NEPTUNE, tau)[..., :3] - obs_pos
            d = targ_pos / geom.norm(targ_pos, keepdim=True)
            rot = self.frame.matrix(tau)
            o_bf = -_mv(rot, targ_pos)
            s, _found = geom.ray_ellipsoid_intercept(o_bf, _mv(rot, d),
                                                     self.radii)
            sub_targvec = o_bf + s[..., None] * _mv(rot, d)
            lt = s / CLIGHT
        tau0 = et - lt
        sub_rayvec = sub_targvec - o_bf
        sub_obsvec = _mv(self.frame.matrix(tau0).transpose(-1, -2), sub_rayvec)

        def d1(t):
            return torch.func.jvp(self.frame.matrix, (t,),
                                  (torch.ones_like(t),))[1]

        def d2(t):
            return torch.func.jvp(d1, (t,), (torch.ones_like(t),))[1]

        targ0 = self.pos(NEPTUNE, tau0)

        # the camera: J2000 -> (angular x, angular y) about the target
        t_norm = target_obsvec / geom.norm(target_obsvec, keepdim=True)
        _r, ra_angle, _d = geom.rect_to_radec(t_norm)
        m_ra = rotation(ra_angle, 3)
        _r, _a, dec_angle = geom.rect_to_radec(_mv(m_ra, t_norm))
        m_ang = rotation(-dec_angle, 2) @ m_ra

        diameter_arcsec = 2.0 * 3600.0 * torch.rad2deg(
            torch.arcsin(self.radii[0] / (target_lt * CLIGHT)))
        return dict(
            et=et, tau0=tau0, rot0=self.frame.matrix(tau0), rot1=d1(tau0),
            rot2=d2(tau0), targ_pos0=targ0[..., :3], targ_vel0=targ0[..., 3:],
            obs_pos=obs_pos, obs_vel=obs_vel, target_lt=target_lt,
            target_obsvec=target_obsvec, subpoint_targvec=sub_targvec,
            subpoint_rayvec=sub_rayvec, subpoint_obsvec=sub_obsvec,
            subpoint_distance=geom.norm(sub_rayvec), obsvec2angular=m_ang,
            diameter_arcsec=diameter_arcsec,
        )


def xy_maps(sc: Scene, anchors: dict, xy2angular, nx: int, ny: int,
            degree_interval: float, device) -> tuple[torch.Tensor, ...]:
    """``(x, y)`` float64 maps on ``device`` of one epoch's scene: each
    sample's planetographic lon/lat -> surface point -> visible at its own
    light-time epoch -> observer-frame vector -> angular coordinates ->
    pixel, NaN where not visible or outside the frame."""
    lon, lat = rm.lonlat_grid(degree_interval)
    lon = torch.as_tensor(np.deg2rad(lon), dtype=F64, device=device)
    lat = torch.as_tensor(np.deg2rad(lat), dtype=F64, device=device)
    re, _, rp = RADII
    targvec = geom.geodetic_to_rect(-lon, lat, 0.0, re, (re - rp) / re)
    a = {k: v.to(device) for k, v in anchors.items()}

    lt = torch.zeros_like(lon)
    for _ in range(4):
        tau = a['et'] - lt
        m = sc.frame.matrix(tau)
        targ = sc.pos(sc.target, tau)[..., :3] - a['obs_pos']
        point = targ + _mv(m.transpose(-1, -2), targvec)
        lt = geom.norm(point) / CLIGHT
    normal = geom.surface_normal(targvec, sc.radii.to(device))
    visible = torch.sum(normal * -_mv(m, point), dim=-1) > 0.0

    sub = {k: a[k] for k in ('subpoint_targvec', 'subpoint_rayvec',
                             'subpoint_distance', 'subpoint_obsvec', 'tau0')}
    obsvec = sc.targvec2obsvec(targvec, sub)
    ax, ay = rs.Scene._angular(a['obsvec2angular'],
                               obsvec / geom.norm(obsvec, keepdim=True))
    inv = torch.linalg.inv(torch.as_tensor(xy2angular, dtype=F64)).to(device)
    x = inv[0, 0] * ax + inv[0, 1] * ay + inv[0, 2]
    y = inv[1, 0] * ax + inv[1, 1] * ay + inv[1, 2]
    ok = (visible & (x > -0.5) & (x < nx - 0.5)
          & (y > -0.5) & (y < ny - 0.5))
    nan = torch.tensor(math.nan, dtype=F64, device=device)
    return torch.where(ok, x, nan), torch.where(ok, y, nan)
