"""
Scene engine: per-(target, observer, time) geometry in float64 PyTorch.

Port of ``planetmapper_tpu.core.scene``. It replaces the CSPICE calls made
throughout ``Body`` in the reference (``subpnt`` body.py:538, ``subslr``
body.py:559, ``sincpt`` body.py:1010, ``illumf`` body.py:1925, ``spkcpt``
body.py:2833, ``et2lst`` body.py:2369, and the per-point ``pxfrm2``
light-time retargeting at body.py:917-1006) with batched tensor functions
over arrays of points.

Each public batched function runs where :func:`.._device.call_device`
puts it: a bulk call (a map or pixel grid, any argument above
:data:`.._device.BULK_ELEMENTS` elements) in float64 on the device of its
tensor arguments, a scalar-sized call on CPU tensors. The scene constants
are scalar and stay on the CPU.

Internally everything works in:

- "obsvec": J2000 rectangular coordinates centred on the observer
- "targvec": body-fixed rectangular coordinates centred on the target

with east-positive longitudes in radians (API layers apply planetographic
sign conventions).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import call_device, f64
from . import geometry as geom
from .ephemeris import (
    CLIGHT,
    SSB,
    Ephemeris,
    _jvp_time,
    parse_abcorr,
    stelab,
)
from .frames import BodyFrameModel


def _matvec(m, v):
    return torch.einsum('...ij,...j->...i', m, v)


def _sub_tensors(sub: dict, device: torch.device) -> dict:
    return {k: f64(v, device) for k, v in sub.items()}


class SceneEngine:
    """
    Batched geometry engine for one (target, observer, frames, abcorr,
    illumination source) configuration. ``et`` is always an argument, so
    one engine serves every observation epoch of that configuration.
    """

    def __init__(
        self,
        ephemeris: Ephemeris,
        *,
        target_id: int,
        observer_id: int,
        illumination_source_id: int,
        radii: tuple[float, float, float],
        frame_model: BodyFrameModel,
        abcorr: str = 'CN',
        et_ref: float = 0.0,
    ) -> None:
        self.ephemeris = ephemeris
        self.target_id = target_id
        self.observer_id = observer_id
        self.illumination_source_id = illumination_source_id
        self.radii = tuple(float(r) for r in radii)
        self.r_eq = self.radii[0]
        self.r_polar = self.radii[2]
        self.flattening = (self.r_eq - self.r_polar) / self.r_eq
        self.frame_model = frame_model
        self.abcorr = str(abcorr).strip().upper()
        self.corr = parse_abcorr(self.abcorr)
        # Epoch retargeting sign: reception corrections evaluate the
        # target at et - lt, transmission ('X*') at et + lt, geometric
        # ('NONE') at et itself (light times are still computed and
        # returned). Stellar aberration rotates by +v/c for reception
        # (stelab) and -v/c for transmission (stlabx).
        self._tau_scale = 0.0 if self.corr.geometric else (
            1.0 if self.corr.reception else -1.0
        )
        self._stelab_vsign = 1.0 if self.corr.reception else -1.0
        self.et_ref = float(et_ref)

        # Chain-frozen SSB state functions (float64 torch in et)
        self._pos_t = ephemeris.position_fn(target_id, SSB, et_ref)
        self._pos_o = ephemeris.position_fn(observer_id, SSB, et_ref)
        if ephemeris.has_data_for(illumination_source_id, et_ref):
            self._pos_s = ephemeris.position_fn(
                illumination_source_id, SSB, et_ref
            )
        else:
            self._pos_s = None

    # ------------------------------------------------------------------
    # Core building blocks
    # ------------------------------------------------------------------
    def _apparent_target_center(self, et):
        """Apparent position of target centre from observer + light time."""
        obs = self._pos_o(et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]
        lt = torch.zeros_like(et)
        n_iter = 3 if self.corr.converged else 1
        if self.corr.geometric:
            n_iter = 0
        targ = None
        for _ in range(n_iter + 1):
            targ = self._pos_t(et - self._tau_scale * lt)
            r = targ[..., :3] - obs_pos
            lt = geom.norm(r) / CLIGHT
        pos = targ[..., :3] - obs_pos
        if self.corr.stellar:
            pos = stelab(pos, self._stelab_vsign * obs_vel / CLIGHT)
        return pos, lt, obs_pos, obs_vel

    def _ray_to_geometric(self, d, obs_vel):
        """
        Convert an apparent ray direction to the geometric direction by
        removing stellar aberration (no-op unless '+S' is active).
        """
        if not self.corr.stellar:
            return d
        return stelab(d, -self._stelab_vsign * obs_vel / CLIGHT)

    def _sincpt_core(self, et, radii, obsvec_norm, lt0):
        """
        Surface intercept of rays from the observer (``sincpt`` equivalent):
        per-ray converged-Newtonian light time, target position and frame
        orientation re-evaluated at each ray's emission epoch.

        Returns ``(targvec, trgepc, found)``; targvec is NaN where the ray
        misses the ellipsoid.
        """
        obs = self._pos_o(et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]
        d = self._ray_to_geometric(obsvec_norm, obs_vel)

        lt = torch.broadcast_to(lt0, d.shape[:-1])
        n_iter = 1 if self.corr.geometric else (4 if self.corr.converged else 1)
        spoint = None
        found = None
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            o_bf = -self.frame_model.rotate_j2000_to_bodyfixed(tau, targ_pos)
            d_bf = self.frame_model.rotate_j2000_to_bodyfixed(
                tau, torch.broadcast_to(d, targ_pos.shape)
            )
            s, found = geom.ray_ellipsoid_intercept(o_bf, d_bf, radii)
            spoint = o_bf + s[..., None] * d_bf
            dist = torch.where(found, s, lt0 * CLIGHT)
            lt = dist / CLIGHT
        trgepc = et - self._tau_scale * lt
        spoint = torch.where(found[..., None], spoint, math.nan)
        return spoint, trgepc, found

    def _illumf_core(self, et, radii, targvec):
        """
        Illumination angles + visibility/lit flags for body-fixed surface
        points (``illumf`` equivalent). Per-point light time epochs for the
        observer ray and for the sun direction.
        """
        obs = self._pos_o(et)
        obs_pos = obs[..., :3]
        # 'LT' needs TWO passes here: the first computes the point light
        # time at tau = et (the loop seeds lt = 0), the second evaluates
        # the geometry at the corrected epoch - one correction, matching
        # CSPICE illumf 'LT'.
        n_iter = 4 if self.corr.converged else 2
        if self.corr.geometric:
            n_iter = 1

        # Light time observer -> surface point
        lt = targvec.new_zeros(targvec.shape[:-1])
        srfvec_j2000 = None
        tau = None
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            point_j2000 = targ_pos + self.frame_model.rotate_bodyfixed_to_j2000(
                tau, targvec
            )
            srfvec_j2000 = point_j2000
            lt = geom.norm(point_j2000) / CLIGHT

        srfvec_bf = self.frame_model.rotate_j2000_to_bodyfixed(
            tau, srfvec_j2000
        )

        # Apparent sun direction from the surface point at epoch tau
        if self._pos_s is not None:
            point_ssb = self._pos_t(tau)[
                ..., :3
            ] + self.frame_model.rotate_bodyfixed_to_j2000(tau, targvec)
            lt_s = targvec.new_zeros(targvec.shape[:-1])
            sun_dir_j2000 = None
            for _ in range(n_iter):
                sun_pos = self._pos_s(tau - self._tau_scale * lt_s)[..., :3]
                sun_dir_j2000 = sun_pos - point_ssb
                lt_s = geom.norm(sun_dir_j2000) / CLIGHT
            sun_dir_bf = self.frame_model.rotate_j2000_to_bodyfixed(
                tau, sun_dir_j2000
            )
        else:
            sun_dir_bf = torch.full_like(targvec, math.nan)

        normal = geom.surface_normal(targvec, radii)
        phase = geom.vector_separation(sun_dir_bf, -srfvec_bf)
        incidence = geom.vector_separation(normal, sun_dir_bf)
        emission = geom.vector_separation(normal, -srfvec_bf)
        visibl = torch.sum(normal * (-srfvec_bf), dim=-1) > 0.0
        lit = torch.sum(normal * sun_dir_bf, dim=-1) > 0.0
        return phase, incidence, emission, visibl, lit

    def _spkcpt_core(self, et, targvec):
        """
        State of constant body-fixed points relative to the observer
        (``spkcpt`` with refloc='OBSERVER'): per-point light-time corrected
        position and velocity (including the frame-rotation contribution and
        the d(lt)/d(et) factor), plus light time.
        """
        obs = self._pos_o(et)
        obs_pos, obs_vel = obs[..., :3], obs[..., 3:]
        n_iter = 4 if self.corr.converged else 1
        if self.corr.geometric:
            n_iter = 1

        def point_state_ssb(tau):
            """Inertial (SSB) state of the body-fixed points at time tau."""
            targ = self._pos_t(tau)
            off, doff = _jvp_time(
                lambda t: self.frame_model.rotate_bodyfixed_to_j2000(
                    t, targvec
                ),
                tau,
            )
            return targ[..., :3] + off, targ[..., 3:] + doff

        lt = targvec.new_zeros(targvec.shape[:-1])
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            p_pos, p_vel = point_state_ssb(tau)
            rel = p_pos - obs_pos
            lt = geom.norm(rel) / CLIGHT
        tau = et - self._tau_scale * lt
        p_pos, p_vel = point_state_ssb(tau)
        rel = p_pos - obs_pos
        dist = geom.norm(rel)
        rhat = rel / dist[..., None]
        if self.corr.geometric:
            vel = p_vel - obs_vel
        else:
            rv_t = torch.sum(rhat * p_vel, dim=-1)
            rv_o = torch.sum(rhat * obs_vel, dim=-1)
            dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
            vel = p_vel * (1.0 - dltdt)[..., None] - obs_vel
        if self.corr.stellar:
            # NOTE the returned velocity omits the (tiny, ~|a_obs| lt/c)
            # derivative of the stellar correction itself
            rel = stelab(rel, self._stelab_vsign * obs_vel / CLIGHT)
        return torch.cat([rel, vel], dim=-1), dist / CLIGHT

    # ------------------------------------------------------------------
    # Reference "model A" transforms: anchored at the sub-observer point
    # (exact mirrors of body.py:917-1006)
    # ------------------------------------------------------------------
    def _targvec2obsvec_core(self, targvec, sub):
        off = targvec - sub['subpoint_targvec']
        dist_offset = (
            geom.norm(sub['subpoint_rayvec'] + off) - sub['subpoint_distance']
        )
        tau = sub['subpoint_et'] - dist_offset / CLIGHT
        rot = self.frame_model.rotate_bodyfixed_to_j2000(tau, off)
        return sub['subpoint_obsvec'] + rot

    def _obsvec2targvec_core(self, obsvec, sub):
        off = obsvec - sub['subpoint_obsvec']
        dist_offset = (
            geom.norm(-sub['subpoint_rayvec'] + off) - sub['subpoint_distance']
        )
        tau = sub['subpoint_et'] - dist_offset / CLIGHT
        rot = self.frame_model.rotate_j2000_to_bodyfixed(tau, off)
        return sub['subpoint_targvec'] + rot

    # ------------------------------------------------------------------
    # Scene constants (Body.__init__ equivalent)
    # ------------------------------------------------------------------
    def scene_constants(self, et: float, radii=None) -> dict:
        """
        All per-scene constants as float64 numpy arrays: apparent target
        centre, sub-observer and sub-solar points, ring plane.
        """
        if radii is None:
            radii = self.radii
        out = self._scene_constants_impl(f64(et), f64(np.asarray(radii)))
        return {k: v.numpy() for k, v in out.items()}

    def _scene_constants_impl(self, et, radii):
        target_obsvec, target_lt, obs_pos, obs_vel = (
            self._apparent_target_center(et)
        )

        # Sub-observer point (method INTERCEPT/ELLIPSOID): the ray is
        # re-aimed at the target centre's position at each refined epoch
        # (CSPICE subpnt's convention).
        n_iter = 1 if self.corr.geometric else (4 if self.corr.converged else 1)
        lt = target_lt
        sub_targvec = None
        o_bf = None
        for _ in range(n_iter):
            tau = et - self._tau_scale * lt
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            if self.corr.stellar:
                # subpnt works entirely in apparent geometry: the target is
                # placed at its stellar-aberration-corrected position and
                # the ray aims at that apparent centre.
                targ_pos = stelab(
                    targ_pos, self._stelab_vsign * obs_vel / CLIGHT
                )
            d = targ_pos / geom.norm(targ_pos)[..., None]
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            o_bf = -_matvec(rot, targ_pos)
            d_bf = _matvec(rot, d)
            s, _found = geom.ray_ellipsoid_intercept(o_bf, d_bf, radii)
            sub_targvec = o_bf + s[..., None] * d_bf
            lt = s / CLIGHT
        sub_et = et - self._tau_scale * lt
        subpoint_rayvec = sub_targvec - o_bf  # observer -> subpoint, bf frame
        subpoint_distance = geom.norm(subpoint_rayvec)
        m_sub = self.frame_model.bodyfixed_to_j2000_matrix(sub_et)
        subpoint_obsvec = _matvec(m_sub, subpoint_rayvec)

        out = dict(
            target_obsvec=target_obsvec,
            target_lt=target_lt,
            obs_pos_ssb=obs_pos,
            obs_vel_ssb=obs_vel,
            subpoint_targvec=sub_targvec,
            subpoint_et=sub_et,
            subpoint_rayvec=subpoint_rayvec,
            subpoint_distance=subpoint_distance,
            subpoint_obsvec=subpoint_obsvec,
        )

        # Sub-solar point: the point where the ray from the sun to the
        # target centre intercepts the surface (SPICE subslr).
        if (
            self._pos_s is not None
            and self.illumination_source_id != self.target_id
        ):
            out.update(self._subslr_impl(et, radii, out))
        else:
            out['subsol_targvec'] = torch.full(
                et.shape + (3,), math.nan, dtype=torch.float64
            )
            out['subsol_et'] = torch.full(et.shape, math.nan,
                                          dtype=torch.float64)

        # Derived scene values (east-positive radians here; the Body layer
        # applies the W/E sign)
        re = radii[0]
        f = (radii[0] - radii[2]) / radii[0]
        lon_sp, lat_sp, _ = geom.rect_to_geodetic(sub_targvec, re, f)
        out['subpoint_lon_e_rad'] = lon_sp
        out['subpoint_lat_rad'] = lat_sp
        _r, ra_sp, dec_sp = geom.rect_to_radec(subpoint_obsvec)
        out['subpoint_ra_rad'] = ra_sp
        out['subpoint_dec_rad'] = dec_sp
        lon_ss, lat_ss, _ = geom.rect_to_geodetic(out['subsol_targvec'], re, f)
        out['subsol_lon_e_rad'] = lon_ss
        out['subsol_lat_rad'] = lat_ss
        # Equatorial (ring) plane in obsvec space (reference body.py:582-588)
        np_obsvec = self._targvec2obsvec_core(
            f64([0.0, 0.0, 1.0]) * radii[2], out
        )
        normal, constant = geom.plane_from_normal_point(
            np_obsvec - target_obsvec, target_obsvec
        )
        out['ring_plane_normal'] = normal
        out['ring_plane_constant'] = constant
        return out

    def _subslr_impl(self, et, radii, consts):
        """
        Sub-solar point, method INTERCEPT/ELLIPSOID (``subslr``): intercept
        on the target of the ray from the sun towards the target's centre,
        with the target epoch matching ``subpnt``'s (et - lt to subpoint).
        """
        n_iter = 4 if self.corr.converged else 1
        obs_pos = consts['obs_pos_ssb']

        # Epoch iteration: trgepc = et - (light time observer -> sub-solar
        # point), exactly as CSPICE subslr converges it.
        tau = consts['subpoint_et']
        spoint = None
        for _ in range(n_iter):
            targ_pos_ssb = self._pos_t(tau)[..., :3]
            # Apparent sun as seen from the target centre at tau
            lt_s = torch.zeros((), dtype=torch.float64)
            sun_vec = None
            for _ in range(n_iter):
                sun_pos = self._pos_s(tau - lt_s)[..., :3]
                sun_vec = sun_pos - targ_pos_ssb
                lt_s = geom.norm(sun_vec) / CLIGHT
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            sun_bf = _matvec(rot, sun_vec)
            d_bf = -sun_bf / geom.norm(sun_bf)[..., None]
            s, found = geom.ray_ellipsoid_intercept(sun_bf, d_bf, radii)
            spoint = torch.where(found[..., None], sun_bf + s[..., None] * d_bf,
                                 math.nan)
            # Distance observer -> sub-solar point sets the next epoch
            m_bf2j = self.frame_model.bodyfixed_to_j2000_matrix(tau)
            spoint_ssb = targ_pos_ssb + _matvec(m_bf2j, spoint)
            dist = geom.norm(spoint_ssb - obs_pos)
            tau = et - dist / CLIGHT
        return dict(subsol_targvec=spoint, subsol_et=tau)

    # ------------------------------------------------------------------
    # Public batched functions (numbers, numpy arrays or tensors in;
    # float64 tensors on the call's device out, see call_device)
    # ------------------------------------------------------------------
    def sincpt(self, et, radii, obsvec_norm, lt0):
        device = call_device(obsvec_norm, lt0)
        return self._sincpt_core(
            f64(et, device), f64(np.asarray(radii), device),
            f64(obsvec_norm, device), f64(lt0, device),
        )

    def illumf(self, et, radii, targvec):
        device = call_device(targvec)
        return self._illumf_core(
            f64(et, device), f64(np.asarray(radii), device),
            f64(targvec, device),
        )

    def spkcpt(self, et, targvec):
        device = call_device(et, targvec)
        return self._spkcpt_core(f64(et, device), f64(targvec, device))

    def targvec2obsvec(self, targvec, sub):
        device = call_device(targvec)
        return self._targvec2obsvec_core(
            f64(targvec, device), _sub_tensors(sub, device)
        )

    def obsvec2targvec(self, obsvec, sub):
        device = call_device(obsvec)
        return self._obsvec2targvec_core(
            f64(obsvec, device), _sub_tensors(sub, device)
        )

    # -- limb (limbpt equivalent) ------------------------------------------
    def limbpt(self, et, radii, rolls, sub):
        device = call_device(rolls)
        return self._limbpt_core(
            f64(et, device), f64(np.asarray(radii), device),
            f64(rolls, device), _sub_tensors(sub, device),
        )

    def _limbpt_core(self, et, radii, rolls, sub):
        """
        Limb points (``limbpt`` with method TANGENT/ELLIPSOID and
        corloc='ELLIPSOID LIMB'): one point per cutting half-plane. The
        half-planes contain the observer-target axis; roll=0 contains the
        reference vector [0,0,1] and roll increases right-handed about the
        axis. Per-point light-time epochs are converged iteratively.

        For an ellipsoid the tangent points are exactly the limb ellipse
        (``edlimb``), so each point is the intersection of that ellipse
        with its half-plane - closed form per iteration, fully batched.
        """
        target_obsvec, _lt, obs_pos, _vel = self._apparent_target_center(et)
        axis = target_obsvec / geom.norm(target_obsvec)
        # CSPICE limbpt expresses refvec in the fixref (body-fixed) frame:
        # [0,0,1] is the spin axis, expressed here in J2000 via the frame
        # rotation at the centre's corrected epoch
        rot_c = self.frame_model.j2000_to_bodyfixed_matrix(sub['subpoint_et'])
        refvec = rot_c[2, :]  # = rot_c^T @ [0,0,1]
        e1 = refvec - torch.sum(refvec * axis) * axis
        e1 = e1 / geom.norm(e1)
        # CSPICE's half-plane axis points target->observer (opposite of
        # ``axis`` here), so positive roll is LEFT-handed about our axis
        e2 = -torch.linalg.cross(axis, e1)
        v_roll = (
            e1 * torch.cos(rolls)[..., None] + e2 * torch.sin(rolls)[..., None]
        )
        plane_normal = torch.linalg.cross(
            torch.broadcast_to(axis, v_roll.shape), v_roll
        )

        tau = torch.zeros_like(rolls) + sub['subpoint_et']
        points = None
        for _ in range(3):
            targ_pos = self._pos_t(tau)[..., :3] - obs_pos
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            o_bf = -_matvec(rot, targ_pos)
            n_bf = _matvec(rot, plane_normal)
            v_bf = _matvec(rot, v_roll)
            center, u, v = geom.limb_ellipse(o_bf, radii)
            # Solve n . (center + u cos t + v sin t - o_bf) = 0
            a_c = torch.sum(n_bf * u, dim=-1)
            b_c = torch.sum(n_bf * v, dim=-1)
            c_c = torch.sum(n_bf * (o_bf - center), dim=-1)
            amp = torch.hypot(a_c, b_c)
            phase0 = torch.atan2(b_c, a_c)
            delta = torch.acos(torch.clamp(c_c / amp, -1.0, 1.0))
            t1 = phase0 + delta
            t2 = phase0 - delta
            q1 = center + u * torch.cos(t1)[..., None] + v * torch.sin(t1)[..., None]
            q2 = center + u * torch.cos(t2)[..., None] + v * torch.sin(t2)[..., None]
            side1 = torch.sum((q1 - o_bf) * v_bf, dim=-1)
            points = torch.where(side1[..., None] >= 0.0, q1, q2)
            dist = geom.norm(points - o_bf)
            tau = et - dist / CLIGHT
        return points

    # -- terminator (termpt equivalent) ------------------------------------
    def termpt(self, et, radii, rolls, sub, umbral: bool = True,
               source_radius: float | None = None):
        if source_radius is None:
            source_radius = self._source_radius()
        device = call_device(rolls)
        return self._termpt_core(
            f64(et, device), f64(np.asarray(radii), device),
            f64(rolls, device), _sub_tensors(sub, device),
            float(source_radius), umbral=umbral,
        )

    def _source_radius(self) -> float:
        try:
            return float(
                self.ephemeris._pool.bodvar(self.illumination_source_id, 'RADII')[0]
            )
        except Exception:
            return 0.0

    def _termpt_core(self, et, radii, rolls, sub, source_radius, *, umbral):
        """
        Terminator points (``termpt`` with method UMBRAL/TANGENT/ELLIPSOID
        or PENUMBRAL/..., corloc='ELLIPSOID TERMINATOR'): the cutting
        half-planes contain the target-source axis. Each point satisfies
        the grazing-ray condition n.s_hat = -/+ sin(angular radius of the
        source), solved by vectorised bisection along each half-plane's
        surface arc, with per-point light-time epochs.
        """
        _, _, obs_pos, _ = self._apparent_target_center(et)

        tau = torch.zeros_like(rolls) + sub['subpoint_et']
        points = None
        for _ in range(3):
            targ_ssb = self._pos_t(tau)[..., :3]
            # Apparent sun from target centre at tau (per point)
            lt_s = torch.zeros_like(rolls)
            sun_vec = None
            for _ in range(3):
                sun_pos = self._pos_s(tau - lt_s)[..., :3]
                sun_vec = sun_pos - targ_ssb
                lt_s = geom.norm(sun_vec) / CLIGHT
            rot = self.frame_model.j2000_to_bodyfixed_matrix(tau)
            sun_bf = _matvec(rot, sun_vec)

            axis = sun_bf / geom.norm(sun_bf, keepdim=True)
            # CSPICE termpt expresses refvec in the fixref (body-fixed)
            # frame: [0,0,1] IS the spin axis - no frame conversion
            ref_bf = torch.zeros_like(sun_bf)
            ref_bf[..., 2] = 1.0
            e1 = ref_bf - torch.sum(ref_bf * axis, dim=-1, keepdim=True) * axis
            e1 = e1 / geom.norm(e1, keepdim=True)
            e2 = torch.linalg.cross(axis, e1)
            v_roll = (
                e1 * torch.cos(rolls)[..., None]
                + e2 * torch.sin(rolls)[..., None]
            )

            def surface_point(psi):
                w = (axis * torch.cos(psi)[..., None]
                     + v_roll * torch.sin(psi)[..., None])
                return geom.radial_surface_point(w, radii)

            def g(psi):
                q = surface_point(psi)
                n = geom.surface_normal(q, radii)
                to_sun = sun_bf - q
                dist_sun = geom.norm(to_sun)
                s_hat = to_sun / dist_sun[..., None]
                sin_alpha = torch.clamp(source_radius / dist_sun, 0.0, 1.0)
                target = -sin_alpha if umbral else sin_alpha
                return torch.sum(n * s_hat, dim=-1) - target

            # Bisection: g decreases from ~+1 at psi=0 (subsolar) to ~-1 at
            # psi=pi (antisolar); exactly one root in between.
            lo = torch.zeros_like(rolls)
            hi = torch.full_like(rolls, math.pi)
            for _ in range(55):
                mid = 0.5 * (lo + hi)
                positive = g(mid) > 0.0
                lo = torch.where(positive, mid, lo)
                hi = torch.where(positive, hi, mid)
            psi = 0.5 * (lo + hi)
            points = surface_point(psi)

            # Light time epoch from the observer to each point
            m_bf2j = torch.swapaxes(rot, -1, -2)
            point_j2000 = (targ_ssb - obs_pos) + _matvec(m_bf2j, points)
            dist = geom.norm(point_j2000)
            tau = et - dist / CLIGHT
        return points

    # -- local solar time --------------------------------------------------
    def solar_longitude(self, et):
        """
        Planetocentric east longitude of the apparent sun (the sub-solar
        meridian used for local solar time, ``et2lst`` equivalent).
        """
        et = f64(et) if not isinstance(et, torch.Tensor) else et
        # Apparent sun from target centre with LT+S (CSPICE et2lst uses the
        # apparent solar position)
        targ_pos_ssb = self._pos_t(et)[..., :3]
        lt_s = torch.zeros_like(et)
        sun_vec = None
        for _ in range(4):
            sun_pos = self._pos_s(et - lt_s)[..., :3]
            sun_vec = sun_pos - targ_pos_ssb
            lt_s = geom.norm(sun_vec) / CLIGHT
        # stellar aberration for an observer at the target centre
        targ_vel_ssb = self._pos_t(et)[..., 3:]
        sun_vec = stelab(sun_vec, targ_vel_ssb / CLIGHT)
        rot = self.frame_model.j2000_to_bodyfixed_matrix(et)
        sun_bf = _matvec(rot, sun_vec)
        return torch.atan2(sun_bf[..., 1], sun_bf[..., 0])
