"""
Fused backplane pipeline: every default backplane in one pass over the
pixel grid (port of ``planetmapper_tpu.pipeline``).

- **Anchors.** :func:`compute_scene_anchors` reduces a body's scene to ~25
  float64 values at the sub-observer epoch: positions, velocities, and the
  frame rotation with its first two time derivatives (``torch.func``).
  Per-pixel light-time retargeting then uses Taylor expansion about these
  anchors instead of re-evaluating ephemerides per pixel.
- **Two implementations of one contract** ``impl(nx, ny, xy2angular, disc,
  radii, anchors, row0=0.0) -> dict`` of the 26 planes of
  :data:`.ops.backplanes_kernel.PLANE_ORDER`:

  - the hand-written CUDA kernel (:mod:`.ops.backplanes_kernel`,
    ``csrc/backplanes.cu``), taken on a CUDA device where the JAX package
    would take its Pallas kernel on a TPU;
  - :func:`fused_backplanes_fn`, the plain float64 PyTorch graph (the JAX
    package's ``precision='double'`` graph), taken on CPU tensors and for
    body shapes the kernel's geodetic solve cannot hold. It is also the
    kernel's reference on the card. At the default precision ``'mixed'``
    it reports LON-CENTRIC in [0, 360) like the kernel, so CPU and CUDA
    bodies agree without a wrap.

:func:`select_pipeline_impl` picks one; every caller then makes one call,
``impl.frames(nx, ny, xy2angulars, discs, radii, anchors, *, device,
row0=0.0)``, on host float64 values of N >= 1 frames
(:func:`pipeline_inputs` reads them from a body), which returns (N, ny, nx)
planes: the single call takes one frame, :func:`compute_backplanes_batch`
N disc sets over one body's anchors, and the time series of
:mod:`.parallel.timeseries` batch the anchors themselves over epochs
(:func:`_anchor_core` is elementwise over any leading time axis).

The JAX package's progressive cold start, AOT prewarm, session warm thread
and shape buckets exist for a remote TPU compile service and have no
counterpart here: ``precompile`` builds and loads the CUDA library, and
:func:`wait_for_steady_state` returns once it is loaded.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from . import host_slots, tracing
from ._device import f64
from .core import geometry as geom
from .core.ephemeris import CLIGHT

DEG = math.pi / 180.0

#: Numeric mode, read like the JAX package's (``PLANETMAPPER_TPU_PRECISION``).
#: ``'mixed'`` (default) lets a CUDA device run the kernel; ``'double'``
#: pins the plain float64 graph everywhere.
DEFAULT_PRECISION = os.environ.get('PLANETMAPPER_TPU_PRECISION', 'mixed')

#: Anchor keys and shapes (the contract with ``anchors_from_numpy``).
ANCHOR_SHAPES: dict[str, tuple[int, ...]] = dict(
    et=(), tau0=(),
    rot0=(3, 3), rot1=(3, 3), rot2=(3, 3),
    targ_pos0=(3,), targ_vel0=(3,),
    obs_pos=(3,), obs_vel=(3,),
    sun_pos0=(3,), sun_vel0=(3,), sun_epoch0=(),
    target_lt=(), target_obsvec=(3,),
    subpoint_targvec=(3,), subpoint_rayvec=(3,),
    subpoint_obsvec=(3,), subpoint_distance=(),
    ring_plane_normal=(3,), ring_plane_constant=(),
    solar_lon_e=(),
    obsvec2angular=(3, 3), angular2km=(2, 2),
)


def frame_inputs(xy2angulars, discs) -> tuple[np.ndarray, np.ndarray]:
    """The (N, 3, 3) affines and (N, 4) discs of N >= 1 frames, float64."""
    a = np.array(xy2angulars, dtype=np.float64)
    disc = np.array(discs, dtype=np.float64)
    if (a.ndim != 3 or a.shape[1:] != (3, 3) or disc.shape != (len(a), 4)
            or not len(a)):
        raise ValueError(f'xy2angulars must be (N, 3, 3) and discs (N, 4) '
                         f'with N >= 1, got {a.shape} and {disc.shape}')
    return a, disc


def _time_derivative(fn):
    """``t -> d fn / d t`` by forward mode, elementwise over ``t``'s axes."""
    def derivative(t):
        return torch.func.jvp(fn, (t,), (torch.ones_like(t),))[1]

    return derivative


def _anchor_core(engine, et, tau0, target_lt) -> dict[str, torch.Tensor]:
    """
    Time-dependent anchor values (float64 tensors), elementwise over any
    leading axes of ``et``, ``tau0`` and ``target_lt`` (one epoch, or a
    time series).
    """
    rot_fn = engine.frame_model.j2000_to_bodyfixed_matrix
    r0 = rot_fn(tau0)
    r1 = _time_derivative(rot_fn)(tau0)
    r2 = _time_derivative(_time_derivative(rot_fn))(tau0)
    targ_state = engine._pos_t(tau0)
    obs_state = engine._pos_o(et)
    if engine._pos_s is not None:
        lt_s = torch.zeros_like(tau0)
        for _ in range(4):
            sun_state = engine._pos_s(tau0 - lt_s)
            lt_s = geom.norm(sun_state[..., :3] - targ_state[..., :3]) / CLIGHT
        sun_epoch = tau0 - lt_s
        sun_state = engine._pos_s(sun_epoch)
    else:
        sun_epoch = tau0
        sun_state = torch.full(tau0.shape + (6,), math.nan,
                               dtype=torch.float64, device=tau0.device)
    solar_lon = engine.solar_longitude(et - target_lt)
    return dict(
        rot0=r0, rot1=r1, rot2=r2,
        targ_state=targ_state, obs_state=obs_state,
        sun_state=sun_state, sun_epoch=sun_epoch, solar_lon=solar_lon,
    )


def compute_scene_anchors(body) -> dict[str, np.ndarray]:
    """
    Anchor values of a body's scene as float64 numpy arrays: positions,
    velocities and frame rotation derivatives at the sub-observer epoch.
    Same keys and values as ``planetmapper_tpu.pipeline.compute_scene_anchors``.
    """
    core = _anchor_core(
        body._engine, f64(body.et), f64(body._subpoint_et),
        f64(body.target_light_time),
    )
    core = {k: v.numpy() for k, v in core.items()}
    targ_state = core['targ_state']
    obs_state = core['obs_state']
    sun_state = core['sun_state']

    sub = body._sub_consts()
    return dict(
        et=np.float64(body.et),
        tau0=np.float64(body._subpoint_et),
        rot0=core['rot0'],
        rot1=core['rot1'],
        rot2=core['rot2'],
        targ_pos0=targ_state[..., :3],  # target SSB position at tau0
        targ_vel0=targ_state[..., 3:],
        obs_pos=obs_state[..., :3],  # observer SSB position at et
        obs_vel=obs_state[..., 3:],
        sun_pos0=sun_state[..., :3],
        sun_vel0=sun_state[..., 3:],
        sun_epoch0=np.float64(core['sun_epoch']),
        target_lt=np.float64(body.target_light_time),
        target_obsvec=np.asarray(body._target_obsvec),
        subpoint_targvec=np.asarray(sub['subpoint_targvec']),
        subpoint_rayvec=np.asarray(sub['subpoint_rayvec']),
        subpoint_obsvec=np.asarray(sub['subpoint_obsvec']),
        subpoint_distance=np.float64(sub['subpoint_distance']),
        ring_plane_normal=np.asarray(body._ring_plane[0]),
        ring_plane_constant=np.float64(body._ring_plane[1]),
        solar_lon_e=np.float64(core['solar_lon']),
        obsvec2angular=np.asarray(body._get_obsvec2angular_matrix()),
        angular2km=np.asarray(body._get_angular2km_matrix()),
    )


def anchors_from_numpy(
    anchors: dict[str, np.ndarray], device: str | torch.device
) -> dict[str, torch.Tensor]:
    """
    The numpy anchor dict of either package's ``compute_scene_anchors`` as
    float64 tensors on ``device`` (the form both implementations take).
    """
    out = {}
    for key, shape in ANCHOR_SHAPES.items():
        value = f64(np.asarray(anchors[key], dtype=np.float64), device)
        if tuple(value.shape) != shape:
            raise ValueError(
                f'anchor {key!r} has shape {tuple(value.shape)}, '
                f'expected {shape}'
            )
        out[key] = value
    return out


def _matvec(m, v):
    """(..., 3, 3) @ (..., 3), summed in index order."""
    return (
        m[..., :, 0] * v[..., None, 0]
        + m[..., :, 1] * v[..., None, 1]
        + m[..., :, 2] * v[..., None, 2]
    )


def _rot_at(anchors, dtau):
    """Frame rotation J2000->body-fixed at tau0 + dtau (2nd order Taylor)."""
    dt = dtau[..., None, None]
    return anchors['rot0'] + anchors['rot1'] * dt + 0.5 * anchors['rot2'] * dt**2


def _rot_dot_at(anchors, dtau):
    return anchors['rot1'] + anchors['rot2'] * dtau[..., None, None]


def rect_to_geodetic_surface(v, re, f, n_iter: int = 1):
    """
    Geodetic conversion for points on (or very near) the spheroid surface:
    the closed-form latitude of the surface normal plus one Bowring step
    for the small off-surface offsets of triaxial intercepts.
    """
    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    rp = re * (1.0 - f)
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    lon = torch.atan2(y, x)
    rho = torch.hypot(x, y)
    omf2 = (1.0 - f) * (1.0 - f)
    lat = torch.atan2(z, rho * omf2)  # exact for on-surface points
    for _ in range(n_iter):
        beta = torch.atan2((1.0 - f) * torch.sin(lat), torch.cos(lat))
        sb = torch.sin(beta)
        cb = torch.cos(beta)
        lat = torch.atan2(z + ep2 * rp * sb**3, rho - e2 * re * cb**3)
    sin_lat = torch.sin(lat)
    cos_lat = torch.cos(lat)
    n = re / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    alt = rho * cos_lat + z * sin_lat - n * (1.0 - e2 * sin_lat * sin_lat)
    return lon, lat, alt


def _obsvec2targvec_lin(anchors, obsvec):
    """Model-A obsvec->targvec transform with linearised rotation."""
    off = obsvec - anchors['subpoint_obsvec']
    dist_offset = (
        geom.norm(-anchors['subpoint_rayvec'] + off)
        - anchors['subpoint_distance']
    )
    dtau = (anchors['tau0'] - dist_offset / CLIGHT) - anchors['tau0']
    rot = _rot_at(anchors, dtau)
    return anchors['subpoint_targvec'] + _matvec(rot, off)


def fused_backplanes_fn(
    *, positive_west: bool, prograde: bool, have_sun: bool,
    optimize_speed: bool = True, precision: str = 'double',
    robust_geodetic: bool = False,
):
    """
    The plain float64 PyTorch graph of all 26 backplanes: the port of
    ``planetmapper_tpu.pipeline.fused_backplanes_fn(precision='double')``
    and the reference of the CUDA kernel. Returns
    ``impl(nx, ny, xy2angular, disc, radii, anchors, row0=0.0) -> dict`` of
    float64 tensors on the device of ``radii``.

    The arithmetic is float64 at either ``precision``. ``'double'`` reports
    LON-CENTRIC in (-180, 180], as the JAX package's ``precision='double'``
    graph does; ``'mixed'`` (the default of :func:`select_pipeline_impl`)
    reports it in [0, 360), as the JAX package's mixed graph and the CUDA
    kernel do. The JAX package's float32 ``'mixed'`` arithmetic is a TPU
    formulation; on a GPU its role is the kernel's.

    ``robust_geodetic``: triaxial bodies (middle axis != re) put intercept
    points inside the biaxial (re, rp) spheroid, where the on-surface
    conversion diverges; they take the exact nearest-point solve.

    ``impl.frames`` is the kernel's call (:mod:`.ops.backplanes_kernel`)
    on the graph: host float64 values of N frames, each anchor shared or
    per frame, the graph run frame by frame on ``device``.
    """
    if precision not in ('double', 'mixed'):
        raise ValueError(
            f"precision must be 'double' or 'mixed', got {precision!r}"
        )
    lon_sign = -1.0 if positive_west else 1.0
    spin_sign = 1.0 if prograde else -1.0

    def impl(nx, ny, xy2angular, disc, radii, anchors, row0=0.0):
        from .body import lst_quantization_enabled

        dev = radii.device
        et = anchors['et']
        tau0 = anchors['tau0']
        re = radii[0]
        rp = radii[2]
        flattening = (re - rp) / re
        nan = torch.tensor(math.nan, dtype=torch.float64, device=dev)

        # -- pixel grid -> angular -> obsvec_norm rays ---------------------
        xg = torch.arange(nx, dtype=torch.float64, device=dev).expand(ny, nx)
        yg = (
            torch.arange(ny, dtype=torch.float64, device=dev) + row0
        )[:, None].expand(ny, nx)
        ang_x = (
            xy2angular[0, 0] * xg + xy2angular[0, 1] * yg + xy2angular[0, 2]
        )
        ang_y = (
            xy2angular[1, 0] * xg + xy2angular[1, 1] * yg + xy2angular[1, 2]
        )
        m_ang = anchors['obsvec2angular']
        vec = geom.radec_to_rect(
            torch.ones_like(ang_x),
            -ang_x / 3600.0 * DEG,
            ang_y / 3600.0 * DEG,
        )
        # unit rays in J2000 (obsvec frame): vec @ m_ang
        d = _matvec(m_ang.T, vec)

        # -- ray-ellipsoid intercept with linearised retargeting -----------
        obs_pos = anchors['obs_pos']
        targ_rel0 = anchors['targ_pos0'] - obs_pos  # target centre at tau0
        targ_vel0 = anchors['targ_vel0']
        lt = torch.full((ny, nx), float(0.0), dtype=torch.float64, device=dev)
        lt = lt + anchors['target_lt']
        spoint = None
        found = None
        for _ in range(4):
            tau = et - lt
            dtau = tau - tau0
            targ_rel = targ_rel0 + targ_vel0 * dtau[..., None]
            rot = _rot_at(anchors, dtau)
            o_bf = -_matvec(rot, targ_rel)
            d_bf = _matvec(rot, d)
            s, found = geom.ray_ellipsoid_intercept(o_bf, d_bf, radii)
            spoint = o_bf + s[..., None] * d_bf
            dist = torch.where(found, s, anchors['target_lt'] * CLIGHT)
            lt = dist / CLIGHT
        tau = et - lt
        dtau = tau - tau0
        spoint = torch.where(found[..., None], spoint, nan)

        if optimize_speed:
            # Behaviour parity with the reference's off-disc short circuit
            r_cutoff = disc[2] * torch.max(radii) / re * 1.05 + 1.0
            r2_px = (xg - disc[0]) ** 2 + (yg - disc[1]) ** 2
            off = r2_px > r_cutoff**2
            spoint = torch.where(off[..., None], nan, spoint)
            found = found & ~off

        out: dict[str, Any] = {}

        # -- lon/lat (graphic + centric) -----------------------------------
        if robust_geodetic:
            lon_e, lat_gd, _alt = geom.rect_to_geodetic(
                spoint, re, flattening
            )
        else:
            lon_e, lat_gd, _alt = rect_to_geodetic_surface(
                spoint, re, flattening
            )
        lon_graphic = torch.remainder(lon_sign * lon_e / DEG, 360.0)
        out['LON-GRAPHIC'] = torch.where(found, lon_graphic, nan)
        out['LAT-GRAPHIC'] = torch.where(found, lat_gd / DEG, nan)
        _r, lon_c, lat_c = geom.rect_to_latlon_centric(spoint)
        lon_c = lon_c / DEG
        if precision == 'mixed':
            lon_c = torch.remainder(lon_c, 360.0)
        out['LON-CENTRIC'] = torch.where(found, lon_c, nan)
        out['LAT-CENTRIC'] = torch.where(found, lat_c / DEG, nan)

        # -- RA/Dec --------------------------------------------------------
        _rr, ra, dec = geom.rect_to_radec(d)
        out['RA'] = ra / DEG
        out['DEC'] = dec / DEG

        # -- pixel coords --------------------------------------------------
        out['PIXEL-X'] = xg
        out['PIXEL-Y'] = yg

        # -- km / angular target plane coords ------------------------------
        m2 = anchors['angular2km']
        km_x = m2[0, 0] * ang_x + m2[0, 1] * ang_y
        km_y = m2[1, 0] * ang_x + m2[1, 1] * ang_y
        out['KM-X'] = km_x
        out['KM-Y'] = km_y
        # ANGULAR backplanes are the KM coordinates scaled to arcsec (same
        # origin/rotation as KM), matching the reference (body_xy.py:3610)
        km_per_arcsec = 2.0 * re / (
            2.0 * 60.0 * 60.0 / DEG * torch.asin(
                re / (anchors['target_lt'] * CLIGHT)
            )
        )
        out['ANGULAR-X'] = km_x / km_per_arcsec
        out['ANGULAR-Y'] = km_y / km_per_arcsec

        # -- illumination (phase/incidence/emission) -----------------------
        rot_tau = _rot_at(anchors, dtau)
        m_bf2j = torch.swapaxes(rot_tau, -1, -2)
        point_j = _matvec(m_bf2j, spoint)
        srfvec_j2000 = targ_rel0 + targ_vel0 * dtau[..., None] + point_j
        srfvec_bf = _matvec(rot_tau, srfvec_j2000)
        if have_sun:
            point_ssb = (
                anchors['targ_pos0'] + targ_vel0 * dtau[..., None] + point_j
            )
            # Apparent sun: anchor epoch already includes the mean light
            # time; refine per-pixel with the linearised sun state
            lt_s = geom.norm(anchors['sun_pos0'] - point_ssb) / CLIGHT
            sun_dtau = (tau - lt_s) - anchors['sun_epoch0']
            sun_pos = anchors['sun_pos0'] + anchors['sun_vel0'] * (
                sun_dtau[..., None]
            )
            sun_bf = _matvec(rot_tau, sun_pos - point_ssb)
        else:
            sun_bf = torch.full_like(spoint, math.nan)

        normal = geom.surface_normal(spoint, radii)
        phase = geom.vector_separation(sun_bf, -srfvec_bf) / DEG
        incidence = geom.vector_separation(normal, sun_bf) / DEG
        emission = geom.vector_separation(normal, -srfvec_bf) / DEG
        out['PHASE'] = phase
        out['INCIDENCE'] = incidence
        out['EMISSION'] = emission

        # -- azimuth -------------------------------------------------------
        cp = torch.cos(phase * DEG)
        ce = torch.cos(emission * DEG)
        ci = torch.cos(incidence * DEG)
        out['AZIMUTH'] = (
            math.pi - torch.acos(
                torch.clamp(
                    (cp - ce * ci)
                    / (torch.sqrt(1 - ce * ce) * torch.sqrt(1 - ci * ci)),
                    -1.0, 1.0,
                )
            )
        ) / DEG

        # -- local solar time ---------------------------------------------
        lst = torch.remainder(
            12.0 + spin_sign * (lon_e - anchors['solar_lon_e']) * 12.0
            / math.pi,
            24.0,
        )
        if lst_quantization_enabled():
            lst = torch.floor(lst * 3600.0) / 3600.0
        out['LOCAL-SOLAR-TIME'] = torch.where(found, lst, nan)

        # -- state: distance / radial velocity / doppler -------------------
        dist_surface = torch.where(found, lt * CLIGHT, nan)
        out['DISTANCE'] = dist_surface
        m_bf2j_dot = torch.swapaxes(_rot_dot_at(anchors, dtau), -1, -2)
        p_vel = targ_vel0 + _matvec(m_bf2j_dot, spoint)  # point SSB velocity
        rel = srfvec_j2000
        rhat = rel / geom.norm(rel)[..., None]
        obs_vel = anchors['obs_vel']
        rv_t = torch.sum(rhat * p_vel, dim=-1)
        rv_o = torch.sum(rhat * obs_vel, dim=-1)
        dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
        vel = p_vel * (1.0 - dltdt)[..., None] - obs_vel
        radial_velocity = torch.where(
            found, torch.sum(rhat * vel, dim=-1), nan
        )
        out['RADIAL-VELOCITY'] = radial_velocity
        beta = radial_velocity / CLIGHT
        out['DOPPLER'] = torch.sqrt((1.0 + beta) / (1.0 - beta))

        # -- limb coordinates ----------------------------------------------
        origin = torch.zeros(3, dtype=torch.float64, device=dev)
        near, near_dist = geom.nearest_point_on_line(
            origin, d, anchors['target_obsvec']
        )
        near_targvec = _obsvec2targvec_lin(anchors, near)
        limb_surface = geom.radial_surface_point(near_targvec, radii)
        if robust_geodetic:
            limb_lon_e, limb_lat, _ = geom.rect_to_geodetic(
                limb_surface, re, flattening
            )
        else:
            limb_lon_e, limb_lat, _ = rect_to_geodetic_surface(
                limb_surface, re, flattening
            )
        out['LIMB-LON-GRAPHIC'] = torch.remainder(
            lon_sign * limb_lon_e / DEG, 360.0
        )
        out['LIMB-LAT-GRAPHIC'] = limb_lat / DEG
        out['LIMB-DISTANCE'] = near_dist - geom.norm(limb_surface)

        # -- ring plane ----------------------------------------------------
        intercept, nxpts = geom.ray_plane_intercept(
            origin, d,
            anchors['ring_plane_normal'], anchors['ring_plane_constant'],
        )
        ring_ok = nxpts == 1
        ring_targvec = _obsvec2targvec_lin(anchors, intercept)
        # Ring intercepts are exterior (interior ones are always occluded by
        # the surface hit and masked below), so the fast Bowring solve
        # matches CSPICE recpgr to machine precision here.
        ring_lon_e, _ring_lat, ring_alt = geom.rect_to_geodetic_exterior(
            ring_targvec, re, flattening
        )
        ring_distance = geom.norm(intercept)
        ring_radius = ring_alt + re
        ring_lon = torch.remainder(lon_sign * ring_lon_e / DEG, 360.0)
        hidden = found & (dist_surface < ring_distance)
        ring_invalid = (~ring_ok) | hidden
        out['RING-RADIUS'] = torch.where(ring_invalid, nan, ring_radius)
        out['RING-LON-GRAPHIC'] = torch.where(ring_invalid, nan, ring_lon)
        out['RING-DISTANCE'] = torch.where(ring_invalid, nan, ring_distance)
        return out

    def frames(nx, ny, xy2angulars, discs, radii, anchors, *, device,
               row0=0.0):
        """The planes of N frames, each (N, ny, nx), on ``device``."""
        a, disc = frame_inputs(xy2angulars, discs)
        per_frame = {k for k, shape in ANCHOR_SHAPES.items()
                     if np.ndim(anchors[k]) > len(shape)}
        common = None if per_frame else anchors_from_numpy(anchors, device)
        radii = f64(radii, device)
        out = [impl(nx, ny, f64(a[i], device), f64(disc[i], device), radii,
                    common or anchors_from_numpy(
                        {k: v[i] if k in per_frame else v
                         for k, v in anchors.items()}, device),
                    row0=row0)
               for i in range(len(a))]
        return {k: torch.stack([f[k] for f in out]) if len(out) > 1
                else out[0][k][None] for k in out[0]}

    impl.frames = frames
    return impl


def pick_ds():
    """
    The extended-precision backend for cancelling float32 chains, by the JAX
    package's stated rule (``planetmapper_tpu/ops/ds64.py``: "TPU -> ds,
    native-f64 backends -> ds64"): :mod:`.ops.ds64`, native float64 with the
    ds call surface, on every device of the port, the CPU and the card
    alike. The JAX code tests for the ``'cpu'`` backend, which would send
    any other device, the card included, to double-single; the H100 has
    native float64, so the rule and not that test is followed. Override
    with ``PLANETMAPPER_TPU_DS=ds|f64`` (:mod:`.ops.ds` or
    :mod:`.ops.ds64`). No path of the port calls it: the backplane kernel
    and the plain graph run their chains in native float64.
    """
    from .ops import ds, ds64

    forced = os.environ.get('PLANETMAPPER_TPU_DS', '')
    if forced == 'ds':
        return ds
    return ds64


def _robust_geodetic(body) -> bool:
    """
    True when the body is triaxial (middle axis != re): surface points of
    the triaxial intercept ellipsoid then sit inside the biaxial (re, rp)
    geodetic spheroid, where the on-surface conversions diverge.
    """
    radii_host = np.asarray(body.radii, dtype=float)
    return bool(abs(radii_host[0] - radii_host[1]) > 1e-9 * radii_host[0])


def _kernel_geodetic_iters(body) -> int | None:
    """
    Bowring iteration count for the kernel's geodetic conversions, or None
    when the kernel cannot hold the error budget (the JAX package's rule):
    0 for biaxial bodies, 4 for triaxial bodies whose surface points stay
    outside the meridian ellipse's evolute (rm/re > e2), None otherwise.
    """
    radii_host = np.asarray(body.radii, dtype=float)
    re, rm, rp = radii_host
    if abs(re - rm) <= 1e-9 * re:
        return 0
    e2 = 1.0 - (rp / re) ** 2
    if rm / re > e2 + 0.02:
        return 4
    return None


def select_pipeline_impl(body, nx: int, ny: int,
                         use_pallas: bool | None = None,
                         planes: tuple[str, ...] | None = None,
                         interpret: bool = False):
    """
    Build the per-pixel pipeline impl for a body: ``(impl, use_pallas)``
    where ``impl.frames(nx, ny, xy2angulars, discs, radii, anchors, *,
    device, row0=0.0)`` computes the planes of N frames for
    rows ``[row0, row0 + ny)`` and ``use_pallas`` says whether it launches
    the CUDA kernel. The keywords are the JAX package's, read for the card:

    - ``use_pallas=None`` (default): the CUDA kernel on a CUDA device when
      the precision is ``'mixed'`` and the kernel's geodetic solve holds for
      the body's shape (the JAX package's rule for its TPU kernel; the
      kernel masks its own ragged edge, so every image shape qualifies);
      the plain float64 graph on the CPU, at ``'double'`` precision and for
      shapes inside the evolute margin.
    - ``use_pallas=True`` forces the kernel: it raises for a shape inside
      the evolute margin and for a body off CUDA. ``False`` takes the plain
      graph.
    - ``interpret=True`` takes the plain graph on any device: the kernel's
      function computed without the kernel (what interpret mode is to the
      JAX package's Pallas kernel), at the kernel's conventions
      (``'mixed'``: LON-CENTRIC in [0, 360)).

    ``planes`` restricts the kernel to a subset (a run-time plane mask);
    the plain graph computes every plane and the caller filters.
    """
    from .ops import backplanes_kernel

    precision = getattr(body, '_pipeline_precision', DEFAULT_PRECISION)
    geodetic_iters = _kernel_geodetic_iters(body)
    if use_pallas and geodetic_iters is None:
        # a forced kernel path must refuse rather than run 0 Bowring
        # iterations on a shape whose surface points sit inside the
        # evolute (garbage graphic latitudes)
        raise ValueError(
            'the CUDA kernel cannot hold the geodetic error budget for '
            'this body shape (middle axis inside the evolute margin); '
            'use the plain graph (use_pallas=False)'
        )
    if interpret:
        use_pallas = False
    elif use_pallas is None:
        use_pallas = (
            body.device.type == 'cuda'
            and precision == 'mixed'
            and geodetic_iters is not None
        )
    elif use_pallas and body.device.type != 'cuda':
        raise ValueError(
            f'use_pallas=True needs a body on a CUDA device, not '
            f'{body.device}; interpret=True computes the kernel\'s '
            'function with the plain graph'
        )
    if use_pallas:
        impl = backplanes_kernel.build_backplanes_kernel(
            positive_west=body.positive_longitude_direction == 'W',
            prograde=body.prograde,
            have_sun=body._engine._pos_s is not None,
            optimize_speed=bool(body._optimize_speed),
            lst_quant=_lst_quantization(),
            planes=planes,
            geodetic_iters=geodetic_iters,
        )
    else:
        impl = fused_backplanes_fn(
            positive_west=body.positive_longitude_direction == 'W',
            prograde=body.prograde,
            have_sun=body._engine._pos_s is not None,
            optimize_speed=bool(body._optimize_speed),
            precision=(
                'mixed' if precision == 'mixed' or interpret else 'double'
            ),
            robust_geodetic=_robust_geodetic(body),
        )
    return impl, use_pallas


def _lst_quantization() -> bool:
    from .body import lst_quantization_enabled

    return lst_quantization_enabled()


def _canonical_planes(planes) -> tuple[str, ...] | None:
    if planes is None:
        return None
    from .ops.backplanes_kernel import PLANE_ORDER

    unknown = set(planes) - set(PLANE_ORDER)
    if unknown:
        raise ValueError(f'unknown planes: {sorted(unknown)}')
    return tuple(n for n in PLANE_ORDER if n in planes)


def get_fused_pipeline(body, nx: int, ny: int,
                       planes: tuple[str, ...] | None = None) -> Callable:
    """
    The pipeline for a body's configuration and image size on the body's
    device: ``fn(xy2angular, disc, radii, anchors) -> dict`` of (ny, nx)
    tensors on that device, from the host values of
    :func:`pipeline_inputs` (one frame of ``impl.frames``), with
    ``fn.precompile()`` (builds and loads the CUDA library when the kernel
    serves; no-op otherwise) and ``fn.wait_steady(timeout=None)`` (the
    same: once the library is loaded the kernel serves every call).
    """
    planes = _canonical_planes(planes)
    impl, use_pallas = select_pipeline_impl(body, nx, ny, planes=planes)

    def fn(xy2angular, disc, radii, anchors):
        out = impl.frames(nx, ny, xy2angular[None], disc[None], radii,
                          anchors, device=body.device)
        return {k: out[k][0] for k in planes or out}

    def precompile():
        if use_pallas:
            from .ops import backplanes_kernel

            backplanes_kernel.load_library()

    fn.precompile = precompile
    fn.wait_steady = lambda timeout=None: precompile()
    return fn


def wait_for_steady_state(
    body, timeout: float | None = None,
    names: tuple[str, ...] | list[str] | None = None,
) -> None:
    """
    Return once the steady-state implementation serves
    :func:`compute_backplanes` for this body: on a CUDA device, once the
    kernel library is built and loaded (``timeout`` is accepted for API
    parity; the build runs in the calling thread). No-op on the CPU.
    """
    nx, ny = body.get_img_size()
    fn = get_fused_pipeline(
        body, nx, ny, planes=None if names is None else tuple(names)
    )
    fn.wait_steady(timeout)


def pipeline_inputs(body):
    """
    ``(xy2angular, disc, radii, anchors)`` of a body, the host float64
    values that ``impl.frames`` takes (the affine and disc of one frame;
    the anchors a dict of them, cached per body).
    """
    return (
        np.asarray(body._get_xy2angular_matrix(), dtype=np.float64),
        np.asarray(body.get_disc_params(), dtype=np.float64),
        np.asarray(body.radii, dtype=np.float64),
        body._get_pipeline_anchors(),
    )


def compute_backplanes(
    body, *, as_numpy: bool = True, with_checksum: bool = False,
    names: tuple[str, ...] | list[str] | None = None,
):
    """
    Compute all default backplane images for a BodyXY in one pass on the
    body's device. Returns a dict keyed by backplane name.

    ``names`` restricts the computation to a subset of the default planes.
    With ``with_checksum=True`` returns ``(dict, checksum)`` where
    ``checksum`` is a device scalar summed from strided samples of every
    plane (kept for API parity with the JAX package).

    With ``as_numpy=True`` (the default) the planes of a CUDA body are
    copied into one of two reused page-locked host slots
    (:func:`_to_host_slot`): the arrays are views of the slot, which is
    lent again once no array from it survives.
    """
    with tracing.span('pm.pipeline.compute_backplanes'):
        nx, ny = body.get_img_size()
        if nx <= 0 or ny <= 0:
            raise ValueError(
                'nx and ny must be positive to generate backplanes'
            )
        fn = get_fused_pipeline(
            body, nx, ny, planes=None if names is None else tuple(names)
        )
        with tracing.span('pm.scene.inputs'):
            inputs = pipeline_inputs(body)
        out = fn(*inputs)
        checksum = None
        if with_checksum:
            checksum = sum(
                torch.nan_to_num(v[::128, ::128].to(torch.float32)).sum()
                for v in out.values()
            )
        if as_numpy:
            if any(v.device.type != 'cuda' for v in out.values()):
                out = _to_numpy(out)
            else:
                out = _to_host_slot(out)
    if with_checksum:
        return out, checksum
    return out


@contextlib.contextmanager
def _copy_stage():
    """
    The copy of the planes to the host (span ``pm.pipeline.to_numpy``).
    While a profiler records, the pages the copy newly makes resident are
    counted (``pipeline.copy_fresh_pages``): each a first-touch page fault,
    about one a 4 KiB page of the planes when the arrays land in pages the
    host allocator takes afresh, none when it reuses its pages. The reads
    of the resident set lie outside the span.
    """
    before = tracing.resident_pages()
    with tracing.span('pm.pipeline.to_numpy'):
        yield
    after = tracing.resident_pages()
    if before is not None and after is not None:
        tracing.count('pipeline.copy_fresh_pages', max(after - before, 0))


def _to_numpy(planes: dict) -> dict[str, np.ndarray]:
    """The planes copied to fresh numpy arrays, one ``.cpu()`` a plane."""
    with _copy_stage():
        return {k: v.cpu().numpy() for k, v in planes.items()}


def _slot_plan(planes: dict):
    """
    ``(copies, views, n_bytes)`` of the planes' copy into one host slot:
    the copies ``(source, offset)``, one per device allocation that the
    planes tile exactly (kernel 1's float32 stack, its float64
    RADIAL-VELOCITY) and one per other plane; each plane's ``(offset,
    dtype, shape)`` in the slot; and the slot's size. Regions start on 64
    bytes.
    """
    groups: dict[int, tuple[torch.Tensor, list[str]]] = {}
    for name, v in planes.items():
        base = v if v._base is None else v._base
        groups.setdefault(id(base), (base, []))[1].append(name)
    copies, views, offset = [], {}, 0
    for base, names in groups.values():
        members = [planes[n] for n in names]
        bounds = sorted((m.data_ptr(), m.data_ptr() + m.nbytes)
                        for m in members)
        whole = (
            base.is_contiguous()
            and all(m.is_contiguous() and m.dtype == base.dtype
                    for m in members)
            and bounds[0][0] == base.data_ptr()
            and bounds[-1][1] == base.data_ptr() + base.nbytes
            and all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        )
        if whole:
            copies.append((base, offset))
            for n, m in zip(names, members):
                views[n] = (offset + m.data_ptr() - base.data_ptr(),
                            m.dtype, tuple(m.shape))
            offset += -(-base.nbytes // 64) * 64
        else:
            for n, m in zip(names, members):
                copies.append((m, offset))
                views[n] = (offset, m.dtype, tuple(m.shape))
                offset += -(-m.nbytes // 64) * 64
    return copies, {n: views[n] for n in planes}, offset


def _to_host_slot(planes: dict) -> dict[str, np.ndarray]:
    """
    The planes of one :func:`compute_backplanes` call copied into a
    page-locked host slot (:mod:`.host_slots`): one
    ``copy_(non_blocking=True)`` per device allocation (:func:`_slot_plan`)
    on the current stream and one synchronise; the result is numpy views of
    the slot with the keys, order, shapes, dtypes and values of
    :func:`_to_numpy`. Counted as ``pipeline.copy_slot_hits``; where
    earlier results still hold both slots, :func:`_to_numpy` copies instead
    (``pipeline.copy_slot_misses``).
    """
    copies, views, n_bytes = _slot_plan(planes)
    lease = host_slots.SLOTS.take(n_bytes)
    if lease is None:
        tracing.count('pipeline.copy_slot_misses')
        return _to_numpy(planes)
    tracing.count('pipeline.copy_slot_hits')
    device = next(iter(planes.values())).device
    with _copy_stage():
        for src, offset in copies:
            lease.tensor[offset:offset + src.nbytes].view(src.dtype).view(
                src.shape).copy_(src, non_blocking=True)
        # the views are cut while the copies run, and handed out after
        flat = np.asarray(lease)
        out = {name: np.ndarray(shape, _numpy_dtype(dtype), flat, offset)
               for name, (offset, dtype, shape) in views.items()}
        if device.type == 'cuda':
            torch.cuda.current_stream(device).synchronize()
    return out


@functools.cache
def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def compute_backplanes_batch(
    body, xy2angulars, discs, *, as_numpy: bool = True
) -> dict[str, Any]:
    """
    All default backplanes for N disc-parameter sets over one body's
    anchors: ``out[name]`` has shape ``(N, ny, nx)``. On a CUDA body the N
    frames are the kernel's launches for a batch; elsewhere the plain graph
    runs frame by frame on the body's device. The natural shape for
    disc-fit parameter sweeps and GUI scrubbing.

    ``xy2angulars``: (N, 3, 3) pixel->angular affines (one per disc
    parameter set, see :meth:`BodyXY._get_xy2angular_matrix`);
    ``discs``: (N, 4) arrays of (x0, y0, r0, rotation).

    The kernel packs the part of its scene that the frames share
    (everything but the affines and the disc) once for the body's cached
    anchors; a call packs only what changes per frame.
    """
    nx, ny = body.get_img_size()
    if nx <= 0 or ny <= 0:
        raise ValueError('nx and ny must be positive to generate backplanes')
    impl, _ = select_pipeline_impl(body, nx, ny)
    _, _, radii, anchors = pipeline_inputs(body)
    out = impl.frames(nx, ny, xy2angulars, discs, radii, anchors,
                      device=body.device)
    if as_numpy:
        return _to_numpy(out)
    return out
