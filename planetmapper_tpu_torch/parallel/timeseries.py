"""
Backplanes for many observation epochs in one pass (port of
``planetmapper_tpu.parallel.timeseries``; the "JWST IFU cube" use case:
per-frame or per-wavelength observation times).

The reference creates one ``Body`` per time and loops the scalar pipeline.
Here every epoch's anchors and pixel->angular affine come from one float64
pass of the scene engine with a leading time axis
(:func:`_batched_pipeline_inputs`: the SPK and frame evaluations, the
sub-observer and sub-solar solves, the rotation's time derivatives, the
camera matrix, the north-pole angle and the affines, all elementwise over
the epochs), and the frames' backplanes come from one launch of the
batched backplane kernel (``csrc/backplanes.cu``
``backplanes26_batch_kernel``) on the body's device, or from the plain
graph frame by frame on CPU tensors. With ``mesh=`` the frames (and, with
:func:`.multihost.pixel_row_sharding`, the rows) are split over the mesh's
entries; a multi-process mesh gathers every process's frames.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np
import torch

from .._device import f64, scene_device
from .sharding import _pad_to_multiple, _placement


def backplane_time_series(
    body,
    times: Iterable,
    names: Sequence[str] | None = None,
    *,
    mesh=None,
    as_numpy: bool = True,
) -> dict[str, Any]:
    """
    Compute backplane images for a sequence of observation times.

    Args:
        body: Template :class:`BodyXY` (or Observation): target/observer
            configuration, image size, disc parameters and device are taken
            from it.
        times: Sequence of UTC strings / datetimes / MJD floats, or float
            TDB seconds (``et`` values).
        names: Backplane names to return (default: all default backplanes).
        mesh: Optional :func:`.sharding.make_mesh` mesh, whose first axis
            takes the time axis, or a placement from
            :func:`.multihost.frame_sharding` (frames over its first axis)
            or :func:`.multihost.pixel_row_sharding` (image rows over its
            second axis). A mesh spanning several processes
            (:func:`.multihost.make_multihost_mesh`) gives each process its
            block of frames and gathers them with ``all_gather``.
        as_numpy: Fetch results to host numpy (default). Pass False to
            keep the cube on the device (the mesh's first device).

    Returns:
        Dict of ``(n_times, ny, nx)`` arrays keyed by backplane name.
    """
    from .. import pipeline

    nx, ny = body.get_img_size()
    if nx <= 0 or ny <= 0:
        raise ValueError('Template body must have a valid image size')
    wanted = (
        None
        if names is None
        else tuple(sorted(body.standardise_backplane_name(n) for n in names))
    )
    placement = _placement(mesh, body.device)
    ets = _ets_from_times(body, times)
    n_times = len(ets)
    if n_times < 1:
        raise ValueError('times must hold at least one epoch')
    n_padded, rank = n_times, 0
    if placement.mesh.processes > 1:
        import torch.distributed as dist

        # every process takes an equal block (the last epoch repeated),
        # so that each block gathers with one all_gather
        n_padded = _pad_to_multiple(n_times, placement.mesh.processes)
        ets = np.concatenate([ets, np.full(n_padded - n_times, ets[-1])])
        rank = dist.get_rank()
    anchors, xy2angular = _batched_pipeline_inputs(body, ets)
    impl, _ = pipeline.select_pipeline_impl(
        body, nx, ny, planes=pipeline._canonical_planes(wanted)
    )
    disc = np.asarray(body.get_disc_params(), dtype=np.float64)
    radii = np.asarray(body.radii, dtype=np.float64)
    discs = np.broadcast_to(disc, (n_padded, 4))

    def run(device, frames: slice, row0: int, rows: int) -> dict:
        out = impl.frames(nx, rows, xy2angular[frames], discs[frames], radii,
                          {k: v[frames] for k, v in anchors.items()},
                          device=device, row0=float(row0))
        return out if wanted is None else {k: out[k] for k in wanted}

    out = placement.compute(run, n_padded, ny, rank)
    if n_padded != n_times:
        out = {k: v[:n_times] for k, v in out.items()}
    if as_numpy:
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out


def _ets_from_times(body, times) -> np.ndarray:
    """Normalise mixed time inputs (et floats / UTC strings / MJD) to et."""
    from ..core.time import utc_string_to_et

    lsk = body._lsk()
    ets = []
    for t in times:
        if isinstance(t, (int, float)) and abs(float(t)) > 1e6:
            ets.append(float(t))  # TDB seconds past J2000
        else:
            # UTC strings / datetimes / MJD floats, like Body(utc=...)
            utc = body._standardise_utc_to_string(t)
            ets.append(utc_string_to_et(utc, lsk))
    return np.asarray(ets, dtype=np.float64)


def _batched_pipeline_inputs(body, ets: np.ndarray):
    """
    Every epoch's pipeline anchors and ``xy2angular`` matrix from one
    float64 pass with a leading time axis: no per-time Body, so a
    1000-frame series costs one scene evaluation's launches, not a
    thousand. Returns ``(anchors, xy2angular)``: a dict of ``(N, ...)``
    numpy arrays with the keys of :func:`..pipeline.compute_scene_anchors`
    and an ``(N, 3, 3)`` array. The pass runs where
    :func:`.._device.scene_device` puts a call of N elements: CPU tensors up
    to 4096 epochs, the body's device above.

    The JAX package's ``per_time`` (``planetmapper_tpu/parallel/
    timeseries.py``) in PyTorch: the camera matrix, the north-pole angle and
    the affines are computed in the pass, not through a Body.
    """
    from ..core import geometry as geom
    from ..core.ephemeris import CLIGHT
    from ..core.frames import _rotmat
    from ..pipeline import _anchor_core

    engine = body._engine
    device = scene_device(len(ets), body.device)
    et = f64(np.asarray(ets, dtype=np.float64), device)
    radii = f64(np.asarray(body.radii, dtype=np.float64), device)
    x0, y0, r0, rotation_deg = (
        float(v) for v in body.get_disc_params()
    )
    r_eq = radii[0]

    def matvec(m, v):
        return torch.einsum('...ij,...j->...i', m, v)

    scene = engine._scene_constants_impl(et, radii)
    tau0 = scene['subpoint_et']
    target_lt = scene['target_lt']
    core = _anchor_core(engine, et, tau0, target_lt)
    targ_state = core['targ_state']
    obs_state = core['obs_state']
    sun_state = core['sun_state']

    # camera: obsvec -> angular matrix centred on the apparent target
    # (Body._get_obsvec2angular_matrix, in the pass)
    t_obsvec = scene['target_obsvec']
    t_norm = t_obsvec / geom.norm(t_obsvec)[..., None]
    _r1, ra_angle, _d1 = geom.rect_to_radec(t_norm)
    m_ra = _rotmat(ra_angle, 3)
    _r2, _a2, dec_angle = geom.rect_to_radec(matvec(m_ra, t_norm))
    m_ang = _rotmat(-dec_angle, 2) @ m_ra

    def obsvec2angular(v):
        _rr, xr, yr = geom.rect_to_radec(matvec(m_ang, v))
        x = torch.remainder(-torch.rad2deg(xr), 360.0)
        x = torch.where(x > 180.0, x - 360.0, x)
        return x * 3600.0, torch.rad2deg(yr) * 3600.0

    target_distance = target_lt * CLIGHT
    diameter_as = (
        2.0 * 3600.0 * torch.rad2deg(torch.arcsin(r_eq / target_distance))
    )
    km_per_arcsec = 2.0 * r_eq / diameter_as

    # north pole angle (Body.north_pole_angle, in the pass)
    np_targvec = f64([0.0, 0.0, 1.0], device) * radii[2]
    np_obsvec = engine._targvec2obsvec_core(np_targvec, scene)
    np_x, np_y = obsvec2angular(np_obsvec / geom.norm(np_obsvec)[..., None])
    t_x, t_y = obsvec2angular(t_norm)
    theta = -torch.atan2(t_x - np_x, np_y - t_y)

    # angular -> km and xy -> angular affines (body_xy equivalents; the
    # rotation is SpiceBase._rotation_matrix_radians's [[c, s], [-s, c]])
    def rotation(c, s):
        return torch.stack([torch.stack([c, s], dim=-1),
                            torch.stack([-s, c], dim=-1)], dim=-2)

    km2angular = rotation(torch.cos(theta), torch.sin(theta)) / \
        km_per_arcsec[..., None, None]
    angular2km = km2angular.transpose(-1, -2) * (
        km_per_arcsec * km_per_arcsec)[..., None, None]

    plate_scale = diameter_as / (2.0 * r0)
    rot_rad = -np.deg2rad(rotation_deg)
    m2 = plate_scale[..., None, None] * rotation(
        torch.full_like(plate_scale, np.cos(rot_rad)),
        torch.full_like(plate_scale, np.sin(rot_rad)),
    )
    offset = -(m2[..., 0] * x0 + m2[..., 1] * y0)
    xy2angular = torch.zeros(et.shape + (3, 3), dtype=torch.float64,
                             device=device)
    xy2angular[..., :2, :2] = m2
    xy2angular[..., :2, 2] = offset
    xy2angular[..., 2, 2] = 1.0

    anchors = dict(
        et=et,
        tau0=tau0,
        rot0=core['rot0'], rot1=core['rot1'], rot2=core['rot2'],
        targ_pos0=targ_state[..., :3],
        targ_vel0=targ_state[..., 3:],
        obs_pos=obs_state[..., :3],
        obs_vel=obs_state[..., 3:],
        sun_pos0=sun_state[..., :3],
        sun_vel0=sun_state[..., 3:],
        sun_epoch0=core['sun_epoch'],
        target_lt=target_lt,
        target_obsvec=t_obsvec,
        subpoint_targvec=scene['subpoint_targvec'],
        subpoint_rayvec=scene['subpoint_rayvec'],
        subpoint_obsvec=scene['subpoint_obsvec'],
        subpoint_distance=scene['subpoint_distance'],
        ring_plane_normal=scene['ring_plane_normal'],
        ring_plane_constant=scene['ring_plane_constant'],
        solar_lon_e=core['solar_lon'],
        obsvec2angular=m_ang,
        angular2km=angular2km,
    )
    return ({k: v.detach().cpu().numpy() for k, v in anchors.items()},
            xy2angular.cpu().numpy())


def _body_at_time(body, t):
    """A copy of ``body`` at time ``t`` (a UTC string, datetime, MJD or et
    float) with the same disc, or ``body`` itself at its own time."""
    if isinstance(t, (int, float)) and abs(float(t)) > 1e6:
        # Treat large floats as TDB seconds past J2000 (et); reference-style
        # MJD floats are far smaller
        from ..core.time import et_to_utc_string

        t = et_to_utc_string(float(t), body._lsk())
    new = body.replace(utc=t) if not _same_time(body, t) else body
    if hasattr(new, 'set_disc_params'):
        new.set_disc_params(*body.get_disc_params())
    return new


def _same_time(body, t) -> bool:
    return isinstance(t, str) and t == body.utc
