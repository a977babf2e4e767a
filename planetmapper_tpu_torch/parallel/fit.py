"""
Gradient-based disc fitting: a differentiable disc render and Adam (port
of ``planetmapper_tpu.parallel.fit``).

The reference fits the disc with threshold/centre-of-mass and annular
photometry heuristics (observation.py:762-823). Here the disc parameters
``(x0, y0, r0, rotation)`` can instead be fit by gradient descent against
the observed image: a smooth differentiable disc render (a sigmoid of the
ray's impact parameter on the spheroid) is compared with the normalised
data, differentiated by ``torch.autograd`` and stepped by
``torch.optim.Adam`` (optax's ``adam`` to rounding). Everything is float64
on the body's device. With a mesh, the frames split over its first axis and
the rows over its second, and the loss is the sum of each block's partial
sum of squared errors over the whole cube's size. No kernel of the port is
on this path (the JAX package has none here either).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from .._device import f64
from ..core import geometry as geom
from .sharding import _Placement

DEG = math.pi / 180.0


def _disc_render_fn(anchors, target_diameter_arcsec: float, nx: int, ny: int,
                    device=None):
    """
    Build a differentiable renderer ``render(params, radii, sharpness=2.0,
    row0=0, rows=ny) -> (rows, nx)`` producing a smooth synthetic disc
    image (rows ``[row0, row0 + rows)``) from disc parameters ``params =
    (x0, y0, log_r0, rotation_rad)``, a float64 tensor on ``device``.
    """
    device = torch.device('cpu') if device is None else torch.device(device)
    a = {k: f64(np.asarray(v, dtype=np.float64), device)
         for k, v in anchors.items()}
    m_ang = a['obsvec2angular']
    # single light-time pass: ample for a smooth fitting target
    dtau = (a['et'] - a['target_lt']) - a['tau0']
    targ_rel = (a['targ_pos0'] - a['obs_pos']) + a['targ_vel0'] * dtau
    rot = a['rot0'] + a['rot1'] * dtau
    o_bf = -(rot @ targ_rel)

    def render(params, radii, sharpness=2.0, row0: int = 0,
               rows: int | None = None):
        rows = ny if rows is None else rows
        x0, y0, log_r0, rotation = params.unbind()
        r0 = torch.exp(log_r0)
        plate_scale = target_diameter_arcsec / (2.0 * r0)  # arcsec/px
        c = torch.cos(-rotation)
        s = torch.sin(-rotation)
        xg = torch.arange(nx, dtype=torch.float64, device=params.device)
        yg = torch.arange(row0, row0 + rows, dtype=torch.float64,
                          device=params.device)
        dx = xg[None, :] - x0
        dy = yg[:, None] - y0
        ang_x = plate_scale * (c * dx + s * dy)
        ang_y = plate_scale * (-s * dx + c * dy)
        vec = geom.radec_to_rect(
            torch.ones_like(ang_x), -ang_x / 3600.0 * DEG,
            ang_y / 3600.0 * DEG,
        )
        d = vec @ m_ang.to(params.device)
        d_bf = torch.einsum('ij,...j->...i', rot.to(params.device), d)
        # Impact parameter of the ray in spheroid-scaled space: the ray
        # hits the surface iff p < 1, and (1 - p) ~ (r_disc - r_px)/r_disc
        # so scaling by r0 gives a smooth pixel-space signed limb distance.
        o = o_bf.to(params.device) / radii
        dd = d_bf / radii
        dd_norm = dd / torch.linalg.vector_norm(dd, dim=-1, keepdim=True)
        p = torch.linalg.vector_norm(
            torch.linalg.cross(o.expand_as(dd_norm), dd_norm), dim=-1)
        signed_px = (1.0 - p) * r0
        return 1.0 / (1.0 + torch.exp(-signed_px * sharpness))

    return render


def _normalise(data: np.ndarray) -> np.ndarray:
    """The data scaled to [0, 1] between its 5th and 95th percentiles."""
    finite = np.isfinite(data)
    lo = np.percentile(data[finite], 5) if finite.any() else 0.0
    hi = np.percentile(data[finite], 95) if finite.any() else 1.0
    return np.clip(
        np.nan_to_num((data - lo) / max(hi - lo, 1e-12), nan=0.0), 0.0, 1.0
    )


def _blocks(mesh, nf: int, ny: int, device) -> list[tuple]:
    """``(device, frames, row0, rows)`` of the loss's blocks: frames over
    the mesh's first axis, rows over its second (if any)."""
    if mesh is None:
        return [(torch.device(device), slice(0, nf), 0, ny)]
    if mesh.processes > 1:
        raise ValueError('the disc fit runs in one process; give it a mesh '
                         "of this process's devices")
    names = mesh.axis_names
    placement = _Placement(mesh, names[0],
                           names[1] if len(names) > 1 else None)
    return [(dev, frames, row0, rows) for dev, _fi, _ri, frames, row0, rows
            in placement.tasks(nf, ny, rank=0)]


def make_training_step(
    body, data: np.ndarray, *, mesh=None, learning_rate: float = 0.05,
) -> tuple[Callable, Any, Any]:
    """
    Build the disc-fit training step.

    Returns ``(step, params0, opt_state0)`` where ``step(params, opt_state,
    batch=None) -> (params, opt_state, loss)`` performs one Adam update:
    ``params`` is a float64 leaf tensor ``(x0, y0, log r0, rotation
    [rad])`` on the body's device (the mesh's first device), updated in
    place, and ``opt_state`` the ``torch.optim.Adam`` over it. ``data`` is
    an ``(nframes, ny, nx)`` cube (or one frame); ``batch`` defaults to it,
    normalised (``step.data``). With ``mesh``, the loss is the sum of the
    partial sums of squared errors of each (frames x rows) block on its
    entry's device, over the cube's size.
    """
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 2:
        data = data[None]
    nf, ny, nx = data.shape
    device = body.device if mesh is None else mesh.devices.reshape(-1)[0]
    blocks = _blocks(mesh, nf, ny, device)

    anchors = body._get_pipeline_anchors()
    renders = {
        dev: _disc_render_fn(anchors, body.target_diameter_arcsec, nx, ny,
                             dev)
        for dev in {b[0] for b in blocks}
    }
    radii = {dev: f64(np.asarray(body.radii, dtype=np.float64), dev)
             for dev in renders}
    data_norm = f64(_normalise(data), device)

    def loss_fn(params, batch):
        total = None
        for dev, frames, row0, rows in blocks:
            model = renders[dev](params.to(dev), radii[dev], row0=row0,
                                 rows=rows)
            err = (model[None, :, :]
                   - batch[frames, row0:row0 + rows].to(dev)) ** 2
            part = err.sum().to(device)
            total = part if total is None else total + part
        return total / batch.numel()

    params0 = torch.tensor(
        [
            body.get_x0(),
            body.get_y0(),
            float(np.log(body.get_r0())),
            float(np.deg2rad(body.get_rotation())),
        ],
        dtype=torch.float64, device=device, requires_grad=True,
    )
    opt_state0 = torch.optim.Adam(
        [params0], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
    )

    def step(params, opt_state, batch=None):
        if batch is None:
            batch = data_norm
        opt_state.zero_grad()
        loss = loss_fn(params, batch)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    step.data = data_norm  # type: ignore[attr-defined]
    return step, params0, opt_state0


def fit_disc_gradient(
    body, data: np.ndarray | None = None, *, n_steps: int = 150,
    learning_rate: float = 0.05, mesh=None, set_params: bool = True,
) -> tuple[float, float, float, float]:
    """
    Fit the disc parameters by gradient descent on a differentiable disc
    render. For :class:`Observation` instances ``data`` defaults to the
    summed observed cube. Returns the fitted ``(x0, y0, r0, rotation)``
    and (by default) applies them to the body.
    """
    if data is None:
        data = np.nansum(np.asarray(body.data), axis=0)
    step, params, opt_state = make_training_step(
        body, np.asarray(data), mesh=mesh, learning_rate=learning_rate
    )
    for _ in range(n_steps):
        params, opt_state, _loss = step(params, opt_state)
    x0, y0, log_r0, rotation = (float(v) for v in params.detach().cpu())
    r0 = float(np.exp(log_r0))
    rotation_deg = float(np.rad2deg(rotation) % 360.0)
    if set_params:
        body.set_disc_params(x0, y0, r0, rotation_deg)
        body.set_disc_method('fit_gradient')
    return x0, y0, r0, rotation_deg
