"""
Ephemeris engine: SPK chain resolution and aberration-corrected states.

Port of ``planetmapper_tpu.core.ephemeris`` (the replacement for
``spice.spkezr``/``spkpos``/``spkcpt``, reference call sites
planetmapper/base.py:828, body.py:2830-2856). Segment *selection* (which
kernels cover which body at which epoch) happens when a scene is built;
state *evaluation* is float64 PyTorch code, batched over leading axes and
differentiable in time with ``torch.func``.

Evaluation runs on the device of its time argument: CPU tensors for the
scalar-sized calls, the card for the per-point light-time loops of a bulk
scene call (:func:`.._device.call_device`).

Conventions match SPICE:

- States are (..., 6) tensors [km, km/s] in the J2000 inertial frame.
- Reception-case light time: target evaluated at ``et - lt`` with ``lt``
  converged by fixed-point iteration ('LT' = 1 pass, 'CN' = converged).
- Velocity of a light-time corrected state is the derivative of the
  corrected position with respect to observation time (d lt/d et term).
- Stellar aberration ('+S') rotates the position toward the observer's
  SSB-relative velocity by the standard ``stelab`` construction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .._device import f64
from ..kernels import sgp4 as sgp4_mod
from ..kernels.pool import KernelPool
from ..kernels.spk import (
    ChebyshevData,
    EquinoctialData,
    LagrangeData,
    SpkSegment,
    TleData,
    TwoBodyData,
    chebyshev_state,
    equinoctial_position,
    lagrange_state,
)
from .geometry import norm
from .inertial import frame_id_to_j2000_matrix
from .timebase import SPEED_OF_LIGHT_KM_S as CLIGHT

SSB = 0


class InsufficientDataError(Exception):
    """No SPK segment covers the requested body/time (SpiceSPKINSUFFDATA)."""


def _jvp_time(fn: Callable, et: torch.Tensor):
    """``(fn(et), d fn / d et)`` by forward-mode differentiation."""
    return torch.func.jvp(fn, (et,), (torch.ones_like(et),))


class Ephemeris:
    """Chain-resolving state evaluator over a kernel pool's SPK segments."""

    def __init__(self, pool: KernelPool) -> None:
        self._pool = pool
        self._n_segments_seen = 0
        self._by_target: dict[int, list[SpkSegment]] = {}
        self._state_fn_cache: dict[tuple, Callable] = {}
        self._chain_cache: dict[tuple, tuple] = {}
        self._refresh()

    def _refresh(self) -> None:
        segments = self._pool.spk_segments
        if len(segments) == self._n_segments_seen:
            return
        self._by_target.clear()
        self._state_fn_cache.clear()
        self._chain_cache.clear()
        # Precedence: later-loaded files first; later segments within a file
        # first (matching the SPICE segment search order).
        for seg in reversed(segments):
            self._by_target.setdefault(seg.target, []).append(seg)
        self._n_segments_seen = len(segments)

    def segment_covering(self, body: int, et: float) -> SpkSegment:
        self._refresh()
        for seg in self._by_target.get(body, ()):  # precedence order
            if seg.covers(et):
                return seg
        raise InsufficientDataError(
            f'Insufficient ephemeris data for body {body} at et={et}. '
            'Check that suitable SPK kernels are loaded.'
        )

    def has_data_for(self, body: int, et: float) -> bool:
        try:
            self.segment_covering(body, et)
            return True
        except InsufficientDataError:
            return False

    def chain(self, body: int, et: float) -> list[SpkSegment]:
        """Segments linking ``body`` up towards the root of its center tree."""
        chain: list[SpkSegment] = []
        current = body
        while current != SSB:
            try:
                seg = self.segment_covering(current, et)
            except InsufficientDataError:
                if chain:
                    break  # partial chain; common-ancestor logic may succeed
                raise
            chain.append(seg)
            current = seg.center
        return chain

    # -- single-segment evaluation (float64 torch in et) -------------------
    def segment_state(self, seg: SpkSegment, et):
        """State (..., 6) of seg.target relative to seg.center in J2000."""
        data = seg.data
        et = f64(et) if not isinstance(et, torch.Tensor) else et
        if isinstance(data, ChebyshevData):
            state = chebyshev_state(data, et)
        elif isinstance(data, EquinoctialData):
            pos, vel = _jvp_time(lambda t: equinoctial_position(data, t), et)
            state = torch.cat([pos, vel], dim=-1)
        elif isinstance(data, TleData):
            state = self._tle_state(data, et)
        elif isinstance(data, LagrangeData):
            if data.hermite:
                # type 13: velocity is the Hermite interpolant's exact
                # derivative (spke13 semantics)
                pos, vel = _jvp_time(lambda t: lagrange_state(data, t), et)
                state = torch.cat([pos, vel], dim=-1)
            else:
                # type 9: the segment's stored velocity knots are
                # Lagrange-interpolated directly (spke09 semantics)
                state = lagrange_state(data, et)
        elif isinstance(data, TwoBodyData):
            state = self._two_body_state(data, et)
        else:
            raise InsufficientDataError(
                f'SPK data type {seg.data_type} (segment for body '
                f'{seg.target} in {seg.source!r}) is not supported'
            )
        if seg.frame_id != 1:
            rot = f64(frame_id_to_j2000_matrix(seg.frame_id), et.device)
            pos = state[..., :3] @ rot.T
            vel = state[..., 3:] @ rot.T
            state = torch.cat([pos, vel], dim=-1)
        return state

    def _tle_state(self, data: TleData, et):
        """
        Type 10: propagate the bracketing element sets with SGP4 and blend
        linearly between their epochs (single set outside the covered span).
        Packet selection is a ``searchsorted`` on the device of ``et``.
        """
        params = getattr(data, '_sgp4_params', None)
        if params is None:
            params = sgp4_mod.sgp4_init_packets(data.constants, data.packets)
            data._sgp4_params = params  # type: ignore[attr-defined]

        epochs = f64(data.epochs, et.device)
        n = len(data.epochs)
        hi = torch.clamp(
            torch.searchsorted(epochs, et.detach().contiguous()), 0, n - 1
        )
        lo = torch.clamp(hi - 1, 0, n - 1)
        state_lo = sgp4_mod.tle_state_j2000_at_index(
            data.constants, params, lo, et
        )
        state_hi = sgp4_mod.tle_state_j2000_at_index(
            data.constants, params, hi, et
        )
        e_lo = epochs[lo]
        e_hi = epochs[hi]
        gap = torch.where(e_hi > e_lo, e_hi - e_lo, torch.ones_like(e_hi))
        w = torch.clamp((et - e_lo) / gap, 0.0, 1.0)[..., None]
        return state_lo * (1.0 - w) + state_hi * w

    def _two_body_state(self, data: TwoBodyData, et):
        """
        Type 5: two-body propagation of the bracketing discrete states,
        blended linearly in time (SPICE type 5 weighting).
        """
        epochs = f64(data.epochs, et.device)
        states = f64(data.states, et.device)
        n = len(data.epochs)
        hi = torch.clamp(
            torch.searchsorted(epochs, et.detach().contiguous()), 0, n - 1
        )
        lo = torch.clamp(hi - 1, 0, n - 1)
        s_lo = _propagate_two_body(data.gm, states[lo], epochs[lo], et)
        s_hi = _propagate_two_body(data.gm, states[hi], epochs[hi], et)
        e_lo = epochs[lo]
        e_hi = epochs[hi]
        gap = torch.where(e_hi > e_lo, e_hi - e_lo, torch.ones_like(e_hi))
        w = torch.clamp((et - e_lo) / gap, 0.0, 1.0)[..., None]
        return s_lo * (1.0 - w) + s_hi * w

    # -- chain evaluation ----------------------------------------------------
    def position_fn(self, target: int, observer: int, et_ref: float) -> Callable:
        """
        A pure function ``et -> geometric state`` with the chain frozen at
        ``et_ref`` (valid while ``et`` stays within the covering segments,
        i.e. for light-time-scale offsets).
        """
        segs_t, segs_o = self._relative_chains(target, observer, et_ref)

        def fn(et):
            et = f64(et) if not isinstance(et, torch.Tensor) else et
            state = torch.zeros(
                et.shape + (6,), dtype=torch.float64, device=et.device
            )
            for seg in segs_t:
                state = state + self.segment_state(seg, et)
            for seg in segs_o:
                state = state - self.segment_state(seg, et)
            return state

        return fn

    def _relative_chains(self, target: int, observer: int, et0: float):
        # Cache keyed on a coarse time bucket (chains are stable over spans
        # far longer than a day), but resolved at the *actual* epoch so
        # segment-boundary epochs are handled exactly.
        self._refresh()
        key = (target, observer, round(et0 / 86400.0))
        cached = self._chain_cache.get(key)
        if cached is None:
            cached = self._relative_chains_impl(target, observer, et0)
            self._chain_cache[key] = cached
        return cached

    def _relative_chains_impl(self, target: int, observer: int, et0: float):
        chain_t = self.chain(target, et0) if target != SSB else []
        chain_o = self.chain(observer, et0) if observer != SSB else []
        nodes_t = [target] + [s.center for s in chain_t]
        nodes_o = [observer] + [s.center for s in chain_o]
        common = None
        for node in nodes_t:
            if node in nodes_o:
                common = node
                break
        if common is None:
            raise InsufficientDataError(
                f'No common ephemeris node links bodies {target} and '
                f'{observer} (chains end at {nodes_t[-1]} and {nodes_o[-1]})'
            )
        segs_t = tuple(chain_t[: nodes_t.index(common)])
        segs_o = tuple(chain_o[: nodes_o.index(common)])
        return segs_t, segs_o

    # -- aberration-corrected states ------------------------------------------
    def state_function(
        self, target: int, observer: int, abcorr: str, et_ref: float
    ) -> Callable:
        """
        Cached function ``et -> (state6, light_time)`` implementing the
        apparent-state computation. The SPK chain is resolved once at
        ``et_ref`` (bucketed by day).
        """
        key = (target, observer, str(abcorr).strip().upper(),
               round(float(et_ref) / 86400.0))
        fn = self._state_fn_cache.get(key)
        if fn is None:
            fn = self._build_state_function(target, observer, abcorr, et_ref)
            self._state_fn_cache[key] = fn
        return fn

    def _build_state_function(
        self, target: int, observer: int, abcorr: str, et_ref: float
    ) -> Callable:
        corr = parse_abcorr(abcorr)
        pos_rel = self.position_fn(target, observer, et_ref)
        if corr.geometric:
            def geometric_impl(et):
                state = pos_rel(f64(et))
                lt = norm(state[..., :3]) / CLIGHT
                return state, lt

            return geometric_impl

        pos_t = self.position_fn(target, SSB, et_ref)
        pos_o = self.position_fn(observer, SSB, et_ref)
        sign = -1.0 if corr.reception else 1.0
        n_iter = 3 if corr.converged else 1

        def corrected(et):
            obs_state = pos_o(et)
            obs_pos, obs_vel = obs_state[..., :3], obs_state[..., 3:]
            lt = torch.zeros_like(et)
            targ_state = None
            for _ in range(n_iter + 1):
                targ_state = pos_t(et + sign * lt)
                r = targ_state[..., :3] - obs_pos
                lt = norm(r) / CLIGHT
            pos = targ_state[..., :3] - obs_pos
            dist = norm(pos)
            rhat = pos / dist[..., None]

            # d(lt)/d(et) from the implicit definition lt = |r(et)|/c
            targ_vel = targ_state[..., 3:]
            rv_t = torch.sum(rhat * targ_vel, dim=-1)
            rv_o = torch.sum(rhat * obs_vel, dim=-1)
            if corr.reception:
                dltdt = (rv_t - rv_o) / (CLIGHT + rv_t)
                vel = targ_vel * (1.0 - dltdt)[..., None] - obs_vel
            else:
                dltdt = (rv_t - rv_o) / (CLIGHT - rv_t)
                vel = targ_vel * (1.0 + dltdt)[..., None] - obs_vel
            return pos, vel, lt, obs_vel

        def impl(et):
            et = f64(et)
            pos, vel, lt, obs_vel = corrected(et)
            if corr.stellar:
                vbyc = obs_vel / CLIGHT * (1.0 if corr.reception else -1.0)
                pos_corrected = stelab(pos, vbyc)

                # Velocity = d/d(et) of the stellar-corrected position
                # (SPICE's definition), via forward-mode differentiation.
                def stellar_pos(t):
                    p, _, _, ov = corrected(t)
                    vb = ov / CLIGHT * (1.0 if corr.reception else -1.0)
                    return stelab(p, vb)

                _, vel = _jvp_time(stellar_pos, et)
                pos = pos_corrected
            state = torch.cat([pos, vel], dim=-1)
            return state, lt

        return impl

    def spkezr(self, target: int, observer: int, et, abcorr: str = 'CN'):
        """
        Apparent state of target as seen by observer (``spice.spkezr``
        equivalent). Returns ``(state6, light_time)`` as CPU float64
        tensors.
        """
        et_arr = np.asarray(et, dtype=np.float64)
        et_ref = float(et_arr.reshape(-1)[0])
        fn = self.state_function(target, observer, abcorr, et_ref)
        return fn(f64(et_arr))

@dataclass(frozen=True)
class AbcorrFlags:
    geometric: bool
    converged: bool
    stellar: bool
    reception: bool


def parse_abcorr(abcorr: str) -> AbcorrFlags:
    s = (
        abcorr.decode() if isinstance(abcorr, bytes) else str(abcorr)
    ).strip().upper().replace(' ', '')
    if s in ('NONE', ''):
        return AbcorrFlags(True, False, False, True)
    reception = not s.startswith('X')
    s2 = s[1:] if s.startswith('X') else s
    stellar = s2.endswith('+S')
    s3 = s2[:-2] if stellar else s2
    if s3 == 'LT':
        return AbcorrFlags(False, False, stellar, reception)
    if s3 == 'CN':
        return AbcorrFlags(False, True, stellar, reception)
    raise ValueError(f'Unrecognised aberration correction {abcorr!r}')


def stelab(pos, vbyc):
    """
    Stellar aberration correction: rotate ``pos`` towards the observer
    velocity direction by the aberration angle (CSPICE ``stelab`` algorithm).
    """
    vbyc = torch.broadcast_to(vbyc, pos.shape)
    u = pos / norm(pos)[..., None]
    h = torch.linalg.cross(u, vbyc)
    sinphi = norm(h)[..., None]
    phi = torch.asin(torch.clamp(sinphi, -1.0, 1.0))
    # Rodrigues rotation of pos about axis h by angle phi
    safe = torch.where(sinphi > 0.0, sinphi, torch.ones_like(sinphi))
    axis = h / safe
    cosphi = torch.cos(phi)
    rotated = (
        pos * cosphi
        + torch.linalg.cross(axis, pos) * torch.sin(phi)
        + axis * torch.sum(axis * pos, dim=-1, keepdim=True) * (1.0 - cosphi)
    )
    return torch.where(sinphi > 0.0, rotated, pos)


_EPHEMERIS_SINGLETON: Ephemeris | None = None


def get_ephemeris() -> Ephemeris:
    """The ephemeris engine bound to the default (module-level) kernel pool."""
    global _EPHEMERIS_SINGLETON
    if _EPHEMERIS_SINGLETON is None:
        from ..kernels.pool import get_pool

        _EPHEMERIS_SINGLETON = Ephemeris(get_pool())
    return _EPHEMERIS_SINGLETON


def _propagate_two_body(gm: float, state0, epoch0, et):
    """
    Universal-variables two-body propagation (SPK type 5). Batched over
    leading axes; fixed-iteration Newton solve of the universal Kepler
    equation (converges quadratically; 25 iterations is far past machine
    precision for bound orbits).
    """
    state0 = f64(state0, et.device)
    r0 = state0[..., :3]
    v0 = state0[..., 3:]
    dt = et - epoch0

    r0n = norm(r0)
    v0n2 = torch.sum(v0 * v0, dim=-1)
    rv = torch.sum(r0 * v0, dim=-1)
    alpha = 2.0 / r0n - v0n2 / gm  # 1/a
    sqrt_gm = math.sqrt(gm)

    chi = sqrt_gm * torch.abs(alpha) * dt
    for _ in range(25):
        z = alpha * chi * chi
        c2, c3 = _stumpff(z)
        r = (
            chi * chi * c2
            + rv / sqrt_gm * chi * (1.0 - z * c3)
            + r0n * (1.0 - z * c2)
        )
        f_val = (
            chi**3 * c3
            + rv / sqrt_gm * chi * chi * c2
            + r0n * chi * (1.0 - z * c3)
            - sqrt_gm * dt
        )
        chi = chi - f_val / r
    z = alpha * chi * chi
    c2, c3 = _stumpff(z)
    f = 1.0 - chi * chi * c2 / r0n
    g = dt - chi**3 * c3 / sqrt_gm
    r_vec = f[..., None] * r0 + g[..., None] * v0
    rn = norm(r_vec)
    fdot = sqrt_gm / (rn * r0n) * chi * (z * c3 - 1.0)
    gdot = 1.0 - chi * chi * c2 / rn
    v_vec = fdot[..., None] * r0 + gdot[..., None] * v0
    return torch.cat([r_vec, v_vec], dim=-1)


def _stumpff(z):
    sz = torch.sqrt(torch.abs(z) + 1e-300)
    tiny = torch.where(z == 0, 1e-300, 0.0)
    c2_pos = (1.0 - torch.cos(sz)) / torch.abs(z + tiny)
    c3_pos = (sz - torch.sin(sz)) / (sz**3)
    c2_neg = (torch.cosh(sz) - 1.0) / torch.abs(z + tiny)
    c3_neg = (torch.sinh(sz) - sz) / (sz**3)
    small = torch.abs(z) < 1e-8
    c2 = torch.where(
        small, 0.5 - z / 24.0, torch.where(z > 0, c2_pos, c2_neg)
    )
    c3 = torch.where(
        small, 1.0 / 6.0 - z / 120.0, torch.where(z > 0, c3_pos, c3_neg)
    )
    return c2, c3
