"""
Plane-by-plane comparison of two backplane sets (numpy arrays).

Used by the tests and by ``chip_smoke.py`` to hold the CUDA kernel against
its plain float64 PyTorch version, the port against the JAX package, the
per-plane getters against the fused pipeline, and a card body's getters
against a CPU body's.

The kernel tolerances are the JAX package's table for its TPU kernel
(``tests/test_pallas_core.py:673-696``): per-plane absolute bounds (angles
in degrees, 1e-4 unless listed), at most 8 pixels whose NaN mask differs
per plane, and at most 8 LOCAL-SOLAR-TIME pixels a 1-second bin apart.

Longitude planes are compared on the circle (``min(d, 360 - d)``), for
two reasons: a longitude that rounds to either side of the 0/360 seam,
and LON-CENTRIC at ``precision='double'``, where the plain float64 graph
reports (-180, 180] (as the JAX package's ``precision='double'`` graph
does). At the default precision ``'mixed'`` every implementation (the
plain graph on a CPU body, the CUDA kernel, the JAX package's mixed graph
and TPU kernel) reports LON-CENTRIC in [0, 360).
"""

from __future__ import annotations

import numpy as np

from ..ops.backplanes_kernel import DISC_PLANES

#: Absolute tolerances of a kernel against its reference (the JAX
#: package's table); planes not listed are angles in degrees.
KERNEL_TOLERANCE: dict[str, float] = {
    'KM-X': 1e-6, 'KM-Y': 1e-6, 'ANGULAR-X': 1e-6,
    'ANGULAR-Y': 1e-6, 'PIXEL-X': 0.0, 'PIXEL-Y': 0.0,
    'DISTANCE': 1e-3, 'RADIAL-VELOCITY': 1e-6, 'DOPPLER': 1e-9,
    'LIMB-DISTANCE': 0.02, 'RING-RADIUS': 1.0,
    'RING-DISTANCE': 1e-3, 'LOCAL-SOLAR-TIME': 2.9e-4,
}
KERNEL_ANGLE_TOLERANCE = 1e-4
MAX_MASK_FLIPS = 8
MAX_LST_BIN_FLIPS = 8

_LST_HALF_BIN = 0.5 / 3600.0


def kernel_tolerance(name: str) -> float:
    return KERNEL_TOLERANCE.get(name, KERNEL_ANGLE_TOLERANCE)


def as_float32_storage(values) -> np.ndarray:
    """
    ``values`` stored the way the kernels store a plane: rounded to float32
    (and widened back to float64, as the wrappers do for RADIAL-VELOCITY).
    """
    return np.asarray(values).astype(np.float32).astype(np.float64)


def compare_plane(
    name: str, got, ref, *, atol: float, float32_ulps: int = 0,
    exclude=None, max_mask_flips: int = MAX_MASK_FLIPS,
) -> dict:
    """
    Compare one plane. With ``float32_ulps > 0`` the reference is first
    stored as the kernels store a plane (float32) and each bound grows by
    that many float32 units in the last place of the reference value: one
    for two values on either side of a float32 rounding boundary, two when
    ``got`` was also computed in float32 arithmetic. ``exclude`` masks
    pixels out of the value comparison.

    Returns a report dict with ``ok``, ``reason``, ``mask_flips``,
    ``max_abs_err`` (NaN when no pixel is finite in both) and
    ``lst_bin_flips``.
    """
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return dict(ok=False, reason=f'shape {got.shape} != {ref.shape}',
                    mask_flips=-1, max_abs_err=np.nan, lst_bin_flips=0)
    if float32_ulps:
        ref = as_float32_storage(ref)
    mask_flips = int(np.sum(np.isfinite(got) != np.isfinite(ref)))
    both = np.isfinite(got) & np.isfinite(ref)
    if exclude is not None:
        both &= ~np.asarray(exclude, dtype=bool)
    d = np.abs(got[both] - ref[both])
    if 'LON' in name:
        d = np.minimum(d, 360.0 - d)
    bound = np.full(d.shape, atol)
    if float32_ulps:
        bound = bound + float32_ulps * np.spacing(
            np.abs(ref[both]).astype(np.float32)
        )
    lst_flips = 0
    if name == 'LOCAL-SOLAR-TIME':
        lst_flips = int(np.sum(d > _LST_HALF_BIN))
    max_err = float(d.max()) if d.size else float('nan')
    reasons = []
    if mask_flips > max_mask_flips:
        reasons.append(f'{mask_flips} mask flips')
    if d.size and np.any(d > bound):
        k = int(np.argmax(d - bound))
        reasons.append(f'max error {d[k]:.3e} over bound {bound[k]:.3e}')
    if lst_flips > MAX_LST_BIN_FLIPS:
        reasons.append(f'{lst_flips} LST bin flips')
    return dict(
        ok=not reasons, reason='; '.join(reasons), mask_flips=mask_flips,
        max_abs_err=max_err, lst_bin_flips=lst_flips,
    )


def compare_backplanes(
    got: dict, ref: dict, *, tolerance=kernel_tolerance,
    float32_ulps: int = 0, exclude: dict | None = None,
    max_mask_flips: int = MAX_MASK_FLIPS,
) -> dict[str, dict]:
    """
    :func:`compare_plane` for every plane of ``got`` (``ref`` must hold
    each of them); ``tolerance`` maps a plane name to its bound and
    ``exclude`` maps plane names to masks of excluded pixels.
    """
    exclude = exclude or {}
    return {
        name: compare_plane(
            name, got[name], ref[name], atol=tolerance(name),
            float32_ulps=float32_ulps, exclude=exclude.get(name),
            max_mask_flips=max_mask_flips,
        )
        for name in got
    }


def failures(reports: dict[str, dict]) -> dict[str, str]:
    """The planes of a :func:`compare_backplanes` result that failed."""
    return {k: r['reason'] for k, r in reports.items() if not r['ok']}


# ---------------------------------------------------------------------------
# The per-plane getters (get_backplane_img / get_backplane_map)
# ---------------------------------------------------------------------------

#: The JAX package's bars of its fused pipeline against its per-plane
#: getters, ``(atol, rtol)`` (``tests/test_pipeline.py:26-37``); planes
#: not listed: ``(5e-5, 0)``, angles in degrees.
FUSED_TOLERANCE: dict[str, tuple[float, float]] = {
    'DISTANCE': (0.05, 5e-7),
    'RING-DISTANCE': (0.05, 5e-7),
    'RING-RADIUS': (0.05, 5e-7),
    'KM-X': (1e-4, 2e-7),
    'KM-Y': (1e-4, 2e-7),
    'LIMB-DISTANCE': (1e-4, 2e-7),
    'RADIAL-VELOCITY': (1e-5, 0.0),
}
FUSED_DEFAULT_TOLERANCE = (5e-5, 0.0)

#: One LOCAL-SOLAR-TIME bin [h]: the quantisation to whole seconds
LST_BIN = 1.0 / 3600.0

#: Float64 against float64, angles [deg]: the port against the JAX package
#: on the CPU (the JAX package contracts multiply-adds into FMAs, PyTorch's
#: CPU kernels do not), and a card body against a CPU body (CUDA's
#: transcendental functions and sum orders differ from the CPU's in the
#: last ulps; the bar of the map chain's card test)
F64_ANGLE = 1e-9
F64_CARD_ANGLE = 1e-8
#: Float64 against float64 (two implementations of the per-plane getters):
#: planes computed from observer-frame vectors of the target's size (km,
#: angular and limb coordinates, ring radius, distances) are held to this
#: fraction of the target distance, one f64 rounding of those vectors
#: being 1.1e-16 of it
F64_POSITION_RELATIVE = 1e-13
#: km/s; and its Doppler factor, that over the speed of light
F64_VELOCITY = 1e-9
#: The bar is this many times larger where the geometry amplifies rounding
#: (:func:`ill_conditioned`)
ILL_CONDITIONED_FACTOR = 100.0

_POSITION_PLANES = ('KM-X', 'KM-Y', 'LIMB-DISTANCE', 'RING-RADIUS',
                    'DISTANCE', 'RING-DISTANCE')


def per_plane_tolerance(body, *, angle: float, pixel: float):
    """
    ``name -> bar`` for two float64 implementations of a body's per-plane
    getters: ``angle`` [deg] for angles, :data:`F64_POSITION_RELATIVE` of
    the target distance for positions and distances (in arcsec for the
    angular planes), :data:`F64_VELOCITY` for velocities, ``pixel`` for
    the pixel planes and one :data:`LST_BIN` (a floor flip; the bins that
    differ are counted apart) for LOCAL-SOLAR-TIME.
    """
    position = F64_POSITION_RELATIVE * body.target_distance
    table = dict.fromkeys(_POSITION_PLANES, position)
    table.update({
        'ANGULAR-X': position / body.km_per_arcsec,
        'ANGULAR-Y': position / body.km_per_arcsec,
        'RADIAL-VELOCITY': F64_VELOCITY,
        'DOPPLER': F64_VELOCITY / body.speed_of_light(),
        'PIXEL-X': pixel, 'PIXEL-Y': pixel,
        'LOCAL-SOLAR-TIME': LST_BIN * (1 + 1e-9),
    })
    return lambda name: table.get(name, angle)


def ill_conditioned(ref: dict, near_centre: np.ndarray) -> dict[str, np.ndarray]:
    """
    Pixels (or map samples) where a plane's value is ill-conditioned in its
    inputs, from the reference planes ``ref``:

    - surface planes where the ray grazes the surface (emission > 75 deg:
      intercept errors grow as 1/cos(emission));
    - longitudes (and LOCAL-SOLAR-TIME) within 15 deg of a pole (errors
      grow as 1/cos(latitude));
    - AZIMUTH near the sub-solar and sub-observer points (undefined there);
    - limb coordinates of rays passing near the target centre
      (``near_centre``; errors grow as the target radius over the ray's
      distance from the centre) and of limb points within 30 deg of a
      pole.
    """
    emission = ref['EMISSION']
    incidence = ref['INCIDENCE']
    grazing = ~(emission < 75.0)
    polar = ~(np.abs(ref['LAT-GRAPHIC']) < 75.0)
    limb_polar = ~(np.abs(ref['LIMB-LAT-GRAPHIC']) < 60.0)
    caps = (
        grazing | ~(incidence > 5.0) | ~(incidence < 175.0)
        | ~(emission > 5.0)
    )
    out = {name: grazing for name in DISC_PLANES}
    for name in ('LON-GRAPHIC', 'LON-CENTRIC', 'LOCAL-SOLAR-TIME'):
        out[name] = grazing | polar
    out['AZIMUTH'] = caps
    for name in ('LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC'):
        out[name] = near_centre | limb_polar
    return out


def per_plane_ill_conditioned(ref: dict, ray_offset: np.ndarray):
    """
    :func:`ill_conditioned` for the per-plane getters, given each ray's
    distance from the target centre in equatorial radii (``ray_offset``;
    near the centre below 0.5), with two more cases:

    - limb coordinates where the offset times the cosine of the limb
      latitude is below 0.5: a limb longitude errs by the near point's
      position error over that product (the two causes of
      :func:`ill_conditioned`, together);
    - RING-LON-GRAPHIC everywhere: its point is a ray's intercept 1e9 km
      away with a plane seen nearly edge-on (position errors grow as 1/sin
      of the opening angle), computed per pixel rather than from anchors,
      and its longitude errs by that position error over the ring radius.
    """
    out = ill_conditioned(ref, ray_offset < 0.5)
    with np.errstate(invalid='ignore'):
        lever = ray_offset * np.cos(np.radians(ref['LIMB-LAT-GRAPHIC']))
    for name in ('LIMB-DISTANCE', 'LIMB-LON-GRAPHIC', 'LIMB-LAT-GRAPHIC'):
        out[name] = out[name] | ~(lever >= 0.5)
    out['RING-LON-GRAPHIC'] = np.ones(ray_offset.shape, dtype=bool)
    return out


def compare_per_plane(got: dict, ref: dict, tolerance, ill: dict,
                      exclude: dict | None = None) -> dict[str, dict]:
    """
    :func:`compare_plane` of every plane at ``tolerance`` where it is well
    conditioned and at :data:`ILL_CONDITIONED_FACTOR` times it everywhere
    (``ill`` from :func:`per_plane_ill_conditioned`), with the JAX
    package's mask-flip rule (:func:`boundary_flips`); ``exclude`` maps
    plane names to pixels left out of the value comparison. Each report
    adds ``max_abs_err_conditioned`` and ``bar``.
    """
    exclude = exclude or {}
    reports = {}
    for name in got:
        max_mask_flips = max_boundary_flips(np.size(ref[name]))
        left_out = exclude.get(name, np.zeros(np.shape(ref[name]), bool))
        everywhere = compare_plane(
            name, got[name], ref[name],
            atol=tolerance(name) * ILL_CONDITIONED_FACTOR,
            exclude=left_out, max_mask_flips=max_mask_flips,
        )
        conditioned = compare_plane(
            name, got[name], ref[name], atol=tolerance(name),
            exclude=left_out | ill.get(name, False),
            max_mask_flips=max_mask_flips,
        )
        flips = boundary_flips(got[name], ref[name])
        reasons = [r['reason'] for r in (everywhere, conditioned)
                   if r['reason']]
        if flips['off_boundary']:
            reasons.append(f'{flips["off_boundary"]} mask flips off the '
                           'disc boundary')
        reports[name] = dict(
            everywhere, ok=not reasons, reason='; '.join(reasons),
            max_abs_err_conditioned=conditioned['max_abs_err'],
            bar=tolerance(name),
        )
    return reports


def on_mask_boundary(mask: np.ndarray) -> np.ndarray:
    """Cells 8-adjacent to a transition of ``mask`` (tests/test_pipeline.py
    ``_on_disc_boundary``)."""
    padded = np.pad(mask, 1, mode='edge')
    out = np.zeros_like(mask)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= (
                padded[1 + dy:1 + dy + mask.shape[0],
                       1 + dx:1 + dx + mask.shape[1]]
                != mask
            )
    return out


def boundary_flips(got, ref) -> dict[str, int]:
    """
    The NaN-mask flips of ``got`` against ``ref`` and how many of them lie
    off the boundary of ``ref``'s NaN mask; the JAX package's rule allows
    flips only on it, at most :func:`max_boundary_flips` of them.
    """
    nan_ref = np.isnan(np.asarray(ref, dtype=np.float64))
    flips = np.isnan(np.asarray(got, dtype=np.float64)) != nan_ref
    return dict(flips=int(flips.sum()),
                off_boundary=int((flips & ~on_mask_boundary(nan_ref)).sum()))


def max_boundary_flips(size: int) -> int:
    """The JAX package's bound on the mask flips of a plane of ``size``."""
    return max(2, size // 64)


def compare_with_fused(exact: dict, fused: dict,
                       exclude: dict | None = None) -> dict[str, dict]:
    """
    The per-plane getters (``exact``) against the fused pipeline, by the
    JAX package's rule (``tests/test_pipeline.py:54-81``): NaN masks may
    differ only on the disc boundary, in at most
    :func:`max_boundary_flips` pixels; values within ``atol + rtol *
    |exact|`` of :data:`FUSED_TOLERANCE`, longitudes on the circle.
    LOCAL-SOLAR-TIME may also differ by one whole :data:`LST_BIN` where
    the two round to either side of a floor (a bin flip), in at most as
    many pixels as the masks. ``exclude`` maps plane names to pixels left
    out of the value comparison.

    Each report holds ``ok``, ``reason``, ``flips``, ``off_boundary``,
    ``max_excess`` (the largest difference less its bar; negative when
    within it) and ``lst_bin_flips``.
    """
    reports = {}
    for name, plane in exact.items():
        e = np.asarray(plane, dtype=np.float64)
        f = np.asarray(fused[name], dtype=np.float64)
        flips = boundary_flips(f, e)
        bound = max_boundary_flips(e.size)
        both = np.isfinite(e) & np.isfinite(f)
        if exclude and name in exclude:
            both &= ~exclude[name]
        diff = np.abs(e[both] - f[both])
        if 'LON' in name:
            diff = np.minimum(diff, 360.0 - diff)
        lst_flips = 0
        if name == 'LOCAL-SOLAR-TIME':
            flipped = np.abs(diff - LST_BIN) < 0.5 * LST_BIN
            lst_flips = int(flipped.sum())
            diff = np.where(flipped, np.abs(diff - LST_BIN), diff)
        atol, rtol = FUSED_TOLERANCE.get(name, FUSED_DEFAULT_TOLERANCE)
        excess = diff - (atol + rtol * np.abs(e[both]))
        max_excess = float(excess.max()) if excess.size else float('nan')
        reasons = []
        if flips['off_boundary']:
            reasons.append(f'{flips["off_boundary"]} mask flips off the '
                           'disc boundary')
        if flips['flips'] > bound:
            reasons.append(f'{flips["flips"]} mask flips (bound {bound})')
        if excess.size and max_excess >= 0:
            reasons.append(f'max excess {max_excess:.3e} over the bar')
        if lst_flips > bound:
            reasons.append(f'{lst_flips} LST bin flips (bound {bound})')
        reports[name] = dict(
            ok=not reasons, reason='; '.join(reasons), **flips,
            max_excess=max_excess, lst_bin_flips=lst_flips,
        )
    return reports


# ---------------------------------------------------------------------------
# Observation FITS files: headers card by card, mapped data
# ---------------------------------------------------------------------------

#: Header cards that hold angles [deg] (the disc rotation, the sub-points,
#: the north-pole angle, the target's RA/Dec and the map WCS axes)
HEADER_ANGLE_CARDS = frozenset({
    'PLANMAP DISC ROT', 'PLANMAP SUBPOINT LAT', 'PLANMAP SUBPOINT LON',
    'PLANMAP SUBSOL LAT', 'PLANMAP SUBSOL LON', 'PLANMAP NP-ANGLE',
    'PLANMAP TARGET RA', 'PLANMAP TARGET DEC', 'CRVAL1', 'CRVAL2',
    'CDELT1', 'CDELT2',
})
#: Header cards that hold pixel positions [px]
HEADER_PIXEL_CARDS = frozenset({
    'PLANMAP DISC X0', 'PLANMAP DISC Y0', 'PLANMAP DISC R0',
})
#: The card that records when a file was written
HEADER_DATE_CARD = 'PLANMAP DATE'


def compare_headers(got, ref, *, angle: float, pixel: float,
                    relative: float, skip=(HEADER_DATE_CARD,)) -> list[str]:
    """
    Two FITS headers (``io.fits.Header``) card by card: the same keywords
    in the same order with the same comments, strings, booleans and
    integers equal, and floats within ``angle`` [deg] for
    :data:`HEADER_ANGLE_CARDS`, ``pixel`` for :data:`HEADER_PIXEL_CARDS`
    and ``relative`` of the value otherwise. The cards in ``skip`` are
    compared by keyword and comment only. A card's comment is cut to fit
    its 80 characters, so where two values print to different lengths
    (a float's last digits, a date) one comment may be a prefix of the
    other. Returns the differences found (empty when the headers agree).
    """
    got_cards, ref_cards = list(got.cards), list(ref.cards)
    problems = []
    if [c.keyword for c in got_cards] != [c.keyword for c in ref_cards]:
        return [f'keywords {[c.keyword for c in got_cards]} != '
                f'{[c.keyword for c in ref_cards]}']
    for g, r in zip(got_cards, ref_cards):
        numeric = (isinstance(r.value, float) and isinstance(g.value, float))
        comments = (g.comment or '', r.comment or '')
        if comments[0] != comments[1] and not (
                (numeric or r.keyword in skip)
                and min(comments, key=len) == max(comments, key=len)[
                    :len(min(comments, key=len))]):
            problems.append(f'{r.keyword}: comment {g.comment!r} != '
                            f'{r.comment!r}')
        if r.keyword in skip:
            continue
        if not numeric:
            if type(g.value) is not type(r.value) or g.value != r.value:
                problems.append(f'{r.keyword}: {g.value!r} != {r.value!r}')
            continue
        if r.keyword in HEADER_ANGLE_CARDS:
            bar = angle
        elif r.keyword in HEADER_PIXEL_CARDS:
            bar = pixel
        else:
            bar = relative * abs(r.value)
        if not abs(g.value - r.value) <= bar:
            problems.append(f'{r.keyword}: {g.value!r} - {r.value!r} = '
                            f'{g.value - r.value:.3e} (bar {bar:.3e})')
    return problems


def compare_map(got, ref, bar: float) -> dict:
    """
    Mapped data against a reference: the same NaN mask, and values within
    ``bar`` times the reference's largest magnitude when above 1 (the map
    bars of ``tests/test_torch_map.py``). A report with ``ok``,
    ``mask_flips``, ``max_abs_err`` and ``limit``.
    """
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return dict(ok=False, mask_flips=-1, max_abs_err=np.nan,
                    limit=np.nan)
    flips = int((np.isnan(got) != np.isnan(ref)).sum())
    both = ~np.isnan(ref) & ~np.isnan(got)
    err = float(np.max(np.abs(got[both] - ref[both]))) if both.any() else 0.0
    scale = float(np.max(np.abs(ref[both]))) if both.any() else 0.0
    limit = bar * max(scale, 1.0)
    return dict(ok=flips == 0 and err <= limit, mask_flips=flips,
                max_abs_err=err, limit=limit)


def compare_curve(got, ref, bar: float, *, period: float | None = None,
                  scale=None) -> dict:
    """
    A curve (a 1-D array of points in curve order: a limb, a terminator, a
    gridline) against a reference: the same shape; NaN masks equal but for
    at most :data:`MAX_MASK_FLIPS` points, each next to a transition of the
    reference's mask (a point at the visibility threshold); finite values
    within ``bar`` (times ``scale`` per point where given, e.g. a
    longitude's 1/cos(lat) conditioning), differences of a ``period``
    (longitudes: 360) taken on the circle. A report with ``ok``,
    ``mask_flips``, ``off_threshold``, ``max_abs_err`` and ``bar``.
    """
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape or ref.ndim != 1:
        return dict(ok=False, mask_flips=-1, off_threshold=-1,
                    max_abs_err=np.nan, bar=bar)
    nan_ref = np.isnan(ref)
    flips = np.isnan(got) != nan_ref
    edge = np.zeros_like(nan_ref)
    edge[1:] |= nan_ref[1:] != nan_ref[:-1]
    edge[:-1] |= nan_ref[1:] != nan_ref[:-1]
    both = ~nan_ref & ~np.isnan(got)
    diff = got - ref
    if period is not None:
        diff = (diff + period / 2) % period - period / 2
    limit = bar * (np.ones_like(ref) if scale is None
                   else np.asarray(scale, dtype=np.float64))
    err = float(np.max(np.abs(diff[both]))) if both.any() else 0.0
    excess = (bool(np.any(np.abs(diff[both]) > limit[both]))
              if both.any() else False)
    off = int((flips & ~edge).sum())
    return dict(ok=not excess and off == 0
                and int(flips.sum()) <= MAX_MASK_FLIPS,
                mask_flips=int(flips.sum()), off_threshold=off,
                max_abs_err=err, bar=bar)
