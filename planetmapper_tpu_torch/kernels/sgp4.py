"""
SGP4 propagation and TEME->J2000 rotation for SPK type 10 segments.

Port of ``planetmapper_tpu.kernels.sgp4``: the standard SGP4 near-earth
analytic satellite propagator (Spacetrack Report #3 as revised by Vallado
et al., "Revisiting Spacetrack Report #3", the algorithm CSPICE uses for
SPK type 10 via ``spice.spkezr`` on spacecraft like HST; reference call
site: planetmapper/base.py:828 with observer='HST').

The element-set initialisation (:func:`sgp4_init_packets`, the deep-space
DSCOM/DSINIT stages) is host numpy, computed once per segment at parse
time, as in the JAX package. Propagation (:func:`sgp4_propagate`,
``_dspace``, ``_dpper``) and the frame rotation (TEME -> J2000 via IAU 1976
precession + recorded nutation angles) are float64 PyTorch functions of
time: batched over leading axes, on the device of their time argument,
and differentiable with ``torch.func`` (fixed-iteration Kepler solve, no
data-dependent control flow). Gravity model constants (J2, J3, J4, KE,
QO, SO, ER, AE) come from the segment itself.

Deep-space element sets (period >= 225 min) take the SDP4 extension: the
lunar-solar secular/periodic perturbations and the 12h/24h geopotential
resonance terms of the original Spacetrack Report #3 deep-space model (the
algorithm CSPICE applies via DPSPCE for such sets). The resonance
integrator (720-minute steps from the element epoch) is a loop of a fixed
number of masked steps, vectorised over times; the step bound is derived
from the element-set spacing at parse time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ARCSEC = math.pi / (180.0 * 3600.0)
CENTURY = 36525.0 * 86400.0


@dataclass(frozen=True)
class Sgp4Constants:
    j2: float
    j3: float
    j4: float
    ke: float  # sqrt(GM) in (earth radii)^1.5 / minute
    qo: float  # density function upper altitude bound [km]
    so: float  # density function lower altitude bound [km]
    er: float  # equatorial earth radius [km]
    ae: float  # distance units / earth radius (1.0)


@dataclass(frozen=True)
class Sgp4Elements:
    """One element set, index layout per CSPICE ``spkw10``."""

    ndt20: float
    ndd60: float
    bstar: float
    inclo: float
    nodeo: float
    ecco: float
    argpo: float
    mo: float
    no_kozai: float  # mean motion [rad/min]
    epoch: float  # TDB seconds past J2000
    nu_obliquity: float  # nutation in obliquity at epoch [rad]
    nu_longitude: float  # nutation in longitude at epoch [rad]
    dnu_obliquity: float  # [rad/s]
    dnu_longitude: float  # [rad/s]


def sgp4_init_packets(constants: np.ndarray, packets: np.ndarray) -> dict:
    """
    Vectorised element-set initialisation over all packets of a segment: the
    standard ``sgp4init`` secular/periodic coefficient computation for the
    near-earth case, computed with numpy broadcasting on the host at parse
    time. Returns a dict of (n,)-shaped parameter arrays, ready to be
    gathered per-time on device.
    """
    c = Sgp4Constants(*(float(v) for v in constants[:8]))
    pk = np.asarray(packets, dtype=np.float64)
    bstar = pk[:, 2]
    inclo = pk[:, 3]
    nodeo = pk[:, 4]
    ecco = pk[:, 5]
    argpo = pk[:, 6]
    mo = pk[:, 7]
    no_kozai = pk[:, 8]
    epoch = pk[:, 9]

    j2, j3, j4, xke = c.j2, c.j3, c.j4, c.ke
    x2o3 = 2.0 / 3.0

    eccsq = ecco * ecco
    omeosq = 1.0 - eccsq
    rteosq = np.sqrt(omeosq)
    cosio = np.cos(inclo)
    cosio2 = cosio * cosio
    sinio = np.sin(inclo)

    # Un-Kozai the mean motion
    ak = (xke / no_kozai) ** x2o3
    d1 = 0.75 * j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
    delp = d1 / (ak * ak)
    adel = ak * (1.0 - delp * delp - delp * (1.0 / 3.0 + 134.0 * delp * delp / 81.0))
    delp = d1 / (adel * adel)
    no = no_kozai / (1.0 + delp)

    # Original Spacetrack Report #3 semi-major-axis recovery
    # (AODP = AO/(1-DEL0)), as in CSPICE's EV2LIN; Vallado's revision uses
    # (xke/no)^(2/3), which differs at O(del0^2) (~1 m radial for LEO).
    ao = adel / (1.0 - delp)
    po = ao * omeosq
    con42 = 1.0 - 5.0 * cosio2
    con41 = -con42 - 2.0 * cosio2
    posq = po * po
    rp = ao * (1.0 - ecco)

    perige = (rp - 1.0) * c.er
    sfour = np.where(
        perige < 156.0, np.where(perige < 98.0, 20.0, perige - 78.0), np.nan
    )
    qzms24 = np.where(
        perige < 156.0,
        ((120.0 - sfour) / c.er) ** 4,
        ((c.qo - c.so) / c.er) ** 4,
    )
    sfour = np.where(perige < 156.0, sfour / c.er + 1.0, 78.0 / c.er + 1.0)
    pinvsq = 1.0 / posq

    tsi = 1.0 / (ao - sfour)
    eta = ao * ecco * tsi
    etasq = eta * eta
    eeta = ecco * eta
    psisq = np.abs(1.0 - etasq)
    coef = qzms24 * tsi**4
    coef1 = coef / psisq**3.5
    cc2 = coef1 * no * (
        ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
        + 0.375 * j2 * tsi / psisq * con41
        * (8.0 + 3.0 * etasq * (8.0 + etasq))
    )
    cc1 = bstar * cc2
    with np.errstate(divide='ignore', invalid='ignore'):
        cc3 = np.where(
            ecco > 1.0e-4,
            -2.0 * coef * tsi * (j3 / j2) * no * sinio / np.where(
                ecco > 1.0e-4, ecco, 1.0
            ),
            0.0,
        )
    x1mth2 = 1.0 - cosio2
    cc4 = 2.0 * no * coef1 * ao * omeosq * (
        eta * (2.0 + 0.5 * etasq)
        + ecco * (0.5 + 2.0 * etasq)
        - j2 * tsi / (ao * psisq)
        * (
            -3.0 * con41 * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
            + 0.75 * x1mth2 * (2.0 * etasq - eeta * (1.0 + etasq))
            * np.cos(2.0 * argpo)
        )
    )
    cc5 = 2.0 * coef1 * ao * omeosq * (1.0 + 2.75 * (etasq + eeta) + eeta * etasq)
    cosio4 = cosio2 * cosio2
    temp1 = 1.5 * j2 * pinvsq * no
    temp2 = 0.5 * temp1 * j2 * pinvsq
    temp3 = -0.46875 * j4 * pinvsq * pinvsq * no
    mdot = (
        no
        + 0.5 * temp1 * rteosq * con41
        + 0.0625 * temp2 * rteosq * (13.0 - 78.0 * cosio2 + 137.0 * cosio4)
    )
    argpdot = (
        -0.5 * temp1 * con42
        + 0.0625 * temp2 * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
        + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4)
    )
    xhdot1 = -temp1 * cosio
    nodedot = xhdot1 + (
        0.5 * temp2 * (4.0 - 19.0 * cosio2)
        + 2.0 * temp3 * (3.0 - 7.0 * cosio2)
    ) * cosio
    omgcof = bstar * cc3 * np.cos(argpo)
    xmcof = np.where(
        ecco > 1.0e-4,
        -x2o3 * coef * bstar / np.where(eeta != 0.0, eeta, 1.0),
        0.0,
    )
    nodecf = 3.5 * omeosq * xhdot1 * cc1
    t2cof = 1.5 * cc1
    denom = np.where(np.abs(cosio + 1.0) > 1.5e-12, 1.0 + cosio, 1.5e-12)
    xlcof = -0.25 * (j3 / j2) * sinio * (3.0 + 5.0 * cosio) / denom
    aycof = -0.5 * (j3 / j2) * sinio
    delmo = (1.0 + eta * np.cos(mo)) ** 3
    sinmao = np.sin(mo)
    x7thm1 = 7.0 * cosio2 - 1.0

    isimp = (rp < (220.0 / c.er + 1.0)).astype(np.float64)
    cc1sq = cc1 * cc1
    d2 = 4.0 * ao * tsi * cc1sq
    temp = d2 * tsi * cc1 / 3.0
    d3 = (17.0 * ao + sfour) * temp
    d4 = 0.5 * temp * ao * tsi * (221.0 * ao + 31.0 * sfour) * cc1
    t3cof = d2 + 2.0 * cc1sq
    t4cof = 0.25 * (3.0 * d3 + cc1 * (12.0 * d2 + 10.0 * cc1sq))
    t5cof = 0.2 * (
        3.0 * d4
        + 12.0 * cc1 * d3
        + 6.0 * d2 * d2
        + 15.0 * cc1sq * (2.0 * d2 + cc1sq)
    )

    deep = (2.0 * math.pi / no) >= 225.0
    isimp = np.where(deep, 1.0, isimp)

    params = dict(
        no=no, cc1=cc1, cc4=cc4, cc5=cc5, d2=d2, d3=d3, d4=d4,
        t2cof=t2cof, t3cof=t3cof, t4cof=t4cof, t5cof=t5cof,
        mdot=mdot, argpdot=argpdot, nodedot=nodedot, nodecf=nodecf,
        omgcof=omgcof, xmcof=xmcof, eta=eta, delmo=delmo, sinmao=sinmao,
        x1mth2=x1mth2, x7thm1=x7thm1, con41=con41, xlcof=xlcof, aycof=aycof,
        isimp=isimp, deep=deep.astype(np.float64),
        ecco=ecco, inclo=inclo, nodeo=nodeo, argpo=argpo, mo=mo,
        bstar=bstar, epoch=epoch,
        nu_obliquity=pk[:, 10], nu_longitude=pk[:, 11],
        dnu_obliquity=pk[:, 12], dnu_longitude=pk[:, 13],
    )
    params['_has_deep'] = bool(np.any(deep))
    if params['_has_deep']:
        params.update(
            _deep_space_init(
                c, epoch, ecco, inclo, nodeo, argpo, mo, no,
                mdot, argpdot, nodedot,
            )
        )
        # Static bound for the 720-minute resonance integrator. The
        # evaluator blends the BRACKETING element sets (not the nearest),
        # so the far packet sees |t - epoch| up to the FULL largest
        # inter-set gap; allow a generous margin for use beyond the ends.
        gaps_min = (
            np.diff(np.sort(epoch)) / 60.0 if len(epoch) > 1
            else np.array([0.0])
        )
        reach = float(np.max(gaps_min, initial=0.0)) + 40320.0
        params['_ds_max_steps'] = int(
            min(1024, max(8, math.ceil(reach / 720.0)))
        )
    return params


def _deep_space_init(
    c: Sgp4Constants,
    epoch: np.ndarray,
    ecco: np.ndarray,
    inclo: np.ndarray,
    nodeo: np.ndarray,
    argpo: np.ndarray,
    mo: np.ndarray,
    no: np.ndarray,
    mdot: np.ndarray,
    argpdot: np.ndarray,
    nodedot: np.ndarray,
) -> dict:
    """
    Vectorised deep-space initialisation (the DSCOM/DSINIT stages of the
    Spacetrack Report #3 deep-space model): lunar-solar periodic
    coefficients, secular element rates and the 12h/24h geopotential
    resonance coefficients, computed for every packet of the segment with
    numpy broadcasting. Values are only *used* where ``deep`` is set.
    ``epoch`` is TDB seconds past J2000 (the type 10 packet convention;
    the sidereal/lunar-solar phase formulae below consume it directly,
    like the CSPICE evaluator, rather than converting to UTC).
    """
    twopi = 2.0 * math.pi
    # Days since 1949 Dec 31 00:00 (JD 2433281.5), the deep-space model's
    # time origin ("ds50")
    ds50 = epoch / 86400.0 + 18263.5
    day = ds50 + 18261.5

    em = ecco
    emsq = em * em
    sinim = np.sin(inclo)
    cosim = np.cos(inclo)
    snodm = np.sin(nodeo)
    cnodm = np.cos(nodeo)
    sinomm = np.sin(argpo)
    cosomm = np.cos(argpo)
    betasq = 1.0 - emsq
    rtemsq = np.sqrt(betasq)

    # -- lunar orbital geometry at epoch ---------------------------------
    xnodce = np.mod(4.5236020 - 9.2422029e-4 * day, twopi)
    stem = np.sin(xnodce)
    ctem = np.cos(xnodce)
    zcosil = 0.91375164 - 0.03568096 * ctem
    zsinil = np.sqrt(1.0 - zcosil * zcosil)
    zsinhl = 0.089683511 * stem / zsinil
    zcoshl = np.sqrt(1.0 - zsinhl * zsinhl)
    gam = 5.8351514 + 0.0019443680 * day
    zx = 0.39785416 * stem / zsinil
    zy = zcoshl * ctem + 0.91744867 * zsinhl * stem
    zx = np.arctan2(zx, zy) + gam - xnodce
    zcosgl = np.cos(zx)
    zsingl = np.sin(zx)

    zes = 0.01675
    zel = 0.05490
    c1ss = 2.9864797e-6
    c1l = 4.7968065e-7
    zsinis = 0.39785416
    zcosis = 0.91744867
    zcosgs = 0.1945905
    zsings = -0.98088458
    xnoi = 1.0 / no

    def third_body(zcosg, zsing, zcosi, zsini, zcosh, zsinh, cc):
        a1 = zcosg * zcosh + zsing * zcosi * zsinh
        a3 = -zsing * zcosh + zcosg * zcosi * zsinh
        a7 = -zcosg * zsinh + zsing * zcosi * zcosh
        a8 = zsing * zsini
        a9 = zsing * zsinh + zcosg * zcosi * zcosh
        a10 = zcosg * zsini
        a2 = cosim * a7 + sinim * a8
        a4 = cosim * a9 + sinim * a10
        a5 = -sinim * a7 + cosim * a8
        a6 = -sinim * a9 + cosim * a10
        x1 = a1 * cosomm + a2 * sinomm
        x2 = a3 * cosomm + a4 * sinomm
        x3 = -a1 * sinomm + a2 * cosomm
        x4 = -a3 * sinomm + a4 * cosomm
        x5 = a5 * sinomm
        x6 = a6 * sinomm
        x7 = a5 * cosomm
        x8 = a6 * cosomm
        z31 = 12.0 * x1 * x1 - 3.0 * x3 * x3
        z32 = 24.0 * x1 * x2 - 6.0 * x3 * x4
        z33 = 12.0 * x2 * x2 - 3.0 * x4 * x4
        z1 = 3.0 * (a1 * a1 + a2 * a2) + z31 * emsq
        z2 = 6.0 * (a1 * a3 + a2 * a4) + z32 * emsq
        z3 = 3.0 * (a3 * a3 + a4 * a4) + z33 * emsq
        z11 = -6.0 * a1 * a5 + emsq * (-24.0 * x1 * x7 - 6.0 * x3 * x5)
        z12 = -6.0 * (a1 * a6 + a3 * a5) + emsq * (
            -24.0 * (x2 * x7 + x1 * x8) - 6.0 * (x3 * x6 + x4 * x5)
        )
        z13 = -6.0 * a3 * a6 + emsq * (-24.0 * x2 * x8 - 6.0 * x4 * x6)
        z21 = 6.0 * a2 * a5 + emsq * (24.0 * x1 * x5 - 6.0 * x3 * x7)
        z22 = 6.0 * (a4 * a5 + a2 * a6) + emsq * (
            24.0 * (x2 * x5 + x1 * x6) - 6.0 * (x4 * x7 + x3 * x8)
        )
        z23 = 6.0 * a4 * a6 + emsq * (24.0 * x2 * x6 - 6.0 * x4 * x8)
        z1 = z1 + z1 + betasq * z31
        z2 = z2 + z2 + betasq * z32
        z3 = z3 + z3 + betasq * z33
        s3 = cc * xnoi
        s2 = -0.5 * s3 / rtemsq
        s4 = s3 * rtemsq
        s1 = -15.0 * em * s4
        s5 = x1 * x3 + x2 * x4
        s6 = x2 * x3 + x1 * x4
        s7 = x2 * x4 - x1 * x3
        return dict(
            s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6, s7=s7,
            z1=z1, z2=z2, z3=z3, z11=z11, z12=z12, z13=z13,
            z21=z21, z22=z22, z23=z23, z31=z31, z32=z32, z33=z33,
        )

    sun = third_body(
        zcosgs, zsings, zcosis, zsinis, cnodm, snodm, c1ss
    )
    moon = third_body(
        zcosgl, zsingl, zcosil, zsinil,
        zcoshl * cnodm + zsinhl * snodm,
        snodm * zcoshl - cnodm * zsinhl,
        c1l,
    )

    zmol = np.mod(4.7199672 + 0.22997150 * day - gam, twopi)
    zmos = np.mod(6.2565837 + 0.017201977 * day, twopi)

    # -- lunar-solar periodic coefficients -------------------------------
    out = dict(
        se2=2.0 * sun['s1'] * sun['s6'],
        se3=2.0 * sun['s1'] * sun['s7'],
        si2=2.0 * sun['s2'] * sun['z12'],
        si3=2.0 * sun['s2'] * (sun['z13'] - sun['z11']),
        sl2=-2.0 * sun['s3'] * sun['z2'],
        sl3=-2.0 * sun['s3'] * (sun['z3'] - sun['z1']),
        sl4=-2.0 * sun['s3'] * (-21.0 - 9.0 * emsq) * zes,
        sgh2=2.0 * sun['s4'] * sun['z32'],
        sgh3=2.0 * sun['s4'] * (sun['z33'] - sun['z31']),
        sgh4=-18.0 * sun['s4'] * zes,
        sh2=-2.0 * sun['s2'] * sun['z22'],
        sh3=-2.0 * sun['s2'] * (sun['z23'] - sun['z21']),
        ee2=2.0 * moon['s1'] * moon['s6'],
        e3=2.0 * moon['s1'] * moon['s7'],
        xi2=2.0 * moon['s2'] * moon['z12'],
        xi3=2.0 * moon['s2'] * (moon['z13'] - moon['z11']),
        xl2=-2.0 * moon['s3'] * moon['z2'],
        xl3=-2.0 * moon['s3'] * (moon['z3'] - moon['z1']),
        xl4=-2.0 * moon['s3'] * (-21.0 - 9.0 * emsq) * zel,
        xgh2=2.0 * moon['s4'] * moon['z32'],
        xgh3=2.0 * moon['s4'] * (moon['z33'] - moon['z31']),
        xgh4=-18.0 * moon['s4'] * zel,
        xh2=-2.0 * moon['s2'] * moon['z22'],
        xh3=-2.0 * moon['s2'] * (moon['z23'] - moon['z21']),
        zmol=zmol, zmos=zmos,
    )

    # -- DSINIT: secular rates -------------------------------------------
    zns = 1.19459e-5
    znl = 1.5835218e-4
    near_polar_or_equatorial = (inclo < 5.2359877e-2) | (
        inclo > math.pi - 5.2359877e-2
    )
    sin_safe = np.where(sinim != 0.0, sinim, 1.0)

    ses = sun['s1'] * zns * sun['s5']
    sis = sun['s2'] * zns * (sun['z11'] + sun['z13'])
    sls = -zns * sun['s3'] * (sun['z1'] + sun['z3'] - 14.0 - 6.0 * emsq)
    sghs = sun['s4'] * zns * (sun['z31'] + sun['z33'] - 6.0)
    shs = -zns * sun['s2'] * (sun['z21'] + sun['z23'])
    shs = np.where(near_polar_or_equatorial, 0.0, shs)
    shs = np.where(sinim != 0.0, shs / sin_safe, shs)
    sgs = sghs - cosim * shs

    dedt = ses + moon['s1'] * znl * moon['s5']
    didt = sis + moon['s2'] * znl * (moon['z11'] + moon['z13'])
    dmdt = sls - znl * moon['s3'] * (
        moon['z1'] + moon['z3'] - 14.0 - 6.0 * emsq
    )
    sghl = moon['s4'] * znl * (moon['z31'] + moon['z33'] - 6.0)
    shll = -znl * moon['s2'] * (moon['z21'] + moon['z23'])
    shll = np.where(near_polar_or_equatorial, 0.0, shll)
    domdt = sgs + sghl
    dnodt = shs
    domdt = np.where(
        sinim != 0.0, domdt - cosim / sin_safe * shll, domdt
    )
    dnodt = np.where(sinim != 0.0, dnodt + shll / sin_safe, dnodt)
    out.update(dedt=dedt, didt=didt, dmdt=dmdt, domdt=domdt, dnodt=dnodt)

    # -- GMST at epoch (original AFSPC formulation) ----------------------
    ts70 = ds50 - 7305.0
    ds70 = np.floor(ts70 + 1.0e-8)
    tfrac = ts70 - ds70
    c1_ = 1.72027916940703639e-2
    thgr70 = 1.7321343856509374
    fk5r = 5.07551419432269442e-15
    gsto = np.mod(
        thgr70 + c1_ * ds70 + (c1_ + twopi) * tfrac + ts70 * ts70 * fk5r,
        twopi,
    )
    out['gsto'] = gsto

    # -- resonance classification ----------------------------------------
    irez = np.zeros_like(no)
    irez = np.where((no < 0.0052359877) & (no > 0.0034906585), 1.0, irez)
    irez = np.where(
        (no >= 8.26e-3) & (no <= 9.24e-3) & (em >= 0.5), 2.0, irez
    )
    out['irez'] = irez

    q22 = 1.7891679e-6
    q31 = 2.1460748e-6
    q33 = 2.2123015e-7
    root22 = 1.7891679e-6
    root44 = 7.3636953e-9
    root54 = 2.1765803e-9
    rptim = 4.37526908801129966e-3
    root32 = 3.7393792e-7
    root52 = 1.1428639e-7
    aonv = (no / c.ke) ** (2.0 / 3.0)
    cosisq = cosim * cosim
    eoc = em * emsq

    # 12h (2:1) geopotential resonance coefficients (Molniya-class)
    g201 = -0.306 - (em - 0.64) * 0.440
    lo = em <= 0.65
    g211 = np.where(
        lo, 3.616 - 13.2470 * em + 16.2900 * emsq,
        -72.099 + 331.819 * em - 508.738 * emsq + 266.724 * eoc,
    )
    g310 = np.where(
        lo, -19.302 + 117.3900 * em - 228.4190 * emsq + 156.5910 * eoc,
        -346.844 + 1582.851 * em - 2415.925 * emsq + 1246.113 * eoc,
    )
    g322 = np.where(
        lo, -18.9068 + 109.7927 * em - 214.6334 * emsq + 146.5816 * eoc,
        -342.585 + 1554.908 * em - 2366.899 * emsq + 1215.972 * eoc,
    )
    g410 = np.where(
        lo, -41.122 + 242.6940 * em - 471.0940 * emsq + 313.9530 * eoc,
        -1052.797 + 4758.686 * em - 7193.992 * emsq + 3651.957 * eoc,
    )
    g422 = np.where(
        lo, -146.407 + 841.8800 * em - 2188.8500 * emsq + 2936.4920 * eoc,
        -3581.690 + 16178.110 * em - 24462.770 * emsq + 12422.520 * eoc,
    )
    g520 = np.where(
        lo, -532.114 + 3017.977 * em - 5740.032 * emsq + 3708.2760 * eoc,
        np.where(
            em > 0.715,
            -5149.66 + 29936.92 * em - 54087.36 * emsq + 31324.56 * eoc,
            1464.74 - 4664.75 * em + 3763.64 * emsq,
        ),
    )
    hi7 = em >= 0.7
    g533 = np.where(
        hi7, -37995.780 + 161616.52 * em - 229838.20 * emsq
        + 109377.94 * eoc,
        -919.22770 + 4988.6100 * em - 9064.7700 * emsq + 5542.21 * eoc,
    )
    g521 = np.where(
        hi7, -51752.104 + 218913.95 * em - 309468.16 * emsq
        + 146349.42 * eoc,
        -822.71072 + 4568.6173 * em - 8491.4146 * emsq + 4640.7400 * eoc,
    )
    g532 = np.where(
        hi7, -40023.880 + 170470.89 * em - 242699.48 * emsq
        + 115605.82 * eoc,
        -853.66600 + 4690.2500 * em - 8624.7700 * emsq + 5341.4 * eoc,
    )
    sini2 = sinim * sinim
    f220 = 0.75 * (1.0 + 2.0 * cosim + cosisq)
    f221 = 1.5 * sini2
    f321 = 1.875 * sinim * (1.0 - 2.0 * cosim - 3.0 * cosisq)
    f322 = -1.875 * sinim * (1.0 + 2.0 * cosim - 3.0 * cosisq)
    f441 = 35.0 * sini2 * f220
    f442 = 39.3750 * sini2 * sini2
    f522 = 9.84375 * sinim * (
        sini2 * (1.0 - 2.0 * cosim - 5.0 * cosisq)
        + 0.33333333 * (-2.0 + 4.0 * cosim + 6.0 * cosisq)
    )
    f523 = sinim * (
        4.92187512 * sini2 * (-2.0 - 4.0 * cosim + 10.0 * cosisq)
        + 6.56250012 * (1.0 + 2.0 * cosim - 3.0 * cosisq)
    )
    f542 = 29.53125 * sinim * (
        2.0 - 8.0 * cosim + cosisq * (-12.0 + 8.0 * cosim + 10.0 * cosisq)
    )
    f543 = 29.53125 * sinim * (
        -2.0 - 8.0 * cosim + cosisq * (12.0 + 8.0 * cosim - 10.0 * cosisq)
    )
    # ``aonv`` is the RECIPROCAL semi-major axis (n/ke)^(2/3) = 1/a [ER];
    # successive multiplications by it supply the 1/a^k resonance scaling
    xno2 = no * no
    ainv2 = aonv * aonv
    temp1 = 3.0 * xno2 * ainv2
    temp = temp1 * root22
    d2201 = temp * f220 * g201
    d2211 = temp * f221 * g211
    temp1 = temp1 * aonv
    temp = temp1 * root32
    d3210 = temp * f321 * g310
    d3222 = temp * f322 * g322
    temp1 = temp1 * aonv
    temp = 2.0 * temp1 * root44
    d4410 = temp * f441 * g410
    d4422 = temp * f442 * g422
    temp1 = temp1 * aonv
    temp = temp1 * root52
    d5220 = temp * f522 * g520
    d5232 = temp * f523 * g532
    temp = 2.0 * temp1 * root54
    d5421 = temp * f542 * g521
    d5433 = temp * f543 * g533
    xlamo_2 = np.mod(mo + nodeo + nodeo - gsto - gsto, twopi)
    xfact_2 = (
        mdot + dmdt + 2.0 * (nodedot + dnodt - rptim) - no
    )

    # 24h (1:1) synchronous resonance coefficients (geostationary-class)
    g200 = 1.0 + emsq * (-2.5 + 0.8125 * emsq)
    g310s = 1.0 + 2.0 * emsq
    g300 = 1.0 + emsq * (-6.0 + 6.60937 * emsq)
    f220s = 0.75 * (1.0 + cosim) * (1.0 + cosim)
    f311 = (
        0.9375 * sinim * sinim * (1.0 + 3.0 * cosim)
        - 0.75 * (1.0 + cosim)
    )
    f330 = 1.0 + cosim
    f330 = 1.875 * f330 * f330 * f330
    del1_ = 3.0 * no * no * aonv * aonv
    del2_ = 2.0 * del1_ * f220s * g200 * q22
    del3_ = 3.0 * del1_ * f330 * g300 * q33 * aonv
    del1_ = del1_ * f311 * g310s * q31 * aonv
    xlamo_1 = np.mod(mo + nodeo + argpo - gsto, twopi)
    xpidot = argpdot + nodedot
    xfact_1 = (
        mdot + xpidot - rptim + dmdt + domdt + dnodt - no
    )

    is_sync = irez == 1.0
    out.update(
        d2201=d2201, d2211=d2211, d3210=d3210, d3222=d3222,
        d4410=d4410, d4422=d4422, d5220=d5220, d5232=d5232,
        d5421=d5421, d5433=d5433,
        del1=del1_, del2=del2_, del3=del3_,
        xlamo=np.where(is_sync, xlamo_1, xlamo_2),
        xfact=np.where(is_sync, xfact_1, xfact_2),
    )
    return out


def _as_f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64)


def _dspace(c: Sgp4Constants, p: dict, t, xmdf, argpdf, nodem_in,
            max_steps: int):
    """
    Deep-space secular rates + 12h/24h resonance integration (the DSPACE
    stage). ``t`` is minutes since the element epoch. The original
    integrates in 720-minute steps from the epoch; here the integrator is
    a loop of ``max_steps`` masked steps (always restarted from the epoch,
    matching the original's behaviour for a fresh propagation), so every
    time of a batch takes the same operations. Returns the deep-space-
    corrected mean elements ``(em, inclm, argpm, nodem, mm, nm)``.
    """
    twopi = 2.0 * math.pi
    fasx2 = 0.13130908
    fasx4 = 2.8843198
    fasx6 = 0.37448087
    g22 = 5.7686396
    g32 = 0.95240898
    g44 = 1.8014998
    g52 = 1.0508330
    g54 = 4.4108898
    rptim = 4.37526908801129966e-3
    stepp = 720.0
    step2 = 259200.0

    em = p['ecco'] + p['dedt'] * t
    inclm = p['inclo'] + p['didt'] * t
    argpm = argpdf + p['domdt'] * t
    nodem = nodem_in + p['dnodt'] * t
    mm = xmdf + p['dmdt'] * t
    theta = torch.remainder(p['gsto'] + t * rptim, twopi)

    irez = p['irez']
    resonant = irez > 0.5
    is_sync = torch.abs(irez - 1.0) < 0.5

    def rates(xli, xni, atime):
        # synchronous (1:1) terms
        xndt_s = (
            p['del1'] * torch.sin(xli - fasx2)
            + p['del2'] * torch.sin(2.0 * (xli - fasx4))
            + p['del3'] * torch.sin(3.0 * (xli - fasx6))
        )
        xnddt_s = (
            p['del1'] * torch.cos(xli - fasx2)
            + 2.0 * p['del2'] * torch.cos(2.0 * (xli - fasx4))
            + 3.0 * p['del3'] * torch.cos(3.0 * (xli - fasx6))
        )
        # half-day (2:1) resonance terms
        xomi = p['argpo'] + p['argpdot'] * atime
        x2omi = xomi + xomi
        x2li = xli + xli
        xndt_r = (
            p['d2201'] * torch.sin(x2omi + xli - g22)
            + p['d2211'] * torch.sin(xli - g22)
            + p['d3210'] * torch.sin(xomi + xli - g32)
            + p['d3222'] * torch.sin(-xomi + xli - g32)
            + p['d4410'] * torch.sin(x2omi + x2li - g44)
            + p['d4422'] * torch.sin(x2li - g44)
            + p['d5220'] * torch.sin(xomi + xli - g52)
            + p['d5232'] * torch.sin(-xomi + xli - g52)
            + p['d5421'] * torch.sin(xomi + x2li - g54)
            + p['d5433'] * torch.sin(-xomi + x2li - g54)
        )
        xnddt_r = (
            p['d2201'] * torch.cos(x2omi + xli - g22)
            + p['d2211'] * torch.cos(xli - g22)
            + p['d3210'] * torch.cos(xomi + xli - g32)
            + p['d3222'] * torch.cos(-xomi + xli - g32)
            + p['d5220'] * torch.cos(xomi + xli - g52)
            + p['d5232'] * torch.cos(-xomi + xli - g52)
            + 2.0 * (
                p['d4410'] * torch.cos(x2omi + x2li - g44)
                + p['d4422'] * torch.cos(x2li - g44)
                + p['d5421'] * torch.cos(xomi + x2li - g54)
                + p['d5433'] * torch.cos(-xomi + x2li - g54)
            )
        )
        xndt = torch.where(is_sync, xndt_s, xndt_r)
        xldot = xni + p['xfact']
        xnddt = torch.where(is_sync, xnddt_s, xnddt_r) * xldot
        return xndt, xldot, xnddt

    delt = torch.where(t >= 0.0, stepp, -stepp)

    xli = p['xlamo'] + 0.0 * t
    xni = p['no'] + 0.0 * t
    atime = torch.zeros_like(t)
    for _ in range(max_steps):
        xndt, xldot, xnddt = rates(xli, xni, atime)
        need = (torch.abs(t - atime) >= stepp) & resonant
        xli = torch.where(need, xli + xldot * delt + xndt * step2, xli)
        xni = torch.where(need, xni + xndt * delt + xnddt * step2, xni)
        atime = torch.where(need, atime + delt, atime)
    xndt, xldot, xnddt = rates(xli, xni, atime)
    ft = t - atime
    nm_res = xni + xndt * ft + xnddt * ft * ft * 0.5
    xl = xli + xldot * ft + xndt * ft * ft * 0.5
    mm_res = torch.where(
        is_sync,
        xl - nodem - argpm + theta,
        xl - 2.0 * nodem + 2.0 * theta,
    )
    nm = torch.where(resonant, nm_res, p['no'])
    mm = torch.where(resonant, mm_res, mm)
    return em, inclm, argpm, nodem, mm, nm


def _dpper(p: dict, t, ep, xincp, nodep, argpp, mp):
    """
    Lunar-solar periodic perturbations (the DPPER stage) applied to the
    mean elements at ``t`` minutes past the element epoch, including the
    original's Lyddane modification for inclinations below 0.2 rad (with
    the AFSPC non-negative node normalisation, as CSPICE's evaluator
    inherits). Returns the perturbed ``(ep, xincp, nodep, argpp, mp)``.
    """
    twopi = 2.0 * math.pi
    zns = 1.19459e-5
    zes = 0.01675
    znl = 1.5835218e-4
    zel = 0.05490

    zm = p['zmos'] + zns * t
    zf = zm + 2.0 * zes * torch.sin(zm)
    sinzf = torch.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * torch.cos(zf)
    ses = p['se2'] * f2 + p['se3'] * f3
    sis = p['si2'] * f2 + p['si3'] * f3
    sls = p['sl2'] * f2 + p['sl3'] * f3 + p['sl4'] * sinzf
    sghs = p['sgh2'] * f2 + p['sgh3'] * f3 + p['sgh4'] * sinzf
    shs = p['sh2'] * f2 + p['sh3'] * f3

    zm = p['zmol'] + znl * t
    zf = zm + 2.0 * zel * torch.sin(zm)
    sinzf = torch.sin(zf)
    f2 = 0.5 * sinzf * sinzf - 0.25
    f3 = -0.5 * sinzf * torch.cos(zf)
    sel = p['ee2'] * f2 + p['e3'] * f3
    sil = p['xi2'] * f2 + p['xi3'] * f3
    sll = p['xl2'] * f2 + p['xl3'] * f3 + p['xl4'] * sinzf
    sghl = p['xgh2'] * f2 + p['xgh3'] * f3 + p['xgh4'] * sinzf
    shll = p['xh2'] * f2 + p['xh3'] * f3

    pe = ses + sel
    pinc = sis + sil
    pl = sls + sll
    pgh = sghs + sghl
    ph = shs + shll

    xincp = xincp + pinc
    ep = ep + pe
    sinip = torch.sin(xincp)
    cosip = torch.cos(xincp)

    # Non-Lyddane branch (inclination >= 0.2 rad)
    sin_safe = torch.where(torch.abs(sinip) > 1e-12, sinip, 1e-12)
    ph_a = ph / sin_safe
    pgh_a = pgh - cosip * ph_a
    argpp_a = argpp + pgh_a
    nodep_a = nodep + ph_a
    mp_a = mp + pl

    # Lyddane branch (AFSPC variant: node normalised to [0, 2pi))
    sinop = torch.sin(nodep)
    cosop = torch.cos(nodep)
    alfdp = sinip * sinop + ph * cosop + pinc * cosip * sinop
    betdp = sinip * cosop - ph * sinop + pinc * cosip * cosop
    nodep_w = torch.remainder(nodep, twopi)
    nodep_w = torch.where(nodep_w < 0.0, nodep_w + twopi, nodep_w)
    xls = (
        mp + argpp + cosip * nodep_w + pl + pgh - pinc * nodep_w * sinip
    )
    xnoh = nodep_w
    nodep_b = torch.atan2(alfdp, betdp)
    nodep_b = torch.where(nodep_b < 0.0, nodep_b + twopi, nodep_b)
    nodep_b = torch.where(
        torch.abs(xnoh - nodep_b) > math.pi,
        torch.where(nodep_b < xnoh, nodep_b + twopi, nodep_b - twopi),
        nodep_b,
    )
    mp_b = mp + pl
    argpp_b = xls - mp_b - cosip * nodep_b

    use_a = xincp >= 0.2
    argpp = torch.where(use_a, argpp_a, argpp_b)
    nodep = torch.where(use_a, nodep_a, nodep_b)
    mp = torch.where(use_a, mp_a, mp_b)
    return ep, xincp, nodep, argpp, mp


def sgp4_propagate(c: Sgp4Constants, p: dict, et):
    """
    Propagate an initialised element set to (scalar or batched) TDB time
    ``et`` [s past J2000]. ``p`` holds float64 tensors (one element set's
    values, or per-time rows as :func:`tle_state_j2000_at_index` gathers
    them; numpy arrays are converted to ``et``'s device). Returns the TEME
    state (..., 6) in km and km/s. Differentiable in ``et``.
    """
    et = _as_f64(et)
    p = {k: (torch.as_tensor(v, dtype=torch.float64, device=et.device)
             if isinstance(v, np.ndarray) else v) for k, v in p.items()}
    twopi = 2.0 * math.pi
    x2o3 = 2.0 / 3.0
    xke = c.ke
    j2 = c.j2

    t = (et - p['epoch']) / 60.0  # minutes

    xmdf = p['mo'] + p['mdot'] * t
    argpdf = p['argpo'] + p['argpdot'] * t
    nodedf = p['nodeo'] + p['nodedot'] * t
    t2 = t * t
    nodem = nodedf + p['nodecf'] * t2
    tempa = 1.0 - p['cc1'] * t
    tempe = p['bstar'] * p['cc4'] * t
    templ = p['t2cof'] * t2

    # non-simple branch corrections (disabled via isimp flag multiplication)
    use_full = 1.0 - p['isimp']
    delomg = p['omgcof'] * t
    delmtemp = 1.0 + p['eta'] * torch.cos(xmdf)
    delm = p['xmcof'] * (delmtemp**3 - p['delmo'])
    temp = (delomg + delm) * use_full
    mm = xmdf + temp
    argpm = argpdf - temp
    t3 = t2 * t
    t4 = t3 * t
    tempa = tempa - use_full * (p['d2'] * t2 + p['d3'] * t3 + p['d4'] * t4)
    tempe = tempe + use_full * p['bstar'] * p['cc5'] * (
        torch.sin(mm) - p['sinmao']
    )
    templ = templ + use_full * (
        p['t3cof'] * t3 + t4 * (p['t4cof'] + t * p['t5cof'])
    )

    no = p['no']
    has_deep = bool(p.get('_has_deep', False))
    nm0 = no
    em0 = p['ecco']
    inclm = p['inclo']
    if has_deep:
        max_steps = int(p.get('_ds_max_steps', 64))
        d_em, d_inclm, d_argpm, d_nodem, d_mm, d_nm = _dspace(
            c, p, t, xmdf, argpdf, nodem, max_steps
        )
        deep = p['deep'] > 0.5
        em0 = torch.where(deep, d_em, em0)
        inclm = torch.where(deep, d_inclm, inclm)
        argpm = torch.where(deep, d_argpm, argpm)
        nodem = torch.where(deep, d_nodem, nodem)
        mm = torch.where(deep, d_mm, mm)
        nm0 = torch.where(deep, d_nm, nm0)
    am = (xke / nm0) ** x2o3 * tempa * tempa
    nm = xke / am**1.5
    em = em0 - tempe
    em = torch.clamp(em, 1.0e-6, 0.999999)
    mm = mm + no * templ
    xlm = mm + argpm + nodem
    nodem = torch.remainder(nodem, twopi)
    argpm = torch.remainder(argpm, twopi)
    xlm = torch.remainder(xlm, twopi)
    mm = torch.remainder(xlm - argpm - nodem, twopi)

    # Lunar-solar periodics (deep-space sets only) + the long-period
    # coefficients that depend on the perturbed inclination
    ep = em
    xincp = inclm
    nodep = nodem
    argpp = argpm
    mp = mm
    aycof = p['aycof']
    xlcof = p['xlcof']
    con41 = p['con41']
    x1mth2 = p['x1mth2']
    x7thm1 = p['x7thm1']
    if has_deep:
        j3oj2 = c.j3 / c.j2
        dp_ep, dp_xincp, dp_nodep, dp_argpp, dp_mp = _dpper(
            p, t, ep, xincp, nodep, argpp, mp
        )
        neg = dp_xincp < 0.0
        dp_nodep = torch.where(neg, dp_nodep + math.pi, dp_nodep)
        dp_argpp = torch.where(neg, dp_argpp - math.pi, dp_argpp)
        dp_xincp = torch.abs(dp_xincp)
        dp_ep = torch.clamp(dp_ep, 1.0e-12, 0.999999)
        ep = torch.where(deep, dp_ep, ep)
        xincp = torch.where(deep, dp_xincp, xincp)
        nodep = torch.where(deep, dp_nodep, nodep)
        argpp = torch.where(deep, dp_argpp, argpp)
        mp = torch.where(deep, dp_mp, mp)
        sinip = torch.sin(xincp)
        cosip = torch.cos(xincp)
        denom = torch.where(
            torch.abs(cosip + 1.0) > 1.5e-12, 1.0 + cosip, 1.5e-12
        )
        aycof = torch.where(deep, -0.5 * j3oj2 * sinip, aycof)
        xlcof = torch.where(
            deep,
            -0.25 * j3oj2 * sinip * (3.0 + 5.0 * cosip) / denom,
            xlcof,
        )
        cosisq = cosip * cosip
        con41 = torch.where(deep, 3.0 * cosisq - 1.0, con41)
        x1mth2 = torch.where(deep, 1.0 - cosisq, x1mth2)
        x7thm1 = torch.where(deep, 7.0 * cosisq - 1.0, x7thm1)

    sinim = torch.sin(xincp)
    cosim = torch.cos(xincp)

    axnl = ep * torch.cos(argpp)
    temp = 1.0 / (am * (1.0 - ep * ep))
    aynl = ep * torch.sin(argpp) + temp * aycof
    xl = mp + argpp + nodep + temp * xlcof * axnl

    u = torch.remainder(xl - nodep, twopi)
    eo1 = u
    for _ in range(10):
        sineo1 = torch.sin(eo1)
        coseo1 = torch.cos(eo1)
        tem5 = 1.0 - coseo1 * axnl - sineo1 * aynl
        tem5 = (u - aynl * coseo1 + axnl * sineo1 - eo1) / tem5
        tem5 = torch.clamp(tem5, -0.95, 0.95)
        eo1 = eo1 + tem5
    sineo1 = torch.sin(eo1)
    coseo1 = torch.cos(eo1)

    ecose = axnl * coseo1 + aynl * sineo1
    esine = axnl * sineo1 - aynl * coseo1
    el2 = axnl * axnl + aynl * aynl
    pl = am * (1.0 - el2)
    rl = am * (1.0 - ecose)
    rdotl = torch.sqrt(am) * esine / rl
    rvdotl = torch.sqrt(pl) / rl
    betal = torch.sqrt(1.0 - el2)
    temp = esine / (1.0 + betal)
    sinu = am / rl * (sineo1 - aynl - axnl * temp)
    cosu = am / rl * (coseo1 - axnl + aynl * temp)
    su = torch.atan2(sinu, cosu)
    sin2u = (cosu + cosu) * sinu
    cos2u = 1.0 - 2.0 * sinu * sinu
    temp = 1.0 / pl
    temp1 = 0.5 * j2 * temp
    temp2 = temp1 * temp

    mrt = rl * (1.0 - 1.5 * temp2 * betal * con41) \
        + 0.5 * temp1 * x1mth2 * cos2u
    su = su - 0.25 * temp2 * x7thm1 * sin2u
    xnode = nodep + 1.5 * temp2 * cosim * sin2u
    xinc = xincp + 1.5 * temp2 * cosim * sinim * cos2u
    mvt = rdotl - nm * temp1 * x1mth2 * sin2u / xke
    rvdot = rvdotl + nm * temp1 * (x1mth2 * cos2u + 1.5 * con41) / xke

    sinsu = torch.sin(su)
    cossu = torch.cos(su)
    snod = torch.sin(xnode)
    cnod = torch.cos(xnode)
    sini = torch.sin(xinc)
    cosi = torch.cos(xinc)
    xmx = -snod * cosi
    xmy = cnod * cosi
    ux = xmx * sinsu + cnod * cossu
    uy = xmy * sinsu + snod * cossu
    uz = sini * sinsu
    vx = xmx * cossu - cnod * sinsu
    vy = xmy * cossu - snod * sinsu
    vz = sini * cossu

    vkmpersec = c.er * xke / 60.0
    r = torch.stack([ux, uy, uz], dim=-1) * (mrt * c.er)[..., None]
    v = (
        torch.stack([ux, uy, uz], dim=-1) * mvt[..., None]
        + torch.stack([vx, vy, vz], dim=-1) * rvdot[..., None]
    ) * vkmpersec
    return torch.cat([r, v], dim=-1)


# ---------------------------------------------------------------------------
# TEME -> J2000 rotation
# ---------------------------------------------------------------------------

def _rotmat(angle, axis: int):
    """
    SPICE-convention coordinate rotation matrix: coordinates of a fixed
    vector in a frame rotated by ``angle`` about ``axis`` (1=x, 2=y, 3=z).
    """
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


def precession_matrix_j2000_to_mod(et):
    """IAU 1976 precession: coordinates in mean-of-date from J2000."""
    T = _as_f64(et) / CENTURY
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * ARCSEC
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * ARCSEC
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * ARCSEC
    # r_MOD = R3(-z) R2(theta) R3(-zeta) r_J2000
    return _rotmat(-z, 3) @ _rotmat(theta, 2) @ _rotmat(-zeta, 3)


def mean_obliquity(et):
    """IAU 1980 mean obliquity of the ecliptic [rad]."""
    T = _as_f64(et) / CENTURY
    return (84381.448 - 46.8150 * T - 0.00059 * T**2 + 0.001813 * T**3) * ARCSEC


def teme_to_j2000_matrix(et, dpsi, deps):
    """
    Rotation matrix taking TEME coordinates to J2000 coordinates, using the
    IAU 1976 precession model, IAU 1980 mean obliquity, and the recorded
    nutation angles (dpsi = nutation in longitude, deps = nutation in
    obliquity) interpolated from the type 10 packet.
    """
    eps0 = mean_obliquity(et)
    eps = eps0 + deps
    # Nutation: r_TOD = R1(-eps) R3(-dpsi) R1(eps0) r_MOD
    nut = _rotmat(-eps, 1) @ _rotmat(-dpsi, 3) @ _rotmat(eps0, 1)
    prec = precession_matrix_j2000_to_mod(et)
    # Equation of the equinoxes: TEME differs from TOD by a z-rotation
    eqeq = dpsi * torch.cos(eps0)
    teme_to_tod = _rotmat(-eqeq, 3)
    mod_to_j2000 = torch.swapaxes(prec, -1, -2)
    tod_to_mod = torch.swapaxes(nut, -1, -2)
    return mod_to_j2000 @ tod_to_mod @ teme_to_tod


def pack_params(params: dict) -> tuple[tuple[str, ...], np.ndarray]:
    """
    Pack the per-packet parameter dict into one (n, P) matrix so per-time
    packet selection is a single row gather.
    """
    keys = tuple(sorted(params.keys()))
    matrix = np.stack([np.asarray(params[k], dtype=np.float64) for k in keys],
                      axis=1)
    return keys, matrix


def tle_state_j2000_at_index(
    constants: np.ndarray, params: dict, idx, et
):
    """
    SGP4 propagation + TEME->J2000 for the element set(s) selected by
    packet index ``idx`` (an int, or an integer tensor broadcasting with
    ``et``). ``params`` is the vectorised output of
    :func:`sgp4_init_packets` (host numpy); the rows are gathered on the
    device of ``et``.
    """
    c = Sgp4Constants(*(float(v) for v in constants[:8]))
    packed = params.get('_packed')
    if packed is None:
        packed = pack_params(
            {k: v for k, v in params.items() if not k.startswith('_')}
        )
        params['_packed'] = packed
    keys, matrix = packed
    tsec = _as_f64(et)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=tsec.device)
    rows = torch.as_tensor(matrix, device=tsec.device)[idx]  # (..., P)
    row = {k: rows[..., i] for i, k in enumerate(keys)}
    for k in ('_has_deep', '_ds_max_steps'):
        if k in params:
            row[k] = params[k]
    state_teme = sgp4_propagate(c, row, tsec)
    dpsi = row['nu_longitude'] + row['dnu_longitude'] * (tsec - row['epoch'])
    deps = row['nu_obliquity'] + row['dnu_obliquity'] * (tsec - row['epoch'])
    m = teme_to_j2000_matrix(tsec, dpsi, deps)
    pos = torch.einsum('...ij,...j->...i', m, state_teme[..., :3])
    vel = torch.einsum('...ij,...j->...i', m, state_teme[..., 3:])
    return torch.cat([pos, vel], dim=-1)
