"""
Minimal celestial WCS (FITS World Coordinate System) implementation.

Replaces the ``astropy.wcs`` subset used by the observation layer
(reference observation.py:427-500): parsing CRPIX/CRVAL/CDELT/PC/CD/CROTA2
keywords, forward and inverse projection for the zenithal family --
gnomonic ``TAN``, orthographic ``SIN`` (radio interferometry), zenithal
equidistant ``ARC``, stereographic ``STG``, zenithal equal-area ``ZEA`` --
and plain linear axes, per the FITS WCS papers (Greisen & Calabretta
2002), plus full SIP distortion handling: forward A/B polynomials in
``pix2foc`` and the AP/BP inverse (or Newton-free fixed-point inversion
of A/B when AP/BP are absent) in ``foc2pix`` / ``world_to_pixel_values``.

Pixel conventions follow astropy's ``*_values`` APIs: 0-based pixel
coordinates (the FITS-standard 1-based CRPIX is converted internally).

This is the port's own copy of ``planetmapper_tpu/io/wcs.py`` (numpy
only).
"""

from __future__ import annotations

import math
import re

import numpy as np


class WCS:
    """Celestial WCS built from a FITS header (zenithal projections)."""

    def __init__(self, header=None, naxis=None) -> None:
        self.naxis = 0
        self.wcs_valid = False
        self.ctype = ('', '')
        self.cunit = ('deg', 'deg')
        self.lonpole = None
        self._axes_swapped = False
        self.crpix = np.array([1.0, 1.0])
        self.crval = np.array([0.0, 0.0])
        self.matrix = np.eye(2)  # CD matrix: intermediate = CD @ (p - crpix)
        self._sip_a: dict[tuple[int, int], float] = {}
        self._sip_b: dict[tuple[int, int], float] = {}
        self._sip_ap: dict[tuple[int, int], float] = {}
        self._sip_bp: dict[tuple[int, int], float] = {}
        del naxis
        if header is not None:
            self._parse(header)

    # ------------------------------------------------------------------
    def _parse(self, header) -> None:
        def get(key, default=None):
            try:
                return header[key]
            except KeyError:
                return default

        ctype1 = str(get('CTYPE1', '') or '')
        ctype2 = str(get('CTYPE2', '') or '')
        if not (ctype1 and ctype2):
            return
        self.ctype = (ctype1, ctype2)
        self.cunit = (
            str(get('CUNIT1', 'deg') or 'deg').strip(),
            str(get('CUNIT2', 'deg') or 'deg').strip(),
        )
        # axis order: a legal header may carry DEC on axis 1 and RA on
        # axis 2; the projection math below works on (ra-like, dec-like)
        # intermediate coordinates, so record the swap
        self._axes_swapped = ctype1.upper().startswith(
            'DEC'
        ) and ctype2.upper().startswith('RA')
        self.crpix = np.array(
            [float(get('CRPIX1', 1.0)), float(get('CRPIX2', 1.0))]
        )
        self.crval = np.array(
            [float(get('CRVAL1', 0.0)), float(get('CRVAL2', 0.0))]
        )
        self.lonpole = get('LONPOLE')
        if self.lonpole is not None:
            self.lonpole = float(self.lonpole)

        cd = np.array(
            [
                [get('CD1_1'), get('CD1_2')],
                [get('CD2_1'), get('CD2_2')],
            ]
        )
        if any(v is not None for v in cd.reshape(-1)):
            self.matrix = np.array(
                [[float(v) if v is not None else 0.0 for v in row]
                 for row in cd]
            )
        else:
            cdelt = np.array(
                [float(get('CDELT1', 1.0)), float(get('CDELT2', 1.0))]
            )
            pc = np.array(
                [
                    [get('PC1_1'), get('PC1_2')],
                    [get('PC2_1'), get('PC2_2')],
                ]
            )
            if any(v is not None for v in pc.reshape(-1)):
                pc_m = np.array(
                    [
                        [
                            float(v) if v is not None else (1.0 if i == j else 0.0)
                            for j, v in enumerate(row)
                        ]
                        for i, row in enumerate(pc)
                    ]
                )
            else:
                crota2 = float(get('CROTA2', 0.0))
                c, s = math.cos(math.radians(crota2)), math.sin(
                    math.radians(crota2)
                )
                pc_m = np.array([[c, -s], [s, c]])
            self.matrix = np.diag(cdelt) @ pc_m

        # SIP distortion coefficients
        a_order = get('A_ORDER')
        b_order = get('B_ORDER')
        if a_order is not None or b_order is not None:
            sip_re = re.compile(r'^(AP|BP|A|B)_(\d+)_(\d+)$')
            tables = {
                'A': self._sip_a, 'B': self._sip_b,
                'AP': self._sip_ap, 'BP': self._sip_bp,
            }
            for key in header.keys():
                m = sip_re.match(str(key))
                if m:
                    p, q = int(m.group(2)), int(m.group(3))
                    tables[m.group(1)][(p, q)] = float(header[key])

        self.naxis = 2
        self.wcs_valid = True

    # ------------------------------------------------------------------
    @property
    def celestial(self) -> 'WCS':
        return self

    @property
    def has_distortion(self) -> bool:
        return bool(self._sip_a or self._sip_b)

    @property
    def world_axis_units(self):
        # real header units: observation.disc_from_wcs guards on these
        # being degrees, so hardcoding 'deg' would defeat the check and
        # navigate with silently mis-scaled coordinates
        return list(self.cunit) if self.wcs_valid else []

    @property
    def world_axis_physical_types(self):
        if not self.wcs_valid:
            return []
        types = []
        for ctype in self.ctype:
            if ctype.startswith('RA'):
                types.append('pos.eq.ra')
            elif ctype.startswith('DEC'):
                types.append('pos.eq.dec')
            else:
                types.append(ctype)
        return types

    # ------------------------------------------------------------------
    def _projection_code(self) -> str:
        if not self.wcs_valid:
            raise ValueError('No WCS information available')
        ctype = self.ctype[0].upper()
        # the SIP convention appends '-SIP' to the projection code
        # (CTYPE1 = 'RA---TAN-SIP'); the distortion itself is applied
        # via the A_*/B_* polynomials in pix2foc
        if ctype.endswith('-SIP'):
            ctype = ctype[:-4]
        proj = ctype[-3:]
        if proj in ('LIN', '   ') or ctype.strip() in ('X', 'Y', ''):
            return 'LIN'
        if proj not in _ZENITHAL_FROM_R:
            raise NotImplementedError(
                f'WCS projection {self.ctype[0]!r} is not supported '
                f'(supported: {", ".join(sorted(_ZENITHAL_FROM_R))}, '
                'and linear)'
            )
        return proj

    def pixel_to_world_values(self, x, y):
        """0-based pixel coordinates to world values in degrees, in AXIS
        order (``(ra, dec)`` for the usual RA-first headers)."""
        proj = self._projection_code()
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        if self.has_distortion:
            x, y = self.pix2foc(x, y, 0)
        # FITS pixels are 1-based
        dp = np.stack(
            np.broadcast_arrays(x + 1 - self.crpix[0], y + 1 - self.crpix[1]),
            axis=-1,
        )
        inter = dp @ self.matrix.T  # intermediate world coords [deg]
        lon_ax = 1 if self._axes_swapped else 0
        if proj == 'LIN':
            ra = self.crval[lon_ax] + inter[..., lon_ax]
            dec = self.crval[1 - lon_ax] + inter[..., 1 - lon_ax]
        else:
            ra, dec = self._plane_to_world(
                inter[..., lon_ax], inter[..., 1 - lon_ax], proj
            )
        if self._axes_swapped:
            ra, dec = dec, ra
        if np.ndim(ra) == 0:
            return float(ra), float(dec)
        return ra, dec

    def world_to_pixel_values(self, w1, w2):
        """World values in AXIS order (``(ra, dec)`` for RA-first
        headers) to 0-based pixel coordinates."""
        proj = self._projection_code()
        ra, dec = (w2, w1) if self._axes_swapped else (w1, w2)
        lon_ax = 1 if self._axes_swapped else 0
        if proj == 'LIN':
            xi = np.asarray(ra, dtype=float) - self.crval[lon_ax]
            eta = np.asarray(dec, dtype=float) - self.crval[1 - lon_ax]
        else:
            xi, eta = self._world_to_plane(
                np.asarray(ra, dtype=float), np.asarray(dec, dtype=float),
                proj,
            )
        if self._axes_swapped:
            xi, eta = eta, xi
        inter = np.stack(np.broadcast_arrays(xi, eta), axis=-1)
        dp = inter @ np.linalg.inv(self.matrix).T
        x = dp[..., 0] + self.crpix[0] - 1
        y = dp[..., 1] + self.crpix[1] - 1
        if self.has_distortion:
            x, y = self.foc2pix(x, y, 0)
        if np.ndim(x) == 0:
            return float(x), float(y)
        return x, y

    def pix2foc(self, x, y, origin: int = 0):
        """Apply SIP distortion polynomials (pixel -> focal plane)."""
        x = np.asarray(x, dtype=float) - origin
        y = np.asarray(y, dtype=float) - origin
        u = x + 1 - self.crpix[0]
        v = y + 1 - self.crpix[1]
        dx = np.zeros_like(u)
        dy = np.zeros_like(v)
        for (p, q), coeff in self._sip_a.items():
            dx = dx + coeff * u**p * v**q
        for (p, q), coeff in self._sip_b.items():
            dy = dy + coeff * u**p * v**q
        return x + dx + origin, y + dy + origin

    def foc2pix(self, x, y, origin: int = 0):
        """Invert the SIP distortion (focal plane -> pixel).

        Uses the header's AP/BP inverse polynomials when present (the SIP
        convention's precomputed inverse, evaluated on focal-plane offsets
        U, V relative to CRPIX); otherwise inverts the forward A/B
        polynomials by fixed-point iteration (the distortion is a small
        perturbation of the identity, so ``p_{k+1} = f - d(p_k)``
        contracts; astropy's ``all_world2pix`` solves the same problem
        iteratively). Matches the reference's astropy-grade
        ``world_to_pixel`` handling (reference observation.py:427-500).
        """
        x = np.asarray(x, dtype=float) - origin
        y = np.asarray(y, dtype=float) - origin
        if self._sip_ap or self._sip_bp:
            u = x + 1 - self.crpix[0]
            v = y + 1 - self.crpix[1]
            dx = np.zeros_like(u)
            dy = np.zeros_like(v)
            for (p, q), coeff in self._sip_ap.items():
                dx = dx + coeff * u**p * v**q
            for (p, q), coeff in self._sip_bp.items():
                dy = dy + coeff * u**p * v**q
            return x + dx + origin, y + dy + origin
        # Newton-free fixed point on the pixel offsets: d(.) is the
        # forward SIP perturbation, |d'| << 1 over the chip for any
        # physical imager, giving linear convergence to float rounding
        # in a handful of sweeps.
        px, py = x, y
        for _ in range(30):
            fx, fy = self.pix2foc(px, py, 0)
            ex = fx - x
            ey = fy - y
            px = px - ex
            py = py - ey
            if max(np.max(np.abs(ex)), np.max(np.abs(ey))) < 1e-12:
                break
        return px + origin, py + origin

    # ------------------------------------------------------------------
    # Zenithal (azimuthal) projections, FITS convention (Calabretta &
    # Greisen 2002): intermediate world coordinates (xi, eta) in degrees;
    # reference point at the native pole (phi0, theta0) = (0, 90deg) and
    # native longitude of the celestial pole LONPOLE = 180 deg for
    # |crval_dec| != 90. All members share the native->celestial rotation
    # and differ only in the radius law R(theta); radii here are in
    # radian units (the degree<->radian scaling of the FITS papers is
    # absorbed when converting xi/eta).
    # ------------------------------------------------------------------
    def _ra0_dec0_phip(self):
        """Reference point and native longitude of the celestial pole
        (LONPOLE) in radians. The FITS default LONPOLE is 180 deg for
        zenithal projections except when the reference point IS the pole
        (CRVAL dec = +90: default 0; dec = -90: default 180 holds)."""
        lon_ax = 1 if self._axes_swapped else 0
        ra0 = math.radians(self.crval[lon_ax])
        dec0 = math.radians(self.crval[1 - lon_ax])
        if self.lonpole is not None:
            phi_p = math.radians(self.lonpole)
        elif self.crval[1 - lon_ax] >= 90.0:
            phi_p = 0.0
        else:
            phi_p = math.pi
        return ra0, dec0, phi_p

    def _plane_to_world(self, xi, eta, proj: str):
        xi = np.radians(xi)
        eta = np.radians(eta)
        ra0, dec0, phi_p = self._ra0_dec0_phip()
        r = np.hypot(xi, eta)
        with np.errstate(invalid='ignore', divide='ignore'):
            theta = _ZENITHAL_FROM_R[proj](r)
        phi = np.arctan2(xi, -eta)  # native longitude
        dphi = phi - phi_p
        sin_t, cos_t = np.sin(theta), np.cos(theta)
        sin_d0, cos_d0 = math.sin(dec0), math.cos(dec0)
        # native -> celestial rotation about the pole at (ra0, dec0)
        # (Calabretta & Greisen 2002 eq 2, with general LONPOLE).
        # dec via arctan2 rather than arcsin: the magnitude of the ra
        # numerator/denominator pair IS cos(dec), and arcsin is
        # ill-conditioned where |dec| -> 90 deg (loses ~7 digits of the
        # offset for pixels near the pole)
        ra_num = -cos_t * np.sin(dphi)
        ra_den = sin_t * cos_d0 - cos_t * np.cos(dphi) * sin_d0
        dec = np.arctan2(
            sin_t * sin_d0 + cos_t * np.cos(dphi) * cos_d0,
            np.hypot(ra_num, ra_den),
        )
        ra = ra0 + np.arctan2(ra_num, ra_den)
        dec = np.where(np.isnan(theta), np.nan, dec)
        ra = np.where(np.isnan(theta), np.nan, ra)
        return np.degrees(ra) % 360.0, np.degrees(dec)

    def _world_to_plane(self, ra, dec, proj: str):
        ra = np.radians(ra)
        dec = np.radians(dec)
        ra0, dec0, phi_p = self._ra0_dec0_phip()
        sin_d, cos_d = np.sin(dec), np.cos(dec)
        sin_d0, cos_d0 = math.sin(dec0), math.cos(dec0)
        cos_dra = np.cos(ra - ra0)
        # native coordinates (inverse rotation, eq 5). theta via arctan2:
        # the phi numerator/denominator magnitude IS cos(theta), and
        # arcsin is ill-conditioned at theta -> 90 deg - exactly the
        # well-navigated case of world points near the reference point,
        # where it would round-trip world_to_pixel with ~3e-4 px error
        phi_num = -cos_d * np.sin(ra - ra0)
        phi_den = sin_d * cos_d0 - cos_d * sin_d0 * cos_dra
        theta = np.arctan2(
            sin_d * sin_d0 + cos_d * cos_d0 * cos_dra,
            np.hypot(phi_num, phi_den),
        )
        phi = phi_p + np.arctan2(phi_num, phi_den)
        with np.errstate(divide='ignore', invalid='ignore'):
            r = _ZENITHAL_TO_R[proj](theta)
        xi = r * np.sin(phi)
        eta = -r * np.cos(phi)
        return np.degrees(xi), np.degrees(eta)


def _sin_from_r(r):
    # orthographic: R = cos(theta); undefined beyond the unit circle
    return np.arccos(np.where(r > 1.0, np.nan, r))


#: radius-law inverses theta(R) for the supported zenithal projections
#: (R in radian units)
_ZENITHAL_FROM_R = {
    'TAN': lambda r: np.arctan2(1.0, r),
    'SIN': _sin_from_r,
    'ARC': lambda r: np.where(
        r > math.pi, np.nan, math.pi / 2.0 - r
    ),
    'STG': lambda r: math.pi / 2.0 - 2.0 * np.arctan(r / 2.0),
    'ZEA': lambda r: math.pi / 2.0 - 2.0 * np.arcsin(
        np.where(r > 2.0, np.nan, r / 2.0)
    ),
}

#: radius laws R(theta)
_ZENITHAL_TO_R = {
    'TAN': lambda theta: 1.0 / np.tan(theta),
    'SIN': lambda theta: np.cos(theta),
    'ARC': lambda theta: math.pi / 2.0 - theta,
    'STG': lambda theta: 2.0 * np.tan((math.pi / 2.0 - theta) / 2.0),
    'ZEA': lambda theta: 2.0 * np.sin((math.pi / 2.0 - theta) / 2.0),
}
