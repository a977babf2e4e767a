"""
Native map projections (the port's copy of ``planetmapper_tpu.ops.
projections``, numpy only; the reference used pyproj/PROJ,
body_xy.py:2755-3149).

Implements the built-in projections as closed-form vectorised transforms:

- ``rectangular`` / ``manual``: identity lon/lat grids
- ``ortho``: orthographic on the oblate spheroid. The forward model is the
  exact parallel projection onto the view plane (which is algebraically
  identical to PROJ's ellipsoidal orthographic series plus a constant y
  offset), so the inverse is an exact closed-form ray-spheroid
  intersection - no iteration.
- ``aeqd``: azimuthal equidistant on the sphere of radius a (PROJ is called
  with ``+b`` removed by the reference, so the spherical forms apply).
- ``laea``: Lambert azimuthal equal-area on the sphere of radius a.

The ``+axis=wnu`` convention of positive-west bodies is reproduced: input
longitudes are interpreted in the body's planetographic convention and the
projected x axis is wested (negated) accordingly, exactly like the PROJ
pipeline the reference constructs. pyproj, where installed, serves other
PROJ strings; it is imported only when such a string is asked for.

All transforms operate on numpy arrays (host side): map grids are generated
once per projection; the per-sample reprojection runs on the device
afterwards.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np


class ProjStringError(ValueError):
    """Bad or inconsistent proj projection string (reference body_xy.py:110)."""


#: Spherical azimuthal family (shared forward/inverse structure)
_AZIMUTHAL_KINDS = frozenset({'aeqd', 'laea', 'stere', 'gnom'})
#: Spherical cylindrical / pseudocylindrical family
_CYLINDRICAL_KINDS = frozenset({'eqc', 'merc', 'mill', 'cea', 'sinu', 'moll'})


def _mollweide_theta(phi):
    """
    Solve Mollweide's auxiliary angle: 2t + sin(2t) = pi sin(phi)
    (Newton iteration; quadratic convergence from t = phi).
    """
    target = np.pi * np.sin(phi)
    theta = np.asarray(phi, dtype=float).copy()
    # Near the poles Newton stalls (F' = 2 + 2cos(2t) -> 0): start from the
    # asymptotic solution psi = (3 delta / 4)^(1/3) of
    # 2(pi/2 - psi) + sin(2(pi/2 - psi)) = pi - delta
    with np.errstate(invalid='ignore', divide='ignore'):
        near_pole = np.abs(target) > 0.9 * np.pi
        delta = np.pi - np.abs(target)
        psi = np.cbrt(0.75 * np.maximum(delta, 0.0))
        theta = np.where(
            near_pole, np.sign(phi) * (np.pi / 2.0 - psi), theta
        )
        for _ in range(10):
            f = 2.0 * theta + np.sin(2.0 * theta) - target
            df = 2.0 + 2.0 * np.cos(2.0 * theta)
            step = np.where(np.abs(df) > 1e-12, f / df, 0.0)
            theta = theta - step
    # poles: the iteration is singular exactly at phi = +-pi/2
    theta = np.where(
        np.isclose(np.abs(phi), np.pi / 2), np.sign(phi) * np.pi / 2, theta
    )
    return theta


@dataclass
class ProjectionTransformer:
    """
    pyproj.Transformer-compatible shim: ``transform(x, y)`` maps lon/lat to
    projected coordinates and ``direction='INVERSE'`` maps back.
    """

    kind: str  # 'lonlat', 'ortho', 'aeqd', 'laea'
    a: float = 1.0
    b: float = 1.0
    lon_0: float = 0.0
    lat_0: float = 0.0
    x_0: float = 0.0  # false easting [same units as a]
    y_0: float = 0.0  # false northing [same units as a]
    lat_ts: float = 0.0  # latitude of true scale (cylindrical kinds)
    to_meter: float = 1.0
    west_positive: bool = False

    def transform(self, x, y, direction: str = 'FORWARD'):
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        # accept pyproj.enums.TransformDirection too (its str() is
        # 'TransformDirection.INVERSE', so use .name when present)
        name = getattr(direction, 'name', None) or str(direction)
        if name.upper().startswith('I'):
            return self._inverse(x, y)
        return self._forward(x, y)

    # -- basis helpers -----------------------------------------------------
    def _view_basis(self):
        """East/North/Up unit vectors at the projection centre (a-units)."""
        lam0 = math.radians(self.lon_0)
        phi0 = math.radians(self.lat_0)
        sl, cl = math.sin(lam0), math.cos(lam0)
        sp, cp = math.sin(phi0), math.cos(phi0)
        east = np.array([-sl, cl, 0.0])
        north = np.array([-sp * cl, -sp * sl, cp])
        up = np.array([cp * cl, cp * sl, sp])  # geodetic normal
        return east, north, up

    def _e2(self):
        return 1.0 - (self.b / self.a) ** 2

    def _y_offset_total(self):
        """
        Constant northing offset between the exact parallel projection and
        the output coordinates: PROJ's series offset plus the false
        northing the reference supplies (body_xy.py:2937).
        """
        phi0 = math.radians(self.lat_0)
        e2 = self._e2()
        nu0 = 1.0 / math.sqrt(1.0 - e2 * math.sin(phi0) ** 2)
        return (
            e2 * nu0 * math.sin(phi0) * math.cos(phi0)
            + self.y_0 / self.a
        )

    # -- forward -----------------------------------------------------------
    def _forward(self, lon, lat):
        if self.kind in ('lonlat', 'rectangular', 'manual'):
            if self.west_positive:
                # PROJ's +axis=wnu axisswap negates the first axis even
                # for the identity longlat "projection"
                return -np.asarray(lon, dtype=float), lat
            return lon, lat

        lam = np.radians(lon - self.lon_0)
        # PROJ wraps input longitudes into lon_0 +/- 180 (adjlon) before
        # projecting; without this, cylindrical forwards put lon 270 at
        # x ~ 3/2 pi a instead of -pi/2 a and round trips fail
        lam = lam - 2.0 * np.pi * np.round(lam / (2.0 * np.pi))
        phi = np.radians(lat)

        if self.kind == 'ortho':
            e2 = self._e2()
            sp = np.sin(phi)
            cp = np.cos(phi)
            nu = 1.0 / np.sqrt(1.0 - e2 * sp * sp)
            phi0 = math.radians(self.lat_0)
            sp0, cp0 = math.sin(phi0), math.cos(phi0)
            nu0 = 1.0 / math.sqrt(1.0 - e2 * sp0 * sp0)
            x = nu * cp * np.sin(lam)
            yy = nu * (sp * cp0 - cp * sp0 * np.cos(lam)) + e2 * (
                nu0 * sp0 - nu * sp
            ) * cp0
            # PROJ refuses the far hemisphere (the parallel projection
            # would fold it onto the visible disc)
            far = sp0 * sp + cp0 * cp * np.cos(lam) < -1e-12
            x = np.where(far, np.nan, x)
            yy = np.where(far, np.nan, yy)
            out_x = (x * self.a + self.x_0) / self.to_meter
            out_y = (yy * self.a + self.y_0) / self.to_meter
        elif self.kind in _AZIMUTHAL_KINDS:
            out_x, out_y = self._forward_azimuthal(lam, phi)
            out_x = out_x + self.x_0 / self.to_meter
            out_y = out_y + self.y_0 / self.to_meter
        elif self.kind in _CYLINDRICAL_KINDS:
            out_x, out_y = self._forward_cylindrical(lam, phi)
            out_x = out_x + self.x_0 / self.to_meter
            out_y = out_y + self.y_0 / self.to_meter
        else:
            raise ProjStringError(f'Unknown projection kind {self.kind!r}')

        if self.west_positive:
            out_x = -out_x
        return out_x, out_y

    def _forward_azimuthal(self, lam, phi):
        """
        Shared spherical azimuthal forward: the projections differ only in
        the radial scale factor k(c) of the angular distance c from the
        projection centre (Snyder 1987, ch. 20-25).
        """
        phi0 = math.radians(self.lat_0)
        sp0, cp0 = math.sin(phi0), math.cos(phi0)
        cosc = sp0 * np.sin(phi) + cp0 * np.cos(phi) * np.cos(lam)
        c = np.arccos(np.clip(cosc, -1.0, 1.0))
        with np.errstate(invalid='ignore', divide='ignore'):
            if self.kind == 'aeqd':
                # The antipode (c = pi) is direction-degenerate: PROJ
                # raises a tolerance-condition error there (non-finite
                # through pyproj), so callers - e.g. the map wireframe's
                # pole labels - must see NaN, not the float-rounding
                # garbage of c/sin(c) at sin(c) ~ 1e-16
                k = np.where(c != 0.0, c / np.sin(c), 1.0)
                k = np.where(cosc <= -1.0 + 1e-12, np.nan, k)
            elif self.kind == 'laea':
                k = np.sqrt(
                    np.where(cosc > -1.0, 2.0 / (1.0 + cosc), np.nan)
                )
            elif self.kind == 'stere':
                k = np.where(cosc > -1.0, 2.0 / (1.0 + cosc), np.nan)
            else:  # gnom: only the near hemisphere projects
                k = np.where(cosc > 0.0, 1.0 / cosc, np.nan)
        x = k * np.cos(phi) * np.sin(lam)
        yy = k * (cp0 * np.sin(phi) - sp0 * np.cos(phi) * np.cos(lam))
        return x * self.a / self.to_meter, yy * self.a / self.to_meter

    def _forward_cylindrical(self, lam, phi):
        """Spherical cylindrical / pseudocylindrical forwards (Snyder)."""
        a = self.a / self.to_meter
        cos_ts = math.cos(math.radians(self.lat_ts))
        with np.errstate(invalid='ignore', divide='ignore'):
            if self.kind == 'eqc':
                return a * lam * cos_ts, a * (
                    phi - math.radians(self.lat_0)
                )
            if self.kind == 'merc':
                y = np.where(
                    np.abs(phi) < np.pi / 2,
                    np.log(np.tan(np.pi / 4 + phi / 2.0)),
                    np.nan,
                )
                return a * lam * cos_ts, a * y * cos_ts
            if self.kind == 'mill':
                y = 1.25 * np.log(np.tan(np.pi / 4 + 0.4 * phi))
                return a * lam, a * y
            if self.kind == 'cea':
                return a * lam * cos_ts, a * np.sin(phi) / cos_ts
            if self.kind == 'sinu':
                return a * lam * np.cos(phi), a * phi
            if self.kind == 'moll':
                theta = _mollweide_theta(phi)
                x = (2.0 * math.sqrt(2.0) / np.pi) * a * lam * np.cos(theta)
                return x, a * math.sqrt(2.0) * np.sin(theta)
        raise ProjStringError(f'Unknown projection kind {self.kind!r}')

    # -- inverse -----------------------------------------------------------
    def _inverse(self, x, y):
        if self.kind in ('lonlat', 'rectangular', 'manual'):
            if self.west_positive:
                return -np.asarray(x, dtype=float), y
            return x, y

        if self.west_positive:
            x = -x

        if self.kind == 'ortho':
            return self._inverse_ortho(x - self.x_0 / self.to_meter, y)
        if self.kind in _CYLINDRICAL_KINDS:
            return self._inverse_cylindrical(
                x - self.x_0 / self.to_meter, y - self.y_0 / self.to_meter
            )

        rho_x = (x - self.x_0 / self.to_meter) * self.to_meter / self.a
        rho_y = (y - self.y_0 / self.to_meter) * self.to_meter / self.a
        rho = np.hypot(rho_x, rho_y)
        phi0 = math.radians(self.lat_0)

        with np.errstate(invalid='ignore'):
            if self.kind == 'aeqd':
                c = rho
                invalid = c > np.pi
            elif self.kind == 'laea':
                c = 2.0 * np.arcsin(np.clip(rho / 2.0, -1.0, 1.0))
                invalid = rho > 2.0
            elif self.kind == 'stere':
                c = 2.0 * np.arctan(rho / 2.0)
                invalid = np.zeros(np.shape(rho), dtype=bool)
            elif self.kind == 'gnom':
                c = np.arctan(rho)
                invalid = np.zeros(np.shape(rho), dtype=bool)
            else:
                raise ProjStringError(
                    f'Unknown projection kind {self.kind!r}'
                )

        with np.errstate(invalid='ignore', divide='ignore'):
            sinc = np.sin(c)
            cosc = np.cos(c)
            phi = np.arcsin(
                np.clip(
                    cosc * math.sin(phi0)
                    + np.where(rho != 0, rho_y * sinc * math.cos(phi0) / rho, 0.0),
                    -1.0,
                    1.0,
                )
            )
            lam = np.arctan2(
                rho_x * sinc,
                rho * cosc * math.cos(phi0) - rho_y * math.sin(phi0) * sinc,
            )
        lon = self.lon_0 + np.degrees(np.where(rho != 0, lam, 0.0))
        lat = np.degrees(np.where(rho != 0, phi, phi0))
        lon = np.where(invalid, np.nan, lon)
        lat = np.where(invalid, np.nan, lat)
        return lon, lat

    def _inverse_cylindrical(self, x, y):
        a = self.a / self.to_meter
        xn = np.asarray(x, dtype=float) / a
        yn = np.asarray(y, dtype=float) / a
        cos_ts = math.cos(math.radians(self.lat_ts))
        with np.errstate(invalid='ignore', divide='ignore'):
            if self.kind == 'eqc':
                lam = xn / cos_ts
                phi = yn + math.radians(self.lat_0)
                lam = np.where(np.abs(phi) > np.pi / 2 + 1e-9, np.nan, lam)
                phi = np.where(np.isnan(lam), np.nan, phi)
            elif self.kind == 'merc':
                lam = xn / cos_ts
                phi = 2.0 * np.arctan(np.exp(yn / cos_ts)) - np.pi / 2.0
            elif self.kind == 'mill':
                lam = xn
                phi = 2.5 * np.arctan(np.exp(0.8 * yn)) - 0.625 * np.pi
            elif self.kind == 'cea':
                lam = xn / cos_ts
                phi = np.arcsin(np.clip(yn * cos_ts, -1.0, 1.0))
                phi = np.where(np.abs(yn * cos_ts) > 1.0, np.nan, phi)
            elif self.kind == 'sinu':
                phi = yn
                lam = np.where(
                    np.abs(phi) <= np.pi / 2, xn / np.cos(phi), np.nan
                )
                # both coordinates go invalid together (a half-NaN pair
                # would feed a finite out-of-range latitude downstream)
                phi = np.where(np.isnan(lam), np.nan, phi)
            elif self.kind == 'moll':
                sq2 = math.sqrt(2.0)
                theta = np.arcsin(np.clip(yn / sq2, -1.0, 1.0))
                phi = np.arcsin(
                    np.clip(
                        (2.0 * theta + np.sin(2.0 * theta)) / np.pi,
                        -1.0, 1.0,
                    )
                )
                lam = np.pi * xn / (2.0 * sq2 * np.cos(theta))
                bad = (np.abs(yn) > sq2) | (np.abs(lam) > np.pi)
                lam = np.where(bad, np.nan, lam)
                phi = np.where(bad, np.nan, phi)
            else:
                raise ProjStringError(
                    f'Unknown projection kind {self.kind!r}'
                )
            invalid = np.abs(lam) > np.pi * (1.0 + 1e-9)
        lon = self.lon_0 + np.degrees(np.where(invalid, np.nan, lam))
        lat = np.degrees(np.where(invalid, np.nan, phi))
        return lon, lat

    def _inverse_ortho(self, x, y):
        """
        Exact inverse of the (parallel-projection) ellipsoidal orthographic
        forward: intersect the view ray with the spheroid and convert the
        near-side intersection to geodetic coordinates.
        """
        east, north, up = self._view_basis()
        xp = x * self.to_meter / self.a
        yp = y * self.to_meter / self.a - self._y_offset_total()

        # Ray: p(t) = xp*east + yp*north + t*up  (a-units); spheroid
        # x^2 + y^2 + (z/(b/a))^2 = 1
        scale = np.array([1.0, 1.0, self.a / self.b])
        origin = (
            xp[..., None] * east + yp[..., None] * north
        ) * scale
        d = up * scale
        aa = np.sum(d * d)
        bb = np.sum(origin * d, axis=-1)
        cc = np.sum(origin * origin, axis=-1) - 1.0
        disc = bb * bb - aa * cc
        ok = disc >= 0.0
        with np.errstate(invalid='ignore'):
            t = (-bb + np.sqrt(np.where(ok, disc, np.nan))) / aa  # near side
        p = (
            xp[..., None] * east
            + yp[..., None] * north
            + t[..., None] * up
        )  # a-units, unscaled frame

        # Geodetic conversion (e2 small enough for fixed-point iteration,
        # and the result is exact for surface points)
        e2 = self._e2()
        lon = np.degrees(np.arctan2(p[..., 1], p[..., 0]))
        rho = np.hypot(p[..., 0], p[..., 1])
        z = p[..., 2]
        with np.errstate(invalid='ignore', divide='ignore'):
            lat = np.arctan2(z, rho * (1.0 - e2))
            for _ in range(8):
                sp = np.sin(lat)
                nu = 1.0 / np.sqrt(1.0 - e2 * sp * sp)
                lat = np.arctan2(z + e2 * nu * sp, rho)
        lat = np.degrees(lat)
        lon = np.where(ok, lon, np.nan)
        lat = np.where(ok, lat, np.nan)
        return lon, lat


_PROJ_RE = re.compile(r'\+proj=(\w+)')
_PARAM_RE = re.compile(r'\+(\w+)=([^\s]+)')

_SUPPORTED_PROJ_NAMES = {
    'ortho': 'ortho',
    'aeqd': 'aeqd',
    'laea': 'laea',
    'stere': 'stere',
    'gnom': 'gnom',
    'eqc': 'eqc',
    'merc': 'merc',
    'mill': 'mill',
    'cea': 'cea',
    'sinu': 'sinu',
    'moll': 'moll',
    'lonlat': 'lonlat',
    'longlat': 'lonlat',
    'latlon': 'lonlat',
}


def transformer_from_proj_string(projection: str) -> ProjectionTransformer:
    """
    Build a :class:`ProjectionTransformer` from a proj-style string
    (supported: the projections the framework implements natively).
    """
    m = _PROJ_RE.search(projection)
    if not m:
        raise ProjStringError(f'No +proj= in projection string {projection!r}')
    name = m.group(1)
    kind = _SUPPORTED_PROJ_NAMES.get(name)
    if kind is None:
        transformer = _maybe_pyproj_transformer(projection)
        if transformer is not None:
            return transformer
        raise NotImplementedError(
            f'Projection {name!r} is not supported natively (supported: '
            f'{sorted(set(_SUPPORTED_PROJ_NAMES))}). Install pyproj for '
            'arbitrary PROJ projections.'
        )
    params = dict(_PARAM_RE.findall(projection))

    def fget(key, default):
        try:
            raw = params[key]
        except KeyError:
            return default
        try:
            return float(raw)
        except ValueError as exc:
            raise ProjStringError(
                f'Cannot parse +{key}={raw!r} in projection string '
                f'{projection!r}'
            ) from exc

    a = fget('a', 1.0)
    b = fget('b', a)
    # The native implementations are the SPHERICAL PROJ forms (plus the
    # exact ellipsoidal orthographic). PROJ computes genuinely
    # ellipsoidal formulas for these kinds when b != a (or a scale
    # factor is given), so silently using the sphere would diverge from
    # the reference by degree-scale latitudes - refuse and point at the
    # pyproj fallback instead. (moll/mill/eqc/gnom are spherical-only in
    # PROJ itself, so b is legitimately ignored for them.)
    k0 = fget('k_0', fget('k', 1.0))
    if (
        (kind in ('merc', 'cea', 'stere', 'laea', 'aeqd', 'sinu')
         and not math.isclose(b, a))
        or not math.isclose(k0, 1.0)
    ):
        transformer = _maybe_pyproj_transformer(projection)
        if transformer is not None:
            return transformer
        raise NotImplementedError(
            f'Projection string {projection!r} requests ellipsoidal/'
            f'scaled {name!r}, which the native (spherical) '
            'implementation does not support. Install pyproj, or drop '
            'the +b/+k parameters (e.g. create_proj_string(..., b=None) '
            'for the spherical form).'
        )
    return ProjectionTransformer(
        kind=kind,
        a=a,
        b=b,
        lon_0=fget('lon_0', 0.0),
        lat_0=fget('lat_0', 0.0),
        x_0=fget('x_0', 0.0),
        y_0=fget('y_0', 0.0),
        lat_ts=fget('lat_ts', 0.0),
        to_meter=fget('to_meter', 1.0),
        west_positive=params.get('axis', 'enu').startswith('w'),
    )


def _maybe_pyproj_transformer(projection: str):
    """
    Optional pyproj fallback for projections without a native
    implementation: when pyproj is installed, any PROJ string the
    reference accepts works here too (reference body_xy.py:3140-3149).
    """
    try:
        import pyproj
    except ImportError:
        return None

    crs = pyproj.CRS(projection)
    lonlat = crs.geodetic_crs if crs.geodetic_crs is not None else crs
    return pyproj.Transformer.from_crs(lonlat, crs, always_xy=True)
