"""
Closed-form ellipsoid geometry in float64 PyTorch.

Port of ``planetmapper_tpu.core.geometry``: the replacements for the
scalar CSPICE geometry routines the reference calls once per pixel or per
point:

- ``pgrrec``/``recpgr`` (body.py:903, 1030): geodetic (planetographic)
  coordinate conversions
- ``reclat``/``latrec`` (body.py:2912): planetocentric conversions
- ``sincpt`` (body.py:1010): ray-ellipsoid intercept as a quadratic root
- ``surfpt``/``nplnpt``/``npedln``-style helpers (body.py:2093-2107)
- ``nvp2pl``/``inrypl`` (body.py:585, 2586): plane construction/intersection
- ``edlimb`` equivalents: the limb of an ellipsoid as an exact ellipse

All functions are elementwise over arbitrary batch shapes and run on
whatever device their tensor inputs live on. Angles are radians,
longitudes are *east-positive* internally (the planetographic W/E sign
convention is applied by the API layer).
"""

from __future__ import annotations

import math

import torch


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor with ``ref``'s dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


# ---------------------------------------------------------------------------
# Geodetic (planetographic) <-> rectangular
# ---------------------------------------------------------------------------

def geodetic_to_rect(lon_e, lat, alt, re, f):
    """
    ``pgrrec`` equivalent (east-positive longitude): geodetic coordinates on
    a spheroid with equatorial radius ``re`` and flattening ``f`` to
    body-fixed rectangular coordinates.
    """
    device = next((a.device for a in (lon_e, lat, alt)
                   if isinstance(a, torch.Tensor)), None)
    lon_e, lat, alt = torch.broadcast_tensors(*(
        torch.as_tensor(a, dtype=torch.float64, device=device)
        for a in (lon_e, lat, alt)
    ))
    e2 = f * (2.0 - f)
    sin_lat = torch.sin(lat)
    cos_lat = torch.cos(lat)
    n = re / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    x = (n + alt) * cos_lat * torch.cos(lon_e)
    y = (n + alt) * cos_lat * torch.sin(lon_e)
    z = (n * (1.0 - e2) + alt) * sin_lat
    return torch.stack([x, y, z], dim=-1)


def rect_to_geodetic(v, re, f):
    """
    ``recpgr``/``recgeo`` equivalent (east-positive longitude): body-fixed
    rectangular coordinates to geodetic ``(lon_e, lat, alt)``.

    Uses the exact nearest-point-on-spheroid construction (like CSPICE
    ``recgeo``): the geodetic latitude is defined by the surface normal at
    the closest point on the spheroid, which remains well-defined for
    points deep inside the body. Solved by vectorised bisection + Newton
    polish on the nearest-point parameter equation
    (a rho/(t+a^2))^2 + (b z/(t+b^2))^2 = 1.
    """
    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    a = _like(re, v)
    b = a * (1.0 - _like(f, v))

    lon = torch.atan2(y, x)
    rho = torch.hypot(x, y)
    az = torch.abs(z)

    a2 = a * a
    b2 = b * b

    def f_of_t(t):
        return (
            (a * rho / (t + a2)) ** 2 + (b * az / (t + b2)) ** 2 - 1.0
        )

    # Root bracket: F is monotonically decreasing for t > -b^2.
    r = torch.sqrt(rho * rho + az * az)
    t_lo = -b2 + 1e-12 * b2 + torch.zeros_like(rho)
    t_hi = torch.maximum(r, a) * a + a2  # F(t_hi) < 0 always
    for _ in range(52):
        t_mid = 0.5 * (t_lo + t_hi)
        pos = f_of_t(t_mid) > 0.0
        t_lo = torch.where(pos, t_mid, t_lo)
        t_hi = torch.where(pos, t_hi, t_mid)
    t = 0.5 * (t_lo + t_hi)
    for _ in range(3):  # Newton polish to machine precision
        ft = f_of_t(t)
        dft = (
            -2.0 * (a * rho) ** 2 / (t + a2) ** 3
            - 2.0 * (b * az) ** 2 / (t + b2) ** 3
        )
        t = t - ft / torch.where(dft != 0.0, dft, torch.ones_like(dft))

    # Nearest surface point (in the rho-z plane)
    rho_s = a2 * rho / (t + a2)
    z_s = b2 * az / (t + b2)
    # Geodetic latitude from the surface normal at the nearest point
    lat = torch.atan2(z_s / b2, rho_s / a2)
    dist = torch.hypot(rho - rho_s, az - z_s)

    # Equatorial-plane points inside the evolute (rho < a e^2, z ~ 0):
    # the parameter equation degenerates (its root lies below -b^2, so
    # the bisection bracket excludes it and Newton diverges), but the
    # nearest point is closed-form: the ellipse parameter beta satisfies
    # cos(beta) = rho / (a e^2), with two symmetric off-equator solutions
    evolute_rho = (a2 - b2) / a
    deg_eq = (az <= 1e-12 * b) & (rho < evolute_rho)
    cosb = torch.clamp(
        rho / torch.where(evolute_rho > 0.0, evolute_rho, 1.0), 0.0, 1.0
    )
    sinb = torch.sqrt(1.0 - cosb * cosb)
    rho_sd = a * cosb
    z_sd = b * sinb
    lat = torch.where(
        deg_eq, torch.atan2(z_sd / b2, rho_sd / a2), lat
    )
    dist = torch.where(deg_eq, torch.hypot(rho - rho_sd, z_sd), dist)

    # Degenerate axis case (rho == 0): the nearest point is the pole
    on_axis = rho == 0.0
    lat = torch.where(on_axis, math.pi / 2.0, lat)
    alt_axis = az - b
    inside = (rho / a) ** 2 + (az / b) ** 2 < 1.0
    alt = torch.where(inside, -dist, dist)
    alt = torch.where(on_axis, alt_axis, alt)
    lat = torch.where(z < 0.0, -lat, lat)
    return lon, lat, alt


def rect_to_geodetic_exterior(v, re, f, n_iter: int = 3):
    """
    Fast ``recpgr`` equivalent for points *outside* the spheroid (and
    shallow-interior points): Bowring's method with geocentric
    initialisation, which converges to machine precision in 2-3 iterations
    everywhere outside the evolute.
    """
    x = v[..., 0]
    y = v[..., 1]
    z = v[..., 2]
    rp = re * (1.0 - f)
    e2 = f * (2.0 - f)
    ep2 = e2 / (1.0 - e2)
    lon = torch.atan2(y, x)
    rho = torch.hypot(x, y)
    beta = torch.atan2(z, (1.0 - f) * rho)
    lat = beta
    for _ in range(n_iter):
        sb = torch.sin(beta)
        cb = torch.cos(beta)
        lat = torch.atan2(z + ep2 * rp * sb**3, rho - e2 * re * cb**3)
        beta = torch.atan2((1.0 - f) * torch.sin(lat), torch.cos(lat))
    sin_lat = torch.sin(lat)
    cos_lat = torch.cos(lat)
    n = re / torch.sqrt(1.0 - e2 * sin_lat * sin_lat)
    alt = rho * cos_lat + z * sin_lat - n * (1.0 - e2 * sin_lat * sin_lat)
    return lon, lat, alt


def rect_to_latlon_centric(v):
    """``reclat`` equivalent: ``(radius, lon_e, lat_centric)``."""
    r = norm(v)
    lon = torch.atan2(v[..., 1], v[..., 0])
    lat = torch.asin(
        torch.clamp(v[..., 2] / torch.where(r > 0, r, 1.0), -1.0, 1.0)
    )
    return r, lon, lat


def rect_to_radec(v):
    """``recrad`` equivalent: ``(range, ra, dec)`` with ra in [0, 2pi)."""
    r = norm(v)
    ra = torch.remainder(torch.atan2(v[..., 1], v[..., 0]), 2.0 * math.pi)
    dec = torch.asin(
        torch.clamp(v[..., 2] / torch.where(r > 0, r, 1.0), -1.0, 1.0)
    )
    return r, ra, dec


def radec_to_rect(r, ra, dec):
    """``radrec`` equivalent."""
    cos_dec = torch.cos(dec)
    return torch.stack(
        [
            r * torch.cos(ra) * cos_dec,
            r * torch.sin(ra) * cos_dec,
            r * torch.sin(dec),
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Ray-ellipsoid intersection
# ---------------------------------------------------------------------------

def ray_ellipsoid_intercept(origin, direction, radii):
    """
    ``sincpt``'s geometric core: smallest positive ray parameter ``s`` such
    that ``origin + s*direction`` lies on the ellipsoid with semi-axes
    ``radii``. Returns ``(s, found)`` with ``s`` NaN where no intercept
    exists (discriminant < 0 or intercept behind the ray origin).
    """
    o = origin / radii
    d = direction / radii
    a = torch.sum(d * d, dim=-1)
    b = torch.sum(o * d, dim=-1)
    # Recentre on the ray's closest approach to the centre before forming
    # the discriminant: the naive b^2 - a*c cancels ~2*log10(|o|/|q|)
    # digits, while the recentred q = o + t_ca*d only cancels *linearly*,
    # leaving the discriminant exact to ~1e-9 of the body radius.
    t_ca = -b / a
    q = o + t_ca[..., None] * d
    cq = torch.sum(q * q, dim=-1) - 1.0
    disc = -cq / a  # == (b^2 - a c)/a^2 = (sqrt_disc/a)^2
    found = disc >= 0.0
    sqrt_disc = torch.sqrt(torch.where(found, disc, 0.0))
    s_near = t_ca - sqrt_disc
    # smallest POSITIVE parameter: a ray starting inside the ellipsoid
    # exits through the far root (surfpt semantics)
    s = torch.where(s_near >= 0.0, s_near, t_ca + sqrt_disc)
    found = found & (s >= 0.0)
    s = torch.where(found, s, math.nan)
    return s, found


def surface_normal(point, radii):
    """Outward unit normal of the ellipsoid at a surface point (``surfnm``)."""
    n = point / (radii * radii)
    return n / norm(n, keepdim=True)


def radial_surface_point(direction, radii):
    """
    ``surfpt`` from the body centre: scale ``direction`` onto the ellipsoid
    surface.
    """
    d = direction / radii
    scale = 1.0 / norm(d, keepdim=True)
    return direction * scale


def nearest_point_on_line(line_point, line_dir, point):
    """
    ``nplnpt`` equivalent: nearest point on the line through ``line_point``
    with direction ``line_dir`` to ``point``; returns ``(near, dist)``.
    """
    d = line_dir / norm(line_dir, keepdim=True)
    s = torch.sum((point - line_point) * d, dim=-1, keepdim=True)
    near = line_point + s * d
    dist = norm(near - point)
    return near, dist


# ---------------------------------------------------------------------------
# Planes (``nvp2pl`` / ``inrypl``)
# ---------------------------------------------------------------------------

def plane_from_normal_point(normal, point):
    """
    ``nvp2pl`` equivalent: plane as ``(unit_normal, constant)`` with
    ``unit_normal . x = constant`` (constant >= 0, matching SPICE's
    normalised plane representation).
    """
    n = normal / norm(normal, keepdim=True)
    c = torch.sum(n * point, dim=-1)
    flip = torch.where(c < 0, -1.0, 1.0)
    return n * flip[..., None], torch.abs(c)


def ray_plane_intercept(origin, direction, plane_normal, plane_constant):
    """
    ``inrypl`` equivalent: intersection of a ray with a plane. Returns
    ``(point, n_intersections)`` where ``n_intersections`` is 0 (parallel,
    misses), 1 (proper intersection ahead of the origin), or -1 (the ray
    lies in the plane; SPICE's "infinite intersections" case).
    """
    denom = torch.sum(direction * plane_normal, dim=-1)
    num = plane_constant - torch.sum(origin * plane_normal, dim=-1)
    # Near-parallel rays (relative threshold, not exact zero): the
    # nominal intersection distance is pure rounding noise at ~1e12 km
    # scales, so treat edge-on geometry as parallel like CSPICE's
    # degenerate-case handling rather than returning garbage points
    dn = norm(direction)
    degenerate = torch.abs(denom) <= 1e-12 * dn
    scale = torch.abs(plane_constant) + norm(origin)
    in_plane = degenerate & (torch.abs(num) <= 1e-9 * scale)
    parallel = degenerate & ~in_plane
    s = num / torch.where(torch.abs(denom) > 0.0, denom, 1.0)
    ok = (~parallel) & (~in_plane) & (s >= 0.0)
    point = origin + s[..., None] * direction
    point = torch.where(ok[..., None], point, math.nan)
    nxpts = torch.where(
        in_plane, -1, torch.where(ok, 1, 0)
    )
    return point, nxpts


# ---------------------------------------------------------------------------
# Limb of an ellipsoid (``edlimb`` equivalent)
# ---------------------------------------------------------------------------

def limb_ellipse(observer_bf, radii):
    """
    The limb of the ellipsoid as seen from ``observer_bf`` (body-fixed
    observer position relative to the body centre), as an exact ellipse:
    returns ``(center, semi_axis_1, semi_axis_2)`` so that limb points are
    ``center + cos(theta)*semi_axis_1 + sin(theta)*semi_axis_2``.

    Derivation: on the unit sphere u = q/radii the limb plane is
    ``m . u = 1`` with ``m = observer_bf/radii``; the limb is the circle cut
    by that plane, mapped back through the ``radii`` scaling.
    """
    m = observer_bf / radii
    m2 = torch.sum(m * m, dim=-1, keepdim=True)
    mhat = m / torch.sqrt(m2)
    delta = 1.0 / torch.sqrt(m2)  # distance of plane from origin (unit sphere)
    rho = torch.sqrt(torch.clamp(1.0 - delta * delta, min=0.0))

    # Any orthonormal basis of the plane perpendicular to mhat
    e1 = _perpendicular_unit(mhat)
    e2 = torch.linalg.cross(mhat, e1)

    center = mhat * delta * radii
    axis1 = e1 * rho * radii
    axis2 = e2 * rho * radii
    return center, axis1, axis2


def _perpendicular_unit(v):
    """A unit vector perpendicular to v (branch-free)."""
    # Choose the smallest component axis to cross against
    ax = torch.abs(v)
    use_x = (ax[..., 0] <= ax[..., 1]) & (ax[..., 0] <= ax[..., 2])
    use_y = (~use_x) & (ax[..., 1] <= ax[..., 2])
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    basis = torch.where(
        use_x[..., None],
        torch.broadcast_to(eye[0], v.shape),
        torch.where(
            use_y[..., None],
            torch.broadcast_to(eye[1], v.shape),
            torch.broadcast_to(eye[2], v.shape),
        ),
    )
    p = torch.linalg.cross(v, basis)
    return p / norm(p, keepdim=True)


# ---------------------------------------------------------------------------
# Angles
# ---------------------------------------------------------------------------

def vector_separation(a, b):
    """
    ``vsep`` equivalent: angle between vectors, numerically stable near 0
    and pi (uses the half-angle construction like SPICE).
    """
    an = a / norm(a, keepdim=True)
    bn = b / norm(b, keepdim=True)
    dot = torch.sum(an * bn, dim=-1)
    near = norm(an - bn)
    far = norm(an + bn)
    return torch.where(
        dot >= 0.0,
        2.0 * torch.asin(torch.clamp(0.5 * near, -1.0, 1.0)),
        math.pi - 2.0 * torch.asin(torch.clamp(0.5 * far, -1.0, 1.0)),
    )
