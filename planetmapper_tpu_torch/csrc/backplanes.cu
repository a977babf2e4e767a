// All 26 default backplanes of a BodyXY frame in one CUDA kernel.
//
// Replaces the TPU kernel of planetmapper_tpu/ops/pallas_pipeline.py
// (build_pallas_pipeline: kernel body at :481, pallas_call at :1152). The
// reference on the GPU is the plain float64 PyTorch graph
// planetmapper_tpu_torch.pipeline.fused_backplanes_fn, whose per-pixel
// algebra this kernel follows step by step.
//
// Design (first version: right and simple, fast later):
// - One thread per pixel in 32x8 blocks over a ceil(ny/8) x ceil(nx/32)
//   grid; threads past the ragged edge return. Row y is `row + row0`, so a
//   frame can be split into row bands (as at pallas_pipeline.py:320-323).
// - Everything runs in native double: the H100 has it, so the TPU kernel's
//   double-single chains and polynomial atan2/asin are not needed. The ray
//   trig is computed per pixel (sincos of the two angular offsets), not
//   from separable row/column tables.
// - The per-scene float64 scalars (the anchors reduced to the values below,
//   see `Scene`) are computed by the PyTorch wrapper and read here through
//   the read-only cache; every thread reads the same addresses.
// - Stores are float32 into one (NP, ny, nx) tensor in PLANE_ORDER, as the
//   TPU kernel stores them; the wrapper upcasts RADIAL-VELOCITY to float64.
// - With optimize_speed, a pixel outside the r_cut circle skips the light
//   time / intercept chain and writes NaN to the on-disc planes; a block
//   wholly outside skips it in every thread. The ring occlusion distance
//   stays in a register.
// - Plane subsets are a run-time slot table in one compiled kernel: every
//   plane is computed by the same instructions whichever subset is asked
//   for, so a subset equals the full set bit for bit.
//
// What bounds it on this card: per pixel it does ~60 double
// transcendentals and a few hundred double multiply-adds against 104 bytes
// of float32 stores, so double-precision arithmetic (not memory traffic)
// sets its time. This first design does nothing about that beyond fusing
// the whole pipeline into one pass; making it fast is later work.
//
// Built by planetmapper_tpu_torch/ops/backplanes_kernel.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kPlanes = 26;
constexpr double kPi = 3.141592653589793;
constexpr double kDeg = kPi / 180.0;
constexpr double kClight = 299792.458;  // km/s

// Output planes, in PLANE_ORDER.
enum Plane {
    LON_GRAPHIC, LAT_GRAPHIC, LON_CENTRIC, LAT_CENTRIC, RA, DEC,
    PIXEL_X, PIXEL_Y, KM_X, KM_Y, ANGULAR_X, ANGULAR_Y, PHASE, INCIDENCE,
    EMISSION, AZIMUTH, LOCAL_SOLAR_TIME, DISTANCE, RADIAL_VELOCITY, DOPPLER,
    LIMB_DISTANCE, LIMB_LON_GRAPHIC, LIMB_LAT_GRAPHIC, RING_RADIUS,
    RING_LON_GRAPHIC, RING_DISTANCE,
};

// Offsets into the float64 scene vector (must match _SCENE_LAYOUT in
// ops/backplanes_kernel.py; checked at load time via backplanes26_scene_size).
enum Scene {
    S_XY2A = 0,            // xy2angular rows 0-1 (6)
    S_MANG = 6,            // obsvec2angular (3x3, row-major)
    S_ET = 15,
    S_TAU0 = 16,
    S_TARGET_LT = 17,
    S_TARG_REL0 = 18,      // targ_pos0 - obs_pos
    S_TARG_VEL0 = 21,
    S_TARG_POS0 = 24,
    S_ROT0 = 27,           // rotation and its derivatives at tau0 (3x3 each)
    S_ROT1 = 36,
    S_ROT2H = 45,          // 0.5 * rot2
    S_RADII = 54,
    S_FLAT = 57,
    S_DISC = 58,           // x0, y0, r_cut
    S_SUN_POS0 = 61,
    S_SUN_VEL0 = 64,
    S_SUN_EPOCH0 = 67,
    S_OBS_VEL = 68,
    S_A2KM = 71,           // angular2km (2x2, row-major)
    S_KPA = 75,            // km per arcsec
    S_SOLAR_LON = 76,
    S_TARGET_OBSVEC = 77,
    S_SP_OBSVEC = 80,
    S_SP_RAYVEC = 83,
    S_SP_DIST = 86,
    S_SP_TARGVEC = 87,
    S_RING_N = 90,
    S_RING_C = 93,
    SCENE_SIZE = 94,
};

enum Flags {
    F_POSITIVE_WEST = 1,
    F_PROGRADE = 2,
    F_HAVE_SUN = 4,
    F_OPTIMIZE_SPEED = 8,
    F_LST_QUANT = 16,
};

struct Params {
    int nx, ny;
    double row0;
    int slot[kPlanes];  // output slot of each plane, -1 when not requested
    int n_lt_iters;
    int geodetic_iters;
    int flags;
};

struct V3 {
    double x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, double s) {
    return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ double dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ double norm(V3 a) { return sqrt(dot(a, a)); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 hadamard_div(V3 a, V3 b) {
    return {a.x / b.x, a.y / b.y, a.z / b.z};
}

__device__ __forceinline__ double sc(const double* s, int i) {
    return __ldg(s + i);
}
__device__ __forceinline__ V3 sc3(const double* s, int i) {
    return {__ldg(s + i), __ldg(s + i + 1), __ldg(s + i + 2)};
}

// Clamp to [-1, 1] that keeps NaN (fmin/fmax would drop it).
__device__ __forceinline__ double clamp_unit(double x) {
    return x > 1.0 ? 1.0 : (x < -1.0 ? -1.0 : x);
}

// x mod m with the sign of m (numpy / torch.remainder semantics).
__device__ __forceinline__ double remainder_pos(double x, double m) {
    double r = fmod(x, m);
    return (r < 0.0) ? r + m : r;
}

// Rotation J2000 -> body-fixed at tau0 + dt (second-order Taylor), applied
// to v; `transpose` applies its inverse.
__device__ V3 rot_apply(const double* s, double dt, V3 v, bool transpose) {
    const double dt2 = dt * dt;
    double r[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        r[k] = sc(s, S_ROT0 + k) + sc(s, S_ROT1 + k) * dt
               + sc(s, S_ROT2H + k) * dt2;
    }
    if (transpose) {
        return {r[0] * v.x + r[3] * v.y + r[6] * v.z,
                r[1] * v.x + r[4] * v.y + r[7] * v.z,
                r[2] * v.x + r[5] * v.y + r[8] * v.z};
    }
    return {r[0] * v.x + r[1] * v.y + r[2] * v.z,
            r[3] * v.x + r[4] * v.y + r[5] * v.z,
            r[6] * v.x + r[7] * v.y + r[8] * v.z};
}

// Inverse of the time derivative of the rotation at tau0 + dt, applied to v.
__device__ V3 rot_dot_transpose_apply(const double* s, double dt, V3 v) {
    double r[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        r[k] = sc(s, S_ROT1 + k) + 2.0 * sc(s, S_ROT2H + k) * dt;
    }
    return {r[0] * v.x + r[3] * v.y + r[6] * v.z,
            r[1] * v.x + r[4] * v.y + r[7] * v.z,
            r[2] * v.x + r[5] * v.y + r[8] * v.z};
}

// Smallest non-negative ray parameter of the ellipsoid intercept
// (core/geometry.py ray_ellipsoid_intercept): recentred discriminant.
__device__ bool ray_ellipsoid(V3 origin, V3 dir, V3 radii, double* s_out) {
    const V3 o = hadamard_div(origin, radii);
    const V3 d = hadamard_div(dir, radii);
    const double a = dot(d, d);
    const double b = dot(o, d);
    const double t_ca = -b / a;
    const V3 q = o + d * t_ca;
    const double cq = dot(q, q) - 1.0;
    const double disc = -cq / a;
    bool found = disc >= 0.0;
    const double sqrt_disc = sqrt(found ? disc : 0.0);
    const double s_near = t_ca - sqrt_disc;
    const double s = (s_near >= 0.0) ? s_near : t_ca + sqrt_disc;
    found = found && (s >= 0.0);
    *s_out = s;
    return found;
}

// Graphic latitude of a point on (or near) the (re, f) spheroid: Bowring's
// form from the reduced latitude plus `iters` refinement steps (0 is exact
// on the spheroid; 4 for triaxial bodies' off-spheroid surface points).
__device__ double bowring_lat(double rho, double z, double re, double f,
                              int iters) {
    const double omf = 1.0 - f;
    const double e2 = f * (2.0 - f);
    const double ep2 = e2 / (1.0 - e2);
    const double w = rho * omf;
    const double rb = 1.0 / sqrt(z * z + w * w);
    double sb = z * rb;
    double cb = w * rb;
    double num = z + ep2 * (re * omf) * sb * sb * sb;
    double den = rho - e2 * re * cb * cb * cb;
    for (int i = 0; i < iters; ++i) {
        const double rr = 1.0 / sqrt(num * num + den * den);
        const double sl = num * rr;
        const double cl = den * rr;
        const double rb2 = 1.0 / sqrt(omf * omf * sl * sl + cl * cl);
        sb = omf * sl * rb2;
        cb = cl * rb2;
        num = z + ep2 * (re * omf) * sb * sb * sb;
        den = rho - e2 * re * cb * cb * cb;
    }
    return atan2(num, den);
}

// Altitude above the (re, f) spheroid of an exterior point (ring plane):
// trig-free Bowring, geocentric start, two refinement steps.
__device__ double exterior_alt(double rho, double z, double re, double f) {
    const double omf = 1.0 - f;
    const double e2 = f * (2.0 - f);
    const double ep2 = e2 / (1.0 - e2);
    const double w = rho * omf;
    const double rb = 1.0 / sqrt(z * z + w * w);
    double sb = z * rb;
    double cb = w * rb;
    for (int i = 0; i < 2; ++i) {
        const double num = z + ep2 * (re * omf) * sb * sb * sb;
        const double den = rho - e2 * re * cb * cb * cb;
        const double rr = 1.0 / sqrt(num * num + den * den);
        const double sl = num * rr;
        const double cl = den * rr;
        const double rb2 = 1.0 / sqrt(omf * omf * sl * sl + cl * cl);
        sb = omf * sl * rb2;
        cb = cl * rb2;
    }
    const double num = z + ep2 * (re * omf) * sb * sb * sb;
    const double den = rho - e2 * re * cb * cb * cb;
    const double rr = 1.0 / sqrt(num * num + den * den);
    const double sl = num * rr;
    const double cl = den * rr;
    const double n = re / sqrt(1.0 - e2 * sl * sl);
    return rho * cl + z * sl - n * (1.0 - e2 * sl * sl);
}

// Body-fixed vector of an observer-frame point, retargeted in time about
// the sub-observer point (pipeline.py _obsvec2targvec_lin).
__device__ V3 obsvec2targvec(const double* s, V3 obsvec) {
    const V3 off = obsvec - sc3(s, S_SP_OBSVEC);
    const double dist_offset =
        norm(off - sc3(s, S_SP_RAYVEC)) - sc(s, S_SP_DIST);
    const double tau0 = sc(s, S_TAU0);
    const double dt = (tau0 - dist_offset / kClight) - tau0;
    return sc3(s, S_SP_TARGVEC) + rot_apply(s, dt, off, false);
}

// Angle between two vectors (SPICE vsep half-angle construction).
__device__ double vsep(V3 a, V3 b) {
    const V3 an = a * (1.0 / norm(a));
    const V3 bn = b * (1.0 / norm(b));
    if (dot(an, bn) >= 0.0) {
        return 2.0 * asin(clamp_unit(0.5 * norm(an - bn)));
    }
    return kPi - 2.0 * asin(clamp_unit(0.5 * norm(an + bn)));
}

__global__ void __launch_bounds__(256)
backplanes26_kernel(const double* __restrict__ s, float* __restrict__ out,
                    const Params p) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    const int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= p.nx || row >= p.ny) return;

    const size_t plane_stride = (size_t)p.nx * (size_t)p.ny;
    const size_t pix = (size_t)row * (size_t)p.nx + (size_t)col;
    auto store = [&](int plane, double v) {
        const int k = p.slot[plane];
        if (k >= 0) out[(size_t)k * plane_stride + pix] = (float)v;
    };
    auto wanted = [&](int plane) { return p.slot[plane] >= 0; };

    const double nan = __longlong_as_double(0x7ff8000000000000ULL);
    const double lon_sign = (p.flags & F_POSITIVE_WEST) ? -1.0 : 1.0;
    const double spin_sign = (p.flags & F_PROGRADE) ? 1.0 : -1.0;
    const V3 radii = sc3(s, S_RADII);
    const double re = radii.x;
    const double flat = sc(s, S_FLAT);

    // ---- pixel -> angular -> unit ray in J2000 ------------------------
    const double xg = (double)col;
    const double yg = (double)row + p.row0;
    const double ang_x = sc(s, S_XY2A + 0) * xg + sc(s, S_XY2A + 1) * yg
                         + sc(s, S_XY2A + 2);
    const double ang_y = sc(s, S_XY2A + 3) * xg + sc(s, S_XY2A + 4) * yg
                         + sc(s, S_XY2A + 5);
    double sra, cra, sdec, cdec;
    sincos(-ang_x / 3600.0 * kDeg, &sra, &cra);
    sincos(ang_y / 3600.0 * kDeg, &sdec, &cdec);
    const V3 vec = {cra * cdec, sra * cdec, sdec};
    const V3 d = {
        vec.x * sc(s, S_MANG + 0) + vec.y * sc(s, S_MANG + 3)
            + vec.z * sc(s, S_MANG + 6),
        vec.x * sc(s, S_MANG + 1) + vec.y * sc(s, S_MANG + 4)
            + vec.z * sc(s, S_MANG + 7),
        vec.x * sc(s, S_MANG + 2) + vec.y * sc(s, S_MANG + 5)
            + vec.z * sc(s, S_MANG + 8),
    };

    // ---- the disc chain: light time, intercept, on-disc planes --------
    bool need_chain = false;
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) {
        const bool always = (k >= RA && k <= ANGULAR_Y)
                            || (k >= LIMB_DISTANCE && k <= LIMB_LAT_GRAPHIC);
        need_chain = need_chain || (!always && p.slot[k] >= 0);
    }
    bool off = false;
    if (p.flags & F_OPTIMIZE_SPEED) {
        const double dx = xg - sc(s, S_DISC + 0);
        const double dy = yg - sc(s, S_DISC + 1);
        const double r_cut = sc(s, S_DISC + 2);
        off = dx * dx + dy * dy > r_cut * r_cut;
    }
    double dist_surface = nan;  // ring occlusion (NaN: nothing hides it)
    bool found = false;
    if (need_chain && !off) {
        const double et = sc(s, S_ET);
        const double tau0 = sc(s, S_TAU0);
        const double target_lt = sc(s, S_TARGET_LT);
        const V3 targ_rel0 = sc3(s, S_TARG_REL0);
        const V3 targ_vel0 = sc3(s, S_TARG_VEL0);
        double lt = target_lt;
        double s_hit = 0.0;
        V3 spoint = {0.0, 0.0, 0.0};
        for (int it = 0; it <= p.n_lt_iters; ++it) {
            const double dt = (et - lt) - tau0;
            const V3 targ_rel = targ_rel0 + targ_vel0 * dt;
            const V3 o_bf = -rot_apply(s, dt, targ_rel, false);
            const V3 d_bf = rot_apply(s, dt, d, false);
            found = ray_ellipsoid(o_bf, d_bf, radii, &s_hit);
            spoint = o_bf + d_bf * s_hit;
            lt = (found ? s_hit : target_lt * kClight) / kClight;
        }
        const double tau = et - lt;
        const double dt = tau - tau0;

        if (found) {
            dist_surface = lt * kClight;
            // -- lon/lat ------------------------------------------------
            const double lon_e = atan2(spoint.y, spoint.x);
            const double rho = hypot(spoint.x, spoint.y);
            store(LON_GRAPHIC, remainder_pos(lon_sign * lon_e / kDeg, 360.0));
            if (wanted(LAT_GRAPHIC)) {
                store(LAT_GRAPHIC,
                      bowring_lat(rho, spoint.z, re, flat, p.geodetic_iters)
                          / kDeg);
            }
            store(LON_CENTRIC, remainder_pos(lon_e / kDeg, 360.0));
            const double r_sp = norm(spoint);
            store(LAT_CENTRIC,
                  asin(clamp_unit(spoint.z / r_sp)) / kDeg);

            // -- illumination --------------------------------------------
            const V3 point_j = rot_apply(s, dt, spoint, true);
            const V3 srfvec_j2000 = targ_rel0 + targ_vel0 * dt + point_j;
            const V3 srfvec_bf = rot_apply(s, dt, srfvec_j2000, false);
            V3 sun_bf = {nan, nan, nan};
            if (p.flags & F_HAVE_SUN) {
                const V3 point_ssb =
                    sc3(s, S_TARG_POS0) + targ_vel0 * dt + point_j;
                const double lt_s =
                    norm(sc3(s, S_SUN_POS0) - point_ssb) / kClight;
                const double sun_dt = (tau - lt_s) - sc(s, S_SUN_EPOCH0);
                const V3 sun_pos =
                    sc3(s, S_SUN_POS0) + sc3(s, S_SUN_VEL0) * sun_dt;
                sun_bf = rot_apply(s, dt, sun_pos - point_ssb, false);
            }
            const V3 normal_raw = hadamard_div(
                spoint, {radii.x * radii.x, radii.y * radii.y,
                         radii.z * radii.z});
            const V3 normal = normal_raw * (1.0 / norm(normal_raw));
            const V3 to_obs = -srfvec_bf;
            store(PHASE, vsep(sun_bf, to_obs) / kDeg);
            store(INCIDENCE, vsep(normal, sun_bf) / kDeg);
            store(EMISSION, vsep(normal, to_obs) / kDeg);
            if (wanted(AZIMUTH)) {
                // dihedral between the tangent-plane projections of the
                // sun and observer directions (well conditioned at the
                // sub-solar and sub-observer caps)
                const V3 a = sun_bf - normal * dot(normal, sun_bf);
                const V3 b = to_obs - normal * dot(normal, to_obs);
                store(AZIMUTH,
                      (kPi - atan2(norm(cross(a, b)), dot(a, b))) / kDeg);
            }

            // -- local solar time -----------------------------------------
            if (wanted(LOCAL_SOLAR_TIME)) {
                double lst = remainder_pos(
                    12.0 + spin_sign * (lon_e - sc(s, S_SOLAR_LON)) * 12.0
                               / kPi,
                    24.0);
                if (p.flags & F_LST_QUANT) lst = floor(lst * 3600.0) / 3600.0;
                store(LOCAL_SOLAR_TIME, lst);
            }

            // -- state ----------------------------------------------------
            store(DISTANCE, dist_surface);
            if (wanted(RADIAL_VELOCITY) || wanted(DOPPLER)) {
                const V3 p_vel =
                    targ_vel0 + rot_dot_transpose_apply(s, dt, spoint);
                const V3 rhat = srfvec_j2000 * (1.0 / norm(srfvec_j2000));
                const V3 obs_vel = sc3(s, S_OBS_VEL);
                const double rv_t = dot(rhat, p_vel);
                const double rv_o = dot(rhat, obs_vel);
                const double dltdt = (rv_t - rv_o) / (kClight + rv_t);
                const double rv = dot(rhat, p_vel * (1.0 - dltdt) - obs_vel);
                store(RADIAL_VELOCITY, rv);
                const double beta = rv / kClight;
                store(DOPPLER, sqrt((1.0 + beta) / (1.0 - beta)));
            }
        }
    }
    if (!found) {
        store(LON_GRAPHIC, nan);
        store(LAT_GRAPHIC, nan);
        store(LON_CENTRIC, nan);
        store(LAT_CENTRIC, nan);
        store(PHASE, nan);
        store(INCIDENCE, nan);
        store(EMISSION, nan);
        store(AZIMUTH, nan);
        store(LOCAL_SOLAR_TIME, nan);
        store(DISTANCE, nan);
        store(RADIAL_VELOCITY, nan);
        store(DOPPLER, nan);
    }

    // ---- RA/Dec, pixel, km, angular (every pixel) ---------------------
    const double d_norm = norm(d);
    store(RA, remainder_pos(atan2(d.y, d.x), 2.0 * kPi) / kDeg);
    store(DEC, asin(clamp_unit(d.z / d_norm)) / kDeg);
    store(PIXEL_X, xg);
    store(PIXEL_Y, yg);
    const double km_x = sc(s, S_A2KM + 0) * ang_x + sc(s, S_A2KM + 1) * ang_y;
    const double km_y = sc(s, S_A2KM + 2) * ang_x + sc(s, S_A2KM + 3) * ang_y;
    store(KM_X, km_x);
    store(KM_Y, km_y);
    store(ANGULAR_X, km_x / sc(s, S_KPA));
    store(ANGULAR_Y, km_y / sc(s, S_KPA));

    // ---- limb: nearest point of the ray to the target centre ----------
    if (wanted(LIMB_DISTANCE) || wanted(LIMB_LON_GRAPHIC)
        || wanted(LIMB_LAT_GRAPHIC)) {
        const V3 target_obsvec = sc3(s, S_TARGET_OBSVEC);
        const V3 dn = d * (1.0 / d_norm);
        const V3 near = dn * dot(target_obsvec, dn);
        const double near_dist = norm(near - target_obsvec);
        const V3 near_targvec = obsvec2targvec(s, near);
        const V3 limb = near_targvec
                        * (1.0 / norm(hadamard_div(near_targvec, radii)));
        store(LIMB_LON_GRAPHIC,
              remainder_pos(lon_sign * atan2(limb.y, limb.x) / kDeg, 360.0));
        if (wanted(LIMB_LAT_GRAPHIC)) {
            store(LIMB_LAT_GRAPHIC,
                  bowring_lat(hypot(limb.x, limb.y), limb.z, re, flat,
                              p.geodetic_iters) / kDeg);
        }
        store(LIMB_DISTANCE, near_dist - norm(limb));
    }

    // ---- ring plane ----------------------------------------------------
    if (wanted(RING_RADIUS) || wanted(RING_LON_GRAPHIC)
        || wanted(RING_DISTANCE)) {
        const V3 ring_n = sc3(s, S_RING_N);
        const double ring_c = sc(s, S_RING_C);
        const double denom = dot(d, ring_n);
        const bool degenerate = fabs(denom) <= 1e-12 * d_norm;
        const bool in_plane = degenerate && fabs(ring_c) <= 1e-9 * fabs(ring_c);
        const bool parallel = degenerate && !in_plane;
        const double s_r = ring_c / (fabs(denom) > 0.0 ? denom : 1.0);
        const bool ring_ok = !parallel && !in_plane && s_r >= 0.0;
        const V3 intercept = d * s_r;
        const double ring_distance = norm(intercept);
        // NaN dist_surface (no surface hit) compares false: not hidden
        const bool hidden = dist_surface < ring_distance;
        if (!ring_ok || hidden) {
            store(RING_RADIUS, nan);
            store(RING_LON_GRAPHIC, nan);
            store(RING_DISTANCE, nan);
        } else {
            const V3 rt = obsvec2targvec(s, intercept);
            store(RING_RADIUS,
                  exterior_alt(hypot(rt.x, rt.y), rt.z, re, flat) + re);
            store(RING_LON_GRAPHIC,
                  remainder_pos(lon_sign * atan2(rt.y, rt.x) / kDeg, 360.0));
            store(RING_DISTANCE, ring_distance);
        }
    }
}

}  // namespace

extern "C" {

int backplanes26_scene_size(void) { return SCENE_SIZE; }

int backplanes26_n_planes(void) { return kPlanes; }

// Launch the kernel on `stream`. `scene` and `out` are device pointers
// (SCENE_SIZE float64; n_requested x ny x nx float32); `slots` is a host
// array of 26 ints. Returns cudaGetLastError() after the launch.
int backplanes26_launch(const double* scene, float* out, int nx, int ny,
                        double row0, const int* slots, int n_lt_iters,
                        int geodetic_iters, int flags, void* stream) {
    Params p;
    p.nx = nx;
    p.ny = ny;
    p.row0 = row0;
    for (int k = 0; k < kPlanes; ++k) p.slot[k] = slots[k];
    p.n_lt_iters = n_lt_iters;
    p.geodetic_iters = geodetic_iters;
    p.flags = flags;
    const dim3 block(32, 8);
    const dim3 grid((nx + 31) / 32, (ny + 7) / 8);
    backplanes26_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(scene, out,
                                                                  p);
    return (int)cudaGetLastError();
}

}  // extern "C"
