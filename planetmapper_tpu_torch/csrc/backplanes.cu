// All 26 default backplanes of a BodyXY frame in one CUDA kernel.
//
// Replaces the TPU kernel of planetmapper_tpu/ops/pallas_pipeline.py
// (build_pallas_pipeline: kernel body at :481, pallas_call at :1152). The
// reference on the GPU is the plain float64 PyTorch graph
// planetmapper_tpu_torch.pipeline.fused_backplanes_fn, whose per-pixel
// algebra this kernel follows.
//
// Design (second version, for Hopper):
// - One thread per pixel in 32x8 blocks over a ceil(ny/8) x ceil(nx/32)
//   grid; threads past the ragged edge help build the block's tables, then
//   return. Row y is `row + row0`, so a frame can be split into row bands.
// - The scene is 106 float64 values packed on the host by the wrapper
//   (ops/backplanes_kernel.py pack_scene) and passed by value in the
//   kernel's parameter struct (a __grid_constant__ of ~1 KB). Every
//   instruction takes its scene operands from the constant bank, so no
//   register holds a scene value, and no launch reads or copies a scene
//   buffer. The host folds what depends on the scene alone: reciprocal
//   radii, the geodetic constants, the affine maps pixel -> ray angle and
//   pixel -> km/arcsec, et - tau0, et - sun_epoch0, sun_pos0 - targ_pos0.
// - The rotation J2000 -> body-fixed (second-order Taylor about tau0) is
//   built once per light-time evaluation and once for the final epoch,
//   and applied to every vector at that epoch.
// - Separable ray trigonometry: the ray's two angles are affine in (x, y),
//   so sin/cos of a*x + (b*y + c) come from per-column sincos(a*x) and
//   per-row sincos(b*y + c) by the angle-addition identity. Each block
//   builds its 32 column and 8 row pairs (80 double sincospi, on angles
//   the host gives in half turns) in shared memory instead of 512. The
//   ray is read from these tables again after the disc chain rather than
//   held in six registers through it.
// - Strength reduction: multiplications by reciprocals in place of
//   divisions by constants and radii, rsqrt in place of 1/sqrt, and exact
//   compare-and-add wraps in place of fmod where the argument's range is
//   known (atan2 output; LOCAL-SOLAR-TIME's [-12, 36]). Each moves a float64
//   value by at most an ulp or two, far below the float32 stores.
// - With optimize_speed, a pixel outside the r_cut circle skips the light
//   time / intercept chain and writes NaN to the on-disc planes. Plane
//   subsets are a run-time slot table in one compiled kernel: every plane
//   is computed by the same instructions whichever subset is asked for, so
//   a subset equals the full set bit for bit.
// - Stores are float32 into one (NP, ny, nx) tensor in PLANE_ORDER, except
//   RADIAL-VELOCITY, which the contract returns in float64: it is stored
//   as float64 into its own (ny, nx) buffer, so no pass widens it later.
//
// - Frames (the batch entry; replaces the lax.map of build_pallas_pipeline
//   over disc sets at planetmapper_tpu/pipeline.py:1904-1908 and the vmap
//   of parallel/timeseries.py:100 over epochs). The per-pixel algebra is
//   written once (backplanes_pixel), templated on where the scene comes
//   from (ParamScene: the single-frame kernel's parameters, constant-bank
//   operands; BlockScene, GlobalScene: below). Output planes are (NP, N,
//   ny, nx), so each plane of the batch is one contiguous (N, ny, nx)
//   view. The wrapper's launch plan (ops/backplanes_kernel.py batch_plan)
//   picks the layout by the frame:
//   - backplanes26_batch_tiles_kernel: frames of 128^2 or more whose 32x8
//     tiles fill 85% of their lanes. The single-frame kernel's tiles and
//     ray tables, a frame a grid layer, 38 frames a launch with their
//     scenes in the launch's parameters (32,224 of its 32,764 bytes): an
//     indexed constant-bank read that every thread of a warp shares. 0
//     bytes of spills, against 8 when the tiles read their scenes from
//     memory (__ldg): 8 frames of 512^2 0.220 ms against 0.255 and 0.241
//     for 8 single-frame launches; 2048^2 1.13x the launches against
//     1.28x.
//   - backplanes26_batch_kernel: narrower frames (the time series' 50x50,
//     whose tiles keep 70% of their lanes: a 2x7 grid for 2,500 pixels,
//     18 of 32 lanes live in the second column). Linear blocks: block b of
//     the launch is 256 consecutive pixels of frame b / blocks_per_frame in
//     row-major order (the frame's last block masked), so every warp but a
//     frame's last is full and stores 32 consecutive values a plane; each
//     pixel computes its own ray trigonometry (4 sincospi); the scenes an
//     (N, 106) device array read through the read-only cache, one launch
//     for any N. 80 registers, 16 bytes of spills. 1000 frames of 50x50,
//     26 planes: 0.393-0.396 ms against the first design's 0.550-0.555 ms
//     (32x8 tiles reading their scenes with __ldg, frames on blockIdx.z).
//   Candidates that lost (scripts/time_backplane_batch.py, H100 80GB HBM3
//   at 700 W, in turns): the linear blocks' scenes in a __constant__ bank
//   of 77 (a device-to-device copy and a launch a chunk: 200 bytes of
//   spills, 0.66-0.69 ms) or in the parameters (38 a launch: 200 bytes of
//   spills, 0.68-0.69 ms), the linear blocks' trigonometry from tables of
//   their rows and columns (a barrier; 0.2-2.9% slower at every size), the
//   tiles reading their scenes with __ldg (above).
//   In tiles the batched kernel beats 8 single-frame launches up to 640^2
//   (0.64x at 256^2, 0.91x at 512^2, 0.996x at 640^2) and loses from
//   768^2 (1.04x; 1.08x at 1024^2, 1.13x at 2048^2), so the wrapper sends
//   frames of 768^2 pixels or more to backplanes26_launch_frames: N
//   launches of the single-frame kernel from one C call (its
//   kFrameOfBatch instance), each with its scene by value, into the same
//   (NP, N, ny, nx) layout.
//
// Precision of each plane (bars: tests/test_pallas_core.py:673-696, plus
// one float32 ulp of the stored value):
// - float64 throughout: the ray, the light-time loop and ellipsoid
//   intercept, the Bowring iterations, PIXEL-X/Y, KM-X/Y, ANGULAR-X/Y,
//   DISTANCE, RADIAL-VELOCITY, DOPPLER, LIMB-DISTANCE, RING-RADIUS,
//   RING-DISTANCE; lon_e = atan2(y, x) of the surface point in float64,
//   so LON-GRAPHIC, LON-CENTRIC (wrapped exactly to [0, 360)) and
//   LOCAL-SOLAR-TIME (whose 1/3600 h bins float32 noise would flip) are
//   float64 to the store.
// - float32 atan2f of float64 arguments, converted to degrees and wrapped
//   in float64: LAT-GRAPHIC, LAT-CENTRIC (atan2f(z, rho)), RA, DEC
//   (atan2f(z, rho)), PHASE, INCIDENCE, EMISSION (atan2f(|a x b|, a.b)),
//   AZIMUTH, LIMB-LON/LAT-GRAPHIC, RING-LON-GRAPHIC: atan2f's 2 ulps and
//   the argument rounding give <= 3e-5 deg against the 1e-4 deg bar.
//
// What bounds it: the function's least work (planetmapper_tpu_torch/
// testing/bounds.py, counted from the plain graph at the cheapest known
// form of each step) is ~380 float64 operations per pixel and ~700 more
// per on-disc pixel, 0.098 ms at 2048^2 at the card's peak rates, below
// its 108 bytes of stores per pixel, 0.135 ms at the HBM rate: the bound
// is the stores'. The kernel's own instruction stream is longer (double
// rsqrt, division, atan2 and sincospi expand to many instructions) and is
// not counted. The first design held 126 registers (2 blocks of 256
// threads per SM, 25% occupancy). This one is launched with
// __launch_bounds__(256, 3): ptxas (CUDA 12.8, sm_90a) gives 80 registers,
// no spills and no stack, and the card keeps 3 blocks of 256 threads per
// SM (37.5% occupancy); builds at a minimum of 2 blocks ran slower and at
// 4 blocks spilled. chip_smoke.py's [build] phase prints the registers,
// local memory and resident blocks of every build
// (backplanes26_occupancy below).
//
// Built by planetmapper_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>
#include <string.h>

namespace {

constexpr int kPlanes = 26;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMinBlocksPerSM = 3;
constexpr int kBatchThreads = 256;  // threads of a batched block at most
constexpr int kBlockScenes = 38;  // scenes in a tiled launch's parameters
constexpr double kPi = 3.141592653589793;
constexpr double kDegPerRad = 180.0 / kPi;
constexpr double kClight = 299792.458;  // km/s
constexpr double kInvClight = 1.0 / kClight;
constexpr double kHoursPerRad = 12.0 / kPi;
constexpr double kInvLstBin = 1.0 / 3600.0;

// Output planes, in PLANE_ORDER.
enum Plane {
    LON_GRAPHIC, LAT_GRAPHIC, LON_CENTRIC, LAT_CENTRIC, RA, DEC,
    PIXEL_X, PIXEL_Y, KM_X, KM_Y, ANGULAR_X, ANGULAR_Y, PHASE, INCIDENCE,
    EMISSION, AZIMUTH, LOCAL_SOLAR_TIME, DISTANCE, RADIAL_VELOCITY, DOPPLER,
    LIMB_DISTANCE, LIMB_LON_GRAPHIC, LIMB_LAT_GRAPHIC, RING_RADIUS,
    RING_LON_GRAPHIC, RING_DISTANCE,
};

// Offsets into the float64 scene (must match _SCENE_LAYOUT in
// ops/backplanes_kernel.py; checked at load time via
// backplanes26_scene_size).
enum Scene {
    S_RAY = 0,          // ra / pi = [0]*x + ([1]*y + [2]); dec / pi: [3..5]
    S_MANG = 6,         // obsvec2angular (3x3, row-major)
    S_KM = 15,          // KM-X/Y affine in (x, y) (2x3, row-major)
    S_ANGULAR = 21,     // ANGULAR-X/Y affine in (x, y) (2x3)
    S_ET_TAU0 = 27,     // et - tau0
    S_TAU0 = 28,
    S_TARGET_LT = 29,
    S_TARG_REL0 = 30,   // targ_pos0 - obs_pos
    S_TARG_VEL0 = 33,
    S_ROT0 = 36,        // rotation and its derivatives at tau0 (3x3 each)
    S_ROT1 = 45,
    S_ROT2H = 54,       // 0.5 * rot2
    S_RINV = 63,        // 1 / radii
    S_RINV2 = 66,       // 1 / radii^2
    S_RE = 69,          // geodetic spheroid (re, f): re
    S_OMF = 70,         // 1 - f
    S_OMF2 = 71,        // (1 - f)^2
    S_E2 = 72,          // f (2 - f)
    S_EP2_RE_OMF = 73,  // e2 / (1 - e2) * (re (1 - f))
    S_E2_RE = 74,       // e2 * re
    S_DISC = 75,        // x0, y0, r_cut^2
    S_SUN_REL0 = 78,    // sun_pos0 - targ_pos0
    S_SUN_VEL0 = 81,
    S_SUN_OFF = 84,     // et - sun_epoch0
    S_OBS_VEL = 85,
    S_SOLAR_LON = 88,   // in [-pi, pi]
    S_TARGET_OBSVEC = 89,
    S_SP_OBSVEC = 92,
    S_SP_RAYVEC = 95,
    S_SP_DIST = 98,
    S_SP_TARGVEC = 99,
    S_RING_N = 102,
    S_RING_C = 105,
    SCENE_SIZE = 106,
};

enum Flags {
    F_POSITIVE_WEST = 1,
    F_PROGRADE = 2,
    F_HAVE_SUN = 4,
    F_OPTIMIZE_SPEED = 8,
    F_LST_QUANT = 16,
};

struct Params {
    double s[SCENE_SIZE];
    double row0;
    unsigned long long plane_stride;  // between planes (frames of a batch)
    int nx, ny;
    int slot[kPlanes];  // output slot of each plane, -1 when not requested
    int n_lt_iters;
    int geodetic_iters;
    int flags;
};

// The batched launch's parameters: Params without the scene (a device
// array of scenes), and where the launch's frames lie in the batch.
struct BatchParams {
    double row0;
    unsigned long long plane_stride;  // n_frames * frame_size
    long long first_frame;  // the launch's first frame in the batch
    int nx, ny;
    int frame_size;  // nx * ny
    int blocks_per_frame;
    int slot[kPlanes];
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
__device__ __forceinline__ V3 hadamard(V3 a, V3 b) {
    return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ double dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ double norm(V3 a) { return sqrt(dot(a, a)); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

template <class Sc>
__device__ __forceinline__ V3 sc3(const Sc& sc, int i) {
    return {sc[i], sc[i + 1], sc[i + 2]};
}

// x in (-360, 360) -> [0, 360): exact for atan2 output in degrees.
__device__ __forceinline__ double wrap360(double x) {
    return x < 0.0 ? x + 360.0 : x;
}

// float32 atan2 of float64 arguments, in degrees (float64).
__device__ __forceinline__ double atan2_deg(double y, double x) {
    return (double)atan2f((float)y, (float)x) * kDegPerRad;
}

// Angle between two vectors in degrees: atan2(|a x b|, a.b), well
// conditioned at 0 and 180 degrees; float64 up to the float32 atan2.
__device__ __forceinline__ double angle_deg(V3 a, V3 b) {
    return atan2_deg(norm(cross(a, b)), dot(a, b));
}

// Per-block sin/cos of the column and row parts of the two ray angles
// (ra and dec): [0] sin ra, [1] cos ra, [2] sin dec, [3] cos dec; NC
// column and NR row slots.
template <int NC, int NR>
struct RayTables {
    double col[4][NC];
    double row[4][NR];
};
// A 32x8 tile of one frame; the slots of a batched block's 256 pixels
using FrameTables = RayTables<kBlockX, kBlockY>;
using BatchTables = RayTables<kBatchThreads, kBatchThreads>;

// The J2000 ray of a pixel whose column and row parts are in slots cx and
// ry of the tables: angle addition, then the obsvec2angular rotation.
template <class Sc, class Tab>
__device__ __forceinline__ V3 ray_j2000(const Sc& sc, const Tab& tab,
                                        int cx, int ry) {
    const double sra = tab.col[0][cx] * tab.row[1][ry]
                       + tab.col[1][cx] * tab.row[0][ry];
    const double cra = tab.col[1][cx] * tab.row[1][ry]
                       - tab.col[0][cx] * tab.row[0][ry];
    const double sdec = tab.col[2][cx] * tab.row[3][ry]
                        + tab.col[3][cx] * tab.row[2][ry];
    const double cdec = tab.col[3][cx] * tab.row[3][ry]
                        - tab.col[2][cx] * tab.row[2][ry];
    const V3 vec = {cra * cdec, sra * cdec, sdec};
    return {vec.x * sc[S_MANG + 0] + vec.y * sc[S_MANG + 3]
                + vec.z * sc[S_MANG + 6],
            vec.x * sc[S_MANG + 1] + vec.y * sc[S_MANG + 4]
                + vec.z * sc[S_MANG + 7],
            vec.x * sc[S_MANG + 2] + vec.y * sc[S_MANG + 5]
                + vec.z * sc[S_MANG + 8]};
}

// Rotation J2000 -> body-fixed at tau0 + dt (second-order Taylor).
struct Rot {
    double m[9];
};

template <class Sc>
__device__ __forceinline__ Rot rot_at(const Sc& sc, double dt) {
    const double dt2 = dt * dt;
    Rot r;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        r.m[k] = sc[S_ROT0 + k] + sc[S_ROT1 + k] * dt
                 + sc[S_ROT2H + k] * dt2;
    }
    return r;
}

__device__ __forceinline__ V3 apply(const Rot& r, V3 v) {
    return {r.m[0] * v.x + r.m[1] * v.y + r.m[2] * v.z,
            r.m[3] * v.x + r.m[4] * v.y + r.m[5] * v.z,
            r.m[6] * v.x + r.m[7] * v.y + r.m[8] * v.z};
}

__device__ __forceinline__ V3 apply_t(const Rot& r, V3 v) {
    return {r.m[0] * v.x + r.m[3] * v.y + r.m[6] * v.z,
            r.m[1] * v.x + r.m[4] * v.y + r.m[7] * v.z,
            r.m[2] * v.x + r.m[5] * v.y + r.m[8] * v.z};
}

// Inverse of the time derivative of the rotation at tau0 + dt, applied to v.
template <class Sc>
__device__ __forceinline__ V3 rot_dot_transpose_apply(const Sc& sc,
                                                      double dt, V3 v) {
    Rot r;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        r.m[k] = sc[S_ROT1 + k] + 2.0 * sc[S_ROT2H + k] * dt;
    }
    return apply_t(r, v);
}

// Smallest non-negative ray parameter of the ellipsoid intercept
// (core/geometry.py ray_ellipsoid_intercept): recentred discriminant.
template <class Sc>
__device__ __forceinline__ bool ray_ellipsoid(const Sc& sc, V3 origin,
                                              V3 dir, double* s_out) {
    const V3 rinv = sc3(sc, S_RINV);
    const V3 o = hadamard(origin, rinv);
    const V3 d = hadamard(dir, rinv);
    const double a_inv = 1.0 / dot(d, d);
    const double t_ca = -dot(o, d) * a_inv;
    const V3 q = o + d * t_ca;
    const double disc = -(dot(q, q) - 1.0) * a_inv;
    bool found = disc >= 0.0;
    const double sqrt_disc = sqrt(found ? disc : 0.0);
    const double s_near = t_ca - sqrt_disc;
    const double s = (s_near >= 0.0) ? s_near : t_ca + sqrt_disc;
    found = found && (s >= 0.0);
    *s_out = s;
    return found;
}

// Numerator and denominator of the graphic latitude atan2 of a point on
// (or near) the (re, f) spheroid: Bowring's form from the reduced latitude
// plus `iters` float64 refinement steps (0 is exact on the spheroid; 4 for
// triaxial bodies' off-spheroid surface points).
template <class Sc>
__device__ __forceinline__ double bowring_lat_deg(const Sc& sc, double rho,
                                                  double z, int iters) {
    const double omf = sc[S_OMF];
    const double w = rho * omf;
    const double rb = rsqrt(z * z + w * w);
    double sb = z * rb;
    double cb = w * rb;
    double num = z + sc[S_EP2_RE_OMF] * sb * sb * sb;
    double den = rho - sc[S_E2_RE] * cb * cb * cb;
    for (int i = 0; i < iters; ++i) {
        const double rr = rsqrt(num * num + den * den);
        const double sl = num * rr;
        const double cl = den * rr;
        const double rb2 = rsqrt(sc[S_OMF2] * sl * sl + cl * cl);
        sb = omf * sl * rb2;
        cb = cl * rb2;
        num = z + sc[S_EP2_RE_OMF] * sb * sb * sb;
        den = rho - sc[S_E2_RE] * cb * cb * cb;
    }
    return atan2_deg(num, den);
}

// Altitude above the (re, f) spheroid of an exterior point (ring plane):
// trig-free Bowring, geocentric start, two refinement steps; float64.
template <class Sc>
__device__ __forceinline__ double exterior_alt(const Sc& sc, double rho,
                                               double z) {
    const double omf = sc[S_OMF];
    const double w = rho * omf;
    const double rb = rsqrt(z * z + w * w);
    double sb = z * rb;
    double cb = w * rb;
    for (int i = 0; i < 2; ++i) {
        const double num = z + sc[S_EP2_RE_OMF] * sb * sb * sb;
        const double den = rho - sc[S_E2_RE] * cb * cb * cb;
        const double rr = rsqrt(num * num + den * den);
        const double sl = num * rr;
        const double cl = den * rr;
        const double rb2 = rsqrt(sc[S_OMF2] * sl * sl + cl * cl);
        sb = omf * sl * rb2;
        cb = cl * rb2;
    }
    const double num = z + sc[S_EP2_RE_OMF] * sb * sb * sb;
    const double den = rho - sc[S_E2_RE] * cb * cb * cb;
    const double rr = rsqrt(num * num + den * den);
    const double sl = num * rr;
    const double cl = den * rr;
    const double k = 1.0 - sc[S_E2] * sl * sl;
    const double n = sc[S_RE] * rsqrt(k);
    return rho * cl + z * sl - n * k;
}

// Body-fixed vector of an observer-frame point, retargeted in time about
// the sub-observer point (pipeline.py _obsvec2targvec_lin).
template <class Sc>
__device__ __forceinline__ V3 obsvec2targvec(const Sc& sc, V3 obsvec) {
    const V3 off = obsvec - sc3(sc, S_SP_OBSVEC);
    const double dist_offset =
        norm(off - sc3(sc, S_SP_RAYVEC)) - sc[S_SP_DIST];
    const double tau0 = sc[S_TAU0];
    const double dt = (tau0 - dist_offset * kInvClight) - tau0;
    return sc3(sc, S_SP_TARGVEC) + apply(rot_at(sc, dt), off);
}

// The block's ray tables: sin/cos of the column and row parts of the two
// ray angles, built by the first 80 threads of the block.
template <class Sc, class P, class Tab>
__device__ __forceinline__ void build_ray_tables(const Sc& sc, const P& p,
                                                 Tab& tab) {
    const int t = threadIdx.y * kBlockX + threadIdx.x;
    if (t < 2 * kBlockX) {
        const int c = t % kBlockX;
        const int k = t / kBlockX;  // 0: ra, 1: dec
        const double x = (double)(blockIdx.x * kBlockX + c);
        double sv, cv;
        sincospi((k ? sc[S_RAY + 3] : sc[S_RAY + 0]) * x, &sv, &cv);
        tab.col[2 * k][c] = sv;
        tab.col[2 * k + 1][c] = cv;
    } else if (t < 2 * kBlockX + 2 * kBlockY) {
        const int r = (t - 2 * kBlockX) % kBlockY;
        const int k = (t - 2 * kBlockX) / kBlockY;
        const double y = (double)(blockIdx.y * kBlockY + r) + p.row0;
        const double arg = k ? sc[S_RAY + 4] * y + sc[S_RAY + 5]
                             : sc[S_RAY + 1] * y + sc[S_RAY + 2];
        double sv, cv;
        sincospi(arg, &sv, &cv);
        tab.row[2 * k][r] = sv;
        tab.row[2 * k + 1][r] = cv;
    }
}

// A batched pixel's entries of the ray tables, in its own slot j: the
// same arguments and sincospi calls as build_ray_tables, so that each
// equals the single-frame kernel's.
template <class Sc>
__device__ __forceinline__ void pixel_tables(const Sc& sc,
                                             const BatchParams& p, int col,
                                             int row, int j,
                                             BatchTables& tab) {
    const double x = (double)col;
    const double y = (double)row + p.row0;
    double sv, cv;
    sincospi(sc[S_RAY + 0] * x, &sv, &cv);
    tab.col[0][j] = sv;
    tab.col[1][j] = cv;
    sincospi(sc[S_RAY + 3] * x, &sv, &cv);
    tab.col[2][j] = sv;
    tab.col[3][j] = cv;
    sincospi(sc[S_RAY + 1] * y + sc[S_RAY + 2], &sv, &cv);
    tab.row[0][j] = sv;
    tab.row[1][j] = cv;
    sincospi(sc[S_RAY + 4] * y + sc[S_RAY + 5], &sv, &cv);
    tab.row[2][j] = sv;
    tab.row[3][j] = cv;
}

// All requested planes of the pixel (col, row): the per-pixel algebra of
// both kernels, written once. `sc` is the frame's scene, `p` the launch's
// slot table and flags, (cx, ry) the pixel's slots in the ray tables;
// plane k of the pixel goes to out[k * plane_stride + pix],
// RADIAL-VELOCITY to rv_out[pix].
template <class Sc, class P, class Tab>
__device__ __forceinline__ void backplanes_pixel(
        const Sc& sc, const P& p, const Tab& tab, int cx, int ry, int col,
        int row, float* __restrict__ out, double* __restrict__ rv_out,
        size_t pix, size_t plane_stride) {
    auto store = [&](int plane, double v) {
        const int k = p.slot[plane];
        if (k < 0) return;
        if (plane == RADIAL_VELOCITY) {
            rv_out[pix] = v;
        } else {
            out[(size_t)k * plane_stride + pix] = (float)v;
        }
    };
    auto wanted = [&](int plane) { return p.slot[plane] >= 0; };

    const double nan = __longlong_as_double(0x7ff8000000000000ULL);
    const double lon_sign = (p.flags & F_POSITIVE_WEST) ? -1.0 : 1.0;
    const double xg = (double)col;
    const double yg = (double)row + p.row0;

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
        const double dx = xg - sc[S_DISC + 0];
        const double dy = yg - sc[S_DISC + 1];
        off = dx * dx + dy * dy > sc[S_DISC + 2];
    }
    double dist_surface = nan;  // ring occlusion (NaN: nothing hides it)
    bool found = false;
    if (need_chain && !off) {
        const V3 d = ray_j2000(sc, tab, cx, ry);
        const V3 targ_rel0 = sc3(sc, S_TARG_REL0);
        const V3 targ_vel0 = sc3(sc, S_TARG_VEL0);
        const double target_lt = sc[S_TARGET_LT];
        double lt = target_lt;
        double s_hit = 0.0;
        V3 spoint = {0.0, 0.0, 0.0};
        for (int it = 0; it <= p.n_lt_iters; ++it) {
            const double dt = sc[S_ET_TAU0] - lt;
            const Rot r = rot_at(sc, dt);
            const V3 o_bf = -apply(r, targ_rel0 + targ_vel0 * dt);
            const V3 d_bf = apply(r, d);
            found = ray_ellipsoid(sc, o_bf, d_bf, &s_hit);
            spoint = o_bf + d_bf * s_hit;
            lt = found ? s_hit * kInvClight : target_lt;
        }
        const double dt = sc[S_ET_TAU0] - lt;

        if (found) {
            dist_surface = lt * kClight;
            // -- lon/lat ------------------------------------------------
            const double lon_e = atan2(spoint.y, spoint.x);
            const double rho = sqrt(spoint.x * spoint.x + spoint.y * spoint.y);
            store(LON_GRAPHIC, wrap360(lon_sign * lon_e * kDegPerRad));
            if (wanted(LAT_GRAPHIC)) {
                store(LAT_GRAPHIC,
                      bowring_lat_deg(sc, rho, spoint.z, p.geodetic_iters));
            }
            store(LON_CENTRIC, wrap360(lon_e * kDegPerRad));
            store(LAT_CENTRIC, atan2_deg(spoint.z, rho));

            // -- local solar time -----------------------------------------
            if (wanted(LOCAL_SOLAR_TIME)) {
                // lon_e and the solar longitude lie in [-pi, pi]: the
                // argument lies in [-12, 36] and wraps with one add
                const double spin_sign = (p.flags & F_PROGRADE) ? 1.0 : -1.0;
                double lst = 12.0 + spin_sign * (lon_e - sc[S_SOLAR_LON])
                                        * kHoursPerRad;
                lst = lst < 0.0 ? lst + 24.0 : (lst >= 24.0 ? lst - 24.0 : lst);
                if (p.flags & F_LST_QUANT) {
                    lst = floor(lst * 3600.0) * kInvLstBin;
                }
                store(LOCAL_SOLAR_TIME, lst);
            }

            // -- illumination vectors (one rotation at the final epoch) ---
            const Rot r = rot_at(sc, dt);
            const V3 point_j = apply_t(r, spoint);
            const V3 drift = targ_vel0 * dt;
            const V3 srfvec_j2000 = (targ_rel0 + drift) + point_j;
            const V3 to_obs = -apply(r, srfvec_j2000);
            V3 sun_bf = {nan, nan, nan};
            if (p.flags & F_HAVE_SUN) {
                // sun_pos - point_ssb, about the target centre at tau0
                const V3 to_sun0 = sc3(sc, S_SUN_REL0) - (drift + point_j);
                const double lt_s = norm(to_sun0) * kInvClight;
                const double sun_dt = (sc[S_SUN_OFF] - lt) - lt_s;
                sun_bf = apply(r, to_sun0 + sc3(sc, S_SUN_VEL0) * sun_dt);
            }

            // -- state ----------------------------------------------------
            store(DISTANCE, dist_surface);
            if (wanted(RADIAL_VELOCITY) || wanted(DOPPLER)) {
                const V3 p_vel =
                    targ_vel0 + rot_dot_transpose_apply(sc, dt, spoint);
                const V3 rhat =
                    srfvec_j2000 * rsqrt(dot(srfvec_j2000, srfvec_j2000));
                const V3 obs_vel = sc3(sc, S_OBS_VEL);
                const double rv_t = dot(rhat, p_vel);
                const double rv_o = dot(rhat, obs_vel);
                const double dltdt = (rv_t - rv_o) / (kClight + rv_t);
                const double rv = dot(rhat, p_vel * (1.0 - dltdt) - obs_vel);
                store(RADIAL_VELOCITY, rv);
                const double beta = rv * kInvClight;
                store(DOPPLER, sqrt((1.0 + beta) / (1.0 - beta)));
            }

            // -- illumination angles --------------------------------------
            const V3 normal_raw = hadamard(spoint, sc3(sc, S_RINV2));
            const V3 normal =
                normal_raw * rsqrt(dot(normal_raw, normal_raw));
            store(PHASE, angle_deg(sun_bf, to_obs));
            store(INCIDENCE, angle_deg(normal, sun_bf));
            store(EMISSION, angle_deg(normal, to_obs));
            if (wanted(AZIMUTH)) {
                // dihedral between the tangent-plane projections of the
                // sun and observer directions (well conditioned at the
                // sub-solar and sub-observer caps)
                const V3 a = sun_bf - normal * dot(normal, sun_bf);
                const V3 b = to_obs - normal * dot(normal, to_obs);
                store(AZIMUTH, 180.0 - angle_deg(a, b));
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
    // the ray again, from the tables: the barrier keeps the compiler from
    // merging these reads with the chain's and holding the ray through it
    asm volatile("" ::: "memory");
    const V3 d = ray_j2000(sc, tab, cx, ry);
    const double d_norm2 = dot(d, d);
    const double rho_d = sqrt(d.x * d.x + d.y * d.y);
    store(RA, wrap360(atan2_deg(d.y, d.x)));
    store(DEC, atan2_deg(d.z, rho_d));
    store(PIXEL_X, xg);
    store(PIXEL_Y, yg);
    store(KM_X, sc[S_KM + 0] * xg + sc[S_KM + 1] * yg + sc[S_KM + 2]);
    store(KM_Y, sc[S_KM + 3] * xg + sc[S_KM + 4] * yg + sc[S_KM + 5]);
    store(ANGULAR_X,
          sc[S_ANGULAR + 0] * xg + sc[S_ANGULAR + 1] * yg
              + sc[S_ANGULAR + 2]);
    store(ANGULAR_Y,
          sc[S_ANGULAR + 3] * xg + sc[S_ANGULAR + 4] * yg
              + sc[S_ANGULAR + 5]);

    // ---- limb: nearest point of the ray to the target centre ----------
    if (wanted(LIMB_DISTANCE) || wanted(LIMB_LON_GRAPHIC)
        || wanted(LIMB_LAT_GRAPHIC)) {
        const V3 target_obsvec = sc3(sc, S_TARGET_OBSVEC);
        const V3 dn = d * rsqrt(d_norm2);
        const V3 near = dn * dot(target_obsvec, dn);
        const double near_dist = norm(near - target_obsvec);
        const V3 near_targvec = obsvec2targvec(sc, near);
        const V3 scaled = hadamard(near_targvec, sc3(sc, S_RINV));
        const V3 limb = near_targvec * rsqrt(dot(scaled, scaled));
        store(LIMB_LON_GRAPHIC, wrap360(lon_sign * atan2_deg(limb.y, limb.x)));
        if (wanted(LIMB_LAT_GRAPHIC)) {
            store(LIMB_LAT_GRAPHIC,
                  bowring_lat_deg(sc, sqrt(limb.x * limb.x + limb.y * limb.y),
                                  limb.z, p.geodetic_iters));
        }
        store(LIMB_DISTANCE, near_dist - norm(limb));
    }

    // ---- ring plane ----------------------------------------------------
    if (wanted(RING_RADIUS) || wanted(RING_LON_GRAPHIC)
        || wanted(RING_DISTANCE)) {
        const V3 ring_n = sc3(sc, S_RING_N);
        const double ring_c = sc[S_RING_C];
        const double denom = dot(d, ring_n);
        const bool degenerate = fabs(denom) <= 1e-12 * sqrt(d_norm2);
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
            const V3 rt = obsvec2targvec(sc, intercept);
            store(RING_RADIUS,
                  exterior_alt(sc, sqrt(rt.x * rt.x + rt.y * rt.y), rt.z)
                      + sc[S_RE]);
            store(RING_LON_GRAPHIC, wrap360(lon_sign * atan2_deg(rt.y, rt.x)));
            store(RING_DISTANCE, ring_distance);
        }
    }
}

// The single-frame scene: the kernel's parameters, read as constant-bank
// operands.
struct ParamScene {
    const Params& p;
    __device__ __forceinline__ double operator[](int i) const {
        return p.s[i];
    }
};

// A batched frame's scene, read from device memory through the read-only
// data cache (every thread of a block reads the same address: one
// broadcast load per warp).
struct GlobalScene {
    const double* s;
    __device__ __forceinline__ double operator[](int i) const {
        return __ldg(s + i);
    }
};

// kFrameOfBatch: the frame is one of a batch's (backplanes26_launch_frames)
// and its planes lie Params::plane_stride apart; otherwise nx * ny apart,
// computed in the kernel (reading the stride from the parameters instead
// costs the main path's frame 1.2-2%: scripts/time_backplane_batch.py).
template <bool kFrameOfBatch>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocksPerSM)
backplanes26_kernel(float* __restrict__ out, double* __restrict__ rv_out,
                    const __grid_constant__ Params p) {
    __shared__ FrameTables tab;
    const ParamScene sc{p};
    build_ray_tables(sc, p, tab);
    __syncthreads();
    const int col = blockIdx.x * kBlockX + threadIdx.x;
    const int row = blockIdx.y * kBlockY + threadIdx.y;
    if (col >= p.nx || row >= p.ny) return;
    backplanes_pixel(sc, p, tab, threadIdx.x, threadIdx.y, col, row, out,
                     rv_out, (size_t)row * (size_t)p.nx + (size_t)col,
                     kFrameOfBatch ? (size_t)p.plane_stride
                                   : (size_t)p.nx * (size_t)p.ny);
}

// The scenes of a tiled launch's frames, in its parameters: with the
// rest of them, within the 32,764 bytes a launch's parameters may hold.
struct SceneBlock {
    double s[kBlockScenes][SCENE_SIZE];
};

// A tiled launch's frame's scene, read from the kernel's parameters (the
// frame index is the block's, so every thread of a warp reads one
// constant-bank address).
struct BlockScene {
    const SceneBlock& b;
    int f;
    __device__ __forceinline__ double operator[](int i) const {
        return b.s[f][i];
    }
};

// N frames of one shape: plane k of frame f is out[k][f] of an (NP, N, ny,
// nx) float32 array, RADIAL-VELOCITY rv_out[f] of an (N, ny, nx) float64
// one. Linear blocks: frame f's scene is scenes[f * SCENE_SIZE ...] in
// device memory; block b of a launch takes frame first_frame + b /
// blocks_per_frame and its pixels [p0, p0 + blockDim.x), p0 = (b %
// blocks_per_frame) * blockDim.x, in row-major order (the frame's last
// block masked): every warp of a frame but its last is full, however
// narrow the frame, and each pixel computes its own ray trigonometry.
__global__ void __launch_bounds__(kBatchThreads, kMinBlocksPerSM)
backplanes26_batch_kernel(float* __restrict__ out, double* __restrict__ rv_out,
                          const double* __restrict__ scenes,
                          const __grid_constant__ BatchParams p) {
    __shared__ BatchTables tab;
    const int local = blockIdx.x / p.blocks_per_frame;
    const long long f = p.first_frame + local;
    const GlobalScene sc{scenes + f * SCENE_SIZE};
    const int p0 = (blockIdx.x - local * p.blocks_per_frame) * blockDim.x;
    const int p1 = min(p0 + (int)blockDim.x, p.frame_size);
    const int j = threadIdx.x;
    const int pix = p0 + j;
    if (pix >= p1) return;
    const int row = pix / p.nx;
    const int col = pix - row * p.nx;
    pixel_tables(sc, p, col, row, j, tab);
    backplanes_pixel(sc, p, tab, j, j, col, row, out, rv_out,
                     (size_t)f * (size_t)p.frame_size + (size_t)pix,
                     (size_t)p.plane_stride);
}

// Tiles: the single-frame kernel's 32x8 tiles and its ray tables over up
// to kBlockScenes frames, frame first_frame + blockIdx.z, its scene
// scenes.s[blockIdx.z] of the launch's parameters.
__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocksPerSM)
backplanes26_batch_tiles_kernel(float* __restrict__ out,
                                double* __restrict__ rv_out,
                                const __grid_constant__ SceneBlock scenes,
                                const __grid_constant__ BatchParams p) {
    __shared__ FrameTables tab;
    const long long f = p.first_frame + blockIdx.z;
    const BlockScene sc{scenes, (int)blockIdx.z};
    build_ray_tables(sc, p, tab);
    __syncthreads();
    const int col = blockIdx.x * kBlockX + threadIdx.x;
    const int row = blockIdx.y * kBlockY + threadIdx.y;
    if (col >= p.nx || row >= p.ny) return;
    backplanes_pixel(sc, p, tab, threadIdx.x, threadIdx.y, col, row, out,
                     rv_out,
                     (size_t)f * (size_t)p.frame_size
                         + (size_t)row * (size_t)p.nx + (size_t)col,
                     (size_t)p.plane_stride);
}

// The batched launches' parameters, false for a launch the kernels cannot
// take (`threads` 0: tiles).
bool batch_params(BatchParams* p, int nx, int ny, long long n_frames,
                  long long first, int count, int threads, double row0,
                  const int* slots, int n_lt_iters, int geodetic_iters,
                  int flags) {
    const long long frame_size = (long long)nx * (long long)ny;
    if (nx < 1 || ny < 1 || frame_size > 0x7fffffffLL || count < 1
        || first < 0 || first + count > n_frames
        || (threads && (threads < 32 || threads > kBatchThreads
                        || threads % 32 != 0))) {
        return false;
    }
    p->row0 = row0;
    p->plane_stride = (unsigned long long)frame_size
                      * (unsigned long long)n_frames;
    p->first_frame = first;
    p->nx = nx;
    p->ny = ny;
    p->frame_size = (int)frame_size;
    p->blocks_per_frame =
        threads ? (int)((frame_size + threads - 1) / threads) : 0;
    for (int k = 0; k < kPlanes; ++k) p->slot[k] = slots[k];
    p->n_lt_iters = n_lt_iters;
    p->geodetic_iters = geodetic_iters;
    p->flags = flags;
    return true;
}

static_assert(sizeof(SceneBlock) + sizeof(BatchParams) + 2 * sizeof(void*)
                  <= 32764,
              "a tiled launch's parameters exceed the launch's limit");

}  // namespace

extern "C" {

int backplanes26_scene_size(void) { return SCENE_SIZE; }

int backplanes26_n_planes(void) { return kPlanes; }

int backplanes26_batch_threads(void) { return kBatchThreads; }

int backplanes26_block_scenes(void) { return kBlockScenes; }

// Registers and local (spill) bytes per thread of the compiled kernel
// (batch 0: the single-frame kernel, 1: the batched one in linear blocks,
// 2: in tiles), and its resident blocks per SM at its block size. Returns
// a cudaError_t.
int backplanes26_occupancy(int batch, int* registers, int* local_bytes,
                           int* blocks_per_sm) {
    const void* kernel =
        batch == 1 ? (const void*)backplanes26_batch_kernel
        : batch == 2 ? (const void*)backplanes26_batch_tiles_kernel
                     : (const void*)backplanes26_kernel<false>;
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc != cudaSuccess) return (int)rc;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, batch == 1 ? kBatchThreads : kBlockX * kBlockY,
        0);
}

// Launch the kernel on `stream`. `scene` is a host array of SCENE_SIZE
// float64 values, copied into the kernel's parameters before this returns;
// `out` (n_float32_planes x ny x nx float32) and `rv_out` (ny x nx float64,
// read only when RADIAL-VELOCITY is requested) are device pointers; `slots`
// is a host array of 26 ints: each plane's index in `out`, -1 when not
// requested (RADIAL-VELOCITY: 0 when requested). Returns cudaGetLastError()
// after the launch.
int backplanes26_launch(const double* scene, float* out, double* rv_out,
                        int nx, int ny,
                        double row0, const int* slots, int n_lt_iters,
                        int geodetic_iters, int flags, void* stream) {
    Params p;
    memcpy(p.s, scene, sizeof(p.s));
    p.nx = nx;
    p.ny = ny;
    p.row0 = row0;
    p.plane_stride = (unsigned long long)nx * (unsigned long long)ny;
    for (int k = 0; k < kPlanes; ++k) p.slot[k] = slots[k];
    p.n_lt_iters = n_lt_iters;
    p.geodetic_iters = geodetic_iters;
    p.flags = flags;
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
    backplanes26_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        out, rv_out, p);
    return (int)cudaGetLastError();
}

// N frames of nx x ny as N launches of the single-frame kernel, each with
// its scene by value, into the batched layout (out: n_float32_planes x
// n_frames x ny x nx float32; rv_out: n_frames x ny x nx float64, or null).
// `scenes` is a host array of n_frames x SCENE_SIZE float64 values; the
// rest as for backplanes26_launch. For frames large enough that the
// batched kernel's table building and scene reads cost more than a
// launch. Returns the first non-zero cudaGetLastError(), or 0.
int backplanes26_launch_frames(const double* scenes, float* out,
                               double* rv_out, int nx, int ny, int n_frames,
                               double row0, const int* slots, int n_lt_iters,
                               int geodetic_iters, int flags, void* stream) {
    Params p;
    p.nx = nx;
    p.ny = ny;
    p.row0 = row0;
    const unsigned long long frame_size =
        (unsigned long long)nx * (unsigned long long)ny;
    p.plane_stride = frame_size * (unsigned long long)n_frames;
    for (int k = 0; k < kPlanes; ++k) p.slot[k] = slots[k];
    p.n_lt_iters = n_lt_iters;
    p.geodetic_iters = geodetic_iters;
    p.flags = flags;
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY);
    for (int f = 0; f < n_frames; ++f) {
        memcpy(p.s, scenes + (size_t)f * SCENE_SIZE, sizeof(p.s));
        backplanes26_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(
            out + f * frame_size,
            rv_out == nullptr ? nullptr : rv_out + f * frame_size, p);
        const cudaError_t rc = cudaGetLastError();
        if (rc != cudaSuccess) return (int)rc;
    }
    return 0;
}

// Launch the batched kernel in linear blocks of `threads` consecutive
// pixels (a multiple of 32, at most kBatchThreads) on `stream` over the
// frames [first, first + count) of a batch of n_frames frames of nx x ny,
// as the wrapper's launch plan gives them (ops/backplanes_kernel.py
// batch_plan). `scenes` is a device array of n_frames x SCENE_SIZE float64
// values; `out` (n_float32_planes x n_frames x ny x nx float32) and
// `rv_out` (n_frames x ny x nx float64, or null when RADIAL-VELOCITY is
// not requested) are device pointers; `slots`, `row0`, the iteration
// counts and the flags as for backplanes26_launch, shared by every frame.
// Returns cudaErrorInvalidValue for a launch the kernel cannot take, else
// cudaGetLastError() after the launch.
int backplanes26_launch_batch(const double* scenes, float* out, double* rv_out,
                              int nx, int ny, long long n_frames,
                              long long first, int count, int threads,
                              double row0, const int* slots, int n_lt_iters,
                              int geodetic_iters, int flags, void* stream) {
    BatchParams p;
    if (threads == 0
        || !batch_params(&p, nx, ny, n_frames, first, count, threads, row0,
                         slots, n_lt_iters, geodetic_iters, flags)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = (long long)count * p.blocks_per_frame;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    backplanes26_batch_kernel<<<(unsigned)blocks, threads, 0,
                                (cudaStream_t)stream>>>(out, rv_out, scenes,
                                                        p);
    return (int)cudaGetLastError();
}

// The same in 32x8 tiles, over at most kBlockScenes frames: `scenes` is a
// host array of n_frames x SCENE_SIZE float64 values, of which the
// launch's frames are copied into its parameters before this returns.
int backplanes26_launch_batch_tiles(const double* scenes, float* out,
                                    double* rv_out, int nx, int ny,
                                    long long n_frames, long long first,
                                    int count, double row0, const int* slots,
                                    int n_lt_iters, int geodetic_iters,
                                    int flags, void* stream) {
    BatchParams p;
    if (count > kBlockScenes
        || !batch_params(&p, nx, ny, n_frames, first, count, 0, row0, slots,
                         n_lt_iters, geodetic_iters, flags)) {
        return (int)cudaErrorInvalidValue;
    }
    SceneBlock block;
    memcpy(block.s, scenes + first * SCENE_SIZE,
           (size_t)count * SCENE_SIZE * sizeof(double));
    const dim3 grid((nx + kBlockX - 1) / kBlockX, (ny + kBlockY - 1) / kBlockY,
                    count);
    backplanes26_batch_tiles_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                                      (cudaStream_t)stream>>>(out, rv_out,
                                                              block, p);
    return (int)cudaGetLastError();
}

}  // extern "C"
