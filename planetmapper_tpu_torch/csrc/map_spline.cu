// Bivariate B-spline evaluation at map samples, with the 4-neighbour NaN
// rule of BodyXY.map_img ('linear', 'quadratic', 'cubic', degrees 4 and 5,
// and (ky, kx) tuples of them).
//
// Replaces two TPU kernels of planetmapper_tpu/ops/map_pallas.py:
// _pallas_eval_fn (:268, kernel :311, pallas_call :386), which keeps the
// whole coefficient grid of a source up to 640 px in VMEM, and
// _pallas_eval_windowed_fn (:628, kernel :664, pallas_call :716), which
// serves larger sources through one 128^2 or 256^2 coefficient window per
// 32x64 map tile. Both read basis values staged by XLA once per map and
// contract them with one-hot matmuls, because the TPU has small VMEM, no
// float64 and slow gathers. This card has none of those limits, so one
// kernel computes the same function directly for any source size. The
// plain version is map_spline_plain in
// planetmapper_tpu_torch/ops/map_spline_kernel.py.
//
// What bounds it on this card: per sample it must read 1 B of validity
// and, for the valid samples only (half of a 720x1440 map), 16 B of
// float64 x/y, and write 4 B per frame; of the coefficient grid (180 KB
// for a 150^2 source, 8 MB for 1024^2) only the entries the live samples
// weight (about those under the disc), each once. That is 13.6 MB for one
// 150^2 frame on a 720x1440 map (18.0 MB from 1024^2 with a NaN block),
// 4.05 us at 3.35 TB/s (5.37 us), against ~0.5-1.5 us of float64 work at
// the least count (testing/bounds.py:map_spline_bound): memory traffic
// bounds the function. The first design (one sample per thread, a binary
// search over the knots in global memory, de Boor-Cox with k(k+1)/2
// divisions per axis) was held instead by its instruction stream and its waves: ~150
// instructions per sample on the card's slow paths (64-bit conversions
// at a quarter of the FP64 rate, NaN-safe min/max, generic loads,
// branches), and each wave of blocks loaded, then computed, then
// gathered, with nothing overlapping. This design:
//
// - Uniform knots by arithmetic. The main path's knots (and those of the
//   host FITPACK solve at s=0) are the FITPACK s=0 knots of a pixel grid: k+1 clamped end knots, and interior knots
//   spaced exactly 1 (integers for odd k, half-integers for even k). The
//   wrapper describes them per axis (MapSplineAxis, from the host's numpy
//   copy of the knots, checked exactly there): t[j] == origin + j on the
//   interior, and the intervals [lo, hi] whose 2k supporting knots all
//   obey it. The interval of the unclamped coordinate is the nearest
//   integer of u - origin, read from the low word of u - origin + 1.5 *
//   2^52 (two adds, no conversion), lowered by one where the exact
//   compare u < origin + i says it rounded up: the search's #{t <= u} - 1,
//   knot values included. Inside [lo, hi] u lies inside the span, so the
//   clamp and the clip are skipped, and the k+1 basis values are the
//   cardinal B-spline polynomials of x = u - t[i] (exact), derived at
//   compile time from the de Boor-Cox recurrence in integers
//   (cardinal_polys): k multiply-adds per value, no division, no knot
//   load. The k intervals at each end of a grid and coordinates outside
//   it (only with propagate_nan off) take the plain version's path,
//   span_basis, with the few knots it reads from global memory (through
//   L1; a copy of the end knots in shared memory measured slower).
// - Other knots (FITPACK's adaptive knots of spline_smoothing > 0): each
//   block stages both knot vectors into shared memory when they fit in
//   40 KB (the wrapper decides), else reads them from global memory, and
//   runs span_basis: the binary search and de Boor-Cox.
// - kSamples = 2 adjacent map samples per thread: 16-byte double2 loads
//   of x and y, float2 stores when the sample count is even, the ragged
//   tail masked; a dead sample gathers the frame's first coefficients, so
//   no branch splits the gathers of the two samples.
// - A persistent grid (every block resident at once) walks the map in
//   strides, and each thread loads its next pair of samples before it
//   evaluates the current one: the x/y stream from memory overlaps the
//   arithmetic and the gathers. The first pair's loads are in flight
//   while the block stages its knots.
// - The NaN rule's floor/ceil neighbours come from the same shift, and
//   only when some frame's any-NaN flag is set (each block reduces the
//   flags once; the frame loop reads them through L1).
// - __launch_bounds__(256, MinBlocks) per instance, from ptxas's report:
//   the cap leaves room for every gather of both samples in flight with
//   no spills: 3 blocks per SM at 80 registers for <kx, ky> = <1, 1>, 2
//   at 128 for <3, 3> and <1, 3>, 1 above 16 coefficients (chip_smoke.py
//   prints registers, spills and resident blocks per SM).
// - kx and ky are template parameters, 1..5 each (25 instances).
//
// Measured on an H100 80GB HBM3 at 700 W (scripts/time_map_spline.py,
// 720x1440 map, this design and the first in turns): one launch after the
// L2 is flushed takes 14.6-15.1 us linear and 17.9-18.2 us cubic from a
// 150^2 source, 22.5-22.8 us cubic from 1024^2 with a NaN block (the
// first design 22.5-22.9, 33.5-33.8 and 41.5-41.9 us): 27%, 23% and 24%
// of the bound. One torch.sum over as many bytes as the call's buffers
// hold takes 18.1-18.6, 18.1-18.4 and 20.9-21.3 us: a single cold launch
// of ~20 MB does not reach the HBM rate the bound assumes. Back to back
// 8.5-8.6, 12.3-12.4 and 16.1-16.4 us. What is left above the linear time
// at cubic and at 1024^2 is the coefficient and NaN-grid gathers. The
// search path (other knots) stays 1.06-1.26x slower than the first
// design: its two samples' searches run one after the other at the
// occupancy sized for the arithmetic path.
//
// Arithmetic against the plain version: span_basis follows it step by
// step; the cardinal polynomials (their 1/k! folded into the
// coefficients) differ from its divided differences by a few float64
// ulps, far below the one float32 ulp at which the result is stored and
// compared.
//
// Built by planetmapper_tpu_torch/ops/map_spline_kernel.py (through
// ops/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

// One spline axis as the wrapper describes it (outside the anonymous
// namespace: the C interface takes it, and must keep external linkage).
struct MapSplineAxis {
    double origin;  // uniform: t[j] == origin + j on the interior knots
    int uniform;    // 1: intervals by arithmetic; 0: binary search
    int lo, hi;     // uniform: intervals with the cardinal basis
    int staged;     // 1: each block copies the knots into shared memory
};

namespace {

using Axis = MapSplineAxis;

constexpr int kThreads = 256;
constexpr int kSamples = 2;  // adjacent map samples per thread (even)
static_assert(kSamples % 2 == 0, "samples are loaded as double2 pairs");
// 1.5 * 2^52: v + kShift rounds v to an integer held in the low word
constexpr double kShift = 6755399441055744.0;
// coordinates beyond this take the span path (the shift needs |v| < 2^51)
constexpr double kMaxUniform = 1073741824.0;

struct Params {
    int64_t n_samples;  // S
    int n_frames;       // F
    int n_ty, n_tx;     // knot counts
    int ny, nx;         // source image (NaN grid) shape
    double y_hi, x_hi;  // ny - 1, nx - 1
    int propagate_nan;
    Axis ay, ax;
};

// Cardinal B-spline basis on a uniform interval: the k+1 basis values
// N_{i-k+j} as polynomials in x = u - t[i], times k!, from de Boor-Cox on
// unit-spaced knots, P_d[j] = (x + d - j) P_{d-1}[j-1] + (1 + j - x)
// P_{d-1}[j], in integers at compile time. c[j][m] is the coefficient of
// x^m of k! N_{i-k+j}.
struct CardinalPolys {
    long long c[6][6];
};

__host__ __device__ constexpr CardinalPolys cardinal_polys(int k) {
    CardinalPolys p{};
    p.c[0][0] = 1;
    for (int d = 1; d <= k; ++d) {
        CardinalPolys q{};
        for (int j = 0; j <= d; ++j) {
            for (int m = 0; m <= d; ++m) {
                long long v = 0;
                if (j >= 1) {
                    v += (d - j) * p.c[j - 1][m];
                    if (m >= 1) v += p.c[j - 1][m - 1];
                }
                if (j < d) {
                    v += (1 + j) * p.c[j][m];
                    if (m >= 1) v -= p.c[j][m - 1];
                }
                q.c[j][m] = v;
            }
        }
        p = q;
    }
    return p;
}

// Coefficient of x^m of N_{i-k+j}, with 1/k! folded in (rounded once).
__host__ __device__ constexpr double cardinal_coeff(int k, int j, int m) {
    long long f = 1;
    for (int q = 2; q <= k; ++q) f *= q;
    return (double)cardinal_polys(k).c[j][m] / (double)f;
}

template <int K, int J, int M>
__device__ __forceinline__ double cardinal_horner(double v) {
    constexpr double c = cardinal_coeff(K, J, M);
    if constexpr (M == K) {
        return c;
    } else {
        return fma(cardinal_horner<K, J, M + 1>(v), v, c);
    }
}

// n[j] for j >= k - j in x; the others as mirror images, N_{i-k+j}(x) =
// N_{i-j}(1 - x), so every value is evaluated in the variable in which it
// has no large cancellation (N_{i-k} = (1 - x)^k / k! comes from 1 - x).
template <int K, int J = 0>
__device__ __forceinline__ void cardinal_basis(double x, double w,
                                               double (&n)[K + 1]) {
    if constexpr (J >= K - J) {
        n[J] = cardinal_horner<K, J, 0>(x);
    } else {
        n[J] = cardinal_horner<K, K - J, 0>(w);
    }
    if constexpr (J < K) cardinal_basis<K, J + 1>(x, w, n);
}

// The interval i = #{origin + j <= u} - 1 of u among the knots origin + j
// (all j), and t_i = origin + i: the nearest integer of u - origin by the
// kShift addition (its low word is the integer; no conversion), lowered by
// one where the exact compare u < t_i says it rounded up.
__device__ __forceinline__ int uniform_interval(double u, double origin,
                                                double& t_i) {
    const double m = __dadd_rn(__dadd_rn(u, -origin), kShift);
    int i = __double2loint(m);
    t_i = __dadd_rn(origin, __dadd_rn(m, -kShift));
    if (u < t_i) {
        --i;
        t_i = __dadd_rn(t_i, -1.0);
    }
    return i;
}

// The knots a block reads: its shared-memory copy when `staged`, else
// global memory.
__device__ const double* stage_knots(const double* __restrict__ t, int n_t,
                                     int staged, double* s) {
    if (!staged) return t;
    for (int j = threadIdx.x; j < n_t; j += blockDim.x) s[j] = t[j];
    return s;
}

// de Boor-Cox with the plain version's denom == 0 -> 1 guard
// (map_pallas.py:178-192), on interval i.
template <int K>
__device__ __forceinline__ void de_boor(const double* t, int i, double u,
                                        double (&n)[K + 1]) {
    n[0] = 1.0;
#pragma unroll
    for (int d = 1; d <= K; ++d) {
        double term[K];
#pragma unroll
        for (int j = 0; j < d; ++j) {
            const double left = t[i + 1 - d + j];
            double denom = t[i + 1 + j] - left;
            if (denom == 0.0) denom = 1.0;
            term[j] = (u - left) / denom;
        }
        double prev[K + 1];
#pragma unroll
        for (int j = 0; j <= K; ++j) prev[j] = n[j];
        n[0] = prev[0] * (1.0 - term[0]);
#pragma unroll
        for (int j = 1; j < d; ++j) {
            n[j] = prev[j - 1] * term[j - 1] + prev[j] * (1.0 - term[j]);
        }
        n[d] = prev[d - 1] * term[d - 1];
    }
}

// The plain version's path: u clamped into the knot span, the interval
// clip(#{t <= u} - 1, k, n_c - 1) (by arithmetic on a uniform axis, else
// by binary search), de Boor-Cox. Returns the first coefficient's index.
template <int K>
__device__ __forceinline__ int span_basis(const double* t, int n_t,
                                          const Axis& a, double u,
                                          double (&n)[K + 1]) {
    const int n_c = n_t - K - 1;
    u = fmin(fmax(u, t[K]), t[n_t - K - 1]);
    int i;
    if (a.uniform) {
        double t_i;
        i = uniform_interval(u, a.origin, t_i);
    } else {
        int lo = 0, hi = n_t;  // lo = #{t <= u}
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (t[mid] <= u) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        i = lo - 1;
    }
    i = min(max(i, K), n_c - 1);
    de_boor<K>(t, i, u, n);
    return i - K;
}

// Non-zero basis values n[0..K] at u and the index of the first
// coefficient they weight. On a uniform interval [lo, hi] u lies inside
// the span, so the clamp and the clip are no-ops and are skipped.
template <int K>
__device__ __forceinline__ int axis_basis(const double* t, int n_t,
                                          const Axis& a, double u,
                                          double (&n)[K + 1]) {
    if (a.uniform && fabs(u) < kMaxUniform) {
        double t_i;
        const int i = uniform_interval(u, a.origin, t_i);
        if (i >= a.lo && i <= a.hi) {
            const double x = __dadd_rn(u, -t_i);  // exact
            cardinal_basis<K>(x, __dadd_rn(1.0, -x), n);
            return i - K;
        }
    }
    return span_basis<K>(t, n_t, a, u, n);
}

// kSamples adjacent map samples: coordinates and validity.
struct Batch {
    double x[kSamples], y[kSamples];
    bool valid[kSamples];
};

__device__ __forceinline__ void load_batch(Batch& b,
                                           const double* __restrict__ xs,
                                           const double* __restrict__ ys,
                                           const uint8_t* __restrict__ valid,
                                           int64_t s0, int64_t S) {
    if (s0 + kSamples <= S) {
#pragma unroll
        for (int v = 0; v < kSamples; v += 2) {
            const double2 xv = *reinterpret_cast<const double2*>(xs + s0 + v);
            const double2 yv = *reinterpret_cast<const double2*>(ys + s0 + v);
            b.x[v] = xv.x;
            b.x[v + 1] = xv.y;
            b.y[v] = yv.x;
            b.y[v + 1] = yv.y;
        }
#pragma unroll
        for (int v = 0; v < kSamples; ++v) b.valid[v] = valid[s0 + v] != 0;
    } else {
#pragma unroll
        for (int v = 0; v < kSamples; ++v) {
            const bool in = s0 + v < S;
            b.x[v] = in ? xs[s0 + v] : 0.0;
            b.y[v] = in ? ys[s0 + v] : 0.0;
            b.valid[v] = in && valid[s0 + v] != 0;
        }
    }
}

// Per-sample state between the basis and the frames.
template <int KX, int KY>
struct Sample {
    double bx[KX + 1], by[KY + 1];
    int base;     // offset of the first coefficient in a frame (< 2^31)
    int nan0;     // NaN-grid offset of the floor/floor neighbour (< 2^31)
    bool dx, dy;  // the ceil neighbours are one column / one row further
    bool live;
};

// One frame's values of every sample of the thread; with CHECK_NAN the
// 4-neighbour reads of the NaN grid are issued beside the gathers.
template <int KX, int KY, bool CHECK_NAN>
__device__ __forceinline__ void frame_values(
    const Sample<KX, KY> (&smp)[kSamples], const double* __restrict__ c,
    const uint8_t* __restrict__ g, int n_cx, int nx,
    float (&out)[kSamples]) {
    const float qnan = __int_as_float(0x7fc00000);
    double val[kSamples];
    bool nan_hit[kSamples];
#pragma unroll
    for (int v = 0; v < kSamples; ++v) {
        const double* cv = c + smp[v].base;
        double acc = 0.0;
#pragma unroll
        for (int a = 0; a <= KY; ++a) {
            double row = 0.0;
#pragma unroll
            for (int b = 0; b <= KX; ++b) {
                row += smp[v].bx[b] * cv[a * n_cx + b];
            }
            acc += smp[v].by[a] * row;
        }
        val[v] = acc;
        nan_hit[v] = false;
        if (CHECK_NAN) {
            const uint8_t* g0 = g + smp[v].nan0;
            const uint8_t* g1 = g0 + (smp[v].dy ? nx : 0);
            const int dx = smp[v].dx ? 1 : 0;
            nan_hit[v] = (g0[0] | g0[dx] | g1[0] | g1[dx]) != 0;
        }
    }
#pragma unroll
    for (int v = 0; v < kSamples; ++v) {
        out[v] = (!smp[v].live || nan_hit[v]) ? qnan : (float)val[v];
    }
}

// Every frame's values of one batch, stored at out + s0.
template <int KX, int KY>
__device__ __forceinline__ void spline_batch(
    const Batch& b, int64_t s0, const Params& p, const double* vty,
    const double* vtx, bool check_nan, const uint8_t* __restrict__ any_nan,
    const double* __restrict__ coeffs, const uint8_t* __restrict__ nan_grid,
    float* __restrict__ out) {
    const int64_t S = p.n_samples;
    const bool full = s0 + kSamples <= S;
    const float qnan = __int_as_float(0x7fc00000);
    const int n_cx = p.n_tx - KX - 1;
    Sample<KX, KY> smp[kSamples];
    bool any_live = false;
#pragma unroll
    for (int v = 0; v < kSamples; ++v) {
        Sample<KX, KY>& s = smp[v];
        const double x = b.x[v], y = b.y[v];
        s.live = b.valid[v];
        if (p.propagate_nan) {
            s.live = s.live && x >= 0.0 && y >= 0.0 && x <= p.x_hi &&
                     y <= p.y_hi;
        }
        any_live = any_live || s.live;
        s.base = s.nan0 = 0;
        s.dx = s.dy = false;
#pragma unroll
        for (int j = 0; j <= KX; ++j) s.bx[j] = 0.0;
#pragma unroll
        for (int j = 0; j <= KY; ++j) s.by[j] = 0.0;
        if (s.live) {
            if (check_nan) {
                // a live sample lies inside the grid: floor and ceil need
                // no clip
                double fx, fy;
                const int x0 = uniform_interval(x, 0.0, fx);
                const int y0 = uniform_interval(y, 0.0, fy);
                s.nan0 = y0 * p.nx + x0;
                s.dx = x != fx;
                s.dy = y != fy;
            }
            const int iy0 = axis_basis<KY>(vty, p.n_ty, p.ay, y, s.by);
            const int ix0 = axis_basis<KX>(vtx, p.n_tx, p.ax, x, s.bx);
            s.base = iy0 * n_cx + ix0;
        }
    }

    float* o = out + s0;
    const bool pair_store = full && (S % 2 == 0);
    const int64_t grid = (int64_t)(p.n_ty - KY - 1) * n_cx;
    const int64_t image = (int64_t)p.ny * p.nx;
    const double* c = coeffs;
    const uint8_t* g = nan_grid;
    for (int f = 0; f < p.n_frames; ++f, c += grid, g += image, o += S) {
        float val[kSamples];
        if (!any_live) {
#pragma unroll
            for (int v = 0; v < kSamples; ++v) val[v] = qnan;
        } else if (check_nan && any_nan[f]) {
            frame_values<KX, KY, true>(smp, c, g, n_cx, p.nx, val);
        } else {
            frame_values<KX, KY, false>(smp, c, g, n_cx, p.nx, val);
        }
        if (pair_store) {
#pragma unroll
            for (int v = 0; v < kSamples; v += 2) {
                *reinterpret_cast<float2*>(o + v) =
                    make_float2(val[v], val[v + 1]);
            }
        } else {
#pragma unroll
            for (int v = 0; v < kSamples; ++v) {
                if (s0 + v < S) o[v] = val[v];
            }
        }
    }
}

template <int KX, int KY>
struct MinBlocks {
    // resident blocks of 256 threads asked of ptxas: the register cap
    // (65536 / 256 / blocks per thread) still holds both samples' gathers
    // with no spills (4 blocks spill at (1, 1), 3 at (2, 1))
    static constexpr int coeffs = (KX + 1) * (KY + 1);
    static constexpr int value = coeffs <= 4 ? 3 : coeffs <= 16 ? 2 : 1;
};

// A persistent grid (as many blocks as fit on the card, see
// map_spline_launch) walks the samples in strides; each thread loads its
// next batch before it evaluates the current one, so the stream of x, y
// and valid from memory overlaps the arithmetic and the gathers.
template <int KX, int KY>
__global__ void __launch_bounds__(kThreads, (MinBlocks<KX, KY>::value))
map_spline_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                  const uint8_t* __restrict__ valid,
                  const double* __restrict__ ty, const double* __restrict__ tx,
                  const double* __restrict__ coeffs,
                  const uint8_t* __restrict__ nan_grid,
                  const uint8_t* __restrict__ any_nan,
                  float* __restrict__ out, Params p) {
    extern __shared__ double smem[];
    const int64_t S = p.n_samples;
    const int64_t stride = (int64_t)gridDim.x * kThreads * kSamples;
    int64_t s0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kSamples;
    Batch cur;
    load_batch(cur, xs, ys, valid, s0, S);  // in flight during the staging

    const double* vty = stage_knots(ty, p.n_ty, p.ay.staged, smem);
    const int sy = p.ay.staged ? p.n_ty : 0;
    const double* vtx = stage_knots(tx, p.n_tx, p.ax.staged, smem + sy);
    int nan_frames = 0;
    for (int f = threadIdx.x; f < p.n_frames; f += blockDim.x) {
        nan_frames |= any_nan[f];
    }
    // also the barrier after the knots' staging
    const bool check_nan =
        __syncthreads_or(nan_frames) != 0 && p.propagate_nan != 0;

    for (; s0 < S; s0 += stride) {
        Batch next;
        load_batch(next, xs, ys, valid, s0 + stride, S);
        spline_batch<KX, KY>(cur, s0, p, vty, vtx, check_nan, any_nan, coeffs,
                             nan_grid, out);
        cur = next;
    }
}

using Kernel = void (*)(const double*, const double*, const uint8_t*,
                        const double*, const double*, const double*,
                        const uint8_t*, const uint8_t*, float*, Params);

template <int KX>
Kernel pick_ky(int ky) {
    switch (ky) {
        case 1: return map_spline_kernel<KX, 1>;
        case 2: return map_spline_kernel<KX, 2>;
        case 3: return map_spline_kernel<KX, 3>;
        case 4: return map_spline_kernel<KX, 4>;
        case 5: return map_spline_kernel<KX, 5>;
        default: return nullptr;
    }
}

Kernel pick(int kx, int ky) {
    switch (kx) {
        case 1: return pick_ky<1>(ky);
        case 2: return pick_ky<2>(ky);
        case 3: return pick_ky<3>(ky);
        case 4: return pick_ky<4>(ky);
        case 5: return pick_ky<5>(ky);
        default: return nullptr;
    }
}

size_t shared_bytes(const Params& p) {
    const size_t knots = (p.ay.staged ? p.n_ty : 0) +
                         (p.ax.staged ? p.n_tx : 0);
    return knots * sizeof(double);
}

}  // namespace

extern "C" {

// Registers and local (spill) bytes per thread of the <kx, ky> instance,
// and its resident blocks per SM at `smem_bytes` of dynamic shared memory.
// Returns a cudaError_t.
int map_spline_occupancy(int kx, int ky, int smem_bytes, int* registers,
                         int* local_bytes, int* blocks_per_sm) {
    const Kernel kernel = pick(kx, ky);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc != cudaSuccess) return (int)rc;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, kThreads, (size_t)smem_bytes);
}

// Launch on `stream`. Every pointer except the two axis descriptors is a
// device pointer: x, y (S float64, 0 where not valid; 16-byte aligned),
// valid (S uint8), ty (n_ty) and tx (n_tx) float64 knots, coeffs (F, n_cy,
// n_cx) float64, nan_grid (F, ny, nx) uint8, any_nan (F) uint8, out (F, S)
// float32 (8-byte aligned); n_cy * n_cx and ny * nx below 2^31. `ay`,
// `ax` are host structs describing the knots (MapSplineAxis). The grid is
// as many blocks as are resident on the current device at once (or fewer
// when the samples need fewer). Returns cudaErrorInvalidValue for a degree
// outside 1..5 or more than 48 KB of shared memory, else the first CUDA
// error of the occupancy queries and the launch.
int map_spline_launch(const double* x, const double* y, const uint8_t* valid,
                      const double* ty, int n_ty, const double* tx, int n_tx,
                      int kx, int ky, const double* coeffs,
                      const uint8_t* nan_grid, const uint8_t* any_nan,
                      int ny, int nx, int propagate_nan, float* out,
                      long long n_samples, int n_frames,
                      const MapSplineAxis* ay, const MapSplineAxis* ax,
                      void* stream) {
    const Kernel kernel = pick(kx, ky);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    Params p;
    p.n_samples = n_samples;
    p.n_frames = n_frames;
    p.n_ty = n_ty;
    p.n_tx = n_tx;
    p.ny = ny;
    p.nx = nx;
    p.y_hi = (double)(ny - 1);
    p.x_hi = (double)(nx - 1);
    p.propagate_nan = propagate_nan;
    p.ay = *ay;
    p.ax = *ax;
    const size_t smem = shared_bytes(p);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    // a persistent grid: every block resident at once, none idle
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc == cudaSuccess) {
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    }
    if (rc == cudaSuccess) {
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, smem);
    }
    if (rc != cudaSuccess) return (int)rc;
    const long long threads = (n_samples + kSamples - 1) / kSamples;
    const long long needed = (threads + kThreads - 1) / kThreads;
    const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    const unsigned grid = (unsigned)(needed < resident ? needed : resident);
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        x, y, valid, ty, tx, coeffs, nan_grid, any_nan, out, p);
    return (int)cudaGetLastError();
}

}  // extern "C"
