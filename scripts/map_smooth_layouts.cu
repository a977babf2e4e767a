// Layouts of the map smooth kernel, for the layout study of
// scripts/time_map_smooth_variants.py; not on any path of the package.
//
// The function is that of planetmapper_tpu_torch/csrc/map_smooth.cu (see
// its note: a bilinear sample of the PCHIP-oversampled grids with the
// NaN-corner and 4-neighbour NaN rules, every frame in one launch), with
// its layout fixed at compile time by four macros: samples a thread
// (MAP_SMOOTH_SAMPLES, 1 or 2), frames whose corners are in flight at once
// (MAP_SMOOTH_FRAMES), a persistent grid of the resident blocks that
// prefetches its next batch (MAP_SMOOTH_PERSISTENT) and the resident
// blocks asked of ptxas (MAP_SMOOTH_MIN_BLOCKS). csrc/map_smooth.cu
// hard-codes the layout the study kept: 2 samples, 1 frame, not
// persistent, 4 blocks. Its C interface is the package kernel's.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// The layout, fixed at compile time; the defaults are the kept one.
#ifndef MAP_SMOOTH_SAMPLES
#define MAP_SMOOTH_SAMPLES 2
#endif
#ifndef MAP_SMOOTH_FRAMES
#define MAP_SMOOTH_FRAMES 1
#endif
#ifndef MAP_SMOOTH_PERSISTENT
#define MAP_SMOOTH_PERSISTENT 0
#endif
#ifndef MAP_SMOOTH_MIN_BLOCKS
#define MAP_SMOOTH_MIN_BLOCKS 4
#endif

constexpr int kThreads = 256;
constexpr int kSamples = MAP_SMOOTH_SAMPLES;  // adjacent samples a thread
constexpr int kFrames = MAP_SMOOTH_FRAMES;    // frames in flight at once
constexpr bool kPersistent = MAP_SMOOTH_PERSISTENT != 0;
constexpr int kMinBlocks = MAP_SMOOTH_MIN_BLOCKS;  // resident, asked of ptxas
static_assert(kSamples == 1 || kSamples == 2, "1 or 2 samples a thread");

struct Params {
    int64_t n_samples;  // S
    int n_frames;       // F
    int n_ys, n_xs;     // oversampled grid shape
    int ny, nx;         // original image shape
    double iy0, ix0;    // box origin in image pixels
    double y_step, x_step;
    int propagate_nan;
};

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
    if (kSamples == 2 && s0 + kSamples <= S) {
        const double2 xv = *reinterpret_cast<const double2*>(xs + s0);
        const double2 yv = *reinterpret_cast<const double2*>(ys + s0);
        b.x[0] = xv.x;
        b.x[kSamples - 1] = xv.y;
        b.y[0] = yv.x;
        b.y[kSamples - 1] = yv.y;
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

// Per-sample state shared by every frame.
struct Sample {
    double fx, fy;  // fractions inside the grid cell
    int corner;     // offset of the floor/floor corner in a grid (< 2^31)
    int nan0;       // image offset of the floor/floor neighbour (< 2^31)
    bool dx, dy;    // the ceil neighbours are one column / one row further
    bool live;
};

__device__ __forceinline__ Sample setup(double x, double y, bool valid,
                                        const Params& p) {
    Sample s;
    const double yb = (y - p.iy0) / p.y_step;
    const double xb = (x - p.ix0) / p.x_step;
    s.live = valid && yb >= 0.0 && yb <= (double)(p.n_ys - 1) &&
             xb >= 0.0 && xb <= (double)(p.n_xs - 1);
    if (p.propagate_nan) {
        s.live = s.live && x >= 0.0 && y >= 0.0 &&
                 x <= (double)(p.nx - 1) && y <= (double)(p.ny - 1);
    }
    const double iy = fmin(fmax(floor(yb), 0.0), (double)(p.n_ys - 2));
    const double ix = fmin(fmax(floor(xb), 0.0), (double)(p.n_xs - 2));
    s.fy = yb - iy;
    s.fx = xb - ix;
    s.corner = s.live ? (int)iy * p.n_xs + (int)ix : 0;
    // a live sample lies inside the image: floor and ceil need no clip
    const double x0 = floor(x), y0 = floor(y);
    s.nan0 = s.live ? (int)y0 * p.nx + (int)x0 : 0;
    s.dx = x != x0;
    s.dy = y != y0;
    return s;
}

__device__ __forceinline__ float bilinear(const Sample& s, double g00,
                                          double g01, double g10,
                                          double g11) {
    const double val = (1.0 - s.fx) * ((1.0 - s.fy) * g00 + s.fy * g10) +
                       s.fx * ((1.0 - s.fy) * g01 + s.fy * g11);
    // any NaN corner, whatever its weight
    return isnan(val) ? __int_as_float(0x7fc00000) : (float)val;
}

// Every frame's values of one batch, stored at out + s0.
__device__ __forceinline__ void smooth_batch(
    const Batch& b, int64_t s0, const Params& p, bool check_nan,
    const uint8_t* __restrict__ any_nan, const double* __restrict__ grid,
    const uint8_t* __restrict__ nan_img, float* __restrict__ out) {
    const int64_t S = p.n_samples;
    const float qnan = __int_as_float(0x7fc00000);
    Sample smp[kSamples];
    bool any_live = false;
#pragma unroll
    for (int v = 0; v < kSamples; ++v) {
        smp[v] = setup(b.x[v], b.y[v], b.valid[v], p);
        any_live = any_live || smp[v].live;
    }
    const bool pair_store = kSamples == 2 && s0 + kSamples <= S && S % 2 == 0;
    const int64_t plane = (int64_t)p.n_ys * p.n_xs;
    const int64_t image = (int64_t)p.ny * p.nx;
    const int n_xs = p.n_xs;
    for (int f0 = 0; f0 < p.n_frames; f0 += kFrames) {
        double g[kFrames][kSamples][4];
        bool hit[kFrames][kSamples];
#pragma unroll
        for (int j = 0; j < kFrames; ++j) {
            const int f = f0 + j < p.n_frames ? f0 + j : f0;
            const double* c = grid + f * plane;
            const uint8_t* m = nan_img + f * image;
            const bool check = check_nan && any_nan[f];
#pragma unroll
            for (int v = 0; v < kSamples; ++v) {
                const double* cv = c + smp[v].corner;
                g[j][v][0] = any_live ? cv[0] : 0.0;
                g[j][v][1] = any_live ? cv[1] : 0.0;
                g[j][v][2] = any_live ? cv[n_xs] : 0.0;
                g[j][v][3] = any_live ? cv[n_xs + 1] : 0.0;
                hit[j][v] = false;
                if (check && smp[v].live) {
                    const uint8_t* m0 = m + smp[v].nan0;
                    const uint8_t* m1 = m0 + (smp[v].dy ? p.nx : 0);
                    const int dx = smp[v].dx ? 1 : 0;
                    hit[j][v] = (m0[0] | m0[dx] | m1[0] | m1[dx]) != 0;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kFrames; ++j) {
            if (f0 + j >= p.n_frames) break;
            float val[kSamples];
#pragma unroll
            for (int v = 0; v < kSamples; ++v) {
                val[v] = (!smp[v].live || hit[j][v])
                             ? qnan
                             : bilinear(smp[v], g[j][v][0], g[j][v][1],
                                        g[j][v][2], g[j][v][3]);
            }
            float* o = out + (int64_t)(f0 + j) * S + s0;
            if (pair_store) {
                *reinterpret_cast<float2*>(o) =
                    make_float2(val[0], val[kSamples - 1]);
            } else {
#pragma unroll
                for (int v = 0; v < kSamples; ++v) {
                    if (s0 + v < S) o[v] = val[v];
                }
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
map_smooth_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                  const uint8_t* __restrict__ valid,
                  const double* __restrict__ grid,
                  const uint8_t* __restrict__ nan_img,
                  const uint8_t* __restrict__ any_nan,
                  float* __restrict__ out, Params p) {
    const int64_t S = p.n_samples;
    const int64_t stride = (int64_t)gridDim.x * kThreads * kSamples;
    int64_t s0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kSamples;
    const bool check_nan = p.propagate_nan != 0;
    Batch cur;
    load_batch(cur, xs, ys, valid, s0, S);
    for (; s0 < S; s0 += stride) {
        Batch next;
        if (kPersistent) load_batch(next, xs, ys, valid, s0 + stride, S);
        smooth_batch(cur, s0, p, check_nan, any_nan, grid, nan_img, out);
        cur = next;
    }
}

}  // namespace

extern "C" {

// Registers and local (spill) bytes per thread, and resident blocks of
// kThreads per SM. Returns a cudaError_t.
int map_smooth_occupancy(int* registers, int* local_bytes,
                         int* blocks_per_sm) {
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, map_smooth_kernel);
    if (rc != cudaSuccess) return (int)rc;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, map_smooth_kernel, kThreads, 0);
}

// Launch on `stream`. Every pointer is a device pointer: x, y (S float64,
// 0 where not valid; 16-byte aligned), valid (S uint8), grid (F, n_ys,
// n_xs) float64 with NaN, nan_img (F, ny, nx) uint8, any_nan (F) uint8, out
// (F, S) float32 (8-byte aligned); n_ys * n_xs and ny * nx below 2^31. The
// grid is as many blocks as are resident on the current device at once (or
// fewer when the samples need fewer). Returns the first CUDA error of the
// occupancy queries and the launch.
int map_smooth_launch(const double* x, const double* y, const uint8_t* valid,
                      const double* grid, int n_ys, int n_xs,
                      double iy0, double ix0, double y_step, double x_step,
                      const uint8_t* nan_img, const uint8_t* any_nan, int ny,
                      int nx, int propagate_nan, float* out,
                      long long n_samples, int n_frames, void* stream) {
    Params p;
    p.n_samples = n_samples;
    p.n_frames = n_frames;
    p.n_ys = n_ys;
    p.n_xs = n_xs;
    p.ny = ny;
    p.nx = nx;
    p.iy0 = iy0;
    p.ix0 = ix0;
    p.y_step = y_step;
    p.x_step = x_step;
    p.propagate_nan = propagate_nan;
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&device);
    if (rc == cudaSuccess) {
        rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    }
    if (rc == cudaSuccess) {
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, map_smooth_kernel, kThreads, 0);
    }
    if (rc != cudaSuccess) return (int)rc;
    const long long threads = (n_samples + kSamples - 1) / kSamples;
    const long long needed = (threads + kThreads - 1) / kThreads;
    const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    const unsigned blocks =
        (unsigned)(kPersistent && resident < needed ? resident : needed);
    map_smooth_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, y, valid, grid, nan_img, any_nan, out, p);
    return (int)cudaGetLastError();
}

}  // extern "C"
