// The last stage of BodyXY.map_img(..., interpolation='smooth'): a bilinear
// sample of the PCHIP-oversampled grids at the map samples, with scipy's
// RegularGridInterpolator NaN-corner rule on each grid and the 4-neighbour
// NaN rule on the original image, for every frame of a cube in one launch.
//
// Replaces the TPU kernel of planetmapper_tpu/ops/smooth_pallas.py
// (_smooth_eval_fn :208, kernel :249, pallas_call :331), which samples one
// 128^2 window of the oversampled grid per 32x64 map tile from bilinear
// indices and fractions staged on the host, contracting them with one-hot
// matmuls, and keeps the original NaN grid (padded <= 384) whole in VMEM.
// Here each thread computes what that staging held, so there is no
// window, no staging and no size cap. The plain version is
// map_smooth_plain in planetmapper_tpu_torch/ops/map_smooth_kernel.py; this
// kernel follows its arithmetic step by step. The grids come from the
// port's PCHIP kernel (csrc/pchip.cu), materialised in device memory.
//
// Per sample, in float64: yb = (y - iy0) / y_step and xb likewise (box
// origin and oversampling steps); live = valid & 0 <= yb <= n_ys-1 &
// 0 <= xb <= n_xs-1 (and, with propagate_nan, inside the image's pixel
// centres); iy = clip(floor(yb), 0, n_ys-2), fy = yb - iy, likewise for x
// (smooth_pallas.py:114-126). Per frame: the 2x2 corners of the grid; any
// NaN corner makes the value NaN whatever its weight (:266-285); with
// propagate_nan a NaN among the sample's floor/ceil 4 neighbours on the
// image makes it NaN too (:287-308), read only for the frames that hold a
// NaN.
//
// What bounds it on this card: per sample 1 B of validity and, for the
// valid samples, 16 B of float64 x/y are read and 4 B are written per
// frame; the corners the samples touch, 8 B each, come from a grid of 3.1
// MB a frame (611x641 for the 150^2 frame), against ~20 double operations:
// memory traffic (4.7 us for one 150^2 frame on a 720x1440 map at 3.35
// TB/s, testing/bounds.py:smooth_call_bound).
//
// Design, measured (PERF.md; the layouts that were not kept are built and
// timed by scripts/time_map_smooth_variants.py from its own copy,
// scripts/map_smooth_layouts.cu):
// - 2 adjacent map samples a thread: 16-byte double2 loads of x and y,
//   both samples' 4 corners in flight, float2 stores when the sample count
//   is even; blocks of 256 over ceil(S / 512).
// - Each sample's set-up (box coordinates, corner offset, fractions, NaN
//   neighbours) is done once for all frames, then the frames one after
//   the other.
// - 4 resident blocks of 256 per SM asked of ptxas (64 registers): the
//   corner gathers' latency is hidden by resident warps more than by
//   loads in flight in one thread. The layouts that held more in flight
//   (several frames' corners, a persistent grid that prefetches) took
//   80-142 registers, 1-3 blocks per SM, and were slower; the first
//   design's one sample a thread with its frame loop was 2 us slower cold.
// - Offsets into one grid or one image are 32-bit: the wrapper refuses a
//   grid or an image of 2^31 values or more.
//
// Built by planetmapper_tpu_torch/ops/map_smooth_kernel.py (through
// ops/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSamples = 2;    // adjacent map samples a thread
constexpr int kMinBlocks = 4;  // resident blocks per SM, asked of ptxas

struct Params {
    int64_t n_samples;  // S
    int n_frames;       // F
    int n_ys, n_xs;     // oversampled grid shape
    int ny, nx;         // original image shape
    double iy0, ix0;    // box origin in image pixels
    double y_step, x_step;
    int propagate_nan;
};

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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
map_smooth_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                  const uint8_t* __restrict__ valid,
                  const double* __restrict__ grid,
                  const uint8_t* __restrict__ nan_img,
                  const uint8_t* __restrict__ any_nan,
                  float* __restrict__ out, Params p) {
    const int64_t S = p.n_samples;
    const int64_t s0 =
        ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kSamples;
    if (s0 >= S) return;
    const bool pair = s0 + kSamples <= S;
    Sample smp[kSamples];
    if (pair) {
        const double2 xv = *reinterpret_cast<const double2*>(xs + s0);
        const double2 yv = *reinterpret_cast<const double2*>(ys + s0);
        smp[0] = setup(xv.x, yv.x, valid[s0] != 0, p);
        smp[1] = setup(xv.y, yv.y, valid[s0 + 1] != 0, p);
    } else {  // the last sample of an odd count
        smp[0] = setup(xs[s0], ys[s0], valid[s0] != 0, p);
        smp[1] = setup(0.0, 0.0, false, p);
    }
    const bool any_live = smp[0].live || smp[1].live;
    const bool pair_store = pair && S % 2 == 0;
    const bool check_nan = p.propagate_nan != 0;
    const float qnan = __int_as_float(0x7fc00000);
    const int64_t plane = (int64_t)p.n_ys * p.n_xs;
    const int64_t image = (int64_t)p.ny * p.nx;
    const int n_xs = p.n_xs;
    for (int f = 0; f < p.n_frames; ++f) {
        const double* c = grid + f * plane;
        const uint8_t* m = nan_img + f * image;
        const bool check = check_nan && any_nan[f];
        double g[kSamples][4];
        bool hit[kSamples];
#pragma unroll
        for (int v = 0; v < kSamples; ++v) {
            const double* cv = c + smp[v].corner;
            g[v][0] = any_live ? cv[0] : 0.0;
            g[v][1] = any_live ? cv[1] : 0.0;
            g[v][2] = any_live ? cv[n_xs] : 0.0;
            g[v][3] = any_live ? cv[n_xs + 1] : 0.0;
            hit[v] = false;
            if (check && smp[v].live) {
                const uint8_t* m0 = m + smp[v].nan0;
                const uint8_t* m1 = m0 + (smp[v].dy ? p.nx : 0);
                const int dx = smp[v].dx ? 1 : 0;
                hit[v] = (m0[0] | m0[dx] | m1[0] | m1[dx]) != 0;
            }
        }
        float val[kSamples];
#pragma unroll
        for (int v = 0; v < kSamples; ++v) {
            val[v] = (!smp[v].live || hit[v])
                         ? qnan
                         : bilinear(smp[v], g[v][0], g[v][1], g[v][2],
                                    g[v][3]);
        }
        float* o = out + (int64_t)f * S + s0;
        if (pair_store) {
            *reinterpret_cast<float2*>(o) = make_float2(val[0], val[1]);
        } else {
            o[0] = val[0];
            if (pair) o[1] = val[1];
        }
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
// (F, S) float32 (8-byte aligned); n_ys * n_xs and ny * nx below 2^31.
// Returns cudaGetLastError() after the launch.
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
    const long long per_block = (long long)kThreads * kSamples;
    const unsigned blocks =
        (unsigned)((n_samples + per_block - 1) / per_block);
    map_smooth_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, y, valid, grid, nan_img, any_nan, out, p);
    return (int)cudaGetLastError();
}

}  // extern "C"
