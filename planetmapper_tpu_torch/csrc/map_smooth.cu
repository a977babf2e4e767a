// The last stage of BodyXY.map_img(..., interpolation='smooth'): a bilinear
// sample of the PCHIP-oversampled grid at the map samples, with scipy's
// RegularGridInterpolator NaN-corner rule on that grid and the 4-neighbour
// NaN rule on the original image.
//
// Replaces the TPU kernel of planetmapper_tpu/ops/smooth_pallas.py
// (_smooth_eval_fn :208, kernel :249, pallas_call :331), which samples one
// 128^2 window of the oversampled grid per 32x64 map tile from bilinear
// indices and fractions staged on the host, contracting them with one-hot
// matmuls, and keeps the original NaN grid (padded <= 384) whole in VMEM.
// Here each thread computes what that staging held, so there is no
// window, no staging and no size cap. The plain version is
// map_smooth_plain in planetmapper_tpu_torch/ops/map_smooth_kernel.py; this
// kernel follows its arithmetic step by step.
//
// Design (first version: right and simple, fast later):
// - One thread per map sample, in blocks of 256 over ceil(S / 256); each
//   thread loops over the frames (out is (F, S) float32, coalesced).
// - Per sample, in float64: yb = (y - iy0) / y_step and xb likewise (box
//   origin and oversampling steps); care = valid & 0 <= yb <= n_ys-1 &
//   0 <= xb <= n_xs-1; iy = clip(floor(yb), 0, n_ys-2), fy = yb - iy, and
//   the same for x (smooth_pallas.py:114-126).
// - Per frame: the 2x2 corners are read from the float64 grid; any NaN
//   corner makes the sample NaN whatever its weight (smooth_pallas.py:
//   266-285). With propagate_nan, a sample outside [0, nx-1] x [0, ny-1]
//   on the original grid, or with a NaN among its floor/ceil 4 neighbours
//   there, is NaN too (:287-308); a per-frame any-NaN flag skips those
//   reads for clean frames.
//
// What bounds it on this card: per sample 1 B of validity and, for the
// valid samples, 16 B of float64 x/y are read and 4 B are written per
// frame; 32 B of corners come from a grid that stays in L2 (3.3 MB at
// 646^2), against ~20 double operations. Memory traffic bounds it (4.7 us
// for one 150^2 frame on a 720x1440 map at 3.35 TB/s, counting each grid
// value the samples touch once: testing/bounds.py:map_smooth_bound), and
// a frame sits near launch latency.
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

struct Params {
    int64_t n_samples;  // S
    int n_frames;       // F
    int n_ys, n_xs;     // oversampled grid shape
    int ny, nx;         // original image shape
    double iy0, ix0;    // box origin in image pixels
    double y_step, x_step;
    int propagate_nan;
};

__global__ void __launch_bounds__(256)
map_smooth_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                  const uint8_t* __restrict__ valid,
                  const double* __restrict__ grid,
                  const uint8_t* __restrict__ nan_img,
                  const uint8_t* __restrict__ any_nan,
                  float* __restrict__ out, Params p) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= p.n_samples) return;
    const float qnan = __int_as_float(0x7fc00000);
    const int64_t S = p.n_samples;

    const double x = xs[s];
    const double y = ys[s];
    const double yb = (y - p.iy0) / p.y_step;
    const double xb = (x - p.ix0) / p.x_step;
    bool dead = valid[s] == 0 || !(yb >= 0.0) ||
                !(yb <= (double)(p.n_ys - 1)) || !(xb >= 0.0) ||
                !(xb <= (double)(p.n_xs - 1));
    int x0 = 0, x1 = 0, y0 = 0, y1 = 0;
    if (p.propagate_nan) {
        dead = dead || x < 0.0 || y < 0.0 || x > (double)(p.nx - 1) ||
               y > (double)(p.ny - 1);
        x0 = min(max((int)floor(x), 0), p.nx - 1);
        x1 = min(max((int)ceil(x), 0), p.nx - 1);
        y0 = min(max((int)floor(y), 0), p.ny - 1);
        y1 = min(max((int)ceil(y), 0), p.ny - 1);
    }
    if (dead) {
        for (int f = 0; f < p.n_frames; ++f) out[f * S + s] = qnan;
        return;
    }

    const double iy = fmin(fmax(floor(yb), 0.0), (double)(p.n_ys - 2));
    const double ix = fmin(fmax(floor(xb), 0.0), (double)(p.n_xs - 2));
    const double fy = yb - iy;
    const double fx = xb - ix;
    const int64_t corner = (int64_t)iy * p.n_xs + (int64_t)ix;
    const int64_t plane = (int64_t)p.n_ys * p.n_xs;
    const int64_t image = (int64_t)p.ny * p.nx;

    for (int f = 0; f < p.n_frames; ++f) {
        if (p.propagate_nan && any_nan[f]) {
            const uint8_t* g = nan_img + f * image;
            if (g[y0 * p.nx + x0] | g[y0 * p.nx + x1] | g[y1 * p.nx + x0] |
                g[y1 * p.nx + x1]) {
                out[f * S + s] = qnan;
                continue;
            }
        }
        const double* c = grid + f * plane + corner;
        const double g00 = c[0], g01 = c[1];
        const double g10 = c[p.n_xs], g11 = c[p.n_xs + 1];
        if (isnan(g00) || isnan(g01) || isnan(g10) || isnan(g11)) {
            out[f * S + s] = qnan;
            continue;
        }
        const double val = (1.0 - fx) * ((1.0 - fy) * g00 + fy * g10) +
                           fx * ((1.0 - fy) * g01 + fy * g11);
        out[f * S + s] = (float)val;
    }
}

}  // namespace

extern "C" {

// Launch on `stream`. Every pointer is a device pointer: x, y (S float64,
// 0 where not valid), valid (S uint8), grid (F, n_ys, n_xs) float64 with
// NaN, nan_img (F, ny, nx) uint8, any_nan (F) uint8, out (F, S) float32.
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
    const int block = 256;
    const unsigned blocks = (unsigned)((n_samples + block - 1) / block);
    map_smooth_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
        x, y, valid, grid, nan_img, any_nan, out, p);
    return (int)cudaGetLastError();
}

}  // extern "C"
