// Bivariate B-spline evaluation at map samples, with the 4-neighbour NaN
// rule of BodyXY.map_img ('linear', 'quadratic', 'cubic', (ky, kx)).
//
// Replaces two TPU kernels of planetmapper_tpu/ops/map_pallas.py:
// _pallas_eval_fn (:268, kernel :311, pallas_call :386), which keeps the
// whole coefficient grid of a source up to 640 px in VMEM, and
// _pallas_eval_windowed_fn (:628, kernel :664, pallas_call :716), which
// serves larger sources through one 128^2 or 256^2 coefficient window per
// 32x64 map tile. Both read basis values staged by XLA once per map and
// contract them with one-hot matmuls, because the TPU has small VMEM, no
// float64 and slow gathers. This card has none of those limits, so one
// kernel computes the same function directly for any source size.
// The plain version is map_spline_plain in
// planetmapper_tpu_torch/ops/map_spline_kernel.py; this kernel follows its
// arithmetic step by step.
//
// Design (first version: right and simple, fast later):
// - One thread per map sample, in blocks of 256 over ceil(S / 256); each
//   thread loops over the frames, so a sample's basis is built once and
//   every frame's store is coalesced (out is (F, S) float32).
// - Per sample, in float64: clamp the coordinate into [t[k], t[n_t-k-1]];
//   find the knot interval i = clip(#{t <= u} - 1, k, n_c - 1) by binary
//   search (the same index as the compare-count of map_pallas.py:159-161,
//   knot values included); build the k+1 de Boor-Cox basis values with
//   the denom == 0 -> 1 guard (map_pallas.py:178-192).
// - The (ky+1)(kx+1) float64 coefficients are read straight from global
//   memory: neighbouring samples read neighbouring coefficients, and a
//   frame's grid (8 MB at 1024^2) stays in the 50 MB L2.
// - NaN rule on the unclamped coordinates: a sample is NaN when it is not
//   valid, or (propagate_nan) outside [0, nx-1] x [0, ny-1], or any of its
//   floor/ceil 4 neighbours (clipped to the grid) is NaN in the frame. A
//   per-frame any-NaN flag skips the neighbour reads for clean frames.
// - kx and ky are template parameters (1..3 each, nine instances).
//
// What bounds it on this card: per sample it reads 16 B of float64 x/y and
// 1 B of validity and writes 4 B per frame; the basis is ~50 double
// operations per axis and the sum 2(ky+1)(kx+1) per frame. At a 720x1440
// map that is ~21 MB per frame against ~0.1 GFLOP of double work, so
// memory traffic bounds it (about 6 us per frame at 3.35 TB/s), and a
// frame sits near launch latency. Nothing more is done about it here.
//
// Built by planetmapper_tpu_torch/ops/map_spline_kernel.py (through
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
    int n_ty, n_tx;     // knot counts
    int ny, nx;         // source image (NaN grid) shape
    int propagate_nan;
};

// Non-zero B-spline basis values n[0..K] at u and the index of the first
// coefficient they weight (interval - K).
template <int K>
__device__ __forceinline__ int bspline_basis(const double* __restrict__ t,
                                             int n_t, double u,
                                             double (&n)[K + 1]) {
    const int n_c = n_t - K - 1;
    u = fmin(fmax(u, t[K]), t[n_t - K - 1]);
    int lo = 0, hi = n_t;  // lo = #{t <= u}
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (t[mid] <= u) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    const int i = min(max(lo - 1, K), n_c - 1);
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
    return i - K;
}

template <int KX, int KY>
__global__ void __launch_bounds__(256)
map_spline_kernel(const double* __restrict__ xs, const double* __restrict__ ys,
                  const uint8_t* __restrict__ valid,
                  const double* __restrict__ ty, const double* __restrict__ tx,
                  const double* __restrict__ coeffs,
                  const uint8_t* __restrict__ nan_grid,
                  const uint8_t* __restrict__ any_nan,
                  float* __restrict__ out, Params p) {
    const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= p.n_samples) return;
    const float qnan = __int_as_float(0x7fc00000);
    const int64_t S = p.n_samples;

    const double x = xs[s];
    const double y = ys[s];
    bool dead = valid[s] == 0;
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

    double by[KY + 1], bx[KX + 1];
    const int iy0 = bspline_basis<KY>(ty, p.n_ty, y, by);
    const int ix0 = bspline_basis<KX>(tx, p.n_tx, x, bx);
    const int n_cy = p.n_ty - KY - 1;
    const int n_cx = p.n_tx - KX - 1;
    const int64_t grid = (int64_t)n_cy * n_cx;
    const int64_t image = (int64_t)p.ny * p.nx;

    for (int f = 0; f < p.n_frames; ++f) {
        if (p.propagate_nan && any_nan[f]) {
            const uint8_t* g = nan_grid + f * image;
            if (g[y0 * p.nx + x0] | g[y0 * p.nx + x1] | g[y1 * p.nx + x0] |
                g[y1 * p.nx + x1]) {
                out[f * S + s] = qnan;
                continue;
            }
        }
        const double* c = coeffs + f * grid + (int64_t)iy0 * n_cx + ix0;
        double val = 0.0;
#pragma unroll
        for (int a = 0; a <= KY; ++a) {
            double row = 0.0;
#pragma unroll
            for (int b = 0; b <= KX; ++b) row += bx[b] * c[a * n_cx + b];
            val += by[a] * row;
        }
        out[f * S + s] = (float)val;
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
        default: return nullptr;
    }
}

Kernel pick(int kx, int ky) {
    switch (kx) {
        case 1: return pick_ky<1>(ky);
        case 2: return pick_ky<2>(ky);
        case 3: return pick_ky<3>(ky);
        default: return nullptr;
    }
}

}  // namespace

extern "C" {

// Launch on `stream`. Every pointer is a device pointer: x, y (S float64,
// 0 where not valid), valid (S uint8), ty (n_ty) and tx (n_tx) float64
// knots, coeffs (F, n_cy, n_cx) float64, nan_grid (F, ny, nx) uint8,
// any_nan (F) uint8, out (F, S) float32. Returns cudaErrorInvalidValue for
// a degree outside 1..3, else cudaGetLastError() after the launch.
int map_spline_launch(const double* x, const double* y, const uint8_t* valid,
                      const double* ty, int n_ty, const double* tx, int n_tx,
                      int kx, int ky, const double* coeffs,
                      const uint8_t* nan_grid, const uint8_t* any_nan,
                      int ny, int nx, int propagate_nan, float* out,
                      long long n_samples, int n_frames, void* stream) {
    const Kernel kernel = pick(kx, ky);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    Params p;
    p.n_samples = n_samples;
    p.n_frames = n_frames;
    p.n_ty = n_ty;
    p.n_tx = n_tx;
    p.ny = ny;
    p.nx = nx;
    p.propagate_nan = propagate_nan;
    const int block = 256;
    const unsigned grid = (unsigned)((n_samples + block - 1) / block);
    kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        x, y, valid, ty, tx, coeffs, nan_grid, any_nan, out, p);
    return (int)cudaGetLastError();
}

}  // extern "C"
