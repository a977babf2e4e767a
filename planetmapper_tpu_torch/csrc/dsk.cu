// Double-single ("two-float") arithmetic and float32 inverse trigonometry
// of planetmapper_tpu/ops/dsk.py, elementwise over n values, in two kernels:
//
// - dsk_pairs<op>: one ds operation on n (hi, lo) float32 pairs a and b,
//   out (hi, lo): MUL dsk.mul(a, b), DIV dsk.div(a, b), HYPOT
//   dsk.sqrt(dsk.add(dsk.sqr(a), dsk.sqr(b))), ATAN2_DS dsk.atan2_ds(a, b)
//   (a the y pair, b the x pair).
// - dsk_atan2: the branch-free float32 dsk.atan2(y, x), its degree-8
//   polynomial and reductions (not atan2f, which differs from it by up to
//   the polynomial's ~1e-7 rad).
//
// Replaces the TPU kernels of the JAX package's dsk tests:
// tests/test_pallas_core.py TestDskOnTpu._run_pairs (:538, pallas_call :557)
// and test_atan2_f32_grade (:596, pallas_call :612), which run these
// functions on one (8, 1024) block in VMEM. This kernel computes the
// functions, not that block layout: one thread per value, grid-stride, any
// n. The plain versions are planetmapper_tpu_torch/ops/dsk.py composed as
// ops/dsk_kernel.py composes them; this kernel follows them operation by
// operation and equals them bit for bit:
// - built with -fmad=false, so that no multiply-add is contracted (a fused
//   t = 4097*a; t - (t - a) would destroy a split, and every lo word);
// - no --use_fast_math: subnormals kept, '/' and sqrt correctly rounded,
//   written as __fdiv_rn and __fsqrt_rn;
// - two_prod is p = a*b, e = fma(a, b, -p) (__fmaf_rn, which the flag
//   leaves alone): exact on Hopper, and the same e as Dekker's split of the
//   plain version wherever that split does not overflow (|a| < ~2^128/4097)
//   and e is not subnormal;
// - the float32 seed of dsk.rsqrt is 1 / sqrt(x), correctly rounded in
//   both (the JAX package takes lax.rsqrt);
// - recip_seed's integer seed by __float_as_int/__int_as_float.
// The constants below are the port's (ops/dsk.py), as hexadecimal float32
// literals; tests/test_torch_dsk.py reads them from this file and holds
// them to ops/dsk.py word for word.
//
// What bounds it on this card (testing/bounds.py:dsk_call_bound): 24 bytes
// a pair value (four words in, two out) and 12 a float32 atan2 value,
// against 10 (MUL) to ~350 (ATAN2_DS) float32 operations a value at their
// least known work. By that count every op is memory-bound at 3.35 TB/s
// and 67 TFLOP/s, ATAN2_DS the closest: its operations take ~3/4 of its
// bytes' time. The loads and stores are coalesced float32 words, one value
// a thread; nothing is reused.
//
// Built by planetmapper_tpu_torch/ops/dsk_kernel.py (through
// ops/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride beyond

enum Op { kMul = 0, kDiv = 1, kHypot = 2, kAtan2Ds = 3 };

// ops/dsk.py constants (float32 words; RECIP_MAGIC an int32); the tables
// in constant memory, read as uniform operands
constexpr int kRecipMagic = 0x7EF311C3;
// _ATAN_C: atan(t) = t + t s P(s), s = t^2, P of degree 8, lowest first
__constant__ float kAtanC[9] = {
    -0x1.555526p-2f, 0x1.998cecp-3f, -0x1.23f17ep-3f, 0x1.becb68p-4f,
    -0x1.5348bep-4f, 0x1.cae4fep-5f, -0x1.e0abaap-6f, 0x1.469fe2p-7f,
    -0x1.a0b5b8p-10f,
};
// _ATAN_DS_C: (-1)^k / (2k + 1), k = 1..13, split into (hi, lo)
__constant__ float kAtanDsHi[13] = {
    -0x1.555556p-2f, 0x1.99999ap-3f, -0x1.24924ap-3f, 0x1.c71c72p-4f,
    -0x1.745d18p-4f, 0x1.3b13b2p-4f, -0x1.111112p-4f, 0x1.e1e1e2p-5f,
    -0x1.af286cp-5f, 0x1.861862p-5f, -0x1.642c86p-5f, 0x1.47ae14p-5f,
    -0x1.2f684cp-5f,
};
__constant__ float kAtanDsLo[13] = {
    0x1.555556p-27f, -0x1.99999ap-29f, 0x1.b6db6ep-28f, -0x1.c71c72p-31f,
    0x1.745d18p-29f, -0x1.89d89ep-29f, 0x1.dddddep-29f, -0x1.e1e1e2p-33f,
    0x1.af286cp-32f, -0x1.e79e7ap-31f, 0x1.bd37a8p-31f, 0x1.eb851ep-31f,
    0x1.2f684cp-32f,
};
// _PI_4, _PI_2, _PI as (hi, lo); _TAN_PI_8, pi/2 and pi as float32
__constant__ float kPi4[2] = {0x1.921fb6p-1f, -0x1.777a5cp-26f};
__constant__ float kPi2[2] = {0x1.921fb6p+0f, -0x1.777a5cp-25f};
__constant__ float kPi[2] = {0x1.921fb6p+1f, -0x1.777a5cp-24f};
constexpr float kTanPi8 = 0x1.a8279ap-2f;
constexpr float kPi2F = 0x1.921fb6p+0f;
constexpr float kPiF = 0x1.921fb6p+1f;

struct ds {
    float hi, lo;
};

__device__ __forceinline__ float nan32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ ds two_sum(float a, float b) {
    const float s = a + b;
    const float bb = s - a;
    return {s, (a - (s - bb)) + (b - bb)};
}

__device__ __forceinline__ ds quick_two_sum(float a, float b) {
    const float s = a + b;
    return {s, b - (s - a)};
}

__device__ __forceinline__ ds two_prod(float a, float b) {
    const float p = a * b;
    return {p, __fmaf_rn(a, b, -p)};
}

__device__ __forceinline__ ds neg(ds a) { return {-a.hi, -a.lo}; }

__device__ __forceinline__ ds pick(bool c, ds a, ds b) {
    return {c ? a.hi : b.hi, c ? a.lo : b.lo};
}

__device__ __forceinline__ ds add(ds a, ds b) {
    const ds s = two_sum(a.hi, b.hi);
    return quick_two_sum(s.hi, s.lo + (a.lo + b.lo));
}

__device__ __forceinline__ ds add_f(ds a, float b) {
    const ds s = two_sum(a.hi, b);
    return quick_two_sum(s.hi, s.lo + a.lo);
}

__device__ __forceinline__ ds mul(ds a, ds b) {
    const ds p = two_prod(a.hi, b.hi);
    return quick_two_sum(p.hi, p.lo + (a.hi * b.lo + a.lo * b.hi));
}

__device__ __forceinline__ ds mul_f(ds a, float b) {
    const ds p = two_prod(a.hi, b);
    return quick_two_sum(p.hi, p.lo + a.lo * b);
}

__device__ __forceinline__ ds sqr(ds a) {
    const ds p = two_prod(a.hi, a.hi);
    return quick_two_sum(p.hi, p.lo + 2.0f * (a.hi * a.lo));
}

__device__ __forceinline__ float recip_seed(float x) {
    float r = __int_as_float(kRecipMagic - __float_as_int(fabsf(x)));
    r = x < 0.0f ? -r : r;
#pragma unroll
    for (int i = 0; i < 3; ++i) r = r * (2.0f - x * r);
    return r;
}

__device__ __forceinline__ ds recip(ds a) {
    const float r0 = recip_seed(a.hi);
    const ds d = add_f(neg(mul_f(a, r0)), 2.0f);
    return mul_f(d, r0);
}

__device__ __forceinline__ ds div_ds(ds a, ds b) { return mul(a, recip(b)); }

__device__ __forceinline__ ds rsqrt_ds(ds a) {
    const float r0 = __fdiv_rn(1.0f, __fsqrt_rn(a.hi));
    const ds d = add_f(neg(mul_f(mul_f(a, r0), r0)), 3.0f);
    return mul_f(mul_f(d, r0), 0.5f);
}

__device__ __forceinline__ ds sqrt_ds(ds a) {
    const bool zero = a.hi == 0.0f;
    const ds s = mul(a, rsqrt_ds({zero ? 1.0f : a.hi, a.lo}));
    return {zero ? __fsqrt_rn(a.hi) : s.hi, zero ? 0.0f : s.lo};
}

__device__ __forceinline__ ds atan2_ds(ds y, ds x) {
    const ds ax = {fabsf(x.hi), x.hi < 0.0f ? -x.lo : x.lo};
    const ds ay = {fabsf(y.hi), y.hi < 0.0f ? -y.lo : y.lo};
    const bool swap = ay.hi > ax.hi;
    const ds num = pick(swap, ax, ay);
    const ds den = pick(swap, ay, ax);
    const bool den_zero = den.hi == 0.0f;
    const ds t = div_ds(num, {den_zero ? 1.0f : den.hi, den_zero ? 0.0f : den.lo});
    // second reduction: t > tan(pi/8) -> (t - 1)/(t + 1), in [-0.414, 0]
    const bool red = t.hi > kTanPi8;
    const ds u = pick(red, div_ds(add_f(t, -1.0f), add_f(t, 1.0f)), t);
    const ds s = sqr(u);
    ds p = {kAtanDsHi[12], kAtanDsLo[12]};
#pragma unroll
    for (int k = 11; k >= 0; --k) p = add(mul(p, s), {kAtanDsHi[k], kAtanDsLo[k]});
    ds r = add(u, mul(u, mul(s, p)));
    r = pick(red, add(r, {kPi4[0], kPi4[1]}), r);
    r = pick(swap, add({kPi2[0], kPi2[1]}, neg(r)), r);
    r = pick(x.hi < 0.0f, add({kPi[0], kPi[1]}, neg(r)), r);
    r = pick(y.hi < 0.0f, neg(r), r);
    if (isnan(x.hi) || isnan(y.hi)) return {nan32(), nan32()};
    return r;
}

__device__ __forceinline__ float atan2_f32(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const float t = __fdiv_rn(lo, hi == 0.0f ? 1.0f : hi);
    const float s = t * t;
    float p = kAtanC[8];
#pragma unroll
    for (int k = 7; k >= 0; --k) p = p * s + kAtanC[k];
    float r = t + t * (s * p);
    r = ay > ax ? kPi2F - r : r;
    r = x < 0.0f ? kPiF - r : r;
    r = y < 0.0f ? -r : r;
    return (isnan(x) || isnan(y)) ? nan32() : r;
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
dsk_pairs(const float* __restrict__ ah, const float* __restrict__ al,
          const float* __restrict__ bh, const float* __restrict__ bl,
          float* __restrict__ oh, float* __restrict__ ol, int64_t n) {
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride) {
        const ds a = {ah[i], al[i]};
        const ds b = {bh[i], bl[i]};
        ds r;
        if constexpr (OP == kMul) {
            r = mul(a, b);
        } else if constexpr (OP == kDiv) {
            r = div_ds(a, b);
        } else if constexpr (OP == kHypot) {
            r = sqrt_ds(add(sqr(a), sqr(b)));
        } else {
            r = atan2_ds(a, b);
        }
        oh[i] = r.hi;
        ol[i] = r.lo;
    }
}

__global__ void __launch_bounds__(kThreads)
dsk_atan2(const float* __restrict__ y, const float* __restrict__ x,
          float* __restrict__ out, int64_t n) {
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride) {
        out[i] = atan2_f32(y[i], x[i]);
    }
}

unsigned blocks_for(long long n) {
    const long long b = (n + kThreads - 1) / kThreads;
    return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" {

// Launch dsk_pairs<op> (0 MUL, 1 DIV, 2 HYPOT, 3 ATAN2_DS) on `stream` over
// n values of contiguous float32 device arrays. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another op).
int dsk_pairs_launch(int op, const float* ah, const float* al,
                     const float* bh, const float* bl, float* oh, float* ol,
                     long long n, void* stream) {
    if (n <= 0) return 0;
    const unsigned blocks = blocks_for(n);
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case kMul:
            dsk_pairs<kMul><<<blocks, kThreads, 0, s>>>(ah, al, bh, bl, oh, ol, n);
            break;
        case kDiv:
            dsk_pairs<kDiv><<<blocks, kThreads, 0, s>>>(ah, al, bh, bl, oh, ol, n);
            break;
        case kHypot:
            dsk_pairs<kHypot><<<blocks, kThreads, 0, s>>>(ah, al, bh, bl, oh, ol, n);
            break;
        case kAtan2Ds:
            dsk_pairs<kAtan2Ds><<<blocks, kThreads, 0, s>>>(ah, al, bh, bl, oh, ol, n);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Launch dsk_atan2 on `stream`: out = dsk.atan2(y, x) over n values of
// contiguous float32 device arrays. Returns cudaGetLastError().
int dsk_atan2_launch(const float* y, const float* x, float* out, long long n,
                     void* stream) {
    if (n <= 0) return 0;
    dsk_atan2<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(y, x, out,
                                                                     n);
    return (int)cudaGetLastError();
}

}  // extern "C"
