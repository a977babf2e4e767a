// Double-single ("two-float") arithmetic and float32 inverse trigonometry
// of planetmapper_tpu/ops/dsk.py, elementwise over n values, in two kernels:
//
// - dsk_pairs<op>: one operation on n (hi, lo) float32 pairs a and b, out
//   (hi, lo): MUL dsk.mul(a, b), DIV dsk.div(a, b), HYPOT
//   dsk.sqrt(dsk.add(dsk.sqr(a), dsk.sqr(b))), ATAN2_DS the function of
//   dsk.atan2_ds(a, b) (a the y pair, b the x pair).
// - dsk_atan2: the branch-free float32 dsk.atan2(y, x), its degree-8
//   polynomial and reductions (not atan2f, which differs from it by up to
//   the polynomial's ~1e-7 rad).
//
// Replaces the TPU kernels of the JAX package's dsk tests:
// tests/test_pallas_core.py TestDskOnTpu._run_pairs (:538, pallas_call :557)
// and test_atan2_f32_grade (:596, pallas_call :612), which run these
// functions on one (8, 1024) block in VMEM. This kernel computes the
// functions, not that block layout. The plain versions are
// planetmapper_tpu_torch/ops/dsk.py composed as ops/dsk_kernel.py composes
// them. MUL, DIV, HYPOT and dsk_atan2 follow them operation by operation
// and equal them bit for bit:
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
// ATAN2_DS is native float64 inside: the TPU has no float64 and runs a
// ~550-instruction double-single chain a value; this card has float64, so
// the kernel adds each pair exactly in float64 (hi + lo spans at most 49
// bits), takes one float64 atan2 (the CUDA math library's device function)
// and splits the result into a pair (~1e-14 rad, against the ds chain's
// ~3e-13). ops/dsk_kernel.py atan2_ds_native transcribes it; the plain
// version stays the ds chain, which it meets within 1e-12 rad.
// The constants below are the port's (ops/dsk.py), as hexadecimal float32
// literals; tests/test_torch_dsk.py reads them from this file and holds
// them to ops/dsk.py word for word.
//
// What bounds it on this card (testing/bounds.py:dsk_call_bound): 24 bytes
// a pair value (four words in, two out) and 12 a float32 atan2 value,
// against 10 (MUL) to ~60 float32 operations a value, or ~60-80 float64
// instructions for ATAN2_DS, at 3.35 TB/s, 67 TFLOP/s and 16.7 T float64
// instructions/s: every op is memory-bound, ATAN2_DS the closest. So the
// design keeps bytes in flight: a thread takes U groups of V = 4 values,
// one 16-byte streaming load (__ldcs) per input array and group, all U
// groups' loads issued before any arithmetic, and one 16-byte streaming
// store (__stcs) per output array and group; nothing is reused. A call
// whose pointers are not all 16-byte aligned (a view such as t[1:]), or
// of fewer than kVecMinValues values, runs the scalar loop (one value a
// thread) over every value, and a vector call's last n % 4 values run it
// too. U = 1 on one block per 1024 values was the fastest layout of the
// sweep of scripts/time_dsk.py on the H100 (PERF.md; at U = 2 and 4
// ATAN2_DS took 62 and 94 registers and ran 6% and 21% slower; the
// persistent grid was nowhere faster); DSK_GROUPS (U) and
// DSK_PERSISTENT (0 one block per 256 V U values; 1 the SMs times the
// resident blocks, with a grid-stride loop) set the sweep's layouts.
//
// Built by planetmapper_tpu_torch/ops/dsk_kernel.py (through
// ops/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#ifndef DSK_GROUPS
#define DSK_GROUPS 1
#endif
#ifndef DSK_PERSISTENT
#define DSK_PERSISTENT 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;              // V: values a group (one float4 load)
constexpr int kGroups = DSK_GROUPS;  // U: groups a thread loads at once
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride beyond
// Below this many values (~one 1024-value block per SM) a call is launch
// latency and the scalar loop's one value a thread, 4x the threads of the
// vector loop, finishes sooner
constexpr long long kVecMinValues = 1 << 17;

enum Op { kMul = 0, kDiv = 1, kHypot = 2, kAtan2Ds = 3 };

// ops/dsk.py constants (float32 words; RECIP_MAGIC an int32); the table
// in constant memory, read as uniform operands (ATAN2_DS needs none)
constexpr int kRecipMagic = 0x7EF311C3;
// _ATAN_C: atan(t) = t + t s P(s), s = t^2, P of degree 8, lowest first
__constant__ float kAtanC[9] = {
    -0x1.555526p-2f, 0x1.998cecp-3f, -0x1.23f17ep-3f, 0x1.becb68p-4f,
    -0x1.5348bep-4f, 0x1.cae4fep-5f, -0x1.e0abaap-6f, 0x1.469fe2p-7f,
    -0x1.a0b5b8p-10f,
};
// pi/2 and pi as float32
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

// The function of dsk.atan2_ds in native float64. A zero of either sign
// counts as +0, as in the port (atan2(-0, -1) = pi, atan2(0, -0) = 0; C's
// atan2 gives -pi and pi); NaN in either gives (NaN, NaN).
__device__ __forceinline__ ds atan2_ds(ds y, ds x) {
    double yd = (double)y.hi + (double)y.lo;
    double xd = (double)x.hi + (double)x.lo;
    yd = yd == 0.0 ? 0.0 : yd;
    xd = xd == 0.0 ? 0.0 : xd;
    const double r = atan2(yd, xd);
    const float hi = __double2float_rn(r);
    return {hi, __double2float_rn(r - (double)hi)};
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
__device__ __forceinline__ ds pair_op(ds a, ds b) {
    if constexpr (OP == kMul) {
        return mul(a, b);
    } else if constexpr (OP == kDiv) {
        return div_ds(a, b);
    } else if constexpr (OP == kHypot) {
        return sqrt_ds(add(sqr(a), sqr(b)));
    } else {
        return atan2_ds(a, b);
    }
}

__device__ __forceinline__ float lane(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(float4& v, int k, float f) {
    if (k == 0) {
        v.x = f;
    } else if (k == 1) {
        v.y = f;
    } else if (k == 2) {
        v.z = f;
    } else {
        v.w = f;
    }
}

// The groups of a thread in one turn of the grid-stride loop: g0, g0 + 256,
// ..., g0 + 256 (U - 1), so that each load of a warp is 512 contiguous bytes
__device__ __forceinline__ int64_t group_of(int64_t g0, int u) {
    return g0 + (int64_t)u * kThreads;
}

// dsk_pairs<op> over n values: the vector loop over the n / 4 groups when
// vec (vector_loop below), then the scalar loop over the rest
template <int OP>
__global__ void __launch_bounds__(kThreads)
dsk_pairs(const float* __restrict__ ah, const float* __restrict__ al,
          const float* __restrict__ bh, const float* __restrict__ bl,
          float* __restrict__ oh, float* __restrict__ ol, int64_t n,
          bool vec) {
    int64_t done = 0;
    if (vec) {
        const int64_t groups = n / kVec;
        done = groups * kVec;
        const float4* in4[4] = {reinterpret_cast<const float4*>(ah),
                                reinterpret_cast<const float4*>(al),
                                reinterpret_cast<const float4*>(bh),
                                reinterpret_cast<const float4*>(bl)};
        const int64_t step = (int64_t)gridDim.x * kThreads * kGroups;
        for (int64_t g0 = (int64_t)blockIdx.x * kThreads * kGroups +
                          threadIdx.x;
             g0 < groups; g0 += step) {
            float4 in[kGroups][4];
#pragma unroll
            for (int u = 0; u < kGroups; ++u) {
                const int64_t g = group_of(g0, u);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    in[u][a] = g < groups ? __ldcs(in4[a] + g)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
                }
            }
#pragma unroll
            for (int u = 0; u < kGroups; ++u) {
                const int64_t g = group_of(g0, u);
                float4 rh, rl;
#pragma unroll
                for (int k = 0; k < kVec; ++k) {
                    const ds r = pair_op<OP>(
                        {lane(in[u][0], k), lane(in[u][1], k)},
                        {lane(in[u][2], k), lane(in[u][3], k)});
                    set_lane(rh, k, r.hi);
                    set_lane(rl, k, r.lo);
                }
                if (g < groups) {
                    __stcs(reinterpret_cast<float4*>(oh) + g, rh);
                    __stcs(reinterpret_cast<float4*>(ol) + g, rl);
                }
            }
        }
    }
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t i = done + (int64_t)blockIdx.x * kThreads + threadIdx.x;
         i < n; i += stride) {
        const ds r = pair_op<OP>({__ldcs(ah + i), __ldcs(al + i)},
                                 {__ldcs(bh + i), __ldcs(bl + i)});
        __stcs(oh + i, r.hi);
        __stcs(ol + i, r.lo);
    }
}

// dsk_atan2 over n values, laid out as dsk_pairs
__global__ void __launch_bounds__(kThreads)
dsk_atan2(const float* __restrict__ y, const float* __restrict__ x,
          float* __restrict__ out, int64_t n, bool vec) {
    int64_t done = 0;
    if (vec) {
        const int64_t groups = n / kVec;
        done = groups * kVec;
        const float4* y4 = reinterpret_cast<const float4*>(y);
        const float4* x4 = reinterpret_cast<const float4*>(x);
        const int64_t step = (int64_t)gridDim.x * kThreads * kGroups;
        for (int64_t g0 = (int64_t)blockIdx.x * kThreads * kGroups +
                          threadIdx.x;
             g0 < groups; g0 += step) {
            float4 yv[kGroups], xv[kGroups];
#pragma unroll
            for (int u = 0; u < kGroups; ++u) {
                const int64_t g = group_of(g0, u);
                const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
                yv[u] = g < groups ? __ldcs(y4 + g) : zero;
                xv[u] = g < groups ? __ldcs(x4 + g) : zero;
            }
#pragma unroll
            for (int u = 0; u < kGroups; ++u) {
                const int64_t g = group_of(g0, u);
                float4 r;
#pragma unroll
                for (int k = 0; k < kVec; ++k) {
                    set_lane(r, k, atan2_f32(lane(yv[u], k), lane(xv[u], k)));
                }
                if (g < groups) __stcs(reinterpret_cast<float4*>(out) + g, r);
            }
        }
    }
    const int64_t stride = (int64_t)gridDim.x * kThreads;
    for (int64_t i = done + (int64_t)blockIdx.x * kThreads + threadIdx.x;
         i < n; i += stride) {
        __stcs(out + i, atan2_f32(__ldcs(y + i), __ldcs(x + i)));
    }
}

// The vector loop: every pointer 16-byte aligned and enough values
bool vector_loop(uintptr_t any_of_the_pointers, long long n) {
    return (any_of_the_pointers & 15) == 0 && n >= kVecMinValues;
}

// The grid of one launch: one block per 256 V U values (vec) or 256 values
// (the scalar loop); with DSK_PERSISTENT, at most the blocks the card holds
// at once
template <class Kernel>
unsigned blocks_for(Kernel kernel, long long n, bool vec) {
    const long long per_block =
        vec ? (long long)kThreads * kVec * kGroups : kThreads;
    long long b = (n + per_block - 1) / per_block;
#if DSK_PERSISTENT
    int device = 0, sms = 0, resident = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                  kThreads, 0);
    const long long held = (long long)sms * resident;
    if (held > 0 && b > held) b = held;
#else
    (void)kernel;
#endif
    return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <int OP>
void launch_pairs(const float* ah, const float* al, const float* bh,
                  const float* bl, float* oh, float* ol, long long n,
                  cudaStream_t s) {
    const bool vec = vector_loop((uintptr_t)ah | (uintptr_t)al |
                                     (uintptr_t)bh | (uintptr_t)bl |
                                     (uintptr_t)oh | (uintptr_t)ol,
                                 n);
    dsk_pairs<OP><<<blocks_for(dsk_pairs<OP>, n, vec), kThreads, 0, s>>>(
        ah, al, bh, bl, oh, ol, n, vec);
}

}  // namespace

extern "C" {

// Launch dsk_pairs<op> (0 MUL, 1 DIV, 2 HYPOT, 3 ATAN2_DS) on `stream` over
// n values of contiguous float32 device arrays (any alignment). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// op).
int dsk_pairs_launch(int op, const float* ah, const float* al,
                     const float* bh, const float* bl, float* oh, float* ol,
                     long long n, void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case kMul:
            launch_pairs<kMul>(ah, al, bh, bl, oh, ol, n, s);
            break;
        case kDiv:
            launch_pairs<kDiv>(ah, al, bh, bl, oh, ol, n, s);
            break;
        case kHypot:
            launch_pairs<kHypot>(ah, al, bh, bl, oh, ol, n, s);
            break;
        case kAtan2Ds:
            launch_pairs<kAtan2Ds>(ah, al, bh, bl, oh, ol, n, s);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Launch dsk_atan2 on `stream`: out = dsk.atan2(y, x) over n values of
// contiguous float32 device arrays (any alignment). Returns
// cudaGetLastError().
int dsk_atan2_launch(const float* y, const float* x, float* out, long long n,
                     void* stream) {
    if (n <= 0) return 0;
    const bool vec =
        vector_loop((uintptr_t)y | (uintptr_t)x | (uintptr_t)out, n);
    dsk_atan2<<<blocks_for(dsk_atan2, n, vec), kThreads, 0,
                (cudaStream_t)stream>>>(y, x, out, n, vec);
    return (int)cudaGetLastError();
}

}  // extern "C"
