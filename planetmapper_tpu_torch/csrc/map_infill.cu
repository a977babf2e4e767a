// The NaN infill in front of the spline modes of BodyXY.map_img: every
// frame of a float64 cube (ny x nx each) becomes the grid the collocation
// solve takes, in one call:
// - a finite cell keeps its value;
// - a non-finite cell with a finite cell in its clipped 3x3 neighbourhood
//   takes the mean of those cells, summed dy outer, dx inner, from 0.0,
//   and divided by their count;
// - any other cell takes its frame's median of finite values (the mean of
//   the two middle ones, as np.nanmedian), or 0 when the frame has none.
// It also writes isnan of every cell (infinities are infilled but not
// propagated) and each frame's count of finite cells.
// For a spline of degree 1 on both axes this grid is the coefficient grid.
//
// Replaces no TPU kernel: the JAX package computes the infill in XLA
// (planetmapper_tpu/ops/interp_device.py _infill_device, :611), a sort of
// the frame for its median and 18 shifted adds. The plain version is
// infill_plain in planetmapper_tpu_torch/ops/map_infill_kernel.py; this
// kernel follows its float64 arithmetic (adds and one division a cell, and
// (lo + hi) / 2 for the median) and is built with -fmad=false, so that it
// is bit for bit with it.
//
// Design: one pass over the cells, and a selection only where it is
// needed, decided on the card.
// - The stencil pass: a thread takes kItems cells of a frame, all loads
//   first. A finite cell is copied; a non-finite one reads its
//   neighbours (L1 and L2 hits: NaNs are few). A cell with no finite
//   neighbour is an orphan: counted, its index listed (the first
//   kOrphanList of a frame) and its value left NaN. The last block of a
//   frame to finish (a counter after a fence) writes the frame's flags
//   and, if it has orphans, starts the frame's selection.
// - The selection finds the ranks (n-1)/2 and n/2 of the frame's finite
//   values as order-preserving 64-bit keys, most significant digit first
//   (kDigitBits a pass): each pass histograms the keys under the current
//   prefix in shared memory, the last block of the frame picks the digit
//   bucket that holds the rank, and once a bucket holds kCandidates keys
//   or fewer, the next pass gathers them and the last block sorts them in
//   shared memory (bitonic). The upper middle value, where it lies in a
//   later bucket than the lower one, is that bucket's least key (a
//   minimum in the next pass). A frame of finite keys needs at most
//   kSelectPasses passes; every pass is launched, and a pass returns at
//   once for a frame whose selection is done or was never needed, so the
//   host reads nothing. Noise around 0 takes two: a histogram of sign and
//   exponent, then a gather.
// - The fill pass writes the median into the listed orphans (or, past the
//   list, into every NaN of the frame's cleaned grid).
//
// What bounds it on this card: bytes. The least time of a 2048^2 frame is
// 71.3 MB (8 bytes read and 8 + 1 written a cell) at 3.35 TB/s, 21.3 us.
// On an H100 80GB HBM3 at 700 W (torch.profiler, the benchmark's
// map_linear frame: 4 blocks of 3 NaN px in unit noise):
// - the stencil pass 24-26 us, 82-87% of that bound;
// - a histogram pass 22-27 us: 13 us to read the frame (a late pass, whose
//   prefix few keys match) and ~10 us of histogram work where every key
//   counts (the noise's keys crowd into ~10 of the 4,096 bins: the lanes
//   of a warp that share a bin add once, __match_any_sync; same-address
//   shared atomics took as long); the gather pass and the sort of ~1,600
//   keys by one block 33-36 us; a pass with nothing to do 1.3 us, and
//   launched every ~2.5 us (the host's launch rate);
// - so 108-113 us a frame with orphans, 52-58 us a finite frame.
// Tried and no faster (within 2 us): 4 loads a thread in flight and 256
// blocks a frame in the selection passes with plain shared atomics (pass
// 1 26.6 us), the last block's loads of the histogram and the keys
// unrolled.
//
// Built by planetmapper_tpu_torch/ops/map_infill_kernel.py (through
// ops/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// cells a thread takes in the stencil and fill passes
constexpr int kItems = 8;
constexpr int kStencilCells = kThreads * kItems;
constexpr int kDigitBits = 12;
constexpr int kBins = 1 << kDigitBits;
// keys a bucket may hold to be gathered and sorted by one block
constexpr int kCandidates = 2048;
// orphans of a frame listed by index
constexpr int kOrphanList = 256;
// 64 key bits in digits of 12 (6 passes), then one pass for a gather or
// for the upper middle value's minimum
constexpr int kSelectPasses = 7;
// cells a block takes in a selection pass, and the most blocks a frame
constexpr long long kSelectCells = 8192;
constexpr int kSelectBlocks = 512;
// loads a thread has in flight in a selection pass
constexpr int kSelectLoads = 8;
constexpr int kMaxGridY = 65535;
constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned long long kNoKey = ~0ull;
constexpr unsigned int kNoBin = ~0u;

static_assert(kBins * sizeof(unsigned int) ==
                  kCandidates * sizeof(unsigned long long),
              "the histogram and the candidates share one shared buffer");
static_assert(kBins % kThreads == 0, "a thread scans whole runs of bins");

// The selection's state of a frame.
enum Mode : int { kIdle = 0, kHist = 1, kGather = 2, kDone = 3 };
// The upper middle value: the lower one (odd count), the next rank under
// the lower one's prefix, the least key under hi_prefix (computed by the
// next pass), or found.
enum HiMode : int { kHiSame = 0, kHiNext = 1, kHiPending = 2, kHiKnown = 3 };

struct alignas(128) FrameState {
    // the stencil pass
    unsigned int finite;
    unsigned int orphans;
    unsigned int stencil_done;
    // the selection
    int mode;
    int hi_mode;
    int bits;      // top bits of `prefix` fixed
    int hi_bits;   // top bits of `hi_prefix` fixed
    unsigned int rank;    // the lower middle's rank among keys under prefix
    unsigned int count;   // keys under prefix
    unsigned int n_cand;  // keys gathered
    unsigned int select_done;
    unsigned long long prefix;
    unsigned long long hi_prefix;
    unsigned long long hi_min;
    unsigned long long lo_key;
    unsigned long long hi_key;
    double median;
};

struct Params {
    const double* in;
    double* cleaned;
    unsigned char* nans;
    int* finite;
    FrameState* state;
    unsigned int* hist;         // nz x kBins (null when no frame needs one)
    unsigned long long* cand;   // nz x cand_cap
    unsigned int* orphan;       // nz x orphan_cap
    long long cells;
    int ny;
    int nx;
    int cand_cap;
    int orphan_cap;
    int z0;
};

struct Layout {
    long long cand_cap, orphan_cap, hist_bytes, cand_bytes, orphan_bytes,
        total;
};

Layout layout(int nz, long long cells) {
    Layout l;
    l.cand_cap = cells < kCandidates ? cells : kCandidates;
    l.orphan_cap = cells < kOrphanList ? cells : kOrphanList;
    const long long states = (long long)nz * sizeof(FrameState);
    // a frame of kCandidates cells or fewer is gathered whole: no histogram
    l.hist_bytes = cells > kCandidates
                       ? (long long)nz * kBins * sizeof(unsigned int) : 0;
    l.cand_bytes = (long long)nz * l.cand_cap * sizeof(unsigned long long);
    l.orphan_bytes = (long long)nz * l.orphan_cap * sizeof(unsigned int);
    l.total = states + l.hist_bytes + l.cand_bytes + l.orphan_bytes;
    return l;
}

// Finite doubles in the order of unsigned 64-bit keys.
__device__ __forceinline__ unsigned long long order_key(double v) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(v);
    return (b & kSign) ? ~b : (b | kSign);
}

__device__ __forceinline__ double key_value(unsigned long long k) {
    return __longlong_as_double((long long)((k & kSign) ? (k & ~kSign) : ~k));
}

// Whether `key` lies under the top `bits` bits of `prefix`.
__device__ __forceinline__ bool under(unsigned long long key,
                                      unsigned long long prefix, int bits) {
    return bits == 0 || ((key ^ prefix) >> (64 - bits)) == 0;
}

__device__ __forceinline__ unsigned int warp_sum(unsigned int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// The block's sum, in thread 0.
__device__ unsigned int block_sum(unsigned int v, unsigned int* warps) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
    __syncthreads();
    unsigned int total = 0;
    if (threadIdx.x < 32) {
        total = threadIdx.x < kThreads / 32 ? warps[threadIdx.x] : 0u;
        total = warp_sum(total);
    }
    __syncthreads();
    return total;
}

// The block's exclusive prefix sum of `v` in thread order.
__device__ unsigned int block_exclusive_scan(unsigned int v,
                                             unsigned int* warps) {
    const int lane = threadIdx.x & 31;
    unsigned int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warps[threadIdx.x >> 5] = x;
    __syncthreads();
    unsigned int before = 0;
    for (int w = 0; w < (int)(threadIdx.x >> 5); ++w) before += warps[w];
    __syncthreads();
    return before + x - v;
}

// Whether this block is the last of the `blocks` of its frame to arrive
// at `counter`; every thread's earlier writes are visible to that block.
__device__ bool last_block(unsigned int* counter, unsigned int blocks) {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == blocks - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// The mean of the finite cells of the clipped 3x3 neighbourhood of cell
// i, in the plain version's order; NaN where there is none.
__device__ double neighbour_mean(const double* f, long long i, int ny,
                                 int nx) {
    const int y = (int)(i / nx);
    const int x = (int)(i - (long long)y * nx);
    double s = 0.0;
    double n = 0.0;
    for (int dy = -1; dy <= 1; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= ny) continue;
        for (int dx = -1; dx <= 1; ++dx) {
            const int xx = x + dx;
            if (xx < 0 || xx >= nx) continue;
            const double w = __ldg(f + (long long)yy * nx + xx);
            if (isfinite(w)) {
                s += w;
                n += 1.0;
            }
        }
    }
    return n > 0.0 ? s / n : __longlong_as_double(0x7ff8000000000000ll);
}

// The frame's flags, and the start of its selection where it has
// orphans; run by the last block of the stencil pass.
__device__ void start_selection(const Params& p, int z, FrameState* st) {
    volatile FrameState* vs = st;
    const unsigned int finite = vs->finite;
    const unsigned int orphans = vs->orphans;
    if (threadIdx.x == 0) p.finite[z] = (int)finite;
    if (orphans == 0) return;
    const bool gather = finite <= (unsigned int)p.cand_cap;
    if (finite > 0 && !gather) {
        unsigned int* hist = p.hist + (long long)z * kBins;
        for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
    }
    if (threadIdx.x == 0) {
        if (finite == 0) {
            st->median = 0.0;
            st->mode = kDone;
        } else {
            st->rank = (finite - 1) / 2;
            st->count = finite;
            st->hi_mode = finite % 2 ? kHiSame : kHiNext;
            st->mode = gather ? kGather : kHist;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
map_infill_stencil_kernel(const __grid_constant__ Params p) {
    __shared__ unsigned int warps[kThreads / 32];
    const int z = p.z0 + blockIdx.y;
    const long long base = (long long)z * p.cells;
    const double* f = p.in + base;
    FrameState* st = p.state + z;
    const long long start = (long long)blockIdx.x * kStencilCells;
    double v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const long long i = start + k * kThreads + threadIdx.x;
        v[k] = i < p.cells ? __ldg(f + i) : 0.0;
    }
    unsigned int finite = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const long long i = start + k * kThreads + threadIdx.x;
        if (i >= p.cells) continue;
        double c = v[k];
        const bool is_nan = isnan(c);
        if (isfinite(c)) {
            ++finite;
        } else {
            c = neighbour_mean(f, i, p.ny, p.nx);
            if (isnan(c)) {
                const unsigned int slot = atomicAdd(&st->orphans, 1u);
                if (slot < (unsigned int)p.orphan_cap) {
                    p.orphan[(long long)z * p.orphan_cap + slot] =
                        (unsigned int)i;
                }
            }
        }
        p.cleaned[base + i] = c;
        p.nans[base + i] = is_nan;
    }
    finite = block_sum(finite, warps);
    if (threadIdx.x == 0 && finite) atomicAdd(&st->finite, finite);
    if (last_block(&st->stencil_done, gridDim.x)) start_selection(p, z, st);
}

// The last block's step after a histogram pass: the bucket of the lower
// middle's rank, and the next state.
__device__ void choose_bucket(const Params& p, int z, FrameState* st,
                              unsigned int* hist, unsigned int* warps,
                              int hi_mode) {
    __shared__ int s_bucket, s_next;
    __shared__ unsigned int s_rank, s_count;
    const int bits = st->bits;
    const int digit = min(kDigitBits, 64 - bits);
    const int shift = 64 - bits - digit;
    const int n_bins = 1 << digit;
    unsigned int* ghist = p.hist + (long long)z * kBins;
    for (int b = threadIdx.x; b < kBins; b += kThreads) {
        hist[b] = b < n_bins ? __ldcg(ghist + b) : 0u;
    }
    if (threadIdx.x == 0) s_next = kBins;
    __syncthreads();
    constexpr int kRun = kBins / kThreads;
    const int first = threadIdx.x * kRun;
    unsigned int local = 0;
    for (int b = first; b < first + kRun; ++b) local += hist[b];
    const unsigned int before = block_exclusive_scan(local, warps);
    const unsigned int rank = st->rank;
    if (before <= rank && rank < before + local) {
        unsigned int cum = before;
        for (int b = first; b < first + kRun; ++b) {
            if (rank < cum + hist[b]) {
                s_bucket = b;
                s_rank = rank - cum;
                s_count = hist[b];
                break;
            }
            cum += hist[b];
        }
    }
    __syncthreads();
    const int bucket = s_bucket;
    // the upper middle leaves the bucket when the lower one is its last key
    const bool next = hi_mode == kHiNext && s_rank + 1 == s_count;
    if (next) {
        for (int b = max(first, bucket + 1); b < first + kRun; ++b) {
            if (hist[b]) {
                atomicMin(&s_next, b);
                break;
            }
        }
    }
    __syncthreads();
    const bool more = bits + digit < 64 && s_count > (unsigned int)p.cand_cap;
    if (threadIdx.x == 0) {
        const unsigned long long prefix =
            st->prefix | ((unsigned long long)bucket << shift);
        if (next) {
            st->hi_prefix =
                st->prefix | ((unsigned long long)s_next << shift);
            st->hi_bits = bits + digit;
            st->hi_min = kNoKey;
            st->hi_mode = kHiPending;
        }
        st->prefix = prefix;
        st->bits = bits + digit;
        st->rank = s_rank;
        st->count = s_count;
        if (bits + digit == 64) {
            // every key under the prefix is the lower middle
            st->lo_key = prefix;
            if (hi_mode == kHiNext && !next) {
                st->hi_key = prefix;
                st->hi_mode = kHiKnown;
            }
            st->mode = kDone;
        } else if (!more) {
            st->n_cand = 0;
            st->mode = kGather;
        }
    }
    if (more) {
        for (int b = threadIdx.x; b < kBins; b += kThreads) ghist[b] = 0u;
    }
}

// The last block's step after a gather: sort the keys, read both ranks.
__device__ void choose_gathered(const Params& p, int z, FrameState* st,
                                unsigned long long* keys, int hi_mode) {
    const unsigned int n =
        min(((volatile FrameState*)st)->n_cand, (unsigned int)p.cand_cap);
    unsigned int size = 2;
    while (size < n) size <<= 1;
    const unsigned long long* cand = p.cand + (long long)z * p.cand_cap;
    for (unsigned int i = threadIdx.x; i < size; i += kThreads) {
        keys[i] = i < n ? __ldcg(cand + i) : kNoKey;
    }
    __syncthreads();
    for (unsigned int k = 2; k <= size; k <<= 1) {
        for (unsigned int j = k >> 1; j > 0; j >>= 1) {
            for (unsigned int i = threadIdx.x; i < size; i += kThreads) {
                const unsigned int l = i ^ j;
                if (l > i) {
                    const unsigned long long a = keys[i], b = keys[l];
                    if (((i & k) == 0) ? a > b : a < b) {
                        keys[i] = b;
                        keys[l] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    if (threadIdx.x == 0) {
        const unsigned int rank = st->rank;
        st->lo_key = keys[rank];
        if (hi_mode == kHiNext) {
            st->hi_key = keys[rank + 1];
            st->hi_mode = kHiKnown;
        }
        st->mode = kDone;
    }
}

__global__ void __launch_bounds__(kThreads)
map_infill_select_kernel(const __grid_constant__ Params p) {
    // the block's histogram, or the last block's sorted keys
    __shared__ unsigned long long smem[kCandidates];
    __shared__ unsigned int warps[kThreads / 32];
    __shared__ unsigned long long mins[kThreads / 32];
    unsigned int* hist = reinterpret_cast<unsigned int*>(smem);
    const int z = p.z0 + blockIdx.y;
    FrameState* st = p.state + z;
    const int mode = st->mode;
    const int hi_mode = st->hi_mode;
    const bool histogram = mode == kHist;
    const bool gather = mode == kGather;
    const bool pending = hi_mode == kHiPending;
    if (!histogram && !gather && !pending) return;
    const int bits = st->bits;
    const int digit = min(kDigitBits, 64 - bits);
    const int shift = 64 - bits - digit;
    const unsigned long long mask = (1ull << digit) - 1;
    const unsigned long long prefix = st->prefix;
    const unsigned long long hi_prefix = st->hi_prefix;
    const int hi_bits = st->hi_bits;
    if (histogram) {
        for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0u;
        __syncthreads();
    }
    const double* f = p.in + (long long)z * p.cells;
    unsigned long long* cand = p.cand + (long long)z * p.cand_cap;
    const long long chunk = (p.cells + gridDim.x - 1) / gridDim.x;
    const long long start = (long long)blockIdx.x * chunk;
    const long long end = min(start + chunk, p.cells);
    unsigned long long least = kNoKey;
    for (long long i0 = start; i0 < end; i0 += kSelectLoads * kThreads) {
        double v[kSelectLoads];
#pragma unroll
        for (int k = 0; k < kSelectLoads; ++k) {
            const long long i = i0 + k * kThreads + threadIdx.x;
            v[k] = i < end ? __ldg(f + i) : __longlong_as_double(
                                                0x7ff8000000000000ll);
        }
#pragma unroll
        for (int k = 0; k < kSelectLoads; ++k) {
            unsigned int bin = kNoBin;
            if (isfinite(v[k])) {
                const unsigned long long key = order_key(v[k]);
                if (under(key, prefix, bits)) {
                    if (histogram) {
                        bin = (unsigned int)((key >> shift) & mask);
                    } else if (gather) {
                        const unsigned int slot = atomicAdd(&st->n_cand, 1u);
                        if (slot < (unsigned int)p.cand_cap) cand[slot] = key;
                    }
                }
                if (pending && under(key, hi_prefix, hi_bits) && key < least) {
                    least = key;
                }
            }
            if (histogram) {
                // the lanes of a warp that count one bin add to it once
                const unsigned int peers = __match_any_sync(0xffffffffu, bin);
                if (bin != kNoBin &&
                    (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
                    atomicAdd(&hist[bin], (unsigned int)__popc(peers));
                }
            }
        }
    }
    __syncthreads();
    if (histogram) {
        unsigned int* ghist = p.hist + (long long)z * kBins;
        for (int b = threadIdx.x; b < kBins; b += kThreads) {
            if (hist[b]) atomicAdd(ghist + b, hist[b]);
        }
    }
    if (pending) {
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long other =
                __shfl_down_sync(0xffffffffu, least, o);
            least = other < least ? other : least;
        }
        if ((threadIdx.x & 31) == 0) mins[threadIdx.x >> 5] = least;
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int w = 1; w < kThreads / 32; ++w) {
                least = mins[w] < least ? mins[w] : least;
            }
            if (least != kNoKey) atomicMin(&st->hi_min, least);
        }
    }
    if (!last_block(&st->select_done, gridDim.x)) return;
    // the last block of the frame: the next state
    if (threadIdx.x == 0) st->select_done = 0;
    if (pending && threadIdx.x == 0) {
        st->hi_key = ((volatile FrameState*)st)->hi_min;
        st->hi_mode = kHiKnown;
    }
    __syncthreads();
    if (histogram) {
        choose_bucket(p, z, st, hist, warps, hi_mode);
    } else if (gather) {
        choose_gathered(p, z, st, smem, hi_mode);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const int now = st->hi_mode;
        if (st->mode == kDone && now != kHiPending) {
            const double lo = key_value(st->lo_key);
            const double hi = now == kHiSame ? lo : key_value(st->hi_key);
            st->median = (lo + hi) / 2.0;
        }
    }
}

__global__ void __launch_bounds__(kThreads)
map_infill_fill_kernel(const __grid_constant__ Params p) {
    const int z = p.z0 + blockIdx.y;
    const FrameState* st = p.state + z;
    const unsigned int orphans = st->orphans;
    if (orphans == 0) return;
    const double median = st->median;
    double* out = p.cleaned + (long long)z * p.cells;
    if (orphans <= (unsigned int)p.orphan_cap) {
        if (blockIdx.x != 0) return;
        const unsigned int* list = p.orphan + (long long)z * p.orphan_cap;
        for (unsigned int j = threadIdx.x; j < orphans; j += kThreads) {
            out[list[j]] = median;
        }
        return;
    }
    const long long start = (long long)blockIdx.x * kStencilCells;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const long long i = start + k * kThreads + threadIdx.x;
        if (i < p.cells && isnan(out[i])) out[i] = median;
    }
}

}  // namespace

extern "C" {

// Bytes of the workspace map_infill_launch takes for nz frames of `cells`
// cells: the frames' states, the histograms, the gathered keys and the
// orphan lists.
long long map_infill_workspace_bytes(int nz, long long cells) {
    return layout(nz, cells).total;
}

// Launch on `stream`. Every pointer is a device pointer: `in` the nz x ny
// x nx float64 frames, contiguous; `cleaned` float64 and `nans` one byte a
// cell, of the same shape; `finite` (int32) one a frame; `workspace` map_infill_workspace_bytes(nz, ny * nx) bytes or
// more, 128-byte aligned. Returns cudaErrorInvalidValue for a short or
// misaligned workspace or a frame of 2^31 cells or more, else the first
// error of the memset and the launches.
int map_infill_launch(const double* in, double* cleaned, unsigned char* nans,
                      int* finite, void* workspace,
                      long long workspace_bytes, int nz, int ny, int nx,
                      void* stream) {
    const long long cells = (long long)ny * nx;
    if (nz < 0 || ny < 0 || nx < 0 || cells >= (1ll << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    if (nz == 0 || cells == 0) return (int)cudaSuccess;
    const Layout l = layout(nz, cells);
    if (workspace_bytes < l.total || (uintptr_t)workspace % 128) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    char* w = (char*)workspace;
    Params p;
    p.in = in;
    p.cleaned = cleaned;
    p.nans = nans;
    p.finite = finite;
    p.state = (FrameState*)w;
    w += (long long)nz * sizeof(FrameState);
    p.hist = l.hist_bytes ? (unsigned int*)w : nullptr;
    w += l.hist_bytes;
    p.cand = (unsigned long long*)w;
    w += l.cand_bytes;
    p.orphan = (unsigned int*)w;
    p.cells = cells;
    p.ny = ny;
    p.nx = nx;
    p.cand_cap = (int)l.cand_cap;
    p.orphan_cap = (int)l.orphan_cap;
    cudaError_t rc = cudaMemsetAsync(p.state, 0,
                                     (size_t)nz * sizeof(FrameState), s);
    if (rc != cudaSuccess) return (int)rc;
    const unsigned int stencil_blocks =
        (unsigned int)((cells + kStencilCells - 1) / kStencilCells);
    long long select = (cells + kSelectCells - 1) / kSelectCells;
    const unsigned int select_blocks =
        (unsigned int)(select < kSelectBlocks ? select : kSelectBlocks);
    for (int z0 = 0; z0 < nz; z0 += kMaxGridY) {
        p.z0 = z0;
        const unsigned int frames =
            (unsigned int)(nz - z0 < kMaxGridY ? nz - z0 : kMaxGridY);
        map_infill_stencil_kernel<<<dim3(stencil_blocks, frames), kThreads,
                                    0, s>>>(p);
    }
    for (int pass = 0; pass < kSelectPasses; ++pass) {
        for (int z0 = 0; z0 < nz; z0 += kMaxGridY) {
            p.z0 = z0;
            const unsigned int frames =
                (unsigned int)(nz - z0 < kMaxGridY ? nz - z0 : kMaxGridY);
            map_infill_select_kernel<<<dim3(select_blocks, frames), kThreads,
                                       0, s>>>(p);
        }
    }
    for (int z0 = 0; z0 < nz; z0 += kMaxGridY) {
        p.z0 = z0;
        const unsigned int frames =
            (unsigned int)(nz - z0 < kMaxGridY ? nz - z0 : kMaxGridY);
        map_infill_fill_kernel<<<dim3(stencil_blocks, frames), kThreads, 0,
                                 s>>>(p);
    }
    return (int)cudaGetLastError();
}

// Registers and local (spill) bytes per thread of the stencil and the
// selection kernels, and their resident blocks per SM. Returns a
// cudaError_t.
int map_infill_occupancy(int* registers, int* local_bytes, int* blocks_per_sm) {
    const void* kernels[2] = {(const void*)map_infill_stencil_kernel,
                              (const void*)map_infill_select_kernel};
    for (int k = 0; k < 2; ++k) {
        cudaFuncAttributes attr;
        cudaError_t rc = cudaFuncGetAttributes(&attr, kernels[k]);
        if (rc != cudaSuccess) return (int)rc;
        registers[k] = attr.numRegs;
        local_bytes[k] = (int)attr.localSizeBytes;
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm + k, kernels[k], kThreads, 0);
        if (rc != cudaSuccess) return (int)rc;
    }
    return (int)cudaSuccess;
}

}  // extern "C"
