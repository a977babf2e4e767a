// One axis pass of the PCHIP oversampling of BodyXY.map_img(...,
// interpolation='smooth'): every line of a cube of frames (box rows, or the
// columns of the row pass's output) is interpolated over its finite cells
// by scipy's PchipInterpolator(extrapolate=False) and evaluated at n_eval
// positions, k_rep to a cell, in one launch.
//
// Replaces the XLA prologue of the TPU 'smooth' sampler:
// planetmapper_tpu/ops/pchip_device.py _pchip_axis (:89), which the JAX
// package runs twice per frame (:564-575, box -> rows -> columns) in front
// of the Pallas kernel of smooth_pallas.py. The plain version is
// _pchip_axis in planetmapper_tpu_torch/ops/pchip_kernel.py; this kernel
// follows its float64 arithmetic operation by operation and is built with
// -fmad=false, so that no multiply-add is contracted where the plain
// version rounds twice.
//
// What the function needs per line: the nearest finite cell before and
// after each cell (NaN gaps of any length are bridged), a derivative per
// finite cell from its finite neighbours (Fritsch-Carlson inside, scipy's
// one-sided three-point estimate at the two ends), and a cubic Hermite
// value per position between two finite cells. Positions outside the
// finite span are NaN, a position on a finite cell is that cell's value,
// and a line with fewer than two finite cells is all NaN.
//
// Design (second version): work parallel over cells and positions, not
// over segments of a line.
// - A block takes kAdjacentLines lines when they are adjacent in memory
//   (the columns of a row-major grid: each load of a cell and each store
//   of a position is one 32-byte sector of the block's lines), else one
//   (a row: a warp loads and stores 32 adjacent values); the wrapper
//   chooses (ops/pchip_kernel.py lines_per_block). It stages a chunk of
//   kCells cells over its lines in shared memory, each line's as slots
//   [b0, b1, the chunk's cells, a0, a1]: the last two finite cells before
//   the chunk (carried from the previous one) and the first two at or
//   after its end (one warp a line finds them with ballots, however long
//   the NaN gap). So any line length runs, in chunks, and every neighbour
//   a derivative or a position needs is a slot: no lookup branches.
// - One step scans each line's nearest finite slot at or before and at or
//   after every slot (a run of slots a thread, warp shuffles across the
//   runs, the line's warps' totals across warps); one step computes each
//   finite slot's derivative once (b1's and a0's included) into shared
//   memory.
// - Every position whose floor cell lies in the chunk is then evaluated on
//   its own, from its two slots' value, index and derivative: in a row
//   pass a position a thread (its cell and remainder stepped, not
//   divided), in a column pass a cell a thread, whose k positions share one
//   load of their interval.
//
// What bounds it on this card: the bound (testing/bounds.py:
// pchip_call_bound) is the box read once and the oversampled grid written
// once (8 bytes a position: the 150^2 frame's 611x641 grid is 3.1 MB,
// 0.97 us), at ~8 float64 operations a position. The kernel repeats the
// plain version's arithmetic to be bit for bit with it: ~25 float64
// instructions a position (no contraction), and its row pass writes an
// intermediate that the column pass reads back. On an H100 80GB HBM3 at
// 700 W (scripts/time_pchip.py, in turns with the first design, which
// walked segments of 2 cells with a window of four):
// - the 150^2 frame (two launches; ~2.5 us each is the launch floor):
//   18.66 us cold, 14.78 us warm, against 19.62 / 16.00 us: phases of
//   ~0.5-1 us latency each (the staging's loads, five barriers, the
//   derivatives' divisions) in ~160 blocks;
// - the 1024^2 8-frame cube: 1.64 ms against 1.81 ms, 19.5% of its 0.32
//   ms bound. With a position a thread in both passes the column pass was
//   1.45 of 1.66 ms, and the whole 1.30 ms with its stores removed: the
//   time is instruction work and latency, not bytes.
// Candidates that lost (same script): a position a thread in both passes
// (20.76 us at 150^2, 1.66 ms on the cube), a cell a thread in both
// (18.26 us, 1.77 ms; its row pass stores 40 bytes apart in a warp), 128
// threads a block (24.6 us), 512 cells a block (1.70 ms), 8 adjacent
// lines a block (22.7 us at 150^2 but 1.41 ms on the cube), both passes in
// one cooperative launch with a grid barrier between them (19.5 us, 2.66
// ms). The first design with 16 or 32 adjacent lines a block (256-byte
// accesses) gained 0.3 ms on the cube's column pass only.
//
// Built by planetmapper_tpu_torch/ops/pchip_kernel.py (through
// ops/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false
// and called through ctypes (plain C interface at the bottom).

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads of a block
constexpr int kCells = 1024;       // cells a block stages, all its lines
constexpr int kAdjacentLines = 4;  // lines a block when adjacent in memory
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kCells + 4 * kAdjacentLines;  // the chunks and halos
constexpr unsigned kFull = 0xffffffffu;

struct Params {
    const double* in;   // cell (f, l, i) at f*in_frame + l*in_line + i*in_cell
    const double* xs;   // the n_eval positions, in cells
    double* out;        // position (f, l, e) at f*out_frame + l*out_line + e*out_pos
    int64_t n_lines;    // frames x lines per frame
    int64_t lines;      // lines per frame
    int64_t in_frame, in_line, in_cell;
    int64_t out_frame, out_line, out_pos;
    int n;              // cells per line
    int n_eval;         // positions per line, (n - 1) * k_rep + 1
    int k_rep;          // positions per cell
};

// One finite cell: its index (-1 when absent) and value.
struct Cell {
    int i;
    double v;
};

__device__ __forceinline__ double sign_of(double x) {
    return (double)((x > 0.0) - (x < 0.0));
}

// a / h; a division by 1 is exact, and skipped
__device__ __forceinline__ double per(double a, double h) {
    return h == 1.0 ? a : a / h;
}

// scipy PchipInterpolator._edge_case (the plain _edge_derivative).
__device__ __forceinline__ double edge_derivative(double h0, double d0,
                                                  double h1, double d1) {
    double d = ((2.0 * h0 + h1) * d0 - h0 * d1) / (h0 + h1);
    const bool over = sign_of(d0) != sign_of(d1) && fabs(d) > 3.0 * fabs(d0);
    if (sign_of(d) != sign_of(d0)) d = 0.0;
    return over ? 3.0 * d0 : d;
}

// The derivative at c from its finite neighbours: p before it, q after
// it, pp before p and qq after q (scipy _find_derivatives and the edge
// cases, as the plain version computes them).
__device__ double derivative(Cell pp, Cell p, Cell c, Cell q, Cell qq) {
    const double xc = (double)c.i;
    const double h_prev = p.i >= 0 ? xc - (double)p.i : 1.0;
    const double d_prev = p.i >= 0 ? per(c.v - p.v, h_prev) : 0.0;
    const double h_next = q.i >= 0 ? (double)q.i - xc : 1.0;
    const double d_next = q.i >= 0 ? per(q.v - c.v, h_next) : 0.0;
    if (p.i >= 0 && q.i >= 0) {
        if (!(d_prev * d_next > 0.0)) return 0.0;
        const double w1 = 2.0 * h_next + h_prev;
        const double w2 = h_next + 2.0 * h_prev;
        return (w1 + w2) / (w1 / d_prev + w2 / d_next);
    }
    if (q.i >= 0) {
        const double h = qq.i >= 0 ? (double)qq.i - (double)q.i : h_next;
        const double d = qq.i >= 0 ? per(qq.v - q.v, h) : d_next;
        return edge_derivative(h_next, d_next, h, d);
    }
    if (p.i >= 0) {
        const double h = pp.i >= 0 ? (double)p.i - (double)pp.i : h_prev;
        const double d = pp.i >= 0 ? per(p.v - pp.v, h) : d_prev;
        return edge_derivative(h_prev, d_prev, h, d);
    }
    return 0.0;
}

// What a block holds of its lines: line j's slots from j * (chunk + 4),
// laid out [b0, b1, cells a..b-1 of the chunk, a0, a1]: the last two
// finite cells before the chunk, the chunk, the first two finite cells at
// or after its end (absent ones NaN). Per slot: the value, its cell's index
// in the line, the nearest finite slot at or before it and at or after it
// (-1 when none), and, for a finite slot, the derivative there.
struct Lines {
    double v[kSlots];
    double d[kSlots];
    int cell[kSlots];
    short prev[kSlots];
    short next[kSlots];
    int warp_prev[kWarps];
    int warp_next[kWarps];
};

__device__ __forceinline__ Cell slot_cell(const Lines& s, int base,
                                          int slot) {
    if (slot < 0) return Cell{-1, 0.0};
    return Cell{s.cell[base + slot], s.v[base + slot]};
}

// The cubic between two finite slots i0 < i1 of a line (from slot line0).
struct Interval {
    double xl, h, v0, v1, d0, d1;

    // its value at x, as the plain version computes it
    __device__ __forceinline__ double at(double x) const {
        const double tt = per(x - xl, h);
        const double t2 = tt * tt;
        const double t3 = t2 * tt;
        return v0 * (2.0 * t3 - 3.0 * t2 + 1.0) +
               h * d0 * (t3 - 2.0 * t2 + tt) +
               v1 * (-2.0 * t3 + 3.0 * t2) + h * d1 * (t3 - t2);
    }
};

__device__ __forceinline__ Interval interval(const Lines& s, int line0,
                                             int i0, int i1) {
    const double xl = (double)s.cell[line0 + i0];
    return Interval{xl, (double)s.cell[line0 + i1] - xl, s.v[line0 + i0],
                    s.v[line0 + i1], s.d[line0 + i0], s.d[line0 + i1]};
}

// The value at position e, whose nearest finite slots are i0 at or before
// its floor cell and i1 at or after its ceiling cell (-1 when none).
__device__ __forceinline__ double position(const Lines& s, const Params& p,
                                           int line0, int i0, int i1,
                                           int e) {
    if (i0 < 0 || i1 < 0) {
        return __longlong_as_double(0x7ff8000000000000ll);  // outside
    }
    if (i0 == i1) {
        // on a finite cell (h == 0 in the plain version); NaN when it is
        // the line's only one (scipy skips lines with < 2 finite cells)
        return s.prev[line0 + i0 - 1] >= 0 || s.next[line0 + i0 + 1] >= 0
                   ? s.v[line0 + i0]
                   : __longlong_as_double(0x7ff8000000000000ll);
    }
    return interval(s, line0, i0, i1).at(__ldg(p.xs + e));
}

// The lines of block group `group` (lines group * L on): chunk by chunk,
// the chunk and its four neighbours staged, the nearest finite slots
// scanned, each finite slot's derivative computed once, then every
// position whose floor cell lies in the chunk evaluated on its own.
template <int L>
__device__ __forceinline__ void pchip_lines(const Params& p, int64_t group,
                                            Lines& s) {
    constexpr int kPerLine = kThreads / L;  // a line's threads
    const int t = threadIdx.x;
    const int lane = t % 32, warp = t / 32;
    const int C = kCells / L;
    const int W = C + 4;  // slots of a line
    const double qnan = __longlong_as_double(0x7ff8000000000000ll);
    const int k = p.k_rep;
    const int step_cells = kPerLine / k, step_rest = kPerLine % k;

    // this thread's line in the scans, and in the stores
    const int js = t / kPerLine, seg = t % kPerLine;
    const int je = t % L;
    const int64_t ge = group * L + je;
    const bool live_e = ge < p.n_lines;
    double* __restrict__ out = p.out;
    if (live_e) {
        const int64_t f = ge / p.lines;
        out += f * p.out_frame + (ge - f * p.lines) * p.out_line;
    }
    if (t < L) {
        s.v[t * W] = qnan;
        s.v[t * W + 1] = qnan;
    }

    for (int a = 0; a < p.n; a += C) {
        const int b = min(a + C, p.n);
        const int m = b - a;
        const int n_slots = m + 4;
        // -- stage the chunk: adjacent lines' cells are adjacent loads ---
        for (int u = t; u < L * m; u += kThreads) {
            const int j = u % L, i = u / L;
            const int64_t g = group * L + j;
            double v = qnan;
            if (g < p.n_lines) {
                const int64_t f = g / p.lines;
                v = __ldg(p.in + f * p.in_frame
                          + (g - f * p.lines) * p.in_line
                          + (int64_t)(a + i) * p.in_cell);
            }
            s.v[j * W + 2 + i] = v;
            s.cell[j * W + 2 + i] = a + i;
        }
        // -- the first two finite cells at or after b: warp j, line j ----
        if (warp < L) {
            Cell c0{-1, qnan}, c1{-1, qnan};
            const int64_t g = group * L + warp;
            if (g < p.n_lines) {
                const int64_t f = g / p.lines;
                const double* __restrict__ line =
                    p.in + f * p.in_frame + (g - f * p.lines) * p.in_line;
                for (int w = b; w < p.n && c1.i < 0; w += 32) {
                    const int i = w + lane;
                    const double v = i < p.n ? line[(int64_t)i * p.in_cell]
                                             : qnan;
                    unsigned found = __ballot_sync(kFull, isfinite(v));
                    while (found != 0u && c1.i < 0) {
                        const int l = __ffs(found) - 1;
                        found &= found - 1u;
                        const Cell c{w + l, __shfl_sync(kFull, v, l)};
                        if (c0.i < 0) {
                            c0 = c;
                        } else {
                            c1 = c;
                        }
                    }
                }
            }
            if (lane == 0) {
                s.v[warp * W + m + 2] = c0.v;
                s.cell[warp * W + m + 2] = c0.i;
                s.v[warp * W + m + 3] = c1.v;
                s.cell[warp * W + m + 3] = c1.i;
            }
        }
        __syncthreads();

        // -- nearest finite slots: each thread a run of its line's slots,
        //    scanned across the line's threads by warp shuffles ----------
        const int run = (n_slots + kPerLine - 1) / kPerLine;
        const int lo = min(seg * run, n_slots), hi = min(lo + run, n_slots);
        const int base = js * W;
        int last = -1, first = kSlots;
        for (int i = lo; i < hi; ++i) {
            if (isfinite(s.v[base + i])) {
                if (first == kSlots) first = i;
                last = i;
            }
        }
        int up = last, down = first;
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(kFull, up, o);
            const int y = __shfl_down_sync(kFull, down, o);
            if (lane >= o) up = max(up, x);
            if (lane + o < 32) down = min(down, y);
        }
        if (lane == 31) s.warp_prev[warp] = up;
        if (lane == 0) s.warp_next[warp] = down;
        __syncthreads();
        {
            int r = __shfl_up_sync(kFull, up, 1);
            int q = __shfl_down_sync(kFull, down, 1);
            if (lane == 0) r = -1;
            if (lane == 31) q = kSlots;
            const int w0 = js * (kPerLine / 32);
            for (int w = w0; w < warp; ++w) r = max(r, s.warp_prev[w]);
            for (int w = warp + 1; w < w0 + kPerLine / 32; ++w) {
                q = min(q, s.warp_next[w]);
            }
            for (int i = lo; i < hi; ++i) {
                if (isfinite(s.v[base + i])) r = i;
                s.prev[base + i] = (short)r;
            }
            for (int i = hi - 1; i >= lo; --i) {
                if (isfinite(s.v[base + i])) q = i;
                s.next[base + i] = (short)(q < kSlots ? q : -1);
            }
        }
        __syncthreads();

        // -- each finite slot's derivative, once: b1, the chunk's, a0 -----
        for (int i = max(lo, 1); i < min(hi, m + 3); ++i) {
            if (!isfinite(s.v[base + i])) continue;
            const int pv = s.prev[base + i - 1];
            const int pp = pv >= 1 ? s.prev[base + pv - 1] : -1;
            const int nx = s.next[base + i + 1];
            const int qq = nx >= 0 && nx + 1 < n_slots ? s.next[base + nx + 1]
                                                       : -1;
            s.d[base + i] = derivative(
                slot_cell(s, base, pp), slot_cell(s, base, pv),
                slot_cell(s, base, i), slot_cell(s, base, nx),
                slot_cell(s, base, qq));
        }
        __syncthreads();

        // -- the positions whose floor cell lies in the chunk -----------
        if (live_e) {
            const int line0 = je * W;
            if constexpr (L == 1) {
                // a position a thread: a warp stores 32 adjacent values
                const int e0 = a * k;
                const int n_pos = min(b * k, p.n_eval) - e0;
                int pos = t / L;
                int cl = (e0 + pos) / k, rest = (e0 + pos) % k;
#pragma unroll 4
                for (; pos < n_pos; pos += kPerLine) {
                    const int at = line0 + cl - a + 2;
                    out[(int64_t)(e0 + pos) * p.out_pos] = position(
                        s, p, line0, s.prev[at], s.next[at + (rest != 0)],
                        e0 + pos);
                    cl += step_cells;
                    rest += step_rest;
                    if (rest >= k) {
                        rest -= k;
                        ++cl;
                    }
                }
            } else {
                // a cell a thread, its k positions from one load of its
                // interval: the block's lines' values are adjacent stores
                for (int c = a + t / L; c < b; c += kPerLine) {
                    const int at = line0 + c - a + 2;
                    const int64_t e = (int64_t)c * k;
                    const int i0 = s.prev[at];
                    out[e * p.out_pos] = position(s, p, line0, i0, s.next[at],
                                                  (int)e);
                    if (c == p.n - 1) continue;
                    const int i1 = s.next[at + 1];
                    if (i0 < 0 || i1 < 0) {
                        for (int q = 1; q < k; ++q) {
                            out[(e + q) * p.out_pos] = qnan;
                        }
                        continue;
                    }
                    const Interval iv = interval(s, line0, i0, i1);
                    for (int q = 1; q < k; ++q) {
                        out[(e + q) * p.out_pos] =
                            iv.at(__ldg(p.xs + e + q));
                    }
                }
            }
        }

        // -- the last two finite cells before the next chunk --------------
        int nb0 = -1, nb1 = -1;
        Cell c0{-1, qnan}, c1{-1, qnan};
        if (seg == 0 && b < p.n) {
            nb1 = s.prev[base + m + 1];
            if (nb1 >= 2) {
                nb0 = s.prev[base + nb1 - 1];
                c1 = slot_cell(s, base, nb1);
                if (nb0 >= 0) c0 = slot_cell(s, base, nb0);
            }
        }
        __syncthreads();
        if (nb1 >= 2) {
            s.v[base] = c0.v;
            s.cell[base] = c0.i;
            s.v[base + 1] = c1.v;
            s.cell[base + 1] = c1.i;
        }
    }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
pchip_axis_kernel(const __grid_constant__ Params p) {
    __shared__ Lines s;
    pchip_lines<L>(p, blockIdx.x, s);
}

// The launch's parameters; false for n < 1, k_rep < 1, a wrong n_eval or
// lines_per_block.
bool fill_params(Params* p, const double* in, long long in_frame,
                 long long in_line, long long in_cell, const double* xs,
                 double* out, long long out_frame, long long out_line,
                 long long out_pos, int n_frames, long long lines, int n,
                 int n_eval, int k_rep, int lines_per_block) {
    if (n < 1 || k_rep < 1 || n_eval != (n - 1) * k_rep + 1
        || (lines_per_block != 1 && lines_per_block != kAdjacentLines)) {
        return false;
    }
    p->in = in;
    p->xs = xs;
    p->out = out;
    p->n_lines = (int64_t)n_frames * lines;
    p->lines = lines;
    p->in_frame = in_frame;
    p->in_line = in_line;
    p->in_cell = in_cell;
    p->out_frame = out_frame;
    p->out_line = out_line;
    p->out_pos = out_pos;
    p->n = n;
    p->n_eval = n_eval;
    p->k_rep = k_rep;
    return true;
}

}  // namespace

extern "C" {

// Launch on `stream`. Every pointer is a device pointer: `in` float64 at
// the strides given (in elements; a strided view, e.g. the image box, is
// read in place), `xs` the n_eval float64 positions, `out` float64 at its
// strides. Lines are (frame, line) pairs, n_frames x lines of them; each
// has n cells and n_eval = (n - 1) * k_rep + 1 positions. A block takes
// lines_per_block lines (1, or kAdjacentLines when they are adjacent in
// memory: the wrapper's choice, ops/pchip_kernel.py lines_per_block).
// Returns cudaErrorInvalidValue for n < 1, k_rep < 1, a wrong n_eval or
// lines_per_block, else cudaGetLastError() after the launch.
int pchip_axis_launch(const double* in, long long in_frame, long long in_line,
                      long long in_cell, const double* xs, double* out,
                      long long out_frame, long long out_line,
                      long long out_pos, int n_frames, long long lines, int n,
                      int n_eval, int k_rep, int lines_per_block,
                      void* stream) {
    Params p;
    if (!fill_params(&p, in, in_frame, in_line, in_cell, xs, out, out_frame,
                     out_line, out_pos, n_frames, lines, n, n_eval, k_rep,
                     lines_per_block)) {
        return (int)cudaErrorInvalidValue;
    }
    if (p.n_lines == 0) return (int)cudaSuccess;
    const unsigned grid = (unsigned)((p.n_lines + lines_per_block - 1) /
                                     lines_per_block);
    if (lines_per_block == 1) {
        pchip_axis_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    } else {
        pchip_axis_kernel<kAdjacentLines>
            <<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
    }
    return (int)cudaGetLastError();
}

// The layout's constants, which the wrapper checks against its own.
void pchip_layout(int* threads, int* cells, int* adjacent_lines) {
    *threads = kThreads;
    *cells = kCells;
    *adjacent_lines = kAdjacentLines;
}

// Registers and local (spill) bytes per thread of the compiled kernel's
// column-pass instance (kAdjacentLines lines a block) and its resident
// blocks per SM. Returns a cudaError_t.
int pchip_occupancy(int* registers, int* local_bytes, int* blocks_per_sm) {
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(
        &attr, pchip_axis_kernel<kAdjacentLines>);
    if (rc != cudaSuccess) return (int)rc;
    *registers = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, pchip_axis_kernel<kAdjacentLines>, kThreads, 0);
}

}  // extern "C"
