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
// Design:
// - A block takes 4 lines when the lines are adjacent in memory (the
//   columns of a row-major grid), else 1, and cuts each line into segments
//   of at least kMinSegment cells, up to kThreads threads a block: thread
//   (x, y) walks segment y of line x. In the column pass each load of one
//   cell and each store of one position is 4 adjacent values (one 32-byte
//   sector); in the row pass the lanes of a warp are the segments of one
//   row and L1 serves the following cells of each. Each thread's walk is a
//   chain of dependent float64 operations, so short segments (2 cells, 10
//   positions at k_rep = 5) and many small blocks put a frame's few lines
//   on every SM.
// - Pass 1: each thread reads its segment once and keeps its first two and
//   last two finite cells and their count in shared memory (72 bytes a
//   segment). After one barrier a thread knows the last two finite cells
//   before its segment and the first two after it, however long the NaN
//   gaps: no line is ever held whole, so any line length runs, in
//   segments.
// - Pass 2: each thread streams the finite cells of its segment (a second
//   read, from L1/L2), framed by those neighbours, through a window of four
//   (previous, left, right, next): each finite cell's derivative is
//   computed once, when the window passes it, and every position that the
//   segment owns (the positions whose floor cell lies in it) is evaluated
//   from the window's left and right cells and stored. A division by a
//   spacing of one cell (no NaN between) is skipped: it is exact.
//
// What bounds it on this card: the box read once and the oversampled grid
// written once (8 bytes a position; the 150^2 frame's 611x641 grid is 3.1
// MB) against ~30 float64 operations per position: memory traffic
// (testing/bounds.py:pchip_call_bound). The row pass writes an
// intermediate (n_box rows x n_eval) that the column pass reads back.
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

constexpr int kThreads = 512;    // threads per block at most
constexpr int kAdjacentLines = 4;  // lines per block when adjacent in memory
constexpr int kMinSegment = 2;     // cells per segment at least

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
    int segment;        // cells per segment
};

// One finite cell: its index (-1 when absent) and value.
struct Cell {
    int i;
    double v;
};

// The finite cells of one segment of one line.
struct Summary {
    int count;            // finite cells in the segment
    Cell first0, first1;  // the first two
    Cell last0, last1;    // the last two (last1 the last)
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

// The finite cells a thread streams: up to two before its segment (b0,
// b1 in order), the segment's own (read from the line), up to two after it
// (a0, a1).
struct Stream {
    Cell b0, b1, a0, a1;
    int n_before, n_after, next_before, next_after;
    int next_cell, end;  // the segment's cells still to read

    __device__ Cell next(const double* __restrict__ line, int64_t in_cell) {
        if (next_before < n_before) return next_before++ == 0 ? b0 : b1;
        while (next_cell < end) {
            const int i = next_cell++;
            const double v = line[i * in_cell];
            if (isfinite(v)) return Cell{i, v};
        }
        if (next_after < n_after) return next_after++ == 0 ? a0 : a1;
        return Cell{-1, 0.0};
    }
};

__global__ void __launch_bounds__(kThreads)
pchip_axis_kernel(Params p) {
    __shared__ Summary sums[kThreads];  // [segment][line in the block]
    const int x = threadIdx.x;  // line in the block
    const int y = threadIdx.y;  // segment of the line
    const int n_segments = blockDim.y;
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + x;
    const bool live = g < p.n_lines;
    const int64_t f = live ? g / p.lines : 0;
    const int64_t l = live ? g - f * p.lines : 0;
    const double* __restrict__ line = p.in + f * p.in_frame + l * p.in_line;
    const int a = min(y * p.segment, p.n);
    const int b = min(a + p.segment, p.n);
    const Cell none{-1, 0.0};

    // pass 1: the segment's finite cells
    Summary s{0, none, none, none, none};
    if (live) {
        for (int i = a; i < b; ++i) {
            const double v = line[i * p.in_cell];
            if (!isfinite(v)) continue;
            if (s.count == 0) s.first0 = Cell{i, v};
            if (s.count == 1) s.first1 = Cell{i, v};
            s.last0 = s.last1;
            s.last1 = Cell{i, v};
            ++s.count;
        }
    }
    sums[y * blockDim.x + x] = s;
    __syncthreads();
    if (!live || a >= b) return;

    // the finite cells around the segment
    Stream st{none, none, none, none, 0, 0, 0, 0, a, b};
    Cell near = none, far = none;  // the last and the one before it
    for (int u = y - 1; u >= 0 && st.n_before < 2; --u) {
        const Summary& t = sums[u * blockDim.x + x];
        if (t.count == 0) continue;
        if (st.n_before == 0) {
            near = t.last1;
            far = t.last0;
            st.n_before = t.count > 1 ? 2 : 1;
        } else {
            far = t.last1;
            st.n_before = 2;
        }
    }
    st.b0 = st.n_before == 2 ? far : near;
    st.b1 = near;
    for (int u = y + 1; u < n_segments && st.n_after < 2; ++u) {
        const Summary& t = sums[u * blockDim.x + x];
        if (t.count == 0) continue;
        if (st.n_after == 0) {
            st.a0 = t.first0;
            st.a1 = t.first1;
            st.n_after = t.count > 1 ? 2 : 1;
        } else {
            st.a1 = t.first0;
            st.n_after = 2;
        }
    }

    // pass 2: the owned positions [a k, min(b k, n_eval)), in order
    double* __restrict__ out = p.out + f * p.out_frame + l * p.out_line;
    const int64_t k = p.k_rep;
    const int64_t e_stop = (int64_t)b * k;
    const int64_t e_end = e_stop < p.n_eval ? e_stop : (int64_t)p.n_eval;
    const double qnan = __longlong_as_double(0x7ff8000000000000ll);
    // window (pp, c0, c1, nn): c0 and c1 the cells around the position,
    // pp before c0 and nn after c1
    Cell pp = none, c0 = none, c1 = none, nn = none;
    for (int j = 0; j < 3; ++j) {
        pp = c0;
        c0 = c1;
        c1 = nn;
        nn = st.next(line, p.in_cell);
    }
    double d0 = 0.0, d1 = 0.0;
    bool d0_ok = false, d1_ok = false;
    for (int64_t e = (int64_t)a * k; e < e_end; ++e) {
        while (c1.i >= 0 && (int64_t)c1.i * k < e) {
            pp = c0;
            c0 = c1;
            c1 = nn;
            nn = st.next(line, p.in_cell);
            d0 = d1;
            d0_ok = d1_ok;
            d1_ok = false;
        }
        double r;
        if (c0.i >= 0 && (int64_t)c0.i * k == e) {
            // on a finite cell (h == 0 in the plain version); NaN when it
            // is the line's only one (scipy skips lines with < 2 finite
            // cells): the window holds its finite neighbours either side
            r = pp.i >= 0 || c1.i >= 0 ? c0.v : qnan;
        } else if (c1.i >= 0 && (int64_t)c1.i * k == e) {
            r = c1.v;
        } else if (c0.i < 0 || c1.i < 0 || (int64_t)c0.i * k > e) {
            r = qnan;  // outside the line's finite span
        } else {
            if (!d0_ok) {
                d0 = derivative(none, pp, c0, c1, nn);
                d0_ok = true;
            }
            if (!d1_ok) {
                d1 = derivative(pp, c0, c1, nn, none);
                d1_ok = true;
            }
            const double xl = (double)c0.i;
            const double h = (double)c1.i - xl;
            const double t = per(p.xs[e] - xl, h);
            const double t2 = t * t;
            const double t3 = t2 * t;
            r = c0.v * (2.0 * t3 - 3.0 * t2 + 1.0) +
                h * d0 * (t3 - 2.0 * t2 + t) +
                c1.v * (-2.0 * t3 + 3.0 * t2) + h * d1 * (t3 - t2);
        }
        out[e * p.out_pos] = r;
    }
}

}  // namespace

extern "C" {

// Launch on `stream`. Every pointer is a device pointer: `in` float64 at
// the strides given (in elements; a strided view, e.g. the image box, is
// read in place), `xs` the n_eval float64 positions, `out` float64 at its
// strides. Lines are (frame, line) pairs, n_frames x lines of them; each
// has n cells and n_eval = (n - 1) * k_rep + 1 positions. Returns
// cudaErrorInvalidValue for n < 1, k_rep < 1 or a wrong n_eval, else
// cudaGetLastError() after the launch.
int pchip_axis_launch(const double* in, long long in_frame, long long in_line,
                      long long in_cell, const double* xs, double* out,
                      long long out_frame, long long out_line,
                      long long out_pos, int n_frames, long long lines, int n,
                      int n_eval, int k_rep, void* stream) {
    if (n < 1 || k_rep < 1 || n_eval != (n - 1) * k_rep + 1) {
        return (int)cudaErrorInvalidValue;
    }
    Params p;
    p.in = in;
    p.xs = xs;
    p.out = out;
    p.n_lines = (int64_t)n_frames * lines;
    p.lines = lines;
    p.in_frame = in_frame;
    p.in_line = in_line;
    p.in_cell = in_cell;
    p.out_frame = out_frame;
    p.out_line = out_line;
    p.out_pos = out_pos;
    p.n = n;
    p.n_eval = n_eval;
    p.k_rep = k_rep;
    if (p.n_lines == 0) return (int)cudaSuccess;
    const int lines_per_block = in_line == 1 ? kAdjacentLines : 1;
    const int most = kThreads / lines_per_block;
    const int wanted = (n + kMinSegment - 1) / kMinSegment;
    const int segments = wanted < most ? wanted : most;
    p.segment = (n + segments - 1) / segments;
    const dim3 block(lines_per_block, segments);
    const unsigned grid = (unsigned)((p.n_lines + lines_per_block - 1) /
                                     lines_per_block);
    pchip_axis_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

}  // extern "C"
