// The segmented reduction over stably sorted group ids, shared by K4
// (seg_agg_sorted.cu) and the large-span route of K6
// (seg_states_ragged.cu). The two differ only in where a row's value
// comes from and how a segment's state is stored, which a source type
// supplies:
//
//   int n_red;                                       reductions
//   __device__ int op(int j) const;                  RedOp of reduction j
//   __device__ bool take(int j, i64 row, i64* x) const;
//                                                    does `row` (an index
//                                                    before sorting)
//                                                    contribute, with x
//   __device__ void store(i64* out, i64 n_seg, int j, i64 s, Acc a) const;
//
// Runs are as skewed as the data (at TPC-H SF1 the dead-row sink alone
// holds 2.4M of 8.4M rows), so work is cut by position, not by segment:
// pass 1 gives each block a fixed piece of SORTED_PIECE sorted positions;
// a warp per segment present in the piece finds the segment's part of the
// piece by binary search and reduces it with a fixed-order butterfly
// (f64 extrema in row order: each lane a contiguous run, the lanes merged
// as a tree in lane order, so a tie of -0.0 and +0.0 keeps the first row,
// as K6's plain version does). A segment wholly inside the piece is
// stored; the piece's first and last
// segment, when they cross its edges, leave a partial (n, v) in `part`
// (4 int64 per reduction and piece). Pass 2, a thread per segment, stores
// the identity for empty segments and folds the partials of a crossing
// segment piece by piece in order. No atomics, so f64 sums are
// bit-identical from run to run. The source rides in each launch's
// parameters (__grid_constant__: K6's holds its tables by value, read in
// place).
#pragma once

#include "common.cuh"

#define SORTED_THREADS 256
#define SORTED_WARPS (SORTED_THREADS / 32)
#define SORTED_PIECE 2048

// Lane 0 ends with the fold of every lane's accumulator in lane order,
// the left part first at each step of the tree.
__device__ __forceinline__ Acc warp_merge_ordered(int op, Acc a) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    Acc b;
    b.n = __shfl_down_sync(0xffffffffu, a.n, off);
    b.v = __shfl_down_sync(0xffffffffu, a.v, off);
    if ((lane & (2 * off - 1)) == 0) a = acc_merge(op, a, b);
  }
  return a;
}

template <class Src>
__global__ void sorted_pieces(i64 n, const i64* __restrict__ gs,
                              const i64* __restrict__ order, i64 n_seg,
                              const __grid_constant__ Src src, i64* __restrict__ out,
                              i64* __restrict__ part) {
  const i64 b0 = (i64)blockIdx.x * SORTED_PIECE;
  const i64 b1 = b0 + SORTED_PIECE < n ? b0 + SORTED_PIECE : n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const i64 first = gs[b0], last = gs[b1 - 1];
  // does the first / last segment continue into a neighbouring piece?
  const bool first_crosses = b0 > 0 && gs[b0 - 1] == first;
  const bool last_crosses = b1 < n && gs[b1] == last;
  for (i64 s = first + warp; s <= last; s += SORTED_WARPS) {
    if (s < 0 || s >= n_seg) continue;
    const i64 lo = lower_bound_i64(gs, b0, b1, s);
    const i64 hi = lower_bound_i64(gs, lo, b1, s + 1);
    if (lo == hi) continue;              // empty: pass 2 stores the identity
    const bool crosses = (s == first && first_crosses) || (s == last && last_crosses);
    for (int j = 0; j < src.n_red; ++j) {
      const int op = src.op(j);
      Acc a = acc_init(op);
      if (op == R_MIN_F || op == R_MAX_F) {
        // in row order (a tie of -0.0 and +0.0 keeps the first row): each
        // lane a contiguous run of the segment's rows, the lanes merged as
        // a tree in lane order
        const i64 c = (hi - lo + 31) / 32;
        const i64 i0 = lo + lane * c < hi ? lo + lane * c : hi;
        const i64 i1 = i0 + c < hi ? i0 + c : hi;
        for (i64 i = i0; i < i1; ++i) {
          i64 x;
          if (src.take(j, order[i], &x)) acc_add(op, a, x);
        }
        a = warp_merge_ordered(op, a);
      } else {
        for (i64 i = lo + lane; i < hi; i += 32) {
          i64 x;
          if (src.take(j, order[i], &x)) acc_add(op, a, x);
        }
        a = warp_merge(op, a);
      }
      if (lane == 0) {
        if (!crosses) {
          src.store(out, n_seg, j, s, a);
        } else {
          i64* p = part + 4 * ((i64)j * gridDim.x + blockIdx.x) + (s == first ? 0 : 2);
          p[0] = a.n;
          p[1] = a.v;
        }
      }
    }
  }
}

template <class Src>
__global__ void sorted_finish(i64 n, const i64* __restrict__ gs, i64 n_seg, int n_pieces,
                              const __grid_constant__ Src src, const i64* __restrict__ part,
                              i64* __restrict__ out) {
  const i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_seg) return;
  const i64 lo = lower_bound_i64(gs, 0, n, s);
  const i64 hi = lower_bound_i64(gs, lo, n, s + 1);
  const i64 p0 = lo / SORTED_PIECE, p1 = (hi - 1) / SORTED_PIECE;
  if (lo < hi && p0 == p1) return;       // stored whole by pass 1
  for (int j = 0; j < src.n_red; ++j) {
    const int op = src.op(j);
    Acc a = acc_init(op);
    for (i64 p = p0; lo < hi && p <= p1; ++p) {
      // the segment is its piece's first segment (slot 0) unless the
      // piece starts inside an earlier one (slot 2: its last segment)
      const int slot = gs[p * SORTED_PIECE] == s ? 0 : 2;
      const i64* q = part + 4 * ((i64)j * n_pieces + p) + slot;
      Acc b = {q[0], q[1]};
      a = acc_merge(op, a, b);
    }
    src.store(out, n_seg, j, s, a);
  }
}

__host__ __forceinline__ int sorted_pieces_count(i64 n) {
  return (int)((n + SORTED_PIECE - 1) / SORTED_PIECE);
}

// Both passes over n sorted ids (none: pass 2 stores every identity);
// `part` holds 4 * n_red * sorted_pieces_count(n) int64.
template <class Src>
int sorted_launch(i64 n, const i64* gs, const i64* order, i64 n_seg, Src src, i64* part,
                  i64* out, cudaStream_t st) {
  if (n_seg < 1 || src.n_red < 1 || n < 0) return -1;
  const int pieces = sorted_pieces_count(n);
  if (n > 0) {
    sorted_pieces<Src><<<pieces, SORTED_THREADS, 0, st>>>(n, gs, order, n_seg, src, out, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  sorted_finish<Src><<<(unsigned)((n_seg + 255) / 256), 256, 0, st>>>(n, gs, n_seg, pieces,
                                                                      src, part, out);
  return (int)cudaGetLastError();
}
