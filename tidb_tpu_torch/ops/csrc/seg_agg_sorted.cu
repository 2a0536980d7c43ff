// K4 seg_agg_sorted: grouped reductions over more than 64 segments.
//
// Replaces the sorted route of tidb_tpu/ops/kernels.py:903
// build_grouped_agg_fn (SegCtx.sorted_ctx :621-652, sums by cumsum
// differences, min/max at run ends with the sentinel for empty segments
// :671-686). As in the reference, a library sort is the building block:
// the caller sorts the group ids stably (torch.sort), and these kernels do
// the segmented reduction over the sorted runs.
//
// Runs are as skewed as the data (at TPC-H SF1 the dead-row sink alone
// holds 2.4M of 8.4M rows), so work is cut by position, not by segment:
// pass 1 gives each block a fixed piece of K4_PIECE sorted positions; a
// warp per segment present in the piece finds the segment's part of the
// piece by binary search and reduces it with a fixed-order butterfly. A
// segment wholly inside the piece is written out; the piece's first and
// last segment, when they cross its edges, leave a partial. Pass 2, a
// thread per segment, writes the sentinel for empty segments and folds
// the partials of a crossing segment piece by piece in order. No atomics,
// so f64 sums are bit-identical from run to run; each sum is a sum of its
// own rows only, with no rounding carried from a prefix as in the
// reference's cumsum differences.
//
// Bound by bytes: 8 B of sorted id and 8 B of permutation per row plus
// the values gathered through the permutation, which are random reads
// (32-byte sectors for 8 bytes used).
#include "common.cuh"

#define K4_THREADS 256
#define K4_WARPS (K4_THREADS / 32)
#define K4_PIECE 2048

__device__ __forceinline__ i64 lower_bound_i64(const i64* a, i64 lo, i64 hi, i64 key) {
  while (lo < hi) {
    const i64 mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void seg_sorted_pieces(i64 n, const i64* __restrict__ gs,
                                  const i64* __restrict__ order,
                                  const unsigned char* __restrict__ mask, i64 n_seg,
                                  int n_red, const i64* __restrict__ desc,
                                  i64* __restrict__ out, i64* __restrict__ part) {
  const i64 b0 = (i64)blockIdx.x * K4_PIECE;
  const i64 b1 = b0 + K4_PIECE < n ? b0 + K4_PIECE : n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const i64 first = gs[b0], last = gs[b1 - 1];
  // does the first / last segment continue into a neighbouring piece?
  const bool first_crosses = b0 > 0 && gs[b0 - 1] == first;
  const bool last_crosses = b1 < n && gs[b1] == last;
  for (i64 s = first + warp; s <= last; s += K4_WARPS) {
    if (s < 0 || s >= n_seg) continue;
    const i64 lo = lower_bound_i64(gs, b0, b1, s);
    const i64 hi = lower_bound_i64(gs, lo, b1, s + 1);
    if (lo == hi) continue;              // empty: pass 2 writes the sentinel
    const bool crosses = (s == first && first_crosses) || (s == last && last_crosses);
    for (int r = 0; r < n_red; ++r) {
      const i64* d = desc + RED_DESC * r;
      const int op = (int)d[0];
      Acc a = acc_init(op);
      for (i64 i = lo + lane; i < hi; i += 32) {
        i64 x;
        if (red_take(d, mask, order[i], &x)) acc_add(op, a, x);
      }
      a = warp_merge(op, a);
      if (lane == 0) {
        i64* p;
        if (!crosses) p = out + 2 * ((i64)r * n_seg + s);
        else p = part + 4 * ((i64)r * gridDim.x + blockIdx.x) + (s == first ? 0 : 2);
        p[0] = a.n;
        p[1] = a.v;
      }
    }
  }
}

__global__ void seg_sorted_finish(i64 n, const i64* __restrict__ gs, i64 n_seg, int n_red,
                                  int n_pieces, const i64* __restrict__ desc,
                                  const i64* __restrict__ part, i64* __restrict__ out) {
  const i64 s = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_seg) return;
  const i64 lo = lower_bound_i64(gs, 0, n, s);
  const i64 hi = lower_bound_i64(gs, lo, n, s + 1);
  const i64 p0 = lo / K4_PIECE, p1 = (hi - 1) / K4_PIECE;
  if (lo < hi && p0 == p1) return;       // written whole by pass 1
  for (int r = 0; r < n_red; ++r) {
    const int op = (int)desc[RED_DESC * r];
    Acc a = acc_init(op);
    for (i64 p = p0; lo < hi && p <= p1; ++p) {
      // the segment is its piece's first segment (slot 0) unless the
      // piece starts inside an earlier one (slot 2: its last segment)
      const int slot = gs[p * K4_PIECE] == s ? 0 : 2;
      const i64* q = part + 4 * ((i64)r * n_pieces + p) + slot;
      Acc b = {q[0], q[1]};
      a = acc_merge(op, a, b);
    }
    out[2 * ((i64)r * n_seg + s)] = a.n;
    out[2 * ((i64)r * n_seg + s) + 1] = a.v;
  }
}

extern "C" int seg_sorted_pieces_count(i64 n) {
  return (int)((n + K4_PIECE - 1) / K4_PIECE);
}

extern "C" int seg_sorted_launch(i64 n, const i64* gid_sorted, const i64* order,
                                 const unsigned char* mask, i64 n_seg, int n_red,
                                 const i64* desc, i64* part, i64* out, void* stream) {
  if (n_seg < 1 || n_red < 1 || n < 1) return -1;
  const int pieces = seg_sorted_pieces_count(n);
  cudaStream_t st = (cudaStream_t)stream;
  seg_sorted_pieces<<<pieces, K4_THREADS, 0, st>>>(n, gid_sorted, order, mask, n_seg,
                                                   n_red, desc, out, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const i64 blocks = (n_seg + 255) / 256;
  seg_sorted_finish<<<(unsigned)blocks, 256, 0, st>>>(n, gid_sorted, n_seg, n_red, pieces,
                                                      desc, part, out);
  return (int)cudaGetLastError();
}
