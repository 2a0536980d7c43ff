// K4 seg_agg_sorted: grouped reductions over more than 64 segments.
//
// Replaces the sorted route of tidb_tpu/ops/kernels.py:903
// build_grouped_agg_fn (SegCtx.sorted_ctx :621-652, sums by cumsum
// differences, min/max at run ends with the sentinel for empty segments
// :671-686). As in the reference, a library sort is the building block:
// the caller sorts the group ids stably (torch.sort), and the segmented
// pass of seg_sorted.cuh reduces the sorted runs. Each sum is a sum of its
// own rows only, with no rounding carried from a prefix as in the
// reference's cumsum differences.
//
// Bound by bytes: 8 B of sorted id and 8 B of permutation per row plus
// the values gathered through the permutation, which are random reads
// (32-byte sectors for 8 bytes used).
#include "seg_sorted.cuh"

// One statement's reductions: RED_DESC int64 descriptors (common.cuh)
// under one row mask; a segment's state is stored as (n, v).
struct K4Src {
  int n_red;
  const i64* desc;
  const unsigned char* mask;
  __device__ int op(int j) const { return (int)desc[RED_DESC * j]; }
  __device__ bool take(int j, i64 row, i64* x) const {
    return red_take(desc + RED_DESC * j, mask, row, x);
  }
  __device__ void store(i64* out, i64 n_seg, int j, i64 s, Acc a) const {
    out[2 * ((i64)j * n_seg + s)] = a.n;
    out[2 * ((i64)j * n_seg + s) + 1] = a.v;
  }
};

extern "C" int seg_sorted_pieces_count(i64 n) { return sorted_pieces_count(n); }

extern "C" int seg_sorted_launch(i64 n, const i64* gid_sorted, const i64* order,
                                 const unsigned char* mask, i64 n_seg, int n_red,
                                 const i64* desc, i64* part, i64* out, void* stream) {
  const K4Src src = {n_red, desc, mask};
  return sorted_launch(n, gid_sorted, order, n_seg, src, part, out, (cudaStream_t)stream);
}
