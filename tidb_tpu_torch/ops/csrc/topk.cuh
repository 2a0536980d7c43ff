// The selection steps K16 (slot_topn.cu) shares: a bitonic sort of a
// tile of row indices in shared memory, and one element's placement in a
// merge round of sorted candidate lists truncated to k. `Ord` orders two
// rows (less(a, b): does a come before b?) and orders every pair, so no
// two rows compare equal. K10 and K20 (topk_level.cuh) take only
// TOPK_DEAD, the dead bit of their composite keys' flags.
#pragma once

#include "common.cuh"

#define TOPK_DEAD 0x80u

// Sort slot[0, TILE) (row indices, -1 for padding, which sorts after
// every row) by ord; every thread of the block calls it.
template <int TILE, int THREADS, class Ord>
__device__ __forceinline__ void topk_tile_sort(i64* slot, const Ord& ord) {
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < TILE / 2; t += THREADS) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const i64 a = slot[i], b = slot[j];
        const bool a_after_b = a < 0 ? b >= 0 : (b >= 0 && ord.less(b, a));
        if (a_after_b == ((i & size) == 0)) {
          slot[i] = b;
          slot[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Length of candidate list j of a round whose lists cover `span` rows each.
__device__ __forceinline__ i64 topk_list_len(i64 n, i64 k, i64 span, i64 j) {
  const i64 lo = j * span;
  const i64 c = (n - lo < span ? n - lo : span);
  return c < k ? c : k;
}

// Element e of a round's lists `in` (min(k, span) slots per list) goes to
// its place in the merged list of its pair in `out`: its rank in its own
// list plus the count of elements of the other list that come before it.
template <class Ord>
__device__ __forceinline__ void topk_merge_one(i64 n, i64 k, i64 span, const i64* in,
                                               i64* out, i64 e, const Ord& ord) {
  const i64 s_in = k < span ? k : span;
  const i64 nlists = (n + span - 1) / span;
  if (e >= nlists * s_in) return;
  const i64 j = e / s_in, i = e - j * s_in;
  if (i >= topk_list_len(n, k, span, j)) return;
  const i64 x = in[e];
  const i64 o = j ^ 1;
  i64 pos = i;
  if (o < nlists) {
    const i64* other = in + o * s_in;
    i64 lo = 0, hi = topk_list_len(n, k, span, o);
    while (lo < hi) {
      const i64 mid = lo + ((hi - lo) >> 1);
      if (ord.less(other[mid], x)) lo = mid + 1; else hi = mid;
    }
    pos += lo;
  }
  const i64 s_out = k < 2 * span ? k : 2 * span;
  if (pos < k) out[(j >> 1) * s_out + pos] = x;
}
