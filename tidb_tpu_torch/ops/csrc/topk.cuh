// The selection steps K10 (topk_select.cu), K16 (slot_topn.cu) and K20
// (shard_topk.cu) share: a bitonic sort of a tile of row indices in shared
// memory, and one element's placement in a merge round of sorted candidate
// lists truncated to k. `Ord` orders two rows (less(a, b): does a come
// before b?) and orders every pair, so no two rows compare equal. K10 and
// K20 also share the row encoding (topk_encode) and its order (TopkOrd):
// live first, then per key its null rank and its order word, then the row.
#pragma once

#include "common.cuh"

#define TOPK_KEY 4           // (values pointer, valid pointer, is_f64, desc)
#define TOPK_DEAD 0x80u

struct TopkOrd {
  i64 n;
  int nk;
  const u64* enc;
  const unsigned char* flg;
  // does row a come before row b?
  __device__ __forceinline__ bool less(i64 a, i64 b) const {
    const unsigned fa = flg[a], fb = flg[b];
    if ((fa & TOPK_DEAD) != (fb & TOPK_DEAD)) return (fa & TOPK_DEAD) < (fb & TOPK_DEAD);
    for (int k = 0; k < nk; ++k) {
      const unsigned na = (fa >> k) & 1u, nb = (fb >> k) & 1u;
      if (na != nb) return na < nb;
      const u64 wa = enc[(i64)k * n + a], wb = enc[(i64)k * n + b];
      if (wa != wb) return wa < wb;
    }
    return a < b;
  }
};

// The order word of every key of `row` and its flags byte.
__device__ __forceinline__ void topk_encode(i64 row, i64 n, const unsigned char* mask, int nk,
                                            const i64* keys, u64* enc, unsigned char* flg) {
  unsigned f = mask[row] ? 0u : TOPK_DEAD;
  for (int k = 0; k < nk; ++k) {
    const i64* kd = keys + TOPK_KEY * k;
    const unsigned char* ok = (const unsigned char*)kd[1];
    const bool valid = ok == nullptr || ok[row] != 0;
    const bool desc = kd[3] != 0;
    u64 w = 0;
    if (valid) {
      i64 x = ((const i64*)kd[0])[row];
      if (kd[2]) {
        // f64: -0.0 is +0.0; sign-magnitude bits to two's complement
        if (as_f64(x) == 0.0) x = 0;
        if (x < 0) x ^= I64_MAX_V;
      }
      w = (u64)x ^ 0x8000000000000000ull;   // int64 order as unsigned order
      if (desc) w = ~w;
    }
    f |= (unsigned)(desc ? !valid : valid) << k;
    enc[(i64)k * n + row] = w;
  }
  flg[row] = (unsigned char)f;
}


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
