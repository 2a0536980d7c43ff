// K20 shard_topk: every shard's first k rows of a TopN on a mesh.
//
// Replaces tidb_tpu/ops/kernels.py:2005 build_topn_partial_fn (one key,
// scored as f64 for lax.top_k, NULL and dead rows both at -inf) and :2048
// build_topn_partial_fn_multi (a full lexsort, int64 keys negated for
// DESC), run per shard by shard_map over S row blocks of L rows each. Here
// all S blocks go through the same launches, in K10's order (live rows
// first; per ORDER BY item its null rank, then its order word, int64 or
// f64 with -0.0 == +0.0, complemented for DESC, never negated; then the
// row position). For the host merge each candidate carries its order
// words and null ranks instead of the reference's f64 score, so the merge
// orders rows exactly as K10 does (kernels.merge_topn_partials).
//
// Bound by bytes: the live byte and each key's value and valid byte read
// once per row; S * k * (8 + 9 * keys) bytes of candidates written. The
// first design wrote every row's order words and flags to device memory,
// bitonic-sorted every 1,024-row tile in full whatever k was, read both
// rows' words back at each comparison, merged in log2(L / 1,024)
// launches and copied its key table to the card on every call. This one
// is K10's threshold filter (topk_level.cuh) run within each shard, from
// the plan kernels.shard_topk_plan gives:
// - level 1: a persistent grid (the card's resident blocks) split evenly
//   over the shards; each block keeps the best K composite keys of a
//   contiguous slice of its shard in shared memory and admits a row only
//   if it comes before the block's K-th key. No row's words are written
//   to device memory;
// - later levels merge fan_in of a shard's lists a block, never two
//   shards' lists, until one block a shard is left; it writes the
//   shard-local rows, their order words and null ranks, and min(live, k)
//   from the level-1 blocks' live counts;
// - k above the largest K a block holds runs in K10's rounds after each
//   shard's previous last key. The launches depend on S and k (and the
//   card's grid), never on L.
// The key descriptors ride by value in the __grid_constant__ parameter
// block; the lists live in a scratch buffer the wrapper keeps per stream.
// The same input gives the same output: every pair of rows is ordered.
#include "topk_level.cuh"

extern "C" int shard_topk_grid(int nk, int level1, int slots) {
  return k10_grid(nk, level1, slots);
}

// One level of one round over S shards of L rows (kernels.shard_topk
// drives them from its plan): keys nk K10Key in host memory; in / out /
// bound list buffers (k10_list) of in_lists * K, blocks * K and S
// entries; idx [S, kk], words [S, nk, kk] and nulls [S, nk, kk] at the
// last level, filled from column idx_off; n_live [S].
extern "C" int shard_topk_level_launch(int nk, int level1, int blocks, int K, int slots,
                                       int shards, i64 L, const unsigned char* mask,
                                       const K10Key* keys, void* in, int in_lists, int fan_in,
                                       void* out, void* bound, int has_lb, int final_level,
                                       i64* idx, i64* words, unsigned char* nulls, i64 idx_off,
                                       i64 kk, i64* live_part, int count_live, int live_blocks,
                                       i64* n_live, void* stream) {
  if (words == nullptr) return -1;
  return k10_launch(nk, level1, blocks, K, slots, (i64)shards * L, L, shards, mask, keys, in,
                    in_lists, fan_in, out, bound, has_lb, final_level, idx, words, nulls,
                    idx_off, kk, live_part, count_live, live_blocks, n_live, nullptr,
                    (cudaStream_t)stream);
}
