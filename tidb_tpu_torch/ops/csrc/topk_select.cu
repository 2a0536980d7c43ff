// K10 topk_select: the first k rows of a TopN.
//
// Replaces tidb_tpu/ops/kernels.py:1980 build_topn_fn (one key, scored as
// f64 for lax.top_k) and :2080 build_topn_fn_multi (a full lexsort, int64
// keys negated for DESC). The order here is the SQL order on the keys'
// own types: live rows first; then per ORDER BY item its null rank (NULL
// first ascending, last descending) and its value, int64 or f64 (-0.0 ==
// +0.0), reversed for DESC by complementing the order word, never by
// negation (which wraps at -2^63); then the row position. Every pair of
// rows is ordered, so no two compare equal and the selection is
// deterministic.
//
// Bound by bytes: the live byte and each key's value and valid byte read
// once per row. The first design wrote every row's order words to device
// memory, bitonic-sorted every 1024-row tile whatever k was, compared rows
// by reading their words back, and merged in log2(n / 1024) launches. This
// one is a threshold filter over composite keys held in registers and
// shared memory (the wrapper's kernels.topk_plan sizes it):
// - a row's composite key (flags: dead bit and null ranks; the order word
//   of each key; the row) is computed in registers as its planes stream
//   in (coalesced loads, K10_ROWS rows a thread per step) and is never
//   written to device memory;
// - each block of a persistent grid takes a contiguous slice of rows and
//   keeps, in shared memory, its best K keys so far and a buffer of new
//   candidates. A row enters the buffer only if it comes before the
//   block's K-th key (one comparison against a copy in registers). Keys
//   stay in their slots; 16-bit slot lists order them. When the buffer
//   could overflow, and as soon as K keys are seen, the block
//   bitonic-sorts the new candidates' slot numbers (the keys' fields read
//   from shared memory as each comparison needs them), merges them with
//   the kept list (merge path: one binary search a thread) and keeps the
//   first K, which tightens the threshold.
//   Slots are handed out with a shared-memory integer atomic; their order
//   does not matter, since the sort orders every pair of keys;
// - the blocks' K-lists (keys and rows, sorted) go to a small buffer; the
//   next level runs the same filter over fan_in lists a block, until one
//   block is left, which writes the rows (a fixed number of levels for the
//   card: two for k 10 and 100, three for k in the thousands). Lists of at
//   least K10_STEP keys are walked list by list: the keys before the
//   threshold are a prefix of each chunk, merged in order without a sort,
//   and the first key that fails ends its list;
// - k above the largest K the shared memory holds runs in rounds, each
//   selecting the next K rows after the previous round's last key (kept
//   in a one-entry buffer), so the launches grow with k / K, never with n.
// No comparison reads a key from device memory; the only atomics are
// shared-memory slot counters. The device code lives in topk_level.cuh,
// which K20 (shard_topk.cu) runs per shard.
#include "topk_level.cuh"

// Blocks of the level kernel that fit on the whole card with `slots`
// slots for nk keys (SMs x resident blocks).
extern "C" int topk_grid(int nk, int level1, int slots) { return k10_grid(nk, level1, slots); }

// One level of one round (kernels.topk_select drives them from its plan).
// keys: nk K10Key in host memory; in / out / bound: list buffers laid out
// as k10_list with capacities in_lists * K, blocks * K and 1.
extern "C" int topk_level_launch(int nk, int level1, int blocks, int K, int slots, i64 n,
                                 const unsigned char* mask, const K10Key* keys, void* in,
                                 int in_lists, int fan_in, void* out, void* bound, int has_lb,
                                 int final_level, i64* idx, i64 idx_off, i64 kk,
                                 i64* live_part, int count_live, int live_blocks, i64* n_live,
                                 void* stream) {
  return k10_launch(nk, level1, blocks, K, slots, n, n, 1, mask, keys, in, in_lists, fan_in, out,
                    bound, has_lb, final_level, idx, nullptr, nullptr, idx_off, kk, live_part,
                    count_live, live_blocks, n_live, nullptr, (cudaStream_t)stream);
}
