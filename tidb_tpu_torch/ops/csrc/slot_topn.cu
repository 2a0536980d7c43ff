// K16 slot_topn: the first k rows of k statements' TopN over one batch,
// each under its own WHERE.
//
// Replaces tidb_tpu/ops/sched.py:532 _build_topn_wrapper: jax.vmap over
// the statement slots of a full lexsort per slot (dead rows last, then per
// ORDER BY item its null rank and value, then the row position), its first
// k indices and min(live rows, k). The reference negates int64 keys for
// DESC, so -2^63 wraps and sorts first (sched.py:553-556); here, as in
// K10 (topk_select.cu), DESC complements the order word and never wraps.
//
// The keys are the same for every slot; only liveness differs: a slot's
// row is live where its bit is set in K14's mask words for that slot.
// The selection is K10's threshold filter (topk_level.cuh) run as K20
// runs shards (shard_topk.cu), one shard a slot, over one shared set of
// key rows, from the plan kernels.shard_topk_plan gives with one shard a
// slot:
// - level 1: the card's resident blocks split evenly over the slots, each
//   block a contiguous slice of the rows. A row's composite key (its
//   slot's live bit, each key's null rank and order word, the row) is
//   built in registers as its planes stream in and never written to
//   device memory; the block keeps its best K keys in shared memory and
//   admits a row only if it comes before its K-th key. The blocks of
//   every slot that read one slice run together on the persistent grid,
//   so the slots' reads of a key row meet in L2;
// - later levels merge fan_in of a slot's lists a block until one block a
//   slot is left, which writes the slot's rows and min(live, k) from the
//   level-1 blocks' integer live counts;
// - k above the largest K a block holds runs in K10's rounds after each
//   slot's previous last key. The launches depend on the slots and k (and
//   the card's grid), never on the rows.
// The key descriptors ride by value in the __grid_constant__ parameter
// block and the lists live in a scratch buffer the wrapper keeps per
// stream, so a call copies nothing to the card. Every pair of rows is
// ordered (row position last), so the result is deterministic.
//
// Bound by bytes: each key's value and valid byte read once per row, the
// k * n / 8 bytes of mask words read once, slots * k * 8 bytes of row ids
// written.
#include "topk_level.cuh"

extern "C" int slot_topn_grid(int nk, int level1, int slots) {
  return k10_grid(nk, level1, slots);
}

// Every launch of one call over n_slots slots of the same n rows, in the
// order of the table `calls` (kernels._k16_calls: K16_CALL int64 a launch,
// made once per shape): level 1 or not, blocks, K, the round's slots, the
// in and out list offsets in the scratch at `base` (-1: none), in_lists,
// fan_in, the bound's offset, has_lb, final level, idx_off, count_live,
// live_blocks, the live counts' offset. words: the slots' mask words
// ([n_slots, n / 32] u32, K14's int64 [n_slots, n / 64] block); keys: nk
// K10Key in host memory; idx [n_slots, kk] filled from column idx_off at
// each round's last level; n_live [n_slots]. One call from the host for
// the whole plan. Returns 0, or the first launch's failure.
#define K16_CALL 15
extern "C" int slot_topn_launch(int n_calls, const i64* calls, int nk, int n_slots, i64 n,
                                const unsigned* words, const K10Key* keys, char* base, i64* idx,
                                i64 kk, i64* n_live, void* stream) {
  if (words == nullptr || calls == nullptr || base == nullptr || n_calls < 1) return -1;
  for (int c = 0; c < n_calls; ++c) {
    const i64* r = calls + (size_t)c * K16_CALL;
    const int rc = k10_launch(
        nk, (int)r[0], (int)r[1], (int)r[2], (int)r[3], n, n, n_slots, nullptr, keys,
        r[4] < 0 ? nullptr : base + r[4], (int)r[5], (int)r[6], r[7] < 0 ? nullptr : base + r[7],
        base + r[8], (int)r[9], (int)r[10], idx, nullptr, nullptr, r[11], kk,
        (i64*)(base + r[14]), (int)r[12], (int)r[13], n_live, words, (cudaStream_t)stream);
    if (rc != 0) return rc;
  }
  return 0;
}
