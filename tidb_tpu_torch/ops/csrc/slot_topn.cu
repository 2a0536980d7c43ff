// K16 slot_topn: the first k rows of k statements' TopN over one batch,
// each under its own WHERE, in one launch sequence.
//
// Replaces tidb_tpu/ops/sched.py:532 _build_topn_wrapper: jax.vmap over
// the statement slots of a full lexsort per slot (dead rows last, then per
// ORDER BY item its null rank and value, then the row position), its first
// k indices and min(live rows, k). The reference negates int64 keys for
// DESC, so -2^63 wraps and sorts first (sched.py:553-556); here, as in
// K10 (topk_select.cu), DESC complements the order word and never wraps.
//
// The keys are the same for every slot, so each row's order words are
// encoded ONCE (pass 0: int64 as is, f64 with -0.0 made +0.0 and its bits
// mapped to two's complement, DEC scaled ints and STR codes as int64; DESC
// complemented; a flags byte holds each key's null rank, NULL first
// ascending and last descending). Only liveness differs between slots: a
// slot's row is live when its bit is set in K14's mask words for that
// slot. Then K10's design with grid.y = slot: pass 1 bitonic-sorts every
// tile of K16_TILE rows in shared memory and keeps its first min(k, tile)
// (and adds the tile's live rows to the slot's count, an integer atomic);
// pass 2, one launch per round, merges the candidate lists in pairs,
// truncated to k, each element placed by a binary search in the other
// list. Every pair of rows is ordered (row position last), so the result
// is deterministic.
//
// Bound by bytes: each key's value and valid byte read once per row, the
// order words and flags written once, the k * n / 8 bytes of mask words
// read once per slot; the tile sorts then re-read the order words per slot
// (from L2 at the tier's batch sizes), which at k = 32 over millions of
// rows makes the sorts, not the bytes, the cost.
#include "topk.cuh"

#define K16_TILE 1024
#define K16_THREADS 512
#define K16_MAXK 4
#define K16_KEY 4           // (values pointer, valid pointer, is_f64, desc)

struct K16Ord {
  i64 n;
  int nk;
  const u64* enc;
  const unsigned char* flg;
  const unsigned* live;     // the slot's mask words, bit r % 32 of word r / 32
  __device__ __forceinline__ bool dead(i64 r) const {
    return ((live[r >> 5] >> (r & 31)) & 1u) == 0;
  }
  // does row a come before row b?
  __device__ __forceinline__ bool less(i64 a, i64 b) const {
    const bool da = dead(a), db = dead(b);
    if (da != db) return !da;
    const unsigned fa = flg[a], fb = flg[b];
    for (int k = 0; k < nk; ++k) {
      const unsigned na = (fa >> k) & 1u, nb = (fb >> k) & 1u;
      if (na != nb) return na < nb;
      const u64 wa = enc[(i64)k * n + a], wb = enc[(i64)k * n + b];
      if (wa != wb) return wa < wb;
    }
    return a < b;
  }
};

__global__ void k16_encode(i64 n, int nk, const i64* __restrict__ keys, u64* __restrict__ enc,
                           unsigned char* __restrict__ flg) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    unsigned f = 0;
    for (int k = 0; k < nk; ++k) {
      const i64* kd = keys + K16_KEY * k;
      const unsigned char* ok = (const unsigned char*)kd[1];
      const bool valid = ok == nullptr || ok[row] != 0;
      const bool desc = kd[3] != 0;
      u64 w = 0;
      if (valid) {
        w = (u64)key_word(((const i64*)kd[0])[row], (int)kd[2]) ^ 0x8000000000000000ull;
        if (desc) w = ~w;
      }
      f |= (unsigned)(desc ? !valid : valid) << k;
      enc[(i64)k * n + row] = w;
    }
    flg[row] = (unsigned char)f;
  }
}

__global__ void __launch_bounds__(K16_THREADS)
k16_tiles(i64 n, i64 k, const unsigned* __restrict__ words, int nk, const u64* __restrict__ enc,
          const unsigned char* __restrict__ flg, i64* __restrict__ out, i64 cand,
          unsigned long long* __restrict__ live_count) {
  __shared__ i64 slot[K16_TILE];
  __shared__ int warp_live[K16_THREADS / 32];
  const i64 s = blockIdx.y;
  const K16Ord ord = {n, nk, enc, flg, words + s * (n >> 5)};
  const i64 t0 = (i64)blockIdx.x * K16_TILE;
  const int m = (int)(n - t0 < K16_TILE ? n - t0 : K16_TILE);
  int live = 0;
  for (int j = threadIdx.x; j < K16_TILE; j += K16_THREADS) {
    if (j < m) {
      live += !ord.dead(t0 + j);
      slot[j] = t0 + j;
    } else {
      slot[j] = -1;                     // padding sorts after every row
    }
  }
  for (int off = 16; off > 0; off >>= 1) live += __shfl_down_sync(0xffffffffu, live, off);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < K16_THREADS / 32; ++w) tot += warp_live[w];
    atomicAdd(live_count + s, (unsigned long long)tot);
  }
  topk_tile_sort<K16_TILE, K16_THREADS>(slot, ord);
  const i64 stride_out = k < K16_TILE ? k : K16_TILE;
  const i64 len = k < m ? k : m;
  i64* o = out + s * cand + (i64)blockIdx.x * stride_out;
  for (int j = threadIdx.x; j < len; j += K16_THREADS) o[j] = slot[j];
}

__global__ void k16_merge(i64 n, i64 k, i64 span, const i64* __restrict__ in_all,
                          i64* __restrict__ out_all, i64 cand, int nk,
                          const u64* __restrict__ enc, const unsigned char* __restrict__ flg,
                          const unsigned* __restrict__ words) {
  const i64 s = blockIdx.y;
  const K16Ord ord = {n, nk, enc, flg, words + s * (n >> 5)};
  topk_merge_one(n, k, span, in_all + s * cand, out_all + s * cand,
                 (i64)blockIdx.x * blockDim.x + threadIdx.x, ord);
}

__global__ void k16_finish(const i64* __restrict__ in_all, i64 cand, i64 k,
                           const i64* __restrict__ count, i64* __restrict__ idx,
                           i64* __restrict__ n_live) {
  const i64 s = blockIdx.x;
  for (i64 j = threadIdx.x; j < k; j += blockDim.x) idx[s * k + j] = in_all[s * cand + j];
  if (threadIdx.x == 0) n_live[s] = count[s] < k ? count[s] : k;
}

extern "C" int slot_topn_tile() { return K16_TILE; }

// words: slots * n / 32 u32 (K14's output); enc nk * n int64, flg n bytes;
// buf_a and buf_b each slots * cand int64 with cand = ceil(n / K16_TILE) *
// min(k, K16_TILE); count and n_live slots int64; idx slots * k int64.
extern "C" int slot_topn_launch(i64 n, int slots, i64 k, const unsigned* words, int nk,
                                const i64* keys, u64* enc, unsigned char* flg, i64* buf_a,
                                i64* buf_b, i64* count, i64* idx, i64* n_live, void* stream) {
  if (n < 1 || (n & 31) || k < 1 || k > n || nk < 0 || nk > K16_MAXK) return -1;
  if (slots < 1 || slots > 65535) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, (size_t)slots * sizeof(i64), st);
  if (e != cudaSuccess) return (int)e;
  i64 eb = (n + 255) / 256;
  if (eb > 132 * 16) eb = 132 * 16;
  k16_encode<<<(unsigned)eb, 256, 0, st>>>(n, nk, keys, enc, flg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const i64 tiles = (n + K16_TILE - 1) / K16_TILE;
  if (tiles > 0x7fffffff) return -1;
  const i64 cand = tiles * (k < K16_TILE ? k : K16_TILE);
  k16_tiles<<<dim3((unsigned)tiles, (unsigned)slots), K16_THREADS, 0, st>>>(
      n, k, words, nk, enc, flg, buf_a, cand, (unsigned long long*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  i64* in = buf_a;
  i64* out = buf_b;
  for (i64 span = K16_TILE; span < n; span *= 2) {
    const i64 s_in = k < span ? k : span;
    const i64 total = (n + span - 1) / span * s_in;
    k16_merge<<<dim3((unsigned)((total + 255) / 256), (unsigned)slots), 256, 0, st>>>(
        n, k, span, in, out, cand, nk, enc, flg, words);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    i64* t = in;
    in = out;
    out = t;
  }
  k16_finish<<<(unsigned)slots, 256, 0, st>>>(in, cand, k, count, idx, n_live);
  return (int)cudaGetLastError();
}
