// K20 shard_topk: every shard's first k rows of a TopN on a mesh.
//
// Replaces tidb_tpu/ops/kernels.py:2005 build_topn_partial_fn (one key,
// scored as f64 for lax.top_k, NULL and dead rows both at -inf) and :2048
// build_topn_partial_fn_multi (a full lexsort, int64 keys negated for
// DESC), run per shard by shard_map over S row blocks of L rows each. Here
// all S blocks go in one launch, in K10's order (topk.cuh: live rows
// first; per ORDER BY item its null rank, then its order word, int64 or
// f64 with -0.0 == +0.0, complemented for DESC, never negated; then the
// row position). For the host merge each candidate carries its order
// words and null ranks instead of the reference's f64 score, so the merge
// orders rows exactly as K10 does (kernels.merge_topn_partials).
//
// Inputs: the live mask [S * L] (K1's WHERE mask over the shard-major
// rows) and per key TOPK_KEY int64 (values pointer, valid pointer, is-f64,
// desc). Pass 1: a block per tile of K20_TILE rows (tiles never cross a
// shard) encodes its rows (topk_encode), bitonic-sorts their indices in
// shared memory, keeps the first min(k, tile) and adds its live rows to
// its shard's count (an integer atomic). Pass 2, one launch per round:
// within each shard the sorted candidate lists merge in pairs, truncated
// to k (topk_merge_one). Pass 3: a thread per (shard, candidate) writes
// the shard-local row index, its order words and null ranks, and the
// shard's min(live, k). The same input gives the same output: every pair
// of rows is ordered.
//
// Bound by bytes: the live byte and each key's value and valid byte read
// once per row; S * k * (8 + 9 * keys) bytes of candidates written.
#include "topk.cuh"

#define K20_TILE 1024
#define K20_THREADS 512
#define K20_MAXK 4

__global__ void __launch_bounds__(K20_THREADS)
k20_tiles(i64 n, i64 L, i64 tps, i64 k, const unsigned char* __restrict__ mask, int nk,
          const i64* __restrict__ keys, u64* enc, unsigned char* flg, i64* __restrict__ out,
          unsigned long long* __restrict__ live_count) {
  __shared__ i64 slot[K20_TILE];
  __shared__ int warp_live[K20_THREADS / 32];
  const i64 s = (i64)blockIdx.x / tps;
  const i64 j0 = (i64)blockIdx.x - s * tps;
  const i64 t0 = s * L + j0 * K20_TILE;
  const i64 rem = (s + 1) * L - t0;
  const int m = (int)(rem < K20_TILE ? rem : K20_TILE);
  int live = 0;
  for (int j = threadIdx.x; j < K20_TILE; j += K20_THREADS) {
    if (j < m) {
      topk_encode(t0 + j, n, mask, nk, keys, enc, flg);
      live += mask[t0 + j] != 0;
      slot[j] = t0 + j;
    } else {
      slot[j] = -1;                     // padding sorts after every row
    }
  }
  for (int off = 16; off > 0; off >>= 1) live += __shfl_down_sync(0xffffffffu, live, off);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = live;
  __syncthreads();                      // also publishes enc/flg to the block
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int w = 0; w < K20_THREADS / 32; ++w) tot += warp_live[w];
    atomicAdd(live_count + s, (unsigned long long)tot);
  }
  const TopkOrd ord = {n, nk, enc, flg};
  topk_tile_sort<K20_TILE, K20_THREADS>(slot, ord);
  const i64 s_in = k < K20_TILE ? k : K20_TILE;
  const i64 len = k < m ? k : m;
  i64* dst = out + s * tps * s_in + j0 * s_in;
  for (int j = threadIdx.x; j < len; j += K20_THREADS) dst[j] = slot[j];
}

// One merge round in every shard: element e of shard s's lists (of
// `per_shard` slots) in its place; `stride` slots separate the shards.
__global__ void k20_merge(i64 n, i64 S, i64 L, i64 k, i64 span, i64 per_shard, i64 stride,
                          const i64* __restrict__ in, i64* __restrict__ out, int nk,
                          const u64* __restrict__ enc, const unsigned char* __restrict__ flg) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  const i64 s = g / per_shard;
  if (s >= S) return;
  const TopkOrd ord = {n, nk, enc, flg};
  topk_merge_one(L, k, span, in + s * stride, out + s * stride, g - s * per_shard, ord);
}

__global__ void k20_finish(i64 n, i64 S, i64 L, i64 k, i64 stride, int nk,
                           const i64* __restrict__ in, const u64* __restrict__ enc,
                           const unsigned char* __restrict__ flg,
                           const unsigned long long* __restrict__ count, i64* __restrict__ idx,
                           i64* __restrict__ n_live, i64* __restrict__ words,
                           unsigned char* __restrict__ nulls) {
  const i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= S * k) return;
  const i64 s = g / k, j = g - s * k;
  const i64 row = in[s * stride + j];
  idx[g] = row - s * L;
  const unsigned f = flg[row];
  for (int key = 0; key < nk; ++key) {
    const i64 o = ((i64)s * nk + key) * k + j;
    words[o] = (i64)enc[(i64)key * n + row];
    nulls[o] = (unsigned char)((f >> key) & 1u);
  }
  if (j == 0) {
    const i64 c = (i64)count[s];
    n_live[s] = c < k ? c : k;
  }
}

extern "C" int shard_topk_tile() { return K20_TILE; }

// enc holds max(nk, 1) * S * L int64, flg S * L bytes, buf_a and buf_b
// each S * ceil(L / K20_TILE) * min(k, K20_TILE) int64, count S int64;
// idx [S, k], n_live [S], words [S, nk, k], nulls [S, nk, k].
extern "C" int shard_topk_launch(i64 S, i64 L, i64 k, const unsigned char* mask, int nk,
                                 const i64* keys, u64* enc, unsigned char* flg, i64* buf_a,
                                 i64* buf_b, i64* count, i64* idx, i64* n_live, i64* words,
                                 unsigned char* nulls, void* stream) {
  if (S < 1 || L < 1 || k < 1 || k > L || nk < 0 || nk > K20_MAXK) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const i64 n = S * L;
  cudaError_t e = cudaMemsetAsync(count, 0, (size_t)S * sizeof(i64), st);
  if (e != cudaSuccess) return (int)e;
  const i64 tps = (L + K20_TILE - 1) / K20_TILE;
  if (S * tps > 0x7fffffff) return -1;
  k20_tiles<<<(unsigned)(S * tps), K20_THREADS, 0, st>>>(n, L, tps, k, mask, nk, keys, enc, flg,
                                                         buf_a, (unsigned long long*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const i64 stride = tps * (k < K20_TILE ? k : K20_TILE);
  i64* in = buf_a;
  i64* out = buf_b;
  for (i64 span = K20_TILE; span < L; span *= 2) {
    const i64 s_in = k < span ? k : span;
    const i64 per_shard = (L + span - 1) / span * s_in;
    const i64 total = S * per_shard;
    k20_merge<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(n, S, L, k, span, per_shard,
                                                               stride, in, out, nk, enc, flg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    i64* t = in;
    in = out;
    out = t;
  }
  k20_finish<<<(unsigned)((S * k + 255) / 256), 256, 0, st>>>(
      n, S, L, k, stride, nk, in, enc, flg, (const unsigned long long*)count, idx, n_live,
      words, nulls);
  return (int)cudaGetLastError();
}
