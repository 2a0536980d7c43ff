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
// Inputs: the live mask (K1's WHERE mask) and per key TOPK_KEY int64
// (values pointer, valid pointer, is-f64, desc). Each row is encoded once
// into an order word per key (enc, [nk][n]) and a flags byte (flg: bit 7
// dead, bit j key j's null rank), which the comparator reads (topk.cuh:
// topk_encode, TopkOrd; K20 shard_topk.cu shares them).
//
// Pass 1: a block per tile of K10_TILE rows encodes them, bitonic-sorts
// their row indices in shared memory and keeps the first min(k, tile)
// (and adds its live rows to a count, an integer atomic). Pass 2, one
// launch per round: the sorted candidate lists merge in pairs, truncated
// to k; each element finds its output slot by binary search in the other
// list (its rank in its own list plus the count of smaller elements in
// the other). Rounds go on until one list covers every row.
//
// Bound by bytes: the live byte and each key's value and valid byte read
// once per row; the order words and flags written once and read back per
// tile; then the candidate lists, read and written per round (about
// n / tile * min(k, tile) candidates in the first rounds).
#include "topk.cuh"

#define K10_TILE 1024
#define K10_THREADS 512
#define K10_MAXK 4

__global__ void __launch_bounds__(K10_THREADS)
k10_tiles(i64 n, i64 k, const unsigned char* __restrict__ mask, int nk,
          const i64* __restrict__ keys, u64* enc, unsigned char* flg, i64* __restrict__ out,
          unsigned long long* __restrict__ live_count) {
  __shared__ i64 slot[K10_TILE];
  __shared__ int warp_live[K10_THREADS / 32];
  const i64 t0 = (i64)blockIdx.x * K10_TILE;
  const int m = (int)(n - t0 < K10_TILE ? n - t0 : K10_TILE);
  int live = 0;
  for (int j = threadIdx.x; j < K10_TILE; j += K10_THREADS) {
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
    for (int w = 0; w < K10_THREADS / 32; ++w) tot += warp_live[w];
    atomicAdd(live_count, (unsigned long long)tot);
  }
  const TopkOrd ord = {n, nk, enc, flg};
  topk_tile_sort<K10_TILE, K10_THREADS>(slot, ord);
  const i64 stride_out = k < K10_TILE ? k : K10_TILE;
  const i64 len = k < m ? k : m;
  for (int j = threadIdx.x; j < len; j += K10_THREADS)
    out[(i64)blockIdx.x * stride_out + j] = slot[j];
}

__global__ void k10_merge(i64 n, i64 k, i64 span, const i64* __restrict__ in,
                          i64* __restrict__ out, int nk, const u64* __restrict__ enc,
                          const unsigned char* __restrict__ flg) {
  const TopkOrd ord = {n, nk, enc, flg};
  topk_merge_one(n, k, span, in, out, (i64)blockIdx.x * blockDim.x + threadIdx.x, ord);
}

__global__ void k10_finish(const i64* __restrict__ count, i64 k, i64* __restrict__ n_live) {
  *n_live = count[0] < k ? count[0] : k;
}

extern "C" int topk_tile() { return K10_TILE; }

// enc holds nk * n int64, flg n bytes, buf_a and buf_b each
// ceil(n / K10_TILE) * min(k, K10_TILE) int64; idx receives k row indices.
extern "C" int topk_select_launch(i64 n, i64 k, const unsigned char* mask, int nk,
                                  const i64* keys, u64* enc, unsigned char* flg, i64* buf_a,
                                  i64* buf_b, i64* count, i64* idx, i64* n_live, void* stream) {
  if (n < 1 || k < 1 || k > n || nk < 0 || nk > K10_MAXK) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(i64), st);
  if (e != cudaSuccess) return (int)e;
  const i64 tiles = (n + K10_TILE - 1) / K10_TILE;
  if (tiles > 0x7fffffff) return -1;
  k10_tiles<<<(unsigned)tiles, K10_THREADS, 0, st>>>(n, k, mask, nk, keys, enc, flg, buf_a,
                                                     (unsigned long long*)count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  i64* in = buf_a;
  i64* out = buf_b;
  for (i64 span = K10_TILE; span < n; span *= 2) {
    const i64 s_in = k < span ? k : span;
    const i64 total = (n + span - 1) / span * s_in;
    k10_merge<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(n, k, span, in, out, nk, enc,
                                                               flg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    i64* t = in;
    in = out;
    out = t;
  }
  e = cudaMemcpyAsync(idx, in, (size_t)k * sizeof(i64), cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  k10_finish<<<1, 1, 0, st>>>(count, k, n_live);
  return (int)cudaGetLastError();
}
