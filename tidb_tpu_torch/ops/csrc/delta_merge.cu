// K19 delta_merge_order: the merge order of a cached base batch and its
// region's delta (the HTAP freshness tier, copr/delta.py).
//
// Replaces tidb_tpu/ops/kernels.py:293 delta_merge_order (searchsorted of
// the base handles into the sorted tombstones for the keep mask, dead and
// tombstoned rows given the handle I64_MAX, the appended handles
// concatenated, one stable argsort, order[:n_live]). Order index i < n is
// base row i, n + j appended row j; the order ascends by handle, a base
// row before an appended row of the same handle (the stable argsort's tie
// rule).
//
// Both runs are already sorted by handle (the live base handles ascend:
// pack_ranges walks row keys in order and a merge emits in handle order;
// the tombstones and appended handles are sorted lists), so the order is a
// merge, not a sort:
//   1. k19_mask: each kept-or-not decision is a binary search of the live
//      base handle in the tombstones (staged in shared memory when they
//      fit); the keep byte is stored, each tile counts its kept rows and
//      checks, in the same pass, that the live handles strictly ascend;
//   2. k19_totals: one block scans the tile counts (the kept rows' ranks
//      start there), carries the ascent check across tiles and checks
//      that the tombstones and appended handles ascend;
//   3. k19_scatter_base: kept row i, of rank r_i among the kept rows,
//      goes to r_i + #(appended handles < h_i), and its handle to
//      kept_h[r_i];
//   4. k19_scatter_app: appended row j goes to j + #(kept handles <=
//      app[j]), a binary search of kept_h.
// Every position is unique, so the scatter needs no atomics; integer work
// only: the same order on every run. A broken precondition is reported in
// meta[1] (the wrapper raises); every position stays inside [0, n_kept +
// k) whatever the inputs, so a broken precondition writes no memory out
// of bounds.
//
// Bound by bytes: the handle plane and the live bytes read once, the
// tombstones and appended handles once, the order (8 B a live row)
// written once; the keep bytes and kept_h are this design's extra traffic
// (9 B a base row and 8 B a kept row each way).
#include "scan.cuh"

#define K19_THREADS 256
#define K19_ITEMS 8
#define K19_TILE (K19_THREADS * K19_ITEMS)
#define K19_SMEM_MAX (96 * 1024)
#define K19_I64_MAX 0x7fffffffffffffffll
#define K19_I64_MIN (-K19_I64_MAX - 1)

// precondition flags: the contract with ops/kernels.py
#define K19_BAD_BASE 1      // the live base handles do not strictly ascend
#define K19_BAD_TOMB 2      // the tombstones do not ascend
#define K19_BAD_APP 4       // the appended handles do not ascend
#define K19_BAD_SENTINEL 8  // a live base or appended handle is I64_MAX

__device__ __forceinline__ i64 k19_lower(const i64* a, i64 len, i64 x) {
  i64 lo = 0, hi = len;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ i64 k19_upper(const i64* a, i64 len, i64 x) {
  i64 lo = 0, hi = len;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// (any live row, max live handle) over a prefix: the ascent check's scan
// element. Identity (0, I64_MIN).
struct K19Seen {
  int f;
  i64 v;
};

__device__ __forceinline__ K19Seen k19_comb(K19Seen a, K19Seen b) {
  K19Seen r;
  r.f = a.f | b.f;
  r.v = a.v > b.v ? a.v : b.v;
  return r;
}

// Exclusive scan of s over the block (blockDim.x a multiple of 32);
// warp_f / warp_v 32 entries of shared memory.
__device__ __forceinline__ K19Seen k19_scan_excl(K19Seen s, int* warp_f, i64* warp_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  K19Seen x = s;
  for (int off = 1; off < 32; off <<= 1) {
    K19Seen y;
    y.f = __shfl_up_sync(0xffffffffu, x.f, off);
    y.v = __shfl_up_sync(0xffffffffu, x.v, off);
    if (lane >= off) x = k19_comb(y, x);
  }
  if (lane == 31) {
    warp_f[warp] = x.f;
    warp_v[warp] = x.v;
  }
  __syncthreads();
  if (warp == 0) {
    K19Seen t;
    t.f = lane < nwarps ? warp_f[lane] : 0;
    t.v = lane < nwarps ? warp_v[lane] : K19_I64_MIN;
    for (int off = 1; off < 32; off <<= 1) {
      K19Seen y;
      y.f = __shfl_up_sync(0xffffffffu, t.f, off);
      y.v = __shfl_up_sync(0xffffffffu, t.v, off);
      if (lane >= off) t = k19_comb(y, t);
    }
    if (lane < nwarps) {
      warp_f[lane] = t.f;
      warp_v[lane] = t.v;
    }
  }
  __syncthreads();
  // exclusive: the warps before, then the lanes before
  K19Seen r;
  r.f = warp == 0 ? 0 : warp_f[warp - 1];
  r.v = warp == 0 ? K19_I64_MIN : warp_v[warp - 1];
  K19Seen lanes;
  lanes.f = __shfl_up_sync(0xffffffffu, x.f, 1);
  lanes.v = __shfl_up_sync(0xffffffffu, x.v, 1);
  if (lane > 0) r = k19_comb(r, lanes);
  __syncthreads();                      // warp_f / warp_v free again
  return r;
}

// Pass 1. tile_* have one entry per tile: kept rows, whether a live row
// exists, the smallest and the largest live handle, the broken flags.
__global__ void __launch_bounds__(K19_THREADS)
k19_mask(i64 n, const i64* __restrict__ h, const unsigned char* __restrict__ live,
         const i64* __restrict__ tomb, i64 m, int tomb_smem, unsigned char* __restrict__ keep,
         i64* __restrict__ tile_kept, int* __restrict__ tile_any, i64* __restrict__ tile_min,
         i64* __restrict__ tile_max, int* __restrict__ tile_bad) {
  extern __shared__ i64 s_stage[];
  __shared__ i64 warp_tot[32];
  __shared__ int warp_f[32];
  __shared__ i64 warp_v[32];
  const i64* T = tomb;
  if (tomb_smem) {
    for (i64 j = threadIdx.x; j < m; j += blockDim.x) s_stage[j] = tomb[j];
    __syncthreads();
    T = s_stage;
  }
  const i64 base = (i64)blockIdx.x * K19_TILE + (i64)threadIdx.x * K19_ITEMS;
  i64 kept = 0;
  K19Seen mine;
  mine.f = 0;
  mine.v = K19_I64_MIN;
  i64 first = K19_I64_MAX;
  int bad = 0;
#pragma unroll
  for (int j = 0; j < K19_ITEMS; ++j) {
    const i64 i = base + j;
    if (i >= n) break;
    unsigned char kp = 0;
    if (live[i]) {
      const i64 hv = h[i];
      if (mine.f && hv <= mine.v) bad |= K19_BAD_BASE;
      if (hv == K19_I64_MAX) bad |= K19_BAD_SENTINEL;
      if (!mine.f) first = hv;
      mine.f = 1;
      mine.v = hv > mine.v ? hv : mine.v;
      const i64 p = k19_lower(T, m, hv);
      kp = !(p < m && T[p] == hv);
    }
    keep[i] = kp;
    kept += kp;
  }
  // the live handles of the threads before must all lie below mine
  const K19Seen before = k19_scan_excl(mine, warp_f, warp_v);
  if (mine.f && before.f && before.v >= first) bad |= K19_BAD_BASE;
  const i64 incl = block_scan_incl(kept, warp_tot);
  // the tile's (any, max) is the inclusive scan at the last thread
  const K19Seen all = k19_comb(before, mine);
  // the smallest live handle: the first of the first thread with any
  const int base_bad = __syncthreads_or(bad & K19_BAD_BASE);
  const int sent_bad = __syncthreads_or(bad & K19_BAD_SENTINEL);
  if (mine.f && !before.f) tile_min[blockIdx.x] = first;
  if (threadIdx.x == blockDim.x - 1) {
    tile_kept[blockIdx.x] = incl;
    tile_any[blockIdx.x] = all.f;
    tile_max[blockIdx.x] = all.v;
    tile_bad[blockIdx.x] = (base_bad ? K19_BAD_BASE : 0) | (sent_bad ? K19_BAD_SENTINEL : 0);
  }
}

// Pass 2, one block of SCAN_TOTALS_THREADS: tile_off[b] = kept rows of
// the tiles before b; meta[0] = the kept rows, meta[1] = the flags.
__global__ void __launch_bounds__(SCAN_TOTALS_THREADS)
k19_totals(i64 nb, const i64* __restrict__ tile_kept, const int* __restrict__ tile_any,
           const i64* __restrict__ tile_min, const i64* __restrict__ tile_max,
           const int* __restrict__ tile_bad, const i64* __restrict__ tomb, i64 m,
           const i64* __restrict__ app, i64 k, i64* __restrict__ tile_off,
           i64* __restrict__ meta) {
  __shared__ i64 warp_tot[32];
  __shared__ int warp_f[32];
  __shared__ i64 warp_v[32];
  __shared__ i64 chunk_kept;
  __shared__ int chunk_f;
  __shared__ i64 chunk_v;
  i64 carry = 0;
  K19Seen seen;
  seen.f = 0;
  seen.v = K19_I64_MIN;
  int bad = 0;
  for (i64 b0 = 0; b0 < nb; b0 += blockDim.x) {
    const i64 b = b0 + threadIdx.x;
    const i64 x = b < nb ? tile_kept[b] : 0;
    K19Seen t;
    t.f = b < nb ? tile_any[b] : 0;
    t.v = b < nb ? tile_max[b] : K19_I64_MIN;
    const i64 incl = block_scan_incl(x, warp_tot);
    const K19Seen before = k19_comb(seen, k19_scan_excl(t, warp_f, warp_v));
    if (b < nb) {
      tile_off[b] = carry + incl - x;
      bad |= tile_bad[b];
      if (t.f && before.f && before.v >= tile_min[b]) bad |= K19_BAD_BASE;
    }
    if (threadIdx.x == blockDim.x - 1) {
      chunk_kept = incl;
      const K19Seen all = k19_comb(before, t);
      chunk_f = all.f;
      chunk_v = all.v;
    }
    __syncthreads();
    carry += chunk_kept;
    seen.f = chunk_f;
    seen.v = chunk_v;
    __syncthreads();
  }
  for (i64 j = 1 + threadIdx.x; j < m; j += blockDim.x)
    if (tomb[j - 1] > tomb[j]) bad |= K19_BAD_TOMB;
  for (i64 j = threadIdx.x; j < k; j += blockDim.x) {
    if (j > 0 && app[j - 1] > app[j]) bad |= K19_BAD_APP;
    if (app[j] == K19_I64_MAX) bad |= K19_BAD_SENTINEL;
  }
  const int any_base = __syncthreads_or(bad & K19_BAD_BASE);
  const int any_tomb = __syncthreads_or(bad & K19_BAD_TOMB);
  const int any_app = __syncthreads_or(bad & K19_BAD_APP);
  const int any_sent = __syncthreads_or(bad & K19_BAD_SENTINEL);
  if (threadIdx.x == 0) {
    meta[0] = carry;
    meta[1] = (any_base ? K19_BAD_BASE : 0) | (any_tomb ? K19_BAD_TOMB : 0) |
              (any_app ? K19_BAD_APP : 0) | (any_sent ? K19_BAD_SENTINEL : 0);
  }
}

// Pass 3: every kept base row to its merge position.
__global__ void __launch_bounds__(K19_THREADS)
k19_scatter_base(i64 n, const i64* __restrict__ h, const unsigned char* __restrict__ keep,
                 const i64* __restrict__ tile_off, const i64* __restrict__ app, i64 k,
                 int app_smem, i64* __restrict__ order, i64* __restrict__ kept_h) {
  extern __shared__ i64 s_stage[];
  __shared__ i64 warp_tot[32];
  const i64* A = app;
  if (app_smem) {
    for (i64 j = threadIdx.x; j < k; j += blockDim.x) s_stage[j] = app[j];
    __syncthreads();
    A = s_stage;
  }
  const i64 base = (i64)blockIdx.x * K19_TILE + (i64)threadIdx.x * K19_ITEMS;
  unsigned char kp[K19_ITEMS];
  i64 run = 0;
#pragma unroll
  for (int j = 0; j < K19_ITEMS; ++j) {
    const i64 i = base + j;
    kp[j] = i < n ? keep[i] : 0;
    run += kp[j];
  }
  i64 r = tile_off[blockIdx.x] + block_scan_incl(run, warp_tot) - run;
#pragma unroll
  for (int j = 0; j < K19_ITEMS; ++j) {
    if (!kp[j]) continue;
    const i64 i = base + j;
    const i64 hv = h[i];
    order[r + k19_lower(A, k, hv)] = i;
    kept_h[r] = hv;
    ++r;
  }
}

// Pass 4: every appended row to its merge position.
__global__ void __launch_bounds__(K19_THREADS)
k19_scatter_app(i64 n, const i64* __restrict__ app, i64 k, const i64* __restrict__ kept_h,
                const i64* __restrict__ meta, i64* __restrict__ order) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  order[j + k19_upper(kept_h, meta[0], app[j])] = n + j;
}

extern "C" i64 delta_merge_blocks(i64 n) { return (n + K19_TILE - 1) / K19_TILE; }

// h: n int64 handles; live: n bytes; tomb: m int64; app: k int64. Scratch:
// keep n bytes; tile_kept, tile_min, tile_max, tile_off nb int64 and
// tile_any, tile_bad nb int32 (nb = delta_merge_blocks(n)); kept_h n
// int64. Outputs: order n + k int64, of which the first meta[0] + k are
// written; meta 2 int64 (kept rows, flags).
extern "C" int delta_merge_launch(i64 n, const i64* h, const unsigned char* live,
                                  const i64* tomb, i64 m, const i64* app, i64 k,
                                  unsigned char* keep, i64* tile_kept, int* tile_any,
                                  i64* tile_min, i64* tile_max, int* tile_bad, i64* tile_off,
                                  i64* kept_h, i64* order, i64* meta, void* stream) {
  if (n < 0 || m < 0 || k < 0) return -1;
  const i64 nb = delta_merge_blocks(n);
  if (nb > 0x7fffffff || (k + K19_THREADS - 1) / K19_THREADS > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  const int tomb_smem = m > 0 && m * 8 <= K19_SMEM_MAX;
  const int app_smem = k > 0 && k * 8 <= K19_SMEM_MAX;
  if (nb > 0) {
    const size_t smem = tomb_smem ? (size_t)m * 8 : 0;
    e = cudaFuncSetAttribute(k19_mask, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K19_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    k19_mask<<<(unsigned)nb, K19_THREADS, smem, st>>>(n, h, live, tomb, m, tomb_smem, keep,
                                                    tile_kept, tile_any, tile_min, tile_max,
                                                    tile_bad);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k19_totals<<<1, SCAN_TOTALS_THREADS, 0, st>>>(nb, tile_kept, tile_any, tile_min, tile_max,
                                                tile_bad, tomb, m, app, k, tile_off, meta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nb > 0) {
    const size_t smem = app_smem ? (size_t)k * 8 : 0;
    e = cudaFuncSetAttribute(k19_scatter_base, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K19_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    k19_scatter_base<<<(unsigned)nb, K19_THREADS, smem, st>>>(n, h, keep, tile_off, app, k,
                                                            app_smem, order, kept_h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (k > 0) {
    const unsigned gb = (unsigned)((k + K19_THREADS - 1) / K19_THREADS);
    k19_scatter_app<<<gb, K19_THREADS, 0, st>>>(n, app, k, kept_h, meta, order);
    e = cudaGetLastError();
  }
  return (int)e;
}
