// K18 window_scan: ranking and default-frame window figures over rows
// already in window order.
//
// Replaces tidb_tpu/ops/kernels.py:2222 window_scan (searchsorted
// partition starts, peer starts and frame ends over the bucket-padded
// planes; ROW_NUMBER / RANK / DENSE_RANK by position; SUM and COUNT as
// int64 cumsum differences read at the frame end; MIN / MAX as a
// segmented associative scan with I64_MAX / I64_MIN sentinels). The frame
// is MySQL's default with ORDER BY: RANGE UNBOUNDED PRECEDING .. the
// current row's last peer.
//
// seg (partition codes) and peer (global peer-group ids) are sorted, so
// every boundary is a scan instead of a search:
//   - partition start s = a forward max-scan of (i where seg changes);
//   - peer start p, likewise over peer;
//   - frame end e = a backward min-scan of (i where the next peer differs);
//   - SUM / COUNT / MIN / MAX: a segmented inclusive scan restarting at
//     each partition start, read at e. SUM and COUNT add in uint64: the
//     reference's cumsum difference wraps modulo 2^64, signed overflow is
//     undefined in C++, unsigned wrap gives the same bits.
// Every scan is one engine in three launches: each block folds its tile
// of K18_TILE rows (warp shuffles, then the warps' totals); one block
// scans the block totals; each block scans its tile again from its
// carry-in and writes the rows. A finishing launch per figure reads the
// formula (ROW_NUMBER = i - s + 1, RANK = p - s + 1, DENSE_RANK =
// peer[i] - peer[s] + 1) or the scan at e. Integers only, no atomics: the
// same figures on every run.
//
// Bound by bytes: seg and peer read once, per reduction its values and
// contributing flags, one int64 plane written per figure.
#include "common.cuh"

#define K18_THREADS 256
#define K18_ITEMS 8
#define K18_TILE (K18_THREADS * K18_ITEMS)
#define K18_CARRY_THREADS 1024
#define K18_I64_MAX 0x7fffffffffffffffll
#define K18_I64_MIN (-K18_I64_MAX - 1)

// scan modes and finishing ops: the contract with ops/kernels.py
enum K18Mode { W_START = 0, W_END = 1, W_COUNT = 2, W_SUM = 3, W_MIN = 4, W_MAX = 5 };
enum K18Fin { W_ROW_NUMBER = 0, W_RANK = 1, W_DENSE_RANK = 2, W_FRAME = 3 };
enum K18Op { K18_OP_ADD = 0, K18_OP_MIN = 1, K18_OP_MAX = 2 };

// A scan element: a value and whether a partition starts at it.
struct SV {
  u64 v;
  int f;
};

__device__ __forceinline__ int k18_op(int mode) {
  switch (mode) {
    case W_START: case W_MAX: return K18_OP_MAX;
    case W_END: case W_MIN: return K18_OP_MIN;
    default: return K18_OP_ADD;
  }
}

__device__ __forceinline__ SV k18_ident(int op) {
  SV r;
  r.v = op == K18_OP_ADD ? 0ull : (u64)(op == K18_OP_MIN ? K18_I64_MAX : K18_I64_MIN);
  r.f = 0;
  return r;
}

// a before b: b's value alone where a partition starts at b.
__device__ __forceinline__ SV k18_comb(int op, SV a, SV b) {
  SV r;
  r.f = a.f | b.f;
  if (b.f) {
    r.v = b.v;
  } else if (op == K18_OP_ADD) {
    r.v = a.v + b.v;
  } else {
    const i64 x = (i64)a.v, y = (i64)b.v;
    r.v = (u64)(op == K18_OP_MIN ? (x < y ? x : y) : (x > y ? x : y));
  }
  return r;
}

__device__ __forceinline__ SV k18_shfl_up(SV x, int off) {
  SV r;
  r.v = __shfl_up_sync(0xffffffffu, x.v, off);
  r.f = __shfl_up_sync(0xffffffffu, x.f, off);
  return r;
}

// Exclusive scan of x over the block (blockDim.x a multiple of 32,
// warp_tot 32 entries of shared memory); *total gets the block's fold.
__device__ SV k18_block_excl(int op, SV x, SV* warp_tot, SV* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const SV id = k18_ident(op);
  SV incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const SV y = k18_shfl_up(incl, off);
    if (lane >= off) incl = k18_comb(op, y, incl);
  }
  SV before = k18_shfl_up(incl, 1);
  if (lane == 0) before = id;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    SV t = lane < nwarps ? warp_tot[lane] : id;
    for (int off = 1; off < 32; off <<= 1) {
      const SV y = k18_shfl_up(t, off);
      if (lane >= off) t = k18_comb(op, y, t);
    }
    if (lane < nwarps) warp_tot[lane] = t;
  }
  __syncthreads();
  const SV r = k18_comb(op, warp == 0 ? id : warp_tot[warp - 1], before);
  *total = warp_tot[nwarps - 1];
  __syncthreads();                      // warp_tot is free for the next scan
  return r;
}

// The row at scan position j: forward scans walk rows 0..n-1, W_END walks
// them backwards.
__device__ __forceinline__ i64 k18_row(int mode, i64 n, i64 j) {
  return mode == W_END ? n - 1 - j : j;
}

__device__ __forceinline__ SV k18_load(int mode, i64 n, i64 i, const i64* __restrict__ key,
                                       const i64* __restrict__ vals,
                                       const unsigned char* __restrict__ contrib) {
  SV r;
  r.f = 0;
  if (mode == W_START) {
    r.v = (u64)((i == 0 || key[i] != key[i - 1]) ? i : K18_I64_MIN);
    return r;
  }
  if (mode == W_END) {
    r.v = (u64)((i == n - 1 || key[i] != key[i + 1]) ? i : K18_I64_MAX);
    return r;
  }
  r.f = i == 0 || key[i] != key[i - 1];
  const bool ok = contrib[i] != 0;
  switch (mode) {
    case W_COUNT: r.v = ok ? 1ull : 0ull; break;
    case W_SUM: r.v = ok ? (u64)vals[i] : 0ull; break;
    case W_MIN: r.v = (u64)(ok ? vals[i] : K18_I64_MAX); break;
    default: r.v = (u64)(ok ? vals[i] : K18_I64_MIN); break;
  }
  return r;
}

// Scans the block's tile from `carry`; with `out` null only the tile's
// fold is kept (agg), else every row's inclusive figure is written.
__device__ void k18_tile(int mode, i64 n, const i64* __restrict__ key,
                         const i64* __restrict__ vals, const unsigned char* __restrict__ contrib,
                         SV carry, u64* __restrict__ out, SV* agg) {
  __shared__ SV warp_tot[32];
  const int op = k18_op(mode);
  const i64 j0 = (i64)blockIdx.x * K18_TILE + (i64)threadIdx.x * K18_ITEMS;
  SV x[K18_ITEMS];
  SV fold = k18_ident(op);
#pragma unroll
  for (int k = 0; k < K18_ITEMS; ++k) {
    const i64 j = j0 + k;
    x[k] = j < n ? k18_load(mode, n, k18_row(mode, n, j), key, vals, contrib) : k18_ident(op);
    fold = k18_comb(op, fold, x[k]);
  }
  SV total;
  SV acc = k18_comb(op, carry, k18_block_excl(op, fold, warp_tot, &total));
  if (!out) {
    *agg = total;
    return;
  }
#pragma unroll
  for (int k = 0; k < K18_ITEMS; ++k) {
    const i64 j = j0 + k;
    acc = k18_comb(op, acc, x[k]);
    if (j < n) out[k18_row(mode, n, j)] = acc.v;
  }
}

__global__ void __launch_bounds__(K18_THREADS)
k18_reduce(int mode, i64 n, const i64* __restrict__ key, const i64* __restrict__ vals,
           const unsigned char* __restrict__ contrib, i64* __restrict__ agg) {
  SV total;
  k18_tile(mode, n, key, vals, contrib, k18_ident(k18_op(mode)), nullptr, &total);
  if (threadIdx.x == 0) {
    agg[2 * blockIdx.x] = (i64)total.v;
    agg[2 * blockIdx.x + 1] = total.f;
  }
}

// One block: carry[b] = the fold of the blocks before b.
__global__ void __launch_bounds__(K18_CARRY_THREADS)
k18_carry(int mode, i64 nb, const i64* __restrict__ agg, i64* __restrict__ carry) {
  __shared__ SV warp_tot[32];
  const int op = k18_op(mode);
  SV run = k18_ident(op);
  for (i64 b0 = 0; b0 < nb; b0 += blockDim.x) {
    const i64 b = b0 + threadIdx.x;
    SV x = k18_ident(op);
    if (b < nb) {
      x.v = (u64)agg[2 * b];
      x.f = (int)agg[2 * b + 1];
    }
    SV total;
    const SV before = k18_comb(op, run, k18_block_excl(op, x, warp_tot, &total));
    if (b < nb) {
      carry[2 * b] = (i64)before.v;
      carry[2 * b + 1] = before.f;
    }
    run = k18_comb(op, run, total);
  }
}

__global__ void __launch_bounds__(K18_THREADS)
k18_down(int mode, i64 n, const i64* __restrict__ key, const i64* __restrict__ vals,
         const unsigned char* __restrict__ contrib, const i64* __restrict__ carry,
         u64* __restrict__ out) {
  SV c;
  c.v = (u64)carry[2 * blockIdx.x];
  c.f = (int)carry[2 * blockIdx.x + 1];
  k18_tile(mode, n, key, vals, contrib, c, out, nullptr);
}

__global__ void __launch_bounds__(K18_THREADS)
k18_finish(i64 n, int fin, const i64* __restrict__ peer, const i64* __restrict__ s,
           const i64* __restrict__ p, const i64* __restrict__ e, const i64* __restrict__ run,
           i64* __restrict__ out) {
  const i64 i = (i64)blockIdx.x * K18_THREADS + threadIdx.x;
  if (i >= n) return;
  switch (fin) {
    case W_ROW_NUMBER: out[i] = i - s[i] + 1; break;
    case W_RANK: out[i] = p[i] - s[i] + 1; break;
    case W_DENSE_RANK: out[i] = peer[i] - peer[s[i]] + 1; break;
    default: out[i] = run[e[i]]; break;
  }
}

extern "C" i64 window_scan_blocks(i64 n) { return (n + K18_TILE - 1) / K18_TILE; }

// One scan over n rows in `mode`: key is seg (W_START over seg, and the
// reductions) or peer (W_START, W_END); vals (int64, W_SUM / W_MIN /
// W_MAX) and contrib (bool, the reductions) may be null otherwise; agg
// and carry 2 * window_scan_blocks(n) int64 of scratch; out n int64.
extern "C" int window_scan_launch(i64 n, int mode, const i64* key, const i64* vals,
                                  const unsigned char* contrib, i64* agg, i64* carry,
                                  i64* out, void* stream) {
  if (n < 1 || mode < W_START || mode > W_MAX) return -1;
  if (mode >= W_COUNT && !contrib) return -1;
  if ((mode == W_SUM || mode == W_MIN || mode == W_MAX) && !vals) return -1;
  const i64 nb = window_scan_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k18_reduce<<<(unsigned)nb, K18_THREADS, 0, st>>>(mode, n, key, vals, contrib, agg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k18_carry<<<1, K18_CARRY_THREADS, 0, st>>>(mode, nb, agg, carry);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k18_down<<<(unsigned)nb, K18_THREADS, 0, st>>>(mode, n, key, vals, contrib, carry, (u64*)out);
  return (int)cudaGetLastError();
}

// One figure: fin W_ROW_NUMBER / W_RANK / W_DENSE_RANK from s, p and peer,
// or W_FRAME: out[i] = run[e[i]].
extern "C" int window_finish_launch(i64 n, int fin, const i64* peer, const i64* s,
                                    const i64* p, const i64* e, const i64* run, i64* out,
                                    void* stream) {
  if (n < 1 || fin < W_ROW_NUMBER || fin > W_FRAME) return -1;
  const i64 nb = (n + K18_THREADS - 1) / K18_THREADS;
  if (nb > 0x7fffffff) return -1;
  k18_finish<<<(unsigned)nb, K18_THREADS, 0, (cudaStream_t)stream>>>(n, fin, peer, s, p, e,
                                                                     run, out);
  return (int)cudaGetLastError();
}
