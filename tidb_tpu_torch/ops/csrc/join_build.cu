// K11 join_build: the build side of the device hash join.
//
// Replaces tidb_tpu/ops/kernels.py:1666 _join_build_impl (a stable
// lexsort of (not valid, key) over the bucket-padded right key plane, a
// +sentinel tail over the NULL and padding rows, and n_valid). The answer
// is the stable order of the valid right rows by key: equal keys keep
// right-scan order, which is what carries the row engine's emission order
// through the join. No sentinel tail: the probe (K12) searches only
// [0, n_valid), which is what the reference's clamp to n_valid computes,
// so a genuine I64_MAX or +inf key still matches.
//
// This file compacts: each valid row writes its order word (common.cuh
// key_word: int64 as it is, f64 with -0.0 made +0.0 and its bits mapped to
// two's complement) and its row index at its rank among the valid rows,
// so NULL rows and padding never enter the sort. The wrapper
// (ops/kernels.py join_build) reads n_valid back and orders the compacted
// words with one stable torch.sort carrying the row indices; a library
// sort is the building block here as XLA's sort is the reference's.
//
// Three launches: a block per tile of K11_TILE rows counts its valid rows
// (the block totals); one block scans the totals (scan.cuh); the tiles
// scan their valid flags again (warp shuffles, then the warp totals) and
// scatter. Integer work only: deterministic.
//
// Bound by bytes: the valid byte read twice, the key read once, the word
// and row index (16 B) written per valid row.
#include "scan.cuh"

#define K11_THREADS 256
#define K11_ITEMS 4
#define K11_TILE (K11_THREADS * K11_ITEMS)

__global__ void __launch_bounds__(K11_THREADS)
k11_count(i64 n, const unsigned char* __restrict__ valid, i64* __restrict__ block_total) {
  __shared__ i64 warp_tot[32];
  const i64 base = (i64)blockIdx.x * K11_TILE + (i64)threadIdx.x * K11_ITEMS;
  i64 run = 0;
#pragma unroll
  for (int j = 0; j < K11_ITEMS; ++j) {
    const i64 i = base + j;
    if (i < n && valid[i]) ++run;
  }
  const i64 incl = block_scan_incl(run, warp_tot);
  if (threadIdx.x == blockDim.x - 1) block_total[blockIdx.x] = incl;
}

__global__ void __launch_bounds__(K11_THREADS)
k11_compact(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
            int is_f64, const i64* __restrict__ block_off, i64* __restrict__ words,
            i64* __restrict__ idx) {
  __shared__ i64 warp_tot[32];
  const i64 base = (i64)blockIdx.x * K11_TILE + (i64)threadIdx.x * K11_ITEMS;
  unsigned char ok[K11_ITEMS];
  i64 run = 0;
#pragma unroll
  for (int j = 0; j < K11_ITEMS; ++j) {
    const i64 i = base + j;
    ok[j] = i < n && valid[i];
    run += ok[j];
  }
  i64 pos = block_off[blockIdx.x] + block_scan_incl(run, warp_tot) - run;
#pragma unroll
  for (int j = 0; j < K11_ITEMS; ++j) {
    if (!ok[j]) continue;
    const i64 i = base + j;
    words[pos] = key_word(key[i], is_f64);
    idx[pos] = i;
    ++pos;
  }
}

extern "C" i64 join_build_blocks(i64 n) { return (n + K11_TILE - 1) / K11_TILE; }

// key: n int64 or f64 (bits); block_total and block_off join_build_blocks(n)
// int64; n_valid one int64; words and idx n int64 each, of which the first
// n_valid are written (in row order; the wrapper sorts them).
extern "C" int join_build_launch(i64 n, const i64* key, const unsigned char* valid, int is_f64,
                                 i64* block_total, i64* block_off, i64* n_valid, i64* words,
                                 i64* idx, void* stream) {
  if (n < 1) return -1;
  const i64 nb = join_build_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k11_count<<<(unsigned)nb, K11_THREADS, 0, st>>>(n, valid, block_total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, SCAN_TOTALS_THREADS, 0, st>>>(nb, block_total, block_off, n_valid);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k11_compact<<<(unsigned)nb, K11_THREADS, 0, st>>>(n, key, valid, is_f64, block_off, words,
                                                    idx);
  return (int)cudaGetLastError();
}
