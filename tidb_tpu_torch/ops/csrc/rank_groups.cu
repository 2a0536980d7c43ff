// K8 rank_groups: group ids of a ranked group-by, in sorted space.
//
// Replaces the rank step of tidb_tpu/ops/kernels.py:989
// build_ranked_group_fn (:1009-1078: boundary flags over the lexsorted
// group columns, `ngroups`, the cumsum ranks clamped into S - 1, the
// representatives gathered at segment starts). As in the reference, a
// library sort is the building block: the caller lexsorts the rows
// (torch.sort, stable; live rows first, then the group columns in
// declaration order, null flag before value) and hands over the
// permutation.
//
// Inputs: n sorted positions, the permutation `order` (row at sorted
// position i), the row-order live mask, and per group column K8_COL int64
// (values pointer, valid pointer, is-f64 flag). A live sorted row opens a
// group when it is position 0 or any column's (null flag, value) differs
// from the previous sorted row's (f64 compared as doubles, so -0.0 equals
// +0.0). Outputs: gid[i] = (inclusive count of openers up to i) - 1,
// clamped to S - 1, dead rows S - 1; ngroups; and for each opener of rank
// r < S: starts[r] = i, rep[c][r] = column c's value (f64 bits) at the
// opener's row, nonnull[c][r] its valid flag. Segments that no row opens
// keep starts -1, rep 0, nonnull 0.
//
// Three launches: each block flags the openers of K8_TILE positions and
// scans their counts (warp shuffles, then the warp totals); one block
// scans the block totals; a thread per position adds its block's offset
// and scatters the representatives. Integer work only: deterministic.
//
// Bound by bytes: per position 8 B of permutation, the live byte and each
// column's value and valid byte gathered through it (random reads, twice:
// this row and the previous), 1 B of opener flag and 8 B of group id
// written and read back.
#include "scan.cuh"

#define K8_THREADS 256
#define K8_ITEMS 4
#define K8_TILE (K8_THREADS * K8_ITEMS)
#define K8_COL 3            // (values pointer, valid pointer, is_f64)

// Does sorted row b open a new group after sorted row a?
__device__ __forceinline__ bool k8_differs(const i64* cols, int ncols, i64 a, i64 b) {
  for (int c = 0; c < ncols; ++c) {
    const i64* v = (const i64*)cols[K8_COL * c];
    const unsigned char* ok = (const unsigned char*)cols[K8_COL * c + 1];
    const bool oa = ok[a] != 0, ob = ok[b] != 0;
    if (oa != ob) return true;
    if (!oa) continue;                  // both NULL: one group
    if (cols[K8_COL * c + 2]) {
      if (as_f64(v[a]) != as_f64(v[b])) return true;
    } else if (v[a] != v[b]) {
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(K8_THREADS)
k8_open(i64 n, const i64* __restrict__ order, const unsigned char* __restrict__ mask,
        int ncols, const i64* __restrict__ cols, unsigned char* __restrict__ opens,
        i64* __restrict__ local, i64* __restrict__ block_total) {
  __shared__ i64 warp_tot[32];
  const i64 base = (i64)blockIdx.x * K8_TILE + (i64)threadIdx.x * K8_ITEMS;
  i64 cnt[K8_ITEMS];
  i64 run = 0;
#pragma unroll
  for (int j = 0; j < K8_ITEMS; ++j) {
    const i64 i = base + j;
    int o = 0;
    if (i < n) {
      const i64 r = order[i];
      if (mask[r]) o = (i == 0) || k8_differs(cols, ncols, order[i - 1], r);
      opens[i] = (unsigned char)o;
    }
    run += o;
    cnt[j] = run;
  }
  const i64 incl = block_scan_incl(run, warp_tot);
  const i64 before = incl - run;
#pragma unroll
  for (int j = 0; j < K8_ITEMS; ++j)
    if (base + j < n) local[base + j] = before + cnt[j];
  if (threadIdx.x == blockDim.x - 1) block_total[blockIdx.x] = incl;
}

__global__ void k8_finish(i64 n, const i64* __restrict__ order,
                          const unsigned char* __restrict__ mask, int ncols,
                          const i64* __restrict__ cols, const unsigned char* __restrict__ opens,
                          const i64* __restrict__ off, i64 S, i64* __restrict__ gid,
                          i64* __restrict__ starts, i64* __restrict__ rep,
                          unsigned char* __restrict__ nonnull) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 r = order[i];
  const i64 rank = off[i / K8_TILE] + gid[i] - 1;   // gid holds the in-block count
  gid[i] = (mask[r] && rank < S - 1) ? rank : S - 1;
  if (opens[i] && rank < S) {
    starts[rank] = i;
    for (int c = 0; c < ncols; ++c) {
      rep[(i64)c * S + rank] = ((const i64*)cols[K8_COL * c])[r];
      nonnull[(i64)c * S + rank] = ((const unsigned char*)cols[K8_COL * c + 1])[r] != 0;
    }
  }
}

extern "C" i64 rank_groups_blocks(i64 n) { return (n + K8_TILE - 1) / K8_TILE; }

// `opens` holds n bytes, `block_total` and `block_off` rank_groups_blocks(n)
// int64; rep and nonnull are [ncols][S].
extern "C" int rank_groups_launch(i64 n, const i64* order, const unsigned char* mask, int ncols,
                                  const i64* cols, i64 S, unsigned char* opens, i64* block_total,
                                  i64* block_off, i64* gid, i64* ngroups, i64* starts, i64* rep,
                                  unsigned char* nonnull, void* stream) {
  if (n < 1 || S < 1 || ncols < 1) return -1;
  const i64 nb = rank_groups_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(starts, 0xff, (size_t)S * sizeof(i64), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(rep, 0, (size_t)S * ncols * sizeof(i64), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(nonnull, 0, (size_t)S * ncols, st);
  if (e != cudaSuccess) return (int)e;
  k8_open<<<(unsigned)nb, K8_THREADS, 0, st>>>(n, order, mask, ncols, cols, opens, gid,
                                               block_total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, SCAN_TOTALS_THREADS, 0, st>>>(nb, block_total, block_off, ngroups);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k8_finish<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(n, order, mask, ncols, cols, opens,
                                                         block_off, S, gid, starts, rep, nonnull);
  return (int)cudaGetLastError();
}
