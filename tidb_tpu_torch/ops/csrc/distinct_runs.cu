// K9 distinct_runs: the run openers of DISTINCT aggregates.
//
// Replaces the boundary step of tidb_tpu/ops/kernels.py:807
// _distinct_reduce and :864 _grouped_distinct (their totals, :695
// _sorted_boundary_sums, are K2's and K4's reductions here). The caller
// lexsorts the rows by (group id, contributing first, orderable value)
// with stable torch.sort passes; a contributing row opens a run when it is
// sorted first or its group or its value differs from the previous sorted
// row's. Contribution is a sort key, so no sentinel run is needed: a
// contributing I64_MAX or +inf value opens its run like any other. The
// orderable key is int64 (f64 bits mapped so that -0.0 and +0.0 are one
// value), so keys compare as integers.
//
// Inputs: the permutation `perm` (row at sorted position i), the
// row-order key and contrib planes, the group ids in sorted order (null:
// one group). Output: firsts[row] in ROW order, so that K2 and K4's pass
// read it beside the row-order value planes.
//
// Bound by bytes: per row 8 B of permutation, the key and contrib byte
// gathered through it (twice: this row and the previous), 8 B of sorted
// group id, 1 B written (a scatter).
#include "common.cuh"

#define K9_THREADS 256

__global__ void distinct_runs_kernel(i64 n, const i64* __restrict__ perm,
                                     const i64* __restrict__ key,
                                     const unsigned char* __restrict__ contrib,
                                     const i64* __restrict__ gid_s,
                                     unsigned char* __restrict__ firsts) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const i64 r = perm[i];
  bool f = contrib[r] != 0;
  if (f && i > 0) {
    const i64 p = perm[i - 1];
    f = key[r] != key[p] || (gid_s != nullptr && gid_s[i] != gid_s[i - 1]);
  }
  firsts[r] = f;
}

extern "C" int distinct_runs_launch(i64 n, const i64* perm, const i64* key,
                                    const unsigned char* contrib, const i64* gid_s,
                                    unsigned char* firsts, void* stream) {
  if (n < 1) return -1;
  distinct_runs_kernel<<<(unsigned)((n + K9_THREADS - 1) / K9_THREADS), K9_THREADS, 0,
                         (cudaStream_t)stream>>>(n, perm, key, contrib, gid_s, firsts);
  return (int)cudaGetLastError();
}
