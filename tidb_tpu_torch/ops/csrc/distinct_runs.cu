// K9 distinct_runs: the run openers of DISTINCT aggregates.
//
// Replaces the boundary step of tidb_tpu/ops/kernels.py:807
// _distinct_reduce and :864 _grouped_distinct (their totals, :695
// _sorted_boundary_sums, are K2's and K4's reductions here). K17 sorts
// the rows by (group id, contributing first, orderable value); a
// contributing row opens a run when it is sorted first or its group or
// its value differs from the previous sorted row's. Contribution is a sort
// key, so no sentinel run is needed: a contributing I64_MAX or +inf value
// opens its run like any other. The orderable key is int64 (f64 bits
// mapped so that -0.0 and +0.0 are one value), so keys compare as
// integers.
//
// Two modes, one output: firsts[row] in ROW order, so that K2 and K4's
// pass read it beside the row-order value planes.
//   - sorted words: where K17 packed the three planes into one composite
//     word, it hands back that word in sorted order. Equal words are equal
//     (group, contributing, value), since the bits K17 drops are equal in
//     every row; within a group contributing rows sort first, so a row
//     opens a run iff it contributes and its word differs from the
//     previous one. Whether it contributes is the flag's bit of the word
//     (`flag` >= 0), or the same for every row (K9_ALL / K9_NONE: the flag
//     plane was constant). Reads the words and the permutation coalesced;
//     the one scattered access is the firsts byte written at perm[i].
//   - gather: where the planes need more than one word, each sorted
//     position gathers the key and contrib of its row and the previous
//     row's key through the permutation, and reads the group ids in
//     sorted order (null: one group).
//
// Bound by bytes: per row 8 B of word and 8 B of permutation read, 1 B
// written (sorted words); the gather mode adds the key and contrib byte
// gathered and 8 B of sorted group id. The sorted-word mode takes four
// rows a thread in 16-byte loads, so that a load moves more bytes.
#include "common.cuh"

#define K9_THREADS 256
#define K9_ROWS 4
#define K9_ALL (-1)
#define K9_NONE (-2)

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

// K9_ROWS consecutive sorted positions a thread: the words and the
// permutation in 16-byte loads (both planes 16-byte aligned, which the
// wrapper checks), the openers of a run of consecutive rows (a
// permutation in row order, as count(distinct l_orderkey)'s) in one
// 4-byte store.
__global__ void distinct_runs_words_kernel(i64 n, const i64* __restrict__ perm,
                                           const i64* __restrict__ words, int flag,
                                           unsigned char* __restrict__ firsts) {
  const i64 i0 = ((i64)blockIdx.x * blockDim.x + threadIdx.x) * K9_ROWS;
  if (i0 >= n) return;
  i64 w[K9_ROWS + 1], p[K9_ROWS];
  w[0] = i0 > 0 ? words[i0 - 1] : 0;
  const bool full = i0 + K9_ROWS <= n;
  if (full) {
    const longlong2 a = *(const longlong2*)(words + i0), b = *(const longlong2*)(words + i0 + 2);
    const longlong2 c = *(const longlong2*)(perm + i0), d = *(const longlong2*)(perm + i0 + 2);
    w[1] = a.x; w[2] = a.y; w[3] = b.x; w[4] = b.y;
    p[0] = c.x; p[1] = c.y; p[2] = d.x; p[3] = d.y;
  } else {
    for (int k = 0; k < K9_ROWS; ++k) {
      w[k + 1] = i0 + k < n ? words[i0 + k] : 0;
      p[k] = i0 + k < n ? perm[i0 + k] : 0;
    }
  }
  unsigned char f[K9_ROWS];
#pragma unroll
  for (int k = 0; k < K9_ROWS; ++k) {
    // the stored word is the composite with its top bit flipped
    const bool c = flag >= 0 ? ((((u64)w[k + 1] ^ 0x8000000000000000ull) >> flag) & 1ull) == 0
                             : flag == K9_ALL;
    f[k] = c && (i0 + k == 0 || w[k + 1] != w[k]);
  }
  if (full && (p[0] & 3) == 0 && p[1] == p[0] + 1 && p[2] == p[0] + 2 && p[3] == p[0] + 3) {
    *(uchar4*)(firsts + p[0]) = make_uchar4(f[0], f[1], f[2], f[3]);
    return;
  }
  for (int k = 0; k < K9_ROWS && i0 + k < n; ++k) firsts[p[k]] = f[k];
}

extern "C" int distinct_runs_launch(i64 n, const i64* perm, const i64* key,
                                    const unsigned char* contrib, const i64* gid_s,
                                    unsigned char* firsts, void* stream) {
  if (n < 1) return -1;
  distinct_runs_kernel<<<(unsigned)((n + K9_THREADS - 1) / K9_THREADS), K9_THREADS, 0,
                         (cudaStream_t)stream>>>(n, perm, key, contrib, gid_s, firsts);
  return (int)cudaGetLastError();
}

extern "C" int distinct_runs_words_launch(i64 n, const i64* perm, const i64* words, int flag,
                                          unsigned char* firsts, void* stream) {
  if (n < 1 || flag < K9_NONE || flag > 63 || ((uintptr_t)perm | (uintptr_t)words) % 16)
    return -1;
  const i64 per_block = (i64)K9_THREADS * K9_ROWS;
  distinct_runs_words_kernel<<<(unsigned)((n + per_block - 1) / per_block), K9_THREADS, 0,
                               (cudaStream_t)stream>>>(n, perm, words, flag, firsts);
  return (int)cudaGetLastError();
}
