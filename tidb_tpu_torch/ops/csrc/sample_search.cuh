// A sorted array searched from a sample of it staged in shared memory
// (K12 join_probe.cu over the build words, K13 dict_remap.cu over a
// domain): every 2^s-th element's search word is staged once a block; a
// search runs over the sample first, then over the one slice of at most
// 2^s - 1 elements between two sampled ones, read where the array lies.
// With s = 0 the sample is the whole array and the slice is empty.
//
// A thread searches N keys at once, step by step (binary lifting over
// power-of-two steps, the same steps for every key), so the N loads of a
// step are in flight together rather than N chains of dependent loads one
// after another. Positions inside the sample and the slice are 32-bit
// (the sample holds at most 2^31 - 1 entries, a slice at most 2^30): a
// step is one add, one predicated load and one 64-bit compare, where
// 64-bit positions and clamps cost three times the instructions.
#pragma once

#include "common.cuh"

// The length ceil(n / 2^s) of a sample of every 2^s-th of n elements (the
// host picks s: ops/kernels.py sample_shift).
static inline i64 sample_len(i64 n, int s) { return (n + ((i64)1 << s) - 1) >> s; }
// The number of bits of n (0 for 0): a lifting over at most n elements
// takes that many steps.
static inline int bit_len(i64 n) {
  int b = 0;
  while (b < 63 && ((i64)1 << b) <= n) ++b;
  return b;
}

struct WordAsIs {
  __device__ __forceinline__ i64 operator()(i64 w) const { return w; }
};

// Stage samp[k] = word(a[k << s]) for k in [0, ns) and I64_MAX_V for k in
// [ns, sp) (a padding no key is above), by the block.
template <class Word>
__device__ __forceinline__ void stage_sample(const i64* __restrict__ a, int s, int ns, int sp,
                                             i64* __restrict__ samp, Word word) {
  for (int k = threadIdx.x; k < sp; k += blockDim.x)
    samp[k] = k < ns ? word(a[(i64)k << s]) : I64_MAX_V;
}

// For each i with on[i]: x[i] = the first index in [b0[i], b1[i]) of the
// ascending array a whose search word (word(a[x])) is >= key[i] (b1[i]
// where none is), where samp[k] = word(a[k << s]) for every k < ns (the
// elements k << s below a's length) and 2^sbits is at least the number of
// sample entries any [b0, b1) holds. Only the entries whose element lies
// in [b0, b1) are searched, then the slice that can hold the bound.
//
// FULL: every range is the whole array [0, nv) and the sample is padded
// with I64_MAX_V to 2^sbits entries (stage_sample's sp), so no step checks
// a range's end. Every step loads all N words first, then compares.
template <int N, bool FULL, class Word>
__device__ __forceinline__ void sampled_lower(const i64* __restrict__ a,
                                              const i64* __restrict__ samp, int s, int sbits,
                                              const i64 (&b0)[N], const i64 (&b1)[N],
                                              const i64 (&key)[N], const bool (&on)[N],
                                              i64 (&x)[N], Word word) {
  const i64 step1 = (i64)1 << s;
  int k0[N], n[N], p[N];
  i64 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    k0[i] = FULL ? 0 : (int)((b0[i] + step1 - 1) >> s);
    n[i] = FULL ? (1 << sbits) : (on[i] ? (int)((b1[i] + step1 - 1) >> s) - k0[i] : 0);
    p[i] = 0;
  }
  // the sample: p = how many of the range's entries are < key
  for (int b = sbits - 1; b >= 0; --b) {
    const int st = 1 << b;
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = FULL || p[i] + st <= n[i] ? samp[k0[i] + p[i] + st - 1] : I64_MAX_V;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (v[i] < key[i]) p[i] += st;
  }
  // samp[k0 + p - 1] < key <= samp[k0 + p]: the bound lies in the slice
  // ((k0 + p - 1) << s, (k0 + p) << s], cut to [b0, b1)
  const i64* at[N];
  int len[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const i64 k = k0[i] + p[i];
    x[i] = p[i] > 0 ? ((k - 1) << s) + 1 : b0[i];
    const i64 y = FULL ? (k << s < b1[i] ? k << s : b1[i]) : (p[i] < n[i] ? (k << s) : b1[i]);
    len[i] = on[i] && y > x[i] ? (int)(y - x[i]) : 0;
    at[i] = a + x[i] - 1;
    p[i] = 0;
  }
  for (int b = s - 1; b >= 0; --b) {
    const int st = 1 << b;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i] + st <= len[i] ? word(at[i][p[i] + st]) : I64_MAX_V;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (v[i] < key[i]) p[i] += st;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] += p[i];
}

// For each i: x[i] = the first index in [lo, lo + len) of a whose word is
// >= key[i] (lo + len where none is), with 2^bits > len: one window for
// all N keys (a warp's in K12, whose keys all lie in it), read where a
// lies.
template <int N>
__device__ __forceinline__ void window_lower(const i64* __restrict__ a, i64 lo, int len, int bits,
                                             const i64 (&key)[N], i64 (&x)[N]) {
  const i64* at = a + lo - 1;
  int p[N];
  i64 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = 0;
  for (int b = bits - 1; b >= 0; --b) {
    const int st = 1 << b;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i] + st <= len ? at[p[i] + st] : I64_MAX_V;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (v[i] < key[i]) p[i] += st;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = lo + p[i];
}

// The same over the whole array a[0, n) with no sample, read where it
// lies (bits >= bit_len(n)).
template <int N, class Word>
__device__ __forceinline__ void lifted_lower(const i64* __restrict__ a, i64 n, int bits,
                                             const i64 (&key)[N], i64 (&x)[N], Word word) {
  i64 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0;
  for (int b = bits - 1; b >= 0; --b) {
    const i64 st = (i64)1 << b;
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = x[i] + st <= n ? word(a[x[i] + st - 1]) : I64_MAX_V;
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (v[i] < key[i]) x[i] += st;
  }
}
