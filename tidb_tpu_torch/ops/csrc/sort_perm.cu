// K17 sort_perm: the stable sort permutation of k key planes.
//
// Replaces tidb_tpu/ops/kernels.py:2126 sort_perm (one jitted
// jnp.lexsort over the bucket-padded planes, a most significant liveness
// key sorting the padding last, int64 keys split into (hi, lo) 32-bit
// digits for the TPU). The answer is np.lexsort(planes): least significant
// plane first, ties in input order. The port launches exact lengths, so
// there is no padding, no liveness key and no digit split.
//
// Each plane's values become 64-bit unsigned order words (ints widened
// with the sign bit flipped, uint8 / bool as they are; f64 -0.0 made
// +0.0, negatives complemented, positives with the sign bit flipped, every
// NaN one word above +inf). This file holds two launches; the sort itself
// is radix.cuh's (entry points in radix_sort.cu):
//   - summary: one launch over all k planes reduces each plane's AND and
//     OR of its words (a block folds its tile, then one integer atomicOr
//     a plane and field into a zeroed summary: OR and AND have no order to
//     keep); the k pairs are copied into page-locked host memory and the
//     call waits for them, the sort's one synchronisation. Plane j's bits
//     above w_j = bit_length(AND ^ OR) are equal in every word, so its low
//     w_j bits keep its order; planes with w_j = 0 drop out.
//   - pack: the host packs the kept planes, most significant highest, into
//     as few 64-bit composite words as hold them, no plane split across
//     two (ops/kernels.py sort_plan). A pack launch writes one composite
//     word a row, stored with its top bit flipped, so that radix.cuh's
//     digit (of the word's unsigned image) reads the composite as it is.
//     The least significant composite word is packed in row order (every
//     plane read at row i, coalesced); each further one through the
//     permutation so far (one gather a plane).
// radix.cuh then sorts each composite word, least significant first, by
// only its varying 8-bit digits, carrying the row positions. Phase H's
// ORDER BY l_extendedprice DESC, l_orderkey packs into one word of about
// 47 bits: 6 passes. Integer work only: the same permutation every run.
//
// Bound by bytes: each plane read once and the int64 permutation written
// once is the least it could move; the summary reads every plane once
// more, the pack once a composite word (plus 16 B a row), every radix pass
// moves 40 B a row.
#include "common.cuh"

#define K17_THREADS 256
#define K17_WARPS (K17_THREADS / 32)
#define K17_ITEMS 8
#define K17_TILE (K17_THREADS * K17_ITEMS)
// planes one summary launch reads, fields one composite word packs (a
// field is at least one bit wide)
#define K17_MAX_PLANES 64
#define K17_NAN_WORD 0xFFF0000000000001ull

// plane dtypes: the contract with ops/kernels.py _SORT_DTYPES
enum K17Dtype { K17_I64 = 0, K17_F64 = 1, K17_I32 = 2, K17_I8 = 3, K17_U8 = 4 };

__device__ __forceinline__ u64 k17_word(const void* src, int dtype, i64 j) {
  switch (dtype) {
    case K17_I64: return (u64)((const i64*)src)[j] ^ RADIX_SIGN;
    case K17_I32: return (u64)(i64)((const int*)src)[j] ^ RADIX_SIGN;
    case K17_I8: return (u64)(i64)((const signed char*)src)[j] ^ RADIX_SIGN;
    case K17_U8: return (u64)((const unsigned char*)src)[j] ^ RADIX_SIGN;
    default: {
      const double v = ((const double*)src)[j];
      if (v != v) return K17_NAN_WORD;
      if (v == 0.0) return RADIX_SIGN;               // -0.0 ties +0.0
      const u64 b = (u64)__double_as_longlong(v);
      return (b & RADIX_SIGN) ? ~b : (b ^ RADIX_SIGN);
    }
  }
}

// A launch's planes (or a word's fields), by value.
struct K17Planes {
  const void* p[K17_MAX_PLANES];
  u64 mask[K17_MAX_PLANES];     // pack: the field's low bits
  int dtype[K17_MAX_PLANES];
  int shift[K17_MAX_PLANES];    // pack: the field's place in the word
  int k;
};

// sum[2j] |= ~(AND of plane j's words), sum[2j + 1] |= their OR.
__global__ void __launch_bounds__(K17_THREADS)
k17_summary(i64 n, const __grid_constant__ K17Planes P, u64* __restrict__ sum) {
  __shared__ u64 w_and[K17_WARPS], w_or[K17_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64 base = (i64)blockIdx.x * K17_TILE;
  for (int j = 0; j < P.k; ++j) {
    u64 a = ~0ull, o = 0ull;
#pragma unroll
    for (int r = 0; r < K17_ITEMS; ++r) {
      const i64 i = base + (i64)r * K17_THREADS + threadIdx.x;
      if (i < n) {
        const u64 w = k17_word(P.p[j], P.dtype[j], i);
        a &= w;
        o |= w;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      a &= __shfl_xor_sync(0xffffffffu, a, off);
      o |= __shfl_xor_sync(0xffffffffu, o, off);
    }
    if (lane == 0) {
      w_and[warp] = a;
      w_or[warp] = o;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < K17_WARPS; ++w) {
        a &= w_and[w];
        o |= w_or[w];
      }
      atomicOr((unsigned long long*)&sum[2 * j], (unsigned long long)~a);
      atomicOr((unsigned long long*)&sum[2 * j + 1], (unsigned long long)o);
    }
    __syncthreads();
  }
}

// words[i] = the composite word of row perm[i] (row i without perm), top
// bit flipped: field f's low bits at its shift.
__global__ void __launch_bounds__(K17_THREADS)
k17_pack(i64 n, const __grid_constant__ K17Planes W, const i64* __restrict__ perm,
         i64* __restrict__ words) {
  const i64 i = (i64)blockIdx.x * K17_THREADS + threadIdx.x;
  if (i >= n) return;
  const i64 r = perm != nullptr ? perm[i] : i;
  u64 c = 0;
  for (int f = 0; f < W.k; ++f) c |= (k17_word(W.p[f], W.dtype[f], r) & W.mask[f]) << W.shift[f];
  words[i] = (i64)(c ^ RADIX_SIGN);
}

// The summary of k >= 1 planes of n >= 1 rows: sum 2k u64 of device
// scratch, host_sum the same in page-locked memory, which holds (NOT AND,
// OR) of each plane's words when the call returns (it waits for the
// stream).
extern "C" int sort_perm_summary_launch(i64 n, int k, const void* const* planes,
                                        const int* dtypes, u64* sum, u64* host_sum,
                                        void* stream) {
  if (n < 1 || k < 1) return -1;
  const i64 nb = (n + K17_TILE - 1) / K17_TILE;
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(sum, 0, 16 * (size_t)k, st);
  if (e != cudaSuccess) return (int)e;
  for (int c = 0; c < k; c += K17_MAX_PLANES) {
    K17Planes P = {};
    P.k = k - c < K17_MAX_PLANES ? k - c : K17_MAX_PLANES;
    for (int j = 0; j < P.k; ++j) {
      if (dtypes[c + j] < K17_I64 || dtypes[c + j] > K17_U8) return -1;
      P.p[j] = planes[c + j];
      P.dtype[j] = dtypes[c + j];
    }
    k17_summary<<<(unsigned)nb, K17_THREADS, 0, st>>>(n, P, sum + 2 * c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaMemcpyAsync(host_sum, sum, 16 * (size_t)k, cudaMemcpyDeviceToHost, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(st);
}

// One composite word over n >= 1 rows from nf <= K17_MAX_PLANES fields
// (plane, dtype, shift, mask); perm null: row order.
extern "C" int sort_perm_pack_launch(i64 n, int nf, const void* const* planes, const int* dtypes,
                                     const int* shifts, const u64* masks, const i64* perm,
                                     i64* words, void* stream) {
  if (n < 1 || nf < 0 || nf > K17_MAX_PLANES) return -1;
  const i64 nb = (n + K17_THREADS - 1) / K17_THREADS;
  if (nb > 0x7fffffff) return -1;
  K17Planes W = {};
  W.k = nf;
  for (int f = 0; f < nf; ++f) {
    if (dtypes[f] < K17_I64 || dtypes[f] > K17_U8 || shifts[f] < 0 || shifts[f] > 63) return -1;
    W.p[f] = planes[f];
    W.dtype[f] = dtypes[f];
    W.shift[f] = shifts[f];
    W.mask[f] = masks[f];
  }
  k17_pack<<<(unsigned)nb, K17_THREADS, 0, (cudaStream_t)stream>>>(n, W, perm, words);
  return (int)cudaGetLastError();
}
