// K17 sort_perm: the stable sort permutation of k key planes.
//
// Replaces tidb_tpu/ops/kernels.py:2126 sort_perm (one jitted
// jnp.lexsort over the bucket-padded planes, a most significant liveness
// key sorting the padding last, int64 keys split into (hi, lo) 32-bit
// digits for the TPU). The answer is np.lexsort(planes): least significant
// plane first, ties in input order. The port launches exact lengths, so
// there is no padding, no liveness key and no digit split.
//
// A least-significant-digit radix sort written out by hand, no library
// sort: for each plane, least significant first,
//   - load: the plane's values, gathered through the permutation so far,
//     become 64-bit unsigned order words (ints widened with the sign bit
//     flipped; f64 -0.0 made +0.0, negatives complemented, positives with
//     the sign bit flipped, every NaN one word above +inf), and the block
//     reduces the AND and the OR of its words (one block then folds the
//     blocks'). A byte where AND and OR agree is the same in every word:
//     that digit is skipped, so NULL planes and the high bytes of narrow
//     keys cost this one pass and no scatter.
//   - per varying 8-bit digit, lowest first: a count per (digit, block)
//     (warp-private histograms in shared memory, __match_any_sync groups
//     a warp's equal digits, the group's lowest lane adds the group's
//     size: no atomics); an exclusive scan of each digit's row of block
//     counts (one block per digit, scan.cuh) with the digit's total; a
//     stable scatter of the (word, row index) pairs: each block adds the
//     totals of the smaller digits and its own offset, and walks its tile
//     in rounds of 256 rows, a row's rank among the equal digits of its
//     round coming from its warp's match group and the counts of the
//     warps before it.
// Integer work only: the same permutation on every run.
//
// Bound by bytes: each plane read once and the int64 permutation written
// once is the least it could move; every digit pass moves the words and
// row indices twice more (32 B a row).
#include "scan.cuh"

#define K17_THREADS 256
#define K17_WARPS (K17_THREADS / 32)
#define K17_ROUNDS 8
#define K17_TILE (K17_THREADS * K17_ROUNDS)
#define K17_SIGN 0x8000000000000000ull
#define K17_NAN_WORD 0xFFF0000000000001ull

// plane dtypes: the contract with ops/kernels.py _SORT_DTYPES
enum K17Dtype { K17_I64 = 0, K17_F64 = 1, K17_I32 = 2, K17_I8 = 3 };

__device__ __forceinline__ u64 k17_word(const void* src, int dtype, i64 j) {
  switch (dtype) {
    case K17_I64: return (u64)((const i64*)src)[j] ^ K17_SIGN;
    case K17_I32: return (u64)(i64)((const int*)src)[j] ^ K17_SIGN;
    case K17_I8: return (u64)(i64)((const signed char*)src)[j] ^ K17_SIGN;
    default: {
      const double v = ((const double*)src)[j];
      if (v != v) return K17_NAN_WORD;
      if (v == 0.0) return K17_SIGN;                 // -0.0 ties +0.0
      const u64 b = (u64)__double_as_longlong(v);
      return (b & K17_SIGN) ? ~b : (b ^ K17_SIGN);
    }
  }
}

__global__ void __launch_bounds__(K17_THREADS)
k17_load(i64 n, const void* __restrict__ src, int dtype, const i64* __restrict__ idx_in,
         u64* __restrict__ keys, i64* __restrict__ idx_out, u64* __restrict__ part) {
  __shared__ u64 w_and[K17_WARPS], w_or[K17_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const i64 base = (i64)blockIdx.x * K17_TILE;
  u64 a = ~0ull, o = 0ull;
#pragma unroll
  for (int r = 0; r < K17_ROUNDS; ++r) {
    const i64 i = base + (i64)r * K17_THREADS + threadIdx.x;
    if (i >= n) break;
    i64 j = i;
    if (idx_in) j = idx_in[i];
    else idx_out[i] = i;
    const u64 w = k17_word(src, dtype, j);
    keys[i] = w;
    a &= w;
    o |= w;
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
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = o;
  }
}

// One block: bits = (AND, OR) over the nb blocks' partials.
__global__ void __launch_bounds__(1024)
k17_fold(i64 nb, const u64* __restrict__ part, u64* __restrict__ bits) {
  __shared__ u64 w_and[32], w_or[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64 a = ~0ull, o = 0ull;
  for (i64 b = threadIdx.x; b < nb; b += blockDim.x) {
    a &= part[2 * b];
    o |= part[2 * b + 1];
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
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      a &= w_and[w];
      o |= w_or[w];
    }
    bits[0] = a;
    bits[1] = o;
  }
}

__device__ __forceinline__ unsigned k17_digit(u64 w, int shift) {
  return (unsigned)((w >> shift) & 0xffull);
}

// counts[d * nb + b]: rows of block b whose digit is d.
__global__ void __launch_bounds__(K17_THREADS)
k17_count(i64 n, int shift, const u64* __restrict__ keys, i64 nb, i64* __restrict__ counts) {
  __shared__ int hist[K17_WARPS][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = threadIdx.x; t < K17_WARPS * 256; t += K17_THREADS) (&hist[0][0])[t] = 0;
  __syncthreads();
  const i64 base = (i64)blockIdx.x * K17_TILE;
  for (int r = 0; r < K17_ROUNDS; ++r) {
    const i64 i = base + (i64)r * K17_THREADS + threadIdx.x;
    const bool in = i < n;
    const unsigned dg = in ? k17_digit(keys[i], shift) : 256u;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (in && lane == __ffs(peers) - 1) hist[warp][dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int d = threadIdx.x; d < 256; d += K17_THREADS) {
    int c = 0;
    for (int w = 0; w < K17_WARPS; ++w) c += hist[w][d];
    counts[(i64)d * nb + blockIdx.x] = c;
  }
}

// Block d: counts[d * nb + b] becomes the rows of digit d in blocks
// [0, b); totals[d] the rows of digit d.
__global__ void __launch_bounds__(SCAN_TOTALS_THREADS)
k17_scan(i64 nb, i64* __restrict__ counts, i64* __restrict__ totals) {
  __shared__ i64 warp_tot[32];
  __shared__ i64 chunk;
  i64* row = counts + (i64)blockIdx.x * nb;
  i64 carry = 0;
  for (i64 b0 = 0; b0 < nb; b0 += blockDim.x) {
    const i64 b = b0 + threadIdx.x;
    const i64 x = b < nb ? row[b] : 0;
    const i64 incl = block_scan_incl(x, warp_tot);
    if (b < nb) row[b] = carry + incl - x;
    if (threadIdx.x == blockDim.x - 1) chunk = incl;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(K17_THREADS)
k17_scatter(i64 n, int shift, const u64* __restrict__ keys_in, const i64* __restrict__ idx_in,
            i64 nb, const i64* __restrict__ offs, const i64* __restrict__ totals,
            u64* __restrict__ keys_out, i64* __restrict__ idx_out) {
  __shared__ i64 warp_tot[32];
  __shared__ i64 next[256];                 // where the block's next row of digit d goes
  __shared__ int wcount[K17_WARPS][256];    // this round: rows of digit d in warp w
  __shared__ i64 wbase[K17_WARPS][256];     // this round: where warp w's first one goes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    const int d = threadIdx.x;              // K17_THREADS == 256 digits
    const i64 t = totals[d];
    const i64 below = block_scan_incl(t, warp_tot) - t;
    next[d] = below + offs[(i64)d * nb + blockIdx.x];
  }
  for (int t = threadIdx.x; t < K17_WARPS * 256; t += K17_THREADS) (&wcount[0][0])[t] = 0;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;
  const i64 base = (i64)blockIdx.x * K17_TILE;
  for (int r = 0; r < K17_ROUNDS; ++r) {
    const i64 i = base + (i64)r * K17_THREADS + threadIdx.x;
    const bool in = i < n;
    const u64 w = in ? keys_in[i] : 0ull;
    const unsigned dg = in ? k17_digit(w, shift) : 256u;
    const unsigned peers = __match_any_sync(0xffffffffu, dg);
    if (in && lane == __ffs(peers) - 1) wcount[warp][dg] = __popc(peers);
    __syncthreads();
    {
      const int d = threadIdx.x;
      i64 at = next[d];
      for (int q = 0; q < K17_WARPS; ++q) {
        wbase[q][d] = at;
        at += wcount[q][d];
        wcount[q][d] = 0;
      }
      next[d] = at;
    }
    __syncthreads();
    if (in) {
      const i64 pos = wbase[warp][dg] + __popc(peers & lt);
      keys_out[pos] = w;
      idx_out[pos] = idx_in[i];
    }
  }
}

extern "C" i64 sort_perm_blocks(i64 n) { return (n + K17_TILE - 1) / K17_TILE; }

// One plane: keys[i] = the order word of src[idx_in[i]] (src[i] when
// idx_in is null; idx_out[i] = i is then written); part 2 * nb u64 of
// scratch; bits[0] / bits[1] = AND / OR of every word.
extern "C" int sort_perm_load_launch(i64 n, const void* src, int dtype, const i64* idx_in,
                                     u64* keys, i64* idx_out, u64* part, u64* bits,
                                     void* stream) {
  if (n < 1 || dtype < 0 || dtype > 3) return -1;
  const i64 nb = sort_perm_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k17_load<<<(unsigned)nb, K17_THREADS, 0, st>>>(n, src, dtype, idx_in, keys, idx_out, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k17_fold<<<1, 1024, 0, st>>>(nb, part, bits);
  return (int)cudaGetLastError();
}

// One stable pass on the digit at `shift`: (keys_in, idx_in) → (keys_out,
// idx_out); counts 256 * nb and totals 256 int64 of scratch.
extern "C" int sort_perm_digit_launch(i64 n, int shift, const u64* keys_in, const i64* idx_in,
                                      u64* keys_out, i64* idx_out, i64* counts, i64* totals,
                                      void* stream) {
  if (n < 1 || shift < 0 || shift > 56) return -1;
  const i64 nb = sort_perm_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k17_count<<<(unsigned)nb, K17_THREADS, 0, st>>>(n, shift, keys_in, nb, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k17_scan<<<256, SCAN_TOTALS_THREADS, 0, st>>>(nb, counts, totals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k17_scatter<<<(unsigned)nb, K17_THREADS, 0, st>>>(n, shift, keys_in, idx_in, nb, counts,
                                                    totals, keys_out, idx_out);
  return (int)cudaGetLastError();
}
