// A stable least-significant-digit radix sort of 64-bit words with an
// int64 payload, one digit a pass: K11 join_build (the valid build keys'
// order words, carrying their rows; within K21's partitions the
// partition id's digits as the most significant ones) and K4
// seg_agg_sorted's sorted route (group ids, carrying row positions) and
// K17 sort_perm (its composite words, carrying row positions), so that
// none of their card paths calls a library sort.
//
// A word's digits are those of its unsigned image (the sign bit flipped,
// so that unsigned order is int64 order); the caller plans the passes
// (ops/kernels.py radix_plan) over only the digits that vary, lowest
// first, so a key of 23 significant bits costs 3 passes at 8-bit digits
// where a full sort of 64-bit words costs 8. A pass may instead take its
// digit from the partition of the payload row (the last p with
// offsets[p] <= row), which sorts K21's partitions back into place after
// the word passes.
//
// One pass is three launches over tiles of RADIX_TILE rows:
//   - count: each tile's histogram of the pass's digit (shared-memory
//     integer atomics, whose result no order changes), written
//     digit-major, tile-minor;
//   - scan: a block per digit scans that digit's tile counts in tile order
//     (exclusive) and writes the digit's total;
//   - scatter: each tile ranks its rows stably. Warp w owns the w-th
//     contiguous slice of the tile and walks it 32 rows a step; a step's
//     lanes of one digit are ranked by __match_any_sync, and the group's
//     lowest lane moves the warp's private count of that digit in shared
//     memory, so a row's rank is its order among its warp's rows of its
//     digit. The warps' counts, scanned digit-major and warp-minor, place
//     every row at its tile-local sorted position in shared memory; the
//     rows then leave in that order, consecutive threads writing
//     consecutive positions of a digit's run, at the smaller digits'
//     totals plus the digit's count in the earlier tiles.
// Rows of one digit keep their order within a warp (steps, then lanes),
// across warps (slices in order) and across tiles (the scan): each pass
// is stable, and so the sort. Words and payloads go through ping-pong
// buffers the caller owns. Integer work only: the same order every run.
//
// Bound by bytes: each pass reads the words (count), then the words and
// payloads (scatter) and writes both: 40 B a row (32 B in the partition
// passes, which read the payload for the digit instead of the word).
//
// K21 key_partition runs the same count, scan and scatter with the digit
// computed from a key (its partition, up to 1,024 bins): it shares the
// scan kernel and the scatter's two tile steps below (radix_warp_rank,
// radix_tile_starts), which take the bins as a template parameter.
#pragma once

#include "scan.cuh"

#define RADIX_THREADS 256
#define RADIX_WARPS (RADIX_THREADS / 32)
#define RADIX_ITEMS 8
#define RADIX_TILE (RADIX_THREADS * RADIX_ITEMS)
// 8-bit digits: 11-bit ones take the same passes for o_orderkey's 23 bits
// at eight times the bins, and measured twice as slow at f1's build (PERF.md)
#define RADIX_BITS 8
#define RADIX_BINS (1 << RADIX_BITS)

__host__ __device__ inline int radix_tiles(long long n) {
  return (int)((n + RADIX_TILE - 1) / RADIX_TILE);
}

// int32 scratch of a pass: the tile counts [digit][tile] and the digits'
// totals
__host__ __device__ inline long long radix_scratch(long long n) {
  return (long long)RADIX_BINS * (radix_tiles(n) + 1);
}

// Dynamic shared memory of the scatter: the tile's words and payloads,
// the warps' digit counts, each digit's output offset and each row's digit.
__host__ __device__ inline long long radix_scatter_bytes() {
  return 16LL * RADIX_TILE + 4LL * RADIX_WARPS * RADIX_BINS + 4LL * RADIX_BINS +
         2LL * RADIX_TILE;
}

// The pass's digit of a row: of the word's unsigned image, or (offsets
// given) of the partition of the payload row among P partitions.
__device__ __forceinline__ int radix_digit(i64 word, i64 row, int shift,
                                           const i64* __restrict__ offsets, int P) {
  if (offsets == nullptr) return (int)((((u64)word ^ RADIX_SIGN) >> shift) & (RADIX_BINS - 1u));
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= row) lo = mid; else hi = mid - 1;
  }
  return (lo >> shift) & (RADIX_BINS - 1);
}

// A row's rank among the earlier rows of its digit d in its warp (rows
// in lane order a step; d == BINS: no row), moving the warp's count h[d]
// of the digit: the lanes of one digit meet in __match_any_sync and the
// group's lowest lane reads and moves the count.
template <int BINS>
__device__ __forceinline__ int radix_warp_rank(int d, int* h) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, d);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (d < BINS && lane == leader) base = h[d];
  base = __shfl_sync(0xffffffffu, base, leader);
  if (d < BINS && lane == leader) h[d] = base + __popc(peers);
  __syncwarp();
  return base + __popc(peers & ((1u << lane) - 1u));
}

// The tile's places, after every warp ranked its rows: whist[warp][digit]
// (the warps' counts) becomes each warp's tile-local start of the digit's
// run (digit-major, warp-minor), and gofs[digit] the run's global start
// minus its tile-local start, from counts[digit][tile] (the scan's
// exclusive offsets) and totals[digit]. Digits from `used` on have no
// count and no row. With starts given, each digit's global start (the
// smaller digits' totals) goes there too. A barrier must separate the
// ranking from this step, and this step from reading its results.
template <int BINS>
__device__ __forceinline__ void radix_tile_starts(int* whist, int* gofs,
                                                  const int* __restrict__ counts,
                                                  const int* __restrict__ totals, int n_tiles,
                                                  int used, i64* starts, i64* warp_tot) {
  constexpr int PER = BINS / RADIX_THREADS;   // digits a thread scans
  const int t = threadIdx.x;
  int tot[PER];
  i64 mine = 0, gmine = 0;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = t * PER + q;
    int run = 0;
    for (int w = 0; w < RADIX_WARPS; ++w) {
      const int c = whist[w * BINS + b];
      whist[w * BINS + b] = run;
      run += c;
    }
    tot[q] = run;
    mine += run;
    gmine += b < used ? totals[b] : 0;
  }
  i64 s = block_scan_incl(mine, warp_tot) - mine;
  i64 gs = block_scan_incl(gmine, warp_tot) - gmine;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int b = t * PER + q;
    for (int w = 0; w < RADIX_WARPS; ++w) whist[w * BINS + b] += (int)s;
    if (b < used) {
      gofs[b] = (int)(gs + counts[(i64)b * n_tiles + blockIdx.x] - s);
      if (starts != nullptr) starts[b] = gs;
      gs += totals[b];
    }
    s += tot[q];
  }
}

__global__ void __launch_bounds__(RADIX_THREADS)
radix_count(i64 n, int shift, const i64* __restrict__ offsets, int P,
            const i64* __restrict__ keys, const i64* __restrict__ pay,
            int* __restrict__ counts, int n_tiles) {
  __shared__ int hist[RADIX_BINS];
  for (int b = threadIdx.x; b < RADIX_BINS; b += RADIX_THREADS) hist[b] = 0;
  __syncthreads();
  const i64 t0 = (i64)blockIdx.x * RADIX_TILE;
  const i64 t1 = t0 + RADIX_TILE < n ? t0 + RADIX_TILE : n;
  for (i64 i = t0 + threadIdx.x; i < t1; i += RADIX_THREADS) {
    const int d = offsets == nullptr
                      ? radix_digit(keys[i], 0, shift, nullptr, 0)
                      : radix_digit(0, pay != nullptr ? pay[i] : i, shift, offsets, P);
    atomicAdd(&hist[d], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < RADIX_BINS; b += RADIX_THREADS)
    counts[(i64)b * n_tiles + blockIdx.x] = hist[b];
}

// A block per digit: its tile counts become exclusive offsets in tile
// order; totals[digit] = its rows.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_scan(int n_tiles, int* __restrict__ counts, int* __restrict__ totals) {
  __shared__ i64 warp_tot[32];
  __shared__ i64 chunk;
  int* c = counts + (i64)blockIdx.x * n_tiles;
  i64 carry = 0;
  for (int b0 = 0; b0 < n_tiles; b0 += RADIX_THREADS) {
    const int b = b0 + threadIdx.x;
    const i64 x = b < n_tiles ? c[b] : 0;
    const i64 incl = block_scan_incl(x, warp_tot);
    if (b < n_tiles) c[b] = (int)(carry + incl - x);
    if (threadIdx.x == RADIX_THREADS - 1) chunk = incl;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = (int)carry;
}

__global__ void __launch_bounds__(RADIX_THREADS)
radix_scatter(i64 n, int shift, const i64* __restrict__ offsets, int P,
              const i64* __restrict__ keys_in, const i64* __restrict__ pay_in,
              i64* __restrict__ keys_out, i64* __restrict__ pay_out,
              const int* __restrict__ counts, const int* __restrict__ totals, int n_tiles) {
  constexpr int BINS = RADIX_BINS;
  extern __shared__ i64 radix_smem[];
  i64* skey = radix_smem;                                    // [RADIX_TILE]
  i64* spay = skey + RADIX_TILE;                             // [RADIX_TILE]
  int* whist = (int*)(spay + RADIX_TILE);                    // [warp][digit]
  int* gofs = whist + RADIX_WARPS * BINS;                    // [digit]
  unsigned short* sdig = (unsigned short*)(gofs + BINS);     // [RADIX_TILE]
  __shared__ i64 warp_tot[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const i64 t0 = (i64)blockIdx.x * RADIX_TILE;
  for (int i = t; i < RADIX_WARPS * BINS; i += RADIX_THREADS) whist[i] = 0;
  __syncthreads();

  // 1. ranks within the warp's slice, in row order
  i64 key[RADIX_ITEMS], pay[RADIX_ITEMS];
  int dig[RADIX_ITEMS], rk[RADIX_ITEMS];
  int* h = whist + warp * BINS;
#pragma unroll
  for (int k = 0; k < RADIX_ITEMS; ++k) {
    const i64 row = t0 + (i64)warp * (32 * RADIX_ITEMS) + k * 32 + lane;
    const bool in = row < n;
    key[k] = in ? keys_in[row] : 0;
    pay[k] = in ? (pay_in != nullptr ? pay_in[row] : row) : 0;
    const int d = in ? radix_digit(key[k], pay[k], shift, offsets, P) : BINS;
    rk[k] = radix_warp_rank<BINS>(d, h);
    dig[k] = d;
  }
  __syncthreads();

  // 2. per digit, the warps' offsets within the digit's run (warp order)
  //    and the run's length; then the runs' tile-local starts and the
  //    digits' global starts (the totals of the smaller digits)
  radix_tile_starts<BINS>(whist, gofs, counts, totals, n_tiles, BINS, nullptr, warp_tot);
  __syncthreads();

  // 3. the tile in sorted order in shared memory
#pragma unroll
  for (int k = 0; k < RADIX_ITEMS; ++k) {
    if (dig[k] >= BINS) continue;
    const int p = whist[warp * BINS + dig[k]] + rk[k];
    skey[p] = key[k];
    spay[p] = pay[k];
    sdig[p] = (unsigned short)dig[k];
  }
  __syncthreads();

  // 4. out in that order: a digit's rows to consecutive positions
  const int m = (int)(n - t0 < RADIX_TILE ? n - t0 : RADIX_TILE);
  for (int p = t; p < m; p += RADIX_THREADS) {
    const i64 g = (i64)gofs[sdig[p]] + p;
    keys_out[g] = skey[p];
    pay_out[g] = spay[p];
  }
}

// The scatter's shared-memory opt-in, once per device.
static inline cudaError_t radix_ready() {
  static bool ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(radix_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)radix_scatter_bytes());
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  return cudaSuccess;
}

// One pass over n rows (1 <= n < 2^31): the digit at `shift` of the
// words, or, with offsets (P + 1 ascending partition starts), of the
// payload row's partition. pay_in null: the payload is the row index.
// counts: radix_scratch(n) int32.
static inline int radix_pass(i64 n, int shift, const i64* offsets, int P, const i64* keys_in,
                      const i64* pay_in, i64* keys_out, i64* pay_out, int* counts,
                      cudaStream_t st) {
  if (n < 1 || n > 0x7fffffffLL || shift < 0 || shift > 63) return -1;
  if (offsets != nullptr && P < 1) return -1;
  cudaError_t e = radix_ready();
  if (e != cudaSuccess) return (int)e;
  const int tiles = radix_tiles(n);
  int* totals = counts + (i64)RADIX_BINS * tiles;
  radix_count<<<tiles, RADIX_THREADS, 0, st>>>(n, shift, offsets, P, keys_in, pay_in, counts,
                                               tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  radix_scan<<<RADIX_BINS, RADIX_THREADS, 0, st>>>(tiles, counts, totals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  radix_scatter<<<tiles, RADIX_THREADS, (size_t)radix_scatter_bytes(), st>>>(
      n, shift, offsets, P, keys_in, pay_in, keys_out, pay_out, counts, totals, tiles);
  return (int)cudaGetLastError();
}
