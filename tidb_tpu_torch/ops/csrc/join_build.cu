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
// so NULL rows and padding never enter the sort. The same launch sums up
// what the sort needs, so that one readback (ops/kernels.py join_build)
// decides it: n_valid; the OR and the AND of the valid words' unsigned
// images, whose difference marks the bits that vary (a digit varies, that
// is has more than one non-empty bin, exactly when one of its bits
// differs between two words: all digits' histograms would tell no more);
// and whether the compacted words are already non-decreasing. A sorted
// build side (a table's keys in handle order, as a region scan returns
// them) is then done with no pass; otherwise the radix of radix.cuh runs
// one pass per varying digit (ops/kernels.py radix_plan). With K21's
// partition starts (`offsets`) the order is (partition, word): the rows
// are partition-major already, so "non-decreasing" compares (partition,
// word) pairs, and the radix adds the partition id's digits as the most
// significant.
//
// Three launches, then the summary's readback: a block per tile of
// K11_TILE rows, each warp walking its contiguous slice 32 rows a step
// (ballots, shuffles for a row's valid predecessor), counts its valid rows
// and folds their OR, AND, order and first and last words; one block
// scans the counts (scan.cuh) and folds the tiles' summaries (a tile's
// first word against the last word of the nearest earlier tile with a
// valid row); the tiles walk their rows again and write each valid row at
// its rank (a warp's valid rows of a step to consecutive positions).
// Integer work only: deterministic.
//
// Bound by bytes: the valid byte read twice, the key read twice, the word
// and row index (16 B) written per valid row.
#include "scan.cuh"

#define K11_THREADS 256
#define K11_WARPS (K11_THREADS / 32)
#define K11_ITEMS 8
#define K11_TILE (K11_THREADS * K11_ITEMS)
// a tile's summary: valid rows, OR, AND, sorted, first word, its
// partition, last word, its partition
#define K11_TILE_FIELDS 8
// the summary read back: n_valid, OR, AND, sorted
#define K11_SUMMARY 4
#define K11_SIGN 0x8000000000000000ull

// (partition, word) pairs in order: is a before b?
__device__ __forceinline__ bool k11_less(i64 pa, i64 wa, i64 pb, i64 wb) {
  return pa < pb || (pa == pb && wa < wb);
}

// The partition of row `row` (the last p with offsets[p] <= row), 0
// without partitions.
__device__ __forceinline__ i64 k11_part(const i64* __restrict__ offsets, int P, i64 row) {
  if (offsets == nullptr) return 0;
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= row) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Row k of warp w's slice of a tile: warps own contiguous slices, walked
// 32 consecutive rows a step (coalesced loads and, in the compaction,
// stores).
__device__ __forceinline__ i64 k11_row(int k) {
  return (i64)blockIdx.x * K11_TILE + (threadIdx.x >> 5) * (32 * K11_ITEMS) + k * 32 +
         (threadIdx.x & 31);
}

__global__ void __launch_bounds__(K11_THREADS)
k11_count(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
          int is_f64, const i64* __restrict__ offsets, int P, i64* __restrict__ tiles) {
  __shared__ i64 s_cnt[K11_WARPS], s_fw[K11_WARPS], s_fp[K11_WARPS], s_lw[K11_WARPS],
      s_lp[K11_WARPS];
  __shared__ int s_bad[K11_WARPS];
  __shared__ unsigned long long s_or, s_and;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) {
    s_or = 0ull;
    s_and = ~0ull;
  }
  __syncthreads();
  // the warp's slice in row order: its count, OR and AND, whether each
  // valid row's (partition, word) is at least its predecessor's, and its
  // first and last valid pair (warp-uniform)
  i64 cnt = 0, fw = 0, fp = 0, lw = 0, lp = 0;
  u64 o = 0ull, a = ~0ull;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < K11_ITEMS; ++k) {
    const i64 i = k11_row(k);
    const bool ok = i < n && valid[i];
    const i64 w = ok ? key_word(key[i], is_f64) : 0;
    const i64 p = ok ? k11_part(offsets, P, i) : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (bal == 0u) continue;
    const unsigned before = bal & lt;
    const int src = before != 0u ? 31 - __clz(before) : lane;
    const i64 pw = __shfl_sync(0xffffffffu, w, src), pp = __shfl_sync(0xffffffffu, p, src);
    if (ok) {
      o |= (u64)w ^ K11_SIGN;
      a &= (u64)w ^ K11_SIGN;
      if (before != 0u ? k11_less(p, w, pp, pw) : (cnt > 0 && k11_less(p, w, lp, lw)))
        bad = true;
    }
    const int first = __ffs(bal) - 1, last = 31 - __clz(bal);
    if (cnt == 0) {
      fw = __shfl_sync(0xffffffffu, w, first);
      fp = __shfl_sync(0xffffffffu, p, first);
    }
    lw = __shfl_sync(0xffffffffu, w, last);
    lp = __shfl_sync(0xffffffffu, p, last);
    cnt += __popc(bal);
  }
  const bool wbad = __any_sync(0xffffffffu, bad);
  if (cnt > 0) {
    atomicOr(&s_or, (unsigned long long)o);
    atomicAnd(&s_and, (unsigned long long)a);
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_fw[warp] = fw;
    s_fp[warp] = fp;
    s_lw[warp] = lw;
    s_lp[warp] = lp;
    s_bad[warp] = wbad;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  // the warps in order
  i64* d = tiles + (i64)blockIdx.x * K11_TILE_FIELDS;
  i64 total = 0;
  int sorted = 1, prev = -1;
  for (int v = 0; v < K11_WARPS; ++v) {
    if (s_cnt[v] == 0) continue;
    if (s_bad[v] || (prev >= 0 && k11_less(s_fp[v], s_fw[v], s_lp[prev], s_lw[prev])))
      sorted = 0;
    if (prev < 0) {
      d[4] = s_fw[v];
      d[5] = s_fp[v];
    }
    prev = v;
    total += s_cnt[v];
  }
  if (prev >= 0) {
    d[6] = s_lw[prev];
    d[7] = s_lp[prev];
  }
  d[0] = total;
  d[1] = (i64)s_or;
  d[2] = (i64)s_and;
  d[3] = sorted;
}

// Exclusive max scan over the block of x >= -1 (blockDim.x a multiple of
// 32): the largest x of the lower threads, or -1; *all gets the block's
// largest. wm is 32 int of shared memory.
__device__ __forceinline__ int k11_max_excl(int x, int* wm, int* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off && y > incl) incl = y;
  }
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) wm[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? wm[lane] : -1;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off && y > v) v = y;
    }
    if (lane < nw) wm[lane] = v;
  }
  __syncthreads();
  if (warp > 0 && wm[warp - 1] > excl) excl = wm[warp - 1];
  *all = wm[nw - 1];
  __syncthreads();                      // wm is free for the next scan
  return excl;
}

// One block of SCAN_TOTALS_THREADS over the nb tile summaries: off[b] =
// the valid rows of tiles [0, b); summary = (n_valid, OR, AND, sorted).
__global__ void __launch_bounds__(SCAN_TOTALS_THREADS)
k11_fold(i64 nb, const i64* __restrict__ tiles, i64* __restrict__ off,
         i64* __restrict__ summary) {
  __shared__ i64 warp_tot[32];
  __shared__ int wm[32];
  __shared__ i64 chunk;
  __shared__ int s_last;
  __shared__ unsigned long long s_or, s_and;
  const int t = threadIdx.x;
  if (t == 0) {
    s_last = -1;
    s_or = 0ull;
    s_and = ~0ull;
  }
  __syncthreads();
  i64 carry = 0;
  u64 o = 0ull, a = ~0ull;
  bool ok = true;
  for (i64 b0 = 0; b0 < nb; b0 += blockDim.x) {
    const i64 b = b0 + t;
    const i64* d = tiles + b * K11_TILE_FIELDS;
    const i64 x = b < nb ? d[0] : 0;
    const i64 incl = block_scan_incl(x, warp_tot);
    if (b < nb) off[b] = carry + incl - x;
    if (t == blockDim.x - 1) chunk = incl;
    int cmax = -1;
    int prev = k11_max_excl(x > 0 ? (int)b : -1, wm, &cmax);   // syncs
    if (s_last > prev) prev = s_last;
    if (x > 0) {
      o |= (u64)d[1];
      a &= (u64)d[2];
      if (!d[3]) ok = false;
      if (prev >= 0) {
        const i64* q = tiles + (i64)prev * K11_TILE_FIELDS;
        if (k11_less(d[5], d[4], q[7], q[6])) ok = false;
      }
    }
    __syncthreads();
    carry += chunk;
    if (t == 0 && cmax > s_last) s_last = cmax;
    __syncthreads();
  }
  atomicOr(&s_or, (unsigned long long)o);
  atomicAnd(&s_and, (unsigned long long)a);
  const int sorted = __syncthreads_and(ok);
  if (t == 0) {
    summary[0] = carry;
    summary[1] = (i64)s_or;
    summary[2] = (i64)s_and;
    summary[3] = sorted;
  }
}

__global__ void __launch_bounds__(K11_THREADS)
k11_compact(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
            int is_f64, const i64* __restrict__ block_off, i64* __restrict__ words,
            i64* __restrict__ idx) {
  __shared__ i64 s_cnt[K11_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  unsigned bal[K11_ITEMS];
  i64 cnt = 0;
#pragma unroll
  for (int k = 0; k < K11_ITEMS; ++k) {
    const i64 i = k11_row(k);
    bal[k] = __ballot_sync(0xffffffffu, i < n && valid[i]);
    cnt += __popc(bal[k]);
  }
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  i64 pos = block_off[blockIdx.x];
  for (int v = 0; v < warp; ++v) pos += s_cnt[v];
#pragma unroll
  for (int k = 0; k < K11_ITEMS; ++k) {
    if ((bal[k] >> lane) & 1u) {
      const i64 i = k11_row(k);
      const i64 p = pos + __popc(bal[k] & lt);
      words[p] = key_word(key[i], is_f64);
      idx[p] = i;
    }
    pos += __popc(bal[k]);
  }
}

extern "C" i64 join_build_blocks(i64 n) { return (n + K11_TILE - 1) / K11_TILE; }

// key: n int64 or f64 (bits); offsets: null, or P + 1 ascending partition
// starts of partition-major planes; tiles K11_TILE_FIELDS *
// join_build_blocks(n) int64 and block_off join_build_blocks(n) int64
// (scratch); summary K11_SUMMARY int64 on the device, host_summary the
// same in page-locked host memory, which holds it when the call returns
// (the call waits for the stream); words and idx n int64 each, of which
// the first n_valid are written (in row order).
extern "C" int join_build_launch(i64 n, const i64* key, const unsigned char* valid, int is_f64,
                                 const i64* offsets, int P, i64* tiles, i64* block_off,
                                 i64* summary, i64* host_summary, i64* words, i64* idx,
                                 void* stream) {
  if (n < 1 || (offsets != nullptr && P < 1)) return -1;
  const i64 nb = join_build_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k11_count<<<(unsigned)nb, K11_THREADS, 0, st>>>(n, key, valid, is_f64, offsets, P, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k11_fold<<<1, SCAN_TOTALS_THREADS, 0, st>>>(nb, tiles, block_off, summary);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k11_compact<<<(unsigned)nb, K11_THREADS, 0, st>>>(n, key, valid, is_f64, block_off, words,
                                                    idx);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(host_summary, summary, K11_SUMMARY * sizeof(i64), cudaMemcpyDeviceToHost,
                      st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(st);
}
