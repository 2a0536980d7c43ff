// K8 rank_groups: group ids of a ranked group-by, in sorted space.
//
// Replaces the rank step of tidb_tpu/ops/kernels.py:989
// build_ranked_group_fn (:1009-1078: boundary flags over the lexsorted
// group columns, `ngroups`, the cumsum ranks clamped into S - 1, the
// representatives gathered at segment starts). The caller sorts the rows
// first (K17: live rows first, then the group columns in declaration
// order, null flag before value) and hands over the permutation and the
// sort's most significant key in sorted order, each position's dead flag
// (kernels.lexsort gathers it).
//
// Two passes, so that the ladder of segment counts (ops/client.py) gathers
// the keys once a statement:
//
//   - the rank pass (k8_rank, then scan.cuh's scan_totals), once a
//     statement: each thread takes K8_ITEMS consecutive sorted positions,
//     reads their rows and dead flags (coalesced) and gathers, for a live
//     row, each column's (valid, value) once; all of a thread's loads are
//     issued before any compare. A position compares with its predecessor in
//     registers (the thread's previous item, the previous lane's last by a
//     shuffle, the previous warp's last through shared memory); only the
//     position before the tile is read again, as its halo. A live
//     position opens a group at position 0 or where any column's (null
//     flag, value image) differs from its predecessor's: an f64 value's
//     image is its bits with -0.0 made +0.0, so -0.0 groups with +0.0 and
//     NaNs of one bit pattern group together (the plain version's and the
//     CPU engine's grouping; K17 sorts by the same images). The tile's
//     openers are counted by a block scan, and each position leaves one
//     coalesced 16-bit word: (inclusive count of openers in its tile << 2)
//     | opener << 1 | live. One block scans the tiles' totals into their
//     offsets and `ngroups` (scan_totals: at most one block total per
//     K8_TILE positions, 8,192 at the batch's 8,388,608).
//   - the output pass (k8_out), at the rung that holds the groups: a
//     thread takes K8_OUT_ITEMS positions, reads their words (16 B) and
//     their tile's offset, and writes gid[i] = rank (the inclusive opener
//     count - 1), clamped to S - 1,
//     dead rows S - 1; an opener of rank r < S writes starts[r] = i and,
//     gathered at its row, rep[c][r] (value bits) and nonnull[c][r]; ranks
//     from ngroups to S - 1 get starts -1, rep 0, nonnull 0.
//
// The column table (values pointer, valid pointer, f64 flag) goes by
// value in the launch's parameters (K8Cols): nothing is copied to the card
// before a launch. Integer work only, no atomics: the same bits every run.
// Precondition, as K17 gives it: live rows sort before dead ones, so a
// live position's predecessor is live and a dead row gathers no key. The
// dead flags come in sorted order because gathering them here through the
// permutation (random one-byte reads, though the plane sits in L2) took
// 0.12 of the rank pass's 0.42 ms at ranked_dates on the H100 (PERF.md).
//
// Bound by bytes: per position 8 B of permutation and the dead byte and,
// for a live row, each column's value and valid byte, gathered through it
// at random (32 B sectors; the valid planes stay in L2 at the batch's
// size, the values do not), 2 B of word written; the output pass reads the word and
// writes 8 B of group id, and gathers the representatives at openers.
#include "scan.cuh"

#define K8_THREADS 256
#define K8_ITEMS 4
#define K8_TILE (K8_THREADS * K8_ITEMS)
#define K8_CHUNK 2           // columns a thread gathers at once
#define K8_MAX_COLS 64      // columns in the parameter table
#define K8_OUT_THREADS 256
#define K8_OUT_ITEMS 8      // positions an output thread takes (K8_TILE a multiple)

struct K8Cols {
  const i64* v[K8_MAX_COLS];
  const unsigned char* ok[K8_MAX_COLS];
  u64 f64;                  // bit c: column c holds f64 bits
  int ncols;
};

// The image a value compares by: 0 for NULL, f64 -0.0 as +0.0, else its
// bits.
__device__ __forceinline__ i64 k8_image(i64 v, bool ok, bool is_f64) {
  if (!ok) return 0;
  return (is_f64 && v == I64_MIN_V) ? 0 : v;
}

__global__ void __launch_bounds__(K8_THREADS)
k8_rank(i64 n, const i64* __restrict__ order, const unsigned char* __restrict__ dead,
        const __grid_constant__ K8Cols cols, unsigned short* __restrict__ word,
        i64* __restrict__ block_total) {
  __shared__ i64 warp_tot[32];
  __shared__ i64 last_img[K8_THREADS / 32][K8_CHUNK];
  __shared__ unsigned char last_ok[K8_THREADS / 32][K8_CHUNK];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const i64 base = (i64)blockIdx.x * K8_TILE;
  const i64 i0 = base + (i64)t * K8_ITEMS;

  i64 row[K8_ITEMS];
  bool live[K8_ITEMS], diff[K8_ITEMS];
#pragma unroll
  for (int j = 0; j < K8_ITEMS; ++j) row[j] = i0 + j < n ? order[i0 + j] : 0;
  // the halo: the row before the tile, compared with the tile's first
  const i64 hrow = (t == 0 && base > 0) ? order[base - 1] : -1;
#pragma unroll
  for (int j = 0; j < K8_ITEMS; ++j) {
    live[j] = i0 + j < n && dead[i0 + j] == 0;
    diff[j] = false;
  }

  for (int c0 = 0; c0 < cols.ncols; c0 += K8_CHUNK) {
    i64 img[K8_CHUNK][K8_ITEMS], himg[K8_CHUNK];
    bool ok[K8_CHUNK][K8_ITEMS], hok[K8_CHUNK];
    // every gather of the chunk first
#pragma unroll
    for (int cc = 0; cc < K8_CHUNK; ++cc) {
      const int c = c0 + cc;
      const bool col = c < cols.ncols;
#pragma unroll
      for (int j = 0; j < K8_ITEMS; ++j) {
        const bool g = col && live[j];
        ok[cc][j] = g && cols.ok[c][row[j]] != 0;
        img[cc][j] = g ? cols.v[c][row[j]] : 0;
      }
      const bool g = col && hrow >= 0;
      hok[cc] = g && cols.ok[c][hrow] != 0;
      himg[cc] = g ? cols.v[c][hrow] : 0;
    }
    // then the compares
#pragma unroll
    for (int cc = 0; cc < K8_CHUNK; ++cc) {
      const bool f = c0 + cc < cols.ncols && ((cols.f64 >> (c0 + cc)) & 1);
#pragma unroll
      for (int j = 0; j < K8_ITEMS; ++j) img[cc][j] = k8_image(img[cc][j], ok[cc][j], f);
      himg[cc] = k8_image(himg[cc], hok[cc], f);
      if (lane == 31) {
        last_img[warp][cc] = img[cc][K8_ITEMS - 1];
        last_ok[warp][cc] = ok[cc][K8_ITEMS - 1];
      }
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < K8_CHUNK; ++cc) {
      i64 pimg = __shfl_up_sync(0xffffffffu, img[cc][K8_ITEMS - 1], 1);
      bool pok = __shfl_up_sync(0xffffffffu, (int)ok[cc][K8_ITEMS - 1], 1) != 0;
      if (lane == 0) {
        pimg = warp > 0 ? last_img[warp - 1][cc] : himg[cc];
        pok = warp > 0 ? last_ok[warp - 1][cc] != 0 : hok[cc];
      }
#pragma unroll
      for (int j = 0; j < K8_ITEMS; ++j) {
        diff[j] |= pok != ok[cc][j] || pimg != img[cc][j];
        pimg = img[cc][j];
        pok = ok[cc][j];
      }
    }
    __syncthreads();                    // last_* are free for the next chunk
  }

  // openers, counted through the tile
  int open[K8_ITEMS], run = 0, cnt[K8_ITEMS];
#pragma unroll
  for (int j = 0; j < K8_ITEMS; ++j) {
    open[j] = live[j] && (i0 + j == 0 || diff[j]);
    run += open[j];
    cnt[j] = run;
  }
  const i64 incl = block_scan_incl(run, warp_tot);
  const int before = (int)(incl - run);
#pragma unroll
  for (int j = 0; j < K8_ITEMS; ++j)
    if (i0 + j < n)
      word[i0 + j] = (unsigned short)(((before + cnt[j]) << 2) | (open[j] << 1) | (int)live[j]);
  if (t == K8_THREADS - 1) block_total[blockIdx.x] = incl;
}

__global__ void __launch_bounds__(K8_OUT_THREADS)
k8_out(i64 n, const unsigned short* __restrict__ word, const i64* __restrict__ block_off,
       const i64* __restrict__ ngroups, const i64* __restrict__ order,
       const __grid_constant__ K8Cols cols, i64 S, i64* __restrict__ gid,
       i64* __restrict__ starts, i64* __restrict__ rep, unsigned char* __restrict__ nonnull) {
  const i64 t = (i64)blockIdx.x * K8_OUT_THREADS + threadIdx.x;
  const i64 ng = *ngroups;
  for (i64 r = ng + t; r < S; r += (i64)gridDim.x * K8_OUT_THREADS) {
    starts[r] = -1;                     // a rank no row opens
    for (int c = 0; c < cols.ncols; ++c) {
      rep[(i64)c * S + r] = 0;
      nonnull[(i64)c * S + r] = 0;
    }
  }
  const i64 i0 = t * K8_OUT_ITEMS;
  if (i0 >= n) return;
  const bool whole = i0 + K8_OUT_ITEMS <= n;
  unsigned w[K8_OUT_ITEMS];
  if (whole) {                          // 16 B of words, 64 B of ids
    const uint4 v = *(const uint4*)(word + i0);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[2 * q] = u[q] & 0xffffu;
      w[2 * q + 1] = u[q] >> 16;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K8_OUT_ITEMS; ++j) w[j] = i0 + j < n ? word[i0 + j] : 0;
  }
  const i64 before = block_off[i0 / K8_TILE] - 1;
  i64 g[K8_OUT_ITEMS];
#pragma unroll
  for (int j = 0; j < K8_OUT_ITEMS; ++j) {
    const i64 rank = before + (i64)(w[j] >> 2);
    g[j] = ((w[j] & 1u) && rank < S - 1) ? rank : S - 1;
    if ((w[j] & 2u) && rank < S) {      // an opener: its representatives
      starts[rank] = i0 + j;
      const i64 r = order[i0 + j];
      for (int c = 0; c < cols.ncols; ++c) {
        rep[(i64)c * S + rank] = cols.v[c][r];
        nonnull[(i64)c * S + rank] = cols.ok[c][r] != 0;
      }
    }
  }
  if (whole) {
#pragma unroll
    for (int q = 0; q < K8_OUT_ITEMS / 2; ++q)
      *(longlong2*)(gid + i0 + 2 * q) = make_longlong2(g[2 * q], g[2 * q + 1]);
  } else {
    for (int j = 0; j < K8_OUT_ITEMS && i0 + j < n; ++j) gid[i0 + j] = g[j];
  }
}

// The rank pass. dead: n bytes, the sorted positions' dead flags; cols:
// ncols (values, valid) pointer pairs, f64 mask bit c for an f64 column;
// word n uint16; block_total and block_off ceil(n / K8_TILE) int64;
// ngroups one int64 (the scan writes it).
extern "C" int rank_groups_rank_launch(i64 n, const i64* order, const unsigned char* dead,
                                       int ncols, const i64* const* vals,
                                       const unsigned char* const* valid, u64 f64,
                                       unsigned short* word, i64* block_total, i64* block_off,
                                       i64* ngroups, void* stream) {
  if (n < 1 || ncols < 1 || ncols > K8_MAX_COLS) return -1;
  const i64 nb = (n + K8_TILE - 1) / K8_TILE;
  if (nb > 0x7fffffff) return -1;
  K8Cols c;
  for (int j = 0; j < ncols; ++j) {
    c.v[j] = vals[j];
    c.ok[j] = valid[j];
  }
  c.f64 = f64;
  c.ncols = ncols;
  cudaStream_t st = (cudaStream_t)stream;
  k8_rank<<<(unsigned)nb, K8_THREADS, 0, st>>>(n, order, dead, c, word, block_total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, SCAN_TOTALS_THREADS, 0, st>>>(nb, block_total, block_off, ngroups);
  return (int)cudaGetLastError();
}

// The output pass over the rank pass's word, block_off and ngroups; gid n
// int64, starts S int64, rep [ncols][S] int64, nonnull [ncols][S] bytes;
// word and gid 16-byte aligned.
extern "C" int rank_groups_out_launch(i64 n, const unsigned short* word, const i64* block_off,
                                      const i64* ngroups, const i64* order, int ncols,
                                      const i64* const* vals, const unsigned char* const* valid,
                                      i64 S, i64* gid, i64* starts, i64* rep,
                                      unsigned char* nonnull, void* stream) {
  if (n < 1 || S < 1 || ncols < 1 || ncols > K8_MAX_COLS) return -1;
  if (((uintptr_t)word | (uintptr_t)gid) & 15) return -1;
  K8Cols c;
  for (int j = 0; j < ncols; ++j) {
    c.v[j] = vals[j];
    c.ok[j] = valid[j];
  }
  c.f64 = 0;
  c.ncols = ncols;
  const i64 per = (i64)K8_OUT_THREADS * K8_OUT_ITEMS;
  const i64 blocks = (n + per - 1) / per;
  if (blocks > 0x7fffffff) return -1;
  k8_out<<<(unsigned)blocks, K8_OUT_THREADS, 0, (cudaStream_t)stream>>>(
      n, word, block_off, ngroups, order, c, S, gid, starts, rep, nonnull);
  return (int)cudaGetLastError();
}
