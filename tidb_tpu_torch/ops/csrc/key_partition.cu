// K21 key_partition: the key-radix partitioning of a join side.
//
// Replaces the host layout of tidb_tpu/ops/mesh.py:825-842 (inside
// join_probe_partitioned, around :756 _partitioned_probe_fn):
// membudget.partition_codes(key, valid, S), a flatnonzero per partition
// and the padded shard blocks. The answer here is the layout without the
// padding: sel, every row in partition-major order, stable (the rows of a
// partition in row order, which keeps right-scan order through the
// join), and offsets[p], where partition p starts in sel (offsets[P] = n).
//
// A row's partition is splitmix64 over its key's int64 image modulo P: an
// f64 key hashes its bits with -0.0 made +0.0 (SQL equality), a NULL row
// goes to partition 0. That is the reference's partition_codes bit for
// bit, and ops.mesh.RegionPlacement's mixer.
//
// One counting pass of radix.cuh with the partition as the digit, over
// tiles of RADIX_TILE rows, in three launches:
//   - count: each tile computes its rows' partitions in registers from
//     the key and valid planes and keeps its histogram of the P bins by
//     shared-memory integer atomics (no order changes a count), written
//     partition-major, tile-minor;
//   - scan: radix.cuh's radix_scan, a block per partition over that
//     partition's tile counts (exclusive, in tile order) and its total;
//   - scatter: the tile computes the partitions again, ranks each warp's
//     rows by __match_any_sync (radix_warp_rank), scans the warps' counts
//     partition-major and warp-minor (radix_tile_starts), places each
//     row's index in shared memory in partition order and writes sel from
//     there, consecutive threads to consecutive positions of a partition's
//     run; tile 0 writes the partition offsets.
// Rows of a partition keep their order within a warp (steps, then lanes),
// across warps (slices in order) and across tiles (the scan): stable.
// The bins are a template parameter, K21_BINS_SMALL up to that many
// partitions, else K21_MAX_PARTS. Integer work only: the same bits on
// every run. Counts and places are int32: at most 2^31 - 1 rows.
//
// Bound by bytes: the key and the valid byte read twice (9 B a row each
// pass; hashing again is cheaper than writing and reading back a
// partition plane), sel written once: 26 B a row. No sort and no search:
// a row's place is its partition's start, its tile's count before it and
// its rank in the tile.
#include "radix.cuh"

#define K21_MAX_PARTS 1024
#define K21_BINS_SMALL RADIX_BINS
#define K21_MAX_ROWS 0x7fffffffLL

__device__ __forceinline__ u64 mix64(u64 x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// A row's partition: splitmix64 of the key's int64 image, modulo parts
// (a mask where parts is a power of two).
__device__ __forceinline__ int key_part(i64 bits, bool ok, int is_f64, unsigned parts) {
  if (!ok) return 0;
  if (is_f64 && as_f64(bits) == 0.0) bits = 0;
  const u64 h = mix64((u64)bits);
  if ((parts & (parts - 1u)) == 0) return (int)(h & (u64)(parts - 1u));
  return (int)(h % (u64)parts);
}

template <int BINS>
__global__ void __launch_bounds__(RADIX_THREADS)
k21_count(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
          int is_f64, unsigned parts, int* __restrict__ counts, int n_tiles) {
  __shared__ int hist[BINS];
  for (int b = threadIdx.x; b < BINS; b += RADIX_THREADS) hist[b] = 0;
  __syncthreads();
  const i64 t0 = (i64)blockIdx.x * RADIX_TILE;
  i64 k[RADIX_ITEMS];
  unsigned char ok[RADIX_ITEMS];
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j) {
    const i64 row = t0 + j * RADIX_THREADS + threadIdx.x;
    k[j] = row < n ? key[row] : 0;
    ok[j] = row < n ? valid[row] : 0;
  }
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j)
    if (t0 + j * RADIX_THREADS + threadIdx.x < n)
      atomicAdd(&hist[key_part(k[j], ok[j] != 0, is_f64, parts)], 1);
  __syncthreads();
  for (unsigned b = threadIdx.x; b < parts; b += RADIX_THREADS)
    counts[(i64)b * n_tiles + blockIdx.x] = hist[b];
}

template <int BINS>
__global__ void __launch_bounds__(RADIX_THREADS)
k21_scatter(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
            int is_f64, unsigned parts, const int* __restrict__ counts,
            const int* __restrict__ totals, int n_tiles, i64* __restrict__ sel,
            i64* __restrict__ offsets) {
  __shared__ int whist[RADIX_WARPS * BINS];         // [warp][partition]
  __shared__ int gofs[BINS];                        // [partition]
  __shared__ unsigned short sidx[RADIX_TILE];       // row in the tile, in place
  __shared__ unsigned short spart[RADIX_TILE];      // its partition
  __shared__ i64 warp_tot[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const i64 t0 = (i64)blockIdx.x * RADIX_TILE;
  for (int i = t; i < RADIX_WARPS * BINS; i += RADIX_THREADS) whist[i] = 0;

  // 1. the warp's slice: every load first, then ranks in row order
  i64 k[RADIX_ITEMS];
  unsigned char ok[RADIX_ITEMS];
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j) {
    const i64 row = t0 + (i64)warp * (32 * RADIX_ITEMS) + j * 32 + lane;
    k[j] = row < n ? key[row] : 0;
    ok[j] = row < n ? valid[row] : 0;
  }
  __syncthreads();
  int part[RADIX_ITEMS], rk[RADIX_ITEMS];
  int* h = whist + warp * BINS;
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j) {
    const i64 row = t0 + (i64)warp * (32 * RADIX_ITEMS) + j * 32 + lane;
    part[j] = row < n ? key_part(k[j], ok[j] != 0, is_f64, parts) : BINS;
    rk[j] = radix_warp_rank<BINS>(part[j], h);
  }
  __syncthreads();

  // 2. the runs' tile-local starts and global starts; tile 0 writes the
  //    partitions' starts
  radix_tile_starts<BINS>(whist, gofs, counts, totals, n_tiles, (int)parts,
                          blockIdx.x == 0 ? offsets : nullptr, warp_tot);
  if (blockIdx.x == 0 && t == 0) offsets[parts] = n;
  __syncthreads();

  // 3. the tile's row indices in partition order in shared memory
#pragma unroll
  for (int j = 0; j < RADIX_ITEMS; ++j) {
    if (part[j] >= BINS) continue;
    const int p = whist[warp * BINS + part[j]] + rk[j];
    sidx[p] = (unsigned short)(warp * (32 * RADIX_ITEMS) + j * 32 + lane);
    spart[p] = (unsigned short)part[j];
  }
  __syncthreads();

  // 4. out in that order: a partition's rows to consecutive positions
  const int m = (int)(n - t0 < RADIX_TILE ? n - t0 : RADIX_TILE);
  for (int p = t; p < m; p += RADIX_THREADS)
    sel[(i64)gofs[spart[p]] + p] = t0 + sidx[p];
}

template <int BINS>
static int k21_run(i64 n, const i64* key, const unsigned char* valid, int is_f64,
                   unsigned parts, int* counts, i64* sel, i64* offsets, cudaStream_t st) {
  const int tiles = radix_tiles(n);
  int* totals = counts + (i64)parts * tiles;
  k21_count<BINS><<<tiles, RADIX_THREADS, 0, st>>>(n, key, valid, is_f64, parts, counts,
                                                   tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  radix_scan<<<parts, RADIX_THREADS, 0, st>>>(tiles, counts, totals);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k21_scatter<BINS><<<tiles, RADIX_THREADS, 0, st>>>(n, key, valid, is_f64, parts, counts,
                                                     totals, tiles, sel, offsets);
  return (int)cudaGetLastError();
}

// int32 scratch of a call: the tile counts [partition][tile] and the
// partitions' totals.
extern "C" i64 key_partition_scratch_ints(i64 n, int parts) {
  return (i64)parts * (radix_tiles(n) + 1);
}

// key: n int64 or f64 (bits); valid: n bytes; 1 <= n <= K21_MAX_ROWS;
// parts in [1, K21_MAX_PARTS]; counts key_partition_scratch_ints(n,
// parts) int32; sel n int64; offsets parts + 1 int64.
extern "C" int key_partition_launch(i64 n, const i64* key, const unsigned char* valid,
                                    int is_f64, int parts, int* counts, i64* sel,
                                    i64* offsets, void* stream) {
  if (n < 1 || n > K21_MAX_ROWS || parts < 1 || parts > K21_MAX_PARTS) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (parts <= K21_BINS_SMALL)
    return k21_run<K21_BINS_SMALL>(n, key, valid, is_f64, (unsigned)parts, counts, sel,
                                   offsets, st);
  return k21_run<K21_MAX_PARTS>(n, key, valid, is_f64, (unsigned)parts, counts, sel, offsets,
                                st);
}
