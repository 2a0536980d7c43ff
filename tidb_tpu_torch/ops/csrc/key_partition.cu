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
// Three launches. (1) A block per tile of K21_TILE rows computes every
// row's partition and sorts the unique tile keys (partition * K21_TILE +
// position in the tile) with a bitonic network in shared memory: equal
// partitions keep their row order because the position is part of the
// key, so no atomic decides an order, and the tile's count of each
// partition is the distance between two lower bounds in the sorted keys.
// It writes the counts partition-major (hist[p * nb + tile]). (2) One block
// scans the P * nb counts (scan.cuh): the offset of each (partition, tile)
// run in sel, and the grand total n. (3) The tiles sort again and scatter
// each row to its run's offset plus its rank inside the run; tile 0
// writes the partition offsets. Integer work only: the same bits on every
// run.
//
// Bound by bytes: the key and the valid byte read twice (9 B a row each
// pass, the recount is cheaper than writing and reading back a partition
// and a rank per row), sel written once, the counts (P * nb int64) written,
// scanned and read. The bitonic sort (66 compare-exchange stages over a
// 2,048-key tile) is the compute; at large P the one-block scan of the
// counts is the tail.
#include "scan.cuh"

#define K21_THREADS 512
#define K21_TILE 2048
#define K21_MAX_PARTS 1024

__device__ __forceinline__ u64 mix64(u64 x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// A row's partition: splitmix64 of the key's int64 image, modulo parts.
__device__ __forceinline__ unsigned key_part(i64 bits, bool ok, int is_f64, unsigned parts) {
  if (!ok) return 0;
  if (is_f64 && as_f64(bits) == 0.0) bits = 0;
  return (unsigned)(mix64((u64)bits) % (u64)parts);
}

// First position in the sorted tile keys s[0, K21_TILE) whose key is >= v.
__device__ __forceinline__ int tile_lower_bound(const unsigned* s, unsigned v) {
  int lo = 0, hi = K21_TILE;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Load the tile's keys (partition * K21_TILE + position; rows past n get
// partition `parts`, which sorts them last) and sort them ascending.
__device__ void tile_sort(i64 n, const i64* __restrict__ key,
                          const unsigned char* __restrict__ valid, int is_f64, unsigned parts,
                          unsigned* s) {
  const i64 base = (i64)blockIdx.x * K21_TILE;
  for (int t = threadIdx.x; t < K21_TILE; t += blockDim.x) {
    const i64 i = base + t;
    const unsigned p = i < n ? key_part(key[i], valid[i] != 0, is_f64, parts) : parts;
    s[t] = p * K21_TILE + (unsigned)t;
  }
  __syncthreads();
  for (int k = 2; k <= K21_TILE; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < K21_TILE; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned a = s[i], b = s[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(K21_THREADS)
k21_count(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
          int is_f64, unsigned parts, i64 nb, i64* __restrict__ hist) {
  __shared__ unsigned s[K21_TILE];
  tile_sort(n, key, valid, is_f64, parts, s);
  for (unsigned p = threadIdx.x; p < parts; p += blockDim.x)
    hist[(i64)p * nb + blockIdx.x] =
        tile_lower_bound(s, (p + 1) * K21_TILE) - tile_lower_bound(s, p * K21_TILE);
}

__global__ void __launch_bounds__(K21_THREADS)
k21_scatter(i64 n, const i64* __restrict__ key, const unsigned char* __restrict__ valid,
            int is_f64, unsigned parts, i64 nb, const i64* __restrict__ off,
            i64* __restrict__ sel, i64* __restrict__ offsets) {
  __shared__ unsigned s[K21_TILE];
  tile_sort(n, key, valid, is_f64, parts, s);
  const i64 base = (i64)blockIdx.x * K21_TILE;
  for (int k = threadIdx.x; k < K21_TILE; k += blockDim.x) {
    const unsigned v = s[k], p = v / K21_TILE;
    if (p >= parts) continue;           // past the end of the rows
    const int start = tile_lower_bound(s, p * K21_TILE);
    sel[off[(i64)p * nb + blockIdx.x] + (k - start)] = base + (i64)(v % K21_TILE);
  }
  if (blockIdx.x == 0)
    for (unsigned p = threadIdx.x; p < parts; p += blockDim.x) offsets[p] = off[(i64)p * nb];
}

extern "C" i64 key_partition_blocks(i64 n) { return (n + K21_TILE - 1) / K21_TILE; }

// key: n int64 or f64 (bits); valid: n bytes; parts in [1, K21_MAX_PARTS];
// hist and off parts * key_partition_blocks(n) int64 of scratch; sel n
// int64; offsets parts + 1 int64.
extern "C" int key_partition_launch(i64 n, const i64* key, const unsigned char* valid,
                                    int is_f64, int parts, i64* hist, i64* off, i64* sel,
                                    i64* offsets, void* stream) {
  if (n < 1 || parts < 1 || parts > K21_MAX_PARTS) return -1;
  const i64 nb = key_partition_blocks(n);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k21_count<<<(unsigned)nb, K21_THREADS, 0, st>>>(n, key, valid, is_f64, (unsigned)parts, nb,
                                                  hist);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, SCAN_TOTALS_THREADS, 0, st>>>((i64)parts * nb, hist, off, offsets + parts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k21_scatter<<<(unsigned)nb, K21_THREADS, 0, st>>>(n, key, valid, is_f64, (unsigned)parts, nb,
                                                    off, sel, offsets);
  return (int)cudaGetLastError();
}
