// K12 join_probe: the probe side of the device hash join.
//
// Replaces tidb_tpu/ops/kernels.py:1688 _join_probe_impl: per left row the
// match range [lo, hi) of its key among the sorted build words (K11),
// clamped to n_valid; an exclusive prefix sum of the match counts; and the
// expansion of output slot j into its (l, r) pair. Pairs come out in
// left-scan order, ties in right-scan order (the build's stable order).
//
// Pass 1 (count): a thread per left row encodes its key as K11 does
// (common.cuh key_word) and, for a valid row, binary-searches the lower
// and upper bound over words [0, n_valid); it writes lo and the row's
// exclusive offset inside its tile (a block scan of the counts), and each
// tile its total. Pass 2: one block scans the tile totals (scan.cuh) into
// tile offsets and the grand total. Pass 3 (add-back): every offset gets
// its tile's offset. The wrapper reads the total back and sizes the output
// exactly, so no capacity bucket and no retry (the reference probes with
// out_cap = the left bucket and retries once with bucket(total)). Pass 4
// (expand): a thread per output slot j finds its left row l by an upper
// bound search over the offsets and writes l and r = order[lo[l] + j -
// offsets[l]], as int32 when both sides are shorter than 2^31, else int64.
// Working per output slot keeps a skewed key (one left row with millions
// of matches) spread over the card.
//
// Bound by bytes: the left key and valid byte read once; lo and the
// offsets written and read back (16 B a left row); per pair the two
// indices written and order read (a gather).
//
// The partition-segmented mode replaces the per-shard probe of
// tidb_tpu/ops/mesh.py:756 _partitioned_probe_fn (each shard's
// _join_probe_impl over its own key partition). The probe planes come in
// K21's partition-major layout (key_partition.cu) and the build words
// sorted within each partition (ops/kernels.py join_build_partitioned):
// probe position i finds its partition p as the last loff[p] <= i (a
// binary search over the P + 1 offsets, which stay in L1) and searches
// only p's build words [bounds[p], bounds[p + 1]). The scan, add-back
// and expand passes are the same; expand maps a probe position to its
// global row through K21's gather index. The pairs of each partition are
// the count pass's offsets at the partition starts: no out_cap, no retry.
#include "scan.cuh"

#define K12_THREADS 256
#define K12_ITEMS 4
#define K12_TILE (K12_THREADS * K12_ITEMS)

template <bool SEG>
__global__ void __launch_bounds__(K12_THREADS)
k12_count(i64 nl, const i64* __restrict__ lkey, const unsigned char* __restrict__ lvalid,
          int is_f64, const i64* __restrict__ words, i64 nv, const i64* __restrict__ loff,
          const i64* __restrict__ bounds, int parts, i64* __restrict__ lo,
          i64* __restrict__ offs, i64* __restrict__ block_total) {
  __shared__ i64 warp_tot[32];
  const i64 base = (i64)blockIdx.x * K12_TILE + (i64)threadIdx.x * K12_ITEMS;
  i64 before[K12_ITEMS];
  i64 run = 0;
#pragma unroll
  for (int j = 0; j < K12_ITEMS; ++j) {
    const i64 l = base + j;
    before[j] = run;
    if (l >= nl) continue;
    i64 a = 0, cnt = 0;
    if (lvalid[l]) {
      i64 b0 = 0, b1 = nv;
      if (SEG) {
        const i64 p = upper_bound_i64(loff, 0, (i64)parts + 1, l) - 1;
        b0 = bounds[p];
        b1 = bounds[p + 1];
      }
      const i64 w = key_word(lkey[l], is_f64);
      a = lower_bound_i64(words, b0, b1, w);
      cnt = upper_bound_i64(words, a, b1, w) - a;
    }
    lo[l] = a;
    run += cnt;
  }
  const i64 start = block_scan_incl(run, warp_tot) - run;
#pragma unroll
  for (int j = 0; j < K12_ITEMS; ++j)
    if (base + j < nl) offs[base + j] = start + before[j];
  if (threadIdx.x == blockDim.x - 1) block_total[blockIdx.x] = start + run;
}

__global__ void k12_add_back(i64 nl, const i64* __restrict__ block_off, i64* __restrict__ offs) {
  const i64 l = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (l < nl) offs[l] += block_off[l / K12_TILE];
}

template <typename T>
__global__ void k12_expand(i64 total, i64 nl, const i64* __restrict__ lo,
                           const i64* __restrict__ offs, const i64* __restrict__ order,
                           const i64* __restrict__ lsel, T* __restrict__ out_l,
                           T* __restrict__ out_r) {
  const i64 j = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const i64 l = upper_bound_i64(offs, 0, nl, j) - 1;
  out_l[j] = (T)(lsel != nullptr ? lsel[l] : l);
  out_r[j] = (T)order[lo[l] + (j - offs[l])];
}

extern "C" i64 join_probe_blocks(i64 nl) { return (nl + K12_TILE - 1) / K12_TILE; }

template <bool SEG>
static int count_launch(i64 nl, const i64* lkey, const unsigned char* lvalid, int is_f64,
                        const i64* words, i64 nv, const i64* loff, const i64* bounds, int parts,
                        i64* lo, i64* offs, i64* block_total, i64* block_off, i64* total,
                        void* stream) {
  if (nl < 1) return -1;
  const i64 nb = join_probe_blocks(nl);
  if (nb > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  k12_count<SEG><<<(unsigned)nb, K12_THREADS, 0, st>>>(nl, lkey, lvalid, is_f64, words, nv, loff,
                                                       bounds, parts, lo, offs, block_total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, SCAN_TOTALS_THREADS, 0, st>>>(nb, block_total, block_off, total);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k12_add_back<<<(unsigned)((nl + 255) / 256), 256, 0, st>>>(nl, block_off, offs);
  return (int)cudaGetLastError();
}

// Passes 1-3. words: the n_valid sorted build words; lo and offs nl int64;
// block_total and block_off join_probe_blocks(nl) int64; total one int64.
extern "C" int join_probe_count_launch(i64 nl, const i64* lkey, const unsigned char* lvalid,
                                       int is_f64, const i64* words, i64 nv, i64* lo, i64* offs,
                                       i64* block_total, i64* block_off, i64* total,
                                       void* stream) {
  return count_launch<false>(nl, lkey, lvalid, is_f64, words, nv, nullptr, nullptr, 0, lo, offs,
                             block_total, block_off, total, stream);
}

// Passes 1-3 of the segmented mode: the probe planes partition-major, loff
// their parts + 1 partition starts (loff[parts] = nl), words sorted within
// each partition, bounds the parts + 1 starts of the partitions' words.
extern "C" int join_probe_count_seg_launch(i64 nl, const i64* lkey, const unsigned char* lvalid,
                                           int is_f64, const i64* words, i64 nv,
                                           const i64* loff, const i64* bounds, int parts,
                                           i64* lo, i64* offs, i64* block_total,
                                           i64* block_off, i64* total, void* stream) {
  if (parts < 1) return -1;
  return count_launch<true>(nl, lkey, lvalid, is_f64, words, nv, loff, bounds, parts, lo, offs,
                            block_total, block_off, total, stream);
}

// Pass 4. out holds 2 * total indices, int32 if narrow else int64: the
// left indices (lsel[l] where lsel is given, else l), then the right ones.
extern "C" int join_probe_expand_launch(i64 total, i64 nl, const i64* lo, const i64* offs,
                                        const i64* order, const i64* lsel, int narrow, void* out,
                                        void* stream) {
  if (total < 1 || nl < 1) return -1;
  const i64 nblk = (total + 255) / 256;
  if (nblk > 0x7fffffff) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (narrow) {
    int* o = (int*)out;
    k12_expand<int><<<(unsigned)nblk, 256, 0, st>>>(total, nl, lo, offs, order, lsel, o,
                                                     o + total);
  } else {
    i64* o = (i64*)out;
    k12_expand<i64><<<(unsigned)nblk, 256, 0, st>>>(total, nl, lo, offs, order, lsel, o,
                                                     o + total);
  }
  return (int)cudaGetLastError();
}
