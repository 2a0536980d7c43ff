// K6 seg_states_ragged: every region's grouped partial states in one pass.
//
// Replaces tidb_tpu/ops/kernels.py:1356 region_agg_states_batched (and
// :1204 region_agg_states, its one-region call): per-region segment
// states over region-local group ids, region r's ids offset by
// off_r = sum of bucket_segments(G_s + 1) over s < r, each region keeping
// its own dead-row sink (:1343 bucket_segments). The reference
// concatenates every region's planes (jnp.concatenate, a copy); here the
// kernel reads each region's planes in place through pointer tables.
//
// Inputs: a region table of K6_RDESC int64 per region (row base in the
// concatenated gid/contrib arrays, rows to reduce, segment offset, span,
// first partial unit and units: tiles or blocks), the concatenated
// region-local group ids, and per reduction (op, concatenated contrib
// mask) plus one values and one valid pointer per region (null values:
// the reduction counts; null valid: all valid). Output: one int64 per
// (reduction, global segment): a count, a wrapping int64 sum, an f64 sum
// (bits), or an extremum with the exact I64 sentinel or f64 +-inf
// identity where no row contributes. Rows past a region's row count are
// never read. Three routes, by what one copy of the span costs
// (kernels.k6_route):
//
// Small spans (warps * reductions * max span * 8 B <= K6_SMEM_BYTES):
// tiles of K6_TILE rows never cross a region; each warp walks a contiguous
// part of its tile 32 rows at a time, groups the lanes that take a row by
// group id (__match_any_sync), and the lowest lane of each group folds the
// group's values in lane order into the warp's own copy of the region's
// span in shared memory. Warp copies fold in warp order into a per-tile
// partial; pass 2, a thread per (reduction, segment), folds the region's
// tile partials in tile order.
//
// Spans up to Hopper's opt-in shared memory (one copy of reductions *
// max span * 8 B, plus an f64 chunk's staging, within the limit the card
// reports; seg_states_block_limit): the block route of seg_block.cuh,
// which K4 shares. A persistent grid gives each region blocks in
// proportion to its rows, each block a contiguous slice of them and ONE
// copy of the region's span for all its reductions; integer reductions
// fold by shared-memory integer atomics, f64 ones class-bucketed in row
// order; pass 2 folds a region's block partials in block order. There is
// no sort and no search per row.
//
// Larger spans: the caller sorts the offset ids stably (torch.sort), and
// K4's segmented pass over the sorted runs (seg_sorted.cuh) reduces them,
// finding each row's region by binary search over the row bases.
//
// No floating-point atomics anywhere: f64 sums are the same from run to
// run. The tile and block routes fold each segment's rows in row order
// (the block route's per-warp trees keep lane order, the left part
// first), so an extremum tie of -0.0 and +0.0 keeps the first in row
// order, as the plain version does.
//
// Bound by bytes: 8 B of group id, 1 B of contrib, 8 B of value and 1 B
// of valid per row and reduction (the sorted route adds 16 B of sorted id
// and permutation per row, and gathers values at random). At one block
// an SM (the span copy takes most of the shared memory) the block route
// spends its time on each chunk's dependent steps: a memory round trip a
// group of reductions, the f64 staging's two barriers and block scan; a
// segment that takes most rows contends on one atomic address (integer
// ops) or leaves one warp most of the f64 fold.
#include "seg_block.cuh"
#include "seg_sorted.cuh"

#define K6_THREADS 256
#define K6_WARPS (K6_THREADS / 32)
#define K6_TILE 4096
#define K6_SMEM_BYTES 49152
#define K6_RED 2   // (op, contrib pointer) per reduction

// Does concatenated row `row` (region r, local row `local`) contribute to
// reduction j, and with which value?
__device__ __forceinline__ bool k6_take(const i64* red, const u64* vals_tab,
                                        const u64* valid_tab, int R, int j, int r,
                                        i64 row, i64 local, i64* x) {
  const int op = (int)red[K6_RED * j];
  const unsigned char* contrib = (const unsigned char*)red[K6_RED * j + 1];
  if (!contrib[row]) return false;
  const unsigned char* valid = (const unsigned char*)valid_tab[(i64)j * R + r];
  if (valid != nullptr && !valid[local]) return false;
  const i64* vals = (const i64*)vals_tab[(i64)j * R + r];
  *x = (op == R_COUNT || vals == nullptr) ? 1 : vals[local];
  return true;
}

__global__ void seg_states_tiles(const i64* __restrict__ rdesc, int R,
                                 const int* __restrict__ tile_region,
                                 const i64* __restrict__ gid, int n_red,
                                 const i64* __restrict__ red,
                                 const u64* __restrict__ vals_tab,
                                 const u64* __restrict__ valid_tab, int span_max,
                                 i64* __restrict__ part) {
  extern __shared__ i64 acc[];   // [warp][reduction][span_max]
  const int r = tile_region[blockIdx.x];
  const i64* d = rdesc + K6_RDESC * r;
  const i64 base = d[0], n_rows = d[1];
  const i64 t0 = (i64)(blockIdx.x - (int)d[4]) * K6_TILE;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slab = n_red * span_max;
  for (int i = threadIdx.x; i < K6_WARPS * slab; i += K6_THREADS)
    acc[i] = val_ident((int)red[K6_RED * ((i % slab) / span_max)]);
  __syncthreads();
  i64* mine = acc + (i64)warp * slab;
  const int per_warp = K6_TILE / K6_WARPS;
  for (int k = 0; k < per_warp; k += 32) {
    const i64 local = t0 + (i64)warp * per_warp + k + lane;
    const bool in = local < n_rows;
    const i64 row = base + local;
    const i64 g = in ? gid[row] : -1;
    for (int j = 0; j < n_red; ++j) {
      const int op = (int)red[K6_RED * j];
      i64 x = 0;
      const bool take = in && k6_take(red, vals_tab, valid_tab, R, j, r, row, local, &x);
      const unsigned int takers = __ballot_sync(0xffffffffu, take);
      if (takers == 0) continue;
      const unsigned int peers = __match_any_sync(0xffffffffu, take ? g : (i64)-1);
      const bool leader = take && (__ffs(peers) - 1) == lane;
      i64 a = val_ident(op);
      for (unsigned int m = takers; m != 0; m &= m - 1) {
        const int s = __ffs(m) - 1;
        const i64 y = __shfl_sync(0xffffffffu, x, s);
        if (leader && ((peers >> s) & 1u)) a = val_merge(op, a, y);
      }
      if (leader) {
        i64* p = mine + (i64)j * span_max + g;
        *p = val_merge(op, *p, a);
      }
    }
  }
  __syncthreads();
  i64* out = part + (i64)blockIdx.x * slab;
  for (int i = threadIdx.x; i < slab; i += K6_THREADS) {
    const int op = (int)red[K6_RED * (i / span_max)];
    i64 a = acc[i];
    for (int w = 1; w < K6_WARPS; ++w) a = val_merge(op, a, acc[(i64)w * slab + i]);
    out[i] = a;
  }
}

// Pass 2 of the tile and block routes: a thread per (reduction, segment)
// folds the region's partial units (tiles or blocks) in order.
__global__ void seg_states_fold(const i64* __restrict__ rdesc, int R, i64 n_seg,
                                int n_red, const i64* __restrict__ red, int span_max,
                                const i64* __restrict__ part, i64* __restrict__ out) {
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (i64)n_red * n_seg) return;
  const int j = (int)(idx / n_seg);
  const i64 s = idx % n_seg;
  const int op = (int)red[K6_RED * j];
  const int r = k6_region(rdesc, R, 2, s);
  const i64* d = rdesc + K6_RDESC * r;
  const i64 local = s - d[2];
  const i64 slab = (i64)n_red * span_max;
  i64 a = val_ident(op);
  for (i64 t = d[4]; t < d[4] + d[5]; ++t)
    a = val_merge(op, a, part[t * slab + (i64)j * span_max + local]);
  out[idx] = a;
}

// ---- spans in the opt-in shared memory: one copy a block
// (seg_block.cuh); a region's slots are its reductions
struct K6BSrc {
  static constexpr bool GLOBAL = false;
  int n_slots;
  const i64* red;
  const u64* vals_tab;
  const u64* valid_tab;
  int R;
  __device__ SbSlot slot(int j, int r, i64 base) const {
    SbSlot s;
    s.op = (int)red[K6_RED * j];
    s.flags = 0;
    s.contrib = (const unsigned char*)red[K6_RED * j + 1] + base;
    s.valid = (const unsigned char*)valid_tab[(i64)j * R + r];
    s.vals = s.op == R_COUNT ? nullptr : (const i64*)vals_tab[(i64)j * R + r];
    s.cval = 1;
    return s;
  }
};

template <int ROWS>
__global__ void __launch_bounds__(K6B_THREADS, 1)
seg_states_block(const i64* __restrict__ rdesc, int R, const i64* __restrict__ gid, int n_red,
                 const i64* __restrict__ red, const u64* __restrict__ vals_tab,
                 const u64* __restrict__ valid_tab, int span_max, i64* __restrict__ part) {
  const K6BSrc src = {n_red, red, vals_tab, valid_tab, R};
  seg_block_run<ROWS>(rdesc, R, gid, src, span_max, 1, part);
}

// The kernel's shared-memory opt-in, once per device: the card's limit
// for one block less the kernel's static shared memory.
template <int ROWS>
static cudaError_t k6b_ready(long long* limit) {
  static bool ready[64];
  return k6b_optin(seg_states_block<ROWS>, ready, limit);
}

static cudaError_t k6b_ready_rows(int rows, long long* limit) {
  switch (rows) {
    case 1: return k6b_ready<1>(limit);
    case 2: return k6b_ready<2>(limit);
    case 4: return k6b_ready<4>(limit);
  }
  return cudaErrorInvalidValue;
}

// ---- large spans: the segmented pass of seg_sorted.cuh over stably
// sorted offset ids; a segment's state is stored as its value (its count
// for R_COUNT)
struct K6Src {
  int n_red;
  const i64* red;
  const i64* rdesc;
  int R;
  const u64* vals_tab;
  const u64* valid_tab;
  __device__ int op(int j) const { return (int)red[K6_RED * j]; }
  __device__ bool take(int j, i64 row, i64* x) const {
    const int r = k6_region(rdesc, R, 0, row);
    return k6_take(red, vals_tab, valid_tab, R, j, r, row, row - rdesc[K6_RDESC * r], x);
  }
  __device__ void store(i64* out, i64 n_seg, int j, i64 s, Acc a) const {
    out[(i64)j * n_seg + s] = op(j) == R_COUNT ? a.n : a.v;
  }
};

extern "C" int seg_states_pieces_count(i64 n) { return sorted_pieces_count(n); }

extern "C" int seg_states_tiles_launch(int n_tiles, const i64* rdesc, int R,
                                       const int* tile_region, const i64* gid, int n_red,
                                       const i64* red, const u64* vals_tab,
                                       const u64* valid_tab, int span_max, i64 n_seg,
                                       i64* part, i64* out, void* stream) {
  if (n_red < 1 || R < 1 || n_seg < 1) return -1;
  const long long smem = (long long)K6_WARPS * n_red * span_max * 8;
  if (smem > K6_SMEM_BYTES) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles > 0) {
    seg_states_tiles<<<(unsigned)n_tiles, K6_THREADS, (size_t)smem, st>>>(
        rdesc, R, tile_region, gid, n_red, red, vals_tab, valid_tab, span_max, part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const i64 total = (i64)n_red * n_seg;
  seg_states_fold<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      rdesc, R, n_seg, n_red, red, span_max, part, out);
  return (int)cudaGetLastError();
}

extern "C" int seg_states_sorted_launch(i64 n, const i64* gid_sorted, const i64* order,
                                        const i64* rdesc, int R, i64 n_seg, int n_red,
                                        const i64* red, const u64* vals_tab,
                                        const u64* valid_tab, i64* part, i64* out,
                                        void* stream) {
  if (R < 1) return -1;
  const K6Src src = {n_red, red, rdesc, R, vals_tab, valid_tab};
  return sorted_launch(n, gid_sorted, order, n_seg, src, part, out, (cudaStream_t)stream);
}

// The block route's dynamic shared-memory limit on this device (after
// its opt-in), or minus a CUDA error.
extern "C" long long seg_states_block_limit() {
  long long lim = 0;
  const cudaError_t e = k6b_ready_rows(1, &lim);
  return e == cudaSuccess ? lim : -(long long)e;
}

// The block route's persistent grid: SMs x resident blocks at smem bytes,
// or minus a CUDA error.
extern "C" int seg_states_block_grid(int rows, long long smem) {
  const cudaError_t e = k6b_ready_rows(rows, nullptr);
  if (e != cudaSuccess) return -(int)e;
  switch (rows) {
    case 1: return k6b_grid(seg_states_block<1>, smem);
    case 2: return k6b_grid(seg_states_block<2>, smem);
  }
  return k6b_grid(seg_states_block<4>, smem);
}

// rdesc's fields 4 and 5 hold each region's first block and blocks (in
// proportion to its rows; n_blocks in all); n_f of the n_red reductions
// are f64 ops (the kernel finds which); part holds n_blocks * n_red *
// span_max int64.
extern "C" int seg_states_block_launch(int rows, int n_blocks, const i64* rdesc, int R,
                                       const i64* gid, int n_red, int n_f, const i64* red,
                                       const u64* vals_tab, const u64* valid_tab, int span_max,
                                       i64 n_seg, i64* part, i64* out, void* stream) {
  if (n_red < 1 || n_red > K6B_MAX_REDS || n_f < 0 || n_f > n_red || R < 1 || n_seg < 1 ||
      span_max < 1)
    return -1;
  long long lim = 0;
  cudaError_t e = k6b_ready_rows(rows, &lim);
  if (e != cudaSuccess) return (int)e;
  const long long smem = k6b_smem_bytes(n_red, n_f, span_max, rows);
  if (smem > lim) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_blocks > 0) {
    switch (rows) {
      case 1: seg_states_block<1><<<(unsigned)n_blocks, K6B_THREADS, (size_t)smem, st>>>(
                  rdesc, R, gid, n_red, red, vals_tab, valid_tab, span_max, part); break;
      case 2: seg_states_block<2><<<(unsigned)n_blocks, K6B_THREADS, (size_t)smem, st>>>(
                  rdesc, R, gid, n_red, red, vals_tab, valid_tab, span_max, part); break;
      default: seg_states_block<4><<<(unsigned)n_blocks, K6B_THREADS, (size_t)smem, st>>>(
                   rdesc, R, gid, n_red, red, vals_tab, valid_tab, span_max, part);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const i64 total = (i64)n_red * n_seg;
  seg_states_fold<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      rdesc, R, n_seg, n_red, red, span_max, part, out);
  return (int)cudaGetLastError();
}
