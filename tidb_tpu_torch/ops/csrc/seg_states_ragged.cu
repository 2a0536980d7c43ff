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
// first block and blocks), the concatenated region-local group ids, and
// per reduction (op, concatenated contrib mask) plus one values and one
// valid pointer per region (null values: the reduction counts; null
// valid: all valid). Output: one int64 per (reduction, global segment): a
// count, a wrapping int64 sum, an f64 sum (bits), or an extremum with the
// exact I64 sentinel or f64 +-inf identity where no row contributes. Rows
// past a region's row count are never read. Two routes, by what one copy
// of the span costs (kernels.k6_route):
//
// Spans up to Hopper's opt-in shared memory (reductions * max span * 8 B,
// plus an f64 chunk's staging, within the limit the card reports;
// seg_states_block_limit): the block route of seg_block.cuh, which K4
// shares. A persistent grid gives each region blocks in proportion to its
// rows, each block a contiguous slice of them and copies of the region's
// span for all its reductions; integer reductions fold by shared-memory
// atomics, lane l into copy l mod copies, f64 ones class-bucketed in row
// order into the first copy; pass 2 folds a region's block partials in
// block order. There is no sort and no search per row. Small spans (Q1's
// few groups, one of them holding half the rows) take as many copies as
// fit half an SM's shared memory (kernels.k4_copies, up to 16), so the
// lanes of a step that share the hot group spread over as many addresses,
// and an instantiation that runs two blocks an SM; larger spans one block
// an SM, with the copies that fit the card's limit (one for date_group).
// The tables (regions, reductions, plane pointers) ride by value in the
// launch's parameters (struct K6Params), so the launch copies nothing to
// the card first; tables past K6Params' room are read from the card.
//
// Larger spans: the caller sorts the offset ids stably (torch.sort), and
// K4's segmented pass over the sorted runs (seg_sorted.cuh) reduces them,
// finding each row's region by binary search over the row bases.
//
// No floating-point atomics anywhere: f64 sums are the same from run to
// run. The block route folds each segment's f64 rows in row order (its
// per-warp trees keep lane order, the left part first), so an extremum
// tie of -0.0 and +0.0 keeps the first in row order, as the plain version
// does.
//
// Bound by bytes: 8 B of group id, 1 B of contrib, 8 B of value and 1 B
// of valid per row and reduction (the sorted route adds 16 B of sorted id
// and permutation per row, and gathers values at random). The block route
// spends its time on each chunk's dependent steps: a memory round trip a
// group of reductions, the f64 staging's two barriers and block scan.
#include <cstring>

#include "seg_block.cuh"
#include "seg_sorted.cuh"

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

// ---- the block route (seg_block.cuh); a region's slots are its
// reductions. Its tables by value: K6_PARAM_REGIONS regions, K6_PARAM_TAB
// plane pointers (values then valid, [n_red][R] each); larger tables are
// read from the card through the _dev pointers.
#define K6_PARAM_REGIONS 16
#define K6_PARAM_TAB 512

struct K6Params {
  i64 rdesc[K6_PARAM_REGIONS * K6_RDESC];
  i64 red[K6B_MAX_REDS * K6_RED];
  u64 tab[K6_PARAM_TAB];
  const i64* rdesc_dev;   // non-null: every table on the card
  const i64* red_dev;
  const u64* tab_dev;
};

__device__ __forceinline__ const i64* k6p_rdesc(const K6Params& p) {
  return p.rdesc_dev != nullptr ? p.rdesc_dev : p.rdesc;
}
__device__ __forceinline__ const i64* k6p_red(const K6Params& p) {
  return p.red_dev != nullptr ? p.red_dev : p.red;
}
__device__ __forceinline__ const u64* k6p_tab(const K6Params& p) {
  return p.tab_dev != nullptr ? p.tab_dev : p.tab;
}

// Pass 2: a thread per (reduction, segment) folds the region's block
// partials in block order.
__global__ void seg_states_fold(const __grid_constant__ K6Params p, int R, i64 n_seg, int n_red,
                                int span_max, const i64* __restrict__ part,
                                i64* __restrict__ out) {
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (i64)n_red * n_seg) return;
  const i64* rdesc = k6p_rdesc(p);
  const int j = (int)(idx / n_seg);
  const i64 s = idx % n_seg;
  const int op = (int)k6p_red(p)[K6_RED * j];
  const int r = k6_region(rdesc, R, 2, s);
  const i64* d = rdesc + K6_RDESC * r;
  const i64 local = s - d[2];
  const i64 slab = (i64)n_red * span_max;
  i64 a = val_ident(op);
  for (i64 t = d[4]; t < d[4] + d[5]; ++t)
    a = val_merge(op, a, part[t * slab + (i64)j * span_max + local]);
  out[idx] = a;
}

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

// MINB blocks an SM: 1 for spans that take most of the shared memory, 2
// for small spans (at most 64 registers a thread).
template <int ROWS, int MINB>
__global__ void __launch_bounds__(K6B_THREADS, MINB)
seg_states_block(const __grid_constant__ K6Params p, int R, const i64* __restrict__ gid,
                 int n_red, int span_max, int copies, i64* __restrict__ part) {
  const u64* tab = k6p_tab(p);
  const K6BSrc src = {n_red, k6p_red(p), tab, tab + (size_t)n_red * R, R};
  seg_block_run<ROWS>(k6p_rdesc(p), R, gid, src, span_max, copies, part);
}

// The kernel's shared-memory opt-in, once per device: the card's limit
// for one block less the kernel's static shared memory.
template <int ROWS, int MINB>
static cudaError_t k6b_ready(long long* limit) {
  static bool ready[64];
  return k6b_optin(seg_states_block<ROWS, MINB>, ready, limit);
}

// The instantiations: rows a thread per chunk and blocks an SM
// (kernels.K6B_ROWS with one block an SM, K6B_SMALL_ROWS with
// K6B_SMALL_BLOCKS).
#define K6B_SMALL_ROWS 2
#define K6B_SMALL_BLOCKS 2

static cudaError_t k6b_ready_rows(int rows, int minb, long long* limit) {
  if (minb == K6B_SMALL_BLOCKS && rows == K6B_SMALL_ROWS)
    return k6b_ready<K6B_SMALL_ROWS, K6B_SMALL_BLOCKS>(limit);
  if (minb != 1) return cudaErrorInvalidValue;
  switch (rows) {
    case 1: return k6b_ready<1, 1>(limit);
    case 2: return k6b_ready<2, 1>(limit);
    case 4: return k6b_ready<4, 1>(limit);
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
  const cudaError_t e = k6b_ready_rows(1, 1, &lim);
  return e == cudaSuccess ? lim : -(long long)e;
}

// The block route's persistent grid: SMs x resident blocks at smem bytes,
// or minus a CUDA error.
extern "C" int seg_states_block_grid(int rows, int minb, long long smem) {
  const cudaError_t e = k6b_ready_rows(rows, minb, nullptr);
  if (e != cudaSuccess) return -(int)e;
  if (minb == K6B_SMALL_BLOCKS)
    return k6b_grid(seg_states_block<K6B_SMALL_ROWS, K6B_SMALL_BLOCKS>, smem);
  switch (rows) {
    case 1: return k6b_grid(seg_states_block<1, 1>, smem);
    case 2: return k6b_grid(seg_states_block<2, 1>, smem);
  }
  return k6b_grid(seg_states_block<4, 1>, smem);
}

// tables: R region rows (K6_RDESC int64: fields 4 and 5 hold each
// region's first block and blocks, n_blocks in all), n_red (op, contrib
// pointer) pairs, then the values and the valid pointers ([n_red][R]
// each): a host array that rides by value where it fits K6Params, else
// (on_card) the same layout on the card. n_f of the n_red reductions are
// f64 ops (the kernel finds which); copies (a power of two) of the
// integer states; part holds n_blocks * n_red * span_max int64.
extern "C" int seg_states_block_launch(int rows, int minb, int copies, int n_blocks,
                                       const i64* tables, int on_card, int R, const i64* gid,
                                       int n_red, int n_f, int span_max, i64 n_seg, i64* part,
                                       i64* out, void* stream) {
  if (n_red < 1 || n_red > K6B_MAX_REDS || n_f < 0 || n_f > n_red || R < 1 || n_seg < 1 ||
      span_max < 1 || copies < 1 || (copies & (copies - 1)))
    return -1;
  long long lim = 0;
  cudaError_t e = k6b_ready_rows(rows, minb, &lim);
  if (e != cudaSuccess) return (int)e;
  const long long smem = k6b_copies_bytes(n_red, n_f, span_max, rows, copies);
  if (smem > lim) return -1;
  K6Params p;
  const size_t n_rd = (size_t)R * K6_RDESC, n_rr = (size_t)n_red * K6_RED,
               n_tab = 2 * (size_t)n_red * R;
  if (on_card) {
    p.rdesc_dev = tables;
    p.red_dev = tables + n_rd;
    p.tab_dev = (const u64*)(tables + n_rd + n_rr);
  } else {
    if (R > K6_PARAM_REGIONS || n_tab > K6_PARAM_TAB) return -1;
    memcpy(p.rdesc, tables, 8 * n_rd);
    memcpy(p.red, tables + n_rd, 8 * n_rr);
    memcpy(p.tab, tables + n_rd + n_rr, 8 * n_tab);
    p.rdesc_dev = nullptr;
    p.red_dev = nullptr;
    p.tab_dev = nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (n_blocks > 0) {
    const dim3 g((unsigned)n_blocks);
    if (minb == K6B_SMALL_BLOCKS)
      seg_states_block<K6B_SMALL_ROWS, K6B_SMALL_BLOCKS><<<g, K6B_THREADS, (size_t)smem, st>>>(
          p, R, gid, n_red, span_max, copies, part);
    else if (rows == 1)
      seg_states_block<1, 1><<<g, K6B_THREADS, (size_t)smem, st>>>(p, R, gid, n_red, span_max,
                                                                  copies, part);
    else if (rows == 2)
      seg_states_block<2, 1><<<g, K6B_THREADS, (size_t)smem, st>>>(p, R, gid, n_red, span_max,
                                                                  copies, part);
    else
      seg_states_block<4, 1><<<g, K6B_THREADS, (size_t)smem, st>>>(p, R, gid, n_red, span_max,
                                                                  copies, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const i64 total = (i64)n_red * n_seg;
  seg_states_fold<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, R, n_seg, n_red, span_max,
                                                                  part, out);
  return (int)cudaGetLastError();
}
