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
// first block and blocks), the concatenated region-local group ids (in
// [0, G_r]: G_r is the sink), and per reduction (op, concatenated
// contrib mask) plus one values and one valid pointer per region (null
// values: the reduction counts; null valid: all valid). Output: one int64
// per (reduction, global segment): a count, a wrapping int64 sum, an f64
// sum (bits), or an extremum with the exact I64 sentinel or f64 +-inf
// identity where no row contributes. Rows past a region's row count are
// never read. Three routes, by what one copy of a span costs
// (kernels.k6_route):
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
//
// Larger spans, up to kernels.K6_MAX_WINDOWS windows a region: the same
// kernel over segment windows, as K4's windows. Each region's segments
// [0, G_r] (its groups and its sink; the span's padding past the sink
// takes no row and holds the identity) are cut into windows of as many
// segments as one copy of their states fits the limit; each (region,
// window) is one row of the table, with the blocks its region's rows earn
// (kernels.k6_block_units), all in one launch. A window's blocks read
// their slice of the region's rows and fold only rows whose id falls in
// the window, so a region's rows are read once a window. d_supplier's
// 10,001 segments a region at 8 reductions take 3 windows.
//
// Past the cap (or past K6B_MAX_REDS reductions): the sorted route. One
// launch writes each row's offset id (gid + off_r); the radix sort of
// radix.cuh orders them stably (one pass per digit of the total span's
// bit length, row positions as payload; no library sort), and K4's
// segmented pass over the sorted runs (seg_sorted.cuh) reduces them,
// finding each row's region by binary search over the row bases.
//
// The tables (regions or window rows, reductions, plane pointers) ride by
// value in each launch's parameters (struct K6Params, __grid_constant__),
// so no route copies anything to the card first; tables past K6Params'
// room are read from the card.
//
// No floating-point atomics anywhere: f64 sums are the same from run to
// run. The block and window routes fold each segment's f64 rows in row
// order (their per-warp trees keep lane order, the left part first), so
// an extremum tie of -0.0 and +0.0 keeps the first in row order, as the
// plain version does.
//
// Bound by bytes: 8 B of group id, 1 B of contrib, 8 B of value and 1 B
// of valid per row and reduction. The windows read them once a window
// (what is read for rows outside a window is loaded and dropped); the
// sorted route adds 8 B of offset id, 16 B of sorted id and permutation
// per row and the radix passes, and gathers values at random. The block
// route spends its time on each chunk's dependent steps: a memory round
// trip a group of reductions, the f64 staging's two barriers and block
// scan.
#include <cstring>

#include "seg_block.cuh"
#include "seg_sorted.cuh"

#define K6_RED 2   // (op, contrib pointer) per reduction

// ---- the tables. By value: K6_PARAM_ROWS table rows (regions, or window
// rows with each one's region and first region-local segment in `win`),
// K6_PARAM_TAB plane pointers (values then valid, [n_red][R] each);
// larger tables are read from the card through the _dev pointers. The
// block route keeps its regions within K6_PARAM_REGIONS by value.
#define K6_PARAM_REGIONS 16
#define K6_PARAM_ROWS 64
#define K6_PARAM_TAB 512
#define K6_WIN 2   // (region, first region-local segment) per window row

struct K6Params {
  i64 rdesc[K6_PARAM_ROWS * K6_RDESC];
  i64 win[K6_PARAM_ROWS * K6_WIN];
  i64 red[K6B_MAX_REDS * K6_RED];
  u64 tab[K6_PARAM_TAB];
  int windowed;           // the table's rows are windows (win holds their regions)
  const i64* rdesc_dev;   // non-null: every table on the card
  const i64* win_dev;
  const i64* red_dev;
  const u64* tab_dev;
};

__device__ __forceinline__ const i64* k6p_rdesc(const K6Params& p) {
  return p.rdesc_dev != nullptr ? p.rdesc_dev : p.rdesc;
}
__device__ __forceinline__ const i64* k6p_win(const K6Params& p) {
  return !p.windowed ? nullptr : p.win_dev != nullptr ? p.win_dev : p.win;
}
__device__ __forceinline__ const i64* k6p_red(const K6Params& p) {
  return p.red_dev != nullptr ? p.red_dev : p.red;
}
__device__ __forceinline__ const u64* k6p_tab(const K6Params& p) {
  return p.tab_dev != nullptr ? p.tab_dev : p.tab;
}

// The parameter block of W table rows (windowed: followed by W window
// pairs) over R regions: from `tables` (host memory, copied in), or
// pointing at the same layout on the card. -1 where the host tables do
// not fit.
static int k6_params(K6Params* p, const i64* tables, int on_card, int W, int R, int n_red,
                     int windowed) {
  const size_t n_rd = (size_t)W * K6_RDESC, n_w = windowed ? (size_t)W * K6_WIN : 0,
               n_rr = (size_t)n_red * K6_RED, n_tab = 2 * (size_t)n_red * R;
  p->windowed = windowed;
  if (on_card) {
    p->rdesc_dev = tables;
    p->win_dev = tables + n_rd;
    p->red_dev = tables + n_rd + n_w;
    p->tab_dev = (const u64*)(tables + n_rd + n_w + n_rr);
    return 0;
  }
  if (W > K6_PARAM_ROWS || n_tab > K6_PARAM_TAB || n_red > K6B_MAX_REDS) return -1;
  memcpy(p->rdesc, tables, 8 * n_rd);
  memcpy(p->win, tables + n_rd, 8 * n_w);
  memcpy(p->red, tables + n_rd + n_w, 8 * n_rr);
  memcpy(p->tab, tables + n_rd + n_w + n_rr, 8 * n_tab);
  p->rdesc_dev = nullptr;
  p->win_dev = nullptr;
  p->red_dev = nullptr;
  p->tab_dev = nullptr;
  return 0;
}

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

// ---- the block and window routes (seg_block.cuh); a table row's slots
// are its region's reductions.

// Pass 2: a thread per (reduction, segment) folds its table row's block
// partials in block order; a segment past its row's span (a region's
// padding past its last window) holds the identity.
__global__ void seg_states_fold(const __grid_constant__ K6Params p, int W, i64 n_seg, int n_red,
                                int span_max, const i64* __restrict__ part,
                                i64* __restrict__ out) {
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (i64)n_red * n_seg) return;
  const i64* rdesc = k6p_rdesc(p);
  const int j = (int)(idx / n_seg);
  const i64 s = idx % n_seg;
  const int op = (int)k6p_red(p)[K6_RED * j];
  const int r = k6_region(rdesc, W, 2, s);
  const i64* d = rdesc + K6_RDESC * r;
  const i64 local = s - d[2];
  const i64 slab = (i64)n_red * span_max;
  i64 a = val_ident(op);
  if (local < d[3])
    for (i64 t = d[4]; t < d[4] + d[5]; ++t)
      a = val_merge(op, a, part[t * slab + (i64)j * span_max + local]);
  out[idx] = a;
}

struct K6BSrc {
  int n_slots;
  const i64* red;
  const u64* vals_tab;
  const u64* valid_tab;
  int R;
  const i64* win;   // window rows: each row's region and first local segment
  __device__ i64 first(int r, const i64* d) const { return win != nullptr ? win[K6_WIN * r + 1] : 0; }
  __device__ SbSlot slot(int j, int r, i64 base) const {
    const int g = win != nullptr ? (int)win[K6_WIN * r] : r;   // the region
    SbSlot s;
    s.op = (int)red[K6_RED * j];
    s.flags = 0;
    s.contrib = (const unsigned char*)red[K6_RED * j + 1] + base;
    s.valid = (const unsigned char*)valid_tab[(i64)j * R + g];
    s.vals = s.op == R_COUNT ? nullptr : (const i64*)vals_tab[(i64)j * R + g];
    s.cval = 1;
    return s;
  }
};

// MINB blocks an SM: 1 for spans that take most of the shared memory, 2
// for small spans (at most 64 registers a thread). W table rows over R
// regions.
template <int ROWS, int MINB>
__global__ void __launch_bounds__(K6B_THREADS, MINB)
seg_states_block(const __grid_constant__ K6Params p, int W, int R, const i64* __restrict__ gid,
                 int n_red, int span_max, int copies, i64* __restrict__ part) {
  const u64* tab = k6p_tab(p);
  const K6BSrc src = {n_red, k6p_red(p), tab, tab + (size_t)n_red * R, R, k6p_win(p)};
  seg_block_run<ROWS>(k6p_rdesc(p), W, gid, src, span_max, copies, part);
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

// Both passes of the block and window routes over the W table rows of p.
static int k6_block_go(int rows, int minb, int copies, int n_blocks, const K6Params& p, int W,
                       int R, const i64* gid, int n_red, int n_f, int span_max, i64 n_seg,
                       i64* part, i64* out, cudaStream_t st) {
  if (n_red < 1 || n_red > K6B_MAX_REDS || n_f < 0 || n_f > n_red || R < 1 || W < 1 ||
      n_seg < 1 || span_max < 1 || copies < 1 || (copies & (copies - 1)))
    return -1;
  long long lim = 0;
  cudaError_t e = k6b_ready_rows(rows, minb, &lim);
  if (e != cudaSuccess) return (int)e;
  const long long smem = k6b_copies_bytes(n_red, n_f, span_max, rows, copies);
  if (smem > lim) return -1;
  if (n_blocks > 0) {
    const dim3 g((unsigned)n_blocks);
    if (minb == K6B_SMALL_BLOCKS)
      seg_states_block<K6B_SMALL_ROWS, K6B_SMALL_BLOCKS><<<g, K6B_THREADS, (size_t)smem, st>>>(
          p, W, R, gid, n_red, span_max, copies, part);
    else if (rows == 1)
      seg_states_block<1, 1><<<g, K6B_THREADS, (size_t)smem, st>>>(p, W, R, gid, n_red, span_max,
                                                                  copies, part);
    else if (rows == 2)
      seg_states_block<2, 1><<<g, K6B_THREADS, (size_t)smem, st>>>(p, W, R, gid, n_red, span_max,
                                                                  copies, part);
    else
      seg_states_block<4, 1><<<g, K6B_THREADS, (size_t)smem, st>>>(p, W, R, gid, n_red, span_max,
                                                                  copies, part);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const i64 total = (i64)n_red * n_seg;
  seg_states_fold<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p, W, n_seg, n_red, span_max,
                                                                  part, out);
  return (int)cudaGetLastError();
}

// ---- the sorted route: each row's offset id, then (after the caller's
// radix sort) the segmented pass of seg_sorted.cuh over the sorted ids; a
// segment's state is stored as its value (its count for R_COUNT)

// keys[row] = gid[row] + the segment offset of row's region.
__global__ void seg_states_keys(const __grid_constant__ K6Params p, int R, i64 n,
                                const i64* __restrict__ gid, i64* __restrict__ keys) {
  const i64* rdesc = k6p_rdesc(p);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride)
    keys[row] = gid[row] + rdesc[K6_RDESC * k6_region(rdesc, R, 0, row) + 2];
}

struct K6Src {
  int n_red;
  int R;
  K6Params p;
  __device__ int op(int j) const { return (int)k6p_red(p)[K6_RED * j]; }
  __device__ bool take(int j, i64 row, i64* x) const {
    const i64* rdesc = k6p_rdesc(p);
    const u64* tab = k6p_tab(p);
    const int r = k6_region(rdesc, R, 0, row);
    return k6_take(k6p_red(p), tab, tab + (size_t)n_red * R, R, j, r, row,
                   row - rdesc[K6_RDESC * r], x);
  }
  __device__ void store(i64* out, i64 n_seg, int j, i64 s, Acc a) const {
    out[(i64)j * n_seg + s] = op(j) == R_COUNT ? a.n : a.v;
  }
};

extern "C" int seg_states_pieces_count(i64 n) { return sorted_pieces_count(n); }

// tables: as seg_states_block_launch's (R region rows, the reductions,
// the plane pointers; fields 4 and 5 unused). keys: n int64.
extern "C" int seg_states_keys_launch(const i64* tables, int on_card, int R, int n_red, i64 n,
                                      const i64* gid, i64* keys, void* stream) {
  if (R < 1 || n < 1) return -1;
  K6Params p;
  if (k6_params(&p, tables, on_card, R, R, n_red, 0) != 0) return -1;
  i64 blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  seg_states_keys<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(p, R, n, gid, keys);
  return (int)cudaGetLastError();
}

// Both passes over the n ids sorted by the caller; part holds
// 4 * n_red * seg_states_pieces_count(n) int64.
extern "C" int seg_states_sorted_launch(i64 n, const i64* gid_sorted, const i64* order,
                                        const i64* tables, int on_card, int R, i64 n_seg,
                                        int n_red, i64* part, i64* out, void* stream) {
  if (R < 1) return -1;
  K6Src src;
  src.n_red = n_red;
  src.R = R;
  if (k6_params(&src.p, tables, on_card, R, R, n_red, 0) != 0) return -1;
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
// each): a host array that rides by value where it fits K6Params
// (K6_PARAM_REGIONS regions), else (on_card) the same layout on the card.
// n_f of the n_red reductions are f64 ops (the kernel finds which);
// copies (a power of two) of the integer states; part holds n_blocks *
// n_red * span_max int64.
extern "C" int seg_states_block_launch(int rows, int minb, int copies, int n_blocks,
                                       const i64* tables, int on_card, int R, const i64* gid,
                                       int n_red, int n_f, int span_max, i64 n_seg, i64* part,
                                       i64* out, void* stream) {
  if (!on_card && R > K6_PARAM_REGIONS) return -1;
  K6Params p;
  if (R < 1 || k6_params(&p, tables, on_card, R, R, n_red, 0) != 0) return -1;
  return k6_block_go(rows, minb, copies, n_blocks, p, R, R, gid, n_red, n_f, span_max, n_seg,
                     part, out, (cudaStream_t)stream);
}

// The window route: W window rows (K6_RDESC int64 each: the region's row
// base and rows, the window's global first segment and its segments, its
// first block and blocks; ascending by segment), then W (region, first
// region-local segment) pairs, then the reductions and the plane pointers
// of the R regions as seg_states_block_launch's. By value where they fit
// K6Params (K6_PARAM_ROWS rows), else on the card (on_card). One block an
// SM at `rows` rows a thread; span_max the longest window.
extern "C" int seg_states_window_launch(int rows, int copies, int n_blocks, const i64* tables,
                                        int on_card, int W, int R, const i64* gid, int n_red,
                                        int n_f, int span_max, i64 n_seg, i64* part, i64* out,
                                        void* stream) {
  K6Params p;
  if (R < 1 || W < 1 || k6_params(&p, tables, on_card, W, R, n_red, 1) != 0) return -1;
  return k6_block_go(rows, 1, copies, n_blocks, p, W, R, gid, n_red, n_f, span_max, n_seg, part,
                     out, (cudaStream_t)stream);
}
