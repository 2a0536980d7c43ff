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
// reports; seg_states_block_limit): a persistent grid gives each region
// blocks in proportion to its rows, each block a fixed contiguous slice of
// them and ONE copy of the region's span in shared memory for all its
// reductions. The block reads its rows once, in order, a chunk of
// K6B_THREADS * ROWS rows at a time (one row a thread a step, coalesced
// loads, each group of K6B_GROUP reductions' contrib, valid and value
// loads issued together); rows that contribute nothing are never staged.
// Integer reductions (counts, wrapping sums, exact min and max) fold at
// once by shared-memory integer atomics, whose result no order changes.
// F64 reductions fold in a fixed order: a step's rows of one segment in
// one warp fold first (a tree in lane order, which is row order) into one
// staged row; the staged rows are bucketed by segment class (k6b_class)
// in row order (ranks from __match_any_sync, a block scan for the
// buckets' offsets); warp w then folds class w's rows 32 at a time, lanes
// grouped by segment and folded as a tree in lane order, the group's
// first lane folding the result into the span copy. So every f64 state is
// folded by one warp in row order, with no float atomics. Each block
// writes its span's partials ([blocks, reductions, span]); pass 2 folds
// a region's block partials in block order. There is no sort and no
// search per row.
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
#include "seg_sorted.cuh"

#define K6_RDESC 6
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

// The last region whose descriptor field `f` (0: row base, 2: segment
// offset, 4: the block route's first block; each ascending) is <= key.
__device__ __forceinline__ int k6_region(const i64* rdesc, int R, int f, i64 key) {
  int lo = 0, hi = R - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rdesc[K6_RDESC * mid + f] <= key) lo = mid; else hi = mid - 1;
  }
  return lo;
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

// ---- spans in the opt-in shared memory: one copy a block ----
#define K6B_THREADS 512
#define K6B_WARPS (K6B_THREADS / 32)   // warps, and segment classes
#define K6B_MAX_REDS 32                // a staged row's take bits: one word
#define K6B_GROUP 4                    // reductions whose loads go together

// Bytes of dynamic shared memory: the span copy [n_red][span] and, with
// n_f f64 reductions, a chunk of C = K6B_THREADS * rows rows staged
// (values [n_f][C], group ids [C], take bits [C]) and two sets of bucket
// offsets [class][step][warp] plus their total (kernels.k6_block_bytes
// mirrors this).
__host__ __device__ inline long long k6b_smem_bytes(int n_red, int n_f, int span_max, int rows) {
  const long long c = (long long)K6B_THREADS * rows;
  return 8LL * n_red * span_max +
         (n_f > 0 ? c * (8LL * n_f + 8) + 8LL * (K6B_WARPS * K6B_WARPS * rows + 1) : 0);
}

// A segment's class (the warp that folds it): its low bits mixed with
// the next ones, so that a class's segments fall in every bank of the
// span copy (s mod K6B_WARPS would put them all in one) and small spans
// still spread over every warp.
__device__ __forceinline__ int k6b_class(int s) { return (s ^ (s >> 4)) & (K6B_WARPS - 1); }

// Exclusive scan of h[0, H) in place, h[H] = the total; every thread calls it.
__device__ __forceinline__ void k6b_scan(int* h, int H, int* wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (H + K6B_THREADS - 1) / K6B_THREADS;
  const int i0 = t * per < H ? t * per : H, i1 = i0 + per < H ? i0 + per : H;
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += h[i];
  int inc = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < K6B_WARPS ? wsum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < K6B_WARPS) wsum[lane] = w;   // inclusive
  }
  __syncthreads();
  int run = inc - mine + (warp > 0 ? wsum[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int c = h[i];
    h[i] = run;
    run += c;
  }
  if (t == K6B_THREADS - 1) h[H] = wsum[K6B_WARPS - 1];
  __syncthreads();
}

// Fold v (the op's identity where a lane takes nothing) over the lanes of
// each group of `peers` (the lanes of one segment) as a tree in lane
// order, the left part first: the group's first lane ends with the
// group's fold. maxc, the largest group, is the same on every lane.
__device__ __forceinline__ i64 k6b_group_fold(int op, i64 v, unsigned peers, int maxc,
                                              int lane) {
  const int rk = __popc(peers & ((1u << lane) - 1u));
  unsigned md = peers & ~((2u << lane) - 1u);   // the 2^s-th peer after this lane
  for (int s = 0; (1 << s) < maxc; ++s) {
    const int src = md != 0u ? __ffs(md) - 1 : lane;
    const i64 y = __shfl_sync(0xffffffffu, v, src);
    if ((rk & ((2 << s) - 1)) == 0 && src != lane) v = val_merge(op, v, y);
    for (int c = 0; c < (1 << s) && md != 0u; ++c) md &= md - 1u;
  }
  return v;
}

__device__ __forceinline__ bool k6b_is_f64(int op) {
  return op == R_SUM_F || op == R_MIN_F || op == R_MAX_F;
}

template <int ROWS>
__global__ void __launch_bounds__(K6B_THREADS, 1)
seg_states_block(const i64* __restrict__ rdesc, int R, const i64* __restrict__ gid, int n_red,
                 const i64* __restrict__ red, const u64* __restrict__ vals_tab,
                 const u64* __restrict__ valid_tab, int span_max, i64* __restrict__ part) {
  constexpr int C = ROWS * K6B_THREADS;
  constexpr int H = K6B_WARPS * ROWS * K6B_WARPS;   // buckets: [class][step][warp]
  extern __shared__ i64 k6b_smem[];
  __shared__ int s_op[K6B_MAX_REDS];
  __shared__ int s_fj[K6B_MAX_REDS];                 // the f64 reductions, in order
  __shared__ const unsigned char* s_contrib[K6B_MAX_REDS];
  __shared__ const unsigned char* s_valid[K6B_MAX_REDS];
  __shared__ const i64* s_vals[K6B_MAX_REDS];
  __shared__ int s_wsum[K6B_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r = k6_region(rdesc, R, 4, blockIdx.x);
  const i64* d = rdesc + K6_RDESC * r;
  const i64 base = d[0], n_rows = d[1], units = d[5], jb = blockIdx.x - d[4];
  const int span = (int)d[3];
  const i64 lo = n_rows * jb / units, hi = n_rows * (jb + 1) / units;
  int n_f = 0;
  unsigned fmask = 0u;
  for (int j = 0; j < n_red; ++j) {
    const int op = (int)red[K6_RED * j];
    if (k6b_is_f64(op)) {
      if (t == 0) s_fj[n_f] = j;
      fmask |= 1u << j;
      ++n_f;
    }
  }
  i64* acc = k6b_smem;                                   // [n_red][span]
  i64* sx = acc + (size_t)n_red * span_max;              // [n_f][C]
  int* sg = (int*)(sx + (size_t)n_f * C);                // [C]
  unsigned* stk = (unsigned*)(sg + C);                   // [C]
  int* hist = (int*)(stk + C);                           // two of [H + 1]
  for (int j = t; j < n_red; j += K6B_THREADS) {
    s_op[j] = (int)red[K6_RED * j];
    s_contrib[j] = (const unsigned char*)red[K6_RED * j + 1];
    s_valid[j] = (const unsigned char*)valid_tab[(i64)j * R + r];
    s_vals[j] = (const i64*)vals_tab[(i64)j * R + r];
  }
  if (n_f > 0)
    for (int i = t; i < 2 * (H + 1); i += K6B_THREADS) hist[i] = 0;
  __syncthreads();
  for (int i = t; i < n_red * span; i += K6B_THREADS) acc[i] = val_ident(s_op[i / span]);
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;

  int par = 0;
  for (i64 c0 = lo; c0 < hi; c0 += C, par ^= 1) {
    // 1. each row's group id and take bits; the integer reductions' values
    //    come with them (read for every row of the slice, so that one
    //    round trip serves the group) and fold at once (shared-memory
    //    integer atomics: a wrapping sum, a count, an exact min or max,
    //    whose result no order changes)
    int g[ROWS];
    unsigned tk[ROWS];
    i64 local[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      local[u] = c0 + u * K6B_THREADS + t;
      const bool in = local[u] < hi;
      g[u] = in ? (int)gid[base + local[u]] : -1;
      if (g[u] >= span) g[u] = -1;
      tk[u] = 0;
      if (!in) local[u] = -1;
    }
    for (int j0 = 0; j0 < n_red; j0 += K6B_GROUP) {
      unsigned char cb[K6B_GROUP][ROWS], vb[K6B_GROUP][ROWS];
      i64 xv[K6B_GROUP][ROWS];
#pragma unroll
      for (int q = 0; q < K6B_GROUP; ++q) {
        const int j = j0 + q;
        const unsigned char* cp = j < n_red ? s_contrib[j] : nullptr;
        const unsigned char* vp = j < n_red ? s_valid[j] : nullptr;
        const int op = j < n_red ? s_op[j] : R_COUNT;
        const i64* xp = (j < n_red && op != R_COUNT && !k6b_is_f64(op)) ? s_vals[j] : nullptr;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const bool in = local[u] >= 0 && g[u] >= 0;
          cb[q][u] = (cp != nullptr && in) ? cp[base + local[u]] : 0;
          vb[q][u] = (vp != nullptr && in) ? vp[local[u]] : 1;
          xv[q][u] = (xp != nullptr && in) ? xp[local[u]] : 1;
        }
      }
#pragma unroll
      for (int q = 0; q < K6B_GROUP; ++q) {
        const int j = j0 + q;
        if (j >= n_red) break;
        const int op = s_op[j];
        const bool f64 = (fmask >> j) & 1u;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const bool take = cb[q][u] != 0 && vb[q][u] != 0;
          tk[u] |= (unsigned)take << j;
          if (!take || f64) continue;
          i64* p = acc + (size_t)j * span + g[u];
          if (op == R_MIN_I) atomicMin((long long*)p, (long long)xv[q][u]);
          else if (op == R_MAX_I) atomicMax((long long*)p, (long long)xv[q][u]);
          else atomicAdd((unsigned long long*)p, (unsigned long long)xv[q][u]);
        }
      }
    }
    if (n_f == 0) continue;
    // 2. the rows that take an f64 reduction. A step's rows of one segment
    //    in one warp (`peg`, in lane order, which is row order) stage as
    //    one row, the first, with their values folded and their take bits
    //    or-ed, so a segment that takes most rows stages few. The staged
    //    rows' class (K6B_WARPS: none), rank in their (class, step, warp)
    //    bucket and the buckets' offsets (class-major, so each class's
    //    rows are one run, in row order)
    int* hc = hist + par * (H + 1);
    int cls[ROWS], rank[ROWS], maxg[ROWS];
    unsigned peg[ROWS], tkf[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const bool ok = (tk[u] & fmask) != 0u;
      peg[u] = __match_any_sync(0xffffffffu, ok ? g[u] : -1 - lane);
      maxg[u] = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(peg[u]));
      tkf[u] = tk[u] & fmask;
      if (maxg[u] > 1)
        for (int f = 0; f < n_f; ++f) {
          const int j = s_fj[f];
          if ((__ballot_sync(0xffffffffu, (tk[u] >> j) & 1u) & peg[u]) != 0u)
            tkf[u] |= 1u << j;
        }
      const bool lead = ok && (peg[u] & lt) == 0u;
      cls[u] = lead ? k6b_class(g[u]) : K6B_WARPS;
      const unsigned peers = __match_any_sync(0xffffffffu, cls[u]);
      rank[u] = __popc(peers & lt);
      if (lead && rank[u] == 0) hc[(cls[u] * ROWS + u) * K6B_WARPS + warp] = __popc(peers);
    }
    __syncthreads();
    k6b_scan(hc, H, s_wsum);
    // 3. stage: group id, take bits and each f64 reduction's value (the
    //    group's fold, a tree in lane order)
    int pos[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      pos[u] = -1;
      if (cls[u] < K6B_WARPS) {
        pos[u] = hc[(cls[u] * ROWS + u) * K6B_WARPS + warp] + rank[u];
        sg[pos[u]] = g[u];
        stk[pos[u]] = tkf[u];
      }
    }
    for (int f0 = 0; f0 < n_f; f0 += K6B_GROUP) {
      i64 xf[K6B_GROUP][ROWS];
#pragma unroll
      for (int q = 0; q < K6B_GROUP; ++q) {
        const int j = f0 + q < n_f ? s_fj[f0 + q] : -1;
        const i64* vp = j >= 0 ? s_vals[j] : nullptr;
        const i64 id = val_ident(j >= 0 ? s_op[j] : R_COUNT);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const bool takes = j >= 0 && ((tk[u] >> j) & 1u);
          xf[q][u] = takes ? (vp != nullptr ? vp[local[u]] : 1) : id;
        }
      }
#pragma unroll
      for (int q = 0; q < K6B_GROUP; ++q) {
        if (f0 + q >= n_f) break;
        const int op = s_op[s_fj[f0 + q]];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          if (maxg[u] > 1) xf[q][u] = k6b_group_fold(op, xf[q][u], peg[u], maxg[u], lane);
          if (pos[u] >= 0) sx[(size_t)(f0 + q) * C + pos[u]] = xf[q][u];
        }
      }
    }
    // the next chunk's buckets start at zero
    int* hn = hist + (par ^ 1) * (H + 1);
    for (int i = t; i < H; i += K6B_THREADS) hn[i] = 0;
    const int a0 = hc[warp * ROWS * K6B_WARPS], a1 = hc[(warp + 1) * ROWS * K6B_WARPS];
    __syncthreads();
    // 4. warp w folds class w's f64 reductions, 32 staged rows at a time:
    //    lanes grouped by segment; each group folds as a tree over its
    //    lanes in lane (row) order, the left part first (no step when every
    //    group is one lane), and its first lane folds the result into the
    //    span copy
    for (int i0 = a0; i0 < a1; i0 += 32) {
      const int i = i0 + lane;
      const bool act = i < a1;
      const int gg = act ? sg[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, gg);
      const int rk = __popc(peers & lt);
      const unsigned tkl = act ? stk[i] : 0u;
      const int maxc = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(peers));
      for (int f = 0; f < n_f; ++f) {
        const int j = s_fj[f];
        const bool mine = act && ((tkl >> j) & 1u);
        const unsigned takers = __ballot_sync(0xffffffffu, mine);
        if (takers == 0u) continue;
        const int op = s_op[j];
        i64 v = mine ? sx[(size_t)f * C + i] : val_ident(op);
        v = k6b_group_fold(op, v, peers, maxc, lane);
        if (act && rk == 0 && (peers & takers) != 0u) {
          i64* p = acc + (size_t)j * span + gg;
          *p = val_merge(op, *p, v);
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();
  i64* out = part + (size_t)blockIdx.x * n_red * span_max;
  for (int i = t; i < n_red * span; i += K6B_THREADS) {
    const int j = i / span;
    out[(size_t)j * span_max + (i - j * span)] = acc[i];
  }
}

// The kernel's shared-memory opt-in, once per device: the card's limit
// for one block less the kernel's static shared memory.
template <int ROWS>
static cudaError_t k6b_ready(long long* limit) {
  static bool ready[64];
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, seg_states_block<ROWS>);
  if (e != cudaSuccess) return e;
  const long long lim = (long long)optin - (long long)fa.sharedSizeBytes;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(seg_states_block<ROWS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lim);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  if (limit != nullptr) *limit = lim;
  return cudaSuccess;
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
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = k6b_ready_rows(rows, nullptr);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    switch (rows) {
      case 1: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, seg_states_block<1>,
                                                                 K6B_THREADS, (size_t)smem); break;
      case 2: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, seg_states_block<2>,
                                                                 K6B_THREADS, (size_t)smem); break;
      default: e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, seg_states_block<4>,
                                                                  K6B_THREADS, (size_t)smem);
    }
  }
  if (e != cudaSuccess) return -(int)e;
  if (occ < 1) return -(int)cudaErrorInvalidValue;
  return sms * occ;
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
