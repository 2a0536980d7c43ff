// The block route of segmented states: copies of a span of segments a
// block, in Hopper's opt-in shared memory. Shared by K6
// (seg_states_ragged.cu: a region's span, region-local group ids) and K4
// (seg_agg_sorted.cu: a window of a statement's segments, global group
// ids). A source type tells the two apart:
//
//   int n_slots;                                       states a segment keeps
//   __device__ i64 first(int r, const i64* d) const;   the id of region r's
//                                                      first segment (d its
//                                                      table row), which is
//                                                      subtracted from each
//                                                      row's id
//   __device__ SbSlot slot(int j, int r, i64 base) const;
//                                                      slot j's inputs in
//                                                      region r (rows from
//                                                      `base`)
//
// The region table holds K6_RDESC int64 a region: row base, rows,
// first segment, span, first block, blocks. A "region" of the table is
// what one span copy covers: K6's region, a window of K4's segments, or
// a window of one of K6's regions (several table rows then share the
// region's rows). A persistent grid gives each
// region blocks (ops/kernels.py k6_block_units), each block a fixed
// contiguous slice of the region's rows and its own copies of the
// region's span for all its slots (one copy, or as many copies of the
// integer states as the caller asks for: kernels.k4_copies). The block reads its rows once, in order, a
// chunk of K6B_THREADS * ROWS rows at a time (one row a thread a step,
// coalesced loads, each group of K6B_GROUP slots' contrib, valid and value
// loads issued together); rows outside the span and rows that contribute
// nothing are never staged. Integer slots (counts, wrapping sums, exact
// min and max, the first row) fold at once by shared-memory integer
// atomics, whose result no order changes (a count, below 2^32 in a
// block's slice, by a 32-bit add to the low word of its state). F64 slots
// fold in a fixed
// order: a step's rows of one segment in one warp fold first (a tree in
// lane order, which is row order) into one staged row; the staged rows
// are bucketed by segment class (k6b_class) in row order (ranks from
// __match_any_sync, a block scan for the buckets' offsets); warp w then
// folds class w's rows 32 at a time, lanes grouped by segment and folded
// as a tree in lane order, the group's first lane folding the result into
// the span copy. So every f64 state is folded by one warp in row order,
// with no float atomics, and an extremum tie of -0.0 and +0.0 keeps the
// first in row order. Each block writes its span's partials ([blocks,
// slots, span_max]); the caller's pass 2 folds a region's block partials
// in block order. There is no sort and no search per row.
#pragma once

#include "common.cuh"

#define K6_RDESC 6
#define K6B_THREADS 512
#define K6B_WARPS (K6B_THREADS / 32)   // warps, and segment classes
#define K6B_MAX_REDS 32                // a staged row's take bits: one word
#define K6B_GROUP 4                    // slots whose loads go together
#define K6B_ROW_VALUE 1                // slot flag: the value is the row

// One slot's inputs in a region, each plane indexed by the region-local
// row: contributing rows, their validity (null: all valid) and values
// (null: cval, or with K6B_ROW_VALUE the row itself). op is the fold:
// R_COUNT adds the value (1 for a count), R_FIRST keeps the least.
struct SbSlot {
  int op;
  int flags;
  const unsigned char* contrib;
  const unsigned char* valid;
  const i64* vals;
  i64 cval;
};

// Bytes of dynamic shared memory: the span copy [n_red][span] and, with
// n_f f64 slots, a chunk of C = K6B_THREADS * rows rows staged
// (values [n_f][C], group ids [C], take bits [C]) and two sets of bucket
// offsets [class][step][warp] plus their total (kernels.k6_block_bytes
// mirrors this).
__host__ __device__ inline long long k6b_smem_bytes(int n_red, int n_f, int span_max, int rows) {
  const long long c = (long long)K6B_THREADS * rows;
  return 8LL * n_red * span_max +
         (n_f > 0 ? c * (8LL * n_f + 8) + 8LL * (K6B_WARPS * K6B_WARPS * rows + 1) : 0);
}

// ... plus copies - 1 more copies of the integer states.
__host__ __device__ inline long long k6b_copies_bytes(int n_red, int n_f, int span_max, int rows,
                                                      int copies) {
  return k6b_smem_bytes(n_red, n_f, span_max, rows) + 8LL * (copies - 1) * n_red * span_max;
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

// The block's work; the caller's kernel is __launch_bounds__(K6B_THREADS,
// blocks an SM) and runs it with ROWS rows a thread per chunk. `copies`
// (a power of two; 1 keeps one copy) replicates the integer states: lane
// l folds into copy l mod copies, so the lanes of a step that share a
// segment spread over as many addresses; the copies follow the staging in
// shared memory (k6b_copies_bytes) and fold into the first at the end.
template <int ROWS, class Src>
__device__ __forceinline__ void seg_block_run(const i64* __restrict__ rdesc, int R,
                                              const i64* __restrict__ gid, const Src& src,
                                              int span_max, int copies,
                                              i64* __restrict__ part) {
  constexpr int C = ROWS * K6B_THREADS;
  constexpr int H = K6B_WARPS * ROWS * K6B_WARPS;   // buckets: [class][step][warp]
  extern __shared__ i64 k6b_smem[];
  __shared__ int s_op[K6B_MAX_REDS];
  __shared__ int s_fj[K6B_MAX_REDS];                 // the f64 slots, in order
  __shared__ int s_rowv[K6B_MAX_REDS];
  __shared__ i64 s_cval[K6B_MAX_REDS];
  __shared__ const unsigned char* s_contrib[K6B_MAX_REDS];
  __shared__ const unsigned char* s_valid[K6B_MAX_REDS];
  __shared__ const i64* s_vals[K6B_MAX_REDS];
  __shared__ int s_wsum[K6B_WARPS];
  const int n_red = src.n_slots;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r = k6_region(rdesc, R, 4, blockIdx.x);
  const i64* d = rdesc + K6_RDESC * r;
  const i64 base = d[0], n_rows = d[1], units = d[5], jb = blockIdx.x - d[4];
  const i64 sub = src.first(r, d);
  const int span = (int)d[3];
  const i64 lo = n_rows * jb / units, hi = n_rows * (jb + 1) / units;
  for (int j = t; j < n_red; j += K6B_THREADS) {
    const SbSlot sl = src.slot(j, r, base);
    s_op[j] = sl.op;
    s_rowv[j] = (sl.flags & K6B_ROW_VALUE) != 0;
    s_cval[j] = sl.cval;
    s_contrib[j] = sl.contrib;
    s_valid[j] = sl.valid;
    s_vals[j] = sl.vals;
  }
  __syncthreads();
  int n_f = 0;
  unsigned fmask = 0u;
  for (int j = 0; j < n_red; ++j) {
    if (k6b_is_f64(s_op[j])) {
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
  i64* ext = n_f > 0 ? (i64*)(hist + 2 * (H + 1))        // [copies - 1][n_red][span]
                     : acc + (size_t)n_red * span_max;
  const size_t slab = (size_t)n_red * span;
  if (n_f > 0)
    for (int i = t; i < 2 * (H + 1); i += K6B_THREADS) hist[i] = 0;
  for (int i = t; i < n_red * span; i += K6B_THREADS) acc[i] = val_ident(s_op[i / span]);
  for (size_t i = t; i < (size_t)(copies - 1) * slab; i += K6B_THREADS)
    ext[i] = val_ident(s_op[(i % slab) / span]);
  i64* mine = (lane & (copies - 1)) == 0 ? acc : ext + ((lane & (copies - 1)) - 1) * slab;
  __syncthreads();
  const unsigned lt = (1u << lane) - 1u;

  int par = 0;
  for (i64 c0 = lo; c0 < hi; c0 += C, par ^= 1) {
    // 1. each row's segment in the span and take bits; the integer slots'
    //    values come with them (read for every row of the slice, so that
    //    one round trip serves the group) and fold at once (shared-memory
    //    integer atomics: a wrapping sum, a count, an exact min or max,
    //    whose result no order changes)
    int g[ROWS];
    unsigned tk[ROWS];
    i64 local[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      local[u] = c0 + u * K6B_THREADS + t;
      const bool in = local[u] < hi;
      const i64 s = in ? gid[base + local[u]] - sub : -1;
      g[u] = (s >= 0 && s < span) ? (int)s : -1;
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
        const bool ints = j < n_red && !k6b_is_f64(op);
        const i64* xp = ints ? s_vals[j] : nullptr;
        const bool rowv = ints && s_rowv[j];
        const i64 cv = ints ? s_cval[j] : 1;
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const bool in = local[u] >= 0 && g[u] >= 0;
          cb[q][u] = (cp != nullptr && in) ? cp[local[u]] : 0;
          vb[q][u] = (vp != nullptr && in) ? vp[local[u]] : 1;
          xv[q][u] = (xp != nullptr && in) ? xp[local[u]] : (rowv ? local[u] : cv);
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
          const i64 x = xv[q][u];
          i64* p = mine + (size_t)j * span + g[u];
          if (op == R_COUNT) atomicAdd((unsigned*)p, 1u);
          else if (op == R_MIN_I || op == R_FIRST) atomicMin((long long*)p, (long long)x);
          else if (op == R_MAX_I) atomicMax((long long*)p, (long long)x);
          else atomicAdd((unsigned long long*)p, (unsigned long long)x);
        }
      }
    }
    if (n_f == 0) continue;
    // 2. the rows that take an f64 slot. A step's rows of one segment in
    //    one warp (`peg`, in lane order, which is row order) stage as one
    //    row, the first, with their values folded and their take bits
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
    // 3. stage: segment, take bits and each f64 slot's value (the group's
    //    fold, a tree in lane order)
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
        const i64 cv = j >= 0 ? s_cval[j] : 1;
        const i64 id = val_ident(j >= 0 ? s_op[j] : R_COUNT);
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const bool takes = j >= 0 && ((tk[u] >> j) & 1u);
          xf[q][u] = takes ? (vp != nullptr ? vp[local[u]] : cv) : id;
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
    // 4. warp w folds class w's f64 slots, 32 staged rows at a time:
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
    i64 a = acc[i];
    if (!k6b_is_f64(s_op[j]))                  // f64 states use the first copy
      for (int c = 1; c < copies; ++c) a = val_merge(s_op[j], a, ext[(size_t)(c - 1) * slab + i]);
    out[(size_t)j * span_max + (i - j * span)] = a;
  }
}

// A block kernel's shared-memory opt-in, once per device (ready: the
// kernel's own flags): the card's limit for one block less the kernel's
// static shared memory.
template <class Kernel>
static cudaError_t k6b_optin(Kernel kernel, bool* ready, long long* limit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  const long long lim = (long long)optin - (long long)fa.sharedSizeBytes;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lim);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  if (limit != nullptr) *limit = lim;
  return cudaSuccess;
}

// The persistent grid of a block kernel at smem bytes: SMs x resident
// blocks, or minus a CUDA error.
template <class Kernel>
static int k6b_grid(Kernel kernel, long long smem) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, K6B_THREADS, (size_t)smem);
  if (e != cudaSuccess) return -(int)e;
  if (occ < 1) return -(int)cudaErrorInvalidValue;
  return sms * occ;
}
