// K19 delta_merge_order: the merge order of a cached base batch and its
// region's delta (the HTAP freshness tier, copr/delta.py).
//
// Replaces tidb_tpu/ops/kernels.py:293 delta_merge_order (searchsorted of
// the base handles into the sorted tombstones for the keep mask, dead and
// tombstoned rows given the handle I64_MAX, the appended handles
// concatenated, one stable argsort, order[:n_live]). Order index i < n is
// base row i, n + j appended row j; the order ascends by handle, a base
// row before an appended row of the same handle (the stable argsort's tie
// rule).
//
// Both runs are already sorted by handle (the live base handles ascend:
// pack_ranges walks row keys in order and a merge emits in handle order;
// the tombstones and appended handles are sorted lists), so the order is a
// merge, not a sort, and one launch makes it: a single-pass scan with
// decoupled look-back over tiles of K19_TILE base rows taken from a
// ticket (lookback.cuh, as K18's window_scan.cu). In each tile:
//   - the handles and live bytes load once into registers (with the
//     tile's share of the tombstones' and appended handles' ascent
//     checks); each warp folds its threads' live ranges and four warps
//     fold the warps', then search that range once each into the
//     tombstones and the appended handles (32 probes a step: a few L2
//     round trips); only those slices
//     are staged in shared memory (up to K19_SLICE words each; a longer
//     slice is searched where it lies), so a call stages about m + k words
//     in all, not m + k a tile;
//   - a live row is kept unless the tombstone slice holds its handle (a
//     search for a thread's first row, a walk for the rest); the kept
//     rows are ranked by a warp scan and warp 0's scan of the warps,
//     their handles and rows kept in shared memory by rank;
//   - warp 0 publishes the tile's aggregate (kept rows; the appended
//     handles at or below its largest kept handle, U; its smallest and
//     largest live handle; flags) and the block looks back for the prefix
//     of the tiles before it. The live range rides in the scanned state, so the ascent check
//     of the live handles across tiles is the scan's own combine;
//   - kept row i goes to r_i + #(appended < h_i) (its rank among all kept
//     rows, then a search of the appended slice);
//   - appended rows j in [U before the tile, U through it) go to j + the
//     kept rows before the tile + #(the tile's kept handles <= app[j]);
//     the last tile also places those above every kept handle, so every
//     appended row is placed once, by the tile whose kept handles close
//     its gap. A call with no base rows still runs one tile;
//   - with a merged plane, each position also takes its row's handle;
//   - the last tile writes meta (kept rows, flags) straight into the
//     caller's page-locked host memory (mapped: no copy after the
//     launch).
// Every position is unique, so the writes need no atomics; the ticket is
// the one integer atomic, and no order changes the result: every run
// gives the same order. A broken precondition is reported in meta[1] (the
// wrapper raises); every read index stays inside its array and every
// write inside [0, n + k) (and the merged plane's length) whatever the
// inputs, so a broken precondition writes no memory out of bounds.
//
// A tile is K19_THREADS x K19_ITEMS rows (4,096), two blocks an SM: a
// tile's steps are latency (memory round trips and barriers), so a few
// large tiles finish sooner than many small ones (region_8 in one call of
// k5_k19_variants.py: 0.0345 ms, 2,048-row tiles at four blocks an SM
// 0.0413, 8,192-row tiles at one 0.0365; H100, 700 W), and one
// look-back step covers K19_THREADS tiles. The kept rows are placed a
// thread every K19_THREADS ranks, so a warp's stores are consecutive.
// The shared memory (the two slices and the kept rows, 72 KB) is
// dynamic; the kernel opts in once per process and device.
//
// Bound by bytes: the live bytes and the live rows' handles read once,
// the tombstones and appended handles once, the order (8 B a position)
// and the merged handle plane (8 B a position) written once.
#include <cstring>

#include "lookback.cuh"

#define K19_THREADS 512
#define K19_MIN_BLOCKS 2
#define K19_WARPS (K19_THREADS / 32)
#define K19_ITEMS 8
#define K19_TILE (K19_THREADS * K19_ITEMS)
#define K19_SLICE 2048              // staged words of a tile's tombstone or appended slice
// dynamic shared memory: the two slices, then the kept rows' handles and
// rows in the tile
#define K19_SMEM (8 * 2 * K19_SLICE + 10 * K19_TILE)
#define K19_W 5                     // words of a tile's published state
#define K19_SPIN_LIMIT (1ll << 26)  // look-back reads of one word before a fault
#define K19_I64_MAX 0x7fffffffffffffffll

// precondition flags: the contract with ops/kernels.py
#define K19_BAD_BASE 1      // the live base handles do not strictly ascend
#define K19_BAD_TOMB 2      // the tombstones do not ascend
#define K19_BAD_APP 4       // the appended handles do not ascend
#define K19_BAD_SENTINEL 8  // a live base or appended handle is I64_MAX
#define K19_BAD 15
// state flags: the span holds a live row, a kept row
#define K19_LIVE 16
#define K19_KEPT 32

// A span's state: its kept rows; `last` its last kept handle inside a
// tile, or U (the appended handles at or below it) once published; its
// smallest and largest live handle; flags.
struct K19St {
  i64 kept, last, minl, maxl, f;
};

__device__ __forceinline__ K19St k19_ident() {
  K19St r = {0, 0, 0, 0, 0};
  return r;
}

// a before b: the live handles of a must all lie below b's
__device__ __forceinline__ K19St k19_comb(const K19St& a, const K19St& b) {
  const bool al = (a.f & K19_LIVE) != 0, bl = (b.f & K19_LIVE) != 0;
  K19St r;
  r.kept = a.kept + b.kept;
  r.last = (b.f & K19_KEPT) ? b.last : a.last;
  r.minl = !al ? b.minl : !bl ? a.minl : (a.minl < b.minl ? a.minl : b.minl);
  r.maxl = !al ? b.maxl : !bl ? a.maxl : (a.maxl > b.maxl ? a.maxl : b.maxl);
  r.f = a.f | b.f | (al && bl && a.maxl >= b.minl ? K19_BAD_BASE : 0);
  return r;
}

__device__ __forceinline__ i64 k19_word(const K19St& s, int x) {
  return x == 0 ? s.kept : x == 1 ? s.last : x == 2 ? s.minl : x == 3 ? s.maxl : s.f;
}

__device__ __forceinline__ K19St k19_shfl_down(const K19St& x, int off) {
  K19St r;
  r.kept = __shfl_down_sync(0xffffffffu, x.kept, off);
  r.last = __shfl_down_sync(0xffffffffu, x.last, off);
  r.minl = __shfl_down_sync(0xffffffffu, x.minl, off);
  r.maxl = __shfl_down_sync(0xffffffffu, x.maxl, off);
  r.f = __shfl_down_sync(0xffffffffu, x.f, off);
  return r;
}

// The fold of a warp's states in lane order, in lane 0.
__device__ __forceinline__ K19St k19_warp_fold(K19St x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const K19St y = k19_shfl_down(x, off);
    if (lane + off < 32) x = k19_comb(x, y);
  }
  return x;
}

// Lane `src`'s state, to every lane of the warp.
__device__ __forceinline__ K19St k19_shfl(const K19St& x, int src) {
  K19St r;
  r.kept = __shfl_sync(0xffffffffu, x.kept, src);
  r.last = __shfl_sync(0xffffffffu, x.last, src);
  r.minl = __shfl_sync(0xffffffffu, x.minl, src);
  r.maxl = __shfl_sync(0xffffffffu, x.maxl, src);
  r.f = __shfl_sync(0xffffffffu, x.f, src);
  return r;
}

__device__ __forceinline__ i64 k19_lower(const i64* a, i64 len, i64 x) {
  i64 lo = 0, hi = len;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ i64 k19_upper(const i64* a, i64 len, i64 x) {
  i64 lo = 0, hi = len;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #(a[q] < x) (upper: <= x) over a sorted run a[0, len) by one warp, 32
// probes a step. Whatever a holds, the answer lies in [0, len] and the
// span shrinks every step.
__device__ __forceinline__ i64 k19_warp_search(const i64* __restrict__ a, i64 len, i64 x,
                                              bool upper) {
  const int lane = threadIdx.x & 31;
  i64 lo = 0, hi = len;
  while (lo < hi) {
    const i64 step = (hi - lo + 31) >> 5;
    const i64 q = lo + (i64)(lane + 1) * step - 1;
    bool p = false;
    if (q < hi) {
      const i64 v = a[q];
      p = upper ? v <= x : v < x;
    }
    const int c = __popc(__ballot_sync(0xffffffffu, p));   // lanes [0, c) pass
    const i64 qc = lo + (i64)(c + 1) * step - 1;
    const i64 nlo = lo + (i64)c * step;
    hi = c < 32 && qc < hi ? qc : hi;
    lo = nlo;
  }
  return lo;
}

// Everything a call reads besides its arrays' rows, by value.
struct K19Args {
  i64 n, m, k, nb;
  const i64* h;
  const unsigned char* live;
  const i64* tomb;
  const i64* app;
  i64* order;                      // n + k
  i64* merged;                     // null, or merged_len
  i64 merged_len;
  u64 epoch;                       // this call's; a word's tag is epoch << 2 | kind
  unsigned* ticket;                // wraps to 0 by itself
  i64* meta;                       // kept rows, flags: mapped host memory
  longlong2* state;                // [nb][2][K19_W] tagged words
};

__global__ void __launch_bounds__(K19_THREADS, K19_MIN_BLOCKS)
k19_merge(const __grid_constant__ K19Args a) {
  extern __shared__ i64 k19_smem[];
  i64* s_tomb = k19_smem;                // [K19_SLICE]
  i64* s_app = s_tomb + K19_SLICE;       // [K19_SLICE]
  i64* s_kh = s_app + K19_SLICE;         // [K19_TILE] the tile's kept handles by rank
  short* s_kr = (short*)(s_kh + K19_TILE);   // [K19_TILE] and their rows in the tile
  __shared__ K19St s_warp[K19_WARPS];
  __shared__ i64 s_wk[K19_WARPS];        // a warp's kept rows, then those before it
  __shared__ i64 s_wl[K19_WARPS];        // a warp's last kept handle
  __shared__ i64 s_cut[4];               // tombstones [0], [1]; appended [2], [3]
  __shared__ K19St s_span, s_agg, s_ex;
  __shared__ int s_hp[K19_WARPS];
  __shared__ i64 s_tile;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = (i64)atomicInc(a.ticket, (unsigned)(a.nb - 1));
  __syncthreads();
  const i64 b = s_tile;
  const i64 n = a.n;
  const i64 i0 = b * K19_TILE + (i64)t * K19_ITEMS;

  // the tile's share of the ascent checks of the tombstones and the
  // appended handles: a thread's first pair loaded before its rows, so
  // the loads are in flight together
  const i64 ct = (a.m + a.nb - 1) / a.nb, ca = (a.k + a.nb - 1) / a.nb;
  const i64 te = (b + 1) * ct < a.m ? (b + 1) * ct : a.m;
  const i64 ae = (b + 1) * ca < a.k ? (b + 1) * ca : a.k;
  const i64 jt = b * ct + t, ja = b * ca + t;
  i64 t0v = 0, t1v = 0, a0v = 0, a1v = 0;
  if (jt < te) {
    t1v = a.tomb[jt];
    t0v = jt > 0 ? a.tomb[jt - 1] : t1v;
  }
  if (ja < ae) {
    a1v = a.app[ja];
    a0v = ja > 0 ? a.app[ja - 1] : a1v;
  }

  // the thread's rows, handles and live bytes once
  i64 hv[K19_ITEMS];
  unsigned lv = 0;                       // bit j: row i0 + j is live
  if (i0 + K19_ITEMS <= n && ((size_t)(a.h + i0) & 15) == 0) {
    const longlong2* q = (const longlong2*)(a.h + i0);
#pragma unroll
    for (int j = 0; j < K19_ITEMS / 2; ++j) {
      const longlong2 w = __ldg(q + j);
      hv[2 * j] = w.x;
      hv[2 * j + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K19_ITEMS; ++j) hv[j] = i0 + j < n ? __ldg(a.h + i0 + j) : 0;
  }
  if (i0 + K19_ITEMS <= n && ((size_t)(a.live + i0) & 7) == 0) {
#pragma unroll
    for (int x = 0; x < K19_ITEMS / 8; ++x) {
      const u64 w = __ldg((const u64*)(a.live + i0) + x);
#pragma unroll
      for (int j = 0; j < 8; ++j) lv |= (unsigned)(((w >> (8 * j)) & 0xffull) != 0) << (8 * x + j);
    }
  } else {
#pragma unroll
    for (int j = 0; j < K19_ITEMS; ++j)
      if (i0 + j < n && __ldg(a.live + i0 + j)) lv |= 1u << j;
  }
  K19St mine = k19_ident();
  if (jt < te && t0v > t1v) mine.f |= K19_BAD_TOMB;
  if (ja < ae && a0v > a1v) mine.f |= K19_BAD_APP;
  if (ja < ae && a1v == K19_I64_MAX) mine.f |= K19_BAD_SENTINEL;
  for (i64 j = jt + K19_THREADS; j < te; j += K19_THREADS)   // past one a thread
    if (a.tomb[j - 1] > a.tomb[j]) mine.f |= K19_BAD_TOMB;
  for (i64 j = ja + K19_THREADS; j < ae; j += K19_THREADS) {
    if (a.app[j - 1] > a.app[j]) mine.f |= K19_BAD_APP;
    if (a.app[j] == K19_I64_MAX) mine.f |= K19_BAD_SENTINEL;
  }
#pragma unroll
  for (int j = 0; j < K19_ITEMS; ++j) {
    if (!((lv >> j) & 1u)) continue;
    const i64 x = hv[j];
    if (mine.f & K19_LIVE) {
      if (x <= mine.maxl) mine.f |= K19_BAD_BASE;
      mine.minl = x < mine.minl ? x : mine.minl;
      mine.maxl = x > mine.maxl ? x : mine.maxl;
    } else {
      mine.minl = mine.maxl = x;
    }
    mine.f |= K19_LIVE;
    if (x == K19_I64_MAX) mine.f |= K19_BAD_SENTINEL;
  }

  // the tile's live range (each warp's fold, then the warps' in each of
  // four warps), searched once into the tombstones and the appended
  // handles (a warp a search), and those slices staged
  mine = k19_warp_fold(mine);
  if (lane == 0) s_warp[warp] = mine;
  __syncthreads();
  if (warp < 4) {
    K19St sp = k19_warp_fold(lane < K19_WARPS ? s_warp[lane] : k19_ident());
    sp = k19_shfl(sp, 0);
    i64 r = 0;
    if (sp.f & K19_LIVE) {
      const bool upper = warp & 1;
      r = k19_warp_search(warp < 2 ? a.tomb : a.app, warp < 2 ? a.m : a.k,
                          upper ? sp.maxl : sp.minl, upper);
    }
    if (lane == 0) {
      s_cut[warp] = r;
      if (warp == 0) s_span = sp;
    }
  }
  __syncthreads();
  const i64 t0 = s_cut[0], a0 = s_cut[2];
  const i64 tl = s_cut[1] > t0 ? s_cut[1] - t0 : 0;
  const i64 al = s_cut[3] > a0 ? s_cut[3] - a0 : 0;
  const i64* T = a.tomb + t0;
  const i64* A = a.app + a0;
  if (tl <= K19_SLICE) {
    for (i64 j = t; j < tl; j += K19_THREADS) s_tomb[j] = T[j];
    T = s_tomb;
  }
  if (al <= K19_SLICE) {
    for (i64 j = t; j < al; j += K19_THREADS) s_app[j] = A[j];
    A = s_app;
  }
  __syncthreads();

  // keep flags; the kept rows' ranks (a warp's scan, then the warps' in
  // warp 0, which also publishes the tile's aggregate: the live range's
  // fold, the kept rows, and U from the last kept handle)
  unsigned kp = 0;
  int nk = 0;
  i64 lk = 0;                            // the thread's last kept handle
  {
    // the thread's live handles ascend: one search for the first, then a
    // walk (a broken order is flagged; the walk stays inside the slice)
    i64 p = -1;
#pragma unroll
    for (int j = 0; j < K19_ITEMS; ++j) {
      if (!((lv >> j) & 1u)) continue;
      if (p < 0) p = k19_lower(T, tl, hv[j]);
      while (p < tl && T[p] < hv[j]) ++p;
      if (p < tl && T[p] == hv[j]) continue;
      kp |= 1u << j;
      ++nk;
      lk = hv[j];
    }
  }
  int inc = nk;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  {
    const unsigned km = __ballot_sync(0xffffffffu, nk > 0);
    const i64 wl = __shfl_sync(0xffffffffu, lk, km ? 31 - __clz((int)km) : 0);
    if (lane == 31) {
      s_wk[warp] = inc;
      s_wl[warp] = wl;
    }
  }
  const i64 tag = (i64)(a.epoch << 2);
  longlong2* rec = a.state + (size_t)b * 2 * K19_W;
  __syncthreads();
  if (warp == 0) {
    const i64 c = lane < K19_WARPS ? s_wk[lane] : 0;
    i64 x = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const i64 y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane < K19_WARPS) s_wk[lane] = x - c;
    const unsigned wm = __ballot_sync(0xffffffffu, c > 0);
    K19St g = s_span;
    g.kept = __shfl_sync(0xffffffffu, x, 31);
    if (wm) {
      g.f |= K19_KEPT;
      g.last = a0 + k19_upper(A, al, s_wl[31 - __clz((int)wm)]);
    }
    const i64 w = k19_word(g, lane < K19_W ? lane : 0);
    put_words(rec, lane, K19_W, tag | 1, w);
    if (b == 0) put_words(rec + K19_W, lane, K19_W, tag | 2, w);
    if (lane == 0) {
      s_agg = g;
      s_ex = k19_ident();
    }
  }
  __syncthreads();                       // s_wk, s_agg, s_ex
  {
    i64 r = s_wk[warp] + inc - nk;
#pragma unroll
    for (int j = 0; j < K19_ITEMS; ++j)
      if ((kp >> j) & 1u) {
        s_kh[r] = hv[j];
        s_kr[r++] = (short)(t * K19_ITEMS + j);
      }
  }
  const K19St agg = s_agg;

  // look back with the whole block, K19_THREADS predecessors a step,
  // folding in tile order up to the nearest inclusive prefix
  for (i64 hi = b - 1; hi >= 0; hi -= K19_THREADS) {
    const i64 q = hi - (K19_THREADS - 1) + t;
    const longlong2* src = a.state + (size_t)(q >= 0 ? q : 0) * 2 * K19_W;
    longlong2 w[K19_W];
    bool has_p = false;
    if (q >= 0) {
#pragma unroll
      for (int x = 0; x < K19_W; ++x) w[x] = ld_tagged(src + x);
      has_p = ld_tagged(src + K19_W).x == (tag | 2);
    }
    const unsigned pm = __ballot_sync(0xffffffffu, has_p);
    if (lane == 0) s_hp[warp] = pm ? 32 * warp + 31 - __clz((int)pm) : -1;
    __syncthreads();
    int hp = -1;
    for (int x = 0; x < K19_WARPS; ++x) hp = s_hp[x] > hp ? s_hp[x] : hp;
    K19St y = k19_ident();
    if (q >= 0 && t >= hp) {
      // that tile's inclusive prefix, the later ones' aggregates: each
      // word waited for until it is this call's
      const bool pre = t == hp;
      const longlong2* from = pre ? src + K19_W : src;
      const i64 want = pre ? (tag | 2) : (tag | 1);
#pragma unroll
      for (int x = 0; x < K19_W; ++x) {
        if (pre) w[x] = ld_tagged(from + x);
        for (long long spins = 0; w[x].x != want; ++spins) {
          // a predecessor that never publishes is a fault: stop the
          // launch rather than wait forever
          if (spins > K19_SPIN_LIMIT) __trap();
          w[x] = ld_tagged(from + x);
        }
      }
      y.kept = w[0].y;
      y.last = w[1].y;
      y.minl = w[2].y;
      y.maxl = w[3].y;
      y.f = w[4].y;
    }
    // the step's fold in tile order: each warp's, then the warps' in warp 0
    y = k19_warp_fold(y);
    if (lane == 0) s_warp[warp] = y;
    __syncthreads();
    if (warp == 0) {
      const K19St z = k19_warp_fold(lane < K19_WARPS ? s_warp[lane] : k19_ident());
      if (lane == 0) s_ex = k19_comb(z, s_ex);
    }
    if (hp >= 0) break;
  }
  __syncthreads();                       // s_ex, s_kh
  const K19St ex = s_ex;
  const K19St inc_st = k19_comb(ex, agg);
  if (b > 0 && warp == 0)
    put_words(rec + K19_W, lane, K19_W, tag | 2, k19_word(inc_st, lane < K19_W ? lane : 0));
  if (b == a.nb - 1 && t == 0) {
    a.meta[0] = inc_st.kept;
    a.meta[1] = inc_st.f & K19_BAD;
  }

  // the kept rows, a thread every K19_THREADS ranks (so a warp's writes
  // are consecutive), then the appended rows whose gap this tile closes
  const i64 out_len = n + a.k;
  for (i64 r = t, p = -1; r < agg.kept; r += K19_THREADS) {
    // a thread's ranks ascend by handle: a search, then a walk
    const i64 x = s_kh[r];
    if (p < 0) p = k19_lower(A, al, x);
    while (p < al && A[p] < x) ++p;
    const i64 pos = ex.kept + r + a0 + p;
    if (pos < out_len) {
      a.order[pos] = b * K19_TILE + s_kr[r];
      if (a.merged != nullptr && pos < a.merged_len) a.merged[pos] = x;
    }
  }
  const i64 s0 = (ex.f & K19_KEPT) ? ex.last : 0;
  const i64 s1 = b == a.nb - 1 ? a.k : (agg.f & K19_KEPT) ? agg.last : s0;
  for (i64 j = s0 + t; j < s1; j += K19_THREADS) {
    const i64 x = a.app[j];
    const i64 pos = j + ex.kept + k19_upper(s_kh, agg.kept, x);
    if (pos < out_len) {
      a.order[pos] = n + j;
      if (a.merged != nullptr && pos < a.merged_len) a.merged[pos] = x;
    }
  }
}

extern "C" i64 delta_merge_tiles(i64 n) { return n > 0 ? (n + K19_TILE - 1) / K19_TILE : 1; }

// The workspace of a call over n base rows: the ticket (16 bytes), then
// every tile's tagged aggregate and inclusive prefix.
extern "C" i64 delta_merge_workspace_bytes(i64 n) {
  return 16 + delta_merge_tiles(n) * 2 * K19_W * 16;
}

// h: n int64 handles; live: n bytes; tomb: m int64; app: k int64.
// order: n + k int64, of which the first n_kept + k are written; merged:
// null, or merged_len int64 of which the positions below n_kept + k are
// written. ws: delta_merge_workspace_bytes(n) bytes zeroed when made and
// reused (epoch above every earlier call's on it). meta_host: 2 int64 of
// page-locked host memory, mapped into the card's address space (as
// cudaHostAlloc's is), where the launch's last tile writes (kept rows,
// flags); read them once the stream has passed the launch.
extern "C" int delta_merge_launch(i64 n, const i64* h, const unsigned char* live,
                                  const i64* tomb, i64 m, const i64* app, i64 k, i64* order,
                                  i64* merged, i64 merged_len, void* ws, u64 epoch,
                                  i64* meta_host, void* stream) {
  if (n < 0 || m < 0 || k < 0 || merged_len < 0) return -1;
  const i64 nb = delta_merge_tiles(n);
  if (nb > 0x7fffffff || epoch == 0 || epoch >= (1ull << 62)) return -1;
  K19Args a;
  memset(&a, 0, sizeof(a));
  a.n = n;
  a.m = m;
  a.k = k;
  a.nb = nb;
  a.h = h;
  a.live = live;
  a.tomb = tomb;
  a.app = app;
  a.order = order;
  a.merged = merged;
  a.merged_len = merged != nullptr ? merged_len : 0;
  a.epoch = epoch;
  a.ticket = (unsigned*)ws;
  a.state = (longlong2*)((char*)ws + 16);
  cudaError_t e = cudaHostGetDevicePointer((void**)&a.meta, meta_host, 0);
  if (e != cudaSuccess) return (int)e;
  // the shared-memory opt-in, once per process and device
  static bool ready[64];
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(k19_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, K19_SMEM);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  k19_merge<<<(unsigned)nb, K19_THREADS, K19_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
