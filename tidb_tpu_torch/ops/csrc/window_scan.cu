// K18 window_scan: ranking and default-frame window figures over rows
// already in window order.
//
// Replaces tidb_tpu/ops/kernels.py:2222 window_scan (searchsorted
// partition starts, peer starts and frame ends over the bucket-padded
// planes; ROW_NUMBER / RANK / DENSE_RANK by position; SUM and COUNT as
// int64 cumsum differences read at the frame end; MIN / MAX as a
// segmented associative scan with I64_MAX / I64_MIN sentinels). The frame
// is MySQL's default with ORDER BY: RANGE UNBOUNDED PRECEDING .. the
// current row's last peer.
//
// seg (partition codes) and peer (global peer-group ids) are sorted and a
// new partition always opens a new peer group, so every figure is a
// prefix scan. All of a call's figures are one single-pass scan with
// decoupled look-back (Merrill and Garland; CUB's single-pass scan):
//   - a tile is K18_TILE consecutive rows, K18_ITEMS a thread; tiles take
//     their ids from an integer ticket in launch order, so a tile's
//     look-back only ever waits on tiles that have started;
//   - a tile reads seg and peer once, and each reduction's values and
//     flags once (staged in shared memory as the reduction's operand);
//   - the scan state, all integers: the last partition start's index and
//     that row's peer id (ROW_NUMBER, DENSE_RANK), the last peer start's
//     index (RANK), and each reduction's run since the last partition
//     start: uint64 for SUM / COUNT (the reference's cumsum difference
//     wraps modulo 2^64; unsigned wrap gives the same bits), signed with
//     the I64_MAX / I64_MIN sentinels for MIN / MAX;
//   - a tile folds its rows with warp scans and one barrier, publishes
//     its aggregate, then the whole block looks back over K18_THREADS
//     predecessors a step, folding in tile order up to the nearest tile
//     that has its inclusive prefix or in which a partition starts (its
//     aggregate is then that prefix: the state is segmented), then
//     publishes its own inclusive prefix. Where partitions are shorter
//     than a tile, a tile so waits on its predecessor's aggregate alone,
//     not on a chain of prefixes; the wide step keeps any look-back to
//     one step (at 32 tiles a step, stopping at prefixes only, the
//     prefixes fell behind by two or three steps of 2-4 µs). Each
//     published word travels with a tag (the call's epoch and the kind)
//     in one 16-byte access, so no fence orders a status after the
//     words, and a word left by an earlier call reads as "not yet": no
//     reset launch.
// A row's SUM / COUNT / MIN / MAX figure is the run at its peer group's
// last row. Inside a tile that row's run is in shared memory. A peer
// group that runs past its tile (at most the tile's last group) is left
// to a second, small launch (k18_patch): the tile holding the group's end
// publishes the run there (endv), each tile the first row of its
// continuing group (trail), and the patch copies the one value into
// those rows. A look-ahead wait in the scan itself would be a forward
// dependency: once every resident block waited on a tile not yet
// scheduled, the launch would deadlock.
//
// So a call is one launch (ranking figures only) or two (with a frame
// figure); the ticket wraps back to 0 by itself (atomicInc) and the tagged
// words need no reset. No s, p, e or run plane is written to device
// memory: each output plane is written once, per tile scratch is a few
// words. Integers only, so every run gives the same bits.
//
// Bound by bytes: seg and peer read once, per reduction its values and
// contributing flags once, one int64 plane written per figure.
#include <cstring>

#include "lookback.cuh"

#define K18_THREADS 256
#define K18_WARPS (K18_THREADS / 32)
#define K18_ITEMS 8
#define K18_TILE (K18_THREADS * K18_ITEMS)
// shared-memory row slot: one pad word per K18_ITEMS, so a thread's
// consecutive rows fall in different banks
#define K18_PAD(j) ((j) + ((j) >> 3))
#define K18_TILE_WORDS (K18_TILE + K18_TILE / K18_ITEMS)
#define K18_MAX_SPECS 16
#define K18_MAX_RED 4
#define K18_HDR 3            // state words before the runs
#define K18_PATCH_THREADS 256
#define K18_NONE K18_TILE    // no group end at or after a row in its tile
#define K18_SPIN_LIMIT (1ll << 26)   // look-back reads of one word before a fault
#define K18_I64_MAX 0x7fffffffffffffffll
#define K18_I64_MIN (-K18_I64_MAX - 1)

// reductions and figures: the contract with ops/kernels.py
enum K18Red { W_COUNT = 0, W_SUM = 1, W_MIN = 2, W_MAX = 3 };
enum K18Fig { W_ROW_NUMBER = 0, W_RANK = 1, W_DENSE_RANK = 2, W_FRAME = 3 };

struct K18RedArg {
  i64 op;
  const i64* vals;                 // null for COUNT
  const unsigned char* contrib;
};

struct K18FigArg {
  i64 kind;                        // K18Fig
  i64 red;                         // W_FRAME: the reduction it reads
  i64* out;
};

// Everything a call reads besides its planes' rows, by value.
struct K18Args {
  i64 n, nb;
  const i64* seg;
  const i64* peer;
  int n_red, n_fig, has_frame, has_dense;
  u64 epoch;                       // this call's; a word's tag is epoch << 2 | kind
  unsigned* ticket;                // wraps to 0 by itself
  longlong2* state;                // [nb][2][K18_HDR + n_red] tagged words
  i64* endv;                       // [nb][n_red]: run at the tile's first group end
  int* trail;                      // [nb]: first row of the group past the tile, or -1
  K18RedArg red[K18_MAX_RED];
  K18FigArg fig[K18_MAX_SPECS];
};

// The header of a scan state: last partition start (-1: none in the
// span), that row's peer id, last peer start (-1: none).
struct Hdr {
  i64 ps, pp, gs;
};

__device__ __forceinline__ Hdr hdr_ident() {
  Hdr h = {-1, 0, -1};
  return h;
}

// a before b
__device__ __forceinline__ Hdr hdr_comb(Hdr a, Hdr b) {
  const bool s = b.ps >= 0;
  Hdr r;
  r.ps = s ? b.ps : a.ps;
  r.pp = s ? b.pp : a.pp;
  r.gs = b.gs > a.gs ? b.gs : a.gs;
  return r;
}

__device__ __forceinline__ u64 red_ident(int op) {
  return op == W_MIN ? (u64)K18_I64_MAX : op == W_MAX ? (u64)K18_I64_MIN : 0ull;
}

__device__ __forceinline__ u64 red_op(int op, u64 a, u64 b) {
  switch (op) {
    case W_MIN: return (i64)b < (i64)a ? b : a;
    case W_MAX: return (i64)b > (i64)a ? b : a;
    default: return a + b;
  }
}

// a before b, where a partition starts in b when bf
__device__ __forceinline__ u64 red_comb(int op, u64 a, u64 b, bool bf) {
  return bf ? b : red_op(op, a, b);
}

__device__ __forceinline__ Hdr hdr_shfl_up(Hdr x, int off) {
  Hdr r;
  r.ps = __shfl_up_sync(0xffffffffu, x.ps, off);
  r.pp = __shfl_up_sync(0xffffffffu, x.pp, off);
  r.gs = __shfl_up_sync(0xffffffffu, x.gs, off);
  return r;
}

// Inclusive warp scan of headers in lane order.
__device__ __forceinline__ Hdr hdr_warp_incl(Hdr x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Hdr y = hdr_shfl_up(x, off);
    if (lane >= off) x = hdr_comb(y, x);
  }
  return x;
}

// Inclusive warp scan of (run, partition started) pairs in lane order.
__device__ __forceinline__ u64 red_warp_incl(int op, u64 v, bool f) {
  const int lane = threadIdx.x & 31;
  int fi = f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u64 y = __shfl_up_sync(0xffffffffu, v, off);
    const int yf = __shfl_up_sync(0xffffffffu, fi, off);
    if (lane >= off) {
      v = red_comb(op, y, v, fi);
      fi |= yf;
    }
  }
  return v;
}

// Rows [i0, i0 + K18_ITEMS) of an int64 plane, 16-byte loads where the
// rows are whole and aligned.
__device__ __forceinline__ void load_rows(const i64* __restrict__ p, i64 i0, i64 n,
                                          i64 (&v)[K18_ITEMS]) {
  if (i0 + K18_ITEMS <= n && ((size_t)(p + i0) & 15) == 0) {
    const longlong2* q = (const longlong2*)(p + i0);
#pragma unroll
    for (int k = 0; k < K18_ITEMS / 2; ++k) {
      const longlong2 w = __ldg(q + k);
      v[2 * k] = w.x;
      v[2 * k + 1] = w.y;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < K18_ITEMS; ++k) v[k] = i0 + k < n ? __ldg(p + i0 + k) : 0;
}

// An 8-byte copy from device to shared memory that the thread does not
// wait for (cp.async): a tile's reductions are all in flight at once.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [i0, i0 + K18_ITEMS) of an int64 output plane.
__device__ __forceinline__ void store_rows(i64* __restrict__ p, i64 i0, i64 n,
                                           const i64 (&v)[K18_ITEMS], unsigned skip) {
  if (skip == 0u && i0 + K18_ITEMS <= n && ((size_t)(p + i0) & 15) == 0) {
    longlong2* q = (longlong2*)(p + i0);
#pragma unroll
    for (int k = 0; k < K18_ITEMS / 2; ++k) q[k] = make_longlong2(v[2 * k], v[2 * k + 1]);
    return;
  }
#pragma unroll
  for (int k = 0; k < K18_ITEMS; ++k)
    if (i0 + k < n && !((skip >> k) & 1u)) p[i0 + k] = v[k];
}

// A tile's published state: K18_HDR + n_red words, each a tagged record
// (lookback.cuh; tag = epoch << 2 | 1 for the aggregate, | 2 for the
// inclusive prefix).

// Three blocks an SM: the scan is bound by each tile's latency, not by
// the card's rates (two an SM, as 128 registers a thread allow, read
// 5-10 % slower at SF1; the few bytes the cap spills cost less).
__global__ void __launch_bounds__(K18_THREADS, 3)
k18_scan(const __grid_constant__ K18Args a) {
  extern __shared__ u64 k18_smem[];
  u64* xs = k18_smem;                                  // [n_red][K18_TILE_WORDS]
  u64* cf = xs + (size_t)a.n_red * K18_TILE_WORDS;     // [n_red][K18_THREADS]
  u64* pvs = cf + (size_t)a.n_red * K18_THREADS;       // [K18_TILE_WORDS] with DENSE_RANK
  __shared__ Hdr s_whdr[K18_WARPS];
  __shared__ u64 s_wv[K18_MAX_RED][K18_WARPS];
  __shared__ int s_wf[K18_WARPS];
  __shared__ int s_wmin[K18_WARPS];
  __shared__ i64 s_agg[K18_HDR + K18_MAX_RED];          // the tile's aggregate
  __shared__ u64 s_exv[K18_MAX_RED];                    // runs before the tile
  __shared__ Hdr s_exh;                                 // header before the tile
  __shared__ i64 s_tile;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = (i64)atomicInc(a.ticket, (unsigned)(a.nb - 1));
  __syncthreads();
  const i64 b = s_tile;
  const i64 base = b * K18_TILE;
  const int j0 = t * K18_ITEMS;
  const i64 i0 = base + j0;
  const i64 n = a.n;
  const int nr = a.n_red;
  const int W = K18_HDR + nr;

  // each reduction's values and flags once, every copy in flight before
  // the first is waited for: the values into their tile slots, a thread's
  // K18_ITEMS flag bytes into one word
  const bool whole = i0 + K18_ITEMS <= n;
  for (int r = 0; r < nr; ++r) {
    u64* xr = xs + (size_t)r * K18_TILE_WORDS;
    const i64* vals = a.red[r].vals;
    const unsigned char* c = a.red[r].contrib;
    if (whole) {
      if (a.red[r].op != W_COUNT)
#pragma unroll
        for (int k = 0; k < K18_ITEMS; ++k) cp_async8(xr + K18_PAD(j0 + k), vals + i0 + k);
      if (((size_t)(c + i0) & 7) == 0) {
        cp_async8(cf + (size_t)r * K18_THREADS + t, c + i0);
        continue;
      }
    } else if (a.red[r].op != W_COUNT) {
      for (int k = 0; k < K18_ITEMS; ++k)
        if (i0 + k < n) xr[K18_PAD(j0 + k)] = (u64)__ldg(vals + i0 + k);
    }
    u64 fw = 0;
    for (int k = 0; k < K18_ITEMS; ++k)
      if (i0 + k < n) fw |= (u64)__ldg(c + i0 + k) << (8 * k);
    cf[(size_t)r * K18_THREADS + t] = fw;
  }

  // seg and peer once: partition starts, peer starts, group ends
  unsigned pbits = 0, gbits = 0, ebits = 0;
  Hdr th = hdr_ident();
  {
    i64 sv[K18_ITEMS], pv[K18_ITEMS];
    load_rows(a.seg, i0, n, sv);
    load_rows(a.peer, i0, n, pv);
    const i64 seg_prev = i0 > 0 && i0 <= n ? __ldg(a.seg + i0 - 1) : 0;
    const i64 peer_prev = i0 > 0 && i0 <= n ? __ldg(a.peer + i0 - 1) : 0;
    const i64 peer_next = i0 + K18_ITEMS < n ? __ldg(a.peer + i0 + K18_ITEMS) : 0;
#pragma unroll
    for (int k = 0; k < K18_ITEMS; ++k) {
      const i64 i = i0 + k;
      if (i >= n) break;
      const bool ps = i == 0 || sv[k] != (k ? sv[k - 1] : seg_prev);
      const bool gs = i == 0 || pv[k] != (k ? pv[k - 1] : peer_prev);
      const bool ge = i == n - 1 || pv[k] != (k + 1 < K18_ITEMS ? pv[k + 1] : peer_next);
      pbits |= (unsigned)ps << k;
      gbits |= (unsigned)gs << k;
      ebits |= (unsigned)ge << k;
      if (ps) {
        th.ps = i;
        th.pp = pv[k];
      }
      if (gs) th.gs = i;
    }
    if (a.has_dense)
#pragma unroll
      for (int k = 0; k < K18_ITEMS; ++k) pvs[K18_PAD(j0 + k)] = (u64)pv[k];
  }
  const bool tf = pbits != 0u;
  cp_async_wait_all();

  // each reduction's operand in its slot and the thread's run; the warps'
  // scans of the header, the runs and the first group end after each
  // thread, then one barrier for all of them
  u64* tpre = cf;                     // a thread's run before it, in its flag word's slot
  const unsigned fb = __ballot_sync(0xffffffffu, tf);
  const bool lane_f = (fb & ((1u << lane) - 1u)) != 0u;   // a start earlier in the warp
#pragma unroll
  for (int r = 0; r < K18_MAX_RED; ++r) {
    if (r >= nr) break;
    const int op = (int)a.red[r].op;
    const u64 id = red_ident(op);
    u64* xr = xs + (size_t)r * K18_TILE_WORDS;
    const u64 fw = cf[(size_t)r * K18_THREADS + t];
    u64 v = id;
#pragma unroll
    for (int k = 0; k < K18_ITEMS; ++k) {
      u64 y = id;
      if (i0 + k < n && ((fw >> (8 * k)) & 0xffull)) y = op == W_COUNT ? 1ull : xr[K18_PAD(j0 + k)];
      xr[K18_PAD(j0 + k)] = y;
      v = red_comb(op, v, y, (pbits >> k) & 1u);
    }
    const u64 inc = red_warp_incl(op, v, tf);
    u64 ex = __shfl_up_sync(0xffffffffu, inc, 1);
    tpre[(size_t)r * K18_THREADS + t] = lane ? ex : id;
    if (lane == 31) s_wv[r][warp] = inc;
  }
  const Hdr hinc = hdr_warp_incl(th);
  Hdr hex = hdr_shfl_up(hinc, 1);
  if (lane == 0) hex = hdr_ident();
  int emin = ebits ? j0 + __ffs((int)ebits) - 1 : K18_NONE;
  int eafter;                               // the first group end after this thread's rows
  {
    int inc = emin;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, inc, off);
      if (lane + off < 32) inc = y < inc ? y : inc;
    }
    eafter = __shfl_down_sync(0xffffffffu, inc, 1);
    if (lane == 31) eafter = K18_NONE;
    if (lane == 0) s_wmin[warp] = inc;
  }
  if (lane == 31) {
    s_whdr[warp] = hinc;
    s_wf[warp] = fb != 0u;
  }
  __syncthreads();
  {
    Hdr before = hdr_ident(), tot = hdr_ident();
    for (int w = 0; w < K18_WARPS; ++w) {
      if (w == warp) before = tot;
      tot = hdr_comb(tot, s_whdr[w]);
    }
    hex = hdr_comb(before, hex);
    if (t == 0) {
      s_agg[0] = tot.ps;
      s_agg[1] = tot.pp;
      s_agg[2] = tot.gs;
    }
    for (int w = warp + 1; w < K18_WARPS; ++w) eafter = s_wmin[w] < eafter ? s_wmin[w] : eafter;
  }
#pragma unroll
  for (int r = 0; r < K18_MAX_RED; ++r) {
    if (r >= nr) break;
    const int op = (int)a.red[r].op;
    u64 before = red_ident(op), tot = red_ident(op);
    for (int w = 0; w < K18_WARPS; ++w) {
      if (w == warp) before = tot;
      tot = red_comb(op, tot, s_wv[r][w], s_wf[w]);
    }
    u64* tp = tpre + (size_t)r * K18_THREADS + t;
    *tp = red_comb(op, before, *tp, lane_f);
    if (t == 0) s_agg[K18_HDR + r] = (i64)tot;
  }

  // publish the aggregate (tile 0: also as its inclusive prefix), then
  // look back with the whole block, K18_THREADS predecessors a step,
  // folding in tile order up to the nearest inclusive prefix
  const i64 tag = (i64)(a.epoch << 2);
  longlong2* mine = a.state + (size_t)b * 2 * W;
  __syncthreads();                       // s_agg
  if (warp == 0) {
    put_words(mine, lane, W, tag | 1, s_agg[lane < W ? lane : 0]);
    if (b == 0) put_words(mine + W, lane, W, tag | 2, s_agg[lane < W ? lane : 0]);
  }
  if (t < nr) s_exv[t] = red_ident((int)a.red[t].op);
  if (t == 0) s_exh = hdr_ident();
  for (i64 hi = b - 1; hi >= 0; hi -= K18_THREADS) {
    // thread t looks at tile hi - K18_THREADS + 1 + t: its aggregate's
    // words and its inclusive prefix's first word, all read at once
    const i64 q = hi - (K18_THREADS - 1) + t;
    const longlong2* rec = a.state + (size_t)(q >= 0 ? q : 0) * 2 * W;
    longlong2 w8[K18_HDR + K18_MAX_RED];
    bool has_p = q < 0;                  // before tile 0: the identity, as a prefix
    bool term = q < 0;
    if (q >= 0) {
#pragma unroll
      for (int x = 0; x < K18_HDR + K18_MAX_RED; ++x)
        if (x < W) w8[x] = ld_tagged(rec + x);
      has_p = ld_tagged(rec + W).x == (tag | 2);
      // a tile in which a partition starts ends the search as its
      // inclusive prefix would: its aggregate is that prefix (the runs
      // restart, the last starts are its own)
      term = has_p || (w8[0].x == (tag | 1) && w8[0].y >= 0);
    }
    // the nearest tile that ends the search: the block's highest t
    const unsigned pm = __ballot_sync(0xffffffffu, term);
    if (lane == 0) s_wmin[warp] = pm ? 32 * warp + 31 - __clz((int)pm) : -1;
    __syncthreads();
    int hp = -1;
    for (int w = 0; w < K18_WARPS; ++w) hp = s_wmin[w] > hp ? s_wmin[w] : hp;
    const bool use = q >= 0 && t >= hp;
    if (use) {
      // that tile's inclusive prefix (or its aggregate, where a partition
      // starts in it), the later ones' aggregates: each word waited for
      // until it is this call's
      const bool pre = t == hp && has_p;
      const longlong2* src = pre ? rec + W : rec;
      const i64 want = pre ? (tag | 2) : (tag | 1);
#pragma unroll
      for (int x = 0; x < K18_HDR + K18_MAX_RED; ++x) {
        if (x >= W) break;
        if (pre) w8[x] = ld_tagged(src + x);
        for (long long spins = 0; w8[x].x != want; ++spins) {
          // a predecessor that never publishes is a fault: stop the
          // launch rather than wait forever
          if (spins > K18_SPIN_LIMIT) __trap();
          w8[x] = ld_tagged(src + x);
        }
      }
    }
    // the step's fold in tile order, every field side by side: lane l
    // takes in lane l + off's span (later tiles), so lane 0 ends with its
    // warp's; then the warps in order
    i64 ps = use ? w8[0].y : -1, pp = use ? w8[1].y : 0, gs = use ? w8[2].y : -1;
    u64 v[K18_MAX_RED];
#pragma unroll
    for (int r = 0; r < K18_MAX_RED; ++r)
      v[r] = r < nr ? (use ? (u64)w8[K18_HDR + r].y : red_ident((int)a.red[r].op)) : 0ull;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const i64 yps = __shfl_down_sync(0xffffffffu, ps, off);
      const i64 ypp = __shfl_down_sync(0xffffffffu, pp, off);
      const i64 ygs = __shfl_down_sync(0xffffffffu, gs, off);
      u64 yv[K18_MAX_RED];
#pragma unroll
      for (int r = 0; r < K18_MAX_RED; ++r) yv[r] = __shfl_down_sync(0xffffffffu, v[r], off);
      if (lane + off < 32) {
        const bool bs = yps >= 0;
#pragma unroll
        for (int r = 0; r < K18_MAX_RED; ++r)
          if (r < nr) v[r] = red_comb((int)a.red[r].op, v[r], yv[r], bs);
        ps = bs ? yps : ps;
        pp = bs ? ypp : pp;
        gs = ygs > gs ? ygs : gs;
      }
    }
    if (lane == 0) {
      s_whdr[warp].ps = ps;
      s_whdr[warp].pp = pp;
      s_whdr[warp].gs = gs;
#pragma unroll
      for (int r = 0; r < K18_MAX_RED; ++r)
        if (r < nr) s_wv[r][warp] = v[r];
    }
    __syncthreads();
    if (t == 0) {
      // the warps' folds in order, then the steps after this one
      Hdr wh = hdr_ident();
      u64 wv[K18_MAX_RED];
#pragma unroll
      for (int r = 0; r < K18_MAX_RED; ++r) wv[r] = r < nr ? red_ident((int)a.red[r].op) : 0ull;
      for (int w = 0; w < K18_WARPS; ++w) {
        const Hdr x = s_whdr[w];
        const bool bs = x.ps >= 0;
#pragma unroll
        for (int r = 0; r < K18_MAX_RED; ++r)
          if (r < nr) wv[r] = red_comb((int)a.red[r].op, wv[r], s_wv[r][w], bs);
        wh = hdr_comb(wh, x);
      }
      const Hdr eh = s_exh;
#pragma unroll
      for (int r = 0; r < K18_MAX_RED; ++r)
        if (r < nr) s_exv[r] = red_comb((int)a.red[r].op, wv[r], s_exv[r], eh.ps >= 0);
      s_exh = hdr_comb(wh, eh);
    }
    __syncthreads();
    if (hp >= 0) break;
  }
  if (b > 0 && warp == 0) {
    // the inclusive prefix: the tiles before, then this one
    const Hdr eh = s_exh;
    const bool af = s_agg[0] >= 0;
    i64 w = 0;
    if (lane == 0) w = af ? s_agg[0] : eh.ps;
    else if (lane == 1) w = af ? s_agg[1] : eh.pp;
    else if (lane == 2) w = s_agg[2] > eh.gs ? s_agg[2] : eh.gs;
    else if (lane < W)
      w = (i64)red_comb((int)a.red[lane - K18_HDR].op, s_exv[lane - K18_HDR],
                        (u64)s_agg[lane], af);
    put_words(mine + W, lane, W, tag | 2, w);
  }
  __syncthreads();

  // every row's runs: the tile's prefix, then the thread's, then its own
  // rows, in place of the operands
  const Hdr hin = hdr_comb(s_exh, hex);
  const bool pre_f = hex.ps >= 0;     // a partition starts earlier in the tile
#pragma unroll
  for (int r = 0; r < K18_MAX_RED; ++r) {
    if (r >= nr) break;
    const int op = (int)a.red[r].op;
    u64* xr = xs + (size_t)r * K18_TILE_WORDS;
    u64 v = red_comb(op, s_exv[r], tpre[(size_t)r * K18_THREADS + t], pre_f);
#pragma unroll
    for (int k = 0; k < K18_ITEMS; ++k) {
      v = red_comb(op, v, xr[K18_PAD(j0 + k)], (pbits >> k) & 1u);
      xr[K18_PAD(j0 + k)] = v;
    }
  }
  // each row's frame end in the tile (K18_NONE: its group runs past it)
  int el[K18_ITEMS];
  {
    int nxt = eafter;
#pragma unroll
    for (int k = K18_ITEMS - 1; k >= 0; --k) {
      if ((ebits >> k) & 1u) nxt = j0 + k;
      el[k] = nxt;
    }
  }
  unsigned trail_rows = 0;            // rows left to the patch
#pragma unroll
  for (int k = 0; k < K18_ITEMS; ++k) trail_rows |= (unsigned)(el[k] == K18_NONE) << k;
  if (t == K18_THREADS - 1) {
    Hdr h = hin;
    for (int k = 0; k < K18_ITEMS; ++k)
      if ((gbits >> k) & 1u) h.gs = i0 + k;
    a.trail[b] = (i0 + K18_ITEMS - 1 < n && !((ebits >> (K18_ITEMS - 1)) & 1u))
                     ? (int)(h.gs > base ? h.gs - base : 0) : -1;
  }
  __syncthreads();
  // the tile's first group end: thread 0's first row's
  const int e0 = __shfl_sync(0xffffffffu, el[0], 0);
  if (a.has_frame && t < nr && e0 != K18_NONE)
    a.endv[(size_t)b * nr + t] = (i64)xs[(size_t)t * K18_TILE_WORDS + K18_PAD(e0)];

  for (int f = 0; f < a.n_fig; ++f) {
    const int kind = (int)a.fig[f].kind;
    i64 o[K18_ITEMS];
    if (kind == W_FRAME) {
      const u64* xr = xs + (size_t)a.fig[f].red * K18_TILE_WORDS;
#pragma unroll
      for (int k = 0; k < K18_ITEMS; ++k)
        o[k] = el[k] == K18_NONE ? 0 : (i64)xr[K18_PAD(el[k])];
      store_rows(a.fig[f].out, i0, n, o, trail_rows);
      continue;
    }
    Hdr h = hin;
    if (kind == W_DENSE_RANK) {
#pragma unroll
      for (int k = 0; k < K18_ITEMS; ++k) {
        const i64 pk = (i64)pvs[K18_PAD(j0 + k)];
        if ((pbits >> k) & 1u) h.pp = pk;
        o[k] = pk - h.pp + 1;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K18_ITEMS; ++k) {
        const i64 i = i0 + k;
        if ((pbits >> k) & 1u) h.ps = i;
        if ((gbits >> k) & 1u) h.gs = i;
        o[k] = kind == W_ROW_NUMBER ? i - h.ps + 1 : h.gs - h.ps + 1;
      }
    }
    store_rows(a.fig[f].out, i0, n, o, 0u);
  }
}

// The rows of each tile's trailing group (the group that runs past the
// tile): its run at the group's end, which the first later tile whose
// trail is not 0 published as its endv.
__global__ void __launch_bounds__(K18_PATCH_THREADS)
k18_patch(const __grid_constant__ K18Args a) {
  __shared__ i64 s_u;
  const int t = threadIdx.x, lane = t & 31;
  for (i64 b = blockIdx.x; b < a.nb; b += gridDim.x) {
    const int tr = a.trail[b];
    if (tr < 0) continue;              // uniform over the block
    if (t < 32) {
      i64 u = -1;
      for (i64 q0 = b + 1; u < 0; q0 += 32) {
        const i64 q = q0 + lane;
        const unsigned m = __ballot_sync(0xffffffffu, q >= a.nb || a.trail[q] != 0);
        if (m) u = q0 + __ffs((int)m) - 1;
      }
      if (lane == 0) s_u = u;
    }
    __syncthreads();
    const i64 u = s_u;
    const i64 base = b * K18_TILE;
    for (int f = 0; f < a.n_fig; ++f) {
      if (a.fig[f].kind != W_FRAME) continue;
      const i64 v = a.endv[(size_t)u * a.n_red + a.fig[f].red];
      for (int j = tr + t; j < K18_TILE; j += K18_PATCH_THREADS) a.fig[f].out[base + j] = v;
    }
    __syncthreads();
  }
}

static i64 window_scan_tiles(i64 n) { return (n + K18_TILE - 1) / K18_TILE; }

// Scratch bytes of a call over n rows with n_red reductions, in two
// buffers: the ticket and the tiles' tagged states (nothing else is ever
// written there, so every 16-byte slot holds a tag and its word, whatever
// the shapes of the calls before), then each tile's endv and trail.
extern "C" i64 window_scan_state_bytes(i64 n, int n_red) {
  return 16 + window_scan_tiles(n) * 32 * (K18_HDR + (i64)n_red);
}

extern "C" i64 window_scan_aux_bytes(i64 n, int n_red) {
  return window_scan_tiles(n) * (8 * (i64)n_red + 4);
}

// One call over n rows: reds (n_red of ops / values / flags) and figs
// (n_fig of kind / reduction / output) are host arrays copied into the
// launch's parameters; state holds window_scan_state_bytes(n, n_red)
// bytes (zeroed once when made; epoch above every earlier call's on it),
// aux window_scan_aux_bytes(n, n_red). Returns the launches made through
// *launches.
extern "C" int window_scan_launch(i64 n, const i64* seg, const i64* peer, int n_red,
                                  const K18RedArg* reds, int n_fig, const K18FigArg* figs,
                                  void* state, void* aux, u64 epoch, int* launches,
                                  void* stream) {
  *launches = 0;
  if (n < 1 || n_red < 0 || n_red > K18_MAX_RED || n_fig < 1 || n_fig > K18_MAX_SPECS)
    return -1;
  const i64 nb = window_scan_tiles(n);
  if (nb > 0x7fffffff || epoch == 0 || epoch >= (1ull << 62)) return -1;
  K18Args a;
  memset(&a, 0, sizeof(a));
  a.n = n;
  a.nb = nb;
  a.seg = seg;
  a.peer = peer;
  a.n_red = n_red;
  a.n_fig = n_fig;
  a.epoch = epoch;
  if (n_red > 0) memcpy(a.red, reds, sizeof(K18RedArg) * (size_t)n_red);
  memcpy(a.fig, figs, sizeof(K18FigArg) * (size_t)n_fig);
  for (int f = 0; f < n_fig; ++f) {
    if (figs[f].kind < W_ROW_NUMBER || figs[f].kind > W_FRAME || !figs[f].out) return -1;
    if (figs[f].kind == W_FRAME) {
      if (figs[f].red < 0 || figs[f].red >= n_red) return -1;
      a.has_frame = 1;
    }
    if (figs[f].kind == W_DENSE_RANK) a.has_dense = 1;
  }
  for (int r = 0; r < n_red; ++r)
    if (reds[r].op < W_COUNT || reds[r].op > W_MAX || !reds[r].contrib ||
        (reds[r].op != W_COUNT && !reds[r].vals))
      return -1;
  a.ticket = (unsigned*)state;
  a.state = (longlong2*)((char*)state + 16);
  a.endv = (i64*)aux;
  a.trail = (int*)(a.endv + nb * n_red);
  const size_t smem =
      8 * ((size_t)n_red * (K18_TILE_WORDS + K18_THREADS) + (a.has_dense ? K18_TILE_WORDS : 0));
  // the opt-in past the default 48 KB counts the static shared memory too
  // (at most about 105 KB in all)
  cudaError_t ce = cudaFuncSetAttribute(k18_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  cudaStream_t st = (cudaStream_t)stream;
  k18_scan<<<(unsigned)nb, K18_THREADS, smem, st>>>(a);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  *launches = 1;
  if (!a.has_frame) return 0;
  const i64 pb = nb < 132 * 4 ? nb : 132 * 4;
  k18_patch<<<(unsigned)pb, K18_PATCH_THREADS, 0, st>>>(a);
  ce = cudaGetLastError();
  if (ce == cudaSuccess) *launches = 2;
  return (int)ce;
}
