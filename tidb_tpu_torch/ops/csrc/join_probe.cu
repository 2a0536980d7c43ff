// K12 join_probe: the probe side of the device hash join.
//
// Replaces tidb_tpu/ops/kernels.py:1688 _join_probe_impl: per left row the
// match range [lo, hi) of its key among the sorted build words (K11),
// clamped to n_valid; an exclusive prefix sum of the match counts; and the
// expansion of output slot j into its (l, r) pair. Pairs come out in
// left-scan order, ties in right-scan order (the build's stable order).
//
// Two launches a call.
//
// Count (k12_count): whole waves of blocks take tiles of K12_TILE left rows
// from a ticket, so a tile's predecessors were taken by running blocks. A
// warp's rows are 32 x K12_ITEMS consecutive ones, lane + 32 j its j-th, so
// every load and store of a plane is coalesced (a thread's rows side by
// side cost 32 sectors a warp access). Each block first stages a sample of the build words in
// shared memory (every 2^s-th word, at most K12_SAMPLE, padded to a power
// of two: sample_search.cuh). A row's key (common.cuh key_word, as K11
// encodes it) is searched with 32-bit positions in the sample, then in the
// one slice of at most 2^s - 1 words between two sampled ones, instead of
// two searches over all the words. Before that a warp bounds its window:
// the lower bounds of its smallest valid key and of the word past its
// largest; where they lie close (a probe side in key order, as lineitem by
// l_orderkey) every key of the warp is searched in that window alone. The
// upper bound steps on from the lower bound (a foreign key matches 0 or 1
// rows) and searches past K12_STEPS equal words. A warp scan a row gives
// each row its offset in the warp, the warps' totals its offset in the
// tile; the tile's total is published as an epoch-tagged word (lookback.cuh,
// as K18 and K19) and warp 0 looks back over its predecessors' words, 32 a
// step, for the tile's offset. So each row's lo and offset are written
// once and final: no scan of the tile totals, no add-back pass, nothing
// reset between calls. The offsets at the marks (the starts of the
// caller's shards or partitions, and the grand total) go straight into
// page-locked host memory mapped into the card, which the wrapper reads
// after one stream synchronisation.
//
// Expand (k12_expand): the output is a merge of the left rows (at their
// offsets) and the output slots, rows first on ties (the load-balanced
// search of merge-path expansions). Each block takes K12_EX_NV consecutive
// items of that merge: one cooperative search a warp over the offsets finds
// where its range starts and ends, it stages the rows' offsets and lo in
// shared memory (32-bit offsets relative to the block's first slot), each
// thread walks K12_EX_ITEMS items of the merge to map its slots to rows,
// and the block writes its pairs coalesced: l (or
// lsel[l]) and r = order[lo[l] + j - offsets[l]], int32 when both sides
// are shorter than 2^31, else int64. A row with millions of matches spreads
// over as many blocks as its slots fill; a run of rows without a match
// costs one item a row.
//
// Bound by bytes: the left key and valid byte read once, the pairs
// written and order read (a gather) once a pair, the build words read from
// L2. The planes between the launches add, a left row, lo (4 B where the
// build side is under 2^31 words, else 8) and the offset (8 B), each
// written once and read once: 72 MB of Phase F's 270 MB. Recomputing a
// tile's ranges in the expand instead would read the keys and search
// again there (the count's search is about half its time), so the planes
// stay (lo as int64 would add 24 MB written and 24 MB read).
//
// The partition-segmented mode replaces the per-shard probe of
// tidb_tpu/ops/mesh.py:756 _partitioned_probe_fn (each shard's
// _join_probe_impl over its own key partition). The probe planes come in
// K21's partition-major layout (key_partition.cu) and the build words
// sorted within each partition (ops/kernels.py join_build_partitioned):
// the P + 1 partition starts loff and the build bounds are staged in
// shared memory, a thread finds its rows' partition p there and searches
// only the sample entries of p's build words [bounds[p], bounds[p + 1]).
// The marks are loff (each partition's first offset), and expand maps a
// probe position to its global row through K21's gather index.
#include "lookback.cuh"
#include "sample_search.cuh"

#define K12_THREADS 256
#define K12_ITEMS 8
#define K12_TILE (K12_THREADS * K12_ITEMS)
#define K12_SAMPLE 2048          // sampled words at most (16 KB)
#define K12_STEPS 8              // steps from the lower bound before a search
#define K12_WINDOW 3             // a warp's window: at least this many steps fewer
#define K12_MAX_PARTS 1024
#define K12_EX_THREADS 256
#define K12_EX_ITEMS 8
#define K12_EX_NV (K12_EX_THREADS * K12_EX_ITEMS)
#define K12_MIN_BLOCKS 3         // count blocks an SM the registers leave room for
#define K12_SPIN_LIMIT (1ll << 26)

struct K12Count {
  i64 nl, nv;
  const i64* lkey;
  const unsigned char* lvalid;
  const i64* words;
  const i64* loff;                 // segmented: parts + 1 probe partition starts
  const i64* bounds;               // segmented: parts + 1 build partition starts
  void* lo;                        // nl int32 (lo32) or int64
  i64* offs;                       // nl int64
  int ns, sp;                      // sampled words; staged (padded, unsegmented)
  i64 mark_stride;                 // unsegmented: mark k is k * mark_stride
  i64 ntiles;
  unsigned* ticket;                // wraps to 0 by itself
  longlong2* state;                // 2 tagged words a tile: aggregate, prefix
  i64* host;                       // mapped: the offset at each mark
  u64 epoch;
  int is_f64, parts, shift, sbits, nmarks;
};

// The exclusive offset of the tile from its predecessors' tagged words:
// warp 0, 32 predecessors a step, each lane waiting on its own tile's
// word until this call's aggregate or prefix is there.
__device__ __forceinline__ i64 k12_look_back(const K12Count& a, i64 tile, int lane) {
  const i64 tag = (i64)(a.epoch << 2);
  i64 excl = 0;
  for (i64 hi = tile - 1;; hi -= 32) {
    const i64 q = hi - lane;
    i64 v = 0;
    bool pre = false;
    if (q >= 0) {
      for (long long spins = 0;; ++spins) {
        // both words read at once: one L2 round trip an attempt
        const longlong2 g = ld_tagged(a.state + 2 * q);
        const longlong2 p = ld_tagged(a.state + 2 * q + 1);
        if (p.x == (tag | 2)) {
          v = p.y;
          pre = true;
          break;
        }
        if (g.x == (tag | 1)) {
          v = g.y;
          break;
        }
        // a predecessor that never publishes is a fault: stop the launch
        if (spins > K12_SPIN_LIMIT) __trap();
      }
    }
    const unsigned pm = __ballot_sync(0xffffffffu, pre);
    const int stop = pm ? __ffs(pm) - 1 : 31;     // the nearest prefix
    if (lane > stop) v = 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    excl += v;
    if (pm || hi < 32) return excl;
  }
}

template <bool SEG, class L>
__global__ void __launch_bounds__(K12_THREADS, K12_MIN_BLOCKS)
k12_count(const __grid_constant__ K12Count a) {
  extern __shared__ i64 k12_smem[];
  __shared__ i64 warp_tot[32];
  __shared__ i64 s_tile, s_excl;
  i64* samp = k12_smem;
  i64* s_loff = k12_smem + a.sp;
  i64* s_bounds = s_loff + a.parts + 1;
  const int t = threadIdx.x, lane = t & 31;
  stage_sample(a.words, a.shift, a.ns, a.sp, samp, WordAsIs());
  if (SEG)
    for (int k = t; k <= a.parts; k += K12_THREADS) {
      s_loff[k] = a.loff[k];
      s_bounds[k] = a.bounds[k];
    }
  const i64 tag = (i64)(a.epoch << 2);
  L* lo_out = (L*)a.lo;
  for (;;) {
    if (t == 0) s_tile = (i64)atomicInc(a.ticket, (unsigned)(a.ntiles + gridDim.x - 1));
    __syncthreads();                   // the sample, s_tile
    const i64 tile = s_tile;
    if (tile >= a.ntiles) return;
    const i64 t0 = tile * K12_TILE;
    const i64 t1 = t0 + K12_TILE < a.nl ? t0 + K12_TILE : a.nl;
    // a warp's rows are 32 * K12_ITEMS consecutive ones, lane + 32 j its
    // j-th: every load and store of a plane is coalesced
    const i64 base = t0 + (i64)(t >> 5) * (32 * K12_ITEMS) + lane;
    // the rows' keys, valid bytes and (segmented) build ranges: every load
    // issued before any is used (indices clamped into the planes)
    i64 w[K12_ITEMS], b0[K12_ITEMS], b1[K12_ITEMS], x[K12_ITEMS], y[K12_ITEMS];
    bool on[K12_ITEMS];
    unsigned char vb[K12_ITEMS];
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j) {
      const i64 l = base + 32 * j < a.nl ? base + 32 * j : a.nl - 1;
      vb[j] = a.lvalid[l];
      w[j] = a.lkey[l];
    }
    int p = 0;
    if (SEG && base < a.nl) p = (int)upper_bound_i64(s_loff, 0, (i64)a.parts + 1, base) - 1;
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j) {
      const i64 l = base + 32 * j;
      on[j] = l < a.nl && vb[j];
      w[j] = key_word(w[j], a.is_f64);
      b0[j] = 0;
      b1[j] = a.nv;
      if (SEG && l < a.nl) {
        while (s_loff[p + 1] <= l) ++p;
        b0[j] = s_bounds[p];
        b1[j] = s_bounds[p + 1];
      }
    }
    // the warp's window: its keys all lie between the lower bounds of its
    // smallest valid key and of the word past its largest; where those lie
    // close (a probe side in key order, as lineitem by l_orderkey), every
    // key is searched in that window instead of the sample and a slice.
    // Segmented, only where the warp's rows lie in one partition.
    i64 kmin = I64_MAX_V, kmax = I64_MIN_V;
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j)
      if (on[j]) {
        kmin = w[j] < kmin ? w[j] : kmin;
        kmax = w[j] > kmax ? w[j] : kmax;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const i64 u = __shfl_xor_sync(0xffffffffu, kmin, off);
      const i64 v = __shfl_xor_sync(0xffffffffu, kmax, off);
      kmin = u < kmin ? u : kmin;
      kmax = v > kmax ? v : kmax;
    }
    bool windowed = false;
    const i64 wb0 = __shfl_sync(0xffffffffu, b0[0], 0), wb1 = __shfl_sync(0xffffffffu, b1[0], 0);
    if (kmin <= kmax &&
        (!SEG || __all_sync(0xffffffffu, b0[0] == wb0 && b1[0] == wb1 &&
                                             b0[K12_ITEMS - 1] == wb0 &&
                                             b1[K12_ITEMS - 1] == wb1))) {
      const bool past = kmax == I64_MAX_V;
      i64 c0[1] = {wb0}, c1[1] = {wb1}, k1[1] = {lane == 0 ? kmin : (past ? kmax : kmax + 1)};
      i64 r[1];
      bool o1[1] = {lane < 2};
      sampled_lower<1, !SEG>(a.words, samp, a.shift, a.sbits, c0, c1, k1, o1, r, WordAsIs());
      const i64 wlo = __shfl_sync(0xffffffffu, r[0], 0);
      const i64 whi = past ? wb1 : __shfl_sync(0xffffffffu, r[0], 1);
      const i64 m = whi - wlo;
      const int bits = m < (1ll << 30) ? 32 - __clz((int)m) : 64;
      if (bits + K12_WINDOW <= a.sbits + a.shift) {
        window_lower<K12_ITEMS>(a.words, wlo, (int)m, bits, w, x);
        windowed = true;
      }
    }
    if (!windowed)
      sampled_lower<K12_ITEMS, !SEG>(a.words, samp, a.shift, a.sbits, b0, b1, w, on, x,
                                     WordAsIs());
    // the upper bounds: steps on from the lower bound, all rows a step
    bool go[K12_ITEMS];
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j) {
      y[j] = x[j];
      go[j] = on[j] && x[j] < b1[j];
    }
    for (int st = 0; st < K12_STEPS; ++st) {
      i64 v[K12_ITEMS];
#pragma unroll
      for (int j = 0; j < K12_ITEMS; ++j) v[j] = go[j] ? a.words[y[j]] : 0;
      bool any = false;
#pragma unroll
      for (int j = 0; j < K12_ITEMS; ++j) {
        go[j] = go[j] && v[j] == w[j];
        if (go[j]) ++y[j];
        go[j] = go[j] && y[j] < b1[j];
        any |= go[j];
      }
      if (!any) break;
    }
    // past the steps (a key with many matches): a search for the next word
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j) {
      if (go[j] && a.words[y[j]] == w[j]) {
        if (w[j] == I64_MAX_V) {
          y[j] = b1[j];
        } else {
          i64 c0[1] = {y[j]}, c1[1] = {b1[j]}, k1[1] = {w[j] + 1}, r[1];
          bool o1[1] = {true};
          sampled_lower<1, false>(a.words, samp, a.shift, a.sbits, c0, c1, k1, o1, r,
                                  WordAsIs());
          y[j] = r[0];
        }
      }
    }
    // each row's offset within its warp: a warp scan a row, in row order
    i64 pre[K12_ITEMS], run = 0;
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j) {
      const i64 c = on[j] ? y[j] - x[j] : 0;
      i64 v = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const i64 u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      pre[j] = run + v - c;
      run += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) warp_tot[t >> 5] = run;
    __syncthreads();
    i64 wex = 0, agg = 0;                            // the warps before, the tile
#pragma unroll
    for (int k = 0; k < K12_THREADS / 32; ++k) {
      const i64 u = warp_tot[k];
      wex += k < (t >> 5) ? u : 0;
      agg += u;
    }
    if (t < 32) {
      i64 excl = 0;
      if (tile == 0) {
        if (lane == 0) __stcg(a.state + 1, make_longlong2(tag | 2, agg));
      } else {
        if (lane == 0) __stcg(a.state + 2 * tile, make_longlong2(tag | 1, agg));
        excl = k12_look_back(a, tile, lane);
        if (lane == 0) __stcg(a.state + 2 * tile + 1, make_longlong2(tag | 2, excl + agg));
      }
      if (lane == 0) s_excl = excl;
    }
    __syncthreads();
    const i64 tile_excl = s_excl;
#pragma unroll
    for (int j = 0; j < K12_ITEMS; ++j) {
      const i64 l = base + 32 * j;
      if (l < a.nl) {
        a.offs[l] = tile_excl + wex + pre[j];
        lo_out[l] = (L)(on[j] ? x[j] : 0);
      }
    }
    // the marks in [t0, t1), and in the last tile those at nl: their
    // offsets from the plane this block just wrote (visible after the
    // barrier), the ones at nl the grand total
    __syncthreads();
    const bool last = tile == a.ntiles - 1;
    i64 k0, k1;
    if (SEG) {
      k0 = lower_bound_i64(s_loff, 0, (i64)a.parts + 1, t0);
      k1 = last ? (i64)a.parts + 1 : lower_bound_i64(s_loff, 0, (i64)a.parts + 1, t1);
    } else {
      k0 = (t0 + a.mark_stride - 1) / a.mark_stride;
      k1 = last ? (i64)a.nmarks : (t1 + a.mark_stride - 1) / a.mark_stride;
      if (k1 > a.nmarks) k1 = a.nmarks;
    }
    for (i64 k = k0 + t; k < k1; k += K12_THREADS) {
      const i64 m = SEG ? s_loff[k] : k * a.mark_stride;
      a.host[k] = m < t1 ? a.offs[m] : tile_excl + agg;
    }
    __syncthreads();                   // s_tile, s_excl free for the next tile
  }
}

// The merge of the rows (row i at offs[i]) and the slots (slot j at j),
// rows first on ties, cut at diagonal d: how many rows come before it.
// One warp: 32 probes a step narrow the range 32-fold.
__device__ __forceinline__ i64 k12_split(const i64* __restrict__ offs, i64 nl, i64 total, i64 d,
                                         int lane) {
  i64 lo = d > total ? d - total : 0, hi = d < nl ? d : nl;
  while (hi - lo > 32) {
    const i64 step = (hi - lo + 31) >> 5;
    const i64 m = lo + lane * step;
    const bool row = m < hi && offs[m] <= d - 1 - m;
    const int n = __popc(__ballot_sync(0xffffffffu, row));
    if (n == 0) return lo;
    const i64 nlo = lo + (i64)(n - 1) * step + 1;
    const i64 nhi = lo + (i64)n * step;
    lo = nlo;
    hi = nhi < hi ? nhi : hi;
  }
  const i64 m = lo + lane;
  const bool row = m < hi && offs[m] <= d - 1 - m;
  return lo + __popc(__ballot_sync(0xffffffffu, row));
}

template <class T, class L>
__global__ void __launch_bounds__(K12_EX_THREADS)
k12_expand(i64 total, i64 nl, const L* __restrict__ lo, const i64* __restrict__ offs,
           const i64* __restrict__ order, const i64* __restrict__ lsel, T* __restrict__ out_l,
           T* __restrict__ out_r) {
  // per staged row: its offset less j0 (at least -1: every earlier one
  // compares alike), and lo less it, so slot j0 + k of the row reads
  // order[s_src[q] + k]; int where the build side is under 2^31 (L)
  __shared__ int s_rel[K12_EX_NV + 1];
  __shared__ L s_src[K12_EX_NV + 1];
  __shared__ int s_row[K12_EX_NV];
  __shared__ i64 s_cut[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const i64 all = nl + total;
  const i64 d0 = (i64)blockIdx.x * K12_EX_NV;
  const i64 d1 = d0 + K12_EX_NV < all ? d0 + K12_EX_NV : all;
  if (warp < 2) {
    const i64 c = k12_split(offs, nl, total, warp ? d1 : d0, lane);
    if (lane == 0) s_cut[warp] = c;
  }
  __syncthreads();
  const i64 i0 = s_cut[0], i1 = s_cut[1];
  const i64 j0 = d0 - i0;
  const int nb = (int)((d1 - i1) - j0);           // the block's slots [j0, j0 + nb)
  const int na = (int)(i1 - i0);                  // its rows [i0, i1)
  // rows [r0, i1) staged: the row before i0 owns the first slots
  const i64 r0 = i0 > 0 ? i0 - 1 : 0;
  const int sh = (int)(i0 - r0);
  for (int k = t; k < (int)(i1 - r0); k += K12_EX_THREADS) {
    const i64 rel = offs[r0 + k] - j0;
    s_rel[k] = rel < -1 ? -1 : (int)rel;
    s_src[k] = (L)((i64)lo[r0 + k] - rel);
  }
  __syncthreads();
  // this thread's items of the block's merge
  const int* A = s_rel + sh;
  const int dd = t * K12_EX_ITEMS < na + nb ? t * K12_EX_ITEMS : na + nb;
  const int de = dd + K12_EX_ITEMS < na + nb ? dd + K12_EX_ITEMS : na + nb;
  int x = dd > nb ? dd - nb : 0, y = dd < na ? dd : na;
  while (x < y) {
    const int mid = (x + y) >> 1;
    if (A[mid] <= dd - 1 - mid) x = mid + 1; else y = mid;
  }
  int i = x, j = dd - x;
  for (int d = dd; d < de; ++d) {
    if (i < na && (j >= nb || A[i] <= j)) {
      ++i;
    } else {
      s_row[j] = i - 1 + sh;
      ++j;
    }
  }
  __syncthreads();
  // the pairs, K12_EX_ITEMS a thread K12_EX_THREADS apart: every gather
  // issued before any store
  i64 l[K12_EX_ITEMS], r[K12_EX_ITEMS];
#pragma unroll
  for (int u = 0; u < K12_EX_ITEMS; ++u) {
    const int k = t + u * K12_EX_THREADS;
    const int q = s_row[k < nb ? k : 0];
    const bool in = k < nb;
    l[u] = lsel != nullptr && in ? lsel[r0 + q] : r0 + q;
    r[u] = in ? order[(i64)s_src[q] + k] : 0;
  }
#pragma unroll
  for (int u = 0; u < K12_EX_ITEMS; ++u) {
    const int k = t + u * K12_EX_THREADS;
    if (k < nb) {
      out_l[j0 + k] = (T)l[u];
      out_r[j0 + k] = (T)r[u];
    }
  }
}

static i64 k12_tiles(i64 nl) { return nl > 0 ? (nl + K12_TILE - 1) / K12_TILE : 1; }

// The workspace of a call over nl probe rows: the ticket (16 bytes), then
// two tagged words a tile.
extern "C" i64 join_probe_workspace_bytes(i64 nl) { return 16 + k12_tiles(nl) * 32; }

// The most sampled build words plus one, for the host's choice of the
// sample's shift (ops/kernels.py _k12).
extern "C" i64 join_probe_sample_cap() { return K12_SAMPLE; }

template <bool SEG, class L>
static int k12_count_go(K12Count& a, size_t smem, cudaStream_t st) {
  // per device: the opt-in for the largest sample and segment tables,
  // and the grid of whole waves at the last shared-memory size asked
  static bool ready[64];
  static size_t at[64];
  static int waves[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(k12_count<SEG, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             8 * (K12_SAMPLE + 2 * (K12_MAX_PARTS + 1)));
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  if (waves[dev] == 0 || at[dev] != smem) {
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k12_count<SEG, L>, K12_THREADS,
                                                        smem);
    if (e != cudaSuccess) return (int)e;
    waves[dev] = (occ > 0 ? occ : 1) * sms;
    at[dev] = smem;
  }
  const i64 grid = a.ntiles < waves[dev] ? a.ntiles : waves[dev];
  k12_count<SEG, L><<<(unsigned)grid, K12_THREADS, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(st);
}

// The count: lo (nl entries of lo_bytes, 4 only where nv is under 2^31)
// and offs (nl int64)
// for every probe row; host, page-locked and mapped, nmarks int64: the
// offset at each mark, the last mark being nl (the grand total). Segmented
// when parts > 0: the probe planes partition-major, loff their parts + 1
// starts (the marks, nmarks = parts + 1), bounds the parts + 1 starts of
// the partitions' words among the nv words; else the marks are k *
// mark_stride for k < nmarks. The sample holds every 2^shift-th word, at
// most K12_SAMPLE - 1 of them. ws: join_probe_workspace_bytes(nl) bytes
// zeroed when made and reused (epoch above every earlier call's on it).
// Waits for the stream, so host holds the marks' offsets on return.
extern "C" int join_probe_count_launch(i64 nl, const i64* lkey, const unsigned char* lvalid,
                                       int is_f64, const i64* words, i64 nv, const i64* loff,
                                       const i64* bounds, int parts, int shift, int lo_bytes,
                                       void* lo,
                                       i64* offs, i64 mark_stride, int nmarks, void* ws,
                                       u64 epoch, i64* host, void* stream) {
  if (nl < 1 || nv < 0 || nmarks < 1 || epoch == 0 || epoch >= (1ull << 62)) return -1;
  if (parts < 0 || parts > K12_MAX_PARTS || (parts > 0 && nmarks != parts + 1)) return -1;
  if (parts == 0 && mark_stride < 1) return -1;
  if (lo_bytes != 4 && lo_bytes != 8) return -1;
  if (lo_bytes == 4 && nv >= ((i64)1 << 31)) return -1;
  if (shift < 0 || shift > 40 || sample_len(nv, shift) > K12_SAMPLE - 1) return -1;
  K12Count a;
  a.nl = nl;
  a.nv = nv;
  a.lkey = lkey;
  a.lvalid = lvalid;
  a.words = words;
  a.loff = loff;
  a.bounds = bounds;
  a.lo = lo;
  a.offs = offs;
  // at most K12_SAMPLE - 1 entries, so that the unsegmented sample padded
  // to 2^sbits (one entry above any key at its end) takes K12_SAMPLE
  a.shift = shift;
  a.ns = nv > 0 ? (int)sample_len(nv, a.shift) : 0;
  a.sbits = bit_len(a.ns);
  a.sp = parts > 0 || a.ns == 0 ? a.ns : 1 << a.sbits;
  a.mark_stride = mark_stride;
  a.ntiles = k12_tiles(nl);
  if (a.ntiles > 0x7fffffffll) return -1;
  a.ticket = (unsigned*)ws;
  a.state = (longlong2*)((char*)ws + 16);
  a.epoch = epoch;
  a.is_f64 = is_f64;
  a.parts = parts;
  a.nmarks = nmarks;
  cudaError_t e = cudaHostGetDevicePointer((void**)&a.host, host, 0);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = 8 * (a.sp + (parts > 0 ? 2 * (parts + 1) : 0));
  cudaStream_t st = (cudaStream_t)stream;
  if (parts > 0)
    return lo_bytes == 4 ? k12_count_go<true, int>(a, smem, st)
                         : k12_count_go<true, i64>(a, smem, st);
  return lo_bytes == 4 ? k12_count_go<false, int>(a, smem, st)
                       : k12_count_go<false, i64>(a, smem, st);
}

// The expand. out holds 2 * total indices, int32 if narrow else int64: the
// left indices (lsel[l] where lsel is given, else l), then the right ones.
extern "C" int join_probe_expand_launch(i64 total, i64 nl, int lo_bytes, const void* lo,
                                        const i64* offs, const i64* order, const i64* lsel,
                                        int narrow, void* out, void* stream) {
  if (total < 1 || nl < 1 || (lo_bytes != 4 && lo_bytes != 8)) return -1;
  const i64 nblk = (nl + total + K12_EX_NV - 1) / K12_EX_NV;
  if (nblk > 0x7fffffffll) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)nblk;
  if (narrow) {
    int* o = (int*)out;
    if (lo_bytes == 4)
      k12_expand<int, int><<<g, K12_EX_THREADS, 0, st>>>(total, nl, (const int*)lo, offs, order,
                                                         lsel, o, o + total);
    else
      k12_expand<int, i64><<<g, K12_EX_THREADS, 0, st>>>(total, nl, (const i64*)lo, offs,
                                                         order, lsel, o, o + total);
  } else {
    i64* o = (i64*)out;
    k12_expand<i64, i64><<<g, K12_EX_THREADS, 0, st>>>(total, nl, (const i64*)lo, offs, order,
                                                       lsel, o, o + total);
  }
  return (int)cudaGetLastError();
}
