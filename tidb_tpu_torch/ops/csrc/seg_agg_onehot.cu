// K3 seg_agg_onehot: grouped reductions over at most 64 segments.
//
// Replaces the one-hot route of tidb_tpu/ops/kernels.py:903
// build_grouped_agg_fn (:945 _grouped_agg, SegCtx :599 with use_onehot,
// :640-670): per segment the count of contributing rows and their sum,
// min/max (sentinel when empty) or first row index. The group id comes
// from K1, with dead rows already in the last (sink) segment.
//
// Bound by bytes: 1 B of mask a row and, at the rows the mask keeps, 8 B
// of group id and each distinct plane of the reductions (1 B of valid,
// 8 B of value), each read once. The first design looped over the
// reductions outside the rows (every reduction re-read the ids and the
// mask), had each warp scan all of a tile's rows for each segment it
// owned (O(S x N)), uploaded its descriptors and folded the block
// partials in a second launch: 2.172 ms at Q1 (PERF.md, row 3).
// This one reads every plane once, for all reductions, in one launch:
// - the reductions by value: ops/kernels.py (k3_chunks) maps a call's
//   reductions to state slots as K4's windows do (a count slot per
//   distinct valid plane, a value slot per distinct (op, values, valid):
//   Q1's eleven reductions keep twelve), integer slots first, and passes
//   the slots and the reduction map in the launch's parameters
//   (__grid_constant__ K3Args); more slots than a block holds go as
//   several launches, each reading the ids and the mask once;
// - one pass: a warp owns a contiguous run of rows and reads it in steps
//   of K3_PAIRS row pairs a lane, each plane's pair in one load (16 bytes
//   of ids or values, 2 bytes of mask or valid) where every plane allows,
//   else row by row; ids are read only where the mask is set, values only
//   for rows in a segment;
// - integer slots (counts, wrapping sums, exact min and max, the first
//   row) fold at once by shared-memory integer atomics, whose result no
//   order changes (32-bit ones: k3_smem_fold), into up to K3_MAX_COPIES
//   copies of the block's states
//   (lane l into copy l mod copies, the copies an odd number of words
//   apart): Q1's largest group holds half the rows, and one copy would pile
//   a warp's lanes onto one address; a lane's two rows in one segment fold
//   together first. At the block's end the copies fold into one, and each
//   state that holds anything meets the other blocks' in a device cell by
//   a global integer atomic (sums add; min and max as an unsigned max of
//   an order-preserving image whose identity is 0);
// - f64 slots fold in row order, with no float atomics: a step's 64 rows
//   of a lane pair are laid out a row a lane (two rounds of shuffles), the
//   lanes sharing a segment (__match_any_sync) fold as a tree in lane
//   order (seg_block.cuh k6b_group_fold) and the group's first lane folds
//   the result into its warp's own states; the block folds its warps in
//   order into its partials, and the last block folds the blocks' partials
//   in block order (each lane a contiguous run of blocks, then a tree that
//   keeps lane order). Rows, warps and blocks are each contiguous, so the
//   fold is in row order: repeats are bit-identical and an extremum tie of
//   -0.0 and +0.0 keeps the first row;
// - one launch: the last block to finish (an integer ticket, which
//   decides no order) reads the cells and partials, writes the (n, v)
//   pairs and leaves the ticket and the cells at 0 for the next launch on
//   the stream's workspace (kernels._stream_scratch), so nothing is reset
//   from the host.
#include <cstring>

#include "seg_block.cuh"   // k6b_group_fold, k6b_is_f64, K6B_ROW_VALUE

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_MINB 4            // resident blocks a launch bound asks for
#define K3_PAIRS 2           // row pairs a lane takes a step
#define K3_MAX_SEG 64
#define K3_MAX_SLOTS 32
#define K3_MAX_REDS 64
#define K3_MAX_COPIES 32
#define K3_SLOT 5
#define K3_MAP 3
#define K3_CELLS (K3_MAX_SLOTS * K3_MAX_SEG)   // device cells of the integer states
#define K3_COPIES_BYTES 49152   // copies are added while the states fit this
#define K3_SMEM_CAP 98304       // one copy's states and f64 states at most
#define K3_MAX_GRID 1024

// A slot is K3_SLOT int64: (op, flags, constant, values pointer, valid
// pointer); a count slot is (R_COUNT, 0, 1, 0, valid); R_FIRST's value
// slot has the K6B_ROW_VALUE flag. The integer slots come first. A
// reduction maps to K3_MAP int64: (op, its count slot, its value slot),
// -1 where it has none.
struct K3Args {
  i64 n;
  const i64* gid;
  const unsigned char* mask;
  unsigned* ticket;    // 0 between launches
  u64* cells;          // [n_int][S] integer states' images, 0 between launches
  i64* part;           // [n_f * S][gridDim.x] f64 block partials
  i64* out;            // [n_red][S] (n, v)
  int S, n_slots, n_int, n_f, n_red, copies, slab, vec;
  i64 slots[K3_MAX_SLOTS * K3_SLOT];
  i64 map[K3_MAX_REDS * K3_MAP];
};

// Words a copy of the integer states takes: n_int * S made odd, so that
// lane l's copy starts in another bank pair than its neighbours'.
__host__ __device__ inline int k3_slab(int n_int, int S) {
  const int w = n_int * S;
  return w > 0 && (w & 1) == 0 ? w + 1 : w;
}

// Dynamic shared memory: the copies of the integer states and each warp's
// f64 states (kernels.k3_smem_bytes mirrors this).
__host__ __device__ inline long long k3_smem_bytes(int n_int, int n_f, int S, int copies) {
  return 8LL * ((long long)copies * k3_slab(n_int, S) + (long long)K3_WARPS * n_f * S);
}

// The device cell's image of an integer state: sums and counts as they
// are; min (and the first row) and max as an unsigned max whose identity,
// 0, decodes to the int64 sentinel.
__device__ __forceinline__ u64 k3_enc(int op, i64 v) {
  if (op == R_MIN_I || op == R_FIRST) return ~((u64)v ^ RADIX_SIGN);
  if (op == R_MAX_I) return (u64)v ^ RADIX_SIGN;
  return (u64)v;
}

__device__ __forceinline__ i64 k3_dec(int op, u64 c) {
  if (op == R_MIN_I || op == R_FIRST) return (i64)(~c ^ RADIX_SIGN);
  if (op == R_MAX_I) return (i64)(c ^ RADIX_SIGN);
  return (i64)c;
}

// One integer state at p (shared memory) takes x from `cnt` rows. Only
// 32-bit shared-memory atomics are native (a 64-bit one is a
// compare-and-swap loop): a count adds to the low word (below 2^32 in a
// block); a wrapping sum adds its low word, then its high word with the
// low word's carry; min and max read the state first and take the atomic
// only where x would change it (a state only moves one way, so a stale
// read never skips a change).
__device__ __forceinline__ void k3_smem_fold(int op, i64* p, i64 x, unsigned cnt) {
  switch (op) {
    case R_COUNT: atomicAdd((unsigned*)p, cnt); break;
    case R_SUM_I: {
      unsigned* w = (unsigned*)p;   // little-endian: the low word first
      const unsigned lo = (unsigned)x, hi = (unsigned)((u64)x >> 32);
      const unsigned old = atomicAdd(w, lo);
      const unsigned up = hi + (old + lo < old ? 1u : 0u);
      if (up != 0u) atomicAdd(w + 1, up);
      break;
    }
    case R_MAX_I:
      if (x > *(volatile i64*)p) atomicMax((long long*)p, (long long)x);
      break;
    default:                                              // R_MIN_I, R_FIRST
      if (x < *(volatile i64*)p) atomicMin((long long*)p, (long long)x);
  }
}

// A plane's pair of rows 2p, 2p + 1: in one load (VEC: every plane in
// phase and both rows in range), else row by row where in range.
template <bool VEC>
__device__ __forceinline__ void k3_pair(const i64* __restrict__ a, i64 p, bool r0, bool r1,
                                        i64& x0, i64& x1) {
  if (VEC) {
    const longlong2 q = __ldg((const longlong2*)a + p);
    x0 = q.x;
    x1 = q.y;
  } else {
    x0 = r0 ? a[2 * p] : 0;
    x1 = r1 ? a[2 * p + 1] : 0;
  }
}

// The two bytes of rows 2p, 2p + 1, each as 0 or 1 (bit 0 and bit 8).
template <bool VEC>
__device__ __forceinline__ unsigned k3_bytes(const unsigned char* __restrict__ a, i64 p, bool r0,
                                             bool r1) {
  unsigned b;
  if (VEC) {
    b = __ldg((const unsigned short*)a + p);
  } else {
    b = (r0 ? (unsigned)a[2 * p] : 0u) | ((r1 ? (unsigned)a[2 * p + 1] : 0u) << 8);
  }
  return ((b & 0xffu) != 0u ? 1u : 0u) | ((b >> 8) != 0u ? 0x100u : 0u);
}

// One step of a warp: pairs base + u * 32 + lane (u < K3_PAIRS) below pend,
// rows below n. ints: the lane's copy of the integer states; fs: the warp's
// f64 states.
template <bool VEC>
__device__ __forceinline__ void k3_step(const K3Args& a, i64 base, i64 pend, i64* __restrict__ ints,
                                        i64* __restrict__ fs, int lane) {
  i64 p[K3_PAIRS];
  bool r0[K3_PAIRS], r1[K3_PAIRS];
  int g0[K3_PAIRS], g1[K3_PAIRS];
  bool any = false;
#pragma unroll
  for (int u = 0; u < K3_PAIRS; ++u) {
    p[u] = base + u * 32 + lane;
    const bool in = p[u] < pend;
    r0[u] = in && 2 * p[u] < a.n;
    r1[u] = in && 2 * p[u] + 1 < a.n;
    const unsigned m = (r0[u] || r1[u]) ? k3_bytes<VEC>(a.mask, p[u], r0[u], r1[u]) : 0u;
    i64 x0 = -1, x1 = -1;
    if (m != 0u) k3_pair<VEC>(a.gid, p[u], r0[u], r1[u], x0, x1);
    g0[u] = (m & 1u) && x0 >= 0 && x0 < a.S ? (int)x0 : -1;
    g1[u] = (m >> 8) && x1 >= 0 && x1 < a.S ? (int)x1 : -1;
    any |= g0[u] >= 0 || g1[u] >= 0;
  }
  if (!__any_sync(0xffffffffu, any)) return;

  // integer slots: shared-memory atomics into the lane's copy, a slot's
  // valid and value loads issued before its folds
  for (int j = 0; j < a.n_int; ++j) {
    const i64* sl = a.slots + K3_SLOT * j;
    const int op = (int)sl[0];
    const bool rowv = (sl[1] & K6B_ROW_VALUE) != 0;
    const i64* vals = op == R_COUNT ? nullptr : (const i64*)sl[3];
    const unsigned char* valid = (const unsigned char*)sl[4];
    unsigned vb[K3_PAIRS];
    i64 x0[K3_PAIRS], x1[K3_PAIRS];
#pragma unroll
    for (int u = 0; u < K3_PAIRS; ++u) {
      const bool live = g0[u] >= 0 || g1[u] >= 0;
      vb[u] = (live && valid != nullptr) ? k3_bytes<VEC>(valid, p[u], r0[u], r1[u]) : 0x101u;
      x0[u] = x1[u] = sl[2];
      if (rowv) {
        x0[u] = 2 * p[u];
        x1[u] = x0[u] + 1;
      } else if (vals != nullptr && live) {
        k3_pair<VEC>(vals, p[u], r0[u], r1[u], x0[u], x1[u]);
      }
    }
    i64* st = ints + j * a.S;
#pragma unroll
    for (int u = 0; u < K3_PAIRS; ++u) {
      const bool t0 = g0[u] >= 0 && (vb[u] & 1u), t1 = g1[u] >= 0 && (vb[u] >> 8);
      if (t0 && t1 && g0[u] == g1[u]) {
        k3_smem_fold(op, st + g0[u], val_merge(op, x0[u], x1[u]), 2u);
      } else {
        if (t0) k3_smem_fold(op, st + g0[u], x0[u], 1u);
        if (t1) k3_smem_fold(op, st + g1[u], x1[u], 1u);
      }
    }
  }

  // f64 slots: a row a lane, the lanes of one segment as a tree in lane
  // order, into the warp's states in row order
  const unsigned lt = (1u << lane) - 1u;
  for (int f = 0; f < a.n_f; ++f) {
    const i64* sl = a.slots + K3_SLOT * (a.n_int + f);
    const int op = (int)sl[0];
    const i64* vals = (const i64*)sl[3];
    const unsigned char* valid = (const unsigned char*)sl[4];
    i64* st = fs + (i64)f * a.S;
    const i64 ident = val_ident(op);
    unsigned vb[K3_PAIRS];
    i64 x0[K3_PAIRS], x1[K3_PAIRS];
#pragma unroll
    for (int u = 0; u < K3_PAIRS; ++u) {
      const bool live = g0[u] >= 0 || g1[u] >= 0;
      vb[u] = (live && valid != nullptr) ? k3_bytes<VEC>(valid, p[u], r0[u], r1[u]) : 0x101u;
      x0[u] = x1[u] = sl[2];
      if (vals != nullptr && live) k3_pair<VEC>(vals, p[u], r0[u], r1[u], x0[u], x1[u]);
    }
#pragma unroll
    for (int u = 0; u < K3_PAIRS; ++u) {
      const bool t0 = g0[u] >= 0 && (vb[u] & 1u), t1 = g1[u] >= 0 && (vb[u] >> 8);
      if (!__any_sync(0xffffffffu, t0 || t1)) continue;
      const int tb = (int)t0 | ((int)t1 << 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // row 32 r + lane of the step's 64: lane 16 r + lane / 2's pair
        const int src = 16 * r + (lane >> 1), odd = lane & 1;
        const int ga = __shfl_sync(0xffffffffu, g0[u], src);
        const int gb = __shfl_sync(0xffffffffu, g1[u], src);
        const int tk = (__shfl_sync(0xffffffffu, tb, src) >> odd) & 1;
        const i64 xa = __shfl_sync(0xffffffffu, x0[u], src);
        const i64 xb = __shfl_sync(0xffffffffu, x1[u], src);
        const int g = odd ? gb : ga;
        const unsigned peers = __match_any_sync(0xffffffffu, tk ? g : -1 - lane);
        const int maxc = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(peers));
        i64 v = tk ? (odd ? xb : xa) : ident;
        if (maxc > 1) v = k6b_group_fold(op, v, peers, maxc, lane);
        if (tk && (peers & lt) == 0u) st[g] = val_merge(op, st[g], v);
        __syncwarp();   // the next round's leader of g reads this one's state
      }
    }
  }
}

__global__ void __launch_bounds__(K3_THREADS, K3_MINB)
seg_onehot_kernel(const __grid_constant__ K3Args a) {
  extern __shared__ i64 k3_smem[];
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int S = a.S, n_int = a.n_int, n_f = a.n_f;
  const int slab = a.slab;
  i64* ints = k3_smem;                                  // [copies][slab]
  i64* fsm = k3_smem + (size_t)a.copies * slab;         // [warps][n_f][S]
  for (int i = t; i < a.copies * slab; i += K3_THREADS) {
    const int k = i % slab;
    ints[i] = k < n_int * S ? val_ident((int)a.slots[K3_SLOT * (k / S)]) : 0;
  }
  for (int i = t; i < K3_WARPS * n_f * S; i += K3_THREADS)
    fsm[i] = val_ident((int)a.slots[K3_SLOT * (n_int + (i / S) % n_f)]);
  __syncthreads();

  // the block's contiguous pairs, each warp a contiguous part of them
  const i64 G = gridDim.x, b = blockIdx.x;
  const i64 P = a.n >> 1;
  const i64 b0 = P * b / G, b1 = P * (b + 1) / G;
  const i64 w0 = b0 + (b1 - b0) * warp / K3_WARPS, w1 = b0 + (b1 - b0) * (warp + 1) / K3_WARPS;
  i64* mine = ints + (size_t)(lane & (a.copies - 1)) * slab;
  i64* fw = fsm + (size_t)warp * n_f * S;
  if (a.vec) {
    for (i64 base = w0; base < w1; base += 32 * K3_PAIRS) k3_step<true>(a, base, w1, mine, fw, lane);
  } else {
    for (i64 base = w0; base < w1; base += 32 * K3_PAIRS) k3_step<false>(a, base, w1, mine, fw, lane);
  }
  // an odd last row: after every other row, by the last warp
  if ((a.n & 1) && b == G - 1 && warp == K3_WARPS - 1) k3_step<false>(a, P, P + 1, mine, fw, lane);
  __syncthreads();

  // the block's integer states (its copies folded) into the device cells;
  // its f64 states (its warps in order) into its partials
  for (int k = t; k < n_int * S; k += K3_THREADS) {
    const int op = (int)a.slots[K3_SLOT * (k / S)];
    i64 v = ints[k];
    for (int c = 1; c < a.copies; ++c) v = val_merge(op, v, ints[(size_t)c * slab + k]);
    if (v == val_ident(op)) continue;
    u64* cell = a.cells + k;
    if (op == R_COUNT || op == R_SUM_I) atomicAdd((unsigned long long*)cell, (unsigned long long)v);
    else atomicMax((unsigned long long*)cell, (unsigned long long)k3_enc(op, v));
  }
  for (int k = t; k < n_f * S; k += K3_THREADS) {
    const int op = (int)a.slots[K3_SLOT * (n_int + k / S)];
    i64 v = val_ident(op);
    for (int w = 0; w < K3_WARPS; ++w) v = val_merge(op, v, fsm[(size_t)w * n_f * S + k]);
    a.part[(i64)k * G + b] = v;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.ticket, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: every state into res (the shared memory's start),
  // the cells back to 0
  i64* res = k3_smem;                                   // [n_slots][S]
  __syncthreads();
  for (int k = t; k < n_int * S; k += K3_THREADS) {
    const int op = (int)a.slots[K3_SLOT * (k / S)];
    res[k] = k3_dec(op, __ldcg(a.cells + k));
    a.cells[k] = 0ull;
  }
  // f64 states: a warp a state, lane l the blocks [G l / 32, G (l + 1) / 32)
  // in order, then a tree that keeps lane order: block order
  for (int k = warp; k < n_f * S; k += K3_WARPS) {
    const int op = (int)a.slots[K3_SLOT * (n_int + k / S)];
    i64 v = val_ident(op);
    const i64 lo = G * lane / 32, hi = G * (lane + 1) / 32;
    const i64* pk = a.part + (i64)k * G;
    for (i64 j = lo; j < hi; ++j) v = val_merge(op, v, __ldcg(pk + j));
    for (int off = 1; off < 32; off <<= 1) {
      const i64 y = __shfl_down_sync(0xffffffffu, v, off);
      if ((lane & (2 * off - 1)) == 0) v = val_merge(op, v, y);
    }
    if (lane == 0) res[n_int * S + k] = v;
  }
  __syncthreads();
  for (int i = t; i < a.n_red * S; i += K3_THREADS) {
    const int r = i / S, s = i % S;
    const int op = (int)a.map[K3_MAP * r];
    const int cs = (int)a.map[K3_MAP * r + 1], vs = (int)a.map[K3_MAP * r + 2];
    a.out[2 * (i64)i] = cs >= 0 ? res[cs * S + s] : 0;
    a.out[2 * (i64)i + 1] = vs >= 0 ? res[vs * S + s] : val_ident(op);
  }
  if (t == 0) *a.ticket = 0u;
}

// The resident grid at smem bytes on the current device, kept per
// (device, bytes); the first call on a device opts the kernel in to
// K3_SMEM_CAP. Minus a CUDA error on failure.
static int k3_grid(long long smem) {
  static bool ready[64];
  static long long keys[64][32];
  static int grids[64][32];
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  for (int i = 0; i < 32 && grids[dev][i] > 0; ++i)
    if (keys[dev][i] == smem) return grids[dev][i];
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(seg_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K3_SMEM_CAP);
    if (e != cudaSuccess) return -(int)e;
    ready[dev] = true;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, seg_onehot_kernel, K3_THREADS,
                                                      (size_t)smem);
  if (e != cudaSuccess) return -(int)e;
  int g = (occ > 0 ? occ : 1) * sms;
  if (g > K3_MAX_GRID) g = K3_MAX_GRID;
  for (int i = 0; i < 32; ++i)
    if (grids[dev][i] == 0) {
      keys[dev][i] = smem;
      grids[dev][i] = g;
      break;
    }
  return g;
}

// The copies of the integer states a launch keeps: the most, a power of
// two up to K3_MAX_COPIES, whose bytes stay within K3_COPIES_BYTES (or
// one copy).
__host__ inline int k3_copies(int n_int, int n_f, int S) {
  int c = 1;
  while (c < K3_MAX_COPIES && k3_smem_bytes(n_int, n_f, S, 2 * c) <= K3_COPIES_BYTES) c *= 2;
  return c;
}

static bool k3_aligned(const void* p, size_t a) { return ((size_t)p & (a - 1)) == 0; }

// One launch over n rows: slots n_slots * K3_SLOT (the first n_slots - n_f
// integer ops) and red_map n_red * K3_MAP in host memory, copied into the
// parameters; work: the stream's workspace (a 4-byte ticket and 4 bytes of
// padding, K3_CELLS cells, then n_f * S * K3_MAX_GRID partials), its
// ticket and cells 0; out: n_red * S (n, v) pairs.
extern "C" int seg_onehot_launch(i64 n, const i64* gid, const unsigned char* mask, int S,
                                 int n_slots, int n_f, const i64* slots, int n_red,
                                 const i64* red_map, void* work, i64* out, void* stream) {
  if (n < 0 || S < 1 || S > K3_MAX_SEG || n_slots < 0 || n_slots > K3_MAX_SLOTS || n_f < 0 ||
      n_f > n_slots || n_red < 1 || n_red > K3_MAX_REDS)
    return -1;
  const int n_int = n_slots - n_f;
  if (k3_smem_bytes(n_int, n_f, S, 1) > K3_SMEM_CAP) return -1;
  K3Args a;
  memset(&a, 0, sizeof(a));
  a.n = n;
  a.gid = gid;
  a.mask = mask;
  a.ticket = (unsigned*)work;
  a.cells = (u64*)((char*)work + 8);
  a.part = (i64*)((char*)work + 8 + 8 * K3_CELLS);
  a.out = out;
  a.S = S;
  a.n_slots = n_slots;
  a.n_int = n_int;
  a.n_f = n_f;
  a.n_red = n_red;
  a.copies = k3_copies(n_int, n_f, S);
  a.slab = k3_slab(n_int, S);
  bool vec = k3_aligned(gid, 16) && k3_aligned(mask, 2);
  for (int j = 0; j < n_slots; ++j) {
    const i64* sl = slots + K3_SLOT * j;
    vec = vec && k3_aligned((const void*)sl[3], 16) && k3_aligned((const void*)sl[4], 2);
  }
  a.vec = vec;
  if (n_slots > 0) memcpy(a.slots, slots, sizeof(i64) * K3_SLOT * n_slots);
  memcpy(a.map, red_map, sizeof(i64) * K3_MAP * n_red);
  const long long smem = k3_smem_bytes(n_int, n_f, S, a.copies);
  const int resident = k3_grid(smem);
  if (resident <= 0) return -resident;
  // at least a step of every warp's pairs a block
  i64 g = ((n >> 1) + K3_THREADS * K3_PAIRS - 1) / (K3_THREADS * K3_PAIRS);
  if (g < 1) g = 1;
  if (g > resident) g = resident;
  seg_onehot_kernel<<<(unsigned)g, K3_THREADS, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
