// K15 slot_agg: the scalar aggregates of k statements of one shape over
// one batch, each under its own WHERE literals, in one launch.
//
// Replaces tidb_tpu/ops/sched.py:439 _build_agg_wrapper: jax.vmap over
// the statement slots of the WHERE mask fused with every aggregate's
// masked count and sum / min / max (the sentinels of kernels._scalar_agg
// where no row contributes). Here the reductions are K2's descriptors
// (common.cuh), the first one the count of rows passing the WHERE.
//
// It runs on K14's shape (slot_filter.cu):
//   - nothing is copied to the card first: the plane pointers, the
//     program, the pools, the reduction descriptors and the LUT ride by
//     value in the launch's parameters (vm.cuh SlotParams);
//   - the grid is row blocks x groups of slots, as many groups as bring
//     it to about K15_TARGET_BLOCKS blocks (16 groups of 2 slots at the
//     tier's 32 x 16,384; one group at millions of rows), a row block a
//     run of tiles of K15_TILE rows (K15_ROWS a thread), at most
//     K15_MAX_ROW_BLOCKS of them. A block stages the program and its
//     group's pools in shared memory;
//   - the program arrives split (ops/exprc.py slot_split): a row runs
//     the slot-invariant part (the plane loads and what reads no constant
//     pool) once, then the rest once a slot of its group, with the
//     registers' values in shared memory and their valid bits in one
//     32-bit register (vm.cuh VmSmemRegs): no local memory;
//   - a reduction equal to an earlier one (the tier's where-pass count
//     and a COUNT(*) are) folds nothing and copies its twin's result;
//   - a row's value and valid planes of every reduction are read once,
//     whatever the group's slots: a row first runs every slot's part into
//     one 64-bit word of WHERE bits, then folds each reduction into each
//     slot whose bit is set;
//   - each (slot, reduction) folds a warp's rows: a thread's K15_ROWS
//     rows in order, then the warp's own reductions (the count a
//     popcount of the contributing rows; int64 sums and extrema by add /
//     min / max reductions; f64 ops by a shuffle tree in lane order),
//     K15_CHUNK slots side by side, then the warp's tiles in row order
//     into a running value in shared memory, then the block's warps in
//     order. An integer reduction's blocks meet
//     in a running cell of the stream's scratch by integer atomics (any
//     order gives the same bits); an f64 reduction's blocks write
//     partials, which the last row block of the group to finish (an
//     integer ticket, which decides no order, as K2) folds: lane l the
//     blocks l, l + 32, ... in order, then a tree in lane order. No
//     floating-point atomics, so f64 sums and extrema (+-inf, the
//     -0.0 / +0.0 tie) repeat bit for bit; the int64 sums are exact
//     because the lowering refuses a sum that could wrap (max_abs *
//     n_rows). The last block also reads the group's integer cells and
//     puts them back to 0, every op's identity in the cells' encoding.
// So a call is one launch. The tickets, the cells and the partials are a
// scratch kept per stream (kernels._stream_scratch), zero when made: a
// launch leaves its tickets and cells at 0.
//
// Bound by bytes: the program's planes, the live byte and each reduction's
// value and valid planes read once per row, k * R * 16 bytes written.
#include "vm.cuh"

// the plan's constants: kernels.slot_agg_plan mirrors them
#define K15_THREADS 128
#define K15_WARPS (K15_THREADS / 32)
#define K15_ROWS 2                               // rows a thread takes a tile
#define K15_TILE (K15_THREADS * K15_ROWS)
#define K15_TARGET_BLOCKS (132 * 12)
#define K15_MAX_ROW_BLOCKS (132 * 12)
#define K15_MAX_RED SLOT_MAX_RED
// a group's running (count, value) per slot, reduction and warp: at most
// this many (slot, reduction) pairs a group, and at most K15_MAX_GROUP
// slots (a row's WHERE bits in one 64-bit word)
#define K15_MAX_PAIRS 512
#define K15_MAX_GROUP 64
// a descriptor flag besides common.cuh's: the reduction is the one at
// index const_bits over again (kernels.slot_agg_states marks them), so it
// folds nothing and copies that one's result
#define K15_SAME 4

// The scratch's fixed head, so that what one launch leaves at 0 is where
// the next looks for it whatever its shape: the integer cells of every
// (slot, reduction) a launch can have (k * P <= SLOT_POOL_WORDS, so k is
// at most that), then a ticket per group; the partials follow.
#define K15_CELL_BYTES (16 * SLOT_POOL_WORDS * SLOT_MAX_RED)
#define K15_TICKET_BYTES (4 * SLOT_POOL_WORDS)

// The warp's fold of v over its lanes for reduction OP (lane 0's result;
// every lane's for the integers): int64 sums by the warp's add reductions
// over 16-, 16- and 32-bit pieces (exact modulo 2^64), int64 extrema and
// FIRST by its min / max reductions over the high words, then the low
// words of the lanes that hold the extreme high word (integers: any order
// gives the same bits); f64 ops by a shuffle tree in lane order.
template <int OP>
__device__ __forceinline__ i64 k15_warp_fold(i64 v) {
  if (OP == R_SUM_I) {
    const u64 u = (u64)v;
    const unsigned lo = __reduce_add_sync(0xffffffffu, (unsigned)(u & 0xffffu));
    const unsigned mid = __reduce_add_sync(0xffffffffu, (unsigned)((u >> 16) & 0xffffu));
    const unsigned hi = __reduce_add_sync(0xffffffffu, (unsigned)(u >> 32));
    return (i64)(((u64)hi << 32) + ((u64)mid << 16) + (u64)lo);
  }
  if (OP == R_MIN_I || OP == R_MAX_I || OP == R_FIRST) {
    const int hi = (int)(v >> 32);
    const unsigned lo = (unsigned)v;
    if (OP == R_MAX_I) {
      const int mh = __reduce_max_sync(0xffffffffu, hi);
      const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
      return (i64)(((u64)(unsigned)mh << 32) | ml);
    }
    const int mh = __reduce_min_sync(0xffffffffu, hi);
    const unsigned ml = __reduce_min_sync(0xffffffffu, hi == mh ? lo : 0xffffffffu);
    return (i64)(((u64)(unsigned)mh << 32) | ml);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = val_merge(OP, v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// An integer reduction's running cell in the stream's scratch: 0 is every
// op's identity, so the cells start at 0 and the last block puts them
// back. A count or an int64 sum adds (modulo 2^64); MAX_I keeps the
// largest x ^ sign bit (unsigned order is the signed order), MIN_I and
// FIRST the largest ~(x ^ sign bit).
__device__ __forceinline__ bool k15_f64(int op) {
  return op == R_SUM_F || op == R_MIN_F || op == R_MAX_F;
}

__device__ __forceinline__ void k15_cell_fold(int op, u64* c, i64 x) {
  switch (op) {
    case R_SUM_I: atomicAdd(c, (u64)x); break;
    case R_MAX_I: atomicMax(c, (u64)x ^ RADIX_SIGN); break;
    default: atomicMax(c, ~((u64)x ^ RADIX_SIGN)); break;   // MIN_I, FIRST
  }
}

__device__ __forceinline__ i64 k15_cell_value(int op, u64 c) {
  switch (op) {
    case R_COUNT: return 0;
    case R_SUM_I: return (i64)c;
    case R_MAX_I: return (i64)(c ^ RADIX_SIGN);
    default: return (i64)(~c ^ RADIX_SIGN);
  }
}

#define K15_CHUNK 4   // slots whose folds a warp runs side by side

// One reduction of a warp's K15_ROWS x 32 rows into the running values of
// the group's slots: slot j takes row i of a thread where bit j of
// take[i] is set; a thread merges its rows in order, then the warp folds,
// K15_CHUNK slots side by side. wn / wv point at the reduction's cell of
// slot 0 and this warp; slot j's is j * stride further.
template <int OP>
__device__ __forceinline__ void k15_fold(const u64 (&take)[K15_ROWS], const i64 (&x)[K15_ROWS],
                                         int ns, int stride, i64* wn, i64* wv, int lane) {
  for (int j0 = 0; j0 < ns; j0 += K15_CHUNK) {
    int cnt[K15_CHUNK];
    i64 v[K15_CHUNK];
    unsigned any = 0;
#pragma unroll
    for (int u = 0; u < K15_CHUNK; ++u) {
      cnt[u] = 0;
      v[u] = val_ident(OP);
#pragma unroll
      for (int i = 0; i < K15_ROWS; ++i) {
        const bool c = j0 + u < ns && ((take[i] >> (j0 + u)) & 1ull);
        const unsigned cb = __ballot_sync(0xffffffffu, c);
        any |= cb;
        cnt[u] += __popc(cb);
        if (OP != R_COUNT && c) v[u] = val_merge(OP, v[u], x[i]);
      }
    }
    if (!any) continue;
    if (OP != R_COUNT) {
#pragma unroll
      for (int u = 0; u < K15_CHUNK; ++u) v[u] = k15_warp_fold<OP>(v[u]);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < K15_CHUNK; ++u) {
        if (!cnt[u]) continue;
        const int q = (j0 + u) * stride;
        wn[q] += cnt[u];
        if (OP != R_COUNT) wv[q] = val_merge(OP, wv[q], v[u]);
      }
    }
  }
}

template <class Prm>
__global__ void __launch_bounds__(K15_THREADS)
slot_agg_kernel(const __grid_constant__ Prm p, i64 n, int k, int P, int per_group,
                int n_instr, int n_inv, int where_reg, int n_regs, int n_red,
                i64 tiles_per_block, const unsigned char* __restrict__ live,
                unsigned* __restrict__ ticket, u64* __restrict__ cells,
                i64* __restrict__ partial, i64* __restrict__ out) {
  extern __shared__ i64 k15_smem[];
  i64* ins = k15_smem;                                   // [6 * n_instr]
  i64* pool = ins + 6 * n_instr;                         // [per_group][P]
  i64* regs = pool + (size_t)per_group * P;              // [n_regs][K15_THREADS]
  i64* wn = regs + (size_t)n_regs * K15_THREADS;         // [pairs][K15_WARPS]
  i64* wv = wn + (size_t)per_group * n_red * K15_WARPS;  // [pairs][K15_WARPS]
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(k, s0 + per_group);
  const int ns = s1 - s0;
  const int pairs = ns * n_red;
  const int stride = n_red * K15_WARPS;
  const i64* desc = p.desc;
  for (int i = t; i < 6 * n_instr; i += K15_THREADS) ins[i] = p.ins[i];
  for (int i = t; i < ns * P; i += K15_THREADS) pool[i] = p.pools[(i64)s0 * P + i];
  for (int i = t; i < pairs * K15_WARPS; i += K15_THREADS) {
    wn[i] = 0;
    wv[i] = val_ident((int)desc[RED_DESC * ((i / K15_WARPS) % n_red)]);
  }
  __syncthreads();

  VmSmemRegs R = {regs + t, K15_THREADS, 0u};
  const VmPlanes pl = {p.planes};
  const i64 tile0 = (i64)blockIdx.x * tiles_per_block;
  for (i64 tile = tile0; tile < tile0 + tiles_per_block; ++tile) {
    const i64 row0 = tile * K15_TILE + t;
    if (row0 >= n) break;   // whole warps: n is a multiple of 64
    // each of the thread's rows: the invariant part once, then each
    // slot's part: bit j of mb[i], row i passes slot s0 + j's WHERE
    u64 mb[K15_ROWS];
#pragma unroll
    for (int i = 0; i < K15_ROWS; ++i) {
      const i64 row = row0 + (i64)i * K15_THREADS;
      mb[i] = 0ull;
      if (row >= n) continue;             // whole warps
      vm_exec(ins, 0, n_inv, row, pool, p.lut, pl, R);
      const bool lv = live[row] != 0;
      for (int s = s0; s < s1; ++s) {
        vm_exec(ins, n_inv, n_instr, row, pool + (size_t)(s - s0) * P, p.lut, pl, R);
        const bool m = lv && (where_reg < 0 || (R.valid(where_reg) && R.val(where_reg) != 0));
        mb[i] |= (u64)m << (s - s0);
      }
    }
    u64 anym = 0;
#pragma unroll
    for (int i = 0; i < K15_ROWS; ++i) anym |= mb[i];
    if (!__any_sync(0xffffffffu, anym != 0ull)) continue;
    // each reduction's value and valid planes once a row, folded into
    // every slot of the group
    for (int r = 0; r < n_red; ++r) {
      const i64* d = desc + RED_DESC * r;
      if (d[1] & K15_SAME) continue;      // an earlier reduction's twin
      i64 x[K15_ROWS];
      u64 take[K15_ROWS];
#pragma unroll
      for (int i = 0; i < K15_ROWS; ++i) {
        const i64 row = row0 + (i64)i * K15_THREADS;
        x[i] = 0;
        take[i] = row < n && red_value(d, row, &x[i]) ? mb[i] : 0ull;
      }
      i64* cn = wn + r * K15_WARPS + w;
      i64* cv = wv + r * K15_WARPS + w;
      switch ((int)d[0]) {
        case R_COUNT: k15_fold<R_COUNT>(take, x, ns, stride, cn, cv, lane); break;
        case R_SUM_I: k15_fold<R_SUM_I>(take, x, ns, stride, cn, cv, lane); break;
        case R_SUM_F: k15_fold<R_SUM_F>(take, x, ns, stride, cn, cv, lane); break;
        case R_MIN_I: k15_fold<R_MIN_I>(take, x, ns, stride, cn, cv, lane); break;
        case R_MAX_I: k15_fold<R_MAX_I>(take, x, ns, stride, cn, cv, lane); break;
        case R_MIN_F: k15_fold<R_MIN_F>(take, x, ns, stride, cn, cv, lane); break;
        case R_MAX_F: k15_fold<R_MAX_F>(take, x, ns, stride, cn, cv, lane); break;
        default: k15_fold<R_FIRST>(take, x, ns, stride, cn, cv, lane); break;
      }
    }
  }
  __syncthreads();

  // the block's fold per (slot, reduction): its warps in order; an
  // integer reduction's into the stream's running cells by integer
  // atomics (any order gives the same bits), an f64 one's as the block's
  // partial
  const i64 G = gridDim.x;
  for (int i = t; i < pairs; i += K15_THREADS) {
    const int r = i % n_red;
    const int op = (int)desc[RED_DESC * r];
    if (desc[RED_DESC * r + 1] & K15_SAME) continue;
    Acc a = acc_init(op);
    for (int j = 0; j < K15_WARPS; ++j) {
      const Acc b = {wn[i * K15_WARPS + j], wv[i * K15_WARPS + j]};
      a = acc_merge(op, a, b);
    }
    const i64 pair = (i64)(s0 + i / n_red) * n_red + r;
    if (k15_f64(op)) {
      i64* q = partial + 2 * (pair * G + blockIdx.x);
      q[0] = a.n;
      q[1] = a.v;
    } else if (a.n) {
      u64* c = cells + 2 * pair;
      atomicAdd(c, (u64)a.n);
      if (op != R_COUNT) k15_cell_fold(op, c + 1, a.v);
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(ticket + blockIdx.y, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the group's last block: each integer cell read; each f64 pair's
  // partials folded, lane l the blocks l, l + 32, ... in order, then a
  // tree in lane order; then a twin copies its reduction's result and
  // the integer cells go back to their identity (0)
  for (int i = t; i < pairs; i += K15_THREADS) {
    const int r = i % n_red;
    const int op = (int)desc[RED_DESC * r];
    if (k15_f64(op) || (desc[RED_DESC * r + 1] & K15_SAME)) continue;
    const i64 pair = (i64)(s0 + i / n_red) * n_red + r;
    const u64* c = cells + 2 * pair;
    out[2 * pair] = (i64)__ldcg(c);
    out[2 * pair + 1] = k15_cell_value(op, __ldcg(c + 1));
  }
  for (int i = w; i < pairs; i += K15_WARPS) {
    const int r = i % n_red;
    const int op = (int)desc[RED_DESC * r];
    if (!k15_f64(op) || (desc[RED_DESC * r + 1] & K15_SAME)) continue;
    const i64 pair = (i64)(s0 + i / n_red) * n_red + r;
    const i64* src = partial + 2 * pair * G;
    Acc a = acc_init(op);
    for (i64 b = lane; b < G; b += 32) {
      const Acc c = {__ldcg(src + 2 * b), __ldcg(src + 2 * b + 1)};
      a = acc_merge(op, a, c);
    }
    a = warp_merge(op, a);
    if (lane == 0) {
      out[2 * pair] = a.n;
      out[2 * pair + 1] = a.v;
    }
  }
  __syncthreads();
  for (int i = t; i < pairs; i += K15_THREADS) {
    const int r = i % n_red;
    const i64* d = desc + RED_DESC * r;
    const i64 slot = s0 + i / n_red;
    const i64 pair = slot * n_red + r;
    if (d[1] & K15_SAME) {
      const i64 twin = slot * n_red + d[2];
      out[2 * pair] = out[2 * twin];
      out[2 * pair + 1] = out[2 * twin + 1];
    } else if (!k15_f64((int)d[0])) {
      u64* c = cells + 2 * pair;
      c[0] = 0ull;
      c[1] = 0ull;
    }
  }
  if (t == 0) ticket[blockIdx.y] = 0u;
}

template <class Prm>
static int k15_go(const Prm& p, i64 n, int k, int P, int n_instr, int n_inv, int where_reg,
                  int n_regs, int n_red, int groups, int per_group, int row_blocks,
                  i64 tiles_per_block, const unsigned char* live, char* scratch, i64* out,
                  cudaStream_t st) {
  const size_t smem = 8 * (6 * (size_t)n_instr + (size_t)per_group * P +
                           (size_t)n_regs * K15_THREADS + 2 * (size_t)per_group * n_red * K15_WARPS);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)   // past the default: the opt-in
    e = cudaFuncSetAttribute(slot_agg_kernel<Prm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  slot_agg_kernel<Prm><<<dim3((unsigned)row_blocks, (unsigned)groups), K15_THREADS, smem, st>>>(
      p, n, k, P, per_group, n_instr, n_inv, where_reg, n_regs, n_red, tiles_per_block, live,
      (unsigned*)(scratch + K15_CELL_BYTES), (u64*)scratch,
      (i64*)(scratch + K15_CELL_BYTES + K15_TICKET_BYTES), out);
  return (int)cudaGetLastError();
}

// out: k * n_red * 2 int64, (count, value) per slot and reduction. n must
// be a multiple of 64. planes, ins (n_instr instructions, the first n_inv
// slot-invariant), pools (k x P), lut and desc (n_red descriptors) are
// host arrays; they ride by value. Registers 0 .. n_regs - 1 are the
// ones the program writes. The plan (kernels.slot_agg_plan): `groups`
// groups of `per_group` slots, `row_blocks` row blocks of
// `tiles_per_block` tiles of K15_TILE rows. scratch holds
// K15_CELL_BYTES of integer cells and K15_TICKET_BYTES of tickets, both 0
// as the last launch left them, then k * n_red * row_blocks partials of
// (count, value) for the f64 reductions.
extern "C" int slot_agg_launch(i64 n, int k, int P, const u64* planes, int n_planes,
                               const i64* ins, int n_instr, int n_inv, int where_reg, int n_regs,
                               const i64* pools, const unsigned char* lut, int lut_len,
                               const unsigned char* live, int n_red, const i64* desc,
                               int groups, int per_group, int row_blocks, i64 tiles_per_block,
                               void* scratch, i64* out, void* stream) {
  if (n <= 0 || (n & 63) || k < 1 || k > 65535 || P < 1) return -1;
  if (n_red < 1 || n_red > K15_MAX_RED || n_inv < 0 || n_inv > n_instr || n_regs < 0 ||
      n_regs > K1_MAX_REGS || where_reg >= n_regs)
    return -1;
  // the plan covers every slot and row, each group holds a slot
  if (per_group < 1 || per_group > K15_MAX_GROUP || per_group * n_red > K15_MAX_PAIRS ||
      groups < 1 || groups > 65535 ||
      (i64)groups * per_group < k || (i64)(groups - 1) * per_group >= k || row_blocks < 1 ||
      tiles_per_block < 1 || (i64)row_blocks * tiles_per_block * K15_TILE < n ||
      (i64)(row_blocks - 1) * tiles_per_block * K15_TILE >= n)
    return -1;
  const i64 pool_words = (i64)k * P;
  cudaStream_t st = (cudaStream_t)stream;
  char* sc = (char*)scratch;
  if (slot_small(n_instr, pool_words, lut_len)) {
    SlotParamsSmall p;
    const int e = slot_fill(&p, planes, n_planes, ins, n_instr, pools, pool_words, lut, lut_len,
                            desc, n_red);
    return e ? e : k15_go(p, n, k, P, n_instr, n_inv, where_reg, n_regs, n_red, groups,
                          per_group, row_blocks, tiles_per_block, live, sc, out, st);
  }
  SlotParamsLarge p;
  const int e = slot_fill(&p, planes, n_planes, ins, n_instr, pools, pool_words, lut, lut_len,
                          desc, n_red);
  return e ? e : k15_go(p, n, k, P, n_instr, n_inv, where_reg, n_regs, n_red, groups, per_group,
                        row_blocks, tiles_per_block, live, sc, out, st);
}
