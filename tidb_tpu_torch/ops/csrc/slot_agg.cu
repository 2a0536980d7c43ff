// K15 slot_agg: the scalar aggregates of k statements of one shape over
// one batch, each under its own WHERE literals, in one launch.
//
// Replaces tidb_tpu/ops/sched.py:439 _build_agg_wrapper: jax.vmap over
// the statement slots of the WHERE mask fused with every aggregate's
// masked count and sum / min / max (the sentinels of kernels._scalar_agg
// where no row contributes). Here the reductions are K2's descriptors
// (common.cuh), the first one the count of rows passing the WHERE.
//
// Pass 1, grid (row blocks) x (slots): each thread loads a row's
// referenced planes once (VmRow), runs the shared program with its slot's
// constant pool and folds the row into every reduction; a fixed-order
// shared-memory tree reduces the block. Pass 2, a block per slot, folds
// the blocks' partials in block order. No floating-point atomics (no
// atomics at all), so f64 extrema and int64 sums repeat bit for bit; the
// int64 sums are exact because the lowering refuses a sum that could wrap
// (max_abs * n_rows).
//
// Its arguments take K14's path (vm.cuh SlotParams): the plane pointers,
// the program, the pools, the reduction descriptors and the LUT ride by
// value in the launch's parameters, so a launch copies nothing to the
// card first.
//
// Bound by bytes: the program's planes, the live byte and each reduction's
// value and valid planes read once per row per slot (the slot axis is in
// the grid, so a slot's blocks re-read what the others read: k times the
// bytes of one statement, most of it from L2 at the tier's batch sizes).
#include "vm.cuh"

#define K15_THREADS 256
#define K15_MAX_RED SLOT_MAX_RED

template <class Prm>
__global__ void __launch_bounds__(K15_THREADS)
slot_agg_partial(const __grid_constant__ Prm p, i64 n, int n_instr, int where_reg, int P,
                 int n_planes, unsigned valid_bits, const unsigned char* __restrict__ live,
                 int n_red, i64* __restrict__ partial) {
  __shared__ i64 sm[6 * SLOT_MAX_INSTR];
  __shared__ i64 sn[K15_THREADS];
  __shared__ i64 sv[K15_THREADS];
  for (int i = threadIdx.x; i < 6 * n_instr; i += blockDim.x) sm[i] = p.ins[i];
  __syncthreads();
  const i64* ins = sm;
  const i64* pool = p.pools + (i64)blockIdx.y * P;
  const i64* desc = p.desc;
  const int t = threadIdx.x;
  Acc acc[K15_MAX_RED];
#pragma unroll
  for (int r = 0; r < K15_MAX_RED; ++r)
    if (r < n_red) acc[r] = acc_init((int)desc[RED_DESC * r]);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + t; row < n; row += stride) {
    VmRow pr;
    pr.load(p.planes, n_planes, valid_bits, row);
    i64 v[K1_MAX_REGS];
    bool ok[K1_MAX_REGS];
    vm_run(ins, n_instr, row, pool, p.lut, pr, v, ok);
    bool m = live[row] != 0;
    if (where_reg >= 0) m = m && ok[where_reg] && v[where_reg] != 0;
    if (!m) continue;
#pragma unroll
    for (int r = 0; r < K15_MAX_RED; ++r) {
      i64 x;
      if (r < n_red && red_value(desc + RED_DESC * r, row, &x))
        acc_add((int)desc[RED_DESC * r], acc[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < K15_MAX_RED; ++r) {
    if (r >= n_red) break;
    const Acc b = block_merge<K15_THREADS>((int)desc[RED_DESC * r], acc[r], sn, sv);
    if (t == 0) {
      i64* q = partial + 2 * (((i64)blockIdx.y * gridDim.x + blockIdx.x) * n_red + r);
      q[0] = b.n;
      q[1] = b.v;
    }
    __syncthreads();
  }
}

// The reductions' ops, by value.
struct K15Ops {
  int op[K15_MAX_RED];
};

__global__ void slot_agg_combine(int n_red, int n_blocks, const __grid_constant__ K15Ops ops,
                                 const i64* __restrict__ partial, i64* __restrict__ out) {
  const int r = threadIdx.x;
  const i64 s = blockIdx.x;
  if (r >= n_red) return;
  const int op = ops.op[r];
  Acc a = acc_init(op);
  for (int b = 0; b < n_blocks; ++b) {
    const i64* q = partial + 2 * ((s * n_blocks + b) * n_red + r);
    Acc c = {q[0], q[1]};
    a = acc_merge(op, a, c);
  }
  out[2 * (s * n_red + r)] = a.n;
  out[2 * (s * n_red + r) + 1] = a.v;
}

// Pass-1 blocks per slot for n rows: the partials buffer holds
// k * blocks * n_red * 2 int64.
extern "C" int slot_agg_blocks(i64 n) {
  i64 b = (n + K15_THREADS * 8 - 1) / (K15_THREADS * 8);
  if (b < 1) b = 1;
  if (b > 132 * 4) b = 132 * 4;
  return (int)b;
}

template <class Prm>
static int k15_go(const Prm& p, i64 n, int k, int n_instr, int where_reg, int P, int n_planes,
                  unsigned valid_bits, const unsigned char* live, int n_red, const i64* desc,
                  i64* partial, i64* out, cudaStream_t st) {
  const int blocks = slot_agg_blocks(n);
  slot_agg_partial<Prm><<<dim3((unsigned)blocks, (unsigned)k), K15_THREADS, 0, st>>>(
      p, n, n_instr, where_reg, P, n_planes, valid_bits, live, n_red, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  K15Ops ops;
  for (int r = 0; r < n_red; ++r) ops.op[r] = (int)desc[RED_DESC * r];
  slot_agg_combine<<<(unsigned)k, 32, 0, st>>>(n_red, blocks, ops, partial, out);
  return (int)cudaGetLastError();
}

// out: k * n_red * 2 int64, (count, value) per slot and reduction.
// planes, ins (the program's n_instr instructions), pools (k x P), lut
// and desc (n_red descriptors) are host arrays; they ride by value.
extern "C" int slot_agg_launch(i64 n, int k, int P, const u64* planes, int n_planes,
                               unsigned valid_bits, const i64* ins, int n_instr, int where_reg,
                               const i64* pools, const unsigned char* lut, int lut_len,
                               const unsigned char* live, int n_red, const i64* desc,
                               i64* partial, i64* out, void* stream) {
  if (n <= 0 || k < 1 || k > 65535 || P < 1) return -1;
  if (n_red < 1 || n_red > K15_MAX_RED || where_reg >= K1_MAX_REGS) return -1;
  const i64 pool_words = (i64)k * P;
  cudaStream_t st = (cudaStream_t)stream;
  if (slot_small(n_instr, pool_words, lut_len)) {
    SlotParamsSmall p;
    const int e = slot_fill(&p, planes, n_planes, ins, n_instr, pools, pool_words, lut, lut_len,
                            desc, n_red);
    return e ? e : k15_go(p, n, k, n_instr, where_reg, P, n_planes, valid_bits, live, n_red,
                          desc, partial, out, st);
  }
  SlotParamsLarge p;
  const int e = slot_fill(&p, planes, n_planes, ins, n_instr, pools, pool_words, lut, lut_len,
                          desc, n_red);
  return e ? e : k15_go(p, n, k, n_instr, where_reg, P, n_planes, valid_bits, live, n_red, desc,
                        partial, out, st);
}
