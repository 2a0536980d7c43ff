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
// Bound by bytes: the program's planes, the live byte and each reduction's
// value and valid planes read once per row per slot (the slot axis is in
// the grid, so a slot's blocks re-read what the others read: k times the
// bytes of one statement, most of it from L2 at the tier's batch sizes).
#include "vm.cuh"

#define K15_THREADS 256
#define K15_MAX_RED 9

__global__ void __launch_bounds__(K15_THREADS)
slot_agg_partial(i64 n, const i64* __restrict__ meta, int meta_len,
                 const i64* __restrict__ params, int P, const unsigned char* __restrict__ lut,
                 const u64* __restrict__ planes, int n_planes, unsigned valid_bits,
                 const unsigned char* __restrict__ live, int n_red,
                 const i64* __restrict__ desc, i64* __restrict__ partial) {
  __shared__ i64 sm[K1_MAX_META];
  __shared__ i64 sn[K15_THREADS];
  __shared__ i64 sv[K15_THREADS];
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x) sm[i] = meta[i];
  __syncthreads();
  const int n_instr = (int)sm[0];
  const int where_reg = (int)sm[1];
  const i64* ins = sm + K1_HDR;
  const i64* pool = params + (i64)blockIdx.y * P;
  const int t = threadIdx.x;
  Acc acc[K15_MAX_RED];
#pragma unroll
  for (int r = 0; r < K15_MAX_RED; ++r)
    if (r < n_red) acc[r] = acc_init((int)desc[RED_DESC * r]);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + t; row < n; row += stride) {
    VmRow pr;
    pr.load(planes, n_planes, valid_bits, row);
    i64 v[K1_MAX_REGS];
    bool ok[K1_MAX_REGS];
    vm_run(ins, n_instr, row, pool, lut, pr, v, ok);
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
      i64* p = partial + 2 * (((i64)blockIdx.y * gridDim.x + blockIdx.x) * n_red + r);
      p[0] = b.n;
      p[1] = b.v;
    }
    __syncthreads();
  }
}

__global__ void slot_agg_combine(int n_red, int n_blocks, const i64* __restrict__ desc,
                                 const i64* __restrict__ partial, i64* __restrict__ out) {
  const int r = threadIdx.x;
  const i64 s = blockIdx.x;
  if (r >= n_red) return;
  const int op = (int)desc[RED_DESC * r];
  Acc a = acc_init(op);
  for (int b = 0; b < n_blocks; ++b) {
    const i64* p = partial + 2 * ((s * n_blocks + b) * n_red + r);
    Acc q = {p[0], p[1]};
    a = acc_merge(op, a, q);
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

// out: k * n_red * 2 int64, (count, value) per slot and reduction.
extern "C" int slot_agg_launch(i64 n, int k, const i64* meta, int meta_len, const i64* params,
                               int P, const unsigned char* lut, const u64* planes,
                               int n_planes, unsigned valid_bits, const unsigned char* live,
                               int n_red, const i64* desc, i64* partial, i64* out,
                               void* stream) {
  if (meta_len > K1_MAX_META || meta_len < K1_HDR) return -1;
  if (n <= 0 || k < 1 || k > 65535 || P < 1) return -1;
  if (n_red < 1 || n_red > K15_MAX_RED) return -1;
  if (n_planes < 0 || n_planes > VM_ROW_PLANES) return -1;
  const int blocks = slot_agg_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  slot_agg_partial<<<dim3((unsigned)blocks, (unsigned)k), K15_THREADS, 0, st>>>(
      n, meta, meta_len, params, P, lut, planes, n_planes, valid_bits, live, n_red, desc,
      partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  slot_agg_combine<<<(unsigned)k, 32, 0, st>>>(n_red, blocks, desc, partial, out);
  return (int)cudaGetLastError();
}
