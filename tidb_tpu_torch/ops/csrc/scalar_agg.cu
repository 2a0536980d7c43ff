// K2 scalar_agg: masked reductions without GROUP BY.
//
// Replaces tidb_tpu/ops/kernels.py:713 build_scalar_agg_fn / :754
// _scalar_agg: per aggregate the count of contributing rows (mask & arg
// valid) and its sum (wrapping int64 or f64), min or max with the exact
// I64_MAX / I64_MIN / +-inf identities, or for first_row the count of
// mask rows and the smallest mask row index.
//
// Bound by bytes: each reduction reads the 1-byte mask and, where it has
// them, its 8-byte values and 1-byte valid plane once. Pass 1 gives every
// block a fixed slice of the rows (grid-stride) and reduces it with a
// fixed-order shared-memory tree; pass 2, one block, folds the per-block
// partials in block order. No atomics, so f64 sums are bit-identical from
// run to run.
#include "common.cuh"

#define K2_THREADS 256

__global__ void scalar_agg_partial(i64 n, const unsigned char* __restrict__ mask,
                                   int n_red, const i64* __restrict__ desc,
                                   i64* __restrict__ partial) {
  __shared__ i64 sn[K2_THREADS];
  __shared__ i64 sv[K2_THREADS];
  const int t = threadIdx.x;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (int r = 0; r < n_red; ++r) {
    const i64* d = desc + RED_DESC * r;
    const int op = (int)d[0];
    Acc a = acc_init(op);
    for (i64 row = (i64)blockIdx.x * blockDim.x + t; row < n; row += stride) {
      i64 x;
      if (red_take(d, mask, row, &x)) acc_add(op, a, x);
    }
    const Acc b = block_merge<K2_THREADS>(op, a, sn, sv);
    if (t == 0) {
      i64* p = partial + 2 * ((i64)r * gridDim.x + blockIdx.x);
      p[0] = b.n;
      p[1] = b.v;
    }
    __syncthreads();
  }
}

__global__ void scalar_agg_combine(int n_red, int n_blocks, const i64* __restrict__ desc,
                                   const i64* __restrict__ partial, i64* __restrict__ out) {
  const int r = threadIdx.x;
  if (r >= n_red) return;
  const int op = (int)desc[RED_DESC * r];
  Acc a = acc_init(op);
  for (int b = 0; b < n_blocks; ++b) {
    const i64* p = partial + 2 * ((i64)r * n_blocks + b);
    Acc q = {p[0], p[1]};
    a = acc_merge(op, a, q);
  }
  out[2 * r] = a.n;
  out[2 * r + 1] = a.v;
}

// Number of pass-1 blocks for n rows: the size of the partials buffer the
// caller allocates (2 int64 per reduction and block).
extern "C" int scalar_agg_blocks(i64 n) {
  i64 b = (n + K2_THREADS * 8 - 1) / (K2_THREADS * 8);
  if (b < 1) b = 1;
  if (b > 132 * 4) b = 132 * 4;
  return (int)b;
}

extern "C" int scalar_agg_launch(i64 n, const unsigned char* mask, int n_red,
                                 const i64* desc, i64* partial, i64* out, void* stream) {
  if (n_red <= 0 || n_red > 1024) return -1;
  const int blocks = scalar_agg_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  scalar_agg_partial<<<blocks, K2_THREADS, 0, s>>>(n, mask, n_red, desc, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scalar_agg_combine<<<1, 1024, 0, s>>>(n_red, blocks, desc, partial, out);
  return (int)cudaGetLastError();
}
