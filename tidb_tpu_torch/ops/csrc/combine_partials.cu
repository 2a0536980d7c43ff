// K7 combine_partials: merge per-region partial states over the region
// axis.
//
// Replaces tidb_tpu/ops/kernels.py:1082 combine_region_partials: states
// [R, G_i] (int64, or the bits of f64) with a combine monoid each (sum,
// min, max) fold over r into [G_i]. All states of a statement go in one
// launch: a descriptor of K7_DESC int64 per state (op, element offset of
// its [R, G] block in the packed input, G, element offset of its [G]
// output; outputs are packed in state order) and one thread per (state,
// group), which finds its state by binary search and folds r = 0..R-1 in
// order. int64 sums wrap as jnp.sum does; f64 sums add in region order;
// min and max are exact. At TPC-H Q1's 8 regions x 4 groups the kernel
// is bound by its launch, not by its 8 * R * G bytes.
#include "common.cuh"

#define K7_DESC 4

__global__ void combine_partials_kernel(int n_states, int R, const i64* __restrict__ desc,
                                        const i64* __restrict__ in, i64* __restrict__ out,
                                        i64 total) {
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // state of this thread: the last state whose first output index <= idx
  int lo = 0, hi = n_states - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (desc[K7_DESC * mid + 3] <= idx) lo = mid; else hi = mid - 1;
  }
  const i64* d = desc + K7_DESC * lo;
  const int op = (int)d[0];
  const i64 G = d[2];
  const i64 g = idx - d[3];
  const i64* s = in + d[1];
  i64 a = s[g];
  for (int r = 1; r < R; ++r) a = val_merge(op, a, s[(i64)r * G + g]);
  out[d[3] + g] = a;
}

extern "C" int combine_partials_launch(int n_states, int R, const i64* desc,
                                       const i64* in, i64* out,
                                       i64 total, void* stream) {
  if (n_states < 1 || R < 1) return -1;
  if (total <= 0) return 0;
  combine_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      n_states, R, desc, in, out, total);
  return (int)cudaGetLastError();
}
