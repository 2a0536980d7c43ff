// K13 dict_remap: the composite join key of one side, in its shared domain.
//
// Replaces tidb_tpu/ops/kernels.py:1877 dict_remap_keys, the device half of
// the dictionary key tier (tidb_tpu_torch/copr/dictionary.py lowers each
// key column of a string or multi-column equi-join to a KeySpec). One
// thread per row, one descriptor of K13_COL int64 per key column:
// (mode, is_f64, values pointer, valid pointer, table pointer, table
// length, cmax, stride). Per column the row's code is
//   codes  (mode 0): the value clipped to [0, cmax];
//   remap  (mode 1): the table entry at the value clipped to the table
//                    (0 for an empty table), clipped to [0, cmax];
//   domain (mode 2): the lower bound of the value among the sorted table
//                    (f64 compared as doubles after -0.0 -> +0.0),
//                    clipped to [0, cmax];
// the key is the sum of code * stride (mixed radix, int64), and the row is
// valid when every column's valid byte is. The search stops at the table's
// length, so the table needs no padding (the reference pads it to a
// bucket with a +sentinel).
//
// Bound by bytes: per row and column the value (8 B) and valid byte read;
// per row the key (8 B) and valid byte written; the tables (a few MB at
// most) stay in L2 under the searches and gathers.
#include "common.cuh"

#define K13_COL 8
#define K13_THREADS 256

enum K13Mode { K13_CODES = 0, K13_REMAP = 1, K13_DOMAIN = 2 };

__device__ __forceinline__ i64 k13_clip(i64 v, i64 hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// First index in a[0, len) whose value is >= x, as doubles.
__device__ __forceinline__ i64 lower_bound_f64(const double* a, i64 len, double x) {
  i64 lo = 0, hi = len;
  while (lo < hi) {
    const i64 mid = lo + ((hi - lo) >> 1);
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(K13_THREADS)
k13_remap(i64 n, int ncols, const i64* __restrict__ desc, i64* __restrict__ key,
          unsigned char* __restrict__ valid) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 k = 0;
  bool ok = true;
  for (int c = 0; c < ncols; ++c) {
    const i64* d = desc + (i64)K13_COL * c;
    const int mode = (int)d[0];
    const i64 v = ((const i64*)d[2])[i];
    const i64 tlen = d[5], cmax = d[6];
    i64 code;
    if (mode == K13_CODES) {
      code = k13_clip(v, cmax);
    } else if (mode == K13_REMAP) {
      code = tlen > 0 ? k13_clip(((const i64*)d[4])[k13_clip(v, tlen - 1)], cmax) : 0;
    } else if (d[1]) {
      double x = as_f64(v);
      if (x == 0.0) x = 0.0;
      code = k13_clip(lower_bound_f64((const double*)d[4], tlen, x), cmax);
    } else {
      code = k13_clip(lower_bound_i64((const i64*)d[4], 0, tlen, v), cmax);
    }
    k += (u64)code * (u64)d[7];
    ok = ok && ((const unsigned char*)d[3])[i] != 0;
  }
  key[i] = (i64)k;
  valid[i] = ok;
}

extern "C" int dict_remap_launch(i64 n, int ncols, const i64* desc, i64* key,
                                 unsigned char* valid, void* stream) {
  if (n < 1 || ncols < 1) return -1;
  const i64 nblk = (n + K13_THREADS - 1) / K13_THREADS;
  if (nblk > 0x7fffffff) return -1;
  k13_remap<<<(unsigned)nblk, K13_THREADS, 0, (cudaStream_t)stream>>>(n, ncols, desc, key,
                                                                       valid);
  return (int)cudaGetLastError();
}
