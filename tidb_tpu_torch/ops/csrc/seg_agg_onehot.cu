// K3 seg_agg_onehot: grouped reductions over at most 64 segments.
//
// Replaces the one-hot route of tidb_tpu/ops/kernels.py:903
// build_grouped_agg_fn (:945 _grouped_agg, SegCtx :599 with use_onehot,
// :640-670): per segment the count of contributing rows and their sum,
// min/max (sentinel when empty) or first row index. The group id comes
// from K1, with dead rows already in the last (sink) segment.
//
// The same O(S*N) work as the reference's one-hot reduction, shaped for
// a GPU: a block stages a tile of 1024 rows (group id, contribution flag,
// value) in shared memory, then each warp owns the segments s = warp,
// warp+8, ... and reduces the tile's rows of its segments with a
// fixed-order butterfly; lane 0 folds the result into the block's
// accumulator for that segment, which only that warp touches. Tiles are
// visited in a fixed order, pass 2 folds the per-block partials in block
// order, so sums are deterministic (no atomics). Each input byte is read
// from device memory once per reduction; with S <= 64 the shared-memory
// scans cost more issue slots than the loads, so for large S the bound is
// the operations, for small S (TPC-H Q1 has 13) the bytes.
#include "common.cuh"

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_TILE 1024
#define K3_MAX_SEG 64

__global__ void seg_onehot_partial(i64 n, const i64* __restrict__ gid,
                                   const unsigned char* __restrict__ mask, int n_seg,
                                   int n_red, const i64* __restrict__ desc,
                                   i64* __restrict__ partial) {
  __shared__ int g_s[K3_TILE];
  __shared__ unsigned char c_s[K3_TILE];
  __shared__ i64 v_s[K3_TILE];
  __shared__ i64 acc_n[K3_MAX_SEG];
  __shared__ i64 acc_v[K3_MAX_SEG];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const i64 n_tiles = (n + K3_TILE - 1) / K3_TILE;

  for (int r = 0; r < n_red; ++r) {
    const i64* d = desc + RED_DESC * r;
    const int op = (int)d[0];
    for (int s = t; s < n_seg; s += K3_THREADS) {
      Acc a = acc_init(op);
      acc_n[s] = a.n;
      acc_v[s] = a.v;
    }
    __syncthreads();
    for (i64 tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const i64 base = tile * K3_TILE;
      for (int i = t; i < K3_TILE; i += K3_THREADS) {
        const i64 row = base + i;
        i64 x = 0;
        bool take = false;
        int g = -1;
        if (row < n) {
          take = red_take(d, mask, row, &x);
          g = (int)gid[row];
        }
        g_s[i] = g;
        c_s[i] = take;
        v_s[i] = x;
      }
      __syncthreads();
      for (int s = warp; s < n_seg; s += K3_WARPS) {
        Acc a = acc_init(op);
        for (int i = lane; i < K3_TILE; i += 32) {
          if (c_s[i] && g_s[i] == s) acc_add(op, a, v_s[i]);
        }
        a = warp_merge(op, a);
        if (lane == 0) {
          Acc cur = {acc_n[s], acc_v[s]};
          cur = acc_merge(op, cur, a);
          acc_n[s] = cur.n;
          acc_v[s] = cur.v;
        }
      }
      __syncthreads();
    }
    for (int s = t; s < n_seg; s += K3_THREADS) {
      i64* p = partial + 2 * (((i64)r * n_seg + s) * gridDim.x + blockIdx.x);
      p[0] = acc_n[s];
      p[1] = acc_v[s];
    }
    __syncthreads();
  }
}

__global__ void seg_onehot_combine(int n_seg, int n_red, int n_blocks,
                                   const i64* __restrict__ desc,
                                   const i64* __restrict__ partial, i64* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;   // (reduction, segment)
  if (k >= n_red * n_seg) return;
  const int r = k / n_seg;
  const int op = (int)desc[RED_DESC * r];
  Acc a = acc_init(op);
  for (int b = 0; b < n_blocks; ++b) {
    const i64* p = partial + 2 * ((i64)k * n_blocks + b);
    Acc q = {p[0], p[1]};
    a = acc_merge(op, a, q);
  }
  out[2 * (i64)k] = a.n;
  out[2 * (i64)k + 1] = a.v;
}

extern "C" int seg_onehot_blocks(i64 n) {
  i64 b = (n + K3_TILE * 4 - 1) / (K3_TILE * 4);
  if (b < 1) b = 1;
  if (b > 132 * 4) b = 132 * 4;
  return (int)b;
}

extern "C" int seg_onehot_launch(i64 n, const i64* gid, const unsigned char* mask,
                                 int n_seg, int n_red, const i64* desc, i64* partial,
                                 i64* out, void* stream) {
  if (n_seg < 1 || n_seg > K3_MAX_SEG || n_red < 1) return -1;
  const int blocks = seg_onehot_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  seg_onehot_partial<<<blocks, K3_THREADS, 0, s>>>(n, gid, mask, n_seg, n_red, desc,
                                                   partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int total = n_red * n_seg;
  seg_onehot_combine<<<(total + 255) / 256, 256, 0, s>>>(n_seg, n_red, blocks, desc,
                                                         partial, out);
  return (int)cudaGetLastError();
}
