// K2 scalar_agg: masked reductions without GROUP BY.
//
// Replaces tidb_tpu/ops/kernels.py:713 build_scalar_agg_fn / :754
// _scalar_agg: per aggregate the count of contributing rows (mask & arg
// valid) and its sum (wrapping int64 or f64), min or max with the exact
// I64_MAX / I64_MIN / +-inf identities, or for first_row the count of
// mask rows and the smallest mask row index.
//
// Bound by bytes: the 1-byte mask once, and per reduction its 8-byte
// values and 1-byte valid plane once. The first design (a loop over the
// reductions around the row loop, a descriptor table re-read per row, one
// dependent scalar load chain per thread, a one-thread fold of the
// partials) was latency-bound at 14 % of the card's bandwidth. This one:
// - descriptors by value: up to K2_MAX_REDS reductions ride in the kernel's
//   parameter block (__grid_constant__ K2Args), so a call uploads nothing
//   and the row loop reads no descriptor from device memory; the wrapper
//   runs more reductions as several launches, in order;
// - one read of every plane: a thread loads K2_UNROLL 16-row mask words
//   (16-byte loads) once and folds every reduction over them; a
//   reduction's 16 valid bytes come in one 16-byte load (all of a thread's
//   words' at once, where a mask byte is set) and its values two rows to a
//   16-byte load, only for row pairs with a contributing row, so a
//   selective WHERE reads few value sectors; the op is a template
//   parameter, dispatched once per reduction and step; a word's value
//   loads are all issued (predicated) before the first is folded; at most
//   64 registers, so that four blocks of 256 threads stay resident per SM
//   (K2_UNROLL and K2_MINB were chosen by timing variants on the card);
// - any alignment: the rows before the mask's first 16-byte boundary and
//   after its last full word (fewer than 16 each) are folded one by one by
//   the first warp of block 0; a plane whose 16-byte phase differs from
//   the mask's (a view at another offset) is read with scalar loads;
// - a persistent grid (the card's SMs times the resident blocks), each
//   block a fixed contiguous slice of mask words; a thread folds its rows
//   in order, a warp its lanes by a fixed butterfly, into a per-warp
//   running value in shared memory, and the block its warps in order;
// - the last block to finish (an integer ticket, which decides no order)
//   folds the per-block partials: each thread a fixed strided set of
//   blocks, then the warps' butterflies, then the warps in order.
// No floating-point atomics, so f64 sums are bit-identical from run to run
// (the order is another than the first design's: the last bits may
// differ from its sums).
#include <cstring>

#include "common.cuh"

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_UNROLL 2     // 16-row mask words a thread holds per step
#define K2_MINB 4       // resident blocks a launch bound asks for
#define K2_MAX_REDS 64

// One reduction, passed by value (kernels.K2Red mirrors this layout).
struct K2Red {
  i64 op;
  i64 flags;
  i64 const_bits;
  const i64* values;
  const unsigned char* valid;
};

struct K2Args {
  i64 n;
  const unsigned char* mask;
  i64 head;                  // rows before the mask's first 16-byte boundary
  i64 words;                 // full 16-row mask words after the head
  i64* partial;              // [n_red][gridDim.x][2]
  unsigned int* ticket;      // 0 between launches
  i64* out_n;                // [n_red] counts
  i64* out_v;                // [n_red] values
  int n_red;
  K2Red red[K2_MAX_REDS];
};

// Each byte of a 0/1 word as 0 or 1, whatever nonzero value it holds.
__device__ __forceinline__ unsigned k2_bytes01(unsigned x) {
  return ((((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) >> 7) & 0x01010101u;
}

__device__ __forceinline__ uint4 k2_norm(uint4 m) {
  return make_uint4(k2_bytes01(m.x), k2_bytes01(m.y), k2_bytes01(m.z), k2_bytes01(m.w));
}

__device__ __forceinline__ unsigned k2_byte(const uint4& c, int b) {
  const unsigned w = b < 4 ? c.x : b < 8 ? c.y : b < 12 ? c.z : c.w;
  return (w >> (8 * (b & 3))) & 0xffu;
}

// Does row `row` (which passes the mask) contribute, and its value.
__device__ __forceinline__ bool k2_take(const K2Red& d, int op, i64 row, i64* x) {
  if (op == R_FIRST) { *x = row; return true; }
  if (d.flags & RED_NEVER) return false;
  if (d.valid != nullptr && !d.valid[row]) return false;
  *x = (d.flags & RED_CONST) ? d.const_bits : d.values[row];
  return true;
}

// Are the valid and values planes in the mask's 16-byte phase?
__device__ __forceinline__ bool k2_vec(const K2Red& d, i64 head) {
  const bool ok_valid = d.valid == nullptr || (((size_t)(d.valid + head)) & 15) == 0;
  const bool ok_vals = (d.flags & RED_CONST) || d.values == nullptr ||
                       (((size_t)(d.values + head)) & 15) == 0;
  return ok_valid && ok_vals;
}

// The first mask row of rows row0 .. row0 + 15 and their count into `a`.
__device__ __forceinline__ void k2_first(i64 row0, uint4 m, Acc& a) {
  if ((m.x | m.y | m.z | m.w) == 0u) return;
  a.n += __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
  const int j = m.x ? 0 : m.y ? 1 : m.z ? 2 : 3;
  const unsigned w = j == 0 ? m.x : j == 1 ? m.y : j == 2 ? m.z : m.w;
  const i64 first = row0 + 4 * j + (__ffs((int)w) - 1) / 8;
  if (first < a.v) a.v = first;
}

// The contributing bytes (0/1) of rows row0 .. row0 + 15: mask & valid.
__device__ __forceinline__ uint4 k2_contrib(const K2Red& d, i64 row0, uint4 m, bool vec) {
  if ((m.x | m.y | m.z | m.w) == 0u || d.valid == nullptr) return m;
  uint4 v;
  if (vec) {
    v = __ldg((const uint4*)(d.valid + row0));
  } else {
    unsigned b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i) b[i >> 2] |= (unsigned)d.valid[row0 + i] << (8 * (i & 3));
    v = make_uint4(b[0], b[1], b[2], b[3]);
  }
  v = k2_norm(v);
  return make_uint4(m.x & v.x, m.y & v.y, m.z & v.z, m.w & v.w);
}

// Fold the contributing rows (bytes c) of row0 .. row0 + 15 into `a`:
// every needed value load is issued (predicated) before the first fold.
template <int OP>
__device__ __forceinline__ void k2_word(const K2Red& d, i64 row0, uint4 c, bool vec, Acc& a) {
  if ((c.x | c.y | c.z | c.w) == 0u) return;
  if (OP == R_COUNT) {
    a.n += __popc(c.x) + __popc(c.y) + __popc(c.z) + __popc(c.w);
    return;
  }
  i64 x[16];
  if (d.flags & RED_CONST) {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = d.const_bits;
  } else if (vec) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      longlong2 q = make_longlong2(0, 0);
      if (k2_byte(c, 2 * p) | k2_byte(c, 2 * p + 1))
        q = __ldg((const longlong2*)(d.values + row0 + 2 * p));
      x[2 * p] = q.x;
      x[2 * p + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = k2_byte(c, i) ? d.values[row0 + i] : 0;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k2_byte(c, i)) acc_add(OP, a, x[i]);
}

// One reduction over a thread's K2_UNROLL mask words, folded into its
// warp's running value (sn[w], sv[w]). The valid words of all of them
// are loaded before any value is.
template <int OP>
__device__ __forceinline__ void k2_fold(const K2Red& d, i64 head, i64 base, const uint4* m,
                                        i64* sn, i64* sv) {
  if (OP != R_FIRST && (d.flags & RED_NEVER)) return;
  Acc acc = acc_init(OP);
  if (OP == R_FIRST) {
#pragma unroll
    for (int u = 0; u < K2_UNROLL; ++u)
      k2_first(head + 16 * (base + u * K2_THREADS + threadIdx.x), m[u], acc);
  } else {
    const bool vec = k2_vec(d, head);
    uint4 c[K2_UNROLL];
#pragma unroll
    for (int u = 0; u < K2_UNROLL; ++u)
      c[u] = k2_contrib(d, head + 16 * (base + u * K2_THREADS + threadIdx.x), m[u], vec);
#pragma unroll 1
    for (int u = 0; u < K2_UNROLL; ++u)
      k2_word<OP>(d, head + 16 * (base + u * K2_THREADS + threadIdx.x), c[u], vec, acc);
  }
  acc = warp_merge(OP, acc);
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    const Acc s = {sn[w], sv[w]};
    const Acc r = acc_merge(OP, s, acc);
    sn[w] = r.n;
    sv[w] = r.v;
  }
}

__global__ void __launch_bounds__(K2_THREADS, K2_MINB) scalar_agg_kernel(const __grid_constant__ K2Args a) {
  __shared__ i64 s_n[K2_MAX_REDS][K2_WARPS];
  __shared__ i64 s_v[K2_MAX_REDS][K2_WARPS];
  __shared__ int s_last;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int i = t; i < a.n_red * K2_WARPS; i += K2_THREADS) {
    const int r = i / K2_WARPS;
    s_n[r][i % K2_WARPS] = 0;
    s_v[r][i % K2_WARPS] = val_ident((int)a.red[r].op);
  }
  __syncthreads();

  // the head (lanes 0-15) and the tail (lanes 16-31), one row a lane
  if (blockIdx.x == 0 && w == 0) {
    const i64 row = lane < 16 ? lane : a.head + 16 * a.words + (lane - 16);
    const bool in = lane < 16 ? row < a.head : row < a.n;
    const bool m = in && a.mask[row] != 0;
    for (int r = 0; r < a.n_red; ++r) {
      const int op = (int)a.red[r].op;
      Acc acc = acc_init(op);
      i64 x;
      if (m && k2_take(a.red[r], op, row, &x)) acc_add(op, acc, x);
      acc = warp_merge(op, acc);
      if (lane == 0) {
        s_n[r][0] = acc.n;
        s_v[r][0] = acc.v;
      }
    }
  }

  // the block's slice of 16-row mask words
  const i64 G = gridDim.x;
  const i64 w0 = a.words * blockIdx.x / G, w1 = a.words * (blockIdx.x + 1) / G;
  const uint4* mw = (const uint4*)(a.mask + a.head);
  for (i64 base = w0; base < w1; base += (i64)K2_THREADS * K2_UNROLL) {
    uint4 m[K2_UNROLL];
    bool any = false;
#pragma unroll
    for (int u = 0; u < K2_UNROLL; ++u) {
      const i64 i = base + u * K2_THREADS + t;
      m[u] = i < w1 ? k2_norm(__ldg(mw + i)) : make_uint4(0u, 0u, 0u, 0u);
      any |= (m[u].x | m[u].y | m[u].z | m[u].w) != 0u;
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    for (int r = 0; r < a.n_red; ++r) {
      const K2Red& d = a.red[r];
      i64* sn = s_n[r];
      i64* sv = s_v[r];
      switch ((int)d.op) {
        case R_COUNT: k2_fold<R_COUNT>(d, a.head, base, m, sn, sv); break;
        case R_SUM_I: k2_fold<R_SUM_I>(d, a.head, base, m, sn, sv); break;
        case R_SUM_F: k2_fold<R_SUM_F>(d, a.head, base, m, sn, sv); break;
        case R_MIN_I: k2_fold<R_MIN_I>(d, a.head, base, m, sn, sv); break;
        case R_MAX_I: k2_fold<R_MAX_I>(d, a.head, base, m, sn, sv); break;
        case R_MIN_F: k2_fold<R_MIN_F>(d, a.head, base, m, sn, sv); break;
        case R_MAX_F: k2_fold<R_MAX_F>(d, a.head, base, m, sn, sv); break;
        default: k2_fold<R_FIRST>(d, a.head, base, m, sn, sv); break;
      }
    }
  }
  __syncthreads();

  // the block's partial per reduction: its warps in order
  for (int r = t; r < a.n_red; r += K2_THREADS) {
    const int op = (int)a.red[r].op;
    Acc s = acc_init(op);
    for (int j = 0; j < K2_WARPS; ++j) {
      const Acc q = {s_n[r][j], s_v[r][j]};
      s = acc_merge(op, s, q);
    }
    i64* p = a.partial + 2 * ((i64)r * G + blockIdx.x);
    p[0] = s.n;
    p[1] = s.v;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.ticket, 1u) == (unsigned)(G - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block folds the blocks' partials: thread t the blocks t,
  // t + K2_THREADS, ... in order, then its warp's butterfly, then the
  // warps in order
  for (int r = 0; r < a.n_red; ++r) {
    const int op = (int)a.red[r].op;
    Acc s = acc_init(op);
    for (i64 b = t; b < G; b += K2_THREADS) {
      const i64* p = a.partial + 2 * ((i64)r * G + b);
      const Acc q = {__ldcg(p), __ldcg(p + 1)};
      s = acc_merge(op, s, q);
    }
    s = warp_merge(op, s);
    if (lane == 0) {
      s_n[r][w] = s.n;
      s_v[r][w] = s.v;
    }
  }
  __syncthreads();
  for (int r = t; r < a.n_red; r += K2_THREADS) {
    const int op = (int)a.red[r].op;
    Acc s = acc_init(op);
    for (int j = 0; j < K2_WARPS; ++j) {
      const Acc q = {s_n[r][j], s_v[r][j]};
      s = acc_merge(op, s, q);
    }
    a.out_n[r] = s.n;
    a.out_v[r] = s.v;
  }
  if (t == 0) *a.ticket = 0u;
}

// The most blocks a launch uses on the current device (SMs x resident
// blocks): the partials buffer holds 2 int64 per reduction and block
// (the wrapper asks once per device).
extern "C" int scalar_agg_grid() {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, scalar_agg_kernel, K2_THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  return sms * (occ > 0 ? occ : 1);
}

// One launch over n rows for n_red <= K2_MAX_REDS reductions `reds` (host
// memory, copied into the parameter block); counts to out_n[n_red], values
// to out_v[n_red]; at most gmax blocks (scalar_agg_grid). partial holds
// gmax * K2_MAX_REDS * 2 int64; ticket is 0.
extern "C" int scalar_agg_launch(i64 n, const unsigned char* mask, int n_red, const K2Red* reds,
                                 i64* partial, unsigned int* ticket, i64* out_n, i64* out_v,
                                 int gmax, void* stream) {
  if (n < 0 || n_red <= 0 || n_red > K2_MAX_REDS || gmax <= 0) return -1;
  K2Args a;
  memset(&a, 0, sizeof(a));
  i64 head = (16 - (i64)(((size_t)mask) & 15)) & 15;
  if (head > n) head = n;
  a.n = n;
  a.mask = mask;
  a.head = head;
  a.words = (n - head) / 16;
  a.partial = partial;
  a.ticket = ticket;
  a.out_n = out_n;
  a.out_v = out_v;
  a.n_red = n_red;
  memcpy(a.red, reds, sizeof(K2Red) * (size_t)n_red);
  i64 g = (a.words + K2_THREADS - 1) / K2_THREADS;
  if (g < 1) g = 1;
  if (g > gmax) g = gmax;
  scalar_agg_kernel<<<(unsigned)g, K2_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
