// K4 seg_agg_sorted: grouped reductions over more than 64 segments.
//
// Replaces the sorted route of tidb_tpu/ops/kernels.py:903
// build_grouped_agg_fn (SegCtx.sorted_ctx :621-652, sums by cumsum
// differences, min/max at run ends with the sentinel for empty segments
// :671-686): per (reduction, segment) its contributing rows' count n and
// value v, with the exact I64 sentinel or f64 +-inf where no row
// contributes. Two routes (ops/kernels.py k4_route), neither with a
// library sort:
//
// Windows (the block route of seg_block.cuh, which K6 shares): the
// segments are cut into at most K4_MAX_WINDOWS windows of W segments, W
// as many as one copy of a window's states fits in the opt-in shared
// memory the card reports. A persistent grid gives each window an equal
// share of the blocks; every block reads its slice of all the rows once,
// skips rows whose id falls outside its window, and folds the rest into
// its copy: integer states by shared-memory integer atomics, f64 states
// class-bucketed in row order, one warp a class. A segment keeps one
// state a slot: a count for each distinct (mask, valid) pair of its
// reductions, shared by the reductions that have it, and a value for each
// distinct (op, values, valid) (ops/kernels.py k4_slots), so Q1's eleven
// reductions keep twelve slots, not twenty-two. One window keeps its
// integer states in as many copies as fit (ops/kernels.py k4_copies, up
// to 16), lane l folding into copy l mod copies: Q1's largest group holds
// half a shard's rows, and one copy would pile half a warp's lanes onto
// one address a slot. Pass 2, a thread per (reduction, segment), folds
// the window's block partials in block order into (n, v). No float
// atomics: repeats are bit-identical.
//
// Past the cap, the sorted route: the caller sorts the group ids stably
// with the radix of radix.cuh (one pass per digit of the ids' bit
// length, row positions as payload), and the segmented pass of
// seg_sorted.cuh reduces the sorted runs; each sum is a sum of its own
// rows only, with no rounding carried from a prefix as in the reference's
// cumsum differences. The ranked and DISTINCT paths call this pass
// directly in their sorted space (ops/kernels.py seg_agg_presorted).
//
// Bound by bytes: 8 B of group id and 1 B of mask a row, and each
// reduction's 1 B of valid and 8 B of value, read once. The windows read
// them once a window (what is read for rows outside a window is loaded
// and dropped); the sorted route adds 8 B of sorted id and 8 B of
// permutation per row and gathers values at random (32-byte sectors for
// 8 bytes used).
#include <cstring>

#include "seg_block.cuh"
#include "seg_sorted.cuh"

// One statement's reductions: RED_DESC int64 descriptors (common.cuh)
// under one row mask; a segment's state is stored as (n, v).
struct K4Src {
  int n_red;
  const i64* desc;
  const unsigned char* mask;
  __device__ int op(int j) const { return (int)desc[RED_DESC * j]; }
  __device__ bool take(int j, i64 row, i64* x) const {
    return red_take(desc + RED_DESC * j, mask, row, x);
  }
  __device__ void store(i64* out, i64 n_seg, int j, i64 s, Acc a) const {
    out[2 * ((i64)j * n_seg + s)] = a.n;
    out[2 * ((i64)j * n_seg + s) + 1] = a.v;
  }
};

extern "C" int seg_sorted_pieces_count(i64 n) { return sorted_pieces_count(n); }

extern "C" int seg_sorted_launch(i64 n, const i64* gid_sorted, const i64* order,
                                 const unsigned char* mask, i64 n_seg, int n_red,
                                 const i64* desc, i64* part, i64* out, void* stream) {
  const K4Src src = {n_red, desc, mask};
  return sorted_launch(n, gid_sorted, order, n_seg, src, part, out, (cudaStream_t)stream);
}

// ---- windows: the block route over one region of global ids ----
// A slot is K4_SLOT int64: (op, flags, constant, values pointer, valid
// pointer); a count slot is (R_COUNT, 0, 1, 0, valid); R_FIRST's value
// slot has the K6B_ROW_VALUE flag. A reduction maps to K4_MAP int64:
// (op, its count slot, its value slot), -1 where it has none. The windows'
// table, the slots and the map ride by value in the launch's parameters
// (at most K4_WINDOWS_CAP windows and K4_MAX_REDS reductions): no upload,
// so a launch never waits for the stream.
#define K4_SLOT 5
#define K4_MAP 3
#define K4_WINDOWS_CAP 16
#define K4_MAX_REDS 64

struct K4Params {
  i64 rdesc[K4_WINDOWS_CAP * K6_RDESC];
  i64 slots[K6B_MAX_REDS * K4_SLOT];
  i64 map[K4_MAX_REDS * K4_MAP];
};

struct K4BSrc {
  int n_slots;
  const i64* slots;
  const unsigned char* mask;
  __device__ i64 first(int, const i64* d) const { return d[2]; }   // global ids
  __device__ SbSlot slot(int j, int r, i64 base) const {
    const i64* d = slots + K4_SLOT * j;
    SbSlot s;
    s.op = (int)d[0];
    s.flags = (int)d[1];
    s.cval = d[2];
    s.vals = (const i64*)d[3];
    s.valid = (const unsigned char*)d[4];
    s.contrib = mask + base;
    return s;
  }
};

template <int ROWS>
__global__ void __launch_bounds__(K6B_THREADS, 1)
seg_agg_block(const __grid_constant__ K4Params P, int R, const i64* __restrict__ gid,
              const unsigned char* __restrict__ mask, int n_slots, int span_max, int copies,
              i64* __restrict__ part) {
  const K4BSrc src = {n_slots, P.slots, mask};
  seg_block_run<ROWS>(P.rdesc, R, gid, src, span_max, copies, part);
}

// Pass 2: a thread per (reduction, segment) folds its window's block
// partials of the reduction's count and value slots in block order.
__global__ void seg_agg_block_fold(const __grid_constant__ K4Params P, int R, i64 n_seg,
                                   int n_red, int n_slots, int span_max,
                                   const i64* __restrict__ part, i64* __restrict__ out) {
  const i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (i64)n_red * n_seg) return;
  const int j = (int)(idx / n_seg);
  const i64 s = idx % n_seg;
  const int op = (int)P.map[K4_MAP * j];
  const int cs = (int)P.map[K4_MAP * j + 1], vs = (int)P.map[K4_MAP * j + 2];
  const int r = k6_region(P.rdesc, R, 2, s);
  const i64* d = P.rdesc + K6_RDESC * r;
  const i64 local = s - d[2];
  const i64 slab = (i64)n_slots * span_max;
  i64 n = 0, v = val_ident(op);
  for (i64 b = d[4]; b < d[4] + d[5]; ++b) {
    const i64* p = part + b * slab + local;
    if (cs >= 0) n += p[(i64)cs * span_max];
    if (vs >= 0) v = val_merge(op, v, p[(i64)vs * span_max]);
  }
  out[2 * idx] = n;
  out[2 * idx + 1] = v;
}

template <int ROWS>
static cudaError_t k4b_ready(long long* limit) {
  static bool ready[64];
  return k6b_optin(seg_agg_block<ROWS>, ready, limit);
}

static cudaError_t k4b_ready_rows(int rows, long long* limit) {
  switch (rows) {
    case 1: return k4b_ready<1>(limit);
    case 2: return k4b_ready<2>(limit);
    case 4: return k4b_ready<4>(limit);
  }
  return cudaErrorInvalidValue;
}

// The windows' dynamic shared-memory limit on this device (after the
// opt-in), or minus a CUDA error.
extern "C" long long seg_agg_block_limit() {
  long long lim = 0;
  const cudaError_t e = k4b_ready_rows(1, &lim);
  return e == cudaSuccess ? lim : -(long long)e;
}

// The persistent grid at smem bytes, or minus a CUDA error.
extern "C" int seg_agg_block_grid(int rows, long long smem) {
  const cudaError_t e = k4b_ready_rows(rows, nullptr);
  if (e != cudaSuccess) return -(int)e;
  switch (rows) {
    case 1: return k6b_grid(seg_agg_block<1>, smem);
    case 2: return k6b_grid(seg_agg_block<2>, smem);
  }
  return k6b_grid(seg_agg_block<4>, smem);
}

// rdesc: K6_RDESC int64 a window (row base 0, rows n, first segment,
// segments, first block, blocks), windows ascending; slots n_slots *
// K4_SLOT, n_f of them f64 ops; red_map n_red * K4_MAP (the three tables
// in host memory, copied into the parameters); copies of the integer
// states a block (a power of two up to 32; kernels.k4_copies); part
// holds n_blocks * n_slots * span_max int64; out n_red * n_seg (n, v)
// pairs.
extern "C" int seg_agg_block_launch(int rows, int n_blocks, const i64* rdesc, int R,
                                    const i64* gid, const unsigned char* mask, int n_slots,
                                    int n_f, const i64* slots, int n_red, const i64* red_map,
                                    int span_max, int copies, i64 n_seg, i64* part, i64* out,
                                    void* stream) {
  if (n_slots < 1 || n_slots > K6B_MAX_REDS || n_f < 0 || n_f > n_slots || R < 1 ||
      R > K4_WINDOWS_CAP || n_red < 1 || n_red > K4_MAX_REDS || n_seg < 1 || span_max < 1 ||
      n_blocks < 1 || copies < 1 || copies > 32 || (copies & (copies - 1)) != 0)
    return -1;
  long long lim = 0;
  cudaError_t e = k4b_ready_rows(rows, &lim);
  if (e != cudaSuccess) return (int)e;
  const long long smem = k6b_copies_bytes(n_slots, n_f, span_max, rows, copies);
  if (smem > lim) return -1;
  K4Params P;
  memcpy(P.rdesc, rdesc, sizeof(i64) * K6_RDESC * R);
  memcpy(P.slots, slots, sizeof(i64) * K4_SLOT * n_slots);
  memcpy(P.map, red_map, sizeof(i64) * K4_MAP * n_red);
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 1: seg_agg_block<1><<<(unsigned)n_blocks, K6B_THREADS, (size_t)smem, st>>>(
                P, R, gid, mask, n_slots, span_max, copies, part); break;
    case 2: seg_agg_block<2><<<(unsigned)n_blocks, K6B_THREADS, (size_t)smem, st>>>(
                P, R, gid, mask, n_slots, span_max, copies, part); break;
    default: seg_agg_block<4><<<(unsigned)n_blocks, K6B_THREADS, (size_t)smem, st>>>(
                 P, R, gid, mask, n_slots, span_max, copies, part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const i64 total = (i64)n_red * n_seg;
  seg_agg_block_fold<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      P, R, n_seg, n_red, n_slots, span_max, part, out);
  return (int)cudaGetLastError();
}
