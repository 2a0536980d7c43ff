// K1 expr_vm: the bytecode interpreter of pushed-down expressions.
//
// Replaces the expression programs of tidb_tpu/ops/exprc.py:79
// compile_expr, which XLA fuses into every coprocessor kernel, and the
// WHERE mask lines of tidb_tpu/ops/kernels.py:721-722 and :921-924 (mask =
// live & valid & truthy(where)) plus the mixed-radix group id of
// kernels.py:925-930.
//
// One thread interprets the whole program for one row (grid-stride loop),
// so every intermediate stays in registers / local memory and each input
// plane is read once, each output written once: the kernel is bound by
// the bytes it moves (about 8 B per loaded column value, 1 B per valid
// flag, 1 B of mask, 8 B of group id and 9 B per output per row). The
// program (at most 64 instructions) is copied into shared memory by every
// block; the data-dependent dispatch is a switch, which costs issue slots
// but no memory traffic. The interpreter (vm_run) lives in vm.cuh, which
// K14 and K15 share.
//
// K5 expr_vm_ragged (below K1) runs the same interpreter over R regions in
// one launch: every region brings its own program, constant pool, LUT and
// plane table (each region's batch has its own string dictionary).
#include <cstring>

#include "vm.cuh"

__global__ void expr_vm_kernel(i64 n, const i64* __restrict__ meta, int meta_len,
                               const i64* __restrict__ pool,
                               const unsigned char* __restrict__ lut,
                               const u64* __restrict__ planes,
                               const unsigned char* __restrict__ live,
                               unsigned char* __restrict__ mask_out,
                               i64* __restrict__ gid_out,
                               const u64* __restrict__ outs) {
  __shared__ i64 sm[K1_MAX_META];
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x) sm[i] = meta[i];
  __syncthreads();
  const int n_instr = (int)sm[0];
  const int where_reg = (int)sm[1];
  const int n_out = (int)sm[2];
  const int n_group = (int)sm[3];
  const i64 sink = sm[4];
  const i64* ins = sm + K1_HDR;
  const i64* out_regs = ins + 6 * n_instr;
  const i64* grp = out_regs + n_out;

  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    i64 v[K1_MAX_REGS];
    bool ok[K1_MAX_REGS];
    vm_run(ins, n_instr, row, pool, lut, VmPlanes{planes}, v, ok);
    bool m = live[row] != 0;
    if (where_reg >= 0) m = m && ok[where_reg] && v[where_reg] != 0;
    mask_out[row] = m;
    if (n_group > 0) {
      i64 g = 0;
      for (int j = 0; j < n_group; ++j) {
        const i64* gs = grp + 4 * j;
        const i64 code = ((const i64*)planes[gs[0]])[row];
        const bool gv = ((const unsigned char*)planes[gs[1]])[row] != 0;
        const i64 cc = gv ? code : gs[2];   // NULL -> slot `size`
        g = j == 0 ? cc : g * gs[3] + cc;
      }
      gid_out[row] = m ? g : sink;          // dead rows -> sink segment
    }
    for (int j = 0; j < n_out; ++j) {
      const int r = (int)out_regs[j];
      ((i64*)outs[2 * j])[row] = v[r];
      ((unsigned char*)outs[2 * j + 1])[row] = ok[r];
    }
  }
}

extern "C" int expr_vm_launch(i64 n, const i64* meta, int meta_len, const i64* pool,
                              const unsigned char* lut, const u64* planes,
                              const unsigned char* live, unsigned char* mask_out,
                              i64* gid_out, const u64* outs, void* stream) {
  if (meta_len > K1_MAX_META || meta_len < K1_HDR) return -1;
  if (n <= 0) return 0;
  const int threads = 256;
  i64 blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  expr_vm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      n, meta, meta_len, pool, lut, planes, live, mask_out, gid_out, outs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5 expr_vm_ragged: every region's WHERE (and aggregate-argument planes)
// in one launch.
//
// Replaces tidb_tpu/ops/kernels.py:1552 region_filter_batched (and the
// arg-plane programs that :1356 region_agg_states_batched evaluates in
// its dispatch, ops/exprc.py:961 compile_arg_plane). Region r's rows are
// [base_r, base_r + cap_r) of the concatenated outputs; cap_r is a
// multiple of K5_TILE, so a tile of K5_TILE rows never crosses a region.
// The survivor bit live & valid & truthy (live = row < n_rows_r) of 32
// consecutive rows is one __ballot_sync word, stored at word
// (base_r + row) / 32: little-endian, so the bytes are exactly
// np.packbits(mask, bitorder="little") of the concatenated masks. Program
// outputs (the argument planes) go to concatenated [sum cap_r] planes at
// base_r + row.
//
// Everything a launch reads besides the planes' rows is one table of
// int64 words that ops/kernels.py (k5_pack) lays out in one host pass:
//   header   K5_HDR words: R, streams, outputs, tiles, registers, then
//            the word offsets of the parts below;
//   tiles    R + 1 words: each region's first tile, then the tile count;
//   regions  K5_REGION words each: row base, n_rows, stream, plane-table
//            offset, pool offset (words), LUT offset (bytes);
//   streams  K5_STREAM + n_out words each: instruction offset, count,
//            WHERE register, then the output registers. Regions whose
//            instructions, WHERE and output registers are equal share one
//            stream (a statement's regions usually share one program:
//            only their pools, LUTs and planes differ);
//   the instructions, the output pointers (values, valid), the plane
//   pointers, the pools, and last the LUT bytes.
// The table rides by value in the launch's parameters (K5Params,
// __grid_constant__, in the smaller block where it fits; the larger block
// cost 4-7 µs a launch at q1full, k5_k19_variants.py). A table past K5_PARAM_WORDS is
// copied once from a page-locked staging buffer into a device buffer, and
// the same body reads it through a pointer (expr_vm_ragged_packed).
// Instructions are fetched from the table, uniform across a warp; no
// block stages a program. A block finds its tile's region by a binary
// search of the tile prefix (at most R entries); the grid is whole waves
// of the resident blocks, striding over the tiles.
//
// A thread interprets its K5_ROWS rows of a tile at once (vm.cuh
// vm_exec_rows): each instruction is fetched and dispatched once for the
// four rows, whose loads are in flight together (one row a thread took
// three times as long at q1full, k5_k19_variants.py). Registers live in shared
// memory, a column a row, and their valid bits in one 32-bit register a
// row (vm.cuh VmSmemRegs, as K14 and K15): no stack frame. Nothing is
// read twice: bound by the bytes of the referenced planes plus 1/8 B of
// mask and 9 B per output per row.
#define K5_TILE 1024
#define K5_THREADS 256
#define K5_HDR 12
#define K5_REGION 6
#define K5_STREAM 3
#define K5_ROWS (K5_TILE / K5_THREADS)              // rows a thread interprets at once
#define K5_REG_BYTES (8 * K5_ROWS * K5_THREADS)      // shared memory a register
#define K5_SMALL_WORDS 512      // the smaller parameter block (4 KB)
#define K5_PARAM_WORDS 3968     // the larger one (31,744 B); past it, packed

// header words
#define K5_H_R 0
#define K5_H_STREAMS 1
#define K5_H_OUT 2
#define K5_H_TILES 3
#define K5_H_REGS 4
#define K5_H_TILE0 5
#define K5_H_REGIONS 6
#define K5_H_STREAMS_OFF 7
#define K5_H_OUTS 8
#define K5_H_PLANES 9
#define K5_H_POOL 10
#define K5_H_LUT 11

template <int W>
struct K5Params {
  i64 w[W];
};

typedef K5Params<K5_SMALL_WORDS> K5ParamsSmall;
typedef K5Params<K5_PARAM_WORDS> K5ParamsLarge;
static_assert(sizeof(K5ParamsLarge) + 64 <= SLOT_PARAM_LIMIT,
              "K5's parameter block and the launch's other arguments exceed "
              "CUDA's parameter limit");

__device__ __forceinline__ void k5_run(const i64* __restrict__ w, unsigned* __restrict__ bits) {
  extern __shared__ i64 k5_regs[];   // [registers][K5_ROWS][K5_THREADS]
  const int R = (int)w[K5_H_R];
  const int n_out = (int)w[K5_H_OUT];
  const i64 n_tiles = w[K5_H_TILES];
  const i64* tile0 = w + w[K5_H_TILE0];
  const i64* regions = w + w[K5_H_REGIONS];
  const i64* streams = w + w[K5_H_STREAMS_OFF];
  const u64* outs = (const u64*)(w + w[K5_H_OUTS]);
  const u64* planes = (const u64*)(w + w[K5_H_PLANES]);
  const i64* pools = w + w[K5_H_POOL];
  const unsigned char* luts = (const unsigned char*)(w + w[K5_H_LUT]);
  VmSmemRegs regs[K5_ROWS];
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q)
    regs[q] = {k5_regs + q * K5_THREADS + threadIdx.x, K5_ROWS * K5_THREADS, 0u};
  for (i64 tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the tile's region: the last whose first tile is at or before it
    int lo = 0, hi = R - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tile0[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    const i64* d = regions + K5_REGION * lo;
    const i64 base = d[0], n_rows = d[1];
    const i64* st = streams + (K5_STREAM + n_out) * d[2];
    const int n_instr = (int)st[1];
    const int where = (int)st[2];
    const VmPlanes pl = {planes + d[3]};
    const i64* pool = pools + d[4];
    const unsigned char* lut = luts + d[5];
    const i64 t0 = (tile - tile0[lo]) * K5_TILE;
    // the thread's K5_ROWS rows of the tile (region-local; t0 + K5_TILE
    // <= cap), a warp's 32 rows consecutive for each
    i64 rows[K5_ROWS];
#pragma unroll
    for (int q = 0; q < K5_ROWS; ++q) rows[q] = t0 + q * K5_THREADS + threadIdx.x;
    vm_exec_rows<K5_ROWS>(w + st[0], 0, n_instr, rows, pool, lut, pl, regs);
#pragma unroll
    for (int q = 0; q < K5_ROWS; ++q) {
      bool m = rows[q] < n_rows;
      if (where >= 0) m = m && regs[q].valid(where) && regs[q].val(where) != 0;
      const unsigned word = __ballot_sync(0xffffffffu, m);
      if ((threadIdx.x & 31) == 0) bits[(base + rows[q]) >> 5] = word;
    }
    for (int j = 0; j < n_out; ++j) {
      const int r = (int)st[K5_STREAM + j];
      i64* vo = (i64*)outs[2 * j] + base;
      unsigned char* ko = (unsigned char*)outs[2 * j + 1] + base;
#pragma unroll
      for (int q = 0; q < K5_ROWS; ++q) {
        vo[rows[q]] = regs[q].val(r);
        ko[rows[q]] = regs[q].valid(r);
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(K5_THREADS)
expr_vm_ragged_value(const __grid_constant__ K5Params<W> p, unsigned* __restrict__ bits) {
  k5_run(p.w, bits);
}

__global__ void __launch_bounds__(K5_THREADS)
expr_vm_ragged_packed(const i64* __restrict__ w, unsigned* __restrict__ bits) {
  k5_run(w, bits);
}

// Whole waves of a K5 kernel at `smem` bytes of registers, kept per
// device, kernel and register count (or minus a CUDA error); the first
// call on a device opts the kernel in to the shared memory of
// K1_MAX_REGS registers.
template <class Kernel>
static int k5_wave(Kernel kernel, int which, int n_regs, size_t smem) {
  static int waves[64][3][K1_MAX_REGS + 1];
  static bool ready[64][3];
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < 0 || dev >= 64) return -(int)cudaErrorInvalidDevice;
  int& g = waves[dev][which][n_regs];
  if (g > 0) return g;
  if (!ready[dev][which]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K5_REG_BYTES * K1_MAX_REGS);
    if (e != cudaSuccess) return -(int)e;
    ready[dev][which] = true;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, K5_THREADS, smem);
  if (e != cudaSuccess) return -(int)e;
  g = (occ > 0 ? occ : 1) * sms;
  return g;
}

template <class Kernel, class Arg>
static int k5_go(Kernel kernel, int which, const Arg& arg, i64 n_tiles, int n_regs,
                 unsigned* bits, cudaStream_t st) {
  const size_t smem = (size_t)K5_REG_BYTES * (n_regs > 0 ? n_regs : 1);
  const int wave = k5_wave(kernel, which, n_regs, smem);
  if (wave <= 0) return -wave;
  const i64 grid = n_tiles < wave ? n_tiles : wave;
  kernel<<<(unsigned)grid, K5_THREADS, smem, st>>>(arg, bits);
  return (int)cudaGetLastError();
}

extern "C" int expr_vm_ragged_tile() { return K5_TILE; }

// words: the table (n_words int64, host memory). dev_words null: the
// table rides by value (n_words <= K5_PARAM_WORDS); else it is copied
// into dev_words (words then page-locked) and read from there. bits:
// sum cap_r / 32 u32 words.
extern "C" int expr_vm_ragged_launch(const i64* words, int n_words, i64* dev_words,
                                     unsigned* bits, void* stream) {
  if (n_words < K5_HDR || words[K5_H_R] < 1 || words[K5_H_TILES] < 0 ||
      words[K5_H_REGS] < 0 || words[K5_H_REGS] > K1_MAX_REGS || words[K5_H_OUT] < 0 ||
      words[K5_H_LUT] > n_words)
    return -1;
  const i64 n_tiles = words[K5_H_TILES];
  const int n_regs = (int)words[K5_H_REGS];
  if (n_tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dev_words != nullptr) {
    const cudaError_t e = cudaMemcpyAsync(dev_words, words, 8 * (size_t)n_words,
                                          cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
    return k5_go(expr_vm_ragged_packed, 2, (const i64*)dev_words, n_tiles, n_regs, bits, st);
  }
  if (n_words <= K5_SMALL_WORDS) {
    K5ParamsSmall p;
    memcpy(p.w, words, 8 * (size_t)n_words);
    return k5_go(expr_vm_ragged_value<K5_SMALL_WORDS>, 0, p, n_tiles, n_regs, bits, st);
  }
  if (n_words > K5_PARAM_WORDS) return -1;
  K5ParamsLarge p;
  memcpy(p.w, words, 8 * (size_t)n_words);
  return k5_go(expr_vm_ragged_value<K5_PARAM_WORDS>, 1, p, n_tiles, n_regs, bits, st);
}
