// K1 expr_vm and K5 expr_vm_ragged: the bytecode interpreter of
// pushed-down expressions (vm.cuh vm_exec_rows), over one batch (K1) or
// over R regions in one launch (K5). Both take everything they read
// besides the planes' rows as one table of int64 words that
// ops/kernels.py lays out in one host pass (k1_pack, k5_pack): by value
// in the launch's parameters (K5Params, __grid_constant__, a 4 KB or a
// 31 KB block), or past K5_PARAM_WORDS copied once from a page-locked
// staging buffer into a device buffer that the same body reads through a
// pointer. Instructions are fetched from the table, uniform across a
// warp; no block stages a program. A thread interprets K5_ROWS rows of a
// K5_TILE-row tile at once, a warp's 32 rows consecutive for each: each
// instruction is fetched and dispatched once for the four rows, whose
// loads are in flight together. Registers live in shared memory, a
// column a row, and their valid bits in one 32-bit register a row
// (vm.cuh VmSmemRegs, as K14 and K15): no stack frame. The grid is whole
// waves of the resident blocks, striding over the tiles.
#include <cstring>

#include "vm.cuh"

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

// The table kernels k5_wave keeps apart: K5's three instantiations (the
// smaller and the larger parameter block, then the packed table), K1's.
#define VM_TABLE_KERNELS 6
#define VM_K5 0
#define VM_K1 3

// Whole waves of a table kernel at `smem` bytes of registers, kept per
// device, kernel and register count (or minus a CUDA error); the first
// call on a device opts the kernel in to the shared memory of
// K1_MAX_REGS registers.
template <class Kernel>
static int k5_wave(Kernel kernel, int which, int n_regs, size_t smem) {
  static int waves[64][VM_TABLE_KERNELS][K1_MAX_REGS + 1];
  static bool ready[64][VM_TABLE_KERNELS];
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

template <class Kernel, class Arg, class Out>
static int k5_go(Kernel kernel, int which, const Arg& arg, i64 n_tiles, int n_regs, Out* out,
                 cudaStream_t st) {
  const size_t smem = (size_t)K5_REG_BYTES * (n_regs > 0 ? n_regs : 1);
  const int wave = k5_wave(kernel, which, n_regs, smem);
  if (wave <= 0) return -wave;
  const i64 grid = n_tiles < wave ? n_tiles : wave;
  kernel<<<(unsigned)grid, K5_THREADS, smem, st>>>(arg, out);
  return (int)cudaGetLastError();
}

// A table of n_words int64 (host memory) launched on the kernels
// [small, large, packed] (k5_wave's which, which + 1, which + 2): by value
// in the smaller or the larger parameter block, or, with dev_words set
// (words then page-locked), copied into dev_words and read from there.
template <class KS, class KL, class KP, class Out>
static int vm_table_go(KS small, KL large, KP packed, int which, const i64* words, int n_words,
                       i64* dev_words, i64 n_tiles, int n_regs, Out* out, cudaStream_t st) {
  if (dev_words != nullptr) {
    const cudaError_t e = cudaMemcpyAsync(dev_words, words, 8 * (size_t)n_words,
                                          cudaMemcpyHostToDevice, st);
    if (e != cudaSuccess) return (int)e;
    return k5_go(packed, which + 2, (const i64*)dev_words, n_tiles, n_regs, out, st);
  }
  if (n_words <= K5_SMALL_WORDS) {
    K5ParamsSmall p;
    memcpy(p.w, words, 8 * (size_t)n_words);
    return k5_go(small, which, p, n_tiles, n_regs, out, st);
  }
  if (n_words > K5_PARAM_WORDS) return -1;
  K5ParamsLarge p;
  memcpy(p.w, words, 8 * (size_t)n_words);
  return k5_go(large, which + 1, p, n_tiles, n_regs, out, st);
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
  if (n_tiles == 0) return 0;
  return vm_table_go(expr_vm_ragged_value<K5_SMALL_WORDS>, expr_vm_ragged_value<K5_PARAM_WORDS>,
                     expr_vm_ragged_packed, VM_K5, words, n_words, dev_words, n_tiles,
                     (int)words[K5_H_REGS], bits, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K1 expr_vm: a request's WHERE mask, group id and argument planes over
// one batch of n rows.
//
// Replaces the expression programs of tidb_tpu/ops/exprc.py:79
// compile_expr, which XLA fuses into every coprocessor kernel, and the
// WHERE mask lines of tidb_tpu/ops/kernels.py:721-722 and :921-924 (mask =
// live & valid & truthy(where)) plus the mixed-radix group id of
// kernels.py:925-930 (NULL takes slot `size`, dead rows the sink).
//
// K5's shape over one batch: its tiles of K5_TILE rows (the last one
// ragged: its lanes past n interpret the last row again and store
// nothing), K5_ROWS rows a thread at once, registers in shared memory,
// the table by value or packed (k1_pack). Bound by the bytes it moves:
// the referenced planes once, 1 B of live, 1 B of mask (bytes, which K2,
// K3 and K4 read), 8 B of group id and 9 B a program output a row. The
// first design ran one row a thread, its registers in a 144-byte stack
// frame, and staged the program in every block from five uploaded tables.
//
// The table: K1_T_HDR header words (below), the output pointers (values,
// valid), the plane pointers, then the program's instructions, output
// registers and group slots (value slot, valid slot, size, radix), its
// pool, and last its LUT bytes.
#define K1_T_HDR 17
#define K1_T_N 0          // rows
#define K1_T_TILES 1
#define K1_T_INSTR 2
#define K1_T_WHERE 3      // the WHERE register, -1: none
#define K1_T_OUT 4
#define K1_T_GROUP 5
#define K1_T_SINK 6
#define K1_T_REGS 7
#define K1_T_LIVE 8       // the live plane's pointer
#define K1_T_GID 9        // the group id's pointer (0 without groups)
#define K1_T_OUTS 10      // word offsets of the parts
#define K1_T_PLANES 11
#define K1_T_INS 12
#define K1_T_OREGS 13
#define K1_T_GRP 14
#define K1_T_POOL 15
#define K1_T_LUT 16
#define K1_MINB 4         // resident blocks a launch bound asks for

__device__ __forceinline__ void k1_run(const i64* __restrict__ w,
                                       unsigned char* __restrict__ mask_out) {
  extern __shared__ i64 k1_regs[];   // [registers][K5_ROWS][K5_THREADS]
  const i64 n = w[K1_T_N], tiles = w[K1_T_TILES], sink = w[K1_T_SINK];
  const int n_instr = (int)w[K1_T_INSTR], where = (int)w[K1_T_WHERE];
  const int n_out = (int)w[K1_T_OUT], n_group = (int)w[K1_T_GROUP];
  const unsigned char* live = (const unsigned char*)w[K1_T_LIVE];
  i64* gid = (i64*)w[K1_T_GID];
  const u64* outs = (const u64*)(w + w[K1_T_OUTS]);
  const VmPlanes pl = {(const u64*)(w + w[K1_T_PLANES])};
  const i64* ins = w + w[K1_T_INS];
  const i64* oregs = w + w[K1_T_OREGS];
  const i64* grp = w + w[K1_T_GRP];
  const i64* pool = w + w[K1_T_POOL];
  const unsigned char* lut = (const unsigned char*)(w + w[K1_T_LUT]);
  VmSmemRegs regs[K5_ROWS];
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q)
    regs[q] = {k1_regs + q * K5_THREADS + threadIdx.x, K5_ROWS * K5_THREADS, 0u};
  for (i64 tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    // the thread's K5_ROWS rows of the tile, a warp's 32 consecutive for
    // each; a row past n reads the last row and stores nothing
    i64 rows[K5_ROWS];
    bool in[K5_ROWS];
#pragma unroll
    for (int q = 0; q < K5_ROWS; ++q) {
      const i64 r = tl * K5_TILE + q * K5_THREADS + threadIdx.x;
      in[q] = r < n;
      rows[q] = in[q] ? r : n - 1;
    }
    vm_exec_rows<K5_ROWS>(ins, 0, n_instr, rows, pool, lut, pl, regs);
    bool m[K5_ROWS];
#pragma unroll
    for (int q = 0; q < K5_ROWS; ++q) {
      m[q] = live[rows[q]] != 0;
      if (where >= 0) m[q] = m[q] && regs[q].valid(where) && regs[q].val(where) != 0;
    }
    if (n_group > 0) {
      // the surviving rows' codes only: a dead row's id is the sink
      i64 g[K5_ROWS];
#pragma unroll
      for (int q = 0; q < K5_ROWS; ++q) g[q] = 0;
      for (int j = 0; j < n_group; ++j) {
        const i64* gs = grp + 4 * j;
#pragma unroll
        for (int q = 0; q < K5_ROWS; ++q) {
          if (!m[q]) continue;
          const i64 code = pl.value(gs[0], rows[q]);
          g[q] = g[q] * gs[3] + (pl.valid(gs[1], rows[q]) ? code : gs[2]);   // NULL -> `size`
        }
      }
#pragma unroll
      for (int q = 0; q < K5_ROWS; ++q)
        if (in[q]) gid[rows[q]] = m[q] ? g[q] : sink;
    }
#pragma unroll
    for (int q = 0; q < K5_ROWS; ++q)
      if (in[q]) mask_out[rows[q]] = m[q];
    for (int j = 0; j < n_out; ++j) {
      const int r = (int)oregs[j];
      i64* vo = (i64*)outs[2 * j];
      unsigned char* ko = (unsigned char*)outs[2 * j + 1];
#pragma unroll
      for (int q = 0; q < K5_ROWS; ++q) {
        if (!in[q]) continue;
        vo[rows[q]] = regs[q].val(r);
        ko[rows[q]] = regs[q].valid(r);
      }
    }
  }
}

// At most 64 registers: four blocks an SM. The packed table keeps its
// pointers in registers: 85, three blocks an SM (at 64 it spills).
template <int W>
__global__ void __launch_bounds__(K5_THREADS, K1_MINB)
expr_vm_value(const __grid_constant__ K5Params<W> p, unsigned char* __restrict__ mask) {
  k1_run(p.w, mask);
}

__global__ void __launch_bounds__(K5_THREADS, 3)
expr_vm_packed(const i64* __restrict__ w, unsigned char* __restrict__ mask) {
  k1_run(w, mask);
}

// words: K1's table (n_words int64, host memory), by value up to
// K5_PARAM_WORDS, else copied into dev_words (words then page-locked);
// mask: n bytes.
extern "C" int expr_vm_launch(const i64* words, int n_words, i64* dev_words,
                              unsigned char* mask, void* stream) {
  if (n_words < K1_T_HDR || words[K1_T_N] < 0 || words[K1_T_INSTR] < 0 ||
      words[K1_T_REGS] < 0 || words[K1_T_REGS] > K1_MAX_REGS || words[K1_T_OUT] < 0 ||
      words[K1_T_GROUP] < 0 || words[K1_T_LUT] > n_words ||
      words[K1_T_TILES] != (words[K1_T_N] + K5_TILE - 1) / K5_TILE)
    return -1;
  const i64 tiles = words[K1_T_TILES];
  if (tiles == 0) return 0;
  return vm_table_go(expr_vm_value<K5_SMALL_WORDS>, expr_vm_value<K5_PARAM_WORDS>,
                     expr_vm_packed, VM_K1, words, n_words, dev_words, tiles,
                     (int)words[K1_T_REGS], mask, (cudaStream_t)stream);
}
