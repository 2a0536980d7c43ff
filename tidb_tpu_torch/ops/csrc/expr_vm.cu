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
// its dispatch, ops/exprc.py:961 compile_arg_plane). Each region r has a
// descriptor of K5_DESC int64:
//   (row base in the concatenated outputs, cap_r, n_rows_r, plane-table
//    offset, program offset, program length, pool offset, LUT offset).
// A host-built table maps each tile of K5_TILE rows to its region; tiles
// never cross a region (cap_r is a power of two >= 1024). A block stages
// its region's program in shared memory and interprets it one row per
// thread; the survivor bit live & valid & truthy (live = row < n_rows_r)
// of 32 consecutive rows is one __ballot_sync word, stored at word
// (base_r + row) / 32 — little-endian, so the bytes are exactly
// np.packbits(mask, bitorder="little") of the concatenated masks.
// Program outputs (the argument planes) go to concatenated [sum cap_r]
// planes at base_r + row. Nothing is read twice: bound by the bytes of
// the referenced planes plus 1/8 B of mask and 9 B per output per row.
#define K5_DESC 8
#define K5_TILE 1024
#define K5_THREADS 256

__global__ void expr_vm_ragged_kernel(const i64* __restrict__ desc,
                                      const int* __restrict__ tile_region,
                                      const int* __restrict__ tile_first,
                                      const i64* __restrict__ meta,
                                      const i64* __restrict__ pool,
                                      const unsigned char* __restrict__ lut,
                                      const u64* __restrict__ planes,
                                      unsigned int* __restrict__ bits_out,
                                      const u64* __restrict__ outs) {
  __shared__ i64 sm[K1_MAX_META];
  const int r = tile_region[blockIdx.x];
  const i64* d = desc + K5_DESC * r;
  const i64 base = d[0], n_rows = d[2];
  const int meta_len = (int)d[5];
  const i64* m_r = meta + d[4];
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x) sm[i] = m_r[i];
  __syncthreads();
  const int n_instr = (int)sm[0];
  const int where_reg = (int)sm[1];
  const int n_out = (int)sm[2];
  const i64* ins = sm + K1_HDR;
  const i64* out_regs = ins + 6 * n_instr;
  const u64* pl = planes + d[3];
  const i64* po = pool + d[6];
  const unsigned char* lu = lut + d[7];
  const i64 t0 = (i64)(blockIdx.x - tile_first[r]) * K5_TILE;
  for (i64 k = threadIdx.x; k < K5_TILE; k += K5_THREADS) {
    const i64 row = t0 + k;           // region-local; t0 + K5_TILE <= cap
    i64 v[K1_MAX_REGS];
    bool ok[K1_MAX_REGS];
    vm_run(ins, n_instr, row, po, lu, VmPlanes{pl}, v, ok);
    bool m = row < n_rows;
    if (where_reg >= 0) m = m && ok[where_reg] && v[where_reg] != 0;
    const unsigned int word = __ballot_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) bits_out[(base + row) >> 5] = word;
    for (int j = 0; j < n_out; ++j) {
      const int q = (int)out_regs[j];
      ((i64*)outs[2 * j])[base + row] = v[q];
      ((unsigned char*)outs[2 * j + 1])[base + row] = ok[q];
    }
  }
}

extern "C" int expr_vm_ragged_tile() { return K5_TILE; }

extern "C" int expr_vm_ragged_launch(int n_tiles, const i64* desc, const int* tile_region,
                                     const int* tile_first, const i64* meta,
                                     const i64* pool, const unsigned char* lut,
                                     const u64* planes, unsigned int* bits_out,
                                     const u64* outs, void* stream) {
  if (n_tiles <= 0) return 0;
  expr_vm_ragged_kernel<<<(unsigned)n_tiles, K5_THREADS, 0, (cudaStream_t)stream>>>(
      desc, tile_region, tile_first, meta, pool, lut, planes, bits_out, outs);
  return (int)cudaGetLastError();
}
