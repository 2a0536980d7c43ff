// K14 slot_filter: the WHERE of k statements of one shape over one batch,
// each with its own literals, in one launch.
//
// Replaces the filter wrapper of tidb_tpu/ops/sched.py:1021-1037
// (MicroBatcher._kernel, :982): jax.vmap of the parameterized predicate
// over the statement slots, then the masks packed 64 rows to an int64
// word. The statements share one K1 program (ops/sched.py lowers each
// literal into a parameter slot of the constant pool); slot s runs it with
// pool row `params + s * P`.
//
// One thread per row (grid-stride; rows come in multiples of 64, so a
// warp is always whole): the row's referenced planes are loaded once
// (VmRow), then the program runs once per slot on registers. The survivor
// bit live & valid & truthy of 32 consecutive rows is one __ballot_sync
// word, stored at u32 word s * (n / 32) + row / 32: two warps' words make
// the int64 word whose bit r % 64 is row r (little-endian), the layout
// the reference's _unpack_mask_words reads (bit 63 the sign bit).
//
// Bound by bytes: the referenced planes (8 B a value, 1 B a valid flag)
// and the live byte read once per row, k * n / 8 bytes of words written.
// The interpretation (k program runs a row) is instruction work the bytes hide
// at small k; at k = 32 over millions of rows it is the larger part.
#include "vm.cuh"

#define K14_THREADS 256

__global__ void __launch_bounds__(K14_THREADS)
slot_filter_kernel(i64 n, int k, const i64* __restrict__ meta, int meta_len,
                   const i64* __restrict__ params, int P,
                   const unsigned char* __restrict__ lut, const u64* __restrict__ planes,
                   int n_planes, unsigned valid_bits, const unsigned char* __restrict__ live,
                   unsigned* __restrict__ words) {
  __shared__ i64 sm[K1_MAX_META];
  for (int i = threadIdx.x; i < meta_len; i += blockDim.x) sm[i] = meta[i];
  __syncthreads();
  const int n_instr = (int)sm[0];
  const int where_reg = (int)sm[1];
  const i64* ins = sm + K1_HDR;
  const i64 n_words = n >> 5;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x; row < n; row += stride) {
    VmRow pr;
    pr.load(planes, n_planes, valid_bits, row);
    const bool lv = live[row] != 0;
    for (int s = 0; s < k; ++s) {
      i64 v[K1_MAX_REGS];
      bool ok[K1_MAX_REGS];
      vm_run(ins, n_instr, row, params + (i64)s * P, lut, pr, v, ok);
      bool m = lv;
      if (where_reg >= 0) m = m && ok[where_reg] && v[where_reg] != 0;
      const unsigned word = __ballot_sync(0xffffffffu, m);
      if ((threadIdx.x & 31) == 0) words[(i64)s * n_words + (row >> 5)] = word;
    }
  }
}

// words: k * n / 64 int64 (k * n / 32 u32). n must be a multiple of 64.
extern "C" int slot_filter_launch(i64 n, int k, const i64* meta, int meta_len,
                                  const i64* params, int P, const unsigned char* lut,
                                  const u64* planes, int n_planes, unsigned valid_bits,
                                  const unsigned char* live, unsigned* words, void* stream) {
  if (meta_len > K1_MAX_META || meta_len < K1_HDR) return -1;
  if (n <= 0 || (n & 63) || k < 1 || P < 1) return -1;
  if (n_planes < 0 || n_planes > VM_ROW_PLANES) return -1;
  i64 blocks = n / K14_THREADS + (n % K14_THREADS != 0);
  if (blocks > 132 * 16) blocks = 132 * 16;
  slot_filter_kernel<<<(unsigned)blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      n, k, meta, meta_len, params, P, lut, planes, n_planes, valid_bits, live, words);
  return (int)cudaGetLastError();
}
