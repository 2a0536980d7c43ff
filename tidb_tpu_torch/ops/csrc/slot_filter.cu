// K14 slot_filter: the WHERE of k statements of one shape over one batch,
// each with its own literals, in one launch.
//
// Replaces the filter wrapper of tidb_tpu/ops/sched.py:1021-1037
// (MicroBatcher._kernel, :982): jax.vmap of the parameterized predicate
// over the statement slots, then the masks packed 64 rows to an int64
// word. The statements share one K1 program (ops/sched.py lowers each
// literal into a parameter slot of the constant pool); slot s runs it with
// pool row s of the k x P pools.
//
// The tier launches it many times a second at small batches (32 slots x
// 16,384 rows), where a launch's fixed costs, not its bytes, bound it. So:
//   - nothing is copied to the card first: the plane pointers, the
//     program, the pools and the LUT ride by value in the launch's
//     parameters (vm.cuh SlotParams, the smaller block where they fit);
//   - the grid is row tiles of K14_THREADS rows x groups of slots, as
//     many groups as bring the grid to about K14_TARGET_BLOCKS blocks (8
//     at 16,384 rows; one at a few million, where the tiles fill the card
//     by themselves). A block stages the program and its slots' pools in
//     shared memory;
//   - the program arrives split (ops/exprc.py slot_split): its
//     slot-invariant instructions (the loads and what depends on no
//     constant pool) first, which a row runs once, then the rest, which
//     it runs once a slot of its group;
//   - the registers' values live in shared memory, a column a thread,
//     and their valid bits in one 32-bit register (vm.cuh VmSmemRegs):
//     no local memory (ptxas reports no stack frame for the kernel).
// The survivor bit live & valid & truthy of 32 consecutive rows is one
// __ballot_sync word, stored at u32 word s * (n / 32) + row / 32: two
// warps' words make the int64 word whose bit r % 64 is row r
// (little-endian), the layout the reference's _unpack_mask_words reads
// (bit 63 the sign bit).
//
// Bound by bytes: the referenced planes (8 B a value, 1 B a valid flag)
// and the live byte read once per row, k * n / 8 bytes of words written;
// at the tier's shape that is about 70 ns, far below one launch. At 32
// slots over millions of rows the per-slot interpretation is the larger
// part.
#include "vm.cuh"

#define K14_THREADS 128
#define K14_TARGET_BLOCKS (132 * 8)

template <class Prm>
__global__ void __launch_bounds__(K14_THREADS)
slot_filter_kernel(const __grid_constant__ Prm p, i64 n, int k, int P, int per_group,
                   int n_instr, int n_inv, int where_reg,
                   const unsigned char* __restrict__ live, unsigned* __restrict__ words) {
  extern __shared__ i64 k14_smem[];
  i64* ins = k14_smem;                             // [6 * n_instr]
  i64* pool = ins + 6 * n_instr;                   // [per_group][P]
  i64* regs = pool + (size_t)per_group * P;        // [n_regs][K14_THREADS]
  const int t = threadIdx.x;
  const int s0 = blockIdx.y * per_group;
  const int s1 = min(k, s0 + per_group);
  for (int i = t; i < 6 * n_instr; i += K14_THREADS) ins[i] = p.ins[i];
  for (int i = t; i < (s1 - s0) * P; i += K14_THREADS) pool[i] = p.pools[(i64)s0 * P + i];
  __syncthreads();
  const i64 row = (i64)blockIdx.x * K14_THREADS + t;
  if (row >= n) return;   // whole warps: n is a multiple of 64
  VmSmemRegs R = {regs + t, K14_THREADS, 0u};
  const VmPlanes pl = {p.planes};
  vm_exec(ins, 0, n_inv, row, pool, p.lut, pl, R);
  const bool lv = live[row] != 0;
  const i64 n_words = n >> 5;
  for (int s = s0; s < s1; ++s) {
    vm_exec(ins, n_inv, n_instr, row, pool + (size_t)(s - s0) * P, p.lut, pl, R);
    bool m = lv;
    if (where_reg >= 0) m = m && R.valid(where_reg) && R.val(where_reg) != 0;
    const unsigned word = __ballot_sync(0xffffffffu, m);
    if ((t & 31) == 0) words[(i64)s * n_words + (row >> 5)] = word;
  }
}

template <class Prm>
static int k14_go(const Prm& p, i64 n, int k, int P, int n_instr, int n_inv, int where_reg,
                  int n_regs, const unsigned char* live, unsigned* words, cudaStream_t st) {
  const i64 tiles = (n + K14_THREADS - 1) / K14_THREADS;
  i64 groups = (K14_TARGET_BLOCKS + tiles - 1) / tiles;
  if (groups > k) groups = k;
  const int per_group = (int)((k + groups - 1) / groups);
  groups = (k + per_group - 1) / per_group;
  const size_t smem = 8 * (6 * (size_t)n_instr + (size_t)per_group * P +
                           (size_t)n_regs * K14_THREADS);
  slot_filter_kernel<Prm><<<dim3((unsigned)tiles, (unsigned)groups), K14_THREADS, smem, st>>>(
      p, n, k, P, per_group, n_instr, n_inv, where_reg, live, words);
  return (int)cudaGetLastError();
}

// words: k * n / 64 int64 (k * n / 32 u32). n must be a multiple of 64.
// planes, ins (n_instr instructions, the first n_inv slot-invariant),
// pools (k x P) and lut are host arrays; they ride by value. Registers
// 0 .. n_regs - 1 are the ones the program writes.
extern "C" int slot_filter_launch(i64 n, int k, int P, const u64* planes, int n_planes,
                                  const i64* ins, int n_instr, int n_inv, int where_reg,
                                  int n_regs, const i64* pools, const unsigned char* lut,
                                  int lut_len, const unsigned char* live, unsigned* words,
                                  void* stream) {
  if (n <= 0 || (n & 63) || k < 1 || P < 1) return -1;
  if (n_inv < 0 || n_inv > n_instr || n_regs < 0 || n_regs > K1_MAX_REGS ||
      where_reg >= n_regs)
    return -1;
  const i64 pool_words = (i64)k * P;
  cudaStream_t st = (cudaStream_t)stream;
  if (slot_small(n_instr, pool_words, lut_len)) {
    SlotParamsSmall p;
    const int e = slot_fill(&p, planes, n_planes, ins, n_instr, pools, pool_words, lut, lut_len,
                            nullptr, 0);
    return e ? e : k14_go(p, n, k, P, n_instr, n_inv, where_reg, n_regs, live, words, st);
  }
  SlotParamsLarge p;
  const int e = slot_fill(&p, planes, n_planes, ins, n_instr, pools, pool_words, lut, lut_len,
                          nullptr, 0);
  return e ? e : k14_go(p, n, k, P, n_instr, n_inv, where_reg, n_regs, live, words, st);
}
