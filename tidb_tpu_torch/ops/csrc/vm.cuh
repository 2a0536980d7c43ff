// The K1 bytecode interpreter, shared by K1 and K5 (expr_vm.cu), K14
// (slot_filter.cu) and K15 (slot_agg.cu).
//
// A plane slot of the program (OP_LOAD's a and b) names an 8-byte value
// plane or a 1-byte valid plane, read from the device planes directly
// (VmPlanes). vm_exec_rows runs instructions over N rows of a thread at
// once (K1 and K5: four, the whole program once a row); vm_exec is its
// one-row form (K14 and K15: the slot-invariant part, where the loads
// are, once a row). The registers live in shared memory, one column a
// thread (VmSmemRegs), their valid bits in one 32-bit register: no local
// memory.
#pragma once

#include <cstring>

#include "common.cuh"

struct VmPlanes {
  const u64* planes;   // per slot: the plane's device pointer
  __device__ __forceinline__ i64 value(i64 slot, i64 row) const {
    return ((const i64*)planes[slot])[row];
  }
  __device__ __forceinline__ bool valid(i64 slot, i64 row) const {
    return ((const unsigned char*)planes[slot])[row] != 0;
  }
};

// At most this many plane slots per program of K14 / K15
// (kernels.SLOT_MAX_PLANES).
#define VM_ROW_PLANES 16

struct VmSmemRegs {
  i64* v;          // this thread's register 0; register r at v[r * stride]
  int stride;      // threads of the block
  unsigned okm;    // bit r: register r is valid
  __device__ __forceinline__ i64 val(int r) const { return v[r * stride]; }
  __device__ __forceinline__ bool valid(int r) const { return (okm >> r) & 1u; }
  __device__ __forceinline__ void put(int r, i64 x, bool k) {
    v[r * stride] = x;
    okm = (okm & ~(1u << r)) | ((unsigned)k << r);
  }
};

__device__ __forceinline__ bool vm_cmp_i(int op, i64 x, i64 y) {
  switch (op) {
    case OP_EQ_I: return x == y;
    case OP_NE_I: return x != y;
    case OP_LT_I: return x < y;
    case OP_LE_I: return x <= y;
    case OP_GT_I: return x > y;
    default: return x >= y;
  }
}

__device__ __forceinline__ bool vm_cmp_f(int op, double x, double y) {
  switch (op) {
    case OP_EQ_F: return x == y;
    case OP_NE_F: return x != y;
    case OP_LT_F: return x < y;
    case OP_LE_F: return x <= y;
    case OP_GT_F: return x > y;
    default: return x >= y;
  }
}

// Each of a thread's N rows in turn (unrolled: q is a constant)
#define VM_ROWS _Pragma("unroll") for (int q = 0; q < N; ++q)

// Run instructions [from, to) of a K1 program over N rows at once: row
// rows[q] into the register file R[q]. Each instruction is fetched and
// dispatched once for the N rows, whose work is independent (their loads
// in flight together). `pl` reads the rows' planes.
template <int N, class Planes, class Regs>
__device__ __forceinline__ void vm_exec_rows(const i64* __restrict__ ins, int from, int to,
                                             const i64 (&rows)[N],
                                             const i64* __restrict__ pool,
                                             const unsigned char* __restrict__ lut,
                                             const Planes& pl, Regs (&R)[N]) {
  for (int k = from; k < to; ++k) {
    const i64* in = ins + 6 * k;
    const int op = (int)in[0];
    const int d = (int)in[1];
    const i64 a = in[2], b = in[3], c = in[4], imm = in[5];
    i64 rv[N];
    bool rk[N];
    switch (op) {
      case OP_LOAD:
        VM_ROWS {
          rv[q] = pl.value(a, rows[q]);
          rk[q] = b < 0 ? true : pl.valid(b, rows[q]);
        }
        break;
      case OP_CONST:
        VM_ROWS {
          rv[q] = pool[imm];
          rk[q] = a != 0;
        }
        break;
      case OP_EQ_I: case OP_NE_I: case OP_LT_I:
      case OP_LE_I: case OP_GT_I: case OP_GE_I:
        VM_ROWS {
          rv[q] = vm_cmp_i(op, R[q].val(a), R[q].val(b));
          rk[q] = R[q].valid(a) && R[q].valid(b);
        }
        break;
      case OP_EQ_F: case OP_NE_F: case OP_LT_F:
      case OP_LE_F: case OP_GT_F: case OP_GE_F:
        VM_ROWS {
          rv[q] = vm_cmp_f(op, as_f64(R[q].val(a)), as_f64(R[q].val(b)));
          rk[q] = R[q].valid(a) && R[q].valid(b);
        }
        break;
      case OP_AND: case OP_OR: case OP_XOR:
        VM_ROWS {
          const bool at = R[q].val(a) != 0, bt = R[q].val(b) != 0;
          const bool aa = R[q].valid(a), bb = R[q].valid(b);
          if (op == OP_AND) {
            rv[q] = at && bt;
            rk[q] = (aa && bb) || (aa && !at) || (bb && !bt);
          } else if (op == OP_OR) {
            rv[q] = at || bt;
            rk[q] = (aa && bb) || (aa && at) || (bb && bt);
          } else {
            rv[q] = at != bt;
            rk[q] = aa && bb;
          }
        }
        break;
      case OP_NOT:
        VM_ROWS {
          rv[q] = R[q].val(a) == 0;
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_ADD_I: case OP_SUB_I: case OP_MUL_I:
        VM_ROWS {
          const u64 x = (u64)R[q].val(a), y = (u64)R[q].val(b);
          rv[q] = (i64)(op == OP_ADD_I ? x + y : op == OP_SUB_I ? x - y : x * y);
          rk[q] = R[q].valid(a) && R[q].valid(b);
        }
        break;
      case OP_IDIV_I: case OP_MOD_I:
        // truncating division, remainder with the dividend's sign;
        // divisor 0 -> NULL; -1 handled apart (INT64_MIN / -1 overflows)
        VM_ROWS {
          const i64 x = R[q].val(a), y = R[q].val(b);
          if (y == 0) rv[q] = op == OP_IDIV_I ? x : 0;
          else if (y == -1) rv[q] = op == OP_IDIV_I ? (i64)(0ULL - (u64)x) : 0;
          else rv[q] = op == OP_IDIV_I ? x / y : x % y;
          rk[q] = R[q].valid(a) && R[q].valid(b) && y != 0;
        }
        break;
      case OP_ADD_F: case OP_SUB_F: case OP_MUL_F:
        VM_ROWS {
          const double x = as_f64(R[q].val(a)), y = as_f64(R[q].val(b));
          rv[q] = as_i64(op == OP_ADD_F ? x + y : op == OP_SUB_F ? x - y : x * y);
          rk[q] = R[q].valid(a) && R[q].valid(b);
        }
        break;
      case OP_DIV_F: case OP_IDIV_F: case OP_MOD_F:
        VM_ROWS {
          const double x = as_f64(R[q].val(a)), y = as_f64(R[q].val(b));
          const bool zero = y == 0.0;
          const double safe = zero ? 1.0 : y;
          if (op == OP_DIV_F) rv[q] = as_i64(x / safe);
          else if (op == OP_IDIV_F) rv[q] = __double2ll_rz(trunc(x / safe));
          else rv[q] = as_i64(fmod(x, safe));
          rk[q] = R[q].valid(a) && R[q].valid(b) && !zero;
        }
        break;
      case OP_I2F:
        VM_ROWS {
          rv[q] = as_i64((double)R[q].val(a) / as_f64(pool[imm]));
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_MULC_I:
        VM_ROWS {
          rv[q] = (i64)((u64)R[q].val(a) * (u64)pool[imm]);
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_NEG_I:
        VM_ROWS {
          rv[q] = (i64)(0ULL - (u64)R[q].val(a));
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_NEG_F:
        VM_ROWS {
          rv[q] = as_i64(-as_f64(R[q].val(a)));
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_ISNULL: case OP_NOTNULL:
        VM_ROWS {
          rv[q] = R[q].valid(a) == (op == OP_NOTNULL);
          rk[q] = true;
        }
        break;
      case OP_IN_I: case OP_IN_F:
        VM_ROWS {
          bool hit = false;
          if (op == OP_IN_I) {
            const i64 x = R[q].val(a);
            for (i64 j = 0; j < b; ++j) hit |= pool[imm + j] == x;
          } else {
            const double x = as_f64(R[q].val(a));
            for (i64 j = 0; j < b; ++j) hit |= as_f64(pool[imm + j]) == x;
          }
          rv[q] = (c & 1) ? !hit : hit;
          rk[q] = R[q].valid(a) && (hit || !(c & 2));
        }
        break;
      case OP_LUT:
        VM_ROWS {
          i64 code = R[q].val(a);
          code = code < 0 ? 0 : (code > b - 1 ? b - 1 : code);
          const bool hit = lut[imm + code] != 0;
          rv[q] = c ? !hit : hit;
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_BOOLV:
        VM_ROWS {
          rv[q] = imm;
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_SELECT:
        VM_ROWS {
          const bool cond = R[q].val(a) != 0 && R[q].valid(a);
          rv[q] = cond ? R[q].val(b) : R[q].val(c);
          rk[q] = cond ? R[q].valid(b) : R[q].valid(c);
        }
        break;
      case OP_IFNULL:
        VM_ROWS {
          rv[q] = R[q].valid(a) ? R[q].val(a) : R[q].val(b);
          rk[q] = R[q].valid(a) || R[q].valid(b);
        }
        break;
      case OP_TRUTHY_I:
        VM_ROWS {
          rv[q] = R[q].val(a) != 0;
          rk[q] = R[q].valid(a);
        }
        break;
      case OP_TRUTHY_F:
        VM_ROWS {
          rv[q] = as_f64(R[q].val(a)) != 0.0;
          rk[q] = R[q].valid(a);
        }
        break;
      default:
        VM_ROWS {
          rv[q] = 0;
          rk[q] = false;
        }
    }
    VM_ROWS R[q].put(d, rv[q], rk[q]);
  }
}

#undef VM_ROWS

// Instructions [from, to) over one row into the register file `R`.
template <class Planes, class Regs>
__device__ __forceinline__ void vm_exec(const i64* __restrict__ ins, int from, int to, i64 row,
                                        const i64* __restrict__ pool,
                                        const unsigned char* __restrict__ lut,
                                        const Planes& pl, Regs& R) {
  const i64 rows[1] = {row};
  Regs one[1] = {R};
  vm_exec_rows<1>(ins, from, to, rows, pool, lut, pl, one);
  R = one[0];
}

// ---- K14 and K15's parameter block: everything a slot launch reads
// besides the planes' rows rides by value in the launch's parameters
// (__grid_constant__), so a launch copies nothing to the card first and
// never waits for the stream: the plane pointers, the program's
// instructions, the slots' constant pools (k rows of P), K15's
// reduction descriptors and the program's LUT. ops/kernels.py packs the
// parts (SLOT_* there mirror the limits) and the launcher picks the
// smaller block where the parts fit it. CUDA takes 32,764 bytes of
// parameters a launch (12.1 and later); the larger block and the
// launchers' other arguments stay well under that.
#define SLOT_MAX_INSTR 64      // exprc.MAX_INSTRS
#define SLOT_POOL_WORDS 2048   // k * P: sched.MAX_SLOTS x MAX_INSTRS
#define SLOT_LUT_BYTES 512
#define SLOT_MAX_RED 9         // K15's reductions a slot
#define SLOT_PARAM_LIMIT 32764

template <int NI, int NP, int NL>
struct SlotParams {
  static constexpr int MAX_INSTR = NI, POOL_WORDS = NP, LUT_BYTES = NL;
  u64 planes[VM_ROW_PLANES];
  i64 ins[6 * NI];
  i64 pools[NP];
  i64 desc[RED_DESC * SLOT_MAX_RED];
  unsigned char lut[NL];
};

typedef SlotParams<24, 256, 64> SlotParamsSmall;
typedef SlotParams<SLOT_MAX_INSTR, SLOT_POOL_WORDS, SLOT_LUT_BYTES> SlotParamsLarge;
static_assert(sizeof(SlotParamsLarge) + 256 <= SLOT_PARAM_LIMIT,
              "the slot parameter block and the launchers' other arguments "
              "exceed CUDA's parameter limit");

// Whether the parts fit the smaller block.
__host__ inline bool slot_small(int n_instr, i64 pool_words, int lut_len) {
  return n_instr <= SlotParamsSmall::MAX_INSTR && pool_words <= SlotParamsSmall::POOL_WORDS &&
         lut_len <= SlotParamsSmall::LUT_BYTES;
}

// Fill a block's parts from host arrays; -1 where a part does not fit.
template <class Prm>
static int slot_fill(Prm* p, const u64* planes, int n_planes, const i64* ins, int n_instr,
                     const i64* pools, i64 pool_words, const unsigned char* lut, int lut_len,
                     const i64* desc, int n_red) {
  if (n_planes < 0 || n_planes > VM_ROW_PLANES || n_instr < 0 || n_instr > Prm::MAX_INSTR ||
      pool_words < 1 || pool_words > Prm::POOL_WORDS || lut_len < 0 ||
      lut_len > Prm::LUT_BYTES || n_red < 0 || n_red > SLOT_MAX_RED)
    return -1;
  if (n_planes > 0) memcpy(p->planes, planes, 8 * (size_t)n_planes);
  if (n_instr > 0) memcpy(p->ins, ins, 48 * (size_t)n_instr);
  memcpy(p->pools, pools, 8 * (size_t)pool_words);
  if (n_red > 0) memcpy(p->desc, desc, 8 * RED_DESC * (size_t)n_red);
  if (lut_len > 0) memcpy(p->lut, lut, (size_t)lut_len);
  return 0;
}
