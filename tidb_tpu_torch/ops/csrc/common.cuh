// Shared definitions of the coprocessor kernels (sm_90a).
//
// The numbers below are the contract with tidb_tpu_torch/ops/exprc.py
// (K1 bytecode) and tidb_tpu_torch/ops/kernels.py (reduction ops); the
// CPU tests parse this file and hold the two sides equal.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef long long i64;
typedef unsigned long long u64;

// ---- K1 bytecode: instruction = (op, dst, a, b, c, imm) as int64 ----
enum K1Op {
  OP_LOAD = 0,
  OP_CONST = 1,
  OP_EQ_I = 2, OP_NE_I = 3, OP_LT_I = 4, OP_LE_I = 5, OP_GT_I = 6, OP_GE_I = 7,
  OP_EQ_F = 8, OP_NE_F = 9, OP_LT_F = 10, OP_LE_F = 11, OP_GT_F = 12, OP_GE_F = 13,
  OP_AND = 14, OP_OR = 15, OP_XOR = 16,
  OP_NOT = 17,
  OP_ADD_I = 18, OP_SUB_I = 19, OP_MUL_I = 20, OP_IDIV_I = 21, OP_MOD_I = 22,
  OP_ADD_F = 23, OP_SUB_F = 24, OP_MUL_F = 25, OP_DIV_F = 26, OP_IDIV_F = 27,
  OP_MOD_F = 28,
  OP_I2F = 29,
  OP_MULC_I = 30,
  OP_NEG_I = 31, OP_NEG_F = 32,
  OP_ISNULL = 33, OP_NOTNULL = 34,
  OP_IN_I = 35, OP_IN_F = 36,
  OP_LUT = 37,
  OP_BOOLV = 38,
  OP_SELECT = 39,
  OP_IFNULL = 40,
  OP_TRUTHY_I = 41, OP_TRUTHY_F = 42,
};

#define K1_HDR 8
#define K1_MAX_REGS 16
#define K1_MAX_META 1024

// ---- reductions of K2/K3/K4 ----
// A reduction descriptor is five int64: (op, flags, const_bits, values
// pointer, valid pointer). flags bit0: the value is the constant
// const_bits (no values plane); bit1: the argument is a NULL constant and
// no row contributes. A null valid pointer means every row is valid.
enum RedOp {
  R_COUNT = 0,   // n = #contrib
  R_SUM_I = 1,   // n, wrapping int64 sum
  R_SUM_F = 2,   // n, f64 sum
  R_MIN_I = 3, R_MAX_I = 4,  // n, extremum with I64_MAX / I64_MIN sentinel
  R_MIN_F = 5, R_MAX_F = 6,  // n, extremum with +-DBL_MAX sentinel
  R_FIRST = 7,   // n = #mask rows, smallest row index among them
};

#define RED_DESC 5
#define RED_CONST 1
#define RED_NEVER 2

#define I64_MAX_V 0x7fffffffffffffffLL
#define I64_MIN_V (-I64_MAX_V - 1LL)
#define F64_MAX_V 1.7976931348623157e308

__device__ __forceinline__ double as_f64(i64 b) { return __longlong_as_double(b); }
__device__ __forceinline__ i64 as_i64(double d) { return __double_as_longlong(d); }

// The value half of a reduction's monoid, shared by every kernel that
// reduces (K2..K4 through Acc, K6 and K7 on bare values): its identity
// (the exact sentinel of an extremum) and its merge, `a` first in the
// fixed order. Counts and int64 sums add with two's complement wrap.
__device__ __forceinline__ i64 val_ident(int op) {
  switch (op) {
    case R_MIN_I: case R_FIRST: return I64_MAX_V;
    case R_MAX_I: return I64_MIN_V;
    case R_MIN_F: return as_i64(F64_MAX_V);
    case R_MAX_F: return as_i64(-F64_MAX_V);
    default: return 0;   // counts, int sums, and +0.0 for f64 sums
  }
}

__device__ __forceinline__ i64 val_merge(int op, i64 a, i64 b) {
  switch (op) {
    case R_SUM_F: return as_i64(as_f64(a) + as_f64(b));
    case R_MIN_I: case R_FIRST: return b < a ? b : a;
    case R_MAX_I: return b > a ? b : a;
    case R_MIN_F: return as_f64(b) < as_f64(a) ? b : a;
    case R_MAX_F: return as_f64(b) > as_f64(a) ? b : a;
    default: return (i64)((u64)a + (u64)b);
  }
}

// The accumulator of one reduction over some rows: a count and a 64-bit
// value (int64, or the bits of an f64; 0 for R_COUNT).
struct Acc {
  i64 n;
  i64 v;
};

__device__ __forceinline__ Acc acc_init(int op) {
  Acc a;
  a.n = 0;
  a.v = val_ident(op);
  return a;
}

// Fold one value in (the caller has decided it contributes).
__device__ __forceinline__ void acc_add(int op, Acc& a, i64 x) {
  a.n += 1;
  if (op != R_COUNT) a.v = val_merge(op, a.v, x);
}

// Combine two partial accumulators; `a` comes first in the fixed order.
__device__ __forceinline__ Acc acc_merge(int op, Acc a, Acc b) {
  Acc r;
  r.n = a.n + b.n;
  r.v = val_merge(op, a.v, b.v);
  return r;
}

// Whether row `row` contributes to reduction `d` under `mask`, and its
// value. R_FIRST contributes every mask row with its row index.
__device__ __forceinline__ bool red_take(const i64* d, const unsigned char* mask,
                                         i64 row, i64* x) {
  if (!mask[row]) return false;
  int op = (int)d[0];
  if (op == R_FIRST) { *x = row; return true; }
  int flags = (int)d[1];
  if (flags & RED_NEVER) return false;
  const unsigned char* valid = (const unsigned char*)d[4];
  if (valid != nullptr && !valid[row]) return false;
  *x = (flags & RED_CONST) ? d[2] : ((const i64*)d[3])[row];
  return true;
}

// Fixed-order warp reduction (butterfly down to lane 0).
__device__ __forceinline__ Acc warp_merge(int op, Acc a) {
  for (int off = 16; off > 0; off >>= 1) {
    Acc b;
    b.n = __shfl_down_sync(0xffffffffu, a.n, off);
    b.v = __shfl_down_sync(0xffffffffu, a.v, off);
    a = acc_merge(op, a, b);
  }
  return a;
}

// First index in a[lo, hi) (ascending) whose value is >= key.
__device__ __forceinline__ i64 lower_bound_i64(const i64* a, i64 lo, i64 hi, i64 key) {
  while (lo < hi) {
    const i64 mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}
