// The K1 bytecode interpreter, shared by K1 and K5 (expr_vm.cu), K14
// (slot_filter.cu) and K15 (slot_agg.cu).
//
// One thread runs the whole program for one row; registers v/ok live in
// local memory. A plane slot of the program (OP_LOAD's a and b) names an
// 8-byte value plane or a 1-byte valid plane; how the slot is read is the
// caller's choice:
//   VmPlanes reads the device planes directly (K1, K5: one program run
//            per row, so each plane is read once anyway);
//   VmRow    reads one row's planes loaded beforehand (K14, K15: one row
//            runs the program once per slot, with another constant pool
//            each time, and loads its planes only once).
#pragma once

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

// At most this many plane slots per row (kernels.SLOT_MAX_PLANES).
#define VM_ROW_PLANES 16

struct VmRow {
  i64 vals[VM_ROW_PLANES];   // per slot: the row's value, or its valid byte

  // Load row `row` of the n_planes planes; bit j of valid_bits marks slot
  // j as a valid (1-byte) plane.
  __device__ __forceinline__ void load(const u64* __restrict__ planes, int n_planes,
                                       unsigned valid_bits, i64 row) {
    for (int j = 0; j < n_planes; ++j)
      vals[j] = (valid_bits >> j) & 1u ? (i64)((const unsigned char*)planes[j])[row]
                                       : ((const i64*)planes[j])[row];
  }
  __device__ __forceinline__ i64 value(i64 slot, i64) const { return vals[slot]; }
  __device__ __forceinline__ bool valid(i64 slot, i64) const { return vals[slot] != 0; }
};

// Run a K1 program over one row: registers v/ok hold every result. `pl`
// reads the row's planes (VmPlanes or VmRow).
template <class Planes>
__device__ __forceinline__ void vm_run(const i64* __restrict__ ins, int n_instr, i64 row,
                                       const i64* __restrict__ pool,
                                       const unsigned char* __restrict__ lut, const Planes& pl,
                                       i64* v, bool* ok) {
  for (int k = 0; k < n_instr; ++k) {
    const i64* in = ins + 6 * k;
    const int op = (int)in[0];
    const int d = (int)in[1];
    const i64 a = in[2], b = in[3], c = in[4], imm = in[5];
    i64 rv = 0;
    bool rk = false;
    switch (op) {
      case OP_LOAD:
        rv = pl.value(a, row);
        rk = b < 0 ? true : pl.valid(b, row);
        break;
      case OP_CONST:
        rv = pool[imm];
        rk = a != 0;
        break;
      case OP_EQ_I: case OP_NE_I: case OP_LT_I:
      case OP_LE_I: case OP_GT_I: case OP_GE_I: {
        const i64 x = v[a], y = v[b];
        bool r;
        switch (op) {
          case OP_EQ_I: r = x == y; break;
          case OP_NE_I: r = x != y; break;
          case OP_LT_I: r = x < y; break;
          case OP_LE_I: r = x <= y; break;
          case OP_GT_I: r = x > y; break;
          default: r = x >= y;
        }
        rv = r;
        rk = ok[a] && ok[b];
        break;
      }
      case OP_EQ_F: case OP_NE_F: case OP_LT_F:
      case OP_LE_F: case OP_GT_F: case OP_GE_F: {
        const double x = as_f64(v[a]), y = as_f64(v[b]);
        bool r;
        switch (op) {
          case OP_EQ_F: r = x == y; break;
          case OP_NE_F: r = x != y; break;
          case OP_LT_F: r = x < y; break;
          case OP_LE_F: r = x <= y; break;
          case OP_GT_F: r = x > y; break;
          default: r = x >= y;
        }
        rv = r;
        rk = ok[a] && ok[b];
        break;
      }
      case OP_AND: case OP_OR: case OP_XOR: {
        const bool at = v[a] != 0, bt = v[b] != 0;
        const bool aa = ok[a], bb = ok[b];
        if (op == OP_AND) {
          rv = at && bt;
          rk = (aa && bb) || (aa && !at) || (bb && !bt);
        } else if (op == OP_OR) {
          rv = at || bt;
          rk = (aa && bb) || (aa && at) || (bb && bt);
        } else {
          rv = at != bt;
          rk = aa && bb;
        }
        break;
      }
      case OP_NOT:
        rv = v[a] == 0;
        rk = ok[a];
        break;
      case OP_ADD_I: rv = (i64)((u64)v[a] + (u64)v[b]); rk = ok[a] && ok[b]; break;
      case OP_SUB_I: rv = (i64)((u64)v[a] - (u64)v[b]); rk = ok[a] && ok[b]; break;
      case OP_MUL_I: rv = (i64)((u64)v[a] * (u64)v[b]); rk = ok[a] && ok[b]; break;
      case OP_IDIV_I: case OP_MOD_I: {
        // truncating division, remainder with the dividend's sign;
        // divisor 0 -> NULL; -1 handled apart (INT64_MIN / -1 overflows)
        const i64 x = v[a], y = v[b];
        if (y == 0) rv = op == OP_IDIV_I ? x : 0;
        else if (y == -1) rv = op == OP_IDIV_I ? (i64)(0ULL - (u64)x) : 0;
        else rv = op == OP_IDIV_I ? x / y : x % y;
        rk = ok[a] && ok[b] && y != 0;
        break;
      }
      case OP_ADD_F: rv = as_i64(as_f64(v[a]) + as_f64(v[b])); rk = ok[a] && ok[b]; break;
      case OP_SUB_F: rv = as_i64(as_f64(v[a]) - as_f64(v[b])); rk = ok[a] && ok[b]; break;
      case OP_MUL_F: rv = as_i64(as_f64(v[a]) * as_f64(v[b])); rk = ok[a] && ok[b]; break;
      case OP_DIV_F: case OP_IDIV_F: case OP_MOD_F: {
        const double x = as_f64(v[a]), y = as_f64(v[b]);
        const bool zero = y == 0.0;
        const double safe = zero ? 1.0 : y;
        if (op == OP_DIV_F) rv = as_i64(x / safe);
        else if (op == OP_IDIV_F) rv = __double2ll_rz(trunc(x / safe));
        else rv = as_i64(fmod(x, safe));
        rk = ok[a] && ok[b] && !zero;
        break;
      }
      case OP_I2F: rv = as_i64((double)v[a] / as_f64(pool[imm])); rk = ok[a]; break;
      case OP_MULC_I: rv = (i64)((u64)v[a] * (u64)pool[imm]); rk = ok[a]; break;
      case OP_NEG_I: rv = (i64)(0ULL - (u64)v[a]); rk = ok[a]; break;
      case OP_NEG_F: rv = as_i64(-as_f64(v[a])); rk = ok[a]; break;
      case OP_ISNULL: rv = !ok[a]; rk = true; break;
      case OP_NOTNULL: rv = ok[a]; rk = true; break;
      case OP_IN_I: case OP_IN_F: {
        bool hit = false;
        if (op == OP_IN_I) {
          const i64 x = v[a];
          for (i64 j = 0; j < b; ++j) hit |= pool[imm + j] == x;
        } else {
          const double x = as_f64(v[a]);
          for (i64 j = 0; j < b; ++j) hit |= as_f64(pool[imm + j]) == x;
        }
        rv = (c & 1) ? !hit : hit;
        rk = ok[a] && (hit || !(c & 2));
        break;
      }
      case OP_LUT: {
        i64 code = v[a];
        code = code < 0 ? 0 : (code > b - 1 ? b - 1 : code);
        const bool hit = lut[imm + code] != 0;
        rv = c ? !hit : hit;
        rk = ok[a];
        break;
      }
      case OP_BOOLV: rv = imm; rk = ok[a]; break;
      case OP_SELECT: {
        const bool cond = v[a] != 0 && ok[a];
        rv = cond ? v[b] : v[c];
        rk = cond ? ok[b] : ok[c];
        break;
      }
      case OP_IFNULL:
        rv = ok[a] ? v[a] : v[b];
        rk = ok[a] || ok[b];
        break;
      case OP_TRUTHY_I: rv = v[a] != 0; rk = ok[a]; break;
      case OP_TRUTHY_F: rv = as_f64(v[a]) != 0.0; rk = ok[a]; break;
      default: break;
    }
    v[d] = rv;
    ok[d] = rk;
  }
}
