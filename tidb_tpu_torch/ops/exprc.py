"""Compile pushdown Expr trees to a bytecode program (the port of
tidb_tpu/ops/exprc.py:35-700).

The reference lowers an Expr tree into jnp closures that XLA fuses into
each kernel. The port lowers the same tree, with the same `Unsupported`
decisions and the same host-side scale and bound proofs, into a small
register program that kernel K1 (`ops/csrc/expr_vm.cu`) interprets four
rows a thread at once, and that `run_program_plain` interprets with torch ops
one instruction at a time over whole planes (K1's plain version).

Value model: a register holds a 64-bit value (int64, or the bits of an
f64) plus a valid bit — SQL three-valued logic without branches:
    AND: false dominates NULL;  OR: true dominates NULL;
    comparisons/arithmetic propagate NULL via valid = va & vb.
Booleans are int64 0/1. A `CompiledExpr` records, beside its register,
the reference's `kind` (i64 / f64 / dec / bool) and the physical type
`dt` of its register ('i', 'f', or 'b' for a 0/1 boolean), which the
reference reads off the jnp dtype.

String semantics ride the ordered dictionary (ops.columnar): =, <, IN and
prefix-LIKE become integer compares against host-computed codes; general
LIKE evaluates the pattern over the dictionary on the host and becomes a
LUT gather.

One `Program` holds every output a request needs: the WHERE, each
aggregate argument, and (in K1) the group id. `Program.finalize` drops
dead instructions, maps the unbounded virtual registers onto at most
MAX_REGS physical ones and lays the program out as the int64 array K1
reads.
"""

from __future__ import annotations

import re
import struct
import threading
from decimal import Decimal

import numpy as np
import torch

from tidb_tpu_torch import errors, mysqldef as my
from tidb_tpu_torch.copr.proto import Expr, ExprType
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import Datum, Kind


class Unsupported(errors.TiDBError):
    """Request shape outside what the port serves; raised, never answered
    elsewhere (the port has no CPU row engine yet)."""


# largest result scale a fixed-point product may reach before the scaled
# int64 sum headroom (9.2e18 / 10^scale) gets too small
MAX_DEC_SCALE = 6

# exact-arithmetic bound: intermediate scaled values must stay below this
# or the request is refused (int64 would silently wrap)
DEC_ABS_LIMIT = 1 << 62

# K1 limits: the program rides in the launch's parameters, its registers
# in shared memory (a column a row of the block)
MAX_INSTRS = 64
MAX_REGS = 16

# ---------------------------------------------------------------------------
# bytecode. The numbers are the contract with ops/csrc/common.cuh.
# An instruction is six int64: (op, dst, a, b, c, imm).
# ---------------------------------------------------------------------------

OP_LOAD = 0        # dst <- plane a (8-byte values), valid plane b (-1: all)
OP_CONST = 1       # dst <- pool[imm], valid a
OP_EQ_I, OP_NE_I, OP_LT_I, OP_LE_I, OP_GT_I, OP_GE_I = 2, 3, 4, 5, 6, 7
OP_EQ_F, OP_NE_F, OP_LT_F, OP_LE_F, OP_GT_F, OP_GE_F = 8, 9, 10, 11, 12, 13
OP_AND, OP_OR, OP_XOR = 14, 15, 16   # 3VL over 0/1 operands
OP_NOT = 17
OP_ADD_I, OP_SUB_I, OP_MUL_I, OP_IDIV_I, OP_MOD_I = 18, 19, 20, 21, 22
OP_ADD_F, OP_SUB_F, OP_MUL_F, OP_DIV_F, OP_IDIV_F, OP_MOD_F = \
    23, 24, 25, 26, 27, 28
OP_I2F = 29        # dst <- f64(a) / pool[imm] (f64 divisor 10^scale)
OP_MULC_I = 30     # dst <- a * pool[imm] (decimal rescale, wrapping)
OP_NEG_I, OP_NEG_F = 31, 32
OP_ISNULL, OP_NOTNULL = 33, 34
OP_IN_I, OP_IN_F = 35, 36   # a in pool[imm:imm+b]; c bit0 negated, bit1 has_null
OP_LUT = 37        # lut[imm + clip(a, 0, b-1)]; c negated
OP_BOOLV = 38      # dst <- imm, valid of a
OP_SELECT = 39     # a (0/1 cond) ? b : c
OP_IFNULL = 40     # valid(a) ? a : b
OP_TRUTHY_I, OP_TRUTHY_F = 41, 42

# register operands per op: (a is reg, b is reg, c is reg)
_REG_ARGS = {OP_LOAD: (0, 0, 0), OP_CONST: (0, 0, 0), OP_BOOLV: (1, 0, 0),
             OP_SELECT: (1, 1, 1), OP_IFNULL: (1, 1, 0)}
for _op in (OP_NOT, OP_I2F, OP_MULC_I, OP_NEG_I, OP_NEG_F, OP_ISNULL,
            OP_NOTNULL, OP_IN_I, OP_IN_F, OP_LUT, OP_TRUTHY_I, OP_TRUTHY_F):
    _REG_ARGS[_op] = (1, 0, 0)
for _op in range(OP_EQ_I, OP_MOD_F + 1):
    _REG_ARGS.setdefault(_op, (1, 1, 0))
del _op

_CMP_I = {Op.EQ: OP_EQ_I, Op.NE: OP_NE_I, Op.LT: OP_LT_I, Op.LE: OP_LE_I,
          Op.GT: OP_GT_I, Op.GE: OP_GE_I}
_CMP_F = {Op.EQ: OP_EQ_F, Op.NE: OP_NE_F, Op.LT: OP_LT_F, Op.LE: OP_LE_F,
          Op.GT: OP_GT_F, Op.GE: OP_GE_F}

# program array header (int64 slots before the instructions)
HDR = 8


def _f64_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(v)))[0]


class Program:
    """A register program under construction over one ColumnBatch."""

    def __init__(self, batch: col.ColumnBatch):
        self.batch = batch
        self.instrs: list[list[int]] = []   # virtual registers
        self.pool: list[int] = []           # int64 / f64 bit patterns
        self.lut = bytearray()
        self.plane_keys: list[tuple] = []   # (planes key, 0 values | 1 valid)
        self._plane_slot: dict = {}
        self._const_slot: dict = {}
        self._emitted: dict = {}            # instruction → its register
        self._n_vregs = 0

    def plane(self, key, which: int) -> int:
        k = (key, which)
        slot = self._plane_slot.get(k)
        if slot is None:
            slot = self._plane_slot[k] = len(self.plane_keys)
            self.plane_keys.append(k)
        return slot

    def const_slot(self, bits: int) -> int:
        slot = self._const_slot.get(int(bits))
        if slot is None:
            slot = self._const_slot[int(bits)] = len(self.pool)
            self.pool.append(int(bits))
        return slot

    def emit(self, op: int, a: int = -1, b: int = -1, c: int = -1,
             imm: int = 0) -> int:
        """Register of the instruction's result. Every op is a pure
        function of its operands, so an instruction already emitted is
        not emitted again (the expressions of one request share their
        common parts, e.g. Q1's price * (1 - discount))."""
        key = (op, a, b, c, imm)
        dst = self._emitted.get(key)
        if dst is None:
            dst = self._emitted[key] = self._n_vregs
            self._n_vregs += 1
            self.instrs.append([op, dst, a, b, c, imm])
        return dst

    def column(self, cid) -> int:
        return self.emit(OP_LOAD, self.plane(cid, 0), self.plane(cid, 1))

    def finalize(self, where: "CompiledExpr | None", outputs: list,
                 group: list | None = None, sink: int = 0) -> "Finalized":
        """Lay the program out for K1. `outputs` are CompiledExprs whose
        (values, valid) planes K1 writes; `group` is [(planes key, size)]
        of the mixed-radix group id K1 computes (NULL → slot `size`, dead
        row → `sink`)."""
        group = group or []
        where_v = None
        if where is not None:
            where_v = where.reg
            if where.dt == "f":
                where_v = self.emit(OP_TRUTHY_F, where_v)
        out_v = [o.reg for o in outputs]
        roots = set(out_v) | ({where_v} if where_v is not None else set())
        # dead-code elimination, backwards
        live_v = set(roots)
        keep = []
        for ins in reversed(self.instrs):
            if ins[1] not in live_v:
                continue
            keep.append(ins)
            for is_reg, v in zip(_REG_ARGS[ins[0]], ins[2:5]):
                if is_reg:
                    live_v.add(v)
        keep.reverse()
        if len(keep) > MAX_INSTRS:
            raise Unsupported(f"expression program of {len(keep)} "
                              f"instructions exceeds {MAX_INSTRS}")
        # linear-scan register allocation: an operand's register frees
        # after its last use, so the same instruction may reuse it
        last = {}
        for i, ins in enumerate(keep):
            for is_reg, v in zip(_REG_ARGS[ins[0]], ins[2:5]):
                if is_reg:
                    last[v] = i
        for v in roots:
            last[v] = len(keep)
        free = list(range(MAX_REGS - 1, -1, -1))
        phys: dict[int, int] = {}
        code = []
        for i, ins in enumerate(keep):
            op, dst, a, b, c, imm = ins
            ra = [phys[v] if is_reg else v
                  for is_reg, v in zip(_REG_ARGS[op], (a, b, c))]
            for is_reg, v in zip(_REG_ARGS[op], (a, b, c)):
                if is_reg and last.get(v) == i and v in phys:
                    free.append(phys.pop(v))
            if not free:
                raise Unsupported(f"expression needs more than {MAX_REGS} "
                                  "registers")
            # every kept instruction's result is read later or is a root
            phys[dst] = free.pop()
            code.append([op, phys[dst]] + ra + [imm])
        # the plane table holds only planes a kept LOAD or the group id
        # reads (a column whose LOAD was dropped is read by no kernel)
        plane_keys: list[tuple] = []
        slot_of: dict[tuple, int] = {}

        def slot(key_which) -> int:
            if key_which not in slot_of:
                slot_of[key_which] = len(plane_keys)
                plane_keys.append(key_which)
            return slot_of[key_which]

        for ins in code:
            if ins[0] == OP_LOAD:
                ins[2] = slot(self.plane_keys[ins[2]])
                ins[3] = slot(self.plane_keys[ins[3]]) if ins[3] >= 0 else -1
        group_slots = [(slot((key, 0)), slot((key, 1)), int(size),
                        int(size) + 1) for key, size in group]
        meta = [len(code), phys[where_v] if where_v is not None else -1,
                len(out_v), len(group_slots), int(sink),
                len(plane_keys), 0, 0]
        for ins in code:
            meta.extend(ins)
        meta.extend(phys[v] for v in out_v)
        for g in group_slots:
            meta.extend(g)
        return Finalized(np.asarray(meta, dtype=np.int64),
                         np.asarray(self.pool or [0], dtype=np.int64),
                         np.frombuffer(bytes(self.lut) or b"\0",
                                       dtype=np.uint8).copy(),
                         plane_keys, [o.dt for o in outputs])


class Finalized:
    """A laid-out program: what K1 and its plain version run."""

    def __init__(self, meta, pool, lut, plane_keys, out_dts):
        self.meta = meta
        self.pool = pool
        self.lut = lut
        self.plane_keys = plane_keys
        self.out_dts = out_dts

    @property
    def n_instr(self) -> int:
        return int(self.meta[0])

    def instructions(self):
        for k in range(self.n_instr):
            yield [int(x) for x in self.meta[HDR + 6 * k: HDR + 6 * k + 6]]

    def tail(self):
        """(where register, output registers, group slots)."""
        n_instr, where, n_out, n_group = (int(x) for x in self.meta[:4])
        off = HDR + 6 * n_instr
        outs = [int(x) for x in self.meta[off:off + n_out]]
        off += n_out
        grp = [tuple(int(x) for x in self.meta[off + 4 * j: off + 4 * j + 4])
               for j in range(n_group)]
        return where, outs, grp


class CompiledExpr:
    """A lowered expression: register `reg` of `prog`, plus the lowering
    metadata of the reference's CompiledExpr.

    kind 'dec' is EXACT fixed-point: an int64 plane scaled by 10^scale,
    with max_abs bounding |values| (from the batch's actual data) so every
    derived expression can PROVE it cannot overflow — an unprovable shape
    raises Unsupported. Mixing with a float converts to f64."""

    def __init__(self, prog: Program, reg, kind: str, dt: str,
                 scale: int = 0, max_abs: int | None = None,
                 cid=None, const=None):
        self.prog = prog
        self.reg = reg
        self.kind = kind  # result kind: i64 / f64 / dec / bool / strconst
        self.dt = dt      # register type: 'i' / 'f' / 'b'
        self.scale = scale
        self.max_abs = max_abs  # None = no tracked bound (0 IS a bound)
        self.cid = cid    # plain column reference: its planes are the value
        self.const = const  # constant: (64-bit pattern, valid)


def _dec_guard(bound: int, what: str) -> int:
    if bound >= DEC_ABS_LIMIT:
        raise Unsupported(f"fixed-point {what} may exceed int64 "
                          "(exact result is not served)")
    return bound


def compile_expr(e: Expr, batch: col.ColumnBatch,
                 prog: Program | None = None) -> CompiledExpr:
    if prog is None:
        prog = Program(batch)
    tp = e.tp

    if tp == ExprType.VALUE:
        return _const(prog, e.val)
    if tp == ExprType.NULL:
        return _null(prog)
    if tp == ExprType.COLUMN_REF:
        cid = e.val
        cd = batch.columns.get(cid)
        if cd is None:
            raise Unsupported(f"column {cid} not packed")
        kind = cd.kind
        return CompiledExpr(prog, prog.column(cid),
                            col.K_I64 if kind == col.K_STR else kind,
                            "f" if kind == col.K_F64 else "i",
                            scale=getattr(cd, "dec_scale", 0),
                            max_abs=getattr(cd, "max_abs", 0), cid=cid)
    if tp == ExprType.OPERATOR:
        return _compile_operator(e, batch, prog)
    if tp in (ExprType.IN, ExprType.NOT_IN):
        return _compile_in(e, batch, prog, negated=(tp == ExprType.NOT_IN))
    if tp in (ExprType.LIKE, ExprType.NOT_LIKE):
        return _compile_like(e, batch, prog,
                             negated=(tp == ExprType.NOT_LIKE))
    if tp in (ExprType.IS_NULL, ExprType.IS_NOT_NULL):
        c = _operand(compile_expr(e.children[0], batch, prog))
        op = OP_ISNULL if tp == ExprType.IS_NULL else OP_NOTNULL
        return CompiledExpr(prog, prog.emit(op, c.reg), "bool", "b")
    if tp == ExprType.IF:
        return _compile_if(e, batch, prog)
    if tp == ExprType.IFNULL:
        a = _operand(compile_expr(e.children[0], batch, prog))
        b = _operand(compile_expr(e.children[1], batch, prog))
        kind = _merge_kind(a.kind, b.kind)
        ra, rb, dt = _promote(prog, a, b, kind)
        return CompiledExpr(prog, prog.emit(OP_IFNULL, ra, rb), kind, dt)
    raise Unsupported(f"expr type {tp!r} has no device lowering")


# ---------------------------------------------------------------------------
# leaves / helpers
# ---------------------------------------------------------------------------

def _null(prog: Program) -> CompiledExpr:
    return CompiledExpr(prog, prog.emit(OP_CONST, 0, imm=prog.const_slot(0)),
                        col.K_I64, "i", const=(0, False))


def _const_i(prog: Program, v: int) -> int:
    return prog.emit(OP_CONST, 1, imm=prog.const_slot(v))


def _const(prog: Program, d: Datum) -> CompiledExpr:
    if d.is_null():
        return _null(prog)
    k = d.kind
    if k in (Kind.INT64, Kind.UINT64):
        v = int(d.val)
        if not (col.I64_MIN <= v <= col.I64_MAX):
            raise Unsupported(f"integer constant {v} outside int64")
        return CompiledExpr(prog, _const_i(prog, v), col.K_I64, "i",
                            max_abs=abs(v), const=(v, True))
    if k == Kind.FLOAT64:
        bits = _f64_bits(float(d.val))
        return CompiledExpr(prog, prog.emit(OP_CONST, 1,
                                            imm=prog.const_slot(bits)),
                            col.K_F64, "f", const=(bits, True))
    if k == Kind.DECIMAL:
        # exact fixed-point at the constant's own scale
        dv: Decimal = d.val
        exp = -dv.as_tuple().exponent
        scale = max(0, exp)
        if scale > MAX_DEC_SCALE:
            raise Unsupported(f"decimal constant scale {scale} too fine")
        iv = int(dv * (10 ** scale))
        _dec_guard(abs(iv), "constant")
        return CompiledExpr(prog, _const_i(prog, iv), col.K_DEC, "i",
                            scale=scale, max_abs=abs(iv), const=(iv, True))
    if k == Kind.TIME:
        v = int(d.val.to_packed_int())  # plane encoding (columnar)
        return CompiledExpr(prog, _const_i(prog, v), col.K_I64, "i",
                            const=(v, True))
    if k in (Kind.STRING, Kind.BYTES):
        # only meaningful against a dict column; handled by comparison
        # lowering (needs the dictionary) — flag with a marker kind
        ce = CompiledExpr(prog, None, "strconst", "i")
        ce.str_value = d.get_bytes()
        return ce
    raise Unsupported(f"constant kind {k!r}")


def _operand(c: CompiledExpr) -> CompiledExpr:
    """A string constant evaluates nowhere but inside a comparison against
    a dict column (the reference faults on it when it traces)."""
    if c.kind == "strconst":
        raise Unsupported("string constant outside dict comparison")
    return c


def _merge_kind(a: str, b: str) -> str:
    if col.K_DEC in (a, b):
        # IF/IFNULL branches would need scale unification
        raise Unsupported("decimal in control function is not served")
    if "f64" in (a, b):
        return col.K_F64
    return col.K_I64


def _promote(prog: Program, a: CompiledExpr, b: CompiledExpr, kind: str):
    """IF/IFNULL branch registers and result register type."""
    if kind == col.K_F64:
        return _as_f64(prog, a, 1.0), _as_f64(prog, b, 1.0), "f"
    return a.reg, b.reg, ("b" if a.dt == b.dt == "b" else "i")


def _as_f64(prog: Program, c: CompiledExpr, divisor: float) -> int:
    """Register holding c as f64, divided by `divisor` when converted."""
    if c.dt == "f":
        return c.reg
    return prog.emit(OP_I2F, c.reg, imm=prog.const_slot(_f64_bits(divisor)))


def _to_f64(prog: Program, c: CompiledExpr) -> int:
    return _as_f64(prog, c, 10.0 ** c.scale
                   if c.kind == col.K_DEC and c.scale else 1.0)


def _truthy(prog: Program, c: CompiledExpr) -> int:
    if c.dt == "b":
        return c.reg
    return prog.emit(OP_TRUTHY_F if c.dt == "f" else OP_TRUTHY_I, c.reg)


def _align(prog: Program, ca: CompiledExpr, cb: CompiledExpr):
    """Common representation for a binary numeric op: returns
    (reg_a, reg_b, kind, scale). Fixed-point decimals stay EXACT (rescale
    to the max scale as int64); a float operand drags both sides into f64
    (MySQL float context)."""
    ka, kb = ca.kind, cb.kind
    if col.K_F64 in (ka, kb):
        return _to_f64(prog, ca), _to_f64(prog, cb), col.K_F64, 0
    if col.K_DEC in (ka, kb):
        sa = ca.scale if ka == col.K_DEC else 0
        sb = cb.scale if kb == col.K_DEC else 0
        s = max(sa, sb)
        # rescaling multiplies the plane — prove it can't wrap
        _dec_guard(_max_abs_of(ca) * 10 ** (s - sa), "rescale")
        _dec_guard(_max_abs_of(cb) * 10 ** (s - sb), "rescale")

        def scaled(c, sc):
            mul = 10 ** (s - sc)
            if mul == 1:
                return c.reg
            return prog.emit(OP_MULC_I, c.reg, imm=prog.const_slot(mul))
        return scaled(ca, sa), scaled(cb, sb), col.K_DEC, s
    return ca.reg, cb.reg, col.K_I64, 0


def _max_abs_of(c: CompiledExpr) -> int:
    """Magnitude bound of an operand feeding fixed-point arithmetic; a
    derived i64 expression without one CANNOT be proven safe."""
    if c.max_abs is not None:
        return c.max_abs
    if c.kind == col.K_DEC:
        return 0  # dec without a bound only arises for empty planes
    raise Unsupported(
        "operand magnitude unknown in fixed-point arithmetic "
        "(exact result is not served)")


def _str_column_of(e: Expr, batch: col.ColumnBatch) -> col.ColumnData | None:
    if e.tp == ExprType.COLUMN_REF:
        cd = batch.columns.get(e.val)
        if cd is not None and cd.kind == col.K_STR:
            return cd
    return None


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

_CMP_OPS = {Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE}
_ARITH_OPS = {Op.Plus, Op.Minus, Op.Mul, Op.Div}
_LOGIC_OPS = {Op.AndAnd, Op.OrOr, Op.Xor}


def _compile_operator(e: Expr, batch, prog: Program) -> CompiledExpr:
    op = e.op
    if len(e.children) == 1:
        c = _operand(compile_expr(e.children[0], batch, prog))
        if op in (Op.UnaryNot, Op.Not):
            return CompiledExpr(prog, prog.emit(OP_NOT, _truthy(prog, c)),
                                "bool", "b")
        if op == Op.UnaryMinus:
            if c.dt == "b":
                raise Unsupported("negation of a boolean")
            return CompiledExpr(
                prog, prog.emit(OP_NEG_F if c.dt == "f" else OP_NEG_I,
                                c.reg),
                c.kind, c.dt, scale=c.scale, max_abs=c.max_abs)
        if op == Op.UnaryPlus:
            return c
        raise Unsupported(f"unary op {op!r}")

    if op in _CMP_OPS:
        return _compile_compare(e, batch, prog)
    if op in _LOGIC_OPS:
        return _compile_logic(e, batch, prog)
    if op in _ARITH_OPS or op in (Op.IntDiv, Op.Mod):
        return _compile_arith(e, batch, prog)
    raise Unsupported(f"binary op {op!r}")


def _compile_compare(e: Expr, batch, prog: Program) -> CompiledExpr:
    op = e.op
    left, right = e.children
    # string constant vs TEMPORAL column: coerce the constant to the
    # column's plane encoding (MySQL date-string coercion; the Q6 shape
    # `l_shipdate <= '1998-09-02'`)
    children = [left, right]
    for i, (a, b) in enumerate(((left, right), (right, left))):
        if a.tp == ExprType.COLUMN_REF and b.tp == ExprType.VALUE \
                and not b.val.is_null() \
                and b.val.kind in (Kind.STRING, Kind.BYTES):
            cd = batch.columns.get(a.val)
            if cd is not None and cd.kind == col.K_I64 \
                    and cd.tp in my.TIME_TYPES:
                from tidb_tpu_torch.types.time_types import parse_time
                try:
                    t = parse_time(b.val.get_string())
                except errors.TiDBError:
                    raise Unsupported("unparseable date constant")
                children[1 - i] = Expr(ExprType.VALUE, val=Datum.i64(
                    t.to_packed_int()))
    left, right = children
    # string column vs string constant → code-space compare
    for a, b, flip in ((left, right, False), (right, left, True)):
        cd = _str_column_of(a, batch)
        if cd is not None and b.tp == ExprType.VALUE \
                and not b.val.is_null() \
                and b.val.kind in (Kind.STRING, Kind.BYTES):
            return _compile_str_cmp(a, cd, b.val.get_bytes(),
                                    _flip_op(op) if flip else op, prog)
    ca = compile_expr(left, batch, prog)
    cb = compile_expr(right, batch, prog)
    if "strconst" in (ca.kind, cb.kind):
        raise Unsupported("string comparison without a dict column")
    str_a = _str_column_of(left, batch)
    str_b = _str_column_of(right, batch)
    if (str_a is None) != (str_b is None):
        raise Unsupported("mixed string/non-string comparison")
    if str_a is not None and str_b is not None:
        raise Unsupported("column-column string compare needs shared dict")
    ra, rb, kind, _scale = _align(prog, ca, cb)
    table = _CMP_F if kind == col.K_F64 else _CMP_I
    return CompiledExpr(prog, prog.emit(table[op], ra, rb), "bool", "b")


def _flip_op(op: Op) -> Op:
    return {Op.LT: Op.GT, Op.LE: Op.GE, Op.GT: Op.LT, Op.GE: Op.LE,
            Op.EQ: Op.EQ, Op.NE: Op.NE}[op]


def _compile_str_cmp(col_expr: Expr, cd: col.ColumnData, const: bytes,
                     op: Op, prog: Program) -> CompiledExpr:
    codes = prog.column(col_expr.val)
    if op in (Op.EQ, Op.NE):
        code = cd.code_of(const)
        if code < 0:
            # absent from the dictionary: never equal, always unequal
            reg = prog.emit(OP_BOOLV, codes, imm=int(op == Op.NE))
        else:
            reg = prog.emit(_CMP_I[op], codes, _const_i(prog, code))
        return CompiledExpr(prog, reg, "bool", "b")
    # ordered compares via dictionary bounds (codes are sorted by bytes)
    lb = cd.lower_bound(const)   # #entries < const
    ub = cd.upper_bound(const)   # #entries <= const
    bound, cmp = {Op.LT: (lb, OP_LT_I), Op.LE: (ub, OP_LT_I),
                  Op.GT: (ub, OP_GE_I), Op.GE: (lb, OP_GE_I)}[op]
    return CompiledExpr(prog, prog.emit(cmp, codes, _const_i(prog, bound)),
                        "bool", "b")


def _compile_logic(e: Expr, batch, prog: Program) -> CompiledExpr:
    ca = _operand(compile_expr(e.children[0], batch, prog))
    cb = _operand(compile_expr(e.children[1], batch, prog))
    op = {Op.AndAnd: OP_AND, Op.OrOr: OP_OR, Op.Xor: OP_XOR}[e.op]
    return CompiledExpr(prog, prog.emit(op, _truthy(prog, ca),
                                        _truthy(prog, cb)), "bool", "b")


def _compile_arith(e: Expr, batch, prog: Program) -> CompiledExpr:
    op = e.op
    ca = compile_expr(e.children[0], batch, prog)
    cb = compile_expr(e.children[1], batch, prog)
    if "strconst" in (ca.kind, cb.kind):
        raise Unsupported("arithmetic on string constant")
    dec_in = col.K_DEC in (ca.kind, cb.kind) \
        and col.K_F64 not in (ca.kind, cb.kind)
    if dec_in and op in (Op.Div, Op.IntDiv, Op.Mod):
        raise Unsupported("decimal division is not served")
    if dec_in and op == Op.Mul:
        # product scale adds; values multiply directly (exact)
        scale = (ca.scale if ca.kind == col.K_DEC else 0) \
            + (cb.scale if cb.kind == col.K_DEC else 0)
        if scale > MAX_DEC_SCALE:
            raise Unsupported(f"decimal product scale {scale} too fine")
        bound = _dec_guard(_max_abs_of(ca) * _max_abs_of(cb), "product")
        return CompiledExpr(prog, prog.emit(OP_MUL_I, ca.reg, cb.reg),
                            col.K_DEC, "i", scale=scale, max_abs=bound)
    if dec_in:
        ra, rb, _k, scale = _align(prog, ca, cb)
        sa = ca.scale if ca.kind == col.K_DEC else 0
        sb = cb.scale if cb.kind == col.K_DEC else 0
        bound = _dec_guard(_max_abs_of(ca) * 10 ** (scale - sa)
                           + _max_abs_of(cb) * 10 ** (scale - sb), "sum")
        reg = prog.emit(OP_ADD_I if op == Op.Plus else OP_SUB_I, ra, rb)
        return CompiledExpr(prog, reg, col.K_DEC, "i", scale=scale,
                            max_abs=bound)
    kind = col.K_F64 if (op == Op.Div or col.K_F64 in (ca.kind, cb.kind)) \
        else col.K_I64
    if kind == col.K_F64:
        ra, rb = _to_f64(prog, ca), _to_f64(prog, cb)
        fop = {Op.Plus: OP_ADD_F, Op.Minus: OP_SUB_F, Op.Mul: OP_MUL_F,
               Op.Div: OP_DIV_F, Op.IntDiv: OP_IDIV_F, Op.Mod: OP_MOD_F}[op]
        # IntDiv truncates to an int64 plane while the kind stays f64 —
        # the reference's CompiledExpr does the same
        return CompiledExpr(prog, prog.emit(fop, ra, rb), kind,
                            "i" if op == Op.IntDiv else "f")
    iop = {Op.Plus: OP_ADD_I, Op.Minus: OP_SUB_I, Op.Mul: OP_MUL_I,
           Op.IntDiv: OP_IDIV_I, Op.Mod: OP_MOD_I}[op]
    return CompiledExpr(prog, prog.emit(iop, ca.reg, cb.reg), kind, "i")


def _compile_in(e: Expr, batch, prog: Program, negated: bool) -> CompiledExpr:
    target = e.children[0]
    items = e.children[1:]
    cd = _str_column_of(target, batch)
    if cd is not None:
        codes = []
        has_null = False
        for it in items:
            if it.tp != ExprType.VALUE:
                raise Unsupported("non-constant IN item")
            if it.val.is_null():
                has_null = True
                continue
            codes.append(cd.code_of(it.val.get_bytes()))
        # absent constants (code -1) can never equal a live row's code
        present = sorted(c for c in codes if c >= 0) or [-2]
        off = len(prog.pool)
        prog.pool.extend(present)
        reg = prog.emit(OP_IN_I, prog.column(target.val), len(present),
                        int(negated) | (int(has_null) << 1), imm=off)
        return CompiledExpr(prog, reg, "bool", "b")

    ct = _operand(compile_expr(target, batch, prog))
    raw = []
    has_null = False
    kind = ct.kind
    for it in items:
        if it.tp != ExprType.VALUE:
            raise Unsupported("non-constant IN item")
        if it.val.is_null():
            has_null = True
            continue
        v = it.val.as_number()
        if isinstance(v, float):
            kind = col.K_F64
        raw.append(v)
    consts = []
    if kind == col.K_DEC:
        for v in raw:
            scaled = (Decimal(v) if not isinstance(v, Decimal) else v) \
                * (10 ** ct.scale)
            if scaled == int(scaled) and abs(int(scaled)) < DEC_ABS_LIMIT:
                consts.append(int(scaled))
            # inexact / beyond the plane bound: can never match — drop
    elif kind == col.K_F64:
        consts = [_f64_bits(float(v)) for v in raw]
    else:
        consts = [int(v) for v in raw]
        if any(not (col.I64_MIN <= v <= col.I64_MAX) for v in consts):
            raise Unsupported("IN constant outside int64")
    if kind == col.K_F64:
        dec_div = (10.0 ** ct.scale) if ct.kind == col.K_DEC else 1.0
        reg, op = _as_f64(prog, ct, dec_div), OP_IN_F
    else:
        reg, op = ct.reg, OP_IN_I
    off = len(prog.pool)
    prog.pool.extend(consts)
    reg = prog.emit(op, reg, len(consts), int(negated) | (int(has_null) << 1),
                    imm=off)
    return CompiledExpr(prog, reg, "bool", "b")


def _like_prefix_bytes(p: str, escape: str):
    """The literal prefix when the pattern is `literal%` — a single
    trailing unescaped `%`, no `_`, no interior `%` — AND every prefix
    char is caseless ASCII (MySQL LIKE is case-insensitive; caseless
    chars make the sorted-byte range test exactly the regex's answer).
    None → no fast path (the dictionary LUT stays correct for
    everything)."""
    out: list[str] = []
    i, n = 0, len(p)
    while i < n:
        ch = p[i]
        if escape and ch == escape and i + 1 < n:
            out.append(p[i + 1])
            i += 2
            continue
        if ch == "%":
            if i != n - 1:
                return None
            lit = "".join(out)
            if any(ord(c) >= 128 or c.lower() != c.upper() for c in lit):
                return None
            return lit.encode("ascii")
        if ch == "_":
            return None
        out.append(ch)
        i += 1
    return None     # no trailing %: an exact literal — not this shape


def _byte_successor(b: bytes):
    """Smallest byte string greater than every string prefixed by `b`
    (increment the last non-0xFF byte); None → no upper bound."""
    arr = bytearray(b)
    while arr and arr[-1] == 0xFF:
        arr.pop()
    if not arr:
        return None
    arr[-1] += 1
    return bytes(arr)


def _compile_like(e: Expr, batch, prog: Program,
                  negated: bool) -> CompiledExpr:
    target, pattern = e.children[0], e.children[1]
    cd = _str_column_of(target, batch)
    if cd is None or pattern.tp != ExprType.VALUE:
        raise Unsupported("LIKE needs dict column + constant pattern")
    escape = e.val if isinstance(e.val, str) else "\\"
    pat = pattern.val
    codes = prog.column(target.val)
    # `LIKE 'prefix%'` over the SORTED dictionary is an integer range
    # compare: lower_bound(prefix) <= code < lower_bound(byte successor)
    pfx = None if pat.is_null() \
        else _like_prefix_bytes(pat.get_string(), escape)
    if pfx is not None:
        lb = cd.lower_bound(pfx)
        succ = _byte_successor(pfx)
        ub = len(cd.dictionary) if succ is None else cd.lower_bound(succ)
        hit = prog.emit(OP_AND,
                        prog.emit(OP_GE_I, codes, _const_i(prog, lb)),
                        prog.emit(OP_LT_I, codes, _const_i(prog, ub)))
        reg = prog.emit(OP_NOT, hit) if negated else hit
        return CompiledExpr(prog, reg, "bool", "b")
    # general patterns: evaluate over the dictionary on host → LUT
    lut = _like_lut(cd, pat, escape)
    off = len(prog.lut)
    prog.lut.extend(lut)
    reg = prog.emit(OP_LUT, codes, len(lut), int(negated), imm=off)
    return CompiledExpr(prog, reg, "bool", "b")


def _compile_if(e: Expr, batch, prog: Program) -> CompiledExpr:
    cc = _operand(compile_expr(e.children[0], batch, prog))
    ca = _operand(compile_expr(e.children[1], batch, prog))
    cb = _operand(compile_expr(e.children[2], batch, prog))
    kind = _merge_kind(ca.kind, cb.kind)
    cond = _truthy(prog, cc)
    ra, rb, dt = _promote(prog, ca, cb, kind)
    return CompiledExpr(prog, prog.emit(OP_SELECT, cond, ra, rb), kind, dt)


# ---------------------------------------------------------------------------
# general-LIKE LUT: evaluated over the dictionary on the host with MySQL's
# case-insensitive LIKE (tidb_tpu/expression/ops.py compute_like), cached
# per (dictionary, pattern, escape)
# ---------------------------------------------------------------------------

_LIKE_LUT_CAP = 256
_like_lut_cache: dict = {}
_like_lut_lock = threading.Lock()
_like_re_cache: dict = {}


def _like_regex(pattern: str, escape: str) -> re.Pattern:
    key = (pattern, escape)
    pat = _like_re_cache.get(key)
    if pat is None:
        out, i = [], 0
        while i < len(pattern):
            ch = pattern[i]
            if escape and ch == escape and i + 1 < len(pattern):
                out.append(re.escape(pattern[i + 1]))
                i += 2
                continue
            if ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(re.escape(ch))
            i += 1
        pat = re.compile("^" + "".join(out) + "$", re.IGNORECASE | re.DOTALL)
        _like_re_cache[key] = pat
    return pat


def _like_lut(cd: col.ColumnData, pat: Datum, escape: str) -> bytes:
    pkey = None if pat.is_null() else pat.get_string()
    key = (id(cd.dictionary), len(cd.dictionary), pkey, escape)
    with _like_lut_lock:
        ent = _like_lut_cache.get(key)
    if ent is not None:
        return ent[0]
    lut = bytearray(max(len(cd.dictionary), 1))
    if pkey is not None:
        rx = _like_regex(pkey, escape)
        for i, b in enumerate(cd.dictionary):
            lut[i] = rx.match(b.decode("utf-8", "replace")) is not None
    lut = bytes(lut)
    with _like_lut_lock:
        _like_lut_cache[key] = (lut, cd.dictionary)  # pin: id() stays live
        while len(_like_lut_cache) > _LIKE_LUT_CAP:
            _like_lut_cache.pop(next(iter(_like_lut_cache)))
    return lut


# ---------------------------------------------------------------------------
# K1's plain version: the same bytecode, one instruction at a time over
# whole planes with torch ops
# ---------------------------------------------------------------------------

def run_program_plain(fin: Finalized, plane_list: list, live: torch.Tensor):
    """Interpret `fin` over `plane_list` (tensors in fin.plane_keys order)
    → (mask bool[n], gid int64[n] or None, [(values, valid)] per output).
    Values are int64 or float64 tensors per fin.out_dts; booleans are
    int64 0/1 as in K1."""
    dev = live.device
    regs: dict[int, tuple] = {}
    _run_plain(fin.instructions(), regs, torch.from_numpy(fin.pool).to(dev),
               torch.from_numpy(fin.lut).to(dev), plane_list, live)
    where, outs, grp = fin.tail()
    mask = live.clone()
    if where >= 0:
        v, ok = regs[where]
        mask &= ok & (_view(v, torch.int64) != 0)
    gid = None
    if grp:
        sink = int(fin.meta[4])
        for vslot, kslot, size, radix in grp:
            c = torch.where(plane_list[kslot], plane_list[vslot],
                            torch.full_like(plane_list[vslot], size))
            gid = c if gid is None else gid * radix + c
        gid = torch.where(mask, gid, torch.full_like(gid, sink))
    values = []
    for r, dt in zip(outs, fin.out_dts):
        v, ok = regs[r]
        v = _view(v, torch.float64 if dt == "f" else torch.int64)
        values.append((v.contiguous(), ok.contiguous()))
    return mask, gid, values


def _view(v: torch.Tensor, dtype) -> torch.Tensor:
    """A register's 64-bit values as `dtype` (int64 or float64 bits)."""
    return v if v.dtype == dtype else v.view(dtype)


# ops that read the constant pool: under a micro-batch launch their
# results, and every register downstream of them, differ from slot to slot
POOL_OPS = (OP_CONST, OP_IN_I, OP_IN_F, OP_I2F, OP_MULC_I)


def slot_split(fin: Finalized) -> tuple[list, int, int]:
    """`fin`'s program as K14 runs it: (instructions, n_inv, where
    register). The slot-invariant instructions come first (a row runs
    them once), then those that read the constant pool or a value
    downstream of one (run once a slot), each part in program order, with
    registers allocated anew for that order: a value of the first part
    that the second reads keeps its register to the end, so every slot
    finds it. Where the new order needs more than MAX_REGS registers, the
    program as it is, all of it per slot (n_inv 0)."""
    ins = list(fin.instructions())
    where = int(fin.meta[1])
    # the program as values: instruction i defines value i; srcs[i] names
    # the values its register operands read (None for a non-register)
    cur: dict[int, int] = {}
    srcs = []
    for i, (op, d, a, b, c, _imm) in enumerate(ins):
        srcs.append([cur[v] if is_reg else None
                     for is_reg, v in zip(_REG_ARGS[op], (a, b, c))])
        cur[d] = i
    root = cur[where] if where >= 0 else None
    dep: list[bool] = []
    for i, x in enumerate(ins):
        dep.append(x[0] in POOL_OPS
                   or any(s is not None and dep[s] for s in srcs[i]))
    order = [i for i in range(len(ins)) if not dep[i]] \
        + [i for i in range(len(ins)) if dep[i]]
    end = len(order)
    last: dict[int, int] = {}
    for p, i in enumerate(order):
        for s in srcs[i]:
            if s is not None:
                last[s] = end if dep[i] and not dep[s] \
                    else max(last.get(s, p), p)
    if root is not None:
        last[root] = end
    free = list(range(MAX_REGS - 1, -1, -1))
    phys: dict[int, int] = {}
    code = []
    for p, i in enumerate(order):
        op, _d, a, b, c, imm = ins[i]
        ra = [v if s is None else phys[s]
              for s, v in zip(srcs[i], (a, b, c))]
        for s in srcs[i]:
            if s is not None and last[s] == p and s in phys:
                free.append(phys.pop(s))
        if not free:
            return ins, 0, where
        phys[i] = free.pop()
        code.append([op, phys[i]] + ra + [imm])
        if i not in last:          # read by nothing: free at once
            free.append(phys.pop(i))
    n_inv = dep.count(False)
    return code, n_inv, (phys[root] if root is not None else -1)


def run_split_plain(fin: Finalized, pools: torch.Tensor, plane_list: list,
                    live: torch.Tensor) -> list:
    """K14's order of evaluation in plain torch: `slot_split`'s invariant
    part once over the rows with no constant pool at all, then its
    per-slot part once a slot with that slot's row of `pools` (int64
    [k, P]), over the registers the invariant part left → one mask
    bool[n] a slot (live & valid & truthy WHERE)."""
    dev = live.device
    ins, n_inv, where = slot_split(fin)
    lut = torch.from_numpy(fin.lut).to(dev)
    regs: dict[int, tuple] = {}
    _run_plain(ins[:n_inv], regs, None, lut, plane_list, live)
    masks = []
    for s in range(pools.shape[0]):
        _run_plain(ins[n_inv:], regs, pools[s].to(dev), lut, plane_list,
                   live)
        mask = live.clone()
        if where >= 0:
            v, ok = regs[where]
            mask &= ok & (_view(v, torch.int64) != 0)
        masks.append(mask)
    return masks


def _run_plain(instrs, regs: dict, pool, lut, plane_list: list,
               live: torch.Tensor) -> None:
    """Run `instrs` over whole planes into `regs` (register → (values,
    valid)). `pool` None: the instructions may not read the pool."""
    n = live.shape[0]
    dev = live.device
    if pool is not None:
        pool_f = pool.view(torch.float64)
    true_ = torch.ones(n, dtype=torch.bool, device=dev)

    def iv(r):      # int64 view of a register
        return _view(regs[r][0], torch.int64)

    def fv(r):      # f64 view of a register
        return _view(regs[r][0], torch.float64)

    def ok(r):
        return regs[r][1]

    for op, d, a, b, c, imm in instrs:
        if pool is None and op in POOL_OPS:
            raise errors.DeviceError(f"instruction {op} reads the constant "
                                     "pool in the slot-invariant part")
        if op == OP_LOAD:
            val = plane_list[a]
            if val.dtype not in (torch.int64, torch.float64):
                raise errors.TypeError_(f"value plane of dtype {val.dtype}")
            res = (val, true_ if b < 0 else plane_list[b])
        elif op == OP_CONST:
            res = (pool[imm].expand(n), true_ if a else ~true_)
        elif OP_EQ_I <= op <= OP_GE_I:
            x, y = iv(a), iv(b)
            res = (_cmp(op - OP_EQ_I, x, y).long(), ok(a) & ok(b))
        elif OP_EQ_F <= op <= OP_GE_F:
            x, y = fv(a), fv(b)
            res = (_cmp(op - OP_EQ_F, x, y).long(), ok(a) & ok(b))
        elif op in (OP_AND, OP_OR, OP_XOR):
            at, bt = iv(a) != 0, iv(b) != 0
            aa, bb = ok(a), ok(b)
            if op == OP_AND:
                res = (at & bt, (aa & bb) | (aa & ~at) | (bb & ~bt))
            elif op == OP_OR:
                res = (at | bt, (aa & bb) | (aa & at) | (bb & bt))
            else:
                res = (at ^ bt, aa & bb)
            res = (res[0].long(), res[1])
        elif op == OP_NOT:
            res = ((iv(a) == 0).long(), ok(a))
        elif op in (OP_ADD_I, OP_SUB_I, OP_MUL_I):
            x, y = iv(a), iv(b)
            val = x + y if op == OP_ADD_I else (x - y if op == OP_SUB_I
                                                else x * y)
            res = (val, ok(a) & ok(b))
        elif op in (OP_IDIV_I, OP_MOD_I):
            x, y = iv(a), iv(b)
            zero = y == 0
            m1 = y == -1        # INT64_MIN / -1 would trap: negate instead
            safe = torch.where(zero | m1, torch.ones_like(y), y)
            if op == OP_IDIV_I:
                val = torch.where(m1, -x, torch.div(x, safe,
                                                    rounding_mode="trunc"))
            else:
                val = torch.where(m1, torch.zeros_like(x),
                                  torch.fmod(x, safe))
            res = (val, ok(a) & ok(b) & ~zero)
        elif op in (OP_ADD_F, OP_SUB_F, OP_MUL_F):
            x, y = fv(a), fv(b)
            val = x + y if op == OP_ADD_F else (x - y if op == OP_SUB_F
                                                else x * y)
            res = (val, ok(a) & ok(b))
        elif op in (OP_DIV_F, OP_IDIV_F, OP_MOD_F):
            x, y = fv(a), fv(b)
            zero = y == 0
            safe = torch.where(zero, torch.ones_like(y), y)
            if op == OP_DIV_F:
                val = x / safe
            elif op == OP_IDIV_F:
                val = torch.trunc(x / safe).to(torch.int64)
            else:
                val = torch.fmod(x, safe)
            res = (val, ok(a) & ok(b) & ~zero)
        elif op == OP_I2F:
            res = (iv(a).to(torch.float64) / pool_f[imm], ok(a))
        elif op == OP_MULC_I:
            res = (iv(a) * pool[imm], ok(a))
        elif op == OP_NEG_I:
            res = (-iv(a), ok(a))
        elif op == OP_NEG_F:
            res = (-fv(a), ok(a))
        elif op == OP_ISNULL:
            res = ((~ok(a)).long(), true_)
        elif op == OP_NOTNULL:
            res = (ok(a).long(), true_)
        elif op in (OP_IN_I, OP_IN_F):
            if op == OP_IN_I:
                x, items = iv(a), pool[imm:imm + b]
            else:
                x, items = fv(a), pool_f[imm:imm + b]
            hit = torch.zeros(n, dtype=torch.bool, device=dev)
            for j in range(b):
                hit |= x == items[j]
            val = ~hit if c & 1 else hit
            res = (val.long(), ok(a) & (hit | (not (c & 2))))
        elif op == OP_LUT:
            hit = lut[imm + torch.clamp(iv(a), 0, b - 1)] != 0
            res = ((~hit if c else hit).long(), ok(a))
        elif op == OP_BOOLV:
            res = (torch.full((n,), imm, dtype=torch.int64, device=dev),
                   ok(a))
        elif op == OP_SELECT:
            cond = (iv(a) != 0) & ok(a)
            res = (torch.where(cond, iv(b), iv(c)),
                   torch.where(cond, ok(b), ok(c)))
        elif op == OP_IFNULL:
            res = (torch.where(ok(a), iv(a), iv(b)), ok(a) | ok(b))
        elif op == OP_TRUTHY_I:
            res = ((iv(a) != 0).long(), ok(a))
        elif op == OP_TRUTHY_F:
            res = ((fv(a) != 0).long(), ok(a))
        else:
            raise errors.DeviceError(f"unknown K1 opcode {op}")
        regs[d] = res


def _cmp(k: int, x, y):
    return (x == y, x != y, x < y, x <= y, x > y, x >= y)[k]


# ---------------------------------------------------------------------------
# aggregate-argument planes (the port of tidb_tpu/ops/exprc.py:770-997):
# an aggregate over an arithmetic EXPRESSION (TPC-H Q1's
# sum(l_extendedprice * (1 - l_discount))) evaluates as a plane program
# beside the WHERE, in the same K5 launch, feeding the states pass. The
# contextual typing refuses every shape whose plane could differ from the
# row engine:
#   * IntDiv/Mod only in pure-int context;
#   * decimal operands feeding a float context must fit the f64
#     exact-integer window (< 2^53 scaled);
#   * int/decimal results carry a whole-tree |value| bound with every
#     intermediate proven below DEC_ABS_LIMIT.
# Every reject depends on the expression and whole-batch metadata only,
# never on which rows a WHERE keeps.
# ---------------------------------------------------------------------------

_ARG_ARITH_OPS = (Op.Plus, Op.Minus, Op.Mul, Op.Div, Op.IntDiv, Op.Mod)
_ARG_UNARY_OPS = (Op.UnaryMinus, Op.UnaryPlus)
F64_EXACT_INT = 1 << 53


class ArgPlaneProg:
    """A compiled aggregate-argument plane program: the CompiledExpr (a
    register of the program it was compiled into), the columns it reads,
    its structural signature, and the kind / scale / |value| bound of the
    plane it yields (max_abs None for f64)."""

    __slots__ = ("compiled", "cids", "kind", "scale", "max_abs", "sig")

    def __init__(self, compiled: CompiledExpr, cids: tuple, sig: tuple):
        self.compiled = compiled
        self.cids = cids
        self.kind = compiled.kind
        self.scale = compiled.scale
        self.max_abs = compiled.max_abs
        self.sig = sig


def _arg_cids(e: Expr, out: set) -> None:
    if e.tp == ExprType.COLUMN_REF:
        out.add(e.val)
    for c in (e.children or ()):
        _arg_cids(c, out)


def _arg_static_kind(e: Expr, batch: col.ColumnBatch, colpb: dict):
    """Static value kind (col.K_* or None for a NULL constant) of an
    argument node under the row engine's contextual typing; raises
    Unsupported for any shape whose plane could differ from it."""
    if e.tp == ExprType.VALUE:
        d = e.val
        if d is None or not isinstance(d, Datum):
            raise Unsupported("arg-plane constant is not a datum")
        if d.is_null():
            return None
        if d.kind in (Kind.INT64, Kind.UINT64):
            return col.K_I64
        if d.kind == Kind.FLOAT64:
            return col.K_F64
        if d.kind == Kind.DECIMAL:
            return col.K_DEC
        raise Unsupported(f"arg-plane constant kind {d.kind!r}")
    if e.tp == ExprType.COLUMN_REF:
        cd = batch.columns.get(e.val)
        c = colpb.get(e.val)
        if cd is None or c is None:
            raise Unsupported("arg-plane column not packed")
        if cd.kind == col.K_STR:
            raise Unsupported("string column in arithmetic argument")
        if my.has_unsigned_flag(c.flag):
            raise Unsupported("unsigned column in arithmetic argument")
        if cd.kind == col.K_I64 and c.tp not in my.INTEGER_TYPES:
            raise Unsupported("temporal/bit column in arithmetic argument")
        return cd.kind
    if e.tp == ExprType.OPERATOR:
        if len(e.children) == 1:
            if e.op not in _ARG_UNARY_OPS:
                raise Unsupported(f"arg-plane unary op {e.op!r}")
            return _arg_static_kind(e.children[0], batch, colpb)
        if len(e.children) != 2 or e.op not in _ARG_ARITH_OPS:
            raise Unsupported(f"arg-plane op {getattr(e, 'op', None)!r}")
        ka = _arg_static_kind(e.children[0], batch, colpb)
        kb = _arg_static_kind(e.children[1], batch, colpb)
        f64 = col.K_F64 in (ka, kb)
        dec = col.K_DEC in (ka, kb)
        if e.op == Op.Div and not f64:
            raise Unsupported("Div outside float context")
        if e.op in (Op.IntDiv, Op.Mod) and (f64 or dec):
            raise Unsupported("IntDiv/Mod outside int context")
        if f64 and dec:
            for ch, k in ((e.children[0], ka), (e.children[1], kb)):
                if k != col.K_DEC:
                    continue
                b = _arg_bound(ch, batch)
                if b is None or b >= F64_EXACT_INT:
                    raise Unsupported(
                        "decimal too wide for exact float conversion")
        if f64:
            return col.K_F64
        if dec:
            return col.K_DEC
        return col.K_F64 if e.op == Op.Div else col.K_I64
    raise Unsupported(f"arg-plane expr type {e.tp!r}")


def _arg_scale(e: Expr, batch: col.ColumnBatch) -> int:
    """Decimal scale of an int/dec argument node (0 for ints/floats)."""
    if e.tp == ExprType.VALUE:
        d = e.val
        if not d.is_null() and d.kind == Kind.DECIMAL:
            return max(0, -d.val.as_tuple().exponent)
        return 0
    if e.tp == ExprType.COLUMN_REF:
        return batch.columns[e.val].dec_scale
    if len(e.children) == 1:
        return _arg_scale(e.children[0], batch)
    sa = _arg_scale(e.children[0], batch)
    sb = _arg_scale(e.children[1], batch)
    if e.op == Op.Mul:
        return sa + sb
    if e.op in (Op.Plus, Op.Minus):
        return max(sa, sb)
    return 0


def _arg_bound(e: Expr, batch: col.ColumnBatch):
    """Scaled-int |value| bound of an argument node, every intermediate
    guarded below DEC_ABS_LIMIT; None once float context is entered.
    Raises Unsupported when a needed bound is unprovable."""
    if e.tp == ExprType.VALUE:
        d = e.val
        if d.is_null():
            return 0
        if d.kind in (Kind.INT64, Kind.UINT64):
            return _dec_guard(abs(int(d.val)), "argument constant")
        if d.kind == Kind.FLOAT64:
            return None
        scale = max(0, -d.val.as_tuple().exponent)
        return _dec_guard(abs(int(d.val * (10 ** scale))),
                          "argument constant")
    if e.tp == ExprType.COLUMN_REF:
        cd = batch.columns[e.val]
        if cd.kind == col.K_F64:
            return None
        if cd.max_abs is None:
            raise Unsupported("argument column carries no bound")
        return _dec_guard(int(cd.max_abs), "argument column")
    if len(e.children) == 1:
        return _arg_bound(e.children[0], batch)
    ma = _arg_bound(e.children[0], batch)
    mb = _arg_bound(e.children[1], batch)
    if ma is None or mb is None or e.op == Op.Div:
        return None
    if e.op == Op.Mul:
        return _dec_guard(ma * mb, "argument product")
    if e.op in (Op.Plus, Op.Minus):
        sa = _arg_scale(e.children[0], batch)
        sb = _arg_scale(e.children[1], batch)
        s = max(sa, sb)
        return _dec_guard(ma * 10 ** (s - sa) + mb * 10 ** (s - sb),
                          "argument sum")
    if e.op == Op.IntDiv:
        return ma
    return min(ma, mb)  # Mod: |a mod b| <= min(|a|, |b|)


def compile_arg_plane(e: Expr, batch: col.ColumnBatch, colpb: dict,
                      prog: Program | None = None) -> ArgPlaneProg:
    """Compile an aggregate's argument expression into `prog` (a fresh
    program when None) as an ArgPlaneProg, or raise Unsupported. Every
    reject is mask-independent, which lets the region handler certify a
    deferred filter against it before the filter has run."""
    cids: set = set()
    _arg_cids(e, cids)
    if not cids:
        raise Unsupported("argument expression references no column")
    if _arg_static_kind(e, batch, colpb) is None:
        raise Unsupported("NULL-only argument expression")
    cids_t = tuple(sorted(cids))
    sig_cols = tuple((cid, batch.columns[cid].kind, batch.columns[cid].tp,
                      batch.columns[cid].dec_scale) for cid in cids_t)
    compiled = compile_expr(e, batch, prog)
    if compiled.kind not in (col.K_I64, col.K_F64, col.K_DEC):
        raise Unsupported(f"argument kind {compiled.kind!r} not aggregable")
    if compiled.kind != col.K_F64 and compiled.max_abs is None:
        compiled.max_abs = _arg_bound(e, batch)
    return ArgPlaneProg(compiled, cids_t, (repr(e),) + sig_cols)
