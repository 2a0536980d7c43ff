"""K1's plain version (run_program_plain) against the JAX compile_expr.

Every predicate of tests/test_tpu_copr.py's QUERIES that slice 1 serves,
the TPC-H Q1/Q6 predicates and arguments, and expressions reaching every
bytecode op lower in both packages over the same seeded planes; values
(where valid) and valid planes must agree, as must the lowering metadata
(kind, decimal scale, magnitude bound). Shapes the reference refuses must
raise Unsupported in the port too.

Tolerance: exact, except f64 values, which may differ by 1e-12 relative
(XLA may contract or reorder float arithmetic).
"""

import datetime as dt
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.proto import Expr as RExpr, ExprType as RT
from tidb_tpu.copr.proto import expr_column as c, expr_op as op, \
    expr_value as v
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops.exprc import Unsupported as RUnsupported
from tidb_tpu.ops.exprc import compile_expr as rcompile
from tidb_tpu.sqlast.opcode import Op
from tidb_tpu.types import Datum as RDatum
from tidb_tpu.types.datum import NULL as RNULL, Kind as RKind
from tidb_tpu.types.time_types import Time as RTime

from tidb_tpu_torch import carry
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import (MAX_REGS, Unsupported, compile_expr,
                                      run_program_plain)

from torch_parity import F64_RTOL

CAP, N = 1024, 1000
ID, A, B, C, D, M, PRICE, DISC, TAX, BIG = 1, 2, 3, 4, 5, 6, 7, 8, 9, 10


def _pack_date(y, m, d):
    return RTime(dt.datetime(y, m, d), rmy.TypeDate).to_packed_int()


def _ref_batch(seed: int = 7) -> rcol.ColumnBatch:
    rng = np.random.default_rng(seed)
    live = np.zeros(CAP, bool)
    live[:N] = True

    def valid(p=0.1):
        return live & (rng.random(CAP) > p)

    a = rng.integers(-60, 60, CAP)
    c_ = np.round(rng.normal(0, 3, CAP), 1)
    c_[::17] = -0.0
    dates = np.array([_pack_date(2023 + int(k % 3), 1 + int(k % 12),
                                 1 + int(k % 28)) for k in
                      rng.integers(0, 1000, CAP)], dtype=np.int64)
    dic = [b"x", b"xx", b"xy", b"y", b"z"]
    b_va = valid()
    b_codes = np.where(b_va, rng.integers(0, len(dic), CAP), -1)
    big = rng.integers(-(1 << 62), 1 << 62, CAP)
    cols = {
        ID: rcol.ColumnData(rcol.K_I64, np.arange(CAP, dtype=np.int64) + 1,
                            live.copy(), tp=rmy.TypeLonglong, max_abs=N),
        A: rcol.ColumnData(rcol.K_I64, a.astype(np.int64), valid(),
                           tp=rmy.TypeLong, max_abs=60),
        B: rcol.ColumnData(rcol.K_STR, b_codes.astype(np.int64), b_va, dic,
                           tp=rmy.TypeVarchar),
        C: rcol.ColumnData(rcol.K_F64, c_, valid(), tp=rmy.TypeDouble),
        D: rcol.ColumnData(rcol.K_I64, dates, valid(), tp=rmy.TypeDate,
                           max_abs=int(dates.max())),
        M: rcol.ColumnData(rcol.K_DEC, rng.integers(-9999, 9999, CAP)
                           .astype(np.int64), valid(), tp=rmy.TypeNewDecimal,
                           dec_scale=2, max_abs=9999),
        PRICE: rcol.ColumnData(rcol.K_DEC, rng.integers(90000, 10494950, CAP)
                               .astype(np.int64), live.copy(),
                               tp=rmy.TypeNewDecimal, dec_scale=2,
                               max_abs=10494950),
        DISC: rcol.ColumnData(rcol.K_DEC, rng.integers(0, 11, CAP)
                              .astype(np.int64), live.copy(),
                              tp=rmy.TypeNewDecimal, dec_scale=2, max_abs=10),
        TAX: rcol.ColumnData(rcol.K_DEC, rng.integers(0, 9, CAP)
                             .astype(np.int64), live.copy(),
                             tp=rmy.TypeNewDecimal, dec_scale=2, max_abs=8),
        BIG: rcol.ColumnData(rcol.K_I64, big.astype(np.int64), valid(),
                             tp=rmy.TypeLonglong, max_abs=1 << 62),
    }
    return rcol.ColumnBatch(N, CAP, np.arange(CAP, dtype=np.int64), cols)


def i(x):
    return v(RDatum.i64(x))


def f(x):
    return v(RDatum.f64(x))


def s(x):
    return v(RDatum.string(x))


def dec(x):
    return v(RDatum.dec(Decimal(x)))


def date(y, m, d):
    return v(RDatum(RKind.TIME, RTime(dt.datetime(y, m, d), rmy.TypeDate)))


def _in(target, *items, negated=False):
    return RExpr(RT.NOT_IN if negated else RT.IN,
                 children=[target] + list(items))


def _like(target, pat, negated=False):
    return RExpr(RT.NOT_LIKE if negated else RT.LIKE, val="\\",
                 children=[target, s(pat)])


def _is(target, null=True):
    return RExpr(RT.IS_NULL if null else RT.IS_NOT_NULL, children=[target])


def _if(cond, a, b):
    return RExpr(RT.IF, children=[cond, a, b])


def _ifnull(a, b):
    return RExpr(RT.IFNULL, children=[a, b])


_one = i(1)
_disc_price = op(Op.Mul, c(PRICE), op(Op.Minus, _one, c(DISC)))

SERVED = {
    # tests/test_tpu_copr.py QUERIES (id, a, b, c, d)
    "a>25": op(Op.GT, c(A), i(25)),
    "a>10&c<4": op(Op.AndAnd, op(Op.GT, c(A), i(10)), op(Op.LT, c(C), f(4.0))),
    "b=x": op(Op.EQ, c(B), s("x")),
    "b!=x": op(Op.NE, c(B), s("x")),
    "b<y": op(Op.LT, c(B), s("y")),
    "b in (x,z)": _in(c(B), s("x"), s("z")),
    "b like x%": _like(c(B), "x%"),
    "c is null": _is(c(C)),
    "c is not null": _is(c(C), null=False),
    "a in (10,30,50)": _in(c(A), i(10), i(30), i(50)),
    "not a>25": op(Op.UnaryNot, op(Op.GT, c(A), i(25))),
    "a>20|b=x": op(Op.OrOr, op(Op.GT, c(A), i(20)), op(Op.EQ, c(B), s("x"))),
    "d<=str": op(Op.LE, c(D), s("2024-03-01")),
    "d>str": op(Op.GT, c(D), s("2024-02-10")),
    "a*2+1": op(Op.Plus, op(Op.Mul, c(A), i(2)), i(1)),
    "id>100": op(Op.GT, c(ID), i(100)),
    # TPC-H Q1 / Q6
    "q1 where": op(Op.LE, c(D), date(1998, 9, 2)),
    "q1 disc_price": _disc_price,
    "q1 charge": op(Op.Mul, _disc_price, op(Op.Plus, _one, c(TAX))),
    "q6 where": op(Op.AndAnd, op(Op.AndAnd, op(Op.AndAnd, op(
        Op.AndAnd, op(Op.GE, c(D), s("2024-01-01")),
        op(Op.LT, c(D), s("2025-01-01"))), op(Op.GE, c(DISC), dec("0.05"))),
        op(Op.LE, c(DISC), dec("0.07"))), op(Op.LT, c(A), i(24))),
    "q6 revenue": op(Op.Mul, c(PRICE), c(DISC)),
    # every other op
    "y<b": op(Op.LT, s("y"), c(B)),
    "b>=xx": op(Op.GE, c(B), s("xx")),
    "b=absent": op(Op.EQ, c(B), s("nope")),
    "b!=absent": op(Op.NE, c(B), s("nope")),
    "b not in (x,null)": _in(c(B), s("x"), v(RNULL), negated=True),
    "b like %y%": _like(c(B), "%y%"),
    "b not like _": _like(c(B), "_", negated=True),
    "b not like x%": _like(c(B), "x%", negated=True),
    "a not in (1,null)": _in(c(A), i(1), v(RNULL), negated=True),
    "a in (1.5,2)": _in(c(A), f(1.5), i(2)),
    "m in (1.25,3)": _in(c(M), dec("1.25"), i(3)),
    "m in (0.5e0)": _in(c(M), f(0.5)),
    "c in ()": _in(c(C), v(RNULL)),
    "a div 7": op(Op.IntDiv, c(A), i(7)),
    "a mod -7": op(Op.Mod, c(A), i(-7)),
    "a div 0": op(Op.IntDiv, c(A), i(0)),
    "a / a": op(Op.Div, c(A), c(A)),
    "c / a": op(Op.Div, c(C), c(A)),
    "c div 2": op(Op.IntDiv, c(C), i(2)),
    "c mod 2.5": op(Op.Mod, c(C), f(2.5)),
    "-c": op(Op.UnaryMinus, c(C)),
    "-a": op(Op.UnaryMinus, c(A)),
    "+a": op(Op.UnaryPlus, c(A)),
    "a - c": op(Op.Minus, c(A), c(C)),
    "m * c": op(Op.Mul, c(M), c(C)),
    "m + a": op(Op.Plus, c(M), c(A)),
    "m - 0.125": op(Op.Minus, c(M), dec("0.125")),
    "m > a": op(Op.GT, c(M), c(A)),
    "c = -0": op(Op.EQ, c(C), f(-0.0)),
    "a xor c": op(Op.Xor, c(A), c(C)),
    "not c": op(Op.Not, c(C)),
    "c and null": op(Op.AndAnd, c(C), v(RNULL)),
    "null or a>0": op(Op.OrOr, v(RNULL), op(Op.GT, c(A), i(0))),
    "if(a>0,a,c)": _if(op(Op.GT, c(A), i(0)), c(A), c(C)),
    "if(c,a,-a)": _if(c(C), c(A), op(Op.UnaryMinus, c(A))),
    "if(b=x,a>1,a<1)": _if(op(Op.EQ, c(B), s("x")), op(Op.GT, c(A), i(1)),
                           op(Op.LT, c(A), i(1))),
    "ifnull(c,a)": _ifnull(c(C), c(A)),
    "ifnull(a,0)": _ifnull(c(A), i(0)),
    "a is null": _is(op(Op.Plus, c(A), i(1))),
    "big*3": op(Op.Mul, c(BIG), i(3)),
    "null": RExpr(RT.NULL),
    "const": i(42),
}

REFUSED = {
    "m / 2": op(Op.Div, c(M), i(2)),
    "m div 2": op(Op.IntDiv, c(M), i(2)),
    "m^4 scale": op(Op.Mul, op(Op.Mul, op(Op.Mul, c(M), c(M)), c(M)), c(M)),
    "str + 1": op(Op.Plus, s("abc"), i(1)),
    "b = c": op(Op.EQ, c(B), c(C)),
    "b < b": op(Op.LT, c(B), c(B)),
    "c like": _like(c(C), "x%"),
    "a in (c)": _in(c(A), c(C)),
    "b in (b)": _in(c(B), c(B)),
    "case": RExpr(RT.CASE, children=[c(A), i(1), i(2)]),
    "func": RExpr(RT.SCALAR_FUNC, val="abs", children=[c(A)]),
    "if dec": _if(op(Op.GT, c(A), i(1)), c(M), i(1)),
    "ifnull dec": _ifnull(c(M), i(0)),
    "m + big": op(Op.Plus, c(M), c(BIG)),
    "m > a*a": op(Op.GT, c(M), op(Op.Mul, c(A), c(A))),
    "bad date": op(Op.LE, c(D), s("not a date")),
    "dec const scale": op(Op.Plus, c(M), dec("0.0000001")),
    "bitand": op(Op.BitAnd, c(A), i(1)),
}


@pytest.fixture(scope="module")
def batches():
    rb = _ref_batch()
    rplanes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
               for cid, cd in rb.columns.items()}
    pb = carry.batch_from(rb)
    cpu = torch.device("cpu")
    return rb, rplanes, pb, kernels.batch_planes(pb, cpu), \
        kernels.device_live(pb, cpu)


def _port_eval(e, pb, planes, live):
    ce = compile_expr(carry.expr_from(e), pb)
    fin = ce.prog.finalize(None, [ce])
    plane_list = [planes[k][w] for k, w in fin.plane_keys]
    _mask, _gid, [(vals, valid)] = run_program_plain(fin, plane_list, live)
    return ce, fin, vals.numpy(), valid.numpy()


@pytest.mark.parametrize("name", sorted(SERVED))
def test_program_matches_reference(batches, name):
    rb, rplanes, pb, planes, live = batches
    e = SERVED[name]
    rc = rcompile(e, rb)
    rv, rva = rc(rplanes)
    rv = np.broadcast_to(np.asarray(rv), (CAP,))
    rva = np.broadcast_to(np.asarray(rva), (CAP,))
    ce, fin, pv, pva = _port_eval(e, pb, planes, live)
    assert (ce.kind, ce.scale, ce.max_abs) == (rc.kind, rc.scale,
                                               rc.max_abs), name
    assert fin.n_instr <= 64 and ce.prog._n_vregs >= 1
    assert np.array_equal(pva, rva), name
    got, want = pv[rva], rv[rva]
    if want.dtype == np.float64:
        assert got.dtype == np.float64, name
        assert np.allclose(got, want, rtol=F64_RTOL, atol=0.0), name
    else:
        assert np.array_equal(got, want.astype(np.int64)), name


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_in_both(batches, name):
    rb, _rplanes, pb, _planes, _live = batches
    e = REFUSED[name]
    with pytest.raises(RUnsupported):
        rcompile(e, rb)
    with pytest.raises(Unsupported):
        compile_expr(carry.expr_from(e), pb)


def test_where_mask_and_shared_program(batches):
    """One program, several outputs: the WHERE mask and two arguments
    evaluated together equal their separate evaluations."""
    rb, rplanes, pb, planes, live = batches
    prog_exprs = [SERVED["q1 disc_price"], SERVED["q1 charge"]]
    where_e = SERVED["a>10&c<4"]
    from tidb_tpu_torch.ops.exprc import Program
    prog = Program(pb)
    where = compile_expr(carry.expr_from(where_e), pb, prog)
    outs = [compile_expr(carry.expr_from(e), pb, prog) for e in prog_exprs]
    fin = prog.finalize(where, outs)
    plane_list = [planes[k][w] for k, w in fin.plane_keys]
    mask, _gid, vals = run_program_plain(fin, plane_list, live)
    wv, wva = rcompile(where_e, rb)(rplanes)
    want_mask = np.asarray(rb.row_mask()) & np.asarray(wva) & np.asarray(wv)
    assert np.array_equal(mask.numpy(), want_mask)
    for e, (pv, pva) in zip(prog_exprs, vals):
        rv, rva = rcompile(e, rb)(rplanes)
        assert np.array_equal(pva.numpy(), np.asarray(rva))
        assert np.array_equal(pv.numpy(), np.asarray(rv))


def test_register_ceiling():
    """A program needing more live values than registers is refused, not
    miscompiled."""
    rb = _ref_batch()
    pb = carry.batch_from(rb)
    from tidb_tpu_torch.ops.exprc import Program
    prog = Program(pb)
    outs = [compile_expr(carry.expr_from(op(Op.Plus, c(A), i(k))), pb, prog)
            for k in range(MAX_REGS + 1)]
    with pytest.raises(Unsupported):
        prog.finalize(None, outs)
