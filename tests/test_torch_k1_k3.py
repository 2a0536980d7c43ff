"""K1 (`expr_vm`) and K3 (`seg_agg_onehot`) of the port after their
redesign for Hopper: K1 on K5's four-row interpreter with its table by
value, K3 as one pass over the rows for all reductions in one launch.

- K3's plain route against the JAX package's one-hot segment reductions
  (`SegCtx` at S <= 64, as `build_grouped_agg_fn` runs them) at S = 1, 2,
  13 and 64: one group holding half the rows, every row dead (in the
  sink), empty segments, f64 sums, min and max with -0.0, +0.0, +-inf and
  NULLs, int64 extremes with wrapping sums, first_row; and through the
  JAX package's `build_grouped_agg_fn` on a statement whose largest group
  holds half the live rows.
- K1's plain route against the JAX package on the programs of TPC-H Q1,
  Q6 and the supplier group-by (WHERE mask, group id, argument planes)
  and on edge programs: string LUTs, f64 compares, NULL group codes to
  slot `size`, dead rows to the sink.
- The pure-Python parts against brute force: K1's table (`k1_pack`,
  decoded as the kernel reads it; the smaller, larger or packed parameter
  block at each limit, a program of K1_MAX_META words and a large LUT) and
  K3's launches (`k3_chunks`: slots, map and maximal spans).
- With a recording stub in place of the CUDA libraries, each wrapper's
  launches: K3 one a span, its output at the span's offset (the stub folds
  in numpy from the slots it was handed); K1 one, every pointer in its
  table where the kernel looks.
- The constants and C signatures the wrappers share with the sources.

Tolerance: masks, ids, counts, integer states and extrema exact (the
reference's f64 extremum identity +-F64_MAX mapped by `port_identity`);
f64 values 1e-12 relative (the summed values are multiples of 0.5, so
every sum is exact in both packages).
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import proto as rproto
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import kernels as rk
from tidb_tpu.ops.exprc import compile_expr as rcompile
from tidb_tpu.sqlast.opcode import Op as ROp
from tidb_tpu.types import datum as rdatum
from tidb_tpu.types.time_types import Time as RTime

from tidb_tpu_torch import carry, errors, tpch
from tidb_tpu_torch.copr.proto import (Expr, ExprType, expr_column,
                                       expr_op, expr_value)
from tidb_tpu_torch.ops import _ext, exprc
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops.exprc import Finalized, Program, compile_expr
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import NULL, Datum, Kind

from torch_parity import F64_RTOL, port_identity

CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
CPU = torch.device("cpu")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src: str, name: str) -> str:
    return re.search(r"#define %s (.+?)(?:\s*//.*)?$" % name, src,
                     re.M).group(1).strip()


# ---------------------------------------------------------------------------
# K3: the plain route against the JAX package's one-hot reductions
# ---------------------------------------------------------------------------

N3 = 3000


def _k3_planes(seed: int):
    """Int values with the int64 extremes, f64 values in halves with
    -0.0, +0.0 and +-inf in their own plane, and NULL planes."""
    rng = np.random.default_rng(seed)
    iv = rng.integers(-1000, 1000, N3)
    ext = rng.random(N3) < 0.03
    iv[ext] = rng.choice([I64_MAX, I64_MIN, I64_MAX - 7], int(ext.sum()))
    fv = rng.integers(-400, 400, N3) * 0.5
    fv[::7] = -0.0
    fv[::11] = 0.0
    fx = fv.copy()                        # extrema: +-inf beside the zeros
    fx[::13] = np.inf
    fx[::17] = -np.inf
    return (iv.astype(np.int64), fv, fx, rng.random(N3) > 0.15,
            rng.random(N3) > 0.3)


def _k3_gid(case: str, rng):
    """(S, gid, mask) of a case: the sink is the last segment."""
    S = {"S1": 1, "S2": 2, "S13": 13, "S64": 64, "hot": 13, "dead": 13,
         "empty": 64}[case]
    gid = rng.integers(0, S, N3)
    mask = rng.random(N3) > 0.25
    if case == "hot":                     # one group holds half the rows
        gid[rng.random(N3) < 0.5] = 4
    elif case == "dead":                  # every row dead, in the sink
        mask[:] = False
    elif case == "empty":                 # only a third of the segments
        gid = rng.integers(0, 21, N3) * 3
    gid = np.where(mask, gid, S - 1)
    return S, gid.astype(np.int64), mask


def _k3_reds(iv, fv, fx, ok, ok2):
    R, t = pk.Red, torch.from_numpy
    return [R(pk.R_COUNT, t(iv), t(ok)), R(pk.R_SUM_I, t(iv), t(ok)),
            R(pk.R_SUM_F, t(fv), t(ok2)), R(pk.R_MIN_I, t(iv), t(ok2)),
            R(pk.R_MAX_I, t(iv), t(ok)), R(pk.R_MIN_F, t(fx), t(ok)),
            R(pk.R_MAX_F, t(fx), t(ok2)), R(pk.R_FIRST),
            R(pk.R_SUM_I, const_bits=7), R(pk.R_COUNT, const_bits=1),
            R(pk.R_MAX_I, const_bits=3, never=True),
            R(pk.R_MIN_F, t(fv))]


def _ref_states(red, gid, mask, S: int):
    """(n, v) of one reduction through the JAX package's SegCtx at S
    segments (its one-hot route: S <= ONEHOT_SEGMENTS_MAX)."""
    seg = rk.SegCtx(jnp.asarray(gid), S)
    assert seg.use_onehot
    m = jnp.asarray(mask)
    if red.op == pk.R_FIRST:
        pos = jnp.arange(len(gid), dtype=jnp.int64)
        return np.asarray(seg.count(m)), np.asarray(seg.min(pos, m))
    if red.never:
        contrib = jnp.zeros_like(m)
    else:
        contrib = m if red.valid is None else m & jnp.asarray(
            red.valid.numpy())
    if red.values is None:
        v = jnp.full(len(gid), red.const_bits, jnp.int64)
    else:
        v = jnp.asarray(red.values.numpy())
    n = np.asarray(seg.count(contrib))
    if red.op == pk.R_COUNT:
        return n, np.zeros(S, np.int64)
    if red.op in (pk.R_SUM_I, pk.R_SUM_F):
        return n, np.asarray(seg.sum(v, contrib))
    if red.op in (pk.R_MIN_I, pk.R_MIN_F):
        return n, np.asarray(seg.min(v, contrib))
    return n, np.asarray(seg.max(v, contrib))


@pytest.mark.parametrize("case", ["S1", "S2", "S13", "S64", "hot", "dead",
                                  "empty"])
def test_k3_plain_matches_jax(case):
    rng = np.random.default_rng(hash(case) % 1000)
    iv, fv, fx, ok, ok2 = _k3_planes(7)
    S, gid, mask = _k3_gid(case, rng)
    reds = _k3_reds(iv, fv, fx, ok, ok2)
    n, acc = pk._seg_agg(torch.from_numpy(gid), torch.from_numpy(mask), S,
                         reds)
    assert tuple(n.shape) == tuple(acc.shape) == (len(reds), S)
    for r, red in enumerate(reds):
        wn, wv = _ref_states(red, gid, mask, S)
        assert np.array_equal(n[r].numpy(), wn), (case, r)
        got = acc[r].numpy()
        if red.op in pk.F_OPS:
            got = got.view(np.float64)
            want = port_identity(np.asarray(wv, np.float64))
            if red.op == pk.R_SUM_F:
                assert np.allclose(got, want, rtol=F64_RTOL, atol=0.0), \
                    (case, r)
            else:
                assert np.array_equal(got, want), (case, r)
        else:
            assert np.array_equal(got, np.asarray(wv).astype(np.int64)), \
                (case, r)
    if case == "dead":
        assert int(n[0, : S - 1].sum()) == 0
    if case == "empty":                   # empty segments hold sentinels
        empty = [s for s in range(S - 1) if s % 3]
        assert int(acc[3, empty].eq(I64_MAX).all()) == 1
        assert int(acc[4, empty].eq(I64_MIN).all()) == 1


# ---------------------------------------------------------------------------
# Both packages on the same TPC-H planes: statements and programs
# ---------------------------------------------------------------------------

L_CIDS = [tpch.C_SUPPKEY, tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
          tpch.C_DISCOUNT, tpch.C_TAX, tpch.C_RETURNFLAG, tpch.C_LINESTATUS,
          tpch.C_SHIPDATE]


def _ref_batch_of(pb: col.ColumnBatch) -> rcol.ColumnBatch:
    """The port's batch as the JAX package's (the same planes)."""
    return rcol.ColumnBatch(pb.n_rows, pb.capacity, pb.handles, {
        cid: rcol.ColumnData(cd.kind, cd.values, cd.valid, cd.dictionary,
                             tp=cd.tp, dec_scale=cd.dec_scale,
                             max_abs=cd.max_abs)
        for cid, cd in pb.columns.items()})


def _ref_datum(d):
    if d.kind == Kind.TIME:
        t = d.val
        return rdatum.Datum(rdatum.Kind.TIME, RTime.from_packed_int(
            t.to_packed_int(), t.tp, t.fsp))
    return rdatum.Datum(rdatum.Kind(int(d.kind)), d.val)


def _ref_expr(e):
    """A port Expr as the JAX package's."""
    if e is None:
        return None
    val = e.val
    if isinstance(val, Datum):
        val = _ref_datum(val)
    return rproto.Expr(rproto.ExprType(int(e.tp)), val=val,
                       op=None if e.op is None else ROp(int(e.op)),
                       children=[_ref_expr(c) for c in e.children],
                       distinct=bool(e.distinct))


@pytest.fixture(scope="module")
def lineitem():
    data = tpch.generate(3000, seed=21)
    pb = tpch.batch(data, L_CIDS)
    rb = _ref_batch_of(pb)
    rplanes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
               for cid, cd in rb.columns.items()}
    return pb, rb, rplanes


def _port_k1(sel, pb):
    """The port's request pieces and K1 (plain route) over a statement."""
    prog = Program(pb)
    where = compile_expr(sel.where, pb, prog) if sel.where is not None \
        else None
    specs = pk.lower_aggregates(sel, pb, prog)
    planes = dict(pk.batch_planes(pb, CPU))
    live = pk.device_live(pb, CPU)
    outputs = pk.program_outputs(specs)
    gspec = None
    if sel.group_by:
        gspec = pk.lower_group_by(sel, pb)
        for key in gspec.plane_keys:
            if key <= pk.GC_BASE:
                codes, _u = pb.group_codes(pk.GC_BASE - key)
                planes[key] = (torch.from_numpy(codes),
                               planes[pk.GC_BASE - key][1])
        fn = pk.build_grouped_agg_fn(prog, where, specs, gspec.plane_keys,
                                     gspec.sizes)
    else:
        fn = pk.build_scalar_agg_fn(prog, where, specs)
    mask, gid, outs = pk.run_k1(fn.program, planes, live, outputs,
                                gspec is not None)
    return specs, mask, gid, outs, fn


def _ref_k1(rsel, rb, rplanes):
    """The JAX package's WHERE mask, group id and argument planes: the
    mask by build_filter_fn, the group id as build_grouped_agg_fn's body
    builds it (caught where it hands it to SegCtx), each argument by its
    CompiledExpr."""
    where = rcompile(rsel.where, rb) if rsel.where is not None else None
    specs = rk.lower_aggregates(rsel, rb)
    live = jnp.asarray(rb.row_mask())
    planes = dict(rplanes)
    planes[rk.POS_CID] = (jnp.arange(rb.capacity, dtype=jnp.int64), None)
    mask = np.asarray(rk.build_filter_fn(where)(planes, live)[0])
    gid = None
    if rsel.group_by:
        gspec = rk.lower_group_by(rsel, rb)
        for key in gspec.plane_keys:
            if rk.is_group_code_key(key):
                codes, _u = rb.group_codes(rk.group_code_cid(key))
                planes[key] = (jnp.asarray(codes),
                               planes[rk.group_code_cid(key)][1])
        caught = []
        orig = rk.SegCtx.__init__

        def spy(self, g, S, presorted=False):
            caught.append(np.asarray(g))
            orig(self, g, S, presorted)

        rk.SegCtx.__init__ = spy
        try:
            rk.build_grouped_agg_fn(where, specs, gspec.plane_keys,
                                    gspec.sizes)(planes, live)
        finally:
            rk.SegCtx.__init__ = orig
        gid = caught[0]
    return specs, mask, gid, planes


STATEMENTS = {"q1": tpch.q1, "q6": tpch.q6, "by_supplier": tpch.by_supplier}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
def test_k1_plain_matches_jax_on_statements(lineitem, name):
    pb, rb, rplanes = lineitem
    sel = STATEMENTS[name]()
    rsel = rproto.SelectRequest(
        start_ts=1, table_info=None, where=_ref_expr(sel.where),
        group_by=[rproto.ByItem(_ref_expr(b.expr), b.desc)
                  for b in sel.group_by],
        aggregates=[_ref_expr(a) for a in sel.aggregates])
    specs, mask, gid, outs, _fn = _port_k1(sel, pb)
    rspecs, rmask, rgid, rplanes2 = _ref_k1(rsel, rb, rplanes)
    assert np.array_equal(mask.numpy(), rmask)
    if sel.group_by:
        assert np.array_equal(gid.numpy(), rgid)
    else:
        assert gid is None
    checked = 0
    for spec, rspec in zip(specs, rspecs):
        if not pk._needs_plane(spec):
            continue
        v, ok = outs[spec.arg.reg]
        rv, rok = rspec.arg(rplanes2)
        rok = np.broadcast_to(np.asarray(rok), ok.shape)
        assert np.array_equal(ok.numpy(), rok)
        got, want = v.numpy()[rok], np.broadcast_to(np.asarray(rv),
                                                    ok.shape)[rok]
        assert np.array_equal(got, want.astype(got.dtype))
        checked += 1
    assert checked == {"q1": 2, "q6": 1, "by_supplier": 0}[name]


def test_k3_plain_matches_jax_grouped_fn_hot_group():
    """A statement through both packages' build_grouped_agg_fn, one group
    holding half of the live rows: every output equal."""
    data = tpch.generate(3000, seed=22)
    data[tpch.C_RETURNFLAG][: 1500] = data[tpch.C_RETURNFLAG][0]
    data[tpch.C_LINESTATUS][: 1500] = data[tpch.C_LINESTATUS][0]
    pb = tpch.batch(data, L_CIDS)
    rb = _ref_batch_of(pb)
    rplanes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
               for cid, cd in rb.columns.items()}
    sel = tpch.q1()
    _specs, _m, _g, _o, fn = _port_k1(sel, pb)
    assert fn.num_segments <= pk.ONEHOT_SEGMENTS_MAX
    planes = dict(pk.batch_planes(pb, CPU))
    got = fn(planes, pk.device_live(pb, CPU))
    rsel = rproto.SelectRequest(
        start_ts=1, table_info=None, where=_ref_expr(sel.where),
        group_by=[rproto.ByItem(_ref_expr(b.expr), b.desc)
                  for b in sel.group_by],
        aggregates=[_ref_expr(a) for a in sel.aggregates])
    rspecs = rk.lower_aggregates(rsel, rb)
    gspec = rk.lower_group_by(rsel, rb)
    rplanes = dict(rplanes)
    rplanes[rk.POS_CID] = (jnp.arange(rb.capacity, dtype=jnp.int64), None)
    want = rk.build_grouped_agg_fn(rcompile(rsel.where, rb), rspecs,
                                   gspec.plane_keys, gspec.sizes)(
        rplanes, jnp.asarray(rb.row_mask()))
    assert len(got) == len(want)
    counts = np.asarray(got[0])
    assert counts.max() >= 0.45 * counts[:-1].sum()
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w).astype(
            np.asarray(g).dtype))


def _edge_exprs():
    """Edge programs: a string LUT (LIKE), string compares and IN lists,
    f64 compares and arithmetic, int IN with a NULL, IF / IFNULL."""
    c, v, op = expr_column, expr_value, expr_op
    i64 = Datum.i64
    like = Expr(ExprType.LIKE, val="\\",
                children=[c(4), v(Datum.string("%A%"))])
    in_s = Expr(ExprType.NOT_IN, children=[c(4), v(Datum.bytes_(b"AIR")),
                                           v(Datum.bytes_(b"SHIP"))])
    in_i = Expr(ExprType.IN, children=[c(2), v(i64(1)), v(i64(-3)),
                                       v(NULL)])
    return [
        [op(Op.OrOr, like, op(Op.LT, c(3), v(Datum.f64(-0.5)))),
         op(Op.Div, c(3), c(2)), op(Op.Plus, c(1), c(2))],
        [op(Op.AndAnd, op(Op.GE, c(3), v(Datum.f64(0.0))), in_s),
         op(Op.Mul, c(3), c(5)), op(Op.Minus, c(1), c(2))],
        [in_i, Expr(ExprType.IF, children=[op(Op.GE, c(2), v(i64(0))),
                                           c(1), c(2)]),
         Expr(ExprType.IFNULL, children=[c(3), c(2)])],
    ]


def _edge_batch(seed: int) -> col.ColumnBatch:
    """Planes with NULLs (also in the string column used as a group key),
    int64 extremes, zero divisors, -0.0 and +-inf, dead rows at the end."""
    rng = np.random.default_rng(seed)
    cap, n = 4096, 4096 - 37
    live = np.arange(cap) < n
    a = rng.integers(-1000, 1000, cap)
    a[rng.random(cap) < 0.05] = I64_MAX
    b = rng.integers(-5, 6, cap)
    f = rng.standard_normal(cap) * 100
    f[::13], f[::29], f[::31] = 0.0, -0.0, np.inf
    s = rng.integers(0, 6, cap)
    dic = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"SHIP", b"TRUCK"]
    sv = live & (rng.random(cap) > 0.1)
    cols = {
        1: col.ColumnData(col.K_I64, a.astype(np.int64),
                          live & (rng.random(cap) > 0.1), tp=8,
                          max_abs=I64_MAX),
        2: col.ColumnData(col.K_I64, b.astype(np.int64),
                          live & (rng.random(cap) > 0.1), tp=8, max_abs=5),
        3: col.ColumnData(col.K_F64, f, live & (rng.random(cap) > 0.1),
                          tp=5),
        4: col.ColumnData(col.K_STR, np.where(sv, s, -1).astype(np.int64),
                          sv, dic, tp=254),
        5: col.ColumnData(col.K_DEC, rng.integers(-99999, 99999, cap)
                          .astype(np.int64), live.copy(), tp=246,
                          dec_scale=2, max_abs=99999),
    }
    return col.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), cols)


@pytest.mark.parametrize("k", range(3))
def test_k1_plain_matches_jax_on_edge_programs(k):
    """Each edge program's WHERE, arguments and (grouped by the string
    column, NULLs in it) group id against the JAX package."""
    pb = _edge_batch(31 + k)
    rb = _ref_batch_of(pb)
    rplanes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
               for cid, cd in rb.columns.items()}
    exprs = _edge_exprs()[k]
    prog = Program(pb)
    outs = [compile_expr(e, pb, prog) for e in exprs]
    size = len(pb.columns[4].dictionary)
    fin = prog.finalize(outs[0], outs[1:], group=[(4, size)],
                        sink=size + 1)
    planes = pk.batch_planes(pb, CPU)
    mask, gid, vals = pk.expr_vm(fin, [planes[k_][w] for k_, w in
                                       fin.plane_keys],
                                 pk.device_live(pb, CPU), True)
    rwhere = rcompile(_ref_expr(exprs[0]), rb)
    live = jnp.asarray(rb.row_mask())
    rmask = np.asarray(rk.build_filter_fn(rwhere)(rplanes, live)[0])
    assert np.array_equal(mask.numpy(), rmask)
    codes, cva = rplanes[4]
    rgid = np.where(rmask, np.where(np.asarray(cva), np.asarray(codes),
                                    size), size + 1)
    assert np.array_equal(gid.numpy(), rgid)
    assert (gid.numpy() == size + 1).any()         # dead rows in the sink
    # NULL codes take slot `size` (program 1's NOT IN drops NULL strings)
    assert (gid.numpy() == size).any() == (k != 1)
    for e, (v, ok) in zip(exprs[1:], vals):
        rv, rok = rcompile(_ref_expr(e), rb)(rplanes)
        rok = np.broadcast_to(np.asarray(rok), ok.shape)
        assert np.array_equal(ok.numpy(), rok)
        got = v.numpy()[rok]
        want = np.broadcast_to(np.asarray(rv), ok.shape)[rok]
        if want.dtype == np.float64:
            assert np.allclose(got, want, rtol=F64_RTOL, atol=0.0,
                               equal_nan=True)
        else:
            assert np.array_equal(got, want.astype(np.int64))


# ---------------------------------------------------------------------------
# K1's table: k1_pack decoded as expr_vm.cu's k1_run reads it
# ---------------------------------------------------------------------------

K1H = dict(N=0, TILES=1, INSTR=2, WHERE=3, OUT=4, GROUP=5, SINK=6, REGS=7,
           LIVE=8, GID=9, OUTS=10, PLANES=11, INS=12, OREGS=13, GRP=14,
           POOL=15, LUT=16)


def _decode_k1(words) -> dict:
    w = np.frombuffer(words.tobytes(), dtype=np.int64)
    h = {k: int(w[i]) for k, i in K1H.items()}
    n_out, n_instr = h["OUT"], h["INSTR"]
    return dict(
        h=h, outs=w[h["OUTS"]:h["OUTS"] + 2 * n_out].tolist(),
        planes=w[h["PLANES"]:h["INS"]].tolist(),
        ins=w[h["INS"]:h["INS"] + 6 * n_instr].tolist(),
        oregs=w[h["OREGS"]:h["OREGS"] + n_out].tolist(),
        grp=w[h["GRP"]:h["GRP"] + 4 * h["GROUP"]].tolist(),
        pool=w[h["POOL"]:h["LUT"]],
        lut=w[h["LUT"]:].tobytes())


def _check_table(fin: Finalized, n: int, words, live_p, gid_p, outs_p,
                 planes_p) -> None:
    d = _decode_k1(words)
    meta = fin.meta
    n_instr, where, n_out, n_group, sink = (int(x) for x in meta[:5])
    h = d["h"]
    assert (h["N"], h["TILES"], h["INSTR"], h["WHERE"], h["OUT"],
            h["GROUP"], h["SINK"], h["LIVE"], h["GID"]) == (
        n, -(-n // pk.K5_TILE), n_instr, where, n_out, n_group, sink,
        live_p, gid_p)
    assert d["outs"] == outs_p and d["planes"] == planes_p
    ins = [list(x) for x in fin.instructions()]
    assert d["ins"] == [x for row in ins for x in row]
    where_, oregs, grp = fin.tail()
    assert d["oregs"] == oregs and d["grp"] == [x for g in grp for x in g]
    assert np.array_equal(d["pool"], fin.pool)
    lut = fin.lut.tobytes()
    assert d["lut"] == lut + bytes(-len(lut) % 8)
    regs = max([row[1] for row in ins] + oregs + [where], default=-1) + 1
    assert h["REGS"] == regs <= exprc.MAX_REGS


@pytest.mark.parametrize("k", range(3))
def test_k1_pack_layout(k):
    pb = _edge_batch(41 + k)
    prog = Program(pb)
    outs = [compile_expr(e, pb, prog) for e in _edge_exprs()[k]]
    fin = prog.finalize(outs[0], outs[1:], group=[(4, 6), (2, 11)],
                        sink=7 * 12)
    n = pb.capacity - 5
    out_p = list(range(1000, 1000 + 2 * len(fin.out_dts)))
    plane_p = list(range(5000, 5000 + len(fin.plane_keys)))
    words = pk.k1_pack(fin, n, 77, 88, out_p, plane_p)
    _check_table(fin, n, words, 77, 88, out_p, plane_p)
    assert pk.param_block(len(words)) == "small"
    # a second pack of the same program reuses its kept words
    again = pk.k1_pack(fin, 9, 1, 0, out_p, plane_p)
    _check_table(fin, 9, again, 1, 0, out_p, plane_p)


def test_param_block_limits():
    """K1 and K5 tables ride in the smaller block up to K5_SMALL_WORDS
    words, the larger up to K5_PARAM_WORDS, past it packed; the routes'
    LAUNCHES keys follow."""
    assert pk.param_block(pk.K1_T_HDR) == "small"
    assert pk.param_block(pk.K5_SMALL_WORDS) == "small"
    assert pk.param_block(pk.K5_SMALL_WORDS + 1) == "large"
    assert pk.param_block(pk.K5_PARAM_WORDS) == "large"
    assert pk.param_block(pk.K5_PARAM_WORDS + 1) == "packed"
    assert set(pk.K1_ROUTES) <= set(pk.LAUNCHES)
    assert pk.k5_route(pk.K5_PARAM_WORDS + 1) == pk.K5_ROUTES[1]


def _big_program(lut_bytes: int) -> Finalized:
    """A program of exactly K1_MAX_META words: 64 instructions, 16 output
    registers and group slots filling the rest; a LUT of lut_bytes."""
    n_instr, n_out = exprc.MAX_INSTRS, 16
    n_group = (pk.K1_MAX_META - exprc.HDR - 6 * n_instr - n_out) // 4
    n_out += pk.K1_MAX_META - exprc.HDR - 6 * n_instr - n_out - 4 * n_group
    meta = [n_instr, 3, n_out, n_group, 99, 2, 0, 0]
    for k in range(n_instr):
        meta += [exprc.OP_ADD_I, k % 16, (k + 1) % 16, (k + 2) % 16, 0, 0]
    meta += [k % 16 for k in range(n_out)]
    for j in range(n_group):
        meta += [0, 1, 5, 6]
    lut = np.frombuffer(bytes(range(256)) * (lut_bytes // 256 + 1),
                        np.uint8)[:lut_bytes].copy()
    return Finalized(np.asarray(meta, np.int64),
                     np.arange(40, dtype=np.int64), lut,
                     [(1, 0), (1, 1)], ["i"] * n_out)


@pytest.mark.parametrize("lut_bytes,block", [
    (1, "large"), (8 * pk.K5_PARAM_WORDS, "packed"), (40_000, "packed")])
def test_k1_pack_at_the_limits(lut_bytes, block):
    """A K1_MAX_META program packs whole; with a large LUT its table goes
    packed; the layout is the same in every block."""
    fin = _big_program(lut_bytes)
    assert fin.meta.shape[0] == pk.K1_MAX_META
    out_p = list(range(2 * len(fin.out_dts)))
    words = pk.k1_pack(fin, 123_457, 5, 6, out_p, [11, 12])
    _check_table(fin, 123_457, words, 5, 6, out_p, [11, 12])
    assert pk.param_block(len(words)) == block
    assert pk.param_block(len(words) - (lut_bytes + 7) // 8 + 1) != \
        "packed"


# ---------------------------------------------------------------------------
# K3's launches: k3_chunks against brute force
# ---------------------------------------------------------------------------

def _want_slots(red) -> list:
    """The count and value slot rows a reduction needs, built apart from
    kernels._slot_rows."""
    if red.op == pk.R_FIRST:
        return [[pk.R_COUNT, 0, 1, 0, 0], [pk.R_FIRST, 1, 0, 0, 0]]
    if red.never:
        return []
    valid = 0 if red.valid is None else red.valid.data_ptr()
    rows = [[pk.R_COUNT, 0, 1, 0, valid]]
    if red.op != pk.R_COUNT:
        vals = 0 if red.values is None else red.values.data_ptr()
        rows.append([red.op, 0, red.const_bits if red.values is None else 0,
                     vals, valid])
    return rows


def _fits(reds, S: int) -> bool:
    rows = []
    for red in reds:
        for row in _want_slots(red):
            if row not in rows:
                rows.append(row)
    n_f = sum(r[0] in pk.F_OPS for r in rows)
    return len(reds) <= pk.K3_MAX_REDS and len(rows) <= pk.K3_MAX_SLOTS \
        and pk.k3_smem_bytes(len(rows) - n_f, n_f, S, 1) <= pk.K3_SMEM_CAP


def _many_reds(rng, k: int) -> list:
    planes_i = [torch.from_numpy(rng.integers(0, 9, 8)) for _ in range(9)]
    planes_f = [torch.from_numpy(rng.random(8)) for _ in range(9)]
    valids = [None] + [torch.from_numpy(rng.random(8) > 0.5)
                       for _ in range(3)]
    ops = [pk.R_COUNT, pk.R_SUM_I, pk.R_SUM_F, pk.R_MIN_I, pk.R_MAX_I,
           pk.R_MIN_F, pk.R_MAX_F, pk.R_FIRST]
    out = []
    for _ in range(k):
        op = ops[rng.integers(len(ops))]
        valid = valids[rng.integers(len(valids))]
        f = op in pk.F_OPS
        plane = (planes_f if f else planes_i)[rng.integers(9)]
        kind = rng.integers(6)
        if kind == 0:
            out.append(pk.Red(op, const_bits=int(rng.integers(1, 4)),
                              valid=valid))
        elif kind == 1:
            out.append(pk.Red(op, const_bits=3, never=True))
        else:
            out.append(pk.Red(op, plane, valid))
    return out


@pytest.mark.parametrize("seed,k,S", [(1, 11, 13), (2, 40, 64), (3, 90, 8),
                                      (4, 70, 64), (5, 1, 1)])
def test_k3_chunks_against_brute_force(seed, k, S):
    reds = _many_reds(np.random.default_rng(seed), k)
    chunks = pk.k3_chunks(reds, S)
    at = 0
    for a, b, slots, red_map in chunks:
        assert a == at and b > a
        sub = reds[a:b]
        assert _fits(sub, S)
        assert b == len(reds) or not _fits(reds[a:b + 1], S)   # maximal
        flags = [r[0] in pk.F_OPS for r in slots]
        assert flags == sorted(flags)                          # ints first
        assert len({tuple(r) for r in slots}) == len(slots)
        want_rows = {tuple(r) for red in sub for r in _want_slots(red)}
        assert {tuple(r) for r in slots} == want_rows
        for red, (op, cs, vs) in zip(sub, red_map):
            rows = _want_slots(red)
            assert op == red.op
            assert (slots[cs] if cs >= 0 else None) == \
                (rows[0] if rows else None)
            assert (slots[vs] if vs >= 0 else None) == \
                (rows[1] if len(rows) > 1 else None)
        at = b
    assert at == len(reds)
    if seed == 1:
        assert len(chunks) == 1


def test_k3_slab_and_bytes():
    """A copy of the integer states is an odd number of words; Q1's
    twelve integer slots over 13 segments take 32 copies within
    K3_COPIES_BYTES, and one copy of 32 slots at 64 segments (f64 ones
    included up to the cap) fits K3_SMEM_CAP."""
    assert pk.k3_slab(12, 13) == 157 and pk.k3_slab(3, 5) == 15
    assert pk.k3_slab(0, 64) == 0
    assert pk.k3_smem_bytes(12, 0, 13, 32) <= pk.K3_COPIES_BYTES
    assert pk.k3_smem_bytes(32, 0, 64, 1) <= pk.K3_SMEM_CAP
    assert pk.k3_smem_bytes(0, 24, 64, 1) <= pk.K3_SMEM_CAP
    assert pk.k3_workspace_bytes(0, 13) == 8 + 8 * pk.K3_CELLS


# ---------------------------------------------------------------------------
# The wrappers' card paths over a recording stub
# ---------------------------------------------------------------------------

def _i64(addr: int, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.int64)
    return np.ctypeslib.as_array((ctypes.c_int64 * n).from_address(addr))


class _Stub:
    """seg_onehot_launch folded in numpy from the slots and map it is
    handed (the planes found by their pointers), and expr_vm_launch
    answered by the plain version after its table is checked."""

    def __init__(self):
        self.calls = []
        self.tensors = {}
        self.k1 = None

    def know(self, *ts):
        for t in ts:
            if t is not None:
                self.tensors[t.data_ptr()] = t

    def seg_onehot_launch(self, n, gid_p, mask_p, S, n_slots, n_f, slots_p,
                          n_red, map_p, work_p, out_p, _st):
        slots = _i64(slots_p, n_slots * pk.K3_SLOT).reshape(n_slots, -1) \
            if n_slots else np.zeros((0, pk.K3_SLOT), np.int64)
        rmap = _i64(map_p, n_red * pk.K3_MAP).reshape(n_red, -1)
        self.calls.append(("k3", n_slots, n_f, n_red, slots.tolist(),
                           rmap.tolist(), work_p))
        gid = self.tensors[gid_p].numpy()
        mask = self.tensors[mask_p].numpy()
        states = []
        for op, flags, cval, vals_p, valid_p in slots.tolist():
            take = mask.copy()
            if valid_p:
                take &= self.tensors[valid_p].numpy()
            if op == pk.R_COUNT:
                states.append(np.bincount(gid[take], minlength=S))
                continue
            x = np.arange(n) if flags & 1 else (
                self.tensors[vals_p].numpy().view(np.int64) if vals_p
                else np.full(n, cval, np.int64))
            red = pk.Red(op, torch.from_numpy(x.copy()).view(
                torch.float64) if op in pk.F_OPS else torch.from_numpy(
                    x.copy()))
            states.append(pk.seg_agg_plain(
                torch.from_numpy(gid), torch.from_numpy(take), S,
                [red])[1][0].numpy())
        out = _i64(out_p, n_red * S * 2).reshape(n_red, S, 2)
        for r, (op, cs, vs) in enumerate(rmap.tolist()):
            out[r, :, 0] = states[cs] if cs >= 0 else 0
            out[r, :, 1] = states[vs] if vs >= 0 else \
                pk._sentinel(op) if op in (pk.R_MIN_I, pk.R_MAX_I,
                                           pk.R_FIRST) else \
                np.array(pk._sentinel(op)).view(np.int64) \
                if op in (pk.R_MIN_F, pk.R_MAX_F) else 0
        return 0

    def expr_vm_launch(self, words_p, n_words, dev_words, mask_p, _st):
        fin, plane_list, live, gid_want = self.k1
        words = _i64(words_p, n_words).copy()
        self.calls.append(("k1", n_words, dev_words))
        d = _decode_k1(words)
        assert d["planes"] == [t.data_ptr() for t in plane_list]
        assert d["h"]["LIVE"] == live.data_ptr()
        mask, gid, values = exprc.run_program_plain(fin, plane_list, live)
        n = live.shape[0]
        np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(mask_p))[:] \
            = mask.numpy()
        if gid_want:
            _i64(d["h"]["GID"], n)[:] = gid.numpy()
        for j, (v, ok) in enumerate(values):
            _i64(d["outs"][2 * j], n)[:] = v.numpy().view(np.int64)
            np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(
                d["outs"][2 * j + 1]))[:] = ok.numpy()
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    stub = _Stub()
    monkeypatch.setattr(_ext, "lib", lambda name: stub)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return stub


@pytest.mark.parametrize("k,S", [(12, 13), (70, 64), (3, 1)])
def test_k3_launches_one_a_chunk(stub_card, k, S):
    rng = np.random.default_rng(k)
    n = 8
    reds = _many_reds(rng, k)
    gid = torch.from_numpy(rng.integers(0, S, n))
    mask = torch.from_numpy(rng.random(n) > 0.3)
    stub_card.know(gid, mask, *[t for r in reds for t in (r.values,
                                                          r.valid)])
    got_n, got_v = pk.seg_agg_onehot(gid, mask, S, reds)
    chunks = pk.k3_chunks(reds, S)
    assert pk.LAUNCHES["seg_agg_onehot"] == len(chunks) == \
        len(stub_card.calls)
    for (_a, _b, slots, red_map), call in zip(chunks, stub_card.calls):
        n_f = sum(r[0] in pk.F_OPS for r in slots)
        assert call[1:6] == (len(slots), n_f, len(red_map), slots,
                             red_map)
    want_n, want_v = pk.seg_agg_plain(gid, mask, S, reds)
    assert torch.equal(got_n, want_n)
    for r, red in enumerate(reds):
        if red.op == pk.R_SUM_F:
            assert np.allclose(got_v[r].view(torch.float64).numpy(),
                               want_v[r].view(torch.float64).numpy(),
                               rtol=F64_RTOL, atol=0.0)
        else:
            assert torch.equal(got_v[r], want_v[r]), r


def test_k1_launch_wires_its_table(stub_card):
    pb = _edge_batch(51)
    prog = Program(pb)
    outs = [compile_expr(e, pb, prog) for e in _edge_exprs()[0]]
    fin = prog.finalize(outs[0], outs[1:], group=[(4, 6)], sink=7)
    planes = pk.batch_planes(pb, CPU)
    plane_list = [planes[k][w] for k, w in fin.plane_keys]
    live = pk.device_live(pb, CPU)
    stub_card.k1 = (fin, plane_list, live, True)
    mask, gid, vals = pk.expr_vm(fin, plane_list, live, True)
    assert [c[0] for c in stub_card.calls] == ["k1"]
    assert stub_card.calls[0][2] is None            # by value
    assert pk.LAUNCHES["expr_vm"] == 1
    pm, pg, pv = exprc.run_program_plain(fin, plane_list, live)
    assert torch.equal(mask, pm) and torch.equal(gid, pg)
    for (a, aok), (b, bok) in zip(vals, pv):
        assert torch.equal(aok, bok)
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    with pytest.raises(Exception):
        pk.expr_vm(fin, plane_list, live, False)    # gid without groups


def test_k1_checks_its_planes_on_every_call(stub_card):
    """A second call with the same program and the very same tensors
    checks them again: a plane cut short in place since the first call is
    refused before any launch."""
    pb = _edge_batch(52)
    prog = Program(pb)
    outs = [compile_expr(e, pb, prog) for e in _edge_exprs()[0]]
    fin = prog.finalize(outs[0], outs[1:], group=[(4, 6)], sink=7)
    planes = pk.batch_planes(pb, CPU)
    plane_list = [planes[k][w].clone() for k, w in fin.plane_keys]
    live = pk.device_live(pb, CPU)
    stub_card.k1 = (fin, plane_list, live, True)
    pk.expr_vm(fin, plane_list, live, True)
    plane_list[0].resize_(plane_list[0].shape[0] - 1)
    with pytest.raises(errors.DeviceError):
        pk.expr_vm(fin, plane_list, live, True)
    assert pk.LAUNCHES["expr_vm"] == 1 and len(stub_card.calls) == 1


# ---------------------------------------------------------------------------
# constants and signatures shared with the sources
# ---------------------------------------------------------------------------

def test_k1_k3_constants_match_the_sources():
    k3 = _source("seg_agg_onehot.cu")
    for name in ("K3_THREADS", "K3_MAX_SLOTS", "K3_MAX_REDS",
                 "K3_MAX_COPIES", "K3_SLOT", "K3_MAP", "K3_COPIES_BYTES",
                 "K3_SMEM_CAP", "K3_MAX_GRID"):
        assert int(_define(k3, name)) == getattr(pk, name), name
    assert int(_define(k3, "K3_MAX_SEG")) == pk.ONEHOT_SEGMENTS_MAX
    assert _define(k3, "K3_CELLS") == "(K3_MAX_SLOTS * K3_MAX_SEG)"
    assert _define(k3, "K3_WARPS") == "(K3_THREADS / 32)"
    assert pk.K3_WARPS == pk.K3_THREADS // 32
    # one launch a chunk; descriptors by value, no upload, no second pass
    assert k3.count("<<<") == 1 and "cudaMemcpy" not in k3
    assert "__grid_constant__ K3Args" in k3
    vm = _source("expr_vm.cu")
    heads = dict(re.findall(r"#define K1_T_(\w+) (\d+)", vm))
    assert int(heads.pop("HDR")) == pk.K1_T_HDR
    assert {k: int(v) for k, v in heads.items()} == K1H
    common = _source("common.cuh")
    assert int(_define(common, "K1_MAX_META")) == pk.K1_MAX_META
    # K1 runs K5's interpreter: no per-thread register arrays, no staged
    # program, and vm.cuh keeps only the register file in shared memory
    assert "v[K1_MAX_REGS]" not in vm and "sm[K1_MAX_META]" not in vm
    assert "vm_exec_rows<K5_ROWS>(ins" in vm
    head = _source("vm.cuh")
    assert "VmArrayRegs" not in head and "vm_run" not in head


@pytest.mark.parametrize("name,fn", [("expr_vm", "expr_vm_launch"),
                                     ("seg_agg_onehot", "seg_onehot_launch")])
def test_k1_k3_signatures_match_the_sources(name, fn):
    src = _source(name + ".cu")
    params = re.search(r'extern "C" \w+ %s\((.*?)\)\s*\{' % fn, src,
                       re.S).group(1)
    argtypes, _rt = _ext.SIGNATURES[name][fn]
    assert len(argtypes) == len([p for p in params.split(",") if p.strip()])
    assert set(_ext.SIGNATURES[name]) == set(
        re.findall(r'extern "C" \w+ (\w+)\(', src))
