"""Plain versions of K2/K3/K4 (through the port's request builders)
against the JAX package's build_scalar_agg_fn / build_grouped_agg_fn, run
through pack_outputs / unpack_outputs as TpuClient runs them.

Cases: scalar with and without WHERE, an all-filtered aggregate, a COUNT
of NULL, NULL group values, the dead-row sink, empty segments, int64
extremes (wrapping sums), first_row, S = 13 (one-hot route, K3) and
S > 64 (sorted route, K4).

Tolerance: counts, ints, decimals, min/max and positions exact; f64 sums
relative 1e-12. The f64 values are multiples of 0.5, so every sum is exact
in both packages whatever the order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.proto import ByItem, SelectRequest, expr_agg, \
    expr_column as c, expr_op, expr_value
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import kernels as rk
from tidb_tpu.ops.exprc import compile_expr as rcompile
from tidb_tpu.sqlast.opcode import Op
from tidb_tpu.types import Datum as RDatum
from tidb_tpu.types.datum import NULL as RNULL

from tidb_tpu_torch import carry
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops.exprc import Program, compile_expr

from torch_parity import F64_RTOL

CAP, N = 2048, 1900
G1, G2, GN, VI, VF, VD, W, GE = 1, 2, 3, 4, 5, 6, 7, 8
I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)


def _ref_batch(seed: int) -> rcol.ColumnBatch:
    rng = np.random.default_rng(seed)
    live = np.zeros(CAP, bool)
    live[:N] = True

    def valid(p=0.1):
        return live & (rng.random(CAP) > p)

    def codes(k, va):
        return np.where(va, rng.integers(0, k, CAP), -1).astype(np.int64)

    g1v, g2v = valid(), valid()
    vi = rng.integers(-1000, 1000, CAP)
    ext = rng.random(CAP) < 0.02
    vi[ext] = rng.choice([I64_MAX, I64_MIN, I64_MAX - 7], int(ext.sum()))
    vf = rng.integers(-400, 400, CAP) * 0.5
    vf[::31] = -0.0
    cols = {
        G1: rcol.ColumnData(rcol.K_STR, codes(3, g1v), g1v,
                            [b"a", b"b", b"c"], tp=rmy.TypeVarchar),
        G2: rcol.ColumnData(rcol.K_STR, codes(2, g2v), g2v, [b"p", b"q"],
                            tp=rmy.TypeVarchar),
        GN: rcol.ColumnData(rcol.K_I64, rng.integers(0, 100, CAP)
                            .astype(np.int64) * 7, valid(), tp=rmy.TypeLong,
                            max_abs=693),
        VI: rcol.ColumnData(rcol.K_I64, vi.astype(np.int64), valid(),
                            tp=rmy.TypeLonglong, max_abs=I64_MAX),
        VF: rcol.ColumnData(rcol.K_F64, vf, valid(), tp=rmy.TypeDouble),
        VD: rcol.ColumnData(rcol.K_DEC, rng.integers(-99999, 99999, CAP)
                            .astype(np.int64), valid(),
                            tp=rmy.TypeNewDecimal, dec_scale=2,
                            max_abs=99999),
        W: rcol.ColumnData(rcol.K_I64, rng.integers(0, 10, CAP)
                           .astype(np.int64), valid(), tp=rmy.TypeLong,
                           max_abs=9),
        GE: rcol.ColumnData(rcol.K_STR, np.full(CAP, -1, np.int64),
                            np.zeros(CAP, bool), [], tp=rmy.TypeVarchar),
    }
    return rcol.ColumnBatch(N, CAP, np.arange(CAP, dtype=np.int64), cols)


def _aggs():
    one = expr_value(RDatum.i64(1))
    return [expr_agg("count", [one]), expr_agg("count", [c(VI)]),
            expr_agg("count", [expr_value(RNULL)]),
            expr_agg("sum", [c(VI)]), expr_agg("avg", [c(VF)]),
            expr_agg("sum", [c(VD)]), expr_agg("avg", [c(VD)]),
            expr_agg("min", [c(VI)]), expr_agg("max", [c(VI)]),
            expr_agg("min", [c(VF)]), expr_agg("max", [c(VF)]),
            expr_agg("min", [c(G1)]), expr_agg("max", [c(VD)]),
            expr_agg("sum", [expr_op(Op.Mul, c(VF), c(W))]),
            expr_agg("first_row", [c(VF)]),
            expr_agg("first_row", [c(G2)])]


_W_SOME = expr_op(Op.GT, c(W), expr_value(RDatum.i64(3)))
_W_NONE = expr_op(Op.GT, c(W), expr_value(RDatum.i64(100)))

CASES = {
    "scalar": (None, []),
    "scalar where": (_W_SOME, []),
    "scalar all filtered": (_W_NONE, []),
    "S=13 onehot": (_W_SOME, [G1, G2]),
    "S=13 no where": (None, [G1, G2]),
    "S=102 sorted": (_W_SOME, [GN]),
    "S>64 two keys": (None, [GN, G2]),
    "all filtered grouped": (_W_NONE, [G1]),
    "all-null group column": (None, [GE, G1]),
}


def _ref_outs(req, rb, grouped):
    where = rcompile(req.where, rb) if req.where is not None else None
    specs = rk.lower_aggregates(req, rb)
    planes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
              for cid, cd in rb.columns.items()}
    planes[rk.POS_CID] = (jnp.arange(rb.capacity, dtype=jnp.int64), None)
    live = jnp.asarray(rb.row_mask())
    if grouped:
        gspec = rk.lower_group_by(req, rb)
        assert gspec.kind == "radix"
        for key in gspec.plane_keys:
            if rk.is_group_code_key(key):
                cid = rk.group_code_cid(key)
                codes, _u = rb.group_codes(cid)
                planes[key] = (jnp.asarray(codes), planes[cid][1])
        fn = rk.build_grouped_agg_fn(where, specs, gspec.plane_keys,
                                     gspec.sizes)
    else:
        fn = rk.build_scalar_agg_fn(where, specs, rb.n_rows)
    wrapper = rk.pack_outputs(fn)
    packed = np.asarray(jax.jit(wrapper)(planes, live))
    return rk.unpack_outputs(wrapper, packed), fn


def _port_outs(req, rb, grouped):
    pb = carry.batch_from(rb)
    preq = carry.request_from(req)
    prog = Program(pb)
    where = compile_expr(preq.where, pb, prog) \
        if preq.where is not None else None
    specs = pk.lower_aggregates(preq, pb, prog)
    cpu = torch.device("cpu")
    planes = dict(pk.batch_planes(pb, cpu))
    live = pk.device_live(pb, cpu)
    if grouped:
        gspec = pk.lower_group_by(preq, pb)
        for key in gspec.plane_keys:
            if key <= pk.GC_BASE:
                cid = pk.GC_BASE - key
                codes, _u = pb.group_codes(cid)
                planes[key] = (torch.from_numpy(codes), planes[cid][1])
        fn = pk.build_grouped_agg_fn(prog, where, specs, gspec.plane_keys,
                                     gspec.sizes)
    else:
        fn = pk.build_scalar_agg_fn(prog, where, specs)
    return fn(planes, live), fn


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernels_match_jax(case):
    where, keys = CASES[case]
    rb = _ref_batch(0)
    req = SelectRequest(start_ts=0, where=where,
                        group_by=[ByItem(c(k)) for k in keys],
                        aggregates=_aggs())
    grouped = bool(keys)
    want, rfn = _ref_outs(req, rb, grouped)
    got, pfn = _port_outs(req, rb, grouped)
    if grouped:
        assert pfn.num_segments == rfn.num_segments
        assert pfn.radices == rfn.radices
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (case, j)
        if w.dtype.kind == "f":
            assert g.dtype.kind == "f", (case, j)
            assert np.allclose(g, w, rtol=F64_RTOL, atol=0.0), (case, j, g, w)
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), \
                (case, j, g, w)


def test_segment_routes():
    """S = 13 takes K3's route, S > 64 K4's, as in the reference."""
    rb = _ref_batch(0)
    for keys, want in (([G1, G2], 13), ([GN], 102)):
        req = SelectRequest(start_ts=0, group_by=[ByItem(c(k))
                                                  for k in keys],
                            aggregates=[expr_agg("count", [c(VI)])])
        _outs, fn = _port_outs(req, rb, True)
        assert fn.num_segments == want


@pytest.mark.parametrize("op", ["min", "max", "sum", "first"])
def test_seg_plain_empty_segments_hold_sentinels(op):
    gid = torch.tensor([0, 0, 3, 3, 5], dtype=torch.int64)
    mask = torch.tensor([True, False, True, True, False])
    vals = torch.tensor([4, 9, -2, 7, 1], dtype=torch.int64)
    red = {"min": pk.R_MIN_I, "max": pk.R_MAX_I, "sum": pk.R_SUM_I,
           "first": pk.R_FIRST}[op]
    n, acc = pk.seg_agg_plain(gid, mask, 6, [pk.Red(red, vals)])
    empty = {"min": I64_MAX, "max": I64_MIN, "sum": 0, "first": I64_MAX}[op]
    assert n[0].tolist() == [1, 0, 0, 2, 0, 0]
    for s in (1, 2, 4, 5):
        assert int(acc[0, s]) == empty


def test_cuda_tensor_without_card_raises():
    """A wrapper never falls back: a tensor on a device the port has no
    kernel for raises."""
    from tidb_tpu_torch import errors
    mask = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(errors.DeviceError):
        pk.scalar_agg(mask, [pk.Red(pk.R_COUNT)])


def test_reduction_ops_match_header():
    """kernels.py and ops/csrc/common.cuh agree on every op number, and
    exprc.py on every bytecode number."""
    import os
    import re

    from tidb_tpu_torch.ops import exprc
    src = open(os.path.join(os.path.dirname(pk.__file__), "csrc",
                            "common.cuh")).read()
    enums = {m.group(1): int(m.group(2))
             for m in re.finditer(r"\b((?:OP|R)_[A-Z_0-9]+) = (\d+)", src)}
    assert len(enums) >= 50
    for name, val in enums.items():
        mod = pk if name.startswith("R_") else exprc
        assert getattr(mod, name) == val, name
    assert int(re.search(r"#define K1_HDR (\d+)", src).group(1)) == exprc.HDR
    assert int(re.search(r"#define K1_MAX_REGS (\d+)", src).group(1)) == \
        exprc.MAX_REGS
    assert int(re.search(r"#define RED_DESC (\d+)", src).group(1)) == 5
    onehot = open(os.path.join(os.path.dirname(pk.__file__), "csrc",
                               "seg_agg_onehot.cu")).read()
    assert int(re.search(r"#define K3_MAX_SEG (\d+)", onehot).group(1)) == \
        pk.ONEHOT_SEGMENTS_MAX


# ---------------------------------------------------------------------------
# slice 2: the plain versions of region_filter_batched (K5),
# region_agg_states_batched (K6) and combine_region_partials (K7) against
# the JAX functions of the same names. Exact throughout: the f64 values
# checked are elementwise planes and extrema.
# ---------------------------------------------------------------------------

RS, RI, RF, RD = 1, 2, 3, 4     # string, int, double, decimal columns


def _region_batch(cap: int, n: int, seed: int) -> rcol.ColumnBatch:
    """One region's planes: its own string dictionary, NULLs, int64
    extremes, -0.0 and n live rows (not always a multiple of 32)."""
    rng = np.random.default_rng(seed)
    live = np.zeros(cap, bool)
    live[:n] = True
    words = sorted(set(rng.choice([b"AIR", b"FOB", b"MAIL", b"RAIL",
                                   b"SHIP", b"xyz"], 4).tolist()))
    sv = live & (rng.random(cap) > 0.1)
    vi = rng.integers(-50, 50, cap)
    ext = rng.random(cap) < 0.03
    vi[ext] = rng.choice([I64_MAX, I64_MIN, -1], int(ext.sum()))
    vf = rng.integers(-400, 400, cap) * 0.25
    vf[::37] = -0.0
    cols = {
        RS: rcol.ColumnData(rcol.K_STR, np.where(
            sv, rng.integers(0, len(words), cap), -1).astype(np.int64), sv,
            words, tp=rmy.TypeVarchar),
        RI: rcol.ColumnData(rcol.K_I64, vi.astype(np.int64),
                            live & (rng.random(cap) > 0.1),
                            tp=rmy.TypeLonglong, max_abs=I64_MAX),
        RF: rcol.ColumnData(rcol.K_F64, vf, live & (rng.random(cap) > 0.1),
                            tp=rmy.TypeDouble),
        RD: rcol.ColumnData(rcol.K_DEC, rng.integers(-9999, 9999, cap)
                            .astype(np.int64), live & (rng.random(cap) > 0.1),
                            tp=rmy.TypeNewDecimal, dec_scale=2, max_abs=9999),
    }
    return rcol.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), cols)


# (capacity, live rows) per region: capacities 1024 and 2048, live rows
# not a multiple of 32, and a region with no live row
REGION_SHAPES = [(1024, 1000), (2048, 2047), (1024, 0), (2048, 1507)]

_S = lambda s: expr_value(RDatum.string(s))  # noqa: E731
_I = lambda v: expr_value(RDatum.i64(v))  # noqa: E731
WHERES = {
    "string compare, or": expr_op(
        Op.OrOr, expr_op(Op.AndAnd, expr_op(Op.GT, c(RI), _I(5)),
                         expr_op(Op.EQ, c(RS), _S("MAIL"))),
        expr_op(Op.LT, c(RF), expr_value(RDatum.f64(0.5)))),
    "NULL predicate": expr_op(Op.LT, c(RI), _I(0)),
    "decimal and string range": expr_op(
        Op.AndAnd, expr_op(Op.GE, c(RD), expr_value(RDatum.dec("1.25"))),
        expr_op(Op.LT, c(RS), _S("RAIL"))),
    "nothing survives": expr_op(Op.GT, c(RI), expr_value(RDatum.i64(
        I64_MAX))),
}


def _regions(seed: int):
    rbs = [_region_batch(cap, n, seed + r)
           for r, (cap, n) in enumerate(REGION_SHAPES)]
    return rbs, [carry.batch_from(rb) for rb in rbs]


def _port_regions(pbs, where_p, args_p=()):
    """K5 inputs: per region one program of WHERE + argument outputs."""
    from tidb_tpu_torch.ops.exprc import compile_arg_plane
    cpu = torch.device("cpu")
    regions, progs = [], []
    for pb in pbs:
        prog = Program(pb)
        where = compile_expr(where_p, pb, prog) if where_p is not None \
            else None
        colpb = {cid: carry.column_info_from(_pbcol(cid))
                 for cid in pb.columns}
        aps = [compile_arg_plane(a, pb, colpb, prog) for a in args_p]
        fin = prog.finalize(where, [a.compiled for a in aps])
        planes = pk.batch_planes(pb, cpu)
        regions.append(pk.RegionProgram(
            fin, [planes[k][w] for k, w in fin.plane_keys], pb.capacity,
            pb.n_rows))
        progs.append(aps)
    return regions, progs


def _pbcol(cid):
    from tidb_tpu.copr.proto import PBColumnInfo
    tp = {RS: rmy.TypeVarchar, RI: rmy.TypeLonglong, RF: rmy.TypeDouble,
          RD: rmy.TypeNewDecimal}[cid]
    return PBColumnInfo(column_id=cid, tp=tp, decimal=2 if cid == RD else -1)


@pytest.mark.parametrize("case", sorted(WHERES))
def test_region_filter_batched_matches_jax(case):
    rbs, pbs = _regions(11)
    where = WHERES[case]
    segs = []
    for r, rb in enumerate(rbs):
        compiled = rcompile(where, rb)
        cids = sorted({RS, RI, RF, RD})
        segs.append(((case, r), compiled,
                     {cid: (rb.columns[cid].values, rb.columns[cid].valid)
                      for cid in cids}, rb.capacity, rb.n_rows, ()))
    want = rk.region_filter_batched(segs)
    regions, _ = _port_regions(pbs, carry.expr_from(where))
    bits, outs = pk.region_filter_batched(regions, "cpu")
    got = pk.unpack_masks(bits, [rb.capacity for rb in rbs])
    assert outs == []
    for g, w in zip(got, want):
        assert np.array_equal(g, w), case
    # the packed layout is np.packbits(..., bitorder="little") region by
    # region, at capacities 1024 and 2048
    assert np.array_equal(bits.numpy(), np.concatenate(
        [np.packbits(w, bitorder="little") for w in want]))


ARGS = [expr_op(Op.Mul, c(RD), expr_op(Op.Minus, _I(1), c(RD))),
        expr_op(Op.Plus, c(RF), expr_value(RDatum.dec("0.5"))),
        expr_op(Op.Minus, c(RD), _I(3))]


def _ref_argspec(expr, rb):
    from tidb_tpu.copr.columnar_region import ArgPlaneSpec as RArg
    from tidb_tpu.ops.exprc import compile_arg_plane as rcap
    colpb = {cid: _pbcol(cid) for cid in rb.columns}
    return RArg(rcap(expr, rb, colpb), rb)


def _states_case(rb, seed):
    """(gid, [(op, values key, contrib)], G) of one region: region-local
    group ids over the live rows, sink G for the rest."""
    rng = np.random.default_rng(seed)
    G = int(rng.integers(0, 6)) if rb.n_rows else 0
    mask = rb.row_mask() & (rng.random(rb.capacity) > 0.2)
    gid = np.full(rb.capacity, G, np.int64)
    if G:
        gid[mask] = rng.integers(0, G, int(mask.sum()))
    else:
        mask[:] = False
    cd = rb.columns
    specs = [("sum", None, mask),
             ("sum", RI, mask & cd[RI].valid),
             ("min", RI, mask & cd[RI].valid),
             ("max", RI, mask & cd[RI].valid),
             ("min", RF, mask & cd[RF].valid & ~np.signbit(cd[RF].values)),
             ("max", RF, mask & cd[RF].valid),
             ("min", RS, mask & cd[RS].valid),
             ("cnt", 0, mask), ("sum", 0, mask),
             ("cnt", 1, mask), ("plane", 1, mask), ("pvalid", 1, mask),
             ("max", 2, mask)]
    return gid, specs, G


def test_region_agg_states_batched_matches_jax():
    """Ragged states over four regions (one with G_r = 0, one with no live
    row), bucketed segment offsets, sentinels for groups no row reaches,
    wrapping int64 sums, decimal / float / int argument planes and the
    row-space plane / pvalid readbacks."""
    from tidb_tpu_torch.copr.columnar_region import ArgPlaneSpec
    rbs, pbs = _regions(23)
    cases = [_states_case(rb, 100 + r) for r, rb in enumerate(rbs)]
    assert any(G == 0 for _g, _s, G in cases)
    ref_segs = []
    for rb, (gid, specs, G) in zip(rbs, cases):
        args = [_ref_argspec(a, rb) for a in ARGS]
        ref_segs.append((gid, [(op, _ref_val(op, key, rb, args), ok)
                               for op, key, ok in specs], G))
    want = rk.region_agg_states_batched(ref_segs)
    regions, progs = _port_regions(pbs, None, [carry.expr_from(a)
                                               for a in ARGS])
    bits, outs = pk.region_filter_batched(regions, "cpu")
    cpu = torch.device("cpu")
    port_segs, base = [], 0
    for pb, aps, (gid, specs, G) in zip(pbs, progs, cases):
        cap = pb.capacity
        args = [ArgPlaneSpec(ap, outs[j][0][base:base + cap],
                             outs[j][1][base:base + cap])
                for j, ap in enumerate(aps)]
        planes = pk.batch_planes(pb, cpu)
        port_segs.append((gid, [
            (op, _port_val(op, key, planes, args), ok)
            for op, key, ok in specs], G, pb.n_rows))
        base += cap
    got = pk.region_agg_states_batched(port_segs, "cpu")
    for r, (g_r, w_r) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(g_r, w_r)):
            w = np.asarray(w)
            assert g.shape == w.shape, (r, j)
            assert np.array_equal(g.astype(w.dtype), w), (r, j, g, w)


def _is_arg(op, key) -> bool:
    """Spec keys 0..2 of cnt/plane/pvalid and of the listed sum/max name
    an ARGS plane; other keys name a column."""
    return op in ("cnt", "plane", "pvalid") or (op, key) in (("sum", 0),
                                                             ("max", 2))


def _ref_val(op, key, rb, args):
    if key is None:
        return None
    return args[key] if _is_arg(op, key) else rb.columns[key].values


def _port_val(op, key, planes, args):
    if key is None:
        return None
    return args[key] if _is_arg(op, key) else planes[key][0]


def test_bucket_segments_matches_jax():
    for n in (0, 1, 7, 8, 9, 100, 2500, 1 << 20):
        assert pk.bucket_segments(n) == rk.bucket_segments(n)


@pytest.mark.parametrize("R,G", [(2, 1), (8, 4), (3, 70)])
def test_combine_region_partials_matches_jax(R, G):
    rng = np.random.default_rng(R * 100 + G)
    si = rng.integers(-1000, 1000, (R, G)).astype(np.int64)
    si[0, 0] = I64_MAX
    si[-1, 0] = I64_MAX            # wraps as jnp.sum does
    mi = rng.integers(I64_MIN, I64_MAX, (R, G), dtype=np.int64)
    mi[:, -1] = I64_MAX            # the sentinel of a group no region saw
    mf = rng.integers(-100, 100, (R, G)) * 0.5
    mf[0, :] = np.inf
    states = [si, mi, mi, mf, mf]
    ops = ["sum", "min", "max", "min", "max"]
    want = rk.combine_region_partials(states, ops)
    got = pk.combine_region_partials(states, ops, "cpu")
    for g, w, op in zip(got, want, ops):
        assert g.dtype == w.dtype and np.array_equal(g, w), op


def test_region_agg_states_matches_jax():
    """One region's states (the serial call, R = 1) with every op."""
    from tidb_tpu_torch.copr.columnar_region import ArgPlaneSpec
    rbs, pbs = _regions(31)
    rb, pb = rbs[1], pbs[1]
    gid, specs, G = _states_case(rb, 7)
    args = [_ref_argspec(a, rb) for a in ARGS]
    want = rk.region_agg_states(
        gid, [(op, _ref_val(op, key, rb, args), ok)
              for op, key, ok in specs], G)
    regions, progs = _port_regions([pb], None, [carry.expr_from(a)
                                                 for a in ARGS])
    _bits, outs = pk.region_filter_batched(regions, "cpu")
    pargs = [ArgPlaneSpec(ap, outs[j][0], outs[j][1])
             for j, ap in enumerate(progs[0])]
    planes = pk.batch_planes(pb, torch.device("cpu"))
    got = pk.region_agg_states(
        gid, [(op, _port_val(op, key, planes, pargs), ok)
              for op, key, ok in specs], G, pb.n_rows, "cpu")
    for j, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert np.array_equal(g.astype(w.dtype), w), (j, g, w)
