"""K5 expr_vm_ragged and K19 delta_merge_order after their redesign, on
the CPU.

K5's plain route (device "cpu") against the JAX package's
region_filter_batched (the survivor bits) and its arg-plane programs (the
argument planes) over 1, 8 and 64 regions whose programs, pools and string
LUTs differ, one region with no live row and NULLs in every WHERE column;
its table (kernels.k5_pack, pure Python) decoded by the layout
ops/csrc/expr_vm.cu reads: streams shared by equal programs, offsets, the
by-value or packed choice at the limit, and the kernel's tile-to-region
search against a brute-force map. K19's plain version and its merged
handle plane against the JAX delta_merge_order and torch.cat(...)[order]
on the shapes the kernel's tiles meet. The constants and C signatures the
wrappers mirror, against the sources.

Exact throughout: bits, valid planes, values where valid (f64 by their
bits), orders and handles.
"""

import os
import re

import numpy as np
import pytest
import torch

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.columnar_region import ArgPlaneSpec as RArg
from tidb_tpu.copr.proto import Expr as RExpr, ExprType as RExprType, \
    PBColumnInfo, expr_column as c, expr_op, expr_value
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import kernels as rk
from tidb_tpu.ops.exprc import compile_arg_plane as rcap, \
    compile_expr as rcompile
from tidb_tpu.sqlast.opcode import Op
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry, errors
from tidb_tpu_torch.copr import delta
from tidb_tpu_torch.ops import _ext, kernels as pk
from tidb_tpu_torch.ops import columnar as pcol
from tidb_tpu_torch.ops.exprc import Program, compile_arg_plane, \
    compile_expr

CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
RS, RI, RF, RD = 1, 2, 3, 4     # string, int, double, decimal columns
CPU = torch.device("cpu")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src: str, name: str) -> str:
    return re.search(r"#define %s (.+?)(?:\s*//.*)?$" % name, src,
                     re.M).group(1).strip()


# ---------------------------------------------------------------------------
# K5: regions of their own dictionaries and programs
# ---------------------------------------------------------------------------

WORDS = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"SHIP", b"TRUCK", b"xyz"]


def _batch(cap: int, n: int, seed: int) -> rcol.ColumnBatch:
    rng = np.random.default_rng(seed)
    live = np.arange(cap) < n
    words = sorted(set(rng.choice(WORDS, 4).tolist()))
    sv = live & (rng.random(cap) > 0.15)
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
                            live & (rng.random(cap) > 0.15),
                            tp=rmy.TypeLonglong, max_abs=I64_MAX),
        RF: rcol.ColumnData(rcol.K_F64, vf, live & (rng.random(cap) > 0.15),
                            tp=rmy.TypeDouble),
        RD: rcol.ColumnData(rcol.K_DEC, rng.integers(-9999, 9999, cap)
                            .astype(np.int64), live & (rng.random(cap) > 0.15),
                            tp=rmy.TypeNewDecimal, dec_scale=2, max_abs=9999),
    }
    return rcol.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), cols)


_S = lambda s: expr_value(RDatum.string(s))  # noqa: E731
_I = lambda v: expr_value(RDatum.i64(v))  # noqa: E731


def _like(target, pattern: str):
    return RExpr(RExprType.LIKE, val="\\", children=[target, _S(pattern)])


# three WHERE shapes, taken by region in turn: a string equality (a code
# constant in the pool, each dictionary its own), a general LIKE (a LUT
# over each dictionary) and NULL tests over a decimal range
WHERES = [
    expr_op(Op.OrOr, expr_op(Op.AndAnd, expr_op(Op.GT, c(RI), _I(5)),
                             expr_op(Op.EQ, c(RS), _S("MAIL"))),
            expr_op(Op.LT, c(RF), expr_value(RDatum.f64(0.5)))),
    expr_op(Op.OrOr, _like(c(RS), "%AI%"), expr_op(Op.LT, c(RI), _I(0))),
    expr_op(Op.OrOr, RExpr(RExprType.IS_NULL, children=[c(RI)]),
            expr_op(Op.GE, c(RD), expr_value(RDatum.dec("1.25")))),
]
ARGS = [expr_op(Op.Mul, c(RD), expr_op(Op.Minus, _I(1), c(RD))),
        expr_op(Op.Plus, c(RF), expr_value(RDatum.dec("0.5")))]


def _pbcol(cid):
    tp = {RS: rmy.TypeVarchar, RI: rmy.TypeLonglong, RF: rmy.TypeDouble,
          RD: rmy.TypeNewDecimal}[cid]
    return PBColumnInfo(column_id=cid, tp=tp, decimal=2 if cid == RD else -1)


def _shapes(R: int, seed: int) -> list:
    """(capacity, live rows) of R regions: capacities 1024 and 2048 (1024
    only past 8 regions), live rows not a multiple of 32, region 2 none."""
    rng = np.random.default_rng(seed)
    caps = (1024, 2048) if R <= 8 else (1024,)
    out = []
    for r in range(R):
        cap = caps[r % len(caps)]
        out.append((cap, 0 if r == 2 else int(rng.integers(1, cap + 1)) | 1))
    return out


def _k5_case(R: int, seed: int):
    """The reference's batches and WHERE / arguments per region, and the
    port's RegionPrograms of the same."""
    rbs = [_batch(cap, n, seed + r)
           for r, (cap, n) in enumerate(_shapes(R, seed))]
    regions = []
    for r, rb in enumerate(rbs):
        pb = carry.batch_from(rb)
        prog = Program(pb)
        where = compile_expr(carry.expr_from(WHERES[r % 3]), pb, prog)
        colpb = {cid: carry.column_info_from(_pbcol(cid))
                 for cid in pb.columns}
        aps = [compile_arg_plane(carry.expr_from(a), pb, colpb, prog)
               for a in ARGS]
        fin = prog.finalize(where, [a.compiled for a in aps])
        planes = pk.batch_planes(pb, CPU)
        regions.append(pk.RegionProgram(
            fin, [planes[k][w] for k, w in fin.plane_keys], pb.capacity,
            pb.n_rows))
    return rbs, regions


@pytest.mark.parametrize("R", [1, 8, 64])
def test_k5_plain_matches_jax(R):
    rbs, regions = _k5_case(R, 100 + R)
    segs = []
    for r, rb in enumerate(rbs):
        segs.append(((R, r), rcompile(WHERES[r % 3], rb),
                     {cid: (rb.columns[cid].values, rb.columns[cid].valid)
                      for cid in (RS, RI, RF, RD)}, rb.capacity, rb.n_rows,
                     ()))
    want = rk.region_filter_batched(segs)
    bits, outs = pk.region_filter_batched(regions, "cpu")
    assert np.array_equal(bits.numpy(), np.concatenate(
        [np.packbits(w, bitorder="little") for w in want]))
    assert not want[2].any() if R > 2 else True
    base = 0
    for rb in rbs:
        colpb = {cid: _pbcol(cid) for cid in rb.columns}
        for j, a in enumerate(ARGS):
            wv, wok = RArg(rcap(a, rb, colpb), rb).host_eval()
            gv, gok = (t[base:base + rb.capacity].numpy() for t in outs[j])
            assert np.array_equal(gok, wok), (R, j)
            assert np.array_equal(gv[wok].view(np.int64),
                                  np.asarray(wv)[wok].view(np.int64)), (R, j)
        base += rb.capacity
    # one program stream of K5's table for each distinct program: the
    # three WHERE shapes, and more where a dictionary lacks 'MAIL'
    words, _n = pk.k5_pack(regions, [0] * 4)
    assert words[1] == len({pk._k5_stream(rp.fin)[0] for rp in regions}) \
        >= min(R, 3)


# ---------------------------------------------------------------------------
# K5's table: the layout expr_vm.cu reads
# ---------------------------------------------------------------------------

def _decode(words) -> dict:
    """K5's table as the kernel reads it (expr_vm.cu k5_run)."""
    w = list(words)
    R, S, n_out, n_tiles, n_regs = w[:5]
    o_tile, o_reg, o_str, o_outs, o_pl, o_pool, o_lut = w[5:12]
    raw = np.asarray(w, np.int64).tobytes()
    regions = []
    for r in range(R):
        base, n_rows, s, pl, po, lu = w[o_reg + 6 * r:o_reg + 6 * r + 6]
        st = w[o_str + (3 + n_out) * s:o_str + (3 + n_out) * (s + 1)]
        regions.append(dict(
            base=base, n_rows=n_rows, stream=s, ins=w[st[0]:st[0] + 6 * st[1]],
            where=st[2], outs=st[3:], planes=w[o_pl + pl:],
            pool=w[o_pool + po:], lut=raw[8 * o_lut + lu:]))
    return dict(R=R, streams=S, n_out=n_out, n_tiles=n_tiles, n_regs=n_regs,
                tile0=w[o_tile:o_tile + R + 1], outs=w[o_outs:o_outs + 2 *
                                                      n_out],
                regions=regions)


def _tile_region(tile0: list, tile: int) -> int:
    """The kernel's search: the last region whose first tile is at or
    before `tile`."""
    lo, hi = 0, len(tile0) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if tile0[mid] <= tile:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("R", [1, 8, 64])
def test_k5_table_layout(R):
    _rbs, regions = _k5_case(R, 300 + R)
    out_ptrs = list(range(1000, 1004))
    words, n_regs = pk.k5_pack(regions, out_ptrs)
    t = _decode(words)
    assert (t["R"], t["n_out"], t["outs"]) == (R, 2, out_ptrs)
    assert t["n_tiles"] == sum(rp.cap for rp in regions) // pk.K5_TILE
    assert t["n_regs"] == n_regs <= 16
    base = 0
    for rp, d in zip(regions, t["regions"]):
        meta = rp.fin.meta
        n = int(meta[0])
        assert d["ins"] == meta[8:8 + 6 * n].tolist()
        assert d["where"] == int(meta[1])
        assert d["outs"] == meta[8 + 6 * n:8 + 6 * n + 2].tolist()
        assert (d["base"], d["n_rows"]) == (base, rp.n_rows)
        np_ = len(rp.planes)
        assert d["planes"][:np_] == [p.data_ptr() for p in rp.planes]
        assert d["pool"][:len(rp.fin.pool)] == rp.fin.pool.tolist()
        assert d["lut"][:len(rp.fin.lut)] == rp.fin.lut.tobytes()
        assert n_regs > max(d["ins"][1::6] + d["outs"] + [d["where"]])
        base += rp.cap
    # regions of equal programs share one stream, distinct ones do not
    keys = [pk._k5_stream(rp.fin)[0] for rp in regions]
    for a, da in zip(keys, t["regions"]):
        for b, db in zip(keys, t["regions"]):
            assert (a == b) == (da["stream"] == db["stream"])
    # every tile's region by the kernel's search and by brute force
    owner = [r for r, rp in enumerate(regions)
             for _ in range(rp.cap // pk.K5_TILE)]
    assert t["tile0"][-1] == len(owner)
    assert [_tile_region(t["tile0"], k) for k in range(len(owner))] == owner


def test_k5_route_at_the_limit():
    assert pk.k5_route(1) == pk.k5_route(pk.K5_SMALL_WORDS) == \
        pk.k5_route(pk.K5_PARAM_WORDS) == "expr_vm_ragged"
    assert pk.k5_route(pk.K5_PARAM_WORDS + 1) == "expr_vm_ragged_packed"
    assert set(pk.K5_ROUTES) <= set(pk.LAUNCHES)
    # 64 regions' table rides by value; many more regions do not
    _rbs, regions = _k5_case(64, 7)
    words, _n = pk.k5_pack(regions, [0] * 4)
    assert pk.k5_route(len(words)) == "expr_vm_ragged"
    many = regions * 12
    words, _n = pk.k5_pack(many, [0] * 4)
    assert len(words) > pk.K5_PARAM_WORDS
    assert pk.k5_route(len(words)) == "expr_vm_ragged_packed"
    assert words[1] == len({pk._k5_stream(rp.fin)[0] for rp in regions})
    # the plain route holds for the packed case's regions as for any
    bits, outs = pk.expr_vm_ragged(many, "cpu")
    b1, o1 = pk.expr_vm_ragged(regions, "cpu")
    assert torch.equal(bits, b1.repeat(12))


def test_k5_checks_before_any_launch():
    _rbs, regions = _k5_case(1, 5)
    rp = regions[0]
    bad = pk.RegionProgram(rp.fin, rp.planes, rp.cap + 512, rp.n_rows)
    with pytest.raises(errors.DeviceError):
        pk.k5_prepare([bad], CPU)
    short = pk.RegionProgram(rp.fin, [p[:512] for p in rp.planes], rp.cap,
                             rp.n_rows)
    with pytest.raises(errors.DeviceError):
        pk.k5_prepare([short], CPU)


# ---------------------------------------------------------------------------
# K19: the merge order and the merged handle plane
# ---------------------------------------------------------------------------

def _k19_case(kind: str, seed: int):
    """(handles [cap], live, tomb, app) of one merge shape."""
    rng = np.random.default_rng(seed)
    cap, n = 8192, 6000
    h = np.full(cap, I64_MIN, np.int64)
    base = np.sort(rng.choice(np.arange(1, 10 ** 6), n, replace=False)) * 4
    h[:n] = base
    live = np.arange(cap) < n
    tomb = np.sort(rng.choice(base, 700, replace=False))
    app = np.sort(rng.choice(np.arange(1, 10 ** 6), 900, replace=False) * 4
                  + 1)
    if kind == "no_base":
        h, live = np.zeros(0, np.int64), np.zeros(0, bool)
    elif kind == "k0":
        app = app[:0]
    elif kind == "m0":
        tomb = tomb[:0]
    elif kind == "all_tombstoned":
        tomb = base.copy()
    elif kind == "app_equal_kept":
        app = np.sort(rng.choice(np.setdiff1d(base, tomb), 900))
    elif kind == "app_below":
        app = np.arange(-900, 0, dtype=np.int64)
    elif kind == "app_above":
        app = base.max() + 1 + np.arange(900, dtype=np.int64)
    elif kind == "live_no_prefix":
        live = rng.random(cap) < 0.5
        live[2048:4096] = False             # a whole tile without a live row
        h = np.where(np.arange(cap) < n, h, np.arange(cap) * 4 + 10 ** 7)
    return h, live, tomb.astype(np.int64), app.astype(np.int64)


K19_KINDS = ["mixed", "no_base", "k0", "m0", "all_tombstoned",
             "app_equal_kept", "app_below", "app_above", "live_no_prefix"]


@pytest.mark.parametrize("kind", K19_KINDS)
def test_k19_plain_and_merged_plane_match_jax(kind):
    h, live, tomb, app = _k19_case(kind, K19_KINDS.index(kind))
    want = rk.delta_merge_order(h, live, tomb, app)
    th, tl, tt, ta = (torch.from_numpy(x) for x in (h, live, tomb, app))
    merged = torch.full((len(want) + 9,), I64_MIN, dtype=torch.int64)
    order = pk.delta_merge_order(th, tl, tt, ta, merged)
    assert np.array_equal(order.numpy(), want)
    assert torch.equal(merged[:len(want)], torch.cat([th, ta])[order])
    assert torch.equal(merged[len(want):],
                       torch.full((9,), I64_MIN, dtype=torch.int64))
    assert torch.equal(pk.delta_merge_handles_plain(th, ta, order),
                       torch.cat([th, ta])[order])
    # the merge: handles ascend, a base row before an appended row of the
    # same handle
    hs = merged[:len(want)].numpy()
    assert np.all(np.diff(hs) >= 0)
    ties = (np.diff(hs) == 0)
    assert not np.any(ties & (want[:-1] >= len(h)) & (want[1:] < len(h)))
    with pytest.raises(errors.DeviceError):
        pk.delta_merge_order(th, tl, tt, ta,
                             torch.empty(max(len(want) - 1, 0),
                                         dtype=torch.int64))


def test_merge_order_keeps_the_merged_plane_bucketed(monkeypatch):
    """The merge path's merged handle plane comes from K19 (its plain
    version on the CPU): the merged batch's bucketed capacity, I64_MIN
    past its rows, also where tombstones shrink the merge below the
    bucket of the base's rows plus the appended ones."""
    monkeypatch.setattr(delta, "MERGE_DEVICE_FLOOR", 0)
    rng = np.random.default_rng(3)
    for n_tomb, k in ((100, 50), (2600, 40)):
        cap, n = 8192, 5000
        handles = np.full(cap, I64_MIN, np.int64)
        handles[:n] = np.sort(rng.choice(10 ** 6, n, replace=False)) * 2
        base = pcol.ColumnBatch(n, cap, handles, {})
        tomb = np.sort(rng.choice(handles[:n], n_tomb, replace=False))
        app = np.sort(rng.choice(10 ** 6, k, replace=False) * 2 + 1)
        order, merged = delta._merge_order(base, tomb, app, CPU)
        want = rk.delta_merge_order(handles, base.row_mask(), tomb, app)
        assert np.array_equal(order, want)
        rows = len(want)
        assert merged.shape[0] == pcol.bucket_capacity(rows)
        assert merged.untyped_storage().nbytes() == 8 * merged.shape[0]
        assert np.array_equal(merged[:rows].numpy(),
                              np.concatenate([handles, app])[want])
        assert bool((merged[rows:] == I64_MIN).all())


# ---------------------------------------------------------------------------
# the constants and signatures the wrappers mirror
# ---------------------------------------------------------------------------

def test_k5_k19_constants_match_the_sources():
    k5 = _source("expr_vm.cu")
    for name in ("K5_TILE", "K5_THREADS", "K5_HDR", "K5_REGION", "K5_STREAM",
                 "K5_SMALL_WORDS", "K5_PARAM_WORDS"):
        assert int(_define(k5, name)) == getattr(pk, name), name
    assert "VmSmemRegs regs" in k5 and "__grid_constant__ K5Params" in k5
    for gone in ("tile_region", "tile_first", "sm[K1_MAX_META]", "s_ins"):
        assert gone not in k5[k5.index("#define K5_TILE"):], gone
    k19 = _source("delta_merge.cu")
    flags = {int(_define(k19, n)): n for n in (
        "K19_BAD_BASE", "K19_BAD_TOMB", "K19_BAD_APP", "K19_BAD_SENTINEL")}
    assert sorted(flags) == sorted(pk.K19_BROKEN) == [1, 2, 4, 8]
    assert int(_define(k19, "K19_BAD")) == 15
    assert "<<<" in k19 and k19.count("<<<") == 1      # one launch a call
    for gone in ("k19_mask", "k19_totals", "k19_scatter", "cudaMemcpy"):
        assert gone not in k19, gone
    # the shared-memory opt-in once per process and device, not a call
    assert k19.count("cudaFuncSetAttribute") == 1 and "static bool ready" in k19
    assert '#include "lookback.cuh"' in k19
    assert '#include "lookback.cuh"' in _source("window_scan.cu")


@pytest.mark.parametrize("name,fn", [
    ("expr_vm", "expr_vm_ragged_launch"), ("expr_vm", "expr_vm_ragged_tile"),
    ("delta_merge", "delta_merge_launch"),
    ("delta_merge", "delta_merge_tiles"),
    ("delta_merge", "delta_merge_workspace_bytes")])
def test_k5_k19_signatures_match_the_sources(name, fn):
    src = _source(name + ".cu")
    params = re.search(r'extern "C" \w+ %s\((.*?)\)\s*\{' % fn, src,
                       re.S).group(1)
    argtypes, _rt = _ext.SIGNATURES[name][fn]
    assert len(argtypes) == len([p for p in params.split(",") if p.strip()])
    assert set(_ext.SIGNATURES[name]) == set(
        re.findall(r'extern "C" \w+ (\w+)\(', src))


def test_variants_script_imports_no_jax():
    """k5_k19_variants.py runs on the card beside chip_smoke.py: it
    imports nothing of JAX or of the JAX package."""
    import ast
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "k5_k19_variants.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert names and not any(n == "jax" or n.startswith(("jax.", "tidb_tpu."))
                             or n == "tidb_tpu" for n in names), names
