"""The plain versions of slice 3's kernels, fed the same numpy inputs as
the JAX package's functions:

- `_distinct_reduce` and `_grouped_distinct`, called on arrays, against
  the port's DISTINCT route (lexsort, K9's plain version, then K2's or
  K4's): int64 values with I64_MAX and f64 values with -0.0 and +0.0,
  and +inf in the scalar case (the reference's grouped sums are prefix-sum
  differences, which turn a group after an infinite value into NaN; SQL
  stores no infinite DOUBLE, so that case is left out);
- `build_ranked_group_fn` with where=None and count / sum / min / max /
  first_row specs against the port's (lexsort, K8's plain version, K4's
  pass in sorted space), over string, int, f64 and all-NULL columns;
- `build_topn_fn` / `build_topn_fn_multi` with `lambda planes:
  planes[cid]` as the key against the port's build_topn_fn (K10's plain
  version), on inputs that stay clear of the reference's recorded TopN
  faults (no int64 minimum under DESC, no BIGINT keys beyond 2^53, and
  dead rows only after every live row).

Tolerance: exact; f64 sums relative 1e-12 (the f64 values are multiples
of 0.25, so every sum is exact whatever the order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.proto import ByItem, SelectRequest, expr_agg, \
    expr_column as c, expr_value
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import kernels as rk
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry
from tidb_tpu_torch.copr.proto import expr_column as pc
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops.exprc import Program, compile_expr

from torch_parity import F64_RTOL, port_identity

I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
CAP, N = 1024, 900
S_STR, S_INT, S_F64, S_NULL, V_INT, V_F64, V_DEC = 1, 2, 3, 4, 5, 6, 7


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=F64_RTOL,
                                   atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=what)


# ---------------------------------------------------------------------------
# DISTINCT
# ---------------------------------------------------------------------------

def _distinct_inputs(seed: int, floats: bool, inf: bool = False):
    rng = np.random.default_rng(seed)
    n = 2000
    if floats:
        v = rng.integers(-8, 8, n) * 0.25
        v[::7] = -0.0
        v[::11] = 0.0
        if inf:
            v[::97] = np.inf
    else:
        v = rng.integers(-50, 50, n).astype(np.int64)
        v[::13] = I64_MAX
        v[::17] = I64_MIN + 1
    contrib = rng.random(n) < 0.7
    gid = rng.integers(0, 12, n).astype(np.int64)
    gid[~contrib & (rng.random(n) < 0.5)] = 12          # the sink
    return v, contrib, gid


def _port_distinct(v, contrib, gid, S, name):
    arg = types.SimpleNamespace(const=None, cid=1, reg=None,
                                dt="f" if v.dtype == np.float64 else "i")
    spec = pk.AggSpec(name, arg, True)
    planes = {1: (torch.from_numpy(v), torch.ones(len(v), dtype=torch.bool))}
    g = None if gid is None else torch.from_numpy(gid)
    return pk.distinct_totals(spec, planes, {}, torch.from_numpy(contrib), g,
                              S)


@pytest.mark.parametrize("floats", [False, True], ids=["int64", "f64"])
def test_distinct_reduce_matches_jax(floats):
    v, contrib, _gid = _distinct_inputs(3, floats, inf=True)
    cnt, vsum = jax.jit(rk._distinct_reduce)(jnp.asarray(v),
                                             jnp.asarray(contrib))
    n, s = _port_distinct(v, contrib, None, 0, "sum")
    n_only, _ = _port_distinct(v, contrib, None, 0, "count")
    _close(n, cnt, "distinct count")
    _close(n_only, cnt, "count(distinct)")
    _close(s, vsum, "distinct sum")
    # no contributing row
    none = np.zeros_like(contrib)
    cnt0, _s0 = jax.jit(rk._distinct_reduce)(jnp.asarray(v),
                                             jnp.asarray(none))
    n0, s0 = _port_distinct(v, none, None, 0, "sum")
    assert int(n0) == int(cnt0) == 0 and float(s0) == 0.0


@pytest.mark.parametrize("floats", [False, True], ids=["int64", "f64"])
def test_grouped_distinct_matches_jax(floats):
    v, contrib, gid = _distinct_inputs(4, floats)
    S = 13
    cnt, vsum = jax.jit(rk._grouped_distinct, static_argnums=3)(
        jnp.asarray(v), jnp.asarray(contrib), jnp.asarray(gid), S)
    n, s = _port_distinct(v, contrib, gid, S, "sum")
    _close(n, cnt, "grouped distinct count")
    _close(s, vsum, "grouped distinct sum")


# ---------------------------------------------------------------------------
# ranked group-by
# ---------------------------------------------------------------------------

def _ranked_batch(seed: int) -> rcol.ColumnBatch:
    rng = np.random.default_rng(seed)
    live = np.arange(CAP) < N

    def valid(p=0.1):
        return live & (rng.random(CAP) > p)

    sv = valid()
    fv = rng.integers(-3, 3, CAP) * 0.5
    fv[::5] = -0.0
    cols = {
        S_STR: rcol.ColumnData(rcol.K_STR, np.where(sv, rng.integers(
            0, 4, CAP), -1).astype(np.int64), sv, [b"a", b"b", b"c", b"d"],
            tp=rmy.TypeVarchar),
        S_INT: rcol.ColumnData(rcol.K_I64, rng.integers(-20, 20, CAP)
                               .astype(np.int64), valid(), tp=rmy.TypeLong,
                               max_abs=20),
        S_F64: rcol.ColumnData(rcol.K_F64, fv, valid(), tp=rmy.TypeDouble),
        S_NULL: rcol.ColumnData(rcol.K_I64, np.zeros(CAP, np.int64),
                                np.zeros(CAP, bool), tp=rmy.TypeLong),
        V_INT: rcol.ColumnData(rcol.K_I64, rng.integers(-1000, 1000, CAP)
                               .astype(np.int64), valid(),
                               tp=rmy.TypeLonglong, max_abs=1000),
        V_F64: rcol.ColumnData(rcol.K_F64, rng.integers(-400, 400, CAP)
                               * 0.25, valid(), tp=rmy.TypeDouble),
        V_DEC: rcol.ColumnData(rcol.K_DEC, rng.integers(-99999, 99999, CAP)
                               .astype(np.int64), valid(),
                               tp=rmy.TypeNewDecimal, dec_scale=2,
                               max_abs=99999),
    }
    return rcol.ColumnBatch(N, CAP, np.arange(CAP, dtype=np.int64), cols)


RANKED_CASES = {
    "string, int": [S_STR, S_INT],
    "f64 with -0.0": [S_F64],
    "int, f64, all-NULL": [S_INT, S_F64, S_NULL],
}


@pytest.mark.parametrize("case", sorted(RANKED_CASES))
def test_ranked_group_fn_matches_jax(case):
    cids = RANKED_CASES[case]
    rb = _ranked_batch(7)
    one = expr_value(RDatum.i64(1))
    req = SelectRequest(
        start_ts=1, group_by=[ByItem(c(cid)) for cid in cids],
        aggregates=[expr_agg("count", [one]), expr_agg("count", [c(V_INT)]),
                    expr_agg("sum", [c(V_INT)]), expr_agg("sum", [c(V_F64)]),
                    expr_agg("avg", [c(V_DEC)]), expr_agg("min", [c(V_F64)]),
                    expr_agg("max", [c(V_INT)]), expr_agg("min", [c(V_DEC)]),
                    expr_agg("first_row", [c(V_F64)]),
                    expr_agg("first_row", [c(cids[0])])])
    S = 1025
    # reference
    specs = rk.lower_aggregates(req, rb)
    kinds = [rb.columns[cid].kind for cid in cids]
    fn = rk.build_ranked_group_fn(None, specs, list(zip(cids, kinds)), S)
    planes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
              for cid, cd in rb.columns.items()}
    planes[rk.POS_CID] = (jnp.arange(CAP, dtype=jnp.int64), None)
    wrapper = rk.pack_outputs(fn)
    ref = port_identity(rk.unpack_outputs(wrapper, np.asarray(jax.jit(
        wrapper)(planes, jnp.asarray(rb.row_mask())))))
    # port
    pb = carry.batch_from(rb)
    preq = carry.request_from(req)
    prog = Program(pb)
    pspecs = pk.lower_aggregates(preq, pb, prog)
    pfn = pk.build_ranked_group_fn(prog, None, pspecs, cids)
    pplanes = pk.batch_planes(pb, torch.device("cpu"))
    plive = pk.device_live(pb, torch.device("cpu"))
    ngroups, got = pfn(pfn.prepare(pplanes, plive), pplanes, S)
    assert got is not None and ngroups == int(ref[0])
    assert ngroups > 1
    _close(got[1], ref[1], "row_count")
    for j in range(len(cids)):
        rep, nonnull = 2 + 2 * j, 3 + 2 * j
        _close(got[nonnull][:ngroups], ref[nonnull][:ngroups],
               f"non-null {j}")
        keep = np.asarray(ref[nonnull][:ngroups]).astype(bool)
        _close(got[rep][:ngroups][keep], ref[rep][:ngroups][keep],
               f"representative {j}")
    assert len(got) == len(ref)
    for i in range(2 + 2 * len(cids), len(ref)):
        _close(got[i], ref[i], f"output {i}")


# ---------------------------------------------------------------------------
# TopN
# ---------------------------------------------------------------------------

TOPN_CASES = {
    "int desc": [(S_INT, True)],
    "f64 asc": [(V_F64, False)],
    "string desc": [(S_STR, True)],
    "decimal asc": [(V_DEC, False)],
    "int desc, f64 asc": [(S_INT, True), (S_F64, False)],
    "string, int desc, decimal": [(S_STR, False), (S_INT, True),
                                  (V_DEC, False)],
    "f64 desc, string desc, int, f64": [(S_F64, True), (S_STR, True),
                                        (V_INT, False), (V_F64, False)],
}


@pytest.mark.parametrize("k", [1, 10, N])
@pytest.mark.parametrize("case", sorted(TOPN_CASES))
def test_topn_matches_jax(case, k):
    keys = TOPN_CASES[case]
    rb = _ranked_batch(11)
    planes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
              for cid, cd in rb.columns.items()}
    live = jnp.asarray(rb.row_mask())
    if len(keys) == 1:
        (cid, desc), = keys
        fn = rk.build_topn_fn(None, lambda p, cid=cid: p[cid], desc, k)
    else:
        fn = rk.build_topn_fn_multi(
            None, [(lambda p, cid=cid: p[cid], d) for cid, d in keys], k)
    idx, n_live = jax.jit(fn)(planes, live)
    want = np.asarray(idx)[:int(n_live)]
    pb = carry.batch_from(rb)
    prog = Program(pb)
    pkeys = [(compile_expr(pc(cid), pb, prog), d) for cid, d in keys]
    pfn = pk.build_topn_fn(prog, None, pkeys, k)
    gidx, gn = pfn(pk.batch_planes(pb, torch.device("cpu")),
                   pk.device_live(pb, torch.device("cpu")))
    assert int(gn[0]) == int(n_live) == min(k, N)
    np.testing.assert_array_equal(gidx.numpy()[:int(gn[0])], want)


def test_topn_raises_beyond_four_keys():
    pb = carry.batch_from(_ranked_batch(1))
    prog = Program(pb)
    keys = [(compile_expr(pc(cid), pb, prog), False)
            for cid in (S_STR, S_INT, S_F64, V_INT, V_F64)]
    with pytest.raises(pk.Unsupported):
        pk.build_topn_fn(prog, None, keys, 3)
