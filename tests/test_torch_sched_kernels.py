"""The plain versions of the tier's kernels (K14 slot_filter, K15
slot_agg, K16 slot_topn) against the JAX package's slot programs, fed the
same numpy batch and the same literals:

- the filter wrapper of MicroBatcher._kernel (tidb_tpu/ops/sched.py:1021),
  jitted on the CPU: its packed words equal K14's plain version's word for
  word, and _unpack_mask_words reads the same masks from both (bit r % 64
  of word r / 64, bit 63 the sign bit);
- _build_agg_wrapper (:439): per slot the where-pass count, each
  aggregate's contributing count and its sum / min / max (the sentinels
  where nothing contributes), decoded with MicroBatcher._decode_slot;
- _build_topn_wrapper (:532): per slot the first k rows and the live
  count, on keys clear of the reference's DESC fault (no int64 minimum
  under DESC), which is pinned apart against numpy's order.

The batch: an int64 column with NULLs and +-(2^63 - 1), an f64 column
with NULLs, -0.0 and +0.0, a DECIMAL(8,2), a dictionary string and a DATE
column; live rows that are no multiple of 64. The literals are drawn from
a seed; some slots keep no row, and each case runs at 1 and at several
slots. Tolerance: exact.
"""

from __future__ import annotations

import types
from decimal import Decimal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.proto import (Expr, ExprType, PBColumnInfo,
                                 PBTableInfo, SelectRequest, expr_agg,
                                 expr_column as c, expr_op, expr_value)
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import sched as rsched
from tidb_tpu.sqlast.opcode import Op
from tidb_tpu.types import Datum as RDatum
from tidb_tpu.types.time_types import parse_time as rparse_time

from tidb_tpu_torch import carry
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops import sched as psched

from torch_parity import port_identity  # one torch thread, the GC frozen

I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
CAP, N = 2048, 2048 - 101
A, F, D, S, T = 1, 2, 3, 4, 5
WORDS = [b"ant", b"bee", b"cat", b"dog", b"eel"]
CPU = torch.device("cpu")
# one reference batcher: its compile cache holds one filter program per
# (signature, slot bucket, capacity), shared by the cases below
_RMB = rsched.MicroBatcher()


def _batch(seed: int, int_min: bool = False) -> rcol.ColumnBatch:
    rng = np.random.default_rng(seed)
    live = np.arange(CAP) < N

    def valid(p=0.12):
        return live & (rng.random(CAP) > p)

    a = rng.integers(-60, 60, CAP).astype(np.int64)
    a[::19] = I64_MAX
    a[::23] = -I64_MAX
    if int_min:
        a[::29] = I64_MIN
    f = rng.integers(-8, 8, CAP) * 0.5
    f[::6] = -0.0
    sv = valid()
    days = rng.integers(0, 2000, CAP)
    dates = np.array([rparse_time(str(np.datetime64("1992-01-01")
                                      + np.timedelta64(int(x), "D")))
                      .to_packed_int() for x in days], dtype=np.int64)
    cols = {
        A: rcol.ColumnData(rcol.K_I64, a, valid(), tp=rmy.TypeLonglong,
                           max_abs=I64_MAX if not int_min else 1 << 63),
        F: rcol.ColumnData(rcol.K_F64, f, valid(), tp=rmy.TypeDouble),
        D: rcol.ColumnData(rcol.K_DEC, rng.integers(-99999, 99999, CAP)
                           .astype(np.int64), valid(),
                           tp=rmy.TypeNewDecimal, dec_scale=2,
                           max_abs=99999),
        S: rcol.ColumnData(rcol.K_STR, np.where(sv, rng.integers(
            0, len(WORDS), CAP), -1).astype(np.int64), sv, list(WORDS),
            tp=rmy.TypeVarchar),
        T: rcol.ColumnData(rcol.K_I64, dates, valid(), tp=rmy.TypeDate,
                           max_abs=int(np.abs(dates).max())),
    }
    return rcol.ColumnBatch(N, CAP, np.arange(1, CAP + 1, dtype=np.int64),
                            cols)


_TI = PBTableInfo(7, [
    PBColumnInfo(column_id=A, tp=rmy.TypeLonglong, flen=20),
    PBColumnInfo(column_id=F, tp=rmy.TypeDouble, flen=22),
    PBColumnInfo(column_id=D, tp=rmy.TypeNewDecimal, flen=8, decimal=2),
    PBColumnInfo(column_id=S, tp=rmy.TypeVarchar, flen=8),
    PBColumnInfo(column_id=T, tp=rmy.TypeDate, flen=10)])


def _i(v):
    return expr_value(RDatum.i64(v))


# WHERE shapes: fn(literal seed) → reference Expr
WHERES = {
    "a < x": lambda x: expr_op(Op.LT, c(A), _i(x % 70 - 35)),
    "x >= a (flipped)": lambda x: expr_op(Op.GE, _i(x % 50 - 25), c(A)),
    "f > float": lambda x: expr_op(Op.GT, c(F), expr_value(
        RDatum.f64((x % 9 - 4) / 2))),
    "f <= int": lambda x: expr_op(Op.LE, c(F), _i(x % 5 - 2)),
    "d >= decimal": lambda x: expr_op(Op.GE, c(D), expr_value(
        RDatum.dec(Decimal(x % 2000 - 1000) / 10))),
    "d = int": lambda x: expr_op(Op.EQ, c(D), _i(x % 3 - 1)),
    "d < f64 literal": lambda x: expr_op(Op.LT, c(D), expr_value(
        RDatum.f64(x * 3.7 - 100))),
    "s = word (absent too)": lambda x: expr_op(Op.EQ, c(S), expr_value(
        RDatum.bytes_([b"bee", b"cow", b"eel", b"ant"][x % 4]))),
    "s < word": lambda x: expr_op(Op.LT, c(S), expr_value(
        RDatum.bytes_([b"b", b"cat", b"zz"][x % 3]))),
    "s >= word": lambda x: expr_op(Op.GE, c(S), expr_value(
        RDatum.bytes_([b"bee", b"c", b"a"][x % 3]))),
    "t <= date string": lambda x: expr_op(Op.LE, c(T), expr_value(
        RDatum.string(f"199{2 + x % 6}-0{1 + x % 9}-11"))),
    "a is null or not f = x": lambda x: expr_op(
        Op.OrOr, _isnull(A),
        expr_op(Op.Not, expr_op(Op.EQ, c(F), _i(x % 3)))),
    "a between x and x (xor d)": lambda x: expr_op(
        Op.Xor, expr_op(Op.AndAnd, expr_op(Op.GE, c(A), _i(x % 9)),
                        expr_op(Op.LE, c(A), _i(x % 9))),
        expr_op(Op.GT, c(D), _i(0))),
    "a = NULL": lambda x: expr_op(Op.EQ, c(A), expr_value(RDatum.null())),
}


def _isnull(cid):
    return Expr(ExprType.IS_NULL, children=[c(cid)])


def _sel(where, aggs=()) -> SelectRequest:
    return SelectRequest(start_ts=1, table_info=_TI, where=where,
                         aggregates=list(aggs))


def _ref_slots(rb, wheres):
    """(root fn, sig, pi [k, n_i], pf [k, n_f]) of the reference's
    lowering of each statement."""
    fn, sig, pis, pfs = None, None, [], []
    for w in wheres:
        lw = rsched._Lowerer(rb)
        f, s = lw.lower(w)
        assert sig is None or s == sig
        fn, sig = f, s
        pis.append(np.asarray(lw.pi, dtype=np.int64))
        pfs.append(np.asarray(lw.pf, dtype=np.float64))
    return fn, sig, np.stack(pis), np.stack(pfs)


def _port_slots(pb, wheres):
    """(program, pools [k, P]) of the port's lowering of each statement."""
    fin, pools = None, []
    for w in wheres:
        lw = psched._Lowerer(pb)
        emit, _sig = lw.lower(carry.expr_from(w))
        f = lw.program(pb, emit)
        assert fin is None or np.array_equal(f.meta, fin.meta)
        fin = f
        pools.append(f.pool)
    return fin, torch.from_numpy(np.stack(pools))


def _jax_planes(rb):
    return ({cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
             for cid, cd in rb.columns.items()},
            jnp.asarray(rb.row_mask()))


def _port_planes(pb, fin):
    planes = pk.batch_planes(pb, CPU)
    return (planes, [planes[key][w] for key, w in fin.plane_keys],
            pk.device_live(pb, CPU))


def _cases(k: int, seed: int) -> list:
    return [seed * 131 + 7 * j for j in range(k)]


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("shape", sorted(WHERES))
def test_slot_filter_matches_jax_filter_wrapper(shape, k):
    rb = _batch(11)
    pb = carry.batch_from(rb)
    wheres = [WHERES[shape](x) for x in _cases(k, 3)]
    fn, sig, pi, pf = _ref_slots(rb, wheres)
    kb = 8
    pi = np.concatenate([pi, np.repeat(pi[-1:], kb - k, 0)])
    pf = np.concatenate([pf, np.repeat(pf[-1:], kb - k, 0)])
    proto = types.SimpleNamespace(sig=(sig, None, None, 0, 0), fn=fn,
                                  aggs=None, topn=None, batch=rb)
    jitted, _kst = _RMB._kernel(None, proto, kb)
    planes, live = _jax_planes(rb)
    words = np.asarray(jitted(planes, live, jnp.asarray(pi),
                              jnp.asarray(pf))).reshape(kb, CAP // 64)[:k]
    fin, pools = _port_slots(pb, wheres)
    _pp, plist, plive = _port_planes(pb, fin)
    got = pk.slot_filter_plain(fin, pools, plist, plive)
    np.testing.assert_array_equal(got.numpy(), words)
    want_masks = rsched._unpack_mask_words(words.reshape(-1), k, CAP)
    np.testing.assert_array_equal(pk.unpack_slot_words(got).numpy(),
                                  want_masks)
    # the wrapper dispatches to the plain version for CPU tensors
    assert torch.equal(pk.slot_filter(fin, pools, plist, plive), got)


AGG_SETS = {
    "ints and decimals": [("count", None), ("count", A), ("sum", D),
                          ("min", A), ("max", A), ("min", D), ("avg", D)],
    "f64 extrema and strings": [("min", F), ("max", F), ("count", F),
                                ("max", S), ("min", S), ("min", T)],
}


def _agg_sel(where, names):
    one = expr_value(RDatum.i64(1))
    return _sel(where, [expr_agg(n, [one] if cid is None else [c(cid)])
                        for n, cid in names])


@pytest.mark.parametrize("aggs", sorted(AGG_SETS))
@pytest.mark.parametrize("shape", ["a < x", "s = word (absent too)",
                                   "a = NULL"])
def test_slot_agg_matches_jax_agg_wrapper(shape, aggs):
    rb = _batch(12)
    # no -0.0 in the f64 plane: the lowering refuses an f64 MIN/MAX over it
    rb.columns[F].values[rb.columns[F].values == 0.0] = 0.0
    pb = carry.batch_from(rb)
    k, kb = 6, 8
    sels = [_agg_sel(WHERES[shape](x), AGG_SETS[aggs])
            for x in _cases(k, 4)]
    ref_aggs = rsched._lower_slot_aggs(sels[0], rb)
    port_aggs = psched._lower_slot_aggs(carry.request_from(sels[0]), pb)
    if aggs == "f64 extrema and strings":
        # min over a DATE: the row handler answers (both refuse)
        assert ref_aggs is None and port_aggs is None
        sels = [_agg_sel(s.where, AGG_SETS[aggs][:-1]) for s in sels]
        ref_aggs = rsched._lower_slot_aggs(sels[0], rb)
        port_aggs = psched._lower_slot_aggs(carry.request_from(sels[0]),
                                            pb)
    fn, _sig, pi, pf = _ref_slots(rb, [s.where for s in sels])
    pi = np.concatenate([pi, np.repeat(pi[-1:], kb - k, 0)])
    pf = np.concatenate([pf, np.repeat(pf[-1:], kb - k, 0)])
    wrapper = jax.jit(rsched._build_agg_wrapper(fn, ref_aggs))
    planes, live = _jax_planes(rb)
    L = rsched.MicroBatcher._slot_layout(ref_aggs)
    block = np.asarray(wrapper(planes, live, jnp.asarray(pi),
                               jnp.asarray(pf))).reshape(kb, L)
    fin, pools = _port_slots(pb, [s.where for s in sels])
    pplanes, plist, plive = _port_planes(pb, fin)
    reds = [pk.Red(pk.R_COUNT, const_bits=1)] + [a.red(pplanes)
                                                 for a in port_aggs]
    n, acc = pk.slot_agg_plain(fin, pools, plist, plive, reds)
    for j in range(k):
        n_pass, outs = rsched.MicroBatcher._decode_slot(ref_aggs, block[j])
        assert int(n[j, 0]) == n_pass
        for i, (a, (cnt, v)) in enumerate(zip(port_aggs, outs), start=1):
            assert int(n[j, i]) == cnt, (a.name, j)
            if a.op == "count":
                continue
            got = int(acc[j, i])
            if a.kind == psched.col.K_F64:
                got = float(np.int64(got).view(np.float64))
                v = float(port_identity(np.float64(v)))
            assert got == v, (a.name, a.cid, j, got, v)
    if shape == "a = NULL":
        assert not n[:, 0].any()        # every slot empty


TOPN_KEYS = {
    "a desc, id": [(A, True), (T, False)],
    "f (-0.0), s desc": [(F, False), (S, True)],
    "s, d desc, a": [(S, False), (D, True), (A, False)],
    "d desc": [(D, True)],
}


def _numpy_topn(rb, mask, keys, k):
    """The SQL order from numpy: live first, per key its null rank (first
    ascending, last descending) then its value (-0.0 == +0.0), row
    position last."""
    sk = [np.arange(CAP)]
    for cid, desc in reversed(keys):
        cd = rb.columns[cid]
        v = cd.values.astype(np.float64) if cd.kind == rcol.K_F64 \
            else cd.values.astype(object)
        v = np.where(cd.valid, v, 0)
        if cd.kind == rcol.K_F64:
            v = np.where(v == 0.0, 0.0, v)
            v = -v if desc else v
        else:
            v = np.array([-x if desc else x for x in v.tolist()],
                         dtype=object)
        sk.append(np.unique(v, return_inverse=True)[1].reshape(-1))
        sk.append(cd.valid if not desc else ~cd.valid)
    sk.append(~mask)
    order = np.lexsort(sk)
    return order[:min(k, int(mask.sum()))]


@pytest.mark.parametrize("k", [3, 128])
@pytest.mark.parametrize("keys", sorted(TOPN_KEYS))
def test_slot_topn_matches_jax_topn_wrapper(keys, k):
    rb = _batch(13)
    pb = carry.batch_from(rb)
    n_slots, kb = 5, 8
    key_spec = TOPN_KEYS[keys]
    # slot 4 keeps fewer rows than k = 128 (the -(2^63 - 1) rows), slot 5
    # none
    wheres = [WHERES["a < x"](x) for x in _cases(n_slots - 2, 5)] + [
        expr_op(Op.LT, c(A), _i(-100)), expr_op(Op.LT, c(A), _i(-I64_MAX))]
    fn, _sig, pi, pf = _ref_slots(rb, wheres)
    pi = np.concatenate([pi, np.repeat(pi[-1:], kb - n_slots, 0)])
    pf = np.concatenate([pf, np.repeat(pf[-1:], kb - n_slots, 0)])
    kinds = {A: rcol.K_I64, F: rcol.K_F64, D: rcol.K_DEC, S: rcol.K_STR,
             T: rcol.K_I64}
    rkeys = tuple((cid, desc, kinds[cid]) for cid, desc in key_spec)
    wrapper = jax.jit(rsched._build_topn_wrapper(fn, rkeys, k))
    planes, live = _jax_planes(rb)
    block = np.asarray(wrapper(planes, live, jnp.asarray(pi),
                               jnp.asarray(pf))).reshape(kb, k + 1)
    fin, pools = _port_slots(pb, wheres)
    pplanes, plist, plive = _port_planes(pb, fin)
    words = pk.slot_filter_plain(fin, pools, plist, plive)
    idx, n_live = pk.slot_topn_plain(
        words, [(pplanes[cid], desc) for cid, desc in key_spec], k)
    masks = pk.unpack_slot_words(words).numpy()
    for j in range(n_slots):
        nl = int(block[j, k])
        assert int(n_live[j]) == nl
        got = idx[j, :nl].numpy()
        np.testing.assert_array_equal(got, block[j, :nl].astype(np.int64))
        np.testing.assert_array_equal(got, _numpy_topn(rb, masks[j],
                                                       key_spec, k))


def test_slot_topn_int64_min_under_desc_fault_of_the_reference():
    """With -2^63 in a DESC key the reference's wrapper negates it,
    -(-2^63) wraps to -2^63, and that row sorts FIRST; the port's order
    (complemented order words) is numpy's: the minimum sorts last."""
    rb = _batch(14, int_min=True)
    pb = carry.batch_from(rb)
    key_spec = [(A, True)]
    where = expr_op(Op.GE, c(D), _i(-1000))
    fn, _sig, pi, pf = _ref_slots(rb, [where])
    wrapper = jax.jit(rsched._build_topn_wrapper(
        fn, ((A, True, rcol.K_I64),), 4))
    planes, live = _jax_planes(rb)
    block = np.asarray(wrapper(planes, live, jnp.asarray(pi),
                               jnp.asarray(pf))).reshape(1, 5)
    fin, pools = _port_slots(pb, [where])
    pplanes, plist, plive = _port_planes(pb, fin)
    words = pk.slot_filter_plain(fin, pools, plist, plive)
    idx, n_live = pk.slot_topn_plain(words, [(pplanes[A], True)], 4)
    mask = pk.unpack_slot_words(words).numpy()[0]
    want = _numpy_topn(rb, mask, key_spec, 4)
    np.testing.assert_array_equal(idx[0].numpy(), want)
    jax_first = int(block[0, 0])
    assert rb.columns[A].values[jax_first] == I64_MIN   # the wrapped key
    assert rb.columns[A].values[want[0]] == I64_MAX
