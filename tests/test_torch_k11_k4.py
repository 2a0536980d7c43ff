"""K11 (`join_build`, `join_build_partitioned`) and K4 (`seg_agg_sorted`)
of the port after their redesign for Hopper: no library sort on either
card path.

- K11's plain version against the JAX package's `_join_build_impl`
  (`join_build_kernel`) on presorted, shuffled, descending and all-equal
  keys, NULLs interleaved, f64 keys with -0.0, +0.0 and +-inf, the int64
  extremes, one row and no valid row.
- `join_build_partitioned`'s plain version against `np.lexsort` over
  (partition, word) on partition-major planes.
- K4's plain version against the JAX package's `build_grouped_agg_fn` at
  S from 65 to past several of the card's segment windows, over every op:
  empty segments, wrapping int64 sums, -0.0 / +0.0 extremum ties, groups
  of only +inf or -inf (the reference's +-F64_MAX mapped by
  `port_identity`); and which zero an extremum keeps on a tie (the first
  in row order).
- The host pieces as pure functions: `radix_plan` (the constant digits
  skipped, no pass for a non-decreasing input; a numpy model that sorts
  stably by the planned digits alone equals `np.argsort(kind="stable")`),
  `k4_slots`, and `k4_route`'s windows and cap against the card's limit.
- With a recording stub in place of the CUDA libraries (one that also
  does each radix pass in numpy): each wrapper drives exactly the
  launches its plan or route names, with no `torch.sort`,
  `torch.argsort`, `torch.unique` or `kernels.lexsort` on the card path.
- The constants and layouts the wrappers share with the `.cu` sources.

Tolerance: words, rows, counts, integer states and extrema exact (the
reference's f64 extrema compared as floats, so -0.0 equals +0.0 there);
f64 sums within 1e-12 relative to the sum of magnitudes (another
summation order; the values are multiples of 0.5, so the sums are exact).
"""

import ctypes
import inspect
import os
import re
import threading

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

from tidb_tpu_torch import carry, errors
from tidb_tpu_torch.ops import _ext
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops.exprc import Program, compile_expr

from torch_parity import F64_RTOL, port_identity

I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
U64 = (1 << 64) - 1
CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
LIMIT = 232448 - 1472          # the H100's opt-in limit less static memory


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src: str, name: str) -> int:
    return int(re.search(r"#define %s (\d+)" % name, src).group(1))


# ---------------------------------------------------------------------------
# K11's plain version against _join_build_impl
# ---------------------------------------------------------------------------

N11 = 3000


def _k11_case(case: str) -> tuple:
    rng = np.random.default_rng(len(case))
    n = N11
    ones = np.ones(n, bool)
    keys = (np.arange(n) // 8) * 32 + np.arange(n) % 8 + 1
    if case == "presorted":
        return keys, ones
    if case == "shuffled":
        return rng.permutation(keys), ones
    if case == "descending":
        return keys[::-1].copy(), ones
    if case == "all equal":
        return np.full(n, 7, np.int64), ones
    if case == "NULLs interleaved":
        return rng.integers(0, 300, n), rng.random(n) > 0.3
    if case == "f64 zeros and infinities":
        f = rng.integers(-6, 6, n) * 0.5
        f[::7] = -0.0
        f[::9] = 0.0
        f[::11] = np.inf
        f[::13] = -np.inf
        return f, rng.random(n) > 0.1
    if case == "int64 extremes":
        ext = np.array([I64_MAX, I64_MIN, I64_MAX - 1, I64_MIN + 1, -1, 0, 1])
        return rng.choice(ext, n), rng.random(n) > 0.05
    if case == "one row":
        return np.array([42], np.int64), np.array([True])
    if case == "no valid row":
        return keys, np.zeros(n, bool)
    raise KeyError(case)


K11_CASES = ("presorted", "shuffled", "descending", "all equal",
             "NULLs interleaved", "f64 zeros and infinities",
             "int64 extremes", "one row", "no valid row")


@pytest.mark.parametrize("case", K11_CASES)
def test_join_build_plain_matches_jax(case):
    key, valid = _k11_case(case)
    key = np.asarray(key)
    rs, order, n_valid = (np.asarray(a) for a in
                          rk.join_build_kernel(key, valid))
    words, rows = pk.join_build(torch.from_numpy(key),
                                torch.from_numpy(valid))
    nv = int(n_valid)
    assert rows.tolist() == order[:nv].tolist()
    assert torch.equal(words, pk.orderable(torch.from_numpy(rs[:nv].copy())))


def _partition_major(seed: int, n: int, parts: int, presorted: bool):
    """Partition-major planes: keys, valid, offsets, and each row's
    partition (K21's layout: rows of a partition in row order)."""
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(-50, 400, n)) if presorted \
        else rng.integers(-50, 400, n)
    valid = rng.random(n) > 0.2
    part = pk.partition_codes_t(torch.from_numpy(key),
                                torch.from_numpy(valid), parts).numpy()
    sel = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=parts)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return key[sel], valid[sel], offsets, part[sel]


@pytest.mark.parametrize("parts,presorted", [(1, False), (3, False),
                                             (16, False), (16, True),
                                             (1024, False)])
def test_join_build_partitioned_plain_matches_lexsort(parts, presorted):
    key, valid, offsets, part = _partition_major(parts, 4000, parts,
                                                 presorted)
    words, rows, bounds = pk.join_build_partitioned(
        torch.from_numpy(key), torch.from_numpy(valid),
        torch.from_numpy(offsets))
    pos = np.flatnonzero(valid)
    order = np.lexsort((key[pos], part[pos]))
    assert rows.tolist() == pos[order].tolist()
    assert words.tolist() == key[pos][order].tolist()
    assert bounds.tolist() == np.searchsorted(pos, offsets).tolist()


# ---------------------------------------------------------------------------
# K4's plain version against build_grouped_agg_fn
# ---------------------------------------------------------------------------

G, VI, VF, VX, W = 1, 2, 3, 4, 5


def _k4_batch(distinct: int) -> rcol.ColumnBatch:
    """A group column of `distinct` values (+ NULLs); an int64 column with
    the extremes; a finite f64 column with -0.0 beside +0.0 (sums); an f64
    column whose groups 1 and 2 hold only +inf and only -inf (extrema)."""
    n = max(2 * distinct, 2000)
    cap = n + 37
    rng = np.random.default_rng(distinct)
    live = np.zeros(cap, bool)
    live[:n] = True
    g = rng.integers(0, distinct, cap).astype(np.int64)
    gv = live & (rng.random(cap) > 0.03)
    every = rng.choice(n, distinct, replace=False)   # each value once
    g[every] = np.arange(distinct)
    gv[every] = True
    vi = rng.integers(-1000, 1000, cap)
    ext = rng.random(cap) < 0.03
    vi[ext] = rng.choice([I64_MAX, I64_MIN, I64_MAX - 7], int(ext.sum()))
    vf = rng.integers(-400, 400, cap) * 0.5
    vf[::17] = -0.0
    vf[::19] = 0.0
    vx = rng.integers(-400, 400, cap) * 0.5
    vx[::23] = -0.0
    vx[g == 1] = np.inf
    vx[g == 2] = -np.inf
    cols = {
        G: rcol.ColumnData(rcol.K_I64, g, gv, tp=rmy.TypeLong,
                           max_abs=distinct),
        VI: rcol.ColumnData(rcol.K_I64, vi.astype(np.int64),
                            live & (rng.random(cap) > 0.1),
                            tp=rmy.TypeLonglong, max_abs=I64_MAX),
        VF: rcol.ColumnData(rcol.K_F64, vf, live & (rng.random(cap) > 0.1),
                            tp=rmy.TypeDouble),
        VX: rcol.ColumnData(rcol.K_F64, vx, live & (rng.random(cap) > 0.1),
                            tp=rmy.TypeDouble),
        W: rcol.ColumnData(rcol.K_I64, rng.integers(0, 10, cap)
                           .astype(np.int64), live, tp=rmy.TypeLong,
                           max_abs=9),
    }
    return rcol.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), cols)


def _k4_aggs():
    one = expr_value(RDatum.i64(1))
    return [expr_agg("count", [one]), expr_agg("count", [c(VI)]),
            expr_agg("count", [expr_value(RNULL)]),
            expr_agg("sum", [c(VI)]), expr_agg("avg", [c(VF)]),
            expr_agg("sum", [c(VF)]),
            expr_agg("min", [c(VI)]), expr_agg("max", [c(VI)]),
            expr_agg("min", [c(VX)]), expr_agg("max", [c(VX)]),
            expr_agg("min", [c(VF)]), expr_agg("max", [c(VF)]),
            expr_agg("first_row", [c(VF)]), expr_agg("first_row", [c(G)])]


def _ref_grouped(req, rb):
    where = rcompile(req.where, rb) if req.where is not None else None
    specs = rk.lower_aggregates(req, rb)
    planes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
              for cid, cd in rb.columns.items()}
    planes[rk.POS_CID] = (jnp.arange(rb.capacity, dtype=jnp.int64), None)
    gspec = rk.lower_group_by(req, rb)
    for key in gspec.plane_keys:
        if rk.is_group_code_key(key):
            cid = rk.group_code_cid(key)
            codes, _u = rb.group_codes(cid)
            planes[key] = (jnp.asarray(codes), planes[cid][1])
    fn = rk.build_grouped_agg_fn(where, specs, gspec.plane_keys, gspec.sizes)
    wrapper = rk.pack_outputs(fn)
    packed = np.asarray(jax.jit(wrapper)(planes,
                                         jnp.asarray(rb.row_mask())))
    return rk.unpack_outputs(wrapper, packed), fn


def _port_grouped(req, rb):
    pb = carry.batch_from(rb)
    preq = carry.request_from(req)
    prog = Program(pb)
    where = compile_expr(preq.where, pb, prog) \
        if preq.where is not None else None
    specs = pk.lower_aggregates(preq, pb, prog)
    cpu = torch.device("cpu")
    planes = dict(pk.batch_planes(pb, cpu))
    gspec = pk.lower_group_by(preq, pb)
    for key in gspec.plane_keys:
        if key <= pk.GC_BASE:
            codes, _u = pb.group_codes(pk.GC_BASE - key)
            planes[key] = (torch.from_numpy(codes),
                           planes[pk.GC_BASE - key][1])
    fn = pk.build_grouped_agg_fn(prog, where, specs, gspec.plane_keys,
                                 gspec.sizes)
    return fn(planes, pk.device_live(pb, cpu)), fn


# distinct group values: S = distinct + 2 (NULL, the dead-row sink); the
# largest takes 6 windows at the slots of _k4_aggs under LIMIT
K4_DISTINCT = (63, 700, 6000, 10000)


@pytest.mark.parametrize("distinct", K4_DISTINCT)
@pytest.mark.parametrize("where", [False, True])
def test_seg_agg_plain_matches_jax(distinct, where):
    rb = _k4_batch(distinct)
    cond = expr_op(Op.GT, c(W), expr_value(RDatum.i64(3))) if where \
        else None
    req = SelectRequest(start_ts=0, where=cond, group_by=[ByItem(c(G))],
                        aggregates=_k4_aggs())
    want, rfn = _ref_grouped(req, rb)
    got, pfn = _port_grouped(req, rb)
    assert pfn.num_segments == rfn.num_segments == distinct + 2
    assert pfn.num_segments > pk.ONEHOT_SEGMENTS_MAX
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(port_identity(w))
        assert g.shape == w.shape, j
        if w.dtype.kind == "f":
            assert np.allclose(g, w, rtol=F64_RTOL, atol=0.0,
                               equal_nan=True), (j, g, w)
        else:
            assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), j
    # the data holds what the docstring promises: empty segments (under
    # the WHERE), +inf-only and -inf-only groups, wrapped sums
    vx_min, vx_max = (np.asarray(x) for x in got[17:20:2])
    assert np.isinf(vx_min).any() and np.isinf(vx_max).any()


def test_k4_cases_cover_several_windows(monkeypatch):
    """The reductions of these cases take one window on the card's limit at
    the smallest S and more than one at the largest."""
    seen = []
    plain = pk.seg_agg_plain

    def spy(gid, mask, S, reds):
        seen.append((S, reds))
        return plain(gid, mask, S, reds)

    monkeypatch.setattr(pk, "seg_agg_plain", spy)
    for distinct in (min(K4_DISTINCT), max(K4_DISTINCT)):
        req = SelectRequest(start_ts=0, group_by=[ByItem(c(G))],
                            aggregates=_k4_aggs())
        _port_grouped(req, _k4_batch(distinct))
    windows = []
    for S, reds in seen:
        slots, _map = pk.k4_slots(reds)
        n_f = sum(s[0] in pk.F_OPS for s in slots)
        route, _rows, w = pk.k4_route(len(reds), len(slots), n_f, S,
                                      LIMIT)
        assert route == "seg_agg_block"
        windows.append(w)
    assert windows[0] == 1 and windows[-1] >= 3


@pytest.mark.parametrize("op", [pk.R_MIN_F, pk.R_MAX_F])
@pytest.mark.parametrize("first", [-0.0, 0.0])
def test_seg_plain_keeps_the_first_zero(op, first):
    """An extremum tie of -0.0 and +0.0 keeps the first in row order, as
    the windows (a fold in row order) and the sorted route do."""
    v = torch.tensor([5.0, first, -first, -7.0], dtype=torch.float64)
    gid = torch.tensor([0, 70, 70, 1], dtype=torch.int64)
    mask = torch.ones(4, dtype=torch.bool)
    _n, acc = pk.seg_agg_plain(gid, mask, 80, [pk.Red(op, v)])
    got = acc[0, 70:71].view(torch.float64)[0]
    assert float(got) == 0.0
    assert bool(torch.signbit(got)) == bool(np.signbit(first))


# ---------------------------------------------------------------------------
# the host pieces
# ---------------------------------------------------------------------------

def _unsigned(w: np.ndarray) -> np.ndarray:
    return w.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)


def _varying(w: np.ndarray) -> int:
    u = _unsigned(w)
    return int(np.bitwise_or.reduce(u)) ^ int(np.bitwise_and.reduce(u))


def _model_sort(w: np.ndarray, plan: list, part=None):
    """Stable LSD passes over the planned digits alone (numpy)."""
    u = _unsigned(w)
    perm = np.arange(len(w))
    for source, shift in plan:
        src = u[perm] if source == 0 else part[perm].astype(np.uint64)
        d = (src >> np.uint64(shift)) & np.uint64((1 << pk.RADIX_BITS) - 1)
        perm = perm[np.argsort(d, kind="stable")]
    return perm


RADIX_WORDS = {
    "23-bit keys": lambda r: r.integers(1, 6_000_000, 5000),
    "negative and positive": lambda r: r.integers(-(1 << 40), 1 << 40, 5000),
    "full 64 bits": lambda r: r.integers(I64_MIN, I64_MAX, 5000,
                                         dtype=np.int64),
    "constant high bytes": lambda r: (r.integers(0, 1 << 12, 5000)
                                      << 20) + (7 << 48),
    "all equal": lambda r: np.full(5000, -9, np.int64),
    "many ties": lambda r: r.integers(0, 4, 5000),
    "int64 extremes": lambda r: r.choice([I64_MAX, I64_MIN, 0, -1], 5000),
}


@pytest.mark.parametrize("case", sorted(RADIX_WORDS))
def test_radix_plan_sorts_like_argsort(case):
    bits = pk.RADIX_BITS
    w = RADIX_WORDS[case](np.random.default_rng(len(case))).astype(np.int64)
    plan = pk.radix_plan(_varying(w), False)
    assert all(src == 0 and shift % bits == 0 for src, shift in plan)
    shifts = [s for _src, s in plan]
    assert shifts == sorted(shifts)
    # exactly the digits in which two words differ
    u = _unsigned(w)
    for shift in range(0, 64, bits):
        d = (u >> np.uint64(shift)) & np.uint64((1 << bits) - 1)
        assert (shift in shifts) == (len(np.unique(d)) > 1)
    assert np.array_equal(_model_sort(w, plan),
                          np.argsort(w, kind="stable"))


def test_radix_plan_counts():
    # order keys below 2^23: 3 passes at 8 bits
    assert pk.RADIX_BITS == 8
    assert pk.radix_plan((1 << 23) - 1, False) == [(0, 0), (0, 8), (0, 16)]
    assert pk.radix_plan(U64, True) == []
    assert pk.radix_plan(0, False) == []
    assert len(pk.radix_plan(U64, False)) == 8
    # a negative Python int (the OR read back as int64) is a 64-bit mask
    assert pk.radix_plan(-1, False) == pk.radix_plan(U64, False)
    # the partition digits come last
    plan = pk.radix_plan(0xFF, False, parts=1024)
    assert plan == [(0, 0), (1, 0), (1, 8)]
    assert pk.radix_plan(0xFF, False, parts=1) == [(0, 0)]


@pytest.mark.parametrize("case", sorted(RADIX_WORDS))
def test_radix_sort_plain_matches_argsort(case):
    """The radix's plain version (its planned passes, each a stable sort by
    one digit) against np.argsort, with and without a payload."""
    w = RADIX_WORDS[case](np.random.default_rng(len(case) + 1)) \
        .astype(np.int64)
    plan = pk.radix_plan(_varying(w), False)
    keys = torch.from_numpy(w)
    got_w, got_p = pk.radix_sort_t(keys, None, plan)
    want = np.argsort(w, kind="stable")
    assert got_p.tolist() == want.tolist()
    assert got_w.tolist() == w[want].tolist()
    pay = torch.from_numpy(np.arange(len(w), dtype=np.int64) * 7 - 3)
    assert pk.radix_sort_t(keys, pay, plan)[1].tolist() == \
        (want * 7 - 3).tolist()


@pytest.mark.parametrize("parts", [3, 16, 1024, 70_000])
def test_radix_plan_partitions_sort_like_lexsort(parts):
    rng = np.random.default_rng(parts)
    w = rng.integers(-1000, 1000, 4000)
    part = np.sort(rng.integers(0, parts, 4000))
    plan = pk.radix_plan(_varying(w), False, parts)
    assert np.array_equal(_model_sort(w, plan, part),
                          np.lexsort((w, part)))
    # the plain version reads each row's partition from the payload
    counts = np.bincount(part, minlength=parts)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    got = pk.radix_sort_plain(torch.from_numpy(w), None, plan, offsets)[1]
    assert np.array_equal(got.numpy(), np.lexsort((w, part)))


def _k4_reds(n: int = 100):
    v = torch.arange(n, dtype=torch.int64)
    f = torch.arange(n, dtype=torch.float64)
    ok, ok2 = torch.ones(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool)
    R = pk.Red
    return [R(pk.R_COUNT), R(pk.R_COUNT, const_bits=1), R(pk.R_SUM_I, v, ok),
            R(pk.R_COUNT, v, ok), R(pk.R_MAX_I, v, ok), R(pk.R_SUM_I, v, ok),
            R(pk.R_SUM_F, f, ok2), R(pk.R_MIN_F, f, ok2), R(pk.R_FIRST),
            R(pk.R_FIRST), R(pk.R_SUM_I, const_bits=7),
            R(pk.R_MAX_I, const_bits=3, never=True)], (v, f, ok, ok2)


def test_k4_slots_share_counts_and_values():
    reds, (v, f, ok, ok2) = _k4_reds()
    slots, red_map = pk.k4_slots(reds)
    n_mask = [pk.R_COUNT, 0, 1, 0, 0]
    n_ok = [pk.R_COUNT, 0, 1, 0, ok.data_ptr()]
    n_ok2 = [pk.R_COUNT, 0, 1, 0, ok2.data_ptr()]
    assert slots == [n_mask, n_ok, [pk.R_SUM_I, 0, 0, v.data_ptr(),
                                    ok.data_ptr()],
                     [pk.R_MAX_I, 0, 0, v.data_ptr(), ok.data_ptr()], n_ok2,
                     [pk.R_SUM_F, 0, 0, f.data_ptr(), ok2.data_ptr()],
                     [pk.R_MIN_F, 0, 0, f.data_ptr(), ok2.data_ptr()],
                     [pk.R_FIRST, pk.K6B_ROW_VALUE, 0, 0, 0],
                     [pk.R_SUM_I, 0, 7, 0, 0]]
    assert red_map == [[pk.R_COUNT, 0, -1], [pk.R_COUNT, 0, -1],
                       [pk.R_SUM_I, 1, 2], [pk.R_COUNT, 1, -1],
                       [pk.R_MAX_I, 1, 3], [pk.R_SUM_I, 1, 2],
                       [pk.R_SUM_F, 4, 5], [pk.R_MIN_F, 4, 6],
                       [pk.R_FIRST, 0, 7], [pk.R_FIRST, 0, 7],
                       [pk.R_SUM_I, 0, 8], [pk.R_MAX_I, -1, -1]]


@pytest.mark.parametrize("n_slots,n_f,S", [
    (8, 0, 10_002), (12, 0, 104), (11, 0, 65), (9, 2, 14_002),
    (8, 0, 80_016), (8, 0, 1 << 20), (32, 4, 3000), (33, 0, 100),
    (1, 0, 1 << 20), (4, 4, 40_000)])
def test_k4_route(n_slots, n_f, S):
    route, rows, windows = pk.k4_route(6, n_slots, n_f, S, LIMIT)
    spans = {r: (LIMIT - pk.k6_block_bytes(n_slots, n_f, 0, r))
             // (8 * n_slots) for r in pk.K6B_ROWS}
    fewest = min((-(-S // s) for s in spans.values() if s > 0),
                 default=None)
    if n_slots > pk.K6B_MAX_REDS or fewest is None \
            or fewest > pk.K4_MAX_WINDOWS:
        assert (route, rows, windows) == ("seg_agg_sorted", 0, 0)
        return
    assert route == "seg_agg_block" and windows == fewest
    assert rows == max(r for r, s in spans.items() if s > 0
                       and -(-S // s) == fewest)
    span = -(-S // windows)
    assert pk.k6_block_bytes(n_slots, n_f, span, rows) <= LIMIT
    # no opt-in memory, or more reductions than the launch's parameters
    # hold: the sorted route
    assert pk.k4_route(6, n_slots, n_f, S, 0)[0] == "seg_agg_sorted"
    assert pk.k4_route(pk.K4_MAX_REDS + 1, n_slots, n_f, S,
                       LIMIT)[0] == "seg_agg_sorted"


@pytest.mark.parametrize("n_slots,n_f,span,rows", [
    (12, 0, 104, 4), (12, 2, 104, 4), (8, 0, 3334, 4), (1, 0, 65, 4),
    (32, 4, 300, 1), (6, 0, 2000, 4)])
def test_k4_copies(n_slots, n_f, span, rows):
    copies = pk.k4_copies(n_slots, n_f, span, rows, LIMIT)
    assert copies & (copies - 1) == 0 and 1 <= copies <= pk.K4_MAX_COPIES

    def nbytes(c):
        return pk.k6_block_bytes(n_slots, n_f, span, rows) \
            + 8 * (c - 1) * n_slots * span

    assert copies == 1 or nbytes(copies) <= LIMIT
    assert copies == pk.K4_MAX_COPIES or nbytes(2 * copies) > LIMIT


def test_k4_route_shapes():
    """The shapes of the main path: Q1's 104 mesh ids in one window,
    GROUP BY l_suppkey's 10,002 in a few, by_supplier over 8 shards and the
    2^20-segment edge past the cap; the cap within what a launch holds."""
    assert pk.k4_route(11, 11, 0, 104, LIMIT)[2] == 1
    assert 1 < pk.k4_route(6, 8, 0, 10_002, LIMIT)[2] <= 4
    assert pk.k4_route(6, 8, 0, 80_016, LIMIT)[0] == "seg_agg_sorted"
    assert pk.k4_route(10, 11, 2, 1 << 20, LIMIT)[0] == "seg_agg_sorted"
    assert pk.K4_MAX_WINDOWS <= pk.K4_WINDOWS_CAP


# ---------------------------------------------------------------------------
# the wrappers drive their launches (a recording stub for the libraries)
# ---------------------------------------------------------------------------

def _i64(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_int64 * max(n, 1))
                                 .from_address(ptr))[:n]


def _u8(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_uint8 * max(n, 1))
                                 .from_address(ptr))[:n]


def _partition_of(offsets: np.ndarray, rows: np.ndarray) -> np.ndarray:
    return np.searchsorted(offsets[:-1], rows, side="right") - 1


class _Recorder:
    """A stand-in for the kernel libraries: records each launch and does
    K11's compaction and each radix pass in numpy on the CPU planes."""

    def __init__(self, grid: int):
        self.calls = []
        self.grid = grid

    def join_build_blocks(self, n):
        return -(-n // pk.K11_TILE)

    def join_build_launch(self, n, key_p, valid_p, is_f64, off_p, P, _tiles,
                          _offs, _summary, summary_p, words_p, idx_p, _st):
        key = _i64(key_p, n).copy()
        if is_f64:
            key = pk.orderable(torch.from_numpy(key.view(np.float64))).numpy()
        rows = np.flatnonzero(_u8(valid_p, n))
        words = key[rows]
        part = _partition_of(_i64(off_p, P + 1), rows) if off_p \
            else np.zeros(len(rows), np.int64)
        pairs = list(zip(part.tolist(), words.tolist()))
        u = _unsigned(words)
        summary = [len(rows),
                   int(np.bitwise_or.reduce(u)) if len(u) else 0,
                   int(np.bitwise_and.reduce(u)) if len(u) else U64,
                   int(pairs == sorted(pairs))]
        _i64(summary_p, 4)[:] = np.array(summary, np.uint64).view(np.int64)
        _i64(words_p, len(rows))[:] = words
        _i64(idx_p, len(rows))[:] = rows
        self.calls.append(("k11", (n, off_p, P)))
        return 0

    def radix_scratch_ints(self, n):
        return (1 << pk.RADIX_BITS) * (-(-n // pk.RADIX_TILE) + 1)

    def radix_pass_launch(self, n, shift, off_p, P, k_in, p_in, k_out,
                          p_out, _counts, _st):
        keys = _i64(k_in, n).copy()
        pay = _i64(p_in, n).copy() if p_in else np.arange(n, dtype=np.int64)
        src = _partition_of(_i64(off_p, P + 1), pay).astype(np.uint64) \
            if off_p else _unsigned(keys)
        d = (src >> np.uint64(shift)) & np.uint64((1 << pk.RADIX_BITS) - 1)
        perm = np.argsort(d, kind="stable")
        _i64(k_out, n)[:] = keys[perm]
        _i64(p_out, n)[:] = pay[perm]
        self.calls.append(("radix", (n, shift, off_p, P, k_in, p_in, k_out,
                                     p_out)))
        return 0

    def seg_agg_block_limit(self):
        return LIMIT

    def seg_agg_block_grid(self, rows, smem):
        return self.grid

    def seg_agg_block_launch(self, *args):
        (rows, n_blocks, rdesc_p, R, _gid, _mask, n_slots, n_f, slots_p,
         n_red, map_p, span, _copies, n_seg, _part, _out, _st) = args
        self.calls.append(("block", args, (
            _i64(rdesc_p, R * pk.K6_RDESC).reshape(R, -1).tolist(),
            _i64(slots_p, n_slots * pk.K4_SLOT).reshape(n_slots, -1)
            .tolist(),
            _i64(map_p, n_red * pk.K4_MAP).reshape(n_red, -1).tolist())))
        return 0

    def seg_sorted_pieces_count(self, n):
        return -(-n // 2048)

    def seg_sorted_launch(self, n, gs_p, order_p, *rest):
        self.calls.append(("sorted", (n, _i64(gs_p, n).copy(),
                                      _i64(order_p, n).copy())))
        return 0


def _no_sort(*_a, **_k):
    raise AssertionError("a library sort on the card path")


@pytest.fixture
def stub_card(monkeypatch):
    """The wrappers' card path over CPU tensors, with a recording library
    instead of the CUDA ones and every library sort made to fail."""
    rec = _Recorder(grid=24)
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "_K11_HOST", {})
    monkeypatch.setattr(pk, "_K4_LIMIT", {})
    monkeypatch.setattr(pk, "_K4_GRID", {})
    for name in ("sort", "argsort", "unique"):
        monkeypatch.setattr(torch, name, _no_sort)
    monkeypatch.setattr(pk, "lexsort", _no_sort)
    # the process's counts stay as they were: other tests read them
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return rec


@pytest.mark.parametrize("case", K11_CASES)
def test_join_build_drives_its_plan(stub_card, case):
    key, valid = _k11_case(case)
    key = np.asarray(key)
    words, rows = pk.join_build(torch.from_numpy(key),
                                torch.from_numpy(valid))
    pos = np.flatnonzero(valid)
    w = pk.orderable(torch.from_numpy(key)).numpy()[pos]
    plan = [] if len(pos) < 2 or np.all(np.diff(w) >= 0) \
        else pk.radix_plan(_varying(w), False)
    kinds = [k for k, _a in stub_card.calls]
    assert kinds == ["k11"] + ["radix"] * len(plan)
    assert pk.LAUNCHES["join_build"] == 1
    assert pk.LAUNCHES["radix_pass"] == len(plan)
    assert sum(pk.LAUNCHES.values()) == 1 + len(plan)
    order = np.argsort(w, kind="stable")
    assert rows.tolist() == pos[order].tolist()
    assert words.tolist() == w[order].tolist()
    for i, (_k, (n, shift, off_p, _P, k_in, _p_in, k_out, _p_out)) \
            in enumerate(stub_card.calls[1:]):
        assert (n, shift, off_p) == (len(pos), plan[i][1], 0)
        if i:
            assert k_in == stub_card.calls[i][1][6]      # ping-pong
        assert k_in != k_out


def test_presorted_build_needs_no_pass(stub_card):
    key = np.arange(5000, dtype=np.int64) * 3
    valid = np.random.default_rng(1).random(5000) > 0.4
    pk.join_build(torch.from_numpy(key), torch.from_numpy(valid))
    assert [k for k, _a in stub_card.calls] == ["k11"]
    assert pk.LAUNCHES["radix_pass"] == 0


def test_k11_threads_on_one_stream_keep_their_summaries(stub_card):
    """Two threads on one stream share K11's page-locked summary: the
    second's launch waits until the first has read its own (else it writes
    its n_valid and digits over the first's, which then keeps the wrong
    rows and plan)."""
    first_in, second_in = threading.Event(), threading.Event()
    launch = stub_card.join_build_launch

    def launch_then_wait(n, *args):
        rc = launch(n, *args)
        if n == N11:                 # the first: give the second its turn
            first_in.set()
            second_in.wait(0.3)
        else:
            second_in.set()
        return rc

    stub_card.join_build_launch = launch_then_wait
    rng = np.random.default_rng(5)
    planes = [(rng.permutation(N11).astype(np.int64), rng.random(N11) > 0.1),
              (rng.integers(-(1 << 40), 1 << 40, 700), rng.random(700) > 0.5)]
    got = [None, None]

    def build(i):
        key, valid = planes[i]
        got[i] = pk.join_build(torch.from_numpy(key), torch.from_numpy(valid))

    first = threading.Thread(target=build, args=(0,))
    first.start()
    assert first_in.wait(10)
    second = threading.Thread(target=build, args=(1,))
    second.start()
    first.join(10)
    second.join(10)
    assert second_in.is_set()
    for (key, valid), (words, rows) in zip(planes, got):
        pos = np.flatnonzero(valid)
        order = pos[np.argsort(key[pos], kind="stable")]
        assert rows.tolist() == order.tolist()
        assert words.tolist() == key[order].tolist()
    assert pk.LAUNCHES["join_build"] == 2


@pytest.mark.parametrize("parts,presorted", [(1, False), (16, False),
                                             (16, True), (1024, False)])
def test_join_build_partitioned_drives_its_plan(stub_card, parts,
                                                presorted):
    key, valid, offsets, part = _partition_major(parts + 7, 4000, parts,
                                                 presorted)
    off_t = torch.from_numpy(offsets)
    words, rows, bounds = pk.join_build_partitioned(
        torch.from_numpy(key), torch.from_numpy(valid), off_t)
    pos = np.flatnonzero(valid)
    order = np.lexsort((key[pos], part[pos]))
    assert rows.tolist() == pos[order].tolist()
    assert words.tolist() == key[pos][order].tolist()
    assert bounds.tolist() == np.searchsorted(pos, offsets).tolist()
    pairs = list(zip(part[pos].tolist(), key[pos].tolist()))
    plan = [] if pairs == sorted(pairs) else pk.radix_plan(
        _varying(key[pos]), False, parts=parts)
    assert [k for k, _a in stub_card.calls] == ["k11"] + ["radix"] * len(plan)
    assert stub_card.calls[0][1] == (4000, off_t.data_ptr(), parts)
    assert pk.LAUNCHES["radix_pass"] == len(plan)
    for (_k, args), (src, shift) in zip(stub_card.calls[1:], plan):
        assert args[1] == shift
        assert args[2] == (off_t.data_ptr() if src else 0)
        assert args[3] == (parts if src else 0)
    if presorted:
        assert plan == []


def _k4_planes(n: int, S: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    gid = torch.from_numpy(rng.integers(0, S, n))
    mask = torch.from_numpy(rng.random(n) > 0.2)
    return gid, mask


def test_seg_agg_windows_drive_their_launch(stub_card):
    reds, _planes = _k4_reds(30_000)
    gid, mask = _k4_planes(30_000, 10_002)
    n, acc = pk.seg_agg_sorted(gid, mask, 10_002, reds)
    assert n.shape == acc.shape == (len(reds), 10_002)
    assert pk.LAUNCHES["seg_agg_block"] == 1
    assert sum(pk.LAUNCHES.values()) == 1
    (kind, args, (rdesc, slots, red_map)), = stub_card.calls
    assert kind == "block"
    want_slots, want_map = pk.k4_slots(reds)
    n_f = sum(s[0] in pk.F_OPS for s in want_slots)
    route, rows, windows = pk.k4_route(len(reds), len(want_slots), n_f,
                                       10_002, LIMIT)
    assert route == "seg_agg_block" and windows > 1
    (c_rows, n_blocks, _rd, R, gid_p, mask_p, n_slots, c_nf, _s, n_red, _m,
     span, copies, n_seg, _part, _out, _st) = args
    assert (c_rows, R, n_slots, c_nf, n_red, n_seg) == (
        rows, windows, len(want_slots), n_f, len(reds), 10_002)
    assert (gid_p, mask_p) == (gid.data_ptr(), mask.data_ptr())
    assert slots == want_slots and red_map == want_map
    assert span == -(-10_002 // windows)
    assert copies == 1                          # more than one window
    units = pk.k6_block_units([30_000] * windows, stub_card.grid)
    assert n_blocks == sum(units)
    first = np.concatenate([[0], np.cumsum(units)])
    for w in range(windows):
        assert rdesc[w] == [0, 30_000, w * span,
                            min(span, 10_002 - w * span), first[w], units[w]]


def test_seg_agg_one_window_takes_copies(stub_card):
    """Few segments: one window, its integer states in k4_copies copies."""
    reds, _planes = _k4_reds(30_000)
    gid, mask = _k4_planes(30_000, 104)
    pk.seg_agg_sorted(gid, mask, 104, reds)
    (kind, args, (rdesc, slots, _map)), = stub_card.calls
    n_f = sum(s[0] in pk.F_OPS for s in slots)
    route, rows, windows = pk.k4_route(len(reds), len(slots), n_f, 104,
                                       LIMIT)
    assert (kind, windows, args[3], args[11]) == ("block", 1, 1, 104)
    assert args[12] == pk.k4_copies(len(slots), n_f, 104, rows, LIMIT) > 1
    assert rdesc == [[0, 30_000, 0, 104, 0, args[1]]]


@pytest.mark.parametrize("S", [80_016, 1 << 20])
def test_seg_agg_past_the_cap_sorts_by_radix(stub_card, S):
    reds, _planes = _k4_reds(20_000)
    gid, mask = _k4_planes(20_000, S)
    pk.seg_agg_sorted(gid, mask, S, reds)
    plan = pk.radix_plan((1 << (S - 1).bit_length()) - 1, False)
    kinds = [k for k, *_a in stub_card.calls]
    assert kinds == ["radix"] * len(plan) + ["sorted"]
    assert pk.LAUNCHES["radix_pass"] == len(plan)
    assert pk.LAUNCHES["seg_agg_sorted"] == 1
    assert sum(pk.LAUNCHES.values()) == len(plan) + 1
    _k, (n, gs, order) = stub_card.calls[-1]
    want = np.argsort(gid.numpy(), kind="stable")
    assert np.array_equal(order, want)
    assert np.array_equal(gs, gid.numpy()[want])
    # the first pass reads the caller's plane and the row positions; none
    # writes the caller's plane
    first = stub_card.calls[0][1]
    assert first[4] == gid.data_ptr() and first[5] == 0
    assert all(call[1][6] != gid.data_ptr() for call in stub_card.calls[:-1])


def test_k4_block_takes_windows_past_the_cap(stub_card):
    """The windowed route run outright, as the card's sweep behind
    K4_MAX_WINDOWS runs it: the fewest windows that fit, past the cap and
    within what its launch holds, where seg_agg_sorted would sort."""
    reds, _planes = _k4_reds(20_000)
    gid, mask = _k4_planes(20_000, 40_000)
    slots, _map = pk.k4_slots(reds)
    n_f = sum(s[0] in pk.F_OPS for s in slots)
    rows, windows = pk._k4_windows(len(reds), len(slots), n_f, 40_000, LIMIT)
    assert pk.K4_MAX_WINDOWS < windows <= pk.K4_WINDOWS_CAP
    assert pk.k4_route(len(reds), len(slots), n_f, 40_000, LIMIT)[0] \
        == "seg_agg_sorted"
    pk._k4_block(gid, mask, 40_000, reds)
    (kind, args, _tables), = stub_card.calls
    assert (kind, args[0], args[3]) == ("block", rows, windows)
    assert pk.LAUNCHES["seg_agg_block"] == 1
    # more windows than the launch holds: refused, not sorted instead
    gid, mask = _k4_planes(20_000, 1 << 20)
    with pytest.raises(errors.DeviceError):
        pk._k4_block(gid, mask, 1 << 20, reds)


def test_card_paths_call_no_library_sort():
    """The card paths' sources name no library sort (the plain versions'
    stay as they are)."""
    for fn in (pk.join_build, pk._k11_sort, pk.join_build_partitioned,
               pk.radix_sort_t, pk._radix_passes, pk.seg_agg_sorted):
        src = inspect.getsource(fn)
        body = src.split('"""')[-1] if src.count('"""') >= 2 else src
        for banned in ("torch.sort", "argsort", "torch.unique", "lexsort",
                       "_segment_sort"):
            assert banned not in body, (fn.__name__, banned)


# ---------------------------------------------------------------------------
# constants and layouts against the .cu sources
# ---------------------------------------------------------------------------

def test_radix_constants_match_source():
    src = _source("radix.cuh")
    assert _define(src, "RADIX_THREADS") * _define(src, "RADIX_ITEMS") \
        == pk.RADIX_TILE
    assert re.search(r"#define RADIX_TILE \(RADIX_THREADS \* RADIX_ITEMS\)",
                     src)
    # one digit width, built without a template of it: only the two tile
    # steps the sort shares with K21's partition pass take their bins as
    # a template, and the sort's scatter instantiates them at RADIX_BINS
    assert _define(src, "RADIX_BITS") == pk.RADIX_BITS
    assert re.findall(r"template <int BINS>\n__device__ __forceinline__ "
                      r"\w+ (\w+)\(", src) == ["radix_warp_rank",
                                               "radix_tile_starts"]
    assert src.count("template <") == 2
    assert "constexpr int BINS = RADIX_BINS;" in src
    assert '#include "radix.cuh"' in _source("radix_sort.cu")
    # the scratch the wrapper asks for: counts [digit][tile] and totals
    body = re.search(r"radix_scratch\(long long n\) \{(.*?)\n\}",
                     src, re.S).group(1)
    assert "RADIX_BINS * (radix_tiles(n) + 1)" in body
    assert re.search(r"#define RADIX_BINS \(1 << RADIX_BITS\)", src)


def test_k11_constants_match_source():
    src = _source("join_build.cu")
    assert _define(src, "K11_THREADS") * _define(src, "K11_ITEMS") \
        == pk.K11_TILE
    assert _define(src, "K11_TILE_FIELDS") == pk.K11_TILE_FIELDS
    assert _define(src, "K11_SUMMARY") == pk.K11_SUMMARY
    # the summary's order: n_valid, OR, AND, sorted
    fold = re.search(r"summary\[0\] = carry;(.*?)summary\[3\] = sorted;", src,
                     re.S)
    assert fold and "summary[1] = (i64)s_or" in fold.group(0) \
        and "summary[2] = (i64)s_and" in fold.group(0)


def test_k4_constants_match_source():
    src = _source("seg_agg_sorted.cu")
    block = _source("seg_block.cuh")
    assert _define(src, "K4_SLOT") == pk.K4_SLOT
    assert _define(src, "K4_MAP") == pk.K4_MAP
    assert _define(src, "K4_WINDOWS_CAP") == pk.K4_WINDOWS_CAP
    assert _define(src, "K4_MAX_REDS") == pk.K4_MAX_REDS
    assert "copies > 32" in src and pk.K4_MAX_COPIES <= 32
    body = re.search(r"k6b_copies_bytes\(int n_red, int n_f, int span_max, "
                     r"int rows,\s+int copies\) \{(.*?)\n\}", block,
                     re.S).group(1)
    assert "8LL * (copies - 1) * n_red * span_max" in body
    # the by-value parameters fit a launch's 4 KB with room to spare
    assert 8 * (pk.K4_WINDOWS_CAP * pk.K6_RDESC + pk.K6B_MAX_REDS
                * pk.K4_SLOT + pk.K4_MAX_REDS * pk.K4_MAP) <= 4096 - 256
    assert "const __grid_constant__ K4Params P" in src
    assert _define(block, "K6B_ROW_VALUE") == pk.K6B_ROW_VALUE
    assert _define(block, "K6_RDESC") == pk.K6_RDESC
    assert _define(block, "K6B_MAX_REDS") == pk.K6B_MAX_REDS
    assert '#include "seg_block.cuh"' in src
    assert '#include "seg_block.cuh"' in _source("seg_states_ragged.cu")
    for rows in pk.K6B_ROWS:
        assert f"seg_agg_block<{rows}>" in src
    # the slot's fields, in the wrapper's order
    body = re.search(r"SbSlot slot\(int j, int r, i64 base\) const \{(.*?)\n"
                     r"  \}", src, re.S).group(1)
    for i, field in enumerate(("op", "flags", "cval", "vals", "valid")):
        assert re.search(r"s\.%s = .*d\[%d\];" % (field, i), body), field
    assert set(pk.K4_ROUTES) <= set(pk.LAUNCHES) and "radix_pass" in \
        pk.LAUNCHES
