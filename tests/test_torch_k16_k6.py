"""K6's segment windows and its sorted route on the radix sort, and K16
(`slot_topn`) on K10's threshold filter, after their redesign for Hopper.

- K6's route and window plan as pure functions (`k6_route`,
  `k6_windows`, `k6_window_plan`): spans past one block take windows
  while a region needs at most K6_MAX_WINDOWS, the windows cover each
  region's groups and sink exactly once and fit the limit; past the cap
  or past K6B_MAX_REDS reductions the route is the sorted one.
- K6's plain version against the JAX package's `region_agg_states_batched`
  at a d_supplier-like shape (4 regions of about 3,000 groups, 8
  reductions with first_row's count, NULLs, -2^63 and +-inf), which takes
  the window route. The reference's f64 extremum identity +-F64_MAX is
  mapped to the port's +-inf (`port_identity`).
- K16's plan (`shard_topk_plan` with one shard a slot): K20's levels,
  rounds past the largest K a block holds, launches that do not grow with
  the rows, k clipped to the rows.
- `slot_topn_plain` against the JAX `_build_topn_wrapper` on K16's edges:
  a slot with no live row, one with every row live, k above the live rows,
  k past one round of the level kernel, four keys, ties only the row
  position breaks, -0.0 beside +0.0; and, with -2^63 under DESC, against
  numpy's order (the CPU engine's), where the reference's negation wraps
  (its fault 4).
- With recording stubs for the CUDA library: K6's window route passes its
  window rows, their regions and the plane tables by value (on the card
  past K6Params' room), its sorted route runs the offset ids, the planned
  radix passes and the sorted pass with no library sort (its tables on
  the card past K6B_MAX_REDS reductions, however few the regions), and
  K16 runs its
  plan's levels with the keys by value and nothing copied to the card.

Tolerance: counts, integers, extrema and row ids exact (the reference's
extrema compared as floats, so -0.0 equals +0.0 there); f64 sums 1e-12
relative to the sum of magnitudes (another summation order).
"""

from __future__ import annotations

import ctypes
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.proto import expr_column as c, expr_op, expr_value
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import kernels as rk
from tidb_tpu.ops import sched as rsched
from tidb_tpu.sqlast.opcode import Op
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry
from tidb_tpu_torch.ops import _ext
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops import sched as psched

from torch_parity import F64_RTOL, port_identity

I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
CPU = torch.device("cpu")
LIMIT = 232448 - 1088          # the H100's opt-in limit less static memory


# ---------------------------------------------------------------------------
# K6's route and windows
# ---------------------------------------------------------------------------

# (n_red, n_f64, segments a region (groups + sink)); the window route
WINDOW_SHAPES = [
    (8, 0, [10_001] * 8),                       # d_supplier at SF1
    (8, 0, [12_001, 9_001, 1, 10_500]),
    (8, 3, [3_001, 2_901, 3_101, 1]),
    (4, 0, [30_001, 1, 20_001]),
    (9, 2, [4_096]),
    (32, 0, [900, 901]),
    (2, 0, [16_384]),
]


@pytest.mark.parametrize("n_red,n_f,segs", WINDOW_SHAPES)
def test_k6_window_plan_covers_each_region_once(n_red, n_f, segs):
    span = max(pk.bucket_segments(g) for g in segs)
    route, rows, minb, windows = pk.k6_route(n_red, span, LIMIT, n_f, segs)
    assert route == "seg_states_ragged_window"
    assert minb == 1 and rows in pk.K6B_ROWS
    assert 1 <= windows <= pk.K6_MAX_WINDOWS
    # the block route does not hold the span
    assert pk.k6_block_bytes(n_red, n_f, span, min(pk.K6B_ROWS)) > LIMIT
    p_rows, wins, wspan = pk.k6_window_plan(n_red, n_f, segs, LIMIT)
    assert p_rows == rows
    assert pk.k6_block_bytes(n_red, n_f, wspan, rows) <= LIMIT
    for r, g in enumerate(segs):
        mine = [(lo, n) for rr, lo, n in wins if rr == r]
        assert 1 <= len(mine) <= windows
        covered = np.zeros(g, np.int64)
        for lo, n in mine:
            assert n >= 1
            covered[lo:lo + n] += 1
        assert (covered == 1).all(), r
        # windows of one length, the last no longer
        sizes = [n for _lo, n in mine]
        assert all(x == sizes[0] for x in sizes[:-1]) and \
            sizes[-1] <= sizes[0]
    # the table's rows ascend by region, then by first segment
    assert wins == sorted(wins)
    assert wspan == max(n for _r, _lo, n in wins)
    # the most rows a thread on a tie of the windows' count
    for other in pk.K6B_ROWS:
        span_o = (LIMIT - pk.k6_block_bytes(n_red, n_f, 0, other)) \
            // (8 * n_red)
        w_o = max(-(-g // span_o) for g in segs) if span_o >= 1 else 1 << 30
        assert w_o > windows or (w_o == windows and other <= rows)


@pytest.mark.parametrize("n_red,n_f,segs", [
    (8, 0, [60_001, 9_001]),            # 17 windows a region
    (5, 2, [120_001, 60_001]),          # chip_smoke's past-cap edge
    (3, 0, [200_001] * 8),              # d_part at SF1
    (33, 0, [65]),                      # past K6B_MAX_REDS
])
def test_k6_past_the_window_cap_is_the_sorted_route(n_red, n_f, segs):
    span = max(pk.bucket_segments(g) for g in segs)
    assert pk.k6_route(n_red, span, LIMIT, n_f, segs) == (
        "seg_states_ragged_sorted", 0, 0, 0)
    fit = pk.k6_windows(n_red, n_f, segs, LIMIT)
    assert fit is None or fit[1] > pk.K6_MAX_WINDOWS


@pytest.mark.parametrize("W,grid,want", [
    (24, 132, 132), (33, 132, 132), (34, 132, 264), (72, 132, 396),
    (128, 132, 528), (1, 132, 132), (40, 24, 168)])
def test_k6_window_blocks_in_whole_waves(W, grid, want):
    """d_supplier's 24 window rows ride one wave of the card's grid; more
    rows take whole waves, at least K6_WINDOW_BLOCKS blocks a row."""
    got = pk.k6_window_blocks(W, grid)
    assert got == want and got % grid == 0
    assert got >= pk.K6_WINDOW_BLOCKS * W or got == grid
    assert got - grid < pk.K6_WINDOW_BLOCKS * W
    units = pk.k6_block_units([1_000_000] * W, got)
    assert min(units) >= min(pk.K6_WINDOW_BLOCKS, got // W)


def test_k6_routes_and_window_constants():
    assert pk.K6_ROUTES == ("seg_states_ragged_smem",
                            "seg_states_ragged_window",
                            "seg_states_ragged_sorted")
    assert all(name in pk.LAUNCHES for name in pk.K6_ROUTES)
    assert pk.K6_MAX_WINDOWS >= 1
    # the block route is unchanged where a span fits: date_group's and
    # Q1's
    assert pk.k6_route(4, 4096, LIMIT, 0, [2600])[0] == \
        "seg_states_ragged_smem"
    assert pk.k6_route(17, 8, LIMIT, 0, [5])[:3] == (
        "seg_states_ragged_smem", 2, 2)
    # no opt-in memory: neither windows nor the block route
    assert pk.k6_route(8, 16384, 0, 0, [10_001])[0] == \
        "seg_states_ragged_sorted"
    # the windows cover the groups and the sink, not the span's padding:
    # 10,001 segments at 8 reductions need 3 windows where the whole span
    # of 16,384 would need 5
    assert pk.k6_windows(8, 0, [10_001], LIMIT)[1] == 3
    assert pk.k6_windows(8, 0, [16_384], LIMIT)[1] == 5


# ---------------------------------------------------------------------------
# K6's plain version against region_agg_states_batched (d_supplier-like)
# ---------------------------------------------------------------------------

# [(cap, live rows, G)] a region and [(op, "i" / "f" / None, valid?)];
# ("sum", None, False) over the mask is first_row's count
SUPPLIER_REGIONS = [(12_007, 12_001, 3000), (11_003, 10_990, 2900),
                    (13_001, 13_001, 3100), (64, 0, 0)]
SUPPLIER_OPS = [("sum", None, True), ("sum", "i", True), ("min", "i", True),
                ("max", "i", False), ("sum", "f", True), ("min", "f", True),
                ("max", "f", True), ("sum", None, False)]


def _supplier_segs() -> list:
    """(gid, [(op, values or None, contrib)], G, n_rows) per region, numpy:
    NULLs (a contrib that drops a fifth of the rows), int64 planes with
    -2^63 and 2^63 - 1 (sums that wrap) and only -2^63 in group 5, f64
    planes with +-inf, only +inf in group 3 and only -inf in group 4, -0.0
    and +0.0 in groups 1 and 2; rows past the live ones in the sink."""
    rng = np.random.default_rng(17)
    segs = []
    for cap, n, G in SUPPLIER_REGIONS:
        gid = rng.integers(0, G + 1, cap).astype(np.int64)
        gid[n:] = G
        live = np.arange(cap) < n
        specs = []
        for op, kind, nulls in SUPPLIER_OPS:
            contrib = live & (rng.random(cap) > 0.2) if nulls else live
            v = None
            if kind == "f":
                v = rng.integers(-40, 40, cap) * 0.25
                if op != "sum":
                    v[rng.random(cap) < 0.01] = np.inf
                    v[rng.random(cap) < 0.01] = -np.inf
                    zeros = np.isin(gid, [1, 2])
                    v[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5,
                                        -0.0, 0.0)
                    v[gid == 3] = np.inf
                    v[gid == 4] = -np.inf
            elif kind == "i":
                v = rng.integers(-10 ** 6, 10 ** 6, cap).astype(np.int64)
                v[rng.random(cap) < 0.02] = I64_MIN
                v[rng.random(cap) < 0.02] = I64_MAX
                v[gid == 5] = I64_MIN
            specs.append((op, v, contrib))
        segs.append((gid, specs, G, n))
    return segs


def test_k6_plain_matches_jax_at_a_d_supplier_like_shape():
    segs = _supplier_segs()
    Gs = [G for _c, _n, G in SUPPLIER_REGIONS]
    span = max(pk.bucket_segments(G + 1) for G in Gs)
    n_f = sum(kind == "f" for _op, kind, _v in SUPPLIER_OPS)
    # the shape takes the window route on the card
    assert pk.k6_route(len(SUPPLIER_OPS), span, LIMIT, n_f,
                       [G + 1 for G in Gs])[0] == "seg_states_ragged_window"
    want = rk.region_agg_states_batched(
        [(g, [(op, v, cc) for op, v, cc in sp], G) for g, sp, G, _n in segs])
    got = pk.region_agg_states_batched(
        [(g, [(op, None if v is None else torch.from_numpy(v), cc)
              for op, v, cc in sp], G, n) for g, sp, G, n in segs], "cpu")
    for r, (g_r, w_r) in enumerate(zip(got, want)):
        gid, specs, G, _n = segs[r]
        for j, (g, w) in enumerate(zip(g_r, w_r)):
            op, v, cc = specs[j]
            w = np.asarray(port_identity(np.asarray(w)))
            assert g.shape == w.shape == (G,), (r, j)
            if g.dtype == np.float64 and op == "sum":
                mag = np.zeros(G)
                keep = cc & (gid < G)
                np.add.at(mag, gid[keep], np.abs(v[keep]))
                assert (np.abs(g - w) <= F64_RTOL * mag).all(), (r, j)
            elif g.dtype == np.float64:
                assert np.array_equal(g, w), (r, j)     # -0.0 == +0.0 here
            else:
                assert np.array_equal(g, w.astype(g.dtype)), (r, j)


# ---------------------------------------------------------------------------
# K16's plan
# ---------------------------------------------------------------------------

def _k16_plan(slots, n, k, nk, grid):
    """K16's plan: K20's (shard_topk_plan) with one shard a slot over the
    first min(k, n) rows."""
    return pk.shard_topk_plan(slots, n, min(k, n), nk, grid)


@pytest.mark.parametrize("slots,n,k,nk,grid", [
    (32, 16384, 100, 2, 396), (1, 16384, 100, 2, 396),
    (32, 1 << 23, 100, 2, 396), (2, 4096, 5000, 2, 264),
    (3, 4096, 4000, 4, 264), (5, 8192, 7500, 1, 264), (32, 64, 128, 0, 132),
    (40, 1 << 20, 10, 3, 8)])
def test_slot_topn_plan(slots, n, k, nk, grid):
    plan = _k16_plan(slots, n, k, nk, lambda sl: grid)
    kk = min(k, n)
    kmax = pk.topk_max_slots(nk) - pk.K10_STEP
    assert sum(K for K, _s, _l in plan) == kk
    assert len(plan) == -(-kk // kmax)
    for K, p_slots, levels in plan:
        assert 1 <= K <= kmax
        assert p_slots & (p_slots - 1) == 0 and p_slots >= K + pk.K10_STEP
        assert p_slots * (8 * nk + 16) <= pk.K10_SMEM_LIMIT
        # level 1: the card's grid split evenly over the slots
        assert levels[0] == (slots * max(1, grid // slots), 0)
        for (b0, _f0), (b1, fan) in zip(levels, levels[1:]):
            assert b0 % slots == 0 and b1 % slots == 0 and fan >= 2
            assert b1 // slots == -(-(b0 // slots) // fan)
        assert levels[-1][0] == slots
    # the tier's shape: level 1 and one merge level a call
    if (slots, n, k, nk, grid) == (32, 16384, 100, 2, 396):
        assert plan == [(100, 2048, [(384, 0), (32, 327)])]


def test_slot_topn_launches_do_not_grow_with_the_rows():
    def count(n):
        return sum(len(levels) for _K, _s, levels in
                   _k16_plan(32, n, 100, 2, lambda sl: 396))
    assert count(1 << 12) == count(1 << 14) == count(1 << 23) == 2
    # k past one round: one more round of levels
    assert len(_k16_plan(2, 1 << 20, 5000, 2, lambda sl: 264)) == 2


# ---------------------------------------------------------------------------
# slot_topn_plain against the JAX _build_topn_wrapper on K16's edges
# ---------------------------------------------------------------------------

CAP, N = 8192, 8192 - 77
A, F, D, S, E = 1, 2, 3, 4, 5
WORDS = [b"ant", b"bee", b"cat", b"dog", b"eel"]
KINDS = {A: rcol.K_I64, F: rcol.K_F64, D: rcol.K_DEC, S: rcol.K_STR,
         E: rcol.K_I64}


def _batch(int_min: bool = False) -> rcol.ColumnBatch:
    """NULLs in every column but e (small integers, for WHEREs that keep
    every live row or none), +-(2^63 - 1) (and -2^63 with int_min) in a,
    -0.0 beside +0.0 in f, few decimals and five words (ties); live rows
    that are no multiple of 64."""
    rng = np.random.default_rng(29 + int_min)
    live = np.arange(CAP) < N

    def valid(p=0.1):
        return live & (rng.random(CAP) > p)

    a = rng.integers(-60, 60, CAP).astype(np.int64)
    a[::19] = I64_MAX
    a[::23] = -I64_MAX
    if int_min:
        a[::29] = I64_MIN
    f = rng.integers(-8, 8, CAP) * 0.5
    f[::6] = -0.0
    sv = valid()
    cols = {
        A: rcol.ColumnData(rcol.K_I64, a, valid(), tp=rmy.TypeLonglong,
                           max_abs=I64_MAX if not int_min else 1 << 63),
        F: rcol.ColumnData(rcol.K_F64, f, valid(), tp=rmy.TypeDouble),
        D: rcol.ColumnData(rcol.K_DEC, rng.integers(-99, 99, CAP)
                           .astype(np.int64), valid(),
                           tp=rmy.TypeNewDecimal, dec_scale=2, max_abs=99),
        S: rcol.ColumnData(rcol.K_STR, np.where(sv, rng.integers(
            0, len(WORDS), CAP), -1).astype(np.int64), sv, list(WORDS),
            tp=rmy.TypeVarchar),
        E: rcol.ColumnData(rcol.K_I64, rng.integers(-5, 5, CAP)
                           .astype(np.int64), live.copy(),
                           tp=rmy.TypeLonglong, max_abs=5),
    }
    return rcol.ColumnBatch(N, CAP, np.arange(1, CAP + 1, dtype=np.int64),
                            cols)


def _i(v):
    return expr_value(RDatum.i64(v))


def _e_ge(x):
    """e >= x: every live row at x <= -5, none at x > 4."""
    return expr_op(Op.GE, c(E), _i(x))


def _ref_topn(rb, wheres, keys, k):
    """The reference's wrapper: [slots, k + 1] (rows, then the live
    count) for the statements' WHEREs, padded to 8 slots."""
    fn, sig, pis, pfs = None, None, [], []
    for w in wheres:
        lw = rsched._Lowerer(rb)
        f, s = lw.lower(w)
        assert sig is None or s == sig
        fn, sig = f, s
        pis.append(np.asarray(lw.pi, dtype=np.int64))
        pfs.append(np.asarray(lw.pf, dtype=np.float64))
    pi, pf = np.stack(pis), np.stack(pfs)
    kb = 8
    pi = np.concatenate([pi, np.repeat(pi[-1:], kb - len(wheres), 0)])
    pf = np.concatenate([pf, np.repeat(pf[-1:], kb - len(wheres), 0)])
    rkeys = tuple((cid, desc, KINDS[cid]) for cid, desc in keys)
    wrapper = jax.jit(rsched._build_topn_wrapper(fn, rkeys, k))
    planes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
              for cid, cd in rb.columns.items()}
    return np.asarray(wrapper(planes, jnp.asarray(rb.row_mask()),
                              jnp.asarray(pi), jnp.asarray(pf))
                      ).reshape(kb, k + 1)


def _port_topn(rb, wheres, keys, k):
    """The port's plain K14 and K16 on the carried batch: (idx, n_live,
    masks)."""
    pb = carry.batch_from(rb)
    fin, pools = None, []
    for w in wheres:
        lw = psched._Lowerer(pb)
        emit, _sig = lw.lower(carry.expr_from(w))
        f = lw.program(pb, emit)
        assert fin is None or np.array_equal(f.meta, fin.meta)
        fin = f
        pools.append(f.pool)
    planes = pk.batch_planes(pb, CPU)
    words = pk.slot_filter_plain(
        fin, torch.from_numpy(np.stack(pools)),
        [planes[key][w] for key, w in fin.plane_keys], pk.device_live(pb, CPU))
    idx, n_live = pk.slot_topn_plain(
        words, [(planes[cid], desc) for cid, desc in keys], k)
    return idx.numpy(), n_live.numpy(), pk.unpack_slot_words(words).numpy()


def _numpy_topn(rb, mask, keys, k):
    """The SQL order from numpy (the CPU engine's): live first, per key
    its null rank (first ascending, last descending) then its value (-0.0
    == +0.0, exact int64), row position last."""
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


# (WHEREs, keys, k): each a batch of slots in one launch
K16_EDGES = {
    "no live row, every row live": (
        [_e_ge(100), _e_ge(-100), _e_ge(0), _e_ge(100)],
        [(A, True), (F, False)], 100),
    "k above the live rows and past one round": (
        [_e_ge(-100), _e_ge(3), _e_ge(100)],
        [(F, True), (A, False)], 5000),
    "four keys": (
        [expr_op(Op.LE, c(D), _i(x)) for x in (-50, 0, 50)],
        [(S, True), (D, False), (A, True), (F, False)], 128),
    "four keys past one round": (
        [_e_ge(-100), _e_ge(0)],
        [(S, False), (D, True), (F, True), (A, False)], 4000),
    "ties only the row position breaks": (
        [expr_op(Op.GE, c(A), _i(x)) for x in (-40, 0, 30, -I64_MAX)],
        [(S, False)], 3500),
    "-0.0 beside +0.0": (
        [expr_op(Op.GT, c(A), _i(x)) for x in (-10, 10)],
        [(F, False)], 700),
}


@pytest.mark.parametrize("case", sorted(K16_EDGES))
def test_slot_topn_plain_matches_jax_on_k16_edges(case):
    wheres, keys, k = K16_EDGES[case]
    rb = _batch()
    block = _ref_topn(rb, wheres, keys, k)
    idx, n_live, masks = _port_topn(rb, wheres, keys, k)
    assert idx.shape == (len(wheres), min(k, CAP))
    for j in range(len(wheres)):
        nl = int(block[j, k])
        assert int(n_live[j]) == nl == min(k, int(masks[j].sum()))
        np.testing.assert_array_equal(idx[j, :nl],
                                      block[j, :nl].astype(np.int64))
        np.testing.assert_array_equal(idx[j, :nl],
                                      _numpy_topn(rb, masks[j], keys, k))
    lives = [int(m.sum()) for m in masks]
    if case == "no live row, every row live":
        assert lives[0] == lives[3] == 0 and lives[1] == N
    if case.startswith("k above"):
        assert lives[0] == N and min(lives) < k
        assert len(_k16_plan(len(wheres), CAP, k, len(keys),
                                     lambda sl: 264)) > 1


def test_slot_topn_plain_desc_over_int64_min_as_the_cpu_engine():
    """-2^63 under DESC: the reference negates it, -(-2^63) wraps and the
    row sorts first; the port complements the order word and answers as
    numpy (the CPU engine): the minimum sorts last among the valid rows."""
    rb = _batch(int_min=True)
    wheres = [_e_ge(-100), _e_ge(0)]
    keys = [(A, True), (F, False)]
    block = _ref_topn(rb, wheres, keys, CAP)
    idx, n_live, masks = _port_topn(rb, wheres, keys, CAP)
    a = rb.columns[A]
    for j in range(len(wheres)):
        want = _numpy_topn(rb, masks[j], keys, CAP)
        np.testing.assert_array_equal(idx[j, :int(n_live[j])], want)
        assert a.values[int(block[j, 0])] == I64_MIN     # the wrapped key
        assert a.values[want[0]] == I64_MAX
        valid = a.valid[want]
        is_min = valid & (a.values[want] == I64_MIN)
        ranks = np.arange(len(want))
        assert is_min.any()
        assert ranks[valid & ~is_min].max() < ranks[is_min].min()


# ---------------------------------------------------------------------------
# the wrappers drive their launches (recording stubs for the library)
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in for the kernel libraries that records each launch."""

    def __init__(self, grid: int):
        self.calls = []
        self.grid = grid

    def seg_states_block_limit(self):
        return LIMIT

    def seg_states_block_grid(self, rows, minb, smem):
        return self.grid

    def seg_states_pieces_count(self, n):
        return -(-n // 2048)

    def seg_states_window_launch(self, *args):
        # the library copies the tables into the parameter block during
        # the call; so does the recorder
        tables_p, on_card, W, R, n_red = args[3], args[4], args[5], \
            args[6], args[8]
        tab = np.frombuffer(ctypes.string_at(
            tables_p, 8 * (8 * W + 2 * n_red + 2 * n_red * R)),
            np.int64).copy()
        self.calls.append(("window", args, tab))
        return 0

    def seg_states_keys_launch(self, *args):
        self.calls.append(("keys", args, None))
        return 0

    def radix_scratch_ints(self, n):
        return 256 * (-(-n // 2048) + 1)

    def radix_pass_launch(self, *args):
        self.calls.append(("radix", args, None))
        return 0

    def seg_states_sorted_launch(self, *args):
        self.calls.append(("sorted", args, None))
        return 0

    def slot_topn_grid(self, nk, level1, slots):
        return self.grid

    def slot_topn_launch(self, *args):
        n_calls, calls_p, nk, keys_p = args[0], args[1], args[2], args[6]
        rows = np.frombuffer(ctypes.string_at(
            calls_p, 8 * pk.K16_CALL * n_calls), np.int64).reshape(
                n_calls, pk.K16_CALL)
        self.calls.append(("k16", args, (
            rows, ctypes.string_at(keys_p, 32 * max(nk, 1)))))
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    """The wrappers' card path over CPU tensors, with a recording library
    instead of the CUDA one; no library sort and no tensor built from host
    data on any of them."""
    rec = _Recorder(grid=24)
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "_K16_CALLS", {})
    monkeypatch.setattr(pk, "_K20_PLANS", {})
    monkeypatch.setattr(pk, "_K10_GRID", {})
    monkeypatch.setattr(pk, "_K6_LIMIT", {})
    monkeypatch.setattr(pk, "_K6_GRID", {})
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))

    def banned(*a, **kw):
        raise AssertionError("a library sort on the card path")
    for name in ("sort", "argsort", "unique", "unique_consecutive"):
        monkeypatch.setattr(torch, name, banned)
    rec.made = []
    real_tensor = torch.tensor

    def tensor(*a, **kw):
        rec.made.append(a)
        return real_tensor(*a, **kw)
    monkeypatch.setattr(torch, "tensor", tensor)
    return rec


def _k6_args(caps, n_rows, Gs, ops, seed=7):
    rng = np.random.default_rng(seed)
    gid = np.concatenate([np.where(np.arange(cp) < n,
                                   rng.integers(0, G + 1, cp), G)
                          for cp, n, G in zip(caps, n_rows, Gs)])
    contribs = [torch.from_numpy(rng.random(sum(caps)) < 0.8) for _ in ops]
    reds = []
    for cp in caps:
        rr = []
        for op in ops:
            v = None
            if op in pk.F_OPS:
                v = torch.from_numpy(rng.random(cp))
            elif op != pk.R_COUNT:
                v = torch.from_numpy(rng.integers(0, 9, cp))
            rr.append(pk.StatesInput(op, None, v, None))
        reds.append(rr)
    return (torch.from_numpy(gid.astype(np.int64)), list(caps), list(n_rows),
            list(Gs), reds, contribs)


def test_k6_window_route_drives_its_launch(stub_card):
    ops = [pk.R_COUNT, pk.R_SUM_I, pk.R_MAX_I, pk.R_MIN_I, pk.R_COUNT,
           pk.R_SUM_I, pk.R_MAX_I, pk.R_SUM_I]
    caps, n_rows, Gs = [3001, 17, 5000, 4099], [2999, 0, 5000, 4000], \
        [10_000, 0, 12_000, 9_000]
    args = _k6_args(caps, n_rows, Gs, ops)
    launch, out = pk.k6_prepare(*args)
    launch()
    assert pk.LAUNCHES["seg_states_ragged_window"] == 1
    assert sum(pk.LAUNCHES.values()) == 1
    (kind, call, tab), = stub_card.calls
    assert kind == "window"
    (rows, copies, n_blocks, _tp, on_card, W, R, gid_p, n_red, n_f, wspan,
     n_seg, _part, out_p, _st) = call
    segs = [G + 1 for G in Gs]
    p_rows, wins, p_wspan = pk.k6_window_plan(8, 0, segs, LIMIT)
    assert (rows, W, R, n_red, n_f, wspan) == (p_rows, len(wins), 4, 8, 0,
                                               p_wspan)
    assert copies == pk.k4_copies(8, 0, wspan, rows, LIMIT)
    assert on_card == 0 and not stub_card.made      # tables by value
    assert (gid_p, out_p) == (args[0].data_ptr(), out.data_ptr())
    spans = [pk.bucket_segments(s) for s in segs]
    assert n_seg == sum(spans) and out.shape == (8, n_seg)
    bases = np.concatenate([[0], np.cumsum(caps)])
    offs = np.concatenate([[0], np.cumsum(spans)])
    units = pk.k6_block_units([n_rows[r] for r, _lo, _n in wins],
                              pk.k6_window_blocks(len(wins), stub_card.grid))
    assert n_blocks == sum(units)
    wdesc = tab[:6 * W].reshape(W, 6)
    wmap = tab[6 * W:8 * W].reshape(W, 2)
    first = 0
    for i, ((r, lo, n), u) in enumerate(zip(wins, units)):
        assert list(wdesc[i]) == [bases[r], n_rows[r], offs[r] + lo, n,
                                  first, u]
        assert list(wmap[i]) == [r, lo]
        first += u
    red = tab[8 * W:8 * W + 2 * n_red].reshape(n_red, 2)
    assert list(red[:, 0]) == ops
    assert list(red[:, 1]) == [cc.data_ptr() for cc in args[5]]
    vals = tab[8 * W + 2 * n_red:].reshape(2, n_red, R)
    assert vals[0, 1].tolist() == [rr[1].values.data_ptr()
                                   for rr in args[4]]
    assert not vals[0, 0].any() and not vals[1].any()


def test_k6_window_tables_past_the_parameter_block_go_to_the_card(
        stub_card):
    # 12 regions of 12,001 segments at 8 reductions: 4 windows each, 48
    # rows by value; 20 regions: 80 rows, past K6_PARAM_ROWS
    ops = [pk.R_COUNT] * 8
    for R, on_card in ((12, 0), (20, 1)):
        stub_card.calls.clear()
        stub_card.made.clear()
        args = _k6_args([300] * R, [300] * R, [12_000] * R, ops, seed=R)
        launch, _out = pk.k6_prepare(*args)
        launch()
        (kind, call, _t), = stub_card.calls
        assert kind == "window" and call[4] == on_card
        assert call[5] == 4 * R
        assert bool(stub_card.made) == bool(on_card)


def test_k6_sorted_route_runs_the_radix_and_no_library_sort(stub_card):
    ops = [pk.R_COUNT, pk.R_SUM_I, pk.R_MAX_F]
    caps, n_rows, Gs = [700, 900, 0], [700, 850, 0], [300_000, 60_000, 0]
    args = _k6_args(caps, n_rows, Gs, ops)
    launch, out = pk.k6_prepare(*args)
    launch()
    S = sum(pk.bucket_segments(G + 1) for G in Gs)
    plan = pk.radix_plan((1 << (S - 1).bit_length()) - 1, False)
    kinds = [k for k, _c, _t in stub_card.calls]
    assert kinds == ["keys"] + ["radix"] * len(plan) + ["sorted"]
    assert pk.LAUNCHES["seg_states_ragged_sorted"] == 1
    assert pk.LAUNCHES["radix_pass"] == len(plan)
    keys_call = stub_card.calls[0][1]
    (_tp, on_card, R, n_red, n, gid_p, keys_p, _st) = keys_call
    assert (on_card, R, n_red, n, gid_p) == (0, 3, 3, sum(caps),
                                             args[0].data_ptr())
    # the radix passes start from the offset ids, their digits the planned
    # shifts
    radix = [cc for k, cc, _t in stub_card.calls if k == "radix"]
    assert radix[0][4] == keys_p
    assert [cc[1] for cc in radix] == [shift for _src, shift in plan]
    sorted_call = stub_card.calls[-1][1]
    assert sorted_call[0] == sum(caps) and sorted_call[6] == S
    assert sorted_call[-2] == out.data_ptr() and not stub_card.made
    # the chip check's forced routes: the block route where no span fits
    # raises, and so does a route that is none of K6_ROUTES
    with pytest.raises(Exception, match="block route"):
        pk._k6_on_route("seg_states_ragged_smem", *args)
    with pytest.raises(Exception, match="no K6 route"):
        pk._k6_on_route("seg_states_ragged_radix", *args)


@pytest.mark.parametrize("n_red,R,on_card", [
    (33, 1, 1), (33, 7, 1), (40, 2, 1), (32, 1, 0), (32, 7, 0)])
def test_k6_sorted_route_past_the_block_reductions(stub_card, n_red, R,
                                                   on_card):
    """More reductions than K6Params holds by value (K6B_MAX_REDS) take the
    sorted route with every table on the card, however few the regions and
    plane pointers (33 reductions over one region: 66 pointers); up to
    K6B_MAX_REDS over few regions the tables ride by value."""
    ops = [(pk.R_COUNT, pk.R_SUM_I, pk.R_MAX_I, pk.R_MIN_F)[j % 4]
           for j in range(n_red)]
    args = _k6_args([400] * R, [390] * R, [5] * R, ops, seed=n_red + R)
    if n_red <= pk.K6B_MAX_REDS:
        # the same tables as the sorted route would build: the block route
        # is what k6_route takes for these spans
        assert pk.k6_route(n_red, 8, LIMIT, 1, [6] * R)[0] == \
            "seg_states_ragged_smem"
        launch, _out = pk._k6_on_route("seg_states_ragged_sorted", *args)
    else:
        assert pk.k6_route(n_red, 8, LIMIT, 1, [6] * R)[0] == \
            "seg_states_ragged_sorted"
        launch, _out = pk.k6_prepare(*args)
    launch()
    assert pk.LAUNCHES["seg_states_ragged_sorted"] == 1
    keys_call = [c for k, c, _t in stub_card.calls if k == "keys"]
    sorted_call = [c for k, c, _t in stub_card.calls if k == "sorted"]
    assert len(keys_call) == len(sorted_call) == 1
    assert keys_call[0][1] == sorted_call[0][4] == on_card
    assert keys_call[0][3] == sorted_call[0][7] == n_red
    assert bool(stub_card.made) == bool(on_card)
    if on_card:
        # the card's table: R region rows, the reductions, the pointers
        (tab,), = stub_card.made
        assert len(tab) == 6 * R + 2 * n_red + 2 * n_red * R


def test_slot_topn_drives_its_plan(stub_card):
    slots, n, nk, k = 3, 4096, 2, 5000
    stub_card.grid = 264           # 88 level-1 blocks a slot: a merge
    rng = np.random.default_rng(5)
    words = torch.from_numpy(rng.integers(I64_MIN, I64_MAX, (slots, n // 64),
                                          dtype=np.int64))
    keys = [((torch.from_numpy(rng.integers(0, 9, n)),
              torch.ones(n, dtype=torch.bool)), bool(j)) for j in range(nk)]
    plan = _k16_plan(slots, n, k, nk, lambda sl: stub_card.grid)
    assert len(plan) == 2
    idx, n_live = pk.slot_topn(words, keys, k)
    assert idx.shape == (slots, n) and n_live.shape == (slots,)
    assert not stub_card.made                   # nothing built from host data
    want = [(r, i, K, p_slots, levels) for r, (K, p_slots, levels)
            in enumerate(plan) for i in range(len(levels))]
    # one call from the host runs the plan's launches from its table
    (kind, call, (rows, keys_b)), = stub_card.calls
    (n_calls, _tp, c_nk, c_n_slots, c_n, words_p, _kp, _base, idx_p, kk,
     nlive_p, _st) = call
    assert kind == "k16" and (c_nk, c_n_slots, c_n, kk) == (nk, slots, n, n)
    assert words_p == words.data_ptr() and idx_p == idx.data_ptr()
    assert nlive_p == n_live.data_ptr()
    assert pk.LAUNCHES["slot_topn"] == len(want) == n_calls == len(rows)
    assert pk.slot_topn_launch_count(slots, n, k, nk, "cpu") == len(want)
    packed = np.frombuffer(keys_b, np.int64).reshape(-1, 4)
    for j, ((v, ok), desc) in enumerate(keys):
        assert list(packed[j]) == [v.data_ptr(), ok.data_ptr(), 0, int(desc)]
    done, bufs, fixed = 0, set(), set()
    for (r, i, K, p_slots, levels), row in zip(want, rows.tolist()):
        (level1, blocks, c_K, c_slots, in_o, in_lists, fan, out_o, bound_o,
         has_lb, final, idx_off, count_live, live_blocks, live_o) = row
        assert (c_K, c_slots) == (K, p_slots)
        assert (blocks, fan) == levels[i] and level1 == int(i == 0)
        assert has_lb == int(r > 0 and i == 0)
        assert final == int(i == len(levels) - 1)
        assert (out_o == -1) == bool(final)
        assert (in_o == -1) == (i == 0)
        if i:
            assert in_lists == levels[i - 1][0]
        if not final:
            bufs.add(out_o)
        fixed.add((bound_o, live_o))
        assert count_live == int(r == 0 and (i == 0 or final))
        assert live_blocks == levels[0][0] // slots
        assert idx_off == done
        if final:
            done += K
    assert done == n and len(bufs) == 2 and len(fixed) == 1


def test_slot_topn_checks_its_words_on_the_card(stub_card):
    n = 128
    keys = [((torch.zeros(n, dtype=torch.int64),
              torch.ones(n, dtype=torch.bool)), False)]
    with pytest.raises(Exception, match="int64"):
        pk.slot_topn(torch.zeros((2, n // 64), dtype=torch.int32), keys, 4)
    with pytest.raises(Exception, match="at most"):
        pk.slot_topn(torch.zeros((2, n // 64), dtype=torch.int64),
                     keys * 5, 4)
    idx, n_live = pk.slot_topn(torch.zeros((2, n // 64), dtype=torch.int64),
                               keys, 0)
    assert idx.shape == (2, 0) and n_live.tolist() == [0, 0]
    assert not stub_card.calls


def test_old_k16_and_topk_pieces_are_gone():
    csrc = os.path.join(os.path.dirname(pk.__file__), "csrc")
    src = open(os.path.join(csrc, "slot_topn.cu")).read()
    for gone in ("k16_encode", "k16_tiles", "k16_merge", "k16_finish",
                 "topk_tile_sort", "topk_merge_one"):
        assert gone not in src
    assert '#include "topk_level.cuh"' in src
    # the launches' table of one host call: as many fields as _k16_calls
    # packs a launch
    assert "#define K16_CALL %d\n" % pk.K16_CALL in src
    assert not os.path.exists(os.path.join(csrc, "topk.cuh"))
    level = open(os.path.join(csrc, "topk_level.cuh")).read()
    assert "const unsigned* live_words;" in level
    assert "topk_tile_sort" not in level and "topk_merge_one" not in level
    # K6's sorted route sorts with the radix, not a library sort
    body = "".join(inspect.getsource(f) for f in (
        pk.k6_prepare, pk._k6_call, pk._k6_block, pk._k6_window,
        pk._k6_sorted))
    for lib_sort in ("torch.sort", "argsort", "unique", "repeat_interleave"):
        assert lib_sort not in body
    assert "radix_sort_t" in inspect.getsource(pk._k6_sorted)
