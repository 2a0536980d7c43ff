"""K20 (`shard_topk`) and K6's block route (`seg_states_ragged`) of the
port after their redesign for Hopper.

- K20's plain version against the JAX package's `build_topn_partial_fn`
  and `build_topn_partial_fn_multi` run per shard, at a few thousand rows
  over 2 and 4 shards: ties across shard boundaries, NULL keys beside
  filtered rows under several keys, shards with no live row or fewer
  than k, k of 1, past a step and the shard length. The inputs stay clear
  of the reference's recorded mesh faults (ROADMAP Queue 3, faults 1-5:
  no NULL single key beside a filtered row, no int64 minimum under DESC,
  no key beyond 2^53), which `test_torch_mesh_kernels.py` pins.
- K6's plain version against the JAX package's
  `region_agg_states_batched` at the shapes the block route takes (spans
  of 512 to 4,096 at 3 or 4 reductions) and over every K6 op: -0.0 beside
  +0.0, groups of only +inf or -inf, the int64 extremes with sums that
  wrap, a region with no row. The reference's f64 extremum identity
  +-F64_MAX is mapped to the port's +-inf (`port_identity`).
- Which zero an extremum keeps on a -0.0 / +0.0 tie: the first in row
  order, in the plain version as in the tile and block routes.
- The host-side pieces: K20's plan (`shard_topk_plan`: launches that do
  not grow with the shard length, rounds for large k, blocks split evenly
  over the shards), K6's route as a pure function of the reductions, the
  span and the card's limit (`k6_route`), the block route's shared memory
  and blocks per region; the by-value parameter block and the constants
  the wrappers share with the `.cu` sources; and, with a recording stub in
  place of the CUDA library, that each wrapper drives the launches its
  plan or route names.

Tolerance: counts, integers, extrema and row ids exact (the reference's
extrema compared as floats, so -0.0 equals +0.0 there); f64 sums 1e-12
relative to the sum of magnitudes (another summation order).
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import kernels as rk

from tidb_tpu_torch.ops import _ext
from tidb_tpu_torch.ops import kernels as pk

from torch_parity import F64_RTOL, port_identity

I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src: str, name: str) -> int:
    return int(re.search(r"#define %s (\d+)" % name, src).group(1))


# ---------------------------------------------------------------------------
# K20's plain version against build_topn_partial_fn / _multi per shard
# ---------------------------------------------------------------------------

K20_ROWS = 4 * 1500


def _k20_case(case: str):
    """(mask, [((values, valid), desc)], shards) as numpy."""
    rng = np.random.default_rng(len(case) + 3)
    n = K20_ROWS
    live = rng.random(n) > 0.35
    ok = np.ones(n, bool)
    rows = np.arange(n, dtype=np.int64)
    tied = rng.integers(0, 5, n).astype(np.int64)
    price = rng.permutation(n).astype(np.int64) - n // 2
    half = rng.integers(-40, 40, n) * 0.25
    some = rng.random(n) > 0.15
    if case == "one key, ties across shards":
        return live, [((np.full(n, 7, np.int64), ok), True)], 4
    if case == "one f64 key":
        return live, [((price / 8.0, ok), False)], 4
    if case == "three keys with NULLs":
        return live, [((tied, some), False), ((half, some), True),
                      ((price, ok), False)], 4
    if case == "a shard without live rows, one with few":
        m = live.copy()
        m[:1500] = False
        m[1500:3000] = rows[1500:3000] % 500 == 3
        return m, [((tied, ok), True), ((price, ok), True)], 4
    if case == "two shards, two keys":
        return live, [((half, ok), True), ((rows, ok), False)], 2
    raise KeyError(case)


K20_CASES = ["one key, ties across shards", "one f64 key",
             "three keys with NULLs",
             "a shard without live rows, one with few",
             "two shards, two keys"]


def _ref_shards(mask, keys: list, k: int, S: int) -> list:
    """The reference's (idx, n_live) per shard."""
    L = len(mask) // S
    exprs = [(lambda p, j=j: (p[2 * j], p[2 * j + 1]), d)
             for j, (_kv, d) in enumerate(keys)]
    if len(keys) == 1:
        fn = rk.build_topn_partial_fn(None, exprs[0][0], exprs[0][1], k)
    else:
        fn = rk.build_topn_partial_fn_multi(None, exprs, k)
    out = []
    for s in range(S):
        sl = slice(s * L, (s + 1) * L)
        planes = []
        for (v, ok), _d in keys:
            planes += [jnp.asarray(v[sl]), jnp.asarray(ok[sl])]
        res = [np.atleast_1d(np.asarray(o))
               for o in fn(planes, jnp.asarray(mask[sl]))]
        out.append((res[0], int(res[2 if len(keys) == 1 else 1][0])))
    return out


@pytest.mark.parametrize("case", K20_CASES)
def test_shard_topk_plain_matches_jax(case):
    mask, keys, S = _k20_case(case)
    L = len(mask) // S
    pkeys = [((torch.from_numpy(v), torch.from_numpy(ok)), d)
             for (v, ok), d in keys]
    for k in (1, 1025, L):
        idx, n_live, words, nulls = pk.shard_topk(torch.from_numpy(mask),
                                                  pkeys, k, S)
        assert idx.shape == (S, k) and words.shape == nulls.shape == \
            (S, len(keys), k)
        for s, (want_idx, want_live) in enumerate(
                _ref_shards(mask, keys, k, S)):
            assert int(n_live[s]) == want_live == min(
                k, int(mask[s * L:(s + 1) * L].sum()))
            np.testing.assert_array_equal(idx[s, :want_live].numpy(),
                                          want_idx[:want_live])
            # each candidate's order words and null ranks
            rows = idx[s] + s * L
            w, f = pk.topk_words_plain(pkeys, rows)
            for j in range(len(keys)):
                assert torch.equal(words[s, j], w[j])
                assert torch.equal(nulls[s, j], f[j])


# ---------------------------------------------------------------------------
# K6's plain version against region_agg_states_batched
# ---------------------------------------------------------------------------

# (case, [(cap, live rows, G)] a region, [(op name, "i" / "f" / None)]);
# ("sum", None) is a count
K6_CASES = {
    "f64 extremes and sums, spans 512 and 4096": (
        [(1500, 1400, 500), (3001, 3001, 3000), (40, 0, 0)],
        [("min", "f"), ("max", "f"), ("sum", "f"), ("sum", None)]),
    "int64 extremes, span 2048": (
        [(2500, 2400, 2000), (900, 899, 600), (17, 17, 3)],
        [("sum", "i"), ("min", "i"), ("max", "i")]),
    "every op, span 1024": (
        [(2000, 1990, 700), (1200, 1000, 900)],
        [("sum", None), ("sum", "i"), ("sum", "f"), ("min", "i"),
         ("max", "i"), ("min", "f"), ("max", "f")]),
}


def _k6_segs(case: str) -> list:
    """(gid, [(op, values or None, contrib)], G, n_rows) per region, numpy:
    f64 planes with -0.0 and +0.0 in groups 1 and 2, only +inf in group 3,
    only -inf in group 4; int64 planes with I64_MAX and I64_MIN, only
    I64_MIN in group 5; rows past the live ones in the sink."""
    regions, ops = K6_CASES[case]
    rng = np.random.default_rng(len(case))
    segs = []
    for cap, n, G in regions:
        gid = rng.integers(0, G + 1, cap).astype(np.int64)
        gid[n:] = G
        live = np.arange(cap) < n
        specs = []
        for op, kind in ops:
            contrib = live & (rng.random(cap) < 0.9)
            if kind == "f":
                v = rng.integers(-20, 20, cap) * 0.25
                if op != "sum":
                    v[rng.random(cap) < 0.02] = np.inf
                    v[rng.random(cap) < 0.02] = -np.inf
                    zeros = np.isin(gid, [1, 2])
                    v[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5,
                                        -0.0, 0.0)
                    v[gid == 3] = np.inf
                    v[gid == 4] = -np.inf
            elif kind == "i":
                v = rng.integers(-1000, 1000, cap).astype(np.int64)
                v[rng.random(cap) < 0.05] = I64_MAX
                v[rng.random(cap) < 0.05] = I64_MIN
                v[gid == 5] = I64_MIN
            else:
                v = None
            specs.append((op, v, contrib))
        segs.append((gid, specs, G, n))
    return segs


def _port_segs(segs: list) -> list:
    return [(g, [(op, None if v is None else torch.from_numpy(v), c)
                 for op, v, c in sp], G, n) for g, sp, G, n in segs]


def _magnitude(v, c, gid, G) -> np.ndarray:
    m = np.zeros(G, np.float64)
    np.add.at(m, gid[c & (gid < G)], np.abs(v[c & (gid < G)]))
    return m


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_seg_states_plain_matches_jax(case):
    segs = _k6_segs(case)
    regions, _ops = K6_CASES[case]
    spans = [pk.bucket_segments(G + 1) for G in (g for _c, _n, g in regions)]
    n_red = len(segs[0][1])
    assert pk.k6_route(n_red, max(spans), pk.K10_SMEM_LIMIT)[0] == \
        "seg_states_ragged_smem"
    want = rk.region_agg_states_batched(
        [(g, [(op, v, c) for op, v, c in sp], G) for g, sp, G, _n in segs])
    got = pk.region_agg_states_batched(_port_segs(segs), "cpu")
    for r, (g_r, w_r) in enumerate(zip(got, want)):
        gid, specs, G, _n = segs[r]
        for j, (g, w) in enumerate(zip(g_r, w_r)):
            op, v, c = specs[j]
            w = np.asarray(port_identity(np.asarray(w)))
            assert g.shape == w.shape == (G,), (r, j)
            if g.dtype == np.float64 and op == "sum":
                tol = F64_RTOL * _magnitude(v, c, gid, G)
                assert (np.abs(g - w) <= tol).all(), (r, j)
            elif g.dtype == np.float64:
                assert np.array_equal(g, w), (r, j)     # -0.0 == +0.0 here
            else:
                assert np.array_equal(g, w.astype(g.dtype)), (r, j)


def test_seg_states_plain_keeps_the_first_zero():
    """An extremum tie of -0.0 and +0.0 keeps the first in row order
    (the plain version's fold order, which the tile and block routes
    keep); sums never end at -0.0."""
    rng = np.random.default_rng(4)
    n, G = 3000, 600
    gid = rng.integers(0, 8, n).astype(np.int64)
    v = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    ok = rng.random(n) < 0.8
    segs = [(gid, [("min", torch.from_numpy(v), ok),
                   ("max", torch.from_numpy(v), ok),
                   ("sum", torch.from_numpy(v), ok)], G, n)]
    mn, mx, sm = pk.region_agg_states_batched(segs, "cpu")[0]
    for s in range(8):
        first = v[np.flatnonzero(ok & (gid == s))[0]]
        assert np.signbit(mn[s]) == np.signbit(first)
        assert np.signbit(mx[s]) == np.signbit(first)
        assert not np.signbit(sm[s])
    assert np.isposinf(mn[8:]).all() and np.isneginf(mx[8:]).all()


# ---------------------------------------------------------------------------
# the host-side plans and routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,k,nk,grid", [
    (8, 10, 1, 264), (8, 100, 3, 264), (8, 5000, 3, 132), (4, 7000, 4, 132),
    (2, 1, 0, 24), (97, 33, 2, 264), (3, 3000, 1, 2)])
def test_shard_topk_plan(S, k, nk, grid):
    L = 1 << 20
    plan = pk.shard_topk_plan(S, L, k, nk, lambda slots: grid)
    kmax = pk.topk_max_slots(nk) - pk.K10_STEP
    assert sum(K for K, _s, _l in plan) == k
    assert len(plan) == -(-k // kmax)
    for K, slots, levels in plan:
        assert 1 <= K <= kmax
        assert slots & (slots - 1) == 0 and slots >= K + pk.K10_STEP
        assert slots * (8 * nk + 16) <= pk.K10_SMEM_LIMIT
        # blocks split evenly over the shards, level 1 the card's grid
        assert levels[0] == (S * max(1, grid // S), 0)
        for (b0, _f0), (b1, fan) in zip(levels, levels[1:]):
            assert b0 % S == 0 and b1 % S == 0 and fan >= 2
            assert b1 // S == -(-(b0 // S) // fan)
        assert levels[-1][0] == S
    a, b, bound, live, total = pk.topk_scratch(plan, nk, S)
    assert a <= b <= bound <= live <= total
    assert live - bound >= S * (8 * nk + 8) + 4 * S     # a bound a shard
    assert total - live == 8 * plan[0][2][0][0]


def test_shard_topk_launches_do_not_grow_with_the_shard_length():
    def count(L):
        return sum(len(levels) for _K, _s, levels in
                   pk.shard_topk_plan(8, L, 100, 3, lambda slots: 264))
    assert count(1 << 10) == count(1 << 20) == count(1 << 29)
    with pytest.raises(Exception, match="outside"):
        pk.shard_topk_plan(8, 50, 100, 1, lambda slots: 264)


LIMIT = 232448 - 1088          # the H100's opt-in limit less static memory


@pytest.mark.parametrize("n_red,span,n_f,want", [
    (4, 64, 0, "seg_states_ragged_smem"), (1, 512, 0,
                                           "seg_states_ragged_smem"),
    (3, 512, 0, "seg_states_ragged_smem"), (4, 4096, 0,
                                            "seg_states_ragged_smem"),
    (4, 4096, 3, "seg_states_ragged_smem"), (3, 2048, 1,
                                             "seg_states_ragged_smem"),
    (8, 16384, 0, "seg_states_ragged_window"),
    (9, 4096, 2, "seg_states_ragged_window"),
    (33, 64, 0, "seg_states_ragged_sorted"),
    (2, 8192, 0, "seg_states_ragged_smem"),
    (2, 16384, 0, "seg_states_ragged_window")])
def test_k6_route(n_red, span, n_f, want):
    route, rows, minb, copies = pk.k6_route(n_red, span, LIMIT, n_f)
    assert route == want
    if route == "seg_states_ragged_smem":
        small = LIMIT // pk.K6B_SMALL_BLOCKS - pk.K6B_SMALL_RESERVE
        fits_small = pk.k6_block_bytes(n_red, n_f, span,
                                       pk.K6B_SMALL_ROWS) <= small
        if fits_small:
            # two blocks an SM, each in half the limit with its copies
            assert (rows, minb) == (pk.K6B_SMALL_ROWS, pk.K6B_SMALL_BLOCKS)
            budget = small
        else:
            assert rows in pk.K6B_ROWS and minb == 1
            bigger = [r for r in pk.K6B_ROWS if r > rows]
            assert all(pk.k6_block_bytes(n_red, n_f, span, r) > LIMIT
                       for r in bigger)
            budget = LIMIT
        assert copies == pk.k4_copies(n_red, n_f, span, rows, budget)
        assert pk.k6_block_bytes(n_red, n_f, span, rows) \
            + 8 * (copies - 1) * n_red * span <= budget
    elif route == "seg_states_ragged_window":
        # past one block: windows of the span, one block an SM, within
        # the cap; the fourth field counts the windows
        assert pk.k6_block_bytes(n_red, n_f, span, min(pk.K6B_ROWS)) > LIMIT
        assert (rows, copies) == pk.k6_windows(n_red, n_f, [span], LIMIT)
        assert minb == 1 and 2 <= copies <= pk.K6_MAX_WINDOWS
    else:
        assert (rows, minb, copies) == (0, 0, 0)
    # no opt-in memory: the block route is never taken
    assert pk.k6_route(n_red, span, 0, n_f)[0] != "seg_states_ragged_smem"


@pytest.mark.parametrize("n_rows,blocks", [
    ([750_000 + r for r in range(8)], 132), ([0, 1, 100_000, 5], 132),
    ([10 ** 6] * 200, 132), ([0, 0], 5), ([3000, 100], 132),
    ([1 << 20] * 8 + [0] * 8, 264)])
def test_k6_block_units(n_rows, blocks):
    units = pk.k6_block_units(n_rows, blocks)
    live = [n for n in n_rows if n]
    assert all((u == 0) == (n == 0) for u, n in zip(units, n_rows))
    assert all(u <= -(-n // pk.K6B_THREADS) for u, n in zip(units, n_rows))
    if len(live) <= blocks:
        assert sum(units) <= blocks
    if live and sum(-(-n // pk.K6B_THREADS) for n in live) >= blocks >= \
            len(live):
        assert sum(units) == blocks
        share = [u / blocks - n / sum(live) for u, n in zip(units, n_rows)]
        assert max(abs(x) for x in share) <= 2 / blocks + len(live) / blocks


# ---------------------------------------------------------------------------
# the parameter block and constants against the .cu sources
# ---------------------------------------------------------------------------

def test_k20_param_block_matches_source():
    src = _source("topk_level.cuh")
    key = re.search(r"struct K10Key \{(.*?)\};", src, re.S).group(1)
    assert [re.search(r"(\w+);", d).group(1) for d in key.split("\n")
            if ";" in d] == list(pk.K10_KEY_FIELDS)
    args = re.search(r"struct K10Args \{(.*?)\};", src, re.S).group(1)
    for field in ("i64 L;", "int shards;", "i64* words;",
                  "unsigned char* nulls;", "K10Key key[K10_MAXK];"):
        assert field in args, field
    assert "const __grid_constant__ K10Args" in src
    assert _define(src, "K10_MAXK") == pk.TOPN_MAX_KEYS
    k20 = _source("shard_topk.cu")
    assert '#include "topk_level.cuh"' in k20
    assert '#include "topk_level.cuh"' in _source("topk_select.cu")
    # no order-word plane, no per-call table: the first design's pieces
    # are gone, and with K16 on the level kernel so is topk.cuh
    assert not os.path.exists(os.path.join(CSRC, "topk.cuh"))
    assert "topk_encode" not in src + k20
    assert "cudaMemcpy" not in k20 and "enc" not in re.findall(r"\w+", k20)


def test_k6_constants_match_source():
    # the block route lives in seg_block.cuh, which K4 shares
    src = _source("seg_states_ragged.cu") + _source("seg_block.cuh")
    assert _define(src, "K6B_SMALL_ROWS") == pk.K6B_SMALL_ROWS
    assert _define(src, "K6B_SMALL_BLOCKS") == pk.K6B_SMALL_BLOCKS
    assert _define(src, "K6B_THREADS") == pk.K6B_THREADS
    assert _define(src, "K6B_MAX_REDS") == pk.K6B_MAX_REDS
    assert _define(src, "K6_PARAM_REGIONS") == pk.K6_PARAM_REGIONS
    assert _define(src, "K6_PARAM_TAB") == pk.K6_PARAM_TAB
    assert _define(src, "K6_PARAM_ROWS") == pk.K6_PARAM_ROWS
    assert _define(src, "K6_WIN") == pk.K6_WIN
    # the per-warp tile route is gone: block, windows and sorted
    assert "seg_states_tiles" not in src and "K6_WARPS" not in src
    assert pk.K6_ROUTES == ("seg_states_ragged_smem",
                            "seg_states_ragged_window",
                            "seg_states_ragged_sorted")
    assert re.search(r"#define K6B_WARPS \(K6B_THREADS / 32\)", src)
    assert pk.K6B_THREADS // 32 == pk.K6B_WARPS
    assert _define(src, "K6_RDESC") == 6
    body = re.search(r"k6b_smem_bytes\(int n_red, int n_f, int span_max, "
                     r"int rows\) \{(.*?)\n\}", src, re.S).group(1)
    compact = re.sub(r"\s+", "", body)
    assert "8LL*n_red*span_max" in compact
    assert "c*(8LL*n_f+8)+8LL*(K6B_WARPS*K6B_WARPS*rows+1)" in compact
    # the block route takes a launch's ROWS from the wrapper's K6B_ROWS
    # (one block an SM) and the small-span instantiation's
    for rows in pk.K6B_ROWS:
        assert f"seg_states_block<{rows}, 1>" in src
    assert "seg_states_block<K6B_SMALL_ROWS, K6B_SMALL_BLOCKS>" in src
    assert "__launch_bounds__(K6B_THREADS, MINB)" in src


# ---------------------------------------------------------------------------
# the wrappers drive their launches (a recording stub for the library)
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in for a kernel library that records each launch."""

    def __init__(self, grid: int):
        self.calls = []
        self.grid = grid

    def shard_topk_grid(self, nk, level1, slots):
        return self.grid

    def shard_topk_level_launch(self, *args):
        # the library copies the key descriptors into the parameter block
        # during the call; so does the recorder
        nk, keys_p = args[0], args[8]
        self.calls.append(("k20", args,
                           ctypes.string_at(keys_p, 32 * max(nk, 1))))
        return 0

    def seg_states_block_limit(self):
        return LIMIT

    def seg_states_block_grid(self, rows, minb, smem):
        return self.grid

    def seg_states_pieces_count(self, n):
        return -(-n // 2048)

    def seg_states_block_launch(self, *args):
        # the library copies the tables into the parameter block during
        # the call; so does the recorder
        tables_p, R, n_red = args[4], args[6], args[8]
        self.calls.append(("block", args, np.frombuffer(ctypes.string_at(
            tables_p, 8 * (6 * R + 2 * n_red + 2 * n_red * R)),
            np.int64).copy()))
        return 0

    def seg_states_window_launch(self, *args):
        tables_p, W, R, n_red = args[3], args[5], args[6], args[8]
        self.calls.append(("window", args, np.frombuffer(ctypes.string_at(
            tables_p, 8 * (8 * W + 2 * n_red + 2 * n_red * R)),
            np.int64).copy()))
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


@pytest.fixture
def stub_card(monkeypatch):
    """The wrappers' card path over CPU tensors, with a recording library
    instead of the CUDA one."""
    rec = _Recorder(grid=24)
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "_K20_PLANS", {})
    monkeypatch.setattr(pk, "_K10_GRID", {})
    monkeypatch.setattr(pk, "_K6_LIMIT", {})
    monkeypatch.setattr(pk, "_K6_GRID", {})
    # the process's counts stay as they were: other tests read them
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return rec


def test_shard_topk_drives_its_plan(stub_card):
    S, L, nk, k = 4, 12_500, 2, 7_000
    stub_card.grid = 264           # 66 level-1 blocks a shard: two merges
    rng = np.random.default_rng(9)
    mask = torch.from_numpy(rng.random(S * L) > 0.5)
    keys = [((torch.from_numpy(rng.integers(0, 9, S * L)),
              torch.ones(S * L, dtype=torch.bool)), bool(j))
            for j in range(nk)]
    plan = pk.shard_topk_plan(S, L, k, nk, lambda slots: stub_card.grid)
    assert len(plan) > 1
    idx, n_live, words, nulls = pk.shard_topk(mask, keys, k, S)
    assert idx.shape == (S, k) and n_live.shape == (S,)
    assert words.shape == nulls.shape == (S, nk, k)
    want = [(r, i, K, slots, levels) for r, (K, slots, levels)
            in enumerate(plan) for i in range(len(levels))]
    assert pk.LAUNCHES["shard_topk"] == len(want) == len(stub_card.calls)
    assert pk.shard_topk_launch_count(S, L, k, nk, "cpu") == len(want)
    done, bufs = 0, set()
    for (r, i, K, slots, levels), (_kind, call, keys_b) in zip(
            want, stub_card.calls):
        (c_nk, level1, blocks, c_K, c_slots, c_S, c_L, mask_p, _keys, in_p,
         in_lists, fan, out_p, _bound, has_lb, final, idx_p, words_p,
         nulls_p, idx_off, kk, _live, count_live, live_blocks, nlive_p,
         _st) = call
        assert (c_nk, c_K, c_slots, c_S, c_L, kk) == (nk, K, slots, S, L, k)
        assert (blocks, fan) == levels[i] and level1 == int(i == 0)
        assert mask_p == mask.data_ptr() and idx_p == idx.data_ptr()
        assert words_p == words.data_ptr() and nulls_p == nulls.data_ptr()
        assert nlive_p == n_live.data_ptr()
        assert has_lb == int(r > 0 and i == 0)
        assert final == int(i == len(levels) - 1)
        assert (out_p is None) == bool(final)
        assert (in_p is None) == (i == 0)
        if i:
            assert in_lists == levels[i - 1][0]
        if not final:
            bufs.add(out_p)
        assert count_live == int(r == 0 and (i == 0 or final))
        assert live_blocks == levels[0][0] // S
        assert idx_off == done
        packed = np.frombuffer(keys_b, np.int64).reshape(-1, 4)
        for j, ((v, ok), desc) in enumerate(keys):
            assert list(packed[j]) == [v.data_ptr(), ok.data_ptr(), 0,
                                       int(desc)]
        if final:
            done += K
    assert done == k and len(bufs) == 2


def test_shard_topk_without_keys_passes_its_buffers(stub_card):
    mask = torch.ones(4 * 100, dtype=torch.bool)
    idx, n_live, words, nulls = pk.shard_topk(mask, [], 5, 4)
    assert words.shape == nulls.shape == (4, 0, 5)
    for _kind, call, _k in stub_card.calls:
        assert call[17] and call[18]          # words and nulls non-null


def _k6_args(caps, n_rows, Gs, ops):
    rng = np.random.default_rng(7)
    gid = np.concatenate([np.where(np.arange(c) < n, rng.integers(0, G + 1, c),
                                   G) for c, n, G in zip(caps, n_rows, Gs)])
    reds, contribs = [], []
    for j, op in enumerate(ops):
        contribs.append(torch.from_numpy(rng.random(sum(caps)) < 0.8))
    for r, c in enumerate(caps):
        rr = []
        for j, op in enumerate(ops):
            v = None
            if op in pk.F_OPS:
                v = torch.from_numpy(rng.random(c))
            elif op != pk.R_COUNT:
                v = torch.from_numpy(rng.integers(0, 9, c))
            rr.append(pk.StatesInput(op, None, v, None))
        reds.append(rr)
    return (torch.from_numpy(gid.astype(np.int64)), list(caps), list(n_rows),
            list(Gs), reds, contribs)


def test_seg_states_block_route_drives_its_launch(stub_card):
    ops = [pk.R_COUNT, pk.R_SUM_I, pk.R_MAX_F, pk.R_SUM_F]
    caps, n_rows, Gs = [3001, 17, 5000, 4099], [2999, 0, 5000, 1], \
        [2526, 0, 3000, 9]
    args = _k6_args(caps, n_rows, Gs, ops)
    launch, out = pk.k6_prepare(*args)
    launch()
    assert pk.LAUNCHES["seg_states_ragged_smem"] == 1
    assert sum(pk.LAUNCHES.values()) == 1
    (kind, call, tables), = stub_card.calls
    assert kind == "block"
    (rows, minb, copies, n_blocks, _tab, on_card, R, gid_p, n_red, n_f,
     span_max, n_seg, _part, out_p, _st) = call
    spans = [pk.bucket_segments(G + 1) for G in Gs]
    assert (R, n_red, n_f, span_max) == (4, 4, 2, max(spans))
    assert (rows, minb, copies) == pk.k6_route(4, max(spans), LIMIT, 2)[1:]
    assert on_card == 0                       # the tables ride by value
    assert (gid_p, out_p) == (args[0].data_ptr(), out.data_ptr())
    rdesc = tables[:6 * R].reshape(R, 6)
    red = tables[6 * R:6 * R + 2 * n_red].reshape(n_red, 2)
    assert list(red[:, 0]) == ops
    assert list(red[:, 1]) == [c.data_ptr() for c in args[5]]
    assert n_seg == sum(spans) and out.shape == (4, n_seg)
    units = pk.k6_block_units(n_rows, stub_card.grid)
    assert n_blocks == sum(units)
    bases = np.concatenate([[0], np.cumsum(caps)])
    offs = np.concatenate([[0], np.cumsum(spans)])
    first = np.concatenate([[0], np.cumsum(units)])
    for r in range(R):
        assert list(rdesc[r]) == [bases[r], n_rows[r], offs[r], spans[r],
                                  first[r], units[r]]


@pytest.mark.parametrize("ops,Gs,route", [
    ([pk.R_COUNT, pk.R_SUM_I], [9, 40], "block"),
    ([pk.R_COUNT] * 8, [12_000, 9_000], "window"),
    ([pk.R_COUNT] * 8, [60_000, 9_000], "sorted")])
def test_seg_states_other_routes_drive_their_launch(stub_card, ops, Gs,
                                                    route):
    # small spans, which the per-warp tile route took, ride the block
    # route; spans past one block windows, and past the windows' cap the
    # radix sort and the sorted pass
    args = _k6_args([700, 900], [700, 850], Gs, ops)
    launch, _out = pk.k6_prepare(*args)
    launch()
    kinds = [kind for kind, _c, _r in stub_card.calls]
    name = {"block": "seg_states_ragged_smem",
            "window": "seg_states_ragged_window",
            "sorted": "seg_states_ragged_sorted"}[route]
    if route == "sorted":
        S = sum(pk.bucket_segments(G + 1) for G in Gs)
        passes = len(pk.radix_plan((1 << (S - 1).bit_length()) - 1, False))
        assert kinds == ["keys"] + ["radix"] * passes + ["sorted"]
        assert pk.LAUNCHES["radix_pass"] == passes
        assert sum(pk.LAUNCHES.values()) == 1 + passes
    else:
        assert kinds == [route]
        assert sum(pk.LAUNCHES.values()) == 1
    assert pk.LAUNCHES[name] == 1
