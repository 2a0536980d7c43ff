"""K2 (`scalar_agg`) and K10 (`topk_select`) of the port after their
redesign for Hopper.

- The edge inputs that `chip_smoke.py` holds the kernels to on the card,
  at a few thousand rows, through the port's wrappers on CPU tensors (the
  plain versions) against the JAX package's `build_scalar_agg_fn` and
  `build_topn_fn` / `build_topn_fn_multi`, jitted on the CPU as the JAX
  tests run them: planes that start at odd row offsets, n of 1, 15, 17
  and 4099, more reductions than one launch takes, every reduction op
  with constant and never arguments; TopN over tied keys, keys sorted in
  and against the wanted order, k above a step, k at and above the live
  rows. The TopN inputs stay clear of the reference's recorded faults
  (no NULL single keys, no int64 minimum under DESC, no BIGINT key beyond
  2^53; ROADMAP Queue 3) and of its single-key score, which orders -0.0
  before +0.0 (the port holds them equal; `chip_smoke.py` checks that
  case against the plain version).
- The by-value parameter blocks (`struct K2Red`, `struct K10Key`) and the
  constants the wrappers share with the `.cu` sources.
- The host-side plans: K2's launches per reduction count, K10's rounds,
  levels and scratch, and that each wrapper drives its plan (a stub in
  place of the CUDA library records the launches).

Tolerance: counts, integers, extrema and row ids exact; f64 sums 1e-12
relative (the values are multiples of 0.5, so the sums are exact in both
packages whatever the order).
"""

import ctypes
import os
import re

import jax
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


# ---------------------------------------------------------------------------
# K2 against build_scalar_agg_fn
# ---------------------------------------------------------------------------

def _k2_planes(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    iv = rng.integers(-1000, 1000, n).astype(np.int64)
    iv[rng.random(n) < 0.02] = I64_MAX
    iv[rng.random(n) < 0.02] = I64_MIN
    fv = rng.integers(-400, 400, n) * 0.5
    fv[::29] = -0.0
    return {"mask": rng.random(n) < 0.6, "iv": iv, "fv": fv,
            "ok": rng.random(n) > 0.2, "ok2": rng.random(n) > 0.6}


# (name, reduction op, argument: plane names or a constant, NULL constant)
K2_AGGS = [
    ("count", pk.R_COUNT, ("iv", "ok")), ("sum", pk.R_SUM_I, ("iv", "ok")),
    ("sum", pk.R_SUM_F, ("fv", "ok")), ("min", pk.R_MIN_I, ("iv", "ok2")),
    ("max", pk.R_MAX_I, ("iv", "ok")), ("min", pk.R_MIN_F, ("fv", "ok2")),
    ("max", pk.R_MAX_F, ("fv", "ok")), ("first_row", pk.R_FIRST, None),
    ("sum", pk.R_SUM_I, (7, None)), ("sum", pk.R_SUM_I, (-3, "ok2")),
    ("max", pk.R_MAX_I, (3, "never")), ("count", pk.R_COUNT, (1, None)),
    ("sum", pk.R_SUM_F, ("fv", None)), ("min", pk.R_MIN_I, ("iv", None)),
]

# (rows, offset of every plane's first row, copies of K2_AGGS)
K2_CASES = {
    "n 4099": (4099, 0, 1), "views [1:]": (4099, 1, 1),
    "views [3:]": (4099, 3, 1), "n 1": (1, 0, 1), "n 15 at 1": (15, 1, 1),
    "n 17 at 3": (17, 3, 1), "70 reductions": (3001, 1, 5),
}


def _k2_reds(pt: dict, aggs: list) -> list:
    reds = []
    for _name, op, arg in aggs:
        if arg is None:
            reds.append(pk.Red(op))
        elif isinstance(arg[0], int):
            const, valid = arg
            reds.append(pk.Red(op, const_bits=const, never=valid == "never",
                               valid=pt[valid] if valid in pt else None))
        else:
            vals, valid = arg
            reds.append(pk.Red(op, pt[vals],
                               pt[valid] if valid is not None else None))
    return reds


def _k2_specs(js: dict, n: int, aggs: list) -> list:
    specs = []
    for name, _op, arg in aggs:
        if arg is None:
            specs.append(rk.AggSpec(name, None, False))
            continue
        a, b = arg
        if isinstance(a, int):
            v = jnp.int64(a)
            va = jnp.bool_(False) if b == "never" else \
                (js[b] if b is not None else jnp.bool_(True))
        else:
            v = js[a]
            va = js[b] if b is not None else jnp.ones(n, jnp.bool_)
        if name == "count" and isinstance(a, int) and b is None:
            specs.append(rk.AggSpec(name, None, False))    # count(1)
        else:
            specs.append(rk.AggSpec(name, lambda p, v=v, va=va: (v, va),
                                    False))
    return specs


@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_scalar_agg_edges_match_jax(case):
    n, off, copies = K2_CASES[case]
    base = _k2_planes(n + off, seed=len(case))
    aggs = K2_AGGS * copies
    # the port reads views that start `off` rows into their planes
    pt = {k: torch.from_numpy(v)[off:] for k, v in base.items()}
    assert all(t.shape[0] == n for t in pt.values())
    got_n, got_v = pk.scalar_agg(pt["mask"], _k2_reds(pt, aggs))
    js = {k: jnp.asarray(v[off:]) for k, v in base.items()}
    fn = rk.build_scalar_agg_fn(None, _k2_specs(js, n, aggs), n)
    planes = {rk.POS_CID: (jnp.arange(n, dtype=jnp.int64), None)}
    want = [np.asarray(x) for x in port_identity(
        list(jax.jit(fn)(planes, js["mask"])))]
    assert len(got_n) == len(aggs)
    pos = 0
    for r, (name, op, _arg) in enumerate(aggs):
        assert int(got_n[r]) == int(want[pos]), (case, r, name)
        if name == "count":
            pos += 1
            continue
        w = want[pos + 1]
        if op in pk.F_OPS:
            g = float(got_v[r:r + 1].view(torch.float64))
            if op == pk.R_SUM_F:
                assert np.isclose(g, float(w), rtol=F64_RTOL, atol=0.0), \
                    (case, r, g, w)
            else:
                assert g == float(w), (case, r, name, g, w)
        else:
            assert int(got_v[r]) == int(w), (case, r, name)
        pos += 2
    assert pos == len(want)


def test_scalar_agg_repeat_gives_the_same_bits():
    pt = {k: torch.from_numpy(v) for k, v in _k2_planes(5000, 3).items()}
    reds = _k2_reds(pt, K2_AGGS)
    a = pk.scalar_agg(pt["mask"], reds)
    b = pk.scalar_agg(pt["mask"], reds)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# K10 against build_topn_fn / build_topn_fn_multi
# ---------------------------------------------------------------------------

TOPN_ROWS = 4 * 1024 + 13


def _topn_case(case: str):
    """(mask, [(values, valid, desc)], k) as numpy."""
    rng = np.random.default_rng(len(case))
    n = TOPN_ROWS
    live = rng.random(n) > 0.4
    ok = np.ones(n, bool)
    rows = np.arange(n, dtype=np.int64)
    tied = rng.integers(0, 8, n).astype(np.int64)
    price = rng.integers(-10_000, 10_000, n).astype(np.int64)
    half = rng.integers(-50, 50, n) * 0.5
    some = rng.random(n) > 0.1
    sparse = rows % 97 == 7
    if case == "all keys equal":
        return live, [(np.full(n, 5, np.int64), ok, True)], 100
    if case == "k-th first key shared":
        return live, [(tied, ok, True), (half, some, False)], 300
    if case == "sorted in the wanted order":
        return live, [(rows, ok, False)], 10
    if case == "sorted against the wanted order":
        return live, [(rows, ok, True)], 10
    if case == "k above a step":
        return live, [(tied, ok, False), (price, some, True)], 1500
    if case == "k equal to the live rows":
        return sparse, [(price, some, True), (tied, ok, False)], \
            int(sparse.sum())
    if case == "k above the live rows":
        return sparse, [(price, some, False), (tied, ok, True)], 100
    if case == "f64 key with NULLs and ties":
        return live, [(half, some, True), (rows, ok, False)], 700
    raise KeyError(case)


TOPN_CASES = ["all keys equal", "k-th first key shared",
              "sorted in the wanted order", "sorted against the wanted order",
              "k above a step", "k equal to the live rows",
              "k above the live rows", "f64 key with NULLs and ties"]


def _ref_topn(mask, keys, k, off):
    jk = [(jnp.asarray(v[off:]), jnp.asarray(ok[off:]), d)
          for v, ok, d in keys]
    if len(jk) == 1:
        v, ok, d = jk[0]
        fn = rk.build_topn_fn(None, lambda p: (v, ok), d, k)
    else:
        fn = rk.build_topn_fn_multi(
            None, [(lambda p, v=v, ok=ok: (v, ok), d) for v, ok, d in jk], k)
    idx, n_live = jax.jit(fn)({}, jnp.asarray(mask[off:]))
    return np.asarray(idx), int(np.asarray(n_live).reshape(-1)[0])


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("case", TOPN_CASES)
def test_topk_select_edges_match_jax(case, off):
    mask, keys, k = _topn_case(case)
    pkeys = [((torch.from_numpy(v)[off:], torch.from_numpy(ok)[off:]), d)
             for v, ok, d in keys]
    idx, n_live = pk.topk_select(torch.from_numpy(mask)[off:], pkeys, k)
    want, want_live = _ref_topn(mask, keys, k, off)
    assert int(n_live[0]) == want_live == min(k, int(mask[off:].sum()))
    np.testing.assert_array_equal(idx.numpy()[:want_live],
                                  want[:want_live])
    if case == "all keys equal":
        np.testing.assert_array_equal(
            idx.numpy()[:want_live], np.flatnonzero(mask[off:])[:k])


# ---------------------------------------------------------------------------
# the parameter blocks and constants against the .cu sources
# ---------------------------------------------------------------------------

def _struct_fields(src: str, name: str) -> list:
    """(field, bytes) of a C struct of int64 and pointer fields."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for decl in body.split(";"):
        decl = decl.split("//")[0].strip()
        if not decl:
            continue
        m = re.fullmatch(r"(const )?(i64|u64|unsigned char|i64\*|"
                         r"unsigned char\*)\s*(\*?)(\w+)", decl)
        assert m, decl
        ctype = (m.group(2) + m.group(3)).replace(" ", "")
        assert ctype in ("i64", "u64", "i64*", "unsignedchar*"), decl
        fields.append((m.group(4), 8))
    return fields


def _define(src: str, name: str) -> int:
    return int(re.search(r"#define %s (\d+)" % name, src).group(1))


def test_k2_param_block_matches_source():
    src = _source("scalar_agg.cu")
    fields = _struct_fields(src, "K2Red")
    assert [f for f, _s in fields] == list(pk.K2_RED_FIELDS)
    assert all(size == 8 for _f, size in fields)
    assert _define(src, "K2_MAX_REDS") == pk.K2_MAX_REDS
    assert "const __grid_constant__ K2Args" in src
    assert re.search(r"K2Red red\[K2_MAX_REDS\];", src)


def test_k10_param_block_matches_source():
    src = _source("topk_select.cu")
    fields = _struct_fields(src, "K10Key")
    assert [f for f, _s in fields] == list(pk.K10_KEY_FIELDS)
    assert all(size == 8 for _f, size in fields)
    assert _define(src, "K10_MAXK") == pk.TOPN_MAX_KEYS
    assert _define(src, "K10_THREADS") * _define(src, "K10_ROWS") == \
        pk.K10_STEP
    for name in ("K10_MAX_SLOTS", "K10_SMEM_LIMIT", "K10_MERGE_ENTRIES"):
        assert _define(src, name) == getattr(pk, name), name
    assert "const __grid_constant__ K10Args" in src
    # the list buffer layout the plan sizes: words, flags, rows, counts
    assert re.search(r"l\.flag = \(unsigned\*\)\(p \+ 8 \* cap \* nk\);",
                     src)


# ---------------------------------------------------------------------------
# the host-side plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_red", [1, 63, 64, 65, 128, 200])
def test_scalar_agg_chunks(n_red):
    spans = pk.scalar_agg_chunks(n_red)
    assert len(spans) == -(-n_red // pk.K2_MAX_REDS)
    assert spans[0][0] == 0 and spans[-1][1] == n_red
    for (a, b), (c, _d) in zip(spans, spans[1:]):
        assert b == c
    assert all(0 < b - a <= pk.K2_MAX_REDS for a, b in spans)


@pytest.mark.parametrize("nk", [0, 1, 2, 3, 4])
def test_topk_max_slots_fit_shared_memory(nk):
    P = pk.topk_max_slots(nk)
    assert P & (P - 1) == 0 and P <= pk.K10_MAX_SLOTS
    assert P * (8 * nk + 16) <= pk.K10_SMEM_LIMIT
    assert P >= 2 * pk.K10_STEP


@pytest.mark.parametrize("n,k,nk,grid", [
    (8_388_608, 10, 1, 264), (8_388_608, 100, 3, 264),
    (8_388_608, 5000, 3, 132), (4_194_317, 8_000, 4, 132),
    (1, 1, 0, 264), (3_589, 3_589, 4, 12), (70_000, 2_500, 2, 40)])
def test_topk_plan(n, k, nk, grid):
    plan = pk.topk_plan(n, k, nk, lambda slots: grid)
    kmax = pk.topk_max_slots(nk) - pk.K10_STEP
    assert sum(K for K, _s, _l in plan) == k
    assert len(plan) == -(-k // kmax)
    for K, slots, levels in plan:
        assert 1 <= K <= kmax
        assert slots & (slots - 1) == 0 and slots >= K + pk.K10_STEP
        assert slots * (8 * nk + 16) <= pk.K10_SMEM_LIMIT
        assert levels[0] == (min(grid, -(-n // pk.K10_STEP)), 0)
        for (b0, _f0), (b1, fan) in zip(levels, levels[1:]):
            assert fan >= 2 and b1 == -(-b0 // fan)
        assert levels[-1][0] == 1
    scratch = pk.topk_scratch(plan, nk)
    assert list(scratch) == sorted(scratch)
    a, b, bound, live, total = scratch
    for K, _s, levels in plan:
        for i, (blocks, _f) in enumerate(levels[:-1]):
            room = (b - a) if i % 2 == 0 else (bound - b)
            assert room >= blocks * K * (8 * nk + 8) + 4 * blocks
    assert live - bound >= 8 * nk + 12
    assert total - live == 8 * plan[0][2][0][0]


def test_topk_launches_do_not_grow_with_rows():
    count = lambda n: sum(len(levels) for _K, _s, levels in  # noqa: E731
                          pk.topk_plan(n, 100, 3, lambda slots: 264))
    assert count(1 << 20) == count(1 << 23) == count(1 << 30)


class _Recorder:
    """A stand-in for a kernel library that records each launch."""

    def __init__(self, grid: int):
        self.calls = []
        self.grid = grid

    def scalar_agg_grid(self):
        return self.grid

    def scalar_agg_launch(self, *args):
        # the library copies the descriptors into the parameter block
        # during the call; so does the recorder
        n_red, desc_p = args[2], args[3]
        size = 8 * len(pk.K2_RED_FIELDS) * n_red
        self.calls.append(args + (ctypes.string_at(desc_p, size),))
        return 0

    def topk_grid(self, nk, level1, slots):
        return self.grid

    def topk_level_launch(self, *args):
        self.calls.append(args)
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
    monkeypatch.setattr(pk, "_K10_PLANS", {})
    monkeypatch.setattr(pk, "_K10_GRID", {})
    monkeypatch.setattr(pk, "_K2_GRID", {})
    # the process's counts stay as they were: other tests read them
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return rec


def test_scalar_agg_drives_its_launches(stub_card):
    pt = {k: torch.from_numpy(v) for k, v in _k2_planes(3000, 5).items()}
    reds = _k2_reds(pt, K2_AGGS * 5)
    rows = pk._red_rows(reds, 3000, pt["mask"].device)
    before = pk.LAUNCHES["scalar_agg"]
    n, acc = pk.scalar_agg(pt["mask"], reds)
    spans = pk.scalar_agg_chunks(len(reds))
    assert pk.LAUNCHES["scalar_agg"] - before == len(spans) == 2
    assert n.shape == acc.shape == (len(reds),)
    for (a, b), call in zip(spans, stub_card.calls):
        (n_rows, mask_p, n_red, _desc_p, part_p, ticket_p, out_n, out_v,
         grid, _stream, desc) = call
        assert grid == stub_card.grid
        assert (n_rows, mask_p, n_red) == (3000, pt["mask"].data_ptr(), b - a)
        packed = np.frombuffer(desc, np.int64).reshape(n_red, -1)
        np.testing.assert_array_equal(packed, np.array(rows[a:b], np.int64))
        assert part_p == ticket_p + 8
        assert out_n == n.data_ptr() + 8 * a
        assert out_v == acc.data_ptr() + 8 * a


def test_topk_select_drives_its_plan(stub_card):
    n, nk, k = 50_000, 2, 7_000
    rng = np.random.default_rng(9)
    mask = torch.from_numpy(rng.random(n) > 0.5)
    keys = [((torch.from_numpy(rng.integers(0, 9, n)),
              torch.ones(n, dtype=torch.bool)), bool(j)) for j in range(nk)]
    plan = pk.topk_plan(n, k, nk, lambda slots: stub_card.grid)
    assert len(plan) > 1
    before = pk.LAUNCHES["topk_select"]
    idx, n_live = pk.topk_select(mask, keys, k)
    assert idx.shape == (k,) and n_live.shape == (1,)
    want = [(r, i, K, slots, levels) for r, (K, slots, levels)
            in enumerate(plan) for i in range(len(levels))]
    assert pk.LAUNCHES["topk_select"] - before == len(want) == \
        len(stub_card.calls)
    done, bufs = 0, set()
    for (r, i, K, slots, levels), call in zip(want, stub_card.calls):
        (c_nk, level1, blocks, c_K, c_slots, c_n, mask_p, _keys, in_p,
         in_lists, fan, out_p, _bound, has_lb, final, idx_p, idx_off, kk,
         _live, count_live, live_blocks, _nlive, _st) = call
        assert (c_nk, c_K, c_slots, c_n, kk) == (nk, K, slots, n, k)
        assert (blocks, fan) == levels[i] and level1 == int(i == 0)
        assert mask_p == mask.data_ptr() and idx_p == idx.data_ptr()
        assert has_lb == int(r > 0 and i == 0)
        assert final == int(i == len(levels) - 1)
        assert (out_p is None) == bool(final)
        assert (in_p is None) == (i == 0)
        if i:
            assert in_lists == levels[i - 1][0]
        if not final:
            bufs.add(out_p)
        assert count_live == int(r == 0 and (i == 0 or final))
        assert live_blocks == levels[0][0]
        assert idx_off == done
        if final:
            done += K
    assert done == k and len(bufs) == 2
