"""K17 (`sort_perm`) and K9 (`distinct_runs`) of the port after their
redesign for Hopper: K17 on `radix.cuh` over packed composite words, K9
over K17's sorted words, and no library sort on the DISTINCT and ranked
card paths.

- `sort_plan` and the composite pack (`sort_pack_plain`, the plain form
  of the pack launch) against `np.lexsort` on mixed int64 / f64 / int32 /
  int8 / uint8 / bool planes, seeded and drawn by hypothesis: int64
  extremes, -0.0 beside +0.0, NaN and +-inf, widths summing to 63, 64
  and 65, a 64-bit plane, constant planes, n of 0, 1 and 2; and the plan
  as a pure function (widths, no plane split, fewest words, passes).
- K9's sorted-word mode in its plain form against `distinct_runs_plain`
  on the same sort, and the DISTINCT route (one composite word, so the
  sorted-word mode) against the JAX package's `_distinct_reduce` and
  `_grouped_distinct` on the same inputs.
- With a recording stub in place of the CUDA libraries (summary, pack,
  radix passes and K9 done in numpy): K17 drives one summary, one pack a
  composite word and the planned passes, its permutation equal to
  `np.lexsort`, its one-word variant handing back the sorted words, and
  past its row limit it splits and still equals `np.lexsort`;
  `kernels.lexsort` on the card equals `lexsort_plain` (the chained
  `torch.sort`), and `distinct_sort` takes K9's sorted-word mode where
  one word holds its planes; no `torch.sort`, `argsort` or `unique` runs.
- The constants the wrappers share with `sort_perm.cu` and
  `distinct_runs.cu`.

Tolerance: exact throughout (permutations, words, run openers; the f64
distinct sums are of multiples of 0.25, so exact in any order).
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
from hypothesis import given, settings, strategies as st

from tidb_tpu.ops import kernels as rk

from tidb_tpu_torch.ops import _ext
from tidb_tpu_torch.ops import kernels as pk

I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
U64 = (1 << 64) - 1
SIGN = np.uint64(1 << 63)
CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
NP_DTYPES = {0: np.int64, 1: np.float64, 2: np.int32, 3: np.int8,
             4: np.uint8}


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _t(planes: list) -> list:
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]


def _plan_sort(planes: list) -> tuple:
    """The plan's LSD sort in plain form: per composite word, least
    significant first, its packed words through the permutation so far,
    sorted stably. Returns (perm, plan, the last word in sorted order)."""
    ts = _t(planes)
    n = len(planes[0])
    plan = pk.sort_plan(pk.sort_summary_plain(ts))
    perm = np.arange(n)
    w = None
    for fields, _varying, _passes in plan:
        w = pk.sort_pack_plain(ts, fields, torch.from_numpy(perm)).numpy()
        order = np.argsort(w, kind="stable")
        perm, w = perm[order], w[order]
    return perm, plan, w


def _edge_planes(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    ext = np.array([I64_MIN, I64_MAX, 0, -1, 1], np.int64)
    f = np.array([-0.0, 0.0, 1.5, np.nan, -np.inf, np.inf, -2.0, 5e-324],
                 np.float64)
    return [~rng.choice(ext, n), (rng.random(n) < 0.2).astype(np.int8),
            rng.choice(f, n), rng.integers(-2, 2, n).astype(np.int32),
            rng.choice(ext, n), np.ones(n, np.int8),
            (rng.random(n) < 0.5).astype(np.uint8),
            rng.random(n) < 0.3]


def _width_planes(widths: list, n: int, seed: int) -> list:
    """Planes whose order words vary in exactly their low `w` bits (a row
    of zeros and a row of all w bits set in each)."""
    rng = np.random.default_rng(seed)
    out = []
    for w in widths:
        if w == 64:
            p = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64,
                             endpoint=True)
            p[0], p[1] = I64_MIN, I64_MAX
        else:
            p = rng.integers(0, 1 << w, n, dtype=np.uint64).view(np.int64) \
                if w == 63 else rng.integers(0, 1 << w, n).astype(np.int64)
            p[0], p[1] = 0, (1 << w) - 1
        out.append(p)
    return out


# ---------------------------------------------------------------------------
# sort_plan and the composite pack against np.lexsort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 33, 2048, 2049, 5000])
def test_plan_sort_edges_vs_lexsort(n):
    planes = _edge_planes(n, seed=n)
    perm, _plan, _w = _plan_sort(planes)
    assert np.array_equal(perm, np.lexsort(planes) if n else perm)
    got, words, _p, _pairs = pk.sort_perm_words(_t(planes), n)
    assert np.array_equal(got.numpy(), np.lexsort(planes) if n else got)


@pytest.mark.parametrize("widths, n_words", [
    ([31, 32], 1), ([40, 24], 1), ([20, 20, 25], 2), ([64], 1),
    ([1, 64, 1], 3), ([33, 32], 2), ([63, 1], 1), ([7, 64, 63], 3)],
    ids=["63", "64", "65", "a 64-bit plane", "64 between flags",
         "65 in two", "63 + 1", "three words"])
def test_plan_widths_vs_lexsort(widths, n_words):
    planes = _width_planes(widths, 3000, seed=sum(widths))
    perm, plan, _w = _plan_sort(planes)
    assert np.array_equal(perm, np.lexsort(planes))
    assert len(plan) == n_words
    assert [w for fields, _v, _p in plan for _j, _s, w in fields] == widths


def test_constant_planes_drop_out():
    n = 4000
    rng = np.random.default_rng(3)
    planes = [np.full(n, 7, np.int64), rng.integers(0, 100, n),
              np.zeros(n, np.int8), np.full(n, -0.0), np.full(n, 0.0),
              np.ones(n, bool)]
    planes[3][::2] = 0.0                # -0.0 and +0.0: one value
    perm, plan, _w = _plan_sort(planes)
    assert np.array_equal(perm, np.lexsort(planes))
    (fields, _v, passes), = plan
    assert [j for j, _s, _w in fields] == [1] and len(passes) == 1
    # every plane constant: no word, the input order
    tied = [np.full(n, 5, np.int64), np.ones(n, np.uint8)]
    perm, plan, _w = _plan_sort(tied)
    assert plan == [] and np.array_equal(perm, np.arange(n))
    got, words, plan, _pairs = pk.sort_perm_words(_t(tied), n)
    assert np.array_equal(got.numpy(), np.arange(n))
    assert torch.equal(words, torch.full((n,), I64_MIN))


def test_signed_zeros_nan_and_infinities():
    v = np.array([0.0, -0.0, np.nan, 0.0, -np.nan, -0.0, np.inf, -np.inf,
                  5e-324, -5e-324], np.float64)
    g = np.array([1, 1, 0, 0, 1, 0, 1, 0, 1, 0], np.int64)
    for planes in ([v], [v, g], [g, v]):
        perm, _plan, _w = _plan_sort(planes)
        assert np.array_equal(perm, np.lexsort(planes))


_DTYPES = st.sampled_from(["i64", "i64 extremes", "f64", "i32", "i8", "u8",
                           "bool", "narrow"])


def _draw_plane(kind: str, n: int, rng) -> np.ndarray:
    if kind == "i64":
        return rng.integers(-(1 << 40), 1 << 40, n)
    if kind == "i64 extremes":
        return rng.choice(np.array([I64_MIN, I64_MAX, -1, 0, 1]), n)
    if kind == "f64":
        return rng.choice(np.array([-0.0, 0.0, np.nan, np.inf, -np.inf,
                                    1.5, -2.25, 1e300]), n)
    if kind == "i32":
        return rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    if kind == "i8":
        return rng.integers(-128, 128, n).astype(np.int8)
    if kind == "u8":
        return rng.integers(0, 256, n).astype(np.uint8)
    if kind == "bool":
        return rng.random(n) < 0.5
    return rng.integers(0, 5, n).astype(np.int64)


@settings(max_examples=60, deadline=None)
@given(kinds=st.lists(_DTYPES, min_size=1, max_size=6),
       n=st.integers(0, 300), seed=st.integers(0, 2 ** 31))
def test_plan_sort_drawn_planes_vs_lexsort(kinds, n, seed):
    rng = np.random.default_rng(seed)
    planes = [_draw_plane(k, n, rng) for k in kinds]
    perm, plan, _w = _plan_sort(planes)
    if n:
        assert np.array_equal(perm, np.lexsort(planes))
    got, _words, _plan, _pairs = pk.sort_perm_words(_t(planes), n)
    assert np.array_equal(got.numpy(), perm)


@settings(max_examples=200, deadline=None)
@given(pairs=st.lists(st.tuples(st.integers(0, U64), st.integers(0, U64)),
                      max_size=12))
def test_sort_plan_is_a_tight_packing(pairs):
    plan = pk.sort_plan(pairs)
    width = {j: ((a ^ o) & U64).bit_length() for j, (a, o) in
             enumerate(pairs)}
    kept = [j for j in range(len(pairs)) if width[j]]
    # every kept plane once, least significant first across the words
    order = [j for fields, _v, _p in plan for j, _s, _w in fields]
    assert order == kept
    for fields, varying, passes in plan:
        shift = 0
        for j, s, w in fields:
            assert (s, w) == (shift, width[j])
            shift += w
        assert shift <= 64
        assert varying == sum(((pairs[j][0] ^ pairs[j][1]) & U64) << s
                              for j, s, _w in fields)
        assert passes == pk.radix_plan(varying, False) and passes
    # fewest words: no word could take the next word's least significant
    # plane (the greedy packing from the most significant end)
    for lo, hi in zip(plan, plan[1:]):
        used = sum(w for _j, _s, w in hi[0])
        assert used + lo[0][-1][2] > 64


# ---------------------------------------------------------------------------
# K9's sorted-word mode against the gather mode and the JAX package
# ---------------------------------------------------------------------------

def _distinct_case(seed: int, n: int, grouped: bool, p: float = 0.7,
                   floats: bool = False):
    rng = np.random.default_rng(seed)
    if floats:
        v = rng.integers(0, 40, n) * 0.25
        v[::7] = -0.0
        v[::11] = 0.0
    else:
        v = rng.integers(0, 1 << 20, n).astype(np.int64)
        v[::5] = v[0]
    contrib = rng.random(n) < p
    gid = rng.integers(0, 12, n).astype(np.int64) if grouped else None
    return v, contrib, gid


@pytest.mark.parametrize("grouped", [False, True], ids=["scalar", "grouped"])
@pytest.mark.parametrize("p", [0.7, 0.0, 1.0])
@pytest.mark.parametrize("floats", [False, True], ids=["int64", "f64"])
def test_sorted_word_mode_equals_gather_mode(grouped, p, floats):
    v, contrib, gid = _distinct_case(11, 3000, grouped, p, floats)
    tv, tc = torch.from_numpy(v), torch.from_numpy(contrib)
    tg = None if gid is None else torch.from_numpy(gid)
    perm, key, gid_s, words = pk.distinct_sort(tv, tc, tg)
    got = pk.distinct_runs(perm, key, tc, gid_s, words)
    want = pk.distinct_runs_plain(perm, key, tc, gid_s)
    assert torch.equal(got, want)
    if floats and grouped:
        # the doubles' 63 bits and 4 bits of group: two words
        assert words is None
        return
    assert words is not None              # one composite word
    w, flag = words
    if p in (0.0, 1.0):
        assert flag == (pk.K9_NONE if p == 0.0 else pk.K9_ALL)
    else:
        assert flag >= 0
    assert torch.equal(pk.distinct_runs_words_plain(perm, w, flag), want)
    # the same rows in lexsort_plain's order: the same openers
    perm2, _l = pk.lexsort_plain([key, (~tc).to(torch.uint8)]
                                 + ([tg] if tg is not None else []))
    assert torch.equal(perm, perm2)


def test_two_word_plan_takes_the_gather_mode():
    rng = np.random.default_rng(2)
    n = 2000
    v = rng.standard_normal(n) * 1e6          # all 64 bits vary
    contrib = torch.from_numpy(rng.random(n) < 0.6)
    gid = torch.from_numpy(rng.integers(0, 5, n).astype(np.int64))
    perm, key, gid_s, words = pk.distinct_sort(torch.from_numpy(v), contrib,
                                               gid)
    assert words is None
    assert torch.equal(pk.distinct_runs(perm, key, contrib, gid_s),
                       pk.distinct_runs_plain(perm, key, contrib, gid_s))


def _port_distinct(v, contrib, gid, S, name):
    arg = type("Arg", (), dict(const=None, cid=1, reg=None,
                               dt="f" if v.dtype == np.float64 else "i"))
    spec = pk.AggSpec(name, arg, True)
    planes = {1: (torch.from_numpy(v), torch.ones(len(v), dtype=torch.bool))}
    g = None if gid is None else torch.from_numpy(gid)
    return pk.distinct_totals(spec, planes, {}, torch.from_numpy(contrib), g,
                              S)


@pytest.mark.parametrize("floats", [False, True], ids=["int64", "f64"])
def test_sorted_word_distinct_matches_jax(floats):
    v, contrib, _g = _distinct_case(5, 2500, False, floats=floats)
    assert pk.distinct_sort(torch.from_numpy(v), torch.from_numpy(contrib)
                            )[3] is not None
    cnt, vsum = jax.jit(rk._distinct_reduce)(jnp.asarray(v),
                                             jnp.asarray(contrib))
    n, s = _port_distinct(v, contrib, None, 0, "sum")
    assert int(n) == int(cnt)
    assert float(s) == float(vsum)


@pytest.mark.parametrize("floats", [False, True], ids=["int64", "f64"])
def test_sorted_word_grouped_distinct_matches_jax(floats):
    v, contrib, gid = _distinct_case(6, 2500, True, floats=floats)
    gid[~contrib & (np.arange(len(gid)) % 2 == 0)] = 12      # the sink
    S = 13
    cnt, vsum = jax.jit(rk._grouped_distinct, static_argnums=3)(
        jnp.asarray(v), jnp.asarray(contrib), jnp.asarray(gid), S)
    n, s = _port_distinct(v, contrib, gid, S, "sum")
    np.testing.assert_array_equal(np.asarray(n, np.int64),
                                  np.asarray(cnt, np.int64))
    np.testing.assert_array_equal(np.asarray(s, np.float64),
                                  np.asarray(vsum, np.float64))


# ---------------------------------------------------------------------------
# the card path over a recording stub
# ---------------------------------------------------------------------------

def _arr(ptr: int, n: int, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    raw = (ctypes.c_uint8 * max(n * dtype.itemsize, 1)).from_address(ptr)
    return np.frombuffer(raw, dtype=dtype, count=n)


def _wr(ptr: int, values: np.ndarray) -> None:
    ctypes.memmove(ptr, np.ascontiguousarray(values).ctypes.data,
                   values.nbytes)


def _np_words(a: np.ndarray, code: int) -> np.ndarray:
    """sort_perm.cu's k17_word in numpy: the unsigned order words."""
    if code == 4:
        return a.astype(np.uint64) ^ SIGN
    if code != 1:
        return a.astype(np.int64).view(np.uint64) ^ SIGN
    b = a.view(np.uint64)
    w = np.where((b & SIGN) != 0, ~b, b ^ SIGN)
    w = np.where(a == 0.0, SIGN, w)
    return np.where(np.isnan(a), np.uint64(0xFFF0000000000001), w)


class _Recorder:
    """A stand-in for the kernel libraries: records each launch and does
    K17's summary and pack, each radix pass and K9 in numpy."""

    def __init__(self):
        self.calls = []

    def sort_perm_summary_launch(self, n, k, planes, dtypes, _sum, host, _s):
        out = []
        for j in range(k):
            w = _np_words(_arr(planes[j], n, NP_DTYPES[dtypes[j]]),
                          dtypes[j])
            out += [~np.bitwise_and.reduce(w), np.bitwise_or.reduce(w)]
        _wr(host, np.array(out, np.uint64))
        self.calls.append(("summary", (n, k)))
        return 0

    def sort_perm_pack_launch(self, n, nf, planes, dtypes, shifts, masks,
                              perm, out, _s):
        rows = _arr(perm, n, np.int64) if perm else np.arange(n)
        c = np.zeros(n, np.uint64)
        for f in range(nf):
            src = _arr(planes[f], 1 + int(rows.max()),
                       NP_DTYPES[dtypes[f]])
            c |= (_np_words(src, dtypes[f])[rows] & np.uint64(masks[f])) \
                << np.uint64(shifts[f])
        _wr(out, (c ^ SIGN).view(np.int64))
        self.calls.append(("pack", (n, nf, perm, out)))
        return 0

    def radix_scratch_ints(self, n):
        return (1 << pk.RADIX_BITS) * (-(-n // pk.RADIX_TILE) + 1)

    def radix_pass_launch(self, n, shift, off_p, _P, k_in, p_in, k_out,
                          p_out, _counts, _st):
        assert not off_p
        keys = _arr(k_in, n, np.int64).copy()
        pay = _arr(p_in, n, np.int64).copy() if p_in else np.arange(n)
        d = ((keys.view(np.uint64) ^ SIGN) >> np.uint64(shift)) \
            & np.uint64((1 << pk.RADIX_BITS) - 1)
        order = np.argsort(d, kind="stable")
        _wr(k_out, keys[order])
        _wr(p_out, pay[order])
        self.calls.append(("radix", (n, shift, k_in, p_in, k_out, p_out)))
        return 0

    def distinct_runs_words_launch(self, n, perm, words, flag, firsts, _s):
        w = _arr(words, n, np.int64)
        if flag >= 0:
            c = (((w.view(np.uint64) ^ SIGN) >> np.uint64(flag))
                 & np.uint64(1)) == 0
        else:
            c = np.full(n, flag == pk.K9_ALL)
        f = c & np.r_[True, w[1:] != w[:-1]]
        out = np.zeros(n, np.uint8)
        out[_arr(perm, n, np.int64)] = f
        _wr(firsts, out)
        self.calls.append(("k9 words", (n, flag)))
        return 0

    def distinct_runs_launch(self, n, perm, key, contrib, gid_s, firsts, _s):
        p = _arr(perm, n, np.int64)
        ks = _arr(key, n, np.int64)[p]
        new = np.r_[True, ks[1:] != ks[:-1]]
        if gid_s:
            g = _arr(gid_s, n, np.int64)
            new[1:] |= g[1:] != g[:-1]
        out = np.zeros(n, np.uint8)
        out[p] = _arr(contrib, n, np.uint8)[p].astype(bool) & new
        _wr(firsts, out)
        self.calls.append(("k9 gather", (n,)))
        return 0


def _no_sort(*_a, **_k):
    raise AssertionError("a library sort on the card path")


def _install_stub(monkeypatch) -> _Recorder:
    """The wrappers' card path over CPU tensors, with a recording library
    instead of the CUDA ones and every library sort made to fail."""
    rec = _Recorder()
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "_K17_HOST", {})
    for name in ("sort", "argsort", "unique", "unique_consecutive"):
        monkeypatch.setattr(torch, name, _no_sort)
    monkeypatch.setattr(pk, "lexsort_plain", _no_sort)
    monkeypatch.setattr(pk, "sort_perm_plain", _no_sort)
    # the process's counts stay as they were: other tests read them
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return rec


@pytest.fixture
def stub_card(monkeypatch):
    return _install_stub(monkeypatch)


def _expected_plan(planes: list) -> list:
    return pk.sort_plan([(int(a), int(o)) for a, o in (
        (np.bitwise_and.reduce(w), np.bitwise_or.reduce(w)) for w in (
            _np_words(np.asarray(p), pk._SORT_DTYPES[
                torch.from_numpy(np.asarray(p)).dtype]) for p in planes))])


@pytest.mark.parametrize("case", ["edges", "one word", "two words",
                                  "three words", "flags"])
def test_k17_drives_its_plan(stub_card, case):
    n = 3000
    rng = np.random.default_rng(len(case))
    planes = {
        "edges": _edge_planes(n, 4),
        "one word": [rng.integers(0, 1 << 23, n),
                     np.zeros(n, np.int8), ~rng.integers(0, 1 << 24, n),
                     np.ones(n, np.int8)],
        "two words": _width_planes([40, 30], n, 1),
        "three words": _width_planes([7, 64, 63], n, 2),
        "flags": [(rng.random(n) < 0.5).astype(np.uint8),
                  rng.random(n) < 0.5, rng.integers(0, 3, n).astype(np.int8)],
    }[case]
    plan = _expected_plan(planes)
    perm, words, got_plan, _pairs = pk.sort_perm_words(_t(planes), n)
    assert got_plan == plan
    assert np.array_equal(perm.numpy(), np.lexsort(planes))
    kinds = [k for k, _a in stub_card.calls]
    want = ["summary"]
    for _f, _v, passes in plan:
        want += ["pack"] + ["radix"] * len(passes)
    assert kinds == want
    assert pk.LAUNCHES["sort_perm"] == 1
    assert pk.LAUNCHES["radix_pass"] == sum(len(p) for _f, _v, p in plan)
    if len(plan) == 1:
        _perm, plan_w, w = _plan_sort(planes)
        assert np.array_equal(words.numpy(), w)
    else:
        assert words is None
    # a pass never writes what it reads; a later word's pack overwrites
    # the words beside the permutation it gathers through
    for k, a in stub_card.calls:
        if k == "radix":
            assert a[2] != a[4] and (a[3] == 0 or a[3] != a[5])
    packs = [a for k, a in stub_card.calls if k == "pack"]
    assert packs[0][2] == 0 and all(p[2] != 0 for p in packs[1:])
    assert torch.equal(pk.sort_perm(_t(planes), n), perm)


def test_k17_edge_lengths(stub_card):
    for n in (0, 1):
        perm = pk.sort_perm(_t(_edge_planes(n, 1)), n)
        assert perm.tolist() == list(range(n))
    assert stub_card.calls == []
    perm = pk.sort_perm(_t(_edge_planes(2, 1)), 2)
    assert np.array_equal(perm.numpy(), np.lexsort(_edge_planes(2, 1)))
    tied = [np.zeros(500, np.int64), np.ones(500, np.int8)]
    perm, words, plan, _p = pk.sort_perm_words(_t(tied), 500)
    assert plan == [] and perm.tolist() == list(range(500))
    assert [k for k, _a in stub_card.calls][-1:] == ["summary"]
    assert torch.equal(words, torch.full((500,), I64_MIN))


@pytest.mark.parametrize("max_rows", [700, 2100])
@pytest.mark.parametrize("min_step", [1 << 16, 301])
def test_k17_splits_past_its_row_limit(stub_card, monkeypatch, max_rows,
                                       min_step):
    # one step, or the digits and row lists in steps of 301 rows
    monkeypatch.setattr(pk, "_K17_SPLIT_MIN_STEP", min_step)
    n = 5000
    rng = np.random.default_rng(max_rows)
    # 12 bits of which most rows use the low 8, under a flag and a key
    # of 3 values, one of which holds half the rows: the top digit's
    # largest part is past the limit and splits again
    planes = [rng.integers(0, 1 << 8, n), (rng.random(n) < 0.1)
              .astype(np.int8), rng.integers(0, 3, n)]
    planes[0][::97] = rng.integers(0, 1 << 12, len(planes[0][::97]))
    planes[2][:2500] = 1
    # the split works within K17's four n-row buffers
    bufs, empty = [], torch.empty

    def record(*a, **k):
        t = empty(*a, **k)
        if t.shape == (n,) and t.dtype == torch.int64:
            bufs.append(t)
        return t

    monkeypatch.setattr(torch, "empty", record)
    perm, words, _plan, _pairs = pk._k17_sort(_t(planes), n,
                                              torch.device("cpu"), max_rows)
    monkeypatch.setattr(torch, "empty", empty)
    assert words is None
    assert np.array_equal(perm.numpy(), np.lexsort(planes))
    passes = [a[0] for k, a in stub_card.calls if k == "radix"]
    assert passes and max(passes) <= max_rows
    assert len(bufs) == 4 and perm.data_ptr() == bufs[3].data_ptr()
    spans = [(b.data_ptr(), b.data_ptr() + 8 * n) for b in bufs]

    def inside(ptr, rows):
        return any(lo <= ptr and ptr + 8 * rows <= hi for lo, hi in spans)

    for k, a in stub_card.calls:
        if k == "pack":
            rows, _nf, src, dst = a
            assert inside(src, rows) and inside(dst, rows)
        elif k == "radix":
            rows = a[0]
            assert all(inside(p, rows) for p in a[2:])


def test_k17_split_drops_a_constant_top_digit(stub_card):
    """A part of one top digit sorts without that digit's pass; the parts
    of several digits keep it. The top digit is the value of the second
    plane: 700 rows of 0..4, 1,900 of 5, 400 of 6..7, so at a limit of
    2,000 the parts are (0..4), (5) and (6..7)."""
    rng = np.random.default_rng(3)
    hi = rng.permutation(np.r_[np.repeat(np.arange(5), 140),
                               np.full(1900, 5), np.repeat([6, 7], 200)])
    n = hi.shape[0]
    planes = [rng.integers(0, 1 << 8, n), hi]
    perm, _words, plan, _pairs = pk._k17_sort(_t(planes), n,
                                              torch.device("cpu"), 2000)
    assert np.array_equal(perm.numpy(), np.lexsort(planes))
    assert [len(p) for _f, _v, p in plan] == [2]
    sizes = [a[0] for k, a in stub_card.calls if k == "radix"]
    assert sizes == [700, 700, 1900, 400, 400]


def test_k17_threads_on_one_stream_keep_their_summaries(stub_card):
    """Two threads on one stream share K17's page-locked summary: the
    second's launch waits until the first has read its own (else it writes
    its pairs over the first's, which then packs by the wrong plan)."""
    first_in, second_in = threading.Event(), threading.Event()
    launch = stub_card.sort_perm_summary_launch

    def launch_then_wait(n, *args):
        rc = launch(n, *args)
        if n == 3000:                # the first: give the second its turn
            first_in.set()
            second_in.wait(0.3)
        else:
            second_in.set()
        return rc

    stub_card.sort_perm_summary_launch = launch_then_wait
    rng = np.random.default_rng(5)
    # the first's planes wide, the second's narrow: the second's plan
    # would cut the first's words
    planes = [[rng.integers(-(1 << 40), 1 << 40, 3000),
               rng.integers(0, 1 << 20, 3000)],
              [rng.permutation(700), rng.integers(0, 4, 700)]]
    got = [None, None]

    def sort(i):
        got[i] = pk.sort_perm(_t(planes[i]), len(planes[i][0]))

    first = threading.Thread(target=sort, args=(0,))
    first.start()
    assert first_in.wait(5)
    second = threading.Thread(target=sort, args=(1,))
    second.start()
    first.join(10)
    second.join(10)
    assert not first.is_alive() and not second.is_alive()
    for i in range(2):
        assert np.array_equal(got[i].numpy(), np.lexsort(planes[i]))


def test_lexsort_on_the_card_is_k17(monkeypatch):
    rng = np.random.default_rng(8)
    n = 4000
    keys = [torch.from_numpy(rng.integers(-3, 4, n)),
            torch.from_numpy((rng.random(n) < 0.2).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 9000, n)),
            torch.from_numpy((rng.random(n) < 0.1).astype(np.uint8)),
            torch.from_numpy((rng.random(n) < 0.3).astype(np.uint8))]
    want_perm, want_last = pk.lexsort(keys)         # the CPU: chained
    assert np.array_equal(want_perm.numpy(), np.lexsort(
        [k.numpy() for k in keys]))
    _install_stub(monkeypatch)
    perm, last = pk.lexsort(keys)
    assert pk.LAUNCHES["sort_perm"] == 1
    assert torch.equal(perm, want_perm) and torch.equal(last, want_last)


@pytest.mark.parametrize("grouped", [False, True], ids=["scalar", "grouped"])
def test_distinct_sort_on_the_card_takes_the_word_mode(stub_card, grouped):
    v, contrib, gid = _distinct_case(21, 3000, grouped)
    tc = torch.from_numpy(contrib)
    tg = None if gid is None else torch.from_numpy(gid)
    perm, key, gid_s, words = pk.distinct_sort(torch.from_numpy(v), tc, tg)
    assert words is not None and words[1] >= 0
    got = pk.distinct_runs(perm, key, tc, gid_s, words)
    assert [k for k, _a in stub_card.calls][-1] == "k9 words"
    assert torch.equal(got, pk.distinct_runs_plain(perm, key, tc, gid_s))
    want = np.lexsort([v, ~contrib] + ([gid] if grouped else []))
    assert np.array_equal(perm.numpy(), want)
    if grouped:
        assert np.array_equal(gid_s.numpy(), gid[want])
    # 16-byte loads: a misaligned view is refused, not read
    w, flag = words
    with pytest.raises(pk.errors.DeviceError, match="aligned"):
        pk.distinct_runs(perm[1:], key[1:], tc[1:], None, (w[1:], flag))
    # the gather mode on the same sort
    assert torch.equal(pk.distinct_runs(perm, key, tc, gid_s), got)
    assert [k for k, _a in stub_card.calls][-1] == "k9 gather"
    assert pk.LAUNCHES["distinct_runs"] == 2


def test_plain_references_keep_the_chained_sort(monkeypatch):
    """K10's and K11's plain versions, which the card checks hold the
    kernels against, sort by lexsort_plain (the chained torch.sort), never
    by lexsort: on the card that is K17 over radix.cuh, whose passes K11
    runs itself, so a fault there would be on both sides."""
    rng = np.random.default_rng(13)
    n = 400
    t = torch.from_numpy
    mask = t(rng.random(n) < 0.8)
    keys = [((t(rng.integers(-5, 5, n)), t(rng.random(n) < 0.9)), True),
            ((t(rng.integers(0, 3, n) * 0.5), t(rng.random(n) < 0.7)),
             False)]
    rkey = t(rng.integers(0, 50, n))
    rvalid = t(rng.random(n) < 0.7)
    offsets = t(np.array([0, 90, 250, n], np.int64))
    want_k10 = pk.topk_select_plain(mask, keys, 37)
    want_k11 = pk.join_build_partitioned_plain(rkey, rvalid, offsets)
    monkeypatch.setattr(pk, "lexsort", _no_sort)
    monkeypatch.setattr(pk, "sort_perm", _no_sort)
    for got, want in ((pk.topk_select_plain(mask, keys, 37), want_k10),
                      (pk.join_build_partitioned_plain(rkey, rvalid,
                                                       offsets), want_k11)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_card_paths_call_no_library_sort():
    """The card paths' sources name no library sort (the plain versions'
    stay as they are)."""
    for fn in (pk.lexsort, pk.distinct_sort, pk.sort_perm,
               pk.sort_perm_words, pk._k17_sort, pk._k17_split,
               pk.distinct_runs, pk.ranked_keys):
        src = inspect.getsource(fn)
        body = src.split('"""')[-1] if src.count('"""') >= 2 else src
        for banned in ("torch.sort", "argsort", "torch.unique"):
            assert banned not in body, (fn.__name__, banned)
    prep = inspect.getsource(pk.build_ranked_group_fn)
    assert "lexsort(ranked_keys(" in prep and "torch.sort" not in prep


# ---------------------------------------------------------------------------
# constants against the .cu sources
# ---------------------------------------------------------------------------

def _define(src: str, name: str) -> int:
    return int(re.search(r"#define %s \(?(-?\d+)\)?" % name, src).group(1))


def test_k17_constants_match_source():
    src = _source("sort_perm.cu")
    enum = re.search(r"enum K17Dtype \{(.*?)\}", src).group(1)
    codes = {name: int(v) for name, v in
             re.findall(r"K17_(\w+) = (\d+)", enum)}
    assert codes == {"I64": 0, "F64": 1, "I32": 2, "I8": 3, "U8": 4}
    assert pk._SORT_DTYPES == {torch.int64: 0, torch.float64: 1,
                               torch.int32: 2, torch.int8: 3,
                               torch.uint8: 4, torch.bool: 4}
    assert _define(src, "K17_MAX_PLANES") == pk.K17_MAX_PLANES
    # the order words' sign bit is common.cuh's: sort_perm.cu compiles
    # no copy of radix.cuh's kernels, whose passes run from radix_sort.cu
    assert '#include "common.cuh"' in src and "radix.cuh\"" not in src
    assert "#define RADIX_SIGN" in _source("common.cuh")
    # the passes are radix.cuh's: none of the old digit kernels is left
    for gone in ("k17_count", "k17_scan", "k17_scatter", "k17_fold",
                 "k17_load"):
        assert gone not in src
    assert "c ^ RADIX_SIGN" in src
    assert pk.K17_MAX_ROWS == (1 << 31) - 1


def test_k9_constants_match_source():
    src = _source("distinct_runs.cu")
    assert _define(src, "K9_ALL") == pk.K9_ALL
    assert _define(src, "K9_NONE") == pk.K9_NONE
