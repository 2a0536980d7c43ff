"""K12 join_probe and K13 dict_remap as redesigned in slice 21: their plain
versions against the JAX package, and the host-side helpers of their
launches against a numpy reckoning.

- K13's f64 domains: NaN, +-inf and -0.0 through the port's plain version
  (kernels.dict_remap_keys on the CPU), the reference's dict_remap_keys
  (JAX on the CPU) and copr.dictionary.host_keys, alone and in a
  mixed-radix key. Every NaN takes the NaN entry's code and +inf its own
  (the plain version gave +inf NaN's code before: searchsorted over the
  doubles, where NaN compares false).
- K12's plain versions against the reference's join_match_pairs
  (_join_build_impl + _join_probe_impl): one key with thousands of
  matches, a left side all NULL, f64 probe keys with NaN, +-inf and -0.0,
  and the per-shard totals of the sharded probe.
- K12's card wrappers over a recording stub in place of the library:
  the sample shift, lo's width, the marks, the epochs and the one
  allocation of both planes each call hands the count, and the pairs and
  totals the wrapper makes of what the count and expand write.
- The helpers: the sample shift (the host's, which K12's launch and K13's
  plan both pass to sample_search.cuh), K13's packed columns (kernels.k13_plan), the marks whose offsets
  K12's count writes to mapped host memory (kernels.k12_marks), the
  domain's order words; and the C signatures against the sources.

Exact equality throughout.
"""

import ast
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from tidb_tpu.copr import dictionary as rdict
from tidb_tpu.ops import kernels as rk

from tidb_tpu_torch.copr import dictionary as pdict
from tidb_tpu_torch.ops import _ext
from tidb_tpu_torch.ops import kernels as pk

NAN, INF = float("nan"), float("inf")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _f64_specs(mod, vals, valid, mixed: bool, seed: int):
    """KeySpecs of `mod` (the reference's dictionary or the port's) over an
    f64 column in domain mode, its domain the unique normalized valid
    values as build_join_specs makes it; with `mixed`, a codes column
    beside it (mixed radix)."""
    vals = np.asarray(vals, np.float64)
    dom = np.unique(mod._norm_f64(vals)[valid])
    first = mod.KeySpec("domain", vals, valid, dom, len(dom))
    if not mixed:
        return [first]
    rng = np.random.default_rng(seed)
    n = len(vals)
    v2 = rng.random(n) > 0.1
    second = mod.KeySpec("codes", np.where(v2, rng.integers(0, 5, n), -1),
                         v2, None, 5)
    first.stride, second.stride = 5, 1
    return [first, second]


def _nan_values(seed: int, n: int = 3001) -> tuple:
    rng = np.random.default_rng(seed)
    vals = rng.integers(-5, 6, n) * 0.5         # 11 finite values
    vals[::7] = NAN
    vals[3::11] = -np.float64(NAN)             # the sign bit set
    vals[::13] = INF
    vals[5::17] = -INF
    vals[::19] = -0.0
    return vals, rng.random(n) > 0.15


@pytest.mark.parametrize("mixed", [False, True], ids=["alone", "mixed_radix"])
def test_f64_domain_nan_and_inf(mixed):
    """Every NaN (either sign) takes the NaN entry's code, +inf its own,
    -0.0 +0.0's: the port's plain K13 equals the reference's JAX program
    and host_keys."""
    vals, valid = _nan_values(7)
    n = len(vals)
    rspecs = _f64_specs(rdict, vals, valid, mixed, 9)
    pspecs = _f64_specs(pdict, vals, valid, mixed, 9)
    want, wvalid = rdict.host_keys(rspecs, n)
    jkey, jvalid = (np.asarray(a)[:n] for a in
                    rk.dict_remap_keys(rspecs, rk.col.bucket_capacity(n)))
    key, kvalid = pk.dict_remap_keys(pspecs, n, "cpu")
    assert jkey.tolist() == want.tolist()
    assert key.numpy().tolist() == want.tolist()
    assert kvalid.numpy().tolist() == wvalid.tolist() == jvalid.tolist()
    dom = rspecs[0].table
    assert np.isnan(dom[-1]) and dom[-2] == INF
    codes = key.numpy() // (5 if mixed else 1)
    assert set(codes[np.isnan(vals)].tolist()) == {len(dom) - 1}
    assert set(codes[vals == INF].tolist()) == {len(dom) - 2}


def test_f64_domain_codes_of_the_table():
    """The values [1, nan, 2, inf, nan, -1] over their unique domain
    [-1, 1, 2, inf, nan]: codes [1, 4, 2, 3, 4, 0] on every path."""
    vals = np.array([1.0, NAN, 2.0, INF, NAN, -1.0])
    valid = np.ones(6, bool)
    for mod in (rdict, pdict):
        specs = _f64_specs(mod, vals, valid, False, 0)
        got = (rdict.host_keys(specs, 6)[0] if mod is rdict else
               pk.dict_remap_keys(specs, 6, "cpu")[0].numpy())
        assert got.tolist() == [1, 4, 2, 3, 4, 0]


def _pairs(lk, lv, rkey, rv):
    ref = rk.join_match_pairs(lk, lv, rkey, rv)
    port = pk.join_match_pairs(lk, lv, rkey, rv, device="cpu")
    return ref, port


def _probe_case(name: str) -> tuple:
    rng = np.random.default_rng(31)
    if name == "one key, 5000 matches":
        lk = np.array([3, 9, 3, 4, 9], np.int64)
        rkey = np.concatenate([np.full(5000, 9), rng.integers(0, 6, 300)])
        return lk, np.ones(5, bool), rkey, rng.random(5300) > 0.05
    if name == "all-NULL left":
        lk = rng.integers(0, 5, 400)
        rkey = rng.integers(0, 5, 100)
        return lk, np.zeros(400, bool), rkey, np.ones(100, bool)
    # f64 probe keys with NaN (either sign), +-inf and -0.0 against a build
    # side of finite keys, +-inf and both zeros
    lk = rng.integers(-4, 4, 2000) * 0.5
    lk[::9] = NAN
    lk[4::23] = -np.float64(NAN)
    lk[::11] = INF
    lk[2::13] = -INF
    lk[::7] = -0.0
    rkey = rng.integers(-4, 4, 700) * 0.5
    rkey[::17] = INF
    rkey[3::19] = -INF
    rkey[::5] = -0.0
    rkey[1::6] = 0.0
    return lk, rng.random(2000) > 0.1, rkey, rng.random(700) > 0.1


@pytest.mark.parametrize("name", ["one key, 5000 matches", "all-NULL left",
                                  "f64 NaN, inf and zeros"])
def test_probe_against_the_reference(name):
    lk, lv, rkey, rv = _probe_case(name)
    (rl, rr), (pl, pr) = _pairs(lk, lv, rkey, rv)
    assert pl.tolist() == rl.tolist()
    assert pr.tolist() == rr.tolist()
    if name == "all-NULL left":
        assert len(pl) == 0
    else:
        assert len(pl) > 0


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_probe_totals(shards):
    """The sharded probe's pairs are the one-shard pairs (the reference's),
    and each shard's total counts the pairs of its contiguous block of
    left rows."""
    rng = np.random.default_rng(shards)
    nl = 64 * 37
    lk = rng.integers(0, 300, nl)
    rkey = rng.integers(0, 300, 900)
    lv, rv = rng.random(nl) > 0.2, rng.random(900) > 0.1
    rl, _rr = rk.join_match_pairs(lk, lv, rkey, rv)
    words, order = pk.join_build(torch.from_numpy(rkey), torch.from_numpy(rv))
    pairs, totals = pk.join_probe(words, order, torch.from_numpy(lk),
                                  torch.from_numpy(lv), shards=shards)
    assert pairs[0].numpy().tolist() == rl.tolist()
    want = np.bincount(rl // (nl // shards), minlength=shards)
    assert totals.tolist() == want.tolist()
    assert pk.k12_marks(nl, shards) == (nl // shards, shards + 1)


def test_k12_marks_layout():
    """The mapped totals: shard starts k * nl / shards for k = 0..shards
    (the last the grand total), or a partition start each."""
    for nl, shards in ((8, 1), (4096, 8), (6_001_215 * 8, 8)):
        stride, nmarks = pk.k12_marks(nl, shards)
        starts = np.arange(nmarks) * stride
        assert starts[0] == 0 and starts[-1] == nl and nmarks == shards + 1
    assert pk.k12_marks(100, 1, parts=16) == (0, 17)


@pytest.mark.parametrize("n,cap", [(0, 1), (1, 1), (7, 1), (10_000, 13_750),
                                   (200_000, 3_840), (1_500_216, 8_192),
                                   (1 << 20, 1 << 13), (1_500_216, 2_047),
                                   (2_548_792, 2_047)])
def test_sample_shift(n, cap):
    """The least s with ceil(n / 2^s) <= cap."""
    s = pk.sample_shift(n, cap)
    fits = [t for t in range(64) if -(-n // (1 << t)) <= cap]
    assert s == fits[0]


def test_domain_words_order():
    """An f64 domain's order words ascend as np.unique orders the values
    (NaN last), equal values give equal words (-0.0 and +0.0, every NaN)."""
    vals = np.array([-INF, -2.5, -0.0, 0.0, 1e-300, 3.0, INF, NAN,
                     -np.float64(NAN)])
    w = pk.domain_words(torch.from_numpy(vals)).numpy()
    assert (np.diff(w[:7]) >= 0).all() and w[2] == w[3]
    assert w[7] == w[8] > w[6]
    dom = np.unique(vals)
    assert (np.diff(pk.domain_words(torch.from_numpy(dom)).numpy()) > 0).all()
    ints = torch.tensor([5, -3], dtype=torch.int64)
    assert pk.domain_words(ints) is ints


def test_k13_plan_packing():
    """K13's packed columns: modes, pointers, lengths, strides; tables
    staged in ascending length, whole where the room holds them, a domain
    past it sampled; a remap table past it read where it lies; a launch
    per config's most columns."""
    RC = pk.RemapCol
    n = 16
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    valid = t(np.ones(n, bool))
    big = t(np.arange(5000, dtype=np.int64))
    small = t(np.arange(10, dtype=np.int64))
    fdom = t(np.array([-1.0, 0.0, INF, NAN]))
    cols = [RC(pk.REMAP_DOMAIN, t(np.zeros(n, np.int64)), valid, big, 4999,
               40),
            RC(pk.REMAP_TABLE, t(np.zeros(n, np.int64)), valid, big, 4999, 1),
            RC(pk.REMAP_DOMAIN, t(np.zeros(n)), valid, fdom, 3, 7),
            RC(pk.REMAP_CODES, t(np.zeros(n, np.int64)), valid, None, 8, 2),
            RC(pk.REMAP_TABLE, t(np.zeros(n, np.int64)), valid, small, 9, 3)]
    # room for 1,000 words, samples of at most 512
    plan = pk.k13_plan(cols, (16, 8000, 512, pk.K13_WORDS))
    assert len(plan) == 1
    words, smem, ncols = plan[0]
    assert ncols == 5 and len(words) == 5 * pk.K13_WORDS
    col = [words[i * pk.K13_WORDS:(i + 1) * pk.K13_WORDS] for i in range(5)]
    modes = [c[0] for c in col]
    assert modes == [pk.K13_DOM_I64, pk.K13_REMAP, pk.K13_DOM_F64,
                     pk.K13_CODES, pk.K13_REMAP]
    for c, rc in zip(col, cols):
        assert c[1] == rc.values.data_ptr() and c[2] == rc.valid.data_ptr()
        assert c[5] == rc.cmax and c[6] == rc.stride
    # staged in ascending length: fdom (4) at 0, small (10) at 4, then the
    # 5,000-entry domain sampled into the 986 words left (cap 512: 2^4)
    assert col[2][7:10] == [0, 4, 0] and col[4][7:10] == [0, 10, 4]
    sh = pk.sample_shift(5000, 512)
    assert col[0][7:10] == [sh, -(-5000 >> sh), 14] and sh == 4
    assert col[0][10] == (-(-5000 >> sh)).bit_length()
    assert col[1][7:10] == [0, 0, 0] and col[1][10] == (5000).bit_length()
    assert col[3][3] == 0 and col[3][4] == 0
    assert smem == 8 * (14 + 313)
    # no shared memory: nothing staged; two launches past the most columns
    off = pk.k13_plan(cols, (16, 0, 512, pk.K13_WORDS))[0]
    assert off[1] == 0 and all(off[0][i * pk.K13_WORDS + 8] == 0
                               for i in range(5))
    two = pk.k13_plan(cols, (3, 8000, 512, pk.K13_WORDS))
    assert [g[2] for g in two] == [3, 2]


def _view(addr: int, n: int, dtype) -> np.ndarray:
    return np.ctypeslib.as_array(
        (np.ctypeslib.as_ctypes_type(dtype) * max(n, 1)).from_address(addr)
    )[:n]


class _K12Stub:
    """join_probe's C entry points in numpy: the count writes each row's lo
    and offset and the marks' offsets (the partition or shard starts and
    the total) where it is told; the expand maps the slots back to rows
    from those planes. Every call's arguments are kept."""

    def __init__(self):
        self.tensors = {}
        self.counts = []
        self.expands = []

    def know(self, *ts):
        for t in ts:
            self.tensors[t.data_ptr()] = t

    def join_probe_sample_cap(self):
        return 2048

    def join_probe_workspace_bytes(self, nl):
        return 16 + 32 * max(-(-nl // 2048), 1)

    def join_probe_count_launch(self, nl, lkey_p, lvalid_p, is_f64, words_p,
                                nv, loff_p, bounds_p, parts, shift, lo_bytes,
                                lo_p, offs_p, stride, nmarks, ws_p, epoch,
                                host_p, _st):
        self.counts.append(dict(nl=nl, nv=nv, parts=parts, shift=shift,
                                lo_bytes=lo_bytes, lo=lo_p, offs=offs_p,
                                stride=stride, nmarks=nmarks, epoch=epoch,
                                is_f64=is_f64))
        lw = pk.orderable(self.tensors[lkey_p]).numpy()
        valid = self.tensors[lvalid_p].numpy()
        words = self.tensors[words_p].numpy()
        lo = np.zeros(nl, np.int64)
        hi = np.zeros(nl, np.int64)
        if parts:
            lb = self.tensors[loff_p].tolist()
            bb = self.tensors[bounds_p].tolist()
        else:
            lb, bb = [0, nl], [0, nv]
        for p in range(len(lb) - 1):
            seg = words[bb[p]:bb[p + 1]]
            lo[lb[p]:lb[p + 1]] = bb[p] + np.searchsorted(seg, lw[lb[p]:lb[p + 1]])
            hi[lb[p]:lb[p + 1]] = bb[p] + np.searchsorted(
                seg, lw[lb[p]:lb[p + 1]], side="right")
        cnt = np.where(valid, hi - lo, 0)
        offs = np.concatenate([[0], np.cumsum(cnt)])
        _view(offs_p, nl, np.int64)[:] = offs[:-1]
        _view(lo_p, nl, np.int32 if lo_bytes == 4 else np.int64)[:] = \
            np.where(valid, lo, 0)
        marks = lb if parts else [k * stride for k in range(nmarks)]
        _view(host_p, nmarks, np.int64)[:] = offs[marks]
        return 0

    def join_probe_expand_launch(self, total, nl, lo_bytes, lo_p, offs_p,
                                 order_p, lsel_p, narrow, out_p, _st):
        self.expands.append(dict(total=total, nl=nl, lo=lo_p, offs=offs_p,
                                 lsel=lsel_p, narrow=narrow))
        offs = np.append(_view(offs_p, nl, np.int64), total)
        lo = _view(lo_p, nl, np.int32 if lo_bytes == 4 else np.int64)
        order = self.tensors[order_p].numpy()
        rows = np.repeat(np.arange(nl), np.diff(offs))
        r = order[lo[rows] + np.arange(total) - offs[rows]]
        left = self.tensors[lsel_p].numpy()[rows] if lsel_p else rows
        out = _view(out_p, 2 * total, np.int32 if narrow else np.int64)
        out[:total], out[total:] = left, r
        return 0


@pytest.fixture
def k12_stub(monkeypatch):
    stub = _K12Stub()
    monkeypatch.setattr(_ext, "lib", lambda name: stub)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "_K12_EPOCH", {})
    # page-locked memory needs a card: the mapped buffer as a plain one
    monkeypatch.setattr(pk, "_K12_HOST",
                        {(None, 0): torch.zeros(64, dtype=torch.int64)})
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return stub


@pytest.mark.parametrize("nv", [300, 4095])
def test_k12_wrapper_hands_the_count_its_plan(k12_stub, nv):
    """Each call: the sample shift the host picks (every 2^s-th word, at
    most the library's cap less one), int32 lo where the pairs are int32,
    lo right after the offsets in one allocation, the shards' marks and a
    new epoch; the pairs and totals equal the plain version's."""
    rng = np.random.default_rng(nv)
    nl, shards = 4 * 1024, 4
    lk = torch.from_numpy(rng.integers(0, nv // 3, nl))
    lv = torch.from_numpy(rng.random(nl) > 0.1)
    # 4,095 words: a sample of every other word would hold 2,048, one
    # past the cap
    words, order = pk.join_build_plain(
        torch.from_numpy(rng.integers(0, nv // 3, nv)),
        torch.ones(nv, dtype=torch.bool))
    assert words.shape[0] == nv
    k12_stub.know(lk, lv, words, order)
    want = pk.join_probe_plain(words, order, lk, lv)
    for _ in range(2):
        pairs, totals = pk.join_probe(words, order, lk, lv, shards=shards)
        assert pairs.dtype == torch.int32
        assert torch.equal(pairs.to(torch.int64), want)
        assert totals.tolist() == np.bincount(
            want[0].numpy() // (nl // shards), minlength=shards).tolist()
    c = k12_stub.counts
    assert [x["epoch"] for x in c] == [1, 2]
    for x, e in zip(c, k12_stub.expands):
        assert x["shift"] == pk.sample_shift(nv, 2047)
        assert -(-nv >> x["shift"]) <= 2047 < -(-nv >> max(x["shift"] - 1, 0)) \
            or x["shift"] == 0
        assert x["lo_bytes"] == 4 and x["lo"] == x["offs"] + 8 * nl
        assert (x["stride"], x["nmarks"]) == pk.k12_marks(nl, shards)
        assert e["total"] == want.shape[1] and e["narrow"] == 1
        assert e["lo"] == x["lo"] and e["lsel"] is None
    assert pk.LAUNCHES["join_probe"] == 2


def test_k12_segmented_wrapper(k12_stub):
    """The segmented mode: the partition starts as its marks, each
    partition's build range, the global rows through lsel; the pairs and
    per-partition totals equal the plain version's."""
    rng = np.random.default_rng(3)
    lk = torch.from_numpy(rng.integers(0, 200, 3000))
    lv = torch.from_numpy(rng.random(3000) > 0.1)
    rkey = torch.from_numpy(rng.integers(0, 200, 800))
    rv = torch.from_numpy(rng.random(800) > 0.1)
    l_sel, l_off = pk.key_partition_plain(lk, lv, 8)
    r_sel, r_off = pk.key_partition_plain(rkey, rv, 8)
    words, rows, bounds = pk.join_build_partitioned_plain(
        rkey.index_select(0, r_sel), rv.index_select(0, r_sel), r_off)
    a = dict(words=words, order=r_sel.index_select(0, rows), bounds=bounds,
             lkey=lk.index_select(0, l_sel), lvalid=lv.index_select(0, l_sel),
             loff=l_off, lsel=l_sel)
    k12_stub.know(*a.values())
    want, tw = pk.join_probe_partitioned_plain(**a)
    pairs, totals = pk.join_probe_partitioned(**a)
    assert torch.equal(pairs.to(torch.int64), want)
    assert totals.tolist() == tw.tolist()
    (x,), (e,) = k12_stub.counts, k12_stub.expands
    assert x["parts"] == 8 and x["nmarks"] == 9
    assert x["shift"] == pk.sample_shift(words.shape[0], 2047)
    assert e["lsel"] == l_sel.data_ptr()
    assert pk.LAUNCHES["join_probe_seg"] == 1


def _define(src: str, name: str) -> str:
    return re.search(r"#define %s (\S+)" % name, src).group(1)


def test_sources_and_signatures():
    """Two launches a K12 call (no tile-total scan, no add-back), K13 with
    no copy to the card and its config as the plan reads it; every C
    signature as the sources declare it."""
    k12, k13 = _source("join_probe.cu"), _source("dict_remap.cu")
    for gone in ("scan_totals", "k12_add_back", "upper_bound_i64(offs"):
        assert gone not in k12, gone
    assert '#include "sample_search.cuh"' in k12
    assert '#include "sample_search.cuh"' in k13
    assert "cudaMemcpy" not in k13 and "cudaMemcpy" not in k12
    # the sample's shift is the host's alone (kernels.sample_shift)
    assert "sample_shift(" not in _source("sample_search.cuh") + k12 + k13
    assert int(_define(k13, "K13_WORDS")) == pk.K13_WORDS
    assert int(_define(k12, "K12_MAX_PARTS")) == pk.K12_MAX_PARTS
    for name, src in (("join_probe", k12), ("dict_remap", k13)):
        assert set(_ext.SIGNATURES[name]) == set(
            re.findall(r'extern "C" \w+ (\w+)\(', src))
        for fn, (argtypes, _rt) in _ext.SIGNATURES[name].items():
            params = re.search(r'extern "C" \w+ %s\((.*?)\)\s*\{' % fn, src,
                               re.S).group(1)
            assert len(argtypes) == len([p for p in params.split(",")
                                         if p.strip()]), fn


def test_variants_script_imports_no_jax():
    """k12_k13_variants.py runs on the card: it imports nothing of JAX or
    of the JAX package."""
    with open(os.path.join(ROOT, "k12_k13_variants.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert names and not any(n == "jax" or n.startswith(("jax.", "tidb_tpu."))
                             or n == "tidb_tpu" for n in names), names
