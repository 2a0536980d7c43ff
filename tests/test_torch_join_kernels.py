"""The join kernels' plain versions against the JAX package's programs.

The same numpy inputs, made from seeds, go through
- the reference's join_match_pairs (_join_build_impl + _join_probe_impl,
  JAX on the CPU) and the port's (kernels.join_build / join_probe, whose
  plain versions K11 and K12 run on CPU tensors); and _join_build_impl's
  sorted keys and order against K11's words and order directly;
- the reference's dict_remap_keys (JAX) and copr.dictionary.host_keys,
  and the port's K13 (kernels.dict_remap_keys, plain on the CPU) and its
  copy of host_keys, over KeySpecs of every mode.

Exact equality: pairs in order, keys, valid.
"""

import numpy as np
import pytest
import torch

from tidb_tpu.copr import dictionary as rdict
from tidb_tpu.ops import kernels as rk

from tidb_tpu_torch.copr import dictionary as pdict
from tidb_tpu_torch.ops import kernels as pk

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
INF = float("inf")


def _random_case(seed: int, dtype):
    rng = np.random.default_rng(seed)
    nl, nr = int(rng.integers(1, 600)), int(rng.integers(1, 400))
    lk = rng.integers(-20, 20, nl).astype(dtype)
    rkey = rng.integers(-20, 20, nr).astype(dtype)
    if dtype == np.float64:
        lk = lk * 0.5
        rkey = rkey * 0.5
        lk[rng.random(nl) < 0.1] = -0.0
        rkey[rng.random(nr) < 0.05] = INF
    return lk, rng.random(nl) > 0.15, rkey, rng.random(nr) > 0.15


# (name, lkey, lvalid, rkey, rvalid): edge cases of join_match_pairs
EDGES = [
    ("i64 max beside nulls", [I64_MAX, 0], [True, True],
     [I64_MAX, I64_MAX, 5], [True, False, True]),
    ("i64 min", [I64_MIN, 3, I64_MIN], [True, True, False],
     [3, I64_MIN, I64_MIN, I64_MAX], [True, True, True, True]),
    ("inf", [INF, 1.0, -INF], [True, True, True],
     [INF, 1.0, 2.0, -INF, -INF], [True, True, False, True, True]),
    ("-0.0 against +0.0", [-0.0, 0.0, 1.0], [True, True, True],
     [0.0, -0.0, 0.0], [True, True, False]),
    ("nulls on both sides", [1, 2, 2], [False, True, False],
     [2, 2, 1], [False, True, False]),
    ("empty right", [1, 2], [True, True], [], []),
    ("empty left", [], [], [1], [True]),
    ("all-null left", [1, 2], [False, False], [1, 2], [True, True]),
    ("8 x 3000 duplicates", [7] * 8, [True] * 8, [7] * 3000, [True] * 3000),
    ("one key, 2^20 matches", [5, 6], [True, True],
     [5] * (1 << 20), [True] * (1 << 20)),
]


def _planes(lk, lv, rkey, rv, dtype=None):
    if dtype is None:
        dtype = np.float64 if any(isinstance(x, float)
                                  for x in list(lk) + list(rkey)) \
            else np.int64
    return (np.asarray(lk, dtype), np.asarray(lv, bool),
            np.asarray(rkey, dtype), np.asarray(rv, bool))


def _both_pairs(lk, lv, rkey, rv):
    ref = rk.join_match_pairs(lk, lv, rkey, rv)
    stats = {}
    port = pk.join_match_pairs(lk, lv, rkey, rv, stats=stats, device="cpu")
    assert stats["n_pairs"] == len(port[0])
    return ref, port


@pytest.mark.parametrize("case", [c[0] for c in EDGES])
def test_match_pairs_edges(case):
    _name, *planes = next(c for c in EDGES if c[0] == case)
    (rl, rr), (pl, pr) = _both_pairs(*_planes(*planes))
    assert pl.tolist() == rl.tolist()
    assert pr.tolist() == rr.tolist()


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_match_pairs_random(seed, dtype):
    (rl, rr), (pl, pr) = _both_pairs(*_random_case(seed, dtype))
    assert len(pl) > 0
    assert pl.tolist() == rl.tolist()
    assert pr.tolist() == rr.tolist()


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_build_order_and_words(dtype):
    """K11 (plain) against _join_build_impl: the order of the valid rows,
    and its words the order words of the reference's sorted keys."""
    _lk, _lv, rkey, rv = _random_case(11, dtype)
    rs, order, n_valid = (np.asarray(a) for a in
                          rk.join_build_kernel(rkey, rv))
    words, porder = pk.join_build(torch.from_numpy(rkey),
                                  torch.from_numpy(rv))
    nv = int(n_valid)
    assert porder.tolist() == order[:nv].tolist()
    want = pk.orderable(torch.from_numpy(np.array(rs[:nv])))
    assert torch.equal(words, want)


def _specs(mod, mode: str, seed: int):
    """One side's KeySpecs of `mode`, built the same way in the reference
    module `mod` or the port's, plus a second column in codes mode (mixed
    radix)."""
    rng = np.random.default_rng(seed)
    n = 257
    valid = rng.random(n) > 0.2
    if mode == "codes":
        size = 9
        vals = np.where(valid, rng.integers(0, size, n), -1)
        first = mod.KeySpec("codes", vals, valid, None, size)
    elif mode == "remap":
        size = 12
        table = rng.permutation(size)[:7].astype(np.int64)
        vals = np.where(valid, rng.integers(0, 7, n), -1)
        first = mod.KeySpec("remap", vals, valid, table, size)
    elif mode == "remap_empty":
        valid = np.zeros(n, bool)
        first = mod.KeySpec("remap", np.full(n, -1, np.int64), valid,
                            np.zeros(0, np.int64), 3)
    elif mode == "domain_i64":
        vals = rng.integers(-(1 << 40), 1 << 40, n)
        vals[::17] = I64_MAX
        vals[::19] = I64_MIN
        dom = np.unique(vals[valid])
        first = mod.KeySpec("domain", vals, valid, dom, len(dom))
    else:
        vals = rng.integers(-6, 6, n) * 0.25
        vals[::13] = INF
        vals[::11] = -INF
        vals = mod._norm_f64(vals)
        dom = np.unique(vals[valid])
        first = mod.KeySpec("domain", vals, valid, dom, len(dom))
    v2 = rng.random(n) > 0.1
    second = mod.KeySpec("codes", np.where(v2, rng.integers(0, 5, n), -1),
                         v2, None, 5)
    first.stride, second.stride = 5, 1
    return [first, second], n


@pytest.mark.parametrize("mode", ["codes", "remap", "remap_empty",
                                  "domain_i64", "domain_f64"])
def test_dict_remap(mode):
    rspecs, n = _specs(rdict, mode, 3)
    pspecs, _n = _specs(pdict, mode, 3)
    rkey, rvalid = rdict.host_keys(rspecs, n)
    jkey, jvalid = (np.asarray(a)[:n] for a in
                    rk.dict_remap_keys(rspecs, rk.col.bucket_capacity(n)))
    pkey, pvalid = pdict.host_keys(pspecs, n)
    kkey, kvalid = pk.dict_remap_keys(pspecs, n, "cpu")
    for key, valid in ((pkey, pvalid), (kkey.numpy(), kvalid.numpy())):
        assert valid.tolist() == rvalid.tolist() == jvalid.tolist()
        assert key.tolist() == rkey.tolist()
    if mode == "remap_empty":
        # the reference pads its empty table with a +sentinel, so its
        # codes differ under rows that are all NULL; valid rows agree
        assert not rvalid.any()
    else:
        assert jkey.tolist() == rkey.tolist()


def test_dict_join_keys_match_pairs():
    """A composite string + int key through build_join_specs on both
    packages' RowsSides, K13 and K11 + K12: the pairs of the reference's
    host keys and join_match_pairs."""
    from tidb_tpu.ops.columnar import RowsSide as RRows
    from tidb_tpu.types.datum import Datum as RDatum, NULL as RNULL

    from tidb_tpu_torch import carry

    rng = np.random.default_rng(5)

    def rows(n):
        return [[RDatum.bytes_(rng.choice([b"a", b"bb", b"c"]))
                 if rng.random() > 0.1 else RNULL,
                 RDatum.i64(int(rng.integers(0, 4)))] for _ in range(n)]

    lref, rref = RRows(rows(300)), RRows(rows(40))
    pairs = [(0, 0, True), (1, 1, False)]
    rs = rdict.build_join_specs(lref, rref, pairs, 0.5)
    lport, rport = carry.side_from(lref), carry.side_from(rref)
    ps = pdict.build_join_specs(lport, rport, pairs, 0.5)
    (lk, lv), (rkey, rv) = (rdict.host_keys(s, len(side)) for s, side in
                            ((rs[0], lref), (rs[1], rref)))
    want = rk.join_match_pairs(lk, lv, rkey, rv)
    dk = [pk.dict_remap_keys(s, len(side), "cpu")
          for s, side in ((ps[0], lport), (ps[1], rport))]
    got = pk.join_match_pairs(None, None, None, None,
                              device_keys=(*dk[0], *dk[1]))
    assert len(want[0]) > 0
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
