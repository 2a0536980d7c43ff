"""K8 (`rank_groups`) and K21 (`key_partition`) of the port after their
redesign for Hopper: K8 as a rank pass once a statement (each sorted
position's key gathered once, f64 keys compared by their orderable
images) and an output pass at the rung that holds the groups; K21 as a
counting pass in radix.cuh's shape, with no sort and no search.

- The ranked group-by (`build_ranked_group_fn`, device="cpu": K17's plain
  sort, K8's plain rank and output parts, K4's pass) against the JAX
  package's `build_ranked_group_fn` at several S: NULLs, -0.0 beside +0.0,
  a rung that overflows (the same group count, no outputs), no live row,
  a length that is no multiple of K8's tile. NaN keys of one bit pattern:
  the port makes one group, as the CPU engine does (one encoded key); the
  JAX package compares f64 keys as doubles and opens a group at every NaN
  row (ROADMAP Queue 3, reference fault 7).
- With a recording stub in place of the CUDA library (K8's two launches
  and K21's done in numpy from the sources' contracts: the 16-bit word,
  the tile offsets, the layout), the card wrappers give the plain
  versions' bits, and the rank ladder runs one rank pass a statement: the
  rungs that cannot hold the group count are passed over, the rung taken,
  `last_rank_cap` and the memo as before, every answer equal to the plain
  route's.
- `key_partition_plain` against `np.argsort(membudget.partition_codes)`
  (the JAX package's numpy partitioner) for P in {1, 8, 256, 257, 1024};
  rows past K21's int32 counts raise on the card.
- The constants and C signatures the wrappers share with `rank_groups.cu`
  and `key_partition.cu`.

Tolerance: exact throughout (group ids, counts, layouts; the f64 sums are
of multiples of 0.25, exact in any order).
"""

import ctypes
import os
import re

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
from tidb_tpu.ops import membudget as rmem
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry, errors, tpch
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops import _ext
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops.client import GpuClient
from tidb_tpu_torch.ops.exprc import Program, Unsupported

from torch_parity import port_identity, port_rows, shrink_ranked

I64_MIN = -(1 << 63)
CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
G_STR, G_INT, G_F64, G_NULL, V_INT, V_F64 = 1, 2, 3, 4, 5, 6
CPU = torch.device("cpu")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# ---------------------------------------------------------------------------
# the ranked group-by against the JAX package
# ---------------------------------------------------------------------------

def _batch(seed: int, cap: int, n: int, nan: bool = False):
    rng = np.random.default_rng(seed)
    live = np.arange(cap) < n

    def valid(p=0.15):
        return live & (rng.random(cap) > p)

    sv = valid()
    fv = rng.integers(-3, 3, cap) * 0.5
    fv[::4] = -0.0
    if nan:
        fv[::3] = np.nan            # one bit pattern
    cols = {
        G_STR: rcol.ColumnData(rcol.K_STR, np.where(sv, rng.integers(
            0, 4, cap), -1).astype(np.int64), sv, [b"a", b"b", b"c", b"d"],
            tp=rmy.TypeVarchar),
        G_INT: rcol.ColumnData(rcol.K_I64, rng.integers(-20, 20, cap)
                               .astype(np.int64), valid(), tp=rmy.TypeLong,
                               max_abs=20),
        G_F64: rcol.ColumnData(rcol.K_F64, fv, valid(), tp=rmy.TypeDouble),
        G_NULL: rcol.ColumnData(rcol.K_I64, np.zeros(cap, np.int64),
                                np.zeros(cap, bool), tp=rmy.TypeLong),
        V_INT: rcol.ColumnData(rcol.K_I64, rng.integers(-1000, 1000, cap)
                               .astype(np.int64), valid(),
                               tp=rmy.TypeLonglong, max_abs=1000),
        V_F64: rcol.ColumnData(rcol.K_F64, rng.integers(-400, 400, cap)
                               * 0.25, valid(), tp=rmy.TypeDouble),
    }
    return rcol.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), cols)


def _request(cids: list) -> SelectRequest:
    one = expr_value(RDatum.i64(1))
    return SelectRequest(
        start_ts=1, group_by=[ByItem(c(cid)) for cid in cids],
        aggregates=[expr_agg("count", [one]), expr_agg("sum", [c(V_INT)]),
                    expr_agg("sum", [c(V_F64)]), expr_agg("min", [c(V_F64)]),
                    expr_agg("max", [c(V_INT)]),
                    expr_agg("first_row", [c(cids[0])])])


def _reference(rb, req, cids: list, S: int) -> list:
    specs = rk.lower_aggregates(req, rb)
    kinds = [rb.columns[cid].kind for cid in cids]
    fn = rk.build_ranked_group_fn(None, specs, list(zip(cids, kinds)), S)
    planes = {cid: (jnp.asarray(cd.values), jnp.asarray(cd.valid))
              for cid, cd in rb.columns.items()}
    planes[rk.POS_CID] = (jnp.arange(rb.capacity, dtype=jnp.int64), None)
    wrapper = rk.pack_outputs(fn)
    return port_identity(rk.unpack_outputs(wrapper, np.asarray(jax.jit(
        wrapper)(planes, jnp.asarray(rb.row_mask())))))


def _port(rb, req, cids: list, S: int) -> tuple:
    pb = carry.batch_from(rb)
    prog = Program(pb)
    specs = pk.lower_aggregates(carry.request_from(req), pb, prog)
    fn = pk.build_ranked_group_fn(prog, None, specs, cids)
    planes = pk.batch_planes(pb, CPU)
    live = pk.device_live(pb, CPU)
    return fn(fn.prepare(planes, live), planes, S)


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind == "f" or want.dtype.kind == "f":
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), what)


# (cap, live rows, S list): a length that is no multiple of K8's tile, a
# rung that overflows beside one that holds, no live row
SHAPES = {"3 tiles and a part": (3 * 1024 + 333, 2900, (65, 4097)),
          "one part tile": (700, 650, (9, 1025)),
          "no live row": (1500, 0, (5,))}
GROUPS = {"string, int, f64 with -0.0": [G_STR, G_INT, G_F64],
          "f64 with -0.0, all-NULL": [G_F64, G_NULL]}


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ranked_group_by_matches_jax(shape, groups):
    cap, n, caps = SHAPES[shape]
    cids = GROUPS[groups]
    rb = _batch(len(shape) + len(groups), cap, n)
    req = _request(cids)
    for S in caps:
        ref = _reference(rb, req, cids, S)
        ngroups, got = _port(rb, req, cids, S)
        assert ngroups == int(ref[0]), (S, ngroups, ref[0])
        if ngroups > S - 1:
            assert got is None
            continue
        assert len(got) == len(ref)
        _equal(got[1], ref[1], "row_count")
        for j in range(len(cids)):
            rep, nonnull = 2 + 2 * j, 3 + 2 * j
            _equal(got[nonnull][:ngroups], ref[nonnull][:ngroups],
                   f"non-null {j}")
            keep = np.asarray(ref[nonnull][:ngroups]).astype(bool)
            _equal(got[rep][:ngroups][keep], ref[rep][:ngroups][keep],
                   f"representative {j}")
        for i in range(2 + 2 * len(cids), len(ref)):
            _equal(got[i], ref[i], f"output {i}")


def test_nan_keys_of_one_pattern_group_once():
    """One group for every NaN of one bit pattern, as the CPU engine
    groups (codec.encode_value of equal bits); the JAX package opens a
    group at every NaN row (reference fault 7)."""
    cap, n = 1500, 1400
    rb = _batch(31, cap, n, nan=True)
    cids = [G_F64]
    req = _request(cids)
    ngroups, got = _port(rb, req, cids, 4097)
    fv, ok = rb.columns[G_F64].values[:n], rb.columns[G_F64].valid[:n]
    img = np.where(fv == 0.0, 0.0, fv).view(np.int64)
    keys = {("null",) if not o else ("v", int(b)) for b, o in zip(img, ok)}
    assert ngroups == len(keys)
    nan_rows = int((np.isnan(fv) & ok).sum())
    assert nan_rows > 1
    counts = np.asarray(got[1][:ngroups])
    reps = np.asarray(got[2][:ngroups])
    nonnull = np.asarray(got[3][:ngroups]).astype(bool)
    (g,) = np.nonzero(nonnull & np.isnan(reps))[0]
    assert counts[g] == nan_rows
    ref = _reference(rb, req, cids, 4097)
    assert int(ref[0]) == ngroups - 1 + nan_rows


# ---------------------------------------------------------------------------
# the card wrappers over a recording stub of the library
# ---------------------------------------------------------------------------

def _arr(ptr: int, n: int, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    raw = (ctypes.c_uint8 * max(n * dtype.itemsize, 1)).from_address(ptr)
    return np.frombuffer(raw, dtype=dtype, count=n)


def _wr(ptr: int, values: np.ndarray) -> None:
    ctypes.memmove(ptr, np.ascontiguousarray(values).ctypes.data,
                   values.nbytes)


class _Recorder:
    """A stand-in for the K8 and K21 libraries: records each launch and
    computes what the sources say it writes, in numpy."""

    def __init__(self):
        self.calls = []

    def rank_groups_rank_launch(self, n, order, dead, ncols, vals, valid,
                                f64, word, totals, offs, ngroups, _s):
        o = _arr(order, n, np.int64)
        live = _arr(dead, n, np.uint8) == 0
        diff = np.zeros(n, bool)
        diff[0] = True
        for j in range(ncols):
            ok = _arr(valid[j], n, np.uint8)[o] != 0
            img = np.where(ok, _arr(vals[j], n, np.int64)[o], 0)
            if (f64 >> j) & 1:
                img = np.where(img == I64_MIN, 0, img)
            diff[1:] |= (img[1:] != img[:-1]) | (ok[1:] != ok[:-1])
        opens = (live & diff).astype(np.int64)
        tiles = -(-n // pk.K8_TILE)
        pad = np.zeros(tiles * pk.K8_TILE, np.int64)
        pad[:n] = opens
        local = np.cumsum(pad.reshape(tiles, pk.K8_TILE), 1)
        tot = local[:, -1].copy()
        w = (local.reshape(-1)[:n] << 2) | (opens << 1) | live
        _wr(word, w.astype(np.uint16))
        _wr(totals, tot)
        _wr(offs, np.cumsum(tot) - tot)
        _wr(ngroups, np.array([tot.sum()], np.int64))
        self.calls.append(("rank", n, ncols))
        return 0

    def rank_groups_out_launch(self, n, word, offs, ngroups, order, ncols,
                               vals, valid, S, gid, starts, rep, nonnull,
                               _s):
        w = _arr(word, n, np.uint16).astype(np.int64)
        off = _arr(offs, -(-n // pk.K8_TILE), np.int64)
        ng = int(_arr(ngroups, 1, np.int64)[0])
        rank = off[np.arange(n) // pk.K8_TILE] + (w >> 2) - 1
        _wr(gid, np.where((w & 1).astype(bool) & (rank < S - 1), rank,
                          S - 1))
        st = np.full(S, -1, np.int64)
        rp = np.zeros((ncols, S), np.int64)
        nn = np.zeros((ncols, S), np.uint8)
        pos = np.nonzero((w & 2).astype(bool) & (rank < S))[0]
        assert len(pos) == min(ng, S)
        st[rank[pos]] = pos
        rows = _arr(order, n, np.int64)[pos]
        for j in range(ncols):
            rp[j, rank[pos]] = _arr(vals[j], n, np.int64)[rows]
            nn[j, rank[pos]] = _arr(valid[j], n, np.uint8)[rows]
        _wr(starts, st)
        _wr(rep, rp)
        _wr(nonnull, nn)
        self.calls.append(("out", n, S))
        return 0

    def key_partition_scratch_ints(self, n, parts):
        return parts * (-(-n // 2048) + 1)

    def key_partition_launch(self, n, key, valid, is_f64, parts, counts,
                             sel, offsets, _s):
        k = _arr(key, n, np.float64 if is_f64 else np.int64)
        codes = rmem.partition_codes(k, _arr(valid, n, np.uint8) != 0,
                                     parts)
        _wr(sel, np.argsort(codes, kind="stable").astype(np.int64))
        _wr(offsets, np.r_[0, np.cumsum(np.bincount(codes,
                                                    minlength=parts))])
        self.calls.append(("k21", n, parts))
        return 0


@pytest.fixture
def stub_card(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    # the process's counts stay as they were: other tests read them
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    return rec


def _on_card(monkeypatch):
    """Every tensor is taken for a card tensor."""
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")


def _rank_case(seed: int, n: int, nan: bool = False) -> tuple:
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    a = t(rng.integers(-3, 4, n).astype(np.int64))
    f = rng.integers(0, 3, n) * 1.5
    f[rng.random(n) < 0.3] = -0.0
    if nan:
        f[rng.random(n) < 0.2] = np.nan
    f = t(f)
    a_ok, f_ok = t(rng.random(n) > 0.2), t(rng.random(n) > 0.2)
    mask = t(rng.random(n) < 0.7)
    cols = [(a, a_ok), (f, f_ok)]
    order, dead = pk.lexsort_plain(pk.ranked_keys(cols, mask))
    return order, dead, cols


@pytest.mark.parametrize("n", [1, 1024, 5 * 1024 + 333])
@pytest.mark.parametrize("nan", [False, True], ids=["zeros", "nan"])
def test_k8_card_wrappers_equal_the_plain_parts(stub_card, monkeypatch, n,
                                                nan):
    order, dead, cols = _rank_case(n, n, nan)
    pp = pk.rank_groups_rank_plain(order, dead, cols)
    _on_card(monkeypatch)
    rp = pk.rank_groups_rank(order, dead, cols)
    assert rp.rank is None and rp.word.dtype == torch.uint16
    assert torch.equal(rp.ngroups, pp.ngroups)
    for S in (1, 5, 1025):
        got = pk.rank_groups_out(rp, S)
        for g, w in zip(got, pk.rank_groups_out_plain(pp, S)):
            assert torch.equal(g, w), S
    assert [k for k, *_a in stub_card.calls] == ["rank", "out", "out", "out"]
    assert pk.LAUNCHES["rank_groups"] == 1
    assert pk.LAUNCHES["rank_groups_out"] == 3


def test_k8_card_limits(stub_card, monkeypatch):
    order, dead, cols = _rank_case(3, 100)
    _on_card(monkeypatch)
    with pytest.raises(Unsupported, match="group columns"):
        pk.rank_groups_rank(order, dead, cols * 33)
    with pytest.raises(errors.DeviceError, match="column"):
        pk.rank_groups_rank(order, dead, [])
    with pytest.raises(errors.DeviceError, match="dead flags"):
        pk.rank_groups_rank(order, dead.bool(), cols)
    rp = pk.rank_groups_rank(order, dead, cols)
    with pytest.raises(errors.DeviceError, match="S >= 1"):
        pk.rank_groups_out(rp, 0)
    empty = torch.zeros(0, dtype=torch.int64)
    none = torch.zeros(0, dtype=torch.bool)
    rp = pk.rank_groups_rank(empty, none.to(torch.uint8), [(empty, none)])
    gid, starts, rep, nonnull = pk.rank_groups_out(rp, 3)
    assert int(rp.ngroups[0]) == 0 and gid.numel() == 0
    assert starts.tolist() == [-1] * 3 and not rep.any() and not nonnull.any()
    assert [k for k, *_a in stub_card.calls] == ["rank"]


LADDER_CAPS = (9, 257, 4097)
TUPLE_CAPS = (9, 65, 257)


def _slice3(n_rows: int):
    data = tpch.generate(n_rows, 4)
    return tpch.batch(data, [tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
                             tpch.C_SHIPDATE, tpch.C_COMMITDATE,
                             tpch.C_RECEIPTDATE])


def _serve_twice(monkeypatch, card: bool, make, batch) -> tuple:
    client = GpuClient(MemStore([], []), device="cpu")
    out = []
    with monkeypatch.context() as m:
        if card:
            for name in ("rank_groups_rank", "rank_groups_out"):
                orig = getattr(pk, name)

                def call(*a, orig=orig):
                    with monkeypatch.context() as mm:
                        _on_card(mm)
                        return orig(*a)
                m.setattr(pk, name, call)
        for _ in range(2):
            out.append(port_rows(client.serve(make(), batch)))
    return client, out


@pytest.mark.parametrize("name,caps", [("ranked_dates", LADDER_CAPS),
                                       ("tuple_dates", TUPLE_CAPS)])
def test_ladder_runs_one_rank_pass_a_statement(stub_card, monkeypatch, name,
                                               caps):
    shrink_ranked(monkeypatch, 4096, caps)
    make = dict(tpch.SLICE3)[name]
    batch = _slice3(3000)
    plain, want = _serve_twice(monkeypatch, False, make, batch)
    assert stub_card.calls == []
    card, got = _serve_twice(monkeypatch, True, make, batch)
    assert got == want and got[0] == got[1]
    kinds = [k for k, *_a in stub_card.calls]
    for client in (plain, card):
        assert list(client._rank_cap_start.values()) == [
            caps[-1] if name == "ranked_dates" else caps[-1] + 1]
    if name == "ranked_dates":
        # one rank pass and one output pass a statement, at the top rung:
        # the two below it cannot hold the groups and are passed over
        assert kinds == ["rank", "out", "rank", "out"]
        assert [a for k, *a in stub_card.calls if k == "out"] == [
            [batch.capacity, caps[-1]]] * 2
        assert card.stats["ranked"] == plain.stats["ranked"] == 2
        assert card.last_rank_cap == plain.last_rank_cap == caps[-1]
    else:
        # the first statement's rank pass overflows every rung; the repeat
        # goes straight to the tuple codes from the memo
        assert kinds == ["rank"]
        assert card.stats["tuple_grouped"] == plain.stats["tuple_grouped"] \
            == 2
        assert card.stats["ranked"] == plain.stats["ranked"] == 0


def test_rank_memo_start_skips_lower_rungs(monkeypatch):
    """A memo at a rung above the groups' first fitting one starts there:
    the output pass runs at the memoized rung, as before."""
    shrink_ranked(monkeypatch, 4096, LADDER_CAPS)
    batch = _slice3(200)
    client = GpuClient(MemStore([], []), device="cpu")
    sel = tpch.ranked_dates()
    first = port_rows(client.serve(sel, batch))
    assert client.last_rank_cap == 257
    (key,) = client._rank_cap_start
    client._rank_cap_start[key] = 4097
    again = port_rows(client.serve(sel, batch))
    assert client.last_rank_cap == 4097 and again == first


# ---------------------------------------------------------------------------
# K21
# ---------------------------------------------------------------------------

def _k21_keys(seed: int, n: int, kind: str):
    rng = np.random.default_rng(seed)
    if kind == "f64":
        k = rng.integers(-6, 6, n) * 0.25
        k[::3] = -0.0
        k[::7] = np.nan
    else:
        k = rng.integers(-(1 << 62), 1 << 62, n)
    return k, rng.random(n) > 0.1


@pytest.mark.parametrize("parts", [1, 8, 256, 257, 1024])
@pytest.mark.parametrize("kind", ["int64", "f64"])
def test_key_partition_plain_is_the_stable_argsort(parts, kind):
    n = 5000 + parts
    k, v = _k21_keys(parts, n, kind)
    codes = rmem.partition_codes(k, v, parts)
    sel, offs = pk.key_partition_plain(torch.from_numpy(k),
                                       torch.from_numpy(v), parts)
    assert np.array_equal(sel.numpy(), np.argsort(codes, kind="stable"))
    assert np.array_equal(offs.numpy(), np.r_[0, np.cumsum(np.bincount(
        codes, minlength=parts))])


@pytest.mark.parametrize("parts", [8, 257])
def test_key_partition_card_wrapper(stub_card, monkeypatch, parts):
    k, v = _k21_keys(parts + 1, 3000, "f64")
    want = pk.key_partition_plain(torch.from_numpy(k), torch.from_numpy(v),
                                  parts)
    _on_card(monkeypatch)
    got = pk.key_partition(torch.from_numpy(k), torch.from_numpy(v), parts)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert stub_card.calls == [("k21", 3000, parts)]
    assert pk.LAUNCHES["key_partition"] == 1


def test_key_partition_rows_past_int32_raise(stub_card, monkeypatch):
    _on_card(monkeypatch)
    n = pk.K21_MAX_ROWS + 1
    key = torch.zeros(1, dtype=torch.int64).expand(n)
    valid = torch.zeros(1, dtype=torch.bool).expand(n)
    with pytest.raises(errors.DeviceError, match="rows"):
        pk.key_partition(key, valid, 8)
    assert stub_card.calls == []


# ---------------------------------------------------------------------------
# constants and signatures against the .cu sources
# ---------------------------------------------------------------------------

def _define(src: str, name: str) -> str:
    return re.search(r"#define %s (.+?)(\s*//.*)?$" % name, src,
                     re.M).group(1)


def test_k8_constants_match_source():
    src = _source("rank_groups.cu")
    assert int(_define(src, "K8_MAX_COLS")) == pk.K8_MAX_COLS
    tile = eval(_define(src, "K8_TILE").replace(
        "K8_THREADS", _define(src, "K8_THREADS")).replace(
        "K8_ITEMS", _define(src, "K8_ITEMS")))
    assert tile == pk.K8_TILE
    # the column table by value, no upload and no memset; images, not
    # doubles, compared
    assert "__grid_constant__ K8Cols" in src
    for gone in ("cudaMemsetAsync", "k8_differs", "as_f64("):
        assert gone not in src


def test_k21_constants_match_source():
    src = _source("key_partition.cu")
    assert int(_define(src, "K21_MAX_PARTS")) == pk.KEY_PARTITIONS_MAX
    assert int(_define(src, "K21_MAX_ROWS").rstrip("L"), 16) \
        == pk.K21_MAX_ROWS
    assert '#include "radix.cuh"' in src
    # a counting pass: no bitonic sort, no binary search, no one-block
    # scan over every (partition, tile) count
    for gone in ("tile_sort", "lower_bound", "scan_totals", "bitonic"):
        assert gone not in src
    radix = _source("radix.cuh")
    for shared in ("radix_warp_rank", "radix_tile_starts"):
        assert f"{shared}<BINS>" in src and f"{shared}<BINS>" in radix


@pytest.mark.parametrize("name", ["rank_groups", "key_partition"])
def test_signatures_match_the_sources(name):
    src = _source(name + ".cu")
    found = re.findall(r'extern "C" \w+ (\w+)\((.*?)\)\s*\{', src, re.S)
    assert set(_ext.SIGNATURES[name]) == {fn for fn, _p in found}
    for fn, params in found:
        argtypes, _rt = _ext.SIGNATURES[name][fn]
        assert len(argtypes) == len([p for p in params.split(",")
                                     if p.strip()]), fn
