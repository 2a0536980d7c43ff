"""The port's budget-aware join router (ops.membudget.join_match_pairs),
its grace-hash passes and the key-partitioned mesh probe (ops.mesh, K21
key_partition + K11 within partitions + the segmented K12), held against
the JAX package's membudget on the same numpy inputs.

- tests/test_membudget.py's TestLedger partition discipline: the port's
  partition_codes (the numpy front of kernels.partition_codes_t, K21's
  plain version) equals the reference's bit for bit; K21's plain layout
  is the reference's per-partition flatnonzero order.
- TestPartitionedPasses: the passes lay the keys out with K21 on their
  device (never the host partition_codes); int keys, f64 keys with
  +-0.0, NULL keys, budget 0 and an empty build side (one pass), a hot
  key that takes the salted
  split, a DeviceOOM that escalates once, escalation past its bound, a
  torch out-of-memory mapped to DeviceOOM, and a DeviceError that is not a
  memory fault, which raises at once. The pairs equal the budget-0 pairs
  exactly; the pass counts equal the reference's under the same budget
  and headroom (the reference's ledger carries the pins of other tests in
  the worker, so its budget functions are pinned to the port's figures).
- TestMeshPartitionedProbe's parity at 8 shards (a port mesh of 8 virtual
  CPU shards; the reference's 8 virtual CPU devices), with the fault rule
  of the port: a fault on the mesh rung raises; the rung charges the
  ledger its whole working set (its shards share one device).
- TestExecutorRoute's SQL shapes (JOIN_Q, OUTER_Q, AGG_Q, the dictionary
  join, whose K13 planes stay on the device): recorded through a JAX Session and replayed
  through the port's scans and HashJoinExec (tests/test_torch_join.py's
  helpers) at budget 0 and squeezed: the same pairs, joined rows and
  fused rows.

A DeviceOOM is injected by a monkeypatched spy, as
tests/test_torch_extsort.py does; the reference's own failpoint drives
its side.
"""

import numpy as np
import pytest
import torch

from tidb_tpu import failpoint
from tidb_tpu.ops import membudget as rmb
from tidb_tpu.parallel import CoprMesh as RefMesh

from tidb_tpu_torch import carry, errors
from tidb_tpu_torch.ops import kernels, membudget
from tidb_tpu_torch.ops import mesh as mesh_mod
from tidb_tpu_torch.parallel import CoprMesh

from test_torch_join import _norm, _port_join, _record
from torch_parity import port_ledger, release, session  # noqa: F401


@pytest.fixture(autouse=True)
def _ledger(port_ledger):  # noqa: F811
    yield
    failpoint.disable_all()


def _mk_keys(seed=7, n_l=30_000, n_r=12_000, ndv=5000):
    """tests/test_membudget.py's _mk_keys."""
    rng = np.random.default_rng(seed)
    lkey = rng.integers(0, ndv, n_l).astype(np.int64)
    rkey = rng.integers(0, ndv, n_r).astype(np.int64)
    lvalid = rng.random(n_l) > 0.05
    rvalid = rng.random(n_r) > 0.05
    return lkey, lvalid, rkey, rvalid


def _float_keys(seed=11):
    """test_float_key_parity_signed_zero's keys."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([rng.random(2000) * 50, np.array([0.0, -0.0])])
    lk = rng.choice(base, 20_000)
    rk = rng.choice(base, 9_000)
    lv = rng.random(20_000) > 0.1
    rv = rng.random(9_000) > 0.1
    return lk, lv, rk, rv


def _null_keys(seed=17):
    """Half the rows of each side NULL, with live keys beside them."""
    lk, lv, rk, rv = _mk_keys(seed=seed, n_l=12_000, n_r=6_000, ndv=900)
    rng = np.random.default_rng(seed)
    return lk, lv & (rng.random(len(lv)) > 0.5), rk, \
        rv & (rng.random(len(rv)) > 0.5)


def _oracle(keys) -> tuple:
    """The single pass at budget 0 (the port's own route there)."""
    membudget.set_budget(0)
    return membudget.join_match_pairs(*keys, device="cpu")


def _ref_pairs(keys, budget: int, mp, stats=None, mesh=None) -> tuple:
    """The reference's router at `budget` with its headroom the whole
    budget, as the port's ledger (no pins on the CPU) has it."""
    mp.setattr(rmb, "budget_bytes", lambda: budget)
    mp.setattr(rmb, "headroom", lambda: budget)
    return rmb.join_match_pairs(*keys, stats=stats, mesh=mesh)


def _same(a, b) -> None:
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


class _Spy:
    """kernels.join_match_pairs counted, failing where `fail(call)` says
    (call counts from 1)."""

    def __init__(self, mp, fail=None, target="join_match_pairs"):
        self.calls = 0
        inner = getattr(kernels, target)

        def spy(*a, **kw):
            self.calls += 1
            if fail is not None:
                fail(self.calls)
            return inner(*a, **kw)

        mp.setattr(kernels, target, spy)


def _oom(_call):
    raise errors.DeviceOOM("injected device OOM (join pass)")


def _oom_first(call):
    if call == 1:
        _oom(call)


def _no_host_partition(mp) -> None:
    """The router partitions on the keys' device (K21); the host
    partition_codes must not run."""
    def host(*_a, **_kw):
        raise AssertionError("the router partitioned on the host")
    mp.setattr(membudget, "partition_codes", host)


# ---------------------------------------------------------------------------
# the partition discipline and K21's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 2, 8, 16, 1024])
def test_partition_codes_discipline(parts):
    vals = np.array([3.5, 0.0, -0.0, 3.5, 9.25, np.inf, -np.inf])
    valid = np.array([True, True, True, True, False, True, True])
    ints = np.array([5, -5, 5, (1 << 62), (1 << 63) - 1, -(1 << 63), 0],
                    dtype=np.int64)
    for k, v in ((vals, valid), (ints, np.ones(len(ints), bool)),
                 _mk_keys(seed=parts, n_l=5000)[:2],
                 _float_keys()[:2]):
        want = rmb.partition_codes(k, v, parts)
        assert np.array_equal(membudget.partition_codes(k, v, parts), want)
        got = kernels.partition_codes_t(torch.from_numpy(k),
                                        torch.from_numpy(v), parts)
        assert np.array_equal(got.numpy(), want)
    part = membudget.partition_codes(vals, valid, parts)
    assert part[0] == part[3] and part[1] == part[2] and part[4] == 0
    assert ((part >= 0) & (part < parts)).all()


@pytest.mark.parametrize("case", ["int", "f64", "nulls", "one_key",
                                  "all_null", "empty"])
@pytest.mark.parametrize("parts", [1, 8, 1024])
def test_key_partition_layout_is_the_reference(case, parts):
    """K21's plain version: the rows of each partition of the reference's
    partition_codes in row order, partition after partition (the
    reference's l_sel / r_sel of mesh.join_probe_partitioned), and where
    each partition starts."""
    lk, lv, _rk, _rv = {"int": lambda: _mk_keys(n_l=4100),
                        "f64": _float_keys, "nulls": _null_keys}.get(
        case, lambda: (None,) * 4)()
    if case == "one_key":
        lk, lv = np.full(3000, 42, np.int64), np.ones(3000, bool)
    if case == "all_null":
        lk, lv = np.arange(3000, dtype=np.int64), np.zeros(3000, bool)
    if case == "empty":
        lk, lv = np.zeros(0, np.int64), np.zeros(0, bool)
    sel, offs = kernels.key_partition(torch.from_numpy(lk),
                                      torch.from_numpy(lv), parts)
    codes = rmb.partition_codes(lk, lv, parts)
    want = [np.flatnonzero(codes == s) for s in range(parts)]
    assert np.array_equal(sel.numpy(), np.concatenate(want))
    assert offs.tolist() == [0] + np.cumsum([len(w) for w in want]).tolist()


@pytest.mark.parametrize("keys", ["int", "f64", "nulls"])
def test_segmented_build_and_probe_plain(keys):
    """K11 within K21's partitions and the segmented K12 (plain versions):
    sorted stably by left row, the pairs of the single pass; each
    partition's total the pairs whose left key falls in it."""
    k = {"int": _mk_keys, "f64": _float_keys, "nulls": _null_keys}[keys]()
    lk, lv, rk, rv = (torch.from_numpy(a) for a in k)
    P = 8
    l_sel, l_off = kernels.key_partition(lk, lv, P)
    r_sel, r_off = kernels.key_partition(rk, rv, P)
    words, rows, bounds = kernels.join_build_partitioned(
        rk[r_sel], rv[r_sel], r_off)
    pairs, totals = kernels.join_probe_partitioned(
        words, r_sel[rows], bounds, lk[l_sel], lv[l_sel], l_off, l_sel)
    perm = kernels.sort_perm([pairs[0]], pairs.shape[1])
    want = _oracle(k)
    assert np.array_equal(pairs[0][perm].numpy(), want[0])
    assert np.array_equal(pairs[1][perm].numpy(), want[1])
    lcode = rmb.partition_codes(k[0], k[1], P)
    assert np.array_equal(totals, np.bincount(lcode[want[0]], minlength=P))


# ---------------------------------------------------------------------------
# grace-hash passes on one device
# ---------------------------------------------------------------------------

class TestPartitionedPasses:
    @pytest.mark.parametrize("keys,budget", [("int", 64 * 1024),
                                             ("f64", 48 * 1024),
                                             ("nulls", 32 * 1024)])
    def test_parity_and_passes(self, monkeypatch, keys, budget):
        k = {"int": _mk_keys, "f64": _float_keys, "nulls": _null_keys}[keys]()
        want = _oracle(k)
        rst: dict = {}
        _same(_ref_pairs(k, budget, monkeypatch, rst), want)
        membudget.set_budget(budget)
        spy = _Spy(monkeypatch)
        k21 = _Spy(monkeypatch, target="key_partition")
        _no_host_partition(monkeypatch)
        st: dict = {}
        got = membudget.join_match_pairs(*k, stats=st, device="cpu")
        _same(got, want)
        assert st["partitioned"] and st["passes"] >= 2
        assert spy.calls == st["passes"] and k21.calls == 2
        for key in ("passes", "partitions", "partition_escalations",
                    "salted_splits"):
            assert st[key] == rst[key], key

    def test_budget_zero_and_empty_build_are_one_pass(self, monkeypatch):
        k = _mk_keys(seed=3)
        spy = _Spy(monkeypatch)
        st: dict = {}
        got = _oracle(k)
        membudget.set_budget(0)
        membudget.join_match_pairs(*k, stats=st, device="cpu")
        assert "partitioned" not in st and spy.calls == 2
        membudget.set_budget(1024)
        empty = (k[0], k[1], np.zeros(0, np.int64), np.zeros(0, bool))
        st = {}
        li, ri = membudget.join_match_pairs(*empty, stats=st, device="cpu")
        assert "partitioned" not in st and spy.calls == 3
        assert len(li) == len(ri) == 0 and len(got[0]) > 0

    def test_oom_escalates_once(self, monkeypatch):
        k = _mk_keys(seed=5)
        want = _oracle(k)
        budget = 128 * 1024
        failpoint.enable("device/oom", when=("first", 1))
        rst: dict = {}
        try:
            _same(_ref_pairs(k, budget, monkeypatch, rst), want)
        finally:
            failpoint.disable("device/oom")
        membudget.set_budget(budget)
        spy = _Spy(monkeypatch, fail=_oom_first)
        k21 = _Spy(monkeypatch, target="key_partition")
        st: dict = {}
        _same(membudget.join_match_pairs(*k, stats=st, device="cpu"), want)
        assert st["partition_escalations"] == 1 and st["partitions"] >= 4
        assert spy.calls == st["passes"] + 1
        # each round lays out both sides; the second only the unfinished
        assert k21.calls == 4
        for key in ("passes", "partitions", "partition_escalations"):
            assert st[key] == rst[key], key

    def test_torch_oom_maps_to_device_oom(self, monkeypatch):
        k = _mk_keys(seed=5)
        want = _oracle(k)
        membudget.set_budget(128 * 1024)

        def cuda_oom(call):
            if call == 2:
                raise torch.cuda.OutOfMemoryError("injected")

        _Spy(monkeypatch, fail=cuda_oom)
        st: dict = {}
        _same(membudget.join_match_pairs(*k, stats=st, device="cpu"), want)
        assert st["partition_escalations"] == 1

    def test_oom_escalation_is_bounded(self, monkeypatch):
        k = _mk_keys(seed=6, n_l=8_000, n_r=4_000)
        membudget.set_budget(32 * 1024)
        spy = _Spy(monkeypatch, fail=_oom)
        with pytest.raises(errors.DeviceOOM):
            membudget.join_match_pairs(*k, device="cpu")
        assert spy.calls > membudget.MAX_ESCALATIONS

    def test_device_error_raises_at_once(self, monkeypatch):
        k = _mk_keys(seed=6, n_l=8_000, n_r=4_000)
        membudget.set_budget(32 * 1024)

        def fault(_call):
            raise errors.DeviceError("injected launch failure")

        spy = _Spy(monkeypatch, fail=fault)
        with pytest.raises(errors.DeviceError) as e:
            membudget.join_match_pairs(*k, device="cpu")
        assert not isinstance(e.value, errors.DeviceOOM)
        assert spy.calls == 1

    def test_hot_key_takes_the_salted_split(self, monkeypatch):
        """One key owns both sides: after an escalation its partition is
        still over the pass target, so it runs as salted probe chunks x
        build blocks; the pairs keep the single-pass order."""
        rng = np.random.default_rng(23)
        k = (np.full(3000, 5, np.int64), rng.random(3000) > 0.1,
             np.full(200, 5, np.int64), rng.random(200) > 0.1)
        want = _oracle(k)
        budget = 16 * 1024
        failpoint.enable("device/oom", when=("first", 1))
        rst: dict = {}
        try:
            _same(_ref_pairs(k, budget, monkeypatch, rst), want)
        finally:
            failpoint.disable("device/oom")
        membudget.set_budget(budget)
        _Spy(monkeypatch, fail=_oom_first)
        st: dict = {}
        _same(membudget.join_match_pairs(*k, stats=st, device="cpu"), want)
        assert st["salted_splits"] == rst["salted_splits"] == 1
        assert st["passes"] == rst["passes"] > 2


# ---------------------------------------------------------------------------
# the key-partitioned mesh probe
# ---------------------------------------------------------------------------

class TestMeshPartitionedProbe:
    @pytest.mark.parametrize("keys", ["int", "f64", "nulls"])
    def test_parity_at_8_shards(self, monkeypatch, keys):
        k = {"int": lambda: _mk_keys(seed=9), "f64": _float_keys,
             "nulls": _null_keys}[keys]()
        want = _oracle(k)
        rst: dict = {}
        ref_mesh = RefMesh()
        assert ref_mesh.n == 8
        _same(_ref_pairs(k, 64 * 1024, monkeypatch, rst, ref_mesh), want)
        membudget.set_budget(64 * 1024)
        launches = dict(kernels.LAUNCHES)
        probes = mesh_mod.stats["partitioned_probes"]
        st: dict = {}
        got = membudget.join_match_pairs(*k, stats=st,
                                         mesh=CoprMesh(["cpu"] * 8))
        _same(got, want)
        for key in ("mesh_partitioned", "mesh_shards", "passes",
                    "partitions"):
            assert st[key] == rst[key], key
        assert st["mesh_shards"] == 8 and st["partitioned"]
        assert st["shard_pairs"].sum() == len(want[0])
        assert mesh_mod.stats["partitioned_probes"] == probes + 1
        assert kernels.LAUNCHES == launches      # plain versions on CPU

    def test_device_keys_need_no_host_planes(self, monkeypatch):
        """Keys on the device alone (the dictionary route's K13 planes):
        the mesh rung and the passes both work on them where they lie."""
        k = _mk_keys(seed=9)
        want = _oracle(k)
        membudget.set_budget(64 * 1024)
        _no_host_partition(monkeypatch)
        keys = tuple(torch.from_numpy(a) for a in k)
        for mesh in (CoprMesh(["cpu"] * 8), None):
            st: dict = {}
            got = membudget.join_match_pairs(None, None, None, None,
                                             stats=st, mesh=mesh,
                                             device_keys=keys)
            _same(got, want)
            assert st["partitioned"]
            assert bool(st.get("mesh_partitioned")) == (mesh is not None)

    def test_the_rung_charges_its_whole_working_set(self):
        """The shards of a port mesh share one device: the rung's
        reservation is the single pass's estimate plus the layouts, not
        the reference's 1/S share."""
        k = _mk_keys(seed=9)
        membudget.set_budget(64 * 1024)
        membudget.reset_highwater()
        membudget.join_match_pairs(*k, mesh=CoprMesh(["cpu"] * 8))
        n_l, n_r = len(k[0]), len(k[2])
        assert membudget.highwater()["join_mesh"] == \
            membudget.join_bytes_estimate(n_l, n_r) \
            + (n_l + n_r) * membudget.LAYOUT_ROW_BYTES

    def test_fewer_probe_rows_than_shards_take_the_passes(self):
        rng = np.random.default_rng(4)
        k = (np.arange(5, dtype=np.int64), np.ones(5, bool),
             rng.integers(0, 5, 6000), rng.random(6000) > 0.1)
        want = _oracle(k)
        membudget.set_budget(32 * 1024)
        st: dict = {}
        _same(membudget.join_match_pairs(*k, stats=st,
                                         mesh=CoprMesh(["cpu"] * 8)), want)
        assert st["partitioned"] and "mesh_partitioned" not in st
        assert st["passes"] >= 1

    def test_a_fault_on_the_mesh_rung_raises(self, monkeypatch):
        """The reference degrades to the replicated probe; the port
        raises (ROADMAP Queue 3, divergences by design)."""
        k = _mk_keys(seed=13)
        membudget.set_budget(64 * 1024)

        def fault(_call):
            raise errors.DeviceError("injected K21 fault")

        spy = _Spy(monkeypatch, fail=fault, target="key_partition")
        passes = _Spy(monkeypatch)
        with pytest.raises(errors.DeviceError, match="injected"):
            membudget.join_match_pairs(*k, mesh=CoprMesh(["cpu"] * 8))
        assert spy.calls == 1 and passes.calls == 0


# ---------------------------------------------------------------------------
# the executor's route: SQL recorded through a JAX Session
# ---------------------------------------------------------------------------

N_PROBE = 3000
N_BUILD = 2000
JOIN_Q = "select l.id, r.w from l join r on l.k = r.k order by l.id, r.w"
OUTER_Q = ("select l.id, r.w from l left join r on l.k = r.k "
           "order by l.id, r.w")
AGG_Q = "select count(*), sum(r.w), min(l.id) from l join r on l.k = r.k"
DICT_Q = ("select sl.id, sr.w from sl join sr on sl.s = sr.s "
          "order by sl.id, sr.w")


@pytest.fixture(scope="module")
def recorded():
    """test_membudget.py's _join_store tables and its dictionary join's,
    each statement recorded at the reference's budget (the CPU rig
    resolves it to 0: the single pass)."""
    out = {}
    store, s, rec = session("memory://torch_membudget")
    s.execute("create database mb")
    s.execute("use mb")
    s.execute("create table l (id bigint primary key, k bigint)")
    s.execute("create table r (id bigint primary key, k bigint, w bigint)")
    s.execute("insert into l values " + ", ".join(
        f"({i}, {i % (N_BUILD + 40)})" for i in range(1, N_PROBE + 1)))
    s.execute("insert into r values " + ", ".join(
        f"({i}, {i % N_BUILD}, {i * 7})" for i in range(1, N_BUILD + 1)))
    s.execute("create table sl (id bigint primary key, s varchar(16))")
    s.execute("create table sr (id bigint primary key, s varchar(16), "
              "w bigint)")
    s.execute("insert into sl values " + ", ".join(
        f"({i}, 'k{i % 600}')" for i in range(1, 2501)))
    s.execute("insert into sr values " + ", ".join(
        f"({i}, 'k{i % 500}', {i})" for i in range(1, 2001)))
    for sql in (JOIN_Q, OUTER_Q, AGG_Q, DICT_Q):
        out[sql] = _record(store, s, rec, sql, 1)
        assert out[sql]["path"] == "device", sql
    yield out
    release(out)


def _replay(ref: dict, budget: int, mesh=None):
    """The statement's join through the port's scans (device="cpu")."""
    membudget.set_budget(budget)
    port = _port_join(ref, "scan")
    if mesh is not None:
        port.mesh = mesh
    res = port.device_join_result()
    assert res.l_idx.tolist() == ref["l_idx"].tolist()
    assert res.r_idx.tolist() == ref["r_idx"].tolist()
    return port


@pytest.mark.parametrize("sql", [JOIN_Q, OUTER_Q, AGG_Q])
@pytest.mark.parametrize("route", ["kill_switch", "passes", "mesh"])
def test_sql_route_parity(recorded, sql, route, monkeypatch):
    ref = recorded[sql]
    budget = 0 if route == "kill_switch" else 12288
    spy = _Spy(monkeypatch)
    port = _replay(ref, budget,
                   CoprMesh(["cpu"] * 8) if route == "mesh" else None)
    st = port.join_stats
    assert st["path"] == "device"
    if route == "kill_switch":
        assert "partitioned" not in st and spy.calls == 1
    elif route == "passes":
        assert st["partitioned"] and st["passes"] >= 2
        assert spy.calls == st["passes"]
    else:
        assert st["mesh_partitioned"] and st["mesh_shards"] == 8
        assert spy.calls == 0
    if ref["agg"] is not None:
        rows = carry.agg_from(ref["agg"], port).drain()
        assert _norm(rows) == _norm(ref["fused"])
    else:
        assert _norm(port.drain()) == _norm(ref["rows"])


def test_sql_oom_mid_pass_answers_unchanged(recorded, monkeypatch):
    ref = recorded[JOIN_Q]

    def every_third(call):
        if call % 3 == 0:
            _oom(call)

    _Spy(monkeypatch, fail=every_third)
    port = _replay(ref, 12288)
    assert port.join_stats["partition_escalations"] >= 1
    assert _norm(port.drain()) == _norm(ref["rows"])


@pytest.mark.parametrize("budget", [0, 12 * 1024])
def test_dict_join_reads_host_keys_only_for_the_passes(recorded, budget,
                                                       monkeypatch):
    """The dictionary route hands its K13 planes on the device, and no
    route reads them back (the reference's passes do, through its
    host_keys_fn): the passes lay the planes out with K21 where they
    lie."""
    ref = recorded[DICT_Q]
    _no_host_partition(monkeypatch)
    k21 = _Spy(monkeypatch, target="key_partition")
    port = _replay(ref, budget)
    st = port.join_stats
    assert st["dict_keys"] and st["device_resident_keys"]
    assert bool(st.get("partitioned")) == bool(budget)
    assert k21.calls == (2 if budget else 0)
    assert _norm(port.drain()) == _norm(ref["rows"])
