"""The micro-batch tier of the port (tidb_tpu_torch/ops/sched.py), held
against the JAX package's MicroBatcher, the port's solo route and the CPU
engine, on the CPU (the kernels' plain versions).

Requests are recorded from JAX Sessions over test_concurrency_tier.py's
table `t` (its MIXED_SHAPES and its TopN shapes) and test_device_dict.py's
aggregate table (its aggregate-slot shapes), several literals per shape,
through a recording TpuClient whose floor keeps every statement on the
reference's CPU engine (no JAX compile while recording). For each shape:

- the port's `_prepare` groups the statements as the reference's does
  (equal signatures exactly where the reference's are equal) and refuses
  the same ones;
- `_dispatch_chunk` of both tiers, driven directly with no gather window,
  over 1, 2, 8 and 33 statements (the port's 33 split into 32 + 1; the
  reference's too for three shapes, into its 8-slot program for the
  rest): the
  port's rows must equal the reference's batched rows, the port's solo
  rows (`GpuClient.serve`) and the CPU engine's rows (`handle_request`),
  with two pinned exceptions: an aggregate slot with no survivor emits no
  row in both tiers (the port's solo route sends the empty partial), and
  an int64 minimum under DESC, where the reference's batched order is
  wrong (it negates the key) and the port's equals the CPU engine's.

Then the gather protocol with threads, a barrier and 300 ms windows
(no assertion depends on a shorter window): statements batch,
a cold singleton goes solo, a stalled leader's followers degrade to the
solo route, an injected DeviceError is raised in every statement of the
launch, micro_batch=False pins the solo route; a stress run with a short
switch interval holds the shared counters consistent. Last, the repair of
the client's per-request state: one statement served in the middle of
another's dispatch must not change its answer.

Tolerance: exact (f64 sums are not batched; f64 extrema and every other
value compare equal).
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from tidb_tpu.copr.region_handler import handle_request
from tidb_tpu.ops import sched as rsched
from tidb_tpu.session import new_store, Session

from tidb_tpu_torch import carry, errors as perrors, tpch
from tidb_tpu_torch.copr.proto import iter_response_rows
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops import sched as psched
from tidb_tpu_torch.ops.client import GpuClient

from torch_parity import (RecordingClient, assert_rows_equal, port_rows,
                          ref_rows, release, table_pairs)

# test_concurrency_tier.py's table t (fewer rows) and shapes
T_ROWS = 900
MIXED_SHAPES = [
    "select id, v from t where v = {k}",
    "select id from t where v between {k} and {k2}",
    "select id, sx from t where sx = 's{m}'",
    "select id from t where f > {k}.5",
    "select id, v from t where v is null",
    "select id from t where v is not null and v < {k}",
    "select id from t where dc = {m}.25",
    "select id, v from t where v = {k} or v = {k2}",
    "select id from t where not (v = {k})",
    "select id, v from t where v = {k} limit 3",
    "select id from t where v = {k} order by id desc limit 4",
    f"select id from t where v = {(1 << 63) + 7}",        # unbatchable
]
TOPN_SHAPES = [
    "select id, v from t where v > {k} order by v, id limit 5",
    "select id, v from t where v > {k} order by v desc, id limit 5",
    "select id, f from t where v > {k} order by f desc limit 7",
    "select id, sx from t where v > {k} order by sx desc, id limit 6",
    "select id, dc from t where v > {k} order by dc, id desc limit 4",
    "select id, f from t where v > {k} order by f limit 9",
]
# test_device_dict.py's aggregate-slot shapes, the literal varied
AGG_SHAPES = [
    "select count(*), sum(v), min(v), max(v) from ba where k < {a}",
    "select count(*), sum(d), min(d), max(d) from ba where k < {a}",
    "select min(f), max(f), count(f) from ba where k < {a}",
    "select avg(v), min(x), max(x) from ba where k < {a}",
    "select count(*) from ba where k > {b}",    # k > 99: no survivor
    "select sum(x) from ba where k < {a}",       # float sum: unbatchable
]
SEEDS = (13, 31, 58)


def _fill(tpl: str, seed: int) -> str:
    return tpl.format(k=seed % 90, k2=seed % 90 + 5, m=seed % 5,
                      a=seed % 7, b=90 + seed % 20)


@pytest.fixture(scope="module")
def rec():
    """{shape: [(reference kv.Request, port kv.Request)] per seed}, the
    reference store and client, and the port's client over the same rows."""
    store = new_store("memory://torchsched")
    s = Session(store)
    s.execute("create database d")
    s.execute("use d")
    s.execute("create table t (id bigint primary key, v bigint, "
              "f double, sx varchar(16), dc decimal(8,2))")
    vals = []
    for i in range(1, T_ROWS + 1):
        if i % 7 == 0:
            vals.append(f"({i}, null, null, 's{i % 5}', {i % 50}.25)")
        else:
            vals.append(f"({i}, {i % 97}, {i}.5, 's{i % 5}', {i % 50}.25)")
    s.execute("insert into t values " + ", ".join(vals))
    s.execute("create table ba (id bigint primary key, k bigint, "
              "v bigint, f varchar(4), d decimal(10,2), x double)")
    s.execute("insert into ba values " + ", ".join(
        f"({i}, {i % 7}, {i * 3}, '{'ANRQ'[i % 4]}', {i % 50}.25, "
        f"{i % 11}.5)" for i in range(1, 601)))
    s.execute("create table m (id bigint primary key, a bigint, b int)")
    s.execute("insert into m values (1, -9223372036854775808, 1), "
              "(2, 5, 1), (3, 9007199254740993, 1), (4, 9007199254740992, "
              "1), (5, 7, 0), (6, 9223372036854775807, 1)")
    s.execute("set global tidb_tpu_columnar_scan = 0")
    client = RecordingClient(store, dispatch_floor_rows=1 << 20)
    client.micro_batch = False      # record through the CPU engine
    store.set_client(client)
    out = {}
    for tpl in MIXED_SHAPES + TOPN_SHAPES + AGG_SHAPES:
        out[tpl] = []
        for seed in SEEDS:
            client.requests.clear()
            s.execute(_fill(tpl, seed))
            req, = client.requests
            out[tpl].append((req, carry.kv_request_from(req)))
    for tpl in ("select id from m where b = 1 order by a desc, id limit 2",
                "select id from m where b = {k} order by a desc, id limit 3"):
        client.requests.clear()
        s.execute(tpl.format(k=1))
        req, = client.requests
        out[tpl] = [(req, carry.kv_request_from(req))]
    start_ts = out[MIXED_SHAPES[0]][0][0].data.start_ts
    pairs = []
    for name in ("t", "ba", "m"):
        tid = s.info_schema().table_by_name("d", name).info.id
        pairs += table_pairs(store, start_ts, tid)
    gclient = GpuClient(MemStore.from_pairs(pairs), device="cpu")
    # one reference batcher for the module: its compile cache holds one
    # program per (signature, slot bucket)
    state = {"reqs": out, "store": store, "client": client,
             "gclient": gclient, "rmb": rsched.MicroBatcher()}
    yield state
    release(state)


def _cpu_rows(store, req) -> list:
    sel = req.data
    snap = store.get_snapshot(sel.start_ts)
    return ref_rows(handle_request(snap, sel, req.key_ranges))


def _run_chunks(mb, client, entries, slots=psched.MAX_SLOTS):
    for i in range(0, len(entries), slots):
        mb._dispatch_chunk(client, entries[i:i + slots])


# the reference's 33 statements go through its 32-slot program for two
# shapes; for the others through its 8-slot one (4 x 8 + 1), which every
# shape compiles anyway: one more compile per shape buys no more coverage
REF_32 = (MIXED_SHAPES[1], TOPN_SHAPES[3], AGG_SHAPES[1])


def _parity(rec, tpl: str, size: int, empty_ok=False):
    """One shape's chunk of `size` statements through both tiers."""
    reqs = rec["reqs"][tpl]
    chunk = [reqs[i % len(reqs)] for i in range(size)]
    rmb, pmb = rec["rmb"], psched.MicroBatcher()
    rent = [rmb._prepare(rec["client"], r, r.data) for r, _p in chunk]
    pent = [pmb._prepare(rec["gclient"], p, p.data) for _r, p in chunk]
    assert all(e is not None for e in rent + pent), tpl
    _run_chunks(rmb, rec["client"], rent,
                psched.MAX_SLOTS if tpl in REF_32 else 8)
    _run_chunks(pmb, rec["gclient"], pent)
    cpu = {}
    for (r, p), re_, pe in zip(chunk, rent, pent):
        got = port_rows(pe.result)
        assert_rows_equal(got, ref_rows(re_.result), f"{tpl} vs JAX tier")
        key = id(r)
        if key not in cpu:
            cpu[key] = _cpu_rows(rec["store"], r)
        assert_rows_equal(got, cpu[key], f"{tpl} vs CPU engine")
        solo = port_rows(rec["gclient"].serve(p.data, pe.batch))
        if not got and empty_ok:
            # an empty aggregate slot: no row batched, the empty partial
            # (counts 0, the rest NULL) solo
            (_h, row), = solo
            assert all(v is None or v == 0 for _k, v in row[1:]), row
            continue
        assert_rows_equal(got, solo, f"{tpl} vs solo route")


@pytest.mark.parametrize("size", [1, 2, 8, 33])
@pytest.mark.parametrize("tpl", MIXED_SHAPES[:-1] + TOPN_SHAPES)
def test_batched_rows_match_jax_solo_and_cpu(rec, tpl, size):
    _parity(rec, tpl, size)


@pytest.mark.parametrize("size", [1, 2, 8, 33])
@pytest.mark.parametrize("tpl", AGG_SHAPES[:-1])
def test_agg_slots_match_jax_solo_and_cpu(rec, tpl, size):
    _parity(rec, tpl, size, empty_ok=tpl == AGG_SHAPES[4])


def test_empty_agg_slot_emits_no_row(rec):
    """k > 99 keeps no row: both tiers emit NO row (the reference's
    _emit_agg), the CPU engine none either; the port's solo route sends
    the empty partial."""
    r, p = rec["reqs"][AGG_SHAPES[4]][0]
    e = psched.MicroBatcher()._prepare(rec["gclient"], p, p.data)
    psched.MicroBatcher()._dispatch_chunk(rec["gclient"], [e])
    re_ = rec["rmb"]._prepare(rec["client"], r, r.data)
    rec["rmb"]._dispatch_chunk(rec["client"], [re_])
    assert port_rows(e.result) == [] == ref_rows(re_.result)
    assert _cpu_rows(rec["store"], r) == []
    (_h, row), = port_rows(rec["gclient"].serve(p.data, e.batch))
    assert [v for _k, v in row[1:]] == [0]


def test_prepare_groups_and_refuses_as_reference(rec):
    """Equal signatures exactly where the reference's are equal, across
    every recorded statement; the same statements refused."""
    rmb, pmb = rec["rmb"], psched.MicroBatcher()
    rsig, psig = [], []
    for tpl, reqs in rec["reqs"].items():
        for r, p in reqs:
            re_ = rmb._prepare(rec["client"], r, r.data)
            pe = pmb._prepare(rec["gclient"], p, p.data)
            assert (re_ is None) == (pe is None), tpl
            if re_ is not None:
                rsig.append(re_.group_key)
                psig.append(pe.group_key)
    assert len(rsig) > 60
    n = len(rsig)
    for i in range(n):
        for j in range(i + 1, n):
            assert (rsig[i] == rsig[j]) == (psig[i] == psig[j]), (i, j)
    refused = [tpl for tpl in (MIXED_SHAPES[-1], AGG_SHAPES[-1])]
    for tpl in refused:
        r, p = rec["reqs"][tpl][0]
        assert pmb._prepare(rec["gclient"], p, p.data) is None, tpl


def test_params_bypass_dedup(rec):
    """`v between 3 and 3` and `v between 3 and 8` share one signature AND
    one program layout: each literal is its own pool slot and its own
    instruction (Program.const_slot and emit deduplicate by value)."""
    batch = rec["gclient"]._get_batch(
        rec["reqs"][MIXED_SHAPES[1]][0][1].data,
        rec["reqs"][MIXED_SHAPES[1]][0][1].key_ranges)
    where = rec["reqs"][MIXED_SHAPES[1]][0][1].data.where
    fins = []
    for lo, hi in ((3, 3), (3, 8)):
        for e, v in zip(where.children, (lo, hi)):
            e.children[1].val.val = v
        lw = psched._Lowerer(batch)
        emit, sig = lw.lower(where)
        fins.append((lw.program(batch, emit), sig))
    (f1, s1), (f2, s2) = fins
    assert s1 == s2
    assert np.array_equal(f1.meta, f2.meta)
    assert list(f1.pool[:2]) == [3, 3] and list(f2.pool[:2]) == [3, 8]
    # restore the recorded literals
    seed = SEEDS[0]
    for e, v in zip(where.children, (seed % 90, seed % 90 + 5)):
        e.children[1].val.val = v


def test_desc_int64_min_fault_of_the_reference(rec):
    """order by a desc over a = -2^63 .. 2^63-1: the reference's batched
    TopN negates the key (sched.py:553-556), -(-2^63) wraps and row 1
    sorts first; the port's order is the CPU engine's."""
    for tpl in ("select id from m where b = 1 order by a desc, id limit 2",
                "select id from m where b = {k} order by a desc, id limit 3"):
        (r, p), = rec["reqs"][tpl]
        pe = psched.MicroBatcher()._prepare(rec["gclient"], p, p.data)
        re_ = rec["rmb"]._prepare(rec["client"], r, r.data)
        psched.MicroBatcher()._dispatch_chunk(rec["gclient"], [pe, pe])
        rec["rmb"]._dispatch_chunk(rec["client"], [re_])
        got = [h for h, _row in port_rows(pe.result)]
        cpu = [h for h, _row in _cpu_rows(rec["store"], r)]
        jax_ = [h for h, _row in ref_rows(re_.result)]
        assert got == cpu == ([6, 3] if "limit 2" in tpl else [6, 3, 4])
        assert jax_[0] == 1, jax_       # the wrapped minimum first


# ---------------------------------------------------------------------------
# the gather protocol
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sup():
    """A MemStore of supplier rows, their numpy arrays, and the batch cache
    of a client that packed every Phase G shape's batch once."""
    data, words = tpch.supplier(1200, seed=5)
    store = MemStore.from_pairs(tpch.supplier_pairs(data, words))
    warm = GpuClient(store, device="cpu")
    for shape in tpch.G_SHAPES:
        warm.send(tpch.g_statement(shape, 1)).next()
    return store, data, words, warm._batch_cache


def _rows(resp):
    return [(h, [d.val for d in ds]) for h, ds in iter_response_rows(resp)]


def _drive(client, work, timeout=60.0):
    """Each thread sends its statements, all released by one barrier.
    Returns ({(thread, i): rows or the exception}, threads)."""
    out = {}
    lock = threading.Lock()
    barrier = threading.Barrier(len(work))

    def run(t):
        barrier.wait()
        for i, (shape, lit) in enumerate(work[t]):
            try:
                got = _rows(client.send(tpch.g_statement(shape, lit)).next())
            except perrors.TiDBError as e:
                got = e
            with lock:
                out[(t, i)] = got
    ths = [threading.Thread(target=run, args=(t,)) for t in range(len(work))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout)
    assert not any(th.is_alive() for th in ths), "a session hung"
    return out


def _check(out, work, data, words):
    for t, w in enumerate(work):
        for i, (shape, lit) in enumerate(w):
            assert out[(t, i)] == tpch.g_expected(shape, lit, data, words), \
                (shape, lit)


def _client(sup, **kw):
    store, _data, _words, warm = sup
    client = GpuClient(store, device="cpu", **kw)
    client._batch_cache.update(warm)        # every shape's batch packed
    return client


def _hot(client):
    """Open the traffic gate for every thread (as recent multi-statement
    traffic does)."""
    client._sched._last_multi = time.monotonic()


def test_gather_batches_concurrent_statements(sup):
    _store, data, words, _w = sup
    client = _client(sup, batch_window_ms=300)
    _hot(client)
    work = [[("g_nation", t), ("g_agg", t + 1), ("g_topn", t + 2)]
            for t in range(6)]
    out = _drive(client, work)
    _check(out, work, data, words)
    st = client.stats
    assert st["small_batched"] + st["small_solo"] == 18
    assert st["batched_slots"] == st["small_batched"]
    assert max(st["batch_sizes"]) >= 2, st["batch_sizes"]


def test_cold_singleton_goes_solo(sup):
    _store, data, words, _w = sup
    client = _client(sup, batch_window_ms=300)
    # the gate open for this one statement, but no peer and a cold shape
    client._sched._last_submit = time.monotonic()
    client._sched._last_thread = None
    out = _drive(client, [[("g_nation", 4)]])
    _check(out, [[("g_nation", 4)]], data, words)
    assert client.stats["batched_launches"] == 0
    assert client.stats["small_solo"] == 1


def test_hot_singleton_rides_one_slot(sup):
    _store, data, words, _w = sup
    client = _client(sup, batch_window_ms=300)
    sig_of = {}
    orig = client._sched._prepare

    def prepare(*a):
        e = orig(*a)
        sig_of[0] = e.sig
        client._sched._hot[e.sig] = time.monotonic()
        return e
    client._sched._prepare = prepare
    _hot(client)
    out = _drive(client, [[("g_topn", 9)]])
    _check(out, [[("g_topn", 9)]], data, words)
    assert client.stats["batch_sizes"] == {1: 1}


def _gather_until(client, n, limit=20.0):
    """A leader that waits until n entries are queued (deterministic
    grouping), then drains."""
    sched = client._sched

    def gather(_window_s):
        end = time.monotonic() + limit
        while time.monotonic() < end:
            with sched._lock:
                if len(sched._queue) >= n:
                    return
            time.sleep(0.005)
    sched._gather = gather


def test_stalled_leader_degrades_followers_solo(sup):
    _store, data, words, _w = sup
    client = _client(sup, batch_window_ms=300)
    _hot(client)
    sched = client._sched
    n = 4

    def stalled(_window_s):         # until every follower gave up
        end = time.monotonic() + 20
        while client.stats["stall_degrades"] < n - 1 \
                and time.monotonic() < end:
            time.sleep(0.01)
    sched._gather = stalled
    work = [[("g_nation", t)] for t in range(n)]
    out = _drive(client, work)
    _check(out, work, data, words)
    assert client.stats["stall_degrades"] == n - 1
    assert client.stats["batched_launches"] == 0


def test_device_error_raises_in_every_statement(sup, monkeypatch):
    client = _client(sup, batch_window_ms=300)
    _hot(client)
    _gather_until(client, 5)

    def broken(*_a):
        raise perrors.DeviceError("injected slot_filter fault")
    monkeypatch.setattr(pk, "slot_filter", broken)
    work = [[("g_nation", t)] for t in range(5)]
    out = _drive(client, work)
    for t in range(5):
        err = out[(t, 0)]
        assert isinstance(err, perrors.DeviceError), err
    assert client.stats["small_solo"] == 0
    assert client.stats["small_batched"] == 0


def test_micro_batch_off_pins_solo(sup):
    _store, data, words, _w = sup
    client = _client(sup, micro_batch=False, batch_window_ms=300)
    _hot(client)
    work = [[("g_nation", t), ("g_agg", t)] for t in range(4)]
    out = _drive(client, work)
    _check(out, work, data, words)
    assert client.stats["small_batched"] == 0
    assert client.stats["small_solo"] == 8
    assert sum(client.stats["launches"].values()) == 0   # plain on CPU


def test_stress_counters_stay_consistent(sup):
    """More threads than cores, a short switch interval: the shared
    counters lose no update (every batched statement is one slot; the
    histogram sums to the launches)."""
    _store, data, words, _w = sup
    client = _client(sup)
    work = [[(tpch.G_SHAPES[(t + i) % 5], (t * 7 + i) % 25)
             for i in range(6)] for t in range(24)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = _drive(client, work, timeout=120.0)
    finally:
        sys.setswitchinterval(old)
    _check(out, work, data, words)
    st = client.stats
    assert st["small_batched"] + st["small_solo"] == 24 * 6
    assert st["batched_slots"] == st["small_batched"]
    assert sum(k * v for k, v in st["batch_sizes"].items()) \
        == st["batched_slots"]
    assert sum(st["batch_sizes"].values()) == st["batched_launches"]
    assert st["batch_packs"] == 0 and st["batch_hits"] >= 24 * 6


# ---------------------------------------------------------------------------
# the client keeps no per-request state
# ---------------------------------------------------------------------------

def test_nested_request_keeps_its_own_decode_tables(monkeypatch):
    """While request A (a lineitem filter) is dispatched, request B (a
    supplier filter: another table, other columns) is served to
    completion on the same client: A's rows must still be A's solo
    answer. A client that kept the request's columns on itself emitted A
    with B's columns."""
    li = tpch.generate(400, seed=3)
    sdata, swords = tpch.supplier(300, seed=3)
    store = MemStore.from_pairs(list(tpch.kv_pairs(li))
                                + list(tpch.supplier_pairs(sdata, swords)))
    client = GpuClient(store, device="cpu")
    a = tpch.store_request(tpch.filter_scan())
    b = tpch.g_statement("g_nation", 3)
    want_a = port_rows(client.send(a).next())
    want_b = port_rows(client.send(b).next())
    orig = pk.build_filter_fn
    nested = []

    def build(prog, where):
        if not nested:
            nested.append(None)
            nested[0] = port_rows(client.send(b).next())
        return orig(prog, where)
    monkeypatch.setattr(pk, "build_filter_fn", build)
    got_a = port_rows(client.send(a).next())
    assert nested == [want_b]
    assert got_a == want_a
