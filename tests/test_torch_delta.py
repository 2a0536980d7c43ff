"""Slice 7: the HTAP freshness tier of the port held against the JAX
package's cluster store.

Reference side: tests/test_delta_pack.py's `_build(4)` (a Session on
`new_store("cluster://3/...")`, table t of 240 rows with NULLs over 4
regions, and table other). Test-only wrappers record the kv.Requests
reaching DistCoprClient.send, the rows fused_agg.try_fused_final returns,
and the mutations of every transaction TwoPhaseCommitter.execute commits;
`STATES_DEVICE_FLOOR` is 0 and the mesh tier is off, so the reference's
own single-device JAX kernels run on the CPU. Nothing in tidb_tpu
changes.

Port side: a DistStore(device="cpu") loaded from the reference store
(carry.cluster_from) replays every recorded transaction through begin /
set / delete / commit, and every recorded request restamped with its own
read timestamp. The final aggregate rows must equal the reference's
exactly (counts, ints, decimal strings, strings, f64 values, -0.0 equal to
+0.0), every plane-cache miss a merge covers must merge (merges ==
misses), and the merged batch must equal a fresh pack of the same
snapshot plane for plane. K19's plain version is held to the JAX
delta_merge_order on seeded inputs, exactly.
"""

import dataclasses
from decimal import Decimal

import numpy as np
import pytest
import torch

import chip_smoke
import test_delta_pack as tdp
from tidb_tpu.cluster import store as ref_cluster_store
from tidb_tpu.cluster import twopc as ref_twopc
from tidb_tpu.copr import columnar_region as ref_columnar_region
from tidb_tpu.copr import delta as ref_delta
from tidb_tpu.executor import fused_agg as ref_fused_agg
from tidb_tpu.ops import kernels as ref_kernels
from tidb_tpu.ops import mesh as ref_mesh

import torch_parity  # noqa: F401  (torch threads, GC freeze)
from tidb_tpu_torch import carry, distsql, errors, tablecodec as tc, tpch
from tidb_tpu_torch.cluster.rpc import _MvccSnapshotView, clip_ranges
from tidb_tpu_torch.cluster.store import DistStore
from tidb_tpu_torch.copr import delta
from tidb_tpu_torch.copr.columnar_region import cache_key
from tidb_tpu_torch.executor import fused_agg
from tidb_tpu_torch.ops import columnar as col, kernels

AGG_QUERIES = tdp.QUERIES[:2]     # the two aggregates of the reference's


class _Ref:
    """A reference Session over `_build(n_regions)` whose statements'
    requests, final rows and committed mutations are recorded."""

    def __init__(self, mp, n_regions: int = 4):
        self.seen = []
        send = ref_cluster_store.DistCoprClient.send
        final = ref_fused_agg.try_fused_final
        execute = ref_twopc.TwoPhaseCommitter.execute

        def rec_send(client, req):
            self.seen.append(("send", req))
            return send(client, req)

        def rec_final(agg):
            out = final(agg)
            self.seen.append(("final", out))
            return out

        def rec_execute(committer):
            ts = execute(committer)
            self.seen.append(("commit", dict(committer.mutations)))
            return ts

        mp.setattr(ref_columnar_region, "STATES_DEVICE_FLOOR", 0)
        mp.setattr(ref_mesh, "_enabled", False)
        mp.setattr(ref_cluster_store.DistCoprClient, "send", rec_send)
        mp.setattr(ref_fused_agg, "try_fused_final", rec_final)
        mp.setattr(ref_twopc.TwoPhaseCommitter, "execute", rec_execute)
        self.s = tdp._build(n_regions)
        self.store = self.s.store

    def query(self, sql: str, session=None):
        """(the statement's hinted request, its final rows)."""
        del self.seen[:]
        (session or self.s).execute(sql)
        sends = [x for k, x in self.seen if k == "send"
                 and getattr(x.data, "columnar_hint", False)]
        finals = [x for k, x in self.seen if k == "final"]
        assert len(sends) == 1 and len(finals) == 1, sql
        assert finals[0] is not None, sql
        return sends[0], finals[0]

    def write(self, sql: str, session=None) -> list:
        """The mutations of every transaction the statement committed."""
        del self.seen[:]
        (session or self.s).execute(sql)
        return [x for k, x in self.seen if k == "commit"]

    def port_store(self, **kw) -> DistStore:
        pairs, splits = carry.cluster_from(self.store,
                                           self.store.current_version())
        return DistStore(pairs, splits, device="cpu", **kw)


def _replay(store: DistStore, txns: list) -> None:
    for muts in txns:
        txn = store.begin()
        for k, v in muts.items():
            if v is None:
                txn.delete(k)
            else:
                txn.set(k, v)
        txn.commit()


def _cell(d):
    v = d.val
    if isinstance(v, Decimal):
        return int(d.kind), "dec", str(v)
    return int(d.kind), v       # f64 ==: -0.0 equals +0.0


def _rows(rows) -> list:
    return [[_cell(d) for d in r] for r in rows]


def _port_request(ref_req, ts: int):
    kreq = carry.kv_request_from(ref_req)
    return dataclasses.replace(
        kreq, data=dataclasses.replace(kreq.data, start_ts=ts))


def _final(store: DistStore, ref_req, ts: int | None = None) -> list:
    kreq = _port_request(ref_req, store.current_version() if ts is None
                         else ts)
    res = distsql.select(store.get_client(), kreq).columnar()
    return fused_agg.final_states(kreq.data, res)


def _stats(store: DistStore) -> dict:
    return {**store.plane_cache.stats, **store.rpc.delta_store.stats}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@pytest.fixture
def ref(monkeypatch):
    return _Ref(monkeypatch)


def _check_all(ref: _Ref, stores) -> list:
    """Every aggregate of the reference's QUERIES: the port stores' rows
    equal the reference's."""
    reqs = []
    for sql in AGG_QUERIES:
        req, want = ref.query(sql)
        for store in stores:
            assert _rows(_final(store, req)) == _rows(want), sql
        reqs.append(req)
    return reqs


def test_commit_to_other_table_never_touches_cached_planes(ref):
    port = ref.port_store()
    _check_all(ref, [port])
    _check_all(ref, [port])
    s0 = _stats(port)
    for i in range(3):
        _replay(port, ref.write(f"insert into other values ({i + 1}, {i})"))
        _check_all(ref, [port])
    d = _delta(_stats(port), s0)
    assert d["misses"] == 0 and d["invalidations"] == 0, d
    assert d["merges"] == 0 and d["hits"] == 3 * 2 * 4, d


@pytest.mark.parametrize("floor", [4096, 0], ids=["host_plan", "k19"])
def test_merge_parity_insert_update_delete(ref, monkeypatch, floor):
    """New dictionary strings, inserts between handles, updates, deletes:
    every miss merges, the answers equal the reference's and the port's
    own delta-off store's (which re-packs). At floor 0 both packages run
    their kernels: the JAX delta_merge_order and K19's plain version."""
    monkeypatch.setattr(ref_delta, "MERGE_DEVICE_FLOOR", floor)
    monkeypatch.setattr(delta, "MERGE_DEVICE_FLOOR", floor)
    port, off = ref.port_store(), ref.port_store()
    off.rpc.delta_store.set_enabled(False)
    reqs = _check_all(ref, [port, off])
    k19 = []
    wrapper = kernels.delta_merge_order

    def spy(*args):
        k19.append(args)
        return wrapper(*args)

    monkeypatch.setattr(kernels, "delta_merge_order", spy)
    for sql in ("insert into t values (1000, 3, 5, 0.5, 'zzz-new', 7.25), "
                "(1001, null, -4, null, null, null)",
                "update t set v = -77, sv = 'aa-upd' where id = 10",
                "update t set sv = 'zzz-new' where id in (17, 34)",
                # every row of region 1 holding 's05': a string the merged
                # dictionary must lose, as a fresh pack's does
                "update t set sv = 'q' where id in (5, 22, 39, 56)",
                "delete from t where id in (11, 12, 119, 120)",
                "insert into t values (120, 1, 2, -0.0, 'a-mid', 1.5)"):
        txns = ref.write(sql)
        _replay(port, txns)
        _replay(off, txns)
    s0 = _stats(port)
    _check_all(ref, [port, off])
    d = _delta(_stats(port), s0)
    assert d["merges"] > 0 and d["merges"] == d["misses"], d
    assert d["repacks"] == 0
    assert (len(k19) > 0) == (floor == 0)
    # the merged generation was admitted: repeat scans hit exactly
    s1 = _stats(port)
    _check_all(ref, [port])
    d = _delta(_stats(port), s1)
    assert d["hits"] == 2 * 4 and d["misses"] == 0, d
    carried = _same_as_fresh_pack(port, reqs)
    assert (len(carried) > 0) == (floor == 0)
    # a second merge over a merged batch runs K19 on the handle and
    # liveness planes the first merge left on the device
    k19.clear()
    txns = ref.write("delete from t where id in (40, 200)")
    _replay(port, txns)
    _replay(off, txns)
    _check_all(ref, [port, off])
    assert (len(k19) > 0) == (floor == 0)
    assert all(any(args[0] is h and args[1] is live for h, live in carried)
               for args in k19)


def _same_as_fresh_pack(store: DistStore, reqs) -> list:
    """Plane for plane, every region's cached (merged) batch equals a
    fresh pack_ranges of the same snapshot, and so do the handle and
    liveness planes a merge left on the device. Returns those planes."""
    carried = []
    ts = store.current_version()
    for ref_req in reqs:
        kreq = _port_request(ref_req, ts)
        sel = kreq.data
        columns = sel.table_info.columns
        prefix = tc.table_prefix(sel.table_info.table_id)
        version = store.data_version_at(ts, prefix)
        defaults = {c.column_id: c.default_val for c in columns
                    if c.default_val is not None}
        for region in store.cluster.regions:
            ranges = clip_ranges(region, kreq.key_ranges)
            if not ranges:
                continue
            got = store.plane_cache.lookup(cache_key(region.region_id, sel,
                                                     ranges),
                                           region.epoch(), version)
            assert got is not None
            want = col.pack_ranges(_MvccSnapshotView(store.mvcc, ts),
                                   sel.table_info.table_id, columns, ranges,
                                   defaults)
            assert (got.n_rows, got.capacity, got.max_handle) == \
                (want.n_rows, want.capacity, want.max_handle)
            assert np.array_equal(got.handles, want.handles)
            dev_h = getattr(got, "_device_handles", {}).get("cpu")
            if dev_h is not None:
                dev_live = got._device_live["cpu"]
                assert np.array_equal(dev_h.numpy(), want.handles)
                assert np.array_equal(dev_live.numpy(), want.row_mask())
                carried.append((dev_h, dev_live))
            assert got.columns.keys() == want.columns.keys()
            for cid, w in want.columns.items():
                g = got.columns[cid]
                assert (g.kind, g.tp, g.dec_scale, g.max_abs,
                        g.dictionary) == \
                    (w.kind, w.tp, w.dec_scale, w.max_abs, w.dictionary)
                assert np.array_equal(g.valid, w.valid)
                assert np.array_equal(g.values.view(np.int64),
                                      w.values.view(np.int64)), cid
    return carried


def test_old_snapshot_keeps_its_generation(ref):
    """An open older snapshot keeps reading its pre-delta data while new
    readers see the merge; its repeats hit its own cached generation."""
    port = ref.port_store()
    s2 = tdp.Session(ref.store)
    s2.execute("use dp")
    q = "select count(*), sum(v) from t"
    ref.s.execute("begin")
    req_old, old = ref.query(q)
    ref.query(q)
    old_txn = port.begin()               # the port's open old reader
    ts_old = old_txn.start_ts()
    assert _rows(_final(port, req_old, ts_old)) == _rows(old)
    assert _rows(_final(port, req_old, ts_old)) == _rows(old)
    _replay(port, ref.write(
        "insert into t values (2000, 1, 999999, null, null, null)", s2))
    req_new, new = ref.query(q, s2)
    assert _rows(_final(port, req_new)) == _rows(new) != _rows(old)
    req_still, still_old = ref.query(q)
    assert _rows(still_old) == _rows(old)
    assert _rows(_final(port, req_still, ts_old)) == _rows(old)
    s0 = _stats(port)
    assert _rows(_final(port, req_still, ts_old)) == _rows(old)
    d = _delta(_stats(port), s0)
    assert d["hits"] == 4 and d["misses"] == 0, d
    # one more commit: the newer reader merges over the newest base, and
    # the sweep keeps the generation the old reader still reads
    _replay(port, ref.write(
        "insert into t values (2001, 1, 5, null, null, null)", s2))
    req_new2, new2 = ref.query(q, s2)
    s1 = _stats(port)
    assert _rows(_final(port, req_new2)) == _rows(new2)
    d = _delta(_stats(port), s1)
    assert d["merges"] == d["misses"] == 4 and d["kept_active"] > 0, d
    assert _rows(_final(port, req_still, ts_old)) == _rows(old)
    ref.s.execute("commit")
    old_txn.rollback()


def test_budget_fold_resets_the_pack(ref):
    port = ref.port_store()
    port.rpc.delta_store.budget_rows = 8
    _check_all(ref, [port])
    vals = ", ".join(f"({3000 + i}, 1, {i}, null, null, null)"
                     for i in range(24))
    _replay(port, ref.write(f"insert into t values {vals}"))
    s0 = _stats(port)
    _check_all(ref, [port])
    assert _delta(_stats(port), s0)["repacks"] > 0
    tid = next(iter(port.plane_cache._base_tables))
    assert all(port.rpc.delta_store.pack_rows(r.region_id, tid) == 0
               for r in port.cluster.regions)
    # the folded generation is the new base: the next commit merges again
    _replay(port, ref.write("insert into t values (4000, 2, 42, null, null, "
                            "null)"))
    s1 = _stats(port)
    _check_all(ref, [port])
    d = _delta(_stats(port), s1)
    assert d["merges"] > 0 and d["merges"] == d["misses"], d


def test_kill_switch(ref):
    port = ref.port_store()
    _check_all(ref, [port])
    _replay(port, ref.write("insert into t values (6000, 1, 1, null, null, "
                            "null)"))
    _check_all(ref, [port])
    ds = port.rpc.delta_store
    _replay(port, ref.write("insert into t values (6001, 1, 1, null, null, "
                            "null)"))
    assert len(ds) > 0
    ds.set_enabled(False)
    assert len(ds) == 0 and not ds.enabled
    s0 = _stats(port)
    _check_all(ref, [port])
    d = _delta(_stats(port), s0)
    assert d["merges"] == 0 and d["misses"] == 2 * 4, d


def test_a_pack_with_a_gap_repacks(ref):
    """A commit the packs missed (taken while the tier was off) leaves a
    gap against the table's commit log: the older base is no merge base,
    the sweep drops it and every region re-packs, with the answers
    right."""
    port = ref.port_store()
    _check_all(ref, [port])
    ds = port.rpc.delta_store
    ds.set_enabled(False)
    _replay(port, ref.write("insert into t values (7000, 1, 1, null, null, "
                            "null)"))
    ds.set_enabled(True)
    _replay(port, ref.write("insert into t values (7001, 2, 2, null, null, "
                            "null)"))
    assert len(ds) == 4
    s0 = _stats(port)
    _check_all(ref, [port])
    d = _delta(_stats(port), s0)
    assert d["merges"] == 0 and d["invalidations"] == d["misses"] == 2 * 4, d


def test_schema_change_never_serves_a_stale_pack(ref):
    """A MODIFY COLUMN commits only meta keys, which the per-table version
    ignores: the column signature in the cache key maps the new request
    shape to a fresh entry."""
    ref.write("create table mt (id bigint primary key, a int)")
    ref.write("insert into mt values " + ", ".join(
        f"({i}, {i % 9})" for i in range(1, 121)))
    port = ref.port_store()
    q = "select count(*), sum(a) from mt where a < 7"
    req, want = ref.query(q)
    assert _rows(_final(port, req)) == _rows(want)
    assert _rows(_final(port, req)) == _rows(want)
    _replay(port, ref.write("alter table mt modify column a bigint"))
    req2, want2 = ref.query(q)
    assert _rows(want2) == _rows(want)
    s0 = _stats(port)
    assert _rows(_final(port, req2)) == _rows(want2)
    d = _delta(_stats(port), s0)
    assert d["misses"] > 0 and d["merges"] == 0, d
    s1 = _stats(port)
    assert _rows(_final(port, req2)) == _rows(want2)
    assert _delta(_stats(port), s1)["hits"] > 0


# ---------------------------------------------------------------------------
# K19 against the JAX delta_merge_order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", chip_smoke.K19_EDGES,
                         ids=[c[0] for c in chip_smoke.K19_EDGES])
def test_k19_plain_equals_jax(case):
    """The edge cases chip_smoke.py holds K19 to on the card."""
    _name, n_rows, cap, n_tomb, app_mode, tomb_all, k = case
    h, live, tomb, app = chip_smoke.k19_case(n_rows, cap, n_tomb, app_mode,
                                             n_rows + cap, tomb_all, k)
    got = kernels.delta_merge_order(torch.from_numpy(h),
                                    torch.from_numpy(live),
                                    torch.from_numpy(tomb),
                                    torch.from_numpy(app)).numpy()
    want = ref_kernels.delta_merge_order(h, live, tomb, app)
    assert np.array_equal(got, want)
    # the order is the merge: handles ascend over kept base and appended
    merged = np.concatenate([h, app])[got]
    assert np.all(np.diff(merged) >= 0)


def test_k19_plain_any_live_mask():
    """The plain version computes the reference's program for any live
    mask, not only a prefix (and the JAX program agrees)."""
    rng = np.random.default_rng(7)
    h = np.sort(rng.choice(1 << 30, 2048, replace=False)).astype(np.int64)
    live = rng.random(2048) < 0.6
    tomb = np.sort(rng.choice(h, 300, replace=False))
    app = np.unique(rng.integers(0, 1 << 30, 120)).astype(np.int64)
    got = kernels.delta_merge_order_plain(
        torch.from_numpy(h), torch.from_numpy(live), torch.from_numpy(tomb),
        torch.from_numpy(app)).numpy()
    assert np.array_equal(got, ref_kernels.delta_merge_order(h, live, tomb,
                                                             app))


def test_merged_batches_meet_k19_precondition(ref, monkeypatch):
    """Every batch the pack and merge paths build has strictly ascending
    live handles below the sentinel: K19's precondition."""
    seen = []
    plain = kernels.delta_merge_order_plain

    def spy(handles, live, tomb, app):
        seen.append(handles[live])
        return plain(handles, live, tomb, app)

    monkeypatch.setattr(delta, "MERGE_DEVICE_FLOOR", 0)
    monkeypatch.setattr(kernels, "delta_merge_order_plain", spy)
    port = ref.port_store()
    _check_all(ref, [port])
    for sql in ("insert into t values (500, 1, 2, null, 'n', 1.0)",
                "delete from t where id in (3, 200)",
                "update t set v = 1 where id < 30"):
        _replay(port, ref.write(sql))
        _check_all(ref, [port])
    assert seen
    for h in seen:
        assert bool(torch.all(h[1:] > h[:-1])) and \
            bool(torch.all(h < delta.I64_MAX))


def test_sentinel_handle_guards():
    """A committed row with handle I64_MAX drops the table's packs, and a
    base whose max_handle is I64_MAX re-packs instead of merging."""
    n = 300
    data = tpch.generate(n, seed=4)
    store = DistStore(tpch.kv_pairs(data), tpch.split_keys(n, 2),
                      device="cpu")
    sel = tpch.sweep_request("q6")
    kreq = tpch.store_request(sel)
    fused_agg.final_states(sel, distsql.select(store.get_client(),
                                               kreq).columnar())
    ds = store.rpc.delta_store
    key0, val0 = next(iter(tpch.kv_pairs(data)))
    txn = store.begin()
    txn.set(key0, val0)
    txn.commit()
    assert len(ds) == 2
    txn = store.begin()
    txn.set(tc.encode_row_key(tpch.TABLE_ID, delta.I64_MAX), val0)
    txn.commit()
    assert len(ds) == 0
    base = tpch.batch(data, [tpch.C_QUANTITY], 0, 10)
    base.max_handle = delta.I64_MAX
    assert delta._merge_batch(base, np.zeros(0, np.int64),
                              np.zeros(0, np.int64), {}, {}, [],
                              torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the write path
# ---------------------------------------------------------------------------

def _region_store(n_regions: int = 3) -> DistStore:
    splits = [tc.encode_row_key(tpch.TABLE_ID, 100 * i)
              for i in range(1, n_regions)]
    return DistStore([], splits, device="cpu")


def test_2pc_primary_alone_and_one_log_entry_per_commit_call(monkeypatch):
    store = _region_store(3)
    calls = []
    kv_commit = store.rpc.kv_commit

    def rec(region, keys, start_ts, commit_ts):
        calls.append((region.region_id, list(keys)))
        return kv_commit(region, keys, start_ts, commit_ts)

    monkeypatch.setattr(store.rpc, "kv_commit", rec)
    big = b"x" * (200 * 1024)     # three to a region batch of 512 KiB
    txn = store.begin()
    handles = [1, 2, 3, 4, 5, 150, 250, 251]
    for h in handles:
        txn.set(tc.encode_row_key(tpch.TABLE_ID, h), big)
    txn.commit()
    keys = [tc.encode_row_key(tpch.TABLE_ID, h) for h in handles]
    # the primary alone, the rest of its batch, its region's second batch,
    # then one batch per other region
    assert [c[1] for c in calls] == [keys[:1], keys[1:2], keys[2:4],
                                     keys[4:5], keys[5:6], keys[6:8]]
    prefix = tc.table_prefix(tpch.TABLE_ID)
    log = store.mvcc.table_commits_between(prefix, 0, 1 << 30)
    assert len(log) == len(calls) and len(set(log)) == 1
    assert store.data_version_at(store.current_version(), prefix) == 6
    snap = store.get_snapshot()
    assert [k for k, _v in snap.iterate(b"", None)] == keys


def test_write_conflict_and_locked_prewrite():
    store = _region_store(2)
    key = tc.encode_row_key(tpch.TABLE_ID, 7)
    t1, t2 = store.begin(), store.begin()
    t2.set(key, b"v2")
    t2.commit()
    status, cts = store.mvcc.txn_status(key, t2.start_ts())
    assert status == "committed" and cts > t2.start_ts()
    t1.set(key, b"v1")
    with pytest.raises(errors.WriteConflict):
        t1.commit()
    # another transaction's lock: the prewrite meets it and rolls back
    other = tc.encode_row_key(tpch.TABLE_ID, 150)
    lock_ts = store.current_version()
    store.mvcc.prewrite([("put", key, b"v3")], key, lock_ts)
    assert store.mvcc.txn_status(key, lock_ts) == ("locked", 0)
    t3 = store.begin()
    t3.set(other, b"o")
    t3.set(key, b"v4")
    with pytest.raises(errors.KeyIsLockedError):
        t3.commit()
    assert [lk.key for lk in store.mvcc.scan_locks(1 << 62)] == [key]
    assert store.mvcc.txn_status(key, t3.start_ts()) == ("rolled_back", 0)
    with pytest.raises(errors.KeyIsLockedError):
        store.get_snapshot().get(key)


def test_lock_gate_forces_the_pack_path():
    """A pending lock in range keeps the cached planes from serving: the
    region packs and meets the lock (the port has no resolver yet)."""
    n = 300
    data = tpch.generate(n, seed=5)
    store = DistStore(tpch.kv_pairs(data), tpch.split_keys(n, 2),
                      device="cpu")
    sel = tpch.sweep_request("q6")

    def run(ts):
        s = dataclasses.replace(sel, start_ts=ts)
        return _rows(fused_agg.final_states(
            s, distsql.select(store.get_client(),
                              tpch.store_request(s)).columnar()))

    want = run(store.current_version())
    hits = store.plane_cache.stats["hits"]
    assert run(store.current_version()) == want
    assert store.plane_cache.stats["hits"] == hits + 2
    key = tc.encode_row_key(tpch.TABLE_ID, n)        # the last region's
    store.mvcc.prewrite([("put", key, b"x")], key, store.current_version())
    s0 = dict(store.plane_cache.stats)
    with pytest.raises(errors.KeyIsLockedError):
        run(store.current_version())
    assert store.plane_cache.stats["hits"] == s0["hits"] + 1  # region 1
    store.mvcc.rollback([key], store.mvcc.scan_locks(1 << 62)[0].start_ts)
    assert run(store.current_version()) == want


def test_bootstrap_load_keeps_versions_and_answers():
    """DistStore(pairs, ...) answers as the read-only store did at the
    timestamps the earlier callers use (start_ts 1, recorded reference
    timestamps) and caches at version 0."""
    n = 400
    data = tpch.generate(n, seed=6)
    store = DistStore(tpch.kv_pairs(data), tpch.split_keys(n, 2),
                      device="cpu")
    prefix = tc.table_prefix(tpch.TABLE_ID)
    for ts in (0, 1, 1 << 60):
        assert store.data_version_at(ts, prefix) == 0
        assert store.data_version_at(ts) == 0
    sel = tpch.sweep_request("q1full")
    for _ in range(2):
        rows = fused_agg.final_states(
            sel, distsql.select(store.get_client(),
                                tpch.store_request(sel)).columnar())
        chip_smoke.check_sweep("q1full", rows, data, "bootstrap")
    stats = store.plane_cache.stats
    assert (stats["hits"], stats["misses"], stats["inserts"]) == (2, 2, 2)


def test_refresh_functions():
    """RF1 inserts SF x 1500 orders' lineitems above the table's handles,
    RF2 deletes SF x 1500 orders' lineitems; both return the arrays after
    the refresh and the mutations that make it."""
    n = 8002                       # SF 0.00133: 2 orders each way
    data = tpch.generate(n, seed=8)
    puts, after = tpch.rf1(data, seed=9)
    new = after[tpch.HANDLE][n:]
    assert np.array_equal(after[tpch.HANDLE][:n], np.arange(1, n + 1))
    assert len(np.unique(after[tpch.C_ORDERKEY][n:])) == 2
    assert new.min() == n + 1 and len(puts) == len(new)
    assert after[tpch.C_ORDERKEY][n:].min() > data[tpch.C_ORDERKEY].max()
    dels, after2 = tpch.rf2(after, seed=10)
    gone = np.setdiff1d(after[tpch.HANDLE], after2[tpch.HANDLE])
    assert len(np.unique(after[tpch.C_ORDERKEY][
        np.isin(after[tpch.HANDLE], gone)])) == 2
    assert [k for k, _v in dels] == [tc.encode_row_key(tpch.TABLE_ID, h)
                                     for h in gone.tolist()]
    store = DistStore(tpch.kv_pairs(data), tpch.split_keys(n, 2),
                      device="cpu")
    for muts in (puts, dels):
        txn = store.begin()
        for k, v in muts:
            txn.delete(k) if v is None else txn.set(k, v)
        txn.commit()
    got = [tc.decode_row_key(k)[1]
           for k, _v in store.get_snapshot().iterate(b"", None)]
    assert got == after2[tpch.HANDLE].tolist()
