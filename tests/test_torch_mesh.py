"""Slice 8 as a whole: the port's mesh tier (S virtual shards on one
device) held against the JAX package's mesh over conftest's 8 virtual CPU
devices, at 1 and 8 shards.

- In-process: tests/test_tpu_mesh_fuzz.py's table (its generator and
  seed, cut from 12,000 to FUZZ_ROWS = 3,000 rows: at 12,000 this file
  took 103 s serial, most of it the reference's row inserts and the
  Python packing and CPU-engine answers of each replay) and QUERIES run
  through a JAX Session whose recording TpuClient has
  mesh=CoprMesh(n_devices=n) and floor 0; every recorded
  request replays through GpuClient(store, mesh=CoprMesh(["cpu"] * n),
  dispatch_floor_rows=0) over the same rows. Aggregates, filters and
  TopN: the port's partial rows equal the CPU engine's and the reference
  mesh client's (integers and decimals exact, f64 within the reference's
  own 1e-9 relative). None of these TopN statements meets the
  reference's mesh TopN faults; tests/test_torch_mesh_kernels.py pins
  those.
- Cluster: tests/test_mesh_exec.py's tables over 4 regions (and its
  -2^63 table over 4) with the reference's process mesh set and
  STATES_DEVICE_FLOOR 0; the statements of its QUERIES whose aggregate is
  pushed down to the regions (the join statements' aggregate combines
  region scans, a path the port has not ported: ops.mesh's
  combine_rows_sharded), the same aggregates grouped by t.k, the float
  SUM/AVG kept on the host and the exact -2^63 max. Each recorded request
  replays through a port DistStore(device="cpu") with the port's mesh set
  (carry.mesh_from): final rows equal, the near-data states and the
  states combine on the mesh.
- The sharded join probe: the pairs of join_match_pairs with an 8-shard
  mesh equal the reference's sharded probe's and the single-device K12's.
"""

import itertools
import math
from decimal import Decimal

import numpy as np
import pytest

import test_mesh_exec as tme
import test_tpu_mesh_fuzz as tmf
from tidb_tpu import tablecodec as rtc
from tidb_tpu.cluster import store as ref_cluster_store
from tidb_tpu.copr import columnar_region as ref_columnar_region
from tidb_tpu.copr.region_handler import handle_request
from tidb_tpu.executor import fused_agg as ref_fused_agg
from tidb_tpu.ops import kernels as ref_kernels
from tidb_tpu.ops import mesh as ref_mesh
from tidb_tpu.parallel import CoprMesh as RefMesh
from tidb_tpu.session import Session, new_store

import torch_parity  # noqa: F401  (torch threads, GC freeze)
from torch_parity import (RecordingClient, by_group_key, port_rows,
                          ref_rows, release, table_pairs)
from tidb_tpu_torch import carry, distsql
from tidb_tpu_torch.cluster.store import DistStore
from tidb_tpu_torch.executor import fused_agg
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops import kernels, mesh
from tidb_tpu_torch.ops.client import GpuClient
from tidb_tpu_torch.ops.exprc import Unsupported

SHARDS = (1, 8)
FUZZ_ROWS = 3000
_id = itertools.count(1)

def _close(a, b) -> bool:
    """The reference's own _close: f64 within 1e-9 relative."""
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= 1e-9 * max(abs(a), abs(b), 1.0)
    return a == b


def _rows_close(got: list, want: list) -> bool:
    if len(got) != len(want):
        return False
    for (hg, rg), (hw, rw) in zip(got, want):
        if hg != hw or len(rg) != len(rw):
            return False
        for (kg, vg), (kw, vw) in zip(rg, rw):
            if kg != kw or not _close(vg, vw):
                return False
    return True


@pytest.fixture(scope="module")
def fuzz():
    """{n: (store, {sql: [(kv.Request, reference mesh partials)]})}."""
    out = {}
    store = new_store(f"memory://torch_mesh_fuzz{next(_id)}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmf, "N_ROWS", FUZZ_ROWS)
        s = tmf._build(store)
    s.execute("set global tidb_tpu_columnar_scan = 0")
    for n in SHARDS:
        rec = RecordingClient(store, mesh=RefMesh(n_devices=n),
                              dispatch_floor_rows=0)
        store.set_client(rec)
        stmts = {}
        for sql in tmf.QUERIES:
            rec.requests.clear()
            rec.responses.clear()
            s.execute(sql)
            stmts[sql] = list(zip(rec.requests, rec.responses))
        out[n] = (store, stmts)
    yield out
    release(out)


def _port_mesh_rows(store, req, n: int):
    sel = req.data
    pairs = table_pairs(store, sel.start_ts, sel.table_info.table_id)
    client = GpuClient(MemStore.from_pairs(pairs),
                       mesh=carry.mesh_from(RefMesh(n_devices=n)),
                       dispatch_floor_rows=0)
    resp = client.send(carry.kv_request_from(req)).next()
    return port_rows(resp), client


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("sql", tmf.QUERIES)
def test_fuzz_queries_on_mesh(fuzz, n, sql):
    store, stmts = fuzz[n]
    reqs = stmts[sql]
    assert reqs, sql
    for req, parts in reqs:
        sel = req.data
        got, client = _port_mesh_rows(store, req, n)
        tpu = [r for part in parts for r in ref_rows(part)]
        snap = store.get_snapshot(sel.start_ts)
        cpu = ref_rows(handle_request(snap, sel, req.key_ranges))
        if sel.aggregates or sel.group_by:
            got, tpu, cpu = (by_group_key(x) for x in (got, tpu, cpu))
        assert client.stats["gpu_requests"] == 1
        assert client.stats["mesh_single"] == 0
        assert _rows_close(got, cpu), (sql, "vs CPU engine")
        assert _rows_close(got, tpu), (sql, "vs reference mesh")


def test_fuzz_tuple_codes_and_gate(fuzz):
    """group by a, f crosses the radix ceiling: on a mesh it takes global
    tuple codes, never the batch-local rank route; a DISTINCT count sent
    to a mesh client raises, as the reference keeps it above one."""
    store, stmts = fuzz[8]
    (req, _p), = stmts["select a, f, count(*), sum(c), min(c) from t "
                       "group by a, f order by a, f"]
    _rows, client = _port_mesh_rows(store, req, 8)
    assert client.stats["tuple_grouped"] == 1
    assert client.stats["ranked"] == 0
    kreq = carry.kv_request_from(req)
    kreq.data.aggregates[0].distinct = True
    with pytest.raises(Unsupported, match="DISTINCT"):
        client.send(kreq)


def test_mesh_single_for_a_distinct_fn(fuzz):
    """serve (a caller holding the batch) answers a DISTINCT count on one
    shard of the mesh's device, counted in mesh_single, equal to the
    client without a mesh."""
    store, stmts = fuzz[8]
    (req, _p), = stmts["select count(*), sum(c), min(a), max(f) from t"]
    kreq = carry.kv_request_from(req)
    kreq.data.aggregates[0].distinct = True
    kreq.data.aggregates[0].children = list(
        kreq.data.aggregates[2].children)
    sel = req.data
    pairs = table_pairs(store, sel.start_ts, sel.table_info.table_id)
    mstore = MemStore.from_pairs(pairs)
    m = GpuClient(mstore, mesh=carry.mesh_from(RefMesh(n_devices=8)),
                  dispatch_floor_rows=0)
    one = GpuClient(mstore, device="cpu", dispatch_floor_rows=0)
    batch = m._get_batch(kreq.data, kreq.key_ranges)
    got = port_rows(m.serve(kreq.data, batch))
    assert m.stats["mesh_single"] == 1
    assert got == port_rows(one.serve(kreq.data, batch))


# ---------------------------------------------------------------------------
# the cluster path
# ---------------------------------------------------------------------------

# test_mesh_exec's QUERIES whose aggregate is pushed down, and the same
# shapes grouped (its GROUPED_Q and FLOAT_SUM_Q over t alone)
CLUSTER_QUERIES = [
    "select count(*), sum(v), min(v), max(v) from t",
    "select k, count(*), sum(v), min(f), max(v) from t group by k "
    "order by k",
    "select k, count(*), sum(f), avg(f) from t group by k order by k",
    "select count(*), sum(v) from t where v > 500",
]
MIN_Q = "select k, count(*), max(v), min(v) from t group by k order by k"


def _build_min() -> Session:
    """test_mesh_exec's -2^63 table: group 1 holds only the int64
    minimum, over 4 regions."""
    store = new_store(f"cluster://3/torchmeshmn{next(_id)}")
    s = Session(store)
    s.execute("create database mn")
    s.execute("use mn")
    s.execute("create table t (id bigint primary key, k bigint, v bigint)")
    lo = -(1 << 63)
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 2}, {lo if i % 2 else i})" for i in range(1, 41)))
    tid = s.info_schema().table_by_name("mn", "t").info.id
    store.cluster.split_keys(
        [rtc.encode_row_key(tid, 10 * i + 1) for i in range(1, 4)])
    return s


@pytest.fixture(scope="module")
def cluster():
    """{(n, sql): (reference store, kv.Request, final rows, the reference
    rode its mesh)} over test_mesh_exec's tables with its mesh set."""
    out = {}
    seen = []
    send = ref_cluster_store.DistCoprClient.send
    final = ref_fused_agg.try_fused_final

    def rec_send(client, req):
        seen.append(["send", client, req])
        return send(client, req)

    def rec_final(agg):
        res = final(agg)
        seen.append(["final", res])
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_columnar_region, "STATES_DEVICE_FLOOR", 0)
        mp.setattr(ref_cluster_store.DistCoprClient, "send", rec_send)
        mp.setattr(ref_fused_agg, "try_fused_final", rec_final)
        sessions = [(tme._build(4), CLUSTER_QUERIES), (_build_min(),
                                                       [MIN_Q])]
        try:
            for n in SHARDS:
                ref_mesh.set_mesh(RefMesh(n_devices=n))
                for s, sqls in sessions:
                    for sql in sqls:
                        del seen[:]
                        mc0 = ref_fused_agg.stats["mesh_combines"]
                        s.execute(sql)
                        sends = [e for e in seen if e[0] == "send"]
                        finals = [e for e in seen if e[0] == "final"]
                        assert len(sends) == 1 and len(finals) == 1, sql
                        assert finals[0][1] is not None, sql
                        out[(n, sql)] = (
                            sends[0][1].store, sends[0][2], finals[0][1],
                            ref_fused_agg.stats["mesh_combines"] > mc0)
        finally:
            ref_mesh.set_mesh(None)
    yield out
    release(out)


@pytest.fixture
def port_mesh():
    """The port's process mesh for one test, reset after it."""
    yield mesh
    mesh.set_mesh(None)
    mesh.set_enabled(True)


def _cell(d):
    v = d.val
    if isinstance(v, Decimal):
        return int(d.kind), "dec", str(v)
    return int(d.kind), v


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("sql", CLUSTER_QUERIES + [MIN_Q])
def test_cluster_statements_on_mesh(cluster, port_mesh, n, sql):
    ref_store, ref_req, want, ref_rode = cluster[(n, sql)]
    assert ref_rode, "the reference's combine did not ride its mesh"
    pairs, splits = carry.cluster_from(ref_store, ref_req.data.start_ts)
    store = DistStore(pairs, splits, device="cpu")
    port_mesh.set_mesh(carry.mesh_from(RefMesh(n_devices=n)))
    kreq = carry.kv_request_from(ref_req)
    nd0 = mesh.stats["near_data_dispatches"]
    mc0 = fused_agg.stats["mesh_combines"]
    calls0 = dict(kernels.CALLS)
    res = distsql.select(store.get_client(), kreq).columnar()
    got = fused_agg.final_states(kreq.data, res)
    assert [[_cell(d) for d in row] for row in got] == \
        [[_cell(d) for d in row] for row in want], sql
    assert mesh.stats["near_data_dispatches"] == nd0 + 1
    assert fused_agg.stats["mesh_combines"] == mc0 + 1
    assert fused_agg.stats["last_mesh_shards"] == n
    calls = {k: kernels.CALLS[k] - calls0[k] for k in calls0}
    # over 8 shards the shard layout's K6 and the fold; at one shard the
    # rungs are the batched K6 and the region combine
    assert calls == {"region_filter_batched": 1,
                     "region_agg_states_batched": int(n == 1),
                     "combine_region_partials": int(n == 1),
                     "mesh_allreduce": int(n > 1)}
    if sql == MIN_Q:
        # group 1's max and min are both the int64 minimum
        assert sum(d.val == -(1 << 63) for row in got for d in row) == 2


def test_cluster_mesh_off_takes_the_single_device_rungs(cluster, port_mesh):
    """The kill switch: with the tier off the same statement takes the
    batched K6 and the region combine, with the same rows."""
    ref_store, ref_req, want, _r = cluster[(8, CLUSTER_QUERIES[1])]
    pairs, splits = carry.cluster_from(ref_store, ref_req.data.start_ts)
    store = DistStore(pairs, splits, device="cpu")
    port_mesh.set_mesh(carry.mesh_from(RefMesh(n_devices=8)))
    port_mesh.set_enabled(False)
    assert store.get_client().mesh is None
    kreq = carry.kv_request_from(ref_req)
    calls0 = dict(kernels.CALLS)
    res = distsql.select(store.get_client(), kreq).columnar()
    got = fused_agg.final_states(kreq.data, res)
    assert [[_cell(d) for d in row] for row in got] == \
        [[_cell(d) for d in row] for row in want]
    assert kernels.CALLS["mesh_allreduce"] == calls0["mesh_allreduce"]
    assert kernels.CALLS["region_agg_states_batched"] == \
        calls0["region_agg_states_batched"] + 1


def test_placements_follow_the_regions(cluster, port_mesh):
    """The port's placement of the statement's regions equals the
    reference's for the same ids and epochs."""
    ref_store, ref_req, _w, _r = cluster[(8, CLUSTER_QUERIES[0])]
    ids = [r.region_id for r in ref_store.cluster.regions]
    ref_pl = ref_mesh.RegionPlacement(8)
    port_pl = mesh.RegionPlacement(8)
    assert port_pl.shard_of(ids) == ref_pl.shard_of(ids)


# ---------------------------------------------------------------------------
# the sharded join probe
# ---------------------------------------------------------------------------

def test_join_probe_sharded_matches_single_device():
    """test_mesh_exec's probe inputs: the 8-shard probe's pairs equal the
    reference's sharded probe's and the port's single-device K12's, with
    multiple matches per row, with the per-shard pair totals."""
    rng = np.random.RandomState(11)
    lkey = rng.randint(0, 40, size=1000).astype(np.int64)
    lvalid = rng.rand(1000) > 0.1
    rkey = rng.randint(0, 40, size=300).astype(np.int64)
    rvalid = rng.rand(300) > 0.1
    want = ref_kernels.join_match_pairs(lkey, lvalid, rkey, rvalid,
                                        mesh=RefMesh(n_devices=8))
    single = kernels.join_match_pairs(lkey, lvalid, rkey, rvalid,
                                      device="cpu")
    st = {}
    got = kernels.join_match_pairs(lkey, lvalid, rkey, rvalid, stats=st,
                                   device="cpu", shards=8)
    assert st["mesh_shards"] == 8
    for g, s, w in zip(got, single, want):
        assert np.array_equal(g, s) and np.array_equal(g, w)
    # 1000 rows pad to a capacity of 1024: 128 rows a shard
    per_shard = np.bincount(got[0] // 128, minlength=8)
    assert np.array_equal(st["shard_pairs"], per_shard)


def test_join_statement_rides_the_sharded_probe():
    """A join through XSelectTableExec → HashJoinExec over a GpuClient
    with an 8-shard mesh: the probe is sharded, the rows are numpy's."""
    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.executor.distsql_exec import XSelectTableExec
    from tidb_tpu_torch.executor.executors import HashAggExec, HashJoinExec
    data = tpch.generate(2000, seed=3)
    tables = tpch.join_data(data, 3)
    client = GpuClient(MemStore([], []),
                       mesh=carry.mesh_from(RefMesh(n_devices=8)))
    left, right, plan, aggs, group_by = tpch.join_statement("f1_q3_join")
    lineitem = [tpch.C_ORDERKEY, tpch.C_PARTKEY, tpch.C_SUPPKEY,
                tpch.C_FDISCOUNT, tpch.C_SHIPDATE]
    kids = []
    for sel in (left, right):
        tid = sel.table_info.table_id
        req = tpch.store_request(sel)
        client.admit(sel, req.key_ranges, tpch.join_batch(
            tables, tid, lineitem if tid == tpch.TABLE_ID else None))
        kids.append(XSelectTableExec(client, sel, req.key_ranges))
    join = HashJoinExec(kids[0], kids[1], plan)
    p0 = mesh.stats["sharded_probes"]
    rows = HashAggExec(join, aggs, group_by).drain()
    got = [[d.val.encode() if isinstance(d.val, str) else d.val
            for d in row] for row in rows]
    assert got == tpch.join_expected("f1_q3_join", tables)
    assert join.join_stats["mesh_shards"] == 8
    # the per-shard pair totals are published as the shard balance
    per_shard = join.join_stats["shard_pairs"]
    assert mesh.stats["sharded_probes"] == p0 + 1
    assert mesh.stats["shard_rows_max"] == per_shard.max()
    assert math.isclose(mesh.stats["shard_rows_mean"], per_shard.mean())
