"""Slice 2 as a whole: the cluster region path of the port held against
the JAX package's cluster store.

Reference side: a Session on `new_store("cluster://3/...")` with the
260-row lineitem tables of tests/test_states_batch.py and
tests/test_filter_batch.py and a 260-row table of bench.py's TPC-H sweep
schema, each split into 1, 2, 4 and 8 regions at handle boundaries.
`columnar_region.STATES_DEVICE_FLOOR` is 0 and the mesh tier is off, so
the reference's own single-device JAX kernels (region_filter_batched,
region_agg_states_batched, combine_region_partials, the functions this
slice ports) run on the CPU. Test-only wrappers record the
kv.Requests reaching DistCoprClient.send and the rows
fused_agg.try_fused_final returns; nothing in tidb_tpu changes. The
reference's JAX compiles are nearly all of this file's time (one set per
statement and region count), so the six TPC-H sweep shapes run over 1, 2,
4 and 8 regions and the QUERIES of the two reference files over 8 only
(the sweep covers the one-region route).

Port side: each recorded request, and the reference store's KV pairs and
region boundaries at its start_ts (carry.cluster_from), go through a port
DistStore(device="cpu"): distsql.select(...).columnar() then
fused_agg.final_states. The final aggregate rows must equal the
reference's exactly: counts, ints, decimal strings, strings, times and
f64 values (-0.0 equal to +0.0). Every statement makes one filter call
(K5), one states call (K6) and, over more than one region, one combine
call (K7).
"""

import dataclasses
from decimal import Decimal

import pytest

import test_filter_batch as tfb
import test_states_batch as tsb
from bench import TPCH_SWEEP_SQLS
from tidb_tpu import tablecodec as rtc
from tidb_tpu.cluster import store as ref_cluster_store
from tidb_tpu.copr import columnar_region as ref_columnar_region
from tidb_tpu.executor import fused_agg as ref_fused_agg
from tidb_tpu.ops import mesh as ref_mesh
from tidb_tpu.session import Session, new_store

import torch_parity  # noqa: F401  (torch threads, GC freeze)
from tidb_tpu_torch import carry, distsql, errors, tpch
from tidb_tpu_torch.cluster.store import DistStore
from tidb_tpu_torch.copr.columnar_region import handle_columnar_scan
from tidb_tpu_torch.copr.proto import ByItem, expr_column
from tidb_tpu_torch.executor import fused_agg
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import Unsupported

N_ROWS = 260

STATEMENTS = ([("states", q) for q in tsb.QUERIES]
              + [("filter", q) for q in tfb.QUERIES]
              + [("sweep", sql) for _name, sql in TPCH_SWEEP_SQLS])
REGIONS = {"states": (8,), "filter": (8,), "sweep": (1, 2, 4, 8)}
CASES = [(n, i) for n in (1, 2, 4, 8)
         for i, (kind, _sql) in enumerate(STATEMENTS)
         if n in REGIONS[kind]]

_sweep_id = iter(range(1, 1 << 30))


def _build_sweep(n_regions: int) -> Session:
    """bench.py measure_tpch_sweep's table and split, at 260 rows."""
    store = new_store(f"cluster://3/torchsweep{next(_sweep_id)}")
    s = Session(store)
    s.execute("create database tpch")
    s.execute("use tpch")
    s.execute("create table lineitem (l_id bigint primary key, "
              "l_returnflag varchar(4), l_linestatus varchar(4), "
              "l_quantity decimal(12,2), l_extendedprice decimal(12,2), "
              "l_discount decimal(12,2), l_tax decimal(12,2), "
              "l_fdisc double, l_ship bigint, l_shipdate datetime)")
    vals = []
    for i in range(1, N_ROWS + 1):
        qty = Decimal(i % 50) + Decimal(i % 4) / 4
        price = Decimal(900 + i * 7 % 1000) + Decimal(i % 10) / 10
        vals.append(
            f"({i}, '{'ANR'[i % 3]}', '{'FO'[i % 2]}', "
            f"{qty}, {price}, {Decimal(i % 11) / 100}, "
            f"{Decimal(i % 9) / 100}, {(i % 7) * 0.01!r}, {i % 365}, "
            f"'2024-0{1 + i % 9}-1{i % 9} 00:00:00')")
    s.execute(f"insert into lineitem values {', '.join(vals)}")
    tid = s.info_schema().table_by_name("tpch", "lineitem").info.id
    step = max(N_ROWS // n_regions, 1)
    store.cluster.split_keys([rtc.encode_row_key(tid, step * i + 1)
                              for i in range(1, n_regions)])
    return s


_recorded: dict = {}


def _recording(n_regions: int) -> dict:
    """{statement index: (reference DistCoprClient, kv.Request, final
    rows)} of the statements run over `n_regions` regions, recorded once
    per module."""
    if n_regions in _recorded:
        return _recorded[n_regions]
    seen = []
    send = ref_cluster_store.DistCoprClient.send
    final = ref_fused_agg.try_fused_final

    def rec_send(client, req):
        seen.append(["send", client, req])
        return send(client, req)

    def rec_final(agg):
        out = final(agg)
        seen.append(["final", out])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_columnar_region, "STATES_DEVICE_FLOOR", 0)
        mp.setattr(ref_mesh, "_enabled", False)
        mp.setattr(ref_cluster_store.DistCoprClient, "send", rec_send)
        mp.setattr(ref_fused_agg, "try_fused_final", rec_final)
        build = {"states": tsb._build, "filter": tfb._build,
                 "sweep": _build_sweep}
        sessions = {kind: build[kind](n_regions) for kind in build
                    if n_regions in REGIONS[kind]}
        out = {}
        for i, (kind, sql) in enumerate(STATEMENTS):
            if kind not in sessions:
                continue
            del seen[:]
            sessions[kind].execute(sql)
            sends = [e for e in seen if e[0] == "send"]
            finals = [e for e in seen if e[0] == "final"]
            assert len(sends) == 1 and len(finals) == 1, sql
            assert finals[0][1] is not None, sql
            out[i] = (sends[0][1], sends[0][2], finals[0][1])
    _recorded[n_regions] = out
    return out


_port_stores: dict = {}


def _port_store(ref_client, start_ts: int) -> DistStore:
    """The port's DistStore over the reference store's data and regions
    (the data does not change after the inserts: one per store)."""
    key = id(ref_client.store)
    if key not in _port_stores:
        pairs, splits = carry.cluster_from(ref_client.store, start_ts)
        _port_stores[key] = (ref_client.store,
                             DistStore(pairs, splits, device="cpu"))
    return _port_stores[key][1]


def _cell(d):
    v = d.val
    if isinstance(v, Decimal):
        return int(d.kind), "dec", str(v)
    if hasattr(v, "to_packed_int"):
        return int(d.kind), "time", v.to_packed_int(), v.tp
    return int(d.kind), v       # f64 ==: -0.0 equals +0.0


def _final(store: DistStore, kreq):
    res = distsql.select(store.get_client(), kreq).columnar()
    return fused_agg.final_states(kreq.data, res)


@pytest.mark.parametrize("n_regions,stmt", CASES,
                         ids=[f"{n}-{STATEMENTS[i][0]}{i}"
                              for n, i in CASES])
def test_final_rows_equal_reference(n_regions, stmt):
    ref_client, ref_req, want = _recording(n_regions)[stmt]
    store = _port_store(ref_client, ref_req.data.start_ts)
    kreq = carry.kv_request_from(ref_req)
    calls0 = dict(kernels.CALLS)
    got = _final(store, kreq)
    calls = {k: kernels.CALLS[k] - calls0[k] for k in calls0}
    assert [[_cell(d) for d in row] for row in got] == \
        [[_cell(d) for d in row] for row in want], STATEMENTS[stmt][1]
    # no group survived: nothing to combine
    combines = int(n_regions > 1 and fused_agg.stats["last_groups"] > 0)
    assert calls == {"region_filter_batched": 1,
                     "region_agg_states_batched": 1,
                     "combine_region_partials": combines}, calls


def _outside(sel):
    """Requests outside slice 2, each built from a served one."""
    col = sel.group_by[0].expr.val
    return {
        "unhinted": dataclasses.replace(sel, columnar_hint=False),
        "index": dataclasses.replace(sel, table_info=None,
                                     index_info=("index", 1, 1)),
        "no_aggregate": dataclasses.replace(sel, aggregates=[],
                                            group_by=[]),
        "topn": dataclasses.replace(
            sel, aggregates=[], group_by=[],
            order_by=[ByItem(expr_column(col))], limit=3),
        "distinct": dataclasses.replace(sel, aggregates=[
            dataclasses.replace(sel.aggregates[0], distinct=True)]),
        "having": dataclasses.replace(sel, having=expr_column(col)),
    }


@pytest.mark.parametrize("case", ["unhinted", "index", "no_aggregate",
                                  "topn", "distinct", "having"])
def test_requests_outside_the_slice_raise(case):
    ref_client, ref_req, _want = _recording(8)[0]
    store = _port_store(ref_client, ref_req.data.start_ts)
    kreq = carry.kv_request_from(ref_req)
    kreq = dataclasses.replace(kreq, data=_outside(kreq.data)[case])
    with pytest.raises(Unsupported):
        _final(store, kreq)


def test_store_without_cuda_raises():
    with pytest.raises(errors.DeviceError):
        DistStore([], device=None)


def test_region_handler_without_cuda_raises():
    """The region handler is an entry point too: None means the card."""
    with pytest.raises(errors.DeviceError):
        handle_columnar_scan(None, tpch.hinted(tpch.q1()), [], device=None)
