"""The in-process path as a whole: SQL through the JAX package, requests
through the port.

Each statement runs through a JAX Session whose store answers with a
recording TpuClient (dispatch floor 0, tidb_tpu_columnar_scan = 0). The
recorded kv.Requests and the store's KV pairs then go through
GpuClient(device="cpu"); its decoded partial rows must equal TpuClient's
and the CPU engine's (copr/region_handler.handle_request). Statements:
every QUERY of test_tpu_copr.py (filters, aggregates, radix group-by,
DISTINCT and TopN), TPC-H Q1 over DECIMAL(15,2) columns, bench.py's Q1
over DOUBLE columns, and Q6. Requests outside the port (HAVING, an index
request, a group tuple count beyond the segment ceiling, more than four
ORDER BY items) must raise the port's Unsupported.

Tolerance: exact, except f64 sums (relative 1e-12).
"""

import pytest

import bench
from tidb_tpu_torch import carry, tpch
from tidb_tpu_torch.copr.proto import Expr, ExprType
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient
from tidb_tpu_torch.ops.exprc import Unsupported

from torch_parity import (RecordingClient, check_statement, release,
                          run_recorded, session, shrink_ranked, table_pairs)

T_QUERIES = [
    "select id from t where a > 25 order by id",
    "select id from t where a > 10 and c < 4.0 order by id",
    "select id from t where b = 'x' order by id",
    "select id from t where b != 'x' order by id",
    "select id from t where b < 'y' order by id",
    "select id from t where b in ('x', 'z') order by id",
    "select id from t where b like 'x%' order by id",
    "select id from t where c is null order by id",
    "select id from t where c is not null order by id",
    "select id from t where a in (10, 30, 50) order by id",
    "select id from t where not (a > 25) order by id",
    "select id from t where a > 20 or b = 'x' order by id",
    "select id from t where d <= '2024-03-01' order by id",
    "select id from t where d > '2024-02-10' order by id",
    "select id, a * 2 + 1 from t where a >= 20 order by id",
    "select count(*) from t",
    "select count(c) from t",
    "select sum(a), min(a), max(a) from t",
    "select sum(c), min(c), max(c) from t",
    "select avg(a), avg(c) from t",
    "select count(*), sum(a) from t where b = 'x'",
    "select min(b), max(b) from t",
    "select min(d), max(d) from t",
    "select b, count(*) from t group by b order by b",
    "select b, count(*), sum(a), min(c), max(c) from t group by b order by b",
    "select b, avg(a) from t group by b order by b",
    "select b, count(*) from t where a > 15 group by b order by b",
    "select a, count(*) from t group by a order by a",
    "select a, sum(c), min(c), max(b) from t group by a order by a",
    "select c, count(*) from t group by c order by c",
    "select d, count(*), sum(a) from t group by d order by d",
    "select a, b, count(*) from t group by a, b order by a, b",
    "select id, count(*) from t group by id order by id",
    "select a, count(*) from t where id > 100 group by a",
    "select b, a from t group by b order by b",
    "select a, c from t group by a order by a",
    "select b, d from t group by b order by b",
    "select id from t limit 3",
    "select sum(c) from t where id > 100",
    "select b, sum(c) from t group by b order by b",
    # DISTINCT (K9) and TopN (K10), served since slice 3
    "select count(distinct b) from t",
    "select count(distinct a) from t",
    "select id from t order by a desc limit 3",
    "select id from t order by c limit 2",
]

# outside the port: each recorded statement's requests must raise the
# port's Unsupported ("having" adds a HAVING to a recorded group-by
# request; "tuple ceiling" runs with RADIX_MAX_SEGMENTS = 8 and the rank
# ladder (3, 5) on both packages, where 7 group tuples + 2 exceed 8)
HAVING_BASE = "select b, count(*) from t group by b order by b"
T_OUT_OF_SLICE = {
    "having": HAVING_BASE,
    "index request": "select a from tix where a = 30",
    "tuple ceiling": "select a, b, count(*) from t group by a, b",
    "five order by items": "select id from t order by a, b, c, d, id "
                           "limit 3",
}
# a word of the Unsupported message each case must raise with
OUT_OF_SLICE_REASON = {"having": "having", "index request": "index",
                       "tuple ceiling": "ceiling",
                       "five order by items": "ORDER BY items"}

TPCH_Q1 = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "sum(l_extendedprice) as sum_base_price, "
    "sum(l_extendedprice * (1 - l_discount)) as sum_disc_price, "
    "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge, "
    "avg(l_quantity) as avg_qty, avg(l_extendedprice) as avg_price, "
    "avg(l_discount) as avg_disc, count(*) as count_order from lineitem "
    "where l_shipdate <= date '1998-12-01' - interval 90 day "
    "group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus")
TPCH_Q6 = (
    "select sum(l_extendedprice * l_discount) as revenue from lineitem "
    "where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01' "
    "and l_discount between 0.05 and 0.07 and l_quantity < 24")
DEC_QUERIES = {
    "q1 decimal": TPCH_Q1,
    "q6 decimal": TPCH_Q6,
    "by suppkey": "select l_suppkey, count(*), sum(l_quantity), "
                  "avg(l_discount), max(l_shipdate) from lineitem "
                  "group by l_suppkey",
    "first_row": "select count(*), min(l_shipdate), max(l_extendedprice), "
                 "sum(l_tax), l_comment from lineitem "
                 "where l_discount > 0.05",
}
DOUBLE_QUERIES = {"q1 double (bench.py)": bench.Q1,
                  "q6 double (bench.py)": bench.Q6}

_LINEITEM = (
    "create table lineitem (l_orderkey bigint, l_partkey bigint, "
    "l_suppkey bigint, l_linenumber int, l_quantity decimal(15,2), "
    "l_extendedprice decimal(15,2), l_discount decimal(15,2), "
    "l_tax decimal(15,2), l_returnflag char(1), l_linestatus char(1), "
    "l_shipdate date, l_commitdate date, l_receiptdate date, "
    "l_shipinstruct char(25), l_shipmode char(10), l_comment varchar(44), "
    "primary key (l_orderkey, l_linenumber))")


def _lineitem_values(n: int, seed: int) -> str:
    data = tpch.generate(n, seed)
    rows = []
    for i in range(n):
        q, p, d, t = (data[c][i] for c in (tpch.C_QUANTITY,
                                           tpch.C_EXTENDEDPRICE,
                                           tpch.C_DISCOUNT, tpch.C_TAX))
        rows.append(
            f"({data[tpch.C_ORDERKEY][i]}, {data[tpch.C_PARTKEY][i]}, "
            f"{data[tpch.C_SUPPKEY][i]}, {data[tpch.C_LINENUMBER][i]}, "
            f"{q / 100:.2f}, {p // 100}.{p % 100:02d}, {d / 100:.2f}, "
            f"{t / 100:.2f}, "
            f"'{tpch.RETURNFLAG[data[tpch.C_RETURNFLAG][i]].decode()}', "
            f"'{tpch.LINESTATUS[data[tpch.C_LINESTATUS][i]].decode()}', "
            f"'{data[tpch.C_SHIPDATE][i]}', '{data[tpch.C_COMMITDATE][i]}', "
            f"'{data[tpch.C_RECEIPTDATE][i]}', "
            f"'{tpch.SHIPINSTRUCT[data[tpch.C_SHIPINSTRUCT][i]].decode()}', "
            f"'{tpch.SHIPMODE[data[tpch.C_SHIPMODE][i]].decode()}', "
            f"'{tpch._comment(int(data[tpch.C_COMMENT][i])).decode()}')")
    return ", ".join(rows)


@pytest.fixture(scope="module")
def recorded():
    """{statement: (store, [(kv.Request, TpuClient partials)])}."""
    out = {}
    store, s, rec = session("memory://torch_copr_t")
    s.execute("create database test")
    s.execute("use test")
    s.execute("create table t (id bigint primary key, a int, "
              "b varchar(32), c double, d date)")
    s.execute(
        "insert into t values "
        "(1, 10, 'x', 1.5, '2024-01-15'), (2, 20, 'y', 2.5, '2024-02-10'), "
        "(3, 30, 'x', 3.5, '2024-03-01'), (4, 40, 'z', null, '2024-04-20'), "
        "(5, 50, 'y', 4.5, null), (6, 30, null, 0.5, '2024-01-01'), "
        "(7, -5, 'xx', -1.5, '2023-12-31')")
    for sql in T_QUERIES + [T_OUT_OF_SLICE["five order by items"]]:
        out[sql] = (store, run_recorded(s, rec, sql))
    s.execute("create table tix (id bigint primary key, a int, "
              "index ia (a))")
    s.execute("insert into tix values (1, 10), (2, 30), (3, 30)")
    sql = T_OUT_OF_SLICE["index request"]
    out[sql] = (store, run_recorded(s, rec, sql))
    with pytest.MonkeyPatch.context() as mp:
        shrink_ranked(mp, 8, (3, 5))
        sql = T_OUT_OF_SLICE["tuple ceiling"]
        out[sql] = (store, run_recorded(s, rec, sql))

    store, s, rec = session("memory://torch_copr_dec")
    s.execute("create database tpch")
    s.execute("use tpch")
    s.execute(_LINEITEM)
    s.execute("insert into lineitem values " + _lineitem_values(400, 11))
    for name, sql in DEC_QUERIES.items():
        out[name] = (store, run_recorded(s, rec, sql))

    store, s, _tbl, _load = bench.build_store(419)
    s.execute("set global tidb_tpu_columnar_scan = 0")
    rec = RecordingClient(store, dispatch_floor_rows=0)
    store.set_client(rec)
    for name, sql in DOUBLE_QUERIES.items():
        out[name] = (store, run_recorded(s, rec, sql))
    yield out
    release(out)


@pytest.mark.parametrize("sql", T_QUERIES)
def test_test_tpu_copr_queries(recorded, sql):
    check_statement(*recorded[sql], sql)


@pytest.mark.parametrize("name", sorted(DEC_QUERIES) + sorted(DOUBLE_QUERIES))
def test_tpch(recorded, name):
    check_statement(*recorded[name], name)


@pytest.mark.parametrize("case", sorted(T_OUT_OF_SLICE))
def test_out_of_slice_raises(recorded, case, monkeypatch):
    sql = T_OUT_OF_SLICE[case]
    if case == "tuple ceiling":
        shrink_ranked(monkeypatch, 8, (3, 5))
    store, reqs = recorded[sql]
    raised = 0
    for req, _parts in reqs:
        preq = carry.kv_request_from(req)
        if case == "having":
            preq.data.having = Expr(ExprType.VALUE, val=None)
        sel = req.data
        table = (sel.table_info or sel.index_info).table_id
        client = GpuClient(MemStore.from_pairs(
            table_pairs(store, sel.start_ts, table)), device="cpu")
        try:
            client.send(preq)
        except Unsupported as e:
            assert OUT_OF_SLICE_REASON[case] in str(e), (case, e)
            raised += 1
    assert raised >= 1, sql


def test_q1_shape_is_the_flagship(recorded):
    """The DECIMAL Q1 the planner sends is the one chip_smoke.py drives:
    the same WHERE, group-by and aggregates over the same column kinds."""
    _store, reqs = recorded["q1 decimal"]
    (req, _parts), = reqs
    got = carry.request_from(req.data)
    want = tpch.q1()
    assert repr(got.where) == repr(want.where)
    assert [repr(b.expr) for b in got.group_by] == \
        [repr(b.expr) for b in want.group_by]
    assert [repr(a) for a in got.aggregates] == \
        [repr(a) for a in want.aggregates]
