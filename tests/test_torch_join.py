"""The in-process join path of the port (scan → join → aggregate), held
against the JAX package.

Statements run through JAX Sessions (tests/torch_parity.py `session`: a
recording TpuClient at dispatch floor 0) with HashJoinExec routed to its
device kernels at any size, as test_join_parity.py's _ForceDevice does.
Recorded per statement: the scan kv.Requests, the HashJoinExec (its plan,
its two sides, its final pairs and route) and the rows
fused_agg.try_fused_agg returned; and, with the vector join off (the
_ForceDict oracle of test_join_parity.py), the rows the HashAgg row loop
returned. Each statement is recorded with tidb_tpu_columnar_scan = 1
(ColumnarScanResult sides) and = 0 (RowsSide sides) and replays through
the port with device="cpu" (the kernels' plain versions) three ways:

- scan: the recorded scan requests through GpuClient + XSelectTableExec
  (the port's own columnar scan answer), then HashJoinExec;
- columnar_side: the reference's ColumnarScanResult sides carried over
  (carry.side_from), then HashJoinExec;
- rows_side: the reference's RowsSide sides carried over.

The port's pairs must equal the reference's device pairs, in order; its
joined rows the reference's DeviceJoinResult rows; its fused aggregate
rows both the reference's fused rows and the row loop's (exact: the same
arithmetic in the same order, np.add.at for float sums). Its route is
asserted (stats["path"], dict_keys for string and multi-column keys).
Shapes the reference hands to its row engine raise Unsupported.

Statements: test_join_parity.py's QUERIES and TestJoinAggFusion's
AGG_QUERIES on its tables; test_device_dict.py's JOIN_QUERIES 1-5 on its
table built in-process (not over regions); a LEFT OUTER join over an
empty right table.
"""

import pytest

from tidb_tpu.executor import executors as rex, fused_agg as rfused

from tidb_tpu_torch import carry
from tidb_tpu_torch.executor.distsql_exec import XSelectTableExec
from tidb_tpu_torch.executor.executors import HashJoinExec
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient
from tidb_tpu_torch.ops.exprc import Unsupported

from torch_parity import (norm_datum, port_rows, ref_rows, release, session,
                          table_pairs)

# the tables of test_join_parity.py (_seed), an empty one, ci-collation
# and string-column tables of its bail-out cases
JP_TABLES = [
    "create table l (id bigint primary key, k int, v double)",
    "create table r (id bigint primary key, k int, w int, f double)",
    "insert into l values (1, 1, 1.5), (2, 2, null), (3, null, 3.5), "
    "(4, 2, 4.5), (5, 9, 5.5), (6, 2, 2.5)",
    "insert into r values (10, 2, 20, 4.5), (11, 2, 21, 1.5), "
    "(12, 1, 22, null), (13, null, 23, 2.5), (14, 2, 24, 4.5)",
    "create table e (id bigint primary key, k int, s varchar(8))",
    "create table cl (id bigint primary key, "
    "s varchar(8) collate utf8_general_ci)",
    "create table cr (id bigint primary key, "
    "s varchar(8) collate utf8_general_ci)",
    "insert into cl values (1, 'Ant'), (2, 'bee'), (3, null)",
    "insert into cr values (10, 'Ant'), (11, 'BEE'), (12, 'cat')",
    "create table sl (id bigint primary key, k int, s varchar(8))",
    "insert into sl values (1, 2, 'x'), (2, 2, 'y'), (3, 1, null)",
]

# test_join_parity.py QUERIES without residual conditions, and a LEFT
# OUTER join over the empty table (int and string keys)
JOINS = [
    "select l.id, r.id from l join r on l.k = r.k",
    "select l.id, r.id from l left join r on l.k = r.k",
    "select l.id, r.w from l join r on l.k = r.k and l.v > 2",
    "select l.id, r.id from l left join r on l.k = r.k where l.id > 1",
    "select l.id, r.id from l join r on l.v = r.f",
    "select l.id, r.id from l left join r on l.v = r.f",
    "select l.id, e.id from l left join e on l.k = e.k",
    "select sl.id, e.id from sl left join e on sl.k = e.k and "
    "sl.s = e.s",
]

# TestJoinAggFusion.AGG_QUERIES of test_join_parity.py, and an aggregate
# over a LEFT OUTER join with no match
AGGS = [
    "select count(*), sum(r.w), avg(l.v), min(r.w), max(l.v) "
    "from l join r on l.k = r.k",
    "select l.k, count(*), sum(r.w), min(l.v) from l join r "
    "on l.k = r.k group by l.k",
    "select l.k, count(r.w), sum(l.v) from l left join r "
    "on l.k = r.k group by l.k",
    "select count(*), sum(r.w), max(l.v) from l join r "
    "on l.k = r.k and l.v > 1e9",
    "select l.k, count(*) from l join r on l.k = r.k "
    "and l.v > 1e9 group by l.k",
    "select count(*), count(e.k), max(l.v) from l left join e "
    "on l.k = e.k",
]

# test_device_dict.py JOIN_QUERIES 1-5 (composite and single string keys,
# a mixed string + int key, a string group-by over the join)
DICT_JOINS = [
    "select count(*), sum(v), min(dv), max(dv) from t "
    "join dim on f = df and g = dg",
    "select count(*), sum(v), sum(dv) from t "
    "left join dim on f = df and g = dg",
    "select count(*), sum(v) from t join dim on f = df",
    "select count(*), max(dv) from t join dim on f = df and v = dv",
    "select f, count(*), sum(v) from t join dim on f = df and g = dg "
    "group by f",
]

# shapes the reference hands to its row engine: (statement, what the
# port's Unsupported says)
OUT_OF_SLICE = {
    "select l.id, r.id from l left join r on l.k = r.k and l.v > 2 "
    "and r.w < 22": "beyond the equi-keys",
    "select cl.id, cr.id from cl join cr on cl.s = cr.s": "ci-collation",
    "select l.k, count(distinct r.w) from l join r on l.k = r.k "
    "group by l.k": "DISTINCT",
    "select max(sl.s), count(*) from r join sl on sl.k = r.k":
        "collation-aware",
}

STRING_OR_MULTI = set(DICT_JOINS) | {JOINS[7]}
N_DICT_ROWS = 240      # test_device_dict.py N_ROWS


def _dict_tables(s) -> None:
    """test_device_dict.py's _build, in-process (no regions)."""
    s.execute("create table t (id bigint primary key, f varchar(8), "
              "g varchar(8), v bigint)")
    s.execute("create table dim (k bigint primary key, df varchar(8), "
              "dg varchar(8), dv bigint)")
    flags = ("AA", "NN", "RR", "QQ")
    stats = ("F", "O")
    s.execute("insert into t values " + ", ".join(
        f"({i}, '{flags[i % 4]}', '{stats[i % 2]}', {i * 3})"
        if i % 9 else f"({i}, null, '{stats[i % 2]}', {i * 3})"
        for i in range(1, N_DICT_ROWS + 1)))
    s.execute("insert into dim values " + ", ".join(
        f"({i}, '{f}', '{st}', {i * 7})"
        for i, (f, st) in enumerate(
            (f, st) for f in flags + ("ZZ",) for st in stats)))


class _Recorder:
    """Wraps the reference's HashJoinExec and try_fused_agg (with the
    join floor at 0) and keeps what they saw and answered."""

    def __init__(self, mp):
        self.joins, self.fused = [], []
        o_try = rex.HashJoinExec._try_vector_join
        o_finish = rex.HashJoinExec._finish_pairs
        o_fused = rfused.try_fused_agg

        def try_vector(ex):
            self.joins.append({"exec": ex})
            return o_try(ex)

        def finish(ex, lside, rside, li, ri, left_ok):
            o_finish(ex, lside, rside, li, ri, left_ok)
            self.joins[-1].update(lside=lside, rside=rside)

        def fused(agg):
            out = o_fused(agg)
            self.fused.append((agg, out))
            return out

        mp.setattr(rex.HashJoinExec, "_device_join_floor", lambda ex: 0)
        mp.setattr(rex.HashJoinExec, "_try_vector_join", try_vector)
        mp.setattr(rex.HashJoinExec, "_finish_pairs", finish)
        mp.setattr(rfused, "try_fused_agg", fused)


def _oracle_rows(s, sql) -> list:
    """The rows the HashAgg row loop returns over the dict-path join."""
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        o_next = rex.HashAggExec.next

        def agg_next(agg):
            row = o_next(agg)
            if row is not None:
                rows.append(row)
            return row

        mp.setattr(rex.HashJoinExec, "_try_vector_join", lambda ex: False)
        mp.setattr(rex.HashAggExec, "next", agg_next)
        s.execute(sql)
    return rows


def _record(store, s, rec, sql, columnar: int) -> dict:
    s.execute(f"set global tidb_tpu_columnar_scan = {columnar}")
    rec.requests.clear()
    rec.responses.clear()
    with pytest.MonkeyPatch.context() as mp:
        r = _Recorder(mp)
        s.execute(sql)
    join = r.joins[-1]
    ex = join["exec"]
    out = {"store": store, "exec": ex, "plan": ex.plan,
           "requests": list(rec.requests),
           "responses": list(rec.responses),
           "agg": r.fused[-1][0] if r.fused else None,
           "fused": r.fused[-1][1] if r.fused else None,
           "path": ex.join_stats.get("path"),
           "dict_keys": bool(ex.join_stats.get("dict_keys")),
           "widths": [len(c.schema) for c in ex.children],
           "tables": [c.scan_plan.table_info.id for c in ex.children]}
    if "lside" in join:
        dj = ex._device
        out.update(lside=join["lside"], rside=join["rside"],
                   l_idx=dj.l_idx.copy(), r_idx=dj.r_idx.copy(),
                   rows=list(dj.iter_rows()))
    return out


@pytest.fixture(scope="module")
def recorded():
    """{(statement, columnar scan 1/0): what the reference did}."""
    out = {}
    store, s, rec = session("memory://torch_join_jp")
    s.execute("create database jp")
    s.execute("use jp")
    for stmt in JP_TABLES:
        s.execute(stmt)
    for sql in JOINS + AGGS + list(OUT_OF_SLICE):
        for columnar in (1, 0):
            out[(sql, columnar)] = _record(store, s, rec, sql, columnar)
        if sql in AGGS:
            out[(sql, "oracle")] = _oracle_rows(s, sql)
    store, s, rec = session("memory://torch_join_dd")
    s.execute("create database dd")
    s.execute("use dd")
    _dict_tables(s)
    for sql in DICT_JOINS:
        for columnar in (1, 0):
            out[(sql, columnar)] = _record(store, s, rec, sql, columnar)
        out[(sql, "oracle")] = _oracle_rows(s, sql)
    yield out
    release(out)


def _port_join(ref: dict, route: str) -> HashJoinExec:
    if route == "scan":
        pairs = [p for tid in sorted(set(ref["tables"]))
                 for p in table_pairs(ref["store"],
                                      ref["requests"][0].data.start_ts, tid)]
        client = GpuClient(MemStore.from_pairs(pairs), device="cpu")
        reqs = {r.data.table_info.table_id: carry.kv_request_from(r)
                for r in ref["requests"]}
        children = [XSelectTableExec(client, reqs[tid].data,
                                     reqs[tid].key_ranges)
                    for tid in ref["tables"]]
        device = None            # the client's
    else:
        children = [carry.SideExec(carry.side_from(ref[side]), width)
                    for side, width in zip(("lside", "rside"),
                                           ref["widths"])]
        device = "cpu"
    assert [len(c.schema) for c in children] == ref["widths"]
    return HashJoinExec(children[0], children[1],
                        carry.join_plan_from(ref["plan"]), device=device)


def _norm(rows: list) -> list:
    return [[norm_datum(int(d.kind), d.val) for d in row] for row in rows]


ROUTES = {"scan": 1, "columnar_side": 1, "rows_side": 0}


def _check_join(recorded, sql, route) -> HashJoinExec:
    ref = recorded[(sql, ROUTES[route])]
    if route == "columnar_side":
        assert type(ref["lside"]).__name__ == "ColumnarScanResult"
    if route == "rows_side":
        assert type(ref["lside"]).__name__ == "RowsSide"
    port = _port_join(ref, route)
    res = port.device_join_result()
    assert res.l_idx.tolist() == ref["l_idx"].tolist(), sql
    assert res.r_idx.tolist() == ref["r_idx"].tolist(), sql
    assert ref["path"] in ("device", "numpy")
    assert port.join_stats["path"] == \
        ("device" if ref["path"] == "device" else "matchless")
    if sql in STRING_OR_MULTI:
        assert ref["dict_keys"] and port.join_stats["dict_keys"]
    return port


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("sql", JOINS)
def test_join_pairs_and_rows(recorded, sql, route):
    port = _check_join(recorded, sql, route)
    assert _norm(port.drain()) == _norm(recorded[(sql, ROUTES[route])]
                                        ["rows"])


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("sql", AGGS + DICT_JOINS)
def test_join_fused_aggregate(recorded, sql, route):
    ref = recorded[(sql, ROUTES[route])]
    port = _check_join(recorded, sql, route)
    rows = carry.agg_from(ref["agg"], port).drain()
    assert ref["fused"] is not None, sql
    assert _norm(rows) == _norm(ref["fused"]), sql
    assert _norm(rows) == _norm(recorded[(sql, "oracle")]), sql


@pytest.mark.parametrize("sql", list(OUT_OF_SLICE))
def test_out_of_slice_raises(recorded, sql):
    ref = recorded[(sql, 1)]
    port = _port_join(ref, "scan")
    with pytest.raises(Unsupported, match=OUT_OF_SLICE[sql]):
        if ref["agg"] is not None:
            carry.agg_from(ref["agg"], port).drain()
        else:
            port.device_join_result()


@pytest.mark.parametrize("sql", JOINS)
def test_scan_answer_is_the_row_protocol(recorded, sql):
    """The port's columnar scan answer, read as rows, is what TpuClient
    sent as chunks for the same request (tidb_tpu_columnar_scan = 0):
    handles and flattened datums alike."""
    ref = recorded[(sql, 0)]
    client = GpuClient(MemStore.from_pairs(
        [p for tid in sorted(set(ref["tables"]))
         for p in table_pairs(ref["store"], ref["requests"][0].data.start_ts,
                              tid)]), device="cpu")
    for req, parts in zip(ref["requests"], ref["responses"]):
        port_req = carry.kv_request_from(req)
        assert port_req.data.columnar_hint
        resp = client.send(port_req).next()
        assert resp.columnar is not None and not resp.chunks
        want = [r for part in parts for r in ref_rows(part)]
        assert port_rows(resp) == want
        assert resp.row_count() == len(want)
