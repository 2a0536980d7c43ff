"""Ranked group-by, DISTINCT aggregates and TopN through the port, held
against the JAX package and its CPU engine.

Statements run through JAX Sessions with a recording TpuClient; their
kv.Requests replay through GpuClient(device="cpu") (tests/torch_parity.py),
whose partial rows must equal TpuClient's and the CPU engine's.

- FUZZ: the DISTINCT, ranked and TopN QUERIES of tests/test_tpu_fuzz.py
  (and four with expression keys or a WHERE) over a 300-row table of its
  schema, with the radix ceiling at 128 and one
  rung of 513 on both packages, so the high-cardinality group-bys take
  the rank route.
- LADDER: statements picked for each rung over test_tpu_copr.py's 7-row
  table, with the radix ceiling at 4 and the ladder (3, 5, 9); RANKED:
  its RANKED_QUERIES at the same ceiling on one rung of 9; TUPLE:
  statements whose ladder (3, 5) overflows and whose tuples fit a
  ceiling of 16. The route each took is asserted, and the rung memo
  across repeats. (Each rung a statement tries costs the reference a
  compile, so the ladders are no longer than the case needs.)
- Faults of the reference's TopN, where the port gives the CPU engine's
  answer and TpuClient's differing answer is asserted as the known fault:
  a NULL key beside a filtered row, the int64 minimum under DESC, and
  BIGINT keys above 2^53 (both index orders; the smaller key first shows
  the fault).

Tolerance: exact, except f64 sums (relative 1e-12).
"""

import random

import pytest

from tidb_tpu_torch import carry
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient

from torch_parity import (answers, assert_rows_equal, check_statement,
                          port_rows, release, run_recorded, session,
                          shrink_ranked, table_pairs)

FUZZ_QUERIES = [
    "select count(distinct a) from t",
    "select count(distinct b) from t",
    "select count(distinct e) from t",
    "select b, e, count(*), sum(a) from t group by b, e order by b, e",
    "select a, count(*), sum(c) from t group by a order by a",
    "select d, count(*) from t group by d order by d",
    "select id from t order by c desc limit 50",
    "select id from t order by a limit 25",
    "select id from t order by e desc, c limit 40",
    "select id from t order by b, a desc, id limit 30",
    "select e, count(distinct a) from t group by e order by e",
    "select e, count(distinct b), sum(distinct a) from t "
    "group by e order by e",
    "select b, count(distinct e) from t group by b order by b",
    "select sum(distinct e), avg(distinct e) from t",
    "select count(distinct m) from t",
    "select sum(distinct c), avg(distinct m) from t where a > 1000",
    "select d, count(distinct b), sum(distinct m) from t group by d",
    # expression keys and arguments (K1 writes their planes), TopN under
    # a WHERE
    "select id from t order by a * 2 + e desc limit 7",
    "select id from t where e < 4 order by c desc, id limit 20",
    "select id from t where e < 4 order by d limit 15",
    "select count(distinct a + e) from t",
]
FUZZ_LADDER = (128, (513,))
# statements of FUZZ_QUERIES that take the rank route
FUZZ_RANKED = {
    "select b, e, count(*), sum(a) from t group by b, e order by b, e",
    "select a, count(*), sum(c) from t group by a order by a",
    "select d, count(*) from t group by d order by d",
    "select d, count(distinct b), sum(distinct m) from t group by d",
}

# (statement, the rung that answers it) over the 7-row table
LADDER_CAPS = (4, (3, 5, 9))
LADDER = {
    "select d, count(*) from t where a >= 40 group by d": 3,
    "select b, count(*) from t where a > 25 group by b": 5,
    "select a, count(distinct b), sum(distinct c), min(c), max(d) "
    "from t group by a": 9,
}
# test_tpu_copr.py RANKED_QUERIES
RANKED_CAPS = (4, (9,))
RANKED_QUERIES = [
    "select a, count(*) from t group by a order by a",
    "select a, b, count(*) from t group by a, b order by a, b",
    "select a, b from t group by a order by a",
    "select d, count(*), sum(a) from t group by d order by d",
]
# the ladder overflows, the tuples fit the ceiling
TUPLE_CAPS = (16, (3, 5))
TUPLE = [
    "select a, b, count(*), sum(c) from t group by a, b",
    "select a, d, count(distinct b), avg(c) from t group by a, d",
]

T_ROWS = ("(1, 10, 'x', 1.5, '2024-01-15'), (2, 20, 'y', 2.5, '2024-02-10'), "
          "(3, 30, 'x', 3.5, '2024-03-01'), (4, 40, 'z', null, '2024-04-20'), "
          "(5, 50, 'y', 4.5, null), (6, 30, null, 0.5, '2024-01-01'), "
          "(7, -5, 'xx', -1.5, '2023-12-31')")

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
# the reference's TopN faults: (table, rows, statement, CPU engine's
# handles, TpuClient's handles)
FAULTS = {
    # build_topn_fn scores a live NULL key under DESC like a filtered row
    # (-inf), and lax.top_k breaks the tie by index: filtered row 1 wins
    "null key beside a filtered row": (
        "f1 (id bigint primary key, a int, c double)",
        "(1, 0, 5.0), (2, 1, null), (3, 1, 3.0), (4, 0, 9.0)",
        "select id from f1 where a > 0 order by c desc limit 2",
        [3, 2], [3, 1]),
    # build_topn_fn_multi negates int64 keys for DESC: -(-2^63) wraps
    "int64 minimum under desc": (
        "f2 (id bigint primary key, a bigint, b int)",
        f"(1, {I64_MIN}, 0), (2, 5, 0), (3, {(1 << 53) + 1}, 0), "
        f"(4, {1 << 53}, 0), (5, 7, 0)",
        "select id from f2 order by a desc, id limit 2",
        [3, 4], [1, 3]),
}
# BIGINT keys above 2^53 that round to one f64, in both index orders
# (build_topn_fn casts its key to f64, and lax.top_k breaks the tie by
# index): (table, rows, statement, CPU engine's handles, TpuClient's).
# With the smaller key first TpuClient returns it: a third fault.
ABOVE_2_53 = {
    "smaller key first": (
        "g1 (id bigint primary key, a bigint)",
        f"(1, {1 << 53}), (2, {(1 << 53) + 1}), (3, {I64_MAX})",
        "select id from g1 where a < 9007199254740994 order by a desc "
        "limit 1", [2], [1]),
    "larger key first": (
        "g2 (id bigint primary key, a bigint)",
        f"(1, {(1 << 53) + 1}), (2, {1 << 53}), (3, {I64_MAX})",
        "select id from g2 where a < 9007199254740994 order by a desc "
        "limit 1", [1], [1]),
}


def _fuzz_rows(n: int, seed: int) -> str:
    """Rows of test_tpu_fuzz.py's schema: NULL-dense columns, 64 words,
    dates over a year, wide ints, 2-place decimals."""
    rng = random.Random(seed)
    words = [f"w{i:03d}" for i in range(64)]
    out = []
    for i in range(1, n + 1):
        a = str(rng.randint(0, 2999)) if rng.random() > 0.05 else "null"
        b = f"'{rng.choice(words)}'" if rng.random() > 0.15 else "null"
        c = repr(round(rng.uniform(-1e6, 1e6), 4)) \
            if rng.random() > 0.30 else "null"
        d = f"date_add('2020-01-01', interval {rng.randint(0, 365)} day)" \
            if rng.random() > 0.10 else "null"
        e = rng.randint(0, 7)
        f = rng.randint(-10 ** 12, 10 ** 12)
        m = f"{rng.randint(-10 ** 7, 10 ** 7) / 100:.2f}" \
            if rng.random() > 0.20 else "null"
        out.append(f"({i}, {a}, {b}, {c}, {d}, {e}, {f}, {m})")
    return ", ".join(out)


def _t_session(url: str):
    store, s, rec = session(url)
    s.execute("create database test")
    s.execute("use test")
    s.execute("create table t (id bigint primary key, a int, "
              "b varchar(32), c double, d date)")
    s.execute("insert into t values " + T_ROWS)
    return store, s, rec


@pytest.fixture(scope="module")
def recorded():
    """{(group, statement): (store, [(kv.Request, TpuClient partials)])}."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        shrink_ranked(mp, *FUZZ_LADDER)
        store, s, rec = session("memory://torch_slice3_fuzz")
        s.execute("create database fz")
        s.execute("use fz")
        s.execute("create table t (id bigint primary key, a int, "
                  "b varchar(32), c double, d date, e int, f bigint, "
                  "m decimal(12,2))")
        s.execute("insert into t values " + _fuzz_rows(300, 1234))
        for sql in FUZZ_QUERIES:
            out[("fuzz", sql)] = (store, run_recorded(s, rec, sql))
    store, s, rec = _t_session("memory://torch_slice3_t")
    for group, caps, sqls in (("ladder", LADDER_CAPS, LADDER),
                              ("ranked", RANKED_CAPS, RANKED_QUERIES),
                              ("tuple", TUPLE_CAPS, TUPLE)):
        with pytest.MonkeyPatch.context() as mp:
            shrink_ranked(mp, *caps)
            for sql in sqls:
                out[(group, sql)] = (store, run_recorded(s, rec, sql))
    store, s, rec = session("memory://torch_slice3_faults")
    s.execute("create database fa")
    s.execute("use fa")
    for table, rows, sql, *_answers in list(FAULTS.values()) \
            + list(ABOVE_2_53.values()):
        s.execute(f"create table {table}")
        s.execute(f"insert into {table.split()[0]} values {rows}")
        out[("fault", sql)] = (store, run_recorded(s, rec, sql))
    yield out
    release(out)


@pytest.mark.parametrize("sql", FUZZ_QUERIES)
def test_fuzz_queries(recorded, sql, monkeypatch):
    shrink_ranked(monkeypatch, *FUZZ_LADDER)
    store, reqs = recorded[("fuzz", sql)]
    clients = check_statement(store, reqs, sql)
    ranked = sum(c.stats["ranked"] for c in clients)
    assert ranked == (1 if sql in FUZZ_RANKED else 0), sql
    if "order by" in sql and "limit" in sql:
        assert all(req.data.order_by and req.data.limit
                   for req, _p in reqs), "TopN was not pushed down"


@pytest.mark.parametrize("sql", sorted(LADDER))
def test_rank_ladder_rungs(recorded, sql, monkeypatch):
    shrink_ranked(monkeypatch, *LADDER_CAPS)
    store, reqs = recorded[("ladder", sql)]
    (client,) = check_statement(store, reqs, sql)
    assert client.stats["ranked"] == 1
    assert client.last_rank_cap == LADDER[sql]


@pytest.mark.parametrize("sql", RANKED_QUERIES)
def test_ranked_queries(recorded, sql, monkeypatch):
    shrink_ranked(monkeypatch, *RANKED_CAPS)
    store, reqs = recorded[("ranked", sql)]
    (client,) = check_statement(store, reqs, sql)
    assert client.stats["ranked"] == 1 and client.last_rank_cap == 9


def _replay_twice(store, req):
    """One GpuClient answering the same request twice."""
    sel = req.data
    client = GpuClient(MemStore.from_pairs(
        table_pairs(store, sel.start_ts, sel.table_info.table_id)),
        device="cpu")
    first = port_rows(client.send(carry.kv_request_from(req)).next())
    memo = dict(client._rank_cap_start)
    second = port_rows(client.send(carry.kv_request_from(req)).next())
    return client, first, second, memo


def test_rank_memo_starts_at_the_answering_rung(recorded, monkeypatch):
    shrink_ranked(monkeypatch, *LADDER_CAPS)
    sql = "select b, count(*) from t where a > 25 group by b"
    store, ((req, _parts),) = recorded[("ladder", sql)]
    client, first, second, memo = _replay_twice(store, req)
    assert list(memo.values()) == [5]
    assert client.stats["ranked"] == 2 and client.last_rank_cap == 5
    assert first == second


@pytest.mark.parametrize("sql", TUPLE)
def test_ladder_overflow_takes_tuple_codes(recorded, sql, monkeypatch):
    shrink_ranked(monkeypatch, *TUPLE_CAPS)
    store, reqs = recorded[("tuple", sql)]
    (client,) = check_statement(store, reqs, sql)
    assert client.stats["ranked"] == 0
    assert client.stats["tuple_grouped"] == 1
    # the overflow is memoized: a repeat goes straight to tuple codes
    (req, _parts), = reqs
    client, first, second, memo = _replay_twice(store, req)
    assert list(memo.values()) == [6]
    assert client.stats["tuple_grouped"] == 2 and client.stats["ranked"] == 0
    assert first == second


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_reference_topn_fault(recorded, case):
    """The port gives the CPU engine's rows; TpuClient's rows differ (a
    known fault of the reference, recorded in ROADMAP.md Queue 3)."""
    _table, _rows, sql, cpu_handles, tpu_handles = FAULTS[case]
    store, ((req, parts),) = recorded[("fault", sql)]
    assert req.data.order_by and req.data.limit
    got, tpu, cpu, _client = answers(store, req, parts)
    assert [h for h, _r in cpu] == cpu_handles
    assert_rows_equal(got, cpu, f"{case} vs CPU engine")
    assert [h for h, _r in tpu] == tpu_handles


@pytest.mark.parametrize("case", sorted(ABOVE_2_53))
def test_bigint_keys_above_2_53(recorded, case):
    _table, _rows, sql, cpu_handles, tpu_handles = ABOVE_2_53[case]
    store, ((req, parts),) = recorded[("fault", sql)]
    got, tpu, cpu, _client = answers(store, req, parts)
    assert [h for h, _r in cpu] == cpu_handles
    assert_rows_equal(got, cpu, f"{case} vs CPU engine")
    assert [h for h, _r in tpu] == tpu_handles
