"""join → ORDER BY and join → TopN in the port (executor.executors
SortExec / TopNExec plane paths over HashJoinExec, K17 through
ops.extsort), held against the JAX package.

tests/test_spill.py's TestSQLOrderBySpill statement (12,000 `l` rows
joined to 3,000 `r` rows, ORDER BY l.v DESC, l.id) and a TopN of it run
through the reference's own session (a memory store, TpuClient at
dispatch floor 0, its HashJoinExec on its device route, budget 0). The
reference's plan, Sort or TopN over a Projection over the join, is
carried over: its join's two sides (ColumnarScanResult sides under
tidb_tpu_columnar_scan = 1, RowsSide sides under 0), its join plan, the
projection and the by-items. The port's rows must equal the reference's
in one K17 pass, in at least two partitioned passes under a budget cut to
half the sort's estimate, and at budget 0. SortExec and TopNExec straight
over a scan's columnar result give Python's sorted rows. A child with no
planes and a key with no order-exact plane raise Unsupported.
"""

from decimal import Decimal

import pytest

from tidb_tpu.executor import executors as rex
from tidb_tpu.ops import membudget as rmembudget
from tidb_tpu.session import new_store
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry, plan
from tidb_tpu_torch.executor.executors import (HashJoinExec, SortExec,
                                               TopNExec, _plane_sort_keys)
from tidb_tpu_torch.ops import extsort, kernels, membudget
from tidb_tpu_torch.ops.exprc import Unsupported

from tests.testkit import TestKit
from torch_parity import port_ledger, release  # noqa: F401

SORT_Q = ("select l.id, l.v, r.w from l join r on l.k = r.k "
          "order by l.v desc, l.id")
TOPN_Q = SORT_Q + " limit 5, 20"
# a DECIMAL key with NULLs: the reference orders it with its row
# comparator, the port by the column's scaled plane
DEC_Q = ("select ld.id, ld.d, r.w from ld join r on ld.k = r.k "
         "order by ld.d desc, ld.id")
N_LD = 5_000
N_L = 12_000        # test_spill.py's min_n for its ORDER BY


@pytest.fixture(autouse=True)
def _ledger(port_ledger):  # noqa: F811
    yield


def _bulk(tk, name, rows):
    tbl = tk.session.info_schema().table_by_name("ss", name)
    txn = tk.store.begin()
    tbl.add_records(txn, rows, skip_unique_check=True)
    txn.commit()


@pytest.fixture(scope="module")
def recorded():
    """{(statement, columnar scan 1 / 0): the reference's plan pieces and
    rows}. The reference sorts DEC_Q with its row comparator: no join
    plane path takes a decimal key there."""
    from tidb_tpu.ops import TpuClient
    tk = TestKit(store=new_store("memory://torch_sort_join"))
    tk.exec("create database ss")
    tk.exec("use ss")
    tk.exec("create table l (id bigint primary key, k bigint, v bigint)")
    tk.exec("create table r (k bigint primary key, w bigint)")
    _bulk(tk, "l", [[RDatum.i64(i), RDatum.i64(i % 3000),
                     RDatum.i64((i * 2654435761) % 65521)]
                    for i in range(1, N_L + 1)])
    _bulk(tk, "r", [[RDatum.i64(k), RDatum.i64(k * 3)] for k in range(3000)])
    tk.exec("create table ld (id bigint primary key, k bigint, "
            "d decimal(10,2))")
    _bulk(tk, "ld", [[RDatum.i64(i), RDatum.i64(i % 3000),
                      RDatum.null() if i % 13 == 0 else RDatum.dec(
                          Decimal(f"{(i * 7919) % 2003 - 1000}.{i % 100:02d}"))]
                     for i in range(1, N_LD + 1)])
    tk.store.set_client(TpuClient(tk.store, dispatch_floor_rows=0))
    out = {}
    seen, sides = [], []
    o_finish = rex.HashJoinExec._finish_pairs

    def finish(ex, lside, rside, li, ri, left_ok):
        o_finish(ex, lside, rside, li, ri, left_ok)
        sides.append((ex, lside, rside))

    def watch(cls):
        o_mat = cls._materialize

        def mat(ex):
            o_mat(ex)
            seen.append(ex)
        return mat

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rex.HashJoinExec, "_device_join_floor", lambda ex: 0)
        mp.setattr(rex.HashJoinExec, "_finish_pairs", finish)
        mp.setattr(rex.SortExec, "_materialize", watch(rex.SortExec))
        mp.setattr(rex.TopNExec, "_materialize", watch(rex.TopNExec))
        rmembudget.set_budget(0)
        try:
            for columnar in (1, 0):
                tk.exec(f"set global tidb_tpu_columnar_scan = {columnar}")
                for sql in (SORT_Q, TOPN_Q, DEC_Q):
                    rows = tk.query(sql).rows
                    top = seen[-1]
                    proj = top.children[0]
                    join, lside, rside = sides[-1]
                    assert type(proj).__name__ == "ProjectionExec"
                    assert proj.children[0] is join
                    out[(sql, columnar)] = dict(
                        top=top, proj=proj, plan=join.plan, lside=lside,
                        rside=rside, widths=[len(c.schema)
                                             for c in join.children],
                        rows=rows)
        finally:
            rmembudget.set_budget(rmembudget.DEFAULT_BUDGET_SPEC)
    yield out
    release(out)


def _port(ref, device="cpu"):
    """The reference's Sort / TopN over Projection over join, as the
    port's over the carried sides (the device comes from the join)."""
    kids = [carry.SideExec(carry.side_from(ref[side]), w)
            for side, w in zip(("lside", "rside"), ref["widths"])]
    join = HashJoinExec(kids[0], kids[1], carry.join_plan_from(ref["plan"]),
                        device=device)
    proj = carry.projection_from(ref["proj"], join)
    top = ref["top"]
    by = [carry.sort_item_from(it) for it in top.by_items]
    if type(top).__name__ == "TopNExec":
        return TopNExec(proj, by, top.offset, top.count), join
    return SortExec(proj, by), join


def _values(rows) -> list:
    """Port rows as the values the reference's session returns."""
    return [[d.val for d in row] for row in rows]


def _estimate(ref) -> int:
    ex, _join = _port(ref)
    from tidb_tpu_torch.executor.executors import _columnar_view
    res, _node = _columnar_view(ex.children[0])
    keys = _plane_sort_keys(res, ex.by_items, len(ex.schema))
    return extsort.sort_bytes_estimate(keys, len(res))


ROUTES = [(sql, c) for sql in (SORT_Q, TOPN_Q) for c in (1, 0)]


@pytest.mark.parametrize("sql,columnar", ROUTES)
def test_one_pass(recorded, sql, columnar):
    ref = recorded[(sql, columnar)]
    membudget.set_budget(1 << 26)
    ex, join = _port(ref)
    got = ex.drain()
    assert _values(got) == ref["rows"], sql
    assert len(got) == (N_L if sql == SORT_Q else 20)
    assert ex.stats == {} and join.join_stats["sort_plane"]
    assert sum(kernels.LAUNCHES.values()) == 0    # plain on the CPU


@pytest.mark.parametrize("sql,columnar", ROUTES)
def test_partitioned_passes(recorded, sql, columnar):
    """A budget cut to half the sort's estimate: at least two passes."""
    ref = recorded[(sql, columnar)]
    membudget.set_budget(_estimate(ref) // 2)
    ex, _join = _port(ref)
    assert _values(ex.drain()) == ref["rows"], sql
    assert ex.stats["spilled"] and ex.stats["sort_passes"] >= 2, ex.stats


@pytest.mark.parametrize("sql", [SORT_Q, TOPN_Q])
def test_kill_switch(recorded, sql):
    ref = recorded[(sql, 1)]
    membudget.set_budget(0)
    ex, _join = _port(ref)
    assert _values(ex.drain()) == ref["rows"], sql
    assert ex.stats == {}


@pytest.mark.parametrize("columnar", [1, 0])
def test_decimal_key(recorded, columnar):
    """The port sorts a decimal key by its scaled plane, in passes too,
    and gives the reference's row comparator's rows; a decimal key over
    row sides (no packed planes) raises."""
    ref = recorded[(DEC_Q, columnar)]
    if columnar == 0:
        ex, _join = _port(ref)
        with pytest.raises(Unsupported, match="order-exact plane"):
            ex.drain()
        return
    for budget in (1 << 26, _estimate(ref) // 2):
        membudget.set_budget(budget)
        ex, _join = _port(ref)
        got = ex.drain()
        assert len(got) == N_LD and _values(got) == ref["rows"]
    assert ex.stats["sort_passes"] >= 2


@pytest.mark.parametrize("budget_share", [0, 2])
def test_scan_order_by_and_topn(recorded, budget_share):
    """SortExec / TopNExec straight over a scan's columnar result (the
    carried `l` side): rows in the order Python's sort gives, in one pass
    (budget_share 0) and in passes over half the estimate."""
    side = carry.side_from(recorded[(SORT_Q, 1)]["lside"])
    by = [plan.SortItem(plan.Column(2), True), plan.SortItem(plan.Column(0))]
    rows = side.rows()
    want = sorted(([d.val for d in r] for r in rows),
                  key=lambda r: (-r[2], r[0]))
    keys = _plane_sort_keys(side, by, 3)
    est = extsort.sort_bytes_estimate(keys, len(rows))
    membudget.set_budget(est // budget_share if budget_share else 1 << 26)
    ex = SortExec(carry.SideExec(side, 3), by, device="cpu")
    assert _values(ex.drain()) == want
    assert bool(ex.stats) == bool(budget_share)
    top = TopNExec(carry.SideExec(side, 3), by, 7, 11, device="cpu")
    assert _values(top.drain()) == want[7:18]


def test_out_of_slice_raises(recorded):
    ref = recorded[(SORT_Q, 0)]
    rows = carry.RowsExec([], 3)
    with pytest.raises(Unsupported, match="offers no planes"):
        SortExec(rows, [plan.SortItem(plan.Column(0))], device="cpu").drain()
    ex, _join = _port(ref)
    ex.by_items = [plan.SortItem(plan.Residual("l.v + 1"))]
    with pytest.raises(Unsupported, match="order-exact plane"):
        ex.drain()
