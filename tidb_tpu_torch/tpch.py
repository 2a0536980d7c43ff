"""TPC-H `lineitem` for driving the port: data and the requests the
planner sends for it.

Types follow the TPC-H v3 specification §1.4 (DECIMAL(15,2) money and
quantities, CHAR flags, DATE columns) and the column layout of the JAX
package's planner for
    CREATE TABLE lineitem (l_orderkey bigint, l_partkey bigint,
      l_suppkey bigint, l_linenumber int, l_quantity decimal(15,2),
      l_extendedprice decimal(15,2), l_discount decimal(15,2),
      l_tax decimal(15,2), l_returnflag char(1), l_linestatus char(1),
      l_shipdate date, l_commitdate date, l_receiptdate date,
      l_shipinstruct char(25), l_shipmode char(10), l_comment varchar(44),
      primary key (l_orderkey, l_linenumber))
whose column ids are 1..16 and whose handle is the row id, plus one
column the specification lacks, l_fdiscount double (id 17, the discount
as a binary float), so that a statement can aggregate a DOUBLE column
(the float_expr shape of the JAX package's TPC-H sweep). Values follow
dbgen's distributions (§4.2.3): sparse order keys, 1-7 lines per order,
the part/supplier bridge, retail price from the part key, order dates
over [1992-01-01, 1998-08-02], ship/commit/receipt offsets, and return
flag / line status against CURRENTDATE 1995-06-17. The random numbers come
from numpy with a seed, not from dbgen's generator, so the rows are not
dbgen's rows; their shapes and distributions are.
"""

from __future__ import annotations

import datetime as dt
from decimal import Decimal

import numpy as np

from tidb_tpu_torch import mysqldef as my, tablecodec as tc
from tidb_tpu_torch.copr.proto import (ByItem, Expr, ExprType, PBColumnInfo,
                                       PBTableInfo, SelectRequest, expr_agg,
                                       expr_column, expr_op, expr_value)
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import Datum, Kind
from tidb_tpu_torch.types.time_types import Time

TABLE_ID = 100
SF1_ROWS = 6_001_215
SF001_ROWS = 60_175

C_ORDERKEY, C_PARTKEY, C_SUPPKEY, C_LINENUMBER = 1, 2, 3, 4
C_QUANTITY, C_EXTENDEDPRICE, C_DISCOUNT, C_TAX = 5, 6, 7, 8
C_RETURNFLAG, C_LINESTATUS = 9, 10
C_SHIPDATE, C_COMMITDATE, C_RECEIPTDATE = 11, 12, 13
C_SHIPINSTRUCT, C_SHIPMODE, C_COMMENT = 14, 15, 16
C_FDISCOUNT = 17

_DEC = dict(tp=my.TypeNewDecimal, flen=15, decimal=2)
COLUMNS = {
    C_ORDERKEY: dict(tp=my.TypeLonglong, flen=20),
    C_PARTKEY: dict(tp=my.TypeLonglong, flen=20),
    C_SUPPKEY: dict(tp=my.TypeLonglong, flen=20),
    C_LINENUMBER: dict(tp=my.TypeLong, flen=11),
    C_QUANTITY: _DEC, C_EXTENDEDPRICE: _DEC, C_DISCOUNT: _DEC, C_TAX: _DEC,
    C_RETURNFLAG: dict(tp=my.TypeString, flen=1),
    C_LINESTATUS: dict(tp=my.TypeString, flen=1),
    C_SHIPDATE: dict(tp=my.TypeDate, flen=10),
    C_COMMITDATE: dict(tp=my.TypeDate, flen=10),
    C_RECEIPTDATE: dict(tp=my.TypeDate, flen=10),
    C_SHIPINSTRUCT: dict(tp=my.TypeString, flen=25),
    C_SHIPMODE: dict(tp=my.TypeString, flen=10),
    C_COMMENT: dict(tp=my.TypeVarchar, flen=44),
    C_FDISCOUNT: dict(tp=my.TypeDouble, flen=22),
}

SHIPINSTRUCT = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
                b"TAKE BACK RETURN"]
SHIPMODE = [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB"]
RETURNFLAG = [b"A", b"N", b"R"]
LINESTATUS = [b"F", b"O"]
_WORDS = (b"furiously regular deposits sleep slyly final accounts haggle "
          b"carefully ironic packages among the blithely express requests "
          b"quickly bold pinto beans unusual theodolites").split()

_EPOCH = np.datetime64("1992-01-01")
_CURRENT = np.datetime64("1995-06-17")


def column_info(cid: int) -> PBColumnInfo:
    c = COLUMNS[cid]
    return PBColumnInfo(column_id=cid, tp=c["tp"], flen=c["flen"],
                        decimal=c.get("decimal", -1))


def table_info(cids) -> PBTableInfo:
    return PBTableInfo(TABLE_ID, [column_info(c) for c in cids])


def generate(n_rows: int, seed: int) -> dict:
    """Columns of `n_rows` lineitem rows as numpy arrays: integers,
    decimals as int64 cents, dates as numpy datetime64[D], strings as
    int64 indices into SHIPINSTRUCT / SHIPMODE / RETURNFLAG / LINESTATUS
    (comments as an index into a small phrase table)."""
    rng = np.random.default_rng(seed)
    sf = n_rows / SF1_ROWS
    n_orders = n_rows // 3 + 8                      # 1-7 lines, mean 4
    lines = rng.integers(1, 8, n_orders)
    while lines.sum() < n_rows:
        lines = np.concatenate([lines, rng.integers(1, 8, n_orders)])
    order_idx = np.repeat(np.arange(lines.shape[0]), lines)[:n_rows]
    first = np.concatenate([[0], np.cumsum(lines)[:-1]])
    linenumber = np.arange(n_rows) - first[order_idx] + 1
    orderkey = (order_idx // 8) * 32 + order_idx % 8 + 1
    span = int((np.datetime64("1998-12-31") - 151 - _EPOCH)
               .astype(int))
    orderdate = rng.integers(0, span + 1, lines.shape[0])[order_idx]

    n_parts = max(int(200_000 * sf), 1)
    n_supp = max(int(10_000 * sf), 1)
    partkey = rng.integers(1, n_parts + 1, n_rows)
    j = rng.integers(0, 4, n_rows)
    suppkey = (partkey + j * (n_supp // 4 + (partkey - 1) // n_supp)) \
        % n_supp + 1
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)
    quantity = rng.integers(1, 51, n_rows)
    ship = orderdate + rng.integers(1, 122, n_rows)
    commit = orderdate + rng.integers(30, 91, n_rows)
    receipt = ship + rng.integers(1, 31, n_rows)
    shipdate = _EPOCH + ship.astype("timedelta64[D]")
    receiptdate = _EPOCH + receipt.astype("timedelta64[D]")
    returned = receiptdate <= _CURRENT
    returnflag = np.where(returned, rng.integers(0, 2, n_rows) * 2, 1)
    out = {
        C_ORDERKEY: orderkey.astype(np.int64),
        C_PARTKEY: partkey.astype(np.int64),
        C_SUPPKEY: suppkey.astype(np.int64),
        C_LINENUMBER: linenumber.astype(np.int64),
        C_QUANTITY: (quantity * 100).astype(np.int64),
        C_EXTENDEDPRICE: (quantity * retail).astype(np.int64),
        C_DISCOUNT: rng.integers(0, 11, n_rows).astype(np.int64),
        C_TAX: rng.integers(0, 9, n_rows).astype(np.int64),
        C_RETURNFLAG: returnflag.astype(np.int64),     # A=0 N=1 R=2
        C_LINESTATUS: (shipdate > _CURRENT).astype(np.int64),  # F=0 O=1
        C_SHIPDATE: shipdate,
        C_COMMITDATE: _EPOCH + commit.astype("timedelta64[D]"),
        C_RECEIPTDATE: receiptdate,
        C_SHIPINSTRUCT: rng.integers(0, 4, n_rows).astype(np.int64),
        C_SHIPMODE: rng.integers(0, 7, n_rows).astype(np.int64),
        C_COMMENT: rng.integers(0, 1 << 20, n_rows).astype(np.int64),
    }
    out[C_FDISCOUNT] = out[C_DISCOUNT] / 100.0
    return out


def packed_dates(d: np.ndarray) -> np.ndarray:
    """datetime64[D] → the packed-int plane encoding of Time (DATE)."""
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    month = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    ymd = ((year * 13 + month) << 5) | day
    return (ymd << 17) << 24


def _comment(code: int) -> bytes:
    words = [_WORDS[(code >> (4 * k)) % len(_WORDS)] for k in range(5)]
    return b" ".join(words)[:43]


def _text(cid: int, code: int) -> bytes:
    if cid == C_SHIPINSTRUCT:
        return SHIPINSTRUCT[code]
    if cid == C_SHIPMODE:
        return SHIPMODE[code]
    if cid == C_RETURNFLAG:
        return RETURNFLAG[code]
    if cid == C_LINESTATUS:
        return LINESTATUS[code]
    return _comment(code)


def kv_pairs(data: dict):
    """(row key, row value) of every row, encoded by the port's
    tablecodec — the rows a store of the table holds."""
    n = data[C_ORDERKEY].shape[0]
    cids = sorted(COLUMNS)
    lists = {cid: data[cid].tolist() for cid in cids}
    for cid in (C_SHIPDATE, C_COMMITDATE, C_RECEIPTDATE):
        lists[cid] = [Datum(Kind.TIME, Time(dt.datetime(x.year, x.month,
                                                        x.day), my.TypeDate))
                      for x in data[cid].astype(dt.date).tolist()]
    for cid in (C_QUANTITY, C_EXTENDEDPRICE, C_DISCOUNT, C_TAX):
        lists[cid] = [Datum.dec(Decimal(v).scaleb(-2)) for v in lists[cid]]
    for cid in (C_RETURNFLAG, C_LINESTATUS, C_SHIPINSTRUCT, C_SHIPMODE,
                C_COMMENT):
        lists[cid] = [Datum.bytes_(_text(cid, v)) for v in lists[cid]]
    for cid in (C_ORDERKEY, C_PARTKEY, C_SUPPKEY, C_LINENUMBER):
        lists[cid] = [Datum.i64(v) for v in lists[cid]]
    lists[C_FDISCOUNT] = [Datum.f64(v) for v in lists[C_FDISCOUNT]]
    for i in range(n):
        yield (tc.encode_row_key(TABLE_ID, i + 1),
               tc.encode_row(cids, [lists[cid][i] for cid in cids]))


def batch(data: dict, cids, lo: int = 0, hi: int | None = None
          ) -> col.ColumnBatch:
    """The packed ColumnBatch of the given columns over rows [lo, hi)
    (handles lo + 1 .. hi), built straight from the arrays (what
    pack_ranges yields for these rows)."""
    if hi is None:
        hi = data[C_ORDERKEY].shape[0]
    data = {cid: data[cid][lo:hi] for cid in cids}
    n = hi - lo
    cap = col.bucket_capacity(n)
    handles = np.full(cap, col.I64_MIN, dtype=np.int64)
    handles[:n] = np.arange(lo + 1, hi + 1)
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True
    cols = {}
    dicts = {C_RETURNFLAG: RETURNFLAG, C_LINESTATUS: LINESTATUS,
             C_SHIPINSTRUCT: SHIPINSTRUCT, C_SHIPMODE: SHIPMODE}
    for cid in cids:
        c = COLUMNS[cid]
        kind = col.column_phys_kind(column_info(cid))
        raw = data[cid]
        if c["tp"] == my.TypeDate:
            raw = packed_dates(raw)
        vals = np.zeros(cap, dtype=np.int64)
        if kind == col.K_STR:
            # the sorted dictionary of the values present; codes index it
            words = dicts[cid]
            dictionary = sorted({words[k] for k in np.unique(raw).tolist()})
            code_of = {w: i for i, w in enumerate(dictionary)}
            lut = np.array([code_of.get(w, -1) for w in words],
                           dtype=np.int64)
            vals[:n] = lut[raw]
            vals[n:] = -1
            cols[cid] = col.ColumnData(kind, vals, valid.copy(), dictionary,
                                       tp=c["tp"])
            continue
        if kind == col.K_F64:
            vals = np.zeros(cap, dtype=np.float64)
            vals[:n] = raw
            cols[cid] = col.ColumnData(kind, vals, valid.copy(), tp=c["tp"])
            continue
        vals[:n] = raw
        cols[cid] = col.ColumnData(
            kind, vals, valid.copy(), tp=c["tp"],
            dec_scale=c.get("decimal", 0) if kind == col.K_DEC else 0,
            max_abs=int(np.abs(raw).max()) if n else 0)
    return col.ColumnBatch(n, cap, handles, cols)


def region_bounds(n_rows: int, n_regions: int) -> list:
    """[(lo, hi)) row ranges of `n_regions` regions split by handle, the
    last taking the remainder (the split of the JAX package's bench)."""
    step = max(n_rows // n_regions, 1)
    cuts = [min(step * i, n_rows) for i in range(n_regions)] + [n_rows]
    return list(zip(cuts[:-1], cuts[1:]))


def split_keys(n_rows: int, n_regions: int) -> list:
    """The row keys that split the table into those regions."""
    return [tc.encode_row_key(TABLE_ID, lo + 1)
            for lo, _hi in region_bounds(n_rows, n_regions)[1:]]


def region_batches(data: dict, cids, n_regions: int) -> list:
    """One ColumnBatch per region of the handle-range split: what each
    region packs for these columns (its own string dictionaries and
    bounds)."""
    n = data[C_ORDERKEY].shape[0]
    return [batch(data, cids, lo, hi)
            for lo, hi in region_bounds(n, n_regions)]


def store_request(sel: SelectRequest) -> kv.Request:
    start, end = tc.encode_record_range(TABLE_ID)
    return kv.Request(kv.REQ_TYPE_SELECT, sel, [kv.KeyRange(start, end)])


def _date(s: str) -> Datum:
    d = dt.date.fromisoformat(s)
    return Datum(Kind.TIME, Time(dt.datetime(d.year, d.month, d.day),
                                 my.TypeDate))


def _dec(s: str) -> Datum:
    return Datum.dec(Decimal(s))


def _one() -> Datum:
    return Datum.i64(1)


def q1() -> SelectRequest:
    """TPC-H Q1 as the planner pushes it (date folded to 1998-09-02)."""
    c = expr_column
    disc_price = expr_op(Op.Mul, c(C_EXTENDEDPRICE),
                         expr_op(Op.Minus, expr_value(_one()), c(C_DISCOUNT)))
    charge = expr_op(Op.Mul, disc_price,
                     expr_op(Op.Plus, expr_value(_one()), c(C_TAX)))
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_QUANTITY, C_EXTENDEDPRICE, C_DISCOUNT,
                               C_TAX, C_RETURNFLAG, C_LINESTATUS,
                               C_SHIPDATE]),
        where=expr_op(Op.LE, c(C_SHIPDATE), expr_value(_date("1998-09-02"))),
        group_by=[ByItem(c(C_RETURNFLAG)), ByItem(c(C_LINESTATUS))],
        aggregates=[
            expr_agg("sum", [c(C_QUANTITY)]),
            expr_agg("sum", [c(C_EXTENDEDPRICE)]),
            expr_agg("sum", [disc_price]),
            expr_agg("sum", [charge]),
            expr_agg("avg", [c(C_QUANTITY)]),
            expr_agg("avg", [c(C_EXTENDEDPRICE)]),
            expr_agg("avg", [c(C_DISCOUNT)]),
            expr_agg("count", [expr_value(_one())]),
            expr_agg("first_row", [c(C_RETURNFLAG)]),
            expr_agg("first_row", [c(C_LINESTATUS)]),
        ])


def q6() -> SelectRequest:
    c = expr_column
    s = Datum.string
    where = expr_op(
        Op.AndAnd,
        expr_op(Op.AndAnd,
                expr_op(Op.AndAnd,
                        expr_op(Op.AndAnd,
                                expr_op(Op.GE, c(C_SHIPDATE),
                                        expr_value(s("1994-01-01"))),
                                expr_op(Op.LT, c(C_SHIPDATE),
                                        expr_value(s("1995-01-01")))),
                        expr_op(Op.GE, c(C_DISCOUNT),
                                expr_value(_dec("0.05")))),
                expr_op(Op.LE, c(C_DISCOUNT), expr_value(_dec("0.07")))),
        expr_op(Op.LT, c(C_QUANTITY), expr_value(Datum.i64(24))))
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_QUANTITY, C_EXTENDEDPRICE, C_DISCOUNT,
                               C_SHIPDATE]),
        where=where,
        aggregates=[expr_agg("sum", [expr_op(Op.Mul, c(C_EXTENDEDPRICE),
                                             c(C_DISCOUNT))])])


def filter_scan() -> SelectRequest:
    """select l_orderkey, l_linenumber, l_quantity, l_shipmode,
    l_shipdate, l_comment where l_quantity < 3 and l_shipmode in ('AIR',
    'MAIL') and l_comment like '%ly%'."""
    c = expr_column
    where = expr_op(
        Op.AndAnd,
        expr_op(Op.AndAnd,
                expr_op(Op.LT, c(C_QUANTITY), expr_value(Datum.i64(3))),
                _in(c(C_SHIPMODE), [b"AIR", b"MAIL"])),
        _like(c(C_COMMENT), "%ly%"))
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_ORDERKEY, C_LINENUMBER, C_QUANTITY,
                               C_SHIPMODE, C_SHIPDATE, C_COMMENT]),
        where=where)


def _in(target, items):
    return Expr(ExprType.IN, children=[target] + [
        expr_value(Datum.bytes_(b)) for b in items])


def _like(target, pattern: str):
    return Expr(ExprType.LIKE, val="\\",
                children=[target, expr_value(Datum.string(pattern))])


def scalar_first_row() -> SelectRequest:
    """select count(*), min(l_shipdate), max(l_extendedprice), sum(l_tax),
    any l_comment where l_discount > 0.05 — first_row on a scalar
    aggregate."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_EXTENDEDPRICE, C_DISCOUNT, C_TAX,
                               C_SHIPDATE, C_COMMENT]),
        where=expr_op(Op.GT, c(C_DISCOUNT), expr_value(_dec("0.05"))),
        aggregates=[expr_agg("count", [expr_value(_one())]),
                    expr_agg("min", [c(C_SHIPDATE)]),
                    expr_agg("max", [c(C_EXTENDEDPRICE)]),
                    expr_agg("sum", [c(C_TAX)]),
                    expr_agg("first_row", [c(C_COMMENT)])])


def by_supplier() -> SelectRequest:
    """select l_suppkey, count(*), sum(l_quantity), avg(l_discount),
    max(l_shipdate) group by l_suppkey — more than 64 segments."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_SUPPKEY, C_QUANTITY, C_DISCOUNT,
                               C_SHIPDATE]),
        group_by=[ByItem(c(C_SUPPKEY))],
        aggregates=[expr_agg("count", [expr_value(_one())]),
                    expr_agg("sum", [c(C_QUANTITY)]),
                    expr_agg("avg", [c(C_DISCOUNT)]),
                    expr_agg("max", [c(C_SHIPDATE)]),
                    expr_agg("first_row", [c(C_SUPPKEY)])])


def all_filtered() -> SelectRequest:
    """An aggregate whose WHERE keeps no row: NULL sums and extrema."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_QUANTITY, C_EXTENDEDPRICE, C_SHIPDATE]),
        where=expr_op(Op.GT, c(C_QUANTITY), expr_value(Datum.i64(100))),
        aggregates=[expr_agg("count", [expr_value(_one())]),
                    expr_agg("sum", [c(C_EXTENDEDPRICE)]),
                    expr_agg("min", [c(C_SHIPDATE)]),
                    expr_agg("max", [c(C_QUANTITY)])])


def q1_expected(data: dict) -> dict:
    """Q1 computed straight from the arrays with numpy (exact int64
    cents): {(flag, status): (count, sum_qty, sum_price, sum_disc_price,
    sum_charge, sum_disc)} — the scaled sums at scales 2, 2, 4, 6, 2."""
    keep = data[C_SHIPDATE] <= np.datetime64("1998-09-02")
    f = data[C_RETURNFLAG][keep]
    s = data[C_LINESTATUS][keep]
    q = data[C_QUANTITY][keep]
    p = data[C_EXTENDEDPRICE][keep]
    d = data[C_DISCOUNT][keep]
    t = data[C_TAX][keep]
    out = {}
    for fi in range(3):
        for si in range(2):
            m = (f == fi) & (s == si)
            if not m.any():
                continue
            dp = p[m] * (100 - d[m])
            out[(RETURNFLAG[fi], LINESTATUS[si])] = (
                int(m.sum()), int(q[m].sum()), int(p[m].sum()),
                int(dp.sum()), int((dp * (100 + t[m])).sum()),
                int(d[m].sum()))
    return out


# ---------------------------------------------------------------------------
# the TPC-H sweep of the JAX package's bench (bench.py:1103 TPCH_SWEEP_SQLS)
# over this lineitem, as the planner pushes each shape to the cluster
# store: a columnar_hint aggregate, group columns as first_row
# ---------------------------------------------------------------------------

def hinted(sel: SelectRequest) -> SelectRequest:
    sel.columnar_hint = True
    return sel


def minmax_expr() -> SelectRequest:
    """select l_returnflag, min(l_extendedprice - l_discount),
    max(l_extendedprice + l_tax) group by l_returnflag."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_EXTENDEDPRICE, C_DISCOUNT, C_TAX,
                               C_RETURNFLAG]),
        group_by=[ByItem(c(C_RETURNFLAG))],
        aggregates=[
            expr_agg("min", [expr_op(Op.Minus, c(C_EXTENDEDPRICE),
                                     c(C_DISCOUNT))]),
            expr_agg("max", [expr_op(Op.Plus, c(C_EXTENDEDPRICE),
                                     c(C_TAX))]),
            expr_agg("first_row", [c(C_RETURNFLAG)])])


def float_expr() -> SelectRequest:
    """select l_returnflag, sum(l_fdiscount * 2), avg(l_fdiscount + 0.5)
    group by l_returnflag (float expression arguments)."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_FDISCOUNT, C_RETURNFLAG]),
        group_by=[ByItem(c(C_RETURNFLAG))],
        aggregates=[
            expr_agg("sum", [expr_op(Op.Mul, c(C_FDISCOUNT),
                                     expr_value(Datum.i64(2)))]),
            expr_agg("avg", [expr_op(Op.Plus, c(C_FDISCOUNT),
                                     expr_value(_dec("0.5")))]),
            expr_agg("first_row", [c(C_RETURNFLAG)])])


def dec_group() -> SelectRequest:
    """select l_quantity, count(*), sum(l_extendedprice) group by
    l_quantity (a decimal group key)."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_QUANTITY, C_EXTENDEDPRICE]),
        group_by=[ByItem(c(C_QUANTITY))],
        aggregates=[expr_agg("count", [expr_value(_one())]),
                    expr_agg("sum", [c(C_EXTENDEDPRICE)]),
                    expr_agg("first_row", [c(C_QUANTITY)])])


def date_group() -> SelectRequest:
    """select l_shipdate, count(*), sum(l_extendedprice * (1 -
    l_discount)) group by l_shipdate (a date group key)."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_EXTENDEDPRICE, C_DISCOUNT, C_SHIPDATE]),
        group_by=[ByItem(c(C_SHIPDATE))],
        aggregates=[
            expr_agg("count", [expr_value(_one())]),
            expr_agg("sum", [expr_op(Op.Mul, c(C_EXTENDEDPRICE),
                                     expr_op(Op.Minus, expr_value(_one()),
                                             c(C_DISCOUNT)))]),
            expr_agg("first_row", [c(C_SHIPDATE)])])


SWEEP = (("q1full", q1), ("q6", q6), ("minmax_expr", minmax_expr),
         ("float_expr", float_expr), ("dec_group", dec_group),
         ("date_group", date_group))


def sweep_request(name: str) -> SelectRequest:
    return hinted(dict(SWEEP)[name]())


def sweep_expected(name: str, data: dict) -> dict:
    """A sweep shape computed straight from the arrays with numpy: {group
    key: [aggregate values without the first_row columns]}, decimals as
    exact Decimals, floats as numpy's sums. Keys: the return flag (str),
    the quantity (Decimal), the ship date (datetime.date); () for q6."""
    d2 = lambda v, s=2: Decimal(int(v)).scaleb(-s)  # noqa: E731
    price, disc, tax = (data[C_EXTENDEDPRICE], data[C_DISCOUNT],
                        data[C_TAX])
    flag = data[C_RETURNFLAG]
    out = {}
    if name == "q1full":
        for (f, s), v in q1_expected(data).items():
            cnt, sq, sp, sdp, sch, sd = v
            out[(f.decode(), s.decode())] = [
                d2(sq), d2(sp), d2(sdp, 4), d2(sch, 6), d2(sq) / cnt,
                d2(sp) / cnt, d2(sd) / cnt, cnt]
    elif name == "q6":
        ship = data[C_SHIPDATE]
        m = ((ship >= np.datetime64("1994-01-01"))
             & (ship < np.datetime64("1995-01-01")) & (disc >= 5)
             & (disc <= 7) & (data[C_QUANTITY] < 2400))
        out[()] = [d2((price[m] * disc[m]).sum(), 4) if m.any() else None]
    elif name in ("minmax_expr", "float_expr"):
        for fi in range(3):
            m = flag == fi
            if not m.any():
                continue
            if name == "minmax_expr":
                vals = [d2((price[m] - disc[m]).min()),
                        d2((price[m] + tax[m]).max())]
            else:
                fd = data[C_FDISCOUNT][m]
                vals = [float((fd * 2).sum()),
                        float((fd + 0.5).sum() / m.sum())]
            out[RETURNFLAG[fi].decode()] = vals
    elif name in ("dec_group", "date_group"):
        key = data[C_QUANTITY] if name == "dec_group" else data[C_SHIPDATE]
        uniq, inv = np.unique(key, return_inverse=True)
        cnt = np.bincount(inv)
        if name == "dec_group":
            sums = np.zeros(len(uniq), np.int64)
            np.add.at(sums, inv, price)
            for u, c, s in zip(uniq.tolist(), cnt.tolist(), sums.tolist()):
                out[d2(u)] = [c, d2(s)]
        else:
            sums = np.zeros(len(uniq), np.int64)
            np.add.at(sums, inv, price * (100 - disc))
            for u, c, s in zip(uniq.astype(dt.date).tolist(), cnt.tolist(),
                               sums.tolist()):
                out[u] = [c, d2(s, 4)]
    else:
        raise KeyError(name)
    return out
