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
from tidb_tpu_torch.plan import AggFunc, Column, Constant, Join
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import Datum, Kind
from tidb_tpu_torch.types.field_type import field_type_from_pb_column
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
# order dates: [STARTDATE, ENDDATE - 151 days], in days since _EPOCH
_ORDERDATE_SPAN = int((np.datetime64("1998-12-31") - 151 - _EPOCH)
                      .astype(int))
# the key of a refreshed table's handles in a `generate` dict (absent:
# row i has the handle i + 1)
HANDLE = "handle"


def _column_info(spec: dict, cid: int) -> PBColumnInfo:
    c = spec[cid]
    return PBColumnInfo(column_id=cid, tp=c["tp"], flen=c["flen"],
                        decimal=c.get("decimal", -1))


def column_info(cid: int) -> PBColumnInfo:
    return _column_info(COLUMNS, cid)


def table_info(cids, table_id: int = TABLE_ID,
               spec: dict | None = None) -> PBTableInfo:
    spec = COLUMNS if spec is None else spec
    return PBTableInfo(table_id, [_column_info(spec, c) for c in cids])


def generate(n_rows: int, seed: int) -> dict:
    """Columns of `n_rows` lineitem rows as numpy arrays: integers,
    decimals as int64 cents, dates as numpy datetime64[D], strings as
    int64 indices into SHIPINSTRUCT / SHIPMODE / RETURNFLAG / LINESTATUS
    (comments as an index into a small phrase table). Row i has the
    handle i + 1."""
    rng = np.random.default_rng(seed)
    lines, order_idx, odate = _draw_orders(rng, n_rows)
    first = np.concatenate([[0], np.cumsum(lines)[:-1]])
    linenumber = np.arange(n_rows) - first[order_idx] + 1
    return _lines(rng, _order_keys(order_idx), linenumber, odate[order_idx],
                  n_rows)


def _lines(rng, orderkey: np.ndarray, linenumber: np.ndarray,
           orderdate: np.ndarray, table_rows: int) -> dict:
    """The lineitem columns of rows whose order key, line number and order
    date (days since 1992-01-01) are given, at the part and supplier
    ranges of a table of `table_rows` rows."""
    n_rows = orderkey.shape[0]
    n_parts, n_supp = _parts_suppliers(table_rows)
    partkey = rng.integers(1, n_parts + 1, n_rows)
    j = rng.integers(0, 4, n_rows)
    suppkey = _supplier(partkey, j, n_supp)
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


def _draw_orders(rng, n_rows: int) -> tuple:
    """The orders behind `n_rows` lineitem rows: lines per order (1-7,
    mean 4), each row's order, and each order's date (days since
    1992-01-01)."""
    n_orders = n_rows // 3 + 8
    lines = rng.integers(1, 8, n_orders)
    while lines.sum() < n_rows:
        lines = np.concatenate([lines, rng.integers(1, 8, n_orders)])
    order_idx = np.repeat(np.arange(lines.shape[0]), lines)[:n_rows]
    return lines, order_idx, rng.integers(0, _ORDERDATE_SPAN + 1,
                                          lines.shape[0])


def _order_keys(order_idx: np.ndarray) -> np.ndarray:
    """dbgen's sparse order keys: 8 used of every 32."""
    return (order_idx // 8) * 32 + order_idx % 8 + 1


def _parts_suppliers(n_rows: int) -> tuple:
    sf = n_rows / SF1_ROWS
    return max(int(200_000 * sf), 1), max(int(10_000 * sf), 1)


def _supplier(partkey: np.ndarray, j, n_supp: int) -> np.ndarray:
    """The j-th (0..3) supplier of a part: the bridge formula of §4.2.3."""
    return (partkey + j * (n_supp // 4 + (partkey - 1) // n_supp)) \
        % n_supp + 1


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


def handles_of(data: dict) -> np.ndarray:
    n = data[C_ORDERKEY].shape[0]
    h = data.get(HANDLE)
    return np.arange(1, n + 1, dtype=np.int64) if h is None else h


def kv_pairs(data: dict):
    """(row key, row value) of every row, encoded by the port's
    tablecodec — the rows a store of the table holds."""
    n = data[C_ORDERKEY].shape[0]
    handles = handles_of(data).tolist()
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
        yield (tc.encode_row_key(TABLE_ID, handles[i]),
               tc.encode_row(cids, [lists[cid][i] for cid in cids]))


def batch(data: dict, cids, lo: int = 0, hi: int | None = None
          ) -> col.ColumnBatch:
    """The packed ColumnBatch of the given columns over rows [lo, hi)
    (handles lo + 1 .. hi), built straight from the arrays (what
    pack_ranges yields for these rows)."""
    return table_batch(COLUMNS, data, cids, {
        C_RETURNFLAG: RETURNFLAG, C_LINESTATUS: LINESTATUS,
        C_SHIPINSTRUCT: SHIPINSTRUCT, C_SHIPMODE: SHIPMODE}, lo, hi)


def table_batch(spec: dict, data: dict, cids, words: dict, lo: int = 0,
                hi: int | None = None) -> col.ColumnBatch:
    """`batch` for any table: `spec` its columns' types by id, `data` its
    arrays (strings as indices into `words[cid]`)."""
    if hi is None:
        hi = next(iter(data.values())).shape[0]
    data = {cid: data[cid][lo:hi] for cid in cids}
    n = hi - lo
    cap = col.bucket_capacity(n)
    handles = np.full(cap, col.I64_MIN, dtype=np.int64)
    handles[:n] = np.arange(lo + 1, hi + 1)
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True
    cols = {}
    for cid in cids:
        c = spec[cid]
        kind = col.column_phys_kind(_column_info(spec, cid))
        raw = data[cid]
        if c["tp"] == my.TypeDate:
            raw = packed_dates(raw)
        vals = np.zeros(cap, dtype=np.int64)
        if kind == col.K_STR:
            # the sorted dictionary of the values present; codes index it
            words_ = words[cid]
            dictionary = sorted({words_[k] for k in np.unique(raw).tolist()})
            code_of = {w: i for i, w in enumerate(dictionary)}
            lut = np.array([code_of.get(w, -1) for w in words_],
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
    start, end = tc.encode_record_range(sel.table_info.table_id)
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


# ---------------------------------------------------------------------------
# TPC-H's refresh functions for lineitem (TPC-H v3 §2.5): the writes of
# the HTAP freshness tier
# ---------------------------------------------------------------------------

def refresh_orders(data: dict) -> int:
    """SF x 1500 (§2.5.2, §2.5.3): the orders one refresh function
    inserts or deletes, SF read from the table's rows."""
    return max(round(1500 * data[C_ORDERKEY].shape[0] / SF1_ROWS), 1)


def rf1(data: dict, seed: int) -> tuple[list, dict]:
    """RF1: SF x 1500 new orders' lineitems (1-7 each, the distributions
    of `generate`), their order keys following the table's largest in
    dbgen's sparse pattern, their handles above the table's (the auto row
    id TiDB gives a table without an integer primary key). Returns (the
    encoded (key, value) puts, the arrays after the insert)."""
    rng = np.random.default_rng(seed)
    n_orders = refresh_orders(data)
    lines = rng.integers(1, 8, n_orders)
    odate = rng.integers(0, _ORDERDATE_SPAN + 1, n_orders)
    order = np.repeat(np.arange(n_orders), lines)
    first = np.concatenate([[0], np.cumsum(lines)[:-1]])
    linenumber = np.arange(order.shape[0]) - first[order] + 1
    top = int(data[C_ORDERKEY].max()) - 1
    next_idx = (top // 32) * 8 + top % 32 + 1
    new = _lines(rng, _order_keys(next_idx + order), linenumber,
                 odate[order], data[C_ORDERKEY].shape[0])
    h0 = int(handles_of(data).max()) + 1
    new[HANDLE] = np.arange(h0, h0 + order.shape[0], dtype=np.int64)
    after = {k: np.concatenate([data[k], v]) for k, v in new.items()
             if k != HANDLE}
    after[HANDLE] = np.concatenate([handles_of(data), new[HANDLE]])
    return list(kv_pairs(new)), after


def rf2(data: dict, seed: int) -> tuple[list, dict]:
    """RF2: the lineitems of SF x 1500 existing orders, drawn with `seed`
    across the whole key range. Returns (the (key, None) deletes, the
    arrays after the delete)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(data[C_ORDERKEY])
    gone = rng.choice(keys, min(refresh_orders(data), keys.shape[0]),
                      replace=False)
    drop = np.isin(data[C_ORDERKEY], gone)
    handles = handles_of(data)
    muts = [(tc.encode_row_key(TABLE_ID, h), None)
            for h in handles[drop].tolist()]
    after = {k: v[~drop] for k, v in data.items()}
    after[HANDLE] = handles[~drop]
    return muts, after


# ---------------------------------------------------------------------------
# ranked group-by, DISTINCT aggregates and TopN over this lineitem, as the
# planner pushes each to the in-process coprocessor (group columns as
# first_row aggregates)
# ---------------------------------------------------------------------------

def _by_two_dates(second: int) -> SelectRequest:
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_QUANTITY, C_EXTENDEDPRICE, C_SHIPDATE,
                               second]),
        group_by=[ByItem(c(C_SHIPDATE)), ByItem(c(second))],
        aggregates=[expr_agg("count", [expr_value(_one())]),
                    expr_agg("sum", [c(C_QUANTITY)]),
                    expr_agg("avg", [c(C_EXTENDEDPRICE)]),
                    expr_agg("first_row", [c(C_SHIPDATE)]),
                    expr_agg("first_row", [c(second)])])


def ranked_dates() -> SelectRequest:
    """select l_shipdate, l_receiptdate, count(*), sum(l_quantity),
    avg(l_extendedprice) group by l_shipdate, l_receiptdate: a radix cross
    product of about 2.5k x 2.5k dates, beyond RADIX_MAX_SEGMENTS, so the
    group-by is ranked."""
    return _by_two_dates(C_RECEIPTDATE)


def tuple_dates() -> SelectRequest:
    """The same over (l_shipdate, l_commitdate), whose groups (about 430k
    at SF1) overflow every rung of the rank ladder: host tuple codes."""
    return _by_two_dates(C_COMMITDATE)


def _in_1994():
    c = expr_column
    return expr_op(Op.AndAnd,
                   expr_op(Op.GE, c(C_SHIPDATE),
                           expr_value(Datum.string("1994-01-01"))),
                   expr_op(Op.LT, c(C_SHIPDATE),
                           expr_value(Datum.string("1995-01-01"))))


def scalar_distinct() -> SelectRequest:
    """select count(distinct l_suppkey), count(distinct l_orderkey),
    sum(distinct l_quantity), avg(distinct l_discount) where l_shipdate
    in 1994."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_ORDERKEY, C_SUPPKEY, C_QUANTITY,
                               C_DISCOUNT, C_SHIPDATE]),
        where=_in_1994(),
        aggregates=[expr_agg("count", [c(C_SUPPKEY)], distinct=True),
                    expr_agg("count", [c(C_ORDERKEY)], distinct=True),
                    expr_agg("sum", [c(C_QUANTITY)], distinct=True),
                    expr_agg("avg", [c(C_DISCOUNT)], distinct=True)])


def grouped_distinct() -> SelectRequest:
    """select l_returnflag, l_linestatus, count(distinct l_orderkey),
    count(*) group by l_returnflag, l_linestatus."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_ORDERKEY, C_RETURNFLAG, C_LINESTATUS]),
        group_by=[ByItem(c(C_RETURNFLAG)), ByItem(c(C_LINESTATUS))],
        aggregates=[expr_agg("count", [c(C_ORDERKEY)], distinct=True),
                    expr_agg("count", [expr_value(_one())]),
                    expr_agg("first_row", [c(C_RETURNFLAG)]),
                    expr_agg("first_row", [c(C_LINESTATUS)])])


def topn_price() -> SelectRequest:
    """select l_orderkey, l_extendedprice where l_shipdate > '1995-03-15'
    order by l_extendedprice desc limit 10."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_ORDERKEY, C_EXTENDEDPRICE, C_SHIPDATE]),
        where=expr_op(Op.GT, c(C_SHIPDATE),
                      expr_value(Datum.string("1995-03-15"))),
        order_by=[ByItem(c(C_EXTENDEDPRICE), desc=True)], limit=10)


def topn_multi(limit: int = 100) -> SelectRequest:
    """select l_orderkey, l_linenumber where l_shipmode in ('MAIL',
    'SHIP') order by l_receiptdate desc, l_extendedprice, l_orderkey
    limit `limit`."""
    c = expr_column
    return SelectRequest(
        start_ts=1,
        table_info=table_info([C_ORDERKEY, C_LINENUMBER, C_EXTENDEDPRICE,
                               C_RECEIPTDATE, C_SHIPMODE]),
        where=_in(c(C_SHIPMODE), [b"MAIL", b"SHIP"]),
        order_by=[ByItem(c(C_RECEIPTDATE), desc=True),
                  ByItem(c(C_EXTENDEDPRICE)), ByItem(c(C_ORDERKEY))],
        limit=limit)


SLICE3 = (("ranked_dates", ranked_dates), ("tuple_dates", tuple_dates),
          ("scalar_distinct", scalar_distinct),
          ("grouped_distinct", grouped_distinct),
          ("topn_price", topn_price), ("topn_multi", topn_multi),
          ("topn_multi_5000", lambda: topn_multi(5000)))


def slice3_expected(name: str, data: dict):
    """A slice-3 statement computed straight from the arrays with numpy.
    Grouped shapes: {group key: [values]} (dates as datetime.date, flags
    as bytes; counts, and decimals as int64 cents). scalar_distinct: the
    four distinct totals [count, count, (count, cents), (count, cents)].
    TopN shapes: the row handles in order."""
    n = data[C_ORDERKEY].shape[0]
    rows = np.arange(n)
    if name in ("ranked_dates", "tuple_dates"):
        second = C_RECEIPTDATE if name == "ranked_dates" else C_COMMITDATE
        a = (data[C_SHIPDATE] - _EPOCH).astype(np.int64)
        b = (data[second] - _EPOCH).astype(np.int64)
        key = a * (1 << 20) + b
        uniq, inv = np.unique(key, return_inverse=True)
        cnt = np.bincount(inv)
        order = np.argsort(inv, kind="stable")
        starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        sq = np.add.reduceat(data[C_QUANTITY][order], starts)
        sp = np.add.reduceat(data[C_EXTENDEDPRICE][order], starts)
        da = (_EPOCH + (uniq >> 20).astype("timedelta64[D]")).astype(dt.date)
        db = (_EPOCH + (uniq & ((1 << 20) - 1)).astype("timedelta64[D]")) \
            .astype(dt.date)
        return {(x, y): [c_, q, p] for x, y, c_, q, p in zip(
            da.tolist(), db.tolist(), cnt.tolist(), sq.tolist(),
            sp.tolist())}
    if name == "scalar_distinct":
        ship = data[C_SHIPDATE]
        m = (ship >= np.datetime64("1994-01-01")) \
            & (ship < np.datetime64("1995-01-01"))
        q = np.unique(data[C_QUANTITY][m])
        d = np.unique(data[C_DISCOUNT][m])
        return [len(np.unique(data[C_SUPPKEY][m])),
                len(np.unique(data[C_ORDERKEY][m])),
                (len(q), int(q.sum())), (len(d), int(d.sum()))]
    if name == "grouped_distinct":
        out = {}
        for fi in range(3):
            for si in range(2):
                m = (data[C_RETURNFLAG] == fi) & (data[C_LINESTATUS] == si)
                if m.any():
                    out[(RETURNFLAG[fi], LINESTATUS[si])] = [
                        len(np.unique(data[C_ORDERKEY][m])), int(m.sum())]
        return out
    if name == "topn_price":
        cand = rows[data[C_SHIPDATE] > np.datetime64("1995-03-15")]
        order = np.lexsort([cand, -data[C_EXTENDEDPRICE][cand]])
        return (cand[order][:10] + 1).tolist()
    if name in ("topn_multi", "topn_multi_5000"):
        limit = 100 if name == "topn_multi" else 5000
        mode = data[C_SHIPMODE]
        cand = rows[(mode == SHIPMODE.index(b"MAIL"))
                    | (mode == SHIPMODE.index(b"SHIP"))]
        receipt = (data[C_RECEIPTDATE][cand] - _EPOCH).astype(np.int64)
        order = np.lexsort([cand, data[C_ORDERKEY][cand],
                            data[C_EXTENDEDPRICE][cand], -receipt])
        return (cand[order][:limit] + 1).tolist()
    raise KeyError(name)


# ---------------------------------------------------------------------------
# orders, partsupp and a priority dimension, consistent with `generate`'s
# lineitem, and the join statements over them (TPC-H v3 §1.4 types):
#   orders (o_orderkey bigint, o_custkey bigint, o_orderstatus char(1),
#     o_totalprice decimal(15,2), o_orderdate date,
#     o_orderpriority char(15), o_shippriority int)
#   partsupp (ps_partkey bigint, ps_suppkey bigint, ps_availqty int,
#     ps_supplycost decimal(15,2))
#   prio (pd_name char(15), pd_rank int): four of the five priorities
# ---------------------------------------------------------------------------

ORDERS_ID, PARTSUPP_ID, PRIO_ID = 101, 102, 103
O_ORDERKEY, O_CUSTKEY, O_ORDERSTATUS, O_TOTALPRICE = 1, 2, 3, 4
O_ORDERDATE, O_ORDERPRIORITY, O_SHIPPRIORITY = 5, 6, 7
PS_PARTKEY, PS_SUPPKEY, PS_AVAILQTY, PS_SUPPLYCOST = 1, 2, 3, 4
PD_NAME, PD_RANK = 1, 2

_BIGINT = dict(tp=my.TypeLonglong, flen=20)
_INT = dict(tp=my.TypeLong, flen=11)
ORDER_COLUMNS = {
    O_ORDERKEY: _BIGINT, O_CUSTKEY: _BIGINT,
    O_ORDERSTATUS: dict(tp=my.TypeString, flen=1), O_TOTALPRICE: _DEC,
    O_ORDERDATE: dict(tp=my.TypeDate, flen=10),
    O_ORDERPRIORITY: dict(tp=my.TypeString, flen=15), O_SHIPPRIORITY: _INT,
}
PARTSUPP_COLUMNS = {PS_PARTKEY: _BIGINT, PS_SUPPKEY: _BIGINT,
                    PS_AVAILQTY: _INT, PS_SUPPLYCOST: _DEC}
PRIO_COLUMNS = {PD_NAME: dict(tp=my.TypeString, flen=15), PD_RANK: _INT}

ORDERPRIORITY = [b"1-URGENT", b"2-HIGH", b"3-MEDIUM", b"4-NOT SPECIFIED",
                 b"5-LOW"]
ORDERSTATUS = [b"F", b"O", b"P"]
PRIO_NAMES = ORDERPRIORITY[:4]     # 5-LOW pads under a LEFT OUTER join


def orders(data: dict, seed: int) -> dict:
    """One row per order that `generate(n, seed)` gave `data`'s lineitem
    rows: the same sparse keys and order dates; o_orderstatus from the
    lines' statuses (F all shipped, O none, P some); o_totalprice the sum
    of extendedprice * (1 + tax) * (1 - discount) over the lines, in
    cents rounded half up; o_custkey (never a multiple of 3) and
    o_orderpriority drawn from a second stream of the seed;
    o_shippriority 0."""
    n_rows = data[C_ORDERKEY].shape[0]
    _lines, order_idx, odate = _draw_orders(np.random.default_rng(seed),
                                            n_rows)
    n = int(order_idx[-1]) + 1 if n_rows else 0
    starts = np.flatnonzero(np.r_[True, order_idx[1:] != order_idx[:-1]])
    status = data[C_LINESTATUS]
    lo = np.minimum.reduceat(status, starts)
    hi = np.maximum.reduceat(status, starts)
    line_price = (data[C_EXTENDEDPRICE] * (100 + data[C_TAX])
                  * (100 - data[C_DISCOUNT]) + 5000) // 10000
    rng = np.random.default_rng([seed, 2])
    n_cust = max(int(150_000 * n_rows / SF1_ROWS), 3)
    c = rng.integers(0, 2 * (n_cust // 3), n)
    return {
        O_ORDERKEY: _order_keys(np.arange(n)).astype(np.int64),
        O_CUSTKEY: (3 * (c // 2) + 1 + c % 2).astype(np.int64),
        O_ORDERSTATUS: np.where(hi == 0, 0, np.where(lo == 1, 1, 2))
        .astype(np.int64),
        O_TOTALPRICE: np.add.reduceat(line_price, starts).astype(np.int64),
        O_ORDERDATE: _EPOCH + odate[:n].astype("timedelta64[D]"),
        O_ORDERPRIORITY: rng.integers(0, 5, n).astype(np.int64),
        O_SHIPPRIORITY: np.zeros(n, np.int64),
    }


def partsupp(n_rows: int, seed: int) -> dict:
    """Four rows per part of `generate(n_rows, ...)`'s part range, the
    suppliers j = 0..3 of the bridge formula that draws l_suppkey."""
    n_parts, n_supp = _parts_suppliers(n_rows)
    part = np.repeat(np.arange(1, n_parts + 1, dtype=np.int64), 4)
    j = np.tile(np.arange(4, dtype=np.int64), n_parts)
    rng = np.random.default_rng([seed, 3])
    return {PS_PARTKEY: part,
            PS_SUPPKEY: _supplier(part, j, n_supp).astype(np.int64),
            PS_AVAILQTY: rng.integers(1, 10_000, 4 * n_parts)
            .astype(np.int64),
            PS_SUPPLYCOST: rng.integers(100, 100_001, 4 * n_parts)
            .astype(np.int64)}


def prio() -> dict:
    return {PD_NAME: np.arange(4, dtype=np.int64),
            PD_RANK: np.arange(1, 5, dtype=np.int64)}


# table id → (columns by id, words of its string columns)
JOIN_TABLES = {
    TABLE_ID: (COLUMNS, {C_RETURNFLAG: RETURNFLAG, C_LINESTATUS: LINESTATUS,
                         C_SHIPINSTRUCT: SHIPINSTRUCT, C_SHIPMODE: SHIPMODE}),
    ORDERS_ID: (ORDER_COLUMNS, {O_ORDERSTATUS: ORDERSTATUS,
                                O_ORDERPRIORITY: ORDERPRIORITY}),
    PARTSUPP_ID: (PARTSUPP_COLUMNS, {}),
    PRIO_ID: (PRIO_COLUMNS, {PD_NAME: PRIO_NAMES}),
}


def join_data(data: dict, seed: int) -> dict:
    """{table id: arrays} of the four tables the join statements read,
    `data` being generate(n, seed)."""
    n = data[C_ORDERKEY].shape[0]
    return {TABLE_ID: data, ORDERS_ID: orders(data, seed),
            PARTSUPP_ID: partsupp(n, seed), PRIO_ID: prio()}


def join_batch(tables: dict, table_id: int, cids=None) -> col.ColumnBatch:
    """The batch of one table of `join_data`, of `cids` (default: every
    column; lineitem's comment has no word list, so pass its columns)."""
    spec, words = JOIN_TABLES[table_id]
    return table_batch(spec, tables[table_id],
                       sorted(spec) if cids is None else cids, words)


def scan_request(table_id: int, cids, where=None) -> SelectRequest:
    """A plain scan of `cids` of one of JOIN_TABLES' tables."""
    spec, _w = JOIN_TABLES[table_id]
    return SelectRequest(start_ts=1,
                         table_info=table_info(cids, table_id, spec),
                         where=where)


def column(table_id: int, cid: int, index: int) -> Column:
    """Output column `index` of a scan or join, typed as column `cid` of
    one of JOIN_TABLES' tables."""
    spec, _w = JOIN_TABLES[table_id]
    return Column(index, field_type_from_pb_column(_column_info(spec, cid)))


def join_statement(name: str) -> tuple:
    """(left scan, right scan, plan.Join, aggregate functions, group-by)
    of a join statement as the planner builds it:
    f1_q3_join   select o_orderpriority, count(*), sum(l_fdiscount),
                 min(l_suppkey), max(o_custkey) from lineitem join orders
                 on l_orderkey = o_orderkey where l_shipdate >
                 '1995-03-15' and o_orderdate < '1995-03-15' group by
                 o_orderpriority (TPC-H Q3's join and dates);
    f2_partsupp  select count(*), sum(ps_availqty), max(ps_availqty),
                 min(l_orderkey) from lineitem join partsupp on
                 l_partkey = ps_partkey and l_suppkey = ps_suppkey (Q9's
                 key pair);
    f3_prio_outer select pd_rank, count(*), count(pd_rank),
                 max(o_orderkey) from orders left join prio on
                 o_orderpriority = pd_name group by pd_rank."""
    one = [Constant(Datum.i64(1))]
    c = expr_column
    if name == "f1_q3_join":
        left = scan_request(TABLE_ID, [C_ORDERKEY, C_SUPPKEY, C_FDISCOUNT,
                                       C_SHIPDATE],
                            expr_op(Op.GT, c(C_SHIPDATE),
                                    expr_value(_date("1995-03-15"))))
        right = scan_request(ORDERS_ID, [O_ORDERKEY, O_ORDERDATE, O_CUSTKEY,
                                         O_ORDERPRIORITY],
                             expr_op(Op.LT, c(O_ORDERDATE),
                                     expr_value(_date("1995-03-15"))))
        join = Join(Join.INNER)
        join.eq_conditions = [(column(TABLE_ID, C_ORDERKEY, 0),
                               column(ORDERS_ID, O_ORDERKEY, 0))]
        aggs = [AggFunc("count", one), AggFunc("sum", [Column(2)]),
                AggFunc("min", [Column(1)]), AggFunc("max", [Column(6)]),
                AggFunc("first_row", [Column(7)])]
        return left, right, join, aggs, [column(ORDERS_ID, O_ORDERPRIORITY,
                                                7)]
    if name == "f2_partsupp":
        left = scan_request(TABLE_ID, [C_ORDERKEY, C_PARTKEY, C_SUPPKEY])
        right = scan_request(PARTSUPP_ID, [PS_PARTKEY, PS_SUPPKEY,
                                           PS_AVAILQTY, PS_SUPPLYCOST])
        join = Join(Join.INNER)
        join.eq_conditions = [
            (column(TABLE_ID, C_PARTKEY, 1),
             column(PARTSUPP_ID, PS_PARTKEY, 0)),
            (column(TABLE_ID, C_SUPPKEY, 2),
             column(PARTSUPP_ID, PS_SUPPKEY, 1))]
        aggs = [AggFunc("count", one), AggFunc("sum", [Column(5)]),
                AggFunc("max", [Column(5)]), AggFunc("min", [Column(0)])]
        return left, right, join, aggs, []
    if name == "f3_prio_outer":
        left = scan_request(ORDERS_ID, [O_ORDERKEY, O_ORDERPRIORITY])
        right = scan_request(PRIO_ID, [PD_NAME, PD_RANK])
        join = Join(Join.LEFT_OUTER)
        join.eq_conditions = [(column(ORDERS_ID, O_ORDERPRIORITY, 1),
                               column(PRIO_ID, PD_NAME, 0))]
        aggs = [AggFunc("count", one), AggFunc("count", [Column(3)]),
                AggFunc("max", [Column(0)]), AggFunc("first_row", [Column(3)])]
        return left, right, join, aggs, [column(PRIO_ID, PD_RANK, 3)]
    raise KeyError(name)


JOINS = ("f1_q3_join", "f2_partsupp", "f3_prio_outer")


def _first_appearance(keys: np.ndarray) -> tuple:
    """(group id per row, rows' groups in first-appearance order)."""
    _u, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], len(order)


def join_expected(name: str, tables: dict) -> list:
    """A join statement's result rows computed straight from the arrays
    with numpy, groups in first-appearance order: python ints, floats,
    Decimals (int sums), bytes (strings) and None (NULL)."""
    data, od = tables[TABLE_ID], tables[ORDERS_ID]
    if name == "f1_q3_join":
        cut = np.datetime64("1995-03-15")
        rows = np.flatnonzero(data[C_SHIPDATE] > cut)
        order = np.searchsorted(od[O_ORDERKEY], data[C_ORDERKEY][rows])
        keep = od[O_ORDERDATE][order] < cut
        rows, order = rows[keep], order[keep]
        gid, G = _first_appearance(od[O_ORDERPRIORITY][order])
        cnt = np.bincount(gid, minlength=G)
        fsum = np.zeros(G)
        np.add.at(fsum, gid, data[C_FDISCOUNT][rows])
        mn = np.full(G, col.I64_MAX)
        np.minimum.at(mn, gid, data[C_SUPPKEY][rows])
        mx = np.full(G, -1)
        np.maximum.at(mx, gid, od[O_CUSTKEY][order])
        prio_ = np.zeros(G, np.int64)
        prio_[gid] = od[O_ORDERPRIORITY][order]
        return [[int(cnt[g]), float(fsum[g]), int(mn[g]), int(mx[g]),
                 ORDERPRIORITY[prio_[g]]] for g in range(G)]
    if name == "f2_partsupp":
        ps = tables[PARTSUPP_ID]
        m = int(max(data[C_SUPPKEY].max(), ps[PS_SUPPKEY].max())) + 1
        lk = data[C_PARTKEY] * m + data[C_SUPPKEY]
        rk = ps[PS_PARTKEY] * m + ps[PS_SUPPKEY]
        order = np.argsort(rk, kind="stable")
        lo = np.searchsorted(rk[order], lk)
        cnt = np.searchsorted(rk[order], lk, side="right") - lo
        li = np.repeat(np.arange(len(lk)), cnt)
        within = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        avail = ps[PS_AVAILQTY][order[lo[li] + within]]
        return [[len(li), Decimal(int(avail.sum())), int(avail.max()),
                 int(data[C_ORDERKEY][li].min())]]
    if name == "f3_prio_outer":
        rank = np.array([1, 2, 3, 4, -1])[od[O_ORDERPRIORITY]]
        gid, G = _first_appearance(rank)
        cnt = np.bincount(gid, minlength=G)
        nonnull = np.bincount(gid[rank >= 0], minlength=G)
        mx = np.full(G, -1)
        np.maximum.at(mx, gid, od[O_ORDERKEY])
        first = np.zeros(G, np.int64)
        first[gid] = rank
        return [[int(cnt[g]), int(nonnull[g]), int(mx[g]),
                 None if first[g] < 0 else int(first[g])] for g in range(G)]
    raise KeyError(name)



# ---------------------------------------------------------------------------
# supplier at SF1 and the micro-batch tier's statements (chip_smoke.py
# Phase G)
# ---------------------------------------------------------------------------

SUPPLIER_ID = 104
SF1_SUPPLIERS = 10_000          # TPC-H §4.2.5: SF * 10,000
S_SUPPKEY, S_NAME, S_ADDRESS, S_NATIONKEY = 1, 2, 3, 4
S_PHONE, S_ACCTBAL, S_COMMENT = 5, 6, 7
SUPPLIER_COLUMNS = {
    S_SUPPKEY: _BIGINT, S_NAME: dict(tp=my.TypeString, flen=25),
    S_ADDRESS: dict(tp=my.TypeVarchar, flen=40), S_NATIONKEY: _BIGINT,
    S_PHONE: dict(tp=my.TypeString, flen=15), S_ACCTBAL: _DEC,
    S_COMMENT: dict(tp=my.TypeVarchar, flen=101),
}
_SUPPLIER_TEXT = (S_NAME, S_ADDRESS, S_PHONE, S_COMMENT)
_ALNUM = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz"
                       b"ABCDEFGHIJKLMNOPQRSTUVWXYZ ,", dtype=np.uint8)


def supplier(n_rows: int, seed: int) -> tuple:
    """(arrays, words) of `n_rows` supplier rows after TPC-H §4.2.3:
    s_suppkey 1..n (also the handle); s_name "Supplier#%09d"; s_address a
    random string of 10 to 40 characters; s_nationkey uniform 0..24;
    s_phone "CC-XXX-XXX-XXXX" with CC = nationkey + 10 (§4.2.2.9);
    s_acctbal uniform over [-999.99, 9,999.99] (int64 cents); s_comment
    25 to 100 characters of words. Strings are indices into words[cid]
    (every row its own string), drawn from numpy with `seed`."""
    rng = np.random.default_rng([seed, 4])
    keys = np.arange(1, n_rows + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n_rows).astype(np.int64)
    local = rng.integers([100, 100, 1000], [1000, 1000, 10_000],
                         (n_rows, 3))
    alen = rng.integers(10, 41, n_rows)
    chars = _ALNUM[rng.integers(0, len(_ALNUM), (n_rows, 40))]
    clen = rng.integers(25, 101, n_rows)
    wds = rng.integers(0, len(_WORDS), (n_rows, 20))
    words = {
        S_NAME: [b"Supplier#%09d" % k for k in keys.tolist()],
        S_ADDRESS: [chars[i, :alen[i]].tobytes() for i in range(n_rows)],
        S_PHONE: [b"%d-%d-%d-%d" % (nation[i] + 10, *local[i])
                  for i in range(n_rows)],
        S_COMMENT: [b" ".join(_WORDS[w] for w in wds[i])[:clen[i]]
                    for i in range(n_rows)],
    }
    data = {S_SUPPKEY: keys, S_NATIONKEY: nation,
            S_ACCTBAL: rng.integers(-99_999, 1_000_000, n_rows)
            .astype(np.int64)}
    for cid in _SUPPLIER_TEXT:
        data[cid] = np.arange(n_rows, dtype=np.int64)
    return data, words


def supplier_pairs(data: dict, words: dict):
    """(row key, row value) of every supplier row."""
    cids = sorted(SUPPLIER_COLUMNS)
    n = data[S_SUPPKEY].shape[0]
    lists = {S_SUPPKEY: [Datum.i64(v) for v in data[S_SUPPKEY].tolist()],
             S_NATIONKEY: [Datum.i64(v)
                           for v in data[S_NATIONKEY].tolist()],
             S_ACCTBAL: [Datum.dec(Decimal(v).scaleb(-2))
                         for v in data[S_ACCTBAL].tolist()]}
    for cid in _SUPPLIER_TEXT:
        w = words[cid]
        lists[cid] = [Datum.bytes_(w[i]) for i in data[cid].tolist()]
    for i in range(n):
        yield (tc.encode_row_key(SUPPLIER_ID, i + 1),
               tc.encode_row(cids, [lists[cid][i] for cid in cids]))


# the five shapes of Phase G, with the columns each scan reads:
# g_nation     select s_suppkey, s_name from supplier where s_nationkey = n
# g_acctbal    select s_suppkey, s_acctbal from supplier
#              where s_acctbal > x limit 10
# g_name       select s_suppkey, s_name, s_phone from supplier
#              where s_name = 'Supplier#...'  (absent names included)
# g_agg        select count(*), sum(s_acctbal), min(s_acctbal),
#              max(s_acctbal) from supplier where s_nationkey = n
# g_topn       select s_suppkey, s_acctbal from supplier where
#              s_nationkey = n order by s_acctbal desc, s_suppkey limit 100
#              (TPC-H Q2's ordering)
G_SHAPES = ("g_nation", "g_acctbal", "g_name", "g_agg", "g_topn")
_G_COLUMNS = {"g_nation": [S_SUPPKEY, S_NAME, S_NATIONKEY],
              "g_acctbal": [S_SUPPKEY, S_ACCTBAL],
              "g_name": [S_SUPPKEY, S_NAME, S_PHONE],
              "g_agg": [S_NATIONKEY, S_ACCTBAL],
              "g_topn": [S_SUPPKEY, S_NATIONKEY, S_ACCTBAL]}


def g_literal(shape: str, rng: np.random.Generator):
    """A literal for one statement of `shape`: a nation key, an account
    balance in cents, or a supplier number (up to 5 % beyond the table)."""
    if shape == "g_acctbal":
        return int(rng.integers(500_000, 1_000_000))
    if shape == "g_name":
        return int(rng.integers(1, SF1_SUPPLIERS * 21 // 20 + 1))
    return int(rng.integers(0, 25))


def g_statement(shape: str, lit: int) -> kv.Request:
    c = expr_column
    ti = table_info(_G_COLUMNS[shape], SUPPLIER_ID, SUPPLIER_COLUMNS)
    sel = SelectRequest(start_ts=1, table_info=ti)
    if shape == "g_acctbal":
        sel.where = expr_op(Op.GT, c(S_ACCTBAL), expr_value(
            Datum.dec(Decimal(lit).scaleb(-2))))
        sel.limit = 10
    elif shape == "g_name":
        sel.where = expr_op(Op.EQ, c(S_NAME), expr_value(
            Datum.bytes_(b"Supplier#%09d" % lit)))
    else:
        sel.where = expr_op(Op.EQ, c(S_NATIONKEY),
                            expr_value(Datum.i64(lit)))
    if shape == "g_agg":
        sel.aggregates = [expr_agg("count", [expr_value(_one())]),
                          expr_agg("sum", [c(S_ACCTBAL)]),
                          expr_agg("min", [c(S_ACCTBAL)]),
                          expr_agg("max", [c(S_ACCTBAL)])]
    elif shape == "g_topn":
        sel.order_by = [ByItem(c(S_ACCTBAL), True),
                        ByItem(c(S_SUPPKEY), False)]
        sel.limit = 100
    return store_request(sel)


def g_expected(shape: str, lit: int, data: dict, words: dict) -> list:
    """The statement's response rows from numpy: [(handle, [values])] with
    python ints, Decimals and bytes; an aggregate's one partial row (handle
    0, an empty group key first)."""
    nation, bal = data[S_NATIONKEY], data[S_ACCTBAL]
    if shape == "g_agg":
        v = bal[nation == lit]
        dec = [Decimal(int(x)).scaleb(-2) for x in (v.sum(), v.min(),
                                                    v.max())]
        return [(0, [b"", len(v), *dec])]
    if shape == "g_acctbal":
        rows = np.flatnonzero(bal > lit)[:10]
    elif shape == "g_name":
        rows = np.flatnonzero(data[S_SUPPKEY] == lit)
    elif shape == "g_topn":
        rows = np.flatnonzero(nation == lit)
        rows = rows[np.lexsort((data[S_SUPPKEY][rows], -bal[rows]))][:100]
    else:
        rows = np.flatnonzero(nation == lit)
    out = []
    for r in rows.tolist():
        vals = []
        for cid in _G_COLUMNS[shape]:
            if cid in _SUPPLIER_TEXT:
                vals.append(words[cid][data[cid][r]])
            elif cid == S_ACCTBAL:
                vals.append(Decimal(int(bal[r])).scaleb(-2))
            else:
                vals.append(int(data[cid][r]))
        out.append((r + 1, vals))
    return out
