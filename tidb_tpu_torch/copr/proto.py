"""The pushdown wire IR: SelectRequest / SelectResponse / Expr (copy of
tidb_tpu/copr/proto.py). The in-process client answers chunks of partial
rows; a region of the cluster store answers a pushed-down aggregate with
a columnar payload of partial states (`SelectResponse.columnar`)."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from tidb_tpu_torch.codec import codec
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import Datum


class ExprType(enum.IntEnum):
    """Mirrors tipb.ExprType's shape: value leaves, column ref, operators by
    Op code, named control/string funcs, aggregates."""
    # leaves
    NULL = 0
    VALUE = 1         # any literal; datum in Expr.val
    COLUMN_REF = 2    # column id in Expr.val (int datum)
    # composite
    OPERATOR = 10     # Expr.op holds the opcode; 1-2 children
    LIKE = 20         # children: [target, pattern]; val: escape str
    NOT_LIKE = 21
    IN = 22           # children: [target, item...]
    NOT_IN = 23
    IS_NULL = 24
    IS_NOT_NULL = 25
    IF = 30
    IFNULL = 31
    NULLIF = 32
    COALESCE = 33
    CASE = 34
    SCALAR_FUNC = 40  # generic builtin; name in Expr.val
    # aggregates (tipb ExprType 3001-3008 family)
    AGG_COUNT = 3001
    AGG_SUM = 3002
    AGG_AVG = 3003
    AGG_MIN = 3004
    AGG_MAX = 3005
    AGG_FIRST = 3006
    AGG_GROUP_CONCAT = 3007
    AGG_DISTINCT = 3010


AGG_NAME = {
    ExprType.AGG_COUNT: "count", ExprType.AGG_SUM: "sum",
    ExprType.AGG_AVG: "avg", ExprType.AGG_MIN: "min",
    ExprType.AGG_MAX: "max", ExprType.AGG_FIRST: "first_row",
    ExprType.AGG_GROUP_CONCAT: "group_concat",
}
AGG_TYPE_BY_NAME = {v: k for k, v in AGG_NAME.items()}

# aggregates whose EXPRESSION arguments ops.exprc.compile_arg_plane can
# lower into the states pass, and the arithmetic grammar it takes
ARG_PLANE_AGGS = ("count", "sum", "avg", "min", "max")

_ARG_PLANE_BINOPS = (Op.Plus, Op.Minus, Op.Mul, Op.Div, Op.IntDiv, Op.Mod)
_ARG_PLANE_UNOPS = (Op.UnaryMinus, Op.UnaryPlus)


def arg_plane_shape_ok(name: str, e: "Expr") -> bool:
    """Structural gate for EXPRESSION aggregate arguments: arithmetic over
    column refs / constants, reduced by a plane-expressible aggregate. The
    contextual rules (kinds, bounds) need the packed batch and run in
    exprc.compile_arg_plane."""
    if name not in ARG_PLANE_AGGS:
        return False
    if e.tp in (ExprType.VALUE, ExprType.COLUMN_REF):
        return True
    if e.tp != ExprType.OPERATOR or not e.children:
        return False
    if len(e.children) == 1:
        ok = e.op in _ARG_PLANE_UNOPS
    elif len(e.children) == 2:
        ok = e.op in _ARG_PLANE_BINOPS
    else:
        ok = False
    return ok and all(arg_plane_shape_ok(name, c) for c in e.children)


@dataclass
class Expr:
    tp: ExprType
    val: Datum | int | str | None = None
    op: Op | None = None
    children: list["Expr"] = field(default_factory=list)
    distinct: bool = False  # aggregates only

    def __repr__(self):
        if self.tp == ExprType.VALUE:
            return repr(self.val)
        if self.tp == ExprType.COLUMN_REF:
            return f"col#{self.val}"
        if self.tp == ExprType.OPERATOR:
            if len(self.children) == 2:
                return f"({self.children[0]!r} {self.op.sql()} {self.children[1]!r})"
            return f"({self.op.sql()} {self.children[0]!r})"
        name = AGG_NAME.get(self.tp) or (self.val if self.tp == ExprType.SCALAR_FUNC
                                         else self.tp.name.lower())
        d = "distinct " if self.distinct else ""
        return f"{name}({d}{', '.join(map(repr, self.children))})"


def expr_value(d: Datum) -> Expr:
    return Expr(ExprType.VALUE, val=d)


def expr_column(col_id: int) -> Expr:
    return Expr(ExprType.COLUMN_REF, val=col_id)


def expr_op(op: Op, *children: Expr) -> Expr:
    return Expr(ExprType.OPERATOR, op=op, children=list(children))


def expr_agg(name: str, children: list[Expr], distinct: bool = False) -> Expr:
    return Expr(AGG_TYPE_BY_NAME[name], children=children, distinct=distinct)


@dataclass
class PBColumnInfo:
    """tipb.ColumnInfo — column metadata the coprocessor needs to decode and
    type rows."""
    column_id: int
    tp: int
    flag: int = 0
    flen: int = -1
    decimal: int = -1
    pk_handle: bool = False    # this column IS the integer handle
    elems: list[str] = field(default_factory=list)
    # value for rows written before this column existed
    default_val: Datum | None = None


@dataclass
class PBTableInfo:
    table_id: int
    columns: list[PBColumnInfo]


@dataclass
class ByItem:
    expr: Expr
    desc: bool = False


@dataclass
class SelectRequest:
    """tipb.SelectRequest. The port serves table scans (`table_info`);
    an index request (`index_info`) raises Unsupported. `columnar_hint`
    asks a region of the cluster store for a columnar payload."""
    start_ts: int
    table_info: PBTableInfo | None = None
    index_info: object | None = None
    where: Expr | None = None
    group_by: list[ByItem] = field(default_factory=list)
    having: Expr | None = None
    order_by: list[ByItem] = field(default_factory=list)
    limit: int | None = None
    aggregates: list[Expr] = field(default_factory=list)
    desc: bool = False                    # scan direction
    time_zone_offset: int = 0
    flags: int = 0
    est_rows: float | None = None
    columnar_hint: bool = False

    def is_agg(self) -> bool:
        return bool(self.aggregates) or bool(self.group_by)


@dataclass
class RowMeta:
    handle: int
    length: int


@dataclass
class Chunk:
    """tipb.Chunk: rows packed as codec-encoded bytes + per-row meta."""
    rows_data: bytes = b""
    rows_meta: list[RowMeta] = field(default_factory=list)


@dataclass
class SelectResponse:
    chunks: list[Chunk] = field(default_factory=list)
    error: str | None = None
    # a columnar payload: a region's ops.columnar.ColumnarAggStates, or a
    # scan's ColumnarScanResult
    columnar: object | None = None

    def row_count(self) -> int:
        if hasattr(self.columnar, "iter_raw_with_handles"):
            return len(self.columnar)
        return sum(len(c.rows_meta) for c in self.chunks)


class ChunkWriter:
    """Packs datum rows into Chunks of `rows_per_chunk` rows."""

    def __init__(self, rows_per_chunk: int = 64):
        self.chunks: list[Chunk] = []
        self._cur_data = bytearray()
        self._cur_meta: list[RowMeta] = []
        self.rows_per_chunk = rows_per_chunk

    def append_row(self, handle: int, datums: list[Datum]) -> None:
        data = codec.encode_value(datums)
        self._cur_data.extend(data)
        self._cur_meta.append(RowMeta(handle, len(data)))
        if len(self._cur_meta) >= self.rows_per_chunk:
            self._flush()

    def _flush(self) -> None:
        if self._cur_meta:
            self.chunks.append(Chunk(bytes(self._cur_data), self._cur_meta))
            self._cur_data = bytearray()
            self._cur_meta = []

    def finish(self) -> list[Chunk]:
        self._flush()
        return self.chunks


def iter_response_rows(resp: SelectResponse):
    """Yield (handle, datums) decoded from chunks; a columnar scan answer
    yields the same flattened datums from its planes."""
    scan = getattr(resp.columnar, "iter_raw_with_handles", None)
    if scan is not None:
        yield from scan()
        return
    for chunk in resp.chunks:
        pos = 0
        mv = memoryview(chunk.rows_data)
        for meta in chunk.rows_meta:
            row_bytes = bytes(mv[pos:pos + meta.length])
            pos += meta.length
            yield meta.handle, codec.decode_all(row_bytes)
