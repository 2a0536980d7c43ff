"""Columnar batches: the coprocessor's in-memory data format (copy of
tidb_tpu/ops/columnar.py:35-383 and :538-560, :1636), and the grouped
partial STATES a region answers a pushed-down aggregate with
(AggStateCol :1087, ColumnarAggStates :1148, ColumnarStatesSet :1282,
dec_canonical :1103, agg_partial_field_types :1056).

Each region-range scan is packed once into column arrays — a values plane
and a validity plane per column, strings dictionary-encoded, temporals as
ordered int64 — and requests evaluate as kernels over the planes. Planes
are padded to power-of-two buckets ("pad-to-bucket").

The packed batch is host numpy; `ops.kernels.batch_planes` moves it to the
device as torch tensors. The reference's native C scan (`codecx`) is not
carried: `_scan_rows` is the Python loop, whose output layout is the
contract.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from decimal import Decimal

import numpy as np

from tidb_tpu_torch import errors, mysqldef as my, tablecodec as tc
from tidb_tpu_torch.copr.proto import PBColumnInfo
from tidb_tpu_torch.types.datum import NULL, Datum, Kind
from tidb_tpu_torch.types.time_types import Duration, Time

I64_MIN = -(1 << 63)
I64_MAX = (1 << 63) - 1

# column physical kinds
K_I64 = "i64"     # ints, times (packed int), durations (nanos)
K_F64 = "f64"
K_STR = "str"     # dictionary codes (int64) + ordered dictionary
K_DEC = "dec"     # EXACT fixed-point: int64 scaled by 10^dec_scale

MAX_DEC_PLANE_SCALE = 6   # columns finer than this stay off the planes

_POW10 = [10 ** i for i in range(19)]


def _dec_scale_of(c: PBColumnInfo, kind: str) -> int:
    return c.decimal if kind == K_DEC and c.decimal and c.decimal > 0 else 0


def _check_u64_plane(c: PBColumnInfo, vals: np.ndarray, va: np.ndarray,
                     n: int) -> None:
    """An unsigned bigint above the int64 range would surface as a negative
    plane value; raise TypeError_ instead of serving it."""
    if c.tp == my.TypeLonglong and my.has_unsigned_flag(c.flag) and n:
        if bool(np.any((vals[:n] < 0) & va[:n])):
            raise errors.TypeError_(
                "unsigned bigint above the int64 plane range")


def _plane_max_abs(vals: np.ndarray, n: int, kind: str) -> int:
    """Magnitude bound of a numeric plane (exact-arithmetic guards).
    Python-int abs: np.abs(int64 min) would itself wrap."""
    if kind not in (K_DEC, K_I64) or n == 0:
        return 0
    return max(abs(int(vals[:n].min())), abs(int(vals[:n].max())))


@dataclass
class ColumnData:
    kind: str
    values: np.ndarray            # i64/f64 plane, or int64 codes for K_STR
    valid: np.ndarray             # bool plane
    dictionary: list[bytes] | None = None  # K_STR: sorted code → bytes
    tp: int = 0                   # MySQL type byte (time/duration decode)
    dec_scale: int = 0            # K_DEC: values = datum * 10^dec_scale
    max_abs: int = 0              # K_DEC/K_I64: max |value| in the batch

    def code_of(self, b: bytes) -> int:
        """Exact-match dictionary code, or -1."""
        i = bisect.bisect_left(self.dictionary, b)
        if i < len(self.dictionary) and self.dictionary[i] == b:
            return i
        return -1

    def lower_bound(self, b: bytes) -> int:
        """#codes strictly below b (for <, >=, prefix ranges)."""
        return bisect.bisect_left(self.dictionary, b)

    def upper_bound(self, b: bytes) -> int:
        return bisect.bisect_right(self.dictionary, b)


@dataclass
class ColumnBatch:
    n_rows: int                   # live rows
    capacity: int                 # padded length of every plane
    handles: np.ndarray           # int64; padding rows hold I64_MIN
    columns: dict[int, ColumnData]  # column_id → planes

    def row_mask(self) -> np.ndarray:
        m = np.zeros(self.capacity, dtype=bool)
        m[: self.n_rows] = True
        return m

    def group_codes(self, cid: int) -> tuple[np.ndarray, np.ndarray]:
        """Host-built dictionary codes for a numeric/time group column:
        (codes plane int64[capacity], sorted unique values). K_STR columns
        don't need this: their values plane already is the code plane."""
        cache = getattr(self, "_group_codes", None)
        if cache is None:
            cache = self._group_codes = {}
        ent = cache.get(cid)
        if ent is not None:
            return ent
        cd = self.columns[cid]
        live = self.row_mask() & cd.valid
        vals = cd.values
        if cd.kind == K_F64:
            # -0.0 groups with +0.0 (SQL equality)
            vals = np.where(vals == 0.0, 0.0, vals)
        uniq = np.unique(vals[live])
        codes = np.searchsorted(uniq, vals).astype(np.int64)
        if len(uniq):
            np.minimum(codes, len(uniq) - 1, out=codes)  # pad rows in-range
        else:
            codes[:] = 0
        ent = (codes, uniq)
        cache[cid] = ent
        return ent


    def tuple_codes(self, cids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Host-built composite codes over a TUPLE of group columns:
        (codes int64[capacity], percol int64[G, k]). Each live row maps
        to the dense id (0..G-1, sorted order) of its distinct
        (col_1, ..., col_k) combination; percol[g, j] is column j's code
        for group g (== the column's size means NULL)."""
        cache = getattr(self, "_tuple_code_cache", None)
        if cache is None:
            cache = self._tuple_code_cache = {}
        key = tuple(cids)
        ent = cache.get(key)
        if ent is not None:
            return ent
        live = self.row_mask()
        percol_planes, radices = [], []
        for cid in cids:
            cd = self.columns[cid]
            if cd.kind == K_STR:
                size = len(cd.dictionary)
                codes = cd.values.astype(np.int64)
            else:
                codes, uniq = self.group_codes(cid)
                size = len(uniq)
            # NULL → reserved per-column slot
            percol_planes.append(np.where(cd.valid, codes, size))
            radices.append(size + 1)
        prod = 1
        for r in radices:
            prod *= r
        k = len(cids)
        if prod < (1 << 62):
            # the tuple packed into one int64 (mixed radix), compacted
            keys = np.zeros(self.capacity, dtype=np.int64)
            for codes, r in zip(percol_planes, radices):
                keys = keys * r + codes
            uniq_keys = np.unique(keys[live])
            out = np.searchsorted(uniq_keys, keys).astype(np.int64)
            G = len(uniq_keys)
            if G:
                np.minimum(out, G - 1, out=out)  # pad rows in-range
            else:
                out[:] = 0
            percol = np.empty((G, k), dtype=np.int64)
            rem = uniq_keys.copy()
            for j in range(k - 1, -1, -1):
                percol[:, j] = rem % radices[j]
                rem //= radices[j]
        else:
            # cross product beyond int64: compact rows directly
            stacked = np.stack(percol_planes, axis=1)
            uniq_rows, inv = np.unique(stacked[live], axis=0,
                                       return_inverse=True)
            out = np.zeros(self.capacity, dtype=np.int64)
            out[live] = np.reshape(inv, -1)
            percol = uniq_rows.astype(np.int64)
        ent = (out, percol)
        cache[key] = ent
        return ent


def bucket_capacity(n: int, minimum: int = 1024) -> int:
    c = minimum
    while c < n:
        c <<= 1
    return c


def column_phys_kind(col: PBColumnInfo) -> str:
    tp = col.tp
    if tp in my.INTEGER_TYPES or tp == my.TypeBit:
        return K_I64
    if tp in my.FLOAT_TYPES:
        return K_F64
    if tp in my.TIME_TYPES or tp == my.TypeDuration:
        return K_I64
    if tp in my.STRING_TYPES:
        return K_STR
    if tp in (my.TypeNewDecimal, my.TypeDecimal):
        scale = col.decimal if col.decimal is not None else -1
        prec = col.flen if col.flen is not None else -1
        if 0 <= scale <= MAX_DEC_PLANE_SCALE and prec <= 18:
            return K_DEC
        raise errors.TypeError_(
            f"decimal({prec},{scale}) exceeds the fixed-point plane")
    raise errors.TypeError_(f"no columnar mapping for type 0x{tp:02x}")


def datum_to_phys(d: Datum, kind: str, dec_scale: int = 0):
    """Datum → (physical value, is_valid). K_DEC demands EXACT
    representation at the plane scale."""
    if d.is_null():
        return 0, False
    k = d.kind
    if kind == K_DEC:
        if k == Kind.DECIMAL:
            v = d.val
        elif k in (Kind.INT64, Kind.UINT64):
            v = Decimal(int(d.val))
        else:
            raise errors.TypeError_(f"cannot pack {d!r} as fixed-point")
        scaled = v * _POW10[dec_scale]
        iv = int(scaled)
        if scaled != iv or not (-(1 << 62) < iv < (1 << 62)):
            raise errors.TypeError_(
                f"decimal {v} not exact at scale {dec_scale}")
        return iv, True
    if kind == K_I64:
        if k in (Kind.INT64, Kind.UINT64):
            v = int(d.val)
            if not (I64_MIN <= v <= I64_MAX):
                raise errors.TypeError_(
                    f"integer {v} exceeds the int64 plane")
            return v, True
        if k == Kind.TIME:
            return int(d.val.to_packed_int()), True
        if k == Kind.DURATION:
            return int(d.val.nanos), True
        if k == Kind.FLOAT64:
            return int(d.val), True
        if k == Kind.DECIMAL:
            return int(d.val), True
    elif kind == K_F64:
        return float(d.as_number()), True
    elif kind == K_STR:
        return d.get_bytes(), True
    raise errors.TypeError_(f"cannot pack {d!r} as {kind}")


def _scan_rows(snapshot, table_id: int, columns, ranges, defaults):
    """Per-row scan + decode: (handles, raw values, valid flags)."""
    col_kinds = {c.column_id: column_phys_kind(c) for c in columns}
    col_scales = {c.column_id: _dec_scale_of(c, col_kinds[c.column_id])
                  for c in columns}
    pk_col = next((c for c in columns if c.pk_handle), None)

    handles: list[int] = []
    raw: dict[int, list] = {c.column_id: [] for c in columns}
    valid: dict[int, list] = {c.column_id: [] for c in columns}

    for rg in ranges:
        for key, value in snapshot.iterate(rg.start, rg.end):
            try:
                _, handle = tc.decode_row_key(key)
            except (ValueError, errors.TiDBError):
                continue
            row = tc.decode_row(value)
            handles.append(handle)
            for c in columns:
                cid = c.column_id
                if pk_col is not None and cid == pk_col.column_id:
                    raw[cid].append(handle)
                    valid[cid].append(True)
                    continue
                d = row.get(cid)
                if d is None:
                    d = defaults.get(cid, NULL)
                v, ok = datum_to_phys(d, col_kinds[cid], col_scales[cid])
                raw[cid].append(v)
                valid[cid].append(ok)
    return handles, raw, valid


def pack_ranges(snapshot, table_id: int, columns: list[PBColumnInfo],
                ranges, fill_defaults: dict[int, Datum] | None = None
                ) -> ColumnBatch:
    """Scan+decode [start,end) row ranges into a ColumnBatch."""
    col_kinds = {c.column_id: column_phys_kind(c) for c in columns}
    defaults = fill_defaults or {}
    handles, raw, valid = _scan_rows(snapshot, table_id, columns, ranges,
                                     defaults)

    n = len(handles)
    cap = bucket_capacity(n)
    h = np.full(cap, I64_MIN, dtype=np.int64)
    h[:n] = handles
    cols: dict[int, ColumnData] = {}
    for c in columns:
        cid = c.column_id
        kind = col_kinds[cid]
        va = np.zeros(cap, dtype=bool)
        va[:n] = valid[cid]
        if kind == K_STR:
            cols[cid] = _pack_str_column(raw[cid], va, cap, n)
            cols[cid].tp = c.tp
        else:
            dtype = np.float64 if kind == K_F64 else np.int64
            vals = np.zeros(cap, dtype=dtype)
            if n:
                vals[:n] = [x if ok else 0
                            for x, ok in zip(raw[cid], valid[cid])]
            if kind == K_I64:
                _check_u64_plane(c, vals, va, n)
            cols[cid] = ColumnData(
                kind, vals, va, tp=c.tp,
                dec_scale=_dec_scale_of(c, kind),
                max_abs=_plane_max_abs(vals, n, kind))
    batch = ColumnBatch(n, cap, h, cols)
    batch.max_handle = int(max(handles)) if n else I64_MIN
    return batch


def plane_datum(cd: ColumnData, c: PBColumnInfo, i: int) -> Datum:
    """One plane cell → the storage-flattened Datum the row protocol
    carries."""
    if not cd.valid[i]:
        return NULL
    if cd.kind == K_STR:
        return Datum.bytes_(cd.dictionary[int(cd.values[i])])
    if cd.kind == K_F64:
        return Datum.f64(float(cd.values[i]))
    if cd.kind == K_DEC:
        return Datum.dec(Decimal(int(cd.values[i]))
                         / (Decimal(10) ** cd.dec_scale))
    v = int(cd.values[i])
    if c.tp in my.TIME_TYPES:
        return Datum(Kind.TIME, Time.from_packed_int(v, c.tp))
    if c.tp == my.TypeDuration:
        return Datum(Kind.DURATION, Duration(v))
    return Datum.i64(v)


def _pack_str_column(raw: list, va: np.ndarray, cap: int, n: int) -> ColumnData:
    uniq = sorted({v for v, ok in zip(raw, va[:n]) if ok})
    code_of = {b: i for i, b in enumerate(uniq)}
    # int64 codes so min/max sentinels and mixed-radix group ids never
    # overflow mid-kernel
    codes = np.full(cap, -1, dtype=np.int64)
    if n:
        codes[:n] = [code_of[v] if ok else -1
                     for v, ok in zip(raw, va[:n])]
    return ColumnData(K_STR, codes, va, uniq)


# ---------------------------------------------------------------------------
# grouped partial STATES: a region's answer to a pushed-down aggregate
# ---------------------------------------------------------------------------

def _expr_field_type(e, col_pb: dict):
    """Result FieldType of a pushed-down argument EXPRESSION: the
    arithmetic inference of the planner (merge_numeric, then Div over
    non-floats promotes to decimal)."""
    from tidb_tpu_torch.copr.proto import ExprType
    from tidb_tpu_torch.sqlast.opcode import Op
    from tidb_tpu_torch.types.field_type import (
        field_type_from_pb_column, merge_numeric, new_field_type)
    if e.tp == ExprType.COLUMN_REF and e.val in col_pb:
        return field_type_from_pb_column(col_pb[e.val])
    if e.tp == ExprType.VALUE:
        d = e.val
        if d is None or d.is_null():
            return new_field_type(my.TypeNull)
        if d.kind == Kind.FLOAT64:
            return new_field_type(my.TypeDouble)
        if d.kind == Kind.DECIMAL:
            ft = new_field_type(my.TypeNewDecimal)
            ft.decimal = max(-d.val.as_tuple().exponent, 0)
            return ft
        return new_field_type(my.TypeLonglong)
    if e.tp == ExprType.OPERATOR and e.children:
        if len(e.children) == 1:
            return _expr_field_type(e.children[0], col_pb)
        rt = merge_numeric(_expr_field_type(e.children[0], col_pb),
                           _expr_field_type(e.children[1], col_pb))
        if e.op == Op.Div and rt.tp not in (my.TypeDouble, my.TypeFloat):
            rt = new_field_type(my.TypeNewDecimal)
        return rt
    return new_field_type(my.TypeLonglong)


def agg_partial_field_types(aggregates, col_pb: dict):
    """Field types of the partial-row layout [groupKey, f0 parts, ...]
    (count first if the aggregate needs one, then the value)."""
    from tidb_tpu_torch.copr.proto import AGG_NAME, ExprType
    from tidb_tpu_torch.types.field_type import (
        FieldType, agg_field_type, field_type_from_pb_column,
        new_field_type)
    fts = [new_field_type(my.TypeBlob)]
    for e in aggregates:
        name = AGG_NAME[e.tp]
        arg = e.children[0] if e.children else None
        if arg is not None and arg.tp == ExprType.COLUMN_REF \
                and arg.val in col_pb:
            arg_ft = field_type_from_pb_column(col_pb[arg.val])
        elif arg is not None:
            arg_ft = _expr_field_type(arg, col_pb)
        else:
            arg_ft = FieldType(my.TypeLonglong)
        need_count = name in ("count", "avg")
        need_value = name in ("sum", "avg", "min", "max", "first_row",
                              "group_concat")
        if need_count:
            fts.append(new_field_type(my.TypeLonglong))
        if need_value:
            fts.append(agg_field_type(name, arg_ft))
        if not need_count and not need_value:
            fts.append(new_field_type(my.TypeLonglong))
    return fts


@dataclass
class AggStateCol:
    """One aggregate's per-group partial states. `values` is the
    combinable numeric state (int64/f64, `op` its monoid); datum-mode
    states (string min/max, first_row) carry per-group flattened Datums
    in `datums` and merge on the host."""
    name: str                       # count|sum|avg|min|max|first_row
    counts: np.ndarray              # int64[G] contributing rows
    values: np.ndarray | None = None   # int64/f64[G] numeric state
    op: str | None = None           # "sum" | "min" | "max"
    kind: str | None = None         # value kind: "i64" | "f64" | "dec"
    dec_scale: int = 0
    pb_col: PBColumnInfo | None = None   # arg column (datum decode)
    datums: list | None = None      # datum-mode per-group values


def dec_canonical(d: Decimal) -> Decimal:
    """Codec-canonical Decimal: trailing zero digits trimmed, the form the
    storage codec round-trips (not Decimal.normalize(), which rounds to
    the context precision)."""
    sign, digits, exp = d.as_tuple()
    dl = list(digits)
    while len(dl) > 1 and dl[-1] == 0:
        dl.pop()
        exp += 1
    if dl == [0]:
        return Decimal(0)
    return Decimal((sign, tuple(dl), exp))


class ColumnarAggStates:
    """One region's pushed-down aggregate answered as grouped partial
    STATES: codec-encoded group keys in the region's first-appearance
    order plus one AggStateCol per requested aggregate. A region ships it
    with the filter and the states still pending (`_pending`); the
    statement finisher (copr.columnar_region.finish_states_batch) fills
    in the keys and states for every region at once."""

    is_agg_states = True

    def __init__(self, group_keys, aggs, aggregates, col_pb: dict,
                 pending=None):
        self._group_keys = group_keys
        self._aggs = aggs
        self._pending = pending
        self._aggregates = aggregates      # request Expr list
        self._col_pb = col_pb
        self._fts: list | None = None
        self.cache_info: dict | None = None
        self.region_id: int | None = None
        self.region_epoch: tuple | None = None
        self.device = None

    @property
    def aggs(self) -> list[AggStateCol]:
        if self._aggs is None:
            raise errors.TiDBError("partial states still pending: the "
                                   "statement finisher has not run")
        return self._aggs

    @property
    def group_keys(self) -> list[bytes]:
        if self._group_keys is None:
            raise errors.TiDBError("group keys still pending: the "
                                   "statement finisher has not run")
        return self._group_keys

    @group_keys.setter
    def group_keys(self, keys: list[bytes]) -> None:
        self._group_keys = keys

    def states_pending(self) -> bool:
        return self._aggs is None and self._pending is not None

    def filter_pending(self) -> bool:
        return (self._aggs is None and self._pending is not None
                and getattr(self._pending, "is_filter", False))

    def fulfill_states(self, aggs: list[AggStateCol]) -> None:
        if self._aggs is None:
            self._aggs = aggs
            self._pending = None

    def __len__(self) -> int:
        return len(self.group_keys)

    def field_types(self) -> list:
        if self._fts is None:
            self._fts = agg_partial_field_types(self._aggregates,
                                                self._col_pb)
        return self._fts

    def value_ft(self, i: int):
        """Field type of aggregate i's value slot."""
        fts = self.field_types()
        j = 1
        for k, st in enumerate(self.aggs):
            if st.name in ("count", "avg"):
                if k == i and st.name == "count":
                    return fts[j]
                j += 1
            if st.name != "count":
                if k == i:
                    return fts[j]
                j += 1
        return fts[-1]


class ColumnarStatesSet:
    """A multi-region pushed-aggregate response: one ColumnarAggStates
    per region task, in task order."""

    is_agg_states = True

    def __init__(self, parts: list):
        assert parts, "empty states set"
        self.parts = parts

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)

    def region_ids(self) -> list:
        return [getattr(p, "region_id", None) for p in self.parts]

    def region_epochs(self) -> list:
        return [getattr(p, "region_epoch", None) for p in self.parts]
