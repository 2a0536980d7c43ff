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


# ---------------------------------------------------------------------------
# a scan's columnar answer and the sides of a device join (copy of
# tidb_tpu/ops/columnar.py:560 plane_datums_batch, :593 ColumnarScanResult,
# :822 ColumnarPartialSet, :1341 RowsSide, :1400 rows_plane, :1442
# DeviceJoinResult with its region segments :1545-1575, :1598
# _side_gather, :1607 materialize_join_rows; the pure-Python branches).
# Rows materialize only for a consumer that pulls rows; an aggregate above
# a join reads the gathered planes (join→agg fusion, executor.fused_agg).
# Every side speaks gather_datums, the batched twin of the reference's
# per-cell datum_at (which only ColumnarPartialSet keeps, as one gather).
# ---------------------------------------------------------------------------

def plane_datums_batch(cd: ColumnData, c: PBColumnInfo,
                       rows: np.ndarray) -> list[Datum]:
    """plane_datum over a batch of plane cells: one numpy gather per
    plane, the same branch per kind."""
    vals = cd.values[rows]
    valid = cd.valid[rows].tolist()
    if cd.kind == K_STR:
        dic = cd.dictionary
        return [Datum.bytes_(dic[v]) if ok else NULL
                for v, ok in zip(vals.tolist(), valid)]
    if cd.kind == K_F64:
        return [Datum.f64(v) if ok else NULL
                for v, ok in zip(vals.tolist(), valid)]
    if cd.kind == K_DEC:
        scale = Decimal(10) ** cd.dec_scale
        return [Datum.dec(Decimal(v) / scale) if ok else NULL
                for v, ok in zip(vals.tolist(), valid)]
    if c.tp in my.TIME_TYPES:
        return [Datum(Kind.TIME, Time.from_packed_int(v, c.tp)) if ok
                else NULL for v, ok in zip(vals.tolist(), valid)]
    if c.tp == my.TypeDuration:
        return [Datum(Kind.DURATION, Duration(v)) if ok else NULL
                for v, ok in zip(vals.tolist(), valid)]
    return [Datum.i64(v) if ok else NULL
            for v, ok in zip(vals.tolist(), valid)]


class ColumnarScanResult:
    """A scan's columnar answer: the packed ColumnBatch plus the selection
    index (filter survivors, in emission order) and the output column
    metadata. Doubles as a device-join SIDE: column_plane / gather_datums /
    rows give what rows_plane over the materialized rows would,
    value for value. The batch is the client's shared cache: read-only;
    every gather copies. `device` is where the client keeps the batch's
    planes (kernels.batch_planes); `sel_device` the selection on it, when
    the filter left it there."""

    def __init__(self, batch: ColumnBatch, sel: np.ndarray,
                 pb_cols: list[PBColumnInfo], device=None, sel_device=None):
        self.batch = batch
        self.sel = np.asarray(sel, dtype=np.int64)
        self.pb_cols = pb_cols
        self.device = device
        self._sel_device = sel_device
        # the origin (region id, epoch) of a region's answer: the mesh
        # tier's placement key
        self.region_id = None
        self.region_epoch = None
        self._fts: list | None = None
        self._plane_cache: dict = {}
        self._device_plane_cache: dict = {}
        self._rows_cache: list | None = None

    def __len__(self) -> int:
        return len(self.sel)

    def handles(self) -> np.ndarray:
        return self.batch.handles[self.sel]

    def _ft(self, j: int):
        if self._fts is None:
            from tidb_tpu_torch.types.field_type import \
                field_type_from_pb_column
            self._fts = [field_type_from_pb_column(c) for c in self.pb_cols]
        return self._fts[j]

    def column_plane(self, j: int):
        """Output column j as a (kind, values, valid) plane, kind one of
        "i64" / "f64" / "str" — or (None, None, None) when the column's
        datum kind has no plane mapping (unsigned bigint, time, duration,
        decimal). The gate is rows_plane's over the row path."""
        ent = self._plane_cache.get(j)
        if ent is not None:
            return ent
        c = self.pb_cols[j]
        cd = self.batch.columns[c.column_id]
        sel = self.sel
        valid = cd.valid[sel]
        if not valid.any():
            # all-NULL: a (vacuously) numeric plane, like rows_plane
            ent = ("i64", np.zeros(len(sel), np.int64), valid)
        elif cd.kind == K_STR:
            vals = np.empty(len(sel), dtype=object)
            dic = self._emit_dictionary(j, cd)
            vals[:] = [dic[code] if ok else None
                       for code, ok in zip(cd.values[sel].tolist(),
                                           valid.tolist())]
            ent = ("str", vals, valid)
        elif cd.kind == K_F64:
            ent = ("f64", cd.values[sel], valid)
        elif cd.kind == K_I64 and c.tp in my.INTEGER_TYPES and \
                not (c.tp == my.TypeLonglong and my.has_unsigned_flag(c.flag)):
            ent = ("i64", cd.values[sel], valid)
        else:
            ent = (None, None, None)
        self._plane_cache[j] = ent
        return ent

    def decimal_plane(self, j: int):
        """Output column j, a DECIMAL column packed exactly, as (int64
        values scaled by the column's one 10^dec_scale, valid): order-exact
        for sorting. None for any other column."""
        cd = self.batch.columns[self.pb_cols[j].column_id]
        if cd.kind != K_DEC:
            return None
        return cd.values[self.sel], cd.valid[self.sel]

    def device_plane(self, j: int):
        """Output column j as (values, valid) tensors on the client's
        device, gathered there from the batch's resident planes — or None
        when the column's plane is not a plain numeric one (or a vacuous
        all-NULL coercion). Kind and dtype agree with column_plane(j)."""
        ent = self._device_plane_cache.get(j, False)
        if ent is not False:
            return ent
        out = None
        if self.device is not None:
            c = self.pb_cols[j]
            cd = self.batch.columns[c.column_id]
            kind, _v, _va = self.column_plane(j)
            if (kind == "f64" and cd.kind == K_F64) or \
                    (kind == "i64" and cd.kind == K_I64):
                import torch

                from tidb_tpu_torch.ops import kernels
                if self._sel_device is None:
                    self._sel_device = torch.from_numpy(self.sel).to(
                        self.device)
                dv, dva = kernels.batch_planes(self.batch,
                                               self.device)[c.column_id]
                out = kernels.gather_plane(dv, dva, self._sel_device)
        self._device_plane_cache[j] = out
        return out

    def dict_code_plane(self, j: int):
        """Output column j as DICTIONARY CODES: (codes int64 in emission
        order, -1 on NULLs, valid, LocalDomain of the batch's sorted
        dictionary). None when the column is not a K_STR plane, or when
        the row path's utf-8 round trip would REWRITE a dictionary entry
        (two raw entries could collapse to one emitted value, so code
        identity would differ from byte identity)."""
        ent = self._plane_cache.get(("dict", j))
        if ent is not None:
            return ent if ent != () else None
        out = None
        c = self.pb_cols[j]
        cd = self.batch.columns.get(c.column_id)
        if cd is not None and cd.kind == K_STR and \
                self._dict_utf8_clean(j, cd):
            from tidb_tpu_torch.copr.dictionary import LocalDomain
            sel = self.sel
            valid = cd.valid[sel]
            codes = np.where(valid, cd.values[sel], -1)
            out = (codes.astype(np.int64), valid,
                   LocalDomain(cd.dictionary))
        self._plane_cache[("dict", j)] = out if out is not None else ()
        return out

    def _dict_utf8_clean(self, j: int, cd: ColumnData) -> bool:
        """True when the emitted dictionary equals the stored one: binary
        columns always, decode-to-string columns when every entry survives
        the utf-8 replacement round trip unchanged."""
        from tidb_tpu_torch.types.convert import bytes_decode_to_string
        if not bytes_decode_to_string(self._ft(j)):
            return True
        clean = getattr(cd, "_utf8_clean", None)
        if clean is None:
            clean = all(b.decode("utf-8", "replace").encode("utf-8") == b
                        for b in cd.dictionary)
            cd._utf8_clean = clean
        return clean

    def _emit_dictionary(self, j: int, cd: ColumnData) -> list[bytes]:
        """Dictionary bytes as the ROW path carries them: non-binary
        string columns round-trip through utf-8 with replacement."""
        from tidb_tpu_torch.types.convert import bytes_decode_to_string
        if bytes_decode_to_string(self._ft(j)):
            return [b.decode("utf-8", "replace").encode("utf-8")
                    for b in cd.dictionary]
        return cd.dictionary

    def rows(self) -> list[list[Datum]]:
        """Materialized executor rows (typed, unflattened)."""
        if self._rows_cache is None:
            every = np.arange(len(self.sel))
            cols = [self.gather_datums(j, every)
                    for j in range(len(self.pb_cols))]
            self._rows_cache = [list(t) for t in zip(*cols)]
        return self._rows_cache

    def gather_datums(self, j: int, idx) -> list[Datum]:
        """Exact typed datums (unflattened) of output rows `idx`
        (positions into sel), column j: one plane gather."""
        if self._rows_cache is not None:
            return [self._rows_cache[int(i)][j] for i in idx]
        from tidb_tpu_torch.types.convert import (
            unflatten_datum, unflatten_identity_kinds)
        c = self.pb_cols[j]
        cd = self.batch.columns[c.column_id]
        ft = self._ft(j)
        idk = unflatten_identity_kinds(ft)
        rows = self.sel[np.asarray(idx, dtype=np.int64)]
        return [d if d.kind in idk else unflatten_datum(d, ft)
                for d in plane_datums_batch(cd, c, rows)]

    def iter_rows_with_handles(self):
        return iter(zip(self.handles().tolist(), self.rows()))

    def iter_raw_with_handles(self):
        """(handle, storage-flattened datums) pairs: what decoding this
        response's chunks would have yielded."""
        cols = list(self.pb_cols)
        cds = [self.batch.columns[c.column_id] for c in cols]
        raw = [plane_datums_batch(cd, c, self.sel) for cd, c in
               zip(cds, cols)]
        return iter(zip(self.handles().tolist(),
                        [list(t) for t in zip(*raw)] if raw
                        else [[] for _ in self.sel]))


class ColumnarPartialSet:
    """A multi-region scan answer (the port of tidb_tpu/ops/columnar.py
    :822): one ColumnarScanResult per region task, in task order, so the
    stacked row order is the row protocol's scan order. It speaks the
    side protocol of one ColumnarScanResult (column_plane, device_plane,
    dict_code_plane, decimal_plane, gather_datums, datum_at, rows), so
    joins, sorts and fused aggregates read it unchanged; region_slices /
    region_ids / region_epochs give each region's stacked rows and
    placement key, over which a fused aggregate combines per-region
    partial states (executor.fused_agg)."""

    def __init__(self, parts: list):
        if not parts:
            raise ValueError("empty partial set")
        self.parts = parts
        self.pb_cols = parts[0].pb_cols
        self.device = parts[0].device
        lens = [len(p) for p in parts]
        self.offsets = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(lens, dtype=np.int64)])
        self._plane_cache: dict = {}
        self._device_plane_cache: dict = {}
        self._rows_cache: list | None = None

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def region_slices(self) -> list[tuple[int, int]]:
        """[start, end) stacked rows of each region partial."""
        return [(int(self.offsets[i]), int(self.offsets[i + 1]))
                for i in range(len(self.parts))]

    def region_ids(self) -> list:
        return [p.region_id for p in self.parts]

    def region_epochs(self) -> list:
        return [p.region_epoch for p in self.parts]

    def handles(self) -> np.ndarray:
        return np.concatenate([p.handles() for p in self.parts])

    def column_plane(self, j: int):
        """Output column j stacked over the regions, as (kind, values,
        valid). A region whose plane is vacuous (all NULL, reported as a
        numeric plane) takes the kind the others agree on; a column some
        region cannot plane, or regions that really disagree on the kind,
        give (None, None, None), the gate rows_plane applies to rows."""
        ent = self._plane_cache.get(j)
        if ent is not None:
            return ent
        planes = [p.column_plane(j) for p in self.parts]
        kinds = {k for k, _v, va in planes if k is not None and va.any()}
        if any(k is None for k, _v, _va in planes) or len(kinds) > 1:
            ent = (None, None, None)
        else:
            kind = kinds.pop() if kinds else "i64"
            vals = []
            for (k, v, va), p in zip(planes, self.parts):
                if k != kind:
                    # a vacuous region: coerce to the agreed kind
                    v = np.empty(len(p), dtype=object) if kind == "str" \
                        else np.zeros(len(p), np.float64 if kind == "f64"
                                      else np.int64)
                vals.append(v)
            ent = (kind, np.concatenate(vals),
                   np.concatenate([va for _k, _v, va in planes]))
        self._plane_cache[j] = ent
        return ent

    def device_plane(self, j: int):
        """Output column j stacked over the regions on the device: one
        torch.cat of the regions' device planes (in place of the
        reference's kernels.stack_planes, a concat). None unless every
        region has a device plane of the set's kind. The stacked plane is
        a transient copy, charged like the reference's: to no pin (the
        join router's estimate covers the keys of a join)."""
        ent = self._device_plane_cache.get(j, False)
        if ent is not False:
            return ent
        out = None
        kind, _v, _va = self.column_plane(j)
        if kind in ("i64", "f64"):
            import torch
            devs = [p.device_plane(j) for p in self.parts]
            want = torch.float64 if kind == "f64" else torch.int64
            if all(d is not None and d[0].dtype == want for d in devs):
                out = (torch.cat([d[0] for d in devs]),
                       torch.cat([d[1] for d in devs]))
        self._device_plane_cache[j] = out
        return out

    def dict_code_plane(self, j: int):
        """Column j's dictionary codes stacked over the regions in one
        domain: each region's sorted dictionary remapped onto their sorted
        union (copr.dictionary.unify_domains), -1 on NULLs; None when a
        region has no code plane."""
        ent = self._plane_cache.get(("dict", j))
        if ent is not None:
            return ent if ent != () else None
        from tidb_tpu_torch.copr import dictionary
        out = None
        planes = [p.dict_code_plane(j) for p in self.parts]
        if all(pl is not None for pl in planes):
            doms = [pl[2] for pl in planes]
            valid = np.concatenate([pl[1] for pl in planes])
            if all(d.entries is doms[0].entries for d in doms):
                out = (np.concatenate([pl[0] for pl in planes]), valid,
                       doms[0])
            else:
                union, remaps = dictionary.unify_domains(doms)
                codes = []
                for (c, va, _d), remap in zip(planes, remaps):
                    if len(remap):
                        codes.append(np.where(
                            va, remap[np.clip(c, 0, len(remap) - 1)], -1))
                    else:
                        codes.append(np.full(len(c), -1, np.int64))
                out = (np.concatenate(codes).astype(np.int64), valid,
                       dictionary.LocalDomain(union))
        self._plane_cache[("dict", j)] = out if out is not None else ()
        return out

    def decimal_plane(self, j: int):
        """Column j's scaled decimal plane stacked over the regions, or
        None when a region has none or the regions' scales differ."""
        cd0 = self.parts[0].batch.columns[self.pb_cols[j].column_id]
        if any(p.batch.columns[self.pb_cols[j].column_id].dec_scale
               != cd0.dec_scale for p in self.parts):
            return None
        planes = [p.decimal_plane(j) for p in self.parts]
        if any(pl is None for pl in planes):
            return None
        return (np.concatenate([v for v, _va in planes]),
                np.concatenate([va for _v, va in planes]))

    def gather_datums(self, j: int, idx) -> list:
        """Datums of stacked rows `idx`, column j: the positions split by
        region, each region's own plane gather, reassembled in order."""
        gidx = np.asarray(idx, dtype=np.int64)
        pids = np.searchsorted(self.offsets, gidx, side="right") - 1
        out: list = [None] * len(gidx)
        for p in np.unique(pids).tolist():
            m = pids == p
            sub = self.parts[p].gather_datums(j, gidx[m]
                                              - int(self.offsets[p]))
            for pos, d in zip(np.flatnonzero(m).tolist(), sub):
                out[pos] = d
        return out

    def datum_at(self, j: int, i: int):
        return self.gather_datums(j, [i])[0]

    def rows(self) -> list:
        if self._rows_cache is None:
            out = []
            for p in self.parts:
                out.extend(p.rows())
            self._rows_cache = out
        return self._rows_cache

    def iter_rows_with_handles(self):
        return iter(zip(self.handles().tolist(), self.rows()))


class RowsSide:
    """Row-list side of a device join: drained executor rows behind the
    plane/rows/datum protocol ColumnarScanResult speaks."""

    def __init__(self, rows: list):
        self._rows = rows
        self._plane_cache: dict = {}

    def __len__(self) -> int:
        return len(self._rows)

    def rows(self) -> list:
        return self._rows

    def column_plane(self, j: int):
        ent = self._plane_cache.get(j)
        if ent is None:
            ent = self._plane_cache[j] = rows_plane(self._rows, j)
        return ent

    def gather_datums(self, j: int, idx) -> list:
        rows = self._rows
        return [rows[int(i)][j] for i in idx]


_JOIN_KINDS = (int(Kind.NULL), int(Kind.INT64), int(Kind.FLOAT64),
               int(Kind.STRING), int(Kind.BYTES))


def rows_plane(rows, idx: int):
    """One column of materialized executor rows → (kind, values, valid):
    "i64" / "f64" numpy planes or "str" (an object plane of bytes);
    (None, None, None) when the column mixes kinds or holds a kind with no
    plane mapping — mixed int/float stays off the join because the row
    engine's codec keys treat int 1 and float 1.0 as distinct values."""
    k_null, k_int, k_f64, k_str, k_bytes = _JOIN_KINDS
    n = len(rows)
    if n == 0:
        return "i64", np.zeros(0, np.int64), np.zeros(0, bool)
    kinds = np.fromiter((r[idx].kind for r in rows), dtype=np.int16, count=n)
    present = set(np.unique(kinds).tolist())
    valid = kinds != k_null
    if present == {k_null}:   # all-NULL: a (vacuously) numeric plane
        return "i64", np.zeros(n, np.int64), valid
    if present <= {k_null, k_str, k_bytes}:
        vals = np.empty(n, dtype=object)
        vals[:] = [r[idx].get_bytes() if m else None
                   for r, m in zip(rows, valid.tolist())]
        return "str", vals, valid
    if not present <= {k_null, k_int, k_f64}:
        return None, None, None
    if k_int in present and k_f64 in present:
        return None, None, None
    dtype = np.float64 if k_f64 in present else np.int64
    vals = np.fromiter(
        (r[idx].val if m else 0 for r, m in zip(rows, valid.tolist())),
        dtype=dtype, count=n)
    return ("f64" if dtype == np.float64 else "i64"), vals, valid


class DeviceJoinResult:
    """Columnar view of a join's output: the two sides (RowsSide row lists
    or ColumnarScanResult scan payloads) plus the FINAL emission-order
    index pairs (r_idx == -1 marks a LEFT OUTER pad row). Column planes
    gather lazily per column; rows materialize only for a consumer that
    pulls them."""

    def __init__(self, lside, rside, l_idx: np.ndarray, r_idx: np.ndarray,
                 left_width: int, right_width: int):
        self.lside = lside
        self.rside = rside
        self.l_idx = l_idx
        self.r_idx = r_idx
        self.left_width = left_width
        self.right_width = right_width
        self._plane_cache: dict = {}

    def __len__(self) -> int:
        return len(self.l_idx)

    def column_plane(self, j: int):
        """Output column j (left columns first) gathered into a plane:
        (kind, values, valid) or (None, None, None). Right-side planes
        fold the outer pads in as NULLs."""
        ent = self._plane_cache.get(j)
        if ent is not None:
            return ent
        if j < self.left_width:
            kind, vals, valid = self.lside.column_plane(j)
            if kind is not None:
                vals, valid = vals[self.l_idx], valid[self.l_idx]
        else:
            kind, vals, valid = self.rside.column_plane(j - self.left_width)
            if kind is not None:
                pad = self.r_idx < 0
                idx = np.where(pad, 0, self.r_idx)
                if len(self.rside):
                    vals, valid = vals[idx], valid[idx] & ~pad
                else:
                    vals = np.zeros(len(self.r_idx),
                                    vals.dtype if kind != "str" else object)
                    valid = np.zeros(len(self.r_idx), bool)
        ent = (kind, vals, valid)
        self._plane_cache[j] = ent
        return ent

    def decimal_plane(self, j: int):
        """Output column j's scaled decimal plane (ColumnarScanResult.
        decimal_plane) gathered through the pairs, the LEFT OUTER pads
        NULL; None when the source side has none."""
        side, jj, idx = (self.lside, j, self.l_idx) if j < self.left_width \
            else (self.rside, j - self.left_width, self.r_idx)
        get = getattr(side, "decimal_plane", None)
        src = get(jj) if get is not None else None
        if src is None:
            return None
        vals, valid = src
        pad = idx < 0
        if not len(vals):
            return np.zeros(len(idx), np.int64), np.zeros(len(idx), bool)
        gi = np.where(pad, 0, idx)
        return vals[gi], valid[gi] & ~pad

    def dict_code_plane(self, j: int):
        """Output column j's dictionary codes gathered through the pairs
        (-1 on NULLs and LEFT OUTER pads), or None when the source side
        has no code plane."""
        ent = self._plane_cache.get(("dict", j))
        if ent is not None:
            return ent if ent != () else None
        out = None
        if j < self.left_width:
            get = getattr(self.lside, "dict_code_plane", None)
            src = get(j) if get is not None else None
            if src is not None:
                codes, valid, dom = src
                out = (codes[self.l_idx], valid[self.l_idx], dom)
        else:
            get = getattr(self.rside, "dict_code_plane", None)
            src = get(j - self.left_width) if get is not None else None
            if src is not None:
                codes, valid, dom = src
                pad = self.r_idx < 0
                idx = np.where(pad, 0, self.r_idx)
                if len(self.rside):
                    out = (np.where(pad, -1, codes[idx]),
                           valid[idx] & ~pad, dom)
                else:
                    out = (np.full(len(self.r_idx), -1, np.int64),
                           np.zeros(len(self.r_idx), bool), dom)
        self._plane_cache[("dict", j)] = out if out is not None else ()
        return out

    def region_slices(self):
        """Each region's [start, end) rows of the join output, inherited
        from a multi-region left side: the pairs come in left-scan order,
        so each left region's rows map to one contiguous output range
        (searchsorted over l_idx). None when the left side has no regions
        or l_idx ever decreases."""
        src = getattr(self.lside, "region_slices", None)
        if src is None:
            return None
        if len(self.l_idx) and np.any(np.diff(self.l_idx) < 0):
            return None
        bounds = [s for s, _e in src()]
        if not bounds:
            return None
        cuts = np.searchsorted(self.l_idx, np.asarray(bounds, np.int64),
                               side="left").tolist() + [len(self.l_idx)]
        return [(int(cuts[i]), int(cuts[i + 1]))
                for i in range(len(cuts) - 1)]

    def region_ids(self):
        """The left side's region ids, aligned with region_slices."""
        src = getattr(self.lside, "region_ids", None)
        return src() if src is not None else None

    def region_epochs(self):
        src = getattr(self.lside, "region_epochs", None)
        return src() if src is not None else None

    def gather_datums(self, j: int, idx) -> list:
        """The source datums of output rows `idx`, column j, through the
        pairs (LEFT OUTER pads as NULLs)."""
        gidx = np.asarray(idx, dtype=np.int64)
        if j < self.left_width:
            return self.lside.gather_datums(j, self.l_idx[gidx])
        r = self.r_idx[gidx]
        pad = r < 0
        if not len(self.rside) or pad.all():
            return [NULL] * len(gidx)
        vals = self.rside.gather_datums(j - self.left_width,
                                        np.where(pad, 0, r))
        return [NULL if p else v for p, v in zip(pad.tolist(), vals)]

    def iter_rows(self, chunk: int = 1 << 16, stats: dict | None = None):
        """Stream output rows, `chunk` pairs per assembly call; `stats`
        accumulates the assembly time under "emit_s"."""
        import time
        n = len(self.l_idx)
        t0 = time.time()
        lrows, rrows = self.lside.rows(), self.rside.rows()
        if stats is not None:
            stats["emit_s"] = stats.get("emit_s", 0.0) + (time.time() - t0)
        for start in range(0, n, chunk):
            t0 = time.time()
            rows = materialize_join_rows(
                lrows, rrows, self.l_idx[start:start + chunk],
                self.r_idx[start:start + chunk], self.right_width)
            if stats is not None:
                stats["emit_s"] = stats.get("emit_s", 0.0) + \
                    (time.time() - t0)
            yield from rows


def materialize_join_rows(lrows, rrows, l_idx, r_idx,
                          right_width: int) -> list:
    """Assemble joined rows from match index pairs (r_idx -1 → LEFT OUTER
    NULL pad), in bulk (map over C iterators). Cyclic GC pauses for the
    allocation burst."""
    import gc
    gc_was_on = gc.isenabled()
    if gc_was_on:
        gc.disable()
    try:
        pad = [NULL] * right_width
        lget, rget = lrows.__getitem__, rrows.__getitem__
        if len(r_idx) and int(r_idx.min()) >= 0:
            return list(map(list.__add__, map(lget, l_idx.tolist()),
                            map(rget, r_idx.tolist())))
        return [lget(l) + (rget(r) if r >= 0 else pad)
                for l, r in zip(l_idx.tolist(), r_idx.tolist())]
    finally:
        if gc_was_on:
            gc.enable()
