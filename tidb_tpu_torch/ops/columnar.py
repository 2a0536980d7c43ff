"""Columnar batches: the coprocessor's in-memory data format (copy of
tidb_tpu/ops/columnar.py:35-383 and :538-560, :1636).

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
