"""Datum conversions of the final aggregate (copy of the parts of
tidb_tpu/types/convert.py and tidb_tpu/types/datum.py:234 compare_datum
that typing and merging partial states need)."""

from __future__ import annotations

from decimal import ROUND_HALF_UP, Decimal, localcontext

from tidb_tpu_torch import errors, mysqldef as my
from tidb_tpu_torch.types.datum import Datum, Kind
from tidb_tpu_torch.types.field_type import FieldType
from tidb_tpu_torch.types.time_types import Duration, Time


def quantize_decimal(dec: Decimal, frac: int,
                     rounding=ROUND_HALF_UP) -> Decimal:
    """Quantize to `frac` fractional digits with enough precision that
    wide values never raise InvalidOperation."""
    q = Decimal(1).scaleb(-frac)
    with localcontext() as ctx:
        ctx.prec = max(dec.adjusted() + 1 + frac + 2, 28)
        return dec.quantize(q, rounding=rounding)


def bytes_decode_to_string(ft: FieldType) -> bool:
    """A BYTES storage value unflattens into a STRING datum for this
    column (non-binary, non-blob string type)."""
    return ft.is_string() and ft.tp not in (
        my.TypeBlob, my.TypeTinyBlob, my.TypeMediumBlob,
        my.TypeLongBlob) and not (ft.flag & my.BinaryFlag)


def unflatten_datum(d: Datum, ft: FieldType) -> Datum:
    """Restore the column-type metadata the flag-only storage codec drops
    (DATE vs DATETIME and fsp, strings vs bytes, unsigned, decimal display
    scale). Enum, set and bit columns never reach the port's states path:
    their values have no plane (ops.columnar.column_phys_kind)."""
    k = d.kind
    if k == Kind.NULL:
        return d
    if k == Kind.TIME:
        t: Time = d.val
        tp = ft.tp if ft.is_time() else t.tp
        fsp = ft.decimal if ft.decimal >= 0 else 0
        return Datum(Kind.TIME, Time(t.dt, tp, fsp))
    if k == Kind.DURATION:
        fsp = ft.decimal if ft.decimal >= 0 else 0
        return Datum(Kind.DURATION, Duration(d.val.nanos, fsp))
    if k == Kind.BYTES and bytes_decode_to_string(ft):
        return Datum(Kind.STRING, d.val.decode("utf-8", "replace"))
    if k == Kind.INT64 and ft.is_unsigned() \
            and ft.tp == my.TypeLonglong and d.val >= 0:
        return Datum(Kind.UINT64, d.val)
    if k in (Kind.INT64, Kind.UINT64) \
            and ft.tp in (my.TypeEnum, my.TypeSet, my.TypeBit):
        raise errors.TypeError_("enum/set/bit values are not ported")
    if k == Kind.DECIMAL and ft.is_decimal() and ft.decimal >= 0:
        quantized = quantize_decimal(d.val, ft.decimal)
        if d.val == quantized:
            return Datum(Kind.DECIMAL, quantized)
    return d


def unflatten_identity_kinds(ft: FieldType) -> frozenset:
    """Kinds for which unflatten_datum(d, ft) is the identity."""
    kinds = {Kind.NULL, Kind.FLOAT64, Kind.STRING}
    if not bytes_decode_to_string(ft):
        kinds.add(Kind.BYTES)
    if ft.tp not in (my.TypeEnum, my.TypeSet, my.TypeBit):
        kinds.add(Kind.UINT64)
        if not (ft.is_unsigned() and ft.tp == my.TypeLonglong):
            kinds.add(Kind.INT64)
    return frozenset(kinds)


def compare_datum(a: Datum, b: Datum) -> int:
    """Three-way compare: NULL first, strings by binary collation over
    utf-8 bytes — the only datum-mode min/max states (string columns) the
    states merge compares. The reference's other kinds and cross-type
    coercions are not ported."""
    ak, bk = a.kind, b.kind
    if ak == Kind.NULL:
        return 0 if bk == Kind.NULL else -1
    if bk == Kind.NULL:
        return 1
    if ak not in (Kind.STRING, Kind.BYTES) \
            or bk not in (Kind.STRING, Kind.BYTES):
        raise errors.TypeError_(f"compare of {ak!r} with {bk!r} not ported")
    x, y = a.get_bytes(), b.get_bytes()
    return -1 if x < y else (0 if x == y else 1)
