"""FieldType: column type metadata (copy of tidb_tpu/types/field_type.py,
cut to what the final aggregate needs to type its results: the aggregate
result types and the arithmetic merge of argument expressions)."""

from __future__ import annotations

from tidb_tpu_torch import mysqldef as my

UNSPECIFIED_LENGTH = -1


class FieldType:
    __slots__ = ("tp", "flag", "flen", "decimal", "elems")

    def __init__(self, tp: int = my.TypeNull, flag: int = 0,
                 flen: int = UNSPECIFIED_LENGTH,
                 decimal: int = UNSPECIFIED_LENGTH, elems=None):
        self.tp = tp
        self.flag = flag
        self.flen = flen
        self.decimal = decimal
        self.elems = elems or []

    def is_unsigned(self) -> bool:
        return my.has_unsigned_flag(self.flag)

    def is_string(self) -> bool:
        return self.tp in my.STRING_TYPES

    def is_float(self) -> bool:
        return self.tp in my.FLOAT_TYPES

    def is_decimal(self) -> bool:
        return self.tp in (my.TypeNewDecimal, my.TypeDecimal)

    def is_time(self) -> bool:
        return self.tp in my.TIME_TYPES

    def clone(self) -> "FieldType":
        return FieldType(self.tp, self.flag, self.flen, self.decimal,
                         list(self.elems))


def new_field_type(tp: int) -> FieldType:
    # the reference also sets the default display length, which no value
    # of the coprocessor path reads
    return FieldType(tp)


_MERGE_ORDER = [
    my.TypeDouble, my.TypeFloat, my.TypeNewDecimal, my.TypeLonglong,
    my.TypeLong, my.TypeInt24, my.TypeShort, my.TypeTiny,
]


def merge_numeric(a: FieldType, b: FieldType) -> FieldType:
    """Result type of an arithmetic op over a and b."""
    if a.tp == my.TypeNull:
        return b.clone()
    if b.tp == my.TypeNull:
        return a.clone()
    for tp in _MERGE_ORDER:
        if a.tp == tp or b.tp == tp:
            ft = new_field_type(tp)
            if tp == my.TypeNewDecimal:
                ft.decimal = max(a.decimal if a.decimal >= 0 else 0,
                                 b.decimal if b.decimal >= 0 else 0)
            return ft
    return new_field_type(my.TypeDouble)


def agg_field_type(name: str, arg: FieldType) -> FieldType:
    """Result FieldType of an aggregate function: count → bigint, sum →
    decimal (double over floats), avg → decimal + 4 digits (double over
    floats), min/max/first_row → the argument's."""
    name = name.lower()
    if name == "count":
        ft = new_field_type(my.TypeLonglong)
        ft.flag |= my.NotNullFlag
        return ft
    if name == "sum":
        if arg.is_float():
            return new_field_type(my.TypeDouble)
        ft = new_field_type(my.TypeNewDecimal)
        ft.decimal = arg.decimal if arg.decimal >= 0 else 0
        return ft
    if name == "avg":
        if arg.is_float():
            return new_field_type(my.TypeDouble)
        ft = new_field_type(my.TypeNewDecimal)
        base = arg.decimal if arg.decimal >= 0 else 0
        ft.decimal = min(base + 4, 30)
        return ft
    if name in ("min", "max", "first", "firstrow", "first_row"):
        return arg.clone()
    if name == "group_concat":
        return new_field_type(my.TypeVarString)
    return new_field_type(my.TypeDouble)


def field_type_from_pb_column(c) -> FieldType:
    return FieldType(tp=c.tp, flag=c.flag, flen=c.flen, decimal=c.decimal,
                     elems=list(c.elems))
