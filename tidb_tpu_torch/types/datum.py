"""Datum: the tagged-union SQL value (copy of tidb_tpu/types/datum.py,
cut to the kinds the coprocessor path carries)."""

from __future__ import annotations

import enum
import re
from decimal import Decimal
from typing import Any

from tidb_tpu_torch import errors


class Kind(enum.IntEnum):
    NULL = 0
    INT64 = 1
    UINT64 = 2
    FLOAT64 = 3
    STRING = 4
    BYTES = 5
    DECIMAL = 6
    DURATION = 7
    TIME = 8
    MIN_NOT_NULL = 100   # range boundary sentinels
    MAX_VALUE = 101


class Datum:
    __slots__ = ("kind", "val")

    def __init__(self, kind: Kind, val: Any = None):
        self.kind = kind
        self.val = val

    @staticmethod
    def i64(v: int) -> "Datum":
        v = int(v)
        if not (-(1 << 63) <= v < (1 << 63)):
            raise errors.OverflowError_(f"int64 out of range: {v}")
        return Datum(Kind.INT64, v)

    @staticmethod
    def u64(v: int) -> "Datum":
        v = int(v)
        if not (0 <= v < (1 << 64)):
            raise errors.OverflowError_(f"uint64 out of range: {v}")
        return Datum(Kind.UINT64, v)

    @staticmethod
    def f64(v: float) -> "Datum":
        return Datum(Kind.FLOAT64, float(v))

    @staticmethod
    def string(v: str) -> "Datum":
        return Datum(Kind.STRING, v)

    @staticmethod
    def bytes_(v: bytes) -> "Datum":
        return Datum(Kind.BYTES, v)

    @staticmethod
    def dec(v) -> "Datum":
        if not isinstance(v, Decimal):
            v = Decimal(str(v))
        return Datum(Kind.DECIMAL, v)

    def is_null(self) -> bool:
        return self.kind == Kind.NULL

    def get_int(self) -> int:
        if self.kind in (Kind.INT64, Kind.UINT64):
            return self.val
        raise errors.TypeError_(f"datum kind {self.kind!r} is not an int")

    def get_string(self) -> str:
        if self.kind == Kind.STRING:
            return self.val
        if self.kind == Kind.BYTES:
            return self.val.decode("utf-8", "replace")
        raise errors.TypeError_(f"datum kind {self.kind!r} is not a string")

    def get_bytes(self) -> bytes:
        if self.kind == Kind.BYTES:
            return self.val
        if self.kind == Kind.STRING:
            return self.val.encode("utf-8")
        raise errors.TypeError_(f"datum kind {self.kind!r} is not bytes")

    def as_number(self):
        """Return a Python number preserving exactness where possible."""
        k = self.kind
        if k in (Kind.INT64, Kind.UINT64, Kind.FLOAT64, Kind.DECIMAL):
            return self.val
        if k == Kind.STRING:
            return _str_to_number(self.val)
        if k == Kind.BYTES:
            return _str_to_number(self.val.decode("utf-8", "replace"))
        if k in (Kind.DURATION, Kind.TIME):
            return self.val.to_number()
        raise errors.TypeError_(f"cannot coerce {k!r} to number")

    def __repr__(self):  # pragma: no cover - debug aid
        if self.kind == Kind.NULL:
            return "Datum(NULL)"
        return f"Datum({self.kind.name}, {self.val!r})"


NULL = Datum(Kind.NULL)
MIN_NOT_NULL = Datum(Kind.MIN_NOT_NULL)
MAX_VALUE = Datum(Kind.MAX_VALUE)

_NUM_PREFIX_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _str_to_number(s: str):
    """MySQL-ish lenient string→number: longest numeric prefix, else 0."""
    m = _NUM_PREFIX_RE.match(s.strip())
    if not m:
        return 0
    text = m.group(0)
    if "." in text or m.group(2):
        return float(text)
    return int(text)
