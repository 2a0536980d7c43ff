"""Time and Duration values (copy of tidb_tpu/types/time_types.py).

The column planes encode Time as its order-preserving packed int
(`to_packed_int`), so date compares run as int64 compares on the card.
"""

from __future__ import annotations

import datetime as _dt
import re

from tidb_tpu_torch import errors, mysqldef as my


class Duration:
    """TIME type: signed duration with fractional-second precision."""

    __slots__ = ("nanos", "fsp")

    def __init__(self, nanos: int, fsp: int = 0):
        self.nanos = int(nanos)
        self.fsp = fsp

    def to_number(self):
        """hhmmss.ffffff numeric form used in numeric contexts."""
        neg = self.nanos < 0
        n = abs(self.nanos)
        secs, frac = divmod(n, 1_000_000_000)
        h, rem = divmod(secs, 3600)
        m, s = divmod(rem, 60)
        v = h * 10000 + m * 100 + s + frac / 1e9
        return -v if neg else v

    def __eq__(self, other):
        return isinstance(other, Duration) and self.nanos == other.nanos

    def __hash__(self):
        return hash(self.nanos)


class Time:
    """DATE/DATETIME/TIMESTAMP value."""

    __slots__ = ("dt", "tp", "fsp")

    def __init__(self, dt: _dt.datetime, tp: int = my.TypeDatetime, fsp: int = 0):
        self.dt = dt
        self.tp = tp
        self.fsp = fsp

    def to_number(self):
        d = self.dt
        if self.tp == my.TypeDate:
            return d.year * 10000 + d.month * 100 + d.day
        v = (d.year * 10**10 + d.month * 10**8 + d.day * 10**6
             + d.hour * 10**4 + d.minute * 100 + d.second)
        if d.microsecond:
            return v + d.microsecond / 1e6
        return v

    def to_packed_int(self) -> int:
        """Order-preserving int64 encoding (codec + columnar plane format)."""
        d = self.dt
        ymd = (d.year * 13 + d.month) << 5 | d.day
        hms = d.hour << 12 | d.minute << 6 | d.second
        return ((ymd << 17 | hms) << 24) | d.microsecond

    @staticmethod
    def from_packed_int(v: int, tp: int = my.TypeDatetime, fsp: int = 0) -> "Time":
        micro = v & ((1 << 24) - 1)
        ymdhms = v >> 24
        ymd = ymdhms >> 17
        hms = ymdhms & ((1 << 17) - 1)
        day = ymd & 31
        ym = ymd >> 5
        year, month = divmod(ym, 13)
        second = hms & 63
        minute = (hms >> 6) & 63
        hour = hms >> 12
        return Time(_dt.datetime(year, month, day, hour, minute, second, micro), tp, fsp)

    def __str__(self):
        if self.tp == my.TypeDate:
            return self.dt.strftime("%Y-%m-%d")
        s = self.dt.strftime("%Y-%m-%d %H:%M:%S")
        if self.fsp > 0:
            s += f".{self.dt.microsecond:06d}"[: self.fsp + 1]
        return s

    def __repr__(self):
        return f"Time({self})"

    def __eq__(self, other):
        return isinstance(other, Time) and self.dt == other.dt

    def __hash__(self):
        return hash(self.dt)


_TIME_RE = re.compile(
    r"^\s*(\d{4})[-/](\d{1,2})[-/](\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2})(?:\.(\d{1,9}))?)?)?\s*$"
)


def parse_time(s: str, tp: int = my.TypeDatetime, fsp: int = 6) -> Time:
    m = _TIME_RE.match(s)
    if not m:
        # compact forms: YYYYMMDD / YYYYMMDDHHMMSS
        t = s.strip()
        if t.isdigit() and len(t) in (8, 14):
            try:
                if len(t) == 8:
                    d = _dt.datetime.strptime(t, "%Y%m%d")
                else:
                    d = _dt.datetime.strptime(t, "%Y%m%d%H%M%S")
                return Time(d, tp, fsp)
            except ValueError as e:
                raise errors.TypeError_(f"invalid time literal {s!r}") from e
        raise errors.TypeError_(f"invalid time literal {s!r}")
    y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
    h = int(m.group(4) or 0)
    mi = int(m.group(5) or 0)
    se = int(m.group(6) or 0)
    frac = m.group(7) or ""
    micro = int((frac + "000000")[:6]) if frac else 0
    try:
        dtv = _dt.datetime(y, mo, d, h, mi, se, micro)
    except ValueError as e:
        raise errors.TypeError_(f"invalid time literal {s!r}") from e
    if tp == my.TypeDate:
        dtv = dtv.replace(hour=0, minute=0, second=0, microsecond=0)
    return Time(dtv, tp, fsp)
