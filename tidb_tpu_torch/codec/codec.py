"""Flagged compound datum encoding (copy of tidb_tpu/codec/codec.py).

Each datum = 1 flag byte + payload. Key encoding is memcomparable; value
encoding uses compact (varint) forms. The reference takes a C encoder when
it is built; this copy is the Python path, whose bytes are the contract.

Decimal layout: sign byte (0=neg, 1=zero, 2=pos); for nonzero: 8-byte
comparable exponent then digits+1 bytes terminated by 0x00, all
bitwise-flipped when negative (terminator 0xFF).
"""

from __future__ import annotations

import struct
from decimal import Decimal

from tidb_tpu_torch.codec import bytes_codec as bc
from tidb_tpu_torch.codec import number as num
from tidb_tpu_torch.types.datum import MAX_VALUE, MIN_NOT_NULL, NULL, Datum, Kind
from tidb_tpu_torch.types.time_types import Duration, Time

NIL_FLAG = 0x00
BYTES_FLAG = 0x01
COMPACT_BYTES_FLAG = 0x02
INT_FLAG = 0x03
UINT_FLAG = 0x04
FLOAT_FLAG = 0x05
DECIMAL_FLAG = 0x06
DURATION_FLAG = 0x07
TIME_FLAG = 0x08
VARINT_FLAG = 0x09
UVARINT_FLAG = 0x0A
MAX_FLAG = 0xFA


def encode_datum(buf: bytearray, d: Datum, comparable: bool) -> None:
    k = d.kind
    if k == Kind.NULL:
        buf.append(NIL_FLAG)
    elif k == Kind.MIN_NOT_NULL:
        buf.append(BYTES_FLAG)
    elif k == Kind.MAX_VALUE:
        buf.append(MAX_FLAG)
    elif k == Kind.INT64:
        if comparable:
            buf.append(INT_FLAG)
            num.encode_u64(buf, num.encode_int_to_cmp_uint(d.val))
        else:
            buf.append(VARINT_FLAG)
            num.encode_varint(buf, d.val)
    elif k == Kind.UINT64:
        if comparable:
            buf.append(UINT_FLAG)
            num.encode_u64(buf, d.val)
        else:
            buf.append(UVARINT_FLAG)
            num.encode_uvarint(buf, d.val)
    elif k == Kind.FLOAT64:
        buf.append(FLOAT_FLAG)
        num.encode_u64(buf, num.encode_float_to_cmp_u64(d.val))
    elif k in (Kind.STRING, Kind.BYTES):
        data = d.get_bytes()
        if comparable:
            buf.append(BYTES_FLAG)
            bc.encode_bytes(buf, data)
        else:
            buf.append(COMPACT_BYTES_FLAG)
            bc.encode_compact_bytes(buf, data)
    elif k == Kind.DECIMAL:
        buf.append(DECIMAL_FLAG)
        _encode_decimal(buf, d.val)
    elif k == Kind.DURATION:
        buf.append(DURATION_FLAG)
        num.encode_u64(buf, num.encode_int_to_cmp_uint(d.val.nanos))
    elif k == Kind.TIME:
        buf.append(TIME_FLAG)
        num.encode_u64(buf, d.val.to_packed_int())
    else:
        raise ValueError(f"cannot encode datum kind {k!r}")


def encode_key(datums) -> bytes:
    buf = bytearray()
    for d in datums:
        encode_datum(buf, d, comparable=True)
    return bytes(buf)


def encode_value(datums) -> bytes:
    buf = bytearray()
    for d in datums:
        encode_datum(buf, d, comparable=False)
    return bytes(buf)


def decode_one(data: memoryview, pos: int = 0) -> tuple[Datum, int]:
    try:
        return _decode_one(data, pos)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated or malformed encoded datum at {pos}: {e}") from e


def _decode_one(data: memoryview, pos: int) -> tuple[Datum, int]:
    flag = data[pos]
    pos += 1
    if flag == NIL_FLAG:
        return NULL, pos
    if flag == MAX_FLAG:
        return MAX_VALUE, pos
    if flag == INT_FLAG:
        u, pos = num.decode_u64(data, pos)
        return Datum.i64(num.decode_cmp_uint_to_int(u)), pos
    if flag == VARINT_FLAG:
        v, pos = num.decode_varint(data, pos)
        return Datum.i64(v), pos
    if flag == UINT_FLAG:
        u, pos = num.decode_u64(data, pos)
        return Datum.u64(u), pos
    if flag == UVARINT_FLAG:
        u, pos = num.decode_uvarint(data, pos)
        return Datum.u64(u), pos
    if flag == FLOAT_FLAG:
        u, pos = num.decode_u64(data, pos)
        return Datum.f64(num.decode_cmp_u64_to_float(u)), pos
    if flag == BYTES_FLAG:
        if pos >= len(data):
            return MIN_NOT_NULL, pos
        b, pos = bc.decode_bytes(data, pos)
        return Datum.bytes_(b), pos
    if flag == COMPACT_BYTES_FLAG:
        b, pos = bc.decode_compact_bytes(data, pos)
        return Datum.bytes_(b), pos
    if flag == DECIMAL_FLAG:
        dec, pos = _decode_decimal(data, pos)
        return Datum.dec(dec), pos
    if flag == DURATION_FLAG:
        u, pos = num.decode_u64(data, pos)
        return Datum(Kind.DURATION, Duration(num.decode_cmp_uint_to_int(u))), pos
    if flag == TIME_FLAG:
        u, pos = num.decode_u64(data, pos)
        return Datum(Kind.TIME, Time.from_packed_int(u)), pos
    raise ValueError(f"invalid encoded datum flag {flag}")


def decode_all(data: bytes) -> list[Datum]:
    mv = memoryview(data)
    pos = 0
    out = []
    while pos < len(mv):
        d, pos = decode_one(mv, pos)
        out.append(d)
    return out


# ---- decimal ----

def _encode_decimal(buf: bytearray, dec: Decimal) -> None:
    # NB: not Decimal.normalize() — that rounds to context precision (28
    # significant digits by default) and would silently corrupt long decimals.
    sign, digits, exponent = dec.as_tuple()
    # strip trailing zeros so equal values share one canonical encoding
    dl = list(digits)
    while len(dl) > 1 and dl[-1] == 0:
        dl.pop()
        exponent += 1
    if dl == [0]:
        buf.append(0x01)
        return
    exp = exponent + len(dl)  # value = 0.d1..dn * 10^exp
    if sign == 0:
        buf.append(0x02)
        num.encode_u64(buf, num.encode_int_to_cmp_uint(exp))
        buf += bytes(d + 1 for d in dl)
        buf.append(0x00)
    else:
        buf.append(0x00)
        start = len(buf)
        num.encode_u64(buf, num.encode_int_to_cmp_uint(exp))
        buf += bytes(d + 1 for d in dl)
        buf.append(0x00)
        for i in range(start, len(buf)):
            buf[i] ^= 0xFF


def _decode_decimal(data: memoryview, pos: int) -> tuple[Decimal, int]:
    sign_byte = data[pos]
    pos += 1
    if sign_byte == 0x01:
        return Decimal(0), pos
    neg = sign_byte == 0x00
    term = 0xFF if neg else 0x00
    end = pos + 8  # skip the fixed-width exponent, which may contain term bytes
    while data[end] != term:
        end += 1
    if neg:
        raw = bytes(b ^ 0xFF for b in data[pos : end + 1])
    else:
        raw = bytes(data[pos : end + 1])
    u = int.from_bytes(raw[:8], "big")
    exp = num.decode_cmp_uint_to_int(u)
    digit_bytes = raw[8:-1]
    digits = tuple(b - 1 for b in digit_bytes)
    # construct from the tuple directly: Decimal arithmetic (scaleb, unary -)
    # would round to context precision and corrupt long mantissas
    val = Decimal((1 if neg else 0, digits, exp - len(digits)))
    return val, end + 1
