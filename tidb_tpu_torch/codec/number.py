"""Integer/float order-preserving encodings (copy of tidb_tpu/codec/number.py).

Reference: util/codec/number.go:34-148 (EncodeInt/EncodeUint/EncodeFloat and
comparable transforms), util/codec/float.go. int64 maps to uint64 by flipping
the sign bit so memcmp order equals numeric order; floats use the IEEE trick
(non-negative: set sign bit; negative: flip all bits).
"""

from __future__ import annotations

import struct

SIGN_MASK = 0x8000000000000000
U64_MASK = 0xFFFFFFFFFFFFFFFF

_u64 = struct.Struct(">Q")
_f64 = struct.Struct(">d")


def encode_int_to_cmp_uint(v: int) -> int:
    return (v & U64_MASK) ^ SIGN_MASK


def decode_cmp_uint_to_int(u: int) -> int:
    u ^= SIGN_MASK
    if u & SIGN_MASK:
        return u - (1 << 64)
    return u


def encode_u64(buf: bytearray, v: int) -> None:
    buf += _u64.pack(v & U64_MASK)


def decode_u64(data: memoryview, pos: int) -> tuple[int, int]:
    return _u64.unpack_from(data, pos)[0], pos + 8



def encode_float_to_cmp_u64(f: float) -> int:
    if f == 0.0:
        f = 0.0  # normalize -0.0 so equal floats share one encoding
    (u,) = _u64.unpack(_f64.pack(f))
    if u & SIGN_MASK:
        u = (~u) & U64_MASK
    else:
        u |= SIGN_MASK
    return u


def decode_cmp_u64_to_float(u: int) -> float:
    if u & SIGN_MASK:
        u &= ~SIGN_MASK & U64_MASK
    else:
        u = (~u) & U64_MASK
    return _f64.unpack(_u64.pack(u))[0]


# ---- varints (value encoding; protobuf zig-zag style, number.go EncodeVarint) ----

def encode_uvarint(buf: bytearray, v: int) -> None:
    v &= U64_MASK
    while v >= 0x80:
        buf.append((v & 0x7F) | 0x80)
        v >>= 7
    buf.append(v)


def decode_uvarint(data: memoryview, pos: int) -> tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & U64_MASK, pos
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


def encode_varint(buf: bytearray, v: int) -> None:
    # zig-zag
    encode_uvarint(buf, ((v << 1) ^ (v >> 63)) & U64_MASK)


def decode_varint(data: memoryview, pos: int) -> tuple[int, int]:
    u, pos = decode_uvarint(data, pos)
    v = (u >> 1) ^ (-(u & 1) & U64_MASK)
    if v & SIGN_MASK:
        v -= 1 << 64
    return v, pos
