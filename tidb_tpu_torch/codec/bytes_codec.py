"""Memcomparable bytes encoding (copy of tidb_tpu/codec/bytes_codec.py).

Reference: util/codec/bytes.go:46,119 (EncodeBytes/DecodeBytes). Layout:
the input is split into 8-byte groups; each group is padded with 0x00 to 8
bytes and followed by a marker byte = 0xFF - pad_count, so that shorter
prefixes sort before longer strings while preserving memcmp order.
"""

from __future__ import annotations

ENC_GROUP_SIZE = 8
ENC_MARKER = 0xFF
ENC_PAD = 0x00


def encode_bytes(buf: bytearray, data: bytes) -> None:
    n = len(data)
    for i in range(0, n + 1, ENC_GROUP_SIZE):
        group = data[i : i + ENC_GROUP_SIZE]
        pad = ENC_GROUP_SIZE - len(group)
        buf += group
        if pad:
            buf += bytes(pad)
            buf.append(ENC_MARKER - pad)
            return
        buf.append(ENC_MARKER)
    # n % 8 == 0 handled by the loop's final empty group (i == n)


def decode_bytes(data: memoryview, pos: int) -> tuple[bytes, int]:
    out = bytearray()
    while True:
        group = data[pos : pos + ENC_GROUP_SIZE + 1]
        if len(group) < ENC_GROUP_SIZE + 1:
            raise ValueError("insufficient bytes to decode")
        marker = group[ENC_GROUP_SIZE]
        pos += ENC_GROUP_SIZE + 1
        if marker == ENC_MARKER:
            out += group[:ENC_GROUP_SIZE]
            continue
        pad = ENC_MARKER - marker
        if pad > ENC_GROUP_SIZE:
            raise ValueError(f"invalid bytes marker {marker}")
        real = ENC_GROUP_SIZE - pad
        out += group[:real]
        for b in group[real:ENC_GROUP_SIZE]:
            if b != ENC_PAD:
                raise ValueError("invalid padding byte")
        return bytes(out), pos


# ---- compact (value) encoding: varint length + raw bytes ----

from tidb_tpu_torch.codec.number import encode_varint, decode_varint  # noqa: E402


def encode_compact_bytes(buf: bytearray, data: bytes) -> None:
    encode_varint(buf, len(data))
    buf += data


def decode_compact_bytes(data: memoryview, pos: int) -> tuple[bytes, int]:
    n, pos = decode_varint(data, pos)
    if n < 0 or pos + n > len(data):
        raise ValueError("insufficient bytes for compact decode")
    return bytes(data[pos : pos + n]), pos + n
