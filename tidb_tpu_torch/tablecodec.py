"""Table key/value layout over the KV store (copy of tidb_tpu/tablecodec).

  rowkey    = 't' + enc_int(tableID) + '_r' + enc_int(handle)
  row value = interleaved [colID datum, value datum] pairs, compact

enc_int is the order-preserving comparable int encoding, so handle order ==
key order.
"""

from __future__ import annotations

import struct

from tidb_tpu_torch import errors
from tidb_tpu_torch.codec import codec as cdc
from tidb_tpu_torch.codec import number as num
from tidb_tpu_torch.types.datum import Datum

TABLE_PREFIX = b"t"
ROW_PREFIX_SEP = b"_r"
# 't' + enc_int(table_id): the prefix a table's record and index keys share
TABLE_PREFIX_LEN = 10
# the bucket of every key outside a table (meta keys)
META_BUCKET = b"m"

_INT_KEY_STRUCT = struct.Struct(">BQ")


def _enc_int(v: int) -> bytes:
    """Comparable-int key encoding (flag + sign-flipped BE)."""
    return _INT_KEY_STRUCT.pack(cdc.INT_FLAG,
                                (v & num.U64_MASK) ^ num.SIGN_MASK)


def _dec_int(data: bytes, pos: int) -> tuple[int, int]:
    if data[pos] != cdc.INT_FLAG:
        raise ValueError("invalid int flag in key")
    u, pos2 = num.decode_u64(memoryview(data), pos + 1)
    return num.decode_cmp_uint_to_int(u), pos2


def table_record_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + _enc_int(table_id) + ROW_PREFIX_SEP


def table_prefix(table_id: int) -> bytes:
    return TABLE_PREFIX + _enc_int(table_id)


def table_prefix_of(key: bytes) -> bytes:
    """The table-prefix bucket of one encoded key: the 10-byte
    't' + enc_int(table_id) prefix shared by a table's record and index
    keys, or META_BUCKET for meta and other non-table keys. The bucketing
    rule of per-table commit filtering (cluster.mvcc, copr.delta)."""
    if key[:1] == TABLE_PREFIX and len(key) >= TABLE_PREFIX_LEN:
        return bytes(key[:TABLE_PREFIX_LEN])
    return META_BUCKET


def decode_table_id(key: bytes) -> int:
    if not key.startswith(TABLE_PREFIX):
        raise ValueError(f"not a table key: {key!r}")
    tid, _ = _dec_int(key, 1)
    return tid


def encode_row_key(table_id: int, handle: int) -> bytes:
    return table_record_prefix(table_id) + _enc_int(handle)


def decode_row_key(key: bytes) -> tuple[int, int]:
    """key → (table_id, handle)."""
    if not key.startswith(TABLE_PREFIX):
        raise ValueError(f"not a record key: {key!r}")
    tid, pos = _dec_int(key, 1)
    if key[pos : pos + 2] != ROW_PREFIX_SEP:
        raise ValueError(f"not a record key: {key!r}")
    handle, _ = _dec_int(key, pos + 2)
    return tid, handle


def encode_row(col_ids, datums) -> bytes:
    """Row value = [colID, value, colID, value, ...] compact-encoded. Empty
    rows encode as a single 0 byte so the KV layer never stores an empty
    value."""
    if len(col_ids) != len(datums):
        raise errors.TiDBError("encode_row: column/value count mismatch")
    if not col_ids:
        return bytes([cdc.NIL_FLAG])
    buf = bytearray()
    for cid, d in zip(col_ids, datums):
        cdc.encode_datum(buf, Datum.i64(cid), comparable=False)
        cdc.encode_datum(buf, d, comparable=False)
    return bytes(buf)


def decode_row(value: bytes) -> dict[int, Datum]:
    """Row value → {colID: datum}."""
    out: dict[int, Datum] = {}
    if not value or value == bytes([cdc.NIL_FLAG]):
        return out
    mv = memoryview(value)
    pos = 0
    while pos < len(mv):
        cid_d, pos = cdc.decode_one(mv, pos)
        if pos >= len(mv):
            raise ValueError("truncated row value")
        val_d, pos = cdc.decode_one(mv, pos)
        out[cid_d.get_int()] = val_d
    return out


def encode_record_range(table_id: int) -> tuple[bytes, bytes]:
    """[start, end) covering all records of a table."""
    prefix = table_record_prefix(table_id)
    return prefix, prefix + b"\xff" * 9
