"""Order-preserving binary codec — the storage wire format (copy of
tidb_tpu/codec)."""

from tidb_tpu_torch.codec.codec import (  # noqa: F401
    decode_all,
    decode_one,
    encode_datum,
    encode_key,
    encode_value,
)
