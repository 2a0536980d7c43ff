"""KV boundary (copy of tidb_tpu/kv/kv.py), the write buffer and union
store of a transaction, and a read-only memory store."""
