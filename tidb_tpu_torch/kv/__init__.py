"""KV boundary (copy of tidb_tpu/kv/kv.py) and a read-only memory store."""
