"""Coprocessor wire protocol (copy of tidb_tpu/copr/proto.py)."""
