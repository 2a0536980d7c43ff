"""A read-only, sorted, in-memory KV snapshot.

The in-process path (GpuClient) reads it: the store is built once from
raw (key, value) pairs (for example the rows a reference store committed,
or rows encoded by `tablecodec`) and every snapshot sees all of them. The
cluster store (cluster.store.DistStore) takes writes through its own MVCC
store.
"""

from __future__ import annotations

import bisect

from tidb_tpu_torch.kv import kv


class MemSnapshot(kv.Snapshot):
    def __init__(self, keys: list[bytes], values: list[bytes]):
        self._keys = keys
        self._values = values

    def iterate(self, start: bytes, end: bytes | None = None):
        i = bisect.bisect_left(self._keys, start)
        j = len(self._keys) if end is None else bisect.bisect_left(self._keys, end)
        for k in range(i, j):
            yield self._keys[k], self._values[k]


class MemStore:
    def __init__(self, keys: list[bytes], values: list[bytes]):
        self._snap = MemSnapshot(keys, values)

    @classmethod
    def from_pairs(cls, pairs) -> "MemStore":
        items = sorted((bytes(k), bytes(v)) for k, v in pairs)
        keys = [k for k, _ in items]
        for a, b in zip(keys, keys[1:]):
            if a == b:
                raise ValueError(f"duplicate key {a!r}")
        return cls(keys, [v for _, v in items])

    def get_snapshot(self, ts: int | None = None) -> MemSnapshot:
        return self._snap

    def data_version_at(self, ts: int, prefix: bytes) -> int:
        """Version of a table's data as seen at `ts`: constant, since the
        store never changes after it is built."""
        return 0
