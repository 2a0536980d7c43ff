"""UnionStore: a private write buffer overlaid on a snapshot (copy of
tidb_tpu/kv/union_store.py without the PresumeKeyNotExists lazy
conditions, which only the SQL INSERT path sets, and without reverse
iteration: the port has neither yet).

Reference: kv/union_store.go:24-203 and kv/union_iter.go (merged
dirty + snapshot iteration).
"""

from __future__ import annotations

from typing import Iterator

from tidb_tpu_torch import errors
from tidb_tpu_torch.kv.kv import Mutator, Retriever, Snapshot
from tidb_tpu_torch.kv.membuffer import MemBuffer, TOMBSTONE


class UnionStore(Retriever, Mutator):
    def __init__(self, snapshot: Snapshot):
        self.snapshot = snapshot
        self.buffer = MemBuffer()

    def get(self, key: bytes) -> bytes:
        v = self.buffer.get_raw(key)
        if v is not None:
            if v == TOMBSTONE:
                raise errors.KeyNotExistsError(f"key deleted: {key!r}")
            return v
        return self.snapshot.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        self.buffer.set(key, value)

    def delete(self, key: bytes) -> None:
        self.buffer.delete(key)

    def iterate(self, start: bytes = b"", end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Merged ascending iteration; the buffer shadows the snapshot."""
        return _merge(self.buffer.iterate(start, end, include_tombstones=True),
                      self.snapshot.iterate(start, end))


def _merge(dirty_it, snap_it) -> Iterator[tuple[bytes, bytes]]:
    """Two-way ordered merge where the dirty side wins on equal keys and
    tombstones suppress snapshot entries."""
    sentinel = object()

    def nxt(it):
        return next(it, sentinel)

    d, s = nxt(dirty_it), nxt(snap_it)
    while d is not sentinel or s is not sentinel:
        if s is sentinel:
            take_dirty = True
        elif d is sentinel:
            take_dirty = False
        else:
            if d[0] == s[0]:
                s = nxt(snap_it)  # shadowed
                continue
            take_dirty = d[0] < s[0]
        if take_dirty:
            k, v = d
            d = nxt(dirty_it)
            if v != TOMBSTONE:
                yield k, v
        else:
            yield s
            s = nxt(snap_it)
