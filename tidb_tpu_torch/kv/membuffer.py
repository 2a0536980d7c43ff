"""In-memory sorted write buffer (copy of tidb_tpu/kv/membuffer.py).

A dict plus a lazily re-sorted key list: writes are O(1), the sorted view
is rebuilt only when iteration follows a write. Deletions are tombstones
(empty value) so UnionStore can shadow snapshot keys.

Reference: kv/memdb_buffer.go.
"""

from __future__ import annotations

import bisect
from typing import Iterator

from tidb_tpu_torch import errors
from tidb_tpu_torch.kv.kv import Mutator, Retriever

TOMBSTONE = b""


class MemBuffer(Retriever, Mutator):
    __slots__ = ("_data", "_sorted", "_dirty")

    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._sorted: list[bytes] = []
        self._dirty = False

    def get(self, key: bytes) -> bytes:
        try:
            v = self._data[key]
        except KeyError:
            raise errors.KeyNotExistsError(f"key not exist: {key!r}") from None
        if v == TOMBSTONE:
            raise errors.KeyNotExistsError(f"key deleted: {key!r}")
        return v

    def get_raw(self, key: bytes) -> bytes | None:
        """Tombstone-visible get (None = never written, b'' = deleted)."""
        return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self._data:
            self._dirty = True
        self._data[key] = value

    def delete(self, key: bytes) -> None:
        self.set(key, TOMBSTONE)

    def _view(self) -> list[bytes]:
        if self._dirty:
            self._sorted = sorted(self._data)
            self._dirty = False
        return self._sorted

    def iterate(self, start: bytes = b"", end: bytes | None = None,
                include_tombstones: bool = False) -> Iterator[tuple[bytes, bytes]]:
        view = self._view()
        i = bisect.bisect_left(view, start)
        while i < len(view):
            k = view[i]
            if end is not None and k >= end:
                return
            v = self._data[k]
            if include_tombstones or v != TOMBSTONE:
                yield k, v
            i += 1
