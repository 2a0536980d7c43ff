"""Percolator-style MVCC store: the storage node's transactional core
(the port of tidb_tpu/cluster/mvcc.py:69-303, without GC).

Three logical columns per key:
  data:  committed versions [(commit_ts, start_ts, value|None)]
  lock:  at most one uncommitted lock (primary, start_ts, ttl, kind, value)
  write: folded into data here (commit records carry start_ts)

Writes follow the Percolator protocol driven by the client's 2PC
(cluster/twopc.py): prewrite takes locks and buffers values, commit moves
the buffered value into the data column at commit_ts, rollback clears the
lock. A read at ts raises KeyIsLockedError on any lock with lock.start_ts
<= ts (the port has no lock resolver: the error reaches the caller).

Reference: store/tikv/mock-tikv/mvcc.go.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

from tidb_tpu_torch.errors import (KeyIsLockedError, LockInfo, TxnAborted,
                                   WriteConflict)
from tidb_tpu_torch.tablecodec import table_prefix_of


@dataclass
class _Versions:
    # parallel sorted-by-commit_ts lists (ascending)
    commit_ts: list[int] = field(default_factory=list)
    start_ts: list[int] = field(default_factory=list)
    values: list[bytes | None] = field(default_factory=list)  # None=delete


class MvccStore:
    """One per cluster store."""

    def __init__(self):
        self._lock = threading.RLock()
        self._data: dict[bytes, _Versions] = {}
        self._locks: dict[bytes, LockInfo] = {}
        # start_ts of explicitly rolled-back txns (rollback records)
        self._rollbacks: set[int] = set()
        self._sorted_keys: list[bytes] | None = []
        # ascending commit_ts of every commit batch (data_version_at)
        self._commit_log: list[int] = []
        self._max_commit_ts = 0
        # per-table-prefix twins of the commit log: a commit appends its
        # commit_ts under every table prefix it touches, so
        # data_version_at(ts, prefix) counts the commits that touched THIS
        # table — the plane cache's per-table version key
        self._table_log: dict[bytes, list[int]] = {}
        self._table_max: dict[bytes, int] = {}

    def load(self, pairs) -> None:
        """Bootstrap load: committed at timestamp 0, so visible at every
        read ts, and recorded in no commit log (every version stays 0)."""
        with self._lock:
            for k, v in pairs:
                k, v = bytes(k), bytes(v)
                if k in self._data:
                    raise ValueError(f"duplicate key {k!r}")
                self._data[k] = _Versions([0], [0], [v])
            self._sorted_keys = None

    def data_version_at(self, read_ts: int, prefix: bytes | None = None
                        ) -> int:
        """Count of commit events visible at read_ts: equal versions imply
        identical visible data. With `prefix` (a table_prefix_of bucket)
        only commits that touched that table's keyspace count, so a commit
        to table B never moves table A's version."""
        with self._lock:
            if prefix is None:
                if read_ts >= self._max_commit_ts:
                    return len(self._commit_log)
                return bisect.bisect_right(self._commit_log, read_ts)
            log = self._table_log.get(prefix)
            if log is None:
                return 0
            if read_ts >= self._table_max.get(prefix, 0):
                return len(log)
            return bisect.bisect_right(log, read_ts)

    def table_commits_between(self, prefix: bytes, v0: int,
                              v1: int) -> list[int]:
        """The commit_ts values of the table's commits (v0, v1]: positions
        v0..v1 of its sorted log. A cached base at table version v0 serves
        a reader at v1 only if its delta pack holds an entry for every one
        of these (copr.delta DeltaStore.usable)."""
        with self._lock:
            log = self._table_log.get(prefix, [])
            return list(log[v0:v1])

    # ---- reads ----

    def get(self, key: bytes, read_ts: int) -> bytes | None:
        with self._lock:
            self._check_lock(key, read_ts)
            return self._get_committed(key, read_ts)

    def _check_lock(self, key: bytes, read_ts: int) -> None:
        lock = self._locks.get(key)
        if lock is not None and lock.start_ts <= read_ts \
                and lock.kind != "lock":
            raise KeyIsLockedError(lock)

    def _get_committed(self, key: bytes, read_ts: int) -> bytes | None:
        vs = self._data.get(key)
        if vs is None:
            return None
        i = bisect.bisect_right(vs.commit_ts, read_ts) - 1
        if i < 0:
            return None
        return vs.values[i]

    def scan(self, start: bytes, end: bytes | None, read_ts: int,
             limit: int | None = None):
        """Committed (key, value) pairs in [start, end) visible at read_ts;
        raises KeyIsLockedError on a blocking lock."""
        with self._lock:
            out = []
            for k in self._keys_in_range(start, end):
                self._check_lock(k, read_ts)
                v = self._get_committed(k, read_ts)
                if v is not None:
                    out.append((k, v))
                    if limit is not None and len(out) >= limit:
                        break
            return out

    def _keys_in_range(self, start: bytes, end: bytes | None) -> list[bytes]:
        if self._sorted_keys is None:
            self._sorted_keys = sorted(set(self._data) | set(self._locks))
        keys = self._sorted_keys
        lo = bisect.bisect_left(keys, start)
        hi = bisect.bisect_left(keys, end) if end is not None else len(keys)
        return keys[lo:hi]

    # ---- percolator writes ----

    def prewrite(self, mutations: list[tuple[str, bytes, bytes | None]],
                 primary: bytes, start_ts: int, ttl_ms: int = 3000) -> None:
        """mutations: (op, key, value). A lock of another transaction →
        KeyIsLockedError; a newer committed write → WriteConflict."""
        with self._lock:
            # validate all first: prewrite is atomic per batch
            for op, key, value in mutations:
                lock = self._locks.get(key)
                if lock is not None and lock.start_ts != start_ts:
                    raise KeyIsLockedError(lock)
                vs = self._data.get(key)
                if vs and vs.commit_ts and vs.commit_ts[-1] >= start_ts:
                    raise WriteConflict(
                        f"write conflict on {key!r}: committed "
                        f"{vs.commit_ts[-1]} >= start_ts {start_ts}")
                if start_ts in self._rollbacks:
                    raise TxnAborted(f"txn {start_ts} already rolled back")
            for op, key, value in mutations:
                self._locks[key] = LockInfo(key, primary, start_ts, ttl_ms,
                                            op, value)
            self._sorted_keys = None

    def commit(self, keys: list[bytes], start_ts: int,
               commit_ts: int) -> list[tuple[bytes, bytes | None]]:
        """Commit the prewritten keys; returns the DATA mutations applied
        as (key, value|None) pairs (None = delete; 'lock' records apply
        nothing), which the delta-pack tier appends over cached base
        planes (copr.delta). The commit logs get ONE entry per call, under
        every table prefix the keys touch."""
        with self._lock:
            for key in keys:
                lock = self._locks.get(key)
                if lock is None or lock.start_ts != start_ts:
                    # already committed (idempotent retry) or rolled back
                    if self._committed_at(key, start_ts) is not None:
                        continue
                    raise TxnAborted(
                        f"commit of {key!r}@{start_ts}: lock missing")
            i = bisect.bisect_left(self._commit_log, commit_ts)
            self._commit_log.insert(i, commit_ts)
            if commit_ts > self._max_commit_ts:
                self._max_commit_ts = commit_ts
            for prefix in {table_prefix_of(k) for k in keys}:
                log = self._table_log.setdefault(prefix, [])
                log.insert(bisect.bisect_left(log, commit_ts), commit_ts)
                if commit_ts > self._table_max.get(prefix, 0):
                    self._table_max[prefix] = commit_ts
            applied: list[tuple[bytes, bytes | None]] = []
            for key in keys:
                lock = self._locks.pop(key, None)
                if lock is None or lock.start_ts != start_ts:
                    continue
                if lock.kind == "lock":
                    continue  # SELECT FOR UPDATE lock: no data write
                vs = self._data.setdefault(key, _Versions())
                i = bisect.bisect_left(vs.commit_ts, commit_ts)
                vs.commit_ts.insert(i, commit_ts)
                vs.start_ts.insert(i, start_ts)
                value = None if lock.kind == "delete" else lock.value
                vs.values.insert(i, value)
                applied.append((key, value))
            self._sorted_keys = None
            return applied

    def rollback(self, keys: list[bytes], start_ts: int) -> None:
        with self._lock:
            for key in keys:
                lock = self._locks.get(key)
                if lock is not None and lock.start_ts == start_ts:
                    del self._locks[key]
                elif self._committed_at(key, start_ts) is not None:
                    raise TxnAborted(
                        f"cannot roll back {key!r}@{start_ts}: committed")
            self._rollbacks.add(start_ts)
            self._sorted_keys = None

    def _committed_at(self, key: bytes, start_ts: int) -> int | None:
        vs = self._data.get(key)
        if vs is None:
            return None
        for cts, sts in zip(vs.commit_ts, vs.start_ts):
            if sts == start_ts:
                return cts
        return None

    # ---- lock inspection ----

    def txn_status(self, primary: bytes, start_ts: int) -> tuple[str, int]:
        """('committed', commit_ts) | ('rolled_back', 0) | ('locked', 0),
        read on the PRIMARY key (the Percolator source of truth)."""
        with self._lock:
            cts = self._committed_at(primary, start_ts)
            if cts is not None:
                return "committed", cts
            lock = self._locks.get(primary)
            if lock is not None and lock.start_ts == start_ts:
                return "locked", 0
            return "rolled_back", 0

    def has_blocking_lock(self, read_ts: int, start: bytes = b"",
                          end: bytes | None = None) -> bool:
        """Any READ-blocking lock (kind != 'lock') in [start, end) visible
        to a reader at read_ts: the plane cache's lock gate. A pending
        lock's commit_ts may have been allocated before read_ts, so
        serving cached planes past it could hide a commit the scan would
        meet. O(1) when no lock exists."""
        with self._lock:
            if not self._locks:
                return False
            for k, lock in self._locks.items():
                if lock.start_ts <= read_ts and lock.kind != "lock" \
                        and k >= start and (end is None or k < end):
                    return True
            return False

    def scan_locks(self, max_ts: int, start: bytes = b"",
                   end: bytes | None = None) -> list[LockInfo]:
        with self._lock:
            return [lk for k, lk in sorted(self._locks.items())
                    if lk.start_ts <= max_ts
                    and k >= start and (end is None or k < end)]
