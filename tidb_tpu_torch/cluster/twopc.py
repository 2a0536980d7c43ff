"""Percolator two-phase commit (the port of
tidb_tpu/cluster/twopc.py:17-165, without the binlog, the retry ladder and
the lock resolver: a prewrite that meets a lock raises KeyIsLockedError
after rolling the transaction's locks back).

Mutations group by region and split into batches of at most
MAX_BATCH_BYTES; the primary's batch is prewritten first; the commit
timestamp comes from the oracle; the primary commits alone, then the rest
of its batch, then every other batch. Each kv_commit call appends one
entry to the MVCC per-table commit log, and the delta tier checks its
packs against that log entry by entry (copr.delta DeltaStore.usable), so
this grouping is part of the contract.

Reference: store/tikv/2pc.go.
"""

from __future__ import annotations

from tidb_tpu_torch import errors

MAX_BATCH_BYTES = 512 * 1024  # appendBatchBySize (2pc.go:514)
LOCK_TTL_MS = 3000


class TwoPhaseCommitter:
    def __init__(self, store, start_ts: int,
                 mutations: dict[bytes, bytes | None]):
        """mutations: key → value (None = delete)."""
        self.store = store
        self.start_ts = start_ts
        self.mutations = mutations
        self.keys = sorted(mutations)
        self.primary = self.keys[0]
        self.committed = False

    def _batches(self, keys: list[bytes]):
        """Group by region, then cap batches by byte size."""
        for _region, group in self.store.cache.group_keys_by_region(keys):
            batch: list[bytes] = []
            size = 0
            for k in group:
                v = self.mutations.get(k)
                ksize = len(k) + (len(v) if v else 0)
                if batch and size + ksize > MAX_BATCH_BYTES:
                    yield batch
                    batch, size = [], 0
                batch.append(k)
                size += ksize
            if batch:
                yield batch

    def _region(self, keys: list[bytes]):
        return self.store.cache.locate(keys[0])

    def _prewrite_batch(self, keys: list[bytes]) -> None:
        muts = []
        for k in keys:
            v = self.mutations[k]
            muts.append(("delete", k, None) if v is None else ("put", k, v))
        self.store.rpc.kv_prewrite(self._region(keys), muts, self.primary,
                                   self.start_ts, LOCK_TTL_MS)

    def _commit_batch(self, keys: list[bytes], commit_ts: int) -> None:
        self.store.rpc.kv_commit(self._region(keys), keys, self.start_ts,
                                 commit_ts)

    def _cleanup(self) -> None:
        for batch in self._batches(self.keys):
            self.store.rpc.kv_rollback(self._region(batch), batch,
                                       self.start_ts)

    def execute(self) -> int:
        """Returns commit_ts (2pc.go:406 execute)."""
        # phase 1: prewrite, the primary's batch first (it IS the txn
        # record)
        try:
            primary_done = False
            for batch in self._batches(self.keys):
                if not primary_done and self.primary in batch:
                    self._prewrite_batch(batch)
                    primary_done = True
            for batch in self._batches(self.keys):
                if self.primary not in batch:
                    self._prewrite_batch(batch)
        except errors.TiDBError:
            self._cleanup()
            raise

        commit_ts = self.store.oracle.current_version()

        # phase 2: the primary first — once it lands the txn IS committed
        try:
            for batch in self._batches(self.keys):
                if self.primary in batch:
                    self._commit_batch([self.primary], commit_ts)
                    # the flag flips HERE: a failure on the same batch's
                    # remainder must never roll back a transaction whose
                    # primary already landed
                    self.committed = True
                    rest = [k for k in batch if k != self.primary]
                    if rest:
                        self._commit_batch(rest, commit_ts)
                    break
        except errors.TiDBError:
            if not self.committed:
                self._cleanup()
            raise
        for batch in self._batches(self.keys):
            if self.primary in batch:
                continue
            self._commit_batch(batch, commit_ts)
        return commit_ts
