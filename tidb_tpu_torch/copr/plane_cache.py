"""Per-region plane cache (the port of tidb_tpu/copr/plane_cache.py:93-412,
cut down): a region's packed ColumnBatch for one (table, column set,
clipped ranges) stays cached across statements, its planes pinned on the
device, so a repeat statement reads HBM without repacking or moving rows.

Key: base_key = (region_id, table_id, column signature, range bounds) as
copr.columnar_region.cache_key builds it; an entry also holds the
region's epoch and the data version it was packed at, and serves only a
lookup that presents both. LRU under a byte budget. The reference's
HTAP delta merge, keep set, lock gate and HBM ledger are not ported.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from tidb_tpu_torch.ops import kernels

DEFAULT_BUDGET_BYTES = 8 << 30


def batch_nbytes(batch) -> int:
    """Byte footprint of one cached batch (planes + dictionaries)."""
    n = int(batch.handles.nbytes)
    for cd in batch.columns.values():
        n += int(cd.values.nbytes) + int(cd.valid.nbytes)
        if cd.dictionary:
            n += sum(len(b) for b in cd.dictionary) + 64 * len(cd.dictionary)
    return n


def pin_batch_device(batch, device) -> None:
    """Move the batch's planes to `device` once (kernels.batch_planes
    memoizes them on the batch); a CPU device pins nothing."""
    if device is not None and device.type == "cuda":
        kernels.batch_planes(batch, device)


class _Entry:
    __slots__ = ("batch", "nbytes", "epoch", "version")

    def __init__(self, batch, nbytes: int, epoch, version: int):
        self.batch = batch
        self.nbytes = nbytes
        self.epoch = epoch
        self.version = version


class PlaneCache:
    """Byte-budget LRU of per-region packed batches, pinned on `device`
    at insert. Thread-safe."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 device=None):
        self.budget_bytes = budget_bytes
        self.device = device
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self.stats = {"hits": 0, "misses": 0, "inserts": 0, "evictions": 0}

    def lookup(self, base_key: tuple, epoch, version: int):
        """The cached batch for this key at this epoch and version, or
        None. An entry of another epoch or an older version is dead and
        dropped."""
        with self._lock:
            ent = self._entries.get(base_key)
            if ent is not None and (ent.epoch != epoch
                                    or ent.version < version):
                self._drop(base_key)
                ent = None
            if ent is None or ent.version != version:
                self.stats["misses"] += 1
                return None
            self._entries.move_to_end(base_key)
            self.stats["hits"] += 1
            return ent.batch

    def insert(self, base_key: tuple, epoch, version: int, batch) -> None:
        """Admit a batch, pin its planes on the cache's device, and evict
        least recently used entries down to the budget."""
        nbytes = batch_nbytes(batch)
        if nbytes > self.budget_bytes:
            return
        pin_batch_device(batch, self.device)
        with self._lock:
            if base_key in self._entries:
                self._drop(base_key)
            self._entries[base_key] = _Entry(batch, nbytes, epoch, version)
            self._bytes += nbytes
            self.stats["inserts"] += 1
            while self._bytes > self.budget_bytes:
                self._drop(next(iter(self._entries)))
                self.stats["evictions"] += 1

    def _drop(self, key: tuple) -> None:
        ent = self._entries.pop(key)
        self._bytes -= ent.nbytes
