"""Per-region plane cache (the port of tidb_tpu/copr/plane_cache.py:93-412
without the metrics, the failpoint, the kill switch and the index
entries): a region's packed ColumnBatch for one (table, column set,
clipped ranges) stays cached across statements, its planes pinned on the
device, so a repeat statement reads HBM without repacking or moving rows.

An entry's full key is base_key + (epoch, version): base_key =
(region_id, table_id, column signature, range bounds) as
copr.columnar_region.cache_key builds it, the region's epoch, and the
table's data version it was packed at. A lookup serves only the entry of
its epoch and version; on a miss it sweeps the region's entries of
another epoch and the same base's older generations, except

* the newest older generation that `base_ok` accepts, which comes back
  as the base of a base + delta merge (copr.delta), and
* generations at or above `keep_version`, the version the oldest active
  reader sees, which that reader can still hit verbatim.

LRU under a byte budget. The HBM ledger charges the pinned planes
(kernels.batch_planes).
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
    __slots__ = ("batch", "nbytes", "epoch", "version", "table_id")

    def __init__(self, batch, nbytes: int, epoch, version: int,
                 table_id: int):
        self.batch = batch
        self.nbytes = nbytes
        self.epoch = epoch
        self.version = version
        self.table_id = table_id


class PlaneCache:
    """Byte-budget LRU of per-region packed batches, pinned on `device`
    at insert. Thread-safe."""

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES,
                 device=None):
        self.budget_bytes = budget_bytes
        self.device = device
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # region id → its entries' full keys (the per-region sweep)
        self._by_region: dict[int, set] = {}
        # table id → {region id: live entries}: where a commit's delta
        # has a base to merge over (copr.delta)
        self._base_tables: dict[int, dict[int, int]] = {}
        self._bytes = 0
        self.stats = {"hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
                      "invalidations": 0, "kept_active": 0, "rekeys": 0}

    def lookup(self, base_key: tuple, epoch, version: int):
        """The cached batch for this key at this epoch and version, or
        None. Entries of another epoch and older generations are dead and
        dropped."""
        return self.lookup_with_base(base_key, epoch, version, None)[0]

    def lookup_with_base(self, base_key: tuple, epoch, version: int,
                         base_ok, keep_version: int | None = None):
        """(batch, delta_base): batch on an exact hit, else None, with
        delta_base = (older batch, its version) when `base_ok(version)`
        accepts an older generation of the same base (the newest such),
        else None. See the module docstring for the sweep."""
        full_key = base_key + (epoch, version)
        with self._lock:
            ent = self._entries.get(full_key)
            if ent is not None:
                self._entries.move_to_end(full_key)
                self.stats["hits"] += 1
                return ent.batch, None
            self.stats["misses"] += 1
            stale = []
            for fk in list(self._by_region.get(base_key[0], ())):
                e = self._entries.get(fk)
                if e is None:
                    continue
                if e.epoch != epoch:
                    self._remove(fk)
                    self.stats["invalidations"] += 1
                elif fk[:-2] == base_key and e.version < version:
                    stale.append((fk, e))
            base_ent = None
            if base_ok is not None:
                for _fk, e in stale:
                    if (base_ent is None or e.version > base_ent.version) \
                            and base_ok(e.version):
                        base_ent = e
            for fk, e in stale:
                if e is base_ent:
                    continue
                if keep_version is not None and e.version >= keep_version:
                    self.stats["kept_active"] += 1
                    continue
                self._remove(fk)
                self.stats["invalidations"] += 1
            base = (base_ent.batch, base_ent.version) \
                if base_ent is not None else None
            return None, base

    def insert(self, base_key: tuple, epoch, version: int, batch) -> None:
        """Admit a batch, pin its planes on the cache's device, and evict
        least recently used entries down to the budget."""
        nbytes = batch_nbytes(batch)
        if nbytes > self.budget_bytes:
            return
        pin_batch_device(batch, self.device)
        full_key = base_key + (epoch, version)
        with self._lock:
            if full_key in self._entries:
                self._remove(full_key)
            self._add(full_key, _Entry(batch, nbytes, epoch, version,
                                       base_key[1]))
            self._bytes += nbytes
            self.stats["inserts"] += 1
            while self._bytes > self.budget_bytes:
                self._remove(next(iter(self._entries)))
                self.stats["evictions"] += 1

    def rekey(self, base_key: tuple, epoch, old_version: int,
              new_version: int) -> bool:
        """Move an entry to a new version under the same base key: the
        version-only delta (other-region commits of the table) leaves the
        visible planes identical, so the batch moves without being
        re-admitted. False when the old entry is gone."""
        full_old = base_key + (epoch, old_version)
        full_new = base_key + (epoch, new_version)
        with self._lock:
            ent = self._entries.get(full_old)
            if ent is None:
                return False
            self._remove(full_old)
            if full_new in self._entries:
                self._remove(full_new)
            ent.version = new_version
            self._add(full_new, ent)
            self._bytes += ent.nbytes
            self.stats["rekeys"] += 1
            return True

    def regions_with_table(self, table_id: int) -> list[int]:
        """Region ids holding live cached entries of table_id: a commit's
        delta is appended only where a base exists to merge over."""
        with self._lock:
            return list(self._base_tables.get(table_id, ()))

    # ---- internals (lock held) ----

    def _add(self, full_key: tuple, ent: _Entry) -> None:
        self._entries[full_key] = ent
        self._by_region.setdefault(full_key[0], set()).add(full_key)
        regs = self._base_tables.setdefault(ent.table_id, {})
        regs[full_key[0]] = regs.get(full_key[0], 0) + 1

    def _remove(self, full_key: tuple) -> None:
        ent = self._entries.pop(full_key)
        self._bytes -= ent.nbytes
        keys = self._by_region.get(full_key[0])
        if keys is not None:
            keys.discard(full_key)
            if not keys:
                del self._by_region[full_key[0]]
        regs = self._base_tables.get(ent.table_id)
        if regs is not None:
            n = regs.get(full_key[0], 0) - 1
            if n > 0:
                regs[full_key[0]] = n
            else:
                regs.pop(full_key[0], None)
                if not regs:
                    del self._base_tables[ent.table_id]
