"""Region routing and snapshot reads of the cluster store (copy of
tidb_tpu/cluster/client.py: RegionCache :36-113 without the stale-epoch
and not-leader handling, since the port's topology is static for a
statement, and DistSnapshot :201-258 without the lock resolver: a read
that meets a lock raises KeyIsLockedError).

Reference: store/tikv/region_cache.go, snapshot.go, scan.go.
"""

from __future__ import annotations

from tidb_tpu_torch import errors
from tidb_tpu_torch.cluster.topology import Cluster, Region
from tidb_tpu_torch.kv import kv


class RegionCache:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def locate(self, key: bytes) -> Region:
        return self.cluster.region_by_key(key)

    def group_keys_by_region(self, keys: list[bytes]):
        """[(region, sorted keys)] in key order (GroupKeysByRegion,
        region_cache.go:80)."""
        groups: dict[int, tuple[Region, list[bytes]]] = {}
        for k in sorted(keys):
            r = self.locate(k)
            groups.setdefault(r.region_id, (r, []))[1].append(k)
        return list(groups.values())

    def split_range_by_region(self, start: bytes, end: bytes | None):
        """[(region, lo, hi)] covering [start, end), one per region."""
        out = []
        key = start
        while True:
            r = self.locate(key)
            seg_end = r.end if end is None else (
                min(r.end, end) if r.end is not None else end)
            out.append((r, key, seg_end))
            if r.end is None or (end is not None and r.end >= end):
                return out
            key = r.end


class DistSnapshot(kv.Snapshot):
    """Reads at `version` through each key's region handler."""

    SCAN_BATCH = 256  # store/tikv/scan.go batch size

    def __init__(self, store, version: int):
        self.store = store
        self.version = version

    def get(self, key: bytes) -> bytes:
        v = self.get_or_none(key)
        if v is None:
            raise errors.KeyNotExistsError(f"key not found: {key!r}")
        return v

    def get_or_none(self, key: bytes):
        return self.store.rpc.kv_get(self.store.cache.locate(key), key,
                                     self.version)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        key = start
        while True:
            region = self.store.cache.locate(key)
            batch = self.store.rpc.kv_scan(region, key, end, self.version,
                                           self.SCAN_BATCH)
            yield from batch
            if len(batch) >= self.SCAN_BATCH:
                key = batch[-1][0] + b"\x00"
            elif region.end is not None and (end is None or region.end < end):
                key = region.end
            else:
                return
