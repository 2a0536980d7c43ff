"""Region routing for the coprocessor client (copy of
tidb_tpu/cluster/client.py:36-113 RegionCache, without the stale-epoch
and not-leader handling: the port's topology is static for a
statement).

Reference: store/tikv/region_cache.go.
"""

from __future__ import annotations

from tidb_tpu_torch.cluster.topology import Cluster, Region


class RegionCache:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def locate(self, key: bytes) -> Region:
        return self.cluster.region_by_key(key)

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
