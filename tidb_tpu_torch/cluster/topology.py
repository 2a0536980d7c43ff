"""Cluster topology: stores, regions and their peers (copy of
tidb_tpu/cluster/topology.py:19-118 without leader moves and merges: the
port's topology is fixed once the store is built).

Reference: store/tikv/mock-tikv/cluster.go (:33 Cluster, :142 Split).
"""

from __future__ import annotations

import bisect
import itertools
import threading
from dataclasses import dataclass


@dataclass
class Peer:
    peer_id: int
    store_id: int


@dataclass
class Region:
    region_id: int
    start: bytes
    end: bytes | None
    peers: list[Peer]
    leader_peer_id: int
    conf_ver: int = 1
    version: int = 1          # bumped on split (epoch)

    def epoch(self) -> tuple[int, int]:
        return (self.conf_ver, self.version)

    def contains(self, key: bytes) -> bool:
        return key >= self.start and (self.end is None or key < self.end)


class Cluster:
    def __init__(self, n_stores: int = 3, replicas: int = 3):
        self._id = itertools.count(1)
        self._lock = threading.RLock()
        self.stores: dict[int, str] = {}
        for _ in range(n_stores):
            sid = next(self._id)
            self.stores[sid] = f"store{sid}"
        self.replicas = min(replicas, n_stores)
        self.regions: list[Region] = [self._new_region(b"", None)]

    def _new_region(self, start: bytes, end: bytes | None) -> Region:
        rid = next(self._id)
        store_ids = list(self.stores)
        peers = [Peer(next(self._id), store_ids[i % len(store_ids)])
                 for i in range(self.replicas)]
        return Region(rid, start, end, peers, peers[0].peer_id)

    def region_by_key(self, key: bytes) -> Region:
        with self._lock:
            return self.regions[self._locate(key)]

    def _locate(self, key: bytes) -> int:
        starts = [r.start for r in self.regions]
        return max(bisect.bisect_right(starts, key) - 1, 0)

    def split(self, key: bytes) -> None:
        with self._lock:
            i = self._locate(key)
            r = self.regions[i]
            if r.start == key:
                return
            right = self._new_region(key, r.end)
            r.end = key
            r.version += 1
            right.version = r.version
            self.regions.insert(i + 1, right)

    def split_keys(self, keys) -> None:
        for k in sorted(keys):
            self.split(k)
