"""The region side of the cluster store (the port of
tidb_tpu/cluster/rpc.py:66-101, :150-244, :279-301): the KV commands over
the MVCC store and the coprocessor request, which clips the request's
ranges to the region and answers with the columnar region engine through
an MVCC snapshot view.

A commit appends its row mutations to the region's delta packs after the
MVCC apply (kv_commit → DeltaStore.on_commit), so a scan that sees the new
version but not yet the delta entry re-packs, never answers wrong.

The port's topology is static, so no region error can occur and the
requests carry the Region itself instead of an epoch-checked context. The
reference falls back to the row handler for a region the columnar engine
cannot answer; the port has no row engine, so such a request raises
Unsupported.
"""

from __future__ import annotations

from tidb_tpu_torch import errors
from tidb_tpu_torch.cluster.mvcc import MvccStore
from tidb_tpu_torch.copr.columnar_region import handle_columnar_scan
from tidb_tpu_torch.copr.delta import DeltaStore
from tidb_tpu_torch.kv.kv import KeyRange
from tidb_tpu_torch.ops.exprc import Unsupported


def _clip(region, start: bytes, end: bytes | None):
    lo = max(start, region.start)
    if region.end is None:
        return lo, end
    return lo, region.end if end is None else min(end, region.end)


def clip_ranges(region, ranges) -> list:
    """The parts of `ranges` inside the region, as KeyRanges."""
    out = []
    for rg in ranges:
        lo, hi = _clip(region, rg.start, rg.end)
        if hi is None or lo < hi:
            out.append(KeyRange(lo, hi))
    return out


class RpcHandler:
    def __init__(self, cluster, mvcc: MvccStore, plane_cache, device):
        self.cluster = cluster
        self.mvcc = mvcc
        self.plane_cache = plane_cache
        self.device = device
        # the HTAP freshness tier: commits whose table has live cached
        # base planes append region-side delta packs instead of orphaning
        # the cache; scans merge base + delta
        self.delta_store = DeltaStore(plane_cache)
        # the owning store's oldest-active-reader probe: the plane cache
        # keeps the generations a live old snapshot still reads
        self.oldest_active_ts_fn = None

    # ---- KV commands ----

    def kv_get(self, region, key: bytes, read_ts: int):
        if not region.contains(key):
            raise errors.KVError(f"key {key!r} outside region "
                                 f"{region.region_id}")
        return self.mvcc.get(key, read_ts)

    def kv_scan(self, region, start: bytes, end: bytes | None,
                read_ts: int, limit: int | None = None):
        lo, hi = _clip(region, start, end)
        return self.mvcc.scan(lo, hi, read_ts, limit)

    def kv_prewrite(self, region, mutations, primary: bytes, start_ts: int,
                    ttl_ms: int) -> None:
        self.mvcc.prewrite(mutations, primary, start_ts, ttl_ms)

    def kv_commit(self, region, keys, start_ts: int, commit_ts: int) -> None:
        applied = self.mvcc.commit(keys, start_ts, commit_ts)
        self.delta_store.on_commit(region, keys, applied, commit_ts)

    def kv_rollback(self, region, keys, start_ts: int) -> None:
        self.mvcc.rollback(keys, start_ts)

    # ---- coprocessor ----

    def cop_request(self, region, sel, ranges, read_ts: int):
        if not getattr(sel, "columnar_hint", False):
            raise Unsupported("row-protocol region requests come in a "
                              "later slice")
        if sel.table_info is None:
            raise Unsupported("index requests over regions come in a "
                              "later slice")
        oldest = (self.oldest_active_ts_fn()
                  if self.oldest_active_ts_fn is not None else None)
        return handle_columnar_scan(
            _MvccSnapshotView(self.mvcc, read_ts), sel,
            clip_ranges(region, ranges),
            region=(region.region_id, region.epoch()),
            cache=self.plane_cache, delta=self.delta_store,
            oldest_ts=oldest, device=self.device)


class _MvccSnapshotView:
    """Snapshot-shaped view over the MVCC store at read_ts: what a region
    packs from. A lock raises KeyIsLockedError."""

    def __init__(self, mvcc: MvccStore, read_ts: int):
        self.mvcc = mvcc
        self.read_ts = read_ts

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        return iter(self.mvcc.scan(start, end, self.read_ts))
