"""The region side of a coprocessor request (the port of
tidb_tpu/cluster/rpc.py:209-244 cop_request): clip the request's ranges
to the region and answer with the columnar region engine.

The reference falls back to the row handler for a region the columnar
engine cannot answer; the port has no row engine, so such a request
raises Unsupported.
"""

from __future__ import annotations

from tidb_tpu_torch import tablecodec as tc
from tidb_tpu_torch.copr.columnar_region import handle_columnar_scan
from tidb_tpu_torch.kv.kv import KeyRange
from tidb_tpu_torch.ops.exprc import Unsupported


def clip_ranges(region, ranges) -> list:
    """The parts of `ranges` inside the region, as KeyRanges."""
    out = []
    for rg in ranges:
        lo = max(rg.start, region.start)
        if rg.end is None:
            hi = region.end
        elif region.end is None:
            hi = rg.end
        else:
            hi = min(rg.end, region.end)
        if hi is None or lo < hi:
            out.append(KeyRange(lo, hi))
    return out


class RpcHandler:
    def __init__(self, cluster, mem, plane_cache, device):
        self.cluster = cluster
        self.mem = mem
        self.plane_cache = plane_cache
        self.device = device

    def cop_request(self, region, sel, ranges, read_ts: int):
        if not getattr(sel, "columnar_hint", False):
            raise Unsupported("row-protocol region requests come in a "
                              "later slice")
        if sel.table_info is None:
            raise Unsupported("index requests over regions come in a "
                              "later slice")
        clipped = clip_ranges(region, ranges)
        version = self.mem.data_version_at(
            read_ts, tc.table_prefix(sel.table_info.table_id))
        return handle_columnar_scan(
            self.mem.get_snapshot(read_ts), sel, clipped,
            region=(region.region_id, region.epoch()),
            cache=self.plane_cache, version=version, device=self.device)
