"""The cluster store's coprocessor path (the port of
tidb_tpu/cluster/store.py:118-341 DistCoprClient, :376-393 _ListResponse
and :563-611 DistStore, cut to the read path).

`DistStore(pairs, split_keys)` holds one read-only KV snapshot split into
regions at `split_keys`; `get_client().send(req)` splits each key range by
region exactly as the reference's buildCopTasks does and runs the tasks
serially in task order (the reference's `concurrency <= 1` branch). The
threaded, pipelined fan-out, MVCC writes, 2PC, the retry ladder and the
lock resolver come in later slices: the topology is static, so no region
error can occur.
"""

from __future__ import annotations

from tidb_tpu_torch.cluster.client import RegionCache
from tidb_tpu_torch.cluster.rpc import RpcHandler
from tidb_tpu_torch.cluster.topology import Cluster
from tidb_tpu_torch.copr.plane_cache import PlaneCache
from tidb_tpu_torch.copr.proto import SelectRequest
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import resolve_device
from tidb_tpu_torch.ops.exprc import Unsupported


class DistCoprClient(kv.Client):
    """Coprocessor fan-out per region (store/tikv/coprocessor.go
    CopClient)."""

    def __init__(self, store: "DistStore"):
        self.store = store

    def send(self, req: kv.Request) -> kv.Response:
        if req.tp != kv.REQ_TYPE_SELECT:
            raise Unsupported(f"request type {req.tp}")
        sel: SelectRequest = req.data
        desc = bool(req.desc or sel.desc)
        # buildCopTasks (store/tikv/coprocessor.go:216): one task per
        # region segment of each range
        ranges_split = []
        for rg in req.key_ranges:
            for _region, lo, hi in self.store.cache.split_range_by_region(
                    rg.start, rg.end):
                ranges_split.append(kv.KeyRange(lo, hi))
        if desc:
            ranges_split = list(reversed(ranges_split))
        responses = []
        for rg in ranges_split:
            out = self._exec_range(rg, sel)
            responses.extend(reversed(out) if desc else out)
        return _ListResponse(responses)

    def _exec_range(self, rg: kv.KeyRange, sel: SelectRequest) -> list:
        """One task's key range, region by region (the reference's
        worklist, without its retry ladder)."""
        out = []
        cursor, end = rg.start, rg.end
        while True:
            if end is not None and cursor >= end:
                return out
            region = self.store.cache.locate(cursor)
            seg_end = region.end if end is None else (
                end if region.end is None else min(region.end, end))
            out.append(self.store.rpc.cop_request(
                region, sel, [kv.KeyRange(cursor, seg_end)], sel.start_ts))
            if seg_end is None or seg_end == end:
                return out
            cursor = seg_end


class _ListResponse(kv.Response):
    def __init__(self, responses):
        self._responses = list(responses)
        self._i = 0

    def next(self):
        if self._i >= len(self._responses):
            return None
        r = self._responses[self._i]
        self._i += 1
        return r

    def drain_all(self) -> list:
        """Every remaining partial, in task order."""
        out = self._responses[self._i:]
        self._i = len(self._responses)
        return out


class DistStore:
    """One read-only KV snapshot split into regions. `device` None means
    the card (and raises without CUDA); only "cpu" selects the plain
    versions of the kernels. `plane_cache` may be shared between stores
    over the same data (the batches are host numpy; each device pins its
    own planes)."""

    def __init__(self, pairs, split_keys=(), device=None,
                 plane_cache: PlaneCache | None = None):
        self.device = resolve_device(device)
        self.mem = MemStore.from_pairs(pairs)
        self.cluster = Cluster()
        self.cluster.split_keys(list(split_keys))
        self.cache = RegionCache(self.cluster)
        self.plane_cache = plane_cache if plane_cache is not None \
            else PlaneCache(device=self.device)
        self.rpc = RpcHandler(self.cluster, self.mem, self.plane_cache,
                              self.device)
        self._client = None

    def get_client(self) -> DistCoprClient:
        if self._client is None:
            self._client = DistCoprClient(self)
        return self._client

    def data_version_at(self, start_ts: int, prefix: bytes | None = None):
        return self.mem.data_version_at(start_ts, prefix)
