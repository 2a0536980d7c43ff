"""The cluster store (the port of tidb_tpu/cluster/store.py:37-116
DistTxn, :118-341 DistCoprClient, :376-393 _ListResponse and :563-611
DistStore).

`DistStore(pairs, split_keys)` holds a Percolator MVCC store split into
regions at `split_keys`; `pairs` are a bootstrap load visible at every
read timestamp. `begin()` gives a DistTxn whose writes buffer in a
UnionStore and commit through 2PC (cluster/twopc.py);
`get_client().send(req)` splits each key range by region exactly as the
reference's buildCopTasks does and runs the tasks serially in task order
(the reference's `concurrency <= 1` branch). The threaded, pipelined
fan-out, the retry ladder, the lock resolver and GC come in later slices:
the topology is static, so no region error can occur, and a read that
meets a lock raises KeyIsLockedError.
"""

from __future__ import annotations

from tidb_tpu_torch import errors
from tidb_tpu_torch.cluster.client import DistSnapshot, RegionCache
from tidb_tpu_torch.cluster.mvcc import MvccStore
from tidb_tpu_torch.cluster.oracle import VersionProvider
from tidb_tpu_torch.cluster.rpc import RpcHandler
from tidb_tpu_torch.cluster.topology import Cluster
from tidb_tpu_torch.cluster.twopc import TwoPhaseCommitter
from tidb_tpu_torch.copr.plane_cache import PlaneCache
from tidb_tpu_torch.copr.proto import SelectRequest
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.kv.membuffer import TOMBSTONE
from tidb_tpu_torch.kv.union_store import UnionStore
from tidb_tpu_torch.ops import mesh as mesh_mod
from tidb_tpu_torch.ops.client import resolve_device
from tidb_tpu_torch.ops.exprc import Unsupported


class DistTxn(kv.Transaction):
    """tikvTxn (store/tikv/txn.go:32): a UnionStore over a snapshot at
    start_ts, committed by 2PC."""

    def __init__(self, store: "DistStore", start_ts: int):
        self._store = store
        self._start_ts = start_ts
        self._us = UnionStore(DistSnapshot(store, start_ts))
        self._valid = True
        self._dirty = False

    def start_ts(self) -> int:
        return self._start_ts

    def get(self, key: bytes) -> bytes:
        self._check()
        return self._us.get(key)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        self._check()
        return self._us.iterate(start, end)

    def set(self, key: bytes, value: bytes) -> None:
        self._check()
        if not value:
            raise errors.KVError("cannot set empty value")
        self._dirty = True
        self._us.set(key, value)

    def delete(self, key: bytes) -> None:
        self._check()
        self._dirty = True
        self._us.delete(key)

    def commit(self) -> None:
        self._check()
        self._valid = False
        if not self._dirty:
            return
        mutations: dict[bytes, bytes | None] = {}
        for k, v in self._us.buffer.iterate(include_tombstones=True):
            mutations[k] = None if v == TOMBSTONE else v
        if not mutations:
            return
        TwoPhaseCommitter(self._store, self._start_ts, mutations).execute()

    def rollback(self) -> None:
        self._check()
        self._valid = False

    def _check(self):
        if not self._valid:
            raise errors.KVError(
                "transaction already committed or rolled back")


class DistCoprClient(kv.Client):
    """Coprocessor fan-out per region (store/tikv/coprocessor.go
    CopClient)."""

    def __init__(self, store: "DistStore"):
        self.store = store

    @property
    def device(self):
        """The store's device: where its scans' planes and the executors
        above them run."""
        return self.store.device

    @property
    def mesh(self):
        """The process mesh (ops.mesh.get_mesh) where it lies on the
        store's device, for the executor layer's sharded kernels (the join
        probe); None keeps them on one shard."""
        m = mesh_mod.get_mesh()
        return m if mesh_mod.on_device(m, self.store.device) else None

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


class DistStore(kv.Storage):
    """An MVCC store split into regions. `device` None means the card (and
    raises without CUDA); only "cpu" selects the plain versions of the
    kernels. `plane_cache` may be shared between stores over the same data
    (the batches are host numpy; each device pins its own planes), but
    the delta packs follow the commits of one store: two stores that both
    take writes keep their own caches."""

    def __init__(self, pairs, split_keys=(), device=None,
                 plane_cache: PlaneCache | None = None):
        self.device = resolve_device(device)
        self.mvcc = MvccStore()
        self.mvcc.load(pairs)
        self.cluster = Cluster()
        self.cluster.split_keys(list(split_keys))
        self.cache = RegionCache(self.cluster)
        self.plane_cache = plane_cache if plane_cache is not None \
            else PlaneCache(device=self.device)
        self.rpc = RpcHandler(self.cluster, self.mvcc, self.plane_cache,
                              self.device)
        self.rpc.oldest_active_ts_fn = self.oldest_active_ts
        self.oracle = VersionProvider()
        self._client = None
        # live readers: the plane cache keeps what the oldest one reads
        self._active_reads = kv.ActiveReads()

    def begin(self) -> DistTxn:
        txn = DistTxn(self, self.oracle.current_version())
        self._active_reads.add(txn)
        return txn

    def get_snapshot(self, version: int | None = None) -> DistSnapshot:
        snap = DistSnapshot(self, version if version is not None
                            else self.oracle.current_version())
        self._active_reads.add(snap)
        return snap

    def oldest_active_ts(self) -> int | None:
        return self._active_reads.oldest()

    def current_version(self) -> int:
        return self.oracle.current_version()

    def get_client(self) -> DistCoprClient:
        if self._client is None:
            self._client = DistCoprClient(self)
        return self._client

    def data_version_at(self, start_ts: int, prefix: bytes | None = None):
        """Visible-data version at start_ts; with `prefix`
        (tablecodec.table_prefix_of) only that table's commits count."""
        return self.mvcc.data_version_at(start_ts, prefix)
