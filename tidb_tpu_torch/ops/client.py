"""GpuClient: the coprocessor on the card behind the kv.Client boundary
(the port of tidb_tpu/ops/client.py:99-1008, TpuClient).

Per request:
  1. a columnar batch for (table, columns, ranges, data version) — packed
     once, cached, its planes resident on the device;
  2. the WHERE, every aggregate argument and every ORDER BY expression
     compile into ONE bytecode program (ops.exprc) that kernel K1 runs;
     then K2/K3/K4 reduce (ops.kernels), a group-by beyond the radix
     ceiling is ranked (sort, K8, K4's pass) up the _RANK_CAPS ladder and
     else compacted to host tuple codes, DISTINCT aggregates sort and K9
     marks their runs, TopN selects with K10, or the filter's survivors
     are gathered;
  3. aggregates go back as the SAME partial-row chunk protocol the CPU
     engine and TpuClient emit (TpuClient under tidb_tpu_columnar_scan=0);
     a scan or TopN that carries `columnar_hint` (a plane-aware executor
     asked for it) is answered with its planes and selection index
     (ops.columnar.ColumnarScanResult), as TpuClient does with
     tidb_tpu_columnar_scan on — the port has no such switch: the hint
     alone decides.

A request whose batch holds fewer rows than the dispatch floor (or whose
planner estimate says so) takes `_route_small`: the micro-batch tier
(ops.sched.MicroBatcher), where concurrent statements of one shape on one
batch share a launch with their literals as per-slot parameters, else the
solo route, which is `serve` on the card: the port has no CPU engine.

A request outside the port (index scans, HAVING, ORDER BY without LIMIT,
more than kernels.TOPN_MAX_KEYS ORDER BY items, a group tuple count beyond
the segment ceiling) raises Unsupported: the port has no CPU engine to
hand it to.

The client keeps no per-request state: one client serves many sessions
at once, so every decode table a statement needs travels with it
(`_Decode`), and the shared caches and counters take the client's lock.
"""

from __future__ import annotations

import functools
import threading
from decimal import Decimal

import numpy as np
import torch

from tidb_tpu_torch import errors, mysqldef as my
from tidb_tpu_torch import tablecodec as tc
from tidb_tpu_torch.codec import codec
from tidb_tpu_torch.copr.proto import (AGG_NAME, ChunkWriter, ExprType,
                                       SelectRequest, SelectResponse)
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import Program, Unsupported, compile_expr
from tidb_tpu_torch.ops.sched import MicroBatcher, batch_uid
from tidb_tpu_torch.types.datum import NULL, Datum, Kind
from tidb_tpu_torch.types.time_types import Duration, Time


# Copies of the reference's sysvar defaults (tidb_tpu/sessionctx/
# __init__.py:54 tidb_tpu_dispatch_floor, :117 tidb_tpu_batch_window_ms):
# a request under DISPATCH_FLOOR_ROWS rows takes _route_small, whose
# micro-batch tier gathers concurrent statements for BATCH_WINDOW_MS.
DISPATCH_FLOOR_ROWS = 16384
BATCH_WINDOW_MS = 2


def _n_outputs(spec) -> int:
    """Kernel outputs per aggregate (mirrors kernels._agg_outputs)."""
    return 1 if spec.name == "count" else 2


def resolve_device(device=None) -> torch.device:
    """None → the card. Only an explicit "cpu" selects the plain versions;
    asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise errors.DeviceError(
            "CUDA is not available (pass device='cpu' for the plain "
            "PyTorch versions of the kernels)")
    if dev.type not in ("cuda", "cpu"):
        raise errors.DeviceError(f"unsupported device {dev}")
    return dev


class _Decode:
    """The decode tables of one request: its batch, its columns and their
    dictionaries. Built per statement and passed down, never kept on the
    client, so that concurrent statements cannot read each other's."""

    __slots__ = ("batch", "cols", "col_pb", "dict_for")

    def __init__(self, sel: SelectRequest, batch: col.ColumnBatch):
        self.batch = batch
        self.cols = sel.table_info.columns
        self.col_pb = {c.column_id: c for c in self.cols}
        self.dict_for = {cid: cd.dictionary
                         for cid, cd in batch.columns.items()
                         if cd.kind == col.K_STR}


class _SingleResponse(kv.Response):
    def __init__(self, resp: SelectResponse):
        self._resp = resp

    def next(self):
        r, self._resp = self._resp, None
        return r


class GpuClient(kv.Client):
    """`mesh` (parallel.CoprMesh, S virtual shards on the client's device;
    its device is the client's when `device` is None) row-shards every
    batch: aggregates fold per-shard partials (K7), TopN merges per-shard
    candidates (K20). A filter's mask is row-wise, the same over the
    batch as over its shard-major blocks: one K1 launch. At one shard
    every statement takes the single-device route."""

    def __init__(self, store, device=None, mesh=None,
                 dispatch_floor_rows=None, micro_batch=True,
                 batch_window_ms=BATCH_WINDOW_MS):
        self.store = store
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if mesh is not None and mesh.device != kernels._device(self.device):
            raise errors.DeviceError(f"a mesh on {mesh.device} for a client "
                                     f"on {self.device}")
        self.mesh = mesh
        # below this many rows a request takes _route_small (0: never)
        self.dispatch_floor_rows = (DISPATCH_FLOOR_ROWS
                                    if dispatch_floor_rows is None
                                    else int(dispatch_floor_rows))
        # False pins every below-floor statement to the solo route
        self.micro_batch = bool(micro_batch)
        self.batch_window_ms = batch_window_ms
        self._sched = MicroBatcher()
        # guards the batch cache, the rank memo and the counters below,
        # which concurrent sessions share
        self._lock = threading.Lock()
        self._batch_cache: dict = {}
        # rung of _RANK_CAPS a repeated ranked statement starts at
        self._rank_cap_start: dict = {}
        # small_batched / small_solo: below-floor statements answered by a
        # shared launch / by the solo route; batched_launches and
        # batched_slots: the tier's launches and the statements they
        # carried (exactly one slot each); batch_sizes: launches by slot
        # count; stall_degrades: statements whose gather window stalled;
        # mesh_single: aggregates a mesh client ran on one shard (not
        # mesh-combinable)
        self.stats = {"gpu_requests": 0, "batch_packs": 0, "batch_hits": 0,
                      "ranked": 0, "tuple_grouped": 0, "mesh_single": 0,
                      "small_batched": 0, "small_solo": 0,
                      "batched_launches": 0, "batched_slots": 0,
                      "batch_sizes": {}, "stall_degrades": 0,
                      "launches": {k: 0 for k in kernels.LAUNCHES}}
        self.last_rank_cap = None     # the rung the last ranked answer took

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.stats[key] += n

    def note_launch(self, slots: int) -> None:
        """One launch of the micro-batch tier carrying `slots` statements."""
        with self._lock:
            self.stats["batched_launches"] += 1
            self.stats["batched_slots"] += slots
            sizes = self.stats["batch_sizes"]
            sizes[slots] = sizes.get(slots, 0) + 1

    # ------------------------------------------------------------------

    def send(self, req: kv.Request) -> kv.Response:
        sel: SelectRequest = req.data
        if req.tp != kv.REQ_TYPE_SELECT or sel.table_info is None:
            raise Unsupported("only table scans are served (index "
                              "requests come with a later slice)")
        if self.mesh is not None and any(
                e.distinct and AGG_NAME.get(e.tp) in ("count", "sum", "avg")
                for e in sel.aggregates):
            # per-shard distinct partials cannot merge: the reference's
            # support_request_type keeps these above a mesh client
            raise Unsupported("DISTINCT count/sum/avg across a mesh")
        floor = self.dispatch_floor_rows
        if floor and sel.est_rows is not None and sel.est_rows < floor:
            # the planner's estimate is under the floor: no pack first
            return self._route_small(req, sel)
        batch = self._get_batch(sel, req.key_ranges)
        if floor and batch.n_rows < floor:
            return self._route_small(req, sel, batch)
        return self._solo(sel, batch)

    def _solo(self, sel: SelectRequest, batch: col.ColumnBatch
              ) -> kv.Response:
        resp = self.serve(sel, batch)
        self.count("gpu_requests")
        return _SingleResponse(resp)

    def _route_small(self, req: kv.Request, sel: SelectRequest,
                     batch: col.ColumnBatch | None = None) -> kv.Response:
        """Below the dispatch floor: the micro-batch tier first (ops.sched;
        statements of one shape on one batch within the gather window share
        one launch), else the solo route — `serve` on the card, where the
        reference answers on its CPU engine. A fault in a shared launch
        raises in every statement it carried."""
        if self.micro_batch:
            resp = self._sched.submit(self, req, sel)
            if resp is not None:
                self.count("small_batched")
                return resp
        self.count("small_solo")
        if batch is None:
            batch = self._get_batch(sel, req.key_ranges)
        return self._solo(sel, batch)

    def _batch_key(self, sel: SelectRequest, ranges) -> tuple:
        """(cache key, data version) of the batch `sel` reads."""
        src = sel.table_info
        sig = tuple((c.column_id, c.tp, c.flag, c.flen, c.decimal,
                     c.pk_handle, repr(c.default_val)) for c in src.columns)
        key = (src.table_id, sig, tuple((r.start, r.end) for r in ranges))
        return key, self.store.data_version_at(sel.start_ts,
                                               tc.table_prefix(src.table_id))

    def admit(self, sel: SelectRequest, ranges, batch: col.ColumnBatch
              ) -> None:
        """Serve `sel` over `ranges` from `batch`, packed by the caller
        straight from its arrays (what packing the store's rows would
        give): send then finds it where it keeps the batches it packed."""
        key, version = self._batch_key(sel, ranges)
        with self._lock:
            self._batch_cache[key] = (batch, version)

    def _get_batch(self, sel: SelectRequest, ranges) -> col.ColumnBatch:
        src = sel.table_info
        cols = src.columns
        key, version = self._batch_key(sel, ranges)
        with self._lock:
            ent = self._batch_cache.get(key)
            if ent is not None and ent[1] == version:
                self.stats["batch_hits"] += 1
                return ent[0]
            self.stats["batch_packs"] += 1
        snapshot = self.store.get_snapshot(sel.start_ts)
        defaults = {c.column_id: c.default_val for c in cols
                    if c.default_val is not None}
        batch = col.pack_ranges(snapshot, src.table_id, cols, ranges,
                                defaults)
        with self._lock:
            self._batch_cache[key] = (batch, version)
            if len(self._batch_cache) > 64:
                self._batch_cache.pop(next(iter(self._batch_cache)))
        return batch

    def serve(self, sel: SelectRequest, batch: col.ColumnBatch
              ) -> SelectResponse:
        """Answer `sel` over an already packed batch (what send does after
        packing; a caller holding planes drives the same path)."""
        if sel.having is not None:
            raise Unsupported("having not lowered")
        prog = Program(batch)
        where = compile_expr(sel.where, batch, prog) \
            if sel.where is not None else None
        if sel.is_agg():
            return self._run_aggregate(sel, _Decode(sel, batch), prog, where)
        if sel.order_by:
            return self._run_topn(sel, batch, prog, where)
        return self._run_filter(sel, batch, prog, where)

    def _dispatch(self, fn, planes, live):
        """One request's kernels, serialized, with their launches counted
        into stats. The results are host numpy (the readback is the
        completion point)."""
        with kernels.dispatch_serial:
            before = dict(kernels.LAUNCHES)
            outs = fn(planes, live)
            for k, v in kernels.LAUNCHES.items():
                self.stats["launches"][k] += v - before[k]
        return outs

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def _run_aggregate(self, sel, dec: _Decode, prog, where
                       ) -> SelectResponse:
        batch = dec.batch
        specs = kernels.lower_aggregates(sel, batch, prog)
        planes = kernels.batch_planes(batch, self.device)
        live = kernels.device_live(batch, self.device)
        if sel.group_by:
            gspec = kernels.lower_group_by(sel, batch)
            if gspec.kind == "rank" and self.mesh is not None:
                # ranks are batch-local, not shard-combinable: global
                # composite tuple codes instead
                tspec = kernels.lower_tuple_group(gspec, batch)
                if tspec is None:
                    raise Unsupported("group tuple cardinality exceeds "
                                      "the segment ceiling")
                gspec = tspec
                self.count("tuple_grouped")
            if gspec.kind == "rank":
                # device sort and rank up the ladder; composite tuple
                # codes only when the ladder overflows
                try:
                    return self._run_ranked(sel, dec, prog, where, specs,
                                            gspec, planes, live)
                except Unsupported:
                    tspec = kernels.lower_tuple_group(gspec, batch)
                    if tspec is None:
                        raise Unsupported("group tuple cardinality exceeds "
                                          "the segment ceiling") from None
                    gspec = tspec
                    self.count("tuple_grouped")
            planes = self._with_group_planes(batch, gspec, planes)
            fn = kernels.build_grouped_agg_fn(prog, where, specs,
                                              gspec.plane_keys,
                                              gspec.kernel_sizes)
            outs = self._dispatch(self._on_mesh(fn), planes, live)
            with kernels.phase("emit", self.device):
                return self._emit_grouped(sel, dec, specs, gspec,
                                          fn.radices, outs)
        fn = kernels.build_scalar_agg_fn(prog, where, specs)
        outs = self._dispatch(self._on_mesh(fn), planes, live)
        return self._emit_scalar(sel, dec, specs, outs)

    def _on_mesh(self, fn):
        """An aggregate fn as this client runs it: over the mesh's shards
        (partials folded by K7), or in one launch over the whole batch
        where there is no mesh or the fn is not mesh-combinable (DISTINCT
        states: the reference's own single-device route on a mesh)."""
        if self.mesh is None:
            return fn
        if any(c is None for c in fn.combiners):
            self.count("mesh_single")
            return fn
        return functools.partial(self.mesh.run, fn)

    def _emit_scalar(self, sel, dec: _Decode, specs, outs) -> SelectResponse:
        row: list[Datum] = [Datum.bytes_(b"")]
        i = 0
        for spec, e in zip(specs, sel.aggregates):
            row.extend(self._partial_datums(dec, spec, e, outs, i, None))
            i += _n_outputs(spec)
        return self._agg_response([(0, row)])

    def _with_group_planes(self, batch, gspec, planes):
        """Add host-built group-code planes (device-cached on the batch):
        per-column numeric codes (the valid plane is the column's own) or
        the composite tuple-code plane (NULLs folded into the codes, so its
        valid plane is all true)."""
        extra = [k for k in gspec.plane_keys
                 if kernels.is_group_code_key(k) or kernels.is_tuple_key(k)]
        if not extra:
            return planes
        cache = getattr(batch, "_device_gcodes", None)
        if cache is None:
            cache = batch._device_gcodes = {}
        planes = dict(planes)
        for key in extra:
            ck = (str(self.device), key)
            ent = cache.get(ck)
            if ent is None:
                if kernels.is_tuple_key(key):
                    codes, _percol = batch.tuple_codes(gspec.cids)
                    ent = (torch.from_numpy(codes).to(self.device),
                           torch.ones(batch.capacity, dtype=torch.bool,
                                      device=self.device))
                else:
                    codes, _uniq = batch.group_codes(kernels.GC_BASE - key)
                    ent = torch.from_numpy(codes).to(self.device)
                cache[ck] = ent
            planes[key] = ent if kernels.is_tuple_key(key) else \
                (ent, planes[kernels.GC_BASE - key][1])
        return planes

    def _group_datum(self, dec: _Decode, cid: int, decoder, code: int
                     ) -> Datum:
        kind = decoder[0]
        if kind == "dec":
            _k, data, scale = decoder
            return Datum.dec(Decimal(int(data[code]))
                             / (Decimal(10) ** scale))
        _k, data = decoder
        if kind == "str":
            return Datum.bytes_(data[code])
        v = data[code]
        if isinstance(v, np.floating):
            return Datum.f64(float(v))
        return _i64_datum(dec, cid, int(v))

    def _emit_grouped(self, sel, dec: _Decode, specs, gspec, radices,
                      outs) -> SelectResponse:
        rows: list = []
        row_count = outs[0]
        n_segments = row_count.shape[0]
        live_gids = np.nonzero(row_count[:n_segments - 1] > 0)[0]
        for gid in live_gids.tolist():
            if gspec.kind == "tuple":
                # the composite id indexes the host-built per-column codes
                if gid >= gspec.n_groups:   # the kernel's unused NULL slot
                    continue
                codes = gspec.percol[gid].tolist()
            else:
                # decode mixed-radix gid → per-column codes
                codes = []
                rem = gid
                for radix in reversed(radices):
                    codes.append(rem % radix)
                    rem //= radix
                codes.reverse()
            gvals = []
            for code, size, cid, decoder in zip(codes, gspec.sizes,
                                                gspec.cids, gspec.decoders):
                gvals.append(NULL if code >= size
                             else self._group_datum(dec, cid, decoder, code))
            gk = codec.encode_value(gvals)
            row: list[Datum] = [Datum.bytes_(gk)]
            i = 1  # outs[0] is row_count
            for spec, e in zip(specs, sel.aggregates):
                row.extend(self._partial_datums(dec, spec, e, outs, i, gid))
                i += _n_outputs(spec)
            rows.append((0, row))
        return self._agg_response(rows)

    # escalation ladder of segment buckets for a ranked group-by (the last
    # slot of each is the dead-row sink); overflow → next bucket → tuple
    # codes
    _RANK_CAPS = (1025, 16385, 262145)

    def _run_ranked(self, sel, dec: _Decode, prog, where, specs, gspec,
                    planes, live) -> SelectResponse:
        """The rank ladder of the reference's _run_ranked, with its memo of
        the rung a repeated statement starts at. The K1 pass, the sort and
        K8's rank pass do not depend on the rung, so they run once per
        statement; the rank pass counts the groups, the rungs that cannot
        hold them are passed over, and the first that can runs K8's output
        pass and the reductions."""
        ck = (batch_uid(dec.batch), repr(sel.where), repr(sel.aggregates),
              repr(sel.group_by))
        with self._lock:
            start = self._rank_cap_start.get(ck, self._RANK_CAPS[0])
        if start > self._RANK_CAPS[-1]:
            # memoized overflow: repeats go straight to the tuple fallback
            raise Unsupported("group cardinality exceeds rank buckets "
                              "(memoized)")
        fn = kernels.build_ranked_group_fn(prog, where, specs, gspec.cids)
        prep = self._dispatch(fn.prepare, planes, live)
        ngroups = prep.ngroups
        for cap in self._RANK_CAPS:
            if cap < start or ngroups > cap - 1:
                continue
            ngroups, outs = self._dispatch(
                lambda p, lv, cap=cap: fn(prep, p, cap), planes, live)
            if outs is not None:
                with self._lock:
                    self._rank_cap_start[ck] = cap
                    if len(self._rank_cap_start) > 256:
                        self._rank_cap_start.pop(
                            next(iter(self._rank_cap_start)))
                    self.last_rank_cap = cap
                    self.stats["ranked"] += 1
                with kernels.phase("emit", self.device):
                    return self._emit_ranked(sel, dec, specs, gspec, outs,
                                             ngroups)
        with self._lock:
            self._rank_cap_start[ck] = self._RANK_CAPS[-1] + 1
        raise Unsupported(f"group cardinality {ngroups} exceeds rank buckets")

    def _emit_ranked(self, sel, dec: _Decode, specs, gspec, outs,
                     ngroups: int) -> SelectResponse:
        rows: list = []
        # outs: [ngroups, row_count, (rep, nonnull) per group column, aggs…]
        base = 2 + 2 * len(gspec.cids)
        for g in range(ngroups):
            gvals = []
            for j, cid in enumerate(gspec.cids):
                if not outs[2 + 2 * j + 1][g]:
                    gvals.append(NULL)
                    continue
                rep = outs[2 + 2 * j][g]
                cd = dec.batch.columns[cid]
                if cd.kind == col.K_STR:
                    gvals.append(Datum.bytes_(cd.dictionary[int(rep)]))
                elif cd.kind == col.K_F64:
                    gvals.append(Datum.f64(float(rep)))
                elif cd.kind == col.K_DEC:
                    gvals.append(Datum.dec(
                        Decimal(int(rep)) / (Decimal(10) ** cd.dec_scale)))
                else:
                    gvals.append(_i64_datum(dec, cid, int(rep)))
            gk = codec.encode_value(gvals)
            row: list[Datum] = [Datum.bytes_(gk)]
            i = base
            for spec, e in zip(specs, sel.aggregates):
                row.extend(self._partial_datums(dec, spec, e, outs, i, g))
                i += _n_outputs(spec)
            rows.append((0, row))
        return self._agg_response(rows)

    def _agg_response(self, rows: list) -> SelectResponse:
        writer = ChunkWriter()
        for handle, row in rows:
            writer.append_row(handle, row)
        return SelectResponse(chunks=writer.finish())

    def _partial_datums(self, dec: _Decode, spec, agg_expr, outs, i, gid
                        ) -> list[Datum]:
        """Partial-row slice for one aggregate, layout-compatible with
        AggregationFunction.get_partial_result."""
        def at(j):
            v = outs[j]
            return v if gid is None else v[gid]

        name = spec.name
        dec_scale = spec.arg.scale if spec.arg is not None \
            and spec.arg.kind == col.K_DEC else None
        if name == "count":
            return [Datum.i64(int(at(i)))]
        n = int(at(i))
        v = at(i + 1)
        if name in ("sum", "avg"):
            if n == 0:
                val = NULL
            elif dec_scale is not None:
                # fixed-point plane: scaled-int sum → exact Decimal
                val = Datum.dec(Decimal(int(v))
                                / (Decimal(10) ** dec_scale))
            elif isinstance(v, np.floating):
                val = Datum.f64(float(v))
            else:
                val = Datum.dec(Decimal(int(v)))
            return [Datum.i64(n), val] if name == "avg" else [val]
        if name == "first_row":
            # v is the first contributing row's position — gather the
            # actual value host-side (exact CPU-engine semantics)
            if n == 0:
                return [NULL]
            return [_col_datum_at(dec, agg_expr.children[0].val, int(v))]
        if name in ("min", "max"):
            if n == 0:
                return [NULL]
            if dec_scale is not None:
                return [Datum.dec(Decimal(int(v))
                                  / (Decimal(10) ** dec_scale))]
            return [_phys_to_datum(dec, agg_expr, v)]
        raise Unsupported(name)

    # ------------------------------------------------------------------
    # filter
    # ------------------------------------------------------------------

    def _run_filter(self, sel, batch, prog, where) -> SelectResponse:
        fn = kernels.build_filter_fn(prog, where)
        planes = kernels.batch_planes(batch, self.device)
        live = kernels.device_live(batch, self.device)

        def run(p, lv):
            idx_d = torch.nonzero(fn(p, lv)[0]).squeeze(1)
            return idx_d, idx_d.cpu().numpy()

        idx_d, idx = self._dispatch(run, planes, live)
        if sel.desc:
            idx, idx_d = idx[::-1], None
        if sel.limit is not None and sel.limit < len(idx):
            idx, idx_d = idx[: sel.limit], None
        return self._emit_rows(sel, batch, idx, idx_d)

    def _run_topn(self, sel, batch, prog, where) -> SelectResponse:
        if sel.limit is None:
            raise Unsupported("topn lowering needs keys + limit")
        if self.mesh is not None and self.mesh.n > 1:
            return self._run_topn_mesh(sel, batch, prog, where)
        k = min(sel.limit, batch.capacity)
        keys = [(compile_expr(item.expr, batch, prog), item.desc)
                for item in sel.order_by]
        fn = kernels.build_topn_fn(prog, where, keys, k)
        planes = kernels.batch_planes(batch, self.device)
        live = kernels.device_live(batch, self.device)

        def run(p, lv):
            idx, n_live = fn(p, lv)
            with kernels.phase("readback", self.device):
                return idx.cpu().numpy()[:int(n_live[0])]

        idx = self._dispatch(run, planes, live)
        with kernels.phase("emit", self.device):
            return self._emit_rows(sel, batch, idx)

    def _run_topn_mesh(self, sel, batch, prog, where) -> SelectResponse:
        """Every shard's first k = min(limit, shard length) rows (K1, then
        K20's launches) and the host merge of the S * k candidates on
        their order words (kernels.merge_topn_partials)."""
        n = self.mesh.n
        shard_len = batch.capacity // n
        k = min(sel.limit, shard_len)
        if k <= 0:
            return self._emit_rows(sel, batch, np.zeros(0, np.int64))
        keys = [(compile_expr(item.expr, batch, prog), item.desc)
                for item in sel.order_by]
        fn = kernels.build_topn_partial_fn(prog, where, keys, k)
        planes = kernels.batch_planes(batch, self.device)
        live = kernels.device_live(batch, self.device)

        def run(p, lv):
            outs = self.mesh.run_sharded(fn, p, lv)
            with kernels.phase("readback", self.device):
                return [o.cpu().numpy() for o in outs]

        idx_l, n_live, words, nulls = self._dispatch(run, planes, live)
        with kernels.phase("merge", self.device):
            idx = kernels.merge_topn_partials(idx_l, n_live, words, nulls,
                                              n, shard_len, sel.limit)
        with kernels.phase("emit", self.device):
            return self._emit_rows(sel, batch, idx)

    def _emit_rows(self, sel, batch, idx, idx_device=None, cols=None
                   ) -> SelectResponse:
        """The filter/TopN survivors: under `columnar_hint` the scan's
        planes and selection index (ColumnarScanResult; `idx_device`, the
        same index on the card where the filter left it), else rows.
        `cols` defaults to the request's own columns."""
        if cols is None:
            cols = sel.table_info.columns
        if sel.columnar_hint:
            return SelectResponse(columnar=col.ColumnarScanResult(
                batch, np.asarray(idx, dtype=np.int64), list(cols),
                device=self.device, sel_device=idx_device))
        writer = ChunkWriter()
        planes = batch.columns
        for i in np.asarray(idx, dtype=np.int64).tolist():
            row = [col.plane_datum(planes[c.column_id], c, i) for c in cols]
            writer.append_row(int(batch.handles[i]), row)
        return SelectResponse(chunks=writer.finish())


# ---------------------------------------------------------------------------
# datum reconstruction from a request's decode tables
# ---------------------------------------------------------------------------

def _i64_datum(dec: _Decode, cid: int, iv: int) -> Datum:
    """Int-plane value → Datum via the column's MySQL type."""
    pb = dec.col_pb.get(cid)
    tp = pb.tp if pb is not None else None
    if tp in my.TIME_TYPES:
        return Datum(Kind.TIME, Time.from_packed_int(iv, tp))
    if tp == my.TypeDuration:
        return Datum(Kind.DURATION, Duration(iv))
    if pb is not None and my.has_unsigned_flag(pb.flag):
        return Datum.u64(iv)
    return Datum.i64(iv)


def _col_datum_at(dec: _Decode, cid: int, i: int) -> Datum:
    cd = dec.batch.columns[cid]
    if not cd.valid[i]:
        return NULL
    if cd.kind == col.K_STR:
        return Datum.bytes_(cd.dictionary[int(cd.values[i])])
    if cd.kind == col.K_F64:
        return Datum.f64(float(cd.values[i]))
    if cd.kind == col.K_DEC:
        return Datum.dec(Decimal(int(cd.values[i]))
                         / (Decimal(10) ** cd.dec_scale))
    return _i64_datum(dec, cid, int(cd.values[i]))


def _phys_to_datum(dec: _Decode, agg_expr, v) -> Datum:
    """Physical kernel value → Datum, reversing columnar.datum_to_phys
    using the aggregate argument's column type."""
    arg = agg_expr.children[0] if agg_expr.children else None
    tp = None
    if arg is not None and arg.tp == ExprType.COLUMN_REF:
        pb = dec.col_pb.get(arg.val)
        tp = pb.tp if pb is not None else None
    if isinstance(v, np.floating):
        return Datum.f64(float(v))
    iv = int(v)
    if tp in my.TIME_TYPES:
        return Datum(Kind.TIME, Time.from_packed_int(iv, tp))
    if tp == my.TypeDuration:
        return Datum(Kind.DURATION, Duration(iv))
    if tp in my.STRING_TYPES:
        # min/max over dict codes: decode via the arg column dictionary
        d = dec.dict_for.get(arg.val)
        return Datum.bytes_(d[iv]) if d is not None and 0 <= iv < len(d) \
            else NULL
    return Datum.i64(iv)
