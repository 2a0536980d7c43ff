"""GpuClient: the coprocessor on the card behind the kv.Client boundary
(the port of tidb_tpu/ops/client.py:99-1008, TpuClient).

Per request:
  1. a columnar batch for (table, columns, ranges, data version) — packed
     once, cached, its planes resident on the device;
  2. the WHERE and every aggregate argument compile into ONE bytecode
     program (ops.exprc) that kernel K1 runs, then K2/K3/K4 reduce
     (ops.kernels), or the filter's survivors are gathered;
  3. results go back as the SAME partial-row chunk protocol the CPU engine
     and TpuClient emit (TpuClient under tidb_tpu_columnar_scan=0: the
     port never answers the columnar payloads).

A request outside slice 1 (index scans, TopN, HAVING, DISTINCT, ranked
group-by) raises Unsupported: the port has no CPU engine to hand it to.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import torch

from tidb_tpu_torch import errors, mysqldef as my
from tidb_tpu_torch import tablecodec as tc
from tidb_tpu_torch.codec import codec
from tidb_tpu_torch.copr.proto import (ChunkWriter, ExprType, SelectRequest,
                                       SelectResponse)
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import Program, Unsupported, compile_expr
from tidb_tpu_torch.types.datum import NULL, Datum, Kind
from tidb_tpu_torch.types.time_types import Duration, Time


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


class _SingleResponse(kv.Response):
    def __init__(self, resp: SelectResponse):
        self._resp = resp

    def next(self):
        r, self._resp = self._resp, None
        return r


class GpuClient(kv.Client):
    def __init__(self, store, device=None):
        self.store = store
        self.device = resolve_device(device)
        self._batch_cache: dict = {}
        self.stats = {"gpu_requests": 0, "batch_packs": 0, "batch_hits": 0,
                      "launches": {k: 0 for k in kernels.LAUNCHES}}

    # ------------------------------------------------------------------

    def send(self, req: kv.Request) -> kv.Response:
        sel: SelectRequest = req.data
        if req.tp != kv.REQ_TYPE_SELECT or sel.table_info is None:
            raise Unsupported("only table scans are served (index "
                              "requests come with a later slice)")
        resp = self._send_gpu(req, sel)
        self.stats["gpu_requests"] += 1
        return _SingleResponse(resp)

    def _get_batch(self, sel: SelectRequest, ranges) -> col.ColumnBatch:
        src = sel.table_info
        cols = src.columns
        sig = tuple((c.column_id, c.tp, c.flag, c.flen, c.decimal,
                     c.pk_handle, repr(c.default_val)) for c in cols)
        key = (src.table_id, sig, tuple((r.start, r.end) for r in ranges))
        version = self.store.data_version_at(sel.start_ts,
                                             tc.table_prefix(src.table_id))
        ent = self._batch_cache.get(key)
        if ent is not None and ent[1] == version:
            self.stats["batch_hits"] += 1
            return ent[0]
        snapshot = self.store.get_snapshot(sel.start_ts)
        defaults = {c.column_id: c.default_val for c in cols
                    if c.default_val is not None}
        self.stats["batch_packs"] += 1
        batch = col.pack_ranges(snapshot, src.table_id, cols, ranges,
                                defaults)
        self._batch_cache[key] = (batch, version)
        if len(self._batch_cache) > 64:
            self._batch_cache.pop(next(iter(self._batch_cache)))
        return batch

    def _send_gpu(self, req: kv.Request, sel: SelectRequest) -> SelectResponse:
        return self.serve(sel, self._get_batch(sel, req.key_ranges))

    def serve(self, sel: SelectRequest, batch: col.ColumnBatch
              ) -> SelectResponse:
        """Answer `sel` over an already packed batch (what send does after
        packing; a caller holding planes drives the same path)."""
        if sel.having is not None:
            raise Unsupported("having not lowered")
        # per-request decode tables for datum reconstruction
        self._cur_batch = batch
        self._cur_cols = sel.table_info.columns
        self._col_pb = {c.column_id: c for c in self._cur_cols}
        self._dict_for = {cid: cd.dictionary
                          for cid, cd in batch.columns.items()
                          if cd.kind == col.K_STR}
        prog = Program(batch)
        where = compile_expr(sel.where, batch, prog) \
            if sel.where is not None else None
        if sel.is_agg():
            return self._run_aggregate(sel, batch, prog, where)
        if sel.order_by:
            raise Unsupported("TopN is not ported yet")
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

    def _run_aggregate(self, sel, batch, prog, where) -> SelectResponse:
        specs = kernels.lower_aggregates(sel, batch, prog)
        planes = kernels.batch_planes(batch, self.device)
        live = kernels.device_live(batch, self.device)
        if sel.group_by:
            gspec = kernels.lower_group_by(sel, batch)
            if gspec.kind != "radix":
                raise Unsupported("group cardinality beyond the radix "
                                  "ceiling needs the ranked kernel, not "
                                  "ported yet")
            planes = self._with_group_planes(batch, gspec, planes)
            fn = kernels.build_grouped_agg_fn(prog, where, specs,
                                              gspec.plane_keys, gspec.sizes)
            outs = self._dispatch(fn, planes, live)
            return self._emit_grouped(sel, batch, specs, gspec, fn.radices,
                                      outs)
        fn = kernels.build_scalar_agg_fn(prog, where, specs)
        outs = self._dispatch(fn, planes, live)
        return self._emit_scalar(sel, batch, specs, outs)

    def _emit_scalar(self, sel, batch, specs, outs) -> SelectResponse:
        row: list[Datum] = [Datum.bytes_(b"")]
        i = 0
        for spec, e in zip(specs, sel.aggregates):
            row.extend(self._partial_datums(spec, e, outs, i, None))
            i += _n_outputs(spec)
        return self._agg_response([(0, row)])

    def _with_group_planes(self, batch, gspec, planes):
        """Add host-built group-code planes (device-cached on the batch):
        per-column numeric codes; the valid plane is the column's own."""
        extra = [k for k in gspec.plane_keys
                 if k <= kernels.GC_BASE]
        if not extra:
            return planes
        cache = getattr(batch, "_device_gcodes", None)
        if cache is None:
            cache = batch._device_gcodes = {}
        planes = dict(planes)
        for key in extra:
            cid = kernels.GC_BASE - key
            ck = (str(self.device), cid)
            arr = cache.get(ck)
            if arr is None:
                codes, _uniq = batch.group_codes(cid)
                arr = cache[ck] = torch.from_numpy(codes).to(self.device)
            planes[key] = (arr, planes[cid][1])
        return planes

    def _group_datum(self, cid: int, decoder, code: int) -> Datum:
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
        return self._i64_datum(cid, int(v))

    def _emit_grouped(self, sel, batch, specs, gspec, radices,
                      outs) -> SelectResponse:
        rows: list = []
        row_count = outs[0]
        n_segments = row_count.shape[0]
        live_gids = np.nonzero(row_count[:n_segments - 1] > 0)[0]
        for gid in live_gids.tolist():
            # decode mixed-radix gid → per-column codes
            codes = []
            rem = gid
            for radix in reversed(radices):
                codes.append(rem % radix)
                rem //= radix
            codes.reverse()
            gvals = []
            for code, size, cid, dec in zip(codes, gspec.sizes, gspec.cids,
                                            gspec.decoders):
                gvals.append(NULL if code >= size
                             else self._group_datum(cid, dec, code))
            gk = codec.encode_value(gvals)
            row: list[Datum] = [Datum.bytes_(gk)]
            i = 1  # outs[0] is row_count
            for spec, e in zip(specs, sel.aggregates):
                row.extend(self._partial_datums(spec, e, outs, i, gid))
                i += _n_outputs(spec)
            rows.append((0, row))
        return self._agg_response(rows)

    def _agg_response(self, rows: list) -> SelectResponse:
        writer = ChunkWriter()
        for handle, row in rows:
            writer.append_row(handle, row)
        return SelectResponse(chunks=writer.finish())

    def _partial_datums(self, spec, agg_expr, outs, i, gid) -> list[Datum]:
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
            return [self._col_datum_at(self._cur_batch,
                                       agg_expr.children[0].val, int(v))]
        if name in ("min", "max"):
            if n == 0:
                return [NULL]
            if dec_scale is not None:
                return [Datum.dec(Decimal(int(v))
                                  / (Decimal(10) ** dec_scale))]
            return [self._phys_to_datum(agg_expr, v)]
        raise Unsupported(name)

    def _i64_datum(self, cid: int, iv: int) -> Datum:
        """Int-plane value → Datum via the column's MySQL type."""
        pb = self._col_pb.get(cid)
        tp = pb.tp if pb is not None else None
        if tp in my.TIME_TYPES:
            return Datum(Kind.TIME, Time.from_packed_int(iv, tp))
        if tp == my.TypeDuration:
            return Datum(Kind.DURATION, Duration(iv))
        if pb is not None and my.has_unsigned_flag(pb.flag):
            return Datum.u64(iv)
        return Datum.i64(iv)

    def _col_datum_at(self, batch, cid: int, i: int) -> Datum:
        cd = batch.columns[cid]
        if not cd.valid[i]:
            return NULL
        if cd.kind == col.K_STR:
            return Datum.bytes_(cd.dictionary[int(cd.values[i])])
        if cd.kind == col.K_F64:
            return Datum.f64(float(cd.values[i]))
        if cd.kind == col.K_DEC:
            return Datum.dec(Decimal(int(cd.values[i]))
                             / (Decimal(10) ** cd.dec_scale))
        return self._i64_datum(cid, int(cd.values[i]))

    def _phys_to_datum(self, agg_expr, v) -> Datum:
        """Physical kernel value → Datum, reversing columnar.datum_to_phys
        using the aggregate argument's column type."""
        arg = agg_expr.children[0] if agg_expr.children else None
        tp = None
        if arg is not None and arg.tp == ExprType.COLUMN_REF:
            pb = self._col_pb.get(arg.val)
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
            d = self._dict_for.get(arg.val)
            return Datum.bytes_(d[iv]) if d is not None and 0 <= iv < len(d) \
                else NULL
        return Datum.i64(iv)

    # ------------------------------------------------------------------
    # filter
    # ------------------------------------------------------------------

    def _run_filter(self, sel, batch, prog, where) -> SelectResponse:
        fn = kernels.build_filter_fn(prog, where)
        planes = kernels.batch_planes(batch, self.device)
        live = kernels.device_live(batch, self.device)
        idx = self._dispatch(
            lambda p, lv: torch.nonzero(fn(p, lv)[0]).squeeze(1).cpu()
            .numpy(), planes, live)
        if sel.desc:
            idx = idx[::-1]
        if sel.limit is not None:
            idx = idx[: sel.limit]
        return self._emit_rows(batch, idx)

    def _emit_rows(self, batch, idx) -> SelectResponse:
        writer = ChunkWriter()
        planes = batch.columns
        for i in idx.tolist():
            row = [col.plane_datum(planes[c.column_id], c, i)
                   for c in self._cur_cols]
            writer.append_row(int(batch.handles[i]), row)
        return SelectResponse(chunks=writer.finish())
