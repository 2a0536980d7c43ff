"""A region's columnar answer to a pushed-down aggregate or a plain scan
(the port of tidb_tpu/copr/columnar_region.py).

A plain scan (no aggregate, no ORDER BY) packs or hits the same plane
cache, runs its WHERE in one K1 launch over the region's planes and
answers a ColumnarScanResult (the survivors' positions, also kept on the
card) carrying the region's id and epoch; distsql stacks the regions'
answers into a ColumnarPartialSet. TopN over regions raises Unsupported.

Each region of the cluster store answers its share of a `columnar_hint`
aggregate request itself: its clipped ranges pack into a ColumnBatch (or
hit the region's plane cache, planes pinned on the device, or merge an
older cached batch with the region's delta pack, copr.delta), the WHERE and
every aggregate-argument expression compile into one register program,
and the response ships a ColumnarAggStates payload with the filter and
the states still PENDING. The statement finisher (`finish_states_batch`,
called by distsql once every region answered) then runs

  K5  every region's program in one launch (survivor bits + argument
      planes), the bits read back;
  host  group discovery in first-appearance order per region (np.unique
      over the survivors' tuple codes), codec-encoded group keys, the
      contributing-row masks of every reduction;
  K6  every region's segment states in one launch (with the process
      mesh up, more than one shard and no argument planes: on each
      region's home shard, one launch over the shard layout, ops.mesh);
  host  the per-group state columns, float SUM/AVG summed in row order.

The reference routes statements below STATES_DEVICE_FLOOR to host numpy
and degrades through mesh → batched → serial → host on device faults;
the port has one route: on the card every statement runs K5 and K6, and
a fault raises. Where the reference answers a region with the row
handler (`handle_columnar_scan` → None, `_prepare_states` → None), the
port raises Unsupported: it has no row engine.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import torch

from tidb_tpu_torch import errors, mysqldef as my, tablecodec as tc
from tidb_tpu_torch.codec import codec
from tidb_tpu_torch.copr.proto import (AGG_NAME, ExprType, SelectRequest,
                                       SelectResponse, arg_plane_shape_ok)
from tidb_tpu_torch.ops import columnar as col, exprc, extsort, kernels
from tidb_tpu_torch.ops import mesh as mesh_mod
from tidb_tpu_torch.ops.client import resolve_device
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.types.datum import NULL, Datum

def cache_key(region_id: int, sel: SelectRequest, ranges) -> tuple:
    """The plane-cache key of one region's share of a table request: the
    region, the table, the schema signature of the requested columns and
    the clipped range bounds."""
    return (region_id, sel.table_info.table_id,
            _columns_sig(sel.table_info.columns),
            tuple((r.start, r.end) for r in ranges))


def handle_columnar_scan(snapshot, sel: SelectRequest, ranges, region=None,
                         cache=None, delta=None, oldest_ts: int | None = None,
                         device=None) -> SelectResponse:
    """One region's share of a columnar_hint request: an aggregate as a
    pending ColumnarAggStates payload, a plain scan as a
    ColumnarScanResult. `region` is (region_id, epoch).

    With a `cache` and a snapshot over the MVCC store (`snapshot.mvcc`,
    `snapshot.read_ts`), the packed batch is served from / admitted to the
    region's plane cache at the table's data version as of read_ts
    (tidb_tpu/copr/columnar_region.py:136-190):
    - the Percolator lock gate: a blocking lock in range forces the pack
      path, whose scan raises KeyIsLockedError;
    - with a `delta` store, a miss whose older base the delta pack covers
      merges base + delta (_delta_merge) instead of re-packing;
    - generations at or above the version of the oldest active reader
      (`oldest_ts`) stay cached for it.

    `device` None means the card (DeviceError without CUDA); only "cpu"
    selects the plain versions. Raises Unsupported for every shape the
    port does not answer."""
    device = resolve_device(device)
    if sel.table_info is None:
        raise Unsupported("index requests over regions come in a later "
                          "slice")
    agg_specs = None
    if sel.is_agg():
        agg_specs = _states_specs(sel)
        if agg_specs is None:
            raise Unsupported("aggregate shape outside the states channel")
    elif sel.order_by:
        raise Unsupported("TopN over regions comes in a later slice")
    columns = sel.table_info.columns
    defaults = {c.column_id: c.default_val for c in columns
                if c.default_val is not None}
    table_id = sel.table_info.table_id
    batch = key = version = prefix = None
    mvcc = getattr(snapshot, "mvcc", None)
    if cache is not None and region is not None and mvcc is not None \
            and not any(mvcc.has_blocking_lock(snapshot.read_ts, rg.start,
                                               rg.end) for rg in ranges):
        prefix = tc.table_prefix(table_id)
        version = mvcc.data_version_at(snapshot.read_ts, prefix)
        key = cache_key(region[0], sel, ranges)
        base_ok = None
        if delta is not None and delta.enabled:
            def base_ok(v0):
                return delta.usable(region[0], table_id, v0, version, mvcc,
                                    prefix)
        keep_version = (mvcc.data_version_at(oldest_ts, prefix)
                        if oldest_ts is not None else None)
        batch, dbase = cache.lookup_with_base(key, region[1], version,
                                              base_ok, keep_version)
        if batch is None and dbase is not None:
            batch = _delta_merge(delta, dbase, key, region, version, mvcc,
                                 prefix, snapshot.read_ts, columns, ranges,
                                 defaults, cache, device)
    try:
        if batch is None:
            batch = col.pack_ranges(snapshot, table_id, columns, ranges,
                                    defaults)
            # sound only if the visible version held still across the pack
            if key is not None and \
                    mvcc.data_version_at(snapshot.read_ts, prefix) == version:
                cache.insert(key, region[1], version, batch)
        if agg_specs is None:
            return _scan_response(sel, batch, region, columns, device)
        return _deferred_filter_response(sel, batch, agg_specs, region,
                                         columns, device)
    except errors.TypeError_ as e:
        # no exact plane mapping: the reference's row handler answers
        raise Unsupported(f"no exact plane mapping: {e}") from e


def _delta_merge(delta, dbase, key, region, version: int, mvcc,
                 prefix: bytes, read_ts: int, columns, ranges, defaults,
                 cache, device):
    """The scan-time base + delta merge (tidb_tpu/copr/columnar_region.py
    :309-369): the merged batch, admitted as the current generation (a
    version-only merge moves the base entry instead), with the pack folded
    and reset when its delta outgrew the budget; or None → the pack path."""
    base_batch, base_version = dbase
    merged = delta.merge(base_batch, base_version, key, version, mvcc,
                         prefix, columns, ranges, defaults, device)
    if merged is None:
        return None
    if mvcc.data_version_at(read_ts, prefix) == version:
        if not (merged is base_batch
                and cache.rekey(key, region[1], base_version, version)):
            with kernels.phase("merge_pin", device):
                cache.insert(key, region[1], version, merged)
        if delta.repack_due(region[0], key[1]):
            delta.reset(region[0], key[1])
            delta.stats["repacks"] += 1
    return merged


def _columns_sig(columns) -> tuple:
    """Schema signature of the requested columns: the cache-key part that
    changes when DDL changes a column's shape."""
    return tuple(
        (c.column_id, c.tp, c.flag, c.flen, c.decimal, c.pk_handle,
         tuple(c.elems or ()),
         repr(c.default_val) if c.default_val is not None else None)
        for c in columns)


def _states_probe(batch: col.ColumnBatch, agg_specs, colpb: dict) -> bool:
    """Can _prepare_states refuse ANY survivor mask of this batch?
    Evaluated before the filter runs, against the superset mask (all
    packed rows): the structural exits are mask-independent and the two
    mask-dependent guards (-0.0 in a float min/max plane, the int-sum
    wrap bound) are monotone, so passing here proves the finisher cannot
    refuse."""
    specs, gcids = agg_specs
    for cid in gcids:
        cd = batch.columns.get(cid)
        c = colpb.get(cid)
        if cd is None or c is None or not _group_plane(cd, c):
            return False
    sup = batch.row_mask()
    for name, arg in specs:
        if arg is None or arg.tp == ExprType.VALUE:
            continue
        if arg.tp != ExprType.COLUMN_REF:
            if not _probe_arg_plane(name, arg, batch, colpb, sup):
                return False
            continue
        cd = batch.columns.get(arg.val)
        c = colpb.get(arg.val)
        if cd is None or c is None:
            return False
        if name == "count":
            continue
        if name == "first_row":
            if not _group_plane(cd, c):
                return False
            continue
        if cd.kind == col.K_F64:
            if name in ("sum", "avg"):
                continue
            contrib = sup & cd.valid
            if bool(np.any((cd.values == 0.0) & np.signbit(cd.values)
                           & contrib)):
                return False
            continue
        if cd.kind == col.K_STR:
            if name not in ("min", "max"):
                return False
            continue
        if not (cd.kind == col.K_DEC or _int_plane(cd, c)):
            return False
        if name in ("sum", "avg"):
            n_sup = int(np.count_nonzero(sup & cd.valid))
            mx = cd.max_abs
            if mx and n_sup and mx * n_sup >= (1 << 63):
                return False
    return True


def _probe_arg_plane(name: str, arg, batch: col.ColumnBatch, colpb: dict,
                     sup: np.ndarray) -> bool:
    try:
        prog = exprc.compile_arg_plane(arg, batch, colpb)
    except (Unsupported, errors.TypeError_):
        return False
    if name == "count":
        return True
    if prog.kind == col.K_F64:
        return name in ("sum", "avg")
    if name in ("sum", "avg"):
        n_sup = int(np.count_nonzero(sup))
        mx = prog.max_abs
        if mx and n_sup and mx * n_sup >= (1 << 63):
            return False
    return True


def _scan_response(sel: SelectRequest, batch: col.ColumnBatch, region,
                   columns, device) -> SelectResponse:
    """A plain scan's answer (the eager tail of the reference's
    handle_columnar_scan, :439 _filter_mask, :282 ColumnarScanResult): the
    WHERE in one K1 launch over the region's resident planes, the
    survivors' positions kept on the card for device_plane and read back
    once, then DESC and LIMIT, the region's (id, epoch) on the answer."""
    prog = exprc.Program(batch)
    where = None
    if sel.where is not None:
        where = exprc.compile_expr(sel.where, batch, prog)
        if where.reg is None:
            raise Unsupported("WHERE is a bare string constant")
    fn = kernels.build_filter_fn(prog, where)
    planes = kernels.batch_planes(batch, device)
    live = kernels.device_live(batch, device)
    with kernels.phase("k1", device):
        idx_d = torch.nonzero(fn(planes, live)[0]).squeeze(1)
    with kernels.phase("sel_readback", device):
        idx = idx_d.cpu().numpy()
    if sel.desc:
        idx, idx_d = idx[::-1], None
    if sel.limit is not None and sel.limit < len(idx):
        idx, idx_d = idx[:sel.limit], None
    res = col.ColumnarScanResult(batch, idx, list(columns), device=device,
                                 sel_device=idx_d)
    if region is not None:
        res.region_id, res.region_epoch = region
    return SelectResponse(columnar=res)


def _deferred_filter_response(sel: SelectRequest, batch: col.ColumnBatch,
                              agg_specs, region, columns,
                              device) -> SelectResponse:
    """The region's payload with its filter and states pending. The WHERE
    and the argument expressions compile into ONE program, which K5 runs
    for every region of the statement at once."""
    colpb = {c.column_id: c for c in columns}
    if not _states_probe(batch, agg_specs, colpb):
        raise Unsupported("aggregate states could need the row engine "
                          "for this region")
    prog = exprc.Program(batch)
    where = None
    if sel.where is not None:
        where = exprc.compile_expr(sel.where, batch, prog)
        if where.reg is None:
            raise Unsupported("WHERE is a bare string constant")
    arg_progs = {}
    for i, (_name, arg) in enumerate(agg_specs[0]):
        if arg is not None and arg.tp not in (ExprType.VALUE,
                                              ExprType.COLUMN_REF):
            arg_progs[i] = exprc.compile_arg_plane(arg, batch, colpb, prog)
    order = sorted(arg_progs)
    fin = prog.finalize(where, [arg_progs[i].compiled for i in order])
    pending = _PendingFilter(batch, agg_specs, colpb, fin, arg_progs,
                             {i: j for j, i in enumerate(order)}, device)
    payload = col.ColumnarAggStates(None, None, list(sel.aggregates),
                                    colpb, pending=pending)
    pending.payload = payload
    payload.device = device
    if region is not None:
        payload.region_id = region[0]
        payload.region_epoch = region[1]
    return SelectResponse(columnar=payload)


# ---------------------------------------------------------------------------
# grouped partial STATES
# ---------------------------------------------------------------------------

_STATES_NAMES = ("count", "sum", "avg", "min", "max", "first_row")


def _states_specs(sel: SelectRequest):
    """Structural gate, before any pack: (agg specs, group column ids)
    when every aggregate and group item is expressible as exact
    per-group monoid states, else None."""
    if sel.having is not None or sel.order_by or sel.limit is not None \
            or sel.desc:
        return None
    specs = []
    for e in sel.aggregates:
        name = AGG_NAME.get(e.tp)
        if name not in _STATES_NAMES or e.distinct or len(e.children) > 1:
            return None
        arg = e.children[0] if e.children else None
        if arg is None or arg.tp == ExprType.VALUE:
            if name != "count":
                return None
        elif arg.tp != ExprType.COLUMN_REF:
            if not arg_plane_shape_ok(name, arg):
                return None
        specs.append((name, arg))
    gcids = []
    for item in sel.group_by:
        if item.expr.tp != ExprType.COLUMN_REF:
            return None
        gcids.append(item.expr.val)
    return specs, gcids


def _int_plane(cd: col.ColumnData, c) -> bool:
    """A plain-integer int64 plane (times/durations/bits excluded)."""
    return cd.kind == col.K_I64 and c.tp in my.INTEGER_TYPES


def _temporal_plane(cd: col.ColumnData, c) -> bool:
    return cd.kind == col.K_I64 and (c.tp in my.TIME_TYPES
                                     or c.tp == my.TypeDuration)


def _group_plane(cd: col.ColumnData, c) -> bool:
    """GROUP-key plane kinds: strings (sorted dictionary codes), floats,
    plain ints, decimals and times/durations."""
    return (cd.kind in (col.K_STR, col.K_F64, col.K_DEC)
            or _int_plane(cd, c) or _temporal_plane(cd, c))


def _flat_datum(cd: col.ColumnData, c, i: int) -> Datum:
    """Plane cell i → the flattened storage datum the row handler's
    decoded row carries: unsigned integers keep UINT64, decimals keep the
    column scale."""
    if cd.valid[i]:
        if cd.kind == col.K_I64 and my.has_unsigned_flag(c.flag):
            return Datum.u64(int(cd.values[i]))
        if cd.kind == col.K_DEC:
            return Datum.dec(
                Decimal(int(cd.values[i])).scaleb(-cd.dec_scale))
    return col.plane_datum(cd, c, i)


class ArgPlaneSpec:
    """The VALUE slot of one expression-argument reduction: the compiled
    program and this region's (values, valid) planes of it, views into
    K5's concatenated outputs on the device."""

    is_arg_plane = True

    __slots__ = ("prog", "values", "valid")

    def __init__(self, prog, values: torch.Tensor, valid: torch.Tensor):
        self.prog = prog
        self.values = values
        self.valid = valid


def _prepare_states(batch: col.ColumnBatch, mask: np.ndarray, agg_specs,
                    colpb: dict, arg_planes: dict, device):
    """Everything between the survivor mask and K6: group discovery in
    first-appearance scan order, codec-encoded group keys, the reductions
    and the state builders. Returns (group_keys, _PendingStates), or None
    where the reference would answer the region with rows (every such
    exit is mask-independent or monotone, see _states_probe)."""
    specs, gcids = agg_specs
    live_idx = np.nonzero(mask)[0]
    for cid in gcids:
        cd = batch.columns.get(cid)
        c = colpb.get(cid)
        if cd is None or c is None or not _group_plane(cd, c):
            return None
    if gcids:
        codes, _percol = batch.tuple_codes(gcids)
        lg = codes[mask]
    else:
        lg = np.zeros(len(live_idx), dtype=np.int64)
    uniq, first_idx, inv = np.unique(lg, return_index=True,
                                     return_inverse=True)
    G = len(uniq)
    # region-local groups in FIRST-APPEARANCE scan order
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(G, np.int64)
    rank[order] = np.arange(G, dtype=np.int64)
    rep_rows = live_idx[first_idx[order]]
    gid = np.full(batch.capacity, G, dtype=np.int64)   # dead-row sink
    if G:
        gid[mask] = rank[np.reshape(inv, -1)]
    group_keys = []
    for r in rep_rows.tolist():
        gvals = [_flat_datum(batch.columns[cid], colpb[cid], int(r))
                 for cid in gcids]
        group_keys.append(codec.encode_value(gvals))
    planes = kernels.batch_planes(batch, device)

    reductions: list = []       # (op, values | None | ArgPlaneSpec, contrib)
    builders: list = []

    def red(op, vals, ok) -> int:
        reductions.append((op, vals, ok))
        return len(reductions) - 1

    for i, (name, arg) in enumerate(specs):
        if arg is None or arg.tp == ExprType.VALUE:
            const = arg.val if arg is not None else Datum.i64(1)
            contrib = np.zeros(batch.capacity, bool) if const.is_null() \
                else mask
            ci = red("sum", None, contrib)
            builders.append(lambda outs, ci=ci: col.AggStateCol(
                "count", outs[ci].astype(np.int64)))
            continue
        if arg.tp != ExprType.COLUMN_REF:
            prog, (pv, pva) = arg_planes[i]
            spec = ArgPlaneSpec(prog, pv, pva)
            if name == "count":
                ci = red("cnt", spec, mask)
                builders.append(lambda outs, ci=ci: col.AggStateCol(
                    "count", outs[ci].astype(np.int64)))
                continue
            if prog.kind == col.K_F64:
                if name in ("min", "max"):
                    return None
                # float SUM/AVG: the plane reads back row-space and sums
                # on the host in row order (np.add.at is unbuffered)
                ci = red("cnt", spec, mask)
                pi = red("plane", spec, mask)
                qi = red("pvalid", spec, mask)

                def fbuild(outs, ci=ci, pi=pi, qi=qi, name=name, gid=gid,
                           G=G):
                    sums = np.zeros(G, np.float64)
                    if G:
                        pok = np.asarray(outs[qi]).astype(bool)
                        np.add.at(sums, gid[pok], outs[pi][pok])
                    return col.AggStateCol(name, outs[ci].astype(np.int64),
                                           values=sums, op="sum",
                                           kind="f64")
                builders.append(fbuild)
                continue
            kind = "dec" if prog.kind == col.K_DEC else "i64"
            scale = prog.scale
            if name in ("sum", "avg"):
                n_contrib = int(np.count_nonzero(mask))
                mx = prog.max_abs
                if mx and n_contrib and mx * n_contrib >= (1 << 63):
                    return None
                ci = red("cnt", spec, mask)
                vi = red("sum", spec, mask)
            else:
                ci = red("cnt", spec, mask)
                vi = red("min" if name == "min" else "max", spec, mask)
            op = "sum" if name in ("sum", "avg") else name
            builders.append(
                lambda outs, ci=ci, vi=vi, name=name, op=op, kind=kind,
                scale=scale:
                col.AggStateCol(name, outs[ci].astype(np.int64),
                                values=outs[vi], op=op, kind=kind,
                                dec_scale=scale))
            continue
        cd = batch.columns.get(arg.val)
        c = colpb.get(arg.val)
        if cd is None or c is None:
            return None
        contrib = mask & cd.valid
        if name == "count":
            ci = red("sum", None, contrib)
            builders.append(lambda outs, ci=ci: col.AggStateCol(
                "count", outs[ci].astype(np.int64)))
            continue
        if name == "first_row":
            if not _group_plane(cd, c):
                return None
            datums = [_flat_datum(cd, c, int(r)) for r in rep_rows.tolist()]
            ci = red("sum", None, mask)
            builders.append(lambda outs, ci=ci, datums=datums, name=name:
                            col.AggStateCol(name,
                                            outs[ci].astype(np.int64),
                                            datums=datums))
            continue
        if cd.kind == col.K_F64:
            vals = cd.values
            if name in ("sum", "avg"):
                # float sums on the host in row order, as the row
                # accumulator adds them
                sums = np.zeros(G, np.float64)
                np.add.at(sums, gid[contrib], vals[contrib])
                ci = red("sum", None, contrib)
                builders.append(
                    lambda outs, ci=ci, sums=sums, name=name:
                    col.AggStateCol(name, outs[ci].astype(np.int64),
                                    values=sums, op="sum", kind="f64"))
                continue
            if bool(np.any((vals == 0.0) & np.signbit(vals) & contrib)):
                return None
            ci = red("sum", None, contrib)
            vi = red("min" if name == "min" else "max", planes[arg.val][0],
                     contrib)
            builders.append(
                lambda outs, ci=ci, vi=vi, name=name:
                col.AggStateCol(name, outs[ci].astype(np.int64),
                                values=outs[vi], op=name, kind="f64"))
            continue
        if cd.kind == col.K_STR:
            if name not in ("min", "max"):
                return None
            # dictionary codes sort as the bytes do
            ci = red("sum", None, contrib)
            vi = red("min" if name == "min" else "max", planes[arg.val][0],
                     contrib)
            dic = cd.dictionary
            builders.append(
                lambda outs, ci=ci, vi=vi, name=name, dic=dic:
                col.AggStateCol(
                    name, outs[ci].astype(np.int64),
                    datums=[NULL if int(n) == 0
                            else Datum.bytes_(dic[int(v)])
                            for n, v in zip(outs[ci], outs[vi])]))
            continue
        if not (cd.kind == col.K_DEC or _int_plane(cd, c)):
            return None
        kind = "dec" if cd.kind == col.K_DEC else "i64"
        scale = cd.dec_scale
        if name in ("sum", "avg"):
            n_contrib = int(np.count_nonzero(contrib))
            mx = cd.max_abs
            if mx and n_contrib and mx * n_contrib >= (1 << 63):
                return None
            ci = red("sum", None, contrib)
            vi = red("sum", planes[arg.val][0], contrib)
        else:
            ci = red("sum", None, contrib)
            vi = red("min" if name == "min" else "max", planes[arg.val][0],
                     contrib)
        op = "sum" if name in ("sum", "avg") else name
        builders.append(
            lambda outs, ci=ci, vi=vi, name=name, op=op, kind=kind,
            scale=scale, c=c:
            col.AggStateCol(name, outs[ci].astype(np.int64),
                            values=outs[vi], op=op, kind=kind,
                            dec_scale=scale, pb_col=c))
    pending = _PendingStates(batch, gid, reductions, G, builders,
                             len(live_idx), group_keys)
    return group_keys, pending


class _PendingStates:
    """One region's pending states pass: the host-built group ids,
    reductions and state builders; K6 computes the reductions for every
    region of the statement at once."""

    __slots__ = ("batch", "gid", "reductions", "G", "builders", "n_live",
                 "group_keys")

    def __init__(self, batch, gid, reductions, G, builders, n_live,
                 group_keys):
        self.batch = batch
        self.gid = gid
        self.reductions = reductions
        self.G = G
        self.builders = builders
        self.n_live = n_live
        self.group_keys = group_keys

    def signature(self) -> tuple:
        """The statement's aggregate shape: regions must share it to
        share one K6 launch."""
        sig = []
        for op, v, _ok in self.reductions:
            if v is None:
                sig.append((op, "c"))
            elif getattr(v, "is_arg_plane", False):
                sig.append((op, "x") + v.prog.sig)
            else:
                sig.append((op, str(v.dtype)))
        return tuple(sig)

    def finish(self, outs) -> list:
        return [build(outs) for build in self.builders]


class _PendingFilter:
    """One region's pending filter + states pass: its compiled program
    (WHERE and argument outputs) and everything _prepare_states needs
    once the survivor mask exists."""

    __slots__ = ("batch", "agg_specs", "colpb", "fin", "arg_progs",
                 "out_index", "device", "payload")

    is_filter = True

    def __init__(self, batch, agg_specs, colpb, fin, arg_progs, out_index,
                 device):
        self.batch = batch
        self.agg_specs = agg_specs
        self.colpb = colpb
        self.fin = fin
        self.arg_progs = arg_progs
        self.out_index = out_index
        self.device = device
        self.payload = None

    def region_program(self) -> kernels.RegionProgram:
        planes = kernels.batch_planes(self.batch, self.device)
        return kernels.RegionProgram(
            self.fin, [planes[k][w] for k, w in self.fin.plane_keys],
            self.batch.capacity, self.batch.n_rows)

    def fulfill_mask(self, mask: np.ndarray, outs: list, base: int) -> None:
        """Survivor mask (and K5's argument planes, this region's rows at
        `base` of the concatenated outputs) → group keys and pending
        states on the payload."""
        cap = self.batch.capacity
        arg_planes = {i: (self.arg_progs[i],
                          (outs[j][0][base:base + cap],
                           outs[j][1][base:base + cap]))
                      for i, j in self.out_index.items()}
        prepared = _prepare_states(self.batch, mask, self.agg_specs,
                                   self.colpb, arg_planes, self.device)
        # _states_probe proved every refusal unreachable for any mask
        assert prepared is not None, "deferred filter lost its states"
        group_keys, pending = prepared
        self.payload.group_keys = group_keys
        self.payload._pending = pending


def _finish_filter_batch(group, device) -> None:
    """Every pending region's survivor mask and argument planes from one
    K5 launch; the bits come back to the host, where each region builds
    its group ids and reductions."""
    pends = [p._pending for p in group]
    with kernels.phase("k5", device):
        bits, outs = kernels.region_filter_batched(
            [pe.region_program() for pe in pends], device)
    with kernels.phase("mask_readback", device):
        masks = kernels.unpack_masks(bits, [pe.batch.capacity
                                            for pe in pends])
    with kernels.phase("host_gid_build", device):
        base = 0
        for pe, mask in zip(pends, masks):
            pe.fulfill_mask(mask, outs, base)
            base += pe.batch.capacity


def finish_states_batch(payloads) -> None:
    """The statement finisher: every pending payload of one statement gets
    its survivor mask from one K5 launch and its states from one K6
    launch. A states working set over the HBM ledger's headroom runs in
    group-radix passes instead (ops.extsort.region_states_spill, the
    reference's spill rung, tidb_tpu/copr/columnar_region.py:1400-1450;
    where the reference lowers argument planes to its host evaluator
    first, the port cuts them by row on the card). Else, with the process
    mesh on the statement's device
    (ops.mesh.get_mesh) and no argument planes among the reductions, the
    states are computed on each region's home shard
    (mesh.region_states_sharded, the reference's near-data rung,
    tidb_tpu/copr/columnar_region.py:1403-1425); statements with argument
    planes take the single-device launch, as the reference's do. At one
    shard (the process mesh of a one-card rig) the rung is the batched
    launch itself. A fault on the mesh raises DeviceError, where the
    reference degrades to the single-device launch."""
    pend = [p for p in payloads if p.states_pending()]
    if not pend:
        return
    device = pend[0].device
    fgroup = [p for p in pend if p.filter_pending()]
    if fgroup:
        _finish_filter_batch(fgroup, device)
    pends = [p._pending for p in pend]
    if len({pe.signature() for pe in pends}) > 1:
        raise Unsupported("regions disagree on the aggregate shape")
    mesh = mesh_mod.get_mesh()
    segs = [(pe.gid, pe.reductions, pe.G, pe.batch.n_rows) for pe in pends]
    if not pends[0].reductions:
        outs = [[] for _ in pends]
    elif extsort.states_over_headroom(segs):
        # spilling trumps shard placement: over the HBM headroom the
        # states run in group-radix passes, argument planes included
        outs = extsort.region_states_spill(segs, device)
    elif mesh_mod.on_device(mesh, device) and not any(
            getattr(v, "is_arg_plane", False)
            for op, v, _ok in pends[0].reductions):
        outs = mesh_mod.region_states_sharded(
            mesh, segs, region_ids=[p.region_id for p in pend],
            epochs=[p.region_epoch for p in pend])
    else:
        outs = kernels.region_agg_states_batched(segs, device)
    with kernels.phase("host_states", device):
        for p, pe, o in zip(pend, pends, outs):
            p.fulfill_states(pe.finish(o))
