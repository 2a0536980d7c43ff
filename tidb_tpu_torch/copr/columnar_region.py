"""A region's columnar answer to a pushed-down aggregate (the port of the
aggregate branch of tidb_tpu/copr/columnar_region.py).

Each region of the cluster store answers its share of a `columnar_hint`
aggregate request itself: its clipped ranges pack into a ColumnBatch (or
hit the region's plane cache, planes pinned on the device), the WHERE and
every aggregate-argument expression compile into one register program,
and the response ships a ColumnarAggStates payload with the filter and
the states still PENDING. The statement finisher (`finish_states_batch`,
called by distsql once every region answered) then runs

  K5  every region's program in one launch (survivor bits + argument
      planes), the bits read back;
  host  group discovery in first-appearance order per region (np.unique
      over the survivors' tuple codes), codec-encoded group keys, the
      contributing-row masks of every reduction;
  K6  every region's segment states in one launch;
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

from tidb_tpu_torch import errors, mysqldef as my
from tidb_tpu_torch.codec import codec
from tidb_tpu_torch.copr.proto import (AGG_NAME, ExprType, SelectRequest,
                                       SelectResponse, arg_plane_shape_ok)
from tidb_tpu_torch.ops import columnar as col, exprc, kernels
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
                         cache=None, version: int = 0,
                         device=None) -> SelectResponse:
    """One region's share of a columnar_hint aggregate request as a
    pending ColumnarAggStates payload. `region` is (region_id, epoch);
    with a `cache` the packed batch is served from / admitted to the
    region's plane cache at data version `version`. `device` None means
    the card (DeviceError without CUDA); only "cpu" selects the plain
    versions. Raises Unsupported for every shape the port does not
    answer."""
    device = resolve_device(device)
    if sel.table_info is None:
        raise Unsupported("index requests over regions come in a later "
                          "slice")
    if not sel.is_agg():
        raise Unsupported("plain region scans come in a later slice")
    agg_specs = _states_specs(sel)
    if agg_specs is None:
        raise Unsupported("aggregate shape outside the states channel")
    columns = sel.table_info.columns
    defaults = {c.column_id: c.default_val for c in columns
                if c.default_val is not None}
    batch = key = None
    if cache is not None and region is not None:
        key = cache_key(region[0], sel, ranges)
        batch = cache.lookup(key, region[1], version)
    try:
        if batch is None:
            batch = col.pack_ranges(snapshot, sel.table_info.table_id,
                                    columns, ranges, defaults)
            if key is not None:
                cache.insert(key, region[1], version, batch)
        return _deferred_filter_response(sel, batch, agg_specs, region,
                                         columns, device)
    except errors.TypeError_ as e:
        # no exact plane mapping: the reference's row handler answers
        raise Unsupported(f"no exact plane mapping: {e}") from e


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
    launch."""
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
    if pends[0].reductions:
        outs = kernels.region_agg_states_batched(
            [(pe.gid, pe.reductions, pe.G, pe.batch.n_rows)
             for pe in pends], device)
    else:
        outs = [[] for _ in pends]
    with kernels.phase("host_states", device):
        for p, pe, o in zip(pend, pends, outs):
            p.fulfill_states(pe.finish(o))
