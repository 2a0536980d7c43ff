"""Carry the reference's state across to the port.

The port imports nothing of `tidb_tpu`; these helpers rebuild the port's
objects from the reference's by reading attributes only (duck typing), so
that a test can hand the requests the JAX package's planner sends, and the
data its store holds, to the port.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import errors
from tidb_tpu_torch.copr import proto
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import Datum, Kind
from tidb_tpu_torch.types.time_types import Duration, Time


def datum_from(d) -> Datum | None:
    if d is None:
        return None
    kind = Kind(int(d.kind))        # raises on kinds the port lacks
    if kind == Kind.TIME:
        t = d.val
        return Datum(kind, Time.from_packed_int(t.to_packed_int(), t.tp,
                                                t.fsp))
    if kind == Kind.DURATION:
        return Datum(kind, Duration(d.val.nanos, d.val.fsp))
    return Datum(kind, d.val)


def expr_from(e) -> proto.Expr | None:
    if e is None:
        return None
    val = e.val
    if val is not None and hasattr(val, "kind") and hasattr(val, "val"):
        val = datum_from(val)
    return proto.Expr(proto.ExprType(int(e.tp)), val=val,
                      op=None if e.op is None else Op(int(e.op)),
                      children=[expr_from(c) for c in e.children],
                      distinct=bool(e.distinct))


def column_info_from(c) -> proto.PBColumnInfo:
    return proto.PBColumnInfo(
        column_id=c.column_id, tp=c.tp, flag=c.flag, flen=c.flen,
        decimal=c.decimal, pk_handle=bool(c.pk_handle),
        elems=list(c.elems), default_val=datum_from(c.default_val))


def request_from(ref_sel) -> proto.SelectRequest:
    """A reference SelectRequest rebuilt as the port's."""
    ti = ref_sel.table_info
    table_info = None if ti is None else proto.PBTableInfo(
        ti.table_id, [column_info_from(c) for c in ti.columns])
    ii = ref_sel.index_info
    # the port serves no index request: keep only that there was one
    index_info = None if ii is None else ("index", ii.table_id, ii.index_id)
    by = [proto.ByItem(expr_from(b.expr), bool(b.desc))
          for b in ref_sel.group_by]
    order = [proto.ByItem(expr_from(b.expr), bool(b.desc))
             for b in ref_sel.order_by]
    return proto.SelectRequest(
        start_ts=ref_sel.start_ts, table_info=table_info,
        index_info=index_info, where=expr_from(ref_sel.where),
        group_by=by, having=expr_from(ref_sel.having), order_by=order,
        limit=ref_sel.limit,
        aggregates=[expr_from(a) for a in ref_sel.aggregates],
        desc=bool(ref_sel.desc), time_zone_offset=ref_sel.time_zone_offset,
        flags=ref_sel.flags, est_rows=ref_sel.est_rows,
        columnar_hint=bool(getattr(ref_sel, "columnar_hint", False)))


def kv_request_from(ref_req) -> kv.Request:
    """A reference kv.Request (carrying a SelectRequest) as the port's."""
    return kv.Request(
        tp=ref_req.tp, data=request_from(ref_req.data),
        key_ranges=[kv.KeyRange(bytes(r.start), bytes(r.end))
                    for r in ref_req.key_ranges],
        keep_order=bool(ref_req.keep_order), desc=bool(ref_req.desc),
        concurrency=ref_req.concurrency)


def batch_from_planes(n_rows: int, capacity: int, handles,
                      columns: dict) -> col.ColumnBatch:
    """A ColumnBatch from numpy planes. `columns` maps each cid to a dict
    with "values", "valid", "kind" and, where they apply, "dictionary",
    "tp", "dec_scale" and "max_abs"."""
    cols = {}
    for cid, c in columns.items():
        values = np.ascontiguousarray(c["values"])
        valid = np.ascontiguousarray(c["valid"], dtype=bool)
        if values.shape != (capacity,) or valid.shape != (capacity,):
            raise errors.TypeError_(f"column {cid}: planes must be "
                                    f"[{capacity}]")
        want = np.float64 if c["kind"] == col.K_F64 else np.int64
        cols[cid] = col.ColumnData(
            c["kind"], values.astype(want, copy=False), valid,
            dictionary=(list(c["dictionary"]) if c.get("dictionary")
                        is not None else None),
            tp=int(c.get("tp", 0)), dec_scale=int(c.get("dec_scale", 0)),
            max_abs=int(c.get("max_abs", 0)))
    return col.ColumnBatch(int(n_rows), int(capacity),
                           np.asarray(handles, dtype=np.int64), cols)


def batch_from(ref_batch) -> col.ColumnBatch:
    """A reference ColumnBatch's planes as the port's."""
    return batch_from_planes(
        ref_batch.n_rows, ref_batch.capacity, ref_batch.handles,
        {cid: {"values": cd.values, "valid": cd.valid, "kind": cd.kind,
               "dictionary": cd.dictionary, "tp": cd.tp,
               "dec_scale": cd.dec_scale, "max_abs": cd.max_abs}
         for cid, cd in ref_batch.columns.items()})


def cluster_from(ref_store, read_ts: int) -> tuple[list, list]:
    """(KV pairs, split keys) of a reference cluster store as seen at
    `read_ts`: every pair its snapshot at that timestamp iterates, and the
    start key of each of its regions but the first — what
    cluster.store.DistStore takes to hold the same data in the same
    regions."""
    pairs = [(bytes(k), bytes(v)) for k, v in
             ref_store.get_snapshot(read_ts).iterate(b"", None)]
    splits = [bytes(r.start) for r in ref_store.cluster.regions[1:]]
    return pairs, splits
