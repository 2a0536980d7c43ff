"""Aggregates fused over columnar inputs (the port of
tidb_tpu/executor/fused_agg.py:226 try_fused_agg, :241 _try_fused, :327
_group_codes, :361 _arg_plane, :379 _fused_func, _has_neg_zero, :859
_sum_avg_datums, :875 _minmax_datums; and, for the cluster path, :63
_RegionCombine, :175 _region_combine_for, :499-580 _StatesCombine,
:630-830 _try_final_states and :833 _merge_datum_states).

COMPLETE mode: `try_fused_agg(agg)` answers a HashAgg over a join's
DeviceJoinResult or a scan's ColumnarScanResult straight from the
gathered planes, row for row what the reference's row loop returns:
groups in first-appearance order (NULL keys one group), int SUM/AVG exact
(int64 with an overflow pre-guard, then Decimal), float SUM/AVG by
np.add.at, an unbuffered scatter-add in row order, so the rounding
sequence is the row loop's. Where the reference gives the fusion back to
its row loop (None: DISTINCT, decimal, time or unsigned arguments, string
MIN/MAX, -0.0 in a float plane, a sum that could wrap) the port raises
Unsupported: it has no row loop. Over one region the reductions stay on
the host, in the reference's order. Over several (a ColumnarPartialSet,
or a join whose left side is one) the order-free aggregates (counts,
int SUM/AVG, int and f64 MIN/MAX) register per-region partial states that
one region combine merges (_RegionCombine: row 15f on the process mesh,
one K6 span on one device); first_row keeps the group's first position,
which the group codes already give, and float SUM/AVG keep the host
accumulator, whose row order per-region partial sums would change.

FINAL mode:
`final_states(sel, result)` turns the per-region ColumnarAggStates of one
statement into the final aggregate rows: the regions' group keys unify in
TASK order (the row protocol's partial arrival order, so the global
first-appearance order is the row loop's emission order), every numeric
state scatters into an [R, G] stack, and all stacks merge over the region
axis in one K7 launch (R = 1 on the host, as in the reference), on the
process mesh when one lies on the statement's device (the regions on
their home shards, ops.mesh.combine_states_sharded). Float
SUM/AVG merge on the host in task order and datum-mode states (string
min/max, first_row) merge on the host; decimal sums requantize to the
exponent the row protocol's sum would carry.

Where the reference returns None (a state outside the exact subset, a
combined int sum that could wrap) the row loop answers; the port raises
Unsupported.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np

from tidb_tpu_torch import mysqldef as my
from tidb_tpu_torch.copr.proto import AGG_NAME, SelectRequest
from tidb_tpu_torch.ops import columnar as col, kernels
from tidb_tpu_torch.ops import mesh as mesh_mod
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.types.convert import (compare_datum, unflatten_datum,
                                          unflatten_identity_kinds)
from tidb_tpu_torch.types.datum import NULL, Datum

I64_SENTINEL_MIN = (1 << 63) - 1   # "min" monoid identity (int planes)
I64_SENTINEL_MAX = -(1 << 63)      # "max" monoid identity

# "fused" counts COMPLETE-mode aggregates answered from planes;
# "mesh_combines" the combines that rode the mesh, "last_mesh_shards" its
# shard count
stats = {"final_states": 0, "partial_combines": 0,
         "last_combine_regions": 0, "last_groups": 0, "fused": 0,
         "mesh_combines": 0, "last_mesh_shards": 0}


class _StatesCombine:
    """[R, G] state stacks merged over the region axis in one K7 launch
    and one readback for all of them: on the process mesh when it lies on
    the statement's device (ops.mesh.combine_states_sharded, the regions
    placed on their home shards by their ids and epochs; at one shard
    that is the single-device combine), else by the single-device
    combine; R <= 1 on the host. A fault on the mesh raises, where the
    reference degrades to the single-device combine."""

    def __init__(self, R: int, G: int, device, region_ids=None,
                 epochs=None):
        self.R, self.G = R, G
        self.device = device
        self.region_ids, self.epochs = region_ids, epochs
        self._states: list = []
        self._ops: list = []
        self._results: list | None = None
        self.rode_mesh = False

    def add(self, op: str, state: np.ndarray) -> int:
        self._states.append(state)
        self._ops.append(op)
        return len(self._states) - 1

    def _host(self) -> list:
        reduce_ = {"sum": np.sum, "min": np.min, "max": np.max}
        return [np.atleast_1d(reduce_[op](s, axis=0))
                for s, op in zip(self._states, self._ops)]

    def run(self) -> None:
        if not self._states:
            return
        if self.R <= 1:
            self._results = self._host()
            return
        mesh = mesh_mod.get_mesh()
        if mesh_mod.on_device(mesh, self.device):
            shard_of = None
            if self.region_ids is not None \
                    and len(self.region_ids) == self.R:
                shard_of = mesh_mod.placement_for(mesh).shard_of(
                    mesh_mod.placement_keys(self.region_ids, self.R),
                    self.epochs)
            self._results = mesh_mod.combine_states_sharded(
                self._states, self._ops, mesh, shard_of=shard_of)
            self.rode_mesh = True
            stats["mesh_combines"] += 1
            stats["last_mesh_shards"] = mesh.n
        else:
            self._results = kernels.combine_region_partials(
                self._states, self._ops, self.device)
        stats["partial_combines"] += 1
        stats["last_combine_regions"] = self.R

    def get(self, idx: int):
        return self._results[idx]


class _RegionCombine:
    """The per-region partial states of one COMPLETE-mode fusion over a
    multi-region join or scan (the port of the reference's :63
    _RegionCombine), gathered as (op, values, contrib) row specs and
    merged in one go: on the process mesh when it lies on the
    statement's device (ops.mesh.combine_rows_sharded, row 15f: each
    region's rows on its home shard, K6 over the shard layout, K7's shard
    fold), else on one device (kernels.rows_states: one K6 span over every
    region's rows, where the reference builds [R, G] stacks on the host
    and folds them with K7). Group ids are global (unified over the
    stacked rows first), so one span over all the rows gives the
    regions' folded states. A fault on either rung raises DeviceError,
    where the reference degrades to the next rung."""

    def __init__(self, slices: list, gid, G: int, device, region_ids=None,
                 epochs=None):
        self.slices = slices
        self.gid = gid
        self.G = G
        self.device = device
        self.region_ids = region_ids
        self.epochs = epochs
        self._specs: list = []
        self._results: list | None = None
        self.rode_mesh = False

    def add(self, op: str, vals, ok) -> int:
        """Register one partial state: op "sum" / "min" / "max", `vals` a
        host int64 / f64 row plane (None: a count), `ok` the contribution
        mask. Returns the index of its result."""
        self._specs.append((op, vals, ok))
        return len(self._specs) - 1

    def run(self) -> None:
        if not self._specs:
            return
        mesh = mesh_mod.get_mesh()
        if mesh_mod.on_device(mesh, self.device):
            self._results = mesh_mod.combine_rows_sharded(
                mesh, self._specs, self.gid, self.G, self.slices,
                self.region_ids, self.epochs)
            self.rode_mesh = True
            stats["mesh_combines"] += 1
            stats["last_mesh_shards"] = mesh.n
        else:
            self._results = kernels.rows_states(
                self._specs, self.gid, self.G, self.device)
        stats["partial_combines"] += 1
        stats["last_combine_regions"] = len(self.slices)

    def get(self, idx: int):
        return self._results[idx]


def _region_combine_for(res, gid, G: int, device):
    """A combine for a result over more than one region (a
    ColumnarPartialSet, or a join whose left side is one), else None: the
    flat path answers, with the same values (the combined aggregates are
    exact and order-free). The regions' ids and epochs go along for the
    mesh's placement."""
    get = getattr(res, "region_slices", None)
    slices = get() if get is not None else None
    if not slices or len(slices) <= 1:
        return None
    return _RegionCombine(slices, gid, G, device, res.region_ids(),
                          res.region_epochs())


def _parts_of(result) -> list:
    if isinstance(result, col.ColumnarStatesSet):
        return result.parts
    if isinstance(result, col.ColumnarAggStates):
        return [result]
    raise Unsupported("final aggregate over a non-states payload")


def _empty_result(name: str) -> Datum:
    """An aggregate's result over no row: count 0, everything else
    NULL."""
    return Datum.i64(0) if name == "count" else NULL


def final_states(sel: SelectRequest, result) -> list:
    """The final aggregate rows (one list of Datums per group, in the
    order the reference's fused_agg._try_final_states returns them) of the
    pushed-down aggregate `sel` over `result`, the payload
    distsql.SelectResult.columnar returned."""
    if result is None:
        parts = []
    else:
        parts = _parts_of(result)
    if any(p.states_pending() for p in parts):
        raise Unsupported("states still pending: run the statement "
                          "through distsql.select(...).columnar()")
    names = [AGG_NAME[e.tp] for e in sel.aggregates]
    for p in parts:
        if len(p.aggs) != len(names):
            raise Unsupported("payload and request disagree on the "
                              "aggregates")
        for st, name in zip(p.aggs, names):
            if st.name != name:
                raise Unsupported("payload and request disagree on the "
                                  "aggregates")
    # unify the group space across regions in TASK order
    key_order: list[bytes] = []
    key_idx: dict = {}
    maps: list[np.ndarray] = []
    for p in parts:
        m = []
        for gk in p.group_keys:
            gi = key_idx.get(gk)
            if gi is None:
                gi = key_idx[gk] = len(key_order)
                key_order.append(gk)
            m.append(gi)
        maps.append(np.asarray(m, dtype=np.int64))
    G = len(key_order)
    R = len(parts)
    stats["last_groups"] = G
    if G == 0:
        if sel.group_by:
            return []   # GROUP BY over empty input emits no rows
        return [[_empty_result(name) for name in names]]
    device = parts[0].device
    with kernels.phase("final_merge", device):
        combine = _StatesCombine(
            R, G, device, [getattr(p, "region_id", None) for p in parts],
            [getattr(p, "region_epoch", None) for p in parts])
        col_specs = _stack_states(parts, names, maps, R, G, combine)
    combine.run()
    with kernels.phase("final_merge", device):
        rows = _final_rows(col_specs, maps, G, combine)
    stats["final_states"] += 1
    return rows


def _stack_states(parts, names, maps, R: int, G: int, combine) -> list:
    col_specs: list[dict] = []
    for i, name in enumerate(names):
        sts = [p.aggs[i] for p in parts]
        cnt_state = np.zeros((R, G), np.int64)
        for r, m in enumerate(maps):
            cnt_state[r, m] = sts[r].counts
        entry: dict = {"name": name, "sts": sts,
                       "ci": combine.add("sum", cnt_state),
                       "ft": parts[0].value_ft(i)}
        col_specs.append(entry)
        if name == "count":
            continue
        if any(st.datums is not None for st in sts):
            if not all(st.datums is not None for st in sts):
                raise Unsupported("regions disagree on a state's mode")
            entry["mode"] = "datum"
            continue
        kinds = {st.kind for st in sts}
        scales = {st.dec_scale for st in sts}
        if len(kinds) != 1 or len(scales) != 1 or None in kinds:
            raise Unsupported("regions disagree on a state's kind")
        kind = kinds.pop()
        entry["kind"], entry["scale"] = kind, scales.pop()
        if kind == "f64" and name in ("sum", "avg"):
            entry["mode"] = "fsum"   # ordered host float accumulation
            continue
        if kind != "f64" and name in ("sum", "avg"):
            # the combined int sum could wrap where per-region sums did
            # not: the reference's row loop answers such a statement
            mx = 0
            for st in sts:
                if len(st.values):
                    mx = max(mx, abs(int(st.values.min())),
                             abs(int(st.values.max())))
            if mx and mx * R >= (1 << 63):
                raise Unsupported("combined integer sum could wrap")
        if name in ("sum", "avg"):
            op, init = "sum", 0
        elif name == "min":
            op = "min"
            init = np.inf if kind == "f64" else I64_SENTINEL_MIN
        else:
            op = "max"
            init = -np.inf if kind == "f64" else I64_SENTINEL_MAX
        dtype = np.float64 if kind == "f64" else np.int64
        vstate = np.full((R, G), init, dtype)
        for r, m in enumerate(maps):
            vstate[r, m] = sts[r].values
        entry["mode"] = "num"
        entry["vi"] = combine.add(op, vstate)
    return col_specs


def _unflat(d: Datum, ft) -> Datum:
    return d if d.kind in unflatten_identity_kinds(ft) \
        else unflatten_datum(d, ft)


def _final_rows(col_specs, maps, G: int, combine) -> list:
    out_cols: list[list] = []
    for entry in col_specs:
        name = entry["name"]
        cnts = combine.get(entry["ci"])
        ft = entry["ft"]
        if name == "count":
            out_cols.append([Datum.i64(int(c)) for c in cnts])
            continue
        if entry.get("mode") == "datum":
            vals = _merge_datum_states(name, entry["sts"], maps, G)
            out_cols.append([_unflat(v, ft) for v in vals])
            continue
        kind, scale = entry["kind"], entry["scale"]
        if entry.get("mode") == "fsum":
            # float partial sums merge on the host in task order
            acc: list = [None] * G
            for st, m in zip(entry["sts"], maps):
                for j, g in enumerate(m.tolist()):
                    if int(st.counts[j]) == 0:
                        continue
                    x = float(st.values[j])
                    acc[g] = x if acc[g] is None else acc[g] + x
            col_out = []
            for g in range(G):
                c = int(cnts[g])
                if c == 0 or acc[g] is None:
                    col_out.append(NULL)
                elif name == "sum":
                    col_out.append(Datum.f64(acc[g]))
                else:
                    col_out.append(Datum.f64(acc[g] / c))
            out_cols.append(col_out)
            continue
        vs = combine.get(entry["vi"])
        exp_g: list = [None] * G
        if kind == "dec" and name in ("sum", "avg"):
            # the row protocol sums codec-trimmed addends, so its sum's
            # exponent is the least over them (folded with the declared
            # scale's lossless restore): requantizing the combined total
            # to it is exact and string-identical
            sdecl = ft.decimal if (ft is not None and ft.is_decimal()
                                   and ft.decimal >= 0) else None
            for st, m in zip(entry["sts"], maps):
                for j, g2 in enumerate(m.tolist()):
                    if int(st.counts[j]) == 0:
                        continue
                    e = col.dec_canonical(
                        Decimal(int(st.values[j]))
                        .scaleb(-st.dec_scale)).as_tuple().exponent
                    if sdecl is not None:
                        e = min(e, -sdecl)
                    if exp_g[g2] is None or e < exp_g[g2]:
                        exp_g[g2] = e
        col_out = []
        for g in range(G):
            c = int(cnts[g])
            if c == 0:
                col_out.append(NULL)
                continue
            if name in ("sum", "avg"):
                if kind == "dec":
                    s = Decimal(int(vs[g])).scaleb(-scale)
                    if exp_g[g] is not None:
                        s = s.quantize(Decimal((0, (1,), exp_g[g])))
                else:
                    s = Decimal(int(vs[g]))
                col_out.append(Datum.dec(s) if name == "sum"
                               else Datum.dec(s / Decimal(c)))
                continue
            if kind == "f64":
                d = Datum.f64(float(vs[g]))
            elif kind == "dec":
                d = Datum.dec(Decimal(int(vs[g])).scaleb(-scale))
            else:
                pb = entry["sts"][0].pb_col
                d = Datum.u64(int(vs[g])) if pb is not None and \
                    my.has_unsigned_flag(pb.flag) else Datum.i64(int(vs[g]))
            col_out.append(_unflat(d, ft))
        out_cols.append(col_out)
    return [[c[g] for c in out_cols] for g in range(G)]


def _merge_datum_states(name: str, sts, maps, G: int) -> list:
    """Host FINAL merge of datum-mode states in task order: first_row
    keeps the FIRST partial seen (even NULL), min/max skip NULLs and keep
    the first-seen value on ties."""
    vals: list = [None] * G
    for st, m in zip(sts, maps):
        for j, g in enumerate(m.tolist()):
            d = st.datums[j]
            if name == "first_row":
                if vals[g] is None:
                    vals[g] = d
                continue
            if d.is_null():
                continue
            cur = vals[g]
            if cur is None or cur.is_null():
                vals[g] = d
                continue
            c = compare_datum(d, cur)
            if (c > 0) == (name == "max") and c != 0:
                vals[g] = d
    return [NULL if v is None else v for v in vals]


# ---------------------------------------------------------------------------
# COMPLETE mode over a single-batch join or scan result
# ---------------------------------------------------------------------------

_FUSABLE = ("count", "sum", "avg", "min", "max", "first_row")

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


def _has_neg_zero(vals, mask) -> bool:
    """-0.0 changes fused SUM/MIN/MAX output identity (the row loop keeps
    the first-seen zero sign, numpy reductions normalize it)."""
    z = (vals == 0.0) & np.signbit(vals) & mask
    return bool(np.any(z))


def try_fused_agg(agg) -> list:
    """The result rows of a COMPLETE-mode HashAgg (`agg_funcs`,
    `group_by`, `children`) over a join (device_join_result) or a scan
    (columnar_result); raises Unsupported outside the fusable subset."""
    out = _try_fused(agg)
    stats["fused"] += 1
    return out


def _try_fused(agg) -> list:
    from tidb_tpu_torch.plan import AggFunctionMode, Column, Constant

    for f in agg.agg_funcs:
        if f.mode != AggFunctionMode.COMPLETE or f.distinct:
            raise Unsupported("a DISTINCT or FINAL-mode aggregate over a "
                              "join needs the row loop")
        if f.name not in _FUSABLE or len(f.args) > 1:
            raise Unsupported(f"aggregate {f.name} needs the row loop")
        for a in f.args:
            if not isinstance(a, (Column, Constant)):
                raise Unsupported("an aggregate over an expression needs "
                                  "the row loop")
    for g in agg.group_by:
        if not isinstance(g, Column) or (
                g.ret_type is not None and g.ret_type.is_ci_collation()):
            raise Unsupported("a group key over an expression or a ci "
                              "collation needs the row loop")
    child = agg.children[0]
    if hasattr(child, "device_join_result"):
        res = child.device_join_result()
    else:
        res = child.columnar_result()
    if res is None:
        raise Unsupported("the aggregate's child answered rows")
    n = len(res)
    # a join's device, or a scan's client's
    device = getattr(child, "device", None) or child.client.device

    with kernels.phase("group_codes", device):
        if agg.group_by:
            codes = []
            for g in agg.group_by:
                c = _group_codes(res, g.index)
                if c is None:
                    raise Unsupported("a group key with no plane")
                codes.append(c)
            if len(codes) == 1:
                _u, first_idx, gid = np.unique(
                    codes[0], return_index=True, return_inverse=True)
                G = len(_u)
            else:
                mat = np.stack(codes, axis=1)
                _u, first_idx, gid = np.unique(
                    mat, axis=0, return_index=True, return_inverse=True)
                G = _u.shape[0]
            gid = np.reshape(gid, -1)
            if G == 0:
                return []   # GROUP BY over empty input emits no rows
        else:
            if n == 0:
                # aggregates over an empty input still yield one row
                return [[f.empty for f in agg.agg_funcs]]
            gid = np.zeros(n, dtype=np.int64)
            first_idx = np.zeros(1, dtype=np.int64)
            G = 1
    combine = _region_combine_for(res, gid, G, device)
    with kernels.phase("reductions", device):
        cols = [_fused_func(res, f, gid, G, first_idx, n, combine)
                for f in agg.agg_funcs]
    if combine is not None:
        with kernels.phase("region_combine", device):
            combine.run()
            cols = [c() if callable(c) else c for c in cols]
    with kernels.phase("emit", device):
        emit = np.argsort(first_idx, kind="stable")
        return [[c[g] for c in cols] for g in emit.tolist()]


def _group_codes(res, j: int):
    """Dense group codes for output column j; NULL → -1 (one group). None
    when the plane can't represent the column with codec-key-equal
    grouping."""
    get_codes = getattr(res, "dict_code_plane", None)
    if get_codes is not None:
        ent = get_codes(j)
        if ent is not None:
            # string group keys ride their dictionary codes (injective over
            # bytes, NULL = -1): no bytes materialize
            codes, valid, _dom = ent
            return np.where(valid, codes, -1).astype(np.int64)
    kind, vals, valid = res.column_plane(j)
    if kind is None:
        return None
    if kind == "str":
        uniq = sorted(set(vals[valid].tolist()))
        m = {b: i for i, b in enumerate(uniq)}
        return np.fromiter(
            (m[v] if ok else -1
             for v, ok in zip(vals.tolist(), valid.tolist())),
            dtype=np.int64, count=len(vals))
    if kind == "f64":
        # -0.0 groups WITH 0.0 (the codec key normalizes it)
        vals = np.where(vals == 0.0, 0.0, vals)
    uniq = np.unique(vals[valid])
    codes = np.searchsorted(uniq, vals).astype(np.int64)
    codes[~valid] = -1
    return codes


def _arg_plane(res, f, n: int):
    """(kind, values, valid) plane of an aggregate argument: a gathered
    column or a broadcast constant; None when unsupported."""
    from tidb_tpu_torch.plan import Constant
    from tidb_tpu_torch.types.datum import Kind

    arg = f.args[0] if f.args else None
    if arg is None or isinstance(arg, Constant):
        const = arg.value if arg is not None else Datum.i64(1)
        if const.is_null():
            return "i64", np.zeros(n, np.int64), np.zeros(n, bool)
        if const.kind == Kind.INT64:
            return ("i64", np.full(n, int(const.val), np.int64),
                    np.ones(n, bool))
        if const.kind == Kind.FLOAT64:
            return ("f64", np.full(n, float(const.val), np.float64),
                    np.ones(n, bool))
        return None
    return res.column_plane(arg.index)


def _fused_func(res, f, gid, G: int, first_idx, n: int,
                combine: _RegionCombine | None = None):
    """Per-group result datums (unique-order indexing) of one aggregate.
    With a region `combine` the order-free aggregates register per-region
    partial states and return a thunk that reads the combined states
    after combine.run(); float SUM/AVG stay on the flat host accumulator,
    whose row order a per-region partial sum would change."""
    from tidb_tpu_torch.plan import Column, Constant

    name = f.name
    if name == "first_row":
        arg = f.args[0] if f.args else None
        if isinstance(arg, Constant):
            return [arg.value] * G
        if not isinstance(arg, Column):
            raise Unsupported("first_row over an expression")
        # the group codes' first positions over the stacked rows, with or
        # without a region combine
        return res.gather_datums(arg.index, first_idx)

    plane = _arg_plane(res, f, n)
    if plane is None or plane[0] is None:
        raise Unsupported(f"{name} over an argument with no plane "
                          f"(decimal, time, unsigned) needs the row loop")
    kind, vals, valid = plane
    if name == "count":
        if combine is not None:
            ci = combine.add("sum", None, valid)
            return lambda: [Datum.i64(int(c)) for c in combine.get(ci)]
        return [Datum.i64(int(c)) for c in np.bincount(gid[valid],
                                                       minlength=G)]
    if kind == "str":
        raise Unsupported(f"string {name} needs collation-aware compares")
    ok = valid

    if name in ("sum", "avg"):
        if kind == "i64":
            vk = vals[ok]
            if len(vk):
                mx = max(abs(int(vk.min())), abs(int(vk.max())))
                if mx and mx * len(vk) >= (1 << 63):
                    raise Unsupported("an int sum that could wrap needs "
                                      "the row loop's Decimal sum")
            if combine is not None:
                # the bound covers every region's partial sum too
                ci = combine.add("sum", None, ok)
                si = combine.add("sum", vals, ok)
                return lambda: _sum_avg_datums(
                    name, "i64", combine.get(ci), combine.get(si), G)
            cnt = np.bincount(gid[ok], minlength=G)
            sums = np.zeros(G, np.int64)
            np.add.at(sums, gid[ok], vk)
        else:
            # float sums accumulate in ROW order (np.add.at, unbuffered)
            if _has_neg_zero(vals, ok):
                raise Unsupported("-0.0 in a float sum needs the row loop")
            cnt = np.bincount(gid[ok], minlength=G)
            sums = np.zeros(G, np.float64)
            np.add.at(sums, gid[ok], vals[ok])
        return _sum_avg_datums(name, kind, cnt, sums, G)

    if name in ("min", "max"):
        is_min = name == "min"
        if kind == "i64":
            init = I64_MAX if is_min else I64_MIN
            dtype = np.int64
        else:
            if _has_neg_zero(vals, ok):
                raise Unsupported("-0.0 in a float extremum needs the row "
                                  "loop")
            init = np.inf if is_min else -np.inf
            dtype = np.float64
        if combine is not None:
            ci = combine.add("sum", None, ok)
            vi = combine.add(name, vals, ok)
            return lambda: _minmax_datums(kind, combine.get(ci),
                                          combine.get(vi), G)
        reduce_at = np.minimum.at if is_min else np.maximum.at
        cnt = np.bincount(gid[ok], minlength=G)
        red = np.full(G, init, dtype)
        reduce_at(red, gid[ok], vals[ok])
        return _minmax_datums(kind, cnt, red, G)
    raise Unsupported(f"aggregate {name} needs the row loop")


def _sum_avg_datums(name: str, kind: str, cnt, sums, G: int) -> list:
    out = []
    for g in range(G):
        c = int(cnt[g])
        if c == 0:
            out.append(NULL)
        elif name == "sum":
            out.append(Datum.f64(float(sums[g])) if kind == "f64"
                       else Datum.dec(Decimal(int(sums[g]))))
        else:
            out.append(Datum.f64(float(sums[g]) / c) if kind == "f64"
                       else Datum.dec(Decimal(int(sums[g]))
                                      / Decimal(c)))
    return out


def _minmax_datums(kind: str, cnt, red, G: int) -> list:
    return [NULL if int(cnt[g]) == 0
            else (Datum.f64(float(red[g])) if kind == "f64"
                  else Datum.i64(int(red[g])))
            for g in range(G)]
