"""FINAL aggregation over grouped partial STATES (the port of
tidb_tpu/executor/fused_agg.py:499-580 _StatesCombine, :630-830
_try_final_states and :833 _merge_datum_states).

`final_states(sel, result)` turns the per-region ColumnarAggStates of one
statement into the final aggregate rows: the regions' group keys unify in
TASK order (the row protocol's partial arrival order, so the global
first-appearance order is the row loop's emission order), every numeric
state scatters into an [R, G] stack, and all stacks merge over the region
axis in one K7 launch (R = 1 on the host, as in the reference). Float
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
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.types.convert import (compare_datum, unflatten_datum,
                                          unflatten_identity_kinds)
from tidb_tpu_torch.types.datum import NULL, Datum

I64_SENTINEL_MIN = (1 << 63) - 1   # "min" monoid identity (int planes)
I64_SENTINEL_MAX = -(1 << 63)      # "max" monoid identity

stats = {"final_states": 0, "partial_combines": 0,
         "last_combine_regions": 0, "last_groups": 0}


class _StatesCombine:
    """[R, G] state stacks merged over the region axis: one K7 launch and
    one readback for all of them; R <= 1 on the host."""

    def __init__(self, R: int, G: int, device):
        self.R, self.G = R, G
        self.device = device
        self._states: list = []
        self._ops: list = []
        self._results: list | None = None

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
        self._results = kernels.combine_region_partials(
            self._states, self._ops, self.device)
        stats["partial_combines"] += 1
        stats["last_combine_regions"] = self.R

    def get(self, idx: int):
        return self._results[idx]


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
        combine = _StatesCombine(R, G, device)
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
