"""The join, aggregate and ordering executors over columnar children (the
port of tidb_tpu/executor/executors.py:688 HashJoinExec's vector route,
:529 HashAggExec's fused route, and the plane paths of :261 SortExec and
:331 TopNExec).

HashJoinExec sends every equi-join to the device, as the reference's does
at or above its dispatch floor: a single int64/f64 key straight to K11
(join_build) + K12 (join_probe), gathered from the scans' resident planes;
string and multi-column keys through the dictionary tier
(copr.dictionary) and K13 (dict_remap), then K11 + K12. The pairs come
back in left-scan order, ties in right-scan order — the row engine's
emission order — and stay columnar (ops.columnar.DeviceJoinResult). The
join goes through the budget-aware router (ops.membudget.join_match_pairs,
the reference's executors.py:1150-1175): within the HBM ledger's headroom
one K11 + K12, with the left scan's client on a mesh of more than one
shard the probe sharded (the same pairs; the per-shard pair totals go to
ops.mesh.stats as the shard balance); over the headroom the key-partitioned
mesh probe (K21 + K11 + the segmented K12) or grace-hash passes on one
device. An aggregate above reads the gathered planes (executor.fused_agg),
anything else pulls materialized rows.

There is no row engine in the port and no floor: every join on the card
runs the kernels, and with device="cpu" their plain PyTorch versions
(the reference's _numpy_pairs arithmetic). Shapes the reference hands to
its row engine raise Unsupported: join types other than INNER and LEFT
OUTER, conditions beyond the equi-keys, ci collations, keys outside the
dictionary tier. A kernel that fails raises; nothing falls back.

SortExec and TopNExec order a join's or a scan's columnar result by its
planes: key planes in np.lexsort's convention (_plane_sort_keys), the
budget-aware external sort (ops.extsort.sort_order: K17 in one pass or
in partitioned passes) and one gather of the rows in sorted order. A
child that offers no planes, or a key without an order-exact plane,
raises Unsupported: the port has no row comparator loop.
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch import mysqldef as my
from tidb_tpu_torch.copr import dictionary
from tidb_tpu_torch.executor import fused_agg
from tidb_tpu_torch.executor.distsql_exec import Executor
from tidb_tpu_torch.ops import columnar as col, extsort, kernels, membudget
from tidb_tpu_torch.ops import mesh as mesh_mod
from tidb_tpu_torch.ops.client import resolve_device
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.plan import Column, Join


def _is_str(c: Column) -> bool:
    return c.ret_type is not None and c.ret_type.tp in my.STRING_TYPES


def _is_ci(c: Column) -> bool:
    return c.ret_type is not None and c.ret_type.is_ci_collation()


class HashJoinExec(Executor):
    """Equi-join of two children (left, right) under a plan.Join. The
    device is the caller's, else the left child's client's, else the
    card (which raises DeviceError where there is no CUDA)."""

    def __init__(self, child_left: Executor, child_right: Executor,
                 plan: Join, device=None):
        self.children = [child_left, child_right]
        self.plan = plan
        self.schema = list(child_left.schema) + list(child_right.schema)
        client = getattr(child_left, "client", None)
        if device is None:
            device = getattr(client, "device", None)
        self.device = resolve_device(device)
        self.mesh = self._join_mesh(client)
        self.join_stats: dict = {}   # path and per-phase timings
        self._right_width = len(child_right.schema)
        self._vector_tried = False
        self._device = None          # the DeviceJoinResult
        self._vector_iter = None

    def _join_mesh(self, client):
        """The mesh of the join: the left scan's client's (GpuClient's own
        mesh, DistCoprClient's process mesh) where it lies on the join's
        device, else None."""
        mesh = getattr(client, "mesh", None)
        return mesh if mesh_mod.on_device(mesh, self.device) else None

    # ---- the sides ----

    @staticmethod
    def _side(child):
        """A child's answer as a join side: its columnar scan payload, or
        its drained rows."""
        get = getattr(child, "columnar_result", None)
        side = get() if get is not None else None
        return side if side is not None else col.RowsSide(child.drain())

    @staticmethod
    def _side_key(side, c: Column):
        """(values, valid) host planes of one int64/f64 key column."""
        kind, vals, valid = side.column_plane(c.index)
        if kind not in ("i64", "f64"):
            raise Unsupported(f"a join key of plane kind {kind} (decimal, "
                              f"time, unsigned) needs the row engine")
        return vals, valid

    @staticmethod
    def _side_device_keys(lside, rside, lcol: Column, rcol: Column):
        """(lkey, lvalid, rkey, rvalid) tensors gathered on the device from
        both sides' resident planes, or None when a side has none."""
        gl = getattr(lside, "device_plane", None)
        gr = getattr(rside, "device_plane", None)
        if gl is None or gr is None:
            return None
        dl, dr = gl(lcol.index), gr(rcol.index)
        if dl is None or dr is None or dl[0].dtype != dr[0].dtype:
            return None
        return (dl[0], dl[1], dr[0], dr[1])

    # ---- the routes ----

    def _try_vector_join(self) -> None:
        plan = self.plan
        if not plan.eq_conditions:
            raise Unsupported("a join without equality conditions needs "
                              "the row engine")
        if plan.join_type not in (Join.INNER, Join.LEFT_OUTER):
            raise Unsupported(f"join type {plan.join_type} needs the row "
                              f"engine")
        if plan.left_conditions or plan.right_conditions or \
                plan.other_conditions:
            raise Unsupported("join conditions beyond the equi-keys need "
                              "the row expression evaluator")
        for pair in plan.eq_conditions:
            if not all(isinstance(c, Column) for c in pair):
                raise Unsupported("an equality condition over an "
                                  "expression needs the row engine")
        if any(_is_ci(c) for pair in plan.eq_conditions for c in pair):
            raise Unsupported("a ci-collation join key needs the row "
                              "engine's casefolded codec keys")
        if len(plan.eq_conditions) > 1 or \
                any(_is_str(c) for pair in plan.eq_conditions for c in pair):
            self._try_dict_join()
            return
        lcol, rcol = plan.eq_conditions[0]
        rside = self._side(self.children[1])
        lside = self._side(self.children[0])
        with kernels.phase("side_planes", self.device):
            rkey, rvalid = self._side_key(rside, rcol)
            lkey, lvalid = self._side_key(lside, lcol)
            device_keys = None
            if rkey.dtype != lkey.dtype:
                # an int side against a float side never matches under the
                # row engine's codec keys: match nothing / outer-pad
                lvalid = np.zeros_like(lvalid)
                lkey = lkey.astype(rkey.dtype)
            else:
                device_keys = self._side_device_keys(lside, rside, lcol,
                                                     rcol)
        self._start_device(lside, rside, lkey, lvalid, rkey, rvalid,
                           device_keys)

    def _try_dict_join(self) -> None:
        """String / multi-column equi-join: each key pair into one shared
        domain (copr.dictionary), the composite key-tuple codes built on
        the device by K13, one launch per side, then K11 + K12."""
        plan = self.plan
        rside = self._side(self.children[1])
        lside = self._side(self.children[0])
        pairs = [(lc.index, rc.index, _is_str(lc) or _is_str(rc))
                 for lc, rc in plan.eq_conditions]
        with kernels.phase("side_planes", self.device):
            try:
                specs = dictionary.build_join_specs(
                    lside, rside, pairs, dictionary.DEFAULT_MAX_NDV_RATIO)
            except dictionary.DictBail as e:
                raise Unsupported(f"join keys outside the dictionary "
                                  f"tier: {e}") from None
        stats = self.join_stats
        stats["dict_keys"] = True
        stats["key_cols"] = len(plan.eq_conditions)
        if specs is None:
            # provably matchless (a cross-kind pair or a vacuous side)
            stats["path"] = "matchless"
            empty = np.zeros(0, np.int64)
            with kernels.phase("finish", self.device):
                self._finish_pairs(lside, rside, empty, empty.copy())
            return
        l_specs, r_specs = specs
        with kernels.phase("k13", self.device):
            lk, lv = kernels.dict_remap_keys(l_specs, len(lside), self.device)
            rk, rv = kernels.dict_remap_keys(r_specs, len(rside), self.device)
        self._start_device(lside, rside, None, None, None, None,
                           (lk, lv, rk, rv))

    def _start_device(self, lside, rside, lkey, lvalid, rkey, rvalid,
                      device_keys) -> None:
        stats = self.join_stats
        li, ri = membudget.join_match_pairs(
            lkey, lvalid, rkey, rvalid, stats=stats,
            device_keys=device_keys, mesh=self.mesh, device=self.device)
        if stats.get("mesh_shards", 1) > 1 \
                and not stats.get("mesh_partitioned"):
            mesh_mod.publish_shard_balance(stats["shard_pairs"])
            mesh_mod.stats["sharded_probes"] += 1
        with kernels.phase("finish", self.device):
            self._finish_pairs(lside, rside, li, ri)
        stats["path"] = "device"
        if device_keys is not None:
            stats["device_resident_keys"] = True

    def _finish_pairs(self, lside, rside, li, ri) -> None:
        """Add the LEFT OUTER pads, merged back stably into left-scan
        order, and expose the columnar DeviceJoinResult."""
        if self.plan.join_type == Join.LEFT_OUTER:
            matched = np.bincount(li, minlength=len(lside))
            pad_l = np.flatnonzero(matched == 0)
            if len(pad_l):
                li = np.concatenate([li, pad_l])
                ri = np.concatenate([ri, np.full(len(pad_l), -1, np.int64)])
                # pads never share a left index with a match
                perm = np.argsort(li, kind="stable")
                li, ri = li[perm], ri[perm]
        self._device = col.DeviceJoinResult(
            lside, rside, li, ri, len(self.children[0].schema),
            self._right_width)

    def device_join_result(self):
        """Run the join (once) and expose its columnar result."""
        if not self._vector_tried:
            self._vector_tried = True
            self._try_vector_join()
        return self._device

    def next(self):
        if self._vector_iter is None:
            self._vector_iter = self.device_join_result().iter_rows(
                stats=self.join_stats)
        return next(self._vector_iter, None)


class HashAggExec(Executor):
    """COMPLETE-mode hash aggregation over a join or a scan, answered by
    the fused route (executor.fused_agg.try_fused_agg) alone: the port has
    no row loop, so an aggregate outside the fusable subset raises
    Unsupported."""

    def __init__(self, child: Executor, agg_funcs: list, group_by: list):
        self.children = [child]
        self.agg_funcs = agg_funcs
        self.group_by = group_by
        self.schema = list(agg_funcs)
        self._rows = None
        self._pos = 0

    def next(self):
        if self._rows is None:
            self._rows = fused_agg.try_fused_agg(self)
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row


# ---------------------------------------------------------------------------
# ordering over planes: SortExec, TopNExec
# ---------------------------------------------------------------------------

def _gather_rows(res, idx, width: int) -> list:
    """Rows `idx` of a columnar result, one gather per column."""
    if not len(idx):
        return []
    cols = [res.gather_datums(j, idx) for j in range(width)]
    return [list(t) for t in zip(*cols)]


class ProjectionExec(Executor):
    """A projection of the child's columns (plain Columns only: the port
    has no row expression evaluator). Seen through by the plane paths."""

    def __init__(self, child: Executor, exprs: list):
        for e in exprs:
            if not isinstance(e, Column):
                raise Unsupported(f"projecting {e!r} needs the row "
                                  f"expression evaluator")
        self.children = [child]
        self.exprs = exprs
        self.schema = [None] * len(exprs)

    def next(self):
        row = self.children[0].next()
        return None if row is None else [e.eval(row) for e in self.exprs]


class _ProjectedView:
    """A columnar result seen through a ProjectionExec: output column j
    reads source column idx_map[j]."""

    def __init__(self, res, idx_map: list):
        self.res = res
        self.idx_map = idx_map

    def __len__(self) -> int:
        return len(self.res)

    def column_plane(self, j: int):
        return self.res.column_plane(self.idx_map[j])

    def dict_code_plane(self, j: int):
        get = getattr(self.res, "dict_code_plane", None)
        return get(self.idx_map[j]) if get is not None else None

    def decimal_plane(self, j: int):
        get = getattr(self.res, "decimal_plane", None)
        return get(self.idx_map[j]) if get is not None else None

    def gather_datums(self, j: int, idx):
        return self.res.gather_datums(self.idx_map[j], idx)


def _columnar_view(child):
    """(the columnar result `child` offers — a join's DeviceJoinResult, a
    scan's ColumnarScanResult, either seen through a ProjectionExec — or
    None, and the node that computed it)."""
    if isinstance(child, ProjectionExec):
        res, node = _columnar_view(child.children[0])
        if res is None:
            return None, node
        return _ProjectedView(res, [e.index for e in child.exprs]), node
    get = getattr(child, "device_join_result", None)
    if get is None:
        get = getattr(child, "columnar_result", None)
    return (get() if get is not None else None), child


def _plane_sort_keys(res, by_items, width: int):
    """np.lexsort-convention key planes (least significant first; each
    by-item a directed value plane, then its directed NULL plane) that
    order the result's rows as the row comparator does: string keys by
    dictionary rank, DESC by complement (ints) or negation (floats, -0.0
    made +0.0 first), NULLs first ascending and last descending. A
    decimal column packed exactly sorts by its scaled int64 plane (one
    scale a column), where the reference gives decimal keys to its row
    comparator. None where a key has no order-exact plane (ci collation,
    an expression, time, unsigned)."""
    sort_keys = []
    for item in reversed(by_items):
        e = item.expr
        if not isinstance(e, Column) or _is_ci(e) or e.index >= width:
            return None
        j = e.index
        if _is_str(e):
            get_codes = getattr(res, "dict_code_plane", None)
            ent = get_codes(j) if get_codes is not None else None
            if ent is None:
                return None
            codes, va, dom = ent
            ranks = dom.ranks()
            vo = ranks[np.clip(codes, 0, max(len(ranks) - 1, 0))] \
                if len(ranks) else np.zeros(len(codes), np.int64)
            if item.desc:
                vo = ~vo
        else:
            kind, vals, va = res.column_plane(j)
            get_dec = getattr(res, "decimal_plane", None)
            dec = get_dec(j) if kind is None and get_dec is not None \
                else None
            if dec is not None:
                kind, (vals, va) = "i64", dec
            if kind == "f64":
                vo = np.where(vals == 0.0, 0.0, vals)
                if item.desc:
                    vo = -vo
            elif kind == "i64":
                vo = ~vals if item.desc else vals
            else:
                return None
        nullk = va.astype(np.int8) if not item.desc \
            else (~va).astype(np.int8)
        sort_keys.append(np.where(va, vo, np.zeros_like(vo)))
        sort_keys.append(nullk)
    return sort_keys


def _child_device(child, device):
    """The caller's device, else the child's (a join's, a scan's
    client's, seen through projections), else the card."""
    while isinstance(child, ProjectionExec):
        child = child.children[0]
    if device is None:
        device = getattr(child, "device", None)
    if device is None:
        device = getattr(getattr(child, "client", None), "device", None)
    return resolve_device(device)


class _PlaneOrder(Executor):
    """The plane path SortExec and TopNExec share: the child's columnar
    result in sorted order, `stats` the external sort's figures."""

    def __init__(self, child: Executor, by_items: list, device=None):
        self.children = [child]
        self.schema = child.schema
        self.by_items = by_items
        self.device = _child_device(child, device)
        self.stats: dict = {}
        self._rows = None
        self._pos = 0

    def _sorted(self):
        """(result, permutation) of the child's rows."""
        res, node = _columnar_view(self.children[0])
        if res is None:
            raise Unsupported("ordering a child that offers no planes "
                              "needs the row comparator loop")
        width = len(self.schema)
        with kernels.phase("sort_keys", self.device):
            keys = _plane_sort_keys(res, self.by_items, width)
        if keys is None:
            raise Unsupported("an ORDER BY key without an order-exact plane "
                              "needs the row comparator loop")
        with kernels.phase("sort", self.device):
            order = extsort.sort_order(keys, len(res), stats=self.stats,
                                       device=self.device)
        js = getattr(node, "join_stats", None)
        if js is not None:
            js["sort_plane"] = True
        return res, order

    def _materialize(self) -> list:
        raise NotImplementedError

    def next(self):
        if self._rows is None:
            self._rows = self._materialize()
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row


class SortExec(_PlaneOrder):
    """ORDER BY over a join's or a scan's planes: every row, sorted."""

    def _materialize(self) -> list:
        res, order = self._sorted()
        with kernels.phase("gather", self.device):
            return _gather_rows(res, order, len(self.schema))


class TopNExec(_PlaneOrder):
    """ORDER BY ... LIMIT offset, count over a join's or a scan's planes:
    the sorted order, and only rows offset .. offset + count gathered."""

    def __init__(self, child: Executor, by_items: list, offset: int,
                 count: int, device=None):
        super().__init__(child, by_items, device)
        self.offset = offset
        self.count = count

    def _materialize(self) -> list:
        res, order = self._sorted()
        keep = order[self.offset:self.offset + self.count]
        with kernels.phase("gather", self.device):
            return _gather_rows(res, keep, len(self.schema))
