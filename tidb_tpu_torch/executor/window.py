"""Window functions (the port of tidb_tpu/executor/window.py:46-384).

WindowExec evaluates every window call of a SELECT over the child's rows
and emits them in input order with one column appended per call. For each
call:

1. the PARTITION BY and ORDER BY keys lower to directed key planes (the
   ORDER BY recipe: a value plane and a NULL plane per key, strings by
   rank among the column's distinct values), and ops.extsort.sort_order
   gives their stable order (K17, in one pass or in partitioned passes
   under the HBM ledger; np.lexsort below the floor or at budget 0);
2. partition codes and global peer ids are change-flag cumsums over the
   sorted planes (a new partition always opens a new peer group);
3. K18 (ops.kernels.window_scan) computes the ranking or default-frame
   reduction: one launch within the ledger's headroom, else one launch per
   span of whole partitions (a figure reads only its own partition); below
   the floor or at budget 0 K18's plain version on the host's tensors
   (kernels.window_scan_plain);
4. the figures return to input order as datums: integer SUM as a Decimal,
   NULL for SUM / MIN / MAX over a frame with no contributing row.

A fault raises: a DeviceError from K17 or K18 is never answered by the
plain version. Shapes the reference sends to its row protocol raise
Unsupported (the port has no row expression engine): keys that do not
lower (ci collations, decimals, times), and reductions over float or
decimal arguments.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np
import torch

from tidb_tpu_torch.executor.distsql_exec import Executor
from tidb_tpu_torch.executor.executors import _child_device
from tidb_tpu_torch.ops import extsort, kernels, membudget
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.plan import SortItem
from tidb_tpu_torch.types.datum import NULL, Datum, Kind

RANKING_FUNCS = frozenset(("row_number", "rank", "dense_rank"))

# bytes a row holds on the card in one K18 launch: seg + peer, plus values,
# flag and output per reduction spec
WINDOW_ROW_BYTES = 16
WINDOW_SPEC_BYTES = 25


class WindowExec(Executor):
    """Appends one column per window call (plan.WindowFuncDesc, bound to
    the child's columns) to the child's rows, in input order. `stats`
    counts "windows" (calls scanned on the device route), "window_passes"
    (K18 launches) and "host_scans" (calls under the floor or at budget
    0)."""

    def __init__(self, child: Executor, window_funcs: list, device=None):
        self.children = [child]
        self.window_funcs = window_funcs
        self.schema = list(child.schema) + [None] * len(window_funcs)
        self.device = _child_device(child, device)
        self.stats = {"windows": 0, "window_passes": 0, "host_scans": 0}
        self._out: list | None = None
        self._pos = 0

    def next(self):
        if self._out is None:
            with kernels.phase("window_rows", self.device):
                rows = self.children[0].drain()
            cols = [self._compute(d, rows) for d in self.window_funcs]
            with kernels.phase("window_emit", self.device):
                self._out = [rows[i] + [c[i] for c in cols]
                             for i in range(len(rows))]
        if self._pos >= len(self._out):
            return None
        row = self._out[self._pos]
        self._pos += 1
        return row

    # ---- one window call over the rows ----

    def _compute(self, desc, rows) -> list:
        n = len(rows)
        if n == 0:
            return []
        dev = self.device
        with kernels.phase("window_keys", dev):
            keys, spec = _lower(desc, rows)
        with kernels.phase("window_sort", dev):
            order = extsort.sort_order(keys, n, device=dev)
        # partition and peer ids over the sorted planes: the partition
        # planes are the trailing 2 * len(partition_by) (least significant
        # first)
        g = [k[order] for k in keys]
        npart = 2 * len(desc.partition_by)
        seg_chg = np.zeros(n, bool)
        peer_chg = np.zeros(n, bool)
        for k in (g[len(g) - npart:] if npart else []):
            seg_chg[1:] |= k[1:] != k[:-1]
        for k in g:
            peer_chg[1:] |= k[1:] != k[:-1]
        peer_chg |= seg_chg
        seg = np.cumsum(seg_chg.astype(np.int64))
        peer = np.cumsum(peer_chg.astype(np.int64))

        name = desc.name
        if name in RANKING_FUNCS:
            specs = [(name, None, None)]
        else:
            vals, contrib = spec
            specs = [(name, vals[order] if vals is not None else None,
                      contrib[order]),
                     ("count", None, contrib[order])]
        with kernels.phase("window_scan", dev):
            outs = self._scan(specs, seg, peer, n)
        with kernels.phase("window_emit", dev):
            return _lift(name, order, outs)

    def _scan(self, specs, seg, peer, n) -> list:
        """K18 within the headroom, in passes over spans of whole
        partitions above it (a single partition over the target still
        launches once: the reservation is accounting, not a gate); K18's
        plain version on the host below the floor or at budget 0."""
        row_bytes = (WINDOW_ROW_BYTES
                     + WINDOW_SPEC_BYTES * sum(1 for s in specs
                                               if s[0] not in RANKING_FUNCS)
                     + 8 * len(specs))
        est = n * row_bytes
        if n < extsort.SORT_DEVICE_FLOOR or membudget.budget_bytes() <= 0:
            self.stats["host_scans"] += 1
            return _window_scan(specs, seg, peer, 0, n, "cpu")
        target = max(membudget.headroom(), 1)
        self.stats["windows"] += 1
        if est <= target:
            with membudget.reserve(est, "window_scan"):
                outs = _window_scan(specs, seg, peer, 0, n, self.device)
            self.stats["window_passes"] += 1
            return outs
        starts = np.flatnonzero(np.concatenate([[True],
                                                seg[1:] != seg[:-1]]))
        span = max(int(target // row_bytes), 1)
        bounds = [0]
        for st in starts[1:]:
            if st - bounds[-1] >= span:
                bounds.append(int(st))
        bounds.append(n)
        parts = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            with membudget.reserve((b - a) * row_bytes, "window_pass"):
                parts.append(_window_scan(specs, seg, peer, a, b,
                                          self.device))
            self.stats["window_passes"] += 1
        return [np.concatenate(cols) for cols in zip(*parts)]


def _window_scan(specs, seg, peer, a: int, b: int, dev) -> list:
    """kernels.window_scan over rows [a, b) on `dev`: one K18 launch on
    the card, its plain version on the host."""

    def t(x):
        return None if x is None else \
            torch.from_numpy(np.ascontiguousarray(x[a:b])).to(dev)

    try:
        outs = kernels.window_scan(
            t(seg), t(peer), [(op, t(v), t(c)) for op, v, c in specs],
            b - a)
        return [o.cpu().numpy() for o in outs]
    except torch.cuda.OutOfMemoryError as e:
        raise kernels.device_oom("window pass", e) from e


def _lift(name: str, order, outs) -> list:
    """The figures of sorted row k back at input row order[k], as
    datums."""
    figures = outs[0].tolist()
    fcount = outs[1].tolist() if len(outs) > 1 else None
    res = [None] * len(figures)
    for k, i in enumerate(order.tolist()):
        if name in RANKING_FUNCS or name == "count":
            res[i] = Datum.i64(figures[k])
        elif fcount[k] == 0:
            res[i] = NULL          # no contributing row in the frame
        elif name == "sum":
            res[i] = Datum.dec(Decimal(figures[k]))
        else:
            res[i] = Datum.i64(figures[k])
    return res


def _lower(desc, rows):
    """(key planes, (vals, contrib)) of one window call; Unsupported where
    a key or the argument does not lower exactly."""
    n = len(rows)
    items = [SortItem(e, False) for e in desc.partition_by] \
        + list(desc.order_by)
    keys: list = []
    for item in reversed(items):
        ent = _datum_plane([item.expr.eval(r) for r in rows], item.expr)
        if ent is None:
            raise Unsupported("a window key without an order-exact plane "
                              "needs the row protocol")
        vo, va = ent
        if item.desc:
            vo = -vo if vo.dtype == np.float64 else ~vo
            nullk = (~va).astype(np.int8)
        else:
            nullk = va.astype(np.int8)
        keys.append(np.where(va, vo, np.zeros_like(vo)))
        keys.append(nullk)
    if not keys:
        # no PARTITION BY and no ORDER BY: one partition in input order
        keys = [np.zeros(n, np.int64), np.zeros(n, np.int8)]
    spec = (None, None)
    if desc.name not in RANKING_FUNCS:
        datums = [desc.args[0].eval(r) for r in rows]
        va = np.array([not d.is_null() for d in datums], bool)
        if desc.name == "count":
            spec = (None, va)
        else:
            if not all(d.is_null() or d.kind == Kind.INT64 for d in datums):
                raise Unsupported(f"window {desc.name} over float or decimal "
                                  f"arguments needs the row protocol")
            vals = np.array([0 if d.is_null() else int(d.val)
                             for d in datums], np.int64)
            spec = (vals, va)
    return keys, spec


def _datum_plane(datums, expr):
    """(undirected int64 / f64 value plane, valid) of one key column; None
    where the kinds have no order-exact plane: ints as int64, floats with
    -0.0 made +0.0, strings by rank among the distinct values."""
    rt = getattr(expr, "ret_type", None)
    if rt is not None and rt.is_ci_collation():
        return None
    va = np.array([not d.is_null() for d in datums], bool)
    kinds = {d.kind for d in datums if not d.is_null()}
    if not kinds:
        return np.zeros(len(datums), np.int64), va
    if kinds <= {Kind.INT64}:
        vo = np.array([0 if d.is_null() else int(d.val) for d in datums],
                      np.int64)
        return vo, va
    if kinds <= {Kind.FLOAT64}:
        vo = np.array([0.0 if d.is_null() else float(d.val)
                       for d in datums], np.float64)
        return np.where(vo == 0.0, 0.0, vo), va
    if kinds <= {Kind.STRING, Kind.BYTES}:
        svals = [None if d.is_null()
                 else (d.val if isinstance(d.val, bytes)
                       else str(d.val).encode()) for d in datums]
        ranks = {s: r for r, s in
                 enumerate(sorted({s for s in svals if s is not None}))}
        vo = np.array([0 if s is None else ranks[s] for s in svals],
                      np.int64)
        return vo, va
    return None
