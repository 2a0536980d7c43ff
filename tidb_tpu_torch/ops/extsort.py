"""The budget-aware external sort (the port of tidb_tpu/ops/extsort.py:
61-275, the sort part).

`sort_order` is the one sort entry of ORDER BY / TopN over planes and of
window ordering. Its key planes follow np.lexsort's convention: least
significant first, each by-item a directed value plane then its directed
NULL plane (executor.executors._plane_sort_keys). Routes, by size:

- n < SORT_DEVICE_FLOOR, or the ledger's budget 0 (the kill switch):
  np.lexsort on the host;
- the working set (sort_bytes_estimate) within the ledger's headroom: one
  K17 launch (ops.kernels.sort_perm);
- over it: `_partitioned_sort`, range partitions on the primary key
  (NULL stratum, then value pivots from a sorted sample) sorted one K17
  launch a pass and concatenated in key order. A job tied on its key
  descends to the next key (the salted split); a job tied on every key is
  already in its stable order. Every other job, however small, is a K17
  launch: the reference's host lexsort of jobs under the floor is not
  ported, so that no job a memory fault split ends on the host.

Every route gives np.lexsort(planes) bit for bit. A fault is not answered
by another route: a DeviceError from K17 reaches the caller. Only a
memory fault (errors.DeviceOOM) escalates: the pass target halves and the
unfinished jobs run again on K17, the finished ones kept; past
membudget.MAX_ESCALATIONS faults in a row (no pass finished between them)
it raises. The reference's last rung, the host
lexsort after a fault, is not ported (stats["sort_host_rung"] stays
False).
"""

from __future__ import annotations

import numpy as np
import torch

from tidb_tpu_torch import errors
from tidb_tpu_torch.ops import kernels, membudget
from tidb_tpu_torch.ops.client import resolve_device

# below this row count the host lexsort is the natural route
SORT_DEVICE_FLOOR = 4096

# working-set model of one pass, per row: each key plane to the card and
# its scratch (~2x), plus the order words and the int64 permutation
SORT_SCRATCH_BYTES = 24


def sort_bytes_estimate(planes, n: int) -> int:
    """Working-set estimate for sorting n rows of the key planes."""
    per_row = sum(int(np.asarray(p).dtype.itemsize) for p in planes)
    return int(n) * (2 * per_row + SORT_SCRATCH_BYTES)


def _pass_target(budget: int) -> int:
    """Per-pass byte target: the headroom, floored at an eighth of the
    budget (a headroom crushed by pins still gives finite passes)."""
    return max(membudget.headroom(), budget // 8, 1)


def _split_job(planes, rows: np.ndarray, level: int,
               pieces: int = 4) -> list:
    """Range-partition `rows` on key group `level` (0 = the primary
    by-item: the last (value, NULL) pair of the planes), in the key's
    order: NULL stratum ascending, value ranges ascending within it. Equal
    keys never straddle a split, so the sorted sub-jobs concatenate into
    the global stable order. Returns [rows] only when every row ties on
    this key group."""
    ln = len(planes)
    vplane = planes[ln - 2 * level - 2]
    nplane = planes[ln - 2 * level - 1]
    nv = nplane[rows]
    vv = vplane[rows]
    subs: list = []
    for stratum in np.unique(nv):
        smask = nv == stratum
        srows = rows[smask]
        vals = vv[smask]
        vmin = vals.min()
        vmax = vals.max()
        if len(srows) < 2 or vmin == vmax:
            subs.append(srows)
            continue
        # quantile pivots of a sorted stride sample, deduplicated and kept
        # above the minimum, so that the first range is never empty
        samp = np.sort(vals[::max(1, len(vals) // 4096)])
        picks = np.linspace(0, len(samp) - 1,
                            max(pieces, 2) + 1).astype(np.int64)[1:-1]
        piv = np.unique(samp[picks])
        piv = piv[piv > vmin]
        if piv.size == 0:
            piv = np.asarray([vmax], dtype=vals.dtype)
        part = np.searchsorted(piv, vals, side="right")
        for pidx in range(piv.size + 1):
            sub = srows[part == pidx]
            if sub.size:
                subs.append(sub)
    return subs


def _device_perm(planes, rows, device) -> np.ndarray:
    """One K17 launch over the rows' key planes (all rows when `rows` is
    None), its permutation back on the host. The card running out of
    memory anywhere in the pass (upload, launch, readback) raises
    DeviceOOM."""
    dev = torch.device(device)
    pick = (lambda p: p) if rows is None else (lambda p: p[rows])
    try:
        ts = [torch.from_numpy(np.ascontiguousarray(pick(p))).to(dev)
              for p in planes]
        return kernels.sort_perm(ts, len(ts[0])).cpu().numpy()
    except torch.cuda.OutOfMemoryError as e:
        raise kernels.device_oom("sort pass", e) from e


def sort_order(planes, n: int, stats: dict | None = None,
               device=None) -> np.ndarray:
    """The stable sort permutation (int64 [n], numpy) of the key planes,
    on `device` (None: the card) where the route uses it."""
    n = int(n)
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    host = [np.asarray(p) for p in planes]
    budget = membudget.budget_bytes()
    if n < SORT_DEVICE_FLOOR or budget <= 0:
        return np.lexsort(host)
    dev = resolve_device(device)
    est = sort_bytes_estimate(host, n)
    if est <= membudget.headroom():
        try:
            with membudget.reserve(est, "sort"):
                return _device_perm(host, None, dev)
        except errors.DeviceOOM:
            # the pass did not fit after all: split it
            return _partitioned_sort(host, n, stats, dev,
                                     target=max(est // 2, 1), escalations=1)
    return _partitioned_sort(host, n, stats, dev)


def _partitioned_sort(planes, n: int, stats: dict | None, device,
                      target: int | None = None,
                      escalations: int = 0) -> np.ndarray:
    """A worklist of (rows, key level) jobs in primary-key order: a job
    over the pass target splits by value pivots, or descends to the next
    key where it ties; a job tied on every key keeps its input order;
    the rest sort one K17 launch each. Finished jobs are checkpoints: a
    DeviceOOM halves the target and splits only the unfinished jobs; more
    than MAX_ESCALATIONS memory faults without a finished pass between
    them raise."""
    if target is None:
        target = _pass_target(membudget.budget_bytes())
    levels = len(planes) // 2
    jobs: list = [(np.arange(n, dtype=np.int64), 0)]
    results: list = []
    passes = salted = 0
    streak = escalations    # memory faults since the last finished pass
    if stats is not None:
        stats["spilled"] = True
    i = 0
    while i < len(jobs):
        rows, level = jobs[i]
        if rows.size <= 1:
            results.append(rows)
            i += 1
            continue
        jest = sort_bytes_estimate(planes, rows.size)
        if jest > target:
            subs = _split_job(planes, rows, level,
                              pieces=min(8, -(-jest // target)))
            if len(subs) > 1:
                jobs[i:i + 1] = [(s, level) for s in subs]
                continue
            if level + 1 < levels:
                # every row ties on this key: the next key orders them
                salted += 1
                jobs[i] = (rows, level + 1)
                continue
            # tied on every key: the stable order is the input order
            results.append(rows)
            i += 1
            continue
        try:
            with membudget.reserve(jest, "sort_pass"):
                perm = _device_perm(planes, rows, device)
        except errors.DeviceOOM:
            escalations += 1
            streak += 1
            if streak > membudget.MAX_ESCALATIONS:
                raise
            target = max(target // 2, 1)
            continue
        streak = 0
        results.append(rows[perm])
        passes += 1
        i += 1
    order = np.concatenate(results) if results else np.zeros(0, np.int64)
    if stats is not None:
        stats["sort_passes"] = passes
        stats["sort_partitions"] = len(results)
        stats["sort_escalations"] = escalations
        stats["sort_salted"] = salted
        stats["sort_host_rung"] = False
    return order
