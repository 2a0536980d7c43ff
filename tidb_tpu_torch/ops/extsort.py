"""The budget-aware external sort and the spilling group-by states (the
port of tidb_tpu/ops/extsort.py: the sort :61-275, the states :278-524).

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

`region_states_spill` is the states finisher's route when a statement's
states working set is over the headroom (`states_over_headroom`,
copr.columnar_region.finish_states_batch): group-radix passes over the
batched K6 (kernels.region_agg_states_batched), each group in exactly one
pass, its states scattered straight into the outputs (integer SUM / COUNT
/ MIN / MAX and f64 MIN / MAX are order-free; float SUM never takes the
device states). Checkpoints and DeviceOOM escalation as the partitioned
join's (ops.membudget); a hot single group splits its rows by a salted
positional hash and merges the chunk states by monoid. Where the
reference lowers argument-plane programs to its host evaluator before it
spills (row-aligned planes cannot split by group), the port cuts K5's
argument planes on the card: one index_select by each pass's rows.
"""

from __future__ import annotations

import copy

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

# states working-set model per row: each device reduction ships an 8-byte
# value plane and a 1-byte contrib plane through one segment reduction
# (~2x), plus the shared 8-byte group-id plane; each segment holds a
# 16-byte state per reduction
STATES_ROW_BYTES_PER_SPEC = 17
STATES_SEG_BYTES_PER_SPEC = 16

# the reference's copr.spill.* counters of the states spill
spill_stats = {"groupbys": 0, "groupby_passes": 0, "escalations": 0,
               "checkpoint_hits": 0, "salted_splits": 0}


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


# ---------------------------------------------------------------------------
# spilling group-by states
# ---------------------------------------------------------------------------

_ROW_SPACE = ("plane", "pvalid")


def states_bytes_estimate(segs) -> int:
    """Working-set estimate of the batched states launch over `segs`
    (kernels.region_agg_states_batched's (gid, specs, G, ...) entries):
    lengths only."""
    total = 0
    for gid, specs, g, *_rest in segs:
        nspecs = max(len(specs), 1)
        total += len(gid) * (nspecs * STATES_ROW_BYTES_PER_SPEC + 8) \
            + (int(g) + 1) * nspecs * STATES_SEG_BYTES_PER_SPEC
    return int(total)


def states_over_headroom(segs) -> bool:
    """A budget and a states working set over the ledger's headroom: the
    spill trigger, argument planes or not."""
    if membudget.budget_bytes() <= 0:
        return False
    return states_bytes_estimate(segs) > membudget.headroom()


def _take(v, rows_d: torch.Tensor):
    """A spec's value slot restricted to a pass's rows on the card: a
    values plane, or an argument plane's values and valid."""
    if v is None:
        return None
    if getattr(v, "is_arg_plane", False):
        cut = copy.copy(v)
        cut.values = v.values.index_select(0, rows_d)
        cut.valid = v.valid.index_select(0, rows_d)
        return cut
    return v.index_select(0, rows_d)


def _sub_segs(segs, gids, luts, rows, n_groups, dev) -> list:
    """The batched-states input of one pass: each region's rows `rows[r]`,
    their pass-local group ids and their device reductions."""
    out = []
    for r, (_gid, specs, _G, *_rest) in enumerate(segs):
        rs = rows[r]
        rows_d = torch.from_numpy(rs).to(dev)
        sub = [(op, _take(v, rows_d), np.asarray(ok, bool)[rs])
               for op, v, ok in specs if op not in _ROW_SPACE]
        out.append((luts[r][gids[r][rs]], sub, n_groups[r], len(rs)))
    return out


def _states_pass(segs, device, nbytes: int) -> list:
    """One batched K6 launch under a reservation; the card running out of
    memory anywhere in it raises DeviceOOM."""
    with membudget.reserve(nbytes, "states_pass"):
        try:
            return kernels.region_agg_states_batched(segs, device)
        except torch.cuda.OutOfMemoryError as e:
            raise kernels.device_oom("states pass", e) from e


def region_states_spill(segs, device, stats: dict | None = None) -> list:
    """kernels.region_agg_states_batched(segs, device), in group-radix
    passes: the same outputs (outs[r], one array per spec: [G_r] states,
    or [cap_r] for the row-space plane / pvalid readbacks, which are read
    once, outside the passes), with a bounded working set a pass.

    Groups split by splitmix64 over the dense group index
    (membudget.partition_codes), so each group's rows run in one pass;
    completed partitions checkpoint across DeviceOOM escalations (P x 2,
    only unfinished groups replayed); a partition of one hot group over
    the pass target splits its rows by a salted positional hash. More than
    MAX_ESCALATIONS rounds with a fault, or P past MAX_PARTITIONS, raise;
    any other DeviceError raises at once."""
    dev = torch.device(device)
    nregions = len(segs)
    gids = [np.asarray(g, np.int64) for g, *_rest in segs]
    caps = [int(g) for _g, _s, g, *_rest in segs]
    dspecs = [j for j, (op, _v, _ok) in enumerate(segs[0][1])
              if op not in _ROW_SPACE]
    nspecs = max(len(dspecs), 1)
    budget = membudget.budget_bytes()
    target = _pass_target(budget)
    parts = membudget.MIN_PARTITIONS
    est = states_bytes_estimate(segs)
    while parts < membudget.MAX_PARTITIONS and est // parts > target:
        parts *= 2
    spill_stats["groupbys"] += 1
    outs = []
    for r, (_g, specs, _G, *_rest) in enumerate(segs):
        row = []
        for op, v, ok in specs:
            if op == "plane":
                row.append(v.values.cpu().numpy().astype(np.float64))
            elif op == "pvalid":
                row.append(np.asarray(ok, bool) & v.valid.cpu().numpy())
            else:
                row.append(None)
        outs.append(row)
    done = [np.zeros(g, bool) for g in caps]
    passes = escalations = salted = 0
    if stats is not None:
        stats["spilled"] = True
    while True:
        with kernels.phase("host_spill_partition", dev):
            codes = [membudget.partition_codes(
                np.arange(g, dtype=np.int64), np.ones(g, bool), parts)
                for g in caps]
        fault = None
        completed = 0
        for p in range(parts):
            gsel = [np.flatnonzero((codes[r] == p) & ~done[r])
                    for r in range(nregions)]
            n_groups = [len(g) for g in gsel]
            if not sum(n_groups):
                continue
            luts, rows = [], []
            with kernels.phase("host_spill_partition", dev):
                for r in range(nregions):
                    lut = np.full(caps[r] + 1, n_groups[r], np.int64)
                    lut[gsel[r]] = np.arange(n_groups[r], dtype=np.int64)
                    luts.append(lut)
                    rows.append(np.flatnonzero(lut[gids[r]] < n_groups[r]))
            pass_rows = sum(len(rs) for rs in rows)
            pass_est = pass_rows * (nspecs * STATES_ROW_BYTES_PER_SPEC + 8) \
                + sum(n_groups) * nspecs * STATES_SEG_BYTES_PER_SPEC
            try:
                if pass_est > target and max(n_groups) <= 1 \
                        and pass_rows >= 2:
                    # one group per region: radix cannot split it
                    chunk_outs = _salted_states_chunks(
                        segs, gids, luts, rows, n_groups, pass_est, target,
                        escalations, dev)
                    salted += 1
                    spill_stats["salted_splits"] += 1
                    passes += len(chunk_outs)
                    merged = _merge_states_chunks(segs, dspecs, n_groups,
                                                  chunk_outs)
                else:
                    merged = _states_pass(
                        _sub_segs(segs, gids, luts, rows, n_groups, dev),
                        dev, pass_est)
                    passes += 1
            except errors.DeviceOOM as e:
                fault = e
                continue
            for r in range(nregions):
                for k, j in enumerate(dspecs):
                    if outs[r][j] is None:
                        outs[r][j] = np.zeros(
                            caps[r], np.asarray(merged[r][k]).dtype)
                    outs[r][j][gsel[r]] = merged[r][k]
                done[r][gsel[r]] = True
            completed += 1
        if fault is None:
            break
        escalations += 1
        spill_stats["escalations"] += 1
        spill_stats["checkpoint_hits"] += completed
        if escalations > membudget.MAX_ESCALATIONS \
                or parts * 2 > membudget.MAX_PARTITIONS:
            raise fault
        parts *= 2
    spill_stats["groupby_passes"] += passes
    for r in range(nregions):
        for j in dspecs:
            if outs[r][j] is None:      # a region without a group
                outs[r][j] = np.zeros(0, np.int64)
    if stats is not None:
        stats["states_passes"] = passes
        stats["states_partitions"] = parts
        stats["states_escalations"] = escalations
        stats["states_salted"] = salted
    return outs


def _salted_states_chunks(segs, gids, luts, rows, n_groups, pass_est: int,
                          target: int, escalations: int, dev) -> list:
    """One hot-group pass as salted row chunks: rows split by splitmix64
    over their salted positions, order-free because every device states
    op is a commutative monoid. Returns each chunk's batched-states
    output."""
    chunks = min(max(2, -(-pass_est // target)) << escalations,
                 membudget.MAX_SALTED_CHUNKS)
    salt = np.int64(0x5D4)    # decorrelated from the group radix
    hashed = [membudget.partition_codes(np.bitwise_xor(rs, salt),
                                        np.ones(len(rs), bool), chunks)
              for rs in rows]
    chunk_outs = []
    for c in range(chunks):
        crows = [rs[h == c] for rs, h in zip(rows, hashed)]
        if not any(len(x) for x in crows):
            continue
        chunk_outs.append(_states_pass(
            _sub_segs(segs, gids, luts, crows, n_groups, dev), dev,
            max(pass_est // chunks, 1)))
    return chunk_outs


def _merge_states_chunks(segs, dspecs, n_groups, chunk_outs) -> list:
    """The chunks' partial states combined by monoid: sums and counts add
    (wrapping), minima np.minimum, maxima np.maximum; an empty chunk holds
    the identities."""
    merged = []
    for r in range(len(segs)):
        row = []
        for k, j in enumerate(dspecs):
            op = segs[r][1][j][0]
            acc = None
            for co in chunk_outs:
                part = np.asarray(co[r][k])
                if acc is None:
                    acc = part.copy()
                elif op == "min":
                    acc = np.minimum(acc, part)
                elif op == "max":
                    acc = np.maximum(acc, part)
                else:
                    acc = acc + part
            row.append(np.zeros(n_groups[r], np.int64) if acc is None
                       else acc)
        merged.append(row)
    return merged
