"""The HBM ledger and the budget-aware join router (the port of
tidb_tpu/ops/membudget.py: the ledger :60-410, the key-radix partitioning
:412-462 and the join router with its partitioned passes :465-741; and of
tidb_tpu/sessionctx/__init__.py:200 parse_hbm_budget_spec).

The budget is set from its sysvar spec: "auto" (AUTO_BUDGET_FRACTION of
the card's memory, from torch.cuda.mem_get_info, which initialises CUDA;
0 on a rig without CUDA), 0 (the kill switch: no ledger, and the external
sort and the window scan take their host route, np.lexsort and the plain
window formulas) or a byte count. Long-lived resident planes charge
`pinned` (kernels.batch_planes, freed by a weakref finalizer when the batch
dies); a kernel's transient working set charges `reserved` for the length
of its launch (`reserve`). `headroom()` is what a new reservation may still
take: the external sort (ops.extsort) and the window scan
(executor.window) split their work into passes when it is short. A
reservation is accounting, never a gate: one past the budget proceeds and
counts stats["over_budget"].

`join_match_pairs` is the join entry of executor.HashJoinExec. Within the
headroom (or at budget 0, or over an empty build side) it is one
reservation and kernels.join_match_pairs (K11 + K12, sharded over a
mesh's shards). A build side over the headroom takes the out-of-core
route (stats["partitioned"]) with the keys on the join's device (host
planes go up once): on a mesh of more than one shard the key-partitioned
probe (ops.mesh.join_probe_partitioned: K21 key_partition, K11 per
partition, the partition-segmented K12; the shards share the card, so the
whole working set is charged), else grace-hash passes on one device: K21
lays both sides out partition-major by key radix (`partition_codes`:
splitmix64 over the key's int64 image, the RegionPlacement discipline),
one kernels.join_match_pairs a partition over its rows, the pairs merged
stably by global left row, which is the single-pass emission order bit
for bit. Completed partitions are checkpoints; a DeviceOOM in a pass
doubles P and lays out again only the unfinished rows; a hot key that
radix cannot split runs as salted probe chunks x contiguous build
blocks.

Faults raise. The reference degrades the partitioned mesh probe to the
replicated one and then to the passes on any DeviceError
(tidb_tpu/ops/membudget.py:509-534); the port raises a fault of the mesh
rung, and in the passes only a DeviceOOM escalates (as extsort.sort_order).

The reference publishes the ledger as metrics gauges and its spill
counters as copr.* metrics; the port, which has no metrics registry yet,
keeps the same figures in `stats` dicts.
"""

from __future__ import annotations

import threading

import numpy as np

from tidb_tpu_torch import errors
from tidb_tpu_torch.ops import columnar as col

DEFAULT_BUDGET_SPEC = "auto"

# fraction of the card's memory "auto" budgets to: the CUDA context,
# PyTorch's caching allocator and allocations outside the ledger need the
# rest
AUTO_BUDGET_FRACTION = 0.85

# an out-of-core operator halves its pass target (or doubles its
# partitions) on a memory fault at most this many times, then raises
MAX_ESCALATIONS = 4

# partition bounds of the partitioned joins and states: P starts at the
# smallest power of two whose per-partition slice fits the pass target and
# doubles on each DeviceOOM, up to MAX_PARTITIONS
MIN_PARTITIONS = 2
MAX_PARTITIONS = 1024
# bound on the salted split of a hot-key partition (probe chunks x build
# blocks)
MAX_SALTED_CHUNKS = 64

# per-row working-set estimate of a join's build side: key plane (8) +
# valid plane (1) + the sorted order words (8) + the order permutation (8),
# rounded up; the probe side adds its key and valid planes, and each pair
# its two indices
BUILD_ROW_BYTES = 32
PROBE_ROW_BYTES = 16
PAIR_ROW_BYTES = 16
# the key-partitioned layouts on the card: each side's partition-major
# gather index (8), held across the passes; the mesh probe adds each
# side's partition-major key and valid copies (9), rounded up
PARTITION_ROW_BYTES = 8
LAYOUT_ROW_BYTES = 24

_lock = threading.Lock()
_budget_spec: str | int = DEFAULT_BUDGET_SPEC
_budget_resolved: int | None = None     # the cached "auto" resolution
_reserved = 0
_pinned = 0

# current and high-water bytes per reservation kind ("pinned" tracks the
# pins), and the combined reserved + pinned peak
_res_by_kind: dict = {}
_hw_by_kind: dict = {}
_hw_total = 0

# the reference's device.hbm.* gauges and counters: "over_budget" counts
# reservations past the budget; "estimate_error_ratio" is the last
# reservation's measured allocator delta over its estimate
stats = {"over_budget": 0, "estimate_error_ratio": None}


def parse_hbm_budget_spec(value) -> "str | int":
    """'auto', or an integer byte count >= 0 (0 = the kill switch).
    Raises ValueError."""
    s = str(value).strip().lower()
    if s == "auto":
        return "auto"
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"tidb_tpu_hbm_budget_bytes must be 'auto' or an integer "
            f">= 0, got {value!r}") from None
    if n < 0:
        raise ValueError("tidb_tpu_hbm_budget_bytes must be >= 0")
    return n


def _hw_note_locked(kind: str, current: int) -> None:
    global _hw_total
    if current > _hw_by_kind.get(kind, 0):
        _hw_by_kind[kind] = current
    _hw_total = max(_hw_total, _reserved + _pinned)


def highwater() -> dict:
    """{kind: high-water bytes} since start or reset, plus "total", the
    combined reserved + pinned peak."""
    with _lock:
        d = dict(_hw_by_kind)
        d["total"] = _hw_total
        return d


def reset_highwater() -> None:
    global _hw_total
    with _lock:
        _hw_by_kind.clear()
        _hw_total = 0


def set_budget(spec) -> None:
    """Install the budget from its spec ('auto', 0 or bytes)."""
    global _budget_spec, _budget_resolved
    val = parse_hbm_budget_spec(spec)
    with _lock:
        _budget_spec = val
        _budget_resolved = None


def _resolve_budget_locked() -> int:
    global _budget_resolved
    if isinstance(_budget_spec, int):
        return _budget_spec
    if _budget_resolved is None:
        _budget_resolved = _derive_card_budget()
    return _budget_resolved


def _derive_card_budget() -> int:
    """'auto': the card's memory scaled by AUTO_BUDGET_FRACTION (reading
    it initialises CUDA); 0 on a rig without CUDA, as the reference
    resolves on a rig whose backend reports no limit."""
    import torch
    if not torch.cuda.is_available():
        return 0
    _free, total = torch.cuda.mem_get_info()
    return int(total * AUTO_BUDGET_FRACTION)


def budget_bytes() -> int:
    """The resolved budget in bytes; 0 = the kill switch (host routes)."""
    with _lock:
        return _resolve_budget_locked()


def headroom() -> int:
    """Bytes a new reservation may take before crossing the budget (0
    at the kill switch: callers gate on budget_bytes())."""
    with _lock:
        budget = _resolve_budget_locked()
        return max(budget - _reserved - _pinned, 0) if budget > 0 else 0


def usage() -> tuple[int, int]:
    """(reserved, pinned)."""
    with _lock:
        return _reserved, _pinned


def pin(nbytes: int) -> None:
    """Charge a long-lived device allocation; unpin() at the end of its
    life (kernels.batch_planes registers a weakref finalizer)."""
    global _pinned
    with _lock:
        _pinned += int(nbytes)
        _hw_note_locked("pinned", _pinned)


def unpin(nbytes: int) -> None:
    global _pinned
    with _lock:
        _pinned = max(_pinned - int(nbytes), 0)


def would_exceed_pin(nbytes: int) -> bool:
    """True when pinning nbytes would cross the budget."""
    with _lock:
        budget = _resolve_budget_locked()
        if budget <= 0:
            return False
        return _pinned + _reserved + int(nbytes) > budget


# ---- allocator reconciliation: a reservation's estimate against what the
# allocator measured over it ----

_stats_provider = None
_stats_checked = False


def set_stats_provider(fn) -> None:
    """Install the allocator-stats source: a callable returning a dict
    with "bytes_in_use" (or None when it cannot measure), or None to
    detect the card's own again."""
    global _stats_provider, _stats_checked
    with _lock:
        _stats_provider = fn
        _stats_checked = fn is not None


def _card_stats() -> dict:
    import torch
    return {"bytes_in_use":
            torch.cuda.memory_stats()["allocated_bytes.all.current"]}


def _detect_stats_provider() -> None:
    """Adopt the card's allocator once CUDA is initialised; never
    initialise it here."""
    global _stats_provider, _stats_checked
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _stats_provider = _card_stats
        _stats_checked = True


def _measured_bytes():
    """The allocator's bytes in use now, or None when unmeasurable."""
    if not _stats_checked:
        _detect_stats_provider()
    fn = _stats_provider
    if fn is None:
        return None
    got = fn()
    if not got:
        return None
    return int(got.get("bytes_in_use", 0))


class _Reservation:
    """Scoped charge of a launch's transient working set."""

    __slots__ = ("nbytes", "kind", "_m0")

    def __init__(self, nbytes: int, kind: str):
        self.nbytes = int(nbytes)
        self.kind = kind
        self._m0 = None

    def __enter__(self):
        global _reserved
        self._m0 = _measured_bytes()
        with _lock:
            budget = _resolve_budget_locked()
            if budget > 0 and _reserved + _pinned + self.nbytes > budget:
                stats["over_budget"] += 1
            _reserved += self.nbytes
            cur = _res_by_kind.get(self.kind, 0) + self.nbytes
            _res_by_kind[self.kind] = cur
            _hw_note_locked(self.kind, cur)
        return self

    def __exit__(self, *exc):
        global _reserved
        if self._m0 is not None and self.nbytes > 0:
            m1 = _measured_bytes()
            if m1 is not None:
                stats["estimate_error_ratio"] = round(
                    max(m1 - self._m0, 0) / self.nbytes, 6)
        with _lock:
            _reserved = max(_reserved - self.nbytes, 0)
            _res_by_kind[self.kind] = max(
                _res_by_kind.get(self.kind, 0) - self.nbytes, 0)
        return False


def reserve(nbytes: int, kind: str = "dispatch") -> _Reservation:
    """Charge `reserved` for the length of a launch (a context manager)."""
    return _Reservation(nbytes, kind)


def planes_nbytes(planes, live=None, extra=()) -> int:
    """Working-set estimate of one launch: the bytes of its input planes
    (arrays or tensors, or (values, valid) tuples of them), its live plane
    and its extra argument blocks."""
    def nb(a) -> int:
        if a is None:
            return 0
        if hasattr(a, "nbytes"):
            return int(a.nbytes)
        if hasattr(a, "element_size"):
            return int(a.numel() * a.element_size())
        return 0

    n = 0
    ents = planes.values() if hasattr(planes, "values") else planes
    for ent in ents:
        if isinstance(ent, tuple):
            n += sum(nb(a) for a in ent)
        else:
            n += nb(ent)
    return n + nb(live) + sum(nb(a) for a in extra)


# ---------------------------------------------------------------------------
# key-radix partitioning (the RegionPlacement splitmix64 discipline over key
# planes; K21 computes the same on the card) and the estimates
# ---------------------------------------------------------------------------

def partition_codes(vals: np.ndarray, valid: np.ndarray,
                    parts: int) -> np.ndarray:
    """Radix partition per row in [0, parts) (int64 numpy): splitmix64 over
    the key's int64 image, modulo parts. A float key hashes its bit pattern
    with -0.0 made +0.0 first (SQL equality: the join kernels match them,
    so they share a partition); a NULL or invalid row goes to partition 0.
    The arithmetic is kernels.partition_codes_t, K21's plain version."""
    import torch

    from tidb_tpu_torch.ops import kernels
    return kernels.partition_codes_t(
        torch.from_numpy(np.ascontiguousarray(vals)),
        torch.from_numpy(np.ascontiguousarray(valid, dtype=bool)),
        parts).numpy()


def build_bytes_estimate(n_right: int) -> int:
    return col.bucket_capacity(max(int(n_right), 1)) * BUILD_ROW_BYTES


def join_bytes_estimate(n_left: int, n_right: int) -> int:
    lcap = col.bucket_capacity(max(int(n_left), 1))
    return build_bytes_estimate(n_right) \
        + lcap * (PROBE_ROW_BYTES + PAIR_ROW_BYTES)


def _initial_partitions(build_bytes: int, budget: int) -> int:
    """The smallest power-of-two P whose per-partition build slice fits
    the headroom (floored at an eighth of the budget, so that a headroom
    crushed by pins still gives a finite P)."""
    target = max(headroom(), budget // 8, 1)
    p = MIN_PARTITIONS
    while p < MAX_PARTITIONS and build_bytes // p > target:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# the budget-aware join router
# ---------------------------------------------------------------------------

def join_match_pairs(lkey, lvalid, rkey, rvalid, stats: dict | None = None,
                     device_keys=None, mesh=None, device=None) -> tuple:
    """(l_idx, r_idx) int64 numpy pairs of an equi-join, in left-scan
    order with ties in right-scan order: kernels.join_match_pairs within
    the headroom (sharded over `mesh`'s shards), the out-of-core routes
    above it. The keys come as host planes or as `device_keys` = (lkey,
    lvalid, rkey, rvalid) on the join's device (the host planes are then
    not read and may be None). `mesh` lies on the join's device (or is
    None); `device` None is the mesh's device, else the card."""
    import torch

    from tidb_tpu_torch.ops import kernels
    from tidb_tpu_torch.ops.client import resolve_device
    if device_keys is not None:
        device = device_keys[1].device
        n_left, n_right = (int(t.shape[0]) for t in device_keys[1::2])
    else:
        n_left, n_right = len(lkey), len(rkey)
    device = resolve_device(mesh.device if device is None and mesh
                            is not None else device)
    budget = budget_bytes()
    build_bytes = build_bytes_estimate(n_right)
    if budget <= 0 or n_right == 0 or build_bytes <= headroom():
        with reserve(join_bytes_estimate(n_left, n_right), "join"):
            return kernels.join_match_pairs(
                lkey, lvalid, rkey, rvalid, stats=stats,
                device_keys=device_keys, device=device,
                shards=1 if mesh is None else mesh.n)
    if stats is not None:
        stats["partitioned"] = True
    if device_keys is None:
        with kernels.phase("h2d", device):
            device_keys = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (lkey, lvalid, rkey, rvalid))
    if mesh is not None and mesh.n > 1 and n_left >= mesh.n:
        from tidb_tpu_torch.ops import mesh as mesh_mod
        # the mesh's shards share one device, so the whole working set is
        # charged (the reference, one shard a device, charges a 1/S share)
        with reserve(join_bytes_estimate(n_left, n_right)
                     + (n_left + n_right) * LAYOUT_ROW_BYTES, "join_mesh"):
            return mesh_mod.join_probe_partitioned(mesh, device_keys,
                                                   join_stats=stats)
    return _partitioned_passes(device_keys,
                               _initial_partitions(build_bytes, budget),
                               stats, device)


def _radix_layout(kernels, key, valid, rows, parts: int) -> tuple:
    """K21 over a side's rows (`rows` a device index, None for all):
    (sel, the rows partition-major as a device index; the same on the
    host; offsets, host int64[parts + 1]; the valid rows of each
    partition, host int64[parts])."""
    if rows is not None:
        key, valid = key.index_select(0, rows), valid.index_select(0, rows)
    sel, offsets = kernels.key_partition(key, valid, parts)
    if rows is not None:
        sel = rows.index_select(0, sel)
    offsets = offsets.cpu().numpy()
    n_valid = np.diff(offsets)
    # K21 puts every invalid row in partition 0
    n_valid[0] -= int((~valid).sum())
    return sel, sel.cpu().numpy(), offsets, n_valid


def _pass_pairs(kernels, keys, l_loc, r_loc, l_host, r_host,
                device) -> tuple:
    """One pass: kernels.join_match_pairs over the rows l_loc x r_loc
    (device indices; l_host / r_host the same on the host), the pairs as
    global rows. The card running out of memory anywhere in the pass
    raises DeviceOOM."""
    import torch
    lk, lv, rk, rv = keys
    with reserve(join_bytes_estimate(len(l_loc), len(r_loc)), "join_pass"):
        try:
            with kernels.phase("pass_gather", device):
                sub = (lk.index_select(0, l_loc), lv.index_select(0, l_loc),
                       rk.index_select(0, r_loc), rv.index_select(0, r_loc))
            li, ri = kernels.join_match_pairs(None, None, None, None,
                                              device_keys=sub, device=device)
        except torch.cuda.OutOfMemoryError as e:
            raise kernels.device_oom("join pass", e) from e
    # a NULL probe row rides partition 0 but never matches, so ri indexes
    # real build rows
    return l_host[li], r_host[ri]


def _partitioned_passes(keys: tuple, parts: int, stats: dict | None,
                        device) -> tuple:
    """Grace-hash passes on one device over the key planes `keys` on it:
    K21 lays both sides out partition-major by key radix (P partitions),
    one kernels.join_match_pairs a partition over its rows (index_select
    on the device), the pairs merged back stably by global left row. Equal
    keys share a partition at every P and a partition's right rows keep
    right-scan order, so the merge is the single-pass emission order.

    Completed partitions keep their pairs (checkpoints): a DeviceOOM in a
    pass leaves its rows unfinished, the round goes on, and the next round
    lays out only the unfinished rows at 2P. A partition still over the
    pass target after an escalation because one key owns it runs as
    salted probe chunks x contiguous build blocks. More than
    MAX_ESCALATIONS rounds with a fault, or P past MAX_PARTITIONS, raise
    the fault; any other DeviceError raises at once."""
    import torch

    from tidb_tpu_torch.ops import kernels
    lk, lv, rk, rv = keys
    budget = budget_bytes()
    target = max(headroom(), budget // 8, 1)
    escalations = passes = salted = 0
    l_done = torch.zeros_like(lv)
    r_done = torch.zeros_like(rv)
    l_out, r_out = [], []
    # each side's partition-major gather index lives across the passes
    with reserve((lv.shape[0] + rv.shape[0]) * PARTITION_ROW_BYTES,
                 "join_layout"):
        while True:
            l_rows = r_rows = None
            if escalations:
                l_rows = torch.nonzero(~l_done).squeeze(1)
                r_rows = torch.nonzero(~r_done).squeeze(1)
            try:
                with kernels.phase("k21", device):
                    l_sel, l_selh, l_off, l_nv = _radix_layout(
                        kernels, lk, lv, l_rows, parts)
                    r_sel, r_selh, r_off, r_nv = _radix_layout(
                        kernels, rk, rv, r_rows, parts)
            except torch.cuda.OutOfMemoryError as e:
                raise kernels.device_oom("join partitioning", e) from e
            fault = None
            for p in range(parts):
                la, lb, ra, rb = l_off[p], l_off[p + 1], r_off[p], r_off[p + 1]
                if la == lb and ra == rb:
                    continue
                l_loc, r_loc = l_sel[la:lb], r_sel[ra:rb]
                # a pass that provably has no pairs (no valid probe key or
                # no valid build row) is skipped
                if not l_nv[p] or not r_nv[p]:
                    l_done[l_loc] = True
                    r_done[r_loc] = True
                    continue
                pass_bytes = join_bytes_estimate(lb - la, rb - ra)
                try:
                    if escalations and pass_bytes > target \
                            and _single_key(lk, lv, l_loc) \
                            and _single_key(rk, rv, r_loc):
                        # one key owns the partition: radix cannot split it
                        lp, rp, n_sub = _salted_join_pass(
                            kernels, keys, l_loc, r_loc, l_selh[la:lb],
                            r_selh[ra:rb], pass_bytes, target, escalations,
                            device)
                        salted += 1
                        passes += n_sub
                    else:
                        li, ri = _pass_pairs(kernels, keys, l_loc, r_loc,
                                             l_selh[la:lb], r_selh[ra:rb],
                                             device)
                        lp, rp = [li], [ri]
                        passes += 1
                except errors.DeviceOOM as e:
                    fault = e
                    continue
                l_out.extend(lp)
                r_out.extend(rp)
                l_done[l_loc] = True
                r_done[r_loc] = True
            if fault is None:
                break
            escalations += 1
            if escalations > MAX_ESCALATIONS or parts * 2 > MAX_PARTITIONS:
                raise fault
            parts *= 2
    if l_out:
        with kernels.phase("host_merge", device):
            l_all = np.concatenate(l_out)
            r_all = np.concatenate(r_out)
            # each left row's pairs come from one pass, in right-scan order
            perm = np.argsort(l_all, kind="stable")
            l_all, r_all = l_all[perm], r_all[perm]
    else:
        l_all = np.zeros(0, np.int64)
        r_all = np.zeros(0, np.int64)
    if stats is not None:
        stats["passes"] = passes
        stats["partitions"] = parts
        stats["partition_escalations"] = escalations
        stats["salted_splits"] = salted
        stats["n_pairs"] = len(l_all)
    return l_all, r_all


def _single_key(key, valid, loc) -> bool:
    """Whether the rows' valid keys hold at most one distinct value: the
    case radix escalation cannot shrink."""
    import torch
    v = key.index_select(0, loc)[valid.index_select(0, loc)]
    if v.shape[0] < 2:
        return True
    if v.dtype == torch.float64:
        v = torch.where(v == 0.0, torch.zeros_like(v), v)
    return bool((v == v[0]).all())


def _salted_join_pass(kernels, keys, l_loc, r_loc, l_host, r_host,
                      pass_bytes: int, target: int, escalations: int,
                      device) -> tuple:
    """One hot-key partition as a grid of passes: probe rows split by a
    salted splitmix64 of their position (K21 over the positions; the salt
    decorrelates it from the key radix that failed to split them), build
    rows by contiguous blocks. Each probe row lives in one chunk and meets
    the build blocks in ascending right-scan order, so the caller's stable
    merge gives the single-pass order. Returns (l pair chunks, r pair
    chunks, passes)."""
    import torch
    _lk, lv, _rk, rv = keys
    build_b = build_bytes_estimate(len(r_loc))
    probe_b = max(pass_bytes - build_b, 0)
    boost = 1 << min(escalations, 4)
    bc = pc = 1
    if build_b > target:
        bc = min(MAX_SALTED_CHUNKS, max(2, -(-build_b // target)) * boost)
    if probe_b > target:
        pc = min(MAX_SALTED_CHUNKS, max(2, -(-probe_b // target)) * boost)
    if bc == 1 and pc == 1:
        pc = 2
    csel, coff = kernels.key_partition(
        torch.bitwise_xor(l_loc, 0x5D4),
        torch.ones(len(l_loc), dtype=torch.bool, device=l_loc.device), pc)
    cselh, coff = csel.cpu().numpy(), coff.cpu().numpy()
    bbounds = np.linspace(0, len(r_loc), bc + 1).astype(np.int64)
    lp, rp = [], []
    n_sub = 0
    for c in range(pc):
        lc = l_loc.index_select(0, csel[coff[c]:coff[c + 1]])
        if not len(lc) or not bool(lv.index_select(0, lc).any()):
            continue
        lch = l_host[cselh[coff[c]:coff[c + 1]]]
        for b in range(bc):
            rc = r_loc[bbounds[b]:bbounds[b + 1]]
            if not len(rc) or not bool(rv.index_select(0, rc).any()):
                continue
            li, ri = _pass_pairs(kernels, keys, lc, rc, lch,
                                 r_host[bbounds[b]:bbounds[b + 1]], device)
            n_sub += 1
            lp.append(li)
            rp.append(ri)
    return lp, rp, n_sub
