"""The HBM ledger: a process-wide account of the card's memory (the port
of tidb_tpu/ops/membudget.py:60-410, the ledger part, and of
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

The reference publishes the ledger as metrics gauges; the port, which has
no metrics registry yet, keeps the same figures in `stats`.
"""

from __future__ import annotations

import threading

DEFAULT_BUDGET_SPEC = "auto"

# fraction of the card's memory "auto" budgets to: the CUDA context,
# PyTorch's caching allocator and allocations outside the ledger need the
# rest
AUTO_BUDGET_FRACTION = 0.85

# an out-of-core operator halves its pass target on a memory fault at most
# this many times, then raises
MAX_ESCALATIONS = 4

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
