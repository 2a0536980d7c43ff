"""Region-side append-only delta packs over cached base planes: the HTAP
freshness tier (the port of tidb_tpu/copr/delta.py:89-521, without the
metrics, tracing and failpoints, which the port has not yet).

A commit to a table whose regions hold cached base planes appends its row
mutations (inserts and updates as puts, deletes as tombstones by handle)
to a bounded per-(region, table) DeltaPack instead of orphaning the
cache. Every later commit of the table appends too (an empty
version-continuity entry where its rows belong to another region), so a
pack covers every commit between a cached base's version and the present:
`usable` matches the pack's entry commit_ts multiset against the MVCC
store's per-table commit log for exactly the (base_version, read_version]
window, and any gap means re-pack, never a wrong answer.

A scan whose plane-cache lookup misses at the current version but finds
an older base that `usable` accepts merges base planes + delta at scan
time (`merge`): the handle-ordered merge order of the kept base rows and
the appended rows comes from K19 `delta_merge_order` at or above
MERGE_DEVICE_FLOOR base rows, from its plain version on the host below
it, and every plane is gathered once on the host; K19 also writes the
merged handle plane, which stays on the device with its liveness plane,
where the next merge over the merged batch finds them. A K19 fault
raises (the reference degrades to its host plan). When a pack's delta outgrows the row budget,
the scan that merged it folds it: the merged batch becomes the new base
entry and the pack resets.

Counters (`DeltaStore.stats`): merges (version-only merges included),
repacks (folds), drops (packs dropped at their hard cap), appends
(entries that carried rows), decode_reuse (merges that reused the decoded
delta planes of an unchanged pack generation).
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from tidb_tpu_torch import errors, tablecodec as tc
from tidb_tpu_torch.ops import columnar as col, kernels
from tidb_tpu_torch.types.datum import NULL

I64_MAX = (1 << 63) - 1

# the reference's default of its GLOBAL sysvar tidb_tpu_delta_budget_rows
# (tidb_tpu/sessionctx): a pack past this many rows folds on the next scan
DEFAULT_BUDGET_ROWS = 4096

# a pack whose delta outgrows this multiple of the budget is dropped
# outright (the scan that would have folded it never came: re-packing is
# cheaper than carrying an unbounded log)
HARD_CAP_FACTOR = 4

# entry-count budget, independent of the row budget: version-continuity
# entries carry no rows but still cost a walk per merge. Past it the next
# scan folds the pack, and past 4x the pack drops
ENTRY_BUDGET = 1024

# base rows below which K19's plain version runs on the host instead
MERGE_DEVICE_FLOOR = 4096


class DeltaPack:
    """Append-only delta of one (region, table): the commits that landed
    since some cached base plane was packed. entries keep append (=
    application) order; rows are (handle, row value | None), None being
    the delete tombstone."""

    __slots__ = ("entries", "rows", "ts_counts", "gen")

    def __init__(self):
        self.entries: list[tuple[int, list]] = []   # (commit_ts, rows)
        self.rows = 0
        self.ts_counts: Counter = Counter()         # commit_ts → entries
        self.gen = 0        # bumps per append: the decoded planes' key

    def append(self, commit_ts: int, rows: list) -> None:
        self.entries.append((commit_ts, rows))
        self.ts_counts[commit_ts] += 1
        self.rows += len(rows)
        self.gen += 1


class DeltaStore:
    """Per-store registry of delta packs, fed from the commit path
    (cluster/rpc.py kv_commit) and drained by the region columnar engine
    (copr/columnar_region). Thread-safe; never takes the plane-cache lock
    while holding its own."""

    def __init__(self, cache):
        self.cache = cache                     # copr.plane_cache.PlaneCache
        self.enabled = True
        self.budget_rows = DEFAULT_BUDGET_ROWS
        self._lock = threading.Lock()
        self._packs: dict[tuple[int, int], DeltaPack] = {}
        # decoded delta planes: (plane-cache base key, pack gen, window)
        # → (tombstones, appended handles, values, valid flags)
        self._decoded: dict[tuple, tuple] = {}
        self.stats = {"merges": 0, "repacks": 0, "drops": 0, "appends": 0,
                      "decode_reuse": 0}

    def __len__(self) -> int:
        return len(self._packs)

    def pack_rows(self, region_id: int, table_id: int) -> int:
        with self._lock:
            pack = self._packs.get((region_id, table_id))
            return pack.rows if pack is not None else 0

    def set_enabled(self, on: bool) -> None:
        """The kill switch: off drops every pack, and scans re-pack."""
        self.enabled = on
        if not on:
            with self._lock:
                self._packs.clear()
                self._decoded.clear()

    # ---- commit side ----

    def on_commit(self, region, keys: list, applied: list,
                  commit_ts: int) -> None:
        """One region's share of a commit just applied to the MVCC store.
        `keys` are ALL committed keys of this call (they drove the version
        bump), `applied` the data mutations actually written. Appends the
        row mutations to this region's packs and version-continuity
        entries to sibling regions' packs of the same tables; anything
        unprovable drops the affected packs instead of guessing."""
        if not self.enabled:
            return
        if not self._packs and not self.cache._base_tables:
            # no cached planes anywhere: nothing to keep fresh
            return
        touched: set[int] = set()
        for k in keys:
            if tc.table_prefix_of(k) != tc.META_BUCKET:
                try:
                    touched.add(tc.decode_table_id(k))
                except ValueError:
                    pass
        if not touched:
            return
        by_table: dict[int, list] = {}
        bad_tables: set[int] = set()
        for key, value in applied:
            if key[:1] != b"t" or key[10:12] != tc.ROW_PREFIX_SEP:
                continue        # index / meta keys: base planes unaffected
            try:
                tid, handle = tc.decode_row_key(key)
            except ValueError:
                continue
            if not region.contains(key) or handle == I64_MAX:
                # a row outside the committing region, or the merge's
                # sentinel handle: nothing sound to append
                bad_tables.add(tid)
                continue
            by_table.setdefault(tid, []).append((handle, value))
        # regions holding live cached bases, read BEFORE the delta lock:
        # the scan path nests cache lock → delta lock (lookup_with_base's
        # base_ok), so taking the cache lock while holding ours would
        # deadlock
        live_by_table = {tid: set(self.cache.regions_with_table(tid))
                         for tid in touched}
        with self._lock:
            for tid in touched:
                live_regions = set(live_by_table[tid])
                live_regions.update(
                    rid for (rid, t) in self._packs if t == tid)
                if tid in bad_tables:
                    for rid in live_regions:
                        self._drop_locked(rid, tid)
                    continue
                for rid in live_regions:
                    pack = self._packs.get((rid, tid))
                    rows = by_table.get(tid, []) \
                        if rid == region.region_id else []
                    if rid not in live_by_table[tid]:
                        # no cached base left to merge over: the pack can
                        # never serve again
                        if pack is not None:
                            self._drop_locked(rid, tid)
                        continue
                    if pack is None:
                        pack = self._packs[(rid, tid)] = DeltaPack()
                    pack.append(commit_ts, rows)
                    if rows:
                        self.stats["appends"] += 1
                    if pack.rows > self.budget_rows * HARD_CAP_FACTOR \
                            or len(pack.entries) > \
                            ENTRY_BUDGET * HARD_CAP_FACTOR:
                        self._drop_locked(rid, tid)
                        self.stats["drops"] += 1

    def _drop_locked(self, region_id: int, table_id: int) -> None:
        self._packs.pop((region_id, table_id), None)
        for k in [k for k in self._decoded
                  if k[0] == region_id and k[1] == table_id]:
            del self._decoded[k]

    def reset(self, region_id: int, table_id: int) -> None:
        """Fold complete: the merged batch became the new base entry and
        the delta restarts empty."""
        with self._lock:
            self._drop_locked(region_id, table_id)

    # ---- scan side ----

    def usable(self, region_id: int, table_id: int, base_version: int,
               version: int, mvcc, prefix: bytes) -> bool:
        """Can a cached base at table version `base_version` serve a
        reader at `version` through this pack? Yes iff the pack holds an
        entry for EVERY table commit in (base_version, version]."""
        if not self.enabled or version <= base_version:
            return False
        with self._lock:
            pack = self._packs.get((region_id, table_id))
            if pack is None:
                return False
            counts = dict(pack.ts_counts)
        need = Counter(mvcc.table_commits_between(prefix, base_version,
                                                  version))
        return all(counts.get(ts, 0) >= n for ts, n in need.items())

    def repack_due(self, region_id: int, table_id: int) -> bool:
        with self._lock:
            pack = self._packs.get((region_id, table_id))
            return pack is not None and \
                (pack.rows > self.budget_rows
                 or len(pack.entries) > ENTRY_BUDGET)

    def merge(self, base, base_version: int, base_key: tuple, version: int,
              mvcc, prefix: bytes, columns, ranges, defaults, device):
        """Base planes + delta → a fresh ColumnBatch equal to what a
        re-pack at `version` would produce, or None (the caller re-packs).
        `base_key` is the plane-cache key (region, table, column
        signature, range bounds)."""
        region_id, table_id = base_key[0], base_key[1]
        need = Counter(mvcc.table_commits_between(prefix, base_version,
                                                  version))
        with self._lock:
            pack = self._packs.get((region_id, table_id))
            if pack is None:
                return None
            gen = pack.gen
            remaining = Counter(need)
            picked: list[list] = []
            for ts, rows in pack.entries:
                if remaining.get(ts, 0) > 0:
                    remaining[ts] -= 1
                    picked.append(rows)
            if any(n > 0 for n in remaining.values()):
                return None     # gap: the pack missed a commit
        # last write wins per handle, in application order
        final: dict[int, bytes | None] = {}
        for rows in picked:
            for handle, value in rows:
                final[handle] = value
        if not final:
            # version-only delta: the base IS the current pack
            self.stats["merges"] += 1
            return base
        dec_key = base_key + (gen, base_version, version)
        with self._lock:
            dec = self._decoded.get(dec_key)
        if dec is not None:
            self.stats["decode_reuse"] += 1
            tomb, app_handles, raw, ok = dec
        else:
            def in_range(k):
                return any(rg.start <= k and (rg.end is None or k < rg.end)
                           for rg in ranges)
            tomb = np.fromiter(sorted(final), dtype=np.int64,
                               count=len(final))
            try:
                with kernels.phase("delta_decode", device):
                    puts = sorted(
                        (h, v) for h, v in final.items() if v is not None
                        and in_range(tc.encode_row_key(table_id, h)))
                    app_handles, raw, ok = _decode_puts(puts, columns,
                                                        defaults)
            except errors.TypeError_:
                return None     # no exact plane mapping: re-pack
            with self._lock:
                self._decoded[dec_key] = (tomb, app_handles, raw, ok)
                while len(self._decoded) > 32:
                    self._decoded.pop(next(iter(self._decoded)))
        try:
            merged = _merge_batch(base, tomb, app_handles, raw, ok, columns,
                                  device)
        except errors.TypeError_:
            return None     # no exact plane mapping: re-pack
        if merged is None:
            return None
        self.stats["merges"] += 1
        return merged


def _decode_puts(puts: list, columns, defaults):
    """Decode the surviving delta rows → (appended handles, raw values per
    column, valid flags per column), by the same datum_to_phys contract
    as the pack path (TypeError_ sends the merge to a re-pack)."""
    k = len(puts)
    app_handles = np.fromiter((h for h, _v in puts), dtype=np.int64,
                              count=k)
    col_kinds = {c.column_id: col.column_phys_kind(c) for c in columns}
    pk_col = next((c for c in columns if c.pk_handle), None)
    raw: dict[int, list] = {c.column_id: [] for c in columns}
    ok: dict[int, list] = {c.column_id: [] for c in columns}
    for h, value in puts:
        row = tc.decode_row(value)
        for c in columns:
            cid = c.column_id
            if pk_col is not None and cid == pk_col.column_id:
                raw[cid].append(h)
                ok[cid].append(True)
                continue
            d = row.get(cid)
            if d is None:
                d = defaults.get(cid, NULL)
            scale = c.decimal if col_kinds[cid] == col.K_DEC \
                and c.decimal and c.decimal > 0 else 0
            v, valid = col.datum_to_phys(d, col_kinds[cid], scale)
            raw[cid].append(v)
            ok[cid].append(valid)
    return app_handles, raw, ok


def _merge_batch(base, tomb: np.ndarray, app_handles: np.ndarray,
                 raw: dict, ok: dict, columns, device):
    """The merged ColumnBatch: the handle-ordered merge order (K19, or its
    plain version on the host below the floor), then every plane gathered
    once on the host. String dictionaries are merged, then cut to the
    strings the merged rows use, as a fresh pack's are."""
    if getattr(base, "max_handle", 0) == I64_MAX:
        return None   # the merge's sentinel handle is in play: re-pack
    cap = base.capacity
    k = len(app_handles)
    col_kinds = {c.column_id: col.column_phys_kind(c) for c in columns}

    order, merged_h = _merge_order(base, tomb, app_handles, device)
    with kernels.phase("merge_gather", device):
        n = len(order)
        cap_new = col.bucket_capacity(n)
        from_base = order < cap
        base_idx = np.where(from_base, order, 0)
        app_idx = np.where(from_base, 0, order - cap)

        handles = np.full(cap_new, col.I64_MIN, dtype=np.int64)
        h_app = np.full(max(k, 1), col.I64_MIN, dtype=np.int64)
        h_app[:k] = app_handles
        handles[:n] = np.where(from_base, base.handles[base_idx],
                               h_app[app_idx])
        cols: dict[int, col.ColumnData] = {}
        for c in columns:
            cid = c.column_id
            kind = col_kinds[cid]
            old = base.columns[cid]
            va = np.zeros(cap_new, dtype=bool)
            okv = np.zeros(max(k, 1), dtype=bool)
            okv[:k] = ok[cid]
            va[:n] = np.where(from_base, old.valid[base_idx], okv[app_idx])
            if kind == col.K_STR:
                cols[cid] = _merge_str(old, raw[cid], ok[cid], from_base,
                                       base_idx, app_idx, va, cap, cap_new,
                                       n, k, c.tp)
                continue
            dtype = np.float64 if kind == col.K_F64 else np.int64
            app_vals = np.zeros(max(k, 1), dtype=dtype)
            if k:
                app_vals[:k] = [x if o else 0
                                for x, o in zip(raw[cid], ok[cid])]
            vals = np.zeros(cap_new, dtype=dtype)
            vals[:n] = np.where(from_base, old.values[base_idx],
                                app_vals[app_idx])
            if kind == col.K_I64:
                col._check_u64_plane(c, vals, va, n)
            scale = c.decimal if kind == col.K_DEC and c.decimal \
                and c.decimal > 0 else 0
            cols[cid] = col.ColumnData(
                kind, vals, va, tp=c.tp, dec_scale=scale,
                max_abs=col._plane_max_abs(vals, n, kind))
        out = col.ColumnBatch(n, cap_new, handles, cols)
        out.max_handle = int(handles[:n].max()) if n else col.I64_MIN
    if merged_h is not None:
        kernels.device_handles(out, device, resident=merged_h)
        kernels.device_live(out, device, resident=torch.arange(
            cap_new, device=merged_h.device) < n)
    return out


def _merge_str(old, raw: list, ok: list, from_base, base_idx, app_idx, va,
               cap: int, cap_new: int, n: int, k: int, tp: int):
    new_vals = [v if o else None for v, o in zip(raw, ok)]
    merged_dict = sorted(set(old.dictionary)
                         | {v for v in new_vals if v is not None})
    code_of = {b: i for i, b in enumerate(merged_dict)}
    base_codes = np.full(cap, -1, dtype=np.int64)
    if old.dictionary:
        remap = np.array([code_of[b] for b in old.dictionary],
                         dtype=np.int64)
        oc = np.clip(old.values, 0, None)
        base_codes = np.where(old.valid, remap[oc], -1)
    app_codes = np.full(max(k, 1), -1, dtype=np.int64)
    app_codes[:k] = [code_of[v] if v is not None else -1 for v in new_vals]
    codes = np.full(cap_new, -1, dtype=np.int64)
    codes[:n] = np.where(from_base, base_codes[base_idx], app_codes[app_idx])
    used = np.zeros(len(merged_dict), dtype=bool)
    used[codes[:n][va[:n]]] = True
    if not used.all():
        # strings only deleted or overwritten rows held
        squeeze = np.cumsum(used) - 1
        merged_dict = [b for b, u in zip(merged_dict, used) if u]
        codes[:n] = np.where(va[:n], squeeze[np.clip(codes[:n], 0, None)],
                             -1)
    return col.ColumnData(col.K_STR, codes, va, merged_dict, tp=tp)


def _merge_order(base, tomb: np.ndarray, app_handles: np.ndarray,
                 device) -> tuple:
    """(the merge order, the merged handle plane on `device` or None).
    Below MERGE_DEVICE_FLOOR base rows K19's plain version runs on the
    host. At or above it K19 (its plain version under device "cpu")
    merges the base's resident handle and liveness planes with the
    delta's: only the tombstones and appended handles move up, and K19
    writes the merged handle plane beside the order (its capacity
    bucketed as the merged batch's, I64_MIN past its rows), which stays
    on the device (with the merged liveness plane) for the merged batch's
    next merge; the order is read back once, into page-locked memory."""
    if base.n_rows < MERGE_DEVICE_FLOOR:
        with kernels.phase("merge_order", device):
            order = kernels.delta_merge_order_plain(
                torch.from_numpy(base.handles),
                torch.from_numpy(base.row_mask()), torch.from_numpy(tomb),
                torch.from_numpy(app_handles))
            return order.numpy(), None
    with kernels.phase("merge_upload", device):
        h = kernels.device_handles(base, device)
        live = kernels.device_live(base, device)
        tomb_d = torch.from_numpy(tomb).to(device)
        app_d = torch.from_numpy(app_handles).to(device)
    with kernels.phase("k19", device):
        # the live rows are the base's first n_rows, so the merge holds at
        # most n_rows + k rows
        merged_h = torch.full((col.bucket_capacity(
            base.n_rows + len(app_handles)),), col.I64_MIN,
            dtype=torch.int64, device=h.device)
        order = kernels.delta_merge_order(h, live, tomb_d, app_d, merged_h)
        cap = col.bucket_capacity(order.shape[0])
        if cap < merged_h.shape[0]:
            merged_h = merged_h[:cap].clone()
        return kernels.to_host(order).numpy(), merged_h
