"""The mesh execution tier on one card (the port of tidb_tpu/ops/mesh.py:
set_enabled / set_mesh / get_mesh :68-108, _mix64 :115, RegionPlacement
:124-173, publish_shard_balance :176, placement_for :200, _identity :196,
_shard_layout :209, combine_rows_sharded :327-432 with _sharded_combine_fn
:290, combine_states_sharded :435-512 with _monoid_collective_fn :241,
region_states_sharded :572-700 with _states_local_fn :527; the sharded
join probe of :913-962 with _sharded_probe_fn :708 and
_shard_block_totals :736 is kernels.join_match_pairs(..., shards=S)).

- `RegionPlacement`: a stable region → shard map, a pure splitmix64 hash
  of the region id, so a region never moves when its neighbours split or
  merge; an epoch bump re-places it (counted) onto the same shard. The
  port keeps the reference's placements exactly: they decide which
  regions share a shard.
- `combine_states_sharded`: [R, G] partial states placed onto shards
  ([S, Rmax, G] blocks padded with the monoid identity), each shard's
  block reduced, the shards folded: on one card one K7 launch over the
  S * Rmax rows in shard-major order (kernels.mesh_allreduce).
- `region_states_sharded`: every region's grouped states on its home
  shard: rows placed shard-major, group ids offset into the statement's
  global segment space, one K6 launch over the shard layout (S spans of
  lmax rows, sp_total segments each); region r's states are read from
  its home shard's block. No collective.
- the sharded join probe (kernels.join_match_pairs with shards = S,
  driven by executor.HashJoinExec): the build side replicated (one K11),
  the probe rows cut into S contiguous blocks (one K12 over them);
  per-shard pair totals from K12's count pass (published here as the
  shard balance), the pairs in global left-scan order.

At one shard there is no layout to build and no collective to run: the
two state routes are then the single-device kernels
(kernels.combine_region_partials, kernels.region_agg_states_batched),
the same bits at the same cost, as CoprMesh.run calls an aggregate fn as
it is at one shard. The reference builds its layout at one shard too.

The mesh is S virtual shards on one device (parallel.CoprMesh). The
process mesh (`get_mesh`) is built lazily over the visible CUDA card;
where there is none it is None, and a CPU mesh exists only through
`set_mesh`. The reference degrades a faulted mesh rung to the next rung;
the port raises DeviceError (it has no lower rung to hide a fault in).

- `join_probe_partitioned` (:792-911 with _partitioned_probe_fn :756):
  the key-partitioned probe of the out-of-core joins (membudget.
  join_match_pairs over the headroom on a mesh of S > 1 shards). Shard s
  owns key partition s of both sides: K21 lays each side out
  partition-major on the card (no padded blocks), K11 builds every
  partition's sorted words (no replicated build side), the segmented K12
  probes each row against its own partition only, with per-partition pair
  totals from the count pass (no out_cap, no retry), and K17 merges the
  pairs stably by global left row.

- `combine_rows_sharded` (:327-432 with _sharded_combine_fn :290): the
  region combine of a fusion over a multi-region join or scan
  (executor.fused_agg): each region's result rows on their home shard,
  the rows' group ids, values and contrib masks taken by the layout on
  the host and uploaded, K6 over the S spans of lmax rows with G + 1
  segments each (the sink G takes the padding), and K7's shard fold
  (psum / pmin / pmax); at one shard the single-device rung
  (kernels.rows_states: one K6 span, no fold).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tidb_tpu_torch import errors
from tidb_tpu_torch.ops import kernels

# process-wide switch (the reference's SET GLOBAL tidb_tpu_mesh)
_enabled = True
_lock = threading.Lock()
_mesh = None              # the process CoprMesh
_placements: dict = {}    # id(mesh) -> RegionPlacement

# dispatches / shard_rows_*: the last shard layout's balance (skew =
# max / mean); near_data_*: region_states_sharded's launches, regions and
# rows; sharded_probes: the join probes sharded over more than one shard;
# partitioned_probes: the key-partitioned probes
stats = {"dispatches": 0, "shard_rows_max": 0, "shard_rows_mean": 0.0,
         "shard_skew": 0.0, "near_data_dispatches": 0,
         "near_data_regions": 0, "near_data_rows": 0, "sharded_probes": 0,
         "partitioned_probes": 0}


def set_enabled(enabled: bool) -> None:
    global _enabled
    _enabled = bool(enabled)


def set_mesh(mesh) -> None:
    """Install an explicit CoprMesh as the process mesh (tests: a CPU
    mesh; the smoke: 8 shards on the card). None resets to the lazy
    default."""
    global _mesh
    with _lock:
        _mesh = mesh


def get_mesh():
    """The process CoprMesh: one shard per visible card (one on this
    rig), or None when the tier is off or there is no CUDA. A mesh over
    more than one card waits for NCCL (parallel.CoprMesh raises), so on
    such a rig the default mesh is the current card alone."""
    global _mesh
    if not _enabled:
        return None
    if _mesh is None and torch.cuda.is_available():
        from tidb_tpu_torch.parallel import CoprMesh
        with _lock:
            if _mesh is None:
                _mesh = CoprMesh([kernels._device("cuda")])
    return _mesh


def on_device(mesh, device) -> bool:
    """Whether a statement on `device` may ride `mesh`: the mesh's
    shards lie on that device."""
    return mesh is not None and mesh.device == kernels._device(device)


# ---------------------------------------------------------------------------
# region → shard placement
# ---------------------------------------------------------------------------

def _mix64(x: int) -> int:
    """splitmix64 finalizer: sequential region ids spread uniformly over
    the shards."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class RegionPlacement:
    """Region → shard over an n-shard mesh: the shard is _mix64(region id)
    % n, so a surviving region never moves when its neighbours split or
    merge; a new epoch (the region's version tuple) re-places it, counted
    in stats["replacements"], onto the same shard."""

    def __init__(self, n_shards: int):
        self.n_shards = max(1, int(n_shards))
        self._assigned: dict[int, tuple[int, object]] = {}
        self._lock = threading.Lock()
        self.stats = {"placements": 0, "replacements": 0}

    def place(self, region_id: int, epoch=None) -> int:
        rid = int(region_id)
        with self._lock:
            ent = self._assigned.get(rid)
            if ent is not None and (epoch is None or ent[1] == epoch):
                return ent[0]
            shard = _mix64(rid) % self.n_shards
            self.stats["replacements" if ent is not None
                       else "placements"] += 1
            self._assigned[rid] = (shard, epoch)
            if len(self._assigned) > 4096:
                self._assigned.pop(next(iter(self._assigned)))
            return shard

    def shard_of(self, region_ids, epochs=None) -> list[int]:
        epochs = epochs or [None] * len(region_ids)
        return [self.place(rid, ep) for rid, ep in zip(region_ids, epochs)]


def publish_shard_balance(rows_per_shard) -> None:
    """The per-shard row balance of a shard layout into `stats`: max,
    mean and skew = max / mean (1.0 balanced)."""
    counts = [int(c) for c in rows_per_shard]
    if not counts:
        return
    mx = max(counts)
    mean = sum(counts) / len(counts)
    stats["dispatches"] += 1
    stats["shard_rows_max"] = mx
    stats["shard_rows_mean"] = round(mean, 3)
    stats["shard_skew"] = round(mx / mean, 3) if mean > 0 else 0.0


def placement_for(mesh) -> RegionPlacement:
    """The process placement for a mesh (one per mesh instance)."""
    with _lock:
        pl = _placements.get(id(mesh))
        if pl is None or pl.n_shards != mesh.n:
            pl = _placements[id(mesh)] = RegionPlacement(mesh.n)
        return pl


def placement_keys(region_ids, n: int) -> list:
    """Placement keys: the region ids, positional (-(i + 1)) where a
    partial carries none."""
    if region_ids is None:
        return list(range(n))
    return [rid if rid is not None else -(i + 1)
            for i, rid in enumerate(region_ids)]


# ---------------------------------------------------------------------------
# the shard layout
# ---------------------------------------------------------------------------

def _identity(op: str, dtype):
    """The monoid identity that pads a shard's block: 0 for sums, +-inf
    for f64 extrema (where the reference pads with +-F64_MAX, which beats
    a real +-inf), and the exact int64 extremes (a max over a region whose
    value is -2^63 must not round to the identity; empty groups are NULL
    by their counts, never by comparison with it)."""
    if op == "sum":
        return 0
    if np.dtype(dtype) == np.float64:
        return np.inf if op == "min" else -np.inf
    return kernels.I64_MAX if op == "min" else kernels.I64_MIN


def _shard_blocks(slices, shard_of, n_shards: int):
    """Where each region's row segment [s, e) lands on its home shard:
    ([(s, e, dst)], rows_per_shard, lmax). Each shard's regions follow
    one another in region order from dst = shard * lmax; lmax is a power
    of two of at least 1024."""
    fill = [0] * n_shards
    placed = []
    for (s, e), sh in zip(slices, shard_of):
        placed.append((s, e, sh, fill[sh]))
        fill[sh] += e - s
    lmax = kernels.bucket_segments(max(max(fill), 1), minimum=1024)
    return ([(s, e, sh * lmax + at) for s, e, sh, at in placed], fill,
            lmax)


def _shard_layout(slices, shard_of, n_shards: int):
    """Row permutation placing each region's row segment [s, e) on its
    home shard: (idx int64[S * lmax] gather index, live bool[S * lmax],
    rows_per_shard). Padding rows gather row 0 under live False."""
    blocks, per_shard, lmax = _shard_blocks(slices, shard_of, n_shards)
    idx = np.zeros(n_shards * lmax, dtype=np.int64)
    live = np.zeros(n_shards * lmax, dtype=bool)
    for s, e, dst in blocks:
        idx[dst:dst + e - s] = np.arange(s, e, dtype=np.int64)
        live[dst:dst + e - s] = True
    return idx, live, per_shard


def _place(a: np.ndarray, blocks: list, size: int, fill) -> np.ndarray:
    """`a`'s row segments copied to their places in a [size] plane of
    `fill`: the shard layout by block copies, not a row gather."""
    out = np.full(size, fill, dtype=a.dtype)
    for s, e, dst in blocks:
        out[dst:dst + e - s] = a[s:e]
    return out


# ---------------------------------------------------------------------------
# sharded combine of [R, G] states
# ---------------------------------------------------------------------------

def combine_states_sharded(states, ops, mesh, shard_of=None) -> list:
    """Merge per-region [R, G] partial states over the mesh: regions place
    onto shards ([S, Rmax, G] blocks padded with the monoid identity),
    each shard reduces its block and the shards fold, in one K7 launch
    over the S * Rmax rows in shard-major order on the mesh's device.
    Equal to the single-device combine for integer sums (wrapping) and
    extrema. Returns one [G] numpy array per state."""
    if mesh.n == 1:
        return kernels.combine_region_partials(states, ops, mesh.device)
    R = int(np.asarray(states[0]).shape[0])
    if shard_of is None:
        shard_of = placement_for(mesh).shard_of(list(range(R)))
    S = mesh.n
    counts = [0] * S
    for sh in shard_of:
        counts[sh] += 1
    rmax = max(max(counts), 1)
    # the rows of every state in shard-major order, padding rows last in
    # their shard's block
    row_of = np.full(S * rmax, -1, dtype=np.int64)
    fill = [0] * S
    for r, sh in enumerate(shard_of):
        row_of[sh * rmax + fill[sh]] = r
        fill[sh] += 1
    pad = row_of < 0
    blocks, codes, is_f = [], [], []
    for st, op in zip(states, ops):
        st = np.asarray(st)
        G = st.shape[1] if st.ndim > 1 else 1
        st = st.reshape(R, G)
        out = st[np.where(pad, 0, row_of)]
        out[pad] = _identity(op, st.dtype)
        f = st.dtype == np.float64
        blocks.append(np.ascontiguousarray(out).view(np.int64))
        codes.append(kernels._COMBINE_CODE[(op, bool(f))])
        is_f.append(f)
    try:
        dev = mesh.device
        with kernels.phase("h2d", dev):
            parts = [torch.from_numpy(b).to(dev) for b in blocks]
        folded = kernels.mesh_allreduce(parts, codes)
    except RuntimeError as e:
        raise errors.DeviceError(f"sharded state combine failed: {e}") \
            from e
    return [np.atleast_1d(a.view(np.float64) if f else a)
            for a, f in zip(folded, is_f)]


# ---------------------------------------------------------------------------
# the region combine of a fusion: result rows on their home shards, [G]
# states per shard, the shards folded (row 15f)
# ---------------------------------------------------------------------------

def _rows_layout(mesh, specs: list, gid, G: int, slices: list, region_ids,
                 epochs) -> tuple:
    """combine_rows_sharded's host half: each region's rows placed on its
    home shard, the group ids, values and contrib masks copied there
    block by block on the host (the reference's inputs are host planes,
    :365-376): (gid_sh, specs_sh, caps, n_rows). Padding rows take the
    sink segment G and never contribute. Over more than one shard."""
    S = mesh.n
    dev = mesh.device
    shard_of = placement_for(mesh).shard_of(
        placement_keys(region_ids, len(slices)), epochs)
    blocks, per_shard, lmax = _shard_blocks(slices, shard_of, S)
    publish_shard_balance(per_shard)
    size = S * lmax
    with kernels.phase("host_shard_layout", dev):
        gid_sh = _place(np.asarray(gid, np.int64), blocks, size, G)
        specs_sh = [(op, None if v is None else _place(np.asarray(v),
                                                       blocks, size, 0),
                     _place(np.asarray(ok, bool), blocks, size, False))
                    for op, v, ok in specs]
    return gid_sh, specs_sh, [lmax] * S, per_shard


def combine_rows_sharded(mesh, specs: list, gid, G: int, slices: list,
                         region_ids=None, epochs=None,
                         plain: bool = False) -> list:
    """Combine one fusion's per-region partial aggregates over the mesh
    (row 15f, the reference's :327 combine_rows_sharded with :290
    _sharded_combine_fn). `specs` is [(op "sum" / "min" / "max", values
    host int64 / f64 row plane or None for a count, contrib host bool)],
    `gid` the host-unified global group id of every row, `slices` each
    region's [start, end) rows, `region_ids` / `epochs` the placement key
    of each (positional where a region has none).

    Every region's rows go to their home shard (RegionPlacement, the
    shard layout), each shard reduces its rows into [G] states, K6 over
    S spans of lmax rows with G + 1 segments each (the sink G takes the
    padding), and K7's shard fold (kernels.mesh_allreduce) merges them:
    psum for counts and sums, pmin / pmax for extrema. At one shard it is
    one K6 span and no fold. `plain` runs the plain versions
    (seg_states_ragged_plain, combine_partials_plain) on the mesh's
    device instead. Returns one [G] numpy array per spec. A fault raises
    DeviceError, where the reference's caller degrades."""
    dev = mesh.device
    if mesh.n == 1:
        publish_shard_balance([len(gid)])
        return kernels.rows_states(specs, gid, G, dev, plain=plain)
    gid_sh, specs_sh, caps, n_rows = _rows_layout(mesh, specs, gid, G,
                                                  slices, region_ids, epochs)
    try:
        with kernels.phase("h2d", dev):
            k6 = kernels.row_spans_inputs(gid_sh, specs_sh, caps, dev)
        out = kernels.span_states_fold(
            k6[0], caps, n_rows, G, k6[1], k6[2], k6[3],
            kernels.mesh_allreduce, plain=plain)
    except RuntimeError as e:
        raise errors.DeviceError(f"sharded row combine failed: {e}") from e
    return out


# ---------------------------------------------------------------------------
# near-data region states: each region's states on its home shard, one K6
# launch over the shard layout, no collective
# ---------------------------------------------------------------------------

def _states_local(n_rows: list, sp_total: int, reds: list):
    """The per-shard states function (the counterpart of the reference's
    _states_local_fn): K6 with each shard as one span of lmax rows and
    sp_total segments. planes = (gid int64[S * lmax], contribs [per
    reduction bool[S * lmax]], values [per reduction: values plane
    [S * lmax] or None])."""

    def local(planes, live, shards: int):
        gid, contribs, values = planes
        lmax = live.shape[0] // shards
        per_shard = [[kernels.StatesInput(
            op, None, None if v is None else v[s * lmax:(s + 1) * lmax])
            for op, v in zip(reds, values)] for s in range(shards)]
        return kernels.seg_states_ragged(
            gid, [lmax] * shards, n_rows, [sp_total - 1] * shards,
            per_shard, contribs)

    return local


def region_states_sharded(mesh, segs: list, region_ids=None,
                          epochs=None) -> list:
    """Every region's grouped partial states of one statement, each
    computed on the region's home shard in one K6 launch.

    segs[r] = (gid_r, specs_r, G_r, n_rows_r), as
    kernels.region_agg_states_batched takes them: the region's group ids
    (int64[cap_r], sink G_r) and reductions (op in sum / min / max, values
    None (a count) or a values plane on the mesh's device, contrib host
    bool[cap_r]); every region has the same reductions. Rows place
    shard-major by RegionPlacement; group ids offset into the statement's
    segment space (sum(G_r + 1) + 1, bucketed to a power of two of at
    least 64, its last segment the padding sink). At one shard it is the
    batched K6 itself. Returns outs[r]: one [G_r] numpy array per
    reduction, bit-identical to the single-device batched K6."""
    R = len(segs)
    dev = mesh.device
    stats["near_data_dispatches"] += 1
    stats["near_data_regions"] += R
    stats["near_data_rows"] += sum(len(s[0]) for s in segs)
    if mesh.n == 1:
        return kernels.region_agg_states_batched(segs, dev)
    Gs = [int(s[2]) for s in segs]
    offs, off = [], 0
    for g in Gs:
        offs.append(off)
        off += g + 1
    sp_total = kernels.bucket_segments(off + 1, minimum=64)
    shard_of = placement_for(mesh).shard_of(placement_keys(region_ids, R),
                                            epochs)
    slices, s0 = [], 0
    for gid_r, *_rest in segs:
        slices.append((s0, s0 + len(gid_r)))
        s0 += len(gid_r)
    idx, live, per_shard = _shard_layout(slices, shard_of, mesh.n)
    publish_shard_balance(per_shard)
    with kernels.phase("host_shard_layout", dev):
        gid_glob = np.concatenate([np.asarray(gid_r, np.int64) + offs[r]
                                   for r, (gid_r, *_rest)
                                   in enumerate(segs)])
        gid_sh = np.where(live, gid_glob[idx], sp_total - 1)
        contrib_sh = [np.concatenate([np.asarray(sp[j][2], bool)
                                      for _g, sp, *_r in segs])[idx] & live
                      for j in range(len(segs[0][1]))]
    try:
        with kernels.phase("h2d", dev):
            idx_d = torch.from_numpy(idx).to(dev)
            planes = (torch.from_numpy(gid_sh).to(dev),
                      [torch.from_numpy(c).to(dev) for c in contrib_sh], [])
            reds = []
            for j, (op, v0, _ok) in enumerate(segs[0][1]):
                si = kernels._states_input(op, v0, None)
                reds.append(si.op)
                planes[2].append(None if si.values is None else torch.cat(
                    [sp[j][1] for _g, sp, *_r in segs]).index_select(0, idx_d))
            live_d = torch.from_numpy(live).to(dev)
        local = _states_local(per_shard, sp_total, reds)
        with kernels.phase("k6", dev):
            out = mesh.run_sharded(local, planes, live_d)
        with kernels.phase("states_readback", dev):
            host = out.cpu().numpy()
    except RuntimeError as e:
        raise errors.DeviceError(f"mesh near-data states failed: {e}") \
            from e
    res = []
    for r in range(R):
        base = shard_of[r] * sp_total + offs[r]
        res.append([(host[j, base:base + Gs[r]].view(np.float64)
                     if op in kernels.F_OPS else host[j, base:base + Gs[r]])
                    .copy() for j, op in enumerate(reds)])
    return res


# ---------------------------------------------------------------------------
# the key-partitioned join probe: shard s owns key partition s of both sides
# ---------------------------------------------------------------------------

def join_probe_partitioned(mesh, device_keys: tuple,
                           join_stats: dict | None = None) -> tuple:
    """(l_idx, r_idx) int64 numpy pairs in left-scan order, ties in
    right-scan order: the pairs of kernels.join_match_pairs, each shard
    building and probing only its own key partition (splitmix64 key radix
    modulo S, membudget.partition_codes). The keys come as `device_keys`
    = (lkey, lvalid, rkey, rvalid) on the mesh's device (the router
    uploads host planes); `join_stats` gets mesh_partitioned,
    mesh_shards, passes and partitions (S each), shard_pairs and n_pairs.
    Any fault raises: a memory fault as DeviceOOM, as the reference's
    typed DeviceError, which its router degrades to the replicated probe
    and the port's does not."""
    S = mesh.n
    dev = mesh.device
    try:
        lk, lv, rk, rv = device_keys
        if lk.dtype != rk.dtype:
            raise errors.DeviceError(f"join keys of {lk.dtype} and "
                                     f"{rk.dtype}")
        with kernels.phase("k21", dev):
            l_sel, l_off = kernels.key_partition(lk, lv, S)
            r_sel, r_off = kernels.key_partition(rk, rv, S)
        with kernels.phase("k11", dev):
            words, rows, bounds = kernels.join_build_partitioned(
                rk.index_select(0, r_sel), rv.index_select(0, r_sel), r_off)
            order = r_sel.index_select(0, rows)
        with kernels.phase("k12", dev):
            pairs, totals = kernels.join_probe_partitioned(
                words, order, bounds, lk.index_select(0, l_sel),
                lv.index_select(0, l_sel), l_off, l_sel)
        n = pairs.shape[1]
        with kernels.phase("k17", dev):
            # each left row's pairs lie in its partition, in right-scan
            # order: a stable sort by left row is the single-pass order
            if n > 1:
                pairs = pairs.index_select(
                    1, kernels.sort_perm([pairs[0]], n))
        with kernels.phase("pairs_readback", dev):
            host = pairs.cpu().numpy()
    except torch.cuda.OutOfMemoryError as e:
        raise kernels.device_oom("key-partitioned probe", e) from e
    publish_shard_balance(totals)
    stats["partitioned_probes"] += 1
    if join_stats is not None:
        join_stats.update(mesh_partitioned=True, mesh_shards=S, passes=S,
                          partitions=S, shard_pairs=totals, n_pairs=n)
    return host[0].astype(np.int64), host[1].astype(np.int64)
