"""Aggregation/filter kernels over columnar batches (the port of
tidb_tpu/ops/kernels.py: batch_planes :202, device_live :384, AggSpec /
lower_aggregates :399-430, GroupSpec / lower_group_by / lower_tuple_group
:475-575, _orderable_i64 :577, build_scalar_agg_fn :713,
_sorted_boundary_sums :695, _distinct_reduce :807, _grouped_distinct :864,
build_grouped_agg_fn :903, build_ranked_group_fn :989, build_filter_fn
:1970, build_topn_fn :1980, build_topn_fn_multi :2080, for the mesh tier
_combiners :732, build_topn_partial_fn :2005, merge_topn_partials :2029,
build_topn_partial_fn_multi :2048 and the sharded probe of
join_match_pairs :1807, and for the cluster
region path combine_region_partials :1082, region_agg_states :1204,
bucket_segments :1343, region_agg_states_batched :1356,
region_filter_batched :1552, and for the HTAP tier delta_merge_order
:293), and for the micro-batch tier the slot kernels
of tidb_tpu/ops/sched.py (the filter wrapper :1021-1037 of
MicroBatcher._kernel, _build_agg_wrapper :439, _build_topn_wrapper :532).

Every request runs as K1 (`expr_vm`: WHERE mask, aggregate arguments and
group id in one pass) followed, for aggregates, by K2 (`scalar_agg`) or,
grouped, by K3 (`seg_agg_onehot`, S <= ONEHOT_SEGMENTS_MAX) or K4
(`seg_agg_sorted`, above: segment windows in shared memory, or past
`K4_MAX_WINDOWS` windows the segmented pass over ids sorted by the radix
of `radix_sort_t`; `k4_route`). A group-by beyond the radix ceiling is ranked:
a stable lexsort of the group columns, K8 (`rank_groups_rank`: each
sorted position's group rank, once a statement; `rank_groups_out`: group
ids in sorted space and representatives at the rung that holds the
groups) and K4's segmented pass in sorted space.
DISTINCT aggregates sort by (group, contributing first, value), K9
(`distinct_runs`) marks the run openers and K2 or K4's pass totals them.
TopN is K10 (`topk_select`) over K1's mask and key planes. Each wrapper
launches its hand-written CUDA kernel for tensors on the card and runs its
plain PyTorch version for tensors on the CPU; any other case raises.
`LAUNCHES` counts the kernel launches (not the plain runs) per kernel.

A statement over R regions runs K5 (`expr_vm_ragged`: every region's
WHERE and aggregate-argument programs in one launch, bit-packed survivor
masks), K6 (`seg_states_ragged`: every region's grouped states in one
launch, on one of three routes by what a copy of the span costs,
`k6_route`) and, in the final aggregate, K7 (`combine_partials`: the merge
over the region axis). `CALLS` counts the calls of their wrappers, kernel
or plain alike.

Statements of one shape that the micro-batch tier (ops.sched) gathers run
one program over one batch with a constant pool per statement (slot):
K14 (`slot_filter`: every slot's survivor mask, bit-packed), K15
(`slot_agg`: every slot's where-pass count and masked reductions) and K16
(`slot_topn`: every slot's first k rows over K14's masks).

On a mesh of S virtual shards (ops.mesh, parallel.CoprMesh) an aggregate
runs K1, then K3/K4 over segment ids offset by shard (each shard's
partials in its own block) and K7 over the shard axis
(`mesh_allreduce`); a TopN runs K1, then K20 (`shard_topk`: every shard's
first k rows with their order words, in the launches of
`shard_topk_plan`), and the host merges the S * k candidates
(`merge_topn_partials`).

The key-partitioned join probe of a mesh (ops.mesh.join_probe_partitioned)
runs K21 (`key_partition`: each side's stable partition-major gather index
by splitmix64 key radix, and the partition offsets) once per side, K11
over the partition-major build rows sorted within each partition
(`join_build_partitioned`), and K12 in its partition-segmented mode
(`join_probe_partitioned`: each probe row searches its own partition's
build range).

A cluster scan that merges a cached base batch with its region's delta
(copr.delta) runs K19 (`delta_merge_order`: the tombstone mask and the
handle-ordered merge of the kept base rows and the appended rows, a merge
of two sorted runs, no sort).

Outputs keep the reference's layout: a scalar aggregate gives (n,) for
count and (n, value) for the others; a grouped one gives row_count[S]
first, then the same per aggregate as [S] arrays, the last segment being
the dead-row sink.
"""

from __future__ import annotations

import array
import contextlib
import ctypes
import threading
import time
import weakref

import numpy as np
import torch

from tidb_tpu_torch import errors
from tidb_tpu_torch.copr.proto import AGG_NAME, ExprType, SelectRequest
from tidb_tpu_torch.ops import _ext, columnar as col, membudget
from tidb_tpu_torch.ops.exprc import (HDR, MAX_REGS, CompiledExpr,
                                      Finalized, Program, Unsupported,
                                      _dec_guard, compile_expr,
                                      run_program_plain, slot_split)

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)

# One device runs one request's kernels at a time; the reference meters
# this lock into device.busy_us and the profiler, which the port has not
# ported yet.
dispatch_serial = threading.Lock()

# pseudo column id of the global row position (exact first_row). The
# kernels read the position as the row index itself, so no plane moves.
POS_CID = -1

# one-hot route (K3) up to this many segments, sorted route (K4) above
ONEHOT_SEGMENTS_MAX = 64

# radix group-by segment ceiling
RADIX_MAX_SEGMENTS = 1 << 20

# planes-dict keys for host-built group-code planes (group code of column
# c lives at GC_BASE - c)
GC_BASE = -1000

# kernel launches per kernel since the last reset (plain runs not
# counted); K6 counts its three routes apart (k6_route): span copies a
# block in the opt-in shared memory (seg_states_ragged_smem), segment
# windows of larger spans (seg_states_ragged_window), and past the
# windows' cap the segmented pass over radix-sorted ids
# (seg_states_ragged_sorted); K4 its two (k4_route): segment windows in
# the opt-in shared memory (seg_agg_block) and the segmented pass over
# sorted ids (seg_agg_sorted, also the ranked and DISTINCT paths' pass);
# radix_pass one pass of the radix sort K11, K4's and K6's sorted routes
# and K17 run
LAUNCHES = {"expr_vm": 0, "expr_vm_packed": 0, "scalar_agg": 0,
            "seg_agg_onehot": 0,
            "seg_agg_sorted": 0, "rank_groups": 0, "rank_groups_out": 0,
            "distinct_runs": 0,
            "topk_select": 0, "expr_vm_ragged": 0,
            "expr_vm_ragged_packed": 0,
            "seg_states_ragged_smem": 0, "seg_states_ragged_window": 0,
            "seg_states_ragged_sorted": 0, "combine_partials": 0,
            "join_build": 0, "join_probe": 0, "dict_remap": 0,
            "slot_filter": 0, "slot_agg": 0, "slot_topn": 0,
            "sort_perm": 0, "window_scan": 0, "delta_merge_order": 0,
            "shard_topk": 0, "key_partition": 0, "join_probe_seg": 0,
            "seg_agg_block": 0, "radix_pass": 0}

# K14 / K15 take a program's planes from a table of this many entries
# (ops/csrc/vm.cuh VM_ROW_PLANES); K15 folds at most SLOT_MAX_REDS
# reductions per slot (vm.cuh SLOT_MAX_RED)
SLOT_MAX_PLANES = 16
SLOT_MAX_REDS = 9

# calls of the cluster path's statement-level wrappers, kernel or plain;
# mesh_allreduce: the mesh tier's shard fold (K7 over partials already on
# the device), counted apart from the cluster finisher's region combine
CALLS = {"region_filter_batched": 0, "region_agg_states_batched": 0,
         "combine_region_partials": 0, "mesh_allreduce": 0}

# Where a statement's time goes: None (the default) costs nothing; a dict
# (chip_smoke.py sets one) collects milliseconds per phase, each phase
# bracketed by device synchronisations.
SPLIT: dict | None = None


@contextlib.contextmanager
def phase(name: str, device):
    if SPLIT is None:
        yield
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        SPLIT[name] = SPLIT.get(name, 0.0) \
            + (time.perf_counter() - t0) * 1e3

# reduction ops: the contract with ops/csrc/common.cuh
R_COUNT, R_SUM_I, R_SUM_F, R_MIN_I, R_MAX_I, R_MIN_F, R_MAX_F, R_FIRST = \
    range(8)
RED_CONST, RED_NEVER = 1, 2
F_OPS = (R_SUM_F, R_MIN_F, R_MAX_F)


def group_code_key(cid: int) -> int:
    return GC_BASE - cid


# ---------------------------------------------------------------------------
# planes on the device
# ---------------------------------------------------------------------------

def batch_planes(batch: col.ColumnBatch, device: torch.device) -> dict:
    """Host numpy → device tensors, one (values, valid) pair per column,
    memoized on the batch per device: planes stay resident across
    requests."""
    cache = getattr(batch, "_device_planes", None)
    if cache is None:
        cache = batch._device_planes = {}
    key = str(device)
    planes = cache.get(key)
    if planes is None:
        planes = cache[key] = {
            cid: (torch.from_numpy(cd.values).to(device),
                  torch.from_numpy(cd.valid).to(device))
            for cid, cd in batch.columns.items()}
        if torch.device(device).type == "cuda":
            _charge_pinned(batch, membudget.planes_nbytes(planes))
    return planes


def _charge_pinned(batch, nbytes: int) -> None:
    """Charge planes made resident on the card to the HBM ledger
    (ops.membudget `pinned`), uncharged when the batch, and with it the
    planes, dies. The plane cache (copr.plane_cache) and GpuClient's batch
    cache both pin through batch_planes."""
    membudget.pin(nbytes)
    weakref.finalize(batch, membudget.unpin, nbytes)


def device_live(batch: col.ColumnBatch, device: torch.device,
                resident: torch.Tensor | None = None) -> torch.Tensor:
    """Device-resident row-liveness plane, memoized on the batch; a merge
    hands the merged batch the plane it made on the device (`resident`)."""
    cache = getattr(batch, "_device_live", None)
    if cache is None:
        cache = batch._device_live = {}
    key = str(device)
    live = cache.get(key)
    if live is None:
        live = cache[key] = resident if resident is not None \
            else torch.from_numpy(batch.row_mask()).to(device)
    return live


def device_handles(batch: col.ColumnBatch, device: torch.device,
                   resident: torch.Tensor | None = None) -> torch.Tensor:
    """Device-resident handle plane, memoized on the batch beside
    device_live and charged to the HBM ledger like batch_planes. A merge
    hands the merged batch the plane it gathered on the device
    (`resident`), so a later merge over that batch (K19) moves only the
    delta."""
    cache = getattr(batch, "_device_handles", None)
    if cache is None:
        cache = batch._device_handles = {}
    key = str(device)
    h = cache.get(key)
    if h is None:
        h = cache[key] = resident if resident is not None \
            else torch.from_numpy(batch.handles).to(device)
        if torch.device(device).type == "cuda":
            _charge_pinned(batch, int(batch.handles.nbytes))
    return h


# ---------------------------------------------------------------------------
# aggregate spec lowering
# ---------------------------------------------------------------------------

class AggSpec:
    """One pushed aggregate lowered to its masked-reduction pieces."""

    def __init__(self, name: str, arg: CompiledExpr | None,
                 distinct: bool = False):
        self.name = name
        self.arg = arg
        self.distinct = distinct

    @property
    def dedup(self) -> bool:
        """Takes the DISTINCT route (MIN/MAX DISTINCT are plain MIN/MAX)."""
        return self.distinct and self.name in ("count", "sum", "avg")


def lower_aggregates(req: SelectRequest, batch: col.ColumnBatch,
                     prog: Program) -> list[AggSpec]:
    specs = []
    for e in req.aggregates:
        name = AGG_NAME[e.tp]
        if name not in ("count", "sum", "avg", "min", "max", "first_row"):
            raise Unsupported(f"aggregate {name} not lowered yet")
        if e.distinct and name == "first_row":
            raise Unsupported("distinct first_row")
        if e.distinct and len(e.children) != 1:
            raise Unsupported("distinct over other than one argument")
        if name == "first_row":
            # exact first-row semantics need a host-side gather by row
            # position, which needs the argument to be a plain column
            if not e.children or e.children[0].tp != ExprType.COLUMN_REF:
                raise Unsupported("first_row lowering needs a column arg")
        arg = compile_expr(e.children[0], batch, prog) if e.children \
            else None
        if arg is not None and arg.kind == "strconst":
            raise Unsupported("string constant as aggregate argument")
        if name in ("sum", "avg") and arg is not None \
                and arg.kind == col.K_DEC:
            # scaled-int sums must provably fit int64: worst case is
            # every row contributing the batch's max magnitude
            _dec_guard((arg.max_abs or 0) * max(batch.n_rows, 1),
                       "aggregate sum")
        specs.append(AggSpec(name, arg, bool(e.distinct)))
    return specs


# planes-dict keys for host-built composite TUPLE codes (tuple_codes): one
# interned negative key per group-column tuple, below every per-column
# group-code key
TUPLE_BASE = -1_000_000
_tuple_keys: dict[tuple, int] = {}


def tuple_code_key(cids) -> int:
    t = tuple(cids)
    key = _tuple_keys.get(t)
    if key is None:
        key = TUPLE_BASE - len(_tuple_keys)
        _tuple_keys[t] = key
    return key


def is_group_code_key(key: int) -> bool:
    return TUPLE_BASE < key <= GC_BASE


def is_tuple_key(key: int) -> bool:
    return key <= TUPLE_BASE


class GroupSpec:
    """Lowered group-by, one of three id schemes:

    - 'radix': mixed-radix code over per-column dictionary codes (K_STR
      codes from the pack dictionary, numeric/time codes from
      ColumnBatch.group_codes), computed by K1.
    - 'tuple': one host-built composite code over the whole group tuple
      (ColumnBatch.tuple_codes), the compaction of a radix space whose
      cross product overflows RADIX_MAX_SEGMENTS; kernel_sizes is
      [n_groups] and percol decodes ids back to per-column codes.
    - 'rank': a device sort of the group columns and ranks over the
      sorted rows (build_ranked_group_fn); any cardinality, no host
      pass."""

    def __init__(self, kind: str, cids: list[int], sizes: list[int],
                 col_kinds: list[str], plane_keys=None, decoders=None):
        self.kind = kind          # "radix" | "tuple" | "rank"
        self.cids = cids
        self.sizes = sizes        # radix/tuple: per-column dict sizes
        self.col_kinds = col_kinds
        # radix/tuple: planes-dict key per group plane (the cid itself for
        # K_STR, group_code_key(cid) for host-built numeric/time planes,
        # tuple_code_key(cids), a single key, for composite codes)
        self.plane_keys = plane_keys or []
        # radix/tuple: per-column ("str", dict) | ("num", uniq) | ("dec", …)
        self.decoders = decoders or []
        # sizes handed to build_grouped_agg_fn ([n_groups] for tuple)
        self.kernel_sizes = sizes
        self.percol = None        # tuple: int64[G, k] per-column codes
        self.n_groups = None      # tuple: G


def lower_group_by(req: SelectRequest, batch: col.ColumnBatch) -> GroupSpec:
    cids, kinds = [], []
    for item in req.group_by:
        e = item.expr
        if e.tp != ExprType.COLUMN_REF:
            raise Unsupported("non-column group-by")
        cd = batch.columns.get(e.val)
        if cd is None:
            raise Unsupported("group-by column not packed")
        cids.append(e.val)
        kinds.append(cd.kind)
    # sizes clamp to >= 1 so the mixed-radix math stays nonzero; the
    # kernel's NULL slot and the emit threshold use the SAME clamped size
    sizes, decoders = _col_sizes_decoders(batch, cids, floor=1)
    plane_keys = [cid if kind == col.K_STR else group_code_key(cid)
                  for cid, kind in zip(cids, kinds)]
    num_segments = 1
    for s in sizes:
        num_segments *= s + 1
    if num_segments + 1 <= RADIX_MAX_SEGMENTS:
        return GroupSpec("radix", cids, sizes, kinds, plane_keys, decoders)
    return GroupSpec("rank", cids, [], kinds)


def _col_sizes_decoders(batch: col.ColumnBatch, cids: list[int],
                        floor: int) -> tuple[list[int], list]:
    """Per-group-column (sizes, decoders) shared by the radix and tuple
    lowerings. `floor=1` for radix (see lower_group_by); `floor=0` for
    tuple, whose percol codes use the UNCLAMPED size as the NULL code, so
    the emit threshold must match it exactly."""
    sizes, decoders = [], []
    for cid in cids:
        cd = batch.columns[cid]
        if cd.kind == col.K_STR:
            sizes.append(max(len(cd.dictionary), floor))
            decoders.append(("str", cd.dictionary))
        else:
            _codes, uniq = batch.group_codes(cid)
            sizes.append(max(len(uniq), floor))
            if cd.kind == col.K_DEC:
                decoders.append(("dec", uniq, cd.dec_scale))
            else:
                decoders.append(("num", uniq))
    return sizes, decoders


def lower_tuple_group(gspec: GroupSpec,
                      batch: col.ColumnBatch) -> GroupSpec | None:
    """Compact a rank-lowered group-by into composite TUPLE codes: one host
    pass builds dense ids over the distinct group tuples, so the grouped
    route (K1 + K3/K4) applies even when the per-column cross product
    overflows RADIX_MAX_SEGMENTS. None when even the distinct-tuple count
    exceeds the segment ceiling."""
    _codes, percol = batch.tuple_codes(gspec.cids)
    n_groups = percol.shape[0]
    if n_groups + 2 > RADIX_MAX_SEGMENTS:
        return None
    sizes, decoders = _col_sizes_decoders(batch, gspec.cids, floor=0)
    spec = GroupSpec("tuple", gspec.cids, sizes, gspec.col_kinds,
                     [tuple_code_key(gspec.cids)], decoders)
    spec.kernel_sizes = [n_groups]
    spec.percol = percol
    spec.n_groups = n_groups
    return spec


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

class Red:
    """One reduction of K2/K3/K4: an op over (values, valid) planes, or
    over a constant (`const_bits`), or over no row at all (`never`)."""

    __slots__ = ("op", "values", "valid", "const_bits", "never")

    def __init__(self, op: int, values=None, valid=None, const_bits=0,
                 never=False):
        self.op = op
        self.values = values
        self.valid = valid
        self.const_bits = int(const_bits)
        self.never = never


def spec_reduction(spec: AggSpec, planes: dict, outs: dict) -> Red:
    arg = spec.arg
    if spec.name == "first_row":
        return Red(R_FIRST)
    dt = arg.dt if arg is not None else "i"
    if spec.name == "count":
        op = R_COUNT
    elif spec.name in ("sum", "avg"):
        op = R_SUM_F if dt == "f" else R_SUM_I
    else:
        is_min = spec.name == "min"
        if dt == "f":
            op = R_MIN_F if is_min else R_MAX_F
        else:
            op = R_MIN_I if is_min else R_MAX_I
    if arg is None:             # count() — the planner's count(1)
        return Red(op, const_bits=1)
    const = getattr(arg, "const", None)
    if const is not None:
        bits, valid = const
        return Red(op, const_bits=bits, never=not valid)
    if arg.cid is not None:
        values, valid = planes[arg.cid]
        return Red(op, values, valid)
    values, valid = outs[arg.reg]
    return Red(op, values, valid)


def _needs_plane(spec: AggSpec) -> bool:
    a = spec.arg
    return (spec.name != "first_row" and a is not None and a.cid is None
            and getattr(a, "const", None) is None)


def _unpack(reds: list[Red], n: torch.Tensor, acc: torch.Tensor):
    """(n[R, ...], acc[R, ...]) int64 → per reduction (n, value) numpy."""
    n = n.cpu().numpy()
    acc = acc.cpu().numpy()
    out = []
    for r, red in enumerate(reds):
        v = acc[r].view(np.float64) if red.op in F_OPS else acc[r]
        out.append((n[r], v))
    return out


def _agg_outputs(specs: list[AggSpec], per_red: list) -> list:
    outs = []
    for spec, (n, v) in zip(specs, per_red):
        outs.extend([n] if spec.name == "count" else [n, v])
    return outs


# ---------------------------------------------------------------------------
# request kernels
# ---------------------------------------------------------------------------

def run_k1(fin: Finalized, planes: dict, live, outputs: list,
            want_gid: bool):
    """K1 over a request's planes → (mask, gid, {virtual reg: (values,
    valid)} of the program outputs)."""
    plane_list = [planes[key][which] for key, which in fin.plane_keys]
    mask, gid, values = expr_vm(fin, plane_list, live, want_gid)
    return mask, gid, {o.reg: vv for o, vv in zip(outputs, values)}


def program_outputs(specs):
    """Aggregate arguments K1 must write: neither a plain column (its
    planes are read directly) nor a constant; one per register."""
    seen, outs = set(), []
    for s in specs:
        if _needs_plane(s) and s.arg.reg not in seen:
            seen.add(s.arg.reg)
            outs.append(s.arg)
    return outs


def _combiners(specs: list[AggSpec], leading: list | None = None) -> list:
    """The shard-combine monoid of every output of an aggregate fn ("sum",
    "min", "max", or None where per-shard partials cannot be combined: a
    DISTINCT count or sum needs a global dedup). first_row combines by
    the smallest global row position."""
    out = list(leading or [])
    for spec in specs:
        if spec.name == "count":
            out.append(None if spec.distinct else "sum")
        elif spec.name in ("sum", "avg"):
            out.extend([None, None] if spec.distinct else ["sum", "sum"])
        elif spec.name in ("min", "first_row"):
            out.extend(["sum", "min"])
        elif spec.name == "max":
            out.extend(["sum", "max"])
        else:
            out.append(None)
    return out


def shard_ids(n: int, shards: int, device) -> torch.Tensor:
    """The shard of every row of an [n] batch cut into `shards` contiguous
    blocks (n divisible by shards)."""
    return torch.arange(n, dtype=torch.int64, device=device) \
        // (n // shards)


def _seg_agg(gid, mask, num_segments: int, reds: list[Red]):
    """K3 up to ONEHOT_SEGMENTS_MAX segments, K4 above."""
    if num_segments <= ONEHOT_SEGMENTS_MAX:
        return seg_agg_onehot(gid, mask, num_segments, reds)
    return seg_agg_sorted(gid, mask, num_segments, reds)


def _shard_outputs(specs: list[AggSpec], reds: list[Red], n, acc,
                   shards: int, first: int) -> list:
    """(partials [shards, M] int64, is-f64) per aggregate output, from
    reductions laid out over shards * M segments; reds[first:] are the
    specs' own."""
    n = n.view(len(reds), shards, -1)
    acc = acc.view(len(reds), shards, -1)
    out = [(n[i], False) for i in range(first)]
    for j, spec in enumerate(specs):
        i = first + j
        out.append((n[i], False))
        if spec.name != "count":
            out.append((acc[i], reds[i].op in F_OPS))
    return out


def _host_outputs(folded: list, parts: list, scalar: bool) -> list:
    """Folded int64 host arrays back to the fn's output layout: f64 views
    where the partial was f64, numpy scalars for a scalar aggregate."""
    out = []
    for a, (_t, is_f) in zip(folded, parts):
        a = a.view(np.float64) if is_f else a
        out.append(a[0] if scalar else a)
    return out


def build_scalar_agg_fn(prog: Program, where: CompiledExpr | None,
                        specs: list[AggSpec]):
    """Returns fn(planes, live) → flat list of reduction results.
    fn.partials(planes, live, shards): the same outputs per shard (K3 or
    K4 over the shard ids), for the mesh to fold (fn.combiners)."""
    outputs = program_outputs(specs)
    fin = prog.finalize(where, outputs)

    def partials(planes, live, shards: int) -> list:
        with phase("k1", live.device):
            mask, _gid, outs = run_k1(fin, planes, live, outputs, False)
        reds = [spec_reduction(s, planes, outs) for s in specs]
        with phase("reduce", live.device):
            n, acc = _seg_agg(shard_ids(live.shape[0], shards, live.device),
                              mask, shards, reds)
        return _shard_outputs(specs, reds, n, acc, shards, 0)

    def fn(planes, live):
        with phase("k1", live.device):
            mask, _gid, outs = run_k1(fin, planes, live, outputs, False)
        per = [None] * len(specs)
        plain = [i for i, s in enumerate(specs) if not s.dedup]
        if plain:
            reds = [spec_reduction(specs[i], planes, outs) for i in plain]
            with phase("reduce", live.device):
                n, acc = scalar_agg(mask, reds)
                for i, r in zip(plain, _unpack(reds, n, acc)):
                    per[i] = r
        for i, s in enumerate(specs):
            if s.dedup:
                per[i] = distinct_totals(s, planes, outs, mask, None, 0)
        return _agg_outputs(specs, per)

    fn.program = fin
    fn.combiners = _combiners(specs)
    fn.partials = partials
    fn.finish = lambda folded, parts: _host_outputs(folded, parts, True)
    return fn


def build_grouped_agg_fn(prog: Program, where: CompiledExpr | None,
                         specs: list[AggSpec], group_keys: list,
                         dict_sizes: list[int]):
    """fn(planes, live) → (row_count, per-spec arrays…), each sized
    num_segments = prod(dict sizes + 1) + 1; the LAST segment is the
    dead-row sink (padding + filtered rows), dropped by the caller. NULL
    group values take the reserved code slot `size` of their column.
    fn.partials(planes, live, shards): the same outputs per shard, K3 or
    K4 over ids shard * num_segments + gid, for the mesh to fold."""
    radices = [s + 1 for s in dict_sizes]
    num_segments = 1
    for r in radices:
        num_segments *= r
    num_segments += 1  # dead-row sink
    outputs = program_outputs(specs)
    fin = prog.finalize(where, outputs,
                        group=list(zip(group_keys, dict_sizes)),
                        sink=num_segments - 1)

    def partials(planes, live, shards: int) -> list:
        with phase("k1", live.device):
            mask, gid, outs = run_k1(fin, planes, live, outputs, True)
        reds = [Red(R_COUNT)] + [spec_reduction(s, planes, outs)
                                 for s in specs]
        with phase("reduce", live.device):
            gid = gid + shard_ids(live.shape[0], shards, live.device) \
                * num_segments
            n, acc = _seg_agg(gid, mask, shards * num_segments, reds)
        return _shard_outputs(specs, reds, n, acc, shards, 1)

    def fn(planes, live):
        with phase("k1", live.device):
            mask, gid, outs = run_k1(fin, planes, live, outputs, True)
        plain = [i for i, s in enumerate(specs) if not s.dedup]
        reds = [Red(R_COUNT)] + [spec_reduction(specs[i], planes, outs)
                                 for i in plain]
        with phase("reduce", live.device):
            n, acc = _seg_agg(gid, mask, num_segments, reds)
            per_red = _unpack(reds, n, acc)
        per = [None] * len(specs)
        for i, r in zip(plain, per_red[1:]):
            per[i] = r
        for i, s in enumerate(specs):
            if s.dedup:
                per[i] = distinct_totals(s, planes, outs, mask, gid,
                                         num_segments)
        return [per_red[0][0]] + _agg_outputs(specs, per)

    fn.num_segments = num_segments
    fn.radices = radices
    fn.program = fin
    fn.combiners = _combiners(specs, leading=["sum"])   # row_count first
    fn.partials = partials
    fn.finish = lambda folded, parts: _host_outputs(folded, parts, False)
    return fn


def build_filter_fn(prog: Program, where: CompiledExpr | None):
    """fn(planes, live) → (mask,). Row-wise, so on a mesh the mask of the
    batch is the mask of its shard-major blocks."""
    fin = prog.finalize(where, [])

    def fn(planes, live):
        mask, _gid, _outs = run_k1(fin, planes, live, [], False)
        return (mask,)

    fn.program = fin
    return fn


# ---------------------------------------------------------------------------
# slice 3: DISTINCT, ranked group-by and TopN on the in-process path
# ---------------------------------------------------------------------------

def orderable(v: torch.Tensor) -> torch.Tensor:
    """Monotone, equality-preserving int64 sort key of a value plane (the
    reference's _orderable_i64): int64 planes as they are; f64 with -0.0
    made +0.0 (SQL equality) and its bits mapped from sign-magnitude to
    two's complement, so that int64 order is the float order."""
    if v.dtype != torch.float64:
        return v.to(torch.int64)
    b = torch.where(v == 0.0, torch.zeros_like(v), v).view(torch.int64)
    return torch.where(b < 0, b ^ I64_MAX, b)


def _flag(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8)


def lexsort_plain(keys: list) -> tuple:
    """Chained stable torch.sort passes, one per key: lexsort's CPU
    route."""
    perm = last = None
    for k in keys:
        last, idx = torch.sort(k if perm is None else k[perm], stable=True)
        perm = idx if perm is None else perm[idx]
    return perm, last


def lexsort(keys: list) -> tuple:
    """Stable lexicographic row order: keys least-significant first
    (np.lexsort's order), each an integer tensor [n]; equal rows keep their
    row order. On the card one K17 (sort_perm), on the CPU lexsort_plain.
    Returns (permutation, the most significant key in sorted order)."""
    if _device_kind(keys[0]) == "cpu":
        return lexsort_plain(keys)
    perm = sort_perm(keys, keys[0].shape[0])
    return perm, keys[-1].index_select(0, perm)


def arg_plane(spec: AggSpec, planes: dict, outs: dict, n: int, dev):
    """(values, valid) of an aggregate's argument as [n] planes."""
    arg = spec.arg
    const = getattr(arg, "const", None)
    if const is not None:
        bits, valid = const
        v = torch.full((n,), bits, dtype=torch.int64, device=dev)
        if arg.dt == "f":
            v = v.view(torch.float64)
        return v, torch.full((n,), bool(valid), dtype=torch.bool, device=dev)
    if arg.cid is not None:
        return planes[arg.cid]
    return outs[arg.reg]


def seg_agg_presorted(gid_sorted: torch.Tensor, order: torch.Tensor,
                      mask: torch.Tensor, num_segments: int,
                      reds: list[Red]):
    """K4's segmented pass over ids already sorted (nondecreasing) under
    the permutation `order`; mask and values stay in row order (the pass
    reads row order[i] at sorted position i)."""
    if _device_kind(mask) == "cpu":
        gid = torch.empty_like(gid_sorted)
        gid[order] = gid_sorted
        return seg_agg_plain(gid, mask, num_segments, reds)
    dev = mask.device
    n = mask.shape[0]
    _check_gid(gid_sorted, mask, dev)
    _check_plane(order, n, (torch.int64,), "order", dev)
    lib = _ext.lib("seg_agg_sorted")
    desc = _red_desc(reds, n, dev)
    part = torch.empty(len(reds) * lib.seg_sorted_pieces_count(n) * 4,
                       dtype=torch.int64, device=dev)
    out = torch.empty(len(reds) * num_segments * 2, dtype=torch.int64,
                      device=dev)
    rc = lib.seg_sorted_launch(
        n, gid_sorted.data_ptr(), order.data_ptr(), mask.data_ptr(),
        num_segments, len(reds), desc.data_ptr(), part.data_ptr(),
        out.data_ptr(), _stream(dev))
    _ext.check(rc, "seg_agg_sorted")
    LAUNCHES["seg_agg_sorted"] += 1
    out = out.view(len(reds), num_segments, 2)
    return out[..., 0], out[..., 1]


def distinct_sort(v: torch.Tensor, contrib: torch.Tensor, gid=None):
    """The sort of the DISTINCT kernels: rows by (group id, contributing
    first, orderable value), one K17 on the card (sort_perm_words).
    Returns (perm, key, gid in sorted order or None, words): words (the
    sorted composite word, K9's flag) where K17 packed the planes into one
    word, for K9's sorted-word mode, else None."""
    key = orderable(v)
    keys = [key, _flag(~contrib)] + ([gid] if gid is not None else [])
    perm, w, plan, pairs = sort_perm_words(keys, key.shape[0])
    gid_s = None if gid is None else gid.index_select(0, perm)
    words = None
    if w is not None:
        flag = [shift for fields, _v, _p in plan for j, shift, _w in fields
                if j == 1]
        # a constant flag plane: every row contributes, or none does
        const = (pairs[1][0] ^ (1 << 63)) & 1
        words = (w, flag[0] if flag else (K9_NONE if const else K9_ALL))
    return perm, key, gid_s, words


def distinct_totals(spec: AggSpec, planes: dict, outs: dict,
                    mask: torch.Tensor, gid, num_segments: int):
    """One DISTINCT aggregate's (count, sum) — numpy scalars, or [S]
    arrays per group id `gid` (row order) — the port of _distinct_reduce
    and _grouped_distinct: rows lexsorted by (group, contributing first,
    orderable value), K9 marks the run openers, and K2 (scalar) or K4's
    pass (grouped) counts them and sums their values."""
    dev = mask.device
    v, ok = arg_plane(spec, planes, outs, mask.shape[0], dev)
    contrib = mask & ok
    with phase("sort", dev):
        perm, key, gid_s, words = distinct_sort(v, contrib, gid)
    with phase("k9", dev):
        firsts = distinct_runs(perm, key, contrib, gid_s, words)
    if spec.name == "count":
        red = Red(R_COUNT)
    elif v.dtype == torch.float64:
        # the (-0.0, +0.0) run adds 0
        red = Red(R_SUM_F, torch.where(v == 0.0, torch.zeros_like(v), v))
    else:
        red = Red(R_SUM_I, v.to(torch.int64))
    with phase("reduce", dev):
        if gid is None:
            cnt, acc = scalar_agg(firsts, [red])
        else:
            cnt, acc = seg_agg_presorted(gid_s, perm, firsts, num_segments,
                                         [red])
        (res,) = _unpack([red], cnt, acc)
    return res


class RankedPrep:
    """What a ranked group-by's statement computes once, whatever the
    rung: K1's mask and argument planes, the lexsort permutation and K8's
    rank pass with its group count."""

    __slots__ = ("mask", "outs", "order", "cols", "ranks", "ngroups")

    def __init__(self, mask, outs, order, cols, ranks):
        self.mask = mask
        self.outs = outs
        self.order = order
        self.cols = cols
        self.ranks = ranks
        self.ngroups = int(ranks.ngroups[0])


def ranked_keys(cols: list, mask: torch.Tensor) -> list:
    """The sort keys of a ranked group-by, least significant first: the
    columns in declaration order, each its orderable value (0 where NULL)
    under its NULL flag, then liveness (live rows first)."""
    keys = []
    for v, ok in reversed(cols):
        keys.append(torch.where(ok, orderable(v), torch.zeros(
            (), dtype=torch.int64, device=v.device)))
        keys.append(_flag(~ok))
    keys.append(_flag(~mask))
    return keys


def build_ranked_group_fn(prog: Program, where: CompiledExpr | None,
                          specs: list[AggSpec], group_cids: list[int]):
    """Group-by over any columns by sort and rank (the port of the
    reference's build_ranked_group_fn, its ids batch-local). fn.prepare(
    planes, live) runs K1, the stable lexsort (liveness first, then the
    columns in declaration order, null flag before value) and K8's rank
    pass, which counts the groups (prep.ngroups); fn(prep, planes, S), when
    the groups fit S segments (ngroups <= S - 1), runs K8's output pass
    with S segments and the reductions in sorted space with K4's pass. It
    returns (ngroups, outs) with outs = [ngroups, row_count[S],
    (representative, non-null) per group column, per-spec outputs…], or
    (ngroups, None) when the groups overflow S - 1 (the caller takes the
    next rung)."""
    outputs = program_outputs(specs)
    fin = prog.finalize(where, outputs)

    def prepare(planes, live) -> RankedPrep:
        with phase("k1", live.device):
            mask, _gid, outs = run_k1(fin, planes, live, outputs, False)
        cols = [planes[cid] for cid in group_cids]
        with phase("sort", live.device):
            order, dead = lexsort(ranked_keys(cols, mask))
        with phase("k8", live.device):
            return RankedPrep(mask, outs, order, cols,
                              rank_groups_rank(order, dead, cols))

    def run(prep: RankedPrep, planes, S: int):
        dev = prep.mask.device
        ngroups = prep.ngroups
        if ngroups > S - 1:
            return ngroups, None
        with phase("k8", dev):
            gid_s, _starts, rep, nonnull = rank_groups_out(prep.ranks, S)
        plain = [i for i, s in enumerate(specs) if not s.dedup]
        reds = [Red(R_COUNT)] + [spec_reduction(specs[i], planes, prep.outs)
                                 for i in plain]
        with phase("reduce", dev):
            n, acc = seg_agg_presorted(gid_s, prep.order, prep.mask, S, reds)
            per_red = _unpack(reds, n, acc)
        per = [None] * len(specs)
        for i, r in zip(plain, per_red[1:]):
            per[i] = r
        if any(s.dedup for s in specs):
            gid = torch.empty_like(gid_s)
            gid[prep.order] = gid_s
            for i, s in enumerate(specs):
                if s.dedup:
                    per[i] = distinct_totals(s, planes, prep.outs, prep.mask,
                                             gid, S)
        rep, nonnull = rep.cpu().numpy(), nonnull.cpu().numpy()
        head = [np.int64(ngroups), per_red[0][0]]
        for c, (v, _ok) in enumerate(prep.cols):
            r = rep[c].view(np.float64) if v.dtype == torch.float64 \
                else rep[c]
            head.extend([r, nonnull[c]])
        return ngroups, head + _agg_outputs(specs, per)

    fn = run
    fn.prepare = prepare
    fn.program = fin
    return fn


# at most this many ORDER BY items (K10's key table)
TOPN_MAX_KEYS = 4


def build_topn_fn(prog: Program, where: CompiledExpr | None,
                  keys: list, k: int):
    """Top-k row indices over ORDER BY items `keys` [(CompiledExpr, desc)]
    (the port of build_topn_fn and build_topn_fn_multi, one builder for
    one key or several): fn(planes, live) → (idx int64[min(k, cap)],
    n_live) with n_live = min(live rows, k). Order: per item, NULL first
    ascending and last descending, values compared natively; ties by row
    position. K1 writes the mask and a key plane for each item that is an
    expression and not a plain column; K10 selects."""
    if len(keys) > TOPN_MAX_KEYS:
        raise Unsupported(f"{len(keys)} ORDER BY items exceed "
                          f"{TOPN_MAX_KEYS}")
    for e, _desc in keys:
        if e.kind == "strconst":
            raise Unsupported("string constant as ORDER BY item")
    # a constant item orders no row before another
    keys = [(e, bool(d)) for e, d in keys
            if getattr(e, "const", None) is None]
    seen, outputs = set(), []
    for e, _d in keys:
        if e.cid is None and e.reg not in seen:
            seen.add(e.reg)
            outputs.append(e)
    fin = prog.finalize(where, outputs)

    def inputs(planes, live):
        """K10's inputs: K1's mask and [((values, valid), desc)]."""
        with phase("k1", live.device):
            mask, _gid, outs = run_k1(fin, planes, live, outputs, False)
        return mask, [(planes[e.cid] if e.cid is not None else outs[e.reg],
                       d) for e, d in keys]

    def fn(planes, live):
        mask, planes_k = inputs(planes, live)
        with phase("k10", live.device):
            return topk_select(mask, planes_k, k)

    fn.inputs = inputs
    fn.program = fin
    return fn


# ---------------------------------------------------------------------------
# K8 rank_groups, K9 distinct_runs, K10 topk_select and their plain versions
# ---------------------------------------------------------------------------

# K8's column table by value, and its tile of sorted positions (the
# contract with ops/csrc/rank_groups.cu: K8_MAX_COLS, K8_TILE)
K8_MAX_COLS = 64
K8_TILE = 1024


class RankPass:
    """What K8's rank pass leaves for its output pass: the permutation and
    group columns it ranked, ngroups (int64 [1], on their device) and, on
    the card, each sorted position's 16-bit word ((inclusive count of
    openers in its K8_TILE tile << 2) | opener << 1 | live) with the
    tiles' offsets and the column table the launch took, or, from the
    plain version, the sorted live flags and the unclamped ranks
    (inclusive count of openers - 1)."""

    __slots__ = ("order", "cols", "ngroups", "word", "block_off", "table",
                 "live_s", "rank")

    def __init__(self, order, cols, ngroups, word=None, block_off=None,
                 table=None, live_s=None, rank=None):
        self.order = order
        self.cols = cols
        self.ngroups = ngroups
        self.word = word
        self.block_off = block_off
        self.table = table
        self.live_s = live_s
        self.rank = rank


def rank_groups_rank_plain(order, dead, cols: list) -> RankPass:
    n = order.shape[0]
    dev = order.device
    live_s = dead == 0
    change = torch.zeros(n, dtype=torch.bool, device=dev)
    change[:1] = True                  # row 0 always opens a group
    for v, ok in cols:
        ks = torch.where(ok, orderable(v), torch.zeros(
            (), dtype=torch.int64, device=dev))[order]
        os_ = ok[order]
        change[1:] |= (ks[1:] != ks[:-1]) | (os_[1:] != os_[:-1])
    newgrp = change & live_s
    rank = torch.cumsum(newgrp.to(torch.int64), 0) - 1
    ngroups = newgrp.sum(dtype=torch.int64).reshape(1)
    return RankPass(order, cols, ngroups, live_s=live_s, rank=rank)


def rank_groups_out_plain(rp: RankPass, S: int) -> tuple:
    order, cols, rank, live_s = rp.order, rp.cols, rp.rank, rp.live_s
    dev = order.device
    sink = torch.full_like(rank, S - 1)
    gid_s = torch.where(live_s, torch.minimum(rank, sink), sink)
    # an opener is a live position whose rank its predecessor lacks
    opens = live_s.clone()
    opens[1:] &= rank[1:] != rank[:-1]
    pos = torch.nonzero(opens & (rank < S)).squeeze(1)
    r = rank[pos]
    starts = torch.full((S,), -1, dtype=torch.int64, device=dev)
    starts[r] = pos
    rows = order[pos]
    rep = torch.zeros((len(cols), S), dtype=torch.int64, device=dev)
    nonnull = torch.zeros((len(cols), S), dtype=torch.bool, device=dev)
    for c, (v, ok) in enumerate(cols):
        vi = v.view(torch.int64) if v.dtype == torch.float64 else v
        rep[c, r] = vi[rows]
        nonnull[c, r] = ok[rows]
    return gid_s, starts, rep, nonnull


def _k8_cols(cols: list, n: int, dev) -> tuple:
    """K8's column table: (values pointers, valid pointers, f64 mask),
    each plane checked."""
    if len(cols) > K8_MAX_COLS:
        raise Unsupported(f"{len(cols)} group columns exceed K8's "
                          f"{K8_MAX_COLS}")
    vals, valid, f64 = [], [], 0
    for c, (v, ok) in enumerate(cols):
        _check_plane(v, n, (torch.int64, torch.float64), f"column {c}", dev)
        _check_plane(ok, n, (torch.bool,), f"column {c} valid", dev)
        vals.append(v.data_ptr())
        valid.append(ok.data_ptr())
        f64 |= int(v.dtype == torch.float64) << c
    return (_c_array(ctypes.c_void_p, vals),
            _c_array(ctypes.c_void_p, valid), f64)


def rank_groups_rank(order: torch.Tensor, dead: torch.Tensor,
                     cols: list) -> RankPass:
    """K8's rank pass over rows in lexsort order `order`, with `dead` each
    sorted position's dead flag (uint8, nonzero for a dead row: the sort's
    most significant key in sorted order, as lexsort(ranked_keys(...))
    returns it; live rows first): a row opens a group when it is live and
    row 0 or any column's (null flag, value) differs from the previous
    row's, f64 values compared by their orderable images (-0.0 as +0.0,
    NaNs of one bit pattern equal). It gathers each sorted position's key
    once; its RankPass holds ngroups and what rank_groups_out needs."""
    if not cols:
        raise errors.DeviceError("rank_groups needs a column")
    if _device_kind(dead) == "cpu":
        return rank_groups_rank_plain(order, dead, cols)
    dev = dead.device
    n = dead.shape[0]
    _check_plane(dead, n, (torch.uint8,), "dead flags", dev)
    _check_plane(order, n, (torch.int64,), "order", dev)
    vals, valid, f64 = _k8_cols(cols, n, dev)
    if n == 0:
        return RankPass(order, cols, torch.zeros(1, dtype=torch.int64,
                                                 device=dev))
    lib = _ext.lib("rank_groups")
    blocks = -(-n // K8_TILE)
    word = torch.empty(n, dtype=torch.uint16, device=dev)
    # the tiles' totals, their offsets and ngroups, which the scan writes
    scan = torch.empty(2 * blocks + 1, dtype=torch.int64, device=dev)
    rc = lib.rank_groups_rank_launch(
        n, order.data_ptr(), dead.data_ptr(), len(cols), vals, valid, f64,
        word.data_ptr(), scan.data_ptr(), scan[blocks:].data_ptr(),
        scan[2 * blocks:].data_ptr(), _stream(dev))
    _ext.check(rc, "rank_groups")
    LAUNCHES["rank_groups"] += 1
    return RankPass(order, cols, scan[2 * blocks:],
                    word=word, block_off=scan[blocks:2 * blocks],
                    table=(vals, valid))


def rank_groups_out(rp: RankPass, S: int) -> tuple:
    """K8's output pass at S segments over a rank pass: (gid_s int64[n]
    group id per sorted position — its rank clamped to S - 1, dead rows
    S - 1; starts int64[S], the sorted position opening each group, -1
    where none; rep int64[ncol, S], each column's value (f64 bits) at the
    group's opener; nonnull bool[ncol, S])."""
    if S < 1:
        raise errors.DeviceError("rank_groups needs S >= 1")
    if rp.rank is not None:
        return rank_groups_out_plain(rp, S)
    dev = rp.order.device
    n = rp.order.shape[0]
    ncols = len(rp.cols)
    gid_s = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return (gid_s, torch.full((S,), -1, dtype=torch.int64, device=dev),
                torch.zeros((ncols, S), dtype=torch.int64, device=dev),
                torch.zeros((ncols, S), dtype=torch.bool, device=dev))
    starts = torch.empty(S, dtype=torch.int64, device=dev)
    rep = torch.empty((ncols, S), dtype=torch.int64, device=dev)
    nonnull = torch.empty((ncols, S), dtype=torch.bool, device=dev)
    vals, valid = rp.table
    lib = _ext.lib("rank_groups")
    rc = lib.rank_groups_out_launch(
        n, rp.word.data_ptr(), rp.block_off.data_ptr(),
        rp.ngroups.data_ptr(), rp.order.data_ptr(), ncols, vals, valid, S,
        gid_s.data_ptr(), starts.data_ptr(), rep.data_ptr(),
        nonnull.data_ptr(), _stream(dev))
    _ext.check(rc, "rank_groups_out")
    LAUNCHES["rank_groups_out"] += 1
    return gid_s, starts, rep, nonnull


# K9's flag for a constant flag plane: the contract with
# ops/csrc/distinct_runs.cu
K9_ALL = -1
K9_NONE = -2


def distinct_runs_plain(perm, key, contrib, gid_s):
    n = perm.shape[0]
    ks = key[perm]
    new = torch.ones(n, dtype=torch.bool, device=perm.device)
    new[1:] = ks[1:] != ks[:-1]
    if gid_s is not None:
        new[1:] |= gid_s[1:] != gid_s[:-1]
    firsts = torch.empty(n, dtype=torch.bool, device=perm.device)
    firsts[perm] = contrib[perm] & new
    return firsts


def distinct_runs_words_plain(perm, words, flag: int):
    """K9's sorted-word mode: a row at sorted position i opens a run iff
    it contributes (the flag's bit of the composite is 0, or K9_ALL) and
    i == 0 or its word differs from the previous one."""
    n = perm.shape[0]
    if flag >= 0:
        contrib = (_shr(words ^ I64_MIN, flag) & 1) == 0
    else:
        contrib = torch.full((n,), flag == K9_ALL, dtype=torch.bool,
                             device=perm.device)
    new = torch.ones(n, dtype=torch.bool, device=perm.device)
    new[1:] = words[1:] != words[:-1]
    firsts = torch.empty(n, dtype=torch.bool, device=perm.device)
    firsts[perm] = contrib & new
    return firsts


def distinct_runs(perm: torch.Tensor, key: torch.Tensor,
                  contrib: torch.Tensor, gid_s=None,
                  words=None) -> torch.Tensor:
    """K9 over rows sorted by (group id, contributing first, orderable
    key) under `perm`; gid_s the group ids in sorted order (None: one
    group). Returns firsts bool[n] in ROW order: a contributing row that
    opens a run, i.e. is sorted first or differs from the previous sorted
    row in group or key. With `words` (distinct_sort's: the sorted
    composite word and the flag's bit) the sorted-word mode, which reads
    no key, contrib or group id; else the gather mode."""
    if words is not None:
        w, flag = words
        if _device_kind(contrib) == "cpu":
            return distinct_runs_words_plain(perm, w, flag)
    elif _device_kind(contrib) == "cpu":
        return distinct_runs_plain(perm, key, contrib, gid_s)
    dev = contrib.device
    n = contrib.shape[0]
    _check_plane(perm, n, (torch.int64,), "perm", dev)
    firsts = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _ext.lib("distinct_runs")
    if words is not None:
        _check_plane(w, n, (torch.int64,), "sorted words", dev)
        if (w.data_ptr() | perm.data_ptr()) % 16:
            raise errors.DeviceError("K9's sorted words and permutation "
                                     "must be 16-byte aligned")
        rc = lib.distinct_runs_words_launch(
            n, perm.data_ptr(), w.data_ptr(), int(flag), firsts.data_ptr(),
            _stream(dev))
    else:
        _check_plane(contrib, n, (torch.bool,), "contrib", dev)
        _check_plane(key, n, (torch.int64,), "key", dev)
        if gid_s is not None:
            _check_plane(gid_s, n, (torch.int64,), "sorted group id", dev)
        rc = lib.distinct_runs_launch(
            n, perm.data_ptr(), key.data_ptr(), contrib.data_ptr(),
            0 if gid_s is None else gid_s.data_ptr(), firsts.data_ptr(),
            _stream(dev))
    _ext.check(rc, "distinct_runs")
    LAUNCHES["distinct_runs"] += 1
    return firsts


def topk_select_plain(mask, keys: list, k: int):
    n = mask.shape[0]
    sk = []
    zero = torch.zeros((), dtype=torch.int64, device=mask.device)
    for (v, ok), desc in reversed(keys):
        o = orderable(v)
        if desc:
            o = ~o                  # reverses the order, never wraps
        sk.append(torch.where(ok, o, zero))
        sk.append(_flag(~ok if desc else ok))   # NULL first asc, last desc
    sk.append(_flag(~mask))                     # dead rows last
    kk = min(k, n)
    perm, _ = lexsort_plain(sk)
    n_live = torch.clamp(mask.sum(dtype=torch.int64), max=kk).reshape(1)
    return perm[:kk].contiguous(), n_live


# K10's parameter block and plan (topk_select.cu: K10Key, K10_THREADS ...)
K10_STEP = 1024              # K10_THREADS * K10_ROWS: a block's step
K10_MAX_SLOTS = 8192         # shared-memory slots a block holds at most
K10_SMEM_LIMIT = 231424      # dynamic shared memory a block may take
K10_MERGE_ENTRIES = 32768    # list entries a merge block reads (fan_in * K)
K10_MAX_ROWS = (1 << 32) - 1  # rows are 32-bit in the composite keys


# one ORDER BY item of K10's parameter block (topk_select.cu: struct
# K10Key), by value: each field 8 bytes, packed in this order
K10_KEY_FIELDS = ("values", "valid", "is_f64", "desc")


def topk_max_slots(nk: int) -> int:
    """The most slots a block's shared memory holds for nk keys, a power
    of two: a slot takes 8 bytes of flags and row, 8 per key and 8 of
    slot lists."""
    P = K10_MAX_SLOTS
    while P > K10_STEP and P * (8 * nk + 16) > K10_SMEM_LIMIT:
        P //= 2
    return P


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def topk_plan(n: int, k: int, nk: int, grid) -> list:
    """K10's launches for the first k <= n rows of n over nk keys:
    rounds [(K, slots, levels)], each selecting the next K rows (K at most
    topk_max_slots(nk) - K10_STEP); a round's levels [(blocks, fan_in)]:
    level 1 over the rows (fan_in 0) with min(grid(slots), row steps)
    blocks, then merges of fan_in lists a block until one block is left.
    grid(slots) is the level-1 block count the card holds."""
    kmax = topk_max_slots(nk) - K10_STEP
    rounds, done = [], 0
    while done < k:
        K = min(kmax, k - done)
        slots = _pow2(K + K10_STEP)
        blocks = max(1, min(int(grid(slots)), -(-n // K10_STEP)))
        levels = [(blocks, 0)]
        fan = max(2, K10_MERGE_ENTRIES // K)
        while blocks > 1:
            blocks = -(-blocks // fan)
            levels.append((blocks, fan))
        rounds.append((K, slots, levels))
        done += K
    return rounds


def _list_bytes(cap: int, lists: int, nk: int) -> int:
    """A K10 list buffer (topk_select.cu k10_list): words, flags, rows of
    cap entries and a count per list, rounded up to 256 bytes."""
    return (cap * (8 * nk + 8) + 4 * lists + 255) // 256 * 256


def topk_scratch(plan: list, nk: int, shards: int = 1) -> tuple:
    """Byte offsets of K10's (or K20's, over `shards` shards) scratch for
    a plan: (list buffer A, list buffer B, the round bound (an entry a
    shard), the level-1 live counts, total). Level i of a round writes
    buffer i % 2 and reads the other."""
    sizes = [0, 0]
    for K, _slots, levels in plan:
        for i, (blocks, _fan) in enumerate(levels[:-1]):
            sizes[i % 2] = max(sizes[i % 2], _list_bytes(blocks * K, blocks,
                                                         nk))
    a, b = 0, sizes[0]
    bound = b + sizes[1]
    live = bound + _list_bytes(shards, shards, nk)
    return a, b, bound, live, live + 8 * plan[0][2][0][0]


_SCRATCH: dict = {}
_scratch_lock = threading.Lock()
_K10_PLANS: dict = {}


def _stream_scratch(name: str, dev: torch.device, nbytes: int,
                    stream: int) -> torch.Tensor:
    """A zeroed device buffer of at least nbytes kept per (kernel, device,
    stream): launches on one stream run in order, so each call reuses its
    predecessor's scratch instead of allocating (K2's ticket is back at 0
    when its launch ends)."""
    key = (name, dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is not None and buf.numel() >= nbytes:
        return buf
    with _scratch_lock:
        buf = _SCRATCH.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.zeros(max(int(nbytes), 1), dtype=torch.uint8,
                              device=dev)
            _SCRATCH[key] = buf
    return buf


def _k10_plan(lib, dev: torch.device, n: int, kk: int, nk: int) -> tuple:
    """topk_plan on the card and its scratch offsets, kept per shape."""
    key = (dev.index, n, kk, nk)
    got = _K10_PLANS.get(key)
    if got is None:
        plan = topk_plan(n, kk, nk, lambda slots: _k10_grid(
            lib.topk_grid, dev, nk, slots))
        got = _K10_PLANS[key] = (plan, topk_scratch(plan, nk))
    return got


# the resident grid of topk_level.cuh's level kernel, which K10, K20 and
# K16 each build: one query per (device, keys, slots), whichever library
# answers it
_K10_GRID: dict = {}


def _k10_grid(query, dev: torch.device, nk: int, slots: int) -> int:
    return _card_query(_K10_GRID, (dev.index, nk, slots), query, nk, 1,
                       slots)


def topk_launch_count(n: int, k: int, nk: int, device) -> int:
    """K10's launches for one call on the card (its plan's levels)."""
    dev = _device(device)
    plan, _offs = _k10_plan(_ext.lib("topk_select"), dev, n, min(k, n), nk)
    return sum(len(levels) for _K, _s, levels in plan)


def topk_select(mask: torch.Tensor, keys: list, k: int):
    """K10: (idx int64[min(k, n)], n_live int64[1]) — the first k rows in
    the order (live first; per ORDER BY item (values, valid), desc: null
    rank, then the value, int64 or f64 with -0.0 == +0.0, reversed for
    DESC; then row position), and min(live rows, k). On the card the
    launches follow topk_plan (LAUNCHES counts each)."""
    if len(keys) > TOPN_MAX_KEYS:
        raise errors.DeviceError(f"K10 takes at most {TOPN_MAX_KEYS} keys")
    if _device_kind(mask) == "cpu":
        return topk_select_plain(mask, keys, k)
    dev = mask.device
    n = mask.shape[0]
    _check_plane(mask, n, (torch.bool,), "mask", dev)
    kk = min(int(k), n)
    if kk <= 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))
    if n > K10_MAX_ROWS:
        raise errors.DeviceError(f"K10 takes at most {K10_MAX_ROWS} rows")
    nk = len(keys)
    flat = []
    for j, ((v, ok), desc) in enumerate(keys):
        _check_plane(v, n, (torch.int64, torch.float64), f"key {j}", dev)
        _check_plane(ok, n, (torch.bool,), f"key {j} valid", dev)
        flat += [v.data_ptr(), ok.data_ptr(), int(v.dtype == torch.float64),
                 int(bool(desc))]
    karr = array.array("q", flat or [0] * len(K10_KEY_FIELDS))
    lib = _ext.lib("topk_select")
    plan, (off_a, off_b, off_bound, off_live, total) = _k10_plan(
        lib, dev, n, kk, nk)
    stream = _stream(dev)
    base = _stream_scratch("topk_select", dev, total, stream).data_ptr()
    bufs = (base + off_a, base + off_b)
    out = torch.empty(kk + 1, dtype=torch.int64, device=dev)
    idx_p, live_p = out.data_ptr(), out.data_ptr() + 8 * kk
    done = 0
    for r, (K, slots, levels) in enumerate(plan):
        for i, (blocks, fan) in enumerate(levels):
            final = i == len(levels) - 1
            rc = lib.topk_level_launch(
                nk, int(i == 0), blocks, K, slots, n, mask.data_ptr(),
                karr.buffer_info()[0], bufs[(i - 1) % 2] if i else None,
                levels[i - 1][0] if i else 0, fan,
                None if final else bufs[i % 2], base + off_bound,
                int(r > 0 and i == 0), int(final), idx_p, done, kk,
                base + off_live, int(r == 0 and (i == 0 or final)),
                levels[0][0], live_p, stream)
            _ext.check(rc, "topk_select")
            LAUNCHES["topk_select"] += 1
        done += K
    return out[:kk], out[kk:]


# ---------------------------------------------------------------------------
# the mesh TopN: K20 shard_topk, its plain version and the host merge
# ---------------------------------------------------------------------------

def build_topn_partial_fn(prog: Program, where: CompiledExpr | None,
                          keys: list, k: int):
    """Per-shard top-k for the mesh (the port of build_topn_partial_fn and
    build_topn_partial_fn_multi, one builder for one key or several):
    fn(planes, live, shards) → K20's (idx int64[S, k] shard-local, n_live
    int64[S], words int64[S, nk, k], nulls uint8[S, nk, k]) over the S
    contiguous row blocks, k <= the block length. The reference ships f64
    scores (one key) or negated int64 keys (several) for the host merge;
    here each candidate carries K10's order words and null ranks, so the
    merge orders rows exactly as K10 and the CPU engine do."""
    base = build_topn_fn(prog, where, keys, k)

    def fn(planes, live, shards: int = 1):
        mask, planes_k = base.inputs(planes, live)
        with phase("k20", live.device):
            return shard_topk(mask, planes_k, k, shards)

    fn.program = base.program
    return fn


def topk_words_plain(keys: list, rows: torch.Tensor) -> tuple:
    """K10's order words (int64 holding the unsigned word) and null ranks
    of the rows `rows`, one [len(rows)] plane per key: the value's int64
    order bits with the sign flipped (unsigned order), complemented for
    DESC, 0 for NULL; the null rank is 1 for a valid ASC key and for a
    NULL DESC key."""
    words, nulls = [], []
    for (v, ok), desc in keys:
        o = orderable(v[rows]) ^ I64_MIN
        if desc:
            o = ~o
        okr = ok[rows]
        words.append(torch.where(okr, o, torch.zeros_like(o)))
        nulls.append(_flag(~okr if desc else okr))
    return words, nulls


def shard_topk_plain(mask, keys: list, k: int, shards: int):
    L = mask.shape[0] // shards
    dev = mask.device
    idx, n_live, words, nulls = [], [], [], []
    for s in range(shards):
        sl = slice(s * L, (s + 1) * L)
        ks = [((v[sl], ok[sl]), d) for (v, ok), d in keys]
        i, nl = topk_select_plain(mask[sl], ks, k)
        w, f = topk_words_plain(ks, i)
        idx.append(i)
        n_live.append(nl)
        words.append(torch.stack(w) if w else
                     torch.empty((0, k), dtype=torch.int64, device=dev))
        nulls.append(torch.stack(f) if f else
                     torch.empty((0, k), dtype=torch.uint8, device=dev))
    return (torch.stack(idx), torch.cat(n_live), torch.stack(words),
            torch.stack(nulls))


def shard_topk_plan(S: int, L: int, k: int, nk: int, grid) -> list:
    """K20's launches for the first k <= L rows of each of S shards of L
    rows over nk keys, as topk_plan's rounds [(K, slots, levels)]: level 1
    over the rows with grid(slots) // S blocks a shard (at least one;
    levels[i][0] counts the blocks of every shard), then merges of fan_in
    of a shard's lists a block until one block a shard is left. The
    launches depend on S, k, nk and the grid, never on L."""
    if not 1 <= k <= L:
        raise errors.DeviceError(f"K20 k = {k} outside [1, {L}]")
    kmax = topk_max_slots(nk) - K10_STEP
    rounds, done = [], 0
    while done < k:
        K = min(kmax, k - done)
        slots = _pow2(K + K10_STEP)
        per = max(1, int(grid(slots)) // S)
        levels = [(S * per, 0)]
        fan = max(2, K10_MERGE_ENTRIES // K)
        while per > 1:
            per = -(-per // fan)
            levels.append((S * per, fan))
        rounds.append((K, slots, levels))
        done += K
    return rounds


_K20_PLANS: dict = {}


def _k20_plan(query, dev: torch.device, S: int, L: int, k: int,
              nk: int) -> tuple:
    """shard_topk_plan on the card (K20's shards, K16's slots) and its
    scratch offsets, kept per shape; `query` the library's grid query."""
    key = (dev.index, S, L, k, nk)
    got = _K20_PLANS.get(key)
    if got is None:
        plan = shard_topk_plan(S, L, k, nk, lambda slots: _k10_grid(
            query, dev, nk, slots))
        got = _K20_PLANS[key] = (plan, topk_scratch(plan, nk, S))
    return got


def shard_topk_launch_count(S: int, L: int, k: int, nk: int,
                            device) -> int:
    """K20's launches for one call on the card (its plan's levels)."""
    dev = _device(device)
    plan, _offs = _k20_plan(_ext.lib("shard_topk").shard_topk_grid, dev, S,
                            L, k, nk)
    return sum(len(levels) for _K, _s, levels in plan)


def shard_topk(mask: torch.Tensor, keys: list, k: int, shards: int):
    """K20: the first k rows of each of `shards` contiguous row blocks in
    K10's order (live first; per ORDER BY item (values, valid), desc: null
    rank, then the order word; then row position). Returns (idx int64[S,
    k], block-local; n_live int64[S], min(live rows of the block, k);
    words int64[S, nk, k] and nulls uint8[S, nk, k], the candidates' order
    words and null ranks, as topk_words_plain gives them). k must lie in
    [1, block length]. On the card the launches follow shard_topk_plan
    (LAUNCHES counts each)."""
    if len(keys) > TOPN_MAX_KEYS:
        raise errors.DeviceError(f"K20 takes at most {TOPN_MAX_KEYS} keys")
    n = mask.shape[0]
    if shards < 1 or n % shards:
        raise errors.DeviceError(f"{n} rows do not split into {shards} "
                                 f"shards")
    L = n // shards
    if not 1 <= k <= L:
        raise errors.DeviceError(f"K20 k = {k} outside [1, {L}]")
    if _device_kind(mask) == "cpu":
        return shard_topk_plain(mask, keys, k, shards)
    dev = mask.device
    _check_plane(mask, n, (torch.bool,), "mask", dev)
    if n > K10_MAX_ROWS:
        raise errors.DeviceError(f"K20 takes at most {K10_MAX_ROWS} rows")
    nk = len(keys)
    flat = []
    for j, ((v, ok), desc) in enumerate(keys):
        _check_plane(v, n, (torch.int64, torch.float64), f"key {j}", dev)
        _check_plane(ok, n, (torch.bool,), f"key {j} valid", dev)
        flat += [v.data_ptr(), ok.data_ptr(), int(v.dtype == torch.float64),
                 int(bool(desc))]
    karr = array.array("q", flat or [0] * len(K10_KEY_FIELDS))
    lib = _ext.lib("shard_topk")
    plan, (off_a, off_b, off_bound, off_live, total) = _k20_plan(
        lib.shard_topk_grid, dev, shards, L, k, nk)
    stream = _stream(dev)
    base = _stream_scratch("shard_topk", dev, total, stream).data_ptr()
    bufs = (base + off_a, base + off_b)
    S = shards
    # one buffer for idx, n_live and words, one for nulls: no key leaves
    # words and nulls empty, and their pointers stay those of the buffers
    out = torch.empty(S * (k + 1 + nk * k), dtype=torch.int64, device=dev)
    n_buf = torch.empty(max(S * nk * k, 1), dtype=torch.uint8, device=dev)
    idx = out[:S * k].view(S, k)
    n_live = out[S * k:S * (k + 1)]
    words = out[S * (k + 1):].view(S, nk, k)
    nulls = n_buf[:S * nk * k].view(S, nk, k)
    words_p = out.data_ptr() + 8 * S * (k + 1)
    done = 0
    for r, (K, slots, levels) in enumerate(plan):
        for i, (blocks, fan) in enumerate(levels):
            final = i == len(levels) - 1
            rc = lib.shard_topk_level_launch(
                nk, int(i == 0), blocks, K, slots, S, L, mask.data_ptr(),
                karr.buffer_info()[0], bufs[(i - 1) % 2] if i else None,
                levels[i - 1][0] if i else 0, fan,
                None if final else bufs[i % 2], base + off_bound,
                int(r > 0 and i == 0), int(final), idx.data_ptr(),
                words_p, n_buf.data_ptr(), done, k,
                base + off_live, int(r == 0 and (i == 0 or final)),
                levels[0][0] // S, n_live.data_ptr(), stream)
            _ext.check(rc, "shard_topk")
            LAUNCHES["shard_topk"] += 1
        done += K
    return idx, n_live, words, nulls


def merge_topn_partials(idx, n_live, words, nulls, n_shards: int,
                        shard_len: int, limit: int) -> np.ndarray:
    """Host merge of K20's per-shard candidates (numpy) → global row
    indices, best first, at most `limit`: the candidates j < n_live[s] of
    every shard, lexsorted by each key's null rank then its order word
    (unsigned), the first key most significant, then the global row index
    idx + s * shard_len. The reference merges on -score (one key) or on
    negated keys (several); merging on the order words keeps NULL ranks,
    int64 extremes and BIGINT keys above 2^53 exact."""
    S, k = idx.shape
    take = np.arange(k)[None, :] < n_live.astype(np.int64)[:, None]
    gidx = (idx.astype(np.int64)
            + (np.arange(S, dtype=np.int64) * shard_len)[:, None])[take]
    sort_keys = [gidx]
    for j in reversed(range(words.shape[1])):
        sort_keys.append(words[:, j, :][take].view(np.uint64))
        sort_keys.append(nulls[:, j, :][take])
    return gidx[np.lexsort(sort_keys)][:limit]


# ---------------------------------------------------------------------------
# joins: K11 join_build, K12 join_probe, K13 dict_remap and their plain
# versions; join_match_pairs drives K11 + K12
# ---------------------------------------------------------------------------

def gather_plane(values: torch.Tensor, valid: torch.Tensor,
                 sel: torch.Tensor) -> tuple:
    """A batch plane gathered by a selection index on the plane's device
    (the reference's gather_plane): data movement, two index_selects."""
    return values.index_select(0, sel), valid.index_select(0, sel)


def join_build_plain(rkey: torch.Tensor, rvalid: torch.Tensor) -> tuple:
    rows = torch.nonzero(rvalid).squeeze(1)
    words, perm = torch.sort(orderable(rkey)[rows], stable=True)
    return words, rows[perm]


# the radix sort of K11 and K4's sorted route (ops/csrc/radix.cuh):
# digit width in bits, rows a tile
RADIX_BITS = 8
RADIX_TILE = 2048
# K11's tile and the fields of its summaries (ops/csrc/join_build.cu)
K11_TILE = 2048
K11_TILE_FIELDS = 8
K11_SUMMARY = 4
_U64 = (1 << 64) - 1


def radix_plan(varying: int, presorted: bool, parts: int = 1) -> list:
    """The passes of the stable LSD radix sort, lowest digit first, as
    (source, shift): source 0 the word's digit at `shift` of its unsigned
    image, 1 the digit of the row's partition (of `parts`). `varying`
    marks the bits in which the words differ (the OR of their unsigned
    images xor the AND): a digit with no such bit holds one value in every
    word and is skipped; the partition digits come last, as the most
    significant. A presorted sequence needs no pass."""
    if presorted:
        return []
    varying &= _U64
    plan = [(0, shift) for shift in range(0, 64, RADIX_BITS)
            if (varying >> shift) & ((1 << RADIX_BITS) - 1)]
    plan += [(1, shift) for shift in range(0, (parts - 1).bit_length(),
                                            RADIX_BITS)]
    return plan


def _radix_passes(n: int, plan: list, keys: int, pay: int, bufs: list,
                  offsets: torch.Tensor | None, dev: torch.device) -> int:
    """Launch the planned radix passes over raw pointers: keys / pay the
    inputs (pay 0: the row positions), pass i writing the (words,
    payloads) pointer pair bufs[i % 2]. Returns the index of the pair that
    holds the result."""
    if n >= 1 << 31:
        raise errors.DeviceError(f"{n} rows exceed the radix sort's 2^31")
    lib = _ext.lib("radix_sort")
    stream = _stream(dev)
    scratch = _stream_scratch("radix_sort", dev, 4 * int(
        lib.radix_scratch_ints(n)), stream)
    counts = scratch.data_ptr()
    off = 0 if offsets is None else offsets.data_ptr()
    P = 0 if offsets is None else offsets.shape[0] - 1
    for i, (source, shift) in enumerate(plan):
        k_out, p_out = bufs[i % 2]
        rc = lib.radix_pass_launch(n, shift, off if source else 0,
                                   P if source else 0, keys, pay, k_out,
                                   p_out, counts, stream)
        _ext.check(rc, "radix_pass")
        LAUNCHES["radix_pass"] += 1
        keys, pay = k_out, p_out
    return (len(plan) - 1) % 2


def radix_sort_plain(keys: torch.Tensor, pay, plan: list,
                     offsets: torch.Tensor | None = None) -> tuple:
    bits = (1 << RADIX_BITS) - 1
    perm = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    u = keys ^ I64_MIN                 # the unsigned image's bits
    for source, shift in plan:
        if source == 0:
            src = u[perm]
        else:
            rows = perm if pay is None else pay[perm]
            src = torch.searchsorted(offsets[:-1], rows, right=True) - 1
        perm = perm[torch.sort(_shr(src, shift) & bits, stable=True).indices]
    return keys[perm], (perm if pay is None else pay[perm])


def radix_sort_t(keys: torch.Tensor, pay, plan: list,
                 offsets: torch.Tensor | None = None) -> tuple:
    """The planned radix passes over card planes: (words, payloads) sorted
    stably. keys int64 [n]; pay int64 [n], or None for the row positions;
    offsets the P + 1 partition starts a source-1 pass reads. The inputs
    are left as they are."""
    if _device_kind(keys) == "cpu":
        return radix_sort_plain(keys, pay, plan, offsets)
    n = keys.shape[0]
    if not plan or n == 0:
        return keys, (pay if pay is not None else torch.arange(
            n, dtype=torch.int64, device=keys.device))
    buf = torch.empty((4, n), dtype=torch.int64, device=keys.device)
    rows = [buf[i].data_ptr() for i in range(4)]
    out = _radix_passes(n, plan, keys.data_ptr(),
                        0 if pay is None else pay.data_ptr(),
                        [rows[:2], rows[2:]], offsets, keys.device)
    return buf[2 * out], buf[2 * out + 1]


def join_build(rkey: torch.Tensor, rvalid: torch.Tensor) -> tuple:
    """K11: (words int64[n_valid], order int64[n_valid]) — the order words
    (`orderable`: -0.0 == +0.0) of the valid right keys, sorted stably, and
    the right row of each; equal keys keep right-scan order. On the card:
    K11's compaction, one readback of its summary, then the radix passes
    `radix_plan` names (none where the words arrive in order)."""
    if _device_kind(rvalid) == "cpu":
        return join_build_plain(rkey, rvalid)
    dev = rvalid.device
    n = rvalid.shape[0]
    _check_plane(rkey, n, (torch.int64, torch.float64), "build key", dev)
    _check_plane(rvalid, n, (torch.bool,), "build valid", dev)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty
    return _k11_sort(rkey, rvalid)


_K11_HOST: dict = {}


def _k11_host_summary(dev: torch.device, stream: int) -> tuple:
    """K11's summary in host memory, one per (device, stream): page-locked
    on a card, where the launch copies into it and waits for the stream.
    (the tensor, a ctypes view of its K11_SUMMARY int64, the lock a caller
    holds from its launch until it has read the view: threads that share
    a stream share the buffer)"""
    key = (dev.index, stream)
    ent = _K11_HOST.get(key)
    if ent is None:
        buf = torch.empty(K11_SUMMARY, dtype=torch.int64,
                          pin_memory=dev.type == "cuda")
        ent = _K11_HOST.setdefault(key, (buf, (
            ctypes.c_int64 * K11_SUMMARY).from_address(buf.data_ptr()),
            threading.Lock()))
    return ent


def _k11_sort(rkey: torch.Tensor, rvalid: torch.Tensor,
              offsets: torch.Tensor | None = None) -> tuple:
    """K11 over n >= 1 checked card planes: its launch, which reads its
    summary back (its one synchronisation), then the radix passes the
    summary plans (radix_plan: by (partition, word) with K21's `offsets`,
    the partition id's digits last). Returns (words, rows) sorted, plus,
    with offsets, each partition's start among them; the buffers and
    scratch are in place before the readback, and without partitions no
    tensor operation runs between it and the passes."""
    dev = rvalid.device
    n = rvalid.shape[0]
    lib = _ext.lib("join_build")
    nb = lib.join_build_blocks(n)
    stream = _stream(dev)
    scratch = _stream_scratch("join_build", dev, 8 * (
        nb * (K11_TILE_FIELDS + 1) + K11_SUMMARY), stream)
    tiles = scratch.data_ptr()
    offs = tiles + 8 * nb * K11_TILE_FIELDS
    host, summary, lock = _k11_host_summary(dev, stream)
    buf = torch.empty((4, n), dtype=torch.int64, device=dev)
    rows = [buf.data_ptr() + 8 * n * i for i in range(4)]
    with lock:
        rc = lib.join_build_launch(
            n, rkey.data_ptr(), rvalid.data_ptr(),
            int(rkey.dtype == torch.float64),
            0 if offsets is None else offsets.data_ptr(),
            0 if offsets is None else offsets.shape[0] - 1, tiles, offs,
            offs + 8 * nb, host.data_ptr(), rows[0], rows[1], stream)
        _ext.check(rc, "join_build")
        nv, o, a, presorted = summary
    LAUNCHES["join_build"] += 1
    plan = [] if presorted or nv < 2 else radix_plan(
        o ^ a, False, parts=1 if offsets is None else offsets.shape[0] - 1)
    res = buf[:, :nv]
    # partition p's words start after the valid rows of the partitions
    # before it: a search of the compacted rows, which ascend (enqueued
    # before the passes overwrite them)
    bounds = None if offsets is None else torch.searchsorted(res[1], offsets)
    # pass i writes pair 2 then 0 in turn: the compaction's buffers are
    # free once the first pass has read them
    out = 0 if not plan else 2 - 2 * _radix_passes(
        nv, plan, rows[0], rows[1], [rows[2:], rows[:2]], offsets, dev)
    if offsets is None:
        return res[out], res[out + 1]
    return res[out], res[out + 1], bounds


def join_probe_plain(words, order, lkey, lvalid) -> torch.Tensor:
    lw = orderable(lkey)
    lo = torch.searchsorted(words, lw)
    hi = torch.searchsorted(words, lw, right=True)
    counts = torch.where(lvalid, hi - lo, torch.zeros_like(lo))
    li = torch.repeat_interleave(
        torch.arange(lkey.shape[0], dtype=torch.int64, device=lkey.device),
        counts)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(li.shape[0], dtype=torch.int64,
                          device=lkey.device) - starts[li]
    return torch.stack([li, order[lo[li] + within]])


def join_probe(words: torch.Tensor, order: torch.Tensor, lkey: torch.Tensor,
               lvalid: torch.Tensor, shards: int = 1) -> tuple:
    """K12: (pairs, totals). pairs [2, total] — the (left row, right row)
    of every match of a valid left key among K11's sorted words, in
    left-scan order with ties in right-scan order; int32 on the card when
    both sides are shorter than 2^31, else int64. totals: host
    int64[shards], the pairs of each of `shards` contiguous blocks of the
    left rows, read off K12's count pass."""
    nl = lvalid.shape[0]
    if shards < 1 or nl % shards:
        raise errors.DeviceError(f"{nl} probe rows do not split into "
                                 f"{shards} shards")
    if _device_kind(lvalid) == "cpu":
        pairs = join_probe_plain(words, order, lkey, lvalid)
        return pairs, np.bincount(pairs[0].numpy() // max(nl // shards, 1),
                                  minlength=shards).astype(np.int64)
    dev = lvalid.device
    nv = words.shape[0]
    _check_plane(lkey, nl, (torch.int64, torch.float64), "probe key", dev)
    _check_plane(lvalid, nl, (torch.bool,), "probe valid", dev)
    _check_plane(words, nv, (torch.int64,), "build words", dev)
    _check_plane(order, nv, (torch.int64,), "build order", dev)
    return _k12(words, order, lkey, lvalid, dev, shards=shards)


# K12's workspace (the ticket and the tiles' tagged words) is kept per
# (device, stream) and never reset: each call takes its stream's next
# epoch under the lock, with its launch; the marks' offsets come back in a
# page-locked buffer per (device, stream), read under the same lock
K12_MAX_PARTS = 1024         # join_probe.cu: the partition starts it stages
_K12_EPOCH: dict = {}
_K12_HOST: dict = {}
_K12_LOCK = threading.Lock()


def k12_marks(nl: int, shards: int = 1, parts: int = 0) -> tuple:
    """(mark stride, marks) of K12's count: the rows whose offsets its
    last tiles write into the mapped host buffer. Segmented (parts > 0):
    the parts + 1 partition starts (the stride unused, 0); else the
    starts k * nl / shards of the shards, k = 0..shards, the last (nl)
    holding the grand total."""
    if parts:
        return 0, parts + 1
    return nl // shards, shards + 1


def _k12(words, order, lkey, lvalid, dev, shards: int = 1, loff=None,
         bounds=None, lsel=None) -> tuple:
    """K12's two launches over checked card planes: the count (it waits
    for the stream; the marks' offsets read from mapped page-locked
    memory), then the expand into an output of the exact total. Returns
    (pairs [2, total], the pairs of each shard or partition)."""
    nl, nv = lvalid.shape[0], words.shape[0]
    narrow = nl < (1 << 31) and nv < (1 << 31)
    dt = torch.int32 if narrow else torch.int64
    parts = 0 if loff is None else loff.shape[0] - 1
    stride, nmarks = k12_marks(nl, shards, parts)
    if nl == 0:
        return (torch.empty((2, 0), dtype=dt, device=dev),
                np.zeros(nmarks - 1, np.int64))
    lib = _ext.lib("join_probe")
    st = _stream(dev)
    # lo int32 where the build side is under 2^31 words; the build words'
    # sample every 2^shift-th word, one fewer than the cap at most
    lo_bytes = 4 if narrow else 8
    shift = sample_shift(nv, lib.join_probe_sample_cap() - 1)
    # the count's two planes, the offsets (int64) then lo, in one block
    planes = torch.empty(nl * (8 + lo_bytes), dtype=torch.uint8, device=dev)
    offs = planes.data_ptr()
    lo = offs + 8 * nl
    ws = _stream_scratch("join_probe", dev,
                         lib.join_probe_workspace_bytes(nl), st)
    key = (dev.index, st)
    what = "join_probe" if loff is None else "join_probe segmented"
    with _K12_LOCK:
        host = _K12_HOST.get(key)
        if host is None or host.numel() < nmarks:
            host = _K12_HOST[key] = torch.empty(max(nmarks, 64),
                                                dtype=torch.int64,
                                                pin_memory=True)
        epoch = _K12_EPOCH[key] = _K12_EPOCH.get(key, 0) + 1
        rc = lib.join_probe_count_launch(
            nl, lkey.data_ptr(), lvalid.data_ptr(),
            int(lkey.dtype == torch.float64), words.data_ptr(), nv,
            None if loff is None else loff.data_ptr(),
            None if bounds is None else bounds.data_ptr(), parts, shift,
            lo_bytes, lo, offs, stride, nmarks, ws.data_ptr(),
            epoch, host.data_ptr(), st)
        _ext.check(rc, what)
        starts = host[:nmarks].numpy().copy()
    LAUNCHES["join_probe" if loff is None else "join_probe_seg"] += 1
    total = int(starts[-1])
    out = torch.empty(2 * total, dtype=dt, device=dev)
    if total:
        rc = lib.join_probe_expand_launch(
            total, nl, lo_bytes, lo, offs, order.data_ptr(),
            None if lsel is None else lsel.data_ptr(), int(narrow),
            out.data_ptr(), st)
        _ext.check(rc, what + " expand")
    return out.view(2, total), np.diff(starts)


def join_match_pairs(lkey, lvalid, rkey, rvalid, stats: dict | None = None,
                     device_keys=None, device=None, shards: int = 1
                     ) -> tuple:
    """(l_idx, r_idx) int64 numpy match pairs of an equi-join on one int64
    or f64 key, in left-scan order with ties in right-scan order: K11 over
    the right keys, K12 over the left, one readback of the pairs. The key
    planes come as host numpy (copied to `device`) or, with
    `device_keys` = (lkey, lvalid, rkey, rvalid), as tensors already on the
    device (the host planes are then not read and may be None). With
    `shards` > 1 dividing the left capacity (bucket_capacity of the left
    rows) the probe is sharded, the reference's mesh probe: the left
    planes padded to the capacity with invalid rows and cut into that
    many contiguous blocks, the same pairs. `stats` receives build_s,
    probe_s, n_pairs, mesh_shards (1 where the probe was not sharded) and
    shard_pairs (the pairs of each block)."""
    if device_keys is None:
        dev = _device(device)
        with phase("h2d", dev):
            device_keys = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (lkey, lvalid, rkey, rvalid))
    lk, lv, rk, rv = device_keys
    dev = lv.device
    if lk.dtype != rk.dtype:
        raise errors.DeviceError(f"join keys of {lk.dtype} and {rk.dtype}")
    t0 = time.perf_counter()
    with phase("k11", dev):
        words, order = join_build(rk, rv)
    t1 = time.perf_counter()
    n = lv.shape[0]
    lcap = col.bucket_capacity(n)
    if shards > 1 and lcap % shards == 0:
        if n < lcap:
            lk = torch.cat([lk, lk.new_zeros(lcap - n)])
            lv = torch.cat([lv, lv.new_zeros(lcap - n)])
    else:
        shards = 1
    with phase("k12", dev):
        pairs, totals = join_probe(words, order, lk, lv, shards)
    with phase("pairs_readback", dev):
        host = pairs.cpu().numpy()
    l_idx = host[0].astype(np.int64)
    r_idx = host[1].astype(np.int64)
    if stats is not None:
        stats["mesh_shards"] = shards
        stats["shard_pairs"] = totals
        stats["build_s"] = t1 - t0
        stats["probe_s"] = time.perf_counter() - t1
        stats["n_pairs"] = len(l_idx)
    return l_idx, r_idx


# ---------------------------------------------------------------------------
# the key-partitioned probe: K21 key_partition, K11 within partitions, K12
# in its partition-segmented mode, and their plain versions
# ---------------------------------------------------------------------------

# the most partitions and rows K21 takes (ops/csrc/key_partition.cu
# K21_MAX_PARTS, K21_MAX_ROWS: its counts and places are int32)
KEY_PARTITIONS_MAX = 1024
K21_MAX_ROWS = (1 << 31) - 1

_M1, _M2, _M3 = (np.uint64(c).astype(np.int64).item() for c in (
    0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB))


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def partition_codes_t(key: torch.Tensor, valid: torch.Tensor,
                      parts: int) -> torch.Tensor:
    """The radix partition of each row (int64 [n], the reference's
    membudget.partition_codes): ops.mesh._mix64 (splitmix64) over the key's
    int64 image (f64: its bits, -0.0 made +0.0) modulo parts, in wrapping
    int64 arithmetic; NULL rows in partition 0."""
    if key.dtype == torch.float64:
        x = torch.where(key == 0.0, torch.zeros_like(key), key) \
            .view(torch.int64)
    else:
        x = key.to(torch.int64)
    x = x + _M1
    x = (x ^ _shr(x, 30)) * _M2
    x = (x ^ _shr(x, 27)) * _M3
    x = x ^ _shr(x, 31)
    # the unsigned remainder: u = 2 * (u >> 1) + (u & 1)
    part = (2 * (_shr(x, 1) % parts) + (x & 1)) % parts
    return torch.where(valid, part, torch.zeros_like(part))


def key_partition_plain(key: torch.Tensor, valid: torch.Tensor,
                        parts: int) -> tuple:
    codes = partition_codes_t(key, valid, parts)
    sel = torch.sort(codes, stable=True).indices
    counts = torch.bincount(codes, minlength=parts)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return sel, offsets


def key_partition(key: torch.Tensor, valid: torch.Tensor,
                  parts: int) -> tuple:
    """K21: (sel int64[n], offsets int64[parts + 1]) — the rows in
    partition-major order, stable (rows of a partition in row order), and
    where each partition starts; a row's partition is
    membudget.partition_codes of its key. On the card one counting pass
    of radix.cuh's shape with the partition as the digit (three
    launches); at most K21_MAX_ROWS rows."""
    if not 1 <= parts <= KEY_PARTITIONS_MAX:
        raise errors.DeviceError(f"{parts} partitions (1 to "
                                 f"{KEY_PARTITIONS_MAX})")
    if _device_kind(valid) == "cpu":
        return key_partition_plain(key, valid, parts)
    dev = valid.device
    n = valid.shape[0]
    if n > K21_MAX_ROWS:
        raise errors.DeviceError(f"key_partition over {n} rows (at most "
                                 f"{K21_MAX_ROWS})")
    _check_plane(key, n, (torch.int64, torch.float64), "partition key", dev)
    _check_plane(valid, n, (torch.bool,), "partition valid", dev)
    sel = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return sel, torch.zeros(parts + 1, dtype=torch.int64, device=dev)
    offsets = torch.empty(parts + 1, dtype=torch.int64, device=dev)
    lib = _ext.lib("key_partition")
    counts = torch.empty(lib.key_partition_scratch_ints(n, parts),
                         dtype=torch.int32, device=dev)
    rc = lib.key_partition_launch(
        n, key.data_ptr(), valid.data_ptr(), int(key.dtype == torch.float64),
        parts, counts.data_ptr(), sel.data_ptr(), offsets.data_ptr(),
        _stream(dev))
    _ext.check(rc, "key_partition")
    LAUNCHES["key_partition"] += 1
    return sel, offsets


def join_build_partitioned_plain(rkey: torch.Tensor, rvalid: torch.Tensor,
                                 offsets: torch.Tensor) -> tuple:
    rows = torch.nonzero(rvalid).squeeze(1)
    words = orderable(rkey)[rows]
    part = torch.searchsorted(offsets, rows, right=True) - 1
    perm, _last = lexsort_plain([words, part])
    return words[perm], rows[perm], torch.searchsorted(rows, offsets)


def join_build_partitioned(rkey: torch.Tensor, rvalid: torch.Tensor,
                           offsets: torch.Tensor) -> tuple:
    """K11 over partition-major build planes (K21's layout, `offsets` its
    partition starts): (words, order, bounds) — the valid rows' order words
    sorted within each partition, stably; each word's row (a position in
    the partition-major planes); partition p's words at [bounds[p],
    bounds[p + 1]). On the card: K11's compaction (its summary orders
    (partition, word) pairs), then the radix passes over the word's varying
    digits and the partition id's digits as the most significant (none
    where each partition's words arrive in order); bounds by a search of
    the compacted rows, which ascend."""
    if _device_kind(rvalid) == "cpu":
        return join_build_partitioned_plain(rkey, rvalid, offsets)
    dev = rvalid.device
    n = rvalid.shape[0]
    _check_plane(rkey, n, (torch.int64, torch.float64), "build key", dev)
    _check_plane(rvalid, n, (torch.bool,), "build valid", dev)
    _check_plane(offsets, offsets.shape[0], (torch.int64,), "offsets", dev)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty, torch.zeros_like(offsets)
    return _k11_sort(rkey, rvalid, offsets)


def join_probe_partitioned_plain(words, order, bounds, lkey, lvalid, loff,
                                 lsel) -> tuple:
    n = lkey.shape[0]
    P = loff.shape[0] - 1
    lw = orderable(lkey)
    lo = torch.zeros(n, dtype=torch.int64, device=lkey.device)
    cnt = torch.zeros(n, dtype=torch.int64, device=lkey.device)
    lb, bb = loff.tolist(), bounds.tolist()
    for p in range(P):
        a, b = lb[p], lb[p + 1]
        if a == b:
            continue
        seg = words[bb[p]:bb[p + 1]]
        lo[a:b] = torch.searchsorted(seg, lw[a:b]) + bb[p]
        hi = torch.searchsorted(seg, lw[a:b], right=True) + bb[p]
        cnt[a:b] = torch.where(lvalid[a:b], hi - lo[a:b],
                               torch.zeros_like(hi))
    li = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=lkey.device), cnt)
    starts = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(li.shape[0], dtype=torch.int64,
                          device=lkey.device) - starts[li]
    ends = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, 0)])[loff]
    return (torch.stack([lsel[li], order[lo[li] + within]]),
            torch.diff(ends).cpu().numpy())


def join_probe_partitioned(words: torch.Tensor, order: torch.Tensor,
                           bounds: torch.Tensor, lkey: torch.Tensor,
                           lvalid: torch.Tensor, loff: torch.Tensor,
                           lsel: torch.Tensor) -> tuple:
    """K12 in its partition-segmented mode: (pairs, totals). The probe
    planes are partition-major (K21's layout, `loff` the partition starts,
    `lsel` the global row of each position); probe position i of
    partition p searches only p's build words [bounds[p], bounds[p + 1]).
    pairs [2, total]: (global left row lsel[i], right row order[k]) of
    every match, in partition-major probe order with ties in the order
    `order` gives; int32 on the card when both sides are shorter than
    2^31, else int64. totals: host int64[P], the pairs of each partition,
    read off the count pass."""
    P = loff.shape[0] - 1
    if _device_kind(lvalid) == "cpu":
        return join_probe_partitioned_plain(words, order, bounds, lkey,
                                            lvalid, loff, lsel)
    dev = lvalid.device
    nl, nv = lvalid.shape[0], words.shape[0]
    _check_plane(lkey, nl, (torch.int64, torch.float64), "probe key", dev)
    _check_plane(lvalid, nl, (torch.bool,), "probe valid", dev)
    _check_plane(lsel, nl, (torch.int64,), "probe rows", dev)
    _check_plane(words, nv, (torch.int64,), "build words", dev)
    _check_plane(order, nv, (torch.int64,), "build order", dev)
    _check_plane(loff, P + 1, (torch.int64,), "probe offsets", dev)
    _check_plane(bounds, P + 1, (torch.int64,), "build bounds", dev)
    if P > K12_MAX_PARTS:
        raise errors.DeviceError(f"K12 takes at most {K12_MAX_PARTS} "
                                 f"partitions, got {P}")
    return _k12(words, order, lkey, lvalid, dev, loff=loff, bounds=bounds,
                lsel=lsel)


# K13 per-column modes: the contract with ops/csrc/dict_remap.cu
REMAP_CODES, REMAP_TABLE, REMAP_DOMAIN = range(3)
_REMAP_MODES = {"codes": REMAP_CODES, "remap": REMAP_TABLE,
                "domain": REMAP_DOMAIN}


class RemapCol:
    """One key column of K13: its mode, value and valid planes, its table
    (remap: local code → domain code; domain: the sorted values; None for
    codes), the largest code and its mixed-radix stride."""

    __slots__ = ("mode", "values", "valid", "table", "cmax", "stride")

    def __init__(self, mode: int, values, valid, table, cmax: int,
                 stride: int):
        self.mode = mode
        self.values = values
        self.valid = valid
        self.table = table
        self.cmax = cmax
        self.stride = stride


def domain_words(v: torch.Tensor) -> torch.Tensor:
    """The order words a domain is searched by: an int64 plane as it is;
    an f64 plane's orderable image with every NaN made the one positive
    NaN first, so NaN sorts after +inf (as numpy and the reference sort
    it) and -0.0 is +0.0."""
    if v.dtype != torch.float64:
        return v
    return orderable(torch.where(torch.isnan(v), torch.full_like(v, np.nan),
                                 v))


def dict_remap_plain(cols: list, n: int) -> tuple:
    dev = cols[0].valid.device
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    for c in cols:
        if c.mode == REMAP_CODES:
            code = c.values.clamp(0, c.cmax)
        elif c.mode == REMAP_TABLE:
            tlen = c.table.shape[0]
            code = c.table[c.values.clamp(0, tlen - 1)].clamp(0, c.cmax) \
                if tlen else torch.zeros(n, dtype=torch.int64, device=dev)
        else:
            code = torch.searchsorted(domain_words(c.table),
                                      domain_words(c.values)).clamp(0, c.cmax)
        key += code * c.stride
        valid &= c.valid
    return key, valid


# K13's kernel modes and packed column (ops/csrc/dict_remap.cu K13Mode,
# dict_remap_launch): mode, values, valid, table, table length, cmax,
# stride, sample shift, staged entries, their first word in shared
# memory, the search's steps
K13_CODES, K13_REMAP, K13_DOM_I64, K13_DOM_F64 = range(4)
K13_WORDS = 11
_K13_CONFIG: dict = {}


def sample_shift(n: int, cap: int) -> int:
    """The shift s of a sample of every 2^s-th of n elements that holds at
    most cap entries: K12's over the build words, K13's over a domain
    (sample_search.cuh searches it)."""
    s = 0
    while -(-n >> s) > cap:
        s += 1
    return s


def k13_config(lib) -> tuple:
    """(most columns a launch, shared-memory bytes, sample entries at most
    a column, words a column) of a K13 library."""
    got = _K13_CONFIG.get(id(lib))
    if got is None:
        buf = (ctypes.c_int64 * 4)()
        lib.dict_remap_config(ctypes.addressof(buf))
        got = _K13_CONFIG[id(lib)] = tuple(int(x) for x in buf)
    return got


def k13_plan(cols: list, config: tuple) -> list:
    """K13's launches over `cols`: [(packed words, shared-memory bytes,
    columns)], one launch per `config`'s most columns, each after the
    first adding to the planes before it. A launch stages its tables in
    ascending length: whole where the room left holds them, else (a
    domain) a sample of every 2^s-th entry of at most the sample cap and
    the room left; a remap table too large to stage, or a table past the
    room, is read where it lies."""
    max_cols, smem, sample_cap, _words = config
    out = []
    for g in range(0, len(cols), max_cols):
        grp = cols[g:g + max_cols]
        tlen = [0 if c.mode == REMAP_CODES else c.table.shape[0] for c in grp]
        staged, used = {}, 0
        for j in sorted((j for j in range(len(grp)) if tlen[j]),
                        key=lambda j: (tlen[j], j)):
            room = smem // 8 - used
            if room < 1:
                break
            if tlen[j] <= room:
                staged[j] = (0, tlen[j], used)
            elif grp[j].mode == REMAP_DOMAIN:
                sh = sample_shift(tlen[j], min(sample_cap, room))
                staged[j] = (sh, -(-tlen[j] >> sh), used)
            else:
                continue
            used += staged[j][1]
        words = []
        for j, c in enumerate(grp):
            if c.mode == REMAP_DOMAIN:
                mode = K13_DOM_F64 if c.values.dtype == torch.float64 \
                    else K13_DOM_I64
            else:
                mode = K13_REMAP if c.mode == REMAP_TABLE else K13_CODES
            sh, ns, soff = staged.get(j, (0, 0, 0))
            words += [mode, c.values.data_ptr(), c.valid.data_ptr(),
                      c.table.data_ptr() if tlen[j] else 0, tlen[j], c.cmax,
                      c.stride, sh, ns, soff,
                      int(ns if ns else tlen[j]).bit_length()]
        out.append((words, 8 * used, len(grp)))
    return out


def dict_remap(cols: list, n: int) -> tuple:
    """K13: (key int64[n], valid bool[n]) — the composite key-tuple code of
    one join side, the sum over its key columns of code * stride, and the
    AND of their valid planes. On the card the columns ride by value in
    the launch's parameters (k13_plan): nothing is copied to the card."""
    if not cols:
        raise errors.DeviceError("dict_remap needs a key column")
    if _device_kind(cols[0].valid) == "cpu":
        return dict_remap_plain(cols, n)
    dev = cols[0].valid.device
    for j, c in enumerate(cols):
        _check_plane(c.valid, n, (torch.bool,), f"key {j} valid", dev)
        if c.mode == REMAP_CODES or c.mode == REMAP_TABLE:
            _check_plane(c.values, n, (torch.int64,), f"key {j} codes", dev)
        else:
            _check_plane(c.values, n, (torch.int64, torch.float64),
                         f"key {j} values", dev)
        if c.mode != REMAP_CODES:
            want = torch.int64 if c.mode == REMAP_TABLE else c.values.dtype
            _check_plane(c.table, c.table.shape[0], (want,), f"key {j} table",
                         dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return key, valid
    lib = _ext.lib("dict_remap")
    st = _stream(dev)
    for i, (words, smem, ncols) in enumerate(k13_plan(cols, k13_config(lib))):
        buf = array.array("q", words)
        rc = lib.dict_remap_launch(n, ncols, buf.buffer_info()[0], smem,
                                   int(i > 0), key.data_ptr(),
                                   valid.data_ptr(), st)
        _ext.check(rc, "dict_remap")
        LAUNCHES["dict_remap"] += 1
    return key, valid


def remap_cols(specs: list, device) -> list:
    """copr.dictionary KeySpecs (host numpy planes and tables) as K13's
    columns on `device`."""
    dev = _device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return [RemapCol(_REMAP_MODES[s.mode], t(s.values), t(s.valid),
                     None if s.mode == "codes" else t(s.table),
                     max(s.size - 1, 0), int(s.stride)) for s in specs]


def dict_remap_keys(specs: list, n: int, device) -> tuple:
    """The composite key plane of one join side on `device` (the
    reference's dict_remap_keys): its KeySpecs through K13."""
    return dict_remap(remap_cols(specs, device), n)


# ---------------------------------------------------------------------------
# K1 expr_vm
# ---------------------------------------------------------------------------

def _device_kind(t: torch.Tensor) -> str:
    if t.device.type == "cpu":
        return "cpu"
    if t.device.type == "cuda":
        return "cuda"
    raise errors.DeviceError(f"no kernel for device {t.device}")


def _check_plane(t: torch.Tensor, n: int, dtypes, what: str, device) -> None:
    if t.device == device and t.dtype in dtypes and t.shape == (n,) \
            and t.is_contiguous():
        return
    if t.device != device:
        raise errors.DeviceError(f"{what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise errors.DeviceError(f"{what} of dtype {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise errors.DeviceError(f"{what} must be a contiguous [{n}] plane")


def _device(device) -> torch.device:
    """A torch.device with its index: "cuda" means the current card, so
    that it compares equal to the device of the tensors on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _stream(device) -> int:
    """The raw handle of the device's current stream (torch's own binding
    where it has one: a Stream object costs microseconds a launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    dev = torch.device(device)
    if raw is None or dev.type != "cuda":
        return torch.cuda.current_stream(device).cuda_stream
    return raw(torch.cuda.current_device() if dev.index is None
               else dev.index)


def _check_program_planes(fin: Finalized, plane_list: list,
                          live: torch.Tensor) -> None:
    dev = live.device
    n = live.shape[0]
    _check_plane(live, n, (torch.bool,), "live plane", dev)
    if len(plane_list) != len(fin.plane_keys):
        raise errors.DeviceError("plane list does not match the program")
    for key_which, t in zip(fin.plane_keys, plane_list):
        try:
            _check_plane(t, n, _VALID_DTYPES if key_which[1]
                         else _VALUE_DTYPES, "plane", dev)
        except errors.DeviceError as e:
            raise errors.DeviceError(f"{e} ({key_which})") from None


_VALID_DTYPES = (torch.bool,)
_VALUE_DTYPES = (torch.int64, torch.float64)


def expr_vm(fin: Finalized, plane_list: list, live: torch.Tensor,
            want_gid: bool):
    """K1: (mask bool[n], gid int64[n] | None, [(values, valid)] per
    program output). On the card one launch: the table (k1_pack) by value
    in the launch's parameters, or past K5_PARAM_WORDS copied once from
    page-locked staging (`_table_launch`, K5's)."""
    if _device_kind(live) == "cpu":
        mask, gid, values = run_program_plain(fin, plane_list, live)
        return mask, (gid if want_gid else None), values
    launch, outputs = k1_prepare(fin, plane_list, live, want_gid)
    launch()
    return outputs()


def k1_prepare(fin: Finalized, plane_list: list, live: torch.Tensor,
               want_gid: bool) -> tuple:
    """Everything of a K1 launch on the card but the launch: checks, the
    outputs allocated (one buffer: the mask and the outputs' valid
    planes, then from a 16-byte boundary the outputs' values and the
    group id, a row each), the table packed. Returns (launch, outputs);
    outputs() gives (mask, gid, values), its views made after the launch
    is queued."""
    dev = live.device
    n = live.shape[0]
    _check_program_planes(fin, plane_list, live)
    if bool(int(fin.meta[3])) != want_gid:
        raise errors.DeviceError("group id requested without group planes")
    if fin.meta.shape[0] > K1_MAX_META:
        raise errors.DeviceError(f"a program of {fin.meta.shape[0]} words "
                                 f"exceeds K1's {K1_MAX_META}")
    k, g = len(fin.out_dts), int(want_gid)
    nb = (k + 1) * n
    at = nb + (-nb % 16)
    buf = torch.empty((at + 8 * (k + g) * n,), dtype=torch.uint8,
                      device=dev)
    fp = buf.data_ptr()
    wp = fp + at
    out_ptrs = []
    for j in range(k):
        out_ptrs += (wp + 8 * j * n, fp + (j + 1) * n)
    words = k1_pack(fin, n, live.data_ptr(), wp + 8 * k * n if g else 0,
                    out_ptrs, [t.data_ptr() for t in plane_list])
    fn = _ext.lib("expr_vm").expr_vm_launch

    def launch():
        _table_launch(fn, K1_ROUTES, words, dev, fp)

    def outputs():
        fl = buf[:nb].view(torch.bool).view(k + 1, n).unbind(0)
        w8 = buf[at:].view(torch.int64).view(k + g, n).unbind(0)
        values = [(w8[j].view(torch.float64) if dt == "f" else w8[j],
                   fl[j + 1]) for j, dt in enumerate(fin.out_dts)]
        return fl[0], (w8[k] if g else None), values

    return launch, outputs


# K1's table (ops/csrc/expr_vm.cu, the contract with k1_pack): K1_T_HDR
# header words, the output and plane pointers, then the program's
# instructions, output registers and group slots, its pool and its LUT
# bytes. A program (exprc's meta) holds at most K1_MAX_META words
# (common.cuh). Each route counts under its own LAUNCHES key
K1_T_HDR = 17
K1_MAX_META = 1024
K1_ROUTES = ("expr_vm", "expr_vm_packed")


def _k1_program(fin: Finalized) -> tuple:
    """(registers, words before the pool, pool words, the table's tail
    bytes: instructions, output registers, group slots, pool, LUT) of a
    program, kept on it."""
    got = getattr(fin, "_k1_program", None)
    if got is None:
        meta = fin.meta
        n_instr, where, n_out, n_group = (int(x) for x in meta[:4])
        body = meta[HDR:HDR + 6 * n_instr + n_out + 4 * n_group]
        dsts = body[1:6 * n_instr:6].tolist()
        oregs = body[6 * n_instr:6 * n_instr + n_out].tolist()
        n_regs = max(dsts + oregs + [where], default=-1) + 1
        lut = fin.lut.tobytes()
        tail = body.tobytes() + fin.pool.tobytes() + lut \
            + bytes(-len(lut) % 8)
        got = fin._k1_program = (n_regs, body.shape[0], fin.pool.shape[0],
                                 tail)
    return got


def k1_pack(fin: Finalized, n: int, live_ptr: int, gid_ptr: int,
            out_ptrs: list, plane_ptrs: list):
    """K1's table for n rows in one host pass (an int64 array): the
    header, the outputs' (values, valid) pointers, the planes' pointers,
    then the program's words (kept on the program)."""
    n_regs, n_body, n_pool, tail = _k1_program(fin)
    meta = fin.meta
    n_instr, n_out = int(meta[0]), int(meta[2])
    off_planes = K1_T_HDR + len(out_ptrs)
    off_ins = off_planes + len(plane_ptrs)
    off_pool = off_ins + n_body
    words = array.array("q", (
        n, -(-n // K5_TILE), n_instr, int(meta[1]), n_out, int(meta[3]),
        int(meta[4]), n_regs, live_ptr, gid_ptr, K1_T_HDR, off_planes,
        off_ins, off_ins + 6 * n_instr, off_ins + 6 * n_instr + n_out,
        off_pool, off_pool + n_pool))
    words.extend(out_ptrs)
    words.extend(plane_ptrs)
    words.frombytes(tail)
    return words


def param_block(n_words: int) -> str:
    """Where a K1 or K5 table of n_words rides: the smaller parameter
    block (4 KB), the larger (31 KB), or packed into a device buffer."""
    if n_words <= K5_SMALL_WORDS:
        return "small"
    return "large" if n_words <= K5_PARAM_WORDS else "packed"


# the packed route's page-locked staging buffer per device (K1 and K5
# share it) and the event of the last copy out of it
_K5_STAGE: dict = {}
_K5_LOCK = threading.Lock()


def _table_launch(fn, routes: tuple, words, dev: torch.device,
                  out_ptr: int) -> None:
    """One launch of a table kernel (K1, K5): `fn(words, n_words,
    dev_words, out, stream)` with the table by value, or past
    K5_PARAM_WORDS (routes[1]) copied from the reused page-locked staging
    buffer into the stream's buffer (waiting first for the buffer's last
    copy). Counts the launch under its route."""
    n = len(words)
    st = _stream(dev)
    route = routes[param_block(n) == "packed"]
    if route == routes[0]:
        rc = fn(words.buffer_info()[0], n, None, out_ptr, st)
    else:
        with _K5_LOCK:
            stage, ev = _K5_STAGE.get(dev.index, (None, None))
            if ev is not None:
                ev.synchronize()   # its last copy has left the buffer
            if stage is None or stage.numel() < n:
                stage = torch.empty(max(n, 2 * K5_PARAM_WORDS),
                                    dtype=torch.int64, pin_memory=True)
                ev = torch.cuda.Event()
            ctypes.memmove(stage.data_ptr(), words.buffer_info()[0], 8 * n)
            buf = _stream_scratch(route, dev, 8 * n, st)
            rc = fn(stage.data_ptr(), n, buf.data_ptr(), out_ptr, st)
            ev.record(torch.cuda.current_stream(dev))
            _K5_STAGE[dev.index] = (stage, ev)
    _ext.check(rc, route)
    LAUNCHES[route] += 1


# ---------------------------------------------------------------------------
# K2 / K3 / K4 and their plain version
# ---------------------------------------------------------------------------

def _check_reds(reds: list[Red], n: int, device) -> None:
    """The reductions' planes checked (an f64 op over f64 values, an
    integer op over int64, contiguous [n] planes on the device), each
    distinct plane once."""
    seen = set()
    for red in reds:
        if red.values is not None:
            want = torch.float64 if red.op in F_OPS else torch.int64
            if red.values.dtype != want and red.op != R_COUNT:
                raise errors.DeviceError(
                    f"reduction op {red.op} over {red.values.dtype}")
            if id(red.values) not in seen:
                seen.add(id(red.values))
                _check_plane(red.values, n, (torch.int64, torch.float64),
                             "reduction values", device)
        if red.valid is not None and id(red.valid) not in seen:
            seen.add(id(red.valid))
            _check_plane(red.valid, n, (torch.bool,), "reduction valid",
                         device)


def _red_rows(reds: list[Red], n: int, device) -> list:
    """Each reduction's descriptor (op, flags, const_bits, values pointer,
    valid pointer), its planes checked."""
    _check_reds(reds, n, device)
    return [[red.op, (RED_CONST if red.values is None else 0)
             | (RED_NEVER if red.never else 0), red.const_bits,
             0 if red.values is None else red.values.data_ptr(),
             0 if red.valid is None else red.valid.data_ptr()]
            for red in reds]


def _red_desc(reds: list[Red], n: int, device) -> torch.Tensor:
    """The descriptor table of K4's sorted pass on the device."""
    return torch.tensor(_red_rows(reds, n, device),
                        dtype=torch.int64).reshape(-1).to(device)


# K2's parameter block (scalar_agg.cu: struct K2Red, K2_MAX_REDS): the
# descriptors ride by value, at most K2_MAX_REDS a launch; each field is
# 8 bytes (int64 or a pointer), packed in this order
K2_MAX_REDS = 64
K2_RED_FIELDS = ("op", "flags", "const_bits", "values", "valid")


_K2_GRID: dict = {}    # device index -> the launch grid's most blocks


def scalar_agg_chunks(n_red: int) -> list:
    """K2's launches for n_red reductions: [start, stop) spans of at most
    K2_MAX_REDS, in order."""
    return [(a, min(a + K2_MAX_REDS, n_red))
            for a in range(0, n_red, K2_MAX_REDS)]


def _red_inputs(red: Red, n: int, mask: torch.Tensor):
    """(contrib bool[n], x typed[n]) of one reduction, plain version."""
    dev = mask.device
    if red.op == R_FIRST:
        return mask, torch.arange(n, dtype=torch.int64, device=dev)
    if red.never:
        contrib = torch.zeros(n, dtype=torch.bool, device=dev)
    elif red.valid is None:
        contrib = mask
    else:
        contrib = mask & red.valid
    if red.values is None:
        x = torch.full((n,), red.const_bits, dtype=torch.int64, device=dev)
        if red.op in F_OPS:
            x = x.view(torch.float64)
    else:
        x = red.values
    return contrib, x


def _sentinel(op: int):
    """The identity of an extremum (common.cuh val_ident): the exact
    int64 bounds, and +-inf for f64, which no value beats: a group of only
    +inf (MIN) or -inf (MAX) answers it, as numpy does. Empty groups are
    NULL by their counts, never by comparison with it."""
    return {R_MIN_I: I64_MAX, R_FIRST: I64_MAX, R_MAX_I: I64_MIN,
            R_MIN_F: float("inf"), R_MAX_F: float("-inf")}[op]


def scalar_agg_plain(mask: torch.Tensor, reds: list[Red]):
    n_rows = mask.shape[0]
    ns, accs = [], []
    for red in reds:
        contrib, x = _red_inputs(red, n_rows, mask)
        ns.append(contrib.sum(dtype=torch.int64))
        if red.op == R_COUNT:
            acc = torch.zeros((), dtype=torch.int64, device=mask.device)
        elif red.op in (R_SUM_I, R_SUM_F):
            acc = torch.where(contrib, x, torch.zeros_like(x)).sum()
        else:
            fill = torch.full_like(x, _sentinel(red.op))
            vv = torch.where(contrib, x, fill)
            acc = vv.min() if red.op in (R_MIN_I, R_MIN_F, R_FIRST) \
                else vv.max()
        if acc.dtype == torch.float64:
            acc = acc.view(torch.int64)
        accs.append(acc.to(torch.int64))
    return torch.stack(ns), torch.stack(accs)


def seg_agg_plain(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
                  reds: list[Red]):
    n_rows = mask.shape[0]
    dev = mask.device
    ns, accs = [], []
    for red in reds:
        contrib, x = _red_inputs(red, n_rows, mask)
        ns.append(torch.zeros(num_segments, dtype=torch.int64, device=dev)
                  .index_add_(0, gid, contrib.to(torch.int64)))
        if red.op == R_COUNT:
            acc = torch.zeros(num_segments, dtype=torch.int64, device=dev)
        elif red.op in (R_SUM_I, R_SUM_F):
            acc = torch.zeros(num_segments, dtype=x.dtype, device=dev) \
                .index_add_(0, gid, torch.where(contrib, x,
                                                torch.zeros_like(x)))
        else:
            s = _sentinel(red.op)
            how = "amin" if red.op in (R_MIN_I, R_MIN_F, R_FIRST) else "amax"
            acc = torch.full((num_segments,), s, dtype=x.dtype, device=dev) \
                .scatter_reduce_(0, gid, torch.where(
                    contrib, x, torch.full_like(x, s)), how)
        if acc.dtype == torch.float64:
            acc = acc.view(torch.int64)
        accs.append(acc)
    return torch.stack(ns), torch.stack(accs)


def scalar_agg(mask: torch.Tensor, reds: list[Red]):
    """K2: (n int64[R], acc int64[R]) — acc holds f64 bits for f64 ops.
    On the card one launch per scalar_agg_chunks span."""
    if _device_kind(mask) == "cpu":
        return scalar_agg_plain(mask, reds)
    dev = mask.device
    n = mask.shape[0]
    _check_plane(mask, n, (torch.bool,), "mask", dev)
    if not reds:
        raise errors.DeviceError("K2 needs at least one reduction")
    descs = array.array("q", [x for row in _red_rows(reds, n, dev)
                              for x in row])
    lib = _ext.lib("scalar_agg")
    grid = _K2_GRID.get(dev.index)
    if grid is None:
        grid = _K2_GRID[dev.index] = lib.scalar_agg_grid()
        if grid <= 0:
            del _K2_GRID[dev.index]
            raise errors.DeviceError(f"scalar_agg_grid failed with CUDA "
                                     f"error {-grid}")
    stream = _stream(dev)
    # the ticket (8 bytes), then the partials: 2 int64 per reduction and
    # block
    base = _stream_scratch("scalar_agg", dev, 8 + grid * K2_MAX_REDS * 16,
                           stream).data_ptr()
    R = len(reds)
    out = torch.empty((2, R), dtype=torch.int64, device=dev)
    d_ptr, o_ptr = descs.buffer_info()[0], out.data_ptr()
    size = 8 * len(K2_RED_FIELDS)
    for a, b in scalar_agg_chunks(R):
        rc = lib.scalar_agg_launch(n, mask.data_ptr(), b - a, d_ptr + a * size,
                                   base + 8, base, o_ptr + 8 * a,
                                   o_ptr + 8 * (R + a), grid, stream)
        _ext.check(rc, "scalar_agg")
        LAUNCHES["scalar_agg"] += 1
    return out.unbind(0)


def _check_gid(gid, mask, dev):
    _check_plane(mask, mask.shape[0], (torch.bool,), "mask", dev)
    _check_plane(gid, mask.shape[0], (torch.int64,), "group id", dev)


# K3's launch (ops/csrc/seg_agg_onehot.cu): at most K3_MAX_SLOTS state
# slots (k3_chunks: K4's slots, integer ones first) and K3_MAX_REDS
# reductions ride by value, their shared-memory states within K3_SMEM_CAP
# bytes for one copy (k3_smem_bytes); copies of the integer states are
# added while they fit K3_COPIES_BYTES; the stream's workspace holds the
# ticket, K3_CELLS device cells and the f64 partials of up to K3_MAX_GRID
# blocks
K3_THREADS = 256
K3_WARPS = K3_THREADS // 32
K3_MAX_SLOTS = 32
K3_MAX_REDS = 64
K3_MAX_COPIES = 32
K3_SLOT = 5
K3_MAP = 3
K3_CELLS = K3_MAX_SLOTS * ONEHOT_SEGMENTS_MAX
K3_COPIES_BYTES = 49152
K3_SMEM_CAP = 98304
K3_MAX_GRID = 1024


def k3_slab(n_int: int, S: int) -> int:
    """Words a copy of K3's integer states takes (made odd)."""
    w = n_int * S
    return w + 1 if w > 0 and w % 2 == 0 else w


def k3_smem_bytes(n_int: int, n_f: int, S: int, copies: int) -> int:
    """K3's dynamic shared memory: `copies` copies of the integer states
    and each warp's f64 states."""
    return 8 * (copies * k3_slab(n_int, S) + K3_WARPS * n_f * S)


def k3_workspace_bytes(n_f: int, S: int) -> int:
    """A K3 launch's workspace: the ticket (8 B), the cells, the f64
    partials of K3_MAX_GRID blocks."""
    return 8 + 8 * K3_CELLS + 8 * n_f * S * K3_MAX_GRID


def k3_chunks(reds: list[Red], S: int) -> list:
    """K3's launches for these reductions over S segments: [(start, stop,
    slots, red_map)], each span of reductions as many as fit one launch
    (K3_MAX_REDS, K3_MAX_SLOTS slots of K4's kinds, `_slot_rows`, one copy
    of their states within K3_SMEM_CAP), in order. Slots are [op, flags,
    constant, values pointer, valid pointer], the integer ones first;
    red_map[j] = [op, count slot, value slot] (-1: none)."""
    slot_rows = [_slot_rows(red) for red in reds]
    chunks, a = [], 0
    while a < len(reds):
        index, rows, n_f, b = {}, [], 0, a
        while b < len(reds) and b - a < K3_MAX_REDS:
            new = [(k, r) for k, r in slot_rows[b] if k not in index]
            if new:
                nf = n_f + sum(r[0] in F_OPS for _k, r in new)
                ns = len(rows) + len(new)
                if b > a and (ns > K3_MAX_SLOTS or k3_smem_bytes(
                        ns - nf, nf, S, 1) > K3_SMEM_CAP):
                    break
                for k, r in new:
                    index[k] = len(rows)
                    rows.append(r)
                n_f = nf
            b += 1
        order = sorted(range(len(rows)), key=lambda i: rows[i][0] in F_OPS)
        at = {old: new for new, old in enumerate(order)}
        red_map = []
        for j in range(a, b):
            keys = [at[index[k]] for k, _r in slot_rows[j]]
            red_map.append([reds[j].op, keys[0] if keys else -1,
                            keys[1] if len(keys) > 1 else -1])
        chunks.append((a, b, [rows[i] for i in order], red_map))
        a = b
    return chunks


def _k3_plan(reds: list[Red], S: int) -> list:
    """k3_chunks as launch arguments: [(start, stop, slots, f64 slots,
    slot words, map words)]."""
    return [(a, b, len(slots), sum(row[0] in F_OPS for row in slots),
             array.array("q", [x for row in slots for x in row]),
             array.array("q", [x for row in red_map for x in row]))
            for a, b, slots, red_map in k3_chunks(reds, S)]


def k3_prepare(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
               reds: list[Red]) -> tuple:
    """Everything of K3's launches on the card but the launches: checks,
    the plan (k3_chunks), the output allocated. Returns (launch,
    out); launch() runs one launch per chunk into out [R, S, 2]."""
    dev = mask.device
    _check_gid(gid, mask, dev)
    n = mask.shape[0]
    if not reds:
        raise errors.DeviceError("K3 needs at least one reduction")
    _check_reds(reds, n, dev)
    fn = _ext.lib("seg_agg_onehot").seg_onehot_launch
    S = num_segments
    plan = _k3_plan(reds, S)
    out = torch.empty((len(reds), S, 2), dtype=torch.int64, device=dev)
    g, m, o = gid.data_ptr(), mask.data_ptr(), out.data_ptr()

    def launch():
        st = _stream(dev)
        for a, b, n_slots, n_f, t_slots, t_map in plan:
            work = _stream_scratch("seg_agg_onehot", dev,
                                   k3_workspace_bytes(n_f, S), st)
            rc = fn(n, g, m, S, n_slots, n_f,
                    t_slots.buffer_info()[0] if n_slots else None, b - a,
                    t_map.buffer_info()[0], work.data_ptr(),
                    o + 16 * S * a, st)
            _ext.check(rc, "seg_agg_onehot")
            LAUNCHES["seg_agg_onehot"] += 1

    return launch, out


def seg_agg_onehot(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
                   reds: list[Red]):
    """K3 (S <= ONEHOT_SEGMENTS_MAX): (n int64[R, S], acc int64[R, S]). On
    the card one launch per k3_chunks span (one for up to K3_MAX_SLOTS
    slots), its slots and map by value, its workspace the stream's."""
    if num_segments > ONEHOT_SEGMENTS_MAX:
        raise errors.DeviceError(
            f"{num_segments} segments exceed the one-hot kernel's "
            f"{ONEHOT_SEGMENTS_MAX}")
    if _device_kind(mask) == "cpu":
        return seg_agg_plain(gid, mask, num_segments, reds)
    launch, out = k3_prepare(gid, mask, num_segments, reds)
    launch()
    return out[..., 0], out[..., 1]


# K4's routes (ops/csrc/seg_agg_sorted.cu): segment windows on K6's block
# route while they are at most K4_MAX_WINDOWS (the point past which the
# sorted route was faster at l_suppkey's reductions on the card: PERF.md),
# else the sorted route. The windows' launch takes its tables by value: a
# slot is K4_SLOT int64, a reduction's map K4_MAP, at most K4_WINDOWS_CAP
# windows and K4_MAX_REDS reductions
K4_MAX_WINDOWS = 7
K4_WINDOWS_CAP = 16
# one window's (K6: one region's) integer states in up to this many
# copies (seg_block.cuh)
K4_MAX_COPIES = 16
K4_MAX_REDS = 64
K4_ROUTES = ("seg_agg_block", "seg_agg_sorted")
K4_SLOT = 5
K4_MAP = 3
K6B_ROW_VALUE = 1


def _slot_rows(red: Red) -> list:
    """The state slots a reduction needs, [(key, slot row)]: its count
    slot first (R_COUNT, constant 1, over its valid plane; R_FIRST's over
    every mask row), then its value slot (none for R_COUNT); none for a
    NULL-constant reduction. Equal keys are one slot."""
    if red.op == R_FIRST:
        return [(("n", 0), [R_COUNT, 0, 1, 0, 0]),
                (("first",), [R_FIRST, K6B_ROW_VALUE, 0, 0, 0])]
    if red.never:
        return []
    valid = 0 if red.valid is None else red.valid.data_ptr()
    out = [(("n", valid), [R_COUNT, 0, 1, 0, valid])]
    if red.op != R_COUNT:
        vals = 0 if red.values is None else red.values.data_ptr()
        const = red.const_bits if red.values is None else 0
        out.append((("v", red.op, vals, const, valid),
                    [red.op, 0, const, vals, valid]))
    return out


def k4_slots(reds: list[Red]) -> tuple:
    """K4's state slots on the windowed route: (slots, red_map). A slot is
    [op, flags, constant, values pointer, valid pointer]: one count slot
    (R_COUNT, constant 1) per distinct valid plane among the reductions
    (R_FIRST's takes every mask row), one value slot per distinct (op,
    values or constant, valid); red_map[j] = [op, count slot, value slot]
    (-1: none; a NULL-constant reduction has neither, R_COUNT no value)."""
    slots, index, red_map = [], {}, []
    for red in reds:
        got = []
        for key, row in _slot_rows(red):
            if key not in index:
                index[key] = len(slots)
                slots.append(row)
            got.append(index[key])
        red_map.append([red.op] + (got + [-1, -1])[:2])
    return slots, red_map


def _k4_windows(n_red: int, n_slots: int, n_f64: int, num_segments: int,
                limit: int) -> tuple | None:
    """The fewest segment windows K4's block route needs, whatever their
    number: (rows a thread per chunk, windows), windows of as many segments
    as one copy of their states (and, for f64 states, a chunk's staging)
    fits in `limit` bytes, the most rows on a tie; None where no window
    fits or the launch cannot take the reductions (K6's windows of one
    region, k6_windows)."""
    if n_red > K4_MAX_REDS:
        return None
    return k6_windows(n_slots, n_f64, [num_segments], limit)


def k4_route(n_red: int, n_slots: int, n_f64: int, num_segments: int,
             limit: int) -> tuple:
    """K4's route for n_red reductions keeping n_slots states a segment
    (n_f64 of them f64 ops; see k4_slots) over num_segments segments,
    given the block route's shared-memory limit in bytes: (LAUNCHES name,
    rows a thread per chunk, windows). The windows of `_k4_windows` while
    they are at most K4_MAX_WINDOWS; else the sorted route, (name, 0, 0)."""
    fit = _k4_windows(n_red, n_slots, n_f64, num_segments, limit)
    if fit is None or fit[1] > K4_MAX_WINDOWS:
        return ("seg_agg_sorted", 0, 0)
    return ("seg_agg_block",) + fit


def k4_copies(n_slots: int, n_f64: int, span: int, rows: int,
              limit: int) -> int:
    """Copies of a span's integer states for a block of seg_block.cuh
    (K4's window, K6's region): the largest power of two up to
    K4_MAX_COPIES whose copies (with the f64 staging) fit `limit`, so that
    lanes sharing a segment fold into different copies (few segments: a
    hot group's lanes pile onto one address)."""
    base = k6_block_bytes(n_slots, n_f64, span, rows)
    copies = 1
    while copies < K4_MAX_COPIES and \
            base + 8 * (2 * copies - 1) * n_slots * span <= limit:
        copies *= 2
    return copies


_K4_LIMIT: dict = {}
_K4_GRID: dict = {}


def _card_query(cache: dict, key, query, *args) -> int:
    """A positive figure the kernel library reports (a block route's
    shared-memory limit, its persistent grid), asked once per key; a
    result <= 0 is minus a CUDA error."""
    v = cache.get(key)
    if v is None:
        v = int(query(*args))
        if v <= 0:
            raise errors.DeviceError(f"{query.__name__} failed with CUDA "
                                     f"error {-v}")
        cache[key] = v
    return v


def _k4_block_limit(lib, dev: torch.device) -> int:
    return _card_query(_K4_LIMIT, dev.index, lib.seg_agg_block_limit)


def _k4_block_grid(lib, dev: torch.device, rows: int, smem: int) -> int:
    return _card_query(_K4_GRID, (dev.index, rows, smem),
                       lib.seg_agg_block_grid, rows, smem)


def seg_agg_sorted(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
                   reds: list[Red]):
    """K4 (S > ONEHOT_SEGMENTS_MAX): (n int64[R, S], acc int64[R, S]). On
    the card by `k4_route`: segment windows in shared memory (one launch,
    every window), or the radix sort of the group ids (one pass per digit
    of their bit length) and the segmented pass over the sorted runs."""
    if _device_kind(mask) == "cpu":
        return seg_agg_plain(gid, mask, num_segments, reds)
    dev = mask.device
    n = mask.shape[0]
    _check_gid(gid, mask, dev)
    _check_reds(reds, n, dev)
    slots, _red_map = k4_slots(reds)
    n_f = sum(row[0] in F_OPS for row in slots)
    route = k4_route(len(reds), len(slots), n_f, num_segments,
                     _k4_block_limit(_ext.lib("seg_agg_sorted"), dev))[0] \
        if n > 0 else "seg_agg_sorted"
    if route == "seg_agg_sorted":
        return _k4_sorted(gid, mask, num_segments, reds)
    return _k4_block(gid, mask, num_segments, reds)


def _k4_sorted(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
               reds: list[Red]):
    """K4's sorted route over checked card planes: the radix sort of the
    group ids, one pass per digit of their bit length, then the segmented
    pass over the sorted runs."""
    plan = radix_plan((1 << (num_segments - 1).bit_length()) - 1, False)
    gid_sorted, order = radix_sort_t(gid, None, plan)
    return seg_agg_presorted(gid_sorted, order, mask, num_segments, reds)


def _k4_block(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
              reds: list[Red]):
    """K4's windowed block route over n >= 1 checked card rows, in the
    fewest windows that fit (`_k4_windows`: k4_route takes this route only
    up to K4_MAX_WINDOWS of them; the launch holds K4_WINDOWS_CAP), all in
    one launch."""
    dev = mask.device
    n = mask.shape[0]
    lib = _ext.lib("seg_agg_sorted")
    slots, red_map = k4_slots(reds)
    n_f = sum(row[0] in F_OPS for row in slots)
    fit = _k4_windows(len(reds), len(slots), n_f, num_segments,
                      _k4_block_limit(lib, dev))
    if fit is None or fit[1] > K4_WINDOWS_CAP:
        raise errors.DeviceError(f"K4's windows do not hold {num_segments} "
                                 f"segments of {len(slots)} states")
    rows, windows = fit
    span = -(-num_segments // windows)
    copies = k4_copies(len(slots), n_f, span, rows,
                       _k4_block_limit(lib, dev)) if windows == 1 else 1
    smem = k6_block_bytes(len(slots), n_f, span, rows) \
        + 8 * (copies - 1) * len(slots) * span
    units = k6_block_units([n] * windows,
                           _k4_block_grid(lib, dev, rows, smem))
    rdesc, first = [], 0
    for w in range(windows):
        rdesc += [0, n, w * span, min(span, num_segments - w * span), first,
                  units[w]]
        first += units[w]
    # the tables go by value: host arrays the launch copies
    t_rdesc = array.array("q", rdesc)
    t_slots = array.array("q", [x for row in slots for x in row])
    t_map = array.array("q", [x for row in red_map for x in row])
    part = torch.empty(first * len(slots) * span, dtype=torch.int64,
                       device=dev)
    out = torch.empty(len(reds) * num_segments * 2, dtype=torch.int64,
                      device=dev)
    rc = lib.seg_agg_block_launch(
        rows, first, t_rdesc.buffer_info()[0], windows, gid.data_ptr(),
        mask.data_ptr(), len(slots), n_f, t_slots.buffer_info()[0],
        len(reds), t_map.buffer_info()[0], span, copies, num_segments,
        part.data_ptr(), out.data_ptr(), _stream(dev))
    _ext.check(rc, "seg_agg_block")
    LAUNCHES["seg_agg_block"] += 1
    out = out.view(len(reds), num_segments, 2)
    return out[..., 0], out[..., 1]


# ---------------------------------------------------------------------------
# the cluster region path: K5 expr_vm_ragged, K6 seg_states_ragged, K7
# combine_partials, and their plain versions
# ---------------------------------------------------------------------------

# K5's tile (rows per block); every region capacity is a multiple of it
K5_TILE = 1024


def bucket_segments(n: int, minimum: int = 8) -> int:
    """Power-of-two span of a region's segment space (G_r groups + its
    sink): the reference's jit-shape bucket, kept so region offsets and
    padded empty segments are the same on both sides."""
    c = minimum
    while c < n:
        c *= 2
    return c


class RegionProgram:
    """One region's share of a K5 launch: its laid-out program (WHERE plus
    argument outputs), the planes the program reads, in `fin.plane_keys`
    order, the capacity and the live row count."""

    __slots__ = ("fin", "planes", "cap", "n_rows")

    def __init__(self, fin: Finalized, planes: list, cap: int, n_rows: int):
        self.fin = fin
        self.planes = planes
        self.cap = int(cap)
        self.n_rows = int(n_rows)


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] (n a multiple of 8) → uint8[n / 8], bit l of byte w = row
    8w + l: np.packbits(..., bitorder="little")."""
    w = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                     device=mask.device)
    return (mask.view(-1, 8).to(torch.uint8) * w).sum(1, dtype=torch.uint8)


def unpack_masks(bits: torch.Tensor, caps: list) -> list:
    """K5's packed survivor bits (read back to the host) → one numpy
    bool[cap_r] mask per region."""
    host = bits.cpu().numpy()
    out, off = [], 0
    for cap in caps:
        w = cap // 8
        out.append(np.unpackbits(host[off:off + w], bitorder="little")
                   .astype(bool))
        off += w
    return out


def _out_dts(regions: list) -> list:
    dts = regions[0].fin.out_dts
    for rp in regions[1:]:
        if rp.fin.out_dts != dts:
            raise errors.DeviceError("regions disagree on argument types")
    return dts


def expr_vm_ragged_plain(regions: list, device):
    dev = torch.device(device)
    bits, per_out = [], [[] for _ in _out_dts(regions)]
    for rp in regions:
        live = torch.arange(rp.cap, device=dev) < rp.n_rows
        mask, _gid, values = run_program_plain(rp.fin, rp.planes, live)
        bits.append(_pack_bits(mask))
        for j, vv in enumerate(values):
            per_out[j].append(vv)
    outs = [(torch.cat([v for v, _ in o]), torch.cat([k for _, k in o]))
            for o in per_out]
    return torch.cat(bits), outs


def expr_vm_ragged(regions: list, device):
    """K5: (uint8[sum cap_r / 8] survivor bits, one (values, valid) pair
    of concatenated [sum cap_r] planes per program output)."""
    dev = _device(device)
    if dev.type == "cpu":
        return expr_vm_ragged_plain(regions, dev)
    if dev.type != "cuda":
        raise errors.DeviceError(f"no kernel for device {dev}")
    launch, bits, outs = k5_prepare(regions, dev)
    launch()
    return bits, outs


# K5's table (ops/csrc/expr_vm.cu, the contract with k5_pack): header
# words, then per region K5_REGION words and per distinct program stream
# K5_STREAM words plus its output registers
K5_THREADS = 256
K5_HDR = 12
K5_REGION = 6
K5_STREAM = 3
# the table rides by value up to K5_PARAM_WORDS (in the smaller block up
# to K5_SMALL_WORDS), past it packed into a device buffer; each counts
# under its own LAUNCHES key
K5_SMALL_WORDS = 512
K5_PARAM_WORDS = 3968
K5_ROUTES = ("expr_vm_ragged", "expr_vm_ragged_packed")


def k5_route(n_words: int) -> str:
    """The K5 instantiation a table of n_words takes."""
    return K5_ROUTES[param_block(n_words) == "packed"]


def _k5_stream(fin: Finalized) -> tuple:
    """(key, instruction words, WHERE register, output registers,
    registers) of a region's program, kept on it. Programs with the same
    key share one stream of K5's table."""
    got = getattr(fin, "_k5_stream", None)
    if got is None:
        meta = fin.meta
        n, where, n_out = int(meta[0]), int(meta[1]), int(meta[2])
        body = meta[HDR:HDR + 6 * n + n_out]
        ins, outs = body[:6 * n].tolist(), body[6 * n:].tolist()
        n_regs = max(ins[1::6] + outs + [where], default=-1) + 1
        got = fin._k5_stream = (meta[:3].tobytes() + body.tobytes(), ins,
                                where, outs, n_regs)
    return got


def k5_pack(regions: list, out_ptrs: list) -> tuple:
    """K5's table in one host pass: (int64 words, registers). `out_ptrs`
    are the outputs' (values, valid) pointers."""
    R, n_out = len(regions), len(out_ptrs) // 2
    stream_of: dict = {}
    streams, tile0, rdesc, planes, pools, luts = [], [], [], [], [], []
    base = tiles = pool_off = lut_off = n_regs = 0
    for rp in regions:
        key, ins, where, oregs, nr = _k5_stream(rp.fin)
        s = stream_of.get(key)
        if s is None:
            s = stream_of[key] = len(streams)
            streams.append((ins, where, oregs))
        n_regs = max(n_regs, nr)
        tile0.append(tiles)
        rdesc += (base, rp.n_rows, s, len(planes), pool_off, lut_off)
        planes += [t.data_ptr() for t in rp.planes]
        pools.append(rp.fin.pool)
        luts.append(rp.fin.lut)
        base += rp.cap
        tiles += rp.cap // K5_TILE
        pool_off += rp.fin.pool.shape[0]
        lut_off += rp.fin.lut.shape[0]
    tile0.append(tiles)
    off_tile0 = K5_HDR
    off_regions = off_tile0 + R + 1
    off_streams = off_regions + K5_REGION * R
    ins_at = off_streams + (K5_STREAM + n_out) * len(streams)
    table = []
    for ins, where, oregs in streams:
        table += (ins_at, len(ins) // 6, where, *oregs)
        ins_at += len(ins)
    off_outs = ins_at
    off_planes = off_outs + 2 * n_out
    off_pool = off_planes + len(planes)
    off_lut = off_pool + pool_off
    words = array.array("q", (R, len(streams), n_out, tiles, n_regs,
                              off_tile0, off_regions, off_streams, off_outs,
                              off_planes, off_pool, off_lut))
    words.extend(tile0)
    words.extend(rdesc)
    words.extend(table)
    for ins, _w, _o in streams:
        words.extend(ins)
    words.extend(out_ptrs)
    words.extend(planes)
    for p in pools:
        words.frombytes(p.tobytes())
    lut = b"".join(x.tobytes() for x in luts)
    words.frombytes(lut + bytes(-len(lut) % 8))
    return words, n_regs


def k5_prepare(regions: list, dev):
    """Everything of a K5 launch but the launch: checks, the table packed
    (k5_pack), the outputs allocated. Returns (launch, bits, outs);
    launch() runs the kernel into bits and outs: the table by value in
    its parameters, or past K5_PARAM_WORDS copied once from the reused
    page-locked staging buffer."""
    dev = _device(dev)
    dts = _out_dts(regions)
    total = 0
    for r, rp in enumerate(regions):
        fin = rp.fin
        if rp.cap % K5_TILE or rp.cap <= 0:
            raise errors.DeviceError(f"region capacity {rp.cap} is not a "
                                     f"multiple of {K5_TILE}")
        for (key, which), t in zip(fin.plane_keys, rp.planes):
            dtypes = (torch.bool,) if which else (torch.int64, torch.float64)
            _check_plane(t, rp.cap, dtypes, f"region {r} plane {key}", dev)
        total += rp.cap
    bits = torch.empty(total // 32, dtype=torch.int32, device=dev)
    outs, out_ptrs = [], []
    for dt in dts:
        v = torch.empty(total, dtype=torch.float64 if dt == "f"
                        else torch.int64, device=dev)
        ok = torch.empty(total, dtype=torch.bool, device=dev)
        outs.append((v, ok))
        out_ptrs += (v.data_ptr(), ok.data_ptr())
    words, n_regs = k5_pack(regions, out_ptrs)
    if n_regs > MAX_REGS:
        raise errors.DeviceError(f"a region program uses {n_regs} registers")
    fn = _ext.lib("expr_vm").expr_vm_ragged_launch

    def launch():
        _table_launch(fn, K5_ROUTES, words, dev, bits.data_ptr())

    return launch, bits.view(torch.uint8), outs


def region_filter_batched(regions: list, device):
    """Every region's WHERE (and its argument programs) in one K5 launch;
    the counterpart of the reference's region_filter_batched. Returns the
    packed bits on the device and the argument planes; `unpack_masks`
    reads the bits back as the per-region masks the reference returns
    (live & where_valid & truthy, bit-identical to the host filter)."""
    CALLS["region_filter_batched"] += 1
    return expr_vm_ragged(regions, device)


# K6 reduction ops (common.cuh RedOp numbers; R_COUNT counts)
K6_OPS = (R_COUNT, R_SUM_I, R_SUM_F, R_MIN_I, R_MAX_I, R_MIN_F, R_MAX_F)


def _k6_ident(op: int):
    if op in (R_MIN_I, R_MAX_I, R_MIN_F, R_MAX_F):
        return _sentinel(op)
    return 0.0 if op == R_SUM_F else 0


class StatesInput:
    """One reduction of one region for K6: op (a K6_OPS number), the
    contributing-row mask (host bool[cap_r]), the values plane (None: a
    count) and an extra valid plane (None: all valid), both on the
    device."""

    __slots__ = ("op", "contrib", "values", "valid")

    def __init__(self, op: int, contrib: np.ndarray, values=None,
                 valid=None):
        self.op = op
        self.contrib = contrib
        self.values = values
        self.valid = valid


def _k6_layout(caps: list, Gs: list):
    spans = [bucket_segments(g + 1) for g in Gs]
    offs = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
    bases = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    return spans, offs, bases


def _k6_contribs(reds: list, dev) -> list:
    """Concatenated contrib masks per reduction on the device, each
    distinct mask set moved once."""
    seen, out = {}, []
    for j in range(len(reds[0])):
        key = tuple(id(r[j].contrib) for r in reds)
        t = seen.get(key)
        if t is None:
            t = seen[key] = torch.from_numpy(np.concatenate(
                [np.asarray(r[j].contrib, bool) for r in reds])).to(dev)
        out.append(t)
    return out


def seg_states_ragged_plain(gid: torch.Tensor, caps: list, Gs: list,
                            reds: list, contribs: list) -> torch.Tensor:
    dev = gid.device
    spans, offs, bases = _k6_layout(caps, Gs)
    S = int(offs[-1])
    region_off = torch.repeat_interleave(
        torch.from_numpy(offs[:-1]).to(dev),
        torch.tensor(caps, device=dev))
    g = gid + region_off
    out = []
    for j, contrib in enumerate(contribs):
        op = reds[0][j].op
        parts_v, parts_ok = [], []
        for r, cap in enumerate(caps):
            si = reds[r][j]
            ok = torch.ones(cap, dtype=torch.bool, device=dev) \
                if si.valid is None else si.valid
            parts_ok.append(ok)
            parts_v.append(torch.ones(cap, dtype=torch.int64, device=dev)
                           if si.values is None or op == R_COUNT
                           else si.values)
        take = contrib & torch.cat(parts_ok)
        x = torch.cat(parts_v)
        ident = _k6_ident(op)
        if op in (R_COUNT, R_SUM_I, R_SUM_F):
            acc = torch.zeros(S, dtype=x.dtype, device=dev).index_add_(
                0, g, torch.where(take, x, torch.zeros_like(x)))
        else:
            how = "amin" if op in (R_MIN_I, R_MIN_F) else "amax"
            acc = torch.full((S,), ident, dtype=x.dtype, device=dev) \
                .scatter_reduce_(0, g, torch.where(
                    take, x, torch.full_like(x, ident)), how)
        out.append(acc.view(torch.int64) if acc.dtype == torch.float64
                   else acc)
    return torch.stack(out)


# K6's routes (seg_states_ragged.cu): the block route within the card's
# opt-in shared memory (K6B_*, seg_block.cuh, which K4 shares), segment
# windows of larger spans on the same kernel up to K6_MAX_WINDOWS a region,
# else the sorted route (radix.cuh and seg_sorted.cuh). The block route's
# instantiations: K6B_ROWS rows a thread per chunk at one block an SM, and
# for small spans K6B_SMALL_ROWS rows at K6B_SMALL_BLOCKS blocks an SM; the
# tables ride by value (struct K6Params) up to K6_PARAM_REGIONS regions
# (the windows: K6_PARAM_ROWS rows) and K6_PARAM_TAB plane pointers
K6_RDESC = 6
K6B_THREADS = 512
K6B_WARPS = 16
K6B_MAX_REDS = 32
K6B_ROWS = (4, 2, 1)         # rows a thread per chunk, largest first
K6B_SMALL_ROWS = 2
K6B_SMALL_BLOCKS = 2
# a small-span block's share of the limit: half of it, less what each
# block's static shared memory and the card's reserve take
K6B_SMALL_RESERVE = 2048
K6_PARAM_REGIONS = 16
K6_PARAM_ROWS = 64
K6_PARAM_TAB = 512
K6_WIN = 2
# windows a region on the window route: the most at which the windows
# beat the sorted route by 1.2x at every shape of k6_window_sweep.py on an
# H100 at 700 W (PERF.md). d_supplier's 8 reductions over 6M rows set it
# (16 windows 1.25x, 20 1.14x); d_part's 6 reductions hold 1.2x up to 24,
# two reductions past 32
K6_MAX_WINDOWS = 16
# the window route's blocks a window row at least (k6_window_blocks)
K6_WINDOW_BLOCKS = 4
K6_ROUTES = ("seg_states_ragged_smem", "seg_states_ragged_window",
             "seg_states_ragged_sorted")


def k6_block_bytes(n_red: int, n_f64: int, span_max: int, rows: int) -> int:
    """Dynamic shared memory of a block of K6's block route
    (seg_states_ragged.cu k6b_smem_bytes): the span copy and, with n_f64
    f64 reductions, a chunk's staged values, group ids and take bits and
    two sets of bucket offsets."""
    c = K6B_THREADS * rows
    staged = c * (8 * n_f64 + 8) + 8 * (K6B_WARPS * K6B_WARPS * rows + 1) \
        if n_f64 else 0
    return 8 * n_red * span_max + staged


def k6_windows(n_red: int, n_f64: int, segs: list,
               limit: int) -> tuple | None:
    """The fewest segment windows a region that K6's window route needs
    for regions of segs[r] segments each (a region's groups and its sink),
    whatever their number: (rows a thread per chunk, windows of the region
    that needs the most), windows of as many segments as one copy of their
    states (and, with n_f64 f64 ops, a chunk's staging) fits in `limit`
    bytes, the most rows on a tie; None where no window fits or the
    reductions are more than a block folds."""
    best = None
    if 1 <= n_red <= K6B_MAX_REDS:
        for rows in K6B_ROWS:
            span = (limit - k6_block_bytes(n_red, n_f64, 0, rows)) \
                // (8 * n_red)
            if span < 1:
                continue
            windows = max(-(-int(g) // span) for g in segs)
            if best is None or windows < best[1]:
                best = (rows, windows)
    return best


def k6_window_plan(n_red: int, n_f64: int, segs: list,
                   limit: int) -> tuple:
    """K6's windows: (rows a thread per chunk, [(region, first
    region-local segment, segments)] in segment order, the longest
    window). Region r's segs[r] segments are cut into the fewest windows
    that fit (k6_windows' window length), of even length; every segment
    of [0, segs[r]) lies in exactly one window."""
    rows, _w = k6_windows(n_red, n_f64, segs, limit)
    span = (limit - k6_block_bytes(n_red, n_f64, 0, rows)) // (8 * n_red)
    wins = []
    for r, g in enumerate(segs):
        g = int(g)
        count = -(-g // span)
        size = -(-g // count)
        wins += [(r, lo, min(size, g - lo)) for lo in range(0, g, size)]
    return rows, wins, max(n for _r, _lo, n in wins)


def k6_window_blocks(W: int, grid: int) -> int:
    """Blocks of the window route's launch for W window rows: whole waves
    of the card's resident grid, at least K6_WINDOW_BLOCKS a row, so that
    one block more or less a row (k6_block_units) moves a row's time by
    no more than a fraction of it; one wave while that holds."""
    return grid * max(1, -(-K6_WINDOW_BLOCKS * W // grid))


def k6_route(n_red: int, span_max: int, limit: int, n_f64: int = 0,
             segs: list | None = None) -> tuple:
    """K6's route for n_red reductions (n_f64 of them f64 ops) over spans
    of at most span_max segments, given the block route's shared-memory
    limit in bytes: (LAUNCHES name, rows a thread per chunk, blocks an SM,
    copies of the integer states on the block route or windows a region on
    the window route; 0, 0, 0 on the sorted route). Small spans, whose
    copy (and, for f64 ops, a chunk's staging) fits a K6B_SMALL_BLOCKS-th
    of `limit`: the K6B_SMALL_ROWS instantiation at K6B_SMALL_BLOCKS blocks
    an SM, with as many copies as fit that share (k4_copies: a hot group's
    lanes spread over them); else one block an SM at the most rows of
    K6B_ROWS that fit `limit`, with the copies that fit it; else segment
    windows of the regions' segs (their groups and sinks; the whole spans
    where not given), one block an SM, while a region needs at most
    K6_MAX_WINDOWS (k6_windows); else the sorted route."""
    if n_red <= K6B_MAX_REDS:
        small = limit // K6B_SMALL_BLOCKS - K6B_SMALL_RESERVE
        if k6_block_bytes(n_red, n_f64, span_max, K6B_SMALL_ROWS) <= small:
            return ("seg_states_ragged_smem", K6B_SMALL_ROWS,
                    K6B_SMALL_BLOCKS, k4_copies(n_red, n_f64, span_max,
                                                K6B_SMALL_ROWS, small))
        for rows in K6B_ROWS:
            if k6_block_bytes(n_red, n_f64, span_max, rows) <= limit:
                return ("seg_states_ragged_smem", rows, 1,
                        k4_copies(n_red, n_f64, span_max, rows, limit))
        fit = k6_windows(n_red, n_f64, segs or [span_max], limit)
        if fit is not None and fit[1] <= K6_MAX_WINDOWS:
            return ("seg_states_ragged_window", fit[0], 1, fit[1])
    return "seg_states_ragged_sorted", 0, 0, 0


def k6_block_units(n_rows: list, blocks: int) -> list:
    """Blocks of K6's block route per region out of `blocks` (the grid
    resident at once): one for each region with rows, the rest in
    proportion to the rows by largest remainders, none for a region
    without rows and no more than one per K6B_THREADS rows. The sum
    exceeds `blocks` only when more regions than blocks have rows."""
    n = [max(int(x), 0) for x in n_rows]
    cap = [-(-x // K6B_THREADS) for x in n]
    units = [1 if x else 0 for x in n]
    left, total = blocks - sum(units), sum(n)
    if left <= 0 or total == 0:
        return units
    for r, x in enumerate(n):
        units[r] += min(x * left // total, cap[r] - units[r])
    left = blocks - sum(units)
    order = sorted(range(len(n)), key=lambda r: (-(n[r] * left % total), r))
    while left > 0 and any(units[r] < cap[r] for r in order):
        for r in order:
            if left and units[r] < cap[r]:
                units[r] += 1
                left -= 1
    return units


_K6_LIMIT: dict = {}
_K6_GRID: dict = {}


def _k6_block_limit(lib, dev: torch.device) -> int:
    return _card_query(_K6_LIMIT, dev.index, lib.seg_states_block_limit)


def _k6_block_grid(lib, dev: torch.device, rows: int, minb: int,
                   smem: int) -> int:
    return _card_query(_K6_GRID, (dev.index, rows, minb, smem),
                       lib.seg_states_block_grid, rows, minb, smem)


def seg_states_ragged(gid: torch.Tensor, caps: list, n_rows: list,
                      Gs: list, reds: list, contribs: list) -> torch.Tensor:
    """K6: int64[n_red, sum bucket_segments(G_r + 1)] (f64 bits for f64
    ops) over region-local group ids `gid` (concatenated, [sum cap_r]);
    reds[r][j] is region r's StatesInput of reduction j, contribs[j] the
    concatenated contrib mask of reduction j on the device."""
    dev = gid.device
    if dev.type == "cpu":
        return seg_states_ragged_plain(gid, caps, Gs, reds, contribs)
    if dev.type != "cuda":
        raise errors.DeviceError(f"no kernel for device {dev}")
    launch, out = k6_prepare(gid, caps, n_rows, Gs, reds, contribs)
    launch()
    return out


class _K6Call:
    """A K6 call's checked inputs, layout and host tables, which each
    route's builder (_K6_BUILDERS) turns into a launch."""

    __slots__ = ("dev", "lib", "gid", "n_rows", "R", "n_red", "n_f64",
                 "total", "S", "offs", "bases", "span_max", "segs", "limit",
                 "rdesc", "plane_tab", "out")


def k6_prepare(gid: torch.Tensor, caps: list, n_rows: list, Gs: list,
               reds: list, contribs: list):
    """Everything of a K6 launch but the launch (checks, tables, route by
    k6_route, buffers). Returns (launch, out); launch() runs the kernels
    into out. No route copies anything to the card while its tables fit
    K6Params, and none calls a library sort."""
    k = _k6_call(gid, caps, n_rows, Gs, reds, contribs)
    name = k6_route(k.n_red, k.span_max, k.limit, k.n_f64, k.segs)[0]
    return _K6_BUILDERS[name](k)


def _k6_call(gid: torch.Tensor, caps: list, n_rows: list, Gs: list,
             reds: list, contribs: list) -> _K6Call:
    k = _K6Call()
    k.dev = dev = gid.device
    k.R, k.n_red = R, n_red = len(caps), len(contribs)
    k.total = total = int(sum(caps))
    _check_plane(gid, total, (torch.int64,), "group id", dev)
    spans, k.offs, k.bases = _k6_layout(caps, Gs)
    k.S = int(k.offs[-1])
    k.lib = _ext.lib("seg_states_ragged")
    red_rows, vals, valids = [], [], []
    for j, contrib in enumerate(contribs):
        op = reds[0][j].op
        if op not in K6_OPS:
            raise errors.DeviceError(f"K6 op {op}")
        _check_plane(contrib, total, (torch.bool,), "contrib", dev)
        red_rows.append([op, contrib.data_ptr()])
        want = torch.float64 if op in F_OPS else torch.int64
        for r in range(R):
            si = reds[r][j]
            if si.op != op:
                raise errors.DeviceError("regions disagree on a reduction")
            if si.values is not None and op != R_COUNT:
                if si.values.dtype != want:
                    raise errors.DeviceError(
                        f"K6 op {op} over {si.values.dtype}")
                _check_plane(si.values, caps[r], (want,), "values", dev)
            if si.valid is not None:
                _check_plane(si.valid, caps[r], (torch.bool,), "valid", dev)
            vals.append(0 if si.values is None or op == R_COUNT
                        else si.values.data_ptr())
            valids.append(0 if si.valid is None else si.valid.data_ptr())
    k.gid, k.n_rows = gid, n_rows
    k.out = torch.empty(n_red * k.S, dtype=torch.int64, device=dev)
    k.span_max = max(spans)
    k.n_f64 = sum(r.op in F_OPS for r in reds[0])
    k.limit = _k6_block_limit(k.lib, dev)
    k.segs = [int(g) + 1 for g in Gs]
    k.rdesc = [[int(k.bases[r]), int(n_rows[r]), int(k.offs[r]), spans[r],
                0, 0] for r in range(R)]
    k.plane_tab = [x for row in red_rows for x in row] + vals + valids
    return k


def _k6_launch(k: _K6Call, route: str, run):
    def launch():
        _ext.check(run(), route)
        LAUNCHES[route] += 1

    return launch, k.out.view(k.n_red, k.S)


def _k6_block(k: _K6Call):
    """The block route: each region's span in one block's shared memory."""
    lib, dev, R, n_red = k.lib, k.dev, k.R, k.n_red
    name, rows, minb, copies = k6_route(n_red, k.span_max, k.limit, k.n_f64)
    if name != "seg_states_ragged_smem":
        raise errors.DeviceError(f"K6's block route does not hold a span of "
                                 f"{k.span_max} segments")
    smem = k6_block_bytes(n_red, k.n_f64, k.span_max, rows) \
        + 8 * (copies - 1) * n_red * k.span_max
    units = k6_block_units(
        k.n_rows, _k6_block_grid(lib, dev, rows, minb, smem))
    rdesc, first = [list(row) for row in k.rdesc], 0
    for r in range(R):
        rdesc[r][4:] = [first, units[r]]
        first += units[r]
    part = torch.empty(max(first, 1) * n_red * k.span_max,
                       dtype=torch.int64, device=dev)
    tables, on_card = _k6_tables(
        [x for row in rdesc for x in row] + k.plane_tab,
        R > K6_PARAM_REGIONS or 2 * n_red * R > K6_PARAM_TAB, dev)

    def run() -> int:
        return lib.seg_states_block_launch(
            rows, minb, copies, first, _k6_ptr(tables), on_card, R,
            k.gid.data_ptr(), n_red, k.n_f64, k.span_max, k.S,
            part.data_ptr(), k.out.data_ptr(), _stream(dev))
    return _k6_launch(k, name, run)


def _k6_window(k: _K6Call):
    """The window route: each region's groups and sink in segment windows
    (k6_window_plan), as many a region as they need."""
    lib, dev, R, n_red, n_f64 = k.lib, k.dev, k.R, k.n_red, k.n_f64
    if k6_windows(n_red, n_f64, k.segs, k.limit) is None:
        raise errors.DeviceError(f"no K6 window holds a segment of {n_red} "
                                 f"states")
    rows, wins, wspan = k6_window_plan(n_red, n_f64, k.segs, k.limit)
    copies = k4_copies(n_red, n_f64, wspan, rows, k.limit)
    smem = k6_block_bytes(n_red, n_f64, wspan, rows) \
        + 8 * (copies - 1) * n_red * wspan
    units = k6_block_units([k.n_rows[r] for r, _lo, _n in wins],
                           k6_window_blocks(len(wins), _k6_block_grid(
                               lib, dev, rows, 1, smem)))
    wdesc, wmap, first = [], [], 0
    for (r, lo, n), u in zip(wins, units):
        wdesc += [int(k.bases[r]), int(k.n_rows[r]), int(k.offs[r]) + lo, n,
                  first, u]
        wmap += [r, lo]
        first += u
    W = len(wins)
    part = torch.empty(max(first, 1) * n_red * wspan, dtype=torch.int64,
                       device=dev)
    tables, on_card = _k6_tables(
        wdesc + wmap + k.plane_tab,
        W > K6_PARAM_ROWS or 2 * n_red * R > K6_PARAM_TAB, dev)

    def run() -> int:
        return lib.seg_states_window_launch(
            rows, copies, first, _k6_ptr(tables), on_card, W, R,
            k.gid.data_ptr(), n_red, n_f64, wspan, k.S, part.data_ptr(),
            k.out.data_ptr(), _stream(dev))
    return _k6_launch(k, "seg_states_ragged_window", run)


def _k6_sorted(k: _K6Call):
    """The sorted route: the offset ids, radix.cuh's passes over S - 1's
    bits, seg_sorted.cuh's pass. Any number of reductions: past
    K6B_MAX_REDS (K6Params' room for them) the tables are on the card."""
    lib, dev, R, n_red, total = k.lib, k.dev, k.R, k.n_red, k.total
    tables, on_card = _k6_tables(
        [x for row in k.rdesc for x in row] + k.plane_tab,
        R > K6_PARAM_ROWS or n_red > K6B_MAX_REDS
        or 2 * n_red * R > K6_PARAM_TAB, dev)
    plan = radix_plan((1 << (k.S - 1).bit_length()) - 1, False)
    part = torch.empty(4 * n_red * lib.seg_states_pieces_count(
        max(total, 1)), dtype=torch.int64, device=dev)
    gid = k.gid

    def run() -> int:
        if total == 0:
            gs = order = gid
        else:
            keys = torch.empty(total, dtype=torch.int64, device=dev)
            rc = lib.seg_states_keys_launch(
                _k6_ptr(tables), on_card, R, n_red, total, gid.data_ptr(),
                keys.data_ptr(), _stream(dev))
            _ext.check(rc, "seg_states_ragged_sorted")
            gs, order = radix_sort_t(keys, None, plan)
        return lib.seg_states_sorted_launch(
            total, gs.data_ptr(), order.data_ptr(), _k6_ptr(tables), on_card,
            R, k.S, n_red, part.data_ptr(), k.out.data_ptr(), _stream(dev))
    return _k6_launch(k, "seg_states_ragged_sorted", run)


# K6's builders by route (k6_prepare takes k6_route's; the chip check's
# comparisons of the routes call one through _k6_on_route)
_K6_BUILDERS = {"seg_states_ragged_smem": _k6_block,
                "seg_states_ragged_window": _k6_window,
                "seg_states_ragged_sorted": _k6_sorted}


def _k6_on_route(route: str, *args):
    """k6_prepare's (launch, out) on `route` (one of K6_ROUTES), whichever
    route k6_route would take."""
    if route not in _K6_BUILDERS:
        raise errors.DeviceError(f"no K6 route {route}")
    return _K6_BUILDERS[route](_k6_call(*args))


def _k6_tables(flat: list, on_card: bool, dev) -> tuple:
    """K6's tables: a host array the launch copies into its parameters,
    or (on_card: past K6Params' room) the same layout on the card."""
    tables = array.array("q", flat)
    if on_card:
        return torch.tensor(tables, dtype=torch.int64).to(dev), 1
    return tables, 0


def _k6_ptr(tables) -> int:
    return tables.data_ptr() if isinstance(tables, torch.Tensor) \
        else tables.buffer_info()[0]


def combine_partials_plain(states: list, codes: list) -> list:
    out = []
    for s, op in zip(states, codes):
        a = s[0]
        for r in range(1, s.shape[0]):
            b = s[r]
            if op in (R_SUM_I, R_SUM_F):
                a = a + b
            elif op in (R_MIN_I, R_MIN_F):
                a = torch.where(b < a, b, a)
            else:
                a = torch.where(b > a, b, a)
        out.append(a)
    return out


def combine_partials(states: list, codes: list, device) -> list:
    """K7: [G_i] per [R, G_i] state, folded over r in order."""
    dev = _device(device)
    if dev.type == "cpu":
        return combine_partials_plain(
            [torch.from_numpy(np.ascontiguousarray(s)) for s in states],
            codes)
    if dev.type != "cuda":
        raise errors.DeviceError(f"no kernel for device {dev}")
    launch, out, desc = k7_prepare(states, codes, dev)
    launch()
    host = out.cpu().numpy()
    res = []
    for (op, _i, G, o) in desc:
        v = host[o:o + G]
        res.append(torch.from_numpy(v.view(np.float64) if op in F_OPS
                                    else v.copy()))
    return res


def k7_prepare(states: list, codes: list, dev):
    """Everything of a K7 launch but the launch: the states packed into
    one int64 buffer and moved to the card with their descriptor. Returns
    (launch, out, desc); launch() runs the kernel into out."""
    dev = _device(dev)
    R = int(states[0].shape[0])
    flat = []
    for s, op in zip(states, codes):
        if s.ndim != 2 or s.shape[0] != R:
            raise errors.DeviceError("combine states must be [R, G]")
        want = np.float64 if op in F_OPS else np.int64
        flat.append(np.ascontiguousarray(s, dtype=want).view(np.int64))
    t_in = torch.from_numpy(np.concatenate([a.reshape(-1) for a in flat])
                            ).to(dev)
    return _k7_prepare_device(t_in, [a.shape[1] for a in flat], codes, R,
                              dev)


def _k7_prepare_device(t_in: torch.Tensor, widths: list, codes: list,
                       R: int, dev):
    """K7 over states already packed on the device: t_in holds every
    [R, G_i] block (int64, f64 bits) in turn."""
    desc, in_off, out_off = [], 0, 0
    for G, op in zip(widths, codes):
        desc.append([op, in_off, G, out_off])
        in_off += R * G
        out_off += G
    t_desc = torch.tensor(desc, dtype=torch.int64).reshape(-1).to(dev)
    out = torch.empty(max(out_off, 1), dtype=torch.int64, device=dev)
    lib = _ext.lib("combine_partials")

    def launch():
        rc = lib.combine_partials_launch(
            len(widths), R, t_desc.data_ptr(), t_in.data_ptr(),
            out.data_ptr(), out_off, _stream(dev))
        _ext.check(rc, "combine_partials")
        LAUNCHES["combine_partials"] += 1

    return launch, out, desc


def mesh_allreduce(parts: list, codes: list) -> list:
    """The mesh tier's collective: per-shard partials already on one
    device, each [S, M_i] int64 (f64 bits for f64 ops), folded over the
    shard axis in shard order with K7's op codes (a wrapping int64 sum, an
    f64 sum, an exact min or max) in one launch and one readback. Integer
    sums and extrema equal psum / pmin / pmax bit for bit; an f64 sum adds
    the shards' partials in shard order. Returns [M_i] int64 host arrays
    (f64 bits)."""
    CALLS["mesh_allreduce"] += 1
    dev = parts[0].device
    if dev.type == "cpu":
        typed = [p.view(torch.float64) if op in F_OPS else p
                 for p, op in zip(parts, codes)]
        return [(o.view(torch.int64) if o.dtype == torch.float64 else o)
                .numpy() for o in combine_partials_plain(typed, codes)]
    if dev.type != "cuda":
        raise errors.DeviceError(f"no kernel for device {dev}")
    S = int(parts[0].shape[0])
    for p in parts:
        if p.dim() != 2 or p.shape[0] != S or p.dtype != torch.int64 \
                or p.device != dev:
            raise errors.DeviceError("mesh partials must be int64 [S, M] "
                                     "on one device")
    t_in = torch.cat([p.reshape(-1) for p in parts])
    launch, out, desc = _k7_prepare_device(
        t_in, [int(p.shape[1]) for p in parts], codes, S, dev)
    with phase("k7", dev):
        launch()
    host = out.cpu().numpy()
    return [host[o:o + G] for _op, _i, G, o in desc]


_COMBINE_CODE = {("sum", False): R_SUM_I, ("sum", True): R_SUM_F,
                 ("min", False): R_MIN_I, ("min", True): R_MIN_F,
                 ("max", False): R_MAX_I, ("max", True): R_MAX_F}


def combine_region_partials(states: list, ops: list, device) -> list:
    """Merge [R, G] partial states over the region axis in one K7 launch
    with one readback; the counterpart of the reference's function of the
    same name. ops[i] is "sum", "min" or "max"."""
    CALLS["combine_region_partials"] += 1
    codes = [_COMBINE_CODE[(op, np.asarray(s).dtype == np.float64)]
             for s, op in zip(states, ops)]
    with phase("k7", device):
        outs = combine_partials(states, codes, device)
    return [np.atleast_1d(o.numpy()) for o in outs]


# ---------------------------------------------------------------------------
# the region combine of the cluster joins: row specs reduced into [G]
# states per span of rows (K6), the spans folded (K7)
# ---------------------------------------------------------------------------

def row_spans_inputs(gid: np.ndarray, specs: list, caps: list,
                     device) -> tuple:
    """K6's arguments for row specs laid out in spans: `gid` host
    int64[sum caps] (global group ids; the sink G for rows that never
    contribute), `specs` [(op "sum" / "min" / "max", values host
    int64 / f64 [sum caps] or None for a count, contrib host bool[sum
    caps])]. Each plane goes up once; span s holds rows sum(caps[:s]) up
    to sum(caps[:s + 1]). Returns (gid, reds, contribs, codes): K6's
    group ids, per-span StatesInputs and contrib masks on `device`, and
    the K7 code that folds each spec over the spans."""
    dev = _device(device)
    bases = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
    g = torch.from_numpy(np.ascontiguousarray(gid, np.int64)).to(dev)
    cols, contribs, codes = [], [], []
    for op, vals, ok in specs:
        contribs.append(torch.from_numpy(np.ascontiguousarray(
            ok, dtype=bool)).to(dev))
        if vals is None:
            cols.append((R_COUNT, None))
            codes.append(R_SUM_I)
            continue
        vals = np.ascontiguousarray(vals)
        code = _COMBINE_CODE[(op, vals.dtype == np.float64)]
        cols.append((code, torch.from_numpy(vals).to(dev)))
        codes.append(code)
    reds = [[StatesInput(code, None, None if v is None
                         else v[int(bases[r]):int(bases[r + 1])])
             for code, v in cols] for r in range(len(caps))]
    return g, reds, contribs, codes


def span_states_fold(gid: torch.Tensor, caps: list, n_rows: list, G: int,
                     reds: list, contribs: list, codes: list, fold,
                     plain: bool = False) -> list:
    """Row specs into [G] states per span, the spans folded: K6 over
    len(caps) spans of G + 1 segments each (the sink G takes padding and
    dead rows), then `fold` (mesh_allreduce) over the [S, G] blocks; one
    span needs no fold. `plain` runs both plain versions on the tensors'
    device (the chip check's yardstick). Returns one [G] numpy array per spec, f64 where its code
    is an f64 op."""
    dev = gid.device
    S = len(caps)
    with phase("k6", dev):
        if plain:
            out = seg_states_ragged_plain(gid, caps, [G] * S, reds, contribs)
        else:
            out = seg_states_ragged(gid, caps, n_rows, [G] * S, reds,
                                    contribs)
    span = bucket_segments(G + 1)
    parts = [out[j].view(S, span)[:, :G] for j in range(len(codes))]
    if S == 1:
        with phase("states_readback", dev):
            host = [p[0].cpu().numpy() for p in parts]
    elif plain:
        typed = [p.view(torch.float64) if c in F_OPS else p
                 for p, c in zip(parts, codes)]
        host = [(o.view(torch.int64) if o.dtype == torch.float64 else o)
                .cpu().numpy() for o in combine_partials_plain(typed, codes)]
    else:
        host = fold(parts, codes)
    return [np.atleast_1d(a.view(np.float64) if c in F_OPS else a).copy()
            for a, c in zip(host, codes)]


def rows_states(specs: list, gid: np.ndarray, G: int, device,
                plain: bool = False) -> list:
    """The region combine on one device: one fusion's row specs
    (row_spans_inputs' form over the stacked rows of every region)
    reduced into [G] states by K6 over one span of all the rows, no fold.
    The group ids are global, so the regions need no [R, G] stacks: where
    the reference builds them with np.add.at on the host and folds them
    with combine_region_partials, one span gives the same states. `plain`
    runs K6's plain version. Returns one [G] numpy array per spec."""
    dev = _device(device)
    n = len(gid)
    try:
        with phase("h2d", dev):
            g, reds, contribs, codes = row_spans_inputs(gid, specs, [n], dev)
        return span_states_fold(g, [n], [n], G, reds, contribs, codes, None,
                                plain=plain)
    except RuntimeError as e:
        raise errors.DeviceError(f"region row combine failed: {e}") from e


def _states_input(op: str, v, ok) -> StatesInput:
    if op == "cnt":
        return StatesInput(R_COUNT, ok, None, v.valid)
    arg = getattr(v, "is_arg_plane", False)
    values = v.values if arg else v
    valid = v.valid if arg else None
    if values is None:
        if op != "sum":
            raise errors.DeviceError(f"{op} over no values")
        return StatesInput(R_COUNT, ok, None, valid)
    f = values.dtype == torch.float64
    code = {"sum": R_SUM_F if f else R_SUM_I,
            "min": R_MIN_F if f else R_MIN_I,
            "max": R_MAX_F if f else R_MAX_I}[op]
    return StatesInput(code, ok, values, valid)


def states_inputs(segs: list, dev) -> tuple:
    """The arguments of seg_states_ragged for region_agg_states_batched's
    segs: the concatenated group ids and contrib masks moved to `dev`
    (the per-statement host-to-device traffic), the layout and the
    per-region StatesInputs."""
    seg_j = [j for j, (op, _v, _ok) in enumerate(segs[0][1])
             if op not in ("plane", "pvalid")]
    reds = [[_states_input(*specs[j]) for j in seg_j]
            for _g, specs, _G, _n in segs]
    gid = torch.from_numpy(np.concatenate(
        [np.asarray(s[0], np.int64) for s in segs])).to(dev)
    return (gid, [len(s[0]) for s in segs], [int(s[3]) for s in segs],
            [int(s[2]) for s in segs], reds, _k6_contribs(reds, dev))


def region_agg_states_batched(segs: list, device) -> list:
    """Per-group partial states of every region of one statement in one K6
    launch; the counterpart of the reference's function of the same name.

    segs[r] = (gid_r, specs_r, G_r, n_rows_r): gid_r the host-built
    region-local group ids (int64[cap_r], sink G_r), specs_r a list of
    (op, vals, contrib) with op in sum/min/max/cnt/plane/pvalid, vals None
    (a count), a device values plane, or an argument plane (`is_arg_plane`,
    with device `values` / `valid` from K5), contrib a host bool[cap_r].
    Returns outs[r]: one numpy array per spec, [G_r] states or, for the
    row-space "plane" / "pvalid" readbacks, [cap_r]."""
    CALLS["region_agg_states_batched"] += 1
    dev = torch.device(device)
    caps = [len(s[0]) for s in segs]
    Gs = [int(s[2]) for s in segs]
    _spans, offs, _bases = _k6_layout(caps, Gs)
    host = reds = None
    if any(op not in ("plane", "pvalid") for op, _v, _ok in segs[0][1]):
        with phase("h2d", dev):
            k6 = states_inputs(segs, dev)
        reds = k6[4]
        with phase("k6", dev):
            out = seg_states_ragged(*k6)
        with phase("states_readback", dev):
            host = out.cpu().numpy()
    res = []
    with phase("plane_readback", dev):
        for r, (_g, specs, G, _n) in enumerate(segs):
            outs = []
            k = 0
            for op, v, ok in specs:
                if op == "plane":
                    outs.append(v.values.cpu().numpy().astype(np.float64))
                elif op == "pvalid":
                    outs.append(np.asarray(ok, bool) & v.valid.cpu().numpy())
                else:
                    a = host[k][offs[r]:offs[r] + G]
                    outs.append(a.view(np.float64).copy()
                                if reds[r][k].op in F_OPS else a.copy())
                    k += 1
            res.append(outs)
    return res


def region_agg_states(gid: np.ndarray, specs: list, G: int, n_rows: int,
                      device) -> list:
    """One region's states: region_agg_states_batched with R = 1."""
    return region_agg_states_batched([(gid, specs, G, n_rows)], device)[0]


# ---------------------------------------------------------------------------
# the micro-batch tier: K14 slot_filter, K15 slot_agg, K16 slot_topn and
# their plain versions. A slot is one statement: the shared program `fin`
# run with the slot's row of `pools` (int64 [k, P]) as its constant pool.
# ---------------------------------------------------------------------------

# K14 / K15's parameter block (ops/csrc/vm.cuh struct SlotParams): the
# plane pointers, the program, the slots' pools, K15's descriptors and
# the program's LUT ride by value in the launch, within these limits
SLOT_MAX_INSTRS = 64         # exprc.MAX_INSTRS
SLOT_POOL_WORDS = 2048       # k * P: sched.MAX_SLOTS x MAX_INSTRS
SLOT_LUT_BYTES = 512
# CUDA's limit on a launch's parameters (12.1 and later)
SLOT_PARAM_LIMIT = 32764
# the two blocks' (instructions, pool words, LUT bytes): the launcher
# takes the smaller where the parts fit it
SLOT_BLOCKS = ((24, 256, 64), (SLOT_MAX_INSTRS, SLOT_POOL_WORDS,
                               SLOT_LUT_BYTES))


def _slot_fin(fin: Finalized, pool: torch.Tensor) -> Finalized:
    return Finalized(fin.meta, pool.cpu().numpy(), fin.lut, fin.plane_keys,
                     fin.out_dts)


def _slot_masks_plain(fin: Finalized, pools: torch.Tensor, plane_list: list,
                      live: torch.Tensor) -> list:
    return [run_program_plain(_slot_fin(fin, pools[s]), plane_list, live)[0]
            for s in range(pools.shape[0])]


class _SlotProgram:
    """What K14 and K15 carry of one program, made once per bytecode and
    LUT: its split order (exprc.slot_split: instructions, the invariant
    part's length, the WHERE register, the registers written), the LUT,
    and their host addresses (the arrays are the object's own)."""

    __slots__ = ("split", "n_inv", "split_where", "n_regs", "n_instr", "lut",
                 "p_split", "p_lut")

    def __init__(self, fin: Finalized):
        if fin.n_instr > SLOT_MAX_INSTRS or len(fin.plane_keys) \
                > SLOT_MAX_PLANES or fin.lut.shape[0] > SLOT_LUT_BYTES:
            raise errors.DeviceError(
                f"{fin.n_instr} instructions, {len(fin.plane_keys)} planes "
                f"and a {fin.lut.shape[0]}-byte LUT exceed the slot "
                f"launch's parameters ({SLOT_MAX_INSTRS}, "
                f"{SLOT_MAX_PLANES}, {SLOT_LUT_BYTES})")
        code, self.n_inv, self.split_where = slot_split(fin)
        self.split = np.asarray(code, dtype=np.int64).reshape(-1)
        self.n_regs = 1 + max([x[1] for x in code], default=-1)
        self.n_instr = fin.n_instr
        self.lut = fin.lut.copy()
        self.p_split, self.p_lut = (a.__array_interface__["data"][0]
                                    for a in (self.split, self.lut))


_SLOT_PROGS: dict = {}       # (bytecode, LUT) -> _SlotProgram
_SLOT_LOCK = threading.Lock()


def _slot_inputs(fin: Finalized, pools: torch.Tensor, plane_list: list,
                 live: torch.Tensor) -> tuple:
    """The launch arguments K14 and K15 share, checked: (rows, slots, pool
    width, the program's _SlotProgram, its plane pointers as a host
    array). The launch copies the host parts into its parameters."""
    n = live.shape[0]
    _check_program_planes(fin, plane_list, live)
    if n % 64:
        raise errors.DeviceError(f"slot kernels need rows in multiples of "
                                 f"64, got {n}")
    if not isinstance(pools, torch.Tensor) or pools.device.type != "cpu" \
            or pools.dtype != torch.int64 or pools.dim() != 2 \
            or not pools.is_contiguous():
        raise errors.DeviceError("pools ride by value: a contiguous host "
                                 "int64 [k, P] tensor")
    k, P = pools.shape
    if k < 1 or P < len(fin.pool) or k * P > SLOT_POOL_WORDS:
        raise errors.DeviceError(
            f"{k} x {P} pool words for a {len(fin.pool)}-word pool: the "
            f"slot launch's parameters hold {SLOT_POOL_WORDS}")
    key = (fin.meta.tobytes(), fin.lut.tobytes())
    prog = _SLOT_PROGS.get(key)
    if prog is None:
        prog = _SlotProgram(fin)
        with _SLOT_LOCK:
            if len(_SLOT_PROGS) >= 512:
                _SLOT_PROGS.pop(next(iter(_SLOT_PROGS)))
            _SLOT_PROGS[key] = prog
    planes = array.array("Q", [t.data_ptr() for t in plane_list] or [0])
    return n, k, P, prog, planes


def slot_filter_plain(fin: Finalized, pools: torch.Tensor, plane_list: list,
                      live: torch.Tensor) -> torch.Tensor:
    words = [_pack_bits(m).view(torch.int64)
             for m in _slot_masks_plain(fin, pools, plane_list, live)]
    return torch.stack(words)


def slot_filter(fin: Finalized, pools: torch.Tensor, plane_list: list,
                live: torch.Tensor) -> torch.Tensor:
    """K14: int64 [k, n / 64] — bit r % 64 of word r / 64 of row s is
    live[r] & valid & truthy(WHERE) of the program run with pools[s]
    (the reference's packed words, bit 63 the sign bit). `pools` is a
    host int64 [k, P] tensor: on the card it rides in the launch's
    parameters with the program, nothing copied first."""
    if _device_kind(live) == "cpu":
        return slot_filter_plain(fin, pools, plane_list, live)
    n, k, P, prog, planes = _slot_inputs(fin, pools, plane_list, live)
    dev = live.device
    words = torch.empty((k, n // 64), dtype=torch.int64, device=dev)
    rc = _ext.lib("slot_filter").slot_filter_launch(
        n, k, P, planes.buffer_info()[0], len(plane_list), prog.p_split,
        prog.n_instr, prog.n_inv, prog.split_where, prog.n_regs,
        pools.data_ptr(), prog.p_lut, prog.lut.shape[0],
        live.data_ptr(), words.data_ptr(), _stream(dev))
    _ext.check(rc, "slot_filter")
    LAUNCHES["slot_filter"] += 1
    return words


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A card tensor's copy in page-locked host memory, the stream waited
    for (a pageable copy would stage through a bounce buffer); a host
    tensor as it is."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


def slot_agg_plain(fin: Finalized, pools: torch.Tensor, plane_list: list,
                   live: torch.Tensor, reds: list[Red]):
    ns, accs = [], []
    for mask in _slot_masks_plain(fin, pools, plane_list, live):
        n, acc = scalar_agg_plain(mask, reds)
        ns.append(n)
        accs.append(acc)
    return torch.stack(ns), torch.stack(accs)


# K15's plan (ops/csrc/slot_agg.cu mirrors these): row tiles of
# K15_THREADS x K15_ROWS rows, about K15_TARGET_BLOCKS blocks of row blocks
# x slot groups, at most K15_MAX_ROW_BLOCKS row blocks (the partials the
# last block of a group folds), at most K15_MAX_PAIRS (slot, reduction)
# pairs a group (their running values in shared memory) and K15_MAX_GROUP
# slots (a row's WHERE bits in one word)
K15_THREADS = 128
K15_ROWS = 2                 # rows a thread takes a tile
K15_TARGET_BLOCKS = 132 * 12
K15_MAX_ROW_BLOCKS = 132 * 12
K15_MAX_PAIRS = 512
K15_MAX_GROUP = 64
K15_SAME = 4                 # descriptor flag: a twin of reduction const_bits


def slot_agg_plan(n: int, k: int, n_red: int) -> tuple:
    """K15's grid for k slots over n rows with n_red reductions, sized as
    K14 sizes its own (slot_filter.cu): (groups, slots a group, row
    blocks, tiles a row block)."""
    tiles = -(-n // (K15_THREADS * K15_ROWS))
    groups = min(-(-K15_TARGET_BLOCKS // tiles), k)
    per_group = min(-(-k // groups), K15_MAX_PAIRS // n_red, K15_MAX_GROUP)
    groups = -(-k // per_group)
    rows = min(-(-K15_TARGET_BLOCKS // groups), K15_MAX_ROW_BLOCKS, tiles)
    tpb = -(-tiles // rows)
    return groups, per_group, -(-tiles // tpb), tpb


# K15's scratch head (slot_agg.cu): an integer cell (count, value) for
# every (slot, reduction) a launch can have and a ticket a group, at fixed
# places, each left at 0 by the launch that used it
K15_CELL_BYTES = 16 * SLOT_POOL_WORDS * SLOT_MAX_REDS
K15_TICKET_BYTES = 4 * SLOT_POOL_WORDS


def slot_agg_scratch_bytes(k: int, n_red: int, plan: tuple) -> int:
    """The cells and tickets, then each (slot, reduction, row block)'s
    partial (count, value) of the f64 reductions."""
    _groups, _per, rows, _tpb = plan
    return K15_CELL_BYTES + K15_TICKET_BYTES + 16 * k * n_red * rows


def slot_agg_states(fin: Finalized, pools: torch.Tensor, plane_list: list,
                    live: torch.Tensor, reds: list[Red]) -> torch.Tensor:
    """K15: int64 [k, R, 2] — per slot and reduction of K2's `reds` the
    (contributing count, value) under the slot's WHERE mask (the value
    holds f64 bits for f64 ops, the exact sentinels where no row
    contributes). `pools` as slot_filter's; the descriptors too ride in
    the launch's parameters. One launch; its cells, tickets and partials
    are a scratch kept per stream, so the call allocates only its
    output."""
    if _device_kind(live) == "cpu":
        return torch.stack(slot_agg_plain(fin, pools, plane_list, live, reds),
                           dim=2)
    if not 1 <= len(reds) <= SLOT_MAX_REDS:
        raise errors.DeviceError(f"K15 folds 1 to {SLOT_MAX_REDS} "
                                 f"reductions, got {len(reds)}")
    n, k, P, prog, planes = _slot_inputs(fin, pools, plane_list, live)
    dev = live.device
    R = len(reds)
    # a reduction equal to an earlier one folds nothing and copies that
    # one's result (K15_SAME, its index in const_bits)
    rows, first = _red_rows(reds, n, dev), {}
    for r, row in enumerate(rows):
        twin = first.setdefault(tuple(row), r)
        if twin != r:
            row[1] |= K15_SAME
            row[2] = twin
    desc = array.array("q", [x for row in rows for x in row])
    plan = slot_agg_plan(n, k, R)
    stream = _stream(dev)
    scratch = _stream_scratch("slot_agg", dev,
                              slot_agg_scratch_bytes(k, R, plan), stream)
    out = torch.empty((k, R, 2), dtype=torch.int64, device=dev)
    rc = _ext.lib("slot_agg").slot_agg_launch(
        n, k, P, planes.buffer_info()[0], len(plane_list), prog.p_split,
        prog.n_instr, prog.n_inv, prog.split_where, prog.n_regs,
        pools.data_ptr(), prog.p_lut, prog.lut.shape[0], live.data_ptr(), R,
        desc.buffer_info()[0], *plan, scratch.data_ptr(), out.data_ptr(),
        stream)
    _ext.check(rc, "slot_agg")
    LAUNCHES["slot_agg"] += 1
    return out


def slot_agg(fin: Finalized, pools: torch.Tensor, plane_list: list,
             live: torch.Tensor, reds: list[Red]):
    """K15 as (n int64 [k, R], acc int64 [k, R]): slot_agg_states' two
    halves."""
    out = slot_agg_states(fin, pools, plane_list, live, reds)
    return out[:, :, 0], out[:, :, 1]


def unpack_slot_words(words: torch.Tensor) -> torch.Tensor:
    """K14's int64 [k, n / 64] words → bool [k, n] masks, on their device."""
    k = words.shape[0]
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    b = words.contiguous().view(torch.uint8).reshape(k, -1, 1)
    return ((b >> shifts) & 1).reshape(k, -1).to(torch.bool)


def slot_topn_plain(words: torch.Tensor, keys: list, k: int):
    idx, n_live = [], []
    for mask in unpack_slot_words(words):
        i, nl = topk_select_plain(mask, keys, k)
        idx.append(i)
        n_live.append(nl)
    return torch.stack(idx), torch.cat(n_live)


_K16_CALLS: dict = {}
# int64 fields of a launch in K16's table (slot_topn.cu K16_CALL)
K16_CALL = 15


def _k16_calls(lib, dev: torch.device, slots: int, n: int, kk: int,
               nk: int) -> tuple:
    """K16's plan (_k20_plan with one shard a slot over the shared rows:
    merges never mix slots, the last level one block a slot), kept per
    shape as (scratch bytes, launches, the launches' table for
    slot_topn_launch: K16_CALL int64 a launch, scratch offsets relative to
    the stream's buffer, -1 for no list)."""
    key = (dev.index, slots, n, kk, nk)
    got = _K16_CALLS.get(key)
    if got is None:
        plan, (off_a, off_b, off_bound, off_live, total) = _k20_plan(
            lib.slot_topn_grid, dev, slots, n, kk, nk)
        bufs, table, done = (off_a, off_b), [], 0
        for r, (K, p_slots, levels) in enumerate(plan):
            for i, (blocks, fan) in enumerate(levels):
                final = i == len(levels) - 1
                table += [int(i == 0), blocks, K, p_slots,
                          bufs[(i - 1) % 2] if i else -1,
                          levels[i - 1][0] if i else 0, fan,
                          -1 if final else bufs[i % 2], off_bound,
                          int(r > 0 and i == 0), int(final), done,
                          int(r == 0 and (i == 0 or final)),
                          levels[0][0] // slots, off_live]
            done += K
        got = _K16_CALLS[key] = (total, len(table) // K16_CALL,
                                 array.array("q", table))
    return got


def slot_topn_launch_count(slots: int, n: int, k: int, nk: int,
                           device) -> int:
    """K16's launches for one call on the card (its plan's levels)."""
    dev = _device(device)
    return _k16_calls(_ext.lib("slot_topn"), dev, slots, n, min(int(k), n),
                      nk)[1]


def slot_topn(words: torch.Tensor, keys: list, k: int):
    """K16: (idx int64 [slots, min(k, n)], n_live int64 [slots]) — per slot
    K10's order (live first under the slot's mask words from K14; per
    ORDER BY item (values, valid), desc its null rank and value, -0.0 ==
    +0.0, reversed for DESC by complement; then row position) and
    min(live rows, k). On the card the launches follow shard_topk_plan
    (LAUNCHES counts each): K10's threshold filter with one shard a slot
    over the shared key rows, the keys by value, nothing copied to the
    card."""
    if len(keys) > TOPN_MAX_KEYS:
        raise errors.DeviceError(f"K16 takes at most {TOPN_MAX_KEYS} keys")
    if _device_kind(words) == "cpu":
        return slot_topn_plain(words, keys, k)
    dev = words.device
    if words.dtype != torch.int64 or words.dim() != 2 \
            or not words.is_contiguous() or words.shape[0] < 1:
        raise errors.DeviceError("mask words must be a contiguous int64 "
                                 "[slots, n / 64] block")
    slots, n = int(words.shape[0]), int(words.shape[1]) * 64
    kk = min(int(k), n)
    if kk <= 0:
        return (torch.empty((slots, 0), dtype=torch.int64, device=dev),
                torch.zeros(slots, dtype=torch.int64, device=dev))
    if n > K10_MAX_ROWS:
        raise errors.DeviceError(f"K16 takes at most {K10_MAX_ROWS} rows")
    flat = []
    for j, ((v, ok), desc) in enumerate(keys):
        _check_plane(v, n, (torch.int64, torch.float64), f"key {j}", dev)
        _check_plane(ok, n, (torch.bool,), f"key {j} valid", dev)
        flat += [v.data_ptr(), ok.data_ptr(), int(v.dtype == torch.float64),
                 int(bool(desc))]
    karr = array.array("q", flat or [0] * len(K10_KEY_FIELDS))
    lib = _ext.lib("slot_topn")
    total, n_calls, table = _k16_calls(lib, dev, slots, n, kk, len(keys))
    stream = _stream(dev)
    base = _stream_scratch("slot_topn", dev, total, stream).data_ptr()
    out = torch.empty(slots * (kk + 1), dtype=torch.int64, device=dev)
    op = out.data_ptr()
    _ext.check(lib.slot_topn_launch(
        n_calls, table.buffer_info()[0], len(keys), slots, n,
        words.data_ptr(), karr.buffer_info()[0], base, op, kk,
        op + 8 * slots * kk, stream), "slot_topn")
    LAUNCHES["slot_topn"] += n_calls
    return out[:slots * kk].view(slots, kk), out[slots * kk:]


# ---------------------------------------------------------------------------
# out-of-core sort and windows: K17 sort_perm, K18 window_scan and their
# plain versions (ops.extsort and executor.window drive them)
# ---------------------------------------------------------------------------

# K17 plane dtypes: the contract with ops/csrc/sort_perm.cu (bool as
# uint8: its 0 / 1 bytes)
_SORT_DTYPES = {torch.int64: 0, torch.float64: 1, torch.int32: 2,
                torch.int8: 3, torch.uint8: 4, torch.bool: 4}
# planes a summary launch reads, fields a composite word packs
K17_MAX_PLANES = 64
# rows one sort by radix.cuh takes (its int32 offsets); K17 splits longer
# ones (_k17_split)
K17_MAX_ROWS = (1 << 31) - 1
# the order word of every NaN: one above +inf's, numpy's NaN-last order
NAN_WORD = 0x7FF0000000000001


def sort_words(p: torch.Tensor) -> torch.Tensor:
    """The int64 order word of a key plane: integers widened as they are;
    f64 through `orderable` (-0.0 == +0.0), every NaN tied just above
    +inf. int64 order of the words is np.lexsort's order of the keys."""
    if p.dtype != torch.float64:
        return p.to(torch.int64)
    return torch.where(torch.isnan(p),
                       torch.full_like(p, NAN_WORD, dtype=torch.int64),
                       orderable(p))


def sort_perm_plain(planes: list, n: int) -> torch.Tensor:
    """Chained stable torch.sort passes over the planes' order words,
    least significant plane first."""
    perm = None
    for p in planes:
        w = sort_words(p)
        _, idx = torch.sort(w if perm is None else w[perm], stable=True)
        perm = idx if perm is None else perm[idx]
    if perm is None:
        perm = torch.arange(n, dtype=torch.int64)
    return perm


def sort_summary_plain(planes: list) -> list:
    """K17's summary: each plane's (AND, OR) of the unsigned images of its
    order words (the int64 word with its sign bit flipped)."""
    out = []
    for p in planes:
        u = sort_words(p).cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
        # no row: nothing varies
        out.append((int(np.bitwise_and.reduce(u)) if len(u) else 0,
                    int(np.bitwise_or.reduce(u)) if len(u) else 0))
    return out


def sort_plan(pairs: list) -> list:
    """K17's composite words, from each plane's (AND, OR) of its unsigned
    order words, planes least significant first. Plane j keeps its low
    w_j = bit_length(AND ^ OR) bits (those above are equal in every word;
    w_j = 0 drops the plane); the kept planes are packed, the most
    significant highest, into as few 64-bit words as hold them, none split
    across two. Returns the words least significant first (the order they
    are sorted in), each (fields, varying, passes): fields (plane, shift,
    width) from the word's lowest bits, varying the bits in which its rows
    differ, passes radix_plan's over them."""
    widths = [((a ^ o) & _U64).bit_length() for a, o in pairs]
    groups, cur, used = [], [], 0
    for j in reversed(range(len(pairs))):
        if not widths[j]:
            continue
        if used + widths[j] > 64:
            groups.append(cur)
            cur, used = [], 0
        cur.append(j)
        used += widths[j]
    if cur:
        groups.append(cur)
    words = []
    for group in reversed(groups):
        fields, shift, varying = [], 0, 0
        for j in reversed(group):
            a, o = pairs[j]
            fields.append((j, shift, widths[j]))
            varying |= ((a ^ o) & _U64) << shift
            shift += widths[j]
        words.append((tuple(fields), varying, radix_plan(varying, False)))
    return words


def sort_pack_plain(planes: list, fields, perm=None) -> torch.Tensor:
    """The composite word K17's pack writes: each field's low `width` bits
    of its plane's unsigned order word at its shift, the whole stored with
    its top bit flipped (so that int64 order is the composite's unsigned
    order); rows through `perm` (None: row order)."""
    n = planes[0].shape[0] if perm is None else perm.shape[0]
    c = torch.zeros(n, dtype=torch.int64, device=planes[0].device)
    for j, shift, width in fields:
        u = sort_words(planes[j]) ^ I64_MIN
        if perm is not None:
            u = u[perm]
        if width < 64:
            u = u & ((1 << width) - 1)
        c |= u << shift
    return c ^ I64_MIN


def device_oom(what: str, e: Exception) -> errors.DeviceOOM:
    """The DeviceOOM a torch.cuda.OutOfMemoryError in `what` maps to."""
    return errors.DeviceOOM(f"{what}: the card is out of memory ({e})")


def _check_sort(planes: list, n: int):
    """The device of K17's key planes (None: the CPU), checked."""
    if not planes:
        raise errors.DeviceError("sort_perm needs at least one key plane")
    if _device_kind(planes[0]) == "cpu":
        return None
    dev = planes[0].device
    for j, p in enumerate(planes):
        _check_plane(p, n, tuple(_SORT_DTYPES), f"sort key {j}", dev)
    return dev


def sort_perm(planes: list, n: int) -> torch.Tensor:
    """K17: the stable sort permutation (int64 [n]) of the key planes
    (f64 / int64 / int32 / int8 / uint8 / bool [n], np.lexsort's
    convention: least significant first, direction and NULL order already
    encoded by the caller), equal to np.lexsort(planes) bit for bit: ties
    keep input order, -0.0 ties +0.0, NaN sorts last. On the card: one
    summary launch read back once, then radix.cuh's passes over the packed
    composite words (sort_plan); an out-of-memory raises DeviceOOM, any
    other fault DeviceError."""
    n = int(n)
    dev = _check_sort(planes, n)
    if dev is None:
        return sort_perm_plain(planes, n)
    if n <= 1:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    return _k17_sort(planes, n, dev)[0]


def sort_perm_words(planes: list, n: int) -> tuple:
    """K17 with what it sorted: (perm, words, plan, pairs). plan is
    sort_plan's, pairs the summary it came from; words the sorted
    composite word (its stored image, int64 [n]) where the plan packs every
    kept plane into one word or none (then every word is equal), else None
    (and for n <= 1). On the card the last radix pass's word buffer, at no
    extra cost; on the CPU the plain versions."""
    n = int(n)
    dev = _check_sort(planes, n)
    if dev is not None:
        if n > 1:
            return _k17_sort(planes, n, dev)
        return torch.zeros(n, dtype=torch.int64, device=dev), None, [], []
    pairs = sort_summary_plain(planes)
    plan = sort_plan(pairs)
    perm = sort_perm_plain(planes, n)
    if n <= 1:
        return perm, None, plan, pairs
    words = None if len(plan) > 1 else sort_pack_plain(
        planes, plan[0][0] if plan else (), perm)
    return perm, words, plan, pairs


_K17_HOST: dict = {}


def _k17_host_summary(dev: torch.device, stream: int, k: int) -> tuple:
    """K17's summary in page-locked host memory, one per (device, stream),
    at least 2k u64 (grown by replacing it): (the tensor, a ctypes view,
    the lock a caller holds from its launch until it has read the view)."""
    key = (dev.index, stream)
    ent = _K17_HOST.get(key)
    if ent is None or ent[0].numel() < 2 * k:
        with _scratch_lock:
            ent = _K17_HOST.get(key)
            if ent is None or ent[0].numel() < 2 * k:
                size = max(2 * k, 16)
                buf = torch.empty(size, dtype=torch.int64,
                                  pin_memory=dev.type == "cuda")
                ent = (buf, (ctypes.c_uint64 * size).from_address(
                    buf.data_ptr()), threading.Lock())
                _K17_HOST[key] = ent
    return ent


def _c_array(ctype, values: list):
    return (ctype * max(len(values), 1))(*values)


def _k17_pack(lib, planes: list, fields, n: int, perm: int, out: int,
              stream: int) -> None:
    """One pack launch: the composite word of `fields` into `out`, rows
    through the permutation at `perm` (0: row order)."""
    rc = lib.sort_perm_pack_launch(
        n, len(fields),
        _c_array(ctypes.c_void_p, [planes[j].data_ptr() for j, _s, _w in
                                   fields]),
        _c_array(ctypes.c_int, [_SORT_DTYPES[planes[j].dtype]
                                for j, _s, _w in fields]),
        _c_array(ctypes.c_int, [s for _j, s, _w in fields]),
        _c_array(ctypes.c_uint64, [(1 << w) - 1 for _j, _s, w in fields]),
        perm, out, stream)
    _ext.check(rc, "sort_perm pack")


def _k17_sort(planes: list, n: int, dev: torch.device,
              max_rows: int = K17_MAX_ROWS) -> tuple:
    """K17 over n >= 2 checked card planes, as sort_perm_words: the
    summary launch and its readback (the one synchronisation; the buffers
    are in place before it), then per composite word, least significant
    first, a pack launch (row order for the first, through the
    permutation after) and its radix passes. Two word and two permutation
    buffers, 32 B a row, its whole working set; past max_rows rows,
    _k17_split within the same four."""
    lib = _ext.lib("sort_perm")
    stream = _stream(dev)
    k = len(planes)
    try:
        bufs = [torch.empty(n, dtype=torch.int64, device=dev)
                for _ in range(4)]
        scratch = _stream_scratch("sort_perm", dev, 16 * k, stream)
        host, view, lock = _k17_host_summary(dev, stream, k)
        with lock:
            rc = lib.sort_perm_summary_launch(
                n, k, _c_array(ctypes.c_void_p,
                               [p.data_ptr() for p in planes]),
                _c_array(ctypes.c_int, [_SORT_DTYPES[p.dtype]
                                        for p in planes]),
                scratch.data_ptr(), host.data_ptr(), stream)
            _ext.check(rc, "sort_perm summary")
            pairs = [(~view[2 * j] & _U64, view[2 * j + 1])
                     for j in range(k)]
        LAUNCHES["sort_perm"] += 1
        plan = sort_plan(pairs)
        if not plan:
            return (torch.arange(n, dtype=torch.int64, device=dev),
                    bufs[0].fill_(I64_MIN), plan, pairs)
        if n > max_rows:
            torch.arange(n, out=bufs[2])
            return _k17_split(lib, planes, plan, bufs, max_rows, dev,
                              stream), None, plan, pairs
        # buffer pairs (words, permutation)
        a = [bufs[0].data_ptr(), bufs[1].data_ptr()]
        b = [bufs[2].data_ptr(), bufs[3].data_ptr()]
        cur = _k17_run(lib, planes, plan, n, a, b, False, dev, stream)
    except torch.cuda.OutOfMemoryError as e:
        raise device_oom("sort_perm", e) from e
    i = 0 if cur is a else 2
    return bufs[i + 1], (bufs[i] if len(plan) == 1 else None), plan, pairs


def _k17_run(lib, planes: list, plan: list, n: int, a: list, b: list,
             listed: bool, dev: torch.device, stream: int) -> list:
    """The plan's packs and radix passes over n rows, with the buffer
    pairs a and b ((words, permutation) pointers): a pass writes the pair
    the previous one did not, a pack overwrites the words of the pair
    holding the permutation it reads. The rows are in row order, or
    (listed) those that a's permutation buffer lists. Returns the pair
    holding the sorted rows."""
    cur = a if listed else None
    for fields, _varying, passes in plan:
        if cur is None:
            _k17_pack(lib, planes, fields, n, 0, a[0], stream)
            order = [b, a]
            cur = order[_radix_passes(n, passes, a[0], 0, order, None,
                                      dev)]
        else:
            _k17_pack(lib, planes, fields, n, cur[1], cur[0], stream)
            order = [a if cur is b else b, cur]
            cur = order[_radix_passes(n, passes, cur[0], cur[1], order,
                                      None, dev)]
    return cur


# _k17_split's digit and row-list work goes in steps of a 64th of its rows
# (at least _K17_SPLIT_MIN_STEP), its temporaries a few bytes a step row
_K17_SPLIT_STEPS = 64
_K17_SPLIT_MIN_STEP = 1 << 16


def _k17_split(lib, planes: list, plan: list, bufs: list, max_rows: int,
               dev: torch.device, stream: int) -> torch.Tensor:
    """K17 over the rows that bufs[2] lists (ascending), past max_rows
    rows (radix.cuh counts in int32), within the four buffers [words,
    words, rows, rows] of as many rows: the top word (the plan's highest
    varying digit) packed into bufs[0], its digit into bufs[1]'s bytes,
    the rows regrouped stably into bufs[3] by parts (runs of digits, each
    of at most max_rows rows), each part then sorted in its slices of the
    four. A part of one digit drops that digit's pass; past max_rows it
    splits again by the next digit. Returns bufs[3], then the sorted
    rows; beyond the four only temporaries of a step's rows."""
    w0, w1, rows, out = bufs
    m = rows.shape[0]
    step = max(_K17_SPLIT_MIN_STEP, -(-m // _K17_SPLIT_STEPS))
    fields, varying, passes = plan[-1]
    shift = passes[-1][1]
    _k17_pack(lib, planes, fields, m, rows.data_ptr(), w0.data_ptr(), stream)
    digit = w1.view(torch.uint8)[:m]
    counts = torch.zeros(1 << RADIX_BITS, dtype=torch.int64, device=dev)
    for c in range(0, m, step):
        # the low 8 bits of an arithmetic shift are the digit's
        d = w0[c:c + step] ^ I64_MIN
        d.bitwise_right_shift_(shift).bitwise_and_((1 << RADIX_BITS) - 1)
        counts += torch.bincount(d, minlength=1 << RADIX_BITS)
        digit[c:c + step] = d
    # parts: (first digit, last digit, rows), the digits of rows only
    parts, size = [], 0
    for dg, cnt in enumerate(counts.tolist()):
        if not cnt:
            continue
        if size and size + cnt > max_rows:
            parts.append((lo, hi, size))
            size = 0
        if not size:
            lo = dg
        hi, size = dg, size + cnt
    parts.append((lo, hi, size))
    # the plan of a part of one digit: that digit's pass dropped
    rest = varying & ~(((1 << RADIX_BITS) - 1) << shift)
    one = plan[:-1] + ([(fields, rest, radix_plan(rest, False))]
                       if rest else [])
    spans, off = [], 0
    for lo, hi, size in parts:
        at = off
        for c in range(0, m, step):
            d = digit[c:c + step]
            sel = rows[c:c + step][(d >= lo) & (d <= hi)]
            out[at:at + sel.shape[0]] = sel
            at += sel.shape[0]
        spans.append((off, size, one if lo == hi else plan))
        off += size
    for off, size, sub in spans:
        part = [t[off:off + size] for t in (w0, w1, out, rows)]
        if size <= 1 or not sub:
            continue
        if size > max_rows:
            got = _k17_split(lib, planes, sub, part, max_rows, dev, stream)
        else:
            pa = [part[0].data_ptr(), part[2].data_ptr()]
            pb = [part[1].data_ptr(), part[3].data_ptr()]
            cur = _k17_run(lib, planes, sub, size, pa, pb, True, dev, stream)
            got = part[2] if cur is pa else part[3]
        if got.data_ptr() != part[2].data_ptr():
            part[2].copy_(got)
    return out


# K18's reductions and figures, its tile and its limits: the contract
# with ops/csrc/window_scan.cu
W_COUNT, W_SUM, W_MIN, W_MAX = range(4)
W_ROW_NUMBER, W_RANK, W_DENSE_RANK, W_FRAME = range(4)
_W_REDUCE = {"count": W_COUNT, "sum": W_SUM, "min": W_MIN, "max": W_MAX}
_W_RANK = {"row_number": W_ROW_NUMBER, "rank": W_RANK,
           "dense_rank": W_DENSE_RANK}
K18_TILE = 2048
K18_MAX_SPECS = 16
K18_MAX_RED = 4
_K18_LOCK = threading.Lock()
_K18_EPOCH: dict = {}        # (device, stream) -> the last call's epoch


def _seg_scan_doubling(v: torch.Tensor, s: torch.Tensor, op) -> torch.Tensor:
    """Inclusive scan of v under op restarting at each row's partition
    start s, by doubling: after the step of width d each row holds op
    over [max(s, i - 2d + 1), i]."""
    n = v.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=v.device)
    run = v
    d = 1
    while d < n:
        prev = torch.cat([run[:d], run[:-d]])
        run = torch.where(pos - d >= s, op(run, prev), run)
        d *= 2
    return run


def window_scan_plain(seg: torch.Tensor, peer: torch.Tensor, specs: list,
                      n: int) -> list:
    """The reference's formulas: searchsorted starts and frame ends,
    cumsum differences for SUM / COUNT (int64, modular), a segmented
    min/max scan gathered at the frame end."""
    dev = seg.device
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    s = torch.searchsorted(seg, seg)
    p = torch.searchsorted(peer, peer)
    e = torch.searchsorted(peer, peer, right=True) - 1
    outs = []
    for op, vals, contrib in specs:
        if op == "row_number":
            outs.append(pos - s + 1)
            continue
        if op == "rank":
            outs.append(p - s + 1)
            continue
        if op == "dense_rank":
            outs.append(peer - peer[s] + 1)
            continue
        ok = contrib.to(torch.bool)
        if op in ("sum", "count"):
            c = ok.to(torch.int64) if op == "count" \
                else torch.where(ok, vals, torch.zeros_like(vals))
            cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.cumsum(c, 0)])
            outs.append(cs[e + 1] - cs[s])
            continue
        sent = I64_MAX if op == "min" else I64_MIN
        v = torch.where(ok, vals, torch.full_like(vals, sent))
        run = _seg_scan_doubling(v, s, torch.minimum if op == "min"
                                 else torch.maximum)
        outs.append(run[e])
    return outs


def window_scan_plan(specs: list) -> tuple:
    """K18's arguments for `specs`: (reductions as (op, vals, contrib),
    figures as (kind, reduction index)); two specs of one op over the same
    planes share a reduction."""
    reds, figs, index = [], [], {}
    for op, vals, contrib in specs:
        if op in _W_RANK:
            figs.append((_W_RANK[op], 0))
            continue
        key = (op, None if vals is None else vals.data_ptr(),
               contrib.data_ptr())
        if key not in index:
            index[key] = len(reds)
            reds.append((_W_REDUCE[op], vals, contrib))
        figs.append((W_FRAME, index[key]))
    return reds, figs


def window_scan_launch_count(specs: list) -> int:
    """K18's launches a call: the scan, and the patch of the peer groups
    that run past their tile where a figure is a frame's."""
    return 1 + any(op in _W_REDUCE for op, _v, _c in specs)


def window_scan(seg: torch.Tensor, peer: torch.Tensor, specs: list,
                n: int) -> list:
    """K18: per spec an int64 [n] plane of window figures over presorted
    rows. seg / peer: int64 partition codes and global peer-group ids,
    both non-decreasing (a new partition always opens a new peer group).
    specs: ("row_number" | "rank" | "dense_rank", None, None) or ("sum" |
    "count" | "min" | "max", vals int64 or None for count, contrib bool),
    the frame RANGE UNBOUNDED PRECEDING .. the current row's last peer.
    SUM and COUNT wrap modulo 2^64 as the reference's cumsum difference
    does; MIN / MAX give I64_MAX / I64_MIN over an empty frame (the
    caller reads NULL from a COUNT spec). On the card: one single-pass
    scan over every spec, and a patch launch where a spec is a frame's
    (window_scan_launch_count); at most K18_MAX_SPECS specs over
    K18_MAX_RED distinct reductions."""
    n = int(n)
    if _device_kind(seg) == "cpu":
        return window_scan_plain(seg, peer, specs, n)
    dev = seg.device
    _check_plane(seg, n, (torch.int64,), "window partitions", dev)
    _check_plane(peer, n, (torch.int64,), "window peers", dev)
    for op, vals, contrib in specs:
        if op in _W_RANK:
            continue
        if op not in _W_REDUCE:
            raise errors.DeviceError(f"window_scan has no {op}")
        _check_plane(contrib, n, (torch.bool,), f"{op} contrib", dev)
        if op != "count":
            _check_plane(vals, n, (torch.int64,), f"{op} values", dev)
    reds, figs = window_scan_plan(specs)
    if len(specs) > K18_MAX_SPECS or len(reds) > K18_MAX_RED:
        raise errors.DeviceError(
            f"K18 takes at most {K18_MAX_SPECS} specs over at most "
            f"{K18_MAX_RED} reductions, got {len(specs)} over {len(reds)}")
    if n == 0 or not specs:
        return [torch.empty(0, dtype=torch.int64, device=dev) for _ in specs]
    lib = _ext.lib("window_scan")
    stream = _stream(dev)
    try:
        outs = list(torch.empty((len(specs), n), dtype=torch.int64,
                                device=dev).unbind(0))
        state = _stream_scratch("window_scan", dev,
                                lib.window_scan_state_bytes(n, len(reds)),
                                stream)
        aux = _stream_scratch("window_scan_aux", dev,
                              lib.window_scan_aux_bytes(n, len(reds)),
                              stream)
    except torch.cuda.OutOfMemoryError as e:
        raise device_oom("window_scan", e) from e
    rarr = array.array("q", [x for op, vals, contrib in reds for x in (
        op, 0 if vals is None else vals.data_ptr(), contrib.data_ptr())]
        or [0])
    farr = array.array("q", [x for (kind, r), out in zip(figs, outs)
                             for x in (kind, r, out.data_ptr())])
    launched = ctypes.c_int(0)
    key = (dev.index, stream)
    # the scan and its patch share the stream's scratch: enqueue them
    # together, each call with an epoch above the last
    with _K18_LOCK:
        epoch = _K18_EPOCH[key] = _K18_EPOCH.get(key, 0) + 1
        rc = lib.window_scan_launch(
            n, seg.data_ptr(), peer.data_ptr(), len(reds),
            rarr.buffer_info()[0], len(figs), farr.buffer_info()[0],
            state.data_ptr(), aux.data_ptr(), epoch, ctypes.byref(launched),
            stream)
    LAUNCHES["window_scan"] += launched.value
    _ext.check(rc, "window_scan")
    return outs


# ---------------------------------------------------------------------------
# the HTAP freshness tier: K19 delta_merge_order and its plain version
# (copr.delta drives it)
# ---------------------------------------------------------------------------

# K19 precondition flags: the contract with ops/csrc/delta_merge.cu
K19_BROKEN = {1: "the live base handles do not strictly ascend",
              2: "the tombstone handles do not ascend",
              4: "the appended handles do not ascend",
              8: "a live base or appended handle is the I64_MAX sentinel"}


def delta_merge_order_plain(handles: torch.Tensor, live: torch.Tensor,
                            tomb: torch.Tensor,
                            app: torch.Tensor) -> torch.Tensor:
    """The reference's program literally: a searchsorted of the handles
    into the sorted tombstones for the keep mask, dead and tombstoned rows
    given I64_MAX, the appended handles concatenated, one stable argsort,
    the first count(keep) + k indices. Holds for any input."""
    m = tomb.shape[0]
    if m:
        pos = torch.searchsorted(tomb, handles)
        dead = (pos < m) & (tomb[pos.clamp(max=m - 1)] == handles)
        keep = live & ~dead
    else:
        keep = live.clone()
    all_h = torch.cat([torch.where(keep, handles,
                                   torch.full_like(handles, I64_MAX)), app])
    order = torch.argsort(all_h, stable=True)
    return order[:int(keep.sum()) + app.shape[0]]


def delta_merge_handles_plain(handles: torch.Tensor, app: torch.Tensor,
                              order: torch.Tensor) -> torch.Tensor:
    """The merged handle plane of a merge order: the handle of the row at
    each position."""
    return torch.cat([handles, app])[order]


# K19's workspace (the ticket and the tiles' tagged states) is kept per
# (device, stream) and never reset: each call takes its stream's next
# epoch, under the lock, with its launch
_K19_EPOCH: dict = {}
_K19_LOCK = threading.Lock()


def delta_merge_prepare(handles: torch.Tensor, live: torch.Tensor,
                        tomb: torch.Tensor, app: torch.Tensor,
                        merged: torch.Tensor | None = None):
    """Everything of a K19 launch but the launch: checks and outputs.
    Returns (launch, order, meta); launch() enqueues the kernel (one
    launch) into order (n + k int64, the first meta[0] + k written) and
    merged (when given: the handle at each of those positions it holds);
    its last tile writes meta ([kept rows, precondition flags]) straight
    into this page-locked host tensor, to read once the stream has passed
    the launch."""
    dev = handles.device
    n, m, k = handles.shape[0], tomb.shape[0], app.shape[0]
    _check_plane(handles, n, (torch.int64,), "base handles", dev)
    _check_plane(live, n, (torch.bool,), "base live", dev)
    _check_plane(tomb, m, (torch.int64,), "tombstones", dev)
    _check_plane(app, k, (torch.int64,), "appended handles", dev)
    if merged is not None:
        _check_plane(merged, merged.shape[0], (torch.int64,),
                     "merged handles", dev)
    lib = _ext.lib("delta_merge")
    st = _stream(dev)
    order = torch.empty(max(n + k, 1), dtype=torch.int64, device=dev)
    meta = torch.empty(2, dtype=torch.int64, pin_memory=True)
    ws = _stream_scratch("delta_merge", dev,
                         lib.delta_merge_workspace_bytes(n), st)
    key = (dev.index, st)
    args = (n, handles.data_ptr(), live.data_ptr(), tomb.data_ptr(), m,
            app.data_ptr(), k, order.data_ptr(),
            None if merged is None else merged.data_ptr(),
            0 if merged is None else merged.shape[0], ws.data_ptr())
    fn = lib.delta_merge_launch

    def launch():
        with _K19_LOCK:
            epoch = _K19_EPOCH[key] = _K19_EPOCH.get(key, 0) + 1
            rc = fn(*args, epoch, meta.data_ptr(), st)
        _ext.check(rc, "delta_merge_order")
        LAUNCHES["delta_merge_order"] += 1

    return launch, order, meta


def delta_merge_order(handles: torch.Tensor, live: torch.Tensor,
                      tomb: torch.Tensor, app: torch.Tensor,
                      merged: torch.Tensor | None = None) -> torch.Tensor:
    """K19: the merge order (int64 [count(keep) + k]) of a base batch's
    rows (handles int64 [n], live bool [n]) and a delta's appended rows
    (app int64 [k], sorted), base rows whose handle is in the sorted
    tombstones (tomb int64 [m]) and dead rows dropped: i < n is base row
    i, n + j appended row j, ascending by handle, a base row before an
    appended row of the same handle. With `merged` (an int64 plane on the
    same device holding at least count(keep) + k), position p of it takes
    the handle of the row at p (delta_merge_handles_plain); the rest is
    left as it is. The kernel merges two sorted runs: the live base
    handles must strictly ascend and no live or appended handle may be
    I64_MAX (the sentinel), or it raises DeviceError naming the broken
    precondition; the order stays on the device."""
    if _device_kind(handles) == "cpu":
        order = delta_merge_order_plain(handles, live, tomb, app)
        if merged is not None:
            _merged_room(merged, order.shape[0])
            merged[:order.shape[0]] = delta_merge_handles_plain(
                handles, app, order)
        return order
    try:
        launch, order, meta = delta_merge_prepare(handles, live, tomb, app,
                                                  merged)
        launch()
        torch.cuda.current_stream(handles.device).synchronize()
        n_kept, flags = meta.tolist()
    except torch.cuda.OutOfMemoryError as e:
        raise device_oom("delta_merge_order", e) from e
    if flags:
        raise errors.DeviceError(
            "delta_merge_order: " + "; ".join(
                what for bit, what in K19_BROKEN.items() if flags & bit))
    if merged is not None:
        _merged_room(merged, n_kept + app.shape[0])
    return order[:n_kept + app.shape[0]]


def _merged_room(merged: torch.Tensor, rows: int) -> None:
    if merged.shape[0] < rows:
        raise errors.DeviceError(f"delta_merge_order: the merged handle "
                                 f"plane holds {merged.shape[0]} of {rows} "
                                 "rows")
