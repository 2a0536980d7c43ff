"""Aggregation/filter kernels over columnar batches (the port of
tidb_tpu/ops/kernels.py: batch_planes :202, device_live :384, AggSpec /
lower_aggregates :399-430, GroupSpec / lower_group_by :475-552 (radix
kind), build_scalar_agg_fn :713, build_grouped_agg_fn :903,
build_filter_fn :1970, and for the cluster region path
combine_region_partials :1082, region_agg_states :1204, bucket_segments
:1343, region_agg_states_batched :1356, region_filter_batched :1552).

Every request runs as K1 (`expr_vm`: WHERE mask, aggregate arguments and
group id in one pass) followed, for aggregates, by K2 (`scalar_agg`) or,
grouped, by K3 (`seg_agg_onehot`, S <= ONEHOT_SEGMENTS_MAX) or K4
(`seg_agg_sorted`, above). Each wrapper launches its hand-written CUDA
kernel for tensors on the card and runs its plain PyTorch version for
tensors on the CPU; any other case raises. `LAUNCHES` counts the kernel
launches (not the plain runs) per kernel.

A statement over R regions runs K5 (`expr_vm_ragged`: every region's
WHERE and aggregate-argument programs in one launch, bit-packed survivor
masks), K6 (`seg_states_ragged`: every region's grouped states in one
launch) and, in the final aggregate, K7 (`combine_partials`: the merge
over the region axis). `CALLS` counts the calls of their wrappers, kernel
or plain alike.

Outputs keep the reference's layout: a scalar aggregate gives (n,) for
count and (n, value) for the others; a grouped one gives row_count[S]
first, then the same per aggregate as [S] arrays, the last segment being
the dead-row sink.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from tidb_tpu_torch import errors
from tidb_tpu_torch.copr.proto import AGG_NAME, ExprType, SelectRequest
from tidb_tpu_torch.ops import _ext, columnar as col
from tidb_tpu_torch.ops.exprc import (CompiledExpr, Finalized, Program,
                                      Unsupported, _dec_guard, compile_expr,
                                      run_program_plain)

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
F64_MAX = float(np.finfo(np.float64).max)

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
# counted); K6 counts its two routes apart: spans within its shared-memory
# limit (seg_states_ragged) and larger ones (seg_states_ragged_sorted)
LAUNCHES = {"expr_vm": 0, "scalar_agg": 0, "seg_agg_onehot": 0,
            "seg_agg_sorted": 0, "expr_vm_ragged": 0, "seg_states_ragged": 0,
            "seg_states_ragged_sorted": 0, "combine_partials": 0}

# calls of the cluster path's statement-level wrappers, kernel or plain
CALLS = {"region_filter_batched": 0, "region_agg_states_batched": 0,
         "combine_region_partials": 0}

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
    return planes


def device_live(batch: col.ColumnBatch, device: torch.device) -> torch.Tensor:
    """Device-resident row-liveness plane, memoized on the batch."""
    cache = getattr(batch, "_device_live", None)
    if cache is None:
        cache = batch._device_live = {}
    key = str(device)
    live = cache.get(key)
    if live is None:
        live = cache[key] = torch.from_numpy(batch.row_mask()).to(device)
    return live


# ---------------------------------------------------------------------------
# aggregate spec lowering
# ---------------------------------------------------------------------------

class AggSpec:
    """One pushed aggregate lowered to its masked-reduction pieces."""

    def __init__(self, name: str, arg: CompiledExpr | None):
        self.name = name
        self.arg = arg


def lower_aggregates(req: SelectRequest, batch: col.ColumnBatch,
                     prog: Program) -> list[AggSpec]:
    specs = []
    for e in req.aggregates:
        name = AGG_NAME[e.tp]
        if name not in ("count", "sum", "avg", "min", "max", "first_row"):
            raise Unsupported(f"aggregate {name} not lowered yet")
        if e.distinct:
            # the reference's sort-based distinct kernels come later
            raise Unsupported(f"distinct {name} not ported yet")
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
        specs.append(AggSpec(name, arg))
    return specs


class GroupSpec:
    """Lowered group-by. 'radix': mixed-radix code over per-column
    dictionary codes (K_STR codes from the pack dictionary, numeric/time
    codes from ColumnBatch.group_codes). 'rank' marks a cross product
    beyond RADIX_MAX_SEGMENTS, whose kernel is not ported yet."""

    def __init__(self, kind: str, cids: list[int], sizes: list[int],
                 plane_keys=None, decoders=None):
        self.kind = kind
        self.cids = cids
        self.sizes = sizes
        self.plane_keys = plane_keys or []
        self.decoders = decoders or []


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
    sizes, decoders = [], []
    for cid in cids:
        cd = batch.columns[cid]
        if cd.kind == col.K_STR:
            sizes.append(max(len(cd.dictionary), 1))
            decoders.append(("str", cd.dictionary))
        else:
            _codes, uniq = batch.group_codes(cid)
            sizes.append(max(len(uniq), 1))
            if cd.kind == col.K_DEC:
                decoders.append(("dec", uniq, cd.dec_scale))
            else:
                decoders.append(("num", uniq))
    plane_keys = [cid if kind == col.K_STR else group_code_key(cid)
                  for cid, kind in zip(cids, kinds)]
    num_segments = 1
    for s in sizes:
        num_segments *= s + 1
    if num_segments + 1 <= RADIX_MAX_SEGMENTS:
        return GroupSpec("radix", cids, sizes, plane_keys, decoders)
    return GroupSpec("rank", cids, [])


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


def build_scalar_agg_fn(prog: Program, where: CompiledExpr | None,
                        specs: list[AggSpec]):
    """Returns fn(planes, live) → flat list of reduction results."""
    outputs = program_outputs(specs)
    fin = prog.finalize(where, outputs)

    def fn(planes, live):
        mask, _gid, outs = run_k1(fin, planes, live, outputs, False)
        reds = [spec_reduction(s, planes, outs) for s in specs]
        n, acc = scalar_agg(mask, reds)
        return _agg_outputs(specs, _unpack(reds, n, acc))

    fn.program = fin
    return fn


def build_grouped_agg_fn(prog: Program, where: CompiledExpr | None,
                         specs: list[AggSpec], group_keys: list,
                         dict_sizes: list[int]):
    """fn(planes, live) → (row_count, per-spec arrays…), each sized
    num_segments = prod(dict sizes + 1) + 1; the LAST segment is the
    dead-row sink (padding + filtered rows), dropped by the caller. NULL
    group values take the reserved code slot `size` of their column."""
    radices = [s + 1 for s in dict_sizes]
    num_segments = 1
    for r in radices:
        num_segments *= r
    num_segments += 1  # dead-row sink
    outputs = program_outputs(specs)
    fin = prog.finalize(where, outputs,
                        group=list(zip(group_keys, dict_sizes)),
                        sink=num_segments - 1)

    def fn(planes, live):
        mask, gid, outs = run_k1(fin, planes, live, outputs, True)
        reds = [Red(R_COUNT)] + [spec_reduction(s, planes, outs) for s in specs]
        if num_segments <= ONEHOT_SEGMENTS_MAX:
            n, acc = seg_agg_onehot(gid, mask, num_segments, reds)
        else:
            n, acc = seg_agg_sorted(gid, mask, num_segments, reds)
        per_red = _unpack(reds, n, acc)
        return [per_red[0][0]] + _agg_outputs(specs, per_red[1:])

    fn.num_segments = num_segments
    fn.radices = radices
    fn.program = fin
    return fn


def build_filter_fn(prog: Program, where: CompiledExpr | None):
    fin = prog.finalize(where, [])

    def fn(planes, live):
        mask, _gid, _outs = run_k1(fin, planes, live, [], False)
        return (mask,)

    fn.program = fin
    return fn


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
    if t.device != device:
        raise errors.DeviceError(f"{what} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise errors.DeviceError(f"{what} of dtype {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise errors.DeviceError(f"{what} must be a contiguous [{n}] plane")


def _ptr_table(tensors, device) -> torch.Tensor:
    ptrs = [0 if t is None else t.data_ptr() for t in tensors] or [0]
    return torch.tensor(ptrs, dtype=torch.int64).to(device)


def _device(device) -> torch.device:
    """A torch.device with its index: "cuda" means the current card, so
    that it compares equal to the device of the tensors on it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def expr_vm(fin: Finalized, plane_list: list, live: torch.Tensor,
            want_gid: bool):
    """K1: (mask bool[n], gid int64[n] | None, [(values, valid)] per
    program output)."""
    if _device_kind(live) == "cpu":
        mask, gid, values = run_program_plain(fin, plane_list, live)
        return mask, (gid if want_gid else None), values
    dev = live.device
    n = live.shape[0]
    _check_plane(live, n, (torch.bool,), "live plane", dev)
    for key_which, t in zip(fin.plane_keys, plane_list):
        dtypes = (torch.bool,) if key_which[1] else (torch.int64,
                                                     torch.float64)
        _check_plane(t, n, dtypes, f"plane {key_which}", dev)
    where, out_regs, grp = fin.tail()
    if bool(grp) != want_gid:
        raise errors.DeviceError("group id requested without group planes")
    meta = torch.from_numpy(fin.meta).to(dev)
    pool = torch.from_numpy(fin.pool).to(dev)
    lut = torch.from_numpy(fin.lut).to(dev)
    planes_t = _ptr_table(plane_list, dev)
    mask = torch.empty(n, dtype=torch.bool, device=dev)
    gid = torch.empty(n, dtype=torch.int64, device=dev) if want_gid else None
    values, out_ptrs = [], []
    for dt in fin.out_dts:
        v = torch.empty(n, dtype=torch.float64 if dt == "f" else torch.int64,
                        device=dev)
        ok = torch.empty(n, dtype=torch.bool, device=dev)
        values.append((v, ok))
        out_ptrs.extend([v, ok])
    outs_t = _ptr_table(out_ptrs, dev)
    rc = _ext.lib("expr_vm").expr_vm_launch(
        n, meta.data_ptr(), int(meta.shape[0]), pool.data_ptr(),
        lut.data_ptr(), planes_t.data_ptr(), live.data_ptr(),
        mask.data_ptr(), 0 if gid is None else gid.data_ptr(),
        outs_t.data_ptr(), _stream(dev))
    _ext.check(rc, "expr_vm")
    LAUNCHES["expr_vm"] += 1
    return mask, gid, values


# ---------------------------------------------------------------------------
# K2 / K3 / K4 and their plain version
# ---------------------------------------------------------------------------

def _red_desc(reds: list[Red], n: int, device) -> torch.Tensor:
    rows = []
    for red in reds:
        flags = (RED_CONST if red.values is None else 0) \
            | (RED_NEVER if red.never else 0)
        if red.values is not None:
            want = torch.float64 if red.op in F_OPS else torch.int64
            if red.values.dtype != want and red.op != R_COUNT:
                raise errors.DeviceError(
                    f"reduction op {red.op} over {red.values.dtype}")
            _check_plane(red.values, n, (torch.int64, torch.float64),
                         "reduction values", device)
        if red.valid is not None:
            _check_plane(red.valid, n, (torch.bool,), "reduction valid",
                         device)
        rows.append([red.op, flags, red.const_bits,
                     0 if red.values is None else red.values.data_ptr(),
                     0 if red.valid is None else red.valid.data_ptr()])
    return torch.tensor(rows, dtype=torch.int64).reshape(-1).to(device)


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
    return {R_MIN_I: I64_MAX, R_FIRST: I64_MAX, R_MAX_I: I64_MIN,
            R_MIN_F: F64_MAX, R_MAX_F: -F64_MAX}[op]


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
    """K2: (n int64[R], acc int64[R]) — acc holds f64 bits for f64 ops."""
    if _device_kind(mask) == "cpu":
        return scalar_agg_plain(mask, reds)
    dev = mask.device
    n = mask.shape[0]
    _check_plane(mask, n, (torch.bool,), "mask", dev)
    lib = _ext.lib("scalar_agg")
    desc = _red_desc(reds, n, dev)
    blocks = lib.scalar_agg_blocks(n)
    partial = torch.empty(len(reds) * blocks * 2, dtype=torch.int64,
                          device=dev)
    out = torch.empty(len(reds) * 2, dtype=torch.int64, device=dev)
    rc = lib.scalar_agg_launch(n, mask.data_ptr(), len(reds),
                               desc.data_ptr(), partial.data_ptr(),
                               out.data_ptr(), _stream(dev))
    _ext.check(rc, "scalar_agg")
    LAUNCHES["scalar_agg"] += 1
    out = out.view(len(reds), 2)
    return out[:, 0], out[:, 1]


def _check_gid(gid, mask, dev):
    _check_plane(mask, mask.shape[0], (torch.bool,), "mask", dev)
    _check_plane(gid, mask.shape[0], (torch.int64,), "group id", dev)


def seg_agg_onehot(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
                   reds: list[Red]):
    """K3 (S <= ONEHOT_SEGMENTS_MAX): (n int64[R, S], acc int64[R, S])."""
    if num_segments > ONEHOT_SEGMENTS_MAX:
        raise errors.DeviceError(
            f"{num_segments} segments exceed the one-hot kernel's "
            f"{ONEHOT_SEGMENTS_MAX}")
    if _device_kind(mask) == "cpu":
        return seg_agg_plain(gid, mask, num_segments, reds)
    dev = mask.device
    _check_gid(gid, mask, dev)
    n = mask.shape[0]
    lib = _ext.lib("seg_agg_onehot")
    desc = _red_desc(reds, n, dev)
    blocks = lib.seg_onehot_blocks(n)
    partial = torch.empty(len(reds) * num_segments * blocks * 2,
                          dtype=torch.int64, device=dev)
    out = torch.empty(len(reds) * num_segments * 2, dtype=torch.int64,
                      device=dev)
    rc = lib.seg_onehot_launch(n, gid.data_ptr(), mask.data_ptr(),
                               num_segments, len(reds), desc.data_ptr(),
                               partial.data_ptr(), out.data_ptr(),
                               _stream(dev))
    _ext.check(rc, "seg_agg_onehot")
    LAUNCHES["seg_agg_onehot"] += 1
    out = out.view(len(reds), num_segments, 2)
    return out[..., 0], out[..., 1]


def seg_agg_sorted(gid: torch.Tensor, mask: torch.Tensor, num_segments: int,
                   reds: list[Red]):
    """K4 (S > ONEHOT_SEGMENTS_MAX): a stable sort of the group ids, then
    the segmented reduction kernel over the sorted runs."""
    if _device_kind(mask) == "cpu":
        return seg_agg_plain(gid, mask, num_segments, reds)
    dev = mask.device
    _check_gid(gid, mask, dev)
    n = mask.shape[0]
    gid_sorted, order = torch.sort(gid, stable=True)
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


def k5_prepare(regions: list, dev):
    """Everything of a K5 launch but the launch: checks, the descriptor,
    tile, program and pointer tables moved to the card, the outputs
    allocated. Returns (launch, bits, outs); launch() runs the kernel
    into bits and outs."""
    dev = _device(dev)
    dts = _out_dts(regions)
    desc, metas, pools, luts, ptrs = [], [], [], [], []
    tile_region, tile_first = [], []
    base = m_off = p_off = l_off = 0
    for r, rp in enumerate(regions):
        fin = rp.fin
        if rp.cap % K5_TILE or rp.cap <= 0:
            raise errors.DeviceError(f"region capacity {rp.cap} is not a "
                                     f"multiple of {K5_TILE}")
        if len(fin.meta) > 1024:
            raise errors.DeviceError("region program exceeds K1_MAX_META")
        for (key, which), t in zip(fin.plane_keys, rp.planes):
            dtypes = (torch.bool,) if which else (torch.int64, torch.float64)
            _check_plane(t, rp.cap, dtypes, f"region {r} plane {key}", dev)
        desc.append([base, rp.cap, rp.n_rows, len(ptrs), m_off,
                     len(fin.meta), p_off, l_off])
        tile_first.append(len(tile_region))
        tile_region.extend([r] * (rp.cap // K5_TILE))
        metas.append(fin.meta)
        pools.append(fin.pool)
        luts.append(fin.lut)
        ptrs.extend(t.data_ptr() for t in rp.planes)
        base += rp.cap
        m_off += len(fin.meta)
        p_off += len(fin.pool)
        l_off += len(fin.lut)
    total = base
    bits = torch.empty(total // 32, dtype=torch.int32, device=dev)
    outs, out_ptrs = [], []
    for dt in dts:
        v = torch.empty(total, dtype=torch.float64 if dt == "f"
                        else torch.int64, device=dev)
        ok = torch.empty(total, dtype=torch.bool, device=dev)
        outs.append((v, ok))
        out_ptrs.extend([v.data_ptr(), ok.data_ptr()])
    t_desc = torch.tensor(desc, dtype=torch.int64).reshape(-1).to(dev)
    t_tiles = torch.tensor(tile_region, dtype=torch.int32).to(dev)
    t_first = torch.tensor(tile_first, dtype=torch.int32).to(dev)
    t_meta = torch.from_numpy(np.concatenate(metas)).to(dev)
    t_pool = torch.from_numpy(np.concatenate(pools)).to(dev)
    t_lut = torch.from_numpy(np.concatenate(luts)).to(dev)
    t_planes = torch.tensor(ptrs or [0], dtype=torch.int64).to(dev)
    t_outs = torch.tensor(out_ptrs or [0], dtype=torch.int64).to(dev)
    lib = _ext.lib("expr_vm")

    def launch():
        rc = lib.expr_vm_ragged_launch(
            len(tile_region), t_desc.data_ptr(), t_tiles.data_ptr(),
            t_first.data_ptr(), t_meta.data_ptr(), t_pool.data_ptr(),
            t_lut.data_ptr(), t_planes.data_ptr(), bits.data_ptr(),
            t_outs.data_ptr(), _stream(dev))
        _ext.check(rc, "expr_vm_ragged")
        LAUNCHES["expr_vm_ragged"] += 1

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


def k6_prepare(gid: torch.Tensor, caps: list, n_rows: list, Gs: list,
               reds: list, contribs: list):
    """Everything of a K6 launch but the launch (checks, tables, route,
    buffers). Returns (launch, out); launch() runs the kernel (with the
    stable sort of the offset ids on the large-span route) into out."""
    dev = gid.device
    R, n_red = len(caps), len(contribs)
    total = int(sum(caps))
    _check_plane(gid, total, (torch.int64,), "group id", dev)
    spans, offs, bases = _k6_layout(caps, Gs)
    S = int(offs[-1])
    lib = _ext.lib("seg_states_ragged")
    tile = lib.seg_states_tile()
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
    tile_region, rdesc = [], []
    for r in range(R):
        rdesc.append([int(bases[r]), int(n_rows[r]), int(offs[r]),
                      spans[r], len(tile_region)])
        tile_region.extend([r] * ((int(n_rows[r]) + tile - 1) // tile))
    t_rdesc = torch.tensor(rdesc, dtype=torch.int64).reshape(-1).to(dev)
    t_red = torch.tensor(red_rows, dtype=torch.int64).reshape(-1).to(dev)
    t_vals = torch.tensor(vals, dtype=torch.int64).to(dev)
    t_valid = torch.tensor(valids, dtype=torch.int64).to(dev)
    out = torch.empty(n_red * S, dtype=torch.int64, device=dev)
    span_max = max(spans)
    if lib.seg_states_smem_bytes(n_red, span_max) \
            <= lib.seg_states_smem_limit():
        route = "seg_states_ragged"
        t_tiles = torch.tensor(tile_region or [0], dtype=torch.int32).to(dev)
        part = torch.empty(max(len(tile_region), 1) * n_red * span_max,
                           dtype=torch.int64, device=dev)

        def run() -> int:
            return lib.seg_states_tiles_launch(
                len(tile_region), t_rdesc.data_ptr(), R, t_tiles.data_ptr(),
                gid.data_ptr(), n_red, t_red.data_ptr(), t_vals.data_ptr(),
                t_valid.data_ptr(), span_max, S, part.data_ptr(),
                out.data_ptr(), _stream(dev))
    else:
        route = "seg_states_ragged_sorted"
        region_off = torch.repeat_interleave(
            torch.from_numpy(offs[:-1]).to(dev),
            torch.tensor(caps, device=dev))
        part = torch.empty(4 * n_red * lib.seg_states_pieces_count(total),
                           dtype=torch.int64, device=dev)

        def run() -> int:
            gs, order = torch.sort(gid + region_off, stable=True)
            return lib.seg_states_sorted_launch(
                total, gs.data_ptr(), order.data_ptr(), t_rdesc.data_ptr(), R,
                S, n_red, t_red.data_ptr(), t_vals.data_ptr(),
                t_valid.data_ptr(), part.data_ptr(), out.data_ptr(),
                _stream(dev))

    def launch():
        _ext.check(run(), route)
        LAUNCHES[route] += 1

    return launch, out.view(n_red, S)


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
    desc, flat, in_off, out_off = [], [], 0, 0
    for s, op in zip(states, codes):
        if s.ndim != 2 or s.shape[0] != R:
            raise errors.DeviceError("combine states must be [R, G]")
        want = np.float64 if op in F_OPS else np.int64
        a = np.ascontiguousarray(s, dtype=want).view(np.int64)
        desc.append([op, in_off, a.shape[1], out_off])
        flat.append(a.reshape(-1))
        in_off += a.size
        out_off += a.shape[1]
    t_in = torch.from_numpy(np.concatenate(flat)).to(dev)
    t_desc = torch.tensor(desc, dtype=torch.int64).reshape(-1).to(dev)
    out = torch.empty(max(out_off, 1), dtype=torch.int64, device=dev)
    lib = _ext.lib("combine_partials")

    def launch():
        rc = lib.combine_partials_launch(
            len(states), R, t_desc.data_ptr(), t_in.data_ptr(),
            out.data_ptr(), out_off, _stream(dev))
        _ext.check(rc, "combine_partials")
        LAUNCHES["combine_partials"] += 1

    return launch, out, desc


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
