"""Aggregation/filter kernels over columnar batches (the port of
tidb_tpu/ops/kernels.py: batch_planes :202, device_live :384, AggSpec /
lower_aggregates :399-430, GroupSpec / lower_group_by :475-552 (radix
kind), build_scalar_agg_fn :713, build_grouped_agg_fn :903,
build_filter_fn :1970).

Every request runs as K1 (`expr_vm`: WHERE mask, aggregate arguments and
group id in one pass) followed, for aggregates, by K2 (`scalar_agg`) or,
grouped, by K3 (`seg_agg_onehot`, S <= ONEHOT_SEGMENTS_MAX) or K4
(`seg_agg_sorted`, above). Each wrapper launches its hand-written CUDA
kernel for tensors on the card and runs its plain PyTorch version for
tensors on the CPU; any other case raises. `LAUNCHES` counts the kernel
launches (not the plain runs) per kernel.

Outputs keep the reference's layout: a scalar aggregate gives (n,) for
count and (n, value) for the others; a grouped one gives row_count[S]
first, then the same per aggregate as [S] arrays, the last segment being
the dead-row sink.
"""

from __future__ import annotations

import threading

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

# kernel launches per kernel since the last reset (plain runs not counted)
LAUNCHES = {"expr_vm": 0, "scalar_agg": 0, "seg_agg_onehot": 0,
            "seg_agg_sorted": 0}

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
