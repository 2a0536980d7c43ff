"""Micro-batched launches for below-floor statements (the port of
tidb_tpu/ops/sched.py:1-1164: _Lowerer :105-323, _lower_slot_aggs
:368-436, _lower_slot_topn :505-529, MicroBatcher :592-1155).

Many sessions sending small statements (point and short-range scans under
the dispatch floor) each pay a launch and a readback that their few rows
cannot amortize. Statements of the same shape over the same packed batch
that arrive within one gather window share ONE launch instead:

  1. `_prepare` lowers the statement's WHERE into the K1 bytecode with its
     literals hoisted into PARAMETER slots of a per-statement constant
     pool (int64, or the bits of an f64), so `v = 3` and `v = 7` run the
     same program over different pools. The literal-free structural
     signature (operators, columns, compare domains) is the group key.
  2. The first submitter of a cycle leads: it waits one gather window,
     drains the queue, groups the entries by (batch, signature) and
     launches each group in chunks of at most MAX_SLOTS, exactly one slot
     per statement (the reference pads to slot buckets for XLA's compile
     cache; nothing here compiles per shape).
  3. A filter runs K14 `slot_filter` (the slots' survivor masks, bit-packed
     64 rows to an int64 word, one readback into page-locked memory; the
     program and the slots' pools ride in the launch's parameters, nothing
     is copied to the card first); an aggregate K15 `slot_agg` (each
     slot's where-pass count and masked reductions in one launch on K14's
     grid, read back once into page-locked memory); a TopN K14 then
     K16 `slot_topn` (each slot's first k rows and live count). Each
     statement demultiplexes its own slot on its own thread's behalf and
     emits through the client's solo emission (desc/limit applied per
     statement).

A stalled window degrades a follower to the solo route (the card, through
GpuClient.serve), counted in the client's stats. A fault inside a shared
launch is raised in every statement the launch carried: nothing degrades
to another route on a fault. Left for later: the reference's deadline
paths (kv/backoff), its failpoints, and StatesGather (:1195-1301).
"""

from __future__ import annotations

import itertools
import threading
import time
from decimal import Decimal

import numpy as np
import torch

from tidb_tpu_torch import errors, mysqldef as my
from tidb_tpu_torch.copr.proto import (AGG_NAME, ChunkWriter, ExprType,
                                       SelectResponse)
from tidb_tpu_torch.kv import kv
from tidb_tpu_torch.ops import columnar as col
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import (
    _CMP_F, _CMP_I, DEC_ABS_LIMIT, MAX_DEC_SCALE, OP_AND, OP_CONST, OP_I2F,
    OP_ISNULL, OP_MULC_I, OP_NOT, OP_NOTNULL, OP_OR, OP_XOR, CompiledExpr,
    Program, Unsupported, _f64_bits)
from tidb_tpu_torch.sqlast.opcode import Op
from tidb_tpu_torch.types.datum import NULL, Datum, Kind

# statements per launch (the reference's largest slot bucket)
MAX_SLOTS = 32

# top-n limits above this never batch (the reference's bound: a large k
# erodes what sharing a launch saves)
TOPN_SLOT_LIMIT_MAX = 128

_CMP_OPS = {Op.EQ, Op.NE, Op.LT, Op.LE, Op.GT, Op.GE}
_LOGIC_OPS = {Op.AndAnd: OP_AND, Op.OrOr: OP_OR, Op.Xor: OP_XOR}

_FLIP = {Op.LT: Op.GT, Op.LE: Op.GE, Op.GT: Op.LT, Op.GE: Op.LE,
         Op.EQ: Op.EQ, Op.NE: Op.NE}

_batch_ids = itertools.count(1)


def batch_uid(batch) -> int:
    """A number naming one packed batch for the life of the process."""
    uid = getattr(batch, "_uid", None)
    if uid is None:
        uid = batch._uid = next(_batch_ids)
    return uid


class _Unbatchable(Exception):
    """WHERE shape this tier cannot parameterize — the solo route answers."""


class _Lowerer:
    """Lower one statement's WHERE into an emitter of K1 bytecode, with
    literals hoisted into the pi (int64) / pf (f64) parameter lists.
    Mirrors the reference's _Lowerer case for case (same admitted subset,
    same valid planes, same compare domains, same fixed-point scaling,
    same signature), so that its answers are the solo route's.

    `lower` returns (emit, sig): emit(prog) emits the instructions into a
    Program whose pool begins with the parameters — int parameter j at
    pool slot j, f64 parameter j at len(pi) + j — and returns the
    register of the 0/1 result. Parameters are their own pool slots and
    their own CONST instructions: Program.const_slot and Program.emit
    deduplicate by value, which would give `v between 3 and 3` another
    layout than `v between 3 and 8` under one signature."""

    def __init__(self, batch: col.ColumnBatch):
        self.batch = batch
        self.pi: list[int] = []
        self.pf: list[float] = []

    def _param_i(self, v: int):
        v = int(v)
        if not -(1 << 63) <= v < (1 << 63):
            raise _Unbatchable("integer literal exceeds int64")
        j = len(self.pi)
        self.pi.append(v)
        return lambda prog: prog.emit(OP_CONST, 1, imm=j)

    def _param_f(self, v: float):
        j = len(self.pf)
        self.pf.append(float(v))
        return lambda prog: prog.emit(OP_CONST, 1, imm=len(self.pi) + j)

    def lower(self, e):
        tp = e.tp
        if tp == ExprType.OPERATOR:
            op = e.op
            if len(e.children) == 1:
                if op in (Op.UnaryNot, Op.Not):
                    cf, cs = self.lower(e.children[0])
                    return (lambda prog: prog.emit(OP_NOT, cf(prog)),
                            ("not", cs))
                raise _Unbatchable(f"unary {op!r}")
            if op in _LOGIC_OPS:
                af, asig = self.lower(e.children[0])
                bf, bsig = self.lower(e.children[1])
                code = _LOGIC_OPS[op]
                return (lambda prog: prog.emit(code, af(prog), bf(prog)),
                        ("logic", int(op), asig, bsig))
            if op in _CMP_OPS:
                return self._compare(e)
            raise _Unbatchable(f"op {op!r}")
        if tp in (ExprType.IS_NULL, ExprType.IS_NOT_NULL):
            c = e.children[0]
            if c.tp != ExprType.COLUMN_REF \
                    or c.val not in self.batch.columns:
                raise _Unbatchable("IS NULL on non-column")
            cid = c.val
            neg = tp == ExprType.IS_NULL
            code = OP_ISNULL if neg else OP_NOTNULL
            return (lambda prog: prog.emit(code, prog.column(cid)),
                    ("isnull" if neg else "isnotnull", cid))
        raise _Unbatchable(f"expr type {tp!r}")

    def _compare(self, e):
        """COLUMN_REF <cmp> VALUE with the literal hoisted to a parameter;
        domains and scales as the reference's _compare (exprc._align)."""
        left, right = e.children
        for a, b, flip in ((left, right, False), (right, left, True)):
            if a.tp == ExprType.COLUMN_REF and b.tp == ExprType.VALUE:
                col_e, val_e = a, b
                op = _FLIP[e.op] if flip else e.op
                break
        else:
            raise _Unbatchable("compare without a column/literal pair")
        cd = self.batch.columns.get(col_e.val)
        if cd is None:
            raise _Unbatchable(f"column {col_e.val} not packed")
        cid = col_e.val
        d = val_e.val
        if d.is_null():
            # a NULL literal: value 0, valid nowhere; no parameter
            return (lambda prog: prog.emit(OP_CONST, 0,
                                           imm=prog.const_slot(0)),
                    ("nullcmp", cid))

        # --- string dictionary columns: compare in code space ---------
        if cd.kind == col.K_STR:
            if d.kind not in (Kind.STRING, Kind.BYTES):
                raise _Unbatchable("non-string literal vs dict column")
            const = d.get_bytes()
            # EQ/NE against the exact code (-1 when absent: codes are
            # non-negative), ordered compares against the dictionary bounds
            if op in (Op.EQ, Op.NE):
                p = self._param_i(cd.code_of(const))
                gop = "eq" if op == Op.EQ else "ne"
            elif op in (Op.LT, Op.LE):
                p = self._param_i(cd.lower_bound(const) if op == Op.LT
                                  else cd.upper_bound(const))
                gop = "lt"
            else:  # GT / GE
                p = self._param_i(cd.upper_bound(const) if op == Op.GT
                                  else cd.lower_bound(const))
                gop = "ge"
            code = {"eq": _CMP_I[Op.EQ], "ne": _CMP_I[Op.NE],
                    "lt": _CMP_I[Op.LT], "ge": _CMP_I[Op.GE]}[gop]
            return (lambda prog: prog.emit(code, prog.column(cid), p(prog)),
                    ("strcmp", gop, cid))

        # --- temporal columns vs string/TIME literal → packed int ------
        if cd.kind == col.K_I64 and cd.tp in my.TIME_TYPES \
                and d.kind in (Kind.STRING, Kind.BYTES):
            from tidb_tpu_torch.types.time_types import parse_time
            try:
                lv = ("i", parse_time(d.get_string()).to_packed_int())
            except (errors.TiDBError, ValueError):
                raise _Unbatchable("unparseable date constant") from None
        elif d.kind == Kind.TIME:
            lv = ("i", int(d.val.to_packed_int()))
        elif d.kind in (Kind.INT64, Kind.UINT64):
            lv = ("i", int(d.val))
        elif d.kind == Kind.FLOAT64:
            lv = ("f", float(d.val))
        elif d.kind == Kind.DECIMAL:
            exp = -d.val.as_tuple().exponent
            scale = max(0, exp)
            if scale > MAX_DEC_SCALE:
                raise _Unbatchable("decimal literal scale too fine")
            lv = ("d", int(d.val * (10 ** scale)), scale)
            if abs(lv[1]) >= DEC_ABS_LIMIT:
                raise _Unbatchable("decimal literal exceeds int64")
        else:
            raise _Unbatchable(f"literal kind {d.kind!r}")

        # --- numeric compare, exprc._align's domain rules --------------
        if cd.kind == col.K_F64 or lv[0] == "f":
            # float context: the host computes the parameter with the f64
            # operations the device would apply to the literal
            if lv[0] == "f":
                pv = lv[1]
            elif lv[0] == "d":
                pv = float(np.float64(lv[1]) / np.float64(10.0 ** lv[2]))
            else:
                pv = float(np.float64(lv[1]))
            p = self._param_f(pv)
            dec_scale = cd.dec_scale if cd.kind == col.K_DEC else 0
            is_f64 = cd.kind == col.K_F64
            divisor = _f64_bits(10.0 ** dec_scale if dec_scale else 1.0)
            code = _CMP_F[op]

            def fcmp(prog):
                v = prog.column(cid)
                if not is_f64:
                    v = prog.emit(OP_I2F, v, imm=prog.const_slot(divisor))
                return prog.emit(code, v, p(prog))
            return fcmp, ("cmp", int(op), cid, "f64", dec_scale)

        # exact integer domain: fixed-point rescale to the larger scale
        # with the reference's overflow proofs
        col_scale = cd.dec_scale if cd.kind == col.K_DEC else 0
        lit_scale = lv[2] if lv[0] == "d" else 0
        s = max(col_scale, lit_scale)
        col_mul = 10 ** (s - col_scale)
        lit_iv = lv[1] * (10 ** (s - lit_scale))
        if s and abs(lit_iv) >= DEC_ABS_LIMIT:
            raise _Unbatchable("fixed-point literal rescale may exceed int64")
        max_abs = getattr(cd, "max_abs", None)
        if col_mul != 1:
            if max_abs is None or max_abs * col_mul >= DEC_ABS_LIMIT:
                raise _Unbatchable("fixed-point rescale unprovable")
        p = self._param_i(lit_iv)
        code = _CMP_I[op]

        def icmp(prog):
            v = prog.column(cid)
            if col_mul != 1:
                v = prog.emit(OP_MULC_I, v, imm=prog.const_slot(col_mul))
            return prog.emit(code, v, p(prog))
        return icmp, ("cmp", int(op), cid, "i64", col_mul)

    def program(self, batch: col.ColumnBatch, emit):
        """The finalized program (None for no WHERE) whose pool starts with
        this statement's parameters."""
        prog = Program(batch)
        prog.pool = list(self.pi) + [_f64_bits(v) for v in self.pf]
        where = None if emit is None else \
            CompiledExpr(prog, emit(prog), "bool", "b")
        return prog.finalize(where, [])


class _SlotAgg:
    """One scalar aggregate of the aggregate slot kind: `op` names the
    reduction ("count" | "sum" | "min" | "max"), `cid` the argument plane
    (None = count over the mask); `kind`/`scale`/`unsigned`/`dic` rebuild
    the partial datum."""

    __slots__ = ("name", "op", "cid", "kind", "scale", "unsigned", "dic",
                 "sig")

    def __init__(self, name, op, cid, kind, scale, unsigned, dic, sig):
        self.name = name
        self.op = op
        self.cid = cid
        self.kind = kind
        self.scale = scale
        self.unsigned = unsigned
        self.dic = dic
        self.sig = sig

    def red(self, planes: dict) -> kernels.Red:
        """K15's reduction of this aggregate over the batch's planes."""
        if self.cid is None:
            return kernels.Red(kernels.R_COUNT, const_bits=1)
        values, valid = planes[self.cid]
        f = self.kind == col.K_F64
        op = {"count": kernels.R_COUNT, "sum": kernels.R_SUM_I,
              "min": kernels.R_MIN_F if f else kernels.R_MIN_I,
              "max": kernels.R_MAX_F if f else kernels.R_MAX_I}[self.op]
        return kernels.Red(op, values, valid)


def _lower_slot_aggs(sel, batch):
    """The reference's _lower_slot_aggs: a below-floor scalar aggregate as
    per-slot masked reductions, or None (unbatchable). Float SUM/AVG bail
    (a device reduction would re-associate the row path's sequential
    rounding), a -0.0 in a float MIN/MAX plane bails (the row path keeps
    the first-seen zero's sign), integer sums bail where max_abs * n_rows
    could wrap, and time, duration and bit sums or extrema bail."""
    colpb = {c.column_id: c for c in sel.table_info.columns}
    out = []
    for e in sel.aggregates:
        name = AGG_NAME.get(e.tp)
        if name not in ("count", "sum", "avg", "min", "max") \
                or e.distinct or len(e.children) > 1:
            return None
        arg = e.children[0] if e.children else None
        if arg is None or arg.tp == ExprType.VALUE:
            if name != "count":
                return None
            const = arg.val if arg is not None else None
            if const is not None and const.is_null():
                return None     # count(NULL literal): solo route
            out.append(_SlotAgg("count", "count", None, None, 0, False,
                                None, ("count", None)))
            continue
        if arg.tp != ExprType.COLUMN_REF:
            return None
        cd = batch.columns.get(arg.val)
        c = colpb.get(arg.val)
        if cd is None or c is None:
            return None
        if name == "count":
            out.append(_SlotAgg("count", "count", arg.val, None, 0,
                                False, None, ("count", arg.val)))
            continue
        unsigned = my.has_unsigned_flag(c.flag)
        int_plane = cd.kind == col.K_I64 and c.tp in my.INTEGER_TYPES
        if name in ("sum", "avg"):
            if not (int_plane or cd.kind == col.K_DEC):
                return None
            mx = getattr(cd, "max_abs", 0)
            if mx and batch.n_rows and mx * batch.n_rows >= (1 << 63):
                return None
            out.append(_SlotAgg(name, "sum", arg.val, cd.kind,
                                cd.dec_scale, unsigned, None,
                                (name, arg.val, cd.kind, cd.dec_scale)))
            continue
        if cd.kind == col.K_F64:
            vals = cd.values
            z = (vals == 0.0) & np.signbit(vals) & cd.valid
            if bool(np.any(z[:batch.n_rows])):
                return None
        elif cd.kind == col.K_STR:
            pass                # code extrema ARE byte extrema
        elif not (int_plane or cd.kind == col.K_DEC):
            return None
        out.append(_SlotAgg(name, name, arg.val, cd.kind, cd.dec_scale,
                            unsigned, cd.dictionary
                            if cd.kind == col.K_STR else None,
                            (name, arg.val, cd.kind, cd.dec_scale)))
    if len(out) + 1 > kernels.SLOT_MAX_REDS:
        return None
    return out


def _lower_slot_topn(sel, batch):
    """The reference's _lower_slot_topn: ORDER BY ... LIMIT k as the per-
    slot top-n kind, or None. Keys are COLUMN_REF planes whose value order
    is the SQL order (int and time, f64, fixed-scale decimal, dictionary
    codes); at most kernels.TOPN_MAX_KEYS of them."""
    if not sel.order_by or sel.limit is None:
        return None
    k = int(sel.limit)
    if k <= 0 or k > min(TOPN_SLOT_LIMIT_MAX, batch.capacity):
        return None
    if len(sel.order_by) > kernels.TOPN_MAX_KEYS:
        return None
    keys = []
    for item in sel.order_by:
        e = item.expr
        if e.tp != ExprType.COLUMN_REF:
            return None
        cd = batch.columns.get(e.val)
        if cd is None:
            return None
        if cd.kind not in (col.K_I64, col.K_F64, col.K_DEC, col.K_STR):
            return None
        keys.append((e.val, bool(item.desc), cd.kind))
    return tuple(keys), k


class _Entry:
    __slots__ = ("sel", "batch", "fin", "pool", "sig", "cols",
                 "aggs", "topn", "event", "result", "error", "degrade",
                 "taken")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.aggs = None        # _SlotAgg list for the aggregate kind
        self.topn = None        # (keys, k) for the top-n kind
        self.degrade = None     # None | "solo" | "stall"
        self.taken = False

    @property
    def group_key(self):
        return (batch_uid(self.batch), self.sig)


class MicroBatcher:
    """One per GpuClient (every session of a store shares the client, so
    concurrent below-floor statements meet here). Leader/follower gather:
    the first submitter of a cycle owns the window and the launch;
    followers wait on their entry's event with a stall patience, so a
    wedged leader degrades them to the solo route instead of wedging
    their statements."""

    # a signature stays hot this long after its last multi-statement
    # launch: a singleton of a hot shape rides a 1-slot launch
    HOT_SIG_S = 2.0

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: list[_Entry] = []
        self._leader_active = False
        self._hot: dict = {}        # sig → monotonic ts of last multi-batch
        self._last_submit = 0.0     # traffic gate: ts of the last submit
        self._last_thread = None    # ... and which thread submitted it
        self._last_multi = 0.0      # ts of the last multi-statement batch

    # ------------------------------------------------------------------
    # eligibility and lowering (on the submitting statement's thread)
    # ------------------------------------------------------------------

    def _prepare(self, client, req: kv.Request, sel) -> _Entry | None:
        if req.tp != kv.REQ_TYPE_SELECT or sel.table_info is None:
            return None
        if sel.having is not None:
            return None
        is_agg = sel.is_agg()
        if is_agg and (sel.group_by or sel.limit is not None or sel.desc
                       or sel.order_by):
            return None
        is_topn = bool(sel.order_by) and not is_agg
        if is_topn and sel.limit is None:
            return None
        if not is_agg and not is_topn and sel.where is None:
            return None
        batch = client._get_batch(sel, req.key_ranges)
        lw = _Lowerer(batch)
        emit, sig = None, ()
        if sel.where is not None:
            try:
                emit, sig = lw.lower(sel.where)
            except _Unbatchable:
                return None
        aggs = None
        if is_agg:
            aggs = _lower_slot_aggs(sel, batch)
            if aggs is None:
                return None
        topn = None
        if is_topn:
            topn = _lower_slot_topn(sel, batch)
            if topn is None:
                return None
        try:
            fin = lw.program(batch, emit)
        except Unsupported:
            return None         # more instructions or registers than K1's
        if len(fin.plane_keys) > kernels.SLOT_MAX_PLANES:
            return None
        e = _Entry()
        e.sel, e.batch = sel, batch
        e.fin, e.pool = fin, fin.pool
        e.aggs, e.topn = aggs, topn
        # parameter counts ride the signature so equal signatures have
        # aligned pools; the aggregate and top-n shapes ride it too so
        # that the three kinds never share a launch
        agg_sig = tuple(a.sig for a in aggs) if aggs is not None else None
        e.sig = (sig, agg_sig, topn, len(lw.pi), len(lw.pf))
        e.cols = list(sel.table_info.columns)
        return e

    # ------------------------------------------------------------------
    # gather protocol
    # ------------------------------------------------------------------

    def submit(self, client, req: kv.Request, sel):
        """Answer a below-floor request through a shared launch: a
        kv.Response, or None when the caller takes the solo route
        (unbatchable shape, no peers, or a stalled window)."""
        window_s = max(0.0, client.batch_window_ms) / 1000.0
        # traffic gate: with no concurrent traffic in sight (nothing
        # queued, no recent multi-statement launch, and no recent submit
        # from ANOTHER thread) the solo route answers at once — a lone
        # connection pays neither the window nor the lowering
        now = time.monotonic()
        me = threading.get_ident()
        with self._lock:
            prev = self._last_submit
            prev_thread = self._last_thread
            self._last_submit = now
            self._last_thread = me
            gate = (not self._queue
                    and now - self._last_multi > self.HOT_SIG_S
                    and (prev_thread == me
                         or now - prev > max(2 * window_s, 0.02)))
        if gate:
            return None
        entry = self._prepare(client, req, sel)
        if entry is None:
            return None
        with self._lock:
            self._queue.append(entry)
            is_leader = not self._leader_active
            if is_leader:
                self._leader_active = True
        if is_leader:
            self._lead(client, entry, window_s)
        else:
            self._follow(entry, window_s)
        if entry.error is not None:
            raise entry.error
        if entry.result is not None:
            return _BatchedResponse(entry.result)
        if entry.degrade == "stall":
            client.count("stall_degrades")
        return None

    def _gather(self, window_s: float) -> None:
        """The leader's wait for peers."""
        if window_s > 0:
            time.sleep(window_s)

    def _lead(self, client, own: _Entry, window_s: float) -> None:
        self._gather(window_s)
        with self._lock:
            entries = list(self._queue)
            self._queue.clear()
            for e in entries:
                e.taken = True
            self._leader_active = False
        self._execute(client, entries)

    def _follow(self, entry: _Entry, window_s: float) -> None:
        patience = max(0.05, window_s * 5)
        end = time.monotonic() + patience
        while not entry.event.wait(0.05):
            if time.monotonic() >= end:
                with self._lock:
                    if not entry.taken and entry in self._queue:
                        # the leader stalled without draining: reclaim the
                        # entry and take the solo route
                        self._queue.remove(entry)
                        entry.degrade = "stall"
                        return
                # taken: the leader is launching — keep waiting
                end = time.monotonic() + patience

    # ------------------------------------------------------------------
    # launches (leader thread)
    # ------------------------------------------------------------------

    def _execute(self, client, entries: list[_Entry]) -> None:
        groups: dict = {}
        for e in entries:
            groups.setdefault(e.group_key, []).append(e)
        for group in groups.values():
            try:
                if len(group) == 1 and not self._sig_hot(group[0].sig):
                    # no peer shared this shape and its traffic is cold:
                    # nothing to amortize, the solo route answers
                    group[0].degrade = "solo"
                else:
                    # a hot singleton rides a 1-slot launch
                    for i in range(0, len(group), MAX_SLOTS):
                        self._dispatch_chunk(client, group[i:i + MAX_SLOTS])
            except Exception as exc:  # raised again in each statement
                for e in group:
                    if e.result is None:
                        e.error = exc
            finally:
                for e in group:
                    e.event.set()

    def _sig_hot(self, sig) -> bool:
        with self._lock:
            ts = self._hot.get(sig)
        return ts is not None and time.monotonic() - ts < self.HOT_SIG_S

    def _dispatch_chunk(self, client, chunk: list[_Entry]) -> None:
        """One launch for the chunk (K14, K15, or K14 + K16), then each
        statement's own response."""
        proto = chunk[0]
        batch = proto.batch
        k = len(chunk)
        dev = client.device
        # the slots' pools ride by value in the launch (host int64 [k, P])
        pools = torch.from_numpy(np.stack([e.pool for e in chunk]))
        planes = kernels.batch_planes(batch, dev)
        live = kernels.device_live(batch, dev)
        plane_list = [planes[key][which]
                      for key, which in proto.fin.plane_keys]
        if proto.aggs is not None:
            reds = [kernels.Red(kernels.R_COUNT, const_bits=1)] \
                + [a.red(planes) for a in proto.aggs]

            def run(_p, _lv):
                # (count, value) per slot and reduction, read back once
                # into page-locked memory
                out = kernels.to_host(kernels.slot_agg_states(
                    proto.fin, pools, plane_list, live, reds)).numpy()
                return out[:, :, 0], out[:, :, 1]
        elif proto.topn is not None:
            keys, kk = proto.topn
            key_planes = [(planes[cid], desc) for cid, desc, _kd in keys]

            def run(_p, _lv):
                words = kernels.slot_filter(proto.fin, pools, plane_list,
                                            live)
                idx, n_live = kernels.slot_topn(words, key_planes, kk)
                return idx.cpu().numpy(), n_live.cpu().numpy()
        else:
            def run(_p, _lv):
                # the words come back into page-locked memory
                return kernels.to_host(kernels.slot_filter(
                    proto.fin, pools, plane_list, live))
        out = client._dispatch(run, planes, live)
        client.note_launch(k)
        if k > 1:
            with self._lock:
                self._hot[proto.sig] = self._last_multi = time.monotonic()
                if len(self._hot) > 256:
                    self._hot.pop(next(iter(self._hot)))
        if proto.aggs is not None:
            n, acc = out
            for j, e in enumerate(chunk):
                e.result = self._emit_agg(e, n[j], acc[j])
            return
        if proto.topn is not None:
            idx, n_live = out
            for j, e in enumerate(chunk):
                e.result = self._emit(client, e, idx[j, :int(n_live[j])])
            return
        masks = kernels.unpack_slot_words(out).numpy()
        for j, e in enumerate(chunk):
            idx = np.nonzero(masks[j])[0]
            if e.sel.desc:
                idx = idx[::-1]
            if e.sel.limit is not None:
                idx = idx[: e.sel.limit]
            e.result = self._emit(client, e, idx)

    # ------------------------------------------------------------------
    # per-statement emission
    # ------------------------------------------------------------------

    @staticmethod
    def _emit(client, e: _Entry, idx) -> SelectResponse:
        """The solo route's emission, with the entry's own columns."""
        return client._emit_rows(e.sel, e.batch, idx, cols=e.cols)

    @staticmethod
    def _emit_agg(e: _Entry, n: np.ndarray, acc: np.ndarray
                  ) -> SelectResponse:
        """One statement's scalar-aggregate partial row from its slot
        (n[0] the where-pass count, then per aggregate its contributing
        count n[i] and value acc[i], f64 as bits) — and, like the
        reference's tier and the CPU row handler, NO row at all when no
        row passed the filter (the solo route sends the empty partial)."""
        rows: list = []
        if int(n[0]):
            row = [Datum.bytes_(b"")]
            for i, a in enumerate(e.aggs, start=1):
                cnt = int(n[i])
                if a.name == "count":
                    row.append(Datum.i64(cnt))
                    continue
                v = int(acc[i])
                if cnt == 0:
                    val = NULL
                elif a.kind == col.K_F64:
                    val = Datum.f64(float(np.int64(v).view(np.float64)))
                elif a.op == "sum" or a.kind == col.K_DEC:
                    # an int64 mantissa: scaleb is exact (no context
                    # rounding below 28 digits) and keeps the column scale
                    # as the reference's partial does
                    val = Datum.dec(Decimal(v).scaleb(-a.scale)
                                    if a.kind == col.K_DEC else Decimal(v))
                elif a.kind == col.K_STR:
                    val = Datum.bytes_(a.dic[v])
                elif a.unsigned:
                    val = Datum.u64(v)
                else:
                    val = Datum.i64(v)
                if a.name == "avg":
                    row.append(Datum.i64(cnt))
                row.append(val)
            rows = [(0, row)]
        writer = ChunkWriter()
        for h, row in rows:
            writer.append_row(h, row)
        return SelectResponse(chunks=writer.finish())


class _BatchedResponse(kv.Response):
    def __init__(self, resp: SelectResponse):
        self._resp = resp

    def next(self):
        r, self._resp = self._resp, None
        return r
