#!/usr/bin/env python3
"""Drive the port on one NVIDIA GPU and hold its kernels to their plain
versions.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; exits non-zero, printing no result, where
either is missing or where `tidb_tpu_torch` is not beside this file.

1. Print the torch, CUDA and nvcc versions and the card's name and power
   limit; build the kernels of tidb_tpu_torch/ops/csrc (printing the
   build time and ptxas' register/spill lines).
2. Phase A, the whole path at TPC-H SF0.01: 60,175 lineitem rows encoded
   into a MemStore; six requests through GpuClient(store).send on the card
   (Q1, Q6, a filter scan, a scalar aggregate with first_row, a GROUP BY
   l_suppkey with more than 64 segments, an aggregate whose WHERE keeps no
   row), each held against GpuClient(store, device="cpu"); Q1 also against
   numpy. Kernel launch counts are reset just before and read just after.
3. Phase B, Q1 at SF1: 6,001,215 rows (capacity 2^23) built straight into
   a ColumnBatch, Q1 through GpuClient.serve (the path send takes after
   packing), checked against numpy. Then K1..K4 each against its plain
   PyTorch version run on the card, at the shapes of Q1 / Q6 / GROUP BY
   l_suppkey on that batch and on edge-case planes (NULLs, int64
   extremes, empty segments); median times over 20 runs from CUDA events.
4. A JSON line of per-kernel numbers, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Any failure raises: no phase catches its own failure.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tidb_tpu_torch import tpch  # noqa: E402
from tidb_tpu_torch.copr.proto import (  # noqa: E402
    Expr, ExprType, SelectRequest, expr_column, expr_op, expr_value,
    iter_response_rows)
from tidb_tpu_torch.kv.memstore import MemStore  # noqa: E402
from tidb_tpu_torch.ops import _ext, kernels  # noqa: E402
from tidb_tpu_torch.ops import columnar as col  # noqa: E402
from tidb_tpu_torch.ops.client import GpuClient  # noqa: E402
from tidb_tpu_torch.ops.exprc import (  # noqa: E402
    Program, compile_expr, run_program_plain)
from tidb_tpu_torch.sqlast.opcode import Op  # noqa: E402
from tidb_tpu_torch.types.datum import NULL, Datum  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the f32 rate
# outside the tensor cores as a generous ceiling for int64/f64 scalar ops
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNELS = {
    "expr_vm": ("tidb_tpu_torch/ops/csrc/expr_vm.cu",
                "tidb_tpu/ops/exprc.py:79"),
    "scalar_agg": ("tidb_tpu_torch/ops/csrc/scalar_agg.cu",
                   "tidb_tpu/ops/kernels.py:713"),
    "seg_agg_onehot": ("tidb_tpu_torch/ops/csrc/seg_agg_onehot.cu",
                       "tidb_tpu/ops/kernels.py:903"),
    "seg_agg_sorted": ("tidb_tpu_torch/ops/csrc/seg_agg_sorted.cu",
                       "tidb_tpu/ops/kernels.py:903"),
}
# f64 sums: another summation order; the bound is relative to the sum of
# the magnitudes of the summed values
F64_SUM_RTOL = 1e-12


class SmokeFailure(AssertionError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# environment and build
# ---------------------------------------------------------------------------

def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout
    return out.strip().splitlines()[0]


def print_versions() -> None:
    nvcc = subprocess.run([_ext.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    print(f"gpu: {smi_line()}")


def build() -> None:
    t0 = time.perf_counter()
    _ext.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(_ext.SOURCES)})")
    for name, log in _ext.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# comparing answers
# ---------------------------------------------------------------------------

def rows_of(resp) -> list:
    return [(h, [(int(d.kind), d.val) for d in ds])
            for h, ds in iter_response_rows(resp)]


def same_rows(got: list, want: list, what: str) -> None:
    need(len(got) == len(want), f"{what}: {len(got)} rows, want {len(want)}")
    for (hg, rg), (hw, rw) in zip(got, want):
        need(hg == hw and len(rg) == len(rw), f"{what}: row shape differs")
        for (kg, vg), (kw, vw) in zip(rg, rw):
            need(kg == kw, f"{what}: datum kind {kg} vs {kw}")
            if isinstance(vg, float):
                need(abs(vg - vw) <= F64_SUM_RTOL * max(abs(vw), 1e-300),
                     f"{what}: {vg!r} vs {vw!r}")
            else:
                need(vg == vw, f"{what}: {vg!r} vs {vw!r}")


def check_q1(resp, data: dict, what: str) -> None:
    """Q1's partial rows against numpy's exact cents."""
    want = tpch.q1_expected(data)
    got = {}
    for _h, ds in iter_response_rows(resp):
        key = (ds[-2].val, ds[-1].val)
        scaled = [int(ds[i].val.scaleb(s)) for i, s in
                  ((1, 2), (2, 2), (3, 4), (4, 6), (10, 2))]
        got[key] = (ds[-3].val, scaled[0], scaled[1], scaled[2], scaled[3],
                    scaled[4])
    need(got == want, f"{what}: Q1 differs from numpy:\n{got}\n{want}")


# ---------------------------------------------------------------------------
# Phase A
# ---------------------------------------------------------------------------

PHASE_A = [("q1", tpch.q1), ("q6", tpch.q6), ("filter", tpch.filter_scan),
           ("scalar_first_row", tpch.scalar_first_row),
           ("group_by_suppkey", tpch.by_supplier),
           ("all_filtered", tpch.all_filtered)]


def phase_a(n_rows: int, seed: int, device=None) -> dict:
    t0 = time.perf_counter()
    data = tpch.generate(n_rows, seed)
    store = MemStore.from_pairs(tpch.kv_pairs(data))
    print(f"phase A: {n_rows} lineitem rows encoded into the store in "
          f"{time.perf_counter() - t0:.1f} s")
    gpu = GpuClient(store, device)
    plain = GpuClient(store, "cpu")
    answers = {}
    for name, make in PHASE_A:
        answers[name] = rows_of(plain.send(tpch.store_request(make()))
                                .next())
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    t1 = time.perf_counter()
    got = {name: gpu.send(tpch.store_request(make())).next()
           for name, make in PHASE_A}
    if gpu.device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    need(launches == gpu.stats["launches"],
         f"GpuClient.stats {gpu.stats['launches']} != launches {launches}")
    for name, resp in got.items():
        same_rows(rows_of(resp), answers[name], f"phase A {name}")
        print(f"  {name}: {resp.row_count()} rows, equal to the plain "
              f"versions")
    check_q1(got["q1"], data, "phase A")
    print(f"phase A: six requests in {t2 - t1:.2f} s (packing included); "
          f"launches {launches}")
    if gpu.device.type == "cuda":
        for k, v in launches.items():
            need(v > 0, f"kernel {k} never launched on the main path")
    return launches


# ---------------------------------------------------------------------------
# Phase B: kernels at SF1 and on edge cases
# ---------------------------------------------------------------------------

def cuda_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def timer(device):
    if device.type == "cuda":
        return cuda_ms

    def host_ms(fn, runs: int = 3, warmup: int = 1):
        for _ in range(warmup):
            fn()
        t = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))
    return host_ms


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if t is None or t.data_ptr() in seen:
            continue
        seen.add(t.data_ptr())
        total += t.numel() * t.element_size()
    return total


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Request:
    """A request's program, planes and reductions on one batch — the
    pieces GpuClient builds, held apart so each kernel can be timed."""

    def __init__(self, sel: SelectRequest, batch, device):
        self.batch = batch
        self.device = device
        prog = Program(batch)
        where = compile_expr(sel.where, batch, prog) \
            if sel.where is not None else None
        self.specs = kernels.lower_aggregates(sel, batch, prog)
        planes = kernels.batch_planes(batch, device)
        self.live = kernels.device_live(batch, device)
        self.outputs = kernels.program_outputs(self.specs)
        if sel.group_by:
            gspec = kernels.lower_group_by(sel, batch)
            planes = dict(planes)
            for key in gspec.plane_keys:
                if key <= kernels.GC_BASE:
                    cid = kernels.GC_BASE - key
                    codes, _u = batch.group_codes(cid)
                    planes[key] = (torch.from_numpy(codes).to(device),
                                   planes[cid][1])
            self.fn = kernels.build_grouped_agg_fn(
                prog, where, self.specs, gspec.plane_keys, gspec.sizes)
            self.segments = self.fn.num_segments
        else:
            self.fn = kernels.build_scalar_agg_fn(prog, where, self.specs)
            self.segments = 0
        self.planes = planes
        self.fin = self.fn.program
        self.plane_list = [planes[k][w] for k, w in self.fin.plane_keys]

    def k1(self):
        return kernels.run_k1(self.fin, self.planes, self.live, self.outputs,
                              self.segments > 0)

    def reds(self, outs) -> list:
        reds = [kernels.spec_reduction(s, self.planes, outs)
                for s in self.specs]
        return ([kernels.Red(kernels.R_COUNT)] + reds) if self.segments \
            else reds


def max_err(a: torch.Tensor, b: torch.Tensor, valid=None) -> float:
    """Largest |a - b| (0 for equal planes); where `valid` is given, only
    there. Raises on a mismatch beyond exactness for integers."""
    if valid is not None:
        a, b = a[valid], b[valid]
    if a.dtype == torch.float64:
        d = (a - b).abs()
        return float(d.max()) if d.numel() else 0.0
    ne = a != b
    if bool(ne.any()):
        raise SmokeFailure(f"integer planes differ at {int(ne.sum())} rows")
    return 0.0


def check_k1(req: Request, what: str) -> float:
    kmask, kgid, kvals = kernels.expr_vm(req.fin, req.plane_list, req.live,
                                         req.segments > 0)
    pmask, pgid, pvals = run_program_plain(req.fin, req.plane_list, req.live)
    err = max_err(kmask, pmask)
    if kgid is not None:
        err = max(err, max_err(kgid, pgid))
    for (kv_, kok), (pv, pok) in zip(kvals, pvals):
        err = max(err, max_err(kok, pok))
        e = max_err(kv_, pv, pok)
        need(e == 0.0, f"{what}: K1 value differs by {e}")
    need(err == 0.0, f"{what}: K1 differs from its plain version")
    return err


def check_reduce(kern, plain, args, reds, what: str) -> float:
    kn, kacc = kern(*args, reds)
    pn, pacc = plain(*args, reds)
    err = max_err(kn, pn)
    for r, red in enumerate(reds):
        if red.op in kernels.F_OPS:
            a = kacc[r].view(torch.float64)
            b = pacc[r].view(torch.float64)
            if red.op == kernels.R_SUM_F:
                # summation order differs: bound the error by the sum of
                # the magnitudes, not by a sum that may cancel to ~0
                mags = kernels.Red(red.op, red.values.abs(), red.valid)
                _n, msum = plain(*args, [mags])
                d = (a - b).abs()
                tol = F64_SUM_RTOL * msum[0].view(torch.float64)
                need(bool((d <= tol).all()),
                     f"{what}: f64 sum {r} off by {float(d.max())}")
                err = max(err, float(d.max()) if d.numel() else 0.0)
            else:
                need(bool((a == b).all()), f"{what}: f64 extremum {r}")
        else:
            err = max(err, max_err(kacc[r], pacc[r]))
    return err


def edge_batch(cap: int, seed: int) -> col.ColumnBatch:
    """Planes with NULLs, int64 extremes, zero divisors, -0.0 and a
    dictionary column."""
    rng = np.random.default_rng(seed)
    n = cap - 37
    live = np.zeros(cap, dtype=bool)
    live[:n] = True
    ext = np.array([col.I64_MIN, col.I64_MAX, -1, 0, 1], dtype=np.int64)
    a = rng.integers(-1000, 1000, cap)
    hit = rng.random(cap) < 0.05
    a[hit] = rng.choice(ext, int(hit.sum()))
    b = rng.integers(-5, 6, cap)
    b[::97] = -1
    c = rng.standard_normal(cap) * 100
    c[::13] = 0.0
    c[::29] = -0.0
    s = rng.integers(0, 6, cap)
    dic = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"SHIP", b"TRUCK"]
    planes = {
        1: col.ColumnData(col.K_I64, a.astype(np.int64),
                          live & (rng.random(cap) > 0.1), tp=8,
                          max_abs=int(np.abs(a[:n].astype(object)).max())),
        2: col.ColumnData(col.K_I64, b.astype(np.int64),
                          live & (rng.random(cap) > 0.1), tp=8, max_abs=5),
        3: col.ColumnData(col.K_F64, c, live & (rng.random(cap) > 0.1),
                          tp=5),
        4: col.ColumnData(col.K_STR, s.astype(np.int64),
                          live & (rng.random(cap) > 0.1), dic, tp=254),
        5: col.ColumnData(col.K_DEC, rng.integers(-99999, 99999, cap)
                          .astype(np.int64), live.copy(), tp=246,
                          dec_scale=2, max_abs=99999),
    }
    planes[4].values[~planes[4].valid] = -1
    return col.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), planes)


def edge_programs():
    """Expressions covering every K1 opcode."""
    c, v, op = expr_column, expr_value, expr_op
    i64 = Datum.i64
    like = Expr(ExprType.LIKE, val="\\",
                children=[c(4), v(Datum.string("%A%"))])
    in_s = Expr(ExprType.NOT_IN, children=[c(4), v(Datum.bytes_(b"AIR")),
                                           v(Datum.bytes_(b"SHIP"))])
    in_i = Expr(ExprType.IN, children=[c(2), v(i64(1)), v(i64(-3)),
                                       v(NULL)])
    in_f = Expr(ExprType.IN, children=[c(3), v(Datum.f64(0.0)),
                                       v(i64(5))])
    return [
        [op(Op.Plus, c(1), c(2)), op(Op.Minus, c(1), c(2)),
         op(Op.Mul, c(1), c(2)), op(Op.IntDiv, c(1), c(2)),
         op(Op.Mod, c(1), c(2)), op(Op.UnaryMinus, c(1))],
        [op(Op.Div, c(3), c(2)), op(Op.IntDiv, c(3), c(2)),
         op(Op.Mod, c(3), c(2)), op(Op.Mul, c(3), c(5)),
         op(Op.Minus, c(3), v(Datum.f64(1.5))), op(Op.UnaryMinus, c(3))],
        [op(Op.AndAnd, op(Op.GT, c(1), c(2)), op(Op.LE, c(3), v(i64(0)))),
         op(Op.OrOr, op(Op.NE, c(1), v(i64(0))),
            op(Op.EQ, c(4), v(Datum.string("RAIL")))),
         op(Op.Xor, c(2), op(Op.LT, c(4), v(Datum.string("MAIL")))),
         op(Op.UnaryNot, c(3)), like, in_s, in_i, in_f],
        [Expr(ExprType.IS_NULL, children=[c(1)]),
         Expr(ExprType.IS_NOT_NULL, children=[c(3)]),
         Expr(ExprType.IF, children=[op(Op.GE, c(2), v(i64(0))), c(1),
                                     c(2)]),
         Expr(ExprType.IFNULL, children=[c(3), c(2)]),
         op(Op.Plus, c(5), v(Datum.dec(__import__("decimal").Decimal(
             "0.125")))),
         op(Op.GE, c(5), c(2))],
    ]


def edge_reductions(batch, device, rng):
    """Reductions over the edge planes: every op, NULLs, constants."""
    p = kernels.batch_planes(batch, device)
    i_v, i_ok = p[1]
    f_v, f_ok = p[3]
    R = kernels.Red
    return [R(kernels.R_COUNT, i_v, i_ok), R(kernels.R_SUM_I, i_v, i_ok),
            R(kernels.R_SUM_F, f_v, f_ok), R(kernels.R_MIN_I, i_v, i_ok),
            R(kernels.R_MAX_I, i_v, i_ok), R(kernels.R_MIN_F, f_v, f_ok),
            R(kernels.R_MAX_F, f_v, f_ok), R(kernels.R_FIRST),
            R(kernels.R_SUM_I, const_bits=7),
            R(kernels.R_MAX_I, const_bits=3, never=True)]


def phase_b(n_rows: int, seed: int, device, edge_cap: int) -> dict:
    ms = timer(device)
    t0 = time.perf_counter()
    data = tpch.generate(n_rows, seed)
    cids = [tpch.C_SUPPKEY, tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
            tpch.C_DISCOUNT, tpch.C_TAX, tpch.C_RETURNFLAG,
            tpch.C_LINESTATUS, tpch.C_SHIPDATE]
    batch = tpch.batch(data, cids)
    kernels.batch_planes(batch, device)
    kernels.device_live(batch, device)
    print(f"phase B: {n_rows} rows, capacity {batch.capacity}, planes on "
          f"{device} in {time.perf_counter() - t0:.1f} s")

    client = GpuClient(MemStore([], []), device)
    sel = tpch.q1()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    resp = client.serve(sel, batch)
    q1_launches = dict(kernels.LAUNCHES)
    check_q1(resp, data, "phase B")
    q1_ms = ms(lambda: client.serve(sel, batch), runs=10)
    print(f"phase B: Q1 at SF1 equal to numpy; launches {q1_launches}; "
          f"GpuClient.serve {q1_ms:.3f} ms median (host clock incl. "
          f"readback and emit)" if device.type != "cuda" else
          f"phase B: Q1 at SF1 equal to numpy; launches {q1_launches}; "
          f"GpuClient.serve {q1_ms:.3f} ms median (CUDA events, incl. "
          f"readback and emit)")

    q1 = Request(sel, batch, device)
    q6 = Request(tpch.q6(), batch, device)
    sup = Request(tpch.by_supplier(), batch, device)
    n = batch.capacity
    out = {}

    # K1
    err = max(check_k1(q1, "Q1"), check_k1(q6, "Q6"), check_k1(sup, "supp"))
    eb = edge_batch(edge_cap, seed + 7)
    elive = kernels.device_live(eb, device)
    eplanes = kernels.batch_planes(eb, device)
    for exprs in edge_programs():
        prog = Program(eb)
        outs = [compile_expr(e, eb, prog) for e in exprs]
        fin = prog.finalize(outs[0], outs)
        plane_list = [eplanes[k][w] for k, w in fin.plane_keys]
        km, _g, kv_ = kernels.expr_vm(fin, plane_list, elive, False)
        pm, _g, pv = run_program_plain(fin, plane_list, elive)
        err = max(err, max_err(km, pm))
        for (a, aok), (b, bok) in zip(kv_, pv):
            err = max(err, max_err(aok, bok), max_err(a, b, bok))
    need(err == 0.0, "K1 differs from its plain version")
    k1_bytes = _nbytes(q1.plane_list) + n * (1 + 1 + 8) \
        + n * 9 * len(q1.fin.out_dts)
    fin = q1.fin
    out["expr_vm"] = dict(
        ms=ms(lambda: kernels.expr_vm(fin, q1.plane_list, q1.live, True)),
        plain_ms=ms(lambda: run_program_plain(fin, q1.plane_list, q1.live)),
        library_ms=None, max_abs_err=err,
        bound=bound(k1_bytes, n * fin.n_instr))

    # K2 at Q6's shape, plus edge reductions
    mask6, _g, outs6 = q6.k1()
    reds6 = q6.reds(outs6)
    err = check_reduce(kernels.scalar_agg, kernels.scalar_agg_plain,
                       (mask6,), reds6, "K2 Q6")
    rng = np.random.default_rng(seed)
    emask = elive & torch.from_numpy(rng.random(edge_cap) > 0.3).to(device)
    ereds = edge_reductions(eb, device, rng)
    err = max(err, check_reduce(kernels.scalar_agg, kernels.scalar_agg_plain,
                                (emask,), ereds, "K2 edge"))
    empty = torch.zeros_like(emask)
    err = max(err, check_reduce(kernels.scalar_agg, kernels.scalar_agg_plain,
                                (empty,), ereds, "K2 empty"))
    x6 = torch.where(mask6 & reds6[0].valid, reds6[0].values,
                     torch.zeros_like(reds6[0].values))
    out["scalar_agg"] = dict(
        ms=ms(lambda: kernels.scalar_agg(mask6, reds6)),
        plain_ms=ms(lambda: kernels.scalar_agg_plain(mask6, reds6)),
        library_ms=ms(lambda: torch.sum(x6)), max_abs_err=err,
        bound=bound(_nbytes([mask6] + [t for r in reds6
                                       for t in (r.values, r.valid)]),
                    n * len(reds6)))

    # K3 at Q1's shape (13 segments), plus 64 segments with empty ones
    mask1, gid1, outs1 = q1.k1()
    reds1 = q1.reds(outs1)
    S1 = q1.segments
    err = check_reduce(lambda *a: kernels.seg_agg_onehot(*a),
                       kernels.seg_agg_plain, (gid1, mask1, S1), reds1,
                       "K3 Q1")
    egid = torch.from_numpy(rng.integers(0, 40, edge_cap) * (64 // 40))\
        .to(device)
    err = max(err, check_reduce(kernels.seg_agg_onehot,
                                kernels.seg_agg_plain, (egid, emask, 64),
                                ereds, "K3 edge"))
    stacked1 = torch.stack([torch.where(mask1, r.values, torch.zeros_like(
        r.values)).view(torch.int64) for r in reds1
        if r.values is not None], 1)
    out["seg_agg_onehot"] = dict(
        ms=ms(lambda: kernels.seg_agg_onehot(gid1, mask1, S1, reds1)),
        plain_ms=ms(lambda: kernels.seg_agg_plain(gid1, mask1, S1, reds1)),
        library_ms=ms(lambda: torch.zeros(S1, stacked1.shape[1],
                                          dtype=torch.int64, device=device)
                      .index_add_(0, gid1, stacked1)),
        max_abs_err=err,
        bound=bound(_nbytes([gid1, mask1] + [t for r in reds1
                                             for t in (r.values, r.valid)]),
                    n * len(reds1)))

    # K4 at GROUP BY l_suppkey's shape, plus 2^20 segments mostly empty
    maskS, gidS, outsS = sup.k1()
    redsS = sup.reds(outsS)
    SS = sup.segments
    err = check_reduce(kernels.seg_agg_sorted, kernels.seg_agg_plain,
                       (gidS, maskS, SS), redsS, "K4 supp")
    big = 1 << 20
    egid4 = torch.from_numpy(rng.integers(0, big // 3, edge_cap) * 3)\
        .to(device)
    err = max(err, check_reduce(kernels.seg_agg_sorted,
                                kernels.seg_agg_plain, (egid4, emask, big),
                                ereds, "K4 edge"))
    stackedS = torch.stack([torch.where(maskS, r.values, torch.zeros_like(
        r.values)).view(torch.int64) for r in redsS
        if r.values is not None], 1)
    out["seg_agg_sorted"] = dict(
        ms=ms(lambda: kernels.seg_agg_sorted(gidS, maskS, SS, redsS)),
        plain_ms=ms(lambda: kernels.seg_agg_plain(gidS, maskS, SS, redsS)),
        library_ms=ms(lambda: torch.zeros(SS, stackedS.shape[1],
                                          dtype=torch.int64, device=device)
                      .index_add_(0, gidS, stackedS)),
        max_abs_err=err,
        bound=bound(_nbytes([gidS, maskS] + [t for r in redsS
                                             for t in (r.values, r.valid)]),
                    n * len(redsS)))
    sort_ms = ms(lambda: torch.sort(gidS, stable=True))
    q1_dev = ms(lambda: q1.fn(q1.planes, q1.live))
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    print(f"phase B: Q1 device time (K1 + K3 + readback) {q1_dev:.4f} ms; "
          f"segments Q1 {S1}, l_suppkey {SS}; of seg_agg_sorted's time the "
          f"stable torch.sort of the group ids takes {sort_ms:.4f} ms")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print_versions()
    build()
    launches = phase_a(tpch.SF001_ROWS, seed=1, device=None)
    results = phase_b(tpch.SF1_ROWS, seed=2, device=device,
                      edge_cap=1 << 20)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
