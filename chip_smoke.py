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
4. Phase C, the cluster path at SF0.01 through KV: the same rows in a
   DistStore split at handle boundaries into 1, 2 and 8 regions; the six
   shapes of the JAX package's TPC-H sweep (tpch.SWEEP) through
   distsql.select(...).columnar() and fused_agg.final_states on the card,
   each held exactly against the same store with device="cpu" (sharing
   its plane cache) and against numpy. Launch counts are reset before
   and read after each statement: K5 and K6 once each, K7 once over more
   than one region.
5. Phase D, the cluster path at SF1 over 8 regions: region batches built
   straight from the seed, admitted pinned into the plane cache under
   the key the region handler computes; the six shapes through the store
   (a cache hit in every region), each against numpy; the statement time
   (median of 10) and its split by phase; K5, K6 and K7 against their
   plain versions on the card at Q1's shapes and on edge cases (NULL
   predicates, live rows not a multiple of 32, regions with no survivor
   and G_r = 0, R = 64, spans above K6's shared-memory limit).
6. A JSON line of per-kernel numbers, the nvidia-smi line, and last
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

from decimal import Decimal  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tidb_tpu_torch import distsql, tpch  # noqa: E402
from tidb_tpu_torch.cluster.rpc import clip_ranges  # noqa: E402
from tidb_tpu_torch.cluster.store import DistStore  # noqa: E402
from tidb_tpu_torch.copr import columnar_region  # noqa: E402
from tidb_tpu_torch.copr.plane_cache import PlaneCache  # noqa: E402
from tidb_tpu_torch.executor import fused_agg  # noqa: E402
from tidb_tpu_torch.copr.proto import (  # noqa: E402
    AGG_NAME, Expr, ExprType, SelectRequest, expr_column, expr_op, expr_value,
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
    "expr_vm_ragged": ("tidb_tpu_torch/ops/csrc/expr_vm.cu",
                       "tidb_tpu/ops/kernels.py:1552"),
    "seg_states_ragged": ("tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
                          "tidb_tpu/ops/kernels.py:1356"),
    "seg_states_ragged_sorted": (
        "tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
        "tidb_tpu/ops/kernels.py:1356"),
    "combine_partials": ("tidb_tpu_torch/ops/csrc/combine_partials.cu",
                         "tidb_tpu/ops/kernels.py:1082"),
}
# K6 has two routes, each counted: spans within its shared-memory limit
# (seg_states_ragged) and larger ones (seg_states_ragged_sorted)
CLUSTER_KERNELS = ("expr_vm_ragged", "seg_states_ragged",
                   "seg_states_ragged_sorted", "combine_partials")
K6_ROUTES = ("seg_states_ragged", "seg_states_ragged_sorted")
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
            need(v > 0 or k in CLUSTER_KERNELS,
                 f"kernel {k} never launched on the main path")
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
    # build_filter_fn (table row 4): K1's mask of Q6's WHERE, then
    # torch.nonzero; bound: the planes and live plane read, the mask
    # written and read back, 8 B per survivor index
    fprog = Program(batch)
    ffn = kernels.build_filter_fn(fprog, compile_expr(tpch.q6().where,
                                                      batch, fprog))
    fmask = ffn(q6.planes, q6.live)[0]
    survivors = int(fmask.sum())
    fplanes = [q6.planes[k][w] for k, w in ffn.program.plane_keys]
    filter_ms = ms(lambda: torch.nonzero(ffn(q6.planes, q6.live)[0]))
    filter_bound = bound(_nbytes(fplanes) + 3 * n + 8 * survivors,
                         n * ffn.program.n_instr)
    print(f"phase B: build_filter_fn (K1 mask + torch.nonzero) at Q6's "
          f"WHERE: {filter_ms:.4f} ms, {survivors} survivors, bound "
          f"{filter_bound[0]:.4f} ms by {filter_bound[1]}")
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


# ---------------------------------------------------------------------------
# Phases C and D: the cluster region path
# ---------------------------------------------------------------------------

# f64 sums against numpy: another summation order over up to 6M rows
F64_SWEEP_RTOL = 1e-9


def final_rows(store: DistStore, sel: SelectRequest) -> list:
    res = distsql.select(store.get_client(),
                         tpch.store_request(sel)).columnar()
    return fused_agg.final_states(sel, res)


def cell(d):
    v = d.val
    if isinstance(v, Decimal):
        return int(d.kind), "dec", str(v)
    if hasattr(v, "to_packed_int"):
        return int(d.kind), "time", v.to_packed_int(), v.tp
    return int(d.kind), v           # f64 ==: -0.0 equals +0.0


def same_final(got: list, want: list, what: str) -> None:
    need([[cell(d) for d in r] for r in got]
         == [[cell(d) for d in r] for r in want],
         f"{what}: final rows differ from the plain versions'")


def check_sweep(name: str, rows: list, data: dict, what: str) -> None:
    """A sweep shape's final rows against numpy (tpch.sweep_expected)."""
    want = tpch.sweep_expected(name, data)
    got = {}
    for row in rows:
        if name == "q1full":
            key, vals = (row[-2].val, row[-1].val), row[:8]
        elif name == "q6":
            key, vals = (), row
        elif name == "date_group":
            key, vals = row[-1].val.dt.date(), row[:2]
        else:
            key, vals = row[-1].val, row[:2]
        got[key] = [None if d.is_null() else d.val for d in vals]
    need(set(got) == set(want), f"{what} {name}: groups differ from numpy")
    for k, w in want.items():
        for a, b in zip(got[k], w):
            if isinstance(b, float):
                need(abs(a - b) <= F64_SWEEP_RTOL * max(abs(b), 1.0),
                     f"{what} {name} {k}: {a!r} vs numpy {b!r}")
            else:
                need(a == b, f"{what} {name} {k}: {a!r} vs numpy {b!r}")


def zero_launches() -> None:
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def phase_c(n_rows: int, seed: int, device, regions=(1, 2, 8)) -> dict:
    t0 = time.perf_counter()
    data = tpch.generate(n_rows, seed)
    pairs = list(tpch.kv_pairs(data))
    print(f"phase C: {n_rows} lineitem rows encoded in "
          f"{time.perf_counter() - t0:.1f} s")
    totals = {k: 0 for k in CLUSTER_KERNELS}
    for R in regions:
        t1 = time.perf_counter()
        cache = PlaneCache(device=device)
        splits = tpch.split_keys(n_rows, R)
        gpu = DistStore(pairs, splits, device, plane_cache=cache)
        plain = DistStore(pairs, splits, device="cpu", plane_cache=cache)
        for name, _make in tpch.SWEEP:
            sel = tpch.sweep_request(name)
            want = final_rows(plain, sel)
            zero_launches()
            calls = dict(kernels.CALLS)
            got = final_rows(gpu, sel)
            launches = {k: kernels.LAUNCHES[k] for k in CLUSTER_KERNELS}
            k7 = int(R > 1 and fused_agg.stats["last_groups"] > 0)
            once = {"region_filter_batched": 1,
                    "region_agg_states_batched": 1,
                    "combine_region_partials": k7}
            need({k: kernels.CALLS[k] - calls[k] for k in calls} == once,
                 f"phase C {R} regions {name}: calls {kernels.CALLS}")
            if gpu.device.type == "cuda":
                torch.cuda.synchronize()
                need(launches["expr_vm_ragged"] == 1
                     and sum(launches[k] for k in K6_ROUTES) == 1
                     and launches["combine_partials"] == k7,
                     f"phase C {R} regions {name}: launches {launches}")
                need(sum(kernels.LAUNCHES.values()) == 1 + 1 + k7,
                     f"phase C {name}: a slice-1 kernel ran on the cluster "
                     f"path")
            same_final(got, want, f"phase C {R} regions {name}")
            check_sweep(name, got, data, f"phase C {R} regions")
            for k in totals:
                totals[k] += launches[k]
        print(f"  {R} regions: six sweep shapes equal to the plain versions "
              f"and numpy ({time.perf_counter() - t1:.1f} s, packing "
              f"included)")
    print(f"phase C: launches {totals}")
    if device.type == "cuda":
        for k, v in totals.items():
            need(v > 0, f"kernel {k} never launched on the cluster path")
    return totals


D_CIDS = [tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE, tpch.C_DISCOUNT,
          tpch.C_TAX, tpch.C_RETURNFLAG, tpch.C_LINESTATUS,
          tpch.C_SHIPDATE, tpch.C_FDISCOUNT]


def admit(store: DistStore, sel: SelectRequest, batches: list) -> None:
    """Admit one batch per region, pinned, under the plane-cache key the
    region handler computes for `sel`."""
    req = tpch.store_request(sel)
    regions = store.cluster.regions
    need(len(regions) == len(batches), "one batch per region")
    version = store.data_version_at(sel.start_ts)
    for region, b in zip(regions, batches):
        key = columnar_region.cache_key(
            region.region_id, sel, clip_ranges(region, req.key_ranges))
        store.plane_cache.insert(key, region.epoch(), version, b)


def host_ms(fn, runs: int) -> float:
    t = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(t))


def capture(store: DistStore, sel: SelectRequest, device) -> tuple:
    """Run one statement step by step, keeping the inputs of its K5, K6
    and K7 launches: (region programs, seg_states_ragged arguments,
    (combine states, K7 op codes))."""
    parts = [p.columnar for p in
             store.get_client().send(tpch.store_request(sel)).drain_all()]
    regions = [p._pending.region_program() for p in parts]
    columnar_region._finish_filter_batch(parts, device)
    pends = [p._pending for p in parts]
    segs = [(pe.gid, pe.reductions, pe.G, pe.batch.n_rows) for pe in pends]
    k6 = kernels.states_inputs(segs, device)
    outs = kernels.region_agg_states_batched(segs, device)
    for p, pe, o in zip(parts, pends, outs):
        p.fulfill_states(pe.finish(o))
    names = [AGG_NAME[e.tp] for e in sel.aggregates]
    keys, maps = {}, []
    for p in parts:
        maps.append(np.asarray([keys.setdefault(k, len(keys))
                                for k in p.group_keys], np.int64))
    combine = fused_agg._StatesCombine(len(parts), len(keys), device)
    fused_agg._stack_states(parts, names, maps, len(parts), len(keys),
                            combine)
    codes = [kernels._COMBINE_CODE[(op, s.dtype == np.float64)]
             for s, op in zip(combine._states, combine._ops)]
    return regions, k6, (combine._states, codes)


def _edge_regions(R: int, seed: int, device, caps=(1024, 2048)) -> list:
    """R regions of random planes, each with its own string dictionary,
    NULLs in the predicate's column, live rows not a multiple of 32 (and
    none in some), compiled with WHERE (a < 0 OR s = 'MAIL') and the
    argument a * 3."""
    rng = np.random.default_rng(seed)
    dic_all = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"SHIP"]
    out = []
    c, v, op = expr_column, expr_value, expr_op
    where = op(Op.OrOr, op(Op.LT, c(1), v(Datum.i64(0))),
               op(Op.EQ, c(2), v(Datum.string("MAIL"))))
    arg = op(Op.Mul, c(1), v(Datum.i64(3)))
    for r in range(R):
        cap = caps[r % len(caps)]
        n = 0 if r % 7 == 3 else int(rng.integers(1, cap + 1)) | 1
        live = np.arange(cap) < n
        dic = sorted(set(rng.choice(dic_all, 3).tolist()))
        a = rng.integers(-1000, 1000, cap).astype(np.int64)
        sv = live & (rng.random(cap) > 0.1)
        f = rng.standard_normal(cap) * 10
        cols = {
            1: col.ColumnData(col.K_I64, a, live & (rng.random(cap) > 0.2),
                              tp=8, max_abs=1000),
            2: col.ColumnData(col.K_STR, np.where(sv, rng.integers(
                0, len(dic), cap), -1).astype(np.int64), sv, dic, tp=15),
            3: col.ColumnData(col.K_F64, f, live & (rng.random(cap) > 0.1),
                              tp=5),
        }
        b = col.ColumnBatch(n, cap, np.arange(cap, dtype=np.int64), cols)
        prog = Program(b)
        w = compile_expr(where, b, prog)
        ap = compile_expr(arg, b, prog)
        fin = prog.finalize(w, [ap])
        planes = kernels.batch_planes(b, device)
        out.append((b, kernels.RegionProgram(
            fin, [planes[k][x] for k, x in fin.plane_keys], cap, n)))
    return out


def _edge_states(edge: list, bits, outs, device, big: bool, seed: int):
    """seg_states_ragged arguments over the edge regions' K5 masks: every
    op, the argument plane's valid, G_r = 0 where nothing survived, and
    with `big` spans above K6's shared-memory limit."""
    rng = np.random.default_rng(seed)
    masks = kernels.unpack_masks(bits, [rp.cap for _b, rp in edge])
    segs, base = [], 0
    for (b, rp), m in zip(edge, masks):
        hi = 3000 if big else 6
        G = int(rng.integers(1, hi)) if m.any() else 0
        gid = np.full(rp.cap, G, np.int64)
        if G:
            gid[m] = rng.integers(0, G, int(m.sum()))
        planes = kernels.batch_planes(b, device)
        a_ok = m & b.columns[1].valid
        f_ok = m & b.columns[3].valid & ~np.signbit(b.columns[3].values)
        arg = columnar_region.ArgPlaneSpec(
            None, outs[0][0][base:base + rp.cap],
            outs[0][1][base:base + rp.cap])
        segs.append((gid, [("sum", None, m), ("sum", planes[1][0], a_ok),
                           ("min", planes[1][0], a_ok),
                           ("max", planes[1][0], a_ok),
                           ("min", planes[3][0], f_ok),
                           ("max", planes[3][0], f_ok),
                           ("cnt", arg, m), ("sum", arg, m),
                           ("min", planes[2][0], m & b.columns[2].valid)],
                     G, rp.n_rows))
        base += rp.cap
    return kernels.states_inputs(segs, device)


# K5, K6 and K7 are held to their plain versions EXACTLY, bit for bit:
# f64 argument planes and extrema included (no f64 sum reaches K6 on the
# cluster path or in these cases; K7 adds f64 states in region order on
# both sides). Each check returns the largest |kernel - plain| it read.

def check_k5(regions: list, device, what: str) -> float:
    kb, ko = kernels.expr_vm_ragged(regions, device)
    pb, po = kernels.expr_vm_ragged_plain(regions, device)
    need(torch.equal(kb, pb), f"{what}: K5 survivor bits differ")
    err = max_err(kb, pb)
    for (kv_, kok), (pv, pok) in zip(ko, po):
        need(torch.equal(kok, pok), f"{what}: K5 argument valid differs")
        need(torch.equal(kv_[pok], pv[pok]),
             f"{what}: K5 argument plane differs")
        err = max(err, max_err(kok, pok), max_err(kv_, pv, pok))
    return err


def check_k6(k6: tuple, what: str) -> float:
    gid, caps, n_rows, Gs, reds, contribs = k6
    got = kernels.seg_states_ragged(*k6)
    want = kernels.seg_states_ragged_plain(gid, caps, Gs, reds, contribs)
    need(torch.equal(got, want), f"{what}: K6 differs from its plain "
         "version")
    err = 0.0
    for j in range(len(contribs)):
        f64 = reds[0][j].op in kernels.F_OPS
        err = max(err, max_err(got[j].view(torch.float64) if f64 else got[j],
                               want[j].view(torch.float64) if f64
                               else want[j]))
    return err


def check_k7(states: list, codes: list, device, what: str) -> float:
    got = kernels.combine_partials(states, codes, device)
    want = kernels.combine_partials_plain(
        [torch.from_numpy(np.ascontiguousarray(x)) for x in states], codes)
    err = 0.0
    for g, w in zip(got, want):
        need(torch.equal(g, w), f"{what}: K7 differs from its plain version")
        both = torch.isfinite(g) if g.dtype == torch.float64 else None
        err = max(err, max_err(g, w, both))
    return err


def k6_bound(k6: tuple) -> tuple:
    gid, caps, n_rows, Gs, reds, contribs = k6
    live = int(sum(n_rows))
    S = sum(kernels.bucket_segments(g + 1) for g in Gs)
    nbytes = live * 8 + live * len({id(c) for c in contribs})
    for j, contrib in enumerate(contribs):
        r0 = reds[0][j]
        if r0.values is not None and r0.op != kernels.R_COUNT:
            nbytes += 8 * int(contrib.sum())
        if r0.valid is not None:
            nbytes += live
    nbytes += 8 * S * len(contribs)
    return bound(nbytes, live * len(contribs))


def phase_d(n_rows: int, seed: int, device, R: int = 8) -> dict:
    t0 = time.perf_counter()
    data = tpch.generate(n_rows, seed)
    batches = tpch.region_batches(data, D_CIDS, R)
    store = DistStore([], tpch.split_keys(n_rows, R), device,
                      plane_cache=PlaneCache(device=device))
    print(f"phase D: {n_rows} rows in {R} region batches built in "
          f"{time.perf_counter() - t0:.1f} s")
    stmt = {}
    for name, _make in tpch.SWEEP:
        sel = tpch.sweep_request(name)
        t1 = time.perf_counter()
        admit(store, sel, batches)
        hits = store.plane_cache.stats["hits"]
        rows = final_rows(store, sel)
        first_s = time.perf_counter() - t1
        need(store.plane_cache.stats["hits"] - hits == R,
             f"phase D {name}: not every region hit the plane cache")
        check_sweep(name, rows, data, "phase D")
        wall = host_ms(lambda: final_rows(store, sel), 10)
        kernels.SPLIT = {}
        final_rows(store, sel)
        split, kernels.SPLIT = kernels.SPLIT, None
        stmt[name] = {"ms": wall, "split": split,
                      "groups": fused_agg.stats["last_groups"]}
        print(f"  {name}: equal to numpy; statement {wall:.3f} ms median "
              f"of 10 (host clock; first run {first_s:.2f} s); split "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    ms = timer(device)
    sel = tpch.sweep_request("q1full")
    regions, k6, (states, codes) = capture(store, sel, device)
    out = {}
    # K5 at Q1's shapes, plus 64 edge regions
    k5_err = check_k5(regions, device, "K5 Q1")
    edge = _edge_regions(64, seed + 11, device)
    eregions = [rp for _b, rp in edge]
    k5_err = max(k5_err, check_k5(eregions, device, "K5 edge"))
    total = sum(rp.cap for rp in regions)
    n_out = len(regions[0].fin.out_dts)
    k5_bytes = _nbytes([t for rp in regions for t in rp.planes]) \
        + total // 8 + total * 9 * n_out
    cuda = device.type == "cuda"
    k5_launch = kernels.k5_prepare(regions, device)[0] if cuda \
        else (lambda: kernels.expr_vm_ragged(regions, device))
    k5_wrapper_ms = ms(lambda: kernels.expr_vm_ragged(regions, device))
    out["expr_vm_ragged"] = dict(
        ms=ms(k5_launch),
        plain_ms=ms(lambda: kernels.expr_vm_ragged_plain(regions, device)),
        library_ms=None, max_abs_err=k5_err,
        bound=bound(k5_bytes, sum(rp.cap * rp.fin.n_instr
                                  for rp in regions)))
    # K6 at Q1's shapes (spans within the shared-memory limit) and at
    # date_group's (about 2.5k dates per region: the sorted route), plus
    # edge states on each route
    _r, k6_date, _s = capture(store, tpch.sweep_request("date_group"), device)
    ebits, eouts = kernels.expr_vm_ragged(eregions, device)
    k6_err = {}
    for route, args, what in (
            ("seg_states_ragged", k6, "K6 Q1"),
            ("seg_states_ragged_sorted", k6_date, "K6 date_group"),
            ("seg_states_ragged", _edge_states(edge, ebits, eouts, device,
                                               False, seed + 13), "K6 edge"),
            ("seg_states_ragged_sorted",
             _edge_states(edge, ebits, eouts, device, True, seed + 13),
             "K6 edge large spans")):
        zero_launches()
        e = check_k6(args, what)
        need(not cuda or kernels.LAUNCHES[route] == 1,
             f"{what}: K6 did not take its {route} route")
        k6_err[route] = max(k6_err.get(route, 0.0), e)
    k6_wrapper_ms = {}
    for route, args in (("seg_states_ragged", k6),
                        ("seg_states_ragged_sorted", k6_date)):
        gid, caps, n_rows_, Gs, reds, contribs = args
        _sp, offs, _b = kernels._k6_layout(caps, Gs)
        S = int(offs[-1])
        g_off = gid + torch.repeat_interleave(
            torch.from_numpy(offs[:-1]).to(device),
            torch.tensor(caps, device=device))
        stacked = torch.stack(
            [torch.where(c_, torch.cat([r[j].values for r in reds])
                         if reds[0][j].values is not None
                         else torch.ones_like(gid), torch.zeros_like(gid))
             .view(torch.int64) for j, c_ in enumerate(contribs)], 1)
        k6_launch = kernels.k6_prepare(*args)[0] if cuda \
            else (lambda a=args: kernels.seg_states_ragged(*a))
        k6_wrapper_ms[route] = ms(lambda a=args: kernels.seg_states_ragged(*a))
        out[route] = dict(
            ms=ms(k6_launch),
            plain_ms=ms(lambda a=args: kernels.seg_states_ragged_plain(
                a[0], a[1], a[3], a[4], a[5])),
            library_ms=ms(lambda S=S, st=stacked, g=g_off: torch.zeros(
                S, st.shape[1], dtype=torch.int64, device=device)
                .index_add_(0, g, st)),
            max_abs_err=k6_err[route], bound=k6_bound(args))
    gid, caps, n_rows_, Gs, reds, contribs = k6
    S = int(kernels._k6_layout(caps, Gs)[1][-1])
    # K7 at Q1's 8 x 4 states, plus R = 64 with extremes
    k7_err = check_k7(states, codes, device, "K7 Q1")
    rng = np.random.default_rng(seed + 17)
    ei = rng.integers(-(1 << 62), 1 << 62, (64, 5), dtype=np.int64)
    ei[:, 0] = (1 << 63) - 1
    ef = rng.standard_normal((64, 5))
    ef[0] = np.inf
    k7_err = max(k7_err, check_k7(
        [ei, ei, ei, ef, ef, ef],
        [kernels.R_SUM_I, kernels.R_MIN_I, kernels.R_MAX_I,
         kernels.R_SUM_F, kernels.R_MIN_F, kernels.R_MAX_F], device,
        "K7 edge"))
    dev_states = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                  for x in states]
    stack7 = torch.cat([x.view(torch.int64) for x in dev_states], 1)
    n7 = sum(x.size for x in states)
    g7 = sum(x.shape[1] for x in states)
    k7_launch = kernels.k7_prepare(states, codes, device)[0] if cuda \
        else (lambda: kernels.combine_partials(states, codes, device))
    k7_wrapper_ms = ms(lambda: kernels.combine_partials(states, codes,
                                                        device))
    out["combine_partials"] = dict(
        ms=ms(k7_launch),
        plain_ms=ms(lambda: kernels.combine_partials_plain(dev_states,
                                                           codes)),
        library_ms=ms(lambda: torch.sum(stack7, dim=0)), max_abs_err=k7_err,
        bound=bound(8 * (n7 + g7), n7))
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    print(f"phase D: the wrappers with their host preparation (tables, "
          f"small copies; K7 also its readback): K5 {k5_wrapper_ms:.4f} ms, "
          f"K6 {k6_wrapper_ms['seg_states_ragged']:.4f} ms (date_group, "
          f"sorted route: {k6_wrapper_ms['seg_states_ragged_sorted']:.4f} "
          f"ms), K7 {k7_wrapper_ms:.4f} ms")
    dg = k6_date
    print(f"phase D: Q1 inputs: {len(regions)} regions, {total} rows, "
          f"{len(contribs)} reductions, {S} segments, K7 {len(states)} "
          f"states of {states[0].shape}; date_group K6 inputs: "
          f"{len(dg[5])} reductions, "
          f"{int(kernels._k6_layout(dg[1], dg[3])[1][-1])} segments")
    print("phase D statements: " + json.dumps(stmt))
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
    launches.update(phase_c(tpch.SF001_ROWS, seed=1, device=device))
    results.update(phase_d(tpch.SF1_ROWS, seed=2, device=device))
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
