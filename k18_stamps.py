#!/usr/bin/env python3
"""Where a K18 tile's time goes, on one card.

    python3 k18_stamps.py

Builds the repo's kernels, then a copy of ops/csrc/window_scan.cu whose
scan kernel stamps each tile's phases with the card's globaltimer (into
build/stamps/, beside the repo's libraries), and runs K18 through
kernels.window_scan at an SF1-sized input (6,001,215 rows in partitions of
1 to 7 rows, every row its own peer group): SUM + COUNT and ROW_NUMBER
alone. For each it prints the call's time (median of 20 CUDA-event runs),
the kernel's span, a tile's phases (ticket, loads, scans, look-back, runs,
outputs; median and 90th percentile), how long a tile's look-back ends
after both its own and its predecessor's aggregates were ready, and the
tiles in flight. Then it times the repo's kernel against a copy built at
two blocks an SM in place of three, in turns. Every call's figures are
held to K18's plain version first. Needs one card; imports nothing of
JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_ms, need, smi_line  # noqa: E402
from tidb_tpu_torch import tpch  # noqa: E402
from tidb_tpu_torch.ops import _ext, kernels  # noqa: E402

STAMPS = os.path.join(ROOT, "build", "stamps")
# (anchor in window_scan.cu, what the stamped copy puts in its place)
STAMP_EDITS = [
    ("struct K18RedArg {",
     "__device__ unsigned long long k18_stamps[8192 * 8];\n"
     "__device__ __forceinline__ unsigned long long gt() {\n"
     "  unsigned long long x;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(x));\n"
     "  return x;\n}\n"
     "extern \"C\" int k18_stamps_read(void* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, k18_stamps,\n"
     "                                   sizeof(k18_stamps));\n}\n"
     "struct K18RedArg {"),
    ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
     "  if (t == 0) s_tile",
     "  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
     "  const unsigned long long T0 = gt();\n  if (t == 0) s_tile"),
    ("  const i64 b = s_tile;\n",
     "  const i64 b = s_tile;\n  const unsigned long long T1 = gt();\n"),
    ("  cp_async_wait_all();\n",
     "  cp_async_wait_all();\n  const unsigned long long T2 = gt();\n"),
    ("  // publish the aggregate (tile 0",
     "  const unsigned long long T3 = gt();\n"
     "  // publish the aggregate (tile 0"),
    ("  __syncthreads();\n\n  // every row's runs",
     "  __syncthreads();\n  const unsigned long long T4 = gt();\n\n"
     "  // every row's runs"),
    ("  for (int f = 0; f < a.n_fig; ++f) {\n    const int kind",
     "  const unsigned long long T5 = gt();\n"
     "  for (int f = 0; f < a.n_fig; ++f) {\n    const int kind"),
    ("    store_rows(a.fig[f].out, i0, n, o, 0u);\n  }\n}",
     "    store_rows(a.fig[f].out, i0, n, o, 0u);\n  }\n  __syncthreads();\n"
     "  if (t == 0 && b < 8192) {\n"
     "    unsigned long long* d = k18_stamps + b * 8;\n"
     "    d[0] = T0; d[1] = T1; d[2] = T2; d[3] = T3;\n"
     "    d[4] = T4; d[5] = T5;\n"
     "    d[6] = gt();\n  }\n}"),
]
TWO_AN_SM = [("__launch_bounds__(K18_THREADS, 3)\nk18_scan",
              "__launch_bounds__(K18_THREADS, 2)\nk18_scan")]
PHASES = ("ticket", "loads", "scans", "look-back", "runs", "outputs")


def build_copy(name: str, edits: list) -> ctypes.CDLL:
    """window_scan.cu with `edits`, built as the repo's sources are."""
    with open(os.path.join(_ext.CSRC, "window_scan.cu")) as f:
        src = f.read()
    for old, new in edits:
        need(src.count(old) == 1, f"{name}: anchor not found once: {old!r}")
        src = src.replace(old, new)
    os.makedirs(STAMPS, exist_ok=True)
    path = os.path.join(STAMPS, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(STAMPS, f"{name}.so")
    p = subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-I", _ext.CSRC,
                        "-o", so, path], capture_output=True, text=True)
    need(p.returncode == 0, f"{name}: nvcc failed:\n{p.stdout}{p.stderr}")
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "stack frame" in line:
            print(f"  {name}: {line.strip()}")
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in _ext.SIGNATURES["window_scan"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def report(lib, seg, peer, specs, what: str) -> None:
    n = seg.shape[0]
    got = kernels.window_scan(seg, peer, specs, n)
    want = kernels.window_scan_plain(seg, peer, specs, n)
    need(all(torch.equal(g, w) for g, w in zip(got, want)),
         f"{what}: the stamped K18 differs from its plain version")
    ms = cuda_ms(lambda: kernels.window_scan(seg, peer, specs, n))
    kernels.window_scan(seg, peer, specs, n)
    torch.cuda.synchronize()
    raw = np.zeros(8192 * 8, np.uint64)
    need(lib.k18_stamps_read(raw.ctypes.data) == 0, "stamps unread")
    nb = -(-n // kernels.K18_TILE)
    d = raw.reshape(-1, 8)[:nb].astype(np.int64)
    ph = np.diff(d[:, :7], axis=1) / 1e3
    after = (d[1:, 4] - np.maximum(d[1:, 3], d[:-1, 3])) / 1e3
    t0, t1 = d[:, 0].min(), d[:, 6].max()
    flight = [int(np.sum((d[:, 0] <= x) & (d[:, 6] >= x)))
              for x in np.linspace(t0, t1, 12)[1:-1]]
    print(f"{what}: {ms:.4f} ms a call; the scan's span "
          f"{(t1 - t0) / 1e3:.1f} µs over {nb} tiles; a tile "
          f"{np.median(d[:, 6] - d[:, 0]) / 1e3:.2f} µs (median)")
    print("  phases, median / p90 µs: " + ", ".join(
        f"{p} {np.median(ph[:, i]):.2f} / {np.percentile(ph[:, i], 90):.2f}"
        for i, p in enumerate(PHASES)))
    print(f"  the look-back ends {np.median(after):.2f} µs (median; p90 "
          f"{np.percentile(after, 90):.2f}) after both the tile's and its "
          f"predecessor's aggregates were ready; tiles in flight {flight}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k18_stamps: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(smi_line())
    _ext.build_all()
    stamped = build_copy("k18_stamped", STAMP_EDITS)
    two = build_copy("k18_two_an_sm", TWO_AN_SM)
    n = tpch.SF1_ROWS
    rng = np.random.default_rng(2)
    lines = rng.integers(1, 8, n // 4 + 10)
    seg = np.repeat(np.arange(len(lines)), lines)[:n].astype(np.int64)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dseg, dpeer = t(seg), t(np.arange(n, dtype=np.int64))
    dq = t(rng.integers(100, 5000, n).astype(np.int64))
    dok = torch.ones(n, dtype=torch.bool, device=dev)
    sum_count = [("sum", dq, dok), ("count", None, dok)]
    row_number = [("row_number", None, None)]
    orig = _ext.lib

    def use(lib):
        """Route kernels' K18 calls to `lib` (None: the repo's library)."""
        _ext.lib = orig if lib is None else (
            lambda name: lib if name == "window_scan" else orig(name))

    use(stamped)
    report(stamped, dseg, dpeer, sum_count, "SUM + COUNT")
    report(stamped, dseg, dpeer, row_number, "ROW_NUMBER")
    # three blocks an SM (the repo's) against two, in turns
    times = {"three an SM": [], "two an SM": []}
    for order in (("three an SM", "two an SM"), ("two an SM", "three an SM")):
        for what in order:
            use(None if what == "three an SM" else two)
            times[what].append(cuda_ms(lambda: kernels.window_scan(
                dseg, dpeer, sum_count, n)))
    use(None)
    print("SUM + COUNT, in turns: " + "; ".join(
        f"{k} " + " / ".join(f"{x:.4f}" for x in v) for k, v in times.items())
        + " ms")
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
