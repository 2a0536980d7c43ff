#!/usr/bin/env python3
"""K5 and K19 against variants of their own sources, in turns on one card.

    python3 k5_k19_variants.py

Builds the repo's kernels, then copies of ops/csrc/expr_vm.cu and
ops/csrc/delta_merge.cu with one design choice undone (into
build/variants/, beside the repo's libraries), binds each with the repo's
C signatures and swaps it in through `_ext._libs`, so the same wrappers
launch it. Every variant is held to the plain version first.

- K5 at q1full over 8 regions at SF1 (8,388,608 rows): the repo's kernel
  (instructions fetched from the table in the parameter space, four rows
  a thread, the table in the 4 KB parameter block); a block's program
  stream copied into shared memory where it changes; one row a thread
  (1,024 threads a block); the 31 KB parameter block. Launch (kernels.k5_prepare) and wrapper, medians of 20
  CUDA-event runs, each variant three times in turns.
- K19 at region_8's and tombstones_only's shapes (1,048,576 base rows,
  760,531 / 748,565 live, 6,924 / 786 tombstones, 6,059 / 0 appended;
  chip_smoke.k19_case): tiles of 4,096 rows at two blocks an SM (the
  repo's), 2,048 at four and 8,192 at one; launch with the merged handle
  plane, medians of 20 CUDA-event runs, three turns. Then the repo's
  kernel with globaltimer stamps: each tile's phases (ticket, loads,
  fold + searches + staging, keep + scan + publish, look-back,
  placement; median and 90th percentile) and the kernel's span.

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tidb_tpu_torch import tpch  # noqa: E402
from tidb_tpu_torch.cluster.store import DistStore  # noqa: E402
from tidb_tpu_torch.copr.plane_cache import PlaneCache  # noqa: E402
from tidb_tpu_torch.ops import _ext, kernels  # noqa: E402
from tidb_tpu_torch.ops import columnar as col  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")

K5_VARIANTS = {
    "staged": [
        ("  for (i64 tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {",
         "  __shared__ i64 s_ins[6 * 64];\n  i64 staged = -1;\n"
         "  for (i64 tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {"),
        ("    vm_exec_rows<K5_ROWS>(w + st[0], ",
         "    if (d[2] != staged) {\n      __syncthreads();\n"
         "      for (int i = threadIdx.x; i < 6 * n_instr; i += K5_THREADS)\n"
         "        s_ins[i] = w[st[0] + i];\n      __syncthreads();\n"
         "      staged = d[2];\n    }\n"
         "    vm_exec_rows<K5_ROWS>(s_ins, ")],
    "one_row": [("#define K5_THREADS 256", "#define K5_THREADS 1024")],
    "large_block": [("  if (n_words <= K5_SMALL_WORDS) {", "  if (false) {")],
}
K19_VARIANTS = {
    "tile_2048": [("#define K19_THREADS 512", "#define K19_THREADS 256"),
                  ("#define K19_SLICE 2048", "#define K19_SLICE 1024"),
                  ("#define K19_MIN_BLOCKS 2", "#define K19_MIN_BLOCKS 4")],
    "tile_8192": [("#define K19_THREADS 512", "#define K19_THREADS 1024"),
                  ("#define K19_MIN_BLOCKS 2", "#define K19_MIN_BLOCKS 1")],
}
# (anchor in delta_merge.cu, what the stamped copy puts in its place)
STAMPS = [
    ("struct K19Args {",
     "__device__ unsigned long long k19_stamps[4096 * 8];\n"
     "__device__ __forceinline__ unsigned long long gt() {\n"
     "  unsigned long long x;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(x));\n"
     "  return x;\n}\n"
     "extern \"C\" int k19_stamps_read(void* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, k19_stamps,\n"
     "                                   sizeof(k19_stamps));\n}\n"
     "struct K19Args {"),
    ("  if (t == 0) s_tile = ",
     "  const unsigned long long T0 = gt();\n  if (t == 0) s_tile = "),
    ("  const i64 b = s_tile;\n",
     "  const i64 b = s_tile;\n  const unsigned long long T1 = gt();\n"),
    ("  // the tile's live range (each warp's fold",
     "  const unsigned long long T2 = gt();\n"
     "  // the tile's live range (each warp's fold"),
    ("  // keep flags; the kept rows' ranks",
     "  const unsigned long long T3 = gt();\n"
     "  // keep flags; the kept rows' ranks"),
    ("  // look back with the whole block",
     "  const unsigned long long T4 = gt();\n"
     "  // look back with the whole block"),
    ("  // the kept rows, a thread every K19_THREADS ranks",
     "  const unsigned long long T5 = gt();\n"
     "  // the kept rows, a thread every K19_THREADS ranks"),
    ("      if (a.merged != nullptr && pos < a.merged_len) a.merged[pos] = x;\n"
     "    }\n  }\n}",
     "      if (a.merged != nullptr && pos < a.merged_len) a.merged[pos] = x;\n"
     "    }\n  }\n  __syncthreads();\n  if (t == 0 && b < 4096) {\n"
     "    unsigned long long* d = k19_stamps + b * 8;\n"
     "    d[0] = T0; d[1] = T1; d[2] = T2; d[3] = T3; d[4] = T4; d[5] = T5;\n"
     "    d[6] = gt();\n  }\n}"),
]
PHASES = ("ticket", "loads", "fold + searches + staging",
          "keep + scan + publish", "look-back", "placement")


def variant(name: str, src: str, edits: list, extra: dict | None = None):
    """A copy of ops/csrc/<src>.cu with `edits`, built and bound."""
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_ext.CSRC, d)
    path = os.path.join(d, src + ".cu")
    with open(path) as f:
        s = f.read()
    for old, new in edits:
        cs.need(old in s, f"{name}: anchor {old[:40]!r} not in {src}.cu")
        s = s.replace(old, new)
    with open(path, "w") as f:
        f.write(s)
    so = os.path.join(d, src + ".so")
    r = subprocess.run([_ext.nvcc_path(), *_ext.NVCC_FLAGS, "-I", d, "-o", so,
                        path], capture_output=True, text=True)
    cs.need(r.returncode == 0, f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in {**_ext.SIGNATURES[src],
                                    **(extra or {})}.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def turns(libs: dict, src: str, makers: dict, rounds: int = 3) -> dict:
    """Each library in turns, `rounds` times forward and back, timing what
    each maker builds with it in place (a wrapper binds its library when
    it prepares): {(library, what): [ms]}."""
    out: dict = {}
    order = list(libs.items())
    for _ in range(rounds):
        for name, lib in order + order[::-1]:
            _ext._libs[src] = lib
            kernels._SCRATCH.clear()
            for what, make in makers.items():
                out.setdefault((name, what), []).append(cs.cuda_ms(make()))
    return out


def report(label: str, times: dict) -> None:
    for (name, what), v in times.items():
        print(f"{label} {what} {name}: median {np.median(v):.4f} ms "
              f"(runs {', '.join(f'{x:.4f}' for x in v)})")


def k5(dev) -> None:
    data = tpch.generate(tpch.SF1_ROWS, 2)
    st = DistStore([], tpch.split_keys(tpch.SF1_ROWS, 8), dev,
                   plane_cache=PlaneCache(device=dev))
    q1full = tpch.sweep_request("q1full")
    cs.admit(st, q1full, tpch.region_batches(data, cs.D_CIDS, 8))
    cs.final_rows(st, q1full)
    regions = cs.capture(st, q1full, dev)[0]
    libs = {"repo": _ext.lib("expr_vm")}
    libs.update({name: variant("k5_" + name, "expr_vm", edits)
                 for name, edits in K5_VARIANTS.items()})
    for name, lib in libs.items():
        _ext._libs["expr_vm"] = lib
        cs.check_k5(regions, dev, f"K5 {name}")
    report("K5 q1full", turns(libs, "expr_vm", {
        "launch": lambda: kernels.k5_prepare(regions, dev)[0],
        "wrapper": lambda: lambda: kernels.expr_vm_ragged(regions, dev)}))
    _ext._libs["expr_vm"] = libs["repo"]


def k19_cases(dev) -> dict:
    out = {}
    for what, args in (
            ("region_8", (760531, 1 << 20, 5540, "between", 3, False, 6059)),
            ("tombstones_only", (748565, 1 << 20, 629, "none", 4, False,
                                 None))):
        h, live, tomb, app = [torch.from_numpy(a).to(dev)
                              for a in cs.k19_case(*args)]
        merged = torch.full((col.bucket_capacity(int(live.sum())
                                                 + app.shape[0]),),
                            col.I64_MIN, dtype=torch.int64, device=dev)
        out[what] = (h, live, tomb, app, merged)
    return out


def k19(dev) -> None:
    cases = k19_cases(dev)
    libs = {"repo": _ext.lib("delta_merge")}
    libs.update({name: variant("k19_" + name, "delta_merge", edits)
                 for name, edits in K19_VARIANTS.items()})
    for name, lib in libs.items():
        _ext._libs["delta_merge"] = lib
        kernels._SCRATCH.clear()
        for what, (h, live, tomb, app, merged) in cases.items():
            cs.check_k19(h, live, tomb, app, f"K19 {name} {what}")
    makers = {what: (lambda c=c: kernels.delta_merge_prepare(*c)[0])
              for what, c in cases.items()}
    report("K19", turns(libs, "delta_merge", makers))
    stamped = variant("k19_stamps", "delta_merge", STAMPS, {
        "k19_stamps_read": ([ctypes.c_void_p], ctypes.c_int)})
    _ext._libs["delta_merge"] = stamped
    kernels._SCRATCH.clear()
    for what, (h, live, tomb, app, merged) in cases.items():
        for _ in range(3):
            kernels.delta_merge_order(h, live, tomb, app, merged)
        buf = np.zeros(4096 * 8, dtype=np.uint64)
        cs.need(stamped.k19_stamps_read(buf.ctypes.data) == 0,
                "K19 stamps: read failed")
        nb = stamped.delta_merge_tiles(h.shape[0])
        s = buf.reshape(4096, 8)[:nb, :7].astype(np.int64)
        ph = np.diff(s, axis=1) / 1e3
        print(f"K19 {what} stamps: {nb} tiles, span "
              f"{(s[:, 6].max() - s[:, 0].min()) / 1e3:.2f} us; "
              + "; ".join(f"{p} median {np.median(ph[:, i]):.2f} us, p90 "
                          f"{np.percentile(ph[:, i], 90):.2f}"
                          for i, p in enumerate(PHASES)))
    _ext._libs["delta_merge"] = libs["repo"]


def main() -> int:
    if not torch.cuda.is_available():
        print("k5_k19_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    _ext.build_all()
    k5(dev)
    k19(dev)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
