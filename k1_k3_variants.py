#!/usr/bin/env python3
"""K3 and K1 against variants of their own sources, in turns on one card.

    python3 k1_k3_variants.py

Builds the repo's kernels, then copies of ops/csrc/seg_agg_onehot.cu and
ops/csrc/expr_vm.cu with one design choice changed (into build/variants/,
beside the repo's libraries; k5_k19_variants.variant), binds each with the
repo's C signatures and swaps it in through `_ext._libs`, so the same
wrappers launch it. Every variant but the diagnostic ones is held to the
plain version first.

- K3 at Q1 at SF1 (8,388,608 rows, 13 segments, 11 reductions in 12
  slots, as chip_smoke's Phase B): the repo's kernel (one integer slot's
  loads at a time, two row pairs a lane a step, 256 threads, four resident
  blocks an SM); 64-bit shared-memory atomics (compare-and-swap loops) for
  sums, min and max; one or four row pairs a lane; 512 threads a block;
  the ids read whatever the mask; and, as diagnostics whose answers are
  wrong, plain shared-memory updates in place of the atomics and no value
  loads. Medians of 20 CUDA-event runs of the wrapper and of the launch
  alone (kernels.k3_prepare), three turns each way; the wrapper at the
  64-segment edge (1,048,576 rows, 10 reductions).
- K1 at Q1 (12 instructions, the group id and two argument planes): the
  repo's kernel (at most 64 registers: four blocks an SM) against three
  and two blocks an SM; the wrapper and the launch alone
  (kernels.k1_prepare).

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import k5_k19_variants as kv  # noqa: E402
from tidb_tpu_torch import tpch  # noqa: E402
from tidb_tpu_torch.ops import _ext, kernels  # noqa: E402

K3_VARIANTS = {
    "cas_atomics": [
        ("      const unsigned old = atomicAdd(w, lo);\n"
         "      const unsigned up = hi + (old + lo < old ? 1u : 0u);\n"
         "      if (up != 0u) atomicAdd(w + 1, up);",
         "      (void)w; (void)lo; (void)hi;\n"
         "      atomicAdd((unsigned long long*)p, (unsigned long long)x);"),
        ("      if (x > *(volatile i64*)p) atomicMax(",
         "      atomicMax("),
        ("      if (x < *(volatile i64*)p) atomicMin(",
         "      atomicMin(")],
    "pairs_1": [("#define K3_PAIRS 2", "#define K3_PAIRS 1")],
    "pairs_4": [("#define K3_PAIRS 2", "#define K3_PAIRS 4"),
                ("#define K3_MINB 4", "#define K3_MINB 2")],
    "threads_512": [("#define K3_THREADS 256", "#define K3_THREADS 512"),
                    ("#define K3_MINB 4", "#define K3_MINB 2")],
    "ids_unmasked": [("    if (m != 0u) k3_pair<VEC>(a.gid,",
                      "    if (r0[u] || r1[u]) k3_pair<VEC>(a.gid,")],
}
# diagnostics: their answers are wrong, only their times are read
K3_DIAGNOSTICS = {
    "no_atomics": [("    case R_COUNT: atomicAdd((unsigned*)p, cnt); break;",
                    "    case R_COUNT: *(unsigned*)p += cnt; break;"),
                   ("      const unsigned old = atomicAdd(w, lo);",
                    "      const unsigned old = *w; *w += lo;"),
                   ("      if (up != 0u) atomicAdd(w + 1, up);",
                    "      w[1] += up;")],
    "no_value_loads": [("      } else if (vals != nullptr && live) {\n"
                        "        k3_pair<VEC>(vals, p[u], r0[u], r1[u], "
                        "x0[u], x1[u]);",
                        "      } else if (false) {\n"
                        "        k3_pair<VEC>(vals, p[u], r0[u], r1[u], "
                        "x0[u], x1[u]);")],
}
K1_VARIANTS = {
    "minb_3": [("#define K1_MINB 4", "#define K1_MINB 3")],
    "minb_2": [("#define K1_MINB 4", "#define K1_MINB 2")],
}


def q1_inputs(dev) -> tuple:
    data = tpch.generate(tpch.SF1_ROWS, 2)
    batch = tpch.batch(data, [tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
                              tpch.C_DISCOUNT, tpch.C_TAX, tpch.C_RETURNFLAG,
                              tpch.C_LINESTATUS, tpch.C_SHIPDATE])
    return cs.Request(tpch.q1(), batch, dev)


def k3(dev, q1) -> None:
    mask, gid, outs = q1.k1()
    reds = q1.reds(outs)
    S = q1.segments
    rng = np.random.default_rng(5)
    n = 1 << 20
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    eb = cs.edge_batch(n, 9)
    emask = kernels.device_live(eb, dev) & t(rng.random(n) > 0.3)
    ereds = cs.edge_reductions(eb, dev, rng)
    egid = t(rng.integers(0, 64, n))
    libs = {"repo": _ext.lib("seg_agg_onehot")}
    libs.update({name: kv.variant("k3_" + name, "seg_agg_onehot", edits)
                 for name, edits in K3_VARIANTS.items()})
    for name, lib in libs.items():
        _ext._libs["seg_agg_onehot"] = lib
        kernels._SCRATCH.clear()
        cs.check_k3(gid, mask, S, reds, f"K3 {name} Q1")
        cs.check_k3(egid, emask, 64, ereds, f"K3 {name} edge")
    libs.update({name: kv.variant("k3_" + name, "seg_agg_onehot", edits)
                 for name, edits in K3_DIAGNOSTICS.items()})
    kv.report("K3", kv.turns(libs, "seg_agg_onehot", {
        "q1": lambda: lambda: kernels.seg_agg_onehot(gid, mask, S, reds),
        "q1 launch": lambda: kernels.k3_prepare(gid, mask, S, reds)[0],
        "edge64": lambda: lambda: kernels.seg_agg_onehot(egid, emask, 64,
                                                         ereds)}))
    _ext._libs["seg_agg_onehot"] = libs["repo"]
    print(f"K4's block route at Q1: "
          f"{cs.cuda_ms(lambda: kernels._k4_block(gid, mask, S, reds)):.4f} "
          f"ms")


def k1(dev, q1) -> None:
    libs = {"repo": _ext.lib("expr_vm")}
    libs.update({name: kv.variant("k1_" + name, "expr_vm", edits)
                 for name, edits in K1_VARIANTS.items()})
    for name, lib in libs.items():
        _ext._libs["expr_vm"] = lib
        cs.check_k1(q1, f"K1 {name} Q1")
    kv.report("K1", kv.turns(libs, "expr_vm", {
        "q1": lambda: lambda: kernels.expr_vm(q1.fin, q1.plane_list,
                                              q1.live, True),
        "q1 launch": lambda: kernels.k1_prepare(q1.fin, q1.plane_list,
                                                q1.live, True)[0]}))
    _ext._libs["expr_vm"] = libs["repo"]


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_k3_variants: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.print_versions()
    cs.build()
    q1 = q1_inputs(dev)
    k3(dev, q1)
    k1(dev, q1)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
