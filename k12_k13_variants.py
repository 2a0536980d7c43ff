#!/usr/bin/env python3
"""K12 and K13 at Phase F's shapes: their split on the card, and variants
of their own sources in turns.

    python3 k12_k13_variants.py [--split-only]

Builds the kernels of this checkout and times, at SF1's shapes (tpch.generate(SF1_ROWS, 2) and its orders and
partsupp):

- the split: each wrapper call of K12 (lineitem's 6,001,215 l_orderkey
  probing orders' 1,500,216 o_orderkey words; the same probe over the
  8,388,608-row batch capacity in 8 shards; the segmented mode over
  K21's layouts at P 8, as chip_smoke's Phase K.2; the skew case, the
  build side with 2^20 more rows of one order key) and of K13 (f2's
  lineitem side: l_partkey and l_suppkey in domain mode over their
  domains with partsupp's keys) under torch.profiler over 20 calls
  (chip_smoke.device_split): every device kernel and copy by name with
  its launches and device time a call, beside the call's CUDA-event time
  (median of 20) and its host time (enqueue to the end of the call,
  median of 20);
- the variants (not with --split-only): copies of ops/csrc/join_probe.cu and
  ops/csrc/dict_remap.cu with one design choice changed in the code
  (into build/variants/; k5_k19_variants.variant), bound with the repo's
  C signatures and swapped in through `_ext._libs`, each held to the
  plain version first, then timed in turns (medians of 20 CUDA-event runs,
  three turns each way). K12: an 8,192-word sample, no warp
  window, no steps from the lower bound, 1,024-row count tiles, the
  count's registers for two blocks an SM, 1,024-item expand blocks; each
  timed through the wrapper and, its count launch alone through the C
  entry point, over lineitem's keys in their order (l_orderkey ascends)
  and shuffled. K13: no interpolation probe, no load a step ahead, no
  shared memory (nothing staged), two or eight rows a thread, 48 KB of
  tables, and the mode switch fixed at f2's one mode (a kernel
  specialised on its columns' modes; right for f2's columns only).

Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# K12: (name, edits to join_probe.cu)
K12_VARIANTS = {
    # an 8,192-word sample in shared memory (the repo's 2,048): a narrower
    # slice searched in L2, four times the staging a block
    "sample_8k": [("#define K12_SAMPLE 2048", "#define K12_SAMPLE 8192")],
    # no warp window: every key through the sample and a slice
    "no_window": [("    if (kmin <= kmax &&", "    if (false && kmin <= kmax &&")],
    # the upper bound by a search, no steps from the lower bound
    "no_steps": [("#define K12_STEPS 8", "#define K12_STEPS 0")],
    # 1,024-row count tiles (the repo's 2,048)
    "items_4": [("#define K12_ITEMS 8", "#define K12_ITEMS 4")],
    # the count's registers for two blocks an SM (the repo's three)
    "min_blocks_2": [("#define K12_MIN_BLOCKS 3", "#define K12_MIN_BLOCKS 2")],
    # 1,024-item expand blocks (the repo's 2,048)
    "expand_1k": [("#define K12_EX_ITEMS 8", "#define K12_EX_ITEMS 4")],
}
# K13: (name, edits to dict_remap.cu)
K13_VARIANTS = {
    # no interpolation probe: every row searches the table
    "no_probe": [("  const i64 first = whole ?", "  if (false) {\n  const i64 first = whole ?"),
                 ("  if (!__any_sync(0xffffffffu, any)) return;\n",
                  "  if (!__any_sync(0xffffffffu, any)) return;\n  }\n")],
    # each step's values loaded when it starts (no load one step ahead)
    "no_prefetch": [("if (tn < ntiles) k13_load(a.col[more ? c + 1 : 0], "
                     "tn * tile_rows + threadIdx.x, a.n, vn, vbn);",
                     "k13_load(d, base, a.n, v, vb);"),
                    ("        v[r] = vn[r];\n        vb[r] = vbn[r];\n", "")],
    # no shared memory for tables: every table searched in L2
    "no_staging": [("#define K13_SMEM (110 * 1024)", "#define K13_SMEM 0")],
    # two and eight rows a thread (the repo's four)
    "rows_2": [("#define K13_ROWS 4", "#define K13_ROWS 2")],
    "rows_8": [("#define K13_ROWS 4", "#define K13_ROWS 8")],
    # 48 KB of tables and samples (the repo's 110 KB)
    "smem_48k": [("#define K13_SMEM (110 * 1024)", "#define K13_SMEM (48 * 1024)")],
    # the mode switch fixed at f2's columns' one mode (i64 domains): the
    # row loop as a kernel specialised on its modes runs it
    "modes_fixed": [("      switch (d.mode) {", "      switch (K13_DOM_I64) {")],
}


def host_ms(fn, runs: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(t))


def inputs(dev) -> dict:
    """The K12 and K13 inputs at SF1 (see the docstring)."""
    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.copr import dictionary as pdict
    from tidb_tpu_torch.ops import kernels

    import chip_smoke as cs

    line = tpch.generate(tpch.SF1_ROWS, 2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    lk = t(line[tpch.C_ORDERKEY])
    lv = torch.ones(lk.shape[0], dtype=torch.bool, device=dev)
    okeys = tpch.orders(line, 2)[tpch.O_ORDERKEY]
    rk = t(okeys)
    rv = torch.ones(rk.shape[0], dtype=torch.bool, device=dev)
    words, order = kernels.join_build(rk, rv)
    cap = 1 << 23
    lk_cap = torch.zeros(cap, dtype=torch.int64, device=dev)
    lv_cap = torch.zeros(cap, dtype=torch.bool, device=dev)
    lk_cap[:lk.shape[0]] = lk
    lv_cap[:lk.shape[0]] = True
    # skew: 2^20 more build rows of the order key of lineitem's row 0
    sk = t(np.concatenate([okeys, np.full(1 << 20, line[tpch.C_ORDERKEY][0],
                                          np.int64)]))
    sw, so = kernels.join_build(sk, torch.ones(sk.shape[0], dtype=torch.bool,
                                               device=dev))
    seg = cs.k_segmented(lk, lv, rk, rv, 8)
    ps = tpch.partsupp(tpch.SF1_ROWS, 2)
    specs = []
    for lc, pc in ((tpch.C_PARTKEY, tpch.PS_PARTKEY),
                   (tpch.C_SUPPKEY, tpch.PS_SUPPKEY)):
        vals = line[lc]
        dom = np.unique(np.concatenate([vals, ps[pc]]))
        specs.append(pdict.KeySpec("domain", vals, np.ones(len(vals), bool),
                                   dom, len(dom)))
    specs[0].stride, specs[1].stride = specs[1].size, 1
    cols = kernels.remap_cols(specs, dev)
    return dict(lk=lk, lv=lv, words=words, order=order, lk_cap=lk_cap,
                lv_cap=lv_cap, sw=sw, so=so, seg=seg, cols=cols,
                n2=lk.shape[0])


def calls(a: dict) -> dict:
    from tidb_tpu_torch.ops import kernels
    w, o = a["words"], a["order"]
    return {
        "k12": lambda: kernels.join_probe(w, o, a["lk"], a["lv"]),
        "k12_sharded": lambda: kernels.join_probe(w, o, a["lk_cap"],
                                                  a["lv_cap"], shards=8),
        "k12_seg": lambda: kernels.join_probe_partitioned(**a["seg"]),
        "k12_skew": lambda: kernels.join_probe(a["sw"], a["so"], a["lk"],
                                               a["lv"]),
        "k13_f2": lambda: kernels.dict_remap(a["cols"], a["n2"]),
    }


def split(a: dict) -> None:
    import chip_smoke as cs
    for name, fn in calls(a).items():
        print(f"split {name}: call {cs.cuda_ms(fn):.4f} ms (CUDA events), "
              f"host {host_ms(fn):.4f} ms")
        by_name, _edges = cs.device_split(fn)
        for k, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
            print(f"  {k}: {n:g} a call, {us:.2f} µs a call")


def count_alone(a: dict, keys: torch.Tensor):
    """A maker of K12's count launch alone through the C entry point of
    the library in place (Phase F's build words, `keys` as the probe,
    every row valid): no expand, no allocation, its own workspace and
    epochs."""
    from tidb_tpu_torch.ops import _ext, kernels

    def make():
        lib = _ext.lib("join_probe")
        w, lv = a["words"], a["lv"]
        nl, nv = keys.shape[0], w.shape[0]
        shift = kernels.sample_shift(nv, lib.join_probe_sample_cap() - 1)
        lo = torch.empty(nl, dtype=torch.int32, device=keys.device)
        offs = torch.empty(nl, dtype=torch.int64, device=keys.device)
        ws = torch.zeros(lib.join_probe_workspace_bytes(nl),
                         dtype=torch.uint8, device=keys.device)
        host = torch.empty(64, dtype=torch.int64, pin_memory=True)
        st = kernels._stream(keys.device)
        epoch = [0]

        def launch():
            epoch[0] += 1
            rc = lib.join_probe_count_launch(
                nl, keys.data_ptr(), lv.data_ptr(), 0, w.data_ptr(), nv,
                None, None, 0, shift, 4, lo.data_ptr(),
                offs.data_ptr(), nl, 2, ws.data_ptr(), epoch[0],
                host.data_ptr(), st)
            _ext.check(rc, "join_probe count")
        return launch
    return make


def variants(a: dict) -> None:
    import chip_smoke as cs
    import k5_k19_variants as kv
    from tidb_tpu_torch.ops import _ext, kernels
    fns = calls(a)
    shuffled = a["lk"][torch.randperm(a["lk"].shape[0],
                                      generator=torch.Generator().manual_seed(5)
                                      ).to(a["lk"].device)].contiguous()
    k12_makers = {w: (lambda w=w: fns[w]) for w in ("k12", "k12_seg",
                                                    "k12_skew")}
    k12_makers["count_in_order"] = count_alone(a, a["lk"])
    k12_makers["count_shuffled"] = count_alone(a, shuffled)
    for src, table, makers in (
            ("join_probe", K12_VARIANTS, k12_makers),
            ("dict_remap", K13_VARIANTS, {"k13_f2": lambda: fns["k13_f2"]})):
        libs = {"repo": _ext.lib(src)}
        libs.update({name: kv.variant("v_" + name, src, edits)
                     for name, edits in table.items()})
        for name, lib in libs.items():
            _ext._libs[src] = lib
            if src == "dict_remap":
                cs.check_k13(a["cols"], a["n2"], f"K13 {name}")
                continue
            for ww, oo in ((a["words"], a["order"]), (a["sw"], a["so"])):
                got, _t = kernels.join_probe(ww, oo, a["lk"], a["lv"])
                want = kernels.join_probe_plain(ww, oo, a["lk"], a["lv"])
                cs.need(torch.equal(got.to(torch.int64), want),
                        f"K12 {name} differs from its plain version")
            got, tot = kernels.join_probe_partitioned(**a["seg"])
            want, tp = kernels.join_probe_partitioned_plain(**a["seg"])
            cs.need(torch.equal(got.to(torch.int64), want)
                    and np.array_equal(tot, tp),
                    f"K12 {name} (segmented) differs from its plain version")
        kv.report(src, kv.turns(libs, src, makers))
        _ext._libs[src] = libs["repo"]


def main(argv: list) -> int:
    if argv not in ([], ["--split-only"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k12_k13_variants: CUDA is not available", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    dev = torch.device("cuda")
    cs.print_versions()
    cs.build()
    a = inputs(dev)
    print(f"k12_k13_variants: {ROOT} at {a['lk'].shape[0]} probe x "
          f"{a['words'].shape[0]} build rows; skew build "
          f"{a['sw'].shape[0]}; K13 tables "
          f"{[c.table.shape[0] for c in a['cols']]}")
    split(a)
    if not argv:
        variants(a)
    print(cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
