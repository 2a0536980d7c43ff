"""Phase G's traffic and the slot and region-states kernels of two
checkouts of this repository, timed in turns on one card.

    python3 compare_trees.py OLD_ROOT [NEW_ROOT]

NEW_ROOT defaults to this file's checkout. The two run in the order OLD,
NEW, NEW, OLD, each in a process of its own started in its checkout's root
and importing that checkout's chip_smoke, tidb_tpu_torch and kernels
(each builds its kernels into its own build/ directory). A run measures,
with the helpers both checkouts' chip_smoke.py share:

- Phase G's traffic (chip_smoke.g_traffic: 64 sessions x 25 statements of
  tpch.G_SHAPES over SF1's supplier table through one GpuClient), once
  with the micro-batch tier on and once off: statements/s, p50 and p99
  latency (host clock);
- K14 and K15 at the tier's shape (32 statements of g_nation and of g_agg
  over the supplier batch), and K14 with its words read back as that
  checkout's tier reads them (kernels.to_host where it has one, else
  Tensor.cpu()): median of 20 CUDA-event runs of the wrapper, as
  chip_smoke.cuda_ms;
- K16 (kernels.slot_topn over K14's words: median of 20 CUDA-event runs)
  at the tier's shape (32 statements of g_topn over the supplier batch)
  and at the stress shape (32 TopN statements over SF1's lineitem, as
  chip_smoke's Phase G), with a digest of the rows;
- K6 (kernels.k6_prepare's launch, median of 20 CUDA-event runs, and the
  route it took) at q1full over 8 regions at SF1 and at SF0.01, at
  plain_q1 over 8 shards of one card (the mesh tier's near-data rung), and
  at d_supplier over 8 regions at SF1 (with the statement's time, median
  of 3 on the host clock), with a digest of the states, which must be
  equal in every run.

Each run prints one JSON line after "RESULT"; this script prints them,
each metric's median per checkout, and the card's name and power limit.
It needs one card and imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ORDER = ("old", "new", "new", "old")


def child(root: str) -> dict:
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.cluster.store import DistStore
    from tidb_tpu_torch.copr.plane_cache import PlaneCache
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.ops import _ext, kernels
    from tidb_tpu_torch.ops import mesh as mesh_mod
    from tidb_tpu_torch.ops.client import GpuClient
    from tidb_tpu_torch.parallel import CoprMesh

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _ext.build_all()
    out = {"build_s": time.perf_counter() - t0}

    # Phase G's traffic, tier on and off, and K14 / K15 at its shape
    data, words = tpch.supplier(tpch.SF1_SUPPLIERS, 9)
    store = MemStore.from_pairs(tpch.supplier_pairs(data, words))
    rng = np.random.default_rng(9)
    work = [[tpch.G_SHAPES[(t + i) % len(tpch.G_SHAPES)]
             for i in range(cs.G_PER_THREAD)] for t in range(cs.G_THREADS)]
    work = [[(sh, tpch.g_literal(sh, rng)) for sh in w] for w in work]
    for mode, on in (("tier", True), ("solo", False)):
        rows, lat, wall, _c, _l = cs.g_traffic(store, (data, words), work,
                                               on, dev)
        for t, w in enumerate(work):
            for i, (shape, lit) in enumerate(w):
                cs.same_g(rows[(t, i)], tpch.g_expected(shape, lit, data,
                                                        words), mode)
        out[f"g_{mode}_stmts_per_s"] = len(lat) / wall
        out[f"g_{mode}_p50_ms"] = float(np.percentile(lat, 50))
        out[f"g_{mode}_p99_ms"] = float(np.percentile(lat, 99))
    client = GpuClient(store, dev)
    for shape in tpch.G_SHAPES:
        client.send(tpch.g_statement(shape, 0)).next()
    for kname, shape in (("slot_filter", "g_nation"), ("slot_agg", "g_agg")):
        reqs = [tpch.g_statement(shape, x % 25) for x in range(32)]
        batch = client._get_batch(reqs[0].data, reqs[0].key_ranges)
        a = cs.slot_inputs(batch, [r.data for r in reqs], dev)
        args = (a["fin"], a["pools"], a["plane_list"], a["live"])
        if kname == "slot_filter":
            # the words read back as each checkout's tier reads them
            back = getattr(kernels, "to_host", lambda t: t.cpu())
            out["k14_ms"] = cs.cuda_ms(lambda: kernels.slot_filter(*args))
            out["k14_readback_ms"] = cs.cuda_ms(
                lambda: back(kernels.slot_filter(*args)))
        else:
            out["k15_ms"] = cs.cuda_ms(
                lambda: kernels.slot_agg(*args, a["reds"]))

    # K16 at the tier's shape and at the stress shape
    def k16_time(key: str, a: dict) -> None:
        words = kernels.slot_filter(a["fin"], a["pools"], a["plane_list"],
                                    a["live"])
        idx, n_live = kernels.slot_topn(words, a["keys"], a["k"])
        out[f"{key}_digest"] = hashlib.sha1(
            idx.cpu().numpy().tobytes() + n_live.cpu().numpy().tobytes()
        ).hexdigest()[:16]
        out[f"{key}_ms"] = cs.cuda_ms(
            lambda: kernels.slot_topn(words, a["keys"], a["k"]))

    reqs = [tpch.g_statement("g_topn", x % 25) for x in range(32)]
    batch = client._get_batch(reqs[0].data, reqs[0].key_ranges)
    k16_time("k16_tier", cs.slot_inputs(batch, [r.data for r in reqs], dev))
    line = tpch.generate(tpch.SF1_ROWS, 2)
    lbatch = tpch.batch(line, [tpch.C_ORDERKEY, tpch.C_QUANTITY,
                               tpch.C_EXTENDEDPRICE, tpch.C_SHIPDATE])
    k16_time("k16_stress", cs.slot_inputs(lbatch, stress_statements(), dev))
    del line, lbatch

    # K6 at q1full over 8 regions (SF1 and SF0.01) and plain_q1 over 8
    # shards of the card
    def k6_time(key: str, k6: tuple) -> None:
        before = dict(kernels.LAUNCHES)
        got = kernels.seg_states_ragged(*k6)
        torch.cuda.synchronize()
        out[f"{key}_route"] = [k for k, v in kernels.LAUNCHES.items()
                               if v != before[k]]
        out[f"{key}_digest"] = hashlib.sha1(
            got.cpu().numpy().tobytes()).hexdigest()[:16]
        out[f"{key}_ms"] = cs.cuda_ms(kernels.k6_prepare(*k6)[0])

    q1full = tpch.sweep_request("q1full")
    stores = {}
    for key, n_rows in (("k6_q1full_sf1", tpch.SF1_ROWS),
                        ("k6_q1full_sf001", tpch.SF001_ROWS)):
        d = tpch.generate(n_rows, 2)
        st = stores[key] = DistStore([], tpch.split_keys(n_rows, 8), dev,
                                     plane_cache=PlaneCache(device=dev))
        cs.admit(st, q1full, tpch.region_batches(d, cs.D_CIDS, 8))
        k6_time(key, cs.capture(st, q1full, dev)[1])
    # plain_q1 reads q1full's columns: the SF1 store's batches serve it
    st = stores["k6_q1full_sf1"]
    hits = st.plane_cache.stats["hits"]
    captured = []
    orig = kernels.seg_states_ragged

    def spy(*a):
        captured.append(a)
        return orig(*a)

    kernels.seg_states_ragged = spy
    mesh_mod.set_mesh(CoprMesh([dev] * 8))
    try:
        cs.final_rows(st, cs.j_plain_q1())
    finally:
        kernels.seg_states_ragged = orig
        mesh_mod.set_mesh(None)
    cs.need(st.plane_cache.stats["hits"] - hits == 8 and len(captured) == 1,
            "plain_q1 missed the plane cache or its K6")
    k6_time("k6_plain_q1_8shards", captured[0])

    # d_supplier over 8 regions at SF1: K6 and the statement
    d = tpch.generate(tpch.SF1_ROWS, 2)
    st = DistStore([], tpch.split_keys(tpch.SF1_ROWS, 8), dev,
                   plane_cache=PlaneCache(device=dev))
    sup = cs.d_supplier()
    cs.admit(st, sup, tpch.region_batches(d, cs.D_SUPPLIER_CIDS, 8))
    cs.final_rows(st, sup)
    out["d_supplier_stmt_ms"] = cs.host_ms(lambda: cs.final_rows(st, sup), 3)
    k6_time("k6_d_supplier", cs.capture(st, sup, dev)[1])
    return out


def stress_statements() -> list:
    """chip_smoke Phase G's stress statements: 32 filters of SF1's
    lineitem with three aggregates and ORDER BY l_extendedprice desc,
    l_orderkey limit 100."""
    from decimal import Decimal

    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.copr.proto import (ByItem, SelectRequest, expr_agg,
                                           expr_column, expr_op, expr_value)
    from tidb_tpu_torch.sqlast.opcode import Op
    from tidb_tpu_torch.types.datum import Datum
    c = expr_column
    ti = tpch.table_info([tpch.C_ORDERKEY, tpch.C_QUANTITY,
                          tpch.C_EXTENDEDPRICE, tpch.C_SHIPDATE])
    one = expr_value(Datum.i64(1))
    out = []
    for j in range(32):
        where = expr_op(Op.AndAnd, expr_op(
            Op.LT, c(tpch.C_QUANTITY), expr_value(Datum.dec(Decimal(
                10 + j)))), expr_op(Op.LE, c(tpch.C_SHIPDATE), expr_value(
                    tpch._date(f"199{2 + j % 7}-0{1 + j % 9}-15"))))
        out.append(SelectRequest(
            start_ts=1, table_info=ti, where=where,
            aggregates=[expr_agg("count", [one]),
                        expr_agg("sum", [c(tpch.C_QUANTITY)]),
                        expr_agg("max", [c(tpch.C_EXTENDEDPRICE)])],
            order_by=[ByItem(c(tpch.C_EXTENDEDPRICE), True),
                      ByItem(c(tpch.C_ORDERKEY), False)], limit=100))
    return out


def main(argv: list) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print("RESULT " + json.dumps(child(argv[1])), flush=True)
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("compare_trees: CUDA is not available", file=sys.stderr)
        return 2
    roots = {"old": os.path.abspath(argv[0]),
             "new": os.path.abspath(argv[1] if len(argv) > 1
                                    else os.path.dirname(__file__))}
    runs = {"old": [], "new": []}
    for which in ORDER:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", roots[which]], cwd=roots[which],
                           capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(p.stdout[-4000:] + p.stderr[-4000:], file=sys.stderr)
            print(f"compare_trees: the {which} run failed", file=sys.stderr)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        runs[which].append(res)
        print(f"{which}: {json.dumps(res)}", flush=True)
    digests = {k: {r[k] for w in runs for r in runs[w]}
               for k in runs["new"][0] if k.endswith("_digest")}
    bad = [k for k, v in digests.items() if len(v) != 1]
    if bad:
        print(f"compare_trees: the states differ between runs: {bad}",
              file=sys.stderr)
        return 1
    for k in runs["new"][0]:
        if isinstance(runs["new"][0][k], float):
            print(f"{k}: old {statistics.median(r[k] for r in runs['old'])}"
                  f" new {statistics.median(r[k] for r in runs['new'])}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
