"""Phase G's traffic, the slot, window, region-states, rank, partition,
region-filter and delta-merge kernels of two checkouts of this
repository, timed in turns on one card.

    python3 compare_trees.py OLD_ROOT [NEW_ROOT] [--only PART,PART...]

NEW_ROOT defaults to this file's checkout. The two run in the order OLD,
NEW, NEW, OLD, each in a process of its own started in its checkout's root
and importing that checkout's chip_smoke, tidb_tpu_torch and kernels
(each builds its kernels into its own build/ directory). A run measures,
with the helpers both checkouts' chip_smoke.py share, the parts below (all
of them, or those --only names: g, stress, k18, k8, k21, k6, k5, k19,
k1k3, k12k13):

- g: Phase G's traffic (chip_smoke.g_traffic: 64 sessions x 25 statements of
  tpch.G_SHAPES over SF1's supplier table through one GpuClient), once
  with the micro-batch tier on and once off: statements/s, p50 and p99
  latency (host clock);
- K14 and K15 at the tier's shape (32 statements of g_nation and of g_agg
  over the supplier batch), and K14 with its words read back as that
  checkout's tier reads them (kernels.to_host where it has one, else
  Tensor.cpu()): median of 20 CUDA-event runs of the wrapper, as
  chip_smoke.cuda_ms;
- K16 (kernels.slot_topn over K14's words: median of 20 CUDA-event runs)
  at the tier's shape (32 statements of g_topn over the supplier batch);
- stress: K16 at the stress shape (32 TopN statements over SF1's
  lineitem, as chip_smoke's Phase G), with a digest of the rows, and K15
  (kernels.slot_agg, median of 5 CUDA-event runs) there (32 statements
  with three aggregates), with a digest of the states;
- k18: K18 (kernels.window_scan, median of 20 CUDA-event runs) at SF1 as
  chip_smoke's Phase H calls it (lineitem in (l_orderkey, l_linenumber)
  order, each order a partition and each line a peer group): SUM + COUNT
  of l_quantity, and the seven figures ROW_NUMBER, RANK, DENSE_RANK, SUM,
  COUNT, MIN, MAX, with a digest of the figures;
- k8: K8 (median of 20 CUDA-event runs) over Phase E's ranked_dates and
  tuple_dates inputs (SF1's lineitem at the batch's 8,388,608 positions,
  sorted by the checkout's prepare): one K8 at the top rung (262,145
  segments; since slice 18 its rank and output passes), and the K8 work
  of each statement (before slice 18 one K8 a rung tried: three for
  either; since, one rank pass and, for ranked_dates, one output pass),
  with a digest of the ids at the top rung and the group count;
- k21: K21 (kernels.key_partition, median of 20 CUDA-event runs) at
  lineitem's 6,001,215 l_orderkey and orders' 1,500,216 o_orderkey with
  P 8, with a digest of the layout;
- k6: K6 (kernels.k6_prepare's launch, median of 20 CUDA-event runs, and the
  route it took) at q1full over 8 regions at SF1 and at SF0.01, at
  plain_q1 over 8 shards of one card (the mesh tier's near-data rung), and
  at d_supplier over 8 regions at SF1 (with the statement's time, median
  of 3 on the host clock), with a digest of the states, which must be
  equal in every run;
- k5: K5 (kernels.k5_prepare's launch and the expr_vm_ragged wrapper,
  medians of 20 CUDA-event runs) at q1full over 8 regions at SF1, and the
  `k5` phase of q1full's statement there (kernels.SPLIT, median of 5),
  with a digest of the survivor bits and the argument planes (values
  where valid);
- k19: Phase I.2 on a store of those regions (chip_smoke.phase_i2: two
  RF1 + RF2 pairs, q1full after each), each pair's `k19` and `k5` phases
  and its merge statement (host clock), a digest of every merge order;
  then K19 at the last pair's region_8 and tombstones_only merges (the
  most and the fewest appended rows): the launch as the merge path makes
  it (with the merged handle plane where the checkout writes one), and
  the merge path's k19 phase as that checkout runs it, with its parts:
  the wrapper (launch and meta read), the merged plane (I64_MIN fill,
  then the parent's cat and gather), the order's readback (the parent's
  Tensor.cpu(), else kernels.to_host).

- k1k3: K1 (kernels.expr_vm) and K3 (kernels.seg_agg_onehot) at TPC-H
  Q1 over SF1's lineitem at the batch's 8,388,608 rows, as chip_smoke's
  Phase B calls them (medians of 20 CUDA-event runs; K1 on a new
  Finalized of the same program each call, as GpuClient.serve makes one
  a statement), with digests of K1's mask, group id and argument planes
  (values where valid) and of K3's counts and integer states (its f64
  states, none at Q1, as values held within 1e-12 relative across the
  runs); K4's block route
  (kernels._k4_block) at the same inputs; Phase B's "Q1 device time"
  (K1 + K3 + readback: the request fn), GpuClient.serve of Q1 (median of
  10) and the build_filter_fn row (K1's mask of Q6's WHERE, then
  torch.nonzero).

- k12k13: K12 (kernels.join_probe, median of 20 CUDA-event runs of the
  wrapper) at Phase F's full shape (lineitem's 6,001,215 l_orderkey
  against orders' 1,500,216 words), the same over the 8,388,608-row
  capacity in 8 shards, the segmented mode over K21's layouts at P 8
  (kernels.join_probe_partitioned), and the skew case (2^20 more build
  rows of one order key); K13 (kernels.dict_remap) at f2's lineitem side
  (l_partkey and l_suppkey in domain mode); the inputs are
  k12_k13_variants.inputs (this script's checkout's file, over the
  measured checkout's modules), with digests of the pairs and totals and
  of the key and valid planes.

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
PARTS = ("g", "stress", "k18", "k8", "k21", "k6", "k5", "k19", "k1k3",
         "k12k13")


def child(root: str, parts: set) -> dict:
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
    from tidb_tpu_torch.ops.exprc import Program
    from tidb_tpu_torch.parallel import CoprMesh

    def want(part: str) -> bool:
        return not parts or part in parts

    def digest(*ts) -> str:
        return hashlib.sha1(b"".join(t.cpu().numpy().tobytes()
                                     for t in ts)).hexdigest()[:16]

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _ext.build_all()
    out = {"build_s": time.perf_counter() - t0}

    # Phase G's traffic, tier on and off, and K14 / K15 / K16 at its shape
    def k16_time(key: str, a: dict) -> None:
        words = kernels.slot_filter(a["fin"], a["pools"], a["plane_list"],
                                    a["live"])
        idx, n_live = kernels.slot_topn(words, a["keys"], a["k"])
        out[f"{key}_digest"] = digest(idx, n_live)
        out[f"{key}_ms"] = cs.cuda_ms(
            lambda: kernels.slot_topn(words, a["keys"], a["k"]))

    if want("g"):
        data, words = tpch.supplier(tpch.SF1_SUPPLIERS, 9)
        store = MemStore.from_pairs(tpch.supplier_pairs(data, words))
        rng = np.random.default_rng(9)
        work = [[tpch.G_SHAPES[(t + i) % len(tpch.G_SHAPES)]
                 for i in range(cs.G_PER_THREAD)]
                for t in range(cs.G_THREADS)]
        work = [[(sh, tpch.g_literal(sh, rng)) for sh in w] for w in work]
        for mode, on in (("tier", True), ("solo", False)):
            rows, lat, wall, _c, _l = cs.g_traffic(store, (data, words),
                                                   work, on, dev)
            for t, w in enumerate(work):
                for i, (shape, lit) in enumerate(w):
                    cs.same_g(rows[(t, i)], tpch.g_expected(
                        shape, lit, data, words), mode)
            out[f"g_{mode}_stmts_per_s"] = len(lat) / wall
            out[f"g_{mode}_p50_ms"] = float(np.percentile(lat, 50))
            out[f"g_{mode}_p99_ms"] = float(np.percentile(lat, 99))
        client = GpuClient(store, dev)
        for shape in tpch.G_SHAPES:
            client.send(tpch.g_statement(shape, 0)).next()
        for kname, shape in (("slot_filter", "g_nation"),
                             ("slot_agg", "g_agg")):
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
        reqs = [tpch.g_statement("g_topn", x % 25) for x in range(32)]
        batch = client._get_batch(reqs[0].data, reqs[0].key_ranges)
        k16_time("k16_tier", cs.slot_inputs(batch, [r.data for r in reqs],
                                            dev))

    line = tpch.generate(tpch.SF1_ROWS, 2) \
        if any(want(p) for p in ("stress", "k18", "k8", "k21", "k1k3")) \
        else None

    if want("k1k3"):
        k1k3(out, line, digest, dev)

    # K16 and K15 at the stress shape
    if want("stress"):
        lbatch = tpch.batch(line, [tpch.C_ORDERKEY, tpch.C_QUANTITY,
                                   tpch.C_EXTENDEDPRICE, tpch.C_SHIPDATE])
        sa = cs.slot_inputs(lbatch, stress_statements(), dev)
        k16_time("k16_stress", sa)
        sargs = (sa["fin"], sa["pools"], sa["plane_list"], sa["live"])
        n15, acc15 = kernels.slot_agg(*sargs, sa["reds"])
        out["k15_stress_digest"] = digest(n15, acc15)
        out["k15_stress_ms"] = cs.cuda_ms(
            lambda: kernels.slot_agg(*sargs, sa["reds"]), runs=5)
        del lbatch, sa, sargs

    # K18 at SF1: SUM + COUNT and the seven figures
    if want("k18"):
        order = np.lexsort((line[tpch.C_LINENUMBER], line[tpch.C_ORDERKEY]))
        okey = line[tpch.C_ORDERKEY][order]
        n = len(order)
        dseg = torch.from_numpy(np.cumsum(np.r_[False, okey[1:] != okey[:-1]])
                                .astype(np.int64)).to(dev)
        dpeer = torch.arange(n, dtype=torch.int64, device=dev)
        dq = torch.from_numpy(np.ascontiguousarray(
            line[tpch.C_QUANTITY][order])).to(dev)
        dok = torch.ones(n, dtype=torch.bool, device=dev)
        for key, specs in (
                ("k18_sum_count", [("sum", dq, dok), ("count", None, dok)]),
                ("k18_seven", [("row_number", None, None),
                               ("rank", None, None),
                               ("dense_rank", None, None), ("sum", dq, dok),
                               ("count", None, dok), ("min", dq, dok),
                               ("max", dq, dok)])):
            figs = kernels.window_scan(dseg, dpeer, specs, n)
            out[f"{key}_digest"] = digest(*figs)
            out[f"{key}_ms"] = cs.cuda_ms(
                lambda: kernels.window_scan(dseg, dpeer, specs, n))
        del dseg, dpeer, dq, dok

    # K8 over Phase E's ranked inputs: one K8 at the top rung, and each
    # statement's K8 work (the checkout's own: the rank and output passes,
    # or one K8 a rung tried)
    if want("k8"):
        kb = tpch.batch(line, [tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
                               tpch.C_SHIPDATE, tpch.C_COMMITDATE,
                               tpch.C_RECEIPTDATE])
        kplanes = kernels.batch_planes(kb, dev)
        klive = kernels.device_live(kb, dev)
        caps = GpuClient._RANK_CAPS
        split = hasattr(kernels, "rank_groups_rank")
        for name, make in tpch.SLICE3[:2]:
            sel = make()
            prog = Program(kb)
            fn = kernels.build_ranked_group_fn(
                prog, None, kernels.lower_aggregates(sel, kb, prog),
                kernels.lower_group_by(sel, kb).cids)
            p = fn.prepare(kplanes, klive)
            args = (p.order, p.mask, p.cols)
            if split:
                # the sort's dead flags in sorted order, as the prepare
                # hands them to the rank pass
                args = (p.order, (~p.mask).to(torch.uint8).index_select(
                    0, p.order), p.cols)
                def top(args=args):
                    rp = kernels.rank_groups_rank(*args)
                    return kernels.rank_groups_out(rp, caps[-1]), rp.ngroups

                def stmt(args=args, ranked=name == "ranked_dates"):
                    rp = kernels.rank_groups_rank(*args)
                    if ranked:
                        kernels.rank_groups_out(rp, caps[-1])
            else:
                def top(args=args):
                    res = kernels.rank_groups(*args, caps[-1])
                    return res[:1] + res[2:], res[1]

                def stmt(args=args):
                    for S in caps:
                        kernels.rank_groups(*args, S)
            ids, ngroups = top()
            out[f"k8_{name}_digest"] = digest(ids[0], ngroups)
            out[f"k8_{name}_top_ms"] = cs.cuda_ms(top)
            out[f"k8_{name}_stmt_ms"] = cs.cuda_ms(stmt)
        del kb, kplanes, klive, p, args

    # K21 at lineitem's and orders' join keys with P 8
    if want("k21"):
        for what, keys in (("lineitem", line[tpch.C_ORDERKEY]),
                           ("orders", tpch.orders(line, 2)[tpch.O_ORDERKEY])):
            k_ = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
            v_ = torch.ones(k_.shape[0], dtype=torch.bool, device=dev)
            out[f"k21_{what}_digest"] = digest(*kernels.key_partition(k_, v_,
                                                                      8))
            out[f"k21_{what}_ms"] = cs.cuda_ms(
                lambda: kernels.key_partition(k_, v_, 8))
    del line

    # K12 (one pass, sharded, segmented, skewed) and K13 at f2's lineitem
    # side, Phase F's shapes (k12_k13_variants.inputs, this script's
    # checkout's, over the measured checkout's modules)
    if want("k12k13"):
        import k12_k13_variants as kv
        a = kv.inputs(dev)
        for name, fn in kv.calls(a).items():
            got = fn()
            planes = got if name == "k13_f2" else (
                got[0].to(torch.int64), torch.from_numpy(np.asarray(got[1])))
            out[f"{name}_digest"] = digest(*planes)
            out[f"{name}_ms"] = cs.cuda_ms(fn)
        del a

    if want("k5") or want("k19"):
        k5_k19(out, want, digest, dev)
    if not want("k6"):
        return out

    # K6 at q1full over 8 regions (SF1 and SF0.01) and plain_q1 over 8
    # shards of the card
    def k6_time(key: str, k6: tuple) -> None:
        before = dict(kernels.LAUNCHES)
        got = kernels.seg_states_ragged(*k6)
        torch.cuda.synchronize()
        out[f"{key}_route"] = [k for k, v in kernels.LAUNCHES.items()
                               if v != before[k]]
        out[f"{key}_digest"] = digest(got)
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


def k5_k19(out: dict, want, digest, dev) -> None:
    """The k5 and k19 parts (see the docstring) into `out`."""
    import inspect

    import numpy as np
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.cluster.store import DistStore
    from tidb_tpu_torch.copr.plane_cache import PlaneCache
    from tidb_tpu_torch.ops import columnar as col, kernels

    q1full = tpch.sweep_request("q1full")
    data = tpch.generate(tpch.SF1_ROWS, 2)
    st = DistStore([], tpch.split_keys(tpch.SF1_ROWS, 8), dev,
                   plane_cache=PlaneCache(device=dev))
    cs.admit(st, q1full, tpch.region_batches(data, cs.D_CIDS, 8))
    cs.final_rows(st, q1full)
    if want("k5"):
        regions = cs.capture(st, q1full, dev)[0]
        bits, outs = kernels.expr_vm_ragged(regions, dev)
        out["k5_q1full_digest"] = digest(bits, *[t for v, ok in outs
                                                 for t in (v[ok], ok)])
        out["k5_q1full_ms"] = cs.cuda_ms(kernels.k5_prepare(regions, dev)[0])
        out["k5_q1full_wrapper_ms"] = cs.cuda_ms(
            lambda: kernels.expr_vm_ragged(regions, dev))
        split = []
        for _ in range(5):
            kernels.SPLIT = {}
            cs.final_rows(st, q1full)
            split.append(kernels.SPLIT["k5"])
            kernels.SPLIT = None
        out["k5_q1full_split_ms"] = float(np.median(split))
    if not want("k19"):
        return
    _l, calls, _e, stmts = cs.phase_i2(st, data, dev, 22)
    for p, s in enumerate(stmts):
        out[f"i2_pair{p + 1}_k19_ms"] = s["split"]["k19"]
        out[f"i2_pair{p + 1}_k5_ms"] = s["split"]["k5"]
        out[f"i2_pair{p + 1}_statement_ms"] = s["merge_statement_ms"]
    out["k19_orders_digest"] = digest(*[c[4] for c in calls])
    merged_arg = "merged" in inspect.signature(
        kernels.delta_merge_order).parameters
    to_host = getattr(kernels, "to_host", None)
    by_app = sorted(calls, key=lambda c: c[3].shape[0])
    for what, c in (("tombstones_only", by_app[0]), ("region_8", by_app[-1])):
        h, live, tomb, app = c[:4]
        cap = col.bucket_capacity(int(live.sum()) + app.shape[0])

        def fill():
            return torch.full((cap,), col.I64_MIN, dtype=torch.int64,
                              device=dev)

        if merged_arg:
            plane = fill()
            launch = kernels.delta_merge_prepare(h, live, tomb, app, plane)[0]

            def wrapper():
                return kernels.delta_merge_order(h, live, tomb, app, plane)

            def gather(order):
                return fill()

            def phase():
                m = fill()
                return to_host(kernels.delta_merge_order(h, live, tomb, app,
                                                          m))
        else:
            launch = kernels.delta_merge_prepare(h, live, tomb, app)[0]

            def wrapper():
                return kernels.delta_merge_order(h, live, tomb, app)

            def gather(order):
                m = fill()
                m[:order.shape[0]] = torch.cat([h, app])[order]
                return m

            def phase():
                order = wrapper()
                gather(order)
                return order.cpu()

        order = wrapper()
        readback = (lambda: to_host(order)) if merged_arg else order.cpu
        out[f"k19_{what}_ms"] = cs.cuda_ms(launch)
        out[f"k19_{what}_wrapper_ms"] = cs.cuda_ms(wrapper)
        out[f"k19_{what}_plane_ms"] = cs.cuda_ms(lambda: gather(order))
        out[f"k19_{what}_readback_ms"] = cs.cuda_ms(readback)
        out[f"k19_{what}_phase_ms"] = cs.cuda_ms(phase)


def k1k3(out: dict, line, digest, dev) -> None:
    """The k1k3 part (see the docstring) into `out`."""
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.ops import kernels
    from tidb_tpu_torch.ops.client import GpuClient
    from tidb_tpu_torch.ops.exprc import Finalized, Program, compile_expr

    batch = tpch.batch(line, [tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
                              tpch.C_DISCOUNT, tpch.C_TAX, tpch.C_RETURNFLAG,
                              tpch.C_LINESTATUS, tpch.C_SHIPDATE])
    q1 = cs.Request(tpch.q1(), batch, dev)
    mask, gid, vals = kernels.expr_vm(q1.fin, q1.plane_list, q1.live, True)
    out["k1_q1_digest"] = digest(mask, gid, *[t for v, ok in vals
                                              for t in (v[ok], ok)])
    fin = q1.fin
    # a new Finalized each call, as GpuClient.serve makes one a statement:
    # nothing a wrapper keeps on the program carries over between calls
    out["k1_q1_ms"] = cs.cuda_ms(lambda: kernels.expr_vm(
        Finalized(fin.meta, fin.pool, fin.lut, fin.plane_keys, fin.out_dts),
        q1.plane_list, q1.live, True))
    mask1, gid1, outs1 = q1.k1()
    reds = q1.reds(outs1)
    S = q1.segments
    n, acc = kernels.seg_agg_onehot(gid1, mask1, S, reds)
    f64 = [r for r, red in enumerate(reds) if red.op in kernels.F_OPS]
    ints = [r for r in range(len(reds)) if r not in f64]
    out["k3_q1_digest"] = digest(n, acc[ints])
    out["k3_q1_f64"] = acc[f64].view(torch.float64).flatten().tolist()
    out["k3_q1_ms"] = cs.cuda_ms(
        lambda: kernels.seg_agg_onehot(gid1, mask1, S, reds))
    out["k4_block_q1_ms"] = cs.cuda_ms(
        lambda: kernels._k4_block(gid1, mask1, S, reds))
    out["q1_device_ms"] = cs.cuda_ms(lambda: q1.fn(q1.planes, q1.live))
    client = GpuClient(MemStore([], []), dev)
    sel = tpch.q1()
    client.serve(sel, batch)
    out["q1_serve_ms"] = cs.cuda_ms(lambda: client.serve(sel, batch),
                                    runs=10)
    q6 = cs.Request(tpch.q6(), batch, dev)
    fprog = Program(batch)
    ffn = kernels.build_filter_fn(fprog, compile_expr(tpch.q6().where, batch,
                                                      fprog))
    out["filter_q6_digest"] = digest(torch.nonzero(ffn(q6.planes,
                                                       q6.live)[0]))
    out["filter_q6_ms"] = cs.cuda_ms(
        lambda: torch.nonzero(ffn(q6.planes, q6.live)[0]))


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
    parts = set()
    if "--only" in argv:
        i = argv.index("--only")
        parts = set(argv[i + 1].split(",")) if i + 1 < len(argv) else {""}
        argv = argv[:i] + argv[i + 2:]
    if len(argv) >= 2 and argv[0] == "--child":
        print("RESULT " + json.dumps(child(argv[1], parts)), flush=True)
        return 0
    if not 1 <= len(argv) <= 2 or not parts <= set(PARTS):
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
        only = ["--only", ",".join(sorted(parts))] if parts else []
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", roots[which]] + only,
                           cwd=roots[which], capture_output=True, text=True)
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
    # f64 states: equal within 1e-12 of their magnitudes across the runs
    for k in runs["new"][0]:
        if not k.endswith("_f64"):
            continue
        ref = runs["new"][0][k]
        for r in runs["old"] + runs["new"]:
            if len(r[k]) != len(ref) or any(
                    abs(a - b) > 1e-12 * max(abs(a), abs(b))
                    for a, b in zip(r[k], ref)):
                print(f"compare_trees: the f64 states {k} differ between "
                      f"runs", file=sys.stderr)
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
