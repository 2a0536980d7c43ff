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
   K2 (redesigned in slice 11: one pass, descriptors by value) also on
   planes that start at odd row offsets (views p[1:], p[3:], a mask in
   another 16-byte phase than its planes), n of 1, 15, 17, 4099 and
   2^20 + 333, 70 reductions (two launches of at most K2_MAX_REDS), every
   op with constant and never arguments, no mask row; every K2 check
   run twice, the f64 sums bit-identical. K4 (redesigned in slice 13:
   kernels.k4_route) at l_suppkey on its segment windows (K6's block
   route over one region, route and windows printed), on edge reductions
   over 65, 3,001 and 20,011 segments and over 2^20 segments (its sorted
   route, the ids sorted by the radix of radix.cuh), each with exactly its
   route's launches and run twice for the same bits; then the windows
   against the sorted route at l_suppkey's reductions over more segments
   (the measurement behind kernels.K4_MAX_WINDOWS).
4. Phase C, the cluster path at SF0.01 through KV: the same rows in a
   DistStore split at handle boundaries into 1, 2 and 8 regions; the six
   shapes of the JAX package's TPC-H sweep (tpch.SWEEP) through
   distsql.select(...).columnar() and fused_agg.final_states on the card,
   each held exactly against the same store with device="cpu" (sharing
   its plane cache) and against numpy. Launch counts are reset before
   and read after each statement: K5 and K6 once each (K6 on one of its
   routes; every sweep shape's spans fit shared memory at SF0.01), K7
   once over more than one region.
5. Phase D, the cluster path at SF1 over 8 regions: region batches built
   straight from the seed, admitted pinned into the plane cache under
   the key the region handler computes; the six shapes through the store
   (a cache hit in every region), each against numpy; the statement time
   (median of 10) and its split by phase; d_supplier (10,000 suppliers:
   K6's segment windows) and d_part (190,000 parts: K6's sorted route)
   through a store of the same regions, launches reset before and read
   after, against numpy; K5, K6 and K7 against their plain versions on
   the card at Q1's shapes and on edge cases (NULL predicates, live rows
   not a multiple of 32, regions with no survivor and G_r = 0, R = 64,
   spans above K6's shared-memory limit). K6 on each of its three routes,
   read from its launch counts: Q1's spans and date_group's (4,096
   segments a region) on the block route (copies of the span a block in
   the opt-in shared memory; small spans with copies of the integer
   states at two blocks an SM), d_supplier's (16,384 at 8 reductions) on
   segment windows of it, d_part's and shapes past the windows' cap or
   past 32 reductions on the radix and the sorted pass; every shape and
   edge states (-0.0 beside +0.0, +-inf-only groups, int64 extremes with
   wrapping sums, f64 sums, an empty region, a hot segment, regions at odd
   offsets) run twice for the same bits and held to its plain version on
   the CPU (f64 sums to 1e-12 of the magnitudes); each main shape timed
   beside one index_add_, and Q1 over Phase C's SF0.01 regions too.
6. Phase E, slice 3 on Phase B's SF1 batch (its planes resident): the
   statements of tpch.SLICE3 through GpuClient.serve, each against numpy
   (counts, decimals and row ids exact) with its launches counted — a
   ranked group-by of 75k groups that answers at the top rung of the rank
   ladder (and, repeated, starts there), one of 430k groups that
   overflows the ladder into host tuple codes, scalar and grouped
   DISTINCT, and TopN over one key and over three (k = 100 and 5000);
   their times (median of 10, host clock; the two group-by shapes one
   run, their repeat) and splits by phase; K8, K9 and K10 against their
   plain versions on the card at those shapes and on edge cases (NULL
   keys beside filtered rows, int64 extremes under DESC, BIGINT keys
   above 2^53 in both orders, -0.0 beside +0.0, no live row, k = 1 and
   k above the live rows, lengths no multiple of a tile), bit for bit.
   K10 (redesigned in slice 11: a threshold filter over composite keys in
   registers and shared memory, launches by kernels.topk_plan, counted
   per statement) also at 2^22 + 13 rows: all keys equal (the first k
   live rows), the k-th first key shared across blocks, a key sorted in
   and one against the wanted order (both timed), k 5000, k at and above
   the live rows. The ranked and DISTINCT sorts are K17 (redesigned in
   slice 14: kernels.sort_plan's composite words on radix.cuh), each
   statement's K17 calls and radix passes exactly those its planes plan
   (the plan recomputed on the host from the planes of each first run);
   K9 in both modes (sorted words where one composite word holds the
   planes, else the gather) on every case; the sort split of ranked_dates'
   and count(distinct l_orderkey)'s keys by K17 and by the chained
   torch.sort the path ran before, with K17's plan printed; K9's two
   modes timed at count(distinct l_orderkey) (rows near their sorted
   order) and at count(distinct l_suppkey) (the gather mode's reads
   random).
7. Phase F, joins at SF1 on Phase B's lineitem batch (its planes
   resident) and orders (one row per order of that lineitem, about 1.5M
   rows), partsupp (800,000) and a 4-row priority table built straight
   into batches: three statements through XSelectTableExec →
   HashJoinExec → HashAggExec (fused_agg.try_fused_agg) on the card —
   lineitem ⋈ orders on TPC-H Q3's key and dates grouped by
   o_orderpriority (K1 x2, K11, K12), lineitem ⋈ partsupp on Q9's key
   pair (K1 x2, K13 x2 in domain mode, K11, K12), orders LEFT JOIN prio on
   a string key (K1 x2, K13 x2 in remap mode, K11, K12) — each equal to
   numpy (counts and integers exact, f64 sums 1e-9 relative, groups in
   first-appearance order), its pairs equal to the plain versions' on
   the CPU, its launches exactly those; the statement time (host clock,
   median of 3) and its split by phase; K11, K12 and K13 against their
   plain versions on the card at the full shapes (6,001,215 probe rows x
   about 1.5M build rows; f2's composite keys) and on edge cases (I64_MAX
   and I64_MIN keys beside NULLs, +-inf, -0.0 against +0.0, NULLs on both
   sides, empty sides, 8 x 3000 duplicates, one key with 2^20 matches,
   f64 keys; every K13 mode), bit for bit. K11 (redesigned in slice 13:
   one readback of its summary, then a radix pass per varying digit,
   kernels.radix_plan) on f1's build (in key order: no pass), the same
   keys under a seeded permutation and f2's
   K13 codes, each equal to its plain version twice, its passes and time
   printed beside torch.sort(stable=True) of the same words; each
   statement's radix passes are those its build side's planes plan.
8. Phase G, the micro-batch tier at SF1's supplier table (see phase_g).
9. Phase H, sort and windows on Phase B's SF1 lineitem (its planes
   resident): ORDER BY l_extendedprice DESC, l_orderkey through
   executors._plane_sort_keys and extsort.sort_order under the "auto"
   budget (one K17 launch) and under a budget whose pass target is a
   quarter of the sort's estimate (at least four partitioned passes),
   both equal to np.lexsort; lineitem ⋈ orders through TopNExec (TopN
   100) and a filtered join (l_quantity < 2, about 120k rows) through
   SortExec, rows equal to numpy; K18 at SF1 on the (l_orderkey,
   l_linenumber) order, seven figures equal to numpy; WindowExec over
   SF0.01 lineitem (seven calls partitioned by l_orderkey, ordered by
   l_linenumber) equal to numpy and to the plain versions, and once with
   its scan split into passes. K17 and K18 launch counts are reset before
   and read after that path; then each kernel against its plain version
   on the card at SF1 and on edge cases (NaN, +-inf, subnormals, -0.0
   beside +0.0, int64 extremes under ~, int8 NULL planes, all keys tied,
   n = 0, 1 and around the tile and the floor; one partition, one row a
   partition, empty frames, SUM wrapping), timed with CUDA events
   (median of 20) beside its bytes bound, K17 beside chained stable
   torch.sort. K17 (redesigned in slice 14) also on planes whose widths
   cross 64 bits, uint8 and bool flag planes, one-, two- and three-word
   plans and past its row limit (kernels._k17_split at a small limit),
   each equal to np.lexsort and its plain version and run twice for the
   same permutation, a one-word plan's sorted words equal to the plain
   pack's; the timed call's plan and its peak device memory beside 32 B
   a row, and K17's split (past its row limit) at a third of the ORDER
   BY's rows, equal to K17, with its peak memory.
10. Phase I, the HTAP freshness tier (slice 7), after Phase D. I.1, at
   SF0.01 through KV: 60,175 lineitem rows committed through
   DistStore.begin() ... commit() into 8 regions; the six sweep shapes
   cache every region; one RF1 and one RF2 (TPC-H §2.5, tpch.rf1 /
   rf2) commit; the shapes again, each equal to numpy on the refreshed
   arrays and to a store with its delta packs off (which re-packs), every
   plane-cache miss merged, each K19 call equal to its plain version, and
   a repeat an exact hit in every region. I.2, at SF1 on Phase D's store
   (region batches pinned, nothing in KV, so a re-pack would answer
   wrong): two RF1 + RF2 pairs (about 6,000 lineitems inserted into the
   last region and 6,000 deleted across all), q1full after each equal to
   numpy with every region merged, the folds counted, the merge
   statement's split and wall time beside a hit's. Then K19 against its
   plain version on edge cases (empty tombstones or appended rows, every
   row tombstoned, appended handles before, after, between and tied with
   the base's, padding, a base at the floor, past shared memory, a live
   mask that is no prefix) and on broken preconditions (each raises),
   and timed at the last region's shape and at a tombstones-only one
   (median of 20 CUDA-event runs of the launch alone) beside its bound,
   its plain version and a stable torch.argsort.
11. Phase J, the mesh tier (slice 8), after Phase D and before I:
   CoprMesh([cuda:0] * 8) over Phase B's batch (1,048,576 rows a shard):
   Q1, Q6, the supplier group-by and Q6's WHERE as a columnar scan
   through GpuClient(mesh=...), each equal to the client without a mesh
   (Q1 and the scan to numpy too); Phase E's TopN statements (K20) against
   numpy and the reference's three mesh TopN faults as the CPU engine's
   rows; Phase D's store with the process mesh set: the sweep and a
   plain-column Q1 equal to numpy and to the mesh-off run (two statements
   on the near-data rung: K6 over the shard layout; every combine on the
   shards); f1_q3_join through the sharded probe, its pairs equal to the
   single-device pairs. Launch counts are reset before and read after
   that path; then the statements' splits, K6 over the shard layout
   (plain_q1 and dec_group on the block route), the K7 fold (client
   partials and states combine), Q1's
   shard partials, K20 at SF1 and on edge cases and the sharded K12, each
   against its plain version and timed (median of 20 CUDA-event runs)
   beside its bound; K20's row in the kernels line is topn_price's shape
   (one key, k 10), beside torch.topk over the same masked f64 score
   viewed [8, L], and topn_multi's and topn_multi_5000's (three keys, k
   100 and 5000) are printed. K20 (redesigned in slice 12: K10's
   threshold filter within each shard) is launched per statement as
   kernels.shard_topk_launch_count says. K4 over Q1's 8 x 13 shard ids
   (one window) beside index_add_ of the same stacked reductions; K4 over
   by_supplier's 8 x 10,002 (past the cap: the sorted route, the main
   path's launches of it and of the radix) and the radix alone at those
   ids beside a stable torch.sort. Last,
   the default configuration that Phases C, D and I also drive: the
   process mesh of this one-card rig is one shard,
   whose near-data rung and combine are the batched K6 and the region
   combine; plain_q1 and dec_group checked on it and timed with the tier
   on and off.
12. Phase K, the out-of-core tier (slice 9), after J and before I, on
   Phase F's tables and Phase D's store: K.1 f1_q3_join and f2_partsupp
   through HashJoinExec at a budget under the resident planes' pins (the
   headroom 0, the pass target budget // 8: P >= 4), the grace-hash passes
   (K11 + K12 a partition; f2's K13 planes read back for them), rows
   equal to budget 0 and to numpy; K.2 membudget.join_match_pairs over
   Q3's key planes at SF1 (6,001,215 x 1,500,216) on CoprMesh([cuda:0] *
   8), the key-partitioned probe (K21 per side, K11 within partitions,
   the segmented K12, K17 for the merge), pairs equal to budget 0's; K.4
   date_group and q1full over Phase D's store with the headroom a quarter
   of the states estimate, the spilled states (argument planes cut by row
   on the card) equal to budget 0 and numpy; launch counts reset before
   K.1 and read after K.4; K.5 a DeviceOOM in f1's first pass (a hook of
   the phase) escalates, same rows; then K21 and the segmented K12
   against their plain versions at K.2's shapes and on edge cases (-0.0
   beside +0.0, NULL keys, one hot key, empty partitions, P = 1 and 1024,
   lengths no multiple of a tile, a build side with no valid row), K11
   within partitions at the orders side in key order and shuffled (its
   passes and time), timed
   (median of 20 CUDA-event runs) beside their bounds, K21 beside a stable
   torch.sort of the partition ids.
13. Phase L, the cluster joins (slice 10), after K and before I: Phase
   F's lineitem, orders and partsupp in 8 regions each (prio in one),
   admitted pinned into one DistStore; tpch.JOINS through XSelectTableExec
   over its DistCoprClient (one K1 per region, the answers stacked into a
   ColumnarPartialSet), HashJoinExec and HashAggExec, whose fused
   aggregate combines the regions' partial states three ways: on the
   default one-shard mesh (row 15f: one K6 span), on CoprMesh([cuda:0] *
   8) (row 15f: K6 over the shard layout, K7's shard fold) and with the
   mesh off (one K6 span, no fold); each run equal to numpy and to Phase
   F's in-process answer, its launches counted, its time (host clock,
   median of 3) and split; row 15f at f1_q3_join's 8-shard shape against
   its plain version bit for bit, timed (median of 20 CUDA-event runs)
   beside its bytes bound and a scatter_reduce_ yardstick; and the f64
   +-inf identity of K2, K3, K4, K6 (its two routes, the block route at
   both instantiations), K7, row 15c, row 15f and K15 against numpy.
14. A JSON line of per-kernel numbers, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Any failure raises: no phase catches its own failure.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from decimal import Decimal  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tidb_tpu_torch import carry, distsql, errors, mysqldef as my  # noqa
from tidb_tpu_torch import plan, tablecodec as tc, tpch  # noqa: E402
from tidb_tpu_torch.cluster.rpc import clip_ranges  # noqa: E402
from tidb_tpu_torch.cluster.store import DistStore  # noqa: E402
from tidb_tpu_torch.copr import columnar_region  # noqa: E402
from tidb_tpu_torch.copr.plane_cache import PlaneCache  # noqa: E402
from tidb_tpu_torch.copr import dictionary  # noqa: E402
from tidb_tpu_torch.executor import executors, fused_agg, window  # noqa
from tidb_tpu_torch.executor.distsql_exec import XSelectTableExec  # noqa
from tidb_tpu_torch.executor.executors import (  # noqa: E402
    HashAggExec, HashJoinExec)
from tidb_tpu_torch.copr.proto import (  # noqa: E402
    AGG_NAME, AGG_TYPE_BY_NAME, ByItem, Expr, ExprType, SelectRequest,
    expr_agg, expr_column, expr_op, expr_value, iter_response_rows)
from tidb_tpu_torch.kv.memstore import MemStore  # noqa: E402
from tidb_tpu_torch.ops import _ext, extsort, kernels, membudget  # noqa
from tidb_tpu_torch.ops import columnar as col  # noqa: E402
from tidb_tpu_torch.ops import mesh as mesh_mod  # noqa: E402
from tidb_tpu_torch.parallel import CoprMesh  # noqa: E402
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
    # K4's segment windows (seg_block.cuh, shared with K6's block route)
    "seg_agg_block": ("tidb_tpu_torch/ops/csrc/seg_agg_sorted.cu",
                      "tidb_tpu/ops/kernels.py:903"),
    "rank_groups": ("tidb_tpu_torch/ops/csrc/rank_groups.cu",
                    "tidb_tpu/ops/kernels.py:989"),
    "distinct_runs": ("tidb_tpu_torch/ops/csrc/distinct_runs.cu",
                      "tidb_tpu/ops/kernels.py:807"),
    "topk_select": ("tidb_tpu_torch/ops/csrc/topk_select.cu",
                    "tidb_tpu/ops/kernels.py:1980"),
    "expr_vm_ragged": ("tidb_tpu_torch/ops/csrc/expr_vm.cu",
                       "tidb_tpu/ops/kernels.py:1552"),
    # K6's block route: its row is q1full over 8 regions at SF1 (small
    # spans, copies of the integer states), then date_group's spans and
    # q1full over Phase C's SF0.01 regions
    "seg_states_ragged_smem": (
        "tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
        "tidb_tpu/ops/kernels.py:1356"),
    "seg_states_ragged_smem/date_group": (
        "tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
        "tidb_tpu/ops/kernels.py:1356"),
    "seg_states_ragged_smem/sf001": (
        "tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
        "tidb_tpu/ops/kernels.py:1356"),
    # K6's segment windows: d_supplier over 8 regions at SF1 (about 10,000
    # suppliers a region at 8 reductions); its sorted route past the
    # windows' cap: d_part (about 190,000 parts a region)
    "seg_states_ragged_window": (
        "tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
        "tidb_tpu/ops/kernels.py:1356"),
    "seg_states_ragged_sorted": (
        "tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
        "tidb_tpu/ops/kernels.py:1356"),
    "combine_partials": ("tidb_tpu_torch/ops/csrc/combine_partials.cu",
                         "tidb_tpu/ops/kernels.py:1082"),
    "join_build": ("tidb_tpu_torch/ops/csrc/join_build.cu",
                   "tidb_tpu/ops/kernels.py:1666"),
    # the stable radix of K11 and K4's sorted route, in place of the
    # reference's lexsort (and the port's former torch.sort)
    "radix_pass": ("tidb_tpu_torch/ops/csrc/radix.cuh",
                   "tidb_tpu/ops/kernels.py:1666"),
    "join_probe": ("tidb_tpu_torch/ops/csrc/join_probe.cu",
                   "tidb_tpu/ops/kernels.py:1688"),
    "dict_remap": ("tidb_tpu_torch/ops/csrc/dict_remap.cu",
                   "tidb_tpu/ops/kernels.py:1877"),
    "slot_filter": ("tidb_tpu_torch/ops/csrc/slot_filter.cu",
                    "tidb_tpu/ops/sched.py:1021"),
    "slot_agg": ("tidb_tpu_torch/ops/csrc/slot_agg.cu",
                 "tidb_tpu/ops/sched.py:439"),
    "slot_topn": ("tidb_tpu_torch/ops/csrc/slot_topn.cu",
                  "tidb_tpu/ops/sched.py:532"),
    "sort_perm": ("tidb_tpu_torch/ops/csrc/sort_perm.cu",
                  "tidb_tpu/ops/kernels.py:2126"),
    "window_scan": ("tidb_tpu_torch/ops/csrc/window_scan.cu",
                    "tidb_tpu/ops/kernels.py:2222"),
    "delta_merge_order": ("tidb_tpu_torch/ops/csrc/delta_merge.cu",
                          "tidb_tpu/ops/kernels.py:293"),
    "shard_topk": ("tidb_tpu_torch/ops/csrc/shard_topk.cu",
                   "tidb_tpu/ops/kernels.py:2005"),
    "key_partition": ("tidb_tpu_torch/ops/csrc/key_partition.cu",
                      "tidb_tpu/ops/mesh.py:756"),
    "join_probe_seg": ("tidb_tpu_torch/ops/csrc/join_probe.cu",
                       "tidb_tpu/ops/mesh.py:756"),
    # row 15f: K6 over the shard layout, then K7's shard fold
    "combine_rows_sharded": ("tidb_tpu_torch/ops/csrc/seg_states_ragged.cu",
                             "tidb_tpu/ops/mesh.py:290"),
}
# K6 has three routes, each counted (kernels.k6_route): span copies a
# block in the opt-in shared memory (seg_states_ragged_smem), segment
# windows of larger spans (seg_states_ragged_window) and, past the
# windows' cap, the radix sort and the sorted pass
# (seg_states_ragged_sorted)
K6_ROUTES = kernels.K6_ROUTES
CLUSTER_KERNELS = ("expr_vm_ragged",) + K6_ROUTES + ("combine_partials",)
# K4's sorted route and the radix that sorts its ids: the main path takes
# them past K4_MAX_WINDOWS windows (Phase J's by_supplier over 8 shards);
# Phase A's group-by fits its windows
K4_SORTED_KERNELS = ("seg_agg_sorted", "radix_pass")
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
            if "registers" in line or "spill" in line \
                    or "Function properties" in line:
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
            need(v > 0 or k in CLUSTER_KERNELS or k in SLICE3_KERNELS
                 or k in JOIN_KERNELS or k in SLOT_KERNELS
                 or k in SORT_KERNELS or k in DELTA_KERNELS
                 or k in MESH_KERNELS or k in OOC_KERNELS
                 or k in K4_SORTED_KERNELS,
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


def k2_edge_reds(iv, fv, ok, ok2) -> list:
    """Every K2 op over int64 (with extremes) and f64 planes, NULLs, a
    constant argument with and without a valid plane, a never argument and
    count(1)."""
    R = kernels.Red
    return [R(kernels.R_COUNT, iv, ok), R(kernels.R_SUM_I, iv, ok),
            R(kernels.R_SUM_F, fv, ok), R(kernels.R_MIN_I, iv, ok2),
            R(kernels.R_MAX_I, iv, ok), R(kernels.R_MIN_F, fv, ok2),
            R(kernels.R_MAX_F, fv, ok), R(kernels.R_FIRST),
            R(kernels.R_SUM_I, const_bits=7),
            R(kernels.R_SUM_I, const_bits=-3, valid=ok2),
            R(kernels.R_MAX_I, const_bits=3, never=True),
            R(kernels.R_COUNT, const_bits=1), R(kernels.R_SUM_F, fv),
            R(kernels.R_MIN_I, iv)]


def k2_repeat(mask, reds, what: str) -> None:
    """Two identical K2 calls give the same bits (f64 sums included)."""
    a_n, a_v = kernels.scalar_agg(mask, reds)
    b_n, b_v = kernels.scalar_agg(mask, reds)
    need(torch.equal(a_n, b_n) and torch.equal(a_v, b_v),
         f"{what}: two identical K2 calls differ")


def k2_edges(device, seed: int) -> float:
    """K2 against its plain version on planes that start at odd row offsets
    (views p[1:], p[3:], and a mask in another 16-byte phase than its
    planes), n of 1, 15, 17 and a length no multiple of a block's slice,
    more reductions than one launch's cap, every op; each case also run
    twice for the same bits."""
    rng = np.random.default_rng(seed)
    n = (1 << 20) + 333
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    iv = rng.integers(-1000, 1000, n)
    iv[rng.random(n) < 0.01] = col.I64_MAX
    iv[rng.random(n) < 0.01] = col.I64_MIN
    iv, fv = t(iv.astype(np.int64)), t(rng.standard_normal(n) * 1e3)
    ok, ok2 = t(rng.random(n) > 0.2), t(rng.random(n) > 0.6)
    mask = t(rng.random(n) < 0.6)
    cases = [(mask, k2_edge_reds(iv, fv, ok, ok2), f"{n} rows")]
    for off in (1, 3):
        cases.append((mask[off:], k2_edge_reds(iv[off:], fv[off:], ok[off:],
                                               ok2[off:]), f"views [{off}:]"))
    m = n - 8
    cases.append((mask[1:1 + m], k2_edge_reds(iv[3:3 + m], fv[3:3 + m],
                                              ok[5:5 + m], ok2[:m]),
                  "mask and planes in other phases"))
    for m in (1, 15, 17, 4099):
        for off in (0, 1):
            sl = slice(off, off + m)
            cases.append((mask[sl], k2_edge_reds(iv[sl], fv[sl], ok[sl],
                                                 ok2[sl]),
                          f"n {m} at offset {off}"))
    cases.append((mask, k2_edge_reds(iv, fv, ok, ok2) * 5,
                  f"{14 * 5} reductions (cap {kernels.K2_MAX_REDS})"))
    cases.append((torch.zeros_like(mask), k2_edge_reds(iv, fv, ok, ok2),
                  "no mask row"))
    err = 0.0
    for msk, reds, what in cases:
        before = kernels.LAUNCHES["scalar_agg"]
        err = max(err, check_reduce(kernels.scalar_agg,
                                    kernels.scalar_agg_plain, (msk,), reds,
                                    f"K2 edge {what}"))
        want = len(kernels.scalar_agg_chunks(len(reds)))
        need(device.type != "cuda"
             or kernels.LAUNCHES["scalar_agg"] - before == want,
             f"K2 edge {what}: not {want} launches")
        k2_repeat(msk, reds, f"K2 edge {what}")
    return err


def k4_route_of(reds: list, S: int, device) -> tuple:
    """K4's route for these reductions over S segments
    (kernels.k4_route under the card's limit; ("plain", 0, 0) off the
    card)."""
    if device.type != "cuda":
        return "plain", 0, 0
    slots, _map = kernels.k4_slots(reds)
    n_f = sum(s[0] in kernels.F_OPS for s in slots)
    return kernels.k4_route(len(reds), len(slots), n_f, S,
                            kernels._k4_block_limit(
                                _ext.lib("seg_agg_sorted"), device))


def k4_copies_of(reds: list, S: int, route: tuple, device) -> int:
    """The copies of the integer states K4's one window keeps
    (kernels.k4_copies), 1 on more windows or off the windows."""
    if device.type != "cuda" or route[0] != "seg_agg_block" or route[2] > 1:
        return 1
    slots, _map = kernels.k4_slots(reds)
    return kernels.k4_copies(
        len(slots), sum(s[0] in kernels.F_OPS for s in slots), S, route[1],
        kernels._k4_block_limit(_ext.lib("seg_agg_sorted"), device))


def k4_launches(route: tuple, S: int) -> dict:
    """The launches one K4 call on `route` makes."""
    if route[0] == "seg_agg_block":
        return {"seg_agg_block": 1}
    plan = kernels.radix_plan((1 << (S - 1).bit_length()) - 1, False)
    return {"seg_agg_sorted": 1, "radix_pass": len(plan)}


def check_k4(gid, mask, S: int, reds: list, what: str) -> float:
    """K4 against its plain version on the same tensors, with exactly the
    launches of its route, and run again for the same bits."""
    device = mask.device
    route = k4_route_of(reds, S, device)
    before = dict(kernels.LAUNCHES)
    err = check_reduce(kernels.seg_agg_sorted, kernels.seg_agg_plain,
                       (gid, mask, S), reds, what)
    launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                if v != before[k]}
    need(device.type != "cuda" or launched == k4_launches(route, S),
         f"{what}: launches {launched} on route {route}")
    a = kernels.seg_agg_sorted(gid, mask, S, reds)
    b = kernels.seg_agg_sorted(gid, mask, S, reds)
    need(all(torch.equal(x, y) for x, y in zip(a, b)),
         f"{what}: two runs of K4 differ")
    return err


def k4_window_sweep(gid, mask, reds: list, device, rng) -> None:
    """The measurement behind kernels.K4_MAX_WINDOWS: at l_suppkey's rows
    and reductions, ids over S segments taking several windows, each S on
    the windowed route (kernels._k4_block, whatever the windows' number)
    and on the sorted route (kernels._k4_sorted), in turns."""
    if device.type != "cuda":
        return
    ms = timer(device)
    slots, _map = kernels.k4_slots(reds)
    n_f = sum(s[0] in kernels.F_OPS for s in slots)
    limit = kernels._k4_block_limit(_ext.lib("seg_agg_sorted"), device)
    rows = []
    for S in (10_002, 20_000, 30_000, 36_000, 40_000):
        g = torch.from_numpy(rng.integers(0, S, gid.shape[0])).to(device)
        windows = kernels._k4_windows(len(reds), len(slots), n_f, S,
                                      limit)[1]
        blk = ms(lambda: kernels._k4_block(g, mask, S, reds))
        srt = ms(lambda: kernels._k4_sorted(g, mask, S, reds))
        rows.append({"segments": S, "windows": windows,
                     "windows_ms": blk, "sorted_ms": srt})
    print(f"phase B: K4 windows against the sorted route (cap "
          f"{kernels.K4_MAX_WINDOWS}): {json.dumps(rows)}")


def phase_b(n_rows: int, seed: int, device, edge_cap: int) -> tuple:
    """Returns (per-kernel results, the rows, the batch), the batch holding
    Phase E's and Phase F's columns too."""
    ms = timer(device)
    t0 = time.perf_counter()
    data = tpch.generate(n_rows, seed)
    cids = [tpch.C_SUPPKEY, tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE,
            tpch.C_DISCOUNT, tpch.C_TAX, tpch.C_RETURNFLAG,
            tpch.C_LINESTATUS, tpch.C_SHIPDATE, tpch.C_ORDERKEY,
            tpch.C_LINENUMBER, tpch.C_COMMITDATE, tpch.C_RECEIPTDATE,
            tpch.C_SHIPMODE, tpch.C_PARTKEY, tpch.C_FDISCOUNT]
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
    k2_repeat(mask6, reds6, "K2 Q6")
    err = max(err, k2_edges(device, seed + 11))
    print("phase B: K2 (one pass, descriptors by value, 16-byte loads, "
          "a last-block fold) equal to its plain version at Q6 and on the "
          "edge cases; repeats bit-identical")
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

    # K4 at GROUP BY l_suppkey's shape (segment windows), plus edge
    # reductions over windows and over 2^20 segments mostly empty (the
    # sorted route, its ids sorted by the radix)
    maskS, gidS, outsS = sup.k1()
    redsS = sup.reds(outsS)
    SS = sup.segments
    routeS = k4_route_of(redsS, SS, device)
    err = check_k4(gidS, maskS, SS, redsS, "K4 supp")
    big = 1 << 20
    egid4 = torch.from_numpy(rng.integers(0, big // 3, edge_cap) * 3)\
        .to(device)
    err = max(err, check_k4(egid4, emask, big, ereds, "K4 edge 2^20"))
    for S in (65, 3_001, 20_011):
        g = torch.from_numpy(rng.integers(0, S, edge_cap)).to(device)
        err = max(err, check_k4(g, emask, S, ereds, f"K4 edge {S}"))
    stackedS = torch.stack([torch.where(maskS, r.values, torch.zeros_like(
        r.values)).view(torch.int64) for r in redsS
        if r.values is not None], 1)
    out["seg_agg_block"] = dict(
        ms=ms(lambda: kernels.seg_agg_sorted(gidS, maskS, SS, redsS)),
        plain_ms=ms(lambda: kernels.seg_agg_plain(gidS, maskS, SS, redsS)),
        library_ms=ms(lambda: torch.zeros(SS, stackedS.shape[1],
                                          dtype=torch.int64, device=device)
                      .index_add_(0, gidS, stackedS)),
        max_abs_err=err,
        bound=bound(_nbytes([gidS, maskS] + [t for r in redsS
                                             for t in (r.values, r.valid)]),
                    n * len(redsS)))
    edge_route = k4_route_of(ereds, big, device)
    edge_ms = ms(lambda: kernels.seg_agg_sorted(egid4, emask, big, ereds))
    print(f"phase B: K4 at l_suppkey ({SS} segments, {len(redsS)} "
          f"reductions) on {routeS}; the 2^20-segment edge ({edge_cap} rows, "
          f"{len(ereds)} reductions) on {edge_route}: {edge_ms:.4f} ms; "
          f"every K4 check equal to its plain version, repeats "
          f"bit-identical")
    k4_window_sweep(gidS, maskS, redsS, device, rng)
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
    q1_dev = ms(lambda: q1.fn(q1.planes, q1.live))
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    print(f"phase B: Q1 device time (K1 + K3 + readback) {q1_dev:.4f} ms; "
          f"segments Q1 {S1}, l_suppkey {SS}")
    # the plain version of build_filter_fn: K1's plain version + nonzero
    filter_plain_ms = ms(lambda: torch.nonzero(run_program_plain(
        ffn.program, fplanes, q6.live)[0]))
    print(f"phase B: build_filter_fn plain version (K1 plain + "
          f"torch.nonzero) {filter_plain_ms:.4f} ms")
    return out, data, batch


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


def phase_c(n_rows: int, seed: int, device, regions=(1, 2, 8)) -> tuple:
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
                    "combine_region_partials": k7, "mesh_allreduce": 0}
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
        # every sweep shape's spans fit shared memory at SF0.01; K6's
        # windows and sorted route are driven on Phase D's main path
        # (d_supplier, d_part)
        for k, v in totals.items():
            need(v > 0 or k in ("seg_states_ragged_window",
                                "seg_states_ragged_sorted"),
                 f"kernel {k} never launched on the cluster path")
    # K6 at q1full's SF0.01 regions (the last store: 8 regions)
    _r, k6, _s = capture(gpu, tpch.sweep_request("q1full"), device)
    zero_launches()
    err = check_k6_twice(k6, "K6 SF0.01 q1full")
    need(device.type != "cuda"
         or kernels.LAUNCHES["seg_states_ragged_smem"] == 2,
         "phase C: K6 at q1full's SF0.01 regions left the block route")
    r = dict(k6_timed(k6, device), max_abs_err=err)
    print(f"  K6 at q1full over {R} regions ({r['shape']}): {r['ms']:.4f} "
          f"ms (plain {r['plain_ms']:.4f} ms, library index_add_ "
          f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.6f} ms by "
          f"{r['bound'][1]})")
    return totals, {"seg_states_ragged_smem/sf001": r}


D_CIDS = [tpch.C_QUANTITY, tpch.C_EXTENDEDPRICE, tpch.C_DISCOUNT,
          tpch.C_TAX, tpch.C_RETURNFLAG, tpch.C_LINESTATUS,
          tpch.C_SHIPDATE, tpch.C_FDISCOUNT]


def admit(store: DistStore, sel: SelectRequest, batches: list) -> None:
    """Admit one batch per region, pinned, under the plane-cache key the
    region handler computes for `sel`."""
    req = tpch.store_request(sel)
    regions = store.cluster.regions
    need(len(regions) == len(batches), "one batch per region")
    version = store.data_version_at(
        sel.start_ts, tc.table_prefix(sel.table_info.table_id))
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


# (case, [(cap, n_rows, G)] a region, [K6 op] a reduction): shapes that
# take K6's block route (spans of 512 to 4,096 at 3 or 4 reductions)
K6_BLOCK_EDGES = (
    ("-0.0 beside +0.0, +-inf-only groups, an f64 sum",
     [(3001, 2999, 700), (4099, 4099, 900), (1, 1, 600)],
     [kernels.R_MIN_F, kernels.R_MAX_F, kernels.R_SUM_F, kernels.R_COUNT]),
    ("int64 extremes, wrapping sums, an empty region",
     [(5003, 5001, 2000), (17, 0, 0), (20011, 19999, 1500), (9, 9, 3)],
     [kernels.R_SUM_I, kernels.R_MIN_I, kernels.R_MAX_I]),
    ("span 4096, one hot segment",
     [(60001, 59999, 3000), (40003, 40003, 2600)],
     [kernels.R_COUNT, kernels.R_SUM_I, kernels.R_MAX_I, kernels.R_SUM_F]),
    ("extrema at span 1024, short regions",
     [(8191, 6000, 520), (12289, 12289, 1000), (333, 100, 700)],
     [kernels.R_MIN_I, kernels.R_MAX_F, kernels.R_COUNT]),
    ("one hot segment of -0.0 and +0.0",
     [(20011, 20000, 1500), (7001, 7001, 800)],
     [kernels.R_MIN_F, kernels.R_MAX_F, kernels.R_SUM_F]),
)


# shapes that take K6's window route (spans past one block: up to 12,001
# segments a region at 8 reductions, 30,001 at 4), one past the windows'
# cap (the sorted route: 120,001 segments at 5 reductions) and two past
# the block route's 32 reductions (the sorted route with its tables on the
# card, over one region and over seven); the -0.0 / +0.0 ties hold on
# every route
K6_WINDOW_EDGES = (
    ("windows: -0.0 beside +0.0, +-inf-only groups, an f64 sum",
     [(300001, 299999, 9000), (200003, 200003, 12000), (1, 1, 5000)],
     [kernels.R_MIN_F, kernels.R_MAX_F, kernels.R_SUM_F, kernels.R_COUNT,
      kernels.R_SUM_I, kernels.R_MIN_I, kernels.R_MAX_I, kernels.R_COUNT]),
    ("windows: int64 extremes, wrapping sums, an empty region, a hot segment",
     [(400003, 400001, 20000), (17, 0, 0), (100011, 99999, 30000)],
     [kernels.R_SUM_I, kernels.R_MIN_I, kernels.R_MAX_I, kernels.R_COUNT]),
)
K6_PAST_CAP_EDGES = (
    ("past the window cap: -0.0 beside +0.0, int64 extremes",
     [(500003, 500001, 120000), (300007, 300007, 60000)],
     [kernels.R_COUNT, kernels.R_SUM_I, kernels.R_MAX_I, kernels.R_MIN_F,
      kernels.R_MAX_F]),
    ("33 reductions over one region: -0.0 beside +0.0, int64 extremes",
     [(40001, 39989, 9)], [kernels.K6_OPS[j % 7] for j in range(33)]),
    ("33 reductions over seven regions: int64 extremes, an empty region",
     [(5003, 4999, 300)] * 3 + [(11, 0, 0)] + [(3001, 3001, 40)] * 3,
     [kernels.K6_OPS[j % 7] for j in range(33)]),
)


def k6_block_edges(device, seed: int, shapes=K6_BLOCK_EDGES) -> list:
    """[(seg_states_ragged arguments, what)] for the K6_BLOCK_EDGES shapes
    (or `shapes` of that form):
    regions whose rows start at odd offsets of the concatenated planes,
    group ids in [0, G_r] (the sink G_r, which rows past n_rows take), a
    contrib mask and, for every other reduction, a valid plane; f64 planes
    with -0.0 and +0.0 in groups 1 and 2, only +inf in group 3 and only
    -inf in group 4, an f64 sum over finite values; int64 planes with
    I64_MAX and I64_MIN (sums that wrap) and only I64_MIN in group 5; a
    hot segment (60 % of the rows), once of -0.0 and +0.0."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    out = []
    for what, regions, ops in shapes:
        gids, reds = [], []
        contribs = [[] for _ in ops]
        for cap, n, G in regions:
            g = rng.integers(0, G + 1, cap).astype(np.int64)
            if "hot" in what:
                g[rng.random(cap) < 0.6] = 1 if "0.0" in what else 7
            g[n:] = G
            gids.append(g)
            live = np.arange(cap) < n
            rr = []
            for j, op in enumerate(ops):
                if op in kernels.F_OPS:
                    v = rng.integers(-20, 20, cap) * 0.25
                    if op != kernels.R_SUM_F:
                        v[rng.random(cap) < 0.01] = np.inf
                        v[rng.random(cap) < 0.01] = -np.inf
                        zeros = np.isin(g, [1, 2])
                        v[zeros] = np.where(
                            rng.random(int(zeros.sum())) < 0.5, -0.0, 0.0)
                        v[g == 3] = np.inf
                        v[g == 4] = -np.inf
                else:
                    v = rng.integers(-1000, 1000, cap).astype(np.int64)
                    v[rng.random(cap) < 0.05] = kernels.I64_MAX
                    v[rng.random(cap) < 0.05] = kernels.I64_MIN
                    v[g == 5] = kernels.I64_MIN
                c = live & (rng.random(cap) < 0.9)
                ok = None if j % 2 else t(rng.random(cap) < 0.85)
                rr.append(kernels.StatesInput(
                    op, c, None if op == kernels.R_COUNT else t(v), ok))
                contribs[j].append(c)
            reds.append(rr)
        k6 = (t(np.concatenate(gids)), [c for c, _n, _G in regions],
              [n for _c, n, _G in regions], [G for _c, _n, G in regions],
              reds, [t(np.concatenate(cs)) for cs in contribs])
        out.append((k6, what))
    return out


def _k6_on(k6: tuple, device) -> tuple:
    gid, caps, n_rows, Gs, reds, contribs = k6
    mv = lambda x: None if x is None else x.to(device)  # noqa: E731
    return (gid.to(device), caps, n_rows, Gs,
            [[kernels.StatesInput(si.op, si.contrib, mv(si.values),
                                  mv(si.valid)) for si in rr] for rr in reds],
            [c.to(device) for c in contribs])


def k6_run(k6: tuple, route: str | None = None) -> torch.Tensor:
    """K6 on its own route, or (on the card) on `route`."""
    if route is None or k6[0].device.type != "cuda":
        return kernels.seg_states_ragged(*k6)
    launch, out = kernels._k6_on_route(route, *k6)
    launch()
    return out


def check_k6_twice(k6: tuple, what: str, route: str | None = None) -> float:
    """K6 run twice (the same bits; on `route` where given) against its
    plain version on the CPU, which folds each segment in row order: an
    extremum tie of -0.0 and +0.0 keeps the first in row order there and
    on every route. Every op exact but f64 sums: those within
    F64_SUM_RTOL of the segment's sum of magnitudes (the block and window
    routes add their blocks' partial sums in block order, the sorted route
    its lanes' in a butterfly)."""
    got = k6_run(k6, route)
    again = k6_run(k6, route)
    need(torch.equal(got, again), f"{what}: two runs of K6 differ")
    gid, caps, n_rows, Gs, reds, contribs = _k6_on(k6, torch.device("cpu"))
    want = kernels.seg_states_ragged_plain(gid, caps, Gs, reds, contribs)
    got = got.cpu()
    err = 0.0
    for j in range(len(contribs)):
        op = reds[0][j].op
        if op != kernels.R_SUM_F:
            need(torch.equal(got[j], want[j]),
                 f"{what}: K6 reduction {j} (op {op}) differs from its plain "
                 "version")
            continue
        absd = [[kernels.StatesInput(si.op, si.contrib, si.values.abs(),
                                     si.valid) if i == j else si
                 for i, si in enumerate(rr)] for rr in reds]
        mag = kernels.seg_states_ragged_plain(
            gid, caps, Gs, absd, contribs)[j].view(torch.float64)
        g, w = got[j].view(torch.float64), want[j].view(torch.float64)
        d = (g - w).abs()
        need(bool((d <= F64_SUM_RTOL * mag).all()),
             f"{what}: K6 f64 sum {j} beyond {F64_SUM_RTOL} of the "
             "magnitudes")
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


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


def k6_timed(k6: tuple, device) -> dict:
    """K6's launch at these arguments (median of 20 CUDA-event runs), its
    plain version's and one index_add_ of the same contributions stacked
    [rows, reductions] into the layout's segments; with its bound and
    shape."""
    ms = timer(device)
    gid, caps, n_rows_, Gs, reds, contribs = k6
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
    launch = kernels.k6_prepare(*k6)[0] if device.type == "cuda" \
        else (lambda: kernels.seg_states_ragged(*k6))
    return dict(
        ms=ms(launch),
        plain_ms=ms(lambda: kernels.seg_states_ragged_plain(
            gid, caps, Gs, reds, contribs)),
        library_ms=ms(lambda: torch.zeros(
            S, stacked.shape[1], dtype=torch.int64, device=device)
            .index_add_(0, g_off, stacked)),
        bound=k6_bound(k6),
        shape=f"{len(caps)} regions, {sum(n_rows_)} rows, {S} segments, "
              f"{len(contribs)} reductions, {k6_plan(k6, device)}")


def k6_plan(k6: tuple, device) -> str:
    """K6's route at these arguments on this card (kernels.k6_route)."""
    if device.type != "cuda":
        return "plain"
    route, rows, minb, copies = k6_route_of(k6, device)
    if route == "seg_states_ragged_window":
        return (f"{route}: {rows} rows a thread, {copies} windows a region "
                f"at most")
    return (f"{route}: {rows} rows a thread, {minb} blocks an SM, "
            f"{copies} copies" if rows else route)


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


D_SUPPLIER_CIDS = [tpch.C_SUPPKEY, tpch.C_QUANTITY, tpch.C_DISCOUNT,
                   tpch.C_SHIPDATE]


def d_supplier() -> SelectRequest:
    """tpch.by_supplier with max(l_quantity) for max(l_shipdate) (the
    cluster path leaves a temporal MAX to the row engine): select
    count(*), sum(l_quantity), avg(l_discount), max(l_quantity),
    first_row(l_suppkey) group by l_suppkey, hinted for the cluster path.
    At SF1 every region holds about 10,000 suppliers: 16,384 segments a
    region at 8 reductions, past one block's shared memory."""
    sel = tpch.by_supplier()
    sel.aggregates[3] = expr_agg("max", [expr_column(tpch.C_QUANTITY)])
    return tpch.hinted(sel)


def check_d_supplier(rows: list, data: dict) -> None:
    """d_supplier's final rows against numpy: count, sum and max of the
    quantity, the discount's sum over the count, by supplier."""
    d2 = lambda v: Decimal(int(v)).scaleb(-2)  # noqa: E731
    uniq, inv = np.unique(data[tpch.C_SUPPKEY], return_inverse=True)
    cnt = np.bincount(inv)
    sq = np.bincount(inv, weights=data[tpch.C_QUANTITY].astype(np.float64))
    sd = np.bincount(inv, weights=data[tpch.C_DISCOUNT].astype(np.float64))
    mx = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, data[tpch.C_QUANTITY].astype(np.int64))
    want = {int(u): [int(c), d2(a), d2(b) / int(c), d2(m)]
            for u, c, a, b, m in zip(uniq, cnt, sq, sd, mx)}
    got = {row[-1].val: [d.val for d in row[:4]] for row in rows}
    need(got == want, f"phase D d_supplier: {len(got)} groups differ from "
         f"numpy's {len(want)}")


D_PART_CIDS = [tpch.C_PARTKEY, tpch.C_QUANTITY]


def d_part() -> SelectRequest:
    """select count(*), sum(l_quantity), max(l_quantity),
    first_row(l_partkey) group by l_partkey, hinted for the cluster path.
    At SF1 every region holds about 190,000 of the 200,000 parts: 262,144
    segments a region, past K6's window cap (its sorted route)."""
    c = expr_column
    return tpch.hinted(SelectRequest(
        start_ts=1, table_info=tpch.table_info(D_PART_CIDS),
        group_by=[ByItem(c(tpch.C_PARTKEY))],
        aggregates=[expr_agg("count", [expr_value(Datum.i64(1))]),
                    expr_agg("sum", [c(tpch.C_QUANTITY)]),
                    expr_agg("max", [c(tpch.C_QUANTITY)]),
                    expr_agg("first_row", [c(tpch.C_PARTKEY)])]))


def check_d_part(rows: list, data: dict) -> None:
    """d_part's final rows against numpy: count, sum and max of the
    quantity by part."""
    d2 = lambda v: Decimal(int(v)).scaleb(-2)  # noqa: E731
    q = data[tpch.C_QUANTITY].astype(np.int64)
    uniq, inv = np.unique(data[tpch.C_PARTKEY], return_inverse=True)
    cnt = np.bincount(inv)
    sq = np.zeros(len(uniq), np.int64)
    np.add.at(sq, inv, q)
    mx = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(mx, inv, q)
    want = {int(u): [int(n), d2(a), d2(m)]
            for u, n, a, m in zip(uniq, cnt, sq, mx)}
    got = {row[-1].val: [d.val for d in row[:3]] for row in rows}
    need(got == want, f"phase D d_part: {len(got)} groups differ from "
         f"numpy's {len(want)}")


def k6_route_of(k6: tuple, device) -> tuple:
    """kernels.k6_route at these arguments on this card (the card's
    opt-in limit; each region's groups and sink as its segments)."""
    _gid, _caps, _n, Gs, reds, contribs = k6
    return kernels.k6_route(
        len(contribs), max(kernels.bucket_segments(g + 1) for g in Gs),
        kernels._k6_block_limit(_ext.lib("seg_states_ragged"), device),
        sum(r.op in kernels.F_OPS for r in reds[0]), [g + 1 for g in Gs])


def phase_d(n_rows: int, seed: int, device, R: int = 8) -> tuple:
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
    # K6's window and sorted routes on the main path: d_supplier (windows)
    # and d_part (past the windows' cap) through a store of the same
    # regions with their columns pinned in its own plane cache (the
    # sweep's store keeps its cache for Phases J, K, L and I)
    cuda = device.type == "cuda"
    s_store = DistStore([], tpch.split_keys(n_rows, R), device,
                        plane_cache=PlaneCache(device=device))
    main_launches = {}
    k6_main = {}
    for name, make, cids, check, route in (
            ("d_supplier", d_supplier, D_SUPPLIER_CIDS, check_d_supplier,
             "seg_states_ragged_window"),
            ("d_part", d_part, D_PART_CIDS, check_d_part,
             "seg_states_ragged_sorted")):
        s_sel = make()
        admit(s_store, s_sel, tpch.region_batches(data, cids, R))
        zero_launches()
        # K6's arguments kept as the statement passes them (d_part's
        # statement takes tens of seconds of host work: run it once)
        captured = []
        orig = kernels.seg_states_ragged

        def spy(*a):
            captured.append(a)
            return orig(*a)

        kernels.seg_states_ragged = spy
        t1 = time.perf_counter()
        try:
            rows = final_rows(s_store, s_sel)
        finally:
            kernels.seg_states_ragged = orig
        if cuda:
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        need(len(captured) == 1, f"phase D {name}: {len(captured)} K6 calls")
        got = {k: kernels.LAUNCHES[k] for k in K6_ROUTES}
        need(not cuda or got == {k: int(k == route) for k in K6_ROUTES},
             f"phase D {name}: K6 launches {got}, not one on {route}")
        main_launches[route] = got[route]
        check(rows, data)
        groups = fused_agg.stats["last_groups"]
        wall, runs = first_s * 1e3, 1
        if name == "d_supplier":
            wall, runs = host_ms(lambda: final_rows(s_store, s_sel), 3), 3
        stmt[name] = {"ms": wall, "groups": groups, "k6": got}
        print(f"  {name}: equal to numpy, K6 launches {got}; statement "
              f"{wall:.3f} ms median of {runs} (first run {first_s:.2f} s)")
        k6_main[route] = captured[0]
    del s_store
    k6_sup = k6_main["seg_states_ragged_window"]
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
    k5_launch = kernels.k5_prepare(regions, device)[0] if cuda \
        else (lambda: kernels.expr_vm_ragged(regions, device))
    k5_wrapper_ms = ms(lambda: kernels.expr_vm_ragged(regions, device))
    out["expr_vm_ragged"] = dict(
        ms=ms(k5_launch),
        plain_ms=ms(lambda: kernels.expr_vm_ragged_plain(regions, device)),
        library_ms=None, max_abs_err=k5_err,
        bound=bound(k5_bytes, sum(rp.cap * rp.fin.n_instr
                                  for rp in regions)))
    # K6 on each of its routes (kernels.k6_route): Q1's spans (8 segments
    # a region) and date_group's (about 2.5k dates, 4,096 segments a
    # region) the block route in the opt-in shared memory, Q1's with 16
    # copies of its integer states at two blocks an SM; d_supplier's
    # (about 10,000 suppliers, 16,384 segments a region at 8 reductions)
    # segment windows; d_part's (about 190,000 parts a region) the sorted
    # route past the windows' cap. Each shape and edge states on its route
    # (read from the launch counts) against the plain version on the CPU,
    # twice, the same bits both times; the large-span edge states also
    # forced onto the sorted route (`route`).
    _r, k6_date, _s = capture(store, tpch.sweep_request("date_group"), device)
    ebits, eouts = kernels.expr_vm_ragged(eregions, device)
    big = _edge_states(edge, ebits, eouts, device, True, seed + 13)
    big_route = k6_route_of(big, device)[0] if cuda else "plain"
    checks = [
        ("seg_states_ragged_smem", k6, "K6 Q1", None),
        ("seg_states_ragged_smem", k6_date, "K6 date_group", None),
        ("seg_states_ragged_window", k6_sup, "K6 d_supplier", None),
        ("seg_states_ragged_sorted", k6_main["seg_states_ragged_sorted"],
         "K6 d_part", None),
        ("seg_states_ragged_smem", _edge_states(
            edge, ebits, eouts, device, False, seed + 13), "K6 edge", None),
        (big_route, big, "K6 edge large spans", None),
        ("seg_states_ragged_sorted", big, "K6 edge large spans, sorted",
         "seg_states_ragged_sorted")]
    checks += [("seg_states_ragged_smem", a, f"K6 block edge: {w}", None)
               for a, w in k6_block_edges(device, seed + 19)]
    checks += [("seg_states_ragged_window", a, f"K6 window edge: {w}", None)
               for a, w in k6_block_edges(device, seed + 23,
                                          K6_WINDOW_EDGES)]
    checks += [("seg_states_ragged_sorted", a, f"K6 edge: {w}", None)
               for a, w in k6_block_edges(device, seed + 29,
                                          K6_PAST_CAP_EDGES)]
    k6_err = {}
    for route, args, what, force in checks:
        zero_launches()
        e = check_k6_twice(args, what, force)
        need(not cuda or {k: kernels.LAUNCHES[k] for k in K6_ROUTES}
             == {k: 2 * (k == route) for k in K6_ROUTES},
             f"{what}: K6 did not take its {route} route: "
             f"{ {k: kernels.LAUNCHES[k] for k in K6_ROUTES} }")
        k6_err[route] = max(k6_err.get(route, 0.0), e)
    print(f"phase D: K6 equal to its plain version on {len(checks)} shapes, "
          f"each on its route ({big_route} for the large-span edge states, "
          f"and the sorted route), each twice with the same bits")
    k6_wrapper_ms = {}
    for route, args in (("seg_states_ragged_smem", k6),
                        ("seg_states_ragged_smem/date_group", k6_date),
                        ("seg_states_ragged_window", k6_sup),
                        ("seg_states_ragged_sorted",
                         k6_main["seg_states_ragged_sorted"])):
        k6_wrapper_ms[route] = ms(lambda a=args: kernels.seg_states_ragged(*a))
        out[route] = dict(k6_timed(args, device), max_abs_err=k6_err[
            route.split("/")[0]])
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
          f"K6 {k6_wrapper_ms['seg_states_ragged_smem']:.4f} ms (date_group, "
          f"block route: "
          f"{k6_wrapper_ms['seg_states_ragged_smem/date_group']:.4f} ms; "
          f"d_supplier, windows: "
          f"{k6_wrapper_ms['seg_states_ragged_window']:.4f} ms; d_part, "
          f"sorted route: {k6_wrapper_ms['seg_states_ragged_sorted']:.4f} "
          f"ms), K7 {k7_wrapper_ms:.4f} ms")
    print(f"phase D: Q1 inputs: {len(regions)} regions, {total} rows, "
          f"{len(contribs)} reductions, {S} segments, K7 {len(states)} "
          f"states of {states[0].shape}; K6 "
          + "; ".join(f"{k}: {out[k]['shape']}" for k in k6_wrapper_ms)
          + f"; K6's block route at Q1: {k6_plan(k6, device)}")
    print("phase D statements: " + json.dumps(stmt))
    return out, store, data, main_launches


# ---------------------------------------------------------------------------
# Phase E: ranked group-by, DISTINCT and TopN at SF1 (slice 3)
# ---------------------------------------------------------------------------

SLICE3_KERNELS = ("rank_groups", "distinct_runs", "topk_select")
# launches per statement on the card: the first run of each statement of
# tpch.SLICE3 in order, then the repeats of the two group-by shapes, which
# start at the memoized rung (ranked_dates) or go straight to tuple codes.
# The ranked prepare (once a statement, whatever the rung) and each
# DISTINCT aggregate sort by one K17 (sort_perm), whose radix passes come
# from its plan (e_statements adds them)
E_LAUNCHES = {
    "ranked_dates": {"expr_vm": 1, "sort_perm": 1, "rank_groups": 3,
                     "seg_agg_sorted": 1},
    # the tuple codes' 429,862 segments: K4's sorted route, its ids sorted
    # by a radix pass per digit of their 19 bits
    "tuple_dates": {"expr_vm": 2, "sort_perm": 1, "rank_groups": 3,
                    "seg_agg_sorted": 1,
                    "radix_pass": len(kernels.radix_plan((1 << 19) - 1,
                                                         False))},
    "scalar_distinct": {"expr_vm": 1, "sort_perm": 4, "distinct_runs": 4,
                        "scalar_agg": 4},
    "grouped_distinct": {"expr_vm": 1, "seg_agg_onehot": 1, "sort_perm": 1,
                         "distinct_runs": 1, "seg_agg_sorted": 1},
    # K10's launches come from its plan (kernels.topk_launch_count)
    "topn_price": {"expr_vm": 1},
    "topn_multi": {"expr_vm": 1},
    "topn_multi_5000": {"expr_vm": 1},
    "ranked_dates repeat": {"expr_vm": 1, "sort_perm": 1, "rank_groups": 1,
                            "seg_agg_sorted": 1},
    "tuple_dates repeat": {"expr_vm": 1, "seg_agg_sorted": 1,
                           "radix_pass": len(kernels.radix_plan(
                               (1 << 19) - 1, False))},
}


def plan_text(plan: list) -> str:
    """K17's plan (kernels.sort_plan) as words, bits and passes."""
    if not plan:
        return "no word (every plane constant), no pass"
    return f"{len(plan)} word(s) of " + " + ".join(
        str(sum(w for _j, _s, w in fields)) for fields, _v, _p in plan) \
        + f" bits, {sum(len(p) for _f, _v, p in plan)} passes"


class K17Spy:
    """Records each K17 sort of a run: its plan and, where `keep`, its
    planes (to recompute the plan on the host after the run)."""

    def __init__(self):
        self.calls = []
        self.keep = True
        self.orig = kernels._k17_sort

    def __enter__(self):
        def spy(planes, n, dev, *rest):
            res = self.orig(planes, n, dev, *rest)
            self.calls.append((list(planes) if self.keep else None, res[2]))
            return res
        kernels._k17_sort = spy
        return self

    def __exit__(self, *exc):
        kernels._k17_sort = self.orig

    def take(self, what: str) -> int:
        """The radix passes of the sorts since the last take, each plan
        that kept its planes checked against the plan recomputed on the
        host from the planes read back."""
        passes = 0
        for planes, plan in self.calls:
            if planes is not None:
                need(kernels.sort_plan(kernels.sort_summary_plain(
                    [p.cpu() for p in planes])) == plan,
                     f"{what}: K17's plan differs from the host's")
            passes += sum(len(p) for _f, _v, p in plan)
        self.calls = []
        return passes


def cents(d) -> int:
    return int(d.val.scaleb(2))


def check_slice3(name: str, resp, data: dict, what: str) -> None:
    """A slice-3 statement's partial rows against numpy
    (tpch.slice3_expected): counts, decimals and row ids exact."""
    want = tpch.slice3_expected(name.split()[0], data)
    rows = list(iter_response_rows(resp))
    if name.startswith(("ranked_dates", "tuple_dates")):
        got = {(ds[5].val.dt.date(), ds[6].val.dt.date()):
               [ds[1].val, cents(ds[2]), cents(ds[4])]
               for _h, ds in rows if ds[3].val == ds[1].val}
        need(len(got) == len(rows) == len(want) and got == {
            k: [c, q, p] for k, (c, q, p) in want.items()},
            f"{what} {name}: groups differ from numpy")
    elif name == "scalar_distinct":
        (_h, ds), = rows
        got = [ds[1].val, ds[2].val, cents(ds[3]), (ds[4].val, cents(ds[5]))]
        need(got == [want[0], want[1], want[2][1], want[3]],
             f"{what} {name}: {got} vs numpy {want}")
    elif name == "grouped_distinct":
        got = {(ds[3].val, ds[4].val): [ds[1].val, ds[2].val]
               for _h, ds in rows}
        need(got == want, f"{what} {name}: {got} vs numpy {want}")
    else:
        got = [h for h, _ds in rows]
        need(got == want, f"{what} {name}: row ids differ from numpy")


def check_k8(prep, S: int, what: str) -> float:
    got = kernels.rank_groups(prep.order, prep.mask, prep.cols, S)
    want = kernels.rank_groups_plain(prep.order, prep.mask, prep.cols, S)
    for g, w, part in zip(got, want, ("gid", "ngroups", "starts", "rep",
                                      "nonnull")):
        need(torch.equal(g, w), f"{what}: K8 {part} differs from its plain "
             "version")
    return max(max_err(g, w) for g, w in zip(got, want))


K9_MODES = {"gather": 0, "sorted words": 0}


def check_k9(args: tuple, what: str) -> float:
    """K9 against its plain version on distinct_sort's output, in the
    gather mode and, where K17 packed one word, the sorted-word mode; each
    run twice for the same bits."""
    perm, key, contrib, gid_s, words = args
    want = kernels.distinct_runs_plain(perm, key, contrib, gid_s)
    err = 0.0
    for mode, w in (("gather", None), ("sorted words", words)):
        if mode != "gather" and w is None:
            continue
        got = kernels.distinct_runs(perm, key, contrib, gid_s, w)
        need(torch.equal(got, want), f"{what}: K9 ({mode}) differs from its "
             "plain version")
        need(torch.equal(kernels.distinct_runs(perm, key, contrib, gid_s, w),
                         got), f"{what}: two runs of K9 ({mode}) differ")
        K9_MODES[mode] += 1
        err = max(err, max_err(got, want))
    return err


def k10_launches(n: int, k: int, nk: int, device):
    """K10's launches for one call (its plan), or "plain" off the card."""
    if torch.device(device).type != "cuda":
        return "plain"
    return kernels.topk_launch_count(n, k, nk, device)


def check_k10(mask, keys: list, k: int, what: str) -> float:
    gi, gn = kernels.topk_select(mask, keys, k)
    wi, wn = kernels.topk_select_plain(mask, keys, k)
    need(torch.equal(gn, wn), f"{what}: K10 live count {gn} vs {wn}")
    need(torch.equal(gi, wi), f"{what}: K10 row ids differ from its plain "
         "version")
    return max(max_err(gi, wi), max_err(gn, wn))


def e_statements(client, batch, data) -> tuple:
    """Each tpch.SLICE3 statement once through GpuClient.serve, launches
    counted per statement; then the repeats of the group-by shapes, whose
    time and split (kernels.SPLIT) are kept. Returns (the requests by
    name, the launches of the whole run, {repeat: (ms, split)})."""
    sels = {name: make() for name, make in tpch.SLICE3}
    order = [(name, sels[name]) for name, _m in tpch.SLICE3] + [
        ("ranked_dates repeat", sels["ranked_dates"]),
        ("tuple_dates repeat", sels["tuple_dates"])]
    cuda = client.device.type == "cuda"
    zero_launches()
    total = {k: 0 for k in kernels.LAUNCHES}
    repeats = {}
    spy = K17Spy()
    for name, sel in order:
        before = dict(kernels.LAUNCHES)
        tuples = client.stats["tuple_grouped"]
        if name.endswith("repeat"):
            kernels.SPLIT = {}
        # a repeat is timed: its sorts keep no planes for the host's plan
        spy.keep = not name.endswith("repeat")
        t0 = time.perf_counter()
        with spy:
            resp = client.serve(sel, batch)
        if cuda:
            torch.cuda.synchronize()
        took = time.perf_counter() - t0
        k17_passes = spy.take(f"phase E {name}")
        if name.endswith("repeat"):
            repeats[name] = (took * 1e3, kernels.SPLIT)
            kernels.SPLIT = None
        delta = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                 if v != before[k]}
        check_slice3(name, resp, data, "phase E")
        if name.startswith("ranked_dates"):
            need(client.last_rank_cap == client._RANK_CAPS[-1],
                 f"{name}: answered at rung {client.last_rank_cap}")
        if name.startswith("tuple_dates"):
            need(client.stats["tuple_grouped"] == tuples + 1,
                 f"{name}: did not take the tuple codes")
        if cuda:
            want = dict(E_LAUNCHES[name])
            if k17_passes:
                want["radix_pass"] = want.get("radix_pass", 0) + k17_passes
            if sel.order_by:
                want["topk_select"] = k10_launches(
                    batch.capacity, sel.limit, len(sel.order_by),
                    client.device)
            need(delta == want, f"{name}: launches {delta}, want {want}")
        for k, v in delta.items():
            total[k] += v
        print(f"  {name}: {resp.row_count()} rows equal to numpy in "
              f"{took:.2f} s; launches {delta}")
    return sels, total, repeats


def edge_topn(device, seed: int) -> list:
    """(mask, keys, k, what) cases for K10: NULL keys beside filtered rows
    under DESC and ASC (the reference's single-key fault), int64 extremes
    under DESC (its multi-key wrap), BIGINT keys above 2^53 in both index
    orders, -0.0 beside +0.0, k = 1, k >= live rows, no live row, live
    counts and lengths that are no multiple of the tile, four keys with
    many ties."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    cases = []
    # fault 1: (id, a, c) = (1,0,5.0) (2,1,NULL) (3,1,3.0) (4,0,9.0), a > 0
    c = t(np.array([5.0, 0.0, 3.0, 9.0]))
    c_ok = t(np.array([True, False, True, True]))
    m = t(np.array([False, True, True, False]))
    for desc in (True, False):
        cases.append((m, [((c, c_ok), desc)], 2, f"null key desc={desc}"))
    # fault 2 and the f64 cast: int64 extremes and keys above 2^53
    big = np.array([-(1 << 63), 5, (1 << 53) + 1, 1 << 53, 7, (1 << 63) - 1],
                   np.int64)
    for arr in (big, big[::-1].copy()):
        ids = t(np.arange(len(arr), dtype=np.int64))
        ok = t(np.ones(len(arr), bool))
        live = t(np.ones(len(arr), bool))
        for desc in (True, False):
            cases.append((live, [((t(arr), ok), desc), ((ids, ok), False)],
                          3, f"int64 extremes desc={desc}"))
            cases.append((live, [((t(arr), ok), desc)], 2,
                          f"one int64 key desc={desc}"))
    n = 3 * 1024 + 517
    zeros = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    ok = t(rng.random(n) > 0.2)
    live = t(rng.random(n) > 0.3)
    cases.append((live, [((t(zeros), ok), False)], 40, "-0.0 and +0.0"))
    keys = [((t(rng.integers(0, 3, n).astype(np.int64)), ok), True),
            ((t(rng.integers(-2, 2, n) * 0.5), t(rng.random(n) > 0.3)),
             False),
            ((t(rng.integers(0, 2, n).astype(np.int64)),
              t(rng.random(n) > 0.5)), True),
            ((t(rng.standard_normal(n)), t(rng.random(n) > 0.1)), False)]
    for k in (1, 37, 1500, n):
        cases.append((live, keys, k, f"four keys k={k}"))
    none = t(np.zeros(n, bool))
    cases.append((none, keys, 10, "no live row"))
    few = t(np.arange(n) % 997 == 3)
    cases.append((few, keys[:2], 100, "k above the live rows"))
    return cases


K10_BIG_ROWS = (1 << 22) + 13


def k10_big_edges(device, seed: int) -> list:
    """(mask, keys, k, what) for K10 at 2^22 + 13 rows, many blocks: all
    keys equal (the first k live rows by position), the k-th first-key
    value shared by rows in every block, a key sorted in the wanted order
    and one sorted against it, k above one tile (5000), k at and above the
    live rows."""
    rng = np.random.default_rng(seed)
    n = K10_BIG_ROWS
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    live = t(rng.random(n) > 0.4)
    ok = t(np.ones(n, bool))
    some = t(rng.random(n) > 0.1)
    rows = np.arange(n, dtype=np.int64)
    tied = t(rng.integers(0, 64, n).astype(np.int64))
    price = t(rng.integers(90_000, 10_500_000, n).astype(np.int64))
    fkey = t(rng.standard_normal(n))
    sparse = t(rows % 4099 == 7)
    return [
        (live, [((t(np.full(n, 5, np.int64)), ok), True)], 100,
         "all keys equal"),
        (live, [((tied, ok), True), ((price, some), False)], 1000,
         "k-th first key shared across blocks"),
        (live, [((tied, ok), False)], 5000, "one tied key, k 5000"),
        (live, [((t(rows), ok), False)], 10, "sorted in the wanted order"),
        (live, [((t(rows), ok), True)], 10, "sorted against the wanted order"),
        (live, [((fkey, some), True), ((tied, ok), False)], 5000,
         "k 5000 over f64 with NULLs"),
        (sparse, [((price, some), True)], int(sparse.sum()),
         "k equal to the live rows"),
        (sparse, [((price, some), True), ((tied, ok), False)], 2000,
         "k above the live rows"),
    ]


def edge_rank(device, seed: int) -> list:
    """(order, mask, cols, S, what) cases for K8: NULLs, -0.0 beside
    +0.0, an int and an f64 column, no live row, S below the group count,
    a length that is no multiple of the tile."""
    rng = np.random.default_rng(seed)
    n = 5 * 1024 + 333
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    a = t(rng.integers(-3, 4, n).astype(np.int64))
    f = t(np.where(rng.random(n) < 0.3, -0.0, rng.integers(0, 3, n) * 1.5))
    a_ok, f_ok = t(rng.random(n) > 0.2), t(rng.random(n) > 0.2)
    cases = []
    for live_p, S, what in ((0.7, 1025, "mixed"), (0.7, 5, "overflow"),
                            (0.0, 17, "no live row")):
        mask = t(rng.random(n) < live_p)
        keys = []
        for v, ok in reversed([(a, a_ok), (f, f_ok)]):
            keys.append(torch.where(ok, kernels.orderable(v),
                                    torch.zeros_like(a)))
            keys.append((~ok).to(torch.uint8))
        keys.append((~mask).to(torch.uint8))
        order, _ = kernels.lexsort(keys)
        cases.append((order, mask, [(a, a_ok), (f, f_ok)], S, what))
    return cases


def edge_distinct(device, seed: int) -> list:
    """K9 argument tuples: I64_MAX and +inf values, -0.0 beside +0.0, no
    contributing row, scalar and grouped."""
    rng = np.random.default_rng(seed)
    n = 4 * 1024 + 77
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    iv = rng.integers(-5, 5, n).astype(np.int64)
    iv[::13] = (1 << 63) - 1
    fv = rng.integers(-3, 3, n) * 0.25
    fv[::7] = -0.0
    fv[::11] = np.inf
    gid = t(rng.integers(0, 9, n).astype(np.int64))
    # values of one sign, so that K17 packs one word: I64_MAX beside small
    # ones (63 bits and the flag), -0.0 / +0.0 / +inf among doubles
    nv = rng.integers(0, 5, n).astype(np.int64)
    nv[::13] = (1 << 63) - 1
    nf = rng.integers(0, 3, n) * 0.25
    nf[::7] = -0.0
    nf[::11] = np.inf
    sv = rng.integers(0, 300, n).astype(np.int64)
    out = []
    for v in (t(iv), t(fv), t(nv), t(nf), t(sv)):
        for p in (0.6, 0.0, 1.0):
            contrib = t(rng.random(n) < p)
            for g in (None, gid):
                perm, key, gs, words = kernels.distinct_sort(v, contrib, g)
                out.append(((perm, key, contrib, gs, words),
                            f"{v.dtype} contrib {p} "
                            f"{'grouped' if g is not None else 'scalar'} "
                            f"{'words' if words is not None else 'gather'}"))
    return out


def phase_e(data: dict, batch, device, seed: int) -> dict:
    ms = timer(device)
    client = GpuClient(MemStore([], []), device)
    t0 = time.perf_counter()
    sels, launches, repeats = e_statements(client, batch, data)
    print(f"phase E: statements equal to numpy in "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    if device.type == "cuda":
        for k in SLICE3_KERNELS:
            need(launches[k] > 0, f"kernel {k} never launched on phase E")
    # the group-by shapes emit 75k and 430k partial rows in Python (seconds
    # a run): their time is their repeat's, one run at the memoized rung
    stmt = {name.split()[0]: {"ms": ms_, "runs": 1, "split": split}
            for name, (ms_, split) in repeats.items()}
    for name, sel in sels.items():
        if name in stmt:
            continue
        runs = 10
        wall = host_ms(lambda: client.serve(sel, batch), runs)
        kernels.SPLIT = {}
        client.serve(sel, batch)
        split, kernels.SPLIT = kernels.SPLIT, None
        stmt[name] = {"ms": wall, "runs": runs, "split": split}
        print(f"  {name}: statement {wall:.3f} ms median of {runs} (host "
              f"clock); split " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in split.items()))
    print("phase E statements: " + json.dumps(stmt))
    planes = kernels.batch_planes(batch, device)
    live = kernels.device_live(batch, device)
    n = batch.capacity
    out = {}

    # K8 at ranked_dates' and tuple_dates' shapes (the top rung), edges
    preps, rfns = {}, {}
    for name in ("ranked_dates", "tuple_dates"):
        sel = sels[name]
        prog = Program(batch)
        specs = kernels.lower_aggregates(sel, batch, prog)
        rfns[name] = kernels.build_ranked_group_fn(
            prog, None, specs, kernels.lower_group_by(sel, batch).cids)
        preps[name] = rfns[name].prepare(planes, live)
    S = client._RANK_CAPS[-1]
    err = max(check_k8(p, S, f"K8 {name}") for name, p in preps.items())
    for order, mask, cols, S_e, what in edge_rank(device, seed):
        err = max(err, check_k8(kernels.RankedPrep(mask, {}, order, cols),
                                S_e, f"K8 edge {what}"))
    prep = preps["ranked_dates"]
    k8_bytes = n * (8 + 1) + sum(n * 9 for _c in prep.cols) + n * 8 + 8 \
        + S * 8 * (1 + len(prep.cols)) + S * len(prep.cols)
    sort_ms = ms(lambda: rfns["ranked_dates"].prepare(planes, live), runs=5)
    # the sort of ranked_dates' prepare: K17, and the chained torch.sort
    # the card path ran before (5 stable sorts); K8's yardstick the
    # library's run numbering of the sorted composite words
    rkeys = kernels.ranked_keys(prep.cols, prep.mask)
    rperm, rwords, rplan, _pairs = kernels.sort_perm_words(rkeys, n)
    if rwords is None:
        # more than one composite word: the sorted planes side by side
        rwords = torch.stack([k.index_select(0, rperm).to(torch.int64)
                              for k in rkeys], 1)
    split = {"K17": ms(lambda: kernels.lexsort(rkeys)),
             "chained torch.sort": ms(lambda: kernels.lexsort_plain(rkeys))}
    out["rank_groups"] = dict(
        ms=ms(lambda: kernels.rank_groups(prep.order, prep.mask, prep.cols,
                                          S)),
        plain_ms=ms(lambda: kernels.rank_groups_plain(
            prep.order, prep.mask, prep.cols, S)),
        library_ms=ms(lambda: torch.unique_consecutive(
            rwords, return_inverse=True, return_counts=True, dim=0)),
        max_abs_err=err, bound=bound(k8_bytes, n * len(prep.cols)))
    print(f"phase E: ranked_dates' K1 + sort ({len(rkeys)} planes of {n} "
          f"rows) {sort_ms:.4f} ms; the sort alone: K17 {split['K17']:.4f} "
          f"ms, chained torch.sort {split['chained torch.sort']:.4f} ms; "
          f"plan {plan_text(rplan)}; K8's yardstick unique_consecutive over "
          + ("one composite word" if rwords.dim() == 1 else
             f"{rwords.shape[1]} sorted planes"))

    # K9 at scalar_distinct's four specs and grouped_distinct's, edges
    k9_args = []
    sd = Request(sels["scalar_distinct"], batch, device)
    mask3, _g, outs3 = sd.k1()
    for spec in sd.specs:
        v, ok = kernels.arg_plane(spec, sd.planes, outs3, n, device)
        contrib = mask3 & ok
        perm, key, _gs, words = kernels.distinct_sort(v, contrib)
        k9_args.append(((perm, key, contrib, None, words), "scalar_distinct",
                        v))
    gd = Request(sels["grouped_distinct"], batch, device)
    mask4, gid4, outs4 = gd.k1()
    spec = gd.specs[0]
    v, ok = kernels.arg_plane(spec, gd.planes, outs4, n, device)
    contrib4 = mask4 & ok
    perm4, key4, gs4, words4 = kernels.distinct_sort(v, contrib4, gid4)
    k9_args.append(((perm4, key4, contrib4, gs4, words4), "grouped_distinct",
                    v))
    err = max(check_k9(a, f"K9 {what}") for a, what, _v in k9_args)
    edges = edge_distinct(device, seed + 1)
    for a, what in edges:
        err = max(err, check_k9(a, f"K9 edge {what}"))
    need(K9_MODES["gather"] and K9_MODES["sorted words"],
         f"phase E: K9's modes checked {K9_MODES}")
    # timed at count(distinct l_orderkey)'s shape, in the mode the path
    # takes there
    (perm, key, contrib, _n, words), _w, v1 = k9_args[1]
    need(words is not None, "phase E: count(distinct l_orderkey) is not on "
         "K9's sorted-word mode")
    sorted_keys = key[perm][contrib[perm]]
    dkeys = [key, (~contrib).to(torch.uint8)]
    dplan = kernels.sort_perm_words(dkeys, n)[2]
    dsplit = {"K17": ms(lambda: kernels.distinct_sort(v1, contrib)),
              "chained torch.sort": ms(lambda: kernels.lexsort_plain(dkeys))}
    gather_ms = ms(lambda: kernels.distinct_runs(perm, key, contrib))
    out["distinct_runs"] = dict(
        ms=ms(lambda: kernels.distinct_runs(perm, key, contrib, None,
                                            words)),
        plain_ms=ms(lambda: kernels.distinct_runs_plain(perm, key, contrib,
                                                        None)),
        library_ms=ms(lambda: torch.unique_consecutive(sorted_keys)),
        max_abs_err=err, bound=bound(n * (8 + 8 + 1), n))
    print(f"phase E: K9 at count(distinct l_orderkey): sorted words "
          f"{out['distinct_runs']['ms']:.4f} ms, gather {gather_ms:.4f} ms; "
          f"its sort: distinct_sort (K17) {dsplit['K17']:.4f} ms, chained "
          f"torch.sort {dsplit['chained torch.sort']:.4f} ms; plan "
          f"{plan_text(dplan)}; K9 modes checked {K9_MODES}")
    # both modes where the gather mode's reads are random: l_suppkey's
    # rows sorted by value (the lineitem batch is in l_orderkey order)
    (perm0, key0, contrib0, _n, words0), _w, _v = k9_args[0]
    need(words0 is not None, "phase E: count(distinct l_suppkey) is not on "
         "K9's sorted-word mode")
    modes0 = {"sorted words": ms(lambda: kernels.distinct_runs(
        perm0, key0, contrib0, None, words0)),
        "gather": ms(lambda: kernels.distinct_runs(perm0, key0, contrib0))}
    plan0 = kernels.sort_perm_words([key0, (~contrib0).to(torch.uint8)],
                                    n)[2]
    print(f"phase E: K9 at count(distinct l_suppkey) (random gathers): "
          f"sorted words {modes0['sorted words']:.4f} ms, gather "
          f"{modes0['gather']:.4f} ms; plan {plan_text(plan0)}")

    # K10 at topn_price's, topn_multi's and topn_multi_5000's shapes, edges
    k10 = {}
    for name in ("topn_price", "topn_multi", "topn_multi_5000"):
        sel = sels[name]
        prog = Program(batch)
        where = compile_expr(sel.where, batch, prog)
        keys = [(compile_expr(b.expr, batch, prog), b.desc)
                for b in sel.order_by]
        fn = kernels.build_topn_fn(prog, where, keys, sel.limit)
        mask, keys_p = fn.inputs(planes, live)
        k10[name] = (mask, keys_p, sel.limit)
    err = max(check_k10(*a, f"K10 {name}") for name, a in k10.items())
    for mask, keys_p, k, what in edge_topn(device, seed + 2):
        err = max(err, check_k10(mask, keys_p, k, f"K10 edge {what}"))
    big = k10_big_edges(device, seed + 3)
    for mask, keys_p, k, what in big:
        err = max(err, check_k10(mask, keys_p, k, f"K10 edge {what}"))
    mask, keys_p, k, _w = big[0]
    need(torch.equal(kernels.topk_select(mask, keys_p, k)[0],
                     torch.nonzero(mask).reshape(-1)[:k]),
         "K10 edge all keys equal: not the first live rows")
    print(f"phase E: K10 (threshold filter, {kernels.K10_STEP}-row steps, "
          f"plan levels by k) equal to its plain version at the three "
          f"shapes and on {len(big)} edge cases at {K10_BIG_ROWS} rows")
    for mask, keys_p, k, what in big[3:5]:
        nb = mask.shape[0]
        b = bound(nb * (1 + 9 * len(keys_p)) + 8 * k + 8, nb * len(keys_p))
        t_k = ms(lambda: kernels.topk_select(mask, keys_p, k))
        t_p = ms(lambda: kernels.topk_select_plain(mask, keys_p, k))
        print(f"phase E: K10 {what} ({nb} rows, k {k}): {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, bound {b[0]:.4f} ms by {b[1]}; "
              f"launches {k10_launches(nb, k, 1, device)}")
    mask, keys_p, k = k10["topn_price"]
    (price, price_ok), _desc = keys_p[0]
    score = torch.where(mask & price_ok, price.to(torch.float64),
                        torch.full_like(price, -np.inf, dtype=torch.float64))
    out["topk_select"] = dict(
        ms=ms(lambda: kernels.topk_select(mask, keys_p, k)),
        plain_ms=ms(lambda: kernels.topk_select_plain(mask, keys_p, k)),
        library_ms=ms(lambda: torch.topk(score, k)), max_abs_err=err,
        bound=bound(n * (1 + 9) + 8 * k + 8, n))
    for name in ("topn_multi", "topn_multi_5000"):
        mask, keys_p, k = k10[name]
        t_k = ms(lambda: kernels.topk_select(mask, keys_p, k))
        t_p = ms(lambda: kernels.topk_select_plain(mask, keys_p, k))
        b = bound(n * (1 + 9 * len(keys_p)) + 8 * k + 8, n * len(keys_p))
        print(f"phase E: K10 at {name}'s shape (k {k}, {len(keys_p)} "
              f"keys): {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{b[0]:.4f} ms by {b[1]}; launches "
              f"{k10_launches(n, k, len(keys_p), device)}")
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    return out, launches


# ---------------------------------------------------------------------------
# Phase F: joins at SF1
# ---------------------------------------------------------------------------

JOIN_KERNELS = ("join_build", "join_probe", "dict_remap")
# launches per statement on the card: each scan's filter (K1), then the
# join's kernels (and K11's radix passes, which k11_passes_host counts
# from the build side's planes)
F_LAUNCHES = {
    "f1_q3_join": {"expr_vm": 2, "join_build": 1, "join_probe": 1},
    "f2_partsupp": {"expr_vm": 2, "dict_remap": 2, "join_build": 1,
                    "join_probe": 1},
    "f3_prio_outer": {"expr_vm": 2, "dict_remap": 2, "join_build": 1,
                      "join_probe": 1},
}


def f_statement(client, name: str, batches: dict) -> tuple:
    """(HashJoinExec, HashAggExec) of a join statement over the admitted
    batches: two XSelectTableExec scans through the client's send."""
    left, right, plan, aggs, group_by = tpch.join_statement(name)
    kids = []
    for sel in (left, right):
        req = tpch.store_request(sel)
        client.admit(sel, req.key_ranges, batches[sel.table_info.table_id])
        kids.append(XSelectTableExec(client, sel, req.key_ranges))
    join = HashJoinExec(kids[0], kids[1], plan)
    return join, HashAggExec(join, aggs, group_by)


def check_join_rows(name: str, rows: list, tables: dict, what: str) -> None:
    want = tpch.join_expected(name, tables)
    need(len(rows) == len(want), f"{what} {name}: {len(rows)} rows, "
         f"want {len(want)}")
    for got, exp in zip(rows, want):
        need(len(got) == len(exp), f"{what} {name}: row width differs")
        for d, w in zip(got, exp):
            v = d.val.encode() if isinstance(d.val, str) else d.val
            if isinstance(w, float):
                need(isinstance(v, float)
                     and abs(v - w) <= F64_SWEEP_RTOL * abs(w),
                     f"{what} {name}: {v!r} vs numpy {w!r}")
            else:
                need(v == w, f"{what} {name}: {v!r} vs numpy {w!r}")


def plain_join_pairs(join) -> tuple:
    """The same join over the same scan answers on the CPU: the plain
    versions of K13, K11 and K12 (no launch)."""
    res = join.device_join_result()
    kids = [carry.SideExec(col.ColumnarScanResult(s.batch, s.sel,
                                                  s.pb_cols),
                           len(c.schema))
            for s, c in zip((res.lside, res.rside), join.children)]
    cpu = HashJoinExec(kids[0], kids[1], join.plan, device="cpu")
    out = cpu.device_join_result()
    return out.l_idx, out.r_idx


def check_join_kernels(rk, rv, lk, lv, what: str) -> float:
    """K11 and K12 against their plain versions on the same card
    tensors: words, order and pairs bit for bit."""
    w, o = kernels.join_build(rk, rv)
    wp, op = kernels.join_build_plain(rk, rv)
    need(torch.equal(w, wp) and torch.equal(o, op),
         f"{what}: K11 differs from its plain version")
    p, _totals = kernels.join_probe(w, o, lk, lv)
    pp = kernels.join_probe_plain(wp, op, lk, lv)
    need(torch.equal(p.to(torch.int64), pp),
         f"{what}: K12 differs from its plain version")
    return max(max_err(w, wp), max_err(o, op), max_err(p.to(torch.int64),
                                                          pp))


def k11_passes_host(rk, rv) -> int:
    """The radix passes K11 owes a build side, from its planes read back:
    none where the valid rows' order words are non-decreasing, else one
    per digit in which two of them differ (kernels.radix_plan)."""
    key, valid = rk.cpu(), rv.cpu().numpy()
    w = kernels.orderable(key).numpy()[valid]
    if len(w) < 2 or bool(np.all(w[1:] >= w[:-1])):
        return 0
    u = w.view(np.uint64) ^ np.uint64(1 << 63)
    varying = int(np.bitwise_or.reduce(u)) ^ int(np.bitwise_and.reduce(u))
    return len(kernels.radix_plan(varying, False))


def check_k11(rk, rv, what: str) -> tuple:
    """K11 against its plain version on the same card tensors, bit for
    bit, twice; (max_abs_err, its radix passes)."""
    before = kernels.LAUNCHES["radix_pass"]
    w, o = kernels.join_build(rk, rv)
    passes = kernels.LAUNCHES["radix_pass"] - before
    wp, op = kernels.join_build_plain(rk, rv)
    need(torch.equal(w, wp) and torch.equal(o, op),
         f"{what}: K11 differs from its plain version")
    w2, o2 = kernels.join_build(rk, rv)
    need(torch.equal(w, w2) and torch.equal(o, o2),
         f"{what}: two runs of K11 differ")
    return max(max_err(w, wp), max_err(o, op)), passes


def check_k13(cols: list, n: int, what: str) -> float:
    got = kernels.dict_remap(cols, n)
    want = kernels.dict_remap_plain(cols, n)
    need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
         f"{what}: K13 differs from its plain version")
    return max(max_err(got[0], want[0]), max_err(got[1], want[1]))


def edge_joins(device, seed: int) -> list:
    """(rkey, rvalid, lkey, lvalid, what) cases for K11 + K12."""
    big, small, inf = (1 << 63) - 1, -(1 << 63), float("inf")
    t = lambda a, dt=None: torch.tensor(a, dtype=dt, device=device)  # noqa
    i64, f64, b = torch.int64, torch.float64, torch.bool
    rng = np.random.default_rng(seed)
    cases = [
        ([big, big, 5], [True, False, True], [big, 0], [True, True],
         i64, "I64_MAX beside NULLs"),
        ([3, small, small, big], [True] * 4, [small, 3, small],
         [True, True, False], i64, "I64_MIN"),
        ([inf, 1.0, 2.0, -inf, -inf], [True, True, False, True, True],
         [inf, 1.0, -inf], [True] * 3, f64, "+-inf"),
        ([0.0, -0.0, 0.0], [True, True, False], [-0.0, 0.0, 1.0],
         [True] * 3, f64, "-0.0 against +0.0"),
        ([2, 2, 1], [False, True, False], [1, 2, 2], [False, True, False],
         i64, "NULLs on both sides"),
        ([], [], [1, 2], [True, True], i64, "empty right"),
        ([1], [True], [], [], i64, "empty left"),
        ([7] * 3000, [True] * 3000, [7] * 8, [True] * 8, i64,
         "8 x 3000 duplicates"),
        ([5] * (1 << 20), [True] * (1 << 20), [6, 5, 4], [True] * 3, i64,
         "one key with 2^20 matches"),
    ]
    out = [(t(rk, dt), t(rv, b), t(lk, dt), t(lv, b), what)
           for rk, rv, lk, lv, dt, what in cases]
    n = 100_003
    keys = rng.integers(-500, 500, (2, n)) * 0.25
    keys[0, ::97] = -0.0
    keys[1, ::89] = inf
    out.append((t(keys[0]), t(rng.random(n) > 0.1), t(keys[1]),
                t(rng.random(n) > 0.1), "f64 keys"))
    return out


def edge_remaps(device, seed: int) -> list:
    """(K13 columns, n, what): every mode, an empty remap table, int64
    extremes, +-inf and -0.0 in a domain, mixed radix."""
    rng = np.random.default_rng(seed)
    n = 40_009
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    RC = kernels.RemapCol
    valid = rng.random(n) > 0.2
    codes = RC(kernels.REMAP_CODES, t(np.where(valid, rng.integers(0, 9, n),
                                               -1)), t(valid), None, 8, 1)
    table = rng.permutation(12)[:7].astype(np.int64)
    remap = RC(kernels.REMAP_TABLE, t(rng.integers(-1, 9, n)),
               t(rng.random(n) > 0.2), t(table), 11, 9)
    empty = RC(kernels.REMAP_TABLE, t(np.full(n, -1, np.int64)),
               t(np.zeros(n, bool)), t(np.zeros(0, np.int64)), 2, 9)
    iv = rng.integers(-(1 << 40), 1 << 40, n)
    iv[::17], iv[::19] = (1 << 63) - 1, -(1 << 63)
    ivalid = rng.random(n) > 0.1
    idom = np.unique(iv[ivalid])
    dom_i = RC(kernels.REMAP_DOMAIN, t(iv), t(ivalid), t(idom),
               len(idom) - 1, 3)
    fv = rng.integers(-6, 6, n) * 0.25
    fv[::13], fv[::11], fv[::7] = np.inf, -np.inf, -0.0
    fvalid = rng.random(n) > 0.1
    fdom = np.unique(np.where(fv == 0.0, 0.0, fv)[fvalid])
    dom_f = RC(kernels.REMAP_DOMAIN, t(fv), t(fvalid), t(fdom),
               len(fdom) - 1, 7)
    return [([codes], n, "codes"), ([remap, codes], n, "remap"),
            ([empty, codes], n, "empty remap table"),
            ([dom_i, codes], n, "int64 domain"),
            ([dom_f, remap, codes], n, "f64 domain")]


def phase_f(data: dict, batch, device, seed: int) -> tuple:
    ms = timer(device)
    t0 = time.perf_counter()
    tables = tpch.join_data(data, seed)
    batches = {tid: tpch.join_batch(tables, tid)
               for tid in (tpch.ORDERS_ID, tpch.PARTSUPP_ID, tpch.PRIO_ID)}
    batches[tpch.TABLE_ID] = batch
    client = GpuClient(MemStore([], []), device)
    print(f"phase F: orders {len(tables[tpch.ORDERS_ID][tpch.O_ORDERKEY])}"
          f" rows, partsupp {len(tables[tpch.PARTSUPP_ID][tpch.PS_PARTKEY])}"
          f", prio 4 built in {time.perf_counter() - t0:.1f} s")
    total = {k: 0 for k in kernels.LAUNCHES}
    stmt, joins = {}, {}
    build = kernels.join_build
    for name in tpch.JOINS:
        builds = []

        def spy(rk_, rv_):
            builds.append((rk_, rv_))
            return build(rk_, rv_)

        kernels.join_build = spy
        zero_launches()
        t1 = time.perf_counter()
        try:
            join, agg = f_statement(client, name, batches)
            rows = agg.drain()
        finally:
            kernels.join_build = build
        if device.type == "cuda":
            torch.cuda.synchronize()
        took = (time.perf_counter() - t1) * 1e3
        delta = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check_join_rows(name, rows, tables, "phase F")
        want = dict(F_LAUNCHES[name])
        passes = sum(k11_passes_host(*b) for b in builds)
        if passes:
            want["radix_pass"] = passes
        need(delta == want or device.type != "cuda",
             f"{name}: launches {delta}, want {want}")
        need(join.join_stats["path"] == "device", f"{name}: not on device")
        for k, v in delta.items():
            total[k] += v
        res = join.device_join_result()
        pl, pr = plain_join_pairs(join)
        need(np.array_equal(res.l_idx, pl) and np.array_equal(res.r_idx, pr),
             f"{name}: pairs differ from the plain versions'")
        joins[name] = join
        print(f"  {name}: {len(rows)} rows equal to numpy, {len(res)} "
              f"pairs equal to the plain versions' (first run {took:.1f} "
              f"ms); launches {delta}")
        runs = 3
        wall = host_ms(lambda: f_statement(client, name, batches)[1].drain(),
                       runs)
        kernels.SPLIT = {}
        f_statement(client, name, batches)[1].drain()
        split, kernels.SPLIT = kernels.SPLIT, None
        stmt[name] = {"ms": wall, "runs": runs, "pairs": len(res),
                      "rows": len(rows), "split": split}
        print(f"  {name}: statement {wall:.3f} ms median of {runs} (host "
              f"clock); split " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in split.items()))
    print("phase F statements: " + json.dumps(stmt))
    out = {}

    # K11 + K12 at the unfiltered full shape: every lineitem row probes
    # every orders row by order key
    n_l = batch.n_rows
    n_o = batches[tpch.ORDERS_ID].n_rows
    lk, lv = (p[:n_l] for p in kernels.batch_planes(batch, device)
              [tpch.C_ORDERKEY])
    rk, rv = (p[:n_o] for p in kernels.batch_planes(
        batches[tpch.ORDERS_ID], device)[tpch.O_ORDERKEY])
    err = check_join_kernels(rk, rv, lk, lv, "K11/K12 full shape")
    for erk, erv, elk, elv, what in edge_joins(device, seed + 11):
        err = max(err, check_join_kernels(erk, erv, elk, elv,
                                          f"K11/K12 edge {what}"))
    words, order = kernels.join_build(rk, rv)
    pairs, _totals = kernels.join_probe(words, order, lk, lv)
    nv, n_pairs = words.shape[0], pairs.shape[1]
    # K11's paths: f1's build (orders in key order: no pass), the same keys
    # under a seeded permutation (a radix pass per varying digit), and
    # f2's build side as K13's domain codes
    perm = torch.from_numpy(np.random.default_rng(seed + 3).permutation(
        n_o)).to(device)
    j2 = joins["f2_partsupp"].device_join_result()
    pairs2 = [(c[0].index, c[1].index, False)
              for c in joins["f2_partsupp"].plan.eq_conditions]
    l_specs, r_specs = dictionary.build_join_specs(
        j2.lside, j2.rside, pairs2, dictionary.DEFAULT_MAX_NDV_RATIO)
    f2k, f2v = kernels.dict_remap_keys(r_specs, len(j2.rside), device)
    k11 = {}
    for what, k_, v_ in (("f1 presorted", rk, rv),
                         ("f1 shuffled", rk.index_select(0, perm),
                          rv.index_select(0, perm)),
                         ("f2 K13 codes", f2k, f2v)):
        e_, passes = check_k11(k_, v_, f"K11 {what}")
        err = max(err, e_)
        k11[what] = {"rows": int(k_.shape[0]), "passes": passes,
                     "ms": ms(lambda: kernels.join_build(k_, v_)),
                     "torch_sort_ms": ms(lambda: torch.sort(
                         kernels.orderable(k_), stable=True))}
    print("phase F: K11 paths " + json.dumps(k11))
    out["join_build"] = dict(
        ms=ms(lambda: kernels.join_build(rk, rv)),
        plain_ms=ms(lambda: kernels.join_build_plain(rk, rv)),
        library_ms=ms(lambda: torch.sort(rk, stable=True)),
        max_abs_err=err, bound=bound(n_o * 9 + nv * 16, n_o))
    out["join_probe"] = dict(
        ms=ms(lambda: kernels.join_probe(words, order, lk, lv)),
        plain_ms=ms(lambda: kernels.join_probe_plain(words, order, lk, lv)),
        library_ms=None, max_abs_err=err,
        bound=bound(n_l * 9 + nv * 16 + pairs.numel()
                    * pairs.element_size(),
                    n_l * 2 * max(int(nv).bit_length(), 1)))
    print(f"phase F: K11/K12 full shape {n_l} probe x {n_o} build rows, "
          f"{n_pairs} pairs")

    # K13 at f2's composite keys (the lineitem side), and edge cases
    cols = kernels.remap_cols(l_specs, device)
    n2 = len(j2.lside)
    err = check_k13(cols, n2, "K13 f2_partsupp")
    for ecols, en, what in edge_remaps(device, seed + 13):
        err = max(err, check_k13(ecols, en, f"K13 edge {what}"))
    tlen = [0 if c.table is None else c.table.numel() for c in cols]
    out["dict_remap"] = dict(
        ms=ms(lambda: kernels.dict_remap(cols, n2)),
        plain_ms=ms(lambda: kernels.dict_remap_plain(cols, n2)),
        library_ms=None, max_abs_err=err,
        bound=bound(n2 * 9 * (len(cols) + 1) + 8 * sum(tlen),
                    n2 * sum(max(t_, 2).bit_length() for t_ in tlen)))
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    return out, total, (tables, batches)


# ---------------------------------------------------------------------------
# Phase G: the micro-batch tier at SF1
# ---------------------------------------------------------------------------

SLOT_KERNELS = ("slot_filter", "slot_agg", "slot_topn")
G_THREADS, G_PER_THREAD = 64, 25


def g_rows(resp) -> list:
    return [(h, [d.val for d in ds]) for h, ds in iter_response_rows(resp)]


def g_traffic(store, tables, work, micro_batch: bool, device) -> tuple:
    """Every session thread sends its statements through one
    GpuClient(store) (default floor and window; the tier on or off), all
    released together by a barrier. Returns (rows by (thread, i),
    latencies in ms, wall seconds, the client, the launches of the run)."""
    data, words = tables
    client = GpuClient(store, device, micro_batch=micro_batch)
    for shape in tpch.G_SHAPES:         # pack each shape's batch once
        client.send(tpch.g_statement(shape, 0)).next()
    rows, lat, errs = {}, [], []
    lock = threading.Lock()
    barrier = threading.Barrier(len(work) + 1)

    def session(t):
        try:
            barrier.wait()
            for i, (shape, lit) in enumerate(work[t]):
                req = tpch.g_statement(shape, lit)
                t0 = time.perf_counter()
                got = g_rows(client.send(req).next())
                took = (time.perf_counter() - t0) * 1e3
                with lock:
                    rows[(t, i)] = got
                    lat.append(took)
        except Exception as e:      # raised again below, after the join
            with lock:
                errs.append(e)

    threads = [threading.Thread(target=session, args=(t,))
               for t in range(len(work))]
    for th in threads:
        th.start()
    zero_launches()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    need(not any(th.is_alive() for th in threads), "phase G: a session hung")
    if errs:
        raise errs[0]
    return rows, lat, wall, client, dict(kernels.LAUNCHES)


def slot_inputs(batch, sels: list, device) -> dict:
    """The tier's lowering of statements of one shape over `batch` (the
    code MicroBatcher._prepare runs): the shared program, one pool row per
    statement, the planes, and K15's reductions / K16's keys where the
    shape has them."""
    from tidb_tpu_torch.ops import sched
    pools, fin, aggs, topn = [], None, None, None
    for sel in sels:
        lw = sched._Lowerer(batch)
        emit = None
        if sel.where is not None:
            emit, _sig = lw.lower(sel.where)
        f = lw.program(batch, emit)
        need(fin is None or np.array_equal(f.meta, fin.meta),
             "statements of one shape lowered to different programs")
        fin = f
        pools.append(f.pool)
        if sel.aggregates:
            aggs = sched._lower_slot_aggs(sel, batch)
            need(aggs is not None, "aggregates outside the slot kind")
        if sel.order_by:
            topn = sched._lower_slot_topn(sel, batch)
            need(topn is not None, "ORDER BY outside the slot kind")
    planes = kernels.batch_planes(batch, device)
    # the pools stay on the host: they ride in the launch's parameters
    out = dict(fin=fin, pools=torch.from_numpy(np.stack(pools)),
               plane_list=[planes[key][w] for key, w in fin.plane_keys],
               live=kernels.device_live(batch, device), reds=None, keys=None,
               k=0)
    if aggs is not None:
        out["reds"] = [kernels.Red(kernels.R_COUNT, const_bits=1)] + [
            a.red(planes) for a in aggs]
    if topn is not None:
        out["keys"] = [(planes[cid], desc) for cid, desc, _k in topn[0]]
        out["k"] = topn[1]
    return out


def check_slots(a: dict, what: str) -> dict:
    """K14 (and K15, K16 where the inputs have them) against their plain
    versions on the card, bit for bit. Returns max_abs_err per kernel."""
    args = (a["fin"], a["pools"], a["plane_list"], a["live"])
    words = kernels.slot_filter(*args)
    pw = kernels.slot_filter_plain(*args)
    need(torch.equal(words, pw), f"{what}: K14 differs from its plain "
         "version")
    errs = {"slot_filter": max_err(words, pw)}
    if a["reds"] is not None:
        kn, kacc = kernels.slot_agg(*args, a["reds"])
        pn, pacc = kernels.slot_agg_plain(*args, a["reds"])
        need(torch.equal(kn, pn), f"{what}: K15 counts differ")
        for r, red in enumerate(a["reds"]):
            ka, pa = kacc[:, r], pacc[:, r]
            if red.op in kernels.F_OPS:
                ka, pa = ka.view(torch.float64), pa.view(torch.float64)
            need(torch.equal(ka, pa), f"{what}: K15 reduction {r} differs")
        errs["slot_agg"] = max(max_err(kn, pn), max_err(kacc, pacc))
    if a["keys"] is not None:
        gi, gn = kernels.slot_topn(words, a["keys"], a["k"])
        wi, wn = kernels.slot_topn_plain(pw, a["keys"], a["k"])
        need(torch.equal(gn, wn), f"{what}: K16 live counts {gn} vs {wn}")
        need(torch.equal(gi, wi), f"{what}: K16 row ids differ")
        errs["slot_topn"] = max(max_err(gi, wi), max_err(gn, wn))
    return errs


G_ECOLS = {1: dict(tp=my.TypeLonglong, flen=20),    # a: int64 extremes
           2: dict(tp=my.TypeDouble, flen=22),      # f: -0.0 beside +0.0
           3: dict(tp=my.TypeNewDecimal, flen=15, decimal=2),
           4: dict(tp=my.TypeString, flen=4),       # s: dictionary codes
           5: dict(tp=my.TypeDouble, flen=22)}      # g: no -0.0 (extrema)
G_EWORDS = [b"aa", b"ab", b"ba", b"bb", b"cc"]


def g_edge_batch(seed: int) -> col.ColumnBatch:
    """NULLs in every column, int64 extremes, -0.0 beside +0.0, and live
    rows that are no multiple of 32."""
    rng = np.random.default_rng(seed)
    n = 4096 - 37
    a = rng.integers(-50, 50, n).astype(np.int64)
    a[::11] = (1 << 63) - 1
    a[::13] = -(1 << 63)
    a[::17] = -((1 << 63) - 1)
    f = rng.integers(-4, 4, n) * 0.5
    f[::5] = -0.0
    data = {1: a, 2: f, 3: rng.integers(-9999, 9999, n).astype(np.int64),
            4: rng.integers(0, len(G_EWORDS), n).astype(np.int64),
            5: rng.standard_normal(n) * 1e3}
    b = tpch.table_batch(G_ECOLS, data, sorted(G_ECOLS), {4: G_EWORDS})
    for cid, cd in b.columns.items():
        cd.valid[:n] &= rng.random(n) > 0.15
    return b


def g_edge_cases(batch) -> list:
    """(statements, what) cases for K14/K15/K16 on the edge batch: NULL
    planes, int64 extremes under DESC, -0.0 keys, k above the live rows,
    an empty slot, one slot."""
    c = expr_column
    ti = tpch.table_info(sorted(G_ECOLS), 200, G_ECOLS)

    def sel(where, aggs=(), order=(), limit=None):
        return SelectRequest(start_ts=1, table_info=ti, where=where,
                             aggregates=list(aggs), order_by=list(order),
                             limit=limit)

    def agg(name, cid):
        return Expr(ExprType(AGG_TYPE_BY_NAME[name]), children=[c(cid)])

    def iv(v):
        return expr_value(Datum.i64(v))

    aggs = [agg("count", 1), agg("sum", 3), agg("min", 1), agg("max", 1),
            agg("min", 5), agg("max", 5), agg("max", 3), agg("min", 4)]
    # a < -2^63 keeps no row: two empty slots
    lits = list(range(-40, 40, 3)) + [-(1 << 63)] * 2
    cases = [
        ([sel(expr_op(Op.LT, c(1), iv(x)), aggs) for x in lits],
         "a < x with NULLs, 29 slots, two empty"),
        ([sel(expr_op(Op.OrOr, expr_op(Op.GE, c(2), expr_value(
            Datum.f64(x / 4))), Expr(ExprType.IS_NULL, children=[c(1)])))
          for x in range(-12, 12)], "f >= x or a is null"),
        ([sel(expr_op(Op.EQ, c(4), expr_value(Datum.bytes_(w))))
          for w in G_EWORDS + [b"zz"]], "s = w, one absent"),
        ([sel(expr_op(Op.GT, c(3), expr_value(Datum.dec(Decimal(x)))))
          for x in ("-50.5", "0.25", "99.99")], "d > decimal"),
        ([sel(expr_op(Op.LT, c(1), iv(7)), aggs)], "one slot"),
        ([sel(Expr(ExprType.OPERATOR, op=Op.Not, children=[
            expr_op(Op.EQ, c(1), iv(x))]), order=[ByItem(c(1), True),
                                                 ByItem(c(2), False)],
              limit=128) for x in range(-3, 3)],
         "not (a = x) order by a desc (int64 extremes), f limit 128"),
        ([sel(expr_op(Op.GT, c(1), iv(x)), order=[ByItem(c(2), False)],
              limit=50) for x in (45, 48, 49, 200)],
         "a > x order by f (-0.0) limit 50: k above the live rows"),
        ([sel(expr_op(Op.LE, c(3), iv(x)), order=[
            ByItem(c(4), True), ByItem(c(3), False), ByItem(c(1), True)],
              limit=7) for x in (-5000, 0, 5000)], "three keys limit 7"),
        # K16's edges: slots with no live row, every row live, k above
        # the live rows, four keys, ties that only the row position breaks
        ([sel(expr_op(Op.LT, c(1), iv(x)), order=[ByItem(c(1), True)],
              limit=10) for x in (-(1 << 63), -(1 << 63), 0, 45)],
         "a < x order by a desc limit 10: two slots with no live row"),
        ([sel(k16_all_live(x), order=[ByItem(c(5), False),
                                       ByItem(c(1), True)], limit=128)
          for x in (-(1 << 63), 0, 49)],
         "a >= x or a is null order by g, a desc limit 128: every row live "
         "at x = -2^63"),
        ([sel(expr_op(Op.EQ, c(1), iv(x)), order=[ByItem(c(2), True)],
              limit=100) for x in (7, -3, 1000)],
         "a = x order by f desc limit 100: k above the live rows"),
        ([sel(expr_op(Op.LE, c(3), iv(x)), order=[
            ByItem(c(4), True), ByItem(c(5), False), ByItem(c(1), True),
            ByItem(c(2), False)], limit=100) for x in (-5000, 0, 5000)],
         "four keys limit 100"),
        ([sel(expr_op(Op.GE, c(1), iv(x)), order=[ByItem(c(4), False)],
              limit=100) for x in (-40, 0, 30)],
         "order by s limit 100: ties broken by the row position"),
    ]
    return cases


def k16_all_live(x: int) -> Expr:
    """a >= x or a is null: every row of the edge batch at x = -2^63."""
    a = expr_column(1)
    return expr_op(Op.OrOr, expr_op(Op.GE, a, expr_value(Datum.i64(x))),
                   Expr(ExprType.IS_NULL, children=[a]))


def slot_bytes(a: dict, kernel: str) -> int:
    """Bytes the kernel must move: its planes and live plane read once,
    its outputs written once (K16 reads the mask words in place of the
    program's planes)."""
    n = a["live"].shape[0]
    k = a["pools"].shape[0]
    words = k * n // 8
    prog = _nbytes(a["plane_list"] + [a["live"], a["pools"]])
    if kernel == "slot_filter":
        return prog + words
    if kernel == "slot_agg":
        reds = [t for r in a["reds"] for t in (r.values, r.valid)]
        return _nbytes(a["plane_list"] + [a["live"], a["pools"]] + reds) \
            + k * len(a["reds"]) * 16
    keys = [t for (v, ok), _d in a["keys"] for t in (v, ok)]
    return _nbytes(keys) + words + k * (a["k"] + 1) * 8


def slot_ops(a: dict, kernel: str) -> int:
    """Operations the kernel must do: one per program instruction per row
    and slot (K14), plus one per reduction (K15); K16's comparisons of a
    merge of every slot's live rows down to k, n log2(k + 1) a slot."""
    n = a["live"].shape[0]
    k = a["pools"].shape[0]
    instr = a["fin"].n_instr + 1
    if kernel == "slot_filter":
        return k * n * instr
    if kernel == "slot_agg":
        return k * n * (instr + len(a["reds"]))
    return k * n * max(int(np.log2(a["k"] + 1)), 1) * len(a["keys"])


def g_h2d_copies(a: dict, launches: int = 20,
                 kernel: str = "slot_filter") -> tuple:
    """Host-to-device copies over `launches` calls of K14 (or, kernel
    "slot_topn", of K16 over K14's words) at these inputs (after a warm-up
    call), read from torch.profiler: the card's HtoD memcpy records and
    the host's copy operators (aten::copy_, aten::_to_copy; an aten::to
    that copies nothing, as Tensor.numpy()'s on a host tensor, is not
    one). Returns (the copies' names, the durations in µs of the K14 (or
    K16) kernels the profiler saw on the card, by kernel name: none where
    it traces no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    args = (a["fin"], a["pools"], a["plane_list"], a["live"])
    if kernel == "slot_topn":
        words = kernels.slot_filter(*args)
        call = lambda: kernels.slot_topn(words, a["keys"], a["k"])  # noqa
    else:
        call = lambda: kernels.slot_filter(*args)  # noqa: E731
    call()
    torch.cuda.synchronize()
    before = kernels.LAUNCHES[kernel]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            call()
        torch.cuda.synchronize()
    per = 1 if kernel == "slot_filter" else kernels.slot_topn_launch_count(
        a["pools"].shape[0], a["live"].shape[0], a["k"], len(a["keys"]),
        a["live"].device)
    need(kernels.LAUNCHES[kernel] - before == launches * per,
         f"phase G: the profiled {kernel} launches were not counted")
    copies, seen = [], {}
    for e in prof.events():
        if "Memcpy HtoD" in e.name or e.name in ("aten::copy_",
                                                 "aten::_to_copy"):
            copies.append(e.name)
        elif ("slot_filter_kernel" if kernel == "slot_filter"
              else "k10_level") in e.name:
            seen.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return copies, seen


def phase_g(lineitem, device, seed: int) -> tuple:
    """The tier at TPC-H SF1's supplier table (10,000 rows, capacity
    16,384: under the 16,384-row floor at its real size): the sessions'
    traffic with the tier on and off, K14, K15 and K16 against their
    plain versions, 20 K14 launches at the tier's shape with no
    host-to-device copy (torch.profiler), K14's time beside the launch
    floor (an empty kernel and a [32, 256] readback), and the stress
    shape over Phase B's lineitem. Returns (per-kernel results, the
    launches of the tier's run)."""
    ms = timer(device)
    t0 = time.perf_counter()
    data, words = tpch.supplier(tpch.SF1_SUPPLIERS, seed)
    store = MemStore.from_pairs(tpch.supplier_pairs(data, words))
    rng = np.random.default_rng(seed)
    work = [[(tpch.G_SHAPES[(t + i) % len(tpch.G_SHAPES)], None)
             for i in range(G_PER_THREAD)] for t in range(G_THREADS)]
    work = [[(sh, tpch.g_literal(sh, rng)) for sh, _ in w] for w in work]
    print(f"phase G: {tpch.SF1_SUPPLIERS} supplier rows encoded into the "
          f"store in {time.perf_counter() - t0:.1f} s; {G_THREADS} sessions "
          f"x {G_PER_THREAD} statements")
    # the two modes in turns (tier, solo, solo, tier) within this call:
    # host clocks on a shared machine drift between runs
    runs = {"tier": [], "solo": []}
    for on in (True, False, False, True):
        rows, lat, wall, client, launches = g_traffic(
            store, (data, words), work, on, device)
        mode = "tier" if on else "solo"
        for t, w in enumerate(work):
            for i, (shape, lit) in enumerate(w):
                same_g(rows[(t, i)], tpch.g_expected(shape, lit, data,
                                                     words),
                       f"phase G {mode} {shape} {lit}")
        n = len(lat)
        st = client.stats
        runs[mode].append((rows, launches, n / wall))
        print(f"phase G {mode}: {n} statements equal to numpy in "
              f"{wall:.3f} s: {n / wall:.1f} statements/s, latency p50 "
              f"{np.percentile(lat, 50):.3f} ms p99 "
              f"{np.percentile(lat, 99):.3f} ms (host clock)")
        print(f"  {mode}: small_batched {st['small_batched']} small_solo "
              f"{st['small_solo']} batched launches {st['batched_launches']}"
              f" mean slots per launch "
              f"{st['batched_slots'] / max(st['batched_launches'], 1):.3f} "
              f"slots histogram {dict(sorted(st['batch_sizes'].items()))} "
              f"stall degrades {st['stall_degrades']}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    first = runs["tier"][0][0]
    need(all(r[0] == first for mode in runs for r in runs[mode]),
         "phase G: the runs answered differently")
    print("phase G in turns (tier, solo, solo, tier): tier " + ", ".join(
        f"{r[2]:.1f}" for r in runs["tier"]) + " statements/s; solo "
        + ", ".join(f"{r[2]:.1f}" for r in runs["solo"]))
    launches = runs["tier"][0][1]
    if device.type == "cuda":
        for k in SLOT_KERNELS:
            need(launches[k] > 0, f"kernel {k} never launched in phase G")
    need(all(r[1][k] == 0 for r in runs["solo"] for k in SLOT_KERNELS),
         "phase G: the solo run launched a slot kernel")
    # one session alone: each shape's statement time on the solo route
    # (the traffic gate keeps a lone thread there), median of 20
    client = GpuClient(store, device)
    alone = {}
    for shape in tpch.G_SHAPES:
        req = tpch.g_statement(shape, 7)
        alone[shape] = host_ms(lambda: client.send(req).next(), 20)
    need(client.stats["small_batched"] == 0, "phase G: a lone session "
         "took the tier")
    print("phase G: one session, statement time by shape (ms, median of "
          "20, host clock): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in alone.items()))

    # the kernels at the tier's shape: 32 statements on the supplier batch
    client = GpuClient(store, device)
    for shape in tpch.G_SHAPES:
        client.send(tpch.g_statement(shape, 0)).next()
    out, err = {}, {k: 0.0 for k in SLOT_KERNELS}
    tier = {}
    for shape in ("g_nation", "g_agg", "g_topn"):
        reqs = [tpch.g_statement(shape, x % 25) for x in range(32)]
        batch = client._get_batch(reqs[0].data, reqs[0].key_ranges)
        tier[shape] = slot_inputs(batch, [r.data for r in reqs], device)
        for kname, e in check_slots(tier[shape], f"K14-16 {shape}").items():
            err[kname] = max(err[kname], e)
    one = slot_inputs(batch, [reqs[0].data], device)
    for kname, e in check_slots(one, "K14-16 one slot").items():
        err[kname] = max(err[kname], e)
    eb = g_edge_batch(seed + 3)
    for sels, what in g_edge_cases(eb):
        for kname, e in check_slots(slot_inputs(eb, sels, device),
                                    f"edge {what}").items():
            err[kname] = max(err[kname], e)
    # K16 past one round of K10's level kernel (k above the largest K a
    # block holds, which the tier's lowering never asks: its k is at most
    # 128), and above the live rows, with every row live in one slot;
    # over two and over four keys
    c = expr_column
    ti = tpch.table_info(sorted(G_ECOLS), 200, G_ECOLS)
    for order in ([ByItem(c(5), False), ByItem(c(1), True)],
                  [ByItem(c(4), True), ByItem(c(5), False),
                   ByItem(c(1), True), ByItem(c(2), False)]):
        sels = [SelectRequest(start_ts=1, table_info=ti,
                              where=k16_all_live(x), order_by=order,
                              limit=100) for x in (-(1 << 63), 0)]
        a = slot_inputs(eb, sels, device)
        a["k"] = 5000
        nk = len(a["keys"])
        n_e = a["live"].shape[0]
        need(device.type != "cuda" or len(kernels.shard_topk_plan(
            2, n_e, min(a["k"], n_e), nk, lambda sl: 264)) > 1,
             "phase G: K16's edge at k 5000 runs one round")
        err["slot_topn"] = max(err["slot_topn"], check_slots(
            a, f"edge: k 5000 past one round, {nk} keys")["slot_topn"])
    print("phase G: K14, K15 and K16 equal their plain versions at k = 32 "
          "on the supplier batch, one slot, and edge cases (K16: no live "
          "row, every row live, k above the live rows and past one round, "
          "four keys, ties)")

    def timed(a: dict, kernel: str, runs_: int = 20) -> dict:
        args = (a["fin"], a["pools"], a["plane_list"], a["live"])
        if kernel == "slot_filter":
            kern = lambda: kernels.slot_filter(*args)  # noqa: E731
            plain = lambda: kernels.slot_filter_plain(*args)  # noqa: E731
        elif kernel == "slot_agg":
            kern = lambda: kernels.slot_agg(*args, a["reds"])  # noqa: E731
            plain = lambda: kernels.slot_agg_plain(  # noqa: E731
                *args, a["reds"])
        else:
            words_ = kernels.slot_filter(*args)
            kern = lambda: kernels.slot_topn(  # noqa: E731
                words_, a["keys"], a["k"])
            plain = lambda: kernels.slot_topn_plain(  # noqa: E731
                words_, a["keys"], a["k"])
        return dict(ms=ms(kern, runs=runs_),
                    plain_ms=ms(plain, runs=max(runs_ // 4, 3)),
                    library_ms=None, max_abs_err=err[kernel],
                    bound=bound(slot_bytes(a, kernel), slot_ops(a, kernel)))

    for kname, shape in zip(SLOT_KERNELS, ("g_nation", "g_agg", "g_topn")):
        out[kname] = timed(tier[shape], kname)
    # K16's yardstick: one torch.topk over g_topn's two keys as one int64
    # score a slot (s_acctbal * 2^14 - s_suppkey: the balance descending,
    # then the supplier key ascending, which is unique and below 2^14;
    # dead rows at -2^63), k 100: the same rows at this shape
    a = tier["g_topn"]
    (bal, _bok), _d0 = a["keys"][0]
    (supp, _sok), _d1 = a["keys"][1]
    live16 = kernels.unpack_slot_words(kernels.slot_filter(
        a["fin"], a["pools"], a["plane_list"], a["live"]))
    score = torch.where(live16, bal.view(1, -1) * (1 << 14) - supp.view(1, -1),
                        torch.full_like(live16, kernels.I64_MIN,
                                        dtype=torch.int64))
    out["slot_topn"]["library_ms"] = ms(lambda: torch.topk(score, a["k"],
                                                           dim=1))
    if device.type == "cuda":
        n16, nk16 = a["live"].shape[0], len(a["keys"])
        per16 = kernels.slot_topn_launch_count(32, n16, a["k"], nk16, device)
        out["slot_topn"]["launches_per_call"] = per16
        copies16, by_name16 = g_h2d_copies(a, kernel="slot_topn")
        need(not copies16, f"phase G: {len(copies16)} host-to-device copies "
             f"over 20 K16 calls at the tier's shape: {set(copies16)}")
        seen16 = [d for ds in by_name16.values() for d in ds]
        out["slot_topn"]["device_us"] = sum(seen16) / 20 if seen16 else None
        levels16 = {name.split("(")[0]: float(np.median(ds))
                    for name, ds in by_name16.items()}
        print(f"phase G: K16 at the tier's shape (32 slots x {n16} rows, "
              f"{nk16} keys, k {a['k']}): {per16} kernel launches a call "
              f"(kernels.shard_topk_plan); {len(copies16)} host-to-device "
              f"copies over 20 calls ({20 * per16} launches; "
              f"torch.profiler, {len(seen16)} level kernels traced, "
              f"{out['slot_topn']['device_us']} µs a call on the card; "
              f"median µs by kernel {levels16}); torch.topk over the "
              f"composite score {out['slot_topn']['library_ms']:.4f} ms")
    if device.type == "cuda":
        # K14 at the tier's shape copies nothing to the card per launch
        a = tier["g_nation"]
        copies, by_name = g_h2d_copies(a)
        seen = [d for ds in by_name.values() for d in ds]
        need(not copies, f"phase G: {len(copies)} host-to-device copies "
             f"over 20 K14 launches at the tier's shape: {set(copies)}")
        r = out["slot_filter"]
        r["device_us"] = float(np.median(seen)) if seen else None
        print(f"phase G: 20 K14 launches at the tier's shape (32 slots x "
              f"{a['live'].shape[0]} rows): {len(copies)} host-to-device "
              f"copies (torch.profiler; {len(seen)} K14 kernels traced on "
              f"the card, median {r['device_us']} µs each)")
        # the launch floor beside the bytes bound: an empty kernel and the
        # readback of a [32, 256] int64 block into page-locked memory; and
        # K14 with its words read back the same way, as the tier reads
        # them
        args = (a["fin"], a["pools"], a["plane_list"], a["live"])
        words_ = kernels.slot_filter(*args)
        need(tuple(words_.shape) == (32, 256), "phase G: the tier's words "
             f"are {tuple(words_.shape)}, not [32, 256]")
        r["floor_ms"] = ms(lambda: (torch.cuda._sleep(0),
                                    kernels.to_host(words_)))
        r["readback_ms"] = ms(lambda: kernels.to_host(
            kernels.slot_filter(*args)))
        # the same launch in the larger parameter block: pools padded to
        # more words than the smaller block holds (the program reads
        # only its own slots of a row)
        wide = torch.zeros((32, kernels.SLOT_BLOCKS[0][1] // 32 + 1),
                           dtype=torch.int64)
        wide[:, :a["pools"].shape[1]] = a["pools"]
        wargs = (a["fin"], wide, a["plane_list"], a["live"])
        need(torch.equal(kernels.slot_filter(*wargs), words_),
             "phase G: K14 in the larger parameter block differs")
        r["large_block_ms"] = ms(lambda: kernels.slot_filter(*wargs))
        print(f"phase G: K14 at the tier's shape {r['ms']:.4f} ms, with its "
              f"words read back into page-locked memory "
              f"{r['readback_ms']:.4f} ms; the launch floor (an empty "
              f"kernel and a [32, 256] int64 readback) {r['floor_ms']:.4f} "
              f"ms; the bytes bound {r['bound'][0]:.6f} ms; in the larger "
              f"parameter block (pools padded past the smaller's) "
              f"{r['large_block_ms']:.4f} ms")
    # the stress shape: 32 statements over Phase B's SF1 lineitem planes
    c = expr_column
    ti = tpch.table_info([tpch.C_ORDERKEY, tpch.C_QUANTITY,
                          tpch.C_EXTENDEDPRICE, tpch.C_SHIPDATE])
    one_ = expr_value(Datum.i64(1))
    stress = []
    for j in range(32):
        where = expr_op(Op.AndAnd, expr_op(
            Op.LT, c(tpch.C_QUANTITY), expr_value(Datum.dec(Decimal(
                10 + j)))), expr_op(Op.LE, c(tpch.C_SHIPDATE), expr_value(
                    tpch._date(f"199{2 + j % 7}-0{1 + j % 9}-15"))))
        stress.append(SelectRequest(
            start_ts=1, table_info=ti, where=where,
            aggregates=[expr_agg("count", [one_]),
                        expr_agg("sum", [c(tpch.C_QUANTITY)]),
                        expr_agg("max", [c(tpch.C_EXTENDEDPRICE)])],
            order_by=[ByItem(c(tpch.C_EXTENDEDPRICE), True),
                      ByItem(c(tpch.C_ORDERKEY), False)], limit=100))
    sa = slot_inputs(lineitem, stress, device)
    for kname, e in check_slots(sa, "K14-16 stress").items():
        err[kname] = max(err[kname], e)
    for kname in SLOT_KERNELS:
        r = timed(sa, kname, runs_=5)
        out[kname]["stress"] = r
        print(f"phase G stress (32 slots over {lineitem.capacity} lineitem "
              f"rows): {kname} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.4f} ms by {r['bound'][1]}")
    if device.type == "cuda":
        per = kernels.slot_topn_launch_count(
            32, sa["live"].shape[0], sa["k"], len(sa["keys"]), device)
        out["slot_topn"]["stress"]["launches_per_call"] = per
        print(f"phase G stress: K16 {per} kernel launches a call")
    for kname in SLOT_KERNELS:
        out[kname]["max_abs_err"] = err[kname]
        r = out[kname]
        print(f"  {kname} at the tier's shape: {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    return out, launches


# ---------------------------------------------------------------------------
# Phase H: sort and windows at SF1 (slice 6)
# ---------------------------------------------------------------------------

SORT_KERNELS = ("sort_perm", "window_scan")
# lineitem columns of Phase H's scans, in output order
H_CIDS = [tpch.C_ORDERKEY, tpch.C_EXTENDEDPRICE, tpch.C_LINENUMBER,
          tpch.C_SUPPKEY, tpch.C_QUANTITY]
H_ORDERKEY, H_PRICE, H_LINENUMBER, H_SUPPKEY, H_QUANTITY = range(5)
# orders columns of the joins (output columns 5 and 6)
H_OCIDS = [tpch.O_ORDERKEY, tpch.O_CUSTKEY]


def h_col(i: int) -> "plan.Column":
    if i < len(H_CIDS):
        return tpch.column(tpch.TABLE_ID, H_CIDS[i], i)
    return tpch.column(tpch.ORDERS_ID, H_OCIDS[i - len(H_CIDS)], i)


def h_by() -> list:
    """ORDER BY l_extendedprice DESC, l_orderkey."""
    return [plan.SortItem(h_col(H_PRICE), True),
            plan.SortItem(h_col(H_ORDERKEY), False)]


def h_scan(client, batch, where=None, table_id=tpch.TABLE_ID, cids=H_CIDS):
    sel = tpch.scan_request(table_id, cids, where)
    req = tpch.store_request(sel)
    client.admit(sel, req.key_ranges, batch)
    return XSelectTableExec(client, sel, req.key_ranges)


def h_join(client, batch, obatch, where=None):
    """lineitem ⋈ orders on the order key (every line matches its order)."""
    join = plan.Join(plan.Join.INNER)
    join.eq_conditions = [(h_col(H_ORDERKEY), tpch.column(
        tpch.ORDERS_ID, tpch.O_ORDERKEY, 0))]
    return HashJoinExec(h_scan(client, batch, where),
                        h_scan(client, obatch, None, tpch.ORDERS_ID,
                               H_OCIDS), join)


def h_expected(data: dict, rows) -> list:
    """numpy's rows (orderkey, price cents, linenumber, suppkey, quantity
    cents) of lineitem rows `rows` of `data`, the join's orders columns
    (orderkey, custkey) looked up by key."""
    return [data[tpch.C_ORDERKEY][rows], data[tpch.C_EXTENDEDPRICE][rows],
            data[tpch.C_LINENUMBER][rows], data[tpch.C_SUPPKEY][rows],
            data[tpch.C_QUANTITY][rows]]


def h_values(rows: list) -> list:
    """Gathered rows as columns of ints (decimals in cents)."""
    out = []
    for j in range(len(rows[0]) if rows else 0):
        col_j = []
        for r in rows:
            v = r[j].val
            col_j.append(int(v.scaleb(2)) if isinstance(v, Decimal) else v)
        out.append(np.asarray(col_j, np.int64))
    return out


def sort_budget(est: int) -> int:
    """A budget whose pass target (extsort._pass_target: the headroom,
    floored at budget // 8) is about a quarter of the estimate, whatever
    the resident planes already pin."""
    used = sum(membudget.usage())
    return used + est // 4 if used <= 7 * est // 4 else 2 * est


def h_edge_planes(n: int, seed: int) -> list:
    """K17 edge planes: DESC int64 extremes, signed zeros, NaN, +-inf and
    subnormals, int8 NULL planes, an int32 key, few distinct values."""
    rng = np.random.default_rng(seed)
    ext = np.array([col.I64_MIN, col.I64_MAX, 0, -1, 1], np.int64)
    f = np.array([-0.0, 0.0, 1.5, np.nan, -np.inf, np.inf, -2.0, 5e-324],
                 np.float64)
    return [~rng.choice(ext, n), (rng.random(n) < 0.2).astype(np.int8),
            rng.choice(f, n), rng.integers(-2, 2, n).astype(np.int32),
            rng.choice(ext, n), np.ones(n, np.int8)]


def check_k17(planes: list, device, what: str, max_rows=None) -> float:
    """K17 on the card against np.lexsort and its plain version on the
    card, bit for bit (max_abs_err 0), run twice for the same permutation;
    a one-word plan's sorted words equal to the plain pack's. max_rows: a
    row limit for kernels._k17_sort (its split past the limit)."""
    n = len(planes[0])
    ts = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
          for p in planes]
    if max_rows is None or device.type != "cuda":
        got, words, plan, _pairs = kernels.sort_perm_words(ts, n)
        again = kernels.sort_perm(ts, n)
    else:
        got, words, plan, _pairs = kernels._k17_sort(ts, n, device, max_rows)
        again = kernels._k17_sort(ts, n, device, max_rows)[0]
    if device.type == "cuda":
        torch.cuda.synchronize()
    plain = kernels.sort_perm_plain(ts, n)
    want = np.lexsort(planes) if n else np.zeros(0, np.int64)
    g = got.cpu().numpy()
    need(np.array_equal(g, want), f"{what}: K17 differs from np.lexsort")
    need(np.array_equal(g, plain.cpu().numpy()),
         f"{what}: K17 differs from its plain version")
    need(torch.equal(got, again), f"{what}: two runs of K17 differ")
    if words is not None:
        need(torch.equal(words, kernels.sort_pack_plain(
            ts, plan[0][0] if plan else (), got)),
             f"{what}: K17's sorted words differ from the plain pack's")
    return 0.0


def k17_edge_sets(seed: int) -> list:
    """(planes, what, max_rows) past Phase H's edge planes: widths that
    cross 64 bits, uint8 and bool flags, one-, two- and three-word plans,
    and a split past a small row limit."""
    rng = np.random.default_rng(seed)
    m = 300_000

    def width(w: int) -> np.ndarray:
        p = rng.integers(0, 1 << 62, m) >> (62 - w) if w < 63 else \
            rng.integers(col.I64_MIN, col.I64_MAX, m, endpoint=True)
        p[0], p[1] = (0, (1 << w) - 1) if w < 63 else (col.I64_MIN,
                                                       col.I64_MAX)
        return p

    flag = (rng.random(m) < 0.4).astype(np.uint8)
    return [
        ([width(31), flag, width(32)], "one word of 64 bits", None),
        ([width(33), width(32)], "65 bits in two words", None),
        ([width(40), flag, width(30)], "two words, a uint8 flag", None),
        ([width(7), width(64), rng.random(m) < 0.5, width(50)],
         "three words, a bool flag", None),
        ([flag, rng.random(m) < 0.5, rng.integers(0, 3, m).astype(np.int8)],
         "uint8 and bool flags", None),
        ([rng.integers(0, 1 << 8, m), (rng.random(m) < 0.1).astype(np.int8),
          np.where(np.arange(m) < m // 2, 1, rng.integers(0, 3, m))],
         "split past 4000 rows", 4000),
    ]


def h_window_inputs(n: int, nparts: int, seed: int, device):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, max(nparts, 1), n)).astype(np.int64)
    chg = np.zeros(n, bool)
    chg[1:] = (seg[1:] != seg[:-1]) | (rng.random(max(n - 1, 0)) < 0.3)
    peer = np.cumsum(chg).astype(np.int64)
    vals = rng.choice(np.array([col.I64_MAX, col.I64_MIN, 5, -7, 1 << 62],
                               np.int64), n)
    ok = rng.random(n) < 0.6
    ok[: n // 7] = False
    t = (lambda a: torch.from_numpy(a).to(device))
    specs = [("row_number", None, None), ("rank", None, None),
             ("dense_rank", None, None), ("sum", t(vals), t(ok)),
             ("count", None, t(ok)), ("min", t(vals), t(ok)),
             ("max", t(vals), t(ok))]
    return t(seg), t(peer), specs


def check_k18(seg, peer, specs, what: str) -> float:
    n = seg.shape[0]
    got = kernels.window_scan(seg, peer, specs, n)
    if seg.device.type == "cuda":
        torch.cuda.synchronize()
    want = kernels.window_scan_plain(seg, peer, specs, n)
    err = 0.0
    for (op, _v, _c), g, w in zip(specs, got, want):
        need(torch.equal(g, w), f"{what}: K18 {op} differs from its plain "
             f"version")
    return err


def window_oracle(orderkey, linenumber, suppkey):
    """numpy's figures of the Phase H window calls, over rows sorted by
    (orderkey, linenumber): each order a partition, each line a peer
    group (line numbers are distinct within an order)."""
    order = np.lexsort((linenumber, orderkey))
    ok_s, v_s = orderkey[order], suppkey[order]
    n = len(order)
    starts = np.flatnonzero(np.r_[True, ok_s[1:] != ok_s[:-1]])
    s = np.repeat(starts, np.diff(np.r_[starts, n]))
    rn = np.arange(n) - s + 1
    cs = np.cumsum(v_s)
    run_sum = cs - (cs[s] - v_s[s])
    mn = np.empty(n, np.int64)
    mx = np.empty(n, np.int64)
    for a, b in zip(starts, np.r_[starts[1:], n]):
        mn[a:b] = np.minimum.accumulate(v_s[a:b])
        mx[a:b] = np.maximum.accumulate(v_s[a:b])
    figs = {"row_number": rn, "rank": rn, "dense_rank": rn,
            "sum": run_sum, "count": rn, "min": mn, "max": mx}
    out = {}
    for k, v in figs.items():
        back = np.empty(n, np.int64)
        back[order] = v
        out[k] = back
    return out


H_WINDOWS = ("row_number", "rank", "dense_rank", "sum", "count", "min",
             "max")


def h_window_descs() -> list:
    """PARTITION BY l_orderkey ORDER BY l_linenumber, reductions over
    l_suppkey (an integer column: decimal arguments raise Unsupported)."""
    part = [h_col(H_ORDERKEY)]
    by = [plan.SortItem(h_col(H_LINENUMBER), False)]
    return [plan.WindowFuncDesc(
        name, [] if name in window.RANKING_FUNCS else [h_col(H_SUPPKEY)],
        part, by) for name in H_WINDOWS]


def phase_h(data: dict, batch, device, seed: int,
            small_rows: int = tpch.SF001_ROWS) -> tuple:
    """Returns (per-kernel results, launches); `data` and `batch` Phase B's
    SF1 lineitem, generated from `seed`."""
    ms = timer(device)
    cuda = device.type == "cuda"
    auto = "auto" if cuda else 1 << 40     # no card: a budget of our own
    t0 = time.perf_counter()
    n = batch.n_rows
    obatch = tpch.join_batch({tpch.ORDERS_ID: tpch.orders(data, seed)},
                             tpch.ORDERS_ID)
    sdata = tpch.generate(small_rows, seed + 1)
    sbatch = tpch.batch(sdata, H_CIDS)
    client = GpuClient(MemStore([], []), device)
    membudget.set_budget(auto)
    print(f"phase H: orders {obatch.n_rows} rows, SF0.01 lineitem "
          f"{sbatch.n_rows} rows built in {time.perf_counter() - t0:.1f} s; "
          f"budget {membudget.budget_bytes()} B, pinned "
          f"{membudget.usage()[1]} B")
    zero_launches()
    stats = {}

    # ORDER BY l_extendedprice DESC, l_orderkey over SF1 lineitem: one K17
    # pass under the auto budget, then passes under a quarter of it
    t1 = time.perf_counter()
    res = h_scan(client, batch).columnar_result()
    keys = executors._plane_sort_keys(res, h_by(), len(H_CIDS))
    need(keys is not None and len(keys) == 4, "phase H: key planes")
    want = np.lexsort(keys)
    st: dict = {}
    order = extsort.sort_order(keys, n, stats=st, device=device)
    need(not st and np.array_equal(order, want),
         "phase H: one-pass ORDER BY differs from np.lexsort")
    est = extsort.sort_bytes_estimate(keys, n)
    membudget.set_budget(sort_budget(est))
    st = {}
    order = extsort.sort_order(keys, n, stats=st, device=device)
    membudget.set_budget(auto)
    need(np.array_equal(order, want),
         "phase H: partitioned ORDER BY differs from np.lexsort")
    need(st["sort_passes"] >= 4, f"phase H: {st['sort_passes']} passes")
    stats["order_by"] = {k: st[k] for k in ("sort_passes", "sort_partitions",
                                           "sort_escalations", "sort_salted")}
    stats["order_by"]["estimate_bytes"] = est
    print(f"  ORDER BY at SF1: one pass and {st['sort_passes']} passes over "
          f"{st['sort_partitions']} partitions ({st['sort_escalations']} "
          f"escalations), both equal to np.lexsort "
          f"({time.perf_counter() - t1:.1f} s)")

    # join → TopN 100 and a filtered join → ORDER BY
    t1 = time.perf_counter()
    join = h_join(client, batch, obatch)
    top = executors.TopNExec(join, h_by(), 0, 100)
    rows = top.drain()
    need(join.join_stats.get("sort_plane"), "phase H: TopN off the planes")
    need(len(join.device_join_result()) == n,
         "phase H: every line must match its order")
    li = want[:100]
    exp = h_expected(data, li)
    got = h_values(rows)
    need(all(np.array_equal(g, e) for g, e in zip(got[:5], exp)),
         "phase H: join TopN differs from numpy")
    need(np.array_equal(got[5], data[tpch.C_ORDERKEY][li]),
         "phase H: join TopN orders key")
    print(f"  join → TopN 100 over {len(join.device_join_result())} pairs: "
          f"equal to numpy ({time.perf_counter() - t1:.1f} s)")
    t1 = time.perf_counter()
    where = expr_op(Op.LT, expr_column(tpch.C_QUANTITY),
                    expr_value(Datum.dec(Decimal("2"))))
    fjoin = h_join(client, batch, obatch, where)
    srt = executors.SortExec(fjoin, h_by())
    rows = srt.drain()
    keep = np.flatnonzero(data[tpch.C_QUANTITY] < 200)
    fk = [k[keep] for k in keys]
    li = keep[np.lexsort(fk)]
    exp = h_expected(data, li)
    got = h_values(rows)
    need(len(rows) == len(li) and all(np.array_equal(g, e)
                                      for g, e in zip(got[:5], exp)),
         "phase H: join ORDER BY differs from numpy")
    stats["join_order_by"] = {"rows": len(rows)}
    print(f"  join → ORDER BY: {len(rows)} rows equal to numpy "
          f"({time.perf_counter() - t1:.1f} s)")

    # windows: K18 at SF1 on the sorted planes, partition by l_orderkey
    # order by l_linenumber (sum / min / max of l_quantity in cents)
    t1 = time.perf_counter()
    wkeys = executors._plane_sort_keys(
        res, [plan.SortItem(h_col(H_ORDERKEY)),
               plan.SortItem(h_col(H_LINENUMBER))], len(H_CIDS))
    worder = extsort.sort_order(wkeys, n, device=device)
    okey = data[tpch.C_ORDERKEY][worder]
    seg = np.cumsum(np.r_[False, okey[1:] != okey[:-1]]).astype(np.int64)
    peer = np.arange(n, dtype=np.int64)      # line numbers are distinct
    qty = data[tpch.C_QUANTITY][worder]
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    dseg, dpeer, dq = t(seg), t(peer), t(qty)
    dok = torch.ones(n, dtype=torch.bool, device=device)
    sf1_specs = [("row_number", None, None), ("rank", None, None),
                 ("dense_rank", None, None), ("sum", dq, dok),
                 ("count", None, dok), ("min", dq, dok), ("max", dq, dok)]
    figs = kernels.window_scan(dseg, dpeer, sf1_specs, n)
    oracle = window_oracle(data[tpch.C_ORDERKEY][worder],
                           data[tpch.C_LINENUMBER][worder], qty)
    for (op, _v, _c), f in zip(sf1_specs, figs):
        need(np.array_equal(f.cpu().numpy(), oracle[op]),
             f"phase H: K18 {op} at SF1 differs from numpy")
    print(f"  K18 at SF1: {int(seg[-1]) + 1} partitions, seven figures "
          f"equal to numpy ({time.perf_counter() - t1:.1f} s)")

    # WindowExec over SF0.01 lineitem (above the floor): card, in passes,
    # and the plain versions
    t1 = time.perf_counter()
    descs = h_window_descs()
    wex = window.WindowExec(h_scan(client, sbatch), descs)
    wrows = wex.drain()
    need(wex.stats["windows"] == len(descs), f"phase H: {wex.stats}")
    w_or = window_oracle(sdata[tpch.C_ORDERKEY], sdata[tpch.C_LINENUMBER],
                         sdata[tpch.C_SUPPKEY])
    for j, name in enumerate(H_WINDOWS):
        col_j = np.asarray([int(r[len(H_CIDS) + j].val) for r in wrows],
                           np.int64)
        need(np.array_equal(col_j, w_or[name]),
             f"phase H: WindowExec {name} differs from numpy")
    wstat = dict(wex.stats)
    row_bytes = window.WINDOW_ROW_BYTES + window.WINDOW_SPEC_BYTES + 16
    membudget.set_budget(sum(membudget.usage())
                         + sbatch.n_rows * row_bytes // 3)
    pex = window.WindowExec(h_scan(client, sbatch), descs[3:4])
    prow = pex.drain()
    membudget.set_budget(auto)
    need(pex.stats["window_passes"] >= 2, f"phase H: {pex.stats}")
    need([r[-1].val for r in prow] == [r[len(H_CIDS) + 3].val
                                       for r in wrows],
         "phase H: WindowExec in passes differs")
    cpu_client = GpuClient(MemStore([], []), "cpu")
    cex = window.WindowExec(h_scan(cpu_client, sbatch), descs)
    crows = cex.drain()
    need([[d.val for d in r] for r in crows]
         == [[d.val for d in r] for r in wrows],
         "phase H: WindowExec differs from the plain versions")
    stats["window_exec"] = {"rows": len(wrows), "card": wstat,
                            "passes": pex.stats["window_passes"]}
    # where a window statement's time goes (host clock, phases bracketed
    # by synchronisations), and the filtered join → ORDER BY's
    for what, make in (
            ("window_exec", lambda: window.WindowExec(h_scan(client, sbatch),
                                                      descs)),
            ("join_order_by", lambda: executors.SortExec(
                h_join(client, batch, obatch, where), h_by()))):
        kernels.SPLIT = {}
        t2 = time.perf_counter()
        make().drain()
        if cuda:
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t2) * 1e3
        split, kernels.SPLIT = kernels.SPLIT, None
        stats.setdefault(what, {})
        stats[what].update(ms=wall, split_ms=split)
        print(f"  {what}: {wall:.1f} ms (host clock); split " + ", ".join(
            f"{k} {v:.1f}" for k, v in split.items()))
    print(f"  WindowExec over {len(wrows)} rows: seven calls equal to numpy "
          f"and the plain versions; {pex.stats['window_passes']} passes in "
          f"the over-headroom run ({time.perf_counter() - t1:.1f} s)")
    launches = dict(kernels.LAUNCHES)
    for k in SORT_KERNELS:
        need(launches[k] > 0 or not cuda, f"phase H: {k} never launched")
    print(f"phase H launches: { {k: launches[k] for k in SORT_KERNELS} }")

    # K17 and K18 against their plain versions at SF1 and on edge cases
    out = {}
    err = check_k17(keys, device, "K17 SF1 ORDER BY")
    err = max(err, check_k17(wkeys, device, "K17 SF1 window keys"))
    for en in (0, 1, 2, 33, 2047, 2048, 2049, 4095, 4096, 4097, 100_000):
        err = max(err, check_k17(h_edge_planes(en, en), device,
                                 f"K17 edge n={en}"))
    err = max(err, check_k17([np.zeros(50_000, np.int64),
                              np.ones(50_000, np.int8)], device,
                             "K17 all tied"))
    for planes, what, max_rows in k17_edge_sets(seed + 7):
        err = max(err, check_k17(planes, device, f"K17 {what}", max_rows))
    tk = [t(k) for k in keys]
    lib = [t(k) for k in keys]
    k17_plan = kernels.sort_perm_words(tk, n)[2]
    peak = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.sort_perm(tk, n)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # the split past K17's row limit (2^31 - 1), here at a third of the
        # rows: the same permutation within the same four buffers
        torch.cuda.reset_peak_memory_stats()
        got = kernels._k17_sort(tk, n, device, n // 3)[0]
        torch.cuda.synchronize()
        split_peak = torch.cuda.max_memory_allocated() - base
        need(torch.equal(got, kernels.sort_perm(tk, n)),
             "phase H: K17 split at a third of the rows differs")
        print(f"  K17 split at a limit of {n // 3} rows: equal; peak device "
              f"memory over its inputs {split_peak} B "
              f"({split_peak / n:.2f} B a row)")
        del got
    out["sort_perm"] = dict(
        ms=ms(lambda: kernels.sort_perm(tk, n)),
        plain_ms=ms(lambda: kernels.sort_perm_plain(tk, n)),
        library_ms=ms(lambda: _chained_torch_sort(lib)),
        max_abs_err=err,
        bound=bound(sum(k.nbytes for k in keys) + 8 * n, 0))
    print(f"  K17 at the ORDER BY ({n} rows, {len(keys)} planes): plan "
          f"{plan_text(k17_plan)}; peak device memory over its inputs "
          f"{peak} B "
          f"({'not measured' if peak is None else f'{peak / n:.2f}'} B a "
          f"row; two word and two permutation buffers are 32 B a row)")
    err = check_k18(dseg, dpeer, sf1_specs, "K18 SF1")
    # tied peers at SF1: partition by l_orderkey order by l_tax (nine
    # values, so lines of one order share a peer group)
    tord = np.lexsort((data[tpch.C_TAX], data[tpch.C_ORDERKEY]))
    tkey, ttax = data[tpch.C_ORDERKEY][tord], data[tpch.C_TAX][tord]
    tseg = np.r_[False, tkey[1:] != tkey[:-1]]
    tpeer = np.cumsum(tseg | np.r_[False, ttax[1:] != ttax[:-1]])
    need(int(tpeer[-1]) < n - 1, "phase H: the tied K18 check has no ties")
    tq = t(data[tpch.C_QUANTITY][tord])
    err = max(err, check_k18(
        t(np.cumsum(tseg)), t(tpeer),
        [(op, None if v is None else tq, c) for op, v, c in sf1_specs],
        "K18 SF1 tied peers"))
    del tord, tkey, ttax, tseg, tpeer, tq
    for en, parts in ((1, 1), (2, 2), (2049, 1), (5000, 40), (100_000, 3),
                      (100_000, 100_000), (4097, 4097)):
        err = max(err, check_k18(*h_window_inputs(en, parts, en + parts,
                                                  device),
                                 f"K18 edge n={en} parts={parts}"))
    ts_specs = [("sum", dq, dok), ("count", None, dok)]
    out["window_scan"] = dict(
        ms=ms(lambda: kernels.window_scan(dseg, dpeer, ts_specs, n)),
        plain_ms=ms(lambda: kernels.window_scan_plain(dseg, dpeer, ts_specs,
                                                      n)),
        library_ms=None, max_abs_err=err,
        bound=bound(n * (8 + 8 + 8 + 1 + 8 * 2), 0))
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    print("phase H: " + json.dumps(stats))
    membudget.set_budget(0)
    return out, launches


# ---------------------------------------------------------------------------
# Phase I: the HTAP freshness tier (slice 7)
# ---------------------------------------------------------------------------

DELTA_KERNELS = ("delta_merge_order",)


def k19_case(n_rows: int, cap: int, n_tomb: int, app_mode: str, seed: int,
             tomb_all: bool = False, k: int | None = None):
    """numpy (handles [cap], live, tomb, app) of one merge: ascending
    unique live handles (multiples of 3) over [0, n_rows), padding
    I64_MIN; tombstones drawn from the live handles (or all of them) plus
    absent ones (3x + 1); appended handles before, after or between the
    base's ("between": updates, i.e. tombstoned handles, and new 3x + 2
    handles; "ties": also kept base handles), or none. `k` fixes the
    appended count (random below 300 otherwise)."""
    rng = np.random.default_rng(seed)
    h = np.full(cap, col.I64_MIN, np.int64)
    base = np.sort(rng.choice(np.arange(1, 40 * max(n_rows, 1)), n_rows,
                              replace=False)).astype(np.int64) * 3
    h[:n_rows] = base
    live = np.arange(cap) < n_rows
    if tomb_all:
        tomb = base.copy()
    else:
        hit = rng.choice(base, min(n_tomb, n_rows), replace=False)
        miss = rng.integers(1, 1 << 40, n_tomb // 4) * 3 + 1
        tomb = np.unique(np.concatenate([hit, miss])).astype(np.int64)
    if k is None:
        k = 0 if app_mode == "none" else int(rng.integers(1, 300))
    if app_mode == "before":
        app = -np.arange(k, 0, -1, dtype=np.int64)
    elif app_mode == "after":
        app = (int(base.max()) if n_rows else 0) + np.arange(1, k + 1)
    elif app_mode in ("between", "ties"):
        upd = rng.choice(tomb, min(k // 2, len(tomb)), replace=False) \
            if len(tomb) else np.zeros(0, np.int64)
        new = rng.integers(0, 40 * max(n_rows, 1), k - len(upd)) * 3 + 2
        if app_mode == "ties":
            new[: len(new) // 2] = rng.choice(base, len(new) // 2)
        app = np.sort(np.concatenate([upd, new]))
    else:
        app = np.zeros(0, np.int64)
    return h, live, tomb.astype(np.int64), np.asarray(app, np.int64)


# (name, n_rows, cap, tombstones, appended mode, all tombstoned, k)
K19_EDGES = [
    ("interleaved", 3000, 4096, 200, "between", False, None),
    ("empty_tomb", 3000, 4096, 0, "between", False, None),
    ("empty_app", 3000, 4096, 150, "none", False, None),
    ("all_tombstoned", 500, 1024, 0, "between", True, None),
    ("app_before", 700, 1024, 30, "before", False, None),
    ("app_after", 700, 1024, 30, "after", False, None),
    ("padding", 37, 1024, 5, "between", False, None),
    ("at_floor", 4096, 4096, 300, "between", False, None),
    ("empty_base", 0, 1024, 0, "after", False, None),
    ("ties_with_kept_rows", 5000, 8192, 400, "ties", False, 2000),
    ("tomb_past_shared_memory", 100_000, 131_072, 40_000, "between", False,
     300),
    ("app_past_shared_memory", 100_000, 131_072, 500, "between", False,
     30_000),
]


def check_k19(h, live, tomb, app, what: str) -> float:
    """K19 against its plain version on the card, bit for bit."""
    got = kernels.delta_merge_order(h, live, tomb, app)
    want = kernels.delta_merge_order_plain(h, live, tomb, app)
    need(torch.equal(got, want), f"{what}: K19 differs from its plain "
         f"version ({got.shape[0]} vs {want.shape[0]} rows)")
    return max_err(got, want)


def k19_edges(device, seed: int) -> float:
    """K19 on K19_EDGES, on a live mask that is no prefix, and on broken
    preconditions (each must raise DeviceError naming it)."""
    err = 0.0
    for name, n_rows, cap, n_tomb, mode, tomb_all, k in K19_EDGES:
        arrs = k19_case(n_rows, cap, n_tomb, mode, seed + n_rows + cap,
                        tomb_all, k)
        err = max(err, check_k19(*[torch.from_numpy(a).to(device)
                                   for a in arrs], f"K19 edge {name}"))
    rng = np.random.default_rng(seed)
    h = np.sort(rng.choice(1 << 40, 50_000, replace=False)).astype(np.int64)
    live = rng.random(50_000) < 0.5
    tomb = np.sort(rng.choice(h, 5000, replace=False))
    app = np.unique(rng.integers(0, 1 << 40, 3000)).astype(np.int64)
    err = max(err, check_k19(*[torch.from_numpy(a).to(device)
                               for a in (h, live, tomb, app)],
                             "K19 edge live mask no prefix"))
    broken = {"strictly ascend": (h[::-1].copy(), live, tomb, app),
              "strictly ascend (ties)": (np.repeat(h[:25_000], 2), live,
                                         tomb, app),
              "I64_MAX": (np.where(np.arange(50_000) == 49_999,
                                   kernels.I64_MAX, h), live | True, tomb,
                          app),
              "appended handles": (h, live, tomb, app[::-1].copy()),
              "tombstone handles": (h, live, tomb[::-1].copy(), app)}
    for what, arrs in broken.items():
        if device.type != "cuda":
            break           # the plain version holds for any input
        try:
            kernels.delta_merge_order(*[torch.from_numpy(a).to(device)
                                        for a in arrs])
        except errors.DeviceError as e:
            need(what.split(" (")[0] in str(e),
                 f"K19 broken precondition {what}: raised {e}")
            continue
        raise SmokeFailure(f"K19 broken precondition {what}: no raise")
    return err


class K19Recorder:
    """Keeps every K19 call the merge path makes (its inputs and output)
    while active."""

    def __init__(self):
        self.calls = []
        self._orig = kernels.delta_merge_order

    def __call__(self, h, live, tomb, app):
        out = self._orig(h, live, tomb, app)
        self.calls.append((h, live, tomb, app, out))
        return out

    def __enter__(self):
        kernels.delta_merge_order = self
        return self

    def __exit__(self, *exc):
        kernels.delta_merge_order = self._orig


def i_commit(store: DistStore, muts) -> None:
    """One transaction through begin / set / delete / commit."""
    txn = store.begin()
    for k, v in muts:
        if v is None:
            txn.delete(k)
        else:
            txn.set(k, v)
    txn.commit()


def i_sweep(store: DistStore, ts: int) -> dict:
    return {name: final_rows(store, dataclasses.replace(
        tpch.sweep_request(name), start_ts=ts)) for name, _m in tpch.SWEEP}


def i_stats(store: DistStore) -> dict:
    return {**store.plane_cache.stats, **store.rpc.delta_store.stats}


def i_diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def phase_i1(n_rows: int, seed: int, device, R: int = 8) -> tuple:
    """Slice 7 through KV at SF0.01: load through the write path, cache
    every region, commit RF1 and RF2, re-run. Returns (K19 launches, the
    recorded K19 calls)."""
    t0 = time.perf_counter()
    data = tpch.generate(n_rows, seed)
    pairs = list(tpch.kv_pairs(data))
    splits = tpch.split_keys(n_rows, R)
    gpu = DistStore([], splits, device)
    off = DistStore([], splits, device="cpu")
    off.rpc.delta_store.set_enabled(False)
    t1 = time.perf_counter()
    i_commit(gpu, pairs)
    load_s = time.perf_counter() - t1
    i_commit(off, pairs)
    print(f"phase I.1: {n_rows} lineitem rows encoded and committed "
          f"through DistTxn over {R} regions in {load_s:.1f} s (encoding "
          f"{t1 - t0:.1f} s)")
    t1 = time.perf_counter()
    for name, rows in i_sweep(gpu, gpu.current_version()).items():
        check_sweep(name, rows, data, "phase I.1 before the refresh")
    print(f"  six sweep shapes cached in every region and equal to numpy "
          f"({time.perf_counter() - t1:.1f} s, packing included)")
    m1, d1 = tpch.rf1(data, seed + 1)
    m2, d2 = tpch.rf2(d1, seed + 2)
    for store in (gpu, off):
        i_commit(store, m1)
        i_commit(store, m2)
    print(f"  RF1 {len(m1)} lineitems inserted, RF2 {len(m2)} deleted "
          f"(two transactions); delta packs {len(gpu.rpc.delta_store)}")
    ts = gpu.current_version()
    s0 = i_stats(gpu)
    zero_launches()
    t1 = time.perf_counter()
    with K19Recorder() as rec:
        got = i_sweep(gpu, ts)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = kernels.LAUNCHES["delta_merge_order"]
    merge_s = time.perf_counter() - t1
    d = i_diff(i_stats(gpu), s0)
    t1 = time.perf_counter()
    want = i_sweep(off, off.current_version())
    repack_s = time.perf_counter() - t1
    for name, rows in got.items():
        check_sweep(name, rows, d2, "phase I.1 after the refresh")
        same_final(rows, want[name], f"phase I.1 {name} (delta off)")
    need(d["misses"] == len(tpch.SWEEP) * R and d["merges"] == d["misses"],
         f"phase I.1: a region re-packed instead of merging: {d}")
    need(device.type != "cuda" or launches == len(rec.calls) > 0,
         f"phase I.1: K19 launches {launches}, merges through it "
         f"{len(rec.calls)}")
    err = 0.0
    for i, (h, live, tomb, app, out) in enumerate(rec.calls):
        want_o = kernels.delta_merge_order_plain(h, live, tomb, app)
        need(torch.equal(out, want_o), f"phase I.1: K19 call {i} differs "
             "from its plain version")
        err = max(err, max_err(out, want_o))
    s1 = i_stats(gpu)
    again = i_sweep(gpu, ts)
    d_rep = i_diff(i_stats(gpu), s1)
    need(d_rep["hits"] == len(tpch.SWEEP) * R and d_rep["misses"] == 0,
         f"phase I.1: the repeat did not hit the plane cache: {d_rep}")
    for name, rows in again.items():
        same_final(rows, got[name], f"phase I.1 {name} repeat")
    print(f"  after the refresh: six shapes equal to numpy and to the "
          f"delta-off store; merges {d['merges']} == misses {d['misses']} "
          f"({d['rekeys']} version-only), K19 launches {launches}, each "
          f"equal to its plain version; {merge_s:.2f} s merging vs "
          f"{repack_s:.2f} s re-packing (host clock); the repeat hit "
          f"{d_rep['hits']} times")
    return launches, err


def merged_planes(store: DistStore, sel: SelectRequest, ts: int) -> list:
    """Each region's cached batch of `sel` at `ts`: the handle and
    liveness planes its merge left on the device, checked equal to the
    batch's host planes."""
    req = tpch.store_request(sel)
    version = store.data_version_at(
        ts, tc.table_prefix(sel.table_info.table_id))
    planes = []
    for region in store.cluster.regions:
        key = columnar_region.cache_key(
            region.region_id, sel, clip_ranges(region, req.key_ranges))
        b = store.plane_cache.lookup(key, region.epoch(), version)
        need(b is not None, f"region {region.region_id}: no merged batch")
        h = next(iter(getattr(b, "_device_handles", {}).values()), None)
        live = next(iter(getattr(b, "_device_live", {}).values()), None)
        need(h is not None and live is not None
             and torch.equal(h.cpu(), torch.from_numpy(b.handles))
             and torch.equal(live.cpu(), torch.from_numpy(b.row_mask())),
             f"region {region.region_id}: the merged batch's device handle "
             "or liveness plane is missing or differs from its host plane")
        planes.append((h, live))
    return planes


def phase_i2(store: DistStore, data: dict, device, seed: int,
             pairs: int = 2) -> tuple:
    """Slice 7 at SF1 on Phase D's store (its region batches pinned in the
    plane cache, nothing in KV): RF1 + RF2 pairs, q1full after each
    against numpy, every region merged, each K19 call equal to its plain
    version; from the second pair on, K19 runs on the handle and
    liveness planes the last merge left on the device. Returns (K19 launches, K19 calls of
    the last pair, max_abs_err, statement figures)."""
    R = len(store.cluster.regions)
    sel = tpch.sweep_request("q1full")
    launches, out, err, resident = 0, [], 0.0, []
    for p in range(pairs):
        t0 = time.perf_counter()
        m1, data = tpch.rf1(data, seed + 2 * p)
        m2, data = tpch.rf2(data, seed + 2 * p + 1)
        i_commit(store, m1)
        i_commit(store, m2)
        commit_s = time.perf_counter() - t0
        ts = store.current_version()
        s0 = i_stats(store)
        zero_launches()
        kernels.SPLIT = {}
        t1 = time.perf_counter()
        with K19Recorder() as rec:
            rows = final_rows(store, dataclasses.replace(sel, start_ts=ts))
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        split, kernels.SPLIT = kernels.SPLIT, None
        launched = kernels.LAUNCHES["delta_merge_order"]
        need(device.type != "cuda" or launched == len(rec.calls) > 0,
             f"phase I.2 pair {p + 1}: K19 launches {launched}, merges "
             f"through it {len(rec.calls)}")
        launches += launched
        d = i_diff(i_stats(store), s0)
        check_sweep("q1full", rows, data, f"phase I.2 pair {p + 1}")
        need(d["misses"] == R and d["merges"] == R,
             f"phase I.2 pair {p + 1}: a region re-packed: {d}")
        for i, c in enumerate(rec.calls):
            want = kernels.delta_merge_order_plain(*c[:4])
            need(torch.equal(c[4], want), f"phase I.2 pair {p + 1}: K19 "
                 f"call {i} differs from its plain version")
            err = max(err, max_err(c[4], want))
        on_card = sum(any(c[0] is h and c[1] is live for h, live in resident)
                      for c in rec.calls)
        need(p == 0 or on_card == len(rec.calls) == R,
             f"phase I.2 pair {p + 1}: {on_card} of {len(rec.calls)} K19 "
             "calls ran on the planes the last merge left on the card")
        resident = merged_planes(store, sel, ts)
        hit_ms = host_ms(lambda: final_rows(
            store, dataclasses.replace(sel, start_ts=ts)), 5)
        out.append({"rows": int(data[tpch.C_ORDERKEY].shape[0]),
                    "inserted": len(m1), "deleted": len(m2),
                    "commit_s": commit_s, "merge_statement_ms": wall,
                    "hit_statement_ms": hit_ms, "split": split,
                    "repacks": d["repacks"],
                    "k19_calls": len(rec.calls),
                    "k19_on_resident_planes": on_card})
        print(f"phase I.2 pair {p + 1}: {len(m1)} inserted, {len(m2)} "
              f"deleted (commits {commit_s:.1f} s); q1full equal to numpy, "
              f"merges {d['merges']} == misses {d['misses']}, folds "
              f"{d['repacks']}, K19 on resident planes {on_card} of "
              f"{len(rec.calls)}; merge statement {wall:.1f} ms vs "
              f"{hit_ms:.1f} ms on a hit (host clock); split "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return launches, rec.calls, err, out


def k19_timed(call, device) -> dict:
    """K19's launch alone, its plain version and a stable argsort of the
    masked concatenation (the yardstick: it omits the mask), medians of
    20 CUDA-event runs, and its bound."""
    h, live, tomb, app, out = call
    n, m, k = h.shape[0], tomb.shape[0], app.shape[0]
    launch = (kernels.delta_merge_prepare(h, live, tomb, app)[0]
              if device.type == "cuda" else
              (lambda: kernels.delta_merge_order(h, live, tomb, app)))
    pos = torch.searchsorted(tomb, h)
    dead = (pos < m) & (tomb[pos.clamp(max=max(m - 1, 0))] == h) \
        if m else torch.zeros_like(live)
    masked = torch.cat([torch.where(live & ~dead, h,
                                    torch.full_like(h, kernels.I64_MAX)),
                        app])
    # the live mask over the capacity, the handles of live base rows only
    # (the kernel reads no other), the tombstones, the appended handles,
    # and the order written
    nbytes = n + 8 * int(live.sum()) + 8 * (m + k) + 8 * out.shape[0]
    ms = timer(device)
    return dict(
        ms=ms(launch),
        plain_ms=ms(lambda: kernels.delta_merge_order_plain(
            h, live, tomb, app)),
        library_ms=ms(lambda: torch.argsort(masked, stable=True)),
        bound=bound(nbytes, n * max(int(m).bit_length(), 1)
                    + k * max(int(n).bit_length(), 1)),
        shape=(n, m, k, int(out.shape[0])))


def phase_i(d_store: DistStore, d_data: dict, device, seed: int,
            small_rows: int = tpch.SF001_ROWS) -> tuple:
    """Returns (per-kernel results, launches); `d_store` and `d_data`
    Phase D's."""
    t0 = time.perf_counter()
    l1, err = phase_i1(small_rows, seed, device)
    l2, calls, err2, stmts = phase_i2(d_store, d_data, device, seed + 10)
    launches = {"delta_merge_order": l1 + l2}
    err = max(err, err2, k19_edges(device, seed))
    print("phase I: K19 equal to its plain version on every merge and on "
          "the edge cases; broken preconditions raise")
    # region 8's shape (tombstones and appended rows) and a region with
    # tombstones only, from the last pair's merges
    by_app = sorted(calls, key=lambda c: c[3].shape[0])
    timed = {"tombstones_only": k19_timed(by_app[0], device),
             "region_8": k19_timed(by_app[-1], device)}
    need(by_app[0][3].shape[0] == 0, "phase I.2: no tombstones-only merge")
    for what, r in timed.items():
        print(f"  K19 at {what} (n, m, k, n_live) {r['shape']}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, stable "
              f"argsort {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} "
              f"ms by {r['bound'][1]})")
    print("phase I statements: " + json.dumps(stmts))
    print(f"phase I: launches {launches}; {time.perf_counter() - t0:.1f} s")
    r = dict(timed["region_8"], max_abs_err=err)
    return {"delta_merge_order": r}, launches


# ---------------------------------------------------------------------------
# Phase J: the mesh tier on the card (slice 8)
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
MESH_KERNELS = ("shard_topk",)
J_AGGS = (("q1", tpch.q1), ("q6", tpch.q6), ("by_supplier", tpch.by_supplier))
J_TOPN = ("topn_price", "topn_multi", "topn_multi_5000")


def j_plain_q1() -> SelectRequest:
    """Q1's WHERE, group-by and columns with plain-column aggregates only
    (count(*), sum(l_quantity), min(l_extendedprice), max(l_discount)),
    so the cluster path takes the near-data mesh rung; its K6 spans fit
    shared memory."""
    sel = tpch.q1()
    c = expr_column
    sel.aggregates = [
        expr_agg("count", [expr_value(Datum.i64(1))]),
        expr_agg("sum", [c(tpch.C_QUANTITY)]),
        expr_agg("min", [c(tpch.C_EXTENDEDPRICE)]),
        expr_agg("max", [c(tpch.C_DISCOUNT)]),
        expr_agg("first_row", [c(tpch.C_RETURNFLAG)]),
        expr_agg("first_row", [c(tpch.C_LINESTATUS)])]
    return tpch.hinted(sel)


def j_filter() -> SelectRequest:
    """Q6's WHERE as a scan (no aggregate) answered columnar: the
    survivors' selection index."""
    sel = tpch.q6()
    sel.aggregates = []
    return tpch.hinted(sel)


def j_filter_expected(data: dict) -> np.ndarray:
    ship = data[tpch.C_SHIPDATE]
    disc = data[tpch.C_DISCOUNT]
    return np.flatnonzero((ship >= np.datetime64("1994-01-01"))
                          & (ship < np.datetime64("1995-01-01"))
                          & (disc >= 5) & (disc <= 7)
                          & (data[tpch.C_QUANTITY] < 2400))


def check_j_plain(rows: list, data: dict) -> None:
    """j_plain_q1's final rows against numpy."""
    m = data[tpch.C_SHIPDATE] <= np.datetime64("1998-09-02")
    q = tpch.q1_expected(data)
    for row in rows:
        key = (row[-2].val, row[-1].val)
        g = m & (data[tpch.C_RETURNFLAG] == tpch.RETURNFLAG.index(
            key[0].encode())) & (data[tpch.C_LINESTATUS] == tpch.LINESTATUS
                                 .index(key[1].encode()))
        want = [q[(key[0].encode(), key[1].encode())][0],
                q[(key[0].encode(), key[1].encode())][1],
                int(data[tpch.C_EXTENDEDPRICE][g].min()),
                int(data[tpch.C_DISCOUNT][g].max())]
        got = [row[0].val, int(row[1].val.scaleb(2)),
               int(row[2].val.scaleb(2)), int(row[3].val.scaleb(2))]
        need(got == want, f"phase J plain q1 {key}: {got} vs numpy {want}")
    need(len(rows) == len(tpch.q1_expected(data)), "phase J plain q1 groups")


def j_faults(device) -> list:
    """The reference's three mesh TopN faults over two shards of 1024 rows:
    (mask, keys, limit, the CPU engine's rows)."""
    L, n = 1024, 2048
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    valid = np.ones(n, bool)
    zeros = np.zeros(n, np.int64)
    a = zeros.copy()
    a[5], a[L + 3] = 1 << 53, (1 << 53) + 1     # one f64 score
    m1 = np.zeros(n, bool)
    m1[[5, L + 3]] = True
    b = np.arange(n, dtype=np.int64)
    b[L + 9] = kernels.I64_MIN                 # wraps when negated
    c = np.zeros(n, np.float64)
    c[2] = 3.0
    cv = valid.copy()
    cv[1] = False                              # NULL beside dead row 0
    m3 = np.zeros(n, bool)
    m3[[1, 2]] = True
    return [(t(m1), [((t(a), t(valid)), True)], 1, [L + 3]),
            (t(valid), [((t(b), t(valid)), True),
                        ((t(zeros), t(valid)), False)], 2, [n - 1, n - 2]),
            (t(m3), [((t(c), t(cv)), True)], 2, [2, 1])]


def j_merged(mask, keys, limit: int, shards: int) -> list:
    L = mask.shape[0] // shards
    outs = kernels.shard_topk(mask, keys, min(limit, L), shards)
    return kernels.merge_topn_partials(
        *[o.cpu().numpy() for o in outs], shards, L, limit).tolist()


def k20_edges(device, seed: int) -> list:
    """(mask, keys, k, shards, what) for K20: K10's edge cases cut into
    shards (NULL keys beside filtered rows, int64 extremes under DESC,
    BIGINT keys above 2^53, -0.0 beside +0.0, no live row, k above the
    live rows, lengths no multiple of the tile), plus k equal to the shard
    length past a tile, shards with no live row or fewer than k, ties
    across shard boundaries and no key at all."""
    cases = []
    for mask, keys, k, what in edge_topn(device, seed):
        n = mask.shape[0]
        shards = next(s for s in (8, 4, 2, 37, 97, 1) if n % s == 0)
        cases.append((mask, keys, min(k, n // shards), shards,
                      f"{what} over {shards} shards"))
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    n = 4 * 5000
    live = rng.random(n) > 0.3
    live[5000:10000] = False                   # a shard with no live row
    live[10000:15000] = np.arange(5000) % 1000 == 7   # five live rows
    a = rng.integers(-5, 5, n).astype(np.int64)
    a[rng.random(n) < 0.01] = kernels.I64_MIN
    ok = t(rng.random(n) > 0.1)
    f = rng.integers(-3, 3, n) * 0.5
    f[rng.random(n) < 0.2] = -0.0
    keys = [((t(a), ok), True), ((t(f), t(rng.random(n) > 0.2)), False)]
    for k in (1, 100, 1500, 5000):
        cases.append((t(live), keys, k, 4, f"two keys k={k} over 4 shards"))
    tied = t(np.full(n, 7, np.int64))
    cases.append((t(np.ones(n, bool)), [((tied, t(np.ones(n, bool))), True)],
                  9, 8, "every key tied"))
    cases.append((t(live), [], 33, 4, "no key"))
    return cases


def check_k20(mask, keys, k: int, shards: int, what: str) -> float:
    got = kernels.shard_topk(mask, keys, k, shards)
    want = kernels.shard_topk_plain(mask, keys, k, shards)
    for g, w, part in zip(got, want, ("idx", "n_live", "words", "nulls")):
        need(g.shape == w.shape and torch.equal(g, w),
             f"{what}: K20 {part} differs from its plain version")
    return max(max_err(g, w) for g, w in zip(got, want))


def k20_bytes(mask, keys, k: int, shards: int) -> int:
    n = mask.shape[0]
    return n + 9 * n * len(keys) + shards * 8 \
        + shards * k * (8 + 9 * len(keys))


def phase_j(data: dict, batch, d_store: DistStore, d_data: dict,
            joins: tuple, device, seed: int) -> tuple:
    """The mesh tier on the card: CoprMesh([cuda:0] * 8). Phase B's batch
    (capacity 2^23, 1,048,576 rows a shard): Q1, Q6 and the supplier
    group-by through GpuClient(mesh=...), each equal to the client without
    a mesh (and Q1 to numpy); the filter scan's mask; Phase E's TopN
    statements (K20) against numpy, and the reference's mesh TopN faults
    as the CPU engine's rows. Phase D's store with the process mesh set:
    the sweep and a plain-column Q1 (the near-data rung: K6 over the shard
    layout) equal to numpy and to the mesh-off run. f1_q3_join's pairs
    through the sharded probe equal to the single-device pairs. Then K20
    against its plain version at SF1 and on edge cases, and K20, the K7
    fold and the K6 shard-layout launch timed beside their bounds; last,
    the default one-shard process mesh on plain_q1 and dec_group.
    Returns (per-kernel results, launches, timings)."""
    t0 = time.perf_counter()
    ms = timer(device)
    f_tables, f_batches = joins
    pmesh = CoprMesh([device] * MESH_SHARDS)
    need(pmesh.n == MESH_SHARDS and batch.capacity % pmesh.n == 0,
         "phase J: the batch does not cut into 8 shards")
    print(f"phase J: {MESH_SHARDS} shards of {batch.capacity // pmesh.n} "
          f"rows on {pmesh.device}")
    cuda = device.type == "cuda"
    single = GpuClient(MemStore([], []), device)
    client = GpuClient(MemStore([], []), mesh=pmesh)
    sweep = [(name, tpch.sweep_request(name)) for name, _m in tpch.SWEEP]
    # plain_q1 reads q1full's columns: Phase D's admitted batches serve it
    sweep.append(("plain_q1", j_plain_q1()))
    # the answers without the mesh, before the main path's counts start
    mesh_mod.set_enabled(False)
    want_aggs = {name: rows_of(single.serve(make(), batch))
                 for name, make in J_AGGS}
    want_sel = single.serve(j_filter(), batch).columnar.sel
    want_sweep = {name: final_rows(d_store, sel) for name, sel in sweep}
    f_join, f_agg = f_statement(single, "f1_q3_join", f_batches)
    f_rows = f_agg.drain()
    want_pairs = f_join.device_join_result()
    mesh_mod.set_enabled(True)
    mesh_mod.set_mesh(pmesh)

    if cuda:
        torch.cuda.synchronize()
    zero_launches()
    calls0 = dict(kernels.CALLS)
    t_main = time.perf_counter()
    per = {}
    for name, make in J_AGGS:
        before = dict(kernels.LAUNCHES)
        resp = client.serve(make(), batch)
        same_rows(rows_of(resp), want_aggs[name], f"phase J {name}")
        if name == "q1":
            check_q1(resp, data, "phase J")
        per[name] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}
    before = dict(kernels.LAUNCHES)
    sel_idx = client.serve(j_filter(), batch).columnar.sel
    per["filter"] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}
    need(np.array_equal(sel_idx, want_sel)
         and np.array_equal(sel_idx, j_filter_expected(data)),
         "phase J: the filter's mask differs over the shards")
    slice3 = dict(tpch.SLICE3)
    for name in J_TOPN:
        before = dict(kernels.LAUNCHES)
        check_slice3(name, client.serve(slice3[name](), batch), data,
                     "phase J")
        per[name] = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                     if v != before[k]}
        sel = slice3[name]()
        want = {"expr_vm": 1, "shard_topk": kernels.shard_topk_launch_count(
            MESH_SHARDS, batch.capacity // MESH_SHARDS,
            min(sel.limit, batch.capacity // MESH_SHARDS), len(sel.order_by),
            device)} if cuda else per[name]
        need(per[name] == want, f"phase J {name}: launches {per[name]}, "
             f"want {want}")
    for mask, keys, limit, cpu_rows in j_faults(device):
        need(j_merged(mask, keys, limit, 2) == cpu_rows,
             f"phase J: a mesh TopN fault case gives {cpu_rows} wrongly")
    nd0 = mesh_mod.stats["near_data_dispatches"]
    mc0 = fused_agg.stats["mesh_combines"]
    for name, sel in sweep:
        rows = final_rows(d_store, sel)
        same_final(rows, want_sweep[name], f"phase J {name}")
        if name == "plain_q1":
            check_j_plain(rows, d_data)
        else:
            check_sweep(name, rows, d_data, "phase J")
    near = mesh_mod.stats["near_data_dispatches"] - nd0
    need(near == 2, f"phase J: {near} near-data dispatches over the sweep "
         "(dec_group and plain_q1 alone have no argument plane)")
    need(fused_agg.stats["mesh_combines"] - mc0 == len(sweep),
         "phase J: a sweep statement's combine missed the mesh")
    j_join, j_agg = f_statement(client, "f1_q3_join", f_batches)
    j_rows = j_agg.drain()
    res = j_join.device_join_result()
    need(j_join.join_stats.get("mesh_shards") == MESH_SHARDS,
         "phase J: f1_q3_join did not take the sharded probe")
    need(np.array_equal(res.l_idx, want_pairs.l_idx)
         and np.array_equal(res.r_idx, want_pairs.r_idx),
         "phase J: sharded pairs differ from the single-device pairs")
    check_join_rows("f1_q3_join", j_rows, f_tables, "phase J")
    if cuda:
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(kernels.LAUNCHES)
    calls = {k: kernels.CALLS[k] - calls0[k] for k in calls0}
    for k in ("shard_topk", "combine_partials", "join_probe", "expr_vm",
              "seg_agg_block") + K4_SORTED_KERNELS:
        need(launches[k] >= 1 or not cuda, f"phase J: {k} never launched")
    need(sum(launches[k] for k in K6_ROUTES) >= 1 or not cuda,
         "phase J: K6 never launched")
    need(calls["mesh_allreduce"] == len(J_AGGS) + len(sweep),
         f"phase J: mesh_allreduce calls {calls}")
    print(f"phase J: main path over {MESH_SHARDS} shards in {main_s:.1f} s; "
          f"launches per statement {json.dumps(per)}; all launches "
          f"{ {k: v for k, v in launches.items() if v} }; calls {calls}; "
          f"shard balance {mesh_mod.stats}")

    # where a mesh statement's time goes: one run of each with the phase
    # split on (host clock, device synchronised at each phase's edges)
    stmts = {}
    for name, run in (
            ("plain_q1", lambda: final_rows(d_store, dict(sweep)["plain_q1"])),
            ("dec_group", lambda: final_rows(d_store,
                                             dict(sweep)["dec_group"])),
            ("q1full", lambda: final_rows(d_store, dict(sweep)["q1full"])),
            ("q1", lambda: client.serve(tpch.q1(), batch)),
            ("topn_multi", lambda: client.serve(slice3["topn_multi"](),
                                                batch)),
            ("topn_multi_5000", lambda: client.serve(
                slice3["topn_multi_5000"](), batch))):
        kernels.SPLIT = {}
        t1 = time.perf_counter()
        run()
        if cuda:
            torch.cuda.synchronize()
        took = (time.perf_counter() - t1) * 1e3
        split, kernels.SPLIT = kernels.SPLIT, None
        stmts[name] = {"ms": took, "split": split}
    print("phase J statements: " + json.dumps(stmts))

    # the near-data rung's K6 over the shard layout: plain_q1 (spans in
    # shared memory) and dec_group (4,096 segments a shard: the block
    # route), captured and timed
    timed = {}
    orig = kernels.seg_states_ragged
    for name in ("plain_q1", "dec_group"):
        captured = []

        def spy(*a):
            captured.append(a)
            return orig(*a)

        kernels.seg_states_ragged = spy
        mesh_mod.set_mesh(pmesh)
        try:
            rows = final_rows(d_store, dict(sweep)[name])
        finally:
            kernels.seg_states_ragged = orig
        same_final(rows, want_sweep[name], f"phase J {name} again")
        need(len(captured) == 1, f"phase J: {name}'s K6 was not captured")
        k6 = captured[0]
        before = dict(kernels.LAUNCHES)
        check_k6(k6, f"K6 shard layout {name}")
        route = ([k for k in K6_ROUTES
                  if kernels.LAUNCHES[k] != before[k]] or ["plain"])[0]
        gid, contrib0 = k6[0], k6[5][0]
        n_seg = len(k6[1]) * kernels.bucket_segments(k6[3][0] + 1)
        timed[f"k6_shard_layout {name}"] = dict(
            ms=ms(kernels.k6_prepare(*k6)[0]), plain_ms=ms(
                lambda: kernels.seg_states_ragged_plain(
                    k6[0], k6[1], k6[3], k6[4], k6[5])),
            library_ms=ms(lambda: torch.zeros(
                n_seg, dtype=torch.int64, device=device).index_add_(
                0, gid, contrib0.to(torch.int64))),
            bound=k6_bound(k6), route=route,
            shape=f"{len(k6[1])} shards x {k6[1][0]} rows, {n_seg} "
                  f"segments, {len(k6[5])} reductions, {route}")
    out = {}

    # the K7 fold at Q1's partials ([8, 13] per output, GpuClient) and at
    # q1full's states ([8 * Rmax, 4] per state, combine_states_sharded)
    orig_fold = kernels.mesh_allreduce
    for what, run in (
            ("k7_fold", lambda: client.serve(tpch.q1(), batch)),
            ("k7_states_combine",
             lambda: final_rows(d_store, dict(sweep)["q1full"]))):
        folds = []

        def fold_spy(parts, codes):
            folds.append(([p.clone() for p in parts], list(codes)))
            return orig_fold(parts, codes)

        kernels.mesh_allreduce = fold_spy
        mesh_mod.set_mesh(pmesh)
        try:
            run()
        finally:
            kernels.mesh_allreduce = orig_fold
        parts, codes = folds[0]
        R = int(parts[0].shape[0])
        t_in = torch.cat([p.reshape(-1) for p in parts])
        widths = [int(p.shape[1]) for p in parts]
        k7_launch, k7_out, k7_desc = kernels._k7_prepare_device(
            t_in, widths, codes, R, device)
        k7_launch()
        plain = kernels.mesh_allreduce([p.cpu() for p in parts], codes)
        host = k7_out.cpu().numpy()
        for (_op, _i, G, o), w in zip(k7_desc, plain):
            need(np.array_equal(host[o:o + G], w),
                 f"phase J: {what} differs from its plain version")
        timed[what] = dict(
            ms=ms(k7_launch),
            plain_ms=ms(lambda: kernels.combine_partials_plain(
                [p.view(torch.float64) if c in kernels.F_OPS else p
                 for p, c in zip(parts, codes)], codes)),
            library_ms=ms(lambda: [p.sum(0) for p in parts]),
            bound=bound(t_in.numel() * 8 + sum(widths) * 8, t_in.numel()),
            shape=f"{len(parts)} outputs of [{R}, {widths[0]}]")

    # Q1's per-shard partials: K1 once, then K4 over 8 x 13 segments
    # (shard * 13 + gid), and the statement through both clients
    q1r = Request(tpch.q1(), batch, device)
    mask1, gid1, outs1 = q1r.k1()
    reds1 = q1r.reds(outs1)
    n_seg = q1r.segments * MESH_SHARDS
    gid_s = gid1 + kernels.shard_ids(gid1.shape[0], MESH_SHARDS, device) \
        * q1r.segments
    n1 = gid1.shape[0]
    err4 = check_k4(gid_s, mask1, n_seg, reds1, "phase J: Q1's shard "
                    "partials")
    route = k4_route_of(reds1, n_seg, device)
    # the yardstick stacks every reduction's masked values, as row 3's
    stacked1 = torch.stack([torch.where(mask1, r.values, torch.zeros_like(
        r.values)).view(torch.int64) for r in reds1
        if r.values is not None], 1)
    timed["shard_partials"] = dict(
        ms=ms(lambda: kernels._seg_agg(gid_s, mask1, n_seg, reds1)),
        plain_ms=ms(lambda: kernels.seg_agg_plain(gid_s, mask1, n_seg,
                                                  reds1)),
        library_ms=ms(lambda: torch.zeros(
            n_seg, stacked1.shape[1], dtype=torch.int64,
            device=device).index_add_(0, gid_s, stacked1)),
        bound=bound(n1 * 9 + sum(n1 * 9 for r in reds1
                                 if r.values is not None)
                    + 16 * n_seg * len(reds1), n1 * len(reds1)),
        shape=f"Q1, {n1} rows, {n_seg} segments, {len(reds1)} reductions, "
              f"{route}, {k4_copies_of(reds1, n_seg, route, device)} copies")
    # what Q1's hot segment costs K4 (each shard's largest group holds
    # about half its rows): the same rows and reductions, the ids spread
    # evenly over the same segments
    hot = float(torch.bincount(gid1[mask1], minlength=q1r.segments).max()) \
        / max(int(mask1.sum()), 1)
    spread = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, n_seg, n1)).to(device)
    err4 = max(err4, check_k4(spread, mask1, n_seg, reds1,
                              "phase J: Q1's reductions over spread ids"))
    timed["shard_partials spread"] = dict(
        ms=ms(lambda: kernels._seg_agg(spread, mask1, n_seg, reds1)),
        plain_ms=ms(lambda: kernels.seg_agg_plain(spread, mask1, n_seg,
                                                  reds1)),
        library_ms=ms(lambda: torch.zeros(
            n_seg, stacked1.shape[1], dtype=torch.int64,
            device=device).index_add_(0, spread, stacked1)),
        bound=timed["shard_partials"]["bound"],
        shape=f"Q1's rows and reductions, ids uniform over {n_seg} "
              f"segments (Q1's largest group: {hot:.3f} of its rows)")
    # by_supplier over the shards: 8 x 10,002 ids, past K4_MAX_WINDOWS:
    # the sorted route, its ids sorted by the radix
    sr = Request(tpch.by_supplier(), batch, device)
    maskB, gidB, outsB = sr.k1()
    redsB = sr.reds(outsB)
    n_segB = sr.segments * MESH_SHARDS
    gid_b = gidB + kernels.shard_ids(gidB.shape[0], MESH_SHARDS, device) \
        * sr.segments
    err4 = max(err4, check_k4(gid_b, maskB, n_segB, redsB,
                              "phase J: by_supplier's shard partials"))
    routeB = k4_route_of(redsB, n_segB, device)
    planB = kernels.radix_plan((1 << (n_segB - 1).bit_length()) - 1, False)
    stackedB = torch.stack([torch.where(maskB, r.values, torch.zeros_like(
        r.values)).view(torch.int64) for r in redsB
        if r.values is not None], 1)
    out["seg_agg_sorted"] = dict(
        ms=ms(lambda: kernels.seg_agg_sorted(gid_b, maskB, n_segB, redsB)),
        plain_ms=ms(lambda: kernels.seg_agg_plain(gid_b, maskB, n_segB,
                                                  redsB)),
        library_ms=ms(lambda: torch.zeros(
            n_segB, stackedB.shape[1], dtype=torch.int64,
            device=device).index_add_(0, gid_b, stackedB)),
        max_abs_err=err4,
        bound=bound(_nbytes([gid_b, maskB] + [t for r in redsB
                                              for t in (r.values, r.valid)]),
                    n1 * len(redsB)),
        shape=f"by_supplier, {n1} rows, {n_segB} segments, {len(redsB)} "
              f"reductions, {routeB}")
    # the radix alone at those ids (its passes, row positions as payload)
    srt, pos = kernels.radix_sort_t(gid_b, None, planB)
    want_pos = torch.sort(gid_b, stable=True).indices
    need(torch.equal(pos, want_pos) and torch.equal(srt, gid_b[want_pos]),
         "phase J: the radix differs from a stable sort")
    out["radix_pass"] = dict(
        ms=ms(lambda: kernels.radix_sort_t(gid_b, None, planB)),
        plain_ms=ms(lambda: kernels.radix_sort_plain(gid_b, None, planB)),
        library_ms=ms(lambda: torch.sort(gid_b, stable=True)),
        max_abs_err=0.0, bound=bound(n1 * 8 + n1 * 16, 0),
        shape=f"{n1} ids below {n_segB}, {len(planB)} passes of "
              f"{kernels.RADIX_BITS} bits")
    timed["by_supplier_partials"] = out["seg_agg_sorted"]
    timed["radix_by_supplier"] = out["radix_pass"]
    q1 = tpch.q1()
    timed["q1_serve"] = dict(
        ms=host_ms(lambda: client.serve(q1, batch), 5),
        plain_ms=host_ms(lambda: single.serve(q1, batch), 5),
        library_ms=None, bound=(0.0, "host clock"),
        shape="Q1 at SF1: ms through the mesh client, plain_ms without "
              "a mesh (host clock incl. readback and emit, median of 5)")

    # K20 against its plain version at SF1 (topn_multi's keys, k 100 and
    # 5000) and on edge cases, then timed
    err = 0.0
    for name in ("topn_price", "topn_multi", "topn_multi_5000"):
        sel = slice3[name]()
        prog = Program(batch)
        where = compile_expr(sel.where, batch, prog) \
            if sel.where is not None else None
        keys = [(compile_expr(i.expr, batch, prog), i.desc)
                for i in sel.order_by]
        base = kernels.build_topn_fn(prog, where, keys, sel.limit)
        mask, kp = base.inputs(kernels.batch_planes(batch, device),
                               kernels.device_live(batch, device))
        k = min(sel.limit, batch.capacity // MESH_SHARDS)
        err = max(err, check_k20(mask, kp, k, MESH_SHARDS, f"K20 {name}"))
        if name == "topn_price":
            # the yardstick computes the same function but for ties: one
            # masked f64 score (dead rows -inf), the top k of each shard
            (v, ok), _desc = kp[0]
            score = torch.where(mask & ok, v.to(torch.float64),
                                torch.full_like(v, -np.inf,
                                                dtype=torch.float64))
            timed["shard_topk"] = dict(
                ms=ms(lambda: kernels.shard_topk(mask, kp, k, MESH_SHARDS)),
                plain_ms=ms(lambda: kernels.shard_topk_plain(
                    mask, kp, k, MESH_SHARDS)),
                library_ms=ms(lambda: torch.topk(
                    score.view(MESH_SHARDS, -1), k, dim=1)),
                bound=bound(k20_bytes(mask, kp, k, MESH_SHARDS), 0),
                shape=f"{MESH_SHARDS} shards x {batch.capacity // MESH_SHARDS}"
                      f" rows, {len(kp)} key, k {k}")
        if name in ("topn_multi", "topn_multi_5000"):
            # no PyTorch call orders by three keys with NULL ranks
            timed[f"shard_topk {name}"] = dict(
                ms=ms(lambda: kernels.shard_topk(mask, kp, k, MESH_SHARDS)),
                plain_ms=ms(lambda: kernels.shard_topk_plain(
                    mask, kp, k, MESH_SHARDS)),
                library_ms=None,
                bound=bound(k20_bytes(mask, kp, k, MESH_SHARDS), 0),
                shape=f"{MESH_SHARDS} shards x {batch.capacity // MESH_SHARDS}"
                      f" rows, {len(kp)} keys, k {k}")
    for mask, keys, k, shards, what in k20_edges(device, seed):
        err = max(err, check_k20(mask, keys, k, shards, f"K20 edge {what}"))
    need(err == 0.0, "phase J: K20 differs from its plain version")

    # K12 over the shard-major probe rows (Phase F's full shape: every
    # lineitem row probes orders by order key) beside the one-shard probe
    lk, lv = kernels.batch_planes(batch, device)[tpch.C_ORDERKEY]
    ob = f_batches[tpch.ORDERS_ID]
    rk, rv = (p[:ob.n_rows] for p in kernels.batch_planes(
        ob, device)[tpch.O_ORDERKEY])
    words, order = kernels.join_build(rk, rv)
    sp, totals = kernels.join_probe(words, order, lk, lv, shards=MESH_SHARDS)
    one, _one_total = kernels.join_probe(words, order, lk, lv)
    need(torch.equal(sp, one) and int(totals.sum()) == one.shape[1],
         "phase J: the sharded probe differs from the one-shard probe")
    timed["join_probe_sharded"] = dict(
        ms=ms(lambda: kernels.join_probe(words, order, lk, lv,
                                         shards=MESH_SHARDS)),
        plain_ms=ms(lambda: kernels.join_probe_plain(words, order, lk, lv)),
        library_ms=None,
        one_shard_ms=ms(lambda: kernels.join_probe(words, order, lk, lv)),
        bound=bound(lk.numel() * 9 + words.numel() * 16
                    + one.numel() * one.element_size(),
                    lk.numel() * 2 * max(int(words.numel()).bit_length(), 1)),
        shape=f"{MESH_SHARDS} shards x {lk.numel() // MESH_SHARDS} probe "
              f"rows, {words.numel()} build rows, totals "
              f"{totals.tolist()}")
    # the default configuration: the process mesh of this one-card rig is
    # one shard, whose rungs are the batched K6 and the region combine
    # (the same launches as with the tier off); each statement timed both
    # ways, in turns (host clock, median of 5 each)
    mesh_mod.set_mesh(None)
    dflt = mesh_mod.get_mesh()
    need(mesh_mod.on_device(dflt, device) and dflt.n == 1,
         "phase J: the default process mesh is not one shard on the card")
    one_shard = {}
    for name in ("plain_q1", "dec_group"):
        sel = dict(sweep)[name]
        nd0 = mesh_mod.stats["near_data_dispatches"]
        mc0 = fused_agg.stats["mesh_combines"]
        calls0 = dict(kernels.CALLS)
        before = dict(kernels.LAUNCHES)
        same_final(final_rows(d_store, sel), want_sweep[name],
                   f"phase J {name} on the default mesh")
        calls = {k: kernels.CALLS[k] - calls0[k] for k in calls0}
        need(calls["region_agg_states_batched"] == 1
             and calls["combine_region_partials"] == 1
             and calls["mesh_allreduce"] == 0
             and mesh_mod.stats["near_data_dispatches"] == nd0 + 1
             and fused_agg.stats["mesh_combines"] == mc0 + 1,
             f"phase J {name}: the one-shard mesh took {calls}")
        launched = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                    if v != before[k]}
        mesh_mod.set_enabled(False)
        before = dict(kernels.LAUNCHES)
        final_rows(d_store, sel)
        need({k: v - before[k] for k, v in kernels.LAUNCHES.items()
              if v != before[k]} == launched,
             f"phase J {name}: the one-shard mesh launched {launched}, "
             "not the tier-off launches")
        turns = {True: [], False: []}
        for _ in range(5):
            for enabled, took in turns.items():
                mesh_mod.set_enabled(enabled)
                took.append(host_ms(lambda: final_rows(d_store, sel), 1))
        mesh_mod.set_enabled(True)
        one_shard[name] = {"launches": launched,
                           "mesh_ms": float(np.median(turns[True])),
                           "off_ms": float(np.median(turns[False]))}
    print("phase J default mesh (1 shard) vs tier off: "
          + json.dumps(one_shard))
    for name, r in timed.items():
        print(f"  {name} ({r['shape']}): {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, library {r.get('library_ms')}, bound "
              f"{r['bound'][0]:.6f} ms by {r['bound'][1]})")
    print(f"phase J: {time.perf_counter() - t0:.1f} s")
    out["shard_topk"] = dict(timed["shard_topk"], max_abs_err=err)
    return out, {k: launches[k] for k in ("shard_topk",)
                 + K4_SORTED_KERNELS}, timed


# ---------------------------------------------------------------------------
# Phase K: the out-of-core joins and the spilling states
# ---------------------------------------------------------------------------

OOC_KERNELS = ("key_partition", "join_probe_seg")
K_JOINS = ("f1_q3_join", "f2_partsupp")
K_SPILLS = ("date_group", "q1full")


def k_values(rows: list) -> list:
    return [[cell(d) for d in row] for row in rows]


def k_split(fn) -> dict:
    """Milliseconds by phase (kernels.SPLIT) of one more run of fn."""
    kernels.SPLIT = {}
    try:
        fn()
    finally:
        split, kernels.SPLIT = kernels.SPLIT, None
    return {k: round(v, 3) for k, v in split.items()}


class KOomOnce:
    """A test hook of this phase: kernels.join_match_pairs whose first
    call raises DeviceOOM, as a pass that runs out of memory on the card
    does; restored on exit."""

    def __init__(self):
        self.calls = 0
        self._orig = kernels.join_match_pairs

    def __call__(self, *a, **kw):
        self.calls += 1
        if self.calls == 1:
            raise errors.DeviceOOM("injected device OOM (phase K hook)")
        return self._orig(*a, **kw)

    def __enter__(self):
        kernels.join_match_pairs = self
        return self

    def __exit__(self, *exc):
        kernels.join_match_pairs = self._orig


class KHostPartition:
    """A check of this phase: stands in for membudget.partition_codes
    while K.1 runs, and fails the phase if the router partitions on the
    host."""

    def __call__(self, *a, **kw):
        need(False, "phase K.1: the passes partitioned on the host")


def k21_edges(device, seed: int) -> list:
    """(key, valid, parts, what) edge cases of K21."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    n = 100_003
    f = rng.integers(-6, 6, n) * 0.25
    f[::3] = -0.0
    out = [(t(f), t(rng.random(n) > 0.1), 8, "-0.0 beside +0.0"),
           (t(rng.integers(0, 99, n)), t(rng.random(n) > 0.5), 8,
            "NULL keys"),
           (t(np.full(n, 7, np.int64)), t(np.ones(n, bool)), 8,
            "one hot key"),
           (t(np.arange(5, dtype=np.int64)), t(np.ones(5, bool)), 64,
            "empty partitions"),
           (t(rng.integers(-(1 << 62), 1 << 62, n)), t(np.ones(n, bool)), 1,
            "P = 1"),
           (t(rng.integers(-(1 << 62), 1 << 62, n)), t(np.ones(n, bool)),
            1024, "P = 1024"),
           (t(rng.integers(0, 9, 2047)), t(np.ones(2047, bool)), 3,
            "2047 rows"),
           (t(rng.integers(0, 9, 2049)), t(np.ones(2049, bool)), 3,
            "2049 rows"),
           (t(np.zeros(0, np.int64)), t(np.zeros(0, bool)), 8, "no row")]
    return out


def check_k21(key, valid, parts: int, what: str) -> tuple:
    """K21 against its plain version and membudget.partition_codes on the
    same card tensors, bit for bit. Returns (max_abs_err, sel, offsets)."""
    sel, offs = kernels.key_partition(key, valid, parts)
    sp, op = kernels.key_partition_plain(key, valid, parts)
    codes = membudget.partition_codes(key.cpu().numpy(), valid.cpu().numpy(),
                                      parts)
    need(torch.equal(sel, sp) and torch.equal(offs, op)
         and np.array_equal(sel.cpu().numpy(),
                            np.argsort(codes, kind="stable")),
         f"{what}: K21 differs from its plain version")
    return max(max_err(sel, sp), max_err(offs, op)), sel, offs


def k_segmented(lk, lv, rk, rv, parts: int) -> dict:
    """The inputs of the segmented K12 over K21's layouts (K11 within the
    partitions)."""
    l_sel, l_off = kernels.key_partition(lk, lv, parts)
    r_sel, r_off = kernels.key_partition(rk, rv, parts)
    words, rows, bounds = kernels.join_build_partitioned(
        rk.index_select(0, r_sel), rv.index_select(0, r_sel), r_off)
    return dict(words=words, order=r_sel.index_select(0, rows),
                bounds=bounds, lkey=lk.index_select(0, l_sel),
                lvalid=lv.index_select(0, l_sel), loff=l_off, lsel=l_sel)


def check_seg_k12(lk, lv, rk, rv, parts: int, what: str) -> float:
    """K11 within partitions and the segmented K12 against their plain
    versions on the card, bit for bit; the pairs, sorted stably by left
    row, equal to the single pass's."""
    a = k_segmented(lk, lv, rk, rv, parts)
    r_sel, r_off = kernels.key_partition_plain(rk, rv, parts)
    wp, rows_p, bp = kernels.join_build_partitioned_plain(
        rk.index_select(0, r_sel), rv.index_select(0, r_sel), r_off)
    need(torch.equal(a["words"], wp) and torch.equal(a["bounds"], bp)
         and torch.equal(a["order"], r_sel.index_select(0, rows_p)),
         f"{what}: K11 within partitions differs from its plain version")
    pairs, totals = kernels.join_probe_partitioned(**a)
    pp, tp = kernels.join_probe_partitioned_plain(**a)
    need(torch.equal(pairs.to(torch.int64), pp)
         and np.array_equal(totals, tp),
         f"{what}: the segmented K12 differs from its plain version")
    err = max(max_err(a["words"], wp), max_err(pairs.to(torch.int64), pp))
    words, order = kernels.join_build(rk, rv)
    single, _t = kernels.join_probe(words, order, lk, lv)
    n = pairs.shape[1]
    if n > 1:
        pairs = pairs.index_select(1, kernels.sort_perm([pairs[0]], n))
    need(torch.equal(pairs.to(torch.int64), single.to(torch.int64)),
         f"{what}: the partitioned pairs differ from the single pass's")
    return err


def k_join_edges(device, seed: int) -> list:
    """(lkey, lvalid, rkey, rvalid, parts, what) edge cases of K11 within
    partitions and the segmented K12."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    n = 50_001
    zk = rng.integers(-4, 4, n) * 0.5
    zk[::5] = -0.0
    zr = np.concatenate([[0.0, -0.0], rng.integers(-4, 4, 3000) * 0.5])
    return [
        (t(zk), t(rng.random(n) > 0.1), t(zr), t(np.ones(len(zr), bool)), 8,
         "-0.0 against +0.0"),
        (t(rng.integers(0, 900, n)), t(rng.random(n) > 0.5),
         t(rng.integers(0, 900, 4000)), t(rng.random(4000) > 0.5), 8,
         "NULL keys on both sides"),
        (t(np.full(4000, 5, np.int64)), t(np.ones(4000, bool)),
         t(np.full(900, 5, np.int64)), t(np.ones(900, bool)), 8,
         "one hot key (3.6M pairs)"),
        (t(np.arange(7, dtype=np.int64)), t(np.ones(7, bool)),
         t(np.arange(7, dtype=np.int64)), t(np.ones(7, bool)), 64,
         "empty partitions"),
        (t(rng.integers(0, 5000, n)), t(np.ones(n, bool)),
         t(rng.integers(0, 5000, 9000)), t(np.ones(9000, bool)), 1, "P = 1"),
        (t(rng.integers(0, 5000, n)), t(np.ones(n, bool)),
         t(rng.integers(0, 5000, 9000)), t(np.ones(9000, bool)), 1024,
         "P = 1024"),
        (t(rng.integers(0, 50, 3001)), t(np.ones(3001, bool)),
         t(rng.integers(0, 50, 2049)), t(np.ones(2049, bool)), 3,
         "lengths no multiple of a tile"),
        (t(np.arange(3000, dtype=np.int64)), t(np.ones(3000, bool)),
         t(np.arange(3000, dtype=np.int64)), t(np.zeros(3000, bool)), 8,
         "a build side with no valid row"),
    ]


def phase_k(joins: tuple, batch, d_store: DistStore, d_data: dict, device,
            seed: int) -> tuple:
    """The out-of-core tier on the card (slice 9). K.1: f1_q3_join and
    f2_partsupp through HashJoinExec at a budget under the resident
    planes' pins (headroom 0, pass target budget // 8), the router's
    grace-hash passes (K21 lays each side out on the card, then K11 + K12
    a partition; the host partition codes never run), rows equal to
    budget 0 and to numpy. K.2: membudget.join_match_pairs over Q3's SF1 key planes
    (lineitem x orders, every row) on CoprMesh([cuda:0] * 8) at that
    budget: the key-partitioned probe (K21 per side, K11 within the
    partitions, the segmented K12, K17), pairs equal to budget 0's. K.4:
    date_group and q1full over Phase D's store with the headroom a quarter
    of the states estimate: the spilled states (argument planes cut by
    row on the card), rows equal to budget 0 and numpy. K.5: a DeviceOOM
    in the first pass of f1_q3_join escalates, same rows. Launch counts
    are reset before K.1 and read after K.4. K.3: K21 and the segmented
    K12 against their plain versions at K.2's shapes and on edge cases,
    timed (median of 20 CUDA-event runs) beside their bounds. Returns
    (per-kernel results, launches)."""
    t0 = time.perf_counter()
    ms = timer(device)
    cuda = device.type == "cuda"
    f_tables, f_batches = joins
    mesh_mod.set_mesh(None)
    client = GpuClient(MemStore([], []), mesh=mesh_mod.get_mesh()) if cuda \
        else GpuClient(MemStore([], []), device)

    # the answers at budget 0, before the main path's counts start
    membudget.set_budget(0)
    want_rows, sizes = {}, {}
    for name in K_JOINS:
        join, agg = f_statement(client, name, f_batches)
        want_rows[name] = k_values(agg.drain())
        res = join.device_join_result()
        sizes[name] = (len(res.lside), len(res.rside))
    n_l, n_o = batch.n_rows, f_batches[tpch.ORDERS_ID].n_rows
    lk, lv = (p[:n_l] for p in kernels.batch_planes(batch, device)
              [tpch.C_ORDERKEY])
    rk, rv = (p[:n_o] for p in kernels.batch_planes(
        f_batches[tpch.ORDERS_ID], device)[tpch.O_ORDERKEY])
    keys = (lk, lv, rk, rv)
    kmesh = CoprMesh([device] * MESH_SHARDS)
    want_pairs = membudget.join_match_pairs(
        None, None, None, None, mesh=kmesh, device_keys=keys)
    spill_sels = {name: tpch.sweep_request(name) for name in K_SPILLS}
    want_spill, est = {}, {}
    orig_states = kernels.region_agg_states_batched
    for name, sel in spill_sels.items():
        def rec(segs, dev, name=name):
            est[name] = extsort.states_bytes_estimate(segs)
            return orig_states(segs, dev)
        kernels.region_agg_states_batched = rec
        try:
            want_spill[name] = k_values(final_rows(d_store, sel))
        finally:
            kernels.region_agg_states_batched = orig_states
    # a budget under the planes the earlier phases pinned (on the card
    # they pin gigabytes): the headroom is 0 and the pass target budget //
    # 8, a sixteenth of the larger build estimate
    budget = max(membudget.build_bytes_estimate(s[1])
                 for s in sizes.values()) // 2
    pinned = membudget.usage()[1]
    print(f"phase K: {pinned} bytes pinned; join budget {budget} (pass "
          f"target {budget // 8}); states estimates {est}")

    if cuda:
        torch.cuda.synchronize()
    zero_launches()
    out_stmt = {}
    # K.1: the grace-hash passes through HashJoinExec
    membudget.set_budget(budget)
    host_codes = membudget.partition_codes
    for name in K_JOINS:
        k21_0 = kernels.LAUNCHES["key_partition"]
        # the passes lay their keys out on the card: the host partition
        # codes must not run
        membudget.partition_codes = KHostPartition()
        try:
            t1 = time.perf_counter()
            join, agg = f_statement(client, name, f_batches)
            rows = agg.drain()
            if cuda:
                torch.cuda.synchronize()
            took = (time.perf_counter() - t1) * 1e3
        finally:
            membudget.partition_codes = host_codes
        k21 = kernels.LAUNCHES["key_partition"] - k21_0
        st = join.join_stats
        need(st.get("partitioned") and not st.get("mesh_partitioned"),
             f"phase K {name}: not on the passes ({st})")
        need(st["partitions"] >= 4 and st["passes"] >= 2,
             f"phase K {name}: P {st['partitions']}, {st['passes']} passes")
        need(k21 == 2 or not cuda,
             f"phase K {name}: {k21} K21 launches, not one per side")
        need(k_values(rows) == want_rows[name],
             f"phase K {name}: rows differ from budget 0's")
        check_join_rows(name, rows, f_tables, "phase K")
        split = k_split(lambda: f_statement(client, name, f_batches)[1]
                        .drain())
        out_stmt[name] = {"ms": took, "partitions": st["partitions"],
                          "passes": st["passes"],
                          "k21_launches": k21,
                          "sizes": sizes[name], "split": split}
        print(f"  K.1 {name}: {sizes[name][0]} x {sizes[name][1]} rows, P "
              f"{st['partitions']}, {st['passes']} passes laid out by {k21} "
              f"K21 launches on the card, rows equal to "
              f"budget 0 and numpy; statement {took:.1f} ms (host clock); "
              f"split {split}")
    # K.2: the key-partitioned mesh probe
    t1 = time.perf_counter()
    st = {}
    got = membudget.join_match_pairs(None, None, None, None, stats=st,
                                     mesh=kmesh, device_keys=keys)
    took = (time.perf_counter() - t1) * 1e3
    need(st.get("mesh_partitioned") and st["mesh_shards"] == MESH_SHARDS,
         f"phase K.2: not the key-partitioned probe ({st})")
    need(np.array_equal(got[0], want_pairs[0])
         and np.array_equal(got[1], want_pairs[1]),
         "phase K.2: the partitioned pairs differ from budget 0's")
    split = k_split(lambda: membudget.join_match_pairs(
        None, None, None, None, mesh=kmesh, device_keys=keys))
    out_stmt["k2_mesh_probe"] = {"ms": took, "pairs": len(got[0]),
                                 "shard_pairs": st["shard_pairs"].tolist(),
                                 "split": split}
    print(f"  K.2: {n_l} x {n_o} rows over {MESH_SHARDS} partitions, "
          f"{len(got[0])} pairs equal to budget 0's; {took:.1f} ms (host "
          f"clock); per partition {st['shard_pairs'].tolist()}; split "
          f"{split}")
    # K.4: the spilling states
    for name, sel in spill_sels.items():
        membudget.set_budget(membudget.usage()[1] + est[name] // 4)
        g0 = dict(extsort.spill_stats)
        t1 = time.perf_counter()
        rows = final_rows(d_store, sel)
        took = (time.perf_counter() - t1) * 1e3
        passes = extsort.spill_stats["groupby_passes"] - g0["groupby_passes"]
        need(extsort.spill_stats["groupbys"] == g0["groupbys"] + 1
             and passes >= 2, f"phase K.4 {name}: did not spill")
        need(k_values(rows) == want_spill[name],
             f"phase K.4 {name}: rows differ from budget 0's")
        check_sweep(name, rows, d_data, "phase K.4")
        split = k_split(lambda: final_rows(d_store, sel))
        out_stmt[f"spill_{name}"] = {"ms": took, "passes": passes,
                                     "split": split}
        print(f"  K.4 {name} (argument planes cut by row): {passes} passes, "
              f"rows equal to budget 0 and numpy; {took:.1f} ms (host "
              f"clock); split {split}")
    launches = dict(kernels.LAUNCHES)
    for k in OOC_KERNELS:
        need(launches[k] > 0 or not cuda, f"phase K: {k} never launched")
    print(f"phase K launches: { {k: v for k, v in launches.items() if v} }")

    # K.5: a memory fault in the first pass escalates
    membudget.set_budget(budget)
    with KOomOnce() as hook:
        join, agg = f_statement(client, "f1_q3_join", f_batches)
        rows = agg.drain()
    st = join.join_stats
    need(st["partition_escalations"] == 1 and hook.calls == st["passes"] + 1
         and k_values(rows) == want_rows["f1_q3_join"],
         f"phase K.5: the escalation went wrong ({st})")
    print(f"  K.5: DeviceOOM in the first pass, P {st['partitions']} after "
          f"one escalation, {st['passes']} passes, rows unchanged")
    membudget.set_budget(0)

    # K.3: the kernels against their plain versions, timed
    err21, sel, offs = check_k21(lk, lv, MESH_SHARDS, "K21 lineitem")
    err21 = max(err21, check_k21(rk, rv, MESH_SHARDS, "K21 orders")[0])
    for key, valid, parts, what in k21_edges(device, seed + 21):
        err21 = max(err21, check_k21(key, valid, parts,
                                     f"K21 edge {what}")[0])
    err12 = check_seg_k12(lk, lv, rk, rv, MESH_SHARDS, "K.2 shapes")
    for a, b, c, d, parts, what in k_join_edges(device, seed + 23):
        err12 = max(err12, check_seg_k12(a, b, c, d, parts,
                                         f"segmented K12 edge {what}"))
    codes = kernels.partition_codes_t(lk, lv, MESH_SHARDS)
    out = {"key_partition": dict(
        ms=ms(lambda: kernels.key_partition(lk, lv, MESH_SHARDS)),
        plain_ms=ms(lambda: kernels.key_partition_plain(lk, lv,
                                                        MESH_SHARDS)),
        library_ms=ms(lambda: torch.sort(codes, stable=True)),
        max_abs_err=err21,
        bound=bound(n_l * 17 + (MESH_SHARDS + 1) * 8, n_l * 12))}
    # K11 within K21's partitions at the orders side (f1's keys, in key
    # order within each partition: no pass) and under a seeded permutation
    shuf = torch.from_numpy(np.random.default_rng(seed + 25).permutation(
        rk.shape[0])).to(device)
    k11p = {}
    for what, k_, v_ in (("orders", rk, rv),
                         ("orders shuffled", rk.index_select(0, shuf),
                          rv.index_select(0, shuf))):
        sel_, off_ = kernels.key_partition(k_, v_, MESH_SHARDS)
        pk_, pv_ = k_.index_select(0, sel_), v_.index_select(0, sel_)
        before = kernels.LAUNCHES["radix_pass"]
        got = kernels.join_build_partitioned(pk_, pv_, off_)
        passes = kernels.LAUNCHES["radix_pass"] - before
        want = kernels.join_build_partitioned_plain(pk_, pv_, off_)
        need(all(torch.equal(x, y) for x, y in zip(got, want)),
             f"phase K: K11 within partitions ({what}) differs from its "
             "plain version")
        k11p[what] = {"partitions": MESH_SHARDS, "passes": passes,
                      "ms": ms(lambda: kernels.join_build_partitioned(
                          pk_, pv_, off_)),
                      "plain_ms": ms(lambda: kernels
                                     .join_build_partitioned_plain(
                                         pk_, pv_, off_))}
    print("phase K: K11 within partitions " + json.dumps(k11p))
    a = k_segmented(lk, lv, rk, rv, MESH_SHARDS)
    pairs, _t = kernels.join_probe_partitioned(**a)
    nv = a["words"].shape[0]
    steps = max(int(max(nv // MESH_SHARDS, 1)).bit_length(), 1)
    out["join_probe_seg"] = dict(
        ms=ms(lambda: kernels.join_probe_partitioned(**a)),
        plain_ms=ms(lambda: kernels.join_probe_partitioned_plain(**a)),
        library_ms=None, max_abs_err=err12,
        bound=bound(n_l * 17 + nv * 16 + pairs.numel() * pairs.element_size()
                    + 2 * (MESH_SHARDS + 1) * 8, n_l * 2 * steps))
    for name, r in out.items():
        print(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']}, bound {r['bound'][0]:.4f} ms by "
              f"{r['bound'][1]}), max_abs_err {r['max_abs_err']}")
    print("phase K statements: " + json.dumps(out_stmt))
    print(f"phase K: {time.perf_counter() - t0:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# Phase L: the cluster joins at SF1 (slice 10)
# ---------------------------------------------------------------------------

L_REGIONS = 8
# the lineitem columns the join statements read; the other tables whole
L_LINEITEM_CIDS = [tpch.C_ORDERKEY, tpch.C_PARTKEY, tpch.C_SUPPKEY,
                   tpch.C_FDISCOUNT, tpch.C_SHIPDATE]
L_RUNGS = ("one_shard", "mesh8", "mesh_off")


def l_store(tables: dict, device) -> tuple:
    """A DistStore holding lineitem, orders and partsupp in 8 regions each
    (TiKV's 96 MiB regions at SF1) and prio in one, with the region
    batches built straight from the arrays: (store, {table id: batches})."""
    splits, batches = [], {}
    for tid in (tpch.TABLE_ID, tpch.ORDERS_ID, tpch.PARTSUPP_ID,
                tpch.PRIO_ID):
        spec, words = tpch.JOIN_TABLES[tid]
        arrays = tables[tid]
        n = next(iter(arrays.values())).shape[0]
        cids = L_LINEITEM_CIDS if tid == tpch.TABLE_ID else sorted(spec)
        bounds = tpch.region_bounds(n, 1 if tid == tpch.PRIO_ID
                                    else L_REGIONS)
        splits.append(tc.encode_record_range(tid)[0])
        splits += [tc.encode_row_key(tid, lo + 1) for lo, _hi in bounds[1:]]
        batches[tid] = [tpch.table_batch(spec, arrays, cids, words, lo, hi)
                        for lo, hi in bounds]
    store = DistStore([], sorted(splits), device,
                      plane_cache=PlaneCache(device=device))
    return store, batches


def l_admit(store: DistStore, sel: SelectRequest, batches: list) -> None:
    """Admit the table's region batches, pinned, under the plane-cache
    keys the region handler computes for `sel` (the regions the table's
    range crosses, in order)."""
    req = tpch.store_request(sel)
    version = store.data_version_at(
        sel.start_ts, tc.table_prefix(sel.table_info.table_id))
    left = list(batches)
    for region in store.cluster.regions:
        ranges = clip_ranges(region, req.key_ranges)
        if ranges:
            need(bool(left), "phase L: more regions than batches")
            key = columnar_region.cache_key(region.region_id, sel, ranges)
            store.plane_cache.insert(key, region.epoch(), version,
                                     left.pop(0))
    need(not left, "phase L: a batch with no region")


def l_statement(store: DistStore, name: str) -> tuple:
    """(HashJoinExec, HashAggExec) of a join statement over the store:
    two XSelectTableExec scans through its DistCoprClient."""
    left, right, plan, aggs, group_by = tpch.join_statement(name)
    kids = [XSelectTableExec(store.get_client(), sel,
                             tpch.store_request(sel).key_ranges)
            for sel in (left, right)]
    join = HashJoinExec(kids[0], kids[1], plan)
    return join, HashAggExec(join, aggs, group_by)


def l_rung(rung: str, mesh8) -> None:
    """Set the process mesh for one way of running the statements."""
    mesh_mod.set_mesh(mesh8 if rung == "mesh8" else None)
    mesh_mod.set_enabled(rung != "mesh_off")


# the kernels row 15f launches: K6 (any route) and K7's shard fold
L_15F_KERNELS = K6_ROUTES + ("combine_partials",)


class LCapture:
    """Keeps the arguments of the 8-shard combine_rows_sharded calls, by
    the statement (`current`) that made them, and counts the launches
    made inside every combine_rows_sharded call (`launches`: the K6 and
    K7 counts of kernels.LAUNCHES, which their wrappers add where they
    launch)."""

    def __init__(self):
        self.calls = {}
        self.current = None
        self.launches = 0
        self._orig = mesh_mod.combine_rows_sharded

    def __enter__(self):
        def rec(mesh, specs, gid, G, slices, region_ids=None, epochs=None,
                plain=False):
            if mesh.n > 1 and not plain:
                self.calls.setdefault(self.current, (
                    mesh, specs, gid, G, slices, region_ids, epochs))
            before = sum(kernels.LAUNCHES[k] for k in L_15F_KERNELS)
            out = self._orig(mesh, specs, gid, G, slices, region_ids,
                             epochs, plain)
            self.launches += sum(kernels.LAUNCHES[k]
                                 for k in L_15F_KERNELS) - before
            return out
        mesh_mod.combine_rows_sharded = rec
        return self

    def __exit__(self, *exc):
        mesh_mod.combine_rows_sharded = self._orig


def l_inf_specs(seed: int) -> tuple:
    """(specs, gid, G, slices, region ids) over 6 regions with empty
    groups, a group of only -2^63, one of only +inf and one of only -inf
    (the row 15f edge case)."""
    rng = np.random.default_rng(seed)
    lens = [3701, 0, 21011, 517, 9623, 14001]
    n, G = sum(lens), 2003
    gid = rng.integers(0, G - 3, n).astype(np.int64)
    iv = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    fv = rng.integers(-800, 800, n) * 0.25
    ok = rng.random(n) > 0.15
    for g in (3, 5, 6):
        gid[gid == g] = 7
    gid[:3], iv[:3] = 3, -(1 << 63)
    gid[3:9] = [5, 5, 5, 6, 6, 6]
    fv[3:9] = [np.inf] * 3 + [-np.inf] * 3
    ok[:9] = True
    specs = [("sum", None, ok), ("sum", iv, ok), ("min", iv, ok),
             ("max", iv, ok), ("min", fv, ok), ("max", fv, ok)]
    cuts = np.concatenate([[0], np.cumsum(lens)])
    return (specs, gid, G, [(int(a), int(b)) for a, b in
                            zip(cuts[:-1], cuts[1:])],
            [11, 3, 250, 7, 64, 1000])


def l_numpy_states(specs, gid, G) -> list:
    out = []
    for op, vals, ok in specs:
        if vals is None:
            out.append(np.bincount(gid[ok], minlength=G).astype(np.int64))
            continue
        f = vals.dtype == np.float64
        if op == "sum":
            acc = np.zeros(G, vals.dtype)
            np.add.at(acc, gid[ok], vals[ok])
        elif op == "min":
            acc = np.full(G, np.inf if f else (1 << 63) - 1, vals.dtype)
            np.minimum.at(acc, gid[ok], vals[ok])
        else:
            acc = np.full(G, -np.inf if f else -(1 << 63), vals.dtype)
            np.maximum.at(acc, gid[ok], vals[ok])
        out.append(acc)
    return out


def l_same_states(got: list, want: list, what: str) -> None:
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        need(g.dtype == w.dtype and g.shape == w.shape
             and np.array_equal(g.view(np.int64), w.view(np.int64)),
             f"{what}: state {j} differs from numpy")


def l_inf_edges(device, mesh8) -> int:
    """The f64 extremum identity on the card: K2, K3, K4, K6 (all three
    routes), K7, the sharded states combine (row 15c), row 15f and K15
    over groups made only of +inf (MIN) or -inf (MAX), against numpy.
    Returns the number of checks."""
    rng = np.random.default_rng(77)
    n = 200_003
    gid = rng.integers(3, 90, n).astype(np.int64)
    f = rng.integers(-80, 80, n) * 0.5
    gid[:6] = [0, 0, 0, 1, 1, 1]
    f[:6] = [np.inf] * 3 + [-np.inf] * 3
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    fv = t(f)
    reds = [kernels.Red(kernels.R_MIN_F, fv), kernels.Red(kernels.R_MAX_F,
                                                          fv)]
    checks = 0
    # K2 over a mask of only +inf rows, then only -inf rows
    for g, j, want in ((0, 0, np.inf), (1, 1, -np.inf)):
        _n, acc = kernels.scalar_agg(t(gid == g), reds)
        got = acc.view(torch.float64).cpu().numpy()[j]
        need(got == want, f"phase L edge: K2 answers {got} over only "
             f"{want}")
        checks += 1
    # K3 (4 segments) and K4 (90): groups 0 / 1 only +-inf, 2 empty
    for S, route in ((4, kernels.seg_agg_onehot),
                     (90, kernels.seg_agg_sorted)):
        keep = gid < S
        cnt, acc = route(t(gid[keep]), t(np.ones(int(keep.sum()), bool)),
                         S, [kernels.Red(kernels.R_MIN_F, t(f[keep])),
                             kernels.Red(kernels.R_MAX_F, t(f[keep]))])
        mn = acc[0].view(torch.float64).cpu().numpy()
        mx = acc[1].view(torch.float64).cpu().numpy()
        need((mn[0], mx[1], mn[2], mx[2]) == (np.inf, -np.inf, np.inf,
                                               -np.inf)
             and int(cnt[0][2]) == 0,
             f"phase L edge: {route.__name__} over only +-inf")
        checks += 1
    # K6 on its two routes (90 and 3,000 segments: the block route's
    # small-span instantiation, two blocks an SM; 7,000: one block an SM;
    # 40,000 past the opt-in shared memory: sorted), then K7 over the
    # regions' states
    for G in (90, 3_000, 7_000, 40_000):
        g2 = gid.copy()
        if G > 90:
            g2[6:] = rng.integers(3, G, n - 6)
        half = n // 2
        segs = [(g2[a:b].copy(), [("min", t(f[a:b]), np.ones(b - a, bool)),
                                  ("max", t(f[a:b]), np.ones(b - a, bool))],
                 G, b - a) for a, b in ((0, half), (half, n))]
        outs = kernels.region_agg_states_batched(segs, device)
        need((outs[0][0][0], outs[0][1][1]) == (np.inf, -np.inf),
             f"phase L edge: K6 ({G} segments) over only +-inf")
        folded = kernels.combine_region_partials(
            [np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs])],
            ["min", "max"], device)
        need((folded[0][0], folded[1][1], folded[0][2], folded[1][2])
             == (np.inf, -np.inf, np.inf, -np.inf),
             f"phase L edge: K7 over only +-inf ({G} segments)")
        checks += 2
        if G == 90:
            sharded = mesh_mod.combine_states_sharded(
                [np.stack([o[0] for o in outs]),
                 np.stack([o[1] for o in outs])], ["min", "max"], mesh8)
            need((sharded[0][0], sharded[1][1]) == (np.inf, -np.inf),
                 "phase L edge: the sharded states combine over only +-inf")
            checks += 1
    # row 15f over the card's 8 shards and its plain version
    specs, rgid, G, slices, rids = l_inf_specs(79)
    want = l_numpy_states(specs, rgid, G)
    for plain in (False, True):
        l_same_states(mesh_mod.combine_rows_sharded(
            mesh8, specs, rgid, G, slices, rids, plain=plain), want,
            f"phase L edge: row 15f (plain {plain})")
        checks += 1
    # K15: slots whose WHERE keeps only +inf rows, only -inf rows, none
    from tidb_tpu_torch.ops import sched
    m, cap = 40, 1024
    a = np.zeros(cap, np.int64)
    a[:m] = np.arange(m) % 4
    fs = np.zeros(cap)
    fs[:m] = np.where(a[:m] == 0, np.inf,
                      np.where(a[:m] == 1, -np.inf, np.arange(m) * 0.5))
    valid = np.zeros(cap, bool)
    valid[:m] = True
    sb = carry.batch_from_planes(m, cap, np.arange(1, cap + 1), {
        1: {"values": a, "valid": valid, "kind": col.K_I64},
        2: {"values": fs, "valid": valid, "kind": col.K_F64}})
    fin, pools = None, []
    for x in (0, 1, 9):
        lw = sched._Lowerer(sb)
        emit, _sig = lw.lower(expr_op(Op.EQ, expr_column(1),
                                      expr_value(Datum.i64(x))))
        fin = lw.program(sb, emit)
        pools.append(fin.pool)
    planes = kernels.batch_planes(sb, device)
    sreds = [kernels.Red(kernels.R_MIN_F, planes[2][0]),
             kernels.Red(kernels.R_MAX_F, planes[2][0])]
    cnt, acc = kernels.slot_agg(fin, torch.from_numpy(np.stack(pools)),
                                [planes[k][w] for k, w in fin.plane_keys],
                                kernels.device_live(sb, device), sreds)
    got = acc.view(torch.float64).cpu().numpy()
    need(cnt[:, 0].tolist() == [10, 10, 0]
         and (got[0, 0], got[1, 1], got[2, 0], got[2, 1])
         == (np.inf, -np.inf, np.inf, -np.inf),
         "phase L edge: K15 over only +-inf")
    return checks + 1


def l_15f_bytes(specs: list, gid: np.ndarray, G: int) -> int:
    """Bytes row 15f must move at least: the live rows' group ids, each
    spec's contrib mask and values once (K6 reads only each span's live
    rows, never the layout's padding), the [G] states once."""
    total = gid.nbytes + len(specs) * G * 8
    for _op, v, ok in specs:
        total += ok.nbytes + (0 if v is None else v.nbytes)
    return total


def phase_l(joins: tuple, device, seed: int) -> tuple:
    """The cluster joins at SF1 (slice 10): lineitem, orders and partsupp
    in 8 regions each, admitted pinned into one DistStore; tpch.JOINS
    through XSelectTableExec over its DistCoprClient (a plain scan per
    region: one K1 each, stacked into a ColumnarPartialSet), HashJoinExec
    and HashAggExec, whose fused aggregate combines the regions' partial
    states: on the default one-shard mesh (row 15f, one K6 span), on
    CoprMesh([cuda:0] * 8) (row 15f: K6 over the shard layout, K7's shard
    fold) and with the mesh off (one K6 span, no fold). Each run equals
    numpy and Phase F's in-process answer; its time (host clock, median
    of 3) and split. Then row 15f at f1's 8-shard shape against its plain
    version, timed beside its bound and a scatter_reduce_ yardstick, and
    the +-inf edge check of every extremum route. Launch counts are reset
    before the statements and read after them. Returns (per-kernel
    results, launches)."""
    t0 = time.perf_counter()
    ms = timer(device)
    cuda = device.type == "cuda"
    f_tables, f_batches = joins
    store, batches = l_store(f_tables, device)
    for name in tpch.JOINS:
        left, right, *_rest = tpch.join_statement(name)
        for sel in (left, right):
            l_admit(store, sel, batches[sel.table_info.table_id])
    mesh8 = CoprMesh([device] * MESH_SHARDS)
    # Phase F's in-process answers, before the counts start
    client = GpuClient(MemStore([], []), device)
    want = {name: k_values(f_statement(client, name, f_batches)[1].drain())
            for name in tpch.JOINS}
    print(f"phase L: {L_REGIONS} regions a table, store built and Phase F's "
          f"answers in {time.perf_counter() - t0:.1f} s")

    if cuda:
        torch.cuda.synchronize()
    zero_launches()
    stmt = {}
    with LCapture() as cap:
        for rung in L_RUNGS:
            l_rung(rung, mesh8)
            for name in tpch.JOINS:
                cap.current = name
                before = dict(kernels.LAUNCHES)
                st0 = dict(fused_agg.stats)
                t1 = time.perf_counter()
                join, agg = l_statement(store, name)
                rows = agg.drain()
                if cuda:
                    torch.cuda.synchronize()
                took = (time.perf_counter() - t1) * 1e3
                delta = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                         if v != before[k]}
                check_join_rows(name, rows, f_tables, f"phase L {rung}")
                need(k_values(rows) == want[name],
                     f"phase L {rung} {name}: rows differ from Phase F's")
                res = join.device_join_result()
                need(isinstance(res.lside, col.ColumnarPartialSet)
                     and len(res.region_slices() or ()) == L_REGIONS,
                     f"phase L {rung} {name}: not over {L_REGIONS} regions")
                on_mesh = fused_agg.stats["mesh_combines"] \
                    - st0["mesh_combines"]
                # the mesh rung on the card's default one-shard mesh too
                # (a CPU rehearsal has no default mesh)
                want_mesh = rung != "mesh_off" if cuda else rung == "mesh8"
                need(fused_agg.stats["partial_combines"]
                     == st0["partial_combines"] + 1
                     and on_mesh == want_mesh,
                     f"phase L {rung} {name}: the region combine went wrong")
                k1 = delta.get("expr_vm", 0)
                need(not cuda or (k1 == L_REGIONS + len(
                    res.rside.parts if isinstance(res.rside,
                                                  col.ColumnarPartialSet)
                    else [res.rside])
                    and sum(delta.get(k, 0) for k in K6_ROUTES) == 1
                    and delta.get("combine_partials", 0)
                    == (rung == "mesh8")),
                     f"phase L {rung} {name}: launches {delta}")
                wall = host_ms(lambda: l_statement(store, name)[1].drain(), 3)
                split = k_split(lambda: l_statement(store, name)[1].drain())
                stmt[f"{rung}/{name}"] = {"first_ms": took, "ms": wall,
                                          "launches": delta, "split": split}
                print(f"  L {rung} {name}: {len(rows)} rows equal to numpy "
                      f"and Phase F; {took:.1f} ms first, {wall:.1f} ms "
                      f"median of 3 (host clock); launches {delta}; split "
                      f"{split}")
    launches = {"combine_rows_sharded": cap.launches}
    need(launches["combine_rows_sharded"] > 0 or not cuda,
         "phase L: row 15f never launched")
    mesh_mod.set_mesh(None)
    mesh_mod.set_enabled(True)
    print(f"phase L launches: "
          f"{ {k: v for k, v in kernels.LAUNCHES.items() if v} }, row 15f "
          f"{launches['combine_rows_sharded']}")

    # row 15f at f1_q3_join's 8-shard shape, against its plain version
    need("f1_q3_join" in cap.calls,
         "phase L: no 8-shard combine captured for f1_q3_join")
    m8, specs, gid, G, slices, rids, eps = cap.calls["f1_q3_join"]
    got = mesh_mod.combine_rows_sharded(m8, specs, gid, G, slices, rids, eps)
    plain = mesh_mod.combine_rows_sharded(m8, specs, gid, G, slices, rids,
                                          eps, plain=True)
    err = 0.0
    for a, b in zip(got, plain):
        need(np.array_equal(np.asarray(a).view(np.int64),
                            np.asarray(b).view(np.int64)),
             "phase L: row 15f differs from its plain version")
    gsh, ssh, caps, nrows = mesh_mod._rows_layout(m8, specs, gid, G, slices,
                                                  rids, eps)
    k6 = kernels.row_spans_inputs(gsh, ssh, caps, device)

    def launch(plain_=False):
        return kernels.span_states_fold(k6[0], caps, nrows, G, k6[1], k6[2],
                                        k6[3], kernels.mesh_allreduce,
                                        plain=plain_)

    # the yardstick: one scatter_reduce_ per spec over the layout's rows
    # into [G + 1] (padding in the sink), contributions masked beforehand
    lib_in = []
    for (op, v, _ok), code, c in zip(ssh, k6[3], k6[2]):
        v = torch.ones_like(k6[0]) if v is None \
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
        how = {"sum": "sum", "min": "amin", "max": "amax"}[op]
        ident = 0 if how == "sum" else kernels._sentinel(code)
        lib_in.append((torch.where(c, v, torch.full_like(v, ident)), how,
                       ident))

    def library():
        for v, how, ident in lib_in:
            torch.full((G + 1,), ident, dtype=v.dtype,
                       device=device).scatter_reduce_(0, k6[0], v, how)

    out = {"combine_rows_sharded": dict(
        ms=ms(launch), plain_ms=ms(lambda: launch(True)),
        library_ms=ms(library), max_abs_err=err,
        bound=bound(l_15f_bytes(specs, gid, G), 0))}
    r = out["combine_rows_sharded"]
    print(f"  row 15f (f1_q3_join, {MESH_SHARDS} shards x {caps[0]} rows, "
          f"{len(specs)} states, G {G}): {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
          f"{r['bound'][0]:.4f} ms by {r['bound'][1]}), max_abs_err {err}")
    checks = l_inf_edges(device, mesh8)
    print(f"phase L edge: {checks} +-inf checks equal to numpy (K2, K3, K4, "
          f"K6 on its two routes, K7, row 15c, row 15f and its plain "
          f"version, K15)")
    print("phase L statements: " + json.dumps(stmt))
    print(f"phase L: {time.perf_counter() - t0:.1f} s")
    return out, launches


def _chained_torch_sort(planes: list):
    """The library yardstick: chained torch.sort(stable=True) over the
    raw planes, least significant first."""
    perm = None
    for p in planes:
        _, idx = torch.sort(p if perm is None else p[perm], stable=True)
        perm = idx if perm is None else perm[idx]
    return perm


def same_g(got: list, want: list, what: str) -> None:
    need(got == want, f"{what}: {got[:3]} ... vs numpy {want[:3]} ... "
         f"({len(got)} vs {len(want)} rows)")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print_versions()
    build()
    launches = phase_a(tpch.SF001_ROWS, seed=1, device=None)
    results, data, batch = phase_b(tpch.SF1_ROWS, seed=2, device=device,
                                   edge_cap=1 << 20)
    e_results, e_launches = phase_e(data, batch, device, seed=5)
    f_results, f_launches, joins = phase_f(data, batch, device, seed=2)
    g_results, g_launches = phase_g(batch, device, seed=9)
    h_results, h_launches = phase_h(data, batch, device, seed=2)
    launches.update({k: e_launches[k] for k in SLICE3_KERNELS})
    launches.update({k: f_launches[k] for k in JOIN_KERNELS})
    launches.update({k: g_launches[k] for k in SLOT_KERNELS})
    launches.update({k: h_launches[k] for k in SORT_KERNELS})
    results.update(e_results)
    results.update(f_results)
    results.update(g_results)
    results.update(h_results)
    c_launches, c_results = phase_c(tpch.SF001_ROWS, seed=1, device=device)
    launches.update(c_launches)
    results.update(c_results)
    d_results, d_store, d_data, d_launches = phase_d(tpch.SF1_ROWS, seed=2,
                                                     device=device)
    results.update(d_results)
    # the sorted route's main-path launches: d_supplier's (Phase D); the
    # sweep's spans fit shared memory in Phase C
    launches.update(d_launches)
    j_results, j_launches, _timed = phase_j(data, batch, d_store, d_data,
                                            joins, device, seed=14)
    results.update(j_results)
    launches.update(j_launches)
    k_results, k_launches = phase_k(joins, batch, d_store, d_data, device,
                                    seed=16)
    results.update(k_results)
    launches.update({k: k_launches[k] for k in OOC_KERNELS})
    l_results, l_launches = phase_l(joins, device, seed=18)
    del data, batch, joins
    results.update(l_results)
    launches.update(l_launches)
    i_results, i_launches = phase_i(d_store, d_data, device, seed=12)
    results.update(i_results)
    launches.update(i_launches)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        # a second shape of one route counts the route's launches
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches[name.split("/")[0]],
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
