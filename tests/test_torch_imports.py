"""The port imports neither JAX nor anything of the JAX package.

The AST scan covers every module of tidb_tpu_torch (cluster/, distsql/,
executor/ and the join path's modules included), chip_smoke.py and the
card scripts beside it (compare_trees.py, k6_window_sweep.py); the
subprocess tests run TPC-H Q1 through GpuClient(device="cpu"), the
slice-3 shapes (a ranked group-by, DISTINCT, TopN) through it too, Q1
through the cluster path over two regions, and a join statement through
XSelectTableExec → HashJoinExec → HashAggExec, the out-of-core tier (a
join in grace-hash passes and through the key-partitioned mesh probe,
spilled group-by states), in a fresh interpreter (tests/conftest.py
imports jax into this one) and look at what got loaded. Without CUDA, the
join path asked for the card raises. The parity test files
(tests/test_torch_*.py) import both packages by design and are not
scanned.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                           "compare_trees.py",
                                           "k6_window_sweep.py",
                                           "k18_stamps.py")]
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT,
                                                      "tidb_tpu_torch")):
        out.extend(os.path.join(dirpath, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tidb_tpu")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            f = node.func
            fname = getattr(f, "id", None) or getattr(f, "attr", None)
            if fname in ("__import__", "import_module") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.args[0].value


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_scan_finds_the_port():
    files = _port_files()
    assert any(p.endswith(os.path.join("ops", "client.py")) for p in files)
    for sub in ("cluster", "distsql", "executor", "parallel"):
        assert any(os.path.join("tidb_tpu_torch", sub, "") in p
                   for p in files), sub
    for mod in (("copr", "dictionary.py"), ("executor", "executors.py"),
                ("executor", "distsql_exec.py"), ("plan.py",),
                ("ops", "membudget.py"), ("ops", "extsort.py"),
                ("ops", "mesh.py")):
        assert any(p.endswith(os.path.join("tidb_tpu_torch", *mod))
                   for p in files), mod
    assert len(files) >= 25


_DRIVE_Q1 = r"""
import sys
sys.path.insert(0, {root!r})
from tidb_tpu_torch import tpch
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient
data = tpch.generate(500, seed=3)
store = MemStore.from_pairs(tpch.kv_pairs(data))
client = GpuClient(store, device="cpu")
resp = client.send(tpch.store_request(tpch.q1())).next()
assert resp.row_count() >= 3, resp.row_count()
assert client.stats["gpu_requests"] == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


_DRIVE_SLICE3 = r"""
import sys
sys.path.insert(0, {root!r})
from tidb_tpu_torch import tpch
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient
data = tpch.generate(500, seed=3)
store = MemStore.from_pairs(tpch.kv_pairs(data))
client = GpuClient(store, device="cpu")
for name, make in tpch.SLICE3:
    resp = client.send(tpch.store_request(make())).next()
    assert resp.row_count() >= 1, name
assert client.stats["gpu_requests"] == len(tpch.SLICE3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


_DRIVE_CLUSTER_Q1 = r"""
import sys
sys.path.insert(0, {root!r})
from tidb_tpu_torch import distsql, tpch
from tidb_tpu_torch.cluster.store import DistStore
from tidb_tpu_torch.executor import fused_agg
from tidb_tpu_torch.ops import kernels
data = tpch.generate(500, seed=3)
store = DistStore(tpch.kv_pairs(data), tpch.split_keys(500, 2), device="cpu")
sel = tpch.sweep_request("q1full")
res = distsql.select(store.get_client(), tpch.store_request(sel)).columnar()
rows = fused_agg.final_states(sel, res)
assert len(rows) >= 3, rows
assert kernels.CALLS == {{"region_filter_batched": 1,
                         "region_agg_states_batched": 1,
                         "combine_region_partials": 1,
                         "mesh_allreduce": 0}}, kernels.CALLS
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


_DRIVE_JOIN = r"""
import sys
sys.path.insert(0, {root!r})
from tidb_tpu_torch import tpch
from tidb_tpu_torch.executor.distsql_exec import XSelectTableExec
from tidb_tpu_torch.executor.executors import HashAggExec, HashJoinExec
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient
data = tpch.generate(2000, seed=3)
tables = tpch.join_data(data, 3)
lineitem = [tpch.C_ORDERKEY, tpch.C_PARTKEY, tpch.C_SUPPKEY,
            tpch.C_FDISCOUNT, tpch.C_SHIPDATE]
client = GpuClient(MemStore([], []), device="cpu")
for name in tpch.JOINS:
    left, right, plan, aggs, group_by = tpch.join_statement(name)
    kids = []
    for sel in (left, right):
        tid = sel.table_info.table_id
        req = tpch.store_request(sel)
        client.admit(sel, req.key_ranges, tpch.join_batch(
            tables, tid, lineitem if tid == tpch.TABLE_ID else None))
        kids.append(XSelectTableExec(client, sel, req.key_ranges))
    join = HashJoinExec(kids[0], kids[1], plan)
    rows = HashAggExec(join, aggs, group_by).drain()
    got = [[d.val.encode() if isinstance(d.val, str) else d.val
            for d in row] for row in rows]
    assert got == tpch.join_expected(name, tables), name
    assert join.join_stats["path"] == "device", join.join_stats
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


_DRIVE_TIER = r"""
import sys, threading, time
sys.path.insert(0, {root!r})
from tidb_tpu_torch import tpch
from tidb_tpu_torch.copr.proto import iter_response_rows
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient
data, words = tpch.supplier(800, seed=3)
store = MemStore.from_pairs(tpch.supplier_pairs(data, words))
client = GpuClient(store, device="cpu", batch_window_ms=300)
client.send(tpch.g_statement("g_topn", 0)).next()    # pack the batch once
sched = client._sched
sched._last_multi = time.monotonic()        # traffic: the gate is open
def gather(_w):                             # the leader waits for all four
    while len(sched._queue) < 4:
        time.sleep(0.005)
sched._gather = gather
out = {{}}
barrier = threading.Barrier(4)
def run(t):
    barrier.wait()
    resp = client.send(tpch.g_statement("g_topn", t)).next()
    out[t] = [(h, [d.val for d in ds]) for h, ds in iter_response_rows(resp)]
ths = [threading.Thread(target=run, args=(t,)) for t in range(4)]
for th in ths:
    th.start()
for th in ths:
    th.join(60)
for t in range(4):
    assert out[t] == tpch.g_expected("g_topn", t, data, words), t
assert client.stats["batch_sizes"] == {{4: 1}}, client.stats
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


_DRIVE_SORT = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from tidb_tpu_torch import plan
from tidb_tpu_torch.carry import RowsExec
from tidb_tpu_torch.executor.window import WindowExec
from tidb_tpu_torch.ops import extsort, membudget
from tidb_tpu_torch.types.datum import Datum
rng = np.random.default_rng(3)
n = 9000
planes = [rng.integers(0, 50, n), np.ones(n, np.int8),
          rng.standard_normal(n), (rng.random(n) < 0.1).astype(np.int8)]
membudget.set_budget(extsort.sort_bytes_estimate(planes, n) // 3)
st = {{}}
order = extsort.sort_order(planes, n, stats=st, device="cpu")
assert np.array_equal(order, np.lexsort(planes)) and st["sort_passes"] >= 2
rows = [[Datum.i64(i), Datum.i64(i % 7)] for i in range(n)]
desc = plan.WindowFuncDesc("rank", [], [plan.Column(1)], [
    plan.SortItem(plan.Column(0), True)])
out = WindowExec(RowsExec(rows, 2), [desc], device="cpu").drain()
assert [r[2].val for r in out[:3]] == [1286, 1286, 1286], out[:3]
membudget.set_budget(0)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


_DRIVE_OUT_OF_CORE = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from tidb_tpu_torch.ops import extsort, kernels, membudget
from tidb_tpu_torch.parallel import CoprMesh
rng = np.random.default_rng(3)
lk, lv = rng.integers(0, 900, 9000), rng.random(9000) > 0.1
rk, rv = rng.integers(0, 900, 4000), rng.random(4000) > 0.1
membudget.set_budget(0)
want = membudget.join_match_pairs(lk, lv, rk, rv, device="cpu")
membudget.set_budget(32 * 1024)
for mesh in (None, CoprMesh(["cpu"] * 8)):
    st = {{}}
    got = membudget.join_match_pairs(lk, lv, rk, rv, stats=st, mesh=mesh,
                                     device="cpu")
    assert st["partitioned"] and st["passes"] >= 2, st
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
gid = rng.integers(0, 2000, 6000)
vals = torch.from_numpy(rng.integers(-9, 9, 6000))
ok = rng.random(6000) > 0.1
segs = [(gid, [("sum", vals, ok), ("min", vals, ok)], 2000, 6000)]
one = kernels.region_agg_states_batched(segs, "cpu")
membudget.set_budget(extsort.states_bytes_estimate(segs) // 4)
st = {{}}
got = extsort.region_states_spill(segs, "cpu", st)
assert st["states_passes"] >= 2, st
assert all(np.array_equal(a, b) for a, b in zip(got[0], one[0]))
membudget.set_budget(0)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))
print("LOADED", bad)
"""


def _run_without_jax(script: str) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_q1_runs_without_jax():
    _run_without_jax(_DRIVE_Q1)


def test_slice3_runs_without_jax():
    _run_without_jax(_DRIVE_SLICE3)


def test_cluster_q1_runs_without_jax():
    _run_without_jax(_DRIVE_CLUSTER_Q1)


def test_join_runs_without_jax():
    _run_without_jax(_DRIVE_JOIN)


def test_tier_runs_without_jax():
    _run_without_jax(_DRIVE_TIER)


def test_tier_client_without_cuda_raises():
    """A client with the micro-batch tier on asks for the card like any
    other: without CUDA it raises, and a slot kernel handed a tensor on no
    supported device raises rather than running its plain version."""
    from tidb_tpu_torch.errors import DeviceError
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.ops import kernels
    from tidb_tpu_torch.ops.client import GpuClient
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the card is there")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        GpuClient(MemStore([], []), micro_batch=True, batch_window_ms=2)
    words = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(DeviceError, match="no kernel for device"):
        kernels.slot_topn(words, [], 4)


def test_join_path_without_cuda_raises():
    """The card is the default: without CUDA a client, or a join with no
    device of its own, raises DeviceError instead of running the plain
    versions."""
    from tidb_tpu_torch import carry, tpch
    from tidb_tpu_torch.errors import DeviceError
    from tidb_tpu_torch.executor.executors import HashJoinExec
    from tidb_tpu_torch.kv.memstore import MemStore
    from tidb_tpu_torch.ops import columnar as col
    from tidb_tpu_torch.ops.client import GpuClient
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the card is there")
    with pytest.raises(DeviceError, match="CUDA is not available"):
        GpuClient(MemStore([], []))
    _l, _r, plan, _a, _g = tpch.join_statement("f1_q3_join")
    side = carry.SideExec(col.RowsSide([]), 4)
    with pytest.raises(DeviceError, match="CUDA is not available"):
        HashJoinExec(side, side, plan)


def test_sort_and_window_run_without_jax():
    _run_without_jax(_DRIVE_SORT)


def test_sort_kernels_without_cuda_raise():
    """Asked for the card without CUDA, the external sort raises at its
    device route, and K17 / K18 handed a tensor on no supported device
    raise rather than run their plain versions."""
    import numpy as np

    from tidb_tpu_torch.errors import DeviceError
    from tidb_tpu_torch.ops import extsort, kernels, membudget
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the card is there")
    planes = [np.arange(5000, dtype=np.int64)[::-1].copy(),
              np.ones(5000, np.int8)]
    membudget.set_budget(1 << 30)
    try:
        with pytest.raises(DeviceError, match="CUDA is not available"):
            extsort.sort_order(planes, 5000)
    finally:
        membudget.set_budget(0)
    assert membudget.usage() == (0, 0)
    meta = torch.zeros(16, dtype=torch.int64, device="meta")
    with pytest.raises(DeviceError, match="no kernel for device"):
        kernels.sort_perm([meta], 16)
    with pytest.raises(DeviceError, match="no kernel for device"):
        kernels.window_scan(meta, meta, [("row_number", None, None)], 16)


def test_out_of_core_tier_runs_without_jax():
    _run_without_jax(_DRIVE_OUT_OF_CORE)


def test_partition_kernels_without_cuda_raise():
    """K21 and the segmented K12 handed tensors on no supported device
    raise rather than run their plain versions."""
    from tidb_tpu_torch.errors import DeviceError
    from tidb_tpu_torch.ops import kernels
    meta = torch.zeros(16, dtype=torch.int64, device="meta")
    mvalid = torch.zeros(16, dtype=torch.bool, device="meta")
    with pytest.raises(DeviceError, match="no kernel for device"):
        kernels.key_partition(meta, mvalid, 8)
    offs = torch.zeros(9, dtype=torch.int64, device="meta")
    with pytest.raises(DeviceError, match="no kernel for device"):
        kernels.join_probe_partitioned(meta, meta, offs, meta, mvalid, offs,
                                       meta)
    with pytest.raises(DeviceError, match="partitions"):
        kernels.key_partition(meta, mvalid, 2048)
