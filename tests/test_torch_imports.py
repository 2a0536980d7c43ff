"""The port imports neither JAX nor anything of the JAX package.

The AST scan covers every module of tidb_tpu_torch (cluster/, distsql/
and executor/ included) and chip_smoke.py; the subprocess tests run TPC-H
Q1 through GpuClient(device="cpu"), and through the cluster path over
two regions, in a fresh interpreter (tests/conftest.py imports jax into
this one) and look at what got loaded.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
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
    for sub in ("cluster", "distsql", "executor"):
        assert any(os.path.join("tidb_tpu_torch", sub, "") in p
                   for p in files), sub
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
                         "combine_region_partials": 1}}, kernels.CALLS
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


def test_cluster_q1_runs_without_jax():
    _run_without_jax(_DRIVE_CLUSTER_Q1)
