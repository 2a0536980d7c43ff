"""Window functions in the port (executor.window.WindowExec over K17 and
K18), held against the JAX package.

- K18's plain version (kernels.window_scan_plain) against the reference's
  jitted kernels.window_scan (JAX on the CPU) on seeded partitions, peers
  and specs: every ranking and reduction, int64 wrap in SUM, empty
  frames.
- WindowExec on the rows of tests/test_spill.py's `w` table (4,500 rows,
  above the device floor) for each of its WIN_QS: the reference runs the
  SQL through its own session (at budget 0, the host rung its own suite
  certifies equal to its device rung) and its WindowExec's input rows and
  calls are carried over (carry.RowsExec, carry.window_desc_from). The
  port's rows must equal the reference's at a set budget (K17 and K18,
  plain versions, one pass) and with the scan split into passes over
  whole partitions (TestWindowFunctions' 70 KB headroom), and at budget 0.
- A K18 fault raises (the reference lands on its host rung), and so
  does an out-of-memory in a pass's copies, as DeviceOOM; the default
  "auto" budget takes K18's route wherever CUDA is present; a float SUM
  raises Unsupported (the reference's row protocol).
"""

import numpy as np
import pytest
import torch

from tidb_tpu.executor import window as rwin
from tidb_tpu.ops import kernels as rkernels, membudget as rmembudget
from tidb_tpu.session import new_store
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry, errors, plan
from tidb_tpu_torch.executor.window import WindowExec
from tidb_tpu_torch.ops import extsort, kernels, membudget
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.types.datum import Datum

from tests.testkit import TestKit
from torch_parity import norm_datum, port_ledger, release  # noqa: F401

# tests/test_spill.py WIN_QS
WIN_QS = [
    "select id, row_number() over (partition by g order by o, id) from w",
    "select id, rank() over (partition by g order by o) from w",
    "select id, dense_rank() over (partition by g order by o) from w",
    "select id, sum(v) over (partition by g order by o, id) from w",
    "select id, count(v) over (partition by g order by o) from w",
    "select id, min(v) over (partition by g order by o) from w",
    "select id, max(v) over (partition by g order by o) from w",
    "select id, sum(v) over () from w",
    "select id, count(*) over (partition by g) from w",
]
N_W = 4_500        # test_spill.py _win_store: above SORT_DEVICE_FLOOR

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


@pytest.fixture(autouse=True)
def _ledger(port_ledger):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def recorded():
    """{sql: (window calls, input rows, output rows)} of the reference's
    WindowExec for each of WIN_QS over test_spill.py's `w` table."""
    tk = TestKit(store=new_store("memory://torch_window_w"))
    tk.exec("create database sw")
    tk.exec("use sw")
    tk.exec("create table w (id bigint primary key, g bigint, o bigint, "
            "v bigint)")
    tbl = tk.session.info_schema().table_by_name("sw", "w")
    txn = tk.store.begin()
    tbl.add_records(txn, [[RDatum.i64(i), RDatum.i64(i % 37),
                           RDatum.i64((i * 7) % 13),
                           RDatum.null() if i % 11 == 0
                           else RDatum.i64((i * 13) % 97)]
                          for i in range(1, N_W + 1)],
                    skip_unique_check=True)
    txn.commit()
    out = {}
    seen = []
    o_mat = rwin.WindowExec._materialize

    def mat(ex):
        o_mat(ex)
        seen.append(ex)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rwin.WindowExec, "_materialize", mat)
        rmembudget.set_budget(0)
        try:
            for sql in WIN_QS:
                rows = tk.query(sql).rows
                ex = seen[-1]
                k = len(ex.window_funcs)
                out[sql] = (ex.window_funcs, [r[:len(r) - k] for r in ex._out],
                            ex._out, rows)
        finally:
            rmembudget.set_budget(rmembudget.DEFAULT_BUDGET_SPEC)
    yield out
    release(out)


def _norm(rows) -> list:
    return [[norm_datum(int(d.kind), d.val) for d in row] for row in rows]


def _port_window(ref) -> WindowExec:
    funcs, inputs, _out, _rows = ref
    child = carry.RowsExec(carry.rows_from(inputs), len(inputs[0]))
    return WindowExec(child, [carry.window_desc_from(d) for d in funcs],
                      device="cpu")


def _base() -> int:
    return sum(membudget.usage())


@pytest.mark.parametrize("sql", WIN_QS)
def test_window_rows_one_pass(recorded, sql):
    ref = recorded[sql]
    assert len(ref[1]) == N_W
    membudget.set_budget(_base() + (1 << 22))
    ex = _port_window(ref)
    got = ex.drain()
    assert _norm(got) == _norm(ref[2]), sql
    assert ex.stats == {"windows": 1, "window_passes": 1, "host_scans": 0}


@pytest.mark.parametrize("sql", WIN_QS[:4])
def test_window_rows_in_passes(recorded, sql):
    """A 70 KB headroom: the K18 scan splits at whole partitions (and the
    key sort partitions too); rows unchanged."""
    ref = recorded[sql]
    membudget.set_budget(_base() + 70_000)
    ex = _port_window(ref)
    got = ex.drain()
    assert _norm(got) == _norm(ref[2]), sql
    assert ex.stats["window_passes"] >= 2, ex.stats


@pytest.mark.parametrize("sql", [WIN_QS[0], WIN_QS[7]])
def test_window_rows_kill_switch(recorded, sql):
    ref = recorded[sql]
    membudget.set_budget(0)
    ex = _port_window(ref)
    assert _norm(ex.drain()) == _norm(ref[2]), sql
    assert ex.stats == {"windows": 0, "window_passes": 0, "host_scans": 1}


def test_scan_fault_raises(recorded, monkeypatch):
    """The reference answers a window_scan fault from its host rung; the
    port raises it."""
    ref = recorded[WIN_QS[1]]
    membudget.set_budget(_base() + (1 << 22))

    def broken(*_a, **_k):
        raise errors.DeviceError("injected window-scan kernel failure")

    monkeypatch.setattr(kernels, "window_scan", broken)
    with pytest.raises(errors.DeviceError, match="injected"):
        _port_window(ref).drain()
    assert membudget.usage() == (0, 0)


def test_auto_budget_takes_the_device_route(recorded, monkeypatch):
    """Where CUDA is present the default "auto" budget reads the card
    before CUDA is initialised: K18's route, not the host's."""
    total = 80 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *_a: (total // 2, total))
    membudget.set_budget("auto")
    ref = recorded[WIN_QS[3]]
    ex = _port_window(ref)
    assert _norm(ex.drain()) == _norm(ref[2])
    assert ex.stats == {"windows": 1, "window_passes": 1, "host_scans": 0}


def test_window_pass_oom_raises_device_oom(recorded, monkeypatch):
    """The card running out of memory in a window pass's copies raises
    DeviceOOM, a DeviceError; the scan does not answer it."""
    ref = recorded[WIN_QS[1]]
    membudget.set_budget(_base() + (1 << 22))
    sort_order = extsort.sort_order
    armed = []

    def sorted_then_arm(*a, **k):
        out = sort_order(*a, **k)
        armed.append(True)
        return out

    to = torch.Tensor.to

    def upload(self, *a, **k):
        if armed and a and isinstance(a[0], torch.device):
            raise torch.cuda.OutOfMemoryError("injected upload OOM")
        return to(self, *a, **k)

    monkeypatch.setattr(extsort, "sort_order", sorted_then_arm)
    monkeypatch.setattr(torch.Tensor, "to", upload)
    with pytest.raises(errors.DeviceOOM, match="window pass"):
        _port_window(ref).drain()
    assert armed and membudget.usage() == (0, 0)


def test_float_sum_raises():
    rows = [[Datum.i64(i), Datum.i64(i % 3), Datum.f64(i / 4)]
            for i in range(5000)]
    desc = plan.WindowFuncDesc("sum", [plan.Column(2)], [plan.Column(1)], [])
    ex = WindowExec(carry.RowsExec(rows, 3), [desc], device="cpu")
    with pytest.raises(Unsupported, match="float or decimal"):
        ex.drain()


# ---------------------------------------------------------------------------
# K18's plain version against the reference's jitted window_scan
# ---------------------------------------------------------------------------

def _window_inputs(n: int, nparts: int, seed: int):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, nparts, n)).astype(np.int64)
    chg = np.zeros(n, bool)
    chg[1:] = (seg[1:] != seg[:-1]) | (rng.random(n - 1) < 0.3)
    peer = np.cumsum(chg).astype(np.int64)
    vals = rng.choice(np.array([I64_MAX, I64_MIN, 5, -7, 1 << 62], np.int64),
                      n)
    ok = rng.random(n) < 0.6
    ok[: n // 7] = False             # a run of empty frames
    specs = [("row_number", None, None), ("rank", None, None),
             ("dense_rank", None, None), ("sum", vals, ok),
             ("count", None, ok), ("min", vals, ok), ("max", vals, ok)]
    return seg, peer, specs


@pytest.mark.parametrize("n,nparts", [(1, 1), (300, 7), (5000, 40),
                                      (5000, 1)])
def test_window_scan_plain_vs_jax(n, nparts):
    seg, peer, specs = _window_inputs(n, nparts, seed=n + nparts)
    want = rkernels.window_scan(seg, peer, specs, n)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = kernels.window_scan(t(seg), t(peer),
                              [(op, t(v), t(c)) for op, v, c in specs], n)
    for (op, _v, _c), g, w in zip(specs, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w, np.int64)), op
    # SUM is the frame's exact sum modulo 2^64, and it wrapped
    _op, vals, ok = specs[3]
    cs = np.concatenate([[0], np.cumsum(np.where(ok, vals, 0).astype(object))])
    s = np.searchsorted(seg, seg)
    e = np.searchsorted(peer, peer, side="right") - 1
    exact = cs[e + 1] - cs[s]
    wrapped = [(int(x) + (1 << 63)) % (1 << 64) - (1 << 63) for x in exact]
    assert got[3].tolist() == wrapped
    assert n == 1 or any(int(x) != w for x, w in zip(exact, wrapped))
    # an empty frame: COUNT 0, MIN / MAX their sentinels (NULL upstream)
    assert n == 1 or got[4][0] == 0 and got[5][0] == I64_MAX \
        and got[6][0] == I64_MIN
    assert sum(kernels.LAUNCHES.values()) == 0    # plain on the CPU
