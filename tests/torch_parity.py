"""Shared pieces of the tests that hold tidb_tpu_torch against tidb_tpu.

The reference side runs JAX on the CPU (tests/conftest.py); the port runs
its kernels' plain PyTorch versions (device="cpu"). Data crosses between
them as numpy arrays or raw KV bytes, requests through tidb_tpu_torch.carry.
"""

from __future__ import annotations

import gc
import math
import sys
from decimal import Decimal

import numpy as np
import pytest
import torch  # noqa: F401  (loaded here, before the freeze below)

from tidb_tpu import tablecodec as rtc
from tidb_tpu.copr.proto import iter_response_rows as ref_iter_rows
from tidb_tpu.copr.region_handler import handle_request
from tidb_tpu.ops import TpuClient
from tidb_tpu.session import Session, new_store

from tidb_tpu_torch import carry
from tidb_tpu_torch.copr.proto import iter_response_rows as port_iter_rows
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient

# f64 sums may differ in summation order; the reference's own parity test
# rounds to 9 places (tests/test_tpu_copr.py:114)
F64_RTOL = 1e-12

F64_MAX = float(np.finfo(np.float64).max)

# Importing torch adds well over a hundred thousand long-lived objects to
# every test worker (each worker collects every test file), which makes
# each later full garbage collection several times slower. Tests of the
# reference that time a gather window (the 30 ms micro-batch window of
# tests/test_device_dict.py) then miss it when a collection lands inside.
# Collect what is garbage now, then move every surviving object out of the
# collector's scans. The port's tests
# use planes of a few thousand rows, so torch runs them on one thread
# rather than start a pool of one thread per core in every worker.
gc.collect()
gc.freeze()
torch.set_num_threads(1)


class _Replay:
    def __init__(self, parts):
        self._parts = list(parts)

    def next(self):
        return self._parts.pop(0) if self._parts else None

    def close(self):
        self._parts = []


class RecordingClient(TpuClient):
    """TpuClient that keeps every kv.Request it answers, with the partial
    responses it answered them with."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.requests = []
        self.responses = []

    def send(self, req):
        resp = super().send(req)
        parts = []
        while True:
            part = resp.next()
            if part is None:
                break
            parts.append(part)
        self.requests.append(req)
        self.responses.append(parts)
        return _Replay(parts)


def norm_datum(kind: int, val):
    """(kind, comparable value) of a datum of either package."""
    if hasattr(val, "to_packed_int"):
        return kind, ("time", val.to_packed_int())
    if hasattr(val, "nanos"):
        return kind, ("duration", val.nanos)
    if isinstance(val, Decimal):
        return kind, ("dec", val)
    return kind, val


def rows(resp, iter_rows) -> list:
    return [(h, [norm_datum(int(d.kind), d.val) for d in ds])
            for h, ds in iter_rows(resp)]


def ref_rows(resp) -> list:
    return rows(resp, ref_iter_rows)


def port_rows(resp) -> list:
    return rows(resp, port_iter_rows)


def assert_rows_equal(got: list, want: list, what: str = "") -> None:
    assert len(got) == len(want), (what, got, want)
    for (hg, rg), (hw, rw) in zip(got, want):
        assert hg == hw, (what, hg, hw)
        assert len(rg) == len(rw), (what, rg, rw)
        for (kg, vg), (kw, vw) in zip(rg, rw):
            assert kg == kw, (what, rg, rw)
            if isinstance(vg, float):
                assert math.isclose(vg, vw, rel_tol=F64_RTOL, abs_tol=0.0), \
                    (what, vg, vw)
            else:
                assert vg == vw, (what, rg, rw)


def by_group_key(rs: list) -> list:
    """Aggregate partial rows in group-key order (engines emit groups in
    different orders)."""
    return sorted(rs, key=lambda r: repr(r[1][0]))


def port_identity(x):
    """Reference states with the JAX package's f64 extremum identity
    written as the port's: where no row contributed to an f64 MIN / MAX
    state, the reference's one-hot, sorted and mesh routes leave
    +-F64_MAX and the port +-inf, which no value beats (ROADMAP Queue 3,
    reference fault 6). Float arrays map +-F64_MAX to +-inf, lists and
    tuples map element by element, anything else stays. The tests' data
    holds no +-F64_MAX value, so only identities move."""
    if isinstance(x, (list, tuple)):
        return type(x)(port_identity(v) for v in x)
    a = np.asarray(x)
    if a.dtype != np.float64:
        return x
    return np.where(a == F64_MAX, np.inf, np.where(a == -F64_MAX, -np.inf,
                                                     a))


def table_pairs(store, start_ts: int, table_id: int) -> list:
    snap = store.get_snapshot(start_ts)
    return list(snap.iterate(rtc.table_prefix(table_id),
                             rtc.table_prefix(table_id + 1)))


def port_answer(store, req) -> list:
    """The port's answer (plain versions) to a reference kv.Request over
    the reference store's rows of that table."""
    sel = req.data
    pairs = table_pairs(store, sel.start_ts, sel.table_info.table_id)
    client = GpuClient(MemStore.from_pairs(pairs), device="cpu")
    resp = client.send(carry.kv_request_from(req)).next()
    return port_rows(resp), client


def release(recorded: dict) -> None:
    """Drop a module's recorded stores and collect them now: the
    reference's device planes unpin their memory-budget charge when
    collected, and a collection landing inside a later test file would
    move the budget that file measured (tests/test_spill.py sizes its
    passes from the charge it finds)."""
    recorded.clear()
    gc.collect()


def session(url: str):
    """(store, Session, RecordingClient): a JAX store whose client records
    what it answers (dispatch floor 0, tidb_tpu_columnar_scan = 0)."""
    store = new_store(url)
    s = Session(store)
    s.execute("set global tidb_tpu_columnar_scan = 0")
    rec = RecordingClient(store, dispatch_floor_rows=0)
    store.set_client(rec)
    return store, s, rec


def run_recorded(session_, rec, sql) -> list:
    """[(kv.Request, TpuClient's partial responses)] of one statement."""
    rec.requests.clear()
    rec.responses.clear()
    session_.execute(sql)
    assert rec.requests, sql
    return list(zip(rec.requests, rec.responses))


def shrink_ranked(mp, radix_max: int, rank_caps: tuple) -> None:
    """The radix ceiling and the rank ladder, shrunk on both packages (mp:
    a pytest MonkeyPatch)."""
    from tidb_tpu.ops import client as rclient, kernels as rkernels
    from tidb_tpu_torch.ops import kernels as pkernels
    mp.setattr(rkernels, "RADIX_MAX_SEGMENTS", radix_max)
    mp.setattr(pkernels, "RADIX_MAX_SEGMENTS", radix_max)
    mp.setattr(rclient.TpuClient, "_RANK_CAPS", rank_caps)
    mp.setattr(GpuClient, "_RANK_CAPS", rank_caps)


def answers(store, req, parts) -> tuple:
    """(port, TpuClient, CPU engine) decoded partial rows of one recorded
    request, and the port's client; aggregate rows in group-key order."""
    sel = req.data
    got, client = port_answer(store, req)
    tpu = [r for part in parts for r in ref_rows(part)]
    snap = store.get_snapshot(sel.start_ts)
    cpu = ref_rows(handle_request(snap, sel, req.key_ranges))
    if sel.aggregates or sel.group_by:
        got, tpu, cpu = (by_group_key(x) for x in (got, tpu, cpu))
    return got, tpu, cpu, client


def check_statement(store, reqs, what: str) -> list:
    """Each recorded request of a statement through the port (plain
    versions): its partial rows must equal TpuClient's and the CPU
    engine's. Returns the port's clients."""
    clients = []
    for req, parts in reqs:
        sel = req.data
        got, tpu, cpu, client = answers(store, req, parts)
        clients.append(client)
        assert client.stats["gpu_requests"] == 1
        assert sum(client.stats["launches"].values()) == 0  # plain on CPU
        assert_rows_equal(got, tpu, f"{what} vs TpuClient")
        if not cpu and not sel.group_by:
            # over a range holding no row the CPU engine sends no partial
            # row where the device engines send the empty one (counts 0,
            # the rest NULL); the SQL final aggregation reads both alike
            (_h, row), = got
            assert all(v is None or v == 0 for _k, v in row[1:]), row
            continue
        assert_rows_equal(got, cpu, f"{what} vs CPU engine")
    return clients


@pytest.fixture
def port_ledger():
    """The port's HBM ledger is process state: a test that sets a budget
    or leaks a reservation would change the route of every later test in
    its worker. Budget back to the kill switch after each test, and the
    test fails where a reservation or a pin outlived it. Test files take
    it as an autouse fixture (see tests/test_torch_extsort.py)."""
    from tidb_tpu_torch.ops import membudget
    yield membudget
    membudget.set_budget(0)
    membudget.set_stats_provider(None)
    assert membudget.usage() == (0, 0), membudget.usage()
