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

import torch  # noqa: F401  (loaded here, before the freeze below)

from tidb_tpu import tablecodec as rtc
from tidb_tpu.copr.proto import iter_response_rows as ref_iter_rows
from tidb_tpu.ops import TpuClient

from tidb_tpu_torch import carry
from tidb_tpu_torch.copr.proto import iter_response_rows as port_iter_rows
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops.client import GpuClient

# f64 sums may differ in summation order; the reference's own parity test
# rounds to 9 places (tests/test_tpu_copr.py:114)
F64_RTOL = 1e-12

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
