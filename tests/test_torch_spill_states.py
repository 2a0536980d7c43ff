"""The port's spilling group-by states (ops.extsort.region_states_spill and
the spill rung of copr.columnar_region.finish_states_batch), held against
the JAX package.

- tests/test_spill.py's TestSpillStates on the same numpy segments: the
  spilled states equal the reference's batched oracle
  (kernels.region_agg_states_batched) exactly, integer states and f64
  MIN / MAX alike, and the pass counts equal the reference's
  region_states_spill under the same budget and headroom (its budget
  functions pinned to the port's figures: the reference's ledger carries
  other tests' pins); a DeviceOOM every third pass (spy) escalates with
  checkpoints; one hot group takes the salted row split; a DeviceError
  that is not a memory fault raises; argument planes (which the
  reference lowers to its host evaluator first) spill on the card, row
  cut by row cut, with the row-space plane readbacks of float SUM beside
  them.
- TestSQLGroupBySpill's statement (and two with argument planes) recorded
  on the reference's cluster store over 2 regions (the reference's states
  floor 0, its mesh off, as tests/test_torch_cluster.py records) and
  replayed through the port's DistStore(device="cpu") under a budget that
  makes the states spill: the final rows equal the reference's, at budget
  0 too, and under a DeviceOOM mid pass.
"""

import itertools

import numpy as np
import pytest
import torch

from tidb_tpu import tablecodec as rtc
from tidb_tpu.cluster import store as ref_cluster_store
from tidb_tpu.copr import columnar_region as ref_columnar_region
from tidb_tpu.executor import fused_agg as ref_fused_agg
from tidb_tpu.ops import extsort as rext, kernels as rkernels
from tidb_tpu.ops import membudget as rmb, mesh as ref_mesh
from tidb_tpu.session import Session, new_store

from tidb_tpu_torch import carry, errors
from tidb_tpu_torch.copr.columnar_region import ArgPlaneSpec
from tidb_tpu_torch.ops import extsort, kernels

from test_torch_cluster import _cell, _final, _port_store
from torch_parity import port_identity, port_ledger, release  # noqa: F401


@pytest.fixture(autouse=True)
def _ledger(port_ledger):  # noqa: F811
    yield


def _mk_segs(nregions=2, n=9_000, G=3_000, seed=7):
    """tests/test_spill.py's _mk_segs: (reference segs, port segs)."""
    rng = np.random.default_rng(seed)
    ref, port = [], []
    for _ in range(nregions):
        gid = rng.integers(0, G, n).astype(np.int64)
        vals = rng.integers(-1000, 1000, n).astype(np.int64)
        ok = rng.random(n) > 0.05
        ok2 = rng.random(n) > 0.5
        ref.append((gid, [("sum", vals, ok), ("min", vals, ok),
                          ("max", vals, ok), ("sum", None, ok2)], G))
        tv = torch.from_numpy(vals)
        port.append((gid, [("sum", tv, ok), ("min", tv, ok),
                           ("max", tv, ok), ("sum", None, ok2)], G, n))
    return ref, port


def _equal(a, b) -> None:
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for sa, sb in zip(ra, rb):
            sa, sb = np.asarray(sa), np.asarray(sb)
            assert sa.dtype == sb.dtype
            assert np.array_equal(sa.view(np.int64) if sa.dtype == np.float64
                                  else sa,
                                  sb.view(np.int64) if sb.dtype == np.float64
                                  else sb)


def _budget(mp, est: int, pieces: int) -> int:
    """A budget whose pass target is est // pieces, on both packages."""
    b = est // pieces
    extsort.membudget.set_budget(b)
    mp.setattr(rmb, "budget_bytes", lambda: b)
    mp.setattr(rmb, "headroom", lambda: b)
    return b


class _Spy:
    """kernels.region_agg_states_batched counted, failing where
    `fail(call)` says (call counts from 1)."""

    def __init__(self, mp, fail=None):
        self.calls = 0
        inner = kernels.region_agg_states_batched

        def spy(*a, **kw):
            self.calls += 1
            if fail is not None:
                fail(self.calls)
            return inner(*a, **kw)

        mp.setattr(kernels, "region_agg_states_batched", spy)


def _oom_every(k):
    def fail(call):
        if call % k == 0:
            raise errors.DeviceOOM("injected device OOM (states pass)")
    return fail


def _oom_at(*calls):
    def fail(call):
        if call in calls:
            raise errors.DeviceOOM("injected device OOM (states pass)")
    return fail


class TestSpillStates:
    def test_parity_and_passes(self, monkeypatch):
        ref, port = _mk_segs()
        oracle = rkernels.region_agg_states_batched(ref)
        est = extsort.states_bytes_estimate(port)
        assert est == rext.states_bytes_estimate(ref)
        _budget(monkeypatch, est, 4)
        assert extsort.states_over_headroom(port)
        rst: dict = {}
        _equal(rext.region_states_spill(ref, rst), oracle)
        g0 = dict(extsort.spill_stats)
        spy = _Spy(monkeypatch)
        st: dict = {}
        _equal(extsort.region_states_spill(port, "cpu", st), oracle)
        assert st == rst
        assert st["states_passes"] >= 2 and spy.calls == st["states_passes"]
        assert extsort.spill_stats["groupbys"] == g0["groupbys"] + 1
        assert extsort.spill_stats["groupby_passes"] == \
            g0["groupby_passes"] + st["states_passes"]

    def test_oom_checkpointed_resume(self, monkeypatch):
        ref, port = _mk_segs(seed=13)
        oracle = rkernels.region_agg_states_batched(ref)
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 4)
        g0 = dict(extsort.spill_stats)
        spy = _Spy(monkeypatch, fail=_oom_every(3))
        st: dict = {}
        _equal(extsort.region_states_spill(port, "cpu", st), oracle)
        assert st["states_escalations"] >= 1
        assert extsort.spill_stats["checkpoint_hits"] > g0["checkpoint_hits"]
        assert spy.calls == st["states_passes"] + st["states_escalations"]

    def test_oom_past_the_bound_raises(self, monkeypatch):
        _ref, port = _mk_segs(n=3_000, G=1_000)
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 4)
        _Spy(monkeypatch, fail=_oom_every(1))
        with pytest.raises(errors.DeviceOOM):
            extsort.region_states_spill(port, "cpu")

    def test_device_error_raises_at_once(self, monkeypatch):
        _ref, port = _mk_segs(n=3_000, G=1_000)
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 4)

        def fault(_call):
            raise errors.DeviceError("injected launch failure")

        spy = _Spy(monkeypatch, fail=fault)
        with pytest.raises(errors.DeviceError, match="injected"):
            extsort.region_states_spill(port, "cpu")
        assert spy.calls == 1

    def test_salted_hot_group_split(self, monkeypatch):
        rng = np.random.default_rng(19)
        n = 9_000
        vals = rng.integers(-500, 500, n).astype(np.int64)
        ok = rng.random(n) > 0.1
        ref = [(np.zeros(n, np.int64), [("sum", vals, ok), ("max", vals, ok)],
                1)]
        port = [(np.zeros(n, np.int64),
                 [("sum", torch.from_numpy(vals), ok),
                  ("max", torch.from_numpy(vals), ok)], 1, n)]
        oracle = rkernels.region_agg_states_batched(ref)
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 2)
        rst: dict = {}
        _equal(rext.region_states_spill(ref, rst), oracle)
        st: dict = {}
        _equal(extsort.region_states_spill(port, "cpu", st), oracle)
        assert st == rst and st["states_salted"] == 1

    def test_f64_extrema_spill(self, monkeypatch):
        rng = np.random.default_rng(29)
        n, G = 6_000, 2_000
        gid = rng.integers(0, G, n).astype(np.int64)
        f = rng.integers(-400, 400, n) * 0.25 + 0.125
        ok = rng.random(n) > 0.1
        ref = [(gid, [("min", f, ok), ("max", f, ok), ("sum", None, ok)], G)]
        port = [(gid, [("min", torch.from_numpy(f), ok),
                       ("max", torch.from_numpy(f), ok),
                       ("sum", None, ok)], G, n)]
        oracle = rkernels.region_agg_states_batched(ref)
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 8)
        # groups no row contributes to included (NULL by their counts);
        # groups of only +-inf: test_f64_extrema_over_only_infinities
        assert (oracle[0][2] == 0).any()
        _equal(extsort.region_states_spill(port, "cpu"),
               port_identity(oracle))

    def test_f64_extrema_over_only_infinities(self, monkeypatch):
        """MIN over a group of only +inf values answers +inf and MAX over
        only -inf answers -inf, in one launch and spilled, as numpy and
        the JAX batched states do (at this shape its sorted route): the
        port's f64 extremum identity is +-inf, which no value beats. Up to
        the repair the port answered +-F64_MAX here (ROADMAP Queue 3)."""
        rng = np.random.default_rng(37)
        n, G = 1_200, 300
        gid = rng.integers(2, G, n).astype(np.int64)
        f = rng.integers(-50, 50, n) * 0.5
        gid[:6] = [0, 0, 0, 1, 1, 1]
        f[:6] = [np.inf] * 3 + [-np.inf] * 3
        ok = np.ones(n, bool)
        ref = [(gid, [("min", f, ok), ("max", f, ok)], G)]
        port = [(gid, [("min", torch.from_numpy(f), ok),
                       ("max", torch.from_numpy(f), ok)], G, n)]
        assert (f[gid == 0].min(), f[gid == 1].max()) == (np.inf, -np.inf)
        oracle = rkernels.region_agg_states_batched(ref)[0]
        assert (oracle[0][0], oracle[1][1]) == (np.inf, -np.inf)
        single = kernels.region_agg_states_batched(port, "cpu")[0]
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 4)
        st: dict = {}
        spilled = extsort.region_states_spill(port, "cpu", st)[0]
        assert st["states_passes"] >= 2
        for got in (single, spilled):
            assert (got[0][0], got[1][1]) == (np.inf, -np.inf)
            # every other group is right
            assert np.array_equal(got[0][2:], port_identity(oracle[0][2:]))
            assert np.array_equal(got[1][2:], port_identity(oracle[1][2:]))

    def test_argument_planes_spill_on_the_card(self, monkeypatch):
        """The reference refuses to spill argument planes as given
        (states_should_spill) and lowers them to its host evaluator; the
        port cuts them by row: equal to its own single launch, and to the
        reference's batched states over the same planes as numpy."""
        rng = np.random.default_rng(31)
        ref, port = [], []
        for r in range(2):
            n, G = 5_000 + 17 * r, 1_500
            gid = rng.integers(0, G, n).astype(np.int64)
            av = rng.integers(-900, 900, n).astype(np.int64)
            aok = rng.random(n) > 0.2
            fv = rng.integers(-50, 50, n) * 0.5
            fok = rng.random(n) > 0.3
            mask = rng.random(n) > 0.05
            arg = ArgPlaneSpec(None, torch.from_numpy(av),
                               torch.from_numpy(aok))
            farg = ArgPlaneSpec(None, torch.from_numpy(fv),
                                torch.from_numpy(fok))
            port.append((gid, [("cnt", arg, mask), ("sum", arg, mask),
                               ("max", arg, mask), ("plane", farg, mask),
                               ("pvalid", farg, mask)], G, n))
            ref.append((gid, [("sum", None, mask & aok),
                              ("sum", av, mask & aok),
                              ("max", av, mask & aok)], G))
        single = kernels.region_agg_states_batched(port, "cpu")
        oracle = rkernels.region_agg_states_batched(ref)
        _budget(monkeypatch, extsort.states_bytes_estimate(port), 4)
        assert extsort.states_over_headroom(port)
        assert not rext.states_should_spill([s[:3] for s in port])
        st: dict = {}
        got = extsort.region_states_spill(port, "cpu", st)
        assert st["states_passes"] >= 2
        _equal(got, single)
        _equal([g[:3] for g in got], port_identity(oracle))


# ---------------------------------------------------------------------------
# SQL level: the group-by of test_spill.py over the reference's cluster
# store, replayed through the port's
# ---------------------------------------------------------------------------

GBY_Q = "select g, sum(v), count(*) from t group by g order by g"
ARG_QS = ["select g, sum(v + g), max(v - g), count(*) from t group by g",
          "select g, sum(v * 0.5e0), min(v * 3), count(v) from t "
          "group by g"]
_store_seq = itertools.count(1)


@pytest.fixture(scope="module")
def recorded():
    """{statement: (reference DistCoprClient, kv.Request, final rows)} of
    test_spill.py's _gby_store statement and the argument-plane ones."""
    seen = []
    send = ref_cluster_store.DistCoprClient.send
    final = ref_fused_agg.try_fused_final

    def rec_send(client, req):
        seen.append(("send", client, req))
        return send(client, req)

    def rec_final(agg):
        out = final(agg)
        seen.append(("final", out))
        return out

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_columnar_region, "STATES_DEVICE_FLOOR", 0)
        mp.setattr(ref_mesh, "_enabled", False)
        mp.setattr(ref_cluster_store.DistCoprClient, "send", rec_send)
        mp.setattr(ref_fused_agg, "try_fused_final", rec_final)
        store = new_store(f"cluster://3/torchspill{next(_store_seq)}")
        s = Session(store)
        s.execute("create database sg")
        s.execute("use sg")
        s.execute("create table t (id bigint primary key, g bigint, "
                  "v bigint)")
        n = 6_000
        for start in range(1, n + 1, 2000):
            s.execute("insert into t values " + ", ".join(
                f"({i}, {(i * 7919) % 3000}, {(i * 31) % 1009})"
                for i in range(start, start + 2000)))
        tid = s.info_schema().table_by_name("sg", "t").info.id
        store.cluster.split_keys([rtc.encode_row_key(tid, n // 2 + 1)])
        for sql in [GBY_Q] + ARG_QS:
            del seen[:]
            s.execute(sql)
            sends = [e for e in seen if e[0] == "send"]
            finals = [e for e in seen if e[0] == "final"]
            assert len(sends) == 1 and len(finals) == 1, sql
            assert finals[0][1] is not None, sql
            out[sql] = (sends[0][1], sends[0][2], finals[0][1])
    yield out
    release(out)


def _replay(rec, sql, budget: int) -> list:
    ref_client, ref_req, _want = rec[sql]
    store = _port_store(ref_client, ref_req.data.start_ts)
    extsort.membudget.set_budget(budget)
    got = _final(store, carry.kv_request_from(ref_req))
    return [[_cell(d) for d in row] for row in got]


def _want(rec, sql) -> list:
    return [[_cell(d) for d in row] for row in rec[sql][2]]


@pytest.mark.parametrize("sql", [GBY_Q] + ARG_QS)
def test_groupby_spill_parity_vs_kill_switch(recorded, sql, monkeypatch):
    want = _want(recorded, sql)
    g0 = dict(extsort.spill_stats)
    assert _replay(recorded, sql, 0) == want
    assert extsort.spill_stats["groupbys"] == g0["groupbys"]
    spy = _Spy(monkeypatch)
    assert _replay(recorded, sql, 120_000) == want
    assert extsort.spill_stats["groupbys"] == g0["groupbys"] + 1
    passes = extsort.spill_stats["groupby_passes"] - g0["groupby_passes"]
    assert passes >= 2 and spy.calls == passes


def test_groupby_oom_mid_pass_checkpointed(recorded, monkeypatch):
    want = _want(recorded, GBY_Q)
    g0 = dict(extsort.spill_stats)
    _Spy(monkeypatch, fail=_oom_at(2, 5))
    assert _replay(recorded, GBY_Q, 120_000) == want
    assert extsort.spill_stats["escalations"] > g0["escalations"]
    assert extsort.spill_stats["checkpoint_hits"] > g0["checkpoint_hits"]
