"""The port's HBM ledger (ops.membudget) and external sort (ops.extsort,
K17 sort_perm), held against the JAX package and np.lexsort.

- K17's plain version (kernels.sort_perm_plain) against the reference's
  jitted kernels.sort_perm (JAX on the CPU) and np.lexsort, on seeded
  planes and the edge cases: -0.0 beside +0.0, NaN and +-inf, the int64
  extremes under ~ (DESC), int8 NULL planes, an all-tied primary key, n =
  0, 1, 4095, 4096 and 4097.
- tests/test_spill.py's TestExternalSort shapes through the port's
  sort_order (device="cpu": the plain version behind the kernel's
  wrapper): one pass within the headroom, partitioned passes over it,
  the kill switch and the device floor, the salted descent on a tied
  primary key, escalation on a DeviceOOM every third launch and on an
  out-of-memory in a pass's upload (answer unchanged, no host rung), and
  a DeviceError that is not a memory fault, which raises.
- TestAllocatorHook's three shapes through set_stats_provider, the
  budget spec, and "auto" reading the card where CUDA is present.
"""

import numpy as np
import pytest
import torch

from tidb_tpu.ops import kernels as rkernels

from tidb_tpu_torch import errors
from tidb_tpu_torch.ops import extsort, kernels, membudget

from torch_parity import port_ledger  # noqa: F401

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


@pytest.fixture(autouse=True)
def _ledger(port_ledger):  # noqa: F811
    yield


def _mk_sort_planes(n=20_000, seed=3, tied_primary=False):
    """test_spill.py's planes: [sec_vals, sec_nulls, pri_vals, pri_nulls]
    (least significant first)."""
    rng = np.random.default_rng(seed)
    pri = np.zeros(n, np.int64) if tied_primary \
        else rng.integers(-1 << 40, 1 << 40, n)
    sec = rng.integers(0, 1 << 20, n)
    pnull = (rng.random(n) < 0.03).astype(np.int8)
    snull = (rng.random(n) < 0.03).astype(np.int8)
    return [sec.astype(np.int64), snull, pri.astype(np.int64), pnull]


def _edge_planes(n: int, seed: int) -> list:
    """DESC int64 extremes (~), f64 signed zeros, NaN and infinities,
    int8 NULL planes, a narrow int32 key, and few distinct values so that
    ties are everywhere."""
    rng = np.random.default_rng(seed)
    ext = np.array([I64_MIN, I64_MAX, 0, -1, 1], np.int64)
    f = np.array([-0.0, 0.0, 1.5, np.nan, -np.inf, np.inf, -2.0, 5e-324],
                 np.float64)
    return [~rng.choice(ext, n), (rng.random(n) < 0.2).astype(np.int8),
            rng.choice(f, n), rng.integers(-2, 2, n).astype(np.int32),
            rng.choice(ext, n), np.ones(n, np.int8)]


def _plain(planes: list) -> np.ndarray:
    n = len(planes[0])
    return kernels.sort_perm(
        [torch.from_numpy(np.ascontiguousarray(p)) for p in planes], n).numpy()


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097])
def test_sort_perm_plain_edges_vs_jax(n):
    planes = _edge_planes(n, seed=n)
    want = np.lexsort(planes) if n else np.zeros(0, np.int64)
    got = _plain(planes)
    assert np.array_equal(got, want)
    if n in (1, 4096, 4097):
        # XLA on the CPU flushes subnormals to zero, which ties 5e-324 with
        # 0.0 in the reference's sort: hold it to the planes without one
        planes[2] = np.where(planes[2] == 5e-324, 3.0, planes[2])
        ref = rkernels.sort_perm(planes, n)
        assert np.array_equal(_plain(planes), np.asarray(ref, np.int64))
        assert np.array_equal(_plain(planes), np.lexsort(planes))
    assert sum(kernels.LAUNCHES.values()) == 0    # plain on the CPU


@pytest.mark.parametrize("tied", [False, True])
def test_sort_perm_plain_seeded_vs_jax(tied):
    planes = _mk_sort_planes(n=6_000, seed=9, tied_primary=tied)
    got = _plain(planes)
    assert np.array_equal(got, np.lexsort(planes))
    assert np.array_equal(got, np.asarray(rkernels.sort_perm(planes, 6_000),
                                          np.int64))


def test_signed_zero_and_nan_keep_input_order():
    v = np.array([0.0, -0.0, np.nan, 0.0, -np.nan, -0.0, np.inf], np.float64)
    got = _plain([v])
    assert got.tolist() == [0, 1, 3, 5, 6, 2, 4] == np.lexsort([v]).tolist()


class _Spy:
    """Counts the port's K17 calls and their sizes."""

    def __init__(self, mp, fail=None):
        self.sizes = []
        orig = kernels.sort_perm

        def spy(planes, n):
            self.sizes.append(n)
            if fail is not None:
                fail(len(self.sizes))
            return orig(planes, n)

        mp.setattr(kernels, "sort_perm", spy)


def _pieces_budget(est: int, pieces: int) -> int:
    """A budget whose pass target is est // pieces (nothing is pinned on
    the CPU, so the budget is the headroom)."""
    t = est // pieces
    assert sum(membudget.usage()) == 0 and t // 8 <= t
    return t


class TestExternalSort:
    def test_single_device_pass_parity(self, monkeypatch):
        planes = _mk_sort_planes(n=6_000)
        membudget.set_budget(1 << 22)
        spy = _Spy(monkeypatch)
        st: dict = {}
        order = extsort.sort_order(planes, 6_000, stats=st, device="cpu")
        assert spy.sizes == [6_000] and not st
        assert np.array_equal(order, np.lexsort(planes))

    def test_partitioned_parity_and_stats(self, monkeypatch):
        n = 20_000
        planes = _mk_sort_planes(n=n)
        membudget.set_budget(
            _pieces_budget(extsort.sort_bytes_estimate(planes, n), 2))
        spy = _Spy(monkeypatch)
        st: dict = {}
        order = extsort.sort_order(planes, n, stats=st, device="cpu")
        assert st["spilled"] and st["sort_passes"] >= 2
        assert st["sort_partitions"] >= 2
        assert st["sort_passes"] == len(spy.sizes)
        assert not st["sort_host_rung"] and st["sort_escalations"] == 0
        assert np.array_equal(order, np.lexsort(planes))

    def test_kill_switch_and_device_floor(self, monkeypatch):
        planes = _mk_sort_planes(n=20_000)
        spy = _Spy(monkeypatch)
        membudget.set_budget(0)
        assert np.array_equal(
            extsort.sort_order(planes, 20_000, device="cpu"),
            np.lexsort(planes))
        small = [p[:512] for p in planes]
        membudget.set_budget(1 << 22)
        assert np.array_equal(extsort.sort_order(small, 512, device="cpu"),
                              np.lexsort(small))
        assert spy.sizes == []
        # the kill switch and the floor take no device: the card is not
        # asked for
        membudget.set_budget(0)
        assert np.array_equal(extsort.sort_order(planes, 20_000),
                              np.lexsort(planes))

    def test_salted_split_on_tied_primary(self, monkeypatch):
        n = 20_000
        planes = _mk_sort_planes(n=n, seed=5, tied_primary=True)
        membudget.set_budget(
            _pieces_budget(extsort.sort_bytes_estimate(planes, n), 2))
        st: dict = {}
        order = extsort.sort_order(planes, n, stats=st, device="cpu")
        assert st["sort_salted"] > 0 and st["sort_passes"] >= 2
        assert np.array_equal(order, np.lexsort(planes))

    def test_every_key_tied(self):
        n = 9_000
        planes = [np.zeros(n, np.int64), np.ones(n, np.int8)]
        membudget.set_budget(
            _pieces_budget(extsort.sort_bytes_estimate(planes, n), 4))
        st: dict = {}
        order = extsort.sort_order(planes, n, stats=st, device="cpu")
        assert order.tolist() == list(range(n))
        assert st["sort_passes"] == 0 and st["sort_partitions"] == 1

    def test_oom_escalates_on_the_same_kernel(self, monkeypatch):
        """DeviceOOM on every third launch: the pass target halves, the
        finished partitions stand, the rest run again on K17; the answer
        is unchanged and no host rung is taken."""
        n = 20_000
        planes = _mk_sort_planes(n=n, seed=11)
        membudget.set_budget(
            _pieces_budget(extsort.sort_bytes_estimate(planes, n), 4))

        def every_third(k):
            if k % 3 == 0:
                raise errors.DeviceOOM("injected device OOM (sort pass)")

        spy = _Spy(monkeypatch, fail=every_third)
        st: dict = {}
        order = extsort.sort_order(planes, n, stats=st, device="cpu")
        assert np.array_equal(order, np.lexsort(planes))
        assert st["sort_escalations"] > 0 and not st["sort_host_rung"]
        assert len(spy.sizes) == st["sort_passes"] + st["sort_escalations"]

    def test_oom_past_the_escalations_raises(self, monkeypatch):
        n = 20_000
        planes = _mk_sort_planes(n=n, seed=11)
        membudget.set_budget(
            _pieces_budget(extsort.sort_bytes_estimate(planes, n), 2))

        def always(_k):
            raise errors.DeviceOOM("injected device OOM (sort pass)")

        spy = _Spy(monkeypatch, fail=always)
        with pytest.raises(errors.DeviceOOM):
            extsort.sort_order(planes, n, device="cpu")
        assert len(spy.sizes) == membudget.MAX_ESCALATIONS + 1

    def test_single_pass_oom_splits(self, monkeypatch):
        planes = _mk_sort_planes(n=12_000)
        membudget.set_budget(1 << 22)
        spy = _Spy(monkeypatch, fail=lambda k: (_ for _ in ()).throw(
            errors.DeviceOOM("injected")) if k == 1 else None)
        st: dict = {}
        order = extsort.sort_order(planes, 12_000, stats=st, device="cpu")
        assert np.array_equal(order, np.lexsort(planes))
        assert spy.sizes[0] == 12_000 and st["sort_escalations"] == 1
        assert st["sort_passes"] >= 2

    def test_upload_oom_escalates(self, monkeypatch):
        """The card running out of memory while a pass's planes are
        copied to it (outside K17's wrapper) escalates like a fault in the
        kernel: same answer, no host rung."""
        n = 20_000
        planes = _mk_sort_planes(n=n, seed=7)
        membudget.set_budget(
            _pieces_budget(extsort.sort_bytes_estimate(planes, n), 4))
        to = torch.Tensor.to
        uploads = []

        def upload(self, *a, **k):
            if a and isinstance(a[0], torch.device):
                uploads.append(a[0])
                if len(uploads) % 10 == 0:
                    raise torch.cuda.OutOfMemoryError("injected upload OOM")
            return to(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, "to", upload)
        spy = _Spy(monkeypatch)
        st: dict = {}
        order = extsort.sort_order(planes, n, stats=st, device="cpu")
        assert np.array_equal(order, np.lexsort(planes))
        assert st["sort_escalations"] > 0 and not st["sort_host_rung"]
        assert len(spy.sizes) == st["sort_passes"]

    def test_device_fault_raises(self, monkeypatch):
        """A fault that is not a memory fault is never answered by
        np.lexsort: it reaches the caller, one pass or many."""
        planes = _mk_sort_planes(n=20_000)

        def broken(_k):
            raise errors.DeviceError("device sort pass failed")

        _Spy(monkeypatch, fail=broken)
        for budget in (1 << 22, _pieces_budget(
                extsort.sort_bytes_estimate(planes, 20_000), 2)):
            membudget.set_budget(budget)
            with pytest.raises(errors.DeviceError, match="sort pass failed"):
                extsort.sort_order(planes, 20_000, device="cpu")
            assert membudget.usage() == (0, 0)


class TestAllocatorHook:
    def test_estimate_error_ratio_with_injected_stats(self):
        reads = iter([10_000, 18_000])
        membudget.set_stats_provider(lambda: {"bytes_in_use": next(reads)})
        membudget.set_budget(1 << 20)
        with membudget.reserve(16_000, "test"):
            pass
        assert abs(membudget.stats["estimate_error_ratio"] - 0.5) < 1e-9

    def test_shrinking_allocator_clamps_to_zero(self):
        reads = iter([40_000, 30_000])
        membudget.set_stats_provider(lambda: {"bytes_in_use": next(reads)})
        membudget.set_budget(1 << 20)
        with membudget.reserve(16_000, "test"):
            pass
        assert membudget.stats["estimate_error_ratio"] == 0.0

    def test_unmeasurable_rig_pays_nothing(self):
        membudget.set_stats_provider(lambda: None)
        membudget.set_budget(1 << 20)
        g0 = membudget.stats["estimate_error_ratio"]
        with membudget.reserve(16_000, "test"):
            pass
        assert membudget.stats["estimate_error_ratio"] == g0


def test_auto_budget_reads_the_card(monkeypatch):
    """Where CUDA is present "auto" reads the card's memory even before
    CUDA is initialised, so the default budget takes the device route."""
    total = 80 << 30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *_a: (total // 2, total))
    membudget.set_budget("auto")
    assert membudget.budget_bytes() == int(
        total * membudget.AUTO_BUDGET_FRACTION) > 0
    planes = _mk_sort_planes(n=6_000)
    spy = _Spy(monkeypatch)
    order = extsort.sort_order(planes, 6_000, device="cpu")
    assert np.array_equal(order, np.lexsort(planes))
    assert spy.sizes == [6_000]


def test_budget_spec_and_ledger():
    assert membudget.parse_hbm_budget_spec(" AUTO ") == "auto"
    assert membudget.parse_hbm_budget_spec("123") == 123
    for bad in ("-1", "lots"):
        with pytest.raises(ValueError):
            membudget.set_budget(bad)
    membudget.set_budget("auto")
    if not torch.cuda.is_available():
        assert membudget.budget_bytes() == 0     # no card: unlimited
    membudget.set_budget(1000)
    membudget.pin(300)
    assert membudget.headroom() == 700 and membudget.would_exceed_pin(701)
    over = membudget.stats["over_budget"]
    with membudget.reserve(800, "test"):
        assert membudget.usage() == (800, 300)
        assert membudget.headroom() == 0
    assert membudget.stats["over_budget"] == over + 1
    membudget.unpin(300)
    assert membudget.highwater()["total"] >= 1100
    membudget.reset_highwater()
    assert membudget.highwater() == {"total": 0}
