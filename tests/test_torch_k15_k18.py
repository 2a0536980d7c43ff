"""K15 (`slot_agg`) and K18 (`window_scan`) after their redesign for
Hopper (slice 17), on the CPU.

- What each launch is handed, over recording stand-ins for the CUDA
  libraries: K15's one launch gets K14's split program (slot_split's
  instructions, n_inv, the split WHERE register, the registers written),
  the group plan of `kernels.slot_agg_plan` and the stream's scratch, and
  the call makes no tensor but its output; the tier reads K15's [k, R, 2]
  back once, through `kernels.to_host`; K18 is one host call carrying
  every spec, which makes one launch or, with a frame figure, two.
- The constants and C signatures the wrappers mirror, against the sources.
- The plain versions against the JAX package: K18's (`window_scan_plain`)
  against the reference's jitted window_scan at K18's tile edges; K15's
  states (`slot_agg_states` on CPU tensors) against the reference's agg
  wrapper at 1 and 32 slots.

Tolerance: exact (integers; f64 extrema with the reference's identity
mapped to the port's).
"""

from __future__ import annotations

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import kernels as rkernels
from tidb_tpu.ops import sched as rsched

from tidb_tpu_torch import carry, tpch
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops import _ext, exprc
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops import sched as psched
from tidb_tpu_torch.ops.client import GpuClient

from test_torch_sched_kernels import (AGG_SETS, WHERES, _agg_sel, _batch,
                                      _cases, _jax_planes, _port_planes,
                                      _port_slots, _ref_slots)
from torch_parity import port_identity

CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
CPU = torch.device("cpu")
I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
T = pk.K18_TILE


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src: str, name: str) -> str:
    return re.search(r"#define %s (.+?)(?:\s*//.*)?$" % name, src,
                     re.M).group(1).strip()


def _read(p: int, count: int, dtype) -> np.ndarray:
    size = count * np.dtype(dtype).itemsize
    return np.frombuffer(ctypes.string_at(p, size), dtype).copy()


# ---------------------------------------------------------------------------
# recording stand-ins for the two libraries
# ---------------------------------------------------------------------------

class _Libs:
    def __init__(self):
        self.k15, self.k18 = [], []

    def slot_agg_launch(self, n, k, P, planes, n_planes, ins, n_instr,
                        n_inv, where, n_regs, pools, lut, lut_len, live,
                        n_red, desc, groups, per_group, row_blocks,
                        tiles_per_block, scratch, out, stream):
        self.k15.append(dict(
            n=n, k=k, ins=_read(ins, 6 * n_instr, np.int64).reshape(-1, 6),
            n_inv=n_inv, where=where, n_regs=n_regs,
            desc=_read(desc, 5 * n_red, np.int64).reshape(n_red, 5),
            plan=(groups, per_group, row_blocks, tiles_per_block),
            scratch=scratch, out=out))
        return 0

    def window_scan_state_bytes(self, n, n_red):
        return 64 + 8 * n_red

    def window_scan_aux_bytes(self, n, n_red):
        return 32

    def window_scan_launch(self, n, seg, peer, n_red, reds, n_fig, figs,
                           scratch, aux, epoch, launches, stream):
        f = _read(figs, 3 * n_fig, np.int64).reshape(n_fig, 3)
        r = _read(reds, 3 * n_red, np.int64).reshape(n_red, 3)
        launches._obj.value = 1 + int((f[:, 0] == pk.W_FRAME).any())
        self.k18.append(dict(n=n, seg=seg, peer=peer, reds=r, figs=f,
                             scratch=scratch, epoch=epoch))
        return 0


@pytest.fixture
def libs(monkeypatch):
    rec = _Libs()
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    monkeypatch.setattr(pk, "_SCRATCH", {})
    monkeypatch.setattr(pk, "_K18_EPOCH", {})
    return rec


def _k15_inputs(k: int, seed: int = 26):
    pb = carry.batch_from(_batch(seed))
    fin, pools = _port_slots(pb, [WHERES["a < x"](x) for x in range(k)])
    planes, plist, plive = _port_planes(pb, fin)
    reds = [pk.Red(pk.R_COUNT, const_bits=1),
            pk.Red(pk.R_SUM_I, *planes[3]), pk.Red(pk.R_MAX_F, *planes[2])]
    return pb, fin, pools, plist, plive, reds


def test_k15_one_launch_of_the_split_program_and_plan(libs, monkeypatch):
    pb, fin, pools, plist, plive, reds = _k15_inputs(5)
    made = []
    empty = torch.empty

    def counting_empty(*a, **kw):
        made.append(a)
        return empty(*a, **kw)

    monkeypatch.setattr(torch, "empty", counting_empty)
    out = pk.slot_agg_states(fin, pools, plist, plive, reds)
    pk.slot_agg_states(fin, pools, plist, plive, reds)
    first, second = libs.k15
    ins, n_inv, where = exprc.slot_split(fin)
    assert first["ins"].tolist() == [list(x) for x in ins]
    assert (first["n_inv"], first["where"]) == (n_inv, where)
    assert n_inv > 0                      # the loads run once a row
    assert first["n_regs"] == 1 + max(x[1] for x in ins)
    assert first["desc"].tolist() == pk._red_rows(reds, pb.capacity, CPU)
    n = pb.capacity
    assert first["plan"] == pk.slot_agg_plan(n, 5, 3)
    # one launch a call; the partials live in the stream's scratch, the
    # same buffer both calls, and the call makes only its output
    assert pk.LAUNCHES["slot_agg"] == 2
    assert first["scratch"] == second["scratch"] \
        == pk._SCRATCH[("slot_agg", None, 0)].data_ptr()
    assert pk._SCRATCH[("slot_agg", None, 0)].numel() >= \
        pk.slot_agg_scratch_bytes(5, 3, first["plan"])
    assert made == [((5, 3, 2),), ((5, 3, 2),)]
    assert first["out"] == out.data_ptr() and out.shape == (5, 3, 2)
    # a reduction equal to an earlier one is marked as its twin: it folds
    # nothing and copies that one's result
    pk.slot_agg_states(fin, pools, plist, plive,
                       reds + [pk.Red(pk.R_COUNT, const_bits=1), reds[1]])
    twins = libs.k15[-1]["desc"]
    assert twins[:3].tolist() == first["desc"].tolist()
    assert twins[3].tolist() == [pk.R_COUNT, 1 | pk.K15_SAME, 0, 0, 0]
    assert twins[4][1] & pk.K15_SAME and twins[4][2] == 1


@pytest.mark.parametrize("n,k,R,plan", [
    (16384, 32, 4, (16, 2, 64, 1)),          # the tier's shape
    (1 << 23, 32, 4, (1, 32, 1561, 21)),     # the stress shape
    (64, 1, 1, (1, 1, 1, 1)),
    (1 << 20, 32, 9, (1, 32, 1366, 3)),
    (4096, 2048, 9, (98, 21, 16, 1)),        # K15_MAX_PAIRS narrows a group
])
def test_k15_plan_covers_every_slot_and_row(n, k, R, plan):
    got = pk.slot_agg_plan(n, k, R)
    assert got == plan
    groups, per, rows, tpb = got
    assert groups * per >= k > (groups - 1) * per
    assert per * R <= pk.K15_MAX_PAIRS
    tiles = -(-n // (pk.K15_THREADS * pk.K15_ROWS))
    assert rows * tpb >= tiles > (rows - 1) * tpb
    assert rows <= pk.K15_MAX_ROW_BLOCKS


def test_tier_reads_k15_back_once_into_page_locked_memory(monkeypatch):
    data, words = tpch.supplier(500, 9)
    store = MemStore.from_pairs(tpch.supplier_pairs(data, words))
    client = GpuClient(store, "cpu")
    reqs = [tpch.g_statement("g_agg", x) for x in (3, 7, 11, 20)]
    mb = psched.MicroBatcher()
    entries = [mb._prepare(client, r, r.data) for r in reqs]
    assert all(e is not None and e.aggs is not None for e in entries)
    back = []
    to_host = pk.to_host

    def recording(t):
        back.append(tuple(t.shape))
        return to_host(t)

    def two_halves(*a, **kw):
        raise AssertionError("the tier read K15's halves apart")

    monkeypatch.setattr(pk, "to_host", recording)
    monkeypatch.setattr(pk, "slot_agg", two_halves)
    mb._dispatch_chunk(client, entries)
    R = 1 + len(entries[0].aggs)
    assert back == [(4, R, 2)]
    # the same answers as each statement alone on the solo route (every
    # slot keeps rows: the tier sends no row for an empty slot)
    solo = GpuClient(store, "cpu")
    for r, e in zip(reqs, entries):
        got = e.result.chunks
        assert got and got == solo.send(r).next().chunks


# ---------------------------------------------------------------------------
# K18's one call
# ---------------------------------------------------------------------------

def _specs(n: int, seed: int, t=torch.from_numpy):
    rng = np.random.default_rng(seed)
    vals = t(rng.integers(-9, 9, n).astype(np.int64))
    ok = t(rng.random(n) < 0.6)
    return [("row_number", None, None), ("rank", None, None),
            ("dense_rank", None, None), ("sum", vals, ok),
            ("count", None, ok), ("min", vals, ok), ("max", vals, ok)]


def test_k18_is_one_call_carrying_every_spec(libs):
    n = 3 * T + 5
    seg = torch.arange(n, dtype=torch.int64) // 7
    peer = torch.arange(n, dtype=torch.int64) // 3
    specs = _specs(n, 1)
    outs = pk.window_scan(seg, peer, specs, n)
    (call,) = libs.k18
    assert (call["n"], call["seg"], call["peer"]) == (n, seg.data_ptr(),
                                                      peer.data_ptr())
    # every spec a figure with its own output plane
    assert call["figs"][:, 0].tolist() == [
        pk.W_ROW_NUMBER, pk.W_RANK, pk.W_DENSE_RANK] + [pk.W_FRAME] * 4
    assert call["figs"][:, 2].tolist() == [o.data_ptr() for o in outs]
    assert all(o.shape == (n,) and o.dtype == torch.int64 for o in outs)
    # the four reductions, each a frame figure reads
    _s, vals, ok = specs[3]
    assert call["reds"].tolist() == [
        [pk.W_SUM, vals.data_ptr(), ok.data_ptr()],
        [pk.W_COUNT, 0, ok.data_ptr()],
        [pk.W_MIN, vals.data_ptr(), ok.data_ptr()],
        [pk.W_MAX, vals.data_ptr(), ok.data_ptr()]]
    assert call["figs"][3:, 1].tolist() == [0, 1, 2, 3]
    assert pk.LAUNCHES["window_scan"] == 2 == \
        pk.window_scan_launch_count(specs)
    # ranking figures only: the scan alone; each call a later epoch on
    # the stream's scratch
    pk.window_scan(seg, peer, specs[:3], n)
    assert pk.LAUNCHES["window_scan"] == 3
    assert pk.window_scan_launch_count(specs[:3]) == 1
    assert [c["epoch"] for c in libs.k18] == [1, 2]
    assert libs.k18[0]["scratch"] == libs.k18[1]["scratch"] \
        == pk._SCRATCH[("window_scan", None, 0)].data_ptr()


def test_k18_shares_a_reduction_and_refuses_past_its_limits(libs):
    n = 100
    seg = torch.zeros(n, dtype=torch.int64)
    peer = torch.arange(n, dtype=torch.int64)
    ok = torch.ones(n, dtype=torch.bool)
    vals = torch.arange(n, dtype=torch.int64)
    pk.window_scan(seg, peer, [("sum", vals, ok), ("count", None, ok),
                               ("sum", vals, ok)], n)
    (call,) = libs.k18
    assert len(call["reds"]) == 2 and call["figs"][:, 1].tolist() == [0, 1, 0]
    many = [("min", torch.full((n,), i, dtype=torch.int64), ok)
            for i in range(pk.K18_MAX_RED + 1)]
    with pytest.raises(pk.errors.DeviceError):
        pk.window_scan(seg, peer, many, n)
    with pytest.raises(pk.errors.DeviceError):
        pk.window_scan(seg, peer, [("rank", None, None)]
                       * (pk.K18_MAX_SPECS + 1), n)
    assert len(libs.k18) == 1
    assert pk.window_scan(seg, peer, [], n) == []


# ---------------------------------------------------------------------------
# the constants and signatures the wrappers mirror
# ---------------------------------------------------------------------------

def test_constants_mirror_the_sources():
    k18 = _source("window_scan.cu")
    assert eval(_define(k18, "K18_THREADS")) * eval(_define(
        k18, "K18_ITEMS")) == pk.K18_TILE
    assert "#define K18_TILE (K18_THREADS * K18_ITEMS)" in k18
    assert int(_define(k18, "K18_MAX_SPECS")) == pk.K18_MAX_SPECS
    assert int(_define(k18, "K18_MAX_RED")) == pk.K18_MAX_RED
    assert "enum K18Red { W_COUNT = %d, W_SUM = %d, W_MIN = %d, W_MAX = %d };" \
        % (pk.W_COUNT, pk.W_SUM, pk.W_MIN, pk.W_MAX) in k18
    assert ("enum K18Fig { W_ROW_NUMBER = %d, W_RANK = %d, W_DENSE_RANK = "
            "%d, W_FRAME = %d };" % (pk.W_ROW_NUMBER, pk.W_RANK,
                                     pk.W_DENSE_RANK, pk.W_FRAME)) in k18
    for gone in ("k18_reduce", "k18_carry", "k18_down", "k18_finish"):
        assert gone not in k18
    k15 = _source("slot_agg.cu")
    for name in ("K15_THREADS", "K15_ROWS", "K15_TARGET_BLOCKS",
                 "K15_MAX_ROW_BLOCKS", "K15_MAX_PAIRS", "K15_MAX_GROUP",
                 "K15_SAME"):
        assert eval(_define(k15, name)) == getattr(pk, name), name
    assert "slot_agg_combine" not in k15 and "VmSmemRegs" in k15
    assert "#define K15_MAX_RED SLOT_MAX_RED" in k15
    assert "#define K15_CELL_BYTES (16 * SLOT_POOL_WORDS * SLOT_MAX_RED)" \
        in k15 and pk.K15_CELL_BYTES == 16 * 2048 * 9
    assert "#define K15_TICKET_BYTES (4 * SLOT_POOL_WORDS)" in k15 \
        and pk.K15_TICKET_BYTES == 4 * 2048
    assert pk.slot_agg_scratch_bytes(3, 2, (5, 1, 7, 1)) == \
        pk.K15_CELL_BYTES + pk.K15_TICKET_BYTES + 16 * 42
    assert "VmRow" not in _source("vm.cuh")


@pytest.mark.parametrize("name,fn", [("slot_agg", "slot_agg_launch"),
                                     ("window_scan", "window_scan_launch"),
                                     ("window_scan", "window_scan_state_bytes"),
                                     ("window_scan", "window_scan_aux_bytes")])
def test_signatures_match_the_sources(name, fn):
    src = _source(name + ".cu")
    params = re.search(r'extern "C" \w+ %s\((.*?)\)\s*\{' % fn, src,
                       re.S).group(1)
    argtypes, _rt = _ext.SIGNATURES[name][fn]
    assert len(argtypes) == len([p for p in params.split(",") if p.strip()])
    assert set(_ext.SIGNATURES[name]) == set(
        re.findall(r'extern "C" \w+ (\w+)\(', src))


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

def _edge_inputs(kind: str, seed: int):
    """seg, peer of one of K18's tile-edge shapes (numpy)."""
    rng = np.random.default_rng(seed)

    def ids(bounds, n):
        chg = np.zeros(n, bool)
        chg[[b for b in bounds if 0 < b < n]] = True
        return np.cumsum(chg).astype(np.int64)

    if kind.startswith("n = "):
        n = eval(kind[4:].replace("T", str(T)))
        seg = np.sort(rng.integers(0, 9, n)).astype(np.int64)
        chg = np.r_[False, (seg[1:] != seg[:-1]) | (rng.random(n - 1) < 0.2)]
        return seg, np.cumsum(chg).astype(np.int64)
    if kind == "a peer group over three tiles":
        n = 3 * T + 40
        return ids([T - 5], n), ids([7, T - 5, 3 * T + 9], n)
    if kind == "a partition on a tile's first row":
        n = 2 * T + 3
        return ids([T], n), ids([T, T + 1], n)
    if kind == "one row":
        return np.zeros(1, np.int64), np.zeros(1, np.int64)
    n = T + 7                                   # every row its own partition
    return np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64)


@pytest.mark.parametrize("kind", [
    "n = T - 1", "n = T", "n = T + 1", "a peer group over three tiles",
    "a partition on a tile's first row", "one row",
    "every row its own partition"])
def test_window_scan_plain_vs_jax_at_the_tile_edges(kind):
    seg, peer = _edge_inputs(kind, len(kind))
    n = len(seg)
    rng = np.random.default_rng(n)
    vals = rng.choice(np.array([I64_MAX, I64_MIN, 5, -7, 1 << 62], np.int64),
                      n)
    ok = rng.random(n) < 0.6
    specs = [("row_number", None, None), ("rank", None, None),
             ("dense_rank", None, None), ("sum", vals, ok),
             ("count", None, ok), ("min", vals, ok), ("max", vals, ok)]
    want = rkernels.window_scan(seg, peer, specs, n)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = pk.window_scan(t(seg), t(peer),
                         [(op, t(v), t(c)) for op, v, c in specs], n)
    for (op, _v, _c), g, w in zip(specs, got, want):
        assert np.array_equal(g.numpy(), np.asarray(w, np.int64)), op
    # numpy's frame ends: a row's figure is the run at its group's end
    e = np.searchsorted(peer, peer, side="right") - 1
    s = np.searchsorted(seg, seg)
    cnt = np.concatenate([[0], np.cumsum(ok)])
    assert got[4].tolist() == (cnt[e + 1] - cnt[s]).tolist()


@pytest.mark.parametrize("k", [1, 32])
def test_slot_agg_states_plain_vs_jax_agg_wrapper(k):
    rb = _batch(31)
    rb.columns[2].values[rb.columns[2].values == 0.0] = 0.0
    pb = carry.batch_from(rb)
    names = AGG_SETS["ints and decimals"]
    sels = [_agg_sel(WHERES["a < x"](x), names) for x in _cases(k, 5)]
    ref_aggs = rsched._lower_slot_aggs(sels[0], rb)
    port_aggs = psched._lower_slot_aggs(carry.request_from(sels[0]), pb)
    fn, _sig, pi, pf = _ref_slots(rb, [s.where for s in sels])
    wrapper = jax.jit(rsched._build_agg_wrapper(fn, ref_aggs))
    planes, live = _jax_planes(rb)
    L = rsched.MicroBatcher._slot_layout(ref_aggs)
    block = np.asarray(wrapper(planes, live, jnp.asarray(pi),
                               jnp.asarray(pf))).reshape(k, L)
    fin, pools = _port_slots(pb, [s.where for s in sels])
    pplanes, plist, plive = _port_planes(pb, fin)
    reds = [pk.Red(pk.R_COUNT, const_bits=1)] + [a.red(pplanes)
                                                 for a in port_aggs]
    states = pk.slot_agg_states(fin, pools, plist, plive, reds)
    assert states.shape == (k, len(reds), 2)
    for j in range(k):
        n_pass, outs = rsched.MicroBatcher._decode_slot(ref_aggs, block[j])
        assert int(states[j, 0, 0]) == n_pass
        for i, (a, (cnt, v)) in enumerate(zip(port_aggs, outs), start=1):
            assert int(states[j, i, 0]) == cnt, (a.name, j)
            if a.op != "count":
                got = int(states[j, i, 1])
                if a.kind == psched.col.K_F64:
                    got = float(np.int64(got).view(np.float64))
                    v = float(port_identity(np.float64(v)))
                assert got == v, (a.name, j)
