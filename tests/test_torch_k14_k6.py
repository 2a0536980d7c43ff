"""K14 (`slot_filter`) and K6's small spans after their redesign for
Hopper (slice 15), on the CPU.

- The slot-invariance pass (`exprc.slot_split`) and its plain model
  (`exprc.run_split_plain`: the invariant instructions once over the
  rows with no constant pool at all, then the rest once a slot over the
  same registers): over the programs of `tpch.G_SHAPES`' WHERE kinds, the
  sched-kernel tests' WHERE shapes and hypothesis-generated WHERE trees of
  them, its masks equal `run_program_plain` run per slot and the JAX
  tier's (the filter wrapper of tidb_tpu/ops/sched.py, jitted on the CPU
  as its own tests run it), bit for bit; a program whose split order
  needs more than MAX_REGS registers runs whole per slot.
- The parameter block K14 and K15 carry by value (vm.cuh SlotParams):
  its limits and layout against the source, the largest constant pool
  the lowering can emit against it, the DeviceError past it, and, over a
  recording stub in place of the CUDA library, what each launch is
  handed (no card tensor made for a table).
- K6's route and copy count at q1full's, plain_q1's and row 15f's shapes
  (17 reductions over 8 segments a region, 9 over 64, 5 over 8), q1full's
  read from its own arguments at SF0.01; the block route's tables by
  value, and on the card past K6Params' room.
- Region states at those shapes, scaled down, with a group that holds
  half the rows: the port's plain version against the JAX package's
  region_agg_states_batched.

Tolerance: masks, counts, integers and extrema exact (the reference's
f64 extremum identity +-F64_MAX mapped to the port's +-inf); f64 sums
1e-12 relative to the sum of magnitudes (another summation order).
"""

from __future__ import annotations

import ctypes
import os
import re
import types
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from tidb_tpu import mysqldef as rmy
from tidb_tpu.copr.proto import expr_column as c, expr_op, expr_value
from tidb_tpu.ops import columnar as rcol
from tidb_tpu.ops import kernels as rk
from tidb_tpu.ops import sched as rsched
from tidb_tpu.sqlast.opcode import Op
from tidb_tpu.types import Datum as RDatum

from tidb_tpu_torch import carry, errors, tpch
from tidb_tpu_torch.ops import _ext, exprc
from tidb_tpu_torch.ops import kernels as pk
from tidb_tpu_torch.ops import sched as psched

from test_torch_sched_kernels import (_RMB, WHERES, _batch, _jax_planes,
                                      _port_planes, _ref_slots)
from torch_parity import F64_RTOL, port_identity

CSRC = os.path.join(os.path.dirname(pk.__file__), "csrc")
CPU = torch.device("cpu")
KB = 8                      # the reference's slot bucket for k <= 8


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _define(src: str, name: str) -> int:
    return int(re.search(r"#define %s (\d+)" % name, src).group(1))


def _lower(pb, wheres):
    """The port's lowering of each statement: (program, pools [k, P]);
    None where the statements lower to different programs."""
    fin, pools = None, []
    for w in wheres:
        lw = psched._Lowerer(pb)
        emit, _sig = lw.lower(carry.expr_from(w))
        f = lw.program(pb, emit)
        if fin is not None and not np.array_equal(f.meta, fin.meta):
            return None
        fin = f
        pools.append(f.pool)
    return fin, torch.from_numpy(np.stack(pools))


def _jax_masks(rb, wheres) -> np.ndarray:
    """The JAX tier's survivor masks bool [k, capacity] of the statements
    (MicroBatcher._kernel's filter wrapper at slot bucket KB)."""
    k = len(wheres)
    fn, sig, pi, pf = _ref_slots(rb, wheres)
    pi = np.concatenate([pi, np.repeat(pi[-1:], KB - k, 0)])
    pf = np.concatenate([pf, np.repeat(pf[-1:], KB - k, 0)])
    proto = types.SimpleNamespace(sig=(sig, None, None, 0, 0), fn=fn,
                                  aggs=None, topn=None, batch=rb)
    jitted, _kst = _RMB._kernel(None, proto, KB)
    planes, live = _jax_planes(rb)
    words = np.asarray(jitted(planes, live, jnp.asarray(pi),
                              jnp.asarray(pf))).reshape(-1)
    return rsched._unpack_mask_words(words, KB, rb.capacity)[:k]


def _check_split(rb, pb, wheres, jax: bool = True) -> tuple:
    """The split plain run against run_program_plain per slot and (jax)
    the JAX tier, mask for mask. Returns (fin, n_inv)."""
    lowered = _lower(pb, wheres)
    assert lowered is not None
    fin, pools = lowered
    _pp, plist, plive = _port_planes(pb, fin)
    split = exprc.run_split_plain(fin, pools, plist, plive)
    per_slot = pk._slot_masks_plain(fin, pools, plist, plive)
    for s, (a, b) in enumerate(zip(split, per_slot)):
        assert torch.equal(a, b), s
    if jax:
        np.testing.assert_array_equal(torch.stack(split).numpy(),
                                      _jax_masks(rb, wheres))
    return fin, exprc.slot_split(fin)[1]


# ---------------------------------------------------------------------------
# the slot-invariance pass
# ---------------------------------------------------------------------------

SUP_CAP, SUP_N = 2048, 2000
NATION, ACCTBAL, NAME = tpch.S_NATIONKEY, tpch.S_ACCTBAL, tpch.S_NAME


def _supplier_batch() -> rcol.ColumnBatch:
    """SF1's supplier columns that the G shapes' WHERE reads, cut to
    SUP_N rows (capacity SUP_CAP), as a reference batch."""
    data, words = tpch.supplier(SUP_N, 9)
    live = np.arange(SUP_CAP) < SUP_N

    def pad(v):
        return np.concatenate([v, np.zeros(SUP_CAP - SUP_N, v.dtype)])

    names = [words[NAME][i] for i in data[NAME].tolist()]
    dic = sorted(set(names))
    code = {w: i for i, w in enumerate(dic)}
    cols = {
        NATION: rcol.ColumnData(rcol.K_I64, pad(data[NATION]), live,
                                tp=rmy.TypeLonglong, max_abs=24),
        ACCTBAL: rcol.ColumnData(rcol.K_DEC, pad(data[ACCTBAL]), live,
                                 tp=rmy.TypeNewDecimal, dec_scale=2,
                                 max_abs=int(np.abs(data[ACCTBAL]).max())),
        NAME: rcol.ColumnData(rcol.K_STR, pad(np.array(
            [code[w] for w in names], np.int64)), live, dic,
            tp=rmy.TypeVarchar),
    }
    return rcol.ColumnBatch(SUP_N, SUP_CAP,
                            np.arange(1, SUP_CAP + 1, dtype=np.int64), cols)


def _g_where(shape: str, lit: int):
    """tpch.g_statement's WHERE as a reference expression."""
    if shape == "g_acctbal":
        return expr_op(Op.GT, c(ACCTBAL), expr_value(
            RDatum.dec(Decimal(lit).scaleb(-2))))
    if shape == "g_name":
        return expr_op(Op.EQ, c(NAME), expr_value(
            RDatum.bytes_(b"Supplier#%09d" % lit)))
    return expr_op(Op.EQ, c(NATION), expr_value(RDatum.i64(lit)))


@pytest.mark.parametrize("shape", tpch.G_SHAPES)
def test_split_matches_per_slot_and_jax_at_g_shapes(shape):
    rb = _supplier_batch()
    pb = carry.batch_from(rb)
    rng = np.random.default_rng(len(shape))
    lits = [tpch.g_literal(shape, rng) % (SUP_N * 21 // 20 + 1)
            if shape == "g_name" else tpch.g_literal(shape, rng)
            for _ in range(6)]
    wheres = [_g_where(shape, x) for x in lits]
    fin, n_inv = _check_split(rb, pb, wheres)
    # the port's own G statement lowers to the same program
    port = tpch.g_statement(shape, lits[0]).data
    lw = psched._Lowerer(pb)
    emit, _sig = lw.lower(port.where)
    assert np.array_equal(lw.program(pb, emit).meta, fin.meta)
    # the column's load runs once a row, the literal's compare once a slot
    ins, n_inv, where = exprc.slot_split(fin)
    assert n_inv >= 1 and all(x[0] == exprc.OP_LOAD for x in ins[:n_inv])
    assert where == ins[-1][1]


@pytest.mark.parametrize("shape", sorted(WHERES))
def test_split_matches_per_slot_and_jax_at_sched_shapes(shape):
    rb = _batch(21)
    pb = carry.batch_from(rb)
    _check_split(rb, pb, [WHERES[shape](x) for x in range(3, 60, 11)])


_LEAVES = sorted(k for k in WHERES if k != "a = NULL")
_TREES = st.recursive(
    st.sampled_from(_LEAVES),
    lambda kids: st.tuples(st.sampled_from(["and", "or", "xor"]), kids,
                           kids) | st.tuples(st.just("not"), kids),
    max_leaves=5)
_LOGIC = {"and": Op.AndAnd, "or": Op.OrOr, "xor": Op.Xor}


def _tree_expr(tree, slot: int, leaf=None):
    """A reference WHERE from a tree of WHERES' leaves: leaf j of slot s
    takes the literal seed 13 s + 7 j, so the slots differ in literals."""
    leaf = leaf if leaf is not None else [0]
    if isinstance(tree, str):
        leaf[0] += 1
        return WHERES[tree](13 * slot + 7 * leaf[0])
    if tree[0] == "not":
        return expr_op(Op.Not, _tree_expr(tree[1], slot, leaf))
    return expr_op(_LOGIC[tree[0]], _tree_expr(tree[1], slot, leaf),
                   _tree_expr(tree[2], slot, leaf))


_HYP_BATCH = _batch(22)
_HYP_PB = carry.batch_from(_HYP_BATCH)


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.filter_too_much])
@given(tree=_TREES, k=st.integers(1, 5))
def test_split_matches_per_slot_and_jax_on_generated_wheres(tree, k):
    wheres = [_tree_expr(tree, s) for s in range(k)]
    try:
        lowered = _lower(_HYP_PB, wheres)
        sigs = {rsched._Lowerer(_HYP_BATCH).lower(w)[1] for w in wheres}
    except (psched._Unbatchable, exprc.Unsupported, rsched._Unbatchable):
        lowered = None
    assume(lowered is not None and len(sigs) == 1)
    _check_split(_HYP_BATCH, _HYP_PB, wheres)


def test_split_reallocates_registers_so_loads_run_once():
    """The allocator of `finalize` reuses a register its operand frees:
    the split allocates anew, so every load lands in the invariant part
    even where the original program reused the load's register."""
    rb = _batch(23)
    pb = carry.batch_from(rb)
    wheres = [WHERES["a between x and x (xor d)"](x) for x in (1, 5, 8)]
    fin, n_inv = _check_split(rb, pb, wheres, jax=False)
    ins, n_inv, _w = exprc.slot_split(fin)
    loads = [x for x in fin.instructions() if x[0] == exprc.OP_LOAD]
    assert [x for x in ins[:n_inv] if x[0] == exprc.OP_LOAD] == loads
    assert not any(x[0] == exprc.OP_LOAD for x in ins[n_inv:])
    assert not any(x[0] in exprc.POOL_OPS for x in ins[:n_inv])


def test_split_past_the_registers_runs_whole_per_slot():
    """15 columns each compared with its own literal: split, the 15 loads
    would all stay live into the per-slot part beside its CONST and its
    compare, more than MAX_REGS registers; the program then runs whole,
    per slot, as it was."""
    n, m = 256, 15
    rng = np.random.default_rng(5)
    plist = [torch.from_numpy(rng.integers(0, 4, n)) for _ in range(m)]
    live = torch.ones(n, dtype=torch.bool)
    code = []
    acc = 15
    for j in range(m):
        code += [[exprc.OP_LOAD, 0, j, -1, -1, 0],
                 [exprc.OP_CONST, 1, 1, -1, -1, j],
                 [exprc.OP_EQ_I, 0, 0, 1, -1, 0]]
        if j == 0:
            code.append([exprc.OP_NOT, acc, 0, -1, -1, 0])
            code.append([exprc.OP_NOT, acc, acc, -1, -1, 0])
        else:
            code.append([exprc.OP_OR, acc, acc, 0, -1, 0])
    meta = [len(code), acc, 0, 0, 0, m, 0, 0] + [x for i in code for x in i]
    fin = exprc.Finalized(np.asarray(meta, np.int64),
                          np.zeros(m, np.int64), np.zeros(1, np.uint8),
                          [(j, 0) for j in range(m)], [])
    ins, n_inv, where = exprc.slot_split(fin)
    assert (n_inv, where) == (0, acc)
    assert [list(x) for x in ins] == code
    pools = torch.from_numpy(rng.integers(0, 4, (3, m)))
    split = exprc.run_split_plain(fin, pools, plist, live)
    for s in range(3):
        want = torch.zeros(n, dtype=torch.bool)
        for j in range(m):
            want |= plist[j] == pools[s, j]
        assert torch.equal(split[s], want)
        assert torch.equal(pk._slot_masks_plain(fin, pools, plist, live)[s],
                           want)


# ---------------------------------------------------------------------------
# the parameter block by value
# ---------------------------------------------------------------------------

def _slot_param_bytes(n_instr: int, pool_words: int, lut_bytes: int) -> int:
    """sizeof(SlotParams<n_instr, pool_words, lut_bytes>) in vm.cuh: plane
    pointers, instructions, pools, K15's descriptors, the LUT (padded to
    8 bytes)."""
    return 8 * (pk.SLOT_MAX_PLANES + 6 * n_instr + pool_words
                + 5 * pk.SLOT_MAX_REDS) + -(-lut_bytes // 8) * 8


def test_slot_param_block_matches_source():
    src = _source("vm.cuh")
    assert _define(src, "SLOT_MAX_INSTR") == pk.SLOT_MAX_INSTRS \
        == exprc.MAX_INSTRS
    assert _define(src, "SLOT_POOL_WORDS") == pk.SLOT_POOL_WORDS \
        == psched.MAX_SLOTS * exprc.MAX_INSTRS
    assert _define(src, "SLOT_LUT_BYTES") == pk.SLOT_LUT_BYTES
    assert _define(src, "SLOT_MAX_RED") == pk.SLOT_MAX_REDS
    assert _define(src, "SLOT_PARAM_LIMIT") == pk.SLOT_PARAM_LIMIT == 32764
    assert _define(src, "VM_ROW_PLANES") == pk.SLOT_MAX_PLANES
    body = re.search(r"struct SlotParams \{(.*?)\};", src, re.S).group(1)
    fields = [re.search(r"(\w+)\[", ln).group(1) for ln in body.split("\n")
              if "[" in ln and ";" in ln]
    assert fields == ["planes", "ins", "pools", "desc", "lut"]
    small = re.search(r"typedef SlotParams<(\d+), (\d+), (\d+)> "
                      r"SlotParamsSmall;", src).groups()
    assert tuple(int(x) for x in small) == pk.SLOT_BLOCKS[0]
    assert "typedef SlotParams<SLOT_MAX_INSTR, SLOT_POOL_WORDS, " \
        "SLOT_LUT_BYTES> SlotParamsLarge;" in src
    # the larger block and a launcher's other arguments fit CUDA's limit
    assert _slot_param_bytes(*pk.SLOT_BLOCKS[1]) + 256 \
        <= pk.SLOT_PARAM_LIMIT
    assert "static_assert(sizeof(SlotParamsLarge) + 256 <= " \
        "SLOT_PARAM_LIMIT" in src
    for name in ("slot_filter.cu", "slot_agg.cu"):
        s = _source(name)
        assert "const __grid_constant__ Prm p" in s
        assert "cudaMemcpy" not in s
    assert "VmSmemRegs" in _source("slot_filter.cu")


def _many_literals(pb, n: int):
    """a = x_0 or a = x_1 or ... with n literals."""
    e = expr_op(Op.EQ, c(1), expr_value(RDatum.i64(0)))
    for j in range(1, n):
        e = expr_op(Op.OrOr, e, expr_op(Op.EQ, c(1),
                                         expr_value(RDatum.i64(j))))
    return e


def test_largest_pool_the_lowering_emits_fits_the_block():
    """Each parameter is one CONST and one compare of the program, so the
    lowering's pool never outgrows MAX_INSTRS; 32 slots of it fit."""
    pb = carry.batch_from(_batch(24))
    widest = 0
    for n in range(1, exprc.MAX_INSTRS):
        try:
            lowered = _lower(pb, [_many_literals(pb, n)])
        except exprc.Unsupported:
            break
        widest = lowered[1].shape[1]
    assert 20 <= widest <= exprc.MAX_INSTRS
    assert psched.MAX_SLOTS * widest <= pk.SLOT_POOL_WORDS


class _Recorder:
    """A stand-in for the slot libraries: records each launch and the
    host tables it was handed, read during the call as the library
    copies them into its parameter block."""

    def __init__(self):
        self.calls = []

    def slot_filter_launch(self, n, k, P, planes, n_planes, ins, n_instr,
                           n_inv, where, n_regs, pools, lut, lut_len, live,
                           words, stream):
        def read(p, count, dtype):
            return np.frombuffer(ctypes.string_at(p, count * np.dtype(
                dtype).itemsize), dtype).copy()
        self.calls.append(dict(
            n=n, k=k, P=P, planes=read(planes, n_planes, np.uint64),
            ins=read(ins, 6 * n_instr, np.int64).reshape(-1, 6),
            n_inv=n_inv, where=where, n_regs=n_regs,
            pools=read(pools, k * P, np.int64).reshape(k, P),
            lut=read(lut, lut_len, np.uint8), live=live, words=words))
        return 0

    def slot_agg_launch(self, n, k, P, planes, n_planes, ins, n_instr,
                        n_inv, where, n_regs, pools, lut, lut_len, live,
                        n_red, desc, groups, per_group, row_blocks,
                        tiles_per_block, scratch, out, stream):
        self.calls.append(dict(
            n=n, k=k, P=P, n_inv=n_inv, where=where, n_regs=n_regs,
            plan=(groups, per_group, row_blocks, tiles_per_block),
            ins=np.frombuffer(ctypes.string_at(ins, 48 * n_instr),
                              np.int64).reshape(-1, 6).copy(),
            desc=np.frombuffer(ctypes.string_at(desc, 40 * n_red),
                               np.int64).reshape(n_red, 5).copy(),
            scratch=scratch, out=out))
        return 0


@pytest.fixture
def stub_slots(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_device_kind", lambda t: "cuda")
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))

    def no_card_tables(*a, **kw):
        raise AssertionError("a slot launch made a tensor of a table")
    monkeypatch.setattr(torch, "tensor", no_card_tables)
    return rec


def test_slot_filter_hands_its_tables_by_value(stub_slots):
    rb = _batch(25)
    pb = carry.batch_from(rb)
    wheres = [WHERES["a is null or not f = x"](x) for x in range(7)]
    fin, pools = _lower(pb, wheres)
    _pp, plist, plive = _port_planes(pb, fin)
    words = pk.slot_filter(fin, pools, plist, plive)
    (call,) = stub_slots.calls
    assert pk.LAUNCHES["slot_filter"] == 1
    ins, n_inv, where = exprc.slot_split(fin)
    assert (call["n"], call["k"], call["P"]) == (rb.capacity, 7,
                                                  pools.shape[1])
    assert list(call["planes"]) == [t.data_ptr() for t in plist]
    assert call["ins"].tolist() == [list(x) for x in ins]
    assert (call["n_inv"], call["where"]) == (n_inv, where)
    assert call["n_regs"] == 1 + max(x[1] for x in ins)
    assert np.array_equal(call["pools"], pools.numpy())
    assert np.array_equal(call["lut"], fin.lut)
    assert (call["live"], call["words"]) == (plive.data_ptr(),
                                             words.data_ptr())
    assert words.shape == (7, rb.capacity // 64)
    # the program's parts are made once per bytecode and LUT
    pk.slot_filter(fin, pools, plist, plive)
    assert np.array_equal(stub_slots.calls[-1]["ins"], call["ins"])
    key = (fin.meta.tobytes(), fin.lut.tobytes())
    assert pk._SLOT_PROGS[key].p_split == \
        pk._SLOT_PROGS[key].split.ctypes.data


def test_slot_agg_hands_its_tables_by_value(stub_slots):
    rb = _batch(26)
    pb = carry.batch_from(rb)
    fin, pools = _lower(pb, [WHERES["a < x"](x) for x in range(3)])
    planes, plist, plive = _port_planes(pb, fin)
    reds = [pk.Red(pk.R_COUNT, const_bits=1),
            pk.Red(pk.R_SUM_I, *planes[3]), pk.Red(pk.R_MAX_F, *planes[2])]
    n, acc = pk.slot_agg(fin, pools, plist, plive, reds)
    (call,) = stub_slots.calls
    # K14's split program: the invariant part, its WHERE register and the
    # registers it writes
    ins, n_inv, where = exprc.slot_split(fin)
    assert call["ins"].tolist() == [list(x) for x in ins]
    assert (call["n_inv"], call["where"]) == (n_inv, where)
    assert call["n_regs"] == 1 + max(x[1] for x in ins)
    assert (call["n"], call["k"], call["P"]) == (rb.capacity, 3,
                                                  pools.shape[1])
    assert call["desc"].tolist() == pk._red_rows(reds, rb.capacity, CPU)
    assert n.shape == acc.shape == (3, 3)
    assert call["out"] == n.data_ptr()
    assert pk.LAUNCHES["slot_agg"] == 1


def test_slot_launch_refuses_what_its_block_cannot_hold(stub_slots):
    pb = carry.batch_from(_batch(27))
    fin, pools = _lower(pb, [WHERES["a < x"](x) for x in range(2)])
    _pp, plist, plive = _port_planes(pb, fin)
    too_many = torch.zeros((pk.SLOT_POOL_WORDS // 64 + 1, 64),
                           dtype=torch.int64)
    for bad in (too_many, torch.zeros((2, 0), dtype=torch.int64),
                torch.zeros((2, 4), dtype=torch.int32),
                torch.zeros((2, 4), dtype=torch.int64, device="meta"),
                torch.zeros((4, 2), dtype=torch.int64).t(),
                np.zeros((2, 4), np.int64)):
        with pytest.raises(errors.DeviceError):
            pk.slot_filter(fin, bad, plist, plive)
        with pytest.raises(errors.DeviceError):
            pk.slot_agg(fin, bad, plist, plive,
                        [pk.Red(pk.R_COUNT, const_bits=1)])
    assert not stub_slots.calls
    # exactly the block's pool words still ride
    pk.slot_filter(fin, torch.zeros((pk.SLOT_POOL_WORDS // 64, 64),
                                    dtype=torch.int64), plist, plive)
    assert len(stub_slots.calls) == 1


# ---------------------------------------------------------------------------
# K6's route and copies at the tile route's former shapes
# ---------------------------------------------------------------------------

LIMIT = 232448 - 1472     # the H100's opt-in limit less the kernel's static


@pytest.mark.parametrize("what,n_red,span,n_f", [
    ("q1full", 17, 8, 0), ("plain_q1 over 8 shards", 9, 64, 0),
    ("row 15f", 5, 8, 0), ("row 15f with f64 states", 5, 8, 2),
    ("SF0.01 regions", 17, 8, 0)])
def test_k6_small_spans_take_the_block_route_with_copies(what, n_red, span,
                                                         n_f):
    route, rows, minb, copies = pk.k6_route(n_red, span, LIMIT, n_f)
    assert route == "seg_states_ragged_smem"
    assert (rows, minb) == (pk.K6B_SMALL_ROWS, pk.K6B_SMALL_BLOCKS) == (2, 2)
    # few segments: every lane of a warp that hits one segment lands in a
    # copy of its own but for two
    assert copies == pk.K4_MAX_COPIES == 16
    small = LIMIT // pk.K6B_SMALL_BLOCKS - pk.K6B_SMALL_RESERVE
    assert pk.k6_block_bytes(n_red, n_f, span, rows) \
        + 8 * (copies - 1) * n_red * span <= small
    # two such blocks and their static and reserved memory fit an SM
    assert 2 * (small + 1472 + 1024) <= 233472


def test_k6_q1full_route_from_its_arguments():
    """q1full's K6 arguments at SF0.01 over 8 regions (the cluster path's
    capture, as chip_smoke's Phase C reads them): 17 integer reductions
    over 8 segments a region, the small-span instantiation, 16 copies."""
    from tidb_tpu_torch.cluster.store import DistStore
    from tidb_tpu_torch.copr.plane_cache import PlaneCache
    import chip_smoke as cs
    data = tpch.generate(4096, 2)
    store = DistStore([], tpch.split_keys(4096, 8), CPU,
                      plane_cache=PlaneCache(device=CPU))
    sel = tpch.sweep_request("q1full")
    cs.admit(store, sel, tpch.region_batches(data, cs.D_CIDS, 8))
    _r, k6, _s = cs.capture(store, sel, CPU)
    _gid, caps, _n, Gs, reds, contribs = k6
    span = max(pk.bucket_segments(g + 1) for g in Gs)
    n_f = sum(r.op in pk.F_OPS for r in reds[0])
    assert (len(caps), len(contribs), span, n_f) == (8, 17, 8, 0)
    assert pk.k6_route(17, span, LIMIT, n_f) == (
        "seg_states_ragged_smem", 2, 2, 16)


class _K6Recorder:
    def __init__(self):
        self.calls = []

    def seg_states_block_limit(self):
        return LIMIT

    def seg_states_block_grid(self, rows, minb, smem):
        return 132 * minb

    def seg_states_block_launch(self, rows, minb, copies, n_blocks, tables,
                                on_card, R, gid, n_red, n_f, span_max,
                                n_seg, part, out, stream):
        n = 6 * R + 2 * n_red + 2 * n_red * R
        self.calls.append(dict(
            rows=rows, minb=minb, copies=copies, on_card=on_card, R=R,
            tables=np.frombuffer(ctypes.string_at(tables, 8 * n),
                                 np.int64).copy()))
        return 0


@pytest.mark.parametrize("R", [8, 16, 17])
def test_k6_tables_by_value_then_on_the_card(monkeypatch, R):
    """Up to K6_PARAM_REGIONS regions and K6_PARAM_TAB plane pointers the
    block route's tables ride by value (no tensor made of them); past
    that they are one table on the card, in the same layout."""
    rec = _K6Recorder()
    monkeypatch.setattr(_ext, "lib", lambda name: rec)
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    monkeypatch.setattr(pk, "_K6_LIMIT", {})
    monkeypatch.setattr(pk, "_K6_GRID", {})
    monkeypatch.setattr(pk, "LAUNCHES", dict.fromkeys(pk.LAUNCHES, 0))
    made = []
    real_tensor = torch.tensor

    def tensor(*a, **kw):
        made.append(a)
        return real_tensor(*a, **kw)
    monkeypatch.setattr(torch, "tensor", tensor)
    rng = np.random.default_rng(R)
    caps = [256] * R
    ops = [pk.R_COUNT, pk.R_SUM_I, pk.R_MIN_I, pk.R_MAX_I, pk.R_SUM_I,
           pk.R_COUNT, pk.R_MAX_I, pk.R_SUM_I]
    gid = torch.from_numpy(rng.integers(0, 5, 256 * R))
    contribs = [torch.from_numpy(rng.random(256 * R) < 0.7) for _ in ops]
    reds = [[pk.StatesInput(op, None, None if op == pk.R_COUNT else
                            torch.from_numpy(rng.integers(0, 9, 256)),
                            None) for op in ops] for _r in range(R)]
    launch, _out = pk.k6_prepare(gid, caps, [250] * R, [4] * R, reds,
                                 contribs)
    launch()
    (call,) = rec.calls
    on_card = 2 * len(ops) * R > pk.K6_PARAM_TAB or R > pk.K6_PARAM_REGIONS
    assert call["on_card"] == int(on_card) and call["R"] == R
    assert bool(made) == on_card
    assert (call["rows"], call["minb"], call["copies"]) == (2, 2, 16)
    rdesc = call["tables"][:6 * R].reshape(R, 6)
    assert rdesc[:, 1].tolist() == [250] * R
    red = call["tables"][6 * R:6 * R + 2 * len(ops)].reshape(-1, 2)
    assert red[:, 0].tolist() == ops
    assert red[:, 1].tolist() == [t.data_ptr() for t in contribs]
    vals = call["tables"][6 * R + 2 * len(ops):].reshape(2, len(ops), R)
    assert vals[0, 1].tolist() == [rr[1].values.data_ptr() for rr in reds]
    assert not vals[0, 0].any() and not vals[1].any()
    assert pk.LAUNCHES["seg_states_ragged_smem"] == 1


# ---------------------------------------------------------------------------
# region states at those shapes against the JAX package
# ---------------------------------------------------------------------------

# (regions, rows a region, live rows a region, G, [(op, "i" / "f" / None)])
K6_SHAPES = {
    "q1full": (8, 3000, 2700, 4, [("sum", None)] * 5 + [("sum", "i")] * 8
               + [("min", "i"), ("max", "i"), ("sum", None),
                  ("sum", "i")]),
    "plain_q1 over 8 shards": (8, 4096, 3000, 50, [
        ("sum", None), ("sum", "i"), ("min", "i"), ("max", "i"),
        ("sum", None), ("sum", "i"), ("min", "i"), ("max", "i"),
        ("sum", None)]),
    "row 15f": (8, 1024, 300, 5, [("sum", "i"), ("sum", "f"), ("min", "f"),
                                  ("max", "f"), ("sum", None)]),
}


def _shape_segs(name: str) -> list:
    """Region segments of a shape: half of each region's live rows in
    group 1 (Q1's largest group holds about half), -0.0 beside +0.0 and
    +-inf in the f64 planes, int64 extremes in the integer ones."""
    R, cap, n, G, ops = K6_SHAPES[name]
    rng = np.random.default_rng(len(name))
    segs = []
    for _r in range(R):
        gid = rng.integers(0, G, cap).astype(np.int64)
        gid[rng.random(cap) < 0.5] = 1 % G
        gid[n:] = G
        live = np.arange(cap) < n
        specs = []
        for op, kind in ops:
            contrib = live & (rng.random(cap) < 0.95)
            if kind == "f":
                v = rng.integers(-40, 40, cap) * 0.125
                if op != "sum":
                    v[rng.random(cap) < 0.3] = -0.0
                    v[rng.random(cap) < 0.01] = np.inf
                    v[rng.random(cap) < 0.01] = -np.inf
            elif kind == "i":
                v = rng.integers(-10 ** 6, 10 ** 6, cap).astype(np.int64)
                if op != "sum":
                    v[rng.random(cap) < 0.01] = (1 << 63) - 1
                    v[rng.random(cap) < 0.01] = -(1 << 63)
            else:
                v = None
            specs.append((op, v, contrib))
        segs.append((gid, specs, G, n))
    return segs


@pytest.mark.parametrize("name", sorted(K6_SHAPES))
def test_region_states_at_the_small_span_shapes_match_jax(name):
    segs = _shape_segs(name)
    R, _cap, _n, G, ops = K6_SHAPES[name]
    span = pk.bucket_segments(G + 1)
    n_f = sum(kind == "f" for _op, kind in ops)
    assert pk.k6_route(len(ops), span, LIMIT, n_f)[:3] == (
        "seg_states_ragged_smem", 2, 2)
    want = rk.region_agg_states_batched(
        [(g, [(op, v, cc) for op, v, cc in sp], G_) for g, sp, G_, _n in segs])
    got = pk.region_agg_states_batched(
        [(g, [(op, None if v is None else torch.from_numpy(v), cc)
              for op, v, cc in sp], G_, n_) for g, sp, G_, n_ in segs], "cpu")
    for r, (g_r, w_r) in enumerate(zip(got, want)):
        gid, specs, _G, _n = segs[r]
        for j, (g, w) in enumerate(zip(g_r, w_r)):
            op, v, cc = specs[j]
            w = np.asarray(port_identity(np.asarray(w)))
            assert g.shape == w.shape == (G,), (r, j)
            if g.dtype == np.float64 and op == "sum":
                mag = np.zeros(G)
                keep = cc & (gid < G)
                np.add.at(mag, gid[keep], np.abs(v[keep]))
                assert (np.abs(g - w) <= F64_RTOL * mag).all(), (r, j)
            elif g.dtype == np.float64:
                assert np.array_equal(g, w), (r, j)     # -0.0 == +0.0 here
            else:
                assert np.array_equal(g, w.astype(g.dtype)), (r, j)
