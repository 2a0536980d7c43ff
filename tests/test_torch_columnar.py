"""The same KV pairs pack into the same column planes in both packages.

A table of every plane kind (int, unsigned, double, decimal, string,
date, datetime, time) with seeded rows and NULLs is written through the
JAX package's SQL layer; its rows are packed by the reference's and the
port's pack_ranges, and every plane, dictionary, scale, bound and group
code must agree. The TPC-H batch builder of the port must agree with
packing its own encoded rows.
"""

import random

import numpy as np
import pytest

from tidb_tpu.ops import columnar as rcol
from tidb_tpu.session import Session, new_store

from tidb_tpu_torch import carry, tpch
from tidb_tpu_torch.kv.memstore import MemStore
from tidb_tpu_torch.ops import columnar as pcol

from torch_parity import RecordingClient, table_pairs

SEEDS = [0, 1, 2]

_COLS = ("id bigint primary key, a int, u bigint unsigned, c double, "
         "m decimal(12,3), s varchar(20), d date, t datetime, du time")


def _value_sql(rng: random.Random, kind: str) -> str:
    if rng.random() < 0.15:
        return "null"
    if kind == "a":
        return str(rng.randrange(-1000, 1000))
    if kind == "u":
        return str(rng.randrange(0, 1 << 62))
    if kind == "c":
        return repr(rng.choice([0.0, -0.0, rng.uniform(-1e4, 1e4)]))
    if kind == "m":
        return f"{rng.randrange(-10**8, 10**8) / 1000:.3f}"
    if kind == "s":
        return "'" + "".join(rng.choice("xyzAB ") for _ in
                             range(rng.randrange(0, 6))) + "'"
    if kind == "d":
        return f"'{rng.randrange(1990, 2030)}-{rng.randrange(1, 13):02d}-" \
               f"{rng.randrange(1, 29):02d}'"
    if kind == "t":
        return f"'2020-01-{rng.randrange(1, 29):02d} " \
               f"{rng.randrange(24):02d}:{rng.randrange(60):02d}:00'"
    return f"'{rng.randrange(-800, 800)}:{rng.randrange(60):02d}:00'"


@pytest.fixture(scope="module")
def packed():
    """Per seed: (reference batch, port batch)."""
    out = {}
    for seed in SEEDS:
        rng = random.Random(seed)
        store = new_store(f"memory://torch_columnar_{seed}")
        s = Session(store)
        s.execute("create database d")
        s.execute("use d")
        s.execute("set global tidb_tpu_columnar_scan = 0")
        rec = RecordingClient(store, dispatch_floor_rows=0)
        store.set_client(rec)
        s.execute(f"create table t ({_COLS})")
        rows = []
        for i in range(1, 150):
            vals = [str(i)] + [_value_sql(rng, k) for k in
                               ("a", "u", "c", "m", "s", "d", "t", "du")]
            rows.append("(" + ", ".join(vals) + ")")
        s.execute("insert into t values " + ", ".join(rows))
        s.execute("select id from t where a > 0")
        req = rec.requests[-1]
        sel = req.data
        pairs = table_pairs(store, sel.start_ts, sel.table_info.table_id)
        snap = store.get_snapshot(sel.start_ts)
        ref = rcol.pack_ranges(snap, sel.table_info.table_id,
                               sel.table_info.columns, req.key_ranges)
        preq = carry.kv_request_from(req)
        port = pcol.pack_ranges(MemStore.from_pairs(pairs).get_snapshot(),
                                preq.data.table_info.table_id,
                                preq.data.table_info.columns,
                                preq.key_ranges)
        out[seed] = (ref, port)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_planes_equal(packed, seed):
    ref, port = packed[seed]
    assert (ref.n_rows, ref.capacity) == (port.n_rows, port.capacity)
    assert np.array_equal(ref.handles, port.handles)
    assert ref.max_handle == port.max_handle
    assert sorted(ref.columns) == sorted(port.columns)
    for cid, rc in ref.columns.items():
        pc = port.columns[cid]
        assert (rc.kind, rc.tp, rc.dec_scale, rc.max_abs) == \
            (pc.kind, pc.tp, pc.dec_scale, pc.max_abs), cid
        assert rc.values.dtype == pc.values.dtype, cid
        assert np.array_equal(rc.valid, pc.valid), cid
        # bit-equal values (−0.0 stays −0.0)
        assert np.array_equal(rc.values.view(np.int64),
                              pc.values.view(np.int64)), cid
        assert rc.dictionary == pc.dictionary, cid


@pytest.mark.parametrize("seed", SEEDS)
def test_group_codes_equal(packed, seed):
    ref, port = packed[seed]
    for cid, cd in ref.columns.items():
        if cd.kind == rcol.K_STR:
            continue
        rcodes, runiq = ref.group_codes(cid)
        pcodes, puniq = port.group_codes(cid)
        assert np.array_equal(rcodes, pcodes), cid
        assert np.array_equal(runiq, puniq), cid


def test_carry_batch_equal(packed):
    ref, port = packed[SEEDS[0]]
    carried = carry.batch_from(ref)
    for cid, pc in port.columns.items():
        cc = carried.columns[cid]
        assert np.array_equal(cc.values.view(np.int64),
                              pc.values.view(np.int64))
        assert np.array_equal(cc.valid, pc.valid)
        assert (cc.kind, cc.dictionary, cc.max_abs) == \
            (pc.kind, pc.dictionary, pc.max_abs)


@pytest.mark.parametrize("n_rows", [1, 700, 2500])
def test_tpch_batch_matches_packing(n_rows):
    data = tpch.generate(n_rows, seed=n_rows)
    store = MemStore.from_pairs(tpch.kv_pairs(data))
    cids = sorted(tpch.COLUMNS)
    cids.remove(tpch.C_COMMENT)
    req = tpch.store_request(tpch.q1())
    packed = pcol.pack_ranges(store.get_snapshot(), tpch.TABLE_ID,
                              tpch.table_info(cids).columns, req.key_ranges)
    built = tpch.batch(data, cids)
    assert (packed.n_rows, packed.capacity) == (built.n_rows, built.capacity)
    assert np.array_equal(packed.handles, built.handles)
    for cid in cids:
        a, b = packed.columns[cid], built.columns[cid]
        assert (a.kind, a.tp, a.dec_scale, a.max_abs, a.dictionary) == \
            (b.kind, b.tp, b.dec_scale, b.max_abs, b.dictionary), cid
        assert np.array_equal(a.values, b.values), cid
        assert np.array_equal(a.valid, b.valid), cid
