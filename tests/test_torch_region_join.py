"""Slice 10 as a whole: joins over a region cluster, held against the JAX
package's cluster store.

Reference side: Sessions on `new_store("cluster://3/...")` with the
tables of tests/test_region_fanout_columnar.py (split into 1, 2, 4 and 8
regions) and of tests/test_mesh_exec.py (4 regions, and its table holding
-2^63). Test-only wrappers record, per statement, the kv.Requests reaching
DistCoprClient.send, the HashJoinExec (plan, pairs, joined rows, region
slices, its left side), the rows fused_agg.try_fused_agg and
try_fused_final return and the Session's rows; nothing in tidb_tpu
changes. Each store is recorded once per module: the reference's JAX
compiles are most of this file's time.

Port side: the reference store's KV pairs and regions at the statement's
start_ts (carry.cluster_from) in a DistStore(device="cpu"); the recorded
scan requests through XSelectTableExec over its DistCoprClient (a plain
scan per region, one K1 each, stacked into a ColumnarPartialSet),
HashJoinExec and HashAggExec (carry.agg_from): pairs, joined rows and
fused rows must equal the reference's exactly (f64 bit for bit), and the
single-region port's. Over more than one region the fused aggregate
combines per-region partial states (the region combine): on the process
mesh (CoprMesh(["cpu"] * S), row 15f's plain versions) or, with the mesh
off, K6 + K7's plain versions on one device.

Also: row 15f (mesh.combine_rows_sharded) against the JAX
combine_rows_sharded on 8 CPU devices and numpy; ColumnarPartialSet's
planes against the reference's over the same region partials, with an
all-NULL region; the join's region slices on the one-pass and the
grace-hash pass routes; the f64 +-inf extremum identity on every
in-process route against numpy, and reference fault 6 (ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import test_mesh_exec as tme
import test_region_fanout_columnar as trf
from tidb_tpu import tablecodec as rtc
from tidb_tpu.cluster import store as rcs
from tidb_tpu.executor import executors as rex, fused_agg as rfused
from tidb_tpu.ops import kernels as rkernels, mesh as rmesh
from tidb_tpu.parallel import CoprMesh as RCoprMesh
from tidb_tpu.session import Session, new_store

from tidb_tpu_torch import carry, distsql
from tidb_tpu_torch.cluster.store import DistStore
from tidb_tpu_torch.executor import fused_agg
from tidb_tpu_torch.executor.distsql_exec import XSelectTableExec
from tidb_tpu_torch.executor.executors import HashJoinExec
from tidb_tpu_torch.ops import columnar as col, kernels, membudget
from tidb_tpu_torch.ops import mesh as mesh_mod
from tidb_tpu_torch.ops.exprc import Unsupported
from tidb_tpu_torch.parallel import CoprMesh

from torch_parity import F64_MAX, norm_datum, port_ledger, release  # noqa

I64_MIN = -(1 << 63)
FANOUT_REGIONS = (1, 2, 4, 8)
# the pushed TopN statements of test_region_fanout_columnar.QUERIES
TOPN = {5, 6}


@pytest.fixture(autouse=True)
def _port_mesh_reset():
    """Every test starts from the lazy default process mesh with the
    tier on (on a CPU rig: no mesh) and leaves it so."""
    mesh_mod.set_mesh(None)
    mesh_mod.set_enabled(True)
    yield
    mesh_mod.set_mesh(None)
    mesh_mod.set_enabled(True)


# ---------------------------------------------------------------------------
# recording the reference
# ---------------------------------------------------------------------------

class _Recorder:
    """Wraps the reference's DistCoprClient.send, HashJoinExec,
    try_fused_agg and try_fused_final and keeps what they saw."""

    def __init__(self, mp):
        self.sends, self.joins, self.fused, self.finals = [], [], [], []
        self.projections = []
        send = rcs.DistCoprClient.send
        o_proj = rex.ProjectionExec.next
        o_try = rex.HashJoinExec._try_vector_join
        o_fused = rfused.try_fused_agg
        o_final = rfused.try_fused_final

        def rec_send(client, req):
            self.sends.append(req)
            return send(client, req)

        def try_vector(ex):
            self.joins.append(ex)
            return o_try(ex)

        def fused(agg):
            out = o_fused(agg)
            self.fused.append((agg, out))
            return out

        def final(agg):
            out = o_final(agg)
            self.finals.append(out)
            return out

        def proj_next(ex):
            if ex not in self.projections:
                self.projections.append(ex)
            return o_proj(ex)

        mp.setattr(rex.ProjectionExec, "next", proj_next)
        mp.setattr(rcs.DistCoprClient, "send", rec_send)
        mp.setattr(rex.HashJoinExec, "_try_vector_join", try_vector)
        mp.setattr(rfused, "try_fused_agg", fused)
        mp.setattr(rfused, "try_fused_final", final)


def _record(s: Session, queries: list) -> list:
    """What the reference did for each statement over Session `s`."""
    out = []
    for sql in queries:
        with pytest.MonkeyPatch.context() as mp:
            r = _Recorder(mp)
            values = s.execute(sql)[0].values()
        rec = {"store": s.store, "sql": sql, "requests": list(r.sends),
               "values": values, "join": None, "agg": None,
               "fused": None, "final": r.finals[-1] if r.finals else None}
        if r.joins:
            ex = r.joins[-1]
            dj = ex._device
            rec.update(join=ex, l_idx=dj.l_idx.copy(), r_idx=dj.r_idx.copy(),
                       join_rows=list(dj.iter_rows()),
                       slices=dj.region_slices(), lside=dj.lside)
        if r.fused:
            rec["agg"], rec["fused"] = r.fused[-1]
            rec["projection"] = next(
                (p for p in r.projections
                 if p.children and p.children[0] is rec["agg"]), None)
        out.append(rec)
    return out


def _row_protocol(s: Session, recs: list) -> None:
    """Each statement's rows under the row protocol (the columnar scan
    off), as test_mesh_exec.py's _row_protocol reads them."""
    for rec, values in zip(recs, tme._row_protocol(
            s, [rec["sql"] for rec in recs])):
        rec["row_values"] = values


def _build_min_table() -> Session:
    """test_mesh_exec.py's test_exact_i64_min_survives_max table: group 1
    holds only -2^63, 4 regions."""
    store = new_store("cluster://3/torch_region_join_min")
    s = Session(store)
    s.execute("create database mn")
    s.execute("use mn")
    s.execute("create table t (id bigint primary key, k bigint, v bigint)")
    s.execute("insert into t values " + ", ".join(
        f"({i}, {i % 2}, {I64_MIN if i % 2 else i})" for i in range(1, 41)))
    s.execute("create table d (d_k bigint primary key)")
    s.execute("insert into d values (0), (1)")
    tid = s.info_schema().table_by_name("mn", "t").info.id
    store.cluster.split_keys(
        [rtc.encode_row_key(tid, 10 * i + 1) for i in range(1, 4)])
    return s


MIN_Q = ("select t.k, count(*), max(t.v), min(t.v) from t "
         "join d on t.k = d.d_k group by t.k order by t.k")


def _build_null_region() -> Session:
    """A 40-row table over 4 regions whose first region holds only NULLs
    in a, s and f, joined to a one-column table."""
    store = new_store("cluster://3/torch_region_join_nulls")
    s = Session(store)
    s.execute("create database nr")
    s.execute("use nr")
    s.execute("create table v (id bigint primary key, a bigint, "
              "s varchar(8), f double)")
    s.execute("insert into v values " + ", ".join(
        f"({i}, null, null, null)" if i <= 10 else
        f"({i}, {i % 5}, '{'xyz'[i % 3]}{i % 4}', {i}.5)"
        for i in range(1, 41)))
    s.execute("create table w (x bigint primary key)")
    s.execute("insert into w values " + ", ".join(f"({i})"
                                                  for i in range(0, 45, 3)))
    tid = s.info_schema().table_by_name("nr", "v").info.id
    store.cluster.split_keys(
        [rtc.encode_row_key(tid, 10 * i + 1) for i in range(1, 4)])
    return s


NULL_Q = "select v.id, v.a, v.s, v.f, w.x from v join w on v.id = w.x"


@pytest.fixture(scope="module")
def recorded():
    out = {}
    for n in FANOUT_REGIONS:
        out[("fanout", n)] = _record(trf._build(n), trf.QUERIES)
    for key, (s, queries) in {"mesh": (tme._build(4), tme.QUERIES),
                              "min": (_build_min_table(), [MIN_Q])}.items():
        out[key] = _record(s, queries)
        _row_protocol(s, out[key])
    out["nulls"] = _record(_build_null_region(), [NULL_Q])
    yield out
    release(out)


# ---------------------------------------------------------------------------
# replaying through the port
# ---------------------------------------------------------------------------

_port_stores: dict = {}


def _port_store(rec) -> DistStore:
    """The port's DistStore over the reference store's data and regions
    (one per reference store: its data does not change)."""
    key = id(rec["store"])
    if key not in _port_stores:
        pairs, splits = carry.cluster_from(
            rec["store"], rec["requests"][0].data.start_ts)
        _port_stores[key] = (rec["store"],
                             DistStore(pairs, splits, device="cpu"))
    return _port_stores[key][1]


def _port_join(rec) -> HashJoinExec:
    store = _port_store(rec)
    ex = rec["join"]
    reqs = {r.data.table_info.table_id: carry.kv_request_from(r)
            for r in rec["requests"]}
    kids = []
    for c in ex.children:
        req = reqs[c.scan_plan.table_info.id]
        kids.append(XSelectTableExec(store.get_client(), req.data,
                                     req.key_ranges))
    return HashJoinExec(kids[0], kids[1], carry.join_plan_from(ex.plan))


def _port_rows(rec) -> list:
    """The port's rows of one recorded statement: the fused aggregate's
    over a join, the joined rows, or a pushed aggregate's final rows."""
    if rec["join"] is not None:
        join = _port_join(rec)
        if rec["agg"] is not None:
            return carry.agg_from(rec["agg"], join).drain()
        return join.drain()
    (req,) = rec["requests"]
    kreq = carry.kv_request_from(req)
    res = distsql.select(_port_store(rec).get_client(), kreq).columnar()
    return fused_agg.final_states(kreq.data, res)


def _norm(rows: list) -> list:
    return [[norm_datum(int(d.kind), d.val) for d in row] for row in rows]


def _want(rec) -> list:
    if rec["join"] is None:
        return _norm(rec["final"])
    return _norm(rec["fused"] if rec["agg"] is not None
                 else rec["join_rows"])


def _values(rows: list) -> list:
    """Port rows as the Session's values() gives them."""
    return [[None if d.is_null() else
             (d.val.decode() if isinstance(d.val, bytes) else d.val)
             for d in row] for row in rows]


def _session_values(rec, rows: list) -> list:
    """The port's fused rows through the reference's projection above
    the aggregate (carried), in the statement's ORDER BY (its first output
    column in these statements), as values."""
    if rec.get("projection") is not None:
        rows = carry.projection_from(rec["projection"],
                                     carry.RowsExec(rows, 0)).drain()
    got = _values(rows)
    return sorted(got, key=lambda r: r[0]) if "order by" in rec["sql"] \
        else got


# ---------------------------------------------------------------------------
# test_region_fanout_columnar.py's QUERIES over 1, 2, 4 and 8 regions
# ---------------------------------------------------------------------------

FANOUT_CASES = [(n, i) for n in FANOUT_REGIONS
                for i in range(len(trf.QUERIES)) if i not in TOPN]


@pytest.mark.parametrize("n,stmt", FANOUT_CASES,
                         ids=[f"{n}-q{i}" for n, i in FANOUT_CASES])
def test_fanout_rows_equal_reference(recorded, n, stmt):
    rec = recorded[("fanout", n)][stmt]
    combines0 = fused_agg.stats["partial_combines"]
    mesh0 = fused_agg.stats["mesh_combines"]
    got = _port_rows(rec)
    assert _norm(got) == _want(rec), rec["sql"]
    # the single-region port answers the same rows
    assert _norm(got) == _norm(_port_rows(recorded[("fanout", 1)][stmt]))
    combined = rec["agg"] is not None and n > 1
    assert fused_agg.stats["partial_combines"] == combines0 + combined + (
        rec["join"] is None and n > 1)
    if combined:
        # no process mesh on a CPU rig: the single-device rung
        assert fused_agg.stats["mesh_combines"] == mesh0
        assert fused_agg.stats["last_combine_regions"] == n


@pytest.mark.parametrize("n", FANOUT_REGIONS)
@pytest.mark.parametrize("stmt", sorted(TOPN))
def test_pushed_topn_over_regions_raises(recorded, n, stmt):
    rec = recorded[("fanout", n)][stmt]
    (req,) = rec["requests"]
    kreq = carry.kv_request_from(req)
    with pytest.raises(Unsupported):
        distsql.select(_port_store(rec).get_client(), kreq).columnar()


def test_partial_combine_runs_device_side(recorded):
    """The fused aggregate over a 4-region join merges per-region partial
    states in one region combine (test_region_fanout_columnar.py's
    test of the same name), grouped or not."""
    for stmt in (0, 1):      # JOIN_AGG_Q, GROUPED_Q
        rec = recorded[("fanout", 4)][stmt]
        before = fused_agg.stats["partial_combines"]
        mesh0 = fused_agg.stats["mesh_combines"]
        got = _port_rows(rec)
        assert fused_agg.stats["partial_combines"] == before + 1
        assert fused_agg.stats["last_combine_regions"] >= 4
        # no process mesh on a CPU rig: the single-device rung
        assert fused_agg.stats["mesh_combines"] == mesh0
        assert _norm(got) == _norm(rec["fused"])
        assert _norm(got) == _norm(_port_rows(recorded[("fanout", 1)][stmt]))


def test_multi_region_scan_is_a_partial_set(recorded):
    """A hinted plain scan over 4 regions answers one ColumnarScanResult
    per region (one K1 call each on the card), stacked in task order with
    the regions' ids and epochs; the join's region slices are the
    reference's."""
    rec = recorded[("fanout", 4)][2]      # a join, no aggregate
    join = _port_join(rec)
    res = join.device_join_result()
    lside = res.lside
    assert isinstance(lside, col.ColumnarPartialSet) and len(lside.parts) == 4
    store = _port_store(rec)
    assert lside.region_ids() == [r.region_id
                                  for r in store.cluster.regions]
    assert all(e is not None for e in lside.region_epochs())
    assert lside.handles().tolist() == sorted(lside.handles().tolist())
    assert res.region_slices() == rec["slices"]
    assert res.region_ids() == lside.region_ids()


# ---------------------------------------------------------------------------
# test_mesh_exec.py's TestMeshParity
# ---------------------------------------------------------------------------

def _run_mesh(recs: list, shards) -> tuple:
    """The port's rows of every statement with the process mesh at
    `shards` CPU shards (None: the tier off), and the mesh combines it
    counted."""
    if shards is None:
        mesh_mod.set_enabled(False)
    else:
        mesh_mod.set_mesh(CoprMesh(["cpu"] * shards))
    mc0 = fused_agg.stats["mesh_combines"]
    rows = [_port_rows(rec) for rec in recs]
    return rows, fused_agg.stats["mesh_combines"] - mc0


def test_fanout_parity_at_1_and_8_shards_and_off(recorded):
    """The 4-region scan → join → aggregate statements over a 1-shard and
    an 8-shard mesh and with the mesh off: all three equal, equal to the
    reference's fused or final rows and, in order, to its Session's rows
    (row 15f, its one-shard case and the single-device rung)."""
    recs = recorded["mesh"]
    runs = {}
    for shards in (1, 8, None):
        rows, mc = _run_mesh(recs, shards)
        runs[shards] = rows
        if shards is None:
            assert mc == 0
        else:
            assert mc > 0 and fused_agg.stats["last_mesh_shards"] == shards
    for i, rec in enumerate(recs):
        for shards in (1, 8, None):
            assert _norm(runs[shards][i]) == _want(rec), (shards, rec["sql"])
        got = _session_values(rec, runs[8][i])
        assert got == [list(v) for v in rec["values"]], rec["sql"]
        assert got == [list(v) for v in rec["row_values"]], rec["sql"]


def test_float_sum_sequential_rounding_on_host(recorded):
    """Float SUM/AVG never enter the region combine: over 8 shards the
    answer is bit for bit the Session's (its row-order accumulation),
    while the counts of the same fusion combine on the mesh."""
    rec = recorded["mesh"][tme.QUERIES.index(tme.FLOAT_SUM_Q)]
    rows, mc = _run_mesh([rec], 8)
    assert mc == 1
    got = _session_values(rec, rows[0])

    def hexed(rs):
        return [[x.hex() if isinstance(x, float) else x for x in r]
                for r in rs]

    assert hexed(got) == hexed(rec["row_values"]) == hexed(rec["values"])


def test_exact_i64_min_survives_max(recorded):
    """MAX over a group holding only -2^63 answers -2^63 on the 8-shard
    mesh: the int64 max identity is exactly I64_MIN."""
    rec = recorded["min"][0]
    rows, mc = _run_mesh([rec], 8)
    assert mc == 1
    assert _norm(rows[0]) == _want(rec)
    got = _session_values(rec, rows[0])
    assert got == [list(v) for v in rec["row_values"]]
    assert [r for r in got if r[0] == 1][0][2] == I64_MIN


# ---------------------------------------------------------------------------
# row 15f: combine_rows_sharded against the JAX function and numpy
# ---------------------------------------------------------------------------

def _row_specs(seed: int) -> tuple:
    """(specs, gid, G, slices, region ids) of one fusion over 6 regions:
    sums, minima and maxima over int64 and f64 rows, counts; empty groups,
    a group holding only -2^63, groups of only +inf and of only -inf."""
    rng = np.random.default_rng(seed)
    lens = [37, 0, 211, 5, 96, 140]
    n, G = sum(lens), 23
    gid = rng.integers(0, G - 3, n).astype(np.int64)   # G-3.. G-1 empty
    iv = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    fv = rng.integers(-800, 800, n) * 0.25
    ok = rng.random(n) > 0.15
    gid[gid == 3] = 4                                   # group 3: -2^63
    gid[:3], iv[:3] = 3, I64_MIN
    gid[gid == 5], gid[gid == 6] = 7, 7                 # 5: +inf, 6: -inf
    gid[3:9] = [5, 5, 5, 6, 6, 6]
    fv[3:9] = [np.inf] * 3 + [-np.inf] * 3
    ok[:9] = True
    specs = [("sum", None, ok), ("sum", iv, ok), ("min", iv, ok),
             ("max", iv, ok), ("min", fv, ok), ("max", fv, ok),
             ("sum", None, np.ones(n, bool))]
    cuts = np.concatenate([[0], np.cumsum(lens)])
    slices = [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]
    return specs, gid, G, slices, [11, 3, 250, 7, 64, 1000]


def _numpy_states(specs, gid, G) -> list:
    out = []
    for op, vals, ok in specs:
        if vals is None:
            out.append(np.bincount(gid[ok], minlength=G).astype(np.int64))
            continue
        f = vals.dtype == np.float64
        if op == "sum":
            acc = np.zeros(G, vals.dtype)
            np.add.at(acc, gid[ok], vals[ok])
        elif op == "min":
            acc = np.full(G, np.inf if f else (1 << 63) - 1, vals.dtype)
            np.minimum.at(acc, gid[ok], vals[ok])
        else:
            acc = np.full(G, -np.inf if f else I64_MIN, vals.dtype)
            np.maximum.at(acc, gid[ok], vals[ok])
        out.append(acc)
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.astype(np.int64)


@pytest.mark.parametrize("shards", [1, 8])
def test_combine_rows_sharded_plain_equals_reference(shards):
    """Row 15f's plain version (the shard layout, seg_states_ragged_plain,
    combine_partials_plain) equals the JAX combine_rows_sharded bit for
    bit, and numpy, wherever a group holds a value other than only +-inf:
    there the port gives numpy's +-inf and the reference +-F64_MAX on its
    mesh rung (reference fault 6)."""
    specs, gid, G, slices, rids = _row_specs(41)
    want = _numpy_states(specs, gid, G)
    ref = rmesh.combine_rows_sharded(RCoprMesh(n_devices=shards), specs,
                                     gid, G, slices, rids)
    calls = dict(kernels.CALLS)
    got = mesh_mod.combine_rows_sharded(CoprMesh(["cpu"] * shards), specs,
                                        gid, G, slices, rids)
    assert kernels.CALLS["mesh_allreduce"] == \
        calls["mesh_allreduce"] + (shards > 1)
    counts = want[0]
    assert counts[G - 3:].tolist() == [0, 0, 0]
    assert (want[3][3], want[4][5], want[5][6]) == (I64_MIN, np.inf,
                                                    -np.inf)
    for j, (g, w, r) in enumerate(zip(got, want, ref)):
        g, r = np.asarray(g), np.asarray(r)
        assert g.dtype == w.dtype and g.shape == (G,), j
        live = counts > 0
        assert np.array_equal(_bits(g)[live], _bits(w)[live]), j
        if w.dtype == np.float64 and j in (4, 5):
            inf_group = 5 if j == 4 else 6
            keep = live.copy()
            keep[inf_group] = False
            assert np.array_equal(_bits(r)[keep], _bits(w)[keep]), j
            # reference fault 6: its identity beats the group's +-inf
            assert r[inf_group] == (F64_MAX if j == 4 else -F64_MAX)
            assert g[inf_group] == w[inf_group]
        else:
            assert np.array_equal(_bits(r)[live], _bits(w)[live]), j
    # empty groups hold the port's identities; their counts make them NULL
    assert np.all(got[4][G - 3:] == np.inf) and \
        np.all(got[5][G - 3:] == -np.inf)


def test_single_device_rung_equals_numpy():
    """The single-device rung (one K6 span over every region's rows, as
    its plain version) gives numpy's states, +-inf groups included, and
    equals the 8-shard route bit for bit."""
    specs, gid, G, slices, rids = _row_specs(43)
    got = kernels.rows_states(specs, gid, G, "cpu")
    sharded = mesh_mod.combine_rows_sharded(CoprMesh(["cpu"] * 8), specs,
                                            gid, G, slices, rids)
    for g, h in zip(got, sharded):
        assert np.array_equal(_bits(g), _bits(h))
    live = _numpy_states(specs, gid, G)[0] > 0
    for g, w in zip(got, _numpy_states(specs, gid, G)):
        assert np.array_equal(_bits(g)[live], _bits(w)[live])


def test_placement_and_layout_match_reference():
    """The port places the fusion's regions on the reference's shards."""
    _specs, _gid, _G, slices, rids = _row_specs(5)
    ref = rmesh.placement_for(RCoprMesh(n_devices=8)).shard_of(rids)
    port = mesh_mod.placement_for(CoprMesh(["cpu"] * 8)).shard_of(rids)
    assert port == ref
    ri, rl, rp = rmesh._shard_layout(slices, ref, 8)
    pi, pl, pp = mesh_mod._shard_layout(slices, port, 8)
    assert np.array_equal(ri, pi) and np.array_equal(rl, pl) and rp == pp


# ---------------------------------------------------------------------------
# ColumnarPartialSet against the reference's, and the join's region slices
# ---------------------------------------------------------------------------

def _carried_set(ref_set) -> col.ColumnarPartialSet:
    parts = []
    for p in ref_set.parts:
        side = carry.side_from(p)
        side.region_id, side.region_epoch = p.region_id, p.region_epoch
        parts.append(side)
    return col.ColumnarPartialSet(parts)


def _same_plane(a, b) -> None:
    assert a[0] == b[0]
    if a[0] is None:
        return
    assert np.array_equal(a[2], b[2])
    va, vb = np.asarray(a[1])[a[2]], np.asarray(b[1])[b[2]]
    if a[0] == "str":
        assert va.tolist() == vb.tolist()
    else:
        assert va.dtype == vb.dtype and np.array_equal(_bits(va), _bits(vb))


@pytest.mark.parametrize("which", ["nulls", "fanout"])
def test_partial_set_planes_equal_reference(recorded, which):
    """column_plane, dict_code_plane (as bytes) and region_slices of the
    port's ColumnarPartialSet over the reference's region partials, and
    over the port's own scan of the same regions, equal the reference's;
    the first region of the "nulls" table is all NULL in a, s and f (a
    vacuous plane coerced to the others' kind)."""
    rec = recorded["nulls"][0] if which == "nulls" \
        else recorded[("fanout", 8)][2]
    ref_set = rec["lside"]
    assert type(ref_set).__name__ == "ColumnarPartialSet"
    own = _port_join(rec).device_join_result().lside
    for port_set in (_carried_set(ref_set), own):
        assert port_set.region_slices() == ref_set.region_slices()
        assert port_set.region_ids() == ref_set.region_ids()
        assert port_set.handles().tolist() == ref_set.handles().tolist()
        for j in range(len(ref_set.pb_cols)):
            _same_plane(port_set.column_plane(j), ref_set.column_plane(j))
            rd, pd = ref_set.dict_code_plane(j), port_set.dict_code_plane(j)
            assert (rd is None) == (pd is None), j
            if rd is not None:
                for (codes, valid, dom), (rc, rv, rdom) in [(pd, rd)]:
                    assert np.array_equal(valid, rv)
                    assert [dom.entries[c] for c in codes[valid]] == \
                        [rdom.entries[c] for c in rc[rv]]
                    assert sorted(dom.entries) == dom.entries
    if which == "nulls":
        first = own.parts[0]
        assert not first.column_plane(3)[2].any()
        assert own.column_plane(3)[0] == "f64"
        assert own.column_plane(2)[0] == "str"


def test_join_region_slices_on_the_pass_route(recorded):
    """Over the headroom the join runs grace-hash passes, whose pairs
    merge stably by left row: l_idx stays non-decreasing, so the region
    slices and the fused rows are the one-pass join's."""
    rec = recorded[("fanout", 8)][0]              # JOIN_AGG_Q
    one = _port_join(rec)
    want_slices = one.device_join_result().region_slices()
    want_rows = _norm(carry.agg_from(rec["agg"], one).drain())
    membudget.set_budget(1024)
    try:
        join = _port_join(rec)
        res = join.device_join_result()
        assert join.join_stats.get("partitioned") and \
            join.join_stats["passes"] >= 2
        assert np.all(np.diff(res.l_idx) >= 0)
        assert res.region_slices() == want_slices == rec["slices"]
        assert _norm(carry.agg_from(rec["agg"], join).drain()) == want_rows
    finally:
        membudget.set_budget(0)


# ---------------------------------------------------------------------------
# the f64 +-inf extremum identity on the in-process routes
# ---------------------------------------------------------------------------

def _inf_reductions() -> tuple:
    """(gid, mask, f64 values): group 0 holds only +inf, group 1 only
    -inf, group 2 nothing, the rest ordinary values."""
    rng = np.random.default_rng(53)
    n = 600
    gid = rng.integers(3, 90, n).astype(np.int64)
    f = rng.integers(-80, 80, n) * 0.5
    gid[:6] = [0, 0, 0, 1, 1, 1]
    f[:6] = [np.inf] * 3 + [-np.inf] * 3
    mask = np.ones(n, bool)
    return gid, mask, f


@pytest.mark.parametrize("segments", [4, 90])
def test_seg_routes_answer_infinities(segments):
    """The plain versions of K3 (S <= 64) and K4 (S > 64) answer +inf /
    -inf for a group of only +inf (MIN) / -inf (MAX), as numpy does; K2
    over one such group too."""
    gid, mask, f = _inf_reductions()
    if segments == 4:
        keep = gid < 4
        gid, mask, f = gid[keep], mask[keep], f[keep]
    vals = torch.from_numpy(f)
    reds = [kernels.Red(kernels.R_MIN_F, vals),
            kernels.Red(kernels.R_MAX_F, vals)]
    route = kernels.seg_agg_onehot if segments <= \
        kernels.ONEHOT_SEGMENTS_MAX else kernels.seg_agg_sorted
    # CPU tensors: the wrapper runs its plain version
    n, acc = route(torch.from_numpy(gid), torch.from_numpy(mask), segments,
                   reds)
    mn = acc[0].view(torch.float64).numpy()
    mx = acc[1].view(torch.float64).numpy()
    assert (mn[0], mx[1]) == (np.inf, -np.inf)
    assert (mn[2], mx[2]) == (np.inf, -np.inf)      # empty: identities
    assert n[0][2] == 0
    for g in range(3, segments):
        sel = f[gid == g]
        if len(sel):
            assert (mn[g], mx[g]) == (sel.min(), sel.max())
    for g, want in ((0, np.inf), (1, -np.inf)):
        only = torch.from_numpy(mask & (gid == g))
        _n, a = kernels.scalar_agg(only, reds)
        got = a.view(torch.float64).numpy()
        assert got[0 if g == 0 else 1] == want


def test_k6_and_k7_answer_infinities():
    """K6's plain version in one launch over two regions and K7's fold
    over them answer numpy's +-inf."""
    gid, _mask, f = _inf_reductions()
    G = 90
    ok = np.ones(len(gid), bool)
    half = len(gid) // 2
    segs = [(gid[:half].copy(), [("min", torch.from_numpy(f[:half].copy()),
                                  ok[:half]),
                                 ("max", torch.from_numpy(f[:half].copy()),
                                  ok[:half])], G, half),
            (gid[half:].copy(), [("min", torch.from_numpy(f[half:].copy()),
                                  ok[half:]),
                                 ("max", torch.from_numpy(f[half:].copy()),
                                  ok[half:])], G, len(gid) - half)]
    outs = kernels.region_agg_states_batched(segs, "cpu")
    assert (outs[0][0][0], outs[0][1][1]) == (np.inf, -np.inf)
    mins = np.stack([o[0] for o in outs])
    maxs = np.stack([o[1] for o in outs])
    folded = kernels.combine_region_partials([mins, maxs], ["min", "max"],
                                             "cpu")
    assert (folded[0][0], folded[1][1]) == (np.inf, -np.inf)
    assert (folded[0][2], folded[1][2]) == (np.inf, -np.inf)


def test_reference_fault_6_one_hot_route():
    """Reference fault 6 (ROADMAP Queue 3): the JAX one-hot route (at 4
    groups) answers +-F64_MAX for MIN over only +inf / MAX over only
    -inf; the port's states answer +-inf, as numpy and the CPU engine
    do."""
    gid, _mask, f = _inf_reductions()
    keep = gid < 4
    gid, f = gid[keep].copy(), f[keep].copy()
    G = 4
    ok = np.ones(len(gid), bool)
    ref = rkernels.region_agg_states_batched(
        [(gid, [("min", f, ok), ("max", f, ok)], G)])[0]
    assert (ref[0][0], ref[1][1]) == (F64_MAX, -F64_MAX)
    port = kernels.region_agg_states_batched(
        [(gid, [("min", torch.from_numpy(f), ok),
                ("max", torch.from_numpy(f), ok)], G, len(gid))], "cpu")[0]
    assert (port[0][0], port[1][1]) == (np.inf, -np.inf)
    assert (f[gid == 0].min(), f[gid == 1].max()) == (np.inf, -np.inf)


def test_slot_agg_plain_answers_infinities():
    """K15's plain version (the micro-batch tier's per-slot reductions):
    a slot whose WHERE keeps only +inf rows answers MIN +inf, one that
    keeps only -inf rows MAX -inf, one that keeps nothing the identities
    with count 0."""
    from tidb_tpu_torch.copr.proto import expr_column, expr_op, expr_value
    from tidb_tpu_torch.ops import sched
    from tidb_tpu_torch.sqlast.opcode import Op
    from tidb_tpu_torch.types.datum import Datum

    n, cap = 40, 1024
    a = np.zeros(cap, np.int64)
    a[:n] = np.arange(n) % 4
    f = np.zeros(cap)
    f[:n] = np.where(a[:n] == 0, np.inf, np.where(a[:n] == 1, -np.inf,
                                                   np.arange(n) * 0.5))
    valid = np.zeros(cap, bool)
    valid[:n] = True
    batch = carry.batch_from_planes(n, cap, np.arange(1, cap + 1), {
        1: {"values": a, "valid": valid, "kind": col.K_I64},
        2: {"values": f, "valid": valid, "kind": col.K_F64}})
    fin, pools = None, []
    for x in (0, 1, 9):
        lw = sched._Lowerer(batch)
        emit, _sig = lw.lower(expr_op(Op.EQ, expr_column(1),
                                      expr_value(Datum.i64(x))))
        fin = lw.program(batch, emit)
        pools.append(fin.pool)
    cpu = torch.device("cpu")
    planes = kernels.batch_planes(batch, cpu)
    fv = planes[2][0]
    reds = [kernels.Red(kernels.R_MIN_F, fv), kernels.Red(kernels.R_MAX_F,
                                                          fv)]
    cnt, acc = kernels.slot_agg_plain(
        fin, torch.from_numpy(np.stack(pools)),
        [planes[key][w] for key, w in fin.plane_keys],
        kernels.device_live(batch, cpu), reds)
    got = acc.view(torch.float64).numpy()
    assert cnt[:, 0].tolist() == [10, 10, 0]
    assert (got[0, 0], got[1, 1]) == (np.inf, -np.inf)
    assert (got[2, 0], got[2, 1]) == (np.inf, -np.inf)
