"""The mesh tier's pieces of the port held against the JAX package's on the
same numpy inputs, made from a seed.

- RegionPlacement over 10,000 region ids with epoch bumps, and
  _shard_layout: exactly equal.
- combine_states_sharded over int64 and f64 [R, G] states (the int64
  extremes, empty groups): exactly equal, at 1 and 8 shards (the
  reference's CoprMesh over conftest's virtual CPU devices, the port's
  over ["cpu"] * n).
- region_states_sharded with mixed G_r over the reductions the cluster
  path sends (counts, int sums, int and f64 extrema): exactly equal.
- K20's plain version against the reference's build_topn_partial_fn and
  build_topn_partial_fn_multi run per shard, on inputs outside the
  reference's faults: the same candidates and live counts.
- The merged mesh TopN (K20's plain version, then merge_topn_partials)
  against numpy's lexsort in the CPU engine's order and against K10's
  plain version over the whole batch, on inputs holding the reference's
  three mesh faults; the reference's merged rows are pinned where they
  differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import kernels as ref_kernels
from tidb_tpu.ops import mesh as ref_mesh
from tidb_tpu.parallel import CoprMesh as RefMesh

from torch_parity import port_identity  # (also: torch threads, GC freeze)
from tidb_tpu_torch import carry
from tidb_tpu_torch.ops import kernels, mesh
from tidb_tpu_torch.parallel import CoprMesh

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
SHARDS = (1, 8)


def _meshes(n: int):
    ref = RefMesh(n_devices=n)
    return ref, carry.mesh_from(ref)


def test_mesh_from_matches_the_reference():
    ref, port = _meshes(8)
    assert port.n == ref.n == 8 and port.device == torch.device("cpu")
    with pytest.raises(Exception, match="distinct devices"):
        CoprMesh(["cpu", "meta"])


def test_placement_equals_reference():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 1 << 40, 10_000).tolist()
    for n in SHARDS + (3,):
        ref, port = ref_mesh.RegionPlacement(n), mesh.RegionPlacement(n)
        assert port.shard_of(ids) == ref.shard_of(ids)
        bumped = ids[::7]
        epochs = [(2, int(e)) for e in rng.integers(0, 9, len(bumped))]
        assert port.shard_of(bumped, epochs) == \
            ref.shard_of(bumped, epochs)
        assert port.stats == {"placements": ref.placements,
                              "replacements": ref.replacements}
        assert port.stats["replacements"] > 0


def test_shard_layout_equals_reference():
    rng = np.random.default_rng(6)
    for n in SHARDS:
        sizes = rng.integers(0, 3000, 13)
        ends = np.cumsum(sizes)
        slices = list(zip((ends - sizes).tolist(), ends.tolist()))
        shard_of = rng.integers(0, n, 13).tolist()
        want = ref_mesh._shard_layout(slices, shard_of, n)
        got = mesh._shard_layout(slices, shard_of, n)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        assert got[2] == want[2]


def _states(rng, R: int, G: int) -> tuple:
    counts = rng.integers(0, 3, (R, G)).astype(np.int64)
    counts[:, 0] = 0                                  # an empty group
    ints = rng.integers(-1 << 40, 1 << 40, (R, G)).astype(np.int64)
    ints[rng.random((R, G)) < 0.1] = I64_MIN
    ints[rng.random((R, G)) < 0.1] = I64_MAX
    floats = rng.standard_normal((R, G)) * 1e6
    floats[rng.random((R, G)) < 0.1] = 0.0
    wrap = rng.integers(-1 << 62, 1 << 62, (R, G)).astype(np.int64)
    return ([counts, wrap, ints, ints, floats, floats],
            ["sum", "sum", "min", "max", "min", "max"])


@pytest.mark.parametrize("n", SHARDS)
def test_combine_states_sharded_equals_reference(n):
    rng = np.random.default_rng(7 + n)
    ref, port = _meshes(n)
    for R, G in ((5, 4), (13, 1), (2, 33)):
        states, ops = _states(rng, R, G)
        want = ref_mesh.combine_states_sharded(states, ops, ref)
        calls = dict(kernels.CALLS)
        got = mesh.combine_states_sharded(states, ops, port)
        # the shard fold; at one shard the single-device combine
        assert kernels.CALLS["mesh_allreduce"] == \
            calls["mesh_allreduce"] + (n > 1)
        assert kernels.CALLS["combine_region_partials"] == \
            calls["combine_region_partials"] + (n == 1)
        for g, w, st in zip(got, want, states):
            assert g.dtype == st.dtype and g.shape == (G,)
            assert np.array_equal(g.view(np.int64),
                                  np.asarray(w).astype(st.dtype)
                                  .view(np.int64)), (R, G)


def _region_segs(rng, Gs: list, cap: int = 256) -> list:
    """(gid_r, [(op, values, contrib)], G_r) per region; values numpy."""
    segs = []
    for G in Gs:
        n_live = int(rng.integers(0, cap))
        gid = np.full(cap, G, np.int64)
        gid[:n_live] = rng.integers(0, max(G, 1), n_live) if G else G
        live = gid < G
        iv = rng.integers(-1 << 50, 1 << 50, cap).astype(np.int64)
        iv[rng.random(cap) < 0.05] = I64_MIN
        fv = rng.standard_normal(cap) * 100
        ok = live & (rng.random(cap) > 0.2)
        segs.append((gid, [("sum", None, live), ("sum", iv, ok),
                           ("min", iv, ok), ("max", iv, ok),
                           ("min", fv, ok), ("max", fv, ok)], G))
    return segs


@pytest.mark.parametrize("n", SHARDS)
def test_region_states_sharded_equals_reference(n):
    rng = np.random.default_rng(11 + n)
    ref, port = _meshes(n)
    segs = _region_segs(rng, [3, 0, 17, 1, 40, 5, 8, 2, 9, 30])
    rids = [101, 7, 3, 55, 1000, 2, 9, 64, 12, 4]
    want = ref_mesh.region_states_sharded(ref, segs, region_ids=rids)
    port_segs = [(g, [(op, None if v is None else torch.from_numpy(v), ok)
                      for op, v, ok in sp], G, len(g)) for g, sp, G in segs]
    nd = mesh.stats["near_data_dispatches"]
    batched = kernels.CALLS["region_agg_states_batched"]
    got = mesh.region_states_sharded(port, port_segs, region_ids=rids)
    assert mesh.stats["near_data_dispatches"] == nd + 1
    # the shard layout; at one shard the batched K6 itself
    assert kernels.CALLS["region_agg_states_batched"] == batched + (n == 1)
    # the port's single-device batched K6, region by region
    single = kernels.region_agg_states_batched(port_segs, "cpu")
    for r, (g, s, w) in enumerate(zip(got, single, want)):
        for j, (a, b, c) in enumerate(zip(g, s, w)):
            c = np.asarray(port_identity(np.asarray(c).astype(a.dtype)))
            assert a.shape == (segs[r][2],)
            assert np.array_equal(a.view(np.int64), b.view(np.int64)), \
                (r, j)
            assert np.array_equal(a.view(np.int64), c.view(np.int64)), \
                (r, j)


# ---------------------------------------------------------------------------
# K20 and the merge
# ---------------------------------------------------------------------------

def _ref_shards(mask, keys: list, k: int, n: int) -> list:
    """The reference's per-shard top-k outputs: build_topn_partial_fn
    (one key) or _multi, run on each shard's planes."""
    L = len(mask) // n
    exprs = [(lambda p, j=j: (p[2 * j], p[2 * j + 1]), d)
             for j, (_kv, d) in enumerate(keys)]
    if len(keys) == 1:
        fn = ref_kernels.build_topn_partial_fn(None, exprs[0][0],
                                               exprs[0][1], k)
    else:
        fn = ref_kernels.build_topn_partial_fn_multi(None, exprs, k)
    parts = []
    for s in range(n):
        sl = slice(s * L, (s + 1) * L)
        planes = []
        for (v, ok), _d in keys:
            planes += [jnp.asarray(v[sl]), jnp.asarray(ok[sl])]
        parts.append([np.atleast_1d(np.asarray(o))
                      for o in fn(planes, jnp.asarray(mask[sl]))])
    return parts


def _ref_partial(mask, keys: list, k: int, n: int):
    """(idx [n, k], n_live [n]) of the reference's per-shard top-k."""
    parts = _ref_shards(mask, keys, k, n)
    live = 2 if len(keys) == 1 else 1
    return (np.stack([p[0] for p in parts]),
            np.concatenate([p[live] for p in parts]))


def _port_keys(keys: list) -> list:
    return [((torch.from_numpy(v), torch.from_numpy(ok)), d)
            for (v, ok), d in keys]


def _clean_keys(rng, n_rows: int, nk: int) -> list:
    """Keys outside the reference's faults: distinct values within 2^53,
    no NULL, no int64 extreme."""
    keys = []
    for j in range(nk):
        v = rng.permutation(n_rows).astype(np.int64) - n_rows // 2
        if j % 2:
            v = v.astype(np.float64) / 4
        keys.append(((v, np.ones(n_rows, bool)), bool(j % 2 == 0)))
    return keys


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("nk", [1, 3])
def test_k20_plain_equals_reference_partials(n, nk):
    rng = np.random.default_rng(20 + n + nk)
    n_rows = 8 * 96
    mask = rng.random(n_rows) > 0.3
    if n > 1:
        mask[:96] = False                          # an empty shard
    keys = _clean_keys(rng, n_rows, nk)
    for k in (1, 7, n_rows // n):
        want_idx, want_live = _ref_partial(mask, keys, k, n)
        idx, n_live, words, nulls = kernels.shard_topk(
            torch.from_numpy(mask), _port_keys(keys), k, n)
        assert idx.shape == (n, k) and words.shape == (n, nk, k)
        assert np.array_equal(n_live.numpy(), want_live)
        for s in range(n):
            m = want_live[s]
            assert np.array_equal(idx[s, :m].numpy(), want_idx[s, :m]), \
                (s, k)


def _cpu_engine_order(mask, keys: list) -> list:
    """Live rows in the CPU engine's ORDER BY order: per key NULL first
    ascending and last descending, values compared natively (reversed for
    DESC), then row position."""
    def key(i):
        out = []
        for (v, ok), desc in keys:
            null = not ok[i]
            val = 0 if null else v[i]
            if desc:
                out.append((null, -val if isinstance(val, float)
                            else _Rev(int(val))))
            else:
                out.append((not null, val))
        return out + [i]
    return sorted(np.flatnonzero(mask).tolist(), key=key)


class _Rev:
    """An int ordered backwards, without negation (which would overflow
    nothing in Python, but mirrors no engine either)."""

    def __init__(self, x):
        self.x = x

    def __lt__(self, o):
        return self.x > o.x

    def __eq__(self, o):
        return self.x == o.x


def _merged(mask, keys, limit: int, n: int):
    L = len(mask) // n
    k = min(limit, L)
    outs = kernels.shard_topk(torch.from_numpy(mask), _port_keys(keys), k, n)
    return kernels.merge_topn_partials(*[o.numpy() for o in outs], n, L,
                                       limit)


def _ref_merged(mask, keys, limit: int, n: int):
    """The reference's mesh TopN: per-shard partials, then its host merge
    on -score (one key) or on the shards' negated sort keys."""
    L = len(mask) // n
    parts = _ref_shards(mask, keys, min(limit, L), n)
    idx = np.concatenate([p[0] for p in parts])
    if len(keys) == 1:
        n_live = np.concatenate([p[2] for p in parts])
        merge_keys = [-np.concatenate([p[1] for p in parts])
                      .astype(np.float64)]
    else:
        n_live = np.concatenate([p[1] for p in parts])
        merge_keys = [np.concatenate([p[i] for p in parts])
                      for i in range(2, len(parts[0]))]
    return ref_kernels.merge_topn_partials(idx, n_live, merge_keys, n, L,
                                           limit)


@pytest.mark.parametrize("n", SHARDS)
def test_merged_topn_equals_cpu_engine_order(n):
    """Random keys with NULLs, ties across shard boundaries, int64
    extremes and -0.0: the merged mesh TopN is the CPU engine's order and
    K10's plain version over the whole batch, for every limit up to past
    the live rows."""
    rng = np.random.default_rng(30 + n)
    n_rows = 8 * 64
    mask = rng.random(n_rows) > 0.25
    a = rng.integers(-3, 4, n_rows).astype(np.int64)
    a[rng.random(n_rows) < 0.05] = I64_MIN
    a[rng.random(n_rows) < 0.05] = I64_MAX
    f = rng.integers(-2, 3, n_rows).astype(np.float64)
    f[rng.random(n_rows) < 0.1] = -0.0
    keys = [((a, rng.random(n_rows) > 0.1), True),
            ((f, rng.random(n_rows) > 0.2), False),
            ((a.copy(), np.ones(n_rows, bool)), False)]
    for nk in (1, 2, 3):
        ks = keys[:nk]
        order = _cpu_engine_order(mask, ks)
        for limit in (1, 5, 64, 200, n_rows):
            got = _merged(mask, ks, limit, n).tolist()
            assert got == order[:limit], (nk, limit)
            single, nl = kernels.topk_select(torch.from_numpy(mask),
                                             _port_keys(ks), limit)
            assert got == single[:int(nl)].tolist()


# the reference's mesh TopN faults: (mask, keys, limit) over two shards of
# 1024 rows, the CPU engine's rows and the reference's merged rows
def _fault_cases() -> dict:
    L = 1024
    n_rows = 2 * L
    none = np.zeros(n_rows, np.int64)
    valid = np.ones(n_rows, bool)
    # 1: BIGINT keys above 2^53 scored as one f64: the smaller key, in
    #    shard 0, ties the larger one in shard 1 and wins by index
    a = none.copy()
    a[5], a[L + 3] = 1 << 53, (1 << 53) + 1
    mask1 = np.zeros(n_rows, bool)
    mask1[[5, L + 3]] = True
    # 2: build_topn_partial_fn_multi negates int64 keys for DESC: -2^63
    #    wraps to itself and sorts first
    b = np.arange(n_rows, dtype=np.int64)
    b[L + 9] = I64_MIN
    # 3: a live NULL key under DESC and a dead row both score -inf: the
    #    dead row (lower index) is taken among the shard's live candidates
    c = np.zeros(n_rows, np.float64)
    c[2] = 3.0
    cvalid = valid.copy()
    cvalid[1] = False
    mask3 = np.zeros(n_rows, bool)
    mask3[[1, 2]] = True
    return {
        "f64 score above 2^53": (mask1, [((a, valid), True)], 1,
                                 [L + 3], [5]),
        "negated int64 minimum": (valid, [((b, valid), True),
                                          ((none, valid), False)], 2,
                                  [n_rows - 1, n_rows - 2], [L + 9,
                                                             n_rows - 1]),
        "NULL beside a dead row": (mask3, [((c, cvalid), True)], 2,
                                   [2, 1], [2, 0]),
    }


@pytest.mark.parametrize("case", sorted(_fault_cases()))
def test_reference_mesh_topn_faults(case):
    """The port's merged TopN gives the CPU engine's rows; the reference's
    mesh TopN gives the pinned wrong rows (ROADMAP.md Queue 3)."""
    mask, keys, limit, cpu_rows, ref_rows = _fault_cases()[case]
    assert _cpu_engine_order(mask, keys)[:limit] == cpu_rows
    assert _merged(mask, keys, limit, 2).tolist() == cpu_rows
    assert _ref_merged(mask, keys, limit, 2).tolist() == ref_rows


def test_k20_raises_outside_its_contract():
    from tidb_tpu_torch.errors import DeviceError
    mask = torch.ones(16, dtype=torch.bool)
    with pytest.raises(DeviceError, match="outside"):
        kernels.shard_topk(mask, [], 3, 8)          # k above the block
    with pytest.raises(DeviceError, match="shards"):
        kernels.shard_topk(mask, [], 1, 3)
    meta = torch.zeros(16, dtype=torch.bool, device="meta")
    with pytest.raises(DeviceError, match="no kernel for device"):
        kernels.shard_topk(meta, [], 1, 2)
