"""Join-domain unification: the dictionary key tier of the device join
(copy of the join-key half of tidb_tpu/copr/dictionary.py: DictBail,
LocalDomain :152, unify_domains :305, KeySpec :330, _norm_f64, _str_specs
:354, build_join_specs :406, host_keys :455).

A string or multi-column equi-join joins on one int64 per row: each key
column pair maps both sides into ONE shared integer domain — batch-local
string dictionaries through a remap onto their sorted union, numeric
columns through the sorted value domain of both sides — and the
composite key is the mixed-radix key-tuple code over the per-column
domains. The codes feed the join kernels (K11, K12) unchanged; K13
(ops.kernels.dict_remap) builds them on the device, and host_keys is the
same integer arithmetic on the host.

The versioned per-store GlobalDict registry of the reference is not
ported: it changes the codes, not the answers. Every domain here is a
batch-local sorted dictionary (LocalDomain). Metrics are not ported.
"""

from __future__ import annotations

import numpy as np

# the reference's SYSVAR_DEFAULTS["tidb_tpu_dict_max_ndv"]
DEFAULT_MAX_NDV_RATIO = 0.5

# columns whose distinct count sits under this never trip the NDV ratio
# gate: tiny batches make any ratio meaningless
NDV_RATIO_FLOOR = 64

# composite key-tuple codes must fit int64 with headroom
RADIX_LIMIT = 1 << 62


class DictBail(Exception):
    """Join shape outside the dictionary tier. `counted` marks the reasons
    the reference accounts on copr.degraded_dict (high NDV, radix
    overflow)."""

    def __init__(self, reason: str, counted: bool = False):
        super().__init__(reason)
        self.counted = counted


class LocalDomain:
    """A batch-local SORTED dictionary in the domain protocol: codes are
    already rank-ordered, so ranks() is the identity."""

    __slots__ = ("entries",)

    def __init__(self, entries: list[bytes]):
        self.entries = entries

    def __len__(self) -> int:
        return len(self.entries)

    def ranks(self) -> np.ndarray:
        return np.arange(len(self.entries), dtype=np.int64)


def unify_domains(doms: list):
    """One shared byte domain over several dictionaries: (union entries
    sorted, [remap int64[len(dom_i)] per dom])."""
    union = sorted(set().union(*(d.entries for d in doms)))
    pos = {b: i for i, b in enumerate(union)}
    remaps = [np.fromiter((pos[b] for b in d.entries), dtype=np.int64,
                          count=len(d)) for d in doms]
    return union, remaps


class KeySpec:
    """One join key column lowered to its shared-domain pieces, one per
    SIDE: `mode` is "codes" (values already domain codes, -1 = NULL),
    "remap" (batch-local codes through `table`, an int64 local→domain
    map) or "domain" (raw i64/f64 values through `table`, the sorted
    per-query value domain, via searchsorted). `size` is the domain
    cardinality; build_join_specs assigns `stride`."""

    __slots__ = ("mode", "values", "valid", "table", "size", "stride")

    def __init__(self, mode: str, values, valid, table, size: int):
        self.mode = mode
        self.values = values
        self.valid = valid
        self.table = table
        self.size = size
        self.stride = 1


def _norm_f64(vals: np.ndarray) -> np.ndarray:
    # -0.0 joins/groups with +0.0 (the codec key normalizes it)
    return np.where(vals == 0.0, 0.0, vals)


def _str_specs(lside, rside, lj: int, rj: int, n_rows: int,
               max_ndv_ratio: float):
    """Shared-domain specs for one STRING key column pair: two dictionary
    code planes unify through a remap onto their sorted union; a side
    without one (drained rows) falls back to a per-query union over the
    emitted bytes planes. High NDV bails."""
    lcp = getattr(lside, "dict_code_plane", None)
    rcp = getattr(rside, "dict_code_plane", None)
    lent = lcp(lj) if lcp is not None else None
    rent = rcp(rj) if rcp is not None else None
    if lent is not None and rent is not None:
        lcodes, lvalid, ldom = lent
        rcodes, rvalid, rdom = rent
        if len(ldom) + len(rdom) > \
                max(2 * NDV_RATIO_FLOOR, max_ndv_ratio * max(n_rows, 1) * 2):
            raise DictBail("string NDV above tidb_tpu_dict_max_ndv",
                           counted=True)
        if ldom is rdom:
            size = len(ldom)
            return (KeySpec("codes", lcodes, lvalid, None, size),
                    KeySpec("codes", rcodes, rvalid, None, size))
        _union, (lmap, rmap) = unify_domains([ldom, rdom])
        size = len(_union)
        return (KeySpec("remap", lcodes, lvalid, lmap, size),
                KeySpec("remap", rcodes, rvalid, rmap, size))
    # bytes-union fallback: the object planes carry the same emitted bytes
    # the row engine's codec keys encode
    lkind, lvals, lvalid = lside.column_plane(lj)
    rkind, rvals, rvalid = rside.column_plane(rj)
    if lkind != "str" or rkind != "str":
        return None     # vacuous/mismatched side: never-match (caller)
    luniq = {v for v, ok in zip(lvals.tolist(), lvalid.tolist()) if ok}
    runiq = {v for v, ok in zip(rvals.tolist(), rvalid.tolist()) if ok}
    union = sorted(luniq | runiq)
    if len(union) > NDV_RATIO_FLOOR and \
            len(union) > max_ndv_ratio * max(n_rows, 1):
        raise DictBail("string NDV above tidb_tpu_dict_max_ndv",
                       counted=True)
    pos = {b: i for i, b in enumerate(union)}

    def codes_of(vals, valid):
        return np.fromiter(
            (pos[v] if ok else -1
             for v, ok in zip(vals.tolist(), valid.tolist())),
            dtype=np.int64, count=len(vals))

    size = len(union)
    return (KeySpec("codes", codes_of(lvals, lvalid), lvalid, None, size),
            KeySpec("codes", codes_of(rvals, rvalid), rvalid, None, size))


def build_join_specs(lside, rside, pairs, max_ndv_ratio: float):
    """Lower every eq-condition column pair (left index, right index, is
    string) into shared-domain KeySpecs: (l_specs, r_specs) with strides
    assigned, or None when some pair can NEVER match (cross-kind sides:
    the caller emits the empty/outer-padded result). Raises DictBail for
    shapes the tier does not take."""
    n_rows = len(lside) + len(rside)
    l_specs: list[KeySpec] = []
    r_specs: list[KeySpec] = []
    for lj, rj, is_str in pairs:
        if is_str:
            ent = _str_specs(lside, rside, lj, rj, n_rows, max_ndv_ratio)
            if ent is None:
                return None     # vacuous side: no matches possible
            ls, rs = ent
        else:
            lkind, lvals, lvalid = lside.column_plane(lj)
            rkind, rvals, rvalid = rside.column_plane(rj)
            if lkind not in ("i64", "f64") or rkind not in ("i64", "f64"):
                raise DictBail(f"no plane mapping for key pair "
                               f"({lkind}, {rkind})")
            if lkind != rkind:
                # int side vs float side never match under the row
                # engine's codec keys (i64(5) != f64(5.0))
                return None
            if lkind == "f64":
                lvals, rvals = _norm_f64(lvals), _norm_f64(rvals)
            dom = np.unique(np.concatenate([lvals[lvalid], rvals[rvalid]]))
            size = len(dom)
            ls = KeySpec("domain", lvals, lvalid, dom, size)
            rs = KeySpec("domain", rvals, rvalid, dom, size)
        l_specs.append(ls)
        r_specs.append(rs)
    # mixed-radix strides, least-significant last
    prod = 1
    for s in l_specs:
        prod *= max(s.size, 1)
        if prod >= RADIX_LIMIT:
            raise DictBail("key-tuple radix exceeds int64", counted=True)
    stride = 1
    for ls, rs in zip(reversed(l_specs), reversed(r_specs)):
        ls.stride = rs.stride = stride
        stride *= max(ls.size, 1)
    return l_specs, r_specs


def host_keys(specs: list[KeySpec], n: int):
    """Composite key-tuple codes on the HOST: (key int64[n], valid
    bool[n]), the integer arithmetic of K13 (ops.kernels.dict_remap_plain
    runs it on tensors)."""
    key = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for s in specs:
        if s.mode == "codes":
            codes = np.clip(s.values, 0, max(s.size - 1, 0))
        elif s.mode == "remap":
            codes = s.table[np.clip(s.values, 0, len(s.table) - 1)] \
                if len(s.table) else np.zeros(n, dtype=np.int64)
        else:
            codes = np.searchsorted(s.table, s.values).astype(np.int64)
            np.clip(codes, 0, max(s.size - 1, 0), out=codes)
        key += codes * s.stride
        valid &= s.valid
    return key, valid
