"""K6's segment windows against its sorted route on one card: the
readings K6_MAX_WINDOWS (tidb_tpu_torch/ops/kernels.py) is set from.

    python3 k6_window_sweep.py [--seed N]

Builds SF1's lineitem over 8 regions (tpch.generate), admits chip_smoke's
d_supplier and d_part statements into a DistStore and captures the K6
arguments of each. Then, for each shape below and each count of windows
a region in WINDOWS, it spreads the group ids uniformly over as many
groups a region as that count of windows holds (rows past a region's row
count in its sink) and runs K6 on its window route and on its sorted
route (kernels._k6_on_route, whichever route k6_route would take): the
two equal on every reduction but an f64 sum, each timed as the median of
20 CUDA-event runs of its launch (chip_smoke.cuda_ms). The shapes:

- d_supplier's planes: 8 reductions over 6,001,215 rows (and its own
  group ids first);
- the same planes cut to the first quarter of each region's rows (its
  capacity cut too, so that no padding row is left);
- d_part's planes (and its own group ids first);
- d_supplier's first two reductions.

Prints one line a reading, for each shape the most windows a region at
which the windows still beat the sorted route by RATIO, and, last, the
card's name and power limit. It needs one card and imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import sys

WINDOWS = (3, 6, 9, 12, 16, 20, 24, 32)
RATIO = 1.2


def first_rows(k6: tuple, part: int) -> tuple:
    """K6 arguments over the first n_r // part rows of each region r, the
    regions' capacities cut to them."""
    import torch

    from tidb_tpu_torch.ops import kernels

    gid, caps, n_rows, Gs, reds, contribs = k6
    keep = [n // part for n in n_rows]
    base = [sum(caps[:r]) for r in range(len(caps))]
    idx = torch.cat([torch.arange(b, b + m, device=gid.device)
                     for b, m in zip(base, keep)])
    cut = lambda t, m: None if t is None else t[:m]  # noqa: E731
    return (gid[idx], keep, keep, Gs,
            [[kernels.StatesInput(si.op, si.contrib, cut(si.values, m),
                                  cut(si.valid, m)) for si in rr]
             for rr, m in zip(reds, keep)],
            [c[idx] for c in contribs])


def shapes(k6_sup: tuple, k6_part: tuple) -> list:
    """[(name, K6 arguments, own ids first)] of the sweep."""
    gid, caps, n_rows, Gs, reds, contribs = k6_sup
    return [
        ("d_supplier", k6_sup, True),
        ("d_supplier, a quarter of the rows", first_rows(k6_sup, 4), False),
        ("d_part", k6_part, True),
        ("d_supplier, two reductions",
         (gid, caps, n_rows, Gs, [rr[:2] for rr in reds], contribs[:2]),
         False),
    ]


def sweep(name: str, k6: tuple, own: bool, lim: int, seed: int) -> list:
    import torch

    import chip_smoke as cs
    from tidb_tpu_torch.ops import kernels

    gid, caps, n_rows, Gs, reds, contribs = k6
    dev = gid.device
    n_red = len(contribs)
    n_f = sum(r.op in kernels.F_OPS for r in reds[0])
    span = max((lim - kernels.k6_block_bytes(n_red, n_f, 0, rows))
               // (8 * n_red) for rows in kernels.K6B_ROWS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    live = torch.cat([torch.arange(c, device=dev) < n
                      for c, n in zip(caps, n_rows)])
    readings = []
    for w in ((None,) if own else ()) + WINDOWS:
        if w is None:
            a = k6
        else:
            G = w * span - 1
            g = torch.randint(0, G, gid.shape, generator=gen, device=dev)
            a = (torch.where(live, g, G), caps, n_rows, [G] * len(caps),
                 reds, contribs)
        fit = kernels.k6_windows(n_red, n_f, [x + 1 for x in a[3]], lim)
        win = kernels._k6_on_route("seg_states_ragged_window", *a)
        srt = kernels._k6_on_route("seg_states_ragged_sorted", *a)
        win[0]()
        srt[0]()
        for j, r in enumerate(reds[0]):
            if r.op != kernels.R_SUM_F:
                cs.need(torch.equal(win[1][j], srt[1][j]),
                        f"{name} at {max(a[3])} groups: reduction {j} "
                        f"differs between the routes")
        tw, ts = cs.cuda_ms(win[0]), cs.cuda_ms(srt[0])
        readings.append((fit[1], tw, ts))
        print(f"{name}: {n_red} reductions, {sum(n_rows)} rows, "
              f"{max(a[3])} groups a region{' (its own)' if w is None else ''}"
              f", {fit[1]} windows a region ({fit[0]} rows a thread): "
              f"windows {tw:.4f} ms, sorted route {ts:.4f} ms, "
              f"sorted / windows {ts / tw:.3f}", flush=True)
    return readings


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("k6_window_sweep: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tidb_tpu_torch import tpch
    from tidb_tpu_torch.cluster.store import DistStore
    from tidb_tpu_torch.copr.plane_cache import PlaneCache
    from tidb_tpu_torch.ops import _ext, kernels

    dev = torch.device("cuda")
    _ext.build_all()
    d = tpch.generate(tpch.SF1_ROWS, args.seed)
    k6s = []
    for sel, cids in ((cs.d_supplier(), cs.D_SUPPLIER_CIDS),
                      (cs.d_part(), cs.D_PART_CIDS)):
        st = DistStore([], tpch.split_keys(tpch.SF1_ROWS, 8), dev,
                       plane_cache=PlaneCache(device=dev))
        cs.admit(st, sel, tpch.region_batches(d, cids, 8))
        k6s.append(cs.capture(st, sel, dev)[1])
    lim = kernels._k6_block_limit(_ext.lib("seg_states_ragged"), dev)
    print(f"k6_window_sweep: block limit {lim} B, K6_MAX_WINDOWS "
          f"{kernels.K6_MAX_WINDOWS}", flush=True)
    best = {}
    for i, (name, k6, own) in enumerate(shapes(*k6s)):
        readings = sweep(name, k6, own, lim, args.seed + i)
        best[name] = max((w for w, tw, ts in readings if ts >= RATIO * tw),
                         default=None)
    for name, w in best.items():
        print(f"{name}: windows beat the sorted route by {RATIO}x up to "
              f"{w} windows a region")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
