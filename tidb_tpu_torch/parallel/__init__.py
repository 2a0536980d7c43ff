"""The coprocessor mesh on one card: S virtual shards (the port of
tidb_tpu/parallel/__init__.py, CoprMesh).

The reference shards a batch's rows over a 1-D device mesh with
shard_map: every chip runs the same fused kernel over its row block, and
the partial aggregates combine with psum / pmin / pmax over the chip
interconnect. Its tier-1 tests span 8 virtual CPU devices. The port's mesh
is S virtual shards on one device, named by a device list that repeats
that device (["cpu"] * 8 in the tests, [cuda:0] * 8 on the card): each
shard owns a contiguous row block, the local half runs over every shard
in one launch, and the collective is the shard-order fold of
kernels.mesh_allreduce (K7) on the device. A mesh over distinct cards
needs NCCL collectives and a rig with more than one card: it raises
Unsupported.
"""

from __future__ import annotations

import torch

from tidb_tpu_torch import errors
from tidb_tpu_torch.ops import kernels
from tidb_tpu_torch.ops.exprc import Unsupported


def available_devices(n: int | None = None) -> list:
    """Every visible CUDA device (the first n); DeviceError without
    CUDA."""
    if not torch.cuda.is_available():
        raise errors.DeviceError("CUDA is not available: a mesh over the "
                                 "card needs one (pass devices=['cpu'] * n "
                                 "for the plain versions)")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return devs if n is None else devs[:n]


class CoprMesh:
    """A 1-D mesh over which coprocessor batches are row-sharded: n
    shards on one device."""

    def __init__(self, devices=None, n_devices: int | None = None):
        devices = [kernels._device(d) for d in
                   (devices or available_devices(n_devices))]
        if not devices:
            raise errors.DeviceError("a mesh needs at least one device")
        if len(set(devices)) > 1:
            raise Unsupported("a mesh over distinct devices needs NCCL "
                              "collectives (a rig with more than one card)")
        self.n = len(devices)
        self.device = devices[0]

    def _check(self, live) -> None:
        if live.shape[0] % self.n != 0:
            raise Unsupported(f"batch capacity {live.shape[0]} not "
                              f"divisible by mesh size {self.n}")

    def _collective(self, parts: list, combiners: list) -> list:
        """The one collective: per-shard partials [n, M] folded in shard
        order on the shards' device (K7), one readback."""
        codes = [kernels._COMBINE_CODE[(c, is_f)]
                 for (_t, is_f), c in zip(parts, combiners)]
        return kernels.mesh_allreduce([t for t, _f in parts], codes)

    def run(self, fn, planes, live) -> list:
        """A mesh-combinable aggregate fn (every entry of fn.combiners a
        monoid; the client keeps the others on one launch) over the
        shards: per-shard partials, then the collective; the outputs as
        the single-device fn gives them. At one shard the partials are
        the totals and fn runs as it is."""
        self._check(live)
        if self.n == 1:
            return fn(planes, live)
        parts = fn.partials(planes, live, self.n)
        return fn.finish(self._collective(parts, fn.combiners), parts)

    def run_sharded(self, fn, planes, live):
        """Per-shard outputs with no collective, shard-major: the per-shard
        top-k candidates (the host merges them) and the near-data tier's
        per-shard state blocks (ops.mesh.region_states_sharded: each
        region lives wholly on its home shard)."""
        self._check(live)
        return fn(planes, live, self.n)
