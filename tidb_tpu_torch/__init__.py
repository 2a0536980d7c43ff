"""tidb_tpu_torch: the coprocessor of tidb_tpu on PyTorch and CUDA.

The JAX package `tidb_tpu` is the reference; this package is its port to
one NVIDIA H100. It imports torch and numpy and nothing of `tidb_tpu`:
every host module it needs is a copy cut down to what the port uses, kept
under the same name and layout so a reader finds the counterpart.

Slice 1 carries the in-process coprocessor path: a `SelectRequest` over a
KV snapshot is packed into column planes (`ops.columnar.pack_ranges`), its
expressions are compiled to a bytecode program (`ops.exprc`), and
`ops.client.GpuClient.send` answers it with four hand-written CUDA kernels
(`ops/csrc/`): the expression interpreter, the scalar aggregate and the
two grouped aggregates. The answer is the same chunk protocol of partial
rows that `tidb_tpu.ops.client.TpuClient` sends.

Entry points run on the card; `device="cpu"` selects the kernels' plain
PyTorch versions (the CPU tests pass it explicitly).
"""
