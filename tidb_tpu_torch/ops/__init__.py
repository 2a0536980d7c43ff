"""The coprocessor on the card: column planes (columnar), the expression
compiler (exprc), the kernels and their builders (kernels, csrc/, _ext)
and the client (client.GpuClient)."""
