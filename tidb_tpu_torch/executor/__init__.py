"""Executors of the port: for now the FINAL aggregate over grouped
partial states (executor.fused_agg)."""
