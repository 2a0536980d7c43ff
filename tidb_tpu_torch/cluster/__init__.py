"""The multi-region cluster store: a static region topology over a
Percolator MVCC store that takes transactions through 2PC, and the
coprocessor client that fans a request out per region (the port of
tidb_tpu/cluster, without the retry ladder, the lock resolver and GC)."""
