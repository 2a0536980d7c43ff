"""The multi-region cluster store: a static region topology over one
read-only KV snapshot, and the coprocessor client that fans a request out
per region (the port of tidb_tpu/cluster, cut to that read path)."""
