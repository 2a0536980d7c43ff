"""SQL values: Datum and the temporal types (copies of tidb_tpu/types)."""

from tidb_tpu_torch.types.datum import Datum, Kind, NULL  # noqa: F401
