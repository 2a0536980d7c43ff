"""Error taxonomy: the subset of tidb_tpu/errors.py the port raises."""

from __future__ import annotations

from tidb_tpu_torch import mysqldef as my


class TiDBError(Exception):
    """Base engine error carrying a MySQL error code for the wire protocol."""

    code: int = my.ErrUnknown

    def __init__(self, msg: str = "", code: int | None = None):
        super().__init__(msg)
        if code is not None:
            self.code = code


class TypeError_(TiDBError):
    code = my.ErrTruncated


class OverflowError_(TiDBError):
    code = my.ErrDataTooLong


class DeviceError(TiDBError):
    """Device-tier fault: a kernel that does not build, launch or finish.
    The port has no lower tier yet, so it reaches the caller."""
