"""Error taxonomy: the subset of tidb_tpu/errors.py the port raises."""

from __future__ import annotations

from dataclasses import dataclass

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


class DeviceOOM(DeviceError):
    """The card ran out of memory (torch.cuda.OutOfMemoryError) in a
    kernel's wrapper or in an out-of-core pass's copies to and from it.
    The one device fault an out-of-core operator answers by splitting its
    work into smaller passes."""


class KVError(TiDBError):
    pass


class KeyNotExistsError(KVError):
    """kv.ErrNotExist"""


class RetryableError(KVError):
    """The write-conflict class: the caller may replay the transaction."""


@dataclass
class LockInfo:
    """An uncommitted Percolator lock (cluster.mvcc)."""
    key: bytes
    primary: bytes
    start_ts: int
    ttl_ms: int
    kind: str               # 'put' | 'delete' | 'lock'
    value: bytes | None


class KeyIsLockedError(RetryableError):
    """A read or prewrite met another transaction's lock. The port has no
    lock resolver yet, so the error reaches the caller."""

    def __init__(self, lock: LockInfo):
        super().__init__(f"key {lock.key!r} locked by txn {lock.start_ts}")
        self.lock = lock


class WriteConflict(RetryableError):
    """A prewrite found a write committed at or after its start_ts."""


class TxnAborted(TiDBError):
    """Commit attempted but the lock is gone and a rollback record exists."""
