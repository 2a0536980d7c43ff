"""Core KV interfaces (copy of tidb_tpu/kv/kv.py: the coprocessor
boundary Client/Request/Response, Snapshot, and the Transaction / Storage
interfaces with ActiveReads, :74-100, :134-155, :196-221)."""

from __future__ import annotations

import abc
import threading
import weakref
from dataclasses import dataclass, field
from typing import Any, Iterator


# request types (kv/kv.go:103-111); the port serves table scans only
REQ_TYPE_SELECT = 101


@dataclass(frozen=True)
class KeyRange:
    """[start, end) over encoded keys."""
    start: bytes
    end: bytes


class Retriever(abc.ABC):
    @abc.abstractmethod
    def get(self, key: bytes) -> bytes:
        """Raise KeyNotExistsError if absent."""

    @abc.abstractmethod
    def iterate(self, start: bytes, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ascending (key, value) pairs in [start, end)."""


class Mutator(abc.ABC):
    @abc.abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def delete(self, key: bytes) -> None: ...


class Snapshot(abc.ABC):
    @abc.abstractmethod
    def iterate(self, start: bytes, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ascending (key, value) pairs in [start, end)."""


class Transaction(Retriever, Mutator, abc.ABC):
    """Snapshot-isolated, buffered writes (kv/kv.go:140-153)."""

    @abc.abstractmethod
    def commit(self) -> None: ...

    @abc.abstractmethod
    def rollback(self) -> None: ...

    @abc.abstractmethod
    def start_ts(self) -> int: ...


@dataclass
class Request:
    """Coprocessor request."""
    tp: int
    data: Any                      # SelectRequest — in-proc object
    key_ranges: list[KeyRange] = field(default_factory=list)
    keep_order: bool = False
    desc: bool = False
    concurrency: int = 1


class Response(abc.ABC):
    @abc.abstractmethod
    def next(self) -> Any | None:
        """Next partial result (SelectResponse) or None when exhausted."""

    def close(self) -> None:
        """Release resources; consumers that stop early call this."""


class Client(abc.ABC):
    @abc.abstractmethod
    def send(self, req: Request) -> Response: ...


class Storage(abc.ABC):
    """kv/kv.go:155-170."""

    @abc.abstractmethod
    def begin(self) -> Transaction: ...

    @abc.abstractmethod
    def get_snapshot(self, version: int | None = None) -> Snapshot: ...

    @abc.abstractmethod
    def get_client(self) -> Client: ...

    @abc.abstractmethod
    def current_version(self) -> int: ...


class ActiveReads:
    """Thread-safe weak registry of live snapshots and transactions:
    oldest() is the start version of the oldest one still open (the plane
    cache keeps the generations such a reader still reads)."""

    def __init__(self):
        self._set = weakref.WeakSet()
        self._lock = threading.Lock()

    def add(self, obj) -> None:
        with self._lock:
            self._set.add(obj)

    def oldest(self) -> int | None:
        """Smallest start version among live, unfinished readers."""
        with self._lock:
            objs = list(self._set)
        ts = [getattr(o, "version", None) or getattr(o, "_start_ts", None)
              for o in objs
              if getattr(o, "_valid", True)]   # finished txns don't pin
        ts = [t for t in ts if t is not None]
        return min(ts) if ts else None
