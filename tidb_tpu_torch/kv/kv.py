"""Core KV interfaces of the coprocessor boundary (copy of the
Client/Request/Response/Snapshot part of tidb_tpu/kv/kv.py)."""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Iterator

# request types (kv/kv.go:103-111); the port serves table scans only
REQ_TYPE_SELECT = 101


@dataclass(frozen=True)
class KeyRange:
    """[start, end) over encoded keys."""
    start: bytes
    end: bytes


class Snapshot(abc.ABC):
    @abc.abstractmethod
    def iterate(self, start: bytes, end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ascending (key, value) pairs in [start, end)."""


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
