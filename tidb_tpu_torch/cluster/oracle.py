"""The cluster store's timestamp oracle (copy of VersionProvider,
tidb_tpu/localstore/store.py:33-47).

Reference: store/localstore/local_version_provider.go.
"""

from __future__ import annotations

import threading
import time


class VersionProvider:
    """Monotonic TSO shaped like TiKV's: physical-ms << 18 | logical."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0

    def current_version(self) -> int:
        with self._lock:
            ts = int(time.time() * 1000) << 18
            if ts <= self._last:
                ts = self._last + 1
            self._last = ts
            return ts
