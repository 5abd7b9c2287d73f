"""Byte-bounded LRU cache — the ICache seam's in-proc tier.

Shared by the historian façade (``service/historian.py``) and the store
node's cache ops (``service/store_server.py``) so the byte-accounting
invariant lives in exactly one place. Reference role:
``historian-base/src/services/redisCache.ts`` (the cache tier) and
``definitions.ts`` (the ICache contract)."""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional


class LruCache:
    """get/set/delete over keyed bytes, evicting least-recently-used
    entries once the byte budget is exceeded. Thread-safe."""

    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity = capacity_bytes
        self._d: "OrderedDict[str, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            v = self._d.get(key)
            if v is not None:
                self._d.move_to_end(key)
            return v

    def set(self, key: str, value: bytes) -> None:
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            if len(value) > self.capacity:
                # An uncacheable oversized value must not flush the whole
                # cache on every write — skip it (the entry it replaced,
                # if any, stays evicted: it no longer reflects the store).
                return
            self._d[key] = value
            self._bytes += len(value)
            while self._bytes > self.capacity:
                _k, v = self._d.popitem(last=False)
                self._bytes -= len(v)

    def delete(self, key: str) -> None:
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
