"""Query result cache.

Behavioral model: the reference's qcache (sphinxqcache.cpp:700 —
QcacheEntry_c stores compressed ranker output per (index, query) and is
invalidated by index generation changes; hooks at sphinxsearch.cpp:4183).
Same policy surface: qcache_max_bytes / qcache_thresh_msec / qcache_ttl_sec,
defaults matching the reference (16MB, 3000ms, 60s — i.e. only queries
slower than 3s are cached unless tuned). Keys carry the index *generation*,
which every write path bumps, so stale entries can never be served.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import replace


class QueryCache:
    def __init__(self, max_bytes: int = 16 * 1024 * 1024,
                 thresh_msec: int = 3000, ttl_sec: int = 60):
        self.max_bytes = max_bytes
        self.thresh_msec = thresh_msec
        self.ttl_sec = ttl_sec
        self._lru: OrderedDict[tuple, tuple] = OrderedDict()  # key->(res,sz,t)
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(index_name: str, generation: int, q) -> tuple:
        return (index_name, generation, repr(q))

    @staticmethod
    def _copy_result(res):
        out = replace(res)
        out.matches = [replace(m, attrs=dict(m.attrs)) for m in res.matches]
        return out

    @staticmethod
    def _size_of(res) -> int:
        # coarse: ~64 bytes per match + attr payloads
        n = 128
        for m in res.matches:
            n += 64 + sum(len(str(k)) + len(str(v))
                          for k, v in m.attrs.items())
        return n

    def get(self, key: tuple):
        if self.max_bytes <= 0:
            return None
        with self._lock:
            ent = self._lru.get(key)
            if ent is None:
                self.misses += 1
                return None
            res, sz, t = ent
            if time.monotonic() - t > self.ttl_sec:
                del self._lru[key]
                self._bytes -= sz
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            return self._copy_result(res)

    def put(self, key: tuple, res) -> None:
        if self.max_bytes <= 0 or res.error is not None:
            return
        sz = self._size_of(res)
        if sz > self.max_bytes:
            return
        with self._lock:
            if key in self._lru:
                self._bytes -= self._lru.pop(key)[1]
            self._lru[key] = (self._copy_result(res), sz, time.monotonic())
            self._bytes += sz
            while self._bytes > self.max_bytes and self._lru:
                _, (_, osz, _) = self._lru.popitem(last=False)
                self._bytes -= osz

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._bytes = 0

    def status(self) -> dict:
        with self._lock:
            return {
                "qcache_max_bytes": self.max_bytes,
                "qcache_thresh_msec": self.thresh_msec,
                "qcache_ttl_sec": self.ttl_sec,
                "qcache_cached_queries": len(self._lru),
                "qcache_used_bytes": self._bytes,
                "qcache_hits": self.hits,
            }
