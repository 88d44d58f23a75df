"""UUID-short id generation (UidShort, sphinxutils.cpp:3357-3371).

Auto-assigned document/query ids are `base + counter` where base packs a
server id (high 7 bits) and a start-time field. In the reference's test
mode (searchd.cpp:18668) the base is the constant 100000<<24 so recorded
golden models carry literal ids; production daemons pass server_id +
started-seconds through `setup()`.

The port's copy of ``manticoresearch_tpu/utils/uid.py``, with a counter
of its own.
"""
from __future__ import annotations

import itertools
import threading

_BASE = 100000 << 24          # test-mode seed (server 0, started 100000)
_counter = itertools.count(1)
_lock = threading.Lock()


def setup(server_id: int, started_sec: int) -> None:
    global _BASE, _counter
    with _lock:
        _BASE = ((server_id & 0x7F) << 56) + (started_sec << 24)
        _counter = itertools.count(1)


def uid_short() -> int:
    return _BASE + next(_counter)


def reset() -> None:
    """Restart semantics: a fresh daemon restarts the counter at 1
    (UidShort state is process-local) — the golden harness's
    restart-daemon hook calls this (test_358 stored-query ids)."""
    global _counter
    with _lock:
        _counter = itertools.count(1)
