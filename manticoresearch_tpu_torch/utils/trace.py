"""Spans and counters at the port's layer boundaries, kept per request.

A *request* is one entry into the search layer (``SearchIndex._drive_steps``,
``ShardedIndex.search_batch``, ``RtIndex.search``). ``request(n)`` opens a
record for it on the calling thread; a request opened while another is open
on the same thread joins the outer record (an RT table's segment searches,
a distributed table's per-shard fallback searches). Inside, ``span(name)``
records ``(name, start_ns, end_ns, parent index)`` into the open record
and ``count(name, n)`` adds to its counters; both do nothing when no record
is open. Times are ``time.perf_counter_ns``.

A closed record goes to a process-wide ring of the last ``KEEP`` records
(``last``), under a lock: the SphinxAPI listener searches from several
threads, each with a record of its own. ``totals`` sums records by span
name (count, total and self time) and counter. Nothing is written out.

While ``torch.profiler`` records, each span also enters
``torch.profiler.record_function("mt." + name)``, so the port's layers sit
in the profiler's host timeline on the clock of its device events. With no
profiler running the range is never entered: even then it costs several
times the span itself.

Spans and their counters:

- ``request``: the record's first span, around the whole entry.
- ``plan`` (``SearchIndex.plan`` and ``_plan_grouped``, their plan-cache
  lookup included; ``ShardedIndex.plan``; the RT segment path), holding
  ``parse`` (the query parser) and ``plan_query`` (the planner). The
  counters ``plan_cache_hit`` and ``plan_cache_miss`` count the lookups of
  ``SearchIndex``'s plan cache; the other planners keep no cache and count
  nothing.
- ``round`` (``SearchIndex._run_round``), holding ``decode`` (the window
  table and the K1 launch), one ``program`` per plan shape (the eager
  program and its output rows), ``fetch`` (the host waits for the device
  and copies every output row) and ``unpack``.
- ``finish`` (``SearchIndex._finish``, ``ShardedIndex._render_merged``).
- ``ShardedIndex.search_batch``: ``prep`` per query (``_prep``: the plan and
  the per-shard runtime fill), ``decode`` per part, ``program`` and
  ``prelude`` per plan shape and part, ``merge`` per plan shape, ``fetch``,
  ``finish`` per query.

SHOW PROFILE reads a query's ``plan``, its round's children and its
``finish`` (``seconds``, ``child_seconds``); ``perfbench/metrics`` reads the
rest of the records (``last``, ``totals``).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch

KEEP = 4096

_now = time.perf_counter_ns


class _Local(threading.local):
    rec = None       # the thread's open record (a class default: no lookup
    #                  of a missing attribute, which costs an exception)


_local = _Local()
_ids = itertools.count(1)
_lock = threading.Lock()
_done: deque = deque(maxlen=KEEP)


class Record:
    """One request: its spans in the order they opened, each
    ``(name, start_ns, end_ns, parent index)`` (-1 for the first), and its
    counters."""
    __slots__ = ("id", "start_ns", "end_ns", "queries", "spans", "counters",
                 "top", "last")

    def __init__(self, queries: int):
        self.id = next(_ids)
        self.start_ns = self.end_ns = 0
        self.queries = queries
        self.spans: list = []
        self.counters: dict = {}
        self.top = -1        # the innermost open span
        self.last: dict = {}  # span name -> index of its latest closed one

    def duration_ns(self, i: int) -> int:
        _n, s, e, _p = self.spans[i]
        return e - s


_profiling = torch.autograd._profiler_enabled


class span:
    """``with span(name):`` one span of the open record (none: nothing)."""
    __slots__ = ("name", "rec", "i", "parent", "start_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = self.rec = _local.rec
        if rec is None:
            return self
        if _profiling():
            self.rf = torch.profiler.record_function("mt." + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.i = len(rec.spans)
        self.parent = rec.top
        rec.top = self.i
        self.start_ns = t = _now()
        rec.spans.append((self.name, t, t, self.parent))
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        rec.spans[self.i] = (self.name, self.start_ns, _now(), self.parent)
        rec.top = self.parent
        rec.last[self.name] = self.i
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class request:
    """``with request(n):`` the record of one entry of ``n`` queries, or,
    inside an open one on this thread, that one (its queries unchanged)."""
    __slots__ = ("queries", "rec", "top")

    def __init__(self, queries: int):
        self.queries = queries

    def __enter__(self):
        if _local.rec is not None:
            self.rec = None
            return self
        rec = self.rec = Record(self.queries)
        _local.rec = rec
        self.top = span("request")
        self.top.__enter__()
        rec.start_ns = self.top.start_ns
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        try:
            self.top.__exit__(*exc)
            rec.end_ns = rec.spans[0][2]
        finally:
            _local.rec = None
        with _lock:
            _done.append(rec)
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open record's counter ``name``."""
    rec = _local.rec
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def seconds(name: str) -> float:
    """Seconds of the open record's latest closed span ``name`` (0.0 where
    there is none)."""
    rec = _local.rec
    i = rec.last.get(name) if rec is not None else None
    return 0.0 if i is None else rec.duration_ns(i) / 1e9


def child_seconds(name: str) -> float:
    """Seconds of the direct children of the open record's latest closed
    span ``name`` (0.0 where there is none)."""
    rec = _local.rec
    i = rec.last.get(name) if rec is not None else None
    if i is None:
        return 0.0
    spans, end, ns = rec.spans, rec.spans[i][2], 0
    for j in range(i + 1, len(spans)):
        _n, s, e, p = spans[j]
        if s > end:
            break
        if p == i:
            ns += e - s
    return ns / 1e9


def last(n: int) -> list[Record]:
    """The last ``n`` closed records, oldest first."""
    with _lock:
        done = list(_done)
    return done[-n:] if n > 0 else []


@dataclass
class Totals:
    """Per span name ``[count, total_ns, self_ns]`` (self: the duration less
    its children's), and the counters summed."""
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    def total_ns(self, name: str) -> int:
        return self.spans.get(name, (0, 0, 0))[1]

    def self_ns(self, name: str) -> int:
        return self.spans.get(name, (0, 0, 0))[2]

    def count(self, name: str) -> int:
        return self.spans.get(name, (0, 0, 0))[0]


def totals(records: list[Record]) -> Totals:
    out = Totals()
    for rec in records:
        child = [0] * len(rec.spans)
        for _n, s, e, p in rec.spans:
            if p >= 0:
                child[p] += e - s
        for (name, s, e, _p), c in zip(rec.spans, child):
            t = out.spans.setdefault(name, [0, 0, 0])
            t[0] += 1
            t[1] += e - s
            t[2] += e - s - c
        for k, v in rec.counters.items():
            out.counters[k] = out.counters.get(k, 0) + v
    return out
