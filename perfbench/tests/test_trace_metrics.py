"""The readers of the port's own spans and counters
(``perfbench/metrics/<name>.py`` over ``program_spans.window``) on
hand-built trace records: each gives the value its docstring defines, and
None where a record of the window is missing, where the records' queries
disagree with the window's, or where the port never ran the layer."""
from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import pytest

from manticoresearch_tpu_torch.utils import trace
from perfbench import spec

MS = 1_000_000      # ns


def _record(spans: list, counters: dict, queries: int = 2):
    r = trace.Record(queries)
    r.spans = spans
    r.counters = counters
    return r


def _plain(hit: bool):
    """A 2-query request on a plain table: plans (one parse and plan_query
    each unless a cache hit), one round of two programs, finishes."""
    plan = ([("plan", 1 * MS, 2 * MS, 0)] if hit else
            [("plan", 1 * MS, 5 * MS, 0), ("parse", 1 * MS, 2 * MS, 1),
             ("plan_query", 2 * MS, 5 * MS, 1)])
    n = len(plan)
    spans = ([("request", 0, 40 * MS, -1)] + plan
             + [("plan", 5 * MS, 9 * MS, 0), ("parse", 5 * MS, 6 * MS, n + 1),
                ("plan_query", 6 * MS, 9 * MS, n + 1),
                ("round", 10 * MS, 35 * MS, 0),
                ("decode", 10 * MS, 12 * MS, n + 4),
                ("program", 12 * MS, 20 * MS, n + 4),
                ("program", 20 * MS, 24 * MS, n + 4),
                ("fetch", 24 * MS, 33 * MS, n + 4),
                ("unpack", 33 * MS, 34 * MS, n + 4),
                ("finish", 35 * MS, 37 * MS, 0),
                ("finish", 37 * MS, 39 * MS, 0)])
    counters = {"plan_cache_miss": 1 if hit else 2}
    if hit:
        counters["plan_cache_hit"] = 1
    return _record(spans, counters)


def _sharded():
    """A 2-query request on a distributed table of 2 parts: preps holding
    the plans, a decode per part, a program and a prelude per part, one
    merge, the fetch and the finishes."""
    spans = [("request", 0, 60 * MS, -1),
             ("prep", 0, 6 * MS, 0), ("plan", 1 * MS, 4 * MS, 1),
             ("parse", 1 * MS, 2 * MS, 2), ("plan_query", 2 * MS, 4 * MS, 2),
             ("prep", 6 * MS, 10 * MS, 0), ("plan", 6 * MS, 9 * MS, 5),
             ("parse", 6 * MS, 7 * MS, 6), ("plan_query", 7 * MS, 9 * MS, 6),
             ("decode", 10 * MS, 12 * MS, 0), ("decode", 12 * MS, 14 * MS, 0),
             ("program", 14 * MS, 24 * MS, 0),
             ("prelude", 24 * MS, 26 * MS, 0),
             ("program", 26 * MS, 36 * MS, 0),
             ("prelude", 36 * MS, 38 * MS, 0),
             ("merge", 38 * MS, 44 * MS, 0), ("fetch", 44 * MS, 54 * MS, 0),
             ("finish", 54 * MS, 56 * MS, 0), ("finish", 56 * MS, 58 * MS, 0)]
    return _record(spans, {})


# per metric: the records of a 2-request window (4 queries) and the value
CASES = {
    # 1 hit of 4 plans
    "plan_cache_hit_pct": ([_plain(False), _plain(True)], 25.0),
    # parse: (1 + 1) + (0 + 1) ms over 4 queries
    "parse_ms_per_query": ([_plain(False), _plain(True)], 3 / 4),
    # plan_query: (3 + 3) + (0 + 3) ms over 4 queries
    "plan_query_ms_per_query": ([_plain(False), _plain(True)], 9 / 4),
    # prep self time: (6 - 3) + (4 - 3) ms per request, over 4 queries
    "shard_prep_ms_per_query": ([_sharded(), _sharded()], 8 / 4),
    # programs: 8 + 4 ms per plain request, over 4 queries
    "program_host_ms_per_query": ([_plain(False), _plain(True)], 24 / 4),
    # fetch: 9 ms per plain request, over 2 requests
    "fetch_wait_ms_per_request": ([_plain(False), _plain(False)], 9.0),
    # prelude 2 + 2 and merge 6 ms per request, over 2 requests
    "merge_ms_per_request": ([_sharded(), _sharded()], 10.0),
}


@pytest.fixture
def ring(monkeypatch):
    """The trace's ring, emptied for the test; -> a function that fills
    it."""
    monkeypatch.setattr(trace, "_done", deque(maxlen=trace.KEEP))

    def fill(records):
        trace._done.extend(records)
    return fill


def _ctx(requests=2, queries=4):
    return SimpleNamespace(requests=requests, queries=queries)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_value(metric, ring):
    records, want = CASES[metric]
    # an older request before the window does not count
    ring([_sharded() if "merge" in metric or "prep" in metric
          else _plain(True)] + records)
    got = spec.reader(metric)(_ctx())
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(CASES))
@pytest.mark.parametrize("fault", ["short", "queries_differ", "empty",
                                   "no_requests"])
def test_reader_none(metric, fault, ring):
    records, _want = CASES[metric]
    ctx = _ctx()
    if fault == "short":          # a window request has no record
        ring(records[1:])
    elif fault == "queries_differ":   # the window completed 5 queries
        ring(records)
        ctx = _ctx(queries=5)
    elif fault == "empty":
        ring([])
    else:
        ring(records)
        ctx = _ctx(requests=0, queries=0)
    assert spec.reader(metric)(ctx) is None


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_none_where_the_layer_never_ran(metric, ring):
    """The plain table's records for a distributed table's metric and the
    distributed table's for the plan cache's: the layer's span or counter
    never appears."""
    if metric in ("shard_prep_ms_per_query", "merge_ms_per_request"):
        other = _plain(False)
    elif metric == "plan_cache_hit_pct":
        other = _sharded()      # the union planner keeps no plan cache
    else:
        other = _record([("request", 0, 5 * MS, -1)], {})
    ring([other, other])
    assert spec.reader(metric)(_ctx()) is None
