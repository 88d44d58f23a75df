"""The port's spans and counters (``manticoresearch_tpu_torch.utils.trace``)
on small indexes built here, on the CPU.

Covered: one record per request with the nesting of the layers
(``SearchIndex``: request > plan > parse, plan_query; round > decode,
program, fetch, unpack; finish; ``ShardedIndex``: request > prep > plan;
decode per part; program and prelude per part; merge; fetch; finish), every
span inside its parent and the request, children never longer than their
parent; the plan-cache counters, the hit-stream rankers' ``lcs_eager`` and
the positional nodes' ``pos_eager``;
searches opened inside an open request (an outer ``request``, an RT
table's segments, a distributed table's fallback) joining it; the ring
of the last ``KEEP`` records; records kept apart per thread; ``mt.*``
ranges under ``torch.profiler`` and no ``record_function`` without one;
``totals``; SHOW PROFILE's stages read from the spans.
"""
from __future__ import annotations

import random
import sys
import threading
from collections import deque

import pytest
import torch

from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.exec.session import Catalog, Session
from manticoresearch_tpu_torch.index.builder import IndexBuilder
from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.utils import trace

SCHEMA = Schema(fields=["content"], attrs=[AttrDef("year", AttrType.UINT),
                                           AttrDef("gid", AttrType.UINT)])
WORDS = [f"w{i}" for i in range(30)]
QUERIES = ["w1 w2", '"w0 w1"', "w3 | w4", "w0 -w5", '"w1 w2"~3']


def _docs(lo: int, hi: int) -> list[dict]:
    rng = random.Random(lo)
    return [{"id": i + 1, "year": 2000 + i % 25, "gid": i % 7,
             "content": " ".join(WORDS[min(int(rng.expovariate(0.15)), 29)]
                                 for _ in range(12))}
            for i in range(lo, hi)]


def _build(lo: int, hi: int):
    b = IndexBuilder(SCHEMA)
    b.add_documents(_docs(lo, hi))
    return b.build()


@pytest.fixture(scope="module")
def index() -> SearchIndex:
    return SearchIndex(_build(0, 400), device="cpu")


@pytest.fixture(scope="module")
def sharded() -> ShardedIndex:
    return ShardedIndex([_build(100 * k, 100 * k + 100) for k in range(4)],
                        devices=["cpu"] * 2)


def _q(text: str, **kw) -> SearchQuery:
    return SearchQuery(match=text, limit=5, **kw)


def _names(rec, parent: int) -> list[str]:
    return [s[0] for s in rec.spans if s[3] == parent]


def _children(rec, i: int) -> list[int]:
    return [j for j, s in enumerate(rec.spans) if s[3] == i]


def _assert_nested(rec) -> None:
    """Span 0 is the request; every other span has an earlier parent, lies
    inside its parent's interval (and so inside the request's), and a
    span's children together last no longer than it."""
    name0, s0, e0, p0 = rec.spans[0]
    assert (name0, p0) == ("request", -1)
    assert (rec.start_ns, rec.end_ns) == (s0, e0) and e0 > s0
    for i, (name, s, e, p) in enumerate(rec.spans):
        assert s <= e, name
        if i:
            assert 0 <= p < i, name
            _pn, ps, pe, _pp = rec.spans[p]
            assert ps <= s and e <= pe, (name, rec.spans[p][0])
            assert s0 <= s and e <= e0
        kids = _children(rec, i)
        assert sum(rec.duration_ns(j) for j in kids) <= rec.duration_ns(i)


def _plan_children(rec) -> list[list[str]]:
    return [_names(rec, i) for i, s in enumerate(rec.spans)
            if s[0] == "plan"]


def test_batch_is_one_record_nested_by_layer(index):
    before = trace.last(1)
    index.search_batch([_q(QUERIES[0]), _q(QUERIES[1] + " w9")])
    rec, = trace.last(1)
    assert not before or rec.id > before[0].id
    assert rec.queries == 2
    _assert_nested(rec)
    assert _names(rec, 0) == ["plan", "plan", "round", "finish", "finish"]
    assert _plan_children(rec) == [["parse", "plan_query"]] * 2
    rnd = [i for i, s in enumerate(rec.spans) if s[0] == "round"]
    assert len(rnd) == 1
    kids = _names(rec, rnd[0])
    assert kids[0] == "decode" and kids[-2:] == ["fetch", "unpack"]
    assert set(kids[1:-2]) == {"program"} and 1 <= len(kids) - 3 <= 2
    # both programs rank by the hit stream and the second holds a phrase:
    # on the CPU, the eager pass and the eager node
    assert rec.counters == {"plan_cache_miss": 2, "lcs_eager": 2,
                            "pos_eager": 1}


def test_same_query_twice_misses_then_hits(index):
    q = _q("w2 w7 w8")
    index.search(q)
    first, = trace.last(1)
    index.search(q)
    second, = trace.last(1)
    assert first.counters["plan_cache_miss"] == 1
    assert "plan_cache_hit" not in first.counters
    assert second.counters["plan_cache_hit"] == 1
    assert "plan_cache_miss" not in second.counters
    # a hit neither parses nor plans
    assert _plan_children(second) == [[]]


def test_sharded_batch_spans(sharded):
    sharded.search_batch([_q(t) for t in QUERIES[:3]])
    rec, = trace.last(1)
    assert rec.queries == 3
    _assert_nested(rec)
    top = _names(rec, 0)
    assert top[:3] == ["prep"] * 3
    assert top.count("decode") == 2           # one per part
    assert top.count("fetch") == 1 and top[-3:] == ["finish"] * 3
    n_merge = top.count("merge")
    assert n_merge >= 1
    assert top.count("program") == top.count("prelude") == 2 * n_merge
    for i, s in enumerate(rec.spans):
        if s[0] == "prep":
            assert _names(rec, i) == ["plan"]
    assert _plan_children(rec) == [["parse", "plan_query"]] * 3
    # the union planner keeps no plan cache and counts nothing; each of
    # the 4 shards' programs of the 3 queries ranks by the eager hit
    # stream, and the phrase query's evaluates its node eager
    assert rec.counters == {"lcs_eager": 12, "pos_eager": 4}


def _outer(index, sharded):
    with trace.request(7):
        index.search(_q("w1"))
        index.search_batch([_q("w2"), _q("w3")])
    return 7, 3     # the record's queries, the searches that joined it


def _rt_segments(index, sharded):
    cat = Catalog(device="cpu")
    sess = Session(cat)
    sess.execute("CREATE TABLE rt (content text, year int)")
    for i in range(3):   # a flush after each insert: three disk chunks
        sess.execute(f"INSERT INTO rt (id, content, year) VALUES "
                     f"({i + 1}, 'w1 w{i + 2}', 2001)")
        sess.execute("FLUSH RAMCHUNK rt")
    assert len(cat.get("rt").searchable_parts()) == 3
    cat.get("rt").search(_q("w1"))
    return 1, 3


def _fallback(index, sharded):
    sharded.search(_q("w1", group_by="gid", select=["count(*)"]))
    return 1, 4     # the per-shard searches


@pytest.mark.parametrize("case", [_outer, _rt_segments, _fallback],
                         ids=["outer_request", "rt_segments",
                              "sharded_fallback"])
def test_inner_searches_join_the_open_request(index, sharded, case):
    n_before = len(trace.last(trace.KEEP))
    first = trace.last(1)
    queries, joined = case(index, sharded)
    rec, = trace.last(1)
    # exactly one record more (or the ring's oldest dropped for it)
    assert rec.id > (first[0].id if first else 0)
    assert len(trace.last(trace.KEEP)) in (n_before + 1, trace.KEEP)
    assert rec.queries == queries
    assert [s[0] for s in rec.spans].count("finish") == joined
    _assert_nested(rec)
    assert [s[0] for s in rec.spans].count("request") == 1
    if case is _fallback:
        assert _names(rec, 0)[:2] == ["prep", "plan"]
        assert _names(rec, 0).count("round") == joined


def test_ring_keeps_the_last_records(index, monkeypatch):
    monkeypatch.setattr(trace, "_done",
                        deque(trace.last(trace.KEEP), maxlen=trace.KEEP))
    for _ in range(trace.KEEP + 5):
        with trace.request(1):
            pass
    recs = trace.last(trace.KEEP + 100)
    assert len(recs) == trace.KEEP == 4096
    ids = [r.id for r in recs]
    assert ids == list(range(ids[0], ids[0] + trace.KEEP))
    assert trace.last(3) == recs[-3:] and trace.last(0) == []


def test_threads_keep_separate_records(index):
    """Several threads search at once, the interpreter switching threads
    every few microseconds: each search is one record of its own thread,
    holding that thread's query alone."""
    n_threads, rounds = 8, 6
    texts = [f"w{t} w{t + 10}" for t in range(n_threads)]
    errors, seen = [], {}

    def work(t: int):
        try:
            for _ in range(rounds):
                index.search(_q(texts[t]))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in ths)
    recs = trace.last(n_threads * rounds)
    for rec in recs:
        _assert_nested(rec)
        assert rec.queries == 1
        assert _names(rec, 0) == ["plan", "round", "finish"]
        seen[rec.id] = rec
    assert len(seen) == n_threads * rounds


def test_profiler_sees_the_port_ranges(index):
    act = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=act) as prof:
        index.search_batch([_q("w4 w5"), _q('"w1 w6"')])
    names = {e.name for e in prof.events()}
    assert {"mt.request", "mt.plan", "mt.round", "mt.decode", "mt.program",
            "mt.fetch", "mt.unpack", "mt.finish"} <= names


def test_no_profiler_no_record_function(index, monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    index.search_batch([_q("w6 w2"), _q("w3")])
    assert entered == []
    assert [s[0] for s in trace.last(1)[0].spans][:2] == ["request", "plan"]


def test_totals_count_total_and_self_time():
    """Hand-made records: per name the count, the summed durations and the
    durations less their direct children's; counters summed."""
    def rec(spans, counters):
        r = trace.Record(1)
        r.spans = spans
        r.counters = counters
        return r
    a = rec([("request", 0, 100, -1), ("plan", 10, 40, 0),
             ("parse", 12, 20, 1), ("plan_query", 20, 35, 1),
             ("round", 50, 90, 0), ("fetch", 60, 80, 4)],
            {"plan_cache_miss": 1})
    b = rec([("request", 0, 30, -1), ("plan", 5, 9, 0)],
            {"plan_cache_hit": 1})
    t = trace.totals([a, b])
    assert t.spans == {"request": [2, 130, 130 - 70 - 4],
                       "plan": [2, 34, 34 - 23], "parse": [1, 8, 8],
                       "plan_query": [1, 15, 15], "round": [1, 40, 20],
                       "fetch": [1, 20, 20]}
    assert t.counters == {"plan_cache_miss": 1, "plan_cache_hit": 1}
    assert (t.count("plan"), t.total_ns("round"), t.self_ns("round")) \
        == (2, 40, 20)
    assert t.total_ns("merge") == t.count("merge") == 0


def test_spans_outside_a_request_record_nothing():
    first = trace.last(1)
    with trace.span("plan"):
        trace.count("plan_cache_hit")
    assert trace.last(1) == first
    assert trace.seconds("plan") == trace.child_seconds("round") == 0.0


def test_show_profile_reads_the_query_spans(index):
    """SHOW PROFILE after a SELECT on a plain table: the three stages of
    the JAX package's rows, each its span's time, summing to no more than
    the SELECT's request span."""
    cat = Catalog(device="cpu")
    cat.tables["plain"] = index
    sess = Session(cat)
    assert sess.execute("SELECT * FROM plain WHERE MATCH('w1 w9')")[0].rows
    rec, = trace.last(1)
    rows = sess.execute("SHOW PROFILE")[0].rows
    stages = rows[:-1]
    assert [r[0] for r in stages] == ["parse_and_plan", "device_exec_fetch",
                                      "finalize"]
    assert rows[-1][0] == "total"
    secs = [float(r[1]) for r in stages]
    assert all(s > 0 for s in secs)
    assert sum(secs) <= rec.duration_ns(0) / 1e9 + 3e-6   # 6-digit rounding
    _assert_nested(rec)
    by_name = {s[0]: rec.duration_ns(i) for i, s in enumerate(rec.spans)
               if s[0] in ("plan", "finish")}
    assert abs(secs[0] - by_name["plan"] / 1e9) <= 1e-6
    assert abs(secs[2] - by_name["finish"] / 1e9) <= 1e-6
