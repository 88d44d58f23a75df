"""Port parity: GROUP BY, late filters and JSON ORDER BY, JAX SearchIndex vs
the port's ``SearchIndex(device="cpu")``.

One seeded 400-document index with a uint group column ``g``, ``year``, a
float ``price`` drawn from values whose sums depend on the add order (1e8,
1, -1e8, ...), a string, a bigint, an MVA, a JSON column, a timestamp and
document ids past 2^32, handed to the port with ``from_jax_packed``. Each
case runs through the port's ``search`` and ``search_batch`` and is held
against the JAX package's ``search``, under ``MT_SPARSE`` never, auto and
always. Covered: every shape of ``tests/test_groupby.py``; every aggregate
(float SUM and AVG included), group order and WITHIN GROUP ORDER BY kind;
expression and string keys; the host routes (MVA, bigint, JSON-path and
bigint-expression keys, GROUP N BY, a string WITHIN GROUP ORDER BY,
COUNT(DISTINCT id)); GROUP_CONCAT and HAVING; late expression and 64-bit
MVA filters; ORDER BY a JSON path; seeded random grouped queries; a
``search_batch`` mixing all of these with ranked queries in one decode
round; and the plain ordered segment sum against XLA's scatter-add.

Tolerance: exact. Docids, weights, totals and integer aggregates are
integers; float aggregates must be the same float32 values, which the
ordered segment sum gives (the same adds in the same order).

Every call the group-by tail makes to ``segment_sum_ordered`` is checked
against the kernel's contract (``tests/_torch_contracts.py``: group ids
nondecreasing and in ``[0, n_out)``), and the plain version is held to
XLA's scatter-add on the six input shapes ``chip_smoke.segment_cases``
checks the kernel on, at a small size.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manticoresearch_tpu.exec.searcher import SearchIndex as JaxIndex
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.exec.searcher import (SearchQuery,
                                                     run_late_filtered)
from manticoresearch_tpu_torch.ops import groupby as port_groupby
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

from ._torch_contracts import check_sorted_ids
from ._torch_contracts import sorted_ids_contract  # noqa: F401  (autouse)
from .test_torch_search import _jax_query, _port, _summary

torch.set_num_threads(2)

N_DOCS = 400
PRICES = np.asarray([1e8, 1.0, -1e8, 0.5, 3.25, -2.0, 1e-3, 7.0], np.float32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(41)
    words = [f"w{i}" for i in range(12)]
    docs = []
    for i in range(1, N_DOCS + 1):
        docs.append(dict(
            id=100 + 7 * i if i <= N_DOCS - 3 else (1 << 33) + i,
            title=words[i % 12],
            body=" ".join(words[int(z) % 12] for z in rng.zipf(1.4, 8)),
            g=int(rng.randint(0, 9)), year=2000 + i % 25,
            price=float(PRICES[rng.randint(len(PRICES))]),
            s=["red", "green", "blue", ""][i % 4],
            big=int(rng.choice([-1, 1]) * rng.randint(0, 2**40)),
            tags=[int(x) for x in rng.randint(0, 12, rng.randint(0, 4))],
            meta=json.dumps({"a": int(rng.randint(0, 20)),
                             "b": ["x", "y"][i % 2]}),
            ts=int(rng.randint(0, 2**31 - 1))))
    b = IndexBuilder(Schema(fields=["title", "body"],
                            attrs=[AttrDef("g", AttrType.UINT),
                                   AttrDef("year", AttrType.UINT),
                                   AttrDef("price", AttrType.FLOAT),
                                   AttrDef("s", AttrType.STRING),
                                   AttrDef("big", AttrType.BIGINT),
                                   AttrDef("tags", AttrType.MVA),
                                   AttrDef("meta", AttrType.JSON),
                                   AttrDef("ts", AttrType.TIMESTAMP)]))
    b.add_documents(docs)
    packed = b.build()
    return JaxIndex(packed), _port(packed)


def _mode(monkeypatch, mode: str, *indexes) -> None:
    monkeypatch.setenv("MT_SPARSE", mode)
    for idx in indexes:
        idx._plan_cache.clear()


def _check(jax_idx, idx, q: SearchQuery) -> dict:
    """The port's search and search_batch against JAX's search."""
    want = _summary(jax_idx.search(_jax_query(q)))
    assert want["error"] is None, want["error"]
    assert _summary(idx.search(q)) == want
    assert _summary(idx.search_batch([q])[0]) == want
    return want


def _f(attr, kind, **kw):
    return AttrFilterDef(attr, kind, **kw)


AGGS = ["count(*)", "sum(year)", "sum(price)", "avg(year)", "avg(price)",
        "min(price)", "max(price)", "min(year)", "max(year)",
        "count(distinct year)"]

DEVICE_CASES = {
    # the shapes of tests/test_groupby.py
    "count": dict(group_by="g", select=["count(*)"]),
    "rep-best-weight": dict(group_by="g", sort=[("g", True)]),
    "sum-min-max-avg": dict(group_by="g", select=["sum(price)", "min(price)",
                                                   "max(price)", "avg(year)"]),
    "count-distinct": dict(group_by="g", select=["count(distinct year)"]),
    "filter": dict(group_by="g", select=["count(*)"],
                   filters=[_f("year", "range_i", lo=2003, hi=2017)]),
    "order-count-desc": dict(group_by="g", select=["count(*)"],
                             sort=[("@count", False)]),
    "order-float-attr": dict(group_by="g", select=["count(*)"],
                             sort=[("price", True)]),
    "having": dict(group_by="g", select=["count(*)"], sort=[("g", True)],
                   having=("count(*)", ">", 30)),
    "expr-mod": dict(group_by="year%7", select=["count(*)"]),
    "limit": dict(group_by="g", select=["count(*)"], limit=3, offset=1),
    # every aggregate at once, every order and within kind
    "all-aggs": dict(group_by="g", select=AGGS),
    "order-gkey-desc": dict(group_by="g", select=AGGS[:4],
                            sort=[("@groupby", False)]),
    "order-count-asc": dict(group_by="g", select=["avg(price)"],
                            sort=[("count(*)", True)]),
    "order-rowid": dict(group_by="g", select=["sum(price)"],
                        sort=[("id", False)]),
    "order-attr-int": dict(group_by="g", select=["avg(year)"],
                           sort=[("year", False)]),
    "order-rel": dict(group_by="g", select=["sum(price)"],
                      sort=[("weight()", False)]),
    "within-attr": dict(group_by="g", select=["count(*)", "sum(price)"],
                        within_sort=[("year", False)]),
    "within-float": dict(group_by="g", select=["count(*)"],
                         within_sort=[("price", True)]),
    "within-rowid": dict(group_by="g", select=["count(*)", "*"],
                         within_sort=[("id", False)]),
    # expression and string keys
    "expr-if": dict(group_by="IF(price > 1, g, 100 + g)",
                    select=["count(*)", "sum(price)"]),
    "expr-in": dict(group_by="g IN (1, 3, 5)", select=["count(*)"]),
    "expr-interval": dict(group_by="INTERVAL(year, 2005, 2010, 2020)",
                          select=["avg(price)"]),
    "expr-date": dict(group_by="YEAR(ts)", select=["count(*)"],
                      sort=[("@count", False)]),
    "expr-month": dict(group_by="MONTH(ts)", select=["count(*)"]),
    "expr-fib": dict(group_by="FIBONACCI(g * 9)", select=["count(*)"]),
    "expr-arith": dict(group_by="year * 3 - g", select=["count(*)"]),
    "string-key": dict(group_by="s", select=["count(*)", "avg(price)"],
                       sort=[("s", True)]),
    "agg-expr": dict(group_by="g", select=["sum(price * 2 + year)",
                                           "avg(year % 3)"]),
    # GROUP_CONCAT and HAVING on a float aggregate
    "group-concat": dict(group_by="g", select=["count(*)",
                                               "group_concat(year)"]),
    "having-avg": dict(group_by="g", select=["avg(year)"],
                       having=("avg(year)", ">", 2011.5)),
}

HOST_CASES = {
    "mva-key": dict(group_by="tags", select=["count(*)", "sum(year)"]),
    "bigint-key": dict(group_by="big", select=["count(*)"], limit=30),
    "bigint-expr": dict(group_by="big % 5", select=["count(*)"]),
    "json-key": dict(group_by="meta.a", select=["count(*)", "avg(year)"]),
    "json-key-str": dict(group_by="meta.b", select=["count(*)"]),
    "group-n-by": dict(group_by="g", select=["count(*)"], group_n=2),
    "within-string": dict(group_by="g", select=["count(*)"],
                          within_sort=[("s", False)]),
    "count-distinct-id": dict(group_by="g", select=["count(*)",
                                                    "count(distinct id)"]),
    "mva-having": dict(group_by="tags", select=["count(*)"],
                       having=("count(*)", ">=", 40)),
}

LATE_AND_JSON_CASES = {
    "late-expr": dict(filters=[_f("year+1", "range_i", lo=2005, hi=2012)]),
    "late-expr-exclude": dict(filters=[_f("g*2", "values", values=[2, 8],
                                          exclude=True)]),
    "late-mva64": dict(filters=[_f("tags", "values", values=[3, 2**33])]),
    "late-mva64-range": dict(filters=[_f("tags", "range_i", lo=-(2**32),
                                         hi=5)]),
    "late-grouped": dict(group_by="g", select=["count(*)", "year"],
                         filters=[_f("year%4", "values", values=[1])]),
    "json-order-asc": dict(sort=[("meta.a", True)]),
    "json-order-desc": dict(sort=[("meta.a", False), ("id", True)],
                            limit=15, offset=3),
    "json-order-str": dict(sort=[("meta.b", True)]),
}


def _query(kw: dict, match: str) -> SearchQuery:
    kw = dict(kw)
    kw.setdefault("limit", 20)
    return SearchQuery(match=match, max_matches=N_DOCS, **kw)


@pytest.mark.parametrize("mode", ["never", "auto", "always"])
@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_device_group_by_matches_jax(pair, monkeypatch, case, mode):
    jax_idx, idx = pair
    _mode(monkeypatch, mode, jax_idx, idx)
    q = _query(DEVICE_CASES[case], "w1 | w3")
    if mode == "always" and "group_concat" not in str(q.select):
        assert idx._plan_grouped(q)[0].sig.sparse
    want = _check(jax_idx, idx, q)
    assert want["total_found"] > 0


@pytest.mark.parametrize("case", ["count", "all-aggs", "order-rowid",
                                  "within-float", "expr-date"])
def test_matchless_group_by_matches_jax(pair, monkeypatch, case):
    jax_idx, idx = pair
    _mode(monkeypatch, "auto", jax_idx, idx)
    _check(jax_idx, idx, _query(DEVICE_CASES[case], ""))


@pytest.mark.parametrize("mode", ["never", "always"])
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_routed_group_by_matches_jax(pair, monkeypatch, case, mode):
    jax_idx, idx = pair
    _mode(monkeypatch, mode, jax_idx, idx)
    assert _check(jax_idx, idx, _query(HOST_CASES[case], "w2"))[
        "total_found"] > 0


@pytest.mark.parametrize("mode", ["never", "always"])
@pytest.mark.parametrize("case", sorted(LATE_AND_JSON_CASES))
def test_late_filters_and_json_order_match_jax(pair, monkeypatch, case,
                                               mode):
    jax_idx, idx = pair
    _mode(monkeypatch, mode, jax_idx, idx)
    assert _check(jax_idx, idx, _query(LATE_AND_JSON_CASES[case], "w4 | w5"))[
        "total_found"] > 0


def test_run_late_filtered_matches_jax(pair):
    jax_idx, idx = pair
    q = _query(LATE_AND_JSON_CASES["late-expr"], "w4")
    late = q.filters
    assert _summary(run_late_filtered(idx.search, q, late)) == \
        _summary(jax_idx.search(_jax_query(q)))


def _random_grouped(rng: np.random.RandomState) -> SearchQuery:
    keys = ["g", "year % 5", "s", "INTERVAL(price, 0, 5)", "MONTH(ts)"]
    orders = [None, [("@count", False)], [("@count", True)],
              [("@groupby", True)], [("id", True)], [("year", False)],
              [("price", False)], [("weight()", False)]]
    withins = [None, [("year", True)], [("price", False)], [("id", True)],
               [("weight()", False)]]
    sel = list(rng.choice(AGGS, rng.randint(1, 5), replace=False))
    match = ["w1", "w2 | w6", "w0 w3", "w7 | w8 | w9", ""][rng.randint(5)]
    filters = ([_f("year", "range_i", lo=2004, hi=2019)]
               if rng.rand() < 0.3 else [])
    return SearchQuery(match=match, group_by=keys[rng.randint(len(keys))],
                       select=sel, sort=orders[rng.randint(len(orders))],
                       within_sort=withins[rng.randint(len(withins))],
                       filters=filters, limit=int(rng.randint(3, 12)),
                       max_matches=N_DOCS)


@pytest.mark.parametrize("mode", ["never", "auto", "always"])
def test_random_grouped_queries_match_jax(pair, monkeypatch, mode):
    jax_idx, idx = pair
    _mode(monkeypatch, mode, jax_idx, idx)
    rng = np.random.RandomState({"never": 1, "auto": 2, "always": 3}[mode])
    qs = [_random_grouped(rng) for _ in range(8)]
    want = [_summary(jax_idx.search(_jax_query(q))) for q in qs]
    assert [_summary(idx.search(q)) for q in qs] == want
    assert [_summary(r) for r in idx.search_batch(qs)] == want


@pytest.mark.parametrize("mode", ["never", "always"])
def test_mixed_search_batch_is_one_decode_round(pair, monkeypatch, mode):
    """Ranked, device-grouped, host-grouped, late-filtered and JSON-ordered
    queries in one search_batch: one grouped decode, one segment sum per
    float aggregate, results equal to JAX's search one by one."""
    jax_idx, idx = pair
    _mode(monkeypatch, mode, jax_idx, idx)
    qs = ([_query(DEVICE_CASES[c], "w1 | w3") for c in
           ("all-aggs", "within-attr", "group-concat", "string-key")]
          + [_query(HOST_CASES[c], "w2") for c in
             ("mva-key", "json-key", "count-distinct-id")]
          + [_query(LATE_AND_JSON_CASES[c], "w4 | w5") for c in
             ("late-expr", "json-order-desc", "late-grouped")]
          + [SearchQuery(match="w1 w2", limit=10),
             SearchQuery(match="w6", sort=[("price", False)], limit=10)])
    want = [_summary(jax_idx.search(_jax_query(q))) for q in qs]
    ps.LAUNCHES.reset()
    port_groupby.LAUNCHES.reset()
    got = [_summary(r) for r in idx.search_batch(qs)]
    assert got == want
    assert ps.LAUNCHES.plain == 1 and ps.LAUNCHES.kernel == 0
    # all-aggs: sum(price), avg(year), avg(price); within-attr: sum(price)
    assert port_groupby.LAUNCHES.plain == 4
    assert port_groupby.LAUNCHES.kernel == 0


def test_ranked_batch_matches_jax_search_batch(pair, monkeypatch):
    """Device-routable grouped queries beside ranked ones: the port's
    search_batch equals the JAX package's search_batch too."""
    jax_idx, idx = pair
    _mode(monkeypatch, "auto", jax_idx, idx)
    qs = [_query(DEVICE_CASES[c], m) for c, m in
          (("count", "w1"), ("all-aggs", "w2 | w3"), ("expr-if", "w5"),
           ("order-count-desc", "w1"))] + [SearchQuery(match="w3", limit=5)]
    want = [_summary(r) for r in jax_idx.search_batch(
        [_jax_query(q) for q in qs])]
    assert [_summary(r) for r in idx.search_batch(qs)] == want


@pytest.mark.parametrize("seed", range(3))
def test_segment_sum_plain_matches_xla_scatter(seed):
    """The plain ordered segment sum against jnp's .at[].add on the CPU:
    sorted runs with a sink, order-sensitive values, -0.0, empty groups
    and scattered ids; bit-exact."""
    rng = np.random.RandomState(seed)
    n = 3000
    vals = rng.choice(np.asarray([1e8, 1.0, -1e8, 0.5, -0.0, 3.25, 1e-7],
                                 np.float32), n)
    gid = np.sort(rng.randint(0, 40, n)).astype(np.int32)
    gid[-500:] = n - 1                     # the sink run
    vals[-500:] = 0.0
    if seed == 2:
        gid = rng.randint(0, 60, n).astype(np.int32)   # not contiguous
    want = np.asarray(jnp.zeros(n, jnp.float32).at[jnp.asarray(gid)].add(
        jnp.asarray(vals)))
    port_groupby.LAUNCHES.reset()
    got = port_groupby.segment_sum_ordered(
        torch.from_numpy(vals), torch.from_numpy(gid), n).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()
    assert port_groupby.LAUNCHES.plain == 1


def _segment_cases(rng):
    """The six shapes of ``chip_smoke.segment_cases`` at a small size:
    (name, values, gid, n_out)."""
    f32, i32 = np.float32, np.int32
    n = 1 << 12
    big = (rng.randn(n) * 10.0 ** rng.randint(-3, 9, n)).astype(f32)
    runs = np.sort(rng.randint(0, 100, 3000)).astype(i32)
    sink_n = 7000
    negz = np.where(rng.rand(2000) < 0.5, f32(-0.0),
                    rng.randn(2000).astype(f32))
    negz[:100] = -0.0
    return [
        ("1-member groups", rng.randn(1000).astype(f32),
         np.arange(1000, dtype=i32), 1000),
        ("one long group", big, np.zeros(n, i32), n),
        ("groups then a sink run",
         np.concatenate([rng.randn(3000).astype(f32) * 1000,
                         np.zeros(sink_n, f32)]),
         np.concatenate([runs, np.full(sink_n, 9_999, i32)]), 10_000),
        ("no eligible entry", np.zeros(n, f32), np.full(n, n - 1, i32), n),
        ("1e8, 1, -1e8, 1 patterns",
         np.tile(np.asarray([1e8, 1, -1e8, 1], f32), 500),
         np.repeat(np.arange(100, dtype=i32), 20), 100),
        ("-0.0 values", negz, np.repeat(np.arange(200, dtype=i32), 10), 200),
    ]


@pytest.mark.parametrize("case", range(6))
def test_segment_sum_plain_on_kernel_check_shapes(case):
    """The plain version against jnp's .at[].add on each shape the card's
    check uses (chip_smoke phase 14), bit-exact; each shape keeps the
    kernel's contract (nondecreasing ids in [0, n_out))."""
    name, vals, gid, n_out = _segment_cases(np.random.RandomState(5))[case]
    check_sorted_ids(torch.from_numpy(gid), n_out)
    want = np.asarray(jnp.zeros(n_out, jnp.float32).at[jnp.asarray(gid)].add(
        jnp.asarray(vals)))
    got = port_groupby.segment_sum_plain(
        torch.from_numpy(vals), torch.from_numpy(gid), n_out).numpy()
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist(), name


def test_group_by_calls_keep_the_kernel_contract(pair, monkeypatch,
                                                 sorted_ids_contract):
    """Float SUM and AVG of every device group-by case, dense and sparse:
    the tail's segment sums pass nondecreasing ids in [0, n_out), the
    sink last, and the results still equal JAX's."""
    jax_idx, idx = pair
    for mode in ("never", "always"):
        _mode(monkeypatch, mode, jax_idx, idx)
        for case in ("all-aggs", "within-attr"):
            q = _query(DEVICE_CASES[case], "w1 | w2")
            want = _summary(jax_idx.search(_jax_query(q)))
            assert _summary(idx.search(q)) == want
    assert len(sorted_ids_contract.checked) >= 6
