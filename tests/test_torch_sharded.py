"""Port parity: the distributed index, JAX ShardedIndex vs the port's.

The same shards (built by the JAX package's builder and carried across
with ``from_jax_packed``) go to ``manticoresearch_tpu.parallel.sharded``'s
``ShardedIndex`` on the 8-device CPU mesh that ``tests/conftest.py`` sets
up (``shard_map``, ``all_gather``, ``lax.sort``) and to the port's
``ShardedIndex(..., "cpu")`` (shards as a leading tensor dimension, the
merge in torch, the bit-plane decode's plain version). Covered:

- every case of ``tests/test_sharded.py``: its queries and positional
  queries, GROUP BY (the host-merge fallback), ORDER BY an attribute,
  the 4-shard attribute order in both directions on an int and a float
  key with the port's host-merge fallback patched to raise,
  ``search_batch`` equal to ``search``, mixed plan shapes;
- the sharded arm of ``tests/test_differential.py`` (random MATCH shapes,
  rankers and filters, string filters through the fallback) at three
  seeds, through one ``search_batch`` each;
- float ORDER BY keys holding -0.0, +0.0, +-inf, NaN and ties, ascending
  and descending (``lax.sort`` holds -0.0 equal to +0.0 and every NaN
  last);
- uneven shards: different sizes, and one shard holding a term at a far
  higher document frequency than the others, so the common slot windows
  run past the small shards' own postings into the union's padding;
- a bench-corpus batch (``bench.build_corpus_shards``, packed slots): one
  grouped decode per merged ``search_batch`` (``LAUNCHES.plain`` on the
  CPU), none for a fallback-only batch, and docids, weights and totals
  equal to the port's single index over the same documents.

Tolerance: exact. Weights are integers, docids, totals, word stats and
attributes integers, strings and float32 values copied from the shards;
grouped aggregates (float sums included) compare exactly.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import bench
from manticoresearch_tpu.exec.searcher import SearchQuery as JaxQuery
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.parallel.sharded import ShardedIndex as JaxSharded
from manticoresearch_tpu.parallel.sharded import (make_mesh,
                                                  partition_documents)
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops.device_index import from_jax_packed
from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex

from . import test_differential as tdiff
from . import test_sharded as tsh
from .test_torch_search import _jax_query

torch.set_num_threads(2)


def _port_query(jq: JaxQuery) -> SearchQuery:
    from manticoresearch_tpu_torch.query.planner import AttrFilterDef
    kw = {f.name: getattr(jq, f.name) for f in fields(jq)}
    kw["filters"] = [AttrFilterDef(**{f.name: getattr(x, f.name)
                                      for f in fields(x)})
                     for x in jq.filters]
    return SearchQuery(**kw)


def _summary(r):
    return dict(matches=[(m.docid, m.weight, m.attrs) for m in r.matches],
                total=r.total, total_found=r.total_found,
                words=[(w.word, w.docs, w.hits) for w in r.word_stats],
                error=r.error)


def _build(schema, docs):
    b = IndexBuilder(schema)
    b.add_documents(docs)
    return b.build()


def _pair(shards):
    """(JAX ShardedIndex on a mesh of len(shards) CPU devices, the port's
    ShardedIndex on the CPU) over the same shards."""
    return (JaxSharded(shards, make_mesh(len(shards))),
            ShardedIndex([from_jax_packed(s) for s in shards], "cpu"))


def _assert_batch_matches_jax(jax_idx, idx, jqs):
    got = idx.search_batch([_port_query(q) for q in jqs])
    for q, r in zip(jqs, got):
        assert _summary(r) == _summary(jax_idx.search(q)), (q.match, q.sort)
    return got


@pytest.fixture(scope="module")
def small():
    parts = partition_documents(tsh.make_docs(), 8)
    return _pair([_build(tsh.SCHEMA, p) for p in parts])


_CASES = list(tsh.QUERIES) + list(tsh.QUERIES_POSITIONAL) + [
    JaxQuery(match="alpha", sort=[("year", False)], limit=20),
    JaxQuery(match="", group_by="year", select=["count(*)", "sum(score)"],
             sort=[("year", True)], limit=50),
]


@pytest.mark.parametrize("qi", range(len(_CASES)))
def test_sharded_matches_jax(small, qi):
    jax_idx, idx = small
    q = _CASES[qi]
    want = _summary(jax_idx.search(q))
    assert want["error"] is None
    assert _summary(idx.search(_port_query(q))) == want


def test_search_batch_equals_sequential(small):
    jax_idx, idx = small
    gq = JaxQuery(match="alpha", group_by="year", select=["count(*)"],
                  sort=[("year", True)], limit=50)
    batch = list(tsh.QUERIES) + list(tsh.QUERIES_POSITIONAL) + [gq]
    got = _assert_batch_matches_jax(jax_idx, idx, batch)
    for q, r in zip(batch, got):
        assert _summary(r) == _summary(idx.search(_port_query(q)))


def test_search_batch_mixed_shapes(small):
    jax_idx, idx = small
    batch = [JaxQuery(match=m) for m in
             ("alpha", "beta", "gamma", "search engine", "kappa", "zeta")]
    _assert_batch_matches_jax(jax_idx, idx, batch)


def test_attr_order_takes_merged_path(monkeypatch):
    """A numeric attribute ORDER BY (int and float, asc and desc) runs on
    the merged path: the host-merge fallback must not be reached."""
    schema = Schema(fields=["c"], attrs=[AttrDef("price", AttrType.UINT),
                                         AttrDef("score", AttrType.FLOAT)])
    docs = [dict(id=i, c="word common", price=(i * 37) % 100,
                 score=((i * 13) % 50) / 2.0) for i in range(1, 201)]
    jax_idx, idx = _pair([_build(schema, p)
                          for p in partition_documents(docs, 4)])

    def boom(q):
        raise AssertionError("host fallback used for attr order")
    monkeypatch.setattr(idx, "_per_shard_search", boom)
    monkeypatch.setattr(jax_idx, "_per_shard_search", boom)
    jqs = [JaxQuery(match="common", limit=20, sort=[(col, asc), ("id", True)])
           for col in ("price", "score") for asc in (True, False)]
    got = _assert_batch_matches_jax(jax_idx, idx, jqs)
    for q, r in zip(jqs, got):
        col, asc = q.sort[0]
        want = sorted(docs, key=lambda d: (d[col] if asc else -d[col],
                                           d["id"]))[:20]
        assert [(m.attrs[col], m.docid) for m in r.matches] == \
            [(d[col], d["id"]) for d in want]


@pytest.fixture(scope="module")
def differential():
    parts = partition_documents(tdiff.make_docs(), 8)
    return _pair([_build(tdiff.SCHEMA, p) for p in parts])


@pytest.mark.parametrize("seed", [99, 5, 17])
def test_differential_sharded_matches_jax(differential, seed):
    """The sharded arm of tests/test_differential.py: random queries over
    its corpus in 8 shards, as one port batch, each equal to JAX's."""
    jax_idx, idx = differential
    rng = np.random.RandomState(seed)
    _assert_batch_matches_jax(jax_idx, idx,
                              [tdiff.random_query(rng) for _ in range(10)])


FLOAT_VALUES = np.asarray(
    [-0.0, 0.0, np.inf, -np.inf, np.nan, 1.5, 1.5, -2.25, 0.0, -0.0, 1.5,
     -np.nan, 3.0, -0.0], np.float32)


@pytest.mark.parametrize("asc", [True, False])
def test_float_keys_match_jax(asc):
    """ORDER BY a float attribute of -0.0, +0.0, +-inf, NaN of both signs
    and ties, through the merged path on 4 shards. (The builder stores
    neither -0.0 nor inf, so the values are written into the shards'
    float columns after the build, as an attribute update would.) Results
    compare by ``repr``, so that -0.0 differs from +0.0 and NaN equals
    NaN. The windows stop where the JAX package's own merge breaks: NaN
    keys sort after the pad key of a shard's unmatched rows, which then
    reach the result (ROADMAP queue 3)."""
    schema = Schema(fields=["c"], attrs=[AttrDef("f", AttrType.FLOAT)])
    docs = [dict(id=i + 1, c="word common" if i % 5 else "word", f=0.0)
            for i in range(60)]
    shards = [_build(schema, p) for p in partition_documents(docs, 4)]
    for s in shards:
        s.attrs_float["f"][:] = FLOAT_VALUES[(s.doc_ids * 5)
                                             % len(FLOAT_VALUES)]
    jax_idx, idx = _pair(shards)
    jqs = [JaxQuery(match=m, limit=lim, sort=[("f", asc)])
           for m, lims in (("common", (7, 20, 40, 48)), ("word", (7, 20)))
           for lim in lims]
    got = idx.search_batch([_port_query(q) for q in jqs])
    for q, r in zip(jqs, got):
        assert repr(_summary(r)) == repr(_summary(jax_idx.search(q))), \
            (q.match, q.limit)
    stored = np.asarray([m.attrs["f"] for r in got for m in r.matches],
                        np.float32)
    assert (np.signbit(stored) & (stored == 0)).any()
    assert ((stored == 0) & ~np.signbit(stored)).any()
    assert np.isnan(stored).any() and np.isinf(stored).any()


def test_uneven_shards_match_jax():
    """Three shards of 1,500, 40 and 300 documents; "hot" in every
    document of the first, two of the second, half of the third: the
    common slot window of the first shard's df runs past the small
    shards' own packed and raw postings."""
    schema = Schema(fields=["title", "body"],
                    attrs=[AttrDef("g", AttrType.UINT)])
    rng = np.random.RandomState(4)
    words = [f"w{i}" for i in range(20)]

    def docs(lo, n, hot_every):
        return [dict(id=lo + i, g=int(rng.randint(0, 9)),
                     title=words[int(rng.randint(0, 20))],
                     body=" ".join(
                         [words[int(z) % 20] for z in rng.zipf(1.4, 6)]
                         + (["hot"] if i % hot_every == 0 else [])))
                for i in range(n)]
    shards = [_build(schema, docs(1, 1500, 1)),
              _build(schema, docs(5001, 40, 20)),
              _build(schema, docs(9001, 300, 2))]
    dfs = [int(s.term_docs[s.term_id("hot")]) for s in shards]
    assert dfs == [1500, 2, 150]
    jax_idx, idx = _pair(shards)
    assert idx.n_common == 1500
    _assert_batch_matches_jax(jax_idx, idx, [
        JaxQuery(match=m) for m in ("hot", "hot w1", "hot | w3",
                                    '"hot w2"', "w1 -hot")] + [
        JaxQuery(match=m, sort=[("g", False)], limit=40)
        for m in ("hot", "hot | w3")])


@pytest.fixture(scope="module")
def bench_shards():
    jax_shards = bench.build_corpus_shards(4000, 400, 30, 8)
    jax_idx, idx = _pair(jax_shards)
    single = SearchIndex(bench_corpus.build_corpus(4000, 400, 30), "cpu")
    gen = bench_corpus.WorkloadGen(np.random.RandomState(3), 400,
                                   single.packed)
    batch = ([SearchQuery(match=gen.term()[1], limit=10) for _ in range(8)]
             + gen.config2(8)[1])
    return jax_idx, idx, single, batch


def test_one_grouped_decode_per_merged_batch(bench_shards):
    jax_idx, idx, single, batch = bench_shards
    cqs = [idx.plan(q) for q in batch]
    assert sum(bool(p[0]) for cq in cqs for p in cq.sig.slot_packed) > 4
    ps.LAUNCHES.reset()
    got = idx.search_batch(batch)
    assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (1, 0)
    for q, r in zip(batch, got):
        assert _summary(r) == _summary(jax_idx.search(_jax_query(q)))
        one = single.search(q)
        assert r.total_found == one.total_found
        assert [(m.docid, m.weight) for m in r.matches] == \
            [(m.docid, m.weight) for m in one.matches]
    # a batch that only takes the host-merge fallback makes no merged
    # decode (each shard's own search decodes its windows)
    grouped = [SearchQuery(match=batch[0].match, group_by="group_id",
                           select=["count(*)"], limit=5)]
    ps.LAUNCHES.reset()
    r = idx.search_batch(grouped)[0]
    assert ps.LAUNCHES.plain == len(idx.shards)
    assert _summary(r) == _summary(jax_idx.search(_jax_query(grouped[0])))
