"""Port parity: the main search path, JAX SearchIndex vs the port on the CPU.

The same PackedIndex goes to ``manticoresearch_tpu.exec.searcher``
(XLA on the CPU) and, carried across with ``from_jax_packed``, to
``manticoresearch_tpu_torch.exec.searcher`` with ``device="cpu"`` (plain
PyTorch, the bit-plane decode's plain version).
Covered: the example.sql corpus in the slice's shapes (single / AND / OR /
NOT / quorum / MAYBE, range and values filters, ORDER BY attr / id,
offset / limit, delete, rankers proximity_bm25 / proximity / bm25 / none /
fieldmask, so ws_bm25, ws and the LCS path all run), and a seeded random
differential of config-1/2 queries over ``bench.build_corpus`` with packed
and residual term slots, through ``search`` and ``search_batch``; each
call decodes all its packed windows in one grouped decode.

Tolerance: exact. Weights are integers computed by the reference formulas;
docids, totals and word stats are integers and strings.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import bench
from manticoresearch_tpu.exec.searcher import SearchIndex as JaxIndex
from manticoresearch_tpu.exec.searcher import SearchQuery as JaxQuery
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.query.planner import AttrFilterDef as JaxFilter
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops.device_index import from_jax_packed
from manticoresearch_tpu_torch.ops.packed_store import PACK_MIN
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

from .test_search import DOCS

torch.set_num_threads(2)

SCHEMA = Schema(fields=["title", "content"],
                attrs=[AttrDef("group_id", AttrType.UINT),
                       AttrDef("group_id2", AttrType.UINT)])


def _jax_query(q: SearchQuery) -> JaxQuery:
    kw = {f.name: getattr(q, f.name) for f in fields(q)}
    kw["filters"] = [JaxFilter(**{f.name: getattr(x, f.name)
                                  for f in fields(x)}) for x in q.filters]
    return JaxQuery(**kw)


def _port(packed) -> SearchIndex:
    """The port's index on the CPU over a copy of a JAX-built index."""
    return SearchIndex(from_jax_packed(packed), "cpu")


def _summary(r):
    return dict(matches=[(m.docid, m.weight, m.attrs) for m in r.matches],
                total=r.total, total_found=r.total_found,
                words=[(w.word, w.docs, w.hits) for w in r.word_stats],
                error=r.error)


def _example_index():
    b = IndexBuilder(SCHEMA)
    b.add_documents(DOCS)
    return b.build()


@pytest.fixture(scope="module")
def example():
    packed = _example_index()
    return JaxIndex(packed), _port(packed)


def _f(attr, kind, **kw):
    return [AttrFilterDef(attr, kind, **kw)]


EXAMPLE_QUERIES = [
    dict(match="test"),
    dict(match="TEST"),
    dict(match="zzzmissing"),
    dict(match="test one"),
    dict(match="my test document"),
    dict(match="groups | phrases"),
    dict(match="test -two"),
    dict(match="test one | groups"),
    dict(match="(one | two) document"),
    dict(match='"this my document test"/3'),
    dict(match="test MAYBE one"),
    dict(match="test", filters=_f("group_id", "values", values=[1])),
    dict(match="test", filters=_f("group_id", "values", values=[1],
                                  exclude=True)),
    dict(match="this is", filters=_f("group_id2", "range_i", lo=6, hi=7)),
    dict(match="this", filters=_f("group_id2", "range_i", lo=6,
                                  exclude=True)),
    dict(match=""),
    dict(match="", limit=2, offset=1),
    dict(match="this", sort=[("group_id2", False)]),
    dict(match="test", sort=[("group_id2", True)]),
    dict(match="this", sort=[("id", False)], limit=3, offset=1),
    dict(match="test", ranker="bm25"),
    dict(match="test one", ranker="proximity"),
    dict(match="test", ranker="proximity"),
    dict(match="this is", ranker="none"),
    dict(match="test", ranker="fieldmask"),
    dict(match="test document", field_weights={"title": 10, "content": 3}),
    dict(match="test", field_weights={"title": 7}),
    dict(match="test this", select=["group_id"]),
]


@pytest.mark.parametrize("kw", EXAMPLE_QUERIES,
                         ids=[str(i) for i in range(len(EXAMPLE_QUERIES))])
def test_example_corpus_matches_jax(example, kw):
    jax_idx, idx = example
    q = SearchQuery(**kw)
    want = _summary(jax_idx.search(_jax_query(q)))
    assert _summary(idx.search(q)) == want
    assert _summary(idx.search_batch([q])[0]) == want


def test_example_effective_rankers(example):
    _, idx = example
    rankers = {idx.plan(SearchQuery(**kw)).sig.ranker
               for kw in EXAMPLE_QUERIES}
    assert {"ws_bm25", "ws", "proximity_bm25", "proximity", "none",
            "fieldmask"} <= rankers


def test_delete_matches_jax():
    packed = _example_index()
    jax_idx, idx = JaxIndex(packed), _port(packed)
    assert idx.delete_documents([2]) == jax_idx.delete_documents([2]) == 1
    assert idx.delete_documents([2]) == 0
    for kw in (dict(match="test"), dict(match="this is"), dict(match="")):
        q = SearchQuery(**kw)
        assert _summary(idx.search(q)) == \
            _summary(jax_idx.search(_jax_query(q)))


def test_out_of_slice_shapes_raise(example):
    """ranker=expr, sph04 and PACKEDFACTORS() still raise. GROUP BY, a
    filter on an expression (or on a dotted name that is no JSON path) and
    ORDER BY a dotted name now run, with the JAX package's results."""
    jax_idx, idx = example
    with pytest.raises(NotImplementedError, match="PACKEDFACTORS"):
        idx.search(SearchQuery(match='"test one"',
                               select=["id", "PACKEDFACTORS()"]))
    with pytest.raises(NotImplementedError, match="ranker=expr"):
        idx.search(SearchQuery(match="test", ranker=("expr", "bm25")))
    with pytest.raises(NotImplementedError, match="ranker=sph04"):
        idx.search_batch([SearchQuery(match="@title test", ranker="sph04")])
    for q in (SearchQuery(match="test", group_by="group_id"),
              SearchQuery(match="test", filters=_f(
                  "group_id*2", "range_i", lo=0, hi=4)),
              SearchQuery(match="", filters=_f(
                  "group_id.x", "values", values=[1])),
              SearchQuery(match="test", sort=[("meta.a", True)])):
        want = _summary(jax_idx.search(_jax_query(q)))
        assert _summary(idx.search(q)) == want
        assert _summary(idx.search_batch([q])[0]) == want


@pytest.mark.parametrize("kw", [
    dict(sort=[("score", True)]),
    dict(sort=[("score", False)]),
    dict(sort=[("score", False)], filters=_f("score", "range_f", lo=-0.5,
                                              hi=0.25, hi_excl=True)),
    dict(filters=_f("score", "range_f", lo=0.0, lo_excl=True)),
], ids=["asc", "desc", "desc-range", "gt0"])
def test_float_attr_order_and_filter_match_jax(kw):
    """Float ORDER BY keys with ties, negatives and zeros, and range_f
    filters."""
    scores = [0.5, 0.0, 0.0, -1.25, 0.5, 3.0, -1.25, 0.25, 0.0, -0.5]
    b = IndexBuilder(Schema(fields=["body"],
                            attrs=[AttrDef("score", AttrType.FLOAT)]))
    b.add_documents([dict(id=i + 1, score=v, body=f"common w{i % 3}")
                     for i, v in enumerate(scores)])
    packed = b.build()
    q = SearchQuery(match="common", **kw)
    want = _summary(JaxIndex(packed).search(_jax_query(q)))
    assert len(want["matches"]) >= 4
    assert _summary(_port(packed).search(q)) == want


@pytest.fixture(scope="module")
def wide_pair():
    """40 words over 300 docs, a string and a uint attr with values past
    2^31."""
    rng = np.random.RandomState(1)
    words = [f"w{i}" for i in range(40)]
    b = IndexBuilder(Schema(fields=["body"],
                            attrs=[AttrDef("color", AttrType.STRING),
                                   AttrDef("g", AttrType.UINT)]))
    b.add_documents([dict(id=i + 1, body=" ".join(rng.choice(words, 8)),
                          color=["red", "Green", "blue"][i % 3],
                          g=int(rng.randint(0, 2**32)))
                     for i in range(300)])
    packed = b.build()
    return JaxIndex(packed), _port(packed)


_WIDE_OR = " | ".join(f"w{i}" for i in range(33))
WIDE_QUERIES = [
    dict(match=_WIDE_OR),                    # 33 slots: two mask words
    dict(match="w1", filters=_f("color", "values", values=["red", "blue"])),
    dict(match="w2 | w3", filters=_f("color", "range_i", lo="blue",
                                     hi="red")),
    dict(match="w1", filters=_f("g", "range_i", lo=2**31, hi=2**32 - 1)),
    dict(match="w4", sort=[("color", True)]),
    dict(match="w5", sort=[("g", False)]),
    dict(match="w1 | w2", filter_tree=("or", (("leaf", 0), ("leaf", 1))),
         filters=_f("g", "range_i", hi=2**30)
         + _f("color", "values", values=["Green"])),
]


@pytest.mark.parametrize("kw", WIDE_QUERIES,
                         ids=[str(i) for i in range(len(WIDE_QUERIES))])
def test_wide_queries_and_attr_filters_match_jax(wide_pair, kw):
    """More than 32 term slots (bit 31 and a second termmask word), string
    ordinal filters and order, unsigned uint compares, an OR filter tree."""
    jax_idx, idx = wide_pair
    q = SearchQuery(**kw)
    want = _summary(jax_idx.search(_jax_query(q)))
    assert want["total_found"] > 0
    assert _summary(idx.search(q)) == want


# --------------------------------------------------------------------------
# random differential: bench config 1/2 shapes on a small bench corpus
# --------------------------------------------------------------------------
N_RANDOM = 40


@pytest.fixture(scope="module")
def bench_pair():
    packed = bench.build_corpus(3000, 400, 30)
    return packed, JaxIndex(packed), _port(packed)


def _random_queries(packed, n, seed=5):
    """config 1 (single term) and config 2 (AND / OR, 10% with the year
    range filter) over terms from the packed and the residual stream."""
    rng = np.random.RandomState(seed)
    df = packed.term_docs
    hot = [t for t in range(len(df)) if df[t] >= PACK_MIN][:40]
    cold = [t for t in range(len(df)) if 0 < df[t] < PACK_MIN][:40]
    width = max(4, len(str(400 - 1)))

    def term():
        pool = hot if rng.rand() < 0.6 else cold
        return f"t{pool[rng.randint(len(pool))]:0{width}d}"

    out = []
    for i in range(n):
        r = rng.rand()
        if i % 2 == 0 or r < 0.4:
            out.append(SearchQuery(match=term(), limit=10))
        elif r < 0.7:
            out.append(SearchQuery(match=f"{term()} {term()}", limit=10))
        elif r < 0.9:
            out.append(SearchQuery(match=f"{term()} | {term()}", limit=10))
        else:
            out.append(SearchQuery(
                match=f"{term()} {term()}", limit=10,
                filters=_f("year", "range_i", lo=2005, hi=2018)))
    return out


def test_random_differential_matches_jax(bench_pair):
    packed, jax_idx, idx = bench_pair
    queries = _random_queries(packed, N_RANDOM)
    plans = [idx.plan(q) for q in queries]
    packed_slots = sum(bool(p[0]) for cq in plans for p in cq.sig.slot_packed)
    residual_slots = sum(not p[0] for cq in plans for p in cq.sig.slot_packed)
    assert packed_slots >= 10 and residual_slots >= 10
    assert {cq.sig.ranker for cq in plans} == {"ws_bm25", "proximity_bm25"}
    assert any(cq.sig.filters for cq in plans)
    assert not any(cq.sig.sparse for cq in plans)

    want = [_summary(jax_idx.search(_jax_query(q))) for q in queries]
    assert sum(w["total_found"] > 0 for w in want) >= N_RANDOM // 2
    assert [_summary(idx.search(q)) for q in queries] == want
    assert [_summary(r) for r in idx.search_batch(queries)] == want


def test_one_grouped_decode_per_call(bench_pair):
    """``search_batch`` decodes the packed windows of every query of the
    batch, across plan-shape groups, in one grouped decode; ``search``
    makes one too."""
    packed, _, idx = bench_pair
    queries = _random_queries(packed, 16)
    plans = [idx.plan(q) for q in queries]
    assert len({(cq.sig, cq.slot_pb, cq.slot_hb) for cq in plans}) >= 3
    assert sum(p[0] for cq in plans for p in cq.sig.slot_packed) >= 4
    ps.LAUNCHES.reset()
    idx.search_batch(queries)
    assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (1, 0)
    packed_q = next(q for q, cq in zip(queries, plans)
                    if cq.sig.slot_packed[0][0])
    ps.LAUNCHES.reset()
    idx.search(packed_q)
    assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (1, 0)
