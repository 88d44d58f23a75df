"""Port parity: the sparse candidate pipeline and the filter-first scan,
JAX SearchIndex vs the port on the CPU.

The same PackedIndex goes to ``manticoresearch_tpu.exec.searcher`` (XLA on
the CPU) and, carried across with ``from_jax_packed``, to
``manticoresearch_tpu_torch.exec.searcher`` with ``device="cpu"`` (plain
PyTorch, the bit-plane decode's plain version). ``MT_SPARSE=always``
forces the planner's sparse union plan (``sig.sparse``) for every query
that can take it; the filter-first plan (``sig.scan_index``) comes from
the planner's own choice on a selective filter. Both scan helpers are held
against their JAX versions on seeded arrays.

Tolerance: exact. Weights are integers computed by the reference formulas;
docids, totals and word stats are integers and strings; the scan helpers
return integers, booleans and copied float32 payloads.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from manticoresearch_tpu.exec.searcher import SearchIndex as JaxIndex
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.ops import search as jax_search
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.exec.searcher import SearchQuery
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops import search as port_search
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

from .test_torch_search import (EXAMPLE_QUERIES, _example_index, _jax_query,
                                _port, _random_queries, _summary)

torch.set_num_threads(2)


def _mode(monkeypatch, mode: str, *indexes) -> None:
    """Set MT_SPARSE and drop the indexes' cached plans."""
    monkeypatch.setenv("MT_SPARSE", mode)
    for idx in indexes:
        idx._plan_cache.clear()


def _check(jax_idx, idx, q: SearchQuery) -> dict:
    """The port's search and search_batch against JAX's search; -> the
    JAX summary."""
    want = _summary(jax_idx.search(_jax_query(q)))
    assert want["error"] is None
    assert _summary(idx.search(q)) == want
    assert _summary(idx.search_batch([q])[0]) == want
    return want


# --------------------------------------------------------------------------
# forced sparse union
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def example():
    packed = _example_index()
    return JaxIndex(packed), _port(packed)


_SPARSE_EXAMPLES = [kw for kw in EXAMPLE_QUERIES if kw["match"]]


@pytest.mark.parametrize("kw", _SPARSE_EXAMPLES,
                         ids=[str(i) for i in range(len(_SPARSE_EXAMPLES))])
def test_forced_sparse_example_matches_jax(example, monkeypatch, kw):
    jax_idx, idx = example
    _mode(monkeypatch, "always", jax_idx, idx)
    q = SearchQuery(**kw)
    cq = idx.plan(q)
    assert cq.sig.sparse and not cq.sig.scan_index
    _check(jax_idx, idx, q)


@pytest.fixture(scope="module")
def bench_pair():
    packed = bench.build_corpus(3000, 400, 30)
    return packed, JaxIndex(packed), _port(packed)


def test_forced_sparse_random_differential_matches_jax(bench_pair,
                                                       monkeypatch):
    packed, jax_idx, idx = bench_pair
    _mode(monkeypatch, "always", jax_idx, idx)
    queries = _random_queries(packed, 40, seed=11)
    plans = [idx.plan(q) for q in queries]
    assert all(cq.sig.sparse and not cq.sig.scan_index for cq in plans)
    assert {cq.sig.ranker for cq in plans} == {"ws_bm25", "proximity_bm25"}
    assert any(cq.sig.filters for cq in plans)
    assert sum(bool(p[0]) for cq in plans for p in cq.sig.slot_packed) >= 10
    assert sum(not p[0] for cq in plans for p in cq.sig.slot_packed) >= 10

    want = [_summary(jax_idx.search(_jax_query(q))) for q in queries]
    assert sum(w["total_found"] > 0 for w in want) >= 20
    assert [_summary(idx.search(q)) for q in queries] == want
    assert [_summary(r) for r in idx.search_batch(queries)] == want


def test_forced_sparse_orders_match_jax(bench_pair, monkeypatch):
    """ORDER BY id / attr over candidate space, where pad positions repeat
    row N."""
    packed, jax_idx, idx = bench_pair
    _mode(monkeypatch, "always", jax_idx, idx)
    term = _random_queries(packed, 1, seed=3)[0].match
    for sort in ([("id", False)], [("id", True)], [("year", False)],
                 [("group_id", True)]):
        q = SearchQuery(match=term, sort=sort, limit=20)
        assert idx.plan(q).sig.sparse
        assert _check(jax_idx, idx, q)["total_found"] > 20


# --------------------------------------------------------------------------
# filter-first, the JAX package's cases
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ff_pair():
    """tests/test_search.py::TestFilterFirstPreselection's index."""
    b = IndexBuilder(Schema(fields=["content"],
                            attrs=[AttrDef("year", AttrType.UINT)]))
    rng = np.random.RandomState(4)
    docs = []
    for i in range(1, 3001):
        words = ["common"] * 3 + [f"w{rng.randint(40):02d}"]
        docs.append(dict(id=i, content=" ".join(words),
                         year=2000 + (i % 100)))
    b.add_documents(docs)
    packed = b.build()
    return JaxIndex(packed), _port(packed)


FF_CASES = [("common", "bm25"), ("common w07", "bm25"),
            ("common | w03", "none"), ("common -w05", "bm25"),
            ("common", "proximity_bm25")]


@pytest.mark.parametrize("match,ranker", FF_CASES,
                         ids=[f"{m}-{r}" for m, r in FF_CASES])
def test_ft_filter_first_matches_jax(ff_pair, monkeypatch, match, ranker):
    jax_idx, idx = ff_pair
    _mode(monkeypatch, "auto", jax_idx, idx)
    q = SearchQuery(match=match, ranker=ranker, limit=50, filters=[
        AttrFilterDef("year", "range_i", lo=2003, hi=2004)])
    cq = idx.plan(q)
    jax_sig = jax_idx.plan(_jax_query(q)).sig
    assert (cq.sig.sparse, cq.sig.scan_index) == (jax_sig.sparse,
                                                 jax_sig.scan_index)
    if match == "common":   # the other windows are too wide for the
        assert cq.sig.scan_index == "year" and cq.sig.sparse  # rarest term
    assert _check(jax_idx, idx, q)["total_found"] > 0


@pytest.fixture(scope="module")
def scan_pair():
    """tests/test_packed_store.py::TestScanIndex's index."""
    import random
    rng = random.Random(5)
    b = IndexBuilder(Schema(fields=["content"],
                            attrs=[AttrDef("price", AttrType.UINT),
                                   AttrDef("score", AttrType.FLOAT)]))
    b.add_documents([dict(id=i, content=f"text {i}",
                          price=rng.randint(0, 999),
                          score=round(rng.random() * 100, 2))
                     for i in range(1, 4001)])
    packed = b.build()
    return JaxIndex(packed), _port(packed)


SCAN_CASES = {
    "range": (dict(limit=4000, max_matches=4000, filters=[
        AttrFilterDef("price", "range_i", lo=100, hi=120)]), "price"),
    "combined": (dict(limit=4000, max_matches=4000, filters=[
        AttrFilterDef("price", "range_i", lo=0, hi=50),
        AttrFilterDef("score", "range_f", lo=0.0, hi=25.0)]), "price"),
    "wide-stays-dense": (dict(limit=4000, max_matches=4000, filters=[
        AttrFilterDef("price", "range_i", lo=0, hi=998)]), ""),
    "order-by-attr": (dict(limit=10, sort=[("price", True), ("id", True)],
                           filters=[AttrFilterDef("price", "range_i",
                                                  lo=400, hi=420)]), "price"),
    "values-order-by-id": (dict(limit=30, sort=[("id", False)], filters=[
        AttrFilterDef("price", "values", values=[7, 500, 501])]), "price"),
    "float-window": (dict(limit=25, filters=[
        AttrFilterDef("score", "range_f", lo=10.0, hi=12.5)]), "score"),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_matchless_scan_matches_jax(scan_pair, monkeypatch, case):
    jax_idx, idx = scan_pair
    _mode(monkeypatch, "auto", jax_idx, idx)
    kw, scan = SCAN_CASES[case]
    q = SearchQuery(match="", **kw)
    cq = idx.plan(q)
    assert cq.sig.scan_index == scan and cq.sig.sparse == bool(scan)
    assert _check(jax_idx, idx, q)["total_found"] > 0


# --------------------------------------------------------------------------
# one grouped decode per call
# --------------------------------------------------------------------------
def test_one_grouped_decode_per_call_sparse_and_scan(bench_pair,
                                                     monkeypatch):
    """Sparse and filter-first plans decode every packed window of a batch
    in one grouped decode; a batch of MATCH-less scans reads no packed
    window and makes none."""
    packed, jax_idx, idx = bench_pair
    _mode(monkeypatch, "always", idx)
    queries = _random_queries(packed, 16)
    assert all(idx.plan(q).sig.sparse for q in queries)
    ps.LAUNCHES.reset()
    idx.search_batch(queries)
    assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (1, 0)

    _mode(monkeypatch, "auto", idx)
    hot = [t for t in range(len(packed.term_docs))
           if packed.term_docs[t] >= 4 * 3000 // 25][:6]
    year = [AttrFilterDef("year", "values", values=[2003])]
    ft = [SearchQuery(match=f"t{t:04d}", ranker="bm25", filters=year,
                      limit=10) for t in hot]
    scans = [SearchQuery(match="", filters=[
        AttrFilterDef("year", "range_i", lo=2000 + i, hi=2001 + i)],
        limit=10) for i in range(6)]
    assert len(ft) == 6
    for batch, decodes in ((ft, 1), (scans, 0), (ft + scans, 1)):
        assert all(idx.plan(q).sig.scan_index == "year" for q in batch)
        ps.LAUNCHES.reset()
        got = idx.search_batch(batch)
        assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (decodes, 0)
        want = [_summary(jax_idx.search(_jax_query(q))) for q in batch]
        assert [_summary(r) for r in got] == want


# --------------------------------------------------------------------------
# the scan helpers against their JAX versions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_member_scan_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 500
    na, nb = [(64, 96), (1024, 256), (7, 300), (256, 1)][seed]
    b_row = np.sort(rng.randint(0, n, nb)).astype(np.int32)
    if seed == 0:
        b_row[10:20] = b_row[10]            # duplicate posting rows
    cand = np.where(rng.rand(na) < 0.8, rng.randint(0, n, na), n)
    cand[0] = b_row[0]
    cand = np.sort(cand).astype(np.int32)   # pads repeat row n
    b_valid = rng.rand(nb) < 0.7
    b_valid[0] = True
    b_row = np.where(b_valid, b_row, n + 1).astype(np.int32)
    pays = (rng.rand(nb).astype(np.float32),
            rng.randint(-2**31, 2**31 - 1, nb).astype(np.int32))
    want_p, want_o = jax_search._member_scan(
        jnp.asarray(cand), jnp.asarray(b_row), jnp.asarray(b_valid),
        tuple(jnp.asarray(p) for p in pays))
    got_p, got_o = port_search._member_scan(
        torch.from_numpy(cand), torch.from_numpy(b_row),
        torch.from_numpy(b_valid), tuple(torch.from_numpy(p) for p in pays))
    assert np.asarray(want_p).any()
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    for g, w in zip(got_o, want_o):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(4))
def test_lex_search_le_matches_jax(seed):
    """Segments sorted on (a, b) with duplicates, empty and reversed
    ranges, keys below, inside and past each range; seed 3 masks b reads
    with the Hitman key mask."""
    rng = np.random.RandomState(seed)
    n, q = 400, 300
    a = np.sort(rng.randint(0, 40, n)).astype(np.int32)
    b = rng.randint(-50, 50, n).astype(np.int32)
    order = np.lexsort((b, a))
    a, b = a[order], b[order]
    b_mask = -1
    if seed == 3:
        b = b | np.int32(1 << 23) * (rng.rand(n) < 0.5)
        b_mask = port_search.HITMAN_KEY_MASK
        assert b_mask == jax_search.HITMAN_KEY_MASK
    lo = rng.randint(0, n, q).astype(np.int32)
    hi = np.clip(lo + rng.randint(-3, 120, q), 0, n).astype(np.int32)
    hi[:10] = lo[:10]                       # empty ranges
    key_a = rng.randint(-2, 42, q).astype(np.int32)
    key_b = rng.randint(-60, 60, q).astype(np.int32)
    n_iters = math.ceil(math.log2(n)) + 1 - (seed == 2) * 4  # 2: too few
    want = jax_search._lex_search_le(
        jnp.asarray(key_a), jnp.asarray(key_b), jnp.asarray(a),
        jnp.asarray(b), jnp.asarray(lo), jnp.asarray(hi), n_iters, b_mask)
    got = port_search._lex_search_le(
        torch.from_numpy(key_a), torch.from_numpy(key_b),
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lo),
        torch.from_numpy(hi), n_iters, b_mask)
    assert np.asarray(want[1]).any() and not np.asarray(want[1]).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
