"""Port parity: the positional operators, field / position / zone limits,
wildcard merge groups, repeated keywords and the wordcount / matchany
rankers, JAX SearchIndex vs the port on the CPU.

The same PackedIndex goes to ``manticoresearch_tpu.exec.searcher`` (XLA on
the CPU) and, carried across with ``from_jax_packed``, to
``manticoresearch_tpu_torch.exec.searcher`` with ``device="cpu"``. Every
case runs under ``MT_SPARSE`` auto, always (the sparse union) and never
(dense), through the port's ``search`` and ``search_batch``. The shapes
are those of ``tests/test_proximity.py`` and ``tests/test_zones.py`` (not
the sharded class) and of the wildcard cases of ``tests/test_search.py``,
plus gating under OR / ANDNOT / MAYBE and attribute filters; a seeded
random differential of config-3 queries (phrases and ``~5`` proximity, half
of them made of terms that stand near each other in a document) runs on a
small bench corpus with packed and residual slots. ``_pred_scan`` and the
chained stable sort are held against JAX on seeded arrays.

Tolerance: exact. Weights are integers computed by the reference formulas;
docids, totals and word stats are integers and strings; the scan helpers
return integers and booleans.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from manticoresearch_tpu.exec.searcher import SearchIndex as JaxIndex
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.ops import search as jax_search
from manticoresearch_tpu.schema import Schema
from manticoresearch_tpu.text.dictionary import DictSettings
from manticoresearch_tpu.text.tokenizer import TokenizerSettings
from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchQuery
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops import search as port_search
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

from .test_torch_search import _example_index, _jax_query, _port, _summary
from .test_torch_sparse import _mode

torch.set_num_threads(2)

MODES = ("auto", "always", "never")


def _build(fields_, docs, tok=None, dic=None):
    b = IndexBuilder(Schema(fields=fields_), tok or TokenizerSettings(),
                     dic or DictSettings())
    b.add_documents(docs)
    return b.build()


def _sp():
    return _build(["body"], [
        dict(id=1, body="The cat sat here. The dog ran away.<p>"
                        "A bird flew over the cat."),
        dict(id=2, body="Dogs and cats together in one sentence."),
        dict(id=3, body="No animals here at all. Nothing to see."),
    ], TokenizerSettings(index_sp=True, html_strip=True))


def _dupes():
    return _build(["body"], [
        dict(id=1, body="to be or not to be that is the question"),
        dict(id=2, body="be or not"),
        dict(id=3, body="to be something else to be"),
    ])


def _near():
    return _build(["content"], [
        dict(id=1, content="red apple sweet tangy juice drink"),
        dict(id=2, content="red apple a b c d e f g h i juice"),
        dict(id=3, content="red tasty apple juice"),
        dict(id=4, content="juice of the red apple tree"),
        dict(id=5, content="alpha beta gamma"),
        dict(id=6, content="alpha x x x x x beta gamma"),
    ])


_BIGRAM_DOCS = [
    dict(id=1, c="the quick brown fox jumps"),
    dict(id=2, c="quick thinking saves the brown bear"),
    dict(id=3, c="a fox and a bear"),
    dict(id=4, c="quick brown quick brown"),
]


def _bigram(mode, **tok):
    return _build(["c"], _BIGRAM_DOCS,
                  TokenizerSettings(bigram_index=mode, **tok))


def _zones():
    return _build(["body"], [
        dict(id=1, body="<h1>apple banana</h1> cherry <em>apple</em> plain"),
        dict(id=2, body="apple outside zones <h1>cherry only</h1>"),
        dict(id=3, body="no zones at all apple"),
    ], TokenizerSettings(html_strip=True, index_zones=("h1", "em")))


def _zonespan():
    return _build(["body"], [
        dict(id=1, body="<h1>apple banana</h1> filler"),
        dict(id=2, body="<h1>apple pie</h1> mid <h1>banana split</h1>"),
        dict(id=3, body="<h1>apple core</h1> banana loose"),
        dict(id=4, body="apple banana plain"),
    ], TokenizerSettings(html_strip=True, index_zones=("h1",)))


def _wild():
    docs = [dict(id=d + 1, content=f"w{d:03d} w{(d + 1) % 50:03d} common")
            for d in range(50)]
    return _build(["content"], docs, dic=DictSettings(min_prefix_len=1))


CORPORA = {
    "example": _example_index, "sp": _sp, "dupes": _dupes, "near": _near,
    "bigram_plain": lambda: _bigram(""), "bigram_all": lambda: _bigram("all"),
    "bigram_freq": lambda: _bigram("first_freq",
                                   bigram_freq_words=("the", "a")),
    "zones": _zones, "zonespan": _zonespan, "wild": _wild,
}


def _f(attr, kind, **kw):
    return [AttrFilterDef(attr, kind, **kw)]


CASES = [
    # phrase, proximity, NEAR on the example.sql corpus
    ("example", dict(match='"test document"')),
    ("example", dict(match='"number one"')),
    ("example", dict(match='"groups"')),
    ("example", dict(match='"test document" number')),
    ("example", dict(match='"my test document"')),
    ("example", dict(match='"document test"~1')),
    ("example", dict(match='"my number"~1')),
    ("example", dict(match='"my number"~2')),   # span 3, one past the window
    ("example", dict(match='"my number"~3')),
    ("example", dict(match='"number my test"~2')),
    ("example", dict(match='"two document"~5')),
    ("example", dict(match="my NEAR/3 number")),
    ("example", dict(match="document NEAR/1 test")),
    ("example", dict(match="test NOTNEAR/1 document")),
    # gating under OR / ANDNOT / MAYBE, and filters
    ("example", dict(match='"test document" | groups')),
    ("example", dict(match='"test document" -number')),
    ("example", dict(match='groups -"test document"')),
    ("example", dict(match='"my test" MAYBE one')),
    ("example", dict(match='test MAYBE "document number"')),
    ("example", dict(match='"test document"',
                     filters=_f("group_id", "values", values=[1]))),
    ("example", dict(match='"my number"~3',
                     filters=_f("group_id2", "range_i", lo=6, hi=8))),
    ("example", dict(match='"test document"', ranker="bm25")),
    # field, position and edge limits
    ("example", dict(match="@title test")),
    ("example", dict(match="(@title test) | groups")),
    ("example", dict(match="@content[4] test")),
    ("example", dict(match="^this")),
    ("example", dict(match="^test one")),
    ("example", dict(match="@title one$ test")),
    ("example", dict(match="@title test", ranker="fieldmask")),
    ("example", dict(match='@content "test document"')),
    # repeated keywords (HANDLE_DUPES) and the wordcount / matchany rankers
    ("example", dict(match="this is this")),
    ("example", dict(match="test test document", ranker="proximity")),
    ("example", dict(match='test "test document"')),
    ("example", dict(match="test document", ranker="wordcount")),
    ("example", dict(match='"test document" one', ranker="wordcount")),
    ("example", dict(match='"my test" number', ranker="matchany")),
    ("example", dict(match="this is this", ranker="matchany")),
    ("dupes", dict(match="to be or not to be")),
    ("dupes", dict(match="to be or not to be", ranker="proximity")),
    ("dupes", dict(match="to be or not to be", ranker="wordcount")),
    ("dupes", dict(match="to be to be", ranker="matchany")),
    # SENTENCE / PARAGRAPH
    ("sp", dict(match="dogs SENTENCE cats")),
    ("sp", dict(match="cat SENTENCE dog")),
    ("sp", dict(match="cat SENTENCE sat")),
    ("sp", dict(match="bird SENTENCE cat")),
    ("sp", dict(match="cat PARAGRAPH dog")),
    ("sp", dict(match="bird PARAGRAPH dog")),
    # general NEAR: phrase operands and chains
    ("near", dict(match='"red apple" NEAR/4 juice')),
    ("near", dict(match='"red apple" NEAR/1 juice')),
    ("near", dict(match='juice NEAR/4 "red apple"')),
    ("near", dict(match="alpha NEAR/2 beta NEAR/2 gamma")),
    ("near", dict(match="alpha NEAR/6 beta NEAR/2 gamma")),
    ("near", dict(match="apple NOTNEAR/2 juice")),
    # bigrams, without and with bigram_index
    ("bigram_plain", dict(match='"quick brown"')),
    ("bigram_plain", dict(match='fox | "brown bear"')),
    ("bigram_all", dict(match='"quick brown"')),
    ("bigram_all", dict(match='"brown fox"')),
    ("bigram_all", dict(match='"a fox"')),
    ("bigram_all", dict(match='fox | "brown bear"')),
    ("bigram_freq", dict(match='"the quick"')),
    ("bigram_freq", dict(match='"quick brown"')),
    # ZONE and ZONESPAN
    ("zones", dict(match="ZONE:h1 apple")),
    ("zones", dict(match="ZONE:em apple")),
    ("zones", dict(match="ZONE:(h1,em) apple")),
    ("zones", dict(match="(ZONE:h1 apple) cherry")),
    ("zones", dict(match="(ZONE:h1 banana) plain")),
    ("zones", dict(match="ZONE:title apple")),
    ("zones", dict(match="ZONESPAN:h1 apple banana")),
    ("zonespan", dict(match="ZONE:h1 apple banana")),
    ("zonespan", dict(match="ZONESPAN:h1 apple banana")),
    ("zonespan", dict(match="ZONESPAN:h1 apple")),
    ("zonespan", dict(match="ZONESPAN:h1 apple pie")),
    ("zonespan", dict(match="ZONESPAN:h1 (apple | pie) banana")),
    # wildcard merge groups (min_prefix_len=1)
    ("wild", dict(match="w00*", limit=60)),
    ("wild", dict(match="w00* common", limit=60)),
    ("wild", dict(match="@content w00*", limit=60)),
    ("wild", dict(match="^w00*", limit=60)),
]


@pytest.fixture(scope="module")
def pairs():
    """corpus name -> (JAX index, the port's index on the CPU), built once."""
    cache: dict = {}

    def get(name):
        if name not in cache:
            packed = CORPORA[name]()
            cache[name] = (JaxIndex(packed), _port(packed))
        return cache[name]
    return get


def _check(jax_idx, idx, q: SearchQuery) -> dict:
    """The port's search and search_batch against JAX's search."""
    want = _summary(jax_idx.search(_jax_query(q)))
    assert _summary(idx.search(q)) == want
    assert _summary(idx.search_batch([q])[0]) == want
    return want


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("corpus,kw", CASES,
                         ids=[f"{c}:{kw['match']}:{kw.get('ranker', '')}"
                              for c, kw in CASES])
def test_positional_matches_jax(pairs, monkeypatch, corpus, kw, mode):
    jax_idx, idx = pairs(corpus)
    _mode(monkeypatch, mode, jax_idx, idx)
    q = SearchQuery(**kw)
    cq = idx.plan(q)
    assert repr(cq.sig) == repr(jax_idx.plan(_jax_query(q)).sig)
    if mode == "always":
        assert cq.sig.sparse
    else:
        assert not cq.sig.sparse
    assert _check(jax_idx, idx, q)["error"] is None


def test_cases_cover_the_slice(pairs):
    """Every plan feature of the slice occurs among the cases."""
    sigs = [pairs(c)[1].plan(SearchQuery(**kw)).sig for c, kw in CASES]
    ops = set()

    def walk(e):
        ops.add(e[0] if e[0] != "near" or len(e) <= 4 else "near_general")
        for c in e[1:]:
            if isinstance(c, tuple) and c and isinstance(c[0], tuple):
                for k in c:
                    walk(k)
            elif isinstance(c, tuple) and c and isinstance(c[0], str):
                walk(c)
    for sig in sigs:
        walk(sig.expr)
    assert {"phrase", "proximity", "near", "near_general", "sentence",
            "paragraph", "bigram_phrase", "andnot", "maybe", "or"} <= ops
    lim = [e for sig in sigs for e in sig.slot_limited]
    assert any(e[1] != 0 and not (e[2] or e[3] or e[4] or e[5]) for e in lim)
    assert any(e[2] for e in lim) and any(e[3] for e in lim)
    assert any(e[5] for e in lim)
    assert any(e[4] and e[4][0].startswith("=") for e in lim)
    assert any(e[4] and not e[4][0].startswith("=") for e in lim)
    assert any(sig.merge_groups for sig in sigs)
    assert any(sig.slot_occs for sig in sigs)
    assert any(sig.has_dupes for sig in sigs)
    assert {"wordcount", "matchany", "proximity", "proximity_bm25",
            "ws_bm25", "fieldmask"} <= {sig.ranker for sig in sigs}


@pytest.mark.parametrize("mode", MODES)
def test_mixed_batch_matches_jax(pairs, monkeypatch, mode):
    """All example-corpus cases in one ``search_batch``: many plan shapes,
    one grouped decode, each result equal to JAX's ``search``."""
    jax_idx, idx = pairs("example")
    _mode(monkeypatch, mode, jax_idx, idx)
    qs = [SearchQuery(**kw) for c, kw in CASES if c == "example"]
    want = [_summary(jax_idx.search(_jax_query(q))) for q in qs]
    assert [_summary(r) for r in idx.search_batch(qs)] == want


# --------------------------------------------------------------------------
# random differential: bench config 3 on a small bench corpus
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench_pair():
    packed = bench.build_corpus(3000, 400, 30)
    return packed, JaxIndex(packed), _port(packed)


def _config3(idx, n, seed):
    """config 3: WorkloadGen's phrase / ~5 proximity pairs with
    field_weights content=3, and as many made of terms that stand adjacent
    (phrase) or within 5 positions (proximity) in a random document."""
    rng = np.random.RandomState(seed)
    gen = bench_corpus.WorkloadGen(rng, 400, idx.packed)
    _, drawn = gen.config3(n // 2)
    fwt = {"content": 3}
    near = ([SearchQuery(match=f'"{a} {b}"', limit=10, field_weights=fwt)
             for a, b in bench_corpus.positional_pairs(idx.packed, rng,
                                                       n // 4, 1)]
            + [SearchQuery(match=f'"{a} {b}"~5', limit=10, field_weights=fwt)
               for a, b in bench_corpus.positional_pairs(idx.packed, rng,
                                                         n // 4, 5)])
    return drawn + near, near


@pytest.mark.parametrize("mode", ("never", "always"))
def test_config3_random_differential_matches_jax(bench_pair, monkeypatch,
                                                 mode):
    packed, jax_idx, idx = bench_pair
    _mode(monkeypatch, mode, jax_idx, idx)
    queries, near = _config3(idx, 16, seed=13)
    plans = [idx.plan(q) for q in queries]
    assert all(cq.sig.sparse == (mode == "always") for cq in plans)
    assert {cq.sig.expr[0] for cq in plans} == {"phrase", "proximity"}
    assert sum(bool(p[0]) for cq in plans for p in cq.sig.slot_packed) >= 4
    assert sum(not p[0] for cq in plans for p in cq.sig.slot_packed) >= 4
    want = [_summary(jax_idx.search(_jax_query(q))) for q in queries]
    assert all(w["total_found"] > 0 for w in want[-len(near):])
    assert [_summary(idx.search(q)) for q in queries] == want
    ps.LAUNCHES.reset()
    assert [_summary(r) for r in idx.search_batch(queries)] == want
    assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (1, 0)


# --------------------------------------------------------------------------
# the scan helpers against their JAX versions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_pred_scan_matches_jax(seed):
    """Queries below, on and past sorted (row, key) entries, with equal
    entries, invalid entries, negative keys; seed 3 has no valid entry."""
    rng = np.random.RandomState(seed)
    na, nb = [(300, 200), (64, 1024), (500, 7), (40, 64)][seed]
    b_row = rng.randint(0, 30, nb).astype(np.int32)
    b_key = rng.randint(-40, 40, nb).astype(np.int32)
    order = np.lexsort((b_key, b_row))
    b_row, b_key = b_row[order], b_key[order]
    if nb > 20:
        b_row[5:12], b_key[5:12] = b_row[5], b_key[5]   # equal entries
    b_valid = rng.rand(nb) < (0.0 if seed == 3 else 0.7)
    a_row = rng.randint(-1, 32, na).astype(np.int32)
    a_key = rng.randint(-50, 50, na).astype(np.int32)
    a_row[:min(nb, na) // 2] = b_row[:min(nb, na) // 2]   # exact ties
    a_key[:min(nb, na) // 2] = b_key[:min(nb, na) // 2]
    want = jax.jit(jax_search._pred_scan)(*(jnp.asarray(x) for x in (
        a_row, a_key, b_row, b_key, b_valid)))
    got = port_search._pred_scan(*(torch.from_numpy(x) for x in (
        a_row, a_key, b_row, b_key, b_valid)))
    assert np.asarray(want[2]).any() == (seed != 3)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_keys", (2, 3, 4))
def test_stable_order_matches_lax_sort(n_keys):
    """Chained stable sorts give lax.sort's lexicographic order of int32
    keys (full range, many ties), with the rest carried through."""
    rng = np.random.RandomState(n_keys)
    m = 2000
    keys = [rng.choice(np.array([-2**31, -7, 0, 3, 2**31 - 1], np.int32), m)
            for _ in range(n_keys)]
    iota = np.arange(m, dtype=np.int32)
    want = jax.lax.sort((*(jnp.asarray(k) for k in keys), jnp.asarray(iota)),
                        num_keys=n_keys + 1)
    order = port_search._stable_order(*(torch.from_numpy(k) for k in keys))
    for g, w in zip([*(torch.from_numpy(k)[order] for k in keys), order],
                    want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("p", (0.0, 0.01, 0.5, 1.0))
def test_last_index_matches_cummax(p):
    """The "last flagged position" equals JAX's cummax form, also with no
    flag and with every position flagged."""
    flag = np.random.RandomState(int(p * 100)).rand(3000) < p
    iota = np.arange(3000, dtype=np.int32)
    want = jax.lax.cummax(jnp.where(jnp.asarray(flag), iota, -1))
    got = port_search._last_index(torch.from_numpy(flag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
