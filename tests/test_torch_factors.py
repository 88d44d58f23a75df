"""Port parity: the expression ranker (``ranker=expr``, sph04,
PACKEDFACTORS()), JAX vs the port on the CPU.

Two levels:
- ``FactorContext``: every factor, ``max_window_hits``, ``bm25a`` and
  ``bm25f`` (with and without field weights) of the port, on streams made
  from a numpy seed, held against the JAX package's ``FactorContext``
  evaluated inside ``jax.jit`` on the same arrays (as its search program
  evaluates it): a few rows and fields, with and without query dupes (a
  deduped stream beside a raw one), one keyword, 20 keywords (S > 16) and
  40 (S > 32, where XLA's CPU reduction takes windows of 32), and without
  the runtime's folding arrays (the other branch of min_best_span_pos and
  atc). The BM25 tails' reduction order is checked at every S from 1 to
  40; the wlccs scan against ``jnp.cumsum`` at several lengths; the
  ordered scatter-add against XLA's at order-dependent values.
- ``SearchIndex``: every query shape of ``tests/test_expr_ranker.py`` (its
  SphinxQL cases as the equivalent ``SearchQuery`` on the same documents),
  each index built by the JAX package's builder and, for the port, by the
  port's own builder, through the port's ``search`` and ``search_batch``
  against JAX's ``search`` under ``MT_SPARSE`` never, auto and always:
  docids, weights, totals and PACKEDFACTORS() strings (plain and
  ``json=1``), and queries of 20 and 33 keywords.

Tolerance: integers exact; float factors bit-exact, except atc: it is
log(1 + ws) of float32 values whose pow and log are the libraries' own (a
pow of an integer gap or a log differs from XLA's by an ulp or so), and
an ulp of 1 + ws moves the log by up to 2^-23, so atc is held to 4 ulp of
itself plus 4 * 2^-23. That bound also covers the atc numbers inside
PACKEDFACTORS() strings, whose other text must be equal. Weights of
formulas over atc or a transcendental function must be equal on these
corpora (they are).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manticoresearch_tpu.ops import factors as jax_factors
from manticoresearch_tpu_torch.exec.searcher import SearchQuery
from manticoresearch_tpu_torch.ops import factors as port_factors
from manticoresearch_tpu_torch.ops import groupby as port_groupby

from ._torch_contracts import sorted_ids_contract  # noqa: F401  (autouse)
from .test_search import DOCS
from .test_torch_search import _both_builders, _jax_query, _summary
from .test_torch_sparse import _mode

torch.set_num_threads(2)

MODES = ("auto", "always", "never")


# --------------------------------------------------------------------------
# FactorContext on seeded streams
# --------------------------------------------------------------------------
STREAMS = {
    # name: (seed, rows N, fields F, slots S, hits M, dupes, max qpos)
    "plain": (0, 30, 3, 4, 400, False, 4),
    "one_word": (5, 30, 2, 1, 300, False, 1),
    "dupes": (2, 30, 3, 4, 400, True, 6),
    "s20": (1, 30, 2, 20, 600, False, 20),
    "s40": (4, 30, 2, 40, 800, False, 40),
    "many_hits": (3, 60, 5, 7, 2000, False, 7),
}
NO_FOLD = ("qpos_fold", "idf_by_qpos")   # rt keys of the folded branches


def _stream_arrays(name: str) -> dict:
    seed, n, f, s, m, dupes, maxq = STREAMS[name]
    rng = np.random.RandomState(seed)

    def stream(count):
        valid = rng.rand(count) < 0.85
        hrow = np.where(valid, rng.randint(0, n, count), n).astype(np.int32)
        fld = rng.randint(0, f, count)
        pos = rng.randint(1, 25, count)
        hpk = np.where(valid, (fld << 24) | pos, 0).astype(np.int32)
        hslot = rng.randint(0, s, count).astype(np.int32)
        hqp = np.where(valid, rng.randint(1, maxq + 1, count),
                       0).astype(np.int32)
        return [hrow, hpk, hqp, hslot, valid]

    st = stream(m)
    rt = dict(
        # mixed signs: terms in more than half the documents have idf < 0
        idf=(rng.rand(s) * 0.8 - 0.3).astype(np.float32),
        idf_by_qpos=(rng.rand(maxq + 1) * 0.8 - 0.3).astype(np.float32),
        field_weights=rng.randint(1, 5, f).astype(np.int32),
        total_field_lens=rng.randint(100, 10000, f).astype(np.float32),
        total_docs=np.asarray([n], np.float32),
        avg_doc_len=np.asarray([rng.rand() * 30 + 3], np.float32),
        qpos_fold=np.arange(1, s + 1).astype(np.int32),
        slot_fold=np.arange(s).astype(np.int32),
        exact_target=np.asarray([min(s, maxq)], np.int32),
    )
    return dict(
        N=n, F=f, S=s, maxq=maxq, st=st, raw=stream(m + 50) if dupes
        else None, rt=rt,
        lcs=rng.randint(0, 4, (n + 1, f)).astype(np.int32),
        bm=rng.randint(0, 3000, n + 1).astype(np.int32),
        tm=rng.randint(-2**31, 2**31 - 1, (n + 1, (s + 31) // 32)).astype(
            np.int32),
        fl=rng.randint(1, 30, (n + 1, f)).astype(np.int32))


def _weights(f: int) -> list[float]:
    return [5.0, 1.5, 2.5, 1.0, 0.5][:f]


FACTORS = sorted(jax_factors.DOC_FACTORS | jax_factors.FIELD_FACTORS) + [
    "bm25a", "bm25f", "bm25f_weighted", "max_window_hits_1",
    "max_window_hits_3"]


def _all_factors(ctx, f: int, weights) -> dict:
    out = {n: ctx.get(n) for n in sorted(jax_factors.DOC_FACTORS
                                         | jax_factors.FIELD_FACTORS)}
    out["bm25a"] = ctx.bm25a(1.2, 0.75)
    out["bm25f"] = ctx.bm25f(1.2, 0.7)
    out["bm25f_weighted"] = ctx.bm25f(1.2, 0.7, weights)
    out["max_window_hits_1"] = ctx.max_window_hits(1)
    out["max_window_hits_3"] = ctx.max_window_hits(3)
    return out


@functools.lru_cache(maxsize=None)
def _both(name: str, fold: bool) -> tuple[dict, dict]:
    """(JAX factors, port factors) of one seeded stream, as numpy."""
    d = _stream_arrays(name)
    rt = {k: v for k, v in d["rt"].items() if fold or k not in NO_FOLD}

    def jax_fn(st, raw, rtj, lcs, bm, tm, fl):
        ctx = jax_factors.FactorContext(
            N=d["N"], F=d["F"], S=d["S"], stream=tuple(st),
            raw_stream=None if raw is None else tuple(raw),
            max_qpos=d["maxq"], lcs=lcs, bm25part=bm, termmask=tm, rt=rtj,
            field_lens=fl)
        return _all_factors(ctx, d["F"], jnp.asarray(_weights(d["F"]),
                                                     jnp.float32))

    def j(x):
        return None if x is None else [jnp.asarray(a) for a in x]
    want = jax.jit(jax_fn)(j(d["st"]), j(d["raw"]),
                           {k: jnp.asarray(v) for k, v in rt.items()},
                           *(jnp.asarray(d[k]) for k in ("lcs", "bm", "tm",
                                                         "fl")))

    def t(x):
        return None if x is None else tuple(torch.from_numpy(np.array(a))
                                            for a in x)
    ctx = port_factors.FactorContext(
        N=d["N"], F=d["F"], S=d["S"], stream=t(d["st"]),
        raw_stream=t(d["raw"]), max_qpos=d["maxq"],
        lcs=torch.from_numpy(d["lcs"]), bm25part=torch.from_numpy(d["bm"]),
        termmask=torch.from_numpy(d["tm"]),
        rt=port_factors.factor_inputs(rt, "cpu"),
        field_lens=torch.from_numpy(d["fl"]))
    got = _all_factors(ctx, d["F"], _weights(d["F"]))
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def _atc_close(got: np.ndarray, want: np.ndarray) -> bool:
    want = want.astype(np.float32)
    bound = 4 * np.spacing(np.abs(want)) + 4 * 2.0**-23
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= bound))


@pytest.mark.parametrize("fold", (True, False), ids=("folded", "unfolded"))
@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("factor", FACTORS)
def test_factor_matches_jax(factor, stream, fold):
    want, got = _both(stream, fold)
    w, g = want[factor], got[factor]
    assert g.shape == w.shape and g.dtype == w.dtype
    if factor == "atc":
        assert _atc_close(g, w)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s", range(1, 41))
def test_bm25_tail_order_matches_jax(s):
    """bm25a's vectorized and bm25f's sequential reductions over S (and
    the one-keyword contracted form) at every S from 1 to 40."""
    rng = np.random.RandomState(100 + s)
    n, f, m = 200, 2, 2000
    valid = rng.rand(m) < 0.9
    st = [np.where(valid, rng.randint(0, n, m), n).astype(np.int32),
          np.where(valid, (rng.randint(0, f, m) << 24)
                   | rng.randint(1, 30, m), 0).astype(np.int32),
          np.zeros(m, np.int32), rng.randint(0, s, m).astype(np.int32),
          valid]
    rt = dict(idf=(rng.rand(s) - 0.3).astype(np.float32),
              avg_doc_len=np.asarray([17.25], np.float32),
              total_docs=np.asarray([n], np.float32),
              total_field_lens=np.asarray([1234.0, 789.0], np.float32))
    fl = rng.randint(1, 40, (n + 1, f)).astype(np.int32)
    kw = dict(N=n, F=f, S=s, max_qpos=s)

    def jax_fn(st_, rt_, fl_):
        ctx = jax_factors.FactorContext(
            stream=tuple(st_), lcs=None, bm25part=None, termmask=None,
            rt=rt_, field_lens=fl_, **kw)
        return ctx.bm25a(1.2, 0.75), ctx.bm25f(1.1, 0.6)
    want = jax.jit(jax_fn)([jnp.asarray(a) for a in st],
                           {k: jnp.asarray(v) for k, v in rt.items()},
                           jnp.asarray(fl))
    ctx = port_factors.FactorContext(
        stream=tuple(torch.from_numpy(a) for a in st),
        lcs=torch.zeros((n + 1, f), dtype=torch.int32), bm25part=None,
        termmask=None, rt=port_factors.factor_inputs(rt, "cpu"),
        field_lens=torch.from_numpy(fl), **kw)
    got = ctx.bm25a(1.2, 0.75), ctx.bm25f(1.1, 0.6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", (1, 15, 16, 17, 40, 1000, 100_000))
def test_wlccs_scan_matches_jnp_cumsum(n):
    """The blocked scan equals XLA's float cumsum bit for bit; a plain
    sequential sum does not (checked at the longer lengths)."""
    x = (np.random.RandomState(n).randn(n)
         * np.random.RandomState(n + 1).exponential(10, n)).astype(
        np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
    got = port_factors.blocked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if n >= 1000:
        assert not np.array_equal(np.cumsum(x, dtype=np.float32), want)


def test_ordered_scatter_add_matches_xla():
    """Float scatter-adds into shared cells, with values whose sum depends
    on the order (1e8, 1, -1e8), through the ordered segment sum (its
    plain version on the CPU)."""
    rng = np.random.RandomState(9)
    m, cells = 5000, 37
    cell = rng.randint(0, cells, m)
    vals = rng.choice(np.asarray([1e8, 1.0, -1e8, 0.5, -3.25, 1e-3],
                                 np.float32), m)
    want = np.asarray(jax.jit(lambda c, v: jnp.zeros(cells, jnp.float32)
                              .at[c].add(v))(jnp.asarray(cell),
                                             jnp.asarray(vals)))
    port_groupby.LAUNCHES.reset()
    got = port_factors.ordered_scatter_add(torch.from_numpy(cell),
                                           torch.from_numpy(vals), cells)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_groupby.LAUNCHES.plain == 1
    shuffled = np.zeros(cells, np.float32)
    for i in rng.permutation(m):
        shuffled[cell[i]] += vals[i]
    assert not np.array_equal(shuffled, want)   # the order matters here


# --------------------------------------------------------------------------
# SearchIndex: the query shapes of tests/test_expr_ranker.py
# --------------------------------------------------------------------------
def _words_docs(n_docs: int, n_words: int, seed: int):
    rng = np.random.RandomState(seed)
    return [dict(id=i + 1, body=" ".join(
        f"w{int(z)}" for z in rng.randint(0, n_words, 8)))
        for i in range(n_docs)]


CORPORA = {
    "example": (("title", "content"), DOCS, (("group_id", "uint"),)),
    "hello": (("title",), [dict(id=1, title="hello"),
                           dict(id=2, title="hello world")], ()),
    "sql": (("body",), [dict(id=1, body="aa bb cc"),
                        dict(id=2, body="aa aa bb")], ()),
    "x": (("body",), [dict(id=1, body="x")], ()),
    "chain": (("body",), [dict(id=1, body="the quick brown fox jumps"),
                          dict(id=2, body="quick fox brown the jumps")], ()),
    "span": (("body",), [dict(id=1, body="x quick brown y quick brown fox z"),
                         dict(id=2, body="quick y brown fox")], ()),
    "window": (("body",), [dict(id=1, body="a a x x x x x x x a a a"),
                           dict(id=2, body="a x x x a x x x a")], ()),
    "pf": (("title", "body"), [dict(id=1, title="red apple",
                                    body="fresh apple pie"),
                               dict(id=2, title="pear", body="apple tart")],
           ()),
    "gaps": (("content",), [dict(id=1, content="alpha beta"),
                            dict(id=2, content="alpha filler beta"),
                            dict(id=3, content="alpha x y beta alpha"),
                            dict(id=4, content="alpha w w w beta"),
                            dict(id=5, content="alpha only here")], ()),
    "words": (("body",), _words_docs(300, 40, 1), ()),
}

_OR20 = " | ".join(f"w{i}" for i in range(20))
_OR33 = " | ".join(f"w{i}" for i in range(33))
_EVERY = ("sum(lcs*user_weight)*1000+bm25+bm25a(1.2,0.75)*100"
          "+sum(tf_idf+sum_idf+wlccs)*10+sum(min_idf)+sum(max_idf)"
          "+sum(hit_count+word_count+exact_order+lccs+min_gaps)"
          "+sum(min_hit_pos+min_best_span_pos+exact_hit)"
          "+sum(max_window_hits(2))*3+field_mask+doc_word_count"
          "+query_word_count+max_lcs")
_PF = ["id", "PACKEDFACTORS()"]
_PF_JSON = ["id", "PACKEDFACTORS({json=1})"]

CASES = [
    # TestExprRanker
    ("example", dict(match="test document")),
    ("example", dict(match="test document",
                     ranker=("expr", "sum(lcs*user_weight)*1000+bm25"))),
    ("example", dict(match="test document",
                     ranker=("expr", "bm25f(1.2, 0.7)*1000"))),
    ("example", dict(match="test document", ranker=(
        "expr", "bm25f(1.2, 0.7, {title=5, content=1})*1000"))),
    ("example", dict(match="test", ranker=("expr", "sum(hit_count)*10 + "
                                                   "doc_word_count"))),
    ("example", dict(match="test one", ranker=("expr", "field_mask*100 + "
                                                       "sum(word_count)"))),
    ("sql", dict(match="aa bb", ranker=("expr", "sum(hit_count)*100"))),
    ("example", dict(match="number", ranker=("expr", "sum(min_hit_pos)"))),
    # TestIdfFactors
    ("example", dict(match="one", ranker=(
        "expr", "sum((sum_idf-min_idf)+(sum_idf-max_idf))*1000 + 7"))),
    ("example", dict(match="test one",
                     ranker=("expr", "sum(max_idf > min_idf)"))),
    ("example", dict(match="one", ranker=("expr", "sum(sum_idf)*1000"))),
    # TestExactOrder
    ("example", dict(match="test document",
                     ranker=("expr", "sum(exact_order)"))),
    ("example", dict(match="document test",
                     ranker=("expr", "sum(exact_order)"))),
    ("example", dict(match="test one", ranker=("expr", "sum(exact_order)"))),
    # TestSph04
    ("example", dict(match="test", ranker="sph04")),
    ("hello", dict(match="hello", ranker="sph04")),
    ("example", dict(match="@title test", ranker="sph04")),
    # TestLccs
    ("example", dict(match="test document", ranker=("expr", "sum(lccs)"))),
    ("example", dict(match="document test", ranker=("expr", "sum(lccs)"))),
    ("example", dict(match="number", ranker=("expr", "sum(lccs)"))),
    ("example", dict(match="one", ranker=(
        "expr", "sum((wlccs-sum_idf)*1000) + 42"))),
    ("chain", dict(match="quick brown fox", ranker=("expr", "sum(lccs)"))),
    # TestSpanFactors
    ("span", dict(match="quick brown fox",
                  ranker=("expr", "sum(min_best_span_pos)"))),
    ("window", dict(match="a", ranker=("expr",
                                       "sum(max_window_hits(3))"))),
    # TestPackedFactors
    ("pf", dict(match="apple", select=_PF,
                ranker=("expr", "sum(lcs)*1000+bm25"))),
    ("x", dict(match="x", select=_PF)),
    ("pf", dict(match="apple", select=_PF)),
    ("pf", dict(match="apple", select=_PF_JSON)),
    # TestMinGapsAtc
    ("gaps", dict(match="alpha | beta", limit=10,
                  ranker=("expr", "sum(min_gaps)*100"))),
    ("gaps", dict(match="alpha | beta", limit=10,
                  ranker=("expr", "sum(atc)*10000"))),
    # every factor at once, repeated keywords, a phrase, functions
    ("example", dict(match="test document", ranker=("expr", _EVERY))),
    ("example", dict(match="this is this", ranker=("expr", _EVERY))),
    ("example", dict(match='"test document" one', ranker=("expr", _EVERY))),
    ("example", dict(match="this is this", select=_PF)),
    ("example", dict(match='"test document" one', select=_PF_JSON)),
    ("example", dict(match="my test document number", select=_PF,
                     sort=[("group_id", False)])),
    ("example", dict(match="test", ranker=(
        "expr", "ln(bm25+1)*1000 + pow(sum(lcs), 2)*10 + exp(1) "
                "+ if(sum(lcs) > 1, 100, 5) + sum(exact_hit)*3 % 2 "
                "+ log2(8) + log10(1000) + sqrt(bm25)"))),
    ("gaps", dict(match="alpha | beta", limit=10, select=_PF)),
    # more than 16 and more than 32 keywords
    ("words", dict(match=_OR20, ranker=("expr", _EVERY))),
    ("words", dict(match=_OR20, select=_PF, limit=5)),
    ("words", dict(match=_OR33, ranker=(
        "expr", "bm25a(1.2,0.75)*1000 + sum(sum_idf)*100 + bm25"))),
    ("words", dict(match=_OR33, select=_PF_JSON, limit=5)),
]

_ATC = re.compile(r'(atc["=:]+)(-?[0-9.]+)')


def _split_atc(summary: dict) -> tuple[str, list[float]]:
    """The summary's text with atc numbers blanked, and the numbers."""
    text = repr(summary)
    return _ATC.sub(r"\1?", text), [float(v) for _, v in _ATC.findall(text)]


def _assert_same(got: dict, want: dict) -> None:
    g_text, g_atc = _split_atc(got)
    w_text, w_atc = _split_atc(want)
    assert g_text == w_text
    assert len(g_atc) == len(w_atc)
    if w_atc:
        assert _atc_close(np.asarray(g_atc, np.float32),
                          np.asarray(w_atc, np.float32))


@pytest.fixture(scope="module")
def pairs():
    cache: dict = {}

    def get(name):
        if name not in cache:
            cache[name] = _both_builders(*CORPORA[name])
        return cache[name]
    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("corpus,kw", CASES,
                         ids=[f"{i}:{c}" for i, (c, _) in enumerate(CASES)])
def test_expr_ranker_matches_jax(pairs, monkeypatch, corpus, kw, mode):
    jax_idx, idx = pairs(corpus)
    _mode(monkeypatch, mode, jax_idx, idx)
    q = SearchQuery(**kw)
    cq = idx.plan(q)
    assert repr(cq.sig) == repr(jax_idx.plan(_jax_query(q)).sig)
    if "ranker" in kw or "select" in kw:
        assert cq.sig.ranker == "expr" and not cq.sig.sparse
    want = _summary(jax_idx.search(_jax_query(q)))
    assert want["error"] is None and want["total_found"] > 0
    _assert_same(_summary(idx.search(q)), want)
    _assert_same(_summary(idx.search_batch([q])[0]), want)


@pytest.mark.parametrize("mode", MODES)
def test_expr_batch_matches_jax(pairs, monkeypatch, mode):
    """Every example-corpus case in one ``search_batch``, PACKEDFACTORS()
    queries among ranked ones: each result equals JAX's ``search``, and
    the factor scatters go through the ordered segment sum."""
    jax_idx, idx = pairs("example")
    _mode(monkeypatch, mode, jax_idx, idx)
    qs = [SearchQuery(**kw) for c, kw in CASES if c == "example"]
    qs.append(SearchQuery(match="test document"))          # not expr
    want = [_summary(jax_idx.search(_jax_query(q))) for q in qs]
    port_groupby.LAUNCHES.reset()
    for g, w in zip(idx.search_batch(qs), want):
        _assert_same(_summary(g), w)
    assert port_groupby.LAUNCHES.plain > 0 and \
        port_groupby.LAUNCHES.kernel == 0
