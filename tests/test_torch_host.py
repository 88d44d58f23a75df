"""Port parity: the port's own host side against the JAX package's.

The port carries copies of the JAX package's host modules (schema, text
pipeline, query parser and planner, index builder, the packed store's
build, the bench corpus and query generator). Each copy must give exactly
what the original gives on the same input:

- ``IndexBuilder`` on the example.sql documents and on a seeded mixed
  corpus (every attribute kind, two fields, non-ASCII and edge-case text),
  and ``build_from_pretokenized`` on a seeded 2,000-doc bench corpus:
  every array of ``PackedIndex`` and of ``packed_store()`` equal. Both
  builders take their native bulk path where g++ builds the library
  (``tests/test_torch_native.py`` holds the port's Python path equal
  too);
- the tokenizer, the dictionary and ``FtQueryParser`` on a fixed list of
  text and query strings: equal tokens, terms and ASTs (or the same error);
- ``plan_query`` on the queries of ``tests/test_torch_search.py``, and on
  expression-ranker, sph04 and PACKEDFACTORS() queries and a 40-field
  index: equal ``PlanSig`` and runtime arrays, every other field of the
  plan, and the same ``render_plan`` text of its transformed tree;
- ``WorkloadGen``: the same draws from the same seed;
- ``from_jax_packed``: a copy equal to the JAX index and to the port's own
  build of the same documents, sharing no array with its source.
- the RT index's host modules: ``merge_packed`` on random segment sets
  with killed rows under both ``row_order``s, ``save_packed`` by one
  package and ``load_packed`` by the other (both ways, and the same
  bytes written), the docstore's bytes and reads, the global-IDF file of
  ``indextool --buildidf`` and ``check_index``, and ``QueryCache`` (puts,
  hits, misses, TTL expiry and eviction under a small byte cap).
- the session layer's host modules: ``split_statements`` and
  ``parse_sql`` on every SQL string literal of the session-layer tests
  (the parsed statements compared field by field, or the same error),
  ``settings_from_sql_options`` and ``load_config`` (the same settings,
  or the same error), ``uid_short`` sequences (and the two packages'
  counters apart), ``jsonquery`` bodies to ``SearchQuery``, and the
  indexer's output directory on ``tests/test_tools.py``'s corpora and
  csv / tsv / kill-list twins (every file byte for byte, arrays.npz
  array by array), ``--rotate`` into a catalog included.
- the copies made as they are (the replication and cluster servers and
  the index builder among them): each module's code equal to its JAX
  original, statement by statement (the ASTs), except its import
  statements and its module docstring; the tokenizer's too, but for the
  lock around its native buffers; and ``_run_batches``,
  ``parity_recall_at_10`` and ``_emit_error`` of the port's bench
  (``tools/bench.py``) equal to ``bench.py``'s, but for imports,
  docstrings and the synchronize that ends each batch in
  ``_run_batches``.

Tolerance: exact. Everything compared is an integer, string, boolean or a
float32 array copied or computed by the same numpy expression.
"""
import ast as _ast
import dataclasses
import json
import enum
from pathlib import Path as _Path

import numpy as np
import pytest

import bench
from manticoresearch_tpu.index import builder as jax_builder
from manticoresearch_tpu.query.explain import render_plan as jax_render_plan
from manticoresearch_tpu.query.ftparser import FtQueryParser as JaxParser
from manticoresearch_tpu.query.planner import plan_query as jax_plan_query
from manticoresearch_tpu.schema import AttrDef as JaxAttrDef
from manticoresearch_tpu.schema import AttrType as JaxAttrType
from manticoresearch_tpu.schema import Schema as JaxSchema
from manticoresearch_tpu.text.dictionary import Dictionary as JaxDictionary
from manticoresearch_tpu.text.dictionary import DictSettings as JaxDictSettings
from manticoresearch_tpu.text.tokenizer import Tokenizer as JaxTokenizer
from manticoresearch_tpu.text.tokenizer import \
    TokenizerSettings as JaxTokenizerSettings
from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.index import builder
from manticoresearch_tpu_torch.ops.device_index import from_jax_packed
from manticoresearch_tpu_torch.query.explain import render_plan
from manticoresearch_tpu_torch.query.ftparser import FtQueryParser
from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.text.dictionary import Dictionary, DictSettings
from manticoresearch_tpu_torch.text.tokenizer import (Tokenizer,
                                                      TokenizerSettings)

from tests._torch_twin import TwinCatalog, TwinSession

from .test_search import DOCS
from .test_torch_search import (EXAMPLE_QUERIES, N_RANDOM, WIDE_FIELDS,
                                WIDE_FIELD_QUERIES, _jax_query,
                                _random_queries)


def _plain(x):
    """A structure of builtins equal across the two packages' classes
    (dataclasses and enums by class name and fields, arrays by dtype,
    shape and bytes)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple(
            (f.name, _plain(getattr(x, f.name)))
            for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("scalar", x.dtype.str, x.item())
    if isinstance(x, dict):
        return ("dict", tuple(sorted(((repr(k), _plain(v))
                                      for k, v in x.items()),
                                     key=lambda kv: kv[0])))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_plain(v) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(v) for v in x)))
    return x


def _assert_packed_equal(port, jax):
    for f in dataclasses.fields(jax):
        assert _plain(getattr(port, f.name)) == _plain(getattr(jax, f.name)), \
            f.name
    assert _plain(port.packed_store()) == _plain(jax.packed_store())


# --------------------------------------------------------------------------
# index builds
# --------------------------------------------------------------------------
_TEXTS = [
    "Hello, World! hello again", "Ünïcödé wörds ÀÉÎ straße", "русский Текст",
    "mixed123 numbers 42 4.5 x_y a-b", "", "   ", "a", "tab\tsep\nnew line",
    "w" * 50 + " long", "don't stop-words it's", "日本語 text", "ümlaut ÜMLAUT",
]


def _mixed_docs():
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(40)] + _TEXTS
    docs = []
    for i in range(1, 301):
        body = " ".join(words[int(z) % len(words)]
                        for z in rng.zipf(1.3, 10))
        docs.append(dict(
            id=1000 + 7 * (301 - i), title=_TEXTS[i % len(_TEXTS)],
            body=body, year=2000 + i % 9, score=float(rng.rand()),
            big=int(rng.randint(-2**40, 2**40)),
            color=["red", "Green", "blue"][i % 3],
            tags=sorted({int(x) for x in rng.randint(0, 50, i % 4)}),
            meta='{"a": 1.5, "b": [1, 2]}' if i % 5 == 0 else None))
    return docs


def _attrs(mod_def, mod_type, kinds):
    return [mod_def(n, mod_type[k]) for n, k in kinds]


def _wide_docs():
    """40 full-text fields, a few words in some of them."""
    rng = np.random.RandomState(3)
    docs = []
    for i in range(60):
        d = dict(id=i + 1, g=i % 5)
        for f in WIDE_FIELDS:
            d[f] = (" ".join(f"w{int(x)}" for x in rng.randint(0, 12, 3))
                    if rng.rand() < 0.3 else "")
        docs.append(d)
    return docs


CORPORA = {
    "example": (["title", "content"],
                [("group_id", "UINT"), ("group_id2", "UINT")], DOCS),
    "wide": (WIDE_FIELDS, [("g", "UINT")], _wide_docs()),
    "mixed": (["title", "body"],
              [("year", "UINT"), ("score", "FLOAT"), ("big", "BIGINT"),
               ("color", "STRING"), ("tags", "MVA"), ("meta", "JSON")],
              _mixed_docs()),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_index_builder_matches_jax(name):
    fields, kinds, docs = CORPORA[name]
    jb = jax_builder.IndexBuilder(JaxSchema(
        fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
    pb = builder.IndexBuilder(Schema(
        fields=fields, attrs=_attrs(AttrDef, AttrType, kinds)))
    jb.add_documents(docs)
    pb.add_documents(docs)
    jax_packed, port_packed = jb.build(), pb.build()
    assert port_packed.n_terms > 10
    _assert_packed_equal(port_packed, jax_packed)


def test_build_from_pretokenized_matches_jax():
    jax_packed = bench.build_corpus(2000, 400, 30)
    port_packed = bench_corpus.build_corpus(2000, 400, 30)
    store = port_packed.packed_store()
    assert store.term_class[:, 0].max() > 0          # some terms packed
    _assert_packed_equal(port_packed, jax_packed)


# --------------------------------------------------------------------------
# text pipeline and parser
# --------------------------------------------------------------------------
_TOKENIZER_SETTINGS = [
    {}, dict(min_word_len=3), dict(html_strip=True),
    dict(ngram_chars="U+3000..U+2FA1F"),
]


@pytest.mark.parametrize("kw", _TOKENIZER_SETTINGS,
                         ids=[str(i) for i in range(len(_TOKENIZER_SETTINGS))])
def test_tokenizer_matches_jax(kw):
    jt = JaxTokenizer(JaxTokenizerSettings(**kw))
    pt = Tokenizer(TokenizerSettings(**kw))
    texts = _TEXTS + [d["content"] for d in DOCS] + [
        "<b>bold</b> and <i>it</i>", "x " * 20]
    for text in texts:
        assert _plain(pt.tokenize(text)) == _plain(jt.tokenize(text)), text
        assert pt.tokenize_fast(text) == jt.tokenize_fast(text), text


_DICT_SETTINGS = [
    {}, dict(stopwords=frozenset({"the", "is", "a"})),
    dict(morphology=("stem_en",)), dict(morphology=("stem_ru",)),
    dict(wordforms=(("walks", "walk"),), index_exact_words=True),
]


@pytest.mark.parametrize("kw", _DICT_SETTINGS,
                         ids=[str(i) for i in range(len(_DICT_SETTINGS))])
def test_dictionary_matches_jax(kw):
    jd = JaxDictionary(JaxDictSettings(**kw))
    pd = Dictionary(DictSettings(**kw))
    words = ["the", "running", "walks", "is", "connection", "текстами",
             "abc", "", "flies", "=exact", "généralement"]
    for w in words:
        assert pd.process(w) == jd.process(w), w


_QUERIES = [
    "hello world", "a | b", "-x y", '"quoted phrase"', '"near words"~3',
    "@title foo", "@(title,content) foo bar", "foo MAYBE bar",
    "w1 NEAR/2 w2", "(a | b) -c", "=exact word", "^start end$",
    "a << b << c", '"a b c"/2', "Ünïcödé wörds", "русский текст",
    "mixed123 42", "", "   ", "unbalanced (paren", '"open quote',
    "a SENTENCE b", "a PARAGRAPH b", "!not", "test -two", "one | two | three",
    "@title test @content doc", "(one | two) document",
]


@pytest.mark.parametrize("settings", [{}, dict(morphology=("stem_en",))],
                         ids=["plain", "stem_en"])
def test_ftparser_matches_jax(settings):
    fields = ["title", "content"]
    jp = JaxParser(JaxTokenizer(JaxTokenizerSettings()),
                   JaxDictionary(JaxDictSettings(**settings)), fields)
    pp = FtQueryParser(Tokenizer(TokenizerSettings()),
                       Dictionary(DictSettings(**settings)), fields)

    def parse(parser, q):
        try:
            return _plain(parser.parse(q))
        except ValueError as e:
            return ("error", type(e).__name__, str(e))
    n_ok = 0
    for q in _QUERIES:
        want = parse(jp, q)
        assert parse(pp, q) == want, q
        n_ok += want[0] != "error"
    assert n_ok >= 20


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------
def _plan_both(port_idx: SearchIndex, jax_packed, q: SearchQuery):
    """The port's plan (``SearchIndex.plan``) and the JAX package's
    ``plan_query`` of the same query with the same arguments."""
    port_cq = port_idx.plan(q)
    jq = _jax_query(q)
    parser = JaxParser(JaxTokenizer(jax_packed.tokenizer_settings),
                       JaxDictionary(jax_packed.dict_settings),
                       jax_packed.schema.fields)
    order = port_cq.sig.order
    emit_factors = any(s.lower().replace(" ", "").startswith(
        "packedfactors(") for s in (jq.select or []))
    jax_cq = jax_plan_query(
        parser.parse(jq.match), jax_packed, filters=jq.filters,
        ranker=jq.ranker, max_matches=jq.max_matches,
        filter_tree=jq.filter_tree, window=jq.offset + jq.limit,
        order=order, field_weights=jq.field_weights,
        idf_plain=jq.idf_plain, tfidf_normalized=jq.tfidf_normalized,
        emit_factors=emit_factors, expansion_limit=jq.expansion_limit,
        packed_store=jax_packed.packed_store(),
        boolean_simplify=jq.boolean_simplify,
        expand_keywords=jq.expand_keywords, collation=jq.collation)
    return port_cq, jax_cq


def _assert_plans_equal(port_cq, jax_cq, port_schema, jax_schema):
    assert _plain(port_cq.sig) == _plain(jax_cq.sig)
    assert render_plan(port_cq.ast, port_schema) == jax_render_plan(
        jax_cq.ast, jax_schema)
    assert port_cq.runtime.keys() == jax_cq.runtime.keys()
    for k, v in jax_cq.runtime.items():
        assert _plain(port_cq.runtime[k]) == _plain(v), k
    for f in dataclasses.fields(jax_cq):
        if f.name not in ("sig", "runtime"):
            assert _plain(getattr(port_cq, f.name)) == _plain(
                getattr(jax_cq, f.name)), f.name


def test_plan_query_matches_jax_on_example_queries():
    fields, kinds, docs = CORPORA["example"]
    jb = jax_builder.IndexBuilder(JaxSchema(
        fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
    jb.add_documents(docs)
    jax_packed = jb.build()
    idx = SearchIndex(from_jax_packed(jax_packed), "cpu")
    for kw in EXAMPLE_QUERIES:
        _assert_plans_equal(*_plan_both(idx, jax_packed, SearchQuery(**kw)),
                            idx.schema, jax_packed.schema)


_PF = ["id", "PACKEDFACTORS()"]
EXPR_PLAN_QUERIES = [
    ("example", dict(match="test document",
                     ranker=("expr", "sum(lcs*user_weight)*1000+bm25"))),
    ("example", dict(match="test one", ranker=(
        "expr", "bm25f(1.2, 0.7, {title=5, content=1})*1000"
                "+bm25a(1.2,0.75)+sum(atc)"))),
    ("example", dict(match="this is this", ranker=("expr", "sum(lccs)"))),
    ("example", dict(match="test", ranker="sph04")),
    ("example", dict(match='"test document" one', ranker="sph04")),
    ("example", dict(match="test document", select=_PF)),
    ("example", dict(match="this is this", select=_PF,
                     ranker=("expr", "sum(lcs)"))),
    ("example", dict(match="test", select=["id", "PACKEDFACTORS({json=1})"],
                     sort=[("group_id", True)])),
] + [("wide", kw) for kw in WIDE_FIELD_QUERIES if not kw.get("group_by")]


@pytest.mark.parametrize("corpus,kw", EXPR_PLAN_QUERIES, ids=[
    str(i) for i in range(len(EXPR_PLAN_QUERIES))])
def test_plan_query_matches_jax_on_expr_and_wide_queries(corpus, kw):
    """The expression ranker's plans (the parsed formula, sph04's formula,
    PACKEDFACTORS() forcing it, the folding runtime arrays) and a 40-field
    index's (every plan dense, multi-word field-limit masks)."""
    fields, kinds, docs = CORPORA[corpus]
    jb = jax_builder.IndexBuilder(JaxSchema(
        fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
    jb.add_documents(docs)
    jax_packed = jb.build()
    idx = SearchIndex(from_jax_packed(jax_packed), "cpu")
    port_cq, jax_cq = _plan_both(idx, jax_packed, SearchQuery(**kw))
    _assert_plans_equal(port_cq, jax_cq, idx.schema, jax_packed.schema)
    if corpus == "wide":
        assert not port_cq.sig.sparse
    else:
        assert port_cq.sig.ranker == "expr"


def test_plan_query_matches_jax_on_random_queries():
    jax_packed = bench.build_corpus(3000, 400, 30)
    idx = SearchIndex(from_jax_packed(jax_packed), "cpu")
    queries = _random_queries(jax_packed, N_RANDOM)
    n_packed = 0
    for q in queries:
        port_cq, jax_cq = _plan_both(idx, jax_packed, q)
        _assert_plans_equal(port_cq, jax_cq, idx.schema, jax_packed.schema)
        n_packed += any(p[0] for p in port_cq.sig.slot_packed)
    assert n_packed >= 10


# --------------------------------------------------------------------------
# bench corpus query generator
# --------------------------------------------------------------------------
def test_workload_gen_draws_match_bench():
    jax_packed = bench.build_corpus(3000, 400, 30)
    port_packed = bench_corpus.build_corpus(3000, 400, 30)
    jg = bench.WorkloadGen(np.random.RandomState(7), 400, jax_packed)
    pg = bench_corpus.WorkloadGen(np.random.RandomState(7), 400, port_packed)
    assert pg.classes == jg.classes and len(pg.classes) >= 2
    assert [pg.term() for _ in range(20)] == [jg.term() for _ in range(20)]
    assert [pg.term(avoid_class=1) for _ in range(5)] == \
        [jg.term(avoid_class=1) for _ in range(5)]
    for cfg in ("config1", "config2", "config3", "config4"):
        pw, pm = getattr(pg, cfg)(12)
        jw, jm = getattr(jg, cfg)(12)
        assert [_plain(q) for q in pw + pm] == \
            [_plain(_jax_query_as_port(q)) for q in jw + jm], cfg


def _jax_query_as_port(jq) -> SearchQuery:
    """A JAX SearchQuery with the port's SearchQuery fields, filters as the
    port's own (for a structural comparison)."""
    from manticoresearch_tpu_torch.query.planner import AttrFilterDef
    kw = {f.name: getattr(jq, f.name) for f in dataclasses.fields(SearchQuery)}
    kw["filters"] = [AttrFilterDef(**{f.name: getattr(x, f.name)
                                      for f in dataclasses.fields(x)})
                     for x in jq.filters]
    return SearchQuery(**kw)


# --------------------------------------------------------------------------
# from_jax_packed
# --------------------------------------------------------------------------
def test_from_jax_packed_round_trip():
    fields, kinds, docs = CORPORA["mixed"]
    jb = jax_builder.IndexBuilder(JaxSchema(
        fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
    jb.add_documents(docs)
    jax_packed = jb.build()
    copy = from_jax_packed(jax_packed)
    assert type(copy) is builder.PackedIndex
    assert type(copy.schema) is Schema
    assert all(type(a.type) is AttrType for a in copy.schema.attrs)
    assert type(copy.tokenizer_settings) is TokenizerSettings
    assert type(copy.dict_settings) is DictSettings
    _assert_packed_equal(copy, jax_packed)
    # the port's own build of the same documents is the same index
    pb = builder.IndexBuilder(Schema(
        fields=fields, attrs=_attrs(AttrDef, AttrType, kinds)))
    pb.add_documents(docs)
    _assert_packed_equal(copy, pb.build())
    # an owned copy: writing to it leaves the source as it was
    before = jax_packed.post_rowid.copy()
    copy.post_rowid[:] = -1
    np.testing.assert_array_equal(jax_packed.post_rowid, before)


# --------------------------------------------------------------------------
# expressions (host half), geodist, the multi-part sort helpers
# --------------------------------------------------------------------------
_TS = 1614834367   # 2021-03-04 05:06:07 UTC
_ROW = {"tags": [5, 2, 9], "name": "abcd", "price": 7, "x": 2,
        "j": {"arr": [1, 5, 9], "a": 1}, "js": '{"a": 3, "b": [1, 2]}'}
# the inputs of tests/test_expr_funcs.py (deterministic ones), then more
EXPR_HOST_CASES = [
    "CRC32('hello')", "FIBONACCI(7)", "FIBONACCI(50)",
    *(f"{fn}({_TS})" for fn in ("YEAR", "MONTH", "DAY", "YEARMONTH",
                                "YEARMONTHDAY", "HOUR", "MINUTE", "SECOND",
                                "WEEK")),
    "TIMEDIFF(3723, 0)", "TIMEDIFF(0, 3723)",
    "REMAP(1, 100, (1,2), (10,20))", "REMAP(9, 100, (1,2), (10,20))",
    "CONCAT('a', 'b', 3)", "TO_STRING(42)", "LENGTH('hello')",
    "LENGTH(tags)", "SUBSTRING_INDEX('www.example.com', '.', 2)",
    "SUBSTRING_INDEX('www.example.com', '.', -1)", "REGEX(name, '^ab.*d$')",
    "LEVENSHTEIN('kitten', 'sitting')", "LEVENSHTEIN('kitten', 'sitting', 1)",
    "LEAST(3, 1, 2)", "GREATEST(3, 1, 2)", "LEAST(tags)", "GREATEST(tags)",
    "EXIST('price', 42)", "EXIST('nosuch', 42)", "ATAN2(1, 1)",
    "CONTAINS(POLY2D(0,0, 0,1, 1,1, 1,0), 0.5, 0.5)",
    "CONTAINS(POLY2D(0,0, 0,1, 1,1, 1,0), 2.0, 0.5)",
    "CONTAINS(GEOPOLY2D(0,0, 0,1, 1,1, 1,0), 0.5, 0.5)",
    "ANY(x > 7 FOR x IN j.arr)", "ALL(x > 0 FOR x IN j.arr)",
    "INDEXOF(x = 5 FOR x IN j.arr)", "j.missing IS NULL", "j.a IS NOT NULL",
    "CONNECTION_ID()", "CURRENT_USER()", "MIN_TOP_WEIGHT()", "RAND(5)",
    "1000000 * 1000000", "id + 1", "ABS(CRC32('test'))", "7 DIV 2",
    "-7 DIV 2", "7 / 0", "-7 % 3", "IDIV(7, 2)", "BIGINT('12abc')",
    "IF(1, 'a', 'b')", "'abc' = 'ABC'", "IN(tags, 2, 4)", "TO_STRING(j.arr)",
    "js.a + 1", "js.b", "LEAST(j.arr)", "x BETWEEN 1 AND 3", "SQRT(-1)",
    "LN(0)", "LOG10(100)", "POW(2, 10)", "CEIL(2.1)", "FLOOR(-2.1)",
    "INTERVAL(5, 1, 3, 7)", "GEODIST(0.1, 0.2, 0.3, 0.4)",
    "GEODIST(10, 20, 30, 40, {in=degrees, out=km})", "weight() * 2 + price",
    "price > 5 AND x < 3", "NOT price", "price & 3 | 8",
    # parse or evaluation errors
    "NOSUCH(1)", "1 +", "`1abc`", "LOG10(tags)", "nosuch_attr + 1",
    "CONTAINS(1, 2, 3)", "REGEX(name, '(')",
]


def _host_value(mod, text):
    try:
        tree = mod.parse_expr(text)
    except mod.ExprError as e:
        return ("parse error", str(e))
    try:
        return (tree, mod.eval_expr_host(tree, dict(_ROW), 17, 12345))
    except mod.ExprError as e:
        return (tree, "eval error", str(e))


@pytest.mark.parametrize("text", EXPR_HOST_CASES)
def test_expr_host_half_matches_jax(text):
    from manticoresearch_tpu.query import expr as jax_expr
    from manticoresearch_tpu_torch.query import expr as port_expr
    assert _host_value(port_expr, text) == _host_value(jax_expr, text)
    if not _host_value(jax_expr, text)[0] == "parse error":
        tree = jax_expr.parse_expr(text)
        assert port_expr.expr_attrs(tree) == jax_expr.expr_attrs(tree)


def test_geodist_matches_jax():
    from manticoresearch_tpu.utils import geodist as jax_geo
    from manticoresearch_tpu_torch.utils import geodist as port_geo
    rng = np.random.RandomState(3)
    for _ in range(200):
        lat1, lat2 = rng.uniform(-89, 89, 2)
        lon1, lon2 = rng.uniform(-179, 179, 2)
        if rng.rand() < 0.3:   # near points take the adaptive fast path
            lat2, lon2 = lat1 + rng.uniform(-1, 1), lon1 + rng.uniform(-1, 1)
        args = (float(lat1), float(lon1), float(lat2), float(lon2))
        rad = tuple(np.radians(a) for a in args)
        assert port_geo.geodist_adaptive_deg(*args) == \
            jax_geo.geodist_adaptive_deg(*args)
        assert port_geo.geodist_adaptive_rad(*rad) == \
            jax_geo.geodist_adaptive_rad(*rad)
        assert port_geo._sphere_rad(*rad) == jax_geo._sphere_rad(*rad)
    poly = [float(v) for v in rng.uniform(-10, 10, 12)]
    assert port_geo.geo_tesselate(poly) == jax_geo.geo_tesselate(poly)


class _M:
    def __init__(self, docid, weight, attrs):
        self.docid, self.weight, self.attrs = docid, weight, attrs


@pytest.mark.parametrize("seed", range(3))
def test_multi_sort_helpers_match_jax(seed):
    from types import SimpleNamespace

    from manticoresearch_tpu.exec import multi as jax_multi
    from manticoresearch_tpu_torch.exec import multi as port_multi
    rng = np.random.RandomState(seed)
    n = int(rng.randint(20, 90))
    keys = [(int(rng.randint(0, 5)), int(rng.randint(0, 30)))
            for _ in range(n)]
    for size in (1, 7, n):
        assert port_multi.ref_queue_order(keys, size) == \
            jax_multi.ref_queue_order(keys, size)
    vals = rng.randint(0, 6, n).tolist()
    for m in (n, 25):
        assert port_multi.sph_sort_indices(m, lambda i, j: vals[i] < vals[j]) \
            == jax_multi.sph_sort_indices(m, lambda i, j: vals[i] < vals[j])
    ents = [([(int(rng.randint(0, 4)), bool(rng.rand() < 0.5)),
              (str(rng.randint(0, 3)), True)], int(rng.randint(0, 10)))
            for _ in range(n)]
    assert port_multi.ref_group_sort(ents) == jax_multi.ref_group_sort(ents)

    def matches():
        r = np.random.RandomState(seed + 10)
        return [_M(int(d), int(r.randint(0, 3)),
                   {"a": int(r.randint(0, 4)), "s": ["x", "y", ""][d % 3],
                    "j": json.dumps({"k": int(r.randint(0, 3))})
                    if d % 4 else "{}"})
                for d in r.permutation(40) + 1]
    for sort in ([("a", False), ("id", True)], [("s", False)],
                 [("j.k", True)], [("j.k", False), ("weight", True)], None):
        q = SimpleNamespace(sort=sort)
        got, want = matches(), matches()
        port_multi._apply_sort(got, q)
        jax_multi._apply_sort(want, q)
        assert [m.docid for m in got] == [m.docid for m in want]


# --------------------------------------------------------------------------
# the distributed index's host half: shards, union view, part merge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_docs,n_shards", [(2000, 3), (9, 4)])
def test_build_corpus_shards_matches_bench(n_docs, n_shards):
    jax_shards = bench.build_corpus_shards(n_docs, 400, 30, n_shards)
    port_shards = bench_corpus.build_corpus_shards(n_docs, 400, 30, n_shards)
    assert len(port_shards) == len(jax_shards)
    for p, j in zip(port_shards, jax_shards):
        _assert_packed_equal(p, j)


def test_union_view_and_partition_match_jax():
    from manticoresearch_tpu.parallel import sharded as jax_sharded
    from manticoresearch_tpu_torch.parallel import sharded as port_sharded
    fields, kinds, docs = CORPORA["mixed"]
    jparts = jax_sharded.partition_documents(docs, 3)
    assert port_sharded.partition_documents(docs, 3) == jparts
    shards = []
    for part in jparts:
        jb = jax_builder.IndexBuilder(JaxSchema(
            fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
        jb.add_documents(part)
        shards.append(jb.build())
    ju = jax_sharded._UnionView(shards)
    pu = port_sharded._UnionView([from_jax_packed(s) for s in shards])
    for name in ("n_docs", "term_strs", "term_docs", "term_hits",
                 "term_offsets", "post_hit_offset", "hit_packed",
                 "field_lens", "attrs_mva"):
        assert _plain(getattr(pu, name)) == _plain(getattr(ju, name)), name
    for t in ju.term_strs[::7] + ["nosuchterm", ""]:
        assert pu.term_id(t) == ju.term_id(t)
    arr = np.arange(5, dtype=np.int32)
    for size, value in ((3, 0), (9, -1)):
        np.testing.assert_array_equal(
            port_sharded._pad_to(arr, size, value),
            jax_sharded._pad_to(arr, size, value))


def _part_results(mod, seed, grouped=False):
    """Per-part SearchResults of one package's classes: random matches
    with duplicate docids across parts, one part in error."""
    rng = np.random.RandomState(seed)
    out = []
    for part in range(4):
        ms = []
        for _ in range(int(rng.randint(0, 9))):
            d = int(rng.randint(1, 30))
            attrs = {"a": int(rng.randint(0, 4)),
                     "s": ["x", "y", ""][d % 3], "f": float(d % 5) / 2}
            if grouped:
                attrs = {"g": int(rng.randint(0, 5)),
                         "count(*)": int(rng.randint(1, 6)),
                         "sum(a)": int(rng.randint(0, 20)),
                         "min(a)": int(rng.randint(0, 3)),
                         "max(a)": int(rng.randint(3, 9))}
                attrs["@groupby"] = attrs["g"]
            m = mod.Match(d, int(rng.randint(1, 4)) * 1000, attrs)
            m._rowid = int(rng.randint(0, 50))
            ms.append(m)
        err = "part failed" if part == 2 and seed % 2 else None
        out.append(mod.SearchResult(
            ms, len(ms), len(ms) + int(rng.randint(0, 3)), 1.0,
            [mod.WordStat(w, part + i, 2 * part + i)
             for i, w in enumerate(("alpha", "beta")[: 1 + part % 2])],
            error=err))
    return out


def _merged_summary(r):
    return (r.error, r.total, r.total_found, r.warning,
            [(m.docid, m.weight, m.attrs) for m in r.matches],
            [(w.word, w.docs, w.hits) for w in r.word_stats])


MERGE_QUERIES = [
    dict(), dict(offset=2, limit=5), dict(sort=[("a", False), ("id", True)]),
    dict(sort=[("s", True), ("a", False)]), dict(sort=[("weight", True)]),
    dict(sort=[("f", False)], max_matches=6),
]


@pytest.mark.parametrize("seed", range(4))
def test_part_merge_matches_jax(seed):
    from manticoresearch_tpu.exec import multi as jax_multi
    from manticoresearch_tpu.exec import searcher as jax_searcher
    from manticoresearch_tpu_torch.exec import multi as port_multi
    from manticoresearch_tpu_torch.exec import searcher as port_searcher
    for kw in MERGE_QUERIES:
        for mode in (dict(), dict(agent_mode=True), dict(rt_heap=True)):
            got = port_multi.merge_part_results(
                _part_results(port_searcher, seed), SearchQuery(**kw), None,
                **mode)
            want = jax_multi.merge_part_results(
                _part_results(jax_searcher, seed), jax_searcher.SearchQuery(
                    **kw), None, **mode)
            assert _merged_summary(got) == _merged_summary(want), (kw, mode)
    assert _plain(port_multi.merge_word_stats(
        _part_results(port_searcher, seed))) == _plain(
        jax_multi.merge_word_stats(_part_results(jax_searcher, seed)))


def test_minimize_result_schema_matches_jax():
    from manticoresearch_tpu.exec import multi as jax_multi
    from manticoresearch_tpu.exec import searcher as jax_searcher
    from manticoresearch_tpu_torch.exec import multi as port_multi
    from manticoresearch_tpu_torch.exec import searcher as port_searcher
    kinds = [[("a", "BOOL"), ("b", "UINT"), ("c", "STRING"), ("d", "UINT")],
             [("a", "FLOAT"), ("b", "BIGINT"), ("c", "UINT"), ("d", "UINT")],
             [("a", "BOOL"), ("b", "TIMESTAMP")]]

    def run(mod, searcher, sdef, stype, schema_cls):
        schemas = [schema_cls(fields=["t"], attrs=_attrs(sdef, stype, k))
                   for k in kinds]
        results = [searcher.SearchResult(
            [searcher.Match(7 + i, 1, {"a": True, "b": -3, "c": "z", "d": i})],
            1, 1, 0.0, []) for i in range(len(kinds))]
        out = mod.minimize_result_schema(results, schemas)
        return _plain(out), [(m.docid, m.attrs) for r in results
                             for m in r.matches]
    for a, b in [("bool", "float"), ("uint", "bigint"), ("timestamp", "bool"),
                 ("string", "uint"), ("float", "float")]:
        assert port_multi._unify_attr_type(a, b) == \
            jax_multi._unify_attr_type(a, b)
    assert run(port_multi, port_searcher, AttrDef, AttrType, Schema) == \
        run(jax_multi, jax_searcher, JaxAttrDef, JaxAttrType, JaxSchema)


class _Part:
    """A part that answers with fixed results: grouped rows for a grouped
    query, the raw match window otherwise."""

    def __init__(self, grouped, raw, n_docs):
        self.grouped, self.raw, self.n_docs = grouped, raw, n_docs

    def search(self, q):
        return self.grouped if q.group_by else self.raw


GROUPED_QUERIES = [
    dict(select=["count(*)", "sum(a)", "min(a)", "max(a)"]),
    dict(select=["count(*)"], sort=[("@count", False)]),
    dict(select=["count(*)"], sort=[("g", True)], offset=1, limit=2),
    dict(select=["count(*)", "sum(a)"], sort=[("a", False)]),
    dict(select=["count(*)", "count(distinct a)"]),
    dict(select=["count(*)"], within_sort=[("a", True)]),
]


@pytest.mark.parametrize("seed", range(3))
def test_search_grouped_parts_matches_jax(seed):
    from manticoresearch_tpu.exec import multi as jax_multi
    from manticoresearch_tpu.exec import searcher as jax_searcher
    from manticoresearch_tpu_torch.exec import multi as port_multi
    from manticoresearch_tpu_torch.exec import searcher as port_searcher

    def parts(searcher):
        grouped = [r for r in _part_results(searcher, seed, grouped=True)
                   if not r.error]
        raw = [r for r in _part_results(searcher, seed + 100)
               if not r.error]
        for r in raw:
            for m in r.matches:
                m.attrs["g"] = m.attrs["a"] % 3
        return [_Part(g, w, 40) for g, w in zip(grouped, raw)]
    schema_p = Schema(fields=["t"], attrs=_attrs(
        AttrDef, AttrType, [("g", "UINT"), ("a", "UINT")]))
    schema_j = JaxSchema(fields=["t"], attrs=_attrs(
        JaxAttrDef, JaxAttrType, [("g", "UINT"), ("a", "UINT")]))
    for kw in GROUPED_QUERIES:
        for mode in (dict(), dict(segments=True), dict(agent_mode=True)):
            got = port_multi.search_grouped_parts(
                parts(port_searcher), SearchQuery(group_by="g", **kw),
                schema_p, **mode)
            want = jax_multi.search_grouped_parts(
                parts(jax_searcher), jax_searcher.SearchQuery(
                    group_by="g", **kw), schema_j, **mode)
            assert _merged_summary(got) == _merged_summary(want), (kw, mode)


# --------------------------------------------------------------------------
# the RT index's host half: posting merge, storage, docstore, global IDF,
# result cache
# --------------------------------------------------------------------------
def _mixed_segments(mod_builder, mod_schema, mod_def, mod_type, seed):
    """The mixed corpus cut at random points into 2-4 segments, each built
    by one package's builder, and a random set of live docids per
    segment."""
    fields, kinds, docs = CORPORA["mixed"]
    rng = np.random.RandomState(seed)
    cuts = sorted(rng.choice(np.arange(20, len(docs) - 20),
                             int(rng.randint(1, 4)), replace=False))
    segs, live = [], []
    for part in np.split(np.asarray(docs, dtype=object), cuts):
        b = mod_builder.IndexBuilder(mod_schema(
            fields=fields, attrs=_attrs(mod_def, mod_type, kinds)))
        b.add_documents(list(part))
        segs.append(b.build())
        ids = [d["id"] for d in part]
        live.append({d for d in ids if rng.rand() > 0.3})
    return segs, live


@pytest.mark.parametrize("row_order", ["docid", "concat"])
@pytest.mark.parametrize("seed", range(3))
def test_merge_packed_matches_jax(seed, row_order):
    from manticoresearch_tpu.index import merge as jax_merge
    from manticoresearch_tpu_torch.index import merge as port_merge
    jsegs, jlive = _mixed_segments(jax_builder, JaxSchema, JaxAttrDef,
                                   JaxAttrType, seed)
    psegs, plive = _mixed_segments(builder, Schema, AttrDef, AttrType, seed)
    assert plive == jlive
    for live in (jlive, None):
        want = jax_merge.merge_packed(jsegs, live, row_order=row_order)
        got = port_merge.merge_packed(psegs, live, row_order=row_order)
        assert 0 < got.n_docs <= sum(s.n_docs for s in psegs)
        _assert_packed_equal(got, want)


def _stored_as_lists(packed):
    """A loaded index with its docstore columns read out as lists (each
    package loads them as its own ``BlockedDocstore`` class)."""
    return dataclasses.replace(packed, stored_fields={
        k: list(v) for k, v in packed.stored_fields.items()})


def test_save_packed_and_load_packed_cross_packages(tmp_path):
    from manticoresearch_tpu.index import storage as jax_storage
    from manticoresearch_tpu_torch.index import storage as port_storage
    fields, kinds, docs = CORPORA["mixed"]
    jb = jax_builder.IndexBuilder(JaxSchema(
        fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
    pb = builder.IndexBuilder(Schema(
        fields=fields, attrs=_attrs(AttrDef, AttrType, kinds)))
    jb.add_documents(docs)
    pb.add_documents(docs)
    jax_storage.save_packed(jb.build(), str(tmp_path / "by_jax"))
    port_storage.save_packed(pb.build(), str(tmp_path / "by_port"))
    for name in ("by_jax", "by_port"):
        path = str(tmp_path / name)
        got = _stored_as_lists(port_storage.load_packed(path))
        want = _stored_as_lists(jax_storage.load_packed(path))
        assert got.n_docs == len(docs)
        _assert_packed_equal(got, want)
    for f in ("header.json", "strings.json", "docstore.bin"):
        assert (tmp_path / "by_port" / f).read_bytes() == \
            (tmp_path / "by_jax" / f).read_bytes(), f


def test_docstore_matches_jax(tmp_path):
    from manticoresearch_tpu.index import docstore as jax_docstore
    from manticoresearch_tpu_torch.index import docstore as port_docstore
    cols = {"title": _TEXTS * 30,
            "body": [None, "", "x" * 5000] + _TEXTS * 10}
    jax_docstore.save_docstore(cols, str(tmp_path / "jax.bin"))
    port_docstore.save_docstore(cols, str(tmp_path / "port.bin"))
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    got = port_docstore.load_docstore(str(tmp_path / "jax.bin"))
    want = jax_docstore.load_docstore(str(tmp_path / "jax.bin"))
    for k in cols:
        assert got[k].tolist() == want[k].tolist()
        assert got[k].compressed_bytes == want[k].compressed_bytes
        assert [got[k][i] for i in (0, -1, 65, 64)] == \
            [want[k][i] for i in (0, -1, 65, 64)]
        assert got[k][3:70:7] == want[k][3:70:7]


def test_global_idf_matches_jax(tmp_path):
    from manticoresearch_tpu.index import storage as jax_storage
    from manticoresearch_tpu.tools import indextool as jax_indextool
    from manticoresearch_tpu_torch.tools import indextool as port_indextool
    jsegs, _ = _mixed_segments(jax_builder, JaxSchema, JaxAttrDef,
                               JaxAttrType, 5)
    paths = []
    for i, s in enumerate(jsegs):
        paths.append(str(tmp_path / f"seg{i}"))
        jax_storage.save_packed(s, paths[-1])
    jax_indextool.build_global_idf(paths, str(tmp_path / "jax.idf"))
    port_indextool.build_global_idf(paths, str(tmp_path / "port.idf"))
    for f in ("jax.idf", "port.idf"):
        got = port_indextool.load_global_idf(str(tmp_path / f))
        assert got == jax_indextool.load_global_idf(str(tmp_path / f))
        assert got[1] == sum(s.n_docs for s in jsegs)
    assert port_indextool.check_index(paths[0]) == \
        jax_indextool.check_index(paths[0]) == []


def test_query_cache_matches_jax(monkeypatch):
    from manticoresearch_tpu.exec import qcache as jax_qcache
    from manticoresearch_tpu.exec import searcher as jax_searcher
    from manticoresearch_tpu_torch.exec import qcache as port_qcache
    from manticoresearch_tpu_torch.exec import searcher as port_searcher

    def run(qc_mod, sr, clock):
        now = [100.0]
        monkeypatch.setattr(qc_mod.time, "monotonic", lambda: now[0])
        qc = qc_mod.QueryCache(max_bytes=1500, thresh_msec=0, ttl_sec=60)
        out = []
        for i in range(12):
            res = sr.SearchResult(
                [sr.Match(d, 1000 + d, {"a": d, "s": "x" * i})
                 for d in range(i % 5)], i % 5, i % 5, 1.0, [],
                error="bad" if i == 7 else None)
            key = qc.key("t", i % 3, f"q{i % 4}")
            qc.put(key, res)
            now[0] += clock
            hit = qc.get(qc.key("t", (i + 1) % 3, f"q{(i + 1) % 4}"))
            out.append(None if hit is None else
                       [(m.docid, m.weight, m.attrs) for m in hit.matches])
            out.append(qc.status())
        qc.clear()
        return out + [qc.status(), qc.misses]
    for clock in (1.0, 30.0):
        assert run(port_qcache, port_searcher, clock) == \
            run(jax_qcache, jax_searcher, clock)


# -- the session layer's host modules ---------------------------------------
_SQL_VERBS = ("SELECT", "INSERT", "REPLACE", "DELETE", "UPDATE", "CREATE",
              "DROP", "ALTER", "SHOW", "DESC", "DESCRIBE", "SET", "CALL",
              "BEGIN", "COMMIT", "ROLLBACK", "START", "TRUNCATE", "OPTIMIZE",
              "FLUSH", "ATTACH", "IMPORT", "RELOAD", "EXPLAIN", "FACET")
_SQL_FILES = ("test_sphinxql.py", "test_snippets_pq.py", "test_agents.py",
              "test_torch_session.py", "test_torch_snippets_pq.py",
              "test_torch_distributed.py")


def _harvest_sql() -> list[tuple[str, str]]:
    """Every SQL string literal of the session-layer tests: (file, text)."""
    out, seen = [], set()
    for name in _SQL_FILES:
        path = _Path(__file__).parent / name
        for node in _ast.walk(_ast.parse(path.read_text())):
            if not (isinstance(node, _ast.Constant)
                    and isinstance(node.value, str)):
                continue
            text = node.value.strip()
            if text.split(" ", 1)[0].upper().rstrip("(;") in _SQL_VERBS \
                    and text not in seen:
                seen.add(text)
                out.append((name, text))
    return out


_SQL = _harvest_sql()


def _parsed(mod, sql):
    try:
        return [mod.parse_sql(p) for p in mod.split_statements(sql)], None
    except mod.SqlParseError as e:
        return None, str(e)


def test_sql_harvest_is_wide():
    assert len(_SQL) >= 250
    assert {f for f, _ in _SQL} == set(_SQL_FILES)


@pytest.mark.parametrize("i", range(len(_SQL)),
                         ids=[f"{f}:{i}" for i, (f, _) in enumerate(_SQL)])
def test_parse_sql_matches_jax(i):
    from manticoresearch_tpu.query import sphinxql as jax_sql
    from manticoresearch_tpu_torch.query import sphinxql as port_sql
    sql = _SQL[i][1]
    assert jax_sql.split_statements(sql) == port_sql.split_statements(sql)
    want, werr = _parsed(jax_sql, sql)
    got, gerr = _parsed(port_sql, sql)
    assert werr == gerr, sql
    assert _plain(want) == _plain(got), sql


_SQL_OPTIONS = [
    {},
    {"morphology": "stem_en", "stopwords": "the a an"},
    {"morphology": "stem_en, soundex", "min_word_len": "3",
     "index_exact_words": "1", "min_prefix_len": "2"},
    {"wordforms": "walks > walk, walked > walk", "html_strip": "1",
     "html_remove_elements": "script, style", "html_index_attrs":
     "img=alt"},
    {"charset_table": "non_cjk, U+00E9->e", "blend_chars": "+, &",
     "ngram_len": "1", "ngram_chars": "cjk", "min_infix_len": "3"},
    {"exceptions": "AT&T => att", "ignore_chars": "U+AD",
     "index_sp": "1", "index_zones": "h1, p", "bigram_index": "all",
     "phrase_boundary": ".", "dict": "crc"},
]


@pytest.mark.parametrize("opts", range(len(_SQL_OPTIONS)))
def test_settings_from_sql_options_matches_jax(opts):
    from manticoresearch_tpu.config import \
        settings_from_sql_options as jax_settings
    from manticoresearch_tpu_torch.config import settings_from_sql_options
    try:
        want, werr = jax_settings(dict(_SQL_OPTIONS[opts])), None
    except ValueError as e:
        want, werr = None, str(e)
    try:
        got, gerr = settings_from_sql_options(dict(_SQL_OPTIONS[opts])), None
    except ValueError as e:
        got, gerr = None, str(e)
    assert werr == gerr
    assert _plain(want) == _plain(got)


_CONFIGS = ['''
[searchd]
listen_mysql = 19306
listen_http = 19308
data_dir = "{d}/data"
rt_flush_period = 60

[index.products]
type = "plain"
source = "{d}/docs.jsonl"
path = "{d}/idx/products"
fields = ["title", "body"]
attrs = {{ price = "float", cat = "uint", tags = "multi", j = "json" }}

[index.products.tokenizer]
charset_table = "non_cjk"
min_word_len = 2

[index.rt1]
type = "rt"
fields = ["body"]
attrs = {{ gid = "uint", name = "string" }}

[index.rt1.dict]
morphology = ["stem_en"]
stopwords = ["the", "a"]
''', '''
[index.x]
attrs = {{ a = "nosuch" }}
''', '''
[searchd]
listen_mysql = "not a port"
''']


@pytest.mark.parametrize("k", range(len(_CONFIGS)))
def test_load_config_matches_jax(tmp_path, k):
    from manticoresearch_tpu.config import ConfigError as JaxConfigError
    from manticoresearch_tpu.config import load_config as jax_load
    from manticoresearch_tpu_torch.config import ConfigError, load_config
    p = tmp_path / "conf.toml"
    p.write_text(_CONFIGS[k].format(d=tmp_path))
    try:
        want, werr = jax_load(str(p)), None
    except (JaxConfigError, ValueError, TypeError) as e:
        want, werr = None, (type(e).__name__, str(e))
    try:
        got, gerr = load_config(str(p)), None
    except (ConfigError, ValueError, TypeError) as e:
        got, gerr = None, (type(e).__name__, str(e))
    assert werr == gerr
    assert _plain(want) == _plain(got)


def test_uid_short_matches_jax():
    from manticoresearch_tpu.utils import uid as jax_uid
    from manticoresearch_tpu_torch.utils import uid
    for server_id, started in ((0, 100000), (3, 12345), (127, 1 << 20)):
        jax_uid.setup(server_id, started)
        uid.setup(server_id, started)
        assert [jax_uid.uid_short() for _ in range(7)] == \
            [uid.uid_short() for _ in range(7)]
    jax_uid.reset()
    uid.reset()
    assert jax_uid.uid_short() == uid.uid_short()
    # the two packages count apart: drawing from one leaves the other
    jax_uid.setup(0, 100000)
    uid.setup(0, 100000)
    jax_uid.uid_short()
    assert uid.uid_short() == jax_uid.uid_short() - 1


_JSON_BODIES = [
    {"index": "t", "query": {"match": {"content": "red apple"}}},
    {"index": "t", "query": {"match": {"_all": {"query": "red apple",
                                                "operator": "and"}}},
     "limit": 5, "offset": 2},
    {"index": "t", "query": {"match_phrase": {"content": "quick fox"}}},
    {"index": "t", "query": {"query_string": "@title (red | blue) -sky"}},
    {"index": "t", "query": {"match_all": {}}, "sort": [{"price": "desc"},
                                                         "_score"]},
    {"index": "t", "query": {"bool": {
        "must": [{"match": {"content": "apple"}},
                 {"range": {"price": {"gte": 2, "lt": 10.5}}}],
        "must_not": [{"equals": {"cat": 3}}],
        "should": [{"in": {"cat": [1, 2]}}]}}},
    {"index": "t", "query": {"bool": {"filter": [
        {"range": {"year": {"gt": 2001, "lte": 2010}}},
        {"equals": {"name": "bob"}}]}}, "size": 3, "from": 1,
     "_source": ["id", "price"]},
    {"index": "t", "query": {"match_all": {}},
     "aggs": {"by_cat": {"terms": {"field": "cat", "size": 5}}},
     "max_matches": 50},
    {"index": "t", "query": {"match": {"content": "x"}},
     "highlight": {"fields": {"content": {}}, "pre_tags": "<em>",
                   "post_tags": "</em>"}},
    {"index": "t", "query": {"nosuch": {}}},
    {"query": {"match": {"content": "no index"}}},
    {"index": "t", "query": {"match": {"a": "x", "b": "y"}}},
]


@pytest.mark.parametrize("k", range(len(_JSON_BODIES)))
def test_jsonquery_matches_jax(k):
    from manticoresearch_tpu.query import jsonquery as jax_jq
    from manticoresearch_tpu_torch.query import jsonquery as jq
    body = json.loads(json.dumps(_JSON_BODIES[k]))
    try:
        want, werr = jax_jq.parse_json_query(body), None
    except (jax_jq.JsonQueryError, jax_jq.JsonSearchError, ValueError,
            KeyError, TypeError) as e:
        want, werr = None, (type(e).__name__, str(e))
    body = json.loads(json.dumps(_JSON_BODIES[k]))
    try:
        got, gerr = jq.parse_json_query(body), None
    except (jq.JsonQueryError, jq.JsonSearchError, ValueError, KeyError,
            TypeError) as e:
        got, gerr = None, (type(e).__name__, str(e))
    assert werr == gerr
    assert _plain(want) == _plain(got)


def _write_sources(d) -> dict:
    """The corpora of ``tests/test_tools.py`` (jsonl, xmlpipe2, sqlite)
    and csv / tsv twins of the jsonl one."""
    import sqlite3
    docs = [
        dict(id=1, title="red apple", body="fresh fruit", price=10.5, cat=1),
        dict(id=2, title="green pear", body="sweet fruit", price=8.25, cat=1),
        dict(id=3, title="blue car", body="fast vehicle", price=999.0, cat=2),
    ]
    (d / "docs.jsonl").write_text("".join(json.dumps(x) + "\n" for x in docs))
    for ext, sep in (("csv", ","), ("tsv", "\t")):
        (d / f"docs.{ext}").write_text(
            sep.join(docs[0]) + "\n" + "".join(
                sep.join(str(v) for v in x.values()) + "\n" for x in docs))
    (d / "d.xml").write_text(
        '<sphinx:docset xmlns:sphinx="s">'
        '<sphinx:document id="1"><body>green apples</body>'
        '<price>3</price></sphinx:document>'
        '<sphinx:document id="2"><body>red apples</body>'
        '<price>5</price></sphinx:document>'
        '</sphinx:docset>')
    con = sqlite3.connect(str(d / "src.db"))
    con.execute("CREATE TABLE documents (id INTEGER, title TEXT, "
                "price INTEGER)")
    con.executemany("INSERT INTO documents VALUES (?, ?, ?)",
                    [(1, "first row", 10), (2, "second row", 20)])
    con.commit()
    con.close()
    (d / "conf.toml").write_text(_CONFIGS[0].format(d=d))
    return {
        "jsonl": ["--source", f"{d}/docs.jsonl", "--fields", "title,body",
                  "--attrs", "price=float,cat=uint"],
        "csv": ["--source", f"{d}/docs.csv", "--fields", "title,body",
                "--attrs", "price=float,cat=uint"],
        "tsv": ["--source", f"{d}/docs.tsv", "--fields", "title",
                "--attrs", "cat=uint"],
        "xmlpipe2": ["--source", f"{d}/d.xml", "--fields", "body",
                     "--attrs", "price=uint"],
        "sqlite": ["--source", f"{d}/src.db", "--fields", "title",
                   "--attrs", "price=uint", "--sql-query",
                   "SELECT id, title, price FROM documents WHERE price > 5"],
        "killlist": ["--source", f"{d}/docs.jsonl", "--fields", "title",
                     "--killlist", "7,9", "--killlist-target", "main:kl"],
    }


def _same_index_dir(a: _Path, b: _Path) -> None:
    """Every file byte for byte; ``arrays.npz`` array by array (its zip
    entries carry their write times)."""
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        if name.endswith(".npz"):
            za, zb = np.load(a / name), np.load(b / name)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert _plain(za[k]) == _plain(zb[k]), (name, k)
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("kind", ["jsonl", "csv", "tsv", "xmlpipe2",
                                  "sqlite", "killlist", "config"])
def test_indexer_output_matches_jax(tmp_path, kind):
    from manticoresearch_tpu.tools.indexer import main as jax_indexer
    from manticoresearch_tpu_torch.tools.indexer import main as indexer
    args = _write_sources(tmp_path)
    for tag, run in (("jax", jax_indexer), ("port", indexer)):
        if kind == "config":
            conf = (tmp_path / "conf.toml").read_text().replace(
                "idx/products", f"idx/{tag}")
            (tmp_path / f"{tag}.toml").write_text(conf)
            assert run(["--config", str(tmp_path / f"{tag}.toml"),
                        "--quiet"]) == 0
        else:
            assert run(args[kind] + ["--out", str(tmp_path / "idx" / tag),
                                     "--quiet"]) == 0
    _same_index_dir(tmp_path / "idx" / "jax", tmp_path / "idx" / "port")


def test_indexer_rotate_into_catalog_matches_jax(tmp_path):
    """``indexer --rotate`` writes ``<name>.new`` into each package's data
    directory; RELOAD TABLES swaps it in, and its kill list removes rows
    of its target table, in both packages alike."""
    from manticoresearch_tpu.tools.indexer import main as jax_indexer
    from manticoresearch_tpu_torch.tools.indexer import main as indexer
    from tests._torch_twin import port_dir
    args = _write_sources(tmp_path)
    data = tmp_path / "data"
    s = TwinSession(TwinCatalog(str(data)))
    s.execute("CREATE TABLE main (title text, body text, price float, "
              "cat uint)")
    s.execute("INSERT INTO main (id, title, body, price, cat) VALUES "
              "(7, 'old apple', 'x', 1.0, 1), (8, 'old pear', 'y', 2.0, 2), "
              "(9, 'red apple', 'z', 3.0, 3)")
    for run, d in ((jax_indexer, str(data)), (indexer, port_dir(str(data)))):
        assert run(args["jsonl"] + ["--out", f"{d}/delta", "--rotate",
                                    "--killlist", "7",
                                    "--killlist-target", "main", "--quiet"]
                   ) == 0
    _same_index_dir(data / "delta.new", _Path(port_dir(str(data))) /
                    "delta.new")
    for sql in ("RELOAD TABLES", "SHOW TABLES",
                "SELECT id, title FROM main ORDER BY id ASC",
                "SELECT id, WEIGHT() FROM delta WHERE MATCH('fruit')",
                "SELECT id FROM main, delta WHERE MATCH('apple') "
                "ORDER BY id ASC"):
        (r,) = s.execute(sql)
        assert r.error is None, (sql, r.error)
    s.close()


# port modules copied from the JAX package with only their imports (and
# their module docstring) changed
_VERBATIM_COPIES = (
    "__init__.py", "config.py", "exec/__init__.py", "exec/distributed.py",
    "exec/qcache.py", "exec/snippets.py", "index/__init__.py",
    "index/builder.py", "index/docstore.py", "index/merge.py", "index/pqfilter.py",
    "ops/__init__.py", "parallel/__init__.py", "plugins.py",
    "query/__init__.py", "query/ast.py", "query/explain.py",
    "query/ftparser.py", "query/jsonquery.py", "query/plan.py",
    "query/planner.py", "query/sphinxql.py", "schema.py",
    "server/__init__.py", "server/agent.py", "server/api.py",
    "server/cluster.py", "server/http.py", "server/mysql.py",
    "server/repl.py", "text/__init__.py", "text/charset.py",
    "text/dictionary.py", "text/htmlstrip.py", "text/morphology.py",
    "tools/__init__.py", "tools/indexer.py", "tools/indextool.py",
    "utils/__init__.py", "utils/geodist.py", "utils/jsonrender.py",
    "utils/uid.py")


class _DropImports(_ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _code_without_imports(path: _Path) -> str:
    tree = _ast.parse(path.read_text(), str(path))
    body = tree.body
    if (body and isinstance(body[0], _ast.Expr)
            and isinstance(body[0].value, _ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    tree.body = body
    return _ast.dump(_DropImports().visit(tree))


@pytest.mark.parametrize("rel", _VERBATIM_COPIES)
def test_copy_equals_jax_original_but_imports(rel):
    repo = _Path(__file__).resolve().parent.parent
    port = repo / "manticoresearch_tpu_torch" / rel
    jax_src = repo / "manticoresearch_tpu" / rel
    assert _code_without_imports(port) == _code_without_imports(jax_src)


# port modules that differ from their JAX original only by the ``device``
# plumbing (a ``device`` parameter, its ``--device`` option, and passing it
# on) and, in the daemon, the module name its watchdog starts
_DEVICE_COPIES = ("server/daemon.py", "tools/replay.py")
_DEVICE_PLUMBING = (
    r", device=(\'cuda\'|device|self\.catalog\.device|args\.device)",
    r"\n *ap\.add_argument\(\'--device\'[^\n]*\)")


def _code_unparsed(path: _Path) -> str:
    tree = _ast.parse(path.read_text(), str(path))
    if _ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return _ast.unparse(tree)


@pytest.mark.parametrize("rel", _DEVICE_COPIES)
def test_copy_differs_from_jax_by_device_only(rel):
    import re
    repo = _Path(__file__).resolve().parent.parent
    port = _code_unparsed(repo / "manticoresearch_tpu_torch" / rel)
    want = _code_unparsed(repo / "manticoresearch_tpu" / rel)
    assert port != want
    for pattern in _DEVICE_PLUMBING:
        port = re.sub(pattern, "", port)
    port = port.replace("manticoresearch_tpu_torch.server.daemon",
                        "manticoresearch_tpu.server.daemon")
    assert port == want


# port modules that differ from their JAX original only by a lock: each
# ``with self._native_mutex:`` block stands for its body, and ``__init__``
# may create the lock
_LOCK_COPIES = ("text/tokenizer.py",)


class _DropLock(_DropImports):
    """Unwraps ``with self._native_mutex:`` and drops the lock's creation
    in ``__init__`` (imports dropped too)."""

    @staticmethod
    def _is_lock(node) -> bool:
        return (isinstance(node, _ast.Attribute) and node.attr ==
                "_native_mutex" and isinstance(node.value, _ast.Name)
                and node.value.id == "self")

    def visit_With(self, node):
        self.generic_visit(node)
        if len(node.items) == 1 and self._is_lock(node.items[0].context_expr):
            return node.body
        return node

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        if node.name == "__init__":
            node.body = [st for st in node.body if not (
                isinstance(st, _ast.Assign) and len(st.targets) == 1
                and self._is_lock(st.targets[0]))]
        return node


def _code_without_lock(path: _Path) -> str:
    tree = _ast.parse(path.read_text(), str(path))
    if _ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return _ast.dump(_DropLock().visit(tree))


@pytest.mark.parametrize("rel", _LOCK_COPIES)
def test_copy_differs_from_jax_by_lock_only(rel):
    repo = _Path(__file__).resolve().parent.parent
    port = repo / "manticoresearch_tpu_torch" / rel
    jax_src = repo / "manticoresearch_tpu" / rel
    assert _code_without_imports(port) != _code_without_imports(jax_src)
    assert _code_without_lock(port) == _code_without_lock(jax_src)


# functions of the port's bench (tools/bench.py) copied from bench.py:
# equal statement by statement but for imports, docstrings and the
# synchronize of the index's cards after each batch
_BENCH_COPIES = ("_run_batches", "parity_recall_at_10", "_emit_error")


class _DropSync(_DropImports):
    """Drops ``_sync(...)`` statements (imports dropped too)."""

    def visit_Expr(self, node):
        call = node.value
        if (isinstance(call, _ast.Call) and isinstance(call.func, _ast.Name)
                and call.func.id == "_sync"):
            return None
        return node


def _function_dump(path: _Path, name: str, transformer) -> str:
    tree = _ast.parse(path.read_text(), str(path))
    (fn,) = [n for n in tree.body
             if isinstance(n, _ast.FunctionDef) and n.name == name]
    if _ast.get_docstring(fn) is not None:
        fn.body = fn.body[1:]
    return _ast.dump(transformer().visit(fn))


@pytest.mark.parametrize("name", _BENCH_COPIES)
def test_bench_copy_equals_bench_py_but_imports_and_sync(name):
    repo = _Path(__file__).resolve().parent.parent
    port = repo / "manticoresearch_tpu_torch" / "tools" / "bench.py"
    original = repo / "bench.py"
    assert _function_dump(port, name, _DropSync) == \
        _function_dump(original, name, _DropSync)
    synced = _function_dump(port, name, _DropImports) != \
        _function_dump(original, name, _DropImports)
    assert synced == (name == "_run_batches")
