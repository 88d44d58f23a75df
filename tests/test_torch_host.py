"""Port parity: the port's own host side against the JAX package's.

The port carries copies of the JAX package's host modules (schema, text
pipeline, query parser and planner, index builder, the packed store's
build, the bench corpus and query generator). Each copy must give exactly
what the original gives on the same input:

- ``IndexBuilder`` on the example.sql documents and on a seeded mixed
  corpus (every attribute kind, two fields, non-ASCII and edge-case text),
  and ``build_from_pretokenized`` on a seeded 2,000-doc bench corpus:
  every array of ``PackedIndex`` and of ``packed_store()`` equal. The JAX
  builder takes its native bulk path here where the library is present;
  the port has only the Python path, so this also holds the two paths
  equal;
- the tokenizer, the dictionary and ``FtQueryParser`` on a fixed list of
  text and query strings: equal tokens, terms and ASTs (or the same error);
- ``plan_query`` on the queries of ``tests/test_torch_search.py``: equal
  ``PlanSig`` and runtime arrays, every other field of the plan, and the
  same ``render_plan`` text of its transformed tree;
- ``WorkloadGen``: the same draws from the same seed;
- ``from_jax_packed``: a copy equal to the JAX index and to the port's own
  build of the same documents, sharing no array with its source.

Tolerance: exact. Everything compared is an integer, string, boolean or a
float32 array copied or computed by the same numpy expression.
"""
import dataclasses
import json
import enum

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

from .test_search import DOCS
from .test_torch_search import (EXAMPLE_QUERIES, N_RANDOM, _jax_query,
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


CORPORA = {
    "example": (["title", "content"],
                [("group_id", "UINT"), ("group_id2", "UINT")], DOCS),
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
    jax_cq = jax_plan_query(
        parser.parse(jq.match), jax_packed, filters=jq.filters,
        ranker=jq.ranker, max_matches=jq.max_matches,
        filter_tree=jq.filter_tree, window=jq.offset + jq.limit,
        order=order, field_weights=jq.field_weights,
        idf_plain=jq.idf_plain, tfidf_normalized=jq.tfidf_normalized,
        expansion_limit=jq.expansion_limit,
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
