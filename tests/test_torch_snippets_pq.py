"""Port parity: snippets and percolate tables, JAX vs the port.

- Every case of ``tests/test_snippets_pq.py`` runs again here: its
  sessions are the twins of ``tests/_torch_twin.py`` (every ``QLResult``
  of a JAX ``Session`` and of the port's on ``device="cpu"`` equal), and
  its ``build_snippet`` calls go to both packages' ``build_snippet`` with
  the same text, query, tokenizer and dictionary settings and options,
  the two strings held equal. The two cases of ``TestJsonHighlight`` run
  their ``/json/search`` requests with ``highlight`` through a JAX
  ``HttpServer`` and the port's over twin catalogs (``TwinHttp`` of
  ``tests/_torch_wire.py``: status and JSON bodies equal, ``took``
  masked).
- ``build_snippet`` on seeded texts (words, sentences, paragraphs and
  HTML) under every field of ``SnippetOptions``, and CALL SNIPPETS under
  every alias of ``OPTION_ALIASES``.
- ``pqfilter``: seeded filter strings parsed (the trees compared field by
  field, or the same error), rendered and evaluated on seeded documents.
- percolate persistence: a ``PercolateIndex`` with a ``data_dir`` is
  reopened and matches the same documents as the JAX package's.

Tolerance: exact (strings, ids and booleans).
"""
import dataclasses

import jax
import numpy as np
import pytest

import tests.test_snippets_pq as base
from manticoresearch_tpu.exec import snippets as jax_snip
from manticoresearch_tpu.index import pqfilter as jax_pqf
from manticoresearch_tpu.index.percolate import PercolateIndex as JaxPQ
from manticoresearch_tpu.schema import (AttrDef as JaxAttrDef,
                                        AttrType as JaxAttrType,
                                        Schema as JaxSchema)
from manticoresearch_tpu.text import dictionary as jax_dict
from manticoresearch_tpu.text import tokenizer as jax_tok
from manticoresearch_tpu_torch.exec import snippets as port_snip
from manticoresearch_tpu_torch.index import pqfilter as port_pqf
from manticoresearch_tpu_torch.index.percolate import PercolateIndex as PortPQ
from manticoresearch_tpu_torch.schema import (AttrDef as PortAttrDef,
                                              AttrType as PortAttrType,
                                              Schema as PortSchema)
from manticoresearch_tpu_torch.text import dictionary as port_dict
from manticoresearch_tpu_torch.text import tokenizer as port_tok
from tests._torch_twin import TwinCatalog, TwinSession
from tests.test_torch_host import _plain
from tests.test_snippets_pq import sess  # noqa: F401  (the twin session)

_jax_build_snippet = jax_snip.build_snippet


def _copy(obj, cls):
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)})


def twin_build_snippet(text, query, tokenizer, dictionary, opts=None):
    """Both packages' ``build_snippet`` on the same inputs: the strings
    must be equal; the JAX package's is returned."""
    want = _jax_build_snippet(text, query, tokenizer, dictionary, opts)
    got = port_snip.build_snippet(
        text, query,
        port_tok.Tokenizer(_copy(tokenizer.settings,
                                 port_tok.TokenizerSettings)),
        port_dict.Dictionary(_copy(dictionary.settings,
                                   port_dict.DictSettings)),
        None if opts is None else _copy(opts, port_snip.SnippetOptions))
    assert got == want, (text, query, opts, got, want)
    return want


@pytest.fixture(autouse=True)
def _twins(monkeypatch):
    monkeypatch.setattr(base, "Session", TwinSession)
    monkeypatch.setattr(base, "Catalog", TwinCatalog)
    monkeypatch.setattr(base, "build_snippet", twin_build_snippet)
    yield
    jax.clear_caches()


class TestSnippets(base.TestSnippets):
    pass


class TestPercolate(base.TestPercolate):
    pass


class TestJsonHighlight(base.TestJsonHighlight):
    @pytest.fixture(autouse=True)
    def _twin_http(self, monkeypatch):
        """Its cases import ``Catalog``, ``Session`` and ``HttpServer``
        from the JAX modules inside the test body: those names become
        twins built from the JAX classes and the port's."""
        from manticoresearch_tpu.exec import session as jax_session
        from manticoresearch_tpu.server import http as jax_http
        from manticoresearch_tpu_torch.exec import session as port_session
        from manticoresearch_tpu_torch.server.http import \
            HttpServer as PortHttpServer
        from tests._torch_wire import TwinHttp
        jax_cat, jax_sess = jax_session.Catalog, jax_session.Session
        jax_server = jax_http.HttpServer

        class Catalog(TwinCatalog):
            def __init__(self):
                self.jax = jax_cat()
                self.port = port_session.Catalog(device="cpu")

        class Session(TwinSession):
            # the JAX module reaches its session registry by this name
            _next_tid, _registry = jax_sess._next_tid, jax_sess._registry

            def __init__(self, catalog):
                self.twin_catalog = catalog
                self.jax = jax_sess(catalog.jax)
                self.port = port_session.Session(catalog.port)

        def http_server(catalog):
            return TwinHttp(jax_server(catalog.jax),
                            PortHttpServer(catalog.port))
        monkeypatch.setattr(jax_session, "Catalog", Catalog)
        monkeypatch.setattr(jax_session, "Session", Session)
        monkeypatch.setattr(jax_http, "HttpServer", http_server)


class TestSnippetOptions(base.TestSnippetOptions):
    @pytest.fixture(autouse=True)
    def _twin_module(self, monkeypatch):
        """Its cases import ``build_snippet`` from the JAX module inside
        the test body."""
        monkeypatch.setattr(jax_snip, "build_snippet", twin_build_snippet)


# -- build_snippet on seeded texts under every option --------------------
_WORDS = ("alpha beta gamma delta needle hay stack river stone cloud "
          "light tree apple pie").split()


def _texts(seed: int, n: int = 6) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 5))):          # paragraphs
            sent = []
            for _ in range(int(rng.integers(1, 4))):      # sentences
                k = int(rng.integers(3, 40))
                ws = [_WORDS[i] for i in rng.integers(0, len(_WORDS), k)]
                if rng.random() < 0.3:
                    j = int(rng.integers(0, k))
                    ws[j] = f"<i>{ws[j]}</i>"
                sent.append(" ".join(ws).capitalize() + ".")
            parts.append(" ".join(sent))
        out.append("\n\n".join(parts) if rng.random() < 0.5
                   else "<p>" + "</p><p>".join(parts) + "</p>")
    return out


def _option_values(name: str, default):
    if name == "passage_boundary":
        return ["sentence", "paragraph"]
    if name == "html_strip_mode":
        return ["none", "strip", "index", "retain"]
    if name in ("before_match", "after_match"):
        return ["[%PASSAGE_ID%>", "<<"]
    if name == "chunk_separator":
        return [" | "]
    if isinstance(default, bool):
        return [not default]
    if isinstance(default, int):
        return [0, 1, 3, 24] if name != "start_passage_id" else [0, 7]
    raise AssertionError(f"no values for option {name}")


_FIELDS = [f.name for f in dataclasses.fields(jax_snip.SnippetOptions)]


def test_option_fields_are_the_same():
    assert _FIELDS == [f.name for f in
                       dataclasses.fields(port_snip.SnippetOptions)]
    assert jax_snip.OPTION_ALIASES == port_snip.OPTION_ALIASES


@pytest.mark.parametrize("name", _FIELDS)
def test_build_snippet_option(name):
    tok, dic = jax_tok.Tokenizer(), jax_dict.Dictionary()
    default = getattr(jax_snip.SnippetOptions(), name)
    texts = _texts(len(name))
    rng = np.random.default_rng(len(name) + 100)
    for value in _option_values(name, default):
        for around in (2, 5):
            opts = jax_snip.SnippetOptions(around=around, limit=120)
            setattr(opts, name, value)
            for text in texts:
                q = " ".join(_WORDS[i] for i in
                             rng.integers(0, len(_WORDS), 2))
                twin_build_snippet(text, q, tok, dic, opts)
                twin_build_snippet(text, f'"{q}"', tok, dic, opts)


_ALIAS_VALUES = {"snippet_separator": "' ~ '", "snippet_boundary":
                 "'sentence'", "limit_snippets": "1",
                 "start_snippet_id": "5", "force_snippets": "1"}


@pytest.mark.parametrize("alias", sorted(jax_snip.OPTION_ALIASES))
def test_call_snippets_alias(alias):
    s = TwinSession()
    s.execute("CREATE TABLE t (content text)")
    texts = _texts(len(alias), 3)
    for text in texts:
        lit = text.replace("'", "\\'")
        for q in ("needle", "apple pie", "alpha"):
            s.execute(f"CALL SNIPPETS('{lit}', 't', '{q}', 3 AS around, "
                      f"'<%PASSAGE_ID%>' AS before_match, 60 AS limit, "
                      f"{_ALIAS_VALUES[alias]} AS {alias})")


# -- pqfilter --------------------------------------------------------------
_ATTRS = {"gid", "price", "tags", "name", "j"}


def _leaf(rng) -> str:
    n = lambda: int(rng.integers(0, 12))  # noqa: E731
    forms = [
        lambda: f"gid {['>', '>=', '<', '<=', '=', '!=', '<>'][n() % 7]} "
                f"{n()}",
        lambda: f"gid IN ({n()}, {n()}, {n()})",
        lambda: f"gid NOT IN ({n()}, {n()})",
        lambda: f"gid BETWEEN {n()} AND {n() + 5}",
        lambda: f"price > {n() / 4}",
        lambda: f"price <= {n() / 3:.2f}",
        lambda: f"name = '{_WORDS[n()]}'",
        lambda: f"name IN ('{_WORDS[n()]}', '{_WORDS[n()]}')",
        lambda: f"ANY(tags) = {n()}",
        lambda: f"ALL(tags) < {n() + 1}",
        lambda: f"tags IN ({n()}, {n()})",
        lambda: f"j.k > {n()}",
        lambda: f"j.s = '{_WORDS[n()]}'",
        lambda: f"gid + {n()} > price",
        lambda: f"nosuch > {n()}",
    ]
    return forms[int(rng.integers(0, len(forms)))]()


def _filter_strings(seed: int, n: int = 40) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        parts = [_leaf(rng) for _ in range(k)]
        s = parts[0]
        for p in parts[1:]:
            op = " AND " if rng.random() < 0.6 else " OR "
            s = f"({s}){op}{p}" if rng.random() < 0.3 else s + op + p
        out.append(s)
    return out


def _docs(seed: int, n: int = 12) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"gid": int(rng.integers(0, 12)),
             "price": float(np.float32(rng.integers(0, 16) / 4)),
             "tags": sorted(int(x) for x in rng.integers(0, 14, 3)),
             "name": _WORDS[int(rng.integers(0, len(_WORDS)))],
             "j": {"k": int(rng.integers(0, 12)),
                   "s": _WORDS[int(rng.integers(0, len(_WORDS)))]}}
            for _ in range(n)]


def _parse(mod, s):
    try:
        return mod.parse_filters(s, _ATTRS), None
    except ValueError as e:
        return None, (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(6))
def test_pqfilter_parse_render_eval(seed):
    docs = _docs(seed + 50)
    parsed = 0
    for s in _filter_strings(seed):
        jt, jerr = _parse(jax_pqf, s)
        pt, perr = _parse(port_pqf, s)
        assert jerr == perr, s
        if jerr:
            continue
        parsed += 1
        assert _plain(jt) == _plain(pt), s
        assert jax_pqf.render_filters(jt) == port_pqf.render_filters(pt), s
        for i, d in enumerate(docs):
            assert jax_pqf.eval_filters(jt, d, i, i + 1) == \
                port_pqf.eval_filters(pt, d, i, i + 1), (s, d)
    assert parsed >= 10


# -- percolate persistence -------------------------------------------------
def _pq_schema(schema_cls, attr_cls, type_cls):
    return schema_cls(fields=["content"],
                      attrs=[attr_cls("gid", type_cls.UINT)])


def test_percolate_index_persistence(tmp_path):
    tables = {}
    for tag, cls, schema in [
            ("jax", JaxPQ, _pq_schema(JaxSchema, JaxAttrDef, JaxAttrType)),
            ("port", PortPQ, _pq_schema(PortSchema, PortAttrDef,
                                        PortAttrType))]:
        kw = {} if tag == "jax" else {"device": "cpu"}
        d = str(tmp_path / tag)
        pq = cls("pq", schema, data_dir=d, **kw)
        for i, (q, f) in enumerate([("red | blue", ""),
                                    ("apple pie", "gid > 3"),
                                    ('"quick fox"', ""),
                                    ("sky -cloud", "gid IN (1, 2)")]):
            pq.add_query(q, f, tags=[f"t{i % 2}"], qid=10 + i)
        pq.delete_query([12])
        tables[tag] = cls("pq", schema, data_dir=d, **kw)   # reopened
    docs = [{"content": "red apple pie", "gid": 5},
            {"content": "blue sky", "gid": 1},
            {"content": "the quick fox and a cloud", "gid": 2},
            {"content": "sky", "gid": 9}]
    j, p = tables["jax"], tables["port"]
    assert [(q.qid, q.query, q.filters, q.tags) for q in
            j.queries.values()] == [(q.qid, q.query, q.filters, q.tags)
                                    for q in p.queries.values()]
    assert j.match_documents(docs) == p.match_documents(docs)
    assert j.match_documents(docs, query_filter_tags=["t1"]) == \
        p.match_documents(docs, query_filter_tags=["t1"])
