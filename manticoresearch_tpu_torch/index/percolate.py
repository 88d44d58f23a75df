"""Percolate index: stored queries matched against incoming documents.

Behavioral model: PercolateIndex_c (Manticore src/sphinxpq.cpp:70):
the table stores parsed queries (+ optional attribute filters and tags);
CALL PQ('idx', docs) matches each document against every stored query
(MatchDocuments:79), with term-based segment rejects as a pre-filter
(SegmentGetRejects:216).

The incoming doc batch builds one small PackedIndex (the batch IS the
index — reverse of normal search), uploaded once to the table's device
(the card unless the caller asks for "cpu"); then every stored query runs
against it through the ordinary device engine, one search per stored
query; a host-side term-reject prefilter skips queries whose required
terms don't appear in the batch dictionary at all.

The port's counterpart of ``manticoresearch_tpu/index/percolate.py``: a
copy that adds the ``device`` of the batch index.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..schema import Schema
from ..text.dictionary import DictSettings
from ..text.tokenizer import TokenizerSettings


@dataclass
class StoredQuery:
    qid: int
    query: str
    filters: str = ""                      # re-rendered display form
    tags: list[str] = field(default_factory=list)
    required_terms: tuple[str, ...] = ()   # any-of reject prefilter
    ftree: object = None                   # parsed pqfilter tree
    raw_filters: str = ""                  # original text (persistence)


class PercolateIndex:
    def __init__(self, name: str, schema: Schema,
                 tokenizer_settings: TokenizerSettings | None = None,
                 dict_settings: DictSettings | None = None,
                 data_dir: str | None = None, device="cuda"):
        self.name = name
        self.device = device       # the batch index's SearchIndex device
        self.schema = schema
        self.tok_settings = tokenizer_settings or TokenizerSettings()
        self.dict_settings = dict_settings or DictSettings()
        self.queries: dict[int, StoredQuery] = {}
        self._next_id = 1
        self.data_dir = data_dir
        if data_dir:
            import os
            os.makedirs(data_dir, exist_ok=True)
            self._load()

    def search(self, q):
        """SELECT over the stored-query table (a PQ table inside a
        distributed index serves its queries as rows; the reference's
        PercolateIndex_c implements MultiQuery over the meta schema)."""
        from ..exec.searcher import Match, SearchResult
        stored = sorted(self.queries.values(), key=lambda x: x.qid)
        matches = [Match(s2.qid, 1,
                         {"query": s2.query, "tags": " ".join(s2.tags),
                          "filters": s2.filters})
                   for s2 in stored]
        total = len(matches)
        matches = matches[q.offset:q.offset + q.limit]
        return SearchResult(matches, min(total, q.max_matches), total,
                            0.0, [])

    # -- store / manage queries ----------------------------------------
    def add_query(self, query: str, filters: str = "",
                  tags: list[str] | None = None, qid: int | None = None
                  ) -> int:
        from ..text.dictionary import Dictionary
        from ..text.tokenizer import Tokenizer
        from ..query.ftparser import FtQueryParser

        # validate the query parses against the schema now (reference
        # stores the parsed XQ tree)
        parser = FtQueryParser(Tokenizer(self.tok_settings),
                               Dictionary(self.dict_settings),
                               self.schema.fields)
        ast = parser.parse(query)  # raises on bad syntax
        req = tuple(sorted(_collect_any_terms(ast)))

        from .pqfilter import parse_filters, render_filters
        raw = filters or ""
        attr_names = {a.name for a in self.schema.attrs}
        ftree = parse_filters(raw, attr_names)   # raises PqFilterError
        display = render_filters(ftree)
        if qid is None:
            # UUID-short auto ids (UidShort, sphinxutils.cpp:3357): the
            # deterministic test-mode base 100000<<24 + a daemon-global
            # counter — the reference harness records these literal ids
            from ..utils.uid import uid_short
            qid = uid_short()
        self._next_id = max(self._next_id, qid + 1)
        self.queries[qid] = StoredQuery(qid, query, display, tags or [],
                                        req, ftree, raw)
        self._save()
        return qid

    def truncate(self) -> None:
        """TRUNCATE on a percolate table drops every stored query
        (RtIndex_c::Truncate applies to PQ tables too)."""
        self.queries = {}
        self._save()

    def delete_query(self, qids: list[int]) -> int:
        n = 0
        for q in qids:
            if q in self.queries:
                del self.queries[q]
                n += 1
        if n:
            self._save()
        return n

    @property
    def n_docs(self) -> int:  # SHOW TABLES compat
        return len(self.queries)

    # -- matching ------------------------------------------------------
    def match_documents(self, docs: list[dict], *, query_filter_tags=None
                        ) -> list[tuple[int, list[int]]]:
        """Returns [(query_id, [doc_ordinals 1-based])] for matching queries
        (CALL PQ result shape)."""
        from ..exec.searcher import SearchIndex, SearchQuery
        from ..index.builder import IndexBuilder
        from ..query.sphinxql import SqlParser
        from ..exec.session import _cond_to_filter

        if not docs:
            return []
        b = IndexBuilder(self.schema, self.tok_settings, self.dict_settings)
        id_map = {}
        for i, d in enumerate(docs, 1):
            doc = dict(d)
            doc["id"] = i
            id_map[i] = i
            b.add_document(doc)
        packed = b.build()
        batch = SearchIndex(packed, self.device)
        batch_terms = set(packed.term_strs)

        out = []
        for sq in self.queries.values():
            if query_filter_tags and not (set(query_filter_tags) &
                                          set(sq.tags)):
                continue
            # term-reject prefilter (SegmentGetRejects analog)
            if sq.required_terms and not any(
                    t in batch_terms for t in sq.required_terms):
                continue
            res = batch.search(SearchQuery(
                match=sq.query, limit=len(docs),
                max_matches=max(len(docs), 1)))
            if res.error or not res.matches:
                continue
            matches = res.matches
            if sq.ftree is not None:
                from .pqfilter import eval_filters
                matches = [m for m in matches
                           if eval_filters(sq.ftree, m.attrs, m.weight,
                                           m.docid)]
            if not matches:
                continue
            out.append((sq.qid, [id_map[m.docid] for m in matches]))
        return sorted(out)

    # -- persistence ----------------------------------------------------
    def _save(self) -> None:
        if not self.data_dir:
            return
        import os
        path = os.path.join(self.data_dir, "queries.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "schema": self.schema.to_json(),
                "queries": [
                    {"id": q.qid, "query": q.query,
                     "filters": q.raw_filters, "tags": q.tags}
                    for q in self.queries.values()
                ],
            }, f)
        os.replace(tmp, path)

    def _load(self) -> None:
        import os
        path = os.path.join(self.data_dir, "queries.json")
        if not os.path.exists(path):
            return
        with open(path) as f:
            data = json.load(f)
        for q in data.get("queries", []):
            try:
                self.add_query(q["query"], q.get("filters", ""),
                               q.get("tags"), qid=int(q["id"]))
            except ValueError:
                continue


def _collect_any_terms(ast) -> set[str]:
    """Terms such that at least one must appear for the query to match
    (an OR-safe underestimate used only as a reject prefilter)."""
    from ..query.ast import (QAnd, QAndNot, QNear, QOr, QPhrase, QQuorum,
                             QTerm)

    if isinstance(ast, QTerm):
        return set() if ast.wildcard else {ast.word}
    if isinstance(ast, (QPhrase, QQuorum)):
        return set(ast.words)
    if isinstance(ast, QAnd):
        for c in ast.children:
            t = _collect_any_terms(c)
            if t:
                return t  # any AND child's requirement suffices
        return set()
    if isinstance(ast, QOr):
        out: set[str] = set()
        for c in ast.children:
            t = _collect_any_terms(c)
            if not t:
                return set()  # one OR branch unconstrained -> no prefilter
            out |= t
        return out
    if isinstance(ast, QAndNot):
        return _collect_any_terms(ast.left)
    if isinstance(ast, QNear):
        return _collect_any_terms(ast.left) or set()
    return set()
