"""Single-index search on PyTorch: plan, run, hydrate.

Counterpart of ``manticoresearch_tpu/exec/searcher.py`` for the main path:
parse and plan on the host with the port's copies of the JAX package's
parser and planner, decode every packed posting window of the batch in one
grouped call, run ``ops.search`` on the index's device, hydrate the
result. ``SearchQuery``, ``Match``, ``WordStat`` and ``SearchResult`` have
the fields of the JAX module's.

Every MATCH shape of the JAX package runs: the boolean operators, the
positional operators (phrase, proximity, NEAR / NOTNEAR, SENTENCE,
PARAGRAPH, bigram), field, position and zone limits (ZONESPAN included),
wildcard merge groups and repeated keywords, under the rankers
proximity_bm25, bm25, proximity, wordcount, matchany, none and fieldmask,
in the dense, sparse-union and filter-first row spaces. Not in the port
yet, each raising ``NotImplementedError``: GROUP BY, JSON ORDER BY, late
filters (expressions, and MVA values past 32 bits), ``ranker=expr`` /
``sph04`` and ``PACKEDFACTORS()``, and indexes of more than 32 full-text
fields (``ops.search.check_in_slice``). A filter on a JSON path goes to
the planner, which evaluates it on the host into a row bitmask.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from ..index.builder import PackedIndex
from ..ops.device_index import upload
from ..ops.packed_store import decode_grouped
from ..ops.search import (INT32_MAX, INT32_MIN, build_kernel, pack_output,
                          packed_windows)
from ..query.explain import render_plan
from ..query.ftparser import FtQueryParser
from ..query.planner import AttrFilterDef, CompiledQuery, plan_query
from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer


@dataclass
class SearchQuery:
    match: str = ""
    filters: list[AttrFilterDef] = dc_field(default_factory=list)
    # boolean combination of `filters`: ("leaf", i) | ("and"/"or", (...));
    # None = AND of all
    filter_tree: tuple | None = None
    limit: int = 20
    offset: int = 0
    max_matches: int = 1000
    ranker: str = "proximity_bm25"
    field_weights: dict[str, int] = dc_field(default_factory=dict)
    # sort: list of (key, asc) — key is "weight", "id", or attr name;
    # None = implicit relevance sort
    sort: list[tuple[str, bool]] | None = None
    idf_plain: bool = False
    tfidf_normalized: bool = True
    expansion_limit: int = 0
    boolean_simplify: bool = False
    expand_keywords: bool = False
    global_idf: bool = False
    collation: str = "binary"
    select: list[str] | None = None      # None = * (all attrs)
    cutoff: int = 0
    group_by: str | None = None
    group_n: int = 1
    having: tuple | None = None
    within_sort: list[tuple[str, bool]] | None = None
    not_only_allowed: bool = False
    implicit_group: bool = False


@dataclass
class WordStat:
    word: str
    docs: int
    hits: int


@dataclass
class Match:
    docid: int
    weight: int
    attrs: dict[str, Any]


@dataclass
class SearchResult:
    matches: list[Match]
    total: int            # matches available in the result window
    total_found: int      # total matching docs
    time_ms: float
    word_stats: list[WordStat]
    error: str | None = None
    warning: str | None = None
    profile: list = dc_field(default_factory=list)  # (stage, seconds) pairs
    schema: object = None


def _wants_packedfactors(select) -> bool:
    return any(s.lower().replace(" ", "").startswith("packedfactors(")
               for s in (select or []))


def _check_query_in_slice(q: SearchQuery, schema) -> None:
    """Refuse, before planning, what the port does not run. ranker=expr
    (and sph04, and PACKEDFACTORS() which forces it) stops here: the
    port's planner has no expression ranker. The plan shapes the search
    program does not run raise from ``ops.search.check_in_slice``."""
    def no(feature: str):
        raise NotImplementedError(f"{feature} is not ported to the PyTorch "
                                  "search path yet")
    if isinstance(q.ranker, tuple) or q.ranker in ("expr", "sph04"):
        no(f"ranker={q.ranker if isinstance(q.ranker, str) else 'expr'}")
    if _wants_packedfactors(q.select):
        no("PACKEDFACTORS()")
    if q.group_by:
        no("GROUP BY")
    if q.sort and "." in q.sort[0][0]:
        no("ORDER BY a JSON path")
    for f in q.filters:
        ad = schema.attr(f.attr)
        if ad is not None and ad.type.value in ("multi", "multi64") and any(
                v is not None and abs(int(v)) > INT32_MAX
                for v in [*(f.values or []), f.lo, f.hi]):
            no(f"filter on {f.attr!r} with MVA values past 32 bits (a late "
               "filter)")
        if ad is not None or f.attr in ("id", "@id"):
            continue
        base = schema.attr(f.attr.split(".", 1)[0])
        if not (re.fullmatch(r"\w+(\.\w+)+", f.attr) and base is not None
                and base.type.value == "json"):
            no(f"filter on {f.attr!r} (expression or unknown attribute)")


def _resolve_order(q: SearchQuery, schema) -> tuple:
    sort = q.sort or [("weight", False), ("id", True)]
    primary, asc = sort[0]
    if primary in ("weight", "@weight", "weight()"):
        return ("rel",)
    if primary in ("id", "@id"):
        return ("attr_id", asc)
    ad = schema.attr(primary)
    if ad is None:
        raise ValueError(f"sort-by attribute '{primary}' not found")
    return ("attr", primary, asc, ad.type.value == "float")


class SearchIndex:
    """A searchable index: host PackedIndex + tensors on ``device`` (the
    card unless the caller asks for "cpu") + the text pipeline."""

    def __init__(self, packed: PackedIndex, device="cuda"):
        self.packed = packed
        self.device = upload(packed, device)
        self.tokenizer = Tokenizer(packed.tokenizer_settings)
        self.dictionary = Dictionary(packed.dict_settings)
        self.parser = FtQueryParser(
            self.tokenizer, self.dictionary, packed.schema.fields)
        self._plan_cache: dict = {}

    @property
    def schema(self):
        return self.packed.schema

    @property
    def n_docs(self) -> int:
        return self.packed.n_docs

    def delete_documents(self, docids: list[int]) -> int:
        """Dead-row map update (DeadRowMap_c semantics, killlist.h:22)."""
        alive = self.device.alive.cpu().numpy().copy()
        killed = 0
        for d in docids:
            r = self.packed.rowid_of_docid(int(d))
            if r >= 0 and alive[r]:
                alive[r] = False
                killed += 1
        if killed:
            self.device.alive = torch.from_numpy(alive).to(self.device.device)
        return killed

    # ------------------------------------------------------------------
    def plan(self, q: SearchQuery) -> CompiledQuery:
        _check_query_in_slice(q, self.schema)
        key = (
            q.match, q.ranker, q.max_matches, q.offset + q.limit,
            tuple(q.sort or ()), q.idf_plain, q.tfidf_normalized,
            q.expansion_limit, q.boolean_simplify, q.expand_keywords,
            q.collation, q.not_only_allowed,
            tuple(sorted(q.field_weights.items())),
            tuple((f.attr, f.kind, tuple(f.values), f.lo, f.hi, f.exclude,
                   f.lo_excl, f.hi_excl) for f in q.filters),
            q.filter_tree,
        )
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached
        ast = self.parser.parse(q.match,
                                not_only_allowed=q.not_only_allowed)
        cq = plan_query(
            ast, self.packed,
            filters=q.filters, ranker=q.ranker, max_matches=q.max_matches,
            filter_tree=q.filter_tree, window=q.offset + q.limit,
            order=_resolve_order(q, self.schema),
            field_weights=q.field_weights,
            idf_plain=q.idf_plain, tfidf_normalized=q.tfidf_normalized,
            expansion_limit=q.expansion_limit,
            packed_store=self.packed.packed_store(),
            boolean_simplify=q.boolean_simplify,
            expand_keywords=q.expand_keywords,
            collation=q.collation,
        )
        if len(self._plan_cache) > 8192:
            self._plan_cache.clear()
        self._plan_cache[key] = cq
        return cq

    def _program(self, cq: CompiledQuery):
        return build_kernel(cq.sig, self.packed.n_docs,
                            max(self.schema.n_fields, 1),
                            cq.slot_pb, cq.slot_hb, cq.n_hit_iters)

    def _decode_windows(self, data: dict,
                        plans: list[CompiledQuery]) -> list[list]:
        """Every packed posting window the plans' programs read, decoded in
        one ``decode_grouped`` call; -> per plan, its program's
        ``decoded`` slices in order."""
        wins = [packed_windows(cq.sig, cq.slot_pb, data, cq.runtime)
                for cq in plans]
        items = [w for ws in wins for w in ws]
        if not items:
            return [[] for _ in plans]
        out, offsets = decode_grouped(items)
        flat = [part.view(-1) for part in out.split(np.diff(offsets).tolist())]
        per_plan, j = [], 0
        for ws in wins:
            per_plan.append(flat[j:j + len(ws)])
            j += len(ws)
        return per_plan

    def search(self, q: SearchQuery) -> SearchResult:
        _check_query_in_slice(q, self.schema)
        t0 = time.perf_counter()
        prof: list[tuple[str, float]] = []
        try:
            cq = self.plan(q)
        except (ValueError, NotImplementedError) as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        prof.append(("parse_and_plan", time.perf_counter() - t0))
        fn = self._program(cq)
        t1 = time.perf_counter()
        data = self.device.data_pytree()
        decoded = self._decode_windows(data, [cq])[0]
        row = pack_output(fn(data, cq.runtime, decoded))
        row = row.cpu().numpy()
        prof.append(("device_exec_fetch", time.perf_counter() - t1))
        t2 = time.perf_counter()
        k = cq.sig.k
        res = self._finish(q, cq, row[:k], row[k:2 * k], int(row[2 * k]), t0)
        prof.append(("finalize", time.perf_counter() - t2))
        res.profile = prof
        if cq.warning:
            res.warning = cq.warning
        return res

    def search_batch(self, queries: list[SearchQuery]) -> list[SearchResult]:
        """One grouped decode of every query's packed posting windows (one
        launch of the bit-plane kernel on the card, whatever the plan
        shapes), then the queries grouped by plan shape run group by group;
        every group's [B, 2k+1] result goes into one tensor, fetched to the
        host once."""
        t0 = time.perf_counter()
        results: list[SearchResult | None] = [None] * len(queries)
        plans: list[CompiledQuery | None] = [None] * len(queries)
        groups: dict[tuple, list[int]] = {}
        for i, q in enumerate(queries):
            _check_query_in_slice(q, self.schema)
            try:
                cq = self.plan(q)
            except (ValueError, NotImplementedError) as e:
                results[i] = SearchResult([], 0, 0, 0.0, [], error=str(e))
                continue
            plans[i] = cq
            key = (cq.sig, cq.slot_pb, cq.slot_hb, cq.n_hit_iters)
            groups.setdefault(key, []).append(i)

        data = self.device.data_pytree()
        order = [i for idxs in groups.values() for i in idxs]
        decoded = dict(zip(order, self._decode_windows(
            data, [plans[i] for i in order])))
        outs = []
        for idxs in groups.values():
            fn = self._program(plans[idxs[0]])
            outs.append(torch.stack(
                [pack_output(fn(data, plans[i].runtime, decoded[i]))
                 for i in idxs]))
        if not outs:
            return results  # type: ignore[return-value]
        flat = torch.cat([o.reshape(-1) for o in outs]).cpu().numpy()
        off = 0
        for idxs, o in zip(groups.values(), outs):
            n = o.numel()
            block = flat[off:off + n].reshape(o.shape)
            off += n
            k = plans[idxs[0]].sig.k
            for bi, i in enumerate(idxs):
                row = block[bi]
                results[i] = self._finish(queries[i], plans[i], row[:k],
                                          row[k:2 * k], int(row[2 * k]), t0)
        return results  # type: ignore[return-value]

    def _finish(self, q: SearchQuery, cq: CompiledQuery,
                rowids: np.ndarray, weights: np.ndarray, found: int,
                t0: float) -> SearchResult:
        if q.cutoff:
            found = min(found, q.cutoff)
        n_avail = min(found, cq.sig.k)
        rowids = rowids[:n_avail]
        weights = weights[:n_avail]
        if cq.sig.order[0] == "rel":
            keep = weights != INT32_MIN
            rowids, weights = rowids[keep], weights[keep]
        lo = min(q.offset, len(rowids))
        hi = min(q.offset + q.limit, len(rowids))
        rowids, weights = rowids[lo:hi], weights[lo:hi]

        matches = self._hydrate(rowids, weights, q.select)
        for m, r in zip(matches, rowids.tolist()):
            m._rowid = int(r)   # physical row within this index
        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in cq.stat_list]
        res = SearchResult(matches, min(found, q.max_matches), found, dt,
                           stats)
        res.plan_repr = render_plan(cq.ast, self.schema)
        return res

    def _hydrate(self, rowids: np.ndarray, weights: np.ndarray,
                 select: list[str] | None) -> list[Match]:
        p = self.packed
        out = []
        attr_names = (
            select if select is not None
            else [a.name for a in p.schema.attrs] + list(p.stored_fields)
        )
        for r, w in zip(rowids.tolist(), weights.tolist()):
            attrs: dict[str, Any] = {}
            for name in attr_names:
                if name in ("id", "weight()", "weight"):
                    continue
                if "." in name and name.split(".", 1)[0] in p.attrs_json:
                    name = name.split(".", 1)[0]   # hydrate the JSON base
                if name in p.attrs_int:
                    attrs[name] = int(p.attrs_int[name][r])
                elif name in p.attrs_big:
                    attrs[name] = int(p.attrs_big[name][r])
                elif name in p.attrs_float:
                    attrs[name] = float(p.attrs_float[name][r])
                elif name in p.attrs_str:
                    attrs[name] = p.attrs_str[name][r]
                elif name in p.attrs_json:
                    attrs[name] = p.attrs_json[name][r]
                elif name in p.attrs_mva:
                    off, vals = p.attrs_mva[name]
                    attrs[name] = [int(x) for x in vals[off[r]:off[r + 1]]]
                elif name in p.stored_fields:
                    attrs[name] = p.stored_fields[name][r]
            out.append(Match(int(p.doc_ids[r]), int(w), attrs))
        return out
