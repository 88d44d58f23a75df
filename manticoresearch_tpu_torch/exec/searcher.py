"""Single-index search on PyTorch: plan, run, hydrate.

Counterpart of ``manticoresearch_tpu/exec/searcher.py``: parse and plan on
the host with the port's copies of the JAX package's parser and planner,
decode every packed posting window of the batch in one grouped call, run
``ops.search`` (ranked queries) and ``ops.groupby`` (GROUP BY) on the
index's device, hydrate the result. ``SearchQuery``, ``Match``,
``WordStat`` and ``SearchResult`` have the fields of the JAX module's.

Every MATCH shape of the JAX package runs: the boolean operators, the
positional operators (phrase, proximity, NEAR / NOTNEAR, SENTENCE,
PARAGRAPH, bigram), field, position and zone limits (ZONESPAN included),
wildcard merge groups and repeated keywords, under the rankers
proximity_bm25, bm25, proximity, wordcount, matchany, none, fieldmask,
sph04 and the expression ranker (``ranker=expr('...')``, and
``PACKEDFACTORS()`` in the select list), in the dense, sparse-union and
filter-first row spaces, on indexes of any number of full-text fields; so
do GROUP BY on the device, the JAX package's host routes (GROUP BY a JSON
path, an MVA or a bigint, GROUP N BY, a string WITHIN GROUP ORDER BY, and
any group-by expression that only the host evaluates), late filters
(expressions, and MVA values past 32 bits) and ORDER BY a JSON path. A
filter on a JSON path goes to the planner, which evaluates it on the host
into a row bitmask. ``search_batch`` gives every query ``search``'s
result, PACKEDFACTORS() included (the JAX package's batch leaves it out).

Each query runs as a generator (``_steps``) that yields the device work it
needs, a ranked plan or a group-by plan, and receives its outputs; host
routes wrap the same generator around their sub-query. ``search`` drives
one generator, ``search_batch`` drives them all together: each round
decodes the windows of every pending plan in one ``decode_grouped`` call,
runs the programs plan shape by plan shape and fetches every output row in
one copy. Every path of the JAX package needs one round, so a batch makes
one launch of the bit-plane kernel whatever its mix of queries.
"""
from __future__ import annotations

import operator
import re
import threading
import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Any

import numpy as np
import torch

from ..index.builder import PackedIndex
from ..ops.device_index import upload
from ..ops.groupby import (AggSpec, GroupSpec, build_groupby,
                           pack_groupby_output, probe_groupby,
                           unpack_groupby_row)
from ..ops.packed_store import decode_lists
from ..ops.search import (INT32_MIN, build_kernel, pack_output,
                          packed_windows, unpack_factors)
from ..query.explain import render_plan
from ..query.expr import ExprError, eval_expr_host, infer_is_float, parse_expr
from ..query.ftparser import FtQueryParser
from ..query.planner import AttrFilterDef, CompiledQuery, plan_query
from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer
from .multi import _apply_sort, ref_group_sort


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
    group_by: str | None = None          # attr name or expression
    group_n: int = 1                     # GROUP N BY: rows kept per group
    having: tuple | None = None          # (colname, op, value) host filter
    # WITHIN GROUP ORDER BY: which member represents the group; None =
    # weight desc, id asc
    within_sort: list[tuple[str, bool]] | None = None
    not_only_allowed: bool = False
    # aggregates without GROUP BY: the rep-row replace rule compares ROWID
    # only (CheckReplaceEntry, sphinxsort.cpp:4420)
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


_AGG_RE = re.compile(
    r"^\s*(count|sum|min|max|avg)\s*\(\s*(distinct\s+)?(.*?)\s*\)\s*$",
    re.IGNORECASE)
_GCONCAT_RE = re.compile(r"^\s*group_concat\s*\(\s*(.*?)\s*\)\s*$",
                         re.IGNORECASE)
_HAVING_OPS = {"=": operator.eq, "!=": operator.ne, "<>": operator.ne,
               "<": operator.lt, "<=": operator.le, ">": operator.gt,
               ">=": operator.ge}


def _wants_packedfactors(select) -> bool:
    return any(s.lower().replace(" ", "").startswith("packedfactors(")
               for s in (select or []))


def _render_packed_factors(pf: dict, j: int, fields, slot_terms,
                           runtime, as_json: bool = False) -> str:
    """Text form of the factor blob (PACKEDFACTORS() / the SPH_UDF_FACTORS
    layout rendered like the reference's ToString path): doc-level factors,
    then per-field blocks for matched fields, then per-word tf/idf."""
    def _f(v):
        # PrintVarFloat (sphinxutils.cpp:2377): "%f" (6 decimals) when it
        # round-trips to the same float32, else "%1.8f"
        f32 = np.float32(v)
        s2 = f"{float(f32):.6f}"
        if np.float32(float(s2)) == f32:
            return s2
        return f"{float(f32):.8f}"

    if as_json:
        fields_out = []
        for f, fname in enumerate(fields):
            if not int(pf["pf_hit_count"][j, f]):
                continue
            fields_out.append(
                f'{{"field":{f}, "lcs":{int(pf["pf_lcs"][j, f])}, '
                f'"hit_count":{int(pf["pf_hit_count"][j, f])}, '
                f'"word_count":{int(pf["pf_word_count"][j, f])}, '
                f'"tf_idf":{_f(pf["pf_tf_idf"][j, f])}, '
                f'"min_idf":{_f(pf["pf_min_idf"][j, f])}, '
                f'"max_idf":{_f(pf["pf_max_idf"][j, f])}, '
                f'"sum_idf":{_f(pf["pf_sum_idf"][j, f])}, '
                f'"min_hit_pos":{int(pf["pf_min_hit_pos"][j, f])}, '
                f'"min_best_span_pos":'
                f'{int(pf["pf_min_best_span_pos"][j, f])}, '
                f'"exact_hit":{int(pf["pf_exact_hit"][j, f])}, '
                f'"max_window_hits":'
                f'{int(pf["pf_max_window_hits"][j, f])}, '
                f'"min_gaps":{int(pf["pf_min_gaps"][j, f])}, '
                f'"exact_order":{int(pf["pf_exact_order"][j, f])}, '
                f'"lccs":{int(pf["pf_lccs"][j, f])}, '
                f'"wlccs":{_f(pf["pf_wlccs"][j, f])}, '
                f'"atc":{_f(pf["pf_atc"][j, f])}}}')
        idf = np.asarray(runtime["idf"])
        words_out = []
        for s, term in enumerate(slot_terms):
            tf = int(pf["pf_word_tf"][j, s])
            if tf:
                words_out.append(f'{{"tf":{tf}, "idf":{_f(idf[s])}}}')
        return (f'{{"bm25":{int(pf["pf_bm25"][j])}, '
                f'"bm25a":{_f(pf["pf_bm25a"][j])}, '
                f'"field_mask":{int(pf["pf_field_mask"][j])}, '
                f'"doc_word_count":{int(pf["pf_doc_word_count"][j])}, '
                f'"fields":[{", ".join(fields_out)}], '
                f'"words":[{", ".join(words_out)}]}}')
    parts = [
        f"bm25={int(pf['pf_bm25'][j])}, "
        f"bm25a={_f(pf['pf_bm25a'][j])}, "
        f"field_mask={int(pf['pf_field_mask'][j])}, "
        f"doc_word_count={int(pf['pf_doc_word_count'][j])}",
    ]
    for f, fname in enumerate(fields):
        if not int(pf["pf_hit_count"][j, f]):
            continue
        parts.append(
            f"field{f}=(lcs={int(pf['pf_lcs'][j, f])}, "
            f"hit_count={int(pf['pf_hit_count'][j, f])}, "
            f"word_count={int(pf['pf_word_count'][j, f])}, "
            f"tf_idf={_f(pf['pf_tf_idf'][j, f])}, "
            f"min_idf={_f(pf['pf_min_idf'][j, f])}, "
            f"max_idf={_f(pf['pf_max_idf'][j, f])}, "
            f"sum_idf={_f(pf['pf_sum_idf'][j, f])}, "
            f"min_hit_pos={int(pf['pf_min_hit_pos'][j, f])}, "
            f"min_best_span_pos={int(pf['pf_min_best_span_pos'][j, f])}, "
            f"exact_hit={int(pf['pf_exact_hit'][j, f])}, "
            f"max_window_hits={int(pf['pf_max_window_hits'][j, f])}, "
            f"min_gaps={int(pf['pf_min_gaps'][j, f])}, "
            f"exact_order={int(pf['pf_exact_order'][j, f])}, "
            f"lccs={int(pf['pf_lccs'][j, f])}, "
            f"wlccs={_f(pf['pf_wlccs'][j, f])}, "
            f"atc={_f(pf['pf_atc'][j, f])})")
    idf = np.asarray(runtime["idf"])
    qpos_r = np.asarray(runtime.get("qpos", np.arange(1, len(slot_terms) + 1)))
    for s, term in enumerate(slot_terms):
        tf = int(pf["pf_word_tf"][j, s])
        if tf:
            # word index = query position - 1 (PackFactors iterates
            # qpos entries; dupes leave gaps: word0..word2, word4, word6)
            wi = int(qpos_r[s]) - 1 if s < len(qpos_r) else s
            parts.append(f"word{wi}=(tf={tf}, idf={_f(idf[s])})")
    return ", ".join(parts)


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


def _resolve_group_order(q: SearchQuery, schema) -> tuple:
    sort = q.sort or [("weight", False), ("id", True)]
    primary, asc = sort[0]
    p = primary.lower().replace(" ", "")
    if p in ("weight", "@weight", "weight()"):
        return ("rel",)
    if p in ("@count", "count(*)"):
        return ("count", asc)
    if p in ("@groupby", "groupby()") or primary == q.group_by:
        return ("gkey", asc)
    if p in ("id", "@id"):
        return ("rowid", asc)
    ad = schema.attr(primary)
    if ad is not None:
        return ("attr", primary, asc, ad.type.value == "float")
    raise ValueError(f"unsupported group ORDER BY {primary!r}")


def _json_base(schema, name: str) -> bool:
    """Whether a dotted name is a path into a JSON attribute."""
    ad = schema.attr(name.split(".", 1)[0])
    return ad is not None and ad.type.value == "json"


class SearchIndex:
    """A searchable index: host PackedIndex + tensors on ``device`` (the
    card unless the caller asks for "cpu") + the text pipeline."""

    def __init__(self, packed: PackedIndex, device="cuda"):
        self.packed = packed
        self.device = upload(packed, device)
        self.tokenizer = Tokenizer(packed.tokenizer_settings)
        self.dictionary = Dictionary(packed.dict_settings)
        self._parsers = threading.local()
        self._plan_cache: dict = {}
        self._attr_dtypes = {k: v.dtype for k, v in
                             self.device.data_pytree()["attrs"].items()}

    @property
    def parser(self) -> FtQueryParser:
        """This thread's query parser. ``FtQueryParser`` keeps its parse
        state on the instance, so each thread that searches the index (the
        SphinxAPI listener's workers) parses with its own; the JAX package
        shares one between threads (ROADMAP queue 3)."""
        parser = getattr(self._parsers, "parser", None)
        if parser is None:
            parser = self._parsers.parser = FtQueryParser(
                self.tokenizer, self.dictionary, self.packed.schema.fields)
        return parser

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
        emit_factors = _wants_packedfactors(q.select)
        key = (
            q.match, q.ranker, q.max_matches, q.offset + q.limit,
            tuple(q.sort or ()), q.idf_plain, q.tfidf_normalized,
            emit_factors, q.expansion_limit, q.boolean_simplify, q.expand_keywords,
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
            emit_factors=emit_factors, expansion_limit=q.expansion_limit,
            packed_store=self.packed.packed_store(),
            boolean_simplify=q.boolean_simplify,
            expand_keywords=q.expand_keywords,
            collation=q.collation,
        )
        self._cache_put(key, cq)
        return cq

    def _cache_put(self, key, value) -> None:
        if len(self._plan_cache) > 8192:
            self._plan_cache.clear()
        self._plan_cache[key] = value

    def search(self, q: SearchQuery) -> SearchResult:
        return self._drive([q])[0]

    def search_batch(self, queries: list[SearchQuery]) -> list[SearchResult]:
        """Every query's device work in one round: one grouped decode of
        every packed posting window (one launch of the bit-plane kernel on
        the card, whatever the plan shapes and however many are grouped),
        then the plans grouped by shape run group by group; every output
        row goes into one tensor, fetched to the host once."""
        return self._drive(queries)

    # ------------------------------------------------------------------
    # driving the per-query generators
    # ------------------------------------------------------------------
    def _drive(self, queries: list[SearchQuery]) -> list[SearchResult]:
        return self._drive_steps([self._steps(q) for q in queries])

    def _drive_steps(self, gens: list) -> list[SearchResult]:
        """Drive generators of device work (``_steps``) together, one round
        of device work at a time, until each has returned its result."""
        results: list[SearchResult | None] = [None] * len(gens)
        pending: dict[int, tuple] = {}
        for i, g in enumerate(gens):
            self._advance(i, g, None, pending, results)
        while pending:
            items = list(pending.items())
            pending = {}
            replies = self._run_round([req for _, req in items])
            for (i, _), reply in zip(items, replies):
                self._advance(i, gens[i], reply, pending, results)
        return results  # type: ignore[return-value]

    @staticmethod
    def _advance(i, gen, reply, pending: dict, results: list) -> None:
        try:
            req = gen.send(reply)
        except StopIteration as stop:
            results[i] = stop.value
        else:
            pending[i] = req

    def _run_round(self, reqs: list[tuple]) -> list:
        """Run one round of device work: ("rank", cq) -> (rowids, weights,
        found, seconds, PACKEDFACTORS() arrays or None); ("group", cq,
        gspec) -> the group-by outputs as numpy."""
        t0 = time.perf_counter()
        n_docs = self.packed.n_docs
        n_fields = max(self.schema.n_fields, 1)
        progs = []
        for req in reqs:
            cq = req[1]
            if req[0] == "rank":
                progs.append(("rank", cq.sig, cq.slot_pb, cq.slot_hb,
                              cq.n_hit_iters))
            else:
                progs.append(("group", cq.sig, req[2], cq.slot_pb,
                              cq.slot_hb, cq.n_hit_iters))
        shapes: dict[tuple, list[int]] = {}
        for j, key in enumerate(progs):
            shapes.setdefault(key, []).append(j)
        data = self.device.data_pytree()
        order = [j for js in shapes.values() for j in js]
        decoded = dict(zip(order, self._decode_windows(
            data, [reqs[j][1] for j in order])))
        outs = []
        for key, js in shapes.items():
            if key[0] == "rank":
                fn = build_kernel(key[1], n_docs, n_fields, *key[2:])
                rows = [pack_output(fn(data, reqs[j][1].runtime, decoded[j]))
                        for j in js]
            else:
                fn = build_groupby(key[1], key[2], n_docs, n_fields, *key[3:])
                rows = [pack_groupby_output(
                    fn(data, reqs[j][1].runtime, decoded[j]), key[2])
                    for j in js]
            outs.append((key, js, torch.stack(rows)))
        replies: list = [None] * len(reqs)
        flat = torch.cat([o.reshape(-1) for _, _, o in outs]).cpu().numpy()
        dt = time.perf_counter() - t0
        off = 0
        for key, js, o in outs:
            block = flat[off:off + o.numel()].reshape(o.shape)
            off += o.numel()
            for bi, j in enumerate(js):
                row = block[bi]
                if key[0] == "rank":
                    k = key[1].k
                    pf = (unpack_factors(row[2 * k + 1:], k, n_fields,
                                         key[1].n_slots)
                          if row.shape[0] > 2 * k + 1 else None)
                    replies[j] = (row[:k], row[k:2 * k], int(row[2 * k]), dt,
                                  pf)
                else:
                    replies[j] = unpack_groupby_row(row, key[2])
        return replies

    def _decode_windows(self, data: dict,
                        plans: list[CompiledQuery]) -> list[list]:
        """Every packed posting window the plans' programs read, decoded in
        one ``decode_grouped`` call; -> per plan, its program's
        ``decoded`` slices in order. (A group-by program that forces a
        dense plan reads the same windows.)"""
        return decode_lists([packed_windows(cq.sig, cq.slot_pb, data,
                                            cq.runtime) for cq in plans])

    # ------------------------------------------------------------------
    # the query paths, as generators of device work
    # ------------------------------------------------------------------
    def _steps(self, q: SearchQuery):
        late = late_filters_for(q, self.schema)
        if late:
            res = yield from self._steps(late_filter_window(q, late))
            return apply_late_filters(res, q, late)
        if q.group_by:
            gb = q.group_by
            if "." in gb and self.schema.attr(gb) is None \
                    and _json_base(self.schema, gb):
                return (yield from self._host_grouped(q))
            return (yield from self._search_grouped(q))
        primary = (q.sort or [("weight", False)])[0][0]
        if "." in primary and _json_base(self.schema, primary):
            # JSON-path ORDER BY: fetch the match window (bounded by
            # max_matches, like the reference sorter) and host-sort
            wide = replace(q, sort=[("weight", False), ("id", True)],
                           offset=0, limit=q.max_matches)
            res = yield from self._steps(wide)
            if res.error:
                return res
            _apply_sort(res.matches, q)
            res.matches = res.matches[q.offset:q.offset + q.limit]
            return res
        return (yield from self._search_ranked(q))

    def _search_ranked(self, q: SearchQuery):
        t0 = time.perf_counter()
        try:
            cq = self.plan(q)
        except (ValueError, NotImplementedError) as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        t_plan = time.perf_counter() - t0
        rowids, weights, found, t_dev, pf = yield ("rank", cq)
        t2 = time.perf_counter()
        res = self._finish(q, cq, rowids, weights, found, t0, pf)
        res.profile = [("parse_and_plan", t_plan),
                       ("device_exec_fetch", t_dev),
                       ("finalize", time.perf_counter() - t2)]
        if cq.warning:
            res.warning = cq.warning
        return res

    def _host_grouped(self, q: SearchQuery):
        """GROUP BY on the host: the key is host-evaluated per match (the
        reference also computes JSON grouping via host expressions);
        aggregates reduce in Python over the match window (bounded by
        max_matches)."""
        t0 = time.perf_counter()
        try:
            parse_expr(q.group_by)
        except ExprError as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        base_q = replace(q, group_by=None, select=None, having=None,
                         sort=(q.within_sort
                               or [("weight", False), ("id", True)]),
                         offset=0, limit=q.max_matches)
        res = yield from self._steps(base_q)
        if res.error:
            return res
        rows, total = self._host_group_body(res.matches, q)
        dt = (time.perf_counter() - t0) * 1000.0
        return SearchResult(rows, total, total, dt, res.word_stats)

    def _host_group_body(self, matches, q):
        # one index = one grouper streaming matches in scan order: the
        # rep-row rules are the sorter's own push rules (shared_grouper)
        return host_group_matches(matches, q, shared_grouper=True)

    def _search_grouped(self, q: SearchQuery):
        """GROUP BY on the device (CSphKBufferGroupSorter semantics via the
        sort-segment-reduce tail, ops/groupby.py), or the host route where
        the JAX package takes it."""
        t0 = time.perf_counter()
        if self.packed.n_docs == 0:
            return SearchResult([], 0, 0, 0.0, [])
        gb_ad = self.schema.attr(q.group_by)
        # bigint keys group host-side: the device key array is i32-clipped,
        # which would collapse distinct 64-bit values
        host_only = (gb_ad is not None
                     and gb_ad.type.value in ("multi", "multi64", "bigint"))
        if gb_ad is None and self._expr_refs_bigint(q.group_by):
            host_only = True   # expression keys over bigint attrs too
        if getattr(q, "group_n", 1) > 1:
            host_only = True   # GROUP N BY emits N member rows per group
        if q.within_sort:
            wad = self.schema.attr(q.within_sort[0][0])
            if wad is not None and wad.type.value not in (
                    "int", "bigint", "bool", "timestamp", "float"):
                host_only = True   # string/JSON rep order: host compare
        if host_only:
            # GROUP BY an MVA attr duplicates the match into one group per
            # value (sphinxsort MVA group iterator)
            return (yield from self._host_grouped(q))
        try:
            plan = self._plan_grouped(q)
        except (ValueError, NotImplementedError) as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        (cq, gspec, aggs, agg_names, plain_cols, gconcats, k) = plan
        try:
            # an expression only the host evaluates (e.g. COUNT(DISTINCT
            # id): 64-bit ids live host-side) raises here, as running the
            # program would, before the round
            probe_groupby(gspec, self._attr_dtypes)
        except ExprError:
            return (yield from self._host_grouped(q))
        out = yield ("group", cq, gspec)
        return self._render_grouped(q, cq, gspec, out, aggs, agg_names,
                                    plain_cols, gconcats, k, t0)

    def _expr_refs_bigint(self, expr_text: str) -> bool:
        """True when an expression references a bigint attr — such keys
        must group host-side (device arrays are i32-clipped)."""
        try:
            tree = parse_expr(expr_text)
        except ExprError:   # not an expression: the device plan reports it
            return False
        found = False

        def walk(t):
            nonlocal found
            if isinstance(t, (list, tuple)):
                if len(t) >= 2 and t[0] == "attr" \
                        and isinstance(t[1], str):
                    ad = self.schema.attr(t[1])
                    if ad is not None and ad.type.value == "bigint":
                        found = True
                for x in t:
                    if isinstance(x, (list, tuple)):
                        walk(x)
        walk(tree)
        return found

    def _plan_grouped(self, q: SearchQuery):
        """Plan a device GROUP BY query: (cq, gspec, aggs, agg_names,
        plain_cols, gconcats, k). Raises ValueError/NotImplementedError on
        unsupported shapes. Cached like ``plan`` on every field it reads."""
        key = ("group", q.match, q.not_only_allowed, q.ranker,
               q.max_matches, q.offset, q.limit, q.idf_plain,
               q.tfidf_normalized, tuple(sorted(q.field_weights.items())),
               tuple((f.attr, f.kind, tuple(f.values), f.lo, f.hi,
                      f.exclude, f.lo_excl, f.hi_excl) for f in q.filters),
               q.filter_tree, q.group_by, tuple(q.select or ()),
               tuple(q.sort or ()), tuple(q.within_sort or ()))
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached
        ast = self.parser.parse(q.match,
                                not_only_allowed=q.not_only_allowed)
        cq = plan_query(
            ast, self.packed,
            filters=q.filters, ranker=q.ranker,
            filter_tree=q.filter_tree,
            max_matches=q.max_matches, window=q.offset + q.limit,
            order=("rel",), field_weights=q.field_weights,
            idf_plain=q.idf_plain, tfidf_normalized=q.tfidf_normalized,
            packed_store=self.packed.packed_store(),
        )
        key_expr = parse_expr(q.group_by)
        aggs: list[AggSpec] = []
        agg_names: list[str] = []
        plain_cols: list[str] = []
        gconcats: list[tuple[str, str]] = []
        for sel in (q.select or ["count(*)"]):
            gm = _GCONCAT_RE.match(sel)
            if gm:
                # GROUP_CONCAT runs host-side over the match mask
                # (sphinxsort.cpp:1904+ computes it on CPU too)
                if self.schema.attr(q.group_by) is None:
                    raise NotImplementedError(
                        "GROUP_CONCAT requires a plain-attribute GROUP BY")
                gconcats.append((sel, gm.group(1)))
                continue
            m = _AGG_RE.match(sel)
            if not m:
                if sel == "*":
                    # SELECT * in a grouped query returns every attr of
                    # the group's representative row
                    plain_cols.extend(
                        a.name for a in self.schema.attrs
                        if a.name != q.group_by
                        and a.name not in plain_cols)
                elif sel not in ("id", "weight()") and sel != q.group_by:
                    plain_cols.append(sel)
                continue
            kind = m.group(1).lower()
            arg = m.group(3)
            arg_ad = self.schema.attr(arg.strip())
            if kind != "count" and arg_ad is not None and \
                    arg_ad.type.value in ("multi", "multi64", "string",
                                          "json"):
                raise ValueError(
                    f"can not aggregate non-scalar attribute "
                    f"'{arg.strip()}'")
            if kind == "count" and m.group(2):
                aggs.append(AggSpec("count_distinct", parse_expr(arg)))
            elif kind == "count":
                aggs.append(AggSpec("count", None))
            else:
                tree = parse_expr(arg)
                aggs.append(AggSpec(
                    kind, tree, infer_is_float(tree, self.schema)))
            agg_names.append(sel)
        if "count(*)" not in [a.lower().replace(" ", "")
                              for a in agg_names]:
            aggs.append(AggSpec("count", None))
            agg_names.append("count(*)")

        order = _resolve_group_order(q, self.schema)
        within: tuple = ("rel",)
        if q.within_sort:
            wname, wasc = q.within_sort[0]
            if wname in ("weight", "@weight", "weight()"):
                within = ("rel",)
            elif wname in ("id", "@id"):
                within = ("rowid", wasc)
            else:
                wad = self.schema.attr(wname)
                if wad is None:
                    raise ValueError(
                        f"unknown WITHIN GROUP ORDER BY attr {wname!r}")
                within = ("attr", wname, wasc, wad.type.value == "float")
        k = max(1, min(q.max_matches, q.offset + q.limit,
                       max(self.packed.n_docs, 1)))
        gspec = GroupSpec(key_expr=key_expr, aggs=tuple(aggs),
                          order=order, k=k,
                          emit_eligible=bool(gconcats), within=within)
        plan = (cq, gspec, tuple(aggs), tuple(agg_names),
                tuple(plain_cols), tuple(gconcats), k)
        self._cache_put(key, plan)
        return plan

    def _render_grouped(self, q, cq, gspec, out, aggs, agg_names,
                        plain_cols, gconcats, k, t0) -> SearchResult:
        rep_rowid = out["rep_rowid"]
        rep_weight = out["rep_weight"]
        gkey = out["group_key"]
        count = out["count"]
        n_groups = int(out["n_groups"])

        n_avail = min(n_groups, k)
        gb_ad = self.schema.attr(q.group_by)
        str_uniq = (self.packed.str_ordinals(q.group_by)[0]
                    if gb_ad is not None and gb_ad.type.value == "string"
                    else None)
        rows = []
        for i in range(n_avail):
            r = int(rep_rowid[i])
            if str_uniq is not None:
                gv = int(gkey[i])
                keyval = str_uniq[gv] if 0 <= gv < len(str_uniq) else ""
            else:
                keyval = int(gkey[i])
            attrs = {q.group_by: keyval}
            for j, name in enumerate(agg_names):
                a = aggs[j]
                if a.kind == "count":
                    attrs[name] = int(count[i])
                else:
                    v = out[f"agg{j}"][i]
                    attrs[name] = float(v) if a.kind == "avg" or a.is_float \
                        else int(v)
            need = set(plain_cols or [])
            # projection expressions re-evaluate over the rep match's
            # attrs: hydrate every schema attr a select expr references
            for sel in (q.select or []):
                for tok in re.findall(r"[A-Za-z_][A-Za-z_0-9]*", sel):
                    if self.schema.attr(tok) is not None:
                        need.add(tok)
            base = self._hydrate(np.asarray([r]), np.asarray([rep_weight[i]]),
                                 sorted(need))
            attrs.update(base[0].attrs)
            attrs["@groupby"] = keyval
            rows.append(Match(base[0].docid, int(rep_weight[i]), attrs))

        if gconcats:
            elig = out["eligible"][: self.packed.n_docs]
            keycol = self._host_column(q.group_by)
            live = np.nonzero(elig)[0]
            for sel, arg in gconcats:
                argcol = self._host_column(arg)
                mp: dict = {}
                for r in live:
                    mp.setdefault(keycol[int(r)], []).append(
                        str(argcol[int(r)]))
                joined = {k2: ",".join(v) for k2, v in mp.items()}
                for m2 in rows:
                    m2.attrs[sel] = joined.get(m2.attrs.get(q.group_by), "")

        if q.having is not None:
            col, op_s, val = q.having
            rows = [m for m in rows
                    if _HAVING_OPS[op_s](
                        m.attrs.get(col, m.weight
                                    if col in ("weight()", "@weight") else 0),
                        val)]

        rows = rows[q.offset:q.offset + q.limit]
        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in cq.stat_list]
        return SearchResult(rows, min(n_groups, q.max_matches), n_groups,
                            dt, stats)

    def _finish(self, q: SearchQuery, cq: CompiledQuery,
                rowids: np.ndarray, weights: np.ndarray, found: int,
                t0: float, pf: dict | None = None) -> SearchResult:
        if q.cutoff:
            found = min(found, q.cutoff)
        n_avail = min(found, cq.sig.k)
        sel = np.arange(n_avail)
        rowids = rowids[:n_avail]
        weights = weights[:n_avail]
        if cq.sig.order[0] == "rel":
            keep = weights != INT32_MIN
            rowids, weights, sel = rowids[keep], weights[keep], sel[keep]
        lo = min(q.offset, len(rowids))
        hi = min(q.offset + q.limit, len(rowids))
        rowids, weights, sel = rowids[lo:hi], weights[lo:hi], sel[lo:hi]

        matches = self._hydrate(rowids, weights, q.select)
        for m, r in zip(matches, rowids.tolist()):
            m._rowid = int(r)   # physical row within this index
        if pf is not None:
            pf_keys = [s2 for s2 in (q.select or [])
                       if s2.lower().replace(" ", "").startswith(
                           "packedfactors(")]
            for m, j in zip(matches, sel.tolist()):
                for pk in (pf_keys or ["packedfactors()"]):
                    as_json = "json=1" in pk.lower().replace(" ", "")
                    m.attrs[pk] = _render_packed_factors(
                        pf, j, self.schema.fields, cq.slot_terms,
                        cq.runtime, as_json=as_json)
        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in cq.stat_list]
        res = SearchResult(matches, min(found, q.max_matches), found, dt,
                           stats)
        res.plan_repr = render_plan(cq.ast, self.schema)
        return res

    def _host_column(self, name: str):
        """One attribute as a host-side per-row sequence (actual values —
        strings, not ordinals)."""
        p = self.packed
        if name == "id":
            return p.doc_ids
        for store in (p.attrs_int, p.attrs_big, p.attrs_float, p.attrs_str,
                      p.attrs_json, p.stored_fields):
            if name in store:
                return store[name]
        raise ValueError(f"unknown attribute {name!r}")

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


# --------------------------------------------------------------------------
# late filters
# --------------------------------------------------------------------------
def late_filters_for(q, schema) -> list:
    """Filters naming a computed expression instead of an attr (the
    reference's late-stage filters, sphinxfilter.cpp expr filters), and
    64-bit MVA values past the device's int32 value pool: evaluated
    host-side over the match window."""
    out = []
    for f in q.filters:
        nm = f.attr
        ad = schema.attr(nm)
        if ad is not None and ad.type.value in ("multi", "multi64") and any(
                x is not None and abs(int(x)) > 2**31 - 1
                for x in [*(f.values or []), f.lo, f.hi]):
            out.append(f)
            continue
        if ad is not None or nm in ("id", "@id"):
            continue
        if re.fullmatch(r"\w+(\.\w+)+", nm) and _json_base(schema, nm):
            continue   # JSON-path filters run on their own path
        try:
            parse_expr(nm)
        except ExprError:
            continue   # let the planner report the unknown attr
        out.append(f)
    return out


def late_filter_window(q, late: list):
    """The query without its late filters, over the whole match window."""
    lset = {id(f) for f in late}
    return replace(q, filters=[f for f in q.filters if id(f) not in lset],
                   offset=0, limit=q.max_matches)


def apply_late_filters(res, q, late: list):
    """Filter ``late_filter_window``'s result host-side and cut q's
    window."""
    if res.error:
        return res
    trees = [(parse_expr(f.attr), f) for f in late]

    def passes(m) -> bool:
        for tree, f in trees:
            try:
                v = eval_expr_host(tree, m.attrs, m.weight, m.docid)
            except ExprError:
                return False
            vs = v if isinstance(v, (list, tuple)) else [v]
            if f.kind == "values":
                ok = any(x in f.values for x in vs)
            else:
                def in_range(x):
                    if x is None:
                        return False
                    if f.lo is not None and (
                            x < f.lo or (f.lo_excl and x == f.lo)):
                        return False
                    if f.hi is not None and (
                            x > f.hi or (f.hi_excl and x == f.hi)):
                        return False
                    return True
                ok = any(in_range(x) for x in vs)
            if ok == bool(f.exclude):
                return False
        return True

    kept = [m for m in res.matches if passes(m)]
    total = len(kept)
    res.matches = kept[q.offset:q.offset + q.limit]
    res.total = min(total, q.max_matches)
    res.total_found = total
    return res


def run_late_filtered(search_fn, q, late):
    """Strip late filters, run wide via search_fn, post-filter host-side."""
    return apply_late_filters(search_fn(late_filter_window(q, late)), q,
                              late)


# --------------------------------------------------------------------------
# host GROUP BY
# --------------------------------------------------------------------------
def host_group_matches(matches, q, shared_grouper=False):
    """Host-side GROUP BY over an already-fetched match list (bounded
    by max_matches upstream). Returns (rows, n_groups).

    shared_grouper: the parts are chunks of ONE index streamed through a
    single sorter (a COUNT(DISTINCT) sorter can't be cloned —
    CanBeCloned(), sphinxsort.cpp:4360): the group rep follows the
    push-order replace rules instead of the per-part group merge."""
    key_tree = parse_expr(q.group_by)
    selects = list(q.select or ["count(*)"])
    if not any(_AGG_RE.match(s2) for s2 in selects):
        selects.append("count(*)")

    def keyof(m):
        try:
            v = eval_expr_host(key_tree, m.attrs, m.weight, m.docid)
        except ExprError:
            v = None
        if isinstance(v, list):
            # MVA group key: the match lands in one group PER value
            # (sphinxsort MVA group iterator)
            return v
        return v if not isinstance(v, dict) else str(v)

    # group-creation order = push order: parts sequentially, each part in
    # scan (rowid) order; MVA values expand in stored (sorted) order.
    # This order is observable through SortGroups()'s tie handling
    # (ref_group_sort) — full ties surface REVERSED.
    groups: dict = {}
    for m in sorted(matches,
                    key=lambda m2: (getattr(m2, "_part", 0),
                                    getattr(m2, "_rowid", m2.docid))):
        k0 = keyof(m)
        for k1 in (k0 if isinstance(k0, list) else [k0]):
            groups.setdefault(k1, []).append(m)

    def _within_sorted(ms):
        # multi-pass stable sort (handles string desc) picking the
        # WITHIN GROUP ORDER BY representative
        ms = sorted(ms, key=lambda m: m.docid)
        for col, asc in reversed(q.within_sort):
            if col in ("weight", "@weight", "weight()"):
                ms.sort(key=lambda m: m.weight, reverse=not asc)
            elif col in ("id", "@id"):
                ms.sort(key=lambda m: m.docid, reverse=not asc)
            else:
                default: object = 0
                for m in ms:
                    v = m.attrs.get(col)
                    if v is not None:
                        default = type(v)()
                        break
                ms.sort(key=lambda m, _c=col, _d=default:
                        m.attrs.get(_c) if m.attrs.get(_c) is not None
                        else _d, reverse=not asc)
        return ms

    rows = []
    for key, ms in groups.items():
        if q.within_sort:
            ms = _within_sorted(ms)
        elif shared_grouper:
            # ONE sorter over all parts: rep starts at the first push
            # and is replaced per the grouper's rule — explicit groups
            # need the entry to beat the rep STRICTLY on (weight desc,
            # rowid asc) (PushIntoExistingGroup MatchIsGreater,
            # sphinxsort.cpp:3127); the implicit grouper compares ONLY
            # rowids (CheckReplaceEntry, sphinxsort.cpp:4420). ms is
            # already in push order, so a stable sort keeps first-push
            # tie wins.
            if getattr(q, "implicit_group", False):
                ms = sorted(ms, key=lambda m: getattr(m, "_rowid",
                                                      m.docid))
            else:
                ms = sorted(ms, key=lambda m: (-m.weight,
                                               getattr(m, "_rowid",
                                                       m.docid)))
        else:
            # default rep mirrors the reference's grouped MERGE: each
            # part groups first, then group rows merge by key keeping
            # the row of the subgroup with the larger count (ties: the
            # later part); within a part: weight desc, docid asc
            part_counts: dict[int, int] = {}
            for m in ms:
                p2 = getattr(m, "_part", 0)
                part_counts[p2] = part_counts.get(p2, 0) + 1
            best_part = max(part_counts,
                            key=lambda p2: (part_counts[p2], p2))
            ms = sorted(ms, key=lambda m: (
                getattr(m, "_part", 0) != best_part,
                -m.weight, m.docid))
        n_rep = max(1, int(getattr(q, "group_n", 1) or 1))
        rep = ms[0]
        attrs = {q.group_by: key}
        for sel in selects:
            am = _AGG_RE.match(sel)
            if not am:
                continue
            kind = am.group(1).lower()
            arg = am.group(3)
            if kind == "count" and am.group(2):
                vals = set()
                tree = parse_expr(arg)
                for m2 in ms:
                    try:
                        v2 = eval_expr_host(tree, m2.attrs,
                                            m2.weight, m2.docid)
                    except ExprError:
                        continue
                    if isinstance(v2, list):
                        # COUNT(DISTINCT mva): each value counts
                        vals.update(v2)
                    else:
                        vals.add(v2)
                attrs[sel] = len(vals)
                continue
            if kind == "count":
                attrs[sel] = len(ms)
                continue
            tree = parse_expr(arg)
            nums = []
            for m2 in ms:
                try:
                    v = eval_expr_host(tree, m2.attrs, m2.weight,
                                       m2.docid)
                except ExprError:
                    v = None
                if v is not None and not isinstance(v, str):
                    nums.append(v)
            if not nums:
                attrs[sel] = 0
            elif kind == "sum":
                attrs[sel] = sum(nums)
            elif kind == "min":
                attrs[sel] = min(nums)
            elif kind == "max":
                attrs[sel] = max(nums)
            else:
                attrs[sel] = sum(nums) / len(nums)
        # GROUP N BY: up to N member rows per group, each carrying the
        # group's aggregates (CSphKBufferNGroupSorter)
        grp_rows = []
        for rep2 in ms[:n_rep]:
            a2 = dict(attrs)
            a2.update(rep2.attrs)
            if not isinstance(rep2.attrs.get(q.group_by), list):
                a2[q.group_by] = key
            a2["@groupby"] = key
            grp_rows.append(Match(rep2.docid, rep2.weight, a2))
        rows.append((grp_rows, rep, len(ms)))

    # group ordering: the reference's SortGroups() — ORDER BY keys with
    # the rep-rowid fallthrough, and sphSort's observable tie handling
    # (exec/multi.py ref_group_sort)
    def _group_keys(grp_rows, rep, cnt):
        ks = []
        head = grp_rows[0]
        for col, asc2 in (q.sort or [("weight", False)]):
            lc = col.lower().replace(" ", "")
            if lc in ("@count", "count(*)"):
                v: object = cnt
            elif lc in ("weight", "@weight", "weight()"):
                v = rep.weight
            elif lc in ("@groupby", "@group", "groupby()") \
                    or col == q.group_by:
                gv = head.attrs.get("@groupby")
                v = (gv if isinstance(gv, (int, float, bool))
                     else str(gv))
            elif lc in ("id", "@id"):
                v = rep.docid
            else:
                v = head.attrs.get(col, 0)
                if v is None:
                    v = 0
                elif not isinstance(v, (int, float, bool)):
                    v = str(v)
            ks.append((v, not asc2))
        return ks

    ents = [(_group_keys(gr, rep3, cnt3),
             getattr(rep3, "_rowid", rep3.docid))
            for gr, rep3, cnt3 in rows]
    order2 = ref_group_sort(ents)
    rows = [m for gi in order2 for m in rows[gi][0]]

    # the grouper buffer holds at most max_matches GROUPS
    # (CSphKBufferGroupSorter size)
    rows = rows[:q.max_matches]

    if q.having is not None:
        col, op_s, val = q.having
        rows = [m for m in rows if _HAVING_OPS[op_s](m.attrs.get(col, 0),
                                                     val)]

    total = len(rows)
    rows = rows[q.offset:q.offset + q.limit]
    return rows, total
