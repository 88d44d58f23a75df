"""Multi-part search: the part merge and the host sort helpers.

The port's copies of ``manticoresearch_tpu/exec/multi.py``'s host
functions: the sort helpers (``_apply_sort``, ``ref_queue_order``,
``ref_queue_order_cmp``, ``sph_sort_indices``, ``ref_group_sort``), which
the JSON-path ORDER BY path and the host GROUP BY
(``exec.searcher.host_group_matches``) sort with, and the part merge
(``merge_word_stats``, ``minimize_result_schema``, ``merge_part_results``,
``search_grouped_parts``) that the distributed index
(``parallel.sharded``) calls. Behavioral model: multi-index SELECTs run
per index then merge sorted results (MinimizeAggrResult /
MergeAllMatches, searchd.cpp:4816,3990) with the sorter's comparator
(weight desc, docid asc by default).

``_search_with_stats`` is rewritten on the port's ``SearchIndex``: it
plans with the caller's term statistics and runs the plan through the
index's own round of device work, so that its windows go through one
grouped decode. The RT-segment search (``search_rt``, and
``_search_rt_grouped`` for GROUP BY) fans out over the RT index's
segments with the summed term statistics, one ``_search_with_stats`` per
segment, as the JAX package does; ``_load_table_global_idf`` reads a
table's global-IDF file.
"""
from __future__ import annotations

import time
from dataclasses import replace as dc_replace

from ..utils import trace


def _apply_sort(matches, q, presort_docid: bool = True):
    """Multi-pass stable sort: supports desc on non-numeric (string) attrs,
    where a negate-the-key trick can't work. presort_docid=False keeps
    the incoming order as the tie-break (part-merge order)."""
    sort = list(q.sort or [("weight", False), ("id", True)])
    if presort_docid:
        matches.sort(key=lambda m: m.docid)  # final tie-break: docid asc
    for col, asc in reversed(sort):
        if col in ("weight", "@weight", "weight()"):
            matches.sort(key=lambda m: m.weight, reverse=not asc)
        elif col in ("id", "@id"):
            matches.sort(key=lambda m: m.docid, reverse=not asc)
        elif "." in col:
            # JSON path ORDER BY: host-evaluated per row (the reference
            # sorts JSON fields with host expressions too)
            from ..query.expr import eval_expr_host, parse_expr
            tree = parse_expr(col)

            def jkey(m, _t=tree):
                try:
                    v = eval_expr_host(_t, m.attrs, m.weight, m.docid)
                except Exception:   # noqa: BLE001 — missing path -> None
                    v = None
                # missing JSON keys compare as the smallest value
                # (null==0; golden test_234 j.uid asc puts them first);
                # mixed types compare as (type_rank, value)
                if v is None:
                    return (-1, 0)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    return (0, v)
                return (1, str(v))
            matches.sort(key=jkey, reverse=not asc)
        else:
            default = next((m.attrs[col] for m in matches
                            if m.attrs.get(col) is not None), 0)
            zero = type(default)()
            matches.sort(key=lambda m, _z=zero, _c=col:
                         m.attrs.get(_c) if m.attrs.get(_c) is not None
                         else _z,
                         reverse=not asc)


def ref_queue_order(keys, size):
    """Exact CSphMatchQueue emulation (the reference's src/sphinxsort.cpp:
    583-811): a binary heap keeping the WORST match at the root — Push
    sifts up, overflow pops the root, Flatten heap-sorts by popping the
    root to the tail.  Replicated because the pop order is observable:
    with equal sort keys, the reference's result order is this heap's
    artifact (per-chunk rowid ties across RT disk chunks; golden
    test_066's implicit-sort fullscans).

    keys: (weight, rowid) per entry in PUSH order.  Comparator is
    MatchRelevanceLt_fn (sphinxsort.cpp:4534: lower weight = worse;
    equal weight, HIGHER rowid = worse).  Returns the surviving entry
    indices, best first."""
    def comp_less(a, b):            # COMP::IsLess(a, b): a worse than b
        if keys[a][0] != keys[b][0]:
            return keys[a][0] < keys[b][0]
        return keys[a][1] > keys[b][1]
    return ref_queue_order_cmp(len(keys), comp_less, size)


def ref_queue_order_cmp(n, comp_less, size):
    """ref_queue_order with an arbitrary IsLess(a, b) over push indices —
    the same CSphMatchQueue heap, usable for generic multi-key sorters
    (MatchGeneric*_fn): full-key ties pop in the heap's artifact order,
    which IS the reference's observable result order (golden test_163
    dist3 'order by str1 desc, idd1 desc' tie runs)."""

    def fn_less(i, j):              # InvCompareIndex_fn: inverted operands
        return comp_less(heap[j], heap[i])

    heap: list[int] = []

    def sift_down():
        i = 0
        used = len(heap)
        while True:
            c = 2 * i + 1
            if c >= used:
                break
            if c + 1 < used and fn_less(c, c + 1):
                c += 1
            if fn_less(i, c):
                heap[i], heap[c] = heap[c], heap[i]
                i = c
                continue
            break

    def pop_root():
        removed = heap.pop()
        if heap:
            heap[0], removed = removed, heap[0]
        sift_down()
        return removed

    for e in range(n):
        if len(heap) == size:
            if comp_less(e, heap[0]):
                continue
            pop_root()
        heap.append(e)
        i = len(heap) - 1
        while i:
            p = (i - 1) // 2
            if not fn_less(p, i):
                break
            heap[i], heap[p] = heap[p], heap[i]
            i = p
    out = []
    while heap:
        out.append(pop_root())
    out.reverse()
    return out


def sph_sort_indices(n: int, is_less) -> list[int]:
    """Faithful replica of the reference's sphSort (sphinxstd.h:818):
    iterative quicksort (median = middle element) with an insertion sort
    below 33 elements and a heapsort depth-limit fallback. The insertion
    sort shifts while NOT strictly less, so EQUAL elements come out in
    REVERSED input order — an observable artifact (golden test_226's MVA
    facets tie on the group rep's rowid and surface reversed). Returns
    the permuted index list; is_less(i, j) is the comparator over the
    ORIGINAL indices."""
    data = list(range(n))
    if n < 2:
        return data

    def sift_down(start: int, end: int) -> None:
        while True:
            child = start * 2 + 1
            if child > end:
                return
            if child + 1 <= end and is_less(data[child], data[child + 1]):
                child += 1
            if is_less(data[child], data[start]):
                return
            data[child], data[start] = data[start], data[child]
            start = child

    def heap_sort(a: int, cnt: int) -> None:
        if cnt <= 1:
            return
        sub = data[a:a + cnt]

        def sless(i, j):
            return is_less(sub[i], sub[j])
        # local heapsort over the slice (mirrors sphHeapSort)
        def sift(start, end):
            while True:
                c = start * 2 + 1
                if c > end:
                    return
                if c + 1 <= end and sless(c, c + 1):
                    c += 1
                if sless(c, start):
                    return
                sub[c], sub[start] = sub[start], sub[c]
                start = c
        for s in range((cnt - 2) >> 1, -1, -1):
            sift(s, cnt - 1)
        end = cnt - 1
        while end > 0:
            sub[0], sub[end] = sub[end], sub[0]
            end -= 1
            sift(0, end)
        data[a:a + cnt] = sub

    SMALL_THRESH = 32
    depth_limit = max(n.bit_length() - 1, 1)
    depth_limit = ((depth_limit << 2) + depth_limit) >> 1  # x2.5

    st0 = [0]
    st1 = [n - 1]
    while st0:
        a = st0.pop()
        b = st1.pop()
        i, j = a, b
        if not st0:
            depth_limit -= 1
            if not depth_limit:
                heap_sort(a, b - a + 1)
                return data
        ln = b - a
        if ln <= SMALL_THRESH:
            for ii in range(a + 1, b + 1):
                jj = ii
                while jj > a:
                    if is_less(data[jj - 1], data[jj]):
                        break
                    data[jj], data[jj - 1] = data[jj - 1], data[jj]
                    jj -= 1
            continue
        x = data[a + ln // 2]
        # NB: i and j are intentionally NOT reset between iterations —
        # the second pass of this loop only pushes the other half
        # (verbatim control flow from sphinxstd.h:873-898)
        while a < b:
            while i <= j:
                while is_less(data[i], x):
                    i += 1
                while is_less(x, data[j]):
                    j -= 1
                if i <= j:
                    data[i], data[j] = data[j], data[i]
                    i += 1
                    j -= 1
            if j - a >= b - i:
                if a < j:
                    st0.append(a)
                    st1.append(j)
                a = i
            else:
                if i < b:
                    st0.append(i)
                    st1.append(b)
                b = j
    return data


def ref_group_sort(entries) -> list[int]:
    """SortGroups() emulation (sphinxsort.cpp:3303): order group rows the
    way the reference's grouped sorter flattens them.

    entries: list in GROUP-CREATION order of (sort_keys, rowid) where
    sort_keys is a list of (value, desc) pairs from the ORDER BY clause
    and rowid is the group REPRESENTATIVE's rowid. The comparator is
    GroupSorter_fn (operands inverted so best sorts first,
    sphinxsort.cpp:1796) over MatchGeneric*_fn keys with the rowid-asc
    fallthrough (sphinxsort.cpp:4678); full rowid ties (MVA groups
    sharing a rep) surface in sphSort's tie-reversed order."""
    def comp_less(ia: int, ib: int) -> bool:
        # GroupSorter_fn::IsLess(a,b) = COMP::IsLess(m[b], m[a]):
        # "b worse than a" -> a first
        ka, ra = entries[ia]
        kb, rb = entries[ib]
        for (va, desc), (vb, _d) in zip(ka, kb):
            if va != vb:
                try:
                    gt = vb > va
                except TypeError:
                    gt = str(vb) > str(va)
                return bool(desc) ^ bool(gt)
        return rb > ra
    return sph_sort_indices(len(entries), comp_less)


def merge_word_stats(results):
    """Sum per-term docs/hits across part results, first-seen term order."""
    from .searcher import WordStat
    stats_map: dict[str, list[int]] = {}
    order = []
    for r in results:
        for ws in r.word_stats:
            if ws.word not in stats_map:
                stats_map[ws.word] = [0, 0]
                order.append(ws.word)
            stats_map[ws.word][0] += ws.docs
            stats_map[ws.word][1] += ws.hits
    return [WordStat(w, *stats_map[w]) for w in order]


_ATTR_BITS = {"bool": 1, "uint": 32, "timestamp": 32, "float": 32,
              "bigint": 64}


def _unify_attr_type(a: str, b: str) -> str | None:
    """MinimizeSchema's seamless conversions (searchd.cpp:2038-2062):
    bool<->float, and any pair within {bool, int, bigint}; the wider
    bitcount wins, equal bitcounts keep the first. None = incompatible
    (the attr is REMOVED from the aggregate schema)."""
    if a == b:
        return a
    pair = {a, b}
    same = pair <= {"bool", "float"} \
        or pair <= {"bool", "uint", "timestamp", "bigint"}
    if not same:
        return None
    if _ATTR_BITS.get(b, 0) > _ATTR_BITS.get(a, 0):
        return b
    return a


def minimize_result_schema(results, part_schemas):
    """Minimized schema over the parts that returned MATCHES — empty
    result sets don't constrain it (MinimizeSchemas, searchd.cpp:4305:
    'skip empty result set'). Same-name attrs of different types unify
    per MinimizeSchema (searchd.cpp:2011): bool<->float and the int
    family widen seamlessly; anything else drops the attr (golden
    test_163 `select * from u_float, u_uint` keeps only id). Match
    values are remapped in place like RemapResult (searchd.cpp:3640):
    bool -> float becomes 0.0/1.0, uint widening reads unsigned bits.
    Returns None when nothing matched."""
    live = [(s, r) for s, r in zip(part_schemas, results)
            if r is not None and not r.error and r.matches and s is not None]
    if not live:
        return None
    base = live[0][0]
    # name -> unified type (None = dropped), seeded from the first live part
    utypes: dict[str, str | None] = {a.name: a.type.value
                                     for a in base.attrs}
    for s, _ in live[1:]:
        have = {a.name: a.type.value for a in s.attrs}
        for name in list(utypes):
            cur = utypes[name]
            if name not in have:
                del utypes[name]
                continue
            if cur is not None:
                utypes[name] = _unify_attr_type(cur, have[name])
    kept = [a.name for a in base.attrs
            if utypes.get(a.name) is not None]
    # remap part match values onto the unified types
    for s, r in live:
        ptypes = {a.name: a.type.value for a in s.attrs}
        conv = {}
        for name in kept:
            src, dst = ptypes.get(name), utypes[name]
            if src == dst or src is None:
                continue
            if dst == "float":
                conv[name] = lambda v: (1.0 if v > 0 else 0.0) \
                    if isinstance(v, (int, bool)) else v
            elif src in ("uint", "timestamp", "bool"):
                conv[name] = lambda v: (int(v) & 0xFFFFFFFF) \
                    if isinstance(v, (int, bool)) else v
        if conv:
            for m in r.matches:
                for name, fn in conv.items():
                    if name in m.attrs and m.attrs[name] is not None:
                        m.attrs[name] = fn(m.attrs[name])
    from ..schema import AttrDef, AttrType, Schema
    if all(utypes.get(a.name) == a.type.value for a in base.attrs) \
            and len(kept) == len(base.attrs):
        return base
    return Schema(fields=list(base.fields),
                  attrs=[AttrDef(a.name, AttrType(utypes[a.name]))
                         for a in base.attrs if a.name in kept])


def merge_part_results(results, q, schema, agent_mode: bool = False,
                       rt_heap: bool = False):
    """Merge per-part SearchResults into one (weight/order-correct).

    agent_mode: remote-agent merges under the DEFAULT sort keep the
    reverse-tag arrival order as the weight tiebreak instead of docid asc
    (the master's remote merge compares shipped sort keys only; golden
    test_323 dist fullscan surfaces the later agent's rows first)."""
    from .searcher import SearchResult

    # per-part failures (a part whose schema can't build the sorter, a
    # dead agent) drop that part and keep serving — the reference's
    # RunLocalSearches collects per-index errors and only fails the
    # whole query when NO part succeeded (searchd.cpp RunLocalSearches;
    # golden test_163 'order by str2' over dist1 returns just the
    # str2-carrying part's rows)
    errs = [r.error for r in results if r.error]
    part_warning = None
    if errs:
        if len(errs) == len(results):
            return SearchResult([], 0, 0, 0.0, [], error=errs[0])
        results = [r for r in results if not r.error]
        # surviving-part merges carry the failures as a WARNING
        # (BuildReport -> m_sWarning, searchd.cpp:5303)
        part_warning = errs[0]
    # docid dupes across parts: the copy from the LAST part wins and the
    # kills shrink the totals (KillPlainDupes tag ordering inside
    # KillDupesAndFlatten, searchd.cpp:3990). Duplicate docids WITHIN one
    # part are legitimate rows (a plain index keeps duplicate-id source
    # rows, test_047) and all survive.
    seen: dict[int, tuple[int, list]] = {}
    n_copies = 0
    for pi, r in enumerate(results):
        for m in r.matches:
            prev = seen.get(m.docid)
            if prev is not None and prev[0] == pi:
                prev[1].append(m)
            else:
                if prev is not None:
                    # re-insert so the winning copy takes ITS part's
                    # arrival position, not the killed copy's slot
                    # (stability of the final sort depends on it —
                    # golden test_163 dist2 tie runs)
                    del seen[m.docid]
                seen[m.docid] = (pi, [m])
            n_copies += 1
    # full-key ties across parts surface the LATER part's rows first
    # (master merge order); within one part the arrival order (the
    # part's own sorter, docid-asc tie-broken) is kept by stability
    by_part: dict[int, list] = {}
    for pi2, ms in seen.values():
        by_part.setdefault(pi2, []).extend(ms)
    all_matches = [m for pi2 in sorted(by_part, reverse=True)
                   for m in by_part[pi2]]
    killed = n_copies - len(all_matches)
    DEFAULT_SORT = [("weight", False), ("id", True)]
    if rt_heap and not q.sort:
        # RT implicit-sort merges replicate the reference's SHARED match
        # queue across chunks: pushes arrive per part in rowid order, the
        # comparator ties on the per-chunk rowid, and the heap's pop
        # order decides full ties (sphinxsort.cpp MatchRelevanceLt_fn +
        # CSphMatchQueue; golden test_066).
        push, keys = [], []
        for pi2 in sorted(by_part):
            part_ms = sorted(by_part[pi2],
                             key=lambda m: getattr(m, "_rowid", m.docid))
            for m in part_ms:
                push.append(m)
                keys.append((m.weight, getattr(m, "_rowid", m.docid)))
        order = ref_queue_order(keys, max(q.max_matches, 1))
        all_matches = [push[i] for i in order]
    elif agent_mode and list(q.sort or DEFAULT_SORT) == DEFAULT_SORT:
        from dataclasses import replace as _rp
        _apply_sort(all_matches, _rp(q, sort=[("weight", False)]),
                    presort_docid=False)
    elif q.sort and list(q.sort) != DEFAULT_SORT \
            and not any("." in c for c, _ in q.sort):
        # explicit attr sorts replay the reference's master merge
        # EXACTLY: KillPlainDupes pushes the surviving copies in global
        # docid-asc order into the final sorter queue (searchd.cpp:3910),
        # and full-key ties surface in the queue's heap-artifact order
        # (golden test_163 dist3 'order by str1 desc, idd1 desc' tie run
        # pops id 8 before 7)
        push = sorted(all_matches, key=lambda m: m.docid)
        skeys = []
        for col, asc in q.sort:
            cl = col.lower()
            if cl in ("weight", "@weight", "weight()"):
                skeys.append((lambda m: m.weight, asc))
            elif cl in ("id", "@id"):
                skeys.append((lambda m: m.docid, asc))
            else:
                zero = next((type(m.attrs[col])()
                             for m in push
                             if m.attrs.get(col) is not None), 0)

                def _get(m, _c=col, _z=zero):
                    v = m.attrs.get(_c)
                    return _z if v is None else v
                skeys.append((_get, asc))

        def _rowkey(m):
            # final MatchGeneric*_fn key: rowid asc (sphinxsort.cpp:4718
            # `a.m_tRowID > b.m_tRowID`). Remote matches never get a
            # rowid over the wire (ParseMatch, searchd.cpp:1775) so they
            # all tie at INVALID_ROWID — their order is the queue's heap
            # artifact; local matches tie deterministically by rowid.
            if getattr(m, "_remote", False):
                return (1, 0)
            return (0, getattr(m, "_rowid", m.docid))

        def is_less(a, b, _p=push, _k=skeys):
            # IsLess(a, b): a is WORSE than b (pops earlier)
            for get, asc in _k:
                va, vb = get(_p[a]), get(_p[b])
                if va != vb:
                    return (va < vb) if not asc else (va > vb)
            ra, rb = _rowkey(_p[a]), _rowkey(_p[b])
            return ra > rb
        order = ref_queue_order_cmp(len(push), is_less,
                                    max(q.max_matches, 1))
        all_matches = [push[i] for i in order]
    else:
        _apply_sort(all_matches, q, presort_docid=False)
    total_found = sum(r.total_found for r in results) - killed
    window = all_matches[q.offset:q.offset + q.limit]
    stats = merge_word_stats(results)
    t = sum(r.time_ms for r in results)
    out = SearchResult(window, min(total_found, q.max_matches), total_found,
                       t, stats)
    if part_warning and not getattr(out, "warning", None):
        out.warning = part_warning
    out.profile = list(getattr(results[0], "profile", []))
    out.plan_repr = getattr(results[0], "plan_repr", None)
    return out


def search_rt(rt, q):
    """Search an RT index: fan out over segments with aggregated term stats
    (one IDF across all segments), merge."""
    from .searcher import SearchResult

    parts = rt.searchable_parts()
    if not parts:
        return SearchResult([], 0, 0, 0.0, [])
    from .searcher import late_filters_for, run_late_filtered
    late = late_filters_for(q, rt.schema)
    if late:
        return run_late_filtered(lambda wq: search_rt(rt, wq), q, late)
    if q.group_by:
        return _search_rt_grouped(rt, q, parts)

    total_docs, df = rt.global_stats()
    if q.global_idf:
        # corpus-wide stats from the table's global-IDF file
        # (sphinxglobalidf; built by indextool --buildidf)
        gstats = _load_table_global_idf(rt)
        if gstats is None:
            return SearchResult([], 0, 0, 0.0, [], error=(
                "OPTION global_idf needs a global_idf='<path>' table "
                "option pointing at an indextool --buildidf file"))
        df, total_docs = gstats
    # each part plans/executes with global stats; fetch enough rows to merge
    from .searcher import _wants_packedfactors
    pf_sel = [s for s in (q.select or [])
              if s.lower().replace(" ", "").startswith("packedfactors(")]
    # implicit relevance sort: fetch the full sorter window per part so
    # the shared-queue tie emulation sees every candidate the reference's
    # single max_matches-sized sorter would (multi.py ref_queue_order)
    part_limit = q.max_matches if not q.sort else q.offset + q.limit
    part_q = dc_replace(q, offset=0, limit=part_limit,
                        select=pf_sel or None)
    results = []
    for part in parts:
        cq_kwargs = dict(total_docs_override=total_docs, local_df=df,
                         emit_factors=_wants_packedfactors(q.select))
        results.append(_search_with_stats(part, part_q, cq_kwargs))
    merged = merge_part_results(results, q, rt.schema, rt_heap=True)
    return merged


def _load_table_global_idf(rt):
    """Load (and cache) the table's global-IDF file, or None."""
    path = (getattr(rt, "options", None) or {}).get("global_idf")
    if not path:
        return None
    cached = getattr(rt, "_gidf_cache", None)
    if cached is not None and cached[0] == path:
        return cached[1]
    from ..tools.indextool import load_global_idf
    try:
        df, total = load_global_idf(path)
    except (OSError, KeyError, ValueError):
        return None
    rt._gidf_cache = (path, (df, total))
    return df, total


def _search_with_stats(index, q, stats_kwargs):
    """``index.search(q)`` with term-stat overrides injected into the plan
    (``total_docs_override`` / ``local_df``), run through the index's own
    round of device work."""
    return index._drive_steps([_stats_steps(index, q, stats_kwargs)])[0]


def _stats_steps(index, q, stats_kwargs):
    """The generator of device work behind ``_search_with_stats``: plan,
    yield the ranked program, hydrate."""
    from ..query.planner import plan_query
    from .searcher import (SearchResult, _resolve_order,
                           _wants_packedfactors)

    t0 = time.perf_counter()
    try:
        with trace.span("plan"):
            with trace.span("parse"):
                ast = index.parser.parse(q.match)
            with trace.span("plan_query"):
                cq = plan_query(
                    ast, index.packed,
                    filters=q.filters, ranker=q.ranker,
                    max_matches=q.max_matches, filter_tree=q.filter_tree,
                    window=q.offset + q.limit,
                    order=_resolve_order(q, index.schema),
                    field_weights=q.field_weights, idf_plain=q.idf_plain,
                    tfidf_normalized=q.tfidf_normalized,
                    expansion_limit=q.expansion_limit,
                    boolean_simplify=q.boolean_simplify,
                    expand_keywords=q.expand_keywords,
                    collation=q.collation,
                    packed_store=index.packed.packed_store(),
                    **{"emit_factors": _wants_packedfactors(q.select),
                       **stats_kwargs},
                )
    except (ValueError, NotImplementedError) as e:
        return SearchResult([], 0, 0, 0.0, [], error=str(e))
    rowids, weights, found, pf = yield ("rank", cq)
    return index._finish(q, cq, rowids, weights, found, t0, pf)


def _search_rt_grouped(rt, q, parts):
    """GROUP BY over segments: per-segment group results merged by key —
    COUNT/SUM/MIN/MAX merge exactly; COUNT(DISTINCT) computes exactly
    over the raw window (segments are ONE index; the reference shares
    the uniq sorter across segments)."""
    return search_grouped_parts(parts, q, rt.schema,
                                single_part_hint="run OPTIMIZE first",
                                segments=True)


def search_grouped_parts(parts, q, schema, single_part_hint="",
                         segments=False, agent_mode=False):
    """Merge per-part grouped results (used by RT segments and the
    distributed index). segments=True: the parts are chunks of ONE
    index — COUNT(DISTINCT) computes exactly over the raw window;
    separate indexes SUM per-part distinct counts like the reference's
    grouped merge."""
    from .searcher import Match, SearchResult

    if len(parts) > 1:
        sel = [s.lower() for s in (q.select or [])]
        gb_ad = schema.attr(q.group_by) if q.group_by else None
        # a WITHIN GROUP ORDER BY equal to the default rep order
        # (weight desc, id asc) IS the default grouped merge — it must
        # not force the exact raw-window path (golden test_067: agent
        # group rows merge by key, counts summing across dup docids)
        ws = [("weight" if c in ("@weight", "weight()") else
               ("id" if c == "@id" else c), a)
              for c, a in (q.within_sort or [])]
        default_ws = ws in ([], [("weight", False)],
                            [("weight", False), ("id", True)])
        if (not agent_mode and any("distinct" in s for s in sel)) \
                or (q.within_sort and not default_ws) \
                or (gb_ad is not None
                    and gb_ad.type.value in ("multi", "multi64")):
            # exact COUNT(DISTINCT) across parts: per-part counts don't
            # merge, so fetch the raw match window from every part and
            # group host-side (the reference re-sorts the merged window
            # the same way, sphinxsort.cpp distinct fixup)
            t0 = time.perf_counter()
            # the grouping pass must see EVERY match (the reference's
            # grouper processes all matches regardless of max_matches;
            # sphinxsort.cpp) — an n_docs-sized window keeps COUNT(*) /
            # COUNT(DISTINCT)/SUM exact instead of clipping at max_matches
            full = max(q.max_matches,
                       sum(getattr(p, "n_docs", 0) or 0 for p in parts))
            base_q = dc_replace(q, group_by=None, select=None, having=None,
                                sort=[("weight", False), ("id", True)],
                                offset=0, limit=full, max_matches=full)
            results = [p.search(base_q) for p in parts]
            err = next((r.error for r in results if r.error), None)
            if err:
                return SearchResult([], 0, 0, 0.0, [], error=err)
            # docid dupes across RT segments/chunks: the LAST part's copy
            # wins (replaced docs) before grouping; dupes WITHIN one part
            # are legitimate rows. Across SEPARATE local indexes every
            # row feeds the grouper — the reference does not kill docid
            # dupes there (golden test_020 q14: mini1={1,7} mini2={1}
            # group-counts 3)
            if segments:
                seen2: dict[int, tuple[int, list]] = {}
                for pi3, r in enumerate(results):
                    for m in r.matches:
                        m._part = pi3   # later parts win grouped-rep ties
                        prev = seen2.get(m.docid)
                        if prev is not None and prev[0] == pi3:
                            prev[1].append(m)
                        else:
                            seen2[m.docid] = (pi3, [m])
                matches = [m for _, ms in seen2.values() for m in ms]
            else:
                matches = []
                for pi3, r in enumerate(results):
                    for m in r.matches:
                        m._part = pi3
                        matches.append(m)
            matches.sort(key=lambda m: (-m.weight, m.docid))
            from .searcher import host_group_matches
            rows, total = host_group_matches(matches, q,
                                             shared_grouper=segments)
            dt = (time.perf_counter() - t0) * 1000.0
            return SearchResult(rows, total, total, dt,
                                merge_word_stats(results))

    part_q = dc_replace(q, offset=0, limit=q.max_matches)
    results = []
    for part in parts:
        results.append(part.search(part_q))
    err = next((r.error for r in results if r.error), None)
    if err:
        return SearchResult([], 0, 0, 0.0, [], error=err)
    if len(results) == 1:
        r = results[0]
        rows = r.matches[q.offset:q.offset + q.limit]
        return SearchResult(rows, r.total, r.total_found, r.time_ms,
                            r.word_stats)

    merged: dict = {}
    for r in results:
        for m in r.matches:
            key = m.attrs.get("@groupby", m.attrs.get(q.group_by))
            if isinstance(key, list):   # MVA group key: hashable form
                key = tuple(key)
            if key not in merged:
                merged[key] = m
                continue
            cur = merged[key]
            attrs = dict(cur.attrs)
            for name, v in m.attrs.items():
                ln = name.lower().replace(" ", "")
                if ln.startswith("count(") and "distinct" in ln \
                        and agent_mode:
                    # agent replies carry opaque @distinct values the
                    # master can't merge: the first part's value sticks
                    continue
                if ln.startswith("count("):
                    # per-part counts SUM — including COUNT(DISTINCT)
                    # for local multi-index, which the reference merges
                    # approximately by summing per-index counts
                    attrs[name] = attrs.get(name, 0) + v
                elif ln.startswith("sum("):
                    attrs[name] = attrs.get(name, 0) + v
                elif ln.startswith("min("):
                    attrs[name] = min(attrs.get(name, v), v)
                elif ln.startswith("max("):
                    attrs[name] = max(attrs.get(name, v), v)
            # rep: the subgroup with the larger count wins; ties keep
            # the LATER part's row (reference grouped merge)
            def _cnt(mm):
                for n2, v2 in mm.attrs.items():
                    if n2.lower().replace(" ", "") == "count(*)":
                        return v2
                return 1
            cur_c = getattr(cur, "_sub_count", _cnt(cur))
            m_c = _cnt(m)
            # local multi-index: the larger subgroup's row wins, ties
            # keep the LATER part. Agent merges: the grouper's rep is
            # NEVER replaced (KillGroupbyDupes pushes in merge order;
            # PushGrouped only folds aggregates) — first part wins.
            if agent_mode:
                best = cur
            else:
                best = m if (m_c > cur_c or m_c == cur_c) else cur
            nm2 = Match(best.docid, best.weight, attrs)
            nm2._sub_count = max(cur_c, m_c)
            merged[key] = nm2
    rows = list(merged.values())
    # recompute averages is not possible without sums; flag instead
    warning = None
    if any("avg(" in (s or "").lower() for s in (q.select or [])):
        warning = "AVG over multi-segment RT merges approximately; OPTIMIZE for exact"
    from .searcher import _resolve_group_order
    order = _resolve_group_order(q, schema)
    if order[0] == "rel":
        rows.sort(key=lambda m: (-m.weight, m.docid))
    elif order[0] == "gkey":
        rows.sort(key=lambda m: m.attrs.get(q.group_by, 0),
                  reverse=not order[1])
    elif order[0] == "count":
        cname = next((n for n in (rows[0].attrs if rows else {})
                      if n.lower().replace(" ", "") == "count(*)"), None)
        rows.sort(key=lambda m: m.attrs.get(cname, 0), reverse=not order[1])
    elif order[0] == "attr":
        rows.sort(key=lambda m: m.attrs.get(order[1], 0),
                  reverse=not order[2])
    n_groups = len(rows)
    rows = rows[q.offset:q.offset + q.limit]
    t = sum(r.time_ms for r in results)
    stats = results[0].word_stats
    res = SearchResult(rows, min(n_groups, q.max_matches), n_groups, t, stats)
    res.warning = warning
    return res
