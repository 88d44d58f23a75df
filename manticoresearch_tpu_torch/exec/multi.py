"""Host sort helpers of multi-part search.

The port's copies of ``manticoresearch_tpu/exec/multi.py``'s ``_apply_sort``,
``ref_queue_order``, ``ref_queue_order_cmp``, ``sph_sort_indices`` and
``ref_group_sort``: the JSON-path ORDER BY path and the host GROUP BY
(``exec.searcher.host_group_matches``) sort with them. The rest of that
module (RT segments, multi-index and distributed merges) is not ported
yet (ROADMAP queue 1 item 12).
"""
from __future__ import annotations


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
