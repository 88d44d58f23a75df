"""The search program for one plan shape, in PyTorch: read postings ->
accumulate -> boolean eval -> filters -> rank -> top-k.

Counterpart of ``manticoresearch_tpu/ops/search.py``. Its three row spaces
share one code path, as there:
- dense (``sig.sparse == False``): per-row accumulators over all N+1 rows,
  row N being the dead pad sink;
- sparse union (``sig.sparse``, no ``scan_index``): the sorted union of
  every slot's posting rows, B = sum(slot_pb) candidates;
- filter-first (``scan_index``): a window of one attribute's sorted-value
  rowid permutation, B = ``sig.scan_bucket`` candidates, each slot's
  postings intersected with it by ``_member_scan``.
``to_idx`` maps row ids into the space (the identity when dense) and
``rows_vec`` holds each position's row. After the posting pass come, in
the JAX package's order: field-, position- and zone-limited slots over
their hits (and the ZONESPAN joint constraint), wildcard merge groups,
the positional nodes (phrase, proximity, NEAR, SENTENCE, PARAGRAPH,
bigram) and the gated tfidf of phrase members; the LCS rankers then rank
the merged hit stream of terms and phrase emissions, with the
HANDLE_DUPES state machine for repeated keywords; the expression ranker
(``ranker=expr``, sph04 and PACKEDFACTORS()) evaluates its factors over
the same stream (``ops.factors``). Indexes of more than 32 full-text
fields carry [.., FW] fieldmask words, FW = (fields + 31) >> 5; the
planner keeps them dense.

The program reads each packed term slot's rowid, tf and fieldmask planes
decoded. ``packed_windows`` lists the packed windows a query's program
reads, so that the caller can decode the windows of a whole batch in one
``packed_store.decode_grouped`` call (one launch of the CUDA bit-plane
kernel on the card) and hand each program its slices. The rest is eager
PyTorch ops.

Integer weights must equal the JAX package's bit for bit, so:
- every float step is its own eager op (no fused multiply-add), and the
  Python float constants are exact float32 values;
- float sums run slot by slot: a real row takes at most one add per slot
  (only a pad sink takes many adds, all zero), so ``index_add_`` is exact
  and adds in the JAX package's order, in the dense and the sparse space;
- top-k ties go to the lower position (docid asc: positions ascend with
  the row in every space) through an int64 key
  ``(weight << 32) | (0xFFFFFFFF - position)``, since ``torch.topk`` fixes
  no tie order;
- multi-key sorts become one sort of an int64 composite key, or chained
  stable sorts (last key first) where the keys do not fit in 64 bits;
- int32 shifts are arithmetic, so every extracted bit is masked with ``& 1``;
- integer sums that may pass 2^31 run in int64 and wrap through
  ``wrap_i32``, which equals JAX's wrapping int32 arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..query.plan import (RANKERS_WITH_HITS, PlanSig, phrase_member_gating,
                          positive_phrase_nodes, positive_slots,
                          ranker_term_slots)
from .device_index import window
from .packed_store import BLOCK, wrap_i32

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
SPH_BM25_SCALE = 1000  # sphinxsearch.cpp:31
HITMAN_END_FLAG = 1 << 23
HITMAN_KEY_MASK = ~(1 << 23)  # strip the field-end flag for position compares
HITMAN_POS_MASK = (1 << 23) - 1   # in-field position
K1 = float(np.float32(1.2))   # BM25 k1, exact as a float32

_PHRASE_OPS = ("phrase", "proximity", "near", "sentence", "paragraph",
               "bigram_phrase")


def _bit(s: int) -> int:
    """int32 value of term bit s & 31 (bit 31 is INT32_MIN)."""
    return _i32(1 << (s & 31))


def _i32(v: int) -> int:
    """A Python int's low 32 bits as a signed int32 value."""
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


# --------------------------------------------------------------------------
# scan helpers
# --------------------------------------------------------------------------
def _lex_search_le(key_a, key_b, arr_a, arr_b, lo, hi, n_iters: int,
                   b_mask: int = -1):
    """For each query i, the index of the RIGHTMOST element with
    (arr_a, arr_b) <= (key_a[i], key_b[i]) within [lo[i], hi[i]), or
    lo[i] - 1 if none: -> (idx clipped into the array, exists). The JAX
    package's ``n_iters``-step vectorized binary search, step for step, so
    the outputs are equal for any input. b_mask ANDs arr_b reads."""
    n = arr_a.shape[0]
    lo0 = lo
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        mid_c = mid.clamp(0, n - 1)
        a = arr_a[mid_c]
        b = arr_b[mid_c] & b_mask
        le = (a < key_a) | ((a == key_a) & (b <= key_b))
        go_right = le & (lo < hi)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right | (lo >= hi), hi, mid))
    idx = lo - 1
    return idx.clamp(0, n - 1), idx >= lo0


def _last_index(flag: torch.Tensor) -> torch.Tensor:
    """For each position i, the largest j <= i with ``flag[j]``, or -1:
    JAX's ``cummax(where(flag, iota, -1))``, computed as the running count
    of flags and a gather of the flagged positions in order (the card's
    int64 ``cummax`` is a slow single-pass scan)."""
    n = flag.shape[0]
    cnt = torch.cumsum(flag, dim=0)
    iota = torch.arange(n, dtype=torch.int64, device=flag.device)
    kth = torch.zeros(n + 1, dtype=torch.int64, device=flag.device).scatter_(
        0, torch.where(flag, cnt - 1, n), iota)    # position of flag k + 1
    return torch.where(cnt > 0, kth[(cnt - 1).clamp(min=0)], -1)


def _pred_scan(a_row, a_key, b_row, b_key, b_valid):
    """Predecessor lookup in ONE sorted hit slice: for each query
    (a_row[i], a_key[i]), the largest valid (b_row[j], b_key[j]) <= it:
    -> (pred_row, pred_key, pred_exists) aligned with the queries. The JAX
    package's sort + "last b seen" + scatter-back: its ``lax.sort`` of
    (row, key, tag) becomes one stable sort of the int64 key ``row << 32 |
    (key + 2^31)``. The input lists the b entries (tag 0) first and the queries
    in tag order, so the stable sort keeps JAX's order among equal (row,
    key): b entries before queries, queries by tag. Invalid b entries
    enter as INT32_MAX in row and key."""
    na = a_row.shape[0]
    nb = b_row.shape[0]
    dev = a_row.device
    rows = torch.cat([torch.where(b_valid, b_row, INT32_MAX), a_row])
    keys = torch.cat([torch.where(b_valid, b_key, INT32_MAX), a_key])
    order = torch.sort((rows.to(torch.int64) << 32)
                       | (keys.to(torch.int64) + 2**31), stable=True).indices
    is_b = order < nb
    j = _last_index(is_b)            # the last b entry at or before me
    src = order[j.clamp(0, nb + na - 1)]          # its unsorted position
    qidx = torch.where(is_b, na, order - nb)      # b entries -> sink na

    def back(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(na + 1, dtype=v.dtype, device=dev).scatter_(
            0, qidx, v)[:na]
    return back(rows[src]), back(keys[src]), back(j >= 0)


def _segmented_sum(v: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of 1-D integers within segments, a segment
    starting wherever ``reset`` is True (``reset[0]`` must be): the
    running ``cumsum`` less its value before the segment start (exact)."""
    c = torch.cumsum(v, dim=0, dtype=v.dtype)
    start = _last_index(reset)
    return c - c[start] + v[start]


def _segmented_or(v: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix OR of int32 values with bits 0..30 within segments:
    one segmented sum over the 31 bit planes laid end to end (each plane
    starts a segment), tested > 0."""
    m = v.shape[0]
    bits = torch.arange(31, dtype=torch.int32, device=v.device)[:, None]
    planes = ((v[None, :] >> bits) & 1).reshape(-1)
    seen = _segmented_sum(planes, reset.repeat(31)).view(31, m) > 0
    return (seen.to(torch.int32) << bits).sum(dim=0, dtype=torch.int32)


def _member_scan(cand_row, b_row, b_valid, payloads: tuple):
    """Membership of each candidate row in ONE posting slice, with the
    matching posting's payloads: -> (present bool[B], payloads aligned to
    the candidates, 0 where absent). The JAX package's sort + cummax +
    scatter-back (``_last_index`` in place of the cummax): its
    ``lax.sort`` of (row, tag) becomes one stable sort of the int64 key
    ``row << 32 | tag``; tag 0 marks postings, so a
    posting sorts before a candidate of the same row, and 1 + i marks
    candidate i. Invalid postings enter as INT32_MAX."""
    na = cand_row.shape[0]
    nb = b_row.shape[0]
    dev = cand_row.device
    rows = torch.cat([torch.where(b_valid, b_row, INT32_MAX),
                      cand_row]).to(torch.int64)
    tag = torch.cat([torch.zeros(nb, dtype=torch.int64, device=dev),
                     torch.arange(1, na + 1, dtype=torch.int64, device=dev)])
    order = torch.sort((rows << 32) | tag, stable=True).indices
    rows_s, tag_s = rows[order], tag[order]
    j = _last_index(tag_s == 0)
    jc = j.clamp(0, nb + na - 1)
    hit = (j >= 0) & (rows_s[jc] == rows_s)
    idx = torch.where(tag_s > 0, tag_s - 1, na)   # postings -> sink na
    present = torch.zeros(na + 1, dtype=torch.bool, device=dev).scatter_(
        0, idx, hit)[:na]
    src = order[jc]                  # each position's posting, unsorted
    outs = []
    for p in payloads:
        pv = torch.cat([p, torch.zeros(na, dtype=p.dtype, device=dev)])[src]
        outs.append(torch.zeros(na + 1, dtype=p.dtype, device=dev).scatter_(
            0, idx, torch.where(hit, pv, 0))[:na])
    return present, tuple(outs)


# --------------------------------------------------------------------------
# boolean tree and filters
# --------------------------------------------------------------------------
def _eval_expr(expr: tuple, termmask: torch.Tensor, phrase_results: dict,
               size: int) -> torch.Tensor:
    """Bottom-up boolean evaluation on the [Z, W] term-presence bitmask;
    a positional node's match comes from ``phrase_results``."""
    op = expr[0]
    if op == "term":
        s = expr[1]
        return ((termmask[:, s >> 5] >> (s & 31)) & 1).bool()
    if op == "all":
        return torch.ones(size, dtype=torch.bool, device=termmask.device)
    if op in ("and", "or"):
        m = _eval_expr(expr[1][0], termmask, phrase_results, size)
        for c in expr[1][1:]:
            mc = _eval_expr(c, termmask, phrase_results, size)
            m = (m & mc) if op == "and" else (m | mc)
        return m
    if op == "andnot":
        return (_eval_expr(expr[1], termmask, phrase_results, size)
                & ~_eval_expr(expr[2], termmask, phrase_results, size))
    if op == "maybe":
        # MAYBE matches on its left arm; the right arm only adds rank
        return _eval_expr(expr[1], termmask, phrase_results, size)
    if op == "quorum":
        slots, need = expr[1], expr[2]
        cnt = torch.zeros(termmask.shape[0], dtype=termmask.dtype,
                          device=termmask.device)
        for s in slots:
            cnt = cnt + ((termmask[:, s >> 5] >> (s & 31)) & 1)
        return cnt >= need
    if op in _PHRASE_OPS:
        return phrase_results[expr][0]
    raise ValueError(f"unknown expr op {op!r}")


def _collect_phrase_nodes(expr: tuple) -> list[tuple]:
    """Every positional node of the tree (NOT sides included), in tree
    order."""
    op = expr[0]
    if op in _PHRASE_OPS:
        return [expr]
    if op in ("and", "or"):
        return [n for c in expr[1] for n in _collect_phrase_nodes(c)]
    if op in ("andnot", "maybe"):
        return _collect_phrase_nodes(expr[1]) + _collect_phrase_nodes(expr[2])
    return []


def _eval_phrase_node(node: tuple, hits_of, data: dict, N: int, size: int,
                      to_idx, n_hit_iters: int):
    """One positional node over sorted hit slices: -> (match bool[Z], tf
    i32[Z] = anchored occurrences, anchor_row, anchor_key, ok, a_w), the
    anchors feeding phrase emission into the LCS stream; ``a_w`` is the
    proximity emission weight (None for the other kinds). ``hits_of(s)``
    gives slot s's hit rows (pad -> N), masked keys and mask.

    The JAX package's formulation, step for step (FSMphrase,
    FSMproximity_c, FSMmultinear, SENTENCE/PARAGRAPH units). As there, tf
    counts every anchored occurrence, also where the reference FSM counts
    only non-overlapping ones (self-overlapping phrases)."""
    op = node[0]
    slots_t = node[1]
    a_w = None
    if op in ("sentence", "paragraph"):
        # both keywords in one sentence / paragraph of a field: the unit
        # holding anchor key p spans (previous break key, next break key],
        # the break arrays holding each unit's LAST token key, sorted
        sa, sb = slots_t
        unit = "sent" if op == "sentence" else "para"
        brow, bkey = data[f"{unit}_rowid"], data[f"{unit}_pkey"]
        nbrk = brow.shape[0]
        a_row, a_key, valid = hits_of(sa)
        idx_le, ex = _lex_search_le(a_row, a_key, brow, bkey,
                                    torch.zeros_like(a_row),
                                    torch.full_like(a_row, nbrk), n_hit_iters)
        fld = a_key >> 24
        same_prev = (ex & (brow[idx_le] == a_row)
                     & ((bkey[idx_le] >> 24) == fld))
        lb = torch.where(same_prev, bkey[idx_le], fld << 24)
        nxt = torch.where(ex, idx_le + 1, 0)
        nxt_c = nxt.clamp(0, nbrk - 1)
        same_next = ((nxt < nbrk) & (brow[nxt_c] == a_row)
                     & ((bkey[nxt_c] >> 24) == fld))
        ub = torch.where(same_next, bkey[nxt_c], ((fld + 1) << 24) - 1)
        b_row, b_key, b_msk = hits_of(sb)
        pr, pk, ph = _pred_scan(a_row, ub, b_row, b_key, b_msk)
        ok = valid & ph & (pr == a_row) & (pk > lb)
    elif op == "bigram_phrase":
        # the pair term's hits are the phrase anchors
        a_row, a_key, ok = hits_of(node[2])
    elif op == "near" and len(node) > 4:
        # general NEAR/n over keywords, phrases or nested NEAR chains: two
        # spans are near iff Rs <= Le + n and Rs >= Ls - n - (rspan - 1)
        ndist, not_near, ld, rd = node[2], node[3], node[4], node[5]

        def side(desc):
            kind, payload, span = desc
            if kind == "slot":
                return (*hits_of(payload[0]), span)
            sub = (("phrase", payload, tuple(range(len(payload))))
                   if kind == "phrase" else payload)
            _, _, r, k, okm, _ = _eval_phrase_node(
                sub, hits_of, data, N, size, to_idx, n_hit_iters)
            return r, k, okm, span

        l_row, l_key, l_ok, lspan = side(ld)
        r_row, r_key, r_ok, rspan = side(rd)
        le_key = l_key + (lspan - 1)
        pr, pk, ph = _pred_scan(l_row, le_key + ndist, r_row, r_key, r_ok)
        cand_ok = (ph & (pr == l_row)
                   & (pk >= l_key - ndist - (rspan - 1)))
        ok = l_ok & (~cand_ok if not_near else cand_ok)
        a_row = l_row
        # the matched group's right edge, so that chains measure the next
        # distance from the latest matched element
        a_key = l_key if not_near else torch.where(
            ok & cand_ok, torch.maximum(le_key, pk + (rspan - 1)), l_key)
    elif op == "near":
        # binary NEAR/n / NOTNEAR/n over keywords, anchored on the left
        sa, sb = slots_t
        ndist, not_near = node[2], node[3]
        a_row, a_key, valid = hits_of(sa)
        b_row, b_key, b_msk = hits_of(sb)
        pr, pk, ph = _pred_scan(a_row, a_key + ndist, b_row, b_key, b_msk)
        within = ph & (pr == a_row) & ((a_key - pk).abs() <= ndist)
        ok = valid & (~within if not_near else within)
        if not not_near:
            a_key = torch.where(ok, torch.maximum(a_key, pk), a_key)
    elif op == "phrase":
        # every member at its query-position delta from the anchor
        a_row, a_key, ok = hits_of(slots_t[0])
        deltas = node[2] if len(node) > 2 else tuple(range(len(slots_t)))
        for qi in range(1, len(slots_t)):
            tgt = a_key + deltas[qi]
            b_row, b_key, b_msk = hits_of(slots_t[qi])
            pr, pk, ph = _pred_scan(a_row, tgt, b_row, b_key, b_msk)
            ok = ok & ph & (pr == a_row) & (pk == tgt)
    else:
        # proximity "..."~n: some hit p of any member (the window end) has
        # every member within [p - (qlen + n - 1), p]
        ndist = node[2]
        qdeltas = (node[3] if len(node) > 3 and node[3]
                   else tuple(range(len(slots_t))))
        win = qdeltas[-1] + ndist
        rows_l, keys_l, msks_l = zip(*[hits_of(s) for s in slots_t])
        a_row = torch.cat(rows_l)
        a_key = torch.cat(keys_l)
        ok = torch.cat(msks_l)
        member_delta = []
        for qi, s in enumerate(slots_t):
            b_row, b_key, b_msk = hits_of(s)
            pr, pk, ph = _pred_scan(a_row, a_key, b_row, b_key, b_msk)
            ok = ok & ph & (pr == a_row) & (a_key - pk < win)
            member_delta.append(pk - qdeltas[qi])
        # emission weight (the FSM's delta-run fold): members in chains of
        # equal (pos - qpos) deltas of length >= 2, or 1 when none chains
        a_w = torch.zeros_like(a_row)
        for di in member_delta:
            cnt = torch.zeros_like(a_row)
            for dj in member_delta:
                cnt = cnt + (di == dj).to(torch.int32)
            a_w = a_w + (cnt >= 2).to(torch.int32)
        a_w = a_w.clamp(min=1)
    tf = torch.zeros(size, dtype=torch.int32, device=a_row.device).index_add_(
        0, to_idx(torch.where(ok, a_row, N)), ok.to(torch.int32))
    return tf > 0, tf, a_row, a_key, ok, a_w


def _eval_filter(spec, attr: torch.Tensor, vals: np.ndarray) -> torch.Tensor:
    """One attribute filter as a mask (values / range_i / range_f)."""
    if spec.kind == "values":
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(attr.device)
        pos = torch.searchsorted(v, attr).clamp(0, spec.n_values - 1)
        mask = v[pos] == attr
    elif spec.kind == "range_i":
        lo, hi = int(vals[0]), int(vals[1])
        if spec.usgn:
            attr = attr ^ INT32_MIN   # unsigned compare, bounds pre-flipped
        mask = (attr >= lo) & (attr <= hi)
    elif spec.kind == "range_f":   # float32 bounds, exact as Python floats
        lo, hi = float(vals[0]), float(vals[1])
        lo_ok = (attr > lo) if spec.lo_excl else (attr >= lo)
        hi_ok = (attr < hi) if spec.hi_excl else (attr <= hi)
        mask = lo_ok & hi_ok
    else:
        raise NotImplementedError(f"filter kind {spec.kind}")
    return ~mask if spec.exclude else mask


def _eval_pair_filter(kind: str, hi_a: torch.Tensor, lo_a: torch.Tensor,
                      vals: np.ndarray) -> torch.Tensor:
    """A 64-bit value filter over its (hi, biased lo) int32 split: kind
    ``*_values`` takes vals [2, n] (hi row, lo row), ``*_range`` takes
    [[lo_hi, hi_hi], [lo_lo, hi_lo]]; signed lexicographic compare."""
    v = torch.from_numpy(np.ascontiguousarray(vals)).to(hi_a.device)
    if kind.endswith("_values"):
        return ((hi_a[:, None] == v[0][None, :])
                & (lo_a[:, None] == v[1][None, :])).any(dim=1)
    ge = (hi_a > v[0, 0]) | ((hi_a == v[0, 0]) & (lo_a >= v[1, 0]))
    le = (hi_a < v[0, 1]) | ((hi_a == v[0, 1]) & (lo_a <= v[1, 1]))
    return ge & le


def _eval_mva_filter(spec, offsets: torch.Tensor, values: torch.Tensor,
                     vals: np.ndarray, rows: torch.Tensor,
                     n_iters: int) -> torch.Tensor:
    """Multi-value attribute filters (Filter_MVA ANY/ALL semantics): each
    row's sorted value segment ``values[offsets[r]:offsets[r + 1]]``,
    membership and ranges by per-row predecessor searches. ``vals`` holds
    the sorted, padded filter values (``*_any/_all/_subset``) or [lo, hi]
    (``*_range``); ``rows`` are the rows to evaluate."""
    if values.shape[0] == 0:
        # no MVA values at all: nothing matches an include filter
        mask = torch.zeros(rows.shape, dtype=torch.bool, device=rows.device)
        return ~mask if spec.exclude else mask
    n_csr = offsets.shape[0] - 1
    n_val = values.shape[0]
    rows_c = rows.clamp(0, max(n_csr - 1, 0))
    lo_idx = offsets[rows_c]
    hi_idx = offsets[(rows_c + 1).clamp(0, n_csr)]
    has_any = hi_idx > lo_idx
    zero = torch.zeros_like(rows)
    zero_v = torch.zeros_like(values)

    def search_le(v: torch.Tensor):
        return _lex_search_le(zero, v, zero_v, values, lo_idx, hi_idx,
                              n_iters)

    def present(v: int) -> torch.Tensor:
        idx, exists = search_le(torch.full_like(rows, v))
        return exists & (values[idx] == v)

    kind = spec.kind
    if kind == "mva_subset":
        # every element of the row's list is a filter value: the counts of
        # the distinct filter values in the segment sum to its length
        total = torch.zeros_like(lo_idx)
        for j in range(spec.n_values):
            v = int(vals[j])
            if j > 0 and v == int(vals[j - 1]):
                continue   # the pow2 padding repeats the last value
            idx_hi, ex_hi = search_le(torch.full_like(rows, v))
            idx_lo, ex_lo = search_le(torch.full_like(rows, v) - 1)
            total = total + (torch.where(ex_hi, idx_hi + 1, lo_idx)
                             - torch.where(ex_lo, idx_lo + 1, lo_idx))
        mask = has_any & (total == hi_idx - lo_idx)
    elif kind in ("mva_any", "mva_all"):
        mask = present(int(vals[0]))
        for j in range(1, spec.n_values):
            p = present(int(vals[j]))
            mask = (mask | p) if kind == "mva_any" else (mask & p)
        if kind == "mva_all":
            mask = mask & has_any
    elif kind == "mva_any_range":
        idx, exists = search_le(torch.full_like(rows, int(vals[1])))
        mask = exists & (values[idx] >= int(vals[0]))
    else:   # mva_all_range
        first = values[lo_idx.clamp(0, n_val - 1)]
        last = values[(hi_idx - 1).clamp(0, n_val - 1)]
        mask = has_any & (first >= int(vals[0])) & (last <= int(vals[1]))
    return ~mask if spec.exclude else mask


def _filter_mask(spec, vals, data: dict, rows_vec: torch.Tensor, at_rows,
                 n_iters: int) -> torch.Tensor:
    """One filter leaf as a mask over the program's row space;
    ``at_rows(v)`` is a per-row tensor at ``rows_vec``."""
    kind = spec.kind
    if kind.startswith("mva_"):
        return _eval_mva_filter(spec, data["mva_offsets"][spec.attr],
                                data["mva_values"][spec.attr], vals,
                                rows_vec, n_iters)
    if kind == "host_mask":
        # a host-evaluated predicate (JSON paths) as packed int32 row bits
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(rows_vec.device)
        w = (rows_vec >> 5).clamp(0, v.shape[0] - 1)
        m = ((v[w] >> (rows_vec & 31)) & 1).bool()
    elif kind in ("id_values", "id_range"):
        m = _eval_pair_filter(kind, at_rows(data["docid_hi"]),
                              at_rows(data["docid_lo"]), vals)
    elif kind in ("big_values", "big_range"):
        attrs = data["attrs"]
        m = _eval_pair_filter(kind, at_rows(attrs[spec.attr + "#hi"]),
                              at_rows(attrs[spec.attr + "#lo"]), vals)
    else:
        return _eval_filter(spec, at_rows(data["attrs"][spec.attr]), vals)
    return ~m if spec.exclude else m


def _float_order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the order of JAX's sort comparator
    (``lax.sort`` canonicalizes its float keys): -0.0 equal to +0.0, every
    NaN after +inf."""
    v = torch.where(torch.isnan(v), float("nan"), v)
    v = torch.where(v == 0, 0.0, v)
    b = v.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


# --------------------------------------------------------------------------
# windows and the program
# --------------------------------------------------------------------------
_NEEDS_FIELDMASK = ("ws_bm25", "ws", "fieldmask")
_WORDS_KEYS = ("pkrw_w", "pktf_w", "pkfm_w")   # by window kind


def _pos_slots(sig: PlanSig) -> set:
    return positive_slots(sig.expr) if sig.expr[0] != "all" else set()


def window_kinds(sig: PlanSig) -> list[tuple[int, int]]:
    """The (slot, kind) of every packed window the program reads, in
    order; kind 0 is the rowid stream, 1 the tf planes, 2 the fieldmask
    planes. rowids are read for every slot; tf for positive slots (the
    posting pass, a limited slot's doc-level tf, a gated phrase member),
    for merge-group slots, and for every slot by the filter-first branch
    (its membership scan carries tf as a payload); fieldmask for positive
    slots of the posting pass under the rankers that use it."""
    pos = _pos_slots(sig)
    fm = sig.ranker in _NEEDS_FIELDMASK
    limited = {e[0] for e in sig.slot_limited}
    grouped = {s for g in sig.merge_groups for s in g}
    out = []
    for s, packed in enumerate(sig.slot_packed):
        tf = s in pos or s in grouped or bool(sig.scan_index)
        for kind, used in ((0, True), (1, tf),
                           (2, fm and s in pos and s not in limited)):
            if used and packed[kind]:
                out.append((s, kind))
    return out


def packed_windows(sig: PlanSig, slot_pb: tuple, data: dict,
                   rt: dict) -> list[tuple]:
    """The decode windows of one query's program, in ``window_kinds``
    order: (words [nb, 4c], base [nb] for the rowid stream else None, c),
    each a view into the device index. ``decode_grouped`` of these gives
    the slices the program takes as ``decoded``."""
    out = []
    for s, kind in window_kinds(sig):
        c = sig.slot_packed[s][kind]
        nb = max(slot_pb[s] // BLOCK, 1)
        p0 = int(rt["pk_starts"][s, kind])
        words = window(data[f"{_WORDS_KEYS[kind]}_{c}"], p0, nb)
        base = window(data[f"pkrw_b_{c}"], p0, nb) if kind == 0 else None
        out.append((words, base, c))
    return out


def build_match_core(sig: PlanSig, n_rows: int, n_fields: int,
                     slot_pb: tuple, slot_hb: tuple, n_hit_iters: int = 0):
    """(data, rt, decoded) -> (eligible bool[Z], weight i32[Z], rows
    i32[Z], at_rows, factors), Z = N+1 (dense) or B (sparse,
    filter-first); ``at_rows(v)`` takes a per-row tensor (its pad row
    optional) to ``rows``; ``factors`` holds the PACKEDFACTORS() arrays
    per position (``factors.PF_LAYOUT``) when the plan emits them, else
    nothing.

    ``data`` is ``DeviceIndex.data_pytree()``; ``rt`` is the planner's
    runtime dict of numpy arrays (slot windows are read on the host);
    ``decoded`` holds the decoded values of the query's ``packed_windows``
    in their order, each flat int32 [nb * 128]; slot_pb / slot_hb are the
    planner's per-slot posting / hit window sizes; ``n_hit_iters`` bounds
    the binary searches over zone spans, sentence and paragraph breaks and
    MVA values."""
    N = n_rows
    F = n_fields
    S = sig.n_slots
    W = max(1, (S + 31) // 32)
    # fieldmask words per posting: more than 32 fields take several
    # (FieldMask_t is 256-bit in the reference, sphinx.h:108)
    FWID = (n_fields + 31) >> 5
    scan_index = sig.scan_index
    if sig.sparse:
        size = sig.scan_bucket if scan_index else int(sum(slot_pb))
    else:
        size = N + 1
    need_fieldmask = sig.ranker in _NEEDS_FIELDMASK
    use_lcs = sig.ranker in RANKERS_WITH_HITS
    pos_slots = _pos_slots(sig)
    rk_slots = ranker_term_slots(sig.expr) if use_lcs else ()
    rk_phrases = positive_phrase_nodes(sig.expr) if use_lcs else ()
    phrase_nodes = _collect_phrase_nodes(sig.expr)
    # phrase members whose tfidf reaches a doc only where their node matched
    gated_nodes, _ = phrase_member_gating(sig.expr)
    gated_all = {s for slots in gated_nodes.values() for s in slots}
    limited_set = {e[0] for e in sig.slot_limited}
    grouped_slots = {s for g in sig.merge_groups for s in g}
    slot_packed = sig.slot_packed
    win_of = {sk: i for i, sk in enumerate(window_kinds(sig))}
    mva_iters = n_hit_iters or 32

    def fn(data, rt, decoded):
        dev = data["alive"].device
        lengths = rt["lengths"]

        def slot_postings(s: int):
            """Slot s's posting rows (pad -> N) and validity mask."""
            sz = slot_pb[s]
            if slot_packed[s][0]:
                row = decoded[win_of[s, 0]]
            else:
                row = window(data["res_rowid"], int(rt["starts"][s]), sz)
            msk = torch.arange(sz, device=dev) < int(lengths[s])
            return torch.where(msk, row, N), msk

        def slot_tfq(s: int) -> torch.Tensor:
            """tf/(tf+K1) per posting (packed: rebuilt from the tf planes
            in float32, as IndexBuilder rounds it)."""
            if slot_packed[s][1]:
                tf = decoded[win_of[s, 1]].to(torch.float32)
                return tf / (tf + K1)
            return window(data["res_tfq"], int(rt["starts"][s]), slot_pb[s])

        def slot_tf_raw(s: int) -> torch.Tensor:
            """Raw tf per posting, as float32: packed slots decode the tf
            planes; raw slots invert tfq = tf/(tf+K1) and round, one
            float32 op at a time."""
            if slot_packed[s][1]:
                return decoded[win_of[s, 1]].to(torch.float32)
            tfq = window(data["res_tfq"], int(rt["starts"][s]), slot_pb[s])
            return torch.round(K1 * tfq / (1.0 - tfq))

        def slot_fieldmask(s: int) -> torch.Tensor:
            if slot_packed[s][2]:
                return decoded[win_of[s, 2]]
            return window(data["res_fieldmask"], int(rt["starts"][s]),
                          slot_pb[s])

        def slot_hits(s: int):
            """Slot s's hit rows (pad -> N), positions (pad -> 0), mask."""
            sz = slot_hb[s]
            st = int(rt["hit_starts"][s])
            hrow = window(data["hit_rowid"], st, sz)
            hpk = window(data["hit_packed"], st, sz) & HITMAN_KEY_MASK
            msk = torch.arange(sz, device=dev) < int(rt["hit_lengths"][s])
            return torch.where(msk, hrow, N), torch.where(msk, hpk, 0), msk

        def contribution(s: int, tfq: torch.Tensor) -> torch.Tensor:
            # each product is its own rounded float32 op before the add
            return tfq * float(rt["idf"][s]) * float(rt["mult"][s])

        tfidf = torch.zeros(size, dtype=torch.float32, device=dev)
        termmask = torch.zeros((size, W), dtype=torch.int32, device=dev)
        fieldhit = (torch.zeros((size, F), dtype=torch.int32, device=dev)
                    if need_fieldmask else None)
        fshift = torch.arange(F, dtype=torch.int32, device=dev)

        def to_candidates(r: torch.Tensor) -> torch.Tensor:
            """Row ids -> candidate positions: exact for candidate rows;
            other rows land on a pad position or clip, where every scatter
            value is zero-gated."""
            return torch.searchsorted(cand_row, r).clamp(0, size - 1)

        if scan_index:
            # ---- filter-first: candidates from a secondary-index window,
            # each slot's postings intersected with them ----
            perm = data["attr_perm"][scan_index]
            rowsl = window(perm, int(rt["scan_start"][0]), size)
            msk0 = torch.arange(size, device=dev) < int(rt["scan_len"][0])
            cand_row = torch.sort(torch.where(msk0, rowsl, N)).values
            for s in range(S):
                if s in limited_set:
                    continue   # the hit pass below
                row, msk = slot_postings(s)
                fm_pay = need_fieldmask and s in pos_slots
                pays = ((slot_tfq(s), slot_fieldmask(s)) if fm_pay
                        else (slot_tfq(s),))
                present, outs = _member_scan(
                    cand_row, torch.where(msk, row, N + 1), msk, pays)
                if s in pos_slots and s not in gated_all:
                    tfidf = tfidf + torch.where(
                        present, contribution(s, outs[0]), 0.0)
                termmask[:, s >> 5] |= torch.where(present, _bit(s), 0)
                if fm_pay:
                    fbits = (outs[1][:, None] >> fshift) & 1
                    fieldhit |= torch.where(present[:, None], fbits, 0)
            rows_vec = cand_row
            to_idx = to_candidates
        else:
            postings = [slot_postings(s) for s in range(S)]
            if sig.sparse:
                # ---- sparse union: the sorted union of every slot's
                # posting rows (limited slots included); segments past the
                # last head keep row N, so cand_row stays ascending ----
                srow = torch.sort(torch.cat([r for r, _ in postings])).values
                head = torch.ones(size, dtype=torch.bool, device=dev)
                head[1:] = srow[1:] != srow[:-1]
                seg = torch.cumsum(head, dim=0) - 1
                cand_row = torch.full((size,), N, dtype=torch.int32,
                                      device=dev).scatter_(0, seg, srow)
                rows_vec = cand_row
                to_idx = to_candidates
            else:
                rows_vec = torch.arange(size, dtype=torch.int32, device=dev)

                def to_idx(r):
                    return r.to(torch.int64)
            # ---- scatter-accumulate, one slot after the other ----
            for s, (row, msk) in enumerate(postings):
                if s in limited_set:
                    continue   # the hit pass below
                idx = to_idx(row)
                if s in pos_slots and s not in gated_all:
                    tfidf.index_add_(0, idx, torch.where(
                        msk, contribution(s, slot_tfq(s)), 0.0))
                termmask[:, s >> 5].index_add_(
                    0, idx, msk.to(torch.int32) * _bit(s))
                if need_fieldmask and s in pos_slots and FWID > 1:
                    # [P, FW] mask words (dense only: the planner keeps
                    # such indexes dense); one posting per doc and slot,
                    # so the add is an OR
                    fm = torch.where(msk[:, None], slot_fieldmask(s), 0)
                    fh_s = torch.zeros((size, FWID), dtype=torch.int32,
                                       device=dev).index_add_(0, idx, fm)
                    fieldhit |= (fh_s[:, fshift >> 5] >> (fshift & 31)) & 1
                elif need_fieldmask and s in pos_slots:
                    fm = torch.where(msk, slot_fieldmask(s), 0)
                    fh_s = torch.zeros(size, dtype=torch.int32,
                                       device=dev).index_add_(0, idx, fm)
                    fieldhit |= (fh_s[:, None] >> fshift) & 1

        def doc_any(rows: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
            """Per position, whether any masked row lands there (the JAX
            scatter-max of a 0/1 flag)."""
            return torch.zeros(size, dtype=torch.int32,
                               device=dev).scatter_reduce_(
                0, to_idx(torch.where(ok, rows, N)), ok.to(torch.int32),
                "amax")

        # ---- field-, position- and zone-limited slots over their hits:
        # a hit qualifies by field, position and zone; the doc's tf for
        # BM25 stays the doc-level tf, gated on a qualifying hit ----
        lim_hit_ok: dict = {}      # slot -> per-hit qualify mask
        lim_present: dict = {}
        zspans = rt.get("zspans", ())   # read only by ZONE limits
        zctr = 0                   # cursor into zspans (planner order)
        zspan_acc: dict = {}       # ZONESPAN: zone list -> member state
        for s, lmask, f_start, f_end, zlim, maxpos in sig.slot_limited:
            hrowL, hpkL, mskL = slot_hits(s)
            hfield = (hpkL >> 24) & 0xFF
            if FWID > 1:
                # the field-limit mask as FW int32 words
                lmpl = torch.tensor([_i32(int(lmask) >> (32 * w))
                                     for w in range(FWID)],
                                    dtype=torch.int32, device=dev)
                ok = mskL & (((lmpl[hfield >> 5] >> (hfield & 31)) & 1) != 0)
            else:
                ok = mskL & (((torch.ones_like(hfield) << hfield)
                              & _i32(lmask)) != 0)
            if maxpos:
                ok = ok & ((hpkL & HITMAN_POS_MASK) <= maxpos)
            if zlim:
                # the hit must lie inside an instance of a listed zone:
                # predecessor search over (row, span start key), then the
                # span's end must cover the hit in the same field
                group = None
                if zlim[0].startswith("="):
                    group = zspan_acc.setdefault(zlim, {"slots": [],
                                                        "zones": {}})
                    group["slots"].append(s)
                inz = torch.zeros_like(ok)
                for j in range(len(zlim)):
                    zrow, zskey, zekey = (
                        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in zspans[zctr])
                    zctr += 1
                    nsp = zrow.shape[0]
                    zi, zex = _lex_search_le(
                        hrowL, hpkL, zrow, zskey, torch.zeros_like(hrowL),
                        torch.full_like(hrowL, nsp), n_hit_iters)
                    hit_in = (zex & (zrow[zi] == hrowL)
                              & (zekey[zi] >= hpkL)
                              & ((zskey[zi] >> 24) == hfield))
                    inz = inz | hit_in
                    if group is not None:
                        # which span instance each member hit
                        pres = torch.zeros(nsp, dtype=torch.int32,
                                           device=dev).scatter_reduce_(
                            0, torch.where(hit_in, zi, 0).clamp(0, nsp - 1),
                            hit_in.to(torch.int32), "amax") > 0
                        group["zones"].setdefault(j, (zrow, []))[1].append(
                            pres)
                ok = ok & inz
            if f_start:
                ok = ok & ((hpkL & HITMAN_POS_MASK) == 1)
            if f_end:
                # the raw packed hit keeps the field-end flag
                raw = window(data["hit_packed"], int(rt["hit_starts"][s]),
                             slot_hb[s])
                ok = ok & ((raw & HITMAN_END_FLAG) != 0)
            lim_hit_ok[s] = ok
            present = doc_any(hrowL, ok) > 0
            lim_present[s] = present
            if s in pos_slots:
                rowP, mskP = slot_postings(s)
                tfq_doc = torch.zeros(size, dtype=torch.float32,
                                      device=dev).index_add_(
                    0, to_idx(rowP), torch.where(mskP, slot_tfq(s), 0.0))
                tfidf = tfidf + torch.where(
                    present, contribution(s, tfq_doc), 0.0)
            termmask[:, s >> 5] |= torch.where(present, _bit(s), 0)
            if need_fieldmask:
                fieldhit |= torch.stack(
                    [doc_any(hrowL, ok & (hfield == f)) for f in range(F)],
                    dim=1)

        # ZONESPAN: the members must hit the SAME zone instance. Exact for
        # members that are term leaves of one AND (or a single term); other
        # shapes keep the per-keyword ZONE test, as in the JAX package
        def and_context(members) -> bool:
            if len(members) <= 1:
                return True
            if sig.expr[0] != "and":
                return False
            leaves = {c[1] for c in sig.expr[1] if c[0] == "term"}
            return all(m in leaves for m in members)

        for g in zspan_acc.values():
            if not and_context(g["slots"]):
                continue
            doc_ok = torch.zeros(size, dtype=torch.int32, device=dev)
            for zrow, pres_list in g["zones"].values():
                full = pres_list[0]
                for pz in pres_list[1:]:
                    full = full & pz
                doc_ok = torch.maximum(doc_ok, doc_any(zrow, full))
            for m in g["slots"]:
                col = termmask[:, m >> 5]
                termmask[:, m >> 5] = torch.where(doc_ok > 0, col,
                                                  col & ~_bit(m))

        # ---- wildcard merge groups: the expansions of one pattern rank as
        # one qword, raw tf summed over the group (grouped slots carry idf
        # 0, so the passes above added nothing for them) ----
        for gi, g in enumerate(sig.merge_groups):
            acc = torch.zeros(size, dtype=torch.float32, device=dev)
            for s in g:
                row, msk = slot_postings(s)
                part = torch.zeros(size, dtype=torch.float32,
                                   device=dev).index_add_(
                    0, to_idx(row), torch.where(msk, slot_tf_raw(s), 0.0))
                if s in limited_set:
                    part = torch.where(lim_present[s], part, 0.0)
                acc = acc + part
            tfidf = tfidf + torch.where(
                acc > 0, acc / (acc + K1) * float(rt["gidf"][gi]), 0.0)

        # ---- positional nodes ----
        phrase_results = {
            node: _eval_phrase_node(node, slot_hits, data, N, size, to_idx,
                                    n_hit_iters)
            for node in phrase_nodes}

        # gated member tfidf: one accumulator per node, each distinct member
        # slot once, reaching the docs where the node matched
        for node, gslots in gated_nodes.items():
            if node not in phrase_results:
                continue
            acc = torch.zeros(size, dtype=torch.float32, device=dev)
            for s in dict.fromkeys(gslots):
                row, msk = slot_postings(s)
                acc.index_add_(0, to_idx(row), torch.where(
                    msk, contribution(s, slot_tfq(s)), 0.0))
            tfidf = tfidf + torch.where(phrase_results[node][0], acc, 0.0)

        def at_rows(v: torch.Tensor) -> torch.Tensor:
            if v.shape[0] == N:   # the pad row repeats the last value
                v = torch.cat([v, v[-1:]])
            return v[rows_vec] if sig.sparse else v

        match = _eval_expr(sig.expr, termmask, phrase_results, size)

        leaf_masks = [_filter_mask(spec, rt["filter_vals"][i], data,
                                   rows_vec, at_rows, mva_iters)
                      for i, spec in enumerate(sig.filters)]

        def combine(node):
            if node[0] == "leaf":
                return leaf_masks[node[1]]
            parts = [combine(c) for c in node[1]]
            out = parts[0]
            for p in parts[1:]:
                out = (out | p) if node[0] == "or" else (out & p)
            return out

        eligible = match & at_rows(data["alive"])
        if leaf_masks:
            tree = sig.filter_tree or (
                "and", tuple(("leaf", i) for i in range(len(leaf_masks))))
            eligible = eligible & combine(tree)

        # ---- weight (exact reference composition) ----
        bm25part = torch.trunc((tfidf + 0.5) * SPH_BM25_SCALE).to(torch.int32)
        fw = torch.from_numpy(
            np.asarray(rt["field_weights"], np.int64)).to(dev)
        factors: dict = {}
        if use_lcs:
            stream = _hit_stream(sig, rt, match, termmask, phrase_results,
                                 lim_hit_ok, rk_slots, rk_phrases, slot_hits,
                                 to_idx, size, N)
            expr_in = ((rt, data["field_lens"], termmask)
                       if sig.ranker == "expr" else None)
            weight, factors = _rank_hit_stream(sig, stream, bm25part, fw,
                                               to_idx, size, N, F, S,
                                               expr_in)
        elif sig.ranker in ("ws_bm25", "ws"):
            rank = wrap_i32((fieldhit.to(torch.int64) * fw).sum(dim=1))
            weight = (bm25part + rank * SPH_BM25_SCALE
                      if sig.ranker == "ws_bm25" else rank)
        elif sig.ranker == "none":
            weight = torch.ones(size, dtype=torch.int32, device=dev)
        else:   # fieldmask: the matched-field bitmask itself (a DWORD:
            #     fields past 31 drop out, as in the reference)
            pw = torch.tensor([1 << f if f < 32 else 0 for f in range(F)],
                              dtype=torch.int64, device=dev)
            weight = wrap_i32((fieldhit.to(torch.int64) * pw).sum(dim=1))

        return eligible, weight, rows_vec, at_rows, factors

    return fn


def _hit_stream(sig, rt, match, termmask, phrase_results, lim_hit_ok,
                rk_slots, rk_phrases, slot_hits, to_idx, size, N):
    """The LCS rankers' merged hit stream, unsorted: -> (row, key, qpos,
    weight, span, slot) int32 per entry, or None when empty; slot (the
    term's slot, a phrase emission's first member) only for the
    expression ranker, whose factors read it, else None. Term hits of the
    ranker slots (once per query occurrence of a repeated keyword, only
    qualifying hits of a limited slot) and the phrase nodes' emissions at
    their anchors. A term's or node's hits reach the ranker only where
    every enclosing AND/ANDNOT/MAYBE-right/QUORUM subtree matched the doc.
    A masked entry has row N and key 0; a masked term entry has qpos 0,
    a masked phrase emission keeps its first member's qpos."""
    with_slot = sig.ranker == "expr"
    qpos = rt["qpos"]
    gate_cache: dict = {repr(sig.expr): match}
    slot_paths: dict[int, list] = {}
    node_paths: dict[tuple, list] = {}

    def anc_walk(node, anc):
        op = node[0]
        if op == "term":
            slot_paths.setdefault(node[1], []).append(tuple(anc))
        elif op in ("phrase", "proximity", "bigram_phrase", "near"):
            node_paths.setdefault(node, []).append(tuple(anc))
        elif op == "quorum":
            for s in node[1]:
                slot_paths.setdefault(s, []).append(tuple(anc) + (node,))
        elif op == "and":
            for k in node[1]:
                anc_walk(k, anc + [node])
        elif op == "or":
            for k in node[1]:
                anc_walk(k, anc)
        elif op == "andnot":
            anc_walk(node[1], anc + [node])
        elif op == "maybe":
            anc_walk(node[1], anc)
            anc_walk(node[2], anc + [node])
    anc_walk(sig.expr, [])

    def gate_of(paths):
        """OR over paths of AND over ancestor matches; None = no gate."""
        if not paths or any(len(p) == 0 for p in paths):
            return None
        alts = []
        for p in paths:
            need = [nd for nd in p if nd is not sig.expr]
            if not need:
                return None
            g = None
            for nd in need:
                key = repr(nd)
                if key not in gate_cache:
                    gate_cache[key] = _eval_expr(nd, termmask,
                                                 phrase_results, size)
                g = gate_cache[key] if g is None else (g & gate_cache[key])
            alts.append(g)
        out = alts[0]
        for g in alts[1:]:
            out = out | g
        return out

    parts: list[tuple] = []
    for s in rk_slots:
        hrow, hpk, msk = slot_hits(s)
        g = gate_of(slot_paths.get(s, []))
        if g is not None:
            msk = msk & g[to_idx(hrow)]
        if s in lim_hit_ok:
            msk = msk & lim_hit_ok[s]
        hrow = torch.where(msk, hrow, N)
        hpk = torch.where(msk, hpk, 0)
        m32 = msk.to(torch.int32)
        # HANDLE_DUPES: a keyword at several query positions emits its
        # hits once per occurrence
        occs = (sig.slot_occs[s] if sig.slot_occs and not rk_phrases
                and len(sig.slot_occs[s]) > 1 else (int(qpos[s]),))
        for qp in occs:
            parts.append((hrow, hpk, m32 * int(qp), m32,
                          torch.ones_like(hrow))
                         + ((torch.full_like(hrow, s),) if with_slot else ()))
    for node in rk_phrases:
        _, _, a_row, a_key, a_ok, a_w = phrase_results[node]
        g = gate_of(node_paths.get(node, []))
        if g is not None:
            a_ok = a_ok & g[to_idx(a_row)]
        n_words = len(node[1])
        # FSMphrase emission: at the phrase start, the first atom's qpos,
        # weight (proximity: the delta-run weight) and span = word count
        w = a_w if a_w is not None else torch.full_like(a_row, n_words)
        parts.append((torch.where(a_ok, a_row, N),
                      torch.where(a_ok, a_key, 0),
                      torch.full_like(a_row, int(qpos[node[1][0]])),
                      torch.where(a_ok, w, 0),
                      torch.full_like(a_row, n_words))
                     + ((torch.full_like(a_row, node[1][0]),) if with_slot
                        else ()))
    if not parts:
        return None
    cols = tuple(torch.cat(col) for col in zip(*parts))
    return cols if with_slot else cols + (None,)


def _rank_hit_stream(sig, stream, bm25part, fw, to_idx, size, N, F, S,
                     expr_in=None):
    """proximity_bm25 / proximity / wordcount / matchany / expr over the
    merged hit stream (RankerState_Proximity_fn, _Wordcount_fn,
    _MatchAny_fn, _Expr_fn): -> (weight, factors). Hit rows reach the
    program's row space through ``to_idx``; position size - 1 is the
    scatter sink, and every value sent there by a masked entry is neutral
    (0 for adds and maxes, M for the min). ``expr_in`` = (rt, field_lens,
    termmask) for the expression ranker, whose ``factors`` are the
    PACKEDFACTORS() arrays when the plan emits them."""
    dev = bm25part.device
    if stream is None:
        return (bm25part if sig.ranker == "proximity_bm25"
                else torch.zeros(size, dtype=torch.int32, device=dev)), {}
    hrow, hpk, hqp, hw, hsp, hslot = stream
    if sig.ranker == "wordcount":
        # the field weight of every stream hit, summed per doc
        wf = torch.where(hrow < N,
                         fw[((hpk >> 24) & 0xFF).clamp(max=F - 1)], 0)
        return wrap_i32(torch.zeros(size, dtype=torch.int64,
                                    device=dev).index_add_(0, to_idx(hrow),
                                                           wf)), {}
    newpos = None
    if sig.has_dupes or sig.slot_occs:
        hrow, hpk, hqp, hslot, curlcs, newpos = _dupes_curlcs(
            hrow, hpk, hqp, hw, hslot, to_idx, size, N)
    else:
        # lax.sort((hrow, hpk, payload), num_keys=2) on signed int32 keys;
        # the payload packs qpos, weight, span and (expr) slot
        payload = (hqp.clamp(0, 255) | (hw.clamp(0, 255) << 8)
                   | (hsp.clamp(0, 255) << 16))
        if hslot is not None:
            payload = payload | (hslot << 24)
        key = (hrow.to(torch.int64) << 32) + (hpk.to(torch.int64) + 2**31)
        order = torch.sort(key, stable=True).indices
        hrow, hpk, payload = hrow[order], hpk[order], payload[order]
        hqp = payload & 0xFF
        hw = (payload >> 8) & 0xFF
        hsp = (payload >> 16) & 0xFF
        if hslot is not None:
            hslot = (payload >> 24) & 0xFF
        delta = hpk - hqp
        linked = ((hrow == _prev(hrow, -1)) & (hpk > _prev(hpk, 0))
                  & (delta == _prev(delta, 0) + _prev(hsp, 0) - 1))
        run_start = _last_index(~linked)   # linked[0] is False
        cumw = torch.cumsum(hw, dim=0)                      # int64
        curlcs = (cumw - cumw[run_start] + hw[run_start]).clamp(max=255)
        curlcs = curlcs.to(torch.int32)                     # BYTE m_uCurLCS

    hfield = (hpk >> 24) & 0xFF
    hidx = to_idx(hrow)
    lcs = torch.stack(
        [torch.zeros(size, dtype=torch.int32, device=dev).scatter_reduce_(
            0, torch.where(hfield == f, hidx, size - 1),
            torch.where(hfield == f, curlcs, 0), "amax")
         for f in range(F)], dim=1)
    if sig.ranker == "matchany":
        # rank = sum_f (distinct qpos matched in f + (lcs_f - 1) * phraseK)
        # * w_f, phraseK = sum_f w_f * n_qwords; JAX's 3-D scatter-max
        # seen[size, F, Q] as one flat-index scatter
        Q = max(S, 1)
        qd = (hqp - 1).clamp(0, Q - 1)
        flat = (hidx * F + hfield.clamp(0, F - 1)) * Q + qd
        seen = torch.zeros(size * F * Q, dtype=torch.int32,
                           device=dev).scatter_reduce_(
            0, flat, ((hrow < N) & (hfield < F)).to(torch.int32), "amax")
        match_cnt = seen.view(size, F, Q).sum(dim=-1)       # int64
        phrase_k = fw.sum() * S
        return wrap_i32(torch.where(
            match_cnt > 0,
            (match_cnt + (lcs.to(torch.int64) - 1) * phrase_k) * fw,
            0).sum(dim=1)), {}
    if sig.ranker == "expr":
        return _expr_rank(sig, expr_in, (hrow, hpk, hqp, hslot), newpos,
                          lcs, bm25part, N, F, S)
    rank = wrap_i32((lcs.to(torch.int64) * fw).sum(dim=1))
    return (bm25part + rank * SPH_BM25_SCALE
            if sig.ranker == "proximity_bm25" else rank), {}


def _expr_rank(sig, expr_in, sorted_stream, newpos, lcs, bm25part, N, F,
               S):
    """ranker=expr('formula') (RankerState_Expr_fn, sphinxsearch.cpp:1964)
    over the sorted stream: weight = (int) formula, and the PACKEDFACTORS()
    arrays when the plan emits them. Dense rows only (the planner runs no
    expression ranker in a sparse space). The factor accounting of a
    dupes query counts each physical (row, pos) ONCE, folded to the first
    instance's qpos and slot (m_dTermsHit / m_dTermDupes,
    sphinxsearch.cpp:3446-3455); the raw stream keeps every emission."""
    from .factors import (FactorContext, expr_weight, factor_inputs,
                          packed_factors)
    rt, field_lens, termmask = expr_in
    hrow, hpk, hqp, hslot = sorted_stream
    valid = hrow < N
    fin = factor_inputs(rt, hrow.device)
    raw = (hrow, hpk, hqp, hslot, valid)
    stream = raw
    if newpos is not None:
        sl = hslot.clamp(0, max(S - 1, 0)).to(torch.int64)
        stream = (hrow, hpk, fin["qpos_fold"][sl], fin["slot_fold"][sl],
                  valid & newpos)
    ctx = FactorContext(N=N, F=F, S=S, stream=stream, raw_stream=raw,
                        max_qpos=sig.max_qpos, lcs=lcs, bm25part=bm25part,
                        termmask=termmask, rt=fin, field_lens=field_lens,
                        fl_on=sig.fl_on)
    weight = expr_weight(sig.ranker_expr, ctx)
    return weight, (packed_factors(ctx, bm25part, lcs)
                    if sig.emit_factors else {})


def _prev(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x shifted right by one, ``fill`` first."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation of a stable lexicographic sort on int32 keys (first
    key most significant): chained stable sorts, last key first, each on
    an int64 of two keys."""
    order = None
    pairs = [keys[i:i + 2] for i in range(0, len(keys), 2)][::-1]
    for pair in pairs:
        cur = [k if order is None else k[order] for k in pair]
        key = cur[0].to(torch.int64)
        if len(cur) == 2:
            key = (key << 32) | (cur[1].to(torch.int64) + 2**31)
        o = torch.sort(key, stable=True).indices
        order = o if order is None else order[o]
    return order


def _dupes_curlcs(hrow, hpk, hqp, hw, hslot, to_idx, size, N):
    """HANDLE_DUPES proximity state machine (RankerState_Proximity_fn with
    dupes, sphinxsearch.cpp:1369-1414), vectorized as in the JAX package:
    once the first 2-chain forms, the LCS tail only advances on extensions
    of THAT chain, so
     1. hits merge per distinct (row, pos) into qpos masks;
     2. the EARLIEST adjacent-position extension (mask shift match, gap <
        32) starts the one growable chain, of constant delta pos - qpos;
     3. the chain grows over same-delta elements while gaps stay < 32;
     4. every other distinct position adds only its hit weight.
    -> (row, key, qpos, slot, curlcs, newpos) in sorted stream order,
    newpos marking each distinct (row, pos)'s first entry."""
    dev = hrow.device
    M = hrow.shape[0]
    sink = size - 1
    payload = hqp.clamp(0, 255) | (hw.clamp(0, 255) << 8)
    # lax.sort((hrow, hpk, payload, slot), num_keys=3)
    order = _stable_order(hrow, hpk, payload)
    hrow, hpk, payload = hrow[order], hpk[order], payload[order]
    if hslot is not None:
        hslot = hslot[order]
    hqp = payload & 0xFF
    hw = (payload >> 8) & 0xFF
    valid = hrow < N
    idx = torch.arange(M, dtype=torch.int64, device=dev)
    newpos = (hrow != _prev(hrow, -1)) | (hpk != _prev(hpk, -1))
    gid = torch.cumsum(newpos, dim=0) - 1
    qbit = torch.where(valid, torch.ones_like(hqp) << hqp.clamp(0, 30), 0)
    seg_or = _segmented_or(qbit, newpos)    # curQposMask as each hit arrives
    last_of_gid = torch.zeros(M, dtype=torch.int64,
                              device=dev).scatter_reduce_(0, gid, idx, "amax")
    gmask = seg_or[last_of_gid]             # [gid]-indexed
    gpos = hpk[last_of_gid]
    grow = hrow[last_of_gid]
    pgid = (gid - 1).clamp(min=0)
    prev_mask, prev_pos, prev_row = gmask[pgid], gpos[pgid], grow[pgid]
    gap = hpk - prev_pos
    ext = (valid & (gid > 0) & (prev_row == hrow) & (gap >= 1) & (gap < 32)
           & (((seg_or >> gap.clamp(0, 31)) & prev_mask) != 0))
    hidx0 = to_idx(hrow)
    first_ext = torch.full((size,), M, dtype=torch.int64,
                           device=dev).scatter_reduce_(
        0, torch.where(valid, hidx0, sink), torch.where(ext, idx, M), "amin")
    started = first_ext < M
    fe = first_ext.clamp(0, M - 1)
    win_delta = torch.where(started, hpk[fe] - hqp[fe], -1)
    # chain growth: same-(row, delta) elements in pos order, broken at the
    # first gap >= 32 past the start
    delta = torch.where(valid, hpk - hqp, -2)
    on_chain = valid & (delta == win_delta[hidx0])
    srow2 = torch.where(on_chain, hrow, N)
    o2 = _stable_order(srow2, delta, hpk)
    srow2, sd2, spk2, sidx2 = srow2[o2], delta[o2], hpk[o2], idx[o2]
    samegrp = (_prev(srow2, -1) == srow2) & (_prev(sd2, -2) == sd2)
    brk = (samegrp & ((spk2 - _prev(spk2, -(1 << 28))) >= 32)).to(
        torch.int32)
    cumbrk = _segmented_sum(brk, ~samegrp)
    real = srow2 < N
    hidx2 = to_idx(srow2)
    at_start = real & (sidx2 == first_ext[hidx2])
    sidx_real = torch.where(real, hidx2, sink)
    start_brk = torch.zeros(size, dtype=torch.int32,
                            device=dev).scatter_reduce_(
        0, sidx_real, torch.where(at_start, cumbrk, 0), "amax")
    member = (real & (sidx2 >= first_ext[hidx2])
              & (cumbrk == start_brk[hidx2]))
    chain = torch.zeros(size, dtype=torch.int32, device=dev).index_add_(
        0, sidx_real, torch.where(member, hw[sidx2], 0)) + 1
    chain = torch.where(started, chain.clamp(max=255), 0)
    # per-field baseline = hit weight; the chain start carries the chain
    chain_bonus = started[hidx0] & (idx == first_ext[hidx0])
    curlcs = torch.where(chain_bonus, chain[hidx0],
                         torch.where(valid, hw, 0))
    return hrow, hpk, hqp, hslot, curlcs, newpos


def build_kernel(sig: PlanSig, n_rows: int, n_fields: int,
                 slot_pb: tuple, slot_hb: tuple, n_hit_iters: int = 0):
    """The search program for one plan shape: (data, rt, decoded) ->
    {"rowid": i32[k], "weight": i32[k], "found": i32[]}; ``decoded`` as
    for ``build_match_core``."""
    core = build_match_core(sig, n_rows, n_fields, slot_pb, slot_hb,
                            n_hit_iters)
    k = sig.k

    def fn(data, rt, decoded):
        eligible, weight, rows, at_rows, factors = core(data, rt, decoded)
        found = eligible.sum(dtype=torch.int32)
        if sig.order[0] == "rel":
            # ties: weight desc, then position asc, as lax.top_k does;
            # positions ascend with the row in every space
            pos = torch.arange(rows.shape[0], dtype=torch.int64,
                               device=rows.device)
            key = torch.where(eligible, weight, INT32_MIN).to(torch.int64)
            top = torch.topk((key << 32) | (0xFFFFFFFF - pos), k).values
            top_pos = 0xFFFFFFFF - (top & 0xFFFFFFFF)
            return {"rowid": rows[top_pos],
                    "weight": (top >> 32).to(torch.int32),
                    "found": found,
                    **{n: v[top_pos] for n, v in factors.items()}}
        if sig.order[0] == "attr_id":
            k1 = torch.where(eligible, rows if sig.order[1] else ~rows,
                             INT32_MAX)
        else:
            _, name, is_asc, is_float = sig.order
            v = at_rows(data["attrs"][name])
            if is_float:
                k1 = _float_order_key(torch.where(
                    eligible, v if is_asc else -v, float("inf")))
            else:
                k1 = torch.where(eligible, v if is_asc else ~v, INT32_MAX)
        # lax.sort((k1, rows, ...), num_keys=2): one int64 key; rows repeat
        # only at pad positions, whose outputs are alike (row N, weight 0)
        key = (k1.to(torch.int64) << 32) | rows.to(torch.int64)
        pos = torch.topk(key, k, largest=False).indices
        # the JAX package gathers the factors at the top ROWS (the same
        # positions: attribute orders keep factors only in dense plans)
        return {"rowid": rows[pos],
                "weight": torch.where(eligible, weight, 0)[pos],
                "found": found,
                **{n: v[rows[pos].to(torch.int64)]
                   for n, v in factors.items()}}

    return fn


def pack_output(out: dict) -> torch.Tensor:
    """One query's result as the batched layout's row: rowid[k] ++
    weight[k] ++ found (i32[2k+1]), then the PACKEDFACTORS() arrays of the
    top k in ``factors.PF_LAYOUT`` order when the program emits them
    (float32 bits viewed as int32), so they ride the batch's one fetch."""
    parts = [out["rowid"], out["weight"], out["found"].reshape(1)]
    if "pf_bm25" in out:
        from .factors import PF_LAYOUT
        for name, _, is_float in PF_LAYOUT:
            v = out[name].contiguous()
            parts.append((v.view(torch.int32) if is_float
                          else v.to(torch.int32)).reshape(-1))
    return torch.cat(parts)


def unpack_factors(row, k: int, n_fields: int, n_slots: int) -> dict:
    """The PACKEDFACTORS() arrays of ``pack_output``'s row tail (a numpy
    int32 array past rowid, weight and found): name -> [k] / [k, F] /
    [k, max(S, 1)], float arrays as float32."""
    from .factors import PF_LAYOUT
    width = {"doc": 1, "field": n_fields, "word": max(n_slots, 1)}
    out, off = {}, 0
    for name, kind, is_float in PF_LAYOUT:
        n = k * width[kind]
        a = row[off:off + n].reshape((k,) if kind == "doc" else
                                     (k, width[kind]))
        out[name] = a.view("float32") if is_float else a
        off += n
    return out
