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
``rows_vec`` holds each position's row. Every plan shape outside the
ported slice raises ``NotImplementedError`` naming the feature (see
``check_in_slice``); nothing falls back to other code.

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
- multi-key sorts become one sort of an int64 composite key;
- int32 shifts are arithmetic, so every extracted bit is masked with ``& 1``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..query.plan import (RANKERS_WITH_HITS, PlanSig, positive_slots,
                          ranker_term_slots)
from .device_index import window
from .packed_store import BLOCK, wrap_i32

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1
SPH_BM25_SCALE = 1000  # sphinxsearch.cpp:31
HITMAN_KEY_MASK = ~(1 << 23)  # strip the field-end flag for position compares
K1 = float(np.float32(1.2))   # BM25 k1, exact as a float32

_PHRASE_OPS = ("phrase", "proximity", "near", "sentence", "paragraph",
               "bigram_phrase")
_RANKERS = ("proximity_bm25", "proximity", "ws_bm25", "ws", "none",
            "fieldmask")


def _bit(s: int) -> int:
    """int32 value of term bit s & 31 (bit 31 is INT32_MIN)."""
    v = 1 << (s & 31)
    return v - 2**32 if v >= 2**31 else v


def _has_phrase(expr: tuple) -> bool:
    op = expr[0]
    if op in _PHRASE_OPS:
        return True
    if op in ("and", "or"):
        return any(_has_phrase(c) for c in expr[1])
    if op in ("andnot", "maybe"):
        return _has_phrase(expr[1]) or _has_phrase(expr[2])
    return False


def check_in_slice(sig: PlanSig, n_fields: int) -> None:
    """Raise NotImplementedError for a plan shape the port does not run."""
    def no(feature: str):
        raise NotImplementedError(f"{feature} is not ported to the PyTorch "
                                  "search path yet")
    if sig.slot_limited:
        no("field-, zone- or position-limited term slots (slot_limited)")
    if _has_phrase(sig.expr):
        no("phrase / proximity / NEAR / SENTENCE / PARAGRAPH nodes")
    if sig.merge_groups:
        no("wildcard payload term-merge groups (merge_groups)")
    if sig.emit_factors:
        no("PACKEDFACTORS() (emit_factors)")
    if sig.ranker not in _RANKERS:
        no(f"ranker={sig.ranker}")
    if sig.ranker in RANKERS_WITH_HITS and (sig.has_dupes or sig.slot_occs):
        no("repeated query keywords under an LCS ranker "
           "(has_dupes / slot_occs)")
    if (n_fields + 31) >> 5 > 1:
        no("indexes with more than 32 full-text fields")


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


def _member_scan(cand_row, b_row, b_valid, payloads: tuple):
    """Membership of each candidate row in ONE posting slice, with the
    matching posting's payloads: -> (present bool[B], payloads aligned to
    the candidates, 0 where absent). The JAX package's sort + cummax +
    scatter-back: its ``lax.sort`` of (row, tag) becomes one stable sort
    of the int64 key ``row << 32 | tag``; tag 0 marks postings, so a
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
    iota = torch.arange(nb + na, dtype=torch.int64, device=dev)
    j = torch.cummax(torch.where(tag_s == 0, iota, -1), dim=0).values
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
def _eval_expr(expr: tuple, termmask: torch.Tensor, size: int) -> torch.Tensor:
    """Bottom-up boolean evaluation on the [Z, W] term-presence bitmask."""
    op = expr[0]
    if op == "term":
        s = expr[1]
        return ((termmask[:, s >> 5] >> (s & 31)) & 1).bool()
    if op == "all":
        return torch.ones(size, dtype=torch.bool, device=termmask.device)
    if op in ("and", "or"):
        m = _eval_expr(expr[1][0], termmask, size)
        for c in expr[1][1:]:
            mc = _eval_expr(c, termmask, size)
            m = (m & mc) if op == "and" else (m | mc)
        return m
    if op == "andnot":
        return (_eval_expr(expr[1], termmask, size)
                & ~_eval_expr(expr[2], termmask, size))
    if op == "maybe":
        # MAYBE matches on its left arm; the right arm only adds rank
        return _eval_expr(expr[1], termmask, size)
    if op == "quorum":
        slots, need = expr[1], expr[2]
        cnt = torch.zeros(termmask.shape[0], dtype=termmask.dtype,
                          device=termmask.device)
        for s in slots:
            cnt = cnt + ((termmask[:, s >> 5] >> (s & 31)) & 1)
        return cnt >= need
    raise NotImplementedError(f"expression node {op!r}")


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
    """float32 -> int32 with the order of JAX's sort comparator, NaN after
    +inf. (Its -0.0 == 0.0 needs no care: stored floats are never -0.0, so
    a key column holds zeros of one sign.)"""
    v = torch.where(torch.isnan(v), float("nan"), v)
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
    planes. tf is read for positive slots, and for every slot by the
    filter-first branch (its membership scan carries tf as a payload);
    fieldmask for positive slots under the rankers that use it."""
    pos = _pos_slots(sig)
    fm = sig.ranker in _NEEDS_FIELDMASK
    out = []
    for s, packed in enumerate(sig.slot_packed):
        for kind, used in ((0, True), (1, s in pos or bool(sig.scan_index)),
                           (2, fm and s in pos)):
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
    i32[Z], at_rows), Z = N+1 (dense) or B (sparse, filter-first);
    ``at_rows(v)`` takes a per-row tensor (its pad row optional) to
    ``rows``.

    ``data`` is ``DeviceIndex.data_pytree()``; ``rt`` is the planner's
    runtime dict of numpy arrays (slot windows are read on the host);
    ``decoded`` holds the decoded values of the query's ``packed_windows``
    in their order, each flat int32 [nb * 128]; slot_pb / slot_hb are the
    planner's per-slot posting / hit window sizes; ``n_hit_iters`` bounds
    the binary searches of the MVA filters."""
    check_in_slice(sig, n_fields)
    N = n_rows
    F = n_fields
    S = sig.n_slots
    W = max(1, (S + 31) // 32)
    scan_index = sig.scan_index
    if sig.sparse:
        size = sig.scan_bucket if scan_index else int(sum(slot_pb))
    else:
        size = N + 1
    need_fieldmask = sig.ranker in _NEEDS_FIELDMASK
    use_lcs = sig.ranker in RANKERS_WITH_HITS
    pos_slots = _pos_slots(sig)
    rk_slots = ranker_term_slots(sig.expr) if use_lcs else ()
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
                row, msk = slot_postings(s)
                fm_pay = need_fieldmask and s in pos_slots
                pays = ((slot_tfq(s), slot_fieldmask(s)) if fm_pay
                        else (slot_tfq(s),))
                present, outs = _member_scan(
                    cand_row, torch.where(msk, row, N + 1), msk, pays)
                if s in pos_slots:
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
                # posting rows; segments past the last head keep row N, so
                # cand_row stays ascending ----
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
                    return r
            # ---- scatter-accumulate, one slot after the other ----
            for s, (row, msk) in enumerate(postings):
                idx = to_idx(row)
                if s in pos_slots:
                    tfidf.index_add_(0, idx, torch.where(
                        msk, contribution(s, slot_tfq(s)), 0.0))
                termmask[:, s >> 5].index_add_(
                    0, idx, msk.to(torch.int32) * _bit(s))
                if need_fieldmask and s in pos_slots:
                    fm = torch.where(msk, slot_fieldmask(s), 0)
                    fh_s = torch.zeros(size, dtype=torch.int32,
                                       device=dev).index_add_(0, idx, fm)
                    fieldhit |= (fh_s[:, None] >> fshift) & 1

        def at_rows(v: torch.Tensor) -> torch.Tensor:
            if v.shape[0] == N:   # the pad row repeats the last value
                v = torch.cat([v, v[-1:]])
            return v[rows_vec] if sig.sparse else v

        match = _eval_expr(sig.expr, termmask, size)

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
        if use_lcs:
            weight = _lcs_weight(sig, rt, match, termmask, size, N, F,
                                 rk_slots, slot_hits, to_idx, bm25part, fw)
        elif sig.ranker in ("ws_bm25", "ws"):
            rank = wrap_i32((fieldhit.to(torch.int64) * fw).sum(dim=1))
            weight = (bm25part + rank * SPH_BM25_SCALE
                      if sig.ranker == "ws_bm25" else rank)
        elif sig.ranker == "none":
            weight = torch.ones(size, dtype=torch.int32, device=dev)
        else:   # fieldmask: the matched-field bitmask itself (a DWORD)
            pw = torch.tensor([1 << f for f in range(F)], dtype=torch.int64,
                              device=dev)
            weight = wrap_i32((fieldhit.to(torch.int64) * pw).sum(dim=1))

        return eligible, weight, rows_vec, at_rows

    return fn


def _lcs_weight(sig, rt, match, termmask, size, N, F, rk_slots, slot_hits,
                to_idx, bm25part, fw):
    """proximity_bm25 / proximity, no-dupes path: the per-field LCS of the
    merged term hit stream as a segmented scan (sort, linked runs, per-field
    max), RankerState_Proximity_fn semantics. Hit rows reach the program's
    row space through ``to_idx``; position size - 1 is the scatter sink,
    and every value sent there by a masked hit is 0."""
    dev = termmask.device
    qpos = rt["qpos"]

    # boolean-subtree emission gating: a term's hits reach the ranker only
    # where every enclosing AND/ANDNOT/MAYBE-right/QUORUM subtree matched
    gate_cache: dict = {repr(sig.expr): match}
    slot_paths: dict[int, list] = {}

    def anc_walk(node, anc):
        op = node[0]
        if op == "term":
            slot_paths.setdefault(node[1], []).append(tuple(anc))
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
                    gate_cache[key] = _eval_expr(nd, termmask, size)
                g = gate_cache[key] if g is None else (g & gate_cache[key])
            alts.append(g)
        out = alts[0]
        for g in alts[1:]:
            out = out | g
        return out

    parts_row, parts_pk, parts_pay = [], [], []
    for s in rk_slots:
        hrow, hpk, msk = slot_hits(s)
        g = gate_of(slot_paths.get(s, []))
        if g is not None:
            msk = msk & g[to_idx(hrow)]
            hrow = torch.where(msk, hrow, N)
            hpk = torch.where(msk, hpk, 0)
        m32 = msk.to(torch.int32)
        # payload: qpos | weight << 8 | span 1 << 16 | slot << 24
        qp = m32 * int(qpos[s])
        parts_row.append(hrow)
        parts_pk.append(hpk)
        parts_pay.append(qp.clamp(0, 255) | (m32 << 8) | (1 << 16)
                         | (s << 24))
    if not parts_row:
        return (bm25part if sig.ranker == "proximity_bm25"
                else torch.zeros(size, dtype=torch.int32, device=dev))

    hrow = torch.cat(parts_row)
    hpk = torch.cat(parts_pk)
    payload = torch.cat(parts_pay)
    # lax.sort((hrow, hpk, payload), num_keys=2) on signed int32 keys
    key = (hrow.to(torch.int64) << 32) + (hpk.to(torch.int64) + 2**31)
    order = torch.sort(key, stable=True).indices
    hrow, hpk, payload = hrow[order], hpk[order], payload[order]
    hqp = payload & 0xFF
    hw = (payload >> 8) & 0xFF
    hsp = (payload >> 16) & 0xFF
    delta = hpk - hqp

    def prev(x, fill):
        return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=dev),
                          x[:-1]])
    linked = ((hrow == prev(hrow, -1)) & (hpk > prev(hpk, 0))
              & (delta == prev(delta, 0) + prev(hsp, 0) - 1))
    idx = torch.arange(hrow.shape[0], dtype=torch.int64, device=dev)
    run_start = torch.cummax(torch.where(linked, 0, idx), dim=0).values
    cumw = torch.cumsum(hw, dim=0)                      # int64
    curlcs = (cumw - cumw[run_start] + hw[run_start]).clamp(max=255)
    curlcs = curlcs.to(torch.int32)                     # BYTE m_uCurLCS

    hfield = (hpk >> 24) & 0xFF
    hidx = to_idx(hrow).to(torch.int64)
    lcs = torch.stack(
        [torch.zeros(size, dtype=torch.int32, device=dev).scatter_reduce_(
            0, torch.where(hfield == f, hidx, size - 1),
            torch.where(hfield == f, curlcs, 0), "amax")
         for f in range(F)], dim=1)
    rank = wrap_i32((lcs.to(torch.int64) * fw).sum(dim=1))
    return (bm25part + rank * SPH_BM25_SCALE
            if sig.ranker == "proximity_bm25" else rank)


def build_kernel(sig: PlanSig, n_rows: int, n_fields: int,
                 slot_pb: tuple, slot_hb: tuple, n_hit_iters: int = 0):
    """The search program for one plan shape: (data, rt, decoded) ->
    {"rowid": i32[k], "weight": i32[k], "found": i32[]}; ``decoded`` as
    for ``build_match_core``."""
    core = build_match_core(sig, n_rows, n_fields, slot_pb, slot_hb,
                            n_hit_iters)
    k = sig.k

    def fn(data, rt, decoded):
        eligible, weight, rows, at_rows = core(data, rt, decoded)
        found = eligible.sum(dtype=torch.int32)
        if sig.order[0] == "rel":
            # ties: weight desc, then position asc, as lax.top_k does;
            # positions ascend with the row in every space
            pos = torch.arange(rows.shape[0], dtype=torch.int64,
                               device=rows.device)
            key = torch.where(eligible, weight, INT32_MIN).to(torch.int64)
            top = torch.topk((key << 32) | (0xFFFFFFFF - pos), k).values
            return {"rowid": rows[0xFFFFFFFF - (top & 0xFFFFFFFF)],
                    "weight": (top >> 32).to(torch.int32),
                    "found": found}
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
        return {"rowid": rows[pos],
                "weight": torch.where(eligible, weight, 0)[pos],
                "found": found}

    return fn


def pack_output(out: dict) -> torch.Tensor:
    """One query's result as the batched layout's row: rowid[k] ++
    weight[k] ++ found (i32[2k+1])."""
    return torch.cat([out["rowid"], out["weight"], out["found"].reshape(1)])
