"""The search program for one plan shape, in PyTorch: read postings ->
scatter-accumulate -> boolean eval -> filters -> rank -> top-k.

Counterpart of ``manticoresearch_tpu/ops/search.py`` for its dense branch
(``sig.sparse == False``, no ``scan_index``): per-row accumulators over all
N+1 rows, row N being the dead pad sink. Every plan shape outside that
slice raises ``NotImplementedError`` naming the feature (see
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
- ``index_add_`` scatters are exact: a real row is hit at most once per
  slot (only the dead sink row N takes many adds, all zero);
- top-k ties go to the lower row (docid asc) through an int64 key
  ``(weight << 32) | (0xFFFFFFFF - row)``, since ``torch.topk`` fixes no
  tie order;
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
_FILTER_KINDS = ("values", "range_i", "range_f")


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
    if sig.sparse or sig.scan_index:
        no("the sparse / filter-first candidate pipeline (sig.sparse, "
           "scan_index)")
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
    for spec in sig.filters:
        if spec.kind not in _FILTER_KINDS:
            no(f"filter kind {spec.kind}")


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
    """One attribute filter as a dense mask (values / range_i / range_f)."""
    if spec.kind == "values":
        v = torch.from_numpy(np.ascontiguousarray(vals)).to(attr.device)
        pos = torch.searchsorted(v, attr).clamp(0, spec.n_values - 1)
        mask = v[pos] == attr
    elif spec.kind == "range_i":
        lo, hi = int(vals[0]), int(vals[1])
        if spec.usgn:
            attr = attr ^ INT32_MIN   # unsigned compare, bounds pre-flipped
        mask = (attr >= lo) & (attr <= hi)
    else:   # range_f; bounds are float32 values, exact as Python floats
        lo, hi = float(vals[0]), float(vals[1])
        lo_ok = (attr > lo) if spec.lo_excl else (attr >= lo)
        hi_ok = (attr < hi) if spec.hi_excl else (attr <= hi)
        mask = lo_ok & hi_ok
    return ~mask if spec.exclude else mask


def _float_order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the order of JAX's sort comparator, NaN after
    +inf. (Its -0.0 == 0.0 needs no care: stored floats are never -0.0, so
    a key column holds zeros of one sign.)"""
    v = torch.where(torch.isnan(v), float("nan"), v)
    b = v.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


_NEEDS_FIELDMASK = ("ws_bm25", "ws", "fieldmask")
_WORDS_KEYS = ("pkrw_w", "pktf_w", "pkfm_w")   # by window kind


def _pos_slots(sig: PlanSig) -> set:
    return positive_slots(sig.expr) if sig.expr[0] != "all" else set()


def window_kinds(sig: PlanSig) -> list[tuple[int, int]]:
    """The (slot, kind) of every packed window the program reads, in
    order; kind 0 is the rowid stream, 1 the tf planes, 2 the fieldmask
    planes. tf and fieldmask are read for positive slots only, fieldmask
    only under the rankers that use it."""
    pos = _pos_slots(sig)
    fm = sig.ranker in _NEEDS_FIELDMASK
    out = []
    for s, packed in enumerate(sig.slot_packed):
        for kind, used in ((0, True), (1, s in pos), (2, fm and s in pos)):
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
                     slot_pb: tuple, slot_hb: tuple):
    """(data, rt, decoded) -> (eligible bool[N+1], weight i32[N+1],
    rows i32[N+1]).

    ``data`` is ``DeviceIndex.data_pytree()``; ``rt`` is the planner's
    runtime dict of numpy arrays (slot windows are read on the host);
    ``decoded`` holds the decoded values of the query's ``packed_windows``
    in their order, each flat int32 [nb * 128]; slot_pb / slot_hb are the
    planner's per-slot posting / hit window sizes."""
    check_in_slice(sig, n_fields)
    N = n_rows
    F = n_fields
    S = sig.n_slots
    W = max(1, (S + 31) // 32)
    size = N + 1
    need_fieldmask = sig.ranker in _NEEDS_FIELDMASK
    use_lcs = sig.ranker in RANKERS_WITH_HITS
    pos_slots = _pos_slots(sig)
    rk_slots = ranker_term_slots(sig.expr) if use_lcs else ()
    slot_packed = sig.slot_packed
    win_of = {sk: i for i, sk in enumerate(window_kinds(sig))}

    def fn(data, rt, decoded):
        dev = data["alive"].device
        attrs = data["attrs"]
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

        # ---- dense scatter-accumulate, one slot after the other ----
        tfidf = torch.zeros(size, dtype=torch.float32, device=dev)
        termmask = torch.zeros((size, W), dtype=torch.int32, device=dev)
        fieldhit = (torch.zeros((size, F), dtype=torch.int32, device=dev)
                    if need_fieldmask else None)
        fshift = torch.arange(F, dtype=torch.int32, device=dev)
        for s in range(S):
            row, msk = slot_postings(s)
            if s in pos_slots:
                # each product is its own rounded float32 op before the add
                contrib = slot_tfq(s) * float(rt["idf"][s])
                contrib = contrib * float(rt["mult"][s])
                tfidf.index_add_(0, row, torch.where(msk, contrib, 0.0))
            termmask[:, s >> 5].index_add_(
                0, row, msk.to(torch.int32) * _bit(s))
            if need_fieldmask and s in pos_slots:
                fm = torch.where(msk, slot_fieldmask(s), 0)
                fh_s = torch.zeros(size, dtype=torch.int32,
                                   device=dev).index_add_(0, row, fm)
                fieldhit |= (fh_s[:, None] >> fshift) & 1

        match = _eval_expr(sig.expr, termmask, size)

        leaf_masks = []
        for i, spec in enumerate(sig.filters):
            attr = attrs[spec.attr]
            if attr.shape[0] == N:   # the pad row repeats the last value
                attr = torch.cat([attr, attr[-1:]])
            leaf_masks.append(_eval_filter(spec, attr,
                                           rt["filter_vals"][i]))

        def combine(node):
            if node[0] == "leaf":
                return leaf_masks[node[1]]
            parts = [combine(c) for c in node[1]]
            out = parts[0]
            for p in parts[1:]:
                out = (out | p) if node[0] == "or" else (out & p)
            return out

        eligible = match & data["alive"]
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
                                 rk_slots, slot_hits, bm25part, fw)
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

        rows = torch.arange(size, dtype=torch.int32, device=dev)
        return eligible, weight, rows

    return fn


def _lcs_weight(sig, rt, match, termmask, size, N, F, rk_slots, slot_hits,
                bm25part, fw):
    """proximity_bm25 / proximity, no-dupes path: the per-field LCS of the
    merged term hit stream as a segmented scan (sort, linked runs, per-field
    max), RankerState_Proximity_fn semantics."""
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
            msk = msk & g[hrow.long()]
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
    hrow64 = hrow.to(torch.int64)
    lcs = torch.stack(
        [torch.zeros(size, dtype=torch.int32, device=dev).scatter_reduce_(
            0, torch.where(hfield == f, hrow64, N),
            torch.where(hfield == f, curlcs, 0), "amax")
         for f in range(F)], dim=1)
    rank = wrap_i32((lcs.to(torch.int64) * fw).sum(dim=1))
    return (bm25part + rank * SPH_BM25_SCALE
            if sig.ranker == "proximity_bm25" else rank)


def build_kernel(sig: PlanSig, n_rows: int, n_fields: int,
                 slot_pb: tuple, slot_hb: tuple):
    """The search program for one plan shape: (data, rt, decoded) ->
    {"rowid": i32[k], "weight": i32[k], "found": i32[]}; ``decoded`` as
    for ``build_match_core``."""
    core = build_match_core(sig, n_rows, n_fields, slot_pb, slot_hb)
    k = sig.k

    def fn(data, rt, decoded):
        eligible, weight, rows = core(data, rt, decoded)
        found = eligible.sum(dtype=torch.int32)
        if sig.order[0] == "rel":
            # ties: weight desc, then row (docid) asc, as lax.top_k does
            key = torch.where(eligible, weight, INT32_MIN).to(torch.int64)
            key = (key << 32) | (0xFFFFFFFF - rows.to(torch.int64))
            top = torch.topk(key, k).values
            return {"rowid": (0xFFFFFFFF - (top & 0xFFFFFFFF)).to(torch.int32),
                    "weight": (top >> 32).to(torch.int32),
                    "found": found}
        if sig.order[0] == "attr_id":
            k1 = torch.where(eligible, rows if sig.order[1] else ~rows,
                             INT32_MAX)
        else:
            _, name, is_asc, is_float = sig.order
            v = data["attrs"][name]
            if v.shape[0] == n_rows:
                v = torch.cat([v, v[-1:]])
            if is_float:
                k1 = _float_order_key(torch.where(
                    eligible, v if is_asc else -v, float("inf")))
            else:
                k1 = torch.where(eligible, v if is_asc else ~v, INT32_MAX)
        # lax.sort((k1, rows, ...), num_keys=2): one int64 key, rows unique
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
