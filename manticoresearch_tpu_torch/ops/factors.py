"""Expression ranker factors (OPTION ranker=expr('...')), in PyTorch.

Counterpart of ``manticoresearch_tpu/ops/factors.py`` (behavioral model:
RankerState_Expr_fn and the factor list, sphinxsearch.cpp:1964 and
2861-2995, Expr_BM25F_T:2562). Factors are computed from the ranker hit
stream as dense per-doc, per-(doc, field) and per-(doc, qword) tensors on
the stream's device; the formula then evaluates as tensor ops and
truncates to the int match weight.

Factors: doc-level bm25, max_lcs, field_mask, query_word_count,
doc_word_count, bm25a(k1, b), bm25f(k1, b[, {field=w, ...}]); field-level
(inside sum(...)) lcs, user_weight, hit_count, word_count, tf_idf,
min_hit_pos, sum_idf / min_idf / max_idf, exact_order, min_best_span_pos,
lccs, wlccs, min_gaps, atc, exact_hit and max_window_hits(n).

Every value must equal what the JAX package computes inside its jitted
search program on the CPU, so the float steps follow XLA's CPU code:
- XLA fuses a multiply into the add or subtract that consumes it as one
  fused multiply-add (LLVM contracts them; not through a select), also
  inside a reduction: ``fma`` rounds once through float64, where the
  product of two float32 values is exact;
- a reduction of at most 32 float terms over one axis adds them left to
  right from 0.0 (``seq_sum``, ``fma_sum``), past 32 terms in windows of
  32 (``_windows``); where LLVM vectorizes the reduction inside its loop
  fusion (bm25a's), lanes are added as a tree (``vec_row_sum``);
- a float ``cumsum`` is a recursive scan of blocks of 16
  (``blocked_cumsum``);
- a float scatter-add adds each cell's updates in update order: a stable
  sort by cell, then the ordered segment sum (``ops.groupby.
  segment_sum_ordered``, the hand-written kernel on the card), whose
  results are written back to their cells (``ordered_scatter_add``);
- integer scatters (add, min, max) are exact in any order and use
  ``index_add_`` / ``scatter_reduce_`` with a sink row;
- a divisor is always a tensor on the operands' device: PyTorch divides
  by a host scalar as a multiply by its reciprocal on the card;
- ``x ** 1.75`` and ``log`` (atc) and the formula functions LN, LOG2,
  LOG10, EXP and POW are computed in float64 and rounded once: XLA's own
  float32 approximations differ from that by an ulp at times.
The translations of the other passes hold here too: JAX's ``cummax`` of
flagged positions is ``search._last_index``, a multi-key ``lax.sort`` is
one int64 key or ``search._stable_order``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import groupby
from .packed_store import wrap_i32
from .search import INT32_MAX, _last_index, _lex_search_le, _prev, _stable_order

DOC_FACTORS = {"bm25", "max_lcs", "field_mask", "query_word_count",
               "doc_word_count"}
FIELD_FACTORS = {"lcs", "user_weight", "hit_count", "word_count", "tf_idf",
                 "min_hit_pos", "exact_hit", "sum_idf", "min_idf", "max_idf",
                 "min_gaps", "atc",
                 "exact_order", "lccs", "wlccs", "min_best_span_pos"}

POS_MASK = (1 << 23) - 1
F32 = torch.float32
I32 = torch.int32
I64 = torch.int64


def factor_names(tree) -> set[str]:
    op = tree[0]
    if op == "attr":
        return {tree[1]}
    if op == "call":
        out = {tree[1].lower()}
        for a in tree[2]:
            out |= factor_names(a)
        return out
    out = set()
    for c in tree[1:]:
        if isinstance(c, tuple):
            out |= factor_names(c)
    return out


def _f32(v: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak constant."""
    return float(np.float32(v))


# --------------------------------------------------------------------------
# float steps in XLA's CPU order
# --------------------------------------------------------------------------
def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a contracted multiply-add): the
    float64 product of two float32 values is exact."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(F32)


def _windows(n: int) -> list[range]:
    """XLA's CPU tree rewrite of a reduction of more than 32 terms: windows
    of 32 over the terms padded to a multiple of 32, half of the padding
    (rounded down) in front; each window's valid terms, in order."""
    if n <= 32:
        return [range(n)]
    nw = -(-n // 32)
    lo = (nw * 32 - n) // 2
    return [range(max(w * 32 - lo, 0), min(w * 32 - lo + 32, n))
            for w in range(nw)]


def seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum over ``dim`` as XLA's CPU reduction: from 0.0 left to
    right, and past 32 terms by ``_windows``, the window sums then added
    left to right."""
    x = x.to(F32).movedim(dim, -1)
    parts = []
    for win in _windows(x.shape[-1]):
        acc = torch.zeros(x.shape[:-1], dtype=F32, device=x.device)
        for i in win:
            acc = acc + x[..., i]
        parts.append(acc)
    return parts[0] if len(parts) == 1 else seq_sum(torch.stack(parts, -1))


def fma_sum(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 sum of ``a * b`` over ``dim`` as XLA reduces a fused
    product: ``acc = fma(a_i, b_i, acc)`` from 0.0, left to right (past 32
    terms by ``_windows``)."""
    a, b = torch.broadcast_tensors(a.to(F32), b.to(F32))
    a, b = a.movedim(dim, -1), b.movedim(dim, -1)
    parts = []
    for win in _windows(a.shape[-1]):
        acc = torch.zeros(a.shape[:-1], dtype=F32, device=a.device)
        for i in win:
            acc = fma(a[..., i], b[..., i], acc)
        parts.append(acc)
    return parts[0] if len(parts) == 1 else seq_sum(torch.stack(parts, -1))


def vec_row_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis of [R, S] values produced in the
    same XLA loop fusion (the BM25 tails): LLVM vectorizes that reduction
    into lanes, i-th term to lane i % VF, then adds the lanes as a halving
    tree. S <= 15: 8 lanes over every term; 16 <= S <= 32: 8 lanes if
    S % 8 < 4 else 4, over the whole vectors, the rest added after the
    tree, left to right; S > 32: ``seq_sum`` (XLA's window rewrite, which
    takes the reduction out of the fusion)."""
    s = v.shape[-1]
    if s > 32:
        return seq_sum(v)
    if s < 16:
        vf, main = 8, s
    else:
        vf = 8 if s % 8 < 4 else 4
        main = s // vf * vf
    n_vec = -(-main // vf)
    lanes = torch.zeros(v.shape[0], n_vec * vf, dtype=F32, device=v.device)
    lanes[:, :main] = v[:, :main]
    acc = lanes[:, :vf]
    for c in range(1, n_vec):
        acc = acc + lanes[:, c * vf:(c + 1) * vf]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    acc = acc[:, 0]
    for i in range(main, s):
        acc = acc + v[:, i]
    return acc


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum of a 1-D tensor, as ``jnp.cumsum`` on
    the CPU: cut into blocks of 16, a sequential sum inside each block (16
    column adds), the block totals scanned the same way recursively, and
    each block's exclusive prefix added."""
    n = x.shape[0]
    nb = -(-n // 16)
    if nb == 0:
        return x.to(F32).clone()
    c = torch.zeros(nb * 16, dtype=F32, device=x.device)
    c[:n] = x
    c = c.view(nb, 16)
    cols = [c[:, 0]]
    for j in range(1, 16):
        cols.append(cols[-1] + c[:, j])
    c = torch.stack(cols, dim=1)
    if nb > 1:
        pre = blocked_cumsum(c[:, 15].contiguous())
        c = torch.cat([c[:1], c[1:] + pre[:-1, None]])
    return c.reshape(-1)[:n]


def ordered_scatter_add(cell: torch.Tensor, vals: torch.Tensor,
                        n_cells: int) -> torch.Tensor:
    """``zeros(n_cells).at[cell].add(vals)`` for float32 values, each
    cell's updates added in update order from 0.0 (XLA's scatter on the
    CPU): a stable sort by cell, the ordered segment sum of each cell's run
    (its ids compacted to the run count, so they fit in int32), and the
    sums written back to their cells."""
    out = torch.zeros(n_cells, dtype=F32, device=vals.device)
    m = cell.shape[0]
    if m == 0:
        return out
    order = torch.sort(cell, stable=True).indices
    sc, sv = cell[order], vals[order].to(F32)
    head = torch.ones(m, dtype=torch.bool, device=vals.device)
    head[1:] = sc[1:] != sc[:-1]
    seg = torch.cumsum(head, dim=0, dtype=I32) - 1
    sums = groupby.segment_sum_ordered(sv.contiguous(), seg, m)
    # every position of a run writes its run's sum: equal values
    return out.scatter_(0, sc, sums[seg.to(I64)])


def _unary_f32(fn, x: torch.Tensor) -> torch.Tensor:
    """A transcendental of float32 values, computed in float64 and rounded
    once: within an ulp of XLA's own approximations, closer than the
    float32 library versions."""
    return fn(x.to(torch.float64)).to(F32)


def _pow_f32(x: torch.Tensor, y) -> torch.Tensor:
    """float32 ``x ** y`` computed in float64 and rounded once (XLA's
    float32 pow of the integer position gaps matches it in all but a few
    in 10^3)."""
    y = y.to(torch.float64) if torch.is_tensor(y) else y
    return torch.pow(x.to(torch.float64), y).to(F32)


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """``trunc(x).astype(int32)`` as XLA converts: saturating, NaN -> 0."""
    t = torch.trunc(x.to(F32))
    v = torch.nan_to_num(t, nan=0.0).clamp(-2.0**31, 2147483520.0).to(I32)
    return torch.where(t >= 2.0**31, INT32_MAX, v)


# --------------------------------------------------------------------------
# the factor inputs of one query, on the device in one copy
# --------------------------------------------------------------------------
_F32_KEYS = ("idf", "idf_by_qpos", "total_field_lens")
_I32_KEYS = ("field_weights", "qpos_fold", "slot_fold")


def factor_inputs(rt: dict, device) -> dict:
    """The runtime arrays the factor passes read, from the planner's numpy
    ``rt``: the float32 and int32 arrays go to ``device`` in ONE
    host-to-device copy (float bits viewed as int32) and come back as
    views; the scalars stay on the host as Python numbers (exact float32
    values)."""
    parts, spec = [], []
    for k in _F32_KEYS + _I32_KEYS:
        if k in rt:
            is_f = k in _F32_KEYS
            a = np.ascontiguousarray(rt[k], np.float32 if is_f else np.int32
                                     ).reshape(-1)
            parts.append(a.view(np.int32))
            spec.append((k, a.size, is_f))
    out: dict = {}
    if parts:
        buf = torch.from_numpy(np.concatenate(parts)).to(device)
        off = 0
        for k, n, is_f in spec:
            t = buf[off:off + n]
            off += n
            out[k] = t.view(F32) if is_f else t
    if "total_field_lens" in rt:
        out["host_total_field_lens"] = np.asarray(rt["total_field_lens"],
                                                  np.float32)
    for k in ("avg_doc_len", "total_docs"):
        if k in rt:
            out[k] = float(np.float32(rt[k][0]))
    if "exact_target" in rt:
        out["exact_target"] = int(rt["exact_target"][0])
    return out


# --------------------------------------------------------------------------
# factors
# --------------------------------------------------------------------------
class FactorContext:
    """Computes factor tensors from the ranker hit stream.

    ``stream``: (hrow, hpk, hqp, hslot, valid) int32 / bool; with query
    dupes it is DEDUPED (one count per physical hit, folded to the first
    instance's qpos: m_dTermsHit / m_dTermDupes, sphinxsearch.cpp:3446)
    while ``raw_stream`` keeps every emission (exact_order, lccs and atc
    walk raw hits in the reference). ``rt`` is ``factor_inputs``' dict.
    Rows are dense, 0..N with row N the sink."""

    def __init__(self, *, N, F, S, stream, lcs, bm25part, termmask, rt,
                 field_lens, fl_on: bool = True, raw_stream=None,
                 max_qpos: int = 0):
        self.N, self.F, self.S = N, F, S
        self.stream = stream
        self.raw_stream = raw_stream if raw_stream is not None else stream
        self.max_qpos = int(max_qpos) if max_qpos else max(S, 1)
        self.lcs = lcs                  # [N+1, F] int32
        self.bm25part = bm25part        # [N+1] int32
        self.termmask = termmask        # [N+1, W] multi-word bitmask
        self.rt = rt
        self.field_lens = field_lens    # [N+1, F]
        # without index_field_lengths the reference has no LENGTH attrs:
        # bm25a / bm25f see dl = 0 (sphinxsearch.cpp m_iDocLen fallback)
        self.fl_bm25 = 1.0 if fl_on else 0.0
        self.dev = lcs.device
        self._cache: dict = {}

    # ---- flat cells of the dense [N+1, F] and [N+1, F, Q] grids ----
    def _cell(self, row, field, valid=None):
        """Flat [N+1, F] cell of (row, field); an invalid entry goes to
        (N, 0), where its neutral value lands."""
        c = row.to(I64) * self.F + field.to(I64)
        return c if valid is None else torch.where(valid, c, self.N * self.F)

    def _grid(self, flat: torch.Tensor) -> torch.Tensor:
        return flat.view(self.N + 1, self.F)

    def _full(self, fill, dtype, per=1) -> torch.Tensor:
        return torch.full(((self.N + 1) * self.F * per,), fill, dtype=dtype,
                          device=self.dev)

    def _scatter_field(self, vals, reduce="add", init=0):
        hrow, hpk, hqp, hslot, valid = self.stream
        hfield = (hpk >> 24) & 0xFF
        row = torch.where(valid, hrow, self.N)
        cell = self._cell(row, hfield, valid)
        if reduce == "add":
            v = torch.where(valid, vals, torch.zeros_like(vals))
            if v.is_floating_point():
                return self._grid(ordered_scatter_add(
                    cell, v, (self.N + 1) * self.F))
            return self._grid(self._full(0, v.dtype).index_add_(0, cell, v))
        if reduce == "min":
            v = torch.where(valid, vals, torch.full_like(vals, init))
            return self._grid(self._full(init, v.dtype).scatter_reduce_(
                0, cell, v, "amin"))
        raise ValueError(reduce)

    def get(self, name: str):
        if name in self._cache:
            return self._cache[name]
        v = self._compute(name)
        self._cache[name] = v
        return v

    def _slot_cells(self):
        """Flat [N+1, F, S'] cell of each stream hit, S' = max(S, 1)."""
        hrow, hpk, hqp, hslot, valid = self.stream
        hfield = (hpk >> 24) & 0xFF
        row = torch.where(valid, hrow, self.N)
        sp = max(self.S, 1)
        cell = (self._cell(row, hfield, valid) * sp
                + hslot.clamp(0, sp - 1).to(I64))
        return cell, valid.to(I32)

    def _seen_qword_field(self):
        """[N+1, F, S] 0/1: qword slot seen in (doc, field)."""
        if "_seen" in self._cache:
            return self._cache["_seen"]
        cell, one = self._slot_cells()
        sp = max(self.S, 1)
        seen = self._full(0, I32, sp).scatter_reduce_(
            0, cell, one, "amax").view(self.N + 1, self.F, sp)
        self._cache["_seen"] = seen
        return seen

    def _field_tf(self):
        """[N+1, F, S]: per-(doc, field, qword) hit counts."""
        if "_ftf" in self._cache:
            return self._cache["_ftf"]
        cell, one = self._slot_cells()
        sp = max(self.S, 1)
        ftf = self._full(0, I32, sp).index_add_(0, cell, one).view(
            self.N + 1, self.F, sp)
        self._cache["_ftf"] = ftf
        return ftf

    def _sorted_stream(self):
        """The stream sorted by (row, packed pos): (srow, spk, sqp, sslot,
        sval). Invalid hits sort to row N with pk 0. lax.sort((row, pk,
        payload), num_keys=2) is one stable sort of an int64 key."""
        if "_sorted" in self._cache:
            return self._cache["_sorted"]
        hrow, hpk, hqp, hslot, valid = self.stream
        row = torch.where(valid, hrow, self.N)
        pk = torch.where(valid, hpk, 0)
        payload = (hqp.clamp(0, 255) | (hslot.clamp(0, 255) << 8)
                   | (valid.to(I32) << 16))
        key = (row.to(I64) << 32) + (pk.to(I64) + 2**31)
        order = torch.sort(key, stable=True).indices
        spl = payload[order]
        out = (row[order], pk[order], spl & 0xFF, (spl >> 8) & 0xFF,
               (spl >> 16) & 1)
        self._cache["_sorted"] = out
        return out

    def _sorted_raw_stream(self):
        """raw_stream sorted by (row, packed pos, qpos): every emission,
        unfolded qpos (exact_order, lccs and atc walk raw hits)."""
        if "_sorted_raw" in self._cache:
            return self._cache["_sorted_raw"]
        hrow, hpk, hqp, hslot, valid = self.raw_stream
        row = torch.where(valid, hrow, self.N)
        pk = torch.where(valid, hpk, 0)
        payload = (hqp.clamp(0, 255) | (hslot.clamp(0, 255) << 8)
                   | (valid.to(I32) << 16))
        order = _stable_order(row, pk, payload)
        spl = payload[order]
        out = (row[order], pk[order], spl & 0xFF, (spl >> 8) & 0xFF,
               (spl >> 16) & 1)
        self._cache["_sorted_raw"] = out
        return out

    def max_window_hits(self, n: int):
        """[N+1, F]: max hits within any n-position window of a field
        (m_dMaxWindowHits): for each hit, count stream hits in
        [pos, pos+n-1] of the same row and field by a bounded predecessor
        search, then a per-field scatter-max."""
        srow, spk, _, _, sval = self._sorted_stream()
        sfield = (spk >> 24) & 0xFF
        m = srow.shape[0]
        idx = torch.arange(m, dtype=I32, device=self.dev)
        n_iters = max(1, int(np.ceil(np.log2(max(m, 2))))) + 1
        hi_key = spk + (max(n, 1) - 1)
        j, ex = _lex_search_le(srow, hi_key, srow, spk, torch.zeros_like(idx),
                               torch.full_like(idx, m), n_iters)
        same = ex & (srow[j] == srow) & ((spk[j] >> 24) == (spk >> 24))
        ok = sval == 1
        cnt = torch.where(same & ok, j - idx + 1, 0).to(I32)
        return self._grid(self._full(0, I32).scatter_reduce_(
            0, self._cell(torch.where(ok, srow, self.N), sfield, ok), cnt,
            "amax"))

    def _compute(self, name: str):
        N, F, S = self.N, self.F, self.S
        rt = self.rt
        dev = self.dev
        hrow, hpk, hqp, hslot, valid = self.stream
        if name == "bm25":
            return self.bm25part
        if name in ("max_lcs", "query_word_count"):
            # number of keywords for plain bag-of-words queries (m_iMaxLCS)
            return torch.full((), S, dtype=I32, device=dev)
        if name == "field_mask":
            # XLA's int32 1 << f is 0 past bit 31
            anyf = (self._seen_qword_field().sum(dim=-1) > 0).to(I64)
            f = torch.arange(F, dtype=I64, device=dev)
            pw = torch.where(f < 32, torch.ones_like(f) << f.clamp(max=31), 0)
            return wrap_i32((anyf * pw).sum(dim=-1))
        if name == "doc_word_count":
            # unique matched keywords in doc = popcount(termmask)
            cnt = torch.zeros(N + 1, dtype=I32, device=dev)
            for s in range(S):
                cnt = cnt + ((self.termmask[:, s >> 5] >> (s & 31)) & 1)
            return cnt
        if name == "lcs":
            return self.lcs
        if name == "user_weight":
            return rt["field_weights"][None, :F].expand(N + 1, F)
        if name == "hit_count":
            return self._scatter_field(torch.ones_like(hrow))
        if name == "word_count":
            return self._seen_qword_field().sum(dim=-1, dtype=I32)
        if name == "tf_idf":
            # sum of idf over stream hit occurrences per field
            return self._scatter_field(rt["idf"][hslot.clamp(0, S - 1)])
        if name == "min_hit_pos":
            mh = self._scatter_field(hpk & POS_MASK, reduce="min",
                                     init=2**22)
            return torch.where(mh >= 2**22, 0, mh)
        if name in ("sum_idf", "min_idf", "max_idf"):
            # idf over the UNIQUE query words matched in the field
            seen = self._seen_qword_field().to(F32)      # [N+1, F, S]
            idf = rt["idf"][:S][None, None, :]
            if name == "sum_idf":
                return fma_sum(seen, idf)
            any_seen = seen.sum(dim=-1) > 0
            if name == "max_idf":
                v = torch.where(seen > 0, idf, float("-inf")).amax(dim=-1)
            else:
                v = torch.where(seen > 0, idf, float("inf")).amin(dim=-1)
            return torch.where(any_seen, v, 0.0)
        if name == "exact_order":
            return self._exact_order()
        if name == "min_best_span_pos" and "qpos_fold" in rt:
            return self._best_span_dupes()
        if name == "min_best_span_pos":
            return self._best_span()
        if name in ("lccs", "wlccs"):
            return self._lccs(name == "wlccs")
        if name == "min_gaps":
            return self._min_gaps()
        if name == "atc" and "idf_by_qpos" in rt:
            # raw-stream ATC (UpdateATC walks every emission; dupe qpos
            # carry the first instance's idf, same-qpos pairs x0.25)
            srow, spk, sqp, _sslot, sval = self._sorted_raw_stream()
            idf_q = rt["idf_by_qpos"]
            q = int(idf_q.shape[0])
            nw = (self.max_qpos + 32) // 32
            return self._atc(srow, spk, sval, sqp.clamp(0, q - 1), idf_q,
                             nw, q)
        if name == "atc":
            srow, spk, sqp, sslot, sval = self._sorted_stream()
            sp = max(S, 1)
            return self._atc(srow, spk, sval, sslot.clamp(0, sp - 1),
                             rt["idf"][:sp], (sp + 31) // 32, sp)
        if name == "exact_hit":
            # field content == query: first hit at pos 1 and the field's
            # token count within the lcs span (the JAX package's
            # approximation of the reference's exact-hit flag)
            mh = self.get("min_hit_pos")
            return ((mh == 1) & (self.field_lens[:, :F] <= self.lcs)).to(I32)
        raise NotImplementedError(f"ranking factor {name!r}")

    def _exact_order(self):
        """Per-field consecutive-qpos chain over RAW hits
        (sphinxsearch.cpp:3503-3515): the counter advances when a hit's
        qpos == last + 1, in stream order; the field sets when the chain
        reaches query_word_count."""
        N, F = self.N, self.F
        srow, spk, sqp, _ssl, sval = self._sorted_raw_stream()
        sfield = (spk >> 24) & 0xFF
        m = srow.shape[0]
        sidx = torch.arange(m, dtype=I32, device=self.dev)
        svalb = sval == 1
        cell = self._cell(torch.where(svalb, srow, N), sfield, svalb)
        cur = self._full(-1, I32)
        alive2 = self._full(True, torch.bool)
        count = self._full(0, I32)
        sink = N * F
        for qv in range(1, self.max_qpos + 1):
            mq = svalb & (sqp == qv) & (sidx > cur[cell]) & alive2[cell]
            nxt = self._full(m, I32).scatter_reduce_(
                0, torch.where(mq, cell, sink), torch.where(mq, sidx, m),
                "amin")
            found = nxt < m
            count = count + (found & alive2).to(I32)
            alive2 = alive2 & found
            cur = torch.where(found, nxt, cur)
        target = self.rt.get("exact_target", self.S)
        return self._grid((count >= target).to(I32))

    def _span_min(self, best, srow, sfld, start_pos):
        big = 2**22
        out = self._full(big, I32).scatter_reduce_(
            0, self._cell(torch.where(best, srow, self.N), sfld, best),
            torch.where(best, start_pos, big).to(I32), "amin")
        return self._grid(torch.where(out >= big, 0, out))

    def _best_span_dupes(self):
        """min_best_span_pos of a dupes query: the HANDLE_DUPES machine
        extends spans through ANY dupe qpos whose qpos delta equals the
        position delta (sphinxsearch.cpp:3358), so chain the RAW stream
        grouped by constant delta = pos - qpos; runs over consecutive
        positions; the min start among runs reaching the field's lcs."""
        N = self.N
        hrow, hpk, hqp, _hslot, valid = self.raw_stream
        row = torch.where(valid, hrow, N)
        fld = (hpk >> 24) & 0xFF
        pos = hpk & POS_MASK
        delta = torch.where(valid, pos - hqp, 1 << 24)
        order = _stable_order(row, fld, delta, pos)
        srow, sfld, sdelta, spos = row[order], fld[order], delta[order], \
            pos[order]
        sval = (srow < N) & (sdelta < (1 << 24))
        p_pos = _prev(spos, -9)
        samekey = ((srow == _prev(srow, -1)) & (sfld == _prev(sfld, -1))
                   & (sdelta == _prev(sdelta, -(1 << 24))))
        linked = samekey & ((spos == p_pos + 1) | (spos == p_pos))
        run_start = _last_index(~linked)
        # same-(delta, pos) re-emissions count once
        hw = (sval & ~(samekey & (spos == p_pos))).to(I32)
        cumw = torch.cumsum(hw, dim=0)
        runw = cumw - cumw[run_start] + hw[run_start]
        lcs_here = self.lcs[torch.where(sval, srow, N), sfld.clamp(
            0, self.F - 1)]
        best = sval & (runw >= lcs_here)
        return self._span_min(best, srow, sfld, spos[run_start])

    def _best_span(self):
        """min_best_span_pos: the LCS linked-run scan over the sorted term
        stream; the min start of runs whose weight reaches the field's
        lcs."""
        N = self.N
        srow, spk, sqp, sslot, sval = self._sorted_stream()
        sfield = (spk >> 24) & 0xFF
        spos = spk & POS_MASK
        delta = spos - sqp
        linked = ((srow == _prev(srow, -1)) & (sfield == _prev(sfield, -1))
                  & (spk > _prev(spk, 0)) & (delta == _prev(delta, 0))
                  & (sval == 1) & (_prev(sval, 0) == 1))
        run_start = _last_index(~linked)
        hw = (sval == 1).to(I32)
        cumw = torch.cumsum(hw, dim=0)
        runw = cumw - cumw[run_start] + hw[run_start]
        ok = sval == 1
        lcs_here = self.lcs[torch.where(ok, srow, N), sfield.clamp(
            0, self.F - 1)]
        best = ok & (runw >= lcs_here)
        return self._span_min(best, srow, sfield, spos[run_start])

    def _lccs(self, weighted: bool):
        """Longest Common Contiguous Subsequence (m_dLCCS / m_dWLCCS): a
        chain of hits where doc position AND query position both advance
        by 1; reset-cumsum runs, per-field scatter-max. lccs counts
        keywords, wlccs sums idf (a float cumsum: ``blocked_cumsum``)."""
        N, S = self.N, self.S
        srow, spk, sqp, sslot, sval = self._sorted_stream()
        sfield = (spk >> 24) & 0xFF
        spos = spk & POS_MASK
        linked = ((srow == _prev(srow, -1)) & (sfield == _prev(sfield, -1))
                  & (spos == _prev(spos, 0) + 1) & (sqp == _prev(sqp, 0) + 1)
                  & (sval == 1) & (_prev(sval, 0) == 1))
        run_start = _last_index(~linked)
        ok = sval == 1
        if weighted:
            hv = torch.where(ok, self.rt["idf"][sslot.clamp(0, S - 1)], 0.0)
            cumv = blocked_cumsum(hv)
        else:
            hv = ok.to(I32)
            cumv = torch.cumsum(hv, dim=0, dtype=I32)
        runv = cumv - cumv[run_start] + hv[run_start]
        cell = self._cell(torch.where(ok, srow, N), sfield, ok)
        return self._grid(self._full(0, runv.dtype).scatter_reduce_(
            0, cell, torch.where(ok, runv, torch.zeros_like(runv)), "amax"))

    def _min_gaps(self):
        """Minimum gaps over windows holding every distinct matched keyword
        of the field (UpdateMinGaps, sphinxsearch.cpp:3643): for each
        window-end hit, the start is the min over present slots of that
        slot's latest occurrence; gaps = span - (words - 1) - 1."""
        N, S = self.N, self.S
        srow, spk, sqp, sslot, sval = self._sorted_stream()
        sfield = (spk >> 24) & 0xFF
        spos = spk & POS_MASK
        m = srow.shape[0]
        head = (srow != _prev(srow, -1)) | (sfield != _prev(sfield, -1))
        seg_id = torch.cumsum(head, dim=0) - 1
        seen = self._seen_qword_field()                 # [N+1, F, S]
        rowv = torch.where(sval == 1, srow, N)
        fc = sfield.clamp(0, self.F - 1)
        wcnt = seen.sum(dim=-1, dtype=I32)[rowv, fc]    # words in segment
        j_min = torch.full((m,), 2**30, dtype=I64, device=self.dev)
        all_ok = torch.ones(m, dtype=torch.bool, device=self.dev)
        for s in range(S):
            last_s = _last_index((sslot == s) & (sval == 1))
            lc = last_s.clamp(0, m - 1)
            ok_s = (last_s >= 0) & (seg_id[lc] == seg_id)
            present = seen[rowv, fc, s] > 0
            j_min = torch.where(present & ok_s, torch.minimum(j_min, last_s),
                                j_min)
            all_ok = all_ok & (~present | ok_s)
        jc = j_min.clamp(0, m - 1)
        gaps = spos - spos[jc] - (wcnt - 1)
        ok = all_ok & (sval == 1) & (wcnt >= 1)
        big = 2**30
        out = self._full(big, I32).scatter_reduce_(
            0, self._cell(torch.where(ok, srow, N), sfield, ok),
            torch.where(ok, gaps, big).to(I32), "amin")
        return self._grid(torch.where(out >= big, 0, out))

    def _atc(self, srow, spk, sval, key, idf_vec, n_words: int, q: int):
        """Aggregate term closeness (UpdateATC / TermTC,
        sphinxsearch.cpp:3904-3995): per hit, sum idf(neighbor) /
        |dpos|^1.75 over the nearest distinct-keyword neighbors within 10
        stream hits each way (same-keyword pairs x0.25, same position
        skipped); field atc = log(1 + sum_k atc_k * idf_k). ``key`` is each
        hit's keyword (raw qpos or slot, clipped), of ``q`` kinds."""
        N, F = self.N, self.F
        sfield = (spk >> 24) & 0xFF
        spos = spk & POS_MASK
        m = srow.shape[0]
        idx = torch.arange(m, dtype=I32, device=self.dev)
        tc = torch.zeros(m, dtype=F32, device=self.dev)
        for step in (-1, 1):
            seen_m = [torch.zeros(m, dtype=I32, device=self.dev)
                      for _ in range(n_words)]
            for d in range(1, 11):
                j = idx + step * d
                jc = j.clamp(0, m - 1)
                ok = ((j >= 0) & (j < m) & (sval == 1)
                      & (srow[jc] == srow) & (sfield[jc] == sfield)
                      & (sval[jc] == 1))
                key_j = key[jc].clamp(0, n_words * 32 - 1)
                delta = (spos - spos[jc]).abs()
                ok = ok & (delta > 0)            # same hitpos: skipped
                already = torch.zeros(m, dtype=torch.bool, device=self.dev)
                for w in range(n_words):
                    already = already | (
                        ((seen_m[w] >> (key_j & 31)) & 1).bool()
                        & ((key_j >> 5) == w))
                take = ok & ~already
                contrib = idf_vec[key_j.clamp(0, q - 1)] / _pow_f32(
                    delta.to(F32), 1.75)
                contrib = torch.where(key_j == key, contrib * 0.25, contrib)
                tc = tc + torch.where(take, contrib, 0.0)
                for w in range(n_words):
                    seen_m[w] = seen_m[w] | torch.where(
                        take & ((key_j >> 5) == w),
                        torch.ones_like(key_j) << (key_j & 31), 0)
        ok = sval == 1
        cell = self._cell(torch.where(ok, srow, N), sfield, ok) * q + \
            key.to(I64)
        a = ordered_scatter_add(cell, torch.where(ok, tc, 0.0),
                                (N + 1) * F * q).view(N + 1, F, q)
        # log(1.0f + ws) in f32: the reference rounds 1 + ws BEFORE the
        # log (UpdateATC, sphinxsearch.cpp:3992)
        ws = fma_sum(a, idf_vec[None, None, :])
        return _unary_f32(torch.log, 1.0 + ws)

    # ---- BM25 variants ------------------------------------------------
    def bm25a(self, k1: float, b: float):
        tf = self._field_tf().sum(dim=1).to(F32)                  # [N+1, S]
        dl = (self.field_lens[:, :self.F].sum(dim=1).to(F32)
              * _f32(self.fl_bm25))
        avgdl = max(self.rt["avg_doc_len"], _f32(1e-6))
        return self._bm25_tail(tf, dl, avgdl, k1, b, vec_row_sum)

    def bm25f(self, k1: float, b: float, weights=None):
        # Expr_BM25F_T::Eval, literal
        ftf = self._field_tf().to(F32)                         # [N+1, F, S]
        wl = [1.0] * self.F if weights is None else [_f32(w) for w in
                                                      weights]
        w = torch.stack([torch.full((), v, dtype=F32, device=self.dev)
                         for v in wl])
        tf = fma_sum(ftf, w[None, :, None], dim=1)             # [N+1, S]
        dl = _f32(self.fl_bm25) * fma_sum(
            self.field_lens[:, :self.F].to(F32), w[None, :], dim=1)
        # weighted avgdl = sum_f total_field_len_f * w_f / total_docs, on
        # the host (a fused reduce, then a float32 divide)
        tfl = self.rt["host_total_field_lens"]
        acc = np.float32(0.0)
        for f in range(self.F):
            acc = np.float32(np.float64(tfl[f]) * np.float64(wl[f])
                             + np.float64(acc))
        avgdl = float(acc / np.float32(max(self.rt["total_docs"], 1.0)))
        return self._bm25_tail(tf, dl, max(avgdl, _f32(1e-6)), k1, b,
                               seq_sum)

    def _bm25_tail(self, tf, dl, avgdl: float, k1: float, b: float,
                   row_sum):
        """sum_s (tf > 0 ? tf / (tf + k1 * (1 - b + b * dl / avgdl)) *
        idf : 0) + 0.5, in XLA's CPU order: with one keyword there is no
        reduction loop, and LLVM contracts both k1 * (...) + tf and
        (...) * idf + 0.5; with more, k1 * (...) is computed once per row
        outside the reduction loop, which ``row_sum`` reproduces (bm25a's
        loop, which also sums tf over the fields, is vectorized; bm25f's,
        over its materialized tf, is not)."""
        dev = self.dev
        inner = _f32(1.0 - b) + (_f32(b) * dl[:, None]) / torch.full(
            (), avgdl, dtype=F32, device=dev)
        k1t = torch.full((), _f32(k1), dtype=F32, device=dev)
        idf = self.rt["idf"][:self.S][None, :]
        if tf.shape[1] == 1:
            q = tf / fma(k1t, inner, tf)
            half = torch.full_like(q, 0.5)
            return torch.where(tf > 0, fma(q, idf, half), half)[:, 0]
        res = row_sum(torch.where(tf > 0, tf / (tf + k1t * inner) * idf,
                                  0.0))
        return res + 0.5


# --------------------------------------------------------------------------
# the formula
# --------------------------------------------------------------------------
def eval_ranker_expr(tree, ctx: FactorContext, per_field: bool = False):
    """Evaluate a ranker formula tree to a [N+1] (or [N+1, F] inside
    sum()) tensor. A float multiply consumed by an add or subtract is one
    fused multiply-add, as XLA compiles it."""
    op = tree[0]
    dev = ctx.dev
    if op == "num":
        return torch.full((), _f32(tree[1]), dtype=F32, device=dev)
    if op == "attr":
        name = tree[1].lower()
        if per_field:
            if name in FIELD_FACTORS:
                return ctx.get(name)
            if name in DOC_FACTORS:
                v = ctx.get(name)
                return v[..., None] if v.dim() == 1 else v
            raise NotImplementedError(f"factor {name!r}")
        if name in DOC_FACTORS:
            return ctx.get(name)
        if name in FIELD_FACTORS:
            raise ValueError(
                f"field factor {name!r} only valid inside sum()")
        raise NotImplementedError(f"factor {name!r}")

    def ev(t):
        return eval_ranker_expr(t, ctx, per_field)

    if op == "neg":
        return -ev(tree[1])
    if op in ("add", "sub"):
        def factors_of(node):
            """(x, y, fused) of a multiply operand, else (value,)."""
            if node[0] != "mul":
                return (ev(node),)
            x, y = ev(node[1]), ev(node[2])
            return x, y, torch.result_type(x, y).is_floating_point

        left = factors_of(tree[1])
        if len(left) == 3 and left[2]:          # x*y + c, x*y - c
            c = ev(tree[2])
            return fma(left[0], left[1], c if op == "add" else -c.to(F32))
        a = left[0] * left[1] if len(left) == 3 else left[0]
        right = factors_of(tree[2])
        if len(right) == 3 and right[2]:        # a + x*y, a - x*y
            x = right[0] if op == "add" else -right[0].to(F32)
            return fma(x, right[1], a)
        b = right[0] * right[1] if len(right) == 3 else right[0]
        return a + b if op == "add" else a - b
    if op in ("mul", "div", "cmp_gt", "cmp_ge", "cmp_lt", "cmp_le",
              "cmp_eq", "cmp_ne", "and", "or", "mod"):
        a, b = ev(tree[1]), ev(tree[2])
        if op == "mul":
            return a * b
        if op == "div":
            return a / b        # true division: integers give float32
        if op == "mod":
            # jnp.remainder: the truncated remainder, moved to the sign of
            # the divisor (torch.remainder rounds differently for floats)
            r = torch.fmod(a, b)
            fix = (r != 0) & ((b < 0) != (r < 0))
            return torch.where(fix, r + b, r)
        if op == "and":
            return ((a != 0) & (b != 0)).to(F32)
        if op == "or":
            return ((a != 0) | (b != 0)).to(F32)
        t = {"cmp_gt": torch.gt, "cmp_ge": torch.ge, "cmp_lt": torch.lt,
             "cmp_le": torch.le, "cmp_eq": torch.eq, "cmp_ne": torch.ne}[op]
        return t(a, b).to(F32)
    if op == "call":
        name = tree[1].upper()
        args = tree[2]
        if name == "SUM":
            inner = args[0]
            if inner[0] == "mul":
                x = eval_ranker_expr(inner[1], ctx, per_field=True)
                y = eval_ranker_expr(inner[2], ctx, per_field=True)
                if torch.result_type(x, y).is_floating_point:
                    return fma_sum(*torch.broadcast_tensors(x, y))
                return seq_sum(x * y)
            return seq_sum(eval_ranker_expr(inner, ctx, per_field=True))
        if name == "MAX_WINDOW_HITS":
            if not per_field:
                raise ValueError(
                    "max_window_hits() only valid inside sum()")
            return ctx.max_window_hits(int(args[0][1]))
        if name == "BM25A":
            return ctx.bm25a(float(args[0][1]), float(args[1][1]))
        if name == "BM25F":
            weights = None
            if len(args) > 2 and args[2][0] == "fieldweights":
                # planner resolved {field=w, ...} to schema field order
                weights = list(args[2][1])
            return ctx.bm25f(float(args[0][1]), float(args[1][1]), weights)
        if name in ("MIN", "MAX"):
            a, b = ev(args[0]), ev(args[1])
            return torch.minimum(a, b) if name == "MIN" else \
                torch.maximum(a, b)
        if name == "ABS":
            return torch.abs(ev(args[0]))
        if name == "IF":
            c, a, b = ev(args[0]), ev(args[1]), ev(args[2])
            return torch.where(c != 0, a, b)
        if name in ("LN", "LOG2", "LOG10", "SQRT", "EXP"):
            f = {"LN": torch.log, "LOG2": torch.log2, "LOG10": torch.log10,
                 "SQRT": torch.sqrt, "EXP": torch.exp}[name]
            return _unary_f32(f, ev(args[0]).to(F32))
        if name == "POW":
            a, b = ev(args[0]), ev(args[1])
            if not (a.is_floating_point() or b.is_floating_point()):
                return torch.pow(a, b)         # integer power
            return _pow_f32(a.to(F32), b.to(F32))
        raise NotImplementedError(f"ranker function {name}()")
    raise NotImplementedError(f"ranker expr node {op!r}")


def expr_weight(tree, ctx: FactorContext) -> torch.Tensor:
    """The formula's int32 match weight: (int) of its float32 value."""
    return _trunc_i32(eval_ranker_expr(tree, ctx))


# PACKEDFACTORS() arrays, in the packed output's order: (name, kind,
# float), kind "doc" [Z], "field" [Z, F], "word" [Z, S']
PF_LAYOUT = (
    ("pf_bm25", "doc", False), ("pf_bm25a", "doc", True),
    ("pf_doc_word_count", "doc", False), ("pf_field_mask", "doc", False),
    ("pf_lcs", "field", False), ("pf_hit_count", "field", False),
    ("pf_word_count", "field", False), ("pf_tf_idf", "field", True),
    ("pf_min_idf", "field", True), ("pf_max_idf", "field", True),
    ("pf_sum_idf", "field", True), ("pf_min_hit_pos", "field", False),
    ("pf_min_best_span_pos", "field", False),
    ("pf_exact_hit", "field", False), ("pf_max_window_hits", "field", False),
    ("pf_min_gaps", "field", False), ("pf_exact_order", "field", False),
    ("pf_lccs", "field", False), ("pf_wlccs", "field", True),
    ("pf_atc", "field", True), ("pf_word_tf", "word", False),
)


def packed_factors(ctx: FactorContext, bm25part, lcs) -> dict:
    """The PACKEDFACTORS() arrays (Expr_GetPackedFactors_T analog): every
    factor of the blob, per row."""
    return {
        "pf_bm25": bm25part,
        "pf_bm25a": ctx.bm25a(1.2, 0.75),
        "pf_doc_word_count": ctx.get("doc_word_count"),
        "pf_field_mask": ctx.get("field_mask"),
        "pf_lcs": lcs,
        "pf_hit_count": ctx.get("hit_count"),
        "pf_word_count": ctx.get("word_count"),
        "pf_tf_idf": ctx.get("tf_idf"),
        "pf_min_idf": ctx.get("min_idf"),
        "pf_max_idf": ctx.get("max_idf"),
        "pf_sum_idf": ctx.get("sum_idf"),
        "pf_min_hit_pos": ctx.get("min_hit_pos"),
        "pf_min_best_span_pos": ctx.get("min_best_span_pos"),
        "pf_exact_hit": ctx.get("exact_hit"),
        "pf_max_window_hits": ctx.max_window_hits(1),
        "pf_min_gaps": ctx.get("min_gaps"),
        "pf_exact_order": ctx.get("exact_order"),
        "pf_lccs": ctx.get("lccs"),
        "pf_wlccs": ctx.get("wlccs"),
        "pf_atc": ctx.get("atc"),
        "pf_word_tf": ctx._field_tf().sum(dim=1, dtype=I32),
    }
