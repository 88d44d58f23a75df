"""The LCS walk (``ops.search.lcs_walk``, csrc/lcs_walk.cu): the proximity
rankers' pass over sorted hit lists, one position at a time.

``walk_numpy`` states the walk in NumPy: per position, find its row in each
list, merge the row's entries by (key, list, entry), run the state machine
(clamps, linked runs, the 255 cap, each field's maximum) and compose the
weight with int32 wrap-around. The kernel's plain version is the eager
ranker, ``_rank_hit_stream``; ``eager_lists`` feeds it the lists laid end
to end as the hit stream. The CPU tests hold the statement equal to it on
random lists, and both equal to the eager hit stream (``_hit_stream`` +
``_rank_hit_stream``) on random programs: slots' hit windows, phrase,
proximity and bigram nodes, gates from nested trees, limited slots. They
also check which plan shapes take the kernel.

The tests marked ``card`` run the kernel on an NVIDIA card: bit-exact
against the eager pass on the same random cases, and on the hit lists of
one query of each of the 12 non-term categories of the ``lucene_tasks``
mix on a small built index, whose search results must equal the CPU's.
This file imports no JAX; run them on a host without it, where
``tests/conftest.py`` (which imports JAX) cannot load, with ``python -m
pytest tests/test_torch_lcs_walk.py -m card --noconftest``.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from manticoresearch_tpu_torch.ops import search
from manticoresearch_tpu_torch.ops.search import (HITMAN_KEY_MASK,
                                                  INT32_MAX, HitList,
                                                  _eval_expr, _hit_stream,
                                                  _rank_hit_stream,
                                                  _ranker_gates, _walk_lists,
                                                  lcs_walk, takes_lcs_walk)
from manticoresearch_tpu_torch.query.plan import (positive_phrase_nodes,
                                                  ranker_term_slots)
from manticoresearch_tpu_torch.utils import trace


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def walk_numpy(lists, rows, bm25part, fw, with_bm25: bool) -> np.ndarray:
    """The walk, position by position. ``lists`` as ``HitList`` with numpy
    arrays (or None) in place of tensors."""
    F = len(fw)
    out = np.empty(len(rows), np.int32)
    for p, r in enumerate(rows.tolist()):
        ents = []
        for li, h in enumerate(lists):
            if h.gate is not None and not h.gate[p]:
                continue
            row = h.row[:h.n]
            for i in range(int(np.searchsorted(row, r, "left")),
                           int(np.searchsorted(row, r, "right"))):
                if h.ok is not None and not h.ok[i]:
                    continue
                w = h.weight[i] if isinstance(h.weight, np.ndarray) \
                    else h.weight
                ents.append((_i32(int(h.key[i]) & h.key_mask), li, i,
                             int(np.clip(h.qpos, 0, 255)),
                             int(np.clip(h.span, 0, 255)),
                             int(np.clip(w, 0, 255))))
        ents.sort(key=lambda e: e[:3])
        lcs = [0] * F
        prev = None
        run = 0
        for key, _li, _i, qp, sp, w in ents:
            delta = _i32(key - qp)
            linked = (prev is not None and key > prev[0]
                      and delta == _i32(prev[1] + prev[2] - 1))
            run = min(run + w, 255) if linked else w
            f = (key >> 24) & 0xFF
            if f < F:
                lcs[f] = max(lcs[f], run)
            prev = (key, delta, sp)
        rank = _i32(sum(lcs[f] * int(fw[f]) for f in range(F)))
        out[p] = (_i32(int(bm25part[p]) + rank * 1000) if with_bm25
                  else rank)
    return out


def eager_lists(lists, rows, bm25part, fw, with_bm25: bool) -> torch.Tensor:
    """The eager ranker over the lists laid end to end as the hit stream, a
    masked entry moved past every row (key 0, weight 0), on the lists'
    device: the kernel's plain version on the kernel's own arguments."""
    size = rows.shape[0]

    def to_idx(r):
        return torch.searchsorted(rows, r).clamp(0, size - 1)

    parts = []
    for h in lists:
        msk = torch.arange(h.row.shape[0], device=rows.device) < h.n
        if h.ok is not None:
            msk = msk & h.ok
        if h.gate is not None:
            msk = msk & h.gate[to_idx(h.row)]
        w = (h.weight if isinstance(h.weight, torch.Tensor)
             else torch.full_like(h.row, h.weight))
        parts.append((torch.where(msk, h.row, INT32_MAX),
                      torch.where(msk, h.key & h.key_mask, 0),
                      torch.full_like(h.row, h.qpos),
                      torch.where(msk, w, 0),
                      torch.full_like(h.row, h.span)))
    stream = tuple(torch.cat(c) for c in zip(*parts)) + (None,)
    sig = SimpleNamespace(ranker="proximity_bm25" if with_bm25
                          else "proximity", has_dupes=False, slot_occs=())
    fw_t = torch.from_numpy(np.asarray(fw, np.int64)).to(rows.device)
    return _rank_hit_stream(sig, stream, bm25part, fw_t, to_idx, size,
                            INT32_MAX, len(fw), 0)[0]


def _np_lists(lists):
    def cv(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else t
    return [HitList(*(cv(v) for v in h)) for h in lists]


def _to(lists, dev):
    def mv(t):
        return t.to(dev) if isinstance(t, torch.Tensor) else t
    return [HitList(*(mv(v) for v in h)) for h in lists]


# --------------------------------------------------------------------------
# random lists
# --------------------------------------------------------------------------
def list_case(seed: int, n_lists: int, dense: bool):
    """Random sorted lists over a dense or sparse position space: ->
    (lists, rows, bm25part, fw, with_bm25), tensors on the CPU. Shared
    phrase starts make the lists' keys chain into runs; equal (row, key)
    entries across lists and within one list test the tie order."""
    rng = np.random.default_rng(seed)
    N = int(rng.integers(20, 60))
    if dense:
        rows = np.arange(N + 1, dtype=np.int32)
        real = rows[:-1]
    else:
        real = np.sort(rng.choice(N, int(rng.integers(3, N // 2)),
                                  replace=False)).astype(np.int32)
        rows = np.concatenate([real, np.full(int(rng.integers(0, 5)), N,
                                             np.int32)])
    F = int(rng.integers(1, 4))
    starts = {int(r): rng.integers(1, 40, int(rng.integers(1, 4)))
              for r in real}
    lists = []
    for li in range(n_lists):
        qpos = int(rng.choice([li + 1, li + 1, 0, 3, 257, -4]))
        span = int(rng.choice([1, 1, 2, 3, 300]))
        ents = []
        for r in real:
            if rng.random() < 0.3:
                continue
            # on a phrase start (a chained key), a neighbour, or anywhere
            for b in starts[int(r)]:
                if rng.random() < 0.7:
                    ents.append((r, int(rng.integers(0, F + 2)),
                                 int(b) + max(qpos, 0)))
            for _ in range(int(rng.integers(0, 3))):
                ents.append((r, int(rng.integers(0, F + 2)),
                             int(rng.integers(1, 50))))
        ents.sort()
        n = len(ents)
        row = np.array([e[0] for e in ents], np.int64)
        key = np.array([(e[1] << 24) | e[2] for e in ents], np.int64)
        term = rng.random() < 0.5
        if term:
            key |= (rng.random(n) < 0.15).astype(np.int64) << 23
        pad = int(rng.integers(0, 6))
        if term:     # another term's hits past the valid prefix
            row = np.concatenate([row, rng.integers(0, N, pad)])
            key = np.concatenate([key, rng.integers(0, 1 << 26, pad)])
        else:        # N-pads, as a positional node's anchors carry them
            row = np.concatenate([row, np.full(pad, N)])
            key = np.concatenate([key, np.zeros(pad, np.int64)])
        m = n + pad
        kind = rng.integers(0, 3)
        weight = (int(rng.choice([1, 2, 200, 300])) if kind == 0 else
                  torch.from_numpy(rng.integers(-3, 300, m).astype(np.int32))
                  if kind == 1 else
                  torch.from_numpy(rng.integers(1, 4, m).astype(np.int32)))
        ok = (torch.from_numpy(rng.random(m) < 0.8) if rng.random() < 0.5
              else None)
        gate = (torch.from_numpy(rng.random(len(rows)) < 0.7)
                if rng.random() < 0.4 else None)
        lists.append(HitList(
            torch.from_numpy(row.astype(np.int32)),
            torch.from_numpy(key.astype(np.int32)), n,
            HITMAN_KEY_MASK if term else -1, qpos, span, weight, ok, gate))
    big = rng.random() < 0.5   # field weights whose sum wraps int32
    fw = (rng.integers(-2**40, 2**40, F) if big
          else rng.integers(1, 100, F)).astype(np.int64)
    bm25 = torch.from_numpy(rng.integers(-2**31, 2**31, len(rows))
                            .astype(np.int32))
    return lists, torch.from_numpy(rows), bm25, fw, bool(rng.random() < 0.7)


LIST_CASES = [(seed, n_lists, dense) for seed in range(6)
              for n_lists in (2, 3, 5) for dense in (True, False)]


def _case_id(c):
    return f"s{c[0]}-{c[1]}lists-{'dense' if c[2] else 'sparse'}"


@pytest.mark.parametrize("case", LIST_CASES, ids=_case_id)
def test_walk_numpy_equals_plain(case):
    lists, rows, bm25, fw, wb = list_case(*case)
    got = eager_lists(lists, rows, bm25, fw, wb)
    want = walk_numpy(_np_lists(lists), rows.numpy(), bm25.numpy(), fw, wb)
    assert np.array_equal(got.numpy(), want)


def test_list_cases_reach_every_corner():
    """The random lists hold ties, linked runs at the 255 cap, fields >= F
    and weights that wrap int32."""
    ties = capped = high_field = wrapped = 0
    for case in LIST_CASES:
        lists, rows, bm25, fw, wb = list_case(*case)
        F = len(fw)
        for h in _np_lists(lists):
            k = h.key[:h.n] & h.key_mask
            ties += int(((h.row[1:h.n] == h.row[:h.n - 1])
                         & (k[1:] == k[:-1])).sum())
            high_field += int(((k >> 24) >= F).sum())
        wrapped += int(np.abs(fw).max() >= 2**31)
        walk = walk_numpy(_np_lists(lists), rows.numpy(), bm25.numpy(),
                          np.full(F, 1, np.int64), False)
        capped += int((walk >= 255).sum())
    assert ties and capped and high_field and wrapped


# --------------------------------------------------------------------------
# random programs: the eager hit stream against the walk's lists
# --------------------------------------------------------------------------
T = ("term",)
EXPRS = {
    "and": ("and", (T + (0,), T + (1,))),
    "or3": ("or", (T + (0,), T + (1,), T + (2,))),
    "phrase": ("phrase", (0, 1)),
    "proximity": ("proximity", (0, 1), 5),
    "proximity3": ("proximity", (0, 1, 2), 2),
    "gated_phrase": ("or", (("and", (T + (0,), ("phrase", (1, 2)))),
                            T + (3,))),
    "gated_proximity": ("or", (("and", (("proximity", (0, 1), 3),
                                        T + (2,))), T + (3,))),
    "maybe_bigram": ("maybe", T + (0,), ("bigram_phrase", (1, 2), 3)),
    "quorum": ("or", (("quorum", (0, 1, 2), 2), ("phrase", (3, 0)))),
    "andnot": ("andnot", ("and", (T + (0,), T + (1,))), T + (2,)),
}


def _program(seed: int, expr_name: str, dense: bool, limited: bool):
    """A program's state over random hit windows of 4 slots: -> (sig, rt,
    data, match, termmask, phrase_results, lim_hit_ok, slot_hb, to_idx,
    rows, size, N, F, bm25part, fw)."""
    rng = np.random.default_rng(seed)
    N = int(rng.integers(20, 50))
    F = int(rng.integers(1, 4))
    S = 4
    expr = EXPRS[expr_name]
    # each slot's hits: rows from a shared pool, keys chained by qpos
    qpos = np.arange(1, S + 1)
    hit_rows, hit_keys, starts, lens, hb = [], [], [], [], []
    off = 0
    pool = rng.choice(N, int(rng.integers(4, N)), replace=False)
    bases = {int(r): rng.integers(1, 30, 3) for r in pool}
    for s in range(S):
        ents = set()
        for r in pool:
            if rng.random() < 0.35:
                continue
            for b in bases[int(r)]:
                if rng.random() < 0.6:
                    ents.add((int(r), int(rng.integers(0, F + 2)),
                              int(b) + int(qpos[s])))
            if rng.random() < 0.5:
                ents.add((int(r), int(rng.integers(0, F + 2)),
                          int(rng.integers(1, 40))))
        ents = sorted(ents)
        n = len(ents)
        size_hb = n + int(rng.integers(0, 4))
        r_ = np.array([e[0] for e in ents], np.int64)
        k_ = np.array([(e[1] << 24) | e[2] for e in ents], np.int64)
        k_ |= (rng.random(n) < 0.1).astype(np.int64) << 23
        hit_rows.append(r_)
        hit_keys.append(k_)
        starts.append(off)
        lens.append(n)
        hb.append(max(size_hb, 1))
        off += n
    tail = max(hb) + 4       # windows run into the next slot's hits
    hit_rowid = np.concatenate(hit_rows + [rng.integers(0, N, tail)])
    hit_packed = np.concatenate(hit_keys + [rng.integers(0, 1 << 25, tail)])
    data = {"hit_rowid": torch.from_numpy(hit_rowid.astype(np.int32)),
            "hit_packed": torch.from_numpy(hit_packed.astype(np.int32))}
    fw = (rng.integers(-2**40, 2**40, F) if rng.random() < 0.4
          else rng.integers(1, 100, F)).astype(np.int64)
    rt = {"hit_starts": np.array(starts), "hit_lengths": np.array(lens),
          "qpos": qpos, "field_weights": fw}
    slot_hb = tuple(hb)
    if dense:
        size = N + 1
        rows = torch.arange(size, dtype=torch.int32)

        def to_idx(r):
            return r.to(torch.int64)
    else:
        valid = np.unique(np.concatenate(hit_rows)) if off else \
            np.zeros(0, np.int64)
        size = len(valid) + int(rng.integers(1, 4))
        rows = torch.from_numpy(np.concatenate(
            [valid, np.full(size - len(valid), N)]).astype(np.int32))

        def to_idx(r):
            return torch.searchsorted(rows, r).clamp(0, size - 1)

    def slot_hits(s):
        sz = slot_hb[s]
        st = int(rt["hit_starts"][s])
        hrow = data["hit_rowid"][st:st + sz]
        hpk = data["hit_packed"][st:st + sz] & HITMAN_KEY_MASK
        msk = torch.arange(sz) < int(rt["hit_lengths"][s])
        return torch.where(msk, hrow, N), torch.where(msk, hpk, 0), msk

    phrase_results = {}
    for node in search._collect_phrase_nodes(expr):
        parts = search._walk_parts(node)
        got = [slot_hits(s) for s in parts]
        a_row = torch.cat([g[0] for g in got])
        a_key = torch.cat([g[1] for g in got])
        ok = torch.cat([g[2] for g in got]) & torch.from_numpy(
            rng.random(a_row.shape[0]) < 0.7)
        a_w = (torch.from_numpy(rng.integers(1, 4, a_row.shape[0])
                                .astype(np.int32))
               if node[0] == "proximity" else None)
        m = torch.from_numpy(rng.random(size) < 0.6)
        phrase_results[node] = (m, m.to(torch.int32), a_row, a_key, ok, a_w)
    W = 1
    termmask = torch.from_numpy(rng.integers(0, 1 << 4, (size, W))
                                .astype(np.int32))
    match = _eval_expr(expr, termmask, phrase_results, size)
    rk_slots = ranker_term_slots(expr)
    lim_hit_ok = {}
    if limited:
        for s in rk_slots[:1]:
            lim_hit_ok[s] = torch.from_numpy(rng.random(slot_hb[s]) < 0.6)
    sig = SimpleNamespace(ranker="proximity_bm25" if rng.random() < 0.7
                          else "proximity", expr=expr, has_dupes=False,
                          slot_occs=(), scan_index="")
    bm25 = torch.from_numpy(rng.integers(-2**31, 2**31, size)
                            .astype(np.int32))
    return SimpleNamespace(
        sig=sig, rt=rt, data=data, match=match, termmask=termmask,
        phrase_results=phrase_results, lim_hit_ok=lim_hit_ok,
        slot_hb=slot_hb, to_idx=to_idx, rows=rows, size=size, N=N, F=F,
        S=S, bm25=bm25, fw=fw, slot_hits=slot_hits, rk_slots=rk_slots,
        rk_phrases=positive_phrase_nodes(expr))


def _program_lists(pg):
    slot_gate, node_gate = _ranker_gates(pg.sig, pg.match, pg.termmask,
                                         pg.phrase_results, pg.size)
    return _walk_lists(pg.data, pg.rt, pg.phrase_results, pg.lim_hit_ok,
                       pg.rk_slots, pg.rk_phrases, slot_gate, node_gate,
                       pg.slot_hb)


PROGRAM_CASES = [(seed, name, dense, limited)
                 for seed, name in enumerate(sorted(EXPRS) * 2)
                 for dense, limited in ((True, False), (False, True))]


def _program_id(c):
    return (f"s{c[0]}-{c[1]}-{'dense' if c[2] else 'sparse'}"
            f"{'-limited' if c[3] else ''}")


@pytest.mark.parametrize("case", PROGRAM_CASES, ids=_program_id)
def test_walk_equals_hit_stream(case):
    pg = _program(*case)
    assert takes_lcs_walk(pg.sig, pg.F)
    fw_t = torch.from_numpy(pg.fw)
    stream = _hit_stream(pg.sig, pg.rt, pg.match, pg.termmask,
                         pg.phrase_results, pg.lim_hit_ok, pg.rk_slots,
                         pg.rk_phrases, pg.slot_hits, pg.to_idx, pg.size,
                         pg.N)
    eager, _ = _rank_hit_stream(pg.sig, stream, pg.bm25, fw_t, pg.to_idx,
                                pg.size, pg.N, pg.F, pg.S)
    lists = _program_lists(pg)
    wb = pg.sig.ranker == "proximity_bm25"
    walked = eager_lists(lists, pg.rows, pg.bm25, pg.fw, wb)
    stated = walk_numpy(_np_lists(lists), pg.rows.numpy(), pg.bm25.numpy(),
                        pg.fw, wb)
    assert np.array_equal(walked.numpy(), eager.numpy())
    assert np.array_equal(stated, eager.numpy())


# --------------------------------------------------------------------------
# which plans take the kernel
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_index():
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.schema import Schema
    b = IndexBuilder(Schema(fields=["title", "body"]))
    words = "alpha beta gamma delta eps zeta".split()
    rng = np.random.default_rng(5)
    b.add_documents(dict(id=d, title=" ".join(rng.choice(words, 4)),
                         body=" ".join(rng.choice(words, 12)))
                    for d in range(1, 61))
    return SearchIndex(b.build(), device="cpu")


RULE = [
    # (match, ranker, takes the kernel)
    ("alpha beta", "proximity_bm25", True),
    ("alpha | beta", "proximity_bm25", True),
    ('"alpha beta"', "proximity_bm25", True),
    ('"alpha beta"~5', "proximity", True),
    ('(alpha | "beta gamma") -delta', "proximity_bm25", True),
    ("alpha NEAR/3 beta", "proximity_bm25", False),   # NEAR moves anchors
    ("alpha SENTENCE beta", "proximity_bm25", False),
    ("alpha alpha beta", "proximity_bm25", False),    # HANDLE_DUPES
    ("alpha beta", "wordcount", False),
    ("alpha beta", "matchany", False),
    ("alpha beta", "bm25", False),                    # no hit stream
    ("alpha", "proximity_bm25", False),               # ws_bm25 shortcut
]


@pytest.mark.parametrize("match,ranker,takes", RULE,
                         ids=[f"{m}-{r}" for m, r, _ in RULE])
def test_selection_rule(small_index, match, ranker, takes):
    from manticoresearch_tpu_torch.exec.searcher import SearchQuery
    cq = small_index.plan(SearchQuery(match=match, ranker=ranker))
    assert takes_lcs_walk(cq.sig, 2) is takes


def test_selection_rule_limits():
    sig = SimpleNamespace(ranker="proximity_bm25", has_dupes=False,
                          slot_occs=(), scan_index="",
                          expr=("or", tuple(T + (s,) for s in range(33))))
    assert not takes_lcs_walk(sig, 2)           # 33 lists
    sig.expr = ("or", tuple(T + (s,) for s in range(32)))
    assert takes_lcs_walk(sig, 64)
    assert not takes_lcs_walk(sig, 65)          # field weights past 64
    sig.scan_index = "year"                     # a filter window
    assert not takes_lcs_walk(sig, 2)
    sig.scan_index, sig.expr = "", ("all",)     # no list
    assert not takes_lcs_walk(sig, 2)


def test_cpu_tensors_keep_the_hit_stream(small_index, monkeypatch):
    """A plan that takes the kernel on the card runs the eager hit stream
    on CPU tensors: no kernel call, ``lcs_eager`` counted."""
    from manticoresearch_tpu_torch.exec.searcher import SearchQuery

    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper ran on CPU tensors")
    monkeypatch.setattr(search, "lcs_walk", refuse)
    search.WALK_LAUNCHES.reset()
    qs = [SearchQuery(match=m) for m in ("alpha beta", '"beta gamma"~3')]
    assert all(takes_lcs_walk(small_index.plan(q).sig, 2) for q in qs)
    res = small_index.search_batch(qs)
    assert all(r.error is None and r.matches for r in res)
    rec = trace.last(1)[0]
    assert rec.counters.get("lcs_eager") == 2
    assert "lcs_walk" not in rec.counters
    assert search.WALK_LAUNCHES.kernel == 0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA): the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("case", LIST_CASES, ids=_case_id)
def test_card_kernel_equals_plain_lists(card, case):
    lists, rows, bm25, fw, wb = list_case(*case)
    want = eager_lists(lists, rows, bm25, fw, wb)
    n0 = search.WALK_LAUNCHES.kernel
    got = lcs_walk(_to(lists, card), rows.to(card), bm25.to(card), fw, wb)
    torch.cuda.synchronize()
    assert search.WALK_LAUNCHES.kernel == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.card
@pytest.mark.parametrize("case", PROGRAM_CASES, ids=_program_id)
def test_card_kernel_equals_plain_programs(card, case):
    pg = _program(*case)
    lists = _program_lists(pg)
    wb = pg.sig.ranker == "proximity_bm25"
    stream = _hit_stream(pg.sig, pg.rt, pg.match, pg.termmask,
                         pg.phrase_results, pg.lim_hit_ok, pg.rk_slots,
                         pg.rk_phrases, pg.slot_hits, pg.to_idx, pg.size,
                         pg.N)
    want, _ = _rank_hit_stream(pg.sig, stream, pg.bm25,
                               torch.from_numpy(pg.fw), pg.to_idx, pg.size,
                               pg.N, pg.F, pg.S)
    got = lcs_walk(_to(lists, card), pg.rows.to(card), pg.bm25.to(card),
                   pg.fw, wb)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.card
def test_card_categories(card, monkeypatch):
    """Each category's lists bit-exact between the kernel and the eager
    ranker on the card, and the search results equal to the CPU's."""
    from manticoresearch_tpu_torch import bench_corpus
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    packed = bench_corpus.build_corpus(20_000, 2_000, 30, seed=3)
    queries = bench_corpus.lucene_categories(packed)
    gpu = SearchIndex(packed, device="cuda")
    cpu = SearchIndex(packed, device="cpu")
    kernel = search.lcs_walk
    checked = []

    def both(lists, rows, bm25part, fw, with_bm25):
        out = kernel(lists, rows, bm25part, fw, with_bm25)
        want = eager_lists(lists, rows, bm25part, fw, with_bm25)
        assert torch.equal(out, want)
        checked.append(len(lists))
        return out
    monkeypatch.setattr(search, "lcs_walk", both)
    for cat, q in queries.items():
        n0 = len(checked)
        got = gpu.search_batch([q])[0]
        want = cpu.search_batch([q])[0]
        assert got.error is None and want.error is None, cat
        assert len(checked) == n0 + 1, f"{cat}: the kernel did not run"
        assert got.total_found == want.total_found, cat
        assert ([(m.docid, m.weight) for m in got.matches]
                == [(m.docid, m.weight) for m in want.matches]), cat
        assert got.total_found > 0, cat


def test_lucene_categories():
    """The 12 categories' queries on a small built index all parse, take
    the walk's plans and find documents (on the CPU)."""
    from manticoresearch_tpu_torch import bench_corpus
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    packed = bench_corpus.build_corpus(4_000, 600, 20, seed=3)
    queries = bench_corpus.lucene_categories(packed)
    assert len(queries) == 12
    idx = SearchIndex(packed, device="cpu")
    for cat, q in queries.items():
        assert takes_lcs_walk(idx.plan(q).sig, 1), cat
        r = idx.search(q)
        assert r.error is None and r.total_found > 0, cat
