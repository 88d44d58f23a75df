"""The positional walk (``ops.search.pos_walk``, csrc/pos_walk.cu): a
program's phrase and proximity nodes, one thread per anchor entry, each
member's predecessor found by binary search in its sorted hit window.

``pos_walk_numpy`` states the kernel in NumPy, anchor by anchor. Its plain
version is the eager ``_eval_phrase_node``. The CPU tests hold the
statement equal to the eager node on random sorted windows (bucket pads
past the valid length that run into other slots' hits, phrases with gapped
deltas, repeated member slots, proximity with slop 0-10, empty and
one-entry windows; dense, sparse and filter-first positions): ``match``,
``tf`` and ``ok`` equal, ``a_w`` equal wherever ``ok`` holds. ``a_w`` is
read nowhere else: the eager hit stream emits ``where(ok, a_w, 0)`` and
the LCS walk skips an entry whose ``ok`` is off, so neither the kernel
nor the statement defines it there. They also check which nodes take the
kernel, that CPU tensors keep the eager node, and that every consumer of
``phrase_results`` reads the walk's entries (anchors left None) as it
reads the eager node's.

The tests marked ``card`` run the kernel on an NVIDIA card: bit-exact
against the eager node on the CPU on the same random cases, several nodes
in one launch, and whole programs of the 12 non-term categories of the
``lucene_tasks`` mix at 1M and 125k documents, against the same programs
with the walk refused. This file imports no JAX; run them on a host
without it, where ``tests/conftest.py`` (which imports JAX) cannot load,
with ``python -m pytest tests/test_torch_pos_walk.py -m card
--noconftest``.
"""
from __future__ import annotations

from bisect import bisect_right
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from manticoresearch_tpu_torch.ops import search
from manticoresearch_tpu_torch.ops.search import (HITMAN_KEY_MASK,
                                                  _eval_expr,
                                                  _member_deltas,
                                                  _eval_phrase_node,
                                                  _hit_stream,
                                                  _rank_hit_stream,
                                                  _ranker_gates, _walk_lists,
                                                  pos_walk, pos_walk_table,
                                                  takes_pos_walk)
from manticoresearch_tpu_torch.query.plan import (positive_phrase_nodes,
                                                  ranker_term_slots)
from manticoresearch_tpu_torch.utils import trace
from tests.test_torch_lcs_walk import eager_lists


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 2**32 if v >= 2**31 else v


def pos_walk_numpy(node, hit_rowid, hit_packed, starts, lengths, slot_hb,
                   rows, size: int):
    """One node, anchor by anchor, as the kernel runs it: -> (match bool,
    tf int32, ok bool, a_w int32 (0 where not ok) or None). ``rows`` is
    None (dense) or the positions' rows, ascending."""
    slots = node[1]
    prox = node[0] == "proximity"
    deltas = _member_deltas(node)
    win = _i32(deltas[-1] + node[2]) if prox else 0

    def member(s):
        st, hb = int(starts[s]), slot_hb[s]
        n = min(int(lengths[s]), hb)
        return [(int(r), _i32(int(k) & HITMAN_KEY_MASK)) for r, k in
                zip(hit_rowid[st:st + n], hit_packed[st:st + n])], hb
    mem = [member(s) for s in slots]
    tf = np.zeros(size, np.int32)
    ok_l, aw_l = [], []
    for ents, hb in (mem if prox else mem[:1]):
        for i in range(hb):
            ok, d = i < len(ents), []
            if ok:
                r, k = ents[i]
                for qi, (b, _) in enumerate(mem):
                    if not prox and qi == 0:
                        continue
                    tgt = k if prox else _i32(k + deltas[qi])
                    j = bisect_right(b, (r, tgt)) - 1
                    ok = j >= 0 and b[j][0] == r
                    if ok and prox:
                        ok = _i32(k - b[j][1]) < win
                        d.append(_i32(b[j][1] - deltas[qi]))
                    elif ok:
                        ok = b[j][1] == tgt
                    if not ok:
                        break
            ok_l.append(ok)
            aw_l.append(max(sum(d.count(x) >= 2 for x in d), 1)
                        if ok and prox else 0)
            if ok:
                p = r if rows is None else min(
                    int(np.searchsorted(rows, r, "left")), size - 1)
                tf[p] += 1
    return (tf > 0, tf, np.array(ok_l, bool),
            np.array(aw_l, np.int32) if prox else None)


# --------------------------------------------------------------------------
# random windows
# --------------------------------------------------------------------------
SPACES = ("dense", "sparse", "filter")
SHAPES = ("random", "repeat", "empty", "one")


def window_case(seed: int, kind: str, m: int, space: str, shape: str):
    """A node of ``kind`` over m members and one extra term slot, each
    slot's hits a sorted window with a bucket pad that runs into the next
    slot's hits: -> namespace of the node, the hit arrays (CPU tensors),
    ``rt`` (hit_starts, hit_lengths, qpos, field_weights), ``slot_hb``,
    the positions (``rows`` None when dense), ``to_idx`` and
    ``slot_hits`` as ``build_match_core`` makes them."""
    rng = np.random.default_rng([seed, m, SPACES.index(space),
                                 SHAPES.index(shape), kind == "phrase"])
    N = int(rng.integers(30, 80))
    F = int(rng.integers(1, 4))
    qd = [0] + list(np.cumsum(rng.integers(1, 4, m - 1)).tolist())
    if kind == "phrase":
        node = (("phrase", None, tuple(qd)) if rng.random() < 0.7
                else ("phrase", None))
        qd = list(_member_deltas(node[:1] + (tuple(range(m)),) + node[2:]))
    else:
        slop = int(rng.integers(0, 11))
        node = (("proximity", None, slop, tuple(qd)) if rng.random() < 0.6
                else ("proximity", None, slop, ()) if rng.random() < 0.5
                else ("proximity", None, slop))
        qd = list(_member_deltas(node[:1] + (tuple(range(m)),) + node[2:]))
    members = list(range(m))
    if shape == "repeat" and m >= 2:
        members[-1] = members[0]
    S = max(members) + 2             # the extra slot is the last
    pool = rng.choice(N, int(rng.integers(N // 3, N)), replace=False)
    starts_of = {int(r): [(int(rng.integers(0, F + 1)),
                           int(rng.integers(1, 60)))
                          for _ in range(int(rng.integers(1, 4)))]
                 for r in pool}
    ents_of = []
    for s in range(S):
        ents = []
        qis = [qi for qi, ms in enumerate(members) if ms == s]
        for r in pool:
            if rng.random() < 0.25:
                continue
            for f, p in starts_of[int(r)]:
                for qi in qis:          # on a phrase start, or near one
                    if rng.random() < 0.75:
                        ents.append((int(r), f, p + qd[qi]))
                    if rng.random() < 0.3:
                        ents.append((int(r), f, p + qd[qi]
                                     + int(rng.integers(-6, 7))))
            for _ in range(int(rng.integers(0, 3))):
                ents.append((int(r), int(rng.integers(0, F + 1)),
                             int(rng.integers(1, 80))))
        ents = sorted(e for e in ents if e[2] >= 0)
        if ents and rng.random() < 0.3:   # an equal (row, key) twice
            j = int(rng.integers(0, len(ents)))
            ents.insert(j, ents[j])
        ents_of.append(ents)
    if shape == "empty":
        ents_of[members[int(rng.integers(0, m))]] = []
    elif shape == "one":
        s = members[int(rng.integers(0, m))]
        ents_of[s] = ents_of[s][:1] or [(int(pool[0]), 0, 5)]
    rows_l, keys_l, starts, lens, hb = [], [], [], [], []
    off = 0
    for ents in ents_of:
        n = len(ents)
        key = np.array([(f << 24) | p for _, f, p in ents], np.int64)
        key |= (rng.random(n) < 0.1).astype(np.int64) << 23   # end flag
        rows_l.append(np.array([e[0] for e in ents], np.int64))
        keys_l.append(key)
        starts.append(off)
        lens.append(n)
        hb.append(n + int(rng.integers(0, 3 * n + 2)))   # bucket: up to 4n
        off += n
    tail = max(hb) + 4                # windows run past the last slot's
    hit_rowid = np.concatenate(rows_l + [rng.integers(0, N + 1, tail)])
    hit_packed = np.concatenate(keys_l + [rng.integers(0, 1 << 26, tail)])
    data = {"hit_rowid": torch.from_numpy(hit_rowid.astype(np.int32)),
            "hit_packed": torch.from_numpy(hit_packed.astype(np.int32))}
    rt = {"hit_starts": np.array(starts), "hit_lengths": np.array(lens),
          "qpos": np.arange(1, S + 1),
          "field_weights": rng.integers(1, 100, F).astype(np.int64)}
    slot_hb = tuple(hb)
    if space == "dense":
        size, rows = N + 1, None

        def to_idx(r):
            return r.to(torch.int64)
    else:
        real = np.unique(np.concatenate(rows_l))
        if space == "filter":      # candidates: any rows, not only hits
            real = np.sort(rng.choice(N, int(rng.integers(1, N)),
                                      replace=False))
        rv = np.concatenate([real, np.full(int(rng.integers(1, 4)), N)])
        rows = torch.from_numpy(rv.astype(np.int32))
        size = len(rv)

        def to_idx(r):
            return torch.searchsorted(rows, r).clamp(0, size - 1)

    def slot_hits(s):
        sz = slot_hb[s]
        st = int(rt["hit_starts"][s])
        hrow = data["hit_rowid"][st:st + sz]
        hpk = data["hit_packed"][st:st + sz] & HITMAN_KEY_MASK
        msk = torch.arange(sz) < int(rt["hit_lengths"][s])
        return torch.where(msk, hrow, N), torch.where(msk, hpk, 0), msk

    node = (node[0], tuple(members)) + node[2:]
    return SimpleNamespace(node=node, data=data, rt=rt, slot_hb=slot_hb,
                           rows=rows, size=size, N=N, F=F, S=S,
                           to_idx=to_idx, slot_hits=slot_hits)


def eager(c, node=None):
    return _eval_phrase_node(node or c.node, c.slot_hits, c.data, c.N,
                             c.size, c.to_idx, 0)


def stated(c, node=None):
    return pos_walk_numpy(node or c.node, c.data["hit_rowid"].numpy(),
                          c.data["hit_packed"].numpy(), c.rt["hit_starts"],
                          c.rt["hit_lengths"], c.slot_hb,
                          None if c.rows is None else c.rows.numpy(), c.size)


def assert_same(got, want, what: str):
    """(match, tf, ok, a_w) against the eager node's six fields: a_w
    compared where ok holds."""
    m, tf, ok, a_w = (np.asarray(v.cpu() if isinstance(v, torch.Tensor)
                                 else v) if v is not None else None
                      for v in got)
    em, etf, _, _, eok, eaw = want
    assert np.array_equal(m, em.numpy()), f"{what}: match"
    assert np.array_equal(tf, etf.numpy()), f"{what}: tf"
    assert np.array_equal(ok, eok.numpy()), f"{what}: ok"
    assert (a_w is None) == (eaw is None), f"{what}: a_w"
    if a_w is not None:
        sel = eok.numpy()
        assert np.array_equal(a_w[sel], eaw.numpy()[sel]), f"{what}: a_w"


CASES = ([(seed, kind, m, space, shape)
          for seed, (kind, m, space, shape) in enumerate(
              (k, m, sp, sh) for k in ("phrase", "proximity")
              for m in (2, 3, 4, 5) for sp in SPACES for sh in SHAPES)]
         + [(100 + i, kind, 1, space, "random")
            for i, (kind, space) in enumerate(
                (k, sp) for k in ("phrase", "proximity") for sp in SPACES)])


def _case_id(c):
    return f"s{c[0]}-{c[1]}{c[2]}-{c[3]}-{c[4]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_numpy_equals_eager_node(case):
    c = window_case(*case)
    assert_same(stated(c), eager(c), _case_id(case))


def test_cases_reach_every_corner():
    """The random cases hold anchors that match and that do not, bucket
    pads, empty and one-entry windows, repeated members, tf above 1 at a
    position, and filter-first anchors whose row is no candidate."""
    ok = miss = pads = empty = one = many = off_cand = 0
    for case in CASES:
        c = window_case(*case)
        _, tf, okv, _ = stated(c)
        ok += int(okv.sum())
        miss += int((~okv).sum())
        many += int((tf > 1).sum())
        lens = c.rt["hit_lengths"][list(c.node[1])]
        pads += int(sum(c.slot_hb[s] > n for s, n in zip(c.node[1], lens)))
        empty += int((lens == 0).any())
        one += int((lens == 1).any())
        if case[3] == "filter":
            _, _, a_row, _, eok, _ = eager(c)
            rows = set(c.rows.tolist())
            off_cand += sum(int(r) not in rows
                            for r in a_row[eok].tolist())
    assert ok and miss and pads and empty and one and many and off_cand


# --------------------------------------------------------------------------
# which nodes take the kernel
# --------------------------------------------------------------------------
NODE_RULE = [
    # (node, fields, takes the kernel)
    (("phrase", (0, 1)), 1, True),
    (("phrase", (0, 1, 0), (0, 2, 5)), 1, True),       # repeated member
    (("phrase", tuple(range(8))), 4, True),
    (("phrase", tuple(range(9))), 4, False),           # past kMaxMembers
    (("proximity", (0, 1), 5), 1, True),
    (("proximity", (0, 1, 2), 0, (0, 1, 3)), 2, True),
    (("proximity", tuple(range(9)), 3), 1, False),
    (("phrase", (0, 1)), 128, True),
    (("phrase", (0, 1)), 129, False),                  # negative keys
    (("proximity", (0, 1), 5), 129, False),
    (("near", (0, 1), 3, False), 1, False),            # moves anchor keys
    (("near", (0, 1), 3, False, ("slot", (0,), 1), ("slot", (1,), 1)), 1,
     False),                                           # general NEAR
    (("sentence", (0, 1)), 1, False),
    (("paragraph", (0, 1)), 1, False),
    (("bigram_phrase", (0, 1), 2), 1, False),
]


@pytest.mark.parametrize("node,fields,takes", NODE_RULE,
                         ids=[f"{n[0]}{len(n[1])}-f{f}"
                              for n, f, _ in NODE_RULE])
def test_takes_pos_walk(node, fields, takes):
    assert takes_pos_walk(node, fields) is takes


def test_pos_walk_table_layout():
    """The plan-level half: nodes laid out one after the other, each on a
    block boundary; a phrase's anchors are its first member's window, a
    proximity node's all of its members' windows; a_w only for proximity
    nodes; deltas and the window as the eager node reads them."""
    hb = (300, 5, 0, 1000)
    nodes = [("phrase", (0, 1), (0, 3)), ("proximity", (1, 3, 2), 4),
             ("phrase", (2, 0)), ("proximity", (3, 0), 0, (0, 2))]
    t = pos_walk_table(nodes, hb, 77)
    assert t.parts == ((0, -1, 300), (300, 0, 1005), (1305, -1, 0),
                       (1305, 1005, 1300))
    assert (t.n_ok, t.n_aw, t.size) == (2605, 2305, 77)
    a = search._PosArgs.from_buffer_copy(t.args)
    assert (a.n_nodes, a.size, a.n_blocks) == (4, 77, 2 + 4 + 0 + 6)
    got = [(nd.first_block, nd.n_anchors, nd.n_members, nd.proximity,
            nd.win, [(mb.hb, mb.delta) for mb in nd.m[:nd.n_members]])
           for nd in a.nodes[:4]]
    assert got == [(0, 300, 2, 0, 0, [(300, 0), (5, 3)]),
                   (2, 1005, 3, 1, 6, [(5, 0), (1000, 1), (0, 2)]),
                   (6, 0, 2, 0, 0, [(0, 0), (300, 1)]),
                   (6, 1300, 2, 1, 2, [(1000, 0), (300, 2)])]
    with pytest.raises(ValueError):
        pos_walk_table(nodes * 3, hb, 77)


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: on CPU tensors it raises
    before it loads or launches anything."""
    c = window_case(0, "phrase", 2, "dense", "random")
    with pytest.raises(ValueError, match="CUDA"):
        pos_walk(pos_walk_table([c.node], c.slot_hb, c.size),
                 c.data["hit_rowid"], c.data["hit_packed"],
                 c.rt["hit_starts"], c.rt["hit_lengths"], None)


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


def test_cpu_tensors_keep_the_eager_node(small_index, monkeypatch):
    """Nodes that take the kernel on the card run the eager node on CPU
    tensors, under every ranker: no kernel call, ``pos_eager`` counted
    once per positional node, ``pos_walk`` never."""
    from manticoresearch_tpu_torch.exec.searcher import SearchQuery

    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper ran on CPU tensors")
    monkeypatch.setattr(search, "pos_walk", refuse)
    search.POS_WALK_LAUNCHES.reset()
    qs = [SearchQuery(match=m, ranker=r)
          for m in ('"beta gamma"', '"alpha beta"~3 | "gamma delta"')
          for r in ("proximity_bm25", "bm25", "wordcount", "none")]
    for q in qs:
        sig = small_index.plan(q).sig
        assert all(takes_pos_walk(nd, 2)
                   for nd in search._collect_phrase_nodes(sig.expr))
    res = small_index.search_batch(qs)
    assert all(r.error is None and r.matches for r in res)
    rec = trace.last(1)[0]
    assert rec.counters.get("pos_eager") == 4 * (1 + 2)
    assert "pos_walk" not in rec.counters
    assert search.POS_WALK_LAUNCHES.kernel == 0


# --------------------------------------------------------------------------
# every consumer of phrase_results reads the walk's entries
# --------------------------------------------------------------------------
LAYOUT_EXPRS = ("alone", "and", "or", "maybe")
LAYOUT_CASES = [(seed, kind, space, shape)
                for seed, (kind, space, shape) in enumerate(
                    (k, sp, sh) for k in ("phrase", "proximity")
                    for sp in SPACES for sh in LAYOUT_EXPRS)]


@pytest.mark.parametrize("case", LAYOUT_CASES,
                         ids=[f"s{c[0]}-{c[1]}-{c[2]}-{c[3]}"
                              for c in LAYOUT_CASES])
def test_phrase_results_layout(case):
    """The eager node's entry and the walk's (its anchors None, its
    outputs the statement's) give the same boolean tree, gates, LCS walk
    lists and eager hit stream ranks."""
    seed, kind, space, shape = case
    c = window_case(seed, kind, 3, space, "random")
    node, x = c.node, c.S - 1
    T = ("term", x)
    expr = {"alone": node, "and": ("and", (T, node)),
            "or": ("or", (node, T)), "maybe": ("maybe", T, node)}[shape]
    e = eager(c)
    m, tf, ok, a_w = stated(c)
    walked = (torch.from_numpy(m), torch.from_numpy(tf), None, None,
              torch.from_numpy(ok),
              None if a_w is None else torch.from_numpy(a_w))
    rng = np.random.default_rng(seed)
    termmask = torch.from_numpy(rng.integers(0, 1 << c.S, (c.size, 1))
                                .astype(np.int32))
    fw_t = torch.from_numpy(c.rt["field_weights"])
    bm25 = torch.from_numpy(rng.integers(0, 2**20, c.size).astype(np.int32))
    rows = (c.rows if c.rows is not None
            else torch.arange(c.size, dtype=torch.int32))
    out = []
    for pr in ({node: e}, {node: walked}):
        match = _eval_expr(expr, termmask, pr, c.size)
        ranks = [match]
        for ranker in ("proximity_bm25", "wordcount", "matchany"):
            sig = SimpleNamespace(ranker=ranker, expr=expr, has_dupes=False,
                                  slot_occs=(), scan_index="")
            gates = _ranker_gates(sig, match, termmask, pr, c.size)
            stream = _hit_stream(sig, c.rt, match, termmask, pr, {},
                                 ranker_term_slots(expr),
                                 positive_phrase_nodes(expr), c.slot_hits,
                                 c.to_idx, c.size, c.N)
            ranks.append(_rank_hit_stream(sig, stream, bm25, fw_t, c.to_idx,
                                          c.size, c.N, c.F, c.S)[0])
            if ranker == "proximity_bm25":
                ranks.append(gates[1](node))
                lists = _walk_lists(c.data, c.rt, pr, {},
                                    ranker_term_slots(expr),
                                    positive_phrase_nodes(expr), *gates,
                                    c.slot_hb)
                ranks.append(eager_lists(lists, rows, bm25,
                                         c.rt["field_weights"], True))
        out.append(ranks)
    for a, b in zip(*out):
        assert (a is None and b is None) or torch.equal(a, b)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA): the kernel runs only there")
    return torch.device("cuda")


def walk_on(c, nodes, dev):
    return pos_walk(pos_walk_table(nodes, c.slot_hb, c.size),
                    c.data["hit_rowid"].to(dev), c.data["hit_packed"].to(dev),
                    c.rt["hit_starts"], c.rt["hit_lengths"],
                    None if c.rows is None else c.rows.to(dev))


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_card_kernel_equals_eager_node(card, case):
    c = window_case(*case)
    n0 = search.POS_WALK_LAUNCHES.kernel
    got = walk_on(c, [c.node], card)
    torch.cuda.synchronize()
    assert search.POS_WALK_LAUNCHES.kernel == n0 + 1
    assert_same(got[0], eager(c), _case_id(case))


@pytest.mark.card
@pytest.mark.parametrize("space", SPACES)
def test_card_nodes_in_one_launch(card, space):
    """Up to eight phrase and proximity nodes over one program's slots in
    one launch, each bit-exact against its eager node."""
    c = window_case(7, "phrase", 4, space, "repeat")
    s = c.node[1]
    nodes = [c.node, ("proximity", s, 4), ("phrase", s[::-1]),
             ("proximity", s[:2], 0, (0, 3)), ("phrase", (s[1],)),
             ("phrase", s[1:3], (0, 2)), ("proximity", s[1:], 10),
             ("phrase", (c.S - 1, s[0]))]
    n0 = search.POS_WALK_LAUNCHES.kernel
    got = walk_on(c, nodes, card)
    torch.cuda.synchronize()
    assert search.POS_WALK_LAUNCHES.kernel == n0 + 1
    for node, g in zip(nodes, got):
        assert_same(g, eager(c, node), repr(node))


@pytest.fixture(scope="module", params=[1_000_000, 125_000],
                ids=["1M", "125k"])
def category_index(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA): the kernel runs only there")
    from manticoresearch_tpu_torch import bench_corpus
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    packed = bench_corpus.build_corpus(request.param, 50_000, 40, seed=3)
    queries = bench_corpus.lucene_categories(packed)
    yield SearchIndex(packed, device="cuda"), queries
    torch.cuda.empty_cache()


@pytest.mark.card
def test_card_categories(category_index, monkeypatch):
    """Each category's program on the card: the Phrase and SloppyPhrase
    ones with exactly one kernel call, its every node bit-exact against the
    eager node on the same card tensors; the results equal to the same
    program's with the walk refused; the other categories untouched."""
    gpu, queries = category_index
    kernel = search.pos_walk
    calls = []

    def record(table, *args):
        out = kernel(table, *args)
        calls.append((table, args, out))
        return out
    monkeypatch.setattr(search, "pos_walk", record)
    phrase_cats = [cat for cat in queries if cat.endswith("Phrase")]
    assert len(phrase_cats) == 6
    got = {}
    for cat, q in queries.items():
        n0 = len(calls)
        got[cat] = gpu.search_batch([q])[0]
        assert got[cat].error is None, cat
        assert len(calls) == n0 + (cat in phrase_cats), cat
    monkeypatch.setattr(search, "takes_pos_walk", lambda node, nf: False)
    nodes_eager = []
    real = search._eval_phrase_node

    def eager_node(node, *args):
        out = real(node, *args)
        nodes_eager.append((node, out))
        return out
    monkeypatch.setattr(search, "_eval_phrase_node", eager_node)
    for cat, q in queries.items():
        n0 = len(nodes_eager)
        want = gpu.search_batch([q])[0]
        assert want.error is None, cat
        assert got[cat].total_found == want.total_found, cat
        assert ([(m.docid, m.weight) for m in got[cat].matches]
                == [(m.docid, m.weight) for m in want.matches]), cat
        if cat in phrase_cats:
            table, _, out = calls[phrase_cats.index(cat)]
            assert len(nodes_eager) == n0 + len(table.nodes), cat
            for (node, g), (enode, e) in zip(zip(table.nodes, out),
                                             nodes_eager[n0:]):
                assert node == enode, cat
                assert_same(g, tuple(v.cpu() if v is not None else None
                                     for v in e), cat)
        assert got[cat].total_found > 0 or cat in phrase_cats, cat


def test_lucene_categories_take_the_walk():
    """The 6 Phrase and SloppyPhrase categories' queries on a small built
    index give one phrase or proximity node each that takes the kernel; the
    6 And and Or categories give none (on the CPU)."""
    from manticoresearch_tpu_torch import bench_corpus
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    packed = bench_corpus.build_corpus(4_000, 600, 20, seed=3)
    idx = SearchIndex(packed, device="cpu")
    for cat, q in bench_corpus.lucene_categories(packed).items():
        nodes = search._collect_phrase_nodes(idx.plan(q).sig.expr)
        want = (("proximity" if "Sloppy" in cat else "phrase",)
                if cat.endswith("Phrase") else ())
        assert tuple(nd[0] for nd in nodes) == want, cat
        assert all(takes_pos_walk(nd, 1) for nd in nodes), cat
