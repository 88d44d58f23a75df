"""The benchmark corpus and query generator of ``bench.py``, on the port.

``build_corpus``, ``build_corpus_shards`` and ``WorkloadGen`` are copies of
``bench.build_corpus``, ``bench.build_corpus_shards`` and
``bench.WorkloadGen`` that build with the port's own builder and make the
port's ``SearchQuery``: the same seed gives the same corpus, the same
shards and the same draws. ``positional_pairs`` draws term pairs that
stand near each other in a document, so that phrase and proximity queries
made of them find something.
"""
from __future__ import annotations

import numpy as np


def build_corpus(n_docs: int, vocab: int, avg_len: int, seed: int = 42):
    from .index.builder import build_from_pretokenized
    from .schema import AttrDef, AttrType, Schema

    rng = np.random.RandomState(seed)
    lens = rng.randint(avg_len // 2, avg_len * 2, n_docs)
    offsets = np.zeros(n_docs + 1, np.int64)
    offsets[1:] = np.cumsum(lens)
    z = rng.zipf(1.25, int(offsets[-1]))
    terms = np.minimum(z - 1, vocab - 1).astype(np.int64)
    schema = Schema(fields=["content"],
                    attrs=[AttrDef("year", AttrType.UINT),
                           AttrDef("group_id", AttrType.UINT)])
    width = max(4, len(str(vocab - 1)))
    packed = build_from_pretokenized(
        schema,
        doc_ids=np.arange(1, n_docs + 1, dtype=np.int64),
        doc_terms=terms,
        doc_offsets=offsets,
        attrs={"year": 2000 + (np.arange(n_docs) % 25),
               "group_id": np.arange(n_docs) % 100},
        vocab=[f"t{i:0{width}d}" for i in range(vocab)],
    )
    return packed


def build_corpus_shards(n_docs: int, vocab: int, avg_len: int,
                        n_shards: int, seed: int = 42):
    """The same synthetic corpus split into per-shard PackedIndexes
    (BASELINE config 5: distributed over local shards)."""
    from .index.builder import build_from_pretokenized
    from .schema import AttrDef, AttrType, Schema

    rng = np.random.RandomState(seed)
    lens = rng.randint(avg_len // 2, avg_len * 2, n_docs)
    offsets = np.zeros(n_docs + 1, np.int64)
    offsets[1:] = np.cumsum(lens)
    z = rng.zipf(1.25, int(offsets[-1]))
    terms = np.minimum(z - 1, vocab - 1).astype(np.int64)
    schema = Schema(fields=["content"],
                    attrs=[AttrDef("year", AttrType.UINT),
                           AttrDef("group_id", AttrType.UINT)])
    width = max(4, len(str(vocab - 1)))
    vocab_list = [f"t{i:0{width}d}" for i in range(vocab)]
    year = 2000 + (np.arange(n_docs) % 25)
    gid = np.arange(n_docs) % 100
    shards = []
    per = (n_docs + n_shards - 1) // n_shards
    for si in range(n_shards):
        lo, hi = si * per, min((si + 1) * per, n_docs)
        if lo >= hi:
            break
        o = offsets[lo:hi + 1] - offsets[lo]
        shards.append(build_from_pretokenized(
            schema,
            doc_ids=np.arange(lo + 1, hi + 1, dtype=np.int64),
            doc_terms=terms[offsets[lo]:offsets[hi]],
            doc_offsets=o,
            attrs={"year": year[lo:hi], "group_id": gid[lo:hi]},
            vocab=vocab_list,
        ))
    return shards


def positional_pairs(packed, rng, n: int, max_gap: int,
                     max_df: int | None = None) -> list[tuple]:
    """n pairs (term_a, term_b) of distinct terms whose hits stand 1 to
    ``max_gap`` positions apart, a before b, in one field of a random
    document, read from the index's own posting and hit arrays: a phrase
    ``"a b"`` (max_gap 1) or a proximity ``"a b"~k`` (max_gap <= k) made of
    such a pair matches at least that document. ``max_df`` keeps to terms
    of at most that many documents (the hits of other terms are skipped,
    so "apart" still counts every position)."""
    key_mask = ~(1 << 23)
    out = []
    while len(out) < n:
        rows = rng.choice(packed.n_docs, n, replace=False)
        sel = np.flatnonzero(np.isin(packed.post_rowid, rows))
        terms = np.searchsorted(packed.term_offsets, sel, side="right") - 1
        for r in rows:
            here = packed.post_rowid[sel] == r
            keys, tids = [], []
            for p, t in zip(sel[here], terms[here]):
                h0, h1 = packed.post_hit_offset[p], packed.post_hit_offset[p + 1]
                k = packed.hit_packed[h0:h1] & key_mask
                keys.append(k)
                tids.append(np.full(len(k), t))
            if not keys:
                continue
            keys, tids = np.concatenate(keys), np.concatenate(tids)
            if max_df is not None:
                keep = packed.term_docs[tids] <= max_df
                keys, tids = keys[keep], tids[keep]
                if not len(keys):
                    continue
            order = np.argsort(keys, kind="stable")
            keys, tids = keys[order], tids[order]
            i = int(rng.randint(len(keys)))
            ok = ((keys > keys[i]) & (keys - keys[i] <= max_gap)
                  & (keys >> 24 == keys[i] >> 24) & (tids != tids[i]))
            if ok.any():
                j = int(rng.choice(np.flatnonzero(ok)))
                out.append((packed.term_strs[tids[i]],
                            packed.term_strs[tids[j]]))
                if len(out) == n:
                    break
    return out


class WorkloadGen:
    """Query generators per BASELINE config.

    Every draw returns a (warmup_term, measured_term) TWIN: two distinct
    terms from the same (posting-bucket, hit-bucket) class, so warmup
    batches compile exactly the plan shapes the measured batches use
    while never repeating an input (a serving daemon compiles each shape
    once)."""

    def __init__(self, rng, vocab: int, packed, lo=3, hi=2000):
        self.rng = rng
        self.vocab = vocab
        self.width = max(4, len(str(vocab - 1)))
        # class map over the sampling band: (pb, hb) -> term ids
        def p2(x):
            n = 1024
            while n < x:
                n <<= 1
            return n
        self.band = []
        classes: dict = {}
        td = packed.term_docs
        th = packed.term_hits if hasattr(packed, "term_hits") else None
        # the packed-store width classes are part of the plan shape too
        # (sig.slot_packed): twins must share them or warmup misses
        store = packed.packed_store()
        for t in range(lo, min(hi, vocab)):
            df = int(td[t]) if t < len(td) else 0
            hits = int(th[t]) if th is not None and t < len(th) else df
            pk = tuple(store.term_class[t]) if t < len(store.term_class) \
                else (0, 0, 0)
            classes.setdefault((p2(df), p2(hits), pk), []).append(t)
        # keep classes with >= 2 members so twins differ; cap the class
        # count (top by population) — every distinct class is a distinct
        # compiled plan shape, and the matrix of shapes (esp. two-term
        # configs) otherwise turns warmup into a compile storm
        pool = sorted((v for v in classes.values() if len(v) >= 2),
                      key=len, reverse=True)[:4]
        self.classes = pool
        if not self.classes:
            self.classes = [list(range(lo, min(hi, vocab)))]

    def _fmt(self, t):
        return f"t{t:0{self.width}d}"

    def term(self, avoid_class: int = -1):
        """-> (warm_term_str, measured_term_str, class_id): twins from one
        shape class (avoid_class forces a different class so two-term
        queries never collapse a slot in one batch arm only)."""
        while True:
            ci = int(self.rng.randint(len(self.classes)))
            if ci != avoid_class or len(self.classes) == 1:
                break
        cls = self.classes[ci]
        i, j = self.rng.choice(len(cls), 2, replace=False) \
            if len(cls) >= 2 else (0, 0)
        return self._fmt(cls[i]), self._fmt(cls[j]), ci

    def config1(self, n):
        """single-term MATCH() BM25 top-10."""
        from .exec.searcher import SearchQuery
        pairs = [self.term() for _ in range(n)]
        return ([SearchQuery(match=w, limit=10) for w, _m, _c in pairs],
                [SearchQuery(match=m, limit=10) for _w, m, _c in pairs])

    def config2(self, n):
        """boolean AND/OR + integer range filters (mixed)."""
        from .exec.searcher import SearchQuery
        from .query.planner import AttrFilterDef
        warm, meas = [], []
        for _ in range(n):
            r = self.rng.rand()
            w1, m1, c1 = self.term()
            w2, m2, _c2 = self.term(avoid_class=c1)
            if r < 0.4:
                warm.append(SearchQuery(match=w1, limit=10))
                meas.append(SearchQuery(match=m1, limit=10))
            elif r < 0.7:
                warm.append(SearchQuery(match=f"{w1} {w2}", limit=10))
                meas.append(SearchQuery(match=f"{m1} {m2}", limit=10))
            elif r < 0.9:
                warm.append(SearchQuery(match=f"{w1} | {w2}", limit=10))
                meas.append(SearchQuery(match=f"{m1} | {m2}", limit=10))
            else:
                filt = [AttrFilterDef("year", "range_i", lo=2005, hi=2018)]
                warm.append(SearchQuery(match=f"{w1} {w2}", filters=filt,
                                        limit=10))
                meas.append(SearchQuery(match=f"{m1} {m2}", filters=filt,
                                        limit=10))
        return warm, meas

    def config3(self, n):
        """phrase / proximity + per-field weights (positional path)."""
        from .exec.searcher import SearchQuery
        warm, meas = [], []
        fwt = {"content": 3}
        for _ in range(n):
            w1, m1, c1 = self.term()
            w2, m2, _c2 = self.term(avoid_class=c1)
            if self.rng.rand() < 0.5:
                warm.append(SearchQuery(match=f'"{w1} {w2}"', limit=10,
                                        field_weights=fwt))
                meas.append(SearchQuery(match=f'"{m1} {m2}"', limit=10,
                                        field_weights=fwt))
            else:
                warm.append(SearchQuery(match=f'"{w1} {w2}"~5', limit=10,
                                        field_weights=fwt))
                meas.append(SearchQuery(match=f'"{m1} {m2}"~5', limit=10,
                                        field_weights=fwt))
        return warm, meas

    def config4(self, n):
        """faceted: GROUP BY + aggregate + ORDER BY count."""
        from .exec.searcher import SearchQuery

        def mk(t):
            return SearchQuery(match=t, group_by="group_id",
                               select=["count(*)", "sum(year)"],
                               sort=[("@count", False)], limit=10)
        pairs = [self.term() for _ in range(n)]
        return ([mk(w) for w, _m, _c in pairs],
                [mk(m) for _w, m, _c in pairs])
