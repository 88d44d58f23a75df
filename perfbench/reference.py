"""Plain reference for the query log: proximity_bm25 over the token arrays.

It reads only the benchmark's own ``Corpus`` (never the port's index) and
answers each query of ``generators/querylog.py`` with its top documents by
weight, their weights and the number of documents it matches. Written
from the ranking's definition (Sphinx's sphinxsearch.cpp, which the port
follows), for one full-text field of weight 1:

- idf of a term of df documents among N, for a query of ``n`` distinct
  words: ``log((N - df + 1) / df) / (2 log(N + 1)) / n``, in double,
  rounded once to float32;
- a term's part in a document, with its tf there (every occurrence, also
  for the members of a phrase): ``tf / (tf + 1.2) * idf``, each step one
  float32 operation; a document sums the parts of the query's terms that
  it holds, in query order, starting from 0;
- ``bm25 = trunc((sum + 0.5) * 1000)``;
- ``lcs``: the longest chain of the ranker's hit stream (the proximity
  FSM): hits in position order, each with (position, query position,
  weight, span); a hit extends the chain of the one before it where its
  ``position - query position`` equals the previous one's plus that
  one's span less 1, and the chain then sums their weights; a term hit
  has weight 1 and span 1, an exact phrase's hit weight and span 2 at the
  phrase's start, and a proximity node's hit, at each hit of its members
  that ends a window holding both, span 2 and weight 2 where the latest
  hits of its members there stand next to each other in query order, else
  1;
- ``weight = bm25 + 1000 * lcs``; the order is weight descending, then
  document id ascending; ``found`` counts every matching document.

``dtype`` is the precision of the float steps: float32 as the
configuration states, bfloat16 for the control, which has to fail the
comparison.
"""
from __future__ import annotations

import math

import numpy as np
import torch

K1 = 1.2
SCALE = 1000


class Reference:
    def __init__(self, corpus, dtype=torch.float32):
        self.dtype = dtype
        self.tok = corpus.tokens
        self.offsets = corpus.offsets
        self.n = corpus.n_docs
        dev = self.tok.device
        self.device = dev
        lens = corpus.offsets[1:] - corpus.offsets[:-1]
        self.doc_of = torch.repeat_interleave(
            torch.arange(self.n, dtype=torch.int64, device=dev), lens)
        # every token's offset, grouped by term, ascending within a term
        self.occ = torch.sort(self.tok, stable=True).indices
        counts = torch.bincount(self.tok.to(torch.int64),
                                minlength=corpus.vocabulary)
        self.tstart = torch.zeros(corpus.vocabulary + 1, dtype=torch.int64)
        torch.cumsum(counts.cpu(), 0, out=self.tstart[1:])
        self.attrs = {k: torch.from_numpy(v).to(dev)
                      for k, v in corpus.attrs.items()}
        self._terms: dict = {}

    # -- per term ---------------------------------------------------------
    def term(self, t: int):
        """-> (occurrences: token offsets ascending, docs ascending, tf)."""
        got = self._terms.get(t)
        if got is None:
            occ = self.occ[int(self.tstart[t]):int(self.tstart[t + 1])]
            docs, tf = torch.unique_consecutive(self.doc_of[occ],
                                                return_counts=True)
            got = self._terms[t] = (occ, docs, tf)
        return got

    def idf(self, df: int, n_words: int) -> float:
        if df <= 0:
            return 0.0
        n = max(self.n, df)
        v = math.log((n - df + 1) / df) / (2.0 * math.log(1 + n))
        return float(np.float32(v / n_words))

    def _part(self, tf: torch.Tensor, idf: float) -> torch.Tensor:
        tfd = tf.to(self.dtype)
        return tfd / (tfd + K1) * idf

    def _adjacent_docs(self, a: int, b: int) -> torch.Tensor:
        """Documents holding a at some position p and b at p + 1."""
        occ_a = self.term(a)[0]
        nxt = occ_a + 1
        nxt = nxt[nxt < self.tok.shape[0]]
        here = occ_a[:nxt.shape[0]]
        ok = (self.tok[nxt] == b) & (self.doc_of[nxt] == self.doc_of[here])
        return self.doc_of[here[ok]]

    def _proximity(self, a: int, b: int, slop: int):
        """``"a b"~slop``: -> (matched bool [n], lcs int64 [n]); a window
        holds both where they stand at most ``slop`` positions apart."""
        occ = torch.sort(torch.cat([self.term(a)[0],
                                    self.term(b)[0]])).values
        doc = self.doc_of[occ]
        start = self.offsets[doc]
        far = slop + 1
        k_a = torch.full_like(occ, far)
        k_b = torch.full_like(occ, far)
        for k in range(far - 1, -1, -1):      # the latest hit wins
            p = occ - k
            inside = p >= start
            t = self.tok[p.clamp(min=0)]
            k_a = torch.where(inside & (t == a), k, k_a)
            k_b = torch.where(inside & (t == b), k, k_b)
        valid = (k_a < far) & (k_b < far)
        occ, doc = occ[valid], doc[valid]
        # member deltas (pos - query pos) equal: b's latest right after a's
        w = torch.where(k_b[valid] == k_a[valid] - 1, 2, 1)
        linked = torch.zeros_like(valid[valid])
        linked[1:] = (occ[1:] == occ[:-1] + 1) & (doc[1:] == doc[:-1])
        idx = torch.arange(occ.shape[0], device=occ.device)
        run_start = torch.cummax(torch.where(linked, 0, idx), 0).values
        cumw = torch.cumsum(w, 0)
        chain = (cumw - cumw[run_start] + w[run_start]).clamp(max=255)
        lcs = torch.zeros(self.n, dtype=torch.int64, device=occ.device)
        lcs.scatter_reduce_(0, doc, chain, "amax")
        return lcs > 0, lcs

    # -- per query --------------------------------------------------------
    def answer(self, q, limit: int = 10):
        """-> (docids, weights, found) of one query of the generator."""
        terms = list(q.terms)
        n_words = len(set(terms))
        dev = self.device
        tfidf = torch.zeros(self.n, dtype=self.dtype, device=dev)
        lcs = torch.zeros(self.n, dtype=torch.int64, device=dev)
        has = []
        for t in terms:
            _occ, docs, tf = self.term(t)
            part = self._part(tf, self.idf(docs.shape[0], n_words))
            tfidf[docs] = tfidf[docs] + part
            m = torch.zeros(self.n, dtype=torch.bool, device=dev)
            m[docs] = True
            has.append(m)
            lcs[docs] = 1
        if q.kind == "term":
            match = has[0]
        elif q.kind in ("and", "or"):
            match = (has[0] & has[1]) if q.kind == "and" else \
                (has[0] | has[1])
            lcs[self._adjacent_docs(*terms)] = 2
        elif q.kind == "phrase":
            match = torch.zeros(self.n, dtype=torch.bool, device=dev)
            match[self._adjacent_docs(*terms)] = True
            lcs = torch.where(match, 2, 0)
        elif q.kind == "proximity":
            match, lcs = self._proximity(*terms, q.slop)
        else:
            raise ValueError(f"unknown query kind {q.kind!r}")
        if q.filter is not None:
            attr, lo, hi = q.filter
            match = match & (self.attrs[attr] >= lo) & (self.attrs[attr] <= hi)
        rows = torch.nonzero(match).view(-1)
        bm25 = torch.trunc((tfidf[rows] + 0.5) * SCALE).to(torch.int64)
        weight = bm25 + SCALE * lcs[rows]
        # weight descending, then row (document id) ascending
        order = torch.sort(-weight, stable=True).indices[:limit]
        return ((rows[order] + 1).tolist(), weight[order].tolist(),
                int(rows.shape[0]))
