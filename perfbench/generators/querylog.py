"""The query-log generator: MATCH() queries by task category, as a traffic
file sets them out (``traffic/<mix>.json``).

A task category (Lucene's nightly benchmark names them: ``HighTerm``,
``AndHighMed``, ``LowSloppyPhrase``, ...) has a kind, the document-frequency
band of each of its words, and a whole-number ``count``: its share of the
queries is its count over the sum of the counts. Kinds: ``term`` (one
word), ``and`` (``a b``), ``or`` (``a | b``), ``phrase`` (``"a b"``, a and
b next to each other in some document) and ``proximity`` (the same kind of
pair as ``"a b"~slop``). A band is a range of Zipf ranks (term id + 1). A
share of the queries also carries the traffic's attribute range filter.

Categories and filters are dealt from shuffled decks that hold each item
as often as its count (``_deck``), not drawn one by one, so every stretch
of a stream holds nearly the same mix whatever the seed.

Texts do not repeat while a band has words left: each kind deals the
single words of a band from a shuffled deck of its own (dealt again once
it is empty), and a pair already used is drawn again. A table's plan cache
then hits only where a band holds fewer words than its category's queries
in a stream; ``repeated`` counts such queries.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..corpus import adjacent_pairs


@dataclass(frozen=True)
class Query:
    kind: str
    terms: tuple
    text: str
    filter: tuple | None = None   # (attribute, lo, hi), both ends in
    slop: int = 0
    category: str = ""


def _text(kind: str, words: list[str], slop: int) -> str:
    if kind == "term":
        return words[0]
    if kind == "and":
        return f"{words[0]} {words[1]}"
    if kind == "or":
        return f"{words[0]} | {words[1]}"
    if kind == "phrase":
        return f'"{words[0]} {words[1]}"'
    if kind == "proximity":
        return f'"{words[0]} {words[1]}"~{slop}'
    raise ValueError(f"unknown query kind {kind!r}")


def _deck(counts: list[int]) -> list[int]:
    """Indexes of ``counts``, each as often as its count."""
    return [i for i, c in enumerate(counts) for _ in range(int(c))]


def _share_deck(share: float) -> list[int]:
    """A deck of 0 (``share`` of the cards) and 1, at most 200 cards."""
    for n in range(1, 201):
        if abs(share * n - round(share * n)) < 1e-9:
            break
    return _deck([round(share * n), n - round(share * n)])


class _Deal:
    """Deals a deck's cards in a shuffled order, shuffled again once
    dealt out."""

    def __init__(self, rng, cards: list):
        self.rng, self.cards, self.left = rng, list(cards), []

    def __call__(self):
        if not self.left:
            self.left = [self.cards[i]
                         for i in self.rng.permutation(len(self.cards))]
        return self.left.pop()


class _Stream:
    def __init__(self, traffic: dict, corpus, seed: int, stream: int):
        self.corpus = corpus
        self.rng = np.random.default_rng([int(seed), stream])
        self.tgen = torch.Generator(device=corpus.tokens.device)
        self.tgen.manual_seed(int(self.rng.integers(2 ** 62)))
        self.bands = traffic["bands"]
        self.decks: dict = {}
        self.pairs: dict = {}
        self.seen: set = set()

    def word(self, kind: str, band: str) -> int:
        deck = self.decks.get((kind, band))
        if not deck:
            lo, hi = self.bands[band]
            deck = self.decks[kind, band] = list(
                self.rng.permutation(np.arange(lo - 1, hi)))
        return int(deck.pop())

    def adjacent(self, band: str) -> tuple[int, int]:
        """The next pair of the band, next to each other in some document,
        in the order in which draws of token positions first meet it."""
        lo, hi = self.bands[band]
        pool = self.pairs.setdefault(band, [])
        if not pool:
            pool += adjacent_pairs(self.corpus, self.tgen, 4096, lo, hi)[::-1]
        return pool.pop()

    def query(self, task: dict) -> Query:
        kind, bands = task["kind"], task["bands"]
        slop = int(task.get("slop", 0))
        for _ in range(1000):
            if kind == "term":
                terms = (self.word(kind, bands[0]),)
            elif kind in ("phrase", "proximity"):
                terms = self.adjacent(bands[0])
            else:
                terms = (self.word(kind, bands[0]),
                         self.word(kind, bands[1]))
                if terms[0] == terms[1]:
                    continue
            text = _text(kind, [self.corpus.term_text(t) for t in terms],
                         slop)
            if kind == "term" or text not in self.seen:
                self.seen.add(text)
                return Query(kind, terms, text, None, slop, task["category"])
        raise RuntimeError(f"no new text of {task['category']} in 1000 "
                           "draws: its bands hold too few words")


def generate(traffic: dict, corpus, seed: int, stream: int,
             n_queries: int) -> list[Query]:
    """``n_queries`` queries of the mix, from ``seed`` and ``stream`` (the
    measured stream and the warm-up's are apart)."""
    st = _Stream(traffic, corpus, seed, stream)
    tasks = traffic["tasks"]
    deal = _Deal(st.rng, _deck([t["count"] for t in tasks]))
    filt = traffic.get("filter")
    filtered = _Deal(st.rng, _share_deck(filt["share"]) if filt else [1])
    out = []
    for _ in range(n_queries):
        q = st.query(tasks[deal()])
        if filtered() == 0:
            q = Query(q.kind, q.terms, q.text,
                      (filt["attr"], *filt["range"]), q.slop, q.category)
        out.append(q)
    return out


def repeated(earlier: list[Query], queries: list[Query]) -> int:
    """The queries of ``queries`` whose text and filter came before, in
    ``earlier`` or in ``queries``: those a plan cache keyed on them could
    answer."""
    seen = {(q.text, q.filter) for q in earlier}
    n = 0
    for q in queries:
        key = (q.text, q.filter)
        n += key in seen
        seen.add(key)
    return n
