"""The query-log generator: the same seed gives the same stream, the task
categories' shares hold, pair texts do not repeat, single words repeat
only once their band's deck is dealt out, the filter's share holds, and
phrase pairs stand next to each other in the corpus."""
from __future__ import annotations

from collections import Counter

import pytest

from perfbench import spec
from perfbench.corpus import make_corpus
from perfbench.reference import Reference

from .conftest import PLAIN

SEED = 3 * 2 ** 31 + 5
N = 4000


@pytest.fixture(scope="module")
def drawn(base):
    cell = spec.cell(spec.load(base), PLAIN, base)
    corpus = make_corpus(cell.config, SEED, "cpu")
    gen = cell.generator()
    return cell, corpus, gen, gen.generate(cell.traffic, corpus, SEED, 0, N)


def test_same_seed_same_stream(drawn):
    cell, corpus, gen, qs = drawn
    assert gen.generate(cell.traffic, corpus, SEED, 0, N) == qs
    assert gen.generate(cell.traffic, corpus, SEED + 1, 0, N) != qs
    assert gen.generate(cell.traffic, corpus, SEED, 1, N) != qs


def test_mix_shares_hold(drawn):
    cell, _corpus, _gen, qs = drawn
    tasks = cell.traffic["tasks"]
    got = Counter(q.category for q in qs)
    assert set(got) == {t["category"] for t in tasks}
    total = sum(t["count"] for t in tasks)
    for task in tasks:
        share = got[task["category"]] / N
        assert abs(share - task["count"] / total) < 0.01, (task, share)
    filtered = sum(1 for q in qs if q.filter) / N
    assert abs(filtered - cell.traffic["filter"]["share"]) < 0.02


def test_words_from_their_bands(drawn):
    cell, _corpus, _gen, qs = drawn
    bands = cell.traffic["bands"]
    lo = min(b[0] for b in bands.values()) - 1
    hi = max(b[1] for b in bands.values()) - 1
    assert all(lo <= t <= hi for q in qs for t in q.terms)
    assert all(len(set(q.terms)) == len(q.terms) for q in qs)


def test_pair_texts_do_not_repeat(drawn):
    _cell, _corpus, _gen, qs = drawn
    pairs = [q.text for q in qs if q.kind != "term"]
    assert len(set(pairs)) == len(pairs)


def test_phrase_pairs_occur(drawn):
    _cell, corpus, _gen, qs = drawn
    ref = Reference(corpus)
    for q in [q for q in qs if q.kind == "phrase"][:40]:
        assert len(ref._adjacent_docs(*q.terms)) > 0, q


def test_single_words_repeat_only_when_dealt_out(drawn):
    """A category's single words come from its band's deck: no text comes
    twice before the band's every word has come once."""
    cell, _corpus, gen, qs = drawn
    bands = cell.traffic["bands"]
    for task in cell.traffic["tasks"]:
        if task["kind"] != "term":
            continue
        lo, hi = bands[task["bands"][0]]
        texts = [q.text for q in qs if q.category == task["category"]]
        first = texts[:hi - lo + 1]
        assert len(set(first)) == len(first), task
        assert len(texts) > len(first)      # the deck came round here


def test_repeated_counts_earlier_texts_and_filters(drawn):
    _cell, _corpus, gen, qs = drawn
    a, b = qs[0], qs[1]
    assert gen.repeated([], [a, b]) == 0
    assert gen.repeated([a], [a, b, b]) == 2
    other = gen.Query(a.kind, a.terms, a.text, ("year", 1, 2), a.slop)
    assert gen.repeated([a], [other]) == 0
