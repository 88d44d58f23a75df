"""The plain reference against the port on the CPU, on every query kind
of the mix: a plain table and a distributed table of 4 shards on 4 parts
and on 2; and the control, the reference in bfloat16, which the
comparison has to fail."""
from __future__ import annotations

import json
from collections import Counter

import pytest
import torch

from perfbench import control, spec
from perfbench.corpus import Corpus, build_inputs, make_corpus
from perfbench.reference import Reference
from perfbench.systems import schema_of, to_port

from .conftest import PLAIN

SEED = 2 ** 33 + 17
KINDS = ("term", "and", "or", "phrase", "proximity")


@pytest.fixture(scope="module")
def setting(base):
    bench = spec.load(base)
    cell = spec.cell(bench, PLAIN, base)
    traffic = dict(cell.traffic)
    traffic["filter"] = dict(traffic["filter"], share=0.3)
    corpus = make_corpus(cell.config, SEED, "cpu")
    queries = cell.generator().generate(traffic, corpus, SEED, 0, 160)
    return cell, corpus, queries


def _differ(queries, results, ref) -> Counter:
    bad = Counter()
    for q, r in zip(queries, results):
        got = ([m.docid for m in r.matches], [m.weight for m in r.matches],
               r.total_found)
        if got != ref.answer(q):
            bad[q.kind] += 1
    return bad


def test_every_kind_drawn(setting):
    _cell, _corpus, queries = setting
    assert set(Counter(q.kind for q in queries)) == set(KINDS)
    assert any(q.filter for q in queries)


def test_reference_equals_plain_table(setting):
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    from manticoresearch_tpu_torch.index.builder import build_from_pretokenized
    cell, corpus, queries = setting
    packed = build_from_pretokenized(schema_of(cell.config),
                                     **build_inputs(corpus, 0, corpus.n_docs))
    idx = SearchIndex(packed, device="cpu")
    results = idx.search_batch([to_port(q, 10) for q in queries])
    assert not _differ(queries, results, Reference(corpus))


@pytest.mark.parametrize("parts", [4, 2])
def test_reference_equals_four_shard_table(setting, parts):
    from manticoresearch_tpu_torch.index.builder import build_from_pretokenized
    from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
    cell, corpus, queries = setting
    n = corpus.n_docs
    shards = [build_from_pretokenized(
        schema_of(cell.config), **build_inputs(corpus, n * i // 4,
                                               n * (i + 1) // 4))
        for i in range(4)]
    idx = ShardedIndex(shards, devices=["cpu"] * parts)
    results = idx.search_batch([to_port(q, 10) for q in queries])
    assert not _differ(queries, results, Reference(corpus))


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_control_in_bfloat16_fails(base, seed):
    """The control (``control.readings``): the reference in the nearest
    precision below float32, in the program's place, judged by the run's
    comparison, on three seeds."""
    cell = spec.cell(spec.load(base), PLAIN, base)
    got = control.readings(cell, seed, 20, "cpu", 1.0)
    assert got["correct"] is False
    assert got["weights_differ"] >= got["queries_checked"] // 2


def test_reference_reads_only_the_corpus():
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "reference.py").read_text()
    tree = ast.walk(ast.parse(src))
    names = {(a.name if isinstance(n, ast.Import) else n.module or ".")
             .split(".")[0]
             for n in tree if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in n.names}
    assert names <= {"__future__", "math", "numpy", "torch"}, names


@pytest.mark.parametrize("zipf_s", [1.0, 1.25])
def test_corpus_is_truncated_zipf(zipf_s):
    cfg = {"documents": 4000, "doc_len": [50, 199], "vocabulary": 500,
           "zipf_s": zipf_s, "attrs": {"year": {"base": 2000, "mod": 25}},
           "fields": ["content"]}
    c = make_corpus(cfg, SEED, "cpu")
    counts = torch.bincount(c.tokens.long(), minlength=500)
    # no pile-up on the last word: the tail falls as ranks rise
    assert counts[-1] < counts[100]
    lens = c.offsets[1:] - c.offsets[:-1]
    assert int(lens.min()) >= 50 and int(lens.max()) <= 199
    again = make_corpus(cfg, SEED, "cpu")
    assert torch.equal(c.tokens, again.tokens)
    assert isinstance(c, Corpus)
    assert json.dumps(c.attrs["year"][:3].tolist()) == "[2000, 2001, 2002]"
