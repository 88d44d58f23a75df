"""A whole run on the CPU (the look for a card skipped), with the timed path
broken underneath: each fault a cell can have has to turn ``correct``
false, and the sound run has to stay true."""
from __future__ import annotations

from dataclasses import replace

import pytest

from perfbench import run, spec

from .conftest import PLAIN, SHARDED

SEED = 2 ** 32 + 901


def _run(base, workload: str) -> dict:
    cell = spec.cell(spec.load(base), workload, base)
    return run.run_cell(cell, SEED, 1.0, False, "cpu", base)


def _alter_first(field: str):
    """Alter, where the single table produces it, the first match of every
    ranked result: its weight or its docid, or the found total."""
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    finish = SearchIndex._finish

    def broken(self, *args, **kwargs):
        res = finish(self, *args, **kwargs)
        if field == "found":
            res.total_found += 1
        elif res.matches:
            m = res.matches[0]
            res.matches[0] = replace(m, **{field: getattr(m, field) + 1})
        return res
    return SearchIndex, "_finish", broken


def _half_batch():
    """Half of each batch left out: its queries get the answers of the
    half that ran."""
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    search_batch = SearchIndex.search_batch

    def broken(self, queries):
        half = search_batch(self, queries[:(len(queries) + 1) // 2])
        return (half * 2)[:len(queries)]
    return SearchIndex, "search_batch", broken


def _no_exchange():
    """The exchange between the parts left out: the merge sees the first
    part's top documents alone."""
    from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
    merge = ShardedIndex._merge

    def broken(self, chunks, k):
        return merge(self, chunks[:1], k)
    return ShardedIndex, "_merge", broken


@pytest.mark.parametrize("workload", [PLAIN, SHARDED])
def test_sound_run_is_correct(base, workload):
    out = _run(base, workload)
    assert out["correct"], out["checked"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-2:] == ["checked", "_lines"]


@pytest.mark.parametrize("fault,workload", [
    (lambda: _alter_first("weight"), PLAIN),
    (lambda: _alter_first("docid"), PLAIN),
    (lambda: _alter_first("found"), PLAIN),
    (_half_batch, PLAIN),
    (_no_exchange, SHARDED),
], ids=["weight", "docid", "found", "half_batch", "no_exchange"])
def test_fault_makes_run_incorrect(base, monkeypatch, fault, workload):
    cls, name, broken = fault()
    monkeypatch.setattr(cls, name, broken)
    out = _run(base, workload)
    assert out["correct"] is False, out["checked"]
