"""Port parity: the RT arm of ``tests/test_differential.py``.

The same 120 documents go, in the same order, into a JAX ``RtIndex`` and
into the port's ``RtIndex(..., device="cpu")``, committed in 7 chunks so
that each table holds 7 RAM segments; then 40 random queries of
``tests/test_differential.py``'s generator (every MATCH shape, ranker
and filter kind it draws) run on both. At three seeds of the corpus, the
commit order and the query stream.

Tolerance: exact, with no tie normalization: the two tables hold the same
segments in the same order, so docids in order, weights, total_found,
attributes and word stats are all equal.
"""
from dataclasses import fields

import jax
import numpy as np
import pytest

from manticoresearch_tpu_torch.exec import searcher
from manticoresearch_tpu_torch.query import planner

from . import test_differential as tdiff
from .test_torch_rt import JAX, PORT, state, summary


@pytest.fixture(autouse=True)
def _free_jax_programs():
    """One seed's JAX searches compile a program per plan shape and
    segment size; free them before the next seed (``tests/conftest.py``
    says why the memory maps must stay bounded)."""
    yield
    jax.clear_caches()


def _port_query(jq):
    kw = {f.name: getattr(jq, f.name) for f in fields(jq)}
    kw["filters"] = [planner.AttrFilterDef(**{f.name: getattr(x, f.name)
                                              for f in fields(x)})
                     for x in jq.filters]
    return searcher.SearchQuery(**kw)


def _table(m, seed):
    docs = tdiff.make_docs(seed=11 + seed)
    t = m.RtIndex("t", m.Schema(
        fields=["title", "body"],
        attrs=[m.AttrDef("year", m.AttrType.UINT),
               m.AttrDef("score", m.AttrType.FLOAT),
               m.AttrDef("color", m.AttrType.STRING)]))
    order = np.random.RandomState(5 + seed).permutation(len(docs))
    for chunk in np.array_split(order, 7):
        for i in chunk:
            t.insert(docs[int(i)])
        t.commit()
    assert len(t.segments) > 1
    return t


@pytest.mark.parametrize("seed", range(3))
def test_differential_rt_arm_matches_jax(seed):
    jt, pt = _table(JAX, seed), _table(PORT, seed)
    assert state(pt) == state(jt)
    rng = np.random.RandomState(99 + seed)
    for qi in range(40):
        q = tdiff.random_query(rng)
        want = summary(jt.search(q))
        assert want["error"] is None, (q.match, want["error"])
        assert summary(pt.search(_port_query(q))) == want, (qi, q.match)
