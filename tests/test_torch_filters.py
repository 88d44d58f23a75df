"""Port parity: every filter kind of the search program, in the dense and
the sparse row space, JAX SearchIndex vs the port on the CPU.

One seeded index with an MVA column (lists of 0-5 values, some empty), an
MVA column whose lists are all empty, a bigint column (negatives and
values past 2^31), a JSON column and document ids past 2^32. Each case
runs through the planner's dense plan (``MT_SPARSE=never``), its sparse
union plan (``MT_SPARSE=always``, asserted on ``sig.sparse``) and, without
a MATCH, its own choice (filter-first where a filter's window is narrow).
Covered kinds: ``mva_any``, ``mva_all``, ``mva_subset`` (with a padded
value set), ``mva_any_range``, ``mva_all_range``, ``id_values``,
``id_range``, ``big_values``, ``big_range`` and ``host_mask`` (JSON
paths), with and without exclude, and under an OR filter tree.

Tolerance: exact. Weights are integers computed by the reference formulas;
docids, totals and word stats are integers and strings.
"""
import json

import numpy as np
import pytest
import torch

from manticoresearch_tpu.exec.searcher import SearchIndex as JaxIndex
from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.exec.searcher import SearchQuery
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

from .test_torch_search import _port
from .test_torch_sparse import _check, _mode

torch.set_num_threads(2)

N_DOCS = 600
BIG_IDS = [(1 << 32) + 5, (1 << 33) + 17, (1 << 40) + 3]


def _doc_id(i: int) -> int:
    return BIG_IDS[i - N_DOCS + 2] if i > N_DOCS - 3 else 100 + 3 * i


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(21)
    words = [f"w{i}" for i in range(30)]
    docs = []
    for i in range(1, N_DOCS + 1):
        n_tags = int(rng.randint(0, 6))
        docs.append(dict(
            id=_doc_id(i),
            title=words[i % 30],
            body=" ".join(words[int(z) % 30] for z in rng.zipf(1.3, 10)),
            year=2000 + i % 20,
            tags=[int(x) for x in rng.randint(0, 40, n_tags)],
            etags=[],
            big=int(rng.choice([-1, 1]) * rng.randint(0, 2**40)),
            meta=json.dumps({"a": int(rng.randint(0, 50)),
                             "s": ["x", "y", "z"][i % 3]})))
    docs[5]["big"] = 2**31 + 7
    docs[6]["big"] = -(2**33)
    b = IndexBuilder(Schema(fields=["title", "body"],
                            attrs=[AttrDef("year", AttrType.UINT),
                                   AttrDef("tags", AttrType.MVA),
                                   AttrDef("etags", AttrType.MVA),
                                   AttrDef("big", AttrType.BIGINT),
                                   AttrDef("meta", AttrType.JSON)]))
    b.add_documents(docs)
    packed = b.build()
    assert len(packed.attrs_mva["etags"][1]) == 0
    return JaxIndex(packed), _port(packed)


def _f(attr, kind, **kw):
    return AttrFilterDef(attr, kind, **kw)


FILTER_CASES = {
    "mva-any": [_f("tags", "values", values=[3, 17])],
    "mva-any-exclude": [_f("tags", "values", values=[3, 17], exclude=True)],
    "mva-all": [_f("tags", "mva_all", values=[1, 5])],
    "mva-all-one": [_f("tags", "mva_all", values=[9])],
    "mva-subset-padded": [_f("tags", "mva_subset", values=[1, 2, 3, 4, 5])],
    "mva-subset-exclude": [_f("tags", "mva_subset", values=[0, 39, 39],
                              exclude=True)],
    "mva-any-range": [_f("tags", "range_i", lo=10, hi=20)],
    "mva-all-range": [_f("tags", "mva_all_range", lo=0, hi=25)],
    "mva-all-range-exclude": [_f("tags", "mva_all_range", lo=5,
                                 exclude=True)],
    "mva-empty-column": [_f("etags", "values", values=[1])],
    "mva-empty-column-exclude": [_f("etags", "values", values=[1],
                                    exclude=True)],
    "id-values": [_f("id", "values", values=[103, BIG_IDS[0], BIG_IDS[2],
                                              2**50])],
    "id-range": [_f("id", "range_i", lo=2**32, hi=2**34)],
    "id-range-exclude": [_f("id", "range_i", lo=400, hi=2**33 + 17,
                            exclude=True)],
    "big-values": [_f("big", "values", values=[2**31 + 7, -(2**33), 5])],
    "big-range": [_f("big", "range_i", lo=-(2**35), hi=2**31 + 7)],
    "big-range-exclude": [_f("big", "range_i", lo=0, exclude=True)],
    "json-range": [_f("meta.a", "range_i", lo=10, hi=30)],
    "json-values-exclude": [_f("meta.s", "values", values=["x"],
                               exclude=True)],
    "mixed-and": [_f("tags", "range_i", lo=0, hi=30),
                  _f("big", "range_i", hi=2**39),
                  _f("meta.a", "range_i", lo=5)],
}

TREE_CASES = {
    "or-tree": ([_f("tags", "values", values=[7]),
                 _f("id", "range_i", hi=400), _f("meta.s", "values",
                                                 values=["y"])],
                ("or", (("leaf", 0), ("and", (("leaf", 1), ("leaf", 2)))))),
}


def _query(case: str, match: str) -> SearchQuery:
    if case in TREE_CASES:
        filters, tree = TREE_CASES[case]
    else:
        filters, tree = FILTER_CASES[case], None
    return SearchQuery(match=match, filters=filters, filter_tree=tree,
                       limit=30, max_matches=N_DOCS)


CASES = list(FILTER_CASES) + list(TREE_CASES)


@pytest.mark.parametrize("mode", ["never", "always"])
@pytest.mark.parametrize("case", CASES)
def test_filter_kinds_match_jax(pair, monkeypatch, case, mode):
    jax_idx, idx = pair
    _mode(monkeypatch, mode, jax_idx, idx)
    q = _query(case, "w2 | w17")
    assert idx.plan(q).sig.sparse == (mode == "always")
    _check(jax_idx, idx, q)


@pytest.mark.parametrize("case", CASES)
def test_filter_kinds_without_match_match_jax(pair, monkeypatch, case):
    jax_idx, idx = pair
    _mode(monkeypatch, "auto", jax_idx, idx)
    _check(jax_idx, idx, _query(case, ""))


def test_filter_first_with_mva_and_id_filters_match_jax(pair, monkeypatch):
    """A narrow year window picks the filter-first plan; the other filters
    then run over its candidates."""
    jax_idx, idx = pair
    _mode(monkeypatch, "auto", jax_idx, idx)
    for extra in (FILTER_CASES["mva-any"], FILTER_CASES["id-range-exclude"],
                  FILTER_CASES["big-range-exclude"],
                  FILTER_CASES["json-range"]):
        q = SearchQuery(match="", filters=[_f("year", "values",
                                              values=[2003])] + extra,
                        sort=[("big", False)], limit=20)
        assert idx.plan(q).sig.scan_index == "year"
        assert _check(jax_idx, idx, q)["total_found"] > 0


def test_late_filters_raise(pair):
    """MVA values past 32 bits and expression filters are late filters in
    the JAX package (a host pass over the match window): not ported."""
    _, idx = pair
    for f in (_f("tags", "values", values=[2**33]),
              _f("tags", "range_i", lo=-(2**32)),
              _f("year+1", "range_i", lo=2003)):
        with pytest.raises(NotImplementedError, match="late filter|expr"):
            idx.search(SearchQuery(match="w2", filters=[f]))
