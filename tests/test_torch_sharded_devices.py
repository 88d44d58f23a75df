"""Port parity: the distributed index in parts, one part per mesh position.

The port's ``ShardedIndex(shards, devices=[...])`` puts a contiguous run of
``len(shards) / len(devices)`` shards on each position of the list (the
JAX package's mesh path; ``tests/conftest.py`` gives JAX an 8-device CPU
mesh). Here every position is the CPU (``["cpu"] * P``), so the parts,
the per-part decode, the per-part prelude and the gather onto the first
device run as they run on several cards. The same shards (built by the
JAX package's builder, carried across with ``from_jax_packed``) go to
JAX's ``ShardedIndex`` on ``make_mesh(len(shards))``. Covered:

- P = 2, 4 and 8 parts of 8 shards on every query of
  ``tests/test_torch_sharded.py``'s ``_CASES`` (GROUP BY and ORDER BY an
  attribute included), equal to JAX's 8-device mesh (its results computed
  once per module) and to the port's one-part index;
- JAX on ``make_mesh(4)`` over 4 shards against the port's 4 parts (and
  2 parts of 2 shards): the small corpus, float ORDER BY keys of -0.0,
  +0.0, +-inf and NaN in both directions, uneven shards;
- one differential seed and the bench corpus under sparse plans
  (``MT_SPARSE=always``: the union plan of a large corpus) at P = 4;
- ``search_batch`` equal to ``search``;
- one plain decode per part per merged batch (``LAUNCHES.plain == P``),
  and no merged decode for a batch that only takes the fallback;
- ``ValueError`` for 8 shards on 3 devices, for ``make_mesh`` asking for
  more cards than are visible (none here), and for one decode of windows
  of two parts on two devices;
- ``tools.multichip.check_mesh`` on ``["cpu"] * 4`` at 4,000 documents,
  with its fallback batch.

Tolerance: exact, as in ``tests/test_torch_sharded.py``: docids, weights,
totals, word stats and attributes.
"""
import numpy as np
import pytest
import torch

import bench
from manticoresearch_tpu.exec.searcher import SearchQuery as JaxQuery
from manticoresearch_tpu.parallel.sharded import ShardedIndex as JaxSharded
from manticoresearch_tpu.parallel.sharded import (make_mesh as jax_mesh,
                                                  partition_documents)
from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops.device_index import from_jax_packed
from manticoresearch_tpu_torch.ops.search import packed_windows
from manticoresearch_tpu_torch.parallel.sharded import (ShardedIndex,
                                                        make_mesh)
from manticoresearch_tpu_torch.tools import multichip

from . import test_differential as tdiff
from . import test_sharded as tsh
from .test_torch_search import _jax_query
from .test_torch_sharded import (_CASES, FLOAT_VALUES, _build, _port_query,
                                 _summary)

torch.set_num_threads(2)

PARTS = (2, 4, 8)


def _parts(shards, n_parts: int) -> ShardedIndex:
    return ShardedIndex([from_jax_packed(s) for s in shards],
                        devices=["cpu"] * n_parts)


def _assert_parts_match_jax(jax_idx, idx, jqs):
    got = idx.search_batch([_port_query(q) for q in jqs])
    for q, r in zip(jqs, got):
        assert _summary(r) == _summary(jax_idx.search(q)), (q.match, q.sort)
    return got


@pytest.fixture(scope="module")
def small():
    """The small corpus in 8 shards: JAX's results of every case on the
    8-device mesh, the port's one-part index and its P-part indexes."""
    shards = [_build(tsh.SCHEMA, p)
              for p in partition_documents(tsh.make_docs(), 8)]
    jax_idx = JaxSharded(shards, jax_mesh(8))
    want = [_summary(jax_idx.search(q)) for q in _CASES]
    one = ShardedIndex([from_jax_packed(s) for s in shards], "cpu")
    return want, one, {p: _parts(shards, p) for p in PARTS}


@pytest.mark.parametrize("qi", range(len(_CASES)))
@pytest.mark.parametrize("n_parts", PARTS)
def test_parts_match_jax_mesh(small, n_parts, qi):
    want, one, by_parts = small
    idx = by_parts[n_parts]
    assert len(idx.parts) == n_parts and idx.per_part == 8 // n_parts
    assert want[qi]["error"] is None
    q = _port_query(_CASES[qi])
    assert _summary(idx.search(q)) == want[qi]
    assert _summary(one.search(q)) == want[qi]


@pytest.mark.parametrize("n_parts", PARTS)
def test_search_batch_equals_search(small, n_parts):
    want, _one, by_parts = small
    idx = by_parts[n_parts]
    got = idx.search_batch([_port_query(q) for q in _CASES])
    assert [_summary(r) for r in got] == want
    for q, r in zip(_CASES, got):
        assert _summary(r) == _summary(idx.search(_port_query(q)))


@pytest.mark.parametrize("n_parts", (2, 4))
def test_four_device_mesh(n_parts):
    """JAX on ``make_mesh(4)`` over 4 shards against the port's parts."""
    shards = [_build(tsh.SCHEMA, p)
              for p in partition_documents(tsh.make_docs(), 4)]
    jax_idx = JaxSharded(shards, jax_mesh(4))
    _assert_parts_match_jax(jax_idx, _parts(shards, n_parts),
                            list(tsh.QUERIES) + list(tsh.QUERIES_POSITIONAL))


@pytest.mark.parametrize("asc", [True, False])
def test_float_keys_four_parts(asc):
    """``test_torch_sharded.test_float_keys_match_jax`` on 4 parts: -0.0,
    +0.0, +-inf and NaN keys through each part's prelude and the gather."""
    from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
    schema = Schema(fields=["c"], attrs=[AttrDef("f", AttrType.FLOAT)])
    docs = [dict(id=i + 1, c="word common" if i % 5 else "word", f=0.0)
            for i in range(60)]
    shards = [_build(schema, p) for p in partition_documents(docs, 4)]
    for s in shards:
        s.attrs_float["f"][:] = FLOAT_VALUES[(s.doc_ids * 5)
                                             % len(FLOAT_VALUES)]
    jax_idx = JaxSharded(shards, jax_mesh(4))
    jqs = [JaxQuery(match=m, limit=lim, sort=[("f", asc)])
           for m, lims in (("common", (7, 20, 40, 48)), ("word", (7, 20)))
           for lim in lims]
    got = _parts(shards, 4).search_batch([_port_query(q) for q in jqs])
    for q, r in zip(jqs, got):
        assert repr(_summary(r)) == repr(_summary(jax_idx.search(q))), \
            (q.match, q.limit)
    stored = np.asarray([m.attrs["f"] for r in got for m in r.matches],
                        np.float32)
    assert (np.signbit(stored) & (stored == 0)).any()
    assert np.isnan(stored).any() and np.isinf(stored).any()


@pytest.mark.parametrize("n_parts", (2, 4))
def test_uneven_shards_parts(n_parts):
    """Four shards of 1,500, 40, 300 and 700 documents ("hot" in every
    document of the first, two of the second, half of the others): the
    common slot windows of the first shard run past the other parts' own
    postings into the union's padding."""
    from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
    schema = Schema(fields=["title", "body"],
                    attrs=[AttrDef("g", AttrType.UINT)])
    rng = np.random.RandomState(4)
    words = [f"w{i}" for i in range(20)]

    def docs(lo, n, hot_every):
        return [dict(id=lo + i, g=int(rng.randint(0, 9)),
                     title=words[int(rng.randint(0, 20))],
                     body=" ".join(
                         [words[int(z) % 20] for z in rng.zipf(1.4, 6)]
                         + (["hot"] if i % hot_every == 0 else [])))
                for i in range(n)]
    shards = [_build(schema, docs(1, 1500, 1)),
              _build(schema, docs(5001, 40, 20)),
              _build(schema, docs(9001, 300, 2)),
              _build(schema, docs(13001, 700, 2))]
    assert [int(s.term_docs[s.term_id("hot")]) for s in shards] == \
        [1500, 2, 150, 350]
    jax_idx = JaxSharded(shards, jax_mesh(4))
    idx = _parts(shards, n_parts)
    assert idx.n_common == 1500
    _assert_parts_match_jax(jax_idx, idx, [
        JaxQuery(match=m) for m in ("hot", "hot w1", "hot | w3",
                                    '"hot w2"', "w1 -hot")] + [
        JaxQuery(match=m, sort=[("g", False)], limit=40)
        for m in ("hot", "hot | w3")])


def test_differential_seed_four_parts():
    """The sharded arm of tests/test_differential.py at one seed, in 4
    parts of 2 shards, equal to JAX's 8-device mesh."""
    shards = [_build(tdiff.SCHEMA, p)
              for p in partition_documents(tdiff.make_docs(), 8)]
    rng = np.random.RandomState(99)
    _assert_parts_match_jax(JaxSharded(shards, jax_mesh(8)),
                            _parts(shards, 4),
                            [tdiff.random_query(rng) for _ in range(10)])


@pytest.fixture(scope="module")
def bench_shards():
    """The bench corpus at 4,000 documents in 8 shards (JAX's builder),
    one config-1 and config-2 batch (packed slots)."""
    jax_shards = bench.build_corpus_shards(4000, 400, 30, 8)
    single = SearchIndex(bench_corpus.build_corpus(4000, 400, 30), "cpu")
    gen = bench_corpus.WorkloadGen(np.random.RandomState(3), 400,
                                   single.packed)
    batch = ([SearchQuery(match=gen.term()[1], limit=10) for _ in range(8)]
             + gen.config2(8)[1])
    return jax_shards, single, batch


def test_sparse_plans_four_parts(bench_shards, monkeypatch):
    """Sparse (candidate-union) plans, as the union of a large corpus
    gets them, in 4 parts: equal to JAX's mesh under the same plans."""
    jax_shards, _single, batch = bench_shards
    monkeypatch.setenv("MT_SPARSE", "always")
    jax_idx = JaxSharded(jax_shards, jax_mesh(8))
    idx = _parts(jax_shards, 4)
    cqs = [idx.plan(q) for q in batch]
    assert sum(cq.sig.sparse for cq in cqs) >= len(batch) // 2
    got = idx.search_batch(batch)
    for q, r in zip(batch, got):
        assert _summary(r) == _summary(jax_idx.search(_jax_query(q)))


@pytest.mark.parametrize("n_parts", PARTS)
def test_one_plain_decode_per_part(bench_shards, n_parts):
    jax_shards, single, batch = bench_shards
    idx = _parts(jax_shards, n_parts)
    ps.LAUNCHES.reset()
    got = idx.search_batch(batch)
    assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (n_parts, 0)
    assert ps.LAUNCHES.by_device == {}
    for q, r in zip(batch, got):
        one = single.search(q)
        assert r.total_found == one.total_found
        assert [(m.docid, m.weight) for m in r.matches] == \
            [(m.docid, m.weight) for m in one.matches]
    # a fallback-only batch makes no merged decode: each shard's own
    # search (on its part's device) decodes its windows
    grouped = [SearchQuery(match=batch[0].match, group_by="group_id",
                           select=["count(*)"], limit=5)]
    ps.LAUNCHES.reset()
    r = idx.search_batch(grouped)[0]
    assert ps.LAUNCHES.plain == len(idx.shards)
    assert [s.device.device.type for s in idx._per_shard_indexes()] == \
        ["cpu"] * 8
    assert r.total_found == single.search(grouped[0]).total_found


def test_shards_must_divide_devices():
    shards = [from_jax_packed(s)
              for s in bench.build_corpus_shards(800, 100, 10, 8)]
    with pytest.raises(ValueError, match="8 shards for 3 mesh devices"):
        ShardedIndex(shards, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="8 shards for 0 mesh devices"):
        ShardedIndex(shards, devices=[])
    with pytest.raises(ValueError, match="not both"):
        ShardedIndex(shards, "cpu", devices=["cpu"] * 4)


@pytest.mark.parametrize("extra", [0, 1, 4])
def test_make_mesh_needs_the_cards(extra):
    """A mesh of more cards than are visible (or of none) raises; none
    falls back to fewer cards or to the CPU."""
    n = torch.cuda.device_count() + extra if extra else 0
    with pytest.raises(ValueError, match="visible"):
        make_mesh(n)


def test_make_mesh_takes_every_visible_card():
    visible = torch.cuda.device_count()
    if visible:
        assert make_mesh() == [torch.device("cuda", i)
                               for i in range(visible)]
    else:
        with pytest.raises(ValueError, match="0 visible"):
            make_mesh()


def test_decode_refuses_mixed_devices():
    """Windows of two parts on two devices in one decode raise; nothing is
    moved to the first window's device."""
    shards = [from_jax_packed(s)
              for s in bench.build_corpus_shards(4000, 400, 30, 2)]
    idx = ShardedIndex(shards, devices=["cpu", "meta"])
    assert [p["alive"].device.type for p in idx.parts] == ["cpu", "meta"]
    q = SearchQuery(match=idx.shards[0].term_strs[3], limit=10)
    st, (cq, rt_shard, rt_repl, pb, _hb, _nhi) = idx._prep(q)
    assert st == "ok"
    wins = [packed_windows(cq.sig, pb, idx._views[d],
                           {**{k: v[d] for k, v in rt_shard.items()},
                            **rt_repl})
            for d in range(2)]
    assert all(wins)
    for order in (wins, wins[::-1]):
        ps.LAUNCHES.reset()
        with pytest.raises(ValueError, match="words must be"):
            ps.decode_lists(order)
        assert (ps.LAUNCHES.plain, ps.LAUNCHES.kernel) == (0, 0)


def test_multichip_check_mesh_on_cpu():
    """The tool's check on ``["cpu"] * 4`` at 4,000 documents: every
    query merged, one plain decode per part per batch, results equal to
    the one-part index and to one index over the corpus; then its
    fallback batch (grouped AVG queries, each shard's own search)."""
    corpus = bench_corpus.build_corpus(4000, 400, 30)
    shards = bench_corpus.build_corpus_shards(4000, 400, 30, 8)
    batches = multichip.config_batches(corpus, n=16, vocab=400)
    single = SearchIndex(corpus, "cpu")
    grouped = multichip.fallback_batch(corpus, n=4, vocab=400)
    report = multichip.check_mesh(
        shards, ["cpu"] * 4, batches, ShardedIndex(shards, "cpu"),
        {name: single.search_batch(qs) for name, qs in batches.items()},
        launches_by_path=(paths := {}), tag="cpu mesh", fallback=grouped)
    assert report["parts"] == 4 and report["memory_bytes"] == {}
    assert all(b > 0 for b in report["part_bytes"])
    assert paths == {"cpu mesh config1": 0, "cpu mesh config2": 0,
                     "cpu mesh fallback": 0}
    assert set(report["batches"]) == {"config1", "config2"}
    # 4 queries x 8 shard searches, each with a plain AVG sum; 4 of them
    # read packed windows (the shards' own pack decisions, 500 documents)
    assert report["fallback"] == {"launches_by_card": {"plain": 4},
                                  "segment_sum_launches": 32}
    # a mesh of the wrong size for the shards is refused
    with pytest.raises(ValueError, match="8 shards for 3 mesh devices"):
        multichip.check_mesh(shards, ["cpu"] * 3, batches,
                             ShardedIndex(shards, "cpu"))
