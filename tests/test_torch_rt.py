"""Port parity: the RT index, JAX ``RtIndex`` vs the port's.

Every case feeds identical operations to a ``manticoresearch_tpu`` RT
index and to a ``manticoresearch_tpu_torch`` one on ``device="cpu"``, each
package building its own segments with its own builder, and requires the
same observations from both: docids in order, weights, total_found,
attributes, word stats, errors and warnings of every search, and after
each step ``n_docs``, the segment count, each segment's chunk id and row
count, and ``chunk_status()``. Covered:

- every case of ``tests/test_rt.py`` (write path, REPLACE, DELETE,
  UPDATE, TRUNCATE, OPTIMIZE, progressive merge, binlog replay, snapshot
  reload, a torn binlog tail, ``save_packed`` / ``load_packed``, the
  posting-level merge against a rebuild, zones and sentences through a
  merge), the files under pytest's ``tmp_path``;
- a write stream under ``MT_SPARSE`` never and always: inserts, REPLACE,
  DELETE, rollback, UPDATE of every attribute kind, commits past
  ``MERGE_SEGMENT_LIMIT``, FLUSH RAMCHUNK, DEBUG SPLIT / MERGE,
  ``attach_packed``, ALTER ADD / DROP, ``part_view``, TRUNCATE and
  OPTIMIZE, with filtered, attribute-ordered and grouped queries (COUNT,
  integer and float SUM, AVG with its warning, COUNT(DISTINCT)) after
  each step;
- a filter-first GROUP BY repeated after an UPDATE of its filter column
  (the port drops its cached group-by plans, as JAX plans afresh);
- ``search_rt``'s other routes over segments with kills: an expression
  late filter, PACKEDFACTORS() under the expression ranker, ORDER BY with
  an offset, a small max_matches, a JSON-path filter and GROUP BY, GROUP
  N BY and a bigint GROUP BY;
- ``OPTION global_idf`` from a file written by the JAX package's
  ``indextool --buildidf`` and read by the port;
- the result-cache hook with ``qcache_thresh_msec = 0``;
- a bigint UPDATE: the JAX package re-uploads a bigint's clipped column but
  not its ``#hi`` / ``#lo`` split, so a 64-bit value filter still sees the
  old value; the port gives the same results;
- a FLUSH after a DELETE and a REPLACE: the snapshot keeps no kill-list,
  so the reloaded JAX table shows the killed rows again; so does the
  port's.

Tolerance: exact. Weights are integers; attributes are ints, strings and
float32 values read back from the segments; grouped float sums and
averages are computed by each package's own code on the same float32
values and must agree to the last bit.
"""
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from manticoresearch_tpu.exec import qcache as jax_qcache
from manticoresearch_tpu.exec import searcher as jax_searcher
from manticoresearch_tpu.index import builder as jax_builder
from manticoresearch_tpu.index import merge as jax_merge
from manticoresearch_tpu.index import rt as jax_rt
from manticoresearch_tpu.index import storage as jax_storage
from manticoresearch_tpu.query import planner as jax_planner
from manticoresearch_tpu.schema import AttrDef as JaxAttrDef
from manticoresearch_tpu.schema import AttrType as JaxAttrType
from manticoresearch_tpu.schema import Schema as JaxSchema
from manticoresearch_tpu.text import tokenizer as jax_tokenizer
from manticoresearch_tpu.tools import indextool as jax_indextool
from manticoresearch_tpu_torch.exec import qcache
from manticoresearch_tpu_torch.exec import searcher
from manticoresearch_tpu_torch.index import builder
from manticoresearch_tpu_torch.index import merge
from manticoresearch_tpu_torch.index import rt
from manticoresearch_tpu_torch.index import storage
from manticoresearch_tpu_torch.query import planner
from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.text import tokenizer

from . import test_differential as tdiff
from .test_search import DOCS

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _free_jax_programs():
    """Free the JAX package's compiled programs after each case: one RT
    scenario compiles a program per plan shape and segment size, and the
    executables' memory maps of several cases together would pass the
    kernel's map-count limit (see ``tests/conftest.py``)."""
    yield
    jax.clear_caches()


def _pkg(sr, bd, mg, rtm, st, pl, ad, at, sc, tk, qc, device):
    """The names a scenario uses, from one package."""
    extra = {} if device is None else {"device": device}

    def rt_index(*a, **kw):
        return rtm.RtIndex(*a, **kw, **extra)

    def rt_from_packed(*a, **kw):
        return rtm.rt_from_packed(*a, **kw, **extra)

    def search_index(packed):
        return sr.SearchIndex(packed, *([device] if device else []))

    return SimpleNamespace(
        RtIndex=rt_index, rt_from_packed=rt_from_packed,
        SearchIndex=search_index, Q=sr.SearchQuery, F=pl.AttrFilterDef,
        IndexBuilder=bd.IndexBuilder, merge_packed=mg.merge_packed,
        save_packed=st.save_packed, load_packed=st.load_packed,
        AttrDef=ad, AttrType=at, Schema=sc,
        TokenizerSettings=tk.TokenizerSettings, QueryCache=qc.QueryCache,
        MERGE_SEGMENT_LIMIT=rtm.RtIndex.MERGE_SEGMENT_LIMIT)


JAX = _pkg(jax_searcher, jax_builder, jax_merge, jax_rt, jax_storage,
           jax_planner, JaxAttrDef, JaxAttrType, JaxSchema, jax_tokenizer,
           jax_qcache, None)
PORT = _pkg(searcher, builder, merge, rt, storage, planner, AttrDef,
            AttrType, Schema, tokenizer, qcache, "cpu")


def summary(r):
    """A search result as builtins that the two packages must agree on."""
    return dict(matches=[(m.docid, m.weight, m.attrs) for m in r.matches],
                total=r.total, total_found=r.total_found,
                words=[(w.word, w.docs, w.hits) for w in r.word_stats],
                error=r.error, warning=getattr(r, "warning", None))


def state(t):
    """The table's shape: live documents, segments and disk chunks."""
    return dict(n_docs=t.n_docs,
                segments=[(s.chunk_id, s.packed.n_docs, len(s.docs))
                          for s in t.segments],
                chunks=t.chunk_status(), generation=t.generation)


def _both(scenario, tmp_path=None):
    """Run one scenario with each package; both must observe the same."""
    out = []
    for name, m in (("jax", JAX), ("port", PORT)):
        tmp = None
        if tmp_path is not None:
            tmp = tmp_path / name
            tmp.mkdir()
        out.append(scenario(m, tmp))
    want, got = out
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"observation {i}"
    return got


# --------------------------------------------------------------------------
# every case of tests/test_rt.py
# --------------------------------------------------------------------------
def _rt_schema(m):
    return m.Schema(fields=["title", "content"],
                    attrs=[m.AttrDef("gid", m.AttrType.UINT),
                           m.AttrDef("price", m.AttrType.FLOAT)])


def _make_rt(m, tmp=None):
    return m.RtIndex("t", _rt_schema(m), data_dir=tmp)


def sc_insert_commit_search(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="hello world", content="first doc", gid=1))
    t.insert(dict(id=2, title="hello there", content="second doc", gid=2))
    n = t.commit()
    r = t.search(m.Q(match="hello"))
    assert [x.docid for x in r.matches] == [1, 2] and r.total_found == 2
    return [n, summary(r), state(t)]


def sc_uncommitted_not_visible(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="x", content="y", gid=1))
    out = [summary(t.search(m.Q(match="x"))), t.n_docs]
    t.commit()
    return out + [summary(t.search(m.Q(match="x"))), state(t)]


def sc_duplicate_insert_rejected(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="a", content="", gid=1))
    t.commit()
    with pytest.raises(ValueError) as e:
        t.insert(dict(id=1, title="b", content="", gid=1))
    return [str(e.value), state(t)]


def sc_replace(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="old text", content="", gid=1))
    t.commit()
    t.insert(dict(id=1, title="new text", content="", gid=1), replace=True)
    t.commit()
    old, new = t.search(m.Q(match="old")), t.search(m.Q(match="new"))
    assert old.matches == [] and [x.docid for x in new.matches] == [1]
    return [summary(old), summary(new), state(t)]


def sc_delete(m, tmp):
    t = _make_rt(m)
    for i in range(1, 5):
        t.insert(dict(id=i, title=f"doc {i}", content="word", gid=i))
    t.commit()
    n = t.delete([2, 3])
    t.commit()
    r = t.search(m.Q(match="word"))
    assert [x.docid for x in r.matches] == [1, 4]
    return [n, summary(r), state(t)]


def sc_multi_segment_search_and_global_idf(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="apple pie", content="", gid=1))
    t.commit()
    t.insert(dict(id=2, title="apple sauce", content="", gid=2))
    t.insert(dict(id=3, title="banana", content="", gid=3))
    t.commit()
    r = t.search(m.Q(match="apple"))
    assert [x.docid for x in r.matches] == [1, 2]
    assert r.matches[0].weight == r.matches[1].weight
    return [summary(r), state(t), t.global_stats()]


def sc_update_attrs(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="a", content="", gid=1, price=10.0))
    t.commit()
    n = t.update_attrs([1], {"price": 99.5, "gid": 7})
    r = t.search(m.Q(match="a"))
    assert r.matches[0].attrs["gid"] == 7
    return [n, summary(r), state(t)]


def sc_truncate(m, tmp):
    t = _make_rt(m)
    t.insert(dict(id=1, title="a", content="", gid=1))
    t.commit()
    t.truncate()
    r = t.search(m.Q(match="a"))
    assert t.n_docs == 0 and r.matches == []
    return [summary(r), state(t)]


def sc_optimize_merges_to_one(m, tmp):
    t = _make_rt(m)
    for i in range(1, 6):
        t.insert(dict(id=i, title=f"word{i} common", content="", gid=i))
        t.commit()
    before = state(t)
    t.optimize()
    r = t.search(m.Q(match="common"))
    assert len(t.segments) == 1 and r.total_found == 5
    return [before, summary(r), state(t)]


def sc_progressive_merge_caps_segments(m, tmp):
    t = _make_rt(m)
    out = []
    for i in range(1, 16):
        t.insert(dict(id=i, title=f"t{i} shared", content="", gid=i))
        t.commit()
        out.append(state(t))
    r = t.search(m.Q(match="shared"))
    assert len(t.segments) <= t.MERGE_SEGMENT_LIMIT + 1
    assert r.total_found == 15
    return out + [summary(r)]


def sc_binlog_replay(m, tmp):
    d = str(tmp / "idx")
    t = _make_rt(m, d)
    t.insert(dict(id=1, title="persisted doc", content="", gid=1))
    t.commit()
    t.insert(dict(id=2, title="another persisted", content="", gid=2))
    t.commit()
    t.delete([1])
    t.commit()
    t2 = _make_rt(m, d)
    r = t2.search(m.Q(match="persisted"))
    assert [x.docid for x in r.matches] == [2]
    return [summary(r), state(t2), summary(t.search(m.Q(match="persisted")))]


def sc_flush_snapshot_and_reload(m, tmp):
    d = str(tmp / "idx2")
    t = _make_rt(m, d)
    for i in range(1, 4):
        t.insert(dict(id=i, title=f"snap doc{i}", content="", gid=i))
    t.commit()
    t.flush()
    t2 = _make_rt(m, d)
    r = t2.search(m.Q(match="snap"))
    assert t2.n_docs == 3 and r.total_found == 3
    return [summary(r), state(t2)]


def sc_torn_binlog_tail_ignored(m, tmp):
    d = str(tmp / "idx3")
    t = _make_rt(m, d)
    t.insert(dict(id=1, title="good record", content="", gid=1))
    t.commit()
    with open(os.path.join(d, "binlog.jsonl"), "a") as f:
        f.write('{"op": "commit", "docs": [{"id": 2')  # torn write
    t2 = _make_rt(m, d)
    assert t2.n_docs == 1
    return [state(t2), summary(t2.search(m.Q(match="good")))]


def sc_save_load_roundtrip(m, tmp):
    schema = m.Schema(fields=["title", "content"],
                      attrs=[m.AttrDef("group_id", m.AttrType.UINT),
                             m.AttrDef("group_id2", m.AttrType.UINT)])
    b = m.IndexBuilder(schema)
    b.add_documents(DOCS)
    packed = b.build()
    path = str(tmp / "plain")
    m.save_packed(packed, path)
    idx1, idx2 = m.SearchIndex(packed), m.SearchIndex(m.load_packed(path))
    out = []
    for match in ("test", "test one", '"test document"', ""):
        r1, r2 = idx1.search(m.Q(match=match)), idx2.search(m.Q(match=match))
        assert summary(r1) == summary(r2)
        out.append(summary(r2))
    return out


def _merge_schema(m):
    return m.Schema(fields=["title", "body"],
                    attrs=[m.AttrDef("price", m.AttrType.UINT),
                           m.AttrDef("name", m.AttrType.STRING),
                           m.AttrDef("tags", m.AttrType.MVA),
                           m.AttrDef("score", m.AttrType.FLOAT)])


def _merge_docs():
    import random
    rng = random.Random(31337)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta",
             "shared", "rare"]
    return [dict(id=i, title=" ".join(rng.choices(words, k=4)),
                 body=" ".join(rng.choices(words, k=10)),
                 price=rng.randint(1, 50),
                 name=rng.choice(["ann", "bob", "cat"]),
                 tags=[rng.randint(1, 9) for _ in range(rng.randint(0, 3))],
                 score=round(rng.random() * 10, 2))
            for i in range(1, 61)]


def _merge_queries(m):
    return [
        m.Q(match="shared", limit=100),
        m.Q(match="alpha beta", limit=100),
        m.Q(match='"alpha beta"', limit=100),
        m.Q(match="gamma | rare", limit=100, ranker="proximity_bm25"),
        m.Q(match="@title delta", limit=100),
        m.Q(match="shared", limit=100,
            filters=[m.F("price", "range_i", lo=10, hi=40)]),
        m.Q(match="shared", limit=100,
            filters=[m.F("tags", "mva_any", values=[3, 5])]),
        m.Q(match="shared", limit=100, sort=[("price", True), ("id", True)]),
    ]


def sc_optimize_matches_rebuild(m, tmp):
    t = m.RtIndex("m", _merge_schema(m))
    docs = _merge_docs()
    for c in range(6):
        for d in docs[c * 10:(c + 1) * 10]:
            t.insert(d)
        t.commit()
    t.delete([5, 17, 33])
    t.commit()
    for d in docs[2:5]:
        t.insert(dict(d, title="replaced words here"), replace=True)
    t.commit()
    out = [state(t)] + [summary(t.search(q)) for q in _merge_queries(m)]
    t.optimize()
    assert len(t.segments) == 1
    live = {d["id"]: d for d in docs if d["id"] not in (5, 17, 33)}
    for d in docs[2:5]:
        live[d["id"]] = dict(d, title="replaced words here")
    b = m.IndexBuilder(t.schema, t.tok_settings, t.dict_settings)
    b.add_documents(live.values())
    ref = m.SearchIndex(b.build())
    for q in _merge_queries(m):
        a, r = t.search(q), ref.search(q)
        assert [(x.docid, x.weight) for x in a.matches] == \
            [(x.docid, x.weight) for x in r.matches], q.match
        out.append(summary(a))
    assert t.get_document(3)["title"] == "replaced words here"
    assert t.get_document(17) is None
    return out + [state(t), t.get_document(6), t.get_document(5)]


def sc_merged_zones_and_sp(m, tmp):
    ts = m.TokenizerSettings(html_strip=True, index_zones=("h1",),
                             index_sp=True)
    schema = m.Schema(fields=["content"], attrs=[])
    docs1 = [dict(id=1, content="<h1>big title</h1> plain text. more")]
    docs2 = [dict(id=2, content="other <h1>second heading</h1> words")]
    parts = []
    for docs in (docs1, docs2, docs1 + docs2):
        b = m.IndexBuilder(schema, ts)
        b.add_documents(docs)
        parts.append(b.build())
    mi = m.SearchIndex(m.merge_packed(parts[:2]))
    ri = m.SearchIndex(parts[2])
    out = []
    for qs in ["ZONE:(h1) title", "ZONE:(h1) heading", "ZONE:(h1) plain",
               '"plain text" SENTENCE more']:
        a, r = mi.search(m.Q(match=qs)), ri.search(m.Q(match=qs))
        assert [(x.docid, x.weight) for x in a.matches] == \
            [(x.docid, x.weight) for x in r.matches], qs
        out.append(summary(a))
    return out


RT_CASES = {
    "insert_commit_search": (sc_insert_commit_search, False),
    "uncommitted_not_visible": (sc_uncommitted_not_visible, False),
    "duplicate_insert_rejected": (sc_duplicate_insert_rejected, False),
    "replace": (sc_replace, False),
    "delete": (sc_delete, False),
    "multi_segment_search_and_global_idf": (
        sc_multi_segment_search_and_global_idf, False),
    "update_attrs": (sc_update_attrs, False),
    "truncate": (sc_truncate, False),
    "optimize_merges_to_one": (sc_optimize_merges_to_one, False),
    "progressive_merge_caps_segments": (
        sc_progressive_merge_caps_segments, False),
    "binlog_replay": (sc_binlog_replay, True),
    "flush_snapshot_and_reload": (sc_flush_snapshot_and_reload, True),
    "torn_binlog_tail_ignored": (sc_torn_binlog_tail_ignored, True),
    "save_load_roundtrip": (sc_save_load_roundtrip, True),
    "optimize_matches_rebuild": (sc_optimize_matches_rebuild, False),
    "merged_zones_and_sp": (sc_merged_zones_and_sp, False),
}


@pytest.mark.parametrize("case", sorted(RT_CASES))
def test_rt_case_matches_jax(case, tmp_path):
    scenario, uses_files = RT_CASES[case]
    _both(scenario, tmp_path if uses_files else None)


# --------------------------------------------------------------------------
# a write stream over every attribute kind
# --------------------------------------------------------------------------
WORDS = ["alpha", "beta", "gamma", "delta", "omega", "kappa", "sigma"]
COLORS = ["red", "green", "blue"]


def _stream_schema(m):
    return m.Schema(fields=["title", "body"],
                    attrs=[m.AttrDef("year", m.AttrType.UINT),
                           m.AttrDef("score", m.AttrType.FLOAT),
                           m.AttrDef("big", m.AttrType.BIGINT),
                           m.AttrDef("color", m.AttrType.STRING),
                           m.AttrDef("tags", m.AttrType.MVA),
                           m.AttrDef("meta", m.AttrType.JSON)])


def _stream_doc(rng, docid):
    return dict(id=docid,
                title=" ".join(rng.choice(WORDS, 2)),
                body=" ".join(rng.choice(WORDS, int(rng.randint(3, 9)))),
                year=2000 + int(rng.randint(0, 8)),
                score=float(np.float32(rng.randint(0, 64) / 8)),
                big=int(rng.randint(-2**40, 2**40)),
                color=COLORS[int(rng.randint(0, 3))],
                tags=sorted({int(x) for x in rng.randint(0, 9, 2)}),
                meta=f'{{"k": {int(rng.randint(0, 5))}}}')


def _stream_queries(m):
    return [
        m.Q(match="alpha", limit=15),
        m.Q(match="beta | gamma", limit=15,
            filters=[m.F("year", "range_i", lo=2002, hi=2005)]),
        m.Q(match="delta", limit=15,
            filters=[m.F("color", "values", values=["red"])]),
        m.Q(match="omega", limit=15,
            filters=[m.F("tags", "mva_any", values=[2, 3])]),
        m.Q(match="kappa", limit=15, sort=[("year", False), ("id", True)]),
        m.Q(match="", limit=15, sort=[("score", True), ("id", True)],
            filters=[m.F("year", "range_i", lo=2001, hi=2006)]),
        m.Q(match="sigma", group_by="year", limit=15,
            select=["count(*)", "sum(year)", "sum(score)"],
            sort=[("year", True)]),
        m.Q(match="", group_by="color", limit=15,
            select=["count(*)", "avg(score)"], sort=[("@count", False)]),
        m.Q(match="alpha | beta", group_by="year", limit=15,
            select=["count(*)", "count(distinct color)"]),
    ]


def _observe(m, t, tag, out):
    out.append((tag, state(t)))
    for q in _stream_queries(m):
        out.append((tag, q.match, q.group_by, summary(t.search(q))))


def sc_write_stream(m, tmp):
    rng = np.random.RandomState(23)
    t = m.RtIndex("s", _stream_schema(m))
    out: list = []
    nxt = 1
    # inserts, one commit each, past the progressive-merge limit
    for c in range(m.MERGE_SEGMENT_LIMIT + 4):
        for _ in range(int(rng.randint(3, 9))):
            t.insert(_stream_doc(rng, nxt))
            nxt += 1
        t.commit()
    _observe(m, t, "inserts", out)
    # REPLACE, DELETE, a rolled-back transaction
    for d in (3, 8, 21):
        t.insert(_stream_doc(rng, d), replace=True)
    out.append(t.delete([5, 13, 40, 9999]))
    t.commit()
    t.insert(_stream_doc(rng, 9000))
    t.delete([1])
    t.rollback()
    _observe(m, t, "replace/delete", out)
    # UPDATE of every attribute kind, the grouped query asked before too
    out.append(t.update_attrs([2, 4, 30], {"year": 2007, "score": 0.5}))
    out.append(t.update_attrs([6, 31], {"big": 2**35, "color": "blue"}))
    out.append(t.update_attrs([7], {"tags": [1, 8], "meta": '{"k": 9}'}))
    _observe(m, t, "updates", out)
    t.flush_ramchunk()
    _observe(m, t, "flush", out)
    for _ in range(6):
        t.insert(_stream_doc(rng, nxt))
        nxt += 1
    t.commit()
    t.flush_ramchunk()
    cids = [s.chunk_id for s in t.segments]
    out.append(t.split_chunk(cids[0], range(1, 40, 2)))
    out.append(t.merge_chunks(cids[-1], t.segments[0].chunk_id))
    _observe(m, t, "split/merge", out)
    b = m.IndexBuilder(t.schema, t.tok_settings, t.dict_settings)
    b.add_documents([_stream_doc(rng, d) for d in (10, 500, 501, 502)])
    t.attach_packed(b.build())
    t.commit()
    _observe(m, t, "attach", out)
    t.alter("add", "rank", m.AttrType.UINT)
    t.alter("drop", "meta")
    out.append(t.update_attrs([500], {"rank": 3}))
    _observe(m, t, "alter", out)
    for n in range(len(t.segments) + 1):
        v = t.part_view(n)
        out.append(("part", n, state(v), summary(v.search(m.Q(match="alpha",
                                                             limit=15)))))
    t.optimize()
    _observe(m, t, "optimize", out)
    t.truncate()
    _observe(m, t, "truncate", out)
    return out


@pytest.mark.parametrize("mode", ["never", "always"])
def test_write_stream_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("MT_SPARSE", mode)
    got = _both(sc_write_stream)
    searches = [o for o in got if isinstance(o, tuple) and len(o) == 4
                and o[0] != "part"]
    assert len(searches) == 9 * 9
    assert all(o[3]["error"] is None for o in searches)
    # AVG across segments warns; found something after every step but
    # TRUNCATE
    assert any(o[3]["warning"] for o in searches if o[2])
    assert all(o[3]["total_found"] for o in searches[:-9])


# --------------------------------------------------------------------------
# global IDF, the result cache, a bigint UPDATE
# --------------------------------------------------------------------------
def test_global_idf_file_from_jax_indextool(tmp_path):
    docs = tdiff.make_docs(n=60, seed=4)
    b = jax_builder.IndexBuilder(JaxSchema(
        fields=["title", "body"],
        attrs=[JaxAttrDef("year", JaxAttrType.UINT)]))
    b.add_documents(docs[:40])
    jax_storage.save_packed(b.build(), str(tmp_path / "a"))
    idf = str(tmp_path / "global.idf")
    jax_indextool.build_global_idf([str(tmp_path / "a")], idf)

    def scenario(m, tmp):
        t = m.RtIndex("g", m.Schema(fields=["title", "body"],
                                    attrs=[m.AttrDef("year",
                                                     m.AttrType.UINT)]))
        for chunk in np.array_split(np.arange(60), 3):
            for i in chunk:
                t.insert(docs[int(i)])
            t.commit()
        out = [summary(t.search(m.Q(match="alpha", global_idf=True)))]
        t.options = {"global_idf": idf}
        for w in ("alpha", "beta gamma", "delta | eta"):
            out.append(summary(t.search(m.Q(match=w, global_idf=True))))
            out.append(summary(t.search(m.Q(match=w))))
        return out
    got = _both(scenario)
    assert got[0]["error"] and got[1]["error"] is None
    assert got[1] != got[2]                       # the file's stats count


def test_qcache_hook_matches_jax():
    def scenario(m, tmp):
        t = m.RtIndex("c", _rt_schema(m))
        t.qcache = m.QueryCache(thresh_msec=0)
        for i in range(1, 9):
            t.insert(dict(id=i, title=f"cache w{i % 3}", content="x", gid=i))
        t.commit()
        q = m.Q(match="cache")
        out = [summary(t.search(q)), t.qcache.status()]   # RAM: no entry
        t.flush_ramchunk()
        for _ in range(2):
            out += [summary(t.search(q)), t.qcache.status()]
        t.update_attrs([2], {"gid": 50})              # a new generation
        out += [summary(t.search(q)), t.qcache.status()]
        return out
    got = _both(scenario)
    assert got[1]["qcache_cached_queries"] == 0
    assert got[5]["qcache_hits"] == 1


def test_bigint_update_keeps_jax_split_columns():
    """UPDATE of a BIGINT: 64-bit value filters read the ``#hi`` / ``#lo``
    arrays, which neither package refreshes, so the filter still sees the
    old value while the document shows the new one."""
    def scenario(m, tmp):
        t = m.RtIndex("b", m.Schema(fields=["title"], attrs=[
            m.AttrDef("b", m.AttrType.BIGINT)]))
        for i in range(1, 5):
            t.insert(dict(id=i, title="word", b=20))
        t.commit()
        out = [t.update_attrs([2], {"b": 5_000_000_000})]
        for vals in ([5_000_000_000], [20, 5_000_000_001], [20]):
            out.append(summary(t.search(m.Q(
                match="word", filters=[m.F("b", "values", values=vals)]))))
        out.append(summary(t.search(m.Q(match="word", sort=[("b", False)]))))
        return out
    got = _both(scenario)
    assert got[1]["total_found"] == 0
    assert (2, ) in {(x[0],) for x in got[2]["matches"]}
    assert dict((x[0], x[2]["b"]) for x in got[2]["matches"])[2] == \
        5_000_000_000


def test_snapshot_drops_kills_as_jax_does(tmp_path):
    """A snapshot saves each segment's rows and its live documents but no
    kill-list: a row deleted or replaced before a FLUSH is alive again in
    the reloaded table, in the JAX package and in the port alike."""
    def scenario(m, tmp):
        d = str(tmp / "idx")
        t = _make_rt(m, d)
        for i in range(1, 5):
            t.insert(dict(id=i, title="apple", content="", gid=i))
        t.commit()
        t.delete([1])
        t.insert(dict(id=2, title="pear", content="", gid=20), replace=True)
        t.commit()
        out = [summary(t.search(m.Q(match="apple"))), state(t)]
        t.flush()
        t2 = _make_rt(m, d)
        return out + [summary(t2.search(m.Q(match="apple"))), state(t2)]
    got = _both(scenario, tmp_path)
    assert got[0]["total_found"] == 2 and got[2]["total_found"] == 4


def test_grouped_filter_first_after_update_matches_jax():
    """A MATCH-less GROUP BY under a narrow filter takes the filter-first
    plan, whose window comes from the attribute's sorted values. The JAX
    package plans such a query afresh each time; the port caches its
    group-by plans, and ``_reupload_attrs`` drops them, so after an
    UPDATE both read the window of the new values. (On fewer than 1,024
    rows the window covers every row, so the segment is larger.)"""
    def scenario(m, tmp):
        t = m.RtIndex("u", m.Schema(fields=["title"], attrs=[
            m.AttrDef("year", m.AttrType.UINT),
            m.AttrDef("g", m.AttrType.UINT)]))
        for i in range(1, 4001):
            t.insert(dict(id=i, title=f"w{i % 7} w{i % 11}",
                          year=2000 + i % 20, g=i % 5))
        t.commit()
        qs = [m.Q(match="", group_by="g", limit=15,
                  select=["count(*)", "sum(year)"], sort=[("g", True)],
                  filters=[m.F("year", "values", values=[2003])]),
              m.Q(match="", limit=15, ranker="none",
                  filters=[m.F("year", "values", values=[2003])])]
        out = [summary(t.search(q)) for q in qs]
        t.update_attrs(list(range(1, 4001, 2)), {"year": 2003})
        return out + [summary(t.search(q)) for q in qs]
    got = _both(scenario)
    assert [r["total_found"] for r in got] == [1, 200, 5, 2000]
    assert got[0]["matches"] != got[2]["matches"]


def test_rt_query_routes_match_jax():
    """``search_rt``'s other routes over several segments with kills: an
    expression late filter, PACKEDFACTORS() under the expression ranker,
    an explicit ORDER BY with an offset, a small max_matches, a JSON-path
    filter and GROUP BY, GROUP N BY and a bigint GROUP BY (host routes)."""
    def scenario(m, tmp):
        rng = np.random.RandomState(8)
        t = m.RtIndex("r", _stream_schema(m))
        for c in range(4):
            for i in range(25):
                t.insert(_stream_doc(rng, 1 + c * 25 + i))
            t.commit()
        t.delete([3, 30, 77])
        t.insert(_stream_doc(rng, 40), replace=True)
        t.commit()
        qs = [
            m.Q(match="alpha | beta", limit=10,
                filters=[m.F("year*2-score", "range_f", lo=4004, hi=4012)]),
            m.Q(match="gamma delta", limit=5,
                ranker=("expr", "sum(lcs*user_weight)*1000+bm25"),
                select=["id", "PACKEDFACTORS()"]),
            m.Q(match="alpha", offset=3, limit=6,
                sort=[("score", False), ("id", True)]),
            m.Q(match="beta", max_matches=7, limit=20),
            m.Q(match="", limit=20, filters=[m.F("meta.k", "values",
                                                 values=[1, 3])]),
            m.Q(match="", group_by="meta.k", select=["count(*)"], limit=10),
            m.Q(match="sigma", group_by="year", group_n=2,
                select=["count(*)"], limit=10, sort=[("year", True)]),
            m.Q(match="omega | kappa", group_by="big", select=["count(*)"],
                limit=10),
        ]
        return [summary(t.search(q)) for q in qs] + [state(t)]
    got = _both(scenario)
    assert all(r["error"] is None for r in got[:-1])
    assert all(r["total_found"] for r in got[:-1])
    assert "PACKEDFACTORS()" in got[1]["matches"][0][2]
