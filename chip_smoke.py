#!/usr/bin/env python3
"""Smoke run of the PyTorch port's search paths on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; each raises on a failure, so the exit code is then not 0. Every
path is driven through ``SearchIndex.search_batch`` on ``device="cuda"``
with the launch counters set to 0 just before and read just after, and
its results are held equal to the same queries on ``device="cpu"``.

1. Require CUDA. Print the card (``nvidia-smi`` name and power limit) and
   the torch and CUDA versions.
2. Build the CUDA kernels from ``manticoresearch_tpu_torch/csrc`` (timed).
3. The dense main path at 200k documents
   (``bench_corpus.build_corpus(200_000, 50_000, 100)``, the port's copy
   of ``bench.build_corpus``): one batch of 64 config-1 queries and one of
   64 config-2 queries, terms picked as ``bench_corpus.WorkloadGen`` picks
   them.
4. Check the grouped bit-plane decode kernel against its plain PyTorch
   version on the card: each batch's own work list (here and at 1M); one
   work list of every width class, with and without the prefix sum,
   windows of 1, 7 and the main path's number of blocks and one of 262144
   blocks, random words with bit 31 set and random bases; each class
   through the one-window wrappers; 2148 small windows, more than the
   kernel keeps in shared memory. Bit-exact. A misaligned window must
   raise.
5. Run both 200k batches: exactly one kernel launch per ``search_batch``,
   no plain decode.
6. Check the results: equal to the CPU port; the single-term queries' top
   10 equal to a host numpy model of the reference scoring (recall@10 =
   1.0, as ``bench.parity_recall_at_10``).
7. Time each batch warm (and once under ``torch.profiler``: device time,
   busy share, kernel launches), and the kernel against its plain version
   at the main path's shape (L2 flushed before each launch), at 65536 and
   at 262144 blocks of the main class (202 MB at c=16: beyond L2). The
   kernel's time is its device time from ``torch.profiler``; the bound is
   the bytes it must move over 3.35 TB/s.
8. Config 3 at 200k (dense plans): 64 queries of ``WorkloadGen.config3``
   (half ``"w1 w2"`` phrases, half ``"w1 w2"~5``, field weight
   content=3), and 64 of term pairs that stand adjacent (32 phrases) or
   within 5 positions (32 proximity queries) in a random document, read
   from the index's hit arrays (terms of at most 65536 documents), each of
   which must find a document: the
   kernel on each batch's work list, one launch per batch, equal to the
   CPU port, the count of queries that find something.
9. The 1M-document index (``build_corpus(1_000_000, 50_000, 100)``,
   bench.py's ``scale.1000k_docs`` corpus; build and upload times, device
   memory of the index):
   a. 64 config-1 and 64 config-2 queries: the planner's share of sparse
      (candidate-union) plans, one kernel launch per batch, equal to the
      CPU port, recall@10 = 1.0; the config-1 batch again with
      ``MT_SPARSE=never`` (dense plans) for the dense/sparse comparison;
   b. the two config-3 batches of phase 8 on this corpus: at least 0.9 of
      the plans sparse, one launch per batch, equal to the CPU port;
   c. 64 MATCH-less filter-first scans (``year`` ranges of 1-12 years or a
      ``group_id`` value set; ordered by weight, id or group_id): every
      plan has ``scan_index``, and no kernel launch;
   d. 64 single-term ``ranker=bm25`` queries on terms too frequent for the
      sparse union, under a one-value ``group_id`` filter: filter-first
      with a MATCH, one kernel launch per batch.
10. Every filter kind (MVA, id, bigint, JSON path) in one batch on a small
    index built with the port's ``IndexBuilder``, under ``MT_SPARSE`` auto
    and always: one launch where the batch reads packed windows, else
    none.
11. Every positional operator, limit and ranker of the port (phrase,
    proximity, NEAR / NOTNEAR and NEAR over a phrase and chains,
    SENTENCE, PARAGRAPH, ``@field``, ``@field[N]``, ``^word``, ``word$``,
    ZONE, ZONESPAN, wildcard merge groups, repeated keywords, the rankers
    wordcount and matchany, phrases under OR / NOT / MAYBE and a filter)
    in one batch on a 3,000-document index with ``html_strip``, zones,
    ``index_sp`` and ``min_prefix_len=1``, and 2-word phrases on its
    ``bigram_index`` twin, under ``MT_SPARSE`` auto and always: the same
    launch rule as phase 10, equal to the CPU port.
12. Config 4 at 200k (after phase 8, dense plans): the measured batch of
    ``WorkloadGen.config4(32)`` (``GROUP BY group_id``, ``count(*)``,
    ``sum(year)``, ``ORDER BY @count desc``, top 10), its twin with
    ``count(*), avg(year)`` (the ordered segment-sum kernel at full width),
    and a mixed batch of 16 config-4 and 16 config-2 queries: the share of
    dense plans, ``n_groups`` and ``found`` of a few queries, one
    bit-plane launch per batch, one segment-sum launch per float or AVG
    aggregate, results (aggregates included) equal to the CPU port. The
    same two config-4 batches at 1M (phase 9e), their sparse share printed.
13. Every group-by kind on a small index with float, string, bigint, MVA,
    JSON and timestamp attributes, under ``MT_SPARSE`` auto and always:
    every aggregate, group order and WITHIN GROUP ORDER BY kind,
    expression and string keys, the host routes (MVA, bigint and JSON-path
    keys, COUNT(DISTINCT id)), GROUP_CONCAT, HAVING, GROUP N BY, an
    expression late filter and ORDER BY a JSON path, in one batch: one
    bit-plane launch, equal to the CPU port.
14. The ordered segment-sum kernel against its plain version (on a CPU
    copy of the same inputs, where the plain version is defined):
    1-member groups, one group of 2^20 members, a run of ineligible
    entries into the sink, no eligible entry, order-dependent values
    (1e8, 1, -1e8 patterns), -0.0, and every call of the 200k and 1M
    config-4 AVG batches; bit-exact. Timed at each batch's calls (the
    kernels line takes the 1M batch's): device time (the three launches
    of one call), the bound (8 bytes per position read, 4 per group
    written, over 3.35 TB/s), the plain version on the host CPU and
    ``index_add_`` on the card (the library yardstick, timed here only).
Each batch of phases 5-13 prints its warm walls and one profiled run
(device time, busy share, kernel launches, host waits and copies).

The last three lines of standard output are one JSON object with the
kernels' numbers, the card's name and power limit, then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from dataclasses import replace

import numpy as np
import torch

from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.ops import _build
from manticoresearch_tpu_torch.ops import groupby as gb
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops.search import packed_windows, window_kinds
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

N_DOCS, VOCAB, AVG_LEN = 200_000, 50_000, 100
BIG_DOCS = 1_000_000       # bench.py's scale.1000k_docs
BATCH = 64
WARM_RUNS = 5
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, published peak
KERNEL_SOURCE = "manticoresearch_tpu_torch/csrc/bitplane_decode.cu"
KERNEL_REPLACES = "manticoresearch_tpu/ops/pfor.py:109"
KERNEL_EVENT = "bitplane_decode_grouped"
KERNEL_SMEM_ITEMS = 2048   # csrc/bitplane_decode.cu: kSmemItems
SEG_SOURCE = "manticoresearch_tpu_torch/csrc/segment_sum.cu"
SEG_REPLACES = "manticoresearch_tpu/ops/groupby.py:145"
SEG_EVENT = "seg_"         # its three kernels: seg_init, seg_bounds, seg_walk
C4_BATCH = 32              # bench.py's config-4 batch: 128 // 4
# segment-sum launches of each counted path (the bit-plane kernel's are in
# launches_by_path)
SEG_BY_PATH: dict = {}


# --------------------------------------------------------------------------
# workload: WorkloadGen's config 1 and 2
# --------------------------------------------------------------------------
def config1_queries(gen: bench_corpus.WorkloadGen,
                    n: int) -> list[SearchQuery]:
    """Single-term MATCH() BM25 top-10 (the measured twin of each draw)."""
    return [SearchQuery(match=gen.term()[1], limit=10) for _ in range(n)]


def config2_queries(gen: bench_corpus.WorkloadGen,
                    n: int) -> list[SearchQuery]:
    """Single term 40%, AND 30%, OR 20%, AND + year range filter 10%."""
    out = []
    for _ in range(n):
        r = gen.rng.rand()
        _w1, m1, c1 = gen.term()
        _w2, m2, _c2 = gen.term(avoid_class=c1)
        if r < 0.4:
            out.append(SearchQuery(match=m1, limit=10))
        elif r < 0.7:
            out.append(SearchQuery(match=f"{m1} {m2}", limit=10))
        elif r < 0.9:
            out.append(SearchQuery(match=f"{m1} | {m2}", limit=10))
        else:
            filt = [AttrFilterDef("year", "range_i", lo=2005, hi=2018)]
            out.append(SearchQuery(match=f"{m1} {m2}", filters=filt,
                                   limit=10))
    return out


def scan_queries(rng: np.random.RandomState, n: int) -> list[SearchQuery]:
    """MATCH-less filtered scans: a ``year`` range of 1-12 years or a set of
    1-5 ``group_id`` values within 40, ordered by weight, id or
    group_id."""
    sorts = [None, [("id", False)], [("group_id", True), ("id", True)],
             [("id", True)], [("group_id", False), ("id", True)]]
    out = []
    for i in range(n):
        if i % 2 == 0:
            span = 1 + rng.randint(12)
            y0 = 2000 + rng.randint(0, 25 - span + 1)
            filt = AttrFilterDef("year", "range_i", lo=y0, hi=y0 + span - 1)
        else:
            base = rng.randint(0, 60)
            vals = base + rng.choice(40, 1 + rng.randint(5), replace=False)
            filt = AttrFilterDef("group_id", "values",
                                 values=sorted(int(v) for v in vals))
        out.append(SearchQuery(match="", filters=[filt], limit=10,
                               sort=sorts[(i // 2) % len(sorts)]))
    return out


def ft_scan_queries(idx: SearchIndex, n: int) -> list[SearchQuery]:
    """Single-term ``ranker=bm25`` queries under a one-value ``group_id``
    filter, on the most frequent terms for which the planner picks the
    filter-first plan (their posting buckets are too large for the sparse
    union, and each df is at least 4x the filter's window)."""
    packed = idx.packed
    width = max(4, len(str(VOCAB - 1)))
    out = []
    for rank, t in enumerate(np.argsort(-packed.term_docs, kind="stable")):
        for g in (rank % 100, (rank * 37 + 11) % 100):
            q = SearchQuery(match=f"t{int(t):0{width}d}", ranker="bm25",
                            limit=10, filters=[AttrFilterDef(
                                "group_id", "values", values=[g])])
            if idx.plan(q).sig.scan_index:
                out.append(q)
        if len(out) >= n or rank > 4 * n:
            break
    return out[:n]


ATTR_DOCS = 4000
BIG_IDS = [(1 << 32) + 5, (1 << 33) + 17, (1 << 40) + 3]


def attr_index():
    """A small index with every attribute kind the filters read: uint, MVA
    (lists of 0-5 values), an MVA whose lists are all empty, bigint
    (negatives, values past 2^31), JSON, and document ids past 2^32."""
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    rng = np.random.RandomState(21)
    words = [f"w{i}" for i in range(30)]
    docs = []
    for i in range(1, ATTR_DOCS + 1):
        docs.append(dict(
            id=(BIG_IDS[i - ATTR_DOCS + 2] if i > ATTR_DOCS - 3
                else 100 + 3 * i),
            title=words[i % 30],
            body=" ".join(words[int(z) % 30] for z in rng.zipf(1.3, 10)),
            year=2000 + i % 20,
            tags=[int(x) for x in rng.randint(0, 40, rng.randint(0, 6))],
            etags=[],
            big=int(rng.choice([-1, 1]) * rng.randint(0, 2**40)),
            meta=json.dumps({"a": int(rng.randint(0, 50)),
                             "s": ["x", "y", "z"][i % 3]})))
    docs[5]["big"] = 2**31 + 7
    b = IndexBuilder(Schema(fields=["title", "body"],
                            attrs=[AttrDef("year", AttrType.UINT),
                                   AttrDef("tags", AttrType.MVA),
                                   AttrDef("etags", AttrType.MVA),
                                   AttrDef("big", AttrType.BIGINT),
                                   AttrDef("meta", AttrType.JSON)]))
    b.add_documents(docs)
    return b.build()


def filter_kind_queries() -> list[SearchQuery]:
    """One query per filter kind, with a MATCH and without."""
    f = AttrFilterDef
    sets = [
        [f("tags", "values", values=[3, 17])],                 # mva_any
        [f("tags", "values", values=[3, 17], exclude=True)],
        [f("tags", "mva_all", values=[1, 5])],
        [f("tags", "mva_subset", values=[1, 2, 3, 4, 5])],
        [f("tags", "range_i", lo=10, hi=20)],                  # mva_any_range
        [f("tags", "mva_all_range", lo=0, hi=25)],
        [f("etags", "values", values=[1], exclude=True)],      # empty MVA
        [f("id", "values", values=[103, BIG_IDS[0], BIG_IDS[2]])],
        [f("id", "range_i", lo=400, hi=2**33 + 17, exclude=True)],
        [f("big", "values", values=[2**31 + 7, 5])],
        [f("big", "range_i", lo=-(2**39), hi=2**31 + 7)],
        [f("meta.a", "range_i", lo=10, hi=30)],                # host_mask
        [f("meta.s", "values", values=["x"], exclude=True)],
        [f("year", "values", values=[2003]), f("tags", "range_i", hi=30)],
    ]
    return [SearchQuery(match=m, filters=fs, limit=20,
                        sort=[("big", False)] if m == "" else None)
            for fs in sets for m in ("w2 | w17", "")]


CONFIG3_WEIGHTS = {"content": 3}
# corpus-drawn pairs keep to terms of at most 65536 documents: two such
# slots stay within the sparse gate at 1M (B <= n_docs / 4), and neither
# corpus's batch meets the Zipf head's multi-million-hit slices
PAIR_MAX_DF = 1 << 16


def pair_queries(packed, rng: np.random.RandomState, n: int,
                 max_df: int | None = None) -> list[SearchQuery]:
    """n/2 phrases and n/2 ``~5`` proximity queries of two terms that stand
    adjacent (phrase) or within 5 positions (proximity) in a random
    document, read from the index's hit arrays: each finds a document."""
    def mk(pairs, tail):
        return [SearchQuery(match=f'"{a} {b}"{tail}', limit=10,
                            field_weights=CONFIG3_WEIGHTS) for a, b in pairs]
    return (mk(bench_corpus.positional_pairs(packed, rng, n // 2, 1, max_df),
               "")
            + mk(bench_corpus.positional_pairs(packed, rng, n - n // 2, 5,
                                               max_df), "~5"))


POS_DOCS = 3000


def positional_index(bigram: str = ""):
    """A small index for every positional operator and limit: two fields,
    ``html_strip`` with ``h1`` / ``em`` zones and paragraph tags,
    ``index_sp``, ``min_prefix_len=1`` (wildcards), a ``year`` attribute,
    optionally ``bigram_index``; 40 Zipf-drawn words, so that the frequent
    ones have packed slots (df >= 128)."""
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    from manticoresearch_tpu_torch.text.dictionary import DictSettings
    from manticoresearch_tpu_torch.text.tokenizer import TokenizerSettings
    rng = np.random.RandomState(31)
    words = [f"w{i}" for i in range(40)]

    def text(k):
        return " ".join(words[int(z) % 40] for z in rng.zipf(1.3, k))
    docs = [dict(id=i, title=text(4), year=2000 + i % 20,
                 body=(f"<h1>{text(3)}</h1> {text(6)}. {text(5)} "
                       f"<em>{text(2)}</em>.<p>{text(6)}. {text(4)}</p>"))
            for i in range(1, POS_DOCS + 1)]
    b = IndexBuilder(
        Schema(fields=["title", "body"],
               attrs=[AttrDef("year", AttrType.UINT)]),
        TokenizerSettings(html_strip=True, index_zones=("h1", "em"),
                          index_sp=True, bigram_index=bigram),
        DictSettings(min_prefix_len=1))
    b.add_documents(docs)
    return b.build()


def positional_kind_queries() -> list[SearchQuery]:
    """Every operator, limit and ranker of the positional slice."""
    year = [AttrFilterDef("year", "range_i", lo=2003, hi=2010)]
    kinds = [
        dict(match='"w1 w2"'), dict(match='"w1 w2 w1"'),
        dict(match='"w1 w3"~4'), dict(match="w1 NEAR/3 w2"),
        dict(match="w1 NOTNEAR/2 w5"), dict(match='"w1 w2" NEAR/4 w3'),
        dict(match="w1 NEAR/2 w2 NEAR/2 w3"), dict(match="w1 SENTENCE w4"),
        dict(match="w2 PARAGRAPH w6"), dict(match="@title w1"),
        dict(match="@title[2] w1"), dict(match="^w1"), dict(match="w2$"),
        dict(match="@body ^w3 w1"), dict(match="ZONE:h1 w1"),
        dict(match="ZONE:(h1,em) w2"), dict(match="ZONESPAN:h1 w1 w2"),
        dict(match="ZONESPAN:h1 w1 | w2"), dict(match="w1*"),
        dict(match="w1* w2"), dict(match="@title w2*"),
        dict(match="w1 w2 w1"), dict(match="w1 w2 w1", ranker="proximity"),
        dict(match="w1 w2", ranker="wordcount"),
        dict(match='"w1 w2" w3', ranker="wordcount"),
        dict(match="w1 | w3", ranker="matchany"),
        dict(match="w1 w2 w1", ranker="matchany"),
        dict(match='"w1 w2" | w7'), dict(match='"w1 w2" -w3'),
        dict(match='w4 MAYBE "w1 w2"'), dict(match='"w1 w2"', filters=year),
        dict(match='"w1 w2"', ranker="bm25"),
    ]
    return [SearchQuery(limit=20, **kw) for kw in kinds]


def bigram_queries() -> list[SearchQuery]:
    return [SearchQuery(match=m, limit=20) for m in
            ('"w1 w2"', '"w2 w3" | w4', '"w3 w1"~2', '"w1 w2" w5',
             '"w5 w1" -w2')]


def config4_batches(packed, seed: int, mixed: bool) -> dict:
    """WorkloadGen's measured config-4 batch, its twin with ``count(*),
    avg(year)``, and (``mixed``) 16 config-4 beside 16 config-2 queries."""
    gen = bench_corpus.WorkloadGen(np.random.RandomState(seed), VOCAB, packed)
    c4 = gen.config4(C4_BATCH)[1]
    out = {"config4": c4,
           "config4 avg": [replace(q, select=["count(*)", "avg(year)"])
                           for q in c4]}
    if mixed:
        half = C4_BATCH // 2
        out["config4 + config2"] = c4[:half] + config2_queries(gen, half)
    return out


def group_counts(idx: SearchIndex, q: SearchQuery) -> tuple[int, int]:
    """(n_groups, found) of one grouped query, from its program's output."""
    cq, gspec = idx._plan_grouped(q)[:2]
    out = idx._run_round([("group", cq, gspec)])[0]
    return out["n_groups"], out["found"]


GROUP_DOCS = 4000
GROUP_PRICES = np.asarray([1e8, 1.0, -1e8, 0.5, 3.25, -2.0, 1e-3, 7.0],
                          np.float32)


def group_index():
    """A small index for every group-by kind: uint ``g`` (40 groups) and
    ``year``, a float ``price`` whose sums depend on the add order, a
    string, a bigint, an MVA, JSON, a timestamp and ids past 2^32."""
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    rng = np.random.RandomState(23)
    words = [f"w{i}" for i in range(30)]
    docs = []
    for i in range(1, GROUP_DOCS + 1):
        docs.append(dict(
            id=100 + 3 * i if i <= GROUP_DOCS - 3 else (1 << 33) + i,
            title=words[i % 30],
            body=" ".join(words[int(z) % 30] for z in rng.zipf(1.3, 10)),
            g=int(rng.randint(0, 40)), year=2000 + i % 20,
            price=float(GROUP_PRICES[rng.randint(len(GROUP_PRICES))]),
            s=["red", "green", "blue", ""][i % 4],
            big=int(rng.choice([-1, 1]) * rng.randint(0, 2**40)),
            tags=[int(x) for x in rng.randint(0, 40, rng.randint(0, 6))],
            meta=json.dumps({"a": int(rng.randint(0, 50)),
                             "b": ["x", "y", "z"][i % 3]}),
            ts=int(rng.randint(0, 2**31 - 1))))
    b = IndexBuilder(Schema(fields=["title", "body"],
                            attrs=[AttrDef("g", AttrType.UINT),
                                   AttrDef("year", AttrType.UINT),
                                   AttrDef("price", AttrType.FLOAT),
                                   AttrDef("s", AttrType.STRING),
                                   AttrDef("big", AttrType.BIGINT),
                                   AttrDef("tags", AttrType.MVA),
                                   AttrDef("meta", AttrType.JSON),
                                   AttrDef("ts", AttrType.TIMESTAMP)]))
    b.add_documents(docs)
    return b.build()


GROUP_AGGS = ["count(*)", "sum(year)", "sum(price)", "avg(year)",
              "avg(price)", "min(price)", "max(price)", "min(year)",
              "max(year)", "count(distinct year)"]


def group_kind_queries() -> list[SearchQuery]:
    """Every aggregate, order, within kind, key kind and host route."""
    f = AttrFilterDef
    kinds = [
        dict(group_by="g", select=GROUP_AGGS),
        dict(group_by="g", select=GROUP_AGGS[:5], sort=[("@groupby", True)]),
        dict(group_by="g", select=["avg(price)"], sort=[("@count", False)]),
        dict(group_by="g", select=["sum(price)"], sort=[("@count", True)]),
        dict(group_by="g", select=["count(*)"], sort=[("id", False)]),
        dict(group_by="g", select=["avg(year)"], sort=[("year", False)]),
        dict(group_by="g", select=["count(*)"], sort=[("price", True)]),
        dict(group_by="g", select=["sum(price)"],
             within_sort=[("year", False)]),
        dict(group_by="g", select=["count(*)"],
             within_sort=[("price", True)]),
        dict(group_by="g", select=["count(*)", "*"],
             within_sort=[("id", False)]),
        dict(group_by="year * 3 - g", select=["count(*)"]),
        dict(group_by="year % 7", select=["avg(price)"]),
        dict(group_by="IF(price > 1, g, 100 + g)", select=["sum(price)"]),
        dict(group_by="g IN (1, 3, 5)", select=["count(*)"]),
        dict(group_by="INTERVAL(year, 2005, 2010, 2015)",
             select=["avg(year)"]),
        dict(group_by="MONTH(ts)", select=["count(*)"],
             sort=[("@count", False)]),
        dict(group_by="FIBONACCI(g)", select=["count(*)"]),
        dict(group_by="s", select=["count(*)", "avg(price)"]),
        dict(group_by="tags", select=["count(*)", "sum(year)"]),
        dict(group_by="big", select=["count(*)"]),
        dict(group_by="meta.a", select=["count(*)", "avg(year)"]),
        dict(group_by="g", select=["count(*)", "count(distinct id)"]),
        dict(group_by="g", select=["count(*)", "group_concat(year)"]),
        dict(group_by="g", select=["count(*)"], having=("count(*)", ">", 20)),
        dict(group_by="g", select=["count(*)"], group_n=2),
        dict(group_by="g", select=["count(*)"],
             filters=[f("year", "range_i", lo=2003, hi=2012)]),
        dict(filters=[f("year+1", "range_i", lo=2005, hi=2012)]),
        dict(sort=[("meta.a", True)]),
    ]
    return [SearchQuery(match="w1 | w3", limit=20, max_matches=GROUP_DOCS,
                        **kw) for kw in kinds]


def host_top10(idx: SearchIndex, term: str) -> list[tuple[int, int]]:
    """Host numpy model of the reference scoring for one term (the model
    of bench.parity_recall_at_10): bm25part = trunc((idf*tfq + 0.5)*1000),
    rank = sum of matched-field weights, weight = bm25part + rank*1000,
    ties docid asc."""
    packed = idx.packed
    tid = packed.term_id(term)
    if tid < 0:
        return []
    t0, t1 = int(packed.term_offsets[tid]), int(packed.term_offsets[tid + 1])
    rows = packed.post_rowid[t0:t1].astype(np.int64)
    tfq = packed.post_tfq[t0:t1].astype(np.float32)
    fm = packed.post_fieldmask[t0:t1]
    cq = idx.plan(SearchQuery(match=term, limit=10))
    idf = np.float32(np.asarray(cq.runtime["idf"])[0])
    fw = np.asarray(cq.runtime["field_weights"]).astype(np.int64)
    bm25part = np.trunc((idf * tfq + np.float32(0.5))
                        * np.float32(1000)).astype(np.int64)
    rank = np.zeros(len(rows), np.int64)
    for f in range(len(fw)):
        rank += np.where((fm >> f) & 1, fw[f], 0)
    w = bm25part + rank * 1000
    order = np.lexsort((rows, -w))[:10]
    return list(zip(packed.doc_ids[rows[order]].tolist(),
                    w[order].tolist()))


def _summary(r) -> tuple:
    return (r.error, r.total, r.total_found,
            [(m.docid, m.weight, m.attrs) for m in r.matches],
            [(w.word, w.docs, w.hits) for w in r.word_stats])


# --------------------------------------------------------------------------
# kernel checks and timing
# --------------------------------------------------------------------------
def _random_window(c: int, nb: int, prefix: bool, gen: torch.Generator):
    words = torch.randint(0, 2**32, (nb, ps.PLANE_WORDS * c), generator=gen,
                          dtype=torch.int64)
    words = ps.wrap_i32(words | (1 << 31)).cuda()
    base = None
    if prefix:
        base = ps.wrap_i32(torch.randint(0, 2**32, (nb,), generator=gen,
                                         dtype=torch.int64)).cuda()
    return words, base, c


def plain_grouped(items: list) -> torch.Tensor:
    """The plain PyTorch version of one grouped decode, on the items'
    device."""
    return torch.cat([ps.decode_words_ref(w, c) if b is None
                      else ps.decode_rowids_ref(w, b, c).reshape(-1, ps.BLOCK)
                      for w, b, c in items])


def check_batch_lists(batch_items: dict) -> int:
    """Grouped kernel vs plain version on each batch's own work list;
    returns the max abs error (must be 0)."""
    max_err = 0
    for name, items in batch_items.items():
        if not items:
            continue
        got = ps.decode_grouped(items)[0]
        want = plain_grouped(items)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"bitplane_decode on the {name} batch's "
                                 f"work list: kernel != plain version (max "
                                 f"abs err {err})")
        print(f"  grouped bitplane_decode, {name} batch's work list "
              f"({len(items)} windows): bit-exact")
    return max_err


def check_decode_kernel(nbs: list[int], big_c: int, big_nb: int,
                        batch_items: dict) -> int:
    """Grouped kernel vs plain version on the card; returns the max abs
    error (must be 0) over every window of a mixed work list, and over
    each main-path batch's own work list."""
    max_err = check_batch_lists(batch_items)
    gen = torch.Generator().manual_seed(1234)
    items = [_random_window(c, nb, prefix, gen)
             for c in ps.CLASSES for nb in nbs for prefix in (False, True)]
    items.append(_random_window(big_c, big_nb, True, gen))
    got, offsets = ps.decode_grouped(items)
    torch.cuda.synchronize()
    for i, (w, b, c) in enumerate(items):
        want = plain_grouped([(w, b, c)])
        part = got[offsets[i]:offsets[i + 1]]
        err = int((part.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(part, want):
            raise AssertionError(
                f"bitplane_decode window {i} c={c} nb={w.shape[0]} "
                f"prefix={b is not None}: kernel != plain version "
                f"(max abs err {err})")
    print(f"  grouped bitplane_decode: {len(items)} windows, "
          f"{int(offsets[-1])} blocks, classes {ps.CLASSES}, prefix on "
          f"and off, nb {sorted(set(nbs))} and {big_nb}: bit-exact")
    for c in ps.CLASSES:
        w, b, _ = _random_window(c, 7, True, gen)
        one_w = ps.decode_words(w, c)
        one_r = ps.decode_rowids(w, b, c)
        torch.cuda.synchronize()
        if not (torch.equal(one_w, ps.decode_words_ref(w, c)) and
                torch.equal(one_r, ps.decode_rowids_ref(w, b, c))):
            raise AssertionError(f"one-window decode c={c}: kernel != "
                                 "plain version")
    print("  one-window decode_words / decode_rowids, every class: "
          "bit-exact")
    # more windows than the kernel keeps in shared memory: the entry
    # search reads the work list from device memory instead
    many = [_random_window(ps.CLASSES[i % 4], 1 + i % 3, i % 2 == 0, gen)
            for i in range(KERNEL_SMEM_ITEMS + 100)]
    got = ps.decode_grouped(many)[0]
    want = plain_grouped(many)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"bitplane_decode on {len(many)} windows: "
                             "kernel != plain version")
    print(f"  grouped bitplane_decode: {len(many)} windows (beyond the "
          f"{KERNEL_SMEM_ITEMS} kept in shared memory): bit-exact")
    # a window whose words do not start at a multiple of 16 bytes
    flat = torch.zeros(1 + ps.PLANE_WORDS * 4, dtype=torch.int32,
                       device="cuda")
    try:
        ps.decode_grouped([(flat[1:].view(1, ps.PLANE_WORDS * 4), None, 4)])
    except ValueError:
        print("  a misaligned window raises ValueError")
    else:
        raise AssertionError("a misaligned window was decoded")
    return max_err


def decode_bytes(items: list) -> int:
    """Bytes one grouped decode must move: each window's words (and bases)
    read once, every output block written once, the work list read once."""
    total = 0
    for w, b, c in items:
        nb = w.shape[0]
        total += nb * (ps.PLANE_WORDS * c * 4 + ps.BLOCK * 4)
        if b is not None:
            total += nb * 4
    return total + 32 * len(items)


def _event_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_device_ms(items: list, iters: int, flush: bool) -> float:
    """Device time of one grouped launch (torch.profiler), optionally with
    the L2 cache flushed by a 64 MB write before each launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ps.decode_grouped(items)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush:
                scrub.fill_(1)
            ps.decode_grouped(items)
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and KERNEL_EVENT in e.name]
    if not us or min(us) <= 0:
        raise AssertionError(f"the profiler saw no {KERNEL_EVENT} launches "
                             "on the device")
    return sum(us) / len(us) / 1e3


def time_decode(name: str, items: list, iters: int, flush: bool) -> dict:
    """Kernel device time, per-call times of the wrapper and of the plain
    version (CUDA events over back-to-back calls, in turns plain, kernel,
    kernel, plain), bytes and bound."""
    byts = decode_bytes(items)
    for fn in (lambda: ps.decode_grouped(items), lambda: plain_grouped(items)):
        fn()
    torch.cuda.synchronize()
    p1 = _event_ms(lambda: plain_grouped(items), max(iters // 4, 3))
    k1 = _event_ms(lambda: ps.decode_grouped(items), iters)
    k2 = _event_ms(lambda: ps.decode_grouped(items), iters)
    p2 = _event_ms(lambda: plain_grouped(items), max(iters // 4, 3))
    dev_ms = kernel_device_ms(items, iters, flush)
    bound_ms = byts / HBM_BYTES_PER_S * 1e3
    blocks = sum(w.shape[0] for w, _, _ in items)
    r = dict(ms=dev_ms, call_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
             bound_ms=bound_ms, bytes=byts, blocks=blocks)
    print(f"  K1 {name}: {len(items)} windows, {blocks} blocks, "
          f"{byts / 1e6:.3f} MB: device {dev_ms * 1e3:.2f} us "
          f"({byts / (dev_ms * 1e-3) / 1e9:.0f} GB/s, "
          f"{bound_ms / dev_ms:.3f} of the bound {bound_ms * 1e3:.2f} us); "
          f"per call {r['call_ms'] * 1e3:.2f} us; plain "
          f"{r['plain_ms'] * 1e3:.2f} us"
          f"{'; L2 flushed before each launch' if flush else ''}")
    return r


def profile_batch(idx: SearchIndex, queries: list[SearchQuery]) -> dict:
    """One warm batch under torch.profiler: its wall time, the device time
    of every kernel and copy in it (one stream, so they do not overlap),
    the device busy share, the kernel launches, the host's waits on the
    device and its copies (CUDA runtime calls by name), K1's device time
    and events, and the device ops that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.search_batch(queries)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    k1 = [e.time_range.elapsed_us() for e in on_device
          if KERNEL_EVENT in e.name]
    launches = sum(1 for e in events
                   if e.name.startswith("cudaLaunchKernel"))
    waits = Counter(e.name for e in events if "Synchronize" in e.name
                    or e.name.startswith("cudaMemcpy"))
    by_name: dict = {}
    for e in on_device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    return dict(wall_ms=wall_ms, device_ms=dev_ms,
                busy=dev_ms / wall_ms, launches=launches,
                k1_ms=sum(k1) / 1e3, k1_events=len(k1), waits=dict(waits),
                top=[(name[:70], n, round(us / 1e3, 3))
                     for name, (n, us) in top])


def program_plan(idx: SearchIndex, q: SearchQuery):
    """The plan of a query's program (its group-by plan where it groups),
    or None where planning refuses it (a late filter's expression: its
    window query runs the same MATCH)."""
    try:
        return idx._plan_grouped(q)[0] if q.group_by else idx.plan(q)
    except (ValueError, NotImplementedError):
        return None


def reads_packed(idx: SearchIndex, queries: list[SearchQuery]) -> bool:
    """Whether any of the queries' programs reads a packed window."""
    return any(cq is not None and window_kinds(cq.sig)
               for cq in (program_plan(idx, q) for q in queries))


def float_aggregates(idx: SearchIndex, queries: list[SearchQuery]) -> int:
    """Float SUM and AVG aggregates of the device-grouped queries: each
    takes one segment-sum launch."""
    return sum(a.kind == "avg" or (a.is_float and a.kind == "sum")
               for q in queries if q.group_by
               for a in idx._plan_grouped(q)[1].aggs)


def run_counted(name: str, idx: SearchIndex, queries: list[SearchQuery],
                launches_by_path: dict,
                want_seg: int | None = 0) -> tuple[list, float]:
    """Drive one ``search_batch`` with the launch counters set to 0 just
    before and read just after: exactly one bit-plane launch where the
    batch reads packed windows, else none, ``want_seg`` segment-sum
    launches (any number when None), and never a plain version."""
    want = 1 if reads_packed(idx, queries) else 0
    torch.cuda.synchronize()
    ps.LAUNCHES.reset()
    gb.LAUNCHES.reset()
    t0 = time.perf_counter()
    results = idx.search_batch(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = ps.LAUNCHES.kernel, ps.LAUNCHES.plain
    seg, seg_plain = gb.LAUNCHES.kernel, gb.LAUNCHES.plain
    launches_by_path[name] = launches
    if seg or want_seg:
        SEG_BY_PATH[name] = seg
    print(f"{name}: bitplane_decode launches {launches} (expected {want}), "
          f"{ps.LAUNCHES.blocks} blocks, plain decodes {plain}; "
          f"segment_sum_ordered launches {seg} (expected "
          f"{'any' if want_seg is None else want_seg}), "
          f"{gb.LAUNCHES.positions} positions; first run "
          f"{wall * 1e3:.1f} ms")
    if launches != want or plain != 0:
        raise AssertionError(f"{name}: {launches} kernel launches and "
                             f"{plain} plain decodes, expected {want} and 0")
    if seg_plain or (want_seg is not None and seg != want_seg):
        raise AssertionError(f"{name}: {seg} segment-sum launches and "
                             f"{seg_plain} plain sums, expected {want_seg} "
                             "and 0")
    return results, wall


def check_equal(name: str, queries: list, got: list, want: list) -> None:
    for q, g, w in zip(queries, got, want):
        if g.error is not None or w.error is not None:
            raise AssertionError(f"{name} {q.match!r} {q.group_by}: error "
                                 f"{g.error or w.error}")
        if _summary(g) != _summary(w):
            raise AssertionError(f"{name} {q.match!r} {q.filters} "
                                 f"{q.group_by} {q.select}: cuda result "
                                 f"{_summary(g)} != cpu {_summary(w)}")
    found = [r.total_found for r in got]
    print(f"{name}: {len(queries)} queries equal on cuda and cpu; "
          f"total_found min/median/max {min(found)}/"
          f"{int(np.median(found))}/{max(found)}")


def recall_at_10(name: str, idx: SearchIndex, queries: list,
                 results: list) -> None:
    """recall@10 of the single-term queries against the host model."""
    n_single, recall = 0, 0.0
    for q, g in zip(queries, results):
        if " " not in q.match and not q.filters:
            model = host_top10(idx, q.match)
            got = [(m.docid, m.weight) for m in g.matches]
            recall += (sum(1 for x in got if x in model)
                       / max(len(model), len(got), 1))
            n_single += 1
    recall /= max(n_single, 1)
    print(f"{name}: recall@10 vs the host model over {n_single} single-term "
          f"queries: {recall}")
    if recall != 1.0:
        raise AssertionError(f"{name}: recall@10 {recall} != 1.0")


def time_batch(name: str, idx: SearchIndex, queries: list,
               runs: int) -> dict:
    """Warm walls of one batch, then one warm run under the profiler."""
    warm = []
    for _ in range(runs):
        t0 = time.perf_counter()
        idx.search_batch(queries)
        torch.cuda.synchronize()
        warm.append(round((time.perf_counter() - t0) * 1e3, 2))
    prof = profile_batch(idx, queries)
    print(f"{name}: batch of {len(queries)} on cuda, warm runs (ms) {warm}")
    print(f"{name}: one warm batch under the profiler: wall "
          f"{prof['wall_ms']:.2f} ms, device time {prof['device_ms']:.3f} ms "
          f"(busy share {prof['busy']:.3f}), {prof['launches']} kernel "
          f"launches, K1 {prof['k1_ms'] * 1e3:.2f} us in "
          f"{prof['k1_events']} events")
    print(f"{name}: top device ops (name, count, ms): {prof['top']}")
    print(f"{name}: host waits and copies: {prof['waits']}")
    return dict(warm_ms=warm, **prof)


def compare_sparse_dense(name: str, idx: SearchIndex, queries: list,
                         runs: int) -> None:
    """Warm walls of one batch on the planner's sparse plans and on dense
    plans (``MT_SPARSE=never``), in turns sparse, dense, dense, sparse;
    each turn starts with one unmeasured run that plans the batch."""
    walls: dict = {"auto": [], "never": []}
    for mode in ("auto", "never", "never", "auto"):
        set_sparse_mode(mode, idx)
        idx.search_batch(queries)
        torch.cuda.synchronize()
        for _ in range(runs):
            t0 = time.perf_counter()
            idx.search_batch(queries)
            torch.cuda.synchronize()
            walls[mode].append(round((time.perf_counter() - t0) * 1e3, 2))
    set_sparse_mode("auto", idx)
    print(f"{name}: warm walls in turns sparse, dense, dense, sparse (ms): "
          f"sparse {walls['auto']}, dense {walls['never']}; medians "
          f"{np.median(walls['auto']):.2f} and "
          f"{np.median(walls['never']):.2f}")


def config3_phase(tag: str, gpu: SearchIndex, cpu: SearchIndex,
                  batches: dict, launches_by_path: dict, runs: int,
                  min_sparse: float | None) -> int:
    """The config-3 batches on one corpus: plan kinds and the share of
    sparse plans (0 when ``min_sparse`` is None, else at least it), K1 on
    each batch's work list, one counted ``search_batch`` with exactly one
    K1 launch, results equal to the CPU port, the count of queries that
    find a document (all, for the corpus-drawn pairs), timing. Returns the
    K1 max abs error."""
    data = gpu.device.data_pytree()
    max_err = 0
    for name, qs in batches.items():
        path = f"{tag} {name}"
        cqs = [gpu.plan(q) for q in qs]
        share = sum(cq.sig.sparse for cq in cqs) / len(cqs)
        print(f"{path}: plans {dict(Counter(cq.sig.expr[0] for cq in cqs))}"
              f", sparse share {share:.3f}, packed slots "
              f"{sum(bool(p[0]) for cq in cqs for p in cq.sig.slot_packed)}"
              f" of {sum(cq.sig.n_slots for cq in cqs)}")
        if (share > 0) if min_sparse is None else (share < min_sparse):
            raise AssertionError(f"{path}: sparse share {share:.3f}")
        if not reads_packed(gpu, qs):
            raise AssertionError(f"{path}: no packed window on the path")
        max_err = max(max_err, check_batch_lists({path: [
            w for cq in cqs
            for w in packed_windows(cq.sig, cq.slot_pb, data, cq.runtime)]}))
        res, _ = run_counted(path, gpu, qs, launches_by_path)
        check_equal(path, qs, res, cpu.search_batch(qs))
        found = sum(r.total_found > 0 for r in res)
        print(f"{path}: {found} of {len(qs)} queries find a document")
        if name == "corpus pairs" and found != len(qs):
            raise AssertionError(f"{path}: a corpus-drawn pair found nothing")
        time_batch(path, gpu, qs, runs)
    return max_err


def config4_phase(tag: str, gpu: SearchIndex, cpu: SearchIndex,
                  batches: dict, launches_by_path: dict, runs: int,
                  dense: bool) -> None:
    """The config-4 batches on one corpus: the share of dense and sparse
    group-by plans (all dense when ``dense``), ``n_groups`` and ``found``
    of a few queries, one counted ``search_batch`` with one bit-plane
    launch and one segment-sum launch per float or AVG aggregate, results
    equal to the CPU port, timing."""
    for name, qs in batches.items():
        path = f"{tag} {name}"
        cqs = [program_plan(gpu, q) for q in qs if q.group_by]
        share = sum(cq.sig.sparse for cq in cqs) / len(cqs)
        print(f"{path}: {len(cqs)} group-by plans, dense share "
              f"{1 - share:.3f}, sparse share {share:.3f}")
        if dense and share > 0:
            raise AssertionError(f"{path}: a group-by plan is not dense")
        counts = [group_counts(gpu, q) for q in qs[:4] if q.group_by]
        print(f"{path}: (n_groups, found) of the first queries {counts}")
        res, _ = run_counted(path, gpu, qs, launches_by_path,
                             want_seg=float_aggregates(gpu, qs))
        check_equal(path, qs, res, cpu.search_batch(qs))
        time_batch(path, gpu, qs, runs)


def capture_segment_calls(idx: SearchIndex, queries: list) -> list:
    """The (values, gid, n_out) of every segment sum one search_batch
    makes (copies), in call order."""
    calls = []
    original = gb.segment_sum_ordered

    def record(values, gid, n_out):
        calls.append((values.clone(), gid.clone(), n_out))
        return original(values, gid, n_out)
    gb.segment_sum_ordered = record
    try:
        idx.search_batch(queries)
    finally:
        gb.segment_sum_ordered = original
    torch.cuda.synchronize()
    return calls


def segment_cases() -> list:
    """(name, values f32, gid int32, n_out) numpy inputs for the segment
    kernel's checks."""
    f32, i32 = np.float32, np.int32
    rng = np.random.RandomState(5)
    n = 1 << 20
    big = (rng.randn(n) * 10.0 ** rng.randint(-3, 9, n)).astype(f32)
    runs = np.sort(rng.randint(0, 100, 300_000)).astype(i32)
    sink_n = 700_000
    pattern = np.tile(np.asarray([1e8, 1, -1e8, 1], f32), 50_000)
    negz = np.where(rng.rand(200_000) < 0.5, f32(-0.0),
                    rng.randn(200_000).astype(f32))
    negz[:1000] = -0.0
    return [
        ("1-member groups", rng.randn(100_000).astype(f32),
         np.arange(100_000, dtype=i32), 100_000),
        ("one group of 2^20 members", big, np.zeros(n, i32), n),
        ("groups then a sink run of ineligible entries",
         np.concatenate([rng.randn(300_000).astype(f32) * 1000,
                         np.zeros(sink_n, f32)]),
         np.concatenate([runs, np.full(sink_n, 999_999, i32)]), 1_000_000),
        ("no eligible entry", np.zeros(n, f32), np.full(n, n - 1, i32), n),
        ("1e8, 1, -1e8, 1 patterns", pattern,
         np.repeat(np.arange(1000, dtype=i32), 200), 1000),
        ("-0.0 values", negz, np.repeat(np.arange(2000, dtype=i32), 100),
         2000),
    ]


def check_segment_kernel(captured: list) -> float:
    """Kernel vs plain version, bit-exact, on the cases above and on
    every captured call of the main path; returns the max abs error."""
    max_err = 0.0
    items = [(name, torch.from_numpy(v), torch.from_numpy(g), n)
             for name, v, g, n in segment_cases()]
    items += [(f"main-path call {i}", v.cpu(), g.cpu(), n)
              for i, (v, g, n) in enumerate(captured)]
    for name, v, g, n in items:
        got = gb.segment_sum_ordered(v.cuda(), g.cuda(), n).cpu()
        want = gb.segment_sum_plain(v, g, n)
        err = float((got.double() - want.double()).abs().max()) if n else 0.0
        max_err = max(max_err, err)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"segment_sum_ordered {name}: kernel != "
                                 f"plain version (max abs err {err})")
    print(f"  segment_sum_ordered: {len(items) - len(captured)} cases and "
          f"{len(captured)} main-path calls: bit-exact")
    try:
        gb.segment_sum_ordered(torch.zeros(4, device="cuda"),
                               torch.zeros(4, dtype=torch.int64,
                                           device="cuda"), 4)
    except ValueError:
        print("  int64 group ids raise ValueError")
    else:
        raise AssertionError("segment_sum_ordered took int64 group ids")
    return max_err


def time_segment(name: str, calls: list, iters: int) -> dict:
    """Per-call times over one batch's captured calls: the kernel's
    device time (its three launches, torch.profiler), the wrapper's call
    time (CUDA events, in turns library, kernel, kernel, library),
    ``index_add_`` on the card, the plain version on the host CPU, and
    the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    lib_in = [(v, g.long(), n) for v, g, n in calls]
    cpu_in = [(v.cpu(), g.cpu(), n) for v, g, n in calls]

    def kernel():
        for v, g, n in calls:
            gb.segment_sum_ordered(v, g, n)

    def library():
        for v, g, n in lib_in:
            torch.zeros(n, dtype=torch.float32, device="cuda").index_add_(
                0, g, v)
    kernel()
    library()
    torch.cuda.synchronize()
    lib1 = _event_ms(library, iters)
    k1 = _event_ms(kernel, iters)
    k2 = _event_ms(kernel, iters)
    lib2 = _event_ms(library, iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kernel()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and SEG_EVENT in e.name)
    if us <= 0:
        raise AssertionError("the profiler saw no segment-sum kernels")
    t0 = time.perf_counter()
    for v, g, n in cpu_in:
        gb.segment_sum_plain(v, g, n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_calls = len(calls)
    byts = sum(8 * v.numel() + 4 * n for v, g, n in calls) / n_calls
    r = dict(ms=us / 1e3 / iters / n_calls, call_ms=(k1 + k2) / 2 / n_calls,
             library_ms=(lib1 + lib2) / 2 / n_calls,
             plain_ms=plain_ms / n_calls,
             bound_ms=byts / HBM_BYTES_PER_S * 1e3, bytes=byts)
    positions = [v.numel() for v, _, _ in calls]
    print(f"  segment_sum_ordered {name}: {n_calls} calls of "
          f"{min(positions)}-{max(positions)} positions; per call: device "
          f"{r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f} us, "
          f"{r['bytes'] / 1e6:.3f} MB), wrapper {r['call_ms'] * 1e3:.2f} us, "
          f"index_add_ on the card {r['library_ms'] * 1e3:.2f} us, plain "
          f"version on the host CPU {r['plain_ms'] * 1e3:.2f} us")
    return r


def set_sparse_mode(mode: str, *indexes: SearchIndex) -> None:
    """The planner's MT_SPARSE override; cached plans are dropped."""
    os.environ["MT_SPARSE"] = mode
    for idx in indexes:
        idx._plan_cache.clear()


def index_bytes(idx: SearchIndex) -> int:
    total = 0
    for v in idx.device.data_pytree().values():
        for t in (v.values() if isinstance(v, dict) else [v]):
            total += t.numel() * t.element_size()
    return total


def since(t_start: float) -> str:
    return f"[{time.perf_counter() - t_start:.0f} s]"


# --------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build (nvcc) and load: {time.perf_counter() - t0:.2f} s")

    # 3. corpus, indexes, plans
    t0 = time.perf_counter()
    packed = bench_corpus.build_corpus(N_DOCS, VOCAB, AVG_LEN)
    print(f"corpus: {packed.n_docs} docs, {packed.n_postings} postings, "
          f"{len(packed.hit_packed)} hits, built in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gpu = SearchIndex(packed, device="cuda")
    cpu = SearchIndex(packed, device="cpu")
    torch.cuda.synchronize()
    print(f"upload (cuda + cpu): {time.perf_counter() - t0:.1f} s")
    gen = bench_corpus.WorkloadGen(np.random.RandomState(7), VOCAB, packed)
    batches = {"config1": config1_queries(gen, BATCH),
               "config2": config2_queries(gen, BATCH)}
    plans = {name: [gpu.plan(q) for q in qs] for name, qs in batches.items()}
    all_plans = [cq for cqs in plans.values() for cq in cqs]
    rankers = Counter(cq.sig.ranker for cq in all_plans)
    if set(rankers) != {"ws_bm25", "proximity_bm25"}:
        raise AssertionError(f"unexpected effective rankers {rankers}")
    if any(cq.sig.sparse for cq in all_plans):
        raise AssertionError("a 200k-document plan is not dense")
    slot_blocks = Counter(
        (cq.sig.slot_packed[s][0], cq.slot_pb[s] // ps.BLOCK)
        for cq in all_plans for s in range(cq.sig.n_slots)
        if cq.sig.slot_packed[s][0])
    if not slot_blocks:
        raise AssertionError("no packed term slot on the main path")
    (main_c, main_nb), _ = slot_blocks.most_common(1)[0]
    print(f"plans: rankers {dict(rankers)}; packed slots by "
          f"(rowid class, blocks): {dict(slot_blocks)}")
    data = gpu.device.data_pytree()
    batch_items = {name: [w for cq in cqs for w in packed_windows(
        cq.sig, cq.slot_pb, data, cq.runtime)] for name, cqs in plans.items()}
    for name, items in batch_items.items():
        nb = sum(w.shape[0] for w, _, _ in items)
        print(f"{name}: one grouped decode of {len(items)} windows, {nb} "
              f"blocks, output buffer {nb * 512 / 2**20:.2f} MiB")

    # 4. kernel vs plain version
    big_nb = 1 << 18
    max_err = check_decode_kernel(sorted({1, 7, main_nb}), main_c, big_nb,
                                  batch_items)

    # 5. the dense main path on the card, counted
    launches_by_path: dict = {}
    gpu_results = {}
    peak = {}
    for name, qs in batches.items():
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        gpu_results[name], _ = run_counted(f"200k {name}", gpu, qs,
                                           launches_by_path)
        peak[name] = torch.cuda.max_memory_allocated() - base_mem
    print(f"peak device memory above the index per batch (MiB): "
          f"{ {k: round(v / 2**20, 2) for k, v in peak.items()} }")

    # 6. results: equal to the CPU port, recall@10 vs the host model
    for name, qs in batches.items():
        check_equal(f"200k {name}", qs, gpu_results[name],
                    cpu.search_batch(qs))
    recall_at_10("200k", gpu, [q for qs in batches.values() for q in qs],
                 [r for rs in gpu_results.values() for r in rs])

    # 7. timing
    for name, qs in batches.items():
        time_batch(f"200k {name}", gpu, qs, WARM_RUNS)
    main = time_decode("main path (config-2 batch)", batch_items["config2"],
                       iters=100, flush=True)
    time_decode("main path (config-1 batch)", batch_items["config1"],
                iters=100, flush=True)
    gen = torch.Generator().manual_seed(7)
    time_decode(f"c={main_c} 65536 blocks rowids",
                [_random_window(main_c, 1 << 16, True, gen)], iters=50,
                flush=True)
    time_decode(f"c={main_c} {big_nb} blocks rowids (beyond L2)",
                [_random_window(main_c, big_nb, True, gen)], iters=20,
                flush=False)

    # 8. config 3 at 200k: WorkloadGen's phrases / ~5 proximity, and pairs
    # drawn from the corpus that must each find a document; dense plans
    # (WorkloadGen.config3 returns warm-up and measured twins: the latter)
    c3 = {"config3": bench_corpus.WorkloadGen(
              np.random.RandomState(17), VOCAB, packed).config3(BATCH)[1],
          "corpus pairs": pair_queries(packed, np.random.RandomState(18),
                                       BATCH, PAIR_MAX_DF)}
    max_err = max(max_err, config3_phase("200k", gpu, cpu, c3,
                                         launches_by_path, 3, None))

    # 12. config 4 at 200k: GROUP BY group_id with count(*) and sum(year),
    # its avg(year) twin, and a batch mixed with config 2; dense plans
    c4 = config4_batches(packed, 21, True)
    config4_phase("200k", gpu, cpu, c4, launches_by_path, 3, dense=True)
    seg_calls_dense = capture_segment_calls(gpu, c4["config4 avg"])
    del gpu, cpu, packed, data, batch_items, plans, all_plans
    torch.cuda.empty_cache()
    print(f"{since(t_start)} 200k phases done")

    # 9. the large index: sparse union and filter-first plans
    n_big = BIG_DOCS
    tag = f"{n_big // 1000}k"
    t0 = time.perf_counter()
    big = bench_corpus.build_corpus(n_big, VOCAB, AVG_LEN)
    print(f"{tag} corpus: {big.n_docs} docs, {big.n_postings} postings, "
          f"{len(big.hit_packed)} hits, built in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    big.packed_store()
    print(f"{tag} packed store built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gpu = SearchIndex(big, device="cuda")
    torch.cuda.synchronize()
    print(f"{tag} upload to cuda: {time.perf_counter() - t0:.1f} s; device "
          f"memory of the index {index_bytes(gpu) / 2**30:.3f} GiB "
          f"(allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB)")
    t0 = time.perf_counter()
    cpu = SearchIndex(big, device="cpu")
    print(f"{tag} upload to cpu: {time.perf_counter() - t0:.1f} s")
    set_sparse_mode("auto", gpu, cpu)

    # 9a. config 1 and 2
    gen = bench_corpus.WorkloadGen(np.random.RandomState(8), VOCAB, big)
    big_batches = {"config1": config1_queries(gen, BATCH),
                   "config2": config2_queries(gen, BATCH)}
    data = gpu.device.data_pytree()
    big_items = {}
    for name, qs in big_batches.items():
        cqs = [gpu.plan(q) for q in qs]
        share = sum(cq.sig.sparse for cq in cqs) / len(cqs)
        sizes = [int(sum(cq.slot_pb)) for cq in cqs if cq.sig.sparse]
        print(f"{tag} {name}: sparse plans {share:.3f} of {len(cqs)}; "
              f"candidate buckets min/median/max {min(sizes, default=0)}/"
              f"{int(np.median(sizes)) if sizes else 0}/"
              f"{max(sizes, default=0)}")
        if share < 0.9:
            raise AssertionError(f"{tag} {name}: only {share:.3f} of the "
                                 "plans are sparse")
        big_items[f"{tag} {name}"] = [w for cq in cqs for w in packed_windows(
            cq.sig, cq.slot_pb, data, cq.runtime)]
    max_err = max(max_err, check_batch_lists(big_items))
    for name, qs in big_batches.items():
        res, _ = run_counted(f"{tag} {name}", gpu, qs, launches_by_path)
        check_equal(f"{tag} {name}", qs, res, cpu.search_batch(qs))
        recall_at_10(f"{tag} {name}", gpu, qs, res)
        time_batch(f"{tag} {name}", gpu, qs, 3)
    set_sparse_mode("never", gpu)
    if any(gpu.plan(q).sig.sparse for q in big_batches["config1"]):
        raise AssertionError("MT_SPARSE=never gave a sparse plan")
    run_counted(f"{tag} config1 dense (MT_SPARSE=never)", gpu,
                big_batches["config1"], launches_by_path)
    time_batch(f"{tag} config1 dense (MT_SPARSE=never)", gpu,
               big_batches["config1"], 3)
    set_sparse_mode("auto", gpu)
    for name, qs in big_batches.items():
        compare_sparse_dense(f"{tag} {name}", gpu, qs, 3)
    print(f"{since(t_start)} {tag} config 1/2 done")

    # 9b. config 3 at 1M: the same two kinds of batch, sparse plans
    c3 = {"config3": bench_corpus.WorkloadGen(
              np.random.RandomState(19), VOCAB, big).config3(BATCH)[1],
          "corpus pairs": pair_queries(big, np.random.RandomState(20), BATCH,
                                       PAIR_MAX_DF)}
    max_err = max(max_err, config3_phase(tag, gpu, cpu, c3,
                                         launches_by_path, 3, 0.9))
    print(f"{since(t_start)} {tag} config 3 done")

    # 9c, 9d. filter-first: MATCH-less scans, single terms under a filter
    scans = scan_queries(np.random.RandomState(9), BATCH)
    ft = ft_scan_queries(gpu, BATCH)
    if len(ft) < BATCH:
        raise AssertionError(f"only {len(ft)} filter-first term queries")
    for name, qs in ((f"{tag} filter-first scans", scans),
                     (f"{tag} filter-first bm25", ft)):
        cqs = [gpu.plan(q) for q in qs]
        if not all(cq.sig.scan_index and cq.sig.sparse for cq in cqs):
            raise AssertionError(f"{name}: a plan is not filter-first")
        print(f"{name}: candidate buckets "
              f"{dict(Counter(cq.sig.scan_bucket for cq in cqs))}")
        items = {name: [w for cq in cqs for w in packed_windows(
            cq.sig, cq.slot_pb, data, cq.runtime)]}
        max_err = max(max_err, check_batch_lists(items))
        res, _ = run_counted(name, gpu, qs, launches_by_path)
        check_equal(name, qs, res, cpu.search_batch(qs))
        time_batch(name, gpu, qs, 3)
    time_decode(f"{tag} config-1 batch", big_items[f"{tag} config1"],
                iters=50, flush=True)

    # 9e. config 4 at 1M: the same two config-4 batches; the segment sums
    # of the AVG batch are kept for phase 14
    c4 = config4_batches(big, 22, False)
    config4_phase(tag, gpu, cpu, c4, launches_by_path, 3, dense=False)
    seg_calls = capture_segment_calls(gpu, c4["config4 avg"])
    print(f"{since(t_start)} {tag} config 4 done")
    del gpu, cpu, big, data, big_items
    torch.cuda.empty_cache()
    print(f"{since(t_start)} {tag} filter-first done")

    # 10. every filter kind on a small index, MT_SPARSE auto and always
    t0 = time.perf_counter()
    small = attr_index()
    gpu = SearchIndex(small, device="cuda")
    cpu = SearchIndex(small, device="cpu")
    print(f"attribute index: {small.n_docs} docs built and uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    qs = filter_kind_queries()
    for mode in ("auto", "always"):
        set_sparse_mode(mode, gpu, cpu)
        cqs = [gpu.plan(q) for q in qs]
        kinds = Counter(spec.kind for cq in cqs for spec in cq.sig.filters)
        spaces = Counter("filter-first" if cq.sig.scan_index else
                         "sparse" if cq.sig.sparse else "dense" for cq in cqs)
        print(f"filter kinds, MT_SPARSE={mode}: {dict(kinds)}; plans "
              f"{dict(spaces)}")
        if mode == "always" and not all(
                cq.sig.sparse for q, cq in zip(qs, cqs) if q.match):
            raise AssertionError("MT_SPARSE=always left a MATCH dense")
        name = f"filter kinds ({mode})"
        res, _ = run_counted(name, gpu, qs, launches_by_path)
        check_equal(name, qs, res, cpu.search_batch(qs))
        time_batch(name, gpu, qs, 3)
    set_sparse_mode("auto", gpu, cpu)
    print(f"{since(t_start)} filter kinds done")

    # 11. every positional operator, limit and ranker on a small index,
    # and 2-word phrases on its bigram_index twin, MT_SPARSE auto and always
    for variant, bigram, qs in (("positional kinds", "",
                                 positional_kind_queries()),
                                ("bigram phrases", "all", bigram_queries())):
        t0 = time.perf_counter()
        small = positional_index(bigram)
        gpu = SearchIndex(small, device="cuda")
        cpu = SearchIndex(small, device="cpu")
        print(f"{variant}: {small.n_docs} docs built and uploaded in "
              f"{time.perf_counter() - t0:.1f} s")
        if not reads_packed(gpu, qs):
            raise AssertionError(f"{variant}: no packed window on the path")
        for mode in ("auto", "always"):
            set_sparse_mode(mode, gpu, cpu)
            cqs = [gpu.plan(q) for q in qs]
            spaces = Counter("sparse" if cq.sig.sparse else "dense"
                             for cq in cqs)
            print(f"{variant}, MT_SPARSE={mode}: plans {dict(spaces)}; "
                  f"rankers {dict(Counter(cq.sig.ranker for cq in cqs))}; "
                  f"limited slots "
                  f"{sum(len(cq.sig.slot_limited) for cq in cqs)}, merge "
                  f"groups {sum(len(cq.sig.merge_groups) for cq in cqs)}, "
                  f"repeated-keyword plans "
                  f"{sum(bool(cq.sig.has_dupes) for cq in cqs)}")
            if mode == "always" and not all(cq.sig.sparse for cq in cqs):
                raise AssertionError(f"{variant}: MT_SPARSE=always left a "
                                     "plan dense")
            name = f"{variant} ({mode})"
            res, _ = run_counted(name, gpu, qs, launches_by_path)
            check_equal(name, qs, res, cpu.search_batch(qs))
            print(f"{name}: {sum(r.total_found > 0 for r in res)} of "
                  f"{len(qs)} queries find a document")
            time_batch(name, gpu, qs, 3)
        set_sparse_mode("auto", gpu, cpu)
    print(f"{since(t_start)} positional kinds done")

    # 13. every group-by kind on a small index, MT_SPARSE auto and always
    t0 = time.perf_counter()
    small = group_index()
    gpu = SearchIndex(small, device="cuda")
    cpu = SearchIndex(small, device="cpu")
    print(f"group-by index: {small.n_docs} docs built and uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    qs = group_kind_queries()
    for mode in ("auto", "always"):
        set_sparse_mode(mode, gpu, cpu)
        cqs = [cq for cq in (program_plan(gpu, q) for q in qs) if cq]
        spaces = Counter("sparse" if cq.sig.sparse else "dense" for cq in cqs)
        print(f"group-by kinds, MT_SPARSE={mode}: plans {dict(spaces)}")
        name = f"group-by kinds ({mode})"
        res, _ = run_counted(name, gpu, qs, launches_by_path, want_seg=None)
        if not SEG_BY_PATH.get(name):
            raise AssertionError(f"{name}: no segment-sum launch")
        check_equal(name, qs, res, cpu.search_batch(qs))
        time_batch(name, gpu, qs, 3)
    set_sparse_mode("auto", gpu, cpu)
    del gpu, cpu, small
    print(f"{since(t_start)} group-by kinds done")

    # 14. the segment-sum kernel: checks, and timing at the config-4 AVG
    # batches' calls (the kernels line takes the 1M batch's)
    seg_err = check_segment_kernel(seg_calls_dense + seg_calls)
    time_segment("200k config-4 avg batch (dense, full width)",
                 seg_calls_dense, iters=10)
    seg = time_segment(f"{tag} config-4 avg batch", seg_calls, iters=20)
    print(f"{since(t_start)} segment kernel done")

    launches = sum(launches_by_path.values())
    print(json.dumps({"kernels": [{
        "name": "bitplane_decode", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "launches_by_path": launches_by_path,
        "max_abs_err": max_err, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "segment_sum_ordered", "route": "cuda",
        "source": SEG_SOURCE, "replaces": SEG_REPLACES,
        "launches": sum(SEG_BY_PATH.values()),
        "launches_by_path": SEG_BY_PATH, "max_abs_err": seg_err,
        "ms": seg["ms"], "plain_ms": seg["plain_ms"],
        "bound_ms": seg["bound_ms"], "bound_by": "bytes",
        "library_ms": seg["library_ms"]}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
