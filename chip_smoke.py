#!/usr/bin/env python3
"""Smoke run of the PyTorch port's search paths on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; each raises on a wrong result or launch count, so the exit code
is then not 0. Every path is driven through ``SearchIndex.search_batch``
(``ShardedIndex.search_batch`` in phase 18, ``RtIndex.search`` query by
query in phase 19, ``Session.execute`` statement by statement in phases
20 and 21) on ``device="cuda"`` with the launch counters set to 0 just before
and read just after, and its results are held equal to the same queries
on ``device="cpu"``.

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
   kernel's time is its device time from ``torch.profiler`` where the
   profiler recorded the launches, else CUDA events around each call; the
   bound is the bytes it must move over 3.35 TB/s.
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
    config-4 AVG and PACKEDFACTORS() batches, whose ids must keep the
    kernel's contract (nondecreasing, in [0, n_out)); bit-exact. Timed at
    each batch's calls (the kernels line takes the 1M config-4 AVG
    batch's) and at the one-group and groups-then-sink cases: device time
    (the two launches of one call, seg_prep and seg_walk), both bounds
    per call (bytes: 8 per position read and 4 per group written over
    3.35 TB/s; chain: the longest run's non-+0.0 members times
    ``FADD_CYCLES`` at the SM clock nvidia-smi reports after the timing;
    the call's bound is the larger), the plain version on the host CPU
    and ``index_add_`` on the card (the library yardstick, timed here
    only).
15. The expression ranker at 200k (after phase 12) and at 1M (after phase
    9e), dense plans: the 64 config-2 queries of ``WorkloadGen.config2``
    (16 at 1M) under ``ranker=expr('sum(lcs*user_weight)*1000+bm25')``,
    under ``ranker=sph04``, and half of them with ``select=["id",
    "PACKEDFACTORS()"]``: every plan dense with the expr ranker, K1 on each
    batch's work list, exactly one K1 launch per batch, the factor scatters
    through the segment-sum kernel (PACKEDFACTORS() batch) and no plain
    sum, results and PACKEDFACTORS() strings equal to the CPU port, how
    many of the formula batch's top-10 lists equal the default ranker's,
    launches per query (the PACKEDFACTORS() batch profiled on its first 8
    queries). The PACKEDFACTORS() batch's segment sums join phase 14's
    checks and are timed there.
16. Every formula of ``tests/test_expr_ranker.py`` (every factor,
    ``bm25a``, ``bm25f`` with field weights, ``max_window_hits``), repeated
    keywords and a phrase, sph04 and PACKEDFACTORS() (plain and json=1) in
    one batch on phase 11's 3,000-document index (dense plans, as under
    any ``MT_SPARSE``): one K1 launch (the batch reads packed windows),
    equal to the CPU port.
17. A 40-field index (two fieldmask words, every term raw): the fieldmask
    ranker, field limits past field 32, sph04, ``field_mask`` in a formula,
    PACKEDFACTORS() and a GROUP BY in one batch: no K1 launch, equal to the
    CPU port.
18. Bench config 5 (after phase 15 at 200k):
    ``bench_corpus.build_corpus_shards(200_000, 50_000, 100, 8)``
    (bench.py's config 5: 8 shards of the run's corpus) as a
    ``ShardedIndex`` on the card (build and upload times, the shards'
    device memory, and that of the fallback's per-shard indexes): phase 3's
    64 config-1 queries (bench's config-5 traffic) and 64 config-2 queries,
    every one on the merged path, with exactly one K1 launch per batch and
    no plain decode, results equal to a ``ShardedIndex`` on the CPU and
    (docids, weights, total_found) to phase 5's results of the single 200k
    index on the card. Then every route in one batch on a small sharded
    index (4,000 documents with an int, a float and a string attribute):
    ORDER BY the int and the float attribute, asc and desc, on the merged
    path, a GROUP BY and a string filter through the host-merge fallback;
    one K1 launch for the merged queries plus one per shard search of the
    fallback, equal to the CPU twin and to one index over the same
    documents (group keys and counts for the GROUP BY).
19. The RT index (after phase 18, at 200k): ``build_corpus_shards(200_000,
    50_000, 100, 8)`` as an RT table on the card (``rt_from_packed`` on
    shard 0, ``attach_packed`` on the other 7: 8 disk chunks of 25,000
    documents) and its CPU twin on a deep copy, in three states. A: no
    writes; the first 16 queries of phase 3's config-1 and config-2
    batches, equal to the twin and, with equal-weight runs normalized, to
    phase 5's single 200k index; K1 timed at one (query, chunk) list and
    at 16 queries' lists of one chunk. B: 24 seeded commits of 256
    operations (REPLACEs of disk-chunk documents, DELETEs, an UPDATE of
    ``year`` in disk chunks and RAM segments, inserts of Zipf-drawn
    documents), crossing ``MERGE_SEGMENT_LIMIT`` (progressive merges);
    the 32 queries, 8 config-2 draws under a ``year`` range and 4
    ``WorkloadGen.config4`` GROUP BY queries. C: FLUSH RAMCHUNK, then
    OPTIMIZE into one segment; the same queries. In each state: the
    segments and their device memory, one K1 launch per (query, segment)
    search whose plan reads packed windows (counted from the plans), no
    plain decode, warm walls and one profiled query. Then a small RT
    table with a binlog in a temporary directory: commits, FLUSH, more
    commits, reloaded (snapshot plus binlog replay) on the card and on the
    CPU, each equal to the table before the reload.
20. The SphinxQL session layer (after phase 19, at 200k): a ``Session``
    on ``Catalog(device="cuda")`` and its twin on
    ``Catalog(device="cpu")``, every statement to both through
    ``Session.execute``, every ``QLResult`` without an error (unless one
    is expected) and equal to the twin's (time fields masked by name:
    SHOW META ``time``, SHOW STATUS ``uptime``, SHOW THREADS and SHOW
    PROFILE times), the result cache off. 1: phase 3's 200k corpus saved
    with ``save_packed`` and loaded by ``IMPORT TABLE docs``; the first 16
    config-1 and 16 config-2 queries as ``SELECT id, WEIGHT() ... LIMIT
    10`` with SHOW META, equal to phase 5's ``SearchIndex`` results (ties
    normalized, total_found from SHOW META), again under ``OPTION
    ranker=none``; 4 ``WorkloadGen.config4`` draws as GROUP BY with
    SUM(year) and their AVG(year) twins; FACET, ORDER BY an attribute
    with an offset, a select-list expression, HAVING, ``ranker=sph04``,
    CALL KEYWORDS with stats and CALL SNIPPETS over 64 corpus documents.
    2: 24 transactions (BEGIN; UPDATE of ``year``; REPLACE; INSERT of
    Zipf-drawn documents; DELETE; COMMIT) of 256 operations, crossing
    ``MERGE_SEGMENT_LIMIT``; the SELECTs again; FLUSH RAMCHUNK and
    OPTIMIZE TABLE (one segment); the SELECTs again. 3: a percolate table
    with 1,000 stored queries from config-1 and config-2 draws (about 10%
    with a ``year > N`` filter) and one CALL PQ over 128 corpus documents
    as JSON. 4: the 8 shards of phase 18 by IMPORT TABLE and a
    distributed table over them: the 32 SELECTs, equal to the twin, with
    ``docs``'s total_found and, under ``ranker=none``, its rows (each
    local part ranks with its own term statistics, so ranked weights
    differ from one table's); then a port ``AgentServer(port=0)`` on a
    third catalog on the card serving shards 6 and 7, and ``dist2`` over
    6 local shards and that agent, equal to ``dist`` with ties
    normalized. In each step: one K1 launch per (query, segment) search
    whose plan reads packed windows (per stored query searched, in CALL
    PQ), one segment-sum launch per float SUM / AVG aggregate of a
    grouped segment search, counted from the plans of every table search
    made while the card's statement ran, and no plain version; the walls,
    the share of parse_sql and of the tables' search in them, the device
    memory of the tables and one profiled SELECT.
21. Replication (after phase 20, at 200k): two nodes on the card
    (``Catalog(data_dir, device="cuda")``, each with a ``ClusterService``
    bound to port 0) and a CPU twin cluster of two, driven by the same
    statements. Node A: IMPORT TABLE of the 200k corpus, CREATE CLUSTER,
    ALTER CLUSTER ... ADD; node B: JOIN CLUSTER, so the table reaches it
    by snapshot transfer and ``load_rt_snapshot`` onto its device (timed,
    and its segments checked on the card). Then 8 write transactions of
    256 operations (an UPDATE, a DELETE, and REPLACE and INSERT
    statements of at most 24 rows, through ``cluster:table``) from each
    node in turn, B's REPLACEs on the ids A's
    just replaced, each timed until both card nodes have applied it; every
    node of both clusters at the same sequence number. Then phase 20's 32
    SELECTs and 8 GROUP BYs, each with SHOW META, on node A and on node B,
    each statement equal to its CPU twin with the launches counted from
    the plans (``SqlTwins``), and node A's results equal to node B's.
Each batch of phases 5-13 and 15-20 prints its warm walls and one profiled
run (device time, busy share, kernel launches, host waits and copies).
Every check of a result and every launch count raises on a failure; a
time does not: where the profiler recorded no launch of a kernel that the
counters saw, the run prints so and times the kernel with CUDA events.

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
SEG_EVENT = "seg_"         # its two kernels: seg_prep_kernel, seg_walk_kernel
# latency of one dependent __fadd_rn on Hopper, in SM cycles: the ordered
# sum's chain bound is a run's non-+0.0 members times this
FADD_CYCLES = 4
# a sleep kernel ahead of each timed call (about 2 ms at 1.7 GHz): the host
# enqueues the call before the device reaches it
SLEEP_CYCLES = 3_000_000
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


EXPR_FORMULA = "sum(lcs*user_weight)*1000+bm25"
PF_SELECT = ["id", "PACKEDFACTORS()"]


def expr_batches(packed, seed: int, n: int = BATCH) -> tuple[list, dict]:
    """The measured config-2 draws of ``WorkloadGen.config2(n)`` and their
    expression-ranker twins: the formula, sph04, and the first half with
    PACKEDFACTORS()."""
    gen = bench_corpus.WorkloadGen(np.random.RandomState(seed), VOCAB, packed)
    qs = gen.config2(n)[1]
    return qs, {
        "expr": [replace(q, ranker=("expr", EXPR_FORMULA)) for q in qs],
        "sph04": [replace(q, ranker="sph04") for q in qs],
        "packedfactors": [replace(q, select=PF_SELECT)
                          for q in qs[:n // 2]]}


EXPR_FORMULAS = [
    EXPR_FORMULA, "bm25f(1.2, 0.7)*1000",
    "bm25f(1.2, 0.7, {title=5, body=1})*1000",
    "sum(hit_count)*10 + doc_word_count", "field_mask*100 + sum(word_count)",
    "sum(min_hit_pos)", "sum((sum_idf-min_idf)+(sum_idf-max_idf))*1000 + 7",
    "sum(max_idf > min_idf)", "sum(sum_idf)*1000", "sum(exact_order)",
    "sum(lccs)", "sum((wlccs-sum_idf)*1000) + 42", "sum(min_best_span_pos)",
    "sum(max_window_hits(3))", "sum(min_gaps)*100", "sum(atc)*10000",
    "bm25a(1.2, 0.75)*1000", "sum(tf_idf)*1000 + max_lcs + query_word_count",
]
EXPR_EVERY = ("sum(lcs*user_weight)*1000+bm25+bm25a(1.2,0.75)*100"
              "+sum(tf_idf+sum_idf+wlccs+atc)*10+sum(min_idf)+sum(max_idf)"
              "+sum(hit_count+word_count+exact_order+lccs+min_gaps)"
              "+sum(min_hit_pos+min_best_span_pos+exact_hit)"
              "+sum(max_window_hits(2))*3+field_mask+doc_word_count")


def expr_kind_queries() -> list[SearchQuery]:
    """Every formula of tests/test_expr_ranker.py on phase 11's index,
    repeated keywords and a phrase, sph04 and PACKEDFACTORS()."""
    kinds = [dict(match="w1 w2", ranker=("expr", f)) for f in EXPR_FORMULAS]
    kinds += [
        dict(match="w1 w2 w1", ranker=("expr", EXPR_EVERY)),
        dict(match='"w1 w2" w3', ranker=("expr", EXPR_EVERY)),
        dict(match="w1 | w3", ranker=("expr", EXPR_EVERY)),
        dict(match="w1 w2", ranker="sph04"),
        dict(match="@title w1", ranker="sph04"),
        dict(match="w1 w2", select=PF_SELECT),
        dict(match="w1 w2 w1", select=PF_SELECT),
        dict(match='"w1 w2" w3', select=["id", "PACKEDFACTORS({json=1})"]),
    ]
    return [SearchQuery(limit=20, **kw) for kw in kinds]


WIDE_FIELDS = [f"f{i}" for i in range(40)]
WIDE_DOCS = 2000


def wide_field_index():
    """40 full-text fields (two fieldmask words: the builder keeps every
    term raw), each holding 0-3 of 12 words in 30% of the documents, and a
    uint ``g``."""
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    rng = np.random.RandomState(37)
    words = [f"w{i}" for i in range(12)]
    docs = []
    for i in range(1, WIDE_DOCS + 1):
        d = dict(id=i, g=i % 7)
        for f in WIDE_FIELDS:
            d[f] = (" ".join(rng.choice(words, rng.randint(0, 4)))
                    if rng.rand() < 0.3 else "")
        docs.append(d)
    b = IndexBuilder(Schema(fields=WIDE_FIELDS,
                            attrs=[AttrDef("g", AttrType.UINT)]))
    b.add_documents(docs)
    return b.build()


def wide_field_queries() -> list[SearchQuery]:
    kinds = [
        dict(match="w1", ranker="fieldmask"),
        dict(match="w1 | w3", ranker="fieldmask"),
        dict(match="@f35 w1"), dict(match="@(f1,f35) w2 | w3"),
        dict(match="@f39 w1", ranker="sph04"),
        dict(match="w1 w2", ranker="sph04"),
        dict(match="w1 w2", ranker=("expr",
                                    "field_mask + sum(lcs*user_weight)")),
        dict(match="w2", select=PF_SELECT),
        dict(match="w1", group_by="g", select=["count(*)", "sum(g)"]),
    ]
    return [SearchQuery(limit=20, **kw) for kw in kinds]


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


def timed_calls(fn, iters: int, sleep_cycles: int, before=None):
    """Run ``fn`` ``iters`` times under torch.profiler, each run between a
    pair of CUDA events recorded after a sleep kernel of ``sleep_cycles``
    (``before`` runs ahead of the sleep, outside the pair): the host has
    enqueued the whole run before the device reaches it, so the pair
    measures device work only. -> (the profiler's events, per-run ms)."""
    from torch.profiler import ProfilerActivity, profile
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for start, stop in pairs:
            if before is not None:
                before()
            torch.cuda._sleep(sleep_cycles)
            start.record()
            fn()
            stop.record()
        torch.cuda.synchronize()
    return prof.events(), [a.elapsed_time(b) for a, b in pairs]


def kernel_device_ms(items: list, iters: int, flush: bool) -> float:
    """Device time of one grouped launch, optionally with the L2 cache
    flushed by a 64 MB write before each launch (outside the timed pair):
    the mean of the launches the profiler recorded, or where it recorded
    none, CUDA events around each call (the work list's copy included).
    Launches the profiler missed are printed; the run goes on."""
    from torch.autograd import DeviceType
    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    ps.decode_grouped(items)
    torch.cuda.synchronize()
    events, event_ms = timed_calls(lambda: ps.decode_grouped(items), iters,
                                   SLEEP_CYCLES,
                                   (lambda: scrub.fill_(1)) if flush else None)
    us = [e.time_range.elapsed_us() for e in events
          if e.device_type == DeviceType.CUDA and KERNEL_EVENT in e.name]
    if len(us) < iters:
        print(f"  the profiler recorded {len(us)} of {iters} {KERNEL_EVENT} "
              f"launches; CUDA events around each call: "
              f"{np.mean(event_ms) * 1e3:.2f} us")
    if us:
        return sum(us) / len(us) / 1e3
    return float(np.mean(event_ms))


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


def run_counted(name: str, idx, queries: list[SearchQuery],
                launches_by_path: dict, want_seg: int | None = 0,
                want: int | None = None) -> tuple[list, float]:
    """Drive one ``search_batch`` of a ``SearchIndex`` or ``ShardedIndex``
    with the launch counters set to 0 just before and read just after:
    ``want`` bit-plane launches (by default exactly one where the batch
    reads packed windows, else none), ``want_seg`` segment-sum launches
    (any number when None), and never a plain version."""
    if want is None:
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


def time_batch(name: str, idx: SearchIndex, queries: list, runs: int,
               profiled: list | None = None) -> dict:
    """Warm walls of one batch, then one warm run under the profiler (of
    ``profiled``, a slice of the batch, where the whole batch would make
    too many events to read back in time)."""
    warm = []
    for _ in range(runs):
        t0 = time.perf_counter()
        idx.search_batch(queries)
        torch.cuda.synchronize()
        warm.append(round((time.perf_counter() - t0) * 1e3, 2))
    profiled = profiled or queries
    prof = profile_batch(idx, profiled)
    print(f"{name}: batch of {len(queries)} on cuda, warm runs (ms) {warm}")
    print(f"{name}: one warm batch of {len(profiled)} under the profiler: wall "
          f"{prof['wall_ms']:.2f} ms, device time {prof['device_ms']:.3f} ms "
          f"(busy share {prof['busy']:.3f}), {prof['launches']} kernel "
          f"launches, K1 {prof['k1_ms'] * 1e3:.2f} us in "
          f"{prof['k1_events']} events")
    print(f"{name}: top device ops (name, count, ms): {prof['top']}")
    print(f"{name}: host waits and copies: {prof['waits']}")
    return dict(warm_ms=warm, n_profiled=len(profiled), **prof)


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


def expr_phase(tag: str, gpu: SearchIndex, cpu: SearchIndex, base: list,
               batches: dict, launches_by_path: dict, runs: int) -> int:
    """The expression-ranker batches on one corpus: every plan dense with
    the expr ranker, K1 on each batch's work list, one counted
    ``search_batch`` with exactly one K1 launch (and, for PACKEDFACTORS(),
    segment-sum launches for the factor scatters), results and factor
    strings equal to the CPU port, the formula batch against the default
    ranker, launches per query. Returns the K1 max abs error."""
    data = gpu.device.data_pytree()
    max_err = 0
    for name, qs in batches.items():
        path = f"{tag} {name}"
        cqs = [gpu.plan(q) for q in qs]
        dense = sum(not cq.sig.sparse for cq in cqs)
        print(f"{path}: {dense} of {len(cqs)} plans dense; rankers "
              f"{dict(Counter(cq.sig.ranker for cq in cqs))}; PACKEDFACTORS "
              f"plans {sum(cq.sig.emit_factors for cq in cqs)}")
        if dense != len(cqs) or any(cq.sig.ranker != "expr" for cq in cqs):
            raise AssertionError(f"{path}: a plan is sparse or not expr")
        if not reads_packed(gpu, qs):
            raise AssertionError(f"{path}: no packed window on the path")
        max_err = max(max_err, check_batch_lists({path: [
            w for cq in cqs
            for w in packed_windows(cq.sig, cq.slot_pb, data, cq.runtime)]}))
        res, _ = run_counted(path, gpu, qs, launches_by_path, want_seg=None)
        if name == "packedfactors" and not SEG_BY_PATH.get(path):
            raise AssertionError(f"{path}: no segment-sum launch")
        check_equal(path, qs, res, cpu.search_batch(qs))
        if name == "packedfactors":
            blobs = [m.attrs["PACKEDFACTORS()"] for r in res
                     for m in r.matches]
            if not blobs or not all(b.startswith("bm25=") for b in blobs):
                raise AssertionError(f"{path}: a match lacks its factors")
            print(f"{path}: {len(blobs)} factor strings, e.g. "
                  f"{blobs[0][:160]}")
        if name == "expr":
            ref = gpu.search_batch(base)
            same = sum([(m.docid, m.weight) for m in a.matches]
                       == [(m.docid, m.weight) for m in b.matches]
                       for a, b in zip(res, ref))
            print(f"{path}: {same} of {len(qs)} top-10 lists (docids and "
                  "weights) equal the default proximity_bm25 ranker's")
        t = time_batch(path, gpu, qs, runs,
                       qs[:8] if name == "packedfactors" else None)
        print(f"{path}: {t['launches'] / t['n_profiled']:.1f} kernel "
              "launches per query")
    return max_err


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
    every captured call of the main path (each of which must keep the
    kernel's contract: ids nondecreasing, in [0, n_out)); returns the max
    abs error."""
    max_err = 0.0
    for i, (v, g, n) in enumerate(captured):
        if g.numel() and not (bool((g[1:] >= g[:-1]).all())
                              and int(g.min()) >= 0 and int(g.max()) < n):
            raise AssertionError(f"main-path segment sum {i}: ids not "
                                 "nondecreasing in [0, n_out)")
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
          f"{len(captured)} main-path calls: bit-exact, the main-path ids "
          "nondecreasing")
    try:
        gb.segment_sum_ordered(torch.zeros(4, device="cuda"),
                               torch.zeros(4, dtype=torch.int64,
                                           device="cuda"), 4)
    except ValueError:
        print("  int64 group ids raise ValueError")
    else:
        raise AssertionError("segment_sum_ordered took int64 group ids")
    return max_err


def sm_clocks() -> tuple[float, float]:
    """(current, max) SM clock in MHz as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cur, mx = (float(x) for x in out.split(","))
    return cur, mx


def longest_chain(v: torch.Tensor, g: torch.Tensor) -> int:
    """The largest count of non-+0.0 members of one group (a run: the ids
    ascend): the ordered sum's chain of dependent adds."""
    if g.numel() == 0:
        return 0
    nz = (v.view(torch.int32) != 0).to(torch.int64)
    _, counts = torch.unique_consecutive(g, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    csum = torch.cumsum(nz, 0)[ends]
    per_run = csum - torch.cat([csum.new_zeros(1), csum[:-1]])
    return int(per_run.max())


def time_segment(name: str, calls: list, iters: int) -> dict:
    """Per-call times over a list of calls (a batch's captured calls, or
    one case): the kernel's device time (its two launches, seg_prep and
    seg_walk: the mean of each kernel's launches that torch.profiler
    recorded, or where it recorded none of one, CUDA events around each
    run of the calls), the wrapper's call time (CUDA events, in turns
    library, kernel, kernel, library), ``index_add_`` on the card, the
    plain version on the host CPU, and both bounds per call: bytes (8 per
    position, 4 per group over 3.35 TB/s) and chain (the longest run's
    non-+0.0 members times FADD_CYCLES at the SM clock nvidia-smi reports
    right after the timing); a call's bound is the larger of the two."""
    from torch.autograd import DeviceType
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
    events, event_ms = timed_calls(kernel, iters,
                                   SLEEP_CYCLES * max(len(calls) // 8, 1))
    clock, clock_max = sm_clocks()
    # per run of every call: seg_prep once per call with a group, seg_walk
    # once per call with a group and a position
    expect = {"prep": sum(n > 0 for _, _, n in calls),
              "walk": sum(n > 0 and v.numel() > 0 for v, _, n in calls)}
    by_kernel: dict = {k: [] for k in expect}
    for e in events:
        if e.device_type == DeviceType.CUDA and SEG_EVENT in e.name:
            for k in expect:
                if f"seg_{k}" in e.name:
                    by_kernel[k].append(e.time_range.elapsed_us())
    counts = {k: len(u) for k, u in by_kernel.items()}
    if counts != {k: iters * n for k, n in expect.items()}:
        print(f"  the profiler recorded {counts} segment-sum launches of "
              f"{name}, of {({k: iters * n for k, n in expect.items()})}")
    if all(counts[k] or not expect[k] for k in expect):
        # mean of the recorded launches of each kernel
        us = iters * sum(np.mean(by_kernel[k]) * expect[k] for k in expect
                         if expect[k])
    else:
        us = sum(event_ms) * 1e3
        print(f"  {name}: CUDA events around each run give the device time")
    t0 = time.perf_counter()
    for v, g, n in cpu_in:
        gb.segment_sum_plain(v, g, n)
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_calls = len(calls)
    bytes_ms = [(8 * v.numel() + 4 * n) / HBM_BYTES_PER_S * 1e3
                for v, g, n in calls]
    chains = [longest_chain(v, g) for v, g, _ in cpu_in]
    chain_ms = [c * FADD_CYCLES / (clock * 1e6) * 1e3 for c in chains]
    bound_ms = sum(max(b, c) for b, c in zip(bytes_ms, chain_ms)) / n_calls
    bound_by = ("operations" if sum(c > b for b, c in zip(bytes_ms, chain_ms))
                * 2 > n_calls else "bytes")
    r = dict(ms=us / 1e3 / iters / n_calls, call_ms=(k1 + k2) / 2 / n_calls,
             library_ms=(lib1 + lib2) / 2 / n_calls,
             plain_ms=plain_ms / n_calls, bound_ms=bound_ms,
             bound_by=bound_by, bytes_ms=sum(bytes_ms) / n_calls,
             chain_ms=sum(chain_ms) / n_calls, chain=max(chains),
             clock=clock)
    positions = [v.numel() for v, _, _ in calls]
    print(f"  segment_sum_ordered {name}: {n_calls} calls of "
          f"{min(positions)}-{max(positions)} positions; per call: device "
          f"{r['ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us (by "
          f"{bound_by}: bytes {r['bytes_ms'] * 1e3:.2f} us, chain "
          f"{r['chain_ms'] * 1e3:.2f} us, longest chain {r['chain']} adds "
          f"at {clock:.0f} MHz of max {clock_max:.0f}), "
          f"{bound_ms / r['ms']:.3f} of it; wrapper {r['call_ms'] * 1e3:.2f}"
          f" us, index_add_ on the card {r['library_ms'] * 1e3:.2f} us, "
          f"plain version on the host CPU {r['plain_ms'] * 1e3:.2f} us")
    return r


SHARDS = 8        # bench.py config 5: min(8, devices) shards of the corpus
ROUTE_DOCS = 4000
ROUTE_COLORS = ["red", "green", "blue", "cyan"]


def route_corpus():
    """A small corpus with an int, a float and a string attribute, as
    SHARDS round-robin shards (``partition_documents``) and as one index;
    30 Zipf-drawn words, so that the frequent ones have packed slots."""
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.parallel.sharded import \
        partition_documents
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    rng = np.random.RandomState(41)
    words = [f"w{i}" for i in range(30)]
    docs = [dict(id=i, title=words[int(rng.randint(0, 30))],
                 body=" ".join(words[int(z) % 30] for z in rng.zipf(1.3, 10)),
                 year=2000 + int(rng.randint(0, 12)),
                 score=float(np.round(rng.rand(), 3)),
                 color=ROUTE_COLORS[int(rng.randint(0, 4))])
            for i in range(1, ROUTE_DOCS + 1)]
    schema = Schema(fields=["title", "body"],
                    attrs=[AttrDef("year", AttrType.UINT),
                           AttrDef("score", AttrType.FLOAT),
                           AttrDef("color", AttrType.STRING)])

    def build(part):
        b = IndexBuilder(schema)
        b.add_documents(part)
        return b.build()
    return [build(p) for p in partition_documents(docs, SHARDS)], build(docs)


def route_queries() -> list[SearchQuery]:
    """ORDER BY an int and a float attribute, asc and desc (the merged
    path); a GROUP BY and a string filter (the host-merge fallback)."""
    f = AttrFilterDef
    kinds = [
        dict(match="w1 | w3", sort=[("year", True)]),
        dict(match="w1 | w3", sort=[("year", False), ("id", True)]),
        dict(match="w2", sort=[("score", True)]),
        dict(match="w2 w5", sort=[("score", False)]),
        dict(match="w1", group_by="year", select=["count(*)", "sum(score)"],
             sort=[("year", True)]),
        dict(match="w1 | w4", filters=[f("color", "values", values=["red"])]),
    ]
    return [SearchQuery(limit=20, **kw) for kw in kinds]


def sharded_launches(sidx, queries: list[SearchQuery]) -> int:
    """Bit-plane launches one ``ShardedIndex.search_batch`` makes: one for
    the merged queries where they read packed windows, and one per shard
    search of the fallback queries that reads them (each shard's own
    ``SearchIndex`` decodes its windows in one call)."""
    routes = [sidx._prep(q)[0] for q in queries]
    merged = [q for q, r in zip(queries, routes) if r == "ok"]
    want = int(any(window_kinds(sidx.plan(q).sig) for q in merged))
    return want + sum(reads_packed(p, [q])
                      for q, r in zip(queries, routes) if r == "fallback"
                      for p in sidx._per_shard_indexes())


def check_single(name: str, queries: list, got: list, want: list) -> None:
    """A distributed result against one index over the same documents:
    docids, weights and total_found; keys and counts of a GROUP BY (its
    representatives may differ between the part merge and one index)."""
    for q, g, w in zip(queries, got, want):
        if q.group_by:
            same = ([(m.attrs[q.group_by], m.attrs["count(*)"])
                     for m in g.matches]
                    == [(m.attrs[q.group_by], m.attrs["count(*)"])
                        for m in w.matches])
        else:
            same = ([(m.docid, m.weight) for m in g.matches]
                    == [(m.docid, m.weight) for m in w.matches])
        if not same or g.total_found != w.total_found:
            raise AssertionError(f"{name} {q.match!r}: sharded "
                                 f"{_summary(g)} != one index {_summary(w)}")
    print(f"{name}: {len(queries)} queries equal to one index over the same "
          "documents on cuda (docids, weights, total_found; group keys and "
          "counts)")


def sharded_phase(gpu: SearchIndex, batches: dict, gpu_results: dict,
                  launches_by_path: dict, t_start: float) -> None:
    """Phase 18: bench config 5 (8 shards of the 200k corpus on one card)
    and a batch of every route on a small sharded index."""
    from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    shards = bench_corpus.build_corpus_shards(N_DOCS, VOCAB, AVG_LEN, SHARDS)
    print(f"config 5: {len(shards)} shards of "
          f"{sorted({s.n_docs for s in shards})} docs, "
          f"{sum(s.n_postings for s in shards)} postings, built in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sgpu = ShardedIndex(shards, "cuda")
    torch.cuda.synchronize()
    print(f"config 5 upload to cuda: {time.perf_counter() - t0:.1f} s; "
          f"device memory of the shards {tree_bytes(sgpu.data) / 2**20:.1f} "
          f"MiB")
    t0 = time.perf_counter()
    scpu = ShardedIndex(shards, "cpu")
    print(f"config 5 upload to cpu: {time.perf_counter() - t0:.1f} s")
    for name in ("config1", "config2"):
        qs = batches[name]
        path = f"config 5 {name}"
        routes = Counter(sgpu._prep(q)[0] for q in qs)
        print(f"{path}: routes {dict(routes)}")
        if routes != Counter({"ok": len(qs)}):
            raise AssertionError(f"{path}: a query left the merged path")
        res, _ = run_counted(path, sgpu, qs, launches_by_path, want=1)
        check_equal(path, qs, res, scpu.search_batch(qs))
        check_single(path, qs, res, gpu_results[name])
        time_batch(path, sgpu, qs, 2, qs[:16])
    del scpu
    t0 = time.perf_counter()
    fallback_bytes = sum(index_bytes(p) for p in sgpu._per_shard_indexes())
    print(f"config 5: the fallback's per-shard indexes (a second upload of "
          f"every shard) take {fallback_bytes / 2**20:.1f} MiB on cuda, "
          f"uploaded in {time.perf_counter() - t0:.1f} s")
    del sgpu
    print(f"{since(t_start)} config 5 done")

    t0 = time.perf_counter()
    rshards, rone = route_corpus()
    rgpu = ShardedIndex(rshards, "cuda")
    rcpu = ShardedIndex(rshards, "cpu")
    one = SearchIndex(rone, "cuda")
    print(f"route index: {SHARDS} shards of {rone.n_docs} docs built and "
          f"uploaded in {time.perf_counter() - t0:.1f} s")
    qs = route_queries()
    routes = [rgpu._prep(q)[0] for q in qs]
    print(f"config 5 routes: {routes}")
    if routes.count("ok") != 4 or routes.count("fallback") != 2:
        raise AssertionError("config 5 routes: wrong routes")
    want = sharded_launches(rgpu, qs)
    res, _ = run_counted("config 5 routes", rgpu, qs, launches_by_path,
                         want_seg=None, want=want)
    check_equal("config 5 routes", qs, res, rcpu.search_batch(qs))
    check_single("config 5 routes", qs, res, one.search_batch(qs))
    time_batch("config 5 routes", rgpu, qs, 2)
    print(f"{since(t_start)} phase 18 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


RT_QUERIES = 16          # of each of phase 3's batches, per state
RT_COMMITS = 24
RT_OPS = 256             # operations per commit
RT_WARM_RUNS = 2


class RtBatch:
    """``search_batch`` over an RT table: one ``RtIndex.search`` per query,
    in order (the RT search has no batch: each query runs one program per
    segment, as in the JAX package)."""

    def __init__(self, rt):
        self.rt = rt

    def search_batch(self, queries: list[SearchQuery]) -> list:
        return [self.rt.search(q) for q in queries]


def rt_launches(rt, queries: list[SearchQuery]) -> tuple[int, int]:
    """(bit-plane launches, segment-sum launches) of ``rt.search`` over the
    queries, counted from the plans: each (query, segment) search is one
    round of device work, so one bit-plane launch where its program reads
    packed windows; a ranked query plans each segment with the table's
    summed term stats, as ``search_rt`` does; a grouped one runs each
    segment's own GROUP BY (one segment-sum launch per float SUM / AVG)."""
    from manticoresearch_tpu_torch.exec import multi
    total_docs, df = rt.global_stats()
    k1 = seg = 0
    for q in queries:
        parts = rt.searchable_parts()
        if q.group_by:
            if any("distinct" in s.lower() for s in q.select or []):
                raise AssertionError("rt_launches: COUNT(DISTINCT) takes "
                                     "the raw-window route")
            part_q = replace(q, offset=0, limit=q.max_matches)
            k1 += sum(reads_packed(p, [part_q]) for p in parts)
            seg += sum(float_aggregates(p, [part_q]) for p in parts)
            continue
        part_q = replace(q, offset=0, select=None, limit=(
            q.offset + q.limit if q.sort else q.max_matches))
        kw = dict(total_docs_override=total_docs, local_df=df,
                  emit_factors=False)
        for p in parts:
            steps = multi._stats_steps(p, part_q, kw)
            try:
                _, cq = next(steps)
            except StopIteration:      # planning refused it: no device work
                continue
            steps.close()
            k1 += bool(window_kinds(cq.sig))
    return k1, seg


def tie_runs(rows: list, limit: int) -> list:
    """(docid, weight) rows as (weight, docids) runs, normalized as
    ``tests/test_differential.py`` does: full ties may come in another
    docid order, and a final run clipped by the window keeps only its
    length."""
    out: list = []
    for d, w in rows:
        if out and out[-1][0] == w:
            out[-1][1].append(d)
        else:
            out.append((w, [d]))
    return [(w, len(ids) if i == len(out) - 1 and len(rows) == limit
             else sorted(ids)) for i, (w, ids) in enumerate(out)]


def check_ties(name: str, queries: list, got: list, want: list) -> None:
    """RT results against one index over the same documents: total_found,
    and the matches with equal-weight runs normalized (``tie_runs``)."""
    def runs(matches, limit):
        return tie_runs([(m.docid, m.weight) for m in matches], limit)
    for q, g, w in zip(queries, got, want):
        if (runs(g.matches, q.limit) != runs(w.matches, q.limit)
                or g.total_found != w.total_found):
            raise AssertionError(f"{name} {q.match!r}: RT {_summary(g)} != "
                                 f"one index {_summary(w)}")
    print(f"{name}: {len(queries)} queries equal to the single 200k index "
          "(total_found, weights, docids with ties normalized)")


def rt_write_stream(rng: np.random.RandomState, rt, next_id: int) -> tuple:
    """One commit's operations, drawn from the table's state: RT_OPS // 8
    REPLACEs of documents of the disk chunks, as many DELETEs and as many
    UPDATEs of ``year`` (each half in the disk chunks, half in the RAM
    segments where they hold enough), and inserts of new documents for
    the rest; documents are Zipf-drawn ``t%05d`` tokens, as the corpus.
    -> (updated ids, the year they get, replaced docs, new docs, deleted
    ids, next free id)."""
    width = max(4, len(str(VOCAB - 1)))
    live = rt.docid_seg
    k = RT_OPS // 8

    def draw(lo, hi, n):
        out: list = []
        for d in rng.randint(lo, max(hi, lo + 1), 4 * n).tolist():
            if d in live and d not in out:
                out.append(d)
        return out
    chunk, ram = draw(1, N_DOCS + 1, 2 * k), draw(N_DOCS + 1, next_id, k)
    replaces = chunk[:k]
    deletes = chunk[k:k + k // 2] + ram[:k // 2]
    updates = chunk[k + k // 2:2 * k] + ram[k // 2:k]

    def doc(docid):
        terms = np.minimum(rng.zipf(1.25, int(rng.randint(AVG_LEN // 2,
                                                          AVG_LEN * 2))) - 1,
                           VOCAB - 1)
        return dict(id=docid, content=" ".join(f"t{t:0{width}d}"
                                               for t in terms.tolist()),
                    year=2000 + int(rng.randint(0, 25)),
                    group_id=int(rng.randint(0, 100)))
    n_new = RT_OPS - len(replaces) - len(deletes) - len(updates)
    year = 2000 + int(rng.randint(0, 25))
    return (updates, year, [doc(d) for d in replaces],
            [doc(next_id + i) for i in range(n_new)], deletes,
            next_id + n_new)


def rt_apply(rt, ops: tuple) -> int:
    """Apply one commit's operations (an UPDATE, then the REPLACEs, inserts
    and DELETEs, then COMMIT); -> the rows the commit affected."""
    updates, year, replaces, inserts, deletes, _ = ops
    rt.update_attrs(updates, {"year": year})
    for d in replaces:
        rt.insert(d, replace=True)
    for d in inserts:
        rt.insert(d)
    rt.delete(deletes)
    return rt.commit()


def rt_state(tag: str, gpu_rt, cpu_rt, queries: list, launches_by_path: dict,
             t_start: float) -> list:
    """One state of the RT table: its segments and their device memory,
    one counted run of the queries (bit-plane launches equal to the count
    from the plans, segment-sum launches likewise, no plain version),
    equality with the CPU twin, warm walls and one profiled query."""
    path = f"rt {tag}"
    segs = [(s.chunk_id, s.packed.n_docs) for s in gpu_rt.segments]
    if segs != [(s.chunk_id, s.packed.n_docs) for s in cpu_rt.segments]:
        raise AssertionError(f"{path}: segments differ from the CPU twin")
    print(f"{path}: {len(segs)} segments (chunk id, rows) {segs}, "
          f"{gpu_rt.n_docs} live docs; device memory of the segments "
          f"{sum(index_bytes(s.search) for s in gpu_rt.segments) / 2**20:.1f}"
          " MiB")
    want_k1, want_seg = rt_launches(gpu_rt, queries)
    res, _ = run_counted(path, RtBatch(gpu_rt), queries, launches_by_path,
                         want_seg=want_seg, want=want_k1)
    t0 = time.perf_counter()
    check_equal(path, queries, res, RtBatch(cpu_rt).search_batch(queries))
    print(f"{path}: the CPU twin's run took {time.perf_counter() - t0:.1f} s")
    time_batch(path, RtBatch(gpu_rt), queries, RT_WARM_RUNS, queries[:1])
    print(f"{since(t_start)} {path} done")
    return res


def rt_binlog_check(t_start: float) -> None:
    """A small RT table with a binlog in a temporary directory: commits of
    new documents, a FLUSH (snapshot, binlog reset), commits with REPLACEs
    and DELETEs and an UPDATE, then a reload on the card (snapshot plus
    binlog replay) and on the CPU, each equal to the table before the
    reload. (Nothing is killed before the snapshot: a snapshot keeps no
    kill-list, in the JAX package as in the port, so a row killed before
    it would come back on reload.)"""
    import tempfile
    from manticoresearch_tpu_torch.index.rt import RtIndex
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    schema = Schema(fields=["title", "body"],
                    attrs=[AttrDef("year", AttrType.UINT),
                           AttrDef("score", AttrType.FLOAT)])
    rng = np.random.RandomState(31)
    words = [f"w{i}" for i in range(40)]
    qs = [SearchQuery(match=m, limit=20) for m in
          ("w1", "w2 w3", "w1 | w5", '"w1 w2"')]
    qs += [SearchQuery(match="w1 | w2", group_by="year", limit=20,
                       select=["count(*)", "sum(score)"],
                       sort=[("year", True)]),
           SearchQuery(match="w3", sort=[("year", False), ("id", True)],
                       limit=20)]
    with tempfile.TemporaryDirectory() as d:
        rt = RtIndex("binlog", schema, data_dir=d, device="cuda")
        for c in range(12):
            if c == 6:
                rt.flush()
            for i in range(40):
                docid = 1 + c * 40 + i if c < 6 else int(rng.randint(1, 400))
                rt.insert(dict(
                    id=docid, title=" ".join(rng.choice(words, 2)),
                    body=" ".join(words[int(z) % 40]
                                  for z in rng.zipf(1.3, 12)),
                    year=2000 + int(rng.randint(0, 10)),
                    score=float(rng.randint(0, 64)) / 8), replace=c >= 6)
            if c >= 6:
                rt.delete([int(x) for x in rng.randint(1, 400, 5)])
            rt.commit()
        rt.update_attrs([int(x) for x in rng.randint(1, 400, 20)],
                        {"year": 2020})
        before = RtBatch(rt).search_batch(qs)
        again = RtIndex("binlog", schema, data_dir=d, device="cuda")
        twin = RtIndex("binlog", schema, data_dir=d, device="cpu")
        for name, t in (("cuda", again), ("cpu", twin)):
            if t.n_docs != rt.n_docs or len(t.segments) != len(rt.segments):
                raise AssertionError(f"rt binlog reload on {name}: "
                                     f"{t.n_docs} docs in {len(t.segments)} "
                                     f"segments, expected {rt.n_docs} in "
                                     f"{len(rt.segments)}")
            check_equal(f"rt binlog reload on {name}", qs,
                        RtBatch(t).search_batch(qs), before)
        print(f"rt binlog: {rt.n_docs} docs in {len(rt.segments)} segments, "
              f"binlog {os.path.getsize(os.path.join(d, 'binlog.jsonl'))} "
              f"bytes after the snapshot")
    print(f"{since(t_start)} rt binlog done")


def rt_phase(packed, batches: dict, gpu_results: dict,
             launches_by_path: dict, t_start: float) -> None:
    """Phase 19: an RT table of the 200k corpus in 8 disk chunks on the
    card, in three states (no writes; after a write stream; after FLUSH
    RAMCHUNK and OPTIMIZE), each against its CPU twin; then a binlog
    reload."""
    import copy
    from manticoresearch_tpu_torch.exec import multi
    from manticoresearch_tpu_torch.index.rt import RtIndex, rt_from_packed
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shards = bench_corpus.build_corpus_shards(N_DOCS, VOCAB, AVG_LEN, SHARDS)
    twin_shards = copy.deepcopy(shards)
    print(f"rt: {len(shards)} chunks of {sorted({s.n_docs for s in shards})} "
          f"docs built (and copied for the CPU twin) in "
          f"{time.perf_counter() - t0:.1f} s")
    twins = {}
    for dev, parts in (("cuda", shards), ("cpu", twin_shards)):
        t0 = time.perf_counter()
        rt = rt_from_packed("rt", parts[0], device=dev)
        for part in parts[1:]:
            rt.attach_packed(part)
        torch.cuda.synchronize()
        twins[dev] = rt
        print(f"rt on {dev}: rt_from_packed + {len(parts) - 1} attach_packed "
              f"in {time.perf_counter() - t0:.1f} s")
    gpu_rt, cpu_rt = twins["cuda"], twins["cpu"]
    del shards, twin_shards
    qs = batches["config1"][:RT_QUERIES] + batches["config2"][:RT_QUERIES]

    # state A: 8 disk chunks, no writes; against the single 200k index too
    res = rt_state("A (8 chunks)", gpu_rt, cpu_rt, qs, launches_by_path,
                   t_start)
    for name in ("config1", "config2"):
        lo = 0 if name == "config1" else RT_QUERIES
        check_ties(f"rt A {name}", qs[lo:lo + RT_QUERIES],
                   res[lo:lo + RT_QUERIES], gpu_results[name][:RT_QUERIES])
    # K1 at one (query, chunk) launch's windows, and at the windows of every
    # config-2 query of the state on one chunk in one list (the decode a
    # batched RT search would make per chunk)
    chunk0 = gpu_rt.segments[0].search
    data = chunk0.device.data_pytree()
    total_docs, df = gpu_rt.global_stats()
    items = []
    for q in batches["config2"][:RT_QUERIES]:
        steps = multi._stats_steps(chunk0, replace(q, limit=q.max_matches),
                                   dict(total_docs_override=total_docs,
                                        local_df=df, emit_factors=False))
        _, cq = next(steps)
        steps.close()
        items.append(packed_windows(cq.sig, cq.slot_pb, data, cq.runtime))
    one = max(items, key=lambda it: sum(w.shape[0] for w, _, _ in it))
    time_decode("rt chunk 0 (25,000 docs), the config-2 query with the "
                "most blocks", one, iters=50, flush=True)
    time_decode(f"rt chunk 0 (25,000 docs), {RT_QUERIES} config-2 queries' "
                "windows in one list", [w for it in items for w in it],
                iters=50, flush=True)
    del data, items, one

    # state B: a write stream across MERGE_SEGMENT_LIMIT
    gen = bench_corpus.WorkloadGen(np.random.RandomState(27), VOCAB, packed)
    ranged = [replace(q, filters=[AttrFilterDef("year", "range_i", lo=2005,
                                                hi=2015)])
              for q in config2_queries(gen, 8)]
    grouped = gen.config4(4)[1]
    rng = np.random.RandomState(29)
    next_id = N_DOCS + 1
    times = []
    ram_updates, merged = 0, []
    for c in range(RT_COMMITS):
        ops = rt_write_stream(rng, cpu_rt, next_id)
        next_id = ops[-1]
        ram_updates += sum(d > N_DOCS for d in ops[0])
        n_before = len(gpu_rt.segments)
        t0 = time.perf_counter()
        n = rt_apply(gpu_rt, ops)
        torch.cuda.synchronize()
        times.append(round((time.perf_counter() - t0) * 1e3, 1))
        if rt_apply(cpu_rt, ops) != n:
            raise AssertionError("rt write stream: the twins' commits differ")
        if len(gpu_rt.segments) <= n_before:
            merged.append(c)
    if len(merged) < 2 or not ram_updates:
        raise AssertionError(f"rt write stream: {len(merged)} progressive "
                             f"merges, {ram_updates} updates in RAM segments")
    print(f"rt write stream: {RT_COMMITS} commits of {RT_OPS} operations "
          f"(up to {RT_OPS // 8} each of updated, REPLACEd and deleted "
          f"documents, the rest inserts; {ram_updates} updates in RAM "
          f"segments in all), {len(merged)} of them with a progressive "
          f"merge (MERGE_SEGMENT_LIMIT {RtIndex.MERGE_SEGMENT_LIMIT}: "
          f"commits {merged}); host time per commit on cuda, the merge "
          f"included (ms) {times}")
    qs_b = qs + ranged + grouped
    rt_state("B (write stream)", gpu_rt, cpu_rt, qs_b, launches_by_path,
             t_start)

    # state C: FLUSH RAMCHUNK, then OPTIMIZE into one segment
    for op in ("flush_ramchunk", "optimize"):
        t0 = time.perf_counter()
        getattr(gpu_rt, op)()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        getattr(cpu_rt, op)()
        print(f"rt {op}: {dt:.2f} s on cuda, {time.perf_counter() - t0:.2f} "
              f"s on cpu; {len(gpu_rt.segments)} segments")
    rt_state("C (optimized)", gpu_rt, cpu_rt, qs_b, launches_by_path, t_start)
    del gpu_rt, cpu_rt, twins
    torch.cuda.empty_cache()
    rt_binlog_check(t_start)
    print(f"{since(t_start)} phase 19 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


SQL_QUERIES = 16         # of each of phase 3's batches
SQL_GROUPED = 4          # WorkloadGen.config4 draws (and their AVG twins)
SQL_PQ_QUERIES = 1000    # stored percolate queries
SQL_PQ_DOCS = 128        # documents of the CALL PQ
SQL_SNIPPET_DOCS = 64
SQL_WARM_RUNS = 2
# time-dependent rows and columns, masked by name in the twin comparison
SQL_MASK_ROWS = {("Variable_name", "Value"): "time",     # SHOW META
                 ("Counter", "Value"): "uptime"}         # SHOW STATUS
SQL_MASK_COLS = ("Connected", "Work time", "Last job took", "Duration")


def sql_masked(r) -> tuple:
    """A QLResult as a comparable tuple, its time fields masked."""
    cols = list(r.columns)
    rows = [tuple(row) for row in r.rows]
    key = SQL_MASK_ROWS.get(tuple(cols))
    if key is not None:
        rows = [(row[0], "<time>") + row[2:] if row and row[0] == key
                else row for row in rows]
    idx = [i for i, c in enumerate(cols) if c in SQL_MASK_COLS]
    if idx:
        rows = [tuple("<time>" if i in idx else v for i, v in enumerate(row))
                for row in rows]
    return cols, rows, r.error, r.warning, r.affected


def sql_match(q: SearchQuery) -> str:
    """A phase 3 query as a SELECT of the session layer."""
    where = f"MATCH('{q.match}')"
    for f in q.filters or []:
        where += f" AND {f.attr} BETWEEN {f.lo} AND {f.hi}"
    return f"SELECT id, WEIGHT() FROM {{t}} WHERE {where} LIMIT {q.limit}"


def sql_grouped(q: SearchQuery, agg: str) -> str:
    return (f"SELECT group_id, COUNT(*), {agg}(year) FROM docs WHERE "
            f"MATCH('{q.match}') GROUP BY group_id ORDER BY COUNT(*) DESC "
            f"LIMIT {q.limit}")


def corpus_texts(rows: list[int]) -> list[str]:
    """The text of corpus documents (row numbers): the token stream of
    ``bench_corpus.build_corpus`` drawn again from its seed."""
    rng = np.random.RandomState(42)
    lens = rng.randint(AVG_LEN // 2, AVG_LEN * 2, N_DOCS)
    offsets = np.zeros(N_DOCS + 1, np.int64)
    offsets[1:] = np.cumsum(lens)
    terms = np.minimum(rng.zipf(1.25, int(offsets[-1])) - 1, VOCAB - 1)
    width = max(4, len(str(VOCAB - 1)))
    return [" ".join(f"t{t:0{width}d}" for t in
                     terms[offsets[r]:offsets[r + 1]].tolist()) for r in rows]


class SqlTwins:
    """One SphinxQL stream to a ``Session`` on a ``Catalog(device="cuda")``
    and to its twin on a ``Catalog(device="cpu")``. Each statement runs on
    the card with the launch counters set to 0 just before and read just
    after, then on the twin; every ``QLResult`` must have no error (unless
    one is expected) and equal the twin's (columns, rows, error, warning,
    affected; time fields masked by name). While the card's statement
    runs, every ``RtIndex.search`` (and, for CALL PQ, every
    ``SearchIndex.search``) is recorded with its query; after it, the
    expected launches are counted from their plans (a statement's searches
    do not change its tables): one bit-plane launch per (query, segment)
    search whose plan reads packed windows, one segment-sum launch per
    float SUM / AVG aggregate of a grouped segment search."""

    def __init__(self, gpu_session, cpu_session):
        from manticoresearch_tpu_torch.index.rt import RtIndex
        import threading
        self.gpu, self.cpu = gpu_session, cpu_session
        self.lock = threading.Lock()
        self.on = False
        self.pq = False
        self.reset_step()
        self.rt_search = RtIndex.search
        self.si_search = SearchIndex.search
        twins = self

        def rt_search(rt, q):
            if not twins.on:
                return twins.rt_search(rt, q)
            t0 = time.perf_counter()
            res = twins.rt_search(rt, q)
            with twins.lock:
                twins.recorded.append((rt, q))
                twins.search_s += time.perf_counter() - t0
            return res

        def si_search(idx, q):
            if not (twins.on and twins.pq):
                return twins.si_search(idx, q)
            res = twins.si_search(idx, q)
            with twins.lock:
                twins.recorded.append((idx, q))
            return res
        RtIndex.search = rt_search
        SearchIndex.search = si_search

    def close(self) -> None:
        from manticoresearch_tpu_torch.index.rt import RtIndex
        RtIndex.search = self.rt_search
        SearchIndex.search = self.si_search

    def reset_step(self) -> None:
        self.want_k1 = self.want_seg = self.got_k1 = self.got_seg = 0
        self.searches = self.statements = 0
        self.recorded: list = []
        self.search_s = self.parse_s = self.wall_s = self.cpu_s = 0.0

    def run(self, sql: str, want_error: bool = False, twin: bool = True):
        """-> the card's results."""
        from manticoresearch_tpu_torch.query.sphinxql import (
            parse_sql, split_statements)
        t0 = time.perf_counter()
        for piece in split_statements(sql):
            try:
                parse_sql(piece)
            except ValueError:
                pass
        self.parse_s += time.perf_counter() - t0
        self.pq = sql.lstrip().upper().startswith("CALL PQ")
        torch.cuda.synchronize()
        ps.LAUNCHES.reset()
        gb.LAUNCHES.reset()
        self.recorded = []
        self.on = True
        t0 = time.perf_counter()
        try:
            got = self.gpu.execute(sql)
            torch.cuda.synchronize()
        finally:
            self.on = False
        self.last_wall = time.perf_counter() - t0
        self.wall_s += self.last_wall
        k1, plain = ps.LAUNCHES.kernel, ps.LAUNCHES.plain
        seg, seg_plain = gb.LAUNCHES.kernel, gb.LAUNCHES.plain
        want_k1 = want_seg = 0
        for table, q in self.recorded:
            if isinstance(table, SearchIndex):
                want_k1 += int(reads_packed(table, [q]))
            else:
                a, b = rt_launches(table, [q])
                want_k1, want_seg = want_k1 + a, want_seg + b
        self.searches += len(self.recorded)
        self.recorded = []
        self.want_k1 += want_k1
        self.want_seg += want_seg
        self.got_k1 += k1
        self.got_seg += seg
        self.statements += 1
        short = sql if len(sql) < 120 else sql[:117] + "..."
        if (k1, seg) != (want_k1, want_seg) or plain or seg_plain:
            raise AssertionError(
                f"session {short!r}: {k1} bit-plane and {seg} segment-sum "
                f"launches, {plain} plain decodes and {seg_plain} plain "
                f"sums; expected {want_k1}, {want_seg}, 0 and 0")
        for r in got:
            if (r.error is not None) != want_error:
                expected = "an" if want_error else "no"
                raise AssertionError(f"session {short!r}: error {r.error!r}"
                                     f" (expected {expected} error)")
        if twin:
            t0 = time.perf_counter()
            want = self.cpu.execute(sql)
            self.cpu_s += time.perf_counter() - t0
            if [sql_masked(r) for r in got] != [sql_masked(r) for r in want]:
                raise AssertionError(
                    f"session {short!r}: cuda {[sql_masked(r) for r in got]}"
                    f" != cpu {[sql_masked(r) for r in want]}")
        return got

    def step(self, name: str, launches_by_path: dict, t_start: float) -> None:
        """Close a step: its launch counts into the kernels line."""
        launches_by_path[f"session {name}"] = self.got_k1
        if self.got_seg:
            SEG_BY_PATH[f"session {name}"] = self.got_seg
        wall = max(self.wall_s, 1e-9)
        print(f"session {name}: {self.statements} statements on cuda and "
              f"cpu, equal; bitplane_decode launches {self.got_k1} "
              f"(expected {self.want_k1}, from the plans of "
              f"{self.searches} table searches), segment_sum_ordered "
              f"launches {self.got_seg} (expected {self.want_seg}), no "
              f"plain version; cuda wall {self.wall_s:.3f} s, of it "
              f"parse_sql {self.parse_s / wall:.4f} and the tables' search "
              f"{self.search_s / wall:.3f} (summed over the fan-out's "
              f"threads where a distributed table searches its parts); cpu "
              f"twin {self.cpu_s:.2f} s")
        print(f"{since(t_start)} session {name} done")
        self.reset_step()


class SqlBatch:
    """``search_batch`` over SQL text: one ``Session.execute`` per
    statement (for ``time_batch`` and ``profile_batch``)."""

    def __init__(self, session):
        self.session = session

    def search_batch(self, sqls: list[str]) -> list:
        return [self.session.execute(sql) for sql in sqls]


def sql_rows(res) -> list:
    return [(row[0], row[1]) for row in res.rows]


def check_sql_ties(name: str, sqls: list, got: list, want: list,
                   limits: list) -> None:
    """(docid, weight) rows and total_found against a reference, equal-weight
    runs normalized (``tie_runs``)."""
    for sql, g, w, lim in zip(sqls, got, want, limits):
        if tie_runs(g[0], lim) != tie_runs(w[0], lim) or g[1] != w[1]:
            raise AssertionError(f"{name} {sql!r}: {g} != {w}")
    print(f"{name}: {len(sqls)} SELECTs equal (total_found, weights, docids "
          "with ties normalized)")


def sql_select_meta(twins: SqlTwins, sql: str) -> tuple:
    """A SELECT and its SHOW META on both sessions: -> ((docid, weight)
    rows, total_found) of the card's."""
    res = twins.run(sql)
    meta = dict(twins.run("SHOW META")[0].rows)
    return sql_rows(res[0]), int(meta["total_found"])


def session_phase(packed, batches: dict, gpu_results: dict,
                  launches_by_path: dict, t_start: float) -> None:
    """Phase 20: the SphinxQL session layer on the card against its CPU
    twin: a 200k table by IMPORT TABLE, a write stream, percolate queries,
    distributed tables of 8 shards with and without an agent."""
    import asyncio
    import shutil
    import tempfile
    import threading
    from manticoresearch_tpu_torch.exec.session import Catalog, Session
    from manticoresearch_tpu_torch.index.storage import save_packed
    from manticoresearch_tpu_torch.server.agent import AgentServer
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")
    twins = None
    loop = None
    try:
        t0 = time.perf_counter()
        save_packed(packed, os.path.join(tmp, "docs"))
        print(f"session: the 200k index saved in "
              f"{time.perf_counter() - t0:.1f} s")
        gcat, ccat = Catalog(device="cuda"), Catalog(device="cpu")
        twins = SqlTwins(Session(gcat), Session(ccat))
        for sql in ("SET GLOBAL qcache_max_bytes=0",
                    f"IMPORT TABLE docs FROM '{os.path.join(tmp, 'docs')}'"):
            twins.run(sql)
        torch.cuda.synchronize()
        docs = gcat.tables["docs"]
        mib = sum(index_bytes(s.search) for s in docs.segments) / 2**20
        print(f"session: IMPORT TABLE docs: {docs.n_docs} docs, "
              f"{len(docs.segments)} segment, device memory {mib:.1f} MiB")
        twins.step("import table (200k docs)", launches_by_path, t_start)

        # 1. SELECTs on the 200k table
        qs = batches["config1"][:SQL_QUERIES] + \
            batches["config2"][:SQL_QUERIES]
        sqls = [sql_match(q).format(t="docs") for q in qs]
        none_sqls = [s + " OPTION ranker=none" for s in sqls]
        limits = [q.limit for q in qs]
        first = [sql_select_meta(twins, s) for s in sqls]
        want = [([(m.docid, m.weight) for m in r.matches], r.total_found)
                for r in gpu_results["config1"][:SQL_QUERIES]
                + gpu_results["config2"][:SQL_QUERIES]]
        check_sql_ties("session docs vs the 200k SearchIndex", sqls, first,
                       want, limits)
        none_first = [sql_select_meta(twins, s) for s in none_sqls]
        gen = bench_corpus.WorkloadGen(np.random.RandomState(33), VOCAB,
                                       packed)
        c4 = gen.config4(SQL_GROUPED)[1]
        grouped = [sql_grouped(q, agg) for agg in ("SUM", "AVG")
                   for q in c4]
        for sql in grouped:
            twins.run(sql)
        t1, t2 = qs[0].match, qs[SQL_QUERIES].match.split()[0]
        rows = list(range(0, N_DOCS, N_DOCS // SQL_SNIPPET_DOCS))
        texts = corpus_texts(rows[:SQL_SNIPPET_DOCS])
        extra = [
            f"SELECT id, WEIGHT() FROM docs WHERE MATCH('{t1}') LIMIT 5 "
            "FACET year ORDER BY COUNT(*) DESC, year ASC LIMIT 5",
            f"SELECT id, year FROM docs WHERE MATCH('{t1} | {t2}') ORDER BY "
            "year DESC, id ASC LIMIT 20, 10",
            f"SELECT id, year * 2 + group_id AS e FROM docs WHERE "
            f"MATCH('{t2}') LIMIT 10",
            f"SELECT group_id, COUNT(*) c FROM docs WHERE MATCH('{t1}') "
            "GROUP BY group_id HAVING c > 2 ORDER BY c DESC, group_id ASC "
            "LIMIT 10",
            f"SELECT id, WEIGHT() FROM docs WHERE MATCH('{t1} {t2}') "
            "LIMIT 10 OPTION ranker=sph04",
            f"CALL KEYWORDS('{t1} {t2} t00001', 'docs', 1)",
            "CALL SNIPPETS((" + ", ".join(f"'{t}'" for t in texts) +
            f"), 'docs', '{t1} {t2}', 5 AS around, 200 AS limit)"]
        for sql in extra:
            twins.run(sql)
        warm = []
        for sql in sqls[:8]:
            t0 = time.perf_counter()
            for _ in range(SQL_WARM_RUNS):
                twins.gpu.execute(sql)
            torch.cuda.synchronize()
            warm.append(round((time.perf_counter() - t0) * 1e3
                              / SQL_WARM_RUNS, 2))
        print(f"session select: warm wall per SELECT on cuda, the first 8 "
              f"(ms): {warm}")
        twins.step("select (200k docs)", launches_by_path, t_start)
        time_batch("session select (200k docs, 32 SELECTs)",
                   SqlBatch(twins.gpu), sqls, SQL_WARM_RUNS, sqls[:1])

        # 2. a write stream by SphinxQL
        rng = np.random.RandomState(35)
        next_id = N_DOCS + 1
        commit_ms, merged = [], []
        cdocs = ccat.tables["docs"]
        for c in range(RT_COMMITS):
            (updates, year, replaces, inserts, deletes,
             next_id) = rt_write_stream(rng, cdocs, next_id)

            def values(ds):
                return ", ".join(f"({d['id']}, '{d['content']}', "
                                 f"{d['year']}, {d['group_id']})" for d in ds)
            cols = "(id, content, year, group_id)"
            txn = "; ".join([
                "BEGIN",
                f"UPDATE docs SET year = {year} WHERE id IN "
                f"({', '.join(map(str, updates))})",
                f"REPLACE INTO docs {cols} VALUES {values(replaces)}",
                f"INSERT INTO docs {cols} VALUES {values(inserts)}",
                f"DELETE FROM docs WHERE id IN "
                f"({', '.join(map(str, deletes))})",
                "COMMIT"])
            n_before = len(docs.segments)
            twins.run(txn)
            commit_ms.append(round(twins.last_wall * 1e3, 1))
            if len(docs.segments) <= n_before:
                merged.append(c)
        if len(merged) < 2:
            raise AssertionError(f"session write stream: {len(merged)} "
                                 "progressive merges")
        print(f"session write stream: {RT_COMMITS} transactions of "
              f"{RT_OPS} operations (UPDATE, REPLACE, INSERT, DELETE), "
              f"{len(merged)} with a progressive merge (commits {merged}); "
              f"{len(docs.segments)} segments, {docs.n_docs} docs; wall per "
              f"transaction on cuda (ms) {commit_ms}")
        twins.step("write stream", launches_by_path, t_start)
        for sql in sqls + grouped:
            twins.run(sql)
            twins.run("SHOW META")
        twins.step("select after writes", launches_by_path, t_start)
        time_batch("session select after writes", SqlBatch(twins.gpu),
                   sqls, SQL_WARM_RUNS, sqls[:1])
        for sql in ("FLUSH RAMCHUNK docs", "OPTIMIZE TABLE docs"):
            twins.run(sql)
            print(f"session {sql}: {twins.last_wall:.3f} s on cuda; "
                  f"{len(docs.segments)} segments")
        if len(docs.segments) != 1:
            raise AssertionError("session OPTIMIZE left "
                                 f"{len(docs.segments)} segments")
        twins.step("flush ramchunk and optimize", launches_by_path, t_start)
        for sql in sqls + grouped:
            twins.run(sql)
            twins.run("SHOW META")
        twins.step("select after optimize", launches_by_path, t_start)
        time_batch("session select after optimize", SqlBatch(twins.gpu),
                   sqls, SQL_WARM_RUNS, sqls[:1])

        # 3. percolate
        twins.run("CREATE TABLE pq (content text, year uint) "
                  "type='percolate'")
        gen = bench_corpus.WorkloadGen(np.random.RandomState(37), VOCAB,
                                       packed)
        pq_rng = np.random.RandomState(39)
        stored = [q.match for q in config1_queries(gen, SQL_PQ_QUERIES // 2)
                  + config2_queries(gen, SQL_PQ_QUERIES // 2)]
        for lo in range(0, len(stored), 250):
            vals = []
            for i, m in enumerate(stored[lo:lo + 250], lo + 1):
                filt = (f"year > {2000 + int(pq_rng.randint(0, 25))}"
                        if pq_rng.rand() < 0.1 else "")
                vals.append(f"({i}, '{m}', '{filt}')")
            twins.run("INSERT INTO pq (id, query, filters) VALUES "
                      + ", ".join(vals))
        rows = pq_rng.choice(N_DOCS, SQL_PQ_DOCS, replace=False).tolist()
        docs_json = [json.dumps({"content": t, "year": 2000 + r % 25})
                     for t, r in zip(corpus_texts(rows), rows)]
        pq_sql = ("CALL PQ('pq', (" + ", ".join(f"'{d}'" for d in docs_json)
                  + "), 1 AS docs_json, 1 AS docs)")
        searched = twins.searches
        res = twins.run(pq_sql)
        print(f"session CALL PQ: {SQL_PQ_QUERIES} stored queries, "
              f"{SQL_PQ_DOCS} documents: {len(res[0].rows)} queries match, "
              f"{twins.searches - searched} stored queries searched (the "
              f"others rejected by their terms); wall "
              f"{twins.last_wall:.3f} s on cuda")
        if not res[0].rows:
            raise AssertionError("session CALL PQ: no stored query matched")
        twins.step("call pq", launches_by_path, t_start)

        # 4. distributed: 8 local shards, then 6 local shards and an agent
        t0 = time.perf_counter()
        shards = bench_corpus.build_corpus_shards(N_DOCS, VOCAB, AVG_LEN,
                                                  SHARDS)
        for i, sh in enumerate(shards):
            save_packed(sh, os.path.join(tmp, f"s{i}"))
        del shards
        print(f"session: {SHARDS} shards built and saved in "
              f"{time.perf_counter() - t0:.1f} s")
        for i in range(SHARDS):
            twins.run(f"IMPORT TABLE s{i} FROM '{os.path.join(tmp, f's{i}')}'")
        twins.run("CREATE TABLE dist type='distributed' " + " ".join(
            f"local='s{i}'" for i in range(SHARDS)))
        twins.step("import tables (8 shards)", launches_by_path, t_start)
        dist_sqls = [sql_match(q).format(t="dist") for q in qs]
        dist = [sql_select_meta(twins, s) for s in dist_sqls]
        # each local part ranks with its own term statistics, so ranked
        # weights differ from one table's; total_found does not, nor do
        # the rows under ranker=none
        for sql, d, f in zip(dist_sqls, dist, first):
            if d[1] != f[1]:
                raise AssertionError(f"session dist {sql!r}: total_found "
                                     f"{d[1]} != docs {f[1]}")
        dist_none = [sql_select_meta(twins, s + " OPTION ranker=none")
                     for s in dist_sqls]
        check_sql_ties("session dist vs docs (ranker=none)", dist_sqls,
                       dist_none, none_first, limits)
        twins.step("distributed (8 local shards)", launches_by_path, t_start)
        dist_ms = []
        for sql in dist_sqls[:8]:
            t0 = time.perf_counter()
            twins.gpu.execute(sql)
            dist_ms.append(round((time.perf_counter() - t0) * 1e3, 2))

        acat = Catalog(device="cuda")
        asess = Session(acat)
        for i in (SHARDS - 2, SHARDS - 1):
            r = asess.execute(f"IMPORT TABLE s{i} FROM "
                              f"'{os.path.join(tmp, f's{i}')}'")
            if r[0].error is not None:
                raise AssertionError(f"agent IMPORT TABLE: {r[0].error}")
        srv = AgentServer(acat, port=0)
        loop = asyncio.new_event_loop()
        started = threading.Event()

        def serve():
            asyncio.set_event_loop(loop)
            loop.run_until_complete(srv.start())
            started.set()
            loop.run_forever()
        agent_thread = threading.Thread(target=serve, daemon=True)
        agent_thread.start()
        if not started.wait(30):
            raise AssertionError("agent server did not start")
        twins.run("CREATE TABLE dist2 type='distributed' " + " ".join(
            f"local='s{i}'" for i in range(SHARDS - 2)) + " " + " ".join(
            f"agent='127.0.0.1:{srv.port}:s{i}'"
            for i in (SHARDS - 2, SHARDS - 1)), twin=False)
        d2_sqls = [s.replace("FROM dist ", "FROM dist2 ") for s in dist_sqls]
        d2 = []
        for sql in d2_sqls:
            res = twins.run(sql, twin=False)
            meta = dict(twins.run("SHOW META", twin=False)[0].rows)
            d2.append((sql_rows(res[0]), int(meta["total_found"])))
        check_sql_ties("session dist2 (6 local shards and an agent) vs dist",
                       d2_sqls, d2, dist, limits)
        twins.step("distributed (6 local shards and an agent)",
                   launches_by_path, t_start)
        d2_ms = []
        for sql in d2_sqls[:8]:
            t0 = time.perf_counter()
            twins.gpu.execute(sql)
            d2_ms.append(round((time.perf_counter() - t0) * 1e3, 2))
        print(f"session distributed: warm wall per SELECT on cuda, the "
              f"first 8 (ms): 8 local shards {dist_ms}; 6 local shards and "
              f"an agent {d2_ms}")
        mem = sum(index_bytes(s.search) for t in list(gcat.tables.values())
                  + list(acat.tables.values())
                  for s in getattr(t, "segments", []))
        print(f"session: device memory of the card's tables "
              f"{mem / 2**20:.1f} MiB (allocated "
              f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB)")
        time_batch("session dist2", SqlBatch(twins.gpu), d2_sqls[:8], 1,
                   d2_sqls[:1])
    finally:
        if loop is not None:
            for t in gcat.tables.values():
                for agent in getattr(t, "agents", []):
                    for m in agent.mirrors:
                        for sock in m._pool():
                            sock.close()
            asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(30)
            loop.call_soon_threadsafe(loop.stop)
            agent_thread.join(30)
        if twins is not None:
            twins.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{since(t_start)} phase 20 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


CLUSTER_TXNS = 8         # write transactions from each of the two nodes
# rows per replicated REPLACE / INSERT statement: a member reads each write
# set as one line of asyncio's default 64 KiB limit, and a longer line
# stops its applier (a fault of the JAX package, ROADMAP queue 3); 24 rows
# of at most 200 corpus tokens stay under 34 KB
CLUSTER_ROWS = 24
CLUSTER_DEADLINE = 120.0  # seconds a node may take to apply a sequence


class ClusterNode:
    """A ``Catalog(data_dir, device)`` with a ``ClusterService`` bound to
    port 0 (its ``port`` read back from the socket) and a ``Session``."""

    def __init__(self, data_dir: str, device: str):
        from manticoresearch_tpu_torch.exec.session import Catalog, Session
        from manticoresearch_tpu_torch.server.cluster import ClusterService
        self.cat = Catalog(data_dir, device=device)
        self.svc = ClusterService(self.cat, port=0)
        self.svc.start()
        self.svc.port = self.svc._server.sockets[0].getsockname()[1]
        self.cat.cluster_service = self.svc
        self.sess = Session(self.cat)

    def execute(self, sql: str) -> list:
        res = self.sess.execute(sql)
        for r in res:
            if r.error is not None:
                raise AssertionError(f"cluster {sql[:100]!r}: {r.error}")
        return res

    def applied(self, name: str) -> int:
        return self.cat.clusters[name].applied


def wait_applied(nodes: list, name: str, seq: int) -> None:
    t0 = time.perf_counter()
    while not all(n.applied(name) >= seq for n in nodes):
        if time.perf_counter() - t0 > CLUSTER_DEADLINE:
            raise AssertionError(f"cluster {name}: seq {seq} not applied "
                                 f"({[n.applied(name) for n in nodes]})")
        time.sleep(0.002)


def cluster_phase(packed, batches: dict, launches_by_path: dict,
                  t_start: float) -> None:
    """Phase 21: replication on the card. Two nodes on the card and a CPU
    twin cluster of two: node A imports the 200k table, CREATE CLUSTER,
    ALTER CLUSTER ADD; node B joins (the table reaches it by snapshot
    transfer onto its device); 8 write transactions from each node
    through ``cluster:table`` (B's REPLACE the ids A's just did); then
    phase 20's SELECTs and SHOW META on both card nodes, each equal to its
    CPU twin (launches counted from the plans) and to each other."""
    import shutil
    import tempfile
    from manticoresearch_tpu_torch.index.storage import save_packed
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    nodes: dict = {}
    twins = None
    try:
        save_packed(packed, os.path.join(tmp, "docs"))
        for dev in ("cuda", "cpu"):
            nodes[dev] = [ClusterNode(os.path.join(tmp, f"{dev}{i}"), dev)
                          for i in range(2)]
        a, b = nodes["cuda"]
        ca, cb = nodes["cpu"]
        twins = SqlTwins(a.sess, ca.sess)
        for n in (b, cb):
            n.execute("SET GLOBAL qcache_max_bytes=0")
        for sql in ("SET GLOBAL qcache_max_bytes=0",
                    f"IMPORT TABLE docs FROM '{os.path.join(tmp, 'docs')}'",
                    "CREATE CLUSTER c", "ALTER CLUSTER c ADD docs"):
            twins.run(sql)
        twins.step("cluster create (node A)", launches_by_path, t_start)
        sst = {}
        for dev, (donor, joiner) in nodes.items():
            t0 = time.perf_counter()
            joiner.execute(f"JOIN CLUSTER c AT '127.0.0.1:{donor.svc.port}'")
            torch.cuda.synchronize()
            sst[dev] = time.perf_counter() - t0
        jt, dt = b.cat.tables["docs"], a.cat.tables["docs"]
        on_card = [on_cuda(s.search) for s in jt.segments]
        if (jt.n_docs != dt.n_docs or len(jt.segments) != len(dt.segments)
                or not all(on_card)):
            raise AssertionError(
                f"cluster JOIN: node B holds {jt.n_docs} docs in "
                f"{len(jt.segments)} segments (on the card: {on_card}), "
                f"node A {dt.n_docs} in {len(dt.segments)}")
        mib = sum(index_bytes(s.search) for s in jt.segments) / 2**20
        print(f"cluster JOIN (SST of the {jt.n_docs}-doc table, then the "
              f"log): {sst['cuda']:.2f} s onto the card ({mib:.1f} MiB "
              f"there), {sst['cpu']:.2f} s onto the CPU twin")

        # writes from both nodes through cluster:table
        rng = np.random.RandomState(41)
        next_id = N_DOCS + 1
        lat_ms, cols = [], "(id, content, year, group_id)"

        def values(ds):
            return ", ".join(f"({d['id']}, '{d['content']}', {d['year']}, "
                             f"{d['group_id']})" for d in ds)
        last_replaces: list = []
        for t in range(2 * CLUSTER_TXNS):
            role = t % 2                  # 0: node A, 1: node B
            (updates, year, replaces, inserts, deletes,
             next_id) = rt_write_stream(rng, ca.cat.tables["docs"], next_id)
            if role == 1:                 # the ids A just replaced
                replaces = [dict(d, year=2000 + (d["year"] + 7) % 25,
                                 group_id=(d["group_id"] + 1) % 100)
                            for d in last_replaces]
            last_replaces = replaces
            txn = ([f"UPDATE c:docs SET year = {year} WHERE id IN "
                    f"({', '.join(map(str, updates))})"]
                   + [f"{verb} INTO c:docs {cols} VALUES "
                      f"{values(rows[i:i + CLUSTER_ROWS])}"
                      for verb, rows in (("REPLACE", replaces),
                                         ("INSERT", inserts))
                      for i in range(0, len(rows), CLUSTER_ROWS)]
                   + [f"DELETE FROM c:docs WHERE id IN "
                      f"({', '.join(map(str, deletes))})"])
            for dev in ("cuda", "cpu"):
                node = nodes[dev][role]
                t0 = time.perf_counter()
                got = [node.execute(sql)[0].affected for sql in txn]
                wait_applied(nodes[dev], "c", node.applied("c"))
                if dev == "cuda":
                    torch.cuda.synchronize()
                    lat_ms.append(round((time.perf_counter() - t0) * 1e3, 1))
                    want = got
                elif got != want:
                    raise AssertionError(f"cluster txn {t}: affected {want}"
                                         f" on the card, {got} on the CPU")
        seqs = {dev: [n.applied("c") for n in ns]
                for dev, ns in nodes.items()}
        if len(set(seqs["cuda"] + seqs["cpu"])) != 1:
            raise AssertionError(f"cluster sequence numbers differ: {seqs}")
        if a.cat.tables["docs"].n_docs != b.cat.tables["docs"].n_docs:
            raise AssertionError("cluster: node A and B differ in docs")
        print(f"cluster writes: {2 * CLUSTER_TXNS} transactions of "
              f"{RT_OPS} operations (an UPDATE, a DELETE and REPLACE / "
              f"INSERT statements of at most {CLUSTER_ROWS} rows each, "
              f"alternately from node A and node B; B REPLACEs A's ids), "
              f"every node at seq "
              f"{seqs['cuda'][0]}; {len(jt.segments)} segments, "
              f"{jt.n_docs} docs; replicate-to-applied on both card nodes "
              f"per transaction (ms) {lat_ms}")

        # phase 20's SELECTs on both card nodes, each against its CPU twin
        gen = bench_corpus.WorkloadGen(np.random.RandomState(33), VOCAB,
                                       packed)
        qs = batches["config1"][:SQL_QUERIES] + \
            batches["config2"][:SQL_QUERIES]
        sqls = [sql_match(q).format(t="docs") for q in qs]
        sqls += [sql_grouped(q, agg) for agg in ("SUM", "AVG")
                 for q in gen.config4(SQL_GROUPED)[1]]
        got: dict = {}
        for tag, (gnode, cnode) in (("A", (a, ca)), ("B", (b, cb))):
            twins.gpu, twins.cpu = gnode.sess, cnode.sess
            got[tag] = []
            walls = []
            for sql in sqls:
                got[tag].append([sql_masked(r) for r in twins.run(sql)])
                walls.append(round(twins.last_wall * 1e3, 1))
                got[tag].append([sql_masked(r)
                                 for r in twins.run("SHOW META")])
            print(f"cluster node {tag}: wall per SELECT on cuda (ms) "
                  f"{walls}")
            twins.step(f"cluster select (node {tag})", launches_by_path,
                       t_start)
        if got["A"] != got["B"]:
            diff = next(i for i, (x, y) in enumerate(zip(got["A"], got["B"]))
                        if x != y)
            raise AssertionError(f"cluster: node A and node B differ at "
                                 f"statement {diff}: {got['A'][diff]} != "
                                 f"{got['B'][diff]}")
        print(f"cluster: {len(sqls)} SELECTs and their SHOW META equal on "
              "both card nodes and their CPU twins")
    finally:
        if twins is not None:
            twins.close()
        for ns in nodes.values():
            for n in ns:
                n.svc.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{since(t_start)} phase 21 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


def set_sparse_mode(mode: str, *indexes: SearchIndex) -> None:
    """The planner's MT_SPARSE override; cached plans are dropped."""
    os.environ["MT_SPARSE"] = mode
    for idx in indexes:
        idx._plan_cache.clear()


def tree_bytes(tree: dict) -> int:
    """Bytes of the tensors of a data dict (one level of nested dicts)."""
    total = 0
    for v in tree.values():
        for t in (v.values() if isinstance(v, dict) else [v]):
            total += t.numel() * t.element_size()
    return total


def on_cuda(idx: SearchIndex) -> bool:
    """Whether every tensor of an index's data lies on the card."""
    tree = idx.device.data_pytree()
    return all(t.is_cuda for v in tree.values()
               for t in (v.values() if isinstance(v, dict) else [v]))


def index_bytes(idx: SearchIndex) -> int:
    return tree_bytes(idx.device.data_pytree())


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

    print(f"{since(t_start)} 200k config 4 done")

    # 15. the expression ranker at 200k: formula, sph04, PACKEDFACTORS()
    base, ex = expr_batches(packed, 25)
    max_err = max(max_err, expr_phase("200k", gpu, cpu, base, ex,
                                      launches_by_path, 2))
    seg_calls_pf_dense = capture_segment_calls(gpu, ex["packedfactors"])
    print(f"{since(t_start)} 200k expression ranker done")

    # 18. config 5: the distributed index, 8 shards of the 200k corpus on
    # the card, against the CPU twin and the single 200k index
    sharded_phase(gpu, batches, gpu_results, launches_by_path, t_start)

    # 19. the RT index: 8 disk chunks of the 200k corpus, a write stream,
    # FLUSH RAMCHUNK and OPTIMIZE, against the CPU twin; a binlog reload
    rt_phase(packed, batches, gpu_results, launches_by_path, t_start)

    # 20. the SphinxQL session layer: a 200k table by IMPORT TABLE, a write
    # stream, percolate queries, distributed tables, against the CPU twin
    session_phase(packed, batches, gpu_results, launches_by_path, t_start)

    # 21. replication: two nodes on the card and a CPU twin cluster; the
    # 200k table by snapshot transfer, writes from both nodes
    cluster_phase(packed, batches, launches_by_path, t_start)
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

    # 15 at 1M: the expression ranker's batches, dense plans
    # (16 draws, not 64: the CPU port's dense 1M comparisons of these
    # batches are the slowest part of the run)
    base, ex = expr_batches(big, 26, BATCH // 4)
    max_err = max(max_err, expr_phase(tag, gpu, cpu, base, ex,
                                      launches_by_path, 2))
    seg_calls_pf = capture_segment_calls(gpu, ex["packedfactors"])
    print(f"{since(t_start)} {tag} expression ranker done")
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
                                ("bigram phrases", "all", bigram_queries()),
                                ("expression ranker kinds", "",
                                 expr_kind_queries())):
        t0 = time.perf_counter()
        small = positional_index(bigram)
        gpu = SearchIndex(small, device="cuda")
        cpu = SearchIndex(small, device="cpu")
        print(f"{variant}: {small.n_docs} docs built and uploaded in "
              f"{time.perf_counter() - t0:.1f} s")
        if not reads_packed(gpu, qs):
            raise AssertionError(f"{variant}: no packed window on the path")
        # the expression ranker's plans are dense whatever MT_SPARSE asks
        expr = variant.startswith("expression")
        for mode in ("auto",) if expr else ("auto", "always"):
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
            if expr and not all(cq.sig.ranker == "expr"
                                and not cq.sig.sparse for cq in cqs):
                raise AssertionError(f"{variant}: a plan is sparse or not "
                                     "expr")
            if (mode == "always" and not expr
                    and not all(cq.sig.sparse for cq in cqs)):
                raise AssertionError(f"{variant}: MT_SPARSE=always left a "
                                     "plan dense")
            name = f"{variant} ({mode})"
            res, _ = run_counted(name, gpu, qs, launches_by_path,
                                 want_seg=None if expr else 0)
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

    # 17. a 40-field index: two fieldmask words, every term raw
    t0 = time.perf_counter()
    small = wide_field_index()
    gpu = SearchIndex(small, device="cuda")
    cpu = SearchIndex(small, device="cpu")
    print(f"40-field index: {small.n_docs} docs built and uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    qs = wide_field_queries()
    if reads_packed(gpu, qs):
        raise AssertionError("40-field index: a packed window on the path")
    cqs = [cq for cq in (program_plan(gpu, q) for q in qs) if cq]
    if any(cq.sig.sparse for cq in cqs):
        raise AssertionError("40-field index: a plan is not dense")
    print(f"40-field index: rankers "
          f"{dict(Counter(cq.sig.ranker for cq in cqs))}")
    res, _ = run_counted("40-field index", gpu, qs, launches_by_path,
                         want_seg=None)
    check_equal("40-field index", qs, res, cpu.search_batch(qs))
    time_batch("40-field index", gpu, qs, 3)
    del gpu, cpu, small
    print(f"{since(t_start)} 40-field index done")

    # 14. the segment-sum kernel: checks, and timing at the config-4 AVG
    # and PACKEDFACTORS() batches' calls (the kernels line takes the 1M
    # config-4 AVG batch's) and at the chain- and sink-bound cases
    seg_err = check_segment_kernel(seg_calls_dense + seg_calls
                                   + seg_calls_pf_dense + seg_calls_pf)
    time_segment("200k config-4 avg batch (dense, full width)",
                 seg_calls_dense, iters=10)
    seg = time_segment(f"{tag} config-4 avg batch", seg_calls, iters=20)
    time_segment("200k PACKEDFACTORS() batch (factor scatters)",
                 seg_calls_pf_dense, iters=5)
    time_segment(f"{tag} PACKEDFACTORS() batch (factor scatters)",
                 seg_calls_pf, iters=5)
    for name, v, g, n in segment_cases():
        if name.startswith(("one group", "groups then")):
            time_segment(name, [(torch.from_numpy(v).cuda(),
                                 torch.from_numpy(g).cuda(), n)],
                         iters=3 if name.startswith("one group") else 20)
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
        "bound_ms": seg["bound_ms"], "bound_by": seg["bound_by"],
        "library_ms": seg["library_ms"]}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
