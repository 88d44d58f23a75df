#!/usr/bin/env python3
"""Smoke run of the PyTorch port's search paths on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; each raises on a wrong result or launch count, so the exit code
is then not 0. Every path is driven through ``SearchIndex.search_batch``
(``ShardedIndex.search_batch`` in phase 18, ``RtIndex.search`` query by
query in phase 19, ``Session.execute`` statement by statement in phases
20 and 21, a listener's request in phase 22) on ``device="cuda"`` with
the launch counters set to 0 just before and read just after, and its
results are held equal to the same queries on ``device="cpu"`` (in phase
24, the bench's own runs, to its host model of the scoring).

1. Require CUDA. Print the card (``nvidia-smi`` name and power limit) and
   the torch and CUDA versions. Start the host-build process (spawned,
   never on the card): it builds phase 18's shards (which phases 19 and
   20 copy) and phase 9's 1M corpus with its packed store while this
   process drives the card; it is stopped when the run ends.
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
    launches per query (the PACKEDFACTORS() batch profiled on its first 4
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
18b. The distributed index in parts (``ShardedIndex(shards,
    devices=[...])``, one part per mesh position; after phase 18's
    batches, on its 8 shards): 4 parts of 2 shards and 8 parts of one (the
    JAX package's layout) on ``cuda:0``, each through
    ``tools.multichip.check_mesh``: every query merged, exactly one K1
    launch per part per merged batch (4 or 8 on this card), results equal
    to phase 18's one-part index and (docids, weights, total_found) to
    phase 5's single index, warm walls in turns with the one-part index,
    one profiled batch of 4 queries with each card's busy share. Where
    more than one card is visible, the same over ``make_mesh`` (up to 8
    cards, one part each); on one card it prints that it ran none. Then
    phase 18's route batch on 4 parts of 2 shards: one K1 launch per part
    for the merged queries plus one per shard search of the fallback,
    equal to the CPU twin.
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
    with ``save_packed`` and loaded by ``IMPORT TABLE docs``; the first 8
    config-1 and 8 config-2 queries as ``SELECT id, WEIGHT() ... LIMIT
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
    distributed table over them: the 16 SELECTs, equal to the twin, with
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
    node of both clusters at the same sequence number. Then phase 20's 16
    SELECTs and 8 GROUP BYs, each with SHOW META, on node A and on node B,
    each statement equal to its CPU twin with the launches counted from
    the plans (``SqlTwins``), and node A's results equal to node B's.
22. The front ends (after phase 21, at 200k). 1: the port's
    ``MysqlServer``, ``HttpServer`` and ``ApiServer`` on one asyncio loop
    in a thread over ``Catalog(device="cuda")``, and a twin set over
    ``Catalog(device="cpu")``, each bound to port 0; every request goes to
    both (``FrontTwins``), the answers equal with time fields masked by
    name (SHOW META ``time``, SHOW STATUS ``uptime``, ``took``, the API's
    ``time_ms``), each card request counted as ``SqlTwins`` counts a
    statement. The 200k corpus by ``save_packed`` and IMPORT TABLE over
    MySQL;
    the first 8 config-1 and 8 config-2 queries as MySQL ``SELECT id,
    WEIGHT() ... LIMIT 10`` with SHOW META, as HTTP ``/sql`` and
    ``/json/search`` (``query_string``) and as one SphinxAPI multi-query
    of 16, each protocol's docids and weights equal to phase 5's (ties
    normalized), and that multi-query from 4 connections at once (the
    listener searches from as many worker threads), each answer equal to
    the one-client answer; 4 ``WorkloadGen.config4`` draws with
    ``AVG(year)`` over MySQL and ``/sql``; then 4 MySQL transactions of
    256 operations (REPLACE / INSERT statements of at most 24 rows),
    ``/json/insert``, ``replace``, ``update``, ``delete`` and a
    ``/json/bulk`` of 64 documents, and the queries again; a
    ``/json/search`` with ``highlight`` (on a 24-row table that stores its
    text); a percolate table with 100 stored
    queries by ``/json/pq/pq/doc`` and ``/json/pq/pq/search`` over 16
    documents; SphinxAPI KEYWORDS and STATUS and a MySQL ping. Walls and
    the tables' search share per protocol, one profiled ``/sql`` request.
    2: ``python -m manticoresearch_tpu_torch.server.daemon`` as a process
    on three free ports: IMPORT TABLE over ``/sql`` (the card's free
    memory must fall by at least 0.9 of the table's device bytes), the 16
    SELECTs over MySQL and ``/sql`` and the multi-query equal to part 1's
    card answers, ``tools.replay --host`` of a query log written by a CPU
    session returns 0, SIGTERM ends it with code 0 within 30 s, a restart
    on its data directory serves the same answers, and ``tools.replay
    --data-dir`` on the card returns 0.
23. The 200k corpus indexed from text (after phase 22): the native
    tokenizer library (``manticoresearch_tpu_torch/native``, g++) must
    build and load; every corpus document rendered as text
    (``corpus_texts``, about 25M tokens) with ``build_corpus``'s ids and
    attribute values; its first 20,000 documents built by the port's
    ``IndexBuilder`` on the native path and on the Python path (the
    library turned off), every array of ``PackedIndex`` and
    ``packed_store()`` equal; all of them built on the native path (build
    and render seconds, seconds per million tokens); phase 3's config-1
    and config-2 batches through ``SearchIndex(..., device="cuda")`` over
    it: one K1 launch per batch, docids, weights and total_found equal to
    phase 5's results with ties normalized (and the count of results
    equal without normalizing).
24. The port's bench (after phase 23): ``tools.bench.main`` in this
    process, building its own corpus (bench.py's default, the same as
    phase 3's) with ``--batches 1 --budget 5 --scale-docs ""``: the parity
    gate's 24 searches, a warm-up and a measured batch of each of configs
    1-4 (128 queries; 32 for config 4) and config 5 on ``min(8, cards)``
    shards, one per card. Every ``SearchIndex`` round (``_drive``) and
    ``ShardedIndex.search_batch`` is counted from 0: one K1 launch where
    it reads packed windows, no plain decode or sum. The bench's JSON
    line is printed (``bench line: ...``) and must hold bench.py's keys
    plus ``device`` (the card's ``nvidia-smi`` name and power limit and
    the number of cards), ``recall_at_10`` 1.0 and every config measured.
    Then the host planner's share of a bench batch: the wall of a fresh
    config-1 (and config-2) batch of 128, and of another planned first
    (the plans' time, then the batch's).
25. The LCS walk kernel (csrc/lcs_walk.cu; after phase 9b, at 1M): one
    query of each of the 12 non-term categories of Lucene's nightly tasks
    (``bench_corpus.lucene_categories``), each on the card with exactly
    one kernel call and results equal to the CPU's; the kernel bit-exact
    against the eager hit stream (its plain version, the same query with
    the walk refused) on the AndHighHigh, HighPhrase and HighSloppyPhrase
    programs, and timed there. The positional walk (csrc/pos_walk.cu) in
    the same queries: one launch for each Phrase and SloppyPhrase
    category (counted per path with the other paths' in
    ``POS_BY_PATH``), none for the others, bit-exact against the eager
    nodes (the query with the walk refused) and timed at HighPhrase and
    HighSloppyPhrase. ``capture`` runs each query with the kernel and
    again with it refused; ``time_kernel`` times both kernels.
    ``chip_walks.py`` times both walks at the benchmark's shapes.
Each batch of phases 5-13 and 15-20 prints its warm walls and one profiled
run of at most its first 16 queries (4 of a PACKEDFACTORS() or config-5
batch): device time, busy share, kernel launches, host waits and copies.
Every hand kernel is timed by ``time_kernel``, one recipe: bit-exact
against its plain version first, then CUDA events in turns, the device
time from the profiler, bytes and bound. A kernel's entry
(``decode_entry``, ``segment_entry``, ``walk_entry``, ``pos_entry``)
supplies its call, its plain version, the comparison, its profiler events
and its bytes. Every check of a result and every launch count raises on a
failure; a time does not: where the profiler recorded no launch of a
kernel that the counters saw, the run prints so and times the kernel with
CUDA events.

The last three lines of standard output are one JSON object with the
kernels' numbers, the card's name and power limit, then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import multiprocessing
import os
import struct
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
from manticoresearch_tpu_torch.ops import search as ops_search
from manticoresearch_tpu_torch.ops.search import packed_windows, window_kinds
from manticoresearch_tpu_torch.query.planner import AttrFilterDef
from manticoresearch_tpu_torch.tools import multichip
from manticoresearch_tpu_torch.tools.multichip import summary

N_DOCS, VOCAB, AVG_LEN = 200_000, 50_000, 100
BIG_DOCS = 1_000_000       # bench.py's scale.1000k_docs
BATCH = 64
WARM_RUNS = 5
# queries of a batch run under the profiler: reading back its events takes
# about 0.45 ms per kernel launch on the card's host, so a whole config-3
# batch (about 21,600 launches) would take 10 s
PROFILE_QUERIES = 16
PROFILE_QUERIES_HEAVY = 4   # PACKEDFACTORS() and config 5: 1,400-3,000 each
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, published peak
KERNEL_SOURCE = "manticoresearch_tpu_torch/csrc/bitplane_decode.cu"
KERNEL_REPLACES = "manticoresearch_tpu/ops/pfor.py:109"
KERNEL_EVENT = "bitplane_decode_grouped"
WALK_EVENT = "lcs_walk_kernel"
KERNEL_SMEM_ITEMS = 2048   # csrc/bitplane_decode.cu: kSmemItems
WALK_SOURCE = "manticoresearch_tpu_torch/csrc/lcs_walk.cu"
WALK_REPLACES = "manticoresearch_tpu/ops/search.py:1191-1225 (XLA, no Pallas)"
POS_EVENT = "pos_walk_kernel"
POS_SOURCE = "manticoresearch_tpu_torch/csrc/pos_walk.cu"
POS_REPLACES = ("manticoresearch_tpu/ops/search.py _pred_scan under "
                "_eval_phrase_node (XLA, no Pallas)")
SEG_SOURCE = "manticoresearch_tpu_torch/csrc/segment_sum.cu"
SEG_REPLACES = "manticoresearch_tpu/ops/groupby.py:145"
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
# LCS walk launches of each counted path that runs the walk
WALK_BY_PATH: dict = {}
# positional walk launches of each counted path that runs it
POS_BY_PATH: dict = {}


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


def time_kernel(what: str, kernel, plain, differ, events: dict, byts: int,
                iters: int, plain_name: str = "plain version",
                flush: bool = True, calls: int = 1,
                library: tuple | None = None, bound=None, **extras) -> dict:
    """A hand kernel checked and timed by the one recipe of this run.

    ``kernel`` and ``plain`` are functions of no arguments that run the
    kernel's wrapper and its plain version on the same ``calls`` calls;
    every time below is per call. ``differ(got, want)`` counts the entries
    where their outputs differ: any raises. ``events`` maps each of the
    kernel's profiler event names to its launches per run; ``byts`` is the
    bytes a run must move. Then, after the check: CUDA events over
    back-to-back runs in turns plain, library, kernel, kernel, library,
    plain (``library``: (its name, a run of a PyTorch call on the card
    that does the same work), where there is one); between the kernel's
    turns the host clock over back-to-back runs (the wrapper's enqueue);
    the device time from ``timed_calls``, with L2 flushed by a 64 MB write
    before each run where ``flush``: the mean of each event's recorded
    launches, else, printed, CUDA events around each run; the bound: the
    bytes over 3.35 TB/s, or where given ``bound()``, read after the
    timing: (bound_ms, bound_by and their parts, a note to print).
    -> those numbers with ``extras``."""
    from torch.autograd import DeviceType
    want, got = plain(), kernel()
    if library:
        library[1]()
    torch.cuda.synchronize()
    bad = differ(got, want)
    if bad:
        raise AssertionError(f"{what}: {bad} entries differ from the "
                             f"{plain_name}")
    few = max(iters // 4, 3)
    p1 = _event_ms(plain, few)
    l1 = library and _event_ms(library[1], iters)
    k1 = _event_ms(kernel, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        kernel()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    k2 = _event_ms(kernel, iters)
    l2 = library and _event_ms(library[1], iters)
    p2 = _event_ms(plain, few)
    scrub = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    prof, event_ms = timed_calls(kernel, iters,
                                 SLEEP_CYCLES * max(calls // 8, 1),
                                 (lambda: scrub.fill_(1)) if flush else None)
    us = {name: [e.time_range.elapsed_us() for e in prof
                 if e.device_type == DeviceType.CUDA and name in e.name]
          for name in events}
    if any(len(us[name]) != iters * n for name, n in events.items()):
        print(f"  the profiler recorded { {k: len(u) for k, u in us.items()} }"
              f" of { {k: iters * n for k, n in events.items()} } launches "
              f"of {what}; CUDA events around each run: "
              f"{np.mean(event_ms) * 1e3:.2f} us")
    if all(us[name] or not n for name, n in events.items()):
        run_ms = sum(np.mean(us[name]) * n
                     for name, n in events.items() if n) / 1e3
    else:
        run_ms = float(np.mean(event_ms))
    b, note = bound() if bound else (
        dict(bound_ms=byts / HBM_BYTES_PER_S * 1e3 / calls,
             bound_by="bytes"), "")
    r = dict(ms=run_ms / calls, host_ms=host_ms / calls,
             call_ms=(k1 + k2) / 2 / calls, plain_ms=(p1 + p2) / 2 / calls,
             bytes=byts, max_abs_err=bad, **b, **extras)
    lib = ""
    if library:
        r["library_ms"] = (l1 + l2) / 2 / calls
        lib = f"; {library[0]} {r['library_ms'] * 1e3:.2f} us"
    print(f"  {what}, {byts / 1e6:.3f} MB: device {r['ms'] * 1e3:.2f} us "
          f"({byts / (run_ms * 1e-3) / 1e9:.0f} GB/s, "
          f"{r['bound_ms'] / r['ms']:.3f} of the bound "
          f"{r['bound_ms'] * 1e3:.2f} us{note}); wrapper host "
          f"{r['host_ms'] * 1e3:.2f} us, per call {r['call_ms'] * 1e3:.2f} "
          f"us; {plain_name} {r['plain_ms'] * 1e3:.2f} us{lib}"
          f"{'; L2 flushed before each launch' if flush else ''}; entries "
          f"differing from the {plain_name} {bad}")
    return r


def kernel_line(name: str, source: str, replaces: str, by_path: dict,
                max_err, t: dict) -> dict:
    """One kernel's entry of the run's closing "kernels" line: its
    launches by counted path, its largest difference from its plain
    version, and the times of a ``time_kernel`` result ``t``, or of such
    results by category (each time then by category)."""
    one = t if "ms" in t else next(iter(t.values()))

    def of(key: str):
        return t[key] if t is one else {c: r[key] for c, r in t.items()}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": max_err,
            "ms": of("ms"), "plain_ms": of("plain_ms"),
            "bound_ms": of("bound_ms"), "bound_by": one["bound_by"],
            "library_ms": one.get("library_ms")}


def decode_entry(name: str, items: list) -> dict:
    """K1's entry of ``time_kernel``: one grouped decode of ``items``."""
    blocks = sum(w.shape[0] for w, _, _ in items)
    return dict(what=f"K1 {name}: {len(items)} windows, {blocks} blocks",
                kernel=lambda: ps.decode_grouped(items)[0],
                plain=lambda: plain_grouped(items),
                differ=lambda got, want: int((got != want).sum()),
                events={KERNEL_EVENT: 1}, byts=decode_bytes(items),
                blocks=blocks)


def walk_bytes(lists: list, size: int) -> int:
    """Bytes one LCS walk must move: each list's valid entries read once
    (row and key, and the per-entry weight and mask where the list has
    them), each gate read once, and per position its row and bm25part read
    and its weight written."""
    total = 12 * size
    for h in lists:
        total += h.n * (8 + 4 * isinstance(h.weight, torch.Tensor)
                        + (h.ok is not None))
        total += size * (h.gate is not None)
    return total


def walk_entry(name: str, call: tuple) -> dict:
    """The LCS walk's entry of ``time_kernel``: ``capture``'s call of one
    program's lists against the same query's eager hit stream."""
    args, plain = call
    lists, size = args[0], args[1].shape[0]
    entries = sum(h.n for h in lists)
    return dict(what=f"LCS walk {name}: {len(lists)} lists, {entries} "
                f"entries, {size} positions",
                kernel=lambda: ops_search.lcs_walk(*args), plain=plain,
                differ=lambda got, want: int((got != want).sum()),
                events={WALK_EVENT: 1}, byts=walk_bytes(lists, size),
                plain_name="eager pass", positions=size, lists=len(lists),
                entries=entries)


def pos_differences(got: list, want: list) -> int:
    """Entries where the walk's (match, tf, ok, a_w) of each node differ
    from the eager node's six fields, a_w compared where ok holds."""
    bad = 0
    for (m, tf, ok, a_w), (em, etf, _, _, eok, eaw) in zip(got, want):
        bad += int((m != em).sum()) + int((tf != etf).sum())
        bad += int((ok != eok).sum())
        if a_w is not None:
            bad += int(((a_w != eaw) & eok).sum())
    return bad


def pos_bytes(args: tuple, n_ok: int) -> int:
    """Bytes one positional walk must move: each node's distinct member
    windows' valid entries read once (row and key), ok (1 B) and a_w (4 B,
    proximity) written per anchor, the positions' rows read once where the
    space is sparse, and 4 B of tf per ok anchor (``n_ok``, counted in a
    call's output)."""
    table, _, _, _, lengths, rows = args
    a = ops_search._PosArgs.from_buffer_copy(table.args)
    total = table.n_ok + 4 * table.n_aw + 4 * n_ok
    total += 4 * table.size * (rows is not None)
    for nd, node in zip(a.nodes, table.nodes):
        hb = {s: m.hb for m, s in zip(nd.m, node[1])}
        total += sum(8 * min(int(lengths[s]), h) for s, h in hb.items())
    return total


def pos_entry(name: str, call: tuple) -> dict:
    """The positional walk's entry of ``time_kernel``: ``capture``'s call
    of one program's nodes against the same query's eager nodes."""
    args, plain = call
    table = args[0]
    n_ok = sum(int(ok.sum()) for _, _, ok, _ in ops_search.pos_walk(*args))
    return dict(what=f"positional walk {name}: {len(table.nodes)} nodes, "
                f"{table.n_ok} anchors ({n_ok} ok), {table.size} positions",
                kernel=lambda: ops_search.pos_walk(*args), plain=plain,
                differ=pos_differences, events={POS_EVENT: 1},
                byts=pos_bytes(args, n_ok), plain_name="eager nodes",
                positions=table.size, nodes=len(table.nodes),
                anchors=table.n_ok, ok=n_ok)


def capture(idx: SearchIndex, q: SearchQuery, wrapper: str, takes: str,
            recorded: tuple, plain_of):
    """One query on the card twice: first with its call of the kernel's
    wrapper (``ops_search.<wrapper>``) recorded, then with the kernel
    refused (``ops_search.<takes>`` false) and the calls of the plain
    path's functions ``recorded`` recorded; both runs must give the same
    results. ``plain_of(call, log)`` (the wrapper call's arguments, each
    recorded function's calls by name) gives the call to time and the
    plain version as a function of no arguments, or None where the
    refused run did not do exactly the kernel's work. -> (the first run's
    result, None where the query made no kernel call, else that pair)."""
    saved = {name: getattr(ops_search, name)
             for name in (wrapper, takes, *recorded)}
    log: dict = {name: [] for name in (wrapper, *recorded)}

    def hook(name: str):
        def run(*args):
            log[name].append(args)
            return saved[name](*args)
        return run
    setattr(ops_search, wrapper, hook(wrapper))
    try:
        res = idx.search_batch([q])[0]
        calls = log[wrapper]
        if len(calls) > 1:
            raise AssertionError(f"{q.match!r}: {len(calls)} {wrapper} calls")
        if not calls:
            return res, None
        setattr(ops_search, takes, lambda *args: False)
        for name in recorded:
            setattr(ops_search, name, hook(name))
        again = idx.search_batch([q])[0]
    finally:
        for name, fn in saved.items():
            setattr(ops_search, name, fn)
    if ((res.total_found, [(m.docid, m.weight) for m in res.matches])
            != (again.total_found,
                [(m.docid, m.weight) for m in again.matches])):
        raise AssertionError(f"{q.match!r}: {wrapper} and its plain path "
                             "give different results")
    call = plain_of(calls[0], log)
    if call is None:
        raise AssertionError(
            f"{q.match!r}: with {wrapper} refused the plain path made "
            f"{ {name: len(log[name]) for name in recorded} } calls")
    return res, call


def lcs_plain(call: tuple, log: dict):
    """The LCS walk's plain path: the refused run's one eager hit stream
    and its ranking; the call takes that run's bm25part."""
    if len(log["_hit_stream"]) != 1 or len(log["_rank_hit_stream"]) != 1:
        return None
    (stream_args,), (rank_args,) = (log["_hit_stream"],
                                    log["_rank_hit_stream"])
    lists, rows, _, fw, with_bm25 = call

    def plain():
        return ops_search._rank_hit_stream(
            rank_args[0], ops_search._hit_stream(*stream_args),
            *rank_args[2:])[0]
    return (lists, rows, rank_args[2], fw, with_bm25), plain


def pos_plain(call: tuple, log: dict):
    """The positional walk's plain path: the refused run's eager nodes,
    exactly the call's."""
    nodes = call[0].nodes
    eager = [a for a in log["_eval_phrase_node"] if a[0] in nodes]
    if [a[0] for a in eager] != list(nodes):
        return None
    return call, lambda: [ops_search._eval_phrase_node(*a) for a in eager]


# ``capture``'s arguments for each walk
LCS_HOOKS = ("lcs_walk", "takes_lcs_walk", ("_hit_stream",
                                            "_rank_hit_stream"), lcs_plain)
POS_HOOKS = ("pos_walk", "takes_pos_walk", ("_eval_phrase_node",), pos_plain)


def lcs_phase(tag: str, gpu: SearchIndex, cpu: SearchIndex, packed,
              t_start: float) -> dict:
    """Phase 25: the LCS walk kernel on the main path. One query of each of
    the 12 non-term categories of Lucene's nightly tasks
    (``bench_corpus.lucene_categories``) on the card, each with exactly one
    kernel call, results equal to the CPU's; the kernel checked and timed
    against the eager hit stream at the AndHighHigh, HighPhrase and
    HighSloppyPhrase programs. -> the timings by category."""
    queries = bench_corpus.lucene_categories(packed)
    got, calls = {}, {}
    for cat, q in queries.items():
        got[cat], calls[cat] = capture(gpu, q, *LCS_HOOKS)
        if calls[cat] is None:
            raise AssertionError(f"{tag} {cat} {q.match!r}: no LCS walk "
                                 "kernel call")
    check_equal(f"{tag} lucene categories", list(queries.values()),
                list(got.values()), cpu.search_batch(list(queries.values())))
    out = {cat: time_kernel(iters=20, **walk_entry(
               f"{tag} {cat} {queries[cat].match!r}", calls[cat]))
           for cat in ("AndHighHigh", "HighPhrase", "HighSloppyPhrase")}
    # the positional walk: one launch for each Phrase and SloppyPhrase
    # category, none for the others
    pos = {}
    for cat, q in queries.items():
        ops_search.POS_WALK_LAUNCHES.reset()
        _, pos[cat] = capture(gpu, q, *POS_HOOKS)
        launches = ops_search.POS_WALK_LAUNCHES.kernel
        if launches != cat.endswith("Phrase"):
            raise AssertionError(f"{tag} {cat} {q.match!r}: {launches} "
                                 "positional walk launches")
        if launches:
            POS_BY_PATH[f"{tag} lucene {cat}"] = launches
    pos_out = {cat: time_kernel(iters=20, **pos_entry(
                   f"{tag} {cat} {queries[cat].match!r}", pos[cat]))
               for cat in ("HighPhrase", "HighSloppyPhrase")}
    print(f"{since(t_start)} {tag} LCS and positional walks done")
    return out, pos_out


def profile_batch(idx: SearchIndex, queries: list[SearchQuery]) -> dict:
    """One warm batch under torch.profiler: its wall time, the device time
    of every kernel and copy in it (one stream, so they do not overlap),
    the device busy share, the kernel launches, the host's waits on the
    device and its copies (CUDA runtime calls by name), K1's device time
    and events, and the device ops that took the most time."""
    from torch.autograd import DeviceType
    wall_ms, events = multichip.profiled(idx, queries, ["cuda"])
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
    ops_search.WALK_LAUNCHES.reset()
    ops_search.POS_WALK_LAUNCHES.reset()
    t0 = time.perf_counter()
    results = idx.search_batch(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = ps.LAUNCHES.kernel, ps.LAUNCHES.plain
    seg, seg_plain = gb.LAUNCHES.kernel, gb.LAUNCHES.plain
    launches_by_path[name] = launches
    if seg or want_seg:
        SEG_BY_PATH[name] = seg
    if ops_search.WALK_LAUNCHES.kernel:
        WALK_BY_PATH[name] = ops_search.WALK_LAUNCHES.kernel
    if ops_search.POS_WALK_LAUNCHES.kernel:
        POS_BY_PATH[name] = ops_search.POS_WALK_LAUNCHES.kernel
    print(f"{name}: bitplane_decode launches {launches} (expected {want}), "
          f"{ps.LAUNCHES.work} blocks, plain decodes {plain}; "
          f"segment_sum_ordered launches {seg} (expected "
          f"{'any' if want_seg is None else want_seg}), "
          f"{gb.LAUNCHES.work} positions; first run "
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
        if summary(g) != summary(w):
            raise AssertionError(f"{name} {q.match!r} {q.filters} "
                                 f"{q.group_by} {q.select}: cuda result "
                                 f"{summary(g)} != cpu {summary(w)}")
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
    """Warm walls of one batch, then one warm run under the profiler of
    ``profiled``, a slice of the batch (by default its first
    ``PROFILE_QUERIES``): the profiler's events of a whole batch take too
    long to read back."""
    warm = multichip.walls(idx, queries, ["cuda"], runs)
    profiled = profiled or queries[:PROFILE_QUERIES]
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
                       qs[:PROFILE_QUERIES_HEAVY] if name == "packedfactors"
                       else None)
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


def segment_entry(name: str, calls: list) -> dict:
    """The segment sum's entry of ``time_kernel``: a list of calls (a
    batch's captured calls, or one case) against the plain version on a
    CPU copy, with ``index_add_`` on the card as the library yardstick.
    Per run: seg_prep once per call with a group, seg_walk once per call
    with a group and a position. Its bound per call is the larger of
    bytes (8 per position, 4 per group over 3.35 TB/s) and chain (the
    longest run's non-+0.0 members times FADD_CYCLES at the SM clock
    nvidia-smi reports right after the timing)."""
    lib_in = [(v, g.long(), n) for v, g, n in calls]
    cpu_in = [(v.cpu(), g.cpu(), n) for v, g, n in calls]
    positions = [v.numel() for v, _, _ in calls]

    def bound():
        clock, clock_max = sm_clocks()
        bytes_ms = [(8 * v.numel() + 4 * n) / HBM_BYTES_PER_S * 1e3
                    for v, _, n in calls]
        chains = [longest_chain(v, g) for v, g, _ in cpu_in]
        chain_ms = [c * FADD_CYCLES / (clock * 1e6) * 1e3 for c in chains]
        by = ("operations" if sum(c > b for b, c in zip(bytes_ms, chain_ms))
              * 2 > len(calls) else "bytes")
        b = dict(bound_ms=sum(map(max, bytes_ms, chain_ms)) / len(calls),
                 bound_by=by, bytes_ms=sum(bytes_ms) / len(calls),
                 chain_ms=sum(chain_ms) / len(calls), chain=max(chains),
                 clock=clock)
        return b, (f", by {by}: bytes {b['bytes_ms'] * 1e3:.2f} us, chain "
                   f"{b['chain_ms'] * 1e3:.2f} us, longest chain "
                   f"{b['chain']} adds at {clock:.0f} MHz of max "
                   f"{clock_max:.0f}")

    def differ(got: list, want: list) -> int:
        return sum(int((a.cpu().view(torch.int32)
                        != b.view(torch.int32)).sum())
                   for a, b in zip(got, want))
    return dict(
        what=f"segment_sum_ordered {name}: {len(calls)} calls of "
        f"{min(positions)}-{max(positions)} positions",
        kernel=lambda: [gb.segment_sum_ordered(*c) for c in calls],
        plain=lambda: [gb.segment_sum_plain(*c) for c in cpu_in],
        differ=differ,
        events={"seg_prep": sum(n > 0 for _, _, n in calls),
                "seg_walk": sum(n > 0 and v.numel() > 0
                                for v, _, n in calls)},
        byts=sum(8 * v.numel() + 4 * n for v, _, n in calls),
        plain_name="plain version on the host CPU", flush=False,
        calls=len(calls),
        library=("index_add_ on the card", lambda: [
            torch.zeros(n, dtype=torch.float32, device="cuda").index_add_(
                0, g, v) for v, g, n in lib_in]),
        bound=bound)


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
    """Bit-plane launches one ``ShardedIndex.search_batch`` makes: one per
    part for the merged queries where they read packed windows, and one per
    shard
    search of the fallback queries that reads them (each shard's own
    ``SearchIndex`` decodes its windows in one call)."""
    routes = [sidx._prep(q)[0] for q in queries]
    merged = [q for q, r in zip(queries, routes) if r == "ok"]
    want = len(sidx.parts) * int(any(window_kinds(sidx.plan(q).sig)
                                     for q in merged))
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
                                 f"{summary(g)} != one index {summary(w)}")
    print(f"{name}: {len(queries)} queries equal to one index over the same "
          "documents on cuda (docids, weights, total_found; group keys and "
          "counts)")


def sharded_phase(gpu: SearchIndex, batches: dict, gpu_results: dict,
                  launches_by_path: dict, t_start: float,
                  shards_job) -> None:
    """Phase 18: bench config 5 (8 shards of the 200k corpus on one card)
    and a batch of every route on a small sharded index."""
    from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
    t_phase = time.perf_counter()
    shards = host_built_shards(shards_job)
    print(f"config 5: {len(shards)} shards of "
          f"{sorted({s.n_docs for s in shards})} docs, "
          f"{sum(s.n_postings for s in shards)} postings")
    t0 = time.perf_counter()
    sgpu = ShardedIndex(shards, "cuda")
    torch.cuda.synchronize()
    print(f"config 5 upload to cuda: {time.perf_counter() - t0:.1f} s; "
          f"device memory of the shards "
          f"{sum(map(tree_bytes, sgpu.parts)) / 2**20:.1f} MiB")
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
        time_batch(path, sgpu, qs, 2, qs[:PROFILE_QUERIES_HEAVY])
    del scpu
    mesh_phase(shards, sgpu, batches, gpu_results, launches_by_path, t_start)
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
    want_cpu = rcpu.search_batch(qs)
    check_equal("config 5 routes", qs, res, want_cpu)
    check_single("config 5 routes", qs, res, one.search_batch(qs))
    time_batch("config 5 routes", rgpu, qs, 2)
    # 18b: the same batch on 4 parts of 2 shards on the card
    rparts = ShardedIndex(rshards, devices=["cuda:0"] * 4)
    name = "config 5 routes (4 parts on cuda:0)"
    res, _ = run_counted(name, rparts, qs, launches_by_path, want_seg=None,
                         want=sharded_launches(rparts, qs))
    check_equal(name, qs, res, want_cpu)
    print(f"{since(t_start)} phase 18 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


MESH_PARTS = (4, 8)       # phase 18b: parts of phase 18's shards on one card


def mesh_phase(shards: list, sgpu, batches: dict, gpu_results: dict,
               launches_by_path: dict, t_start: float) -> None:
    """Phase 18b: phase 18's shards in 4 and in 8 parts (the JAX layout,
    one shard per mesh position) on this card, and, where more than one
    card is visible, one part per card, each through
    ``tools.multichip.check_mesh`` against phase 18's one-part index and
    phase 5's single index."""
    from manticoresearch_tpu_torch.parallel.sharded import make_mesh
    t_phase = time.perf_counter()
    meshes = [["cuda:0"] * n for n in MESH_PARTS]
    visible = torch.cuda.device_count()
    if visible > 1:
        n = min(SHARDS, visible)
        while SHARDS % n:
            n -= 1
        meshes.append(make_mesh(n))
    else:
        print("config 5 mesh: one card visible, so no mesh of several "
              "cards")
    for devices in meshes:
        cards = multichip.cards(devices)
        tag = (f"config 5 in {len(devices)} parts on {cards[0]}"
               if len(cards) == 1 else f"config 5 on {len(cards)} cards")
        multichip.check_mesh(shards, devices, batches, sgpu, gpu_results,
                             runs=2, launches_by_path=launches_by_path,
                             tag=tag)
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
    print(f"{since(t_start)} phase 18b done in "
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
    """Results against one index over the same documents: total_found,
    and the matches with equal-weight runs normalized (``tie_runs``)."""
    def runs(matches, limit):
        return tie_runs([(m.docid, m.weight) for m in matches], limit)
    for q, g, w in zip(queries, got, want):
        if (g.error is not None or runs(g.matches, q.limit)
                != runs(w.matches, q.limit)
                or g.total_found != w.total_found):
            raise AssertionError(f"{name} {q.match!r}: {summary(g)} != "
                                 f"the single index's {summary(w)}")
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
             launches_by_path: dict, t_start: float, shards_job) -> None:
    """Phase 19: an RT table of the 200k corpus in 8 disk chunks on the
    card, in three states (no writes; after a write stream; after FLUSH
    RAMCHUNK and OPTIMIZE), each against its CPU twin; then a binlog
    reload."""
    from manticoresearch_tpu_torch.exec import multi
    from manticoresearch_tpu_torch.index.rt import RtIndex, rt_from_packed
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    shards = host_built_shards(shards_job)
    twin_shards = host_built_shards(shards_job)
    print(f"rt: {len(shards)} chunks of {sorted({s.n_docs for s in shards})} "
          f"docs, and a copy for the CPU twin")
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
    time_kernel(iters=50, **decode_entry(
        "rt chunk 0 (25,000 docs), the config-2 query with the most blocks",
        one))
    time_kernel(iters=50, **decode_entry(
        f"rt chunk 0 (25,000 docs), {RT_QUERIES} config-2 queries' windows "
        "in one list", [w for it in items for w in it]))
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


SQL_QUERIES = 8          # of each of phase 3's batches
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
    words = [f"t{t:0{width}d}" for t in range(VOCAB)]
    return [" ".join(map(words.__getitem__,
                         terms[offsets[r]:offsets[r + 1]].tolist()))
            for r in rows]


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
        short = sql if len(sql) < 120 else sql[:117] + "..."
        got = self.counted(f"session {short!r}", lambda: self.gpu.execute(sql),
                           pq=sql.lstrip().upper().startswith("CALL PQ"))
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

    def counted(self, label: str, fn, pq: bool = False):
        """Run ``fn`` (the card's side of one statement or request) with the
        launch counters set to 0 just before and read just after; the
        launches must equal the count from the plans of the table searches
        it made, on any thread, and no plain version may run. -> what
        ``fn`` returns."""
        self.pq = pq
        torch.cuda.synchronize()
        ps.LAUNCHES.reset()
        gb.LAUNCHES.reset()
        self.recorded = []
        self.on = True
        t0 = time.perf_counter()
        try:
            got = fn()
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
        if (k1, seg) != (want_k1, want_seg) or plain or seg_plain:
            raise AssertionError(
                f"{label}: {k1} bit-plane and {seg} segment-sum "
                f"launches, {plain} plain decodes and {seg_plain} plain "
                f"sums; expected {want_k1}, {want_seg}, 0 and 0")
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
                  launches_by_path: dict, t_start: float,
                  shards_job) -> None:
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
        time_batch(f"session select (200k docs, {len(sqls)} SELECTs)",
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
        for i, sh in enumerate(shards_job.get()[0]):
            save_packed(sh, os.path.join(tmp, f"s{i}"))
        print(f"session: {SHARDS} shards saved in "
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


FRONT_QUERIES = 8        # of each of phase 3's batches
FRONT_GROUPED = 4        # WorkloadGen.config4 draws, with AVG(year)
FRONT_TXNS = 4           # MySQL write transactions of RT_OPS operations
FRONT_ROWS = 24          # rows per REPLACE / INSERT statement
FRONT_JSON_DOCS = 4      # documents of each /json/insert, replace, ...
FRONT_BULK = 64          # documents of the /json/bulk
FRONT_PQ_QUERIES = 100   # stored percolate queries
FRONT_PQ_DOCS = 16       # documents of the percolate search
FRONT_WARM_RUNS = 2
FRONT_API_CLIENTS = 4    # SphinxAPI connections searching at once
# extra arguments of the daemon process and of ``tools.replay``: none on
# the card (their default device is "cuda"); a rehearsal on the CPU passes
# ["--device", "cpu"]
FRONT_DEVICE_ARGS: list = []
FRONT_DAEMON_START_S = 180.0   # seconds a daemon may take to listen
FRONT_DAEMON_STOP_S = 30.0     # seconds it may take to exit on SIGTERM
API_VER_SEARCH, API_VER_KEYWORDS, API_VER_STATUS = 0x121, 0x101, 0x101
API_BIGINT, API_STRING, API_MVA = 6, 7, 0x40000001
FRONT_MASK = "<time>"


class WireMysql:
    """Just enough of a MySQL text-protocol client: the protocol-41 login
    (no TLS, no compression), COM_QUERY with one result, COM_PING."""

    def __init__(self, port: int):
        import socket
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        self.seq = 0
        if self._read()[0] != 0x0A:
            raise AssertionError("mysql: not a protocol-10 greeting")
        self._send(struct.pack("<II", 0x0200, 1 << 24) + b"\x21"
                   + b"\x00" * 23 + b"root\x00\x00")
        if self._read()[0] != 0x00:
            raise AssertionError("mysql: login refused")

    def _recv(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("mysql: connection closed")
            out += chunk
        return out

    def _read(self) -> bytes:
        head = self._recv(4)
        self.seq = head[3]
        return self._recv(head[0] | head[1] << 8 | head[2] << 16)

    def _send(self, payload: bytes) -> None:
        self.seq = (self.seq + 1) % 256
        self.sock.sendall(struct.pack("<I", len(payload))[:3]
                          + bytes([self.seq]) + payload)

    @staticmethod
    def _lenenc(data: bytes, pos: int) -> tuple:
        b = data[pos]
        if b < 251:
            return b, pos + 1
        if b == 0xFC:
            return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
        if b == 0xFD:
            return data[pos + 1] | data[pos + 2] << 8 | data[pos + 3] << 16, \
                pos + 4
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9

    def command(self, cmd: int, arg: bytes = b"") -> bytes:
        self.seq = 255
        self._send(bytes([cmd]) + arg)
        return self._read()

    def query(self, sql: str) -> dict:
        """-> {"error": msg}, {"affected": n} or {"columns", "rows"}."""
        first = self.command(0x03, sql.encode())
        if first[0] == 0xFF:
            return {"error": first[9:].decode()}
        if first[0] == 0x00:
            return {"affected": self._lenenc(first, 1)[0]}
        ncols = self._lenenc(first, 0)[0]
        cols = []
        for _ in range(ncols):
            pkt, pos, vals = self._read(), 0, []
            for _f in range(6):
                n, pos = self._lenenc(pkt, pos)
                vals.append(pkt[pos:pos + n])
                pos += n
            cols.append(vals[4].decode())
        if self._read()[0] != 0xFE:
            raise AssertionError("mysql: no EOF after the columns")
        rows = []
        while True:
            pkt = self._read()
            if pkt[0] == 0xFE and len(pkt) < 9:
                if pkt[3] & 0x08:
                    raise AssertionError("mysql: an unexpected second "
                                         "result set")
                return {"columns": cols, "rows": rows}
            pos, row = 0, []
            for _c in range(ncols):
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                else:
                    n, pos = self._lenenc(pkt, pos)
                    row.append(pkt[pos:pos + n].decode())
                    pos += n
            rows.append(row)

    def close(self) -> None:
        try:
            self.seq = 255
            self._send(b"\x01")
        finally:
            self.sock.close()


def mysql_masked(out: dict) -> dict:
    """A ``WireMysql.query`` answer with SHOW META's ``time`` and SHOW
    STATUS's ``uptime`` masked."""
    if "rows" not in out:
        return out
    key = SQL_MASK_ROWS.get(tuple(out["columns"]))
    return dict(out, rows=[[r[0], FRONT_MASK] + r[2:]
                           if key and r and r[0] == key else r
                           for r in out["rows"]])


class WireApi:
    """A SphinxAPI client: the version exchange, then requests of (WORD
    command, WORD version, DWORD length, body) on one connection."""

    def __init__(self, port: int):
        import socket
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=600)
        self._recv(4)
        self.sock.sendall(struct.pack(">L", 1))

    def _recv(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("api: connection closed")
            out += chunk
        return out

    def request(self, cmd: int, ver: int, body: bytes) -> tuple:
        self.sock.sendall(struct.pack(">HHL", cmd, ver, len(body)) + body)
        status, _ver, n = struct.unpack(">HHL", self._recv(8))
        return status, self._recv(n)

    def close(self) -> None:
        self.sock.close()


def _api_str(text: str) -> bytes:
    b = text.encode()
    return struct.pack(">L", len(b)) + b


def api_search_body(queries: list, index: str) -> bytes:
    """One SphinxAPI multi-query (v.0x121, as ``sphinxapi`` clients send
    it): relevance order, the default ranker, each query's limit and year
    range filters."""
    out = struct.pack(">lL", 0, len(queries))
    for q in queries:
        filt = b"".join(_api_str(f.attr) + struct.pack(">LQQL", 1, f.lo,
                                                       f.hi, 0)
                        for f in q.filters or [])
        out += (struct.pack(">Lllll", 0, 0, q.limit, 6, 0)
                + struct.pack(">l", 0) + _api_str("") + _api_str(q.match)
                + struct.pack(">l", 0) + _api_str(index)
                + struct.pack(">lQQ", 1, 0, 0)
                + struct.pack(">l", len(q.filters or [])) + filt
                + struct.pack(">L", 0) + _api_str("")
                + struct.pack(">l", 1000) + _api_str("@count desc")
                + struct.pack(">lll", 0, 0, 0) + _api_str("")
                + struct.pack(">llL", 0, 0, 0) + struct.pack(">l", 0)
                + _api_str("") + struct.pack(">l", 0) + _api_str("*")
                + _api_str("") + struct.pack(">LLl", 0, 0, 0)
                + struct.pack(">l", 0))
    return out


def api_search_results(b: bytes) -> tuple:
    """A SEARCH reply -> ([((docid, weight) rows, total_found) per query],
    the reply with each ``time_ms`` masked)."""
    i, results = 0, []
    masked = bytearray(b)

    def u32() -> int:
        nonlocal i
        (v,) = struct.unpack_from(">L", b, i)
        i += 4
        return v

    def skip_str() -> None:
        nonlocal i
        n = u32()
        i += n
    while i < len(b):
        if u32() != 0:
            n = u32()
            raise AssertionError(f"api search: {b[i:i + n].decode()}")
        for _ in range(u32()):
            skip_str()
        types = []
        for _ in range(u32()):
            skip_str()
            types.append(u32())
        count, rows = u32(), []
        u32()                                   # id64
        for _ in range(count):
            docid, weight = struct.unpack_from(">Ql", b, i)
            i += 12
            rows.append((docid, weight))
            for t in types:
                if t == API_BIGINT:
                    i += 8
                elif t == API_STRING:
                    skip_str()
                elif t == API_MVA:
                    n = u32()
                    i += 4 * n
                else:
                    i += 4
        u32()
        total_found = u32()
        masked[i:i + 4] = b"\0\0\0\0"           # time_ms
        i += 4
        for _ in range(u32()):
            skip_str()
            i += 8
        results.append((rows, total_found))
    return results, bytes(masked)


def api_status_masked(b: bytes) -> list:
    n, cols = struct.unpack_from(">ll", b, 0)
    i, vals = 8, []
    for _ in range(n * cols):
        (k,) = struct.unpack_from(">L", b, i)
        vals.append(b[i + 4:i + 4 + k].decode())
        i += 4 + k
    return [[v if not (c == 1 and vals[r * cols] == "uptime")
             else FRONT_MASK for c, v in enumerate(vals[r * cols:
                                                          (r + 1) * cols])]
            for r in range(n)]


def http_post(port: int, path: str, body: bytes) -> tuple:
    """-> (HTTP status, the decoded JSON body)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_sql(port: int, sql: str) -> tuple:
    import urllib.parse
    return http_post(port, "/sql",
                     ("query=" + urllib.parse.quote(sql)).encode())


def json_masked(obj):
    """A JSON answer with ``took`` (a search's time) masked."""
    if isinstance(obj, list):
        return [json_masked(v) for v in obj]
    if isinstance(obj, dict):
        return {k: FRONT_MASK if k == "took" else json_masked(v)
                for k, v in obj.items()}
    return obj


def json_query(q: SearchQuery) -> dict:
    """A phase 3 query as a ``/json/search`` request (``query_string``)."""
    query: dict = {"query_string": q.match}
    if q.filters:
        query = {"bool": {"must": [query], "filter": [
            {"range": {f.attr: {"gte": f.lo, "lte": f.hi}}}
            for f in q.filters]}}
    return {"index": "docs", "query": query, "limit": q.limit}


def hits_rows(out: dict) -> tuple:
    """((docid, weight) rows, total) of a JSON search-shaped answer."""
    return ([(int(h["_id"]), int(h["_score"])) for h in out["hits"]["hits"]],
            int(out["hits"]["total"]))


class FrontTwins:
    """Each request to a listener of the port on a ``Catalog(device=
    "cuda")`` and to its twin on a ``Catalog(device="cpu")``: the card's
    side runs under ``SqlTwins.counted`` (its launches equal to the count
    from the plans of every table search it made, on any thread, and no
    plain version), then the twin's; the two answers, time fields masked,
    must be equal. Walls, search time and launches are kept per
    protocol."""

    def __init__(self, counter: SqlTwins):
        self.counter = counter
        self.walls: Counter = Counter()
        self.search: Counter = Counter()
        self.n: Counter = Counter()
        self.k1: Counter = Counter()
        self.seg: Counter = Counter()

    def request(self, proto: str, label: str, gpu, cpu, norm=None,
                pq: bool = False):
        c = self.counter
        s0, k0, g0 = c.search_s, c.got_k1, c.got_seg
        got = c.counted(f"front {proto} {label[:100]!r}", gpu, pq=pq)
        want = cpu()
        norm = norm or (lambda x: x)
        if norm(got) != norm(want):
            raise AssertionError(f"front {proto} {label[:200]!r}: cuda "
                                 f"{str(norm(got))[:2000]} != cpu "
                                 f"{str(norm(want))[:2000]}")
        self.walls[proto] += c.last_wall
        self.search[proto] += c.search_s - s0
        self.k1[proto] += c.got_k1 - k0
        self.seg[proto] += c.got_seg - g0
        self.n[proto] += 1
        return got

    def report(self, launches_by_path: dict, t_start: float) -> None:
        for proto in sorted(self.n):
            launches_by_path[f"front {proto}"] = self.k1[proto]
            if self.seg[proto]:
                SEG_BY_PATH[f"front {proto}"] = self.seg[proto]
            wall = max(self.walls[proto], 1e-9)
            print(f"front {proto}: {self.n[proto]} requests on cuda and "
                  f"cpu, equal; bitplane_decode launches {self.k1[proto]}, "
                  f"segment_sum_ordered launches {self.seg[proto]} (each "
                  f"as the plans count), no plain version; cuda wall "
                  f"{self.walls[proto]:.3f} s, "
                  f"{self.walls[proto] / self.n[proto] * 1e3:.1f} ms per "
                  f"request, of it the tables' search "
                  f"{self.search[proto] / wall:.3f} (summed over threads: "
                  f"above 1 where requests search at once)")
        c = self.counter
        print(f"front: {c.statements} requests, bitplane_decode launches "
              f"{c.got_k1} (expected {c.want_k1} from the plans of "
              f"{c.searches} table searches), segment_sum_ordered launches "
              f"{c.got_seg} (expected {c.want_seg})")
        print(f"{since(t_start)} front listeners done")


class HttpSqlBatch:
    """``search_batch`` over ``/sql`` requests to one port (for
    ``time_batch`` and ``profile_batch``)."""

    def __init__(self, port: int):
        self.port = port

    def search_batch(self, sqls: list[str]) -> list:
        return [http_sql(self.port, sql) for sql in sqls]


def free_ports(n: int) -> list[int]:
    import socket
    socks = [socket.socket() for _ in range(n)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    ports = [sk.getsockname()[1] for sk in socks]
    for sk in socks:
        sk.close()
    return ports


class DaemonProcess:
    """``python -m manticoresearch_tpu_torch.server.daemon`` as users start
    it, on three ports, its output in ``<data_dir>.log``."""

    def __init__(self, data_dir: str, ports: list[int]):
        import socket
        self.data_dir, self.ports = data_dir, ports
        self.log_path = data_dir.rstrip("/") + ".log"
        self.log = open(self.log_path, "a")
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "manticoresearch_tpu_torch.server.daemon",
             "--data-dir", data_dir, "--listen-mysql", str(ports[0]),
             "--listen-http", str(ports[1]), "--listen-api", str(ports[2])]
            + FRONT_DEVICE_ARGS, cwd=root, env=env, stdout=self.log,
            stderr=subprocess.STDOUT)
        while True:
            if self.proc.poll() is not None:
                self.fail(f"exited with {self.proc.returncode} at start")
            if time.perf_counter() - t0 > FRONT_DAEMON_START_S:
                self.fail("did not listen")
            try:
                for port in ports:
                    socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                time.sleep(0.1)
        self.start_s = time.perf_counter() - t0

    def fail(self, what: str) -> None:
        self.kill()
        print(f"daemon {what}; the tail of its log:")
        with open(self.log_path) as f:
            print("".join(f.readlines()[-40:]))
        crash = os.path.join(self.data_dir, "crash.log")
        if os.path.exists(crash):
            with open(crash) as f:
                print("crash.log:", f.read()[-4000:])
        raise AssertionError(f"daemon {what}")

    def stop(self) -> float:
        """SIGTERM; -> seconds until it exited (with code 0)."""
        import signal
        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(FRONT_DAEMON_STOP_S)
        except subprocess.TimeoutExpired:
            self.fail(f"did not exit within {FRONT_DAEMON_STOP_S} s of "
                      "SIGTERM")
        if rc != 0:
            self.fail(f"exited with {rc} on SIGTERM")
        self.log.close()
        return time.perf_counter() - t0

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self.log.close()


def front_phase(packed, batches: dict, gpu_results: dict,
                launches_by_path: dict, t_start: float) -> None:
    """Phase 22: the front ends on the card. 1: the port's MySQL, HTTP and
    SphinxAPI listeners on a ``Catalog(device="cuda")`` and their twins on
    a ``Catalog(device="cpu")`` in this process, each request to both
    (``FrontTwins``): phase 3's queries through every protocol (equal to
    phase 5's results), GROUP BY with AVG, writes, a highlight, percolate
    queries, KEYWORDS, STATUS and a ping. 2: the daemon as a process on
    the card: IMPORT TABLE, the SELECTs (equal to part 1's), the table's
    memory on the card, a replayed query log, SIGTERM, a restart that
    reloads the table, and a replay against its data directory."""
    import asyncio
    import io
    import itertools
    import shutil
    import tempfile
    import threading
    from manticoresearch_tpu_torch.exec.session import Catalog, Session
    from manticoresearch_tpu_torch.index.storage import save_packed
    from manticoresearch_tpu_torch.server.api import ApiServer
    from manticoresearch_tpu_torch.server.http import HttpServer
    from manticoresearch_tpu_torch.server.mysql import MysqlServer
    from manticoresearch_tpu_torch.tools import replay
    from manticoresearch_tpu_torch.utils import uid
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_front_")
    counter = loop = None
    servers: dict = {}
    clients: list = []
    daemon = None
    try:
        t0 = time.perf_counter()
        save_packed(packed, os.path.join(tmp, "docs"))
        print(f"front: the 200k index saved in "
              f"{time.perf_counter() - t0:.1f} s")

        # 1. the listeners in this process, on the card and on the CPU
        cats = {"cuda": Catalog(device="cuda"), "cpu": Catalog(device="cpu")}
        loop = asyncio.new_event_loop()
        started = threading.Event()
        for dev, cat in cats.items():
            servers[dev] = {"mysql": MysqlServer(cat, port=0),
                            "http": HttpServer(cat, port=0),
                            "api": ApiServer(cat, port=0)}

        def serve():
            asyncio.set_event_loop(loop)
            for by_proto in servers.values():
                for srv in by_proto.values():
                    loop.run_until_complete(srv.start())
                    srv.port = srv._server.sockets[0].getsockname()[1]
            started.set()
            loop.run_forever()
        loop_thread = threading.Thread(target=serve, daemon=True)
        loop_thread.start()
        if not started.wait(60):
            raise AssertionError("front: the listeners did not start")
        port = {dev: {p: srv.port for p, srv in by_proto.items()}
                for dev, by_proto in servers.items()}
        my = {dev: WireMysql(port[dev]["mysql"]) for dev in cats}
        api = {dev: WireApi(port[dev]["api"]) for dev in cats}
        clients += list(my.values()) + list(api.values())
        counter = SqlTwins(None, None)
        front = FrontTwins(counter)

        def mysql(sql: str, want_error: bool = False) -> dict:
            got = front.request("mysql", sql, lambda: my["cuda"].query(sql),
                                lambda: my["cpu"].query(sql), mysql_masked)
            if ("error" in got) != want_error:
                raise AssertionError(f"front mysql {sql[:100]!r}: {got}")
            return got

        def http(path: str, body: bytes, label: str, pq: bool = False,
                 cpu_first=None) -> dict:
            def cpu():
                if cpu_first:
                    cpu_first()
                return http_post(port["cpu"]["http"], path, body)
            status, got = front.request(
                "http", f"{path} {label}",
                lambda: http_post(port["cuda"]["http"], path, body), cpu,
                lambda r: (r[0], json_masked(r[1])), pq=pq)
            if status != 200:
                raise AssertionError(f"front http {path} {label[:100]!r}: "
                                     f"{status} {got}")
            return got

        def sql_http(sql: str) -> dict:
            import urllib.parse
            return http("/sql", ("query=" + urllib.parse.quote(sql)
                                 ).encode(), sql)

        def api_search(queries: list) -> list:
            body = api_search_body(queries, "docs")

            def norm(r):
                return r[0], api_search_results(r[1])[1]
            status, payload = front.request(
                "api", f"SEARCH of {len(queries)}",
                lambda: api["cuda"].request(0, API_VER_SEARCH, body),
                lambda: api["cpu"].request(0, API_VER_SEARCH, body), norm)
            if status != 0:
                raise AssertionError(f"front api SEARCH: status {status}")
            return api_search_results(payload)[0]

        def api_burst(queries: list, want: list) -> None:
            """The multi-query from FRONT_API_CLIENTS connections at once:
            the listener searches from as many worker threads; each
            answer equal to the one-client answer ``want``."""
            from concurrent.futures import ThreadPoolExecutor
            body = api_search_body(queries, "docs")

            def run(dev: str) -> list:
                conns = [WireApi(port[dev]["api"])
                         for _ in range(FRONT_API_CLIENTS)]
                try:
                    with ThreadPoolExecutor(FRONT_API_CLIENTS) as ex:
                        return list(ex.map(lambda c: c.request(
                            0, API_VER_SEARCH, body), conns))
                finally:
                    for c in conns:
                        c.close()
            got = front.request(
                "api", f"{FRONT_API_CLIENTS} concurrent SEARCHes",
                lambda: run("cuda"), lambda: run("cpu"),
                lambda rs: [(st, api_search_results(p)[1]) for st, p in rs])
            for status, payload in got:
                if status != 0 or api_search_results(payload)[0] != want:
                    raise AssertionError("front api: a concurrent SEARCH "
                                         "differs from the one-client one")

        mysql("SET GLOBAL qcache_max_bytes=0")
        mysql(f"IMPORT TABLE docs FROM '{os.path.join(tmp, 'docs')}'")
        docs = cats["cuda"].tables["docs"]
        table_bytes = sum(index_bytes(s.search) for s in docs.segments)
        print(f"front: IMPORT TABLE docs over MySQL: {docs.n_docs} docs, "
              f"{len(docs.segments)} segment, device memory "
              f"{table_bytes / 2**20:.1f} MiB")

        qs = batches["config1"][:FRONT_QUERIES] + \
            batches["config2"][:FRONT_QUERIES]
        sqls = [sql_match(q).format(t="docs") for q in qs]
        limits = [q.limit for q in qs]
        want = [([(m.docid, m.weight) for m in r.matches], r.total_found)
                for r in gpu_results["config1"][:FRONT_QUERIES]
                + gpu_results["config2"][:FRONT_QUERIES]]
        c4 = bench_corpus.WorkloadGen(np.random.RandomState(33), VOCAB,
                                      packed).config4(FRONT_GROUPED)[1]
        grouped = [sql_grouped(q, "AVG") for q in c4]
        t1, t2 = qs[0].match, qs[FRONT_QUERIES].match.split()[0]

        def selects(tag: str, check: bool) -> dict:
            """The 16 queries through every protocol (and the GROUP BYs
            over MySQL and /sql); -> the card's answers by protocol."""
            out: dict = {"mysql": [], "sql": [], "json": []}
            walls: dict = {}

            def timed(name: str, value):
                walls.setdefault(name, []).append(counter.last_wall * 1e3)
                return value
            for sql in sqls:
                res = timed("mysql SELECT", mysql(sql))
                meta = timed("mysql SHOW META", mysql("SHOW META"))
                out["mysql"].append((res, meta))
            for sql in sqls:
                out["sql"].append(timed("/sql", sql_http(sql)))
            for q in qs:
                body = json.dumps(json_query(q)).encode()
                out["json"].append(timed("/json/search", http(
                    "/json/search", body, q.match)))
            out["api"] = timed("api multi-query", api_search(qs))
            timed(f"api {FRONT_API_CLIENTS} concurrent multi-queries",
                  api_burst(qs, out["api"]))
            print(f"front selects ({tag}): cuda wall per request, median "
                  f"[min, max] (ms): " + "; ".join(
                      f"{k} {np.median(v):.2f} [{min(v):.2f}, {max(v):.2f}]"
                      for k, v in walls.items()))
            for sql in grouped:
                mysql(sql)
                sql_http(sql)
            if check:
                got = {
                    "mysql": [([(int(a), int(b)) for a, b in r["rows"]],
                               int(dict(m["rows"])["total_found"]))
                              for r, m in out["mysql"]],
                    "/sql": [hits_rows(o) for o in out["sql"]],
                    "/json/search": [hits_rows(o) for o in out["json"]],
                    "sphinxapi": out["api"]}
                for proto, rows in got.items():
                    check_sql_ties(f"front {proto} {tag} vs the 200k "
                                   "SearchIndex", sqls, rows, want, limits)
            print(f"{since(t_start)} front selects ({tag}) done")
            return out

        first = selects("after IMPORT", True)

        # writes: MySQL transactions, then the JSON write endpoints
        rng = np.random.RandomState(43)
        next_id = N_DOCS + 1
        cdocs = cats["cpu"].tables["docs"]
        cols = "(id, content, year, group_id)"

        def values(ds):
            return ", ".join(f"({d['id']}, '{d['content']}', {d['year']}, "
                             f"{d['group_id']})" for d in ds)
        for _ in range(FRONT_TXNS):
            (updates, year, replaces, inserts, deletes,
             next_id) = rt_write_stream(rng, cdocs, next_id)
            txn = (["BEGIN", f"UPDATE docs SET year = {year} WHERE id IN "
                    f"({', '.join(map(str, updates))})"]
                   + [f"{verb} INTO docs {cols} VALUES "
                      f"{values(rows[i:i + FRONT_ROWS])}"
                      for verb, rows in (("REPLACE", replaces),
                                         ("INSERT", inserts))
                      for i in range(0, len(rows), FRONT_ROWS)]
                   + [f"DELETE FROM docs WHERE id IN "
                      f"({', '.join(map(str, deletes))})", "COMMIT"])
            for sql in txn:
                mysql(sql)
        texts = corpus_texts(rng.choice(N_DOCS, 4 * FRONT_JSON_DOCS
                                        + FRONT_BULK, replace=False).tolist())
        live = sorted(rng.choice(N_DOCS // 2, 3 * FRONT_JSON_DOCS,
                                 replace=False).tolist())
        for k in range(FRONT_JSON_DOCS):
            doc = {"content": texts.pop(), "year": 2000 + k,
                   "group_id": k}
            http("/json/insert", json.dumps(
                {"index": "docs", "id": next_id, "doc": doc}).encode(),
                "insert")
            next_id += 1
            http("/json/replace", json.dumps(
                {"index": "docs", "id": live[k] + 1,
                 "doc": dict(doc, content=texts.pop())}).encode(),
                "replace")
            http("/json/update", json.dumps(
                {"index": "docs", "id": live[FRONT_JSON_DOCS + k] + 1,
                 "doc": {"year": 1990 + k}}).encode(), "update")
            http("/json/delete", json.dumps(
                {"index": "docs", "id": live[2 * FRONT_JSON_DOCS + k] + 1}
            ).encode(), "delete")
        bulk = "\n".join(json.dumps({"insert": {
            "index": "docs", "id": next_id + i,
            "doc": {"content": texts.pop() + " frontbulk",
                    "year": 2000 + i % 25, "group_id": i % 100}}})
            for i in range(FRONT_BULK))
        out = http("/json/bulk", bulk.encode(), f"{FRONT_BULK} documents")
        if out.get("errors") or len(out.get("items", [])) != FRONT_BULK:
            raise AssertionError(f"front /json/bulk: {str(out)[:500]}")
        next_id += FRONT_BULK
        print(f"front writes: {FRONT_TXNS} MySQL transactions of {RT_OPS} "
              f"operations (statements of at most {FRONT_ROWS} rows), "
              f"{FRONT_JSON_DOCS} each of /json/insert, replace, update and "
              f"delete, a /json/bulk of {FRONT_BULK}; {len(docs.segments)} "
              f"segments, {docs.n_docs} docs")
        selects("after the writes", False)
        # a highlight needs stored text: a small table that keeps it
        sql_http("CREATE TABLE notes (content text, year uint)")
        mysql("INSERT INTO notes (id, content, year) VALUES " + ", ".join(
            f"({i + 1}, '{t} frontbulk', {2000 + i})"
            for i, t in enumerate(corpus_texts(list(range(FRONT_ROWS))))))
        hl = http("/json/search", json.dumps({
            "index": "notes", "query": {"match": {"content": f"{t1}"}},
            "limit": 5, "highlight": {"fields": ["content"],
                                      "limit": 80}}).encode(), "highlight")
        frags = [f for h in hl["hits"]["hits"]
                 for f in h.get("highlight", {}).get("content", [])]
        print(f"front highlight: {hl['hits']['total']} hits, "
              f"{len(frags)} fragments, the first {frags[:1]}")
        if not any("<b>" in f for f in frags):
            raise AssertionError(f"front highlight: no highlighted "
                                 f"fragment in {str(hl)[:500]}")

        # percolate: stored queries by /json/pq/<t>/doc, then a search
        sql_http("CREATE TABLE pq (content text, year uint) "
                 "type='percolate'")
        gen = bench_corpus.WorkloadGen(np.random.RandomState(45), VOCAB,
                                       packed)
        stored = [q.match for q in
                  config1_queries(gen, FRONT_PQ_QUERIES // 2)
                  + config2_queries(gen, FRONT_PQ_QUERIES // 2)]
        mark: dict = {}

        def peek_uid():
            n = next(uid._counter)
            uid._counter = itertools.count(n)
            mark["n"] = n

        def rewind_uid():       # the twin draws the same auto ids
            uid._counter = itertools.count(mark["n"])
        for m in stored:
            peek_uid()
            http("/json/pq/pq/doc", json.dumps({"query": {"ql": m}}).encode(),
                 m, cpu_first=rewind_uid)
        rows = np.random.RandomState(47).choice(N_DOCS, FRONT_PQ_DOCS,
                                                replace=False).tolist()
        pq_docs = [{"content": t, "year": 2000 + r % 25}
                   for t, r in zip(corpus_texts(rows), rows)]
        searched = counter.searches
        out = http("/json/pq/pq/search", json.dumps({"query": {"percolate": {
            "documents": pq_docs}}}).encode(), "search", pq=True)
        print(f"front percolate: {FRONT_PQ_QUERIES} stored queries, "
              f"{FRONT_PQ_DOCS} documents: {out['hits']['total']} queries "
              f"match, {counter.searches - searched} stored queries "
              f"searched; wall {counter.last_wall:.3f} s on cuda")
        if not out["hits"]["total"]:
            raise AssertionError("front percolate: no stored query matched")

        # KEYWORDS, STATUS, ping
        kw = (_api_str(f"{t1} {t2} t00001") + _api_str("docs")
              + struct.pack(">lllll", 1, 0, 0, 0, 0))
        front.request("api", "KEYWORDS",
                      lambda: api["cuda"].request(3, API_VER_KEYWORDS, kw),
                      lambda: api["cpu"].request(3, API_VER_KEYWORDS, kw))
        front.request("api", "STATUS",
                      lambda: api["cuda"].request(5, API_VER_STATUS,
                                                  struct.pack(">L", 1)),
                      lambda: api["cpu"].request(5, API_VER_STATUS,
                                                 struct.pack(">L", 1)),
                      lambda r: (r[0], api_status_masked(r[1])))
        front.request("mysql", "COM_PING",
                      lambda: my["cuda"].command(0x0E),
                      lambda: my["cpu"].command(0x0E))
        front.report(launches_by_path, t_start)
        time_batch("front http /sql (8 SELECTs after the writes)",
                   HttpSqlBatch(port["cuda"]["http"]), sqls[:8],
                   FRONT_WARM_RUNS, sqls[:1])

        # the query log of the 16 SELECTs, written by a CPU session
        log = io.StringIO()
        sess = Session(cats["cpu"])
        sess.query_log = log
        for sql in sqls:
            if sess.execute(sql)[0].error is not None:
                raise AssertionError(f"front query log: {sql!r}")
        sess.close()
        log_path = os.path.join(tmp, "query.log")
        with open(log_path, "w") as f:
            f.write(log.getvalue())

        # 2. the daemon as a process
        for c in clients:
            c.close()
        clients = []
        asyncio.run_coroutine_threadsafe(_stop_all(servers), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        loop_thread.join(60)
        loop = None
        counter.close()
        counter = None
        del cats, docs, cdocs, servers
        servers = {}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ddir = os.path.join(tmp, "daemon")
        dports = free_ports(3)
        daemon = DaemonProcess(ddir, dports)
        print(f"front daemon: listening on MySQL {dports[0]}, HTTP "
              f"{dports[1]}, SphinxAPI {dports[2]} after "
              f"{daemon.start_s:.2f} s")
        free0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        for sql in ("SET GLOBAL qcache_max_bytes=0",
                    f"IMPORT TABLE docs FROM '{os.path.join(tmp, 'docs')}'"):
            status, out = http_sql(dports[1], sql)
            if status != 200 or out.get("error"):
                daemon.fail(f"{sql}: {status} {out}")
        import_s = time.perf_counter() - t0
        free1 = torch.cuda.mem_get_info()[0]
        try:
            apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip().replace("\n", "; ")
        except (OSError, subprocess.SubprocessError) as e:
            apps = f"not read ({e})"
        print(f"front daemon: IMPORT TABLE over /sql {import_s:.2f} s; the "
              f"card's free memory fell by {(free0 - free1) / 2**20:.1f} "
              f"MiB (the table took {table_bytes / 2**20:.1f} MiB in part "
              f"1); nvidia-smi compute apps: {apps or 'none listed'} "
              f"(daemon pid {daemon.proc.pid})")
        if free0 - free1 < 0.9 * table_bytes:
            daemon.fail(f"holds {(free0 - free1) / 2**20:.1f} MiB on the "
                        f"card, less than 0.9 of the table's "
                        f"{table_bytes / 2**20:.1f} MiB")

        def daemon_selects(tag: str) -> None:
            t0 = time.perf_counter()
            dmy = WireMysql(dports[0])
            try:
                for sql, (res, meta) in zip(sqls, first["mysql"]):
                    got = (mysql_masked(dmy.query(sql)),
                           mysql_masked(dmy.query("SHOW META")))
                    if got != (mysql_masked(res), mysql_masked(meta)):
                        daemon.fail(f"mysql {sql!r} ({tag}): {got} != "
                                    f"{res}, {meta}")
            finally:
                dmy.close()
            for sql, res in zip(sqls, first["sql"]):
                status, got = http_sql(dports[1], sql)
                if status != 200 or json_masked(got) != json_masked(res):
                    daemon.fail(f"/sql {sql!r} ({tag}): {status} {got} != "
                                f"{res}")
            dapi = WireApi(dports[2])
            try:
                status, payload = dapi.request(
                    0, API_VER_SEARCH, api_search_body(qs, "docs"))
            finally:
                dapi.close()
            if status != 0 or api_search_results(payload)[0] != first["api"]:
                daemon.fail(f"api search ({tag}): status {status}")
            print(f"front daemon ({tag}): the {len(sqls)} SELECTs over "
                  f"MySQL (with SHOW META) and /sql and one SphinxAPI "
                  f"multi-query equal to part 1's on the card; "
                  f"{time.perf_counter() - t0:.2f} s")
        daemon_selects("after IMPORT")
        rc = replay.main(["--log", log_path, "--host", "127.0.0.1",
                          "--port", str(dports[1]), "--quiet"])
        if rc != 0:
            daemon.fail(f"replay --host returned {rc}")
        stop_s = daemon.stop()
        daemon = DaemonProcess(ddir, dports)
        print(f"front daemon: SIGTERM, exit 0 after {stop_s:.2f} s; "
              f"restarted on its data directory, listening after "
              f"{daemon.start_s:.2f} s (the table reloaded)")
        daemon_selects("after the restart")
        stop_s = daemon.stop()
        daemon = None
        t0 = time.perf_counter()
        rc = replay.main(["--log", log_path, "--data-dir", ddir, "--quiet"]
                         + FRONT_DEVICE_ARGS)
        torch.cuda.synchronize()
        print(f"front replay --data-dir: returned {rc} in "
              f"{time.perf_counter() - t0:.2f} s (daemon stopped in "
              f"{stop_s:.2f} s)")
        if rc != 0:
            raise AssertionError(f"front replay --data-dir returned {rc}")
    finally:
        for c in clients:
            c.close()
        if loop is not None:
            asyncio.run_coroutine_threadsafe(_stop_all(servers),
                                             loop).result(60)
            loop.call_soon_threadsafe(loop.stop)
        if counter is not None:
            counter.close()
        if daemon is not None:
            daemon.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"{since(t_start)} phase 22 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


TEXT_BOTH_PATHS_DOCS = 20_000   # documents built on both builder paths


def load_native() -> str:
    """Build (g++) and load the native tokenizer library, or raise; its
    file name."""
    from manticoresearch_tpu_torch import native
    if native.get_native_lib() is None:
        raise RuntimeError("the native tokenizer library did not build "
                           "(g++ on manticoresearch_tpu_torch/native)")
    return native.library_path().name


def ranked(r) -> tuple:
    """A result's totals, docids in order with their weights, word stats."""
    return (r.total, r.total_found, [(m.docid, m.weight) for m in r.matches],
            [(w.word, w.docs, w.hits) for w in r.word_stats])


def text_documents(texts: list) -> list[dict]:
    """Corpus rows as the documents ``bench_corpus.build_corpus`` indexes:
    ids row + 1, ``year`` 2000 + row % 25, ``group_id`` row % 100."""
    return [dict(id=r + 1, content=t, year=2000 + r % 25, group_id=r % 100)
            for r, t in enumerate(texts)]


def build_text_index(docs: list[dict]):
    """The port's ``IndexBuilder`` over documents with text, on the schema
    of ``bench_corpus.build_corpus``."""
    from manticoresearch_tpu_torch.index.builder import IndexBuilder
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    b = IndexBuilder(Schema(fields=["content"],
                            attrs=[AttrDef("year", AttrType.UINT),
                                   AttrDef("group_id", AttrType.UINT)]))
    b.add_documents(docs)
    return b.build()


def packed_differences(a, b) -> list[str]:
    """Names of the ``PackedIndex`` and ``packed_store()`` fields that
    differ between two builds."""
    import dataclasses

    def same(x, y) -> bool:
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                    and x.dtype == y.dtype and np.array_equal(x, y))
        if isinstance(x, dict) and isinstance(y, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)) and isinstance(y, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y
    out = [f.name for f in dataclasses.fields(a)
           if not same(getattr(a, f.name), getattr(b, f.name))]
    sa, sb = a.packed_store(), b.packed_store()
    return out + [f"packed_store.{f.name}" for f in dataclasses.fields(sa)
                  if not same(getattr(sa, f.name), getattr(sb, f.name))]


def text_phase(batches: dict, gpu_results: dict, launches_by_path: dict,
               t_start: float) -> None:
    """Phase 23: the 200k corpus indexed from text by the port's
    ``IndexBuilder`` on its native path (``native/tokenizer.cpp``), the
    first 20,000 documents on both builder paths (equal), and phase 3's
    batches on the card over the text-built index: one K1 launch per batch
    and phase 5's answers."""
    from manticoresearch_tpu_torch import native
    t_phase = time.perf_counter()
    print(f"text200k: native library {load_native()} loaded (built in "
          "phase 2)")
    t0 = time.perf_counter()
    docs = text_documents(corpus_texts(list(range(N_DOCS))))
    print(f"text200k: {len(docs)} documents rendered as text in "
          f"{time.perf_counter() - t0:.2f} s "
          f"({sum(len(d['content']) for d in docs) / 2**20:.1f} MiB)")

    n_both = min(TEXT_BOTH_PATHS_DOCS, len(docs))
    t0 = time.perf_counter()
    by_native = build_text_index(docs[:n_both])
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with native.turned_off():
        by_python = build_text_index(docs[:n_both])
    python_s = time.perf_counter() - t0
    tokens = len(by_native.hit_packed)
    print(f"text200k: the first {n_both} documents ({tokens} tokens) built "
          f"on the native path in {native_s:.2f} s "
          f"({tokens / native_s / 1e6:.3f} M tokens/s), on the Python path "
          f"in {python_s:.2f} s ({tokens / python_s / 1e6:.3f} M tokens/s)")
    diff = packed_differences(by_native, by_python)
    if diff:
        raise AssertionError(f"text200k: the native and Python builds "
                             f"differ in {diff}")
    print("text200k: both paths give every array of PackedIndex and "
          "packed_store() equal")
    del by_native, by_python

    t0 = time.perf_counter()
    built = build_text_index(docs)
    build_s = time.perf_counter() - t0
    tokens = len(built.hit_packed)
    del docs
    print(f"text200k: {built.n_docs} docs, {built.n_terms} terms, "
          f"{built.n_postings} postings, {tokens} tokens built from text on "
          f"the native path in {build_s:.2f} s "
          f"({build_s / (tokens / 1e6):.3f} s per M tokens)")
    t0 = time.perf_counter()
    built.packed_store()
    gpu = SearchIndex(built, device="cuda")
    torch.cuda.synchronize()
    print(f"text200k: packed store and upload {time.perf_counter() - t0:.2f} "
          f"s; device memory of the index {index_bytes(gpu) / 2**20:.1f} MiB")
    for name, qs in batches.items():
        res, _ = run_counted(f"text200k {name}", gpu, qs, launches_by_path)
        check_ties(f"text200k {name}", qs, res, gpu_results[name])
        exact = sum(ranked(r) == ranked(w)
                    for r, w in zip(res, gpu_results[name]))
        print(f"text200k {name}: {exact} of {len(qs)} results (docids in "
              "order, weights, totals, word stats) equal to phase 5's "
              "without normalizing ties")
    del gpu, built
    torch.cuda.empty_cache()
    print(f"{since(t_start)} phase 23 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


# phase 24: the bench at its defaults but one measured batch per config,
# a 5 s budget and no scale section
BENCH_ARGS = ["--batches", "1", "--budget", "5", "--scale-docs", "",
              "--verbose"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "recall_at_10",
              "configs", "scale", "latency_ms", "utilization", "device"}
BENCH_MAINS = ("1_single_term_bm25", "2_boolean_filters",
               "3_phrase_proximity", "4_facet_groupby")
BENCH_BATCH = 128          # bench.py's --batch


def bench_phase(smi: str, launches_by_path: dict, t_start: float) -> None:
    """Phase 24: the port's bench (``tools/bench.py``) at phase 3's corpus
    size, with every ``SearchIndex`` round and ``ShardedIndex`` batch
    counted: its JSON line must hold bench.py's keys and the card's
    ``device``, ``recall_at_10`` 1.0 and every config measured, and each
    round one K1 launch where it reads packed windows."""
    import contextlib
    import io
    from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
    from manticoresearch_tpu_torch.tools import bench
    t_phase = time.perf_counter()
    calls = []     # (kind, index, queries, K1 launches, plain decodes)
    drive, sharded = SearchIndex._drive, ShardedIndex.search_batch

    def counted(kind, orig):
        def wrapper(self, queries):
            ps.LAUNCHES.reset()
            gb.LAUNCHES.reset()
            out = orig(self, queries)
            calls.append((kind, self, list(queries), ps.LAUNCHES.kernel,
                          ps.LAUNCHES.plain + gb.LAUNCHES.plain))
            return out
        return wrapper

    SearchIndex._drive = counted("single", drive)
    ShardedIndex.search_batch = counted("sharded", sharded)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--docs", str(N_DOCS), "--vocab", str(VOCAB),
                             "--avg-len", str(AVG_LEN)] + BENCH_ARGS)
    finally:
        SearchIndex._drive, ShardedIndex.search_batch = drive, sharded
    line = buf.getvalue().strip()
    print(f"bench line: {line}")
    if rc != 0:
        raise AssertionError(f"bench: exit code {rc}")
    out = json.loads(line)
    D = min(8, torch.cuda.device_count())
    want_cfgs = set(BENCH_MAINS) | {f"5_distributed_{D}shard"}
    name, power = (s.strip() for s in smi.split(",", 1))
    if set(out) != BENCH_KEYS:
        raise AssertionError(f"bench: keys {sorted(out)}, expected "
                             f"{sorted(BENCH_KEYS)}")
    if out["recall_at_10"] != 1.0:
        raise AssertionError(f"bench: recall_at_10 {out['recall_at_10']}")
    if set(out["configs"]) != want_cfgs or not all(
            isinstance(v, float) and v > 0 for v in out["configs"].values()):
        raise AssertionError(f"bench: configs {out['configs']}")
    if out["device"] != {"name": name, "power_limit": power,
                         "count": torch.cuda.device_count()}:
        raise AssertionError(f"bench: device {out['device']}, card {smi}")
    if set(out["latency_ms"]) != {"batch_p50_ms", "batch_p99_ms"}:
        raise AssertionError(f"bench: latency_ms {out['latency_ms']}")

    paths = Counter()
    n_batches = 0
    for kind, idx, qs, k1, plain in calls:
        want = (sharded_launches(idx, qs) if kind == "sharded"
                else int(reads_packed(idx, qs)))
        if k1 != want or plain:
            raise AssertionError(f"bench {kind} round of {len(qs)}: {k1} K1 "
                                 f"launches and {plain} plain, expected "
                                 f"{want} and 0")
        path = ("bench config 5" if kind == "sharded" else
                "bench configs 1-4" if len(qs) > 1 else "bench parity")
        paths[path] += k1
        n_batches += kind == "single" and len(qs) > 1
    # --batches 1: one warm-up and one measured batch per config
    if n_batches != 2 * len(BENCH_MAINS) or paths["bench configs 1-4"] != \
            n_batches:
        raise AssertionError(f"bench: {n_batches} batches of configs 1-4 "
                             f"with {paths['bench configs 1-4']} K1 "
                             "launches, expected 8 and 8")
    launches_by_path.update(paths)
    print(f"bench: {len(calls)} rounds counted, K1 launches {dict(paths)}: "
          "one per round that reads packed windows; configs "
          f"{out['configs']}, recall_at_10 {out['recall_at_10']}")

    # the host planner's share of a bench batch: every measured batch is a
    # fresh draw, so its wall includes planning each query
    idx = next(c[1] for c in reversed(calls) if c[0] == "single")
    gen = bench_corpus.WorkloadGen(np.random.RandomState(31), VOCAB,
                                   idx.packed)
    for name, draw in (("config1", gen.config1), ("config2", gen.config2)):
        fresh, planned = draw(BENCH_BATCH)[1], draw(BENCH_BATCH)[1]
        t0 = time.perf_counter()
        idx.search_batch(fresh)
        torch.cuda.synchronize()
        fresh_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for q in planned:
            idx.plan(q)
        plan_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        idx.search_batch(planned)
        torch.cuda.synchronize()
        print(f"bench {name}: a fresh batch of {BENCH_BATCH} "
              f"{fresh_ms:.2f} ms; another fresh batch planned first: "
              f"plans {plan_ms:.2f} ms, then the batch "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    del calls, idx
    torch.cuda.empty_cache()
    print(f"{since(t_start)} phase 24 done in "
          f"{time.perf_counter() - t_phase:.1f} s")


async def _stop_all(servers: dict) -> None:
    """Close every listener and cancel its connections' handlers."""
    import asyncio
    for by_proto in servers.values():
        for srv in by_proto.values():
            if srv._server is not None:
                srv._server.close()
    me = asyncio.current_task()
    tasks = [t for t in asyncio.all_tasks() if t is not me]
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)


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
def build_shards() -> tuple[list, float]:
    """Bench config 5's shards of the 200k corpus (phases 18-20) and their
    build seconds."""
    t0 = time.perf_counter()
    shards = bench_corpus.build_corpus_shards(N_DOCS, VOCAB, AVG_LEN, SHARDS)
    return shards, time.perf_counter() - t0


def build_big(n_docs: int) -> tuple:
    """Phase 9's corpus with its packed store, and the seconds of each."""
    t0 = time.perf_counter()
    big = bench_corpus.build_corpus(n_docs, VOCAB, AVG_LEN)
    t1 = time.perf_counter()
    big.packed_store()
    return big, t1 - t0, time.perf_counter() - t1


def host_built_shards(shards_job) -> list:
    """A copy of the host-build process's shards, for a phase to own."""
    t0 = time.perf_counter()
    shards, build_s = shards_job.get()
    shards = copy.deepcopy(shards)
    print(f"shards built in {build_s:.1f} s by the host-build process; "
          f"waited and copied in {time.perf_counter() - t0:.1f} s here")
    return shards


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the shards of phases 18-20 and the 1M corpus of phase 9 are about two
    # minutes of host work: a process of their own (spawned, so it never
    # touches the card) builds them while this one drives the card
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        return smoke(pool.apply_async(build_shards),
                     pool.apply_async(build_big, (BIG_DOCS,)))
    finally:
        pool.terminate()
        pool.join()


def smoke(shards_job, big_job) -> int:
    """The phases, in order; ``shards_job`` and ``big_job`` are the
    host-build process's results (``build_shards``, ``build_big``)."""
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
    t0 = time.perf_counter()
    lib_name = load_native()
    print(f"native tokenizer library build (g++) and load: "
          f"{time.perf_counter() - t0:.2f} s ({lib_name})")

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
    main = time_kernel(iters=100, **decode_entry(
        "main path (config-2 batch)", batch_items["config2"]))
    time_kernel(iters=100, **decode_entry("main path (config-1 batch)",
                                          batch_items["config1"]))
    gen = torch.Generator().manual_seed(7)
    time_kernel(iters=50, **decode_entry(
        f"c={main_c} 65536 blocks rowids",
        [_random_window(main_c, 1 << 16, True, gen)]))
    time_kernel(iters=20, flush=False, **decode_entry(
        f"c={main_c} {big_nb} blocks rowids (beyond L2)",
        [_random_window(main_c, big_nb, True, gen)]))

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
    sharded_phase(gpu, batches, gpu_results, launches_by_path, t_start,
                  shards_job)

    # 19. the RT index: 8 disk chunks of the 200k corpus, a write stream,
    # FLUSH RAMCHUNK and OPTIMIZE, against the CPU twin; a binlog reload
    rt_phase(packed, batches, gpu_results, launches_by_path, t_start,
             shards_job)

    # 20. the SphinxQL session layer: a 200k table by IMPORT TABLE, a write
    # stream, percolate queries, distributed tables, against the CPU twin
    session_phase(packed, batches, gpu_results, launches_by_path, t_start,
                  shards_job)

    # 21. replication: two nodes on the card and a CPU twin cluster; the
    # 200k table by snapshot transfer, writes from both nodes
    cluster_phase(packed, batches, launches_by_path, t_start)

    # 22. the front ends: the MySQL, HTTP and SphinxAPI listeners on the
    # card against CPU twins, then the daemon as a process
    front_phase(packed, batches, gpu_results, launches_by_path, t_start)

    # 23. the 200k corpus indexed from text on the native path (both builder
    # paths equal on 20k documents), phase 3's batches over it on the card
    text_phase(batches, gpu_results, launches_by_path, t_start)

    # 24. the port's bench (tools/bench.py) over the 200k corpus: its JSON
    # line, the parity gate and one K1 launch per round
    bench_phase(smi, launches_by_path, t_start)
    del gpu, cpu, packed, data, batch_items, plans, all_plans
    torch.cuda.empty_cache()
    print(f"{since(t_start)} 200k phases done")

    # 9. the large index: sparse union and filter-first plans
    n_big = BIG_DOCS
    tag = f"{n_big // 1000}k"
    t0 = time.perf_counter()
    big, build_s, store_s = big_job.get()
    print(f"{tag} corpus: {big.n_docs} docs, {big.n_postings} postings, "
          f"{len(big.hit_packed)} hits, built in {build_s:.1f} s and its "
          f"packed store in {store_s:.1f} s by the host-build process; "
          f"waited {time.perf_counter() - t0:.1f} s for it here")
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

    # 25. the LCS walk kernel: the 12 non-term Lucene categories at 1M
    walk, pos = lcs_phase(tag, gpu, cpu, big, t_start)

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
    time_kernel(iters=50, **decode_entry(f"{tag} config-1 batch",
                                         big_items[f"{tag} config1"]))

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
    time_kernel(iters=10, **segment_entry(
        "200k config-4 avg batch (dense, full width)", seg_calls_dense))
    seg = time_kernel(iters=20, **segment_entry(f"{tag} config-4 avg batch",
                                                seg_calls))
    time_kernel(iters=5, **segment_entry(
        "200k PACKEDFACTORS() batch (factor scatters)", seg_calls_pf_dense))
    time_kernel(iters=5, **segment_entry(
        f"{tag} PACKEDFACTORS() batch (factor scatters)", seg_calls_pf))
    for name, v, g, n in segment_cases():
        if name.startswith(("one group", "groups then")):
            time_kernel(
                iters=3 if name.startswith("one group") else 20,
                **segment_entry(name, [(torch.from_numpy(v).cuda(),
                                        torch.from_numpy(g).cuda(), n)]))
    print(f"{since(t_start)} segment kernel done")

    print(json.dumps({"kernels": [
        kernel_line("bitplane_decode", KERNEL_SOURCE, KERNEL_REPLACES,
                    launches_by_path, max_err, main),
        kernel_line("segment_sum_ordered", SEG_SOURCE, SEG_REPLACES,
                    SEG_BY_PATH, seg_err, seg),
        kernel_line("lcs_walk", WALK_SOURCE, WALK_REPLACES, WALK_BY_PATH,
                    max(t["max_abs_err"] for t in walk.values()), walk),
        kernel_line("pos_walk", POS_SOURCE, POS_REPLACES, POS_BY_PATH,
                    max(t["max_abs_err"] for t in pos.values()), pos)]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
