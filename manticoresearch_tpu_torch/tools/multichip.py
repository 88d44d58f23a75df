"""The distributed index over several cards: bench config 5, one shard per
card.

The port's counterpart of ``__graft_entry__.dryrun_multichip`` (which
compiles the JAX package's mesh program on a virtual CPU mesh), on real
cards:

    python3 -m manticoresearch_tpu_torch.tools.multichip \\
        [--docs 200000 1000000]

For each corpus size it builds bench.py's config 5: ``D = min(8, visible
cards)`` shards of ``bench_corpus.build_corpus_shards(n, 50_000, 100,
D)``, one per card (``make_mesh(D)``), and runs 64 config-1 and 64
config-2 queries through ``ShardedIndex.search_batch``, then 8 grouped
config-4 queries with ``avg(year)`` (the host-merge fallback: each
shard's search on its own card, the segment-sum kernel included). The
queries are drawn as ``chip_smoke.py`` draws them (``WorkloadGen`` over
the 200k corpus, seeds 7 and 21) and serve every corpus size. It fails,
with a nonzero exit code, where a query leaves its route, where a merged
batch makes other than one bit-plane launch on each card (or the
fallback other launches than its shard searches' plans give), where a
card's allocation grew by less than the bytes of the parts put on it, or
where a result differs from a ``ShardedIndex`` of the same shards on the
first card alone and, at 200k, from one ``SearchIndex`` over the whole
corpus (docids, weights, total_found). It never fails on a time. It
prints each card's name and power limit, the memory the mesh took on
each card, the warm walls of each batch on the D cards and on one card,
and each card's busy share in one profiled warm batch; its last
line is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": D}}``.

``check_mesh`` is the check for one mesh: ``chip_smoke.py`` (phase 18b)
calls it with positions on one card (``["cuda:0"] * 4``), the tests with
``["cpu"] * P``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from collections import Counter

import numpy as np
import torch

from dataclasses import replace

from .. import bench_corpus
from ..exec.searcher import SearchIndex, SearchQuery
from ..ops import _build
from ..ops import groupby as gb
from ..ops import packed_store as ps
from ..ops.search import window_kinds
from ..parallel.sharded import (ShardedIndex, cards, make_mesh,
                                smi_cards, sync)

VOCAB, AVG_LEN = 50_000, 100       # bench.py's corpus
QUERY_DOCS, QUERY_SEED = 200_000, 7
BATCH = 64
MAX_CARDS = 8                      # bench.py config 5: min(8, devices)
PROFILE_QUERIES = 4                # profiled queries of a batch
FALLBACK_QUERIES = 8               # grouped queries of the fallback batch
FALLBACK_SEED = 21


def config_batches(packed, seed: int = QUERY_SEED, n: int = BATCH,
                   vocab: int = VOCAB) -> dict[str, list[SearchQuery]]:
    """``chip_smoke.py``'s phase 3 draws: the measured twins of n
    ``WorkloadGen`` config-1 draws (single terms), then of n config-2
    draws (a term 40%, AND 30%, OR 20%, AND under a ``year`` range
    10%)."""
    gen = bench_corpus.WorkloadGen(np.random.RandomState(seed), vocab, packed)
    return {"config1": gen.config1(n)[1], "config2": gen.config2(n)[1]}


def fallback_batch(packed, seed: int = FALLBACK_SEED,
                   n: int = FALLBACK_QUERIES,
                   vocab: int = VOCAB) -> list[SearchQuery]:
    """n ``WorkloadGen`` config-4 draws (GROUP BY group_id, ORDER BY
    @count desc) with ``count(*), avg(year)``: the distributed index's
    host-merge fallback, each shard's grouped search on its own device
    with one segment-sum launch for the AVG."""
    gen = bench_corpus.WorkloadGen(np.random.RandomState(seed), vocab, packed)
    return [replace(q, select=["count(*)", "avg(year)"])
            for q in gen.config4(n)[1]]


def summary(r) -> tuple:
    return (r.error, r.total, r.total_found,
            [(m.docid, m.weight, m.attrs) for m in r.matches],
            [(w.word, w.docs, w.hits) for w in r.word_stats])


def walls(idx, queries: list, devices: list, runs: int) -> list[float]:
    """Warm walls (ms) of ``runs`` batches, each up to a synchronize of
    every card of ``devices``."""
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        idx.search_batch(queries)
        sync(devices)
        out.append(round((time.perf_counter() - t0) * 1e3, 2))
    return out


def profiled(idx, queries: list, devices: list) -> tuple[float, list]:
    """One warm batch under torch.profiler, up to a synchronize of every
    card of ``devices``: its wall (ms) and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.search_batch(queries)
        sync(devices)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof.events()


def busy_shares(idx, queries: list, devices: list) -> dict:
    """One warm batch under torch.profiler: its wall, and each card's
    device time (its kernels and copies, by the events' device index) over
    that wall."""
    from torch.autograd import DeviceType
    wall_ms, events = profiled(idx, queries, devices)
    dev_us: Counter = Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            dev_us[e.device_index] += e.time_range.elapsed_us()
    return {"wall_ms": round(wall_ms, 2), "queries": len(queries),
            "busy": {str(d): round(dev_us[d.index] / 1e3 / wall_ms, 4)
                     for d in cards(devices)},
            "device_ms": {str(d): round(dev_us[d.index] / 1e3, 3)
                          for d in cards(devices)}}


def check_fallback(idx: ShardedIndex, one, queries: list, path: str,
                   launches_by_path: dict | None) -> dict:
    """A batch that only takes the fallback: each shard's own grouped
    search on its part's device. On cards: one bit-plane launch per shard
    search whose plan reads packed windows, on that shard's card, and one
    segment-sum launch per float SUM or AVG aggregate of each shard
    search; on the CPU the same counts as plain versions. Results equal to
    ``one``'s."""
    routes = Counter(idx._prep(q)[0] for q in queries)
    if routes != Counter({"fallback": len(queries)}):
        raise AssertionError(f"{path}: routes {dict(routes)}")
    want_k1, want_seg = Counter(), 0
    for d, sidx in enumerate(idx._per_shard_indexes()):
        dev = idx.devices[d // idx.per_part]
        for q in queries:
            cq, gspec = sidx._plan_grouped(q)[:2]
            if window_kinds(cq.sig):
                want_k1[str(cards([dev])[0]) if dev.type == "cuda"
                        else "plain"] += 1
            want_seg += sum(a.kind == "avg" or (a.is_float and a.kind == "sum")
                            for a in gspec.aggs)
    on_cards = all(d.type == "cuda" for d in idx.devices)
    sync(idx.devices)
    ps.LAUNCHES.reset()
    gb.LAUNCHES.reset()
    got = idx.search_batch(queries)
    sync(idx.devices)
    k1 = dict(ps.LAUNCHES.by_device)
    if ps.LAUNCHES.plain:
        k1["plain"] = ps.LAUNCHES.plain
    seg = gb.LAUNCHES.kernel if on_cards else gb.LAUNCHES.plain
    if launches_by_path is not None:
        launches_by_path[path] = ps.LAUNCHES.kernel
    print(f"{path}: bitplane_decode launches by card {k1} (expected "
          f"{dict(want_k1)}); segment_sum_ordered "
          f"{'launches' if on_cards else 'plain sums'} {seg} (expected "
          f"{want_seg})")
    if k1 != dict(want_k1) or seg != want_seg or (
            on_cards and (ps.LAUNCHES.plain or gb.LAUNCHES.plain)):
        raise AssertionError(f"{path}: launches {k1}, segment sums {seg}")
    for q, g, w in zip(queries, got, one.search_batch(queries)):
        if g.error is not None or summary(g) != summary(w):
            raise AssertionError(f"{path} {q.match!r}: {summary(g)} != one "
                                 f"part {summary(w)}")
    print(f"{path}: {len(queries)} queries equal to one part")
    return {"launches_by_card": k1, "segment_sum_launches": seg}


def check_mesh(shards: list, devices: list, batches: dict, one,
               single: dict | None = None, runs: int = 2,
               launches_by_path: dict | None = None,
               tag: str = "mesh", fallback: list | None = None) -> dict:
    """``ShardedIndex(shards, devices=devices)`` against ``one``, an index
    of the same shards in one part: every query of ``batches`` (name ->
    queries) on the merged path; per merged batch exactly one bit-plane
    launch on each part's device (a plain decode for a CPU part); every
    result equal to ``one``'s and (docids, weights, total_found) to
    ``single[name]`` where given; every card's allocation grown, while the
    mesh was built, by at least the bytes of its parts. Raises on the
    first failure. Records each counted batch's kernel launches in
    ``launches_by_path``. On cards it also times ``runs`` warm batches in
    turns on the mesh and on ``one`` and profiles one of
    ``PROFILE_QUERIES``. Then ``fallback``, where given, through
    ``check_fallback``. -> a report of what it measured."""
    on_cards = cards(devices)
    gc.collect()
    sync(devices)
    before = {d: torch.cuda.memory_allocated(d) for d in on_cards}
    t0 = time.perf_counter()
    idx = ShardedIndex(shards, devices=devices)
    sync(devices)
    # each card's allocation taken by the mesh, apart from what it held
    memory = {str(d): torch.cuda.memory_allocated(d) - before[d]
              for d in on_cards}
    part_bytes = [sum(t.numel() * t.element_size()
                      for v in part.values()
                      for t in (v.values() if isinstance(v, dict) else [v]))
                  for part in idx.parts]
    card_bytes = Counter()
    for dev, b in zip(idx.devices, part_bytes):
        if dev.type == "cuda":
            card_bytes[str(cards([dev])[0])] += b
    print(f"{tag}: {len(shards)} shards in {len(idx.parts)} parts on "
          f"{[str(d) for d in idx.devices]}, uploaded in "
          f"{time.perf_counter() - t0:.1f} s; MiB per part "
          f"{[round(b / 2**20, 1) for b in part_bytes]}; memory allocated "
          f"by the mesh per card (MiB) "
          f"{ {d: round(b / 2**20, 1) for d, b in memory.items()} }")
    short = [d for d, b in memory.items() if b <= 0 or b < card_bytes[d]]
    if short:
        raise AssertionError(f"{tag}: allocation on {short} grew by "
                             f"{[memory[d] for d in short]} B, less than "
                             f"its parts' {[card_bytes[d] for d in short]}")
    want_cards = Counter(str(cards([d])[0]) for d in idx.devices
                         if d.type == "cuda")
    n_plain = sum(d.type != "cuda" for d in idx.devices)
    report: dict = {"parts": len(idx.parts),
                    "devices": [str(d) for d in idx.devices],
                    "memory_bytes": memory, "part_bytes": part_bytes,
                    "batches": {}}
    for name, qs in batches.items():
        path = f"{tag} {name}"
        routes = Counter(idx._prep(q)[0] for q in qs)
        if routes != Counter({"ok": len(qs)}):
            raise AssertionError(f"{path}: routes {dict(routes)}: a query "
                                 "left the merged path")
        if not any(window_kinds(idx.plan(q).sig) for q in qs):
            raise AssertionError(f"{path}: no packed window on the path")
        sync(devices)
        ps.LAUNCHES.reset()
        t1 = time.perf_counter()
        got = idx.search_batch(qs)
        sync(devices)
        first_ms = (time.perf_counter() - t1) * 1e3
        kernel, plain = ps.LAUNCHES.kernel, ps.LAUNCHES.plain
        by_card = dict(ps.LAUNCHES.by_device)
        if launches_by_path is not None:
            launches_by_path[path] = kernel
        print(f"{path}: bitplane_decode launches {kernel} by card {by_card} "
              f"(expected {dict(want_cards)}), plain decodes {plain} "
              f"(expected {n_plain}); first run {first_ms:.1f} ms")
        if by_card != dict(want_cards) or kernel != sum(want_cards.values()) \
                or plain != n_plain:
            raise AssertionError(f"{path}: launches {kernel} by card "
                                 f"{by_card} and {plain} plain decodes")
        want = one.search_batch(qs)
        for q, g, w in zip(qs, got, want):
            if g.error is not None or summary(g) != summary(w):
                raise AssertionError(f"{path} {q.match!r}: {len(idx.parts)} "
                                     f"parts {summary(g)} != one part "
                                     f"{summary(w)}")
        checked = "equal to one part"
        if single is not None:
            for q, g, w in zip(qs, got, single[name]):
                if ([(m.docid, m.weight) for m in g.matches]
                        != [(m.docid, m.weight) for m in w.matches]
                        or g.total_found != w.total_found):
                    raise AssertionError(f"{path} {q.match!r}: "
                                         f"{summary(g)} != one index "
                                         f"{summary(w)}")
            checked += " and (docids, weights, total_found) to one index"
        print(f"{path}: {len(qs)} queries {checked}")
        entry = {"launches": kernel, "launches_by_card": by_card,
                 "first_ms": round(first_ms, 2)}
        if on_cards:
            mesh_ms, one_ms = [], []
            for run, target in ((idx, mesh_ms), (one, one_ms),
                                (one, one_ms), (idx, mesh_ms)):
                target += walls(run, qs, devices + [one.device],
                                max(runs // 2, 1))
            prof = busy_shares(idx, qs[:PROFILE_QUERIES], devices)
            entry.update(warm_ms=mesh_ms, one_part_warm_ms=one_ms,
                         profiled=prof)
            print(f"{path}: warm walls (ms), in turns: {len(idx.parts)} "
                  f"parts {mesh_ms}, one part on {one.device} {one_ms}")
            print(f"{path}: one warm batch of {prof['queries']} under the "
                  f"profiler: wall {prof['wall_ms']} ms, device ms by card "
                  f"{prof['device_ms']}, busy share by card {prof['busy']}")
        report["batches"][name] = entry
    if fallback:
        report["fallback"] = check_fallback(idx, one, fallback,
                                            f"{tag} fallback",
                                            launches_by_path)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="bench config 5 with one shard per card")
    ap.add_argument("--docs", type=int, nargs="+",
                    default=[200_000, 1_000_000],
                    help="corpus sizes (bench.py's 200k and 1000k)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("multichip: torch.cuda.is_available() is false: this run "
              "needs NVIDIA GPUs", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    mesh = make_mesh(min(MAX_CARDS, torch.cuda.device_count()))
    for line in smi_cards():
        print(f"card: {line}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; mesh "
          f"{[str(d) for d in mesh]}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build (nvcc) and load: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    corpus = bench_corpus.build_corpus(QUERY_DOCS, VOCAB, AVG_LEN)
    batches = config_batches(corpus)
    grouped = fallback_batch(corpus)
    print(f"query corpus ({QUERY_DOCS} docs) built and queries drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    reports = {}
    for n_docs in args.docs:
        tag = f"{n_docs // 1000}k on {len(mesh)} cards"
        t0 = time.perf_counter()
        shards = bench_corpus.build_corpus_shards(n_docs, VOCAB, AVG_LEN,
                                                  len(mesh))
        print(f"{tag}: {len(shards)} shards of "
              f"{sorted({s.n_docs for s in shards})} docs, "
              f"{sum(s.n_postings for s in shards)} postings, built in "
              f"{time.perf_counter() - t0:.1f} s")
        one = ShardedIndex(shards, device=mesh[0])
        single = None
        if n_docs == QUERY_DOCS:
            sidx = SearchIndex(corpus, mesh[0])
            single = {name: sidx.search_batch(qs)
                      for name, qs in batches.items()}
            del sidx
        reports[tag] = check_mesh(shards, mesh, batches, one, single,
                                  runs=4, tag=tag, fallback=grouped)
        del one, shards
        for d in mesh:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        print(f"[{time.perf_counter() - t_start:.0f} s] {tag} done")
    print(json.dumps({"multichip": reports}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": len(mesh)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
