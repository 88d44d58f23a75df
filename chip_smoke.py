#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main search path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; each raises on a failure, so the exit code is then not 0:

1. Require CUDA. Print the card (``nvidia-smi`` name and power limit) and
   the torch and CUDA versions.
2. Build the CUDA kernels from ``manticoresearch_tpu_torch/csrc`` (timed).
3. Plan the main path's queries: the bench corpus at 200k documents
   (``bench_corpus.build_corpus(200_000, 50_000, 100)``, the port's copy
   of ``bench.build_corpus``), one batch of 64 config-1 queries and one of
   64 config-2 queries, with terms picked as ``bench_corpus.WorkloadGen``
   picks them.
4. Check the grouped bit-plane decode kernel against its plain PyTorch
   version on the card: each main-path batch's own work list; one work
   list of every width class, with and without the prefix sum, windows of
   1, 7 and the main path's number of blocks and one of 262144 blocks,
   random words with bit 31 set and random bases; then each class through
   the one-window wrappers; then 2148 small windows, more than the kernel
   keeps in shared memory. Bit-exact. A misaligned window must raise.
5. Run the main path: both batches through ``SearchIndex.search_batch``
   on ``device="cuda"``, with the launch counters set to 0 just before and
   read just after. Each ``search_batch`` must make exactly one kernel
   launch, and the plain decode must not have run.
6. Check the results: every docid, weight, total, total_found and word
   stat equal to the same queries on ``device="cpu"``; the single-term
   queries' top 10 equal to a host numpy model of the reference scoring
   (recall@10 = 1.0, as ``bench.parity_recall_at_10``).
7. Time each batch again with everything warm (and once under
   ``torch.profiler``: device time, busy share, kernel launches), and the
   kernel against its plain version: at the main path's shape (each
   batch's work list, with the 50 MB L2 flushed before each launch), at
   65536 blocks and at 262144 blocks of the main class (202 MB at c=16:
   beyond L2).
   The kernel's time is its device time from ``torch.profiler``; the
   bound is the bytes it must move over 3.35 TB/s.

The last three lines of standard output are one JSON object with the
kernels' numbers, the card's name and power limit, then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.ops import _build
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops.search import packed_windows
from manticoresearch_tpu_torch.query.planner import AttrFilterDef

N_DOCS, VOCAB, AVG_LEN = 200_000, 50_000, 100
BATCH = 64
WARM_RUNS = 5
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory, published peak
KERNEL_SOURCE = "manticoresearch_tpu_torch/csrc/bitplane_decode.cu"
KERNEL_REPLACES = "manticoresearch_tpu/ops/pfor.py:109"
KERNEL_EVENT = "bitplane_decode_grouped"
KERNEL_SMEM_ITEMS = 2048   # csrc/bitplane_decode.cu: kSmemItems


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
            [(m.docid, m.weight) for m in r.matches],
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


def check_decode_kernel(nbs: list[int], big_c: int, big_nb: int,
                        batch_items: dict) -> int:
    """Grouped kernel vs plain version on the card; returns the max abs
    error (must be 0) over every window of a mixed work list, and over
    each main-path batch's own work list."""
    max_err = 0
    for name, items in batch_items.items():
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
    the device busy share, the kernel launches and K1's device time."""
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
    k1_ms = sum(e.time_range.elapsed_us() for e in on_device
                if KERNEL_EVENT in e.name) / 1e3
    launches = sum(1 for e in events
                   if e.name.startswith("cudaLaunchKernel"))
    return dict(wall_ms=wall_ms, device_ms=dev_ms,
                busy=dev_ms / wall_ms, launches=launches, k1_ms=k1_ms)


# --------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1

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

    # 5. the main path on the card, counted
    ps.LAUNCHES.reset()
    gpu_results = {}
    wall = {}
    per_batch = {}
    peak = {}
    for name, qs in batches.items():
        before = ps.LAUNCHES.kernel
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        gpu_results[name] = gpu.search_batch(qs)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        per_batch[name] = ps.LAUNCHES.kernel - before
        peak[name] = torch.cuda.max_memory_allocated() - base_mem
    launches, plain = ps.LAUNCHES.kernel, ps.LAUNCHES.plain
    blocks = ps.LAUNCHES.blocks
    print(f"main path on cuda: bitplane_decode launches {launches} "
          f"({per_batch} per search_batch), {blocks} blocks decoded, "
          f"plain decodes {plain}; peak device memory above the index "
          f"per batch (MiB): "
          f"{ {k: round(v / 2**20, 2) for k, v in peak.items()} }")
    if plain != 0 or any(n != 1 for n in per_batch.values()):
        raise AssertionError("the main path did not make exactly one kernel "
                             "launch per search_batch")

    # 6. results: equal to the CPU port, recall@10 vs the host model
    n_single = 0
    recall = 0.0
    for name, qs in batches.items():
        want = cpu.search_batch(qs)
        for q, g, w in zip(qs, gpu_results[name], want):
            if g.error is not None or w.error is not None:
                raise AssertionError(f"{q.match!r}: error {g.error or w.error}")
            if _summary(g) != _summary(w):
                raise AssertionError(f"{name} {q.match!r}: cuda result "
                                     f"{_summary(g)} != cpu {_summary(w)}")
            if " " not in q.match and not q.filters:
                model = host_top10(gpu, q.match)
                got = [(m.docid, m.weight) for m in g.matches]
                hit = sum(1 for x in got if x in model)
                recall += hit / max(len(model), len(got), 1)
                n_single += 1
        found = [r.total_found for r in gpu_results[name]]
        print(f"{name}: {len(qs)} queries equal on cuda and cpu; "
              f"total_found min/median/max {min(found)}/"
              f"{int(np.median(found))}/{max(found)}")
    recall /= max(n_single, 1)
    print(f"recall@10 vs the host model over {n_single} single-term "
          f"queries: {recall}")
    if recall != 1.0:
        raise AssertionError(f"recall@10 {recall} != 1.0")

    # 7. timing
    for name, qs in batches.items():
        warm = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            gpu.search_batch(qs)
            torch.cuda.synchronize()
            warm.append(round((time.perf_counter() - t0) * 1e3, 2))
        print(f"{name}: batch of {len(qs)} on cuda: first run "
              f"{wall[name] * 1e3:.1f} ms, warm runs (ms) {warm}")
        prof = profile_batch(gpu, qs)
        print(f"{name}: one warm batch under the profiler: wall "
              f"{prof['wall_ms']:.2f} ms, device time {prof['device_ms']:.3f}"
              f" ms (busy share {prof['busy']:.3f}), {prof['launches']} "
              f"kernel launches, K1 {prof['k1_ms'] * 1e3:.2f} us")
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

    print(json.dumps({"kernels": [{
        "name": "bitplane_decode", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "launches_per_batch": launches / len(batches),
        "max_abs_err": max_err, "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
