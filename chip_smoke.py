#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main search path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; each raises on a failure, so the exit code is then not 0:

1. Require CUDA. Print the card (``nvidia-smi`` name and power limit) and
   the torch and CUDA versions.
2. Build the CUDA kernels from ``manticoresearch_tpu_torch/csrc`` (timed).
3. Plan the main path's queries: the bench corpus at 200k documents
   (``bench.build_corpus(200_000, 50_000, 100)``), one batch of 64 config-1
   queries and one of 64 config-2 queries, with terms picked as
   ``bench.WorkloadGen`` picks them.
4. Check the bit-plane decode kernel against its plain PyTorch version on
   the card: every width class, with and without the prefix sum, random
   words with bit 31 set, 1, 7 and the main path's number of blocks.
   Bit-exact.
5. Run the main path: both batches through ``SearchIndex.search_batch``
   on ``device="cuda"``, with the kernel launch counters set to 0 just
   before and read just after. The kernel must have launched, the plain
   decode must not have run.
6. Check the results: every docid, weight, total, total_found and word
   stat equal to the same queries on ``device="cpu"``; the single-term
   queries' top 10 equal to a host numpy model of the reference scoring
   (recall@10 = 1.0, as ``bench.parity_recall_at_10``).
7. Time the kernel against its plain version at the main path's shape
   and at 65536 blocks, and each batch again with everything warm.

The last two lines of standard output are one JSON object with the
kernels' numbers, then ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

import bench
from manticoresearch_tpu.query.planner import AttrFilterDef
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.ops import _build
from manticoresearch_tpu_torch.ops import packed_store as ps

N_DOCS, VOCAB, AVG_LEN = 200_000, 50_000, 100
BATCH = 64
KERNEL_SOURCE = "manticoresearch_tpu_torch/csrc/bitplane_decode.cu"
KERNEL_REPLACES = "manticoresearch_tpu/ops/pfor.py:109"


# --------------------------------------------------------------------------
# workload: bench.WorkloadGen's config 1 and 2, with the port's SearchQuery
# --------------------------------------------------------------------------
def config1_queries(gen: bench.WorkloadGen, n: int) -> list[SearchQuery]:
    """Single-term MATCH() BM25 top-10 (the measured twin of each draw)."""
    return [SearchQuery(match=gen.term()[1], limit=10) for _ in range(n)]


def config2_queries(gen: bench.WorkloadGen, n: int) -> list[SearchQuery]:
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
def _random_block_inputs(c: int, nb: int, gen: torch.Generator):
    words = torch.randint(0, 2**32, (nb, ps.PLANE_WORDS * c), generator=gen,
                          dtype=torch.int64)
    words = ps.wrap_i32(words | (1 << 31))
    base = ps.wrap_i32(torch.randint(0, 2**32, (nb,), generator=gen,
                                     dtype=torch.int64))
    return words.cuda(), base.cuda()


def check_decode_kernel(nbs: list[int]) -> int:
    """Kernel vs plain version on the card; returns the max abs error
    (must be 0) over every class, prefix mode and block count."""
    gen = torch.Generator().manual_seed(1234)
    max_err = 0
    for c in ps.CLASSES:
        for nb in nbs:
            words, base = _random_block_inputs(c, nb, gen)
            for prefix in (False, True):
                if prefix:
                    got = ps.decode_rowids(words, base, c)
                    want = ps.decode_rowids_ref(words, base, c)
                else:
                    got = ps.decode_words(words, c)
                    want = ps.decode_words_ref(words, c)
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64))
                          .abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"bitplane_decode c={c} nb={nb} prefix={prefix}: "
                        f"kernel != plain version (max abs err {err})")
            print(f"  bitplane_decode c={c:2d} nb={nb:5d}: bit-exact "
                  "(words, rowids)")
    return max_err


def _time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_decode(c: int, nb: int, prefix: bool, iters: int = 200):
    """(kernel ms, plain ms) per call, measured in turns: plain, kernel,
    kernel, plain."""
    words, base = _random_block_inputs(c, nb, torch.Generator().manual_seed(7))
    if prefix:
        def kern():
            ps.decode_rowids(words, base, c)

        def plain():
            ps.decode_rowids_ref(words, base, c)
    else:
        def kern():
            ps.decode_words(words, c)

        def plain():
            ps.decode_words_ref(words, c)
    for f in (kern, plain):
        f()
    torch.cuda.synchronize()
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kern, iters)
    k2 = _time_ms(kern, iters)
    p2 = _time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
    packed = bench.build_corpus(N_DOCS, VOCAB, AVG_LEN)
    print(f"corpus: {packed.n_docs} docs, {packed.n_postings} postings, "
          f"{len(packed.hit_packed)} hits, built in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gpu = SearchIndex(packed, device="cuda")
    cpu = SearchIndex(packed, device="cpu")
    torch.cuda.synchronize()
    print(f"upload (cuda + cpu): {time.perf_counter() - t0:.1f} s")
    gen = bench.WorkloadGen(np.random.RandomState(7), VOCAB, packed)
    batches = {"config1": config1_queries(gen, BATCH),
               "config2": config2_queries(gen, BATCH)}
    plans = [gpu.plan(q) for qs in batches.values() for q in qs]
    rankers = Counter(cq.sig.ranker for cq in plans)
    if set(rankers) != {"ws_bm25", "proximity_bm25"}:
        raise AssertionError(f"unexpected effective rankers {rankers}")
    slot_blocks = Counter(
        (cq.sig.slot_packed[s][0], cq.slot_pb[s] // ps.BLOCK)
        for cq in plans for s in range(cq.sig.n_slots)
        if cq.sig.slot_packed[s][0])
    if not slot_blocks:
        raise AssertionError("no packed term slot on the main path")
    (main_c, main_nb), _ = slot_blocks.most_common(1)[0]
    print(f"plans: rankers {dict(rankers)}; packed slots by "
          f"(rowid class, blocks): {dict(slot_blocks)}")

    # 4. kernel vs plain version
    max_err = check_decode_kernel(sorted({1, 7, main_nb}))

    # 5. the main path on the card, counted
    ps.LAUNCHES.reset()
    gpu_results = {}
    wall = {}
    for name, qs in batches.items():
        t0 = time.perf_counter()
        gpu_results[name] = gpu.search_batch(qs)
        wall[name] = time.perf_counter() - t0
    launches, plain = ps.LAUNCHES.kernel, ps.LAUNCHES.plain
    print(f"main path on cuda: bitplane_decode launches {launches}, "
          f"plain decodes {plain}")
    if launches <= 0 or plain != 0:
        raise AssertionError("the main path did not run through the kernel")

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
        t0 = time.perf_counter()
        gpu.search_batch(qs)
        warm = time.perf_counter() - t0
        print(f"{name}: batch of {len(qs)} on cuda: first run "
              f"{wall[name] * 1e3:.1f} ms, warm run {warm * 1e3:.1f} ms")
    timings = {}
    for c in ps.CLASSES:
        for prefix in (True, False):
            k_ms, p_ms = time_decode(c, main_nb, prefix)
            timings[(c, prefix)] = (k_ms, p_ms)
            print(f"  decode c={c:2d} nb={main_nb} "
                  f"{'rowids' if prefix else 'words '}: kernel "
                  f"{k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us")
    k_ms, p_ms = timings[(main_c, True)]
    # at the main path's few blocks a call is bound by the host's launch
    # cost; a large call shows the kernel against device-memory bandwidth
    big = 1 << 16
    kb_ms, pb_ms = time_decode(main_c, big, True, iters=20)
    moved = big * (ps.PLANE_WORDS * main_c * 4 + 4 + ps.BLOCK * 4)
    print(f"  decode c={main_c} nb={big} rowids: kernel {kb_ms * 1e3:.1f} us "
          f"({moved / (kb_ms * 1e-3) / 1e9:.0f} GB/s of words, bases and "
          f"rowids), plain {pb_ms * 1e3:.1f} us")

    print(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "bitplane_decode", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
