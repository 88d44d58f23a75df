"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. Set-up
(timed as ``setup_s`` from the process's start): the corpus and the
request streams from ``--seed`` (``corpus.py``, the mix's generator), the
port's table built and uploaded (``systems/<table>.py``), the warm-up
requests (a stream of their own). The window: one client in a closed
loop, each request one ``search_batch`` of the mix's queries, ended by a
synchronize of every card of the table, for ``--seconds``. Then the check
(``check.py``) against the plain reference (``reference.py``), once the
device peak is read and the table freed.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics.
With ``--trace 1`` they are its per-layer metrics: the benchmark times the
table's planning entry and counts K1's bytes (``trace.Spans``), and runs
``torch.profiler`` over a slice of ``trace_requests`` requests that
starts a third of the way into the window (``trace.reduce_slice``).

It exits non-zero and prints no result where there is no card, or fewer
than the cell asks for, where the port is missing, and where JAX or the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from collections import Counter  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

from . import check, spec  # noqa: E402
from .trace import Spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "manticoresearch_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


@dataclass
class Context:
    """What the metric readers read (``metrics/<name>.py``)."""
    setup_s: float
    window_s: float
    queries: int
    requests: int
    latencies: list
    peak_bytes: list
    k1_window: int
    spans: Spans
    slice: object = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name starts with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _window(table, requests, seconds, trace, spans, profile_from,
            trace_requests):
    """The closed loop. -> (results, latencies, seconds, profiler slice
    events or None, the slice's first request)."""
    import torch
    results, lat = [], []
    prof, prof_at, events = None, None, None
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    # a slice that has begun runs to its end (a traced run's window may
    # outlast ``seconds``: it reports no end-to-end metric)
    while time.perf_counter() - t0 < seconds or prof is not None:
        if i >= len(requests):
            raise RuntimeError(f"the stream of {len(requests)} requests "
                               "ran out inside the window")
        if trace and prof is None and prof_at is None \
                and time.perf_counter() - t0 >= profile_from:
            act = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                act.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=act)
            prof.start()
            prof_at = i
            spans.recording_k1 = True
        ts = time.perf_counter()
        if trace:
            with torch.profiler.record_function("request"):
                rs = table.search_batch(requests[i])
                table.sync()
        else:
            rs = table.search_batch(requests[i])
            table.sync()
        t_end = time.perf_counter()
        results.append(rs)
        lat.append(t_end - ts)
        i += 1
        if prof is not None and i - prof_at >= trace_requests:
            prof.stop()
            spans.recording_k1 = False
            events = prof.events()
            prof = None
    return results, lat, t_end - t0, events, prof_at


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", base: Path = spec.ROOT) -> dict:
    """One run of ``cell``; -> the result line as a dict (``checked``
    last)."""
    import torch
    from manticoresearch_tpu_torch.ops import packed_store

    from .corpus import Corpus, make_corpus
    from .reference import Reference
    from .systems import to_port

    cfg, traffic = cell.config, cell.traffic
    qpr = int(traffic["queries_per_request"])
    limit = int(traffic["limit"])
    gen = cell.generator()
    corpus = make_corpus(cfg, seed, device)
    n_req = math.ceil(traffic["stream_queries_per_second"] * seconds / qpr)
    warm = gen.generate(traffic, corpus, seed, 1,
                        int(traffic["warmup_requests"]) * qpr)
    stream = gen.generate(traffic, corpus, seed, 0, n_req * qpr)
    requests = [stream[j:j + qpr] for j in range(0, len(stream), qpr)]
    # the table's memory alone: the corpus goes to the host first
    corpus = Corpus(corpus.tokens.cpu(), corpus.offsets.cpu(),
                    corpus.vocabulary, corpus.attrs, corpus.fields)
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.empty_cache()
        for d in range(cell.chips):
            torch.cuda.reset_peak_memory_stats(d)
    t_table = time.perf_counter()
    table = cell.system().build(cfg, corpus, device)
    port_reqs = [[to_port(q, limit) for q in r] for r in requests]
    t_warm = time.perf_counter()
    for j in range(0, len(warm), qpr):
        table.search_batch([to_port(q, limit) for q in warm[j:j + qpr]])
        table.sync()
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s:.1f} s: to the table {t_table - T_START:.1f} s, "
          f"table {t_warm - t_table:.1f} s, warm-up "
          f"{T_START + setup_s - t_warm:.1f} s", file=sys.stderr)
    gc.collect()     # set-up's garbage is not the window's

    spans = Spans()
    with spans.installed(table.points) if trace else nullcontext():
        packed_store.LAUNCHES.reset()
        results, lat, window_s, events, prof_at = _window(
            table, port_reqs, seconds, trace, spans, seconds / 3,
            int(traffic["trace_requests"]))
        k1_window = packed_store.LAUNCHES.kernel
    cards = sorted({torch.device(d).index or 0 for d in table.devices}) \
        if on_cuda else []
    peak = [torch.cuda.max_memory_allocated(d) for d in cards]
    n_done = len(results)
    sl = None
    if events is not None:
        from .trace import reduce_slice
        sl = reduce_slice(events, cards, int(traffic["trace_requests"]),
                          sum(len(r) for r in requests[
                              prof_at:prof_at + int(traffic["trace_requests"])]),
                          spans.k1_calls,
                          {"request"} | {n.rstrip("()") for _o, _a, n
                                         in table.points})
        del events
    ctx = Context(setup_s, window_s, sum(len(r) for r in results), n_done,
                  lat, peak, k1_window, spans, sl)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"], base)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    attempted = sum(len(r) for r in requests[:n_done])
    failed = sum(sum(1 for r in rs if r.error) + len(qs) - len(rs)
                 for qs, rs in zip(requests, results))
    # the check: the table freed, the reference on the first card
    del table, port_reqs
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    ref_dev = f"cuda:{cards[0]}" if on_cuda else device
    ref = Reference(Corpus(corpus.tokens.to(ref_dev),
                           corpus.offsets.to(ref_dev), corpus.vocabulary,
                           corpus.attrs, corpus.fields))
    picks = check.sample_requests(n_done, lat, seed,
                                  int(traffic["check_requests"]))
    t_check = time.perf_counter()
    numbers = check.compare(requests[:n_done], results, picks,
                            lambda q: ref.answer(q, limit),
                            qpr * len(picks), limit)
    check_s = time.perf_counter() - t_check

    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(cards[0]) if on_cuda else "cpu",
           "count": len(cards) if on_cuda else 1,
           "memory_peak_bytes": max(peak) if peak else 0}
    out = {"correct": check.passes(numbers), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if sl is not None:
        dev["busy_s"] = sum(sl.busy_s.values()) / max(len(sl.busy_s), 1)
        dev["window_s"] = sl.window_s
        out["breakdown"] = {"device_ops": sl.device_ops,
                            "idle_gaps": sl.idle_gaps}
    kinds = Counter(q.kind for r in requests[:n_done] for q in r)
    sent = [q for r in requests[:n_done] for q in r]
    print(f"window {window_s:.3f} s, {n_done} requests, {attempted} "
          f"queries {dict(kinds)}, {gen.repeated(warm, sent)} of them "
          f"repeat an earlier text and filter; request ms median "
          f"{statistics.median(lat) * 1e3:.1f} max {max(lat) * 1e3:.1f}; "
          f"check {check_s:.1f} s over {len(picks)} requests",
          file=sys.stderr)
    out["checked"] = {name: {"value": v, "limit": lim,
                             "kind": "at most" if kind == "max"
                             else "at least"}
                      for name, (v, lim, kind) in numbers.items()}
    out["_lines"] = check.lines(numbers)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(spec.ROOT / ".perfbench_cache" / sub)
    try:
        cell = spec.cell(spec.load(), args.workload)
        import torch
        # one client, one host thread: the port's host work is small
        # tensors and numpy, and idle pool threads only spread the timings
        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            print("no card: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except Exception:  # noqa: BLE001 -- any failure: no result, exit 1
        traceback.print_exc(file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    lines = out.pop("_lines")
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
