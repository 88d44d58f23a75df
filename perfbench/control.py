"""The control of the comparison: the reference in bfloat16, the precision
below the float32 that the configurations state, put in the program's
place and judged as a run judges the port.

    python3 -m perfbench.control --workload <cell> --seeds a,b,c
        [--requests 200] [--device cuda]

For each seed: the cell's corpus and measured stream, as a run makes them;
the requests a run checks (``check_requests`` drawn from the seed among
the first ``--requests``, the window's count); the bfloat16 answers
compared with the float32 reference's. Prints one JSON line: per seed the
numbers compared. The benchmark's runs never run it; ``correct`` has to
come out false on every seed.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

from . import check, spec


class Answer:
    """A reference answer in the shape of the port's ``SearchResult``."""

    def __init__(self, docids, weights, found):
        self.matches = [type("M", (), {"docid": d, "weight": w})()
                        for d, w in zip(docids, weights)]
        self.total_found, self.error = found, None


def readings(cell: spec.Cell, seed: int, n_requests: int, device: str,
             seconds: float) -> dict:
    import torch

    from .corpus import make_corpus
    from .reference import Reference

    traffic = cell.traffic
    qpr, limit = int(traffic["queries_per_request"]), int(traffic["limit"])
    corpus = make_corpus(cell.config, seed, device)
    n_req = math.ceil(traffic["stream_queries_per_second"] * seconds / qpr)
    stream = cell.generator().generate(traffic, corpus, seed, 0, n_req * qpr)
    requests = [stream[j:j + qpr] for j in range(0, n_requests * qpr, qpr)]
    picks = check.sample_requests(len(requests), [], seed,
                                  int(traffic["check_requests"]))
    ref = Reference(corpus)
    low = Reference(corpus, torch.bfloat16)

    # only the sampled requests are answered, and judged
    numbers = check.compare([requests[i] for i in picks],
                            [[Answer(*low.answer(q, limit))
                              for q in requests[i]] for i in picks],
                            list(range(len(picks))),
                            lambda q: ref.answer(q, limit),
                            qpr * len(picks), limit)
    return {name: v for name, (v, _lim, _k) in numbers.items()} | {
        "correct": check.passes(numbers)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    out = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        out[seed] = readings(cell, seed, args.requests, args.device,
                             bench["run_seconds"])
        print(f"seed {seed}: {out[seed]} ({time.perf_counter() - t0:.1f} s)",
              file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0 if not any(r["correct"] for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
