"""The comparison that decides ``correct``.

After the window, a sample of the window's requests, drawn from the seed,
with the slowest request added, is answered again by the plain reference
(``reference.py``), and each query's top documents, their weights and its
``found`` total are compared with what the timed path returned for it.
Every number compared has its limit: each count of differing queries 0
(the answers are exact), the queries that returned an error or no result
0, and the queries compared at least ``min_checked``.
"""
from __future__ import annotations

import numpy as np


def sample_requests(n_done: int, latencies: list, seed: int,
                    n_sample: int) -> list[int]:
    """``n_sample`` request indexes drawn from the seed, plus the slowest."""
    rng = np.random.default_rng([int(seed), 2])
    pick = rng.choice(n_done, min(n_sample, n_done), replace=False).tolist()
    slowest = int(np.argmax(latencies)) if latencies else 0
    return sorted(set(pick) | ({slowest} if n_done else set()))


def compare(requests: list, results: list, picks: list[int], answer,
            min_checked: int, limit: int) -> dict:
    """-> {name: (value, limit, "max" | "min")}. ``requests[i]`` holds the
    generator's queries and ``results[i]`` the port's results of request
    i; ``answer(query)`` is the reference's (docids, weights, found)."""
    errors = sum(1 for qs, rs in zip(requests, results)
                 if rs is None or len(rs) != len(qs)
                 or any(r.error for r in rs))
    docids = weights = found = checked = 0
    for i in picks:
        for q, r in zip(requests[i], results[i] or []):
            want = answer(q)
            got = ([m.docid for m in r.matches][:limit],
                   [m.weight for m in r.matches][:limit], r.total_found)
            checked += 1
            docids += got[0] != want[0]
            weights += got[1] != want[1]
            found += got[2] != want[2]
    return {"errors": (errors, 0, "max"),
            "docids_differ": (docids, 0, "max"),
            "weights_differ": (weights, 0, "max"),
            "found_differ": (found, 0, "max"),
            "queries_checked": (checked, min_checked, "min")}


def passes(numbers: dict) -> bool:
    return all(v <= lim if kind == "max" else v >= lim
               for v, lim, kind in numbers.values())


def lines(numbers: dict) -> list[str]:
    return [f"{name} {v} ({'at most' if kind == 'max' else 'at least'} "
            f"{lim})" for name, (v, lim, kind) in numbers.items()]
