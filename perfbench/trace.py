"""What the traced run reads: spans and counters the benchmark puts around
the port's calls, and ``torch.profiler``'s events over a slice of the
window, reduced to the numbers the per-layer metrics and ``breakdown``
report.

The profiler arithmetic is a copy of ``chip_smoke.profile_batch`` and
``manticoresearch_tpu_torch.tools.multichip.busy_shares``: device time
from the CUDA events by the card's index, kernel launches from the
``cudaLaunchKernel`` runtime calls, host waits from ``*Synchronize*`` and
``cudaMemcpy*``. Two changes: busy time is the union of a card's event
intervals (the original sums durations, which counts overlapping copies
twice), and the slice is bounded by the benchmark's own ``request`` spans.
The K1 byte count (``k1_bytes``) replaces ``PERF.md``'s bytes of isolated
posting lists with the bytes of each launch the window makes.
"""
from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

K1_KERNEL = "bitplane_decode_grouped"
HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet, at 700 W


def k1_bytes(items: list) -> int:
    """The least bytes one grouped decode moves: each window's bit-plane
    words (int32 [nb, 4c]) and block bases (int32 [nb], rowid windows)
    read once, its address-table row (4 int64) read once, its decoded
    values (int32 [nb, 128]) written once. Windows of no block are not
    sent to the kernel."""
    total = 0
    for words, base, _c in items:
        nb = int(words.shape[0])
        if nb == 0:
            continue
        total += words.numel() * 4 + nb * 128 * 4 + 32
        if base is not None:
            total += nb * 4
    return total


@dataclass
class Spans:
    """The benchmark's own spans and counters around the port's calls."""
    plan_s: float = 0.0
    plan_calls: int = 0
    k1_calls: list = field(default_factory=list)   # (device, bytes)
    recording_k1: bool = False

    @contextmanager
    def installed(self, points: list):
        """While inside: a profiler span around each call of the port's
        ``points`` ((owner, attribute, span name); a name ending in ``()``
        wraps the callables that the attribute returns), the host time of
        the ``plan`` spans summed, and the bytes of every K1 launch
        recorded while ``recording_k1``."""
        import torch
        from manticoresearch_tpu_torch.ops import packed_store
        saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _n
                 in points]
        decode = packed_store.decode_grouped
        spans = self

        def spanned(fn, name):
            def call(*args, **kwargs):
                with torch.profiler.record_function(name):
                    if name != "plan":
                        return fn(*args, **kwargs)
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        spans.plan_s += time.perf_counter() - t0
                        spans.plan_calls += 1
            return call

        def factory(fn, name):
            def make(*args, **kwargs):
                return spanned(fn(*args, **kwargs), name)
            return make

        def counted(items):
            out = decode(items)
            if spans.recording_k1 and items and items[0][0].is_cuda:
                spans.k1_calls.append((items[0][0].device, k1_bytes(items)))
            return out

        try:
            for (owner, attr, fn), (_o, _a, name) in zip(saved, points):
                setattr(owner, attr, factory(fn, name[:-2])
                        if name.endswith("()") else spanned(fn, name))
            packed_store.decode_grouped = counted
            yield self
        finally:
            packed_store.decode_grouped = decode
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)


@dataclass
class Slice:
    """The profiled slice, reduced."""
    requests: int
    queries: int
    window_s: float                 # first request's start to last's end
    busy_s: dict                    # card index -> seconds
    launches: int
    waits: int
    k1_time_s: float
    k1_events: int
    k1_launches: int
    k1_bytes: int
    device_ops: list                # [name, seconds] averaged over cards
    idle_gaps: list                 # [host op, seconds] averaged over cards


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(cpu: list, points: list) -> list:
    """For each time point (ascending), the name of the innermost host
    event spanning it (nested events: a stack sweep), else "none"."""
    cpu = sorted(cpu, key=lambda e: (e[0], -e[1]))
    names, stack, j = [], [], 0
    for m in points:
        while j < len(cpu) and cpu[j][0] <= m:
            while stack and stack[-1][1] < cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        names.append(stack[-1][2] if stack else "none")
    return names


def reduce_slice(events, cards: list, requests: int, queries: int,
                 k1_calls: list, span_names: set) -> Slice:
    """Reduce a profiler's events over the slice of ``requests`` requests
    (``queries`` queries) that ``request`` spans bound; ``cards`` are the
    device indexes of the table's cards; ``k1_calls`` the (device, bytes)
    of the slice's K1 launches as the wrapper recorded them;
    ``span_names`` the names of the benchmark's spans."""
    from torch.autograd import DeviceType
    req = [e for e in events if e.name == "request"
           and e.device_type == DeviceType.CPU]
    t0 = min(e.time_range.start for e in req)
    t1 = max(e.time_range.end for e in req)
    wall_us = t1 - t0
    # the benchmark's spans also show on the device's timeline (user
    # annotations): they are no device work
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA
              and e.device_index in cards and e.name not in span_names
              and not getattr(e, "is_user_annotation", False)]
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CPU]
    busy, by_op, gaps = {}, Counter(), Counter()
    for c in cards:
        spans = []
        for e in on_dev:
            if e.device_index != c:
                continue
            s, t = max(e.time_range.start, t0), min(e.time_range.end, t1)
            if t > s:
                spans.append((s, t))
                by_op[e.name] += t - s
        merged = _union(spans)
        busy[c] = sum(t - s for s, t in merged) / 1e6
        edges = [t0] + [x for st in merged for x in st] + [t1]
        holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
        mids = [(s + t) / 2 for s, t in holes]
        for (s, t), name in zip(holes, _innermost(cpu, mids)):
            gaps[name] += t - s
    k1 = [e for e in on_dev if K1_KERNEL in e.name]
    n = max(len(cards), 1)
    return Slice(
        requests=requests, queries=queries, window_s=wall_us / 1e6,
        busy_s=busy,
        launches=sum(1 for e in events
                     if e.name.startswith(("cudaLaunchKernel",
                                           "cuLaunchKernel"))),
        waits=sum(1 for e in events if "Synchronize" in e.name
                  or e.name.startswith("cudaMemcpy")),
        k1_time_s=sum(e.time_range.elapsed_us() for e in k1) / 1e6,
        k1_events=len(k1), k1_launches=len(k1_calls),
        k1_bytes=sum(b for _d, b in k1_calls),
        device_ops=[[name[:120], us / n / 1e6]
                    for name, us in by_op.most_common(10)],
        idle_gaps=[[name[:120], us / n / 1e6]
                   for name, us in gaps.most_common(10)])
