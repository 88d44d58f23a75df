"""The port's own spans and counters over the window, for the readers of
``program_span`` and ``program_counter`` metrics.

The port records one trace record per request
(``manticoresearch_tpu_torch.utils.trace``): its spans
``(name, start_ns, end_ns, parent)`` and counters. After the window nothing
calls the port's search until the readers have run, so the last
``ctx.requests`` records are the window's requests. ``window(ctx)`` sums
them (``trace.totals``), or gives None where the port has no trace module
or the records do not match the window's requests and queries.
"""
from __future__ import annotations


def window(ctx):
    """``trace.totals`` of the window's records, or None."""
    try:
        from manticoresearch_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx.requests or not ctx.queries:
        return None
    recs = trace.last(ctx.requests)
    if (len(recs) != ctx.requests
            or sum(r.queries for r in recs) != ctx.queries):
        return None
    return trace.totals(recs)


def per_query_ms(ctx, total_ns: int) -> float:
    return total_ns / 1e6 / ctx.queries


def per_request_ms(ctx, total_ns: int) -> float:
    return total_ns / 1e6 / ctx.requests
