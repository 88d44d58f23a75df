"""Host milliseconds of a distributed table's per-query preparation, its
plan left out, per query completed: the self time of the port's ``prep``
spans (``ShardedIndex._prep``: the route and the per-shard runtime fill;
its child ``plan`` excluded) over the window, over the window's queries."""
from perfbench.program_spans import per_query_ms, window


def read(ctx):
    t = window(ctx)
    if t is None or not t.count("prep"):
        return None
    return per_query_ms(ctx, t.self_ns("prep"))
