"""Host milliseconds issuing the eager search program per query completed:
the port's ``program`` spans (``SearchIndex._run_round`` and
``ShardedIndex.search_batch``, one per plan shape and part: the program's
launches and its output rows) over the window, over its queries."""
from perfbench.program_spans import per_query_ms, window


def read(ctx):
    t = window(ctx)
    if t is None or not t.count("program"):
        return None
    return per_query_ms(ctx, t.total_ns("program"))
