"""Host milliseconds in the planner per query completed: the port's
``plan_query`` spans (``query/planner.plan_query`` inside the table's
``plan``: dictionary lookups, the slot table, word statistics, the runtime
arrays) over the window, summed, over the window's queries."""
from perfbench.program_spans import per_query_ms, window


def read(ctx):
    t = window(ctx)
    if t is None or not t.count("plan"):
        return None
    return per_query_ms(ctx, t.total_ns("plan_query"))
