"""Host milliseconds in the query parser per query completed: the port's
``parse`` spans (``FtQueryParser.parse`` inside the table's ``plan``) over
the window, summed, over the window's queries. A plan-cache hit parses
nothing and adds 0."""
from perfbench.program_spans import per_query_ms, window


def read(ctx):
    t = window(ctx)
    if t is None or not t.count("plan"):
        return None
    return per_query_ms(ctx, t.total_ns("parse"))
