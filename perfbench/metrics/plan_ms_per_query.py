"""Host milliseconds in the table's planning entry (``SearchIndex.plan``,
``ShardedIndex.plan``) over the window, per query completed."""


def read(ctx):
    if not ctx.spans.plan_calls or not ctx.queries:
        return None
    return ctx.spans.plan_s * 1e3 / ctx.queries
