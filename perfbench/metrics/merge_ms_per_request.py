"""Host milliseconds per request in a distributed table's prelude, gather
and merge: the port's ``prelude`` (per plan shape and part) and ``merge``
(the copy to the first card and the merge there) spans of
``ShardedIndex.search_batch`` over the window, over its requests."""
from perfbench.program_spans import per_request_ms, window


def read(ctx):
    t = window(ctx)
    if t is None or not t.count("merge"):
        return None
    return per_request_ms(ctx, t.total_ns("prelude") + t.total_ns("merge"))
