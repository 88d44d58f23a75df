"""Launches of the bit-plane decode kernel K1 (``packed_store.LAUNCHES``,
every card) over the window, per request."""


def read(ctx):
    if not ctx.k1_window or not ctx.requests:
        return None
    return ctx.k1_window / ctx.requests
