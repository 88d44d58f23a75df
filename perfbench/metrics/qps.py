"""Queries completed in the window over the window's seconds (first send
to last result on the host)."""


def read(ctx):
    return ctx.queries / ctx.window_s
