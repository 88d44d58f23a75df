"""Host waits on the card (``*Synchronize*`` and ``cudaMemcpy*`` runtime
calls) in the profiled slice over the slice's requests."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.waits:
        return None
    return sl.waits / sl.requests
