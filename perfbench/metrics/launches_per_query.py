"""Kernel launches (``cudaLaunchKernel`` runtime calls) in the profiled
slice over the slice's queries."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.launches:
        return None
    return sl.launches / sl.queries
