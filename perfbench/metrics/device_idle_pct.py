"""Share of the profiled slice in which no operation ran on the card, in
%, the mean over the table's cards."""


def read(ctx):
    sl = ctx.slice
    if sl is None or not sl.busy_s or not any(sl.busy_s.values()):
        return None
    busy = sum(sl.busy_s.values()) / len(sl.busy_s)
    return 100.0 * (1.0 - busy / sl.window_s)
