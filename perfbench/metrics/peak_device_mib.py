"""``torch.cuda.max_memory_allocated`` of each card of the table after
set-up and window, summed, in MiB."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return sum(ctx.peak_bytes) / 2 ** 20
