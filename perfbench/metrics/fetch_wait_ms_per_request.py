"""Host milliseconds per request blocked in the one fetch of the request's
output rows (the port's ``fetch`` spans: ``torch.cat(...).cpu()``, which
waits until the card has drained): the device work that the host's issue
did not hide, over the window's requests."""
from perfbench.program_spans import per_request_ms, window


def read(ctx):
    t = window(ctx)
    if t is None or not t.count("fetch"):
        return None
    return per_request_ms(ctx, t.total_ns("fetch"))
