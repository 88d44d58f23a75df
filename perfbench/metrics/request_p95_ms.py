"""The 95th percentile of every request's latency in the window, from its
send to its last result on the host, in milliseconds (Python's
``statistics.quantiles``, inclusive)."""
import statistics


def read(ctx):
    if len(ctx.latencies) < 2:
        return None
    return statistics.quantiles(ctx.latencies, n=100,
                                method="inclusive")[94] * 1e3
