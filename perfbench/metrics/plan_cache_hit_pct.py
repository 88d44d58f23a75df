"""Share of the window's plans that the plan cache answered, in %: 100 x
``plan_cache_hit`` / (``plan_cache_hit`` + ``plan_cache_miss``), the port's
counters in ``SearchIndex.plan`` (``exec/searcher.py``)."""
from perfbench.program_spans import window


def read(ctx):
    t = window(ctx)
    if t is None:
        return None
    hit = t.counters.get("plan_cache_hit", 0)
    plans = hit + t.counters.get("plan_cache_miss", 0)
    return 100.0 * hit / plans if plans else None
