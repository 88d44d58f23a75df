"""Share of the window's hit-stream ranker programs that ranked by the LCS
walk kernel, in %: 100 x ``lcs_walk`` / (``lcs_walk`` + ``lcs_eager``),
the port's counters in the search program (``ops/search.py``: one per
program whose ranker reads the hit stream, ``lcs_walk`` where it launched
csrc/lcs_walk.cu, ``lcs_eager`` where it took the eager hit stream)."""
from perfbench.program_spans import window


def read(ctx):
    t = window(ctx)
    if t is None:
        return None
    walk = t.counters.get("lcs_walk", 0)
    progs = walk + t.counters.get("lcs_eager", 0)
    return 100.0 * walk / progs if progs else None
