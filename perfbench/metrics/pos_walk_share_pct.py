"""Share of the window's phrase and proximity nodes that ran in the
positional walk kernel, in %: 100 x ``pos_walk`` / (``pos_walk`` +
``pos_eager``), the port's counters in the search program
(``ops/search.py``: one per positional node of a program, ``pos_walk``
where it ran in csrc/pos_walk.cu, ``pos_eager`` where it took the eager
``_eval_phrase_node``)."""
from perfbench.program_spans import window


def read(ctx):
    t = window(ctx)
    if t is None:
        return None
    walk = t.counters.get("pos_walk", 0)
    nodes = walk + t.counters.get("pos_eager", 0)
    return 100.0 * walk / nodes if nodes else None
