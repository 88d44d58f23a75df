"""The reader of ``pos_walk_share_pct`` (``perfbench/metrics/
pos_walk_share_pct.py``) on hand-built trace records: 100 x ``pos_walk`` /
(``pos_walk`` + ``pos_eager``) over the window, and None where the window
ran no positional node (term queries alone, or a port that counts
neither) or where its records do not match the window."""
from __future__ import annotations

from collections import deque

import pytest

from manticoresearch_tpu_torch.utils import trace
from perfbench import spec
from perfbench.tests.test_trace_metrics import _ctx, _plain, _sharded

READ = spec.reader("pos_walk_share_pct")


@pytest.fixture
def ring(monkeypatch):
    """The trace's ring, emptied for the test; -> a function that fills
    it."""
    monkeypatch.setattr(trace, "_done", deque(maxlen=trace.KEEP))

    def fill(records):
        trace._done.extend(records)
    return fill


def _ranked(walk: int, eager: int, sharded: bool = False):
    """A 2-query request whose programs ran ``walk`` positional nodes in
    the positional walk kernel and ``eager`` in the eager node."""
    r = _sharded() if sharded else _plain(False)
    r.counters.update({k: n for k, n in (("pos_walk", walk),
                                         ("pos_eager", eager)) if n})
    return r


@pytest.mark.parametrize("walk,eager,sharded,want", [
    ((2, 2), (0, 0), False, 100.0),   # every positional node walked
    ((8, 8), (0, 0), True, 100.0),    # each shard's programs too
    ((2, 1), (0, 1), False, 75.0),
    ((1, 0), (0, 3), False, 25.0),
    ((0, 0), (2, 1), False, 0.0),     # none did: the eager node
    ((0, 0), (0, 0), False, None),    # no positional node (term queries)
    ((0, 0), (0, 0), True, None),
])
def test_value(walk, eager, sharded, want, ring):
    # an older request before the window does not count
    ring([_ranked(0, 5)] + [_ranked(w, e, sharded)
                            for w, e in zip(walk, eager)])
    got = READ(_ctx())
    assert got == (want if want is None else pytest.approx(want, rel=1e-12))


@pytest.mark.parametrize("fault", ["no_counters", "short", "queries_differ",
                                   "empty", "no_requests"])
def test_none(fault, ring):
    """Absent: a port that counts neither (one older than the kernel), a
    window request without its record, records whose queries disagree,
    no records, no requests."""
    records = [_ranked(2, 0), _ranked(1, 1)]
    ctx = _ctx()
    if fault == "no_counters":
        ring([_plain(False), _plain(True)])
    elif fault == "short":
        ring(records[1:])
    elif fault == "queries_differ":
        ring(records)
        ctx = _ctx(queries=5)
    elif fault == "empty":
        ring([])
    else:
        ring(records)
        ctx = _ctx(requests=0, queries=0)
    assert READ(ctx) is None


def test_none_without_the_trace_module(monkeypatch):
    """A port with no ``utils.trace`` at all reads None, and does not
    raise."""
    import builtins
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "manticoresearch_tpu_torch.utils" and "trace" in (
                fromlist or ()):
            raise ImportError("no trace module")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert READ(_ctx()) is None
