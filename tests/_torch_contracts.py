"""The segment-sum kernel's input contract, checked on the CPU.

On the card, ``ops.groupby.segment_sum_ordered`` takes group ids that are
nondecreasing and lie in ``[0, n_out)`` (``csrc/segment_sum.cu``): each
group is one run. The CPU tests reach only the plain version, which takes
any order, so ``sorted_ids_contract`` wraps the wrapper for a test module
and asserts the contract on every call that the port's own code makes
(the group-by tail and the factor scatters); a test that calls the
wrapper directly is not held to it.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from manticoresearch_tpu_torch.ops import groupby as port_groupby

_CALLERS = {str(Path(port_groupby.__file__).resolve()),
            str(Path(port_groupby.__file__).resolve().parent / "factors.py")}


def check_sorted_ids(gid: torch.Tensor, n_out: int) -> None:
    if gid.numel() == 0:
        return
    assert int(gid.min()) >= 0 and int(gid.max()) < n_out, (
        "segment sum ids outside [0, n_out)", int(gid.min()),
        int(gid.max()), n_out)
    assert bool((gid[1:] >= gid[:-1]).all()), \
        "segment sum ids not nondecreasing"


@pytest.fixture(autouse=True)
def sorted_ids_contract(monkeypatch):
    """Every call of ``segment_sum_ordered`` made by the port's group-by
    and factor code passes nondecreasing ids in ``[0, n_out)``; the count
    of checked calls is kept on the wrapper as ``checked``."""
    original = port_groupby.segment_sum_ordered
    checked = []

    def recording(values, gid, n_out):
        caller = str(Path(sys._getframe(1).f_code.co_filename).resolve())
        if caller in _CALLERS:
            check_sorted_ids(gid, n_out)
            checked.append(n_out)
        return original(values, gid, n_out)
    recording.checked = checked
    monkeypatch.setattr(port_groupby, "segment_sum_ordered", recording)
    yield recording
