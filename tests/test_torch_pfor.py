"""Port parity: decode of a whole bit-packed rowid list.

The JAX package's ``decode_packed`` runs its Pallas kernel in interpret
mode on the CPU (as tests/test_pfor.py runs it); the port's
``decode_packed(device="cpu")`` runs the plain PyTorch version of the CUDA
kernel. Both get the dict that ``pack_rowids`` makes from the same seeded
numpy rowids.

Tolerance: exact. Rowids are integers; any difference is a decode fault.
"""
import numpy as np
import pytest
import torch

from manticoresearch_tpu.ops.pfor import decode_packed as jax_decode_packed
from manticoresearch_tpu.ops.pfor import pack_rowids
from manticoresearch_tpu_torch.ops import packed_store as ps
from manticoresearch_tpu_torch.ops.pfor import decode_packed

torch.set_num_threads(2)


@pytest.mark.parametrize("n,maxgap", [
    (5, 3), (128, 10), (129, 1), (1000, 1), (4096, 50000), (10000, 7),
    (1, 0), (127, 100),
])
def test_decode_packed_matches_jax(n, maxgap):
    rng = np.random.RandomState(n)
    rows = np.cumsum(rng.randint(0, maxgap + 1, n)).astype(np.int64)
    packed = pack_rowids(rows)
    want = np.asarray(jax_decode_packed(packed))
    before = ps.LAUNCHES.plain
    got = decode_packed(packed, "cpu")
    assert ps.LAUNCHES.plain == before + 1   # every class in one decode
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), rows)


def test_decode_packed_empty():
    packed = pack_rowids(np.zeros(0, np.int64))
    want = np.asarray(jax_decode_packed(packed))
    got = decode_packed(packed, "cpu")
    assert got.shape == (0,) and want.shape == (0,)
