"""Port parity: the bit-plane decode of the packed posting store.

``decode_words`` / ``decode_rowids`` of the port (their plain PyTorch
version, which the wrappers take for CPU tensors) against the JAX
package's XLA decode (``manticoresearch_tpu/ops/packed_store.py``), for
every width class, on seeded random words with bit 31 set so the uint32
bits held in int32 are exercised, and random bases so the int32 prefix
sum wraps. ``decode_grouped`` (one call for many windows, the kernel's
entry point) must equal the one-window plain decodes concatenated.

Tolerance: exact. The results are integers and bit patterns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manticoresearch_tpu.ops import packed_store as jax_ps
from manticoresearch_tpu_torch.ops import packed_store as ps

torch.set_num_threads(2)


def _inputs(c, nb, seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2**32, (nb, ps.PLANE_WORDS * c), dtype=np.uint64)
    words = (words | (1 << 31)).astype(np.uint32).view(np.int32)
    base = rng.randint(-2**31, 2**31, nb, dtype=np.int64).astype(np.int32)
    return words, base


def test_reexports_match_jax_layout():
    assert (ps.BLOCK, ps.PLANE_WORDS, ps.CLASSES, ps.PACK_MIN) == (
        jax_ps.BLOCK, jax_ps.PLANE_WORDS, jax_ps.CLASSES, jax_ps.PACK_MIN)


@pytest.mark.parametrize("c", [4, 8, 16, 32])
@pytest.mark.parametrize("nb", [1, 7, 33])
def test_decode_words_and_rowids_match_jax(c, nb):
    words, base = _inputs(c, nb, seed=c * 100 + nb)
    want_w = np.asarray(jax_ps.decode_words(jnp.asarray(words), c))
    want_r = np.asarray(jax_ps.decode_rowids(jnp.asarray(words),
                                             jnp.asarray(base), c))
    before = ps.LAUNCHES.plain
    got_w = ps.decode_words(torch.from_numpy(words), c)
    got_r = ps.decode_rowids(torch.from_numpy(words), torch.from_numpy(base),
                             c)
    assert ps.LAUNCHES.plain == before + 2   # CPU tensors: plain path
    assert got_w.dtype == got_r.dtype == torch.int32
    assert got_w.shape == (nb, ps.BLOCK) and got_r.shape == (nb * ps.BLOCK,)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    np.testing.assert_array_equal(got_r.numpy(), want_r)


def test_decode_refuses_other_devices():
    words = torch.zeros((1, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ps.decode_words(words, 4)


def test_decode_grouped_equals_one_window_decodes():
    """Mixed classes, prefix on and off, nb = 1 and more, in one call."""
    items = []
    for i, (c, nb, prefix) in enumerate([
            (16, 1, True), (4, 3, False), (32, 1, False), (8, 5, True),
            (16, 2, False), (4, 1, True), (32, 4, True), (8, 1, False)]):
        words, base = _inputs(c, nb, seed=1000 + i)
        items.append((torch.from_numpy(words),
                      torch.from_numpy(base) if prefix else None, c))
    before = ps.LAUNCHES.plain
    out, offsets = ps.decode_grouped(items)
    assert ps.LAUNCHES.plain == before + 1      # one call, however many
    want = [ps.decode_words_ref(w, c) if b is None
            else ps.decode_rowids_ref(w, b, c).reshape(-1, ps.BLOCK)
            for w, b, c in items]
    assert out.dtype == torch.int32 and out.shape == (
        sum(w.shape[0] for w, _, _ in items), ps.BLOCK)
    assert offsets.tolist() == np.cumsum(
        [0] + [w.shape[0] for w, _, _ in items]).tolist()
    for i, ref in enumerate(want):
        np.testing.assert_array_equal(
            out[offsets[i]:offsets[i + 1]].numpy(), ref.numpy())
    np.testing.assert_array_equal(out.numpy(), torch.cat(want).numpy())


def test_decode_grouped_refuses_bad_windows():
    words = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        ps.decode_grouped([])
    with pytest.raises(ValueError):
        ps.decode_grouped([(words, None, 8)])            # 16 words: c=4
    with pytest.raises(ValueError):
        ps.decode_grouped([(words, torch.zeros(3, dtype=torch.int32), 4)])
    with pytest.raises(ValueError):
        ps.decode_grouped([(words, None, 4),
                           (words.to("meta"), None, 4)])  # mixed devices
