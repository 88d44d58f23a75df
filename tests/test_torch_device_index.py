"""Port parity: the device index upload.

The port's ``upload(from_jax_packed(packed), "cpu")`` against the JAX
package's ``upload(packed).data_pytree()`` on one seeded corpus that has
packed and residual terms and every attribute kind the upload handles
(uint, float, bigint, string, MVA): the same keys, shapes, dtypes and
values, including the over-padding, the uint32-as-int32 word views and
the docid hi/lo split. ``from_jax_arrays`` on the JAX leaves must give
identical tensors.

Tolerance: exact. Every leaf is an integer, bool or float32 array copied,
not computed.
"""
import numpy as np
import pytest
import torch

from manticoresearch_tpu.index.builder import IndexBuilder
from manticoresearch_tpu.ops.device_index import upload as jax_upload
from manticoresearch_tpu.ops.packed_store import PACK_MIN
from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.ops.device_index import (from_jax_arrays,
                                                        from_jax_packed,
                                                        upload, window)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def packed():
    rng = np.random.RandomState(3)
    words = [f"w{i}" for i in range(60)]
    docs = []
    for i in range(1, 401):
        body = " ".join(words[int(z) % 60] for z in rng.zipf(1.3, 12))
        docs.append(dict(
            id=1000 + 7 * i, title=words[i % 60], body=body,
            year=2000 + i % 9, score=float(rng.rand()),
            big=int(rng.randint(-2**40, 2**40)),
            color=["red", "Green", "blue"][i % 3],
            tags=sorted({int(x) for x in rng.randint(0, 50, i % 4)})))
    schema = Schema(fields=["title", "body"],
                    attrs=[AttrDef("year", AttrType.UINT),
                           AttrDef("score", AttrType.FLOAT),
                           AttrDef("big", AttrType.BIGINT),
                           AttrDef("color", AttrType.STRING),
                           AttrDef("tags", AttrType.MVA)])
    b = IndexBuilder(schema)
    b.add_documents(docs)
    p = b.build()
    assert p.term_docs.max() >= PACK_MIN        # some terms are packed
    assert (p.term_docs < PACK_MIN).any()       # some stay residual
    return p


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[(k, k2)] = v2
        else:
            out[(k,)] = v
    return out


def _assert_same(port_tree, jax_tree):
    pt, jt = _flat(port_tree), _flat(jax_tree)
    assert pt.keys() == jt.keys()
    for key, ref in jt.items():
        ref = np.asarray(ref)
        got = pt[key]
        assert isinstance(got, torch.Tensor), key
        assert got.device.type == "cpu", key
        assert tuple(got.shape) == ref.shape, key
        assert got.numpy().dtype == ref.dtype, key
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(key))


def test_upload_matches_jax_data_pytree(packed):
    dev = upload(from_jax_packed(packed), "cpu")
    assert dev.n_rows == packed.n_docs and dev.n_fields == 2
    _assert_same(dev.data_pytree(), jax_upload(packed).data_pytree())


def test_from_jax_arrays_is_identical(packed):
    tree = jax_upload(packed).data_pytree()
    host = {k: ({k2: np.asarray(v2) for k2, v2 in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}
    dev = from_jax_arrays(host, packed.n_docs, 2, "cpu")
    _assert_same(dev.data_pytree(), tree)


def test_window_is_full_length_or_raises():
    t = torch.arange(10)
    assert window(t, 6, 4).tolist() == [6, 7, 8, 9]
    with pytest.raises(ValueError):
        window(t, 7, 4)
