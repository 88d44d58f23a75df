"""Device-resident index tensors (one shard) and their upload.

Counterpart of ``manticoresearch_tpu/ops/device_index.py``: the same arrays
under the same keys as its ``DeviceIndex.data_pytree()``, with the same
over-padding, the same uint32-as-int32 views of the packed words and the
same docid hi/lo split, as torch tensors on an explicit device.

The padding matters more here than in JAX: ``lax.dynamic_slice`` clamps a
window that runs past the array end, while a torch slice silently comes
back short. Padding every posting and hit array by the planner's largest
slot bucket (``planner._next_pow4``) keeps every slot window full length,
and ``window`` checks that it is.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..index.builder import PackedIndex
from ..query.planner import _next_pow4
from ..schema import AttrDef, AttrType, Schema
from ..text.dictionary import DictSettings
from ..text.tokenizer import TokenizerSettings
from .packed_store import BLOCK, CLASSES, PLANE_WORDS

_DICT_KEYS = ("attrs", "attr_perm", "mva_offsets", "mva_values")


@dataclass
class DeviceIndex:
    """Tensors of one shard, all on ``device``. Row ``n_rows`` is the pad
    sink: ``alive[n_rows]`` is always False."""

    n_rows: int
    n_fields: int
    device: torch.device
    packed: dict[str, torch.Tensor]   # pkrw_w_{c}/pkrw_b_{c}/pktf_w_{c}/pkfm_w_{c}
    res_rowid: torch.Tensor           # i32[Pres + pad] short-tail raw postings
    res_tfq: torch.Tensor             # f32
    res_fieldmask: torch.Tensor       # i32
    hit_packed: torch.Tensor          # i32[H + pad] Hitman packing incl. end flag
    hit_rowid: torch.Tensor           # i32[H + pad]
    sent_rowid: torch.Tensor
    sent_pkey: torch.Tensor
    para_rowid: torch.Tensor
    para_pkey: torch.Tensor
    alive: torch.Tensor               # bool[N + 1]
    field_lens: torch.Tensor          # i32[N + 1, F]
    docid_hi: torch.Tensor            # i32[N + 1]
    docid_lo: torch.Tensor            # i32[N + 1], biased by -2^31
    attrs: dict[str, torch.Tensor]
    attr_perm: dict[str, torch.Tensor]
    mva_offsets: dict[str, torch.Tensor]
    mva_values: dict[str, torch.Tensor]

    def data_pytree(self) -> dict:
        """The tensors under the keys of the JAX ``data_pytree()``."""
        return {
            **self.packed,
            "res_rowid": self.res_rowid,
            "res_tfq": self.res_tfq,
            "res_fieldmask": self.res_fieldmask,
            "hit_packed": self.hit_packed,
            "hit_rowid": self.hit_rowid,
            "sent_rowid": self.sent_rowid,
            "sent_pkey": self.sent_pkey,
            "para_rowid": self.para_rowid,
            "para_pkey": self.para_pkey,
            "alive": self.alive,
            "field_lens": self.field_lens,
            "docid_hi": self.docid_hi,
            "docid_lo": self.docid_lo,
            "attrs": self.attrs,
            "attr_perm": self.attr_perm,
            "mva_offsets": self.mva_offsets,
            "mva_values": self.mva_values,
        }


def window(t: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``t[start:start + size]`` along dim 0, which must be full length
    (the upload's over-padding guarantees it for every slot window)."""
    if start < 0 or start + size > t.shape[0]:
        raise ValueError(f"window [{start}, {start + size}) runs past an "
                         f"array of {t.shape[0]} rows: padding too small")
    return t.narrow(0, start, size)


def _pad_breaks(arr: np.ndarray) -> np.ndarray:
    """Boundary arrays padded to >=1 with a +inf-like row so searches miss."""
    if len(arr):
        return arr.astype(np.int32)
    return np.full(1, 2**31 - 1, np.int32)


def _padp(arr: np.ndarray, val, pad: int) -> np.ndarray:
    return np.concatenate([arr, np.full(pad, val, arr.dtype)])


def host_arrays(packed: PackedIndex) -> dict:
    """numpy arrays in the layout of the JAX ``data_pytree()``."""
    n = packed.n_docs
    alive = np.ones(n + 1, dtype=bool)
    alive[n] = False

    attrs: dict[str, np.ndarray] = {}
    for name, arr in packed.attrs_int.items():
        attrs[name] = arr.astype(np.int32)
    for name, arr in packed.attrs_float.items():
        attrs[name] = arr.astype(np.float32)
    for name, arr in packed.attrs_big.items():
        attrs[name] = np.clip(arr, -(2**31), 2**31 - 1).astype(np.int32)
        a64 = arr.astype(np.int64)
        attrs[name + "#hi"] = (a64 >> 32).astype(np.int32)
        attrs[name + "#lo"] = ((a64 & 0xFFFFFFFF) - (1 << 31)).astype(
            np.int32)
    for name in packed.attrs_str:
        attrs[name] = packed.str_ordinals(name)[2]
        attrs[name + "\x00ci"] = packed.str_ordinals(name, ci=True)[2]

    mva_off = {}
    mva_val = {}
    for name, (off, vals) in packed.attrs_mva.items():
        mva_off[name] = off.astype(np.int32)
        mva_val[name] = np.clip(vals, -(2**31), 2**31 - 1).astype(np.int32)

    # over-pad posting/hit arrays by the planner's largest slot bucket
    max_df = int(packed.term_docs.max()) if packed.n_terms else 0
    pad_p = _next_pow4(max_df, 1024)
    max_th = 0
    if packed.n_terms:
        per_term_hits = (packed.post_hit_offset[packed.term_offsets[1:]]
                         - packed.post_hit_offset[packed.term_offsets[:-1]])
        max_th = int(per_term_hits.max()) if len(per_term_hits) else 0
    pad_h = _next_pow4(max_th, 1024)

    store = packed.packed_store()
    pad_nb = pad_p // BLOCK          # worst-case slot block window
    tree: dict = {}
    for c in CLASSES:
        empty = np.zeros((0, PLANE_WORDS * c), np.uint32)
        padrows = np.zeros((pad_nb, PLANE_WORDS * c), np.uint32)
        b = store.rw_base.get(c, np.zeros(0, np.int32))
        tree[f"pkrw_w_{c}"] = np.concatenate(
            [store.rw_words.get(c, empty), padrows]).view(np.int32)
        tree[f"pkrw_b_{c}"] = _padp(b.astype(np.int32), n, pad_nb)
        tree[f"pktf_w_{c}"] = np.concatenate(
            [store.tf_words.get(c, empty), padrows]).view(np.int32)
        tree[f"pkfm_w_{c}"] = np.concatenate(
            [store.fm_words.get(c, empty), padrows]).view(np.int32)
    tree["res_rowid"] = _padp(store.res_rowid, n, pad_p)   # pad rows -> sink N
    tree["res_tfq"] = _padp(store.res_tfq, 0, pad_p)
    if store.res_fieldmask.ndim == 2:
        tree["res_fieldmask"] = np.concatenate(
            [store.res_fieldmask,
             np.zeros((pad_p, store.res_fieldmask.shape[1]), np.int32)])
    else:
        tree["res_fieldmask"] = _padp(store.res_fieldmask, 0, pad_p)

    hit_rowid = np.repeat(packed.post_rowid, packed.post_tf).astype(np.int32)
    tree["hit_packed"] = _padp(packed.hit_packed, 0, pad_h)
    tree["hit_rowid"] = _padp(hit_rowid, n, pad_h)
    tree["sent_rowid"] = _pad_breaks(packed.sent_rowid)
    tree["sent_pkey"] = _pad_breaks(packed.sent_pkey)
    tree["para_rowid"] = _pad_breaks(packed.para_rowid)
    tree["para_pkey"] = _pad_breaks(packed.para_pkey)
    tree["alive"] = alive

    fl = np.zeros((n + 1, max(packed.schema.n_fields, 1)), np.int32)
    if packed.field_lens.size:
        fl[:n, : packed.field_lens.shape[1]] = packed.field_lens
    tree["field_lens"] = fl

    # pad row sorts last on ties; (hi, biased lo) compares like uint64 ids
    did = np.append(packed.doc_ids, 2**63 - 1).astype(np.uint64)
    tree["docid_hi"] = (did >> np.uint64(32)).astype(np.int64).astype(np.int32)
    tree["docid_lo"] = ((did & np.uint64(0xFFFFFFFF)).astype(np.int64)
                        - 2**31).astype(np.int32)
    tree["attrs"] = attrs

    # secondary indexes: rowid permutations per numeric attr
    perm_len = 1024
    while perm_len < n + 1:
        perm_len <<= 1
    attr_perm = {}
    for name in (list(packed.attrs_int) + list(packed.attrs_float)
                 + list(packed.attrs_big)):
        _, perm = packed.attr_index(name)
        attr_perm[name] = _padp(perm.astype(np.int32), n, perm_len - n)
    tree["attr_perm"] = attr_perm
    tree["mva_offsets"] = mva_off
    tree["mva_values"] = mva_val
    return tree


def from_jax_arrays(tree: dict, n_rows: int, n_fields: int,
                    device) -> DeviceIndex:
    """Build the port's DeviceIndex from arrays in the layout of the JAX
    ``DeviceIndex.data_pytree()`` (each leaf a numpy array), so both
    packages can run on identical data."""
    device = torch.device(device)

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a)).to(device)   # owned copy

    flat = {k: put(v) for k, v in tree.items() if k not in _DICT_KEYS}
    dicts = {k: {name: put(v) for name, v in tree[k].items()}
             for k in _DICT_KEYS}
    return DeviceIndex(
        n_rows=n_rows, n_fields=n_fields, device=device,
        packed={k: v for k, v in flat.items() if k.startswith("pk")},
        res_rowid=flat["res_rowid"], res_tfq=flat["res_tfq"],
        res_fieldmask=flat["res_fieldmask"],
        hit_packed=flat["hit_packed"], hit_rowid=flat["hit_rowid"],
        sent_rowid=flat["sent_rowid"], sent_pkey=flat["sent_pkey"],
        para_rowid=flat["para_rowid"], para_pkey=flat["para_pkey"],
        alive=flat["alive"], field_lens=flat["field_lens"],
        docid_hi=flat["docid_hi"], docid_lo=flat["docid_lo"],
        **dicts)


def upload(packed: PackedIndex, device) -> DeviceIndex:
    """Upload a PackedIndex to ``device`` (counterpart of the JAX
    ``device_index.upload``)."""
    return from_jax_arrays(host_arrays(packed), packed.n_docs,
                           packed.schema.n_fields, device)


def from_jax_packed(jax_packed) -> PackedIndex:
    """The port's PackedIndex from the JAX package's (every array, list and
    setting copied; the schema and settings rebuilt as the port's own
    classes), so that both packages can run on identical data without the
    port's code meeting a class of the JAX package."""
    js = jax_packed.schema
    schema = Schema(fields=list(js.fields),
                    attrs=[AttrDef(a.name, AttrType(a.type.value))
                           for a in js.attrs])

    def settings(cls, src):
        return cls(**{f.name: copy.deepcopy(getattr(src, f.name))
                      for f in fields(cls)})

    kw = {}
    for f in fields(PackedIndex):
        src = getattr(jax_packed, f.name)
        if f.name == "schema":
            kw[f.name] = schema
        elif f.name == "tokenizer_settings":
            kw[f.name] = settings(TokenizerSettings, src)
        elif f.name == "dict_settings":
            kw[f.name] = settings(DictSettings, src)
        else:
            kw[f.name] = copy.deepcopy(src)
    return PackedIndex(**kw)
