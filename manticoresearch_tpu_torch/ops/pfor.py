"""Decode of a whole bit-packed rowid list.

Counterpart of ``manticoresearch_tpu/ops/pfor.py:decode_packed``: it takes
the dict that the JAX package's ``pack_rowids`` returns (width-class
rectangles of 128-delta blocks) and decodes every class in one
``packed_store.decode_grouped`` call, as the JAX function decodes them in
one program (one launch of the CUDA kernel on the card, its plain version
on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from .packed_store import BLOCK, decode_grouped


def decode_packed(packed: dict, device="cuda") -> torch.Tensor:
    """All blocks back to absolute rowids: int32 [packed["count"]]."""
    device = torch.device(device)
    rows = torch.zeros((packed["n_blocks"], BLOCK), dtype=torch.int32,
                       device=device)
    items, idx = [], []
    for c, pc in packed["classes"].items():
        words = torch.from_numpy(
            np.ascontiguousarray(pc["words"], np.uint32).view(np.int32)
        ).to(device)
        base = torch.from_numpy(pc["base"].astype(np.int32)).to(device)
        items.append((words, base, c))
        idx.append(pc["block_idx"].astype(np.int64))
    if items:
        out, _ = decode_grouped(items)
        rows[torch.from_numpy(np.concatenate(idx)).to(device)] = out
    return rows.reshape(-1)[: packed["count"]]
