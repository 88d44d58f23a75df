"""Bit-plane posting decode: the CUDA kernel's wrappers and plain versions.

Counterpart of ``manticoresearch_tpu/ops/packed_store.py:231-259``. One
block holds 128 values in c bit planes (c in CLASSES); plane j is 4 uint32
words (held in int32 tensors) and value l's bit j is bit l % 32 of word
4j + l // 32. ``decode_words`` extracts the values (the tf and fieldmask
streams); ``decode_rowids`` adds the in-block prefix sum plus the block's
base (the delta-coded rowid stream).

On a CUDA tensor each wrapper launches the hand-written kernel
(csrc/bitplane_decode.cu) or raises; on a CPU tensor it runs the plain
PyTorch version. ``LAUNCHES`` counts both, so a run can show which path
the search took.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from manticoresearch_tpu.ops.packed_store import (  # noqa: F401  (re-export)
    BLOCK, CLASSES, PACK_MIN, PLANE_WORDS)

from . import _build


@dataclass
class LaunchCounts:
    kernel: int = 0   # CUDA bitplane_decode launches
    plain: int = 0    # plain-PyTorch decodes (CPU tensors)

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


LAUNCHES = LaunchCounts()


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (what int32 arithmetic
    in the JAX code does on overflow)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernel's oracle on the card)
# --------------------------------------------------------------------------
def decode_words_ref(words: torch.Tensor, c: int) -> torch.Tensor:
    """[nb, 4c] int32 words -> [nb, 128] int32 values."""
    nb = words.shape[0]
    w = (words.to(torch.int64) & 0xFFFFFFFF).reshape(nb, c, PLANE_WORDS)
    lane = torch.arange(BLOCK, device=words.device)
    sh = lane % 32
    vals = torch.zeros((nb, BLOCK), dtype=torch.int64, device=words.device)
    for j in range(c):
        word = w[:, j, :][:, lane // 32]                       # [nb, 128]
        vals |= ((word >> sh) & 1) << j
    return wrap_i32(vals)


def decode_rowids_ref(words: torch.Tensor, base: torch.Tensor,
                      c: int) -> torch.Tensor:
    """Delta blocks + per-block base -> absolute rowids [nb * 128]."""
    deltas = decode_words_ref(words, c).to(torch.int64)
    out = base.to(torch.int64)[:, None] + torch.cumsum(deltas, dim=1)
    return wrap_i32(out).reshape(-1)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------
def _launch(words: torch.Tensor, base: torch.Tensor | None,
            c: int) -> torch.Tensor:
    if c not in CLASSES:
        raise ValueError(f"width class {c} not in {CLASSES}")
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[1] != PLANE_WORDS * c):
        raise ValueError(f"words must be int32 [nb, {PLANE_WORDS * c}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    words = words.contiguous()
    nb = words.shape[0]
    if base is not None:
        if (base.dtype != torch.int32 or base.shape != (nb,)
                or base.device != words.device):
            raise ValueError(f"base must be int32 [{nb}] on {words.device}")
        base = base.contiguous()
    out = torch.empty((nb, BLOCK), dtype=torch.int32, device=words.device)
    if nb == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mt_bitplane_decode(
            words.data_ptr(), None if base is None else base.data_ptr(),
            out.data_ptr(), nb, c, int(base is not None), stream)
    _build.check(rc, "bitplane_decode")
    LAUNCHES.kernel += 1
    return out


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no bit-plane decode for device {t.device}")


def decode_words(words: torch.Tensor, c: int) -> torch.Tensor:
    """[nb, 4c] int32 words -> [nb, 128] int32 values (bit-plane extract)."""
    if _on_cpu(words):
        LAUNCHES.plain += 1
        return decode_words_ref(words, c)
    return _launch(words, None, c)


def decode_rowids(words: torch.Tensor, base: torch.Tensor,
                  c: int) -> torch.Tensor:
    """Delta blocks + per-block base -> absolute rowids [nb * 128]."""
    if _on_cpu(words):
        LAUNCHES.plain += 1
        return decode_rowids_ref(words, base, c)
    return _launch(words, base, c).reshape(-1)
