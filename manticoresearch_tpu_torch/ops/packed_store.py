"""Packed posting store: the host build and the bit-plane decode.

The host half (``build_store``, ``PackedStore`` and their helpers) is the
JAX package's ``ops/packed_store.py`` as it is: posting rowids
(delta-coded), term frequencies and field masks of every term with
df >= PACK_MIN go into 128-entry bit-plane blocks grouped by width class.

The decode is the counterpart of that module's ``decode_words`` /
``decode_rowids``. One block holds 128 values in c bit planes (c in
CLASSES); plane j is 4 uint32 words (held in int32 tensors) and value l's
bit j is bit l % 32 of word 4j + l // 32. ``decode_words`` extracts the
values (the tf and fieldmask streams); ``decode_rowids`` adds the in-block
prefix sum plus the block's base (the delta-coded rowid stream).
``decode_grouped`` decodes many windows of any classes and both kinds in
one call; the other two are its one-window cases.

On CUDA tensors ``decode_grouped`` makes one launch of the hand-written
kernel (csrc/bitplane_decode.cu) or raises; on CPU tensors it runs the
plain PyTorch version. ``LAUNCHES`` counts both, and the blocks the kernel
decoded, so a run can show which path the search took.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from . import _build

BLOCK = 128
PLANE_WORDS = 4            # 128 bits per plane
CLASSES = (4, 8, 16, 32)
PACK_MIN = 128             # min df to pack (else residual raw postings)
_CHUNK = 8192              # blocks per packing chunk (bounds temp memory)


def _class_of(width: np.ndarray) -> np.ndarray:
    """Bit width -> class id (index into CLASSES)."""
    c = np.zeros(len(width), np.int8)
    for i, cc in enumerate(CLASSES):
        c[width > (CLASSES[i - 1] if i else 0)] = i
    return c


def _pack_planes(vals: np.ndarray, c: int) -> np.ndarray:
    """[NB, 128] uint32 values (< 2^c) -> [NB, 4c] u32 bit-plane words."""
    out = np.empty((len(vals), PLANE_WORDS * c), np.uint32)
    sh = np.arange(32, dtype=np.uint32)
    for lo in range(0, len(vals), _CHUNK):
        v = vals[lo:lo + _CHUNK]
        bits = ((v[:, None, :] >> np.arange(c, dtype=np.uint32)[None, :,
                                            None]) & 1).astype(np.uint32)
        w = (bits.reshape(len(v), c, PLANE_WORDS, 32)
             << sh[None, None, None, :]).sum(axis=3, dtype=np.uint32)
        out[lo:lo + _CHUNK] = w.reshape(len(v), PLANE_WORDS * c)
    return out


@dataclass
class PackedStore:
    """Host-side packed streams + per-term metadata (uploaded by
    ops/device_index.upload; consumed by the planner + search kernel)."""

    # per-term: class id+1 per stream (0 = unpacked), start block row
    term_class: np.ndarray          # i8[T, 3]   (rw, tf, fm)
    term_start: np.ndarray          # i32[T, 3]  block row in class array
    # class streams: kind -> class width -> arrays
    rw_words: dict = dc_field(default_factory=dict)   # c -> u32[NB, 4c]
    rw_base: dict = dc_field(default_factory=dict)    # c -> i32[NB]
    tf_words: dict = dc_field(default_factory=dict)
    fm_words: dict = dc_field(default_factory=dict)
    # residual raw postings (unpacked short-tail terms)
    res_offsets: np.ndarray = None  # i32[T+1] (0-width for packed terms)
    res_rowid: np.ndarray = None    # i32[Pres]
    res_tfq: np.ndarray = None      # f32[Pres]
    res_fieldmask: np.ndarray = None  # i32[Pres]

    def nbytes(self) -> int:
        tot = 0
        for d in (self.rw_words, self.rw_base, self.tf_words,
                  self.fm_words):
            tot += sum(a.nbytes for a in d.values())
        for a in (self.res_rowid, self.res_tfq, self.res_fieldmask):
            tot += a.nbytes
        return tot


def build_store(term_docs: np.ndarray, term_offsets: np.ndarray,
                post_rowid: np.ndarray, post_tf: np.ndarray,
                post_tfq: np.ndarray, post_fieldmask: np.ndarray,
                force_packed: np.ndarray | None = None,
                force_class: np.ndarray | None = None,
                classes_only: bool = False):
    """force_packed (bool[T]) / force_class (i8[T,3], CLASS INDEX values)
    override the local pack decision and width classes — the sharded path
    forces GLOBAL assignments so one plan's static slot_packed shapes hold
    on every shard (a shard's local widths never exceed the global max)."""
    T = len(term_docs)
    df = term_docs.astype(np.int64)
    packed_sel = (df >= PACK_MIN) if force_packed is None \
        else (np.asarray(force_packed, bool) & (df > 0))
    p_tids = np.flatnonzero(packed_sel)

    term_class = np.zeros((T, 3), np.int8)
    term_start = np.zeros((T, 3), np.int32)

    # ---- residual raw stream for short-tail terms -------------------------
    res_offsets = np.zeros(T + 1, np.int64)
    res_len = np.where(packed_sel, 0, df)
    np.cumsum(res_len, out=res_offsets[1:])
    Pres = int(res_offsets[-1])
    res_rowid = np.zeros(Pres, np.int32)
    res_tfq = np.zeros(Pres, np.float32)
    # wide-field indexes carry [P, FW] fieldmask planes
    res_fm = (np.zeros((Pres, post_fieldmask.shape[1]), np.int32)
              if post_fieldmask.ndim == 2 else np.zeros(Pres, np.int32))
    u_tids = np.flatnonzero(~packed_sel & (df > 0))
    if len(u_tids):
        src = _ranges_concat(term_offsets, u_tids, df)
        dst = _ranges_concat(res_offsets, u_tids, res_len)
        res_rowid[dst] = post_rowid[src]
        res_tfq[dst] = post_tfq[src]
        res_fm[dst] = post_fieldmask[src]

    store = PackedStore(term_class=term_class, term_start=term_start,
                        res_offsets=res_offsets.astype(np.int32),
                        res_rowid=res_rowid, res_tfq=res_tfq,
                        res_fieldmask=res_fm)
    if not len(p_tids):
        if classes_only:
            return packed_sel, np.zeros((T, 3), np.int8)
        for c in CLASSES:
            store.rw_words[c] = np.zeros((0, PLANE_WORDS * c), np.uint32)
            store.rw_base[c] = np.zeros(0, np.int32)
            store.tf_words[c] = np.zeros((0, PLANE_WORDS * c), np.uint32)
            store.fm_words[c] = np.zeros((0, PLANE_WORDS * c), np.uint32)
        return store

    # ---- block layout for packed terms ------------------------------------
    p_df = df[p_tids]
    p_nb = (p_df + BLOCK - 1) // BLOCK
    p_len = p_nb * BLOCK
    p_out = np.zeros(len(p_tids) + 1, np.int64)
    np.cumsum(p_len, out=p_out[1:])
    total = int(p_out[-1])
    NB = total // BLOCK

    # value matrix V[sum p_len]; pad region repeats the term's LAST rowid
    # so in-block deltas stay 0 there (decode repeats the row; masked out
    # by slot length like the raw path's padding)
    src = _ranges_concat(term_offsets, p_tids, df)
    dst = _ranges_concat(p_out, np.arange(len(p_tids)), p_df)
    last_rowid = post_rowid[term_offsets[p_tids + 1].astype(np.int64) - 1]
    V = np.repeat(last_rowid.astype(np.int64), p_len)
    V[dst] = post_rowid[src]
    blocks = V.reshape(NB, BLOCK)
    deltas = blocks.copy()
    deltas[:, 1:] -= blocks[:, :-1]
    deltas[:, 0] = 0
    base = blocks[:, 0].astype(np.int32)

    # tf / fieldmask matrices (absolute values, pad 0)
    Vtf = np.zeros(total, np.int64)
    Vtf[dst] = post_tf[src]
    Vfm = np.zeros(total, np.int64)
    Vfm[dst] = post_fieldmask[src]

    # per-term class per stream: width of the max value over its blocks;
    # blocks are term-major, so per-term reductions are reduceat ranges
    blk_off = np.zeros(len(p_tids) + 1, np.int64)
    np.cumsum(p_nb, out=blk_off[1:])

    def classes_for(mat):
        bmax = mat.max(axis=1)
        tmax = np.maximum.reduceat(bmax, blk_off[:-1])
        width = np.ceil(np.log2(np.maximum(tmax, 1) + 1)).astype(np.int64)
        return _class_of(np.maximum(width, 1))

    if force_class is not None:
        fc = np.asarray(force_class)
        cls_rw = fc[p_tids, 0]
        cls_tf = fc[p_tids, 1]
        cls_fm = fc[p_tids, 2]
    else:
        cls_rw = classes_for(deltas)
        cls_tf = classes_for(Vtf.reshape(NB, BLOCK))
        cls_fm = classes_for(Vfm.reshape(NB, BLOCK))
    if classes_only:
        cls = np.zeros((T, 3), np.int8)
        cls[p_tids, 0] = cls_rw
        cls[p_tids, 1] = cls_tf
        cls[p_tids, 2] = cls_fm
        return packed_sel, cls

    def emit(kind_idx, cls, mat, words_out, base_out=None):
        for ci, c in enumerate(CLASSES):
            sel_t = np.flatnonzero(cls == ci)          # packed-term indices
            sel_b = _ranges_concat(blk_off, sel_t, p_nb)      # their blocks
            words_out[c] = _pack_planes(
                mat[sel_b].astype(np.uint32), c)
            if base_out is not None:
                base_out[c] = base[sel_b]
            # start block row per term within this class array
            nb_sel = p_nb[sel_t]
            starts = np.zeros(len(sel_t) + 1, np.int64)
            np.cumsum(nb_sel, out=starts[1:])
            term_class[p_tids[sel_t], kind_idx] = ci + 1
            term_start[p_tids[sel_t], kind_idx] = starts[:-1]

    emit(0, cls_rw, deltas, store.rw_words, store.rw_base)
    emit(1, cls_tf, Vtf.reshape(NB, BLOCK), store.tf_words)
    emit(2, cls_fm, Vfm.reshape(NB, BLOCK), store.fm_words)
    return store


def _ranges_concat(offsets: np.ndarray, ids: np.ndarray,
                   lens_all: np.ndarray) -> np.ndarray:
    """Concatenate [offsets[i], offsets[i]+len_i) ranges for i in ids."""
    lens = np.asarray(lens_all)[ids].astype(np.int64)
    tot = int(lens.sum())
    if not tot:
        return np.zeros(0, np.int64)
    rep_start = np.repeat(np.asarray(offsets)[ids].astype(np.int64), lens)
    excl = np.zeros(len(ids), np.int64)
    np.cumsum(lens[:-1], out=excl[1:])
    intra = np.arange(tot, dtype=np.int64) - np.repeat(excl, lens)
    return rep_start + intra


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
LAUNCHES = _build.KernelLaunches()


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (what int32 arithmetic
    in the JAX code does on overflow)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def decode_words_ref(words: torch.Tensor, c: int) -> torch.Tensor:
    """[nb, 4c] int32 words -> [nb, 128] int32 values (plain version)."""
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
    """Delta blocks + per-block base -> absolute rowids [nb * 128]
    (plain version)."""
    deltas = decode_words_ref(words, c).to(torch.int64)
    out = base.to(torch.int64)[:, None] + torch.cumsum(deltas, dim=1)
    return wrap_i32(out).reshape(-1)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"no bit-plane decode for device {t.device}")


def _check(words: torch.Tensor, base: torch.Tensor | None, c: int,
           device: torch.device) -> int:
    """Validate one window; returns its block count."""
    if c not in CLASSES:
        raise ValueError(f"width class {c} not in {CLASSES}")
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[1] != PLANE_WORDS * c or not words.is_contiguous()
            or words.device != device):
        raise ValueError(f"words must be contiguous int32 [nb, "
                         f"{PLANE_WORDS * c}] on {device}, got {words.dtype} "
                         f"{tuple(words.shape)} on {words.device}")
    nb = words.shape[0]
    if base is not None and (base.dtype != torch.int32
                             or base.shape != (nb,)
                             or not base.is_contiguous()
                             or base.device != device):
        raise ValueError(f"base must be contiguous int32 [{nb}] on {device}")
    return nb


def decode_grouped(items: list[tuple]) -> tuple[torch.Tensor, np.ndarray]:
    """Decode every window in one call: -> (out int32 [total_blocks, 128],
    offsets int64 [len(items) + 1]). A window is (words int32 [nb, 4c],
    base int32 [nb] or None, c); window i's blocks are rows
    ``offsets[i]:offsets[i + 1]`` of ``out``, rowids with the prefix sum
    where it has a base, plain values where not.

    On CUDA tensors: one list of window addresses goes to the card in one
    copy from pinned memory and one kernel launch decodes every window."""
    if not items:
        raise ValueError("decode_grouped needs at least one window")
    device = items[0][0].device
    nbs = np.fromiter((_check(w, b, c, device) for w, b, c in items),
                      np.int64, len(items))
    offsets = np.zeros(len(items) + 1, np.int64)
    np.cumsum(nbs, out=offsets[1:])
    total = int(offsets[-1])
    if _on_cpu(items[0][0]):
        LAUNCHES.add(plain=1)
        parts = [decode_words_ref(w, c) if b is None
                 else decode_rowids_ref(w, b, c).reshape(-1, BLOCK)
                 for w, b, c in items]
        out = (torch.cat(parts) if parts else
               torch.empty((0, BLOCK), dtype=torch.int32))
        return out, offsets
    out = torch.empty((total, BLOCK), dtype=torch.int32, device=device)
    keep = nbs > 0           # the kernel takes windows of >= 1 block
    if not keep.any():
        return out, offsets
    table = np.empty((int(keep.sum()), 4), np.int64)
    row = 0
    for (w, b, c), first, k in zip(items, offsets[:-1], keep):
        if not k:
            continue
        addr = w.data_ptr()
        if addr % 16:
            raise ValueError(f"words of a window must start at a multiple "
                             f"of 16 bytes (address {addr:#x})")
        table[row] = (addr, 0 if b is None else b.data_ptr(), first, c)
        row += 1
    # a fresh pinned buffer per call: the caching host allocator holds it
    # until the copy below has run
    table_dev = torch.from_numpy(table).pin_memory().to(device,
                                                        non_blocking=True)
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mt_bitplane_decode_grouped(
            table_dev.data_ptr(), len(table), total, out.data_ptr(), stream)
    _build.check(rc, "bitplane_decode_grouped")
    LAUNCHES.add(device=device, kernel=1, work=total)
    return out, offsets


def decode_lists(wins: list[list[tuple]]) -> list[list[torch.Tensor]]:
    """Decode several lists of windows (one per program, each as
    ``ops.search.packed_windows`` gives it) in one ``decode_grouped`` call,
    or none where no list holds a window; -> per list, each window's
    values flat (int32 [nb * 128]), in order."""
    items = [w for ws in wins for w in ws]
    if not items:
        return [[] for _ in wins]
    out, offsets = decode_grouped(items)
    flat = [part.view(-1) for part in out.split(np.diff(offsets).tolist())]
    per, j = [], 0
    for ws in wins:
        per.append(flat[j:j + len(ws)])
        j += len(ws)
    return per


def decode_words(words: torch.Tensor, c: int) -> torch.Tensor:
    """[nb, 4c] int32 words -> [nb, 128] int32 values (bit-plane extract)."""
    return decode_grouped([(words, None, c)])[0]


def decode_rowids(words: torch.Tensor, base: torch.Tensor,
                  c: int) -> torch.Tensor:
    """Delta blocks + per-block base -> absolute rowids [nb * 128]."""
    return decode_grouped([(words, base, c)])[0].reshape(-1)
