"""Docstore: stored field text in compressed blocks with lazy access.

Behavioral model: the reference docstore (Manticore src/docstore.cpp:50-181)
keeps original document text in LZ4-compressed blocks of consecutive
rows with a block index and a small decompressed-block cache, so
fetching one document touches one block, not the whole column. Same
design here with stdlib zlib (LZ4 isn't vendored): rows pack into
blocks of `block_size` docs; each block is a zlib-compressed
length-prefixed UTF-8 run; reads decompress one block and LRU-cache a
few.
"""
from __future__ import annotations

import struct
import zlib
from collections import OrderedDict

_MAGIC = b"MTDS1\n"


class BlockedDocstore:
    """A read-only list[str]-like column stored as compressed blocks."""

    def __init__(self, blocks: list[bytes], n: int, block_size: int,
                 cache_blocks: int = 8):
        self._blocks = blocks
        self._n = n
        self._bs = block_size
        self._cache: OrderedDict[int, list[str]] = OrderedDict()
        self._cache_blocks = cache_blocks

    # -- construction -------------------------------------------------------
    @classmethod
    def from_list(cls, values, block_size: int = 64,
                  level: int = 6) -> "BlockedDocstore":
        blocks = []
        n = len(values)
        for b0 in range(0, n, block_size):
            chunk = values[b0:b0 + block_size]
            raw = bytearray()
            for v in chunk:
                enc = ("" if v is None else str(v)).encode("utf-8")
                raw += struct.pack("<I", len(enc)) + enc
            blocks.append(zlib.compress(bytes(raw), level))
        return cls(blocks, n, block_size)

    # -- sequence protocol --------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def _block(self, bi: int) -> list[str]:
        hit = self._cache.get(bi)
        if hit is not None:
            self._cache.move_to_end(bi)
            return hit
        raw = zlib.decompress(self._blocks[bi])
        out = []
        off = 0
        while off < len(raw):
            (ln,) = struct.unpack_from("<I", raw, off)
            off += 4
            out.append(raw[off:off + ln].decode("utf-8"))
            off += ln
        self._cache[bi] = out
        if len(self._cache) > self._cache_blocks:
            self._cache.popitem(last=False)
        return out

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._block(i // self._bs)[i % self._bs]

    def __iter__(self):
        for bi in range(len(self._blocks)):
            yield from self._block(bi)

    def tolist(self) -> list[str]:
        return list(self)

    @property
    def compressed_bytes(self) -> int:
        return sum(len(b) for b in self._blocks)

    # -- (de)serialization --------------------------------------------------
    def dump(self, fh) -> None:
        fh.write(_MAGIC)
        fh.write(struct.pack("<III", self._n, self._bs, len(self._blocks)))
        for b in self._blocks:
            fh.write(struct.pack("<I", len(b)))
            fh.write(b)

    @classmethod
    def load(cls, fh) -> "BlockedDocstore":
        if fh.read(len(_MAGIC)) != _MAGIC:
            raise ValueError("bad docstore magic")
        n, bs, nb = struct.unpack("<III", fh.read(12))
        blocks = []
        for _ in range(nb):
            (ln,) = struct.unpack("<I", fh.read(4))
            blocks.append(fh.read(ln))
        return cls(blocks, n, bs)


def save_docstore(columns: dict, path: str) -> None:
    """Write named columns ({field: list[str] | BlockedDocstore}) to one
    docstore file."""
    with open(path, "wb") as fh:
        names = sorted(columns)
        fh.write(struct.pack("<I", len(names)))
        for name in names:
            enc = name.encode("utf-8")
            fh.write(struct.pack("<I", len(enc)))
            fh.write(enc)
            col = columns[name]
            if not isinstance(col, BlockedDocstore):
                col = BlockedDocstore.from_list(col)
            col.dump(fh)


def load_docstore(path: str) -> dict:
    out: dict = {}
    with open(path, "rb") as fh:
        (nn,) = struct.unpack("<I", fh.read(4))
        for _ in range(nn):
            (ln,) = struct.unpack("<I", fh.read(4))
            name = fh.read(ln).decode("utf-8")
            out[name] = BlockedDocstore.load(fh)
    return out
