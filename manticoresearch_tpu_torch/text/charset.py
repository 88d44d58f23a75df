"""Charset table parsing + codepoint folding.

Re-implements the semantics of the reference's charset_table machinery
(CSphCharsetDefinitionParser, Manticore src/sphinx.cpp:3395-3690 and
CSphLowercaser): a charset spec is a comma-separated list of entries

    x           stray char (maps to itself, is a word character)
    x..y        stray range
    x->y        single remap
    x..y->z..t  remapped range (lengths must match)
    x..y/2      "checkerboard" range: (a, a+1) -> a+1 for each pair
    <alias>     named alias (english, russian, non_cjk, cjk, ...)

Chars can be literal ASCII (0x20..0x7f) or U+XXXX hex. Codepoints absent from
the table fold to 0 and act as token separators. Dest codepoints below U+20
are rejected (AddRange, sphinx.cpp:3427).

The fold table is materialized as sorted numpy range arrays; folding a string
is a vectorized searchsorted over its codepoints — the host-side analog of the
reference's 256-entry chunked lookup tables, built for numpy throughput
instead of per-char lookup.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

_CHARSET_DIR = os.path.join(os.path.dirname(__file__), "charsets")

# Built-in string aliases (reference sphinx.cpp:3449-3451); file-based aliases
# are resolved from the data dir like the cmake-generated globalaliases.h does.
_BUILTIN_ALIASES = {
    "english": "A..Z->a..z, a..z",
    "russian": "U+410..U+42F->U+430..U+44F, U+430..U+44F, U+401->U+451, U+451",
}
_FILE_ALIASES = ("non_cjk", "cjk", "chinese", "japanese", "korean")

DEFAULT_CHARSET = "non_cjk"


class CharsetError(ValueError):
    pass


@dataclass(frozen=True)
class RemapRange:
    start: int
    end: int
    remap_start: int


@lru_cache(maxsize=None)
def _alias_spec(name: str) -> str | None:
    if name in _BUILTIN_ALIASES:
        return _BUILTIN_ALIASES[name]
    if name in _FILE_ALIASES:
        path = os.path.join(_CHARSET_DIR, name + ".txt")
        with open(path, "r", encoding="utf-8") as f:
            return f.read()
    return None


class _Parser:
    def __init__(self, text: str):
        self.s = text
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.s)

    def skip_spaces(self) -> None:
        while not self.eof() and self.s[self.i].isspace():
            self.i += 1

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < len(self.s) else ""

    def parse_code(self) -> int:
        s, i = self.s, self.i
        if s[i : i + 2] == "U+":
            i += 2
            code = 0
            ndig = 0
            while i < len(s) and s[i] in "0123456789abcdefABCDEF":
                code = code * 16 + int(s[i], 16)
                i += 1
                ndig += 1
            if ndig == 0:
                raise CharsetError("bad U+ code in charset_table")
        else:
            c = s[i]
            if ord(c) < 32 or ord(c) > 127:
                raise CharsetError(
                    "non-ASCII characters not allowed, use 'U+00AB' syntax"
                )
            code = ord(c)
            i += 1
        while i < len(s) and s[i].isspace():
            i += 1
        self.i = i
        return code


def parse_charset_spec(spec: str) -> list[RemapRange]:
    """Parse a charset_table spec into merged, sorted remap ranges.

    Mirrors CSphCharsetDefinitionParser::Parse (sphinx.cpp:3496) including the
    final sort + overlap merge (later/overlapping ranges collapse, keeping the
    first range's mapping — sphinx.cpp:3675-3685).
    """
    ranges: list[RemapRange] = []

    def add(start: int, end: int, remap: int) -> None:
        if remap < 0x20:
            raise CharsetError(f"dest range (U+{remap:x}) below U+20, not allowed")
        ranges.append(RemapRange(start, end, remap))

    p = _Parser(spec)
    while True:
        p.skip_spaces()
        if p.eof():
            break
        if p.peek() == ",":
            raise CharsetError("stray ',' not allowed, use 'U+002C' instead")

        # alias?
        got_alias = False
        for name in list(_BUILTIN_ALIASES) + list(_FILE_ALIASES):
            nl = len(name)
            if p.s.startswith(name, p.i) and (
                p.i + nl >= len(p.s) or p.s[p.i + nl] == ","
            ):
                p.i += nl
                if p.peek() == ",":
                    p.i += 1
                sub = _alias_spec(name)
                for r in parse_charset_spec(sub):
                    add(r.start, r.end, r.remap_start)
                got_alias = True
                break
        if got_alias:
            continue

        start = p.parse_code()
        # stray char
        if p.eof() or p.peek() == ",":
            add(start, start, start)
            if p.eof():
                break
            p.i += 1
            continue
        # single remap
        if p.peek() == "-" and p.peek(1) == ">":
            p.i += 2
            dest = p.parse_code()
            add(start, start, dest)
            if not p.eof():
                if p.peek() != ",":
                    raise CharsetError("syntax error")
                p.i += 1
            continue
        # range
        if not (p.peek() == "." and p.peek(1) == "."):
            raise CharsetError(f"syntax error near offset {p.i}")
        p.i += 2
        p.skip_spaces()
        end = p.parse_code()
        if start > end:
            raise CharsetError("range end less than range start")
        # stray range
        if p.eof() or p.peek() == ",":
            add(start, end, start)
            if p.eof():
                break
            p.i += 1
            continue
        # checkerboard
        if p.peek() == "/" and p.peek(1) == "2":
            for i in range(start, end, 2):
                add(i, i, i + 1)
                add(i + 1, i + 1, i + 1)
            p.i += 2
            p.skip_spaces()
            if not p.eof():
                if p.peek() != ",":
                    raise CharsetError("expected end of line or ','")
                p.i += 1
            continue
        # remapped range
        if not (p.peek() == "-" and p.peek(1) == ">"):
            raise CharsetError("expected end of line, ',' or '-><char>'")
        p.i += 2
        p.skip_spaces()
        rstart = p.parse_code()
        if not (p.peek() == "." and p.peek(1) == "."):
            raise CharsetError("expected '..'")
        p.i += 2
        rend = p.parse_code()
        if rstart > rend:
            raise CharsetError("dest range end less than dest range start")
        if rend - rstart != end - start:
            raise CharsetError("dest range length must match src range length")
        add(start, end, rstart)
        if p.eof():
            break
        if p.peek() != ",":
            raise CharsetError("expected ','")
        p.i += 1

    # sort + merge overlaps (reference keeps first mapping on overlap)
    ranges.sort(key=lambda r: (r.start, r.end))
    merged: list[RemapRange] = []
    for r in ranges:
        if merged and merged[-1].end >= r.start:
            prev = merged[-1]
            merged[-1] = RemapRange(prev.start, max(prev.end, r.end), prev.remap_start)
        else:
            merged.append(r)
    return merged


class Lowercaser:
    """Vectorized codepoint folder (CSphLowercaser analog).

    fold(codepoints) maps each codepoint through the charset table; codepoints
    outside every range fold to 0 (separator).
    """

    def __init__(self, ranges: list[RemapRange]):
        self.ranges = ranges
        n = len(ranges)
        self._starts = np.fromiter((r.start for r in ranges), np.int32, n)
        self._ends = np.fromiter((r.end for r in ranges), np.int32, n)
        self._remaps = np.fromiter((r.remap_start for r in ranges), np.int32, n)

    def fold(self, codes: np.ndarray) -> np.ndarray:
        codes = codes.astype(np.int32, copy=False)
        idx = np.searchsorted(self._starts, codes, side="right") - 1
        idx_c = np.clip(idx, 0, max(len(self._starts) - 1, 0))
        if len(self._starts) == 0:
            return np.zeros_like(codes)
        in_range = (idx >= 0) & (codes <= self._ends[idx_c])
        out = np.where(
            in_range, self._remaps[idx_c] + (codes - self._starts[idx_c]), 0
        )
        return out.astype(np.int32)

    def fold_str(self, text: str) -> np.ndarray:
        if not text:
            return np.zeros(0, np.int32)
        codes = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
        return self.fold(codes.astype(np.int32))


@lru_cache(maxsize=32)
def get_lowercaser(spec: str = DEFAULT_CHARSET) -> Lowercaser:
    return Lowercaser(parse_charset_spec(spec))
