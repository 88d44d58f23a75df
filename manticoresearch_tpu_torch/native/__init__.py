"""Native (C++) host components, loaded via ctypes.

``tokenizer.cpp`` holds the host-side hot loops of tokenization, the
index-build bottleneck: ``mt_tokenize`` (UTF-8 decode, charset fold and
word split in one pass), ``mt_crc64`` and the ``MtDict`` bulk-build API,
which assigns term ids to a whole field's tokens in one call. It is the
JAX package's source, and the exported names and ctypes signatures are
the same.

The library compiles with g++ on first use into
``manticoresearch_tpu_torch/_build/`` (git-ignored), under a name keyed
on a hash of the source and the flags, so a fresh checkout builds it once
and an edited source builds anew. Nothing built is committed and nothing
is written next to the source. The ``.so`` is linked under a temporary
name and moved into place with ``os.replace``, so processes that build at
once agree. Where g++ is missing or fails, ``get_native_lib()`` returns
None and the callers take their Python path, as the JAX package does;
``turned_off()`` makes them take it on purpose.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_OFF = 0

_SRC = Path(__file__).resolve().parent / "tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_dir / f"libmttok_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library into ``build_dir`` unless it is there."""
    out = library_path(build_dir)
    if out.is_file():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"{out.name}.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)   # atomic: concurrent builders agree
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _declare(lib: ctypes.CDLL) -> None:
    lib.mt_tokenize.restype = ctypes.c_int
    lib.mt_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_int,                  # text
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,   # fold table
        ctypes.c_int, ctypes.c_int,                     # minlen, step
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,   # codes
        ctypes.POINTER(ctypes.c_int32),                 # tok_off
        ctypes.POINTER(ctypes.c_int32),                 # len
        ctypes.POINTER(ctypes.c_int32),                 # pos
        ctypes.POINTER(ctypes.c_int32),                 # char_start
        ctypes.POINTER(ctypes.c_int32),                 # char_end
        ctypes.c_int,                                   # cap_tokens
    ]
    lib.mt_crc64.restype = ctypes.c_uint64
    lib.mt_crc64.argtypes = [ctypes.c_char_p, ctypes.c_int]
    # bulk-build dictionary API
    lib.mt_dict_new.restype = ctypes.c_void_p
    lib.mt_dict_free.argtypes = [ctypes.c_void_p]
    lib.mt_dict_n_terms.restype = ctypes.c_int
    lib.mt_dict_n_terms.argtypes = [ctypes.c_void_p]
    lib.mt_dict_pool_len.restype = ctypes.c_int64
    lib.mt_dict_pool_len.argtypes = [ctypes.c_void_p]
    lib.mt_dict_export.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mt_dict_tokenize.restype = ctypes.c_int
    lib.mt_dict_tokenize.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def load(path: Path) -> ctypes.CDLL:
    """Open a built library and declare its entry points."""
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


@contextlib.contextmanager
def turned_off():
    """Inside the block ``get_native_lib()`` returns None, so the callers
    take their Python path (to hold the two paths equal)."""
    global _OFF
    with _LOCK:
        _OFF += 1
    try:
        yield
    finally:
        with _LOCK:
            _OFF -= 1


def get_native_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _OFF:
            return None
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            _LIB = load(build())
        except (OSError, subprocess.SubprocessError):
            _LIB = None
        return _LIB
