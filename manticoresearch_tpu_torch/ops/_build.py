"""Build and load the port's CUDA kernels.

The sources under ``manticoresearch_tpu_torch/csrc/`` compile with nvcc for
Hopper (``sm_90a``), one nvcc process per source, all started together,
and link into one shared library with a plain C interface, which is loaded
with ctypes. The build happens at first use, into
``manticoresearch_tpu_torch/_build/`` (git-ignored), keyed on a hash of the
sources and flags, so a fresh checkout builds everything on its first call
and later processes reuse the library.

There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels cannot be built")


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.mt_bitplane_decode_grouped
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mt_segment_sum_ordered
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _run(procs: list) -> None:
    """Wait for every (command, process); raise on the first failure."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                      f"{out}{err}")
    if failed:
        raise RuntimeError(failed)


def _compile(srcs: list[Path], out: Path) -> None:
    """One nvcc per source, all at once, then one link into ``out``."""
    tmp_dir = BUILD_DIR / f"objs.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        objs = [tmp_dir / f"{p.stem}.o" for p in srcs]
        procs = []
        for src, obj in zip(srcs, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        _run(procs)
        tmp = tmp_dir / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)   # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
        out = BUILD_DIR / f"libmt_kernels_{_digest(srcs)}.so"
        if not out.is_file():
            _compile(srcs, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")
