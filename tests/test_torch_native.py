"""The port's native host code (``manticoresearch_tpu_torch/native``).

- ``native/tokenizer.cpp`` is the JAX package's source, byte for byte but
  for the path of the reference's source named in its header comment;
- the library builds here with g++, into the port's ``_build/`` under a
  name keyed on the source and flags, and never next to its source; two
  processes that build it into one empty directory at once both load it;
- ``IndexBuilder`` on the corpora of ``tests/test_torch_host.py`` and the
  tokenizer on its texts, on each of the port's two paths (native, and
  Python with the library turned off), equal to the JAX package on its
  native path: every array of ``PackedIndex`` and ``packed_store()``,
  every token;
- one ``Tokenizer`` shared by 8 threads, on texts from 10 bytes to over
  16 KiB (its native buffers grow while other threads read them), gives
  every thread the serial result.

Tolerance: exact.
"""
import contextlib
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from manticoresearch_tpu import native as jax_native
from manticoresearch_tpu.index import builder as jax_builder
from manticoresearch_tpu.schema import AttrDef as JaxAttrDef
from manticoresearch_tpu.schema import AttrType as JaxAttrType
from manticoresearch_tpu.schema import Schema as JaxSchema
from manticoresearch_tpu.text.tokenizer import Tokenizer as JaxTokenizer
from manticoresearch_tpu.text.tokenizer import \
    TokenizerSettings as JaxTokenizerSettings
from manticoresearch_tpu_torch import native
from manticoresearch_tpu_torch.index import builder
from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.text.tokenizer import (Tokenizer,
                                                      TokenizerSettings)

from .test_search import DOCS
from .test_torch_host import (CORPORA, _TEXTS, _TOKENIZER_SETTINGS,
                              _assert_packed_equal, _attrs, _plain)

REPO = Path(__file__).resolve().parent.parent
PATHS = ("native", "python")


def _on_path(path: str):
    """The port's native path as it comes, or its Python path."""
    if path == "native":
        assert native.get_native_lib() is not None
        return contextlib.nullcontext()
    return native.turned_off()


def test_tokenizer_source_is_the_jax_source():
    port = (REPO / "manticoresearch_tpu_torch" / "native" /
            "tokenizer.cpp").read_bytes()
    jax_src = (REPO / "manticoresearch_tpu" / "native" /
               "tokenizer.cpp").read_bytes()
    port_lines = port.splitlines(keepends=True)
    jax_lines = jax_src.splitlines(keepends=True)
    assert len(port_lines) == len(jax_lines)
    assert [i for i, (a, b) in enumerate(zip(port_lines, jax_lines))
            if a != b] == [2]
    # the header names where the reference's tokenizer lives
    model = b"// Behavioral model: CSphTokenizer_UTF8 ("
    assert port_lines[2] == model + b"Manticore src/sphinx.cpp:2671+)\n"
    assert jax_lines[2].startswith(model)
    assert jax_lines[2].endswith(b"/src/sphinx.cpp:2671+)\n")


def test_library_builds_into_build_dir():
    lib = native.get_native_lib()
    assert lib is not None
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert not list((REPO / "manticoresearch_tpu_torch" / "native").glob(
        "*.so"))
    jax_lib = jax_native.get_native_lib()
    for raw in (b"", b"abc", "Ünïcödé wörds".encode(), bytes(range(256))):
        assert lib.mt_crc64(raw, len(raw)) == jax_lib.mt_crc64(raw, len(raw))


_BUILD_SCRIPT = """
import sys
from pathlib import Path
from manticoresearch_tpu_torch import native
lib = native.load(native.build(Path(sys.argv[1])))
print(lib.mt_crc64(b"abc", 3))
"""


def test_concurrent_builds_into_one_directory(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    want = str(native.get_native_lib().mt_crc64(b"abc", 3))
    assert [out.strip() for out, _ in outs] == [want, want]
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path(tmp_path).name]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_index_builder_paths_match_jax_native(name, path):
    fields, kinds, docs = CORPORA[name]
    assert jax_native.get_native_lib() is not None
    jb = jax_builder.IndexBuilder(JaxSchema(
        fields=fields, attrs=_attrs(JaxAttrDef, JaxAttrType, kinds)))
    jb.add_documents(docs)
    jax_packed = jb.build()
    pb = builder.IndexBuilder(Schema(
        fields=fields, attrs=_attrs(AttrDef, AttrType, kinds)))
    with _on_path(path):
        pb.add_documents(docs)
        port_packed = pb.build()
    # the native bulk build reads the tokenizer's dense fold table
    assert hasattr(pb.tokenizer, "_fold_dense") == (path == "native")
    assert port_packed.n_terms > 10
    _assert_packed_equal(port_packed, jax_packed)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("kw", _TOKENIZER_SETTINGS,
                         ids=[str(i) for i in range(len(_TOKENIZER_SETTINGS))])
def test_tokenizer_paths_match_jax_native(kw, path):
    assert jax_native.get_native_lib() is not None
    jt = JaxTokenizer(JaxTokenizerSettings(**kw))
    pt = Tokenizer(TokenizerSettings(**kw))
    texts = _TEXTS + [d["content"] for d in DOCS] + [
        "<b>bold</b> and <i>it</i>", "x " * 20, "word " * 2000]
    with _on_path(path):
        for text in texts:
            assert _plain(pt.tokenize(text)) == _plain(jt.tokenize(text)), \
                text
            assert pt.tokenize_fast(text) == jt.tokenize_fast(text), text
    # n-gram settings take the Python path on both packages
    native_taken = path == "native" and "ngram_chars" not in kw
    assert hasattr(pt, "_buf_cap") == native_taken


N_THREADS = 8
N_CALLS = 200


def _thread_texts() -> list[str]:
    """N_CALLS texts from 10 bytes to over 16 KiB, ascending, of ASCII and
    two- and three-byte UTF-8 words."""
    rng = np.random.RandomState(5)
    words = ["alpha", "beta", "Ünïcödé", "wörds", "русский", "日本語",
             "x1", "don't", "a-b"] + [f"w{i}" for i in range(50)]
    sizes = np.geomspace(10, 17_000, N_CALLS).astype(int)
    texts = []
    for size in sizes:
        out, n = [], 0
        while n < size:
            w = words[rng.randint(len(words))]
            out.append(w)
            n += len(w.encode()) + 1
        texts.append(" ".join(out))
    assert len(texts[0].encode()) >= 10
    assert len(texts[-1].encode()) > 16 * 1024
    return texts


def test_tokenizer_shared_by_threads():
    assert native.get_native_lib() is not None
    texts = _thread_texts()
    serial = Tokenizer(TokenizerSettings())
    want = [(serial.tokenize(t), serial.tokenize_fast(t)) for t in texts]
    shared = Tokenizer(TokenizerSettings())
    start = threading.Barrier(N_THREADS)
    bad: list = []

    def run(k: int):
        start.wait()
        # every thread goes up in size, so the buffers grow (at each new
        # largest text past 4 KiB) while other threads read them
        for j in range(N_CALLS):
            got = (shared.tokenize(texts[j]), shared.tokenize_fast(texts[j]))
            if got != want[j]:
                bad.append((k, j))

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(N_THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert shared._buf_cap > 16 * 1024
