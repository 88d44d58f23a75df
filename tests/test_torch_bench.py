"""Port parity: the port's bench (``tools/bench.py``) against ``bench.py``.

On a 3,000-document bench corpus (``vocab`` 400, ``avg_len`` 30):

- the parity gate: the port's ``parity_recall_at_10`` on its
  ``SearchIndex(..., "cpu")`` returns 1.0, equal to
  ``bench.parity_recall_at_10`` on the JAX ``SearchIndex`` of
  ``bench.build_corpus`` with the same seeds, and both search the same
  24 query strings;
- the draws after the gate: the warm-up and measured batches of configs
  1-4 at bench's batch sizes (128; 32 for config 4), equal in match
  string, filters, group-by, select list, order, field weights and limit;
- the JSON line: ``bench.py`` (JAX on the CPU, through a launcher that
  keeps its persistent compile cache in the test's temporary directory)
  and ``python -m manticoresearch_tpu_torch.tools.bench --device cpu`` at
  the same tiny arguments, each in a subprocess with its own time limit,
  print lines
  with the same keys at every level (config 5's key by its prefix
  ``5_distributed_``; ``warnings`` only where both have it), the port's
  with ``device`` besides, both with ``recall_at_10`` 1.0;
- the failure contract: a perturbed weight fails the gate (the error line,
  exit 1, no ``configs`` numbers, no batch timed); ``--device cuda``
  without a card, or with a card but no ``nvidia-smi`` line to name it,
  gives the error line and exit 1, never a CPU run; a ``--deadline`` too
  short gives ``null`` configs with bench's warnings.

Tolerance: exact. recall@10 compares integer (docid, weight) pairs; the
draws are strings, integers and dataclasses of them.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from manticoresearch_tpu.exec.searcher import SearchIndex as JaxIndex
from manticoresearch_tpu_torch import bench_corpus
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery
from manticoresearch_tpu_torch.tools import bench as port_bench

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
DOCS, VOCAB, AVG_LEN = 3000, 400, 30
TINY = ["--docs", str(DOCS), "--vocab", str(VOCAB), "--avg-len",
        str(AVG_LEN), "--batch", "8", "--batches", "1", "--budget", "5",
        "--scale-docs", "6000"]
SUBPROCESS_TIMEOUT = 600
# bench.py keeps JAX's persistent compile cache in a fixed directory; this
# launcher runs bench.py unchanged with that cache in the directory given
# as its first argument, and checks that bench.py asked for one.
BENCH_LAUNCHER = """
import runpy, sys
import jax
cache, sys.argv = sys.argv[1], ["bench.py"] + sys.argv[2:]
update = jax.config.update
jax.config.update = lambda key, value: update(
    key, cache if key == "jax_compilation_cache_dir" else value)
runpy.run_path("bench.py", run_name="__main__")
assert jax.config.jax_compilation_cache_dir == cache
"""


def _recording(idx):
    """Record the match string of every ``search`` of an index."""
    seen = []
    search = idx.search

    def spy(q):
        seen.append(q.match)
        return search(q)
    idx.search = spy
    return seen


@pytest.fixture(scope="module")
def parity_runs():
    """Both packages' parity gates on the same corpus and seeds; the
    generators are left where the gate leaves them."""
    jax_packed = bench.build_corpus(DOCS, VOCAB, AVG_LEN)
    port_packed = bench_corpus.build_corpus(DOCS, VOCAB, AVG_LEN)
    jax_idx, port_idx = JaxIndex(jax_packed), SearchIndex(port_packed, "cpu")
    jax_seen, port_seen = _recording(jax_idx), _recording(port_idx)
    jax_gen = bench.WorkloadGen(np.random.RandomState(7), VOCAB, jax_packed)
    port_gen = bench_corpus.WorkloadGen(np.random.RandomState(7), VOCAB,
                                        port_packed)
    return {"jax": bench.parity_recall_at_10(jax_idx, jax_gen),
            "port": port_bench.parity_recall_at_10(port_idx, port_gen),
            "jax_seen": jax_seen, "port_seen": port_seen,
            "jax_gen": jax_gen, "port_gen": port_gen,
            "port_idx": port_idx, "port_packed": port_packed}


def test_parity_gate_equals_bench(parity_runs):
    assert parity_runs["port"] == parity_runs["jax"] == 1.0
    assert len(parity_runs["port_seen"]) == 24
    assert parity_runs["port_seen"] == parity_runs["jax_seen"]
    # what the host model reads: the index's PackedIndex and the plan's
    # host arrays
    idx = parity_runs["port_idx"]
    assert idx.packed is parity_runs["port_packed"]
    cq = idx.plan(SearchQuery(match=parity_runs["port_seen"][0], limit=10))
    assert isinstance(cq.runtime["idf"], np.ndarray)
    assert isinstance(cq.runtime["field_weights"], np.ndarray)


def _shape(q) -> tuple:
    """A query's fields that bench's draws set, as builtins."""
    return (q.match, q.limit, q.group_by, tuple(q.select or ()),
            tuple(q.sort or ()), tuple(sorted(q.field_weights.items())),
            tuple((f.attr, f.kind, tuple(f.values), f.lo, f.hi, f.exclude)
                  for f in q.filters))


def test_measured_draws_after_the_gate_equal_bench(parity_runs):
    jg, pg = parity_runs["jax_gen"], parity_runs["port_gen"]
    for cfg, n in (("config1", 128), ("config2", 128), ("config3", 128),
                   ("config4", 32)):
        pw, pm = getattr(pg, cfg)(n)
        jw, jm = getattr(jg, cfg)(n)
        assert [_shape(q) for q in pm] == [_shape(q) for q in jm], cfg
        assert [_shape(q) for q in pw] == [_shape(q) for q in jw], cfg
        assert len({q.match for q in pm}) > 1


def _key_tree(obj):
    """The keys of a JSON value at every level (config 5's by prefix)."""
    if not isinstance(obj, dict):
        return None
    return {("5_distributed_" if k.startswith("5_distributed_") else k):
            _key_tree(v) for k, v in obj.items()}


def _run(cmd: list, env: dict) -> tuple[subprocess.CompletedProcess, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=SUBPROCESS_TIMEOUT)
    return proc, time.perf_counter() - t0


def _line(proc) -> dict:
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout + proc.stderr
    return json.loads(lines[0])


def test_json_line_has_bench_keys(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="2", TMPDIR=str(tmp_path))
    jax_proc, jax_s = _run([sys.executable, "-c", BENCH_LAUNCHER,
                            str(tmp_path / "jax_cache")] + TINY, env)
    port_proc, port_s = _run([sys.executable, "-m",
                              "manticoresearch_tpu_torch.tools.bench",
                              "--device", "cpu"] + TINY, env)
    print(f"bench.py {jax_s:.1f} s, the port's bench {port_s:.1f} s")
    assert jax_proc.returncode == 0, jax_proc.stderr
    assert port_proc.returncode == 0, port_proc.stderr
    jax_out, port_out = _line(jax_proc), _line(port_proc)
    assert "error" not in jax_out and "error" not in port_out
    assert jax_out["recall_at_10"] == port_out["recall_at_10"] == 1.0
    assert port_out["device"] == {"name": "cpu", "power_limit": None,
                                  "count": 1}
    assert "5_distributed_1shard" in port_out["configs"]
    assert all(v is not None for v in port_out["configs"].values())
    assert all(v is not None for v in port_out["scale"]["6k_docs"].values())
    port_keys, jax_keys = _key_tree(port_out), _key_tree(jax_out)
    del port_keys["device"]
    if not ("warnings" in port_keys and "warnings" in jax_keys):
        port_keys.pop("warnings", None)
        jax_keys.pop("warnings", None)
    assert port_keys == jax_keys
    assert port_out["metric"] == jax_out["metric"]
    assert port_out["unit"] == jax_out["unit"] == "qps"


def test_perturbed_weight_fails_the_gate(monkeypatch, capsys):
    search, timed = SearchIndex.search, []

    def off_by_one(self, q):
        r = search(self, q)
        if r.matches and not off_by_one.done:
            r.matches[0].weight += 1
            off_by_one.done = True
        return r
    off_by_one.done = False
    monkeypatch.setattr(SearchIndex, "search", off_by_one)
    monkeypatch.setattr(SearchIndex, "search_batch",
                        lambda self, qs: timed.append(qs))
    rc = port_bench.main(["--device", "cpu"] + TINY)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and off_by_one.done and not timed
    assert out["error"].startswith("parity: recall@10 parity failed: ")
    assert out["configs"] == {} and out["value"] == 0.0
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "error",
                        "configs"}


def test_no_card_is_an_error_not_a_cpu_run():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="2")
    proc, _ = _run([sys.executable, "-m",
                    "manticoresearch_tpu_torch.tools.bench"] + TINY, env)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    out = _line(proc)
    assert out["error"].startswith("backend_init: torch.cuda.is_available()")
    assert out["configs"] == {} and "recall_at_10" not in out


def test_unreadable_nvidia_smi_is_an_error(monkeypatch, capsys):
    def no_smi():
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_bench, "smi_cards", no_smi)
    monkeypatch.setattr(port_bench, "build_corpus",
                        lambda *a: pytest.fail("a corpus was built"))
    rc = port_bench.main(TINY)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 1 and out["error"] == "run: nvidia-smi"
    assert out["configs"] == {} and "device" not in out


def test_short_deadline_gives_null_configs(capsys):
    rc = port_bench.main(["--device", "cpu", "--deadline", "1e-9"] + TINY)
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and out["recall_at_10"] == 1.0
    assert out["configs"] == {"1_single_term_bm25": None,
                              "2_boolean_filters": None,
                              "3_phrase_proximity": None,
                              "4_facet_groupby": None,
                              "5_distributed": None}
    assert out["scale"] == {"6k_docs": None}
    assert out["value"] == 0.0 and out["latency_ms"] == {}
    assert out["utilization"] == {}
    assert out["warnings"] == [
        "1_single_term_bm25: global deadline exhausted before this config "
        "ran",
        "2_boolean_filters: global deadline exhausted before this config "
        "ran",
        "3_phrase_proximity: global deadline exhausted before this config "
        "ran",
        "4_facet_groupby: global deadline exhausted before this config ran",
        "5_distributed: global deadline exhausted",
        "scale 6k: deadline exhausted before the corpus was built"]
