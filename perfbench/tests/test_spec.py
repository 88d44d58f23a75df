"""BENCHMARK.json against the contract's characters and keys, its files
found by name, a new mix added by files alone, and no JAX in a run."""
from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from perfbench import run, spec

from .conftest import ROOT, SHARDED

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    layers = [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = spec.cell(BENCH, workload)
    assert cell.config["name"] == workload.split(".")[0]
    assert cell.generator().generate and cell.system().build
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "qps"}
    assert cell.per_layer


def test_throwaway_mix_added_by_files_alone(base, tmp_path):
    """A new traffic file and a new workloads entry run without a change
    to any file of the harness."""
    traffic = json.loads(
        (base / "perfbench/traffic/lucene_tasks.json").read_text())
    traffic["tasks"] = [{"category": "LowTerm", "kind": "term",
                         "bands": ["low"], "count": 1}]
    traffic["filter"] = {"attr": "group_id", "range": [10, 40],
                         "share": 0.5}
    # single rare words run fast on a small table: a longer stream
    traffic["stream_queries_per_second"] = 4000
    (base / "perfbench/traffic/throwaway_terms.json").write_text(
        json.dumps(traffic))
    bench = spec.load(base)
    bench["workloads"].append({"name": "text1m_plain.throwaway_terms",
                               "config": "text1m_plain",
                               "traffic": "throwaway_terms", "chips": 1,
                               "why": "a test's throwaway mix"})
    cell = spec.cell(bench, "text1m_plain.throwaway_terms", base)
    out = run.run_cell(cell, 77, 0.5, False, "cpu", base)
    assert out["correct"], out["checked"]
    assert out["metrics"]["qps"]["value"] > 0


def test_no_jax_in_a_run(base):
    """A whole CPU run in a process of its own, then every loaded module's
    top-level name compared whole with JAX's and the JAX package's."""
    code = (
        "import sys, json; from pathlib import Path; "
        "from perfbench import run, spec; "
        f"b = Path({str(base)!r}); "
        f"c = spec.cell(spec.load(b), {SHARDED!r}, b); "
        "o = run.run_cell(c, 5, 0.5, True, 'cpu', b); "
        "print(json.dumps([o['correct'], run.forbidden_modules(), "
        "sorted({m.split('.')[0] for m in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, found, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and found == []
    assert "manticoresearch_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "manticoresearch_tpu"} & set(tops)


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_cell_runs_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 11), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
