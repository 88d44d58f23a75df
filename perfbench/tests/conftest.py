"""Fixtures of the harness's tests: a copy of the benchmark's data files
with the configurations and the mix cut to a size the CPU runs in
seconds. Tests that need a card carry the ``card`` marker and look for one
in the ``card`` fixture."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SMALL_DOCS = 6000
SMALL_VOCAB = 3000
# bands whose every word has df >= 128, as every band word has at 1M
# documents: the port keeps such terms in the packed store
# (and enough High words that no two-word category runs out of new pairs)
SMALL_BANDS = {"high": [1, 24], "med": [25, 80], "low": [81, 240]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA card here: run on the card with "
                    "`python -m pytest perfbench/tests -m card`")


PLAIN = "text1m_plain.lucene_tasks"
# the same corpus as a distributed table of 4 shards, 2 on each of 2 parts:
# a configuration and a cell added to the small checkout by files alone
SHARDED = "text1m_sharded.lucene_tasks"


def small_base(dest: Path) -> Path:
    """A checkout root under ``dest`` holding BENCHMARK.json and the
    benchmark's data files, configurations and mix made small, and the
    sharded cell ``SHARDED``."""
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = dest / "perfbench" / "configs"
    for p in configs.glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(documents=SMALL_DOCS, vocabulary=SMALL_VOCAB)
        p.write_text(json.dumps(cfg))
    cfg = json.loads((configs / "text1m_plain.json").read_text())
    cfg.update(name="text1m_sharded", table="sharded", shards=4, cards=2)
    (configs / "text1m_sharded.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="text1m_sharded",
                                 file="perfbench/configs/text1m_sharded.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=SHARDED,
                                   config="text1m_sharded"))
    for m in bench["per_layer"]:
        m["workloads"].append(SHARDED)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    for p in (dest / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(bands=SMALL_BANDS, stream_queries_per_second=400,
                 warmup_requests=1, check_requests=4)
        p.write_text(json.dumps(t))
    return dest


@pytest.fixture(scope="session")
def base(tmp_path_factory) -> Path:
    return small_base(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Several test workers share the CPU: two threads each."""
    import torch
    torch.set_num_threads(2)
