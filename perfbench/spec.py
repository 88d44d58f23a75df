"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is ``configs[].file``, the mix's is
``traffic/<traffic>.json``, the mix's generator ``generators/<generator>.py``,
the configuration's table ``systems/<table>.py``, and every metric's
reader ``metrics/<name>.py``. Adding a configuration, a mix or a metric is
adding files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list

    def generator(self):
        return importlib.import_module(
            f"perfbench.generators.{self.traffic['generator']}")

    def system(self):
        return importlib.import_module(
            f"perfbench.systems.{self.config['table']}")


def load(base: Path = ROOT) -> dict:
    return json.loads((base / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str, base: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench``, its files read under ``base`` (the
    checkout's root)."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((base / c["file"]).read_text())
    traffic = json.loads((base / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def reader(metric: str, base: Path = ROOT):
    """The ``read(ctx)`` of ``perfbench/metrics/<metric>.py`` under
    ``base``."""
    path = base / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
