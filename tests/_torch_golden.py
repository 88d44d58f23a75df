"""Run the reference's golden test cases through the port.

The golden harness (``tests/golden``) imports ``manticoresearch_tpu.*``
inside its functions. In this process those names resolve to the port:
a meta-path finder maps ``manticoresearch_tpu`` and every
``manticoresearch_tpu.<sub>`` to the very module object of
``manticoresearch_tpu_torch.<sub>`` (so ``isinstance`` checks and module
state such as the ``utils/uid.py`` counter are one with the port's own
imports), and importing ``jax``, ``jaxlib`` or ``bench`` raises. The
port's constructors that the harness calls without a device get "cpu" as
their default here, in this process only.

    python -m tests._torch_golden [--root DIR] CASE ...
        runs each case as ``tests/test_golden.py`` does, against its
        recorded ``model.bin``, and prints one JSON line per case:
        ``{"case", "passed", "failures" (the first 3), "seconds"}``. A case
        gets ``CASE_SECONDS``; past that it fails.
    python -m tests._torch_golden --root DIR --dump FILE CASE ...
        runs every query of every subtest of each case (no model) and
        pickles the shaped results, ``{case: [[result, ...], ...]}``, to
        FILE, to be held against the JAX package's.
    python -m tests._torch_golden --alias MODULE:NAME ...
        prints one JSON object: each name as the port's object or not.

Every run ends by checking that each loaded ``manticoresearch_tpu*``
module is the port's and that no JAX module was loaded after start-up.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.abc
import importlib.machinery
import json
import pickle
import signal
import sys
import tempfile
import time

JAX_PKG = "manticoresearch_tpu"
PORT_PKG = "manticoresearch_tpu_torch"
BLOCKED = ("jax", "jaxlib", "bench")
CASE_SECONDS = 120.0      # tests/golden/scan.py's time_budget
TORCH_THREADS = 2         # leave the cores to the JAX golden run beside it


def port_name(name: str) -> str:
    return PORT_PKG + name[len(JAX_PKG):]


class PortAlias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``manticoresearch_tpu[.<sub>]`` is ``manticoresearch_tpu_torch[.<sub>]``;
    ``jax``, ``jaxlib`` and ``bench`` cannot be imported."""

    def __init__(self):
        self._specs: dict = {}

    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in BLOCKED:
            raise ImportError(f"not importable here: {name}")
        if root != JAX_PKG:
            return None
        port = importlib.import_module(port_name(name))
        return importlib.machinery.ModuleSpec(
            name, self, is_package=hasattr(port, "__path__"))

    def create_module(self, spec):
        module = importlib.import_module(port_name(spec.name))
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias's spec on the port's module
        module.__spec__ = self._specs.pop(module.__spec__.name)


def install() -> set:
    """Install the alias, make "cpu" the port's default device; returns
    the JAX modules loaded before (by the interpreter's start-up)."""
    before = {m for m in sys.modules if m.split(".")[0] in BLOCKED[:2]}
    sys.meta_path.insert(0, PortAlias())
    import torch

    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    from manticoresearch_tpu_torch.exec.session import Catalog
    from manticoresearch_tpu_torch.index import rt
    from manticoresearch_tpu_torch.index.percolate import PercolateIndex
    from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
    from manticoresearch_tpu_torch.server.daemon import Daemon

    torch.set_num_threads(TORCH_THREADS)
    for fn in (SearchIndex.__init__, Catalog.__init__, rt.RtIndex.__init__,
               rt.rt_from_packed, PercolateIndex.__init__,
               ShardedIndex.__init__, Daemon.__init__):
        fn.__defaults__ = tuple("cpu" if d == "cuda" else d
                                for d in fn.__defaults__)
    return before


def check_modules(before: set) -> None:
    """Every loaded ``manticoresearch_tpu*`` module is the port's; no JAX
    module came in after start-up."""
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == JAX_PKG:
            if mod is not sys.modules.get(port_name(name)):
                raise AssertionError(f"{name} is not the port's module")
    late = {m for m in sys.modules
            if m.split(".")[0] in BLOCKED} - before
    if late:
        raise AssertionError(f"loaded here: {sorted(late)[:5]}")


class CaseTimeout(BaseException):
    """Raised by the alarm; not an ``Exception``, so that no handler of the
    engine or the harness takes it for a query's error."""


def _on_alarm(signum, frame):
    raise CaseTimeout(f"cut at {CASE_SECONDS:.0f} s")


def run_case(dirname: str, root: str) -> dict:
    """One golden case against its model, as ``tests/test_golden.py``."""
    from tests.golden.phpser import load_model
    from tests.golden.runner import run_subtest
    from tests.golden.testcase import load_test

    t0 = time.perf_counter()
    failures: list[str] = []
    signal.setitimer(signal.ITIMER_REAL, CASE_SECONDS)
    try:
        gt = load_test(dirname, root=root)
        model = load_model(f"{root}/{dirname}/model.bin")
        n = min(gt.n_subtests, len(model))
        if n == 0:
            failures.append("no subtest")
        with tempfile.TemporaryDirectory() as td:
            for st in range(n):
                if gt.has_custom:
                    from tests.golden.phpcustom import run_custom_subtest
                    fails = run_custom_subtest(gt, st, model[st], td)
                else:
                    fails = run_subtest(gt, st, model[st], td)
                failures.extend(f"subtest {st}: {f}" for f in fails)
                if failures:
                    break
    except (Exception, CaseTimeout) as e:   # the case fails with its reason
        failures.append(f"{type(e).__name__}: {e}"[:2000])
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
    return {"case": dirname, "passed": not failures,
            "failures": failures[:3],
            "seconds": round(time.perf_counter() - t0, 3)}


def dump_case(dirname: str, root: str) -> list:
    """Every shaped result of every subtest of a case, in model order."""
    from tests.golden.runner import GoldenEnv
    from tests.golden.testcase import load_test
    from manticoresearch_tpu_torch.utils import uid

    gt = load_test(dirname, root=root)
    out = []
    for st in range(gt.n_subtests):
        uid.reset()
        with tempfile.TemporaryDirectory() as td:
            env = GoldenEnv(gt, st, td)
            out.append([r for q in gt.queries if q.type != "comment"
                        for r in env.run_query(q)])
    return out


def _from_import(module: str, name: str):
    """What ``from module import name`` binds."""
    mod = importlib.import_module(module)
    if not hasattr(mod, name):
        importlib.import_module(f"{module}.{name}")
    return getattr(mod, name)


def check_alias(pairs: list[str]) -> dict:
    """``MODULE:NAME`` -> whether it binds the port's own object."""
    out = {}
    for pair in pairs:
        mod, _, name = pair.partition(":")
        out[pair] = _from_import(mod, name) is _from_import(port_name(mod),
                                                            name)
    return out


def main(argv: list[str]) -> int:
    from tests.golden.testcase import TESTROOT

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=TESTROOT)
    ap.add_argument("--dump")
    ap.add_argument("--alias", action="store_true")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    before = install()
    signal.signal(signal.SIGALRM, _on_alarm)
    if args.alias:
        print(json.dumps(check_alias(args.names)), flush=True)
    elif args.dump:
        with open(args.dump, "wb") as f:
            pickle.dump({c: dump_case(c, args.root) for c in args.names}, f)
    else:
        for case in args.names:
            print(json.dumps(run_case(case, args.root)), flush=True)
    check_modules(before)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
