"""The port imports neither jax nor the JAX package.

The machine with the GPU has no JAX installed, and the port stands on its
own: no module of ``manticoresearch_tpu_torch`` and not ``chip_smoke.py``
may import ``jax``, ``jaxlib``, ``manticoresearch_tpu`` (even a module of
it that does not import jax) or ``bench``, at any level of the file (an
AST scan of every import statement, function bodies included); nor may
``tests/_torch_golden.py``, which runs the golden harness on the port. The JAX
package's own import chain to jax is still computed from its module-level
imports, not from a hard-coded list. A subprocess in which importing any
of those names raises then imports the port and ``chip_smoke``, builds an
index with the port's builder and runs one query on the CPU, on one index,
on a two-shard ``ShardedIndex`` and on an RT table after an UPDATE and
OPTIMIZE; then a port ``Session(Catalog(device="cpu"))`` runs CREATE
TABLE, INSERT, a SELECT with MATCH, CALL PQ on a percolate table and a
SELECT on a local-only distributed table; then two port nodes (each a
``ClusterService`` on port 0) run CREATE / ALTER / JOIN CLUSTER and a
``cluster:table`` INSERT from the joiner, read back on the creator; then
a port ``Daemon(device="cpu")`` creates, fills and searches a table over
its HTTP listener's dispatch, and ``tools.replay`` replays a query log
against its data directory; last, ``tools.bench`` runs configs 1 and 5 on
the CPU at 2,000 documents (exit 0, ``recall_at_10`` 1.0).

Tolerance: exact (import graphs and docids).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
_JAX_ROOTS = ("jax", "jaxlib")
_FORBIDDEN_ROOTS = _JAX_ROOTS + ("manticoresearch_tpu", "bench")


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _files(pkg: str) -> list[Path]:
    return sorted((REPO / pkg).rglob("*.py"))


def _imports(path: Path, module_level_only: bool) -> set[str]:
    """Absolute names of the modules a file imports (with their parent
    packages, which an import executes too)."""
    name = _module_name(path)
    package = name if path.name == "__init__.py" else name.rpartition(".")[0]
    tree = ast.parse(path.read_text(), str(path))
    if module_level_only:
        nodes, todo = [], list(tree.body)
        while todo:   # statements run at import: not function bodies
            node = todo.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            nodes.append(node)
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo.extend(getattr(node, field, []) or [])
    else:
        nodes = list(ast.walk(tree))
    out: set[str] = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".")
                up = up[:len(up) - (node.level - 1)]
                base = ".".join(up + ([node.module] if node.module else []))
            mods = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for m in mods:
            parts = m.split(".")
            out.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
    return out


def _jax_reaching_modules() -> set[str]:
    """Modules of the JAX package (and bench.py) whose import runs jax."""
    files = _files("manticoresearch_tpu") + [REPO / "bench.py"]
    graph = {}
    for f in files:
        name = _module_name(f)
        deps = _imports(f, module_level_only=True)
        parts = name.split(".")
        deps |= {".".join(parts[:i]) for i in range(1, len(parts))}
        graph[name] = deps
    reach = {m for m, deps in graph.items()
             if any(d.split(".")[0] in _JAX_ROOTS for d in deps)}
    grew = True
    while grew:
        new = {m for m, deps in graph.items() if deps & reach} - reach
        reach |= new
        grew = bool(new)
    return reach


def test_jax_chain_is_computed():
    reach = _jax_reaching_modules()
    assert {"manticoresearch_tpu.ops.search", "manticoresearch_tpu.ops.pfor",
            "manticoresearch_tpu.exec.searcher",
            "manticoresearch_tpu.query.expr"} <= reach
    assert not {"manticoresearch_tpu.query.planner",
                "manticoresearch_tpu.index.builder",
                "manticoresearch_tpu.ops.packed_store", "bench"} & reach


def test_port_imports_nothing_that_reaches_jax():
    reach = _jax_reaching_modules()
    files = _files("manticoresearch_tpu_torch") + [
        REPO / "chip_smoke.py", REPO / "tests" / "_torch_golden.py"]
    assert len(files) >= 20
    port = REPO / "manticoresearch_tpu_torch"
    assert {port / "parallel" / "sharded.py", port / "index" / "rt.py",
            port / "index" / "storage.py", port / "index" / "merge.py",
            port / "index" / "docstore.py", port / "tools" / "indextool.py",
            port / "exec" / "qcache.py"} <= set(files)
    # the session layer
    assert {port / "exec" / "session.py", port / "exec" / "snippets.py",
            port / "exec" / "distributed.py", port / "query" / "sphinxql.py",
            port / "query" / "jsonquery.py", port / "index" / "percolate.py",
            port / "index" / "pqfilter.py", port / "config.py",
            port / "utils" / "uid.py", port / "server" / "agent.py",
            port / "server" / "__init__.py", port / "server" / "cluster.py",
            port / "server" / "repl.py",
            port / "tools" / "indexer.py"} <= set(files)
    # the native tokenizer's loader
    assert port / "native" / "__init__.py" in set(files)
    # the front ends
    assert {port / "server" / "mysql.py", port / "server" / "http.py",
            port / "server" / "api.py", port / "server" / "daemon.py",
            port / "tools" / "replay.py"} <= set(files)
    # the benchmark
    assert port / "tools" / "bench.py" in set(files)
    bad = {}
    for f in files:
        deps = _imports(f, module_level_only=False)
        hits = sorted(d for d in deps
                      if d.split(".")[0] in _FORBIDDEN_ROOTS or d in reach)
        if hits:
            bad[str(f.relative_to(REPO))] = hits
    assert not bad
    # the scan sees the imports it must refuse, function bodies included
    probe = REPO / "tests" / "test_torch_search.py"
    assert {"bench", "manticoresearch_tpu.exec.searcher"} <= _imports(
        probe, module_level_only=False)


_NO_JAX_SCRIPT = r'''
import importlib, importlib.abc, pkgutil, sys

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "manticoresearch_tpu",
                                  "bench"):
            raise ImportError("not importable here: " + name)
        return None

sys.meta_path.insert(0, _NoJax())
import chip_smoke  # noqa: F401  (module only; main() is not run)
import manticoresearch_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)

from manticoresearch_tpu_torch.index.builder import IndexBuilder
from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
from manticoresearch_tpu_torch.exec.searcher import SearchIndex, SearchQuery

b = IndexBuilder(Schema(fields=["title"],
                        attrs=[AttrDef("g", AttrType.UINT)]))
b.add_documents([dict(id=i + 1, g=i, title=t) for i, t in enumerate(
    ["red apple", "green apple pie", "blue sky", "apple apple"])])
r = SearchIndex(b.build(), "cpu").search(SearchQuery(match="apple"))
assert r.error is None, r.error

from manticoresearch_tpu_torch.parallel.sharded import ShardedIndex
shards = []
for part in (["red apple", "blue sky"], ["green apple pie", "apple apple"]):
    b = IndexBuilder(Schema(fields=["title"],
                            attrs=[AttrDef("g", AttrType.UINT)]))
    b.add_documents([dict(id=len(shards) * 2 + i + 1, g=i, title=t)
                     for i, t in enumerate(part)])
    shards.append(b.build())
rs = ShardedIndex(shards, "cpu").search(SearchQuery(match="apple"))
assert rs.error is None, rs.error
print("SHARDED", sorted(m.docid for m in rs.matches))

from manticoresearch_tpu_torch.index.rt import RtIndex
rt = RtIndex("t", Schema(fields=["title"], attrs=[AttrDef("g", AttrType.UINT)]),
             device="cpu")
for i, t in enumerate(["red apple", "blue sky", "apple apple"]):
    rt.insert(dict(id=i + 1, g=i, title=t))
    rt.commit()
rt.update_attrs([3], {"g": 9})
rt.optimize()
rr = rt.search(SearchQuery(match="apple"))
assert rr.error is None, rr.error
print("RT", sorted((m.docid, m.attrs["g"]) for m in rr.matches))
from manticoresearch_tpu_torch.exec.session import Catalog, Session
sess = Session(Catalog(device="cpu"))
for sql in [
        "CREATE TABLE t1 (title text, g uint)",
        "INSERT INTO t1 (id, title, g) VALUES (1, 'red apple', 1), "
        "(2, 'blue sky', 2), (3, 'apple apple', 3)",
        "CREATE TABLE t2 (title text, g uint)",
        "INSERT INTO t2 (id, title, g) VALUES (4, 'green apple pie', 4)",
        "CREATE TABLE d type='distributed' local='t1' local='t2'",
        "CREATE TABLE pq (title text, g uint) type='percolate'",
        "INSERT INTO pq (query) VALUES ('apple'), ('sky')"]:
    (res,) = sess.execute(sql)
    assert res.error is None, (sql, res.error)
(res,) = sess.execute("SELECT id FROM t1 WHERE MATCH('apple')")
assert res.error is None, res.error
print("SQL", sorted(row[0] for row in res.rows))
(res,) = sess.execute("CALL PQ('pq', ('blue sky above', 'an apple'), "
                      "1 AS docs, 0 AS docs_json)")
assert res.error is None, res.error
print("PQ", [row[1] for row in res.rows])
(res,) = sess.execute("SELECT id FROM d WHERE MATCH('apple')")
assert res.error is None, res.error
print("DIST", sorted(row[0] for row in res.rows))
import shutil, tempfile, time
from manticoresearch_tpu_torch.server.cluster import ClusterService
nodes = []
tmp = tempfile.mkdtemp()
for i in range(2):
    cat = Catalog(f"{tmp}/node{i}", device="cpu")
    svc = ClusterService(cat, port=0)
    svc.start()
    svc.port = svc._server.sockets[0].getsockname()[1]
    cat.cluster_service = svc
    nodes.append((cat, Session(cat), svc))
try:
    (ca, sa, svc_a), (cb, sb, _) = nodes
    for sql in ["CREATE TABLE ct (title text, g uint)", "CREATE CLUSTER cl",
                "ALTER CLUSTER cl ADD ct"]:
        (res,) = sa.execute(sql)
        assert res.error is None, (sql, res.error)
    (res,) = sb.execute(f"JOIN CLUSTER cl AT '127.0.0.1:{svc_a.port}'")
    assert res.error is None, res.error
    (res,) = sb.execute("INSERT INTO cl:ct (id, title, g) VALUES "
                        "(5, 'red apple', 1)")
    assert res.error is None, res.error
    t0 = time.monotonic()
    while ca.clusters["cl"].applied < 2 and time.monotonic() - t0 < 15:
        time.sleep(0.02)
    (res,) = sa.execute("SELECT id FROM ct WHERE MATCH('apple')")
    print("CLUSTER", [row[0] for row in res.rows])
finally:
    for _, _, svc in nodes:
        svc.stop()
    shutil.rmtree(tmp, ignore_errors=True)
import json, os
from manticoresearch_tpu_torch.server.api import ApiServer
from manticoresearch_tpu_torch.server.daemon import Daemon
from manticoresearch_tpu_torch.server.http import HttpServer
from manticoresearch_tpu_torch.server.mysql import MysqlServer
from manticoresearch_tpu_torch.tools import replay
tmp = tempfile.mkdtemp()
d = Daemon(os.path.join(tmp, "daemon"), device="cpu", api_port=0)
assert isinstance(d.mysql, MysqlServer) and isinstance(d.api, ApiServer)
status, _, body = d.http.handle_request(
    "POST", "/sql", {}, b"query=CREATE TABLE h (title text)")
assert status.startswith("200"), body
d.http.handle_request("POST", "/json/insert", {}, json.dumps(
    {"index": "h", "id": 7, "doc": {"title": "red apple"}}).encode())
status, _, body = d.http.handle_request("POST", "/json/search", {},
    json.dumps({"index": "h", "query": {"match": {"title": "apple"}}}
               ).encode())
print("HTTP", [h["_id"] for h in json.loads(body)["hits"]["hits"]])
with open(os.path.join(tmp, "q.log"), "w") as f:
    f.write("SELECT id FROM h WHERE MATCH('apple');\n")
rc = replay.main(["--log", os.path.join(tmp, "q.log"), "--data-dir",
                  os.path.join(tmp, "daemon"), "--device", "cpu", "--quiet"])
print("REPLAY", rc)
shutil.rmtree(tmp, ignore_errors=True)
import contextlib, io
from manticoresearch_tpu_torch.tools import bench
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = bench.main(["--device", "cpu", "--docs", "2000", "--vocab", "300",
                     "--avg-len", "20", "--batch", "8", "--batches", "1",
                     "--configs", "1,5", "--scale-docs", ""])
line = json.loads(buf.getvalue())
print("BENCH", rc, line["recall_at_10"], sorted(line["configs"]))
assert not [m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "manticoresearch_tpu", "bench")]
print("DOCIDS", sorted(m.docid for m in r.matches))
'''


def test_port_runs_where_jax_cannot_be_imported():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "DOCIDS [1, 2, 4]" in proc.stdout
    assert "SHARDED [1, 3, 4]" in proc.stdout
    assert "RT [(1, 0), (3, 9)]" in proc.stdout
    assert "SQL [1, 3]" in proc.stdout
    assert "PQ ['2', '1']" in proc.stdout
    assert "DIST [1, 3, 4]" in proc.stdout
    assert "CLUSTER [5]" in proc.stdout
    assert "HTTP [7]" in proc.stdout
    assert "REPLAY 0" in proc.stdout
    assert "BENCH 0 1.0 ['1_single_term_bm25', '5_distributed_1shard']" \
        in proc.stdout
