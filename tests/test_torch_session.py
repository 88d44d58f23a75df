"""Port parity: the SphinxQL session layer, JAX ``Session`` vs the port's.

Every case of ``tests/test_sphinxql.py`` runs here again with that
module's ``Session`` and ``Catalog`` replaced by the twins of
``tests/_torch_twin.py``: each statement goes to a JAX
``Session(Catalog())`` and to the port's ``Session(Catalog(device="cpu"))``,
every ``QLResult`` of the two must be equal (columns, rows, error,
warning, affected; SHOW META included), and the case's own assertions
then run on the JAX package's results. The only masked fields are the
time fields that ``tests/_torch_twin.py`` names (SHOW META ``time``, SHOW
STATUS ``uptime``, SHOW THREADS and SHOW PROFILE times).

The SELECT, GROUP BY and write-path classes run again under
``MT_SPARSE`` never and always (dense and sparse candidate plans). A
catalog with a ``data_dir`` is written, closed and reopened: the
manifest, a snapshot (FLUSH RAMCHUNK) and the binlog after it, for an
RT, a percolate and a distributed table.

The cluster statements run too: CREATE / JOIN CLUSTER without a cluster
service and JOIN without AT (the same errors), then two nodes of each
package, each a ``ClusterService`` on port 0 (``tests/test_torch_cluster``'s
``Node``): CREATE CLUSTER, ALTER CLUSTER ... ADD, ``cluster:table``
writes from both nodes, JOIN CLUSTER (to each package's own first node),
SHOW STATUS, ALTER CLUSTER ... DROP and DELETE CLUSTER, every result equal.

Tolerance: exact. Weights are integers; float columns come from each
package's own code on the same float32 values.
"""
import json
import os

import jax
import pytest

import tests.test_sphinxql as base
from tests._torch_twin import TwinCatalog, TwinSession, port_dir
from tests.test_sphinxql import (  # noqa: F401  (collected again here)
    TestAdmin, TestAggregateExtras, TestAlterTable, TestAutocomplete,
    TestBigintIds, TestCollation, TestCreateTableOptions,
    TestCutoffAndShowTables, TestDDL, TestImplicitAggregation,
    TestJsonGroupBy, TestJsonOrderBy, TestQueryCache, TestQueryTransforms,
    TestSelect, TestStringJsonAttrs, TestTokenFilterPlugins,
    TestUdfAndPlan, TestWrites, loaded, sess)


@pytest.fixture(autouse=True)
def _twins(monkeypatch):
    """The module under test builds its sessions through the twins; JAX's
    compiled programs are freed after each case (a program per plan
    shape and segment size, see ``tests/test_torch_rt.py``)."""
    monkeypatch.setattr(base, "Session", TwinSession)
    monkeypatch.setattr(base, "Catalog", TwinCatalog)
    yield
    jax.clear_caches()


def _sparse(mode):
    @pytest.fixture(autouse=True)
    def _mt_sparse(self, monkeypatch):
        monkeypatch.setenv("MT_SPARSE", mode)
    return _mt_sparse


class TestSelectSparseNever(TestSelect):
    _mt_sparse = _sparse("never")


class TestSelectSparseAlways(TestSelect):
    _mt_sparse = _sparse("always")


class TestWritesSparseNever(TestWrites):
    _mt_sparse = _sparse("never")


class TestWritesSparseAlways(TestWrites):
    _mt_sparse = _sparse("always")


class TestAggregateExtrasSparseNever(TestAggregateExtras):
    _mt_sparse = _sparse("never")


class TestAggregateExtrasSparseAlways(TestAggregateExtras):
    _mt_sparse = _sparse("always")


class TestImplicitAggregationSparseNever(TestImplicitAggregation):
    _mt_sparse = _sparse("never")


class TestImplicitAggregationSparseAlways(TestImplicitAggregation):
    _mt_sparse = _sparse("always")


class TestJsonGroupBySparseNever(TestJsonGroupBy):
    _mt_sparse = _sparse("never")


class TestJsonGroupBySparseAlways(TestJsonGroupBy):
    _mt_sparse = _sparse("always")


_SELECTS = [
    "SELECT id, WEIGHT(), gid FROM rt WHERE MATCH('apple') ORDER BY id ASC",
    "SELECT gid, COUNT(*), SUM(price) FROM rt GROUP BY gid ORDER BY gid ASC",
    "SELECT id, gid FROM rt WHERE gid > 1 ORDER BY id ASC",
    "SHOW META",
    "SELECT * FROM pq",
    "CALL PQ('pq', ('{\"body\": \"red apple\", \"gid\": 7}', "
    "'{\"body\": \"blue sky\", \"gid\": 1}'), 1 AS docs, 1 AS docs_json)",
    "SELECT id, WEIGHT() FROM dist WHERE MATCH('apple | sky') "
    "ORDER BY id ASC",
    "SHOW TABLES",
    "DESC rt",
    "SHOW TABLE rt STATUS",
]


@pytest.mark.parametrize("flush", [False, True])
def test_reopen_data_dir(tmp_path, flush):
    """Manifest, snapshot and binlog: a catalog written, then reopened
    from its files, answers as the JAX package's reopened catalog does
    (both before and after the reopen), and both manifests list the same
    tables, schemas and options."""
    d = str(tmp_path / "data")
    s = TwinSession(TwinCatalog(d))
    for sql in [
            "CREATE TABLE rt (body text, gid uint, price float) "
            "morphology='stem_en'",
            "INSERT INTO rt (id, body, gid, price) VALUES "
            "(1, 'red apple', 1, 1.5), (2, 'green apples', 2, 2.25), "
            "(3, 'blue sky', 3, 0.5)",
            "CREATE TABLE pq (body text, gid uint) type='percolate'",
            "INSERT INTO pq (query, filters) VALUES ('apple', 'gid > 5'), "
            "('sky', '')",
            "CREATE TABLE dist type='distributed' local='rt'",
            "SET GLOBAL qcache_thresh_msec=0"]:
        s.execute(sql)
    if flush:
        s.execute("FLUSH RAMCHUNK rt")
    for sql in [
            "INSERT INTO rt (id, body, gid, price) VALUES "
            "(4, 'apple pie', 2, 3.0)",
            "UPDATE rt SET gid = 9 WHERE id = 2",
            "DELETE FROM rt WHERE id = 3",
            "REPLACE INTO rt (id, body, gid, price) VALUES "
            "(1, 'red apple tree', 5, 1.75)"]:
        s.execute(sql)
    for q in _SELECTS:
        s.execute(q)
    s.close()
    for t in list(s.twin_catalog.jax.tables.values()) + \
            list(s.twin_catalog.port.tables.values()):
        if getattr(t, "_binlog", None):
            t._binlog.close()
    with open(os.path.join(d, "catalog.json")) as f:
        man_jax = json.load(f)
    with open(os.path.join(port_dir(d), "catalog.json")) as f:
        man_port = json.load(f)
    assert man_jax == man_port
    s2 = TwinSession(TwinCatalog(d))
    for q in _SELECTS:
        s2.execute(q)
    s2.close()


def test_cluster_statements_without_a_service():
    """No cluster service on the catalog: the same errors."""
    s = TwinSession()
    for sql in ["CREATE TABLE t (body text)", "CREATE CLUSTER c",
                "JOIN CLUSTER c AT '127.0.0.1:1'", "DELETE CLUSTER c",
                "ALTER CLUSTER c ADD t", "INSERT INTO c:t (id, body) "
                "VALUES (1, 'x')"]:
        s.execute(sql)


def test_cluster_statements_match_jax(tmp_path):
    """CREATE / JOIN / ALTER / DELETE CLUSTER and cluster:table writes on
    two nodes of each package: every result equal, the same rows on every
    node and the same sequence numbers."""
    from tests.test_torch_cluster import SIDES, Node, converge, run
    nodes = {side: [] for side in SIDES}
    try:
        for side in SIDES:
            for i in range(2):
                nodes[side].append(Node(side, str(tmp_path / f"{side}{i}")))
        steps = [
            (0, "CREATE TABLE t (body text, gid uint)"),
            (0, "CREATE CLUSTER c"),
            (0, "ALTER CLUSTER c ADD t"),
            (0, "INSERT INTO c:t (id, body, gid) VALUES (1, 'red apple', 1), "
                "(2, 'green apple', 2)"),
            (0, "INSERT INTO t (id, body, gid) VALUES (3, 'x', 3)"),
            (1, "JOIN CLUSTER c AT '{addr}'"),
            (1, "REPLACE INTO c:t (id, body, gid) VALUES (2, 'blue sky', 5)"),
            (0, "UPDATE c:t SET gid = 7 WHERE id = 1"),
            (1, "INSERT INTO c:t (id, body, gid) VALUES (4, 'apple pie', 4)")]
        for i, sql in steps:
            run(nodes, i, sql)
        assert converge(nodes, "c", members=(0, 1)) == [5, 5]
        for i in (0, 1):
            for sql in ["SELECT id, gid FROM t ORDER BY id ASC",
                        "SELECT id FROM t WHERE MATCH('apple') ORDER BY id "
                        "ASC", "SHOW STATUS LIKE 'cluster_c_%'",
                        "SHOW TABLES"]:
                (r,) = run(nodes, i, sql)
                assert r.error is None, (sql, r.error)
        (r,) = run(nodes, 0, "SELECT id, gid FROM t ORDER BY id ASC")
        assert r.rows == [(1, 7), (2, 5), (4, 4)]
        for i, sql in [(1, "ALTER CLUSTER c DROP t"),
                       (1, "INSERT INTO t (id, body, gid) VALUES (9, 'z', 9)"),
                       (0, "DELETE CLUSTER c"),
                       (0, "DELETE CLUSTER c"),
                       (0, "INSERT INTO t (id, body, gid) VALUES (9, 'z', 9)"),
                       (0, "SELECT id FROM t ORDER BY id ASC")]:
            run(nodes, i, sql)
    finally:
        for side in SIDES:
            for n in nodes[side]:
                n.svc.stop()
