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

CREATE CLUSTER and JOIN CLUSTER are left out: they import
``server.cluster``, which the port does not carry yet.

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
