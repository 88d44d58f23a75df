"""Port parity: replication and clusters, the JAX package vs the port.

The shapes of ``tests/test_replication.py`` (3 cases) and
``tests/test_cluster.py`` (4 cases), each run twice: once on JAX nodes
(``Catalog(data_dir)``, the JAX ``ReplicationServer`` / ``Replica`` /
``ClusterService``) and once on port nodes (``Catalog(data_dir,
device="cpu")`` and the port's copies in ``server/repl.py`` and
``server/cluster.py``), driven by the same statements in the same order.
Every ``QLResult`` of the two sides must be equal (``tests/_torch_twin``'s
``masked``; no field here is time-dependent), and so must the rows every
node answers, the ``applied`` sequence numbers of every replica and
cluster member, and SHOW STATUS's cluster rows.

One more case holds a fault of the JAX reference in both packages: a
member reads the sequencer's log one JSON line at a time with asyncio's
default 64 KiB limit, so a write set whose line is longer stops the
member's applier thread (ROADMAP queue 3).

Every service binds port 0 and the bound port is read back from its
socket (fixed ports clash across xdist workers); every service and
replica is stopped in a ``finally``, and every wait has a deadline.

Tolerance: exact (docids, integer attributes, sequence numbers, strings).
"""
import asyncio
import threading
import time

import jax
import pytest

from manticoresearch_tpu.exec import searcher as jax_searcher
from manticoresearch_tpu.exec import session as jax_session
from manticoresearch_tpu.index import rt as jax_rt
from manticoresearch_tpu.server import cluster as jax_cluster
from manticoresearch_tpu.server import repl as jax_repl
from manticoresearch_tpu_torch.exec import searcher as port_searcher
from manticoresearch_tpu_torch.exec import session as port_session
from manticoresearch_tpu_torch.index import rt as port_rt
from manticoresearch_tpu_torch.server import cluster as port_cluster
from manticoresearch_tpu_torch.server import repl as port_repl

from tests._torch_twin import assert_same

SIDES = ("jax", "port")
MODS = {"jax": (jax_session, jax_cluster, jax_repl, jax_rt, jax_searcher),
        "port": (port_session, port_cluster, port_repl, port_rt,
                 port_searcher)}
DEADLINE = 15.0


@pytest.fixture(autouse=True)
def _free_jax_programs():
    yield
    jax.clear_caches()


def _catalog(side, data_dir):
    sess = MODS[side][0]
    return (sess.Catalog(data_dir) if side == "jax"
            else sess.Catalog(data_dir, device="cpu"))


def _wait(pred, what, timeout=DEADLINE):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# --------------------------------------------------------------------------
# clusters (tests/test_cluster.py)
# --------------------------------------------------------------------------
class Node:
    def __init__(self, side, data_dir):
        sess, cl = MODS[side][:2]
        self.cat = _catalog(side, data_dir)
        self.svc = cl.ClusterService(self.cat, port=0)
        self.svc.start()
        self.svc.port = self.svc._server.sockets[0].getsockname()[1]
        self.cat.cluster_service = self.svc
        self.sess = sess.Session(self.cat)


@pytest.fixture()
def clusters(tmp_path):
    """Three JAX nodes and three port nodes; node 0 of each side is the
    one the others join."""
    nodes = {s: [] for s in SIDES}
    try:
        for s in SIDES:
            for i in range(3):
                nodes[s].append(Node(s, str(tmp_path / f"{s}{i}")))
        yield nodes
    finally:
        for s in SIDES:
            for n in nodes[s]:
                n.svc.stop()


def run(nodes, i, sql):
    """One statement on node i of each side ({addr} is that side's node 0):
    equal results; -> the JAX side's."""
    got = {}
    for s in SIDES:
        addr = f"127.0.0.1:{nodes[s][0].svc.port}"
        got[s] = nodes[s][i].sess.execute(sql.format(addr=addr))
    assert_same(got["jax"], got["port"], sql)
    return got["jax"]


def converge(nodes, name, members=(0, 1, 2)):
    """Every member of each side has applied its side's last sequence
    number; the two sides' sequence numbers are equal."""
    applied = {}
    for s in SIDES:
        cats = [nodes[s][i].cat for i in members]
        seq = max(c.clusters[name].applied for c in cats)
        _wait(lambda: all(c.clusters[name].applied >= seq for c in cats),
              f"{s} cluster {name} at seq {seq}")
        applied[s] = [c.clusters[name].applied for c in cats]
    assert applied["jax"] == applied["port"]
    return applied["jax"]


def rows_everywhere(nodes, sql):
    """The rows of one SELECT on every node of both sides: all equal."""
    want = None
    for i in range(3):
        (r,) = run(nodes, i, sql)
        assert r.error is None, r.error
        want = r.rows if want is None else want
        assert r.rows == want, (i, r.rows, want)
    return want


def test_three_node_convergence(clusters):
    for sql in ["CREATE TABLE t (body text, gid uint)",
                "CREATE CLUSTER posts",
                "ALTER CLUSTER posts ADD t",
                "INSERT INTO posts:t (id, body, gid) VALUES (1, 'seed', 1)"]:
        (r,) = run(clusters, 0, sql)
        assert r.error is None, (sql, r.error)
    for i in (1, 2):     # JOIN must SST the seed row over
        (r,) = run(clusters, i, "JOIN CLUSTER posts AT '{addr}'")
        assert r.error is None, r.error
    for i, (docid, body) in ((1, (2, "from b")), (2, (3, "from c")),
                             (0, (4, "from a"))):
        (r,) = run(clusters, i, f"INSERT INTO posts:t (id, body, gid) "
                                f"VALUES ({docid}, '{body}', {docid})")
        assert r.error is None, r.error
    assert converge(clusters, "posts") == [5, 5, 5]
    assert rows_everywhere(clusters, "SELECT id, gid FROM t ORDER BY id "
                                     "ASC") == [(1, 1), (2, 2), (3, 3), (4, 4)]
    assert [r[0] for r in rows_everywhere(
        clusters, "SELECT id FROM t WHERE MATCH('seed')")] == [1]


def test_conflicting_writes_certify_identically(clusters):
    for sql in ["CREATE TABLE t (body text, gid uint)", "CREATE CLUSTER c2",
                "ALTER CLUSTER c2 ADD t"]:
        run(clusters, 0, sql)
    for i in (1, 2):
        (r,) = run(clusters, i, "JOIN CLUSTER c2 AT '{addr}'")
        assert r.error is None, r.error
    # the same id REPLACEd from two nodes: the later sequence number wins
    # everywhere
    run(clusters, 1, "REPLACE INTO c2:t (id, body, gid) "
                     "VALUES (7, 'b wins?', 20)")
    run(clusters, 2, "REPLACE INTO c2:t (id, body, gid) "
                     "VALUES (7, 'c wins?', 30)")
    converge(clusters, "c2")
    assert rows_everywhere(clusters, "SELECT gid FROM t WHERE id=7") == [
        (30,)]
    run(clusters, 0, "UPDATE c2:t SET gid=99 WHERE id=7")
    converge(clusters, "c2")
    assert rows_everywhere(clusters, "SELECT gid FROM t WHERE id=7") == [
        (99,)]
    run(clusters, 1, "DELETE FROM c2:t WHERE id=7")
    assert converge(clusters, "c2") == [5, 5, 5]
    assert rows_everywhere(clusters, "SELECT gid FROM t WHERE id=7") == []


def test_plain_write_into_clustered_table_rejected(clusters):
    for sql in ["CREATE TABLE t (body text)", "CREATE CLUSTER c3",
                "ALTER CLUSTER c3 ADD t"]:
        run(clusters, 0, sql)
    (r,) = run(clusters, 0, "INSERT INTO t (id, body) VALUES (1, 'x')")
    assert r.error and "c3:t" in r.error


def test_cluster_status(clusters):
    for sql in ["CREATE TABLE t (body text)", "CREATE CLUSTER c4",
                "ALTER CLUSTER c4 ADD t"]:
        run(clusters, 0, sql)
    (r,) = run(clusters, 1, "JOIN CLUSTER c4 AT '{addr}'")
    assert r.error is None, r.error
    assert converge(clusters, "c4", members=(0, 1)) == [1, 1]
    for i in (0, 1):
        (r,) = run(clusters, i, "SHOW STATUS LIKE 'cluster_c4%'")
        assert "cluster_c4_node_state" in {row[0] for row in r.rows}


def test_long_write_set_stops_a_members_applier(clusters, monkeypatch):
    """A write set over 64 KiB on the sequencer: applied there, and in both
    packages the member's applier stops on the long line (ValueError) and
    stays at its last sequence number."""
    stopped = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: stopped.append(args.exc_type))
    for sql in ["CREATE TABLE t (body text)", "CREATE CLUSTER c5",
                "ALTER CLUSTER c5 ADD t"]:
        run(clusters, 0, sql)
    (r,) = run(clusters, 1, "JOIN CLUSTER c5 AT '{addr}'")
    assert r.error is None, r.error
    assert converge(clusters, "c5", members=(0, 1)) == [1, 1]
    body = " ".join(f"w{i % 997}" for i in range(20_000))   # about 110 KB
    (r,) = run(clusters, 0, f"INSERT INTO c5:t (id, body) VALUES "
                            f"(1, '{body}')")
    assert r.error is None, r.error
    for s in SIDES:
        member = clusters[s][1].cat.clusters["c5"]
        _wait(lambda: not member._applier.is_alive(), f"{s} applier stop")
        assert clusters[s][0].cat.clusters["c5"].applied == 2
        assert member.applied == 1
    assert stopped == [ValueError, ValueError]


# --------------------------------------------------------------------------
# primary -> replica binlog shipping (tests/test_replication.py)
# --------------------------------------------------------------------------
class Primary:
    """A catalog with table t and a ReplicationServer on port 0 in its own
    event-loop thread."""

    def __init__(self, side, data_dir):
        sess, _, repl = MODS[side][:3]
        self.side = side
        self.cat = _catalog(side, data_dir)
        self.sess = sess.Session(self.cat)
        self.sess.execute("CREATE TABLE t (body text, grp uint)")
        self.loop = asyncio.new_event_loop()
        self.srv = repl.ReplicationServer(self.cat, port=0)
        started = threading.Event()

        def serve():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.srv.start())
            self.port = self.srv._server.sockets[0].getsockname()[1]
            started.set()
            self.loop.run_forever()
        self.thread = threading.Thread(target=serve, daemon=True)
        self.thread.start()
        assert started.wait(10)

    def stop(self):
        # close the listener and stop the loop; a tailing handler never
        # returns by itself, so Server.wait_closed is not awaited
        self.loop.call_soon_threadsafe(self.srv._server.close)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture()
def primaries(tmp_path):
    prims = {}
    try:
        for s in SIDES:
            prims[s] = Primary(s, str(tmp_path / f"primary_{s}"))
        yield prims
    finally:
        for p in prims.values():
            p.stop()


def primary_sql(prims, sql):
    got = {s: prims[s].sess.execute(sql) for s in SIDES}
    assert_same(got["jax"], got["port"], sql)


def replica_rows(sessions, sql):
    got = {s: sessions[s].execute(sql) for s in SIDES}
    assert_same(got["jax"], got["port"], sql)
    assert got["jax"][0].error is None, got["jax"][0].error
    return sorted(got["jax"][0].rows)


def _replica_catalogs(tmp_path, name):
    cats, sessions = {}, {}
    for s in SIDES:
        cats[s] = _catalog(s, str(tmp_path / f"{name}_{s}"))
        sessions[s] = MODS[s][0].Session(cats[s])
        sessions[s].execute("CREATE TABLE t (body text, grp uint)")
    return cats, sessions


def _wait_applied(reps, n):
    for s in SIDES:
        _wait(lambda: reps[s].applied >= n or reps[s].error,
              f"{s} replica at {n}")
        assert reps[s].error is None, reps[s].error
    assert reps["jax"].applied == reps["port"].applied == n


def test_stream_and_catchup(primaries, tmp_path):
    # writes before the replica exists (catch-up)
    for sql in ["INSERT INTO t (id, body, grp) VALUES (1, 'aa bb', 1)",
                "INSERT INTO t (id, body, grp) VALUES (2, 'aa cc', 2)"]:
        primary_sql(primaries, sql)
    cats, sessions = _replica_catalogs(tmp_path, "replica")
    reps = {s: MODS[s][2].Replica(cats[s].get("t"), "127.0.0.1",
                                  primaries[s].port) for s in SIDES}
    try:
        for r in reps.values():
            r.start()
        _wait_applied(reps, 2)
        assert replica_rows(sessions, "SELECT id FROM t WHERE "
                                      "MATCH('aa')") == [(1,), (2,)]
        # live writes: insert, update, delete
        for sql in ["INSERT INTO t (id, body, grp) VALUES (3, 'aa dd', 3)",
                    "UPDATE t SET grp=9 WHERE id=1",
                    "DELETE FROM t WHERE id=2"]:
            primary_sql(primaries, sql)
        _wait_applied(reps, 5)
        assert replica_rows(sessions, "SELECT id, grp FROM t WHERE "
                                      "MATCH('aa')") == [(1, 9), (3, 3)]
    finally:
        for r in reps.values():
            r.stop()


def test_replica_restart_resumes(primaries, tmp_path):
    primary_sql(primaries, "INSERT INTO t (id, body, grp) VALUES "
                           "(1, 'xx', 1)")
    cats, _ = _replica_catalogs(tmp_path, "replica2")
    reps = {s: MODS[s][2].Replica(cats[s].get("t"), "127.0.0.1",
                                  primaries[s].port) for s in SIDES}
    try:
        for r in reps.values():
            r.start()
        _wait_applied(reps, 1)
    finally:
        for r in reps.values():
            r.stop()
    # reopen from disk: local WAL replay, then resume from offset 1
    cats2 = {s: _catalog(s, str(tmp_path / f"replica2_{s}")) for s in SIDES}
    assert cats2["jax"].get("t").n_docs == cats2["port"].get("t").n_docs == 1
    primary_sql(primaries, "INSERT INTO t (id, body, grp) VALUES "
                           "(2, 'xx yy', 2)")
    reps2 = {s: MODS[s][2].Replica(cats2[s].get("t"), "127.0.0.1",
                                   primaries[s].port) for s in SIDES}
    try:
        for r in reps2.values():
            r.applied = 1
            r.start()
        _wait_applied(reps2, 2)
        sessions = {s: MODS[s][0].Session(cats2[s]) for s in SIDES}
        assert replica_rows(sessions, "SELECT id FROM t WHERE "
                                      "MATCH('xx')") == [(1,), (2,)]
    finally:
        for r in reps2.values():
            r.stop()


def test_replica_joins_via_snapshot(primaries, tmp_path):
    """An empty replica joins after FLUSH truncated the primary's binlog:
    only the snapshot transfer gives the full state."""
    for i in range(1, 6):
        primary_sql(primaries, f"INSERT INTO t (id, body, grp) VALUES "
                               f"({i}, 'early doc {i}', 1)")
    primary_sql(primaries, "FLUSH TABLE t")
    for i in range(6, 9):
        primary_sql(primaries, f"INSERT INTO t (id, body, grp) VALUES "
                               f"({i}, 'late doc {i}', 2)")
    tables, reps = {}, {}
    for s in SIDES:
        prim_t = primaries[s].cat.get("t")
        kw = {} if s == "jax" else {"device": "cpu"}
        tables[s] = MODS[s][3].RtIndex(
            "t", prim_t.schema, prim_t.tok_settings, prim_t.dict_settings,
            data_dir=str(tmp_path / f"replica_sst_{s}"), **kw)
        reps[s] = MODS[s][2].Replica(tables[s], "127.0.0.1",
                                     primaries[s].port, sst=True)

    def found(match):
        out = {}
        for s in SIDES:
            q = MODS[s][4].SearchQuery(match=match, limit=10)
            out[s] = sorted(m.docid for m in tables[s].search(q).matches)
        assert out["jax"] == out["port"], match
        return out["jax"]
    try:
        for r in reps.values():
            r.start()
        for s in SIDES:
            _wait(lambda: tables[s].n_docs == 8 or reps[s].error,
                  f"{s} snapshot")
            assert reps[s].error is None, reps[s].error
        assert reps["jax"].applied == reps["port"].applied
        assert found("early") == [1, 2, 3, 4, 5]
        assert found("late") == [6, 7, 8]
        primary_sql(primaries, "INSERT INTO t (id, body, grp) VALUES "
                               "(9, 'fresh doc', 3)")
        for s in SIDES:
            _wait(lambda: tables[s].n_docs == 9, f"{s} stream after SST")
        assert reps["jax"].applied == reps["port"].applied
        assert found("fresh") == [9]
    finally:
        for r in reps.values():
            r.stop()
