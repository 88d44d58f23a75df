"""Port parity: the daemon's listeners and the daemon, JAX vs the port.

Every case of ``tests/test_servers.py`` (31) runs again here in twin form:
a JAX listener and the port's copy (``manticoresearch_tpu_torch/server``)
over twin catalogs (``tests/_torch_twin.py``: a JAX ``Catalog`` and the
port's ``Catalog(device="cpu")``) seeded by the same statements, every
server bound to port 0 with its port read back. Each request goes to
both; the answers must be equal, with only time fields masked by name
(``tests/_torch_wire.py``), and the case's own assertions run on the JAX
package's. The rest of the cases hold the port's sessions, catalogs and
watchdog equal to the JAX package's doing the same steps:

- HTTP by direct dispatch and over a socket; MySQL over the wire, with
  TLS, compression and both; the logged fault of a statement; the HTTP
  percolate flow; the FACET multi-result; the handshake's sysvars;
  rotation, RELOAD and IMPORT TABLE, SHOW THREADS; SET GLOBAL; the
  kill-list target; the watchdog's restart of a crashed child.

Added for the port:
- the watchdog starts ``-m manticoresearch_tpu_torch.server.daemon`` with
  the caller's arguments, ``--device`` kept;
- ``Daemon(config=..., device="cpu")`` loads a plain index named in a
  TOML config onto the CPU, equal to the JAX daemon's; ``Daemon()`` has a
  catalog on "cuda" and builds no table;
- the daemon as a process (``--device cpu``): the three listeners answer
  as a JAX catalog fed the same statements does, SIGTERM ends it with
  exit code 0, and a restart on its data directory serves the table
  again.

Tolerance: exact (JSON bodies, decoded rows, docids and weights).
"""
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

import pytest
import torch

import tests.test_servers as base
from manticoresearch_tpu.exec import session as jax_session
from manticoresearch_tpu.exec.searcher import SearchQuery as JaxQuery
from manticoresearch_tpu.server import daemon as jax_daemon
from manticoresearch_tpu.server.http import HttpServer as JaxHttpServer
from manticoresearch_tpu.server.mysql import MysqlServer as JaxMysqlServer
from manticoresearch_tpu_torch.exec import session as port_session
from manticoresearch_tpu_torch.exec.searcher import SearchQuery as PortQuery
from manticoresearch_tpu_torch.server import daemon as port_daemon
from manticoresearch_tpu_torch.server.api import ApiServer as PortApiServer
from manticoresearch_tpu_torch.server.http import HttpServer as PortHttpServer
from manticoresearch_tpu_torch.server.mysql import \
    MysqlServer as PortMysqlServer
from tests._torch_twin import TwinCatalog, TwinSession, port_dir
from tests.test_servers import MiniMysqlClient
from tests._torch_wire import (Listeners, TwinHttp, TwinMysqlClient,
                               mask_json, mask_mysql)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def twin_http(catalog):
    return TwinHttp(JaxHttpServer(catalog.jax), PortHttpServer(catalog.port))


@pytest.fixture(scope="module")
def catalog():
    c = TwinCatalog()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(base, "Session", TwinSession)
        base._seed(c)
    return c


@pytest.fixture(scope="module")
def http(catalog):
    return twin_http(catalog)


def _mysql_twin(catalog, **kw):
    return Listeners(JaxMysqlServer(catalog.jax, port=0, **kw),
                     PortMysqlServer(catalog.port, port=0, **kw))


@pytest.fixture(autouse=True)
def _twin_clients(monkeypatch):
    monkeypatch.setattr(base, "MiniMysqlClient", TwinMysqlClient)
    monkeypatch.setattr(base, "HttpServer", twin_http)


# ---------------- HTTP (direct dispatch, no socket) ----------------
class TestHttpJson(base.TestHttpJson):
    pass


# ---------------- HTTP over a real socket ----------------
class TestHttpSocket:
    def test_real_socket_roundtrip(self, catalog):
        import requests
        servers = Listeners(JaxHttpServer(catalog.jax, port=0),
                            PortHttpServer(catalog.port, port=0))
        try:
            got = []
            for port in servers.ports:
                resp = requests.post(
                    f"http://127.0.0.1:{port}/json/search",
                    json={"index": "films",
                          "query": {"match": {"title": "matrix"}}},
                    timeout=10)
                assert resp.status_code == 200
                got.append(mask_json(resp.json()))
            assert got[1] == got[0]
            assert got[0]["hits"]["total"] == 2
        finally:
            servers.close()


# ---------------- MySQL wire over a real socket ----------------
class TestMysqlWire(base.TestMysqlWire):
    @pytest.fixture(scope="class")
    def server_port(self, catalog):
        servers = _mysql_twin(catalog)
        yield tuple(servers.ports)
        servers.close()


class TestMysqlTlsCompress(base.TestMysqlTlsCompress):
    @pytest.fixture(scope="class")
    def tls_port(self, catalog):
        servers = _mysql_twin(catalog, ssl=True)
        yield tuple(servers.ports)
        servers.close()


class TestCrashQueryDump:
    def test_unexpected_fault_logged_and_served(self, catalog, caplog,
                                                monkeypatch):
        """An unhandled exception inside one statement leaves a crash dump
        in each package's daemon log and both sessions keep serving."""
        from manticoresearch_tpu.query.sphinxql import SelectStmt as JaxSel
        from manticoresearch_tpu_torch.query.sphinxql import \
            SelectStmt as PortSel
        out = {}
        for tag, mod, cat, sel, logger in (
                ("jax", jax_session, catalog.jax, JaxSel,
                 "manticoresearch_tpu.daemon"),
                ("port", port_session, catalog.port, PortSel,
                 "manticoresearch_tpu_torch.daemon")):
            orig = mod.Session._dispatch

            def boom(self, st, orig=orig, sel=sel):
                if isinstance(st, sel) and "segfault" in repr(st.conds):
                    raise RuntimeError("simulated crash")
                return orig(self, st)

            monkeypatch.setattr(mod.Session, "_dispatch", boom)
            caplog.clear()
            with caplog.at_level(logging.ERROR, logger=logger):
                rs = mod.Session(cat).execute(
                    "SELECT id FROM films WHERE MATCH('segfault'); "
                    "SELECT id FROM films ORDER BY id ASC LIMIT 1")
            assert rs[0].error and "internal error" in rs[0].error
            assert rs[1].error is None
            joined = "\n".join(r.getMessage() for r in caplog.records
                               if r.name == logger)
            assert "CRASH DUMP" in joined
            assert "segfault" in joined and "RuntimeError" in joined
            out[tag] = [(r.columns, r.rows, r.error) for r in rs]
        assert out["port"] == out["jax"]


class TestHttpPq(base.TestHttpPq):
    pass


class TestMysqlMultiResult:
    def test_facet_multi_result(self, catalog):
        servers = _mysql_twin(catalog)
        c = TwinMysqlClient("127.0.0.1", servers.ports)
        try:
            out = c.query("SELECT id FROM films WHERE MATCH('matrix') "
                          "FACET year")
            assert out.get("error") is None
            assert len(out["rows"]) == 2
            # the second result set follows on the wire: its column
            # count, columns, EOF, rows and the last EOF, equal
            first = c._read_packet()
            assert first[0] not in (0x00, 0xFF)
            for _ in range(first[0] + 1):
                c._read_packet()
            while True:
                pkt = c._read_packet()
                if pkt[0] == 0xFE and len(pkt) < 9:
                    break
        finally:
            for cl in c.clients:
                cl.sock.close()
            servers.close()


class TestClientHandshakeCompat:
    def test_sysvar_selects(self):
        s = TwinSession(TwinCatalog())
        r = s.execute("SELECT @@version_comment LIMIT 1")[0]
        assert r.error is None and r.rows == [("manticoresearch-tpu",)]
        r = s.execute("SELECT @@max_allowed_packet, @@version")[0]
        assert r.error is None and r.rows[0][0] == 8388608
        r = s.execute("SELECT DATABASE(), USER(), CONNECTION_ID()")[0]
        assert r.error is None and r.rows == [("Manticore", "root", 1)]
        r = s.execute("SELECT @@session.autocommit")[0]
        assert r.error is None and r.rows == [(1,)]
        s.close()


# ---------------- rotation, threads, globals, kill lists ----------------
def _save_plain(path, tag, port: bool):
    """The JAX test's plain index, built and saved by one package."""
    if port:
        from manticoresearch_tpu_torch.index.builder import IndexBuilder
        from manticoresearch_tpu_torch.index.storage import save_packed
        from manticoresearch_tpu_torch.schema import Schema
    else:
        from manticoresearch_tpu.index.builder import IndexBuilder
        from manticoresearch_tpu.index.storage import save_packed
        from manticoresearch_tpu.schema import Schema
    b = IndexBuilder(Schema(fields=["content"], attrs=[]))
    b.add_documents([dict(id=i, content=f"{tag} words {i}")
                     for i in range(1, 6)])
    save_packed(b.build(), path)


def _save_docs(path, docs, port: bool, killlist=None, target=""):
    if port:
        from manticoresearch_tpu_torch.index.builder import IndexBuilder
        from manticoresearch_tpu_torch.index.storage import save_packed
        from manticoresearch_tpu_torch.schema import Schema
    else:
        from manticoresearch_tpu.index.builder import IndexBuilder
        from manticoresearch_tpu.index.storage import save_packed
        from manticoresearch_tpu.schema import Schema
    b = IndexBuilder(Schema(fields=["content"], attrs=[]))
    b.add_documents(docs)
    save_packed(b.build(), path)
    if killlist is not None:
        with open(os.path.join(path, "killlist.json"), "w") as f:
            json.dump({"ids": killlist, "target": target}, f)


def _searched(twin, name, match):
    """(total_found, [(docid, weight)]) of one table in both catalogs,
    which must be equal."""
    out = []
    for cat, q in ((twin.jax, JaxQuery), (twin.port, PortQuery)):
        r = cat.get(name).search(q(match=match))
        assert r.error is None, r.error
        out.append((r.total_found, [(m.docid, m.weight) for m in r.matches]))
    assert out[1] == out[0], (name, match, out)
    return out[0]


class TestRotationAndThreads:
    def test_catalog_rotate_pickup_and_swap(self, tmp_path):
        dd = str(tmp_path / "data")
        twin = TwinCatalog(dd)
        dirs = {False: dd, True: port_dir(dd)}

        def rotate():
            got = twin.jax.rotate()
            assert twin.port.rotate() == got
            return got
        for port, d in dirs.items():
            _save_plain(os.path.join(d, "t1.new"), "alpha", port)
        assert rotate() == ["t1"]
        assert _searched(twin, "t1", "alpha")[0] == 5
        for d in dirs.values():
            assert os.path.isdir(os.path.join(d, "t1"))
            assert not os.path.isdir(os.path.join(d, "t1.new"))
        for port, d in dirs.items():
            _save_plain(os.path.join(d, "t1.new"), "beta", port)
        assert rotate() == ["t1"]
        assert _searched(twin, "t1", "beta")[0] == 5
        assert _searched(twin, "t1", "alpha")[0] == 0
        assert rotate() == []

    def test_reload_tables_and_import_sql(self, tmp_path):
        dd = str(tmp_path / "data")
        sess = TwinSession(TwinCatalog(dd))
        for port, d in ((False, dd), (True, port_dir(dd))):
            _save_plain(os.path.join(d, "t2.new"), "gamma", port)
        (r,) = sess.execute("RELOAD TABLES")
        assert r.error is None
        rows = sess.execute("SELECT id FROM t2 WHERE MATCH('gamma')")[0]
        assert len(rows.rows) == 5
        src = str(tmp_path / "ext_idx")
        _save_plain(src, "delta", False)
        (r2,) = sess.execute(f"IMPORT TABLE imp FROM '{src}'")
        assert r2.error is None, r2.error
        rows2 = sess.execute("SELECT id FROM imp WHERE MATCH('delta')")[0]
        assert len(rows2.rows) == 5
        sess.close()

    def test_show_threads_live_registry(self):
        """Each package lists its own live sessions; the rows of the two
        sessions made here are equal, their thread ids mapped to names
        (each package counts its sessions from 1 in the process)."""
        out = {}
        for tag, mod in (("jax", jax_session), ("port", port_session)):
            cat = (mod.Catalog() if tag == "jax"
                   else mod.Catalog(device="cpu"))
            s1 = mod.Session(cat, proto="mysql", host="1.2.3.4:5")
            s2 = mod.Session(cat, proto="http")
            try:
                (r,) = s1.execute("SHOW THREADS")
                assert r.error is None
                names = {str(s1.tid): "s1", str(s2.tid): "s2"}
                mine = [row for row in r.rows if row[0] in names]
                assert len(mine) == 2
                me = next(row for row in mine if row[0] == str(s1.tid))
                assert me[2] == "mysql" and me[3] == "1.2.3.4:5"
                assert "SHOW THREADS" in me[-1]
                # Connected, Work time and Last job took are times
                out[tag] = (r.columns, sorted(
                    (names[row[0]],) + row[2:5] + row[7:8] + row[9:]
                    for row in mine))
            finally:
                s1.close()
                s2.close()
        assert out["port"] == out["jax"]


class TestWatchdog:
    @staticmethod
    def _crash_then_serve(tmp_path, mod):
        """The JAX test's scenario on one package's ``run_watchdog``: a
        stand-in child crashes once, then serves until TERM; -> the
        commands the watchdog asked ``Popen`` for."""
        child = tmp_path / "fakechild.py"
        marker = tmp_path / "starts.txt"
        child.write_text(textwrap.dedent(f"""
            import signal, sys, time
            with open({str(marker)!r}, 'a') as f:
                f.write('x')
            if len(open({str(marker)!r}).read()) == 1:
                sys.exit(3)           # first run: crash
            signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
            while True:
                time.sleep(0.1)
        """))
        real_popen = subprocess.Popen
        spawned, cmds = [], []
        done = {"flag": False}

        def fake_popen(cmd, **kw):
            cmds.append(list(cmd))
            # once the test is over, a child that exits 0 ends the loop
            argv = ([sys.executable, "-c", "pass"] if done["flag"]
                    else [sys.executable, str(child)])
            p = real_popen(argv, **kw)
            spawned.append(p)
            return p
        subprocess.Popen = fake_popen
        th = threading.Thread(target=mod.run_watchdog,
                              args=(["--data-dir", str(tmp_path / "d")],),
                              daemon=True)
        try:
            th.start()
            t0 = time.time()
            while time.time() - t0 < 60:
                if marker.exists() and len(marker.read_text()) >= 2:
                    break
                time.sleep(0.05)
            assert len(marker.read_text()) >= 2   # crashed + restarted
        finally:
            done["flag"] = True
            for p in spawned:
                if p.poll() is None:
                    p.terminate()
                    p.wait(timeout=5)
            th.join(30)
            subprocess.Popen = real_popen
        assert not th.is_alive()
        return cmds

    def test_restarts_crashed_daemon(self, tmp_path):
        got = {}
        for tag, mod in (("jax", jax_daemon), ("port", port_daemon)):
            (tmp_path / tag).mkdir()
            got[tag] = self._crash_then_serve(tmp_path / tag, mod)
        want = [[c.replace("manticoresearch_tpu.", "manticoresearch_tpu_"
                           "torch.").replace(str(tmp_path / "jax"),
                                             str(tmp_path / "port"))
                 for c in cmd] for cmd in got["jax"]]
        assert got["port"] == want
        assert got["port"][0][1:3] == ["-m",
                                       "manticoresearch_tpu_torch.server."
                                       "daemon"]

    def test_child_is_the_port_daemon_with_its_device(self, monkeypatch):
        cmds = []

        class Exited:              # a child that has exited with code 0
            def wait(self):
                return 0

            def poll(self):
                return 0

        def fake_popen(cmd, **kw):
            cmds.append(list(cmd))
            return Exited()
        monkeypatch.setattr(subprocess, "Popen", fake_popen)
        argv = ["--watchdog", "--data-dir", "/nonexistent/d", "--device",
                "cpu", "--listen-http", "9999"]
        th = threading.Thread(target=port_daemon.main, args=(argv,))
        th.start()
        th.join(30)
        assert not th.is_alive()
        assert cmds == [[sys.executable, "-m",
                         "manticoresearch_tpu_torch.server.daemon",
                         "--data-dir", "/nonexistent/d", "--device", "cpu",
                         "--listen-http", "9999"]]


class TestGlobalVars:
    def test_set_global_persists(self, tmp_path):
        dd = str(tmp_path / "g")
        s = TwinSession(TwinCatalog(dd))
        (r,) = s.execute("SET GLOBAL query_log_min_msec = 250")
        assert r.error is None
        s.close()
        j = jax_session.Catalog(dd)
        p = port_session.Catalog(port_dir(dd), device="cpu")
        assert j.globals.get("query_log_min_msec") == 250
        assert p.globals == j.globals


class TestKlistTarget:
    def test_rotated_killlist_suppresses_target_rows(self, tmp_path):
        dd = str(tmp_path / "data")
        twin = TwinCatalog(dd)
        dirs = {False: dd, True: port_dir(dd)}

        def rotate():
            got = twin.jax.rotate()
            assert twin.port.rotate() == got
            return got

        def ids(name, match):
            found, rows = _searched(twin, name, match)
            return found, {d for d, _ in rows}
        for port, d in dirs.items():
            _save_docs(os.path.join(d, "main.new"),
                       [dict(id=i, content=f"old row {i}")
                        for i in (1, 2, 3, 4)], port)
        assert rotate() == ["main"]
        assert ids("main", "old")[0] == 4
        for port, d in dirs.items():
            _save_docs(os.path.join(d, "delta.new"),
                       [dict(id=i, content=f"new row {i}") for i in (2, 3)],
                       port, killlist=[2, 3], target="main:kl")
        assert rotate() == ["delta"]
        assert ids("main", "old") == (2, {1, 4})
        assert ids("delta", "new")[0] == 2
        for port, d in dirs.items():
            _save_docs(os.path.join(d, "delta.new"),
                       [dict(id=4, content="new row 4")], port,
                       killlist=[], target="main:id")
        assert rotate() == ["delta"]
        assert ids("main", "old")[1] == {1}


# ---------------- the port's daemon ----------------
def _toml_config(tmp_path, idx_path) -> str:
    p = tmp_path / "conf.toml"
    p.write_text(textwrap.dedent(f"""
        [searchd]
        listen_mysql = 9306
        listen_http = 9308

        [index.products]
        type = "plain"
        fields = ["content"]
        path = "{idx_path}"

        [index.rt1]
        type = "rt"
        fields = ["body"]
        attrs = {{ gid = "uint" }}

        [index.pq1]
        type = "pq"
        fields = ["body"]
    """))
    return str(p)


class TestDaemon:
    def test_config_plain_index_lands_on_the_cpu(self, tmp_path):
        from manticoresearch_tpu.config import load_config as jax_load
        from manticoresearch_tpu_torch.config import load_config
        src = str(tmp_path / "products")
        _save_plain(src, "epsilon", False)
        conf = _toml_config(tmp_path, src)
        j = jax_daemon.Daemon(config=jax_load(conf))
        p = port_daemon.Daemon(config=load_config(conf), device="cpu")
        twin = TwinCatalog()
        twin.jax, twin.port = j.catalog, p.catalog
        assert p.catalog.device == "cpu"
        assert sorted(p.catalog.tables) == sorted(j.catalog.tables) == \
            ["pq1", "products", "rt1"]
        products = p.catalog.tables["products"]
        assert products.device == "cpu"
        tree = [t for s in products.segments
                for v in s.search.device.data_pytree().values()
                for t in (v.values() if isinstance(v, dict) else [v])]
        assert tree and all(t.device.type == "cpu" for t in tree)
        found, rows = _searched(twin, "products", "epsilon")
        assert found == 5 and sorted(d for d, _ in rows) == [1, 2, 3, 4, 5]
        assert type(p.catalog.tables["pq1"]).__name__ == \
            type(j.catalog.tables["pq1"]).__name__

    def test_default_device_is_the_card(self):
        d = port_daemon.Daemon()
        assert d.catalog.device == "cuda"
        assert d.catalog.tables == {}
        assert d.mysql.catalog is d.http.catalog is d.catalog


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _post_sql(port, sql):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/sql",
        data=("query=" + urllib.parse.quote(sql)).encode(), method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _start_daemon(data_dir, ports, log):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "manticoresearch_tpu_torch.server.daemon",
         "--data-dir", data_dir, "--listen-mysql", str(ports[0]),
         "--listen-http", str(ports[1]), "--listen-api", str(ports[2]),
         "--device", "cpu"], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    t0 = time.time()
    while time.time() - t0 < 120:
        assert proc.poll() is None, "the daemon exited"
        try:
            socket.create_connection(("127.0.0.1", ports[2]), 1).close()
            return proc
        except OSError:
            time.sleep(0.2)
    proc.kill()
    raise AssertionError("the daemon did not listen")


_DAEMON_SQL = [
    "CREATE TABLE films (title text, plot text, year uint, rating float)",
    "INSERT INTO films (id, title, plot, year, rating) VALUES "
    "(1, 'The Matrix', 'hacker discovers reality', 1999, 8.7), "
    "(2, 'The Matrix Reloaded', 'hacker fights machines', 2003, 7.2), "
    "(3, 'Inception', 'dream within a dream heist', 2010, 8.8)"]
_DAEMON_SELECTS = [
    "SELECT id, WEIGHT() FROM films WHERE MATCH('hacker') LIMIT 10",
    "SELECT year, COUNT(*), AVG(rating) FROM films GROUP BY year "
    "ORDER BY year ASC"]


def test_daemon_process_serves_and_stops(tmp_path):
    """The port's daemon as users start it, on the CPU: its answers over
    HTTP and MySQL equal a JAX ``HttpServer`` fed the same statements;
    SIGTERM ends it with exit code 0; a restart serves the table again."""
    data = str(tmp_path / "data")
    jax_http = JaxHttpServer(jax_session.Catalog())
    ports = _free_ports(3)
    log_path = tmp_path / "daemon.log"
    with open(log_path, "w") as log:
        proc = _start_daemon(data, ports, log)
        try:
            for sql in _DAEMON_SQL:
                want = jax_http.handle_request(
                    "POST", "/sql", {}, b"query=" + sql.encode())
                assert _post_sql(ports[1], sql) == json.loads(want[2])
            answers = []
            for sql in _DAEMON_SELECTS:
                want = jax_http.handle_request(
                    "POST", "/sql", {}, ("query=" + sql).encode())
                got = _post_sql(ports[1], sql)
                assert mask_json(got) == mask_json(json.loads(want[2]))
                c = MiniMysqlClient("127.0.0.1", ports[0])
                try:
                    answers.append(mask_mysql(c.query(sql)))
                finally:
                    c.close()
            assert [r[0] for r in answers[0]["rows"]] == ["1", "2"]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(30) == 0, log_path.read_text()
            proc = _start_daemon(data, ports, log)
            again = []
            for sql in _DAEMON_SELECTS:
                c = MiniMysqlClient("127.0.0.1", ports[0])
                try:
                    again.append(mask_mysql(c.query(sql)))
                finally:
                    c.close()
            assert again == answers
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(30) == 0, log_path.read_text()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    assert not os.path.exists(os.path.join(data, "searchd.pid"))


def test_api_listener_on_the_port_catalog_threads():
    """Concurrent SphinxAPI clients search one port table (two segments)
    from the listener's worker threads, with the interpreter switching
    threads every few microseconds: every answer equals the one-client
    answer. (The JAX package's ``SearchIndex`` shares one query parser,
    which keeps its state on the instance, between such threads; the
    port's gives each thread its own.)"""
    import asyncio
    import struct
    import tests.test_api_protocol as api_base
    from tests._torch_wire import api_masked
    cat = port_session.Catalog(device="cpu")
    s = port_session.Session(cat)
    s.execute("CREATE TABLE t (content text, g uint)")
    for lo in (1, 41):
        s.execute("INSERT INTO t (id, content, g) VALUES " + ", ".join(
            f"({i}, 'word{i % 5} common w{i % 7} x{i % 11}', {i % 3})"
            for i in range(lo, lo + 40)))
    queries = [f"word{k} common" for k in range(5)] + \
        [f"w{k} | x{k} | word{k % 5}" for k in range(7)]
    bodies = [api_base.build_search_body(q, index="t") for q in queries]
    servers = Listeners(PortApiServer(cat, port=0))
    try:
        one = [asyncio.run(api_base._roundtrip(
            servers.ports[0], api_base.CMD_SEARCH, api_base.VER_SEARCH, b))
            for b in bodies]
        assert all(struct.unpack_from(">L", p, 0)[0] == 0 for _, p in one)

        async def many():
            return await asyncio.gather(*[
                api_base._roundtrip(servers.ports[0], api_base.CMD_SEARCH,
                                    api_base.VER_SEARCH,
                                    bodies[i % len(bodies)])
                for i in range(8 * len(bodies))])
        interval = sys.getswitchinterval()
        sys.setswitchinterval(2e-6)
        try:
            got = asyncio.run(many())
        finally:
            sys.setswitchinterval(interval)
        for i, r in enumerate(got):
            assert api_masked(0, *r) == api_masked(0, *one[i % len(one)])
    finally:
        servers.close()
