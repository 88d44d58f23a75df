"""Port parity: the query-log replay tool and ``indextool``'s modes.

- ``TestReplay.test_log_and_replay`` of ``tests/test_tools.py`` in twin
  form: the statements run in twin sessions (``tests/_torch_twin.py``)
  that each write a query log; each package's ``replay.main`` replays the
  JAX session's log against its own data directory (the port's with
  ``--device cpu``) and returns 0. Over ``--host`` / ``--port`` each
  package's replay posts a log to its own ``HttpServer`` (the port's on a
  ``Catalog(device="cpu")``) with the same outcome.
- Each ``indextool.main`` mode that ``tests/test_tools.py`` drives
  (``--check``, ``--dumpheader``, ``--dumpdict``, ``--dumpdocids``,
  ``--dumphitlist``, ``--stats``) on the same saved index: the port's
  exit code and standard output equal to the JAX package's.

Tolerance: exact (exit codes and text).
"""
import io
import sys

import pytest
import torch

from manticoresearch_tpu.tools import indextool as jax_indextool
from manticoresearch_tpu.tools import replay as jax_replay
from manticoresearch_tpu_torch.tools import indextool as port_indextool
from manticoresearch_tpu_torch.tools import replay as port_replay
from tests._torch_twin import TwinCatalog, TwinSession, port_dir

torch.set_num_threads(2)


class TestReplay:
    def test_log_and_replay(self, tmp_path):
        dd = str(tmp_path / "data")
        s = TwinSession(TwinCatalog(dd))
        logs = {"jax": io.StringIO(), "port": io.StringIO()}
        s.jax.query_log, s.port.query_log = logs["jax"], logs["port"]
        s.execute("CREATE TABLE r (c text)")
        s.execute("INSERT INTO r (id, c) VALUES (1, 'replay me twice')")
        s.execute("SELECT id FROM r WHERE MATCH('replay')")
        s.execute("SELECT id FROM r WHERE MATCH('twice') LIMIT 5")
        s.close()
        logfile = tmp_path / "q.log"
        logfile.write_text(logs["jax"].getvalue())
        assert "MATCH('replay')" in logs["jax"].getvalue()
        # the two logs differ only in their stamps and times
        assert [ln.split("*/", 1)[1] for ln in
                logs["port"].getvalue().splitlines()] == \
            [ln.split("*/", 1)[1] for ln in
             logs["jax"].getvalue().splitlines()]
        assert jax_replay.main(["--log", str(logfile), "--data-dir", dd,
                                "--quiet"]) == 0
        assert port_replay.main(["--log", str(logfile), "--data-dir",
                                 port_dir(dd), "--device", "cpu",
                                 "--quiet"]) == 0

    def test_replay_over_http(self, tmp_path):
        """Each package's replay posts a log to its own ``HttpServer``
        (the port's on a ``Catalog(device="cpu")``): 0 for a log that
        runs; a failing statement's HTTP 400 ends the replay with
        urllib's ``HTTPError`` in both."""
        import urllib.error
        from manticoresearch_tpu.server.http import HttpServer as JaxHttp
        from manticoresearch_tpu_torch.server.http import HttpServer
        from tests._torch_wire import Listeners
        twin = TwinCatalog()
        sess = TwinSession(twin)
        sess.execute("CREATE TABLE r (c text)")
        sess.execute("INSERT INTO r (id, c) VALUES (1, 'replay me')")
        good = tmp_path / "good.log"
        good.write_text("/* Sat Oct 17 10:00:00.000 2026 conn 1 real 0.001 "
                        "wall 0.001 found 1 */ SELECT id FROM r WHERE "
                        "MATCH('replay');\nSELECT id FROM r LIMIT 1;\n")
        bad = tmp_path / "bad.log"
        bad.write_text("SELECT id FROM nosuch;\n")
        servers = Listeners(JaxHttp(twin.jax, port=0),
                            HttpServer(twin.port, port=0))
        try:
            for mod, port in zip((jax_replay, port_replay), servers.ports):
                args = ["--host", "127.0.0.1", "--port", str(port),
                        "--quiet"]
                assert mod.main(["--log", str(good)] + args) == 0
                with pytest.raises(urllib.error.HTTPError) as err:
                    mod.main(["--log", str(bad)] + args)
                assert err.value.code == 400
        finally:
            servers.close()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """``TestIndextoolDepth``'s index, saved by the JAX package."""
    from manticoresearch_tpu.index.builder import IndexBuilder
    from manticoresearch_tpu.index.storage import save_packed
    from manticoresearch_tpu.schema import AttrDef, AttrType, Schema
    d = tmp_path_factory.mktemp("itool")
    b = IndexBuilder(Schema(fields=["content"],
                            attrs=[AttrDef("price", AttrType.UINT),
                                   AttrDef("tags", AttrType.MVA)]))
    b.add_documents([dict(id=i, content=f"common word{i % 7} text",
                          price=i, tags=[i % 3, 5]) for i in range(1, 201)])
    p = str(d / "idx")
    save_packed(b.build(), p)
    return p


_MODES = {
    "check": lambda p: ["--check", p],
    "dumpheader": lambda p: ["--dumpheader", p],
    "dumpdict": lambda p: ["--dumpdict", p, "--limit", "12"],
    "dumpdocids": lambda p: ["--dumpdocids", p, "--limit", "5"],
    "dumphitlist": lambda p: ["--dumphitlist", p, "--word", "common",
                              "--limit", "3"],
    "stats": lambda p: ["--stats", p],
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_indextool_mode_matches_jax(mode, saved, capsys):
    out = {}
    for tag, mod in (("jax", jax_indextool), ("port", port_indextool)):
        rc = mod.main(_MODES[mode](saved))
        sys.stdout.flush()
        out[tag] = (rc, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["jax"][0] == 0 and out["jax"][1].strip()
