"""Port parity: distributed tables and agents, JAX vs the port.

- Every case of ``tests/test_agents.py`` runs once per package: a JAX
  ``AgentServer`` over a JAX catalog, and a port ``AgentServer`` over a
  port ``Catalog(device="cpu")``, each on a port the system picks
  (``port=0``), each with its own master catalog (a local table and a
  distributed table over it and the agent). Each case makes the original
  assertions on both packages and gives an observation (results, SHOW
  output, replies, mirror statistics); the two observations must be
  equal once the ports the system picked are replaced by ``<port>`` and
  latencies and reply times are masked.
- A local-only distributed table over 4 RT tables, built and queried by
  SphinxQL through the twins of ``tests/_torch_twin.py``: every result
  equal to the JAX package's, and to one table holding all the documents
  as far as per-part term statistics allow (total_found; docids and
  weights with equal-weight runs normalized under ``ranker=none``;
  attribute orders and integer aggregates exactly).
- The parts of a distributed table search on a thread pool: the launch
  counters of ``ops/packed_store`` and ``ops/groupby`` count exactly the
  same under that fan-out, repeated from several threads at once, as in
  a serial run of the same part searches.

Tolerance: exact.
"""
import asyncio
import re
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tests._torch_twin import TwinCatalog, TwinSession, masked

DOCS_A = [
    (1, "the quick brown fox jumps", 2001, 1),
    (2, "quick silver lining", 2002, 1),
    (3, "brown bread and butter", 2003, 2),
]
DOCS_B = [
    (11, "fox hunting is quick business", 2004, 2),
    (12, "silver fox in the snow", 2005, 3),
    (13, "butter and jam sandwich", 2006, 3),
]


def _package(name: str) -> SimpleNamespace:
    if name == "jax":
        from manticoresearch_tpu.exec import searcher, session
        from manticoresearch_tpu.exec.distributed import DistributedTable
        from manticoresearch_tpu.server import agent
        catalog = session.Catalog
    else:
        from manticoresearch_tpu_torch.exec import searcher, session
        from manticoresearch_tpu_torch.exec.distributed import \
            DistributedTable
        from manticoresearch_tpu_torch.server import agent

        def catalog(data_dir=None):
            return session.Catalog(data_dir, device="cpu")
    return SimpleNamespace(name=name, Catalog=catalog, Session=session.Session,
                           DistributedTable=DistributedTable, agent=agent,
                           SearchQuery=searcher.SearchQuery)


PKGS = {n: _package(n) for n in ("jax", "port")}


def _make_catalog(P, docs):
    c = P.Catalog()
    s = P.Session(c)
    for r in s.execute(
            "CREATE TABLE t (content text, year uint, gid uint)"):
        assert r.error is None, r.error
    vals = ", ".join(f"({i}, '{txt}', {y}, {g})" for i, txt, y, g in docs)
    r = s.execute(f"INSERT INTO t (id, content, year, gid) VALUES {vals}")
    assert r[0].error is None, r[0].error
    return c


def _serve(catalog, P):
    srv = P.agent.AgentServer(catalog, port=0)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(srv.start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(5)
    return srv, loop


@pytest.fixture(scope="module")
def remotes():
    """One AgentServer per package, serving DOCS_B as table 't'."""
    out = {n: _serve(_make_catalog(P, DOCS_B), P) for n, P in PKGS.items()}
    yield {n: srv for n, (srv, _) in out.items()}
    for _, loop in out.values():
        loop.call_soon_threadsafe(loop.stop)


@pytest.fixture(scope="module")
def masters(remotes):
    """Per package: local table 'ta' (DOCS_A) and 'dist' over 'ta' and the
    package's own agent."""
    out = {}
    for n, P in PKGS.items():
        catalog = _make_catalog(P, DOCS_A)
        catalog.tables["ta"] = catalog.tables.pop("t")
        for r in P.Session(catalog).execute(
                "CREATE TABLE dist type='distributed' local='ta' "
                f"agent='127.0.0.1:{remotes[n].port}:t'"):
            assert r.error is None, r.error
        out[n] = catalog
    return out


def _dead_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


# -- the cases of tests/test_agents.py, one function per case ---------------
def case_ping(P, remote, master):
    m = P.agent.AgentMirror("127.0.0.1", remote.port, "t")
    ok = P.agent.agent_ping(m)
    assert ok
    assert m.queries == 1 and m.errors == 0
    return ok, m.queries, m.errors


def case_search_raw(P, remote, master):
    agent = P.agent.MultiAgent(P.agent.parse_agent_spec(
        f"127.0.0.1:{remote.port}:t"))
    reply = P.agent.agent_search(agent, P.agent.query_to_payload(
        P.SearchQuery(match="fox")))
    assert reply["error"] is None
    assert sorted(m[0] for m in reply["matches"]) == [11, 12]
    assert reply["total_found"] == 2
    return reply


def case_unknown_table_is_remote_error(P, remote, master):
    agent = P.agent.MultiAgent(P.agent.parse_agent_spec(
        f"127.0.0.1:{remote.port}:nosuch"))
    with pytest.raises(P.agent.AgentError) as e:
        P.agent.agent_search(agent, P.agent.query_to_payload(
            P.SearchQuery(match="fox")), retry_count=0)
    assert agent.mirrors[0].errors == 1
    return str(e.value), agent.mirrors[0].errors


def _sql(P, master, *sqls):
    s = P.Session(master)
    out = []
    for sql in sqls:
        rs = s.execute(sql)
        out.append(rs)
    return s, out


def case_merged_results_span_parts(P, remote, master):
    _, (out,) = _sql(P, master, "SELECT id FROM dist WHERE MATCH('fox')")
    assert out[0].error is None, out[0].error
    assert sorted(r[0] for r in out[0].rows) == [1, 11, 12]
    return [masked(r) for r in out]


def case_merge_order_weight_desc_docid_asc(P, remote, master):
    _, (out,) = _sql(P, master,
                     "SELECT id, weight() FROM dist WHERE MATCH('quick')")
    assert out[0].error is None
    ws = [r[1] for r in out[0].rows]
    assert ws == sorted(ws, reverse=True)
    for i in range(len(out[0].rows) - 1):
        if out[0].rows[i][1] == out[0].rows[i + 1][1]:
            assert out[0].rows[i][0] < out[0].rows[i + 1][0]
    return [masked(r) for r in out]


def case_word_stats_summed(P, remote, master):
    _, (out, meta) = _sql(P, master,
                          "SELECT id FROM dist WHERE MATCH('quick')",
                          "SHOW META")
    assert out[0].error is None
    assert int(dict(meta[0].rows).get("docs[0]", 0)) == 3
    return [masked(r) for r in out + meta]


def case_filters_travel_to_agents(P, remote, master):
    _, (out,) = _sql(P, master, "SELECT id FROM dist WHERE MATCH('fox') "
                                "AND year >= 2004")
    assert out[0].error is None
    assert sorted(r[0] for r in out[0].rows) == [11, 12]
    return [masked(r) for r in out]


def case_group_by_across_parts(P, remote, master):
    _, (out,) = _sql(P, master, "SELECT gid, count(*) FROM dist GROUP BY "
                                "gid ORDER BY gid ASC")
    assert out[0].error is None, out[0].error
    assert {r[0]: r[1] for r in out[0].rows} == {1: 2, 2: 2, 3: 2}
    return [masked(r) for r in out]


def case_writes_rejected(P, remote, master):
    _, (out,) = _sql(P, master, "INSERT INTO dist (id, content, year, gid) "
                                "VALUES (99, 'x', 2000, 1)")
    assert out[0].error is not None
    assert "distributed" in out[0].error
    return [masked(r) for r in out]


def case_show_tables_reports_type(P, remote, master):
    _, (out,) = _sql(P, master, "SHOW TABLES")
    assert dict(out[0].rows)["dist"] == "distributed"
    return [masked(r) for r in out]


def case_show_agent_status(P, remote, master):
    # a query through the agent first, whatever cases ran before on this
    # worker (the original case relies on the file's earlier cases)
    _, (_, out) = _sql(P, master, "SELECT id FROM dist WHERE MATCH('fox')",
                       "SHOW AGENT STATUS")
    d = dict(out[0].rows)
    assert any(k.endswith("_addr") for k in d)
    assert any(int(v) > 0 for k, v in d.items() if k.endswith("_queries"))
    return [(k, "<latency>" if k.endswith("_latency_ms") else v)
            for k, v in out[0].rows]


def case_dead_mirror_fails_over(P, remote, master):
    dead_port = _dead_port()
    agent = P.agent.MultiAgent(
        P.agent.parse_agent_spec(
            f"127.0.0.1:{dead_port}:t|127.0.0.1:{remote.port}:t"),
        strategy="roundrobin")
    reply = P.agent.agent_search(agent, P.agent.query_to_payload(
        P.SearchQuery(match="fox")), timeout=1.0, retry_count=2)
    assert reply["error"] is None
    assert sorted(m[0] for m in reply["matches"]) == [11, 12]
    dead = next(m for m in agent.mirrors if m.port == dead_port)
    assert dead.errors >= 1 and dead.is_dead()
    return _dead_sub(reply, dead_port), dead.errors, dead.is_dead()


def case_nodeads_prefers_live_mirror(P, remote, master):
    m_dead = P.agent.AgentMirror("127.0.0.1", 1, "t")
    m_dead.note_error("down")
    m_live = P.agent.AgentMirror("127.0.0.1", remote.port, "t")
    agent = P.agent.MultiAgent([m_dead, m_live], strategy="nodeads")
    order = agent.choose_order()
    assert order[0] is m_live
    return [agent.mirrors.index(m) for m in order]


def case_all_mirrors_dead_is_error(P, remote, master):
    dead_port = _dead_port()
    agent = P.agent.MultiAgent(P.agent.parse_agent_spec(
        f"127.0.0.1:{dead_port}:t"))
    with pytest.raises(P.agent.AgentError) as e:
        P.agent.agent_search(agent, P.agent.query_to_payload(
            P.SearchQuery(match="x")), timeout=0.5, retry_count=1)
    return _dead_sub(str(e.value), dead_port)


def case_distributed_table_partial_agent_failure_reported(P, remote,
                                                           master):
    catalog = _make_catalog(P, DOCS_A)
    dead_port = _dead_port()
    catalog.tables["d2"] = P.DistributedTable(
        "d2", catalog, ["t"], [f"127.0.0.1:{dead_port}:t"],
        agent_query_timeout_ms=300, retry_count=0)
    r = catalog.tables["d2"].search(P.SearchQuery(match="quick"))
    assert r.error is None
    assert r.warning
    assert r.matches
    return (_dead_sub(r.warning, dead_port), r.total_found,
            [(m.docid, m.weight, m.attrs) for m in r.matches])


def case_distributed_table_all_parts_dead_is_error(P, remote, master):
    catalog = _make_catalog(P, DOCS_A)
    dead_port = _dead_port()
    catalog.tables["d3"] = P.DistributedTable(
        "d3", catalog, [], [f"127.0.0.1:{dead_port}:t"],
        agent_query_timeout_ms=300, retry_count=0)
    r = catalog.tables["d3"].search(P.SearchQuery(match="quick"))
    assert r.error is not None
    return _dead_sub(r.error, dead_port)


def case_mirror_split(P, remote, master):
    ms = P.agent.parse_agent_spec("h1:1:t|h2:2:u")
    got = [(m.host, m.port, m.table) for m in ms]
    assert got == [("h1", 1, "t"), ("h2", 2, "u")]
    return got


def case_bad_spec(P, remote, master):
    with pytest.raises(ValueError) as e:
        P.agent.parse_agent_spec("justhost")
    return str(e.value)


def case_pool_reuse_and_keywords(P, remote, master):
    agent = P.agent.MultiAgent(P.agent.parse_agent_spec(
        f"127.0.0.1:{remote.port}:t"))
    m = agent.mirrors[0]
    replies = []
    for _ in range(3):
        r = P.agent.agent_search(agent, P.agent.query_to_payload(
            P.SearchQuery(match="fox")), timeout=2.0)
        assert "matches" in r
        replies.append(r)
    assert getattr(m, "_pool_hits", 0) >= 2
    assert len(m._pool()) >= 1
    r = P.agent._request(m, P.agent.CMD_KEYWORDS,
                         {"table": "t", "text": "fox zzz"}, timeout=2.0)
    kws = {k["normalized"]: k for k in r["keywords"]}
    assert kws["fox"]["docs"] == 2
    assert kws["zzz"]["docs"] == 0
    return replies, r, m._pool_hits


def case_stale_pooled_socket_retries_fresh(P, remote, master):
    agent = P.agent.MultiAgent(P.agent.parse_agent_spec(
        f"127.0.0.1:{remote.port}:t"))
    m = agent.mirrors[0]
    r1 = P.agent.agent_search(agent, P.agent.query_to_payload(
        P.SearchQuery(match="fox")), timeout=2.0)
    assert "matches" in r1
    for s in m._pool():
        s.close()
    r2 = P.agent.agent_search(agent, P.agent.query_to_payload(
        P.SearchQuery(match="fox")), timeout=2.0)
    assert "matches" in r2
    assert m.errors == 0
    return r1, r2, m.errors


def _dead_sub(obj, dead_port: int):
    return _norm(obj, {str(dead_port)})


def _norm(obj, ports: set):
    """Ports the system picked -> '<port>'; reply times masked."""
    if isinstance(obj, str):
        return re.sub(r"\d+", lambda m: "<port>" if m.group(0) in ports
                      else m.group(0), obj)
    if isinstance(obj, dict):
        return {k: ("<time>" if k == "time_ms" else _norm(v, ports))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_norm(v, ports) for v in obj)
    return obj


CASES = {n[len("case_"):]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_agents_case(name, remotes, masters):
    seen = {}
    for n, P in PKGS.items():
        seen[n] = _norm(CASES[name](P, remotes[n], masters[n]),
                        {str(remotes[n].port)})
    assert seen["jax"] == seen["port"]


def test_every_agents_case_is_here():
    import tests.test_agents as base
    names = {n[len("test_"):] for cls in vars(base).values()
             if isinstance(cls, type) and cls.__name__.startswith("Test")
             for n in vars(cls) if n.startswith("test_")}
    assert names == set(CASES)


# -- a local-only distributed table over 4 RT tables -----------------------
_VOCAB = [f"w{i}" for i in range(30)]


def _rt_docs(seed: int, n: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(3, 12))
        words = [_VOCAB[min(int(z) - 1, len(_VOCAB) - 1)]
                 for z in rng.zipf(1.4, k)]
        out.append((i + 1, " ".join(words), 2000 + int(rng.integers(0, 20)),
                    int(rng.integers(0, 6)),
                    float(np.float32(rng.integers(0, 40) / 8))))
    return out


_DIST_QUERIES = [
    "SELECT id, WEIGHT() FROM {t} WHERE MATCH('w1'){o}",
    "SELECT id, WEIGHT() FROM {t} WHERE MATCH('w2 w3') LIMIT 5{o}",
    "SELECT id, WEIGHT() FROM {t} WHERE MATCH('w1 | w4 | w7') LIMIT 30{o}",
    "SELECT id, WEIGHT() FROM {t} WHERE MATCH('\"w1 w2\"'){o}",
    "SELECT id, WEIGHT(), year FROM {t} WHERE MATCH('w3') AND "
    "year BETWEEN 2005 AND 2012 LIMIT 50{o}",
    "SELECT id, WEIGHT() FROM {t} WHERE MATCH('w5 -w1') LIMIT 40{o}",
    "SELECT id, year FROM {t} WHERE MATCH('w2') ORDER BY year DESC, id ASC "
    "LIMIT 3, 10",
    "SELECT gid, COUNT(*), SUM(year) FROM {t} WHERE MATCH('w1 | w2') "
    "GROUP BY gid ORDER BY gid ASC",
    "SELECT gid, COUNT(*), SUM(year), AVG(price) FROM {t} WHERE "
    "MATCH('w1 | w2') GROUP BY gid ORDER BY gid ASC",
    "SELECT id, price * 2 AS p2 FROM {t} WHERE MATCH('w6') ORDER BY id ASC",
]


def _runs(rows, limit: int):
    """(weight, docids) runs: equal weights may come in another docid
    order, and a final run that the limit clipped keeps only its length
    (as ``tests/test_differential.py`` normalizes ties)."""
    out: list = []
    for row in rows:
        docid, w = row[0], row[1]
        if out and out[-1][0] == w:
            out[-1][1].append(docid)
        else:
            out.append((w, [docid]))
    return [(w, len(ids) if i == len(out) - 1 and len(rows) == limit
             else sorted(ids)) for i, (w, ids) in enumerate(out)]


def test_local_distributed_table():
    """Each local part ranks with its own term statistics (the reference's
    default, without ``local_df``), so ranked weights differ from one
    table's: against the one table, the ranked queries are held on
    total_found and, under ``OPTION ranker=none`` (weights that need no
    statistics), on docids and weights with ties normalized; the
    attribute-ordered and grouped ones exactly (AVG aside: its float sums
    add the parts in another order)."""
    docs = _rt_docs(5, 240)
    s = TwinSession(TwinCatalog())
    s.execute("CREATE TABLE whole (content text, year uint, gid uint, "
              "price float)")
    for k in range(4):
        s.execute(f"CREATE TABLE p{k} (content text, year uint, gid uint, "
                  "price float)")
    for i in range(0, len(docs), 240):       # one segment each
        chunk = docs[i:i + 240]
        vals = ", ".join(f"({d}, '{c}', {y}, {g}, {p})"
                         for d, c, y, g, p in chunk)
        s.execute("INSERT INTO whole (id, content, year, gid, price) "
                  f"VALUES {vals}")
        for k in range(4):
            part = [x for x in chunk if x[0] % 4 == k]
            vals = ", ".join(f"({d}, '{c}', {y}, {g}, {p})"
                             for d, c, y, g, p in part)
            s.execute(f"INSERT INTO p{k} (id, content, year, gid, price) "
                      f"VALUES {vals}")
    s.execute("CREATE TABLE dist type='distributed' " +
              " ".join(f"local='p{k}'" for k in range(4)))
    for q in _DIST_QUERIES:
        for o in ("", " OPTION ranker=none"):
            if o and "{o}" not in q:
                continue
            (d,), (meta,) = s.execute(q.format(t="dist", o=o)), \
                s.execute("SHOW META")
            (w,), (wmeta,) = s.execute(q.format(t="whole", o=o)), \
                s.execute("SHOW META")
            assert d.error is None and w.error is None, (q, d.error, w.error)
            assert dict(meta.rows)["total_found"] == \
                dict(wmeta.rows)["total_found"], q
            if o:
                m = re.search(r"LIMIT (\d+)", q)
                limit = int(m.group(1)) if m else 20
                assert _runs(d.rows, limit) == _runs(w.rows, limit), q
            elif "{o}" not in q and "AVG" not in q:
                assert d.rows == w.rows, q
    jax.clear_caches()


# -- launch counters under the thread fan-out -------------------------------
def test_fanout_launch_counts_are_exact():
    from manticoresearch_tpu_torch.exec.session import Catalog, Session
    from manticoresearch_tpu_torch.ops import groupby as gb
    from manticoresearch_tpu_torch.ops import packed_store as ps
    P = PKGS["port"]
    catalog = Catalog(device="cpu")
    s = Session(catalog)
    docs = _rt_docs(9, 4000)
    names = [f"p{k}" for k in range(4)]
    for k, name in enumerate(names):
        assert s.execute(f"CREATE TABLE {name} (content text, year uint, "
                         "gid uint, price float)")[0].error is None
        for i in range(0, 4000, 2000):    # two segments per table
            vals = ", ".join(f"({d}, '{c}', {y}, {g}, {p})"
                             for d, c, y, g, p in docs[i:i + 2000]
                             if d % 4 == k)
            assert s.execute(f"INSERT INTO {name} (id, content, year, gid, "
                             f"price) VALUES {vals}")[0].error is None
    dist = P.DistributedTable("dist", catalog, names, [])
    qs = [P.SearchQuery(match=m, limit=20) for m in
          ("w1", "w2 w3", "w1 | w5", '"w1 w2"', "w4 -w1")]
    qs.append(P.SearchQuery(match="w1 | w2", group_by="gid", limit=10,
                            select=["gid", "count(*)", "sum(price)"]))

    def counts():
        return (ps.LAUNCHES.plain, ps.LAUNCHES.kernel, gb.LAUNCHES.plain,
                gb.LAUNCHES.kernel)

    # serial: each part's search of each query, one thread
    ps.LAUNCHES.reset()
    gb.LAUNCHES.reset()
    serial_results = []
    for q in qs:
        part_q = replace(q, offset=0, limit=q.offset + q.limit) \
            if not q.group_by else q
        for name in names:
            catalog.get(name).search(part_q)
        serial_results.append(dist.search(q))
    one_pass = counts()      # the serial part searches and one fan-out
    assert one_pass[0] > 0 and one_pass[2] > 0
    ps.LAUNCHES.reset()
    gb.LAUNCHES.reset()
    for q in qs:
        dist.search(q)
    per_dist = counts()      # the fan-out alone
    assert [a - b for a, b in zip(one_pass, per_dist)] == list(per_dist)
    # concurrent: 6 threads, each running every query's fan-out
    ps.LAUNCHES.reset()
    gb.LAUNCHES.reset()
    with ThreadPoolExecutor(max_workers=6) as ex:
        results = list(ex.map(lambda i: [dist.search(q) for q in qs],
                              range(6)))
    assert counts() == tuple(6 * x for x in per_dist)
    for rs in results:
        assert [(r.total_found, [(m.docid, m.weight) for m in r.matches])
                for r in rs] == [
            (r.total_found, [(m.docid, m.weight) for m in r.matches])
            for r in serial_results]
