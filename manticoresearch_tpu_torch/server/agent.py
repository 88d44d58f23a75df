"""Inter-host tier: remote agents for distributed tables.

Behavioral model — the reference's agent subsystem:
- master fans a query out to remote agents and merges one pre-sorted
  chunk per agent (ScheduleDistrJobs, Manticore src/searchdha.cpp:2090;
  "by design remotes return one chunk", searchd.cpp:6737);
- each agent is a mirror set with an HA routing strategy
  (HAStrategies_e, searchdha.h:102-110: random / roundrobin /
  nodeads / noerrors) driven by per-host dashboards of error and
  latency statistics (HostDashboard_t, searchdha.h:226);
- failures retry on a re-picked mirror (RunSubset retries,
  searchd.cpp:6648; iRetryCount/iRetryDelay);
- blackhole agents get fire-and-forget copies (searchd.cpp:6651);
- a periodic ping keeps dashboards warm (taskping.cpp:119).

The wire protocol mirrors the master<->agent request/reply *semantics*
(versioned framing, one merged chunk per agent — searchd.cpp:1540-2500)
as a compact length-prefixed JSON protocol over TCP; agents here are
other daemons of this framework, not the reference's binary SphinxAPI.

This is the inter-host tier: shards on one card stay one
``ShardedIndex`` (parallel/sharded.py); agents exist for capacity past
one host.

The port's copy of ``manticoresearch_tpu/server/agent.py``.
"""
from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

MAGIC = 0x4D544153          # "MTAS"
PROTO_VERSION = 1
CMD_SEARCH = 1
CMD_PING = 2
CMD_KEYWORDS = 3
CMD_UPDATE = 4
_HDR = struct.Struct(">IHHI")   # magic, version, command/status, payload len

STATUS_OK = 0
STATUS_ERROR = 1


# ---------------------------------------------------------------------------
# framing

def _send_frame(sock: socket.socket, command: int, payload: dict) -> None:
    body = json.dumps(payload).encode()
    sock.sendall(_HDR.pack(MAGIC, PROTO_VERSION, command, len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("agent connection closed mid-frame")
        buf += chunk
    return buf


# reply-size cap (max_packet_size, searchd default 8M; the master
# rejects oversized agent replies — CheckSockError/invalid packet size)
MAX_PACKET = 8 << 20


def _recv_frame(sock: socket.socket) -> tuple[int, dict]:
    hdr = _recv_exact(sock, _HDR.size)
    magic, ver, cmd, ln = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise ConnectionError(f"bad agent protocol magic {magic:#x}")
    if ver > PROTO_VERSION:
        raise ConnectionError(f"unsupported agent protocol version {ver}")
    if MAX_PACKET and ln > MAX_PACKET:
        raise ConnectionError(
            f"invalid packet size (status=0, len={ln}, "
            f"max_packet_size={MAX_PACKET})")
    body = _recv_exact(sock, ln) if ln else b"{}"
    return cmd, json.loads(body)


def prune_attrs_for_select(matches, q) -> None:
    """Agents ship only the attrs the master asked for (the reference
    master requests an explicit item list; `select id,gid` over a wide
    schema must NOT push every attribute through the wire — golden
    test_220 hits max_packet_size otherwise)."""
    if q.select is None:
        return
    keep = {s.strip().lower() for s in q.select}
    if "*" in keep:
        return
    keep.add((q.group_by or "").lower())
    for col, _asc in (q.sort or []):
        keep.add(str(col).lower())
    for m in matches:
        m.attrs = {k: v for k, v in m.attrs.items()
                   if k.startswith("@") or "(" in k
                   or k.lower() in keep}


# ---------------------------------------------------------------------------
# mirrors + dashboards

@dataclass
class AgentMirror:
    """One host:port:table endpoint + its dashboard counters
    (HostDashboard_t analog, searchdha.h:226)."""

    host: str
    port: int
    table: str
    queries: int = 0
    errors: int = 0
    timeouts: int = 0
    last_error: str = ""
    ema_latency_ms: float = 0.0
    dead_until: float = 0.0      # monotonic time before which mirror is dead

    def addr(self) -> str:
        return f"{self.host}:{self.port}:{self.table}"

    def note_success(self, latency_ms: float) -> None:
        self.queries += 1
        a = 0.2  # EWMA factor
        self.ema_latency_ms = (latency_ms if self.ema_latency_ms == 0.0
                               else (1 - a) * self.ema_latency_ms
                               + a * latency_ms)
        self.dead_until = 0.0

    def note_error(self, msg: str, timeout: bool = False,
                   dead_for: float = 5.0) -> None:
        self.queries += 1
        self.errors += 1
        if timeout:
            self.timeouts += 1
        self.last_error = msg
        self.dead_until = time.monotonic() + dead_for

    def is_dead(self) -> bool:
        return time.monotonic() < self.dead_until

    # -- persistent connection pool (searchdha.h:118) -------------------
    _POOL_CAP = 4

    def _pool(self) -> list:
        if not hasattr(self, "_conns"):
            self._conns: list = []
            self._pool_hits = 0
            self._pool_misses = 0
        return self._conns

    def acquire(self, timeout: float):
        """-> (socket, reused_flag)."""
        pool = self._pool()
        if pool:
            self._pool_hits += 1
            return pool.pop(), True
        self._pool_misses += 1
        return socket.create_connection((self.host, self.port),
                                        timeout=timeout), False

    def release(self, sock) -> None:
        pool = self._pool()
        if len(pool) < self._POOL_CAP:
            pool.append(sock)
        else:
            try:
                sock.close()
            except OSError:
                pass

    def discard(self, sock) -> None:
        try:
            sock.close()
        except OSError:
            pass


def parse_agent_spec(spec: str) -> list[AgentMirror]:
    """'host1:port1:tbl|host2:port2:tbl' -> mirror list (the reference's
    agent = h1|h2 mirror syntax, searchdha.cpp ParseAgentLine)."""
    mirrors = []
    for part in spec.split("|"):
        bits = part.strip().split(":")
        if len(bits) != 3:
            raise ValueError(
                f"agent spec '{part}' must be host:port:table")
        mirrors.append(AgentMirror(bits[0], int(bits[1]), bits[2]))
    if not mirrors:
        raise ValueError("empty agent spec")
    return mirrors


@dataclass
class MultiAgent:
    """A mirror set + HA strategy state (MultiAgentDesc_c, searchdha.h:330)."""

    mirrors: list[AgentMirror]
    strategy: str = "random"     # random | roundrobin | nodeads | noerrors
    _rr: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def choose_order(self) -> list[AgentMirror]:
        """Mirror try-order for one request: strategy pick first, then the
        remaining mirrors as retry fallbacks."""
        with self._lock:
            ms = list(self.mirrors)
            if self.strategy == "roundrobin":
                first = self._rr % len(ms)
                self._rr += 1
                order = ms[first:] + ms[:first]
            elif self.strategy == "nodeads":
                alive = [m for m in ms if not m.is_dead()]
                dead = [m for m in ms if m.is_dead()]
                random.shuffle(alive)
                order = alive + dead
            elif self.strategy == "noerrors":
                # weighted toward low error ratio (searchdha.h:102 weighted-
                # probability mirror choice, simplified to a stable sort)
                order = sorted(
                    ms, key=lambda m: (m.is_dead(),
                                       m.errors / max(m.queries, 1),
                                       m.ema_latency_ms))
            else:  # random
                random.shuffle(ms)
                order = sorted(ms, key=lambda m: m.is_dead())
        return order


# ---------------------------------------------------------------------------
# client

class AgentError(Exception):
    pass


def _request(mirror: AgentMirror, command: int, payload: dict,
             timeout: float) -> dict:
    """One request over the mirror's persistent connection pool
    (agent_persistent semantics, searchdha.h:118): a pooled socket is
    reused across requests; a send/recv failure on a REUSED socket retries
    once on a fresh connection before counting as a mirror error."""
    t0 = time.perf_counter()
    last_err: Exception | None = None
    for attempt in (0, 1):
        try:
            sock, reused = mirror.acquire(timeout)
        except OSError as e:
            mirror.note_error(str(e))
            raise AgentError(f"agent {mirror.addr()}: {e}") from e
        try:
            sock.settimeout(timeout)
            _send_frame(sock, command, payload)
            status, reply = _recv_frame(sock)
        except socket.timeout as e:
            mirror.discard(sock)
            mirror.note_error(f"timeout after {timeout}s", timeout=True)
            raise AgentError(f"agent {mirror.addr()}: timed out") from e
        except OSError as e:
            mirror.discard(sock)
            last_err = e
            if reused:
                continue       # stale pooled socket: one fresh retry
            mirror.note_error(str(e))
            raise AgentError(f"agent {mirror.addr()}: {e}") from e
        mirror.release(sock)
        if status == STATUS_ERROR:
            mirror.note_error(reply.get("error", "remote error"))
            raise AgentError(
                f"agent {mirror.addr()}: "
                f"{reply.get('error', 'remote error')}")
        mirror.note_success((time.perf_counter() - t0) * 1000.0)
        return reply
    mirror.note_error(str(last_err))
    raise AgentError(f"agent {mirror.addr()}: {last_err}")


def agent_search(agent: MultiAgent, query_payload: dict,
                 timeout: float = 3.0, retry_count: int = 2,
                 retry_delay: float = 0.0) -> dict:
    """Run one search on an agent: mirror order per HA strategy, retries
    re-pick mirrors (RunSubset retry loop, searchd.cpp:6648-6700)."""
    attempts = max(1, retry_count + 1)
    last: Exception | None = None
    tried = 0
    while tried < attempts:
        for mirror in agent.choose_order():
            if tried >= attempts:
                break
            tried += 1
            payload = dict(query_payload)
            payload["table"] = mirror.table
            try:
                return _request(mirror, CMD_SEARCH, payload, timeout)
            except AgentError as e:
                last = e
                if retry_delay and tried < attempts:
                    time.sleep(retry_delay)
    raise last if last is not None else AgentError("no mirrors")


def agent_update(agent: MultiAgent, ids: list, values: dict,
                 timeout: float = 3.0, retry_count: int = 2,
                 retry_delay: float = 0.0) -> int:
    """Fan an attribute UPDATE out to one mirror of an agent (distributed
    UPDATE, searchd.cpp HandleCommandUpdate); returns rows updated."""
    attempts = max(1, retry_count + 1)
    last: Exception | None = None
    tried = 0
    while tried < attempts:
        for mirror in agent.choose_order():
            if tried >= attempts:
                break
            tried += 1
            payload = {"table": mirror.table, "ids": list(ids),
                       "values": dict(values)}
            try:
                return int(_request(mirror, CMD_UPDATE, payload,
                                    timeout).get("updated", 0))
            except AgentError as e:
                last = e
                if retry_delay and tried < attempts:
                    time.sleep(retry_delay)
    raise last if last is not None else AgentError("no mirrors")


def agent_blackhole(agent: MultiAgent, query_payload: dict,
                    timeout: float = 1.0) -> None:
    """Fire-and-forget copy to a blackhole agent (searchd.cpp:6651):
    errors are swallowed, results discarded."""
    def run():
        for mirror in agent.choose_order()[:1]:
            payload = dict(query_payload)
            payload["table"] = mirror.table
            try:
                _request(mirror, CMD_SEARCH, payload, timeout)
            except AgentError:
                pass
    threading.Thread(target=run, daemon=True).start()


def agent_ping(mirror: AgentMirror, timeout: float = 1.0) -> bool:
    """Dashboard ping (taskping.cpp:119)."""
    try:
        _request(mirror, CMD_PING, {}, timeout)
        return True
    except AgentError:
        return False


# ---------------------------------------------------------------------------
# query (de)serialization — the master->agent search request body
# (SearchRequestBuilder_c / SearchReplyParser_c semantics, searchd.cpp:1540)

def query_to_payload(q) -> dict:
    return {
        "match": q.match,
        "filters": [
            {"attr": f.attr, "kind": f.kind, "values": list(f.values),
             "lo": f.lo, "hi": f.hi, "exclude": f.exclude,
             "lo_excl": f.lo_excl, "hi_excl": f.hi_excl}
            for f in q.filters
        ],
        "limit": q.limit, "offset": q.offset,
        "max_matches": q.max_matches, "ranker": q.ranker,
        "field_weights": q.field_weights, "sort": list(q.sort or []),
        "idf_plain": q.idf_plain,
        "tfidf_normalized": q.tfidf_normalized,
        "select": q.select, "cutoff": q.cutoff,
        "group_by": q.group_by, "having": q.having,
    }


def payload_to_query(p: dict):
    from ..exec.searcher import SearchQuery
    from ..query.planner import AttrFilterDef

    return SearchQuery(
        match=p.get("match", ""),
        filters=[
            AttrFilterDef(f["attr"], f["kind"], values=f.get("values", []),
                          lo=f.get("lo"), hi=f.get("hi"),
                          exclude=f.get("exclude", False),
                          lo_excl=f.get("lo_excl", False),
                          hi_excl=f.get("hi_excl", False))
            for f in p.get("filters", [])
        ],
        limit=int(p.get("limit", 20)), offset=int(p.get("offset", 0)),
        max_matches=int(p.get("max_matches", 1000)),
        ranker=p.get("ranker", "proximity_bm25"),
        field_weights=p.get("field_weights") or {},
        sort=[tuple(s) for s in p.get("sort", [])] or None,
        idf_plain=bool(p.get("idf_plain", False)),
        tfidf_normalized=bool(p.get("tfidf_normalized", True)),
        select=p.get("select"), cutoff=int(p.get("cutoff", 0)),
        group_by=p.get("group_by"),
        having=tuple(p["having"]) if p.get("having") else None,
    )


def result_to_payload(r) -> dict:
    return {
        "error": r.error, "warning": r.warning,
        "total": r.total, "total_found": r.total_found,
        "time_ms": r.time_ms,
        "word_stats": [[w.word, w.docs, w.hits] for w in r.word_stats],
        "matches": [[m.docid, m.weight, _jsonable(m.attrs)]
                    for m in r.matches],
    }


def _jsonable(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out


def payload_to_result(p: dict):
    from ..exec.searcher import Match, SearchResult, WordStat

    return SearchResult(
        matches=[Match(int(d), int(w), a) for d, w, a in p.get("matches", [])],
        total=int(p.get("total", 0)),
        total_found=int(p.get("total_found", 0)),
        time_ms=float(p.get("time_ms", 0.0)),
        word_stats=[WordStat(w, d, h) for w, d, h in p.get("word_stats", [])],
        error=p.get("error"),
        warning=p.get("warning"),
    )


# ---------------------------------------------------------------------------
# server side — the agent listener a daemon exposes

class AgentServer:
    """Serves the agent protocol against a Catalog (the agent side of
    HandleCommandSearch, searchd.cpp:6932 — an agent may itself fan out
    further if the target table is distributed)."""

    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 0):
        self.catalog = catalog
        self.host = host
        self.port = port
        self._server = None

    async def start(self):
        import asyncio
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer):
        import asyncio
        try:
            while True:
                hdr = await reader.readexactly(_HDR.size)
                magic, ver, cmd, ln = _HDR.unpack(hdr)
                if magic != MAGIC:
                    break
                body = await reader.readexactly(ln) if ln else b"{}"
                req = json.loads(body)
                status, reply = await asyncio.get_running_loop() \
                    .run_in_executor(None, self._dispatch, cmd, req)
                out = json.dumps(reply).encode()
                writer.write(_HDR.pack(MAGIC, PROTO_VERSION, status,
                                       len(out)) + out)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    def _dispatch(self, cmd: int, req: dict) -> tuple[int, dict]:
        if cmd == CMD_PING:
            return STATUS_OK, {"pong": True}
        if cmd == CMD_SEARCH:
            try:
                table = self.catalog.get(req["table"])
            except (ValueError, KeyError) as e:
                return STATUS_ERROR, {"error": str(e)}
            try:
                q = payload_to_query(req)
                r = table.search(q)
            except Exception as e:  # noqa: BLE001 — report, don't kill conn
                return STATUS_ERROR, {"error": f"{type(e).__name__}: {e}"}
            prune_attrs_for_select(r.matches, q)
            return STATUS_OK, result_to_payload(r)
        if cmd == CMD_UPDATE:
            try:
                table = self.catalog.get(req["table"])
                n = table.update_attrs([int(x) for x in req["ids"]],
                                       dict(req["values"]))
            except Exception as e:  # noqa: BLE001
                return STATUS_ERROR, {"error": f"{type(e).__name__}: {e}"}
            return STATUS_OK, {"updated": n}
        if cmd == CMD_KEYWORDS:
            # agent-side CALL KEYWORDS (SetupLocalDF fetches per-term df
            # from remote agents this way, searchd.cpp:5869)
            try:
                t = self.catalog.get(req["table"])
            except (ValueError, KeyError) as e:
                return STATUS_ERROR, {"error": str(e)}
            from ..text.dictionary import Dictionary
            from ..text.tokenizer import Tokenizer
            tok = Tokenizer(t.tok_settings)
            dic = Dictionary(t.dict_settings)
            _total, df = t.global_stats()
            kws = []
            for token in tok.tokenize(str(req.get("text", ""))):
                for term in dic.process(token.text) or []:
                    docs = int(df.get(term, 0))
                    hits = 0
                    for seg in t.segments:
                        tid = seg.packed.term_id(term)
                        if tid >= 0:
                            hits += int(seg.packed.term_hits[tid])
                    kws.append({"tokenized": token.text,
                                "normalized": term,
                                "docs": docs, "hits": hits})
            return STATUS_OK, {"keywords": kws}
        return STATUS_ERROR, {"error": f"unknown command {cmd}"}
