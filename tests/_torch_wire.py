"""Twin front ends: every request to a JAX listener and to the port's.

The listeners of ``manticoresearch_tpu/server`` and of the port's copies
(``manticoresearch_tpu_torch/server``, on ``Catalog(device="cpu")``) get
the same requests; each pair of responses must be equal and the JAX
package's is handed back, so that a test written for the JAX package runs
its own assertions on top.

- ``Listeners`` runs servers (``start`` / ``stop`` coroutines, bound to
  port 0) on one asyncio loop in a thread and sets each ``port`` from its
  socket.
- ``TwinHttp`` dispatches one HTTP request to two ``HttpServer`` objects
  (no socket): status, content type and the JSON body must be equal.
- ``TwinMysqlClient`` is a ``MiniMysqlClient`` (of
  ``tests/test_servers.py``) to each of two MySQL listeners: decoded
  result sets, OK and error packets must be equal.
- ``api_masked`` masks the time fields of a SphinxAPI reply.

Only time fields are masked, each by name: ``took`` in a JSON search
result; the ``time`` row of SHOW META and the ``uptime`` row of SHOW
STATUS in a JSON ``/sql`` answer, a MySQL result set or a SphinxAPI STATUS
reply; a SphinxAPI search result's ``time_ms`` and FLUSHATTRS's stamp.
"""
from __future__ import annotations

import asyncio
import json
import struct
import threading

from tests.test_servers import MiniMysqlClient

MASK = "<masked: time>"
_TIME_ROWS = {("Variable_name", "Value"): "time",      # SHOW META
              ("Counter", "Value"): "uptime"}          # SHOW STATUS
_JSON_TIME_KEYS = ("took",)


class Listeners:
    """Servers on one asyncio loop in a daemon thread, each bound to port
    0; ``ports`` lists the port each was given, in order."""

    def __init__(self, *servers):
        self.servers = servers
        self.loop = asyncio.new_event_loop()
        started = threading.Event()
        failed: list = []

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                for srv in servers:
                    self.loop.run_until_complete(srv.start())
                    srv.port = srv._server.sockets[0].getsockname()[1]
            except Exception as e:   # noqa: BLE001 — handed to the caller
                failed.append(e)
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30), "listeners did not start"
        if failed:
            self.close()
            raise failed[0]
        self.ports = [srv.port for srv in servers]

    def close(self) -> None:
        """Close every listener and cancel its connections' handlers (a
        client may hold a keep-alive connection open)."""
        async def shutdown():
            for srv in self.servers:
                if srv._server is not None:
                    srv._server.close()
            me = asyncio.current_task()
            tasks = [t for t in asyncio.all_tasks() if t is not me]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        asyncio.run_coroutine_threadsafe(shutdown(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        assert not self.thread.is_alive(), "the listeners' loop did not stop"
        self.loop.close()


def mask_json(obj):
    """A decoded JSON answer with its time fields masked."""
    if isinstance(obj, list):
        return [mask_json(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out = {k: MASK if k in _JSON_TIME_KEYS else mask_json(v)
           for k, v in obj.items()}
    for (name_col, value_col), name in _TIME_ROWS.items():
        if out.get(name_col) == name and value_col in out:
            out[value_col] = MASK
    return out


def mask_rows(columns, rows) -> list:
    key = _TIME_ROWS.get(tuple(columns))
    if key is None:
        return [list(r) for r in rows]
    return [[r[0], MASK] + list(r[2:]) if r and r[0] == key else list(r)
            for r in rows]


def mask_mysql(out: dict) -> dict:
    """A ``MiniMysqlClient.query`` answer with its time fields masked."""
    if "rows" not in out:
        return out
    return dict(out, rows=mask_rows(out["columns"], out["rows"]))


class TwinHttp:
    """``handle_request`` on a JAX ``HttpServer`` and a port one."""

    def __init__(self, jax_server, port_server):
        self.jax, self.port = jax_server, port_server

    def handle_request(self, method, path, headers, body):
        want = self.jax.handle_request(method, path, headers, body)
        got = self.port.handle_request(method, path, headers, body)
        assert got[:2] == want[:2], (path, body, got, want)
        assert mask_json(json.loads(got[2])) == \
            mask_json(json.loads(want[2])), (path, body, got[2], want[2])
        return want


class TwinMysqlClient:
    """One ``MiniMysqlClient`` to each of two listeners (JAX first)."""

    def __init__(self, host, ports, use_ssl=False, compress=False):
        self.clients = [MiniMysqlClient(host, p, use_ssl=use_ssl,
                                        compress=compress) for p in ports]

    @property
    def seq(self):
        return self.clients[0].seq

    @seq.setter
    def seq(self, value):
        for c in self.clients:
            c.seq = value

    def query(self, sql):
        want, got = (c.query(sql) for c in self.clients)
        assert mask_mysql(got) == mask_mysql(want), (sql, got, want)
        return want

    def _send_packet(self, payload):
        for c in self.clients:
            c._send_packet(payload)

    def _read_packet(self):
        want, got = (c._read_packet() for c in self.clients)
        assert got == want, (got, want)
        return want

    def close(self):
        for c in self.clients:
            c.close()


# -- SphinxAPI replies ---------------------------------------------------
_API_BIGINT, _API_STRING, _API_MVA = 6, 7, 0x40000001


def _search_time_offsets(b: bytes) -> list[int]:
    """Offsets of the ``time_ms`` field of each result of a SEARCH reply
    (``_send_result`` of ``server/api.py``)."""
    i, offsets = 0, []

    def u32():
        nonlocal i
        (v,) = struct.unpack_from(">L", b, i)
        i += 4
        return v

    def skip_str():
        nonlocal i
        n = u32()
        i += n
    while i < len(b):
        if u32() != 0:                  # an error result: its message
            skip_str()
            continue
        for _ in range(u32()):          # fields
            skip_str()
        attrs = []
        for _ in range(u32()):
            skip_str()
            attrs.append(u32())
        count = u32()
        u32()                           # id64
        for _ in range(count):
            i += 8 + 4                  # docid, weight
            for t in attrs:
                if t == _API_BIGINT:
                    i += 8
                elif t == _API_STRING:
                    skip_str()
                elif t == _API_MVA:
                    n = u32()
                    i += 4 * n
                else:
                    i += 4
        i += 8                          # rows, total_found
        offsets.append(i)
        i += 4                          # time_ms
        for _ in range(u32()):          # word stats
            skip_str()
            i += 8
    return offsets


def _status_masked(b: bytes) -> list:
    n, cols = struct.unpack_from(">ll", b, 0)
    i, vals = 8, []
    for _ in range(n * cols):
        (k,) = struct.unpack_from(">L", b, i)
        vals.append(b[i + 4:i + 4 + k].decode())
        i += 4 + k
    rows = [vals[r * cols:(r + 1) * cols] for r in range(n)]
    return [n, cols, mask_rows(["Counter", "Value"], rows), b[i:]]


def api_masked(cmd: int, status: int, payload: bytes):
    """A SphinxAPI reply (status, body) with its time fields masked."""
    if status != 0:
        return status, payload
    if cmd == 0:                                    # SEARCH
        body = bytearray(payload)
        for off in _search_time_offsets(payload):
            body[off:off + 4] = b"\xff" * 4
        return status, bytes(body)
    if cmd == 5:                                    # STATUS
        return status, _status_masked(payload)
    if cmd == 7:                                    # FLUSHATTRS
        return status, MASK
    return status, payload
