"""Port parity: the SphinxAPI listener, JAX vs the port.

Every case of ``tests/test_api_protocol.py`` runs again here against two
listeners: the JAX package's ``ApiServer`` and the port's (on
``Catalog(device="cpu")``), over twin catalogs seeded by the same
statements, both bound to port 0 with the port read back from the
socket. Each request goes to both; the replies must be equal byte for
byte but for the time fields (a search result's ``time_ms``, FLUSHATTRS's
stamp and SHOW STATUS's ``uptime``, masked by ``tests/_torch_wire``).
The case's own assertions then run on the JAX package's reply. A
multi-query of three searches, KEYWORDS without stats and FLUSHATTRS are
held equal too.

Tolerance: exact (bytes).
"""
import asyncio
import struct

import pytest
import torch

import tests.test_api_protocol as base
from manticoresearch_tpu.server.api import ApiServer as JaxApiServer
from manticoresearch_tpu_torch.server.api import ApiServer as PortApiServer
from tests._torch_twin import TwinCatalog, TwinSession
from tests._torch_wire import Listeners, api_masked

torch.set_num_threads(2)
_roundtrip = base._roundtrip


async def twin_roundtrip(ports, cmd, ver, body):
    """One request to the JAX listener and to the port's: the replies
    equal but for their time fields; -> the JAX package's."""
    want = await _roundtrip(ports[0], cmd, ver, body)
    got = await _roundtrip(ports[1], cmd, ver, body)
    assert api_masked(cmd, *got) == api_masked(cmd, *want), (cmd, got, want)
    return want


@pytest.fixture(scope="module")
def api_port():
    cat = TwinCatalog()
    sess = TwinSession(cat)
    sess.execute("CREATE TABLE books (title text, content text, "
                 "price integer, score float)")
    for i in range(1, 21):
        extra = "classic" if i % 3 == 0 else "modern"
        sess.execute(
            f"INSERT INTO books (id, title, content, price, score) VALUES "
            f"({i}, 'book {i}', 'story number {i} is {extra} tale', "
            f"{i * 10}, {i * 0.5})")
    sess.close()
    servers = Listeners(JaxApiServer(cat.jax, port=0),
                        PortApiServer(cat.port, port=0))
    yield tuple(servers.ports)
    servers.close()


@pytest.fixture(autouse=True)
def _twin_roundtrip(monkeypatch):
    monkeypatch.setattr(base, "_roundtrip", twin_roundtrip)


def test_ping(api_port):
    base.test_ping(api_port)


def test_search_basic(api_port):
    base.test_search_basic(api_port)


def test_search_with_range_filter(api_port):
    base.test_search_with_range_filter(api_port)


def test_keywords(api_port):
    base.test_keywords(api_port)


def test_status(api_port):
    base.test_status(api_port)


def test_multi_query_keywords_and_flush(api_port):
    """Three searches in one request (one sorted by an attribute, one with
    an error), KEYWORDS without stats and FLUSHATTRS."""
    one = [base.build_search_body(q, index="books", sort_mode=sm,
                                  sort_by=sb)[8:]
           for q, sm, sb in (("tale", 0, ""), ("story | classic", 2,
                                                "price"),
                             ("tale", 0, ""))]
    one[2] = one[2].replace(base._s("books"), base._s("nosuch"))
    body = struct.pack(">lL", 0, 3) + b"".join(one)
    status, payload = asyncio.run(twin_roundtrip(
        api_port, base.CMD_SEARCH, base.VER_SEARCH, body))
    assert status == base.SEARCHD_OK
    body = base._s("modern story") + base._s("books") + struct.pack(">l", 0)
    status, _ = asyncio.run(twin_roundtrip(
        api_port, base.CMD_KEYWORDS, base.VER_KEYWORDS, body))
    assert status == base.SEARCHD_OK
    status, _ = asyncio.run(twin_roundtrip(api_port, 7, 0x100, b""))
    assert status == base.SEARCHD_OK
