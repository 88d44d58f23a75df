"""SphinxAPI binary protocol frontend (the third listener).

Behavioral model: the reference's legacy API net loop
(Manticore src/netreceive_api.cpp:205 ApiServe,
searchdaemon.h:146-200 command/version tables, searchd.cpp:2320
ParseSearchQuery and :3398 SendResult). Wire format: big-endian; on
accept the server sends DWORD protocol version 1 and reads the
client's DWORD; each request is (WORD command, WORD version, DWORD
body length, body); each reply is (WORD status, WORD version, DWORD
length, body). Strings are DWORD-length-prefixed UTF-8.

Commands implemented: SEARCH (0, v.0x121 wire with master_ver=0),
KEYWORDS (3), PERSIST (4), STATUS (5), FLUSHATTRS (7), PING (9).
Classic sphinxapi clients (PHP/Python/Java) work unmodified.

The port's copy of ``manticoresearch_tpu/server/api.py``. Each request
runs on a worker thread (``asyncio.to_thread``), so concurrent clients
search one table on its device from several threads.
"""
from __future__ import annotations

import asyncio
import struct
import time

SEARCHD_OK = 0
SEARCHD_ERROR = 1
SEARCHD_RETRY = 2
SEARCHD_WARNING = 3

CMD_SEARCH, CMD_EXCERPT, CMD_UPDATE, CMD_KEYWORDS, CMD_PERSIST, \
    CMD_STATUS = 0, 1, 2, 3, 4, 5
CMD_FLUSHATTRS, CMD_SPHINXQL, CMD_PING = 7, 8, 9

VER_SEARCH = 0x121
VER_KEYWORDS = 0x101
VER_STATUS = 0x101
VER_FLUSHATTRS = 0x100
VER_PING = 0x100

# ESphAttr subset (sphinxexpr.h:32-45)
ATTR_INTEGER, ATTR_TIMESTAMP, ATTR_BOOL, ATTR_FLOAT, ATTR_BIGINT, \
    ATTR_STRING = 1, 2, 4, 5, 6, 7
ATTR_JSON = 12
ATTR_MVA = 0x40000001

# rankers (ESphRankMode order)
RANKERS = ["proximity_bm25", "bm25", "none", "wordcount", "proximity",
           "matchany", "fieldmask", "sph04", "expr", "export"]


class _In:
    def __init__(self, body: bytes):
        self.b = body
        self.i = 0

    def dword(self) -> int:
        (v,) = struct.unpack_from(">L", self.b, self.i)
        self.i += 4
        return v

    def int32(self) -> int:
        (v,) = struct.unpack_from(">l", self.b, self.i)
        self.i += 4
        return v

    def qword(self) -> int:
        (v,) = struct.unpack_from(">Q", self.b, self.i)
        self.i += 8
        return v

    def float_(self) -> float:
        (v,) = struct.unpack_from(">f", self.b, self.i)
        self.i += 4
        return v

    def string(self) -> str:
        n = self.dword()
        s = self.b[self.i:self.i + n].decode("utf-8", "replace")
        self.i += n
        return s


class _Out:
    def __init__(self):
        self.parts: list[bytes] = []

    def dword(self, v):
        self.parts.append(struct.pack(">L", v & 0xFFFFFFFF))

    def int32(self, v):
        self.parts.append(struct.pack(">l", int(v)))

    def qword(self, v):
        self.parts.append(struct.pack(">Q", int(v) & (2**64 - 1)))

    def float_(self, v):
        self.parts.append(struct.pack(">f", float(v)))

    def string(self, s):
        b = ("" if s is None else str(s)).encode("utf-8")
        self.dword(len(b))
        self.parts.append(b)

    def body(self) -> bytes:
        return b"".join(self.parts)


def _attr_net_type(schema, name: str) -> int:
    ad = schema.attr(name)
    t = ad.type.value if ad else "uint"
    return {"uint": ATTR_INTEGER, "timestamp": ATTR_TIMESTAMP,
            "bool": ATTR_BOOL, "float": ATTR_FLOAT,
            "bigint": ATTR_BIGINT, "string": ATTR_STRING,
            "json": ATTR_STRING, "mva": ATTR_MVA,
            "mva64": ATTR_MVA}.get(t, ATTR_INTEGER)


def parse_search_query(r: _In, uver: int):
    """ParseSearchQuery (searchd.cpp:2320), master_ver=0 wire."""
    from ..exec.searcher import SearchQuery
    from ..query.planner import AttrFilterDef

    flags = r.dword() if uver >= 0x11B else 0
    offset = r.int32()
    limit = r.int32()
    r.int32()                        # legacy match mode (extended assumed)
    ranker_id = r.int32()
    ranker = RANKERS[ranker_id] if 0 <= ranker_id < len(RANKERS) \
        else "proximity_bm25"
    if ranker in ("expr", "export"):
        ranker = ("expr", r.string())
    sort_mode = r.int32()
    sort_by = r.string()
    query = r.string()
    n_w = r.int32()
    for _ in range(max(0, min(n_w, 4096))):
        r.int32()                    # legacy index weights, ignored
    indexes = r.string()
    id64 = r.int32() != 0
    min_id = r.qword() if id64 else r.dword()
    max_id = r.qword() if id64 else r.dword()
    if max_id in (0, 2**64 - 1, 2**32 - 1):
        max_id = 2**63 - 1
    filters = []
    n_f = r.int32()
    for _ in range(max(0, min(n_f, 256))):
        attr = r.string()
        ftype = r.dword()
        if ftype == 1:               # RANGE
            lo, hi = r.qword(), r.qword()
            f = AttrFilterDef(attr, "range_i", lo=lo, hi=hi)
        elif ftype == 2:             # FLOATRANGE
            lo, hi = r.float_(), r.float_()
            f = AttrFilterDef(attr, "range_f", lo=lo, hi=hi)
        elif ftype == 0:             # VALUES
            cnt = r.int32()
            vals = [r.qword() for _ in range(max(0, min(cnt, 65536)))]
            f = AttrFilterDef(attr, "values", values=vals)
        elif ftype == 3:             # STRING
            f = AttrFilterDef(attr, "values", values=[r.string()])
        else:
            raise ValueError(f"unsupported filter type {ftype}")
        f.exclude = r.dword() != 0
        filters.append(f)
    if min_id != 0 or max_id != 2**63 - 1:
        filters.append(AttrFilterDef("id", "range_i", lo=min_id, hi=max_id))
    r.dword()                        # group func
    group_by = r.string() or None
    max_matches = r.int32()
    r.string()                       # group sort (fixed @count desc here)
    cutoff = r.int32()
    r.int32()                        # retry count
    r.int32()                        # retry delay
    r.string()                       # group distinct
    if r.int32():                    # geo anchor
        r.string()
        r.string()
        r.float_()
        r.float_()
    for _ in range(max(0, r.int32())):   # per-index weights
        r.string()
        r.int32()
    r.dword()                        # max query time
    field_weights = {}
    for _ in range(max(0, r.int32())):
        name = r.string()
        field_weights[name] = r.int32()
    r.string()                       # comment
    if r.int32() > 0:
        raise ValueError("attribute overrides are deprecated")
    select = r.string()
    if uver >= 0x11B and (flags & 512):
        r.int32()                    # max predicted msec
    if uver >= 0x11D:
        r.string()                   # outer order by
        r.dword()
        r.dword()
        r.int32()                    # has outer
    if uver >= 0x121:
        for _ in range(max(0, r.int32())):   # filter tree (none expected)
            r.int32()
            r.int32()
            r.int32()
            r.int32()
    sort = [("weight", False), ("id", True)]
    if sort_mode in (1, 2) and sort_by:
        sort = [(sort_by, sort_mode == 2), ("id", True)]
    elif sort_mode == 4 and sort_by:
        sort = []
        for part in sort_by.split(","):
            toks = part.split()
            if not toks:
                continue
            col = toks[0].replace("@weight", "weight").replace("@id", "id")
            asc = len(toks) > 1 and toks[1].upper() == "ASC"
            sort.append((col, asc))
        sort.append(("id", True))
    q = SearchQuery(
        match=query, filters=filters, offset=offset, limit=limit or 20,
        max_matches=max_matches or 1000, ranker=ranker,
        field_weights=field_weights, sort=sort, cutoff=cutoff,
        group_by=group_by,
        idf_plain=bool(flags & 64),
        tfidf_normalized=not (flags & 0x4000) if uver == 0x11E else True,
    )
    return q, indexes


def _send_result(o: _Out, res, schema, limit: int):
    """SendResult (searchd.cpp:3398), non-agent mode."""
    if res.error:
        o.int32(SEARCHD_ERROR)
        o.string(res.error)
        return
    o.dword(SEARCHD_OK)
    fields = list(schema.fields)
    o.int32(len(fields))
    for f in fields:
        o.string(f)
    attr_names = [a.name for a in schema.attrs]
    field_set = set(fields)
    # grouped results carry synthetic columns (@groupby/@count/...);
    # docstore text fields are not attributes and are not sent
    extra = []
    extra_types = {}
    if res.matches:
        for k, v in res.matches[0].attrs.items():
            if k in attr_names or k in field_set or k in extra:
                continue
            extra.append(k)
            extra_types[k] = (ATTR_BIGINT if k == "@groupby"
                              else ATTR_FLOAT if isinstance(v, float)
                              else ATTR_STRING if isinstance(v, str)
                              else ATTR_INTEGER)
    o.int32(len(attr_names) + len(extra))
    for a in attr_names:
        o.string(a)
        o.dword(_attr_net_type(schema, a))
    for a in extra:
        o.string(a)
        o.dword(extra_types[a])
    rows = res.matches[:limit]
    o.int32(len(rows))
    o.int32(1)                       # id64
    for m in rows:
        o.qword(m.docid)
        o.int32(m.weight)
        for a in attr_names:
            t = _attr_net_type(schema, a)
            v = m.attrs.get(a)
            if t == ATTR_FLOAT:
                o.float_(v or 0.0)
            elif t == ATTR_BIGINT:
                o.qword(v or 0)
            elif t == ATTR_STRING:
                import json as _json
                o.string(v if isinstance(v, str) or v is None
                         else _json.dumps(v))
            elif t == ATTR_MVA:
                vals = v or []
                o.dword(len(vals))
                for x in vals:
                    o.dword(int(x))
            else:
                o.dword(int(v or 0))
        for a in extra:
            v = m.attrs.get(a)
            t = extra_types[a]
            if t == ATTR_BIGINT:
                o.qword(int(v or 0))
            elif t == ATTR_FLOAT:
                o.float_(v or 0.0)
            elif t == ATTR_STRING:
                o.string(v)
            else:
                o.dword(int(v or 0))
    o.int32(len(rows))
    o.dword(res.total_found)
    o.int32(int(res.time_ms))
    o.int32(len(res.word_stats))
    for ws in res.word_stats:
        o.string(ws.word)
        o.dword(ws.docs)
        o.dword(ws.hits)


class ApiServer:
    """asyncio SphinxAPI listener (--listen-api)."""

    def __init__(self, catalog, host: str = "127.0.0.1", port: int = 9312):
        self.catalog = catalog
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        try:
            writer.write(struct.pack(">L", 1))   # my proto version
            await writer.drain()
            await asyncio.wait_for(reader.readexactly(4), 10)
            while True:
                hdr = await reader.readexactly(8)
                cmd, ver, length = struct.unpack(">HHL", hdr)
                body = await reader.readexactly(length) if length else b""
                if cmd == CMD_PERSIST:
                    continue                      # just keep the connection
                reply = await asyncio.to_thread(self._dispatch, cmd, ver,
                                                body)
                writer.write(reply)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.TimeoutError):
            pass
        finally:
            writer.close()

    # ------------------------------------------------------------------
    def _frame(self, status: int, ver: int, body: bytes) -> bytes:
        return struct.pack(">HHL", status, ver, len(body)) + body

    def _error(self, msg: str) -> bytes:
        o = _Out()
        o.string(msg)
        return self._frame(SEARCHD_ERROR, 0, o.body())

    def _dispatch(self, cmd: int, ver: int, body: bytes) -> bytes:
        try:
            if cmd == CMD_SEARCH:
                return self._search(_In(body), ver)
            if cmd == CMD_KEYWORDS:
                return self._keywords(_In(body), ver)
            if cmd == CMD_STATUS:
                return self._status(_In(body))
            if cmd == CMD_PING:
                o = _Out()
                o.int32(_In(body).int32())
                return self._frame(SEARCHD_OK, VER_PING, o.body())
            if cmd == CMD_FLUSHATTRS:
                for t in self.catalog.tables.values():
                    if getattr(t, "data_dir", None):
                        t.flush()
                o = _Out()
                o.int32(int(time.time()))
                return self._frame(SEARCHD_OK, VER_FLUSHATTRS, o.body())
            return self._error(f"unknown command {cmd}")
        except (ValueError, KeyError, struct.error,
                NotImplementedError) as e:
            return self._error(str(e))

    def _search(self, r: _In, uver: int) -> bytes:
        if uver < 0x119:
            return self._error("client version is too old")
        master = r.int32()
        if master != 0:
            return self._error("master-agent mode not supported on this "
                               "listener; use --listen-agent")
        n_q = r.dword()
        if not 1 <= n_q <= 32:
            return self._error(f"bad multi-query count {n_q}")
        o = _Out()
        for _ in range(n_q):
            q, indexes = parse_search_query(r, uver)
            names = [s.strip() for s in indexes.replace(";", ",").split(",")
                     if s.strip()]
            if indexes.strip() == "*" or not names:
                names = list(self.catalog.tables)
            try:
                if len(names) == 1:
                    t = self.catalog.get(names[0])
                    res = t.search(q)
                    schema = t.schema
                else:
                    from ..exec.multi import merge_part_results
                    parts = [self.catalog.get(n) for n in names]
                    rs = [t.search(q) for t in parts]
                    res = merge_part_results(rs, q, parts[0].schema)
                    schema = parts[0].schema
            except ValueError as e:
                class _Err:
                    error = str(e)
                res, schema = _Err(), None
            _send_result(o, res, schema, q.offset + q.limit)
        return self._frame(SEARCHD_OK, VER_SEARCH, o.body())

    def _keywords(self, r: _In, uver: int) -> bytes:
        query = r.string()
        index = r.string()
        stats = r.int32() != 0
        # v.0x101 extras (fold flags + expansion limit) — read & ignore
        if uver >= 0x101 and r.i + 16 <= len(r.b):
            r.int32()
            r.int32()
            r.int32()
            r.int32()
        t = self.catalog.get(index)
        parts = t.searchable_parts()
        o = _Out()
        toks = []
        if parts:
            tokenizer = parts[0].parser.tokenizer
            dictionary = parts[0].parser.dictionary
            for tok in tokenizer.tokenize(query):
                norm = dictionary.process_query_term(tok.text)
                if norm is None:
                    continue
                docs = hits = 0          # stats aggregate over segments
                for part in parts:
                    tid = part.packed.term_id(norm)
                    if tid >= 0:
                        docs += int(part.packed.term_docs[tid])
                        hits += int(part.packed.term_hits[tid])
                toks.append((tok.text, norm, tok.position, docs, hits))
        o.int32(len(toks))
        for raw, norm, qpos, docs, hits in toks:
            o.string(raw)
            o.string(norm)
            if uver >= 0x101:
                o.int32(qpos)
            if stats:
                o.int32(docs)
                o.int32(hits)
        return self._frame(SEARCHD_OK, VER_KEYWORDS, o.body())

    def _status(self, r: _In) -> bytes:
        from ..exec.session import Session
        sess = Session(self.catalog)
        try:
            (res,) = sess.execute("SHOW STATUS")
        finally:
            sess.close()
        o = _Out()
        o.int32(len(res.rows))
        o.int32(2)
        for name, val in res.rows:
            o.string(name)
            o.string(val)
        return self._frame(SEARCHD_OK, VER_STATUS, o.body())
