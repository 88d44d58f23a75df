"""HTTP frontend: /sql, /cli, /json/* endpoints.

Behavioral model: the reference's HTTP layer (netreceive_http.cpp,
searchdhttp.cpp:1230-1311 endpoint dispatch): /sql (SphinxQL passthrough),
/cli, /json/search, /json/insert, /json/replace, /json/update, /json/delete,
/json/bulk. asyncio replaces the epoll net loop (CSphNetLoop,
networking_daemon.h:72) — queries naturally batch per event-loop tick.

The port's copy of ``manticoresearch_tpu/server/http.py``: one ``Session``
on the catalog serves every request, and ``/json/search`` searches the
catalog's tables on their device.
"""
from __future__ import annotations

import asyncio
import json
import re
import urllib.parse
from typing import Any

from ..exec.session import Catalog, Session
from ..query.jsonquery import (JsonQueryError, JsonSearchError,
                               parse_json_query, render_result)


def _hl_query_text(hq: dict) -> str:
    """Flatten a "highlight_query" json object into its term text (the
    reference stringifies the object and re-parses it as the snippet
    query; bag-of-words terms are what matters for highlighting)."""
    words: list[str] = []

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ("match", "match_phrase") and isinstance(v, dict):
                    for fv in v.values():
                        if isinstance(fv, dict):
                            fv = fv.get("query", "")
                        words.append(str(fv))
                elif k == "query_string":
                    words.append(str(v))
                else:
                    walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(hq)
    return " ".join(words)


def _json_body(body) -> Any:
    """Parse a JSON request body, tolerating trailing garbage after the
    top-level value (the reference's bson parser stops at the end of the
    document — several test harness queries carry a stray '}')."""
    text = (body or b"{}")
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    text = text.strip() or "{}"
    obj, _end = json.JSONDecoder().raw_decode(text)
    return obj


class HttpServer:
    def __init__(self, catalog: Catalog, host: str = "127.0.0.1",
                 port: int = 9308):
        self.catalog = catalog
        self.host = host
        self.port = port
        self.session = Session(catalog, proto="http")
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, path, headers, body = req
                status, ctype, payload = self.handle_request(
                    method, path, headers, body)
                resp = (
                    f"HTTP/1.1 {status}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n"
                    f"Connection: keep-alive\r\n\r\n"
                ).encode() + payload
                writer.write(resp)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            line = await reader.readline()
        except (ConnectionError, asyncio.LimitOverrunError):
            return None
        if not line:
            return None
        parts = line.decode("latin1").strip().split()
        if len(parts) < 2:
            return None
        method, path = parts[0], parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        body = await reader.readexactly(length) if length else b""
        return method, path, headers, body

    # ------------------------------------------------------------------
    def handle_request(self, method: str, path: str, headers: dict,
                       body: bytes) -> tuple[str, str, bytes]:
        """Dispatch one request; returns (status, content_type, payload).
        Synchronous — callable directly from tests."""
        parsed = urllib.parse.urlsplit(path)
        route = parsed.path.rstrip("/") or "/"
        qs = urllib.parse.parse_qs(parsed.query)
        try:
            if route in ("/sql", "/cli"):
                return self._handle_sql(route, qs, body)
            if route == "/json/search" or route == "/search":
                return self._json(self._handle_search(body))
            if route in ("/json/insert", "/insert", "/json/replace",
                         "/replace"):
                return self._json(self._handle_insert(
                    body, replace="replace" in route))
            if route in ("/json/update", "/update"):
                return self._json(self._handle_update(body))
            if route in ("/json/delete", "/delete"):
                return self._json(self._handle_delete(body))
            if route in ("/json/bulk", "/bulk"):
                return self._json(self._handle_bulk(body))
            if route.startswith("/json/pq/") or route.startswith("/pq/"):
                return self._json(self._handle_pq(route, body))
            return ("404 Not Found", "application/json",
                    json.dumps({"error": f"unknown endpoint {route}"})
                    .encode())
        except JsonSearchError as e:
            # query-time errors: 500 with the per-index message
            # (searchdhttp SPH_HTTP_STATUS_500)
            return ("500 Internal Server Error", "application/json",
                    json.dumps({"error": str(e)}).encode())
        except (JsonQueryError, ValueError, KeyError,
                json.JSONDecodeError) as e:
            return ("400 Bad Request", "application/json",
                    json.dumps({"error": str(e)}).encode())

    def _json(self, obj: Any, status: str = "200 OK"):
        return (status, "application/json",
                json.dumps(obj, default=str).encode())

    def _handle_sql(self, route, qs, body: bytes):
        raw_mode = "raw" in (qs.get("mode") or [])
        if route == "/cli":
            sql = body.decode("utf-8")
            raw_mode = True
        else:
            raw = body.decode("utf-8")
            if raw.startswith("query=") or "query" in qs:
                if raw.startswith("query="):
                    sql = urllib.parse.unquote_plus(raw[6:])
                else:
                    sql = qs["query"][0]
            elif raw.startswith("mode=") and "query=" in raw:
                # form body "mode=raw&query=<sql>": the sql part is sent
                # verbatim (clients don't fully url-encode; '+' is
                # literal) — only %XX unquotes
                head, _, tail = raw.partition("query=")
                raw_mode = raw_mode or "mode=raw" in head
                sql = urllib.parse.unquote(tail)
            else:
                sql = raw
        results = self.session.execute(sql)
        is_select = bool(re.match(r"\s*select\b", sql, re.I)) \
            and not raw_mode
        out = []
        for r in results:
            if r.error:
                return ("400 Bad Request", "application/json",
                        json.dumps({"error": r.error}).encode())
            if r.columns and is_select:
                # SELECT over /sql renders the search-result shape
                # (HttpHandler_JsonSearch reuse, searchdhttp.cpp):
                # _source carries every selected column; weight/_score
                # from the result, JSON attrs as parsed objects
                meta = dict(self.session.last_meta)
                hits = []
                for row in r.rows:
                    src = dict(zip(r.columns, row))
                    did = src.pop("id", None)
                    score = src.pop("weight()", src.pop("@weight", 1))
                    for k, v in list(src.items()):
                        if isinstance(v, str) and v[:1] in "[{":
                            try:
                                src[k] = json.loads(v)
                            except ValueError:
                                pass
                    if score is None or score == 1:
                        score = self.session.last_weights.get(
                            did if isinstance(did, int) else
                            int(did or 0), score or 1)
                    hits.append({"_id": str(did),
                                 "_score": int(score), "_source": src})
                out.append({
                    "timed_out": False,
                    "hits": {"total": int(meta.get("total_found",
                                                   len(hits))),
                             "hits": hits},
                })
            elif r.columns:
                def _ctype(ci, c):
                    if c in ("id", "@id"):
                        return "long long"
                    v0 = next((row[ci] for row in r.rows
                               if row[ci] is not None), None)
                    if isinstance(v0, bool):
                        return "long"
                    if isinstance(v0, int):
                        return "long"
                    if isinstance(v0, float):
                        return "float"
                    return "string"
                out.append({
                    "columns": [{c: {"type": _ctype(ci, c)}}
                                for ci, c in enumerate(r.columns)],
                    "data": [dict(zip(r.columns, row)) for row in r.rows],
                    "total": r.affected,
                    "error": "", "warning": r.warning or "",
                })
            else:
                out.append({"total": r.affected, "error": "", "warning":
                            r.warning or ""})
        return self._json(out if len(out) != 1 else out[0])

    def _handle_search(self, body: bytes) -> dict:
        req = _json_body(body)
        index, sq, aggs = parse_json_query(req)
        extras = aggs.pop("__extras__", {}) if aggs else {}
        geo_sort = extras.get("geo_sort")
        mva_sort = extras.get("mva_sort")
        if geo_sort or mva_sort:
            from dataclasses import replace as dc_replace
            limit0, offset0 = sq.limit, sq.offset
            sq = dc_replace(sq, sort=[("weight", False), ("id", True)],
                            offset=0, limit=sq.max_matches)
        if str(index) in ("*", "_all"):
            names = sorted(self.catalog.tables)
        else:
            names = [n.strip() for n in str(index).split(",")
                     if n.strip()]
        if len(names) == 1:
            table = self.catalog.get(names[0])
            res = table.search(sq)
        else:
            # multi-index search: per-part + master merge
            from dataclasses import replace as dc_replace
            from ..exec.multi import merge_part_results
            parts = [self.catalog.get(n) for n in names]
            table = parts[0]
            part_q = dc_replace(sq, offset=0, limit=sq.offset + sq.limit)
            results = [p.search(part_q) for p in parts]
            res = merge_part_results(results, sq, parts[0].schema)
        if res.error:
            raise JsonQueryError(res.error)
        if mva_sort:
            col, mode = mva_sort["col"], mva_sort["mode"]

            def _mkey(m):
                v = m.attrs.get(col)
                vs = v if isinstance(v, list) and v else [0]
                return max(vs) if mode == "max" else min(vs)
            res.matches.sort(key=lambda m: (_mkey(m), m.docid),
                             reverse=not mva_sort["asc"])
            res.matches = res.matches[offset0:offset0 + limit0]
        if geo_sort:
            from ..utils.geodist import geodist_adaptive_deg
            la, lo = geo_sort["lat"], geo_sort["lon"]
            a_lat, a_lon = (geo_sort["attrs"] + ["lat", "lon"])[:2]
            # the reference resolves the pair by NAME when one side is
            # identifiably the latitude (list order does not swap them;
            # recorded behavior, test_329 q6)
            if "lat" in a_lon and "lat" not in a_lat:
                a_lat, a_lon = a_lon, a_lat
            for m in res.matches:
                m.attrs["@geodist"] = geodist_adaptive_deg(
                    la, lo, float(m.attrs.get(a_lat, 0) or 0),
                    float(m.attrs.get(a_lon, 0) or 0))
            res.matches.sort(key=lambda m: (m.attrs["@geodist"],
                                            m.docid),
                             reverse=not geo_sort["asc"])
            res.matches = res.matches[offset0:offset0 + limit0]
            for m in res.matches:
                m.attrs.pop("@geodist", None)
        highlight = self._build_highlights(table, sq, res,
                                           req.get("highlight"))
        aggs_out = {}
        for name, spec in aggs.items():
            terms = spec.get("terms")
            if not terms:
                raise JsonQueryError(f"unsupported agg {name!r}")
            from dataclasses import replace as dc_replace
            # bucket order: group key DESC (searchdhttp.cpp:580 sets
            # m_sGroupSortBy="@groupby desc" for every terms agg)
            gq = dc_replace(
                sq, group_by=terms["field"],
                select=["count(*)"], offset=0,
                limit=int(terms.get("size", 20)),
                sort=[("@groupby", False)])
            gres = table.search(gq)
            if gres.error:
                raise JsonQueryError(gres.error)
            aggs_out[name] = {
                "buckets": [
                    {"key": m.attrs.get(terms["field"]),
                     "doc_count": m.attrs.get("count(*)")}
                    for m in gres.matches
                ]
            }
        stored = [f for f in getattr(table, "stored_fields", ()) or ()
                  if table.schema.attr(f) is None]
        stored_docs = None
        if stored and hasattr(table, "get_document"):
            stored_docs = {
                m.docid: {f: (table.get_document(m.docid) or {}).get(f, "")
                          for f in stored}
                for m in res.matches}
        # script_fields: highlight({opts},'field') inline scripts add
        # computed _source columns (sphinxjsonquery ParseScriptFields)
        sf = req.get("script_fields")
        if sf and hasattr(table, "get_document"):
            import re as _re
            stored_docs = stored_docs or \
                {m.docid: {} for m in res.matches}
            for name, sspec in sf.items():
                inline = ((sspec or {}).get("script") or {}).get(
                    "inline", "")
                mt = _re.match(r"highlight\((\{.*?\}|)\s*,\s*'(\w+)'\)",
                               inline)
                if not mt:
                    raise JsonQueryError(
                        f"unsupported script_fields script: {inline!r}")
                hl_spec = json.loads(mt.group(1)) if mt.group(1) and \
                    mt.group(1) != "{}" else {}
                hl_spec.setdefault("fields", [mt.group(2)])
                hmap = self._build_highlights(table, sq, res, hl_spec)
                for m in res.matches:
                    frags = (hmap or {}).get(m.docid, {}).get(
                        mt.group(2), [])
                    stored_docs.setdefault(m.docid, {})[name] = \
                        " ... ".join(frags)
        out = render_result(res, aggs_out or None, source=sq.select,
                            attr_names={a.name for a in
                                        table.schema.attrs},
                            stored_docs=stored_docs,
                            attr_types={a.name: a.type for a in
                                        table.schema.attrs})
        if highlight:
            for hit in out["hits"]["hits"]:
                hl = highlight.get(hit["_id"])
                if hl is not None:
                    hit["highlight"] = hl
        return out

    def _build_highlights(self, table, sq, res, spec):
        """ES-style "highlight" on /json/search (sphinxjsonquery
        ParseSnippet, sphinxjsonquery.cpp:1930 — elastic + sphinx option
        names, per-field limits, strict option typing)."""
        if spec is None or not res.matches:
            return None
        from ..exec.snippets import SnippetOptions, highlight_fragments
        from ..text.dictionary import Dictionary
        from ..text.tokenizer import Tokenizer

        if not hasattr(table, "get_document"):
            raise JsonQueryError("highlight unsupported for this table type")

        def perr(msg):
            raise JsonQueryError(f"Error parsing json query: {msg}")

        def want_bool(key):
            v = spec.get(key)
            if v is None:
                return None
            if not isinstance(v, bool):
                perr(f'"{key}" property value should be a boolean')
            return v

        def want_int(obj, key):
            v = obj.get(key)
            if v is None:
                return None
            if isinstance(v, bool) or not isinstance(v, int):
                perr(f'"{key}" property value should be an integer')
            return v

        def want_str(key):
            v = spec.get(key)
            if v is None:
                return None
            if not isinstance(v, str):
                perr(f'"{key}" property value should be a string')
            return v

        def read_limits(obj):
            """ParseSnippetLimits{Elastic,Sphinx}: per-field or global."""
            lim = {}
            for src, dst in (("fragment_size", "limit"),
                             ("number_of_fragments", "limit_passages"),
                             ("limit", "limit"),
                             ("limit_passages", "limit_passages"),
                             ("limit_snippets", "limit_passages"),
                             ("limit_words", "limit_words")):
                v = want_int(obj, src)
                if v is not None:
                    lim[dst] = v
            return lim

        # fields: array of names or object {name: {limits}}
        fspec = spec.get("fields")
        per_field: dict = {}
        if isinstance(fspec, dict):
            for fname, fopts in fspec.items():
                if not isinstance(fopts, dict):
                    perr(f'"{fname}" field should be an object')
                per_field[fname] = read_limits(fopts)
        elif isinstance(fspec, list):
            per_field = {str(f): {} for f in fspec}
        elif fspec is not None:
            perr('"fields" property value should be an array or an object')

        stored = list(getattr(table, "stored_fields", ()) or ())
        fields = [f for f in (per_field or {}) if f in table.schema.fields] \
            or list(table.schema.fields)
        fields = [f for f in fields if f in stored]

        opts = SnippetOptions()
        glob = read_limits(spec)
        opts.limit = glob.get("limit", opts.limit)
        opts.limit_passages = glob.get("limit_passages", opts.limit_passages)
        opts.limit_words = glob.get("limit_words", opts.limit_words)

        enc = want_str("encoder")
        if enc == "html":
            opts.html_strip_mode = "retain"
        v = want_str("pre_tags") or want_str("before_match")
        if v:
            opts.before_match = v
        v = want_str("post_tags") or want_str("after_match")
        if v:
            opts.after_match = v
        if "no_match_size" in spec:
            nms = want_int(spec, "no_match_size")
            opts.allow_empty = (nms or 0) < 1
        order = want_str("order")
        if order:
            opts.weight_order = order == "score"
        v = want_int(spec, "around")
        if v is not None:
            opts.around = v
        for key, attr in (("use_boundaries", "use_boundaries"),
                          ("weight_order", "weight_order"),
                          ("force_all_words", "force_all_words"),
                          ("allow_empty", "allow_empty"),
                          ("force_passages", "force_passages"),
                          ("force_snippets", "force_passages")):
            b = want_bool(key)
            if b is not None:
                setattr(opts, attr, b)
        want_bool("emit_zones")
        want_bool("pack_fields")
        want_bool("limits_per_field")
        v = want_str("html_strip_mode")
        if v:
            opts.html_strip_mode = v

        # highlight_query overrides the search query's terms
        # (ParseSnippetOptsElastic, sphinxjsonquery.cpp:1856)
        query = sq.match or ""
        hq = spec.get("highlight_query")
        if hq is not None:
            if not isinstance(hq, dict):
                perr('"highlight_query" property value should be an object')
            query = _hl_query_text(hq)

        tok = Tokenizer(table.tok_settings)
        dic = Dictionary(table.dict_settings)
        out = {}
        for m in res.matches:
            doc = table.get_document(m.docid)
            if doc is None:
                continue
            hl = {}
            for f in fields:
                lim = per_field.get(f, {})
                hl[f] = highlight_fragments(
                    str(doc.get(f, "")), query, tok, dic, opts,
                    limit=lim.get("limit"),
                    limit_words=lim.get("limit_words"),
                    limit_passages=lim.get("limit_passages"))
            out[m.docid] = hl
        return out

    def _handle_insert(self, body: bytes, replace: bool) -> dict:
        req = _json_body(body)
        index = req.get("index") or req.get("table")
        table = self.catalog.get(index)
        doc = dict(req.get("doc") or {})
        doc["id"] = req.get("id") or doc.get("id")
        if not doc.get("id"):
            doc["id"] = max(table.docid_seg, default=0) + \
                len(table.accum) + 1
        table.insert(doc, replace=replace)
        table.commit()
        return {"_index": index, "_id": doc["id"], "created": not replace,
                "result": "updated" if replace else "created", "status": 201}

    def _handle_update(self, body: bytes) -> dict:
        req = _json_body(body)
        index = req.get("index") or req.get("table")
        table = self.catalog.get(index)
        n = table.update_attrs([int(req["id"])], dict(req["doc"]))
        return {"_index": index, "updated": n}

    def _handle_delete(self, body: bytes) -> dict:
        req = _json_body(body)
        index = req.get("index") or req.get("table")
        table = self.catalog.get(index)
        if "id" in req:
            n = table.delete([int(req["id"])])
        elif "query" in req:
            _, sq, _ = parse_json_query({"index": index,
                                         "query": req["query"]})
            sq.limit = sq.max_matches = 10**6
            res = table.search(sq)
            if res.error:
                raise JsonQueryError(res.error)
            n = table.delete([m.docid for m in res.matches])
        else:
            raise JsonQueryError("delete needs 'id' or 'query'")
        table.commit()
        return {"_index": index, "deleted": n}

    def _handle_pq(self, route: str, body: bytes) -> dict:
        """Percolate endpoints: /json/pq/<idx>/search matches docs against
        stored queries; /json/pq/<idx>/doc[?id=N] stores a query
        (sphinxjsonquery pq endpoints)."""
        from ..index.percolate import PercolateIndex

        parts = [p for p in route.split("/") if p]
        # ["json","pq",idx,op] or ["pq",idx,op]
        idx = parts[-2]
        op = parts[-1]
        table = self.catalog.get(idx)
        if not isinstance(table, PercolateIndex):
            raise JsonQueryError(f"'{idx}' is not a percolate table")
        req = _json_body(body)
        if op == "search":
            docs = req.get("query", {}).get("percolate", {}).get(
                "documents") or req.get("documents") or []
            if isinstance(docs, dict):
                docs = [docs]
            matches = table.match_documents(docs)
            hits = []
            for qid, doc_ords in matches:
                q = table.queries[qid]
                hits.append({"_id": qid,
                             "_source": {"query": {"ql": q.query}},
                             "fields": {"_percolator_document_slot":
                                        doc_ords}})
            return {"timed_out": False,
                    "hits": {"total": len(hits), "hits": hits}}
        if op == "doc":
            q = req.get("query", {})
            ql = q.get("ql") or q.get("match", {})
            if isinstance(ql, dict):
                ql = " ".join(str(v) for v in ql.values())
            qid = table.add_query(str(ql),
                                  str(req.get("filters", "")),
                                  req.get("tags"))
            return {"index": idx, "_id": qid, "created": True,
                    "result": "created"}
        raise JsonQueryError(f"unknown pq operation {op!r}")

    def _handle_bulk(self, body: bytes) -> dict:
        items = []
        errors = False
        touched: set[str] = set()
        for line in body.decode("utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            op = json.loads(line)
            try:
                if "insert" in op or "replace" in op or "index" in op:
                    key = ("insert" if "insert" in op else
                           "replace" if "replace" in op else "index")
                    spec = op[key]
                    index = spec.get("index") or spec.get("table")
                    t = self.catalog.get(index)
                    doc = dict(spec.get("doc") or {})
                    doc["id"] = spec.get("id") or doc.get("id")
                    t.insert(doc, replace=key != "insert")
                    touched.add(index)
                    items.append({key: {"_id": doc["id"], "status": 201}})
                elif "delete" in op:
                    spec = op["delete"]
                    index = spec.get("index") or spec.get("table")
                    t = self.catalog.get(index)
                    n = t.delete([int(spec["id"])])
                    touched.add(index)
                    items.append({"delete": {"deleted": n, "status": 200}})
                else:
                    raise JsonQueryError(f"unsupported bulk op {list(op)}")
            except (ValueError, KeyError, JsonQueryError) as e:
                errors = True
                items.append({"error": str(e)})
        for index in touched:
            self.catalog.get(index).commit()
        return {"items": items, "errors": errors}


def run_http_server(catalog: Catalog, host="127.0.0.1", port=9308):
    srv = HttpServer(catalog, host, port)
    asyncio.run(srv.serve_forever())
