"""Offline index builder CLI — the `indexer` tool analog
(Manticore src/indexer.cpp: per-index sections, sources, --rotate).

Sources supported: csv, tsv (header row names columns), jsonl (one document
object per line). Column 'id' is required; schema columns map by name.

Usage:
    python -m manticoresearch_tpu_torch.tools.indexer --config conf.toml [index...]
    python -m manticoresearch_tpu_torch.tools.indexer --source docs.jsonl \
        --fields title,body --attrs price=float,cat=uint --out ./idx/name

The port's copy of ``manticoresearch_tpu/tools/indexer.py``.
"""
from __future__ import annotations

import argparse
import csv
import json
import sys
import time


def read_source(path: str, sql_query: str | None = None):
    """Yield document dicts from csv/tsv/jsonl/xmlpipe2/sqlite sources."""
    if path.endswith(".jsonl") or path.endswith(".ndjson"):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield json.loads(line)
    elif path.endswith(".csv") or path.endswith(".tsv"):
        delim = "\t" if path.endswith(".tsv") else ","
        with open(path, "r", encoding="utf-8", newline="") as f:
            for row in csv.DictReader(f, delimiter=delim):
                yield row
    elif path.endswith(".xml"):
        yield from read_xmlpipe2(path)
    elif path.endswith((".db", ".sqlite", ".sqlite3")):
        yield from read_sql_source(path, sql_query)
    else:
        raise ValueError(f"unsupported source format: {path}")


def read_xmlpipe2(path: str):
    """xmlpipe2 source (CSphSource_XMLPipe2, sphinx.cpp:24763-25400):
    <sphinx:docset> with an optional inline <sphinx:schema> and one
    <sphinx:document id=N> per document, streamed via iterparse so
    arbitrarily large dumps index in O(1) memory."""
    import xml.etree.ElementTree as ET

    def tag(e):
        # the sphinx: prefix is not a bound XML namespace in the wire
        # format; some dumps declare it, some don't
        t = e.tag
        return t.split("}", 1)[1] if "}" in t else t.split(":", 1)[-1]

    for _, elem in ET.iterparse(path, events=("end",)):
        t = tag(elem)
        if t == "document":
            doc: dict = {"id": int(elem.get("id", 0))}
            for child in elem:
                doc[tag(child)] = (child.text or "").strip()
            yield doc
            elem.clear()       # free the subtree (streaming)
        elif t == "killlist":
            elem.clear()


def read_sql_source(path: str, sql_query: str | None):
    """SQL source over the stdlib sqlite3 driver (CSphSource_SQL
    semantics, sphinx.h:1788-2347: sql_query rows map by column name,
    first column must be the document id). MySQL/PostgreSQL drivers are
    not vendored in this build — mirror the table into SQLite or use
    csv/jsonl/xmlpipe2 dumps."""
    import sqlite3

    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    con.row_factory = sqlite3.Row
    try:
        q = sql_query or "SELECT * FROM documents"
        for row in con.execute(q):
            d = dict(row)
            if "id" not in d:
                first = list(d)[0]
                d["id"] = d.pop(first)
            yield d
    finally:
        con.close()


def build_one(name: str, schema, tok, dic, source: str, out: str,
              quiet: bool = False, sql_query: str | None = None,
              killlist: list[int] | None = None,
              killlist_target: str = "") -> int:
    from ..index.builder import IndexBuilder
    from ..index.storage import save_packed

    t0 = time.time()
    b = IndexBuilder(schema, tok, dic)
    n = 0
    for doc in read_source(source, sql_query):
        b.add_document(doc)
        n += 1
    packed = b.build()
    save_packed(packed, out)
    if killlist or killlist_target:
        # sidecar kill list (.spk analog, killlist.h:22): docids this
        # index suppresses in its killlist_target tables at rotation
        import json as _json
        import os as _os
        with open(_os.path.join(out, "killlist.json"), "w") as f:
            _json.dump({"ids": [int(x) for x in (killlist or [])],
                        "target": killlist_target}, f)
    if not quiet:
        dt = time.time() - t0
        print(f"index '{name}': {n} docs, {packed.total_hits} hits, "
              f"{packed.n_terms} terms in {dt:.1f}s "
              f"({n / max(dt, 1e-9):.0f} docs/sec)")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="offline index builder")
    ap.add_argument("--config", help="TOML config with [index.*] sections")
    ap.add_argument("indexes", nargs="*", help="index names (default: all)")
    ap.add_argument("--source", help="ad-hoc source file (csv/tsv/jsonl)")
    ap.add_argument("--fields", help="comma-separated full-text fields")
    ap.add_argument("--attrs", help="name=type,... attribute spec")
    ap.add_argument("--out", help="output index directory")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--rotate", action="store_true",
                    help="write to <path>.new and SIGHUP the running "
                         "daemon to swap it in (reference --rotate)")
    ap.add_argument("--sql-query", default=None,
                    help="row query for sqlite sources (sql_query)")
    ap.add_argument("--killlist", default=None,
                    help="comma-separated docids to kill in the "
                         "killlist-target tables at rotation "
                         "(sql_query_killlist analog)")
    ap.add_argument("--killlist-target", default="",
                    help="comma list of target tables, each optionally "
                         ":kl/:id qualified (killlist_target)")
    args = ap.parse_args(argv)

    if args.config:
        from ..config import load_config
        cfg = load_config(args.config)
        wanted = args.indexes or [n for n, ic in cfg.indexes.items()
                                  if ic.type == "plain"]
        for name in wanted:
            ic = cfg.indexes.get(name)
            if ic is None:
                print(f"ERROR: no index '{name}' in config", file=sys.stderr)
                return 1
            if ic.type != "plain":
                print(f"skipping '{name}' (type={ic.type})")
                continue
            if not ic.source or not ic.path:
                print(f"ERROR: index '{name}' needs source and path",
                      file=sys.stderr)
                return 1
            out = ic.path + ".new" if args.rotate else ic.path
            build_one(name, ic.schema, ic.tokenizer, ic.dict, ic.source,
                      out, args.quiet)
            if args.rotate:
                _signal_rotate(ic.path, args.quiet)
        return 0

    if not (args.source and args.out):
        ap.error("either --config or --source/--out required")
    from ..schema import AttrDef, AttrType, Schema
    fields = [s for s in (args.fields or "").split(",") if s]
    attrs = []
    for spec in (args.attrs or "").split(","):
        if not spec:
            continue
        aname, _, atype = spec.partition("=")
        attrs.append(AttrDef(aname, AttrType(atype)))
    schema = Schema(fields=fields, attrs=attrs)
    out = args.out + ".new" if args.rotate else args.out
    kl = [int(x) for x in (args.killlist or "").split(",") if x.strip()]
    build_one(args.out, schema, None, None, args.source, out, args.quiet,
              sql_query=args.sql_query, killlist=kl,
              killlist_target=args.killlist_target)
    if args.rotate:
        _signal_rotate(args.out, args.quiet)
    return 0


def _signal_rotate(index_path: str, quiet: bool) -> None:
    """SIGHUP the daemon whose data_dir contains this index path, if a
    searchd.pid is found (indexer --rotate handoff, indexer.cpp)."""
    import os
    import signal as _sig
    pidfile = os.path.join(os.path.dirname(os.path.abspath(index_path)),
                           "searchd.pid")
    if not os.path.exists(pidfile):
        if not quiet:
            print(f"rotate: no daemon pidfile at {pidfile}; "
                  "run RELOAD TABLES to pick up")
        return
    try:
        pid = int(open(pidfile).read().strip())
        os.kill(pid, _sig.SIGHUP)
        if not quiet:
            print(f"rotate: signalled daemon pid {pid}")
    except (ValueError, OSError) as e:
        if not quiet:
            print(f"rotate: could not signal daemon: {e}")


if __name__ == "__main__":
    sys.exit(main())
