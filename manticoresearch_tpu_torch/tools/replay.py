"""Query-log replay tool.

Behavioral model: the reference's sphinxql-format query log
(searchd.cpp:2918) is valid SphinxQL with a leading /* meta */ comment,
so it can be replayed verbatim. This tool replays a log against a live
daemon (or an in-process catalog) and reports per-query timing vs the
logged wall times — the standard way to reproduce production load.

Usage:
    python -m manticoresearch_tpu_torch.tools.replay --log query.log \
        [--data-dir ./data [--device cuda|cpu] | --host 127.0.0.1 \
        --port 9308] [--limit N]

The port's copy of ``manticoresearch_tpu/tools/replay.py``: with
``--data-dir`` the catalog holds its tables on ``--device`` (the card by
default).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.parse
import urllib.request

_META = re.compile(r"^/\*\s*(.*?)\s*\*/\s*(.*);?\s*$")
_WALL = re.compile(r"wall\s+([0-9.]+)")


def parse_log(path: str, limit: int = 0):
    """Yield (sql, logged_wall_seconds_or_None)."""
    n = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = _META.match(line)
            if m:
                wall = _WALL.search(m.group(1))
                yield m.group(2).rstrip(";"), \
                    float(wall.group(1)) if wall else None
            else:
                yield line.rstrip(";"), None
            n += 1
            if limit and n >= limit:
                return


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="query log replay")
    ap.add_argument("--log", required=True)
    ap.add_argument("--data-dir", help="replay against a local catalog")
    ap.add_argument("--device", default="cuda",
                    help="the device of the local catalog's tables")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9308,
                    help="HTTP /sql port of a running daemon")
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.data_dir:
        from ..exec.session import Catalog, Session
        sess = Session(Catalog(args.data_dir, device=args.device))

        def run(sql):
            rs = sess.execute(sql)
            return next((r.error for r in rs if r.error), None)
    else:
        url = f"http://{args.host}:{args.port}/sql"

        def run(sql):
            req = urllib.request.Request(
                url, data=("query=" + urllib.parse.quote(sql)).encode(),
                method="POST")
            out = json.loads(urllib.request.urlopen(req, timeout=60).read())
            if isinstance(out, dict):
                return out.get("error") or None
            return next((o.get("error") for o in out if o.get("error")),
                        None)

    n = errs = 0
    total = 0.0
    logged = 0.0
    slower = []
    for sql, wall in parse_log(args.log, args.limit):
        t0 = time.perf_counter()
        err = run(sql)
        dt = time.perf_counter() - t0
        total += dt
        n += 1
        if err:
            errs += 1
            if not args.quiet:
                print(f"ERROR: {err}  -- {sql[:100]}", file=sys.stderr)
        if wall is not None:
            logged += wall
            if dt > max(wall * 2, wall + 0.05):
                slower.append((dt, wall, sql[:80]))
    print(f"replayed {n} statements, {errs} errors, "
          f"{total:.3f}s total (log said {logged:.3f}s)")
    for dt, wall, sql in sorted(slower, reverse=True)[:10]:
        print(f"  SLOWER {dt:.3f}s vs {wall:.3f}s: {sql}")
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
