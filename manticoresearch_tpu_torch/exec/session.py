"""SQL session: statement dispatch + catalog (searchd's CSphinxqlSession).

Behavioral model: CSphinxqlSession::Execute (Manticore src/
searchd.cpp:15180-15700): parse -> dispatch per statement kind; SHOW META
reports the last SELECT's stats (per-term docs/hits included); transactions
control RT accumulator commit timing; the catalog mirrors RT-mode
manticore.json table registry (searchdconfig.cpp:481).

The port's copy of ``manticoresearch_tpu/exec/session.py``. ``Catalog``
takes the ``device`` of every table it builds or loads (the card unless
the caller asks for "cpu"); a ``Session`` runs on its catalog's device.
CREATE CLUSTER and JOIN CLUSTER run through the port's ``server.cluster``
(with ``catalog.cluster_service`` set): a joiner's replicated tables
land on its catalog's device.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import time
from dataclasses import dataclass, field, replace as dc_replace
from typing import Any

from ..index.rt import RtIndex
from ..query.expr import ExprError, eval_expr_host, parse_expr
from ..query.planner import AttrFilterDef
from ..query.sphinxql import (AlterStmt, CallStmt, Cond, CreateTableStmt,
                              DeleteStmt, FacetStmt, InsertStmt, SelectStmt,
                              SetStmt, SimpleStmt, SqlParseError, UpdateStmt,
                              parse_sql)
from ..schema import AttrDef, AttrType, Schema
from .searcher import SearchQuery

_COLUMN_TYPES = {
    "text": "field", "string": AttrType.STRING, "uint": AttrType.UINT,
    "int": AttrType.UINT, "integer": AttrType.UINT,
    "bigint": AttrType.BIGINT, "float": AttrType.FLOAT,
    "bool": AttrType.BOOL, "boolean": AttrType.BOOL,
    "timestamp": AttrType.TIMESTAMP, "json": AttrType.JSON,
    "multi": AttrType.MVA, "multi64": AttrType.MVA64,
}


class _NegWrap:
    """Inverts comparison for one key of a mixed-type host sort (DESC)."""
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, o):
        a, b = self.v, o.v
        try:
            return b < a
        except TypeError:
            return str(b) < str(a)

    def __eq__(self, o):
        return self.v == o.v


@dataclass
class QLResult:
    columns: list[str] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    error: str | None = None
    warning: str | None = None
    affected: int = 0

    @staticmethod
    def ok(affected: int = 0) -> "QLResult":
        return QLResult(affected=affected)

    @staticmethod
    def err(msg: str) -> "QLResult":
        return QLResult(error=msg)


class Catalog:
    """Table registry (manticore.json analog)."""

    def __init__(self, data_dir: str | None = None, device="cuda"):
        from .qcache import QueryCache
        self.data_dir = data_dir
        self.device = device      # the device of every table it builds
        self.tables: dict[str, RtIndex] = {}
        self.globals: dict[str, Any] = {}    # SET GLOBAL state
        self.clusters: dict[str, Any] = {}   # name -> server.cluster.Cluster
        self.cluster_service = None          # set by the daemon / tests
        self.qcache = QueryCache()
        # fresh daemon => fresh uid-short counter (SetUidShort at startup,
        # searchd.cpp:19321)
        from ..utils.uid import setup as _uid_setup
        _uid_setup(0, 100000)
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._load_manifest()

    def _manifest_path(self):
        return os.path.join(self.data_dir, "catalog.json")

    def _load_manifest(self):
        p = self._manifest_path()
        if not os.path.exists(p):
            return
        with open(p) as f:
            man = json.load(f)
        self.globals = dict(man.get("globals", {}))
        for name, meta in man.get("tables", {}).items():
            if meta.get("type") == "distributed":
                self.tables[name] = self._make_distributed(
                    name, meta.get("options") or {})
                self.tables[name].options = dict(meta.get("options") or {})
                continue
            schema = Schema.from_json(meta["schema"])
            ddir = os.path.join(self.data_dir, name)
            from ..config import settings_from_sql_options
            tok, dic = settings_from_sql_options(meta.get("options") or {})
            if meta.get("type") == "percolate":
                from ..index.percolate import PercolateIndex
                self.tables[name] = PercolateIndex(name, schema, tok, dic,
                                                   data_dir=ddir,
                                                   device=self.device)
            else:
                self.tables[name] = RtIndex(name, schema, tok, dic,
                                            data_dir=ddir,
                                            device=self.device)
            self.tables[name].options = dict(meta.get("options") or {})

    @staticmethod
    def table_type(t) -> str:
        from ..index.percolate import PercolateIndex
        from .distributed import DistributedTable
        if isinstance(t, DistributedTable):
            return "distributed"
        return "percolate" if isinstance(t, PercolateIndex) else "rt"

    def _save_manifest(self):
        if not self.data_dir:
            return
        man = {"tables": {n: {"schema": t.schema.to_json(),
                              "type": self.table_type(t),
                              "options": getattr(t, "options", {})}
                          for n, t in self.tables.items()},
               "globals": self.globals}
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f)
        os.replace(tmp, self._manifest_path())

    def create(self, name: str, schema: Schema, table_type: str = "rt",
               options: dict | None = None):
        if name in self.tables:
            raise ValueError(f"table '{name}' already exists")
        ddir = os.path.join(self.data_dir, name) if self.data_dir else None
        from ..config import settings_from_sql_options
        opts = options or {}
        if table_type == "distributed":
            self.tables[name] = self._make_distributed(name, opts)
            self.tables[name].options = dict(opts)
            self._save_manifest()
            return self.tables[name]
        tok, dic = settings_from_sql_options(opts)
        if table_type in ("percolate", "pq"):
            from ..index.percolate import PercolateIndex
            self.tables[name] = PercolateIndex(name, schema, tok, dic,
                                               data_dir=ddir,
                                               device=self.device)
        else:
            self.tables[name] = RtIndex(name, schema, tok, dic,
                                        data_dir=ddir, device=self.device)
        self.tables[name].options = dict(opts)
        sf = str(opts.get("stored_fields", "") or "")
        if sf:
            self.tables[name].stored_fields = [
                s.strip() for s in sf.replace(",", " ").split()
                if s.strip()]
        self._save_manifest()
        return self.tables[name]

    def _make_distributed(self, name: str, opts: dict):
        from .distributed import DistributedTable

        def as_list(v):
            return v if isinstance(v, list) else ([v] if v else [])

        return DistributedTable(
            name, self,
            locals_=as_list(opts.get("local")),
            agent_specs=as_list(opts.get("agent")),
            blackhole_specs=as_list(opts.get("agent_blackhole")),
            ha_strategy=str(opts.get("ha_strategy", "random")),
            agent_query_timeout_ms=int(opts.get("agent_query_timeout",
                                                3000)),
            retry_count=int(opts.get("retry_count", 2)),
            retry_delay_ms=int(opts.get("retry_delay", 0)),
        )

    def set_global(self, name: str, value) -> None:
        """Persist a SET GLOBAL server variable (sphinxql_state analog):
        stored in the manifest, reloaded on startup."""
        self.globals[str(name)] = value
        self._save_manifest()

    def rotate(self) -> list[str]:
        """Pick up `<name>.new` index dirs written by `indexer --rotate`
        and atomically swap them in (CheckRotate + seamless rotate,
        searchd.cpp:17476). Returns rotated table names."""
        if not self.data_dir:
            return []
        import glob
        import shutil
        import time as _t

        from ..index.rt import rt_from_packed
        from ..index.storage import load_packed

        rotated = []
        for newdir in sorted(glob.glob(os.path.join(self.data_dir,
                                                    "*.new"))):
            name = os.path.basename(newdir)[:-4]
            try:
                packed = load_packed(newdir)
            except Exception:
                continue                   # partial/corrupt .new: skip
            old = self.tables.get(name)
            if old is not None and getattr(old, "_binlog", None):
                old._binlog.close()
                old._binlog = None
            ddir = os.path.join(self.data_dir, name)
            olddir = ddir + ".old"
            if os.path.isdir(ddir):
                shutil.rmtree(olddir, ignore_errors=True)
                os.rename(ddir, olddir)
            os.rename(newdir, ddir)
            rt = rt_from_packed(name, packed, ddir, device=self.device)
            # fresh table object: key the qcache away from stale entries
            rt.generation = int(_t.time())
            self.tables[name] = rt
            rotated.append(name)
            # klist_target (ApplyKillListsTo, searchd.cpp:15926-16005):
            # the rotated-in index's kill list suppresses rows in its
            # target tables — the classic main+delta workflow
            klpath = os.path.join(ddir, "killlist.json")
            if os.path.isfile(klpath):
                with open(klpath) as f:
                    kl = json.load(f)
                for tgt in str(kl.get("target", "")).split(","):
                    tgt = tgt.strip()
                    mode = "both"
                    if ":" in tgt:
                        tgt, _, mode = tgt.partition(":")
                    t2 = self.tables.get(tgt.strip())
                    if t2 is None:
                        continue
                    ids: list[int] = []
                    if mode in ("kl", "both"):
                        ids += [int(x) for x in kl.get("ids", [])]
                    if mode in ("id", "both"):
                        ids += [int(x) for x in packed.doc_ids.tolist()]
                    if ids and t2.delete(ids):
                        t2.commit()
        if rotated:
            self._save_manifest()
        return rotated

    def drop(self, name: str) -> None:
        t = self.tables.pop(name)
        self._save_manifest()
        if t.data_dir and os.path.isdir(t.data_dir):
            import shutil
            shutil.rmtree(t.data_dir)

    def get(self, name: str) -> RtIndex:
        if name not in self.tables and "." in name:
            # <table>.<N>: single disk-chunk/segment pseudo-table
            # (ParseIdxSubkeys int subkeys, searchd.cpp; golden test_066)
            base, _, suffix = name.rpartition(".")
            if suffix.isdigit() and base in self.tables:
                t = self.tables[base]
                if hasattr(t, "part_view"):
                    return t.part_view(int(suffix))
        if name not in self.tables:
            raise ValueError(f"no such table '{name}'")
        t = self.tables[name]
        if getattr(t, "qcache", None) is not self.qcache:
            t.qcache = self.qcache
        return t


class Session:
    _next_tid = itertools.count(1)
    _registry: "dict[int, Session]" = {}

    def __init__(self, catalog: Catalog, proto: str = "sphinxql",
                 host: str = "local"):
        self.catalog = catalog
        self.autocommit = True
        self.in_txn = False
        self.txn_tables: set[str] = set()
        self.last_meta: list[tuple[str, str]] = []
        self.last_weights: dict[int, int] = {}   # docid -> weight (http)
        self.last_profile: list[tuple[str, float]] = []
        self.last_plan: str | None = None
        self._qcache: dict = {}        # (sql, gens) -> results (opt-in)
        self.query_log: "object | None" = None  # file-like; set by daemon
        self.last_warning: str | None = None
        self.variables: dict[str, Any] = {}
        # user variables (SET GLOBAL @name = (...)) are daemon-global:
        # share one dict per catalog (g_hUservars, searchd.cpp)
        if not hasattr(catalog, "uservars"):
            catalog.uservars = {}
        self.uservars: dict[str, Any] = catalog.uservars
        # vars set via SET INDEX <t> GLOBAL: pushed to that index's agents
        self.uservars_pushed: set = getattr(catalog, "uservars_pushed",
                                            set())
        catalog.uservars_pushed = self.uservars_pushed
        self.start_time = time.time()
        self.queries_done = 0
        # thread registry entry (SHOW THREADS; ThreadSystem_t analog,
        # searchd.cpp thread descriptors)
        self.tid = next(Session._next_tid)
        self.proto = proto
        self.host = host
        self.state = "net_idle"
        self.current_info = ""
        self.last_job_took = 0.0
        self.work_time = 0.0
        Session._registry[self.tid] = self

    def close(self) -> None:
        Session._registry.pop(self.tid, None)

    # ------------------------------------------------------------------
    def execute(self, sql: str) -> list[QLResult]:
        # statements of a batch parse and execute INDEPENDENTLY — a parse
        # error in one yields an error result for it only (test_069)
        from ..query.sphinxql import split_statements
        pieces = split_statements(sql)
        out: list[QLResult] = []
        self.state = "query"
        self.current_info = sql[:512]
        t0 = time.perf_counter()
        # the leading run of SELECTs forms one shared SearchHandler batch:
        # its multiplier row must land in last_meta BEFORE any trailing
        # SHOW META in the same batch reads it (test_226 'select ...
        # facet ...; show meta')
        sel_prefix: list = []
        prefix_open = True
        for piece in pieces:
            try:
                stmts = parse_sql(piece)
            except SqlParseError as e:
                if prefix_open:
                    self._apply_multiplier_meta(sel_prefix)
                    prefix_open = False
                msg = str(e)
                if not msg.startswith("sphinxql:"):
                    msg = f"sphinxql: syntax error: {msg}"
                out.append(QLResult.err(msg))
                continue
            for st in stmts:
                if prefix_open and not isinstance(st, SelectStmt):
                    self._apply_multiplier_meta(sel_prefix)
                    prefix_open = False
                try:
                    out.extend(self._dispatch(st))
                    if prefix_open:
                        sel_prefix.append(st)
                except (ValueError, ExprError, NotImplementedError,
                        KeyError) as e:
                    out.append(QLResult.err(str(e)))
                except Exception as e:  # noqa: BLE001 — crash-query dump
                    # unexpected faults must not kill the serving loop:
                    # dump the offending statement + backtrace to the
                    # daemon log and keep serving (SphCrashLogger_c
                    # crash-query dump, searchd.cpp:17886 'query dump'
                    # + watchdog keep-alive, threadutils.h:181)
                    import logging
                    import traceback as _tb
                    logging.getLogger(
                        "manticoresearch_tpu_torch.daemon").error(
                        "CRASH DUMP\n--- crashed SphinxQL request dump ---"
                        "\n%s\n--- request dump end ---\n%s",
                        piece.strip(), _tb.format_exc())
                    out.append(QLResult.err(
                        f"internal error: {type(e).__name__}: {e}"))
        if prefix_open:
            self._apply_multiplier_meta(sel_prefix)
        self.last_job_took = time.perf_counter() - t0
        self.work_time += self.last_job_took
        self.state = "net_idle"
        return out

    def _dispatch(self, st) -> list[QLResult]:
        if isinstance(st, SelectStmt):
            return self._select(st)
        if isinstance(st, InsertStmt):
            return [self._insert(st)]
        if isinstance(st, DeleteStmt):
            return [self._delete(st)]
        if isinstance(st, UpdateStmt):
            return [self._update(st)]
        if isinstance(st, CreateTableStmt):
            return [self._create_table(st)]
        if isinstance(st, AlterStmt):
            return [self._alter(st)]
        if isinstance(st, SetStmt):
            if st.name.startswith("@"):
                # user variables are daemon-global value lists
                # (g_hUservars, searchd.cpp)
                self.uservars[st.name] = st.value
                if getattr(st, "pushed_to_agents", False):
                    self.uservars_pushed.add(st.name)
                else:
                    self.uservars_pushed.discard(st.name)
                return [QLResult.ok()]
            if st.name == "autocommit":
                self.autocommit = bool(int(st.value))
            elif st.name in ("qcache_max_bytes", "qcache_thresh_msec",
                             "qcache_ttl_sec"):
                # reference qcache knobs (sphinxqcache.cpp QcacheSetup);
                # changing any setting resets the cache, like the reference
                setattr(self.catalog.qcache,
                        st.name.removeprefix("qcache_"), int(st.value))
                self.catalog.qcache.clear()
            elif getattr(st, "is_global", False):
                # SET GLOBAL persists across restarts via the catalog
                # manifest (sphinxql_state file semantics)
                self.catalog.set_global(st.name, st.value)
                self.variables[st.name] = st.value
            else:
                self.variables[st.name] = st.value
            return [QLResult.ok()]
        if isinstance(st, CallStmt):
            return [self._call(st)]
        if isinstance(st, SimpleStmt):
            return [self._simple(st)]
        return [QLResult.err(f"unhandled statement {type(st).__name__}")]

    # -- SELECT ---------------------------------------------------------
    def _select(self, st: SelectStmt) -> list[QLResult]:
        if not st.indexes:
            # SELECT <exprs> without FROM — includes MySQL client handshake
            # probes (@@version_comment etc., HandleMysqlSelectSysvar in the
            # reference, searchd.cpp)
            cols, row = [], []
            for it in st.items:
                cols.append(it.alias or it.display or it.expr)
                low = it.expr.strip().lower()
                if low.startswith("@@"):
                    row.append(self._sysvar(low[2:]))
                    continue
                fn = low.replace(" ", "")
                if fn in ("database()", "schema()"):
                    row.append("Manticore")
                    continue
                if fn == "user()":
                    row.append("root")
                    continue
                if fn == "current_user()":
                    # connection class, not a login (searchd "Usual"/"VIP")
                    row.append("Usual")
                    continue
                if fn == "connection_id()":
                    row.append(1)
                    continue
                tree = parse_expr(it.expr)
                row.append(eval_expr_host(tree, {}))
            return [QLResult(columns=cols, rows=[tuple(row)])]

        if len(st.indexes) == 1 and st.indexes[0].endswith(".status"):
            base = st.indexes[0][: -len(".status")]
            t0 = self.catalog.tables.get(base)
            if t0 is not None and hasattr(t0, "chunk_status"):
                return [self._select_index_status(st, t0)]

        # percolate tables list stored queries — their WHERE surface (id,
        # tags ANY/ALL) differs from document queries, so route BEFORE the
        # generic filter build
        from ..index.percolate import PercolateIndex as _PQ
        _tabs0 = [self.catalog.get(n) for n in st.indexes]
        if len(_tabs0) == 1 and isinstance(_tabs0[0], _PQ):
            pq = _tabs0[0]
            try:
                stored = _filter_stored_queries(
                    sorted(pq.queries.values(), key=lambda x: x.qid),
                    st.conds)
            except ValueError as e:
                return [QLResult.err(str(e))]
            lim = st.limit if st.limit is not None else 20
            qrows = [{"id": q2.qid, "query": q2.query,
                      "tags": " ".join(q2.tags), "filters": q2.filters}
                     for q2 in stored]
            if st.group_by:
                # SELECT ... GROUP BY over stored queries: group head is
                # the first-inserted query, count(*) the group size
                key = st.group_by
                groups: dict = {}
                for r0 in qrows:
                    groups.setdefault(r0.get(key), []).append(r0)
                grows = []
                for gkey, members in groups.items():
                    head = dict(members[0])
                    head["count(*)"] = len(members)
                    grows.append(head)
                qrows = grows
            # projection: plain columns, count(*) aliases, or *
            items = [(it.expr.strip(), it.alias) for it in st.items]
            if items and not (len(items) == 1 and items[0][0] == "*"):
                cols_out, rows_out = [], []
                for expr, alias in items:
                    cols_out.append(alias or expr)
                for r0 in qrows:
                    row0 = []
                    for expr, alias in items:
                        e = expr.lower().replace(" ", "")
                        if e == "count(*)":
                            row0.append(r0.get("count(*)", 1))
                        else:
                            row0.append(r0.get(expr, ""))
                    rows_out.append(tuple(row0))
                rows = rows_out[st.offset:st.offset + lim]
                return [QLResult(columns=cols_out, rows=rows)]
            rows = [(r0["id"], r0["query"], r0["tags"], r0["filters"])
                    for r0 in qrows]
            rows = rows[st.offset:st.offset + lim]
            return [QLResult(columns=["id", "query", "tags", "filters"],
                             rows=rows)]

        # the old-fashion @variables are rejected on the QL surface
        # (sphinxql.y deprecation errors)
        _at_re = re.compile(r"@(id|count|weight|distinct|groupby|expr)\b",
                            re.I)
        _texts = [it.expr for it in st.items] \
            + ([st.group_by] if st.group_by else []) \
            + [c for c, _ in st.order] \
            + [c for c, _ in st.within_order]
        for _t in _texts:
            if _t and _at_re.search(str(_t)):
                if any(it.alias for it in st.items) or any(
                        _at_re.search(str(it.expr)) is None
                        and it.expr != "*" for it in st.items):
                    return [QLResult.err(
                        "Mixing the old-fashion internal vars (@id, "
                        "@count, @weight) with new acronyms is not "
                        "allowed")]
                return [QLResult.err(
                    "Using the old-fashion @variables (@count, @weight, "
                    "etc.) is deprecated")]

        q, err = self._build_query(st)
        if err:
            return [QLResult.err(err)]

        tables = [self.catalog.get(n) for n in st.indexes]
        if st.facets:
            # facet aliases must not collide with the head query's output
            # columns or each other (the reference's facet schema merge
            # rejects duplicate dynamic attrs; test_226 'facet brand_id
            # as price' against a selected 'price')
            names = set()
            for it in st.items:
                if it.expr.strip() == "*":
                    names.add("id")
                    names.update(a.name.lower()
                                 for a in tables[0].schema.attrs)
                else:
                    names.add((it.alias or it.display or it.expr).lower())
            for fc in st.facets:
                for it in fc.items:
                    if it.alias:
                        al = it.alias.lower()
                        if al in names:
                            return [QLResult.err(
                                f"index {st.indexes[0]}: alias "
                                f"'{it.alias}' must be unique (conflicts "
                                "with another alias)")]
                        names.add(al)
        if q.group_by:
            # aggregates over non-scalar attrs are a parse error in the
            # reference ("can not aggregate non-scalar attribute")
            import re as _re
            agg_chk = _re.compile(
                r"^\s*(sum|min|max|avg)\s*\(\s*(\w+)\s*\)\s*$", _re.I)
            for sel in (q.select or []):
                m2 = agg_chk.match(sel)
                if not m2:
                    continue
                ad = tables[0].schema.attr(m2.group(2))
                if ad is not None and ad.type.value in (
                        "multi", "multi64", "string", "json"):
                    return [QLResult.err(
                        f"index {st.indexes[0]}: can not aggregate "
                        f"non-scalar attribute '{m2.group(2)}'")]
        expr_sort = None
        if q.sort and not q.group_by and tables:
            # over a multi-part FROM, an ORDER BY attr that only SOME
            # parts carry stays a plain sort: each part builds its own
            # sorter and the ones lacking the attr fail out of the merge
            # (searchd.cpp RunLocalSearches; golden test_163) — it must
            # NOT be re-routed into the host expression sort
            prim0 = q.sort[0][0]
            if not (tables[0].schema.attr(prim0) is None
                    and re.match(r"^[A-Za-z_]\w*$", prim0 or "")
                    and any(s.attr(prim0) is not None
                            for s in _part_schemas(tables))):
                expr_sort = self._resolve_expr_sort(
                    st, q, tables[0].schema, tables[0])
        group_agg_sort = None
        if q.group_by and q.sort:
            # ORDER BY an aggregate (AVG/SUM/MIN/MAX alias): the device
            # groups under the default order, the host re-sorts group rows
            # on the aggregate value (the reference's group sorter keys on
            # m_tLocator of the aggregate attr, sphinxsort.cpp)
            prim, asc0 = q.sort[0]
            pl = prim.lower().replace(" ", "")
            if _AGG_RE.match(prim) and not pl.startswith("count("):
                # every group must exist before the max_matches cut — the
                # reference's group sorter evicts by the aggregate key, so
                # the kept groups are the BEST max_matches, not the first
                try:
                    nd = sum(getattr(self.catalog.get(n2), "n_docs", 0)
                             for n2 in st.indexes)
                except ValueError:
                    nd = 0
                group_agg_sort = (prim, asc0, q.offset,
                                  q.limit if q.limit is not None else 20,
                                  q.max_matches)
                q = dc_replace(q, sort=None, offset=0,
                               limit=max(q.max_matches, nd),
                               max_matches=max(q.max_matches, nd))
        if len(tables) == 1:
            res = tables[0].search(q)
        elif q.group_by:
            # multi-index GROUP BY: per-part results merge by key with
            # cross-part docid dedup (search orchestrator semantics)
            from .multi import search_grouped_parts
            res = search_grouped_parts(tables, q, tables[0].schema)
        else:
            from .multi import merge_part_results, minimize_result_schema
            parts = [t.search(dc_replace(q, offset=0,
                                         limit=q.offset + q.limit))
                     for t in tables]
            res = merge_part_results(parts, q, tables[0].schema)
            if res.error is None:
                res.schema = minimize_result_schema(
                    parts, [t.schema for t in tables])
        if group_agg_sort is not None and res.error is None:
            prim, asc0, off0, lim0, mm0 = group_agg_sort
            key = next((k for k in (res.matches[0].attrs if res.matches
                                    else {})
                        if k.lower().replace(" ", "")
                        == prim.lower().replace(" ", "")), prim)
            res.matches.sort(
                key=lambda m: (m.attrs.get(key) is not None,
                               m.attrs.get(key) or 0),
                reverse=not asc0)
            res.matches = res.matches[:mm0][off0:off0 + lim0]
        if expr_sort is not None and res.error is None:
            tree, asc, offset, limit = expr_sort
            if tree == "__rand__":
                import random
                random.shuffle(res.matches)
            else:
                def _val(m, _t=tree):
                    try:
                        return eval_expr_host(_t, m.attrs, m.weight,
                                              m.docid)
                    except ExprError:
                        return None
                def _k(m):
                    v = _val(m)
                    # missing values (absent JSON path) compare as the
                    # smallest value (null==0 — golden test_234)
                    if v is None:
                        return (-1, 0)
                    if isinstance(v, (int, float)) \
                            and not isinstance(v, bool):
                        return (0, v)
                    return (1, str(v))
                res.matches.sort(key=_k, reverse=not asc)
            res.matches = res.matches[offset:offset + limit]
        if (q.group_by == "1" and st.group_by is None and res.error is None
                and not res.matches):
            # implicit aggregation over an empty match set returns one row
            # of zero counts (SQL semantics)
            from .searcher import Match
            attrs = {}
            for it in st.items:
                e = it.expr.lower().replace(" ", "")
                attrs[it.expr] = 0 if e.startswith("count(") else None
            # id and plain attrs render as wire NULLs on this row
            # (golden test_163 q37: select *, count(*) over no matches)
            nm = Match(None, 0, attrs)
            nm._null_row = True
            res.matches.append(nm)
        self.queries_done += 1
        if res.error:
            return [QLResult.err(res.error)]
        self._store_meta(res)
        self.last_profile = list(getattr(res, "profile", []))
        self.last_plan = getattr(res, "plan_repr", None) or self.last_plan
        self.last_warning = res.warning
        if self.query_log is not None:
            # replayable SphinxQL-format query log (searchd.cpp:2918)
            import time as _t
            stamp = _t.strftime("%Y-%m-%d %H:%M:%S")
            stmt = (self.current_info or "").strip().rstrip(";")
            self.query_log.write(
                f"/* {stamp} conn {self.tid} real "
                f"{res.time_ms / 1000.0:.3f} "
                f"wall {res.time_ms / 1000.0:.3f} found {res.total_found} "
                f"*/ {stmt};\n")
            self.query_log.flush()

        main = self._project(st, res,
                             getattr(res, "schema", None)
                             or tables[0].schema, tables[0])
        out = [main]
        for fc in st.facets:
            out.append(self._facet(st, fc, tables))
        return out

    def _build_query(self, st: SelectStmt):
        match = ""
        filters: list[AttrFilterDef] = []
        # WHERE may reference select aliases: resolve alias -> its
        # expression text (plain attr aliases land on the device filter
        # path; computed ones become late filters)
        amap = {it.alias: it.expr for it in st.items
                if it.alias and it.expr != it.alias}

        def _convert_cond(c) -> str | None:
            """Lower one WHERE condition into `filters` entries; returns
            an error string or None."""
            was_alias = c.attr in amap
            if was_alias:
                c = dc_replace(c, attr=amap[c.attr])
            if c.kind == "cmp" and c.attr.lower().replace(" ", "") in (
                    "@count", "count(*)", "@distinct"):
                return ("aggregates in 'where' clause prohibited, "
                        "use 'HAVING'")
            if c.attr.startswith("@") and c.attr.lower() not in (
                    "@id",):
                return ("Using the old-fashion @variables (@count, "
                        "@weight, etc.) is deprecated")
            from_uservar = False
            if c.kind == "in" and len(c.values) == 1 \
                    and isinstance(c.values[0], str) \
                    and c.values[0].startswith("@"):
                # id IN @uservar: resolve the stored value list
                _vname = c.values[0]
                uv = self.uservars.get(_vname)
                if uv is None:
                    return f"undefined variable {_vname}"
                c = dc_replace(c, values=list(uv)
                               if isinstance(uv, (list, tuple)) else [uv])
                from_uservar = _vname not in self.uservars_pushed
            m_any = re.match(r"^(any|all)\((\w+)\)$", c.attr, re.I)
            if m_any and c.kind == "between":
                is_any = m_any.group(1).lower() == "any"
                nm2 = m_any.group(2)
                kind2 = "mva_any_range" if is_any != c.negate \
                    else "mva_all_range"
                # NOT BETWEEN inverts: any not between == NOT(all in
                # range); all not between == NOT(any in range)
                filters.append(AttrFilterDef(
                    nm2, "mva_all_range" if (not is_any) != c.negate
                    else "mva_any_range",
                    lo=c.lo, hi=c.hi, exclude=c.negate))
                return None
            if m_any and c.kind in ("cmp", "in"):
                # ANY(mva) op v: exists an element satisfying op;
                # ALL(mva) op v: every element satisfies op
                # (Filter_MVA ANY/ALL, sphinxfilter.cpp)
                is_any = m_any.group(1).lower() == "any"
                nm2 = m_any.group(2)
                if c.kind == "in":
                    # any IN set -> element ∈ set exists;
                    # any NOT IN set -> NOT(subset);
                    # all IN set -> subset; all NOT IN -> no element ∈ set
                    if is_any and not c.negate:
                        filters.append(AttrFilterDef(
                            nm2, "mva_any", values=c.values))
                    elif is_any:
                        filters.append(AttrFilterDef(
                            nm2, "mva_subset", values=c.values,
                            exclude=True))
                    elif not c.negate:
                        filters.append(AttrFilterDef(
                            nm2, "mva_subset", values=c.values))
                    else:
                        filters.append(AttrFilterDef(
                            nm2, "mva_any", values=c.values,
                            exclude=True))
                    return None
                v = c.value
                if c.op == "=":
                    filters.append(AttrFilterDef(
                        nm2, "mva_any" if is_any else "mva_all_range",
                        values=[v], lo=v, hi=v))
                elif c.op in ("!=", "<>"):
                    # any != v == NOT(all == v); all != v == NOT(any == v)
                    if is_any:
                        filters.append(AttrFilterDef(
                            nm2, "mva_all_range", lo=v, hi=v,
                            exclude=True))
                    else:
                        filters.append(AttrFilterDef(
                            nm2, "mva_any", values=[v], exclude=True))
                else:
                    lo = v if c.op in (">", ">=") else None
                    hi = v if c.op in ("<", "<=") else None
                    kind2 = "mva_any_range" if is_any \
                        else "mva_all_range"
                    filters.append(AttrFilterDef(
                        nm2, kind2, lo=lo, hi=hi,
                        lo_excl=c.op == ">", hi_excl=c.op == "<"))
                return None
            if c.kind == "isnull":
                # IS [NOT] NULL on plain string/MVA attrs has no null
                # concept: the filter passes everything (reference
                # accepts-and-ignores); JSON paths evaluate host-side
                try:
                    sch = self.catalog.get(st.indexes[0]).schema
                    ad0 = sch.attr(c.attr)
                except (ValueError, KeyError, IndexError):
                    ad0 = None
                if ad0 is not None and ad0.type.value in (
                        "string", "multi", "multi64"):
                    return None
                if ad0 is not None and ad0.type.value == "json" \
                        and not was_alias:
                    # IS [NOT] NULL directly on a JSON column passes
                    # everything ({} rows included); only the expression
                    # path (via a select alias) treats {} as null
                    # (golden test_318 queries 3 vs 4)
                    return None
            f, err = _cond_to_filter(c)
            if err:
                return err
            if from_uservar:
                f = dc_replace(f, uservar=True)
            try:
                ad0 = self.catalog.get(st.indexes[0]).schema.attr(f.attr)
            except (ValueError, KeyError, IndexError):
                ad0 = None
            if ad0 is not None and ad0.type.value in ("multi",
                                                      "multi64"):
                # bare filters on MVA columns default to ANY() with a
                # warning (sphinxfilter.cpp CreateFilter MVA notice)
                self._pending_warning = (
                    f"index {st.indexes[0]}: suggest an explicit "
                    f"ANY()/ALL() around a filter on MVA column")
            filters.append(f)
            return None

        tree_nodes: list = []   # boolean node per top-level cond (or None)
        saw_or = False

        def _convert_tree(node):
            """Lower a boolean cond tree -> ("leaf"/"and"/"or", ...) over
            `filters` indices. None = always-true (vanished cond).
            Raises ValueError on conversion errors."""
            nonlocal saw_or
            if isinstance(node, Cond):
                if node.kind == "match":
                    raise ValueError(
                        "MATCH() must be the top-level condition "
                        "(cannot appear inside OR)")
                i0 = len(filters)
                err2 = _convert_cond(node)
                if err2:
                    raise ValueError(err2)
                leaves = tuple(("leaf", i2)
                               for i2 in range(i0, len(filters)))
                if not leaves:
                    return None
                return leaves[0] if len(leaves) == 1 \
                    else ("and", leaves)
            op2, kids2 = node
            parts = [_convert_tree(k2) for k2 in kids2]
            if op2 == "or":
                saw_or = True
                if any(p is None for p in parts):
                    return None     # an always-true branch wins the OR
            else:
                parts = [p for p in parts if p is not None]
                if not parts:
                    return None
            return parts[0] if len(parts) == 1 else (op2, tuple(parts))

        for c in st.conds:
            if c.kind == "match":
                match = c.value
                continue
            if c.kind == "ortree":
                try:
                    tree_nodes.append(_convert_tree(c.value))
                except ValueError as e:
                    return None, str(e)
                continue
            i0 = len(filters)
            err = _convert_cond(c)
            if err:
                return None, err
            tree_nodes.extend(("leaf", i2)
                              for i2 in range(i0, len(filters)))

        filter_tree = None
        if saw_or:
            nodes = [n for n in tree_nodes if n is not None]
            filter_tree = (None if not nodes
                           else nodes[0] if len(nodes) == 1
                           else ("and", tuple(nodes)))

        # no ORDER BY = implicit relevance sort, kept as None so merge
        # layers can tell it apart from an explicit `ORDER BY weight()
        # DESC, id ASC` (the reference uses FUNC_REL_DESC with rowid
        # ties for the implicit case; golden test_066)
        sort = [(col, asc) for col, asc in st.order] or None
        # ORDER BY names are case-insensitive against the schema
        if sort:
            try:
                schema0 = self.catalog.get(st.indexes[0]).schema
                cmap = {n.lower(): n for n in
                        [a.name for a in schema0.attrs] + schema0.fields}
                sort = [(cmap.get(c.lower(), c), a) for c, a in sort]
            except (ValueError, KeyError, IndexError):
                pass
        opts = st.options
        if "reverse_scan" in opts:
            # parse-time rejection (searchdsql.cpp:599; golden test_239)
            return None, "reverse_scan is deprecated"
        q = SearchQuery(
            match=match,
            filters=filters,
            filter_tree=filter_tree,
            offset=st.offset,
            limit=st.limit,
            max_matches=int(opts.get("max_matches", 1000)),
            cutoff=int(opts.get("cutoff", 0)),
            ranker=opts.get("ranker", "proximity_bm25"),
            field_weights={k: int(v) for k, v in
                           opts.get("field_weights", {}).items()},
            sort=sort,
            idf_plain="plain" in str(opts.get("idf", "")),
            expansion_limit=int(opts.get("expansion_limit", 0)),
            boolean_simplify=str(opts.get("boolean_simplify", "0")) == "1",
            expand_keywords=str(opts.get("expand_keywords", "0")) == "1",
            global_idf=str(opts.get("global_idf", "0")) == "1",
            collation=str(self.variables.get("collation_connection",
                                             "libc_ci")).lower(),
            tfidf_normalized="tfidf_unnormalized" not in str(opts.get("idf", "")),
            # select carries EXPRESSIONS for the engine: an aliased
            # PACKEDFACTORS()/aggregate must keep its function form
            # (aliases only rename output columns); aggregate args that
            # reference earlier select ALIASES resolve to their exprs
            # (count(distinct i) with `j.id i`, golden test_412)
            select=_engine_select(st.items),
            group_by=st.group_by,
            group_n=int(getattr(st, "group_n", 1) or 1),
            having=st.having,
            within_sort=(st.within_order or None),
            not_only_allowed=(
                str(opts.get(
                    "not_terms_only_allowed",
                    getattr(self.catalog, "searchd_opts", {}).get(
                        "not_terms_only_allowed", "0"))) == "1"),
        )
        if not st.group_by:
            # implicit single-group aggregation: SELECT COUNT(*)/SUM(x)...
            # without GROUP BY groups the whole match set (reference
            # implicit-grouping semantics)
            exprs = [it.expr for it in st.items]
            if exprs and any(_is_aggregate_expr(e) for e in exprs):
                st = dc_replace(st, group_by="1")
                q.group_by = "1"
                q.implicit_group = True
        if st.group_by:
            # aggregates are recognized from raw expr text; args that
            # reference select aliases resolve to the aliased expressions
            q.select = [_resolve_agg_args(it.expr, st.items)
                        if _is_aggregate_expr(it.expr) else it.expr
                        for it in st.items]
            # ORDER BY may name a SELECT alias (ORDER BY c DESC with
            # count(*) AS c): resolve to the aggregate's expr text
            amap = {it.alias: it.expr for it in st.items if it.alias}
            q.sort = [(amap.get(col, col), asc)
                      for col, asc in (q.sort or [])] or None
            if q.group_by in amap and amap[q.group_by] != q.group_by:
                # GROUP BY a select alias: group on its expression, but
                # expose the alias column from the group key
                alias_gb = q.group_by
                q.group_by = amap[alias_gb]
                q.within_sort = q.within_sort and [
                    (amap.get(c, c), a) for c, a in q.within_sort]
            if q.having is not None:
                # HAVING may reference a SELECT alias (HAVING c > 1 with
                # count(*) AS c): resolve back to the aggregate's expr text
                col, op_s, val = q.having
                for it in st.items:
                    if it.alias == col:
                        col = it.expr
                        break
                q.having = (col, op_s, val)
        return q, None

    def _sysvar(self, name: str):
        """@@system variable values (the reference answers a fixed set for
        client compatibility, HandleMysqlSelectSysvar)."""
        from .. import __version__
        name = name.removeprefix("session.").removeprefix("global.")
        fixed = {
            "version": f"5.5.21-{__version__}",
            "version_comment": "manticoresearch-tpu",
            "max_allowed_packet": 8388608,
            "autocommit": int(self.autocommit),
            "character_set_client": "utf8",
            "character_set_connection": "utf8",
            "collation_connection": "utf8_general_ci",
            "lower_case_table_names": 1,
            "sql_auto_is_null": 0,
            "sql_mode": "",
            "session_read_only": 0,
            "auto_increment_increment": 1,
        }
        if name in fixed:
            return fixed[name]
        return self.variables.get(name, 0)

    def _resolve_expr_sort(self, st: SelectStmt, q, schema, table=None):
        """ORDER BY <expr or select-alias>: the device sorts by rel, the
        final top-max_matches re-sorts host-side on the evaluated expression
        (the reference's expression sorters, sphinxsort.cpp comparators over
        computed columns). Mutates q; returns (tree, asc, offset, limit)."""
        primary, asc = q.sort[0]
        p = primary.lower().replace(" ", "")
        if p == "rand()":
            offset, limit = q.offset, q.limit
            q.sort = [("weight", False), ("id", True)]
            q.offset = 0
            q.limit = max(q.max_matches, offset + limit)
            return ("__rand__", asc, offset, limit)
        if p in ("weight", "@weight", "weight()", "id", "@id"):
            return None
        if schema.attr(primary) is not None:
            return None
        text = primary
        for it in st.items:
            if it.alias == primary:
                text = it.expr
                break
        tl = text.strip().lower()
        if tl in {f.lower() for f in schema.fields}:
            # sorting by a full-text FIELD (directly or via a select
            # alias) is an error in row-wise indexes (CheckSortClause,
            # sphinxsort.cpp:6578) — but works when the field_string's
            # attr twin is COLUMNAR (the columnar sorters resolve select
            # aliases; golden test_430 queries 8 vs 9)
            colr = {c.strip().lower() for c in str(
                (getattr(table, "options", None) or {})
                .get("columnar_attrs", "")).replace(",", " ").split()}
            if tl not in colr:
                raise ValueError(
                    f"index {st.indexes[0]}: sort-by attribute "
                    f"'{primary}' not found")
        try:
            tree = parse_expr(text)
        except ExprError:
            return None
        offset, limit = q.offset, q.limit
        q.sort = [("weight", False), ("id", True)]
        q.offset = 0
        q.limit = max(q.max_matches, offset + limit)
        q.select = None
        return (tree, asc, offset, limit)

    def _project(self, st: SelectStmt, res, schema, table=None) -> QLResult:
        cols: list[str] = []
        getters = []
        match_text = next((c.value for c in st.conds if c.kind == "match"),
                          "")

        def make_highlighter():
            from .snippets import SnippetOptions, build_snippet
            from ..text.dictionary import Dictionary
            from ..text.tokenizer import Tokenizer
            tok = Tokenizer(table.tok_settings)
            dic = Dictionary(table.dict_settings)
            opts = SnippetOptions()

            def hl(m):
                text = " | ".join(
                    str(m.attrs.get(f, "")) for f in schema.fields
                    if m.attrs.get(f))
                return build_snippet(text, match_text, tok, dic, opts)
            return hl
        galias: list = []   # per-getter alias (parallel to getters)
        for it in st.items:
            # unaliased items display lowercased (the reference parser
            # folds the expression span: SELECT CRC32('x') -> crc32('x'))
            name = it.alias or it.display or _fold_expr_case(it.expr)
            raw = it.expr
            _pre = len(getters)
            if raw == "*":
                # SELECT * = id + attributes + STORED fields (docstore
                # columns appear in the result schema like the reference's
                # stored_fields, sphinx.h:1486 CSphSchema + DocstoreDoc_t);
                # plain non-stored full-text fields are not returned
                cols.append("id")
                getters.append(lambda m: m.docid)
                for a in schema.attrs:
                    cols.append(a.name)
                    getters.append(lambda m, n=a.name: m.attrs.get(n))
                stored = [f for f in getattr(table, "stored_fields", ())
                          or () if schema.attr(f) is None] \
                    if table is not None else []
                for f in stored:
                    cols.append(f)
                    getters.append(
                        lambda m, n=f, t=table:
                        (t.get_document(m.docid) or {}).get(n, ""))
                continue
            cols.append(name)
            lraw = raw.lower().replace(" ", "")
            if lraw in ("id", "@id"):
                getters.append(lambda m: m.docid)
            elif lraw.startswith("highlight("):
                if table is None:
                    return QLResult.err("HIGHLIGHT() needs a table")
                getters.append(make_highlighter())
            elif lraw.startswith("snippet("):
                # SNIPPET(data, query [, 'opt=value'...]) select-list
                # function (Expr_Snippet_c, searchdexpr.cpp)
                if table is None:
                    return QLResult.err("SNIPPET() needs a table")
                try:
                    getters.append(_make_snippet_getter(raw, table, schema))
                except ValueError as e:
                    return QLResult.err(
                        f"index {st.indexes[0]}: parse error: {e}")
            elif lraw in ("weight()", "@weight"):
                getters.append(lambda m: m.weight)
            elif lraw in ("groupby()", "@groupby"):
                getters.append(lambda m: m.attrs.get(
                    "@groupby", m.attrs.get(st.group_by)))
            elif lraw.startswith("packedfactors("):
                getters.append(lambda m, n=raw: m.attrs.get(
                    n, m.attrs.get(n.replace(" ", ""),
                                   m.attrs.get("packedfactors()", ""))))
            elif lraw in ("count(*)", "@count") or (
                    lraw.startswith(("count(", "sum(", "min(", "max(",
                                     "avg(", "group_concat("))
                    and _is_aggregate_expr(raw)):
                # engine keys may carry alias-resolved args (test_412)
                rkey = _resolve_agg_args(raw, st.items)
                getters.append(lambda m, n=raw, n2=name, n3=rkey:
                               m.attrs.get(n, m.attrs.get(
                                   n.replace(" ", ""),
                                   m.attrs.get(n3, m.attrs.get(n2)))))
            elif (schema.attr(raw) is not None or raw in schema.fields
                  or raw == st.group_by):
                _adr = schema.attr(raw)
                if _adr is not None and _adr.type.value in (
                        "uint", "timestamp"):
                    # 32-bit uint attrs display UNSIGNED (the device
                    # carries them as wrapped i32; 4294967295 not -1)
                    getters.append(
                        lambda m, n=raw: (m.attrs.get(n) & 0xFFFFFFFF)
                        if isinstance(m.attrs.get(n), int)
                        else m.attrs.get(n))
                else:
                    getters.append(lambda m, n=raw: m.attrs.get(n))
                if _adr is not None:
                    # a later select alias that REUSES this attr name
                    # overwrites the attr's row slot in place; this
                    # plain reference is a locator onto that slot and
                    # displays the overwritten value (test_189 q10:
                    # `idd as agent, agent+2 as idd` -> agent==idd)
                    getters[-1]._attr_ref = raw
            else:
                tree = parse_expr(raw)
                exerr = _exist_type_error(tree, schema)
                if exerr:
                    return QLResult.err(
                        f"index {st.indexes[0]}: parse error: {exerr}")
                # int-typed functions render unsigned (%u int display,
                # SendMysqlRow): CRC32's signed i32 shows as u32
                u32 = (isinstance(tree, tuple) and tree
                       and tree[0] == "call" and tree[1] == "CRC32")
                uv = self.uservars

                def _g(m, extra, t=tree, u=u32):
                    # earlier select aliases are visible to later items
                    # (SELECT 0 zero, 1/zero — expr parser alias refs)
                    v = eval_expr_host(t, {**uv, **m.attrs, **extra},
                                       m.weight, m.docid)
                    if isinstance(v, (list, dict)):
                        # JSON sub-values render as compact JSON text
                        # (golden test_396: json_col.a -> "[1,2,3,4]")
                        from ..utils.jsonrender import _dump
                        return _dump(v)
                    return (v & 0xFFFFFFFF) if u and isinstance(v, int) \
                        else v
                _g._wants_extra = True
                getters.append(_g)
            added = len(getters) - _pre
            galias.extend([it.alias] if added == 1 else [None] * added)
        rows = []
        try:
            for m in res.matches:
                extra: dict = {}
                vals = []
                gi = 0
                for g in getters:
                    try:
                        if getattr(g, "_wants_extra", False):
                            v = g(m, extra)
                        else:
                            v = g(m)
                    except ExprError:
                        # the synthetic empty-aggregate row: attr-fed
                        # expressions are wire NULLs, constants still
                        # evaluate (golden test_163 q72 sin(idd) -> NULL,
                        # sin(1.0) -> value)
                        if getattr(m, "_null_row", False):
                            v = None
                        else:
                            raise
                    al = galias[gi] if gi < len(galias) else None
                    if al:
                        extra[al] = v
                    vals.append(v)
                    gi += 1
                # in-place alias shadowing: `<expr> AS attrname` writes
                # the existing attribute's slot, so plain references to
                # that attr (locators) display the new value
                for gi2, g2 in enumerate(getters):
                    ar = getattr(g2, "_attr_ref", None)
                    if ar is not None and ar in extra \
                            and galias[gi2] != ar:
                        vals[gi2] = extra[ar]
                rows.append(tuple(vals))
        except ExprError as e:
            return QLResult.err(
                f"index {st.indexes[0]}: parse error: {e}")
        return QLResult(columns=cols, rows=rows, warning=res.warning)

    def _facet(self, base: SelectStmt, fc: FacetStmt, tables) -> QLResult:
        """One FACET result set (sphinxql.y facet_stmt; searchd expands
        facets into extra grouped queries over the same match set). BY
        list absent = group by the facet items themselves; ORDER BY may
        reference item aliases, facet() (= the group key) and count(*)."""
        by_list = [b for b in (fc.by or [it.expr for it in fc.items])]
        # alias -> expr map for ORDER BY resolution
        amap = {}
        for it in fc.items:
            if it.alias:
                amap[it.alias.lower()] = it.expr
        order: list[tuple[str, bool]] = []
        for c, a in fc.order:
            cl = c.strip()
            low = cl.lower().replace(" ", "")
            if low in amap:
                cl = amap[low]
                low = cl.lower().replace(" ", "")
            if low == "facet()":
                cl = by_list[0] if len(by_list) == 1 else "facet()"
            order.append((cl, a))
        fq, err = self._build_query(base)
        if err:
            return QLResult.err(err)
        if len(tables) > 1:
            return QLResult.err("FACET over multiple indexes: TODO")
        cols = [it.alias or it.display or it.expr for it in fc.items] \
            + ["count(*)"]
        seen = set()
        dedup_cols = []
        for c in cols:
            if c not in seen:
                seen.add(c)
                dedup_cols.append(c)

        from ..query.expr import ExprError, eval_expr_host, parse_expr
        trees = {}
        for it in fc.items:
            try:
                trees[it.alias or it.display or it.expr] = \
                    parse_expr(it.expr)
            except ExprError as e:
                return QLResult.err(str(e))

        if len(by_list) > 1:
            return self._facet_multi(fq, fc, by_list, order, dedup_cols,
                                     trees, tables[0])

        by = by_list[0]
        fsel = [it.expr for it in fc.items]
        if not any(s.lower().replace(" ", "").startswith("count(")
                   for s in fsel):
            fsel = fsel + ["count(*)"]
        fq = dc_replace(
            fq, group_by=by, select=fsel, offset=fc.offset, limit=fc.limit,
            sort=order or [("weight", False)], having=None)
        res = tables[0].search(fq)
        if res.error:
            return QLResult.err(res.error)
        rows = []
        nby = by.lower().replace(" ", "")
        for m in res.matches:
            row = []
            for c in dedup_cols:
                lc = c.lower().replace(" ", "")
                expr = amap.get(lc) or (c if c in trees else None)
                nexpr = (expr or "").lower().replace(" ", "")
                if lc == "count(*)":
                    row.append(m.attrs.get("count(*)"))
                elif nexpr == nby or lc == nby:
                    # the item IS the group key: render the grouped key
                    # VALUE — for MVA facets that's the per-value group
                    # (@groupby), not the rep's whole list (test_226
                    # 'facet categories' rows show 14, 13, ... not
                    # '13,14')
                    v = m.attrs.get("@groupby")
                    if v is None:
                        v = m.attrs.get(by)
                    row.append(v)
                elif expr is not None:
                    # independent item expression: evaluate over the
                    # group representative's attrs (test_226:
                    # 'facet brand_id+1 by brand_id+2')
                    try:
                        row.append(eval_expr_host(trees[c], m.attrs,
                                                  m.weight, m.docid))
                    except ExprError:
                        row.append(m.attrs.get(c))
                elif c in m.attrs:
                    row.append(m.attrs.get(c))
                else:
                    row.append(m.attrs.get(by))
            rows.append(tuple(row))
        return QLResult(columns=dedup_cols, rows=rows)

    def _facet_multi(self, fq, fc: FacetStmt, by_list, order, dedup_cols,
                     trees, table) -> QLResult:
        """Multi-attribute facet (FACET a,b BY c,d): grouped host-side by
        the tuple of BY values over the full match window — the reference
        composes a joint group key the same way (GroupbyMulti)."""
        from ..query.expr import ExprError, eval_expr_host, parse_expr
        big = max(getattr(fq, "max_matches", 1000),
                  getattr(table, "n_docs", 0) or 0)
        base_q = dc_replace(fq, group_by=None, select=None, having=None,
                            sort=[("weight", False), ("id", True)],
                            offset=0, limit=big, max_matches=big)
        res = table.search(base_q)
        if res.error:
            return QLResult.err(res.error)
        try:
            by_trees = [parse_expr(b) for b in by_list]
        except ExprError as e:
            return QLResult.err(str(e))
        groups: dict = {}
        korder: list = []
        for m in sorted(res.matches, key=lambda m2: m2.docid):
            try:
                key = tuple(eval_expr_host(t, m.attrs, m.weight, m.docid)
                            for t in by_trees)
            except ExprError as e:
                return QLResult.err(str(e))
            if key not in groups:
                groups[key] = [m, 0]
                korder.append(key)
            g = groups[key]
            g[1] += 1
            # rep = best by weight desc, docid asc (first wins ties)
            if m.weight > g[0].weight:
                g[0] = m
        ents = [(groups[k][0], groups[k][1], k) for k in korder]

        def sort_key(e):
            rep, cnt, key = e
            ks = []
            for c, a in (order or [("weight", False)]):
                lc = c.lower().replace(" ", "")
                if lc == "count(*)" or lc == "@count":
                    v = cnt
                elif lc in ("weight", "@weight", "weight()"):
                    v = rep.weight
                elif lc == "facet()":
                    v = key
                else:
                    try:
                        v = eval_expr_host(parse_expr(c), rep.attrs,
                                           rep.weight, rep.docid)
                    except ExprError:
                        v = 0
                ks.append(_NegWrap(v) if not a else v)
            ks.append(rep.docid)   # implicit rep-rowid tie-break
            return tuple(ks)

        ents.sort(key=sort_key)
        rows = []
        for rep, cnt, key in ents[fc.offset:fc.offset + fc.limit]:
            row = []
            for c in dedup_cols:
                if c.lower().replace(" ", "") == "count(*)":
                    row.append(cnt)
                else:
                    try:
                        row.append(eval_expr_host(trees[c], rep.attrs,
                                                  rep.weight, rep.docid))
                    except ExprError:
                        row.append(rep.attrs.get(c))
            rows.append(tuple(row))
        return QLResult(columns=dedup_cols, rows=rows)

    _STATUS_COLS = (
        "chunk_id", "base_name", "indexed_documents", "indexed_bytes",
        "ram_bytes", "disk_bytes", "disk_mapped", "disk_mapped_cached",
        "disk_mapped_doclists", "disk_mapped_cached_doclists",
        "disk_mapped_hitlists", "disk_mapped_cached_hitlists",
        "killed_documents")

    def _select_index_status(self, st: SelectStmt, t) -> QLResult:
        """SELECT ... FROM <table>.status — per-disk-chunk rows served as
        a dynamic table (HandleSelectIndexStatus feeding MakeDynamicIndex,
        searchd.cpp:14371/6110).  Each fed row lands in its own segment
        with rowid 0, so the implicit sort's shared-queue order over n
        all-equal rows is [2..n, 1] — reproduced by ref_queue_order."""
        from .multi import ref_queue_order
        rows = t.chunk_status()
        for i, r in enumerate(rows):
            r["id"] = i + 1
        order = ref_queue_order([(1, 0)] * len(rows), max(len(rows), 1))
        rows = [rows[i] for i in order]
        proj: list[tuple[str, str]] = []
        for it in st.items:
            e = it.expr.strip()
            if e == "*":
                proj.extend((c, c) for c in ("id",) + self._STATUS_COLS)
            else:
                proj.append((it.alias or it.display or e, e.lower()))
        lim = st.limit if st.limit is not None else 20
        out = [tuple(r.get(key, "") for _, key in proj)
               for r in rows[st.offset:st.offset + lim]]
        return QLResult(columns=[d for d, _ in proj], rows=out)

    def _apply_multiplier_meta(self, batch_stmts: list) -> None:
        """SHOW META 'multiplier' row: the number of queries that shared
        ONE scan pass when the multi-queue / facet-queue optimization
        applied (searchd.cpp:5759 sets m_iMultiplier=iQueries; BuildMeta
        emits the row only when >1, searchd.cpp:8673). Emulated over the
        parsed batch: a SELECT with FACETs is a facet queue of
        1+len(facets) queries (searchd.cpp:6581); a multi-statement of
        SELECTs shares a pass when index set, MATCH text and attr filters
        all agree (CheckMultiQuery, searchd.cpp:6140)."""
        sels: list[SelectStmt] = [st for st in batch_stmts
                                  if isinstance(st, SelectStmt)]
        if not sels:
            return
        n = sum(1 + len(st.facets) for st in sels)
        if n <= 1:
            return
        # agent-backed distributed tables never share a pass (the
        # optimization lives in the local SearchHandler; remote fan-out
        # runs per-query — test_226: facetdemo4/agent shows no
        # multiplier, facetdemo3/local-only dist shows 2)
        for st in sels:
            for tn in st.indexes:
                t = self.catalog.tables.get(tn)
                if t is None:
                    return
                af = getattr(t, "agent_flags", None)
                if af and any(af):
                    return
                if self.catalog.table_type(t) == "distributed" \
                        and getattr(t, "agents", None):
                    return
        if len(sels) > 1:
            def mq_key(st: SelectStmt):
                match = next((c.value for c in st.conds
                              if c.kind == "match"), "")
                filt = tuple(repr(c) for c in st.conds if c.kind != "match")
                opts = tuple(sorted(
                    (k2, repr(v)) for k2, v in st.options.items()))
                return (tuple(st.indexes), match, filt, opts)
            k0 = mq_key(sels[0])
            if any(mq_key(s) != k0 for s in sels[1:]):
                return
        if self.last_meta and not any(k2 == "multiplier"
                                      for k2, _ in self.last_meta):
            pos = next((i + 1 for i, (k2, _) in enumerate(self.last_meta)
                        if k2 == "time"), len(self.last_meta))
            self.last_meta.insert(pos, ("multiplier", str(n)))

    def _store_meta(self, res) -> None:
        self.last_weights = {m.docid: m.weight for m in res.matches}
        meta = []
        warn = getattr(self, "_pending_warning", None) or res.warning
        self._pending_warning = None
        if warn:
            meta.append(("warning", warn))
        meta += [("total", str(res.total)),
                ("total_found", str(res.total_found)),
                ("time", f"{res.time_ms / 1000.0:.3f}")]
        # SHOW META sorts keywords lexicographically (MakeSortedWordStat,
        # sphinx.cpp:27938: byte-order compare of the normalized words)
        stats = sorted(res.word_stats,
                       key=lambda ws: ws.word.encode("utf-8", "replace"))
        for i, ws in enumerate(stats):
            meta.append((f"keyword[{i}]", ws.word))
            meta.append((f"docs[{i}]", str(ws.docs)))
            meta.append((f"hits[{i}]", str(ws.hits)))
        self.last_meta = meta

    # -- writes ----------------------------------------------------------
    def _resolve_write_ref(self, ref: str):
        """'cluster:table' write routing (HandleCmdReplicate,
        searchdreplication.h:30): returns (table_name, cluster|None).
        Plain writes into clustered tables are rejected like the
        reference does."""
        if ":" in ref:
            c, _, tname = ref.partition(":")
            cl = self.catalog.clusters.get(c)
            if cl is None:
                raise ValueError(f"unknown cluster '{c}'")
            if tname not in cl.tables:
                raise ValueError(
                    f"table '{tname}' is not in cluster '{c}'")
            return tname, cl
        for c, cl in self.catalog.clusters.items():
            if ref in cl.tables:
                raise ValueError(
                    f"table '{ref}' is a part of cluster '{c}', "
                    f"use '{c}:{ref}'")
        return ref, None

    def _insert(self, st: InsertStmt) -> QLResult:
        tname, cl = self._resolve_write_ref(st.index)
        if cl is not None:
            return self._cluster_insert(st, tname, cl)
        t = self.catalog.get(st.index)
        from ..index.percolate import PercolateIndex
        if isinstance(t, PercolateIndex):
            cols = st.columns or ["query"]
            n = 0
            for row in st.rows:
                d = dict(zip(cols, row))
                tags = d.get("tags")
                if isinstance(tags, str):
                    # tags split on commas AND whitespace (the reference
                    # accepts both; sphinxpq tag lists)
                    import re as _re
                    tags = [x for x in _re.split(r"[,\s]+", tags) if x]
                qid = int(d["id"]) if "id" in d else None
                if qid is not None and qid in t.queries \
                        and not st.replace:
                    return QLResult.err(f"duplicate id '{qid}'")
                t.add_query(str(d.get("query", "")),
                            str(d.get("filters", "")), tags, qid=qid)
                n += 1
            return QLResult.ok(n)
        cols = st.columns
        if not cols:
            cols = ["id"] + t.schema.fields + [a.name for a in t.schema.attrs]
        if st.columns:
            # schema names are case-insensitive: fold the column list
            # onto the canonical spellings (reference sphToLower)
            canon_map = {n.lower(): n for n in
                         ["id"] + t.schema.fields
                         + [a.name for a in t.schema.attrs]}
            cols = [canon_map.get(c.lower(), c) for c in st.columns]
            seen_cols: set[str] = set()
            for c in cols:
                if c in seen_cols:
                    return QLResult.err(f"column '{c}' specified twice")
                seen_cols.add(c)
            known = {"id"} | set(t.schema.fields) | {
                a.name for a in t.schema.attrs}
            for c in cols:
                if c not in known:
                    return QLResult.err(f"unknown column: '{c}'")
        str_cols = set(t.schema.fields) | {
            a.name for a in t.schema.attrs
            if getattr(a.type, "value", "") in ("string", "json")}
        n = 0
        for rn, row in enumerate(st.rows, 1):
            if len(row) != len(cols):
                return QLResult.err(
                    f"column count mismatch: {len(cols)} vs {len(row)}")
            for ci, (c, v) in enumerate(zip(cols, row), 1):
                # typed VALUES: text fields / string attrs require a
                # quoted literal (sphinxql insert row check,
                # "row %d, column %d: string expected")
                if c in str_cols and not isinstance(v, str):
                    return QLResult.err(
                        f"row {rn}, column {ci}: string expected")
            doc = dict(zip(cols, row))
            if "id" not in doc:
                # auto ids are UUID-short (UidShort, sphinxutils.cpp:3357)
                from ..utils.uid import uid_short
                doc["id"] = uid_short()
            t.insert(doc, replace=st.replace)
            n += 1
        if self.autocommit and not self.in_txn:
            t.commit()
        else:
            self.txn_tables.add(st.index)
        return QLResult.ok(n)

    def _cluster_insert(self, st: InsertStmt, tname: str, cl) -> QLResult:
        """Writes into cluster tables replicate as total-ordered commit
        write sets (certify-then-apply; every member applies in the same
        order)."""
        import time as _time
        t = self.catalog.get(tname)
        cols = st.columns
        if not cols:
            cols = ["id"] + t.schema.fields + [a.name for a in t.schema.attrs]
        # same column/type validation as the plain _insert path — a bad
        # record must fail HERE, not inside every member's applier thread
        str_cols = set(t.schema.fields) | {
            a.name for a in t.schema.attrs
            if getattr(a.type, "value", "") in ("string", "json")}
        docs = []
        for rn, row in enumerate(st.rows, 1):
            if len(row) != len(cols):
                return QLResult.err(
                    f"column count mismatch: {len(cols)} vs {len(row)}")
            for ci, (c, v) in enumerate(zip(cols, row), 1):
                if c in str_cols and not isinstance(v, str):
                    return QLResult.err(
                        f"row {rn}, column {ci}: string expected")
            doc = dict(zip(cols, row))
            if "id" not in doc:
                # auto ids, as in _insert (UidShort, sphinxutils.cpp:3357)
                from ..utils.uid import uid_short
                doc["id"] = uid_short()
            docid = int(doc.get("id", 0))
            if not st.replace and docid in t.docid_seg:
                return QLResult.err(f"duplicate id {docid}")
            docs.append(doc)
        rec = {"op": "commit", "docs": docs, "deletes": [],
               "ts": _time.time()}
        try:
            cl.replicate(tname, rec)
        except ValueError as e:
            return QLResult.err(str(e))
        return QLResult.ok(len(docs))

    def _delete(self, st: DeleteStmt) -> QLResult:
        tname, cl = self._resolve_write_ref(st.index)
        if cl is not None:
            import time as _time
            ids = _extract_id_list(st.conds)
            if ids is None:
                return QLResult.err(
                    "cluster DELETE needs id conditions")
            rec = {"op": "commit", "docs": [],
                   "deletes": [int(x) for x in ids], "ts": _time.time()}
            try:
                cl.replicate(tname, rec)
            except ValueError as e:
                return QLResult.err(str(e))
            return QLResult.ok(len(ids))
        t = self.catalog.get(st.index)
        from ..index.percolate import PercolateIndex
        if isinstance(t, PercolateIndex):
            ids = _extract_id_list(st.conds)
            if ids is None:
                try:
                    stored = _filter_stored_queries(
                        sorted(t.queries.values(), key=lambda x: x.qid),
                        st.conds)
                except ValueError as e:
                    return QLResult.err(str(e))
                ids = [q.qid for q in stored]
            return QLResult.ok(t.delete_query(ids))
        ids = _extract_id_list(st.conds)
        if ids is None:
            q, err = self._build_query(SelectStmt(
                items=[], indexes=[st.index], conds=st.conds))
            if err:
                return QLResult.err(err)
            q.limit = q.max_matches = 10**6
            res = t.search(q)
            if res.error:
                return QLResult.err(res.error)
            ids = [m.docid for m in res.matches]
        store = st.options.get("store") if getattr(st, "options", None) \
            else None
        if store:
            # DELETE ... OPTION store='@var': collect the matched ids into
            # a global uservar, delete nothing (DEBUG SPLIT prep,
            # sphinxrt.cpp; golden test_066)
            self.uservars[str(store)] = sorted(int(x) for x in ids)
            return QLResult.ok(0)
        n = t.delete(ids)
        if self.autocommit and not self.in_txn:
            t.commit()
        else:
            self.txn_tables.add(st.index)
        return QLResult.ok(n)

    def _update(self, st: UpdateStmt) -> QLResult:
        if "," in st.index:
            # UPDATE t1, t2 SET ...: per-table fan-out, summed rows
            n = 0
            for nm in st.index.split(","):
                r = self._update(dc_replace(st, index=nm.strip()))
                if r.error:
                    return r
                n += r.affected
            return QLResult.ok(n)
        tname, cl = self._resolve_write_ref(st.index)
        if cl is not None:
            import time as _time
            uids = _extract_id_list(st.conds)
            if uids is None:
                return QLResult.err("cluster UPDATE needs id conditions")
            rec = {"op": "update", "ids": [int(x) for x in uids],
                   "values": st.values, "ts": _time.time()}
            try:
                cl.replicate(tname, rec)
            except ValueError as e:
                return QLResult.err(str(e))
            return QLResult.ok(len(uids))
        t = self.catalog.get(st.index)
        ids = _extract_id_list(st.conds)
        if ids is None:
            q, err = self._build_query(SelectStmt(
                items=[], indexes=[st.index], conds=st.conds))
            if err:
                return QLResult.err(err)
            q.limit = q.max_matches = 10**6
            res = t.search(q)
            if res.error:
                return QLResult.err(res.error)
            ids = [m.docid for m in res.matches]
        values = st.values
        if str(st.options.get("ignore_nonexistent_columns", "0")) == "1":
            # drop unknown columns instead of erroring (reference UPDATE
            # OPTION ignore_nonexistent_columns)
            known = {a.name for a in t.schema.attrs}
            values = {k: v for k, v in values.items() if k in known}
            if not values:
                return QLResult.ok(0)
        return QLResult.ok(t.update_attrs(ids, values))

    def _create_table(self, st: CreateTableStmt) -> QLResult:
        if st.name in self.catalog.tables:
            if st.if_not_exists:
                return QLResult.ok()
            return QLResult.err(f"table '{st.name}' already exists")
        fields_ = []
        attrs = []
        for cname, ctype in st.columns:
            if cname == "id":
                continue
            ct = _COLUMN_TYPES.get(ctype)
            if ct is None:
                return QLResult.err(f"unknown column type '{ctype}'")
            if ct == "field":
                fields_.append(cname)
            else:
                attrs.append(AttrDef(cname, ct))
        if not fields_:
            fields_ = []
        schema = Schema(fields=fields_, attrs=attrs)
        ttype = st.options.get("type", "rt")
        self.catalog.create(st.name, schema, ttype, options=st.options)
        return QLResult.ok()

    def _alter(self, st: AlterStmt) -> QLResult:
        t = self.catalog.get(st.index)
        if not hasattr(t, "alter"):
            return QLResult.err(
                f"table '{st.index}' does not support ALTER")
        ct = None
        if st.op == "add":
            ct = _COLUMN_TYPES.get(st.coltype)
            if ct is None:
                return QLResult.err(f"unknown column type '{st.coltype}'")
        t.alter(st.op, st.column, ct)
        return QLResult.ok()

    # -- CALL / admin ----------------------------------------------------
    def _call(self, st: CallStmt) -> QLResult:
        if st.func == "KEYWORDS":
            if len(st.args) < 2:
                return QLResult.err("CALL KEYWORDS(text, index) required")
            text, index = st.args[0], st.args[1]
            t = self.catalog.get(str(index))
            toks = []
            from ..text.tokenizer import Tokenizer
            from ..text.dictionary import Dictionary
            tok = Tokenizer(t.tok_settings)
            dic = Dictionary(t.dict_settings)
            total_docs, df = t.global_stats()
            named = {k.lower(): v for k, v in (st.named or {}).items()}
            want_stats = False
            if len(st.args) > 2:
                want_stats = str(st.args[2]).strip() in ("1", "true")
            if "stats" in named:
                want_stats = str(named["stats"]).strip() in ("1", "true")
            fold_wild = str(named.get("fold_wildcards", "0")
                            ).strip() in ("1", "true")
            sort_mode = str(named.get("sort_mode", "")).strip().lower()
            exp_limit = int(named.get("expansion_limit", 0) or 0)
            rows = []
            qpos = 0
            import fnmatch as _fn
            import zlib as _zl

            ds = t.dict_settings
            wc_enabled = (getattr(ds, "min_prefix_len", 0) > 0
                          or getattr(ds, "min_infix_len", 0) > 0)

            def _tokens_keeping_wildcards(s: str):
                # the reference's keyword tokenizer keeps wildcard chars
                # only when the index allows expansion (AddPlainKeywords
                # clones the star-enabled tokenizer iff min_prefix_len or
                # min_infix_len > 0); otherwise '*' is a separator and
                # 'test*' tokenizes to plain 'test' (golden test_041
                # plain_nostar1). Our charset-driven tokenizer drops wild
                # chars, so wildcard-bearing pieces pass through
                # case-folded as single tokens when expansion is on.
                from types import SimpleNamespace
                for piece in s.split():
                    if wc_enabled and any(c in piece for c in "*?%"):
                        yield SimpleNamespace(text=piece.lower())
                    else:
                        yield from tok.tokenize(piece)

            for token in _tokens_keeping_wildcards(str(text)):
                qpos += 1
                if any(c in token.text for c in "*?%"):
                    # wildcard expansion against the dict
                    # (ISphQueryFilter::GetKeywords, sphinx.cpp:14172;
                    # per-word entries dedup in CRC32-of-length-prefixed-
                    # word order, DictEntryRtPayload_t::Convert,
                    # sphinxrt.cpp:5385; golden test_364)
                    pat = token.text.replace("%", "*")
                    agg: dict[str, list[int]] = {}
                    for seg in t.segments:
                        p = seg.packed
                        for tid, w in enumerate(p.term_strs):
                            if _fn.fnmatchcase(w, pat):
                                e = agg.setdefault(w, [0, 0])
                                e[0] += int(p.term_docs[tid])
                                e[1] += int(p.term_hits[tid])
                    if exp_limit and len(agg) > exp_limit * max(
                            len(t.segments), 1):
                        agg = dict(sorted(
                            agg.items(),
                            key=lambda kv: (-kv[1][0], -kv[1][1])
                        )[: exp_limit * max(len(t.segments), 1)])
                    if fold_wild or not agg:
                        d0 = sum(v[0] for v in agg.values())
                        h0 = sum(v[1] for v in agg.values())
                        row = (str(qpos), token.text, token.text)
                        rows.append(row + ((str(d0), str(h0))
                                           if want_stats else ()))
                        continue

                    def _crc(w: str) -> int:
                        b = w.encode("utf-8")
                        return _zl.crc32(bytes([len(b) & 0xFF]) + b) \
                            & 0xFFFFFFFF
                    for w in sorted(agg, key=lambda w: (_crc(w),
                                                        w.encode())):
                        row = (str(qpos), token.text, w)
                        rows.append(row + ((str(agg[w][0]),
                                            str(agg[w][1]))
                                           if want_stats else ()))
                    continue
                terms = dic.process(token.text)
                term = terms[0] if terms else None
                # stopped keywords still consume a query position
                # (GetKeywords m_iQpos from the tokenizer's counter;
                # golden test_154: 'a bird' -> bird qpos=2)
                if term is None:
                    continue
                if not want_stats:
                    rows.append((str(qpos), token.text, term))
                    continue
                docs = df.get(term, 0)
                hits = 0
                for seg in t.segments:
                    tid = seg.packed.term_id(term)
                    if tid >= 0:
                        hits += int(seg.packed.term_hits[tid])
                rows.append((str(qpos), token.text, term,
                             str(docs), str(hits)))
            if want_stats and sort_mode in ("docs", "hits"):
                # SortKeywords: qpos asc, docs|hits desc, normalized asc
                # (KeywordSorterDocs_fn/KeywordSorter_fn, searchd.cpp:10866)
                ki = 3 if sort_mode == "docs" else 4
                rows.sort(key=lambda r: (int(r[0]), -int(r[ki]), r[2]))
            cols = ["qpos", "tokenized", "normalized"]
            if want_stats:
                cols += ["docs", "hits"]
            return QLResult(columns=cols, rows=rows)
        if st.func == "SUGGEST" or st.func == "QSUGGEST":
            return self._suggest(st)
        if st.func == "SNIPPETS":
            return self._snippets(st)
        if st.func == "PQ":
            return self._call_pq(st)
        if st.func == "AUTOCOMPLETE":
            return self._autocomplete(st)
        return QLResult.err(f"unsupported CALL {st.func}")

    def _autocomplete(self, st: CallStmt) -> QLResult:
        """CALL AUTOCOMPLETE('prefix', 'table' [, N as limit]): dictionary
        prefix completions ranked by document frequency (the reference's
        CALL AUTOCOMPLETE over the dict)."""
        import bisect as _b
        if len(st.args) < 2:
            return QLResult.err("CALL AUTOCOMPLETE(prefix, table) required")
        prefix, index = str(st.args[0]).lower(), str(st.args[1])
        limit = int(st.named.get("limit", 10))
        t = self.catalog.get(index)
        cand: dict[str, int] = {}
        for part in t.searchable_parts():
            terms = part.packed.term_strs
            i = _b.bisect_left(terms, prefix)
            while i < len(terms) and terms[i].startswith(prefix):
                cand[terms[i]] = cand.get(terms[i], 0) + int(
                    part.packed.term_docs[i])
                i += 1
        rows = sorted(cand.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
        return QLResult(columns=["query"], rows=[(w,) for w, _ in rows])

    def _snippets(self, st: CallStmt) -> QLResult:
        """CALL SNIPPETS((data...), index, query [, opt AS name...])
        (HandleMysqlCallSnippets, searchd.cpp:10448)."""
        from .snippets import SnippetOptions, build_snippet
        from ..text.dictionary import Dictionary
        from ..text.tokenizer import Tokenizer

        if len(st.args) < 3:
            return QLResult.err(
                "CALL SNIPPETS(data, index, query) required")
        data, index, query = st.args[0], str(st.args[1]), str(st.args[2])
        texts = data if isinstance(data, list) else [data]
        t = self.catalog.get(index)
        opts = SnippetOptions()
        from .snippets import OPTION_ALIASES
        for k, v in st.named.items():
            k = OPTION_ALIASES.get(k, k)
            if hasattr(opts, k):
                cur = getattr(opts, k)
                setattr(opts, k, type(cur)(v) if cur is not None else v)
        tok = Tokenizer(t.tok_settings)
        dic = Dictionary(t.dict_settings)
        rows = [(build_snippet(str(x), query, tok, dic, opts),)
                for x in texts]
        return QLResult(columns=["snippet"], rows=rows)

    def _call_pq(self, st: CallStmt) -> QLResult:
        """CALL PQ(index, docs [, options]) (sphinxpq.cpp MatchDocuments)."""
        from ..index.percolate import PercolateIndex

        if len(st.args) < 2:
            return QLResult.err("CALL PQ(index, docs) required")
        t = self.catalog.get(str(st.args[0]))
        if not isinstance(t, PercolateIndex):
            return QLResult.err(f"'{st.args[0]}' is not a percolate table")
        raw_docs = st.args[1]
        if not isinstance(raw_docs, list):
            raw_docs = [raw_docs]
        # docs are JSON objects by default (m_bJsonDocs = true,
        # searchdaemon.h:1308); plain-text docs need 0 as docs_json
        as_json = bool(int(st.named.get("docs_json", 1)))
        id_alias = st.named.get("docs_id")   # 'attr' as docs_id
        shift = int(st.named.get("shift", 0))
        skip_bad = bool(int(st.named.get("skip_bad_json", 0)))
        docs = []
        docids: list[int] = []   # per kept doc, its external id (docs_id)
        for rd in raw_docs:
            if as_json:
                try:
                    d = _lenient_json(rd) if isinstance(rd, str) \
                        else dict(rd)
                except (ValueError, TypeError):
                    if skip_bad:
                        continue
                    return QLResult.err(f"bad JSON document: {rd!r}")
                if not isinstance(d, dict):
                    if skip_bad:
                        continue
                    return QLResult.err(f"bad JSON document: {rd!r}")
            else:
                field_name = t.schema.fields[0] if t.schema.fields else "text"
                d = {field_name: str(rd)}
            if id_alias is not None:
                # docs without the id attribute are skipped with a warning
                # (searchd.cpp:9691 "skipped N document(s) without id field")
                if str(id_alias) not in d:
                    continue
                docids.append(int(d[str(id_alias)]))
            docs.append(d)
        matches = t.match_documents(docs)
        want_docs = bool(int(st.named.get("docs", 0)))
        # reference column set: id [, documents] [, query+tags+filters with
        # `1 as query`] (HandleMysqlCallPQ result schema)
        want_query = bool(int(st.named.get("query", 0)))
        rows = []
        for qid, doc_ords in matches:
            q = t.queries[qid]
            row: list = [qid]
            if want_docs:
                if id_alias is not None:
                    # map 1-based ordinals to the id attr values, then
                    # sort+dedupe (dTmpDocs.Uniq(), searchd.cpp:9446-9456)
                    vals = sorted({docids[o - 1] for o in doc_ords})
                else:
                    vals = [o + shift for o in doc_ords]
                row.append(",".join(map(str, vals)))
            if want_query:
                row += [q.query, " ".join(q.tags), q.filters]
            rows.append(tuple(row))
        cols = ["id"] + (["documents"] if want_docs else []) \
            + (["query", "tags", "filters"] if want_query else [])
        return QLResult(columns=cols, rows=rows)

    def _suggest(self, st: CallStmt) -> QLResult:
        """CALL SUGGEST(word, index): trigram+levenshtein candidates
        (ISphWordlistSuggest semantics, sphinxint.h:1472)."""
        if len(st.args) < 2:
            return QLResult.err("CALL SUGGEST(word, index) required")
        word, index = str(st.args[0]).lower(), str(st.args[1])
        t = self.catalog.get(index)
        _, df = t.global_stats()

        def trigrams(w):
            w2 = f"__{w}__"
            return {w2[i:i + 3] for i in range(len(w2) - 2)}

        wt = trigrams(word)
        cands = []
        for term, docs in df.items():
            if abs(len(term) - len(word)) > 3:
                continue
            overlap = len(wt & trigrams(term))
            if overlap == 0:
                continue
            d = _levenshtein(word, term, 4)
            if d <= 4:
                cands.append((d, -docs, term, docs))
        cands.sort()
        rows = [(term, str(d), str(docs)) for d, _nd, term, docs in cands[:5]]
        return QLResult(columns=["suggest", "distance", "docs"], rows=rows)

    def _simple(self, st: SimpleStmt) -> QLResult:
        k = st.kind
        if k == "show_tables":
            return QLResult(
                columns=["Index", "Type"],
                rows=[(n, self.catalog.table_type(self.catalog.tables[n]))
                      for n in sorted(self.catalog.tables)])
        if k == "show_meta":
            rows = list(self.last_meta)
            like = st.args[0] if st.args else None
            if like:
                # VectorLike filtering (searchd.cpp BuildMeta feeds a
                # VectorLike constructed from the LIKE pattern)
                import fnmatch as _fn
                pat = like.replace("%", "*").replace("_", "?")
                rows = [r for r in rows if _fn.fnmatchcase(r[0], pat)]
            return QLResult(columns=["Variable_name", "Value"], rows=rows)
        if k == "show_warnings":
            rows = []
            if self.last_warning:
                rows.append(("warning", "1000", self.last_warning))
            return QLResult(columns=["Level", "Code", "Message"], rows=rows)
        if k == "show_status":
            up = int(time.time() - self.start_time)
            rows = [("uptime", str(up)),
                    ("queries", str(self.queries_done)),
                    ("tables", str(len(self.catalog.tables)))]
            rows += [(k2, str(v)) for k2, v in
                     sorted(self.catalog.qcache.status().items())]
            # per-cluster counters (SHOW STATUS LIKE 'cluster_%' — the
            # reference's wsrep status surface, searchdreplication.cpp)
            for cname, cl in sorted(self.catalog.clusters.items()):
                rows += [
                    (f"cluster_{cname}_node_state", cl.state_name),
                    (f"cluster_{cname}_status",
                     "primary" if cl.is_sequencer else "non-primary"),
                    (f"cluster_{cname}_last_committed", str(cl.applied)),
                    (f"cluster_{cname}_indexes",
                     ",".join(sorted(cl.tables))),
                ]
            like = st.args[0] if st.args else None
            if like:
                import fnmatch as _fn
                pat = like.replace("%", "*").replace("_", "?")
                rows = [r for r in rows
                        if _fn.fnmatchcase(r[0], pat)]
            return QLResult(columns=["Counter", "Value"], rows=rows)
        if k == "show_variables":
            rows = [("autocommit", str(int(self.autocommit)))]
            rows += [(k2, str(v)) for k2, v in sorted(self.variables.items())]
            like = st.args[0] if st.args else None
            if like:
                import fnmatch
                pat = like.replace("%", "*").replace("_", "?")
                rows = [r for r in rows if fnmatch.fnmatch(r[0], pat)]
            rows.sort()
            return QLResult(columns=["Variable_name", "Value"], rows=rows)
        if k == "show_version":
            from .. import __version__
            return QLResult(columns=["Component", "Version"],
                            rows=[("Daemon", f"manticoresearch-tpu "
                                             f"{__version__}")])
        if k == "show_databases":
            return QLResult(columns=["Databases"], rows=[("Manticore",)])
        if k == "show_collation":
            # mimics the MySQL answer clients expect (HandleMysqlShow*)
            return QLResult(
                columns=["Collation", "Charset", "Id", "Default",
                         "Compiled", "Sortlen"],
                rows=[("utf8_general_ci", "utf8", 33, "Yes", "Yes", 1)])
        if k == "show_charset":
            return QLResult(
                columns=["Charset", "Description", "Default collation",
                         "Maxlen"],
                rows=[("utf8", "UTF-8 Unicode", "utf8_general_ci", 3)])
        if k == "show_threads":
            # live session registry (searchd.cpp SHOW THREADS columns)
            now = time.time()
            rows = []
            for tid, s in sorted(Session._registry.items()):
                rows.append((
                    str(tid), f"work_{tid}", s.proto, s.host, s.state,
                    f"{now - s.start_time:.0f}",
                    f"{s.work_time:.3f}", str(s.queries_done),
                    f"{s.last_job_took * 1e3:.1f}ms",
                    s.current_info,
                ))
            return QLResult(
                columns=["Tid", "Name", "Proto", "Host", "State",
                         "Connected", "Work time", "Jobs done",
                         "Last job took", "Info"],
                rows=rows)
        if k == "show_profile":
            # SHOW PROFILE: per-stage timers (queryprofile.h:18-51 states)
            rows = [(name, f"{sec:.6f}", "1")
                    for name, sec in self.last_profile]
            total = sum(sec for _, sec in self.last_profile)
            rows.append(("total", f"{total:.6f}",
                         str(len(self.last_profile))))
            return QLResult(columns=["Status", "Duration", "Switches"],
                            rows=rows)
        if k == "show_plan":
            return QLResult(columns=["Variable", "Value"],
                            rows=[("transformed_tree",
                                   self.last_plan or "NONE")])
        if k == "show_plugins":
            from ..plugins import token_filter_names, udf_names
            return QLResult(
                columns=["Type", "Name", "Library"],
                rows=[("udf", n, "") for n in udf_names()]
                + [("index_token_filter", n, "")
                   for n in token_filter_names()])
        if k == "create_function":
            from ..plugins import PluginError, load_udf_soname
            try:
                load_udf_soname(st.args[0], st.args[1])
            except PluginError as e:
                return QLResult.err(str(e))
            return QLResult.ok()
        if k == "drop_function":
            from ..plugins import unregister_udf
            if not unregister_udf(st.args[0]):
                return QLResult.err(f"no function '{st.args[0]}'")
            return QLResult.ok()
        if k == "create_plugin":
            from ..plugins import PluginError, load_plugin_soname
            name, ptype, soname = st.args
            try:
                load_plugin_soname(name, str(ptype), soname)
            except PluginError as e:
                return QLResult.err(str(e))
            return QLResult.ok()
        if k == "drop_plugin":
            from ..plugins import unregister_token_filter
            if not unregister_token_filter(st.args[0]):
                return QLResult.err(f"no plugin '{st.args[0]}'")
            return QLResult.ok()
        if k == "show_agent_status":
            # per-mirror dashboards of every distributed table
            # (HandleMysqlShowAgentStatus over HostDashboard_t counters,
            # searchdha.h:226)
            from .distributed import DistributedTable
            rows: list[tuple[str, str]] = []
            for name, t in self.catalog.tables.items():
                if isinstance(t, DistributedTable):
                    rows += [(f"{name}_{k2}", v)
                             for k2, v in t.agent_status_rows()]
            return QLResult(columns=["Key", "Value"], rows=rows)
        if k == "desc":
            # DESCRIBE idx [TABLE]: percolate tables describe the stored-
            # query meta schema by default; DESC idx TABLE shows the
            # document ("internal") schema (HandleMysqlDescribe,
            # searchd.cpp:11194-11216; type names sphinxint.h:842)
            from ..index.percolate import PercolateIndex as _PQI
            t = self.catalog.get(st.args[0])
            want_internal = len(st.args) > 1 and st.args[1] == "table"
            if isinstance(t, _PQI) and not want_internal:
                rows = [("id", "bigint", ""), ("query", "string", ""),
                        ("tags", "string", ""), ("filters", "string", "")]
                return QLResult(columns=["Field", "Type", "Properties"],
                                rows=rows)
            tname = {"multi": "mva", "multi64": "mva64"}
            stored = set(getattr(t, "stored_fields", ()) or ())
            # columnar_attrs display (the SoA device layout subsumes the
            # columnar lib; DESC shows the declared storage per attr)
            colr = {c.strip() for c in str((getattr(t, "options", None)
                    or {}).get("columnar_attrs", "")).replace(
                    ",", " ").split() if c.strip()}
            rows = [("id", "bigint", "columnar" if "id" in colr else "")]
            rows += [(f, "text",
                      "indexed stored" if f in stored else "indexed")
                     for f in t.schema.fields]
            rows += [(a.name, tname.get(a.type.value, a.type.value),
                      "columnar" if a.name in colr else "")
                     for a in t.schema.attrs]
            return QLResult(columns=["Field", "Type", "Properties"],
                            rows=rows)
        if k == "show_create_table":
            t = self.catalog.get(st.args[0])
            cols = [f"{f} text" for f in t.schema.fields]
            cols += [f"{a.name} {a.type.value}" for a in t.schema.attrs]
            ddl = f"CREATE TABLE {st.args[0]} (\n" + ",\n".join(cols) + "\n)"
            return QLResult(columns=["Table", "Create Table"],
                            rows=[(st.args[0], ddl)])
        if k == "show_index_status":
            t = self.catalog.get(st.args[0])
            return QLResult(
                columns=["Variable_name", "Value"],
                rows=[("index_type", "rt"),
                      ("indexed_documents", str(t.n_docs)),
                      ("ram_chunk_segments_count", str(len(t.segments)))])
        if k == "drop_table":
            name, if_exists = st.args
            if name not in self.catalog.tables:
                if if_exists:
                    return QLResult.ok()
                return QLResult.err(f"no such table '{name}'")
            self.catalog.drop(name)
            return QLResult.ok()
        if k == "truncate":
            import time as _time
            tname, cl = self._resolve_write_ref(st.args[0])
            if cl is not None:
                cl.replicate(tname, {"op": "truncate", "ts": _time.time()})
                return QLResult.ok()
            self.catalog.get(tname).truncate()
            return QLResult.ok()
        if k == "create_cluster":
            from ..server.cluster import create_cluster
            if self.catalog.cluster_service is None:
                return QLResult.err("cluster service is not running "
                                    "(start the daemon with --cluster)")
            create_cluster(self.catalog, self.catalog.cluster_service,
                           st.args[0])
            return QLResult.ok()
        if k == "join_cluster":
            from ..server.cluster import join_cluster
            if self.catalog.cluster_service is None:
                return QLResult.err("cluster service is not running "
                                    "(start the daemon with --cluster)")
            if not st.args[1]:
                return QLResult.err("JOIN CLUSTER needs AT 'host:port'")
            join_cluster(self.catalog, self.catalog.cluster_service,
                         st.args[0], st.args[1])
            return QLResult.ok()
        if k == "delete_cluster":
            cl = self.catalog.clusters.pop(st.args[0], None)
            if cl is None:
                return QLResult.err(f"unknown cluster '{st.args[0]}'")
            cl.stop()
            return QLResult.ok()
        if k == "cluster_add":
            import time as _time
            cl = self.catalog.clusters.get(st.args[0])
            if cl is None:
                return QLResult.err(f"unknown cluster '{st.args[0]}'")
            t = self.catalog.get(st.args[1])    # must exist locally
            cl.tables.add(st.args[1])
            # membership replicates through the ordered log so every
            # member accepts subsequent cluster:table writes (the
            # reference ships the table to all nodes on ALTER CLUSTER ADD)
            cl.replicate(st.args[1], {
                "op": "cluster_add", "schema": t.schema.to_json(),
                "options": dict(getattr(t, "options", {})),
                "ts": _time.time()})
            return QLResult.ok()
        if k == "cluster_drop":
            cl = self.catalog.clusters.get(st.args[0])
            if cl is None:
                return QLResult.err(f"unknown cluster '{st.args[0]}'")
            cl.tables.discard(st.args[1])
            return QLResult.ok()
        if k == "optimize":
            self.catalog.get(st.args[0]).optimize()
            return QLResult.ok()
        if k == "flush":
            self.catalog.get(st.args[0]).flush()
            return QLResult.ok()
        if k == "flush_ramchunk":
            t = self.catalog.get(st.args[0])
            if not hasattr(t, "flush_ramchunk"):
                return QLResult.err(
                    f"FLUSH RAMCHUNK requires an RT table, "
                    f"'{st.args[0]}' is not")
            t.flush_ramchunk()
            return QLResult.ok()
        if k == "debug_split":
            tbl, cid, var = st.args
            t = self.catalog.get(tbl)
            vals = self.uservars.get(var) or []
            if hasattr(t, "split_chunk"):
                t.split_chunk(int(cid), vals)
            return QLResult.ok()
        if k == "debug_merge":
            tbl, a, b = st.args
            t = self.catalog.get(tbl)
            if hasattr(t, "merge_chunks"):
                t.merge_chunks(int(a), int(b))
            return QLResult.ok()
        if k == "debug":
            return QLResult.ok()
        if k in ("flush_attributes", "flush_logs", "flush_hostnames",
                 "set_names"):
            return QLResult.ok()
        if k == "begin":
            self._commit_txn()
            self.in_txn = True
            return QLResult.ok()
        if k == "commit":
            self._commit_txn()
            self.in_txn = False
            return QLResult.ok()
        if k == "rollback":
            for n in self.txn_tables:
                self.catalog.get(n).rollback()
            self.txn_tables = set()
            self.in_txn = False
            return QLResult.ok()
        if k == "reload_tables":
            names = self.catalog.rotate()
            return QLResult.ok(len(names))
        if k in ("reload_table", "import_table"):
            # load a saved packed index from a path into the catalog
            # (IMPORT TABLE / RELOAD TABLE ... FROM)
            name, src = st.args
            from ..index.rt import rt_from_packed
            from ..index.storage import load_packed
            if k == "import_table" and name in self.catalog.tables:
                return QLResult.err(f"table '{name}' already exists")
            try:
                packed = load_packed(src)
            except (OSError, ValueError, KeyError) as e:
                return QLResult.err(
                    f"IMPORT TABLE failed: can not read table files "
                    f"from '{src}': {e}")
            ddir = (os.path.join(self.catalog.data_dir, name)
                    if self.catalog.data_dir else None)
            rt = rt_from_packed(name, packed, ddir,
                                device=self.catalog.device)
            rt.generation = int(time.time())
            self.catalog.tables[name] = rt
            self.catalog._save_manifest()
            return QLResult.ok(packed.n_docs)
        if k == "attach":
            src, dst = st.args[0], st.args[1]
            truncate = len(st.args) > 2 and st.args[2] == "truncate"
            from ..index.rt import rt_from_packed
            from ..index.storage import load_packed
            if src in self.catalog.tables:
                # served-table form (AttachDiskIndex, sphinxrt.cpp): the
                # plain index's data moves into the RT index (emptied
                # first WITH TRUNCATE) and the source stops being served
                srct = self.catalog.tables[src]
                dstt = self.catalog.tables.get(dst)
                if dstt is None:
                    return QLResult.err(f"no such table '{dst}'")
                if truncate:
                    dstt.truncate()
                for p in srct.searchable_parts():
                    dstt.attach_packed(p.packed)
                # the attached disk index's docstore travels with it
                # (AttachDiskIndex moves the whole index incl. .spds;
                # golden test_398 SELECT * shows stored title after ATTACH)
                src_stored = list(getattr(srct, "stored_fields", ()) or ())
                if src_stored:
                    dst_stored = list(getattr(dstt, "stored_fields", ())
                                      or ())
                    dstt.stored_fields = dst_stored + [
                        f for f in src_stored if f not in dst_stored]
                del self.catalog.tables[src]
                self.catalog._save_manifest()
                return QLResult.ok(0)
            if dst in self.catalog.tables:
                return QLResult.err(f"table '{dst}' already exists")
            try:
                packed = load_packed(src)
            except (OSError, ValueError, KeyError) as e:
                return QLResult.err(
                    f"ATTACH failed: can not read index files from "
                    f"'{src}': {e}")
            ddir = (os.path.join(self.catalog.data_dir, dst)
                    if self.catalog.data_dir else None)
            self.catalog.tables[dst] = rt_from_packed(
                dst, packed, ddir, device=self.catalog.device)
            self.catalog._save_manifest()
            return QLResult.ok(packed.n_docs)
        if k == "explain":
            idx, qtext = st.args
            t = self.catalog.get(idx)
            parts = t.searchable_parts()
            if not parts:
                return QLResult(columns=["Variable", "Value"],
                                rows=[("transformed_tree", "EMPTY")])
            cq = parts[0].plan(SearchQuery(match=qtext))
            from ..query.explain import render_plan
            return QLResult(columns=["Variable", "Value"],
                            rows=[("transformed_tree",
                                   render_plan(cq.ast, t.schema))])
        return QLResult.err(f"unhandled statement kind {k}")

    def _commit_txn(self):
        for n in self.txn_tables:
            self.catalog.get(n).commit()
        self.txn_tables = set()


def _exist_type_error(tree, schema) -> str | None:
    """EXIST('name', default) over an MVA or string-family attr is a
    per-index parse error (EXIST typecheck, sphinxexpr.cpp: 'MVA and
    STRING in EXIST() prohibited'; golden test_163 q30/31)."""
    if not isinstance(tree, tuple):
        return None
    if tree[0] == "call" and len(tree) >= 3:
        if tree[1] == "EXIST" and tree[2]:
            a0 = tree[2][0]
            if isinstance(a0, tuple) and len(a0) >= 2 \
                    and a0[0] in ("str", "attr"):
                ad = schema.attr(str(a0[1]).strip().lower())
                if ad is not None and ad.type.value in (
                        "multi", "multi64", "string", "json"):
                    return "MVA and STRING in EXIST() prohibited"
        for a in tree[2]:
            e = _exist_type_error(a, schema)
            if e:
                return e
        return None
    for sub in tree[1:]:
        e = _exist_type_error(sub, schema)
        if e:
            return e
    return None


def _part_schemas(tables) -> list:
    """Every individual-part schema behind a FROM list: plain tables
    contribute their own schema; distributed tables contribute each
    LOCAL part's schema (remote agents check sort attrs on their own
    daemon). Used to decide whether an ORDER BY key is a real per-part
    attr vs a host expression sort (RunLocalSearches per-index sorter
    failures, searchd.cpp; golden test_163)."""
    out = []
    for t in tables:
        if hasattr(t, "_tables"):            # harness cross-env dist
            try:
                out.extend(p.schema for p in t._tables())
                continue
            except Exception:
                pass
        if hasattr(t, "_parts"):             # DistributedTable
            try:
                for p in t._parts():
                    s = getattr(p, "schema", None)
                    if s is not None:
                        out.append(s)
                continue
            except Exception:
                pass
        s = getattr(t, "schema", None)
        if s is not None:
            out.append(s)
    return out


def _fold_expr_case(expr: str) -> str:
    """Display name of an unaliased select item: keywords/identifiers fold
    to lowercase but string literals keep their case (the reference's
    lexer folds outside quotes only)."""
    out = []
    q = None
    for ch in expr:
        if q:
            out.append(ch)
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            out.append(ch)
        else:
            out.append(ch.lower())
    return "".join(out)


def _split_call_args(s: str) -> list[tuple[str, bool]]:
    """Split a function-call argument list on top-level commas; returns
    (text, was_quoted) per argument (quotes stripped, escapes applied)."""
    args: list[tuple[str, bool]] = []
    cur: list[str] = []
    quoted = False
    q = None
    depth = 0
    i = 0
    while i < len(s):
        c = s[i]
        if q:
            if c == "\\" and i + 1 < len(s):
                cur.append(s[i + 1])
                i += 2
                continue
            if c == q:
                q = None
            else:
                cur.append(c)
        elif c in "'\"":
            q = c
            quoted = True
        elif c == "(":
            depth += 1
            cur.append(c)
        elif c == ")":
            depth -= 1
            cur.append(c)
        elif c == "," and depth == 0:
            args.append(("".join(cur).strip() if not quoted
                         else "".join(cur), quoted))
            cur = []
            quoted = False
        else:
            cur.append(c)
        i += 1
    if cur or args:
        args.append(("".join(cur).strip() if not quoted
                     else "".join(cur), quoted))
    return args


def _make_snippet_getter(raw: str, table, schema):
    """Build a per-match getter for SNIPPET(data, query, 'opt=val'...)."""
    from ..text.dictionary import Dictionary
    from ..text.tokenizer import Tokenizer
    from .snippets import SnippetOptions, build_snippet

    inner = raw[raw.index("(") + 1: raw.rindex(")")]
    parts = _split_call_args(inner)
    if len(parts) < 2:
        raise ValueError("SNIPPET() expects (data, query, ...)")
    (data_text, data_quoted), (query, query_quoted) = parts[0], parts[1]
    if not query_quoted:
        raise ValueError("1 argument to SNIPPET() must be a string")
    opts = SnippetOptions()
    from .snippets import OPTION_ALIASES
    for text, _quoted in parts[2:]:
        k, _, v = text.partition("=")
        k = OPTION_ALIASES.get(k.strip().lower(), k.strip().lower())
        if hasattr(opts, k):
            cur = getattr(opts, k)
            if isinstance(cur, bool):
                v = bool(int(v))
            elif isinstance(cur, int):
                v = int(v)
            setattr(opts, k, v)
    tok = Tokenizer(table.tok_settings)
    dic = Dictionary(table.dict_settings)

    def getter(m):
        if data_quoted:
            text = data_text
        else:
            text = m.attrs.get(data_text)
            if text is None and hasattr(table, "get_document"):
                text = (table.get_document(m.docid) or {}).get(data_text, "")
        return build_snippet(str(text or ""), query, tok, dic, opts)
    return getter


def _lenient_json(s: str):
    """JSON with the reference parser's leniencies: bare TRUE/FALSE/NULL
    in any case (sphinxjson.cpp accepts them case-insensitively)."""
    try:
        return json.loads(s)
    except ValueError:
        import re as _re
        fixed = _re.sub(
            r'("(?:[^"\\]|\\.)*")|\b(?i:TRUE|FALSE|NULL)\b',
            lambda m: m.group(1) if m.group(1) else m.group(0).lower(), s)
        return json.loads(fixed)


def _filter_stored_queries(stored, conds):
    """WHERE over a percolate table's stored queries: id conditions and
    `tags ANY/ALL ('t1','t2')` (sphinxpq.cpp stored-query filtering)."""
    import operator as _op
    ops = {"=": _op.eq, "!=": _op.ne, "<>": _op.ne, "<": _op.lt,
           "<=": _op.le, ">": _op.gt, ">=": _op.ge}
    out = stored
    for c in conds or []:
        if c.kind == "cmp" and c.attr == "id":
            out = [q for q in out if ops[c.op](q.qid, int(c.value))]
        elif c.kind == "between" and c.attr == "id":
            out = [q for q in out
                   if (int(c.lo) <= q.qid <= int(c.hi)) != c.negate]
        elif c.kind == "in" and c.attr == "id":
            want = {int(v) for v in c.values}
            keep = [q for q in out if (q.qid in want) != c.negate]
            out = keep
        elif c.kind == "cmp" and c.attr == "tags":
            # tags = '...' / tags != '...' string compares (the common
            # golden form is tags!='' — a has-tags check)
            val = str(c.value)
            eq = c.op == "="
            out = [q for q in out
                   if (" ".join(q.tags) == val) == eq]
        elif c.kind in ("any", "all") and c.attr == "tags":
            vals = {str(v) for v in c.values}
            if c.kind == "any":
                out = [q for q in out
                       if bool(set(q.tags) & vals) != c.negate]
            else:
                out = [q for q in out
                       if (vals <= set(q.tags)) != c.negate]
        else:
            raise ValueError(
                f"unsupported percolate WHERE condition on '{c.attr}'")
    return out


def _cond_to_filter(c: Cond):
    if c.kind == "cmp":
        if c.op == "=":
            return AttrFilterDef(c.attr, "values", values=[c.value]), None
        if c.op in ("!=", "<>"):
            return AttrFilterDef(c.attr, "values", values=[c.value],
                                 exclude=True), None
        is_f = isinstance(c.value, float)
        kind = "range_f" if is_f else "range_i"
        if c.op == "<":
            return AttrFilterDef(c.attr, kind, hi=c.value, hi_excl=True), None
        if c.op == "<=":
            return AttrFilterDef(c.attr, kind, hi=c.value), None
        if c.op == ">":
            return AttrFilterDef(c.attr, kind, lo=c.value, lo_excl=True), None
        if c.op == ">=":
            return AttrFilterDef(c.attr, kind, lo=c.value), None
    if c.kind == "in":
        return AttrFilterDef(c.attr, "values", values=c.values,
                             exclude=c.negate), None
    if c.kind == "between":
        is_f = isinstance(c.lo, float) or isinstance(c.hi, float)
        return AttrFilterDef(c.attr, "range_f" if is_f else "range_i",
                             lo=c.lo, hi=c.hi, exclude=c.negate), None
    if c.kind == "isnull":
        # host-evaluated late filter on the ISNULL expression
        expr = f"{c.attr} is{' not' if c.negate else ''} null"
        return AttrFilterDef(expr, "values", values=[1]), None
    if c.kind in ("any", "all"):
        # MVA membership over values (Filter_MVA ANY/ALL)
        return AttrFilterDef(c.attr, f"mva_{c.kind}", values=c.values,
                             exclude=c.negate), None
    return None, f"unsupported condition {c.kind}"


_AGG_RE = __import__("re").compile(
    r"^\s*(count|sum|min|max|avg|group_concat)\s*\(", __import__("re").I)


def _is_aggregate_expr(e: str) -> bool:
    """True for aggregate calls — but MIN(x,y)/MAX(x,y) with two args are
    the SCALAR expression functions, not aggregates (ExprParser MIN/MAX
    vs sphinxsort aggregates; golden test_050 'min(a,n) as sel')."""
    m = _AGG_RE.match(e or "")
    if not m:
        return False
    if m.group(1).lower() not in ("min", "max"):
        return True
    depth = 0
    for ch in e[m.end():]:
        if ch == "(":
            depth += 1
        elif ch == ")":
            if depth == 0:
                break
            depth -= 1
        elif ch == "," and depth == 0:
            return False      # two top-level args: scalar MIN/MAX
    return True


def _resolve_agg_args(e: str, items) -> str:
    """Aggregate args referencing select ALIASES resolve to the aliased
    expressions (count(distinct i) with `j.id i`, golden test_412)."""
    import re as _re
    amap = {it.alias: it.expr for it in items
            if it.alias and it.alias != it.expr}
    if not amap:
        return e
    head, _, rest = e.partition("(")
    rest = _re.sub(r"[A-Za-z_][\w.]*",
                   lambda m: amap.get(m.group(0), m.group(0)), rest)
    return head + "(" + rest


def _engine_select(items) -> list:
    """Select list for the engine: aggregates keep their function form
    (aliases only rename output columns)."""
    out = []
    for it in items:
        e = it.expr
        low = e.lower().replace(" ", "")
        if low.startswith(("packedfactors(", "count(", "sum(", "min(",
                           "max(", "avg(", "group_concat(")):
            out.append(_resolve_agg_args(e, items))
        else:
            out.append(it.alias or it.display or it.expr)
    return out


def _extract_id_list(conds: list[Cond]):
    """id=N / id IN (...) fast path for DELETE/UPDATE."""
    if len(conds) != 1:
        return None
    c = conds[0]
    if c.attr != "id":
        return None
    if c.kind == "cmp" and c.op == "=":
        return [int(c.value)]
    if c.kind == "in" and not c.negate:
        return [int(v) for v in c.values]
    return None


def _levenshtein(a: str, b: str, cap: int) -> int:
    if abs(len(a) - len(b)) > cap:
        return cap + 1
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
