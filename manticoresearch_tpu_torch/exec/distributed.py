"""Distributed tables: local parts + remote agents.

Behavioral model: DistributedIndex_t (Manticore src/searchdha.h:679)
— a list of local index names plus agent mirror sets; SELECTs fan out to
all parts concurrently (locals run while remotes are in flight,
RunSubset, searchd.cpp:6550-6860), each agent returns ONE pre-merged
chunk (searchd.cpp:6737), and the master merges with the sorter's
comparator (weight desc, docid asc — MinimizeAggrResult/MergeAllMatches,
searchd.cpp:4816,3990). Writes are rejected (the reference forwards only
via agent_persistent INSERT, out of scope here; plain distributed tables
reject writes too).

The port's copy of ``manticoresearch_tpu/exec/distributed.py``: local
parts resolve through the catalog, so they run on the catalog's device.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace as dc_replace

from ..server.agent import (AgentError, MultiAgent, agent_blackhole,
                            agent_search, agent_update, parse_agent_spec,
                            payload_to_result, query_to_payload)


class _AgentPart:
    """Adapter: one agent (mirror set) as a searchable part."""

    def __init__(self, agent: MultiAgent, timeout: float, retry_count: int,
                 retry_delay: float):
        self.agent = agent
        self.timeout = timeout
        self.retry_count = retry_count
        self.retry_delay = retry_delay

    def search(self, q):
        from .searcher import SearchResult
        try:
            reply = agent_search(self.agent, query_to_payload(q),
                                 timeout=self.timeout,
                                 retry_count=self.retry_count,
                                 retry_delay=self.retry_delay)
        except AgentError as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        res = payload_to_result(reply)
        for m in res.matches:
            # wire matches carry no rowid (ParseMatch, searchd.cpp:1775):
            # the master's final sorter tiebreak sees them all equal
            m._remote = True
        return res


class _LocalPart:
    """Adapter: a named local table resolved lazily through the catalog
    (rotation/DDL-safe: each query sees the current table object)."""

    def __init__(self, catalog, name: str):
        self.catalog = catalog
        self.name = name

    @property
    def schema(self):
        try:
            return self.catalog.get(self.name).schema
        except (ValueError, KeyError):
            return None

    def search(self, q):
        from .searcher import SearchResult
        try:
            t = self.catalog.get(self.name)
        except (ValueError, KeyError) as e:
            return SearchResult([], 0, 0, 0.0, [], error=str(e))
        return t.search(q)


class DistributedTable:
    """A distributed table in the catalog. Options (CREATE TABLE ...
    type='distributed'): local='name' (repeatable), agent='h:p:tbl|h2:p2:tbl'
    (repeatable), agent_blackhole='h:p:tbl', ha_strategy, agent_query_timeout
    (ms), retry_count, retry_delay (ms)."""

    data_dir = None  # no on-disk state of its own

    def __init__(self, name: str, catalog, locals_: list[str],
                 agent_specs: list[str], blackhole_specs: list[str] = (),
                 ha_strategy: str = "random",
                 agent_query_timeout_ms: int = 3000,
                 retry_count: int = 2, retry_delay_ms: int = 0):
        self.name = name
        self.catalog = catalog
        self.locals_ = list(locals_)
        self.ha_strategy = ha_strategy
        self.timeout = agent_query_timeout_ms / 1000.0
        self.retry_count = retry_count
        self.retry_delay = retry_delay_ms / 1000.0
        self.agents = [MultiAgent(parse_agent_spec(s), strategy=ha_strategy)
                       for s in agent_specs]
        self.blackholes = [MultiAgent(parse_agent_spec(s),
                                      strategy=ha_strategy)
                           for s in blackhole_specs]
        self.options: dict = {}

    # -- catalog protocol ------------------------------------------------
    @property
    def schema(self):
        """Result schema = the INTERSECTION of the part schemas, ordered
        by the first part (the master minimizes the aggregate schema over
        all part results — MinimizeAggrResult, searchd.cpp:4816)."""
        schemas = []
        for n in self.locals_:
            try:
                schemas.append(self.catalog.get(n).schema)
            except (ValueError, KeyError):
                continue
        if not schemas:
            from ..schema import Schema
            return Schema(fields=[], attrs=[])
        base = schemas[0]
        common = {a.name for a in base.attrs}
        for sc in schemas[1:]:
            common &= {a.name for a in sc.attrs}
        if common == {a.name for a in base.attrs}:
            return base
        from ..schema import Schema
        return Schema(fields=list(base.fields),
                      attrs=[a for a in base.attrs if a.name in common])

    @property
    def tok_settings(self):
        """Text-pipeline settings delegate to the first reachable local
        part (CALL KEYWORDS/SNIPPETS against a distributed table use the
        first local agent's pipeline, searchd.cpp)."""
        for n in self.locals_:
            try:
                return self.catalog.get(n).tok_settings
            except (ValueError, KeyError, AttributeError):
                continue
        from ..text.tokenizer import TokenizerSettings
        return TokenizerSettings()

    @property
    def dict_settings(self):
        for n in self.locals_:
            try:
                return self.catalog.get(n).dict_settings
            except (ValueError, KeyError, AttributeError):
                continue
        from ..text.dictionary import DictSettings
        return DictSettings()

    @property
    def stored_fields(self):
        """SELECT * over a distributed table returns the parts' stored
        fields (the reference ships docstore columns in agent replies)."""
        for n in self.locals_:
            try:
                sf = getattr(self.catalog.get(n), "stored_fields", None)
            except (ValueError, KeyError):
                continue
            if sf:
                return sf
        return ()

    def get_document(self, docid):
        for n in self.locals_:
            try:
                t = self.catalog.get(n)
            except (ValueError, KeyError):
                continue
            gd = getattr(t, "get_document", None)
            if gd is not None:
                d = gd(docid)
                if d:
                    return d
        return None

    def delete(self, docids: list) -> int:
        """DELETE fans out to local parts (the reference forwards
        deletes to distributed parts, HandleMysqlDelete agent loop)."""
        n = 0
        for nm in self.locals_:
            try:
                t = self.catalog.get(nm)
                n += t.delete(docids)
                if hasattr(t, "commit"):
                    t.commit()
            except (ValueError, KeyError):
                continue
        return n

    def commit(self) -> None:
        """Transactional surface: local parts commit their own staged
        writes (update/delete fan-outs already commit per part)."""
        for nm in self.locals_:
            try:
                t = self.catalog.get(nm)
            except (ValueError, KeyError):
                continue
            if hasattr(t, "commit"):
                t.commit()

    def global_stats(self):
        """Aggregated (total_docs, df) over local parts (CALL KEYWORDS
        against a distributed table sums local stats)."""
        total = 0
        df: dict = {}
        for nm in self.locals_:
            try:
                t = self.catalog.get(nm)
            except (ValueError, KeyError):
                continue
            td, d = t.global_stats()
            total += td
            for k, v in d.items():
                df[k] = df.get(k, 0) + v
        return total, df

    @property
    def segments(self):
        segs = []
        for nm in self.locals_:
            try:
                segs.extend(self.catalog.get(nm).segments)
            except (ValueError, KeyError, AttributeError):
                continue
        return segs

    def flush(self) -> None:
        pass

    def _parts(self):
        """Tag order = merge order: the reference assigns store tags to
        AGENTS first, then locals (searchd.cpp:6484 agents, :6492+
        locals), and KillPlainDupes keeps the copy with the LARGEST tag
        (MatchIterator IsLess, searchd.cpp:3906) — so a docid present
        both locally and on an agent keeps the LOCAL row (golden
        test_163 dist2). Later entries in this list win dedup."""
        parts: list = [_AgentPart(a, self.timeout, self.retry_count,
                                  self.retry_delay) for a in self.agents]
        parts += [_LocalPart(self.catalog, n) for n in self.locals_]
        return parts

    # -- search ----------------------------------------------------------
    def search(self, q):
        from .multi import merge_part_results, search_grouped_parts
        from .searcher import SearchResult

        parts = self._parts()
        if not parts:
            return SearchResult([], 0, 0, 0.0, [],
                                error=f"distributed table '{self.name}' "
                                      f"has no parts")
        from .searcher import late_filters_for, run_late_filtered
        late = late_filters_for(q, self.schema)
        if late:
            return run_late_filtered(self.search, q, late)
        for bh in self.blackholes:
            agent_blackhole(bh, query_to_payload(q), timeout=self.timeout)

        if q.group_by:
            return search_grouped_parts(parts, q, self.schema,
                                        agent_mode=True)

        part_q = dc_replace(q, offset=0, limit=q.offset + q.limit)
        if any(getattr(f, "uservar", False) for f in q.filters):
            # remote agents don't share the master's uservars: @var
            # filters match nothing on agent parts (golden test_039)
            from .searcher import SearchResult as _SR
            results = [p.search(part_q) if isinstance(p, _LocalPart)
                       else _SR([], 0, 0, 0.0, [])
                       for p in parts]
            return merge_part_results(results, q, self.schema,
                                      agent_mode=bool(self.agents))
        if len(parts) == 1:
            results = [parts[0].search(part_q)]
        else:
            # locals + agents concurrently (local part runs while remote
            # requests are in flight — RunSubset, searchd.cpp:6550)
            with ThreadPoolExecutor(max_workers=min(len(parts), 16)) as ex:
                results = list(ex.map(lambda p: p.search(part_q), parts))
        merged = merge_part_results(results, q, self.schema,
                                    agent_mode=bool(self.agents))
        from .multi import minimize_result_schema
        try:
            merged.schema = minimize_result_schema(
                results, [getattr(p, "schema", None) or self.schema
                          for p in parts])
        except AttributeError:
            pass
        return merged

    # -- writes ----------------------------------------------------------
    def update_attrs(self, docids: list, values: dict) -> int:
        """UPDATE fans out to every part — local tables directly, agents
        over CMD_UPDATE (distributed UpdateAttrs, searchd.cpp
        HandleMysqlUpdate agent loop); returns total rows updated."""
        n = 0
        for nm in self.locals_:
            try:
                n += self.catalog.get(nm).update_attrs(docids, values)
            except (ValueError, KeyError):
                continue
        for a in self.agents:
            try:
                n += agent_update(a, docids, values, timeout=self.timeout,
                                  retry_count=self.retry_count,
                                  retry_delay=self.retry_delay)
            except AgentError:
                continue
        return n

    def _no_writes(self, *_a, **_k):
        raise ValueError(
            f"table '{self.name}' is distributed: INSERT/REPLACE/DELETE "
            f"are not supported on distributed tables")

    insert = replace = delete_documents = _no_writes
    truncate = optimize = _no_writes

    # -- observability ---------------------------------------------------
    def agent_status_rows(self) -> list[tuple[str, str]]:
        """SHOW AGENT STATUS rows (searchd.cpp HandleMysqlShowAgentStatus)."""
        rows: list[tuple[str, str]] = []
        for ai, agent in enumerate(self.agents):
            for mi, m in enumerate(agent.mirrors):
                p = f"agent{ai}_mirror{mi}"
                rows += [
                    (f"{p}_addr", m.addr()),
                    (f"{p}_queries", str(m.queries)),
                    (f"{p}_errors", str(m.errors)),
                    (f"{p}_timeouts", str(m.timeouts)),
                    (f"{p}_last_error", m.last_error),
                    (f"{p}_latency_ms", f"{m.ema_latency_ms:.3f}"),
                    (f"{p}_dead", "1" if m.is_dead() else "0"),
                    (f"{p}_pool_idle", str(len(m._pool()))),
                    (f"{p}_pool_hits", str(getattr(m, "_pool_hits", 0))),
                    (f"{p}_pool_misses",
                     str(getattr(m, "_pool_misses", 0))),
                ]
        return rows

    def all_mirrors(self):
        for agent in self.agents:
            yield from agent.mirrors
