"""HTTP JSON query DSL -> SearchQuery.

Behavioral model: the reference's Elasticsearch-like JSON API
(sphParseJsonQuery, Manticore src/sphinxjsonquery.cpp:615-940,2362):
query clauses match / match_phrase / match_all / query_string / bool
(must/should/must_not/filter) / equals / in / range; top-level limit/size,
offset/from, sort, _source, aggs (terms buckets), max_matches.

The port's copy of ``manticoresearch_tpu/query/jsonquery.py``.
"""
from __future__ import annotations

import json
import re
from typing import Any

from ..exec.searcher import SearchQuery
from ..query.planner import AttrFilterDef


class JsonSearchError(Exception):
    """Search-time query error: rendered with the per-index prefix and
    HTTP 500 (the reference's AddError 'index %s: query error: %s' +
    SPH_HTTP_STATUS_500)."""


class JsonQueryError(ValueError):
    pass


def _escape_ft(text: str) -> str:
    """Escape full-text operator chars in user text (plain match clauses are
    not operator-aware in the JSON DSL)."""
    return re.sub(r'([()|\-!@~"/^$<=*]+)', " ", str(text))


def _match_to_ft(clause: Any, phrase: bool = False) -> str:
    if not isinstance(clause, dict) or len(clause) != 1:
        raise JsonQueryError("match clause must have exactly one field")
    field_name, spec = next(iter(clause.items()))
    if isinstance(spec, dict):
        text = spec.get("query", "")
        op = str(spec.get("operator", "or")).lower()
    else:
        text = spec
        op = "or"
    text = _escape_ft(text)
    words = text.split()
    if phrase:
        body = '"' + " ".join(words) + '"'
    elif op == "and":
        body = " ".join(words)
    else:
        body = " | ".join(words)
    if not words:
        return ""
    if field_name in ("_all", "*", ""):
        return f"({body})" if len(words) > 1 else body
    if "," in field_name:
        # the reference's field-list parser allows NO whitespace around
        # commas (ParseFieldList; golden test_334 'content, title' is a
        # query error, HTTP 500)
        import re as _re
        mm = _re.match(r"[A-Za-z_][A-Za-z_0-9]*(,[A-Za-z_][A-Za-z_0-9]*)*",
                       field_name)
        if not mm or mm.end() != len(field_name):
            near = field_name[mm.end():] if mm else field_name
            near = near.lstrip(",")
            raise JsonSearchError(
                "query error: error parsing field list: invalid field "
                f"block operator syntax near '{near}'")
        return f"(@({field_name}) {body})"
    return f"(@{field_name} {body})"


def _walk_query(q: dict, ft_parts: list[str], filters: list[AttrFilterDef],
                negate_ft: list[str]) -> None:
    for kind, body in q.items():
        if kind == "match":
            ft = _match_to_ft(body)
            if ft:
                ft_parts.append(ft)
        elif kind == "match_phrase":
            ft_parts.append(_match_to_ft(body, phrase=True))
        elif kind == "match_all":
            continue
        elif kind == "query_string":
            ft_parts.append(f"({body})" if isinstance(body, str) else "")
        elif kind == "bool":
            def _aslist(x):
                return [x] if isinstance(x, dict) else (x or [])
            must_ft: list[str] = []
            for must in _aslist(body.get("must")):
                _walk_query(must, must_ft, filters, negate_ft)
            for flt in _aslist(body.get("filter")):
                _walk_query(flt, must_ft, filters, negate_ft)
            should = _aslist(body.get("should"))
            sub_ft: list[str] = []
            if should:
                sub_f: list[AttrFilterDef] = []
                for sh in should:
                    _walk_query(sh, sub_ft, sub_f, negate_ft)
                if sub_f and not sub_ft and len(
                        {f.attr for f in sub_f}) == 1 and all(
                        f.kind == "values" and not f.exclude
                        for f in sub_f):
                    # OR of equals on one attr folds into a values set
                    filters.append(AttrFilterDef(
                        sub_f[0].attr, "values",
                        values=[v for f in sub_f for v in f.values]))
                elif sub_f:
                    raise JsonQueryError(
                        "attribute conditions under 'should' are not "
                        "supported yet (OR of filters)")
            if sub_ft and must_ft:
                # must + should combine with MAYBE: should only boosts
                # (ConstructBoolNode, sphinxjsonquery.cpp:553-557)
                ft_parts.append("((" + " ".join(must_ft) + ") MAYBE ("
                                + " | ".join(sub_ft) + "))")
            elif sub_ft:
                ft_parts.append("(" + " | ".join(sub_ft) + ")")
            else:
                ft_parts.extend(must_ft)
            for mn in _aslist(body.get("must_not")):
                sub_ft2: list[str] = []
                sub_f2: list[AttrFilterDef] = []
                _walk_query(mn, sub_ft2, sub_f2, negate_ft)
                for f in sub_f2:
                    filters.append(AttrFilterDef(
                        f.attr, f.kind, values=f.values, lo=f.lo, hi=f.hi,
                        exclude=not f.exclude, lo_excl=f.lo_excl,
                        hi_excl=f.hi_excl))
                negate_ft.extend(sub_ft2)
        elif kind == "equals":
            for attr, val in body.items():
                filters.append(AttrFilterDef(attr, "values", values=[val]))
        elif kind == "in":
            for attr, vals in body.items():
                filters.append(AttrFilterDef(attr, "values",
                                             values=list(vals)))
        elif kind == "range":
            for attr, spec in body.items():
                is_f = any(isinstance(spec.get(x), float)
                           for x in ("gt", "gte", "lt", "lte"))
                lo = spec.get("gte", spec.get("gt"))
                hi = spec.get("lte", spec.get("lt"))
                filters.append(AttrFilterDef(
                    attr, "range_f" if is_f else "range_i", lo=lo, hi=hi,
                    lo_excl="gt" in spec, hi_excl="lt" in spec))
        else:
            raise JsonQueryError(f"unsupported query clause {kind!r}")


def parse_json_query(body: dict) -> tuple[str, SearchQuery, dict]:
    """Returns (index, SearchQuery, aggs_spec)."""
    index = body.get("index") or body.get("table")
    if not index:
        raise JsonQueryError("missing 'index'")

    ft_parts: list[str] = []
    filters: list[AttrFilterDef] = []
    negate_ft: list[str] = []
    q = body.get("query") or {"match_all": {}}
    try:
        _walk_query(q, ft_parts, filters, negate_ft)
    except JsonSearchError as e:
        raise JsonSearchError(f"index {index}: {e}") from None

    match = " ".join(p for p in ft_parts if p)
    if negate_ft:
        match = (match + " " if match else "") + " ".join(
            f"-{p}" for p in negate_ft if p)

    sort: list[tuple[str, bool]] = []
    geo_sort = None
    mva_sort = None
    for s in body.get("sort", []) or []:
        if isinstance(s, str):
            sort.append((s, s != "_score"))
        elif isinstance(s, dict):
            for col, spec in s.items():
                if col == "_geo_distance":
                    # sort by distance from an anchor; location_source
                    # names the lat/lon attrs (degrees in the json API)
                    anchor = spec.get("location_anchor") or {}
                    raw_src = spec.get("location_source", "")
                    if isinstance(raw_src, list):
                        srcs = [str(x) for x in raw_src]
                    else:
                        srcs = [x for x in
                                re.split(r"[,\s]+", str(raw_src)) if x]
                    geo_sort = {"lat": float(anchor.get("lat", 0)),
                                "lon": float(anchor.get("lon", 0)),
                                "attrs": srcs,
                                "asc": str(spec.get("order", "asc")
                                           ).lower() != "desc"}
                    sort.append(("@geodist", geo_sort["asc"]))
                    continue
                order = spec.get("order", "asc") if isinstance(spec, dict) \
                    else spec
                if isinstance(spec, dict) and spec.get("mode"):
                    # MVA sort: min/max of the value list, host-side
                    mva_sort = {"col": col,
                                "mode": str(spec["mode"]).lower(),
                                "asc": str(order).lower() != "desc"}
                    sort.append(("@mva_sort", mva_sort["asc"]))
                    continue
                sort.append((col, str(order).lower() != "desc"))
    if not sort:
        sort = [("weight", False), ("id", True)]
    sort = [(("weight" if c == "_score" else c), a) for c, a in sort]

    limit = int(body.get("limit", body.get("size", 20)))
    offset = int(body.get("offset", body.get("from", 0)))

    src = body.get("_source")
    select = None
    if isinstance(src, str):
        select = [src]
    elif isinstance(src, list):
        select = [str(c) for c in src]
    elif isinstance(src, dict):
        # {"includes": [...], "excludes": [...]}: excludes glob; the
        # recorded wire format treats dict-form includes as EXACT names
        # ('=' prefix for the renderer; '-' marks excludes)
        if "includes" in src:
            select = ["=" + str(c) for c in (src.get("includes") or [])]
        else:
            select = ["*"]
        select += ["-" + str(c) for c in (src.get("excludes") or [])]
    elif src is False:
        select = []

    if mva_sort:
        sort = [(c, a) for c, a in sort if c != "@mva_sort"] \
            or [("weight", False), ("id", True)]
    ranker = "proximity_bm25"
    if (mva_sort or (sort and sort[0][0] not in ("weight", "_score"))) \
            and not body.get("track_scores"):
        # attr-sorted searches skip ranking unless track_scores is set
        # (_score renders 1)
        ranker = "none"
    sq = SearchQuery(
        match=match, filters=filters, limit=limit, offset=offset,
        max_matches=int(body.get("max_matches", 1000)),
        sort=sort, select=select, ranker=ranker,
    )
    extras = {}
    if geo_sort:
        extras["geo_sort"] = geo_sort
    if mva_sort:
        extras["mva_sort"] = mva_sort
    aggs = dict(body.get("aggs") or {})
    if extras:
        aggs["__extras__"] = extras
    return str(index), sq, aggs


def _typed_attr(v, atype):
    """JsonObjAddAttr (sphinxjsonquery.cpp:1147): BOOL renders true/false,
    FLOAT via PrintVarFloat ("%f" when it round-trips at f32, else %1.8f;
    the JSON number then loses trailing zeros), JSON attrs as parsed
    objects (sphJsonFormat), MVA as number arrays."""
    tname = getattr(atype, "name", str(atype)).lower()
    if tname == "bool":
        return bool(int(v or 0))
    if tname == "float":
        import numpy as _np
        f32 = _np.float32(v or 0.0)
        s = f"{float(f32):.6f}"
        if _np.float32(float(s)) != f32:
            s = f"{float(f32):.8f}"
        return float(s)
    if tname == "json":
        if isinstance(v, (dict, list)):
            return v
        s = str(v or "")
        if not s.strip():
            return None
        try:
            return json.loads(s)
        except ValueError:
            return s
    return v


def render_result(res, aggs_results: dict | None = None,
                  source: list[str] | None = None,
                  attr_names: set | None = None,
                  stored_docs: dict | None = None,
                  attr_types: dict | None = None) -> dict:
    hits = []
    for m in res.matches:
        attrs = m.attrs
        if attr_types:
            attrs = {k: (_typed_attr(v, attr_types[k])
                         if k in attr_types else v)
                     for k, v in attrs.items()}
        if attr_names is not None:
            # _source carries attributes, then the docstore's stored
            # fields (sphinxjsonquery EncodeResultToJson: attrs followed
            # by stored field text)
            attrs = {k: v for k, v in attrs.items() if k in attr_names}
        if stored_docs is not None:
            doc = stored_docs.get(m.docid)
            if doc:
                attrs = {**attrs, **doc}
        if source is not None:
            import fnmatch
            inc = [p for p in source
                   if not p.startswith("-") and not p.startswith("=")]
            inc_exact = [p[1:] for p in source if p.startswith("=")]
            exc = [p[1:] for p in source if p.startswith("-")]

            def _keep(k):
                if (inc or inc_exact) and not (
                        any(fnmatch.fnmatch(k, p) for p in inc)
                        or k in inc_exact):
                    return False
                return not any(fnmatch.fnmatch(k, p) for p in exc)
            attrs = {k: v for k, v in attrs.items() if _keep(k)}
        hits.append({
            "_id": m.docid,
            "_score": m.weight,
            "_source": attrs,
        })
    out = {
        "took": int(res.time_ms),
        "timed_out": False,
        "hits": {
            "total": res.total_found,
            "total_relation": "eq",
            "hits": hits,
        },
    }
    if res.warning:
        out["warning"] = {"reason": res.warning}
    if aggs_results:
        out["aggregations"] = aggs_results
    return out
