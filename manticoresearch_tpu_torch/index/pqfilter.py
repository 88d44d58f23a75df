"""Stored-query attribute filters for percolate tables.

Behavioral model: PercolateParseFilters (Manticore src/searchdsql.cpp
:1602) — the filter string is first parsed with the SphinxQL WHERE grammar
(filter_expr: AND/OR trees of filter items, sphinxql.y:595-867) into
CSphFilterSettings; if that fails wholesale with a syntax error, the whole
string is re-parsed as ONE boolean expression (SPH_FILTER_EXPRESSION whose
attr name is the verbatim text).  The stored settings are re-rendered for
display by FormatFiltersQL (Manticore src/sphinxfilter.cpp:2289),
which is why `all(mva3) < 13` comes back as `mva3<=12` while a plain
`mva3 < 13` stays `mva3<13`.

Matching evaluates the parsed tree per document on the host — CALL PQ
batches are tiny (the docs of one call), so this is the cheap side of the
percolate pipeline; the device engine handles the full-text part.

The port's copy of ``manticoresearch_tpu/index/pqfilter.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..query.sphinxql import SqlParseError, SqlParser

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


@dataclass
class PqFilter:
    """One filter leaf (CSphFilterSettings analog)."""
    attr: str
    ftype: str              # values|range|frange|string|strlist|null|expr
    values: list = field(default_factory=list)       # ints (values)
    strings: list = field(default_factory=list)      # strlist / string
    lo: float = INT64_MIN
    hi: float = INT64_MAX
    eq_min: bool = True
    eq_max: bool = True
    exclude: bool = False
    mva_func: str = "none"  # none|any|all  (SPH_MVAFUNC_*)
    is_null: bool = False   # for ftype null
    expr_text: str = ""     # for ftype expr


# tree node: ("f", PqFilter) | ("and", left, right) | ("or", left, right)


class PqFilterError(ValueError):
    pass


def parse_filters(s: str, attr_names: set[str] | None = None):
    """Parse a stored-query filter string into a filter tree, falling back
    to a whole-string expression filter exactly like PercolateParseFilters.

    Returns the tree, or None for an empty string. Raises PqFilterError on
    unknown attributes / unparseable text (the reference fails the INSERT).
    """
    s = (s or "").strip()
    if not s:
        return None
    try:
        p = SqlParser(s)
        tree = _parse_or(p)
        if p.peek()[0] is not None:
            raise SqlParseError(f"unexpected {p.peek()[1]!r}")
    except SqlParseError:
        # whole-string expression fallback (searchdsql.cpp:1700-1719)
        from ..query.expr import ExprError, parse_expr
        try:
            parse_expr(s)
        except ExprError as e:
            raise PqFilterError(f"bad filters: {e}") from None
        return ("f", PqFilter(attr=s, ftype="expr", expr_text=s))
    # attribute names must exist (searchdsql.cpp:1663 "no such filter
    # attribute"); json paths check the part before the first dot
    if attr_names is not None:
        for f in _leaves(tree):
            base = f.attr.split(".", 1)[0]
            if base not in attr_names and base != "id":
                raise PqFilterError(f"no such filter attribute '{base}'")
    return tree


def _leaves(tree):
    if tree[0] == "f":
        yield tree[1]
    else:
        yield from _leaves(tree[1])
        yield from _leaves(tree[2])


def _parse_or(p: SqlParser):
    node = _parse_and(p)
    while p.eat_kw("OR"):
        node = ("or", node, _parse_and(p))
    return node


def _parse_and(p: SqlParser):
    node = _parse_prim(p)
    while p.eat_kw("AND"):
        node = ("and", node, _parse_prim(p))
    return node


def _parse_prim(p: SqlParser):
    if p.peek() == ("op", "("):
        p.next()
        node = _parse_or(p)
        p.expect_op(")")
        return node
    return ("f", _parse_item(p))


def _int(v) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    raise SqlParseError(f"expected integer, got {v!r}")


def _parse_item(p: SqlParser) -> PqFilter:
    # lhs: ANY(attr) / ALL(attr) mva aggregates, or a plain/json ident
    mva_func = "none"
    if p.at_kw("ANY", "ALL") and p.peek(1) == ("op", "("):
        kw = p.next()[1].lower()
        p.expect_op("(")
        attr = p.name()
        p.expect_op(")")
        mva_func = kw
    else:
        attr = p.name()
        if attr.upper() in ("AND", "OR", "NOT"):
            raise SqlParseError(f"bad filter attr {attr!r}")

    neg = bool(p.eat_kw("NOT"))

    if p.eat_kw("IN"):
        p.expect_op("(")
        vals = [p.value()]
        while p.peek() == ("op", ","):
            p.next()
            vals.append(p.value())
        p.expect_op(")")
        if all(isinstance(v, str) for v in vals):
            if mva_func != "none":
                raise SqlParseError("string list on mva aggregate")
            return PqFilter(attr=attr, ftype="strlist", strings=vals,
                            exclude=neg, mva_func="none")
        ivals = sorted({_int(v) for v in vals})  # m_dValues.Uniq()
        f = PqFilter(attr=attr, ftype="values", values=ivals, exclude=neg)
        if mva_func != "none":
            # NOT IN inverts the aggregate (sphinxql.y:813-821)
            f.mva_func = (("all" if mva_func == "any" else "any")
                          if neg else mva_func)
        return f

    if p.eat_kw("BETWEEN"):
        lo = p.value()
        p.expect_kw("AND")
        hi = p.value()
        if isinstance(lo, float) or isinstance(hi, float):
            return PqFilter(attr=attr, ftype="frange", lo=float(lo),
                            hi=float(hi), exclude=neg)
        f = PqFilter(attr=attr, ftype="range", lo=_int(lo), hi=_int(hi),
                     exclude=neg)
        if mva_func != "none":
            f.mva_func = (("all" if mva_func == "any" else "any")
                          if neg else mva_func)
        return f

    if neg:
        # `attr NOT ANY/ALL ('...')` string-list forms
        if p.at_kw("ANY", "ALL"):
            kw = p.next()[1].lower()
            vals = _string_list(p)
            return PqFilter(attr=attr, ftype="strlist", strings=vals,
                            exclude=True, mva_func=kw)
        raise SqlParseError("expected IN/BETWEEN/ANY/ALL after NOT")

    if p.at_kw("IS"):
        p.next()
        n2 = bool(p.eat_kw("NOT"))
        p.expect_kw("NULL")
        return PqFilter(attr=attr, ftype="null", is_null=not n2)

    if p.at_kw("ANY", "ALL") and p.peek(1) == ("op", "("):
        kw = p.next()[1].lower()
        vals = _string_list(p)
        return PqFilter(attr=attr, ftype="strlist", strings=vals,
                        mva_func=kw)

    k, op = p.next()
    if k != "op" or op not in ("=", "!=", "<>", "<", "<=", ">", ">="):
        raise SqlParseError(f"bad condition operator {op!r}")
    if op == "<>":
        op = "!="
    v = p.value()

    if isinstance(v, str):
        if op not in ("=", "!="):
            raise SqlParseError("strings support =/!= only")
        return PqFilter(attr=attr, ftype="string", strings=[v],
                        exclude=(op == "!="), mva_func=mva_func)
    if v is None:
        raise SqlParseError("NULL needs IS [NOT] NULL")

    if isinstance(v, float):
        # float rules (sphinxql.y:707-752): =/!= make [v,v] with equality
        if op == "=":
            return PqFilter(attr=attr, ftype="frange", lo=v, hi=v)
        if op == "!=":
            return PqFilter(attr=attr, ftype="frange", lo=v, hi=v,
                            exclude=True)
        f = PqFilter(attr=attr, ftype="frange")
        if op in (">", ">="):
            f.lo, f.hi = v, float("inf")
            f.eq_min, f.eq_max = (op == ">="), True
        else:
            f.lo, f.hi = float("-inf"), v
            f.eq_min, f.eq_max = True, (op == "<=")
        return f

    v = _int(v)
    if mva_func != "none":
        # mva aggregates normalize strict ranges to inclusive ones
        # (AddMvaRange, sphinxql.y:835-850: `<v` -> [MIN, v-1])
        if op == "=":
            return PqFilter(attr=attr, ftype="values", values=[v],
                            mva_func=mva_func)
        if op == "!=":
            inv = "all" if mva_func == "any" else "any"
            return PqFilter(attr=attr, ftype="values", values=[v],
                            exclude=True, mva_func=inv)
        f = PqFilter(attr=attr, ftype="range", mva_func=mva_func)
        if op == "<":
            f.hi = v - 1
        elif op == "<=":
            f.hi = v
        elif op == ">":
            f.lo = v + 1
        else:
            f.lo = v
        return f

    if op == "=":
        return PqFilter(attr=attr, ftype="values", values=[v])
    if op == "!=":
        return PqFilter(attr=attr, ftype="values", values=[v], exclude=True)
    f = PqFilter(attr=attr, ftype="range")
    if op in (">", ">="):
        f.lo, f.eq_min = v, (op == ">=")
    else:
        f.hi, f.eq_max = v, (op == "<=")
    return f


def _string_list(p: SqlParser) -> list[str]:
    p.expect_op("(")
    vals = [p.value()]
    while p.peek() == ("op", ","):
        p.next()
        vals.append(p.value())
    p.expect_op(")")
    if not all(isinstance(v, str) for v in vals):
        raise SqlParseError("expected string list")
    return vals


# ---------------------------------------------------------------------------
# display rendering (FormatFilterQL, sphinxfilter.cpp:2108-2222)

def _fmt_num(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


def render_filter(f: PqFilter) -> str:
    t = f.ftype
    if t == "values":
        if len(f.values) == 1:
            return f"{f.attr}{'!=' if f.exclude else '='}{f.values[0]}"
        op = " NOT IN (" if f.exclude else " IN ("
        vals = f.values
        if len(vals) > 6:   # iCompactIN=5 ellipsis form
            head = ",".join(map(str, vals[:2]))
            tail = ",".join(map(str, vals[-3:]))
            return f"{f.attr}{op}{head},...{tail})"
        return f"{f.attr}{op}{','.join(map(str, vals))})"
    if t == "range":
        if f.lo == INT64_MIN:
            op = [["<", "<="], [">=", ">"]][f.exclude][f.eq_max]
            return f"{f.attr}{op}{f.hi}"
        if f.hi == INT64_MAX:
            op = [[">", ">="], ["<", "<="]][f.exclude][f.eq_min]
            return f"{f.attr}{op}{f.lo}"
        if f.eq_min != f.eq_max:
            o1, o2 = ("<=" if f.eq_min else "<"), ("<=" if f.eq_max else "<")
            pre = "NOT " if f.exclude else ""
            return f"{pre}{f.lo}{o1}{f.attr}{o2}{f.hi}"
        lo = f.lo + (0 if f.eq_min else 1)
        hi = f.hi - (0 if f.eq_max else 1)
        neg = " NOT" if f.exclude else ""
        return f"{f.attr}{neg} BETWEEN {lo} AND {hi}"
    if t == "frange":
        if f.lo == float("-inf"):
            op = [["<", "<="], [">=", ">"]][f.exclude][f.eq_max]
            return f"{f.attr}{op}{_fmt_num(f.hi)}"
        if f.hi == float("inf"):
            op = [[">", ">="], ["<", "<="]][f.exclude][f.eq_min]
            return f"{f.attr}{op}{_fmt_num(f.lo)}"
        if f.eq_min != f.eq_max:
            o1, o2 = ("<=" if f.eq_min else "<"), ("<=" if f.eq_max else "<")
            pre = "NOT " if f.exclude else ""
            return (f"{pre}{_fmt_num(f.lo)}{o1}{f.attr}{o2}"
                    f"{_fmt_num(f.hi)}")
        neg = " NOT" if f.exclude else ""
        return (f"{f.attr}{neg} BETWEEN {_fmt_num(f.lo)} AND "
                f"{_fmt_num(f.hi)}")
    if t == "string":
        s = f.strings[0] if len(f.strings) == 1 else ""
        return f"{f.attr}{'!=' if f.exclude else '='}'{s}'"
    if t == "null":
        return f"{f.attr} IS {'NULL' if f.is_null else 'NOT NULL'}"
    if t == "strlist":
        neg = " NOT" if f.exclude else ""
        kw = {"any": " ANY ('", "all": " ALL ('"}.get(f.mva_func, " IN ('")
        return f.attr + neg + kw + "', '".join(f.strings) + "')"
    if t == "expr":
        return f.expr_text
    return "1 /* oops, unknown filter type */"


def render_filters(tree, *, root: bool = True) -> str:
    """FormatFiltersQL: AND-joined list, OR trees with nested parens."""
    if tree is None:
        return ""
    if tree[0] == "f":
        return render_filter(tree[1])
    op = " OR " if tree[0] == "or" else " AND "
    parts = []
    for sub in (tree[1], tree[2]):
        s = render_filters(sub, root=False)
        if sub[0] != "f":   # every nested boolean group is parenthesized
            s = "(" + s + ")"
        parts.append(s)
    return op.join(parts)


# ---------------------------------------------------------------------------
# host evaluation

def _resolve(attrs: dict, path: str):
    """Attr lookup incl. json dotted paths; returns None when missing."""
    if path in attrs:
        return attrs[path]
    if "." in path:
        base, rest = path.split(".", 1)
        v = attrs.get(base)
        for part in rest.split("."):
            if isinstance(v, dict):
                v = v.get(part)
            else:
                return None
        return v
    return None


def _as_num_list(v) -> list:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x for x in v if isinstance(x, (int, float))]
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return [v]
    if isinstance(v, bool):
        return [int(v)]
    return []


def eval_filter(f: PqFilter, attrs: dict, weight: int = 0,
                docid: int = 0) -> bool:
    t = f.ftype
    if t == "expr":
        from ..query.expr import ExprError, eval_expr_host, parse_expr
        try:
            return bool(eval_expr_host(parse_expr(f.expr_text), attrs,
                                       weight, docid))
        except ExprError:
            return False
    v = _resolve(attrs, f.attr)
    if t == "null":
        return (v is None) == f.is_null
    if t == "string":
        want = f.strings[0] if f.strings else ""
        got = v if isinstance(v, str) else ("" if v is None else str(v))
        return (got.lower() == want.lower()) != f.exclude
    if t == "strlist":
        want = {w.lower() for w in f.strings}
        if isinstance(v, (list, tuple)):
            got = {str(x).lower() for x in v}
        else:
            got = {str(v).lower()} if v is not None else set()
        if f.mva_func == "any":
            ok = bool(got & want)
        elif f.mva_func == "all":
            ok = bool(got) and got <= want
        else:   # IN: the value (or any element) is in the list
            ok = bool(got & want)
        return ok != f.exclude
    vals = _as_num_list(v)
    if t == "values":
        want = set(f.values)
        hits = [x in want for x in vals]
        if f.mva_func == "all":
            ok = bool(hits) and all(hits)
        else:                          # none/any
            ok = any(hits)
        return ok != f.exclude
    if t in ("range", "frange"):
        def inr(x):
            lo_ok = (x >= f.lo) if f.eq_min else (x > f.lo)
            hi_ok = (x <= f.hi) if f.eq_max else (x < f.hi)
            return lo_ok and hi_ok
        hits = [inr(x) for x in vals]
        if f.mva_func == "all":
            ok = bool(hits) and all(hits)
        else:
            ok = any(hits)
        return ok != f.exclude
    return False


def eval_filters(tree, attrs: dict, weight: int = 0, docid: int = 0) -> bool:
    if tree is None:
        return True
    if tree[0] == "f":
        return eval_filter(tree[1], attrs, weight, docid)
    a = eval_filters(tree[1], attrs, weight, docid)
    if tree[0] == "and":
        return a and eval_filters(tree[2], attrs, weight, docid)
    return a or eval_filters(tree[2], attrs, weight, docid)
