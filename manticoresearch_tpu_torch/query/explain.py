"""SHOW PLAN / EXPLAIN rendering in the reference's exact format.

Behavioral model: sphExplainQuery + RenderPlainBsonPlan
(Manticore src/sphinxsearch.cpp:300-530): the transformed XQ tree
renders as nested TYPE(...) groups — keyword-bearing plain nodes as
AND(KEYWORD(word, querypos=N[, excluded][, expanded][, field_start]
[, field_end][, morphed][, boost=F])), non-keyword nodes on their own
indented lines ("\n" + 2 spaces per level), children comma-separated,
node options (distance=N / count=N) and access specs (fields=(...),
max_field_pos=N, zones=(...)) before the children.
"""
from __future__ import annotations

from .ast import (QAll, QAnd, QAndNot, QGap, QMaybe, QNear, QOr, QPhrase,
                  QQuorum, QSentence, QTerm)


class _Cursor:
    """Atom-position cursor replicating _SlotTable.get/skip ordering."""

    def __init__(self):
        self.pos = 0

    def take(self, span: int = 1) -> int:
        self.pos += 1
        p = self.pos
        self.pos += max(1, span) - 1
        return p

    def skip(self, span: int = 1) -> None:
        self.pos += max(1, span)


def _kw(word: str, qpos: int, *, excluded=False, expanded=False,
        field_start=False, field_end=False, morphed=False,
        boost=1.0) -> str:
    parts = [word, f"querypos={qpos}"]
    if excluded:
        parts.append("excluded")
    if expanded:
        parts.append("expanded")
    if field_start:
        parts.append("field_start")
    if field_end:
        parts.append("field_end")
    if morphed:
        parts.append("morphed")
    if boost != 1.0:
        parts.append("boost=%f" % boost)
    return "KEYWORD(" + ", ".join(parts) + ")"


def _specs(fields, zones, schema) -> list[str]:
    out = []
    if fields is not None and schema is not None:
        all_f = list(schema.fields)
        sel = [f for f in all_f if f in fields]
        if sel != all_f:
            out.append("fields=(" + ", ".join(sel) + ")")
    elif fields is not None:
        out.append("fields=(" + ", ".join(fields) + ")")
    if zones:
        span = any(z.startswith("=") for z in zones)
        names = [z.lstrip("=") for z in zones]
        out.append(("zonespans=(" if span else "zones=(")
                   + ", ".join(names) + ")")
    return out


def _indent(depth: int) -> str:
    return "\n" + "  " * depth


def _node(title: str, items: list[str], depth: int, inline: bool) -> str:
    head = "" if depth == 0 or inline else _indent(depth)
    return f"{head}{title}(" + ", ".join(items) + ")"


def _render(node, cur: _Cursor, depth: int, schema, excluded=False) -> str:
    if node is None or isinstance(node, QAll):
        return "" if node is None else _node("AND", [], depth, False)
    if isinstance(node, QGap):
        cur.skip(node.span)
        return ""
    if isinstance(node, QTerm):
        p = cur.take(getattr(node, "atom_span", 1))
        kw = _kw(getattr(node, "raw", "") or node.word, p, excluded=excluded,
                 expanded=bool(node.expanded), field_start=node.field_start,
                 field_end=node.field_end, boost=node.boost)
        items = _specs(node.fields, node.zones, schema) + [kw]
        return _node("AND", items, depth, False)
    if isinstance(node, QPhrase):
        deltas = node.positions or tuple(range(len(node.words)))
        base = cur.pos + 1
        cur.pos += (max(deltas) + 1) if deltas else len(node.words)
        raws = node.raws or node.words
        kws = [_kw(r, base + d) for r, d in zip(raws, deltas)]
        items = _specs(node.fields, (), schema) + kws
        title = "PROXIMITY" if node.proximity else "PHRASE"
        opts = [f"distance={node.proximity}"] if node.proximity else []
        return _node(title, opts + items, depth, False)
    if isinstance(node, QQuorum):
        kws = [_kw(r, cur.take())
               for r in (node.raws or node.words)]
        items = [f"count={node.m}"] + _specs(node.fields, (), schema) + kws
        return _node("QUORUM", items, depth, False)
    if isinstance(node, QAnd):
        kids = [_render(c, cur, depth + 1, schema) for c in node.children]
        return _node("AND", [k for k in kids if k], depth, False)
    if isinstance(node, QOr):
        # one wildcard pattern's expansions share the original atom pos
        pats = {c.expanded for c in node.children
                if isinstance(c, QTerm)} if node.children else set()
        if len(pats) == 1 and "" not in pats \
                and all(isinstance(c, QTerm) for c in node.children):
            kids = []
            p = None
            for c in node.children:
                if p is None:
                    p = cur.take()
                kids.append(_node("AND", [_kw(c.word, p, expanded=True)],
                                  depth + 1, False))
            return _node("OR", kids, depth, False)
        kids = [_render(c, cur, depth + 1, schema) for c in node.children]
        return _node("OR", [k for k in kids if k], depth, False)
    if isinstance(node, QAndNot):
        left = _render(node.left, cur, depth + 1, schema)
        right = _render(node.right, cur, depth + 2, schema, excluded=True)
        notn = _node("NOT", [right] if right else [], depth + 1, False)
        return _node("ANDNOT", [k for k in (left, notn) if k], depth, False)
    if isinstance(node, QMaybe):
        left = _render(node.left, cur, depth + 1, schema)
        right = _render(node.right, cur, depth + 1, schema)
        return _node("MAYBE", [k for k in (left, right) if k], depth, False)
    if isinstance(node, QNear):
        title = "NOTNEAR" if node.not_near else "NEAR"
        left = _render(node.left, cur, depth + 1, schema)
        right = _render(node.right, cur, depth + 1, schema,
                        excluded=node.not_near)
        return _node(title, [f"distance={node.n}"]
                     + [k for k in (left, right) if k], depth, False)
    if isinstance(node, QSentence):
        title = "PARAGRAPH" if node.paragraph else "SENTENCE"
        left = _render(node.left, cur, depth + 1, schema)
        right = _render(node.right, cur, depth + 1, schema)
        return _node(title, [k for k in (left, right) if k], depth, False)
    return repr(node)


def render_plan(ast, schema=None) -> str:
    """Transformed-tree string for SHOW PLAN / EXPLAIN QUERY."""
    if ast is None:
        return "EMPTY"
    return _render(ast, _Cursor(), 0, schema)
