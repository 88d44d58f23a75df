"""SphinxQL parser: MySQL-dialect SQL -> statement objects.

Behavioral model: the reference's bison grammar + statement enum
(Manticore src/sphinxql.y, searchdsql.h:71-138 — ~60 STMT_* kinds) and
the SELECT grammar (sphinxselect.y:206). Hand-rolled recursive descent; the
statement surface mirrors the reference's SphinxQL dialect:

SELECT select_list FROM idx[,idx2] [WHERE MATCH('...') AND conds]
    [GROUP [N] BY col] [WITHIN GROUP ORDER BY ...] [HAVING cond]
    [ORDER BY col {ASC|DESC}, ...] [LIMIT [off,]n] [OPTION k=v,...]
    [FACET ...]*
INSERT/REPLACE INTO idx [(cols)] VALUES (...),(...)
DELETE FROM idx WHERE ...
UPDATE idx SET a=v,... WHERE ...
CREATE TABLE / DROP TABLE / DESC / SHOW ... / SET ... / transactions /
TRUNCATE / OPTIMIZE / FLUSH / CALL ...

The port's copy of ``manticoresearch_tpu/query/sphinxql.py``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any


class SqlParseError(ValueError):
    pass


_SQL_TOK = re.compile(r"""
    (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<bname>`[^`]+`)
  | (?P<name>[A-Za-z_@][A-Za-z_0-9@.]*(?:\[(?:\d+|'[^']*')\][A-Za-z_0-9@.]*)*)
  | (?P<op><=|>=|<>|!=|:=|=|<|>|\(|\)|,|\*|\+|-|/|%|&|\||\^|;|:|\{|\})
  | (?P<ws>\s+|--[^\n]*|\#[^\n]*|/\*.*?\*/)
""", re.VERBOSE | re.DOTALL)


def sql_tokenize(s: str) -> list[tuple[str, str, int, int]]:
    """Returns (kind, text, start, end) — spans let expression text be
    recovered verbatim from the source."""
    out = []
    i = 0
    while i < len(s):
        m = _SQL_TOK.match(s, i)
        if not m:
            raise SqlParseError(f"bad character {s[i]!r} at offset {i}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "name" and "[" in m.group():
            # JSON subscripts normalize to dotted path segments:
            # j.parent[0] -> j.parent.0, j['key'] -> j.key
            # (sphinxjson path grammar)
            t = re.sub(r"\['([^']*)'\]", r".\1", m.group())
            t = re.sub(r"\[(\d+)\]", r".\1", t)
            out.append(("name", t, m.start(), m.end()))
            continue
        if m.lastgroup == "num" and i < len(s) \
                and (s[i].isalpha() or s[i] == "_"):
            # digit-leading identifier = BAD_NUMERIC (sphinxql.l lexer;
            # golden test_186 `select 100500some`)
            raise SqlParseError(
                f"sphinxql: syntax error, unexpected BAD_NUMERIC near "
                f"'{s[m.start():]}'")
        if m.lastgroup == "bname":
            # `backtick` identifiers (MySQL compat): any chars allowed
            out.append(("name", m.group()[1:-1], m.start(), m.end()))
            continue
        out.append((m.lastgroup, m.group(), m.start(), m.end()))
    return out


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


# ---- statement objects -----------------------------------------------------

@dataclass
class SelectItem:
    expr: str                 # raw expression text
    alias: str | None = None
    display: str | None = None   # column header when it differs from expr
    #                              (backticked digit-leading identifiers
    #                              display as typed, resolve stripped)


@dataclass
class Cond:
    """One WHERE condition."""
    kind: str                 # "match" | "cmp" | "in" | "between"
    attr: str = ""
    op: str = ""
    value: Any = None
    values: list = field(default_factory=list)
    lo: Any = None
    hi: Any = None
    negate: bool = False


@dataclass
class SelectStmt:
    items: list[SelectItem]
    indexes: list[str]
    conds: list[Cond]
    group_by: str | None = None
    group_n: int = 1
    within_order: list[tuple[str, bool]] = field(default_factory=list)
    having: tuple | None = None
    order: list[tuple[str, bool]] = field(default_factory=list)
    offset: int = 0
    limit: int = 20
    options: dict[str, Any] = field(default_factory=dict)
    facets: list["FacetStmt"] = field(default_factory=list)


@dataclass
class FacetStmt:
    items: list[SelectItem]
    by: list[str] | None      # BY expr list; None = group by the items
    order: list[tuple[str, bool]]
    offset: int
    limit: int


@dataclass
class InsertStmt:
    index: str
    columns: list[str]
    rows: list[list[Any]]
    replace: bool = False


@dataclass
class DeleteStmt:
    index: str
    conds: list[Cond]
    options: dict = field(default_factory=dict)


@dataclass
class UpdateStmt:
    index: str
    values: dict[str, Any]
    conds: list[Cond]
    options: dict[str, Any] = field(default_factory=dict)


@dataclass
class CreateTableStmt:
    name: str
    columns: list[tuple[str, str]]     # (name, type)
    options: dict[str, str] = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class AlterStmt:
    index: str
    op: str                    # "add" | "drop"
    column: str = ""
    coltype: str = ""


@dataclass
class SimpleStmt:
    kind: str                  # "show_tables", "show_meta", "desc", ...
    args: list[Any] = field(default_factory=list)


@dataclass
class SetStmt:
    name: str
    value: Any
    is_global: bool = False


@dataclass
class CallStmt:
    func: str
    args: list[Any]
    named: dict[str, Any] = field(default_factory=dict)


# ---- parser ---------------------------------------------------------------

class SqlParser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = sql_tokenize(sql)
        self.i = 0

    # token helpers
    def peek(self, k=0):
        j = self.i + k
        return self.toks[j][:2] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def at_kw(self, *words) -> bool:
        k, v = self.peek()
        return k == "name" and v.upper() in words

    def eat_kw(self, *words) -> str | None:
        if self.at_kw(*words):
            return self.next()[1].upper()
        return None

    def expect_kw(self, word):
        if not self.eat_kw(word):
            raise SqlParseError(f"expected {word}, got {self.peek()[1]!r}")

    def expect_op(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise SqlParseError(f"expected {op!r}, got {v!r}")

    def name(self) -> str:
        k, v = self.next()
        if k != "name":
            raise SqlParseError(f"expected identifier, got {v!r}")
        return v

    def value(self):
        k, v = self.next()
        if k == "str":
            return _unquote(v)
        if k == "num":
            # integer literals saturate at int64 max like strtoll
            # (test_047: id<2^63 parses as id<2^63-1)
            return float(v) if "." in v else min(int(v), 2**63 - 1)
        if k == "op" and v == "-":
            k2, v2 = self.next()
            if k2 != "num":
                raise SqlParseError("expected number after '-'")
            return -(float(v2) if "." in v2
                     else min(int(v2), 2**63))
        if k == "op" and v == "(":
            if self.peek() == ("op", ")"):
                self.next()
                return []      # () = empty value list (MVA clear)
            vals = [self.value()]
            while self.peek() == ("op", ","):
                self.next()
                vals.append(self.value())
            self.expect_op(")")
            return vals
        if k == "name" and v.upper() in ("TRUE", "FALSE"):
            return 1 if v.upper() == "TRUE" else 0
        if k == "name" and v.upper() == "NULL":
            return None
        raise SqlParseError(f"expected value, got {v!r}")

    # entry
    def parse(self):
        stmts = [self.parse_statement()]
        while self.peek() == ("op", ";"):
            self.next()
            if self.peek()[0] is None:
                break
            stmts.append(self.parse_statement())
        if self.peek()[0] is not None:
            raise SqlParseError(f"unexpected {self.peek()[1]!r}")
        return stmts

    def parse_statement(self):
        k, v = self.peek()
        if k != "name":
            raise SqlParseError(f"expected statement, got {v!r}")
        head = v.upper()
        fn = {
            "SELECT": self.parse_select,
            "INSERT": lambda: self.parse_insert(False),
            "REPLACE": lambda: self.parse_insert(True),
            "DELETE": self.parse_delete,
            "UPDATE": self.parse_update,
            "CREATE": self.parse_create,
            "DROP": self.parse_drop,
            "DESC": self.parse_desc,
            "DESCRIBE": self.parse_desc,
            "SHOW": self.parse_show,
            "SET": self.parse_set,
            "BEGIN": lambda: (self.next(), SimpleStmt("begin"))[1],
            "START": self.parse_start,
            "COMMIT": lambda: (self.next(), SimpleStmt("commit"))[1],
            "ROLLBACK": lambda: (self.next(), SimpleStmt("rollback"))[1],
            "TRUNCATE": self.parse_truncate,
            "OPTIMIZE": self.parse_optimize,
            "FLUSH": self.parse_flush,
            "CALL": self.parse_call,
            "ATTACH": self.parse_attach,
            "EXPLAIN": self.parse_explain,
            "ALTER": self.parse_alter,
            "RELOAD": self.parse_reload,
            "IMPORT": self.parse_import,
            "JOIN": self.parse_join_cluster,
            "DEBUG": self.parse_debug,
        }.get(head)
        if fn is None:
            raise SqlParseError(f"unsupported statement {head}")
        return fn()

    # --- SELECT ---
    def parse_select(self):
        self.expect_kw("SELECT")
        items = [self.parse_select_item()]
        while self.peek() == ("op", ","):
            self.next()
            items.append(self.parse_select_item())

        if not self.at_kw("FROM"):
            # SELECT without FROM (client handshake probes like
            # `select @@version_comment limit 1`): allow a trailing LIMIT
            if self.eat_kw("LIMIT"):
                self.value()
                if self.peek() == ("op", ","):
                    self.next()
                    self.value()
            return SelectStmt(items=items, indexes=[], conds=[])
        self.next()
        indexes = [self.name()]
        while self.peek() == ("op", ","):
            self.next()
            indexes.append(self.name())

        conds: list[Cond] = []
        if self.eat_kw("WHERE"):
            conds = self.parse_conds()

        # index hints: FORCE/IGNORE/USE INDEX (name[, ...]) — accepted and
        # recorded; the planner has no CBO hints to apply them to yet
        # (sphinxql.y:1130 AddIndexHint)
        while self.at_kw("FORCE") or self.at_kw("IGNORE") \
                or self.at_kw("USE"):
            self.next()
            self.expect_kw("INDEX")
            self.expect_op("(")
            self.name()
            while self.peek() == ("op", ","):
                self.next()
                self.name()
            self.expect_op(")")

        st = SelectStmt(items=items, indexes=indexes, conds=conds)

        if self.eat_kw("GROUP"):
            k, v = self.peek()
            if k == "num":
                st.group_n = int(self.next()[1])
            self.expect_kw("BY")
            st.group_by = self.parse_expr_text(stop_kw=(
                "WITHIN", "HAVING", "ORDER", "LIMIT", "OPTION", "FACET"))
        if self.eat_kw("WITHIN"):
            self.expect_kw("GROUP")
            self.expect_kw("ORDER")
            self.expect_kw("BY")
            st.within_order = self.parse_order_list()
        if self.eat_kw("HAVING"):
            col = self.parse_expr_text(stop_op=("=", "!=", "<>", "<", "<=",
                                                ">", ">="))
            k, op = self.next()
            if k != "op":
                raise SqlParseError("bad HAVING")
            st.having = (col.strip(), op, self.value())
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            st.order = self.parse_order_list()
        if self.eat_kw("LIMIT"):
            a = self.value()
            if self.peek() == ("op", ","):
                self.next()
                st.offset, st.limit = int(a), int(self.value())
            else:
                st.limit = int(a)
                if self.eat_kw("OFFSET"):
                    st.offset = int(self.value())
        if self.eat_kw("OPTION"):
            while True:
                n = self.name()
                self.expect_op("=")
                if self.peek()[0] == "op" and self.peek()[1] == "(":
                    # named-value list: field_weights=(title=10, body=3)
                    self.next()
                    d = {}
                    while True:
                        fn_ = self.name()
                        self.expect_op("=")
                        d[fn_] = self.value()
                        if self.peek() == ("op", ","):
                            self.next()
                            continue
                        break
                    self.expect_op(")")
                    st.options[n.lower()] = d
                elif (self.peek()[0] == "name"
                      and self.peek()[1].lower() == "expr"
                      and self.peek(1) == ("op", "(")):
                    # ranker=expr('formula')
                    self.next()
                    self.expect_op("(")
                    k2, v2 = self.next()
                    if k2 != "str":
                        raise SqlParseError("expr() needs a quoted formula")
                    self.expect_op(")")
                    st.options[n.lower()] = ("expr", _unquote(v2))
                else:
                    st.options[n.lower()] = self.value() \
                        if self.peek()[0] in ("num", "str") or \
                        self.peek() == ("op", "-") else self.name()
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
        while self.at_kw("FACET"):
            st.facets.append(self.parse_facet())
        return st

    _EXPR_KWS = {"AND", "OR", "NOT", "BETWEEN", "IN", "IS", "DIV", "MOD"}

    def parse_select_item(self) -> SelectItem:
        start = self.i
        expr = self.parse_expr_text(
            stop_kw=("AS", "FROM", "ORDER", "BY", "LIMIT", "FACET", "WHERE",
                     "GROUP", "OPTION", "HAVING", "WITHIN"),
            stop_comma=True)
        alias = None
        if self.eat_kw("AS"):
            alias = self.name()
        elif self.i - start >= 2:
            # implicit alias without AS: 'count(*) c' — a trailing bare
            # identifier right after a token that completes an expression
            lk, lv = self.toks[self.i - 1][:2]
            pk, pv = self.toks[self.i - 2][:2]
            if (lk == "name" and lv.upper() not in self._EXPR_KWS
                    and (pk in ("num", "str")
                         or (pk == "op" and pv == ")")
                         or (pk == "name"
                             and pv.upper() not in self._EXPR_KWS))):
                alias = lv
                expr = self.sql[self.toks[start][2]:self.toks[self.i - 2][3]]
        expr = expr.strip()
        display = None
        if re.fullmatch(r"`[^`]+`", expr):
            # display names drop backticks for valid identifiers; a
            # digit-leading name displays in its raw `...` form (the
            # select lexer can't token it, so the item renders as typed —
            # golden test_186 `id` vs test_069 `123abc`) while resolution
            # uses the stripped name
            if not re.fullmatch(r"`[A-Za-z_@][^`]*`", expr):
                display = expr
            expr = expr[1:-1]
        return SelectItem(expr, alias, display)

    def parse_expr_text(self, stop_kw=(), stop_op=(), stop_comma=False) -> str:
        """Collect source text until a stop keyword/op at depth 0."""
        start_tok = self.i
        depth = 0
        while True:
            k, v = self.peek()
            if k is None:
                break
            if depth == 0:
                if k == "name" and v.upper() in stop_kw and not (
                        v.upper() == "FACET"
                        and self.peek(1) == ("op", "(")):
                    # FACET( is the facet() sort function inside a facet's
                    # ORDER BY (sphinxql.y sort_by_item), not the clause
                    break
                if k == "op" and v in stop_op:
                    break
                if k == "op" and (v == ";" or (stop_comma and v == ",")):
                    break
                if k == "op" and v == ")":
                    break
            if k == "op" and v == "(":
                depth += 1
            if k == "op" and v == ")":
                depth -= 1
            self.next()
        if self.i == start_tok:
            raise SqlParseError(f"expected expression near {self.peek()[1]!r}")
        s0 = self.toks[start_tok][2]
        s1 = self.toks[self.i - 1][3]
        return self.sql[s0:s1]

    def parse_order_list(self) -> list[tuple[str, bool]]:
        out = []
        while True:
            col = self.parse_expr_text(
                stop_kw=("ASC", "DESC", "LIMIT", "OPTION", "FACET", "WITHIN",
                         "HAVING"),
                stop_comma=True)
            asc = True
            if self.eat_kw("DESC"):
                asc = False
            elif self.eat_kw("ASC"):
                asc = True
            out.append((col.strip(), asc))
            if self.peek() == ("op", ","):
                self.next()
                continue
            break
        return out

    def parse_conds(self) -> list[Cond]:
        """WHERE grammar with boolean combinations (filter tree,
        sphinxql.y where_expr: AND binds tighter than OR, parens group).
        Returns the reference-era flat list: top-level AND members, with
        any OR subtree wrapped as Cond('ortree', value=('or'/'and',
        [children])) whose leaves are plain Conds."""
        tree = self._parse_cond_or()
        out: list[Cond] = []

        # MATCH() applies globally regardless of where it sits in the
        # boolean expression — the reference extracts the FT query and
        # builds the filter tree over the attribute conditions only
        # (golden test_323: match('test') and gid > 72 OR pid < 1101
        # means FT(test) AND (gid>72 OR pid<1101))
        def _lift(node):
            if isinstance(node, Cond):
                if node.kind == "match":
                    out.append(node)
                    return None
                return node
            op, kids = node
            kids = [k2 for k2 in (_lift(k) for k in kids)
                    if k2 is not None]
            if not kids:
                return None
            return kids[0] if len(kids) == 1 else (op, kids)

        def _flat(node):
            if node is None:
                return
            if isinstance(node, Cond):
                out.append(node)
                return
            op, kids = node
            if op == "and":
                for k in kids:
                    _flat(k)
            else:
                out.append(Cond("ortree", value=node))
        _flat(_lift(tree))
        return out

    def _parse_cond_or(self):
        kids = [self._parse_cond_and()]
        while self.eat_kw("OR"):
            kids.append(self._parse_cond_and())
        return kids[0] if len(kids) == 1 else ("or", kids)

    def _parse_cond_and(self):
        kids = [self._parse_cond_prim()]
        while self.eat_kw("AND"):
            kids.append(self._parse_cond_prim())
        return kids[0] if len(kids) == 1 else ("and", kids)

    def _parse_cond_prim(self):
        if self.peek() == ("op", "(") and (
                self.peek(1)[1] or "").upper() != "MATCH":
            # parenthesized boolean group: WHERE (a AND b) OR c — but
            # only when it really parses as a condition group; else
            # backtrack and let parse_cond treat '(' as expression text
            save = self.i
            self.next()
            try:
                sub = self._parse_cond_or()
                self.expect_op(")")
                return sub
            except SqlParseError:
                self.i = save
        return self.parse_cond()

    def parse_cond(self) -> Cond:
        if self.peek() == ("op", "(") and (
                self.peek(1)[1] or "").upper() == "MATCH":
            # parenthesized condition: WHERE (MATCH('...')) — the
            # reference grammar allows bracketed where_items
            self.next()
            c = self.parse_cond()
            self.expect_op(")")
            return c
        if self.at_kw("MATCH"):
            self.next()
            self.expect_op("(")
            k, v = self.next()
            if k != "str":
                raise SqlParseError("MATCH() needs a quoted query string")
            self.expect_op(")")
            return Cond("match", value=_unquote(v))
        attr = self.name()
        if attr.lower() == "weight" and self.peek() == ("op", "(") \
                and self.peek(1) == ("op", ")"):
            self.next(); self.next()
            attr = "weight()"
        if self.peek() == ("op", "("):
            # function-call condition (REGEX(title,'x'), ANY(tags),
            # weight()): collect the call text — these become late
            # expression filters
            depth = 0
            start_tok = self.i
            while True:
                k3, v3 = self.peek()
                if k3 is None:
                    break
                if v3 == "(":
                    depth += 1
                elif v3 == ")":
                    depth -= 1
                    if depth == 0:
                        self.next()
                        break
                self.next()
            s0 = self.toks[start_tok][2]
            s1 = self.toks[self.i - 1][3]
            attr = attr + self.sql[s0:s1]
        if self.eat_kw("IS"):
            neg2 = bool(self.eat_kw("NOT"))
            self.expect_kw("NULL")
            # IS NULL on a json path: equality against null, host-side
            return Cond("isnull", attr=attr, negate=neg2)
        neg = bool(self.eat_kw("NOT"))
        if self.eat_kw("IN"):
            k4, v4 = self.peek()
            if k4 == "name" and v4.startswith("@"):
                # id IN @uservar (value-list user variables)
                self.next()
                return Cond("in", attr=attr, values=[v4], negate=neg)
            self.expect_op("(")
            if self.peek() == ("op", ")"):
                self.next()
                return Cond("in", attr=attr, values=[], negate=neg)
            vals = [self.value()]
            while self.peek() == ("op", ","):
                self.next()
                vals.append(self.value())
            self.expect_op(")")
            return Cond("in", attr=attr, values=vals, negate=neg)
        if self.eat_kw("BETWEEN"):
            lo = self.value()
            self.expect_kw("AND")
            hi = self.value()
            return Cond("between", attr=attr, lo=lo, hi=hi, negate=neg)
        if self.at_kw("ANY", "ALL"):
            # `attr ANY ('v1','v2')` / `attr ALL (...)` — MVA/string-list
            # membership (Filter_MVA ANY/ALL, sphinxfilter.cpp; PQ `tags
            # any`, sphinxpq.cpp)
            _, kw = self.next()
            self.expect_op("(")
            vals = [self.value()]
            while self.peek() == ("op", ","):
                self.next()
                vals.append(self.value())
            self.expect_op(")")
            return Cond(kw.lower(), attr=attr, values=vals, negate=neg)
        if neg:
            raise SqlParseError("expected IN or BETWEEN after NOT")
        k, op = self.peek()
        if k != "op" or op not in ("=", "!=", "<>", "<", "<=", ">", ">="):
            if "(" in attr:
                # bare boolean call: REGEX(...) [AND ...] — nonzero test
                return Cond("cmp", attr=attr, op="!=", value=0)
            raise SqlParseError(f"bad condition operator {op!r}")
        self.next()
        return Cond("cmp", attr=attr, op=op, value=self.value())

    def parse_facet(self) -> FacetStmt:
        self.expect_kw("FACET")
        items = [self.parse_select_item()]
        while self.peek() == ("op", ","):
            self.next()
            items.append(self.parse_select_item())
        by = None
        if self.eat_kw("BY"):
            # BY expr [, expr ...] — multi-attribute facet grouping
            # (sphinxql.y facet_by_items_list)
            by = [self.parse_expr_text(
                stop_kw=("ORDER", "LIMIT", "FACET"),
                stop_comma=True).strip()]
            while self.peek() == ("op", ","):
                self.next()
                by.append(self.parse_expr_text(
                    stop_kw=("ORDER", "LIMIT", "FACET"),
                    stop_comma=True).strip())
        order: list[tuple[str, bool]] = []
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            order = self.parse_order_list()
        offset, limit = 0, 20
        if self.eat_kw("LIMIT"):
            a = self.value()
            if self.peek() == ("op", ","):
                self.next()
                offset, limit = int(a), int(self.value())
            else:
                limit = int(a)
        return FacetStmt(items, by, order, offset, limit)

    # --- writes ---
    def table_ref(self) -> str:
        """Table name, optionally cluster-qualified: `cluster:table`
        (write routing into replication clusters, searchdsql.h)."""
        n = self.name()
        if self.peek() == ("op", ":"):
            self.next()
            return n + ":" + self.name()
        return n

    def parse_insert(self, replace: bool):
        self.next()  # INSERT/REPLACE
        self.expect_kw("INTO")
        index = self.table_ref()
        columns: list[str] = []
        if self.peek() == ("op", "("):
            self.next()
            columns.append(self.name())
            while self.peek() == ("op", ","):
                self.next()
                columns.append(self.name())
            self.expect_op(")")
        self.expect_kw("VALUES")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.value()]
            while self.peek() == ("op", ","):
                self.next()
                row.append(self.value())
            self.expect_op(")")
            rows.append(row)
            if self.peek() == ("op", ","):
                self.next()
                continue
            break
        return InsertStmt(index, columns, rows, replace)

    def parse_delete(self):
        self.expect_kw("DELETE")
        if self.at_kw("CLUSTER"):
            self.next()
            return SimpleStmt("delete_cluster", [self.name()])
        self.expect_kw("FROM")
        index = self.table_ref()
        self.expect_kw("WHERE")
        st = DeleteStmt(index, self.parse_conds())
        if self.eat_kw("OPTION"):
            # DELETE ... OPTION store='@uservar' collects the matched ids
            # into a global uservar instead of deleting (DEBUG SPLIT prep,
            # sphinxrt.cpp; golden test_066)
            while True:
                n = self.name()
                self.expect_op("=")
                st.options[n.lower()] = self.value() \
                    if self.peek()[0] in ("num", "str") else self.name()
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
        return st

    def parse_update(self):
        self.expect_kw("UPDATE")
        index = self.table_ref()
        while self.peek() == ("op", ","):
            # UPDATE t1, t2 SET ... fans out over a table list
            self.next()
            index += "," + self.table_ref()
        self.expect_kw("SET")
        values = {}
        while True:
            n = self.name()
            self.expect_op("=")
            values[n] = self.value()
            if self.peek() == ("op", ","):
                self.next()
                continue
            break
        self.expect_kw("WHERE")
        conds = self.parse_conds()
        options: dict[str, Any] = {}
        if self.eat_kw("OPTION"):
            # UPDATE ... OPTION ignore_nonexistent_columns=1, strict=0
            while True:
                n2 = self.name()
                self.expect_op("=")
                options[n2.lower()] = self.value()
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
        return UpdateStmt(index, values, conds, options)

    # --- DDL / admin ---
    def parse_create(self):
        self.expect_kw("CREATE")
        if self.eat_kw("CLUSTER"):
            name = self.name()
            while self.peek()[0] == "str":   # 'path'/'nodes' options
                self.next()
                if self.peek() == ("op", ","):
                    self.next()
            return SimpleStmt("create_cluster", [name])
        if self.eat_kw("FUNCTION"):
            name = self.name()
            self.expect_kw("RETURNS")
            self.name()  # return type (informational)
            self.expect_kw("SONAME")
            k, v = self.next()
            if k != "str":
                raise SqlParseError("SONAME needs a quoted string")
            return SimpleStmt("create_function", [name, _unquote(v)])
        if self.eat_kw("PLUGIN"):
            name = self.name()
            self.expect_kw("TYPE")
            ptype = self.value()
            self.expect_kw("SONAME")
            k, v = self.next()
            return SimpleStmt("create_plugin", [name, ptype, _unquote(v)])
        self.expect_kw("TABLE")
        ine = False
        if self.eat_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            ine = True
        name = self.name()
        cols: list[tuple[str, str]] = []
        stored_cols: list[str] = []
        if self.peek() == ("op", "("):
            self.next()
            while True:
                cn = self.name()
                k, v = self.peek()
                ct = "text"
                if k != "name":
                    stored_cols.append(cn)   # bare col = stored text
                if k == "name":
                    ct = self.name().lower()
                    # col options: 'indexed stored attribute' — STORED
                    # puts the field into the docstore result schema;
                    # a bare `text` column with NO options defaults to
                    # indexed+stored (CREATE TABLE DDL, searchdddl.cpp)
                    had_opts = False
                    while self.at_kw("INDEXED", "STORED", "ATTRIBUTE"):
                        had_opts = True
                        if self.at_kw("STORED"):
                            stored_cols.append(cn)
                        self.next()
                    if ct == "text" and not had_opts:
                        stored_cols.append(cn)
                cols.append((cn, ct))
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
            self.expect_op(")")
        options = {}
        while self.peek()[0] == "name":
            n = self.name().lower()
            self.expect_op("=")
            v = str(self.value())
            if n in ("local", "agent", "agent_blackhole"):
                # repeatable keys (distributed tables: local='a' local='b'
                # agent='h:p:t|h2:p2:t' — DistributedIndex_t config syntax)
                options.setdefault(n, []).append(v)
            else:
                options[n] = v
        if stored_cols and "stored_fields" not in options:
            options["stored_fields"] = ",".join(stored_cols)
        return CreateTableStmt(name, cols, options, ine)

    def parse_drop(self):
        self.expect_kw("DROP")
        if self.eat_kw("FUNCTION"):
            return SimpleStmt("drop_function", [self.name()])
        if self.eat_kw("PLUGIN"):
            return SimpleStmt("drop_plugin", [self.name()])
        self.expect_kw("TABLE")
        if_exists = False
        if self.eat_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        return SimpleStmt("drop_table", [self.name(), if_exists])

    def parse_desc(self):
        self.next()
        name = self.name()
        # DESC pq_idx TABLE: show a percolate table's document schema
        # instead of the stored-query schema (searchd.cpp:11205-11212)
        if self.eat_kw("TABLE"):
            return SimpleStmt("desc", [name, "table"])
        return SimpleStmt("desc", [name])

    def parse_show(self):
        self.expect_kw("SHOW")
        if self.eat_kw("TABLES"):
            return SimpleStmt("show_tables")
        if self.eat_kw("META"):
            like = None
            if self.eat_kw("LIKE"):
                k, v = self.next()
                if k != "str":
                    raise SqlParseError("LIKE needs a quoted pattern")
                like = _unquote(v)
            return SimpleStmt("show_meta", [like] if like else [])
        if self.eat_kw("WARNINGS"):
            return SimpleStmt("show_warnings")
        if self.eat_kw("STATUS"):
            like = None
            if self.eat_kw("LIKE"):
                k, v = self.next()
                if k != "str":
                    raise SqlParseError("LIKE needs a quoted pattern")
                like = _unquote(v)
            return SimpleStmt("show_status", [like] if like else [])
        if self.eat_kw("VARIABLES"):
            like = None
            if self.eat_kw("LIKE"):
                k2, v2 = self.next()
                like = _unquote(v2) if k2 == "str" else v2
            return SimpleStmt("show_variables", [like] if like else [])
        if self.eat_kw("VERSION"):
            return SimpleStmt("show_version")
        if self.eat_kw("PROFILE"):
            return SimpleStmt("show_profile")
        if self.eat_kw("PLAN"):
            return SimpleStmt("show_plan")
        if self.eat_kw("PLUGINS"):
            return SimpleStmt("show_plugins")
        if self.eat_kw("THREADS"):
            return SimpleStmt("show_threads")
        if self.eat_kw("AGENT"):
            self.eat_kw("STATUS")
            return SimpleStmt("show_agent_status")
        if self.eat_kw("CREATE"):
            self.expect_kw("TABLE")
            return SimpleStmt("show_create_table", [self.name()])
        if self.eat_kw("INDEX", "TABLE"):
            n = self.name()
            self.expect_kw("STATUS")
            return SimpleStmt("show_index_status", [n])
        if self.eat_kw("DATABASES"):
            return SimpleStmt("show_databases")
        if self.eat_kw("COLLATION"):
            return SimpleStmt("show_collation")
        if self.eat_kw("SESSION", "GLOBAL"):
            self.expect_kw("VARIABLES")
            like = None
            if self.eat_kw("LIKE"):
                k2, v2 = self.next()
                like = _unquote(v2) if k2 == "str" else v2
            return SimpleStmt("show_variables", [like])
        if self.eat_kw("CHARACTER"):
            self.expect_kw("SET")
            return SimpleStmt("show_charset")
        raise SqlParseError(f"unsupported SHOW {self.peek()[1]!r}")

    def parse_set(self):
        self.expect_kw("SET")
        if self.eat_kw("INDEX"):
            # SET INDEX <name> GLOBAL @var = (...): per-index uservar
            # (SetIndexUservar) — the master PUSHES the variable to that
            # index's agents, so agent parts can resolve it (unlike plain
            # SET GLOBAL uservars — golden test_039)
            self.name()
            self.expect_kw("GLOBAL")
            name = self.name()
            self.expect_op("=")
            self.expect_op("(")
            vals = [self.value()]
            while self.peek() == ("op", ","):
                self.next()
                vals.append(self.value())
            self.expect_op(")")
            st2 = SetStmt(name.lower(), vals, True)
            st2.pushed_to_agents = True
            return st2
        is_global = bool(self.eat_kw("GLOBAL"))
        if self.eat_kw("NAMES"):
            self.value() if self.peek()[0] in ("str", "num") else self.name()
            return SimpleStmt("set_names")
        if self.eat_kw("CHARACTER"):
            self.expect_kw("SET")
            self.value() if self.peek()[0] in ("str", "num") else self.name()
            return SimpleStmt("set_names")
        if self.eat_kw("AUTOCOMMIT"):
            self.expect_op("=")
            return SetStmt("autocommit", self.value(), is_global)
        name = self.name()
        self.expect_op("=")
        k, v = self.peek()
        if k == "op" and v == "(":
            # SET GLOBAL @uservar = (v1, v2, ...) — value-list user
            # variables (UservarIntSet_c, searchd.cpp HandleMysqlSet)
            self.next()
            vals = [self.value()]
            while self.peek() == ("op", ","):
                self.next()
                vals.append(self.value())
            self.expect_op(")")
            return SetStmt(name.lower(), vals, is_global)
        if k == "name":
            val = self.name()
        else:
            val = self.value()
        return SetStmt(name.lower(), val, is_global)

    def parse_start(self):
        self.expect_kw("START")
        self.expect_kw("TRANSACTION")
        return SimpleStmt("begin")

    def parse_join_cluster(self):
        # JOIN CLUSTER name AT 'host:port' (searchdreplication.cpp JOIN)
        self.expect_kw("JOIN")
        self.expect_kw("CLUSTER")
        name = self.name()
        addr = ""
        if self.eat_kw("AT"):
            k, v = self.next()
            if k != "str":
                raise SqlParseError("JOIN CLUSTER ... AT needs 'host:port'")
            addr = _unquote(v)
        return SimpleStmt("join_cluster", [name, addr])

    def parse_truncate(self):
        self.expect_kw("TRUNCATE")
        self.eat_kw("RTINDEX", "TABLE")
        st = SimpleStmt("truncate", [self.table_ref()])
        if self.eat_kw("WITH"):
            self.expect_kw("RECONFIGURE")
        return st

    def parse_optimize(self):
        self.expect_kw("OPTIMIZE")
        self.eat_kw("INDEX", "TABLE")
        return SimpleStmt("optimize", [self.name()])

    def parse_flush(self):
        self.expect_kw("FLUSH")
        if self.eat_kw("RAMCHUNK"):
            # FLUSH RAMCHUNK seals the RAM segments into a disk chunk
            # (distinct from FLUSH RTINDEX's checkpoint; sphinxrt.cpp)
            return SimpleStmt("flush_ramchunk", [self.name()])
        if self.eat_kw("RTINDEX", "TABLE"):
            return SimpleStmt("flush", [self.name()])
        if self.eat_kw("ATTRIBUTES"):
            return SimpleStmt("flush_attributes")
        if self.eat_kw("LOGS"):
            return SimpleStmt("flush_logs")
        if self.eat_kw("HOSTNAMES"):
            return SimpleStmt("flush_hostnames")
        raise SqlParseError("unsupported FLUSH")

    def parse_debug(self):
        """DEBUG <subcommand> (HandleMysqlDebug, searchd.cpp): SPLIT and
        MERGE drive explicit RT disk-chunk surgery (golden test_066);
        other subcommands are accepted as no-ops."""
        self.expect_kw("DEBUG")
        sub = (self.name() if self.peek()[0] == "name" else "").lower()

        def _skip_rest():
            while self.peek()[0] is not None \
                    and self.peek() != ("op", ";"):
                self.next()

        if sub == "split":
            tbl = self.name()
            cid = int(self.next()[1])
            self.expect_kw("ON")
            var = self.name()
            _skip_rest()
            return SimpleStmt("debug_split", [tbl, cid, var])
        if sub == "merge":
            tbl = self.name()
            a = int(self.next()[1])
            b = int(self.next()[1])
            _skip_rest()
            return SimpleStmt("debug_merge", [tbl, a, b])
        _skip_rest()
        return SimpleStmt("debug", [sub])

    def parse_call(self):
        self.expect_kw("CALL")
        func = self.name().upper()
        self.expect_op("(")
        args = []
        named = {}

        def one_arg():
            v = self.value()
            if self.eat_kw("AS"):
                named[self.name().lower()] = v
            else:
                args.append(v)

        if self.peek() != ("op", ")"):
            one_arg()
            while self.peek() == ("op", ","):
                self.next()
                one_arg()
        self.expect_op(")")
        return CallStmt(func, args, named)

    def parse_reload(self):
        # RELOAD TABLES (SIGHUP rotation pickup) | RELOAD TABLE t FROM 'p'
        self.expect_kw("RELOAD")
        if self.eat_kw("TABLES", "INDEXES"):
            return SimpleStmt("reload_tables")
        if self.eat_kw("TABLE", "INDEX"):
            name = self.name()
            self.expect_kw("FROM")
            return SimpleStmt("reload_table", [name, str(self.value())])
        raise SqlParseError("unsupported RELOAD")

    def parse_import(self):
        # IMPORT TABLE name FROM 'path' (manticore import of a saved index)
        self.expect_kw("IMPORT")
        self.expect_kw("TABLE")
        name = self.name()
        self.expect_kw("FROM")
        return SimpleStmt("import_table", [name, str(self.value())])

    def parse_attach(self):
        self.expect_kw("ATTACH")
        self.eat_kw("INDEX", "TABLE")
        # source: an index path (quoted) or a bare name
        src = self.value() if self.peek()[0] == "str" else self.name()
        self.expect_kw("TO")
        self.eat_kw("RTINDEX", "TABLE")
        dst = self.name()
        truncate = False
        if self.eat_kw("WITH"):
            # ATTACH ... WITH TRUNCATE empties the destination RT index
            # first (searchdsql grammar, sphinxrt.cpp AttachDiskIndex)
            self.expect_kw("TRUNCATE")
            truncate = True
        return SimpleStmt("attach", [str(src), dst,
                                     "truncate" if truncate else ""])

    def parse_alter(self):
        # ALTER TABLE t ADD COLUMN c <type> | ALTER TABLE t DROP COLUMN c
        # (AlterSchemaAdd_c / searchdddl.cpp grammar shape)
        self.expect_kw("ALTER")
        if self.at_kw("CLUSTER"):
            self.next()
            cname = self.name()
            if self.eat_kw("ADD"):
                return SimpleStmt("cluster_add", [cname, self.name()])
            if self.eat_kw("DROP"):
                return SimpleStmt("cluster_drop", [cname, self.name()])
            raise SqlParseError("expected ADD or DROP after ALTER CLUSTER")
        self.eat_kw("TABLE", "RTINDEX", "INDEX")
        idx = self.name()
        op = self.eat_kw("ADD", "DROP")
        if op is None:
            raise SqlParseError("expected ADD or DROP after ALTER TABLE")
        self.eat_kw("COLUMN")
        col = self.name()
        coltype = ""
        if op == "ADD":
            coltype = self.name().lower()
        return AlterStmt(idx, op.lower(), col, coltype)

    def parse_explain(self):
        self.expect_kw("EXPLAIN")
        self.eat_kw("QUERY")
        idx = self.name()
        k, v = self.next()
        if k != "str":
            raise SqlParseError("EXPLAIN QUERY needs a quoted query")
        return SimpleStmt("explain", [idx, _unquote(v)])


def split_statements(sql: str) -> list[str]:
    """Split a multi-statement batch on top-level ';' (outside quotes,
    backticks and comments) — the reference daemon executes each statement
    of a batch independently, so a lexer error in one statement still lets
    the rest run (golden test_069: BAD_NUMERIC mid-batch)."""
    out = []
    cur = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c in "'\"`":
            q = c
            cur.append(c)
            i += 1
            while i < n:
                cur.append(sql[i])
                if sql[i] == "\\" and q != "`" and i + 1 < n:
                    cur.append(sql[i + 1])
                    i += 2
                    continue
                if sql[i] == q:
                    i += 1
                    break
                i += 1
            continue
        if c == ";":
            out.append("".join(cur))
            cur = []
            i += 1
            continue
        cur.append(c)
        i += 1
    out.append("".join(cur))
    return [s for s in (x.strip() for x in out) if s]


def parse_sql(sql: str):
    return SqlParser(sql).parse()
