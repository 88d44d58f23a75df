"""Expression engine: parse SphinxQL expressions -> hashable tree ->
evaluation over attribute columns.

The port's counterpart of ``manticoresearch_tpu/query/expr.py``, in two
halves:
- the host half (tokenizer, ``ExprParser``, ``parse_expr``, ``expr_attrs``,
  ``eval_expr_host`` and its helpers, ``infer_is_float``) is that module's
  code as it is, its imports pointing inside the port;
- the device half (``eval_expr``, ``_call``) is rewritten on torch tensors
  and gives the JAX package's values: the same result types, int32
  wrapping, XLA's saturating float -> int32 casts and its integer division
  by zero, floor division in the date functions, FIBONACCI wrapping at
  uint32. The transcendental functions (SIN, COS, EXP, LN, LOG2, LOG10,
  POW, ATAN2 and GEODIST) use another libm than XLA's and may differ in
  the last bits.

Trees are nested tuples (hashable) so they can key plan caches:
    ("num", 2.5) ("attr", "price") ("weight",) ("id",)
    ("neg", x) ("add"|"sub"|"mul"|"div"|"mod", a, b)
    ("cmp_eq"|"cmp_ne"|"cmp_lt"|"cmp_le"|"cmp_gt"|"cmp_ge", a, b)
    ("and", a, b) ("or", a, b) ("not", a)
    ("call", NAME, (args...))
"""
from __future__ import annotations

import math
import re
import time

import torch


class ExprError(ValueError):
    pass


_TOK = re.compile(r"""
    (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<bname>`[^`]+`)
  | (?P<name>[A-Za-z_@][A-Za-z_0-9@.]*(?:\[(?:\d+|'[^']*')\][A-Za-z_0-9@.]*)*)
  | (?P<str>'(?:[^'\\]|\\.)*')
  | (?P<op><=|>=|<>|!=|==|=|<|>|\+|-|\*|/|%|&|\||\^|\(|\)|,|\{|\})
  | (?P<ws>\s+)
""", re.VERBOSE)

_FUNCS_1 = {"ABS", "CEIL", "FLOOR", "SIN", "COS", "LN", "LOG2", "LOG10",
            "EXP", "SQRT", "BIGINT", "SINT", "INTEGER", "DOUBLE", "UINT",
            "CRC32", "FIBONACCI", "DAY", "MONTH", "YEAR", "YEARMONTH",
            "YEARMONTHDAY", "WEEK", "HOUR", "MINUTE", "SECOND", "LENGTH",
            "TO_STRING"}
_FUNCS_N = {"MIN", "MAX", "POW", "IDIV", "IF", "IN", "INTERVAL", "GEODIST",
            "BITDOT", "MADD", "MUL3", "SUM", "TOP", "BM25A", "BM25F",
            "MAX_WINDOW_HITS",
            # sphinxexpr.cpp:3548-3631 tail (round-2 breadth)
            "NOW", "ATAN2", "RAND", "REMAP", "EXIST", "CONCAT", "LEAST",
            "GREATEST", "SUBSTRING_INDEX", "REGEX", "LEVENSHTEIN",
            "POLY2D", "GEOPOLY2D", "CONTAINS", "TIMEDIFF", "CURTIME",
            "UTC_TIME", "UTC_TIMESTAMP", "CURRENT_USER", "CONNECTION_ID",
            "LAST_INSERT_ID", "ALL", "ANY", "INDEXOF", "QUERY",
            "MIN_TOP_WEIGHT", "MIN_TOP_SORTVAL"}
KNOWN_FUNCS = _FUNCS_1 | _FUNCS_N
# FOR-iterator heads: ANY(x > 3 FOR x IN j.arr) (Expr_JsonFieldAggr)
_ITER_FUNCS = {"ALL", "ANY", "INDEXOF"}


def tokenize(s: str) -> list[tuple[str, str]]:
    out = []
    i = 0
    while i < len(s):
        m = _TOK.match(s, i)
        if not m:
            raise ExprError(f"bad char {s[i]!r} in expression")
        i = m.end()
        kind = m.lastgroup
        if kind == "bname":
            inner = m.group()[1:-1]
            if inner[:1].isdigit():
                # the reference expr lexer can't reference digit-leading
                # identifiers ("unexpected BAD_NUMERIC")
                raise ExprError(
                    f"syntax error, unexpected BAD_NUMERIC near "
                    f"{inner!r}")
            out.append(("name", inner))
        elif kind == "name" and "[" in m.group():
            # JSON subscripts normalize to dotted path segments:
            # j.parent[0] -> j.parent.0, j['key'] -> j.key
            t = re.sub(r"\['([^']*)'\]", r".\1", m.group())
            t = re.sub(r"\[(\d+)\]", r".\1", t)
            out.append(("name", t))
        elif kind != "ws":
            out.append((kind, m.group()))
    return out


class ExprParser:
    """Pratt parser with SQL-ish precedence: OR < AND < NOT < cmp < add < mul."""

    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, text):
        k, v = self.next()
        if v != text:
            raise ExprError(f"expected {text!r}, got {v!r}")

    def parse(self) -> tuple:
        e = self.parse_or()
        if self.i != len(self.toks):
            raise ExprError(f"unexpected {self.peek()[1]!r}")
        return e

    def parse_or(self):
        left = self.parse_and()
        while self.peek() == ("name", "OR") or (
                self.peek()[0] == "name" and self.peek()[1].upper() == "OR"):
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.peek()[0] == "name" and self.peek()[1].upper() == "AND":
            self.next()
            left = ("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.peek()[0] == "name" and self.peek()[1].upper() == "NOT":
            self.next()
            return ("not", self.parse_not())
        return self.parse_bitor()

    def parse_bitor(self):
        # bitwise ops sit between AND and the comparisons
        # (sphinxexpr.y precedence: OR < AND < '|' < '&' < '=')
        left = self.parse_bitand()
        while self.peek() == ("op", "|"):
            self.next()
            left = ("bitor", left, self.parse_bitand())
        return left

    def parse_bitand(self):
        left = self.parse_cmp()
        while self.peek() == ("op", "&"):
            self.next()
            left = ("bitand", left, self.parse_cmp())
        return left

    _CMP = {"=": "cmp_eq", "==": "cmp_eq", "<>": "cmp_ne", "!=": "cmp_ne",
            "<": "cmp_lt",
            "<=": "cmp_le", ">": "cmp_gt", ">=": "cmp_ge"}

    def parse_cmp(self):
        left = self.parse_add()
        k, v = self.peek()
        if k == "op" and v in self._CMP:
            self.next()
            return (self._CMP[v], left, self.parse_add())
        if k == "name" and v.upper() == "IN" \
                and self.toks[self.i + 1:self.i + 2] == [("op", "(")]:
            # postfix set test: expr IN (v1, v2, ...) == IN(expr, v1...)
            self.next()
            self.next()
            args = [left]
            while True:
                args.append(self.parse_add())
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
            self.expect(")")
            return ("call", "IN", tuple(args))
        if k == "name" and v.upper() == "BETWEEN":
            self.next()
            lo = self.parse_add()
            if not (self.peek()[0] == "name" and self.peek()[1].upper() == "AND"):
                raise ExprError("BETWEEN needs AND")
            self.next()
            hi = self.parse_add()
            return ("and", ("cmp_ge", left, lo), ("cmp_le", left, hi))
        if k == "name" and v.upper() == "IS":
            # IS [NOT] NULL (TOKH_IS/TOKH_NULL; JSON fields only)
            self.next()
            neg = False
            if self.peek()[0] == "name" and self.peek()[1].upper() == "NOT":
                self.next()
                neg = True
            nk, nv = self.next()
            if nk != "name" or nv.upper() != "NULL":
                raise ExprError("expected NULL after IS")
            t = ("isnull", left)
            return ("not", t) if neg else t
        return left

    def parse_add(self):
        left = self.parse_mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                left = ("add" if v == "+" else "sub", left, self.parse_mul())
            else:
                return left

    def parse_mul(self):
        left = self.parse_unary()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                op = {"*": "mul", "/": "div", "%": "mod"}[v]
                left = (op, left, self.parse_unary())
            elif k == "name" and v.lower() == "div":
                # a DIV b: integer division truncating toward zero
                # (Expr_Idiv_c, sphinxexpr.cpp)
                self.next()
                left = ("idiv", left, self.parse_unary())
            elif k == "name" and v.lower() == "mod":
                self.next()
                left = ("mod", left, self.parse_unary())
            else:
                return left

    def parse_unary(self):
        k, v = self.peek()
        if k == "op" and v == "-":
            self.next()
            return ("neg", self.parse_unary())
        if k == "op" and v == "+":
            self.next()
            return self.parse_unary()
        return self.parse_atom()

    def parse_atom(self):
        k, v = self.next()
        if k == "num":
            return ("num", float(v))
        if k == "str":
            # C-style escapes in string literals (\t \n \r \0 \' \\ —
            # sphinxql string unescape); other \x keep the char
            body = v[1:-1]
            _esc = {"t": "\t", "n": "\n", "r": "\r", "0": "\0"}
            return ("str", re.sub(r"\\(.)",
                                  lambda m2: _esc.get(m2.group(1),
                                                      m2.group(1)),
                                  body))
        if k == "op" and v == "{":
            # {field=weight, ...} map argument (bm25f)
            pairs = []
            while True:
                nk, nv = self.next()
                if nk != "name":
                    raise ExprError("expected field name in {...} map")
                self.expect("=")
                vk, vv = self.next()
                if vk == "num":
                    pairs.append((nv, float(vv)))
                elif vk == "name":   # named option: {in=radians}
                    pairs.append((nv, vv.lower()))
                else:
                    raise ExprError("expected value in {...} map")
                if self.peek() == ("op", ","):
                    self.next()
                    continue
                break
            self.expect("}")
            return ("fieldmap", tuple(pairs))
        if k == "op" and v == "(":
            e = self.parse_or()
            if self.peek() == ("op", ","):
                # (a, b, ...) tuple literal (REMAP value lists)
                items = [e]
                while self.peek() == ("op", ","):
                    self.next()
                    items.append(self.parse_or())
                self.expect(")")
                return ("tuple", tuple(items))
            self.expect(")")
            return e
        if k == "name":
            up = v.upper()
            if self.peek() == ("op", "("):
                self.next()
                if up in _ITER_FUNCS and self.peek() != ("op", ")"):
                    # ALL/ANY/INDEXOF(body FOR var IN container)
                    # (ExprParser FOR-iterator, sphinxexpr.cpp TOKH_FOR)
                    save = self.i
                    body = self.parse_or()
                    if (self.peek()[0] == "name"
                            and self.peek()[1].upper() == "FOR"):
                        self.next()
                        vk, var = self.next()
                        if vk != "name":
                            raise ExprError("expected variable after FOR")
                        if not (self.peek()[0] == "name"
                                and self.peek()[1].upper() == "IN"):
                            raise ExprError("expected IN in FOR iterator")
                        self.next()
                        cont = self.parse_or()
                        self.expect(")")
                        return ("foriter", up, var, body, cont)
                    self.i = save  # plain arg list (e.g. ANY(mva_attr))
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse_or())
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse_or())
                self.expect(")")
                if up == "WEIGHT":
                    return ("weight",)
                if up not in KNOWN_FUNCS:
                    from ..plugins import get_udf
                    if get_udf(up) is None:
                        raise ExprError(f"unknown function {v}()")
                return ("call", up, tuple(args))
            if up in ("WEIGHT", "@WEIGHT"):
                return ("weight",)
            if v == "@weight":
                return ("weight",)
            if v in ("id", "@id"):
                return ("id",)
            return ("attr", v)
        raise ExprError(f"unexpected token {v!r}")


def parse_expr(text: str) -> tuple:
    return ExprParser(text).parse()


def expr_attrs(tree: tuple) -> set[str]:
    op = tree[0]
    if op == "attr":
        return {tree[1]}
    if op in ("num", "weight", "id", "str"):
        return set()
    if op == "foriter":
        # the loop variable is bound, not an attribute
        return ((expr_attrs(tree[3]) - {tree[2]}) | expr_attrs(tree[4]))
    if op == "call":
        out: set[str] = set()
        for a in tree[2]:
            out |= expr_attrs(a)
        return out
    out = set()
    for child in tree[1:]:
        if isinstance(child, tuple):
            out |= expr_attrs(child)
    return out


# --------------------------------------------------------------------------
# device half: eval_expr / _call on torch tensors
# --------------------------------------------------------------------------
# The JAX package evaluates these with jnp under jit. Its numbers are int32
# and float32 (x64 is off), its constants typed 0-d arrays, and torch's
# promotion of 0-d tensors gives the same result types: int32 with float32
# is float32. Integer arithmetic runs in int64 and wraps to int32 (XLA's
# int32 ops wrap); float -> int32 casts saturate with NaN -> 0, as XLA's
# convert does on the CPU; division and remainder by an integer zero give
# XLA's values (x / 0 = -1, x % 0 = x inside jnp's formulas).
_I32 = 2**32


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32, two's complement."""
    return ((x + 2**31) % _I32 - 2**31).to(torch.int32)


def _is_int(x: torch.Tensor) -> bool:
    return not x.is_floating_point()


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """``astype(int32)``: integers wrap; floats truncate toward zero and
    saturate at the int32 range, NaN -> 0."""
    if _is_int(x):
        return x.to(torch.int32) if x.dtype != torch.int64 else _wrap(x)
    d = x.to(torch.float64).clamp(-(2**31), 2**31 - 1)
    return torch.where(torch.isnan(d), 0.0, d).trunc().to(torch.int32)


def _to_uint32(x: torch.Tensor) -> torch.Tensor:
    """``astype(uint32)`` as int64 in [0, 2^32): integers wrap; floats
    truncate and saturate at [0, 2^32 - 1], NaN -> 0."""
    if _is_int(x):
        return x.to(torch.int64) & 0xFFFFFFFF
    d = x.to(torch.float64).clamp(0, _I32 - 1)
    return torch.where(torch.isnan(d), 0.0, d).trunc().to(torch.int64)


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * y mod 2^32 for int64 values in [0, 2^32), split so that no
    product passes 2^48."""
    return (x * (y & 0xFFFF) + (((x * (y >> 16)) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF


def _arith(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, a - b or a * b with int32 wrap."""
    if _is_int(a) and _is_int(b):
        return _wrap(op(a.to(torch.int64), b.to(torch.int64)))
    return op(a, b)


def _trunc_div_i64(a: torch.Tensor, b: torch.Tensor):
    """XLA's integer div and rem (C truncation; x / 0 = -1, x % 0 = x),
    in int64."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    bz = b == 0
    bs = torch.where(bz, 1, b)
    q = torch.div(a, bs, rounding_mode="trunc")
    return torch.where(bz, -1, q), torch.where(bz, a, a - q * bs)


def _floordiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.floor_divide: the integer formula over XLA's div and rem (so
    x // 0 is -2 for x != 0, -1 for 0); floats through jnp's divmod."""
    if _is_int(a) and _is_int(b):
        q, r = _trunc_div_i64(a, b)
        a64, b64 = a.to(torch.int64), b.to(torch.int64)
        fix = (torch.sign(a64) != torch.sign(b64)) & (r != 0)
        return _wrap(torch.where(fix, q - 1, q))
    a, b = _promote(a, b)
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    fix = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    div = torch.where(fix, div - 1, div)
    # lax.round: half away from zero
    t = div.trunc()
    return torch.where((div - t).abs() >= 0.5, t + torch.sign(div), t)


def _remainder(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.remainder: sign of the divisor; an integer divisor of 0 is
    replaced by 1 (so x % 0 == 0)."""
    if _is_int(a) and _is_int(b):
        b64 = b.to(torch.int64)
        bs = torch.where(b64 == 0, 1, b64)
        r = _trunc_div_i64(a, bs)[1]
        plus = (r != 0) & ((r < 0) != (bs < 0))
        return _wrap(torch.where(plus, r + bs, r))
    a, b = _promote(a, b)
    r = torch.fmod(a, b)
    plus = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(plus, r + b, r)


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _device(attrs, weight) -> torch.device:
    dev = getattr(attrs, "device", None)
    if dev is not None:
        return dev
    for v in attrs.values():
        return v.device
    return weight.device if weight is not None else torch.device("cpu")


def eval_expr(tree: tuple, attrs, weight=None, doc_ids=None):
    """Evaluate on the attrs' device: returns a tensor broadcast over rows
    (or 0-d for constant expressions). ``attrs`` maps attribute names to
    per-row tensors (any Mapping; a ``device`` attribute, where present,
    places the constants)."""
    op = tree[0]
    if op == "tuple":
        return tuple(eval_expr(t, attrs, weight, doc_ids) for t in tree[1])
    if op in ("isnull", "foriter", "str"):
        raise ExprError(
            f"{op} expressions run host-side only (final-stage calc)")
    if op == "num":
        v = tree[1]
        dev = _device(attrs, weight)
        if float(v).is_integer() and abs(v) < 2**31:
            return torch.tensor(int(v), dtype=torch.int32, device=dev)
        return torch.tensor(v, dtype=torch.float32, device=dev)
    if op == "attr":
        if tree[1] not in attrs:
            # schema names are case-insensitive (reference sphToLower)
            low = tree[1].lower()
            hit = next((k for k in attrs if k.lower() == low), None)
            if hit is None:
                raise ExprError(
                    f"unknown attribute {tree[1]!r} in expression")
            return attrs[hit]
        return attrs[tree[1]]
    if op == "weight":
        if weight is None:
            raise ExprError("weight() not available in this context")
        return weight
    if op == "id":
        if doc_ids is None:
            raise ExprError("id not available on device in expressions")
        return doc_ids
    if op == "neg":
        a = eval_expr(tree[1], attrs, weight, doc_ids)
        return _wrap(-a.to(torch.int64)) if _is_int(a) else -a
    if op == "not":
        return (eval_expr(tree[1], attrs, weight, doc_ids) == 0).to(
            torch.int32)
    if op in ("add", "sub", "mul", "div", "idiv", "mod", "and", "or",
              "bitand", "bitor",
              "cmp_eq", "cmp_ne", "cmp_lt", "cmp_le", "cmp_gt", "cmp_ge"):
        a = eval_expr(tree[1], attrs, weight, doc_ids)
        b = eval_expr(tree[2], attrs, weight, doc_ids)
        if op == "add":
            return _arith(torch.add, a, b)
        if op == "sub":
            return _arith(torch.sub, a, b)
        if op == "mul":
            return _arith(torch.mul, a, b)
        if op == "div":
            # reference '/' is plain float division (Expr_Div_c)
            return _f32(a) / _f32(b)
        if op == "idiv":
            # a DIV b: C-style truncating division (Expr_Idiv_c)
            if _is_int(a) and _is_int(b):
                q = _trunc_div_i64(a, b)[0]
                return _wrap(q * (b != 0).to(torch.int64))
            return torch.trunc(_f32(a) / _f32(b))
        if op == "mod":
            return _remainder(a, b)
        if op == "bitand":
            return to_int32(a) & to_int32(b)
        if op == "bitor":
            return to_int32(a) | to_int32(b)
        if op == "and":
            return ((a != 0) & (b != 0)).to(torch.int32)
        if op == "or":
            return ((a != 0) | (b != 0)).to(torch.int32)
        table = {"cmp_eq": torch.eq, "cmp_ne": torch.ne, "cmp_lt": torch.lt,
                 "cmp_le": torch.le, "cmp_gt": torch.gt, "cmp_ge": torch.ge}
        return table[op](a, b).to(torch.int32)
    if op == "call":
        name, args = tree[1], tree[2]
        vals = [eval_expr(a, attrs, weight, doc_ids) for a in args]
        return _call(name, vals, args)
    raise ExprError(f"bad expr node {op!r}")


_DATE_FUNCS = ("DAY", "MONTH", "YEAR", "YEARMONTH", "YEARMONTHDAY", "WEEK",
               "HOUR", "MINUTE", "SECOND")


def _call(name: str, vals, raw_args):
    if name == "ABS":
        a = vals[0]
        return _wrap(a.to(torch.int64).abs()) if _is_int(a) else a.abs()
    if name == "CEIL":
        return to_int32(torch.ceil(_f32(vals[0])))
    if name == "FLOOR":
        return to_int32(torch.floor(_f32(vals[0])))
    if name in ("SIN", "COS", "EXP", "SQRT"):
        f = {"SIN": torch.sin, "COS": torch.cos, "EXP": torch.exp,
             "SQRT": torch.sqrt}[name]
        return f(_f32(vals[0]))
    if name == "LN":
        return torch.log(_f32(vals[0]))
    if name == "LOG2":
        return torch.log2(_f32(vals[0]))
    if name == "LOG10":
        return torch.log10(_f32(vals[0]))
    if name in ("BIGINT", "SINT", "INTEGER", "UINT"):
        return to_int32(vals[0])
    if name == "DOUBLE":
        return _f32(vals[0])
    if name == "MIN":
        return torch.minimum(*_promote(vals[0], vals[1]))
    if name == "MAX":
        return torch.maximum(*_promote(vals[0], vals[1]))
    if name == "POW":
        return torch.pow(_f32(vals[0]), _f32(vals[1]))
    if name == "IDIV":
        return to_int32(_floordiv(vals[0], vals[1]))
    if name == "IF":
        return torch.where(vals[0] != 0, *_promote(vals[1], vals[2]))
    if name == "IN":
        # IN(expr, v1, v2, ...) -> 1/0  (Expr_In_c)
        acc = None
        for v in vals[1:]:
            hit = vals[0] == v
            acc = hit if acc is None else (acc | hit)
        return acc.to(torch.int32)
    if name == "INTERVAL":
        # INTERVAL(expr, p1, .., pN): index of largest point <= expr
        # (sphinxexpr Expr_Interval_c semantics: returns 0 if expr < p1)
        acc = torch.zeros_like(vals[0], dtype=torch.int32)
        for v in vals[1:]:
            acc = acc + (vals[0] >= v).to(torch.int32)
        return acc
    if name == "GEODIST":
        # the JAX package's device formula: haversine on a 6371 km sphere
        # (the host path's adaptive formula differs)
        lat1, lon1, lat2, lon2 = [_f32(v) for v in vals]
        dlat = (lat2 - lat1) * 0.5
        dlon = (lon2 - lon1) * 0.5
        s_lat = torch.sin(dlat)
        s_lon = torch.sin(dlon)
        a = (s_lat * s_lat
             + torch.cos(lat1) * torch.cos(lat2) * (s_lon * s_lon))
        return 12742000.0 * torch.asin(torch.sqrt(a))   # 2 * r, exact
    if name == "BITDOT":
        acc = torch.zeros_like(vals[0], dtype=torch.float32)
        for i, v in enumerate(vals[1:]):
            # an arithmetic shift past 31 fills with the sign, as in XLA
            acc = acc + ((vals[0] >> min(i, 31)) & 1) * v
        return acc
    if name == "MADD":
        return _arith(torch.add, _arith(torch.mul, vals[0], vals[1]),
                      vals[2])
    if name == "MUL3":
        return _arith(torch.mul, _arith(torch.mul, vals[0], vals[1]),
                      vals[2])
    if name == "ATAN2":
        return torch.atan2(_f32(vals[0]), _f32(vals[1]))
    if name == "REMAP":
        cond, out = vals[0], vals[1]
        for c, t in zip(vals[2], vals[3]):
            out = torch.where(cond == c, *_promote(t, out))
        return out
    if name == "FIBONACCI":
        # fast doubling over 32 bits, wrapping at uint32 like the
        # reference's unsigned arithmetic (values held in int64)
        m = 0xFFFFFFFF
        n = _to_uint32(vals[0])
        a = torch.zeros_like(n)   # F(k)
        b = torch.ones_like(n)    # F(k+1)
        for i in reversed(range(32)):
            c = _mul32(a, ((b << 1) - a) & m)                # F(2k)
            d = (_mul32(a, a) + _mul32(b, b)) & m            # F(2k+1)
            bit = ((n >> i) & 1) == 1
            a, b = torch.where(bit, d, c), torch.where(bit, (c + d) & m, d)
        return _wrap(a)
    if name in _DATE_FUNCS:
        return _date_part(name, vals[0])
    if name in ("LEAST", "GREATEST"):
        f = torch.minimum if name == "LEAST" else torch.maximum
        acc = vals[0]
        for v in vals[1:]:
            acc = f(*_promote(acc, v))
        return acc
    raise ExprError(f"unimplemented function {name}()")


def _date_part(name: str, v: torch.Tensor) -> torch.Tensor:
    """civil-from-days (Hinnant algorithm) with the process-local UTC
    offset folded in when the expression is evaluated (the reference uses
    localtime_r, sphinxexpr.cpp:3410; DST transitions shift by the one
    constant offset). Floor division throughout, so timestamps before
    1970 split as in the JAX package; no step passes 2^31."""
    ts = _wrap(to_int32(v).to(torch.int64) - time.timezone).to(torch.int64)

    def fdiv(x, d):
        return torch.div(x, d, rounding_mode="floor")
    days = fdiv(ts, 86400)
    secs = torch.remainder(ts, 86400)
    if name == "HOUR":
        return fdiv(secs, 3600).to(torch.int32)
    if name == "MINUTE":
        return fdiv(torch.remainder(secs, 3600), 60).to(torch.int32)
    if name == "SECOND":
        return torch.remainder(secs, 60).to(torch.int32)
    z = days + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524) - fdiv(doe, 146096),
               365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)
    d = doy - fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int64)
    if name == "DAY":
        out = d
    elif name == "MONTH":
        out = m
    elif name == "YEAR":
        out = y
    elif name == "YEARMONTH":
        out = y * 100 + m
    elif name == "WEEK":
        # CSphGrouperWeek key (sphinxsort.cpp:1301): year*1000 +
        # day-of-year of the week's Sunday (base 1), year-adjusted
        wday = torch.remainder(days + 4, 7)   # 1970-01-01 was a Thursday
        yy = y - 1                            # days_from_civil(y, 1, 1)
        era2 = fdiv(yy, 400)
        yoe2 = yy - era2 * 400
        jan1 = (era2 * 146097 + yoe2 * 365 + fdiv(yoe2, 4)
                - fdiv(yoe2, 100) + 306 - 719468)
        yday = days - jan1                    # 0-based
        prev_sun = (1 + yday) - wday
        py = y - 1
        leap_prev = ((torch.remainder(py, 4) == 0)
                     & ((torch.remainder(py, 100) != 0)
                        | (torch.remainder(py, 400) == 0)))
        crossed = prev_sun <= 0
        prev_sun = torch.where(crossed,
                               prev_sun + 365 + leap_prev.to(torch.int64),
                               prev_sun)
        out = torch.where(crossed, py, y) * 1000 + prev_sun
    else:
        out = y * 10000 + m * 100 + d
    return out.to(torch.int32)


def eval_expr_host(tree: tuple, row: dict, weight: int = 0, docid: int = 0):
    """Host-side scalar evaluation over one result row (the reference's
    final-stage calc split, sphinx.cpp:15905 — presentation expressions run
    on the final top-k only)."""
    op = tree[0]
    if op == "str":
        return tree[1]
    if op == "fieldmap":
        return dict(tree[1])     # named-option map ({in=radians,...})
    if op == "tuple":
        return tuple(eval_expr_host(t, row, weight, docid)
                     for t in tree[1])
    if op == "isnull":
        v = eval_expr_host(tree[1], row, weight, docid)
        # empty strings count as NULL (string attrs store "" for
        # missing; golden test_357); a JSON column holding an empty
        # OBJECT is null too, but an empty ARRAY is not (golden
        # test_318: {} -> null, [] -> not null)
        if isinstance(v, str):
            return int(v.strip() in ("", "{}"))
        return int(v is None or v == {})
    if op == "foriter":
        # ALL/ANY/INDEXOF(body FOR var IN container) over a JSON array
        # or MVA list (Expr_JsonFieldAggr semantics)
        kind, var, body, cont = tree[1], tree[2], tree[3], tree[4]
        seq = eval_expr_host(cont, row, weight, docid)
        if seq is None:
            seq = []
        if not isinstance(seq, (list, tuple)):
            seq = [seq]
        results = (eval_expr_host(body, {**row, var: el}, weight, docid)
                   for el in seq)
        if kind == "ALL":
            # ALL() over an empty array is 0, not vacuous truth
            # (Expr_JsonFieldAggr; golden test_396 doc with "a":[])
            if not seq:
                return 0
            return int(all(bool(r) for r in results))
        if kind == "ANY":
            return int(any(bool(r) for r in results))
        for i, r in enumerate(results):   # INDEXOF: first hit or -1
            if r:
                return i
        return -1
    if op == "num":
        v = tree[1]
        return int(v) if float(v).is_integer() else v
    if op == "attr":
        if tree[1] not in row:
            name = tree[1]
            low = name.lower()
            hit = next((k for k in row if k.lower() == low), None)
            if hit is not None:
                return row[hit]
            if "." in name:
                # JSON path access (sphinxjson.cpp sphJsonFindByKey analog)
                base, _, path = name.partition(".")
                if base in row:
                    import json as _json
                    obj = row[base]
                    if isinstance(obj, str):
                        try:
                            obj = _json.loads(obj) if obj.strip() else None
                        except ValueError:
                            obj = None
                    from .planner import json_path_get
                    return json_path_get(obj, path)
            raise ExprError(f"unknown attribute {tree[1]!r}")
        return row[tree[1]]
    if op == "weight":
        return weight
    if op == "id":
        return docid
    if op == "neg":
        return -eval_expr_host(tree[1], row, weight, docid)
    if op == "not":
        return int(eval_expr_host(tree[1], row, weight, docid) == 0)
    if op in ("add", "sub", "mul", "div", "idiv", "mod", "and", "or",
              "bitand", "bitor",
              "cmp_eq", "cmp_ne", "cmp_lt", "cmp_le", "cmp_gt", "cmp_ge"):
        a = eval_expr_host(tree[1], row, weight, docid)
        b = eval_expr_host(tree[2], row, weight, docid)
        if op in ("add", "sub", "mul") and isinstance(a, int) \
                and isinstance(b, int) and not _has_wide_int(tree) \
                and abs(a) < 2**31 and abs(b) < 2**31:
            # int32 arithmetic wraps unless an operand is 64-bit typed
            # (ExprParser widest-type rule: 1000000*1000000 overflows);
            # a 64-bit VALUE (bigint attr) also promotes the whole
            # expression to int64 (golden test_050: n+a over bigint n)
            r0 = {"add": a + b, "sub": a - b, "mul": a * b}[op]
            r0 &= 0xFFFFFFFF
            return r0 - (1 << 32) if r0 >= (1 << 31) else r0
        if op in ("add", "sub", "mul") and isinstance(a, int) \
                and isinstance(b, int):
            # int64 context still wraps at 64 bits (C++ arithmetic;
            # test_050: INT64_MAX + 100 wraps negative)
            r0 = {"add": a + b, "sub": a - b, "mul": a * b}[op]
            r0 &= (1 << 64) - 1
            return r0 - (1 << 64) if r0 >= (1 << 63) else r0
        if a is None or isinstance(a, (list, dict)):
            a = 0   # JSON null/array/object coerce to 0 in numeric context
        if b is None or isinstance(b, (list, dict)):
            b = 0
        if isinstance(a, str) != isinstance(b, str):
            # mixed string/number comparison: numeric if both parse
            try:
                a, b = float(a), float(b)
            except (TypeError, ValueError):
                a, b = str(a), str(b)
        if op == "add":
            return a + b
        if op == "sub":
            return a - b
        if op == "mul":
            return a * b
        if op == "div":
            if b == 0:
                return 0.0   # Expr_Div_c: x/0 evaluates to 0
            return float(a) / float(b)
        if op == "idiv":
            if b == 0:
                return 0
            import math
            q = a / b
            return (int(math.trunc(q))
                    if isinstance(a, int) and isinstance(b, int) else
                    float(math.trunc(q)))
        if op == "mod":
            return a % b
        if op == "bitand":
            return int(a) & int(b)
        if op == "bitor":
            return int(a) | int(b)
        if op == "and":
            return int(bool(a) and bool(b))
        if op == "or":
            return int(bool(a) or bool(b))
        import operator as _o
        if isinstance(a, str) and isinstance(b, str):
            # string comparisons follow the default collation (libc_ci:
            # case-insensitive, CollateLibcCI)
            a, b = a.lower(), b.lower()
        t = {"cmp_eq": _o.eq, "cmp_ne": _o.ne, "cmp_lt": _o.lt,
             "cmp_le": _o.le, "cmp_gt": _o.gt, "cmp_ge": _o.ge}
        return int(t[op](a, b))
    if op == "call":
        name, args = tree[1], tree[2]
        if name == "EXIST":
            # EXIST('attr', default): by-name lookup with a fallback for
            # schema-less multi-index unions (Expr_GetInt_c wrapper).
            # The name is trimmed + case-folded like any attr reference
            # (golden test_163: EXIST(' aTTr2', 11) finds attr2)
            key = args[0][1] if args[0][0] in ("str", "attr") else None
            if key is not None:
                if key in row and row[key] is not None:
                    return row[key]
                k = key.strip().lower()
                if k in row and row[k] is not None:
                    return row[k]
            return eval_expr_host(args[1], row, weight, docid)
        vals = [eval_expr_host(a, row, weight, docid) for a in args]
        if name == "TO_STRING" and args \
                and isinstance(vals[0], (list, dict)) \
                and args[0][0] == "attr" and "." in str(args[0][1]):
            # TO_STRING over a JSON sub-field formats as compact JSON
            # (Expr_ToString_c SPH_ATTR_JSON_FIELD -> sphJsonFieldFormat,
            # sphinxexpr.cpp:1695-1712); MVA args stay comma-joined
            from ..utils.jsonrender import _dump
            return _dump(vals[0])
        if name in ("LEAST", "GREATEST") and len(args) == 1 \
                and isinstance(vals[0], list) \
                and args[0][0] == "attr" and "." not in str(args[0][1]):
            # over a uint/bigint MVA the return type is INTEGER/BIGINT
            # (FUNC_LEAST ret-type fixup, sphinxexpr.cpp:9297), not the
            # float render used for JSON arrays
            nums = [v for v in vals[0]
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)]
            if not nums:
                return None
            return int(min(nums) if name == "LEAST" else max(nums))
        if name == "ABS" and vals and isinstance(vals[0], int) \
            and not _has_wide_int(args[0]) and abs(vals[0]) < 2**31:
            # int32 context: the argument wraps before ABS
            # (ABS(CRC32('test')) = |(int)uCrc|); a 64-bit VALUE keeps
            # the wide int64 path (bigint attrs, golden test_050)
            v = vals[0] & 0xFFFFFFFF
            vals = [v - (1 << 32) if v >= (1 << 31) else v]
        return _call_host(name, vals)
    raise ExprError(f"bad expr node {op!r}")


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=4096)
def _has_wide_int(tree) -> bool:
    """True when an expression subtree mentions a 64-bit integer source
    (id / BIGINT()/SINT() casts) — those widen int arithmetic past the
    int32 wrap (ExprParser_t::GetWidestRet)."""
    if not isinstance(tree, tuple):
        return False
    if tree[0] == "id":
        return True
    if tree[0] == "attr" and str(tree[1]).lower() in ("id", "@id"):
        return True
    if tree[0] == "call" and tree[1] in ("BIGINT", "SINT"):
        return True
    for x in tree[1:]:
        if isinstance(x, tuple):
            # either a subtree (str head) or an args tuple of subtrees
            if x and isinstance(x[0], str):
                if _has_wide_int(x):
                    return True
            elif any(_has_wide_int(y) for y in x
                     if isinstance(y, tuple)):
                return True
        elif isinstance(x, list):
            if any(_has_wide_int(y) for y in x if isinstance(y, tuple)):
                return True
    return False


class _TimeStr(str):
    """Clock-function result: renders as a time string but carries the
    epoch for integer contexts (Expr_Time_c StringEval vs IntEval)."""

    def __new__(cls, s, ival):
        o = str.__new__(cls, s)
        o.ival = ival
        return o


def _call_host(name: str, vals):
    if name in ("ABS", "CEIL", "FLOOR", "SIN", "COS", "EXP", "SQRT",
                "LN", "LOG2", "LOG10", "BIGINT", "SINT", "INTEGER",
                "UINT", "DOUBLE", "MIN", "MAX", "POW", "IDIV") \
            and any(isinstance(v, list) for v in vals):
        # ExprParser_t::CheckForConstSet rejects MVA args to scalar
        # functions ("log10() arguments can not be MVA")
        raise ExprError(f"{name.lower()}() arguments can not be MVA")
    if name == "ABS":
        return abs(vals[0] if vals[0] is not None else 0)
    if name == "CEIL":
        return int(math.ceil(vals[0]))
    if name == "FLOOR":
        return int(math.floor(vals[0]))
    if name in ("SIN", "COS", "EXP", "SQRT"):
        if name == "SQRT" and vals[0] < 0:
            return 0.0   # Expr_Sqrt_c clamps the domain
        return {"SIN": math.sin, "COS": math.cos, "EXP": math.exp,
                "SQRT": math.sqrt}[name](vals[0])
    # log functions clamp non-positive args to 0.0 (Expr_Ln_c etc.
    # return 0 on domain errors rather than NaN/-inf)
    if name == "LN":
        return math.log(vals[0]) if vals[0] > 0 else 0.0
    if name == "LOG2":
        return math.log2(vals[0]) if vals[0] > 0 else 0.0
    if name == "LOG10":
        return math.log10(vals[0]) if vals[0] > 0 else 0.0
    if name in ("BIGINT", "SINT", "INTEGER", "UINT"):
        if isinstance(vals[0], str):
            # strtoll semantics: parse the leading integer, 0 if none
            m2 = re.match(r"\s*[-+]?\d+", vals[0])
            return int(m2.group()) if m2 else 0
        return int(vals[0])
    if name == "DOUBLE":
        return float(vals[0])
    if name == "MIN":
        return min(vals)
    if name == "MAX":
        return max(vals)
    if name == "POW":
        return math.pow(vals[0], vals[1])
    if name == "IDIV":
        return int(vals[0] // vals[1])
    if name == "IF":
        return vals[1] if vals[0] else vals[2]
    if name == "IN":
        # list args (uservars / constant sets) flatten into the value set
        vset: list = []
        for v in vals[1:]:
            vset.extend(v if isinstance(v, list) else [v])
        if isinstance(vals[0], list):
            # IN(mva, v1..vn): true when ANY of the MVA's values is
            # listed (Expr_MVAIn_c semantics)
            return int(any(v in vset for v in vals[0]))
        if isinstance(vals[0], str):
            # string IN compares under the default collation (libc_ci)
            return int(vals[0].lower() in
                       {str(v).lower() for v in vset})
        return int(vals[0] in vset)
    if name == "INTERVAL":
        return sum(1 for v in vals[1:] if vals[0] >= v)
    if name == "GEODIST":
        from ..utils.geodist import (geodist_adaptive_deg,
                                     geodist_adaptive_rad)
        lat1, lon1, lat2, lon2 = (float(v) if v is not None else 0.0
                                  for v in vals[:4])
        opts = vals[4] if len(vals) > 4 and isinstance(vals[4], dict) \
            else {}
        if str(opts.get("in", "radians")).startswith("deg"):
            d = geodist_adaptive_deg(lat1, lon1, lat2, lon2)
        else:
            d = geodist_adaptive_rad(lat1, lon1, lat2, lon2)
        out = str(opts.get("out", "meters"))
        scale = {"km": 0.001, "kilometers": 0.001, "mi": 1 / 1609.344,
                 "miles": 1 / 1609.344, "ft": 3.28084,
                 "feet": 3.28084, "yd": 1.0936133, "yards": 1.0936133,
                 "in": 39.37, "inch": 39.37, "cm": 100.0,
                 "centimeters": 100.0, "mm": 1000.0,
                 "millimeters": 1000.0}.get(out, 1.0)
        import numpy as _np
        return float(_np.float32(d * _np.float32(scale)))
    if name == "BITDOT":
        # BITDOT(mask, v0, v1, ...) = sum of vi for each set bit i
        mask = int(vals[0])
        return sum(v for i, v in enumerate(vals[1:]) if (mask >> i) & 1)
    if name == "MADD":
        return vals[0] * vals[1] + vals[2]
    if name == "MUL3":
        return vals[0] * vals[1] * vals[2]
    if name == "ATAN2":
        return math.atan2(float(vals[0]), float(vals[1]))
    if name == "CRC32":
        import zlib
        # u32 value; int32 contexts (ABS, narrow arithmetic) view it
        # signed via the i32 wrap at the call/op sites
        return zlib.crc32(str(vals[0]).encode("utf-8"))
    if name == "FIBONACCI":
        n = max(0, int(vals[0]))
        a, b = 0, 1
        for _ in range(n):
            a, b = b, (a + b) & 0xFFFFFFFF   # reference wraps at uint32
        return a
    if name in ("DAY", "MONTH", "YEAR", "YEARMONTH", "YEARMONTHDAY",
                "WEEK", "HOUR", "MINUTE", "SECOND"):
        # localtime split like DECLARE_TIMESTAMP (sphinxexpr.cpp:3410-3430)
        s = time.localtime(int(vals[0]))
        if name == "WEEK":
            # CSphGrouperWeek (sphinxsort.cpp:1301); Python tm_yday is
            # 1-based and tm_wday is Monday=0 (C: 0-based / Sunday=0)
            prev_sun = s.tm_yday - ((s.tm_wday + 1) % 7)
            year = s.tm_year
            if prev_sun <= 0:
                prev_sun += 365
                year -= 1
                if year % 4 == 0 and (year % 100 != 0 or year % 400 == 0):
                    prev_sun += 1
            return year * 1000 + prev_sun
        return {"DAY": s.tm_mday, "MONTH": s.tm_mon, "YEAR": s.tm_year,
                "YEARMONTH": s.tm_year * 100 + s.tm_mon,
                "YEARMONTHDAY": (s.tm_year * 10000 + s.tm_mon * 100
                                 + s.tm_mday),
                "HOUR": s.tm_hour, "MINUTE": s.tm_min,
                "SECOND": s.tm_sec}[name]
    if name == "NOW":
        return int(time.time())
    if name == "CURTIME":
        t = time.time()
        return _TimeStr(time.strftime("%H:%M:%S", time.localtime(t)),
                        int(t))
    if name == "UTC_TIME":
        t = time.time()
        return _TimeStr(time.strftime("%H:%M:%S", time.gmtime(t)),
                        int(time.mktime(time.gmtime(t))))
    if name == "UTC_TIMESTAMP":
        t = time.time()
        return _TimeStr(time.strftime("%Y-%m-%d %H:%M:%S",
                                      time.gmtime(t)),
                        int(time.mktime(time.gmtime(t))))
    if name == "TIMEDIFF":
        # TIMEDIFF(ts1, ts2) -> "+-H:MM:SS" like Expr_TimeDiff_c;
        # string args coerce via strtoll (leading digits)
        def _ival(v):
            if isinstance(v, _TimeStr):
                return v.ival    # Expr_Time_c IntEval = epoch seconds
            if isinstance(v, str):
                m2 = re.match(r"\s*[-+]?\d+", v)
                return int(m2.group()) if m2 else 0
            return int(v)
        d = _ival(vals[0]) - _ival(vals[1])
        sign = "-" if d < 0 else ""
        d = abs(d)
        return f"{sign}{d // 3600}:{d % 3600 // 60:02d}:{d % 60:02d}"
    if name == "RAND":
        # Expr_Rand_c: xorshift64* seeded by the argument; non-const
        # args reseed per evaluation so rand(id) is deterministic
        import numpy as _np
        if vals:
            st = int(vals[0]) & ((1 << 64) - 1)
        else:
            import random
            st = random.getrandbits(64)
        st ^= st >> 12
        st = (st ^ (st << 25)) & ((1 << 64) - 1)
        st ^= st >> 27
        st = (st * 2685821657736338717) & ((1 << 64) - 1)
        return float(_np.float32(st / float((1 << 64) - 1)))
    if name == "REMAP":
        # REMAP(cond, target, (c1,..), (t1,..)): target remapped where
        # cond matches a listed value (Expr_Remap_c)
        cond, target, cs, ts = vals[0], vals[1], vals[2], vals[3]
        if not isinstance(cs, (list, tuple)):
            cs = [cs]               # single-element IN-list folds to scalar
        if not isinstance(ts, (list, tuple)):
            ts = [ts]
        for c, t in zip(cs, ts):
            if cond == c:
                return t
        return target
    if name == "EXIST":
        return vals[0] if vals[0] is not None else vals[1]
    if name == "CONCAT":
        return "".join("" if v is None else str(v) for v in vals)
    if name == "TO_STRING":
        if isinstance(vals[0], list):   # MVA: comma-joined values
            return ",".join(str(v) for v in vals[0])
        return "" if vals[0] is None else str(vals[0])
    if name == "LENGTH":
        v = vals[0]
        if v is None:
            return 0
        if isinstance(v, (list, tuple)):
            return len(v)     # MVA / JSON array element count
        return len(str(v))
    if name in ("LEAST", "GREATEST"):
        # over an MVA/JSON array arg, or a plain arg list
        pool = (list(vals[0]) if len(vals) == 1
                and isinstance(vals[0], (list, tuple)) else list(vals))
        # JSON arrays aggregate NUMERIC members only (strings are
        # skipped, Expr_JsonFieldAggr); results render as float
        nums = [v for v in pool
                if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if not nums:
            if all(isinstance(v, str) for v in pool) and pool:
                return min(pool) if name == "LEAST" else max(pool)
            return None
        return float(min(nums) if name == "LEAST" else max(nums))
    if name == "SUBSTRING_INDEX":
        # SUBSTRING_INDEX(str, delim, count) — MySQL semantics
        s, delim, count = str(vals[0]), str(vals[1]), int(vals[2])
        parts = s.split(delim)
        if count > 0:
            return delim.join(parts[:count])
        if count < 0:
            return delim.join(parts[count:])
        return ""
    if name == "REGEX":
        # REGEX(attr, 'pattern') -> 1/0 (Expr_Regex_c over RE2)
        try:
            return int(bool(re.search(str(vals[1]),
                                      "" if vals[0] is None
                                      else str(vals[0]))))
        except re.error as e:
            raise ExprError(f"bad REGEX pattern: {e}")
    if name == "LEVENSHTEIN":
        return _levenshtein(str(vals[0]), str(vals[1]),
                            *(vals[2:] or ()))
    if name == "GEOPOLY2D":
        from ..utils.geodist import geo_tesselate
        return ("__poly__", True,
                tuple(geo_tesselate([float(v) for v in vals])))
    if name == "POLY2D":
        # returns the polygon vertex list; a single string arg (attr
        # holding "x1,y1,x2,y2,...") splits on separators
        # (Expr_ContainsStrattr_c)
        if len(vals) == 1 and isinstance(vals[0], str):
            vals = [float(x) for x in
                    re.findall(r"-?\d+(?:\.\d+)?", vals[0])]
        elif len(vals) == 1 and isinstance(vals[0], list):
            vals = vals[0]   # JSON array arg
        return ("__poly__", False,
                tuple(float(v) if v is not None else 0.0 for v in vals))
    if name == "CONTAINS":
        poly, x, y = vals[0], float(vals[1]), float(vals[2])
        if not (isinstance(poly, tuple) and poly and poly[0] == "__poly__"):
            raise ExprError("CONTAINS() needs POLY2D()/GEOPOLY2D()")
        return int(_point_in_poly(poly[2], x, y))
    if name == "QUERY":
        return ""       # filled by session when a MATCH() is present
    if name == "CURRENT_USER":
        # searchd reports the connection CLASS, not a login ("Usual"
        # vs "VIP", HandleMysqlSelectSysvar)
        return "Usual"
    if name == "CONNECTION_ID":
        return 0        # session overrides via row context when known
    if name == "LAST_INSERT_ID":
        return ""
    if name in ("MIN_TOP_WEIGHT", "MIN_TOP_SORTVAL"):
        return 0        # sorter watermark: 0 before the queue fills
    from ..plugins import get_udf
    udf = get_udf(name)
    if udf is not None:
        return udf(*vals)
    raise ExprError(f"unimplemented function {name}() on host")


def _levenshtein(a: str, b: str, *opts):
    """Plain Levenshtein distance (Expr_Levenshtein_c; option arg selects
    normalized output in the reference JSON API — here: 3rd arg truthy ->
    1 - dist/max_len)."""
    if a == b:
        dist = 0
    else:
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (ca != cb)))
            prev = cur
        dist = prev[-1]
    if opts and opts[0]:
        m = max(len(a), len(b))
        return 1.0 - (dist / m if m else 0.0)
    return dist


def _point_in_poly(flat: tuple, x: float, y: float) -> bool:
    """Even-odd crossing rule with on-edge inclusion over (x1,y1,x2,y2,
    ...) vertices (Expr_Contains_c::Contains, sphinxexpr.cpp:5509): a
    point ON any edge segment counts as contained, so degenerate
    (collinear) polygons still contain points on their line."""
    import numpy as np
    f32 = np.float32
    n = len(flat)
    if n < 6 or n % 2:
        return False   # degenerate vertex list: nothing contained
    inside = False
    for ii in range(0, n, 2):
        ax, ay = f32(flat[ii]), f32(flat[ii + 1])
        bx = f32(flat[0]) if ii == n - 2 else f32(flat[ii + 2])
        by = f32(flat[1]) if ii == n - 2 else f32(flat[ii + 3])
        t1 = f32((f32(x) - ax) * (by - ay))
        t2 = f32((f32(y) - ay) * (bx - ax))
        if t1 == t2 and not (ax == bx and ay == by):
            # collinear: on-segment test via projections
            t3 = (f32(x) - ax) * (bx - ax) + (f32(y) - ay) * (by - ay)
            t4 = (bx - ax) * (bx - ax) + (by - ay) * (by - ay)
            if 0 <= t3 <= t4:
                return True
        if (ay > y) != (by > y):
            if (t1 < t2) != (by < ay):
                inside = not inside
    return inside


def infer_is_float(tree: tuple, schema) -> bool:
    """Rough result-type inference (float vs int) for sort-key handling."""
    op = tree[0]
    if op == "num":
        return not float(tree[1]).is_integer()
    if op == "attr":
        ad = schema.attr(tree[1])
        return ad is not None and ad.type.value == "float"
    if op in ("weight", "id"):
        return False
    if op == "div":
        return True
    if op == "call":
        if tree[1] in ("DOUBLE", "SIN", "COS", "LN", "LOG2", "LOG10", "EXP",
                       "SQRT", "POW", "GEODIST", "BITDOT", "ATAN2", "RAND"):
            return True
        if tree[1] in ("BIGINT", "SINT", "INTEGER", "UINT", "CEIL", "FLOOR",
                       "IDIV", "IN", "INTERVAL", "CRC32", "FIBONACCI",
                       "DAY", "MONTH", "YEAR", "YEARMONTH", "YEARMONTHDAY",
                       "HOUR", "MINUTE", "SECOND", "LENGTH", "REGEX",
                       "INDEXOF", "ALL", "ANY"):
            return False
        return any(infer_is_float(a, schema) for a in tree[2])
    return any(infer_is_float(c, schema) for c in tree[1:]
               if isinstance(c, tuple))
