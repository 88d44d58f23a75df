"""Full-text query syntax parser.

Behavioral model: the reference's bison grammar + hand lexer
(Manticore src/sphinxquery.{y,cpp}; operator list sphinxquery.h:43-62,
user surface in SURVEY.md Appendix B). Implemented as a recursive-descent
parser with Sphinx precedence: `|` (OR) binds tighter than the implicit AND;
NOT applies to the following atom; field limits (@field / @(f1,f2) / @!f /
@@relaxed) apply to subsequent atoms until the next field operator.

Words are run through the same tokenizer+dictionary as indexing (index-time
and query-time tokenization must agree — SURVEY §1-L1).

Supported now: implicit AND, |, -/!NOT, "phrase", "phrase"~N, "quorum"/N and
/0.N, @field limits, =exact, word^boost, MAYBE, parentheses, word* wildcards
(expansion happens in the planner against the shard dictionary).
TODO (later rounds/milestones): NEAR/N, NOTNEAR/N, SENTENCE, PARAGRAPH,
ZONE:/ZONESPAN:, ^/$ field start/end markers.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer
from .ast import (QAll, QAnd, QGap, QMaybe, QNear, QOr, QPhrase, QQuorum,
                  QSentence, QTerm)


class QueryParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<or>\|)
  | (?P<not>[-!])
  | (?P<quote>")
  | (?P<field>@(?:@relaxed|!?\(\s*[\w,\s]+\s*\)(?:\[\d+\])?|!?[\w*]+(?:\[\d+\])?))
  | (?P<zone>ZONESPAN:(?:\(\s*[\w,\s]+\s*\)|\w+)|ZONE:(?:\(\s*[\w,\s]+\s*\)|\w+))
  | (?P<maybe>MAYBE\b)
  | (?P<esc>\\.)
  | (?P<word>[^\s()|!\-"@\\]+)
  | (?P<space>\s+)
  | (?P<stray>.)
    """,
    re.VERBOSE,
)

# marks an escaped char inside a word chunk: the chunk becomes a LITERAL
# keyword (the reference tokenizer honors query escapes — the escaped
# char joins the token even when it's a separator, so 'aaa\*ccc' looks
# up the single keyword "aaa*ccc")
ESC_CH = "\x03"

_POST_WORD_RE = re.compile(r"^(?P<exact>=?)(?P<body>.*?)(?P<boost>\^\d+(\.\d+)?)?$")


@dataclass
class _Tok:
    kind: str
    text: str
    start: int = -1      # source offsets: adjacency decides phrase
    end: int = -1        # chunk grouping (blend chars join chunks)


def _lex(q: str, word_chars: frozenset = frozenset()) -> list[_Tok]:
    out = []
    pos = 0
    last_word_end = -1   # end offset of the last emitted word-ish token
    while pos < len(q):
        m = _TOKEN_RE.match(q, pos)
        if not m:
            pos += 1  # skip stray char (reference lexer is permissive)
            continue
        pos = m.end()
        kind = m.lastgroup
        if word_chars:
            # operator chars the index charset declares as word chars
            # lose their operator meaning (the reference query lexer
            # asks the tokenizer about specials, sphinxquery.cpp):
            # charset_table with '|' makes "aaa|bbb" one keyword
            t0 = m.group()[0]
            if kind in ("or", "not", "lparen", "rparen", "quote") \
                    and t0 in word_chars:
                kind = "op_as_word"
            elif kind in ("field", "zone") and t0 in word_chars:
                kind = "op_as_word"
        if kind == "op_as_word":
            text = m.group()
            if out and out[-1].kind == "word" \
                    and m.start() == last_word_end:
                out[-1] = _Tok("word", out[-1].text + text,
                               out[-1].start, m.end())
            else:
                out.append(_Tok("word", text, m.start(), m.end()))
            last_word_end = m.end()
            continue
        if kind == "space":
            continue
        if kind == "esc":
            # \X: X loses any operator meaning (EscapeString counterpart,
            # PrepareQueryEmulation escape table, searchd.cpp:2168); it
            # joins the adjacent word chunk and the plain tokenizer later
            # folds non-charset chars to separators
            kind, text = "word", m.group()[1]
        else:
            text = m.group()
        if kind == "field" and out and out[-1].kind == "word" \
                and m.start() == last_word_end:
            # '@' directly after a word char is part of the word
            # ("bbb@ccc"): not a field operator — the tokenizer later
            # folds '@' to a separator, yielding adjacent keywords
            # (reference field-op lexing requires term start)
            kind = "word"
        if kind == "stray" and text == "@" and out \
                and out[-1].kind == "word" and m.start() == last_word_end:
            # trailing '@' glued to a word ("jill@"): part of the keyword
            # (blend chars keep it; otherwise the tokenizer folds it to a
            # separator) — the reference only field-parses '@' at term
            # start (golden test_203)
            kind = "word"
        if kind == "stray" and text == "@":
            # '@' followed by a char that can't start a field spec is
            # silently dropped and lexing resumes at the next char
            # (ParseFields bIgnore re-parse, sphinxquery.cpp:110-116):
            # '@@title test' field-limits to title, '-word@#1215' sheds
            # the '@' and keeps '#1215' as a keyword chunk
            continue
        if kind == "not" and out and out[-1].kind == "word" \
                and m.start() == last_word_end:
            # '-'/'!' directly after a word char is part of the word
            # ("16-35"): the tokenizer later folds it to a separator,
            # splitting into adjacent keywords — NOT only negates at
            # term start (reference lexer)
            kind = "word"
        if kind == "word" and out and out[-1].kind == "word" \
                and m.start() == last_word_end:
            out[-1] = _Tok("word", out[-1].text + text,
                           out[-1].start, m.end())
        else:
            out.append(_Tok(kind, text, m.start(), m.end()))
        if kind == "word":
            last_word_end = m.end()
    return out


class FtQueryParser:
    def __init__(self, tokenizer: Tokenizer, dictionary: Dictionary,
                 field_names: list[str]):
        self.tokenizer = tokenizer
        self.dictionary = dictionary
        self.field_names = field_names
        self._op_word_chars: frozenset | None = None

    def _operator_word_chars(self) -> frozenset:
        """Operator chars that the index charset maps to word chars
        (they lose operator meaning in queries, sphinxquery.cpp lexer
        consulting the tokenizer's specials)."""
        if self._op_word_chars is None:
            # only true charset word chars lose operator meaning; blend
            # chars keep it bare (test_063: 'bbb|ccc' with blended '|'
            # is still an OR) and only join inside phrases/escapes
            chars = set()
            lc = getattr(self.tokenizer, "_lc", None)
            for c in '|-!()"@':
                if lc is not None:
                    try:
                        if int(lc.fold_str(c)[0]) > 0:
                            chars.add(c)
                    except Exception:
                        pass
            self._op_word_chars = frozenset(chars)
        return self._op_word_chars

    def parse(self, query: str, not_only_allowed: bool = False):
        self.not_only_allowed = not_only_allowed
        if not query.strip():
            return QAll()
        self._exc_dsts: list[str] = []
        self.toks = _lex(query, self._operator_word_chars())
        if getattr(self.tokenizer, "_exc_map", None):
            # exceptions (synonyms file) substitute over the keyword
            # stream: runs of word chunks matching a source (split on
            # whitespace, case-sensitive) collapse to a \x01<idx>
            # destination placeholder — AFTER syntax lexing, so quorum
            # '/N' suffixes etc. stay operators
            self.toks = self._merge_exceptions(self.toks)
        if getattr(self.tokenizer.settings, "multiforms", ()):
            self.toks = self._merge_multiforms(self.toks)
        self.i = 0
        self.cur_fields: tuple[str, ...] | None = None
        self.cur_zones: tuple[str, ...] = ()
        self.cur_maxpos = 0
        self.relaxed = False
        node = self._parse_and_list()
        if self.i < len(self.toks):
            raise QueryParseError(f"unexpected {self.toks[self.i].text!r}")
        pruned = self._prune_fieldless(node)
        if pruned is None:
            # the reference never deletes the ROOT node itself
            # (DeleteNodesWOFields only removes children): a lone leaf
            # limited to zero fields stays in the tree — it matches
            # nothing but its keyword stats are still reported
            node = node if isinstance(node, (QTerm, QPhrase, QQuorum)) \
                else QTerm(word="\x00")
        else:
            node = pruned
        if node is None:
            # non-empty query whose every keyword was removed (stopwords,
            # overshort): matches NOTHING, unlike an empty MATCH('') which
            # is a fullscan (reference: a fully-stopped query tree yields
            # no matches). Use an impossible term (df=0 on any index).
            return QTerm(word="\x00")
        return node

    def _prune_fieldless(self, node):
        """DeleteNodesWOFields analog (sphinxquery.cpp:576): subtrees whose
        field limit resolved to an EMPTY field set (@@relaxed with every
        named field unknown, or @!(all fields)) are REMOVED from the tree
        and their parents re-collapse — '@@relaxed ((@bad a)|(@bad b))
        (@body x)' evaluates as '@body x', not as match-nothing."""
        from .ast import QAndNot, QNot
        p = self._prune_fieldless
        if node is None:
            return None
        if isinstance(node, (QTerm, QPhrase, QQuorum)):
            return None if node.fields == () else node
        if isinstance(node, (QAnd, QOr)):
            kids = [k for k in (p(c) for c in node.children)
                    if k is not None]
            if not kids:
                return None
            if len(kids) == 1:
                return kids[0]
            if len(kids) == len(node.children):
                return node
            return type(node)(tuple(kids))
        if isinstance(node, QAndNot):
            left = p(node.left)
            if left is None:
                return None
            right = p(node.right)
            if right is None:
                return left
            return node if (left is node.left and right is node.right) \
                else QAndNot(left, right)
        if isinstance(node, QNot):
            child = p(node.child)
            return None if child is None else \
                (node if child is node.child else QNot(child))
        if isinstance(node, QMaybe):
            left = p(node.left)
            if left is None:
                return None
            right = p(node.right)
            if right is None:
                return left
            return node if (left is node.left and right is node.right) \
                else QMaybe(left, right)
        if isinstance(node, (QNear, QSentence)):
            left, right = p(node.left), p(node.right)
            if left is None:
                return right
            if right is None:
                return left
            return node
        return node

    def _merge_exceptions(self, toks: list[_Tok]) -> list[_Tok]:
        by_first: dict[str, list] = {}
        for src, dst in self.tokenizer._exc_map.items():
            parts = src.split()
            by_first.setdefault(parts[0], []).append((parts, dst))
        for lst in by_first.values():
            lst.sort(key=lambda p: -len(p[0]))
        out: list[_Tok] = []
        i = 0
        while i < len(toks):
            t = toks[i]
            best = None
            if t.kind == "word":
                for parts, dst in by_first.get(t.text, ()):
                    k = len(parts)
                    if i + k <= len(toks) and all(
                            toks[i + j].kind == "word"
                            and toks[i + j].text == parts[j]
                            for j in range(1, k)):
                        best = (dst, k)
                        break
            if best:
                out.append(_Tok("word", f"\x01{len(self._exc_dsts)}"))
                self._exc_dsts.append(best[0])
                i += best[1]
            else:
                out.append(t)
                i += 1
        return out

    def _merge_multiforms(self, toks: list[_Tok]) -> list[_Tok]:
        """Multi-word wordforms spanning whitespace-separated query atoms:
        consecutive word chunks matching a source sequence collapse into
        one chunk carrying the destination (CSphMultiformTokenizer runs
        under the query parser in the reference, so '4 you' becomes the
        single keyword '4you'). Within-chunk matches are handled by the
        tokenizer itself."""
        by_first: dict[str, list] = {}
        for src, dst in self.tokenizer.settings.multiforms:
            if len(src) > 1:
                by_first.setdefault(src[0], []).append((src, dst))
        for lst in by_first.values():
            lst.sort(key=lambda p: -len(p[0]))

        def fold_one(text):
            tk = self.tokenizer.tokenize(text)
            return tk[0].text if len(tk) == 1 else None

        out: list[_Tok] = []
        i = 0
        while i < len(toks):
            t = toks[i]
            best = None
            if t.kind == "word" and t.text[:1] not in "~/":
                f0 = fold_one(t.text)
                for src, dst in by_first.get(f0, ()):
                    k = len(src)
                    if i + k <= len(toks) and all(
                            toks[i + j].kind == "word"
                            and fold_one(toks[i + j].text) == src[j]
                            for j in range(1, k)):
                        best = (dst, k)
                        break
            if best:
                out.append(_Tok("word", " ".join(best[0])))
                i += best[1]
            else:
                out.append(t)
                i += 1
        return out

    # --- helpers -----------------------------------------------------------
    def _peek(self) -> _Tok | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _terms_of(self, word: str, exact: bool) -> list[str]:
        """Tokenize a raw query word chunk into index terms. Sets
        self._last_span to the number of atom positions the chunk
        consumed (blended chunks cover their parts' positions)."""
        toks = self.tokenizer.tokenize(word)
        self._last_span = (max(t.position for t in toks)
                           - min(t.position for t in toks) + 1) \
            if toks else 1
        # blended chunk ("m&m"): the whole token covers the chunk and
        # shares the first sub-token's position — query side searches the
        # most specific (whole) form, like the reference's query-time
        # blended handling (qpos still advances over the parts,
        # m_iAtomPos per tokenizer position)
        if (len(toks) > 1 and toks[0].position == toks[1].position
                and toks[0].start <= toks[1].start
                and toks[0].end >= toks[-1].end):
            toks = [toks[0]]
        out = []
        self._last_raws = []
        for t in toks:
            term = self.dictionary.process_query_term(t.text, exact=exact)
            if term is not None:
                out.append(term)
                self._last_raws.append(t.text)
        return out

    def _parse_field_spec(self, text: str) -> tuple[str, ...] | None:
        body = text[1:]
        # optional position-range modifier: @field[N] / @(f1,f2)[N]
        # (ParseFields, sphinxquery.cpp:201-215) — hits at in-field
        # position > N won't match; resets to 0 per field operator
        prev_maxpos = getattr(self, "cur_maxpos", 0)
        self.cur_maxpos = 0
        m = re.search(r"\[(\d+)\]$", body)
        if m:
            self.cur_maxpos = int(m.group(1))
            body = body[:m.start()]
        if body == "@relaxed":
            # @@relaxed: unknown field references stop being errors
            # (sphinxquery.cpp relaxed flag); limits to only-missing
            # fields match nothing
            self.relaxed = True
            self.cur_maxpos = prev_maxpos
            return self.cur_fields
        if body == "*":
            return None
        negate = body.startswith("!")
        if negate:
            body = body[1:]
        if body.startswith("("):
            names = [s.strip() for s in body.strip("()").split(",") if s.strip()]
        else:
            names = [body]
        known = []
        for n in names:
            if n not in self.field_names:
                if getattr(self, "relaxed", False):
                    continue
                raise QueryParseError(f"no field '{n}' in schema")
            known.append(n)
        names = known
        if negate:
            names = [f for f in self.field_names if f not in names]
        return tuple(names)

    def _parse_zone_spec(self, text: str) -> tuple[str, ...]:
        """ZONE:(h1,h2) / ZONE:h1 / ZONESPAN:... (sphinxquery.y zone
        grammar). ZONESPAN zone names carry an '=' prefix through the
        plan: the kernel applies the same-span-instance constraint to the
        slots sharing the spec (exact for AND-of-keywords contexts)."""
        span = text.startswith("ZONESPAN")
        body = text.split(":", 1)[1]
        if body.startswith("("):
            body = body[1:-1]
        return tuple(("=" if span else "") + z.strip().lower()
                     for z in body.split(",") if z.strip())

    # --- grammar -----------------------------------------------------------
    def _parse_and_list(self):
        """Implicit-AND list of OR-expressions; NOT members split out."""
        pos_children = []
        neg_children = []
        while True:
            t = self._peek()
            if t is None or t.kind == "rparen":
                break
            if t.kind == "field":
                self._next()
                self.cur_fields = self._parse_field_spec(t.text)
                if self._peek() is None:
                    # a trailing field operator with no operand is a
                    # syntax error ("unexpected $end", sphinxquery.y)
                    raise QueryParseError(
                        "syntax error, unexpected $end")
                continue
            if t.kind == "zone":
                self._next()
                self.cur_zones = self._parse_zone_spec(t.text)
                continue
            if t.kind == "maybe":
                self._next()
                right = self._parse_or_expr()
                if not pos_children:
                    raise QueryParseError("MAYBE needs a left operand")
                left = pos_children.pop()
                pos_children.append(QMaybe(left, right))
                continue
            if t.kind == "not":
                self._next()
                child = self._parse_or_expr()
                if isinstance(child, QGap):
                    pos_children.append(child)
                elif child is not None:
                    if isinstance(child, QAnd) \
                            and getattr(self, "_chunk_split_and", False):
                        # one syntax word that split into several
                        # consecutive keywords ('-word@#1215' ->
                        # word, 1215): the grammar's '-' binds ONE
                        # keyword token (sphinxquery.y:83 '-' orlist of
                        # one atom); the remaining emissions continue
                        # the implicit AND list as positives
                        neg_children.append(child.children[0])
                        pos_children.extend(child.children[1:])
                    else:
                        neg_children.append(child)
                continue
            child = self._parse_or_expr()
            # NEAR/N, NOTNEAR/N, SENTENCE, PARAGRAPH infix operators
            # (sphinxquery.h:43-62)
            while True:
                nxt = self._peek()
                m = None
                sp = None
                if nxt is not None and nxt.kind == "word":
                    m = re.match(r"^(NEAR|NOTNEAR)/(\d+)$", nxt.text)
                    if nxt.text in ("SENTENCE", "PARAGRAPH"):
                        sp = nxt.text
                if not m and not sp:
                    break
                self._next()
                right = self._parse_or_expr()
                if child is None or right is None:
                    raise QueryParseError("binary operator needs two operands")
                if sp:
                    child = QSentence(child, right,
                                      paragraph=sp == "PARAGRAPH")
                else:
                    child = QNear(child, right, int(m.group(2)),
                                  not_near=m.group(1) == "NOTNEAR")
            if child is not None:
                pos_children.append(child)

        if all(isinstance(c, QGap) for c in pos_children) \
                and neg_children:
            if getattr(self, "not_only_allowed", False):
                # OPTION not_terms_only_allowed=1 (searchd.cpp:18470,
                # searchdsql.cpp:744): a pure-NOT query evaluates as
                # fullscan-minus-matches
                pos_children = [c for c in pos_children
                                if not isinstance(c, QGap)]
                pos_children.append(QAll())
            else:
                raise QueryParseError(
                    "query is non-computable (single NOT operator)"
                )
        if not pos_children:
            return None
        if all(isinstance(c, QGap) for c in pos_children):
            return None
        pos = pos_children[0] if len(pos_children) == 1 else QAnd(tuple(pos_children))
        if not neg_children:
            return pos
        neg = neg_children[0] if len(neg_children) == 1 else QOr(tuple(neg_children))
        from .ast import QAndNot  # local to avoid unused when no NOT
        return QAndNot(pos, neg)

    def _parse_or_expr(self):
        left = self._parse_atom()
        while True:
            t = self._peek()
            if t is None or t.kind != "or":
                break
            self._next()
            # allow field spec right after |
            while self._peek() and self._peek().kind == "field":
                self.cur_fields = self._parse_field_spec(self._next().text)
            right = self._parse_atom()
            if isinstance(right, QGap):
                right = None
            if left is None or isinstance(left, QGap):
                left = right if left is None else (right or left)
            elif right is not None:
                lc = left.children if isinstance(left, QOr) else (left,)
                rc = right.children if isinstance(right, QOr) else (right,)
                left = QOr(lc + rc)
        return left

    def _parse_atom(self):
        self._chunk_split_and = False
        t = self._peek()
        if t is None:
            return None
        if t.kind == "lparen":
            self._next()
            saved = self.cur_fields
            saved_z = self.cur_zones
            node = self._parse_and_list()
            if self._peek() is None or self._peek().kind != "rparen":
                raise QueryParseError("missing ')'")
            self._next()
            self.cur_fields = saved
            self.cur_zones = saved_z
            self._chunk_split_and = False
            return node
        if t.kind == "quote":
            return self._parse_quoted()
        if t.kind == "word":
            if t.text == "=" and self.i + 1 < len(self.toks) \
                    and self.toks[self.i + 1].kind == "quote":
                # ='phrase': exact-form distributes to every phrase term
                # (sphinxquery.cpp exact-form before quote)
                self._next()
                return self._parse_quoted(exact=True)
            self._next()
            return self._make_term_atom(t.text)
        if t.kind == "field":
            self._next()
            self.cur_fields = self._parse_field_spec(t.text)
            if self._peek() is None:
                # a field operator must be followed by something
                # ("syntax error, unexpected $end", sphinxquery.y)
                raise QueryParseError("syntax error, unexpected $end")
            return self._parse_atom()
        if t.kind == "zone":
            self._next()
            self.cur_zones = self._parse_zone_spec(t.text)
            return self._parse_atom()
        raise QueryParseError(f"unexpected {t.text!r}")

    def _exc_terms(self, ph: str) -> list[str]:
        """Placeholder \\x01<idx> -> the exception destination's terms
        (indexed verbatim-lowercased by the builder, then dict-processed)."""
        dst = self._exc_dsts[int(ph[1:])]
        out = []
        for w in dst.split():
            term = self.dictionary.process_query_term(w.lower())
            if term is not None:
                out.append(term)
        return out

    def _make_term_atom(self, raw: str):
        if raw and raw[0] in "~/" and not raw.startswith("\x01"):
            # a stray proximity/quorum suffix not attached to a phrase is
            # a syntax error (sphinxquery.y: "unexpected '~'")
            raise QueryParseError(
                f"syntax error, unexpected '{raw[0]}' near '{raw}'")
        if raw.startswith("\x01"):
            terms = self._exc_terms(raw)
            if not terms:
                return None
            if len(terms) == 1:
                return QTerm(terms[0], self.cur_fields,
                             zones=self.cur_zones,
                             max_field_pos=self.cur_maxpos)
            return QPhrase(tuple(terms), self.cur_fields)
        m = _POST_WORD_RE.match(raw)
        exact = bool(m.group("exact"))
        body = m.group("body")
        boost = float(m.group("boost")[1:]) if m.group("boost") else 1.0
        fstart = body.startswith("^")
        if fstart:
            body = body[1:]
        fend = body.endswith("$")
        if fend:
            body = body[:-1]
        wildcard = "*" in body or "?" in body
        if wildcard:
            ds = self.dictionary.settings
            if getattr(ds, "min_prefix_len", 0) <= 0 \
                    and getattr(ds, "min_infix_len", 0) <= 0:
                # wildcards disabled: wild chars are not in the charset and
                # fold to separators; remaining keywords go through the
                # normal pipeline (min_word_len/stopwords apply)
                body = body.replace("*", " ").replace("?", " ").strip()
                if not body:
                    return None
                wildcard = False
            elif all(c in "*?" for c in body):
                # just wildcards: the keyword drops entirely
                # (sphHasExpandableWildcards, sphinx.cpp:14917)
                return None
            else:
                return QTerm(body.lower(), self.cur_fields, exact, boost,
                             wildcard=True, zones=self.cur_zones,
                             field_start=fstart, field_end=fend,
                             raw=body.lower(),
                             max_field_pos=self.cur_maxpos)
        terms = self._terms_of(body, exact)
        if not terms:
            # every keyword of the atom dropped (stopword/overshort):
            # the atom still consumes its positions (m_iAtomPos advances
            # over stopped keywords — stopword_step semantics)
            return QGap(getattr(self, "_last_span", 1))
        raws = list(getattr(self, "_last_raws", []) or terms)
        if exact and self.dictionary.settings.index_exact_words \
                and (self.dictionary._morphs or self.dictionary._wordforms):
            # the exact-form operator displays as part of the keyword
            # (XQKeyword m_sWord keeps the '=' marker: plan "=dogs");
            # without index_exact_words the '=' is dropped entirely
            raws = ["=" + r for r in raws]
        if len(terms) == 1:
            return QTerm(terms[0], self.cur_fields, exact, boost,
                         field_start=fstart, field_end=fend,
                         zones=self.cur_zones, raw=raws[0],
                         atom_span=getattr(self, "_last_span", 1),
                         max_field_pos=self.cur_maxpos)
        # a single syntax word expanding to multiple tokens ("t-shirt",
        # multiform destinations like rdogs > red dogs) becomes separate
        # consecutive keywords — implicit AND, one atom pos each (the XQ
        # parser appends each tokenizer emission as its own keyword;
        # golden test_022 plan: OR(AND(me), AND(AND(red), AND(dogs)));
        # ^/$ anchors apply to the first/last emission (q48 field_end)
        kids = []
        for i2, (t, rw) in enumerate(zip(terms, raws)):
            kids.append(QTerm(t, self.cur_fields, zones=self.cur_zones,
                              raw=rw,
                              field_start=fstart and i2 == 0,
                              field_end=fend and i2 == len(terms) - 1,
                              max_field_pos=self.cur_maxpos))
        self._chunk_split_and = True
        return QAnd(tuple(kids))

    def _parse_quoted(self, exact: bool = False):
        self._next()  # opening quote
        # specials lose their meaning inside quotes: regroup tokens into
        # whitespace-separated RAW chunks by source adjacency and let the
        # tokenizer decide what separates (blend chars join — test_063
        # '"aaa|eee|ccc"' is ONE blended keyword; plain specials fold to
        # separators: '@steroids' -> steroids)
        words: list[str] = []
        last_end = None
        while True:
            t = self._peek()
            if t is None:
                raise QueryParseError("missing closing '\"'")
            if t.kind == "quote":
                self._next()
                break
            self._next()
            joinable = t.kind in ("word", "field", "zone", "maybe", "or",
                                  "not", "lparen", "rparen")
            if not joinable:
                last_end = None
                continue
            if words and last_end is not None and t.start == last_end \
                    and not words[-1].startswith("\x01"):
                words[-1] += t.text
            else:
                words.append(t.text)
            last_end = t.end if t.start >= 0 else None
        # suffix: ~N proximity or /N quorum
        prox = 0
        quorum = None
        suffix_gap = False
        rest = self._peek()
        if rest is not None and rest.kind == "word" and rest.text[:1] in "~/":
            self._next()
            txt = rest.text
            try:
                if txt.startswith("~"):
                    prox = int(txt[1:])
                else:
                    val = float(txt[1:])
                    quorum = val
            except ValueError:
                raise QueryParseError(f"bad phrase suffix {txt!r}")
            if txt.startswith("~") and prox < 1:
                # CheckQuorumProximity (sphinxquery.cpp:303)
                raise QueryParseError(
                    f"proximity threshold too low ({prox})")
            suffix_gap = True
        # tokenize chunk-by-chunk: stopped/overshort tokens keep their
        # POSITION (stopword_step/overshort_step semantics), so phrase
        # matching preserves the gaps — "walking in my shoes" with in/my
        # stopped must match walking@p, shoes@p+3. Wildcard chunks stay as
        # starred members (expanded in the planner against the dict) when
        # prefix/infix indexing allows it.
        ds = self.dictionary.settings
        wc_enabled = (getattr(ds, "min_prefix_len", 0) > 0
                      or getattr(ds, "min_infix_len", 0) > 0)
        entries: list[tuple] = []   # (term, pos, raw)
        base = 0
        for chunk in words:
            if chunk.startswith("\x01"):
                for term in self._exc_terms(chunk):
                    base += 1
                    entries.append((term, base, term))
                continue
            if any(c in "*?" for c in chunk):
                if all(c in "*?" for c in chunk):
                    # a lone '*' placeholder consumes ONE position and
                    # matches anything ("that * box": that@1 box@3,
                    # sphinxquery.cpp star-in-phrase)
                    base += 1
                    continue
                if not wc_enabled:
                    chunk = chunk.replace("*", " ").replace("?", " ").strip()
                    if not chunk:
                        continue
                else:
                    base += 1
                    entries.append((chunk.lower(), base, chunk.lower()))
                    continue
            # '~'/'/' directly followed by digits inside a phrase: the
            # reference lexer's number check (GetNumber,
            # sphinxquery.cpp:1236-1276, armed by the '~'/'/' specials)
            # turns the digit run into TOK_INT, and the grammar's keyword
            # rule (sphinxquery.y:110-112) adds it as a keyword — a NULL
            # one AT THE PREVIOUS atom position when the digits can't
            # tokenize (overshort under min_word_len), which makes the
            # phrase unmatchable: '"phrase (query)/3 ~on steroids"'
            # matches nothing under min_word_len=2
            segs = (re.split(r"[~/](\d+(?:\.\d+)?)(?![\w*?])", chunk)
                    if ("/" in chunk or "~" in chunk) else [chunk])
            for si, seg in enumerate(segs):
                if si % 2 == 1:
                    nt = self.tokenizer.tokenize(seg)
                    nterm = (self.dictionary.process_query_term(
                        nt[0].text, exact=exact) if nt else None)
                    if nterm is not None:
                        base += 1
                        entries.append((nterm, base, seg))
                    else:
                        entries.append(("\x00",
                                        base if entries else base + 1,
                                        seg))
                    continue
                if not seg:
                    continue
                toks = self.tokenizer.tokenize(seg)
                maxpos = max((t.position for t in toks), default=0)
                if (len(toks) > 1 and toks[0].position == toks[1].position
                        and toks[0].start <= toks[1].start
                        and toks[0].end >= toks[-1].end):
                    # blended chunk inside a phrase: search the whole form
                    # only; it still covers its parts' positions
                    toks = [toks[0]]
                for tk in toks:
                    term = self.dictionary.process_query_term(tk.text,
                                                              exact=exact)
                    if term is not None:
                        entries.append((term, base + tk.position, tk.text))
                if toks:
                    base += maxpos
                elif any(c.isalnum() for c in seg):
                    # a word-ish chunk whose tokens all dropped (overshort/
                    # stopword) keeps its position gap
                    base += self.tokenizer.settings.overshort_step
                # pure-special chunks ('(', '!') consume no position
        words = [e[0] for e in entries]
        raws = tuple(e[2] for e in entries)
        if not words:
            return None
        base = entries[0][1]
        deltas = tuple(e[1] - base for e in entries)

        def _with_gap(node):
            # the /N or ~N count is a tokenizer token in the reference —
            # it consumes one atom position after the phrase
            return QAnd((node, QGap(1))) if suffix_gap else node
        if quorum is not None:
            m = int(quorum) if quorum >= 1 else max(1, int(len(words) * quorum))
            if len(words) == 1:
                return _with_gap(QTerm(words[0], self.cur_fields,
                                       raw=raws[0],
                                       max_field_pos=self.cur_maxpos))
            return _with_gap(QQuorum(tuple(words), m, self.cur_fields,
                                     raws=raws))
        if len(words) == 1:
            # a one-word phrase degenerates to the bare term — keep its
            # wildcard flag so `"*abc*"` still expands in the planner
            return _with_gap(QTerm(words[0], self.cur_fields, raw=raws[0],
                             wildcard=any(c in "*?" for c in words[0]),
                             max_field_pos=self.cur_maxpos))
        return _with_gap(QPhrase(tuple(words), self.cur_fields,
                                 proximity=prox, positions=deltas,
                                 raws=raws))
