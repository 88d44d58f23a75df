"""Host planner: parsed AST + options -> PlanSig (static) + runtime arrays.

Covers the reference's query-prep pipeline (sphinx.cpp:15362-15760):
sphTransformExtendedQuery (flatten/simplify), ExpandPrefix (wildcards -> OR
over dictionary terms), qword setup (dict lookups -> CSR offsets), IDF
computation (sphinxsearch.cpp:4295-4360 — implemented literally), ranker
selection (sphCreateRanker:4167 incl. the single-keyword WeightSum shortcut).
"""
from __future__ import annotations

import bisect
import math
import os
from dataclasses import dataclass, field

import numpy as np

from .ast import (QAll, QAnd, QAndNot, QGap, QMaybe, QNear, QOr, QPhrase,
                  QQuorum, QSentence, QTerm)
from .plan import FilterSpec, PlanSig, _desc_slots


@dataclass
class AttrFilterDef:
    """Host-level filter (from SQL WHERE / JSON DSL)."""
    attr: str
    kind: str                      # "values" | "range_i" | "range_f"
    values: list = field(default_factory=list)   # for values
    lo: float | int | None = None
    hi: float | int | None = None
    exclude: bool = False
    lo_excl: bool = False
    hi_excl: bool = False
    uservar: bool = False          # values came from a @uservar: remote
    #                                agents don't share the master's
    #                                uservars, so agent parts match
    #                                nothing (golden test_039)


@dataclass
class CompiledQuery:
    sig: PlanSig
    runtime: dict                  # jit-ready runtime arg pytree
    slot_terms: list[str]          # slot -> term string (for SHOW META)
    slot_df: list[int]
    slot_hits: list[int]
    slot_pb: tuple                 # per-slot posting bucket (pow2 of df)
    slot_hb: tuple                 # per-slot hit bucket (pow2 of hit count)
    n_hit_iters: int
    # display word stats: (word, docs, hits) with wildcard expansions
    # aggregated under the original pattern (sphinx.cpp:14873 AddStat)
    stat_list: list = field(default_factory=list)
    ast: object = None             # transformed AST (SHOW PLAN render)
    warning: str = ""              # plan-time warning (hitless phrase
    #                                degradation etc.)


def _next_pow2(x: int, lo: int = 128) -> int:
    n = lo
    while n < x:
        n <<= 1
    return n


def _next_pow4(x: int, lo: int = 1024) -> int:
    """Bucket quantized in 4x steps: coarser than pow2 on purpose — every
    distinct (slot_pb, slot_hb) tuple is a separate XLA program, and
    compiles on this link cost 25-150s each; halving the bucket count per
    dimension collapses the compile matrix at a bounded (<4x, amortized
    ~2x) padding-compute cost that is micro vs. minutes."""
    n = lo
    while n < x:
        n <<= 2
    return n


def compute_idf(df: int, total_docs: int, *, plain: bool = False,
                normalized_tfidf: bool = True, n_qwords: int = 1,
                boost: float = 1.0) -> float:
    """Literal re-implementation of the IDF build in sphCreateRanker
    (sphinxsearch.cpp:4317-4360)."""
    if df <= 0:
        idf = 0.0
    else:
        n_total = max(total_docs, df)
        log_total = math.log(1 + n_total)
        if plain:
            idf = math.log(n_total / df) / (2.0 * log_total)
        else:
            idf = math.log((n_total - df + 1) / df) / (2.0 * log_total)
    if normalized_tfidf:
        idf /= max(n_qwords, 1)
    return idf * boost


_JSON_MISSING = object()   # marks an absent path (vs an explicit null)


def json_path_get(obj, path: str, missing=None):
    """Descend a dotted JSON path; int segments index arrays. `missing`
    is returned when the path does not exist — pass a sentinel to
    distinguish it from an explicit JSON null value."""
    cur = obj
    for seg in path.split("."):
        if cur is None:
            return missing
        if isinstance(cur, dict):
            if seg not in cur:
                return missing
            cur = cur.get(seg)
        elif isinstance(cur, list):
            try:
                cur = cur[int(seg)]
            except (ValueError, IndexError):
                return missing
        else:
            return missing
    return cur


def _json_cmp_num(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _eval_json_filter(index, base: str, f) -> np.ndarray:
    """Evaluate one JSON-path filter host-side -> packed i32 row bitmask."""
    path = f.attr.split(".", 1)[1]
    docs = index.json_docs(base)
    n = index.n_docs
    bits = np.zeros(n + 1, bool)
    if f.kind == "values":
        want_s = {str(v) for v in f.values}
        want_n = {x for x in (_json_cmp_num(v) for v in f.values)
                  if x is not None}
        for r in range(n):
            v = json_path_get(docs[r], path)
            if v is None:
                continue
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                bits[r] = float(v) in want_n
            else:
                bits[r] = str(v) in want_s
    elif f.kind in ("range_i", "range_f"):
        lo = _json_cmp_num(f.lo) if f.lo is not None else None
        hi = _json_cmp_num(f.hi) if f.hi is not None else None
        for r in range(n):
            raw = json_path_get(docs[r], path, missing=_JSON_MISSING)
            if raw is _JSON_MISSING:
                continue
            # an explicit JSON null compares as 0 (Expr_JsonField null
            # coercion; golden test_318 {"price":null} matches price<25)
            v = 0.0 if raw is None else _json_cmp_num(raw)
            if v is None:
                continue
            ok = True
            if lo is not None:
                ok &= (v > lo) if f.lo_excl else (v >= lo)
            if hi is not None:
                ok &= (v < hi) if f.hi_excl else (v <= hi)
            bits[r] = ok
    else:
        raise NotImplementedError(
            f"filter kind {f.kind} on JSON path {f.attr!r}")
    idx = np.nonzero(bits)[0].astype(np.int64)
    words = np.zeros((n + 1 + 31) // 32, np.uint32)
    np.bitwise_or.at(words, idx >> 5,
                     np.uint32(1) << (idx & 31).astype(np.uint32))
    return words.view(np.int32)


def simplify(node):
    """Flatten nested AND/OR, drop Nones (sphTransformExtendedQuery-lite,
    sphinx.cpp:15345)."""
    if isinstance(node, QAnd):
        out = []
        for c in node.children:
            c = simplify(c)
            if isinstance(c, QAnd):
                out.extend(c.children)
            elif c is not None:
                out.append(c)
        if not out:
            return None
        return out[0] if len(out) == 1 else QAnd(tuple(out))
    if isinstance(node, QOr):
        out = []
        for c in node.children:
            c = simplify(c)
            if isinstance(c, QOr):
                out.extend(c.children)
            elif c is not None:
                out.append(c)
        if not out:
            return None
        return out[0] if len(out) == 1 else QOr(tuple(out))
    if isinstance(node, QAndNot):
        left = simplify(node.left)
        right = simplify(node.right)
        if right is None:
            return left
        if left is None:
            return None
        return QAndNot(left, right)
    if isinstance(node, QMaybe):
        left = simplify(node.left)
        right = simplify(node.right)
        if right is None:
            return left
        if left is None:
            return None
        return QMaybe(left, right)
    return node


def transform_boolean_simplify(node):
    """Opt-in boolean transformations (sphTransformExtendedQuery with
    boolean_simplify=1, sphinxquery.cpp transformation set): duplicate
    sibling removal and common-keyword factoring
    (a x) | (a y) -> a (x | y). Like the reference, this may perturb
    ranking slightly (shared subtree tf aggregation) — hence opt-in."""
    if isinstance(node, QAnd):
        kids = [transform_boolean_simplify(c) for c in node.children]
        out = []
        for c in kids:                       # dedupe identical siblings
            if c not in out:
                out.append(c)
        return out[0] if len(out) == 1 else QAnd(tuple(out))
    if isinstance(node, QOr):
        kids = [transform_boolean_simplify(c) for c in node.children]
        out = []
        for c in kids:
            if c not in out:
                out.append(c)
        if len(out) == 1:
            return out[0]
        # common keyword factoring across AND groups
        groups = []
        for c in out:
            groups.append(list(c.children) if isinstance(c, QAnd) else [c])
        common = [t for t in groups[0]
                  if isinstance(t, QTerm)
                  and all(t in g for g in groups[1:])]
        if common:
            rests = []
            for g in groups:
                rest = [t for t in g if t not in common]
                if not rest:
                    # one arm is exactly the common part: the OR collapses
                    # to it (a | (a x) -> a)
                    return (common[0] if len(common) == 1
                            else QAnd(tuple(common)))
                rests.append(rest[0] if len(rest) == 1
                             else QAnd(tuple(rest)))
            return QAnd(tuple(common) + (QOr(tuple(rests)),))
        return QOr(tuple(out))
    if isinstance(node, QAndNot):
        return QAndNot(transform_boolean_simplify(node.left),
                       transform_boolean_simplify(node.right))
    if isinstance(node, QMaybe):
        return QMaybe(transform_boolean_simplify(node.left),
                      transform_boolean_simplify(node.right))
    return node


def expand_keywords_ast(node, index):
    """expand_keywords=1 (sphinx.cpp ExpandKeywords): every plain keyword
    becomes ( word | word* | =word ), letting stem/exact/prefix forms
    compete; wildcard expansion then resolves the starred form."""
    if isinstance(node, QTerm) and not node.wildcard and not node.exact \
            and node.word:
        from ..text.dictionary import DictSettings
        ds = getattr(index, "dict_settings", DictSettings())
        alts = [node]
        # the starred form only competes when expansion is available
        # (KWE_STAR skipped otherwise, sphinx.cpp:5955)
        if getattr(ds, "min_prefix_len", 0) > 0 \
                or getattr(ds, "min_infix_len", 0) > 0:
            alts.append(QTerm(node.word + "*", node.fields, boost=node.boost,
                              wildcard=True, zones=node.zones,
                              max_field_pos=node.max_field_pos))
        if ds.index_exact_words:
            alts.append(QTerm(node.word, node.fields, exact=True,
                              boost=node.boost, zones=node.zones,
                              max_field_pos=node.max_field_pos))
        return QOr(tuple(alts))
    if isinstance(node, QAnd):
        return QAnd(tuple(expand_keywords_ast(c, index)
                          for c in node.children))
    if isinstance(node, QOr):
        return QOr(tuple(expand_keywords_ast(c, index)
                         for c in node.children))
    if isinstance(node, QAndNot):
        return QAndNot(expand_keywords_ast(node.left, index),
                       expand_keywords_ast(node.right, index))
    if isinstance(node, QMaybe):
        return QMaybe(expand_keywords_ast(node.left, index),
                      expand_keywords_ast(node.right, index))
    return node


_WILDS = set("*?%")          # sphIsWild (sphinxstd.h)


def _expansion_terms(pat: str, term_strs: list[str],
                     min_prefix: int, min_infix: int,
                     expansion_limit: int,
                     exact_forms: bool = False) -> list[str] | None:
    """Dictionary terms a wildcard pattern expands to, replicating
    sphExpandGetWords (sphinx.cpp:14931-15018). Returns None when the
    pattern's fixed part is under the min prefix/infix length (the
    reference warns and leaves the term unexpanded — matching nothing)."""
    import fnmatch

    if pat[:2] == "=*":            # '=*term' counts as infix
        pat = pat[1:]
    if pat[:1] and pat[0] not in _WILDS or min_infix <= 0:
        # prefix expansion: skip an exact-form modifier and any leading
        # wilds (non-infixed path), then the fixed prefix runs to the
        # first remaining wild
        p = pat[1:] if pat[:1] == "=" else pat
        p = p.lstrip("".join(_WILDS))
        fixed = p
        for i, ch in enumerate(p):
            if ch in _WILDS:
                fixed = p[:i]
                break
        if len(fixed) < min_prefix:
            return None
        # the match pattern drops the leading wilds (reference quirk:
        # '*earc*' on a prefix-only index behaves as 'earc*')
        pattern = p
    else:
        # infix expansion: the longest run of non-wild chars gates
        runs = [r for r in
                "".join(c if c not in _WILDS else " " for c in pat).split()]
        longest = max((len(r) for r in runs), default=0)
        if longest < min_infix:
            return None
        pattern = pat
    # with morphology/exact forms, expansion runs over the nonstemmed
    # shadow entries ("="-prefixed; MAGIC_WORD_HEAD_NONSTEMMED analog) and
    # the expanded terms ARE those shadow entries
    shadow = "=" if exact_forms else ""
    matches: list[str] = []
    if pattern.endswith("*") and not any(c in _WILDS for c in pattern[:-1]):
        prefix = shadow + pattern[:-1]
        i = bisect.bisect_left(term_strs, prefix)
        while i < len(term_strs) and term_strs[i].startswith(prefix):
            matches.append(term_strs[i])
            i += 1
            if expansion_limit and len(matches) >= expansion_limit:
                break
    else:
        fpat = shadow + pattern.replace("%", "?")
        if shadow:
            lo = bisect.bisect_left(term_strs, "=")
            hi = bisect.bisect_left(term_strs, ">")
            cand = term_strs[lo:hi]
        else:
            cand = term_strs
        for t in cand:
            if fnmatch.fnmatchcase(t, fpat):
                matches.append(t)
                if expansion_limit and len(matches) >= expansion_limit:
                    break
    return matches


def expand_wildcards(node, index, expansion_limit: int = 0,
                     expanded_out: dict | None = None):
    """word* / *infix* -> OR over matching dictionary terms (ExpandPrefix,
    sphinx.cpp:15021 + sphExpandXQNode:14794). Returns a new AST.

    Gating mirrors the reference: expansion needs min_prefix_len>0 or
    min_infix_len>0 (index settings); otherwise wild chars are separators
    and fold away. `expanded_out` (pattern -> list of expanded terms)
    records expansions so word stats aggregate under the original pattern
    (AddStat of the root word, sphinx.cpp:14873)."""
    term_strs = index.term_strs
    ds = getattr(index, "dict_settings", None)
    min_prefix = getattr(ds, "min_prefix_len", 0) if ds else 0
    min_infix = getattr(ds, "min_infix_len", 0) if ds else 0
    enabled = min_prefix > 0 or min_infix > 0
    exact_forms = bool(ds and (ds.index_exact_words or ds.morphology))

    # dict=crc prefix_fields/infix_fields: each field indexes whole words,
    # prefixes, or all substrings (GetWordpart, indexsettings.cpp:223 —
    # prefix wins when a field qualifies for both). A prefix query is
    # answered by PREFIX and INFIX fields (infix substring emission adds
    # the magic-head prefix forms, BuildSubstringHits sphinx.cpp:22390);
    # an infix query only by INFIX fields. We model this as a field limit
    # on the expansion terms (hits outside enabled fields are filtered,
    # stats recalc over the filtered cache).
    _crc = bool(ds) and getattr(ds, "mode", "keywords") == "crc"
    _pfx_l = tuple(getattr(ds, "prefix_fields", ()) or ()) if ds else ()
    _inf_l = tuple(getattr(ds, "infix_fields", ()) or ()) if ds else ()

    def crc_field_limit(pat: str):
        """-> tuple of allowed fields, or None = unrestricted."""
        if not _crc or (not _pfx_l and not _inf_l):
            return None
        flds = [f.lower() for f in index.schema.fields]
        pfx = {f for f in flds
               if min_prefix > 0 and (not _pfx_l or f in _pfx_l)}
        inf = {f for f in flds
               if min_infix > 0 and (not _inf_l or f in _inf_l)
               and f not in pfx}
        is_prefix_q = (pat.endswith("*") and not pat.startswith("*")
                       and "*" not in pat[:-1] and "?" not in pat)
        ok = (pfx | inf) if is_prefix_q else inf
        return tuple(f for f in flds if f in ok)

    def rec(node):
        if isinstance(node, QTerm) and node.wildcard:
            pat = node.word
            if not enabled:
                # wild chars are not in the charset: they fold to
                # separators and the bare keyword remains
                bare = "".join(c for c in pat if c not in _WILDS)
                if not bare:
                    return None
                return QTerm(bare, node.fields, boost=node.boost,
                             zones=node.zones,
                             field_start=node.field_start,
                             field_end=node.field_end,
                             max_field_pos=node.max_field_pos)
            n_wild = sum(1 for c in pat if c in _WILDS)
            if n_wild == len(pat):
                # just wilds: the keyword drops entirely
                return None
            if n_wild == 0:
                return QTerm(pat, node.fields, zones=node.zones,
                             field_start=node.field_start,
                             field_end=node.field_end,
                             max_field_pos=node.max_field_pos)
            lim = crc_field_limit(pat)
            efields = node.fields
            if lim is not None:
                efields = (lim if node.fields is None
                           else tuple(f for f in node.fields
                                      if f.lower() in lim))
                if not efields:
                    # no field carries the needed substring index: the
                    # pattern matches nothing (crc term absent)
                    if expanded_out is not None:
                        expanded_out[pat] = []
                    return QTerm(pat, node.fields, zones=node.zones,
                                 field_start=node.field_start,
                                 field_end=node.field_end,
                                 max_field_pos=node.max_field_pos)
            matches = _expansion_terms(pat, term_strs, min_prefix,
                                       min_infix, expansion_limit,
                                       exact_forms=exact_forms)
            if expanded_out is not None:
                expanded_out[pat] = list(matches or ())
            if not matches:
                return QTerm(pat, efields, zones=node.zones,
                             field_start=node.field_start,
                             field_end=node.field_end,
                             max_field_pos=node.max_field_pos)  # df=0
            if len(matches) == 1:
                return QTerm(matches[0], efields, boost=node.boost,
                             zones=node.zones, expanded=pat,
                             field_start=node.field_start,
                             field_end=node.field_end,
                             max_field_pos=node.max_field_pos)
            return QOr(tuple(QTerm(m, efields, boost=node.boost,
                                   zones=node.zones, expanded=pat,
                                   field_start=node.field_start,
                                   field_end=node.field_end,
                                   max_field_pos=node.max_field_pos)
                             for m in matches))
        if isinstance(node, QPhrase) and enabled \
                and any(any(c in _WILDS for c in w) for w in node.words):
            # wildcard inside a phrase: the member expands against the
            # dict and the phrase becomes an OR over the variants (the
            # reference's star-dict qword unions the expansions at the
            # member level; the variant OR is equivalent for matching and
            # exact for single-expansion members). A member with no
            # expansions keeps an impossible sentinel (phrase matches
            # nothing but other members still report stats).
            import itertools
            alt_lists: list[list[str]] = []
            for w in node.words:
                if any(c in _WILDS for c in w):
                    matches = _expansion_terms(
                        w, term_strs, min_prefix, min_infix,
                        expansion_limit, exact_forms=exact_forms) or []
                    if expanded_out is not None:
                        expanded_out[w] = list(matches)
                    alt_lists.append(list(matches) or ["\x00"])
                else:
                    alt_lists.append([w])
            n_var = 1
            for al in alt_lists:
                n_var *= len(al)
            if n_var > 36:
                raise NotImplementedError(
                    "phrase wildcard expansion too wide; raise "
                    "expansion_limit granularity")
            variants = [
                QPhrase(tuple(c), node.fields, node.proximity,
                        node.positions)
                for c in itertools.product(*alt_lists)
            ]
            if len(variants) == 1:
                return variants[0]
            return QOr(tuple(variants))
        if isinstance(node, QAnd):
            return QAnd(tuple(c2 for c in node.children
                              if (c2 := rec(c)) is not None))
        if isinstance(node, QOr):
            return QOr(tuple(c2 for c in node.children
                             if (c2 := rec(c)) is not None))
        if isinstance(node, QAndNot):
            left = rec(node.left)
            right = rec(node.right)
            if left is None:
                return None
            if right is None:
                return left
            return QAndNot(left, right)
        if isinstance(node, QMaybe):
            left = rec(node.left)
            right = rec(node.right)
            if left is None:
                return None
            if right is None:
                return left
            return QMaybe(left, right)
        return node

    return rec(node)


class _SlotTable:
    """Unique (term, field-limit-mask) -> slot. The same word limited to
    different fields is a different qword (XQLimitSpec_t is part of node
    identity in the reference)."""

    def __init__(self, all_fields_mask: int, mask_of):
        self.slots: dict[tuple, int] = {}
        self.terms: list[str] = []
        self.masks: list[int] = []
        self.flags: list[tuple] = []   # (field_start, field_end) per slot
        self.zones: list[tuple] = []   # zone-name tuple per slot
        self.occ: list[list[int]] = []  # every occurrence's qpos per slot
        self.mult: list[float] = []
        self.first_boost: list[float] = []  # boost of the slot's first instance
        self.qpos: list[int] = []   # query atom position (m_iAtomPos), 1-based
        self._cursor = 0            # advances per leaf occurrence
        self.groups: list[tuple] = []   # payload merge groups (slot tuples)
        self.all_mask = all_fields_mask
        self.mask_of = mask_of
        self.warnings: list[str] = []
        self.hitless = lambda w: False   # plan_query installs the real one
        self.dead_stats: set[int] = set()   # slots excluded from word stats

    def skip(self, span: int = 1) -> None:
        """Advance the atom-position cursor without emitting a slot
        (stopped keywords consume positions: stopword_step)."""
        self._cursor += max(1, span)

    def get(self, term: str, fields, positive: bool, weight: float = 1.0,
            field_start: bool = False, field_end: bool = False,
            zones: tuple = (), advance: bool = True,
            span: int = 1, max_field_pos: int = 0) -> int:
        if advance:
            self._cursor += 1
        pos = self._cursor
        if (field_start or field_end or zones or max_field_pos) \
                and self.hitless(term):
            # positional modifiers on a hitless word are dropped with a
            # warning (ExtNode_i::Create, searchnode.cpp:1151-1155)
            if "hitlist unavailable, position limit ignored" \
                    not in self.warnings:
                self.warnings.append(
                    "hitlist unavailable, position limit ignored")
            field_start = field_end = False
            zones = ()
            max_field_pos = 0
        if advance:
            # a blended chunk's qpos is its first position, but the
            # cursor advances over the parts' positions too
            # (m_iAtomPos advances per tokenizer position)
            self._cursor += max(1, span) - 1
        mask = self.mask_of(fields)
        key = (term, mask, field_start, field_end, zones, max_field_pos)
        if key in self.slots:
            s = self.slots[key]
            self.occ[s].append(pos)
        else:
            s = len(self.terms)
            self.slots[key] = s
            self.terms.append(term)
            self.masks.append(mask)
            self.flags.append((field_start, field_end, max_field_pos))
            self.zones.append(tuple(zones))
            self.mult.append(0.0)
            self.first_boost.append(weight)
            self.qpos.append(pos)
            self.occ.append([pos])
        if positive:
            self.mult[s] += weight
        return s


def _idf_by_qpos(S, st, idf, slot_fold):
    out = np.zeros(66, np.float32)
    for s2 in range(S):
        base = float(idf[slot_fold[s2]])
        if base == 0.0:
            base = float(idf[s2])
        for o in st.occ[s2]:
            if 0 < o < len(out):
                out[o] = base if base != 0.0 else out[o]
    return out


def _lower(node, st: _SlotTable, positive: bool):
    """AST -> plan expr tuple, assigning slots."""
    if isinstance(node, QAll) or node is None:
        return ("all",)
    if isinstance(node, QGap):
        # stopped atom: consumes query positions, matches nothing
        # (m_iAtomPos advances over stopwords; node itself is NULL)
        st.skip(node.span)
        return None
    if isinstance(node, QTerm):
        s = st.get(node.word, node.fields, positive, node.boost,
                   node.field_start, node.field_end, node.zones,
                   span=getattr(node, "atom_span", 1),
                   max_field_pos=getattr(node, "max_field_pos", 0))
        return ("term", s)
    if isinstance(node, QAnd):
        kids = tuple(k for k in (_lower(c, st, positive)
                                 for c in node.children) if k is not None)
        if not kids:
            return None
        return kids[0] if len(kids) == 1 else ("and", kids)
    if isinstance(node, QOr):
        # an OR whose children are all expansions of ONE wildcard pattern is
        # the reference's payload term-merge node (BuildExpandedTree +
        # ExtPayload, sphinx.cpp:14880): the expansions share the original
        # atom position and rank as a single merged qword
        pats = {c.expanded for c in node.children
                if isinstance(c, QTerm)} if node.children else set()
        if len(pats) == 1 and "" not in pats \
                and all(isinstance(c, QTerm) for c in node.children) \
                and not any(c.zones for c in node.children):
            slots = []
            for i, c in enumerate(node.children):
                s = st.get(c.word, c.fields, positive, c.boost,
                           c.field_start, c.field_end, c.zones,
                           advance=(i == 0))
                slots.append(s)
            uniq = tuple(dict.fromkeys(slots))
            if len(uniq) > 1:
                st.groups.append(uniq)
            return ("or", tuple(("term", s) for s in uniq))
        return ("or", tuple(_lower(c, st, positive) for c in node.children))
    if isinstance(node, QAndNot):
        return ("andnot", _lower(node.left, st, positive),
                _lower(node.right, st, False))
    if isinstance(node, QMaybe):
        # MAYBE: matching follows the left arm; the right arm's hits and
        # tfidf contribute to rank when present (ExtMaybe, searchnode.cpp)
        lo = _lower(node.left, st, positive)
        ro = _lower(node.right, st, positive)
        if lo is None:
            return ro
        if ro is None:
            return lo
        return ("maybe", lo, ro)
    if isinstance(node, QQuorum):
        # quorum needs no hitlists (CreateMultiNode bNeedsHitlist=false,
        # searchnode.cpp:1661): hitless members participate normally
        slots = tuple(st.get(w, node.fields, positive) for w in node.words)
        if node.m >= len(node.words):
            # over-threshold quorum degrades to plain AND at execution
            # (ExtNode creation; the SHOW PLAN tree keeps QUORUM(count=N))
            return ("and", tuple(("term", s2) for s2 in slots))
        return ("quorum", slots, node.m)
    if isinstance(node, QPhrase):
        slots = tuple(st.get(w, node.fields, positive) for w in node.words)
        deltas = node.positions or tuple(range(len(slots)))
        if any(st.hitless(w) for w in node.words):
            # partition: the phrase runs over the words that still carry
            # hitlists (ORIGINAL positions kept, so gaps stay), ANDed
            # with the hitless words as plain terms; under two positional
            # atoms the node can't exist (searchnode.cpp:1000-1010
            # 'can't create phrase node, hitlists unavailable')
            keep = [i2 for i2, w in enumerate(node.words)
                    if not st.hitless(w)]
            if len({deltas[i2] for i2 in keep}) < 2:
                st.warnings.append(
                    f"can't create phrase node, hitlists unavailable "
                    f"(hitlists={len(keep)}, nodes={len(node.words)})")
                # the reference deletes the node's qwords before stats
                # collection: none of the phrase's words report stats
                st.dead_stats.update(slots)
                return ("term", st.get("\x00", None, False))
            p_slots = tuple(slots[i2] for i2 in keep)
            p_deltas = tuple(deltas[i2] for i2 in keep)
            core = (("proximity", p_slots, node.proximity, p_deltas)
                    if node.proximity else ("phrase", p_slots, p_deltas))
            hl_slots = tuple(slots[i2] for i2 in range(len(slots))
                             if i2 not in keep)
            return ("and", (core,) + tuple(("term", s2)
                                           for s2 in hl_slots))
        if node.proximity:
            return ("proximity", slots, node.proximity, deltas)
        return ("phrase", slots, deltas)
    if isinstance(node, QNear):
        def _nd_words(nd):
            if isinstance(nd, QTerm):
                return [nd.word]
            if isinstance(nd, QPhrase):
                return list(nd.words)
            if isinstance(nd, QNear):
                return _nd_words(nd.left) + _nd_words(nd.right)
            return []
        if any(st.hitless(w)
               for w in _nd_words(node.left) + _nd_words(node.right)):
            # CreateOrderNode: any hitless child kills the whole node
            # (searchnode.cpp:1057 'failed to create order node,
            # hitlist unavailable')
            st.warnings.append(
                "failed to create order node, hitlist unavailable")
            return ("term", st.get("\x00", None, False))
        if isinstance(node.left, QGap) or isinstance(node.right, QGap):
            if isinstance(node.left, QGap):
                st.skip(node.left.span)
                return _lower(node.right, st,
                              positive and not node.not_near)
            st.skip(node.right.span)
            return _lower(node.left, st, positive)
        if isinstance(node.left, QTerm) and isinstance(node.right, QTerm):
            sa = st.get(node.left.word, node.left.fields, positive)
            sb = st.get(node.right.word, node.right.fields,
                        positive and not node.not_near)
            return ("near", (sa, sb), node.n, node.not_near)

        # general operands: phrases and nested NEAR chains
        # (searchnode.cpp FSMmultinear over arbitrary child nodes)
        def op_desc(nd, pos_flag):
            if isinstance(nd, QTerm):
                s = st.get(nd.word, nd.fields, pos_flag, nd.boost,
                           nd.field_start, nd.field_end, nd.zones)
                return ("slot", (s,), 1)
            if isinstance(nd, QPhrase) and not nd.proximity:
                slots = tuple(st.get(w, nd.fields, pos_flag)
                              for w in nd.words)
                return ("phrase", slots, len(slots))
            if isinstance(nd, QNear) and not nd.not_near:
                sub = _lower(nd, st, pos_flag)
                span = sub[4][2] if len(sub) > 4 else 1
                return ("nearsub", sub, span)
            raise NotImplementedError(
                "NEAR operands must be keywords, phrases, or NEAR chains")
        ld = op_desc(node.left, positive)
        rd = op_desc(node.right, positive and not node.not_near)
        all_slots = tuple(_desc_slots(ld)) + tuple(_desc_slots(rd))
        return ("near", all_slots, node.n, node.not_near, ld, rd)
    if isinstance(node, QSentence):
        if not (isinstance(node.left, QTerm) and isinstance(node.right, QTerm)):
            raise NotImplementedError(
                "SENTENCE/PARAGRAPH between non-keyword operands lands later")
        if st.hitless(node.left.word) or st.hitless(node.right.word):
            st.warnings.append(
                "failed to create order node, hitlist unavailable")
            return ("term", st.get("\x00", None, False))
        sa = st.get(node.left.word, node.left.fields, positive)
        sb = st.get(node.right.word, node.right.fields, positive)
        return ("paragraph" if node.paragraph else "sentence", (sa, sb))
    raise NotImplementedError(f"AST node {type(node).__name__}")


def plan_query(
    ast_root,
    index,                      # PackedIndex
    *,
    filters: list[AttrFilterDef] | None = None,
    filter_tree: tuple | None = None,
    ranker: str = "proximity_bm25",
    max_matches: int = 1000,
    window: int | None = None,   # offset+limit: device keeps only this many
    order: tuple = ("rel",),
    field_weights: dict[str, int] | None = None,
    idf_plain: bool = False,
    tfidf_normalized: bool = True,
    total_docs_override: int | None = None,
    local_df: dict[str, int] | None = None,
    emit_factors: bool = False,
    expansion_limit: int = 0,
    packed_store=None,          # ops.packed_store.PackedStore of `index`
    boolean_simplify: bool = False,
    expand_keywords: bool = False,
    collation: str = "binary",
) -> CompiledQuery:
    node = simplify(ast_root)
    if node is not None and expand_keywords:
        node = expand_keywords_ast(node, index)
    if node is not None and boolean_simplify:
        node = simplify(transform_boolean_simplify(node))
    expanded_records: dict[str, list[str]] = {}
    if node is not None:
        pre_expand = node
        node = expand_wildcards(node, index, expansion_limit,
                                expanded_out=expanded_records)
        if node is None:
            # every keyword dropped during expansion (e.g. lone '*'):
            # matches NOTHING — not a fullscan (the reference's empty
            # transformed tree)
            node = QTerm(word="\x00")
            del pre_expand
    if node is None:
        node = QAll()

    all_mask = index.schema.field_mask(None) if index.schema.n_fields else 1

    def mask_of(fields):
        if fields is None:
            return all_mask
        return index.schema.field_mask(list(fields))

    st = _SlotTable(all_mask, mask_of)
    _hl_set = getattr(index, "hitless_terms", frozenset()) or frozenset()
    _hl_all = bool(getattr(index, "hitless_all", False))
    if _hl_all or _hl_set:
        st.hitless = lambda w: _hl_all or w in _hl_set
    expr = _lower(node, st, True)

    # bigram fast path (sphinx.cpp bigram indexing): a qualifying 2-word
    # phrase is answered by the "w1 w2" pair term's hit list — anchors are
    # identical to the phrase FSM's, so match/tf/rank emission are exact
    _ts = getattr(index, "tokenizer_settings", None)
    bmode = getattr(_ts, "bigram_index", "") if _ts is not None else ""
    bigram_slots: set = set()
    if bmode:
        bfreq = set(getattr(_ts, "bigram_freq_words", ()))

        def _bg(e):
            if e[0] == "phrase" and len(e[1]) == 2 \
                    and (len(e) < 3 or e[2] == (0, 1)):
                sa, sb = e[1]
                wa, wb = st.terms[sa], st.terms[sb]
                qual = (bmode == "all"
                        or (bmode == "first_freq" and wa in bfreq)
                        or (bmode == "both_freq" and wa in bfreq
                            and wb in bfreq))
                plain = (st.masks[sa] == all_mask
                         and st.masks[sb] == all_mask
                         and st.flags[sa] == (False, False, 0)
                         and st.flags[sb] == (False, False, 0)
                         and not st.zones[sa] and not st.zones[sb])
                if qual and plain:
                    bslot = st.get(f"{wa} {wb}", None, True)
                    bigram_slots.add(bslot)
                    return ("bigram_phrase", e[1], bslot)
                return e
            if e[0] in ("and", "or"):
                return (e[0], tuple(_bg(c) for c in e[1]))
            if e[0] in ("andnot", "maybe"):
                return (e[0], _bg(e[1]), _bg(e[2]))
            return e
        expr = _bg(expr)
    S = len(st.terms)
    if S > 127:
        # the ranker hit stream packs the slot id into 7 bits
        # (ops/search.py payload layout); the reference's analogous guard
        # is expansion_limit on wildcard blow-ups (sphinx.cpp:15021)
        raise NotImplementedError(
            f"{S} unique query terms; maximum is 127 — set expansion_limit "
            "to bound wildcard expansion")

    total_docs = total_docs_override if total_docs_override is not None \
        else index.n_docs

    starts = np.zeros(max(S, 1), np.int32)
    lengths = np.zeros(max(S, 1), np.int32)
    hit_starts = np.zeros(max(S, 1), np.int32)
    hit_lengths = np.zeros(max(S, 1), np.int32)
    idf = np.zeros(max(S, 1), np.float32)
    mult = np.ones(max(S, 1), np.float32)
    slot_df: list[int] = []
    slot_hits: list[int] = []

    # hQwords is keyed by word -> unique count; bigram pair terms are
    # matching machinery, not query words (ranking parity with the
    # non-bigram index requires excluding them). All expansions of one
    # wildcard pattern count as ONE query word: the reference's payload
    # term-merge node is a single hQwords entry (sphExpandXQNode,
    # sphinx.cpp:14880-14912)
    term2pat = {t: p for p, terms in expanded_records.items() for t in terms}
    _seen_keys: set[str] = set()
    n_qwords = 0
    word_dupe = [False] * S          # slot is a 2nd+ instance of its word
    for _s in range(S):
        if _s in bigram_slots:
            continue
        _key = term2pat.get(st.terms[_s], st.terms[_s])
        if _key in _seen_keys:
            # duplicate qword: the reference's ExtTerm_T::GetQwords leaves
            # m_fIDF = 0 for every instance after the first
            # (searchnode.cpp:2030-2037), so dupes contribute NO tfidf
            word_dupe[_s] = True
        else:
            _seen_keys.add(_key)
            n_qwords += 1
    slot_packed: list = []
    pk_starts = np.zeros((max(S, 1), 3), np.int32)
    for s, term in enumerate(st.terms):
        tid = index.term_id(term)
        if tid >= 0:
            t0, t1 = int(index.term_offsets[tid]), int(index.term_offsets[tid + 1])
            df = int(index.term_docs[tid])
            th = int(index.term_hits[tid])
        else:
            t0 = t1 = df = th = 0
        if packed_store is not None:
            from ..ops.packed_store import CLASSES
            tc = packed_store.term_class[tid] if tid >= 0 else None
            if tc is not None and tc[0] > 0:
                slot_packed.append(tuple(CLASSES[c - 1] for c in tc))
                pk_starts[s] = packed_store.term_start[tid]
                starts[s] = 0
            else:
                slot_packed.append((0, 0, 0))
                starts[s] = (int(packed_store.res_offsets[tid])
                             if tid >= 0 else 0)
            lengths[s] = t1 - t0
            hit_starts[s] = int(index.post_hit_offset[t0]) if t1 > t0 else 0
            hit_lengths[s] = (int(index.post_hit_offset[t1])
                              - int(index.post_hit_offset[t0]))                 if t1 > t0 else 0
            eff_df = local_df.get(term, df) if local_df else df
            idf[s] = compute_idf(eff_df, total_docs, plain=idf_plain,
                                 normalized_tfidf=tfidf_normalized,
                                 n_qwords=n_qwords)
            mult[s] = 0.0 if word_dupe[s] else (
                st.first_boost[s] if st.mult[s] > 0 else 1.0)
            slot_df.append(df)
            slot_hits.append(th)
            continue
        starts[s] = t0
        lengths[s] = t1 - t0
        hit_starts[s] = int(index.post_hit_offset[t0]) if t1 > t0 else 0
        hit_lengths[s] = (int(index.post_hit_offset[t1]) - int(index.post_hit_offset[t0])) if t1 > t0 else 0
        eff_df = local_df.get(term, df) if local_df else df
        idf[s] = compute_idf(eff_df, total_docs, plain=idf_plain,
                             normalized_tfidf=tfidf_normalized,
                             n_qwords=n_qwords)
        mult[s] = 0.0 if word_dupe[s] else (
            st.first_boost[s] if st.mult[s] > 0 else 1.0)
        slot_df.append(df)
        slot_hits.append(th)

    # word stats for SHOW META / the API words block: expansions aggregate
    # under their original starred pattern with SUMMED dict docs/hits
    # (AddStat of the root word with tWordlist totals, sphinx.cpp:14873)
    stat_list: list[tuple[str, int, int]] = []
    _emitted: set[str] = set()
    for s in range(S):
        t = st.terms[s]
        if t == "\x00":
            continue   # dropped-keywords sentinel: no stat (the reference
            #            reports no words for a fully-dropped query)
        if s in st.dead_stats:
            continue   # qwords of a hitless-killed phrase node: deleted
            #            before stats collection (searchnode.cpp:1005)
        p = term2pat.get(t)
        if p is None:
            if t in _emitted:
                continue   # one stat per unique word (AddStat hash
                #            unifies repeats: '^bbb | bbb$' reports once)
            _emitted.add(t)
            stat_list.append((t, slot_df[s], slot_hits[s]))
        elif p not in _emitted:
            _emitted.add(p)
            # expanded-pattern stats: dict=crc substring terms are real
            # dict entries, so the stat is the MERGED posting list's
            # DISTINCT doc count; dict=keywords sums the expanded terms'
            # dict dfs (AddStat with tWordlist totals, sphinx.cpp:14873;
            # golden test_161: crc 't*' = docs 2, keywords 't*' = docs 3)
            crc = getattr(getattr(index, "dict_settings", None),
                          "mode", "keywords") == "crc"
            # crc + prefix_fields/infix_fields: the substring terms only
            # exist for the allowed fields, so docs/hits count over the
            # FIELD-FILTERED hit stream (the crc dict entry holds only
            # those postings in the reference)
            _lm = st.masks[s] if st.masks[s] != st.all_mask and crc \
                else 0
            shits = 0
            sdocs = 0
            rowsets = []
            for et in expanded_records[p]:
                etid = index.term_id(et)
                if etid >= 0:
                    o0 = int(index.term_offsets[etid])
                    o1 = int(index.term_offsets[etid + 1])
                    if _lm:
                        h0 = int(index.post_hit_offset[o0])
                        h1 = int(index.post_hit_offset[o1])
                        hf = (np.asarray(index.hit_packed[h0:h1])
                              >> 24) & 0xFF
                        okh = ((1 << hf.astype(np.int64)) & _lm) != 0
                        shits += int(okh.sum())
                        hrows = np.repeat(
                            index.post_rowid[o0:o1],
                            np.diff(index.post_hit_offset[o0:o1 + 1]))
                        rowsets.append(np.unique(hrows[okh]))
                        continue
                    shits += int(index.term_hits[etid])
                    if crc:
                        rowsets.append(index.post_rowid[o0:o1])
                    else:
                        sdocs += int(index.term_docs[etid])
            if crc and rowsets:
                sdocs = int(np.unique(np.concatenate(rowsets)).size)
            stat_list.append((p, sdocs, shits))
    # patterns that expanded to nothing still report a (0,0) stat under
    # their starred form (AddStat on the empty expansion, sphinx.cpp:14865)
    for p, terms in expanded_records.items():
        if not terms and p not in _emitted:
            _emitted.add(p)
            stat_list.append((p, 0, 0))

    # hit-conditional slots (field limits / ^field-start / field-end$):
    # evaluated over hits; the kernel skips them in the posting pass.
    # entries: (slot, fieldmask, field_start, field_end)
    slot_limited = tuple(
        (s, st.masks[s], st.flags[s][0], st.flags[s][1], st.zones[s],
         st.flags[s][2])
        for s in range(S)
        if st.masks[s] != all_mask or st.flags[s][0] or st.flags[s][1]
        or st.zones[s] or st.flags[s][2]
    )

    # ranker resolution (sphCreateRanker:4167): single-keyword
    # proximity/proximity_bm25 queries shortcut to WeightSum (identical
    # result for one keyword: lcs[f] is 1 wherever the field matched);
    # fullscan matches get weight = index_weight (sphinx.cpp:12840) which
    # the 'none' ranker produces
    has_positional = _has_positional(expr)
    if ranker == "sph04":
        # SPH_RANK_SPH04 (sphinxsearch.cpp RankerState_Proximity_fn with
        # field-start/exact-hit boosts); equals the documented formula
        ranker = ("expr", "sum((4*lcs+2*(min_hit_pos==1)+exact_hit)"
                          "*user_weight)*1000+bm25")
    if emit_factors and ranker == "proximity_bm25":
        # PACKEDFACTORS() with the default ranker: run the expr ranker
        # with the equivalent formula so factors are materialized
        # (the reference collects factors under any ranker)
        ranker = ("expr", "sum(lcs*user_weight)*1000+bm25")
    eff_ranker = ranker
    ranker_expr: tuple = ()
    if isinstance(ranker, tuple) and ranker[0] == "expr":
        from .expr import parse_expr as _parse_expr
        tree = _parse_expr(ranker[1])
        ranker_expr = _resolve_fieldmaps(tree, index.schema)
        eff_ranker = "expr"
    elif expr[0] == "all":
        eff_ranker = "none"
    elif ranker == "proximity_bm25":
        # m_bSingleWord (sphinxquery.cpp:2014) counts keyword INSTANCES:
        # "go go" is two keywords (dupes ranker), not the WeightSum path
        single = (not has_positional and S <= 1
                  and all(len(o) <= 1 for o in st.occ))
        eff_ranker = "ws_bm25" if single else "proximity_bm25"
    elif ranker == "proximity":
        single = (not has_positional and S <= 1
                  and all(len(o) <= 1 for o in st.occ))
        eff_ranker = "ws" if single else "proximity"
    elif ranker == "bm25":
        eff_ranker = "ws_bm25"
    elif ranker in ("none", "fieldmask", "wordcount", "matchany"):
        eff_ranker = ranker
    else:
        raise NotImplementedError(f"ranker {ranker!r}")

    fspecs = []
    fvals = []
    for f in filters or []:
        ad = index.schema.attr(f.attr)
        if ad is None and "." in f.attr:
            base = f.attr.split(".", 1)[0]
            bad = index.schema.attr(base)
            if bad is not None and bad.type.value == "json":
                # JSON-path filter: evaluated host-side over the parsed
                # JSON column into a packed row bitmask the kernel ANDs in
                # (the reference also evaluates JSON filters per-row on the
                # CPU — sphinxfilter.cpp JSON filter expressions)
                bits = _eval_json_filter(index, base, f)
                nw = bits.shape[0]
                fspecs.append(FilterSpec(f.attr, "host_mask", f.exclude,
                                         n_values=nw))
                fvals.append(bits)
                continue
        if ad is None and f.attr != "id":
            raise ValueError(f"unknown attr {f.attr!r} in filter")
        if ad is not None and ad.type.value == "string":
            # collation: utf8_general_ci compares case-folded
            # (CollateUtf8GeneralCI, sphinxstd collations); the device
            # column switches to the case-folded ordinal twin
            ci = collation in ("utf8_general_ci", "utf8_ci",
                               "libc_ci")
            uniq, lookup, _ = index.str_ordinals(f.attr, ci=ci)
            dev_attr = f.attr + "\x00ci" if ci else f.attr

            def _fold(v):
                return str(v).casefold() if ci else str(v)
            if f.kind == "values":
                ords = sorted(lookup.get(_fold(v), -1) for v in f.values)
                nv = _next_pow2(len(ords), 1)
                arr = np.asarray(ords + [ords[-1]] * (nv - len(ords)),
                                 np.int32)
                fspecs.append(FilterSpec(dev_attr, "values", f.exclude,
                                         n_values=nv))
                fvals.append(arr)
            elif f.kind in ("range_i", "range_f"):
                import bisect as _bisect
                lo = 0
                if f.lo is not None:
                    lo = (_bisect.bisect_right(uniq, _fold(f.lo))
                          if f.lo_excl
                          else _bisect.bisect_left(uniq, _fold(f.lo)))
                hi = len(uniq) - 1
                if f.hi is not None:
                    hi = (_bisect.bisect_left(uniq, _fold(f.hi))
                          if f.hi_excl
                          else _bisect.bisect_right(uniq, _fold(f.hi))) - 1
                fspecs.append(FilterSpec(dev_attr, "range_i", f.exclude))
                fvals.append(np.asarray([lo, hi], np.int32))
            else:
                raise NotImplementedError(
                    f"filter kind {f.kind} on string attr {f.attr!r}")
            continue
        f_kind = f.kind
        if ad is not None and ad.type.value in ("multi", "multi64"):
            # generic conds on MVA attrs get ANY semantics (reference
            # default for MVA filters, sphinxfilter.cpp Filter_MVAValues)
            f_kind = {"values": "mva_any", "range_i": "mva_any_range",
                      "range_f": "mva_any_range"}.get(f_kind, f_kind)
        if f_kind.startswith("mva_"):
            if f_kind in ("mva_any", "mva_all", "mva_subset"):
                vals = sorted(int(v) for v in f.values)
                nv = _next_pow2(len(vals), 1)
                arr = np.asarray(vals + [vals[-1]] * (nv - len(vals)),
                                 np.int32)
                fspecs.append(FilterSpec(f.attr, f_kind, f.exclude,
                                         n_values=nv))
                fvals.append(arr)
            else:
                lo = -(2**31) if f.lo is None else int(f.lo) + (1 if f.lo_excl else 0)
                hi = 2**31 - 1 if f.hi is None else int(f.hi) - (1 if f.hi_excl else 0)
                fspecs.append(FilterSpec(f.attr, f_kind, f.exclude))
                fvals.append(np.asarray([lo, hi], np.int32))
            continue
        if f.attr == "id" and f.kind in ("values", "range_i"):
            # document ids are 64-bit; the device carries them as an i32
            # (hi = id>>32, lo = (id&0xffffffff)-2^31) pair — the bias
            # makes signed lexicographic compare exact over [0, 2^63)
            def _split(v: int) -> tuple[int, int]:
                v = max(0, min(int(v), (1 << 63) - 1))
                return v >> 32, (v & 0xFFFFFFFF) - (1 << 31)
            if f.kind == "values":
                vals = sorted(int(v) for v in f.values)
                nv = _next_pow2(len(vals), 1)
                vals = vals + [vals[-1]] * (nv - len(vals))
                sp = [_split(v) for v in vals]
                arr = np.asarray([[h for h, _ in sp],
                                  [l for _, l in sp]], np.int32)
                fspecs.append(FilterSpec("id", "id_values", f.exclude,
                                         n_values=nv))
            else:
                lo = 0 if f.lo is None else int(f.lo) + (1 if f.lo_excl else 0)
                hi = (1 << 63) - 1 if f.hi is None else \
                    min(int(f.hi) - (1 if f.hi_excl else 0), (1 << 63) - 1)
                (lh, ll), (hh, hl) = _split(lo), _split(hi)
                arr = np.asarray([[lh, hh], [ll, hl]], np.int32)
                fspecs.append(FilterSpec("id", "id_range", f.exclude))
            fvals.append(arr)
            continue
        _ad0 = index.schema.attr(f.attr)
        _usgn = _ad0 is not None and _ad0.type.value in (
            "uint", "timestamp", "bool")
        if _ad0 is not None and _ad0.type.value == "bigint" \
                and f.kind in ("values", "range_i"):
            # 64-bit attr filters compare over the (hi, biased-lo) split
            def _split64(v: int) -> tuple[int, int]:
                v = max(-(2**63), min(int(v), 2**63 - 1))
                return v >> 32, (v & 0xFFFFFFFF) - (1 << 31)
            if f.kind == "values":
                vals = sorted(int(v) for v in f.values)
                nv = _next_pow2(len(vals), 1)
                vals = vals + [vals[-1]] * (nv - len(vals))
                sp = [_split64(v) for v in vals]
                fspecs.append(FilterSpec(f.attr, "big_values", f.exclude,
                                         n_values=nv))
                fvals.append(np.asarray([[h for h, _ in sp],
                                         [l for _, l in sp]], np.int32))
            else:
                lo = -(2**63) if f.lo is None \
                    else int(f.lo) + (1 if f.lo_excl else 0)
                hi = 2**63 - 1 if f.hi is None \
                    else int(f.hi) - (1 if f.hi_excl else 0)
                (lh, ll), (hh, hl) = _split64(lo), _split64(hi)
                fspecs.append(FilterSpec(f.attr, "big_range", f.exclude))
                fvals.append(np.asarray([[lh, hh], [ll, hl]], np.int32))
            continue

        def _wrap32(v: int) -> int:
            v &= 0xFFFFFFFF
            return v - (1 << 32) if v >= (1 << 31) else v

        def _ubias(v: int) -> int:
            # unsigned order -> signed order: flip the sign bit
            return _wrap32(int(v) ^ 0x80000000)
        if f.kind == "values":
            if _usgn:
                vals = sorted(_wrap32(int(v)) for v in f.values)
            else:
                vals = sorted(int(v) for v in f.values)
            nv = _next_pow2(len(vals), 1)
            arr = np.asarray(vals + [vals[-1]] * (nv - len(vals)), np.int32)
            fspecs.append(FilterSpec(f.attr, "values", f.exclude, n_values=nv))
            fvals.append(arr)
        elif f.kind == "range_i" and _usgn:
            # uint attrs compare UNSIGNED (sphinxfilter Filter_Range on
            # 32-bit uints; golden test_322 gid=4294967295 > 1000): the
            # kernel bias-flips the attr, bounds pre-flip here
            lo_u = 0 if f.lo is None else int(f.lo) + (1 if f.lo_excl else 0)
            hi_u = (1 << 32) - 1 if f.hi is None                 else int(f.hi) - (1 if f.hi_excl else 0)
            lo_u = max(0, min(lo_u, (1 << 32) - 1))
            hi_u = max(-1, min(hi_u, (1 << 32) - 1))
            fspecs.append(FilterSpec(f.attr, "range_i", f.exclude,
                                     usgn=True))
            fvals.append(np.asarray([_ubias(lo_u),
                                     _ubias(hi_u) if hi_u >= 0
                                     else -(2**31)], np.int32))
        elif f.kind == "range_i":
            lo = -(2**31) if f.lo is None else int(f.lo) + (1 if f.lo_excl else 0)
            hi = 2**31 - 1 if f.hi is None else int(f.hi) - (1 if f.hi_excl else 0)
            fspecs.append(FilterSpec(f.attr, "range_i", f.exclude))
            fvals.append(np.asarray([lo, hi], np.int32))
        elif f.kind == "range_f":
            lo = -np.inf if f.lo is None else float(f.lo)
            hi = np.inf if f.hi is None else float(f.hi)
            fspecs.append(FilterSpec(f.attr, "range_f", f.exclude,
                                     lo_excl=f.lo_excl, hi_excl=f.hi_excl))
            fvals.append(np.asarray([lo, hi], np.float32))
        else:
            raise NotImplementedError(f"filter kind {f.kind}")

    F = index.schema.n_fields
    fw = np.ones(max(F, 1), np.int32)
    for name, w in (field_weights or {}).items():
        fw[index.schema.field_id(name)] = int(w)

    qpos = np.zeros(max(S, 1), np.int32)
    for s in range(S):
        qpos[s] = st.qpos[s]
    # dupe folding (m_dTermDupes, sphinxsearch.cpp SetTermDupes): factor
    # accounting folds every instance of a word onto its FIRST instance
    qpos_fold = qpos.copy()
    slot_fold = np.arange(max(S, 1), dtype=np.int32)
    _first_of: dict[str, int] = {}
    for s in range(S):
        key2 = term2pat.get(st.terms[s], st.terms[s])
        f0s = _first_of.setdefault(key2, s)
        slot_fold[s] = f0s
        qpos_fold[s] = st.qpos[f0s]

    # per-slot bucket sizes (pow2): each slot's CSR range is pulled with one
    # contiguous dynamic_slice of this static size (ops/search.py); min 1024
    # bounds plan-shape diversity
    slot_pb = tuple(_next_pow4(int(lengths[s]), 1024) for s in range(S))
    slot_hb = tuple(_next_pow4(int(hit_lengths[s]), 1024) for s in range(S))
    # zone span arrays, shipped through the runtime in slot_limited order
    # (one (rows, start_keys, end_keys) triple per zone name per entry)
    zone_spans = []
    zone_max = 0
    index_zones = getattr(index, "zones", {}) or {}
    for entry in slot_limited:
        for zname in entry[4]:
            zr, zs, ze = index_zones.get(
                zname.lstrip("="), (np.zeros(0, np.int32),) * 3)
            nz = _next_pow2(max(len(zr), 1), 1)
            pad = nz - len(zr)
            big = np.full(pad, 2**31 - 1, np.int32)   # sentinel: matches no row
            zone_spans.append((
                np.concatenate([np.asarray(zr, np.int32), big]),
                np.concatenate([np.asarray(zs, np.int32), big]),
                np.concatenate([np.asarray(ze, np.int32),
                                np.zeros(pad, np.int32)]),
            ))
            zone_max = max(zone_max, nz)

    H = len(index.hit_packed)
    mva_max = max((len(v[1]) for v in getattr(index, "attrs_mva", {}).values()),
                  default=0)
    n_hit_iters = max(1, math.ceil(
        math.log2(max(H, mva_max, zone_max, 2)))) + 1

    k = min(max_matches, window) if window is not None else max_matches
    k = max(1, min(k, index.n_docs)) if index.n_docs else 1

    # HANDLE_DUPES (sphinxsearch.cpp ExtRanker dupe handling): a keyword
    # occurring at several query positions emits its hits once per
    # occurrence into the ranker stream, so LCS chains can pass through
    # repeated words ("to be or not to be")
    slot_occs = tuple(tuple(st.occ[s]) for s in range(S))
    # HasQwordDupes (sphinxsearch.cpp:4178): same-slot multi-occurrence OR
    # distinct slots sharing one word string both select the dupes ranker
    has_dupes = (any(len(o) > 1 for o in slot_occs)
                 or any(word_dupe))
    if all(len(o) <= 1 for o in slot_occs):
        slot_occs = ()

    if emit_factors and eff_ranker != "expr":
        raise ValueError(
            "PACKEDFACTORS() requires OPTION ranker=expr('...')")

    # sparse candidate pipeline (skiplist economics, sphinx.cpp:8522):
    # evaluate over the union of the query terms' postings instead of dense
    # [N+1] accumulators whenever (a) the plan never needs a fullscan,
    # (b) the ranker runs in candidate space, and (c) the candidate bucket
    # total is meaningfully smaller than the corpus (else dense passes win).
    # MT_SPARSE=always|never overrides the size heuristic (tests).
    from .plan import expr_has_all
    B_total = int(sum(slot_pb))
    sparse_capable = (
        S > 0
        and not expr_has_all(expr)
        and eff_ranker in ("proximity_bm25", "proximity", "ws_bm25", "ws",
                           "none", "fieldmask", "wordcount", "matchany")
        and not emit_factors
        and B_total >= k
    )
    _mode = os.environ.get("MT_SPARSE", "auto")
    if index.schema.n_fields > 32:
        # wide-field indexes (multi-word fieldmask planes) stay on the
        # dense path: the packed store and candidate pipeline carry
        # single-word masks only
        _mode = "never"
    if _mode == "never":
        sparse = False
    elif _mode == "always":
        sparse = sparse_capable
    else:
        # measured on v5e @200k docs: the dense [N] scatter + top-k beats
        # the candidate sort until the corpus is large enough that the
        # dense passes dominate (config1 735 vs 503 qps dense-vs-sparse
        # at 200k); the union sort wins when cost tracks postings, i.e.
        # big N with a comparatively small candidate set
        sparse = (sparse_capable
                  and index.n_docs >= 400_000
                  and B_total <= max(index.n_docs // 4, 0))

    # filtered fullscan: pre-select candidates from a numeric attr's
    # secondary index instead of touching all N rows (the histogram /
    # filter-iterator economics, histogram.h:19, sphinx.cpp:12676-12692)
    scan_index = ""
    scan_bucket = 0
    scan_start = scan_len = 0
    # filter-first pre-selection (CreateFilteredIterator economics,
    # secondaryindex.h:36 + histogram selection, sphinx.cpp:15815):
    # MATCH-less fullscans always qualify; FT queries qualify when the
    # filter's candidate window is much smaller than the rarest term's
    # postings — then intersecting term postings against the window beats
    # walking the postings
    from .plan import RANKERS_WITH_HITS as _RWH
    _pos_slots_lens = [int(lengths[s]) for s in range(S)
                       if st.terms[s] != "\x00"]
    _min_df = min(_pos_slots_lens) if _pos_slots_lens else 0
    # hit-stream consumers (LCS rankers, positional nodes, field-limited
    # slots) need every hit row in the candidate set — true for the
    # posting-union pipeline, NOT for a filter window — so they stay on
    # the term-first path
    _ft_ok = (expr != ("all",) and _min_df > 0
              and eff_ranker not in _RWH
              and not _has_positional(expr)
              and not slot_limited and not st.groups)
    if (not sparse and not emit_factors and _mode != "never"
            and packed_store is not None and not filter_tree
            and (expr == ("all",) and eff_ranker == "none" or _ft_ok)):
        # (filter-first pre-selection assumes a CONJUNCTION: slicing one
        # filter's value window is wrong under an OR tree)
        for f in filters or []:
            if f.exclude or f.attr in ("id",):
                continue
            try:
                svals, _perm = index.attr_index(f.attr)
            except (KeyError, AttributeError):
                continue
            _ad1 = index.schema.attr(f.attr)
            if _ad1 is not None and _ad1.type.value in (
                    "uint", "timestamp", "bool"):
                big_bound = any(v is not None and abs(int(v)) >= (1 << 31)
                                for v in (f.lo, f.hi))
                has_wrapped = bool(svals.size) and int(svals[0]) < 0
                if big_bound or has_wrapped:
                    continue  # signed perm order != unsigned order
            if f.kind in ("range_i", "range_f"):
                lo = f.lo if f.lo is not None else -np.inf
                hi = f.hi if f.hi is not None else np.inf
                li = int(np.searchsorted(
                    svals, lo, "right" if f.lo_excl else "left"))
                hi_i = int(np.searchsorted(
                    svals, hi, "left" if f.hi_excl else "right"))
            elif f.kind == "values" and f.values:
                li = int(np.searchsorted(svals, min(f.values), "left"))
                hi_i = int(np.searchsorted(svals, max(f.values), "right"))
            else:
                continue
            size = max(hi_i - li, 0)
            ok = (size <= index.n_docs // 2 if expr == ("all",)
                  else size * 4 <= _min_df)
            if ok:
                scan_index = f.attr
                scan_bucket = _next_pow2(size, 1024)
                # shift the window start left if the bucket would run past
                # the permutation end — extra candidates are real rows
                # outside the value window; the filter kills them exactly
                scan_start = max(0, min(li, index.n_docs - scan_bucket))
                scan_len = min(scan_bucket,
                               max(index.n_docs - scan_start, 0),
                               (hi_i - scan_start))
                k = min(k, scan_bucket)
                sparse = True
                break

    # payload term-merge groups (ExtPayload, sphinx.cpp:14880): a group of
    # expansion slots ranks as ONE qword. The merged idf comes from the
    # UNION document count of the expansions' postings (the materialized
    # payload's m_iDocs); per-slot idf zeroes out so only the group
    # contributes tfidf.
    merge_groups = tuple(tuple(g) for g in st.groups)
    gidf = np.zeros(max(len(merge_groups), 1), np.float32)
    for gi, g in enumerate(merge_groups):
        # position/field-limited payloads recalculate df over the
        # FILTERED hit cache (PopulateCache "recalculate docs count",
        # searchnode.cpp:1415-1425; golden test_211 '^abc*' idf df=2)
        fs, fe, maxp = st.flags[g[0]]
        lmask = st.masks[g[0]]
        limited = fs or fe or maxp or (lmask != st.all_mask)
        rows_parts = []
        for s in g:
            tid = index.term_id(st.terms[s])
            if tid >= 0:
                g0 = int(index.term_offsets[tid])
                g1 = int(index.term_offsets[tid + 1])
                if limited:
                    h0 = int(index.post_hit_offset[g0])
                    h1 = int(index.post_hit_offset[g1])
                    hp = np.asarray(index.hit_packed[h0:h1])
                    hrows = np.repeat(
                        index.post_rowid[g0:g1],
                        np.diff(index.post_hit_offset[g0:g1 + 1]))
                    ok = np.ones(len(hp), bool)
                    if fs:
                        ok &= (hp & ((1 << 23) - 1)) == 1
                    if fe:
                        ok &= (hp & (1 << 23)) != 0
                    if lmask != st.all_mask:
                        fld = (hp >> 24) & 0xFF
                        ok &= ((np.int64(1) << fld.astype(np.int64))
                               & lmask) != 0
                    rows_parts.append(hrows[ok])
                else:
                    rows_parts.append(index.post_rowid[g0:g1])
            idf[s] = 0.0
        union_df = (int(np.unique(np.concatenate(rows_parts)).size)
                    if rows_parts else 0)
        if local_df:
            # distributed global-df: per-shard unions sum exactly (shards
            # partition rows); the sharded planner keys them by pattern
            pat = None
            for p, terms in expanded_records.items():
                if st.terms[g[0]] in terms:
                    pat = p
                    break
            if pat is not None and pat in local_df:
                union_df = local_df[pat]
        gidf[gi] = compute_idf(union_df, total_docs, plain=idf_plain,
                               normalized_tfidf=tfidf_normalized,
                               n_qwords=n_qwords)

    sig = PlanSig(
        fl_on=bool(getattr(index, "index_field_lengths", False)),
        expr=expr, n_slots=S, ranker=eff_ranker,
        filters=tuple(fspecs), k=k, order=order,
        filter_tree=tuple(filter_tree) if filter_tree else (),
        slot_limited=slot_limited, ranker_expr=ranker_expr,
        emit_factors=emit_factors, slot_occs=slot_occs,
        has_dupes=has_dupes,
        max_qpos=min(64, max([int(qpos[s2]) for s2 in range(S)]
                             + [int(o) for oc in (slot_occs or ())
                                for o in oc] + [0])),
        sparse=sparse,
        slot_packed=(tuple(slot_packed) if packed_store is not None
                     else ()),
        scan_index=scan_index, scan_bucket=scan_bucket,
        merge_groups=merge_groups,
    )
    fl = getattr(index, "field_lens", None)
    if fl is not None and getattr(fl, "size", 0):
        total_fl = np.asarray(fl, np.float64).sum(axis=0).astype(np.float32)
    else:
        total_fl = np.zeros(max(F, 1), np.float32)
    avg_dl = np.asarray(
        [float(total_fl.sum()) / max(total_docs, 1)], np.float32)

    runtime = {
        "starts": starts, "lengths": lengths,
        "total_field_lens": total_fl[:max(F, 1)],
        "total_docs": np.asarray([float(total_docs)], np.float32),
        "avg_doc_len": avg_dl,
        "hit_starts": hit_starts, "hit_lengths": hit_lengths,
        "qpos": qpos,
        "qpos_fold": qpos_fold,
        "slot_fold": slot_fold,
        # distinct non-excluded first-instance positions
        # (m_iQueryWordCount, sphinxsearch.cpp:2115)
        "exact_target": np.asarray([len({int(qpos_fold[s2])
                                         for s2 in range(S)
                                         if st.mult[s2] > 0})],
                                   np.int32),
        # per-QPOS idf for raw-stream factors (m_dIDF indexed by atom pos;
        # dupe positions copy the first instance's idf,
        # sphinxsearch.cpp:2177)
        "idf_by_qpos": _idf_by_qpos(S, st, idf, slot_fold),
        "idf": idf, "mult": mult,
        "field_weights": fw,
        "filter_vals": tuple(fvals),
        "zspans": tuple(zone_spans),
    }
    if merge_groups:
        runtime["gidf"] = gidf
    if packed_store is not None:
        runtime["pk_starts"] = pk_starts
    if scan_index:
        runtime["scan_start"] = np.asarray([scan_start], np.int32)
        runtime["scan_len"] = np.asarray([scan_len], np.int32)
    return CompiledQuery(
        sig=sig, runtime=runtime, slot_terms=list(st.terms),
        slot_df=slot_df, slot_hits=slot_hits, stat_list=stat_list,
        slot_pb=slot_pb, slot_hb=slot_hb, n_hit_iters=n_hit_iters,
        ast=node, warning="; ".join(st.warnings),
    )


def _resolve_fieldmaps(tree, schema):
    """Rewrite ("fieldmap", ((name, w), ...)) into schema-ordered
    ("fieldweights", (w0, w1, ...)) so the plan stays static/hashable."""
    if not isinstance(tree, tuple):
        return tree
    if tree[0] == "fieldmap":
        w = [1.0] * max(schema.n_fields, 1)
        for name, val in tree[1]:
            if name in schema.fields:
                w[schema.field_id(name)] = float(val)
        return ("fieldweights", tuple(w))
    return tuple(_resolve_fieldmaps(c, schema) if isinstance(c, tuple)
                 else c for c in tree)


def _positional_hits_need(expr, hit_lengths) -> int:
    """Hit-gather bucket requirement: phrase anchors = first slot's hits;
    proximity windows scan all member slots' hits."""
    op = expr[0]
    if op == "phrase":
        return int(hit_lengths[expr[1][0]])
    if op == "bigram_phrase":
        return int(hit_lengths[expr[2]])
    if op == "near":
        return int(hit_lengths[expr[1][0]])
    if op == "proximity":
        return int(sum(hit_lengths[s] for s in expr[1]))
    if op in ("and", "or"):
        return max((_positional_hits_need(c, hit_lengths) for c in expr[1]),
                   default=0)
    if op == "andnot":
        return max(_positional_hits_need(expr[1], hit_lengths),
                   _positional_hits_need(expr[2], hit_lengths))
    return 0


def _has_positional(expr) -> bool:
    op = expr[0]
    if op in ("phrase", "proximity", "near", "sentence", "paragraph",
              "bigram_phrase"):
        return True
    if op in ("and", "or"):
        return any(_has_positional(c) for c in expr[1])
    if op == "andnot":
        return _has_positional(expr[1]) or _has_positional(expr[2])
    return False
