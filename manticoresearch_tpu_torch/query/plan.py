"""Device query plan IR.

The host planner (query/planner.py) lowers a parsed full-text AST + filters +
options into a PlanSig: a fully static, hashable description of the device
program (the analog of the reference's transformed XQ tree + filter/ranker
setup, sphinx.cpp:15664 ParsedMultiQuery). PlanSig is the jit-cache key; all
per-query numbers (CSR offsets, IDFs, filter bounds) are runtime arrays so
queries with the same *shape* share one compiled program.

Boolean expressions are nested tuples over term slots:
    ("term", slot)
    ("and", (e1, e2, ...))       implicit AND / & — ExtAnd_c semantics
    ("or", (e1, e2, ...))        | — ExtOr_c
    ("andnot", left, right)      left AND NOT right — ExtAndNot_c
    ("quorum", (slots...), m)    "..."/m — ExtQuorum_c
    ("phrase", (slots...))       "..." — exact phrase (hit-level)
    ("proximity", (slots...), n) "..."~n
    ("all",)                     fullscan (MultiScan, sphinx.cpp:12739)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FilterSpec:
    """Static shape of one attribute filter (ISphFilter analog,
    sphinxfilter.cpp:40-123). Runtime values live in the runtime args."""

    attr: str
    kind: str          # "values" | "range_i" | "range_f" | "mva_any" | "mva_all"
    exclude: bool = False
    n_values: int = 0  # for "values": padded value-list length (pow2)
    lo_excl: bool = False  # for range_f
    hi_excl: bool = False
    usgn: bool = False  # uint attr: compare in the unsigned domain
    #                     (values bias-flipped: v ^ 0x80000000)


@dataclass(frozen=True)
class PlanSig:
    expr: tuple
    n_slots: int               # number of term slots (<= 32 on fast path)
    ranker: str                # "ws_bm25" | "ws" | "none" | "wordcount" | "proximity_bm25" | ...
    filters: tuple[FilterSpec, ...]
    k: int                     # top-k kept on device (max_matches clamp)
    order: tuple               # ("rel",) | ("attr", name, is_asc, is_float)
    slot_limited: tuple = ()   # ((slot, fieldmask), ...): field-limited slots
                               # evaluated via the hit pass (XQLimitSpec_t
                               # semantics: tf counts only allowed-field hits)
    ranker_expr: tuple = ()    # formula tree for ranker=expr('...')
    emit_factors: bool = False  # PACKEDFACTORS(): output factor arrays
                                # gathered at the top-k rows
    fl_on: bool = False         # index_field_lengths: doc lengths feed
                                # bm25a/bm25f (dl=0 when the index lacks
                                # LENGTH attrs, like the reference)
    slot_occs: tuple = ()       # HANDLE_DUPES: per-slot tuple of query
                                # positions when a keyword occurs more than
                                # once in the query (else empty)
    has_dupes: bool = False     # HasQwordDupes (sphinxsearch.cpp:4178):
                                # any word string appears in >1 query atom
                                # -> the dupes proximity state machine
    max_qpos: int = 0           # highest query atom position (static:
                                # bounds the exact_order chain walk)
    sparse: bool = False        # sparse candidate pipeline: evaluate over
                                # the union of the query terms' postings
                                # (sorted + segment-reduced) instead of
                                # dense [N+1] accumulators — the TPU analog
                                # of skiplist economics (sphinx.cpp:8522):
                                # per-query cost tracks posting sizes, not
                                # corpus size
    slot_packed: tuple = ()     # packed posting store: per-slot (c_rw,
                                # c_tf, c_fm) width classes (0 = slot reads
                                # the raw residual stream); () = the index
                                # has no packed store (legacy/sharded data
                                # pytrees with raw post_* arrays)
    scan_index: str = ""        # filtered fullscan pre-selection: evaluate
                                # over a slice of this attr's sorted-value
                                # rowid permutation instead of all N rows —
                                # the secondary-index/histogram analog
                                # (histogram.h:19, sphinx.cpp:12676)
    scan_bucket: int = 0        # pow2 candidate bucket for scan_index
    filter_tree: tuple = ()     # boolean combination of the filters:
                                # ("leaf", i) | ("and"/"or", (children...))
                                # over sig.filters indices; () = AND of all
                                # (the reference's m_dFilterTree,
                                # sphinxfilter.cpp filter tree eval)
    merge_groups: tuple = ()    # wildcard payload term-merge (ExtPayload,
                                # sphinx.cpp:14880-14912): tuples of slot
                                # ids that rank as ONE qword — the kernel
                                # sums raw tf across the group and scores
                                # sum/(sum+K1)*group_idf; grouped slots get
                                # per-slot idf 0 and share one query
                                # position


RANKERS_WITH_HITS = frozenset(
    {"proximity_bm25", "proximity", "wordcount", "matchany", "expr"})


def _desc_slots(desc) -> tuple:
    """Slots of a NEAR operand descriptor (slot/phrase/nearsub)."""
    kind, payload, _span = desc
    if kind in ("slot", "phrase"):
        return tuple(payload)
    return tuple(payload[1])          # nearsub: its flattened slot list


def expr_has_all(expr: tuple) -> bool:
    """True if the expression contains a fullscan ("all") node anywhere —
    such plans must touch every row and cannot run on the sparse
    candidate pipeline."""
    op = expr[0]
    if op == "all":
        return True
    if op in ("and", "or"):
        return any(expr_has_all(c) for c in expr[1])
    if op == "andnot":
        return expr_has_all(expr[1]) or expr_has_all(expr[2])
    if op == "maybe":
        return expr_has_all(expr[1])
    return False


def expr_slots(expr: tuple) -> set[int]:
    op = expr[0]
    if op == "term":
        return {expr[1]}
    if op == "all":
        return set()
    if op in ("and", "or"):
        out: set[int] = set()
        for c in expr[1]:
            out |= expr_slots(c)
        return out
    if op == "andnot":
        return expr_slots(expr[1]) | expr_slots(expr[2])
    if op in ("quorum", "phrase"):
        return set(expr[1])
    if op in ("proximity", "near", "sentence", "paragraph"):
        return set(expr[1])
    if op == "bigram_phrase":
        return set(expr[1]) | {expr[2]}
    if op == "maybe":
        return expr_slots(expr[1]) | expr_slots(expr[2])
    raise ValueError(f"unknown expr op {op!r}")


def ranker_term_slots(expr: tuple) -> tuple[int, ...]:
    """Slots whose raw hits feed the ranker hit stream: positive term leaves
    and quorum members — NOT phrase members (the phrase node consumes its
    children's hits and emits phrase hits instead, searchnode.cpp:3901)."""
    def walk(e) -> list[int]:
        op = e[0]
        if op == "term":
            return [e[1]]
        if op == "all":
            return []
        if op in ("and", "or"):
            out = []
            for c in e[1]:
                out.extend(walk(c))
            return out
        if op == "andnot":
            return walk(e[1])
        if op == "quorum":
            return list(e[1])
        if op == "maybe":
            return walk(e[1]) + walk(e[2])
        if op in ("phrase", "proximity", "near", "sentence", "paragraph",
                  "bigram_phrase"):
            return []
        raise ValueError(f"unknown expr op {op!r}")
    seen: list[int] = []
    for s in walk(expr):
        if s not in seen:
            seen.append(s)
    return tuple(seen)


def positive_phrase_nodes(expr: tuple) -> tuple:
    """Phrase/proximity nodes not under a NOT branch, in tree order."""
    op = expr[0]
    if op in ("phrase", "proximity", "near", "sentence", "paragraph",
              "bigram_phrase"):
        return (expr,)
    if op in ("and", "or"):
        out: tuple = ()
        for c in expr[1]:
            out = out + positive_phrase_nodes(c)
        return out
    if op == "andnot":
        return positive_phrase_nodes(expr[1])
    if op == "maybe":
        return positive_phrase_nodes(expr[1]) + positive_phrase_nodes(
            expr[2])
    return ()


def phrase_member_gating(expr: tuple) -> tuple:
    """(node -> member slots whose tfidf is gated on the node matching,
    free slot set). A phrase/proximity member's tfidf reaches a doc only
    through the node's FSM emissions — docs matching merely the word (not
    the phrase) must not receive it (reference: qword hits flow through
    the operator tree; golden test_019 '"test program" | basic'). Slots
    that also occur as bare terms stay free (their bare instance always
    contributes)."""
    free: set[int] = set()
    nodes: dict = {}

    def walk(e, positive=True):
        op = e[0]
        if op == "term":
            free.add(e[1])
        elif op in ("and", "or"):
            for c in e[1]:
                walk(c, positive)
        elif op == "andnot":
            walk(e[1], positive)
            walk(e[2], False)
        elif op == "maybe":
            walk(e[1], positive)
            walk(e[2], positive)
        elif op in ("phrase", "proximity", "bigram_phrase"):
            if positive:
                nodes[e] = tuple(e[1])
            else:
                free.update(e[1])
        elif op in ("quorum", "near", "sentence", "paragraph"):
            # ungated node types keep direct member contribution
            free.update(positive_slots(e) if positive else ())
        elif op == "all":
            pass

    walk(expr)
    gated = {n: tuple(s for s in slots if s not in free)
             for n, slots in nodes.items()}
    gated = {n: slots for n, slots in gated.items() if slots}
    return gated, free


def positive_slots(expr: tuple) -> set[int]:
    """Slots whose TFIDF contributes to the doc weight: everything except
    slots under the NOT side of ANDNOT (reference: NOT subtrees never emit
    docs upward, searchnode.cpp ExtAndNot)."""
    op = expr[0]
    if op == "term":
        return {expr[1]}
    if op == "all":
        return set()
    if op in ("and", "or"):
        out: set[int] = set()
        for c in expr[1]:
            out |= positive_slots(c)
        return out
    if op == "andnot":
        return positive_slots(expr[1])
    if op in ("quorum", "phrase", "proximity", "sentence", "paragraph",
              "bigram_phrase"):
        return set(expr[1])
    if op == "near":
        # NOTNEAR's right side never contributes weight
        if expr[3]:
            return set(_desc_slots(expr[4])) if len(expr) > 4 \
                else {expr[1][0]}
        return set(expr[1])
    if op == "maybe":
        return positive_slots(expr[1]) | positive_slots(expr[2])
    raise ValueError(f"unknown expr op {op!r}")
