"""Full-text query AST (XQNode_t analog, Manticore src/sphinxquery.h:21-310).

Field limits attach to keyword/phrase atoms (XQLimitSpec_t semantics: an
@field operator applies to everything that follows until the next field
operator, within the current parenthesized group).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QTerm:
    word: str
    fields: tuple[str, ...] | None = None   # None = all fields
    exact: bool = False                      # =word operator
    boost: float = 1.0                       # word^N
    wildcard: bool = False                   # word* / *word* — expansion
    field_start: bool = False                # ^word — must start the field
    field_end: bool = False                  # word$ — must end the field
    zones: tuple = ()                        # ZONE:(...) limit (tag names)
    expanded: str = ""                       # wildcard pattern this term was
    #                                          expanded from ("" = not an
    #                                          expansion; XQKeyword_t
    #                                          m_bExpanded analog)
    atom_span: int = 1                       # query atom positions consumed
    #                                          (blended chunks cover their
    #                                          parts' positions: m_iAtomPos
    #                                          advances per tokenizer pos)
    raw: str = ""                            # display form for SHOW PLAN:
    #                                          XQKeyword_t m_sWord is the
    #                                          raw (pre-dict) token
    max_field_pos: int = 0                   # @field[N]: only hits at
    #                                          in-field position <= N match
    #                                          (XQLimitSpec_t
    #                                          m_iFieldMaxPos; 0 = off)


@dataclass(frozen=True)
class QPhrase:
    words: tuple[str, ...]
    fields: tuple[str, ...] | None = None
    proximity: int = 0        # "..."~N ; 0 = exact phrase
    # per-word query-position offsets relative to the first word (gaps >1
    # where stopped/overshort words held a position); () = 0,1,2,...
    positions: tuple = ()
    raws: tuple = ()          # raw (pre-dict) display forms for SHOW PLAN


@dataclass(frozen=True)
class QQuorum:
    words: tuple[str, ...]
    m: int                    # resolved count (fractions resolved at parse)
    fields: tuple[str, ...] | None = None
    raws: tuple = ()          # raw (pre-dict) display forms for SHOW PLAN


@dataclass(frozen=True)
class QNear:
    left: object              # QTerm (v1 restriction)
    right: object             # QTerm
    n: int
    not_near: bool = False    # NOTNEAR/N


@dataclass(frozen=True)
class QSentence:
    left: object
    right: object
    paragraph: bool = False   # PARAGRAPH instead of SENTENCE


@dataclass(frozen=True)
class QAnd:
    children: tuple


@dataclass(frozen=True)
class QOr:
    children: tuple


@dataclass(frozen=True)
class QAndNot:
    left: object
    right: object


@dataclass(frozen=True)
class QNot:
    child: object             # only valid as an AND-list member


@dataclass(frozen=True)
class QMaybe:
    left: object
    right: object             # MAYBE: match left, rank with right's weight too


@dataclass(frozen=True)
class QGap:
    """A query atom whose keywords all dropped (stopword/overshort) but
    which still consumes atom positions: the reference's parser advances
    m_iAtomPos over stopped keywords (stopword_step, sphinxquery.cpp), so
    proximity LCS sees the positional hole ("senior pastor of riverside
    church" with 'of' stopped ranks doc positions 1,2,4,5 as LCS 4)."""
    span: int = 1


@dataclass(frozen=True)
class QAll:
    """Match-all (empty query / fullscan)."""
