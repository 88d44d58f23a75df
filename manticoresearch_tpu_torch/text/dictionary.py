"""Dictionary: token -> term processing (stopwords, morphology, exact forms).

Behavioral model: CSphDict (Manticore src/sphinx.h:597,
sphinx.cpp:16600-19500) in its dict=keywords flavor: terms keep their text
(we never need CRC wordids — the engine's term identity is the dense term
index of the shard dictionary). Processing order per token mirrors
CSphTemplateDictTraits: stopword check (pre-morphology), morphology,
stopword check again (post-morphology), wordforms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .morphology import get_morph


@dataclass(frozen=True)
class DictSettings:
    stopwords: frozenset[str] = frozenset()
    morphology: tuple[str, ...] = ()  # e.g. ("stem_en",)
    wordforms: tuple[tuple[str, str], ...] = ()  # (from, to) pairs
    index_exact_words: bool = False
    min_stemming_len: int = 1
    token_filter: str = ""        # registered token-filter plugin name
    # wildcard expansion gates (reference index settings m_iMinPrefixLen /
    # m_iMinInfixLen, sphinx.cpp:14466-14467; 0 = wildcards disabled and
    # stars fold away as separators)
    min_prefix_len: int = 0
    min_infix_len: int = 0
    mode: str = "keywords"        # dict=keywords | dict=crc: crc indexes
    #                               substrings as real terms, so expanded
    #                               stats count DISTINCT docs (test_161)
    # hitless_words: "all" or space/comma-separated word-list file paths
    # (LoadHitlessWords, sphinx.cpp:9345) — listed words index postings
    # (tf + fieldmask) but no positions
    hitless_words: str = ""
    # dict=crc per-field substring indexing (GetWordpart,
    # indexsettings.cpp:223): empty list = every field qualifies; a field
    # in NEITHER list (when both are non-empty) indexes whole words only
    prefix_fields: tuple = ()
    infix_fields: tuple = ()

    def key(self) -> tuple:
        return (
            tuple(sorted(self.stopwords)),
            self.morphology,
            self.wordforms,
            self.index_exact_words,
            self.min_stemming_len,
            self.token_filter,
            self.min_prefix_len,
            self.min_infix_len,
            self.mode,
            self.hitless_words,
            self.prefix_fields,
            self.infix_fields,
        )


class Dictionary:
    def __init__(self, settings: DictSettings | None = None):
        self.settings = settings or DictSettings()
        self._morphs: list[Callable[[str], str]] = [
            get_morph(m) for m in self.settings.morphology
        ]
        self._wordforms = dict(self.settings.wordforms)

    def process(self, token: str, skip_morph: bool = False) -> list[str]:
        """Map one raw token to the term(s) actually indexed.

        Returns [] for stopwords. With index_exact_words, emits the exact
        form as an extra "=token" term (reference CSphDictExact,
        sphinx.cpp:1020-1033 — exact terms carry a magic prefix).
        """
        s = self.settings
        if s.token_filter:
            from ..plugins import get_token_filter
            tf = get_token_filter(s.token_filter)
            if tf is not None:
                out = tf(token)
                if out is None:
                    return []
                if isinstance(out, (list, tuple)):
                    res: list[str] = []
                    for t2 in out:
                        res.extend(self._process_tail(str(t2)))
                    return res
                token = str(out)
        return self._process_tail(token, skip_morph)

    def _process_tail(self, token: str,
                      skip_morph: bool = False) -> list[str]:
        """Stopword/morphology/wordforms pipeline after token filters.
        skip_morph: multiform-destination tokens are post-morphology
        (XQKeyword m_bMorphed / CSphMultiformTokenizer emissions)."""
        s = self.settings
        if token in s.stopwords:
            return []
        term = token
        if skip_morph:
            pass
        elif self._wordforms and term in self._wordforms:
            term = self._wordforms[term]
        elif len(term) >= s.min_stemming_len:
            extra_lemmas: list[str] = []
            for m in self._morphs:
                stemmed = m(term)
                if getattr(m, "emits_all", False):
                    # lemmatize_*_all: every candidate indexes at the
                    # same position (sphinxaot.cpp dual-form emission)
                    cands = list(stemmed)
                    stemmed = cands[0] if cands else term
                    extra_lemmas = [c for c in cands[1:] if c]
                if stemmed != term:
                    term = stemmed
                    break
            if extra_lemmas:
                out = [term] + [c for c in extra_lemmas if c != term]
                exact_on2 = s.index_exact_words and (self._morphs
                                                     or self._wordforms)
                if exact_on2 or (s.min_prefix_len > 0
                                 or s.min_infix_len > 0):
                    out.append("=" + token)
                return [t for t in out if t not in s.stopwords]
        if term in s.stopwords or not term:
            return []
        # nonstemmed shadow entries (MAGIC_WORD_HEAD_NONSTEMMED analog):
        # indexed with index_exact_words, and ALSO whenever morphology
        # coexists with wildcard indexing — the reference expands wildcards
        # over nonstemmed forms only (sphExpandGetWords "prefix expansion
        # should work on nonstemmed words only", sphinx.cpp:14965)
        exact_on = s.index_exact_words and (self._morphs
                                            or self._wordforms)
        if exact_on or (
                self._morphs and (s.min_prefix_len > 0
                                  or s.min_infix_len > 0)):
            return [term, "=" + token]
        return [term]

    def process_query_term(self, token: str, exact: bool = False,
                           skip_morph: bool = False) -> str | None:
        """Query-side term mapping; exact=True means the =term operator.
        With index_exact_words disabled the '=' loses its meaning and the
        keyword processes normally (sphinxquery.cpp exact-form check)."""
        if exact and self.settings.index_exact_words \
                and (self._morphs or self._wordforms):
            # without morphology/wordforms the exact form IS the plain
            # form: the reference drops the '=' with a warning
            return "=" + token
        out = self.process(token, skip_morph=skip_morph)
        if not out:
            return None
        return out[0]
