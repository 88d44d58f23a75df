"""UTF-8 tokenizer: charset folding + word-run splitting.

Behavioral model: the reference's CSphTokenizer_UTF8 family
(Manticore src/sphinx.cpp:2671-4875): codepoints fold through the
charset table (0 = separator); a token is a maximal run of word codepoints,
clipped at SPH_MAX_WORD_LEN=42 codepoints (sphinx.h:106); tokens shorter than
min_word_len are skipped but still advance the position counter by
overshort_step. Positions are 1-based within each field (Hitman packing keeps
the field id out of band here — the index builder packs it).

Implementation is vectorized numpy (single-core host): fold all codepoints at
once, find run boundaries with a diff, slice tokens out. N-gram (CJK) chars
each become their own single-codepoint token (ngram_len=1 semantics).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .charset import DEFAULT_CHARSET, get_lowercaser, parse_charset_spec

SPH_MAX_WORD_LEN = 42  # reference sphinx.h:106


@dataclass(frozen=True)
class TokenizerSettings:
    charset_table: str = DEFAULT_CHARSET
    min_word_len: int = 1
    ngram_chars: str = ""  # charset spec of chars to split as 1-grams
    ngram_len: int = 1
    overshort_step: int = 1
    index_sp: bool = False  # detect sentence/paragraph boundaries (index_sp)
    html_strip: bool = False
    html_remove_elements: tuple = ()     # e.g. ("style", "script")
    html_index_attrs: str = ""           # e.g. "img=alt,title; a=title"
    index_zones: tuple = ()              # zone tag names (ZONE operator)
    # round-2 feature tail (sphinx.cpp:2671-4875 tokenizer options)
    synonyms: tuple = ()        # exceptions: ("AT & T => AT&T", ...) or pairs
    blend_chars: str = ""       # charset spec of dual word/separator chars
    blend_mode: str = ""        # comma list: trim_none/head/tail/both,
    #                             skip_pure ("" = trim_none)
    phrase_boundary: str = ""   # charset spec of boundary chars
    phrase_boundary_step: int = 0
    regexp_filter: tuple = ()   # ("pattern => replacement", ...)
    bigram_index: str = ""      # "" | all | first_freq | both_freq
    bigram_freq_words: tuple = ()
    # multi-word wordforms (CSphMultiformTokenizer, the reference wraps
    # the tokenizer when any wordform line has a multi-token side):
    # ((src tokens...), (dst tokens...)) pairs, matched greedily
    # longest-first over the folded token stream
    multiforms: tuple = ()

    def key(self) -> tuple:
        return (
            self.charset_table,
            self.min_word_len,
            self.ngram_chars,
            self.ngram_len,
            self.overshort_step,
            self.index_sp,
            self.html_strip,
            self.html_remove_elements,
            self.html_index_attrs,
            self.index_zones,
            self.synonyms,
            self.blend_chars,
            self.blend_mode,
            self.phrase_boundary,
            self.phrase_boundary_step,
            self.regexp_filter,
            self.bigram_index,
            self.bigram_freq_words,
            self.multiforms,
        )


@dataclass
class Token:
    text: str
    position: int
    start: int = 0      # char offset of the raw token in the source text
    end: int = 0        # char offset past the raw token
    mf: bool = False    # produced by a multiform substitution (exempt from
    #                     the post-multiform min_word_len filter)


class Tokenizer:
    def __init__(self, settings: TokenizerSettings | None = None):
        self.settings = settings or TokenizerSettings()
        self._ngram_set: np.ndarray | None = None
        if self.settings.ngram_chars:
            # ngram_chars is a charset spec with optional -> remaps: its
            # chars join the fold table (word chars), and the n-gram check
            # runs on FOLDED codepoints (remap targets) — the reference
            # merges ngram_chars into the charset the same way
            # (CSphTokenizerBase::SetNgramChars)
            self._lc = get_lowercaser(self.settings.charset_table + ", "
                                      + self.settings.ngram_chars)
            ranges = parse_charset_spec(self.settings.ngram_chars)
            pts = set()
            for r in ranges:
                pts.update(range(r.remap_start,
                                 r.remap_start + (r.end - r.start) + 1))
            self._ngram_set = np.array(sorted(pts), dtype=np.int32)
        else:
            self._lc = get_lowercaser(self.settings.charset_table)
        self._strip = None
        if self.settings.html_strip:
            from .htmlstrip import parse_index_attrs, strip_html
            ia = parse_index_attrs(self.settings.html_index_attrs)
            rm = tuple(self.settings.html_remove_elements)
            self._strip = lambda t: strip_html(t, rm, ia)
            if self.settings.index_zones:
                zn = tuple(self.settings.index_zones)
                self._strip_z = lambda t: strip_html(t, rm, ia, zones=zn,
                                                     with_zones=True)
        s = self.settings
        # regexp_filter: "pattern => replacement" pre-tokenization rewrites
        # (reference regexp filter, sphinx.h:1736; RE2 there, `re` here)
        import re as _re
        self._regexps = []
        for spec in s.regexp_filter:
            if isinstance(spec, (tuple, list)):
                pat, repl = spec
            else:
                pat, _, repl = spec.partition("=>")
            self._regexps.append((_re.compile(pat.strip()),
                                  _re.sub(r"\\(\d)", r"\\\1", repl.strip())))
        # exceptions ("synonyms" file): case-sensitive source spans ->
        # destination keyword(s), matched longest-first at separator
        # boundaries (CSphTokenizer_UTF8MF, sphinx.cpp multiforms)
        self._exceptions = []
        for spec in s.synonyms:
            if isinstance(spec, (tuple, list)):
                src, dst = spec
            else:
                src, _, dst = spec.partition("=>")
            src, dst = src.strip(), dst.strip()
            if src:
                self._exceptions.append((src, dst))
        self._exc_rx = None
        if self._exceptions:
            alts = "|".join(
                _re.escape(src) for src, _ in
                sorted(self._exceptions, key=lambda p: -len(p[0])))
            self._exc_rx = _re.compile("(" + alts + ")")
            self._exc_map = {src: dst for src, dst in self._exceptions}
        self._blend_set = self._parse_charset_points(s.blend_chars)
        modes = [m.strip() for m in (s.blend_mode or "").split(",")
                 if m.strip()]
        self._blend_trims = [m for m in modes if m.startswith("trim_")] \
            or ["trim_none"]
        self._blend_skip_pure = "skip_pure" in modes
        self._boundary_set = self._parse_charset_points(s.phrase_boundary)
        self._features_active = bool(
            self._regexps or self._exceptions or len(self._blend_set)
            or (len(self._boundary_set) and s.phrase_boundary_step))

    @staticmethod
    def _parse_charset_points(spec: str) -> np.ndarray:
        if not spec:
            return np.empty(0, np.int32)
        pts = []
        for r in parse_charset_spec(spec):
            pts.extend(range(r.start, r.end + 1))
        return np.array(sorted(set(pts)), dtype=np.int32)

    @staticmethod
    def _in_set(codes: np.ndarray, sset: np.ndarray) -> np.ndarray:
        if len(sset) == 0:
            return np.zeros(len(codes), dtype=bool)
        idx = np.clip(np.searchsorted(sset, codes), 0, len(sset) - 1)
        return sset[idx] == codes

    def _is_ngram(self, codes: np.ndarray) -> np.ndarray:
        if self._ngram_set is None or len(self._ngram_set) == 0:
            return np.zeros(len(codes), dtype=bool)
        idx = np.searchsorted(self._ngram_set, codes)
        idx_c = np.clip(idx, 0, len(self._ngram_set) - 1)
        return self._ngram_set[idx_c] == codes

    def tokenize(self, text: str) -> list[Token]:
        """Tokenize one field; returns tokens with 1-based positions."""
        if self._strip is not None:
            text = self._strip(text)
        if self._features_active:
            out = self._tokenize_features(text)
        else:
            out, _ = self._tokenize_plain(text, 0, 0)
        if self.settings.multiforms:
            out = self._apply_multiforms(out)
            min_len = self.settings.min_word_len
            if min_len > 1:
                # length filter runs AFTER substitution; the position a
                # dropped token held stays consumed
                out = [t for t in out if t.mf or len(t.text) >= min_len]
        return out

    def _apply_multiforms(self, toks: list[Token]) -> list[Token]:
        """Multi-word wordform substitution over the folded token stream
        (CSphMultiformTokenizer): greedy, longest source first; destination
        tokens take sequential positions from the match start and later
        tokens shift by the length delta."""
        if not hasattr(self, "_mf_by_first"):
            by_first: dict[str, list] = {}
            for src, dst in self.settings.multiforms:
                by_first.setdefault(src[0], []).append(
                    (tuple(src), tuple(dst)))
            for lst in by_first.values():
                lst.sort(key=lambda p: -len(p[0]))
            self._mf_by_first = by_first
        by_first = self._mf_by_first
        out: list[Token] = []
        i = 0
        shift = 0
        n = len(toks)
        while i < n:
            t = toks[i]
            cands = by_first.get(t.text)
            matched = None
            if cands:
                for src, dst in cands:
                    k = len(src)
                    if i + k <= n and all(
                            toks[i + j].text == src[j]
                            and (j == 0 or toks[i + j].position
                                 == toks[i + j - 1].position + 1)
                            for j in range(k)):
                        matched = (src, dst, k)
                        break
            if matched is None:
                out.append(Token(t.text, t.position + shift,
                                 t.start, t.end))
                i += 1
                continue
            src, dst, k = matched
            base = toks[i].position + shift
            span = (toks[i].start, toks[i + k - 1].end)
            for j, d in enumerate(dst):
                out.append(Token(d, base + j, span[0], span[1], mf=True))
            shift += len(dst) - (toks[i + k - 1].position
                                 - toks[i].position + 1)
            i += k
        return out

    def _tokenize_plain(self, text: str, pos: int,
                        off: int) -> tuple[list[Token], int]:
        """Vectorized word-run splitter over one text segment; `pos` is the
        running position counter, `off` the char offset of this segment in
        the full source. Returns (tokens, new_pos)."""
        folded = self._lc.fold_str(text)
        if len(folded) == 0:
            return [], pos
        is_word = folded > 0
        is_ngram = self._is_ngram(folded) & is_word

        out: list[Token] = []
        prev_word = np.concatenate(([False], is_word[:-1]))
        prev_ngram = np.concatenate(([False], is_ngram[:-1]))
        run_start = is_word & (~prev_word | is_ngram | prev_ngram)
        next_word = np.concatenate((is_word[1:], [False]))
        next_ngram = np.concatenate((is_ngram[1:], [False]))
        run_end = is_word & (~next_word | is_ngram | next_ngram)
        starts = np.flatnonzero(run_start)
        ends = np.flatnonzero(run_end)
        assert len(starts) == len(ends)

        min_len = 1 if self.settings.multiforms \
            else self.settings.min_word_len
        ov = self.settings.overshort_step
        for s, e in zip(starts.tolist(), ends.tolist()):
            length = e - s + 1
            if length < min_len and not (
                    self._ngram_set is not None
                    and bool(self._is_ngram(folded[s:s + 1])[0])):
                # n-gram splits are inherently 1 codepoint: min_word_len
                # does not drop them (reference CJK behavior)
                pos += ov
                continue
            pos += 1
            clipped = folded[s : s + min(length, SPH_MAX_WORD_LEN)]
            out.append(
                Token(clipped.astype(np.uint32).tobytes().decode("utf-32-le"),
                      pos, off + s, off + e + 1)
            )
        return out, pos

    # ------------------------------------------------------------------
    # feature path: regexp_filter -> exceptions -> blend/boundary splitter
    # ------------------------------------------------------------------
    def _tokenize_features(self, text: str) -> list[Token]:
        for rx, repl in self._regexps:
            text = rx.sub(repl, text)
        segments = self._split_exceptions(text)
        out: list[Token] = []
        pos = 0
        for kind, payload, span in segments:
            if kind == "exc":
                # destination keyword(s), indexed verbatim (no charset
                # fold — exceptions may carry special chars like AT&T)
                for word in payload.split():
                    pos += 1
                    out.append(Token(word.lower(), pos, span[0], span[1]))
            else:
                toks, pos = self._tokenize_blend(payload, pos, span[0])
                out.extend(toks)
        return out

    def _split_exceptions(self, text: str):
        """Split text into ("exc", dest, span) and ("plain", text, span)
        pieces. Matches are case-sensitive, longest-first, and must sit at
        separator boundaries (neighbor folds to 0)."""
        if self._exc_rx is None:
            return [("plain", text, (0, len(text)))]
        segs = []
        last = 0
        for m in self._exc_rx.finditer(text):
            a, b = m.span()
            before = text[a - 1] if a > 0 else None
            after = text[b] if b < len(text) else None
            if (before is not None
                    and int(self._lc.fold_str(before)[0]) > 0) or \
               (after is not None
                    and int(self._lc.fold_str(after)[0]) > 0):
                continue  # not token-bounded
            if a > last:
                segs.append(("plain", text[last:a], (last, a)))
            segs.append(("exc", self._exc_map[m.group(1)], (a, b)))
            last = b
        if last < len(text):
            segs.append(("plain", text[last:], (last, len(text))))
        return segs

    def _tokenize_blend(self, text: str, pos: int,
                        off: int) -> tuple[list[Token], int]:
        """Run splitter with blend_chars and phrase_boundary support.

        Blended runs emit the whole token (per blend_mode trim variants)
        at the first sub-token's position; sub-tokens advance the counter
        (CSphTokenizerBase2 blended processing). Boundary chars bump the
        position by phrase_boundary_step once per gap."""
        raw = np.array([ord(c) for c in text], dtype=np.int32) \
            if text else np.empty(0, np.int32)
        folded = self._lc.fold_str(text)
        if len(folded) == 0:
            return [], pos
        is_blend = self._in_set(raw, self._blend_set)
        is_bound = self._in_set(raw, self._boundary_set)
        is_word = folded > 0
        eff = np.where(is_word, folded, np.where(is_blend, raw, 0))
        is_word2 = eff > 0
        is_ngram = self._is_ngram(folded) & is_word

        prev_word = np.concatenate(([False], is_word2[:-1]))
        prev_ngram = np.concatenate(([False], is_ngram[:-1]))
        run_start = is_word2 & (~prev_word | is_ngram | prev_ngram)
        next_word = np.concatenate((is_word2[1:], [False]))
        next_ngram = np.concatenate((is_ngram[1:], [False]))
        run_end = is_word2 & (~next_word | is_ngram | next_ngram)
        starts = np.flatnonzero(run_start).tolist()
        ends = np.flatnonzero(run_end).tolist()
        bound_idx = np.flatnonzero(is_bound).tolist()

        min_len = 1 if self.settings.multiforms \
            else self.settings.min_word_len
        ov = self.settings.overshort_step
        step = self.settings.phrase_boundary_step
        out: list[Token] = []
        bi = 0

        def txt(arr):
            return arr.astype(np.uint32).tobytes().decode("utf-32-le")

        prev_end = -1
        for s, e in zip(starts, ends):
            # boundary chars between the previous token and this one bump
            # the position once (m_bBoundary, CSphTokenizerBase)
            if step and bound_idx:
                while bi < len(bound_idx) and bound_idx[bi] < s:
                    bi += 1
                if bi > 0 and bound_idx[bi - 1] > prev_end:
                    pos += step
            prev_end = e
            run_blend = is_blend[s:e + 1] & ~is_word[s:e + 1]
            if not run_blend.any():
                length = e - s + 1
                if length < min_len and not (
                        self._ngram_set is not None
                        and bool(self._is_ngram(eff[s:s + 1])[0])):
                    pos += ov
                    continue
                pos += 1
                clipped = eff[s:s + min(length, SPH_MAX_WORD_LEN)]
                out.append(Token(txt(clipped), pos, off + s, off + e + 1))
                continue
            # ---- blended run ----
            codes = eff[s:e + 1]
            pure = bool(run_blend.all())
            if pure and self._blend_skip_pure:
                continue
            first_pos = pos + 1
            # whole-token variants per blend_mode (dedup, emission order
            # trim_none first like the reference)
            seen = set()
            for mode in self._blend_trims:
                a, b = 0, len(codes)
                if mode in ("trim_head", "trim_both"):
                    while a < b and run_blend[a]:
                        a += 1
                if mode in ("trim_tail", "trim_both"):
                    while b > a and run_blend[b - 1]:
                        b -= 1
                if b <= a:
                    continue
                whole = txt(codes[a:a + min(b - a, SPH_MAX_WORD_LEN)])
                if whole not in seen:
                    seen.add(whole)
                    out.append(Token(whole, first_pos, off + s + a,
                                     off + s + b))
            # sub-tokens: split on blend positions, sequential positions
            # starting at first_pos; a sub identical to a whole-token
            # variant at the same position is not re-emitted
            sub_start = None
            emitted = 0
            for i in range(len(codes) + 1):
                at_blend = i >= len(codes) or run_blend[i]
                if not at_blend and sub_start is None:
                    sub_start = i
                elif at_blend and sub_start is not None:
                    ln = i - sub_start
                    if ln >= min_len:
                        pos += 1
                        emitted += 1
                        sub = codes[sub_start:sub_start
                                    + min(ln, SPH_MAX_WORD_LEN)]
                        st = txt(sub)
                        if not (pos == first_pos and st in seen):
                            out.append(Token(st, pos, off + s + sub_start,
                                             off + s + i))
                    else:
                        pos += ov
                    sub_start = None
            if emitted == 0 and seen:
                pos += 1  # whole-token variants claimed first_pos
        return out, pos

    def tokenize_boundaries(self, text: str):
        """index_sp / index_zones token stream with position-consuming
        boundaries. Returns (tokens, events, last_pos):

        - tokens carry ADJUSTED positions: each boundary before a token
          shifts it by +1, exactly like the reference's magic tokens
          (MAGIC_CODE_SENTENCE/PARAGRAPH/ZONE go through the same
          HITMAN::AddPos as words — BuildRegularHits sphinx.cpp:22461,
          BuildZoneHits sphinx.cpp:22233);
        - events are (kind, name, pos): kind 's' (sentence boundary),
          'p' (paragraph: block tag open/close), 'zopen'/'zclose' (zone
          tags) at the position the boundary itself consumed. Zone and
          paragraph events imply sentence breaks; zone events imply
          paragraph breaks (BuildZoneHits emits \\3sentence/\\3paragraph
          alongside the zone word);
        - last_pos is the final consumed position (field length per the
          reference's m_pFieldLengthAttrs = pos of the LAST hit, magic
          included).

        Sentence detection replicates CodepointArbitrationI
        (sphinx.cpp:4578-4655): '?'/'!' always break; '.' breaks unless
        in-word (next char alnum/-/_/,/high-bit), in-phrase (". a"), or
        after a middle-name/salutation token (J. / Mr. / MRS.)."""
        sp = bool(self.settings.index_sp)
        zones_on = bool(self.settings.index_zones)
        raw_events: list[tuple[str, str, int]] = []
        if self.settings.html_strip:
            from .htmlstrip import parse_index_attrs, strip_html_events
            ia = parse_index_attrs(self.settings.html_index_attrs)
            rm = tuple(self.settings.html_remove_elements)
            zn = tuple(self.settings.index_zones) if zones_on else ()
            stripped, raw_events = strip_html_events(
                text, rm, ia, zones=zn, paragraphs=sp)
        else:
            stripped = text
        saved = self._strip
        self._strip = None          # already stripped
        try:
            toks = self.tokenize(stripped)
        finally:
            self._strip = saved
        if sp:
            raw_events.extend(self._sentence_events(stripped, toks))
        if not raw_events:
            return toks, [], (toks[-1].position if toks else 0)
        raw_events.sort(key=lambda e: e[2])
        # walk tokens+events by offset, consuming one position per event
        events_out: list[tuple[str, str, int]] = []
        out: list[Token] = []
        ei = 0
        delta = 0
        last_pos = 0
        for t in toks:
            while ei < len(raw_events) and raw_events[ei][2] <= t.start:
                kind, name, _off = raw_events[ei]
                delta += 1
                last_pos += 1
                events_out.append((kind, name, last_pos))
                ei += 1
            nt = Token(t.text, t.position + delta, t.start, t.end, t.mf)
            out.append(nt)
            last_pos = nt.position
        for kind, name, _off in raw_events[ei:]:
            delta += 1
            last_pos += 1
            events_out.append((kind, name, last_pos))
        return out, events_out, last_pos

    @staticmethod
    def _sentence_events(text: str, toks) -> list[tuple[str, str, int]]:
        """Sentence boundaries per CodepointArbitrationI — returns
        ('s', '', char_off) events."""
        ends = {t.end: t for t in toks}   # token ending exactly at offset

        def _cap(c: str) -> bool:
            return "A" <= c <= "Z"

        out = []
        n = len(text)
        for o, ch in enumerate(text):
            if ch in "?!":
                out.append(("s", "", o))
                continue
            if ch != ".":
                continue
            nxt = text[o + 1] if o + 1 < n else "\0"
            # in-word dot ("U.K", "1.5"): sphIsAlpha covers [0-9a-zA-Z-_]
            if (nxt.isascii() and (nxt.isalnum() or nxt in "-_,")) \
                    or ord(nxt) > 127:
                continue
            # in-phrase dot (". a" / ". (a"): exactly one space then a
            # small letter or an opening paren + small letter
            if nxt in " \t\n\r":
                n2 = text[o + 2] if o + 2 < n else "\0"
                if "a" <= n2 <= "z":
                    continue
                if n2 == "(" and o + 3 < n and "a" <= text[o + 3] <= "z":
                    continue
            # middle name / salutation: the dot directly terminates a
            # 1-2-3 char token (J. | Mr./MR./MS./DR. | Mrs./Drs.)
            t = ends.get(o)
            if t is not None:
                ln = len(t.text)
                if ln == 1 and o >= 1 and _cap(text[o - 1]):
                    continue
                if ln == 2 and o >= 2 and _cap(text[o - 2]):
                    if not _cap(text[o - 1]):
                        continue
                    if (text[o - 2], text[o - 1]) in (
                            ("M", "R"), ("M", "S"), ("D", "R")):
                        continue
                if ln == 3 and t.text in ("mrs", "drs"):
                    continue
            out.append(("s", "", o))
        return out

    def tokenize_with_zones(self, text: str):
        """Tokenize + zone spans: returns (tokens, [(zone, open_char_off,
        close_char_off)]) with offsets into the stripped text — token
        start/end offsets live in the same space, so the index builder can
        map spans to token positions."""
        if getattr(self, "_strip_z", None) is None:
            return self.tokenize(text), []
        stripped, events = self._strip_z(text)
        saved = self._strip
        self._strip = None         # already stripped
        try:
            toks = self.tokenize(stripped)
        finally:
            self._strip = saved
        return toks, events

    def tokenize_fast(self, text: str):
        """Builder fast path: returns (terms list[str], positions list[int])
        without Token objects."""
        toks = self.tokenize(text)
        return [t.text for t in toks], [t.position for t in toks]

    def tokenize_terms(self, text: str) -> list[str]:
        return [t.text for t in self.tokenize(text)]
