"""Snippets / highlighting: query-aware passage extraction.

Behavioral model: SnippetBuilder_c (Manticore src/sphinxexcerpt.h:110,
sphinxexcerpt.cpp + snippetfunctor.cpp/snippetpassage.cpp): tokenize the
source text with the index's tokenizer into word/gap tokens, mark query-term
hits, slide a char+word-bounded window collecting candidate passages
(PassageExtractor_c state machine, snippetfunctor.cpp:440), trim each to
`around` words per side (FlushPassage, snippetfunctor.cpp:720), greedily
select best passages under the char/word budget with term re-weighting
(SelectBestPassages, snippetpassage.cpp:94), shave passage edges token by
token until the budget fits, and render matches wrapped in before/after
tags.  Whole-doc highlighting when the text fits the limit
(CanHighlightAll, sphinxexcerpt.cpp:685); doc-start clip for fields
without hits (DocStartHighlighter_c, snippetfunctor.cpp:300).  Runs
host-side over final top-k docs only (CALL SNIPPETS / HIGHLIGHT() / json
"highlight").

The port's copy of ``manticoresearch_tpu/exec/snippets.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer


@dataclass
class SnippetOptions:
    before_match: str = "<b>"     # %PASSAGE_ID% macro supported
    after_match: str = "</b>"
    chunk_separator: str = " ... "
    limit: int = 256              # max snippet size in chars
    around: int = 5               # words on each side of a match
    limit_passages: int = 0       # 0 = unlimited
    limit_words: int = 0          # total words across passages
    exact_phrase: bool = False
    use_boundaries: bool = False
    weight_order: bool = False    # order passages by weight vs appearance
    allow_empty: bool = False     # return "" when no match (else doc start)
    no_match_size: int = 256      # kept for API compat (json maps <1 to
    #                               allow_empty; clip length is `limit`)
    start_passage_id: int = 1     # %PASSAGE_ID% counter start
    force_all_words: bool = False  # ignore limit until all words shown
    force_passages: bool = False   # never use the whole-doc fast path
    passage_boundary: str = ""    # "sentence" | "paragraph": clamp spans
    html_strip_mode: str = "index"  # "none"|"strip"|"index"|"retain"
    query_mode: bool = False      # evaluate the query's boolean tree over
    #                               the doc: only terms of MATCHED subtrees
    #                               highlight (SnippetsQwordSetup)


# ---------------------------------------------------------------------------
# token stream: words (from the index tokenizer) + gap runs, split at
# space/non-space transitions (SplitSpaceIntoTokens, snippetfunctor.cpp:160)

# CALL SNIPPETS / SNIPPET() option-name aliases (searchd.cpp:10488-10521)
OPTION_ALIASES = {
    "snippet_separator": "chunk_separator",
    "snippet_boundary": "passage_boundary",
    "limit_snippets": "limit_passages",
    "start_snippet_id": "start_passage_id",
    "force_snippets": "force_passages",
}


@dataclass
class _Tok:
    text: str                      # raw source slice (rendered verbatim)
    is_word: bool
    norm: str = ""                 # tokenizer-normalized form (matching)
    alts: tuple = ()               # extra norms (multiform destinations
    #                                sharing this source span)
    qmask: int = 0

    @property
    def lcp(self) -> int:          # length in codepoints
        return len(self.text)


def _gap_runs(gap: str) -> list[str]:
    """Split inter-word text into alternating space/non-space runs."""
    if not gap:
        return []
    if len(gap) == 1:
        return [gap]
    runs = []
    cur = gap[0]
    was_space = gap[0].isspace()
    for ch in gap[1:]:
        sp = ch.isspace()
        if sp != was_space:
            runs.append(cur)
            cur = ch
            was_space = sp
        else:
            cur += ch
    runs.append(cur)
    return runs


def _stream(text: str, tokenizer: Tokenizer) -> list[_Tok]:
    raw = list(tokenizer.tokenize(text))
    # blend_chars emit overlapping variants (the blended whole plus its
    # parts); keep the non-overlapping parts for a clean text cover
    toks = []
    pos = 0
    for i, t in enumerate(raw):
        if t.start < pos:
            # same-span duplicate (multiform destinations): extra norm
            # on the token already emitted for this span
            if toks and toks[-1].is_word and t.end <= pos:
                toks[-1].alts = toks[-1].alts + (t.text,)
            continue
        nxt = raw[i + 1] if i + 1 < len(raw) else None
        if nxt is not None and t.start <= nxt.start < t.end \
                and nxt.end - nxt.start < t.end - t.start:
            continue               # blended container; its parts follow
        for run in _gap_runs(text[pos:t.start]):
            toks.append(_Tok(run, False))
        end = t.end
        if getattr(t, "mf", False):
            # a multiform phrase token consumed its trailing separator
            # while scanning ahead (CSphMultiformTokenizer) — the tag
            # closes after it: "<b>dou true </b>1"
            while end < len(text) and text[end].isspace():
                end += 1
        toks.append(_Tok(text[t.start:end], True, norm=t.text))
        pos = end
    for run in _gap_runs(text[pos:]):
        toks.append(_Tok(run, False))
    return toks


def _query_terms(query: str, tokenizer: Tokenizer, dictionary: Dictionary
                 ) -> list[str]:
    """Flatten the query into its ordered unique match terms (operators
    ignored — bag-of-words highlighting, SnippetsDocIndex_c::ParseQuery)."""
    import re
    words = re.sub(r'[()|!\-"~/@^$<]+', " ", query)
    out: list[str] = []
    for t in tokenizer.tokenize(words):
        star_pre = t.start > 0 and words[t.start - 1] == "*"
        star_post = t.end < len(words) and words[t.end] == "*"
        if star_pre or star_post:
            # wildcard term: kept as a pattern, matched by prefix/suffix
            # against raw token forms (ExpandKeywords star path)
            term = ("*" if star_pre else "") + t.text + \
                ("*" if star_post else "")
            if term not in out:
                out.append(term)
            continue
        if t.start > 0 and words[t.start - 1] == "=":
            # exact-form term: matches only the unstemmed token
            # (CSphDictExact magic prefix, sphinx.cpp:1020)
            term = dictionary.process_query_term(t.text, exact=True)
            if term and term not in out:
                out.append(term)
            continue
        for term in dictionary.process(t.text):
            if not term.startswith("=") and term not in out:
                out.append(term)
    return out[:32]                # qword masks are 32-bit


def _mark(toks: list[_Tok], dictionary: Dictionary, terms: list[str],
          exact_phrase: bool = False) -> int:
    """Assign per-token query masks; returns the mask of terms found."""
    bit = {t: 1 << i for i, t in enumerate(terms)}
    found = 0
    if exact_phrase:
        widx = [i for i, t in enumerate(toks) if t.is_word]
        proc = [dictionary.process(toks[i].norm or toks[i].text) for i in widx]
        n = len(terms)
        for i in range(len(widx) - n + 1):
            if all(terms[j] in proc[i + j] for j in range(n)):
                for j in range(n):
                    toks[widx[i + j]].qmask |= bit[terms[j]]
                    found |= bit[terms[j]]
        return found
    stars = [(term, b) for term, b in bit.items() if "*" in term]
    for t in toks:
        if not t.is_word:
            continue
        for nrm in (t.norm or t.text, *t.alts):
            for p in dictionary.process(nrm):
                if p in bit:
                    t.qmask |= bit[p]
                    found |= bit[p]
        if stars:
            w = t.norm or t.text
            for term, b in stars:
                core = term.strip("*")
                ok = (w == core if term[0] != "*" and term[-1] != "*" else
                      core in w if term[0] == "*" and term[-1] == "*" else
                      w.endswith(core) if term[0] == "*" else
                      w.startswith(core))
                if ok:
                    t.qmask |= b
                    found |= b
    return found


# ---------------------------------------------------------------------------
# passage candidates (PassageExtractor_c, snippetfunctor.cpp:440)

@dataclass
class _Passage:
    start: int = 0                # absolute token index
    ntokens: int = 0
    codes: int = 0
    words: int = 0
    qmask: int = 0
    qwords_weight: int = 0
    qword_count: int = 0
    uniq: int = 0
    max_lcs: int = 1
    min_gap: int = 0
    start_limit: int = 0          # first/last qword token (absolute)
    end_limit: int = 0
    codes_between: int = 0
    words_between: int = 0
    before_toks: list = field(default_factory=list)   # [(is_word, lcp)]
    after_toks: list = field(default_factory=list)
    fld: int = 0

    def weight(self) -> int:
        return self.qword_count + self.qwords_weight * self.max_lcs \
            + self.min_gap

    def less(self, o: "_Passage") -> bool:
        # operator< (snippetpassage.cpp:19): uniq, weight, codes
        if self.uniq != o.uniq:
            return self.uniq < o.uniq
        wa, wb = self.weight(), o.weight()
        return self.codes < o.codes if wa == wb else wa < wb

    def copy(self) -> "_Passage":
        import copy as _c
        p = _c.copy(self)
        p.before_toks = list(self.before_toks)
        p.after_toks = list(self.after_toks)
        return p


class _Extractor:
    """Sliding-window candidate collection, one field."""

    def __init__(self, toks: list[_Tok], around: int, limit: int,
                 limit_words: int, limit_passages: int,
                 force_all: bool, all_mask: int, term_weights: list[int],
                 doclen_cp: int, fld: int, passages: list[_Passage],
                 ctx: dict, boundary: str = ""):
        self.toks = toks
        self.boundary = boundary   # ""|"sentence"|"paragraph" (SPZ)
        self.around = around
        self.cp_limit = limit if limit else 1 << 30
        self.limit = limit
        self.limit_words = limit_words
        self.force_all = force_all
        self.all_mask = all_mask
        self.term_weights = term_weights
        self.doclen_cp = doclen_cp
        self.fld = fld
        self.passages = passages   # shared across fields in global mode
        self.ctx = ctx             # {qwords, top_weights, qword_w[32]}
        t0 = limit_passages or (limit_words // 2) or (limit // 4)
        self.thresh = 1 << t0.bit_length()
        # span state
        self.s_start = 0           # absolute index of first span token
        self.s_end = 0             # one past last
        self.codes = 0
        self.words = 0
        self.qwords = 0            # count of qword tokens in span
        self.qwords_changed = True
        self.state = 0             # 0 = WINDOW_SETUP, 1 = ADD_WORD
        self.pass_ = _Passage()

    def words_limit(self) -> int:
        return self.limit_words if self.limit_words \
            else 2 * self.around + self.qwords

    def _is_boundary(self, t: _Tok) -> bool:
        if t.is_word or not self.boundary:
            return False
        if self.boundary == "sentence":
            return any(c in t.text for c in ".?!")
        if self.boundary == "paragraph":
            return "\n" in t.text
        return False

    def _boundary_flush(self, nxt: int):
        # OnSPZ (snippetfunctor.cpp:581): weight+submit the current span,
        # then reset it — passages never cross an SPZ boundary
        self.qwords_changed = True
        self.submit()
        self.state = 0
        self.s_start = self.s_end = nxt
        self.codes = 0
        self.words = 0
        self.qwords = 0

    def run(self):
        # SPZ boundary marker is deferred one token so the terminator and
        # its following space stay with the preceding sentence
        # (m_bAppendSentenceEnd, snippetfunctor.cpp:566-588)
        pending = False
        for i, t in enumerate(self.toks):
            if pending:
                pending = False
                if not t.is_word:
                    self.add(i, t)
                    self._boundary_flush(i + 1)
                    continue
                self._boundary_flush(i)
            if self.state == 0:
                ok = self.codes + t.lcp <= self.cp_limit and \
                    self.words <= self.words_limit()
                trigger = (self.qmask_now() == self.all_mask and not ok) \
                    if self.force_all else not ok
                if trigger:
                    self.qwords_changed = True
                    self.submit()
                    self.state = 1
                self.add(i, t)
                if self.state == 1 and t.is_word:
                    self.shrink()
                    self.submit()
            else:
                self.add(i, t)
                if t.is_word:
                    self.shrink()
                    self.submit()
            if self._is_boundary(t):
                pending = True
        # tail (OnTail/OnFinish, snippetfunctor.cpp:612)
        self.shrink()
        self.submit()

    def qmask_now(self) -> int:
        m = 0
        for i in range(self.s_start, self.s_end):
            m |= self.toks[i].qmask
        return m

    def add(self, i: int, t: _Tok):
        if self.s_end != i:        # first add
            self.s_start = self.s_end = i
        self.s_end = i + 1
        self.codes += t.lcp
        self.words += t.is_word
        if t.qmask:
            self.qwords += 1
            self.qwords_changed = True

    def shrink(self):
        # ShrinkSpanHead (snippetfunctor.cpp:843)
        while self.s_start < self.s_end - 1 and \
                (self.codes > self.cp_limit or
                 self.words > self.words_limit()):
            t = self.toks[self.s_start]
            if t.qmask:
                self.qwords -= 1
                self.qwords_changed = True
            self.words -= t.is_word
            self.codes -= t.lcp
            self.s_start += 1

    def submit(self):
        # WeightAndSubmit (snippetfunctor.cpp:676); qwords_changed fast
        # path skipped — full recompute is equivalent
        if not self.qwords:
            return
        self.calc()
        if self.pass_.qmask:
            self.flush()

    def calc(self):
        # CalcPassageWeight (snippetfunctor.cpp:871)
        p = self.pass_ = _Passage()
        p.min_gap = self.words_limit() - 1
        p.start_limit = 1 << 30
        p.end_limit = -(1 << 30)
        u_last = 0
        lcs = 1
        widx = -1
        around_after = 0
        for i in range(self.s_start, self.s_end):
            t = self.toks[i]
            if not t.is_word:
                continue
            widx += 1
            p.qmask |= t.qmask
            if t.qmask:
                p.start_limit = min(p.start_limit, i)
                p.end_limit = max(p.end_limit, i)
                p.qword_count += 1
            u_last = t.qmask & (u_last << 1)
            if u_last:
                lcs += 1
                p.max_lcs = max(lcs, p.max_lcs)
            else:
                lcs = 1
                u_last = t.qmask
            if t.qmask:
                p.min_gap = min(p.min_gap, widx, self.words - 1 - widx)
            if p.qmask == 0:
                self._around_before += 1
            around_after = 0 if t.qmask else around_after + 1
        p.min_gap = max(p.min_gap, 0)
        self._around_after = around_after
        m = p.qmask
        i = 0
        while m:
            if m & 1:
                p.qwords_weight += self.term_weights[i]
                p.uniq += 1
            m >>= 1
            i += 1
        p.qword_count *= 2

    @property
    def _around_before(self):
        return self.pass_.__dict__.setdefault("_ab", 0)

    @_around_before.setter
    def _around_before(self, v):
        self.pass_.__dict__["_ab"] = v

    @property
    def _around_after(self):
        return self.pass_.__dict__.setdefault("_aa", 0)

    @_around_after.setter
    def _around_after(self, v):
        self.pass_.__dict__["_aa"] = v

    def flush(self):
        # FlushPassage (snippetfunctor.cpp:720): copy span bounds, trim
        # leading/trailing context beyond `around` words per side
        p = self.pass_
        p.fld = self.fld
        p.start = self.s_start
        p.ntokens = self.s_end - self.s_start
        p.codes = self.codes
        p.words = self.words
        ab, aa = self._around_before, self._around_after
        while ab > self.around:
            t = self.toks[p.start]
            p.codes -= t.lcp
            ab -= t.is_word
            p.start += 1
            p.ntokens -= 1
            p.words -= t.is_word
        while aa > self.around:
            t = self.toks[p.start + p.ntokens - 1]
            p.codes -= t.lcp
            aa -= t.is_word
            p.ntokens -= 1
            p.words -= t.is_word
        self._append_context(p)

        if self.passages and self.passages[-1].fld == self.fld:
            last = self.passages[-1]
            if (p.start_limit <= last.start_limit
                    and last.end_limit <= p.end_limit) or \
               (last.start_limit <= p.start_limit
                    and p.end_limit <= last.end_limit):
                # overlapping: keep the better-centered/heavier one
                ppre = p.start_limit - p.start + 1
                ppost = p.start + p.ntokens - p.end_limit + 1
                pgap = max(ppre, ppost) / max(1, min(ppre, ppost))
                lpre = last.start_limit - last.start + 1
                lpost = last.start + last.ntokens - last.end_limit + 1
                lgap = max(lpre, lpost) / max(1, min(lpre, lpost))
                wl, wp = last.weight(), p.weight()
                if last.uniq <= p.uniq and \
                        (wl < wp or (wl == wp and pgap < lgap)):
                    self.passages[-1] = p.copy()
                return

        w = p.weight()
        qbit = -1                  # single-keyword slot (dead: count is 2x)
        while len(self.passages) > self.thresh:
            if p.qmask & ~self.ctx["qwords"]:
                break
            if qbit >= 0:
                if w <= self.ctx["qword_w"][qbit]:
                    return
                break
            tops = self.ctx["top_weights"]
            if self.thresh < len(tops) and w <= tops[self.thresh]:
                return
            break
        self.passages.append(p.copy())
        self.ctx["qwords"] |= p.qmask
        self.ctx["top_weights"].append(w)
        if len(self.ctx["top_weights"]) % self.thresh == 0:
            self.ctx["top_weights"].sort(reverse=True)

    def _append_context(self, p: _Passage):
        # AppendBeforeAfterTokens (snippetfunctor.cpp:954)
        if (self.limit == 0 or self.limit >= self.doclen_cp) and \
                not self.limit_words:
            return
        p.codes_between = p.codes
        p.words_between = p.words
        for i in range(p.start_limit - 1, p.start - 1, -1):
            t = self.toks[i]
            p.codes_between -= t.lcp
            p.words_between -= t.is_word
            p.before_toks.append((t.is_word, t.lcp))
        for i in range(p.end_limit + 1, p.start + p.ntokens):
            t = self.toks[i]
            p.codes_between -= t.lcp
            p.words_between -= t.is_word
            p.after_toks.append((t.is_word, t.lcp))


def _select_best(passages: list[_Passage], limit: int, limit_words: int,
                 limit_passages: int, found_mask: int,
                 term_weights: list[int], force_all: bool,
                 use_boundaries: bool, weight_order: bool
                 ) -> list[_Passage]:
    """SelectBestPassages (snippetpassage.cpp:94)."""
    if not passages:
        return []
    live = [p.copy() for p in passages]
    max_passages = min(len(live), limit_passages) if limit_passages \
        else len(live)
    max_words = limit_words or (1 << 30)
    max_cp = limit or (1 << 30)

    u_words = 0
    t_codes = t_words = 0
    tk_codes = tk_words = 0
    orig_weights = [p.qwords_weight for p in live]
    show: list[_Passage] = []
    got_all = False

    while len(show) < max_passages:
        best = -1
        for i, p in enumerate(live):
            if p.codes and (best == -1 or live[best].less(p)):
                best = i
        if best < 0:
            break
        bp = live[best]
        if not force_all or show:
            if tk_codes + bp.codes_between > max_cp or \
                    tk_words + bp.words_between > max_words:
                break
        fits = t_codes + bp.codes <= max_cp and t_words + bp.words \
            <= max_words
        if u_words == found_mask and not fits:
            # maybe room for a partial display of this one
            if t_codes + bp.codes_between <= max_cp and \
                    t_words + bp.words_between <= max_words:
                t_words += bp.words
                t_codes += bp.codes
                show.append(bp.copy())
            break
        show.append(bp.copy())
        u_words |= bp.qmask
        tk_words += bp.words_between
        tk_codes += bp.codes_between
        t_words += bp.words
        t_codes += bp.codes
        best_mask = bp.qmask
        bp.codes = 0               # mark consumed
        if not got_all and u_words == found_mask:
            got_all = True
            for p, w in zip(live, orig_weights):
                p.qwords_weight = w
        if got_all:
            continue
        for p in live:
            if not p.codes:
                continue
            m = best_mask
            bit = 0
            while m:
                if (m & 1) and (p.qmask & (1 << bit)):
                    p.qwords_weight -= term_weights[bit]
                    p.qword_count -= 1
                    p.uniq -= 1
                m >>= 1
                bit += 1
            p.qmask &= ~u_words

    # shave passage edges until the budget fits (snippetpassage.cpp:293)
    if (t_codes > max_cp or t_words > max_words) and not use_boundaries:
        first = True
        done = False
        codes_before = t_codes
        while not done:
            for i in range(len(show), 0, -1):
                p = show[i - 1]
                if not p.before_toks and not p.after_toks:
                    continue
                if len(p.before_toks) > len(p.after_toks):
                    drop_first = True
                elif len(p.before_toks) < len(p.after_toks):
                    drop_first = False
                elif not p.before_toks[-1][0] and p.after_toks[-1][0]:
                    drop_first = True
                elif p.before_toks[-1][0] and not p.after_toks[-1][0]:
                    drop_first = False
                else:
                    drop_first = first
                if drop_first:
                    isw, lcp = p.before_toks.pop()
                    p.start += 1
                else:
                    isw, lcp = p.after_toks.pop()
                p.ntokens -= 1
                p.codes -= lcp
                t_codes -= lcp
                t_words -= isw
                if t_codes <= max_cp and t_words <= max_words:
                    done = True
                    break
            if t_codes == codes_before:
                break              # nothing left to shave
            codes_before = t_codes
            first = not first

    # limit is sacred: drop least significant passages
    while (t_codes > max_cp or t_words > max_words) and not force_all \
            and show:
        t_codes -= show[-1].codes
        t_words -= show[-1].words
        show.pop()

    # reference always sorts the selection in document order
    # (PassagePositionOrder_fn, snippetpassage.cpp:271); weight_order only
    # reorders the RENDERED texts afterwards (WeightedPassageSort_fn)
    show.sort(key=lambda p: (p.fld, p.start))
    return show


def _clip_ranges(sel: list[_Passage]) -> list[tuple[_Passage, int, int]]:
    """Render ranges for position-ordered selected passages.

    The reference emitter assigns each token to the FIRST passage containing
    it, scanning forward only (PassageHighlighter_c::UpdatePassage,
    snippetfunctor.cpp:1160-1188), so overlapping selections render
    disjoint spans: a later passage only renders its suffix past the
    previous passage's end. Fully-covered passages render nothing."""
    out = []
    prev_hi = 0
    for p in sel:
        lo = max(p.start, prev_hi)
        hi = p.start + p.ntokens
        prev_hi = max(prev_hi, hi)
        if lo < hi:
            out.append((p, lo, hi))
    return out


# ---------------------------------------------------------------------------
# rendering

def _render_span(toks: list[_Tok], lo: int, hi: int, before: str,
                 after: str, pid: list | None = None) -> str:
    """Wrap matches in tags, folding ADJACENT hits (matched words with
    only gap tokens between them) into one tag pair — FoldHitsIntoSpans
    (sphinxexcerpt.cpp): "<b>be, to it</b>", not three separate wraps."""
    out = []
    i = lo
    while i < hi:
        t = toks[i]
        if not t.qmask:
            out.append(t.text)
            i += 1
            continue
        end = i                    # extend over gaps onto further hits
        j = i + 1
        while True:
            while j < hi and not toks[j].is_word:
                j += 1
            if j < hi and toks[j].qmask:
                end = j
                j += 1
            else:
                break
        b, a = before, after
        if pid is not None:
            # whole-doc mode: %PASSAGE_ID% advances per emitted match
            # span (QueryHighlighter_c, snippetfunctor.cpp)
            b = b.replace("%PASSAGE_ID%", str(pid[0]))
            a = a.replace("%PASSAGE_ID%", str(pid[0]))
            pid[0] += 1
        out.append(b)
        out.extend(toks[k].text for k in range(i, end + 1))
        out.append(a)
        i = end + 1
    return "".join(out)


def _doc_start_clip(toks: list[_Tok], limit: int, separator: str) -> str:
    """DocStartHighlighter_c (snippetfunctor.cpp:300): emit whole tokens
    from the doc start while they fit the char limit; append the chunk
    separator when clipped."""
    out = []
    cp = 0
    for t in toks:
        ok = limit <= 0 or cp + t.lcp <= limit
        if ok or not out:
            out.append(t.text)
            cp += t.lcp
        if not ok:
            out.append(separator)
            break
    return "".join(out)


def _can_highlight_all(doclen_cp: int, limit: int, limit_words: int,
                       force_passages: bool, limit_passages: int,
                       passage_boundary: str = "") -> bool:
    # CanHighlightAll (sphinxexcerpt.cpp:685): a passage-boundary SPZ mode
    # always forces passage extraction (m_ePassageSPZ==SPH_SPZ_NONE check)
    all_ = (limit == 0 or limit >= doclen_cp) and \
        (limit_words == 0 or limit_words > doclen_cp // 2) and \
        not passage_boundary
    if all_ and force_passages and (limit or limit_words or limit_passages):
        all_ = False
    return all_


def _highlight_all(toks: list[_Tok], before: str, after: str,
                   pid: list | None = None) -> str:
    return _render_span(toks, 0, len(toks), before, after, pid)


def _tags(opts: SnippetOptions, pid: int) -> tuple[str, str]:
    return (opts.before_match.replace("%PASSAGE_ID%", str(pid)),
            opts.after_match.replace("%PASSAGE_ID%", str(pid)))


def highlight_fragments(text: str, query: str, tokenizer: Tokenizer,
                        dictionary: Dictionary,
                        opts: SnippetOptions | None = None,
                        limit: int | None = None,
                        limit_words: int | None = None,
                        limit_passages: int | None = None,
                        ) -> list[str]:
    """One field of json "highlight": returns the fragment list (each
    selected passage is its own item; whole-doc item when the text fits;
    doc-start clip when the field has no hits; [] when allow_empty)."""
    opts = opts or SnippetOptions()
    limit = opts.limit if limit is None else limit
    limit_words = opts.limit_words if limit_words is None else limit_words
    limit_passages = opts.limit_passages if limit_passages is None \
        else limit_passages
    if opts.html_strip_mode == "strip":
        from ..text.htmlstrip import strip_html
        text = strip_html(text, (), {})
    terms = None
    if opts.query_mode:
        terms = _query_mode_terms(query, tokenizer, dictionary, text)
    if terms is None:
        terms = _query_terms(query, tokenizer, dictionary)
    toks = _stream(text, tokenizer)
    found = _mark(toks, dictionary, terms, opts.exact_phrase)
    if not found:
        if opts.allow_empty:
            return []
        clip = _doc_start_clip(toks, limit, opts.chunk_separator)
        return [clip] if clip else []
    if _can_highlight_all(len(text), limit, limit_words,
                          opts.force_passages, limit_passages,
                          opts.passage_boundary):
        return [_highlight_all(toks, opts.before_match, opts.after_match,
                               [opts.start_passage_id])]
    passages: list[_Passage] = []
    ctx = {"qwords": 0, "top_weights": [], "qword_w": [0] * 32}
    weights = [len(t) for t in terms]
    ex = _Extractor(toks, opts.around, limit, limit_words, limit_passages,
                    opts.force_all_words, found, weights, len(text), 0,
                    passages, ctx, opts.passage_boundary)
    ex.run()
    sel = _select_best(passages, limit, limit_words, limit_passages,
                       found, weights, opts.force_all_words,
                       opts.use_boundaries, opts.weight_order)
    out = []
    pid = opts.start_passage_id
    for p, lo, hi in _clip_ranges(sel):
        b, a = _tags(opts, pid)
        pid += 1
        out.append((p.weight(), _render_span(toks, lo, hi, b, a)))
    if opts.weight_order:
        out.sort(key=lambda t: -t[0])
    return [s for _, s in out]


def _query_mode_terms(query: str, tokenizer: Tokenizer,
                      dictionary: Dictionary, text: str):
    """query_mode=1: parse the full query syntax, evaluate the boolean
    tree against the document's term set, and return only the terms of
    MATCHED subtrees — 'aaa|(bbb ccc)' over 'aaa bbb ddd' highlights
    only aaa (the reference runs the real ExtNode tree over a one-doc
    index; golden test_232). Returns None to fall back to bag-of-words
    (unparseable query / operators we approximate)."""
    from ..query import ast as A
    from ..query.ftparser import FtQueryParser
    try:
        tree = FtQueryParser(tokenizer, dictionary, []).parse(query)
    except Exception:   # noqa: BLE001 — unparsable: bag-of-words
        return None
    doc_terms: set = set()
    for t in tokenizer.tokenize(text):
        doc_terms.update(dictionary.process(t.text))
        doc_terms.add(t.text)

    def matched(nd) -> bool:
        if nd is None or isinstance(nd, (A.QAll, A.QGap)):
            return True
        if isinstance(nd, A.QTerm):
            if nd.wildcard:
                pat = nd.word.strip("*")
                return any(pat in w for w in doc_terms)
            return nd.word in doc_terms
        if isinstance(nd, A.QAnd):
            out_m = True
            for c in nd.children:
                if isinstance(c, A.QNot):
                    out_m &= not matched(c.child)
                else:
                    out_m &= matched(c)
            return out_m
        if isinstance(nd, A.QOr):
            return any(matched(c) for c in nd.children)
        if isinstance(nd, (A.QPhrase,)):
            return all(w in doc_terms or w == "\x00" for w in nd.words)
        if isinstance(nd, A.QQuorum):
            return sum(1 for w in nd.words if w in doc_terms) >= nd.m
        if isinstance(nd, A.QAndNot):
            return matched(nd.left) and not matched(nd.right)
        if isinstance(nd, A.QMaybe):
            return matched(nd.left)
        if isinstance(nd, (A.QNear, A.QSentence)):
            return matched(nd.left) and matched(nd.right)
        return True

    out: list[str] = []

    def _add(w):
        if w and w != "\x00" and w not in out:
            out.append(w)

    def emit(nd):
        """Collect highlightable terms from nd, assuming nd matched."""
        if nd is None or isinstance(nd, (A.QAll, A.QGap, A.QNot)):
            return
        if isinstance(nd, A.QTerm):
            _add(("*" + nd.word.strip("*") + "*")
                 if nd.wildcard else nd.word)
        elif isinstance(nd, A.QAnd):
            for c in nd.children:
                if not isinstance(c, A.QNot):
                    emit(c)
        elif isinstance(nd, A.QOr):
            for c in nd.children:
                if matched(c):
                    emit(c)
        elif isinstance(nd, A.QPhrase):
            for w in nd.words:
                _add(w)
        elif isinstance(nd, A.QQuorum):
            for w in nd.words:
                if w in doc_terms:
                    _add(w)
        elif isinstance(nd, A.QAndNot):
            emit(nd.left)
        elif isinstance(nd, A.QMaybe):
            emit(nd.left)
            if matched(nd.right):
                emit(nd.right)
        elif isinstance(nd, (A.QNear, A.QSentence)):
            emit(nd.left)
            emit(nd.right)

    if matched(tree):
        emit(tree)
    return out[:32]


def build_snippet(text: str, query: str, tokenizer: Tokenizer,
                  dictionary: Dictionary,
                  opts: SnippetOptions | None = None) -> str:
    """CALL SNIPPETS / HIGHLIGHT() surface: single string, passages joined
    with the chunk separator, edge separators when the doc was clipped
    (HighlightPassages, sphinxexcerpt.cpp)."""
    opts = opts or SnippetOptions()
    if opts.html_strip_mode == "strip":
        from ..text.htmlstrip import strip_html
        text = strip_html(text, (), {})
    terms = None
    if opts.query_mode:
        terms = _query_mode_terms(query, tokenizer, dictionary, text)
    if terms is None:
        terms = _query_terms(query, tokenizer, dictionary)
    toks = _stream(text, tokenizer)
    found = _mark(toks, dictionary, terms, opts.exact_phrase)
    if not found:
        if opts.allow_empty:
            return ""
        return _doc_start_clip(toks, opts.limit, opts.chunk_separator)
    if _can_highlight_all(len(text), opts.limit, opts.limit_words,
                          opts.force_passages, opts.limit_passages,
                          opts.passage_boundary):
        return _highlight_all(toks, opts.before_match, opts.after_match,
                              [opts.start_passage_id])
    passages: list[_Passage] = []
    ctx = {"qwords": 0, "top_weights": [], "qword_w": [0] * 32}
    weights = [len(t) for t in terms]
    ex = _Extractor(toks, opts.around, opts.limit, opts.limit_words,
                    opts.limit_passages, opts.force_all_words, found,
                    weights, len(text), 0, passages, ctx,
                    opts.passage_boundary)
    ex.run()
    sel = _select_best(passages, opts.limit, opts.limit_words,
                       opts.limit_passages, found, weights,
                       opts.force_all_words, opts.use_boundaries,
                       opts.weight_order)
    pieces = []
    pid = opts.start_passage_id
    for p, lo, hi in _clip_ranges(sel):
        b, a = _tags(opts, pid)
        pid += 1
        pieces.append((p.weight(), _render_span(toks, lo, hi, b, a)))
    if opts.weight_order:
        pieces.sort(key=lambda t: -t[0])
    snippet = opts.chunk_separator.join(s for _, s in pieces)
    if sel and sel[0].start > 0:
        snippet = opts.chunk_separator + snippet
    if sel and sel[-1].start + sel[-1].ntokens < len(toks):
        snippet = snippet + opts.chunk_separator
    return snippet
