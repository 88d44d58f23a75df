"""Morphology processors (reference: SPH_MORPH_* dispatch, sphinx.cpp:16695+).

stem_en is the classic Porter (1980) algorithm, which is what the reference's
sphinxstemen.cpp implements; soundex and metaphone follow the standard
published algorithms (reference: sphinxsoundex.cpp / sphinxmetaphone.cpp).
These run host-side only, at index and query time.
"""
from __future__ import annotations

from typing import Callable

_VOWELS = "aeiou"


def _is_cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences in the stem."""
    m = 0
    prev_v = False
    for i in range(len(stem)):
        v = not _is_cons(stem, i)
        if prev_v and not v:
            m += 1
        prev_v = v
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    if not (_is_cons(w, len(w) - 3) and not _is_cons(w, len(w) - 2) and _is_cons(w, len(w) - 1)):
        return False
    return w[-1] not in "wxy"


def porter_stem(word: str) -> str:
    w = word
    if len(w) <= 2 or not w.isascii() or not w.isalpha():
        return word

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("bli", "ble"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
        ("logi", "log"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    continue
                w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


def soundex(word: str) -> str:
    """Exact replica of stem_soundex (sphinxsoundex.cpp:14-39). NOT
    standard Soundex: dedup compares against the last EMITTED char (codes
    collapse across vowels; the first letter never matches a digit), and
    zero-padding stops at the original word length."""
    if not word or not all("a" <= c <= "z" for c in word):
        return word
    table = "01230120022455012623010202"
    out = [word[0]]
    for c in word[1:]:
        code = table[ord(c) - ord("a")]
        if code != "0" and out[-1] != code:
            out.append(code)
    while len(out) < 4 and len(out) < len(word):
        out.append("0")
    return "".join(out)


_MORPHS: dict[str, Callable[[str], str]] = {
    "stem_en": porter_stem,
    "soundex": soundex,
    "none": lambda w: w,
}


def _register_late():
    _MORPHS["lemmatize_en"] = lemmatize_en
    _MORPHS["lemmatize_en_all"] = lemmatize_en_all
    _MORPHS["stem_ru"] = russian_stem
    _MORPHS["metaphone"] = metaphone
    _MORPHS["stem_enru"] = lambda w: (russian_stem(w) if any(
        "\u0400" <= c <= "\u04ff" for c in w) else porter_stem(w))


# libstemmer language pack (reference vendors libstemmer_c the same way,
# SURVEY #52): Snowball algorithms for 15 languages via the environment's
# nltk implementation, loaded lazily per language. Accepts both the
# reference's config names (libstemmer_german / libstemmer_de) and short
# stem_de-style aliases.
_LIBSTEMMER_LANGS = {
    "ar": "arabic", "da": "danish", "nl": "dutch", "en": "english",
    "fi": "finnish", "fr": "french", "de": "german", "hu": "hungarian",
    "it": "italian", "no": "norwegian", "pt": "portuguese",
    "ro": "romanian", "ru": "russian", "es": "spanish", "sv": "swedish",
}
_LANG_BY_NAME = {v: v for v in _LIBSTEMMER_LANGS.values()}
_LANG_BY_NAME.update(_LIBSTEMMER_LANGS)


def _load_libstemmer(lang: str) -> Callable[[str], str]:
    from nltk.stem.snowball import SnowballStemmer
    st = SnowballStemmer(lang)
    stem = st.stem

    def run(word: str) -> str:
        out = stem(word)
        return out if out else word
    return run


def get_morph(name: str) -> Callable[[str], str]:
    if "stem_ru" not in _MORPHS:
        _register_late()
    if name not in _MORPHS:
        lang = None
        if name.startswith("libstemmer_"):
            lang = _LANG_BY_NAME.get(name[len("libstemmer_"):])
        elif name.startswith("stem_") and len(name) == 7:
            lang = _LIBSTEMMER_LANGS.get(name[5:])
        if lang is not None:
            try:
                _MORPHS[name] = _load_libstemmer(lang)
            except ImportError:
                raise ValueError(
                    f"morphology {name!r} needs the snowball language "
                    f"pack, which is unavailable in this build")
        else:
            raise ValueError(f"unknown morphology processor: {name!r}")
    return _MORPHS[name]


# ---------------------------------------------------------------------------
# Russian stemmer — the standard Snowball russian algorithm
# (reference sphinxstemru.cpp implements the same algorithm).
_RU_VOWELS = "аеиоуыэюя"

_RU_PERFECTIVE_1 = ("в", "вши", "вшись")                  # require preceding а/я
_RU_PERFECTIVE_2 = ("ив", "ивши", "ившись", "ыв", "ывши", "ывшись")
_RU_ADJECTIVE = ("ее", "ие", "ые", "ое", "ими", "ыми", "ей", "ий", "ый",
                 "ой", "ем", "им", "ым", "ом", "его", "ого", "ему", "ому",
                 "их", "ых", "ую", "юю", "ая", "яя", "ою", "ею")
_RU_PARTICIPLE_1 = ("ем", "нн", "вш", "ющ", "щ")          # require а/я
_RU_PARTICIPLE_2 = ("ивш", "ывш", "ующ")
_RU_REFLEXIVE = ("ся", "сь")
_RU_VERB_1 = ("ла", "на", "ете", "йте", "ли", "й", "л", "ем", "н", "ло",
              "но", "ет", "ют", "ны", "ть", "ешь", "нно")  # require а/я
_RU_VERB_2 = ("ила", "ыла", "ена", "ейте", "уйте", "ите", "или", "ыли",
              "ей", "уй", "ил", "ыл", "им", "ым", "ен", "ило", "ыло",
              "ено", "ят", "ует", "уют", "ит", "ыт", "ены", "ить", "ыть",
              "ишь", "ую", "ю")
_RU_NOUN = ("а", "ев", "ов", "ие", "ье", "е", "иями", "ями", "ами", "еи",
            "ии", "и", "ией", "ей", "ой", "ий", "й", "иям", "ям", "ием",
            "ем", "ам", "ом", "о", "у", "ах", "иях", "ях", "ы", "ь", "ию",
            "ью", "ю", "ия", "ья", "я")
_RU_SUPERLATIVE = ("ейш", "ейше")
_RU_DERIVATIONAL = ("ост", "ость")


def _ru_rv(word: str) -> int:
    for i, c in enumerate(word):
        if c in _RU_VOWELS:
            return i + 1
    return len(word)


def _ru_ends(word: str, rv: int, suffixes, require_ay: bool = False):
    """Longest matching suffix within RV; require_ay: char before the suffix
    must be а or я (group-1 endings in the snowball spec)."""
    best = None
    for suf in suffixes:
        if word.endswith(suf) and len(word) - len(suf) >= rv:
            if require_ay:
                i = len(word) - len(suf) - 1
                if i < 0 or word[i] not in "ая":
                    continue
            if best is None or len(suf) > len(best):
                best = suf
    return best


def russian_stem(word: str) -> str:
    w = word.lower().replace("ё", "е")
    if not w or not any(c in _RU_VOWELS for c in w):
        return word
    rv = _ru_rv(w)

    # step 1: perfective gerund, else adjectival / reflexive+verb / noun
    suf = _ru_ends(w, rv, _RU_PERFECTIVE_2) or \
        _ru_ends(w, rv, _RU_PERFECTIVE_1, require_ay=True)
    if suf:
        w = w[: -len(suf)]
    else:
        adj = _ru_ends(w, rv, _RU_ADJECTIVE)
        if adj:
            w = w[: -len(adj)]
            part = _ru_ends(w, rv, _RU_PARTICIPLE_2) or \
                _ru_ends(w, rv, _RU_PARTICIPLE_1, require_ay=True)
            if part:
                w = w[: -len(part)]
        else:
            refl = _ru_ends(w, rv, _RU_REFLEXIVE)
            if refl:
                w = w[: -len(refl)]
            verb = _ru_ends(w, rv, _RU_VERB_2) or \
                _ru_ends(w, rv, _RU_VERB_1, require_ay=True)
            if verb:
                w = w[: -len(verb)]
            else:
                noun = _ru_ends(w, rv, _RU_NOUN)
                if noun:
                    w = w[: -len(noun)]

    # step 2: drop trailing и
    if w.endswith("и") and len(w) - 1 >= rv:
        w = w[:-1]

    # step 3: derivational (R2 check approximated by RV here, like many
    # lightweight ports; exact R2 TODO)
    der = _ru_ends(w, rv, _RU_DERIVATIONAL)
    if der:
        w = w[: -len(der)]

    # step 4
    if w.endswith("нн"):
        w = w[:-1]
    else:
        sup = _ru_ends(w, rv, _RU_SUPERLATIVE)
        if sup:
            w = w[: -len(sup)]
            if w.endswith("нн"):
                w = w[:-1]
    if w.endswith("ь") and len(w) - 1 >= rv:
        w = w[:-1]
    return w or word


# ---------------------------------------------------------------------------
# Double Metaphone (Lawrence Philips, 2000) — the algorithm the reference's
# stem_dmetaphone implements (sphinxmetaphone.cpp:586): UPPERCASE primary
# code, no length cap, and words containing non-ASCII codepoints other than
# C-cedilla / N-tilde pass through unchanged.

def _dm_slavo_germanic(w: str) -> bool:
    return "W" in w or "K" in w or "CZ" in w or "WITZ" in w


def metaphone(word: str) -> str:
    up = word.upper()
    for c in up:
        o = ord(c)
        if o > 128 and o not in (0xC7, 0xE7, 0xD1, 0xF1):
            return word
    w = up.replace(chr(0xC7), "\x80").replace(chr(0xE7), "\x80") \
          .replace(chr(0xD1), "\x81").replace(chr(0xF1), "\x81")
    # internal markers: \x80 = C-cedilla, \x81 = N-tilde
    n = len(w)
    pad = w + " " * 10
    vowels = "AEIOUY"

    def at(i):
        return pad[i] if i >= 0 else ""

    def stringat(start, length, *subs):
        if start < 0:
            return False
        piece = pad[start:start + length]
        return piece in subs

    def isvowel(i):
        return 0 <= i < n and pad[i] in vowels

    sg = _dm_slavo_germanic(w)
    pri: list[str] = []
    i = 0

    if stringat(0, 2, "GN", "KN", "PN", "WR", "PS"):
        i = 1
    if at(0) == "X":
        pri.append("S")
        i = 1

    while i < n:
        c = pad[i]
        if c in "AEIOUY":
            if i == 0:
                pri.append("A")
            i += 1
        elif c == "\x80":                      # C-cedilla
            pri.append("S")
            i += 1
        elif c == "\x81":                      # N-tilde
            pri.append("N")
            i += 1
        elif c == "B":
            pri.append("P")
            i += 2 if at(i + 1) == "B" else 1
        elif c == "C":
            # germanic CH as K: e.g. 'ACH-' but not 'BACHER'/'MACHER'
            if i > 1 and not isvowel(i - 2) and stringat(i - 1, 3, "ACH") \
                    and at(i + 2) != "I" \
                    and (at(i + 2) != "E"
                         or stringat(i - 2, 6, "BACHER", "MACHER")):
                pri.append("K")
                i += 2
            elif i == 0 and stringat(0, 6, "CAESAR"):
                pri.append("S")
                i += 2
            elif stringat(i, 4, "CHIA"):
                pri.append("K")
                i += 2
            elif stringat(i, 2, "CH"):
                if i > 0 and stringat(i, 4, "CHAE"):
                    pri.append("K")
                elif i == 0 and (stringat(i + 1, 5, "HARAC", "HARIS")
                                 or stringat(i + 1, 3, "HOR", "HYM", "HIA",
                                             "HEM")) \
                        and not stringat(0, 5, "CHORE"):
                    pri.append("K")
                elif stringat(0, 4, "VAN ", "VON ") \
                        or stringat(0, 3, "SCH") \
                        or stringat(i - 2, 6, "ORCHES", "ARCHIT", "ORCHID") \
                        or stringat(i + 2, 1, "T", "S") \
                        or ((stringat(i - 1, 1, "A", "O", "U", "E")
                             or i == 0)
                            and stringat(i + 2, 1, "L", "R", "N", "M", "B",
                                         "H", "F", "V", "W", " ")):
                    pri.append("K")
                elif i > 0:
                    pri.append("K" if stringat(0, 2, "MC") else "X")
                else:
                    pri.append("X")
                i += 2
            elif stringat(i, 2, "CZ") and not stringat(i - 2, 4, "WICZ"):
                pri.append("S")
                i += 2
            elif stringat(i + 1, 3, "CIA"):
                pri.append("X")
                i += 3
            elif stringat(i, 2, "CC") and not (i == 1 and at(0) == "M"):
                if stringat(i + 2, 1, "I", "E", "H") \
                        and not stringat(i + 2, 2, "HU"):
                    if (i == 1 and at(i - 1) == "A") \
                            or stringat(i - 1, 5, "UCCEE", "UCCES"):
                        pri.append("KS")
                    else:
                        pri.append("X")
                    i += 3
                else:
                    pri.append("K")
                    i += 2
            elif stringat(i, 2, "CK", "CG", "CQ"):
                pri.append("K")
                i += 2
            elif stringat(i, 2, "CI", "CE", "CY"):
                pri.append("S")
                i += 2
            else:
                pri.append("K")
                if stringat(i + 1, 2, " C", " Q", " G"):
                    i += 3
                elif stringat(i + 1, 1, "C", "K", "Q") \
                        and not stringat(i + 1, 2, "CE", "CI"):
                    i += 2
                else:
                    i += 1
        elif c == "D":
            if stringat(i, 2, "DG"):
                if stringat(i + 2, 1, "I", "E", "Y"):
                    pri.append("J")
                    i += 3
                else:
                    pri.append("TK")
                    i += 2
            elif stringat(i, 2, "DT", "DD"):
                pri.append("T")
                i += 2
            else:
                pri.append("T")
                i += 1
        elif c == "F":
            pri.append("F")
            i += 2 if at(i + 1) == "F" else 1
        elif c == "G":
            if at(i + 1) == "H":
                if i > 0 and not isvowel(i - 1):
                    pri.append("K")
                    i += 2
                elif i == 0:
                    if at(i + 2) == "I":
                        pri.append("J")
                    else:
                        pri.append("K")
                    i += 2
                elif (i > 1 and stringat(i - 2, 1, "B", "H", "D")) \
                        or (i > 2 and stringat(i - 3, 1, "B", "H", "D")) \
                        or (i > 3 and stringat(i - 4, 1, "B", "H")):
                    i += 2
                else:
                    if i > 2 and at(i - 1) == "U" \
                            and stringat(i - 3, 1, "C", "G", "L", "R", "T"):
                        pri.append("F")
                    elif i > 0 and at(i - 1) != "I":
                        pri.append("K")
                    i += 2
            elif at(i + 1) == "N":
                if i == 1 and isvowel(0) and not sg:
                    pri.append("KN")
                elif not stringat(i + 2, 2, "EY") and at(i + 1) != "Y" \
                        and not sg:
                    pri.append("N")
                else:
                    pri.append("KN")
                i += 2
            elif stringat(i + 1, 2, "LI") and not sg:
                pri.append("KL")
                i += 2
            elif i == 0 and (at(i + 1) == "Y"
                             or stringat(i + 1, 2, "ES", "EP", "EB", "EL",
                                         "EY", "IB", "IL", "IN", "IE",
                                         "EI", "ER")):
                pri.append("K")
                i += 2
            elif (stringat(i + 1, 2, "ER") or at(i + 1) == "Y") \
                    and not stringat(0, 6, "DANGER", "RANGER", "MANGER") \
                    and not stringat(i - 1, 1, "E", "I") \
                    and not stringat(i - 1, 3, "RGY", "OGY"):
                pri.append("K")
                i += 2
            elif stringat(i + 1, 1, "E", "I", "Y") \
                    or stringat(i - 1, 4, "AGGI", "OGGI"):
                if stringat(0, 4, "VAN ", "VON ") or stringat(0, 3, "SCH") \
                        or stringat(i + 1, 2, "ET"):
                    pri.append("K")
                elif stringat(i + 1, 4, "IER "):
                    pri.append("J")
                else:
                    pri.append("J")
                i += 2
            else:
                pri.append("K")
                i += 2 if at(i + 1) == "G" else 1
        elif c == "H":
            if (i == 0 or isvowel(i - 1)) and isvowel(i + 1):
                pri.append("H")
                i += 2
            else:
                i += 1
        elif c == "J":
            if stringat(i, 4, "JOSE") or stringat(0, 4, "SAN "):
                if (i == 0 and at(i + 4) == " ") or stringat(0, 4, "SAN "):
                    pri.append("H")
                else:
                    pri.append("J")
                i += 1
            else:
                if i == 0 and not stringat(i, 4, "JOSE"):
                    pri.append("J")
                elif isvowel(i - 1) and not sg \
                        and (at(i + 1) == "A" or at(i + 1) == "O"):
                    pri.append("J")
                elif i == n - 1:
                    pri.append("J")
                elif not stringat(i + 1, 1, "L", "T", "K", "S", "N", "M",
                                  "B", "Z") \
                        and not stringat(i - 1, 1, "S", "K", "L"):
                    pri.append("J")
                i += 2 if at(i + 1) == "J" else 1
        elif c == "K":
            pri.append("K")
            i += 2 if at(i + 1) == "K" else 1
        elif c == "L":
            if at(i + 1) == "L":
                i += 2
            else:
                i += 1
            pri.append("L")
        elif c == "M":
            pri.append("M")
            if (stringat(i - 1, 3, "UMB")
                    and (i + 1 == n - 1 or stringat(i + 2, 2, "ER"))) \
                    or at(i + 1) == "M":
                i += 2
            else:
                i += 1
        elif c == "N":
            pri.append("N")
            i += 2 if at(i + 1) == "N" else 1
        elif c == "P":
            if at(i + 1) == "H":
                pri.append("F")
                i += 2
            else:
                pri.append("P")
                i += 2 if stringat(i + 1, 1, "P", "B") else 1
        elif c == "Q":
            pri.append("K")
            i += 2 if at(i + 1) == "Q" else 1
        elif c == "R":
            # french ending e.g. 'rogier' drops to secondary only
            if not (i == n - 1 and not sg
                    and stringat(i - 2, 2, "IE")
                    and not stringat(i - 4, 2, "ME", "MA")):
                pri.append("R")
            i += 2 if at(i + 1) == "R" else 1
        elif c == "S":
            if stringat(i - 1, 3, "ISL", "YSL"):
                i += 1
            elif i == 0 and stringat(i, 5, "SUGAR"):
                pri.append("X")
                i += 1
            elif stringat(i, 2, "SH"):
                if stringat(i + 1, 4, "HEIM", "HOEK", "HOLM", "HOLZ"):
                    pri.append("S")
                else:
                    pri.append("X")
                i += 2
            elif stringat(i, 3, "SIO", "SIA") or stringat(i, 4, "SIAN"):
                pri.append("S")
                i += 3
            elif (i == 0 and stringat(i + 1, 1, "M", "N", "L", "W")) \
                    or stringat(i + 1, 1, "Z"):
                pri.append("S")
                i += 2 if stringat(i + 1, 1, "Z") else 1
            elif stringat(i, 2, "SC"):
                if at(i + 2) == "H":
                    if stringat(i + 3, 2, "OO", "ER", "EN", "UY", "ED",
                                "EM"):
                        if stringat(i + 3, 2, "ER", "EN"):
                            pri.append("X")
                        else:
                            pri.append("SK")
                        i += 3
                    else:
                        pri.append("X")
                        i += 3
                elif stringat(i + 2, 1, "I", "E", "Y"):
                    pri.append("S")
                    i += 3
                else:
                    pri.append("SK")
                    i += 3
            else:
                if not (i == n - 1 and stringat(i - 2, 2, "AI", "OI")):
                    pri.append("S")
                i += 2 if stringat(i + 1, 1, "S", "Z") else 1
        elif c == "T":
            if stringat(i, 4, "TION") or stringat(i, 3, "TIA", "TCH"):
                pri.append("X")
                i += 3
            elif stringat(i, 2, "TH") or stringat(i, 3, "TTH"):
                if stringat(i + 2, 2, "OM", "AM") \
                        or stringat(0, 4, "VAN ", "VON ") \
                        or stringat(0, 3, "SCH"):
                    pri.append("T")
                else:
                    pri.append("0")
                i += 2
            else:
                pri.append("T")
                i += 2 if stringat(i + 1, 1, "T", "D") else 1
        elif c == "V":
            pri.append("F")
            i += 2 if at(i + 1) == "V" else 1
        elif c == "W":
            if stringat(i, 2, "WR"):
                pri.append("R")
                i += 2
            else:
                if i == 0 and (isvowel(i + 1) or stringat(i, 2, "WH")):
                    if isvowel(i + 1):
                        pri.append("A")
                    else:
                        pri.append("A")
                if (i == n - 1 and isvowel(i - 1)) \
                        or stringat(i - 1, 5, "EWSKI", "EWSKY", "OWSKI",
                                    "OWSKY") \
                        or stringat(0, 3, "SCH"):
                    i += 1
                elif stringat(i, 4, "WICZ", "WITZ"):
                    pri.append("TS")
                    i += 4
                else:
                    i += 1
        elif c == "X":
            if not (i == n - 1
                    and (stringat(i - 3, 3, "IAU", "EAU")
                         or stringat(i - 2, 2, "AU", "OU"))):
                pri.append("KS")
            i += 2 if stringat(i + 1, 1, "C", "X") else 1
        elif c == "Z":
            if at(i + 1) == "H":
                pri.append("J")
                i += 2
            else:
                pri.append("S")
                i += 2 if at(i + 1) == "Z" else 1
        else:
            i += 1
    return "".join(pri)


# ---------------------------------------------------------------------------
# English lemmatizer (reference: sphinxaot.cpp CLemmatizer — dictionary-
# driven AOT lemmatization over en.pak). The .pak dictionary packs are not
# redistributable data and do not ship in this environment, so this is a
# rule/exception analog with the same interface and the same pipeline
# semantics: `lemmatize_en` emits the primary lemma, `lemmatize_en_all`
# emits every candidate at the same position (sphinxaot.cpp
# CSphAotTokenizer dual-form emission). The ru/de/uk packs stay
# data-gated (get_morph raises for them).

_EN_IRREGULAR = {
    # plurals
    "men": "man", "women": "woman", "children": "child", "mice": "mouse",
    "feet": "foot", "teeth": "tooth", "geese": "goose", "people": "people",
    "oxen": "ox", "lice": "louse", "dice": "die", "data": "datum",
    "criteria": "criterion", "phenomena": "phenomenon",
    # be / irregular verbs (most common forms)
    "is": "be", "are": "be", "am": "be", "was": "be", "were": "be",
    "been": "be", "being": "be",
    "has": "have", "had": "have", "having": "have",
    "does": "do", "did": "do", "done": "do", "doing": "do",
    "went": "go", "gone": "go", "goes": "go", "going": "go",
    "saw": "see", "seen": "see", "ran": "run", "running": "run",
    "came": "come", "coming": "come", "took": "take", "taken": "take",
    "taking": "take", "made": "make", "making": "make",
    "said": "say", "got": "get", "gotten": "get", "getting": "get",
    "gave": "give", "given": "give", "giving": "give",
    "found": "find", "thought": "think", "told": "tell", "knew": "know",
    "known": "know", "wrote": "write", "written": "write",
    "writing": "write", "left": "leave", "felt": "feel", "kept": "keep",
    "held": "hold", "brought": "bring", "began": "begin",
    "begun": "begin", "showed": "show", "shown": "show",
    "heard": "hear", "meant": "mean", "met": "meet", "paid": "pay",
    "sat": "sit", "stood": "stand", "lost": "lose", "led": "lead",
    "read": "read", "grew": "grow", "grown": "grow", "flew": "fly",
    "flown": "fly", "drew": "draw", "drawn": "draw", "spoke": "speak",
    "spoken": "speak", "sent": "send", "built": "build", "spent": "spend",
    "fell": "fall", "fallen": "fall", "bought": "buy", "caught": "catch",
    "taught": "teach", "sought": "seek", "fought": "fight",
    "sold": "sell", "wore": "wear", "worn": "wear", "chose": "choose",
    "chosen": "choose", "broke": "break", "broken": "break",
    "ate": "eat", "eaten": "eat", "drove": "drive", "driven": "drive",
    "rode": "ride", "ridden": "ride", "rose": "rise", "risen": "rise",
    "sang": "sing", "sung": "sing", "swam": "swim", "swum": "swim",
    "threw": "throw", "thrown": "throw", "woke": "wake", "woken": "wake",
    "won": "win", "laid": "lay", "lain": "lie", "lay": "lie",
    "slept": "sleep", "struck": "strike", "hung": "hang",
    # adjectives
    "better": "good", "best": "good", "worse": "bad", "worst": "bad",
    "further": "far", "farther": "far", "furthest": "far",
    "farthest": "far",
}

# nouns whose -ves plural restores -f / -fe
_EN_VES_F = {"wolves": "wolf", "leaves": "leaf", "knives": "knife",
             "wives": "wife", "lives": "life", "shelves": "shelf",
             "halves": "half", "selves": "self", "calves": "calf",
             "loaves": "loaf", "thieves": "thief", "scarves": "scarf"}

_EN_VOWELS = "aeiou"

# words ending -ss/-us/-is keep their s (glass, virus, basis)
_EN_KEEP_S = ("ss", "us", "is", "news")


def _en_candidates(word: str) -> list[str]:
    """Every plausible lemma for an inflected English surface form,
    most-likely first; [word] when no rule applies."""
    w = word
    out: list[str] = []
    if not w.isascii() or len(w) < 3 or not w.isalpha():
        return [w]
    if w in _EN_IRREGULAR:
        return [_EN_IRREGULAR[w]]
    if w in _EN_VES_F:
        return [_EN_VES_F[w]]

    def add(c):
        if c and len(c) >= 2 and c not in out:
            out.append(c)

    # --- plural / 3rd person -s family
    if w.endswith("ies") and len(w) > 4:
        add(w[:-3] + "y")            # cities -> city
        add(w[:-1])                  # ties -> tie
    elif w.endswith(("ches", "shes", "sses", "xes", "zes", "oes")) \
            and len(w) > 4:
        add(w[:-2])                  # boxes -> box, heroes -> hero
        add(w[:-1])                  # (horse-like: uses -> use)
    elif w.endswith("es") and len(w) > 3:
        add(w[:-1])                  # makes -> make
        add(w[:-2])                  # axes -> ax
    elif w.endswith("s") and not w.endswith(_EN_KEEP_S) and len(w) > 3:
        add(w[:-1])                  # dogs -> dog
    # --- past tense -ed
    if w.endswith("ied") and len(w) > 4:
        add(w[:-3] + "y")            # tried -> try
    elif w.endswith("ed") and len(w) > 3:
        stem = w[:-2]
        if len(stem) > 2 and stem[-1] == stem[-2] \
                and stem[-1] not in _EN_VOWELS + "ls":
            add(stem[:-1])           # stopped -> stop
        elif _cvc(stem):
            add(stem + "e")          # liked -> like
            add(stem)
        else:
            add(stem)                # walked -> walk
            add(stem + "e")
    # --- progressive -ing
    if w.endswith("ing") and len(w) > 4:
        stem = w[:-3]
        if len(stem) > 2 and stem[-1] == stem[-2] \
                and stem[-1] not in _EN_VOWELS + "ls":
            add(stem[:-1])           # running -> run
        elif _cvc(stem):
            add(stem + "e")          # making -> make
            if _has_vowel(stem):
                add(stem)
        else:
            if _has_vowel(stem):
                add(stem)            # walking -> walk
            add(stem + "e")
    # --- comparatives / superlatives
    if w.endswith("iest") and len(w) > 5:
        add(w[:-4] + "y")            # happiest -> happy
    elif w.endswith("est") and len(w) > 4:
        if _cvc(w[:-3]):
            add(w[:-2])              # nicest -> nice
            add(w[:-3])
        else:
            add(w[:-3])              # fastest -> fast
            add(w[:-2])
    if w.endswith("ier") and len(w) > 4:
        add(w[:-3] + "y")            # happier -> happy
    elif w.endswith("er") and len(w) > 4:
        if _cvc(w[:-2]):
            add(w[:-1])              # nicer -> nice
            add(w[:-2])
        else:
            add(w[:-2])              # faster -> fast
            add(w[:-1])
    if not out:
        return [w]
    return out


def lemmatize_en(word: str) -> str:
    return _en_candidates(word)[0]


def lemmatize_en_all(word: str) -> list[str]:
    c = _en_candidates(word)
    return c if word in c or word in _EN_IRREGULAR \
        or word in _EN_VES_F else c + [word]


lemmatize_en_all.emits_all = True     # Dictionary: index every candidate
