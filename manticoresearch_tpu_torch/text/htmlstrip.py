"""HTML stripper (html_strip / html_remove_elements / html_index_attrs).

Behavioral model: CSphHTMLStripper (Manticore src/sphinx.h:1672 and
its implementation in sphinx.cpp): remove tags/comments/PIs/DOCTYPE, decode
character entities, drop the *contents* of elements listed in
html_remove_elements (e.g. style, script), and inject the values of
attributes listed in html_index_attrs ("img=alt,title; a=title") as
indexable text. Tags are replaced by whitespace so token boundaries and
positions behave as if the markup were separators.
"""
from __future__ import annotations

import html
import re

_COMMENT = re.compile(r"<!--.*?-->", re.S)
_CDATA = re.compile(r"<!\[CDATA\[(.*?)\]\]>", re.S)
_DECL = re.compile(r"<![^>]*>")
_PI = re.compile(r"<\?.*?\?>", re.S)
_TAG = re.compile(r"<(/?)([a-zA-Z][a-zA-Z0-9:_-]*)((?:[^>\"']|\"[^\"]*\"|"
                  r"'[^']*')*)>")
_ATTR = re.compile(r"([a-zA-Z][a-zA-Z0-9:_-]*)\s*=\s*(\"[^\"]*\"|'[^']*'|"
                   r"[^\s>]+)")


def parse_index_attrs(spec: str) -> dict[str, tuple[str, ...]]:
    """Parse 'img=alt,title; a=title' into {tag: (attrs...)}."""
    out: dict[str, tuple[str, ...]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        tag, _, attrs = part.partition("=")
        out[tag.strip().lower()] = tuple(
            a.strip().lower() for a in attrs.split(",") if a.strip())
    return out


# block-level elements that emit a paragraph boundary when index_sp=1
# (CSphHTMLStripper::EnableParagraphs, sphinx.cpp:20385-20392); open AND
# close tags both emit MAGIC_CODE_PARAGRAPH
BLOCK_TAGS = frozenset((
    "address", "blockquote", "caption", "center", "dd", "div", "dl", "dt",
    "h1", "h2", "h3", "h4", "h5", "li", "menu", "ol", "p", "pre", "table",
    "tbody", "td", "tfoot", "th", "thead", "tr", "ul"))


def strip_html_events(text: str, remove_elements: tuple[str, ...] = (),
                      index_attrs: dict[str, tuple[str, ...]] | None = None,
                      zones: tuple[str, ...] = (), paragraphs: bool = False):
    """Strip markup, returning (stripped_text, events). Events are the
    stripper's boundary emissions in document order — the analog of the
    MAGIC_CODE_ZONE / MAGIC_CODE_PARAGRAPH bytes CSphHTMLStripper injects
    into the stripped stream (sphinx.cpp:21250-21272):

      ("zopen",  name, off)  zone-open tag   (<zoneA>)
      ("zclose", name, off)  zone-close tag  (</zoneA>)
      ("para",   "",   off)  block-level tag boundary (paragraphs=True,
                             both open and close tags)

    with `off` an offset into the RETURNED text. Each event consumes one
    token position at indexing time (BuildZoneHits, sphinx.cpp:22233) —
    the caller does that accounting. Entity decoding is skipped (offsets
    must map 1:1); zone/sp-indexed fields should not rely on entities."""
    index_attrs = index_attrs or {}
    removed = {e.strip().lower() for e in remove_elements if e.strip()}
    zone_set = {z.strip().lower() for z in zones if z.strip()}
    # index_zones supports trailing-star patterns ("z_*", h*):
    # sphinx.cpp zone-name wildcards
    zone_pats = tuple(z[:-1] for z in zone_set if z.endswith("*"))
    zone_set = {z for z in zone_set if not z.endswith("*")}

    def _is_zone(nm: str) -> bool:
        return nm in zone_set or any(nm.startswith(p) for p in zone_pats)

    text = _COMMENT.sub(" ", text)
    text = _CDATA.sub(r" \1 ", text)
    text = _PI.sub(" ", text)
    text = _DECL.sub(" ", text)

    out: list[str] = []
    out_len = 0
    events: list[tuple[str, str, int]] = []

    def emit(s: str):
        nonlocal out_len
        out.append(s)
        out_len += len(s)

    i = 0
    skip_until: str | None = None   # inside a removed element's content
    for m in _TAG.finditer(text):
        if skip_until is None:
            emit(text[i:m.start()])
        closing, name, attrs_raw = m.group(1), m.group(2).lower(), m.group(3)
        i = m.end()
        if skip_until is not None:
            if closing and name == skip_until:
                skip_until = None
            continue
        if _is_zone(name):
            events.append(("zclose" if closing else "zopen", name, out_len))
            emit(" ")
            continue
        if paragraphs and name in BLOCK_TAGS:
            events.append(("para", "", out_len))
            emit(" ")
            continue
        if not closing and name in removed:
            # self-closing removed element has no content to skip
            if not attrs_raw.rstrip().endswith("/"):
                skip_until = name
            emit(" ")
            continue
        if not closing and name in index_attrs:
            wanted = index_attrs[name]
            for am in _ATTR.finditer(attrs_raw):
                if am.group(1).lower() in wanted:
                    v = am.group(2)
                    if v[:1] in "\"'":
                        v = v[1:-1]
                    emit(" " + v + " ")
        emit(" ")
    if skip_until is None:
        emit(text[i:])
    result = "".join(out)
    # space/paragraph sequence elimination (sphinx.cpp:21314-21374):
    # consecutive paragraph markers collapse to one; a paragraph marker
    # with only whitespace between it and a zone marker (either side) is
    # dropped — the zone boundary subsumes it. Zone markers never collapse.
    kept: list[tuple[str, str, int]] = []
    para_out = False
    zone_out = False
    ptr = 0
    for kind, name, off in events:
        if any(c not in " \t\n\r" for c in result[ptr:off]):
            para_out = zone_out = False
        ptr = off
        if kind == "para":
            if not para_out and not zone_out:
                kept.append((kind, name, off))
                para_out = True
        else:
            if para_out:
                # rewind the immediately preceding paragraph marker
                kept.pop()
            kept.append((kind, name, off))
            zone_out = True
            para_out = False
    return result, kept


def strip_html(text: str, remove_elements: tuple[str, ...] = (),
               index_attrs: dict[str, tuple[str, ...]] | None = None,
               zones: tuple[str, ...] = (), with_zones: bool = False):
    """Strip markup. With `zones` + `with_zones=True`, also returns zone
    events [(name, open_char_off, close_char_off), ...] with offsets into
    the RETURNED text (CSphHTMLStripper's MAGIC_CODE_ZONE emission
    repackaged as matched spans; entities inside zones are left encoded so
    offsets stay valid — zone content is re-unescaped by the caller's
    tokenizer charset fold, which ignores '&').

    Note: when zones are requested, entity decoding is skipped (offsets
    must map 1:1); zone-indexed fields should not rely on entities."""
    if "<" not in text and "&" not in text:
        return (text, []) if with_zones else text
    result, raw = strip_html_events(text, remove_elements, index_attrs,
                                    zones)
    if not with_zones:
        return html.unescape(result)
    # pair zopen/zclose into spans (innermost-first per name)
    open_zones: list[tuple[str, int]] = []
    events: list[tuple[str, int, int]] = []
    for kind, name, off in raw:
        if kind == "zopen":
            open_zones.append((name, off))
        elif kind == "zclose":
            for j in range(len(open_zones) - 1, -1, -1):
                if open_zones[j][0] == name:
                    events.append((name, open_zones[j][1], off))
                    del open_zones[j]
                    break
    for name, off in open_zones:        # unclosed zones run to the end
        events.append((name, off, len(result)))
    return result, events
