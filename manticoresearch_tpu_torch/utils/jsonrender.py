"""Canonical JSON attribute rendering — the reference parses JSON into
BSON at index time and re-serializes on output (sphinxjson.cpp
sphJsonFieldFormat): floats print %f (6 decimals), ints bare, compact
separators, key order preserved.
"""
from __future__ import annotations

import json


def _dump(o) -> str:
    if o is None:
        return "null"
    if isinstance(o, bool):
        return "true" if o else "false"
    if isinstance(o, float):
        return f"{o:.6f}"
    if isinstance(o, int):
        return str(o)
    if isinstance(o, str):
        return json.dumps(o, ensure_ascii=False)
    if isinstance(o, list):
        return "[" + ",".join(_dump(v) for v in o) + "]"
    if isinstance(o, dict):
        return "{" + ",".join(f"{json.dumps(str(k), ensure_ascii=False)}"
                              f":{_dump(v)}" for k, v in o.items()) + "}"
    return json.dumps(o, ensure_ascii=False)


def render_json(text) -> str:
    """Normalize a JSON attribute's source text to the engine's output
    form; malformed input passes through unchanged."""
    if not isinstance(text, str) or not text.strip():
        return "" if text is None else str(text or "")
    try:
        obj = json.loads(text)
    except (ValueError, TypeError):
        # the reference's JSON parser accepts unquoted keys
        # (sphinxjson relaxed mode); quote them and retry
        import re
        relaxed = re.sub(r"([{,]\s*)([A-Za-z_]\w*)(\s*):", r'\1"\2"\3:',
                         text)
        try:
            obj = json.loads(relaxed)
        except (ValueError, TypeError):
            return text
    return _dump(obj)
