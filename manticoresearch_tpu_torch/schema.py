"""Schema: full-text fields + typed attributes.

Behavioral model: CSphSchema / CSphColumnInfo (Manticore src/sphinx.h:1486,
935). Fields are full-text indexed (up to 32 on the device fast path — the
reference's low-32 mask is its own fast path, sphinxsearch.cpp:4350ish);
attributes are typed columns stored SoA for the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class AttrType(Enum):
    UINT = "uint"
    BIGINT = "bigint"
    FLOAT = "float"
    BOOL = "bool"
    TIMESTAMP = "timestamp"
    STRING = "string"
    JSON = "json"
    MVA = "multi"        # set of uint32
    MVA64 = "multi64"    # set of int64

    @property
    def is_numeric_device(self) -> bool:
        return self in (
            AttrType.UINT, AttrType.BIGINT, AttrType.FLOAT,
            AttrType.BOOL, AttrType.TIMESTAMP,
        )

    @property
    def device_dtype(self):
        if self is AttrType.FLOAT:
            return np.float32
        if self is AttrType.BIGINT:
            return np.int64  # stored as int64 host-side; device uses f64->f32/i32 split
        return np.int32


@dataclass(frozen=True)
class AttrDef:
    name: str
    type: AttrType


@dataclass
class Schema:
    fields: list[str]
    attrs: list[AttrDef] = field(default_factory=list)

    def __post_init__(self):
        if len(self.fields) > 256:
            # the reference caps at SPH_MAX_FIELDS=256 (sphinx.h:108);
            # >32 fields switch the engine to multi-word fieldmask planes
            raise ValueError("too many full-text fields (max 256)")
        names = [f for f in self.fields] + [a.name for a in self.attrs]
        if len(set(names)) != len(names):
            # one exception: a full-text field may share its name with a
            # STRING attribute — the reference's sql_field_string /
            # rt_field+rt_attr_string "indexed and stored" columns
            # (sphinx.h:1788+). SELECT resolves the attr; MATCH @name the
            # field.
            for n in {x for x in names if names.count(x) > 1}:
                ok = (names.count(n) == 2 and n in self.fields
                      and any(a.name == n and a.type is AttrType.STRING
                              for a in self.attrs))
                if not ok:
                    raise ValueError("duplicate column names in schema")

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    def field_id(self, name: str) -> int:
        return self.fields.index(name)

    def attr(self, name: str) -> AttrDef | None:
        for a in self.attrs:
            if a.name == name:
                return a
        # schema names are case-insensitive (the reference folds them
        # with sphToLower at parse time, sphinxstd ToLower)
        low = name.lower()
        for a in self.attrs:
            if a.name.lower() == low:
                return a
        return None

    def field_mask(self, names: list[str] | None) -> int:
        """Bitmask of the given fields (None = all)."""
        if names is None:
            return (1 << len(self.fields)) - 1
        mask = 0
        for n in names:
            mask |= 1 << self.field_id(n)
        return mask

    def to_json(self) -> dict:
        return {
            "fields": list(self.fields),
            "attrs": [{"name": a.name, "type": a.type.value} for a in self.attrs],
        }

    @staticmethod
    def from_json(d: dict) -> "Schema":
        return Schema(
            fields=list(d["fields"]),
            attrs=[AttrDef(a["name"], AttrType(a["type"])) for a in d["attrs"]],
        )
