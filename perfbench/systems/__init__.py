"""The systems under test, one module per kind of table.

A configuration names its kind (``"table"``) and ``run.py`` loads
``systems/<table>.py``, whose ``build(cfg, corpus, device)`` returns a
``Table``: the port's table, built from the benchmark's corpus and
uploaded, with the calls the window makes on it.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Table:
    index: object           # the port's table (its ``search_batch``)
    devices: list           # every device the table lives on
    points: list            # (owner, attribute, span name): see Spans

    def search_batch(self, queries: list) -> list:
        return self.index.search_batch(queries)

    def sync(self) -> None:
        """Wait for every card of the table."""
        from manticoresearch_tpu_torch.parallel.sharded import sync
        sync(self.devices)


def schema_of(cfg: dict):
    from manticoresearch_tpu_torch.schema import AttrDef, AttrType, Schema
    return Schema(fields=list(cfg["fields"]),
                  attrs=[AttrDef(name, AttrType.UINT) for name in cfg["attrs"]])


def to_port(q, limit: int):
    """The generator's query as the port's ``SearchQuery``."""
    from manticoresearch_tpu_torch.exec.searcher import SearchQuery
    from manticoresearch_tpu_torch.query.planner import AttrFilterDef
    filters = []
    if q.filter is not None:
        attr, lo, hi = q.filter
        filters.append(AttrFilterDef(attr, "range_i", lo=lo, hi=hi))
    return SearchQuery(match=q.text, limit=limit, filters=filters)
