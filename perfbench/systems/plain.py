"""A plain table: one ``SearchIndex`` over the whole corpus on one device,
built by the port's ``build_from_pretokenized`` in this process."""
from __future__ import annotations

from . import Table, schema_of
from ..corpus import build_inputs


def build(cfg: dict, corpus, device) -> Table:
    from manticoresearch_tpu_torch.exec import searcher
    from manticoresearch_tpu_torch.exec.searcher import SearchIndex
    from manticoresearch_tpu_torch.index.builder import build_from_pretokenized
    from manticoresearch_tpu_torch.ops import packed_store
    packed = build_from_pretokenized(schema_of(cfg),
                                     **build_inputs(corpus, 0, corpus.n_docs))
    return Table(SearchIndex(packed, device=device), [device], [
        (SearchIndex, "plan", "plan"),
        (SearchIndex, "_run_round", "round"),
        (searcher, "decode_lists", "decode"),
        (searcher, "build_kernel", "search_program()"),
        (SearchIndex, "_finish", "finish")])
