"""The LCS and positional walk kernels (csrc/lcs_walk.cu, csrc/pos_walk.cu)
at the benchmark cells' shapes, on an NVIDIA card.

The ``text1m_plain.lucene_tasks`` cell's corpus (perfbench, from the given
seed), made once, indexed whole (1M documents) and as its first 125k
documents (one shard of ``text1m_shard8``), each index built once. On
each, one query of each walk's categories from the cell's query stream
runs on the card: ``chip_smoke.capture`` records the kernel's call and,
with the kernel refused, its plain path (the eager hit stream, the eager
nodes), and ``chip_smoke.time_kernel`` checks the kernel bit-exact against
it and times both. The last line is JSON: ``{"lcs_walk": {"<1M|shard
125k> <category>": timings}, "pos_walk": {...}}``.

    python3 chip_walks.py [seed]
"""
import json
import sys
import time

import torch

import chip_smoke as cs
from manticoresearch_tpu_torch.exec.searcher import SearchIndex
from manticoresearch_tpu_torch.index.builder import build_from_pretokenized
from perfbench import spec
from perfbench.corpus import Corpus, build_inputs, make_corpus
from perfbench.generators import querylog
from perfbench.systems import schema_of, to_port

CELL = "text1m_plain.lucene_tasks"
# each walk: its categories, ``capture``'s arguments, its timer entry
WALKS = {
    "lcs_walk": (("AndHighHigh", "HighPhrase", "HighSloppyPhrase",
                  "AndHighMed", "OrHighHigh"), cs.LCS_HOOKS, cs.walk_entry),
    "pos_walk": (("HighPhrase", "MedPhrase", "LowPhrase", "HighSloppyPhrase",
                  "MedSloppyPhrase", "LowSloppyPhrase"), cs.POS_HOOKS,
                 cs.pos_entry)}
SHARD_DOCS = 125_000   # text1m_shard8: 1M documents over 8 shards


def main(seed: int) -> dict:
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    cell = spec.cell(spec.load(), CELL)
    cfg = cell.config
    t0 = time.perf_counter()
    corpus = make_corpus(cfg, seed, "cuda")
    qs = querylog.generate(cell.traffic, corpus, seed, 0, 600)
    corpus = Corpus(corpus.tokens.cpu(), corpus.offsets.cpu(),
                    corpus.vocabulary, corpus.attrs, corpus.fields)
    wanted = {c for cats, _, _ in WALKS.values() for c in cats}
    pick = {}
    for q in qs:
        if (q.category in wanted and q.category not in pick
                and q.filter is None):
            pick[q.category] = to_port(q, 10)
    print(f"corpus and queries {time.perf_counter() - t0:.1f} s: "
          f"{ {c: q.match for c, q in pick.items()} }", flush=True)
    out: dict = {walk: {} for walk in WALKS}
    for tag, hi in (("1M", corpus.n_docs), ("shard 125k", SHARD_DOCS)):
        t0 = time.perf_counter()
        packed = build_from_pretokenized(schema_of(cfg),
                                         **build_inputs(corpus, 0, hi))
        idx = SearchIndex(packed, device="cuda")
        print(f"{tag}: built and uploaded in {time.perf_counter() - t0:.1f} "
              "s", flush=True)
        for walk, (cats, hooks, entry) in WALKS.items():
            for cat in cats:
                q = pick[cat]
                res, call = cs.capture(idx, q, *hooks)
                if call is None:
                    raise AssertionError(f"{tag} {cat} {q.match!r}: no "
                                         f"{walk} call")
                sig = idx.plan(q).sig
                r = cs.time_kernel(iters=20, **entry(
                    f"{tag} {cat} {q.match!r} "
                    f"({'sparse' if sig.sparse else 'dense'})", call))
                r["found"] = res.total_found
                out[walk][f"{tag} {cat}"] = r
        del idx, packed
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    print(json.dumps(main(int(sys.argv[1]) if len(sys.argv) > 1
                          else 2147501901)))
