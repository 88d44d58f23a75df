"""A distributed table: the corpus cut into ``shards`` contiguous runs of
documents, each built by the port's ``build_from_pretokenized`` in a
process of its own (``build_worker``, all at once), searched as one
``ShardedIndex`` over ``cards`` cards (``make_mesh``; on the CPU, as many
parts on "cpu"), each card holding ``shards / cards`` of them."""
from __future__ import annotations

import pickle
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import Table, schema_of
from ..corpus import build_inputs

ROOT = Path(__file__).resolve().parents[2]


def _build_in_process(payload: bytes):
    proc = subprocess.Popen(
        [sys.executable, "-m", "perfbench.systems.build_worker"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
    out, _ = proc.communicate(payload)
    if proc.returncode != 0:
        raise RuntimeError(f"shard build failed: exit {proc.returncode}")
    return pickle.loads(out)


def build(cfg: dict, corpus, device) -> Table:
    import torch
    from manticoresearch_tpu_torch.parallel import sharded
    from manticoresearch_tpu_torch.parallel.sharded import (ShardedIndex,
                                                            make_mesh)
    n, k = corpus.n_docs, int(cfg["shards"])
    cards = int(cfg["cards"])
    bounds = [n * i // k for i in range(k + 1)]
    schema = schema_of(cfg)
    payloads = [pickle.dumps((schema, build_inputs(corpus, lo, hi)),
                             protocol=pickle.HIGHEST_PROTOCOL)
                for lo, hi in zip(bounds[:-1], bounds[1:])]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(k) as pool:
        shards = list(pool.map(_build_in_process, payloads))
    t1 = time.perf_counter()
    devices = (make_mesh(cards) if torch.device(device).type == "cuda"
               else [torch.device(device)] * cards)
    index = ShardedIndex(shards, devices=devices)
    print(f"{k} shards built in {t1 - t0:.1f} s, ShardedIndex on {cards} "
          f"cards in {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return Table(index, devices, [
        (ShardedIndex, "plan", "plan"),
        (ShardedIndex, "_prep", "prep"),
        (sharded, "decode_lists", "decode"),
        (sharded, "build_kernel", "search_program()"),
        (ShardedIndex, "_prelude", "prelude"),
        (ShardedIndex, "_merge", "merge"),
        (ShardedIndex, "_render_merged", "finish")])
