"""The benchmark's corpus: documents of term ids drawn from ``--seed``.

A copy of ``manticoresearch_tpu_torch.bench_corpus.build_corpus``'s
recipe, with one repair: the Zipf draw is truncated to the vocabulary
(drawn by the inverse of the truncated distribution, which is what
redrawing every value past the vocabulary gives), where the original
clamps such draws onto the last term and so makes it the corpus's third
most frequent. The tokens are made in a few large calls with a
``torch.Generator`` on the run's device, then handed to the table's
builder and, after the window, to the reference, as the same arrays.

``adjacent_pairs`` stands in for ``bench_corpus.positional_pairs``: it
draws pairs of distinct terms that stand next to each other in some
document, read from the benchmark's own tokens (the original reads the
port's packed arrays).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Corpus:
    """Documents as one token array: document i holds
    ``tokens[offsets[i]:offsets[i + 1]]`` at positions 1, 2, ...; term id
    t is the word ``term_text(t)``, and term id + 1 is its Zipf rank."""
    tokens: torch.Tensor      # int32 [T], on the device it was made on
    offsets: torch.Tensor     # int64 [n + 1]
    vocabulary: int
    attrs: dict               # name -> int64 [n] numpy, per row
    fields: list

    @property
    def n_docs(self) -> int:
        return self.offsets.shape[0] - 1

    def term_width(self) -> int:
        return max(4, len(str(self.vocabulary - 1)))

    def term_text(self, t: int) -> str:
        return f"t{t:0{self.term_width()}d}"

    def doc_ids(self) -> np.ndarray:
        return np.arange(1, self.n_docs + 1, dtype=np.int64)


def make_corpus(cfg: dict, seed: int, device) -> Corpus:
    """The configuration's corpus from ``seed``: document lengths uniform
    over ``doc_len`` (both ends included), terms Zipf(``zipf_s``)
    truncated to ``vocabulary``, attributes ``base + row % mod``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = int(cfg["documents"])
    lo, hi = cfg["doc_len"]
    lens = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offsets[1:])
    vocab = int(cfg["vocabulary"])
    rank = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(rank ** -float(cfg["zipf_s"]), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(int(offsets[-1]), generator=gen, dtype=torch.float64,
                   device=device)
    tokens = torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)
    del u
    rows = np.arange(n, dtype=np.int64)
    attrs = {name: a["base"] + rows % a["mod"]
             for name, a in cfg["attrs"].items()}
    return Corpus(tokens.to(torch.int32), offsets, vocab, attrs,
                  list(cfg["fields"]))


def adjacent_pairs(corpus: Corpus, gen: torch.Generator, n: int,
                   lo_rank: int, hi_rank: int) -> list[tuple[int, int]]:
    """``n`` term pairs (a, b), a != b, both of Zipf rank ``lo_rank`` to
    ``hi_rank``, with b right after a in some document: drawn as uniform
    token positions, kept where the pair qualifies, so a pair comes up as
    often as it occurs. The phrase ``"a b"`` matches at least that
    document."""
    tok = corpus.tokens
    dev = tok.device
    starts = corpus.offsets[1:-1]
    out: list[tuple[int, int]] = []
    draw = max(4 * n, 1 << 16)
    for _ in range(10_000):
        if len(out) >= n:
            break
        i = torch.randint(0, tok.shape[0] - 1, (draw,), generator=gen,
                          device=dev)
        a, b = tok[i].to(torch.int64), tok[i + 1].to(torch.int64)
        ok = ((a != b) & (a >= lo_rank - 1) & (a <= hi_rank - 1)
              & (b >= lo_rank - 1) & (b <= hi_rank - 1)
              & ~torch.isin(i + 1, starts))
        out += list(zip(a[ok].tolist(), b[ok].tolist()))
    if len(out) < n:
        raise RuntimeError(f"only {len(out)} adjacent pairs of ranks "
                           f"{lo_rank}-{hi_rank} found, {n} wanted")
    return out[:n]


def build_inputs(corpus: Corpus, lo: int, hi: int) -> dict:
    """Documents ``lo:hi`` as the port's ``build_from_pretokenized`` takes
    them (host numpy)."""
    offs = corpus.offsets[lo:hi + 1].cpu().numpy()
    return dict(
        doc_ids=corpus.doc_ids()[lo:hi],
        doc_terms=corpus.tokens[offs[0]:offs[-1]].cpu().numpy(),
        doc_offsets=offs - offs[0],
        attrs={k: v[lo:hi] for k, v in corpus.attrs.items()},
        vocab=[corpus.term_text(t) for t in range(corpus.vocabulary)],
    )
