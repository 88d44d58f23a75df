"""Index inspection / integrity checking CLI — the `indextool` analog
(Manticore src/indextool.cpp: --check, --dumpheader, --dumpdict).

Usage:
    python -m manticoresearch_tpu_torch.tools.indextool --check PATH
    python -m manticoresearch_tpu_torch.tools.indextool --dumpheader PATH
    python -m manticoresearch_tpu_torch.tools.indextool --dumpdict PATH [--limit N]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def check_index(path: str) -> list[str]:
    """Structural validation (DebugCheckHelper_c analog,
    indexcheck.cpp:1418). Returns a list of error strings."""
    from ..index.storage import load_packed

    errors: list[str] = []
    p = load_packed(path)

    def chk(cond, msg):
        if not cond:
            errors.append(msg)

    n, P, H, T = p.n_docs, p.n_postings, len(p.hit_packed), p.n_terms
    chk(len(p.doc_ids) == n, "doc_ids length != n_docs")
    # rows may be in segment-concatenation order (a flushed disk chunk,
    # SaveDiskChunk sphinxrt.cpp:3014); the sorted docid->rowid lookup is
    # a separate table (.spt analog) — every row must resolve through it
    chk(all(p.doc_ids[p.rowid_of_docid(int(d))] == d
            for d in p.doc_ids[:min(n, 1000)]),
        "docid lookup inconsistent with rows")
    chk(len(p.term_offsets) == T + 1, "term_offsets length != n_terms+1")
    chk(int(p.term_offsets[0]) == 0 and int(p.term_offsets[-1]) == P,
        "term_offsets bounds broken")
    chk(bool(np.all(np.diff(p.term_offsets) >= 0)),
        "term_offsets not monotonic")
    chk(p.term_strs == sorted(p.term_strs), "dictionary not sorted")
    chk(bool(np.all(np.diff(p.post_hit_offset) >= 0)),
        "post_hit_offset not monotonic")
    chk(int(p.post_hit_offset[-1]) == H, "hit offsets do not cover hitlist")
    if P:
        chk(bool(np.all((p.post_rowid >= 0) & (p.post_rowid < max(n, 1)))),
            "posting rowid out of range")
        chk(bool(np.all(p.post_tf >= 1)), "posting tf < 1")
        # per-term rowids ascending
        for t in range(T):
            a, b = int(p.term_offsets[t]), int(p.term_offsets[t + 1])
            if b - a > 1 and not np.all(np.diff(p.post_rowid[a:b]) > 0):
                errors.append(f"term {p.term_strs[t]!r}: rowids not ascending")
                break
        chk(bool(np.all(np.diff(p.post_hit_offset) == p.post_tf)),
            "tf != hitlist segment size")
        tfq = p.post_tf / (p.post_tf + np.float32(1.2))
        chk(bool(np.allclose(p.post_tfq, tfq.astype(np.float32))),
            "eager tf/(tf+K1) mismatch")
    df = np.diff(p.term_offsets)
    chk(bool(np.all(df == p.term_docs)), "df != posting counts")

    # ---- hitlist checks (CheckHitlists, indexcheck.cpp) -------------------
    if H:
        pos_mask = (1 << 23) - 1
        fields = (p.hit_packed >> 24) & 0xFF
        poss = p.hit_packed & pos_mask
        F = max(p.schema.n_fields, 1)
        chk(bool(np.all(fields < F)), "hit field id out of schema range")
        chk(bool(np.all(poss >= 1)), "hit position < 1 (positions 1-based)")
        # per-posting hits ascending in packed (field, pos) order
        key = p.hit_packed & ~(1 << 23)
        seg_start = p.post_hit_offset[:-1]
        inc = np.ones(H, bool)
        inc[1:] = key[1:] > key[:-1]
        inc[seg_start] = True
        chk(bool(np.all(inc)), "hits not ascending within a posting")
        th = np.zeros(T, np.int64)
        np.add.at(th, np.repeat(np.arange(T), df), p.post_tf)
        chk(bool(np.all(th == p.term_hits)), "term_hits != summed tf")

    # ---- attribute / docstore checks (CheckRowitems, CheckDocstore) -------
    for name, arr in {**p.attrs_int, **p.attrs_big,
                      **p.attrs_float}.items():
        chk(len(arr) == n, f"attr {name!r} length != n_docs")
    for name, vals in p.attrs_str.items():
        chk(len(vals) == n, f"string attr {name!r} length != n_docs")
    for name, (off, vals) in p.attrs_mva.items():
        chk(len(off) == n + 1, f"mva {name!r} CSR length != n_docs+1")
        chk(bool(np.all(np.diff(off) >= 0)),
            f"mva {name!r} offsets not monotonic")
        chk(int(off[-1]) == len(vals), f"mva {name!r} CSR does not cover "
            "values")
        for r in range(min(n, 64)):     # spot-check sortedness
            seg = vals[off[r]:off[r + 1]]
            if len(seg) > 1 and not np.all(np.diff(seg) >= 0):
                errors.append(f"mva {name!r} row {r} values not sorted")
                break
    for fname, col in p.stored_fields.items():
        chk(len(col) == n, f"stored field {fname!r} length != n_docs")
    chk(p.field_lens.shape[0] == n or not p.field_lens.size,
        "field_lens rows != n_docs")

    # ---- packed posting store spot-check (decode == raw) ------------------
    if P:
        from ..ops.packed_store import BLOCK, CLASSES
        st = p.packed_store()
        packed_tids = np.flatnonzero(st.term_class[:, 0] > 0)[:8]
        for t in packed_tids:
            c = CLASSES[st.term_class[t, 0] - 1]
            nb = (int(p.term_docs[t]) + BLOCK - 1) // BLOCK
            s0 = int(st.term_start[t, 0])
            words = st.rw_words[c][s0:s0 + nb]
            base = st.rw_base[c][s0:s0 + nb]
            dec = _decode_host(words, base, c)[: int(p.term_docs[t])]
            a, b = int(p.term_offsets[t]), int(p.term_offsets[t + 1])
            if not np.array_equal(dec, p.post_rowid[a:b]):
                errors.append(
                    f"packed store decode mismatch for term "
                    f"{p.term_strs[t]!r}")
                break
    return [e for e in errors if e]


def _decode_host(words: np.ndarray, base: np.ndarray, c: int) -> np.ndarray:
    """Host-side bit-plane decode (verification twin of the device path)."""
    from ..ops.packed_store import BLOCK, PLANE_WORDS
    nb = len(base)
    lane = np.arange(BLOCK)
    word_sel = lane // 32
    sh = (lane % 32).astype(np.uint32)
    deltas = np.zeros((nb, BLOCK), np.int64)
    for j in range(c):
        plane = words[:, PLANE_WORDS * j: PLANE_WORDS * (j + 1)]
        w = np.take_along_axis(
            plane, np.broadcast_to(word_sel[None, :], (nb, BLOCK)), axis=1)
        deltas += (((w >> sh[None, :]) & 1) << j).astype(np.int64)
    deltas[:, 0] = 0
    return (base[:, None] + np.cumsum(deltas, axis=1)).reshape(-1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="index inspection tool")
    ap.add_argument("--check", metavar="PATH")
    ap.add_argument("--dumpheader", metavar="PATH")
    ap.add_argument("--dumpdict", metavar="PATH")
    ap.add_argument("--dumpdocids", metavar="PATH")
    ap.add_argument("--dumphitlist", metavar="PATH")
    ap.add_argument("--word", help="term for --dumphitlist")
    ap.add_argument("--stats", metavar="PATH",
                    help="index size/statistics summary")
    ap.add_argument("--buildidf", nargs="+", metavar="PATH",
                    help="merge per-index dictionaries into a global IDF "
                         "file (indextool --buildidf idx1 idx2 --out f.idf)")
    ap.add_argument("--out", help="output file for --buildidf")
    ap.add_argument("--limit", type=int, default=100)
    args = ap.parse_args(argv)

    from ..index.storage import load_packed

    if args.buildidf:
        if not args.out:
            ap.error("--buildidf needs --out")
        build_global_idf(args.buildidf, args.out)
        print(f"wrote global idf for {len(args.buildidf)} indexes "
              f"-> {args.out}")
        return 0

    if args.dumpdocids:
        p = load_packed(args.dumpdocids)
        for d in p.doc_ids[: args.limit].tolist():
            print(d)
        return 0
    if args.dumphitlist:
        if not args.word:
            ap.error("--dumphitlist needs --word")
        p = load_packed(args.dumphitlist)
        t = p.term_id(args.word)
        if t < 0:
            print(f"term {args.word!r} not in dictionary", file=sys.stderr)
            return 1
        a, b = int(p.term_offsets[t]), int(p.term_offsets[t + 1])
        print("docid\tfield\tpos\tend")
        for i in range(a, min(b, a + args.limit)):
            did = int(p.doc_ids[p.post_rowid[i]])
            h0, h1 = int(p.post_hit_offset[i]), int(p.post_hit_offset[i + 1])
            for h in range(h0, h1):
                pk = int(p.hit_packed[h])
                print(f"{did}\t{(pk >> 24) & 0xFF}\t{pk & ((1 << 23) - 1)}"
                      f"\t{(pk >> 23) & 1}")
        return 0
    if args.stats:
        p = load_packed(args.stats)
        st = p.packed_store()
        raw = (p.post_rowid.nbytes + p.post_tfq.nbytes
               + p.post_fieldmask.nbytes)
        print(f"docs:         {p.n_docs}")
        print(f"terms:        {p.n_terms}")
        print(f"postings:     {p.n_postings}")
        print(f"hits:         {p.total_hits}")
        print(f"posting raw:  {raw} bytes")
        print(f"posting packed: {st.nbytes()} bytes "
              f"({raw / max(st.nbytes(), 1):.1f}x)")
        print(f"hit arrays:   {p.hit_packed.nbytes * 2} bytes")
        return 0
    if args.check:
        errors = check_index(args.check)
        if errors:
            for e in errors:
                print(f"FAILED: {e}")
            return 1
        print("check passed")
        return 0
    if args.dumpheader:
        import json as _json
        with open(f"{args.dumpheader}/header.json") as f:
            print(_json.dumps(_json.load(f), indent=2))
        return 0
    if args.dumpdict:
        p = load_packed(args.dumpdict)
        print("term\tdocs\thits")
        for i, t in enumerate(p.term_strs[: args.limit]):
            print(f"{t}\t{int(p.term_docs[i])}\t{int(p.term_hits[i])}")
        return 0
    ap.error("one of --check/--dumpheader/--dumpdict required")
    return 2


if __name__ == "__main__":
    sys.exit(main())


def build_global_idf(paths: list[str], out: str) -> None:
    """Merge dictionaries of several indexes into one global-IDF table
    (sphinxglobalidf / indextool --buildidf analog): term -> summed df,
    plus the summed document count."""
    from ..index.storage import load_packed
    df: dict[str, int] = {}
    total = 0
    for p in paths:
        idx = load_packed(p)
        total += idx.n_docs
        for t, d in zip(idx.term_strs, idx.term_docs.tolist()):
            df[t] = df.get(t, 0) + int(d)
    terms = sorted(df)
    with open(out, "wb") as f:
        np.savez_compressed(
            f,
            terms=np.asarray(terms, dtype=object),
            df=np.asarray([df[t] for t in terms], np.int64),
            total_docs=np.asarray([total], np.int64))


def load_global_idf(path: str):
    """-> (df dict, total_docs)."""
    z = np.load(path, allow_pickle=True)
    terms = z["terms"].tolist()
    dfs = z["df"].tolist()
    return dict(zip(terms, dfs)), int(z["total_docs"][0])
