"""Posting-level segment merge: K PackedIndex -> one, no re-tokenization.

Behavioral model: the reference's progressive RT merge
(Manticore src/sphinxrt.cpp:2606 MergeSegments and the disk-chunk
merger sphinx.cpp CSphIndex_VLN::Merge): postings of live rows are
concatenated and re-sorted under the merged dictionary; dead (killed /
replaced) rows are dropped — merge doubles as compaction.

TPU-first shape: everything is flat SoA arrays already, so the merge is
vectorized numpy — union the sorted dictionaries, remap term ids and
rowids, one lexsort of (tid, row) over the union, and a gather of hit
slices into the new posting order. Cost is O(P log P) in postings, not
O(corpus) re-tokenization.
"""
from __future__ import annotations

import numpy as np

from .builder import SPH_BM25_K1, PackedIndex, _pack_mva


def merge_packed(segments: list[PackedIndex],
                 live_docids: list[set] | None = None,
                 row_order: str = "docid") -> PackedIndex:
    """Merge segments into one PackedIndex.

    live_docids[i]: the set of docids of segment i that are still alive
    (REPLACE/DELETE kills excluded). None = all rows live.

    row_order: "docid" = global ascending docid order (RT segment merges,
    whose accumulators are docid-sorted); "concat" = segment-concatenation
    order, each segment's live rows in their existing rowid order — the
    disk-chunk save layout (SaveDiskChunk walks m_dRamChunks in order and
    assigns tNextRowID sequentially, sphinxrt.cpp:3014; the docid lookup
    is a SEPARATE sorted table, :3056). Rowid order is observable through
    sorter tie artifacts (golden test_412 post-FLUSH-RAMCHUNK).
    """
    assert segments, "nothing to merge"
    schema = segments[0].schema
    K = len(segments)

    # ---- row space ---------------------------------------------------------
    seg_live_rows: list[np.ndarray] = []      # old rowids kept, ascending
    seg_docids: list[np.ndarray] = []
    for i, p in enumerate(segments):
        if live_docids is None or live_docids[i] is None:
            rows = np.arange(p.n_docs, dtype=np.int64)
        else:
            alive = np.isin(p.doc_ids,
                            np.fromiter(live_docids[i], np.int64,
                                        len(live_docids[i]))
                            if live_docids[i] else np.zeros(0, np.int64))
            rows = np.flatnonzero(alive).astype(np.int64)
        seg_live_rows.append(rows)
        seg_docids.append(p.doc_ids[rows])
    all_docids = np.concatenate(seg_docids) if K else np.zeros(0, np.int64)
    if row_order == "concat":
        doc_order = np.arange(len(all_docids), dtype=np.int64)
    else:
        doc_order = np.argsort(all_docids, kind="stable")
    doc_ids = all_docids[doc_order]
    n_new = len(doc_ids)
    # new rowid for each entry of the concatenated live-doc list
    new_row_of_concat = np.empty(n_new, dtype=np.int64)
    new_row_of_concat[doc_order] = np.arange(n_new)
    # per segment: old_row -> new_row (or -1 dead)
    seg_rowmap: list[np.ndarray] = []
    base = 0
    for i, p in enumerate(segments):
        m = np.full(p.n_docs + 1, -1, dtype=np.int64)
        cnt = len(seg_live_rows[i])
        m[seg_live_rows[i]] = new_row_of_concat[base:base + cnt]
        base += cnt
        seg_rowmap.append(m)

    # ---- dictionary union -------------------------------------------------
    term_strs = sorted(set().union(*[set(p.term_strs) for p in segments])) \
        if K else []
    tarr = np.asarray(term_strs, dtype=object)
    seg_tidmap: list[np.ndarray] = []
    for p in segments:
        if p.n_terms:
            seg_tidmap.append(np.searchsorted(
                tarr, np.asarray(p.term_strs, dtype=object)))
        else:
            seg_tidmap.append(np.zeros(0, np.int64))

    # ---- postings ---------------------------------------------------------
    parts_tid, parts_row, parts_tf, parts_fm = [], [], [], []
    parts_hit_start, parts_seg = [], []
    hit_bases = np.zeros(K + 1, np.int64)
    for i, p in enumerate(segments):
        hit_bases[i + 1] = hit_bases[i] + len(p.hit_packed)
        P = p.n_postings
        if not P:
            continue
        post_tid_old = np.repeat(np.arange(p.n_terms, dtype=np.int64),
                                 p.term_docs)
        tid = seg_tidmap[i][post_tid_old]
        row = seg_rowmap[i][p.post_rowid.astype(np.int64)]
        keep = row >= 0
        parts_tid.append(tid[keep])
        parts_row.append(row[keep])
        parts_tf.append(p.post_tf[keep])
        parts_fm.append(p.post_fieldmask[keep])
        parts_hit_start.append(
            p.post_hit_offset[:-1].astype(np.int64)[keep] + hit_bases[i])
        parts_seg.append(np.full(int(keep.sum()), i, np.int64))

    if parts_tid:
        tid = np.concatenate(parts_tid)
        row = np.concatenate(parts_row)
        tf = np.concatenate(parts_tf)
        fm = np.concatenate(parts_fm)
        hstart = np.concatenate(parts_hit_start)
        # combined-key radix sort: ~2x over lexsort on this host
        # (tid < 2^31, row < 2^32 -> the packed key is collision-free)
        order = np.argsort((tid << 32) | row, kind="stable")
        tid, row, tf, fm, hstart = (tid[order], row[order], tf[order],
                                    fm[order], hstart[order])
    else:
        tid = row = hstart = np.zeros(0, np.int64)
        tf = fm = np.zeros(0, np.int32)

    P = len(tid)
    post_hit_offset = np.zeros(P + 1, np.int32)
    np.cumsum(tf, out=post_hit_offset[1:])
    H = int(post_hit_offset[-1])

    # hits: gather each posting's old hit slice into the new order
    all_hits = (np.concatenate([p.hit_packed for p in segments])
                if K else np.zeros(0, np.int32))
    if H:
        tf64 = tf.astype(np.int64)
        excl = post_hit_offset[:-1].astype(np.int64)
        idx = (np.repeat(hstart, tf64)
               + np.arange(H, dtype=np.int64) - np.repeat(excl, tf64))
        hit_packed = all_hits[idx]
    else:
        hit_packed = np.zeros(0, np.int32)

    T = len(term_strs)
    term_offsets = np.searchsorted(tid, np.arange(T + 1)).astype(np.int32)
    term_docs = np.diff(term_offsets).astype(np.int32)
    term_hits = np.zeros(T, np.int32)
    if P:
        np.add.at(term_hits, tid, tf)

    # ---- attributes / row-aligned payloads --------------------------------
    def scatter_rows(getter, dtype=None, fill=0):
        """Build a row-aligned array by scattering each segment's live rows
        into new-rowid positions."""
        out = None
        for i, p in enumerate(segments):
            src = getter(p)
            if src is None:
                continue
            if out is None:
                out = np.full(n_new, fill,
                              dtype or np.asarray(src).dtype)
            rows = seg_live_rows[i]
            out[seg_rowmap[i][rows]] = np.asarray(src)[rows]
        return out

    def scatter_list(getter, default=""):
        out = [default] * n_new
        for i, p in enumerate(segments):
            src = getter(p)
            if src is None:
                continue
            nm = seg_rowmap[i]
            for r in seg_live_rows[i].tolist():
                out[nm[r]] = src[r]
        return out

    attrs_int = {k: scatter_rows(lambda p, k=k: p.attrs_int.get(k),
                                 np.int32)
                 for k in segments[0].attrs_int}
    attrs_big = {k: scatter_rows(lambda p, k=k: p.attrs_big.get(k),
                                 np.int64)
                 for k in segments[0].attrs_big}
    attrs_float = {k: scatter_rows(lambda p, k=k: p.attrs_float.get(k),
                                   np.float32)
                   for k in segments[0].attrs_float}
    attrs_str = {k: scatter_list(lambda p, k=k: p.attrs_str.get(k))
                 for k in segments[0].attrs_str}
    attrs_json = {k: scatter_list(lambda p, k=k: p.attrs_json.get(k),
                                  default=None)
                  for k in segments[0].attrs_json}
    attrs_mva = {}
    for k in segments[0].attrs_mva:
        lists = scatter_list(
            lambda p, k=k: _mva_lists(p, k), default=[])
        attrs_mva[k] = _pack_mva(lists)
    stored_fields = {f: scatter_list(
        lambda p, f=f: p.stored_fields.get(f))
        for f in segments[0].stored_fields}
    Fw = segments[0].field_lens.shape[1] if segments[0].field_lens.ndim > 1 \
        else max(schema.n_fields, 1)
    field_lens = np.zeros((n_new, Fw), np.int32)
    for i, p in enumerate(segments):
        rows = seg_live_rows[i]
        field_lens[seg_rowmap[i][rows]] = p.field_lens[rows]

    # ---- positional side structures --------------------------------------
    def remap_spans(rows_of, keys_of):
        rr, kk = [], []
        for i, p in enumerate(segments):
            r0 = rows_of(p)
            if r0 is None or not len(r0):
                continue
            nr = seg_rowmap[i][r0.astype(np.int64)]
            keep = nr >= 0
            rr.append(nr[keep])
            kk.append(keys_of(p)[keep])
        if not rr:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        r = np.concatenate(rr)
        k2 = np.concatenate(kk)
        o = np.lexsort((k2, r))
        return r[o].astype(np.int32), k2[o].astype(np.int32)

    sent_rowid, sent_pkey = remap_spans(lambda p: p.sent_rowid,
                                        lambda p: p.sent_pkey)
    para_rowid, para_pkey = remap_spans(lambda p: p.para_rowid,
                                        lambda p: p.para_pkey)
    zones: dict = {}
    znames = set()
    for p in segments:
        znames |= set(p.zones)
    for z in znames:
        rr, ss, ee = [], [], []
        for i, p in enumerate(segments):
            zr = p.zones.get(z)
            if zr is None or not len(zr[0]):
                continue
            nr = seg_rowmap[i][zr[0].astype(np.int64)]
            keep = nr >= 0
            rr.append(nr[keep])
            ss.append(zr[1][keep])
            ee.append(zr[2][keep])
        if rr:
            r = np.concatenate(rr)
            s = np.concatenate(ss)
            e = np.concatenate(ee)
            o = np.lexsort((s, r))
            zones[z] = (r[o].astype(np.int32), s[o].astype(np.int32),
                        e[o].astype(np.int32))
        else:
            zones[z] = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                        np.zeros(0, np.int32))

    post_tf = tf.astype(np.int32)
    return PackedIndex(
        schema=schema,
        n_docs=n_new,
        doc_ids=doc_ids,
        term_strs=term_strs,
        term_offsets=term_offsets,
        term_docs=term_docs,
        term_hits=term_hits,
        post_rowid=row.astype(np.int32),
        post_tf=post_tf,
        post_tfq=(post_tf.astype(np.float32)
                  / (post_tf + np.float32(SPH_BM25_K1))).astype(np.float32),
        post_fieldmask=fm.astype(np.int32),
        post_hit_offset=post_hit_offset,
        hit_packed=hit_packed.astype(np.int32),
        attrs_int=attrs_int,
        attrs_big=attrs_big,
        attrs_float=attrs_float,
        attrs_str=attrs_str,
        attrs_json=attrs_json,
        attrs_mva=attrs_mva,
        stored_fields=stored_fields,
        field_lens=field_lens,
        total_hits=H,
        tokenizer_settings=segments[0].tokenizer_settings,
        dict_settings=segments[0].dict_settings,
        sent_rowid=sent_rowid,
        sent_pkey=sent_pkey,
        para_rowid=para_rowid,
        para_pkey=para_pkey,
        zones=zones,
    )


def _mva_lists(p: PackedIndex, k: str):
    off, vals = p.attrs_mva[k]
    return [vals[off[r]:off[r + 1]].tolist() for r in range(p.n_docs)]
