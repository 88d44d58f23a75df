"""RT (real-time) index: in-RAM segments + device chunks + binlog WAL.

Behavioral model: RtIndex_c (Manticore src/sphinxrt.cpp:931):
INSERT/REPLACE accumulate into a per-session accumulator (RtAccum_t,
accumulator.h:84); COMMIT builds an in-RAM segment searchable immediately
(CreateSegment, sphinxrt.cpp:2503); segments merge progressively
(MergeSegments:2606); every commit is WAL-logged for crash replay
(RtBinlog_c:762); REPLACE kills older versions of the docid across segments
via kill-lists; TRUNCATE/OPTIMIZE manage the segment set.

A "segment" is a PackedIndex served by its own ``SearchIndex`` on the RT
index's device (the card unless the caller asks for "cpu"); small segments
are cheap to build: the builder is vectorized numpy. Search fans out over
segments with term stats summed across them (``exec.multi.search_rt``)
and merges per-segment top-k host-side, the same merge as the
distributed path. OPTIMIZE/progressive merge work at the posting level
(index/merge.py): no re-tokenization; source docs are retained only as the
docstore.

The port's counterpart of ``manticoresearch_tpu/index/rt.py``: the host
code is a copy; ``_reupload_attrs`` refreshes the segment's device
attributes as torch tensors, key for key and dtype for dtype.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..schema import Schema
from ..text.dictionary import DictSettings
from ..text.tokenizer import TokenizerSettings
from ..utils import trace
from .builder import IndexBuilder, PackedIndex


@dataclass
class _Segment:
    packed: PackedIndex
    search: Any                      # exec.searcher.SearchIndex
    docs: dict[int, dict]            # retained source docs (for merge)
    chunk_id: int | None = None      # persistent disk-chunk id; None = RAM


class RtIndex:
    MERGE_SEGMENT_LIMIT = 12         # progressive merge threshold
    BINLOG_MAX_BYTES = 128 << 20     # size-triggered binlog rotation

    def __init__(self, name: str, schema: Schema,
                 tokenizer_settings: TokenizerSettings | None = None,
                 dict_settings: DictSettings | None = None,
                 data_dir: str | None = None, device="cuda"):
        self.name = name
        self.device = device           # every segment's SearchIndex device
        self.schema = schema
        self.tok_settings = tokenizer_settings or TokenizerSettings()
        self.dict_settings = dict_settings or DictSettings()
        self.segments: list[_Segment] = []
        self.next_chunk_id = 0         # persistent disk-chunk id counter
        self.accum: dict[int, dict] = {}      # pending (uncommitted) docs
        self.accum_deletes: set[int] = set()
        self.docid_seg: dict[int, int] = {}   # live docid -> segment idx
        self.data_dir = data_dir
        self.generation = 0            # bumped by every write (qcache key)
        self.qcache = None             # shared QueryCache (set by Catalog)
        self._binlog = None
        self._binlog_path = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            self._binlog_path = os.path.join(data_dir, "binlog.jsonl")
            from .storage import load_rt_snapshot
            load_rt_snapshot(self)          # checkpoint first...
            self._replay_binlog()           # ...then WAL records after it
            self._binlog = open(self._binlog_path, "a", encoding="utf-8")

    # -- write path ---------------------------------------------------------
    def insert(self, doc: dict, replace: bool = False) -> None:
        docid = int(doc["id"])
        if not replace and (docid in self.docid_seg or docid in self.accum):
            raise ValueError(f"duplicate id {docid}")
        doc = dict(doc)
        if str((getattr(self, "options", None) or {}).get(
                "index_field_lengths", "0")).strip() not in ("", "0"):
            # index_field_lengths: auto-populate <field>_len TOKENCOUNT
            # attrs (AddAutoAttrs / m_pFieldLengthAttrs)
            attr_names = {a.name for a in self.schema.attrs}
            tok = None
            for f in self.schema.fields:
                ln_name = f + "_len"
                if ln_name not in attr_names or ln_name in doc:
                    continue
                if tok is None:
                    from ..text.tokenizer import Tokenizer
                    tok = Tokenizer(self.tok_settings)
                doc[ln_name] = len(tok.tokenize(str(doc.get(f, "") or "")))
        self.accum[docid] = doc
        self.accum_deletes.discard(docid)

    def delete(self, docids: list[int]) -> int:
        n = 0
        for d in docids:
            d = int(d)
            if d in self.accum:
                del self.accum[d]
                n += 1
            elif d in self.docid_seg:
                self.accum_deletes.add(d)
                n += 1
        return n

    def commit(self) -> int:
        """Seal the accumulator into a searchable segment (RtIndex_c::Commit,
        sphinxrt.cpp:2503). Returns affected row count."""
        n = len(self.accum) + len(self.accum_deletes)
        if not n:
            return 0
        self._binlog_write({
            "op": "commit",
            "docs": list(self.accum.values()),
            "deletes": sorted(self.accum_deletes),
            "ts": time.time(),
        })
        self._apply_commit(self.accum, self.accum_deletes)
        self.accum = {}
        self.accum_deletes = set()
        return n

    def rollback(self) -> None:
        self.accum = {}
        self.accum_deletes = set()

    def _apply_commit(self, docs: dict[int, dict], deletes: set[int]) -> None:
        from ..exec.searcher import SearchIndex

        self.generation += 1

        # kill superseded/deleted docids in existing segments
        kill = set(deletes) | (docs.keys() & self.docid_seg.keys())
        by_seg: dict[int, list[int]] = {}
        for d in kill:
            if d in self.docid_seg:
                by_seg.setdefault(self.docid_seg[d], []).append(d)
        for si, ids in by_seg.items():
            self.segments[si].search.delete_documents(ids)
            for d in ids:
                del self.segments[si].docs[d]
                del self.docid_seg[d]

        if docs:
            b = IndexBuilder(self.schema, self.tok_settings, self.dict_settings)
            b.add_documents(docs.values())
            packed = b.build()
            seg = _Segment(packed, SearchIndex(packed, self.device),
                           dict(docs))
            self.segments.append(seg)
            si = len(self.segments) - 1
            for d in docs:
                self.docid_seg[d] = si
            # every new-segment commit re-sorts the RAM segments by merge
            # factor (= row count) DESC (MergeSegments, sphinxrt.cpp:2633)
            # via sphSort, whose insertion sort REVERSES equal elements —
            # same-size segments surface newest-first. Observable: the
            # implicit-group rep row and FLUSH RAMCHUNK's rowid order
            # (golden test_412 keeps j.id=7, the later insert).
            from ..exec.multi import sph_sort_indices
            chunks = [s for s in self.segments if s.chunk_id is not None]
            rams = [s for s in self.segments if s.chunk_id is None]
            order = sph_sort_indices(
                len(rams),
                lambda a, b: rams[a].packed.n_docs > rams[b].packed.n_docs)
            self._set_segments(chunks + [rams[i] for i in order])

        if len(self.segments) > self.MERGE_SEGMENT_LIMIT:
            self._merge_segments()

    def _merge_segments(self) -> None:
        """Progressive merge (MergeSegments, sphinxrt.cpp:2606): merge the
        smallest half at the POSTING level — no re-tokenization; killed
        rows are compacted away (index/merge.py). Only RAM segments
        participate — sealed disk chunks keep their identity (split/
        merge them explicitly via DEBUG SPLIT/MERGE or OPTIMIZE)."""
        from ..exec.searcher import SearchIndex
        from .merge import merge_packed

        chunks = [s for s in self.segments if s.chunk_id is not None]
        rams = [s for s in self.segments if s.chunk_id is None]
        order = sorted(range(len(rams)),
                       key=lambda i: rams[i].packed.n_docs)
        merge_idx = set(order[: len(order) // 2 + 1])
        merged_docs: dict[int, dict] = {}
        to_merge: list[_Segment] = []
        keep: list[_Segment] = []
        for i, seg in enumerate(rams):
            if i in merge_idx:
                merged_docs.update(seg.docs)
                to_merge.append(seg)
            else:
                keep.append(seg)
        if to_merge:
            packed = merge_packed([s.packed for s in to_merge],
                                  [set(s.docs) for s in to_merge])
            keep.append(_Segment(packed, SearchIndex(packed, self.device),
                                 merged_docs))
        self._set_segments(chunks + keep)

    def _set_segments(self, segs: list[_Segment]) -> None:
        """Install a new segment list (disk chunks first, in position
        order, RAM segments after) and rebuild the docid map."""
        self.segments = segs
        self.docid_seg = {}
        for si, seg in enumerate(segs):
            for d in seg.docs:
                self.docid_seg[d] = si

    def alter(self, op: str, name: str, coltype=None) -> None:
        """ALTER TABLE ADD/DROP COLUMN (AlterSchemaAdd/Drop in the
        reference's DDL layer). Because segments retain their source docs,
        a schema change is a rebuild of every segment under the new schema —
        the reference's attr-blob rewrite, done the simple way."""
        from ..schema import AttrDef, Schema

        if self.accum or self.accum_deletes:
            raise ValueError("ALTER with uncommitted changes; COMMIT first")
        fields = list(self.schema.fields)
        attrs = list(self.schema.attrs)
        if op == "add":
            if name in fields or self.schema.attr(name) or name == "id":
                raise ValueError(f"column '{name}' already exists")
            if coltype == "field":
                fields.append(name)
            else:
                attrs.append(AttrDef(name, coltype))
        elif op == "drop":
            if name in fields:
                fields.remove(name)
            elif self.schema.attr(name):
                attrs = [a for a in attrs if a.name != name]
            else:
                raise ValueError(f"unknown column '{name}'")
        else:
            raise ValueError(f"unknown ALTER op {op!r}")
        self.schema = Schema(fields=fields, attrs=attrs)
        self.generation += 1
        if op == "drop":
            for seg in self.segments:
                for doc in seg.docs.values():
                    doc.pop(name, None)
        self._binlog_write({"op": "alter", "alter": op, "name": name,
                            "coltype": getattr(coltype, "value", coltype),
                            "ts": time.time()})
        self._rebuild_segments()

    def _rebuild_segments(self) -> None:
        from ..exec.searcher import SearchIndex

        rebuilt = []
        for seg in self.segments:
            if not seg.docs:
                continue
            b = IndexBuilder(self.schema, self.tok_settings,
                             self.dict_settings)
            b.add_documents(seg.docs.values())
            packed = b.build()
            rebuilt.append(_Segment(packed, SearchIndex(packed, self.device),
                                    dict(seg.docs), seg.chunk_id))
        self.segments = rebuilt
        self.docid_seg = {}
        for si, seg in enumerate(self.segments):
            for d in seg.docs:
                self.docid_seg[d] = si

    def attach_packed(self, packed) -> None:
        """Append an offline-built index as one sealed segment — the
        served-table ATTACH path (sphinxrt.cpp AttachDiskIndex): postings
        move in as-is, docs reconstruct from stored fields + attrs so
        later merges keep working. Docids already present in this RT
        index are killed first (REPLACE semantics on collision)."""
        from ..exec.searcher import SearchIndex

        docs = _docs_from_packed(packed)
        dupes = [d for d in docs if d in self.docid_seg]
        if dupes:
            self.delete(dupes)
        self.generation += 1
        cid = self.next_chunk_id      # an attached index IS a disk chunk
        self.next_chunk_id += 1
        seg = _Segment(packed, SearchIndex(packed, self.device), docs, cid)
        self._set_segments(self._chunks() + [seg] + self._ram_segs())

    # -- disk-chunk management (golden test_066) ---------------------------
    def _chunks(self) -> list[_Segment]:
        return [s for s in self.segments if s.chunk_id is not None]

    def _ram_segs(self) -> list[_Segment]:
        return [s for s in self.segments if s.chunk_id is None]

    def flush_ramchunk(self) -> None:
        """FLUSH RAMCHUNK: seal every RAM segment into one new disk chunk
        with a persistent chunk id (ForceRamFlush/SaveDiskChunk,
        sphinxrt.cpp; chunk numbering m_iChunk)."""
        rams = self._ram_segs()
        if not rams:
            return
        self.generation += 1
        from ..exec.searcher import SearchIndex
        from .merge import merge_packed

        docs: dict[int, dict] = {}
        for s in rams:
            docs.update(s.docs)
        if len(rams) == 1:
            packed, search = rams[0].packed, rams[0].search
        else:
            # disk-chunk save keeps segment-concatenation rowid order
            # (SaveDiskChunk tNextRowID walk, sphinxrt.cpp:3014) — NOT
            # global docid order; observable via sorter rowid ties
            packed = merge_packed([s.packed for s in rams],
                                  [set(s.docs) for s in rams],
                                  row_order="concat")
            search = SearchIndex(packed, self.device)
        cid = self.next_chunk_id
        self.next_chunk_id += 1
        self._set_segments(self._chunks()
                           + [_Segment(packed, search, docs, cid)])
        self._binlog_write({"op": "flush_ramchunk", "ts": time.time()})

    def _build_chunk_from_docs(self, docs: dict[int, dict]) -> _Segment:
        from ..exec.searcher import SearchIndex
        b = IndexBuilder(self.schema, self.tok_settings, self.dict_settings)
        b.add_documents(docs.values())
        packed = b.build()
        cid = self.next_chunk_id
        self.next_chunk_id += 1
        return _Segment(packed, SearchIndex(packed, self.device), dict(docs),
                        cid)

    def split_chunk(self, chunk_id: int, ids) -> bool:
        """DEBUG SPLIT <table> <chunk_id> ON @uservar (SplitOneChunk,
        sphinxrt.cpp): the chunk splits in place into [docs in the id
        set, docs outside it]; the non-matching part takes the first new
        chunk id, the matching part the second, and the matching part
        lands first positionally. No-op when the chunk id doesn't exist
        or either side would be empty."""
        pos = next((i for i, s in enumerate(self.segments)
                    if s.chunk_id == chunk_id), None)
        if pos is None:
            return False
        idset = {int(x) for x in ids}
        seg = self.segments[pos]
        match_docs = {d: v for d, v in seg.docs.items() if d in idset}
        rest_docs = {d: v for d, v in seg.docs.items() if d not in idset}
        if not match_docs or not rest_docs:
            return False
        self.generation += 1
        rest = self._build_chunk_from_docs(rest_docs)
        got = self._build_chunk_from_docs(match_docs)
        self._set_segments(self.segments[:pos] + [got, rest]
                           + self.segments[pos + 1:])
        self._binlog_write({"op": "split", "chunk": int(chunk_id),
                            "ids": sorted(idset), "ts": time.time()})
        return True

    def merge_chunks(self, cid_a: int, cid_b: int) -> bool:
        """DEBUG MERGE <table> <A> <B>: chunk A merges into chunk B —
        the combined chunk (A's docs first) takes a fresh chunk id at
        B's position (MergeTwoChunks, sphinxrt.cpp)."""
        pa = next((i for i, s in enumerate(self.segments)
                   if s.chunk_id == cid_a), None)
        pb = next((i for i, s in enumerate(self.segments)
                   if s.chunk_id == cid_b), None)
        if pa is None or pb is None or pa == pb:
            return False
        self.generation += 1
        docs: dict[int, dict] = {}
        docs.update(self.segments[pa].docs)
        docs.update(self.segments[pb].docs)
        merged = self._build_chunk_from_docs(docs)
        segs = list(self.segments)
        segs[pb] = merged
        del segs[pa]
        self._set_segments(segs)
        self._binlog_write({"op": "merge", "a": int(cid_a), "b": int(cid_b),
                            "ts": time.time()})
        return True

    def chunk_status(self) -> list[dict]:
        """Rows for SELECT ... FROM <table>.status — one per disk chunk in
        position order (HandleSelectIndexStatus, searchd.cpp:14371)."""
        path = (getattr(self, "options", None) or {}).get("path") \
            or f"data/{self.name}"
        rows = []
        for s in self._chunks():
            live = len(s.docs)
            ibytes = sum(len(str(doc.get(f) or ""))
                         for doc in s.docs.values()
                         for f in self.schema.fields)
            rows.append({
                "chunk_id": s.chunk_id,
                "base_name": f"{path}.{s.chunk_id}",
                "indexed_documents": live,
                "indexed_bytes": ibytes,
                "ram_bytes": 0, "disk_bytes": 0, "disk_mapped": 0,
                "disk_mapped_cached": 0, "disk_mapped_doclists": 0,
                "disk_mapped_cached_doclists": 0,
                "disk_mapped_hitlists": 0,
                "disk_mapped_cached_hitlists": 0,
                "killed_documents": int(s.packed.n_docs) - live,
            })
        return rows

    def part_view(self, n: int) -> "RtIndex":
        """Single-part pseudo-table for SELECT ... FROM <table>.<N> —
        disk chunks in position order, then RAM segments (GetDiskChunk
        subtable addressing, searchd.cpp ParseIdxSubkeys)."""
        parts = self._chunks() + self._ram_segs()
        v = RtIndex(f"{self.name}.{n}", self.schema, self.tok_settings,
                    self.dict_settings, device=self.device)
        v.generation = self.generation   # qcache key stays fresh
        v.options = dict(getattr(self, "options", None) or {})
        v.stored_fields = getattr(self, "stored_fields", None)
        if 0 <= n < len(parts):
            seg = parts[n]
            v.segments = [seg]
            v.docid_seg = {d: 0 for d in seg.docs}
        return v

    def truncate(self) -> None:
        self.generation += 1
        self.segments = []
        self.accum = {}
        self.accum_deletes = set()
        self.docid_seg = {}
        self._binlog_write({"op": "truncate", "ts": time.time()})

    def optimize(self) -> None:
        """OPTIMIZE INDEX: posting-level merge of every segment into one
        (no re-tokenization; sphinxrt.cpp Optimize_ -> merge path)."""
        if len(self.segments) <= 1:
            return
        from ..exec.searcher import SearchIndex
        from .merge import merge_packed

        self.generation += 1
        all_docs: dict[int, dict] = {}
        for seg in self.segments:
            all_docs.update(seg.docs)
        packed = merge_packed([s.packed for s in self.segments],
                              [set(s.docs) for s in self.segments])
        cid = None
        if any(s.chunk_id is not None for s in self.segments):
            cid = self.next_chunk_id     # merged disk chunk keeps identity
            self.next_chunk_id += 1
        self.segments = [_Segment(packed, SearchIndex(packed, self.device),
                                  all_docs, cid)] if all_docs else []
        self.docid_seg = {d: 0 for d in all_docs}

    # -- update -------------------------------------------------------------
    def update_attrs(self, docids: list[int], values: dict[str, Any]) -> int:
        """UPDATE ... SET attr=val (in-place attr update, no re-tokenize —
        reference semantics for plain attr updates)."""
        n = 0
        self.generation += 1
        touched: set[int] = set()
        for d in docids:
            d = int(d)
            seg = None
            if d in self.accum:
                self.accum[d].update(values)
                n += 1
                continue
            si = self.docid_seg.get(d)
            if si is None:
                continue
            seg = self.segments[si]
            r = seg.packed.rowid_of_docid(d)
            if r < 0:
                continue
            for name, val in values.items():
                if name in seg.packed.attrs_int:
                    seg.packed.attrs_int[name][r] = int(val)
                elif name in seg.packed.attrs_big:
                    seg.packed.attrs_big[name][r] = int(val)
                elif name in seg.packed.attrs_float:
                    seg.packed.attrs_float[name][r] = float(val)
                elif name in seg.packed.attrs_mva:
                    # MVA update rebuilds the attr's CSR (value lists
                    # change length; UpdateAttributes_fn MVA pool write)
                    off, vals_a = seg.packed.attrs_mva[name]
                    lists = [vals_a[off[i]:off[i + 1]].tolist()
                             for i in range(len(off) - 1)]
                    newv = sorted(int(x) for x in
                                  (val if isinstance(val, (list, tuple))
                                   else [val]))
                    lists[r] = newv
                    no = np.zeros(len(lists) + 1, np.int64)
                    for i, l2 in enumerate(lists):
                        no[i + 1] = no[i] + len(l2)
                    nv = np.array([x for l2 in lists for x in l2],
                                  vals_a.dtype if len(vals_a) else
                                  np.int64)
                    seg.packed.attrs_mva[name] = (
                        no.astype(off.dtype), nv)
                elif name in seg.packed.attrs_str:
                    # blob string update (UpdateAttributes .SPB rewrite,
                    # sphinx.cpp blob updates; golden test_414) — the
                    # ordinal cache rebuilds on re-upload
                    seg.packed.attrs_str[name][r] = str(val)
                    if hasattr(seg.packed, "_str_ord"):
                        seg.packed._str_ord = {}
                elif name in seg.packed.attrs_json:
                    from ..utils.jsonrender import render_json
                    seg.packed.attrs_json[name][r] = (
                        render_json(val) if isinstance(val, str) else val)
                    if hasattr(seg.packed, "_json_parsed"):
                        del seg.packed._json_parsed
                else:
                    raise ValueError(f"unknown or non-updatable attr {name!r}")
                seg.docs[d][name] = val
            touched.add(si)
            n += 1
        if n:
            self._binlog_write({"op": "update", "ids": [int(x) for x in docids],
                                "values": values, "ts": time.time()})
        # re-upload touched segments' attrs to device
        for si in touched:
            self._reupload_attrs(si)
        return n

    def _reupload_attrs(self, si: int) -> None:
        """Refresh the segment's device attributes from its host arrays:
        the keys and dtypes of ``ops.device_index.host_arrays``. As in the
        JAX package, a bigint's ``#hi`` / ``#lo`` split arrays are left as
        they were uploaded."""
        seg = self.segments[si]
        search = seg.search
        dev = search.device
        p = seg.packed

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a)).to(dev.device)

        # attr values changed: drop the secondary-index cache and rebuild
        # the device permutations so scan-index plans stay correct
        if hasattr(p, "_attr_idx"):
            p._attr_idx = {}
        # the JAX package plans a device GROUP BY afresh on every query;
        # the port caches those plans, so drop them (ranked plans stay
        # cached in both)
        for key in [k for k in search._plan_cache
                    if isinstance(k, tuple) and k and k[0] == "group"]:
            del search._plan_cache[key]
        for name in list(dev.attrs):
            if name in p.attrs_int:
                dev.attrs[name] = put(p.attrs_int[name].astype(np.int32))
            elif name in p.attrs_float:
                dev.attrs[name] = put(p.attrs_float[name].astype(np.float32))
            elif name in p.attrs_big:
                dev.attrs[name] = put(
                    np.clip(p.attrs_big[name], -(2**31), 2**31 - 1
                            ).astype(np.int32))
            elif name.split("\x00")[0] in p.attrs_str:
                base = name.split("\x00")[0]
                ci = name.endswith("\x00ci")
                dev.attrs[name] = put(p.str_ordinals(base, ci)[2])
        for name in list(dev.mva_offsets):
            if name in p.attrs_mva:
                off, vals_a = p.attrs_mva[name]
                dev.mva_offsets[name] = put(off.astype(np.int32))
                dev.mva_values[name] = put(
                    np.clip(vals_a, -(2**31), 2**31 - 1).astype(np.int32))
        for name in list(dev.attr_perm):
            _, perm = p.attr_index(name)
            old = dev.attr_perm[name]
            pad = old.shape[0] - len(perm)
            dev.attr_perm[name] = put(np.concatenate(
                [perm.astype(np.int32),
                 np.full(pad, p.n_docs, np.int32)]))

    # -- binlog (RtBinlog_c analog, sphinxrt.cpp:762) -----------------------
    def _binlog_write(self, rec: dict) -> None:
        if self._binlog is not None:
            self._binlog.write(json.dumps(rec) + "\n")
            self._binlog.flush()
            os.fsync(self._binlog.fileno())
            # size-triggered rotation (binlog_max_log_size semantics,
            # sphinxrt binlog files): checkpoint + reset when the log
            # outgrows the cap — replay time stays bounded
            if self._binlog.tell() > self.BINLOG_MAX_BYTES:
                self.flush()

    def _replay_binlog(self) -> None:
        if not self._binlog_path or not os.path.exists(self._binlog_path):
            return
        with open(self._binlog_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail record: stop replay (reference CRC stop)
                self.apply_binlog_record(rec)

    def apply_binlog_record(self, rec: dict) -> None:
        """Apply one WAL record (startup replay and replica streams both
        funnel here — the reference's CommitReplayable/HandleCmdReplicate
        split, sphinxrt.cpp:2704, searchdreplication.cpp)."""
        op = rec.get("op")
        if op == "commit":
            docs = {int(d["id"]): d for d in rec.get("docs", [])}
            self._apply_commit(docs, set(rec.get("deletes", [])))
        elif op == "truncate":
            self.segments = []
            self.docid_seg = {}
        elif op == "update":
            self.update_attrs(rec["ids"], rec["values"])
        elif op == "alter":
            from ..schema import AttrType
            ct = rec.get("coltype")
            if ct and ct != "field":
                ct = AttrType(ct)
            self.alter(rec["alter"], rec["name"], ct)
        elif op == "flush_ramchunk":
            self.flush_ramchunk()
        elif op == "split":
            self.split_chunk(rec["chunk"], rec.get("ids", []))
        elif op == "merge":
            self.merge_chunks(rec["a"], rec["b"])

    def flush(self) -> None:
        """FLUSH RTINDEX analog: checkpoint segments to disk and reset the
        binlog (disk-chunk save, sphinxrt.cpp:3608)."""
        if not self.data_dir:
            return
        from .storage import save_rt_snapshot
        save_rt_snapshot(self)
        if self._binlog is not None:
            self._binlog.close()
        open(self._binlog_path, "w").close()
        self._binlog = open(self._binlog_path, "a", encoding="utf-8")

    # -- read path ----------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return len(self.docid_seg) + len(self.accum)

    def get_document(self, docid: int) -> dict | None:
        """Fetch a live document's source (docstore lookup analog)."""
        docid = int(docid)
        if docid in self.accum:
            return self.accum[docid]
        si = self.docid_seg.get(docid)
        if si is None:
            return None
        return self.segments[si].docs.get(docid)

    def searchable_parts(self):
        return [s.search for s in self.segments]

    def global_stats(self):
        """Aggregate per-term df and total docs across segments (the
        reference sums segment qword stats at setup, sphinxrt.cpp)."""
        # count ROWS, not unique docids: a plain-built segment may carry
        # duplicate-id rows (test_047) and each contributes to N for IDF
        total_docs = sum(s.packed.n_docs for s in self.segments)
        df: dict[str, int] = {}
        for seg in self.segments:
            p = seg.packed
            for t, d in zip(p.term_strs, p.term_docs.tolist()):
                df[t] = df.get(t, 0) + d
        return total_docs, df

    def search(self, q):
        """Search with result-cache hook (qcache hook analog,
        sphinxsearch.cpp:4183: QcacheFind before ranking, QcacheRanker
        after)."""
        from ..exec.multi import search_rt
        qc = self.qcache
        key = None
        if qc is not None:
            key = qc.key(self.name, self.generation, q)
            hit = qc.get(key)
            if hit is not None:
                return hit
        with trace.request(1):     # the segments' searches join it
            res = search_rt(self, q)
        # RAM segments never cache: the reference's qcache keys disk-chunk
        # identity only (sphinxqcache.cpp ties entries to a CSphIndex+TID;
        # RAM chunks are excluded — golden test_229's counters stay 0
        # pre-flush). qcache_thresh_msec=0 caches everything (golden
        # test_401 counts the first SELECT's entry). The JAX package also
        # keeps a query whose time includes a compile out of the cache;
        # the port has no compile step to tell apart.
        if qc is not None and res.error is None and \
                (qc.thresh_msec == 0 or res.time_ms >= qc.thresh_msec) and \
                self.segments and not self._ram_segs():
            qc.put(key, res)
        return res


def _docs_from_packed(packed) -> dict[int, dict]:
    """Reconstruct source docs from a packed index's stored fields +
    attrs (so RT-level merges can re-tokenize if they must)."""
    docs: dict[int, dict] = {}
    for r, did in enumerate(packed.doc_ids.tolist()):
        d: dict = {"id": int(did)}
        for fname, vals in packed.stored_fields.items():
            d[fname] = vals[r]
        for aname, arr in packed.attrs_int.items():
            d[aname] = int(arr[r])
        for aname, arr in packed.attrs_big.items():
            d[aname] = int(arr[r])
        for aname, arr in packed.attrs_float.items():
            d[aname] = float(arr[r])
        for aname, lst in packed.attrs_str.items():
            d[aname] = lst[r]
        for aname, (off, vals) in packed.attrs_mva.items():
            d[aname] = [int(x) for x in vals[off[r]:off[r + 1]]]
        docs[int(did)] = d
    return docs


def rt_from_packed(name: str, packed, data_dir: str | None = None,
                   device="cuda") -> "RtIndex":
    """Wrap a plain (offline-built) index as a served RT table with one
    sealed segment — the ATTACH INDEX path (sphinxrt AttachDiskIndex
    semantics). Source docs reconstruct from stored fields + attrs so later
    merges keep working."""
    from ..exec.searcher import SearchIndex

    rt = RtIndex(name, packed.schema, packed.tokenizer_settings,
                 packed.dict_settings, data_dir=data_dir, device=device)
    docs = _docs_from_packed(packed)
    rt.segments = [_Segment(packed, SearchIndex(packed, device), docs, 0)]
    rt.next_chunk_id = 1
    rt.docid_seg = {d: 0 for d in docs}
    return rt
