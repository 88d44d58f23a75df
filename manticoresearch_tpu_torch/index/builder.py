"""Index builder: documents -> device-ready SoA posting arrays.

Behavioral model: the reference's offline build pipeline
(CSphIndex_VLN::Build, Manticore src/sphinx.cpp:10129 and
CSphHitBuilder::cidxHit, sphinx.cpp:8554) which streams sorted
(wordid, rowid, position) hits into dictionary/doclist/hitlist/skiplist files.

TPU-first redesign: instead of VByte-compressed streams with skiplists, we
pack postings into flat SoA arrays sorted by (term, rowid) — the device's
"skip" is simply not gathering — and *eagerly* compute the query-independent
BM25 factor tf/(tf+K1) per posting (K1=1.2, searchnode.cpp:45) so query-time
scoring is one gather + scatter-add (BM25S-style eager scoring, with exact
Manticore semantics preserved because idf multiplies at query time).

Hit (position) packing mirrors Hitman_c (sphinx.h:768-827): bits 0..22 =
1-based in-field position, bit 23 = field-end flag, bits 24..30 = field id.
Rowids are assigned in ascending docid order so that index-order tie-breaks
equal the reference's (weight desc, docid asc) sort (sphinxsort.cpp:4534).
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Iterable, Mapping

import numpy as np

from ..schema import AttrType, Schema
from ..text.dictionary import Dictionary, DictSettings
from ..text.tokenizer import Tokenizer, TokenizerSettings

SPH_BM25_K1 = 1.2  # reference searchnode.cpp:45
HITMAN_POS_BITS = 23
HITMAN_FIELD_SHIFT = 24
HITMAN_END_FLAG = 1 << 23
HITMAN_POS_MASK = (1 << 23) - 1
DOC_BLOCK = 128  # reference DOCINFO_INDEX_FREQ / skiplist block (sphinxint.h:312)


def hitman_pack(field_id: int, pos: int, is_end: bool = False) -> int:
    return (field_id << HITMAN_FIELD_SHIFT) | (HITMAN_END_FLAG if is_end else 0) | pos


@dataclass
class PackedIndex:
    """Host-side, device-layout index for one shard."""

    schema: Schema
    n_docs: int
    doc_ids: np.ndarray          # int64[n_docs], ascending
    term_strs: list[str]         # sorted
    term_offsets: np.ndarray     # int32[T+1] into postings
    term_docs: np.ndarray        # int32[T]  (df)
    term_hits: np.ndarray        # int32[T]
    post_rowid: np.ndarray       # int32[P]
    post_tf: np.ndarray          # int32[P]
    post_tfq: np.ndarray         # float32[P] = tf/(tf+K1)
    post_fieldmask: np.ndarray   # int32[P]
    post_hit_offset: np.ndarray  # int32[P+1] into hits
    hit_packed: np.ndarray       # int32[H]
    attrs_int: dict[str, np.ndarray]      # int32[n_docs]
    attrs_big: dict[str, np.ndarray]      # int64[n_docs]
    attrs_float: dict[str, np.ndarray]    # float32[n_docs]
    attrs_str: dict[str, list[str]]
    attrs_json: dict[str, list[Any]]
    attrs_mva: dict[str, tuple[np.ndarray, np.ndarray]]  # (offsets[n+1], values)
    stored_fields: dict[str, list[str]]  # docstore analog (docstore.h:16):
                                         # original field text, row-aligned
    field_lens: np.ndarray       # int32[n_docs, F]
    total_hits: int
    tokenizer_settings: TokenizerSettings = dc_field(default_factory=TokenizerSettings)
    dict_settings: DictSettings = dc_field(default_factory=DictSettings)
    # sentence/paragraph boundaries (index_sp): sorted (rowid, packed-pos of
    # the token that ENDS the sentence/paragraph) — the SENTENCE/PARAGRAPH
    # operators bisect these (reference stores MAGIC_CODE_SENTENCE tokens)
    sent_rowid: np.ndarray = dc_field(
        default_factory=lambda: np.zeros(0, np.int32))
    sent_pkey: np.ndarray = dc_field(
        default_factory=lambda: np.zeros(0, np.int32))
    para_rowid: np.ndarray = dc_field(
        default_factory=lambda: np.zeros(0, np.int32))
    para_pkey: np.ndarray = dc_field(
        default_factory=lambda: np.zeros(0, np.int32))
    # ZONE spans (index_zones): zone name -> (rows, start_keys, end_keys),
    # keys = fid<<24|pos of the zone's first/last token, sorted by (row, key)
    zones: dict = dc_field(default_factory=dict)
    # hitless_words: terms indexed without positions (their hit lists hold
    # one SYNTHETIC hit per matched field at in-field position -1 —
    # ExtTermHitless_T::CollectHits, searchnode.cpp:2142); the planner
    # keeps them out of positional nodes
    hitless_terms: frozenset = frozenset()
    hitless_all: bool = False

    @property
    def n_terms(self) -> int:
        return len(self.term_strs)

    @property
    def n_postings(self) -> int:
        return len(self.post_rowid)

    def term_id(self, term: str) -> int:
        """Sorted-terms binary search (CWordlist checkpoint bsearch analog)."""
        import bisect

        i = bisect.bisect_left(self.term_strs, term)
        if i < len(self.term_strs) and self.term_strs[i] == term:
            return i
        return -1

    def attr_index(self, name: str):
        """Secondary index over a numeric attr: (sorted_values,
        rowid_permutation) — the host keeps the values for bound searches,
        the device keeps the permutation (secondaryindex.h:36 analog)."""
        if not hasattr(self, "_attr_idx"):
            self._attr_idx = {}
        if name not in self._attr_idx:
            if name in self.attrs_int:
                vals = self.attrs_int[name]
            elif name in self.attrs_float:
                vals = self.attrs_float[name]
            elif name in self.attrs_big:
                # int64 values stay exact: the device only holds the
                # rowid permutation; bound searches run host-side
                # (golden test_050 bigint equality pre-selection)
                vals = self.attrs_big[name]
            else:
                raise KeyError(name)
            perm = np.argsort(vals, kind="stable").astype(np.int32)
            self._attr_idx[name] = (np.asarray(vals)[perm], perm)
        return self._attr_idx[name]

    def packed_store(self):
        """Bit-plane packed posting store (built lazily, cached): the HBM
        posting format for single-shard serving (ops/packed_store.py)."""
        if not hasattr(self, "_pstore"):
            from ..ops.packed_store import build_store
            force = None
            if getattr(self.post_fieldmask, "ndim", 1) == 2:
                # wide-field indexes: plane classes pack single-word
                # masks only — keep every term in the raw residual stream
                force = np.zeros(len(self.term_docs), bool)
            self._pstore = build_store(
                self.term_docs, self.term_offsets, self.post_rowid,
                self.post_tf, self.post_tfq, self.post_fieldmask,
                force_packed=force)
        return self._pstore

    def rowid_of_docid(self, docid: int) -> int:
        """docid -> rowid lookup (.spt analog, secondaryindex.h:52).
        Rows need not be docid-ordered (a flushed disk chunk keeps
        segment-concatenation order, SaveDiskChunk sphinxrt.cpp:3014);
        like the reference's dLookup.Sort, the lookup table is sorted
        separately."""
        lk = getattr(self, "_docid_lookup", None)
        if lk is None:
            perm = np.argsort(self.doc_ids, kind="stable")
            lk = (self.doc_ids[perm], perm)
            self._docid_lookup = lk
        svals, perm = lk
        i = int(np.searchsorted(svals, docid))
        if i < self.n_docs and svals[i] == docid:
            return int(perm[i])
        return -1

    def str_ordinals(self, name: str, ci: bool = False):
        """String attr as sorted-unique ordinals: (uniques, value->ord,
        ord_array[i32]). Ordinal order == lexicographic order, so device
        equality/IN/range filters and ORDER BY on the ordinal array are
        exact within this index (the reference compares strings directly,
        sphinxfilter.cpp string filters; we pre-factor the comparison).
        ci=True folds case first (utf8_general_ci collation: values that
        fold equal share one ordinal)."""
        if not hasattr(self, "_str_ord"):
            self._str_ord = {}
        key = (name, ci)
        if key not in self._str_ord:
            vals = self.attrs_str[name]
            if ci:
                vals = [v.casefold() for v in vals]
            uniq = sorted(set(vals))
            lookup = {v: i for i, v in enumerate(uniq)}
            self._str_ord[key] = (
                uniq, lookup,
                np.asarray([lookup[v] for v in vals] or [0], np.int32))
        return self._str_ord[key]

    def json_docs(self, name: str) -> list:
        """Parsed JSON attr column (values may arrive as JSON strings from
        SQL INSERT; parse lazily, cache)."""
        import json as _json
        if not hasattr(self, "_json_parsed"):
            self._json_parsed = {}
        if name not in self._json_parsed:
            out = []
            for v in self.attrs_json[name]:
                if isinstance(v, str):
                    try:
                        v = _json.loads(v) if v.strip() else None
                    except ValueError:
                        v = None
                out.append(v)
            self._json_parsed[name] = out
        return self._json_parsed[name]


class IndexBuilder:
    def __init__(
        self,
        schema: Schema,
        tokenizer_settings: TokenizerSettings | None = None,
        dict_settings: DictSettings | None = None,
    ):
        self.schema = schema
        self.tok_settings = tokenizer_settings or TokenizerSettings()
        self.dict_settings = dict_settings or DictSettings()
        self.tokenizer = Tokenizer(self.tok_settings)
        self.dictionary = Dictionary(self.dict_settings)
        # (docid, doc) in insertion order; duplicate docids are KEPT —
        # the reference's plain indexer writes source rows as-is
        # (duplicate-id rows both survive, test_047 model q7); RT-level
        # REPLACE dedup happens in the RT layer, not here
        self._docs: list[tuple[int, dict]] = []

    def _resolve_hitless(self, term_strs) -> tuple[bool, set]:
        """hitless_words -> (all?, set of dict-processed term strings).
        Word-list files run through the index tokenizer + dictionary
        (morphology applies) exactly like LoadHitlessWords
        (sphinx.cpp:9345)."""
        spec = str(getattr(self.dict_settings, "hitless_words", "") or "")
        if not spec.strip():
            return False, set()
        if spec.strip().lower() == "all":
            return True, set()
        out: set = set()
        for path in spec.replace(",", " ").split():
            try:
                with open(path, encoding="utf-8", errors="replace") as fh:
                    text = fh.read()
            except OSError as e:
                raise ValueError(f"hitless_words: failed to open "
                                 f"'{path}': {e}") from e
            for t in self.tokenizer.tokenize(text):
                for term in self.dictionary.process(t.text):
                    out.add(term)
        return False, out

    def add_document(self, doc: Mapping[str, Any]) -> None:
        if "id" not in doc:
            raise ValueError("document must have an 'id'")
        # ids parse as uint64 but saturate at int64 max (the reference
        # clamps 2^63 to 2^63-1: test_047 'max +1' groups with 'max')
        docid = min(int(doc["id"]), 2**63 - 1)
        if docid <= 0:
            raise ValueError("document id must be a positive integer")
        self._docs.append((docid, dict(doc)))

    def add_documents(self, docs: Iterable[Mapping[str, Any]]) -> None:
        for d in docs:
            self.add_document(d)

    def build(self) -> PackedIndex:
        schema = self.schema
        F = schema.n_fields
        order = sorted(range(len(self._docs)),
                       key=lambda i: self._docs[i][0])
        docs_sorted = [self._docs[i] for i in order]
        doc_ids = np.array([d[0] for d in docs_sorted], dtype=np.int64)
        n = len(doc_ids)

        vocab: dict[str, int] = {}
        hits_tid: list[int] = []
        hits_row: list[int] = []
        hits_packed: list[int] = []
        field_lens = np.zeros((n, F), dtype=np.int32)
        stored_fields: dict[str, list[str]] = {f: [] for f in schema.fields}

        # attribute columns
        attrs_int: dict[str, list] = {}
        attrs_big: dict[str, list] = {}
        attrs_float: dict[str, list] = {}
        attrs_str: dict[str, list] = {}
        attrs_json: dict[str, list] = {}
        attrs_mva: dict[str, list] = {}
        for a in schema.attrs:
            if a.type in (AttrType.UINT, AttrType.BOOL, AttrType.TIMESTAMP):
                attrs_int[a.name] = []
            elif a.type is AttrType.BIGINT:
                attrs_big[a.name] = []
            elif a.type is AttrType.FLOAT:
                attrs_float[a.name] = []
            elif a.type is AttrType.STRING:
                attrs_str[a.name] = []
            elif a.type is AttrType.JSON:
                attrs_json[a.name] = []
            elif a.type in (AttrType.MVA, AttrType.MVA64):
                attrs_mva[a.name] = []

        ds = self.dict_settings
        index_sp = self.tok_settings.index_sp
        index_zones = tuple(self.tok_settings.index_zones)
        bigram_mode = self.tok_settings.bigram_index
        bigram_freq = set(self.tok_settings.bigram_freq_words)
        trivial_dict = (not ds.stopwords and not ds.morphology
                        and not ds.wordforms and not ds.index_exact_words
                        and not getattr(ds, "token_filter", "")
                        and not bigram_mode
                        and not index_sp and not index_zones)

        sent_rows: list[int] = []
        sent_keys: list[int] = []
        para_rows: list[int] = []
        para_keys: list[int] = []
        zone_acc: dict[str, list[tuple[int, int, int]]] = {
            z: [] for z in index_zones if not z.endswith("*")}

        for rowid, (docid, doc) in enumerate(docs_sorted):
            for fid, fname in enumerate(schema.fields):
                text = doc.get(fname, "") or ""
                stored_fields[fname].append(str(text))
                if trivial_dict:
                    # fast path: no per-token dict processing needed
                    terms, positions = self.tokenizer.tokenize_fast(str(text))
                    field_lens[rowid, fid] = len(terms)
                    last_pos = positions[-1] if positions else 0
                    for term, pos in zip(terms, positions):
                        tid = vocab.setdefault(term, len(vocab))
                        hits_tid.append(tid)
                        hits_row.append(rowid)
                        hits_packed.append(
                            hitman_pack(fid, pos, pos == last_pos))
                    continue
                if index_zones or index_sp:
                    # boundary-consuming token stream: sentence/paragraph/
                    # zone boundaries are MAGIC tokens in the reference —
                    # they occupy hit positions exactly like words
                    # (BuildRegularHits + BuildZoneHits,
                    # sphinx.cpp:22437/22233). tokenize_boundaries returns
                    # tokens with adjusted positions plus the boundary
                    # events at their consumed positions.
                    tokens, bevents, last_hit_pos = \
                        self.tokenizer.tokenize_boundaries(str(text))
                    zstack: dict[str, list[int]] = {}
                    for kind, zname, pos in bevents:
                        key = fid << HITMAN_FIELD_SHIFT | pos
                        sent_rows.append(rowid)
                        sent_keys.append(key)
                        if kind == "s":
                            continue
                        # paragraph and zone boundaries imply both break
                        # kinds (\3sentence + \3paragraph emitted together)
                        para_rows.append(rowid)
                        para_keys.append(key)
                        if kind == "zopen":
                            if zname not in zone_acc:
                                # zone matched via a trailing-star pattern
                                # (index_zones = z_*): record under the
                                # ACTUAL tag name so ZONE:z_1 resolves
                                if any(zname.startswith(z[:-1])
                                       for z in index_zones
                                       if z.endswith("*")):
                                    zone_acc.setdefault(zname, [])
                                else:
                                    continue
                            zstack.setdefault(zname, []).append(pos)
                        elif kind == "zclose":
                            opens = zstack.get(zname)
                            if opens:
                                op = opens.pop()
                                zone_acc[zname].append((
                                    rowid,
                                    fid << HITMAN_FIELD_SHIFT | op, key))
                    for zname, opens in zstack.items():
                        # unclosed zones run to the end of the field
                        for op in opens:
                            zone_acc[zname].append((
                                rowid, fid << HITMAN_FIELD_SHIFT | op,
                                fid << HITMAN_FIELD_SHIFT
                                | max(last_hit_pos, op)))
                    # field length = position of the LAST hit, magic
                    # included (m_pFieldLengthAttrs, sphinx.cpp:22415);
                    # trailing boundaries also steal the end-of-field flag
                    # from the last real token
                    field_lens[rowid, fid] = last_hit_pos
                    last_pos = last_hit_pos
                else:
                    tokens = self.tokenizer.tokenize(str(text))
                    field_lens[rowid, fid] = len(tokens)
                    last_pos = tokens[-1].position if tokens else 0
                ptoks: list[tuple[str, int]] = []
                for t in tokens:
                    first = None
                    for term in self.dictionary.process(t.text):
                        if first is None and not term.startswith("="):
                            first = term
                        tid = vocab.setdefault(term, len(vocab))
                        hits_tid.append(tid)
                        hits_row.append(rowid)
                        hits_packed.append(
                            hitman_pack(fid, t.position, t.position == last_pos)
                        )
                    if bigram_mode and first is not None:
                        ptoks.append((first, t.position))
                if bigram_mode:
                    # bigram_index: adjacent surviving terms emit an extra
                    # "w1 w2" term anchored at w1 (sphinx.cpp bigram
                    # indexing; space-joined pair tokens)
                    for (w1, p1), (w2, _p2) in zip(ptoks, ptoks[1:]):
                        if bigram_mode == "first_freq" and                                 w1 not in bigram_freq:
                            continue
                        if bigram_mode == "both_freq" and not (
                                w1 in bigram_freq and w2 in bigram_freq):
                            continue
                        tid = vocab.setdefault(f"{w1} {w2}", len(vocab))
                        hits_tid.append(tid)
                        hits_row.append(rowid)
                        hits_packed.append(hitman_pack(fid, p1, False))
            for a in schema.attrs:
                v = doc.get(a.name)
                if a.type in (AttrType.UINT, AttrType.BOOL, AttrType.TIMESTAMP):
                    attrs_int[a.name].append(int(v or 0) & 0xFFFFFFFF)
                elif a.type is AttrType.BIGINT:
                    attrs_big[a.name].append(int(v or 0))
                elif a.type is AttrType.FLOAT:
                    fv = float(v or 0.0)
                    # out-of-range values clamp to ±FLT_MAX (strtof
                    # saturation), not inf
                    fmax = 3.4028234663852886e38
                    if fv > fmax:
                        fv = fmax
                    elif fv < -fmax:
                        fv = -fmax
                    attrs_float[a.name].append(fv)
                elif a.type is AttrType.STRING:
                    attrs_str[a.name].append("" if v is None else str(v))
                elif a.type is AttrType.JSON:
                    # store the canonical output form (the reference
                    # keeps BSON and re-serializes: floats %f, compact)
                    from ..utils.jsonrender import render_json
                    attrs_json[a.name].append(
                        render_json(v) if isinstance(v, str) else v)
                elif a.type is AttrType.MVA:
                    # 32-bit MVA values are UNSIGNED (negatives wrap and
                    # sort after the positives, golden test_108) and the
                    # stored list is sorted-UNIQUE (golden test_224:
                    # inserting (1,1) stores "1")
                    attrs_mva[a.name].append(
                        sorted({(int(x) & 0xFFFFFFFF) for x in (v or [])}))
                elif a.type is AttrType.MVA64:
                    attrs_mva[a.name].append(
                        sorted({int(x) for x in (v or [])}))

        # re-map vocab ids to sorted-term order (deterministic; enables
        # wildcard expansion by prefix bisect, like the .spi sorted wordlist)
        term_strs = sorted(vocab)
        remap = np.zeros(len(vocab), dtype=np.int64)
        for new_id, s in enumerate(term_strs):
            remap[vocab[s]] = new_id

        tid_arr = remap[np.array(hits_tid, dtype=np.int64)] if hits_tid else np.zeros(0, np.int64)
        row_arr = np.array(hits_row, dtype=np.int64)
        pk_arr = np.array(hits_packed, dtype=np.int64)

        order = np.lexsort((pk_arr, row_arr, tid_arr))
        tid_arr, row_arr, pk_arr = tid_arr[order], row_arr[order], pk_arr[order]

        # hitless stats keep the REAL hit totals (dict entry counters are
        # written before positions are dropped)
        term_hits_real = np.bincount(
            tid_arr, minlength=len(term_strs)).astype(np.int32) \
            if len(tid_arr) else np.zeros(len(term_strs), np.int32)

        # posting boundaries: unique (tid, rowid)
        H = len(tid_arr)
        if H:
            new_post = np.empty(H, dtype=bool)
            new_post[0] = True
            new_post[1:] = (tid_arr[1:] != tid_arr[:-1]) | (row_arr[1:] != row_arr[:-1])
            post_starts = np.flatnonzero(new_post)
            P = len(post_starts)
            post_hit_offset = np.append(post_starts, H).astype(np.int32)
            post_rowid = row_arr[post_starts].astype(np.int32)
            post_tid = tid_arr[post_starts]
            post_tf = np.diff(post_hit_offset).astype(np.int32)
            fields_of_hits = (pk_arr >> HITMAN_FIELD_SHIFT).astype(np.int64) & 0xFF
            if len(schema.fields) > 32:
                # multi-word fieldmask planes [P, FW] (FieldMask_t is a
                # 256-bit vector in the reference, sphinx.h:108,833)
                FW = (len(schema.fields) + 31) >> 5
                planes = []
                for w2 in range(FW):
                    inw = (fields_of_hits >> 5) == w2
                    bits = np.where(
                        inw, 1 << (fields_of_hits & 31), 0).astype(np.int64)
                    planes.append(np.bitwise_or.reduceat(
                        bits, post_starts).astype(np.int64))
                post_fieldmask = np.stack(
                    [((p2 & 0xFFFFFFFF) - ((p2 >> 31) & 1) * (1 << 32)
                      ).astype(np.int32) for p2 in planes], axis=1)
            else:
                post_fieldmask = np.bitwise_or.reduceat(
                    (1 << fields_of_hits).astype(np.int64), post_starts
                ).astype(np.int32)
        else:
            P = 0
            post_hit_offset = np.zeros(1, dtype=np.int32)
            post_rowid = np.zeros(0, dtype=np.int32)
            post_tid = np.zeros(0, dtype=np.int64)
            post_tf = np.zeros(0, dtype=np.int32)
            post_fieldmask = (
                np.zeros((0, (len(schema.fields) + 31) >> 5), np.int32)
                if len(schema.fields) > 32 else np.zeros(0, np.int32))

        # hitless_words: drop positions — each hitless posting's hit list
        # becomes one synthetic hit per matched field at in-field pos -1
        # (LoadHitlessWords sphinx.cpp:9345 + ExtTermHitless emission);
        # tf/fieldmask/df keep the REAL values (doclist carries them)
        hl_all, hl_set = self._resolve_hitless(term_strs)
        if H and (hl_all or hl_set):
            hl_ids = np.array(sorted(
                i for i, s2 in enumerate(term_strs)
                if hl_all or s2 in hl_set), np.int64)
            post_is_hl = np.isin(post_tid, hl_ids)
            if post_is_hl.any():
                POSMAX = (1 << 23) - 1
                hit_is_hl = np.repeat(post_is_hl, post_tf)
                tids_h = post_tid[post_is_hl]
                rows_h = post_rowid[post_is_hl].astype(np.int64)
                fm_h = post_fieldmask[post_is_hl].astype(np.int64)
                s_tid, s_row, s_pk = [], [], []
                for fb in range(32):
                    sel = ((fm_h >> fb) & 1).astype(bool)
                    if not sel.any():
                        continue
                    s_tid.append(tids_h[sel])
                    s_row.append(rows_h[sel])
                    s_pk.append(np.full(
                        int(sel.sum()),
                        (fb << HITMAN_FIELD_SHIFT) | POSMAX, np.int64))
                tid_arr = np.concatenate([tid_arr[~hit_is_hl]] + s_tid)
                row_arr = np.concatenate([row_arr[~hit_is_hl]] + s_row)
                pk_arr = np.concatenate([pk_arr[~hit_is_hl]] + s_pk)
                order2 = np.lexsort((pk_arr, row_arr, tid_arr))
                tid_arr = tid_arr[order2]
                row_arr = row_arr[order2]
                pk_arr = pk_arr[order2]
                H = len(tid_arr)
                # every posting keeps >=1 (synthetic) hit, so the
                # (tid,row) boundary SET is unchanged — tf/fieldmask
                # stay aligned; only the hit offsets move
                new_post2 = np.empty(H, dtype=bool)
                new_post2[0] = True
                new_post2[1:] = ((tid_arr[1:] != tid_arr[:-1])
                                 | (row_arr[1:] != row_arr[:-1]))
                post_starts2 = np.flatnonzero(new_post2)
                assert len(post_starts2) == P
                post_hit_offset = np.append(post_starts2, H).astype(
                    np.int32)

        T = len(term_strs)
        term_offsets = np.searchsorted(post_tid, np.arange(T + 1)).astype(np.int32)
        term_docs = np.diff(term_offsets).astype(np.int32)
        term_hits = term_hits_real

        post_tfq = (
            post_tf.astype(np.float32)
            / (post_tf.astype(np.float32) + np.float32(SPH_BM25_K1))
        ).astype(np.float32)

        sp_kwargs = {}
        if hl_all or hl_set:
            sp_kwargs["hitless_terms"] = frozenset(hl_set)
            sp_kwargs["hitless_all"] = hl_all
        if index_sp:
            sp_kwargs = dict(
                sent_rowid=np.asarray(sent_rows, np.int32),
                sent_pkey=np.asarray(sent_keys, np.int32),
                para_rowid=np.asarray(para_rows, np.int32),
                para_pkey=np.asarray(para_keys, np.int32),
            )
        if index_zones:
            zones_out = {}
            for zname, spans in zone_acc.items():
                spans.sort()
                zones_out[zname] = (
                    np.asarray([s[0] for s in spans], np.int32),
                    np.asarray([s[1] for s in spans], np.int32),
                    np.asarray([s[2] for s in spans], np.int32),
                )
            sp_kwargs["zones"] = zones_out
        return PackedIndex(
            schema=schema,
            n_docs=n,
            doc_ids=doc_ids,
            **sp_kwargs,
            term_strs=term_strs,
            term_offsets=term_offsets,
            term_docs=term_docs,
            term_hits=term_hits,
            post_rowid=post_rowid,
            post_tf=post_tf,
            post_tfq=post_tfq,
            post_fieldmask=post_fieldmask,
            post_hit_offset=post_hit_offset,
            hit_packed=pk_arr.astype(np.int32),
            attrs_int={k: np.array(v, dtype=np.int64).astype(np.int32) for k, v in attrs_int.items()},
            attrs_big={k: np.array(v, dtype=np.int64) for k, v in attrs_big.items()},
            attrs_float={k: np.array(v, dtype=np.float32) for k, v in attrs_float.items()},
            attrs_str=attrs_str,
            attrs_json=attrs_json,
            attrs_mva={
                k: _pack_mva(v) for k, v in attrs_mva.items()
            },
            stored_fields=stored_fields,
            field_lens=field_lens,
            total_hits=H,
            tokenizer_settings=self.tok_settings,
            dict_settings=self.dict_settings,
        )


def _pack_mva(lists: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
    offsets = np.zeros(len(lists) + 1, dtype=np.int32)
    for i, l in enumerate(lists):
        offsets[i + 1] = offsets[i] + len(l)
    values = np.array(
        [x for l in lists for x in l], dtype=np.int64
    )
    return offsets, values


def build_from_pretokenized(
    schema: Schema,
    doc_ids: np.ndarray,
    doc_terms: "np.ndarray",
    doc_offsets: np.ndarray,
    attrs: dict[str, np.ndarray] | None = None,
    vocab: list[str] | None = None,
) -> PackedIndex:
    """Fast path for benchmarks: documents given as term-id sequences.

    doc_terms[doc_offsets[i]:doc_offsets[i+1]] are the term ids of doc i,
    single field, positions 1..len. Term ids must refer to `vocab` (sorted) or
    a synthetic vocab is generated. Host cost is O(hits) numpy work.
    """
    n = len(doc_ids)
    order = np.argsort(doc_ids, kind="stable")
    doc_ids_sorted = np.asarray(doc_ids, dtype=np.int64)[order]

    counts = np.diff(doc_offsets)
    row_of_hit = np.repeat(np.arange(n), counts[order] if False else counts)
    # remap docs into sorted-docid rowids
    rowmap = np.empty(n, dtype=np.int64)
    rowmap[order] = np.arange(n)
    row_arr = rowmap[row_of_hit]
    tid_arr = np.asarray(doc_terms, dtype=np.int64)
    pos_within = np.arange(len(tid_arr)) - np.repeat(doc_offsets[:-1], counts) + 1
    end_flag = np.zeros(len(tid_arr), dtype=np.int64)
    if len(tid_arr):
        last_idx = np.asarray(doc_offsets[1:], dtype=np.int64) - 1
        last_idx = last_idx[counts > 0]
        end_flag[last_idx] = 1
    pk_arr = (end_flag << 23) | pos_within.astype(np.int64)

    sort_o = np.lexsort((pk_arr, row_arr, tid_arr))
    tid_arr, row_arr, pk_arr = tid_arr[sort_o], row_arr[sort_o], pk_arr[sort_o]

    H = len(tid_arr)
    T = int(tid_arr.max()) + 1 if H else 0
    if vocab is None:
        width = len(str(max(T - 1, 0)))
        vocab = [f"t{str(i).zfill(width)}" for i in range(T)]
    else:
        T = len(vocab)

    new_post = np.empty(H, dtype=bool)
    if H:
        new_post[0] = True
        new_post[1:] = (tid_arr[1:] != tid_arr[:-1]) | (row_arr[1:] != row_arr[:-1])
        post_starts = np.flatnonzero(new_post)
        post_hit_offset = np.append(post_starts, H).astype(np.int32)
        post_rowid = row_arr[post_starts].astype(np.int32)
        post_tid = tid_arr[post_starts]
        post_tf = np.diff(post_hit_offset).astype(np.int32)
        post_fieldmask = np.ones(len(post_starts), dtype=np.int32)
    else:
        post_hit_offset = np.zeros(1, dtype=np.int32)
        post_rowid = np.zeros(0, np.int32)
        post_tid = np.zeros(0, np.int64)
        post_tf = np.zeros(0, np.int32)
        post_fieldmask = np.zeros(0, np.int32)

    term_offsets = np.searchsorted(post_tid, np.arange(T + 1)).astype(np.int32)
    term_docs = np.diff(term_offsets).astype(np.int32)
    term_hits = np.bincount(tid_arr, minlength=T).astype(np.int32) if H else np.zeros(T, np.int32)
    post_tfq = (post_tf / (post_tf + np.float32(SPH_BM25_K1))).astype(np.float32)

    field_lens = np.zeros((n, 1), dtype=np.int32)
    if n:
        # counts is in original doc order; rowid r holds original doc order[r]
        field_lens[:, 0] = counts[order]

    a_int, a_big, a_float = {}, {}, {}
    for name, arr in (attrs or {}).items():
        arr = np.asarray(arr)[order]
        ad = schema.attr(name)
        if ad is None:
            raise ValueError(f"unknown attr {name}")
        if ad.type is AttrType.FLOAT:
            a_float[name] = arr.astype(np.float32)
        elif ad.type is AttrType.BIGINT:
            a_big[name] = arr.astype(np.int64)
        else:
            a_int[name] = arr.astype(np.int32)

    return PackedIndex(
        schema=schema,
        n_docs=n,
        doc_ids=doc_ids_sorted,
        term_strs=list(vocab),
        term_offsets=term_offsets,
        term_docs=term_docs,
        term_hits=term_hits,
        post_rowid=post_rowid,
        post_tf=post_tf,
        post_tfq=post_tfq,
        post_fieldmask=post_fieldmask,
        post_hit_offset=post_hit_offset,
        hit_packed=pk_arr.astype(np.int32),
        attrs_int=a_int,
        attrs_big=a_big,
        attrs_float=a_float,
        attrs_str={},
        attrs_json={},
        attrs_mva={},
        stored_fields={},
        field_lens=field_lens,
        total_hits=H,
    )
