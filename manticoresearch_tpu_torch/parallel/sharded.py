"""Distributed-index search: shards in parts, one part per device.

Counterpart of ``manticoresearch_tpu/parallel/sharded.py``, with the same
structure and names. Behavioral model: the reference's distributed index +
agent fan-out (DistributedIndex_t, searchdha.h:679; RunSubset
scatter-gather, searchd.cpp:6550-6860; per-agent merged chunks
searchd.cpp:6737) and the global-IDF aggregation (SetupLocalDF,
searchd.cpp:5869).

The mesh is a list of devices (``make_mesh``: the host's cards). Each of
its positions holds a *part*: a contiguous run of ``len(shards) /
len(devices)`` shards, the leading dimension of every tensor of that
part's upload (``_stack``). The JAX package's layout is one shard per
position; ``device=...`` alone is one part holding every shard. The
shards are laid out as the JAX package lays them out: every shard at the
union's common row count ``N = max(n_docs)``, rows past its own documents
dead (``alive`` false, docid 2^63-1), every posting, hit and class array
padded by the union's largest slot bucket, each shard's packed store built
with the union's pack decision and width classes. So one plan's per-shard
program (``ops.search.build_kernel`` at the plan's common slot buckets)
runs on every shard of every part, on the JAX package's shapes. One
process and one host thread drive every device, as one JAX controller
drives every chip of a mesh.

``search_batch`` plans each query against the union dictionary (df summed
over the shards: global IDF), decodes every packed window of a part's
shards for every query in one ``decode_lists`` call (one launch of the
bit-plane kernel per part, on the part's device), runs the per-shard
program shard by shard and query by query on each shard's device, then
JAX's per-shard prelude on each part's device (docid halves, the
attribute sort key; ``_prelude``), copies each part's top-k chunks to the
first device and sums the match counts there (JAX's ``all_gather`` and
``psum``), and merges there as ``lax.sort`` does: weight desc, then docid
asc, or the attribute key, then docid asc (``_merge``). The whole batch's
output is one tensor, fetched once. Grouped, string- or JSON-filtered,
ZONE-limited and multi-key-ordered queries take the fallback, as in the
JAX package: per-shard ``SearchIndex`` searches (each on its shard's
device) with the union's term statistics, merged on the host
(``exec.multi``).
"""
from __future__ import annotations

import bisect
import math
import subprocess
import time
from dataclasses import replace

import numpy as np
import torch

from ..exec.searcher import (Match, SearchIndex, SearchResult, WordStat,
                             _resolve_order)
from ..index.builder import PackedIndex
from ..ops.packed_store import (BLOCK, CLASSES, PACK_MIN, PLANE_WORDS,
                                build_store, decode_lists)
from ..ops.search import (INT32_MAX, INT32_MIN, _float_order_key,
                          build_kernel, packed_windows)
from ..query.ftparser import FtQueryParser
from ..query.planner import CompiledQuery, _next_pow4, plan_query
from ..schema import Schema
from ..text.dictionary import Dictionary
from ..text.tokenizer import Tokenizer
from ..utils import trace


class _UnionView:
    """A virtual 'index' exposing the union dictionary of all shards —
    used by the planner for AST lowering, wildcard expansion and global IDF
    (df summed across shards = SetupLocalDF semantics)."""

    def __init__(self, shards: list[PackedIndex]):
        self.schema = shards[0].schema
        self.n_docs = sum(s.n_docs for s in shards)
        union: dict[str, tuple[int, int]] = {}
        for s in shards:
            for t, df, th in zip(s.term_strs, s.term_docs.tolist(),
                                 s.term_hits.tolist()):
                d0, h0 = union.get(t, (0, 0))
                union[t] = (d0 + df, h0 + th)
        self.term_strs = sorted(union)
        self.term_docs = np.array(
            [union[t][0] for t in self.term_strs], np.int32
        ) if self.term_strs else np.zeros(0, np.int32)
        self.term_hits = np.array(
            [union[t][1] for t in self.term_strs], np.int32
        ) if self.term_strs else np.zeros(0, np.int32)
        T = len(self.term_strs)
        self.term_offsets = np.zeros(T + 1, np.int32)
        self.post_hit_offset = np.zeros(1, np.int32)
        self.hit_packed = np.zeros(0, np.int32)
        fls = [s.field_lens for s in shards if s.field_lens.size]
        self.field_lens = (np.concatenate(fls) if fls
                           else np.zeros((0, 1), np.int32))
        self.attrs_mva = {}

    def term_id(self, term: str) -> int:
        i = bisect.bisect_left(self.term_strs, term)
        if i < len(self.term_strs) and self.term_strs[i] == term:
            return i
        return -1


def _pad_to(arr: np.ndarray, size: int, value) -> np.ndarray:
    if len(arr) >= size:
        return arr
    pad = np.full(size - len(arr), value, dtype=arr.dtype)
    return np.concatenate([arr, pad])


def _merge_order(first: torch.Tensor, hi: torch.Tensor,
                 lo: torch.Tensor) -> torch.Tensor:
    """Per row of [B, M] int32 keys, the permutation of ``lax.sort((first,
    hi, lo, ...), num_keys=3)``: stable, ascending. The key takes 96 bits,
    so two stable sorts chain, the docid (hi, biased lo) as one int64
    first, then ``first``."""
    docid = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + 2**31)
    o1 = torch.sort(docid, dim=1, stable=True).indices
    o2 = torch.sort(first.gather(1, o1), dim=1, stable=True).indices
    return o1.gather(1, o2)


def make_mesh(n_shards: int | None = None) -> list[torch.device]:
    """The host's first ``n_shards`` cards (every visible card when None),
    one mesh position each: ``[cuda:0, ..., cuda:n-1]``. Raises where fewer
    cards are visible than asked; never falls back to one card or the
    CPU."""
    visible = torch.cuda.device_count()
    n = visible if n_shards is None else n_shards
    if n < 1 or n > visible:
        raise ValueError(f"a mesh of {n} cards asked for, {visible} visible")
    return [torch.device("cuda", i) for i in range(n)]


def cards(devices: list) -> list[torch.device]:
    """The distinct cards among ``devices``, each with its index."""
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda":
            d = torch.device("cuda", torch.cuda.current_device()
                             if d.index is None else d.index)
            if d not in out:
                out.append(d)
    return out


def sync(devices: list) -> None:
    """Wait for every card among ``devices``."""
    for d in cards(devices):
        torch.cuda.synchronize(d)


def smi_cards() -> list[str]:
    """``nvidia-smi``'s name and power limit of every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()


class ShardedIndex:
    """A distributed index: documents partitioned over shards, the shards
    in parts, part p on ``devices[p]`` (the mesh; repeats allowed). With
    ``devices`` None, one part on ``device`` (the card unless the caller
    asks for "cpu") holds every shard. Give one of the two, not both."""

    def __init__(self, shards: list[PackedIndex], device=None,
                 devices=None):
        if not shards:
            raise ValueError("need at least one shard")
        if device is not None and devices is not None:
            raise ValueError("give device or devices, not both")
        self.devices = [torch.device(d)
                        for d in (devices if devices is not None
                                  else [device or "cuda"])]
        if not self.devices or len(shards) % len(self.devices):
            raise ValueError(f"{len(shards)} shards for "
                             f"{len(self.devices)} mesh devices")
        self.shards = shards
        # the merge runs, and the batch's output lands, on the first
        self.device = self.devices[0]
        self.per_part = len(shards) // len(self.devices)
        self.union = _UnionView(shards)
        self.schema: Schema = shards[0].schema
        self.tokenizer = Tokenizer(shards[0].tokenizer_settings)
        self.dictionary = Dictionary(shards[0].dict_settings)
        self.parser = FtQueryParser(
            self.tokenizer, self.dictionary, self.schema.fields)
        self._stack()

    # ------------------------------------------------------------------
    def _stack(self) -> None:
        """Lay every shard out as one row of [D, ...] arrays (the JAX
        package's layout) and upload rows ``p * per_part`` on as
        ``parts[p]`` to ``devices[p]``; ``_views[d]`` is shard d's data
        dict of views into its part, under the keys the search program
        reads."""
        shards = self.shards
        D = len(shards)
        N = max(s.n_docs for s in shards)
        self.n_common = N

        max_df = max((int(s2.term_docs.max()) for s2 in shards
                      if s2.n_terms), default=0)
        # padding must match the planner's pow4 slot buckets (they can
        # round above the next pow2)
        pad_p = _next_pow4(max_df, 1024)
        max_th = 0
        for s2 in shards:
            if s2.n_terms:
                pth = (s2.post_hit_offset[s2.term_offsets[1:]]
                       - s2.post_hit_offset[s2.term_offsets[:-1]])
                if len(pth):
                    max_th = max(max_th, int(pth.max()))
        pad_h = _next_pow4(max_th, 1024)
        Hmax = max(max(len(s.hit_packed) for s in shards), 1) + pad_h

        hitp = np.zeros((D, Hmax), np.int32)
        hitr = np.full((D, Hmax), N, np.int32)
        alive = np.zeros((D, N + 1), bool)
        Fn = max(self.schema.n_fields, 1)
        flens = np.zeros((D, N + 1, Fn), np.int32)
        dhi = np.zeros((D, N + 1), np.int32)
        dlo = np.zeros((D, N + 1), np.int32)
        for i, s in enumerate(shards):
            h = len(s.hit_packed)
            hitp[i, :h] = s.hit_packed
            hitr[i, :h] = np.repeat(s.post_rowid, s.post_tf)
            alive[i, : s.n_docs] = True
            if s.field_lens.size:
                flens[i, : s.n_docs, : s.field_lens.shape[1]] = s.field_lens
            did = np.append(s.doc_ids,
                            np.full(N - s.n_docs + 1,
                                    2**63 - 1)).astype(np.uint64)
            dhi[i] = (did >> np.uint64(32)).astype(np.int64) \
                .astype(np.int32)
            dlo[i] = ((did & np.uint64(0xFFFFFFFF)).astype(np.int64)
                      - 2**31).astype(np.int32)

        attrs = {}
        for a in self.schema.attrs:
            if not a.type.is_numeric_device:
                continue
            dt = np.float32 if a.type.value == "float" else np.int32
            col = np.zeros((D, N), dt)
            for i, s in enumerate(shards):
                src = (s.attrs_int.get(a.name) if a.name in s.attrs_int
                       else s.attrs_float.get(a.name)
                       if a.name in s.attrs_float
                       else s.attrs_big.get(a.name))
                if src is not None:
                    col[i, : len(src)] = np.clip(
                        src, -(2**31), 2**31 - 1
                    ).astype(dt) if dt == np.int32 else src.astype(dt)
            attrs[a.name] = col

        SBmax = max(max((len(s2.sent_rowid) for s2 in shards), default=0), 1)
        PBmax = max(max((len(s2.para_rowid) for s2 in shards), default=0), 1)
        sbr = np.full((D, SBmax), 2**31 - 1, np.int32)
        sbk = np.full((D, SBmax), 2**31 - 1, np.int32)
        pbr = np.full((D, PBmax), 2**31 - 1, np.int32)
        pbk = np.full((D, PBmax), 2**31 - 1, np.int32)
        for i, s in enumerate(shards):
            sbr[i, : len(s.sent_rowid)] = s.sent_rowid
            sbk[i, : len(s.sent_pkey)] = s.sent_pkey
            pbr[i, : len(s.para_rowid)] = s.para_rowid
            pbk[i, : len(s.para_pkey)] = s.para_pkey

        data = {
            "hit_packed": hitp, "hit_rowid": hitr, "alive": alive,
            "field_lens": flens,
            "sent_rowid": sbr, "sent_pkey": sbk,
            "para_rowid": pbr, "para_pkey": pbk,
            "docid_hi": dhi, "docid_lo": dlo,
        }

        # ---- packed posting store with GLOBAL width classes ------------
        # Each shard packs with the UNION's pack decision and the
        # elementwise-max width classes across shards, so one plan's
        # static slot_packed shapes hold on every shard.
        u = self.union
        u_arr = np.array(u.term_strs) if u.term_strs else np.zeros(0, str)
        union_sel = (u.term_docs.astype(np.int64) >= PACK_MIN
                     if len(u.term_strs) else np.zeros(0, bool))
        shard_pos = []
        for s in shards:
            pos = (np.searchsorted(u_arr, np.array(s.term_strs))
                   if s.n_terms else np.zeros(0, np.int64))
            shard_pos.append(pos)
        u_cls = np.zeros((len(u.term_strs), 3), np.int8)
        for s, pos in zip(shards, shard_pos):
            if not s.n_terms:
                continue
            _, cls = build_store(
                s.term_docs, s.term_offsets, s.post_rowid, s.post_tf,
                s.post_tfq, s.post_fieldmask,
                force_packed=union_sel[pos], classes_only=True)
            np.maximum.at(u_cls, pos, cls)
        self._stores = []
        for s, pos in zip(shards, shard_pos):
            self._stores.append(build_store(
                s.term_docs, s.term_offsets, s.post_rowid, s.post_tf,
                s.post_tfq, s.post_fieldmask,
                force_packed=(union_sel[pos] if s.n_terms
                              else np.zeros(0, bool)),
                force_class=(u_cls[pos] if s.n_terms
                             else np.zeros((0, 3), np.int8))))
        # union-term class values (1-based like PackedStore.term_class)
        self._u_cls = np.where(union_sel[:, None], u_cls + 1,
                               0).astype(np.int8) \
            if len(u.term_strs) else np.zeros((0, 3), np.int8)

        # windows never run short: every class/residual array is
        # over-padded by the largest possible slot bucket (the
        # single-index upload does the same; see ops/device_index.py)
        pad_blocks = pad_p // BLOCK + 1
        for c in CLASSES:
            nbm = max(max((st.rw_words[c].shape[0]
                           for st in self._stores), default=0), 1) \
                + pad_blocks
            for kind, attr_name in (("pkrw_w", "rw_words"),
                                    ("pktf_w", "tf_words"),
                                    ("pkfm_w", "fm_words")):
                nk = max(max((getattr(st, attr_name)[c].shape[0]
                              for st in self._stores), default=0), 1) \
                    + pad_blocks
                arr = np.zeros((D, nk, PLANE_WORDS * c), np.uint32)
                for i, st in enumerate(self._stores):
                    w = getattr(st, attr_name)[c]
                    arr[i, : w.shape[0]] = w
                data[f"{kind}_{c}"] = arr.view(np.int32)
            bs = np.zeros((D, nbm), np.int32)
            for i, st in enumerate(self._stores):
                b = st.rw_base[c]
                bs[i, : len(b)] = b
            data[f"pkrw_b_{c}"] = bs
        Rmax = max(max((len(st.res_rowid) for st in self._stores),
                       default=0), 1) + pad_p
        res_r = np.full((D, Rmax), N, np.int32)
        res_q = np.zeros((D, Rmax), np.float32)
        res_f = np.zeros((D, Rmax), np.int32)
        for i, st in enumerate(self._stores):
            r = len(st.res_rowid)
            res_r[i, :r] = st.res_rowid
            res_q[i, :r] = st.res_tfq
            res_f[i, :r] = st.res_fieldmask
        data["res_rowid"] = res_r
        data["res_tfq"] = res_q
        data["res_fieldmask"] = res_f

        spp = self.per_part

        def put(a: np.ndarray, p: int) -> torch.Tensor:
            return torch.from_numpy(a[p * spp:(p + 1) * spp]).to(
                self.devices[p])

        self.parts = [{**{k: put(v, p) for k, v in data.items()},
                       "attrs": {k: put(v, p) for k, v in attrs.items()}}
                      for p in range(len(self.devices))]

        def view(d: int) -> dict:
            part, j = self.parts[d // spp], d % spp
            return {**{k: v[j] for k, v in part.items() if k != "attrs"},
                    "attrs": {k: v[j] for k, v in part["attrs"].items()},
                    "mva_offsets": {}, "mva_values": {}}
        self._views = [view(d) for d in range(D)]

    # ------------------------------------------------------------------
    def _merge_k(self, sig) -> tuple[int, int]:
        """(k_local, k): per-shard chunk size and merged-result size."""
        k_local = max(1, min(sig.k, self.n_common))
        return k_local, min(sig.k, len(self.shards) * k_local)

    def _prelude(self, p: int, order: tuple, rid: torch.Tensor,
                 w: torch.Tensor, found: torch.Tensor) -> tuple:
        """JAX's per-shard prelude, on part p's device, for the part's
        top-k chunks (rid, w: [B, S, k_local], found: [B, S], S =
        ``per_part``): -> (first, hi, lo, w, rid, found), ``first`` the
        merge's leading sort key, hi / lo the docid halves."""
        B, S, kl = rid.shape
        dev = rid.device
        part = self.parts[p]
        shard = torch.arange(S, device=dev).view(1, S, 1)
        r64 = rid.to(torch.int64)
        hi = part["docid_hi"][shard, r64]
        lo = part["docid_lo"][shard, r64]
        if order[0] == "attr":
            # attr-ordered merge: the sort key (numeric attr value) rides
            # the gather; ties break (docid asc) like the reference sorter
            # comparators (sphinxsort.cpp)
            _, name, asc, is_float = order
            col = part["attrs"][name]
            keyv = col[shard, r64.clamp(0, col.shape[1] - 1)]
            # entries past the shard's own match count are garbage rows
            # (the attr-ordered kernel fills the chunk): they must sort
            # last in the merge
            valid = (torch.arange(kl, device=dev).view(1, 1, kl)
                     < found.view(B, S, 1))
            if is_float:
                # lax.sort's float order: -0.0 == +0.0, NaN after +inf
                first = _float_order_key(torch.where(
                    valid, keyv if asc else -keyv, float("inf")))
            else:
                first = torch.where(valid, keyv if asc else ~keyv,
                                    INT32_MAX)
        else:
            # merged order: weight desc, docid asc
            first = ~w
        return first, hi, lo, w, rid, found

    def _merge(self, chunks: list[tuple], k: int) -> torch.Tensor:
        """Gather the parts' ``_prelude`` chunks on the first device (JAX's
        ``all_gather``; ``found`` summed there, its ``psum``) and merge the
        per-shard top-k chunks into the batched layout [B, 5k+1] = weight[k]
        ++ docid_hi[k] ++ docid_lo[k] ++ rowid[k] ++ shard[k] ++ found (one
        pre-merged chunk per shard, as agents return one chunk each,
        searchd.cpp:6737; merge = MinimizeAggrResult semantics,
        searchd.cpp:4816,3990)."""
        def gather(j: int) -> torch.Tensor:
            if len(chunks) == 1:     # one part: nothing to copy or join
                return chunks[0][j]
            return torch.cat([c[j].to(self.device, non_blocking=True)
                              for c in chunks], dim=1)
        first, hi, lo, w, rid, found = (gather(j) for j in range(6))
        B, D, kl = rid.shape
        shard = torch.arange(D, device=rid.device).view(1, D, 1)
        cols = [w, hi, lo, rid, shard.expand(B, D, kl).to(torch.int32)]
        cols = [c.reshape(B, D * kl) for c in cols]
        perm = _merge_order(first.reshape(B, D * kl), cols[1], cols[2])
        top = [c.gather(1, perm)[:, :k].to(torch.int32) for c in cols]
        total = found.sum(dim=1, dtype=torch.int32).view(B, 1)
        return torch.cat(top + [total], dim=1)

    # ------------------------------------------------------------------
    def _per_shard_indexes(self):
        """Lazy per-shard SearchIndex list (a second upload of every shard,
        each on its part's device; built on demand for the queries whose
        merge runs host-side)."""
        if not hasattr(self, "_shard_idx"):
            self._shard_idx = [SearchIndex(p, self.devices[d // self.per_part])
                               for d, p in enumerate(self.shards)]
        return self._shard_idx

    def global_stats(self):
        """Union total_docs + per-term df across shards (SetupLocalDF,
        searchd.cpp:5869). Cached — shards are immutable."""
        if not hasattr(self, "_gstats"):
            total = sum(p.n_docs for p in self.shards)
            df: dict = {}
            for p in self.shards:
                for t, d in zip(p.term_strs, p.term_docs.tolist()):
                    df[t] = df.get(t, 0) + d
            self._gstats = (total, df)
        return self._gstats

    def _per_shard_search(self, q):
        from ..exec.multi import _search_with_stats, merge_part_results
        total_docs, df = self.global_stats()
        part_q = replace(q, offset=0, limit=q.offset + q.limit, select=None)
        kw = dict(total_docs_override=total_docs, local_df=df)
        results = [_search_with_stats(p, part_q, kw)
                   for p in self._per_shard_indexes()]
        return merge_part_results(results, q, self.schema)

    def plan(self, q) -> CompiledQuery:
        with trace.span("plan"):
            with trace.span("parse"):
                ast = self.parser.parse(q.match)
            with trace.span("plan_query"):
                try:
                    order = _resolve_order(q, self.schema)
                except ValueError:
                    order = ("rel",)
                if order[0] not in ("rel", "attr"):
                    order = ("rel",)
                return plan_query(
                    ast, self.union,
                    filters=q.filters, ranker=q.ranker,
                    max_matches=q.max_matches, filter_tree=q.filter_tree,
                    order=order, field_weights=q.field_weights,
                    idf_plain=q.idf_plain,
                    tfidf_normalized=q.tfidf_normalized,
                    packed_store=self._union_store(),
                )

    def _union_store(self):
        """Union-term pseudo PackedStore: carries the GLOBAL width classes
        so the plan's slot_packed matches every shard's layout; the
        per-shard starts are filled into the runtime at dispatch."""
        if not hasattr(self, "_ustore"):
            T = len(self.union.term_strs)

            class _U:
                term_class = self._u_cls
                term_start = np.zeros((T, 3), np.int32)
                res_offsets = np.zeros(T + 1, np.int32)
            self._ustore = _U()
        return self._ustore

    def search(self, q):
        return self.search_batch([q])[0]

    def _prep(self, q):
        """Classify + lower one query for the merged path.
        Returns ("fallback", None) when the query needs per-shard searches
        with a host merge, ("error", msg) on plan errors, or
        ("ok", (cq, rt_shard, rt_repl, slot_pb, slot_hb, n_hit_iters))
        with host runtime arrays — rt_shard leaves are (D, ...), rt_repl
        leaves are per-query."""
        if getattr(q, "group_by", None):
            return "fallback", None

        def _host_merge_filter(f) -> bool:
            # string ordinals and JSON columns are per-shard structures;
            # such filters run on per-shard searches + host merge
            if "." in f.attr:
                return True
            ad = self.schema.attr(f.attr)
            return ad is not None and ad.type.value in ("string", "json")

        def _merged_sortable() -> bool:
            sort = q.sort or [("weight", False)]
            primary = sort[0][0]
            if primary in ("weight", "@weight", "weight()"):
                return True
            ad = self.schema.attr(primary)
            if ad is None or ad.type.value not in (
                    "uint", "bool", "timestamp", "float", "bigint"):
                return False
            # secondary keys beyond the implicit docid tiebreak need the
            # host merge
            rest = [c for c, _a in sort[1:] if c not in ("id", "@id")]
            return not rest

        if (any(_host_merge_filter(f) for f in (q.filters or []))
                or not _merged_sortable()):
            # per-shard searches + host merge, with GLOBAL term stats so
            # weights match the merged path (SetupLocalDF)
            return "fallback", None
        try:
            cq = self.plan(q)
        except (ValueError, NotImplementedError) as e:
            return "error", str(e)

        if any(e[4] for e in cq.sig.slot_limited):
            # ZONE-limited slots: zone span arrays are per-shard (ragged),
            # so run per-shard searches + host merge
            return "fallback", None

        S = max(cq.sig.n_slots, 1)
        D = len(self.shards)
        starts = np.zeros((D, S), np.int32)
        lengths = np.zeros((D, S), np.int32)
        hstarts = np.zeros((D, S), np.int32)
        hlengths = np.zeros((D, S), np.int32)
        pk_starts = np.zeros((D, S, 3), np.int32)
        slot_packed = tuple(getattr(cq.sig, "slot_packed", ()) or ())
        for d, sh in enumerate(self.shards):
            store_d = self._stores[d]
            for s, term in enumerate(cq.slot_terms):
                tid = sh.term_id(term)
                if tid < 0:
                    continue
                t0_, t1_ = int(sh.term_offsets[tid]), int(sh.term_offsets[tid + 1])
                hs = int(sh.post_hit_offset[t0_]) if t1_ > t0_ else 0
                he = int(sh.post_hit_offset[t1_]) if t1_ > t0_ else 0
                hstarts[d, s] = hs
                hlengths[d, s] = he - hs
                lengths[d, s] = t1_ - t0_
                if slot_packed and slot_packed[s][0]:
                    pk_starts[d, s] = store_d.term_start[tid]
                    starts[d, s] = 0
                else:
                    starts[d, s] = (int(store_d.res_offsets[tid])
                                    if slot_packed else t0_)

        # per-slot buckets must be COMMON across shards (one program):
        # the bucket of the max per-shard size
        Sreal = cq.sig.n_slots
        slot_pb = tuple(_next_pow4(int(lengths[:, s].max()), 1024)
                        for s in range(Sreal))
        slot_hb = tuple(_next_pow4(int(hlengths[:, s].max()), 1024)
                        for s in range(Sreal))
        Hmax = int(self.parts[0]["hit_packed"].shape[1])
        n_hit_iters = max(1, math.ceil(math.log2(max(Hmax, 2)))) + 1

        rt_shard = {
            "starts": starts, "lengths": lengths,
            "hit_starts": hstarts, "hit_lengths": hlengths,
        }
        if slot_packed:
            rt_shard["pk_starts"] = pk_starts
        rt_repl = {
            "idf": cq.runtime["idf"], "mult": cq.runtime["mult"],
            "qpos": cq.runtime["qpos"],
            "field_weights": cq.runtime["field_weights"],
            "filter_vals": cq.runtime["filter_vals"],
            "total_field_lens": cq.runtime["total_field_lens"],
            "total_docs": cq.runtime["total_docs"],
            "avg_doc_len": cq.runtime["avg_doc_len"],
        }
        # replicated small arrays the program may read depending on the
        # plan (dupe folding, payload merge-group idf)
        for k in ("qpos_fold", "slot_fold", "gidf"):
            if k in cq.runtime:
                rt_repl[k] = cq.runtime[k]
        return "ok", (cq, rt_shard, rt_repl, slot_pb, slot_hb, n_hit_iters)

    def search_batch(self, queries):
        """Batched distributed execution: per part, one grouped decode of
        every packed window of its shards and every query (one bit-plane
        launch on the part's device); the per-shard program per shard and
        query, plan shape by plan shape; the prelude on each part's device,
        the gather and the merge on the first device; one fetch of every
        output row (the agent fan-out of every query in one round). The
        batch is one request of the trace (``utils.trace``)."""
        with trace.request(len(queries)):
            t0 = time.perf_counter()
            results: list = [None] * len(queries)
            bundles: dict[int, tuple] = {}
            groups: dict[tuple, list[int]] = {}
            for i, q in enumerate(queries):
                with trace.span("prep"):
                    st, val = self._prep(q)
                if st == "error":
                    results[i] = SearchResult([], 0, 0, 0.0, [], error=val)
                elif st == "fallback":
                    results[i] = self._fallback_search(q)
                else:
                    bundles[i] = val
                    cq = val[0]
                    groups.setdefault((cq.sig, val[3], val[4], val[5]),
                                      []).append(i)
            if not groups:
                return results
            D, spp = len(self.shards), self.per_part
            part_shards = [range(p * spp, (p + 1) * spp)
                           for p in range(len(self.parts))]
            # per query and shard, the runtime the per-shard program reads
            rts = {i: [{**{k: v[d] for k, v in b[1].items()}, **b[2]}
                       for d in range(D)] for i, b in bundles.items()}
            decoded = {}
            for ds in part_shards:
                order = [(i, d) for idxs in groups.values() for i in idxs
                         for d in ds]
                with trace.span("decode"):
                    decoded.update(zip(order, decode_lists([
                        packed_windows(bundles[i][0].sig, bundles[i][3],
                                       self._views[d], rts[i][d])
                        for i, d in order])))
            N = self.n_common
            F = max(self.schema.n_fields, 1)
            outs = []
            for (sig, pb, hb, nhi), idxs in groups.items():
                k_local, k = self._merge_k(sig)
                kern = build_kernel(replace(sig, k=k_local), N, F, pb, hb, nhi)
                chunks = []
                for p, ds in enumerate(part_shards):
                    with trace.span("program"):
                        per = [[kern(self._views[d], rts[i][d], decoded[i, d])
                                for d in ds] for i in idxs]
                        rid, w, found = (
                            torch.stack([torch.stack([o[name] for o in row])
                                         for row in per])
                            for name in ("rowid", "weight", "found"))
                    with trace.span("prelude"):
                        chunks.append(self._prelude(p, sig.order, rid, w,
                                                    found))
                with trace.span("merge"):
                    outs.append((idxs, k, self._merge(chunks, k)))
            with trace.span("fetch"):
                flat = torch.cat([o.reshape(-1) for _, _, o in outs]).cpu() \
                    .numpy()
            off = 0
            for idxs, k, o in outs:
                block = flat[off:off + o.numel()].reshape(o.shape)
                off += o.numel()
                for bi, i in enumerate(idxs):
                    row = block[bi]
                    with trace.span("finish"):
                        results[i] = self._render_merged(
                            queries[i], bundles[i][0], row[:k], row[k:2 * k],
                            row[2 * k:3 * k], row[3 * k:4 * k],
                            row[4 * k:5 * k], int(row[5 * k]), t0)
            return results

    def _fallback_search(self, q):
        if getattr(q, "group_by", None):
            # grouped queries: per-shard grouped searches + exact host
            # merge (COUNT/SUM/MIN/MAX; same semantics as RT segment merge)
            from ..exec.multi import search_grouped_parts
            return search_grouped_parts(
                self._per_shard_indexes(), q, self.schema,
                single_part_hint="query a single shard for exact distinct")
        return self._per_shard_search(q)

    def _render_merged(self, q, cq, w, hi, lo, rid, shard, found, t0):
        hi = hi.astype(np.int64)
        lo = lo.astype(np.int64)

        n_avail = min(found, cq.sig.k)
        keep = w[:n_avail] != INT32_MIN
        w, hi, lo, rid, shard = (x[:n_avail][keep] for x in (w, hi, lo, rid, shard))
        docids = (hi << 32) | (lo + 2**31)

        lo_i = min(q.offset, len(w))
        hi_i = min(q.offset + q.limit, len(w))
        matches = []
        for i in range(lo_i, hi_i):
            sh = self.shards[int(shard[i])]
            r = int(rid[i])
            attrs = {}
            for a in self.schema.attrs:
                if a.name in sh.attrs_int:
                    attrs[a.name] = int(sh.attrs_int[a.name][r])
                elif a.name in sh.attrs_big:
                    attrs[a.name] = int(sh.attrs_big[a.name][r])
                elif a.name in sh.attrs_float:
                    attrs[a.name] = float(sh.attrs_float[a.name][r])
                elif a.name in sh.attrs_str:
                    attrs[a.name] = sh.attrs_str[a.name][r]
            for fname, vals in sh.stored_fields.items():
                attrs[fname] = vals[r]
            matches.append(Match(int(docids[i]), int(w[i]), attrs))

        dt = (time.perf_counter() - t0) * 1000.0
        stats = [WordStat(t, d, h) for t, d, h in
                 zip(cq.slot_terms, cq.slot_df, cq.slot_hits)]
        return SearchResult(matches, n_avail, found, dt, stats)


def partition_documents(docs: list[dict], n_shards: int) -> list[list[dict]]:
    """Round-robin doc partition (the reference leaves sharding to the user's
    distributed config; round-robin by id keeps shards balanced)."""
    out: list[list[dict]] = [[] for _ in range(n_shards)]
    for d in docs:
        out[int(d["id"]) % n_shards].append(d)
    return out
