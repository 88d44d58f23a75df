"""Group-by / aggregation tail over the match core, in PyTorch.

Counterpart of ``manticoresearch_tpu/ops/groupby.py``: the reference's
group-by sorters (CSphKBufferGroupSorter family) as sort-segment-reduce:
  1. a stable sort of the rows by (group key, within-group order), so that
     each group's best row comes first;
  2. group boundaries, and group ids by a running count;
  3. aggregates by scatter over the group ids;
  4. group ordering and the top k over the boundary rows.
COUNT(DISTINCT x) sorts again by (group, x) and counts value boundaries.

Exactness against the JAX package:
- every multi-key sort is one stable sort of an int64 key; rows ascend
  with the position in every row space (``ops.search``), so a stable sort
  on (key, within) keeps JAX's rowid tie order;
- counts, integer SUM (in int64, wrapped to int32) and MIN / MAX are exact
  under any add order, so ``index_add_`` and ``scatter_reduce_`` serve on
  the card;
- float SUM and every AVG add each group's members one by one, left to
  right in sorted order, as XLA's scatter does on the CPU: no PyTorch call
  keeps that order on the card, so ``segment_sum_ordered`` launches the
  hand-written kernel ``csrc/segment_sum.cu`` there, and on CPU tensors
  runs its plain version (``index_add_``, a sequential loop on the CPU).

``LAUNCHES`` counts the kernel's launches and the plain version's calls.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass, replace

import torch

from ..query.expr import eval_expr, to_int32
from ..query.plan import PlanSig
from . import _build
from .packed_store import wrap_i32
from .search import INT32_MAX, INT32_MIN, build_match_core

_2_32 = 1 << 32


@dataclass(frozen=True)
class AggSpec:
    kind: str            # "count" | "sum" | "min" | "max" | "avg"
                         # | "count_distinct"
    expr: tuple | None   # expr tree (None for count)
    is_float: bool = False


@dataclass(frozen=True)
class GroupSpec:
    key_expr: tuple                  # expr tree producing the group key
    aggs: tuple[AggSpec, ...]
    order: tuple                     # ("rel",) | ("gkey", asc) |
                                     # ("count", asc) | ("rowid", asc) |
                                     # ("attr", name, asc, is_float)
    k: int                           # max groups returned
    emit_eligible: bool = False      # also output the raw match mask
                                     # (host-side GROUP_CONCAT needs members)
    within: tuple = ("rel",)         # WITHIN GROUP ORDER BY: which row
                                     # represents the group — ("rel",) |
                                     # ("attr", name, asc, is_float) |
                                     # ("rowid", asc)


# --------------------------------------------------------------------------
# the ordered float segment sum
# --------------------------------------------------------------------------
@dataclass
class SegmentLaunches:
    kernel: int = 0      # segment_sum_ordered CUDA launches
    positions: int = 0   # positions those launches read
    plain: int = 0       # plain-PyTorch sums (CPU tensors)

    def reset(self) -> None:
        self.kernel = 0
        self.positions = 0
        self.plain = 0


LAUNCHES = SegmentLaunches()


def segment_sum_plain(values: torch.Tensor, gid: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """out[g] = the sum from 0.0 of values[i] over the i with gid[i] == g;
    on the CPU ``index_add_`` adds them one by one in index order."""
    return torch.zeros(n_out, dtype=torch.float32,
                       device=values.device).index_add_(0, gid.long(), values)


def segment_sum_ordered(values: torch.Tensor, gid: torch.Tensor,
                        n_out: int) -> torch.Tensor:
    """Each group's float32 sum from 0.0, its members added one by one in
    index order (XLA's scatter-add on the CPU): values f32[Z], gid int32[Z]
    with every value in [0, n_out) -> f32[n_out]. CPU tensors take the
    plain version; CUDA tensors one launch of the kernel, or a raise."""
    if values.dtype != torch.float32 or values.dim() != 1:
        raise ValueError(f"values must be float32 [Z], got {values.dtype} "
                         f"{tuple(values.shape)}")
    if gid.dtype != torch.int32 or gid.shape != values.shape:
        raise ValueError(f"gid must be int32 {tuple(values.shape)}, got "
                         f"{gid.dtype} {tuple(gid.shape)}")
    if not values.is_cuda:
        if values.device.type != "cpu" or gid.device != values.device:
            raise ValueError(f"no segment sum for {values.device} / "
                             f"{gid.device}")
        LAUNCHES.plain += 1
        return segment_sum_plain(values, gid, n_out)
    if gid.device != values.device:
        raise ValueError("values and gid must be on one device")
    if values.shape[0] >= 2**31 or n_out >= 2**31:
        raise ValueError("segment sums index with int32")
    values = values.contiguous()
    gid = gid.contiguous()
    out = torch.empty(n_out, dtype=torch.float32, device=values.device)
    bounds = torch.empty(2 * n_out, dtype=torch.int32, device=values.device)
    lib = _build.load_library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mt_segment_sum_ordered(
            values.data_ptr(), gid.data_ptr(), values.shape[0], n_out,
            out.data_ptr(), bounds.data_ptr(), stream)
    _build.check(rc, "segment_sum_ordered")
    LAUNCHES.kernel += 1
    LAUNCHES.positions += values.shape[0]
    return out


# --------------------------------------------------------------------------
# the group-by program
# --------------------------------------------------------------------------
class AttrView(Mapping):
    """The attribute columns as the expressions see them: each gathered
    to the program's rows (``at_rows``) when first read, so that only the
    attributes an expression names are gathered. Its ``device`` places
    expression constants."""

    def __init__(self, cols: dict, at_rows, device: torch.device):
        self._cols = cols
        self._at_rows = at_rows
        self._seen: dict = {}
        self.device = device

    def __getitem__(self, name):
        if name not in self._seen:
            self._seen[name] = self._at_rows(self._cols[name])
        return self._seen[name]

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __iter__(self):
        return iter(self._cols)

    def __len__(self) -> int:
        return len(self._cols)


def probe_groupby(gspec: GroupSpec, attr_dtypes: dict) -> None:
    """Evaluate the spec's key and aggregate expressions over one-row CPU
    columns of the given dtypes: raises the ExprError (a host-only
    expression) that running the program would raise, before any work."""
    attrs = {k: torch.zeros(1, dtype=dt) for k, dt in attr_dtypes.items()}
    w = torch.zeros(1, dtype=torch.int32)
    eval_expr(gspec.key_expr, attrs, w)
    for a in gspec.aggs:
        if a.expr is not None:
            eval_expr(a.expr, attrs, w)


def _f32_sortable_i32(v: torch.Tensor) -> torch.Tensor:
    """Map float32 bits to int32 preserving float order (IEEE754 trick:
    positives keep their bit pattern, negatives are complemented)."""
    b = v.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(b >= 0, b, (~b) ^ INT32_MIN)


def _stable_sort_pairs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Permutation of a stable sort by the int32 pair (hi, lo)."""
    key = hi.to(torch.int64) * _2_32 + (lo.to(torch.int64) + 2**31)
    return torch.sort(key, stable=True).indices


def build_groupby(sig: PlanSig, gspec: GroupSpec, n_rows: int, n_fields: int,
                  slot_pb: tuple = (), slot_hb: tuple = (),
                  n_hit_iters: int = 0):
    """The group-by program for one plan shape and spec, the counterpart of
    ``_build_groupby_fn``: (data, rt, decoded) -> dict of rep_rowid,
    rep_weight, group_key, count i32[k], agg{i} [k] (float32 for float
    aggregates and AVG), n_groups, found, and eligible bool[N+1] when
    ``gspec.emit_eligible``. Arguments as for ``ops.search.build_match_core``.
    """
    if gspec.emit_eligible and sig.sparse:
        # host-side GROUP_CONCAT needs a dense per-row match mask
        sig = replace(sig, sparse=False)
    core = build_match_core(sig, n_rows, n_fields, slot_pb, slot_hb,
                            n_hit_iters)
    N = n_rows
    # the core's row space: scan plans stream a scan_bucket window, term
    # plans the slot posting union, dense plans every row and the pad
    Z = ((sig.scan_bucket if sig.scan_index else int(sum(slot_pb)))
         if sig.sparse else N + 1)
    k = gspec.k

    def fn(data, rt, decoded):
        eligible, weight, rows, at_rows = core(data, rt, decoded)
        dev = rows.device
        attrs = AttrView(data["attrs"], at_rows, dev)

        def per_row(x: torch.Tensor) -> torch.Tensor:
            return torch.broadcast_to(x.to(dev), (Z,))

        key = to_int32(per_row(eval_expr(gspec.key_expr, attrs, weight)))
        weight = per_row(weight)
        sk = torch.where(eligible, key, INT32_MAX)
        # within-group order picks the representative (boundary) row:
        # weight desc then rowid asc by default; WITHIN GROUP ORDER BY
        # replaces the primary key
        if gspec.within[0] == "rel":
            wkey = ~weight
        elif gspec.within[0] == "attr":
            _, wname, wasc, wfloat = gspec.within
            wv = attrs[wname]
            wvi = per_row(_f32_sortable_i32(wv) if wfloat else to_int32(wv))
            wkey = wvi if wasc else ~wvi
        elif gspec.within[0] == "rowid":
            wkey = rows if gspec.within[1] else ~rows
        else:
            raise NotImplementedError(f"within order {gspec.within}")
        # lax.sort((sk, wkey, rows, idx), num_keys=3): positions ascend
        # with rows, so a stable sort on (sk, wkey) breaks ties by rowid
        s_idx = _stable_sort_pairs(sk, wkey)
        s_key = sk[s_idx]
        s_row = rows[s_idx]
        s_w = weight[s_idx]
        s_elig = s_key != INT32_MAX

        prev_key = torch.cat([torch.full((1,), INT32_MIN, dtype=torch.int32,
                                         device=dev), s_key[:-1]])
        new_group = (s_key != prev_key) & s_elig
        gid = (torch.cumsum(new_group, dim=0) - 1).clamp(min=0)
        # sink Z-1 is safe: gid <= n_eligible-1 <= Z-2 whenever any row is
        # ineligible, and the sink is unused when every row is eligible
        gid_scatter = torch.where(s_elig, gid, Z - 1)
        n_groups = new_group.sum(dtype=torch.int32)
        counts = torch.zeros(Z, dtype=torch.int32, device=dev).index_add_(
            0, gid_scatter, s_elig.to(torch.int32))

        agg_results = []
        for a in gspec.aggs:
            if a.kind == "count":
                agg_results.append(counts)
                continue
            if a.kind == "count_distinct":
                dv = to_int32(per_row(eval_expr(a.expr, attrs, weight)))
                d_ord = _stable_sort_pairs(sk, dv)
                d_key, d_val = sk[d_ord], dv[d_ord]
                d_elig = d_key != INT32_MAX
                new_key = d_key != torch.cat([torch.full(
                    (1,), INT32_MIN, dtype=torch.int32, device=dev),
                    d_key[:-1]])
                new_val = d_val != torch.cat([torch.zeros(
                    1, dtype=torch.int32, device=dev), d_val[:-1]])
                d_new = (new_key | new_val) & d_elig
                d_gid = torch.cumsum(new_key & d_elig, dim=0) - 1
                d_gid = torch.where(d_elig, d_gid.clamp(min=0), Z - 1)
                agg_results.append(torch.zeros(
                    Z, dtype=torch.int32, device=dev).index_add_(
                    0, d_gid, d_new.to(torch.int32)))
                continue
            v = per_row(eval_expr(a.expr, attrs, weight))
            # the accumulator dtype follows is_float, so the packed row's
            # bit view round-trips
            v = v.to(torch.float32) if a.is_float else to_int32(v)
            v_sorted = v[s_idx]
            if a.kind in ("sum", "avg"):
                if a.is_float or a.kind == "avg":
                    acc = segment_sum_ordered(
                        torch.where(s_elig, v_sorted.to(torch.float32), 0.0),
                        gid_scatter.to(torch.int32), Z)
                else:
                    acc = wrap_i32(torch.zeros(
                        Z, dtype=torch.int64, device=dev).index_add_(
                        0, gid_scatter, torch.where(s_elig, v_sorted, 0).to(
                            torch.int64)))
                if a.kind == "avg":
                    acc = acc / counts.clamp(min=1).to(torch.float32)
                agg_results.append(acc)
            elif a.kind in ("min", "max"):
                if a.is_float:
                    fill = float("inf") if a.kind == "min" else float("-inf")
                else:
                    fill = INT32_MAX if a.kind == "min" else INT32_MIN
                acc = torch.full((Z,), fill, dtype=v_sorted.dtype,
                                 device=dev).scatter_reduce_(
                    0, gid_scatter, torch.where(s_elig, v_sorted, fill),
                    "amin" if a.kind == "min" else "amax")
                agg_results.append(acc)
            else:
                raise NotImplementedError(f"aggregate {a.kind}")

        # ---- order the groups, take the top k (boundary rows represent
        # them); the final tie-break is the representative's rowid asc ----
        if gspec.order[0] == "rel":
            okey = torch.where(new_group, s_w, INT32_MIN)
        elif gspec.order[0] == "gkey":
            okey = torch.where(new_group, ~s_key if gspec.order[1] else s_key,
                               INT32_MIN)
        elif gspec.order[0] == "count":
            cnt_b = counts[gid]
            okey = torch.where(new_group, ~cnt_b if gspec.order[1] else cnt_b,
                               INT32_MIN)
        elif gspec.order[0] == "rowid":
            # groups ordered by their representative row's id
            okey = torch.where(new_group, ~s_row if gspec.order[1] else s_row,
                               INT32_MIN)
        elif gspec.order[0] == "attr":
            _, name, asc, is_float = gspec.order
            v = per_row(attrs[name])[s_idx]
            vi = _f32_sortable_i32(v) if is_float else to_int32(v)
            okey = torch.where(new_group, ~vi if asc else vi, INT32_MIN)
        else:
            raise NotImplementedError(f"group order {gspec.order}")
        # lax.sort((~okey, tie, iota), num_keys=2), first k: one stable
        # sort of (~okey << 32) | tie, tie >= 0; only non-boundary
        # positions tie fully, and their outputs are masked below
        tie = torch.where(new_group, s_row, INT32_MAX)
        o_key = (~okey).to(torch.int64) * _2_32 + tie.to(torch.int64)
        top_pos = torch.sort(o_key, stable=True).indices[:k]
        top_key = okey[top_pos]
        if top_pos.shape[0] < k:
            # a row space narrower than k: pad with empty slots
            pad = k - top_pos.shape[0]
            top_pos = torch.cat([top_pos, top_pos.new_zeros(pad)])
            top_key = torch.cat([top_key, top_key.new_full((pad,),
                                                          INT32_MIN)])

        valid_out = top_key != INT32_MIN
        out_gid = gid[top_pos]
        out = {
            "rep_rowid": torch.where(valid_out, s_row[top_pos], N),
            "rep_weight": torch.where(valid_out, s_w[top_pos], 0),
            "group_key": torch.where(valid_out, s_key[top_pos], 0),
            "count": torch.where(valid_out, counts[out_gid], 0),
            "n_groups": n_groups,
            "found": eligible.sum(dtype=torch.int32),
        }
        for i, acc in enumerate(agg_results):
            out[f"agg{i}"] = torch.where(valid_out, acc[out_gid], 0)
        if gspec.emit_eligible:
            out["eligible"] = eligible
        return out

    return fn


def groupby_row_width(gspec: GroupSpec) -> int:
    """i32 row width of the packed layout: k x (rowid, weight, key,
    count) ++ k per aggregate ++ (n_groups, found)."""
    return gspec.k * (4 + len(gspec.aggs)) + 2


def pack_groupby_output(out: dict, gspec: GroupSpec) -> torch.Tensor:
    """One query's group-by result as an int32 row of
    ``groupby_row_width`` (float aggregates as their bits), followed, when
    ``gspec.emit_eligible``, by the eligible mask as int32."""
    parts = [out["rep_rowid"], out["rep_weight"], out["group_key"],
             out["count"]]
    for i in range(len(gspec.aggs)):
        arr = out[f"agg{i}"]
        parts.append(arr.view(torch.int32) if arr.is_floating_point()
                     else arr.to(torch.int32))
    parts += [out["n_groups"].reshape(1), out["found"].reshape(1)]
    if gspec.emit_eligible:
        parts.append(out["eligible"].to(torch.int32))
    return torch.cat(parts)


def unpack_groupby_row(row, gspec: GroupSpec) -> dict:
    """``pack_groupby_output``'s row (a numpy int32 array) back to the
    program's outputs, float aggregates as float32."""
    k = gspec.k
    out = {"rep_rowid": row[0:k], "rep_weight": row[k:2 * k],
           "group_key": row[2 * k:3 * k], "count": row[3 * k:4 * k]}
    off = 4 * k
    for j, a in enumerate(gspec.aggs):
        arr = row[off:off + k]
        off += k
        if a.kind == "avg" or (a.is_float and a.kind in ("sum", "min",
                                                         "max")):
            arr = arr.view("float32")
        out[f"agg{j}"] = arr
    w = groupby_row_width(gspec)
    out["n_groups"] = int(row[w - 2])
    out["found"] = int(row[w - 1])
    if gspec.emit_eligible:
        out["eligible"] = row[w:].astype(bool)
    return out
