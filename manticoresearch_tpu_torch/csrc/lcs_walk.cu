// The proximity rankers' LCS pass for Hopper (sm_90a): one launch ranks
// every candidate position of a search program from the sorted hit lists of
// its ranker terms and phrase nodes.
//
// Replaces no TPU kernel. It stands for the XLA sort-and-scan ranker of
// manticoresearch_tpu/ops/search.py:1191-1225 (lax.sort of the merged hit
// stream by (row, key), the linked-run scan and one scatter-max per field),
// which the port ran as eager PyTorch ops (ops/search.py _hit_stream and
// _rank_hit_stream, still its plain version): a stable int64 sort of the
// whole stream, gathers of every column in sorted order, two cumsums, a
// last-index scatter and one scatter-max into [size, F] per field, about
// 75 eager ops per query, which the host issues one by one while the card
// waits.
//
// Nothing needs sorting. Every list handed in is already sorted by (row,
// key) over its valid prefix: a term slot's hit window as the index stores
// it, a phrase node's anchors (its anchor slot's hits), each member's part
// of a proximity node's anchors. The state machine (RankerState_Proximity)
// only ever looks at one document's hits in key order. So one thread per
// candidate position:
//  1. finds its row in each list by binary search (a list whose gate is
//     off at the position is skipped whole);
//  2. merges the lists' entries of that row by (key, list index, entry
//     index), which is the order of the stable sort of the lists laid end
//     to end, skipping entries whose per-entry mask is off;
//  3. clamps qpos, weight and span to 0..255 (the sort's packed payload),
//     and marks an entry linked iff the previous merged entry has a
//     smaller key and delta == prev_delta + prev_span - 1, with delta =
//     key - qpos, in wrapping int32 arithmetic;
//  4. keeps the run's weight sum, capped at 255 (BYTE m_uCurLCS);
//  5. takes each field's maximum: entries of one field are contiguous in
//     key order (the field is the key's top byte, and equal top bytes form
//     one interval of signed keys), so a running maximum flushed when the
//     field changes replaces the [size, F] array; fields >= F reach none;
//  6. writes bm25part + wrap_i32(sum_f lcs_f * fw_f) * 1000 (or the rank
//     alone for the proximity ranker), every sum wrapping like the plain
//     version's int64 sum and int32 ops.
// Output: one int32 per position, every position written.
//
// Bound: device-memory bytes. The pass needs each hit entry it merges once
// (row and key, 8 bytes, plus a per-entry weight or mask where the list
// has one) and 12 bytes per position (row, bm25part, weight). A thread's
// binary searches read a few more entries; neighbouring positions hold
// neighbouring rows, so a warp's searches share their first steps in L2.
// The list table (at most kMaxLists lists, kMaxFields field weights) is
// the kernel's by-value argument: no table copy to the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLists = 32;
constexpr int kMaxFields = 64;
constexpr int kThreads = 256;

struct HitList {
  const int32_t* row;     // [n] sorted by (row, key & key_mask)
  const int32_t* key;     // [n]
  const int32_t* weight;  // [n] per entry, or null: wconst
  const uint8_t* ok;      // [n] per-entry mask, or null: every entry
  const uint8_t* gate;    // [size] per-position gate, or null: none
  int32_t n;
  int32_t qpos;
  int32_t span;
  int32_t wconst;
  int32_t key_mask;
  int32_t pad;
};

struct LcsArgs {
  const int32_t* rows;      // [size] each position's row
  const int32_t* bm25part;  // [size]
  int32_t* out;             // [size]
  int64_t size;
  int32_t n_lists;
  int32_t n_fields;
  int32_t with_bm25;
  int32_t pad;
  int64_t fw[kMaxFields];
  HitList lists[kMaxLists];
};

__device__ __forceinline__ int32_t clamp255(int32_t v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// the first index in [0, n) whose row is >= r (rows nondecreasing)
__device__ __forceinline__ int32_t lower_bound(const int32_t* row, int32_t n,
                                               int32_t r) {
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(row + mid) < r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
lcs_walk_kernel(const LcsArgs a) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= a.size) return;
  const int32_t r = __ldg(a.rows + p);
  const int nl = a.n_lists;

  // each list's cursor and the masked key at it (INT64_MAX: no entry of
  // this row left)
  int32_t cur[kMaxLists];
  int64_t head[kMaxLists];
  for (int l = 0; l < nl; ++l) {
    const HitList& L = a.lists[l];
    head[l] = INT64_MAX;
    cur[l] = 0;
    if (L.gate != nullptr && __ldg(L.gate + p) == 0) continue;
    const int32_t i = lower_bound(L.row, L.n, r);
    cur[l] = i;
    if (i < L.n && __ldg(L.row + i) == r) {
      head[l] = __ldg(L.key + i) & L.key_mask;
    }
  }

  bool have_prev = false;
  int32_t prev_key = 0, prev_delta = 0, prev_span = 0;
  int32_t run = 0;          // curlcs: the run's weight sum, capped at 255
  int32_t field = -1;       // the field of the entries being maximised
  int32_t field_max = 0;
  uint64_t rank = 0;        // sum_f lcs_f * fw_f, wrapping like int64

  for (;;) {
    int best = -1;
    int64_t best_key = INT64_MAX;
    for (int l = 0; l < nl; ++l) {
      if (head[l] < best_key) {   // strict: equal keys keep list order
        best_key = head[l];
        best = l;
      }
    }
    if (best < 0) break;
    const HitList& L = a.lists[best];
    const int32_t i = cur[best]++;
    head[best] = (cur[best] < L.n && __ldg(L.row + cur[best]) == r)
                     ? static_cast<int64_t>(__ldg(L.key + cur[best]) &
                                            L.key_mask)
                     : INT64_MAX;
    if (L.ok != nullptr && __ldg(L.ok + i) == 0) continue;

    const int32_t key = static_cast<int32_t>(best_key);
    const int32_t qp = clamp255(L.qpos);
    const int32_t sp = clamp255(L.span);
    const int32_t w = clamp255(L.weight != nullptr ? __ldg(L.weight + i)
                                                   : L.wconst);
    const int32_t delta = static_cast<int32_t>(static_cast<uint32_t>(key) -
                                               static_cast<uint32_t>(qp));
    const int32_t want = static_cast<int32_t>(
        static_cast<uint32_t>(prev_delta) + static_cast<uint32_t>(prev_span) -
        1u);
    const bool linked = have_prev && key > prev_key && delta == want;
    run = linked ? min(run + w, 255) : w;

    const int32_t f = static_cast<int32_t>((static_cast<uint32_t>(key) >> 24) &
                                           0xFFu);
    if (f != field) {
      if (field >= 0 && field < a.n_fields) {
        rank += static_cast<uint64_t>(field_max) *
                static_cast<uint64_t>(a.fw[field]);
      }
      field = f;
      field_max = 0;
    }
    field_max = max(field_max, run);

    have_prev = true;
    prev_key = key;
    prev_delta = delta;
    prev_span = sp;
  }
  if (field >= 0 && field < a.n_fields) {
    rank += static_cast<uint64_t>(field_max) *
            static_cast<uint64_t>(a.fw[field]);
  }
  const uint32_t rank32 = static_cast<uint32_t>(rank);
  const uint32_t w = a.with_bm25
                         ? static_cast<uint32_t>(__ldg(a.bm25part + p)) +
                               rank32 * 1000u
                         : rank32;
  a.out[p] = static_cast<int32_t>(w);
}

}  // namespace

// args: host pointer to one LcsArgs (the wrapper's ctypes structure, with
// n_lists <= 32 and n_fields <= 64), passed to the kernel by value.
// Launches one kernel on `stream` and returns cudaGetLastError() so the
// caller sees a refused launch.
extern "C" int mt_lcs_walk(const void* args, void* stream) {
  const LcsArgs* a = static_cast<const LcsArgs*>(args);
  if (a->size <= 0) return static_cast<int>(cudaSuccess);
  if (a->n_lists > kMaxLists || a->n_fields > kMaxFields || a->n_lists < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (a->size + kThreads - 1) / kThreads;
  lcs_walk_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(LcsArgs) and sizeof(HitList), for the wrapper's layout check
extern "C" int64_t mt_lcs_walk_sizes(void) {
  return (static_cast<int64_t>(sizeof(LcsArgs)) << 32) |
         static_cast<int64_t>(sizeof(HitList));
}
