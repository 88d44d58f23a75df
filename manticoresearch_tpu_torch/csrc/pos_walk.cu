// The phrase and proximity nodes of a search program for Hopper (sm_90a):
// one launch evaluates every such node of the program from its members' hit
// windows.
//
// Replaces no TPU kernel. It stands for the XLA sort-and-scan predecessor
// lookup of manticoresearch_tpu/ops/search.py (_pred_scan under
// _eval_phrase_node: a lax.sort of the member's hits and the anchors'
// targets, a running "last member hit seen" and a scatter back), which the
// port runs as eager PyTorch ops (ops/search.py _eval_phrase_node, still its
// plain version): per member a stable int64 sort of the member's window and
// the anchors together, a _last_index, three scatter-backs and the hit
// masks, about 60 eager ops for a two-word phrase and 145 for a two-word
// proximity node, which the host issues one by one while the card waits.
//
// Nothing needs sorting. Every slot's hit window is sorted by (row, key &
// ~end flag) over its valid prefix, keys non-negative (field < 128), and the
// anchors are such a window too. So one thread per anchor entry (a phrase:
// the anchor slot's window; a proximity node: each member's window in turn,
// laid end to end as the plain version lays them):
//  1. reads its anchor (row, key); entries past the window's valid length
//     are pads, never ok;
//  2. for each member binary-searches its window for the predecessor, the
//     last valid (row, key) <= (anchor row, target), equal keys counting
//     as <=: the plain version's answer without its sort;
//     - phrase, members 1..m-1: target a_key + delta, ok while the
//       predecessor is (a_row, target) itself;
//     - proximity, every member: target a_key, ok while the predecessor has
//       the anchor's row and a_key - key < win; the member's delta key -
//       qdelta stays in a register;
//  3. proximity: folds the deltas into the emission weight as the plain
//     version does, the count of members in chains of >= 2 equal deltas,
//     at least 1 (also written for anchors that are not ok, which no reader
//     takes);
//  4. writes ok, and for an ok anchor adds 1 to tf at its row's position
//     (the row itself in a dense space, else the first position whose row
//     is >= it, clamped to the last: the plain version's to_idx), with an
//     integer atomic, which is exact in any order.
// Arithmetic on keys wraps like int32 tensors.
//
// Bound: dependent loads. The bytes it needs are each window's valid
// entries (row and key, 8 B), 1 B of ok (and 4 B of a_w) per anchor and
// tf's adds; each binary search chains about log2(window) loads, of which
// neighbouring anchors, sorted, share the first steps in L2. The node table
// (at most kMaxNodes nodes of at most kMaxMembers members) is the kernel's
// by-value argument: no table copy to the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNodes = 8;
constexpr int kMaxMembers = 8;
constexpr int kThreads = 256;
constexpr int32_t kKeyMask = ~(1 << 23);   // strip the field-end flag

struct Member {
  const int32_t* row;   // the slot's hit window: rows
  const int32_t* key;   // packed keys (end flag masked here)
  int32_t n;            // valid entries
  int32_t hb;           // window length (a proximity node's anchors per part)
  int32_t delta;        // phrase: target key - anchor key; proximity: qdelta
  int32_t pad;
};

struct Node {
  uint8_t* ok;          // [n_anchors]
  int32_t* a_w;         // [n_anchors] proximity emission weight, or null
  int32_t* tf;          // [size], zeroed by the caller
  int32_t n_anchors;    // phrase: member 0's hb; proximity: the sum of hb
  int32_t first_block;  // the node's anchors start on a block boundary
  int32_t n_members;
  int32_t proximity;    // 0: phrase, 1: proximity
  int32_t win;          // proximity: qdeltas[-1] + slop
  int32_t pad;
  Member m[kMaxMembers];
};

struct PosArgs {
  const int32_t* rows;  // [size] each position's row, ascending; null: dense
  int64_t size;
  int32_t n_nodes;
  int32_t n_blocks;
  Node nodes[kMaxNodes];
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// the last index in [0, M.n) whose (row, key & kKeyMask) <= (r, k), or -1
__device__ __forceinline__ int32_t predecessor(const Member& M, int32_t r,
                                               int32_t k) {
  int32_t lo = 0, hi = M.n;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const int32_t mr = __ldg(M.row + mid);
    if (mr < r || (mr == r && (__ldg(M.key + mid) & kKeyMask) <= k)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

__global__ void __launch_bounds__(kThreads) pos_walk_kernel(const PosArgs a) {
  int k = 0;
  while (k + 1 < a.n_nodes &&
         static_cast<int32_t>(blockIdx.x) >= a.nodes[k + 1].first_block) {
    ++k;
  }
  const Node& nd = a.nodes[k];
  const int32_t t =
      (static_cast<int32_t>(blockIdx.x) - nd.first_block) * kThreads +
      static_cast<int32_t>(threadIdx.x);
  if (t >= nd.n_anchors) return;

  // the anchor's part: a proximity node lays its members' windows end to
  // end, a phrase anchors on member 0
  int q = 0;
  int32_t i = t;
  if (nd.proximity) {
    while (q + 1 < nd.n_members && i >= nd.m[q].hb) {
      i -= nd.m[q].hb;
      ++q;
    }
  }
  bool ok = i < nd.m[q].n;
  int32_t a_row = 0, a_key = 0;
  if (ok) {
    a_row = __ldg(nd.m[q].row + i);
    a_key = __ldg(nd.m[q].key + i) & kKeyMask;
  }

  if (!nd.proximity) {
    for (int qi = 1; qi < nd.n_members && ok; ++qi) {
      const Member& B = nd.m[qi];
      const int32_t tgt = wrap_add(a_key, B.delta);
      const int32_t j = predecessor(B, a_row, tgt);
      ok = j >= 0 && __ldg(B.row + j) == a_row &&
           (__ldg(B.key + j) & kKeyMask) == tgt;
    }
  } else {
    int32_t d[kMaxMembers];
#pragma unroll
    for (int qi = 0; qi < kMaxMembers; ++qi) {
      d[qi] = 0;
      if (qi < nd.n_members && ok) {
        const Member& B = nd.m[qi];
        const int32_t j = predecessor(B, a_row, a_key);
        int32_t pk = 0;
        if (j >= 0 && __ldg(B.row + j) == a_row) {
          pk = __ldg(B.key + j) & kKeyMask;
          ok = wrap_sub(a_key, pk) < nd.win;
        } else {
          ok = false;
        }
        d[qi] = wrap_sub(pk, B.delta);
      }
    }
    int32_t w = 0;
#pragma unroll
    for (int qi = 0; qi < kMaxMembers; ++qi) {
      int32_t cnt = 0;
#pragma unroll
      for (int qj = 0; qj < kMaxMembers; ++qj) {
        cnt += (qj < nd.n_members && d[qi] == d[qj]) ? 1 : 0;
      }
      w += (qi < nd.n_members && cnt >= 2) ? 1 : 0;
    }
    nd.a_w[t] = max(w, 1);
  }
  nd.ok[t] = ok ? 1 : 0;
  if (!ok) return;

  int64_t p = a_row;
  if (a.rows != nullptr) {
    int64_t lo = 0, hi = a.size;
    while (lo < hi) {
      const int64_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(a.rows + mid) < a_row) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    p = min(lo, a.size - 1);
  }
  atomicAdd(nd.tf + p, 1);
}

}  // namespace

// args: host pointer to one PosArgs (the wrapper's ctypes structure, with
// n_nodes <= 8 and 1..8 members a node), passed to the kernel by value.
// Launches one kernel on `stream` and returns cudaGetLastError() so the
// caller sees a refused launch.
extern "C" int mt_pos_walk(const void* args, void* stream) {
  const PosArgs* a = static_cast<const PosArgs*>(args);
  if (a->n_nodes < 0 || a->n_nodes > kMaxNodes || a->size < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < a->n_nodes; ++k) {
    if (a->nodes[k].n_members < 1 || a->nodes[k].n_members > kMaxMembers) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (a->n_blocks <= 0) return static_cast<int>(cudaSuccess);
  pos_walk_kernel<<<static_cast<unsigned>(a->n_blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(PosArgs) and sizeof(Node), for the wrapper's layout check
extern "C" int64_t mt_pos_walk_sizes(void) {
  return (static_cast<int64_t>(sizeof(PosArgs)) << 32) |
         static_cast<int64_t>(sizeof(Node));
}
