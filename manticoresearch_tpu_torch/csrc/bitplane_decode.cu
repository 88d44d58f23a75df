// Bit-plane posting decode for Hopper (sm_90a): one grouped launch decodes
// every packed window of a search batch.
//
// Replaces manticoresearch_tpu/ops/pfor.py:_decode_class (the Pallas kernel
// that _make_class_kernel builds) and stands for the XLA decode the JAX
// serving path runs in manticoresearch_tpu/ops/packed_store.py
// (decode_words without the prefix sum, decode_rowids with it).
//
// Layout: one block holds 128 values in c bit planes, c in {4, 8, 16, 32}.
// Plane j is 4 uint32 words; value l's bit j is bit l % 32 of word
// 4j + l / 32. The decode is value[l] = sum_j bit_j(l) << j, optionally
// followed by an inclusive in-block prefix sum plus the block's base (the
// delta-coded rowid stream).
//
// Work list: one entry per packed window, four int64 each: the address of
// its words ([nb, 4c] uint32), the address of its bases ([nb] int32, or 0
// for no prefix sum), its first block in the output, and c. Entries are in
// output order, so the output block of global block g is row g of one
// [total_blocks, 128] int32 buffer and an entry's nb is the gap to the next
// entry's first block.
//
// Bound: device-memory bytes. A block reads 16c bytes of words (and 4 of
// base) and writes 512 bytes of values: at c=16, 772 bytes, so 262144
// blocks take at least 202 MB / 3.35 TB/s = 60 us on an H100 SXM. The first
// version (one warp per block, words staged in shared memory, one bit per
// broadcast LDS and three integer ops per bit) spent about 300 warp
// instructions per block, above that bound, and the main path launched it
// once per window. This design:
// - one launch per batch: the work list above, so the host pays one launch
//   and one list copy, not one of each per window;
// - a persistent grid (SM count times resident CTAs), each warp taking a
//   contiguous run of global blocks; the CTA first copies the entries'
//   first blocks into shared memory (up to kSmemItems entries, else they
//   are read from global memory), each warp finds its first entry by a
//   binary search there and then steps forward one entry at a time, which
//   costs one compare per block;
// - loads: lane j < c reads plane j's four words in one 16-byte load on the
//   read-only path (a window's words start at a multiple of 16 bytes; the
//   wrapper checks it); lanes j >= c hold zeros;
// - a ring of kDepth staged blocks per warp: the loads of the next kDepth
//   blocks are in flight while the current one decodes;
// - no per-bit extraction and no shared memory for the words: each of the
//   4 words is a 32x32 bit matrix across the warp (row = lane = plane) and
//   is transposed in registers in 5 __shfl_xor_sync butterfly stages (one
//   SHFL, one funnel-shift rotate and one LOP3 each), after which lane t
//   holds values t, t+32, t+64 and t+96 whole: 60 instructions for the
//   four words;
// - the prefix sum is a __shfl_up_sync scan over each 32-value segment with
//   the running total carried from one segment to the next, and the four
//   results go out as four coalesced 128-byte rows.
// On an H100 SXM (700 W) this reaches about 0.6 of the bound at 262144
// blocks of c=16 (PERF.md). The depth, CTA shape and shared-memory search
// were chosen by timing variants there: depth 4 was fastest on large
// lists, and a CTA shape with 8 CTAs per SM (32 registers) spilled and ran
// slower. The time per block changed little with c in those runs, so
// what holds the rest back is likely the work per block (about
// 44 shuffles per rowid block, for the transpose and the scan), not bytes.
// Arithmetic is uint32, so sums wrap like the int32 cumsum of the JAX code.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kItemWords = 4;     // int64 fields per work-list entry
constexpr int kWarpsPerCta = 8;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kMinCtasPerSm = 4;  // 64 registers a thread at most
constexpr int kDepth = 4;         // blocks staged ahead per warp
constexpr int kSmemItems = 2048;  // entries' first blocks held in smem
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

struct Window {
  const uint4* words;   // plane-major words, 16 bytes per plane
  const int32_t* base;  // null: no prefix sum
  int64_t first;        // first global block of this window
  int64_t end;          // one past its last global block
  int c;
};

__device__ __forceinline__ Window load_window(const int64_t* __restrict__ items,
                                              int i, int64_t end) {
  const int64_t* e = items + static_cast<int64_t>(i) * kItemWords;
  Window w;
  w.words = reinterpret_cast<const uint4*>(ld64(e + 0));
  w.base = reinterpret_cast<const int32_t*>(ld64(e + 1));
  w.first = ld64(e + 2);
  w.c = static_cast<int>(ld64(e + 3));
  w.end = end;
  return w;
}

struct Staged {
  uint4 words;     // lane j < c: plane j; other lanes: zeros
  uint32_t base;   // the block's base (prefix sum only)
  bool prefix;
};

__device__ __forceinline__ Staged stage(const Window& w, int64_t g, int lane) {
  const int64_t b = g - w.first;
  Staged s;
  s.words = make_uint4(0u, 0u, 0u, 0u);
  if (lane < w.c) s.words = __ldg(w.words + b * w.c + lane);
  s.prefix = w.base != nullptr;
  s.base = s.prefix ? static_cast<uint32_t>(__ldg(w.base + b)) : 0u;
  return s;
}

// Per-lane constants of the butterfly transpose. Stage s (16, 8, 4, 2, 1)
// swaps the off-diagonal s x s blocks of each 2s x 2s block: a lane with
// bit s clear keeps its low columns (mask m) and takes its partner's low
// columns shifted up by s; a lane with bit s set keeps its high columns and
// takes its partner's high columns shifted down by s. Both shifts are one
// rotate (by s, or by 32 - s), whose wrapped bits the mask drops.
struct Butterfly {
  uint32_t keep[5];
  uint32_t rot[5];
};

__device__ __forceinline__ Butterfly make_butterfly(int lane) {
  constexpr uint32_t kMasks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                                  0x33333333u, 0x55555555u};
  Butterfly b;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const bool hi = (lane & s) != 0;
    b.keep[k] = hi ? ~kMasks[k] : kMasks[k];
    b.rot[k] = hi ? 32u - s : static_cast<uint32_t>(s);
  }
  return b;
}

// Row r = lane holds word x; afterwards bit j of lane t is bit t of lane j.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, const Butterfly& b) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint32_t y = __shfl_xor_sync(kFullMask, x, 16 >> k);
    const uint32_t r = __funnelshift_l(y, y, b.rot[k]);
    x = (x & b.keep[k]) | (r & ~b.keep[k]);
  }
  return x;
}

__device__ __forceinline__ void decode_block(const Staged& s,
                                             const Butterfly& bf, int lane,
                                             int32_t* __restrict__ dst) {
  uint32_t v[4];
  v[0] = transpose32(s.words.x, bf);
  v[1] = transpose32(s.words.y, bf);
  v[2] = transpose32(s.words.z, bf);
  v[3] = transpose32(s.words.w, bf);

  if (s.prefix) {
    uint32_t carry = s.base;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t x = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(kFullMask, x, d);
        if (lane >= d) x += y;
      }
      v[k] = carry + x;
      carry += __shfl_sync(kFullMask, x, 31);
    }
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) dst[32 * k + lane] = static_cast<int32_t>(v[k]);
}

__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
bitplane_decode_grouped_kernel(const int64_t* __restrict__ items, int n_items,
                               int64_t total_blocks, int64_t chunk,
                               int32_t* __restrict__ out) {
  __shared__ int64_t s_first[kSmemItems > 0 ? kSmemItems : 1];
  const bool in_smem = n_items <= kSmemItems;
  if (in_smem) {
    for (int k = threadIdx.x; k < n_items; k += kThreads) {
      s_first[k] = ld64(items + static_cast<int64_t>(k) * kItemWords + 2);
    }
    __syncthreads();
  }
  const auto first_of = [&](int k) -> int64_t {
    return in_smem ? s_first[k]
                   : ld64(items + static_cast<int64_t>(k) * kItemWords + 2);
  };
  const auto window_at = [&](int k) -> Window {
    return load_window(items, k, k + 1 < n_items ? first_of(k + 1)
                                                 : total_blocks);
  };

  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  int64_t g = warp * chunk;
  const int64_t g_end = g + chunk < total_blocks ? g + chunk : total_blocks;
  if (g >= g_end) return;  // uniform across the warp

  // the last entry whose first block is <= g (entries have nb >= 1)
  int lo = 0;
  int hi = n_items - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first_of(mid) <= g) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  int i = lo;
  Window w = window_at(i);
  const Butterfly bf = make_butterfly(lane);

  // a ring of kDepth staged blocks: block g decodes while the loads of
  // blocks g+1 .. g+kDepth are in flight
  Staged q[kDepth] = {};
  int64_t gl = g;  // the next block to stage
#pragma unroll
  for (int d = 0; d < kDepth; ++d, ++gl) {
    if (gl < g_end) {
      while (gl >= w.end) w = window_at(++i);
      q[d] = stage(w, gl, lane);
    }
  }
  for (; g < g_end; ++g, ++gl) {
    const Staged cur = q[0];
#pragma unroll
    for (int d = 0; d + 1 < kDepth; ++d) q[d] = q[d + 1];
    if (gl < g_end) {
      while (gl >= w.end) w = window_at(++i);
      q[kDepth - 1] = stage(w, gl, lane);
    }
    decode_block(cur, bf, lane, out + g * kBlock);
  }
}

int grid_for(int64_t total_blocks, int64_t* chunk) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bitplane_decode_grouped_kernel, kThreads, 0);
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 1) *
                           (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (total_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  const int64_t grid = needed < resident ? needed : resident;
  const int64_t warps = grid * kWarpsPerCta;
  *chunk = (total_blocks + warps - 1) / warps;
  return static_cast<int>(grid);
}

}  // namespace

// items: device int64 [n_items, 4] work list (see above), entries in output
// order with nb >= 1 each; out: device int32 [total_blocks, 128]. Launches
// one kernel on `stream` and returns cudaGetLastError() so the caller sees
// a refused launch.
extern "C" int mt_bitplane_decode_grouped(const void* items, int n_items,
                                          int64_t total_blocks, void* out,
                                          void* stream) {
  if (n_items <= 0 || total_blocks <= 0) return static_cast<int>(cudaSuccess);
  int64_t chunk = 0;
  const int grid = grid_for(total_blocks, &chunk);
  bitplane_decode_grouped_kernel<<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(items), n_items, total_blocks, chunk,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
