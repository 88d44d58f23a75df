// Ordered float segment sum for Hopper (sm_90a): each group's float32 sum
// of its members, added one by one in index order from +0.0.
//
// Replaces manticoresearch_tpu/ops/groupby.py:143-148, the group-by tail's
// float SUM / AVG accumulator zeros(Z, f32).at[gid_scatter].add(...), and
// the factor scatter-adds of manticoresearch_tpu/ops/factors.py (XLA
// scatters, not Pallas kernels). On the CPU that scatter adds each
// group's members left to right in sorted order; the card's PyTorch calls
// (index_add_ and scatter_add_ with atomics, cumsum's parallel scan,
// segment_reduce) keep no order, so a grouped SUM(float) or AVG would
// differ from the CPU by rounding and from run to run. This kernel gives
// the CPU's sum bit for bit: every add is __fadd_rn, in index order.
//
// Input: values f32[n], gid int32[n], NONDECREASING, with values in
// [0, n_out) (both callers sort by group first: the group-by tail's ids
// ascend with its sink Z-1 last, the factor scatters number the runs of a
// stable sort). So each group is one contiguous run. Output: out f32[n_out],
// +0.0 where no entry lands. Ids outside [0, n_out) are never written; ids
// out of order give wrong sums (two owners of one run), not a fault.
//
// Adding +0.0 to the running sum changes nothing: the sum starts at +0.0,
// and a float sum is -0.0 only when both addends are, so it is never -0.0
// and x + (+0.0) == x for every x it can hold. So a stretch of +0.0 values
// may be skipped, and any other value is simply added. The group-by sink
// (every ineligible row, all +0.0, up to the whole index) costs nothing
// but its scan.
//
// Bounds on this card. Bytes: 8 per position read and 4 per group written,
// over 3.35 TB/s. Chain: an exactly ordered sum cannot beat the chain of
// dependent adds of its longest run (its members that are not +0.0), at
// the latency of one __fadd_rn (4 SM cycles). The first version (three
// launches: an init, per-group bounds by atomicMin / atomicMax, and a walk
// of one thread per group over n_out threads, 16 scalar global loads ahead
// of 16 adds) ran 7-13 us per call at every measured shape against bounds
// of 0.03-0.72 us, and paid a global-memory round trip for every 16 adds
// of a long group (about 65,536 of them for a 2^20-member group).
//
// This design, two launches on the caller's stream and no scratch of its
// own (the wrapper allocates the per-chunk flags behind `out`):
// 1. prep (one CTA per 2048 positions or 2048 groups, whichever is more):
//    zero-fills out with 16-byte stores, and writes one flag per chunk of
//    kChunk positions: does any value of the chunk have bits other than
//    +0.0 (16-byte loads, __syncthreads_or). The fill cannot share a launch
//    with the sums: a group's sum is written by the CTA that owns its run,
//    and only a later launch is ordered after every CTA's fill. Filling
//    only the empty groups instead would leave the gap before a sink
//    (about Z groups) to one CTA.
// 2. walk (one CTA per chunk). A chunk owns the runs whose first position
//    (head) lies in it. A chunk whose id does not change across it owns
//    nothing and exits after two loads. An all-+0.0 chunk writes nothing
//    (prep wrote +0.0) unless its last run continues past it. Otherwise the
//    CTA stages the chunk's values and ids in shared memory with 16-byte
//    cp.async copies, finds the heads (and a 64-bit map of the 32-position
//    blocks that hold a value other than +0.0) and lists them in order with
//    a block scan. Each owned run that ends in the chunk is summed by one
//    thread from shared memory, so no global latency sits in its add chain,
//    and all-+0.0 blocks are jumped by the map.
//    The run that continues past the chunk's end goes to warp 0: lane 0
//    sums its part in the chunk, then the warp finds the run's end (one
//    round of 32 exponential probes, then 32-ary search rounds over the
//    ids, which ascend), and streams the values of the flagged chunks in
//    [end of chunk, end of run) through a ring of kDepth tiles of 512
//    values (cp.async, four 16-byte copies per lane) while lane 0 adds the
//    oldest tile from shared memory: only the __fadd_rn chain is serial.
//    A tile whose 512 values are all +0.0 is skipped by ballot, and
//    unflagged chunks (a sink of 200k-1M positions) are jumped 512 flags
//    per warp load, so a sink costs a few round trips, not a serial scan.
// Why not one launch: see 1. A persistent grid could order the fill and
// the sums through a grid-wide barrier, but a barrier that spins on
// co-resident CTAs deadlocks when two calls share the card from two
// streams; the second launch costs one kernel boundary instead.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                     // positions per thread
constexpr int kChunk = kThreads * kPer;     // 2048 positions a CTA
constexpr int kTile = 512;                  // continuation tile: 32 x 64 B
constexpr int kDepth = 4;                   // tiles in flight
constexpr int kFlagWindow = 512;            // flags one warp load covers
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc = __fadd_rn(acc, x.y);
  acc = __fadd_rn(acc, x.z);
  return __fadd_rn(acc, x.w);
}

__device__ __forceinline__ bool nonzero4(uint4 w) {
  return (w.x | w.y | w.z | w.w) != 0u;
}

// ---------------------------------------------------------------- prep
__global__ void __launch_bounds__(kThreads)
    seg_prep_kernel(const float* __restrict__ values, int64_t n,
                    int64_t n_out, float* __restrict__ out,
                    unsigned char* __restrict__ flags) {
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t f0 = b * kChunk;
  if (f0 < n_out) {
    const int64_t f1 = lmin(f0 + kChunk, n_out);
    if (f1 - f0 == kChunk) {
      float4* o = reinterpret_cast<float4*>(out + f0);
#pragma unroll
      for (int k = 0; k < kPer / 4; ++k)
        o[tid + k * kThreads] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int64_t g = f0 + tid; g < f1; g += kThreads) out[g] = 0.0f;
    }
  }
  const int64_t c0 = b * kChunk;
  if (c0 < n) {   // uniform across the CTA
    const int64_t c1 = lmin(c0 + kChunk, n);
    bool nz = false;
    if (c1 - c0 == kChunk) {
      const uint4* v = reinterpret_cast<const uint4*>(values + c0);
#pragma unroll
      for (int k = 0; k < kPer / 4; ++k)
        nz |= nonzero4(__ldg(v + tid + k * kThreads));
    } else {
      const unsigned* v = reinterpret_cast<const unsigned*>(values);
      for (int64_t i = c0 + tid; i < c1; i += kThreads)
        nz |= __ldg(v + i) != 0u;
    }
    nz = __syncthreads_or(nz);
    if (tid == 0) flags[b] = nz ? 1 : 0;
  }
}

// ---------------------------------------------------------------- walk
struct WalkSmem {
  float v[kChunk];
  int g[kChunk];
  int heads[kChunk];
  float ring[kDepth][kTile];
  unsigned char warp_nz[kWarps];   // 8 blocks of 32 positions a warp
  int warp_heads[kWarps];
};

// Sum v[lo, hi) onto acc in order, jumping 32-position blocks whose bit in
// `nzmap` is clear (all +0.0).
__device__ float sum_smem(const float* v, int lo, int hi,
                          unsigned long long nzmap, float acc) {
  int i = lo;
  while (i < hi) {
    const unsigned long long m = nzmap >> (i >> 5);
    if (m == 0ull) break;
    const int b0 = ((i >> 5) + __ffsll(static_cast<long long>(m)) - 1) << 5;
    if (b0 >= hi) break;
    if (b0 > i) i = b0;
    const int end = min(hi, b0 + 32);
    if (i == b0 && end == b0 + 32) {
      const float4* q = reinterpret_cast<const float4*>(v + b0);
      float4 x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = q[k];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = add4(acc, x[k]);
    } else {
#pragma unroll 4
      for (int j = i; j < end; ++j) acc = __fadd_rn(acc, v[j]);
    }
    i = end;
  }
  return acc;
}

// Warp-collective: the first position p >= from with gid[p] != g, or n.
// gid ascends, so "differs" is false then true along [from, n).
__device__ int64_t run_end(const int* __restrict__ gid, int64_t from,
                           int64_t n, int g, int lane) {
  if (from >= n) return n;
  const int64_t span = n - from;
  // exponential probes from + 2^lane - 1 (clamped to n - 1): short runs
  // end after this round and one more
  int64_t off = lmin((static_cast<int64_t>(1) << lane) - 1, span - 1);
  unsigned m = __ballot_sync(kFull, __ldg(gid + from + off) != g);
  if (m == 0u) return n;   // lane 31 probed n - 1 (n < 2^31)
  int f = __ffs(m) - 1;
  int64_t hi = from + lmin((static_cast<int64_t>(1) << f) - 1, span - 1);
  int64_t lo = f == 0 ? from
                      : from + lmin((static_cast<int64_t>(1) << (f - 1)) - 1,
                                   span - 1) + 1;
  // the answer lies in [lo, hi], and gid[hi] != g
  while (hi - lo > 32) {
    const int64_t step = (hi - lo) / 32;
    const int64_t q = lo + static_cast<int64_t>(lane + 1) * step - 1;
    m = __ballot_sync(kFull, __ldg(gid + q) != g);
    if (m) {
      f = __ffs(m) - 1;
      hi = lo + static_cast<int64_t>(f + 1) * step - 1;
      lo = lo + static_cast<int64_t>(f) * step;
    } else {
      lo = lo + 32 * step;
    }
  }
  const int64_t q = lo + lane;
  m = __ballot_sync(kFull, q < hi && __ldg(gid + q) != g);
  return m ? lo + __ffs(m) - 1 : hi;
}

// Warp-collective: the first chunk j in [from, last] whose flag is set
// (want_set) or clear (!want_set), or last + 1. `flags` is padded to a
// multiple of kFlagWindow bytes.
__device__ int64_t next_flag(const unsigned char* __restrict__ flags,
                             int64_t from, int64_t last, bool want_set,
                             int lane) {
  int64_t j = from;
  while (j <= last) {
    const int64_t wbase = j & ~static_cast<int64_t>(kFlagWindow - 1);
    const int64_t first = wbase + 16 * lane;
    const uint4 w = *reinterpret_cast<const uint4*>(flags + first);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned bits = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool set = ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0u;
      bits |= static_cast<unsigned>(set == want_set) << k;
    }
    const int lo_k = static_cast<int>(lmax(0, lmin(16, j - first)));
    const int hi_k =
        static_cast<int>(lmax(0, lmin(16, last + 1 - first)));
    const unsigned range =
        hi_k > lo_k ? (((1u << hi_k) - 1u) & ~((1u << lo_k) - 1u)) : 0u;
    bits &= range;
    const unsigned any = __ballot_sync(kFull, bits != 0u);
    if (any) {
      const int src = __ffs(any) - 1;
      const unsigned sb = __shfl_sync(kFull, bits, src);
      return wbase + 16 * src + (__ffs(sb) - 1);
    }
    j = wbase + kFlagWindow;
  }
  return last + 1;
}

// Lane 0: add the first `count` values of a tile in order. In a full tile
// the next 16 values are loaded from shared memory while the current 16
// are added, so the load latency stays off the add chain; a partial tile
// (a run's end) adds its groups of 16 only (the zero-filled rest of the
// last group adds +0.0).
__device__ __forceinline__ float add_tile(const float* tile, int count,
                                          float acc) {
  const float4* q = reinterpret_cast<const float4*>(tile);
  if (count < kTile) {
    for (int k = 0; k < count; k += 16) {
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = q[k / 4 + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc = add4(acc, x[u]);
    }
    return acc;
  }
  float4 cur[4], nxt[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) cur[u] = q[u];
#pragma unroll
  for (int k = 0; k < kTile / 16; ++k) {
    if (k + 1 < kTile / 16) {
#pragma unroll
      for (int u = 0; u < 4; ++u) nxt[u] = q[4 * (k + 1) + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = add4(acc, cur[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = nxt[u];
  }
  return acc;
}

// Warp-collective: add values[lo, hi) onto lane 0's acc in order through a
// ring of kDepth tiles (kTile / 128 16-byte copies per lane each); lo is a
// multiple of kTile (chunk-aligned).
__device__ float stream_sum(const float* __restrict__ values, int64_t lo,
                            int64_t hi, float acc, float (*ring)[kTile],
                            int lane) {
  const int64_t ntiles = (hi - lo + kTile - 1) / kTile;
  auto fetch = [&](int64_t t) {
    if (t < ntiles) {
#pragma unroll
      for (int h = 0; h < kTile / 128; ++h) {
        const int at = 4 * (lane + 32 * h);
        const int64_t p = lo + t * kTile + at;
        const int64_t left = hi - p;
        const int bytes =
            left >= 4 ? 16 : (left > 0 ? static_cast<int>(left) * 4 : 0);
        cp_async16(&ring[t % kDepth][at], bytes ? values + p : values,
                   bytes);
      }
    }
    cp_async_commit();   // empty groups keep the count uniform
  };
  for (int t = 0; t < kDepth; ++t) fetch(t);
  for (int64_t t = 0; t < ntiles; ++t) {
    cp_async_wait<kDepth - 1>();
    __syncwarp();
    const float* tile = ring[t % kDepth];
    bool mine = false;
#pragma unroll
    for (int h = 0; h < kTile / 128; ++h)
      mine |= nonzero4(
          *reinterpret_cast<const uint4*>(tile + 4 * lane + 128 * h));
    const bool any = __ballot_sync(kFull, mine) != 0u;
    if (any && lane == 0)
      acc = add_tile(tile, static_cast<int>(lmin(kTile, hi - lo - t * kTile)),
                     acc);
    __syncwarp();
    fetch(t + kDepth);
  }
  cp_async_wait<0>();
  return acc;
}

// Warp-collective: continue run g (lane 0 holds its sum so far) from
// position `from` (a chunk boundary) to its end, then write it.
__device__ void continue_run(const float* __restrict__ values,
                             const int* __restrict__ gid,
                             const unsigned char* __restrict__ flags,
                             int64_t n, int64_t n_out, int g, float acc,
                             int64_t from, float* __restrict__ out,
                             float (*ring)[kTile], int lane) {
  const int64_t e = run_end(gid, from, n, g, lane);
  if (e > from) {
    const int64_t last = (e - 1) / kChunk;
    int64_t j = from / kChunk;
    while (j <= last) {
      const int64_t a = next_flag(flags, j, last, true, lane);
      if (a > last) break;
      const int64_t b = next_flag(flags, a + 1, last, false, lane);
      acc = stream_sum(values, a * kChunk, lmin(b * kChunk, e), acc, ring,
                       lane);
      j = b + 1;
    }
  }
  if (lane == 0 && g >= 0 && g < n_out) out[g] = acc;
}

__global__ void __launch_bounds__(kThreads, 2)
    seg_walk_kernel(const float* __restrict__ values,
                    const int* __restrict__ gid, int64_t n, int64_t n_out,
                    float* __restrict__ out,
                    const unsigned char* __restrict__ flags) {
  __shared__ __align__(16) WalkSmem S;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int len = static_cast<int>(lmin(kChunk, n - c0));
  const int64_t c1 = c0 + len;
  const int gprev = c0 > 0 ? __ldg(gid + c0 - 1) : -1;
  const int glast = __ldg(gid + c1 - 1);
  if (c0 > 0 && gprev == glast) return;   // no run starts here
  const bool cont = c1 < n && __ldg(gid + c1) == glast;
  if (!flags[blockIdx.x]) {
    // every value is +0.0: the runs that end here sum to +0.0, which prep
    // wrote; the last run may still gain members past the chunk
    if (cont && warp == 0)
      continue_run(values, gid, flags, n, n_out, glast, 0.0f, c1, out,
                   S.ring, lane);
    return;
  }

  // stage the chunk (the tail past len is zero-filled)
#pragma unroll
  for (int k = 0; k < kPer / 4; ++k) {
    const int p = 4 * (tid + k * kThreads);
    const int left = len - p;
    const int bytes = left >= 4 ? 16 : (left > 0 ? left * 4 : 0);
    cp_async16(&S.v[p], bytes ? values + c0 + p : values, bytes);
    cp_async16(&S.g[p], bytes ? gid + c0 + p : gid, bytes);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // heads and non-+0.0 blocks of this thread's kPer positions
  const int base = tid * kPer;
  unsigned hmask = 0u;
  bool nz = false;
  {
    const int4 ga = *reinterpret_cast<const int4*>(&S.g[base]);
    const int4 gb = *reinterpret_cast<const int4*>(&S.g[base + 4]);
    const uint4 va = *reinterpret_cast<const uint4*>(&S.v[base]);
    const uint4 vb = *reinterpret_cast<const uint4*>(&S.v[base + 4]);
    const int gs[kPer] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
    const unsigned vs[kPer] = {va.x, va.y, va.z, va.w,
                               vb.x, vb.y, vb.z, vb.w};
    int prev = base == 0 ? gprev : S.g[base - 1];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (base + i < len) {
        hmask |= static_cast<unsigned>(gs[i] != prev) << i;
        nz |= vs[i] != 0u;
      }
      prev = gs[i];
    }
  }
  // 4 threads per 32-position block: one byte of block bits per warp
  const unsigned nzw = __ballot_sync(kFull, nz);
  const int cnt = __popc(hmask);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) {
    S.warp_heads[warp] = incl;
    unsigned byte = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      byte |= static_cast<unsigned>(((nzw >> (4 * k)) & 0xfu) != 0u) << k;
    S.warp_nz[warp] = static_cast<unsigned char>(byte);
  }
  __syncthreads();
  int off = 0, n_heads = 0;
  unsigned long long nzmap = 0ull;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int h = S.warp_heads[w];
    off += w < warp ? h : 0;
    n_heads += h;
    nzmap |= static_cast<unsigned long long>(S.warp_nz[w]) << (8 * w);
  }
  off += incl - cnt;
  for (unsigned m = hmask; m; m &= m - 1) S.heads[off++] = base + __ffs(m) - 1;
  __syncthreads();

  // runs that end in the chunk: one thread each (warp 0 is kept for the
  // continuing run when there is one)
  const int n_plain = cont ? n_heads - 1 : n_heads;
  if (cont && warp == 0) {
    float acc = 0.0f;
    if (lane == 0) acc = sum_smem(S.v, S.heads[n_heads - 1], len, nzmap, acc);
    continue_run(values, gid, flags, n, n_out, glast, acc, c1, out, S.ring,
                 lane);
    return;
  }
  const int first = cont ? tid - 32 : tid;
  const int stride = cont ? kThreads - 32 : kThreads;
  for (int r = first; r < n_plain; r += stride) {
    const int lo = S.heads[r];
    const int hi = r + 1 < n_heads ? S.heads[r + 1] : len;
    const float acc = sum_smem(S.v, lo, hi, nzmap, 0.0f);
    const int g = S.g[lo];
    if (g >= 0 && g < n_out) out[g] = acc;
  }
}

}  // namespace

// values: device float32 [n]; gid: device int32 [n], nondecreasing; out:
// device float32 [n_out]; flags: device bytes, at least ceil(n / 2048)
// rounded up to a multiple of 512. values, gid, out and flags 16-byte
// aligned; n and n_out below 2^31. Launches two kernels on `stream` and
// returns cudaGetLastError() so the caller sees a refused launch.
extern "C" int mt_segment_sum_ordered(const void* values, const void* gid,
                                      int64_t n, int64_t n_out, void* out,
                                      void* flags, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  const int64_t fill = (n_out + kChunk - 1) / kChunk;
  const int64_t grid = n_chunks > fill ? n_chunks : fill;
  seg_prep_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const float*>(values), n, n_out, static_cast<float*>(out),
      static_cast<unsigned char*>(flags));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  seg_walk_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0, s>>>(
      static_cast<const float*>(values), static_cast<const int*>(gid), n,
      n_out, static_cast<float*>(out),
      static_cast<const unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}
