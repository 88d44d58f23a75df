// Ordered float segment sum for Hopper (sm_90a): each group's float32 sum
// of its members, added one by one in index order from 0.0.
//
// Replaces manticoresearch_tpu/ops/groupby.py:143-148, the group-by tail's
// float SUM / AVG accumulator zeros(Z, f32).at[gid_scatter].add(...) (an
// XLA scatter, not a Pallas kernel). On the CPU that scatter adds each
// group's members left to right in sorted order; the card's PyTorch calls
// (index_add_ and scatter_add_ with atomics, cumsum's parallel scan,
// segment_reduce) keep no order, so a grouped SUM(float) or AVG would
// differ from the CPU by rounding and from run to run. This kernel gives
// the CPU's sum bit for bit: every add is __fadd_rn, in index order.
//
// Input: values f32[n] (the sorted members, ineligible entries included as
// the tail passes them), gid int32[n] with values in [0, n_out) (others
// are skipped). Output: out f32[n_out], 0.0 where no entry lands.
//
// Three launches on the caller's stream, no allocation (the wrapper passes
// bounds, int32[2 * n_out] of scratch):
// 1. init: out = 0, first = n, last = -1;
// 2. bounds: for each group, the first and last position holding a value
//    whose bits are not +0.0, by atomicMin / atomicMax (exact in any
//    order), one pair per run of equal ids within a warp (__match_any);
// 3. walk: one thread per group adds, in order, the values of its
//    positions between first and last (a position of another group in
//    between is skipped, so any layout of ids is summed right), kUnroll
//    loads in flight at a time.
// Skipping the +0.0 values outside [first, last] is exact: the sum starts
// at +0.0, and a sum is -0.0 only when both addends are, so it is never
// -0.0 and x + 0.0 == x for every x it can hold. That keeps the group-by
// sink (every ineligible row, all +0.0, up to the whole index) from being
// walked by one thread.
//
// Bound: bytes. 8 bytes read per position and 4 written per group, over
// 3.35 TB/s on an H100 SXM. The adds of one group are dependent, so a
// group's time is its member count times the latency of one add and its
// share of the loads: a group of a million members is a million dependent
// adds on one thread. A warp staging each run in shared memory for one
// adding lane would shorten that chain's load latency.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;

__global__ void seg_init_kernel(float* __restrict__ out,
                                int* __restrict__ first,
                                int* __restrict__ last, int n_out, int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_out;
       g += stride) {
    out[g] = 0.0f;
    first[g] = n;
    last[g] = -1;
  }
}

__global__ void seg_bounds_kernel(const float* __restrict__ values,
                                  const int* __restrict__ gid, int n,
                                  int n_out, int* __restrict__ first,
                                  int* __restrict__ last) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  // warp-uniform loop over 32-position chunks
  for (int base = warp * 32; base < n; base += n_warps * 32) {
    const int i = base + lane;
    int g = -1;
    bool live = false;
    if (i < n) {
      g = __ldg(gid + i);
      live = g >= 0 && g < n_out && __float_as_uint(__ldg(values + i)) != 0u;
    }
    const unsigned live_mask = __ballot_sync(0xffffffffu, live);
    if (live) {
      const unsigned peers = __match_any_sync(live_mask, g);
      if (lane == __ffs(peers) - 1) {
        atomicMin(first + g, base + lane);
        atomicMax(last + g, base + 31 - __clz(peers));
      }
    }
  }
}

__global__ void seg_walk_kernel(const float* __restrict__ values,
                                const int* __restrict__ gid,
                                const int* __restrict__ first,
                                const int* __restrict__ last, int n_out,
                                float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_out;
       g += stride) {
    int j = first[g];
    const int end = last[g] + 1;
    if (j >= end) continue;   // out[g] stays 0.0
    float acc = 0.0f;
    for (; j + kUnroll <= end; j += kUnroll) {
      float v[kUnroll];
      int k[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __ldg(values + j + u);
        k[u] = __ldg(gid + j + u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k[u] == g) acc = __fadd_rn(acc, v[u]);
      }
    }
    for (; j < end; ++j) {
      if (__ldg(gid + j) == g) acc = __fadd_rn(acc, __ldg(values + j));
    }
    out[g] = acc;
  }
}

int blocks_for(int64_t items) {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 16;
  const int64_t need = (items + kThreads - 1) / kThreads;
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

}  // namespace

// values: device float32 [n]; gid: device int32 [n]; out: device float32
// [n_out]; bounds: device int32 [2 * n_out] scratch. n and n_out below
// 2^31. Launches three kernels on `stream` and returns cudaGetLastError()
// so the caller sees a refused launch.
extern "C" int mt_segment_sum_ordered(const void* values, const void* gid,
                                      int64_t n, int64_t n_out, void* out,
                                      void* bounds, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* first = static_cast<int*>(bounds);
  int* last = first + n_out;
  const int no = static_cast<int>(n_out);
  const int ni = static_cast<int>(n);
  seg_init_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      static_cast<float*>(out), first, last, no, ni);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    seg_bounds_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(values), static_cast<const int*>(gid), ni,
        no, first, last);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  seg_walk_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(
      static_cast<const float*>(values), static_cast<const int*>(gid), first,
      last, no, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
