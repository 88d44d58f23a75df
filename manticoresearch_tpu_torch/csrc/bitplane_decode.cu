// Bit-plane posting decode for Hopper (sm_90a).
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
// Bound: device-memory bytes. A block reads 16c bytes of words (and 4 of
// base) and writes 512 bytes of values, so it reads c/32 of what it writes;
// the arithmetic is a shift, a mask and an OR per bit. The design keeps
// every global access coalesced and nothing else in the way:
// - one warp per block: the warp stages the block's 4c words in shared
//   memory with coalesced loads, then every lane reads each word as a
//   broadcast (all lanes read one address, no bank conflict);
// - lane t owns values t, t+32, t+64, t+96, i.e. bit t of word k of every
//   plane, so the four results go out as four coalesced 128-byte rows;
// - the prefix sum is a __shfl_up_sync scan over each 32-value segment,
//   with the running total carried from one segment to the next.
// Arithmetic is uint32, so sums wrap like the int32 cumsum of the JAX code.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kPlaneWords = 4;
constexpr int kWarpsPerCta = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarpsPerCta)
bitplane_decode_kernel(const uint32_t* __restrict__ words,
                       const int32_t* __restrict__ base,
                       int32_t* __restrict__ out,
                       int64_t nb, int c, int prefix) {
  __shared__ uint32_t stage[kWarpsPerCta][kPlaneWords * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + warp;
  if (blk >= nb) return;  // uniform across the warp

  const int n_words = kPlaneWords * c;
  const uint32_t* src = words + blk * n_words;
  for (int i = lane; i < n_words; i += 32) stage[warp][i] = src[i];
  __syncwarp();

  uint32_t v[kPlaneWords] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < c; ++j) {
#pragma unroll
    for (int k = 0; k < kPlaneWords; ++k) {
      v[k] |= ((stage[warp][kPlaneWords * j + k] >> lane) & 1u) << j;
    }
  }

  if (prefix) {
    uint32_t carry = static_cast<uint32_t>(base[blk]);
#pragma unroll
    for (int k = 0; k < kPlaneWords; ++k) {
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

  int32_t* dst = out + blk * kBlock;
#pragma unroll
  for (int k = 0; k < kPlaneWords; ++k) {
    dst[32 * k + lane] = static_cast<int32_t>(v[k]);
  }
}

}  // namespace

// words: [nb, 4c] uint32 bits (an int32 tensor), base: [nb] int32 or null
// when prefix == 0, out: [nb, 128] int32. Launches on `stream` and returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int mt_bitplane_decode(const void* words, const void* base,
                                  void* out, int64_t nb, int c, int prefix,
                                  void* stream) {
  if (nb <= 0) return static_cast<int>(cudaSuccess);
  const int64_t grid = (nb + kWarpsPerCta - 1) / kWarpsPerCta;
  bitplane_decode_kernel<<<static_cast<unsigned>(grid), 32 * kWarpsPerCta, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(base),
      static_cast<int32_t*>(out), nb, c, prefix);
  return static_cast<int>(cudaGetLastError());
}
