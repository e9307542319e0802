// Shared device code for the bit-packed scorers (scores.cu, bucketed.cu).
//
// Packed layout (the JAX package's, vsearch_tpu/ops/bitpack.py): vocab id
// v lives in word (v / 4096) * 128 + v % 128, bit (v % 4096) / 128, so a
// row of V' = 29,523 columns is 1,024 uint32 words (4 KB).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace vs {

constexpr int kTileBits = 4096;
constexpr int kLanes = 128;
constexpr unsigned kFullMask = 0xffffffffu;
// 32-word chunks loaded before any is walked: 8 coalesced 128-byte loads
// in flight per warp keep enough bytes moving to feed device memory.
constexpr int kUnroll = 8;

// Sum over the set bits v of one packed row of qcol[v * stride], in f32.
//
// The whole warp walks the same row: each lane loads every 32nd word, a
// ballot finds the nonzero words, and each one is broadcast and walked bit
// by bit with __ffs. Lane t reads its own query column (qcol points at
// query t of the tile), so the warp's 32 reads for one bit are one
// contiguous 64-byte run of the [VP, B_pad] bf16 query operand, which sits
// in L2 (2 MB at B = 32). A bag-of-token row has at most nnz_pad set bits,
// so the cost is the 4 KB row read plus ~nnz short gathers.
//
// Summation runs in word order then bit order, not in vocab order as the
// TPU's per-plane dots do: results agree to f32 rounding, and exactly
// when every query weight is dyadic with few significant bits.
__device__ __forceinline__ float row_score(
    const uint32_t* __restrict__ row, int num_words,
    const __nv_bfloat16* __restrict__ qcol, int stride) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int base = 0; base < num_words; base += 32 * kUnroll) {
    uint32_t w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * 32 + lane;
      w[u] = idx < num_words ? __ldg(row + idx) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint32_t nz = __ballot_sync(kFullMask, w[u] != 0u);
      while (nz) {
        const int src = __ffs(nz) - 1;
        nz &= nz - 1;
        uint32_t word = __shfl_sync(kFullMask, w[u], src);
        const int widx = base + u * 32 + src;
        const int vbase = (widx >> 7) * kTileBits + (widx & (kLanes - 1));
        while (word) {
          const int p = __ffs(word) - 1;
          word &= word - 1;
          acc += __bfloat162float(
              qcol[(int64_t)(vbase + p * kLanes) * stride]);
        }
      }
    }
  }
  return acc;
}

}  // namespace vs
