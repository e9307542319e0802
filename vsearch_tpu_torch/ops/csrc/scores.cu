// Kernel #2: exact bit-plane scores, scores[r, b] = sum_v bit(r, v) * q[v, b].
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_kernel` + `_accumulate_scores`
// (pallas_call in `bitpack_scores`), which extracts 0/1 planes on the VPU
// and feeds 128-wide bf16 dots to the MXU.
//
// Bound on the H100: bytes. The packed rows (4 KB each at V' = 29,523) are
// read once; the work is ~nnz adds per row and query, far below the f32
// rate. The dense product would do V'/nnz ~ 230x more operations on the
// tensor cores, so the design walks set bits instead (bitrow.cuh): one
// warp per row, lane t = query t of a 32-query tile, no reduction across
// lanes, one coalesced 128-byte store per row and tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scores_kernel(const uint32_t* __restrict__ words,
              const __nv_bfloat16* __restrict__ qT,
              float* __restrict__ out, int64_t n_pad, int num_words, int b,
              int b_pad) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_pad) return;  // uniform across the warp
  const int q = blockIdx.y * 32 + lane;
  const float acc =
      vs::row_score(words + row * num_words, num_words, qT + q, b_pad);
  if (q < b) out[row * b + q] = acc;
}

}  // namespace

// words [n_pad, num_words] uint32, qT [VP, b_pad] bf16 (b_pad % 32 == 0,
// columns >= b zero), out [n_pad, b] f32. Returns cudaGetLastError().
extern "C" int vs_bitpack_scores(const void* words, const void* qT,
                                 void* out, long long n_pad, int num_words,
                                 int b, int b_pad, void* stream) {
  if (n_pad <= 0 || b <= 0) return 0;
  const dim3 grid((unsigned)((n_pad + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)(b_pad / 32));
  scores_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const __nv_bfloat16*)qT, (float*)out, n_pad,
      num_words, b, b_pad);
  return (int)cudaGetLastError();
}
