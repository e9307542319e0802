// Kernel #3: fused scoring + bucketed candidate keys.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_bucketed_kernel` (pallas_call
// in `_bucketed_keys`). Each row's score is spliced into an int32 key,
// (bits(max(score, 0)) & ~1023) | (row % 1024), rows >= num_rows get
// INT32_MIN, and the keys of each 1024-row block are max-folded to kb =
// 1024 / bucket keys: local rows l and l' share key slot l % kb. Only the
// keys [n_pad / bucket, B] reach device memory.
//
// Bound on the H100: bytes, the packed rows read once (4 GiB at 1,048,576
// rows and V' = 29,523). Scoring is kernel #2's bit walk (bitrow.cuh).
// The fold needs no atomics and no shared memory: one block owns one
// 1024-row block and one 32-query tile, and each of its 8 warps owns
// kb / 8 key slots, walking the `bucket` rows of each slot and keeping the
// running max in a register. The grouping of rows into buckets is exactly
// the JAX one, whatever the block shape, so candidate sets match.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

namespace {

constexpr int kRowBlock = 1024;
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
bucketed_kernel(const uint32_t* __restrict__ words,
                const __nv_bfloat16* __restrict__ qT,
                int32_t* __restrict__ keys, long long num_rows,
                int num_words, int b, int b_pad, int kb) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * kRowBlock;
  const int q = blockIdx.y * 32 + lane;
  const int slots_per_warp = kb / kWarps;
  const int bucket = kRowBlock / kb;
  for (int i = 0; i < slots_per_warp; ++i) {
    const int slot = warp * slots_per_warp + i;
    int best = INT32_MIN;
    for (int j = 0; j < bucket; ++j) {
      const int local = j * kb + slot;
      const int64_t r = row0 + local;
      if (r >= num_rows) continue;  // uniform across the warp
      const float s =
          vs::row_score(words + r * num_words, num_words, qT + q, b_pad);
      const int key =
          (__float_as_int(fmaxf(s, 0.f)) & ~(kRowBlock - 1)) | local;
      best = max(best, key);
    }
    if (q < b) keys[((int64_t)blockIdx.x * kb + slot) * b + q] = best;
  }
}

}  // namespace

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0), qT [VP, b_pad] bf16
// (b_pad % 32 == 0), keys [n_pad / bucket, b] int32 with kb = 1024 /
// bucket a multiple of 8. Returns cudaGetLastError().
extern "C" int vs_bucketed_keys(const void* words, const void* qT,
                                void* keys, long long n_pad,
                                long long num_rows, int num_words, int b,
                                int b_pad, int kb, void* stream) {
  if (n_pad <= 0 || b <= 0) return 0;
  const dim3 grid((unsigned)(n_pad / kRowBlock), (unsigned)(b_pad / 32));
  bucketed_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const __nv_bfloat16*)qT, (int32_t*)keys,
      num_rows, num_words, b, b_pad, kb);
  return (int)cudaGetLastError();
}
