// Kernel #4: integer scoring + bucketed candidate keys for the block tier.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_int8_bucketed_kernel`
// (pallas_call in `_int8_bucketed_keys`), which feeds 0/1 planes and the
// int8 query operand to the TPU's int8 MXU. Each row's integer score, the
// sum of the int8 query weights over its set bits, is spliced into an
// int32 key, (score << 10) | (row % 1024); rows >= num_rows get INT32_MIN.
// The keys of each 1024-row block are max-folded to kb = 1024 / bucket
// keys, local rows l and l' sharing key slot l % kb, as JAX's halving fold
// groups them. Only the keys [n_pad / bucket, B] reach device memory.
//
// Bound on the H100: bytes, the packed rows read once (1 GiB for one
// 262,144-row block at V' = 29,523). The design is kernel #3's
// (bucketed.cu) with the int8 operand: the bit walk of bitrow.cuh reads
// one contiguous 32-byte run of the [VP, B_pad] int8 operand per set bit
// (1 MB at B = 32, L2-resident) and sums in int32, so the kernel, its
// plain version and the TPU kernel agree bit for bit with any weights.
// One block owns one 1024-row block and one 32-query tile; each of its 8
// warps owns kb / 8 key slots and keeps their running max in a register.
// The shift runs on uint32_t: a left shift of a negative int is undefined
// in C++, while JAX's int32 shift wraps, as the unsigned one does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

namespace {

constexpr int kRowBlock = 1024;
constexpr int kKeyShift = 10;  // log2(kRowBlock): low bits hold the row
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
int8_bucketed_kernel(const uint32_t* __restrict__ words,
                     const int8_t* __restrict__ q8T,
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
      const int s =
          vs::row_score(words + r * num_words, num_words, q8T + q, b_pad);
      const int key =
          (int)(((uint32_t)s << kKeyShift) | (uint32_t)local);
      best = max(best, key);
    }
    if (q < b) keys[((int64_t)blockIdx.x * kb + slot) * b + q] = best;
  }
}

}  // namespace

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0), q8T [VP, b_pad]
// int8 (b_pad % 32 == 0), keys [n_pad / bucket, b] int32 with kb = 1024 /
// bucket a multiple of 8. Returns cudaGetLastError().
extern "C" int vs_int8_bucketed_keys(const void* words, const void* q8T,
                                     void* keys, long long n_pad,
                                     long long num_rows, int num_words,
                                     int b, int b_pad, int kb,
                                     void* stream) {
  if (n_pad <= 0 || b <= 0) return 0;
  const dim3 grid((unsigned)(n_pad / kRowBlock), (unsigned)(b_pad / 32));
  int8_bucketed_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int8_t*)q8T, (int32_t*)keys, num_rows,
      num_words, b, b_pad, kb);
  return (int)cudaGetLastError();
}
