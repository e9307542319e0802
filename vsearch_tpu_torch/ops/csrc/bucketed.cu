// Kernel #3: fused scoring + bucketed candidate keys.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_bucketed_kernel` (pallas_call
// in `_bucketed_keys`), which extracts 0/1 planes on the TPU's VPU and
// feeds bf16 dots to its MXU. Each row's score is spliced into an int32
// key, (bits(max(score, 0)) & ~1023) | (row % 1024), rows >= num_rows get
// INT32_MIN, and the keys of each 1024-row block are max-folded to kb =
// 1024 / bucket keys: local rows l and l' share key slot l % kb. Only the
// keys [n_pad / bucket, B] reach device memory.
//
// Bound on the H100: bytes, the packed rows read once (4 GiB at 1,048,576
// rows and V' = 29,523, 1 GiB for the stream tier's 262,144-row block).
// What held the first port back was latency, not bytes: one CTA per
// 1024-row block (256 CTAs of 8 warps at 262,144 rows, a quarter of the
// card's warp slots), and a bit walk with one dependent L2 gather in
// flight per warp, streaming no row bytes while it walked. The design now
// (bitrow.cuh, `fold_slot`): one warp per key slot, so 16,384-32,768
// warps at 262,144 rows; each row is decoded into a list of
// query-operand offsets in shared memory, then summed with 8
// independent gathers in flight a lane, a warp summing two rows at once
// and each 4-byte load carrying two queries' weights (`PairSum`). Each
// query still sums its row's set bits in word order, then bit order, the
// first port's order, so keys are bit-identical to it and, under dyadic
// weights, to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

namespace {

// (bits(max(s, 0)) & ~1023) | local
struct F32Splice {
  __device__ __forceinline__ int operator()(float s, int local) const {
    return (__float_as_int(fmaxf(s, 0.f)) & ~(vs::kRowBlock - 1)) | local;
  }
};

}  // namespace

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0, num_words % 128 ==
// 0, 16-byte aligned), qT [VP, b_pad] bf16 (b_pad % 32 == 0), keys
// [n_pad / bucket, b] int32 with kb = 1024 / bucket. grid_x comes from
// the Python wrapper's `fold_geometry`. Returns a cudaError_t.
VS_FOLD_ENTRY(vs_bucketed_keys, bucketed_kernel, F32Splice)
