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
// 262,144-row block at V' = 29,523). The first port ran at 15% of that
// bound, held back by latency: one CTA per 1024-row block (256 CTAs at
// 262,144 rows, a quarter of the card's warp slots), and a bit walk with
// one dependent L2 gather of the operand (32 bytes a set bit) in flight
// per warp, streaming no row bytes while it walked. The design now
// (bitrow.cuh, `fold_slot`, shared with kernel #3): one warp per key slot
// (16,384 warps at bucket 16), its rows read with 16-byte streaming loads,
// each row's set bits decoded into a list of operand offsets in shared
// memory, then summed with 8 independent gathers in flight a lane, each
// 4-byte load carrying four queries' weights (`QuadSum`). Sums are int32,
// so the kernel, its plain version and the TPU kernel agree bit for bit
// with any weights. The shift runs on uint32_t: a left shift of a
// negative int is undefined in C++, while JAX's int32 shift wraps, as the
// unsigned one does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

namespace {

constexpr int kKeyShift = 10;  // log2(kRowBlock): low bits hold the row

// (s << 10) | local, wrapping
struct Int8Splice {
  __device__ __forceinline__ int operator()(int s, int local) const {
    return (int)(((uint32_t)s << kKeyShift) | (uint32_t)local);
  }
};

}  // namespace

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0, num_words % 128 ==
// 0, 16-byte aligned), q8T [VP, b_pad] int8 (b_pad % 32 == 0), keys
// [n_pad / bucket, b] int32 with kb = 1024 / bucket. grid_x comes from
// the Python wrapper's `fold_geometry`. Returns a cudaError_t.
VS_FOLD_ENTRY(vs_int8_bucketed_keys, int8_bucketed_kernel, int8_t,
              Int8Splice)
