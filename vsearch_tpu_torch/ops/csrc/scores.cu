// Kernel #2: exact bit-plane scores, scores[r, b] = sum_v bit(r, v) * q[v, b].
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_kernel` + `_accumulate_scores`
// (pallas_call in `bitpack_scores`), which extracts 0/1 planes on the VPU
// and feeds 128-wide bf16 dots to the MXU.
//
// Bound on the H100: bytes, the packed rows read once (4 KB a row at V' =
// 29,523: 1 GiB for the tiers' 262,144-row block) and the f32 scores
// written once (128 B a row at B = 32). The work is ~nnz adds a row and
// query, far below the f32 rate; the dense product would do V'/nnz ~ 230x
// more operations on the tensor cores, so the kernel sums set bits only.
//
// What held the first port back was latency, not bytes: one warp a row
// walked its set bits one at a time, each L2 gather of the query operand
// feeding the next add, so a warp had about one gather in flight and
// streamed no row bytes while it walked (34% of the bound at 65,536 rows).
// The design now is the decode-then-gather core of kernels #3 and #4
// (bitrow.cuh `score_rows`): one warp a pair of consecutive rows (32,768
// warps at 65,536 rows), each row decoded into a list of operand offsets
// in shared memory, then summed with 8 independent gathers in flight a
// lane, each 4-byte load carrying two queries' weights (`PairSum`). Each
// query sums its row's set bits in word order, then bit order, as #3 does,
// so #3's keys are #2's scores spliced and folded, bit for bit, and under
// dyadic weights both equal the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

// Warp w of CTA x scores rows 2 * (x * kWarps + w) and the next (grid_x
// from the Python wrapper's `score_geometry`); blockIdx.y tiles the
// queries by 32. Lane (h, s) = (lane / 16, lane % 16) holds queries 2s and
// 2s + 1 of row h of the pair and writes them: one 128-byte run a row and
// tile.
extern "C" __global__ void __launch_bounds__(vs::kWarps * 32)
    scores_kernel(const uint32_t* __restrict__ words,
                  const __nv_bfloat16* __restrict__ qT,
                  float* __restrict__ out, long long n_pad, int num_words,
                  int b, int b_pad) {
  __shared__ __align__(16) int lists[vs::kWarps][vs::kListCap];
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = 2 * ((int64_t)blockIdx.x * vs::kWarps + warp);
  if (row0 >= n_pad) return;  // warp-uniform
  const int rows = (int)min(2LL, n_pad - row0);
  vs::PairSum sum(qT + blockIdx.y * 32);
  vs::score_rows(sum, words, row0, 1, rows, num_words, lists[warp], b_pad);
  const int h = (threadIdx.x >> 4) & 1;
  const int q = blockIdx.y * 32 + 2 * (threadIdx.x & 15);
  if (h >= rows || q >= b) return;
  float* o = out + (row0 + h) * b + q;
  if (!(b & 1)) {  // q and b even: an aligned pair
    *reinterpret_cast<float2*>(o) = make_float2(sum.acc[0], sum.acc[1]);
  } else {
    o[0] = sum.acc[0];
    if (q + 1 < b) o[1] = sum.acc[1];
  }
}

// words [n_pad, num_words] uint32 (num_words % 128 == 0, 16-byte aligned),
// qT [VP, b_pad] bf16 (b_pad % 32 == 0, columns >= b zero, 16-byte
// aligned), out [n_pad, b] f32. grid_x comes from `score_geometry`.
// Returns a cudaError_t.
extern "C" int vs_bitpack_scores(const void* words, const void* qT,
                                 void* out, long long n_pad, int num_words,
                                 int b, int b_pad, int grid_x, void* stream) {
  if (grid_x <= 0 || n_pad <= 0 || b <= 0) return 0;
  scores_kernel<<<dim3((unsigned)grid_x, (unsigned)(b_pad / 32)),
                  vs::kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const __nv_bfloat16*)qT, (float*)out, n_pad,
      num_words, b, b_pad);
  return (int)cudaGetLastError();
}

VS_OCCUPANCY_ENTRY(vs_bitpack_scores, scores_kernel)
