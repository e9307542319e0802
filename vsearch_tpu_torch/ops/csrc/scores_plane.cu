// Kernel #2 in the plane form: exact bit-plane scores of dense rows,
// scores[r, b] = sum_v bit(r, v) * q[v, b], on the tensor cores.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_kernel` + `_accumulate_scores`
// (pallas_call in `bitpack_scores`) for rows at or above the crossover
// width in matrices of enough rows to fill the card (bitpack.row_form);
// scores.cu keeps the others. The row core is planes.cuh `plane_rows`
// (its note gives the design): its work is 2 x 128 x 32 bf16 operations a
// plane below num_cols and a row on the tensor cores, whatever the row's
// density.
#include <cuda_runtime.h>
#include <stdint.h>

#include "planes.cuh"

// CTA x scores rows 256 x .. 256 x + 255 (one pass); blockIdx.y tiles the
// queries by 32. Each thread writes its two rows' 8 queries as float2
// pairs where b is even.
extern "C" __global__ void __launch_bounds__(vs::kPlaneThreads, 1)
    scores_plane_kernel(const uint32_t* __restrict__ words,
                        const uint8_t* __restrict__ qI,
                        float* __restrict__ out, long long n_pad,
                        int num_words, int nplanes, int b) {
  const int q0 = blockIdx.y * vs::kPlaneN + 2 * (threadIdx.x & 3);
  vs::plane_rows(
      words, qI, n_pad, num_words, nplanes,
      (long long)blockIdx.x * vs::kPlaneRows, 1,
      [&](long long row, const float (&acc)[16]) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const long long r = row + 8 * e2;
          if (r >= n_pad) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int q = q0 + 8 * j;
            const float s0 = acc[4 * j + 2 * e2] * 0.5f;
            const float s1 = acc[4 * j + 2 * e2 + 1] * 0.5f;
            float* o = out + r * b + q;
            if (!(b & 1) && q < b) {
              *reinterpret_cast<float2*>(o) = make_float2(s0, s1);
            } else {
              if (q < b) o[0] = s0;
              if (q + 1 < b) o[1] = s1;
            }
          }
        }
      });
}

// words [n_pad, num_words] uint32 (num_words % 128 == 0, 16-byte aligned),
// qI [b_pad / 32, 2 * nplanes, 4 KB] (bitpack._plane_operand: queries >=
// b zero, 16-byte aligned), out [n_pad, b] f32. nplanes (even) and grid_x
// come from `plane_geometry`. Returns a cudaError_t.
extern "C" int vs_bitpack_scores_plane(const void* words, const void* qI,
                                       void* out, long long n_pad,
                                       int num_words, int nplanes, int b,
                                       int b_pad, int grid_x, void* stream) {
  if (grid_x <= 0 || n_pad <= 0 || b <= 0) return 0;
  VS_PLANE_LAUNCH(scores_plane_kernel,
                  dim3((unsigned)grid_x, (unsigned)(b_pad / 32)),
                  (cudaStream_t)stream,
      (const uint32_t*)words, (const uint8_t*)qI, (float*)out, n_pad,
      num_words, nplanes, b);
  return (int)cudaGetLastError();
}

VS_PLANE_OCCUPANCY_ENTRY(vs_bitpack_scores_plane, scores_plane_kernel)
