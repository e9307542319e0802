// Kernel #3 in the plane form: fused scoring + bucketed candidate keys of
// dense rows, on the tensor cores.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_bucketed_kernel` (pallas_call
// in `_bucketed_keys`) for rows at or above the crossover width in
// matrices of enough rows to fill the card (bitpack.row_form); bucketed.cu
// keeps the others. The keys
// are bucketed.cu's: (bits(max(score, 0)) & ~1023) | (row % 1024), rows >=
// num_rows INT32_MIN, each 1024-row block max-folded to kb = 1024 / bucket
// slots, local rows l and l' sharing slot l % kb. The row core is
// planes.cuh `plane_rows` (its note gives the design).
//
// The fold: `split` CTAs share a 1024-row block (bitpack.plane_geometry:
// 1 once there are enough blocks to fill the card, up to 4 on small
// indexes), each running 4 / split passes of 256 rows. A pass's keys go to
// the CTA's kb x 32 slots in shared memory (atomicMax: integer, so the
// order does not matter), and after its last pass the CTA writes them
// once, or, where the block is split, max-folds them into keys prefilled
// with INT32_MIN (atomicMax in device memory). Only the keys reach device
// memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"
#include "planes.cuh"

// CTA x runs block x / split, part x % split; blockIdx.y tiles the queries
// by 32.
extern "C" __global__ void __launch_bounds__(vs::kPlaneThreads, 1)
    bucketed_plane_kernel(const uint32_t* __restrict__ words,
                          const uint8_t* __restrict__ qI,
                          int32_t* __restrict__ keys, long long num_rows,
                          long long n_pad, int num_words, int nplanes,
                          int b, int kb, int split) {
  __shared__ int best[vs::kRowBlock / 8][vs::kPlaneN];
  for (int i = threadIdx.x; i < kb * vs::kPlaneN; i += vs::kPlaneThreads)
    best[i / vs::kPlaneN][i % vs::kPlaneN] = INT32_MIN;
  __syncthreads();
  const long long block = blockIdx.x / split;
  const int part = blockIdx.x % split;
  const int rows_per_cta = vs::kRowBlock / split;
  const long long block_row = block * vs::kRowBlock;
  const int tig2 = 2 * (threadIdx.x & 3);
  vs::plane_rows(
      words, qI, n_pad, num_words, nplanes,
      block_row + (long long)part * rows_per_cta,
      rows_per_cta / vs::kPlaneRows,
      [&](long long row, const float (&acc)[16]) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const long long r = row + 8 * e2;
          if (r >= num_rows) continue;
          const int local = (int)(r - block_row);
          int* slot = best[local & (kb - 1)];
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s = acc[4 * j + 2 * e2 + e] * 0.5f;
              atomicMax(&slot[8 * j + tig2 + e],
                        (__float_as_int(fmaxf(s, 0.f)) &
                         ~(vs::kRowBlock - 1)) |
                            local);
            }
        }
      });
  if (threadIdx.x >= vs::kPlaneConsumers) return;  // the producer warp
  vs::consumers_sync();
  for (int i = threadIdx.x; i < kb * vs::kPlaneN; i += vs::kPlaneConsumers) {
    const int s = i / vs::kPlaneN, qq = i % vs::kPlaneN;
    const int q = blockIdx.y * vs::kPlaneN + qq;
    if (q >= b) continue;
    int32_t* o = keys + (block * kb + s) * b + q;
    if (split == 1)
      *o = best[s][qq];
    else
      atomicMax(o, best[s][qq]);
  }
}

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0, num_words % 128 ==
// 0, 16-byte aligned), qI [b_pad / 32, 2 * nplanes, 4 KB]
// (bitpack._plane_operand), keys [n_pad / bucket, b] int32 (prefilled
// with INT32_MIN when split > 1) with kb = 1024 / bucket. nplanes (even),
// grid_x and split come from `plane_geometry`. Returns a cudaError_t.
extern "C" int vs_bucketed_keys_plane(const void* words, const void* qI,
                                      void* keys, long long num_rows,
                                      long long n_pad, int num_words,
                                      int nplanes, int b, int b_pad, int kb,
                                      int split, int grid_x, void* stream) {
  if (grid_x <= 0 || b <= 0) return 0;
  VS_PLANE_LAUNCH(bucketed_plane_kernel,
                  dim3((unsigned)grid_x, (unsigned)(b_pad / 32)),
                  (cudaStream_t)stream,
      (const uint32_t*)words, (const uint8_t*)qI, (int32_t*)keys, num_rows,
      n_pad, num_words, nplanes, b, kb, split);
  return (int)cudaGetLastError();
}

VS_PLANE_OCCUPANCY_ENTRY(vs_bucketed_keys_plane, bucketed_plane_kernel)
