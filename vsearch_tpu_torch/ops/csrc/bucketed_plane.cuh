// The fold of kernel #3's plane form (bucketed_plane.cu): the kernel body
// over `plane_rows`, shared with the plane form's timing probes
// (plane_operand_only.cu, plane_fragments_only.cu), which instantiate it
// with their own variant of the pass (planes.cuh).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"
#include "planes.cuh"

namespace vs {

// CTA x runs block x / split, part x % split; blockIdx.y tiles the queries
// by 32.
template <int kVariant>
__device__ __forceinline__ void bucketed_plane_fold(
    const uint32_t* __restrict__ words, const uint8_t* __restrict__ qI,
    int32_t* __restrict__ keys, long long num_rows, long long n_pad,
    int num_words, int nplanes, int b, int kb, int split) {
  __shared__ int best[kRowBlock / 8][kPlaneN];
  for (int i = threadIdx.x; i < kb * kPlaneN; i += kPlaneThreads)
    best[i / kPlaneN][i % kPlaneN] = INT32_MIN;
  __syncthreads();
  const long long block = blockIdx.x / split;
  const int part = blockIdx.x % split;
  const int rows_per_cta = kRowBlock / split;
  const long long block_row = block * kRowBlock;
  const int tig2 = 2 * (threadIdx.x & 3);
  plane_rows<kVariant>(
      words, qI, n_pad, num_words, nplanes,
      block_row + (long long)part * rows_per_cta, rows_per_cta / kPlaneRows,
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
                         ~(kRowBlock - 1)) |
                            local);
            }
        }
      });
  if (threadIdx.x >= kPlaneConsumers) return;  // the producer warp
  consumers_sync();
  for (int i = threadIdx.x; i < kb * kPlaneN; i += kPlaneConsumers) {
    const int s = i / kPlaneN, qq = i % kPlaneN;
    const int q = blockIdx.y * kPlaneN + qq;
    if (q >= b) continue;
    int32_t* o = keys + (block * kb + s) * b + q;
    if (split == 1)
      *o = best[s][qq];
    else
      atomicMax(o, best[s][qq]);
  }
}

}  // namespace vs

// The fold kernel of one variant of the pass (unmangled, so the ptxas
// report and the profiler name it), its C entry point and its occupancy
// entry. The entry takes (words, qI, keys, num_rows, n_pad, num_words,
// nplanes, b, b_pad, kb, split, grid_x, stream).
#define VS_BUCKETED_PLANE_ENTRY(entry, kernel, variant)                     \
  extern "C" __global__ void __launch_bounds__(vs::kPlaneThreads, 1) kernel( \
      const uint32_t* __restrict__ words, const uint8_t* __restrict__ qI,   \
      int32_t* __restrict__ keys, long long num_rows, long long n_pad,      \
      int num_words, int nplanes, int b, int kb, int split) {               \
    vs::bucketed_plane_fold<variant>(words, qI, keys, num_rows, n_pad,      \
                                     num_words, nplanes, b, kb, split);     \
  }                                                                         \
  extern "C" int entry(const void* words, const void* qI, void* keys,       \
                       long long num_rows, long long n_pad, int num_words,  \
                       int nplanes, int b, int b_pad, int kb, int split,    \
                       int grid_x, void* stream) {                          \
    if (grid_x <= 0 || b <= 0) return 0;                                    \
    VS_PLANE_LAUNCH(kernel, dim3((unsigned)grid_x, (unsigned)(b_pad / 32)), \
                    (cudaStream_t)stream, (const uint32_t*)words,           \
                    (const uint8_t*)qI, (int32_t*)keys, num_rows, n_pad,    \
                    num_words, nplanes, b, kb, split);                      \
    return (int)cudaGetLastError();                                         \
  }                                                                         \
  VS_PLANE_OCCUPANCY_ENTRY(entry, kernel)
