// P1: the uint32 -> bf16 row layout of scripts/probe_bitcast_layout.py.
//
// Replaces scripts/probe_bitcast_layout.py `kernel` (pallas_call in
// `main`), which asked where pltpu.bitcast(x [S, L] uint32, bf16) puts the
// two 16-bit halves of word (s, l) in its [2S, L] output; the TPU answered
// layout A (probe_scorer_variants.py:20-24): the low half at row 2s, the
// high half at row 2s + 1. CUDA has no such primitive and no sublanes: a
// bf16 is 16 bits of memory wherever the kernel writes it. So this kernel
// writes layout A by hand, and what it checks on the card is the port's own
// convention (the halves, in that order), not the hardware.
//
// One thread per word. Bound: bytes, the words read once and the halves
// written once (32 KB at the probe's [8, 128]: launch latency).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitcast_rows_kernel(const uint32_t* __restrict__ x,
                    uint16_t* __restrict__ out, long long s, int l) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= s * l) return;
  const long long row = i / l;
  const int col = (int)(i % l);
  const uint32_t w = x[i];
  out[(2 * row) * l + col] = (uint16_t)(w & 0xffffu);
  out[(2 * row + 1) * l + col] = (uint16_t)(w >> 16);
}

}  // namespace

// x [s, l] uint32 -> out [2 s, l] bf16 (16-bit patterns). Returns
// cudaGetLastError().
extern "C" int vs_bitcast_rows(const void* x, void* out, long long s, int l,
                               void* stream) {
  const long long n = s * l;
  if (n <= 0) return 0;
  bitcast_rows_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                        0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint16_t*)out, s, l);
  return (int)cudaGetLastError();
}
