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
// Bound: bytes, the words read once and the halves written once: 0.160 ms
// at [65,536, 1,024] (512 MiB at 3.35 TB/s); at the probe's [8, 128] (8
// KB) the launch, and the host's part of a call (cuda_build.launch) with it.
//
// Design. A thread takes 4 words of a row: one 16-byte streaming load
// (__ldcs), and its 4 low halves and 4 high halves each one 8-byte store,
// to rows 2s and 2s + 1; a warp thus reads 512 contiguous bytes and
// writes two runs of 256. When l is not a multiple of 4 (or the tensors
// lie off 16 and 8 bytes) the rows are not aligned for that: each thread
// then moves its 4 words one at a time, the ragged end of a row masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
bitcast_rows_kernel(const uint32_t* __restrict__ x,
                    uint16_t* __restrict__ out, long long s, int l) {
  const int quads = (l + 3) / 4;  // 4-word groups a row
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= s * quads) return;
  const long long row = i / quads;
  const int col = (int)(i % quads) * 4;
  uint16_t* lo = out + (2 * row) * l + col;
  uint16_t* hi = lo + l;
  if (kAligned) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(x + row * l + col));
    const uint2 vlo = make_uint2((w.x & 0xffffu) | (w.y << 16),
                                 (w.z & 0xffffu) | (w.w << 16));
    const uint2 vhi = make_uint2((w.x >> 16) | (w.y & 0xffff0000u),
                                 (w.z >> 16) | (w.w & 0xffff0000u));
    __stcs(reinterpret_cast<uint2*>(lo), vlo);
    __stcs(reinterpret_cast<uint2*>(hi), vhi);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col + k >= l) break;
      const uint32_t w = __ldcs(x + row * l + col + k);
      lo[k] = (uint16_t)(w & 0xffffu);
      hi[k] = (uint16_t)(w >> 16);
    }
  }
}

}  // namespace

// x [s, l] uint32 -> out [2 s, l] bf16 (16-bit patterns). Returns
// cudaGetLastError().
extern "C" int vs_bitcast_rows(const void* x, void* out, long long s, int l,
                               void* stream) {
  const long long n = s * ((l + 3) / 4);
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  if (l % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 8 == 0)
    bitcast_rows_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint16_t*)out, s, l);
  else
    bitcast_rows_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint16_t*)out, s, l);
  return (int)cudaGetLastError();
}
