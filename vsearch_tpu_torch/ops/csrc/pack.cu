// Kernel #1: pack ELL rows into the bit matrix.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_pack_kernel` (pallas_call in
// `_pack_fn`). Column v of row r sets word (v / 4096) * 128 + v % 128, bit
// (v % 4096) / 128; slots j >= nnz[r] and columns outside [0, V) (the
// sentinel pad) are dropped; rows n .. n_pad - 1 are zero.
//
// Bound on the H100: bytes, the ELL read once and the packed rows written
// once (4 GiB of words at 1,048,576 rows and V' = 29,523, ~8x the ELL).
// One block owns one row: it clears the row in shared memory, ORs one bit
// per valid slot there (atomicOr; columns are unique within a row, so the
// result is exact whatever the order), then writes the row out with
// coalesced stores. Every word is written once and the output needs no
// prior memset.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ cols,
            const int32_t* __restrict__ nnz, uint32_t* __restrict__ out,
            long long n, int nnz_pad, int v, int num_words) {
  extern __shared__ uint32_t row_bits[];
  const int64_t r = blockIdx.x;
  for (int i = threadIdx.x; i < num_words; i += kThreads) row_bits[i] = 0u;
  __syncthreads();
  if (r < n) {
    const int cnt = min(nnz[r], nnz_pad);
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const int c = cols[r * nnz_pad + j];
      if (c >= 0 && c < v) {
        atomicOr(&row_bits[(c >> 12) * 128 + (c & 127)],
                 1u << ((c & 4095) >> 7));
      }
    }
  }
  __syncthreads();
  uint32_t* dst = out + r * num_words;
  for (int i = threadIdx.x; i < num_words; i += kThreads) dst[i] = row_bits[i];
}

}  // namespace

// cols [n, nnz_pad] int32, nnz [n] int32, out [n_pad, num_words] uint32
// (every word written). Returns cudaGetLastError().
extern "C" int vs_pack_ell(const void* cols, const void* nnz, void* out,
                           long long n, long long n_pad, int nnz_pad, int v,
                           int num_words, void* stream) {
  if (n_pad <= 0) return 0;
  const size_t smem = (size_t)num_words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pack_kernel<<<(unsigned)n_pad, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const int32_t*)nnz, (uint32_t*)out, n, nnz_pad,
      v, num_words);
  return (int)cudaGetLastError();
}
