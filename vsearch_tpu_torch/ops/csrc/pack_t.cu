// P2: pack ELL rows into the TRANSPOSED bit matrix words_T [num_words,
// n_pad], the bits of kernel #1 (pack.cu) with rows along the last axis.
//
// Replaces scripts/probe_pack.py `make_packT` (pallas_call in its `pack`),
// the TPU probe's layout with rows on lanes, which scripts/
// probe_scorer_variants.py's transposed scorer reads (bucketed_t.cu here).
// The layout of the bits is the JAX package's: column v of row r sets word
// (v / 4096) * 128 + v % 128, bit (v % 4096) / 128, at words_T[word, r];
// slots j >= nnz[r], negative ids and ids >= V (the sentinel pad) set
// nothing; rows n .. n_pad - 1 are zero. So words_T == pack(...).T.
//
// Bound on the H100: bytes, the ELL read once and words_T written once
// (8.2 GB written and 1.0 GB read at the probe's 2,000,000 x 128 ids,
// ~2.75 ms at 3.35 TB/s). A CTA owns kRows consecutive rows: it zeroes
// their words in shared memory, ORs one bit per valid slot there
// (atomicOr; the ids of a row are distinct, and OR is exact in any order),
// then stores each word's kRows rows contiguously, so a warp's stores
// along n_pad land in two 64-byte runs and every word is written once with
// no prior memset. 16 rows of 1,024 words is 64 KB of shared memory: three
// CTAs an SM, so one CTA's stores overlap another's bit setting.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRows = 16;  // rows of one CTA (bitpack.ROW_BLOCK % kRows == 0)

__global__ void __launch_bounds__(kThreads)
pack_t_kernel(const int32_t* __restrict__ cols,
              const int32_t* __restrict__ nnz, uint32_t* __restrict__ out,
              long long n, long long n_pad, int nnz_pad, int v,
              int num_words) {
  extern __shared__ uint32_t bits[];  // [num_words][kRows]
  const long long row0 = (long long)blockIdx.x * kRows;
  const int total = num_words * kRows;
  for (int i = threadIdx.x; i < total; i += kThreads) bits[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * nnz_pad; i += kThreads) {
    const int r = i / nnz_pad, j = i % nnz_pad;
    const long long row = row0 + r;
    if (row >= n || j >= min(nnz[row], nnz_pad)) continue;
    const int c = cols[row * nnz_pad + j];
    if (c >= 0 && c < v)
      atomicOr(&bits[((c >> 12) * 128 + (c & 127)) * kRows + r],
               1u << ((c & 4095) >> 7));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kThreads)
    out[(long long)(i / kRows) * n_pad + row0 + i % kRows] = bits[i];
}

}  // namespace

// cols [n, nnz_pad] int32, nnz [n] int32, out [num_words, n_pad] uint32
// (n_pad % 16 == 0; every word written). Returns cudaGetLastError().
extern "C" int vs_pack_ell_t(const void* cols, const void* nnz, void* out,
                             long long n, long long n_pad, int nnz_pad,
                             int v, int num_words, void* stream) {
  if (n_pad <= 0) return 0;
  const size_t smem = (size_t)num_words * kRows * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pack_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pack_t_kernel<<<(unsigned)(n_pad / kRows), kThreads, smem,
                  (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const int32_t*)nnz, (uint32_t*)out, n, n_pad,
      nnz_pad, v, num_words);
  return (int)cudaGetLastError();
}
