// P5: kernel #3's keys scored from the TRANSPOSED bit matrix words_T
// [num_words, n_pad] (pack_t.cu).
//
// Replaces scripts/probe_scorer_variants.py `acc_v3` (pallas_call in
// `run_transposed`), the TPU probe's scorer over words_T, which extracted
// two bit planes a shift with pltpu.bitcast and fed them to the matrix
// unit against pair-interleaved queries scaled by 1/2 (an artifact of the
// bitcast). This kernel takes the ordinary query operand qT [VP, b_pad]
// bf16 and computes #3's function (bucketed.cu): each row's score spliced
// with its local row id, (bits(max(score, 0)) & ~1023) | (row % 1024),
// rows >= num_rows INT32_MIN, each 1024-row block max-folded to kb = 1024 /
// bucket slots (local rows l and l' share slot l % kb).
//
// Bound on the H100: the function's (bitpack.score_bounds, the same as
// #3's): one f32 add a set bit and query at 67 TFLOP/s, or the words read
// once at 3.35 TB/s (3.7 ms of adds against 2.8 ms of bytes at the probe's
// 2,000,000 rows of ~120 ids, B = 1,024). It is a probe kernel: nothing on
// a search path calls it.
//
// Design. A lane owns one row, so a warp's load of word w for its 32
// consecutive rows is one coalesced 128-byte read of words_T. The lane
// turns the row's set bits into a list of vocab ids in shared memory, in
// word order, then bit order: the order of bitrow.cuh's lists. It then sums
// the query weights of the list for the kQ = 32 queries of its tile
// (blockIdx.y), sequentially in f32 from +0, each entry one 64-byte load of
// qT's row, two entries in flight. That is #3's gather form's order and
// arithmetic, so the keys equal #3's bit for bit, whatever the weights. A
// list holds kCap ids a lane; before a word could overflow any lane's list
// the warp sums and empties it, which keeps the order. The 8 rows of a
// bucket-8 slot lie kb = 128 rows apart, so they fall in 8 warps, not in 8
// lanes of one warp: warp j of a CTA owns the rows j * kb + [32 g, 32 g +
// 32) of a block (g = the CTA's slot group), and the fold is a max over
// the warps' keys in shared memory (integer, so exact). Each query tile
// re-reads the words and re-decodes the rows, as #3's gather form does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowBlock = 1024;
constexpr int kCap = 64;  // vocab ids a lane's list holds
constexpr int kQ = 32;    // queries a lane sums: one tile of blockIdx.y
constexpr int kMaxWarps = 8;  // warps a CTA = bucket <= 8
// shared memory a warp: its lists, then (reused) its keys for the fold
constexpr int kListBytes = kCap * 32 * 2;
constexpr int kFoldBytes = 32 * (kQ + 1) * 4;
constexpr int kWarpBytes = kListBytes > kFoldBytes ? kListBytes : kFoldBytes;

// acc[8 u + k] += query 8 u + k of the 16-byte loads x[u] (bf16 -> f32 is
// a shift)
__device__ __forceinline__ void add_row(float (&acc)[kQ], const uint4 (&x)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t h[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[8 * u + 2 * k] += __uint_as_float(h[k] << 16);
      acc[8 * u + 2 * k + 1] += __uint_as_float(h[k] & 0xffff0000u);
    }
  }
}

}  // namespace

// CTA x serves block x / (kb / 32), slot group x % (kb / 32); blockIdx.y
// tiles the queries by 32. blockDim.x = 32 * bucket.
extern "C" __global__ void __launch_bounds__(kMaxWarps * 32)
    bucketed_t_kernel(const uint32_t* __restrict__ words_t,
                      const __nv_bfloat16* __restrict__ qT,
                      int32_t* __restrict__ keys, long long num_rows,
                      long long n_pad, int num_words, int b, int b_pad,
                      int kb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int groups = kb / 32;
  const long long block = blockIdx.x / groups;
  const int g = (int)(blockIdx.x % groups);
  const int local = warp * kb + g * 32 + lane;
  const long long row = block * kRowBlock + local;
  // entry i of this lane's list at list[32 i]: lanes side by side
  uint16_t* list =
      reinterpret_cast<uint16_t*>(smem + warp * kWarpBytes) + lane;
  const char* qtile =
      reinterpret_cast<const char*>(qT + (size_t)blockIdx.y * kQ);
  const size_t qrow = (size_t)b_pad * 2;  // bytes of one qT row
  float acc[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
  int cnt = 0;
  // sum and empty the lists: entries past a lane's count add +0, which
  // changes no sum (a sum from +0 is never -0)
  auto flush = [&]() {
    int n = cnt;
#pragma unroll
    for (int d = 16; d; d >>= 1) n = max(n, __shfl_xor_sync(kFull, n, d));
    for (int i = 0; i < n; i += 2) {
      uint4 x0[4], x1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x0[u] = i < cnt ? __ldg(reinterpret_cast<const uint4*>(
                              qtile + list[32 * i] * qrow) + u)
                        : make_uint4(0u, 0u, 0u, 0u);
        x1[u] = i + 1 < cnt ? __ldg(reinterpret_cast<const uint4*>(
                                  qtile + list[32 * (i + 1)] * qrow) + u)
                            : make_uint4(0u, 0u, 0u, 0u);
      }
      add_row(acc, x0);
      add_row(acc, x1);
    }
    cnt = 0;
  };
  const uint32_t* col = words_t + row;
  for (int w0 = 0; w0 < num_words; w0 += 8) {
    uint32_t wv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) wv[u] = __ldcs(col + (size_t)(w0 + u) * n_pad);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      uint32_t x = wv[u];
      if (__any_sync(kFull, cnt + __popc(x) > kCap)) flush();
      const int w = w0 + u;
      const int base = (w >> 7) * 4096 + (w & 127);
      while (x) {
        const int p = __ffs(x) - 1;
        x &= x - 1;
        list[32 * cnt++] = (uint16_t)(base + p * 128);
      }
    }
  }
  flush();
  __syncthreads();  // every warp is done with its list: reuse it
  int32_t* fold = reinterpret_cast<int32_t*>(smem + warp * kWarpBytes) +
                  lane * (kQ + 1);
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    fold[q] = row < num_rows
                  ? (__float_as_int(fmaxf(acc[q], 0.f)) & ~(kRowBlock - 1)) |
                        local
                  : INT32_MIN;
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * kQ; i += blockDim.x) {
    const int s = i / kQ, q = i % kQ;
    int best = INT32_MIN;
    for (int j = 0; j < warps; ++j)
      best = max(best, reinterpret_cast<const int32_t*>(
                           smem + j * kWarpBytes)[s * (kQ + 1) + q]);
    const int qq = blockIdx.y * kQ + q;
    if (qq < b) keys[(block * kb + g * 32 + s) * b + qq] = best;
  }
}

// words_t [num_words, n_pad] uint32 (n_pad % 1024 == 0, num_words % 8 ==
// 0), qT [VP, b_pad] bf16 (b_pad % 32 == 0, 16-byte aligned, VP <= 65,536),
// keys [n_pad / bucket, b] int32, kb = 1024 / bucket with bucket a power of
// two <= 8. Returns a cudaError_t.
extern "C" int vs_bucketed_keys_t(const void* words_t, const void* qT,
                                  void* keys, long long num_rows,
                                  long long n_pad, int num_words, int b,
                                  int b_pad, int kb, void* stream) {
  if (n_pad <= 0 || b <= 0) return 0;
  const int warps = kRowBlock / kb;
  const int smem = warps * kWarpBytes;
  const dim3 grid((unsigned)(n_pad / kRowBlock * (kb / 32)),
                  (unsigned)(b_pad / kQ));
  bucketed_t_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)words_t, (const __nv_bfloat16*)qT, (int32_t*)keys,
      num_rows, n_pad, num_words, b, b_pad, kb);
  return (int)cudaGetLastError();
}
