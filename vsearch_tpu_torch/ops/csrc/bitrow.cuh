// Shared device code of the bit-packed scorers: the exact scorer (#2,
// scores.cu) and the fold kernel #3 (bucketed.cu), both over the bf16
// query operand. Kernel #4 (int8_bucketed.cu) calls only the decode
// (`decode_chunk`, `emit_bits`); its int32 sums sweep every query of a
// call from one decode, so it has its own sweep.
//
// Packed layout (the JAX package's, vsearch_tpu/ops/bitpack.py): vocab id
// v lives in word (v / 4096) * 128 + v % 128, bit (v % 4096) / 128, so a
// row of V' = 29,523 columns is 1,024 uint32 words (4 KB).
//
// #2 and #3 score a row by decode, then gather (`score_rows`). The warp
// loads the row into registers, 2 KB at a time (one 16-byte streaming load
// a lane per 512-byte chunk), turns its set bits into a list of
// query-operand offsets in shared memory, then sums the operand over the
// list with kGather loads in flight a lane, each load serving two queries
// (`PairSum`, below). The list keeps word order, then bit order within a
// word, the order of the first port's bit-by-bit walk: f32 sums are
// bit-identical to it, and to each other across #2 and #3. A row with
// more set bits than the list holds is summed in chunks of the list, in
// the same order. (The walk with one gather in flight a warp, and a ring
// of rows staged in shared memory with cp.async, were measured slower on
// the H100: PERF.md.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vs {

constexpr int kTileBits = 4096;
constexpr int kLanes = 128;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRowBlock = 1024;   // rows of one fold block
constexpr int kWarps = 8;         // warps a CTA (bitpack.CTA_WARPS)
constexpr int kListCap = 256;     // offsets a warp's list holds
constexpr int kChunkWords = 128;  // one 512-byte chunk: 4 words a lane
constexpr int kHeldChunks = 4;    // chunks a warp holds at once
constexpr int kGather = 8;        // operand loads in flight a lane

// Row sums with two queries a lane and two rows at once, for the bf16
// operand: lane (h, s) = (lane / 16, lane % 16) loads the 4 bytes of
// queries 2s, 2s + 1 from the list of row h of the pair, so one load
// serves two queries and the warp gathers for two rows at once, while
// each query still sums its row's list in order (f32 sums stay
// identical). store() takes the max of the two halves.
struct PairSum {
  static constexpr int kRows = 2;
  const char* base;
  float acc[2] = {0.f, 0.f};
  int best[2] = {INT32_MIN, INT32_MIN};

  __device__ explicit PairSum(const __nv_bfloat16* qtile)
      : base(reinterpret_cast<const char*>(qtile + 2 * (threadIdx.x & 15))) {}

  // rows h < 2 add their lists list + h * cap, of n[h] entries
  __device__ __forceinline__ void add(const int* __restrict__ list, int cap,
                                      const int (&n)[2]) {
    __syncwarp();
    const int h = (threadIdx.x >> 4) & 1;
    const int* mine = list + h * cap;
    const int my_n = h ? n[1] : n[0];
    const int len = max(n[0], n[1]);
    for (int i = 0; i < len; i += kGather) {
      unsigned x[kGather];
#pragma unroll
      for (int u = 0; u < kGather; u += 4) {
        const int4 o = *reinterpret_cast<const int4*>(mine + i + u);
        x[u] = i + u < my_n ? __ldg(reinterpret_cast<const unsigned*>(
                                  base + 2 * o.x))
                            : 0u;
        x[u + 1] = i + u + 1 < my_n ? __ldg(reinterpret_cast<const unsigned*>(
                                          base + 2 * o.y))
                                    : 0u;
        x[u + 2] = i + u + 2 < my_n ? __ldg(reinterpret_cast<const unsigned*>(
                                          base + 2 * o.z))
                                    : 0u;
        x[u + 3] = i + u + 3 < my_n ? __ldg(reinterpret_cast<const unsigned*>(
                                          base + 2 * o.w))
                                    : 0u;
      }
      // bf16 -> f32 is a shift; adding +0 past the end changes nothing (a
      // sum from +0 is never -0)
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        acc[0] += __uint_as_float(x[u] << 16);
        acc[1] += __uint_as_float(x[u] & 0xffff0000u);
      }
    }
    __syncwarp();
  }
  // fold rows h < rows of the pair, local row ids local0 + h * kb
  template <typename Splice>
  __device__ __forceinline__ void fold(int rows, int local0, int kb) {
    const int h = (threadIdx.x >> 4) & 1;
    if (h < rows) {
      best[0] = max(best[0], Splice{}(acc[0], local0 + h * kb));
      best[1] = max(best[1], Splice{}(acc[1], local0 + h * kb));
    }
    acc[0] = acc[1] = 0.f;
  }
  __device__ __forceinline__ void store(int32_t* __restrict__ out, int q0,
                                        int b) {
    best[0] = max(best[0], __shfl_xor_sync(kFullMask, best[0], 16));
    best[1] = max(best[1], __shfl_xor_sync(kFullMask, best[1], 16));
    const int h = (threadIdx.x >> 4) & 1;
    const int q = q0 + 2 * (threadIdx.x & 15) + h;
    if (q < b) out[q] = h ? best[1] : best[0];
  }
};

// Write the offsets of `word`'s set bits (vocab id v + p * 128 for bit p)
// to list slots s, s + 1, ... that fall inside [0, cap).
__device__ __forceinline__ void emit_bits(uint32_t word, int v, int stride,
                                          int& s, int* list, int cap) {
  while (word) {
    const int p = __ffs(word) - 1;
    word &= word - 1;
    if ((unsigned)s < (unsigned)cap) list[s] = (v + p * kLanes) * stride;
    ++s;
  }
}

// Append the set bits of chunk c (lane l holds its words 4l .. 4l + 3) to
// the warp's list; whenever the list would overflow, flush(cap) sums it
// first.
template <typename Flush>
__device__ __forceinline__ void decode_chunk(uint4 w, int c, int* list,
                                             int cap, int& count, int stride,
                                             Flush&& flush) {
  const int lane = threadIdx.x & 31;
  const int n = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
  int incl = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += t;
  }
  int end = count + __shfl_sync(kFullMask, incl, 31);  // uniform
  int first = count + incl - n;  // this lane's first slot
  const int v = c * kTileBits + 4 * lane;
  for (;;) {
    int s = first;
    emit_bits(w.x, v, stride, s, list, cap);
    emit_bits(w.y, v + 1, stride, s, list, cap);
    emit_bits(w.z, v + 2, stride, s, list, cap);
    emit_bits(w.w, v + 3, stride, s, list, cap);
    if (end <= cap) break;
    flush(cap);
    first -= cap;
    end -= cap;
  }
  count = end;
}

// The shared row scorer: one warp sums rows first + h * step (h < rows <=
// Sum::kRows) of `words` into `sum`'s accumulators, by decode, then
// gather. `list` is the warp's kListCap offsets in shared memory, split
// evenly between the Sum's kRows rows; `stride` is the query operand's row
// length (b_pad). The caller reads the sums, then resets them (Sum::fold)
// or not (kernel #2 writes them once).
template <typename Sum>
__device__ __forceinline__ void score_rows(Sum& sum,
                                           const uint32_t* __restrict__ words,
                                           int64_t first, int64_t step,
                                           int rows, int num_words, int* list,
                                           int stride) {
  constexpr int kR = Sum::kRows;
  constexpr int cap = kListCap / kR;  // entries of one row's list
  const int lane = threadIdx.x & 31;
  // decode one chunk of row h of the group into its list; a full list is
  // summed alone first (the other rows' halves add nothing)
  auto decode = [&](uint4 w, int c, int h, int& count) {
    decode_chunk(w, c, list + h * cap, cap, count, stride, [&](int n) {
      int only[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) only[r] = r == h ? n : 0;
      sum.add(list, cap, only);
    });
  };

  const int row_chunks = num_words / kChunkWords;
  int count[kR];
#pragma unroll
  for (int h = 0; h < kR; ++h) {
    count[h] = 0;
    if (h >= rows) continue;  // warp-uniform
    const uint4* row = reinterpret_cast<const uint4*>(
        words + (first + (int64_t)h * step) * num_words);
    for (int c0 = 0; c0 < row_chunks; c0 += kHeldChunks) {
      uint4 w[kHeldChunks];
#pragma unroll
      for (int u = 0; u < kHeldChunks; ++u)
        w[u] = c0 + u < row_chunks
                   ? __ldcs(row + (c0 + u) * (kChunkWords / 4) + lane)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < kHeldChunks; ++u)
        if (c0 + u < row_chunks) decode(w[u], c0 + u, h, count[h]);
    }
  }
  sum.add(list, cap, count);
}

// ---------------------------------------------------------------------------
// The slot fold of kernel #3: score rows, splice each score with its
// local row id into an int32 key, and max-fold the keys of each 1024-row
// block to kb = 1024 / bucket slots (local rows l and l' share slot
// l % kb, the grouping of JAX's halving fold).
//
// Geometry (grid_x computed by the Python wrapper, `fold_geometry`): a CTA
// of kWarps warps owns kWarps consecutive slots of one 1024-row block, one
// slot a warp; CTA x serves block x / (kb / kWarps). Warp w folds the
// `bucket` rows block * 1024 + j * kb + slot (j < bucket) of its slot,
// kRows at a time, keeping the running max in registers: no atomics, and
// as many warps as slots (16,384 for a 262,144-row block at bucket 16) to
// fill the card. `Splice` turns (score, local row) into the key.
template <typename Splice>
__device__ __forceinline__ void fold_slot(
    const uint32_t* __restrict__ words, const __nv_bfloat16* __restrict__ qT,
    int32_t* __restrict__ keys, long long num_rows, int num_words, int b,
    int b_pad, int kb) {
  __shared__ __align__(16) int lists[kWarps][kListCap];
  const int warp = threadIdx.x >> 5;
  const int groups = kb / kWarps;
  const int64_t block = blockIdx.x / groups;
  const int slot = (blockIdx.x % groups) * kWarps + warp;
  const int64_t first_row = block * kRowBlock + slot;
  const int bucket = kRowBlock / kb;
  const int nrows =
      first_row < num_rows
          ? (int)min((long long)bucket, (num_rows - 1 - first_row) / kb + 1)
          : 0;
  int32_t* out = keys + (block * kb + slot) * b;

  constexpr int kR = PairSum::kRows;
  PairSum sum(qT + blockIdx.y * 32);
  for (int j0 = 0; j0 < nrows; j0 += kR) {
    const int rows = min(kR, nrows - j0);
    score_rows(sum, words, first_row + (int64_t)j0 * kb, kb, rows, num_words,
               lists[warp], b_pad);
    sum.template fold<Splice>(rows, j0 * kb + slot, kb);
  }
  sum.store(out, blockIdx.y * 32, b);
}

}  // namespace vs

// `<entry>_occupancy`: the CTAs of `kernel` (kWarps warps) one SM holds at
// once, as the CUDA runtime computes them from its registers and shared
// memory.
#define VS_OCCUPANCY_ENTRY(entry, kernel)                        \
  extern "C" int entry##_occupancy(int* ctas_per_sm) {           \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(   \
        ctas_per_sm, kernel, vs::kWarps * 32, 0);                \
  }

// Kernel #3's fold kernel of one splice (unmangled, so the ptxas report
// and the profiler name it), its C entry point and its occupancy entry.
#define VS_FOLD_ENTRY(entry, kernel, Splice)                                 \
  extern "C" __global__ void __launch_bounds__(vs::kWarps * 32) kernel(      \
      const uint32_t* __restrict__ words,                                    \
      const __nv_bfloat16* __restrict__ qT, int32_t* __restrict__ keys,      \
      long long num_rows, int num_words, int b, int b_pad, int kb) {         \
    vs::fold_slot<Splice>(words, qT, keys, num_rows, num_words, b, b_pad,    \
                          kb);                                               \
  }                                                                          \
  extern "C" int entry(const void* words, const void* qT, void* keys,        \
                       long long num_rows, int num_words, int b, int b_pad,  \
                       int kb, int grid_x, void* stream) {                   \
    if (grid_x <= 0 || b <= 0) return 0;                                     \
    kernel<<<dim3((unsigned)grid_x, (unsigned)(b_pad / 32)),                 \
             vs::kWarps * 32, 0, (cudaStream_t)stream>>>(                    \
        (const uint32_t*)words, (const __nv_bfloat16*)qT, (int32_t*)keys,    \
        num_rows, num_words, b, b_pad, kb);                                  \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  VS_OCCUPANCY_ENTRY(entry, kernel)
