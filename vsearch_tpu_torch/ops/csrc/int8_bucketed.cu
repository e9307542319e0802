// Kernel #4: integer scoring + bucketed candidate keys for the block tier.
//
// Replaces vsearch_tpu/ops/bitpack.py `_make_int8_bucketed_kernel`
// (pallas_call in `_int8_bucketed_keys`), which feeds 0/1 planes and the
// int8 query operand to the TPU's int8 MXU. Each row's integer score, the
// sum of the int8 query weights over its set bits, is spliced into an
// int32 key, (score << 10) | (row % 1024); rows >= num_rows get INT32_MIN.
// The keys of each 1024-row block are max-folded to kb = 1024 / bucket
// keys, local rows l and l' sharing key slot l % kb, as JAX's halving fold
// groups them. Only the keys [n_pad / bucket, B] reach device memory.
//
// Bound on the H100: bytes, the packed rows read once plus the int8 query
// operand read once plus the keys written once. At the block tier's
// 262,144-row block of V' = 29,523 and B = 224 that is 967 MB of words,
// 6.6 MB of operand and 14.7 MB of keys: 0.295 ms at 3.35 TB/s. The
// operand's gathers, b_pad bytes a set bit (~4.6 GB at that shape), come
// from L1 and L2: the operand (7.3 MB) stays in L2.
//
// Design. #4 used to share #3's slot fold (bitrow.cuh `fold_slot`):
// a warp per key slot, and the queries tiled by 32 along the grid's y
// axis, so every tile's CTAs streamed the whole block from device memory
// and decoded it again: 7 reads and 7 decodes of the block's 1 GiB of
// words at 224 queries, 3.2 ms a block. Here the query tiles moved from
// the grid into the warp: a tile re-read the words because its CTAs held
// only 32 queries' sums, and one warp can hold a row's sums for up to 512.
// The grid is one CTA a kWarps key slots of one 1024-row block, as before,
// and warp w folds the `bucket` rows of its slot. It reads each row once
// (16-byte streaming loads), decodes its set bits once into its list of
// operand offsets in shared memory (bitrow.cuh `decode_chunk`, its order),
// then sums that list for every query of the call. A list entry's operand
// for all queries is one run of b_pad contiguous bytes of q8T: lane g *
// lanes + c loads kQ of them (4, 8 or 16 queries, one 4-, 8- or 16-byte
// load, picked by the wrapper from b_pad) of the entries j = g mod groups,
// accumulates them in int32 with __dp4a, and a shuffle tree adds the
// groups' sums; the entry step is a compile-time constant where it can
// be. Time goes to the decode and the __dp4a's, not to the gathers (with
// the gathers served from shared memory it drops ~14%, PERF.md). One pass
// holds 32 kQ queries; past that the warp sweeps the kept list again, and
// the bucket's best keys live in shared memory. Beyond 2,048 queries the
// grid's y axis tiles the queries again, each tile reading the words once.
// A row with more set bits than the list holds is summed chunk by chunk,
// each full list swept before the next decode, and decoded again for each
// further pass. Sums are int32, so any order gives the same keys: the
// kernel, its plain version and the TPU kernel agree bit for bit with any
// weights (#3 keeps `fold_slot`, whose f32 sums must keep #2's order). The
// splice shifts a uint32_t: a left shift of a negative int is undefined in
// C++, while JAX's int32 shift wraps, as the unsigned one does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitrow.cuh"

namespace {

constexpr int kKeyShift = 10;  // log2(kRowBlock): low bits hold the row

// (s << 10) | local, wrapping
__device__ __forceinline__ int splice(int s, int local) {
  return (int)(((uint32_t)s << kKeyShift) | (uint32_t)local);
}

// One load of kQ queries' int8 weights (kQ = 4, 8 or 16 bytes a lane),
// and acc[k] += signed byte k of it
template <int kQ> struct Load;
template <> struct Load<4> { using T = unsigned; };
template <> struct Load<8> { using T = uint2; };
template <> struct Load<16> { using T = uint4; };

__device__ __forceinline__ void add(int* acc, unsigned x) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = __dp4a((int)x, 1 << (8 * k), acc[k]);
}
__device__ __forceinline__ void add(int* acc, uint2 x) {
  add(acc, x.x);
  add(acc + 4, x.y);
}
__device__ __forceinline__ void add(int* acc, uint4 x) {
  add(acc, x.x);
  add(acc + 4, x.y);
  add(acc + 8, x.z);
  add(acc + 12, x.w);
}

// How a warp's lanes split pass p (queries p * 32 kQ .. of b_pad): lane =
// g * lanes + c sums queries q0 + kQ c .. q0 + kQ c + kQ - 1 over the list
// entries j = g mod groups; groups is the largest power of two with
// groups * lanes <= 32, and the lanes past it idle.
template <int kQ>
struct Pass {
  int q0, lanes, groups, g, c;
  bool active;
  __device__ __forceinline__ Pass(int p, int b_pad) {
    q0 = p * 32 * kQ;
    lanes = min(32 * kQ, b_pad - q0) / kQ;
    groups = 1;
    while (2 * groups * lanes <= 32) groups *= 2;
    const int lane = threadIdx.x & 31;
    g = lane / lanes;
    c = lane % lanes;
    active = g < groups;
  }
};

// acc[k] += query q0 + kQ c + k's weights over the lane's entries j = g
// mod step of list[0, n) (byte offsets of operand rows; base is the
// lane's column), kIn loads in flight a lane; kStep > 0 fixes the step at
// compile time, so the list's indices are immediates
template <int kQ, int kIn, int kStep>
__device__ __forceinline__ void sweep_step(int (&acc)[kQ],
                                           const int* __restrict__ list,
                                           int n, const char* base,
                                           const Pass<kQ>& ps) {
  using T = typename Load<kQ>::T;
  const int step = kStep > 0 ? kStep : ps.groups;
  const int lim = ps.active ? n : 0;  // idle lanes load nothing
  for (int i0 = 0; i0 < n; i0 += kIn * step) {  // as many trips each lane
    T x[kIn];
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int j = i0 + u * step + ps.g;
      x[u] = j < lim ? __ldg(reinterpret_cast<const T*>(base + list[j]))
                     : T{};
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) add(acc, x[u]);
  }
}

template <int kQ, int kIn>
__device__ __forceinline__ void sweep(int (&acc)[kQ],
                                      const int* __restrict__ list, int n,
                                      const char* base, const Pass<kQ>& ps) {
  __syncwarp();
  switch (ps.groups) {  // warp-uniform
    case 1: sweep_step<kQ, kIn, 1>(acc, list, n, base, ps); break;
    case 2: sweep_step<kQ, kIn, 2>(acc, list, n, base, ps); break;
    case 4: sweep_step<kQ, kIn, 4>(acc, list, n, base, ps); break;
    default: sweep_step<kQ, kIn, 0>(acc, list, n, base, ps);
  }
  __syncwarp();
}

// acc[k] += lane (g + s, c)'s acc[k] for s < groups, so lanes g == 0
// hold the row's sums
template <int kQ>
__device__ __forceinline__ void reduce(int (&acc)[kQ], const Pass<kQ>& ps) {
  for (int s = ps.groups >> 1; s > 0; s >>= 1)
#pragma unroll
    for (int k = 0; k < kQ; ++k)
      acc[k] += __shfl_down_sync(vs::kFullMask, acc[k], s * ps.lanes);
}

// loads in flight a lane (64 bytes, 32 for the narrowest) and the CTAs an
// SM holds (the registers' budget) at kQ queries a lane
__host__ __device__ constexpr int in_flight(int q) {
  return q == 4 ? 8 : 64 / q;
}
__host__ __device__ constexpr int min_ctas(int q) { return q == 16 ? 3 : 4; }

// queries of one grid row (bitpack.INT8_TILE_QUERIES)
constexpr int kTileQ = 2048;

}  // namespace

// words [n_pad, num_words] uint32 (n_pad % 1024 == 0, num_words % 128 ==
// 0, 16-byte aligned), q8T [VP, b_pad] int8 (b_pad % 32 == 0, 16-byte
// aligned), keys [n_pad / bucket, b] int32 with kb = 1024 / bucket. CTA
// (x, y) owns slots (x % (kb / kWarps)) * kWarps + w of block x / (kb /
// kWarps), for queries y * 2048 .. (y + 1) * 2048 - 1; kQ queries a lane.
// Past one pass, the bucket's best keys live in dynamic shared memory:
// kWarps x (passes x kQ x 32) int32, query q0 + kQ c + k of a pass at
// k * 32 + c (each lane its own bank).
template <int kQ, bool kMulti>
__global__ void __launch_bounds__(vs::kWarps * 32, min_ctas(kQ))
    int8_bucketed_kernel(const uint32_t* __restrict__ words,
                         const int8_t* __restrict__ q8T,
                         int32_t* __restrict__ keys, long long num_rows,
                         int num_words, int b, int b_pad, int kb) {
  constexpr int kIn = in_flight(kQ);
  __shared__ __align__(16) int lists[vs::kWarps][vs::kListCap];
  extern __shared__ int best_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kb / vs::kWarps;
  const int64_t block = blockIdx.x / groups;
  const int slot = (blockIdx.x % groups) * vs::kWarps + warp;
  const int64_t first_row = block * vs::kRowBlock + slot;
  const int bucket = vs::kRowBlock / kb;
  const int nrows =
      first_row < num_rows
          ? (int)min((long long)bucket, (num_rows - 1 - first_row) / kb + 1)
          : 0;
  // this grid row's queries: a tile of at most kTileQ
  const int tile_q0 = blockIdx.y * kTileQ;
  const int tile_pad = min(kTileQ, b_pad - tile_q0);
  const int tile_b = min(kTileQ, b - tile_q0);
  int32_t* out = keys + (block * kb + slot) * b + tile_q0;
  int* list = lists[warp];
  const char* qbytes = reinterpret_cast<const char*>(q8T) + tile_q0;
  const int passes = (tile_pad + 32 * kQ - 1) / (32 * kQ);
  const int row_chunks = num_words / vs::kChunkWords;

  int acc[kQ];  // a row's sums
#pragma unroll
  for (int k = 0; k < kQ; ++k) acc[k] = 0;
  auto column = [&](const Pass<kQ>& ps) {
    return qbytes + ps.q0 + kQ * ps.c;
  };
  // decode `row` into the list, sweeping pass ps over every full list
  // first; returns the entries left in it, `flushed` whether any was full
  auto decode_row = [&](int64_t row, const Pass<kQ>& ps, bool& flushed) {
    const uint4* src = reinterpret_cast<const uint4*>(words + row * num_words);
    const char* base = column(ps);
    int count = 0;
    for (int c0 = 0; c0 < row_chunks; c0 += vs::kHeldChunks) {
      uint4 w[vs::kHeldChunks];
#pragma unroll
      for (int u = 0; u < vs::kHeldChunks; ++u)
        w[u] = c0 + u < row_chunks
                   ? __ldcs(src + (c0 + u) * (vs::kChunkWords / 4) + lane)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < vs::kHeldChunks; ++u)
        if (c0 + u < row_chunks)
          vs::decode_chunk(w[u], c0 + u, list, vs::kListCap, count, b_pad,
                           [&](int n) {  // rare: one form of the sweep
                             __syncwarp();
                             sweep_step<kQ, kIn, 0>(acc, list, n, base, ps);
                             __syncwarp();
                             flushed = true;
                           });
    }
    return count;
  };
  if (!kMulti) {  // one pass: the bucket's best keys in registers
    const Pass<kQ> ps(0, tile_pad);
    int best[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) best[k] = INT32_MIN;
    for (int j = 0; j < nrows; ++j) {
      bool flushed = false;
      const int n = decode_row(first_row + (int64_t)j * kb, ps, flushed);
      sweep<kQ, kIn>(acc, list, n, column(ps), ps);
      reduce(acc, ps);
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        best[k] = max(best[k], splice(acc[k], j * kb + slot));
        acc[k] = 0;
      }
    }
    if (ps.g == 0)
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        if (kQ * ps.c + k < tile_b) out[kQ * ps.c + k] = best[k];
    return;
  }
  // more passes: the kept list swept again (a row longer than the list
  // decoded again for each), the best keys in shared memory
  int* best = best_s + warp * passes * kQ * 32;
  for (int i = lane; i < passes * kQ * 32; i += 32) best[i] = INT32_MIN;
  __syncwarp();
  for (int j = 0; j < nrows; ++j) {
    const int64_t row = first_row + (int64_t)j * kb;
    bool flushed = false;
    int n = 0;
    for (int p = 0; p < passes; ++p) {
      const Pass<kQ> ps(p, tile_pad);
      bool again = false;
      if (p == 0 || flushed) n = decode_row(row, ps, p ? again : flushed);
      sweep<kQ, kIn>(acc, list, n, column(ps), ps);
      reduce(acc, ps);
      int* mine = best + p * kQ * 32 + ps.c;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        if (ps.g == 0)
          mine[k * 32] = max(mine[k * 32], splice(acc[k], j * kb + slot));
        acc[k] = 0;
      }
    }
  }
  __syncwarp();
  for (int q = lane; q < tile_b; q += 32) {  // query q: pass, lane, k
    const int p = q / (32 * kQ), r = q % (32 * kQ);
    out[q] = best[p * kQ * 32 + (r % kQ) * 32 + r / kQ];
  }
}

namespace {

// dynamic shared memory of a launch: the best keys, past one pass
int best_bytes(int kq, int b_pad) {
  const int tile = b_pad < kTileQ ? b_pad : kTileQ;
  const int passes = (tile + 32 * kq - 1) / (32 * kq);
  return passes > 1 ? vs::kWarps * passes * kq * 32 * 4 : 0;
}

template <int kQ>
int launch(const void* words, const void* q8T, void* keys, long long num_rows,
           int num_words, int b, int b_pad, int kb, int grid_x,
           cudaStream_t stream) {
  const int smem = best_bytes(kQ, b_pad);
  const dim3 grid((unsigned)grid_x, (unsigned)((b_pad + kTileQ - 1) / kTileQ));
  if (smem == 0) {
    int8_bucketed_kernel<kQ, false><<<grid, vs::kWarps * 32, 0, stream>>>(
        (const uint32_t*)words, (const int8_t*)q8T, (int32_t*)keys, num_rows,
        num_words, b, b_pad, kb);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      int8_bucketed_kernel<kQ, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int8_bucketed_kernel<kQ, true><<<grid, vs::kWarps * 32, smem, stream>>>(
      (const uint32_t*)words, (const int8_t*)q8T, (int32_t*)keys, num_rows,
      num_words, b, b_pad, kb);
  return (int)cudaGetLastError();
}

}  // namespace

// lane_q (queries a lane: 4, 8 or 16) and grid_x come from the Python
// wrapper's `int8_fold_geometry`. Returns a cudaError_t.
extern "C" int vs_int8_bucketed_keys(const void* words, const void* q8T,
                                     void* keys, long long num_rows,
                                     int num_words, int b, int b_pad, int kb,
                                     int lane_q, int grid_x, void* stream) {
  if (grid_x <= 0 || b <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lane_q) {
    case 4:
      return launch<4>(words, q8T, keys, num_rows, num_words, b, b_pad, kb,
                       grid_x, s);
    case 8:
      return launch<8>(words, q8T, keys, num_rows, num_words, b, b_pad, kb,
                       grid_x, s);
    case 16:
      return launch<16>(words, q8T, keys, num_rows, num_words, b, b_pad, kb,
                        grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The CTAs an SM holds at once of the lane width that holds the fewest
// (16 queries a lane, in one pass), as the CUDA runtime computes them.
extern "C" int vs_int8_bucketed_keys_occupancy(int* ctas_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, int8_bucketed_kernel<16, false>, vs::kWarps * 32, 0);
}
