// P5's kernel: kernel #3's keys scored from the TRANSPOSED bit matrix
// words_T [num_words, n_pad] (pack_t.cu), each row decoded once and swept
// against every query tile. bucketed_t.cu holds its note and the shipped
// entry; bucketed_t_decode_only.cu a timing-only variant.
//
// A CTA (kThreads = 256 threads) owns kRows = 256 rows of one 1024-row
// block: the kb / 4 key slots g * kb / 4 + [0, kb / 4) of the block (g =
// blockIdx.x % 4, kb = 1024 / bucket) with all `bucket` members of each.
//
// 1. Decode. Thread t reads the words of one row (consecutive threads,
//    consecutive rows: each warp load is 128 coalesced bytes of words_T)
//    and writes its set bits as u16 vocab ids to the row's list in shared
//    memory, in word order, then bit order: bitrow.cuh's order. A list
//    holds `cap` ids; a longer row keeps where its decode stopped (the word
//    and its bits left) and counts once in state[1].
// 2. Sweep. Lane (r8, qq) = (lane / 4, lane % 4) of warp w sums rows
//    w * 32 + g8 * 8 + r8 (g8 < 4) for queries qq * 8 + [0, 8) of the pass's
//    tile of kQ = 32: each list entry is one 16-byte load of qT a lane, and
//    the 4 lanes of a row read one 64-byte run, so a warp's load touches 8
//    lines, not 32. Each query sums its row's list sequentially in f32 from
//    +0 (a long row then walks its words from where the decode stopped):
//    #3's gather form's order, so the keys are #3's bit for bit. The
//    members of a slot lie in the lane's 4 rows (and, at bucket 8, in the
//    lane 4 apart), so the fold is a max in registers and one shuffle.
// 3. Query tiles. Every CTA sweeps all b_pad / 32 tiles, starting at the
//    tile that the CTAs resident before it have reached (state[0] counts
//    finished passes; `resident` CTAs finish one pass each per tile), so
//    that the CTAs on the card read one tile of qT (2 MiB) at a time and
//    it stays in L2.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vs_t {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowBlock = 1024;
constexpr int kRows = 256;     // rows a CTA (probes.KEYS_T_ROWS)
constexpr int kThreads = 256;  // one row a thread in the decode
constexpr int kGroups = kRowBlock / kRows;  // CTAs a 1024-row block
constexpr int kQ = 32;         // queries a pass (probes.KEYS_T_QUERIES)
constexpr int kLaneRows = 4;   // rows a lane sums in the sweep
constexpr int kLaneQ = 8;      // queries a lane sums: one 16-byte load
constexpr int kWordsInFlight = 8;
// the rows' state after the lists: count, resume word, resume bits
constexpr int kStateBytes = 3 * 4 * kRows;

__host__ __device__ constexpr int smem_bytes(int cap) {
  return cap * kRows * 2 + kStateBytes;
}

// sweep position (warp w, row g8 of the lane, r8) -> (member j, slot s of
// the CTA, 0 <= s < kRows / B)
template <int B>
__device__ __forceinline__ void member_of(int w, int g8, int r8, int& j,
                                          int& s) {
  if constexpr (B == 8) {
    j = g8 + 4 * (r8 & 1);
    s = w * 4 + (r8 >> 1);
  } else {
    j = g8 % B;
    s = w * (32 / B) + r8 * (4 / B) + g8 / B;
  }
}

// (member j, slot s) -> the column of shared memory that the sweep reads:
// w * 32 + g8 * 8 + r8 (the inverse of member_of)
template <int B>
__device__ __forceinline__ int column_of(int j, int s) {
  const int w = s / (32 / B), sig = s % (32 / B);
  int g8, r8;
  if constexpr (B == 8) {
    g8 = j & 3;
    r8 = 2 * sig + (j >> 2);
  } else {
    r8 = sig / (4 / B);
    g8 = (sig % (4 / B)) * B + j;
  }
  return w * 32 + g8 * 8 + r8;
}

// acc[k] += query k of the 16-byte load x (bf16 -> f32 is a shift)
__device__ __forceinline__ void add8(float (&acc)[kLaneQ], const uint4& x) {
  const uint32_t h[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(h[k] << 16);
    acc[2 * k + 1] += __uint_as_float(h[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load_q(const char* base, int id,
                                        size_t qrow) {
  return __ldg(reinterpret_cast<const uint4*>(base + (size_t)id * qrow));
}

// vocab id of bit p of word w (bitpack's layout)
__device__ __forceinline__ int vocab_id(int w, int p) {
  return (w >> 7) * 4096 + (w & 127) + p * 128;
}

// kDecodeOnly (TIMING ONLY): the decode as shipped, then each pass stores
// keys made from the lists' counts without reading qT: the shipped kernel
// less its gathers and adds.
template <int B, bool kDecodeOnly>
__global__ void __launch_bounds__(kThreads, 2)
    keys_t_kernel(const uint32_t* __restrict__ words_t,
                  const __nv_bfloat16* __restrict__ qT,
                  int32_t* __restrict__ keys, unsigned* __restrict__ state,
                  long long num_rows, long long n_pad, int num_words, int b,
                  int b_pad, int cap, int resident) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* list = reinterpret_cast<uint16_t*>(smem);  // [cap][kRows]
  int* cnt_s = reinterpret_cast<int*>(smem + cap * kRows * 2);
  int* word_s = cnt_s + kRows;         // where a long row's decode stopped
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(word_s + kRows);
  constexpr int kb = kRowBlock / B, slots = kRows / B;
  const long long block = blockIdx.x / kGroups;
  const int grp = blockIdx.x % kGroups;
  // the CTA's rows: local rows j * kb + grp * slots + s of the block
  const long long row0 = block * kRowBlock;

  // -- 1. decode: thread t, member t / slots, slot t % slots -------------
  {
    const int j = threadIdx.x / slots, s = threadIdx.x % slots;
    const int local = j * kb + grp * slots + s;
    const int col = column_of<B>(j, s);
    const bool live = row0 + local < num_rows;
    const uint32_t* wp = words_t + row0 + local;
    int cnt = 0, stop = num_words;
    uint32_t left = 0u;
    for (int w0 = 0; live && w0 < num_words; w0 += kWordsInFlight) {
      uint32_t wv[kWordsInFlight];
#pragma unroll
      for (int u = 0; u < kWordsInFlight; ++u)
        wv[u] = __ldcs(wp + (size_t)(w0 + u) * n_pad);
#pragma unroll
      for (int u = 0; u < kWordsInFlight; ++u) {
        uint32_t x = stop == num_words ? wv[u] : 0u;
        while (x) {
          if (cnt == cap) {
            stop = w0 + u;
            left = x;
            break;
          }
          list[cnt++ * kRows + col] =
              (uint16_t)vocab_id(w0 + u, __ffs(x) - 1);
          x &= x - 1;
        }
      }
    }
    cnt_s[col] = cnt;
    word_s[col] = stop;
    bits_s[col] = left;
    if (stop < num_words) atomicAdd(&state[1], 1u);
  }
  __syncthreads();

  // -- 2. sweep every query tile ------------------------------------------
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r8 = lane >> 2, qq = lane & 3;
  int cnt[kLaneRows], local[kLaneRows];
  bool live[kLaneRows], longrow = false;
  int most = 0;
#pragma unroll
  for (int g8 = 0; g8 < kLaneRows; ++g8) {
    int j, s;
    member_of<B>(warp, g8, r8, j, s);
    local[g8] = j * kb + grp * slots + s;
    live[g8] = row0 + local[g8] < num_rows;
    cnt[g8] = cnt_s[warp * 32 + g8 * 8 + r8];
    longrow |= word_s[warp * 32 + g8 * 8 + r8] < num_words;
    most = max(most, cnt[g8]);
  }
  most = __reduce_max_sync(kFull, most);
  const bool any_long = __any_sync(kFull, longrow);
  const uint16_t* mine = list + warp * 32 + r8;  // + g8 * 8 + i * kRows
  const size_t qrow = (size_t)b_pad * 2;         // bytes of one qT row
  const int tiles = b_pad / kQ;
  __shared__ int first;
  if (threadIdx.x == 0)
    first = (int)((*(volatile unsigned*)&state[0] / (unsigned)resident) %
                  (unsigned)tiles);
  __syncthreads();

  for (int k = 0, tile = first; k < tiles;
       ++k, tile = tile + 1 == tiles ? 0 : tile + 1) {
    const char* qbase = reinterpret_cast<const char*>(qT) +
                        (size_t)tile * kQ * 2 + qq * 16;
    float acc[kLaneRows][kLaneQ];
#pragma unroll
    for (int g8 = 0; g8 < kLaneRows; ++g8)
#pragma unroll
      for (int q = 0; q < kLaneQ; ++q) acc[g8][q] = 0.f;
    if constexpr (kDecodeOnly) {
#pragma unroll
      for (int g8 = 0; g8 < kLaneRows; ++g8)
        acc[g8][0] = (float)(cnt[g8] + (cnt[g8] ? mine[g8 * 8] : 0));
    } else {
      // entries past a row's count add +0, which changes no sum (a sum
      // from +0 is never -0); two entries of each row in flight
      for (int i = 0; i < most; i += 2) {
        uint4 x[2][kLaneRows];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int g8 = 0; g8 < kLaneRows; ++g8)
            x[h][g8] = i + h < cnt[g8]
                           ? load_q(qbase, mine[(i + h) * kRows + g8 * 8],
                                    qrow)
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int g8 = 0; g8 < kLaneRows; ++g8) add8(acc[g8], x[h][g8]);
      }
      if (any_long) {
        // a long row: the rest of its ids, from its words, in order
#pragma unroll
        for (int g8 = 0; g8 < kLaneRows; ++g8) {
          const int c = warp * 32 + g8 * 8 + r8;
          int w = word_s[c];
          if (w >= num_words) continue;
          uint32_t x = bits_s[c];
          const uint32_t* wp = words_t + row0 + local[g8];
          while (true) {
            while (x) {
              add8(acc[g8], load_q(qbase, vocab_id(w, __ffs(x) - 1), qrow));
              x &= x - 1;
            }
            if (++w >= num_words) break;
            x = __ldg(wp + (size_t)w * n_pad);
          }
        }
      }
    }
    // splice with the local row id, fold the slot's members, store
    int key[kLaneRows][kLaneQ];
#pragma unroll
    for (int g8 = 0; g8 < kLaneRows; ++g8)
#pragma unroll
      for (int q = 0; q < kLaneQ; ++q)
        key[g8][q] = live[g8] ? (__float_as_int(fmaxf(acc[g8][q], 0.f)) &
                                 ~(kRowBlock - 1)) |
                                    local[g8]
                              : INT32_MIN;
    const int q0 = tile * kQ + qq * kLaneQ;
    int32_t* out = keys + (block * kb + grp * slots) * (long long)b + q0;
    if constexpr (B == 8) {
      // members g8 here and g8 + 4 in the lane 4 apart (r8 ^ 1); each of
      // the two stores half of the slot's 8 queries
#pragma unroll
      for (int q = 0; q < kLaneQ; ++q) {
        int m = max(max(key[0][q], key[1][q]), max(key[2][q], key[3][q]));
        m = max(m, __shfl_xor_sync(kFull, m, 4));
        const int s = warp * 4 + (r8 >> 1);
        if ((q >> 2) == (r8 & 1) && q0 + q < b) out[s * (long long)b + q] = m;
      }
    } else {
      // the lane holds 4 / B slots, members g8 = u * B + j
#pragma unroll
      for (int u = 0; u < 4 / B; ++u) {
        const int s = warp * (32 / B) + r8 * (4 / B) + u;
#pragma unroll
        for (int q = 0; q < kLaneQ; ++q) {
          int m = key[u * B][q];
#pragma unroll
          for (int j = 1; j < B; ++j) m = max(m, key[u * B + j][q]);
          if (q0 + q < b) out[s * (long long)b + q] = m;
        }
      }
    }
    if (threadIdx.x == 0) atomicAdd(&state[0], 1u);
  }
}

// Launch one instantiation with `smem` bytes of dynamic shared memory
// (opted in first), `resident` = the CTAs the card holds at once.
template <int B, bool kDecodeOnly>
int launch(const void* words_t, const void* qT, void* keys, void* state,
           long long num_rows, long long n_pad, int num_words, int b,
           int b_pad, int cap, int grid_x, int smem, cudaStream_t stream) {
  auto kernel = keys_t_kernel<B, kDecodeOnly>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, kernel, kThreads, smem)) != cudaSuccess)
    return (int)e;
  kernel<<<grid_x, kThreads, smem, stream>>>(
      (const uint32_t*)words_t, (const __nv_bfloat16*)qT, (int32_t*)keys,
      (unsigned*)state, num_rows, n_pad, num_words, b, b_pad, cap,
      sms * per > 0 ? sms * per : 1);
  return (int)cudaGetLastError();
}

}  // namespace vs_t

// `entry`(words_t, qT, keys, state, num_rows, n_pad, num_words, b, b_pad,
// bucket, cap, grid_x, smem, stream): words_t [num_words, n_pad] uint32
// (n_pad % 1024 == 0, num_words % 8 == 0), qT [VP, b_pad] bf16 (b_pad % 32
// == 0, 16-byte aligned, VP <= 65,536), keys [n_pad / bucket, b] int32,
// state [2] uint32 (the pass clock, the long rows; never reset), bucket 1,
// 2, 4 or 8; cap, grid_x and smem from probes.keys_t_geometry, checked
// here. Returns a cudaError_t. `entry`_occupancy: the CTAs one SM holds at
// bucket 8 and the default capacity (probes.KEYS_T_CAP).
#define VS_KEYS_T_ENTRY(entry, decode_only)                                  \
  extern "C" int entry(const void* words_t, const void* qT, void* keys,      \
                       void* state, long long num_rows, long long n_pad,     \
                       int num_words, int b, int b_pad, int bucket, int cap, \
                       int grid_x, int smem, void* stream) {                 \
    if (n_pad <= 0 || b <= 0) return 0;                                      \
    if (n_pad % vs_t::kRowBlock || num_words % vs_t::kWordsInFlight ||       \
        b_pad % vs_t::kQ || b > b_pad || cap <= 0 || cap % 8 ||              \
        grid_x != n_pad / vs_t::kRows || smem != vs_t::smem_bytes(cap))      \
      return (int)cudaErrorInvalidValue;                                     \
    cudaStream_t s = (cudaStream_t)stream;                                   \
    switch (bucket) {                                                        \
      case 1:                                                                \
        return vs_t::launch<1, decode_only>(words_t, qT, keys, state,        \
                                            num_rows, n_pad, num_words, b,   \
                                            b_pad, cap, grid_x, smem, s);    \
      case 2:                                                                \
        return vs_t::launch<2, decode_only>(words_t, qT, keys, state,        \
                                            num_rows, n_pad, num_words, b,   \
                                            b_pad, cap, grid_x, smem, s);    \
      case 4:                                                                \
        return vs_t::launch<4, decode_only>(words_t, qT, keys, state,        \
                                            num_rows, n_pad, num_words, b,   \
                                            b_pad, cap, grid_x, smem, s);    \
      case 8:                                                                \
        return vs_t::launch<8, decode_only>(words_t, qT, keys, state,        \
                                            num_rows, n_pad, num_words, b,   \
                                            b_pad, cap, grid_x, smem, s);    \
      default:                                                               \
        return (int)cudaErrorInvalidValue;                                   \
    }                                                                        \
  }                                                                          \
  extern "C" int entry##_occupancy(int* ctas_per_sm) {                       \
    auto kernel = vs_t::keys_t_kernel<8, decode_only>;                       \
    const int smem = vs_t::smem_bytes(192);                                  \
    cudaError_t e = cudaFuncSetAttribute(                                    \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);          \
    if (e != cudaSuccess) return (int)e;                                     \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(               \
        ctas_per_sm, kernel, vs_t::kThreads, smem);                          \
  }
