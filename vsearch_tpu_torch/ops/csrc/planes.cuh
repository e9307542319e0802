// The plane form: the row core of kernels #2 (scores_plane.cu) and #3
// (bucketed_plane.cu) for dense rows, on Hopper's tensor cores.
//
// It is the TPU kernel's own bit-plane product (vsearch_tpu/ops/bitpack.py
// `_accumulate_scores`): in the packed layout (bitrow.cuh) vocab id
// v = t * 4096 + p * 128 + w lives in word t * 128 + w, bit p, so bit plane
// p of tile t, over a row's 128 words of the tile, is the 0/1 row that
// multiplies the 128 consecutive query rows t * 4096 + p * 128 + [0, 128).
// Each plane is one [rows, 128] x [128, 32] product on the tensor cores
// (wgmma m64n32k16, bf16 in, f32 sums), and no bf16 copy of the bits is
// ever written to memory: each thread turns its rows' words into the A
// fragments in registers, one plane at a time.
//
// Why: the gather form (bitrow.cuh `score_rows`) pays for each set bit, so
// at 768 ids a row it gathers ~12.9 GB of the query operand out of L2 for a
// 262,144-row block (13x its byte bound). The plane form pays for each
// plane, whatever the density: 231 planes x 128 x 2 x 32 operations a row
// at V' = 29,523 (0.50 ms a 262,144-row block at the bf16 peak, above the
// bits' 0.32 ms of bytes). Below the crossover row width
// (bitpack.PLANE_MIN_BITS, from card measurements) the gather form stays
// cheaper, and in matrices of fewer rows than bitpack.PLANE_MIN_ROWS too:
// a CTA runs its planes in series, so a grid that leaves SMs idle is
// bound by that latency.
//
// Geometry (bitpack.plane_geometry): a CTA is kPlaneWarpgroups = 4
// consumer warpgroups, each owning 64 consecutive rows of a 256-row pass
// (the tensor core's m64), and one producer warp. In a warpgroup, warp i
// holds rows 16 i + g and 16 i + g + 8 (g = lane / 4), as the A fragment
// puts them (PTX ISA, "Register Fragments" of wgmma .m64nNk16).
// blockIdx.y tiles the queries by 32 (N = 32).
//
// One step is one half of one plane: 64 query rows (K = 4 x k16) x 32
// queries, a 4 KB slice of the operand. The wrapper lays the operand out
// as these slices in step order, each already in wgmma's K-major core
// matrix layout (bitpack._plane_operand), so the producer warp stages a
// slice with one bulk copy (cp.async.bulk) into a ring of kPlaneStages in
// dynamic shared memory, completing a `full` mbarrier; each consumer warp
// waits on it, multiplies, waits for its products (wait_group 0), then
// arrives on the slot's `empty` mbarrier, which the producer waits on
// before refilling it. The warpgroups thus run out of step, one building
// fragments on the integer units while another's products run on the
// tensor cores. Each pass re-reads the whole operand from L2 (2 MB at
// V' = 29,523, B = 32), twice the bytes of its 256 rows' bits; 16 slices
// in flight hide the copies' latency. Planes at or past num_cols are
// skipped, as `_accumulate_scores` skips them (an odd count runs one zero
// plane more).
//
// A fragments: the bf16x2 of plane p for the word pair (x, y) (columns c,
// c + 1 of one row) holds bit p of x low and bit p of y high. zlo =
// (x & 0xffff) | (y << 16) holds planes 0-15 of both at bits p and p + 16,
// zhi planes 16-31. Planes go in pairs (p even): one rotation puts bits
// p and p + 1 of both halves at bits 13, 14 and 29, 30, and two masks
// make the fragments, 0x2000 (bf16 2^-63) for plane p and 0x4000 (2.0)
// for p + 1. The wrapper scales the operand's even planes by 2^64, so
// every product is exactly twice the query weight, and the sums are halved,
// exactly, when read: three integer operations for two fragment
// registers.
//
// Summation order: each product is exact, but the tensor core adds them
// in its own order, so the plane form equals the plain version bit for bit
// only where every partial sum is exact (the dyadic operands of the
// tests), and otherwise to f32 rounding. #2 and #3 run the same steps in
// the same order for every pass, so #3's keys are #2's plane-form scores
// spliced and folded, bit for bit.
//
// Designs measured slower on the H100 while this one was built: all
// threads copying by cp.async with a CTA barrier a step; a ring of 6
// slices; overlapping a warpgroup's products with its next fragments
// (wait_group 1: more registers, spills); one plane a rotation.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vs {

constexpr int kPlaneWarpgroups = 4;
constexpr int kPlaneConsumers = kPlaneWarpgroups * 128;
constexpr int kPlaneThreads = kPlaneConsumers + 32;  // + the producer warp
constexpr int kPlaneRows = kPlaneWarpgroups * 64;    // rows of one pass
constexpr int kPlaneN = 32;                          // queries a CTA
constexpr int kPlaneStepBytes = 64 * kPlaneN * 2;    // one slice: 4 KB
constexpr int kPlaneStages = 16;
// the ring, in dynamic shared memory (the launch passes these bytes)
constexpr int kPlaneRingBytes = kPlaneStages * kPlaneStepBytes;

// A shared-memory matrix descriptor of wgmma, no swizzle: start address,
// leading byte offset (between the two 8-column core matrices along K) and
// stride byte offset (between 8-row core matrices along N), in 16 B units.
__device__ __forceinline__ uint64_t plane_desc(const void* smem, int lbo,
                                               int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[16] += A (4 bf16x2 registers: this thread's fragment of a 64 x 16
// tile) x B (16 x 32 in shared memory, K-major), f32 sums.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy (the async proxy) of `bytes` into shared memory, counted
// on `bar` (whose phase then expects those bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The variants of the pass. Only kPlaneShipped computes the function; the
// other two are timing probes, built into their own libraries
// (plane_operand_only.cu, plane_fragments_only.cu) and never on a search
// path, whose keys are neither compared nor used. Both stream the rows'
// words from device memory as the shipped pass does, and each drops one
// of the pass's other two streams of work: kPlaneOperandOnly loads every
// word but builds no fragments (it multiplies one fixed pair, and the
// loaded words go to an asm sink), so only the operand streams through
// the ring; kPlaneFragmentsOnly fills the ring once and multiplies its
// slices again, so only the fragments are built.
constexpr int kPlaneShipped = 0;
constexpr int kPlaneOperandOnly = 1;
constexpr int kPlaneFragmentsOnly = 2;

// The plane core: this CTA runs `passes` passes of 256 rows, the first at
// row `row0`, pass i at row0 + i * 256, over the query tile blockIdx.y.
// After each pass every consumer thread calls epi(row, acc) with its first
// row (the second is row + 8) and its f32 sums, doubled: acc[4 j + e] is
// row + 8 * (e >> 1), query 8 j + 2 (lane % 4) + (e & 1) of the tile. The
// producer warp returns without calling it; `consumers_sync()` below joins
// the consumers alone.
//
// words [n_pad, num_words] uint32 (num_words % 128 == 0); qI [b_pad / 32,
// 2 * nplanes, 4096 B]: the query operand as the ring's slices, in step
// order (bitpack._plane_operand). nplanes = the planes of the row below
// num_cols, ceil(num_cols / 128) rounded up to even; tile t holds
// min(32, nplanes - 32 t). `kVariant` is kPlaneShipped but in the timing
// probes (above).
template <int kVariant = kPlaneShipped, typename Epi>
__device__ __forceinline__ void plane_rows(
    const uint32_t* __restrict__ words, const uint8_t* __restrict__ qI,
    long long n_pad, int num_words, int nplanes, long long row0, int passes,
    Epi&& epi) {
  extern __shared__ __align__(128) uint8_t plane_ring[];
  auto ring = reinterpret_cast<uint8_t(*)[kPlaneStepBytes]>(plane_ring);
  __shared__ __align__(8) uint64_t full[kPlaneStages];
  __shared__ __align__(8) uint64_t empty[kPlaneStages];
  const int tid = threadIdx.x;
  // the role, uniform over each warp (broadcast, so the compiler sees it)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int pass_steps = 2 * nplanes;
  const int total = passes * pass_steps;
  if (tid == 0) {
    for (int i = 0; i < kPlaneStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kPlaneConsumers / 32);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kPlaneWarpgroups) {  // the producer warp
    if ((tid & 31) == 0) {
      const uint8_t* src = qI + (size_t)blockIdx.y * pass_steps *
                                    kPlaneStepBytes;
      const int loads = kVariant == kPlaneFragmentsOnly
                            ? min(total, kPlaneStages)
                            : total;
      for (int s = 0; s < loads; ++s) {
        const int slot = (int)(s % kPlaneStages);
        const int use = (int)(s / kPlaneStages);
        if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
        bulk_load(ring[slot],
                  src + (size_t)(s % pass_steps) * kPlaneStepBytes,
                  kPlaneStepBytes, &full[slot]);
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int my_row = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // in the pass
  const int tiles = (nplanes + 31) / 32;
  // the descriptor of k16 chunk c of slot i is desc0 + (i * 4096 + c *
  // 1024) / 16: only the start address (bits 0-13) moves
  const uint64_t desc0 = plane_desc(ring[0], 512, 128);
  int step = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const long long r0 = row0 + (long long)pass * kPlaneRows + my_row;
    const long long r1 = r0 + 8;
    // rows past n_pad read row n_pad - 1; their sums are never written
    const uint32_t* w0 = words + min(r0, n_pad - 1) * num_words;
    const uint32_t* w1 = words + min(r1, n_pad - 1) * num_words;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const int planes = min(32, nplanes - 32 * t);
      for (int h = 0; h < 2; ++h) {
        // z[c][r][0/1]: planes 0-15 / 16-31 of fragment register r of
        // k16 chunk c: r = 0, 1 rows r0, r1 at columns 2 tig, +1; r = 2, 3
        // at columns 2 tig + 8, +9 (columns = words 64 h + 16 c + ...)
        uint32_t z[4][4][2];
        uint32_t sink = 0;  // kPlaneOperandOnly: the words, kept loaded
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int w = t * 128 + h * 64 + c * 16 + 2 * tig;
          uint2 v[4];
          v[0] = __ldcs(reinterpret_cast<const uint2*>(w0 + w));
          v[1] = __ldcs(reinterpret_cast<const uint2*>(w1 + w));
          v[2] = __ldcs(reinterpret_cast<const uint2*>(w0 + w + 8));
          v[3] = __ldcs(reinterpret_cast<const uint2*>(w1 + w + 8));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (kVariant == kPlaneOperandOnly) {
              sink ^= v[r].x ^ v[r].y;
            } else {
              z[c][r][0] = __byte_perm(v[r].x, v[r].y, 0x5410);
              z[c][r][1] = __byte_perm(v[r].x, v[r].y, 0x7632);
            }
          }
        }
        if constexpr (kVariant == kPlaneOperandOnly)
          asm volatile("" ::"r"(sink));
        // planes p, p + 1 a round (tiles hold even counts: nplanes is
        // even, bitpack.plane_geometry): one rotation puts bits p, p + 1
        // of both halves at bits 13, 14 and 29, 30, and two masks make
        // the fragments, bf16 2^-63 (0x2000) and 2.0 (0x4000); the
        // operand's even planes come scaled by 2^64, so every product is
        // twice the query weight
#pragma unroll
        for (int p = 0; p < 32; p += 2) {
          if (p >= planes) break;  // planes past num_cols (uniform)
          uint32_t ae[4][4], ao[4][4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if constexpr (kVariant == kPlaneOperandOnly) {
                ae[c][r] = 0x20002000u;  // one fixed pair, no building
                ao[c][r] = 0x40004000u;
              } else {
                const uint32_t x = __funnelshift_l(
                    z[c][r][p >> 4], z[c][r][p >> 4], (13 - (p & 15)) & 31);
                ae[c][r] = x & 0x20002000u;
                ao[c][r] = x & 0x40004000u;
              }
            }
          const int s0 = step % kPlaneStages, s1 = (step + 1) % kPlaneStages;
          // kPlaneFragmentsOnly: the ring's slots hold their first slices
          // for good (the phase of parity 0 completes once)
          const bool once = kVariant == kPlaneFragmentsOnly;
          mbar_wait(&full[s0], once ? 0 : (step / kPlaneStages) & 1);
          mbar_wait(&full[s1], once ? 0 : ((step + 1) / kPlaneStages) & 1);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wgmma_m64n32k16(acc, ae[c], desc0 + s0 * 256 + c * 64);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wgmma_m64n32k16(acc, ao[c], desc0 + s1 * 256 + c * 64);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          if (lane == 0 && kVariant != kPlaneFragmentsOnly) {
            mbar_arrive(&empty[s0]);
            mbar_arrive(&empty[s1]);
          }
          step += 2;
        }
      }
    }
    epi(row0 + (long long)pass * kPlaneRows + my_row, acc);
  }
}

// a barrier of the consumer warpgroups alone (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPlaneConsumers) : "memory");
}

}  // namespace vs

// `<entry>_occupancy`: the CTAs of a plane-form `kernel` one SM holds,
// with the ring's dynamic shared memory opted in first (as at a launch:
// the query must not depend on a launch having come before it).
#define VS_PLANE_OCCUPANCY_ENTRY(entry, kernel)                          \
  extern "C" int entry##_occupancy(int* ctas_per_sm) {                   \
    cudaError_t e = cudaFuncSetAttribute(                                \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,             \
        vs::kPlaneRingBytes);                                            \
    if (e != cudaSuccess) return (int)e;                                 \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(           \
        ctas_per_sm, kernel, vs::kPlaneThreads, vs::kPlaneRingBytes);    \
  }

// launch `kernel` with the ring's dynamic shared memory, opted in first
#define VS_PLANE_LAUNCH(kernel, grid, stream, ...)                       \
  do {                                                                   \
    cudaError_t e = cudaFuncSetAttribute(                                \
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,             \
        vs::kPlaneRingBytes);                                            \
    if (e != cudaSuccess) return (int)e;                                 \
    kernel<<<grid, vs::kPlaneThreads, vs::kPlaneRingBytes, stream>>>(    \
        __VA_ARGS__);                                                    \
  } while (0)
