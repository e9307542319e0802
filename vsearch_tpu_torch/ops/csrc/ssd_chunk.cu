// The Mamba-2 chunk scan of a granite-4.0-h mixer, one sequence chunk
// (vsearch_tpu_torch/ops/ssd.py `ssd_chunk`; plain twin `ssd_chunk_plain`).
//
// Replaces no TPU kernel: the JAX package has no state-space trunk. Added
// because the plain form materialises [B, L, L, heads] decay tensors in each
// of the trunk's 36 Mamba-2 layers. From the in-projection's bf16 output
// proj = [z | xBC | dt] it computes, in f32 and in one launch: the causal
// depthwise conv (4 taps) of xBC plus its bias, SiLU, split into x [heads x
// 64], B [128] and C [128]; delta = softplus(dt + dt_bias) and the running
// sum cs of delta * A (A = -exp(A_log)); then per head, from a zero state,
//   y[t] = sum_{s <= t} (C[t] . B[s]) exp(cs[t] - cs[s]) delta[s] x[s]
//          + D x[t],
// the single-chunk SSD (the recurrence S_t = exp(delta_t A) S_{t-1} +
// delta_t x_t B_t^T, y_t = S_t C_t + D x_t written out), stored as bf16.
//
// Bound on the H100: at the rerank's 64-256 positions, the L^2 products on
// the CUDA cores (f32) against the bytes of proj's xBC and dt read once and
// y written once; they are within a factor of two of each other at L ~ 100.
// Design: one CTA a (64-row tile of t, 16 heads, sequence). G = C B^T is
// shared by every head (one group): the CTA computes its rows' G against
// every s up to the tile's end once (64 x 256 f32 in shared memory), then
// for each of its heads walks the s tiles: the conv of the head's 64 x
// channels over the tile (from L2; a thread slides the 4-tap window down
// 16 rows of one channel, its loads all in flight at once), the
// decay-weighted tile of G, and a 64 x 64 x 64 product in registers (4 x 4
// a thread). Nothing but y is written to device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows t of a CTA; positions s of a step
constexpr int kPad = kTile + 4;  // padded rows of the G phase's tiles
constexpr int kHeadDim = 64;
constexpr int kState = 128;
constexpr int kConv = 4;
constexpr int kMaxLen = 256;
constexpr int kHeadsPerCta = 16;
constexpr int kChunkN = 32;  // state columns of B a G step holds

struct GPhase {
  float ct[kState][kPad];   // C of the tile's rows, transposed
  float bt[kChunkN][kPad];  // a chunk of B of one s tile, transposed
};
struct HPhase {
  float xs[kTile][kHeadDim];  // x of one head over one s tile
  float mt[kTile][kTile];     // its decay-weighted G, [s][t]
};
struct Smem {
  float gt[kMaxLen][kTile];  // G[t][s] of the tile's rows, as [s][t]
  float cs[kMaxLen];         // running sum of delta * A, one head
  float delta[kMaxLen];
  union {
    GPhase g;
    HPhase h;
  } u;
};

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + __expf(-v));
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));  // torch's threshold
}

// SiLU(bias[c] + sum_k w[c][k] * xbc[s - 3 + k][c]) of channel c at rows
// s0 .. s0 + kRows - 1 into dst[r * dst_stride]: one thread slides the
// 4-tap window down its rows, with the channel's taps in registers and
// every load issued up front. Rows before 0 read as 0; rows at or past len
// come out 0.
template <int kRows>
__device__ __forceinline__ void conv_silu_rows(
    const __nv_bfloat16* __restrict__ xbc, long long stride, int len, int c,
    int s0, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, float* dst, int dst_stride) {
  static_assert(kConv == 4, "the window holds three rows before s");
  const float w0 = ld(w + c * kConv), w1 = ld(w + c * kConv + 1);
  const float w2 = ld(w + c * kConv + 2), w3 = ld(w + c * kConv + 3);
  const float b = ld(bias + c);
  float x[kRows + 3];
#pragma unroll
  for (int r = 0; r < kRows + 3; ++r) {
    const int s = s0 - 3 + r;
    x[r] = (s >= 0 && s < len) ? ld(xbc + (long long)s * stride + c) : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float acc = fmaf(w0, x[r], b);
    acc = fmaf(w1, x[r + 1], acc);
    acc = fmaf(w2, x[r + 2], acc);
    acc = fmaf(w3, x[r + 3], acc);
    dst[r * dst_stride] = s0 + r < len ? silu(acc) : 0.0f;
  }
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const __nv_bfloat16* __restrict__ proj, long long stride,
                 int x_off, int dt_off,
                 const __nv_bfloat16* __restrict__ conv_w,
                 const __nv_bfloat16* __restrict__ conv_b,
                 const __nv_bfloat16* __restrict__ dt_bias,
                 const __nv_bfloat16* __restrict__ a_log,
                 const __nv_bfloat16* __restrict__ d_skip,
                 __nv_bfloat16* __restrict__ out, int len, int heads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tile = blockIdx.x;
  const int b = blockIdx.z;
  const int t0 = tile * kTile;
  const int t_hi = min(t0 + kTile, len);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int hp = heads * kHeadDim;
  const __nv_bfloat16* xbc = proj + (long long)b * len * stride + x_off;
  const __nv_bfloat16* dts = proj + (long long)b * len * stride + dt_off;

  // 1. G = C B^T: the tile's rows t against every s below t_hi
  {  // C: a channel and 32 rows a thread
    static_assert(kThreads == 2 * kState, "two row blocks of C");
    const int n = tid % kState, rb = (tid / kState) * (kTile / 2);
    conv_silu_rows<kTile / 2>(xbc, stride, len, hp + kState + n, t0 + rb,
                              conv_w, conv_b, &sm.u.g.ct[n][rb], 1);
  }
  for (int j = 0; j <= tile; ++j) {
    float acc[4][4] = {};
    for (int n0 = 0; n0 < kState; n0 += kChunkN) {
      __syncthreads();  // C written; the last chunk of B read
      {  // a chunk of B: a channel and 8 rows a thread
        constexpr int kRows = kChunkN * kTile / kThreads;
        const int n = tid % kChunkN, rb = (tid / kChunkN) * kRows;
        conv_silu_rows<kRows>(xbc, stride, len, hp + n0 + n,
                              j * kTile + rb, conv_w, conv_b,
                              &sm.u.g.bt[n][rb], 1);
      }
      __syncthreads();
#pragma unroll 8
      for (int n = 0; n < kChunkN; ++n) {
        fma4x4(acc,
               *reinterpret_cast<const float4*>(&sm.u.g.ct[n0 + n][4 * ty]),
               *reinterpret_cast<const float4*>(&sm.u.g.bt[n][4 * tx]));
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      *reinterpret_cast<float4*>(&sm.gt[j * kTile + 4 * tx + jj][4 * ty]) =
          make_float4(acc[0][jj], acc[1][jj], acc[2][jj], acc[3][jj]);
    }
  }

  // 2. each head of the group over the s tiles up to this one
  for (int hh = 0; hh < kHeadsPerCta; ++hh) {
    const int h = blockIdx.y * kHeadsPerCta + hh;
    __syncthreads();  // G written; the last head's cs, delta, xs, mt read
    if (warp == 0) {  // delta and the running sum of delta * A, 8 a lane
      const float a = -expf(ld(a_log + h));
      const float bias = ld(dt_bias + h);
      float loc[kMaxLen / 32];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxLen / 32; ++k) {
        const int s = lane * (kMaxLen / 32) + k;
        if (s < t_hi) {
          const float dl = softplus(ld(dts + (long long)s * stride + h) + bias);
          sm.delta[s] = dl;
          run += dl * a;
        }
        loc[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const float before = incl - run;
#pragma unroll
      for (int k = 0; k < kMaxLen / 32; ++k) {
        const int s = lane * (kMaxLen / 32) + k;
        if (s < t_hi) sm.cs[s] = before + loc[k];
      }
    }
    __syncthreads();
    const float dh = ld(d_skip + h);
    float acc[4][4] = {};
    for (int j = 0; j <= tile; ++j) {
      {  // x of the head: a channel and 16 rows a thread
        constexpr int kRows = kTile * kHeadDim / kThreads;
        const int p = tid % kHeadDim, rb = (tid / kHeadDim) * kRows;
        conv_silu_rows<kRows>(xbc, stride, len, h * kHeadDim + p,
                              j * kTile + rb, conv_w, conv_b,
                              &sm.u.h.xs[rb][p], kHeadDim);
      }
      for (int i = tid; i < kTile * kTile; i += kThreads) {
        const int sl = i / kTile, tl = i % kTile;
        const int s = j * kTile + sl, t = t0 + tl;
        sm.u.h.mt[sl][tl] =
            (s <= t && t < t_hi)
                ? sm.gt[s][tl] * __expf(sm.cs[t] - sm.cs[s]) * sm.delta[s]
                : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int s = 0; s < kTile; ++s) {
        fma4x4(acc, *reinterpret_cast<const float4*>(&sm.u.h.mt[s][4 * ty]),
               *reinterpret_cast<const float4*>(&sm.u.h.xs[s][4 * tx]));
      }
      if (j == tile) {  // the D skip: x at the tile's own rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[i][jj] = fmaf(dh, sm.u.h.xs[4 * ty + i][4 * tx + jj],
                              acc[i][jj]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + 4 * ty + i;
      if (t < len) {
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
            out + ((long long)b * len + t) * hp + h * kHeadDim + 4 * tx);
        o[0] = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
        o[1] = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      }
    }
  }
}

}  // namespace

// proj [batch, len, stride] bf16 (xBC at column x_off, dt at dt_off), the
// conv's weight [conv_dim, 4] and bias [conv_dim], dt_bias, A_log and D
// [heads], all bf16; out [batch, len, heads * 64] bf16 (every element
// written). len <= 256, heads a multiple of 16. Returns cudaGetLastError().
extern "C" int vs_ssd_chunk(const void* proj, long long stride, int x_off,
                            int dt_off, const void* conv_w,
                            const void* conv_b, const void* dt_bias,
                            const void* a_log, const void* d_skip, void* out,
                            int batch, int len, int heads, void* stream) {
  if (batch <= 0 || len <= 0) return 0;
  if (len > kMaxLen || heads <= 0 || heads % kHeadsPerCta) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(Smem);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((len + kTile - 1) / kTile, heads / kHeadsPerCta, batch);
  ssd_chunk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)proj, stride, x_off, dt_off,
      (const __nv_bfloat16*)conv_w, (const __nv_bfloat16*)conv_b,
      (const __nv_bfloat16*)dt_bias, (const __nv_bfloat16*)a_log,
      (const __nv_bfloat16*)d_skip, (__nv_bfloat16*)out, len, heads);
  return (int)cudaGetLastError();
}
