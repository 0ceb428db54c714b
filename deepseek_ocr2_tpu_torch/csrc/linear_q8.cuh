// Int8-weight skinny GEMM (w8a16) device code for sm_90a: the body of
// kernel H (linear_q8.cu), also used for the two projections of kernel K
// (attn_fused.cu) and the expert products of kernels I and J (moe_q8.cu).
//
//   out[b, o] = round_O((sum_k x[b, k] * q[o, k]) * scale[o])
//
// q is int8 [Out, In] (HF's [out, in] layout, per-output-channel symmetric
// codes), scale f32 [Out], x [B, In] in f32 or bf16, out [B, Out] in f32 or
// bf16. float(int8) is exact and so is a bf16 x int8 product in f32, so this
// is the TPU kernel's math (dequant to x's type, one f32-accumulated dot,
// scale after the dot) up to the order of the f32 sum.
//
// Two forms:
// - bf16 x, In a multiple of 64, more than 4 rows: the tensor cores. mma.sync m16n8k16 with
//   the weights as A (16 output rows, codes widened to bf16, exact) and x as
//   B (8 rows of the batch; rows past B are zeros). A block of 8 warps takes
//   MT 16-row tiles and all the batch's rows (NTL 8-row tiles); the warps
//   split the contraction into 64-wide chunks (warp w takes chunks w, w + 8,
//   ...) and sum their partial tiles through shared memory in warp order,
//   so the result does not depend on timing. In a chunk a lane reads 16
//   contiguous codes of each of its two rows (g and g + 8 of the tile: one
//   16-byte load each) and 16 contiguous values of its x row, and feeds
//   them to 4 mma steps: the dot is a sum over k in any order, so mma step
//   j's logical k pairs (2q, 2q + 1) and (2q + 8, 2q + 9) are mapped to the
//   physical k 16q + 4j + (0, 1) and (2, 3) of the chunk, the same for A and
//   B. Each weight byte is read once; x comes through the read-only cache.
// - otherwise (f32 x, a ragged In, 1-4 rows): plain FMAs on the CUDA cores, one
//   warp per COLS output rows and RB rows of x per block. A lane loads 16
//   codes (one 16-byte load) of each of its rows per step and widens them
//   once for all RB rows of x; the COLS * RB partial sums reduce across the
//   warp with xor shuffles. From B = 8 the x loads from L1 (RB rows per
//   weight load) bound this form, hence the tensor cores for bf16.
//
// Shapes: In a multiple of 16 with 16-byte aligned rows (the wrappers check
// both); any B and Out.

#pragma once

#include "gemv_common.cuh"

namespace q8 {

using gemv::FULL;
using gemv::from_f32;
using gemv::mma_bf16;
using gemv::NT;
using gemv::to_f32;
using gemv::warp_sum;
using gemv::WARPS;
using gemv::word;

constexpr int KV = 16;  // codes per lane per step

__device__ __forceinline__ void load16(const float* p, float* o) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = __ldg(v + j);
    o[4 * j] = f.x;
    o[4 * j + 1] = f.y;
    o[4 * j + 2] = f.z;
    o[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* o) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = __ldg(v + j);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      o[8 * j + 2 * t] = f.x;
      o[8 * j + 2 * t + 1] = f.y;
    }
  }
}

// 16 int8 codes (one 16-byte word) widened to f32, exactly.
__device__ __forceinline__ void widen16(const uint4 w, float* o) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int t = 0; t < 4; ++t) o[4 * j + t] = (float)(((int)(u[j] << (24 - 8 * t))) >> 24);
  }
}



// Partial dots of COLS int8 rows (row pointers `rows`) against RB rows of x
// starting at x + b0 * in_dim, reduced across the warp: acc[c * RB + r].
template <typename T, int RB, int COLS>
__device__ __forceinline__ void warp_dots(const T* __restrict__ x, int nb, int b0, int in_dim,
                                          const int8_t* const* rows, float* acc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < COLS * RB; ++j) acc[j] = 0.f;
#pragma unroll 2
  for (int k = lane * KV; k < in_dim; k += 32 * KV) {
    float w[COLS][KV];
#pragma unroll
    for (int c = 0; c < COLS; ++c) widen16(__ldg(reinterpret_cast<const uint4*>(rows[c] + k)), w[c]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < nb) {
        float xv[KV];
        load16(x + (size_t)(b0 + r) * in_dim + k, xv);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
#pragma unroll
          for (int j = 0; j < KV; ++j) acc[c * RB + r] = fmaf(xv[j], w[c][j], acc[c * RB + r]);
        }
      }
    }
  }
  warp_sum<COLS * RB>(acc);
}

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 x).

constexpr int MK = 64;  // contraction chunk

// Two int8 codes of a word (bytes t, t + 1) as a bf16x2, exactly.
__device__ __forceinline__ unsigned widen2_bf16(unsigned w, int t) {
  const float lo = (float)(((int)(w << (24 - 8 * t))) >> 24);
  const float hi = (float)(((int)(w << (16 - 8 * t))) >> 24);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Partial tiles of MT 16-row weight tiles against NTL 8-row tiles of x (x
// rows b0 ..), summed over all of In by the block's warps: on return warp
// 0 holds acc[mt][nt][c] for weight row (tile mt) g + 8 (c / 2) and x row
// b0 + 8 nt + 2q + c % 2, where g = lane / 4, q = lane % 4. rlo[mt] / rhi[mt]
// point at this lane's weight rows g and g + 8 of tile mt (a ragged tile
// repeats a valid row). `red` is shared memory of WARPS * 32 * MT * NTL * 4
// floats. Every thread of the block must call it.
template <int MT, int NTL>
__device__ __forceinline__ void block_mma_dots(const __nv_bfloat16* __restrict__ x, int nb, int b0, int in_dim,
                                               const int8_t* const* rlo, const int8_t* const* rhi,
                                               float (&acc)[MT][NTL][4], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  const int n_chunks = in_dim / MK;
#pragma unroll 2
  for (int ch = warp; ch < n_chunks; ch += WARPS) {
    const int k0 = ch * MK + 16 * q;
    uint4 xv[NTL][2];
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int row = b0 + 8 * nt + g;
      if (row < nb) {
        const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * in_dim + k0);
        xv[nt][0] = __ldg(p);
        xv[nt][1] = __ldg(p + 1);
      } else {
        xv[nt][0] = xv[nt][1] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint4 wl = __ldg(reinterpret_cast<const uint4*>(rlo[mt] + k0));
      const uint4 wh = __ldg(reinterpret_cast<const uint4*>(rhi[mt] + k0));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned a[4] = {widen2_bf16(word(wl, j), 0), widen2_bf16(word(wh, j), 0),
                               widen2_bf16(word(wl, j), 2), widen2_bf16(word(wh, j), 2)};
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
          // x words 2j, 2j + 1 of the lane's 16 values: k 16q + 4j + (0, 1), (2, 3)
          const uint4& xh = xv[nt][j / 2];
          mma_bf16(acc[mt][nt], a, word(xh, 2 * (j % 2)), word(xh, 2 * (j % 2) + 1));
        }
      }
    }
  }
  constexpr int PER = MT * NTL * 4;
  float* mine = red + ((size_t)warp * 32 + lane) * PER;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) mine[(mt * NTL + nt) * 4 + c] = acc[mt][nt][c];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float s = 0.f;
          for (int w = 0; w < WARPS; ++w) s += red[((size_t)w * 32 + lane) * PER + (mt * NTL + nt) * 4 + c];
          acc[mt][nt][c] = s;
        }
  }
}

// Block: output rows [blockIdx.x * 16 * MT, + 16 * MT), x rows
// [blockIdx.y * 8 * NTL, + 8 * NTL).
template <typename O, int MT, int NTL>
__global__ void __launch_bounds__(NT) gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                                                      const float* __restrict__ scale, O* __restrict__ out, int nb,
                                                      int in_dim, int out_dim) {
  __shared__ float red[WARPS * 32 * MT * NTL * 4];
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int o0 = blockIdx.x * 16 * MT;
  const int b0 = blockIdx.y * 8 * NTL;
  const int8_t* rlo[MT];
  const int8_t* rhi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    rlo[mt] = q + (size_t)min(o0 + 16 * mt + g, out_dim - 1) * in_dim;
    rhi[mt] = q + (size_t)min(o0 + 16 * mt + g + 8, out_dim - 1) * in_dim;
  }
  float acc[MT][NTL][4];
  block_mma_dots<MT, NTL>(x, nb, b0, in_dim, rlo, rhi, acc, red);
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = o0 + 16 * mt + g + 8 * (c / 2);
        const int b = b0 + 8 * nt + 2 * qd + c % 2;
        if (o < out_dim && b < nb) out[(size_t)b * out_dim + o] = from_f32<O>(acc[mt][nt][c] * scale[o]);
      }
}

template <typename O, int MT, int NTL>
int launch_mma(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
               cudaStream_t s) {
  const dim3 grid((out_dim + 16 * MT - 1) / (16 * MT), (nb + 8 * NTL - 1) / (8 * NTL));
  gemv_mma_kernel<O, MT, NTL><<<grid, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const int8_t*>(q), static_cast<const float*>(scale),
                                                  static_cast<O*>(out), nb, in_dim, out_dim);
  return (int)cudaGetLastError();
}

// NTL: 8-row x tiles covering B (1, 2 or 4; tiles of 32 rows above). MT: two
// row tiles a block when that still leaves a few blocks an SM.
template <typename O>
int gemv_mma(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
             cudaStream_t s) {
  const bool wide = out_dim >= 2 * 132 * 32;
#define Q8_MMA(MT, NTL) return launch_mma<O, MT, NTL>(x, q, scale, out, nb, in_dim, out_dim, s)
  if (nb <= 8) { if (wide) Q8_MMA(2, 1); Q8_MMA(1, 1); }
  if (nb <= 16) { if (wide) Q8_MMA(2, 2); Q8_MMA(1, 2); }
  if (wide) Q8_MMA(2, 4);
  Q8_MMA(1, 4);
#undef Q8_MMA
}

// ---------------------------------------------------------------------------
// CUDA-core form.

// Block: output rows [(blockIdx.x * WARPS + warp) * COLS, + COLS), x rows
// [blockIdx.y * RB, + RB).
template <typename T, typename O, int RB, int COLS>
__global__ void __launch_bounds__(NT) gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                                                  const float* __restrict__ scale, O* __restrict__ out, int nb,
                                                  int in_dim, int out_dim) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = (blockIdx.x * WARPS + warp) * COLS;
  const int b0 = blockIdx.y * RB;
  if (o0 >= out_dim) return;  // warp-uniform
  const int8_t* rows[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) rows[c] = q + (size_t)min(o0 + c, out_dim - 1) * in_dim;  // ragged: re-read
  float acc[COLS * RB];
  warp_dots<T, RB, COLS>(x, nb, b0, in_dim, rows, acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int o = o0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < nb && o < out_dim) {
        out[(size_t)(b0 + r) * out_dim + o] = from_f32<O>(acc[c * RB + r] * scale[o]);
      }
    }
  }
}

template <typename T, typename O, int RB, int COLS>
int launch_rb(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
              cudaStream_t s) {
  const dim3 grid((out_dim + WARPS * COLS - 1) / (WARPS * COLS), (nb + RB - 1) / RB);
  gemv_kernel<T, O, RB, COLS><<<grid, NT, 0, s>>>(static_cast<const T*>(x), static_cast<const int8_t*>(q),
                                                  static_cast<const float*>(scale), static_cast<O*>(out), nb,
                                                  in_dim, out_dim);
  return (int)cudaGetLastError();
}

// RB: the smallest of 1, 2, 4, 8, 16, 32 that covers B (row tiles of 32
// above). COLS: as many rows as the registers allow at that RB, unless the
// grid would then leave SMs idle (narrow outputs), where each warp takes one.
template <typename T, typename O>
int gemv(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
         cudaStream_t s) {
  if (nb <= 0 || in_dim <= 0 || out_dim <= 0 || in_dim % KV) return (int)cudaErrorInvalidValue;
  const bool narrow = out_dim < 2 * 132 * WARPS * 4;
#define Q8_LAUNCH(RB, COLS) return launch_rb<T, O, RB, COLS>(x, q, scale, out, nb, in_dim, out_dim, s)
  if (nb == 1) { if (narrow) Q8_LAUNCH(1, 1); Q8_LAUNCH(1, 4); }
  if (nb == 2) { if (narrow) Q8_LAUNCH(2, 1); Q8_LAUNCH(2, 4); }
  if (nb <= 4) { if (narrow) Q8_LAUNCH(4, 1); Q8_LAUNCH(4, 4); }
  if (nb <= 8) { if (narrow) Q8_LAUNCH(8, 1); Q8_LAUNCH(8, 2); }
  if (nb <= 16) { if (narrow) Q8_LAUNCH(16, 1); Q8_LAUNCH(16, 2); }
  Q8_LAUNCH(32, 1);
#undef Q8_LAUNCH
}

// From how many rows bf16 x takes the tensor cores. Below, the CUDA-core
// form streams the weights faster: lm_head at one row 0.077-0.095 ms against
// 0.118 for the mma form, whose 8 warps split only 20 chunks of K there
// (measured on an H100; PERF.md).
constexpr int MMA_MIN_ROWS = 4;

// Type dispatch on flags: x_bf16 / out_bf16 pick bf16, else f32; bf16 x
// with In a multiple of 64 and more than MMA_MIN_ROWS rows takes the
// tensor cores.
// A template (of nothing) so that a source including this header for its
// device dots alone instantiates none of the GEMV kernels.
template <int = 0>
int gemv_dispatch(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim,
                  int out_dim, int x_bf16, int out_bf16, cudaStream_t s) {
  if (nb <= 0 || in_dim <= 0 || out_dim <= 0 || in_dim % KV) return (int)cudaErrorInvalidValue;
  if (x_bf16 && in_dim % MK == 0 && nb > MMA_MIN_ROWS) {
    if (out_bf16) return gemv_mma<__nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
    return gemv_mma<float>(x, q, scale, out, nb, in_dim, out_dim, s);
  }
  if (x_bf16 && out_bf16) return gemv<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
  if (x_bf16) return gemv<__nv_bfloat16, float>(x, q, scale, out, nb, in_dim, out_dim, s);
  if (out_bf16) return gemv<float, __nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
  return gemv<float, float>(x, q, scale, out, nb, in_dim, out_dim, s);
}

}  // namespace q8
