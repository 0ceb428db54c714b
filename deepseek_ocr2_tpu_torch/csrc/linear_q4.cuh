// Int4-weight skinny GEMM (w4a16) device code for sm_90a: the body of
// kernel L (linear_q4.cu), also used for the two projections of kernel O
// (attn_fused.cu) and the expert products of kernels M and N (moe_q4.cu).
//
//   out[b, o] = round_O(sum_g s[o, g] * (sum_{k in g} x[b, k] * lvl[o, k]))
//
// Codes are uint8 [Out, In_p / 2] (HF's [out, in] layout): byte j holds input
// rows 2j (low nibble) and 2j + 1 (high nibble) as level + 8, levels in
// [-7, 7]; scales f32 [Out, In_p / 128], one per group of 128 input rows;
// In_p is In rounded up to 128 (padding levels are 0, never multiplied by x:
// a lane whose levels lie past In reads no x). A level widened to f32 or
// bf16 is exact and so is each x * level product in f32, so this is the TPU
// kernel's math: each group's dot accumulated in f32, times its scale, summed
// in f32; only the order of the f32 sums differs.
//
// Two forms, as linear_q8.cuh's:
// - bf16 x, more than MMA_MIN_ROWS rows: mma.sync m16n8k16 with the weights
//   as A (16 output rows, levels widened to bf16) and x as B (8 rows of the
//   batch). A warp's contraction chunk is one 128-row group, so the chunk's
//   f32 tile is scaled by the group's scales before it joins the accumulator
//   (warp w takes groups w, w + 8, ...; the block's warps sum their tiles
//   through shared memory in warp order). In a group, lane q of a quad reads
//   32 consecutive levels (one 16-byte load) of each of its two rows and 32
//   values of its x row, and feeds 8 mma steps: step (t, j) maps the logical
//   k pairs (2q, 2q + 1) and (2q + 8, 2q + 9) to the physical k 32q + 8t + 4j
//   + (0, 1) and (2, 3), the same for A and B.
// - otherwise (f32 x, or 1-4 rows): FMAs on the CUDA cores, one warp per COLS
//   output rows and RB rows of x per block. A lane takes 32 levels (one
//   16-byte load) of one group per step, widens them once for all its RB rows
//   of x, and multiplies each partial by the group's scale before adding it
//   to its sum; the COLS * RB sums reduce across the warp with xor shuffles.
//
// Shapes: In a multiple of 32 (the wrappers check it); any B and Out.

#pragma once

#include "gemv_common.cuh"

namespace q4 {

using gemv::NT;
using gemv::WARPS;

constexpr int GROUP = 128;
constexpr int KV = 32;  // levels per lane per step: one 16-byte load

__host__ __device__ __forceinline__ int groups_of(int in_dim) { return (in_dim + GROUP - 1) / GROUP; }
// Bytes of one row of codes.
__host__ __device__ __forceinline__ size_t row_bytes(int in_dim) { return (size_t)groups_of(in_dim) * (GROUP / 2); }

// Level n (0..7) of a code word, exactly: the nibble c set into the
// mantissa of 2^23 gives 2^23 + c, and 2^23 + 8 off that is c - 8. (An
// int-to-float convert runs at a quarter of the FMA rate and would bound
// the decode.)
__device__ __forceinline__ float level(unsigned w, int n) {
  return __uint_as_float(0x4B000000u | ((w >> (4 * n)) & 0xFu)) - 8388616.0f;
}

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4* v = reinterpret_cast<const float4*>(p);
  const float4 a = __ldg(v), b = __ldg(v + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    o[2 * t] = f.x;
    o[2 * t + 1] = f.y;
  }
}

// Sums of COLS int4 rows (code rows `rows`, scale rows `srows`) against RB
// rows of x starting at x + b0 * in_dim, reduced across the warp:
// acc[c * RB + r], group scales applied.
template <typename T, int RB, int COLS>
__device__ __forceinline__ void warp_dots(const T* __restrict__ x, int nb, int b0, int in_dim,
                                          const uint8_t* const* rows, const float* const* srows, float* acc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < COLS * RB; ++j) acc[j] = 0.f;
#pragma unroll 1
  for (int k = lane * KV; k < in_dim; k += 32 * KV) {
    uint4 wv[COLS];
    float s[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      wv[c] = __ldg(reinterpret_cast<const uint4*>(rows[c] + k / 2));
      s[c] = __ldg(srows[c] + k / GROUP);
    }
    float part[COLS * RB];
#pragma unroll
    for (int j = 0; j < COLS * RB; ++j) part[j] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float w[COLS][8];
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const unsigned u = gemv::word(wv[c], t);
#pragma unroll
        for (int n = 0; n < 8; ++n) w[c][n] = level(u, n);
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (b0 + r < nb) {
          float xv[8];
          load8(x + (size_t)(b0 + r) * in_dim + k + 8 * t, xv);
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
#pragma unroll
            for (int n = 0; n < 8; ++n) part[c * RB + r] = fmaf(xv[n], w[c][n], part[c * RB + r]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[c * RB + r] += part[c * RB + r] * s[c];
    }
  }
  gemv::warp_sum<COLS * RB>(acc);
}

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 x).

// Levels n and n + 1 of a code word as a bf16x2 (level n in the low half),
// exactly: each nibble c set into the mantissa of bf16 128 gives 128 + c,
// and 136 off that is c - 8.
__device__ __forceinline__ unsigned pair_bf16(unsigned w, int n) {
  const unsigned t = w >> (4 * n);
  const unsigned u = (t & 0xFu) | ((t << 12) & 0xF0000u) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const unsigned*>(&v);
}

// Tiles of MT 16-row weight tiles against NTL 8-row tiles of x (x rows
// b0 ..), summed over all of In by the block's warps: on return warp 0
// holds acc[mt][nt][c] for weight row (tile mt) g + 8 (c / 2) and x row
// b0 + 8 nt + 2q + c % 2, where g = lane / 4, q = lane % 4. rlo[mt] / rhi[mt]
// point at this lane's code rows g and g + 8 of tile mt, slo[mt] / shi[mt]
// at their scale rows (a ragged tile repeats a valid row). `red` is shared
// memory of WARPS * 32 * MT * NTL * 4 floats. Every thread of the block must
// call it.
template <int MT, int NTL>
__device__ __forceinline__ void block_mma_dots(const __nv_bfloat16* __restrict__ x, int nb, int b0, int in_dim,
                                               const uint8_t* const* rlo, const uint8_t* const* rhi,
                                               const float* const* slo, const float* const* shi,
                                               float (&acc)[MT][NTL][4], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  const int n_groups = groups_of(in_dim);
#pragma unroll 1
  for (int ch = warp; ch < n_groups; ch += WARPS) {
    const int k0 = ch * GROUP + 32 * q;
    const bool live = k0 < in_dim;  // past In: padding levels (0) and no x
    uint4 wl[MT], wh[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wl[mt] = __ldg(reinterpret_cast<const uint4*>(rlo[mt] + k0 / 2));
      wh[mt] = __ldg(reinterpret_cast<const uint4*>(rhi[mt] + k0 / 2));
    }
    float part[MT][NTL][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // code word t: physical k k0 + 8t .. + 7
      uint4 xv[NTL];
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt) {
        const int row = b0 + 8 * nt + g;
        xv[nt] = (live && row < nb)
                     ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * in_dim + k0 + 8 * t))
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned cl = gemv::word(wl[mt], t), chh = gemv::word(wh[mt], t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const unsigned a[4] = {pair_bf16(cl, 4 * j), pair_bf16(chh, 4 * j), pair_bf16(cl, 4 * j + 2),
                                 pair_bf16(chh, 4 * j + 2)};
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt)
            gemv::mma_bf16(part[mt][nt], a, gemv::word(xv[nt], 2 * j), gemv::word(xv[nt], 2 * j + 1));
        }
      }
    }
    // The group's scales, in f32, before the chunk joins the sum.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float s0 = __ldg(slo[mt] + ch), s1 = __ldg(shi[mt] + ch);
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += part[mt][nt][c] * (c < 2 ? s0 : s1);
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
__global__ void __launch_bounds__(NT) gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                                                      const float* __restrict__ scale, O* __restrict__ out, int nb,
                                                      int in_dim, int out_dim) {
  __shared__ float red[WARPS * 32 * MT * NTL * 4];
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int o0 = blockIdx.x * 16 * MT;
  const int b0 = blockIdx.y * 8 * NTL;
  const size_t rb = row_bytes(in_dim);
  const int ng = groups_of(in_dim);
  const uint8_t* rlo[MT];
  const uint8_t* rhi[MT];
  const float* slo[MT];
  const float* shi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int lo = min(o0 + 16 * mt + g, out_dim - 1), hi = min(o0 + 16 * mt + g + 8, out_dim - 1);
    rlo[mt] = q + (size_t)lo * rb;
    rhi[mt] = q + (size_t)hi * rb;
    slo[mt] = scale + (size_t)lo * ng;
    shi[mt] = scale + (size_t)hi * ng;
  }
  float acc[MT][NTL][4];
  block_mma_dots<MT, NTL>(x, nb, b0, in_dim, rlo, rhi, slo, shi, acc, red);
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = o0 + 16 * mt + g + 8 * (c / 2);
        const int b = b0 + 8 * nt + 2 * qd + c % 2;
        if (o < out_dim && b < nb) out[(size_t)b * out_dim + o] = gemv::from_f32<O>(acc[mt][nt][c]);
      }
}

template <typename O, int MT, int NTL>
int launch_mma(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
               cudaStream_t s) {
  const dim3 grid((out_dim + 16 * MT - 1) / (16 * MT), (nb + 8 * NTL - 1) / (8 * NTL));
  gemv_mma_kernel<O, MT, NTL><<<grid, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
                                                  static_cast<O*>(out), nb, in_dim, out_dim);
  return (int)cudaGetLastError();
}

template <typename O>
int gemv_mma(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
             cudaStream_t s) {
  const bool wide = out_dim >= 2 * 132 * 32;
#define Q4_MMA(MT, NTL) return launch_mma<O, MT, NTL>(x, q, scale, out, nb, in_dim, out_dim, s)
  if (nb <= 8) { if (wide) Q4_MMA(2, 1); Q4_MMA(1, 1); }
  if (nb <= 16) { if (wide) Q4_MMA(2, 2); Q4_MMA(1, 2); }
  if (wide) Q4_MMA(2, 4);
  Q4_MMA(1, 4);
#undef Q4_MMA
}

// ---------------------------------------------------------------------------
// CUDA-core form.

// Block: output rows [(blockIdx.x * WARPS + warp) * COLS, + COLS), x rows
// [blockIdx.y * RB, + RB).
template <typename T, typename O, int RB, int COLS>
__global__ void __launch_bounds__(NT) gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                                                  const float* __restrict__ scale, O* __restrict__ out, int nb,
                                                  int in_dim, int out_dim) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o0 = (blockIdx.x * WARPS + warp) * COLS;
  const int b0 = blockIdx.y * RB;
  if (o0 >= out_dim) return;  // warp-uniform
  const size_t rb = row_bytes(in_dim);
  const int ng = groups_of(in_dim);
  const uint8_t* rows[COLS];
  const float* srows[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int o = min(o0 + c, out_dim - 1);  // ragged: re-read
    rows[c] = q + (size_t)o * rb;
    srows[c] = scale + (size_t)o * ng;
  }
  float acc[COLS * RB];
  warp_dots<T, RB, COLS>(x, nb, b0, in_dim, rows, srows, acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int o = o0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < nb && o < out_dim) {
        out[(size_t)(b0 + r) * out_dim + o] = gemv::from_f32<O>(acc[c * RB + r]);
      }
    }
  }
}

template <typename T, typename O, int RB, int COLS>
int launch_rb(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
              cudaStream_t s) {
  const dim3 grid((out_dim + WARPS * COLS - 1) / (WARPS * COLS), (nb + RB - 1) / RB);
  gemv_kernel<T, O, RB, COLS><<<grid, NT, 0, s>>>(static_cast<const T*>(x), static_cast<const uint8_t*>(q),
                                                  static_cast<const float*>(scale), static_cast<O*>(out), nb,
                                                  in_dim, out_dim);
  return (int)cudaGetLastError();
}

// RB: the smallest of 1, 2, 4, 8, 16, 32 that covers B (row tiles of 32
// above). COLS: 4 rows a warp at 1-4 rows of x, fewer above (registers),
// one where the grid would otherwise leave SMs idle (narrow outputs).
template <typename T, typename O>
int gemv(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
         cudaStream_t s) {
  const bool narrow = out_dim < 2 * 132 * WARPS * 4;
#define Q4_LAUNCH(RB, COLS) return launch_rb<T, O, RB, COLS>(x, q, scale, out, nb, in_dim, out_dim, s)
  if (nb == 1) { if (narrow) Q4_LAUNCH(1, 1); Q4_LAUNCH(1, 4); }
  if (nb == 2) { if (narrow) Q4_LAUNCH(2, 1); Q4_LAUNCH(2, 4); }
  if (nb <= 4) { if (narrow) Q4_LAUNCH(4, 1); Q4_LAUNCH(4, 4); }
  if (nb <= 8) { if (narrow) Q4_LAUNCH(8, 1); Q4_LAUNCH(8, 2); }
  if (nb <= 16) { if (narrow) Q4_LAUNCH(16, 1); Q4_LAUNCH(16, 2); }
  Q4_LAUNCH(32, 1);
#undef Q4_LAUNCH
}

// From how many rows bf16 x takes the tensor cores (as linear_q8.cuh's).
constexpr int MMA_MIN_ROWS = 4;

// Type dispatch on flags: x_bf16 / out_bf16 pick bf16, else f32; bf16 x
// with more than MMA_MIN_ROWS rows takes the tensor cores.
// A template (of nothing) so that a source including this header for its
// device dots alone instantiates none of the GEMV kernels.
template <int = 0>
int gemv_dispatch(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
                  int x_bf16, int out_bf16, cudaStream_t s) {
  if (nb <= 0 || in_dim <= 0 || out_dim <= 0 || in_dim % KV) return (int)cudaErrorInvalidValue;
  if (x_bf16 && nb > MMA_MIN_ROWS) {
    if (out_bf16) return gemv_mma<__nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
    return gemv_mma<float>(x, q, scale, out, nb, in_dim, out_dim, s);
  }
  if (x_bf16 && out_bf16) return gemv<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
  if (x_bf16) return gemv<__nv_bfloat16, float>(x, q, scale, out, nb, in_dim, out_dim, s);
  if (out_bf16) return gemv<float, __nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
  return gemv<float, float>(x, q, scale, out, nb, in_dim, out_dim, s);
}

}  // namespace q4
