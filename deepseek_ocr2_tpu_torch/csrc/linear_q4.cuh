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
// Three forms:
// - 1-4 rows of x (a decode step; lm_head at one row is the path's shape):
//   the streaming form, below. What bounds it is the bytes of the codes
//   (lm_head 129 280 x 1280: 82.7 MB + 5.2 MB of scales, 0.026 ms at 3.35
//   TB/s). A persistent grid of up to three blocks an SM (two for f32 x),
//   each a ring of its own: one producer thread streams whole runs of 16
//   rt code rows (contiguous: 16 rt rb bytes, 20 KB at In 1280) and their
//   scales by 1-D bulk async copies into shared-memory stages, each
//   completing on an mbarrier; 8 consumer warps take the stage's (16-row
//   tile, 128-row group) items in turn, so no lane idles whatever In is.
//   bf16 x: mma.sync m16n8k16 on the staged codes (levels decoded two a
//   byte-permute into bf16 pairs 128 + c, then 136 off: exact), x staged
//   once a block in shared memory in the pair order the decode gives; f32
//   x: FMAs on the CUDA cores with level() below, x read through L1. Each
//   item's f32 tile is scaled by its group's scales before it joins the
//   warp's sums; the warps' sums meet in shared memory in warp order (the
//   same order every run) and are summed a stage later, under the next
//   stage's work; each output is written once, rows past Out never.
//   scripts/torch_q4_ablate.py times the variants this shape was chosen
//   from: the consumers' work alone and the stream alone each take 85-90 %
//   of the whole, so both limit it.
// - bf16 x, more than 4 rows: mma.sync m16n8k16 with the weights
//   as A (16 output rows, levels widened to bf16) and x as B (8 rows of the
//   batch). A warp's contraction chunk is one 128-row group, so the chunk's
//   f32 tile is scaled by the group's scales before it joins the accumulator
//   (warp w takes groups w, w + 8, ...; the block's warps sum their tiles
//   through shared memory in warp order). In a group, lane q of a quad reads
//   32 consecutive levels (one 16-byte load) of each of its two rows and 32
//   values of its x row, and feeds 8 mma steps: step (t, j) maps the logical
//   k pairs (2q, 2q + 1) and (2q + 8, 2q + 9) to the physical k 32q + 8t + 4j
//   + (0, 1) and (2, 3), the same for A and B.
// - f32 x, more than 4 rows: FMAs on the CUDA cores, one warp per COLS
//   output rows and RB rows of x per block. A lane takes 32 levels (one
//   16-byte load) of one group per step, widens them once for all its RB rows
//   of x, and multiplies each partial by the group's scale before adding it
//   to its sum; the COLS * RB sums reduce across the warp with xor shuffles.
//
// Shapes: In a multiple of 32 (the wrappers check it); any B and Out; the
// streaming form needs one stage of 16 code rows (plus x in bf16) in shared
// memory, so In up to about 13 000 (dispatch refuses more).

#pragma once

#include "gemv_common.cuh"
#include "sm90.cuh"

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

// f32 x, more than 4 rows. RB: the smallest of 8, 16, 32 that covers B
// (row tiles of 32 above). COLS: 2 rows a warp at 8 and 16 rows of x, one
// above (registers) and where the grid would otherwise leave SMs idle
// (narrow outputs).
template <typename O>
int gemv(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
         cudaStream_t s) {
  const bool narrow = out_dim < 2 * 132 * WARPS * 4;
#define Q4_LAUNCH(RB, COLS) return launch_rb<float, O, RB, COLS>(x, q, scale, out, nb, in_dim, out_dim, s)
  if (nb <= 8) { if (narrow) Q4_LAUNCH(8, 1); Q4_LAUNCH(8, 2); }
  if (nb <= 16) { if (narrow) Q4_LAUNCH(16, 1); Q4_LAUNCH(16, 2); }
  Q4_LAUNCH(32, 1);
#undef Q4_LAUNCH
}

// ---------------------------------------------------------------------------
// Streaming form (1-4 rows of x; see the header).

constexpr int S_WARPS = 8;                     // consumer warps
constexpr int S_THREADS = 32 * (S_WARPS + 1);  // and one producer warp
constexpr int S_STAGE_CODES = 20 * 1024;       // code bytes a stage holds at most (one 16-row tile at least)
constexpr int S_MAX_STAGES = 8;
constexpr int S_SMEM = 232448;     // a block's shared memory on sm_90 at one block an SM
constexpr int S_SM_SMEM = 233472;  // an SM's, 1 KB of it reserved for each block
// Blocks an SM at most: bf16 x (72 registers a thread) fits three, f32 x
// (96) two.
template <typename T>
constexpr int s_max_blocks() { return sizeof(T) == 2 ? 3 : 2; }
constexpr int S_ROWS_MAX = 4;   // rows of x

__host__ __device__ __forceinline__ int align_up(int n, int a) { return (n + a - 1) / a * a; }

// Shared memory of one streaming block: x in bf16 (the mma form only), the
// warps' sums (double-buffered), the ring of stages, the ring's mbarriers.
struct StreamLayout {
  int rt;           // 16-row tiles a stage
  int codes;        // code bytes of a stage (16 rt rows), then its scales
  int stage;        // bytes of a stage, 16-aligned
  int x_off, red_off, ring_off, bar_off, stages, smem;

  __host__ __device__ StreamLayout(int in_dim, bool mma_x, int n_stages) {
    const int rb = (int)row_bytes(in_dim), ng = groups_of(in_dim);
    const int fit = S_STAGE_CODES / (16 * rb);
    rt = fit < 1 ? 1 : fit > 4 ? 4 : fit;
    codes = 16 * rt * rb;
    stage = codes + align_up(16 * rt * ng * 4, 16);
    x_off = 0;
    red_off = align_up(mma_x ? S_ROWS_MAX * ng * GROUP * 2 : 0, 128);
    ring_off = red_off + align_up(2 * S_WARPS * rt * 16 * 4 * 4, 128);
    stages = n_stages;
    bar_off = ring_off + stages * stage;
    smem = bar_off + 2 * S_MAX_STAGES * 8;
  }
};

// Levels n0 n2 (sel 0x4140) or n4 n6 (0x4342) of the nibbles in v's bytes
// as a bf16x2: byte-permuted next to 0x43 they read 128 + c, and 136 off
// that is c - 8, exactly.
__device__ __forceinline__ unsigned pair_perm_bf16(unsigned v, unsigned sel) {
  const unsigned u = __byte_perm(v, 0x43434343u, sel);
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const unsigned*>(&r);
}

// One item on the tensor cores: the 16 x 8 tile (code rows g, g + 8 of
// `rows`, x rows = columns) of one 128-row group. Lane (g, qd) reads 16
// bytes of each of its two rows (levels 32 qd .. + 31 of the group); code
// word t's nibbles pair as (0, 2), (4, 6) from its low nibbles and (1, 3),
// (5, 7) from its high ones, so x's 8-value chunks sit in shared memory as
// x0 x2 x1 x3 x4 x6 x5 x7 (`xg`: this lane's x row at the group's start,
// null for a lane whose row is past B).
__device__ __forceinline__ void stream_item_mma(const uint8_t* rows, int rb, const __nv_bfloat16* xg,
                                                float (&part)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const uint4 wl = *reinterpret_cast<const uint4*>(rows + g * rb + 16 * qd);
  const uint4 wh = *reinterpret_cast<const uint4*>(rows + (g + 8) * rb + 16 * qd);
  float part1[4];  // a second chain of mma sums, added at the end
#pragma unroll
  for (int c = 0; c < 4; ++c) part[c] = part1[c] = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint4 xv = xg ? *reinterpret_cast<const uint4*>(xg + 32 * qd + 8 * t) : make_uint4(0, 0, 0, 0);
    const unsigned cl = gemv::word(wl, t), ch = gemv::word(wh, t);
    const unsigned ll = cl & 0x0F0F0F0Fu, hl = (cl >> 4) & 0x0F0F0F0Fu;
    const unsigned lh = ch & 0x0F0F0F0Fu, hh = (ch >> 4) & 0x0F0F0F0Fu;
    const unsigned a0[4] = {pair_perm_bf16(ll, 0x4140), pair_perm_bf16(lh, 0x4140), pair_perm_bf16(hl, 0x4140),
                            pair_perm_bf16(hh, 0x4140)};
    gemv::mma_bf16(part, a0, xv.x, xv.y);
    const unsigned a1[4] = {pair_perm_bf16(ll, 0x4342), pair_perm_bf16(lh, 0x4342), pair_perm_bf16(hl, 0x4342),
                            pair_perm_bf16(hh, 0x4342)};
    gemv::mma_bf16(part1, a1, xv.z, xv.w);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) part[c] += part1[c];
}

// One item on the CUDA cores (f32 x): lane (g, qd) takes levels 32 qd ..
// + 31 of the group in code rows g and g + 8 against x rows b < nb at `xk`
// (x + the lane's first input row; null past In): part[h][b] for row g +
// 8 h, this lane's quarter of the group.
__device__ __forceinline__ void stream_item_fma(const uint8_t* rows, int rb, const float* __restrict__ xk,
                                                int in_dim, int nb, float (&part)[2][S_ROWS_MAX]) {
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int b = 0; b < S_ROWS_MAX; ++b) part[h][b] = 0.f;
  if (xk == nullptr) return;
  const uint4 wl = *reinterpret_cast<const uint4*>(rows + g * rb + 16 * qd);
  const uint4 wh = *reinterpret_cast<const uint4*>(rows + (g + 8) * rb + 16 * qd);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float lv[2][8];
    const unsigned cl = gemv::word(wl, t), ch = gemv::word(wh, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      lv[0][n] = level(cl, n);
      lv[1][n] = level(ch, n);
    }
#pragma unroll
    for (int b = 0; b < S_ROWS_MAX; ++b) {
      if (b < nb) {
        float xv[8];
        load8(xk + (size_t)b * in_dim + 8 * t, xv);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n) part[h][b] = fmaf(xv[n], lv[h][n], part[h][b]);
      }
    }
  }
}

// Stage i of the grid: output rows [16 rt i, + 16 rt); block b takes stages
// b, b + gridDim.x, ... in order, its j-th in ring slot j % stages.
template <typename T, typename O>
__global__ void __launch_bounds__(S_THREADS, s_max_blocks<T>()) gemv_stream_kernel(const T* __restrict__ x,
                                                                   const uint8_t* __restrict__ q,
                                                                   const float* __restrict__ scale,
                                                                   O* __restrict__ out, int nb, int in_dim,
                                                                   int out_dim, int n_stages) {
  constexpr bool MMA = sizeof(T) == 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const StreamLayout lay(in_dim, MMA, n_stages);
  const int rb = (int)row_bytes(in_dim), ng = groups_of(in_dim), in_p = ng * GROUP;
  const int rows_per = 16 * lay.rt, n_items = (out_dim + rows_per - 1) / rows_per;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + S_MAX_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < lay.stages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], S_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == S_WARPS) {  // the producer
    if (lane != 0) return;
    for (int item = blockIdx.x, j = 0; item < n_items; item += gridDim.x, ++j) {
      const int slot = j % lay.stages;
      sm90::mbar_wait(&empty[slot], ((j / lay.stages) & 1) ^ 1);  // a fresh slot passes at once
      uint8_t* dst = smem + lay.ring_off + slot * lay.stage;
      const int o0 = item * rows_per, rows = min(rows_per, out_dim - o0);
      // The scales' bulk part: [o0 ng, (o0 + rows) ng) floats starts 16-byte
      // aligned (16 | rows_per); the last stage's up to 3 trailing floats go
      // in by this thread's own stores, before its arrival releases them.
      const int n_s = rows * ng, n_bulk = n_s & ~3;
      float* sdst = reinterpret_cast<float*>(dst + lay.codes);
      const float* ssrc = scale + (size_t)o0 * ng;
      for (int i = n_bulk; i < n_s; ++i) sdst[i] = ssrc[i];
      sm90::mbar_arrive_expect_tx(&full[slot], rows * rb + 4 * n_bulk);
      sm90::bulk_load(dst, q + (size_t)o0 * rb, rows * rb, &full[slot]);
      if (n_bulk) sm90::bulk_load(sdst, ssrc, 4 * n_bulk, &full[slot]);
    }
    return;
  }

  // Consumers. x in bf16 goes to shared memory once, zero past In, each
  // 8-value chunk in the order stream_item_mma reads it.
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem + lay.x_off);
  if constexpr (MMA) {
    __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem + lay.x_off);
    for (int i = threadIdx.x; i < nb * in_p; i += 32 * S_WARPS) {
      const int b = i / in_p, kp = i - b * in_p;
      const int k = (kp & ~3) | ((kp & 1) << 1) | ((kp >> 1) & 1);  // swaps bits 0 and 1 of the position
      xw[i] = k < in_dim ? x[(size_t)b * in_dim + k] : __float2bfloat16_rn(0.f);
    }
    sm90::bar_sync(1, 32 * S_WARPS);
  }
  const int g = lane / 4, qd = lane % 4;
  // Stage j's sums meet in red[j % 2]; its outputs are summed and stored in
  // stage j + 1, after that stage's items (hidden under the slower warps'),
  // by the last warps (those with the fewest items), or after the loop.
  auto store = [&](int jj, int item) {
    const float* redf = reinterpret_cast<const float*>(smem + lay.red_off) + (jj & 1) * S_WARPS * lay.rt * 16 * 4;
    const int o0 = item * rows_per;
    for (int i = 32 * S_WARPS - 1 - threadIdx.x; i < rows_per * nb; i += 32 * S_WARPS) {
      const int b = i / rows_per, r = i - b * rows_per;
      if (o0 + r >= out_dim) continue;
      const int tile = r / 16, rr = r % 16, src = 2 * (rr % 8) + b / 2, c = 2 * (rr / 8) + b % 2;
      float sum = 0.f;
      for (int w = 0; w < S_WARPS; ++w) sum += redf[((w * lay.rt + tile) * 16 + src) * 4 + c];
      out[(size_t)b * out_dim + o0 + r] = gemv::from_f32<O>(sum);
    }
  };
  int j = 0, prev = -1;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
    const int slot = j % lay.stages;
    sm90::mbar_wait(&full[slot], (j / lay.stages) & 1);
    const uint8_t* codes = smem + lay.ring_off + slot * lay.stage;
    const float* sc = reinterpret_cast<const float*>(codes + lay.codes);
    float acc[4][4];  // row 16 tile + g + 8 h, x row 2 qd + e: acc[tile][2 h + e]
    // The warp's items: (16-row tile, group) pairs numbered tile ng + group,
    // those = warp mod S_WARPS, tile by tile (acc[tile] a register).
#pragma unroll
    for (int tile = 0; tile < 4; ++tile) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[tile][c] = 0.f;
      if (tile >= lay.rt) continue;
      const uint8_t* tile_rows = codes + (size_t)16 * tile * rb;
      const float* srow0 = sc + (16 * tile + g) * ng;
      const float* srow1 = srow0 + 8 * ng;
      float f[2][S_ROWS_MAX] = {};  // the CUDA-core form's quarter-group sums
      for (int grp = ((warp - tile * ng) % S_WARPS + S_WARPS) % S_WARPS; grp < ng; grp += S_WARPS) {
        const float s0 = srow0[grp], s1 = srow1[grp];
        if constexpr (MMA) {
          float part[4];
          stream_item_mma(tile_rows + grp * (GROUP / 2), rb, g < nb ? xs + (size_t)g * in_p + grp * GROUP : nullptr,
                          part);
          acc[tile][0] += part[0] * s0;
          acc[tile][1] += part[1] * s0;
          acc[tile][2] += part[2] * s1;
          acc[tile][3] += part[3] * s1;
        } else {
          const int k0 = grp * GROUP + 32 * qd;
          float part[2][S_ROWS_MAX];
          stream_item_fma(tile_rows + grp * (GROUP / 2), rb,
                          k0 < in_dim ? reinterpret_cast<const float*>(x) + k0 : nullptr, in_dim, nb, part);
#pragma unroll
          for (int b = 0; b < S_ROWS_MAX; ++b) {
            f[0][b] += part[0][b] * s0;
            f[1][b] += part[1][b] * s1;
          }
        }
      }
      if constexpr (!MMA) {
        // The quad's four quarters of each group summed; lane qd keeps x
        // rows 2 qd, 2 qd + 1, as the mma tile's columns lie.
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int b = 0; b < S_ROWS_MAX; ++b) {
            f[h][b] += __shfl_xor_sync(gemv::FULL, f[h][b], 1);
            f[h][b] += __shfl_xor_sync(gemv::FULL, f[h][b], 2);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[tile][2 * h + e] = qd == 0 ? f[h][e] : qd == 1 ? f[h][2 + e] : 0.f;
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);  // the stage is read: refill it
    // This warp's sums for the stage's rows (the lanes qd < 2 hold x rows
    // 0-3, to slot 2 g + qd); the last stage's outputs first.
    if (prev >= 0) store(j - 1, prev);
    float4* red = reinterpret_cast<float4*>(smem + lay.red_off) + (j & 1) * S_WARPS * lay.rt * 16;
    if (qd < 2) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < lay.rt) red[(warp * lay.rt + r) * 16 + 2 * g + qd] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    sm90::bar_sync(1, 32 * S_WARPS);  // red[j % 2] complete; red[(j - 1) % 2] read
    prev = item;
  }
  if (prev >= 0) store(j - 1, prev);
}

namespace {
// The streaming kernel's shared-memory limit as raised so far, one per
// library: internal linkage, since a static inside the (inline) template
// would be one object for every library of the process, and a library
// that found it raised by another would launch unconfigured.
template <typename T, typename O>
int stream_smem_limit = 0;
}  // namespace

inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

template <typename T, typename O>
int gemv_stream(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
                cudaStream_t s) {
  constexpr bool MMA = sizeof(T) == 2;
  // As many blocks an SM as each fit two stages (independent rings: one
  // block's waits and barriers fall in the others' work), else one.
  const StreamLayout base(in_dim, MMA, 0);
  int per_sm = s_max_blocks<T>(), fit = 0;
  for (; per_sm > 1; --per_sm) {
    fit = (S_SM_SMEM / per_sm - 1024 - base.smem) / base.stage;
    if (fit >= 2) break;
  }
  if (per_sm == 1) fit = (S_SMEM - base.smem) / base.stage;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int stages = fit < S_MAX_STAGES ? fit : S_MAX_STAGES;
  const StreamLayout lay(in_dim, MMA, stages);
  auto kernel = gemv_stream_kernel<T, O>;
  if (lay.smem > stream_smem_limit<T, O>) {  // raised once to the most asked
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
    if (err != cudaSuccess) return (int)err;
    stream_smem_limit<T, O> = lay.smem;
  }
  const int n_items = (out_dim + 16 * lay.rt - 1) / (16 * lay.rt), slots = per_sm * sm_count();
  kernel<<<n_items < slots ? n_items : slots, S_THREADS, lay.smem, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
      static_cast<O*>(out), nb, in_dim, out_dim, stages);
  return (int)cudaGetLastError();
}

// Type dispatch on flags: x_bf16 / out_bf16 pick bf16, else f32. 1-4 rows
// take the streaming form; more take the tensor-core form (bf16 x) or the
// CUDA-core form (f32 x).
// A template (of nothing) so that a source including this header for its
// device dots alone instantiates none of the GEMV kernels.
template <int = 0>
int gemv_dispatch(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim, int out_dim,
                  int x_bf16, int out_bf16, cudaStream_t s) {
  if (nb <= 0 || in_dim <= 0 || out_dim <= 0 || in_dim % KV) return (int)cudaErrorInvalidValue;
  if (nb <= S_ROWS_MAX) {
    if (x_bf16 && out_bf16) return gemv_stream<__nv_bfloat16, __nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
    if (x_bf16) return gemv_stream<__nv_bfloat16, float>(x, q, scale, out, nb, in_dim, out_dim, s);
    if (out_bf16) return gemv_stream<float, __nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
    return gemv_stream<float, float>(x, q, scale, out, nb, in_dim, out_dim, s);
  }
  if (x_bf16) {
    if (out_bf16) return gemv_mma<__nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
    return gemv_mma<float>(x, q, scale, out, nb, in_dim, out_dim, s);
  }
  if (out_bf16) return gemv<__nv_bfloat16>(x, q, scale, out, nb, in_dim, out_dim, s);
  return gemv<float>(x, q, scale, out, nb, in_dim, out_dim, s);
}

}  // namespace q4
