// Int8-weight decode MoE for sm_90a: kernels I and J.
//
// I replaces deepseek_ocr2_tpu/ops/moe_q8.py: _q8_kernel and _q8_pe_kernel
// (via moe_ffn_decode_q8): one visit per (row, selection), plus, when the
// shared MLP is split into pseudo-experts ("pe" streams), n_sh always-on
// visits per row with weight 1.
// J replaces deepseek_ocr2_tpu/ops/moe_decode.py: _decode_q8_kernel and
// _decode_q8_pe_kernel (via moe_ffn_decode_q8_fused): one visit per
// DISTINCT selected expert over the whole batch, then the n_sh
// pseudo-expert visits over every row. The visit list (ve, valid) and the
// combine table w_visit [E, B] are kernel F's, built on the device with no
// host sync by the schedule kernel of csrc/moe_decode.cu.
//
// Experts in the port's layout: gu int8 [E, 2I, H] (gate rows, then up
// rows), gu_scale f32 [E, 2I], down int8 [E, H, I], down_scale f32 [E, H];
// the pseudo-experts the same with n_sh in place of E. Expert ids at or
// above E name pseudo-expert id - E.
//
// Rounding points, those of both TPU kernels (round() is to x's type T,
// identity for f32; every sum in f32):
//   gate = (x . gu[i]) * gus[i],  up = (x . gu[I + i]) * gus[I + i]  (f32)
//   act  = round(silu_f32(gate) * up)
//   y    = (act . down[h]) * ds[h]                                  (f32)
//   out  = round(sum over visits of y * w)
// This differs from kernel F, which rounds gate and up before silu (the
// bf16 TPU kernel does, the q8 ones do not). The sum runs in the TPU
// grid's order: for I a row's selections in top-k order, then its
// pseudo-experts; for J the valid visits in ascending expert id, then the
// pseudo-experts.
//
// Three launches, as F: swiglu (grid visit x I tile x row tile) writes act
// [V, R, I] in T; down writes y * w [V, R, H] in f32; combine sums each
// output's visits in that fixed order and casts once. No atomics, so a
// row's bits depend neither on the other rows of the batch nor on the run.
// Both matrix products are linear_q8.cuh's: for J with bf16 x (H and I
// multiples of 64) its tensor-core block dots (each block's warps split the
// contraction and sum in warp order), otherwise its CUDA-core warp dots (I's
// visits have one row each: the bytes, not the FMAs, bound them).
//
// What bounds it: the int8 expert bytes, 3 * H * I = 3.44 MB an expert at
// H = 1280, I = 896. I at b = 1 with the pseudo-experts: 8 visits, 27.5 MB,
// 8.2 us at 3.35 TB/s per MoE layer. J at 16 rows: about 51 distinct
// experts + 2 pseudo-experts, 182 MB, 0.054 ms. I re-reads an expert for
// every row that selects it, hence J once B * k > E.
//
// Shapes: H and I multiples of 16 (16-byte code loads), any B.

#include "linear_q8.cuh"

#include <math.h>

namespace {

using q8::FULL;
using q8::NT;
using q8::WARPS;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

struct Experts {
  const int8_t* gu;
  const float* gus;
  const int8_t* down;
  const float* ds;
  const int8_t* pgu;
  const float* pgus;
  const int8_t* pdown;
  const float* pds;
  int n_exp;
};

// Visit v of the plan -> (expert id, first row of x, rows of the visit), or
// false for a pad visit of J.
//   PER_SEL (I): v = b * kv + j; expert idx[b, j] (row stride ld) for
//   j < k, else E + j - k.
//   else (J): expert ve[v] for a valid v < E, v itself for v >= E.
template <bool PER_SEL>
__device__ __forceinline__ bool visit(int v, const long long* idx, const int* ve, const int* valid, int k, int kv,
                                      int ld, int n_exp, int* ex, int* row) {
  if (PER_SEL) {
    const int b = v / kv, j = v % kv;
    *ex = j < k ? (int)idx[(size_t)b * ld + j] : n_exp + j - k;
    *row = b;
    return true;
  }
  if (v < n_exp && !valid[v]) return false;
  *ex = v < n_exp ? ve[v] : v;
  *row = 0;
  return true;
}

template <typename T, bool PER_SEL, int RB, int COLS>
__global__ void __launch_bounds__(NT) swiglu_kernel(const T* __restrict__ x, Experts w, const long long* idx,
                                                    const int* ve, const int* valid, T* __restrict__ act, int nb,
                                                    int k, int kv, int ld, int h_dim, int i_dim) {
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<PER_SEL>(v, idx, ve, valid, k, kv, ld, w.n_exp, &ex, &row)) return;
  const bool pe = ex >= w.n_exp;
  const int e = pe ? ex - w.n_exp : ex;
  const int8_t* gu = (pe ? w.pgu : w.gu) + (size_t)e * 2 * i_dim * h_dim;
  const float* gus = (pe ? w.pgus : w.gus) + (size_t)e * 2 * i_dim;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = (blockIdx.y * WARPS + warp) * COLS;
  if (i0 >= i_dim) return;  // warp-uniform
  const int rows_v = PER_SEL ? 1 : nb;  // rows of x this visit covers
  const int b0 = blockIdx.z * RB;
  const int8_t* rows[2 * COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = min(i0 + c, i_dim - 1);
    rows[2 * c] = gu + (size_t)i * h_dim;
    rows[2 * c + 1] = gu + (size_t)(i_dim + i) * h_dim;
  }
  float acc[2 * COLS * RB];
  q8::warp_dots<T, RB, 2 * COLS>(x + (size_t)row * h_dim, rows_v, b0, h_dim, rows, acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = i0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < rows_v && i < i_dim) {
        const float gate = acc[(2 * c) * RB + r] * gus[i];
        const float up = acc[(2 * c + 1) * RB + r] * gus[i_dim + i];
        act[((size_t)v * rows_v + b0 + r) * i_dim + i] = q8::from_f32<T>(silu(gate) * up);
      }
    }
  }
}

template <typename T, bool PER_SEL, int RB, int COLS>
__global__ void __launch_bounds__(NT) down_kernel(const T* __restrict__ act, Experts w, const long long* idx,
                                                  const float* wts, const int* ve, const int* valid,
                                                  const float* w_visit, float* __restrict__ yw, int nb, int k, int kv,
                                                  int ld, int h_dim, int i_dim) {
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<PER_SEL>(v, idx, ve, valid, k, kv, ld, w.n_exp, &ex, &row)) return;
  const bool pe = ex >= w.n_exp;
  const int e = pe ? ex - w.n_exp : ex;
  const int8_t* down = (pe ? w.pdown : w.down) + (size_t)e * h_dim * i_dim;
  const float* ds = (pe ? w.pds : w.ds) + (size_t)e * h_dim;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = (blockIdx.y * WARPS + warp) * COLS;
  if (h0 >= h_dim) return;
  const int rows_v = PER_SEL ? 1 : nb;
  const int b0 = blockIdx.z * RB;
  const int8_t* rows[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) rows[c] = down + (size_t)min(h0 + c, h_dim - 1) * i_dim;
  float acc[COLS * RB];
  q8::warp_dots<T, RB, COLS>(act + (size_t)v * rows_v * i_dim, rows_v, b0, i_dim, rows, acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int h = h0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < rows_v && h < h_dim) {
        const int b = b0 + r;
        float wt;
        if (PER_SEL) {
          const int j = v % kv;
          wt = j < k ? wts[(size_t)row * ld + j] : 1.f;
        } else {
          wt = v < w.n_exp ? w_visit[(size_t)v * nb + b] : 1.f;
        }
        yw[((size_t)v * rows_v + b) * h_dim + h] = acc[c * RB + r] * ds[h] * wt;
      }
    }
  }
}

// Tensor-core forms of J (bf16 x, H and I multiples of 64): the same
// visits, rows and epilogues, the products through linear_q8.cuh's
// block_mma_dots. swiglu: a block takes 16 columns i of a visit, as two
// row tiles (gate rows i, up rows I + i), and 8 * NTL rows of x.
template <int NTL>
__global__ void __launch_bounds__(NT) swiglu_mma_kernel(const __nv_bfloat16* __restrict__ x, Experts w,
                                                        const int* ve, const int* valid,
                                                        __nv_bfloat16* __restrict__ act, int nb, int h_dim, int i_dim) {
  __shared__ float red[WARPS * 32 * 2 * NTL * 4];
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<false>(v, nullptr, ve, valid, 0, 0, 0, w.n_exp, &ex, &row)) return;  // block-uniform
  const bool pe = ex >= w.n_exp;
  const int e = pe ? ex - w.n_exp : ex;
  const int8_t* gu = (pe ? w.pgu : w.gu) + (size_t)e * 2 * i_dim * h_dim;
  const float* gus = (pe ? w.pgus : w.gus) + (size_t)e * 2 * i_dim;
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int i0 = blockIdx.y * 16;
  const int b0 = blockIdx.z * 8 * NTL;
  const int8_t* rlo[2];
  const int8_t* rhi[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    rlo[t] = gu + (size_t)(t * i_dim + min(i0 + g, i_dim - 1)) * h_dim;
    rhi[t] = gu + (size_t)(t * i_dim + min(i0 + g + 8, i_dim - 1)) * h_dim;
  }
  float acc[2][NTL][4];
  q8::block_mma_dots<2, NTL>(x, nb, b0, h_dim, rlo, rhi, acc, red);
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + g + 8 * (c / 2);
      const int b = b0 + 8 * nt + 2 * qd + c % 2;
      if (i < i_dim && b < nb) {
        const float gate = acc[0][nt][c] * gus[i];
        const float up = acc[1][nt][c] * gus[i_dim + i];
        act[((size_t)v * nb + b) * i_dim + i] = __float2bfloat16_rn(silu(gate) * up);
      }
    }
}

// down: a block takes 16 * MT output columns h of a visit.
template <int MT, int NTL>
__global__ void __launch_bounds__(NT) down_mma_kernel(const __nv_bfloat16* __restrict__ act, Experts w, const int* ve,
                                                      const int* valid, const float* w_visit, float* __restrict__ yw,
                                                      int nb, int h_dim, int i_dim) {
  __shared__ float red[WARPS * 32 * MT * NTL * 4];
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<false>(v, nullptr, ve, valid, 0, 0, 0, w.n_exp, &ex, &row)) return;
  const bool pe = ex >= w.n_exp;
  const int e = pe ? ex - w.n_exp : ex;
  const int8_t* down = (pe ? w.pdown : w.down) + (size_t)e * h_dim * i_dim;
  const float* ds = (pe ? w.pds : w.ds) + (size_t)e * h_dim;
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int h0 = blockIdx.y * 16 * MT;
  const int b0 = blockIdx.z * 8 * NTL;
  const int8_t* rlo[MT];
  const int8_t* rhi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    rlo[mt] = down + (size_t)min(h0 + 16 * mt + g, h_dim - 1) * i_dim;
    rhi[mt] = down + (size_t)min(h0 + 16 * mt + g + 8, h_dim - 1) * i_dim;
  }
  float acc[MT][NTL][4];
  q8::block_mma_dots<MT, NTL>(act + (size_t)v * nb * i_dim, nb, b0, i_dim, rlo, rhi, acc, red);
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = h0 + 16 * mt + g + 8 * (c / 2);
        const int b = b0 + 8 * nt + 2 * qd + c % 2;
        if (h < h_dim && b < nb) {
          const float wt = v < w.n_exp ? w_visit[(size_t)v * nb + b] : 1.f;
          yw[((size_t)v * nb + b) * h_dim + h] = acc[mt][nt][c] * ds[h] * wt;
        }
      }
}

// out[b, h] = round(sum of row b's visits in order): for I the visits
// b * kv .. b * kv + kv - 1; for J the valid visits v = 0 .. V - 1.
template <typename T, bool PER_SEL>
__global__ void __launch_bounds__(NT) combine_kernel(const float* __restrict__ yw, const int* valid, T* __restrict__ out,
                                                     int nb, int n_visits, int kv, int n_exp, int h_dim) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= nb * h_dim) return;
  const int b = idx / h_dim, h = idx % h_dim;
  float s = 0.f;
  if (PER_SEL) {
    for (int j = 0; j < kv; ++j) s += yw[((size_t)b * kv + j) * h_dim + h];
  } else {
    for (int v = 0; v < n_visits; ++v) {
      if (v >= n_exp || valid[v]) s += yw[((size_t)v * nb + b) * h_dim + h];
    }
  }
  out[idx] = q8::from_f32<T>(s);
}

template <typename T, bool PER_SEL, int RB, int C1, int C2>
int launch_cfg(const void* x, const Experts& w, const long long* idx, const float* wts, const int* ve,
               const int* valid, const float* w_visit, void* act, void* yw, void* out, int nb, int k, int ld,
               int n_sh, int h_dim, int i_dim, cudaStream_t s) {
  const int kv = k + n_sh;
  const int n_visits = PER_SEL ? nb * kv : w.n_exp + n_sh;
  const int row_tiles = PER_SEL ? 1 : (nb + RB - 1) / RB;
  const dim3 g1(n_visits, (i_dim + WARPS * C1 - 1) / (WARPS * C1), row_tiles);
  swiglu_kernel<T, PER_SEL, RB, C1><<<g1, NT, 0, s>>>(static_cast<const T*>(x), w, idx, ve, valid,
                                                      static_cast<T*>(act), nb, k, kv, ld, h_dim, i_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(n_visits, (h_dim + WARPS * C2 - 1) / (WARPS * C2), row_tiles);
  down_kernel<T, PER_SEL, RB, C2><<<g2, NT, 0, s>>>(static_cast<const T*>(act), w, idx, wts, ve, valid, w_visit,
                                                    static_cast<float*>(yw), nb, k, kv, ld, h_dim, i_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = nb * h_dim;
  combine_kernel<T, PER_SEL><<<(n_out + NT - 1) / NT, NT, 0, s>>>(static_cast<const float*>(yw), valid,
                                                                  static_cast<T*>(out), nb, n_visits, kv, w.n_exp,
                                                                  h_dim);
  return (int)cudaGetLastError();
}

template <int NTL>
int launch_mma(const void* x, const Experts& w, const int* ve, const int* valid, const float* w_visit, void* act,
               void* yw, void* out, int nb, int n_sh, int h_dim, int i_dim, cudaStream_t s) {
  constexpr int MT = 2;
  const int n_visits = w.n_exp + n_sh;
  const int row_tiles = (nb + 8 * NTL - 1) / (8 * NTL);
  swiglu_mma_kernel<NTL><<<dim3(n_visits, (i_dim + 15) / 16, row_tiles), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), w, ve, valid, static_cast<__nv_bfloat16*>(act), nb, h_dim, i_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_mma_kernel<MT, NTL><<<dim3(n_visits, (h_dim + 16 * MT - 1) / (16 * MT), row_tiles), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(act), w, ve, valid, w_visit, static_cast<float*>(yw), nb, h_dim, i_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = nb * h_dim;
  combine_kernel<__nv_bfloat16, false><<<(n_out + NT - 1) / NT, NT, 0, s>>>(
      static_cast<const float*>(yw), valid, static_cast<__nv_bfloat16*>(out), nb, n_visits, 0, w.n_exp, h_dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int per_sel, const void* x, const Experts& w, const void* idx, const void* wts, const void* ve,
           const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb, int k, int ld, int n_sh,
           int h_dim, int i_dim, void* stream) {
  if (nb <= 0 || k <= 0 || ld < k || n_sh < 0 || w.n_exp <= 0 || h_dim % q8::KV || i_dim % q8::KV || h_dim <= 0 ||
      i_dim <= 0 || (n_sh > 0 && (!w.pgu || !w.pdown))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  const float* wt = static_cast<const float*>(wts);
  const int* v = static_cast<const int*>(ve);
  const int* vd = static_cast<const int*>(valid);
  const float* wv = static_cast<const float*>(w_visit);
  // J with bf16 x takes the tensor cores; I's visits have one row each.
  if (!per_sel && sizeof(T) == 2 && h_dim % q8::MK == 0 && i_dim % q8::MK == 0) {
#define MOE_Q8_MMA(NTL) return launch_mma<NTL>(x, w, v, vd, wv, act, yw, out, nb, n_sh, h_dim, i_dim, s)
    if (nb <= 8) MOE_Q8_MMA(1);
    if (nb <= 16) MOE_Q8_MMA(2);
    MOE_Q8_MMA(4);
#undef MOE_Q8_MMA
  }
#define MOE_Q8_LAUNCH(PS, RB, C1, C2) \
  return launch_cfg<T, PS, RB, C1, C2>(x, w, ix, wt, v, vd, wv, act, yw, out, nb, k, ld, n_sh, h_dim, i_dim, s)
  if (per_sel) MOE_Q8_LAUNCH(true, 1, 4, 4);
  if (nb <= 8) MOE_Q8_LAUNCH(false, 8, 2, 2);
  if (nb <= 16) MOE_Q8_LAUNCH(false, 16, 1, 2);
  MOE_Q8_LAUNCH(false, 32, 1, 1);
#undef MOE_Q8_LAUNCH
}

}  // namespace

// x [B, H]; gu / gus / down / ds the routed experts, pgu / pgus / pdown / pds
// the n_sh pseudo-experts (null when n_sh = 0). per_sel = 1 (kernel I):
// idx int64 [B, k] and wts f32 [B, k], rows ld apart (a slice of the
// router's sorted [B, E] outputs needs no copy); workspaces act [B * (k + n_sh), 1, I]
// (T) and yw [B * (k + n_sh), 1, H] (f32). per_sel = 0 (kernel J): ve / valid
// int32 [E], w_visit f32 [E, B]; act [E + n_sh, B, I], yw [E + n_sh, B, H].
// out [B, H] in T.
#define MOE_Q8_ENTRY(NAME, T)                                                                                 \
  extern "C" int NAME(int per_sel, const void* x, const void* gu, const void* gus, const void* down,            \
                      const void* ds, const void* pgu, const void* pgus, const void* pdown, const void* pds,      \
                      const void* idx, const void* wts, const void* ve, const void* valid, const void* w_visit,    \
                      void* act, void* yw, void* out, int nb, int n_exp, int k, int ld, int n_sh, int h_dim,      \
                      int i_dim, void* stream) {                                                               \
    Experts w{static_cast<const int8_t*>(gu),    static_cast<const float*>(gus),                              \
              static_cast<const int8_t*>(down),  static_cast<const float*>(ds),                               \
              static_cast<const int8_t*>(pgu),   static_cast<const float*>(pgus),                             \
              static_cast<const int8_t*>(pdown), static_cast<const float*>(pds),                              \
              n_exp};                                                                                          \
    return launch<T>(per_sel, x, w, idx, wts, ve, valid, w_visit, act, yw, out, nb, k, ld, n_sh, h_dim, i_dim,\
                     stream);                                                                                  \
  }

MOE_Q8_ENTRY(moe_q8_f32, float)
MOE_Q8_ENTRY(moe_q8_bf16, __nv_bfloat16)
