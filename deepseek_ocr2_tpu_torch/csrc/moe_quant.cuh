// Quantized-weight decode MoE for sm_90a: the device code of kernels I and
// J (int8 experts, moe_q8.cu) and M and N (int4 experts, moe_q4.cu), one
// set of kernels templated on the weight format.
//
// I and M (PER_SEL): one visit per (row, selection), plus, when the shared
// MLP is split into pseudo-experts ("pe" streams), n_sh always-on visits
// per row with weight 1. J and N: one visit per DISTINCT selected expert
// over the whole batch, then the n_sh pseudo-expert visits over every row;
// the visit list (ve, valid) and the combine table w_visit [E, B] are
// kernel F's, built on the device with no host sync by the schedule kernel
// of csrc/moe_decode.cu.
//
// Experts in the port's layout: gu [E, 2I, H] (gate rows, then up rows) and
// down [E, H, I] as rows of codes, each row's scales beside it: one scale a
// row for int8 (Q8: gu_scale [E, 2I], down_scale [E, H]), one per group of
// 128 inputs for int4 (Q4: codes [.., In_p / 2], scales [.., In_p / 128],
// linear_q4.cuh's layout). The pseudo-experts the same with n_sh in place of
// E. Expert ids at or above E name pseudo-expert id - E.
//
// Under expert parallelism a rank holds E = E_local experts and the router's
// selections of other ranks' experts carry the id E with weight 0
// (ops/moe.local_routing). Per selection such a selection is a visit with no
// work: it reads no expert and adds nothing to its row's sum, so a row with
// no local selection comes out an exact zero. (The distinct-expert plan
// never lists it: the schedule gives it no visit.) out is written in T, or
// in f32 unrounded (out_f32: the rank's partial, summed over the ranks
// before one rounding).
//
// Rounding points, those of the TPU kernels (_q8_kernel, _decode_q8_kernel,
// _q4_swiglu; round() is to x's type T, identity for f32; every sum in f32):
//   gate = x . gu[i] scaled,  up = x . gu[I + i] scaled               (f32)
//   act  = round(silu_f32(gate) * up)
//   y    = act . down[h] scaled                                        (f32)
//   out  = round(sum over visits of y * w)    (not rounded with out_f32)
// where "scaled" is the dot times the row's scale (int8) or each group's dot
// times its scale, summed (int4). This differs from kernel F, which rounds
// gate and up before silu. The sum runs in the TPU grid's order: per
// selection a row's selections in top-k order, then its pseudo-experts;
// distinct experts the valid visits in ascending expert id, then the
// pseudo-experts.
//
// Three launches, as F's f32 form: swiglu (grid visit x I tile x row tile)
// writes act [V, R, I] in T; down writes y * w [V, R, H] in f32; combine
// sums each output's visits in that fixed order and casts once. This is
// the first form of J, M and N: each runs it only with f32 x or a shape its
// stream does not take (with bf16 x, J runs F's bulk-copy tensor-core
// stream in moe_q8.cu, N the same design over int4 codes in moe_q4.cu, M a
// per-selection stream there: no combine launch). I runs it at every
// shape. No atomics, so a
// row's bits depend neither on the other rows of the batch nor on the run.
// The products are the format's GEMV device code: for the distinct-expert
// plan with bf16 x its tensor-core block dots (each block's warps split the
// contraction and sum in warp order), otherwise its CUDA-core warp dots
// (per-selection visits have one row each: the bytes, not the FMAs, bound
// them).
//
// Shapes: H and I multiples of the format's KV (16 int8, 32 int4), any B.

#pragma once

#include "linear_q4.cuh"
#include "linear_q8.cuh"

#include <math.h>

namespace moe_quant {

using gemv::NT;
using gemv::WARPS;

// int8 codes, one scale a row applied after the dot.
struct Q8 {
  using Code = int8_t;
  static constexpr int KV = q8::KV;
  __host__ __device__ static size_t row_bytes(int in_dim) { return in_dim; }
  __host__ __device__ static int scales_per_row(int) { return 1; }
  static bool mma_ok(int h_dim, int i_dim) { return h_dim % q8::MK == 0 && i_dim % q8::MK == 0; }

  // Scaled sums of COLS rows against RB rows of x, on every lane.
  template <typename T, int RB, int COLS>
  __device__ static void dots(const T* __restrict__ x, int nb, int b0, int in_dim, const Code* const* rows,
                              const float* const* srows, float* acc) {
    q8::warp_dots<T, RB, COLS>(x, nb, b0, in_dim, rows, acc);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[c * RB + r] *= *srows[c];
  }

  // Scaled tiles, on warp 0 (block_mma_dots' layout).
  template <int MT, int NTL>
  __device__ static void mma_dots(const __nv_bfloat16* __restrict__ x, int nb, int b0, int in_dim,
                                  const Code* const* rlo, const Code* const* rhi, const float* const* slo,
                                  const float* const* shi, float (&acc)[MT][NTL][4], float* red) {
    q8::block_mma_dots<MT, NTL>(x, nb, b0, in_dim, rlo, rhi, acc, red);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] *= *(c < 2 ? slo[mt] : shi[mt]);
  }
};

// int4 codes with group-128 scales, applied inside the dot.
struct Q4 {
  using Code = uint8_t;
  static constexpr int KV = q4::KV;
  __host__ __device__ static size_t row_bytes(int in_dim) { return q4::row_bytes(in_dim); }
  __host__ __device__ static int scales_per_row(int in_dim) { return q4::groups_of(in_dim); }
  static bool mma_ok(int, int) { return true; }

  template <typename T, int RB, int COLS>
  __device__ static void dots(const T* __restrict__ x, int nb, int b0, int in_dim, const Code* const* rows,
                              const float* const* srows, float* acc) {
    q4::warp_dots<T, RB, COLS>(x, nb, b0, in_dim, rows, srows, acc);
  }

  template <int MT, int NTL>
  __device__ static void mma_dots(const __nv_bfloat16* __restrict__ x, int nb, int b0, int in_dim,
                                  const Code* const* rlo, const Code* const* rhi, const float* const* slo,
                                  const float* const* shi, float (&acc)[MT][NTL][4], float* red) {
    q4::block_mma_dots<MT, NTL>(x, nb, b0, in_dim, rlo, rhi, slo, shi, acc, red);
  }
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// Valid visits (a prefix of the E visits), counted by a warp: 128 flags a
// round of loads, counted by ballots. Every lane of the warp calls it.
__device__ __forceinline__ int count_valid(const int* valid, int n_exp, int lane) {
  int n = 0;
  for (int v0 = 0; v0 < n_exp; v0 += 128) {
    int f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = v0 + 32 * i + lane < n_exp ? valid[v0 + 32 * i + lane] : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) n += __popc(__ballot_sync(gemv::FULL, f[i] != 0));
  }
  return n;
}

// Visit v's expert: ve[v] for the nv valid visits, pseudo-expert v - nv
// after (0 past the last visit): the stream kernels' visit order (moe_q8.cu,
// moe_q4.cu).
__device__ __forceinline__ int visit_expert(const int* ve, int v, int nv, int n_visits) {
  return v >= n_visits ? 0 : v < nv ? ve[v] : v - nv;
}

template <typename F>
struct Experts {
  const typename F::Code* gu;
  const float* gus;
  const typename F::Code* down;
  const float* ds;
  const typename F::Code* pgu;
  const float* pgus;
  const typename F::Code* pdown;
  const float* pds;
  int n_exp;
};

// Row `r` of a stream of expert ex: rows of gate||up over H, or of down
// over I.
template <typename F>
struct Row {
  const typename F::Code* q;
  const float* s;
};

template <typename F>
__device__ __forceinline__ Row<F> gu_row(const Experts<F>& w, int ex, int r, int h_dim, int i_dim) {
  const bool pe = ex >= w.n_exp;
  const size_t row = (size_t)(pe ? ex - w.n_exp : ex) * 2 * i_dim + r;
  return {(pe ? w.pgu : w.gu) + row * F::row_bytes(h_dim), (pe ? w.pgus : w.gus) + row * F::scales_per_row(h_dim)};
}

template <typename F>
__device__ __forceinline__ Row<F> down_row(const Experts<F>& w, int ex, int r, int h_dim, int i_dim) {
  const bool pe = ex >= w.n_exp;
  const size_t row = (size_t)(pe ? ex - w.n_exp : ex) * h_dim + r;
  return {(pe ? w.pdown : w.down) + row * F::row_bytes(i_dim), (pe ? w.pds : w.ds) + row * F::scales_per_row(i_dim)};
}

// Whether selection j of row b names another rank's expert (id >= E):
// a per-selection visit with no work.
__device__ __forceinline__ bool not_local(const long long* idx, int b, int j, int k, int ld, int n_exp) {
  return j < k && idx[(size_t)b * ld + j] >= n_exp;
}

// Visit v of the plan -> (expert id, first row of x), or false for a visit
// with no work: a pad visit of the distinct-expert plan, or a selection of
// another rank's expert.
//   PER_SEL: v = b * kv + j; expert idx[b, j] (row stride ld) for j < k,
//   else E + j - k.
//   else: expert ve[v] for a valid v < E, v itself for v >= E.
template <bool PER_SEL>
__device__ __forceinline__ bool visit(int v, const long long* idx, const int* ve, const int* valid, int k, int kv,
                                      int ld, int n_exp, int* ex, int* row) {
  if (PER_SEL) {
    const int b = v / kv, j = v % kv;
    if (not_local(idx, b, j, k, ld, n_exp)) return false;
    *ex = j < k ? (int)idx[(size_t)b * ld + j] : n_exp + j - k;
    *row = b;
    return true;
  }
  if (v < n_exp && !valid[v]) return false;
  *ex = v < n_exp ? ve[v] : v;
  *row = 0;
  return true;
}

template <typename F, typename T, bool PER_SEL, int RB, int COLS>
__global__ void __launch_bounds__(NT) swiglu_kernel(const T* __restrict__ x, Experts<F> w, const long long* idx,
                                                    const int* ve, const int* valid, T* __restrict__ act, int nb,
                                                    int k, int kv, int ld, int h_dim, int i_dim) {
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<PER_SEL>(v, idx, ve, valid, k, kv, ld, w.n_exp, &ex, &row)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = (blockIdx.y * WARPS + warp) * COLS;
  if (i0 >= i_dim) return;  // warp-uniform
  const int rows_v = PER_SEL ? 1 : nb;  // rows of x this visit covers
  const int b0 = blockIdx.z * RB;
  const typename F::Code* rows[2 * COLS];
  const float* srows[2 * COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = min(i0 + c, i_dim - 1);
#pragma unroll
    for (int t = 0; t < 2; ++t) {  // gate row i, up row I + i
      const Row<F> r = gu_row(w, ex, t * i_dim + i, h_dim, i_dim);
      rows[2 * c + t] = r.q;
      srows[2 * c + t] = r.s;
    }
  }
  float acc[2 * COLS * RB];
  F::template dots<T, RB, 2 * COLS>(x + (size_t)row * h_dim, rows_v, b0, h_dim, rows, srows, acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = i0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < rows_v && i < i_dim) {
        const float gate = acc[(2 * c) * RB + r], up = acc[(2 * c + 1) * RB + r];
        act[((size_t)v * rows_v + b0 + r) * i_dim + i] = gemv::from_f32<T>(silu(gate) * up);
      }
    }
  }
}

template <typename F, typename T, bool PER_SEL, int RB, int COLS>
__global__ void __launch_bounds__(NT) down_kernel(const T* __restrict__ act, Experts<F> w, const long long* idx,
                                                  const float* wts, const int* ve, const int* valid,
                                                  const float* w_visit, float* __restrict__ yw, int nb, int k, int kv,
                                                  int ld, int h_dim, int i_dim) {
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<PER_SEL>(v, idx, ve, valid, k, kv, ld, w.n_exp, &ex, &row)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = (blockIdx.y * WARPS + warp) * COLS;
  if (h0 >= h_dim) return;
  const int rows_v = PER_SEL ? 1 : nb;
  const int b0 = blockIdx.z * RB;
  const typename F::Code* rows[COLS];
  const float* srows[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const Row<F> r = down_row(w, ex, min(h0 + c, h_dim - 1), h_dim, i_dim);
    rows[c] = r.q;
    srows[c] = r.s;
  }
  float acc[COLS * RB];
  F::template dots<T, RB, COLS>(act + (size_t)v * rows_v * i_dim, rows_v, b0, i_dim, rows, srows, acc);
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
        yw[((size_t)v * rows_v + b) * h_dim + h] = acc[c * RB + r] * wt;
      }
    }
  }
}

// Tensor-core forms of the distinct-expert plan (bf16 x): the same visits,
// rows and epilogues, the products through the format's block dots.
// swiglu: a block takes 16 columns i of a visit, as two row tiles (gate
// rows i, up rows I + i), and 8 * NTL rows of x.
template <typename F, int NTL>
__global__ void __launch_bounds__(NT) swiglu_mma_kernel(const __nv_bfloat16* __restrict__ x, Experts<F> w,
                                                        const int* ve, const int* valid,
                                                        __nv_bfloat16* __restrict__ act, int nb, int h_dim, int i_dim) {
  __shared__ float red[WARPS * 32 * 2 * NTL * 4];
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<false>(v, nullptr, ve, valid, 0, 0, 0, w.n_exp, &ex, &row)) return;  // block-uniform
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int i0 = blockIdx.y * 16;
  const int b0 = blockIdx.z * 8 * NTL;
  const typename F::Code* rlo[2];
  const typename F::Code* rhi[2];
  const float* slo[2];
  const float* shi[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const Row<F> lo = gu_row(w, ex, t * i_dim + min(i0 + g, i_dim - 1), h_dim, i_dim);
    const Row<F> hi = gu_row(w, ex, t * i_dim + min(i0 + g + 8, i_dim - 1), h_dim, i_dim);
    rlo[t] = lo.q;
    slo[t] = lo.s;
    rhi[t] = hi.q;
    shi[t] = hi.s;
  }
  float acc[2][NTL][4];
  F::template mma_dots<2, NTL>(x, nb, b0, h_dim, rlo, rhi, slo, shi, acc, red);
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + g + 8 * (c / 2);
      const int b = b0 + 8 * nt + 2 * qd + c % 2;
      if (i < i_dim && b < nb) {
        act[((size_t)v * nb + b) * i_dim + i] = __float2bfloat16_rn(silu(acc[0][nt][c]) * acc[1][nt][c]);
      }
    }
}

// down: a block takes 16 * MT output columns h of a visit.
template <typename F, int MT, int NTL>
__global__ void __launch_bounds__(NT) down_mma_kernel(const __nv_bfloat16* __restrict__ act, Experts<F> w,
                                                      const int* ve, const int* valid, const float* w_visit,
                                                      float* __restrict__ yw, int nb, int h_dim, int i_dim) {
  __shared__ float red[WARPS * 32 * MT * NTL * 4];
  const int v = blockIdx.x;
  int ex, row;
  if (!visit<false>(v, nullptr, ve, valid, 0, 0, 0, w.n_exp, &ex, &row)) return;
  const int lane = threadIdx.x % 32, g = lane / 4, qd = lane % 4;
  const int h0 = blockIdx.y * 16 * MT;
  const int b0 = blockIdx.z * 8 * NTL;
  const typename F::Code* rlo[MT];
  const typename F::Code* rhi[MT];
  const float* slo[MT];
  const float* shi[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const Row<F> lo = down_row(w, ex, min(h0 + 16 * mt + g, h_dim - 1), h_dim, i_dim);
    const Row<F> hi = down_row(w, ex, min(h0 + 16 * mt + g + 8, h_dim - 1), h_dim, i_dim);
    rlo[mt] = lo.q;
    slo[mt] = lo.s;
    rhi[mt] = hi.q;
    shi[mt] = hi.s;
  }
  float acc[MT][NTL][4];
  F::template mma_dots<MT, NTL>(act + (size_t)v * nb * i_dim, nb, b0, i_dim, rlo, rhi, slo, shi, acc, red);
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
          yw[((size_t)v * nb + b) * h_dim + h] = acc[mt][nt][c] * wt;
        }
      }
}

// out[b, h] = round(sum of row b's visits in order) in TO (T, or f32 for
// the unrounded sum): per selection the visits b * kv .. b * kv + kv - 1
// that have work; distinct experts the valid visits v = 0 .. V - 1.
template <typename TO, bool PER_SEL>
__global__ void __launch_bounds__(NT) combine_kernel(const float* __restrict__ yw, const long long* sel,
                                                     const int* valid, TO* __restrict__ out, int nb, int n_visits,
                                                     int k, int kv, int ld, int n_exp, int h_dim) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= nb * h_dim) return;
  const int b = idx / h_dim, h = idx % h_dim;
  float s = 0.f;
  if (PER_SEL) {
    for (int j = 0; j < kv; ++j) {
      if (!not_local(sel, b, j, k, ld, n_exp)) s += yw[((size_t)b * kv + j) * h_dim + h];
    }
  } else {
    for (int v = 0; v < n_visits; ++v) {
      if (v >= n_exp || valid[v]) s += yw[((size_t)v * nb + b) * h_dim + h];
    }
  }
  out[idx] = gemv::from_f32<TO>(s);
}

// The combine launch, its output in T or (out_f32) in f32.
template <typename T, bool PER_SEL>
cudaError_t launch_combine(const float* yw, const long long* idx, const int* valid, void* out, bool out_f32, int nb,
                           int n_visits, int k, int kv, int ld, int n_exp, int h_dim, cudaStream_t s) {
  const int blocks = (nb * h_dim + NT - 1) / NT;
  if (out_f32) {
    combine_kernel<float, PER_SEL><<<blocks, NT, 0, s>>>(yw, idx, valid, static_cast<float*>(out), nb, n_visits, k,
                                                          kv, ld, n_exp, h_dim);
  } else {
    combine_kernel<T, PER_SEL><<<blocks, NT, 0, s>>>(yw, idx, valid, static_cast<T*>(out), nb, n_visits, k, kv, ld,
                                                      n_exp, h_dim);
  }
  return cudaGetLastError();
}

template <typename F, typename T, bool PER_SEL, int RB, int C1, int C2>
int launch_cfg(const void* x, const Experts<F>& w, const long long* idx, const float* wts, const int* ve,
               const int* valid, const float* w_visit, void* act, void* yw, void* out, bool out_f32, int nb, int k,
               int ld, int n_sh, int h_dim, int i_dim, cudaStream_t s) {
  const int kv = k + n_sh;
  const int n_visits = PER_SEL ? nb * kv : w.n_exp + n_sh;
  const int row_tiles = PER_SEL ? 1 : (nb + RB - 1) / RB;
  const dim3 g1(n_visits, (i_dim + WARPS * C1 - 1) / (WARPS * C1), row_tiles);
  swiglu_kernel<F, T, PER_SEL, RB, C1><<<g1, NT, 0, s>>>(static_cast<const T*>(x), w, idx, ve, valid,
                                                         static_cast<T*>(act), nb, k, kv, ld, h_dim, i_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(n_visits, (h_dim + WARPS * C2 - 1) / (WARPS * C2), row_tiles);
  down_kernel<F, T, PER_SEL, RB, C2><<<g2, NT, 0, s>>>(static_cast<const T*>(act), w, idx, wts, ve, valid, w_visit,
                                                       static_cast<float*>(yw), nb, k, kv, ld, h_dim, i_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine<T, PER_SEL>(static_cast<const float*>(yw), idx, valid, out, out_f32, nb, n_visits, k,
                                         kv, ld, w.n_exp, h_dim, s);
}

template <typename F, int NTL>
int launch_mma(const void* x, const Experts<F>& w, const int* ve, const int* valid, const float* w_visit, void* act,
               void* yw, void* out, bool out_f32, int nb, int n_sh, int h_dim, int i_dim, cudaStream_t s) {
  constexpr int MT = 2;
  const int n_visits = w.n_exp + n_sh;
  const int row_tiles = (nb + 8 * NTL - 1) / (8 * NTL);
  swiglu_mma_kernel<F, NTL><<<dim3(n_visits, (i_dim + 15) / 16, row_tiles), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), w, ve, valid, static_cast<__nv_bfloat16*>(act), nb, h_dim, i_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_mma_kernel<F, MT, NTL><<<dim3(n_visits, (h_dim + 16 * MT - 1) / (16 * MT), row_tiles), NT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(act), w, ve, valid, w_visit, static_cast<float*>(yw), nb, h_dim, i_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_combine<__nv_bfloat16, false>(static_cast<const float*>(yw), nullptr, valid, out, out_f32, nb,
                                                   n_visits, 0, 0, 0, w.n_exp, h_dim, s);
}

template <typename F, typename T>
int launch(int per_sel, const void* x, const Experts<F>& w, const void* idx, const void* wts, const void* ve,
           const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb, int k, int ld, int n_sh,
           int h_dim, int i_dim, int out_f32, void* stream) {
  if (nb <= 0 || k <= 0 || ld < k || n_sh < 0 || w.n_exp <= 0 || h_dim % F::KV || i_dim % F::KV || h_dim <= 0 ||
      i_dim <= 0 || (n_sh > 0 && (!w.pgu || !w.pdown))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* ix = static_cast<const long long*>(idx);
  const float* wt = static_cast<const float*>(wts);
  const int* v = static_cast<const int*>(ve);
  const int* vd = static_cast<const int*>(valid);
  const float* wv = static_cast<const float*>(w_visit);
  // The distinct-expert plan with bf16 x takes the tensor cores; per-selection
  // visits have one row each.
  if (!per_sel && sizeof(T) == 2 && F::mma_ok(h_dim, i_dim)) {
#define MOE_QUANT_MMA(NTL) \
  return launch_mma<F, NTL>(x, w, v, vd, wv, act, yw, out, out_f32 != 0, nb, n_sh, h_dim, i_dim, s)
    if (nb <= 8) MOE_QUANT_MMA(1);
    if (nb <= 16) MOE_QUANT_MMA(2);
    MOE_QUANT_MMA(4);
#undef MOE_QUANT_MMA
  }
#define MOE_QUANT_LAUNCH(PS, RB, C1, C2) \
  return launch_cfg<F, T, PS, RB, C1, C2>(x, w, ix, wt, v, vd, wv, act, yw, out, out_f32 != 0, nb, k, ld, n_sh, h_dim, \
                                          i_dim, s)
  if (per_sel) MOE_QUANT_LAUNCH(true, 1, 4, 4);
  if (nb <= 8) MOE_QUANT_LAUNCH(false, 8, 2, 2);
  if (nb <= 16) MOE_QUANT_LAUNCH(false, 16, 1, 2);
  MOE_QUANT_LAUNCH(false, 32, 1, 1);
#undef MOE_QUANT_LAUNCH
}

}  // namespace moe_quant

// x [B, H]; gu / gus / down / ds the routed experts, pgu / pgus / pdown / pds
// the n_sh pseudo-experts (null when n_sh = 0), in format F's layout.
// per_sel = 1: idx int64 [B, k] and wts f32 [B, k], rows ld apart (a slice
// of the router's sorted [B, E] outputs needs no copy); workspaces act
// [B * (k + n_sh), 1, I] (T) and yw [B * (k + n_sh), 1, H] (f32).
// per_sel = 0: ve / valid int32 [E], w_visit f32 [E, B]; act [E + n_sh, B, I],
// yw [E + n_sh, B, H]. out [B, H] in T, or in f32 (unrounded) when out_f32.
#define MOE_QUANT_ENTRY(NAME, F, T)                                                                            \
  extern "C" int NAME(int per_sel, const void* x, const void* gu, const void* gus, const void* down,            \
                      const void* ds, const void* pgu, const void* pgus, const void* pdown, const void* pds,      \
                      const void* idx, const void* wts, const void* ve, const void* valid, const void* w_visit,    \
                      void* act, void* yw, void* out, int nb, int n_exp, int k, int ld, int n_sh, int h_dim,      \
                      int i_dim, int out_f32, void* stream) {                                                  \
    using C = F::Code;                                                                                         \
    moe_quant::Experts<F> w{static_cast<const C*>(gu),    static_cast<const float*>(gus),                      \
                            static_cast<const C*>(down),  static_cast<const float*>(ds),                       \
                            static_cast<const C*>(pgu),   static_cast<const float*>(pgus),                     \
                            static_cast<const C*>(pdown), static_cast<const float*>(pds),                      \
                            n_exp};                                                                            \
    return moe_quant::launch<F, T>(per_sel, x, w, idx, wts, ve, valid, w_visit, act, yw, out, nb, k, ld, n_sh, \
                                   h_dim, i_dim, out_f32, stream);                                             \
  }
