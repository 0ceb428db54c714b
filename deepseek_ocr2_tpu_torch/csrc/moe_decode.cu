// Batched-decode MoE for sm_90a: kernel F.
//
// Replaces the Pallas TPU kernel deepseek_ocr2_tpu/ops/moe_decode.py:
// _decode_kernel (via moe_ffn_decode_fused): one visit per DISTINCT
// selected expert, each over the whole decode batch, so every selected
// expert's weights stream from HBM once per step however many rows chose
// it. Rows that did not select a visit's expert get a zero combine weight.
//
// The visit list (built on the device by schedule_kernel below, one launch,
// no host sync; kernel J of csrc/moe_q8.cu takes the same one): ve [E] holds the distinct selected expert ids in ascending order, padded
// to E by repeating the last; valid [E] is 1 for a real visit. w_visit
// [E, B] f32 holds each row's routing weight for the visit's expert (0 if
// the row did not select it, and for every pad visit).
//
// Rounding points, those of the TPU kernel (round() is to the working type
// T, identity for f32; sums in f32):
//   gate = round(x Wg^T), up = round(x Wu^T)      (each over all of H)
//   act  = round(round(silu_f32(gate)) * up)
//   y    = act Wd^T                                (f32, not rounded)
//   out  = round(sum over visits, ascending expert id, of y * w_visit)
//
// Three launches after the schedule's:
//   1. swiglu: grid (visit, I tile, row tile) writes act [E, B, I] (T);
//   2. down:   grid (visit, H tile, row tile) writes y * w [E, B, H] (f32);
//   3. combine: one thread per (row, column) sums the valid visits in visit
//      order and casts to T.
// No atomics: a row's output is a fixed-order sum that does not depend on
// which other rows share the batch (a visit a row did not select adds an
// exact zero) and does not vary from run to run. Preemption in the
// continuous engine relies on that: a re-admitted page must reproduce its
// tokens. Invalid visits return at once in launches 1 and 2 and are
// skipped in 3.
//
// What bounds it: at B = 16 and k = 6 about 50 of the 64 experts are
// selected per step, and each visit reads 6.9 MB of bf16 weights at H =
// 1280, I = 896: ~340 MB per MoE layer, 0.1 ms at 3.35 TB/s. Each weight
// element is used by B rows, 2 * B FLOP per element (16 FLOP per byte at
// B = 16 in bf16), far below the tensor cores' ridge point, so the design
// streams the weights once with plain FMAs on the CUDA cores:
// - one warp per weight row; lanes read 16-byte vectors along K, so a
//   warp reads 512 contiguous bytes per step;
// - each warp holds 2 * COLS * RB f32 sums (64 in launch 1) in registers:
//   a loaded x vector feeds COLS weight rows (gate and up of COLS
//   columns), and RB rows of x are covered per block;
// - x (or act) rows come through the read-only cache: they are small
//   (40 KB at B = 16, H = 1280, bf16) and every warp of the grid reads
//   them;
// - the partial sums reduce across the warp with xor shuffles, and lane r
//   writes row r.
// mma.sync tensor cores, cp.async staging and a split of the K loop across
// warps are later work.
//
// Shapes: H and I multiples of 8 (16-byte vectors in bf16, 4 in f32),
// 16-byte aligned rows (checked by the wrapper); any B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float round(float x) { return round_bf16(x); }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16_rn(x); }
};

template <int N>
__device__ __forceinline__ void warp_sum(float* a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] += __shfl_xor_sync(FULL, a[j], off);
  }
}

// Launch 1. Block: visit v = blockIdx.x, columns [blockIdx.y * WARPS * COLS,
// + WARPS * COLS), rows [blockIdx.z * RB, + RB). Warp w owns COLS columns
// i; for each it streams the gate and up rows Wg[e, i, :], Wu[e, i, :].
template <typename T, int RB>
__global__ void __launch_bounds__(NT) swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                                                    const T* __restrict__ wu, const int* __restrict__ ve,
                                                    const int* __restrict__ valid, T* __restrict__ act,
                                                    int nb, int h_dim, int i_dim) {
  constexpr int COLS = 32 / RB;
  constexpr int VN = Vec<T>::N;
  const int v = blockIdx.x;
  if (!valid[v]) return;
  const int e = ve[v];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.z * RB;
  const int i0 = (blockIdx.y * WARPS + warp) * COLS;
  if (i0 >= i_dim) return;  // warp-uniform

  float acc[2 * COLS * RB];
#pragma unroll
  for (int j = 0; j < 2 * COLS * RB; ++j) acc[j] = 0.f;
  const T* grow[COLS];
  const T* urow[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = min(i0 + c, i_dim - 1);  // a ragged last warp re-reads a valid row, never writes it
    grow[c] = wg + ((size_t)e * i_dim + i) * h_dim;
    urow[c] = wu + ((size_t)e * i_dim + i) * h_dim;
  }
  for (int k = lane * VN; k < h_dim; k += 32 * VN) {
    float g[COLS][VN], u[COLS][VN];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      Vec<T>::load(grow[c] + k, g[c]);
      Vec<T>::load(urow[c] + k, u[c]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < nb) {
        float xv[VN];
        Vec<T>::load(x + (size_t)(b0 + r) * h_dim + k, xv);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
#pragma unroll
          for (int j = 0; j < VN; ++j) {
            acc[(2 * c) * RB + r] = fmaf(xv[j], g[c][j], acc[(2 * c) * RB + r]);
            acc[(2 * c + 1) * RB + r] = fmaf(xv[j], u[c][j], acc[(2 * c + 1) * RB + r]);
          }
        }
      }
    }
  }
  warp_sum<2 * COLS * RB>(acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = i0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < nb && i < i_dim) {
        const float gate = Vec<T>::round(acc[(2 * c) * RB + r]);
        const float up = Vec<T>::round(acc[(2 * c + 1) * RB + r]);
        act[((size_t)v * nb + b0 + r) * i_dim + i] = Vec<T>::store(Vec<T>::round(silu(gate)) * up);
      }
    }
  }
}

// Launch 2. Block: visit v, output columns [blockIdx.y * WARPS * COLS, +),
// rows [blockIdx.z * RB, + RB). Warp w streams the down rows Wd[e, h, :]
// of its COLS columns h against act[v, b, :].
template <typename T, int RB>
__global__ void __launch_bounds__(NT) down_kernel(const T* __restrict__ act, const T* __restrict__ wd,
                                                  const int* __restrict__ ve, const int* __restrict__ valid,
                                                  const float* __restrict__ w_visit, float* __restrict__ yw,
                                                  int nb, int i_dim, int h_dim) {
  constexpr int COLS = 32 / RB;
  constexpr int VN = Vec<T>::N;
  const int v = blockIdx.x;
  if (!valid[v]) return;
  const int e = ve[v];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.z * RB;
  const int h0 = (blockIdx.y * WARPS + warp) * COLS;
  if (h0 >= h_dim) return;

  float acc[COLS * RB];
#pragma unroll
  for (int j = 0; j < COLS * RB; ++j) acc[j] = 0.f;
  const T* drow[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) drow[c] = wd + ((size_t)e * h_dim + min(h0 + c, h_dim - 1)) * i_dim;
  const T* a = act + (size_t)v * nb * i_dim;
  for (int k = lane * VN; k < i_dim; k += 32 * VN) {
    float d[COLS][VN];
#pragma unroll
    for (int c = 0; c < COLS; ++c) Vec<T>::load(drow[c] + k, d[c]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < nb) {
        float av[VN];
        Vec<T>::load(a + (size_t)(b0 + r) * i_dim + k, av);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
#pragma unroll
          for (int j = 0; j < VN; ++j) acc[c * RB + r] = fmaf(av[j], d[c][j], acc[c * RB + r]);
        }
      }
    }
  }
  warp_sum<COLS * RB>(acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int h = h0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < nb && h < h_dim) {
        const int b = b0 + r;
        yw[((size_t)v * nb + b) * h_dim + h] = acc[c * RB + r] * w_visit[(size_t)v * nb + b];
      }
    }
  }
}

// Launch 3: out[b, h] = round(sum over valid visits v, in order, of yw[v, b, h]).
template <typename T>
__global__ void __launch_bounds__(NT) combine_kernel(const float* __restrict__ yw, const int* __restrict__ valid,
                                                     T* __restrict__ out, int n_visits, int n_out) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= n_out) return;
  float s = 0.f;
  for (int v = 0; v < n_visits; ++v) {
    if (valid[v]) s += yw[(size_t)v * n_out + idx];
  }
  out[idx] = Vec<T>::store(s);
}

template <typename T, int RB>
int launch_rb(const void* x, const void* wg, const void* wu, const void* wd, const void* ve,
              const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb, int n_exp,
              int h_dim, int i_dim, cudaStream_t stream) {
  constexpr int COLS = 32 / RB;
  const int row_tiles = (nb + RB - 1) / RB;
  const dim3 g1(n_exp, (i_dim + WARPS * COLS - 1) / (WARPS * COLS), row_tiles);
  swiglu_kernel<T, RB><<<g1, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const int*>(ve), static_cast<const int*>(valid), static_cast<T*>(act), nb, h_dim, i_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(n_exp, (h_dim + WARPS * COLS - 1) / (WARPS * COLS), row_tiles);
  down_kernel<T, RB><<<g2, NT, 0, stream>>>(
      static_cast<const T*>(act), static_cast<const T*>(wd), static_cast<const int*>(ve),
      static_cast<const int*>(valid), static_cast<const float*>(w_visit), static_cast<float*>(yw), nb, i_dim,
      h_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = nb * h_dim;
  combine_kernel<T><<<(n_out + NT - 1) / NT, NT, 0, stream>>>(
      static_cast<const float*>(yw), static_cast<const int*>(valid), static_cast<T*>(out), n_exp, n_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, const void* ve, const void* valid,
           const void* w_visit, void* act, void* yw, void* out, int nb, int n_exp, int h_dim, int i_dim,
           void* stream) {
  if (nb <= 0 || n_exp <= 0 || h_dim <= 0 || i_dim <= 0 || h_dim % 8 || i_dim % 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb <= 8) return launch_rb<T, 8>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, s);
  if (nb <= 16) return launch_rb<T, 16>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, s);
  return launch_rb<T, 32>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, s);
}

}  // namespace

// x [B, H]; wg / wu [E, I, H]; wd [E, H, I]; ve / valid [E] int32; w_visit
// [E, B] f32; workspaces act [E, B, I] (T) and yw [E, B, H] (f32); out [B, H].
extern "C" int moe_decode_f32(const void* x, const void* wg, const void* wu, const void* wd, const void* ve,
                              const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb,
                              int n_exp, int h_dim, int i_dim, void* stream) {
  return launch<float>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, stream);
}

extern "C" int moe_decode_bf16(const void* x, const void* wg, const void* wu, const void* wd, const void* ve,
                               const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb,
                               int n_exp, int h_dim, int i_dim, void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim,
                               stream);
}

// The visit schedule of F and J in one launch (the semantics of
// ops/moe_decode.py's distinct_schedule and combine_table): one block of E
// threads; thread e flags whether any row selected expert e, its rank
// among the flagged gives its visit; visits past the n distinct ones repeat
// the last distinct id with valid 0; w_visit[v, b] is the sum of row b's
// routing weights for visit v's expert (0 for a pad visit). idx int64 and
// wts f32 [B, k], rows ld apart; ve / valid int32 [E]; w_visit f32 [E, B].
namespace {

__global__ void schedule_kernel(const long long* __restrict__ idx, const float* __restrict__ wts, int nb, int k,
                                int ld, int n_exp, int* __restrict__ ve, int* __restrict__ valid,
                                float* __restrict__ w_visit) {
  extern __shared__ int sh[];  // present [E], then the distinct ids [E]
  int* present = sh;
  int* ids = sh + n_exp;
  const int e = threadIdx.x;
  int p = 0;
  for (int b = 0; b < nb; ++b)
    for (int j = 0; j < k; ++j) p |= idx[(size_t)b * ld + j] == e;
  present[e] = p;
  __syncthreads();
  int rank = 0, n_distinct = 0;
  for (int j = 0; j < n_exp; ++j) {
    rank += j < e ? present[j] : 0;
    n_distinct += present[j];
  }
  if (p) ids[rank] = e;
  __syncthreads();
  const int v = e;  // thread e also writes visit v = e
  const bool ok = v < n_distinct;
  const int vid = ids[ok ? v : max(n_distinct - 1, 0)];
  ve[v] = vid;
  valid[v] = ok;
  for (int b = 0; b < nb; ++b) {
    float w = 0.f;
    for (int j = 0; j < k; ++j) w += idx[(size_t)b * ld + j] == vid ? wts[(size_t)b * ld + j] : 0.f;
    w_visit[(size_t)v * nb + b] = ok ? w : 0.f;
  }
}

}  // namespace

extern "C" int moe_decode_schedule(const void* idx, const void* wts, int nb, int k, int ld, int n_exp, void* ve,
                                   void* valid, void* w_visit, void* stream) {
  if (nb <= 0 || k <= 0 || ld < k || n_exp <= 0 || n_exp > 1024) return (int)cudaErrorInvalidValue;
  schedule_kernel<<<1, n_exp, 2 * n_exp * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const float*>(wts), nb, k, ld, n_exp, static_cast<int*>(ve),
      static_cast<int*>(valid), static_cast<float*>(w_visit));
  return (int)cudaGetLastError();
}
