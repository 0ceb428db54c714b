// Fused ViT MLP for sm_90a: out = gelu_erf(x W1^T + b1) W2^T + b2.
//
// Replaces the Pallas TPU kernel _mlp_kernel of
// deepseek_ocr2_tpu/ops/fused_mlp.py (every SAM block's MLP: 768 -> 3072 ->
// 768 over 4096 tokens per 1024^2 view). As there, the [M, F] intermediate
// never reaches device memory: one block owns a 32-row tile and walks F in
// 128-wide chunks. For each chunk it computes h = x W1^T, applies the
// activation, and accumulates the chunk's down-product into an f32
// accumulator held in registers for the whole F walk; b2 is added once.
//
// Rounding points are those of the TPU kernel and of the XLA form it
// mirrors, for T = bf16 (identity for f32):
//   h = round_T(f32 dot) ; h = round_T(h + b1) ; g = round_T(gelu(h) in f32)
//   out = round_T(round_T(f32 sum over F of g * W2) + b2)
// GELU is the exact form 0.5 h (1 + erf(h / sqrt 2)) with CUDA's erff (at
// most 2 ulp); the TPU kernel had to use a 1.5e-7-accurate polynomial.
//
// What bounds it: ~38.6 GFLOP of f32 FMAs per SAM MLP at M = 4096 on CUDA
// cores (no TF32, per the port's f32 parity policy), fed from shared
// memory, whose 128 B/clock per SM must not fall below the FMA rate. Each
// thread therefore owns 8 rows of its tiles, so every weight word it loads
// feeds 8 FMAs: an 8 x 2 tile of h in the up product, an 8 x 12 tile of the
// accumulator in the down product. x and the activations are stored
// transposed (row index fastest) so the 8 row values come as two broadcast
// 16-byte loads; weights are staged transposed (output column fastest) and
// read as 8- or 16-byte vectors by consecutive lanes. The weights (2 x 9.4
// MB in f32) are re-read by every row tile from the 50 MB L2, as 16-byte
// loads along their rows. wgmma, TMA and a bf16 tensor-core path come later.
//
// Layout (HF nn.Linear [out, in], contiguous, 16-byte aligned): x [M, E],
// w1 [F, E], b1 [F], w2 [E, F], b2 [E], out [M, E], with E <= 768 and E, F
// multiples of 4. Grid ceil(M / 32), 256 threads: thread (rg, cg) =
// (tid / 64, tid % 64) owns rows 8 rg .. 8 rg + 7; in the up product the
// chunk columns 2 cg, 2 cg + 1, in the down product the columns
// 4 cg + 256 j + {0..3}, j < 3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 32;    // rows per block
constexpr int FC = 128;   // F chunk
constexpr int KC = 64;    // E slice of W1 staged per step (up product)
constexpr int KF = 16;    // F slice of W2 staged per step (down product)
constexpr int NT = 256;
constexpr int MAX_E = 768;
constexpr int EJ = MAX_E / 256;  // 16-byte column groups per thread (down product)
constexpr int RS = BM + 4;       // row stride of the transposed x / activation tiles
constexpr int WS1 = FC + 2;      // row stride of the staged W1 slice [KC][FC]

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f32(from_f32<T>(x));
}

// Four consecutive elements from global memory (16-byte aligned for f32,
// 8-byte for bf16), widened to f32.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

size_t smem_floats(int e) {
  const size_t w1 = (size_t)KC * WS1, w2 = (size_t)KF * (e + 4);
  return (size_t)e * RS + (size_t)FC * RS + (w1 > w2 ? w1 : w2);
}

template <typename T>
__global__ void __launch_bounds__(NT) mlp_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ out, int m, int e,
    int f) {
  extern __shared__ __align__(16) float smem[];
  const int ew = e + 4;           // row stride of the staged W2 slice [KF][E]
  float* xs = smem;               // [E][RS]: x transposed
  float* gs = xs + e * RS;        // [FC][RS]: activations of the chunk, transposed
  float* ws = gs + FC * RS;       // W1 slice [KC][WS1] or W2 slice [KF][ew]

  const int tid = threadIdx.x;
  const int rg = tid / 64;
  const int cg = tid % 64;
  const int row0 = blockIdx.x * BM;

  for (int i = tid; i < BM * (e / 4); i += NT) {
    const int r = i % BM, c = 4 * (i / BM);  // lanes on rows: conflict-free transposed stores
    const float4 v = row0 + r < m ? load4(x + (size_t)(row0 + r) * e + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    xs[(c + 0) * RS + r] = v.x;
    xs[(c + 1) * RS + r] = v.y;
    xs[(c + 2) * RS + r] = v.z;
    xs[(c + 3) * RS + r] = v.w;
  }

  float acc[8][EJ][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < EJ; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  for (int f0 = 0; f0 < f; f0 += FC) {
    // Up product: h[i][t] = x[8 rg + i] . W1[f0 + 2 cg + t]
    float h[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i][0] = h[i][1] = 0.f;
    for (int e0 = 0; e0 < e; e0 += KC) {
      __syncthreads();  // ws free (and xs written on the first pass)
      for (int i = tid; i < FC * (KC / 4); i += NT) {
        // Lanes take consecutive rows of W1, so the transposed stores hit
        // consecutive banks; the other half of each 32-byte sector read is
        // the next pass's (same lane, next 4 columns), served from L1.
        const int fl = i % FC, el = 4 * (i / FC);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (f0 + fl < f && e0 + el < e) v = load4(w1 + (size_t)(f0 + fl) * e + e0 + el);
        ws[(el + 0) * WS1 + fl] = v.x;
        ws[(el + 1) * WS1 + fl] = v.y;
        ws[(el + 2) * WS1 + fl] = v.z;
        ws[(el + 3) * WS1 + fl] = v.w;
      }
      __syncthreads();
      const int n = min(KC, e - e0);
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 xa = *reinterpret_cast<const float4*>(xs + (e0 + k) * RS + rg * 8);
        const float4 xb = *reinterpret_cast<const float4*>(xs + (e0 + k) * RS + rg * 8 + 4);
        const float2 wv = *reinterpret_cast<const float2*>(ws + k * WS1 + cg * 2);
        const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          h[i][0] = fmaf(xv[i], wv.x, h[i][0]);
          h[i][1] = fmaf(xv[i], wv.y, h[i][1]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int fc = f0 + cg * 2 + t;
      const float bias = fc < f ? to_f32(b1[fc]) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float g = 0.f;
        if (fc < f) {
          const float hv = round_t<T>(round_t<T>(h[i][t]) + bias);
          g = round_t<T>(0.5f * hv * (1.f + erff(hv * 0.70710678118654752f)));
        }
        gs[(cg * 2 + t) * RS + rg * 8 + i] = g;
      }
    }

    // Down product: acc[i][j][t] += g[8 rg + i] . W2[4 cg + 256 j + t][f0 : f0 + FC]
    for (int k0 = 0; k0 < FC; k0 += KF) {
      __syncthreads();  // gs written; ws free
      for (int i = tid; i < e * (KF / 4); i += NT) {
        const int c = i % e, kl = 4 * (i / e);  // as for W1: lanes on consecutive rows
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (f0 + k0 + kl < f) v = load4(w2 + (size_t)c * f + f0 + k0 + kl);
        ws[(kl + 0) * ew + c] = v.x;
        ws[(kl + 1) * ew + c] = v.y;
        ws[(kl + 2) * ew + c] = v.z;
        ws[(kl + 3) * ew + c] = v.w;
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < KF; ++k) {
        const float4 ga = *reinterpret_cast<const float4*>(gs + (k0 + k) * RS + rg * 8);
        const float4 gb = *reinterpret_cast<const float4*>(gs + (k0 + k) * RS + rg * 8 + 4);
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          const int c = cg * 4 + 256 * j;
          const float4 wv = c < e ? *reinterpret_cast<const float4*>(ws + k * ew + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j][0] = fmaf(gv[i], wv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(gv[i], wv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(gv[i], wv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(gv[i], wv.w, acc[i][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + rg * 8 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < EJ; ++j) {
      const int c = cg * 4 + 256 * j;
      if (c >= e) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        out[(size_t)row * e + c + t] = from_f32<T>(round_t<T>(acc[i][j][t]) + to_f32(b2[c + t]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int m, int e, int f, void* stream) {
  if (m <= 0 || e <= 0 || e > MAX_E || e % 4 || f <= 0 || f % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(e);
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_kernel<T><<<(m + BM - 1) / BM, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), m, e, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mlp_max_e() { return MAX_E; }

extern "C" int mlp_gelu_f32(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int m, int e, int f, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, out, m, e, f, stream);
}

extern "C" int mlp_gelu_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, void* out, int m, int e, int f, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, m, e, f, stream);
}
