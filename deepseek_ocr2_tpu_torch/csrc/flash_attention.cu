// Exact attention with an online f32 softmax, for sm_90a.
//
// Replaces three Pallas TPU kernels of deepseek_ocr2_tpu/ops/flash_attention.py:
//   A: _attn_kernel        (modes none / causal / prefix; LM prefill uses causal)
//   B: _attn_kernel_relpos (SAM's decomposed relative-position bias)
//   V: _attn_kernel_relwin (SAM's windowed attention with the rel-pos bias
//      built inside the kernel from the flattened tables; the windowed
//      blocks under DEEPSEEK_SAM_WIN_KERNEL=1)
// The TPU kernels keep a whole score row in VMEM and take an exact softmax
// over it. A 64-query tile of f32 rows at SAM's 4096 global keys is 1 MB,
// far over the 227 KB of shared memory a block may use on Hopper, so this
// kernel streams 64-key tiles with an online softmax (running max and sum,
// rescaled per tile). Its result differs from the full-row form by f32
// rounding only.
//
// Semantics, per score (all in f32):
//   s = (q . k) * scale
//   B: s = s + (rel_h[q, key / Kw] + rel_w[q, key % Kw]); the [L, L] bias is
//      never built, each block loads its 64 query rows of rel_h / rel_w.
//   A causal:  key > query                                   -> s = -1e4
//   A prefix:  (query < P and key >= P) or
//              (query >= P and key >= P and key > query)     -> s = -1e4
//   V: per query block, the win rel-h and win rel-w dot products of each
//      query with its own rows of the flattened tables rhf, rwf [D, T2] f32
//      (rhf[c, h win + kh] = rel_h_table[h, kh, c]) go into shared memory,
//      in f32 FMAs (no TF32): rel_h[q, kh] = q . rhf[:, (q / win) win + kh],
//      rel_w[q, kw] = q . rwf[:, (q % win) win + kw]. They are then folded in
//      as B's are, and keys of a padded window (key / win or key % win >=
//      valid) get s = s - 1e30. The TPU kernel builds the same bias with four
//      0/1 select dots over [T2, T2] tiles; its t2 % 128 == 0 assertion is
//      the TPU's lane rule: any win works here (SAM's true 14 x 14 windows,
//      T2 = 196, and the JAX package's 16 / 14 padded form).
//   key padding (key >= Lk, the ragged last tile)            -> s = -inf
//   o = softmax(s) @ v, written in the input type.
// Fully masked causal tiles are still visited: with -1e4 (not -inf) they
// contribute exp(-1e4 - max) like the reference, and at LM prefill lengths
// (~260 keys) they cost little.
//
// What bounds it: at SAM's global shape (12 heads x 4096 x 4096, D = 64) the
// work is ~26 GFLOP of f32 FMAs per block on CUDA cores (no TF32: the port's
// f32 parity policy), read from shared memory. Each thread owns a 4 x 4
// score sub-tile, so every shared-memory load feeds two FMAs; K is stored
// with a padded row stride so the 16 column lanes hit 16 banks. bf16 inputs
// are widened to f32 on load: products of bf16 values are exact in f32, which
// is what the TPU kernel's bf16 MXU pass with f32 accumulation computes.
// Tensor cores (wgmma) and TMA come in a later change. V adds 2 win D FMAs
// per query to B's 2 T2 D of the scores: at win 14, T2 196, 14 %; in
// exchange the [B H, T2, win] rel tensors are never written or read.
//
// Layout: q [BH, Lq, D], k/v [BH, Lk, D], o [BH, Lq, D], rel_h [BH, Lq, Kh],
// rel_w [BH, Lq, Kw] (f32), all contiguous; for V (mode 4, through the
// same entry points) rel_h / rel_w are the tables rhf / rwf [D, T2] f32
// (shared by every window and head), Kh = Kw = win, Lq = Lk = T2, and the
// n_prefix argument carries `valid`. Grid (ceil(Lq / 64), BH),
// 256 threads: thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// 4*ty .. 4*ty+3 and key / output columns tx + 16*j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float MASK_VALUE = -1.0e4f;

enum Mode { NONE = 0, CAUSAL = 1, PREFIX = 2, RELPOS = 3, RELWIN = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(NT) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    int lq, int lk, int n_prefix, int kh, int kw, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D + 1]
  float* ks = qs + BQ * (D + 1);     // [BK][D + 1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK + 1] probabilities of the tile
  float* rhs = ps + BQ * (BK + 1);   // [BQ][kh]   (relpos / relwin only)
  float* rws = rhs + BQ * kh;        // [BQ][kw]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (size_t)bh * lq * D;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * (D + 1) + c] = (q0 + r < lq) ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  if (MODE == RELPOS) {
    const float* rhb = rel_h + (size_t)bh * lq * kh;
    const float* rwb = rel_w + (size_t)bh * lq * kw;
    for (int i = tid; i < BQ * kh; i += NT) {
      const int r = i / kh;
      rhs[i] = (q0 + r < lq) ? rhb[(size_t)(q0 + r) * kh + i % kh] : 0.f;
    }
    for (int i = tid; i < BQ * kw; i += NT) {
      const int r = i / kw;
      rws[i] = (q0 + r < lq) ? rwb[(size_t)(q0 + r) * kw + i % kw] : 0.f;
    }
  }
  if (MODE == RELWIN) {
    __syncthreads();  // the block's q rows are staged
    const int win = kh;
    for (int i = tid; i < BQ * win; i += NT) {
      const int r = i / win, kk = i % win, qp = q0 + r;
      float sh = 0.f, sw = 0.f;
      if (qp < lq) {
        const float* th = rel_h + (qp / win) * win + kk;  // rhf[:, (q / win) win + kk]
        const float* tw = rel_w + (qp % win) * win + kk;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          const float qv = qs[r * (D + 1) + c];
          sh = fmaf(qv, th[(size_t)c * lk], sh);
          sw = fmaf(qv, tw[(size_t)c * lk], sw);
        }
      }
      rhs[i] = sh;
      rws[i] = sw;
    }
  }

  constexpr int DC = D / 16;
  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < lk;
      ks[r * (D + 1) + c] = ok ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= lk) {
          x = -INFINITY;
        } else {
          if (MODE == RELPOS || MODE == RELWIN) x = x + (rhs[r * kh + kp / kw] + rws[r * kw + kp % kw]);
          if (MODE == RELWIN && (kp / kw >= n_prefix || kp % kw >= n_prefix)) x = x + -1.0e30f;
          if (MODE == CAUSAL && kp > qp) x = MASK_VALUE;
          if (MODE == PREFIX) {
            const bool query_col = kp >= n_prefix;
            if ((qp < n_prefix && query_col) || (qp >= n_prefix && query_col && kp > qp))
              x = MASK_VALUE;
          }
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The 16 lanes sharing these rows are one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile 0 row holds key 0
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)bh * lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) ob[(size_t)qp * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, const void* rel_h,
           const void* rel_w, int bh, int lq, int lk, int n_prefix, int kh, int kw,
           float scale, cudaStream_t stream) {
  const int rel = MODE == RELPOS || MODE == RELWIN ? BQ * (kh + kw) : 0;
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + rel);
  auto kernel = attn_kernel<T, D, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      lq, lk, n_prefix, kh, kw, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_mode(int mode, const void* q, const void* k, const void* v, void* o,
            const void* rel_h, const void* rel_w, int bh, int lq, int lk, int n_prefix,
            int kh, int kw, float scale, cudaStream_t s) {
  switch (mode) {
    case NONE: return launch<T, D, NONE>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
    case CAUSAL: return launch<T, D, CAUSAL>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
    case PREFIX: return launch<T, D, PREFIX>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
    case RELPOS: return launch<T, D, RELPOS>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
    case RELWIN: return launch<T, D, RELWIN>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const void* rel_h,
             const void* rel_w, int bh, int lq, int lk, int d, int mode, int n_prefix,
             int kh, int kw, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  if (mode == RELPOS && (kh <= 0 || kw <= 0 || kh * kw != lk)) return (int)cudaErrorInvalidValue;
  if (mode == RELWIN && (kh <= 0 || kw != kh || kh * kw != lk || lq != lk || n_prefix < 1 || n_prefix > kh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return by_mode<T, 64>(mode, q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
    case 128: return by_mode<T, 128>(mode, q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int attn_f32(const void* q, const void* k, const void* v, void* o,
                        const void* rel_h, const void* rel_w, int bh, int lq, int lk, int d,
                        int mode, int n_prefix, int kh, int kw, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, rel_h, rel_w, bh, lq, lk, d, mode, n_prefix, kh, kw,
                         scale, stream);
}

extern "C" int attn_bf16(const void* q, const void* k, const void* v, void* o,
                         const void* rel_h, const void* rel_w, int bh, int lq, int lk, int d,
                         int mode, int n_prefix, int kh, int kw, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, rel_h, rel_w, bh, lq, lk, d, mode, n_prefix, kh,
                                 kw, scale, stream);
}
