// Fused decode attention with int8 or int4 weights for sm_90a: kernels K
// and O.
//
// Replaces the Pallas TPU kernel deepseek_ocr2_tpu/ops/attn_fused.py:
// _fused_kernel with bits = 8 (K) and bits = 4 (O) (via attn_decode_fused):
// one decode step of
// one layer's attention block on the contiguous layer-stacked cache
// [L, B, Hh, cap, D], for every row at its own position pos[b] (the number
// of cached keys):
//   1. qkv = round_T(xn . wqkv): the fused [3H, H] stream (int8 with one
//      scale per output, or int4 with group-128 scales, each group's dot
//      scaled in f32), rounded to the activation type T as the unfused
//      projection's output is;
//   2. RoPE in f32 on q and k from the cos/sin tables at pos[b];
//   3. an online softmax in f32 over cache[li, b, :, :pos[b]], seeded with
//      the current token from registers (m = q.k_cur * scale, l = 1,
//      acc = v_cur): the current token is attended in f32, before it is
//      rounded into the cache; keys at or past pos[b] are -inf; the output
//      is acc / max(l, 1e-37);
//   4. ctx rounded to T, out = round_T(ctx . wo), wo as wqkv;
//   5. k_new / v_new leave in the cache type; the caller writes them into
//      cache[li, b, :, pos[b]].
// One launch cannot sync the grid between the qkv GEMV, the attention and
// the wo GEMV (on the TPU the grid runs in order on one core), so this is
// three launches: the two projections are linear_q8.cuh's int8 GEMV (kernel
// H's device code) for K or linear_q4.cuh's int4 GEMV (kernel L's) for O,
// and the attention runs one block per (row, head), the same for both. The
// wrapper counts the three as one K or one O.
//
// Attention: D = 128 threads; thread t owns dim t of q, k, v and of the
// output. Keys go in tiles of 64: warp w scores keys w, w + 4, ... of the
// tile (each lane 4 dims of the key row, xor-shuffle sum), the tile's
// weights sit in shared memory, and each thread then accumulates its dim
// over the tile's V rows; the TPU kernel's per-chunk update, with the
// capacity walked in tiles of any length (the TPU kernel needs cap <= 512 or
// a multiple of 512, and head_dim a multiple of 128, for its lane and chunk
// layout; here any capacity works).
//
// What bounds it: bytes. At b = 1, capacity 1024, pos ~ 300: 4.9 MB of wqkv
// + 1.6 MB of wo int8 + 1.5 MB of bf16 K/V, 2.4 us at 3.35 TB/s; in practice
// three launches of a few microseconds each bound it. With int4 weights
// (O), 3.5 MB of codes and scales: 0.002 ms with an f32 cache at pos 300.
//
// Shapes: D = 128; H = Hh * D a multiple of 16 (int8) or 32 (int4); T and
// the cache f32 or bf16.

#include "linear_q4.cuh"
#include "linear_q8.cuh"

#include <math.h>

namespace {

constexpr int D = 128;
constexpr int NT = D;
constexpr int WARPS = NT / 32;
constexpr int TILE = 64;
constexpr unsigned FULL = 0xffffffffu;

template <typename C>
__device__ __forceinline__ void load4(const C* p, float* out);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// qkv [B, 3H] (T); k_cache / v_cache: layer li's [B, Hh, cap, D] view (C);
// pos [B] int32; cos / sin [max_pos, D] f32; ctx [B, H] (T); k_new / v_new
// [B, Hh, D] (C).
template <typename T, typename C>
__global__ void __launch_bounds__(NT) attn_kernel(const T* __restrict__ qkv, const C* __restrict__ k_cache,
                                                  const C* __restrict__ v_cache, const int* __restrict__ pos,
                                                  const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                                                  T* __restrict__ ctx, C* __restrict__ k_new, C* __restrict__ v_new,
                                                  int n_heads, int cap, int max_pos, float scale) {
  __shared__ float qs[D];
  __shared__ float ks[D];
  __shared__ float w[TILE];
  __shared__ float part[WARPS];
  const int b = blockIdx.x, head = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int hidden = n_heads * D;
  // The caller keeps pos below the capacity and the RoPE tables; never read past either.
  const int p = min(max(pos[b], 0), min(cap, max_pos) - 1);
  const T* row = qkv + (size_t)b * 3 * hidden + head * D;
  const float qv = gemv::to_f32(row[t]);
  const float kv = gemv::to_f32(row[hidden + t]);
  const float vv = gemv::to_f32(row[2 * hidden + t]);
  qs[t] = qv;
  ks[t] = kv;
  __syncthreads();
  // RoPE, half-split: rot(x)[t] = -x[t + D/2] below D/2, x[t - D/2] above.
  const int half = D / 2;
  const float sgn = t < half ? -1.f : 1.f;
  const int partner = t < half ? t + half : t - half;
  const float c = cos_t[(size_t)p * D + t], s = sin_t[(size_t)p * D + t];
  const float qr = qv * c + sgn * qs[partner] * s;
  const float kr = kv * c + sgn * ks[partner] * s;
  const size_t no = ((size_t)b * n_heads + head) * D + t;
  k_new[no] = gemv::from_f32<C>(kr);
  v_new[no] = gemv::from_f32<C>(vv);
  __syncthreads();  // every thread has read qs / ks
  qs[t] = qr;
  float d = qr * kr;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
  if (lane == 0) part[warp] = d;
  __syncthreads();
  float m = (part[0] + part[1] + part[2] + part[3]) * scale;  // the current token's score
  float l = 1.f, acc = vv;
  float qf[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) qf[j] = qs[lane * 4 + j];
  __syncthreads();  // part is rewritten below

  const size_t base = ((size_t)b * n_heads + head) * cap * D;
  for (int j0 = 0; j0 < p; j0 += TILE) {
    float mx = -INFINITY;
#pragma unroll 4
    for (int j = warp; j < TILE; j += WARPS) {
      float sj = -INFINITY;
      if (j0 + j < p) {  // warp-uniform
        float kf[4];
        load4<C>(k_cache + base + (size_t)(j0 + j) * D + lane * 4, kf);
        float dot = qf[0] * kf[0];
        dot = fmaf(qf[1], kf[1], dot);
        dot = fmaf(qf[2], kf[2], dot);
        dot = fmaf(qf[3], kf[3], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(FULL, dot, off);
        sj = dot * scale;
      }
      if (lane == 0) w[j] = sj;
      mx = fmaxf(mx, sj);
    }
    if (lane == 0) part[warp] = mx;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) m_new = fmaxf(m_new, part[i]);
    const float alpha = expf(m - m_new);
    if (t < TILE) w[t] = expf(w[t] - m_new);  // masked keys: exp(-inf) = 0
    __syncthreads();
    const int n = min(TILE, p - j0);
    float psum = 0.f, pv = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float pj = w[j];
      psum += pj;
      pv = fmaf(pj, gemv::to_f32(v_cache[base + (size_t)(j0 + j) * D + t]), pv);
    }
    l = alpha * l + psum;
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // w and part are rewritten by the next tile
  }
  ctx[(size_t)b * hidden + head * D + t] = gemv::from_f32<T>(acc / fmaxf(l, 1e-37f));
}

// The projections: int8 (linear_q8.cuh) or int4 (linear_q4.cuh) weights.
inline int gemv(int bits, const void* x, const void* w, const void* ws, void* out, int nb, int in_dim, int out_dim,
                int bf16, cudaStream_t s) {
  if (bits == 4) return q4::gemv_dispatch(x, w, ws, out, nb, in_dim, out_dim, bf16, bf16, s);
  return q8::gemv_dispatch(x, w, ws, out, nb, in_dim, out_dim, bf16, bf16, s);
}

template <typename T, typename C>
int launch(int bits, const void* xn, const void* wqkv, const void* wqkv_s, const void* wo, const void* wo_s,
           const void* k_cache, const void* v_cache, const void* pos, const void* cos_t, const void* sin_t, void* qkv,
           void* ctx, void* out, void* k_new, void* v_new, int nb, int n_heads, int head_dim, int cap, int max_pos,
           float scale, cudaStream_t s) {
  const int hidden = n_heads * head_dim;
  if (nb <= 0 || n_heads <= 0 || head_dim != D || cap <= 0 || max_pos <= 0 || (bits != 4 && bits != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr bool TB = sizeof(T) == 2;
  int err = gemv(bits, xn, wqkv, wqkv_s, qkv, nb, hidden, 3 * hidden, TB, s);
  if (err) return err;
  attn_kernel<T, C><<<dim3(nb, n_heads), NT, 0, s>>>(
      static_cast<const T*>(qkv), static_cast<const C*>(k_cache), static_cast<const C*>(v_cache),
      static_cast<const int*>(pos), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(ctx), static_cast<C*>(k_new), static_cast<C*>(v_new), n_heads, cap, max_pos, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  return gemv(bits, ctx, wo, wo_s, out, nb, hidden, hidden, TB, s);
}

}  // namespace

// bits 8: wqkv int8 [3H, H], wqkv_s f32 [3H]; wo int8 [H, H], wo_s f32 [H].
// bits 4: wqkv uint8 [3H, H_p / 2], wqkv_s f32 [3H, H_p / 128]; wo uint8
// [H, H_p / 2], wo_s f32 [H, H_p / 128] (H_p: H rounded up to 128).
// xn [B, H] (T); k_cache / v_cache: layer li's [B, Hh, cap, D] (C); pos [B]
// int32; cos / sin [max_pos, D] f32; workspaces qkv [B, 3H] and ctx [B, H]
// (T); out [B, H] (T); k_new / v_new [B, Hh, D] (C). x_bf16 / kv_bf16 pick
// bf16 for T / C, else f32.
extern "C" int attn_fused(int bits, const void* xn, const void* wqkv, const void* wqkv_s, const void* wo,
                          const void* wo_s, const void* k_cache, const void* v_cache, const void* pos,
                          const void* cos_t, const void* sin_t, void* qkv, void* ctx, void* out, void* k_new,
                          void* v_new, int nb, int n_heads, int head_dim, int cap, int max_pos, float scale,
                          int x_bf16, int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_LAUNCH(T, C)                                                                                       \
  return launch<T, C>(bits, xn, wqkv, wqkv_s, wo, wo_s, k_cache, v_cache, pos, cos_t, sin_t, qkv, ctx, out, k_new, \
                      v_new, nb, n_heads, head_dim, cap, max_pos, scale, s)
  if (x_bf16 && kv_bf16) ATTN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (x_bf16) ATTN_LAUNCH(__nv_bfloat16, float);
  if (kv_bf16) ATTN_LAUNCH(float, __nv_bfloat16);
  ATTN_LAUNCH(float, float);
#undef ATTN_LAUNCH
}
