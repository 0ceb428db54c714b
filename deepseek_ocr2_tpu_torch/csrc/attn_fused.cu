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
// and the attention is one launch of a split-key walk, the same for both.
// The wrapper counts the three as one K or one O.
//
// The attention (attn_split_kernel) is kernel U's walk in kernel G's one
// launch (split_walk.cuh; paged_attention.cu's header gives the design) on
// the contiguous [cap, D] slabs of a (row, head):
// - blocks (chunk, head, row) over 64-key chunks of the row's pos[b] cached
//   keys: two warps of 32 keys, each its own online softmax in f32, merged
//   in the block into a partial (acc[D], m, l) in a workspace [B, Hh,
//   ceil(cap / 64), D + 4] f32 (torch.empty: a CUDA graph captures it); a
//   chunk at or past pos exits at once, but chunk 0 always runs, so that a
//   row at pos 0 (no cached key) has its merging block;
// - every block rotates its own q (RoPE at pos[b], in f32, from the qkv
//   row: thread t owns dims t and t + 64, each the other's partner);
// - the last block of a (row, head) to arrive (an arrival counter a (row,
//   head), shared with kernels G, X, P, Q and R and set back to zero by the
//   merging block, ready for the next launch or a graph's replay) merges:
//   the current token's seed first (m = q . k_cur * scale, l = 1, acc =
//   v_cur: attended once, in f32, before it is rounded into the cache),
//   then the chunks' partials in ascending order (merge_partials), out =
//   acc / max(l, 1e-37); it also writes k_new and v_new, once. The order
//   depends on pos[b] alone, so a row's bits do not depend on the other
//   rows; a warp with no live key adds exact zeros. The TPU kernel walks
//   the capacity in 512-key chunks (it needs cap <= 512 or a multiple of
//   512, and head_dim a multiple of 128); here any capacity works.
// Its first form ran one block of 128 threads per (row, head) (10 blocks
// at batch 1 on 132 SMs) walking every cached key in 64-key tiles, three
// block barriers a tile: 0.049 ms (K) and 0.050 ms (O) in a CUDA graph at
// batch 1, pos 300, f32 cache, on an H100 (PERF.md).
//
// What bounds it: bytes. At b = 1, capacity 1024, pos 300: 4.9 MB of wqkv
// + 1.6 MB of wo int8 + 3.1 MB of f32 K/V, 2.9 us at 3.35 TB/s (K); with
// int4 weights (O), 3.5 MB of codes and scales, 2.0 us. At these sizes the
// three launches' latencies weigh as much as the bytes: on an H100 a K call
// there spans 12.5 us in a CUDA graph, the attention 6.6 of it (40.5 in the
// first form) and the two GEMVs 3.0 and 2.7 (PERF.md); at 16 rows of pos 0
// .. 1023 the attention reads 84 MB of f32 K/V in 35 us.
//
// Shapes: D = 128; H = Hh * D a multiple of 16 (int8) or 32 (int4); T and
// the cache f32 or bf16.

#include "linear_q4.cuh"
#include "linear_q8.cuh"
#include "split_walk.cuh"

namespace {

using namespace split_walk;

// Block (chunk, head, row): keys [64 chunk, 64 chunk + 64) of the row's
// pos[b] cached keys of that head (layer li's [B, Hh, cap, D] view of the
// cache, C), as chunk_partial's two warps, into part [B, Hh, n_chunks,
// U_PART]; chunk 0 runs even with no cached key (an empty partial), the
// other chunks at or past pos exit at once. Every block rotates its own q
// from qkv [B, 3H] (T): thread t owns dims t and t + 64, each the other's
// RoPE partner. The last block of the (row, head) to arrive (counters [B
// * Hh], zero between launches) merges: the current token's seed first,
// then the chunks' partials in ascending order; it writes ctx [B, H] (T),
// k_new / v_new [B, Hh, D] (C) and sets the counter back to zero.
template <typename T, typename C>
__global__ void __launch_bounds__(U_WARPS * 32) attn_split_kernel(
    const T* __restrict__ qkv, const C* __restrict__ k_cache, const C* __restrict__ v_cache,
    const int* __restrict__ pos, const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    float* __restrict__ part, int* __restrict__ counters, T* __restrict__ ctx, C* __restrict__ k_new,
    C* __restrict__ v_new, int n_heads, int cap, int max_pos, int n_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float qr[D];
  __shared__ __align__(16) float kr[D];
  __shared__ float dots[U_WARPS];
  __shared__ int merger;
  constexpr int HALF = D / 2;
  const int chunk = blockIdx.x, head = blockIdx.y, row = blockIdx.z;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // The caller keeps pos below the capacity and the RoPE tables; never read past either.
  const int p = min(max(pos[row], 0), min(cap, max_pos) - 1);
  const int c0 = chunk * U_CHUNK;
  if (chunk > 0 && c0 >= p) return;  // the whole block: no key of its chunk is cached
  const int hidden = n_heads * D;
  const T* src = qkv + (size_t)row * 3 * hidden + head * D;
  const float* cs = cos_t + (size_t)p * D;
  const float* sn = sin_t + (size_t)p * D;
  // RoPE, half-split: rot(x)[t] = -x[t + D/2] below D/2, x[t - D/2] above.
  {
    const float q0 = gemv::to_f32(src[t]), q1 = gemv::to_f32(src[t + HALF]);
    qr[t] = q0 * cs[t] - q1 * sn[t];
    qr[t + HALF] = q1 * cs[t + HALF] + q0 * sn[t + HALF];
  }
  __syncthreads();
  const size_t rh = (size_t)row * n_heads + head;
  const size_t base = (rh * cap + c0) * D;
  const int n = max(0, min(U_CHUNK, p - c0));
  const int nq[1] = {n};
  float* prh = part + rh * n_chunks * U_PART;
  chunk_partial<C, 1>(qr, D, k_cache + base, v_cache + base, nullptr, nullptr, n, nq, scale,
                      prh + (size_t)chunk * U_PART, smem_raw);

  // Arrival, as paged_split_kernel's: the partial is written and made
  // visible before the count; the block that brings it to the number of
  // live chunks merges. Which block that is changes nothing in the bits.
  const int n_live = max(1, (p + U_CHUNK - 1) / U_CHUNK);
  __threadfence();
  __syncthreads();
  if (t == 0) merger = atomicAdd(counters + rh, 1) == n_live - 1;
  __syncthreads();
  if (!merger) return;
  __threadfence();
  // The current token: k rotated as q, v as it is; both leave in the cache
  // type, and seed the merge in f32 (m = q . k scale, l = 1, acc = v).
  const float k0 = gemv::to_f32(src[hidden + t]), k1 = gemv::to_f32(src[hidden + t + HALF]);
  kr[t] = k0 * cs[t] - k1 * sn[t];
  kr[t + HALF] = k1 * cs[t + HALF] + k0 * sn[t + HALF];
  const size_t no = rh * D;
  k_new[no + t] = gemv::from_f32<C>(kr[t]);
  k_new[no + t + HALF] = gemv::from_f32<C>(kr[t + HALF]);
  v_new[no + t] = gemv::from_f32<C>(gemv::to_f32(src[2 * hidden + t]));
  v_new[no + t + HALF] = gemv::from_f32<C>(gemv::to_f32(src[2 * hidden + t + HALF]));
  float d = qr[t] * kr[t] + qr[t + HALF] * kr[t + HALF];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
  if (lane == 0) dots[warp] = d;
  __syncthreads();
  if (t >= D / 4) return;
  const float m0 = (dots[0] + dots[1]) * scale;
  const T* vs = src + 2 * hidden + 4 * t;
  const float4 v0 = make_float4(gemv::to_f32(vs[0]), gemv::to_f32(vs[1]), gemv::to_f32(vs[2]), gemv::to_f32(vs[3]));
  const float4 o = merge_partials(prh, n_live, U_PART, t, m0, v0);
  T* out = ctx + (size_t)row * hidden + head * D + 4 * t;
  out[0] = gemv::from_f32<T>(o.x);
  out[1] = gemv::from_f32<T>(o.y);
  out[2] = gemv::from_f32<T>(o.z);
  out[3] = gemv::from_f32<T>(o.w);
  if (t == 0) counters[rh] = 0;  // ready for the next launch (and a graph's next replay)
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
           void* ctx, void* part, void* counters, void* out, void* k_new, void* v_new, int nb, int n_heads,
           int head_dim, int cap, int max_pos, float scale, cudaStream_t s) {
  const int hidden = n_heads * head_dim;
  if (nb <= 0 || nb > 65535 || n_heads <= 0 || n_heads > 65535 || head_dim != D || cap <= 0 || max_pos <= 0 ||
      (bits != 4 && bits != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr bool TB = sizeof(T) == 2;
  int err = gemv(bits, xn, wqkv, wqkv_s, qkv, nb, hidden, 3 * hidden, TB, s);
  if (err) return err;
  const int n_chunks = (cap + U_CHUNK - 1) / U_CHUNK;
  const auto kernel = attn_split_kernel<T, C>;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, UTile<C, 1>::SMEM);
  if (err) return err;
  kernel<<<dim3(n_chunks, n_heads, nb), U_WARPS * 32, UTile<C, 1>::SMEM, s>>>(
      static_cast<const T*>(qkv), static_cast<const C*>(k_cache), static_cast<const C*>(v_cache),
      static_cast<const int*>(pos), static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<float*>(part), static_cast<int*>(counters), static_cast<T*>(ctx), static_cast<C*>(k_new),
      static_cast<C*>(v_new), n_heads, cap, max_pos, n_chunks, scale);
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
// (T) and part [B, Hh, ceil(cap / 64), D + 4] f32; counters [B * Hh]
// int32, zero before the call and left zero after it; out [B, H] (T);
// k_new / v_new [B, Hh, D] (C). x_bf16 / kv_bf16 pick bf16 for T / C, else
// f32.
extern "C" int attn_fused(int bits, const void* xn, const void* wqkv, const void* wqkv_s, const void* wo,
                          const void* wo_s, const void* k_cache, const void* v_cache, const void* pos,
                          const void* cos_t, const void* sin_t, void* qkv, void* ctx, void* part, void* counters,
                          void* out, void* k_new, void* v_new, int nb, int n_heads, int head_dim, int cap,
                          int max_pos, float scale, int x_bf16, int kv_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ATTN_LAUNCH(T, C)                                                                                    \
  return launch<T, C>(bits, xn, wqkv, wqkv_s, wo, wo_s, k_cache, v_cache, pos, cos_t, sin_t, qkv, ctx, part, \
                      counters, out, k_new, v_new, nb, n_heads, head_dim, cap, max_pos, scale, s)
  if (x_bf16 && kv_bf16) ATTN_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (x_bf16) ATTN_LAUNCH(__nv_bfloat16, float);
  if (kv_bf16) ATTN_LAUNCH(float, __nv_bfloat16);
  ATTN_LAUNCH(float, float);
#undef ATTN_LAUNCH
}
