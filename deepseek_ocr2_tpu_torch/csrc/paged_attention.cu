// Paged decode attention over the layer-stacked pool for sm_90a: kernel G.
//
// Replaces the Pallas TPU kernel deepseek_ocr2_tpu/ops/paged_attention.py:
// _paged_kernel_pool (via paged_decode_attention_pool): one query per row
// (a decode step) against that row's K/V pages, which the block table
// lists in order. The pool is [L, P, Hh, page, D]; the wrapper passes the
// pointer of layer li's [P, Hh, page, D] view (a view, never a copy: the
// TPU kernel rides the layer index through scalar prefetch only because
// XLA would copy a scan-sliced operand).
//
// One block per (row, head), D = 128 threads. The block walks the row's
// pages while p * page < seq_len; page p of the head, pool[li, bt[row, p],
// head], is a contiguous [page, D] slab of K and one of V. Per page, as the
// TPU kernel does per grid step:
//   s_j   = (q . k_j) * scale, -inf for key positions >= seq_len
//   m_new = max(m, max_j s_j);  alpha = exp(m - m_new)
//   p_j   = exp(s_j - m_new);   l = alpha * l + sum_j p_j
//   acc   = alpha * acc + sum_j p_j v_j
// and the output is acc / max(l, 1e-37), all in f32 (paged_attention.py
// :192-206). Rows that point at the scratch page 0 (finished slots) read it
// like any other page; their output is discarded by the caller.
//
// Scores: warp w takes keys w, w + 4, ...; each lane holds 4 of the 128
// dims of q and reads 4 consecutive elements of the key row, so a warp
// reads one 512-byte (f32) or 256-byte (bf16) row per key, then reduces
// across lanes with xor shuffles. PV: thread t owns output dim t and walks
// the page's keys, so a warp reads a contiguous 128-byte slice of each V
// row. The scores and weights of a page live in shared memory.
//
// What bounds it: bytes. A row of 2048 tokens reads 2 MB of f32 K/V per
// layer (1 MB in bf16) and does 4 FLOP per element read: far under the
// card's ridge point. At B = 16 rows x 10 heads = 160 blocks, about one per
// SM; a block's loads of a page are independent and unrolled. Splitting a
// row's pages across blocks (a second pass to merge the partial softmaxes)
// would fill the card at small B and is later work.
//
// Shapes: D = 128 (the LM's head dim), page <= 128, f32 or bf16 pool, q
// f32 (checked by the wrapper).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 128;
constexpr int NT = D;
constexpr int WARPS = NT / 32;
constexpr int MAX_PAGE = 128;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT) paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                                                   const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                                                   const int* __restrict__ seq_lens, float* __restrict__ out,
                                                   int n_heads, int page, int max_pages, float scale) {
  __shared__ float w[MAX_PAGE];
  __shared__ float wmax[WARPS];
  const int row = blockIdx.x, head = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const size_t qo = ((size_t)row * n_heads + head) * D;
  float qf[4];
  load4(q + qo + lane * 4, qf);

  const int len = seq_lens[row];
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int p = 0; p < max_pages && p * page < len; ++p) {
    const int pg = block_tables[(size_t)row * max_pages + p];
    const size_t base = ((size_t)pg * n_heads + head) * page * D;
    float mx = -INFINITY;
#pragma unroll 4
    for (int j = warp; j < page; j += WARPS) {
      float kf[4];
      load4(k_pages + base + (size_t)j * D + lane * 4, kf);
      float d = qf[0] * kf[0];
      d = fmaf(qf[1], kf[1], d);
      d = fmaf(qf[2], kf[2], d);
      d = fmaf(qf[3], kf[3], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
      const float s = (p * page + j < len) ? d * scale : -INFINITY;
      if (lane == 0) w[j] = s;
      mx = fmaxf(mx, s);
    }
    if (lane == 0) wmax[warp] = mx;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) m_new = fmaxf(m_new, wmax[i]);
    const float alpha = expf(m - m_new);  // m = -inf on the first page: 0
    if (t < page) w[t] = expf(w[t] - m_new);  // masked keys: exp(-inf) = 0
    __syncthreads();
    float psum = 0.f, pv = 0.f;
#pragma unroll 8
    for (int j = 0; j < page; ++j) {
      const float pj = w[j];
      psum += pj;
      pv = fmaf(pj, to_f32(v_pages[base + (size_t)j * D + t]), pv);
    }
    l = alpha * l + psum;
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // w and wmax are rewritten by the next page
  }
  out[qo + t] = acc / fmaxf(l, 1e-37f);
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
           const void* seq_lens, void* out, int batch, int n_heads, int head_dim, int page, int max_pages,
           float scale, void* stream) {
  if (batch <= 0 || n_heads <= 0 || head_dim != D || page <= 0 || page > MAX_PAGE || max_pages <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch, n_heads);
  paged_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens), static_cast<float*>(out), n_heads,
      page, max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hh, D] f32; k_pages / v_pages: one layer of the pool, [P, Hh, page,
// D]; block_tables [B, max_pages] int32; seq_lens [B] int32; out [B, Hh, D] f32.
extern "C" int paged_decode_f32(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                                const void* seq_lens, void* out, int batch, int n_heads, int head_dim, int page,
                                int max_pages, float scale, void* stream) {
  return launch<float>(q, k_pages, v_pages, block_tables, seq_lens, out, batch, n_heads, head_dim, page,
                       max_pages, scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                                 const void* seq_lens, void* out, int batch, int n_heads, int head_dim, int page,
                                 int max_pages, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, out, batch, n_heads, head_dim, page,
                               max_pages, scale, stream);
}
