// Decode attention for sm_90a: kernels G, P, Q and R over the layer-stacked
// paged pool, X over a per-sequence pool and U over the contiguous cache.
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
//
// Kernel P (paged_decode_q8) replaces deepseek_ocr2_tpu/ops/paged_attention.py:
// _paged_kernel_pool_q8, its one-query form: the same walk over an int8 pool.
// Page p of the head is a [page, D] slab of int8 codes and a [page] row of
// f32 scales (pool[li, bt[row, p], head] and scale[li, bt[row, p], head]);
// key j widens to codes[j, :] * scale[j] in f32 before the dot product, as
// the TPU kernel and the plain twin (dequantize, then attend) do. In tail
// mode (int8tail pools) the row's last page, p == (seq_len - 1) / page, is
// read instead from the row's bf16 open page open[li, row, head], exact; a
// row of seq_len <= page reads only that. Finished rows point at the scratch
// page 0 and read their own slot's open page; their output is discarded.
//
// Same layout as G: one block per (row, head), D = 128 threads. Scores: a
// lane reads 4 codes (a char4, sign-extended) where G reads 4 floats, so a
// warp reads one 128-byte key row. PV: thread t owns output dim t. The page's
// two scale rows sit in shared memory.
//
// What bounds it: bytes. A token of a (row, head) costs 2 * 128 code bytes
// and 2 * 4 scale bytes, 264 bytes against G's 1024 (f32) and 512 (bf16);
// the open page adds 2 * 2 * 128 bytes a token of the last page. The same
// 160 blocks at 16 rows as G: splitting a row's pages across blocks is later
// work.
//
// Kernels Q (paged_chunk_f32 / paged_chunk_bf16) and R (paged_chunk_q8)
// replace deepseek_ocr2_tpu/ops/paged_attention.py: _paged_kernel_pool_chunk
// and _paged_kernel_pool_chunk_q8, the chunk forms of G and P that lookup
// decoding's verification step runs: S queries a row (the row's last token
// and its S - 1 drafts, 2 <= S <= 8 and S <= page, a template parameter),
// q [B, S, Hh, D], each query i with its own causal budget
// seq_lens[row, i] (its position + 1): keys at positions >= the budget are
// -inf for that query. Output [B, S, Hh, D] f32.
//
// Design: one block per (row, head), D = 128 threads, as in G and P. The
// block walks the row's pages while p * page < max_len, max_len the largest
// of the row's budgets (the TPU grid visits every block-table column and
// skips the rest), and on the last page only up to max_len. Each page's K
// and V are read ONCE and all S queries are scored against them: a lane
// holds 4 dims of every query (S x 4 registers), reads 4 elements of a key
// row and reduces S dot products across the warp; the S score rows of the
// page sit in shared memory. S online-softmax states (m, l, acc) in f32 per
// thread, thread t owning output dim t of every query; the output is
// acc / max(l, 1e-37). Every budget is >= 1, so page 0 holds a live key for
// every query and m is finite after it; the update never takes
// exp(-inf - (-inf)) all the same: a query whose keys so far are all
// masked subtracts 0 instead of its -inf maximum.
//
// R reads int8 codes times per-(token, head) f32 scales as P does. In tail
// mode (int8tail pools) the row's open page is its LAST page by the row's
// LARGEST budget, p == (max_len - 1) / page, whatever each query's own
// budget: a chunk that crosses a page boundary has written every token of
// the chunk at (row, position % page) of the open page, and the earlier
// page's tokens that land there sit past max_len. Finished rows point at
// the scratch page 0 and are walked like any row; their output is
// discarded.
//
// What bounds it: bytes, as G and P. At the serving shape (16 rows of
// 260..2048 tokens, 18464 tokens in all, 10 heads, S = 4) Q reads G's bytes
// once, 189 MB of f32 K/V (0.056 ms at 3.35 TB/s; 94 MB in bf16), and does
// 4 x S FLOP per K/V element pair, 0.38 GFLOP: 0.006 ms at 67 TFLOP/s f32,
// still far under the ridge. R reads P's bytes, 48.7 MB (0.0146 ms). The
// shuffles of S reductions a key are the likeliest limit once the loads are
// fast; wgmma/TMA and splitting pages across blocks are later work.
//
// Kernel X (the same paged_decode_f32 / paged_decode_bf16 entry points)
// replaces deepseek_ocr2_tpu/ops/paged_attention.py: _paged_kernel (via
// paged_decode_attention), the per-sequence decode kernel from before the
// pool: one query per row over the row's block-table pages of a pool
// [P, Hh, page, D] with no layer axis. That is exactly the [P, Hh, page, D]
// view G walks, so X is G's device code behind its own wrapper
// (ops/paged_attention.paged_decode_attention); no new device code.
//
// Kernel U (decode_stacked_f32 / decode_stacked_bf16) replaces
// deepseek_ocr2_tpu/ops/paged_attention.py: _stacked_kernel (via
// decode_attention_stacked), decode attention read straight from the
// layer-stacked contiguous cache [L, B, Hh, cap, D] (the decode path of
// DEEPSEEK_DECODE_ATTN=stacked). The wrapper passes the pointer of layer
// li's [B, Hh, cap, D] view, so no layer is copied (the TPU kernel rides
// the layer index through scalar prefetch for the same reason). Row b,
// head h is one contiguous [cap, D] slab of K and one of V.
//
// Same layout as G: one block per (row, head), D = 128 threads; the block
// walks the row's first len = seq_lens[row] keys (pos + 1: the new token's
// K/V are written before attention) in tiles of 128, each tile as one of
// G's pages: warp w scores keys w, w + 4, ... with xor-shuffle dot
// products, the weights of the tile in shared memory, thread t owns output
// dim t, f32 online softmax, out = acc / max(l, 1e-37). A tile holds only
// valid keys (its last one is cut at len), so keys at or past seq_lens are
// never read and never contribute, where the TPU kernel reads whole
// 512-key chunks and masks them to -inf. The 512-key chunk and the
// cap % 512 == 0 assertion were Mosaic tiling rules: any capacity works
// here (bucket_capacity gives caps such as 1280).
//
// What bounds it: bytes. A row at position p reads 2 (p + 1) Hh D elements
// of K/V per layer (1.0 MB of f32 at p = 1000) for 4 FLOP per element
// pair. One row of 10 heads is 10 blocks on 132 SMs: at batch 1 the card
// is mostly idle and the kernel is latency-bound; splitting a row's keys
// across blocks (with a merge pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int D = 128;
constexpr int NT = D;
constexpr int WARPS = NT / 32;
constexpr int MAX_PAGE = 128;
constexpr int MAX_CHUNK = 8;
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

// One page (G, X) or key tile (U) of the f32 online softmax of thread t's
// output dim: the keys j < n_read of a [n_read, D] slab of K and of V at k /
// v, keys j >= n_valid at -inf. Scores: warp w takes keys w, w + 4, ...,
// each lane 4 of the 128 dims, xor-shuffle reductions; the tile's weights
// sit in w [MAX_PAGE], the warps' maxima in wmax. Ends with a barrier, so
// w and wmax may be rewritten by the next tile.
template <typename T>
__device__ __forceinline__ void attend_tile(const T* __restrict__ k, const T* __restrict__ v, int n_read,
                                            int n_valid, const float (&qf)[4], float scale, float* w, float* wmax,
                                            float& m, float& l, float& acc) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  float mx = -INFINITY;
#pragma unroll 4
  for (int j = warp; j < n_read; j += WARPS) {
    float kf[4];
    load4(k + (size_t)j * D + lane * 4, kf);
    float d = qf[0] * kf[0];
    d = fmaf(qf[1], kf[1], d);
    d = fmaf(qf[2], kf[2], d);
    d = fmaf(qf[3], kf[3], d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
    const float s = j < n_valid ? d * scale : -INFINITY;
    if (lane == 0) w[j] = s;
    mx = fmaxf(mx, s);
  }
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  float m_new = m;
#pragma unroll
  for (int i = 0; i < WARPS; ++i) m_new = fmaxf(m_new, wmax[i]);
  const float alpha = expf(m - m_new);  // m = -inf on the first tile: 0
  if (t < n_read) w[t] = expf(w[t] - m_new);  // masked keys: exp(-inf) = 0
  __syncthreads();
  float psum = 0.f, pv = 0.f;
#pragma unroll 8
  for (int j = 0; j < n_read; ++j) {
    const float pj = w[j];
    psum += pj;
    pv = fmaf(pj, to_f32(v[(size_t)j * D + t]), pv);
  }
  l = alpha * l + psum;
  acc = acc * alpha + pv;
  m = m_new;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT) paged_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                                                   const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                                                   const int* __restrict__ seq_lens, float* __restrict__ out,
                                                   int n_heads, int page, int max_pages, float scale) {
  __shared__ float w[MAX_PAGE];
  __shared__ float wmax[WARPS];
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x;
  const size_t qo = ((size_t)row * n_heads + head) * D;
  float qf[4];
  load4(q + qo + t % 32 * 4, qf);  // lane l holds dims 4 l .. 4 l + 3

  const int len = seq_lens[row];
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int p = 0; p < max_pages && p * page < len; ++p) {
    const int pg = block_tables[(size_t)row * max_pages + p];
    const size_t base = ((size_t)pg * n_heads + head) * page * D;
    attend_tile(k_pages + base, v_pages + base, page, len - p * page, qf, scale, w, wmax, m, l, acc);
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

// Kernel U: see the header. k_layer / v_layer [B, Hh, cap, D].
template <typename T>
__global__ void __launch_bounds__(NT) stacked_kernel(const float* __restrict__ q, const T* __restrict__ k_layer,
                                                     const T* __restrict__ v_layer, const int* __restrict__ seq_lens,
                                                     float* __restrict__ out, int n_heads, int cap, float scale) {
  constexpr int TILE = MAX_PAGE;  // keys a tile
  __shared__ float w[TILE];
  __shared__ float wmax[WARPS];
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x;
  const size_t qo = ((size_t)row * n_heads + head) * D;
  const size_t slab = qo * cap;  // ((row * Hh + head) * cap) * D
  float qf[4];
  load4(q + qo + t % 32 * 4, qf);  // lane l holds dims 4 l .. 4 l + 3

  const int len = min(seq_lens[row], cap);
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n = min(TILE, len - t0);  // valid keys of the tile
    const size_t base = slab + (size_t)t0 * D;
    attend_tile(k_layer + base, v_layer + base, n, n, qf, scale, w, wmax, m, l, acc);
  }
  out[qo + t] = acc / fmaxf(l, 1e-37f);
}

template <typename T>
int launch_stacked(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens, void* out,
                   int batch, int n_heads, int head_dim, int cap, float scale, void* stream) {
  if (batch <= 0 || n_heads <= 0 || n_heads > 65535 || head_dim != D || cap <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch, n_heads);
  stacked_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_layer), static_cast<const T*>(v_layer),
      static_cast<const int*>(seq_lens), static_cast<float*>(out), n_heads, cap, scale);
  return (int)cudaGetLastError();
}

template <bool TAIL>
__global__ void __launch_bounds__(NT) paged_q8_kernel(
    const float* __restrict__ q, const signed char* __restrict__ k_pages, const signed char* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ open_k,
    const __nv_bfloat16* __restrict__ open_v, const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    float* __restrict__ out, int n_heads, int page, int max_pages, float scale) {
  __shared__ float w[MAX_PAGE];
  __shared__ float ks[MAX_PAGE];
  __shared__ float vs[MAX_PAGE];
  __shared__ float wmax[WARPS];
  const int row = blockIdx.x, head = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const size_t qo = ((size_t)row * n_heads + head) * D;
  float qf[4];
  load4(q + qo + lane * 4, qf);

  const int len = seq_lens[row];
  const int last = len > 0 ? (len - 1) / page : -1;
  const size_t obase = ((size_t)row * n_heads + head) * page * D;  // the row's open page (tail mode)
  float m = -INFINITY, l = 0.f, acc = 0.f;
  for (int p = 0; p < max_pages && p * page < len; ++p) {
    const int pg = block_tables[(size_t)row * max_pages + p];
    const size_t sbase = ((size_t)pg * n_heads + head) * page;
    const size_t base = sbase * D;
    const bool in_open = TAIL && p == last;
    if (!in_open && t < page) {
      ks[t] = k_scale[sbase + t];
      vs[t] = v_scale[sbase + t];
    }
    __syncthreads();
    float mx = -INFINITY;
#pragma unroll 4
    for (int j = warp; j < page; j += WARPS) {
      float kf[4];
      if (in_open) {
        load4(open_k + obase + (size_t)j * D + lane * 4, kf);
      } else {
        const char4 c = *reinterpret_cast<const char4*>(k_pages + base + (size_t)j * D + lane * 4);
        const float sj = ks[j];
        kf[0] = (float)c.x * sj;
        kf[1] = (float)c.y * sj;
        kf[2] = (float)c.z * sj;
        kf[3] = (float)c.w * sj;
      }
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
    const float alpha = expf(m - m_new);
    if (t < page) w[t] = expf(w[t] - m_new);
    __syncthreads();
    float psum = 0.f, pv = 0.f;
    if (in_open) {
#pragma unroll 8
      for (int j = 0; j < page; ++j) {
        psum += w[j];
        pv = fmaf(w[j], __bfloat162float(open_v[obase + (size_t)j * D + t]), pv);
      }
    } else {
#pragma unroll 8
      for (int j = 0; j < page; ++j) {
        psum += w[j];
        pv = fmaf(w[j], (float)v_pages[base + (size_t)j * D + t] * vs[j], pv);
      }
    }
    l = alpha * l + psum;
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // w, wmax and the scale rows are rewritten by the next page
  }
  out[qo + t] = acc / fmaxf(l, 1e-37f);
}

// One page of kernels Q and R: the S queries against keys [0, kend) of the
// page (absolute positions pos0 + j), then the online-softmax update of the
// S states. load_k(j, kf) gives this lane's 4 dims of key j, load_v(j)
// element t of value j. w / wmax are the block's shared score rows.
template <int S, typename LoadK, typename LoadV>
__device__ __forceinline__ void chunk_page(const float (&qf)[S][4], const int (&budget)[S], int pos0, int kend,
                                           float scale, LoadK load_k, LoadV load_v, float (*w)[MAX_PAGE],
                                           float (*wmax)[S], float (&m)[S], float (&l)[S], float (&acc)[S]) {
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  float mx[S];
#pragma unroll
  for (int i = 0; i < S; ++i) mx[i] = -INFINITY;
  for (int j = warp; j < kend; j += WARPS) {
    float kf[4];
    load_k(j, kf);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float d = qf[i][0] * kf[0];
      d = fmaf(qf[i][1], kf[1], d);
      d = fmaf(qf[i][2], kf[2], d);
      d = fmaf(qf[i][3], kf[3], d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
      const float s = (pos0 + j < budget[i]) ? d * scale : -INFINITY;
      if (lane == 0) w[i][j] = s;
      mx[i] = fmaxf(mx[i], s);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) wmax[warp][i] = mx[i];
  }
  __syncthreads();
  float alpha[S], mu[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float m_new = m[i];
#pragma unroll
    for (int k = 0; k < WARPS; ++k) m_new = fmaxf(m_new, wmax[k][i]);
    mu[i] = m_new == -INFINITY ? 0.f : m_new;  // no -inf - (-inf) below
    alpha[i] = expf(m[i] - mu[i]);             // m = -inf: 0
    m[i] = m_new;
  }
  if (t < kend) {
#pragma unroll
    for (int i = 0; i < S; ++i) w[i][t] = expf(w[i][t] - mu[i]);  // masked keys: 0
  }
  __syncthreads();
  float psum[S], pv[S];
#pragma unroll
  for (int i = 0; i < S; ++i) psum[i] = pv[i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < kend; ++j) {
    const float vj = load_v(j);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      psum[i] += w[i][j];
      pv[i] = fmaf(w[i][j], vj, pv[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < S; ++i) {
    l[i] = alpha[i] * l[i] + psum[i];
    acc[i] = acc[i] * alpha[i] + pv[i];
  }
  __syncthreads();  // w and wmax (and R's scale rows) are rewritten by the next page
}

// The S queries of (row, head), the budgets and their largest; zeroed states.
template <int S>
__device__ __forceinline__ int chunk_setup(const float* __restrict__ q, const int* __restrict__ seq_lens, int n_heads,
                                           float (&qf)[S][4], int (&budget)[S], float (&m)[S], float (&l)[S],
                                           float (&acc)[S]) {
  const int row = blockIdx.x, head = blockIdx.y, lane = threadIdx.x % 32;
  int max_len = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    load4(q + (((size_t)row * S + i) * n_heads + head) * D + lane * 4, qf[i]);
    budget[i] = seq_lens[(size_t)row * S + i];
    max_len = max(max_len, budget[i]);
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i] = 0.f;
  }
  return max_len;
}

template <int S>
__device__ __forceinline__ void chunk_store(float* __restrict__ out, int n_heads, const float (&acc)[S],
                                            const float (&l)[S]) {
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S; ++i) out[(((size_t)row * S + i) * n_heads + head) * D + t] = acc[i] / fmaxf(l[i], 1e-37f);
}

template <typename T, int S>
__global__ void __launch_bounds__(NT) paged_chunk_kernel(const float* __restrict__ q, const T* __restrict__ k_pages,
                                                         const T* __restrict__ v_pages,
                                                         const int* __restrict__ block_tables,
                                                         const int* __restrict__ seq_lens, float* __restrict__ out,
                                                         int n_heads, int page, int max_pages, float scale) {
  __shared__ float w[S][MAX_PAGE];
  __shared__ float wmax[WARPS][S];
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x, lane = t % 32;
  float qf[S][4], m[S], l[S], acc[S];
  int budget[S];
  const int max_len = chunk_setup<S>(q, seq_lens, n_heads, qf, budget, m, l, acc);
  for (int p = 0; p < max_pages && p * page < max_len; ++p) {
    const int pg = block_tables[(size_t)row * max_pages + p];
    const size_t base = ((size_t)pg * n_heads + head) * page * D;
    chunk_page<S>(
        qf, budget, p * page, min(page, max_len - p * page), scale,
        [&](int j, float* kf) { load4(k_pages + base + (size_t)j * D + lane * 4, kf); },
        [&](int j) { return to_f32(v_pages[base + (size_t)j * D + t]); }, w, wmax, m, l, acc);
  }
  chunk_store<S>(out, n_heads, acc, l);
}

template <bool TAIL, int S>
__global__ void __launch_bounds__(NT) paged_chunk_q8_kernel(
    const float* __restrict__ q, const signed char* __restrict__ k_pages, const signed char* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ open_k,
    const __nv_bfloat16* __restrict__ open_v, const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    float* __restrict__ out, int n_heads, int page, int max_pages, float scale) {
  __shared__ float w[S][MAX_PAGE];
  __shared__ float wmax[WARPS][S];
  __shared__ float ks[MAX_PAGE];
  __shared__ float vs[MAX_PAGE];
  const int row = blockIdx.x, head = blockIdx.y, t = threadIdx.x, lane = t % 32;
  float qf[S][4], m[S], l[S], acc[S];
  int budget[S];
  const int max_len = chunk_setup<S>(q, seq_lens, n_heads, qf, budget, m, l, acc);
  const int last = (max_len - 1) / page;  // the open page: by the row's LARGEST budget
  const size_t obase = ((size_t)row * n_heads + head) * page * D;
  for (int p = 0; p < max_pages && p * page < max_len; ++p) {
    const int pg = block_tables[(size_t)row * max_pages + p];
    const size_t sbase = ((size_t)pg * n_heads + head) * page;
    const size_t base = sbase * D;
    const int kend = min(page, max_len - p * page);
    if (TAIL && p == last) {
      chunk_page<S>(
          qf, budget, p * page, kend, scale,
          [&](int j, float* kf) { load4(open_k + obase + (size_t)j * D + lane * 4, kf); },
          [&](int j) { return __bfloat162float(open_v[obase + (size_t)j * D + t]); }, w, wmax, m, l, acc);
      continue;
    }
    if (t < kend) {
      ks[t] = k_scale[sbase + t];
      vs[t] = v_scale[sbase + t];
    }
    __syncthreads();
    chunk_page<S>(
        qf, budget, p * page, kend, scale,
        [&](int j, float* kf) {
          const char4 c = *reinterpret_cast<const char4*>(k_pages + base + (size_t)j * D + lane * 4);
          const float sj = ks[j];
          kf[0] = (float)c.x * sj;
          kf[1] = (float)c.y * sj;
          kf[2] = (float)c.z * sj;
          kf[3] = (float)c.w * sj;
        },
        [&](int j) { return (float)v_pages[base + (size_t)j * D + t] * vs[j]; }, w, wmax, m, l, acc);
  }
  chunk_store<S>(out, n_heads, acc, l);
}

// f(std::integral_constant<int, S>) for the runtime S; false if unsupported.
template <typename F>
bool with_chunk(int n_queries, F&& f) {
  switch (n_queries) {
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 3: f(std::integral_constant<int, 3>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 5: f(std::integral_constant<int, 5>{}); return true;
    case 6: f(std::integral_constant<int, 6>{}); return true;
    case 7: f(std::integral_constant<int, 7>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    default: return false;
  }
}

bool chunk_shape_ok(int batch, int n_queries, int n_heads, int head_dim, int page, int max_pages) {
  return batch > 0 && n_heads > 0 && head_dim == D && page > 0 && page <= MAX_PAGE && max_pages > 0 &&
         n_queries >= 2 && n_queries <= MAX_CHUNK && n_queries <= page;
}

template <typename T>
int launch_chunk(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                 const void* seq_lens, void* out, int batch, int n_queries, int n_heads, int head_dim, int page,
                 int max_pages, float scale, void* stream) {
  if (!chunk_shape_ok(batch, n_queries, n_heads, head_dim, page, max_pages)) return (int)cudaErrorInvalidValue;
  const dim3 grid(batch, n_heads);
  with_chunk(n_queries, [&](auto s) {
    paged_chunk_kernel<T, decltype(s)::value><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
        static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens), static_cast<float*>(out), n_heads,
        page, max_pages, scale);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel Q. q [B, S, Hh, D] f32; k_pages / v_pages: one layer of the pool,
// [P, Hh, page, D] f32 or bf16; block_tables [B, max_pages] int32; seq_lens
// [B, S] int32 (per-query budgets); out [B, S, Hh, D] f32.
extern "C" int paged_chunk_f32(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                               const void* seq_lens, void* out, int batch, int n_queries, int n_heads, int head_dim,
                               int page, int max_pages, float scale, void* stream) {
  return launch_chunk<float>(q, k_pages, v_pages, block_tables, seq_lens, out, batch, n_queries, n_heads, head_dim,
                             page, max_pages, scale, stream);
}

extern "C" int paged_chunk_bf16(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                                const void* seq_lens, void* out, int batch, int n_queries, int n_heads, int head_dim,
                                int page, int max_pages, float scale, void* stream) {
  return launch_chunk<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, out, batch, n_queries, n_heads,
                                     head_dim, page, max_pages, scale, stream);
}

// Kernel R. As kernel Q over one layer of an int8 pool: k_pages / v_pages
// [P, Hh, page, D] int8, k_scale / v_scale [P, Hh, page] f32, and when tail
// is non-zero the layer's open pages open_k / open_v [B, Hh, page, D] bf16.
extern "C" int paged_chunk_q8(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
                              const void* v_scale, const void* open_k, const void* open_v, const void* block_tables,
                              const void* seq_lens, void* out, int batch, int n_queries, int n_heads, int head_dim,
                              int page, int max_pages, int tail, float scale, void* stream) {
  if (!chunk_shape_ok(batch, n_queries, n_heads, head_dim, page, max_pages) ||
      (tail && (open_k == nullptr || open_v == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch, n_heads);
  with_chunk(n_queries, [&](auto s) {
    constexpr int S = decltype(s)::value;
    const auto kernel = tail ? paged_chunk_q8_kernel<true, S> : paged_chunk_q8_kernel<false, S>;
    kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const signed char*>(k_pages),
        static_cast<const signed char*>(v_pages), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const __nv_bfloat16*>(open_k),
        static_cast<const __nv_bfloat16*>(open_v), static_cast<const int*>(block_tables),
        static_cast<const int*>(seq_lens), static_cast<float*>(out), n_heads, page, max_pages, scale);
  });
  return (int)cudaGetLastError();
}

// Kernel P. q [B, Hh, D] f32; k_pages / v_pages: one layer of the int8 pool,
// [P, Hh, page, D]; k_scale / v_scale: that layer's [P, Hh, page] f32;
// open_k / open_v: that layer's open pages [B, Hh, page, D] bf16 when tail is
// non-zero (ignored otherwise); block_tables [B, max_pages] int32; seq_lens
// [B] int32; out [B, Hh, D] f32.
extern "C" int paged_decode_q8(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* open_k, const void* open_v, const void* block_tables,
                               const void* seq_lens, void* out, int batch, int n_heads, int head_dim, int page,
                               int max_pages, int tail, float scale, void* stream) {
  if (batch <= 0 || n_heads <= 0 || head_dim != D || page <= 0 || page > MAX_PAGE || max_pages <= 0 ||
      (tail && (open_k == nullptr || open_v == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(batch, n_heads);
  const auto kernel = tail ? paged_q8_kernel<true> : paged_q8_kernel<false>;
  kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const signed char*>(k_pages), static_cast<const signed char*>(v_pages),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(open_k), static_cast<const __nv_bfloat16*>(open_v),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens), static_cast<float*>(out), n_heads,
      page, max_pages, scale);
  return (int)cudaGetLastError();
}

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

// Kernel U. q [B, Hh, D] f32; k_layer / v_layer: layer li of the stacked
// cache, [B, Hh, cap, D] f32 or bf16; seq_lens [B] int32 (pos + 1, at most
// cap); out [B, Hh, D] f32.
extern "C" int decode_stacked_f32(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens,
                                  void* out, int batch, int n_heads, int head_dim, int cap, float scale,
                                  void* stream) {
  return launch_stacked<float>(q, k_layer, v_layer, seq_lens, out, batch, n_heads, head_dim, cap, scale, stream);
}

extern "C" int decode_stacked_bf16(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens,
                                   void* out, int batch, int n_heads, int head_dim, int cap, float scale,
                                   void* stream) {
  return launch_stacked<__nv_bfloat16>(q, k_layer, v_layer, seq_lens, out, batch, n_heads, head_dim, cap, scale,
                                       stream);
}
