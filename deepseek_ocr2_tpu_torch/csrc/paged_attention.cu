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
// What bounds it: bytes. A row at position p reads 2 (p + 1) Hh D elements
// of K/V per layer (1.0 MB of f32 at p = 1000) for 4 FLOP per element
// pair. One block per (row, head) walking every key would run 10 blocks a
// row on 132 SMs and keep too few bytes in flight, so U is a split-key
// decode:
// - Each (row, head)'s keys are cut into chunks of U_CHUNK = 64 across
//   blocks: grid (ceil(cap / 64), Hh, B), 64 threads. A block whose chunk
//   starts at or past len = seq_lens[row] (pos + 1: the new token's K/V
//   are written before attention) exits at once, and within a chunk only
//   live keys are copied: keys at or past len are never read, where the
//   TPU kernel reads whole 512-key chunks and masks them to -inf. The
//   512-key chunk and the cap % 512 == 0 assertion were Mosaic tiling
//   rules: any capacity works here (bucket_capacity gives caps such as
//   1280).
// - Each of a block's two warps takes 32 keys, one a lane, with its own
//   online softmax and no block barrier: it copies its live K rows, then
//   its V rows, into shared memory by cp.async (two groups, all in flight
//   at once: 16 KB of bf16 or 32 KB of f32 a warp); lane j scores key j
//   against the whole q (a copy a warp in shared memory; K rows padded so
//   that 8 lanes' 16-byte loads hit 32 banks); the warp's max and sum come
//   by xor shuffles (the same sum on every lane); each lane then owns 4
//   output dims of P V, the weights passed by shuffle.
// - At the end warp 1's (m, l, acc) goes through shared memory, warp 0
//   merges it (a warp with no live key has m = -inf and adds exact zeros)
//   and writes the chunk's partial (acc[D], m, l) to a workspace [B, Hh,
//   ceil(cap / 64), D + 4] f32 that the wrapper allocates (torch.empty:
//   no host sync, and a CUDA graph captures it).
// - A second launch, one block of D threads per (row, head), merges the
//   row's ceil(len / 64) partials in ascending chunk order
//   (merge_partials): out = sum acc_c e^(m_c - m) / max(sum l_c e^(m_c -
//   m), 1e-37), m = max m_c, as the one-block walk divided by max(l,
//   1e-37). The order depends on len and the chunk size alone, never on B
//   or cap, so a row's output is bit-identical from run to run and
//   whatever the other rows hold. merge_partials is written for any set of
//   partials: the paged kernels can split their pages the same way.
// At 16 rows of 260..1000 tokens, 10 heads, that is about 1600 live blocks
// of 64 keys (32 KB of bf16 K/V each); at one row at position 300, 50.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// One page (G, X) of the f32 online softmax of thread t's output dim: the
// keys j < n_read of a [n_read, D] slab of K and of V at k / v, keys j >=
// n_valid at -inf. Scores: warp w takes keys w, w + 4, ...,
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

// Kernel U: see the header. k_layer / v_layer [B, Hh, cap, D]; part
// [B, Hh, n_chunks, U_PART] f32, the chunks' partials.
constexpr int U_WARP_KEYS = 32;                     // keys a warp: one a lane
constexpr int U_WARPS = 2;
constexpr int U_CHUNK = U_WARPS * U_WARP_KEYS;      // keys a block: one chunk of a row's keys
constexpr int U_PART = D + 4;                       // a partial: acc[D], m, l (16-byte rows)

template <typename T>
struct UTile {
  static constexpr int CE = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  static constexpr int KS = D + CE;  // K row stride: a lane reads its own row, 8 lanes' 16-byte loads on 32 banks
  static constexpr int WARP_BYTES = (int)sizeof(T) * U_WARP_KEYS * (KS + D);  // a warp's K and V rows
  static constexpr int Q_OFF = U_WARPS * WARP_BYTES;                          // a copy of q a warp
  static constexpr int X_OFF = Q_OFF + U_WARPS * D * 4;                       // warp 1's state for the merge
  static constexpr int SMEM = X_OFF + U_PART * 4;
};

// Eight neighbouring elements of a 16-byte aligned row as f32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  load4(p, out);
  load4(p + 4, out + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The fixed-order merge of n partials (acc[D], m, l at stride floats apart)
// of one (row, head): out[t] = sum_c acc_c[t] e^(m_c - m) / max(sum_c l_c
// e^(m_c - m), 1e-37), m = max_c m_c, summed in ascending c. A partial that
// saw no key (m_c = -inf) adds exact zeros. The order depends on n alone,
// so an output is bit-identical from run to run and whatever the other
// rows hold. Thread t returns output dim t.
__device__ __forceinline__ float merge_partials(const float* __restrict__ part, int n, int stride, int t) {
  float m = -INFINITY;
  for (int c = 0; c < n; ++c) m = fmaxf(m, part[(size_t)c * stride + D]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < n; ++c) {
    const float* pc = part + (size_t)c * stride;
    const float mc = pc[D];
    const float w = mc == -INFINITY ? 0.f : expf(mc - m);
    l = fmaf(pc[D + 1], w, l);
    acc = fmaf(pc[t], w, acc);
  }
  return acc / fmaxf(l, 1e-37f);
}

// One chunk of U_CHUNK keys of one (row, head): block (chunk, head, row),
// U_WARPS warps of U_WARP_KEYS keys, each its own online softmax with no
// block barrier until the in-block merge. A block whose chunk starts at or
// past len exits at once; keys at or past len are never read.
template <typename T>
__global__ void __launch_bounds__(U_WARPS * 32) stacked_chunk_kernel(
    const float* __restrict__ q, const T* __restrict__ k_layer, const T* __restrict__ v_layer,
    const int* __restrict__ seq_lens, float* __restrict__ part, int n_heads, int cap, int n_chunks, float scale) {
  using Tile = UTile<T>;
  constexpr int KS = Tile::KS, CE = Tile::CE, CH = D / CE;  // CH: 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk = blockIdx.x, head = blockIdx.y, row = blockIdx.z;
  const int len = min(seq_lens[row], cap);
  const int c0 = chunk * U_CHUNK;
  if (c0 >= len) return;  // the whole block: no key of its chunk is live
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* ks = reinterpret_cast<T*>(smem_raw + warp * Tile::WARP_BYTES);  // [U_WARP_KEYS][KS]
  T* vs = ks + U_WARP_KEYS * KS;                                      // [U_WARP_KEYS][D]
  float* qs = reinterpret_cast<float*>(smem_raw + Tile::Q_OFF) + warp * D;
  const size_t qo = ((size_t)row * n_heads + head) * D;
  const int k0 = c0 + warp * U_WARP_KEYS;                // the warp's first key
  const int nk = max(0, min(U_WARP_KEYS, len - k0));    // its live keys (warp-uniform)

  float m = -INFINITY, l = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};  // lane: output dims 4 lane .. 4 lane + 3
  if (nk > 0) {
    // The warp's live K rows, then its V rows, in two cp.async groups.
    const size_t base = qo * cap + (size_t)k0 * D;  // ((row Hh + head) cap + k0) D
    for (int i = lane; i < nk * CH; i += 32) {
      const int r = i / CH, c = CE * (i % CH);
      cp_async16(ks + r * KS + c, k_layer + base + (size_t)r * D + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = lane; i < nk * CH; i += 32) {
      const int r = i / CH, c = CE * (i % CH);
      cp_async16(vs + r * D + c, v_layer + base + (size_t)r * D + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    *reinterpret_cast<float4*>(qs + 4 * lane) = *reinterpret_cast<const float4*>(q + qo + 4 * lane);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();

    // Lane j scores key k0 + j against the whole q (four partial sums).
    float s = -INFINITY;
    if (lane < nk) {
      const T* kr = ks + lane * KS;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int i = 0; i < D; i += 8) {
        float kf[8];
        load8(kr + i, kf);
        const float4 qa = *reinterpret_cast<const float4*>(qs + i), qb = *reinterpret_cast<const float4*>(qs + i + 4);
        d[0] = fmaf(qa.x, kf[0], d[0]);
        d[1] = fmaf(qa.y, kf[1], d[1]);
        d[2] = fmaf(qa.z, kf[2], d[2]);
        d[3] = fmaf(qa.w, kf[3], d[3]);
        d[0] = fmaf(qb.x, kf[4], d[0]);
        d[1] = fmaf(qb.y, kf[5], d[1]);
        d[2] = fmaf(qb.z, kf[6], d[2]);
        d[3] = fmaf(qb.w, kf[7], d[3]);
      }
      s = ((d[0] + d[1]) + (d[2] + d[3])) * scale;
    }
    m = s;  // lane 0's key is live: m is finite
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    const float p = expf(s - m);  // keys past len: exp(-inf) = 0
    l = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(FULL, l, off);  // the same sum on every lane

    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float pj = __shfl_sync(FULL, p, j);
      float vf[4];
      load4(vs + j * D + 4 * lane, vf);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(pj, vf[i], acc[i]);
    }
  }

  // In-block merge, warp 0 then warp 1 (a warp with no live key adds 0),
  // and the chunk's partial out.
  float* xs = reinterpret_cast<float*>(smem_raw + Tile::X_OFF);
  if (warp == 1) {
    *reinterpret_cast<float4*>(xs + 4 * lane) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (lane == 0) xs[D] = m, xs[D + 1] = l;
  }
  __syncthreads();
  if (warp == 1) return;
  const float m1 = xs[D], l1 = xs[D + 1];
  const float4 o1 = *reinterpret_cast<const float4*>(xs + 4 * lane);
  const float mm = fmaxf(m, m1);  // finite: warp 0 saw key c0
  const float a0 = expf(m - mm), a1 = m1 == -INFINITY ? 0.f : expf(m1 - mm);
  float* pc = part + (qo / D * n_chunks + chunk) * U_PART;
  *reinterpret_cast<float4*>(pc + 4 * lane) =
      make_float4(fmaf(o1.x, a1, acc[0] * a0), fmaf(o1.y, a1, acc[1] * a0), fmaf(o1.z, a1, acc[2] * a0),
                  fmaf(o1.w, a1, acc[3] * a0));
  if (lane == 0) pc[D] = mm, pc[D + 1] = fmaf(l1, a1, l * a0);
}

// The merge pass: block (head, row), thread t = output dim t, over the row's
// ceil(len / U_CHUNK) partials.
__global__ void __launch_bounds__(NT) stacked_merge_kernel(const float* __restrict__ part,
                                                           const int* __restrict__ seq_lens, float* __restrict__ out,
                                                           int n_heads, int cap, int n_chunks) {
  const int head = blockIdx.x, row = blockIdx.y;
  const int len = min(seq_lens[row], cap);
  const int n = max(0, (len + U_CHUNK - 1) / U_CHUNK);
  const size_t rh = (size_t)row * n_heads + head;
  out[rh * D + threadIdx.x] = merge_partials(part + rh * n_chunks * U_PART, n, U_PART, threadIdx.x);
}

template <typename T>
int launch_stacked(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens, void* part,
                   void* out, int batch, int n_heads, int head_dim, int cap, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || n_heads <= 0 || n_heads > 65535 || head_dim != D || cap <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = (cap + U_CHUNK - 1) / U_CHUNK;
  const auto kernel = stacked_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, UTile<T>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(n_chunks, n_heads, batch), U_WARPS * 32, UTile<T>::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_layer), static_cast<const T*>(v_layer),
      static_cast<const int*>(seq_lens), static_cast<float*>(part), n_heads, cap, n_chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stacked_merge_kernel<<<dim3(n_heads, batch), NT, 0, s>>>(static_cast<const float*>(part),
                                                           static_cast<const int*>(seq_lens),
                                                           static_cast<float*>(out), n_heads, cap, n_chunks);
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
// cap); part: the workspace, [B, Hh, ceil(cap / 64), D + 4] f32 (written
// and read before the call returns on the stream); out [B, Hh, D] f32.
extern "C" int decode_stacked_f32(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens,
                                  void* part, void* out, int batch, int n_heads, int head_dim, int cap, float scale,
                                  void* stream) {
  return launch_stacked<float>(q, k_layer, v_layer, seq_lens, part, out, batch, n_heads, head_dim, cap, scale,
                               stream);
}

extern "C" int decode_stacked_bf16(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens,
                                   void* part, void* out, int batch, int n_heads, int head_dim, int cap, float scale,
                                   void* stream) {
  return launch_stacked<__nv_bfloat16>(q, k_layer, v_layer, seq_lens, part, out, batch, n_heads, head_dim, cap,
                                       scale, stream);
}
