// Decode attention for sm_90a: kernels G, P, Q and R over the layer-stacked
// paged pool, X over a per-sequence pool and U over the contiguous cache.
//
// Kernel G replaces the Pallas TPU kernel deepseek_ocr2_tpu/ops/paged_attention.py:
// _paged_kernel_pool (via paged_decode_attention_pool): one query per row
// (a decode step) against that row's K/V pages, which the block table
// lists in order. The pool is [L, P, Hh, page, D]; the wrapper passes the
// pointer of layer li's [P, Hh, page, D] view (a view, never a copy: the
// TPU kernel rides the layer index through scalar prefetch only because
// XLA would copy a scan-sliced operand).
//
// Per (row, head), as the TPU kernel does per grid step:
//   s_j   = (q . k_j) * scale, -inf for key positions >= seq_len
//   m_new = max(m, max_j s_j);  alpha = exp(m - m_new)
//   p_j   = exp(s_j - m_new);   l = alpha * l + sum_j p_j
//   acc   = alpha * acc + sum_j p_j v_j
// and the output is acc / max(l, 1e-37), all in f32 (paged_attention.py
// :192-206). Rows that point at the scratch page 0 (finished slots) read it
// like any other page; their output is discarded by the caller.
//
// What bounds it: bytes. A row of 2048 tokens reads 2 MB of f32 K/V per
// layer (1 MB in bf16) and does 4 FLOP per element read: far under the
// card's ridge point. One block per (row, head) walking its pages one
// after another would run 160 blocks at 16 rows, with too few bytes in
// flight, so G is a split-key decode on U's walk (chunk_partial,
// merge_partials; below), in one launch (paged_split_kernel):
// - A (row, head)'s keys are cut into chunks that never cross a page end:
//   ck = min(64, page) keys, ceil(page / ck) a page; block (chunk, head,
//   row) finds its page through the block table. A block whose chunk starts
//   at or past len = seq_lens[row] exits at once, and only live K/V rows
//   are copied (cp.async); the two warps score and accumulate as U's do,
//   and the chunk's partial (acc[D], m, l) goes to a workspace the wrapper
//   makes with torch.empty (a CUDA graph captures it).
// - The last block of a (row, head) to finish merges the row's partials in
//   ascending chunk order (merge_partials): each block writes its partial,
//   __threadfence()s and counts itself on an arrival counter of the (row,
//   head); the block that brings the count to the number of live chunks
//   merges, then sets the counter back to zero, ready for the next launch
//   or a graph's next replay. The order depends on len, the page and the
//   chunk size alone, never on B, the other rows or the pool's size, and
//   not on which block merges: a row's output is bit-identical whatever
//   else is in the batch. One launch, not U's two: the decode step is
//   host-bound. G, X, P, Q and R share the counters ([B * Hh] int32, one
//   buffer a device): that holds because launches on one stream run in
//   order and each leaves every counter at zero.
// At 16 rows of 260..2048 tokens, 10 heads, pages of 128, that is 2960
// live blocks of at most 64 keys (18464 keys a head).
//
// Shapes: D = 128 (the LM's head dim), page <= 128, f32 or bf16 pool, q
// f32 (checked by the wrapper).
//
// Kernel P (paged_decode_q8) replaces deepseek_ocr2_tpu/ops/paged_attention.py:
// _paged_kernel_pool_q8, its one-query form over an int8 pool, on G's walk
// (paged_split_kernel with int8 elements). Key j of a page is codes[j, :]
// times the f32 scale k_scale[li, pg, head, j] (V the same way), where the
// TPU kernel and the plain twin widen each key to f32 before the dot
// product. Here the scales are folded out of the inner loops:
//   s_j = (scale * ks_j) * (q . c_j),  acc += (p_j * vs_j) * c_j,
// so the loops are int8 -> f32 converts (a byte permute into the mantissa
// of 2^23 and one subtraction: exact, at the FMA's rate where a convert
// instruction runs at a quarter of it) and FMAs; lane j loads its key's two
// scales into registers. The sums round differently from the twin's, well
// within 1e-4. A chunk moves 64 code rows of 128 bytes a block (K and V:
// 16 KB, against G's 32 KB of bf16). In tail mode (int8tail pools) the
// chunks of the row's last page, p == (len - 1) / page, read instead the
// row's bf16 open page open[li, row, head] at the same offsets (G's bf16
// walk, no scales); a row of len <= page reads nothing else. Finished rows
// point at the scratch page 0 and read their own slot's open page for their
// last page only; their output is discarded.
// What bounds it: bytes. A token of a (row, head) costs 2 * 128 code bytes
// and 2 * 4 scale bytes, 264 bytes against G's 1024 (f32) and 512 (bf16);
// the open page adds 2 * 2 * 128 bytes a token of the last page.
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
// Q and R are G's walk with S queries a block (paged_split_kernel<T, S,
// TAIL>: Q f32 / bf16, R int8 codes): the chunks run up to the row's
// LARGEST budget max_len, each chunk's K and V rows are copied once for all
// S queries, lane j scores key j against the S queries (a copy of them a
// warp in shared memory) and owns 4 output dims of each of the S
// accumulators; the weights of a key pass through shared memory ([key][S],
// one broadcast load a key for four queries) instead of S shuffles. A query
// whose budget ends before a warp's (or the chunk's) first key has no live
// key there: its maximum is -inf, and the softmax subtracts 0 instead (as
// merge_partials weighs such a partial by 0), so the partial adds exact
// zeros. Query i's partials, its output included, are then bit-identical to
// the one-query walk's (G's, or P's on an int8 pool without a tail) at len =
// seq_lens[row, i], whatever the other queries' budgets. The workspace holds
// S partials a chunk ([B, Hh, n_chunks, S, D + 4] f32) and the merging block
// merges all S in ascending chunk order. CUDA cores, not mma: S <= 8 rows
// would fill little of a tile, and the kernel is bound by bytes (4 S FLOP
// per K/V element pair). At the serving shape (16 rows of 260..2048 tokens,
// 18464 tokens in all, 10 heads, S = 4) Q reads G's bytes once, 189 MB of
// f32 K/V (0.056 ms at 3.35 TB/s; 94 MB in bf16), and writes and reads back
// about 12 MB of partials.
//
// R reads P's int8 codes and per-token scales, folded out of the loops as
// P's are. In tail mode (int8tail pools) the chunks of the row's open page,
// its LAST page by the row's LARGEST budget, p == (len - 1) / page with len
// the largest budget, read the bf16 open page instead, whatever each
// query's own budget: a chunk forward that crosses a page end has written
// every token of the chunk at (row, position % page) of the open page, and
// the earlier page's tokens that land there sit past len. (The budgets are
// clamped to max_pages * page, which a block table's row covers: within
// that, the open page is the one the twin patches, seq_lens[row, -1] of
// ascending budgets.) So on an int8tail pool query i equals P's walk at its
// budget only where all of the row's budgets lie in one page. The serving
// shape's 16 rows read 48.7 MB of codes, scales and open pages (0.0155 ms
// at 3.35 TB/s), and write and read back the same 12 MB of partials as Q.
// Finished rows point at the scratch page 0 and are walked like any row;
// their output is discarded.
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
//   output dims of P V, the weights passed through shared memory.
// - At the end warp 1's (m, l, acc) goes through shared memory, warp 0
//   merges it (a warp with no live key has m = -inf and adds exact zeros)
//   and writes the chunk's partial (acc[D], m, l) to a workspace [B, Hh,
//   ceil(cap / 64), D + 4] f32 that the wrapper allocates (torch.empty:
//   no host sync, and a CUDA graph captures it).
// - A second launch, one block of D / 4 threads per (row, head), four
//   output dims a thread, merges the row's ceil(len / 64) partials in
//   ascending chunk order
//   (merge_partials): out = sum acc_c e^(m_c - m) / max(sum l_c e^(m_c -
//   m), 1e-37), m = max m_c, as the one-block walk divided by max(l,
//   1e-37). The order depends on len and the chunk size alone, never on B
//   or cap, so a row's output is bit-identical from run to run and
//   whatever the other rows hold. G, X, P, Q and R split their pages the
//   same way (chunk_partial, merge_partials).
// At 16 rows of 260..1000 tokens, 10 heads, that is about 1600 live blocks
// of 64 keys (32 KB of bf16 K/V each); at one row at position 300, 50.

#include "split_walk.cuh"

#include <type_traits>

namespace {

using namespace split_walk;

constexpr int MAX_PAGE = 128;
constexpr int MAX_CHUNK = 8;

// Kernel U: block (chunk, head, row) over keys chunk * U_CHUNK ... of the
// row's contiguous [cap, D] slabs; a block whose chunk starts at or past
// len exits at once. k_layer / v_layer [B, Hh, cap, D]; part [B, Hh,
// n_chunks, U_PART] f32.
template <typename T>
__global__ void __launch_bounds__(U_WARPS * 32) stacked_chunk_kernel(
    const float* __restrict__ q, const T* __restrict__ k_layer, const T* __restrict__ v_layer,
    const int* __restrict__ seq_lens, float* __restrict__ part, int n_heads, int cap, int n_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk = blockIdx.x, head = blockIdx.y, row = blockIdx.z;
  const int len = min(seq_lens[row], cap);
  const int c0 = chunk * U_CHUNK;
  if (c0 >= len) return;  // the whole block: no key of its chunk is live
  const size_t rh = (size_t)row * n_heads + head;
  const size_t base = (rh * cap + c0) * D;
  const int n = min(U_CHUNK, len - c0);
  const int nq[1] = {n};
  chunk_partial<T, 1>(q + rh * D, D, k_layer + base, v_layer + base, nullptr, nullptr, n, nq, scale,
                      part + (rh * n_chunks + chunk) * U_PART, smem_raw);
}

// The merge pass: block (head, row), thread t = output dims 4 t .. 4 t + 3,
// over the row's ceil(len / U_CHUNK) partials.
__global__ void __launch_bounds__(D / 4) stacked_merge_kernel(const float* __restrict__ part,
                                                              const int* __restrict__ seq_lens,
                                                              float* __restrict__ out, int n_heads, int cap,
                                                              int n_chunks) {
  const int head = blockIdx.x, row = blockIdx.y;
  const int len = min(seq_lens[row], cap);
  const int n = max(0, (len + U_CHUNK - 1) / U_CHUNK);
  const size_t rh = (size_t)row * n_heads + head;
  reinterpret_cast<float4*>(out + rh * D)[threadIdx.x] =
      merge_partials(part + rh * n_chunks * U_PART, n, U_PART, threadIdx.x);
}

template <typename T>
int launch_stacked(const void* q, const void* k_layer, const void* v_layer, const void* seq_lens, void* part,
                   void* out, int batch, int n_heads, int head_dim, int cap, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || n_heads <= 0 || n_heads > 65535 || head_dim != D || cap <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_chunks = (cap + U_CHUNK - 1) / U_CHUNK;
  const auto kernel = stacked_chunk_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, UTile<T, 1>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(n_chunks, n_heads, batch), U_WARPS * 32, UTile<T, 1>::SMEM, s>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_layer), static_cast<const T*>(v_layer),
      static_cast<const int*>(seq_lens), static_cast<float*>(part), n_heads, cap, n_chunks, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stacked_merge_kernel<<<dim3(n_heads, batch), D / 4, 0, s>>>(static_cast<const float*>(part),
                                                           static_cast<const int*>(seq_lens),
                                                           static_cast<float*>(out), n_heads, cap, n_chunks);
  return (int)cudaGetLastError();
}

// Kernels G, X, P, Q and R: see the header. The keys of page p of a row are
// cut into chunks of ck = min(U_CHUNK, page) keys that never cross a page
// end, cpp = ceil(page / ck) a page; chunk c of the row is chunk c % cpp of
// its page c / cpp, so chunks ascend with the key position. live_chunks:
// the chunks that hold a key below len (len >= 1).
__device__ __forceinline__ int live_chunks(int len, int page, int ck, int cpp) {
  const int p_last = (len - 1) / page;
  return p_last * cpp + (len - 1 - p_last * page) / ck + 1;
}

// Block (chunk, head, row) of S queries a row (q, out [B, S, Hh, D];
// seq_lens [B, S]; G, X, P: S = 1; Q, R: S > 1): one chunk's S partials
// into part [B, Hh, n_chunks, S, U_PART]; the last block of the (row, head)
// to finish merges the row's live partials of each query in ascending order
// into out and resets its arrival count (counters [B * Hh], zero between
// launches).
// The chunks run up to len, the largest of the row's budgets. A block whose
// chunk starts at or past len exits at once; so does every block of a row
// with len <= 0 but chunk 0's, which writes zeros (the one-block walk's acc
// / max(l, 1e-37) with no key). T = signed char: int8 codes with scales
// k_scale / v_scale [P, Hh, page] (kernels P, R); with TAIL the chunks of
// the row's last page read its bf16 open page open_k / open_v [B, Hh, page,
// D] instead.
template <typename T, int S, bool TAIL>
__global__ void __launch_bounds__(U_WARPS * 32) paged_split_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale, const __nv_bfloat16* __restrict__ open_k,
    const __nv_bfloat16* __restrict__ open_v, const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
    float* __restrict__ part, int* __restrict__ counters, float* __restrict__ out, int n_heads, int page,
    int max_pages, int n_chunks, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int merger;
  const int chunk = blockIdx.x, head = blockIdx.y, row = blockIdx.z;
  const size_t rh = (size_t)row * n_heads + head;
  const size_t qo = ((size_t)row * S * n_heads + head) * D, q_stride = (size_t)n_heads * D;  // query i: qo + i q_stride
  int budget[S], len = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    budget[i] = min(seq_lens[(size_t)row * S + i], max_pages * page);
    len = max(len, budget[i]);
  }
  if (len <= 0) {
    if (chunk == 0)
      for (int e = threadIdx.x; e < S * D; e += U_WARPS * 32) out[qo + e / D * q_stride + e % D] = 0.f;
    return;
  }
  const int ck = min(U_CHUNK, page), cpp = (page + ck - 1) / ck;
  const int p = chunk / cpp, off = chunk % cpp * ck;
  const int k0 = p * page + off;  // the chunk's first key position
  if (k0 >= len) return;
  const int n = min(min(ck, page - off), len - k0);  // the keys any query of the row sees
  int nq[S];
#pragma unroll
  for (int i = 0; i < S; ++i) nq[i] = max(0, min(n, budget[i] - k0));
  float* prh = part + rh * n_chunks * S * U_PART;
  float* pc = prh + (size_t)chunk * S * U_PART;
  if (TAIL && p == (len - 1) / page) {
    const size_t obase = (rh * page + off) * D;  // the row's open page, at the chunk's offset
    chunk_partial<__nv_bfloat16, S>(q + qo, q_stride, open_k + obase, open_v + obase, nullptr, nullptr, n, nq,
                                    scale, pc, smem_raw);
  } else {
    const int pg = block_tables[(size_t)row * max_pages + p];
    const size_t sbase = ((size_t)pg * n_heads + head) * page + off;  // the chunk's first key row
    constexpr bool CODES = sizeof(T) == 1;
    chunk_partial<T, S>(q + qo, q_stride, k_pages + sbase * D, v_pages + sbase * D, CODES ? k_scale + sbase : nullptr,
                        CODES ? v_scale + sbase : nullptr, n, nq, scale, pc, smem_raw);
  }

  // Arrival: the partials are written (warp 0) and made visible device-wide
  // before the count; the block that brings the count to the number of live
  // chunks merges. Which block that is changes nothing in the bits.
  const int n_live = live_chunks(len, page, ck, cpp);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) merger = atomicAdd(counters + rh, 1) == n_live - 1;
  __syncthreads();
  if (!merger) return;
  __threadfence();
  constexpr int Q4 = D / 4, ITEMS = (S * Q4 + U_WARPS * 32 - 1) / (U_WARPS * 32);  // (query, 4 dims) a thread
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int e = threadIdx.x + k * U_WARPS * 32, i = e / Q4;
    if (e < S * Q4)
      *reinterpret_cast<float4*>(out + qo + i * q_stride + 4 * (e % Q4)) =
          merge_partials(prh + i * U_PART, n_live, S * U_PART, e % Q4);
  }
  if (threadIdx.x == 0) counters[rh] = 0;  // ready for the next launch (and a graph's next replay)
}

bool split_shape_ok(int batch, int n_heads, int head_dim, int page, int max_pages) {
  return batch > 0 && batch <= 65535 && n_heads > 0 && n_heads <= 65535 && head_dim == D && page > 0 &&
         page <= MAX_PAGE && max_pages > 0;
}

// One launch of paged_split_kernel<T, S, TAIL> on the row's pages; k_scale,
// v_scale, open_k and open_v may be null where the kernel does not read
// them. The workspace part is [B, Hh, max_pages * ceil(page / min(64,
// page)), S, D + 4] f32.
template <typename T, int S, bool TAIL>
int launch_split(const void* q, const void* k_pages, const void* v_pages, const void* k_scale, const void* v_scale,
                 const void* open_k, const void* open_v, const void* block_tables, const void* seq_lens, void* part,
                 void* counters, void* out, int batch, int n_heads, int page, int max_pages, float scale,
                 void* stream) {
  constexpr int smem = TAIL && UTile<__nv_bfloat16, S>::SMEM > UTile<T, S>::SMEM ? UTile<__nv_bfloat16, S>::SMEM
                                                                                  : UTile<T, S>::SMEM;
  const int ck = page < U_CHUNK ? page : U_CHUNK;
  const int n_chunks = max_pages * ((page + ck - 1) / ck);
  const auto kernel = paged_split_kernel<T, S, TAIL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_chunks, n_heads, batch), U_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const __nv_bfloat16*>(open_k), static_cast<const __nv_bfloat16*>(open_v),
      static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens), static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<float*>(out), n_heads, page, max_pages, n_chunks, scale);
  return (int)cudaGetLastError();
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

// Kernels Q (T = float / bf16) and R (T = signed char, with TAIL for
// int8tail pools): paged_split_kernel<T, S, TAIL> for the runtime S.
template <typename T>
int launch_chunk(const void* q, const void* k_pages, const void* v_pages, const void* k_scale, const void* v_scale,
                 const void* open_k, const void* open_v, const void* block_tables, const void* seq_lens, void* part,
                 void* counters, void* out, int batch, int n_queries, int n_heads, int head_dim, int page,
                 int max_pages, bool tail, float scale, void* stream) {
  if (!chunk_shape_ok(batch, n_queries, n_heads, head_dim, page, max_pages) ||
      !split_shape_ok(batch, n_heads, head_dim, page, max_pages)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = 0;
  with_chunk(n_queries, [&](auto s) {
    constexpr int S = decltype(s)::value;
    auto launch = launch_split<T, S, false>;
    if constexpr (sizeof(T) == 1) {  // int8tail: R only
      if (tail) launch = launch_split<T, S, true>;
    }
    err = launch(q, k_pages, v_pages, k_scale, v_scale, open_k, open_v, block_tables, seq_lens, part, counters, out,
                 batch, n_heads, page, max_pages, scale, stream);
  });
  return err;
}

template <typename T>
int launch_paged(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                 const void* seq_lens, void* part, void* counters, void* out, int batch, int n_heads, int head_dim,
                 int page, int max_pages, float scale, void* stream) {
  if (!split_shape_ok(batch, n_heads, head_dim, page, max_pages)) return (int)cudaErrorInvalidValue;
  return launch_split<T, 1, false>(q, k_pages, v_pages, nullptr, nullptr, nullptr, nullptr, block_tables, seq_lens,
                                   part, counters, out, batch, n_heads, page, max_pages, scale, stream);
}

}  // namespace

// Kernel Q. q [B, S, Hh, D] f32; k_pages / v_pages: one layer of the pool,
// [P, Hh, page, D] f32 or bf16; block_tables [B, max_pages] int32; seq_lens
// [B, S] int32 (per-query budgets); part: the workspace, [B, Hh, max_pages *
// ceil(page / min(64, page)), S, D + 4] f32; counters: [B * Hh] int32, zero
// before the call and left zero after it; out [B, S, Hh, D] f32.
extern "C" int paged_chunk_f32(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                               const void* seq_lens, void* part, void* counters, void* out, int batch, int n_queries,
                               int n_heads, int head_dim, int page, int max_pages, float scale, void* stream) {
  return launch_chunk<float>(q, k_pages, v_pages, nullptr, nullptr, nullptr, nullptr, block_tables, seq_lens, part,
                             counters, out, batch, n_queries, n_heads, head_dim, page, max_pages, false, scale, stream);
}

extern "C" int paged_chunk_bf16(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                                const void* seq_lens, void* part, void* counters, void* out, int batch, int n_queries,
                                int n_heads, int head_dim, int page, int max_pages, float scale, void* stream) {
  return launch_chunk<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, nullptr, nullptr, block_tables, seq_lens,
                                     part, counters, out, batch, n_queries, n_heads, head_dim, page, max_pages, false,
                                     scale, stream);
}

// Kernel R. As kernel Q over one layer of an int8 pool: k_pages / v_pages
// [P, Hh, page, D] int8, k_scale / v_scale [P, Hh, page] f32, and when tail
// is non-zero the layer's open pages open_k / open_v [B, Hh, page, D] bf16;
// part and counters as kernel Q's.
extern "C" int paged_chunk_q8(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
                              const void* v_scale, const void* open_k, const void* open_v, const void* block_tables,
                              const void* seq_lens, void* part, void* counters, void* out, int batch, int n_queries,
                              int n_heads, int head_dim, int page, int max_pages, int tail, float scale,
                              void* stream) {
  if (tail && (open_k == nullptr || open_v == nullptr)) return (int)cudaErrorInvalidValue;
  return launch_chunk<signed char>(q, k_pages, v_pages, k_scale, v_scale, open_k, open_v, block_tables, seq_lens, part,
                                   counters, out, batch, n_queries, n_heads, head_dim, page, max_pages, tail != 0,
                                   scale, stream);
}

// Kernel P. q [B, Hh, D] f32; k_pages / v_pages: one layer of the int8 pool,
// [P, Hh, page, D]; k_scale / v_scale: that layer's [P, Hh, page] f32;
// open_k / open_v: that layer's open pages [B, Hh, page, D] bf16 when tail is
// non-zero (ignored otherwise); block_tables [B, max_pages] int32; seq_lens
// [B] int32; part, counters: as kernel G's; out [B, Hh, D] f32.
extern "C" int paged_decode_q8(const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
                               const void* v_scale, const void* open_k, const void* open_v, const void* block_tables,
                               const void* seq_lens, void* part, void* counters, void* out, int batch, int n_heads,
                               int head_dim, int page, int max_pages, int tail, float scale, void* stream) {
  if (!split_shape_ok(batch, n_heads, head_dim, page, max_pages) ||
      (tail && (open_k == nullptr || open_v == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const auto launch = tail ? launch_split<signed char, 1, true> : launch_split<signed char, 1, false>;
  return launch(q, k_pages, v_pages, k_scale, v_scale, open_k, open_v, block_tables, seq_lens, part, counters, out,
                batch, n_heads, page, max_pages, scale, stream);
}

// Kernels G and X. q [B, Hh, D] f32; k_pages / v_pages: one layer of the
// pool, [P, Hh, page, D]; block_tables [B, max_pages] int32; seq_lens [B]
// int32; part: the workspace, [B, Hh, max_pages * ceil(page / min(64,
// page)), D + 4] f32; counters: [B * Hh] int32, zero before the call and
// left zero after it; out [B, Hh, D] f32.
extern "C" int paged_decode_f32(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                                const void* seq_lens, void* part, void* counters, void* out, int batch, int n_heads,
                                int head_dim, int page, int max_pages, float scale, void* stream) {
  return launch_paged<float>(q, k_pages, v_pages, block_tables, seq_lens, part, counters, out, batch, n_heads,
                             head_dim, page, max_pages, scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages, const void* v_pages, const void* block_tables,
                                 const void* seq_lens, void* part, void* counters, void* out, int batch, int n_heads,
                                 int head_dim, int page, int max_pages, float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, part, counters, out, batch,
                                     n_heads, head_dim, page, max_pages, scale, stream);
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
