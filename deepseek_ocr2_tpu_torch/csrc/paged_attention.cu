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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 128;
constexpr int MAX_PAGE = 128;
constexpr int MAX_CHUNK = 8;
constexpr unsigned FULL = 0xffffffffu;

// Four int8 codes (one 32-bit word) as f32, exactly: c ^ 0x80 = c + 128 as
// a byte goes into the low mantissa byte of 2^23 (a byte permute), and
// 2^23 + 128 comes off again (one FADD). A convert instruction would run at
// a quarter of the FMA's rate.
__device__ __forceinline__ void codes4(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) - 8388736.f;
}

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

__device__ __forceinline__ void load4(const signed char* p, float* out) {
  codes4(*reinterpret_cast<const uint32_t*>(p), out);
}

// The split-key walk of kernels G, X, P, Q, R and U: a chunk of at most
// U_CHUNK keys of one (row, head) a block, U_WARP_KEYS a warp, and the
// chunks' partials merged in ascending chunk order. U_PART floats a
// partial of one query.
constexpr int U_WARP_KEYS = 32;                     // keys a warp: one a lane
constexpr int U_WARPS = 2;
constexpr int U_CHUNK = U_WARPS * U_WARP_KEYS;      // keys a block: one chunk of a row's keys
constexpr int U_PART = D + 4;                       // a partial: acc[D], m, l (16-byte rows)

// Shared memory of chunk_partial<T, S>: per warp its K rows (padded) and V
// rows, a copy of the S queries and its keys' weights, and the S states of
// warps 1.. for the in-block merge.
template <typename T, int S>
struct UTile {
  static constexpr int CE = 16 / (int)sizeof(T);    // elements a 16-byte chunk
  static constexpr int KS = D + CE;  // K row stride: a lane reads its own row, 8 lanes' 16-byte loads on 32 banks
  static constexpr int WARP_BYTES = (int)sizeof(T) * U_WARP_KEYS * (KS + D);  // a warp's K and V rows
  static constexpr int SP = (S + 3) / 4 * 4;        // a key's S weights, in 16-byte rows
  static constexpr int Q_OFF = U_WARPS * WARP_BYTES;                          // the S queries, a copy a warp
  static constexpr int W_OFF = Q_OFF + U_WARPS * S * D * 4;                   // [U_WARP_KEYS][SP] weights a warp
  static constexpr int X_OFF = W_OFF + U_WARPS * U_WARP_KEYS * SP * 4;        // warps 1..'s S states
  static constexpr int SMEM = X_OFF + (U_WARPS - 1) * S * U_PART * 4;
};

// A key row's elements a step of chunk_partial's score loop, as f32: 8 of
// f32 or bf16, 16 int8 codes (one 16-byte load of a 16-byte aligned row,
// f32's two).
__device__ __forceinline__ void load_step(const float* p, float* out) {
  load4(p, out);
  load4(p + 4, out + 4);
}

__device__ __forceinline__ void load_step(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_step(const signed char* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  codes4(v.x, out);
  codes4(v.y, out + 4);
  codes4(v.z, out + 8);
  codes4(v.w, out + 12);
}

// S weights of one key (16-byte aligned rows of shared memory).
template <int S>
__device__ __forceinline__ void load_weights(const float* p, float (&w)[S]) {
#pragma unroll
  for (int i = 0; i + 4 <= S; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    w[i] = x.x;
    w[i + 1] = x.y;
    w[i + 2] = x.z;
    w[i + 3] = x.w;
  }
#pragma unroll
  for (int i = S / 4 * 4; i < S; ++i) w[i] = p[i];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The fixed-order merge of n partials (acc[D], m, l at stride floats apart)
// of one (row, head, query): out[t] = sum_c acc_c[t] e^(m_c - m) /
// max(sum_c l_c e^(m_c - m), 1e-37), m = max_c m_c, summed in ascending c.
// A partial that saw no key (m_c = -inf) adds exact zeros. The order
// depends on n alone, so an output is bit-identical from run to run and
// whatever the other rows hold. Returns output dims 4 t4 .. 4 t4 + 3 (a
// thread merges four: a quarter of the loads and of the chain of steps of
// one a thread). The loads bypass L1 (ld.cg): in G, P and Q the partials
// were written by other blocks of the same launch.
__device__ __forceinline__ float4 merge_partials(const float* __restrict__ part, int n, int stride, int t4) {
  float m = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < n; ++c) m = fmaxf(m, __ldcg(part + (size_t)c * stride + D));
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    const float* pc = part + (size_t)c * stride;
    const float mc = __ldcg(pc + D);
    const float w = mc == -INFINITY ? 0.f : expf(mc - m);
    l = fmaf(__ldcg(pc + D + 1), w, l);
    const float4 a = __ldcg(reinterpret_cast<const float4*>(pc) + t4);
    acc.x = fmaf(a.x, w, acc.x);
    acc.y = fmaf(a.y, w, acc.y);
    acc.z = fmaf(a.z, w, acc.z);
    acc.w = fmaf(a.w, w, acc.w);
  }
  const float r = fmaxf(l, 1e-37f);
  return make_float4(acc.x / r, acc.y / r, acc.z / r, acc.w / r);
}

// One chunk's partials: the n (1 <= n <= U_CHUNK) keys whose K and V rows
// lie contiguous at k and v, against S queries q + i q_stride ([D] f32
// each), query i seeing the chunk's first nq[i] <= n keys, into pc + i
// U_PART (acc[D], m, l). Int8 codes (T = signed char) come with their keys'
// f32 scales at ks and vs, folded in as s_j = (scale ks_j) (q . c_j) and
// acc += (p_j vs_j) c_j; other element types ignore ks and vs. U_WARPS
// warps of U_WARP_KEYS keys, each its own online softmax with no block
// barrier until the in-block merge; keys past n are never read. A query
// with no live key in a warp (or the chunk) has m = -inf and adds exact
// zeros: the softmax subtracts 0 for it, and the merges weigh it by 0.
// Every thread of the block calls it (one __syncthreads).
template <typename T, int S>
__device__ __forceinline__ void chunk_partial(const float* __restrict__ q, size_t q_stride, const T* __restrict__ k,
                                              const T* __restrict__ v, const float* __restrict__ ks,
                                              const float* __restrict__ vs, int n, const int (&nq)[S], float scale,
                                              float* __restrict__ pc, unsigned char* smem_raw) {
  using Tile = UTile<T, S>;
  constexpr int KS = Tile::KS, CE = Tile::CE, CH = D / CE, SP = Tile::SP;  // CH: 16-byte chunks a row
  constexpr int STEP = sizeof(T) == 1 ? 16 : 8;  // key elements a step of the score loop (load_step)
  constexpr bool CODES = sizeof(T) == 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* kt = reinterpret_cast<T*>(smem_raw + warp * Tile::WARP_BYTES);  // [U_WARP_KEYS][KS]
  T* vt = kt + U_WARP_KEYS * KS;                                      // [U_WARP_KEYS][D]
  float* qs = reinterpret_cast<float*>(smem_raw + Tile::Q_OFF) + warp * S * D;          // [S][D]
  float* ws = reinterpret_cast<float*>(smem_raw + Tile::W_OFF) + warp * U_WARP_KEYS * SP;  // [U_WARP_KEYS][SP]
  const int j0 = warp * U_WARP_KEYS;                     // the warp's first key of the chunk
  const int nk = max(0, min(U_WARP_KEYS, n - j0));       // its live keys (warp-uniform)

  float m[S], l[S], acc[S][4];  // lane: output dims 4 lane .. 4 lane + 3 of each query
#pragma unroll
  for (int i = 0; i < S; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  if (nk > 0) {
    // The warp's live K rows, then its V rows, in two cp.async groups.
    const size_t base = (size_t)j0 * D;
    for (int i = lane; i < nk * CH; i += 32) {
      const int r = i / CH, c = CE * (i % CH);
      cp_async16(kt + r * KS + c, k + base + (size_t)r * D + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = lane; i < nk * CH; i += 32) {
      const int r = i / CH, c = CE * (i % CH);
      cp_async16(vt + r * D + c, v + base + (size_t)r * D + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
    for (int i = 0; i < S; ++i)
      *reinterpret_cast<float4*>(qs + i * D + 4 * lane) = *reinterpret_cast<const float4*>(q + i * q_stride + 4 * lane);
    float kscale = scale, vscale = 1.f;  // lane j: key j0 + j's
    if (CODES && lane < nk) {
      kscale = scale * ks[j0 + lane];
      vscale = vs[j0 + lane];
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();

    // Lane j scores key j0 + j against each query (four partial sums each).
    float s[S];
#pragma unroll
    for (int i = 0; i < S; ++i) s[i] = -INFINITY;
    if (lane < nk) {
      const T* kr = kt + lane * KS;
      float d[S][4];
#pragma unroll
      for (int i = 0; i < S; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
#pragma unroll 4
      for (int e = 0; e < D; e += STEP) {
        float kf[STEP];
        load_step(kr + e, kf);
#pragma unroll
        for (int i = 0; i < S; ++i) {
#pragma unroll
          for (int x = 0; x < STEP; x += 4) {
            const float4 qa = *reinterpret_cast<const float4*>(qs + i * D + e + x);
            d[i][0] = fmaf(qa.x, kf[x], d[i][0]);
            d[i][1] = fmaf(qa.y, kf[x + 1], d[i][1]);
            d[i][2] = fmaf(qa.z, kf[x + 2], d[i][2]);
            d[i][3] = fmaf(qa.w, kf[x + 3], d[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < S; ++i)
        if (j0 + lane < nq[i]) s[i] = ((d[i][0] + d[i][1]) + (d[i][2] + d[i][3])) * kscale;
    }
    // Each query's warp max and sum by xor shuffles (the same on every
    // lane); its weights p (times V's scale for codes) to shared memory.
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float mx = s[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      m[i] = mx;
      const float p = expf(s[i] - (mx == -INFINITY ? 0.f : mx));  // masked keys: exp(-inf) = 0
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
      l[i] = sum;
      ws[lane * SP + i] = CODES ? p * vscale : p;
    }

    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      float w[S], vf[4];
      load_weights<S>(ws + j * SP, w);
      load4(vt + j * D + 4 * lane, vf);
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][x] = fmaf(w[i], vf[x], acc[i][x]);
    }
  }

  // In-block merge, warp 0 then warps 1 ... in order (a query with no live
  // key in a warp adds 0), and the chunk's partials out by warp 0.
  float* xs = reinterpret_cast<float*>(smem_raw + Tile::X_OFF);  // [U_WARPS - 1][S][U_PART]
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float* xi = xs + ((warp - 1) * S + i) * U_PART;
      *reinterpret_cast<float4*>(xi + 4 * lane) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (lane == 0) xi[D] = m[i], xi[D + 1] = l[i];
    }
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    for (int w = 1; w < U_WARPS; ++w) {
      const float* x1 = xs + ((w - 1) * S + i) * U_PART;
      const float m1 = x1[D], l1 = x1[D + 1];
      const float4 o1 = *reinterpret_cast<const float4*>(x1 + 4 * lane);
      const float mm = fmaxf(m[i], m1);
      const float a0 = m[i] == -INFINITY ? 0.f : expf(m[i] - mm), a1 = m1 == -INFINITY ? 0.f : expf(m1 - mm);
      acc[i][0] = fmaf(o1.x, a1, acc[i][0] * a0);
      acc[i][1] = fmaf(o1.y, a1, acc[i][1] * a0);
      acc[i][2] = fmaf(o1.z, a1, acc[i][2] * a0);
      acc[i][3] = fmaf(o1.w, a1, acc[i][3] * a0);
      l[i] = fmaf(l1, a1, l[i] * a0);
      m[i] = mm;
    }
    float* pi = pc + i * U_PART;
    *reinterpret_cast<float4*>(pi + 4 * lane) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (lane == 0) pi[D] = m[i], pi[D + 1] = l[i];
  }
}

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
