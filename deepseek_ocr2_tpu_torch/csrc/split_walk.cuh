// The split-key decode walk of kernels G, P, Q, R, U and X
// (paged_attention.cu) and of kernels K and O (attn_fused.cu): one chunk
// of at most U_CHUNK keys of one (row, head) a block (chunk_partial), and
// the chunks' partials merged in ascending chunk order (merge_partials).
// paged_attention.cu's header gives the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace split_walk {

constexpr int D = 128;  // the LM's head dim
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

// The split-key walk of kernels G, X, P, Q, R, U, K and O: a chunk of at most
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
// one a thread). The loads bypass L1 (ld.cg): in G, P, Q, K and O the
// partials were written by other blocks of the same launch. A seed (m0
// finite: K's and O's current token, acc a0 and l = 1) goes in ahead of
// the partials; with m0 = -inf (the default) there is none and the sums
// start at exact zeros.
__device__ __forceinline__ float4 merge_partials(const float* __restrict__ part, int n, int stride, int t4,
                                                 float m0 = -INFINITY, float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f)) {
  float m = m0;
#pragma unroll 8
  for (int c = 0; c < n; ++c) m = fmaxf(m, __ldcg(part + (size_t)c * stride + D));
  const float w0 = m0 == -INFINITY ? 0.f : expf(m0 - m);
  float l = w0;
  float4 acc = make_float4(a0.x * w0, a0.y * w0, a0.z * w0, a0.w * w0);
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

}  // namespace split_walk
