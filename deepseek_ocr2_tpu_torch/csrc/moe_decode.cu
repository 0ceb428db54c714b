// Batched-decode MoE for sm_90a: kernel F.
//
// Replaces the Pallas TPU kernel deepseek_ocr2_tpu/ops/moe_decode.py:
// _decode_kernel (via moe_ffn_decode_fused): one visit per DISTINCT
// selected expert, each over the whole decode batch, so every selected
// expert's weights stream from HBM once per step however many rows chose
// it. Rows that did not select a visit's expert get a zero combine weight.
//
// The visit list (built on the device by schedule_kernel below, one launch,
// no host sync; kernel J of csrc/moe_q8.cu takes the same one): ve [E] holds the distinct selected expert ids in ascending order, padded
// to E by repeating the last; valid [E] is 1 for a real visit. w_visit
// [E, B] f32 holds each row's routing weight for the visit's expert (0 if
// the row did not select it, and for every pad visit).
//
// Rounding points, those of the TPU kernel (round() is to the working type
// T, identity for f32; sums in f32):
//   gate = round(x Wg^T), up = round(x Wu^T)      (each over all of H)
//   act  = round(round(silu_f32(gate)) * up)
//   y    = act Wd^T                                (f32, not rounded)
//   out  = round(sum over visits, ascending expert id, of y * w_visit)
//
// bf16 experts (the served LM's dtype), two launches after the schedule's:
//   1. gate/up: gu_tc_kernel writes act [E, B, AP] (bf16, rows padded to
//      AP = act_stride(I) elements) for the valid visits;
//   2. down and combine: down_tc_kernel, one block an H tile of 16
//      columns, walks the valid visits in ascending order and sums y * w
//      in registers; it writes out [B, H] (no yw, no combine launch),
//      in bf16 (moe_decode_bf16) or, unrounded, in f32
//      (moe_decode_bf16_out_f32: a rank's partial under expert
//      parallelism, summed over the ranks in f32 and rounded once).
// f32 experts (only the reduced-depth f32 check phases run them) keep the
// CUDA-core form, three launches after the schedule's:
//   1. swiglu: grid (visit, I tile, row tile) writes act [E, B, I] (T);
//   2. down:   grid (visit, H tile, row tile) writes y * w [E, B, H] (f32);
//   3. combine: one thread per (row, column) sums the valid visits in visit
//      order and casts to T.
// No atomics: a row's output is a fixed-order sum that does not depend on
// which other rows share the batch (a visit a row did not select adds an
// exact zero; a product's row m depends on row m of x alone) and does not
// vary from run to run. Preemption in the continuous engine relies on
// that: a re-admitted page must reproduce its tokens. Invalid visits cost
// no weight bytes: the bf16 kernels walk the valid ones only (valid is a
// prefix of the visits), the f32 ones return at once.
//
// What bounds it: at B = 16 and k = 6 about 50 of the 64 experts are
// selected per step, and each visit reads 6.9 MB of bf16 weights at H =
// 1280, I = 896: ~340 MB per MoE layer, 0.105 ms at 3.35 TB/s. Each weight
// element is used by B rows, 2 * B FLOP per element (16 FLOP per byte at
// B = 16 in bf16), far below the tensor cores' ridge point: the weight
// stream sets the time, and the products must cost the stream nothing.
// The bf16 design (on an H100 the CUDA-core form took 0.65 ms at B 16,
// its warps' shuffle reductions and 64 B of loads in flight a warp far
// from the stream's needs):
// - The weights stream once, by 1-D bulk copies (TMA) of whole rows into
//   a ring of stages in shared memory, completing on mbarriers; one
//   producer warp keeps the ring full, 2-4 stages (80-170 KB) in flight
//   an SM. Each row lands at a padded stride (act_stride: its 16-byte
//   units = 1 mod 8), so the 8 rows an ldmatrix reads lie on 8 distinct
//   bank groups.
// - The products run on the tensor cores, mma.sync m16n8k16 with the
//   decode rows as A (m16 tiles of x or act, zero or ignored past B) and
//   8 weight rows as B (n8): the f32 sums stay in the mma accumulators,
//   no cross-lane reduction per output.
// - gate/up: a persistent grid (one block an SM, 8 consumer warps and the
//   producer) over items (valid visit, 8 columns of I): a stage holds the
//   item's 8 gate and 8 up rows. Each consumer warp takes an eighth of H
//   and keeps its x fragments of that eighth in registers for the whole
//   launch (x is read once a block: H <= 1280, 10 k16 steps a warp); the
//   warps' partial sums meet in shared memory (two buffers, one barrier
//   an item) in a fixed order, and SwiGLU at the rounding points above
//   writes act.
// - down: a block an H tile of 16 columns (two n8 tiles, 80 blocks at H
//   1280), 4 consumer warps each a quarter of I; a stage holds one visit's
//   act rows (one bulk copy, L2-resident) and the tile's 16 down rows.
//   The warps' partials meet in shared memory, and the thread that owns
//   an output adds y * w_visit to its register sum, visit after visit in
//   ascending order, then writes out once.
// - B > 32 runs as groups of 32 rows (each streams the weights again).
//
// Shapes: f32 H and I multiples of 8 (16-byte vectors), bf16 H and I
// multiples of 16 (k16 steps) and H <= 1280; 16-byte aligned rows (checked
// by the wrapper); any B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int WARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// The f32 form's vector loads (the CUDA-core kernels below run f32 only).
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <int N>
__device__ __forceinline__ void warp_sum(float* a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < N; ++j) a[j] += __shfl_xor_sync(FULL, a[j], off);
  }
}

// Launch 1 (f32). Block: visit v = blockIdx.x, columns [blockIdx.y * WARPS * COLS,
// + WARPS * COLS), rows [blockIdx.z * RB, + RB). Warp w owns COLS columns
// i; for each it streams the gate and up rows Wg[e, i, :], Wu[e, i, :].
template <typename T, int RB>
__global__ void __launch_bounds__(NT) swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                                                    const T* __restrict__ wu, const int* __restrict__ ve,
                                                    const int* __restrict__ valid, T* __restrict__ act,
                                                    int nb, int h_dim, int i_dim) {
  constexpr int COLS = 32 / RB;
  constexpr int VN = Vec<T>::N;
  const int v = blockIdx.x;
  if (!valid[v]) return;
  const int e = ve[v];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.z * RB;
  const int i0 = (blockIdx.y * WARPS + warp) * COLS;
  if (i0 >= i_dim) return;  // warp-uniform

  float acc[2 * COLS * RB];
#pragma unroll
  for (int j = 0; j < 2 * COLS * RB; ++j) acc[j] = 0.f;
  const T* grow[COLS];
  const T* urow[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = min(i0 + c, i_dim - 1);  // a ragged last warp re-reads a valid row, never writes it
    grow[c] = wg + ((size_t)e * i_dim + i) * h_dim;
    urow[c] = wu + ((size_t)e * i_dim + i) * h_dim;
  }
  for (int k = lane * VN; k < h_dim; k += 32 * VN) {
    float g[COLS][VN], u[COLS][VN];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      Vec<T>::load(grow[c] + k, g[c]);
      Vec<T>::load(urow[c] + k, u[c]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < nb) {
        float xv[VN];
        Vec<T>::load(x + (size_t)(b0 + r) * h_dim + k, xv);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
#pragma unroll
          for (int j = 0; j < VN; ++j) {
            acc[(2 * c) * RB + r] = fmaf(xv[j], g[c][j], acc[(2 * c) * RB + r]);
            acc[(2 * c + 1) * RB + r] = fmaf(xv[j], u[c][j], acc[(2 * c + 1) * RB + r]);
          }
        }
      }
    }
  }
  warp_sum<2 * COLS * RB>(acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int i = i0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < nb && i < i_dim) {
        const float gate = Vec<T>::round(acc[(2 * c) * RB + r]);
        const float up = Vec<T>::round(acc[(2 * c + 1) * RB + r]);
        act[((size_t)v * nb + b0 + r) * i_dim + i] = Vec<T>::store(Vec<T>::round(silu(gate)) * up);
      }
    }
  }
}

// Launch 2 (f32). Block: visit v, output columns [blockIdx.y * WARPS * COLS, +),
// rows [blockIdx.z * RB, + RB). Warp w streams the down rows Wd[e, h, :]
// of its COLS columns h against act[v, b, :].
template <typename T, int RB>
__global__ void __launch_bounds__(NT) down_kernel(const T* __restrict__ act, const T* __restrict__ wd,
                                                  const int* __restrict__ ve, const int* __restrict__ valid,
                                                  const float* __restrict__ w_visit, float* __restrict__ yw,
                                                  int nb, int i_dim, int h_dim) {
  constexpr int COLS = 32 / RB;
  constexpr int VN = Vec<T>::N;
  const int v = blockIdx.x;
  if (!valid[v]) return;
  const int e = ve[v];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.z * RB;
  const int h0 = (blockIdx.y * WARPS + warp) * COLS;
  if (h0 >= h_dim) return;

  float acc[COLS * RB];
#pragma unroll
  for (int j = 0; j < COLS * RB; ++j) acc[j] = 0.f;
  const T* drow[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) drow[c] = wd + ((size_t)e * h_dim + min(h0 + c, h_dim - 1)) * i_dim;
  const T* a = act + (size_t)v * nb * i_dim;
  for (int k = lane * VN; k < i_dim; k += 32 * VN) {
    float d[COLS][VN];
#pragma unroll
    for (int c = 0; c < COLS; ++c) Vec<T>::load(drow[c] + k, d[c]);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (b0 + r < nb) {
        float av[VN];
        Vec<T>::load(a + (size_t)(b0 + r) * i_dim + k, av);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
#pragma unroll
          for (int j = 0; j < VN; ++j) acc[c * RB + r] = fmaf(av[j], d[c][j], acc[c * RB + r]);
        }
      }
    }
  }
  warp_sum<COLS * RB>(acc);
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int h = h0 + c;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (lane == r && b0 + r < nb && h < h_dim) {
        const int b = b0 + r;
        yw[((size_t)v * nb + b) * h_dim + h] = acc[c * RB + r] * w_visit[(size_t)v * nb + b];
      }
    }
  }
}

// Launch 3 (f32): out[b, h] = round(sum over valid visits v, in order, of yw[v, b, h]).
template <typename T>
__global__ void __launch_bounds__(NT) combine_kernel(const float* __restrict__ yw, const int* __restrict__ valid,
                                                     T* __restrict__ out, int n_visits, int n_out) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= n_out) return;
  float s = 0.f;
  for (int v = 0; v < n_visits; ++v) {
    if (valid[v]) s += yw[(size_t)v * n_out + idx];
  }
  out[idx] = Vec<T>::store(s);
}

// ---------------------------------------------------------------------------
// bf16 experts on the tensor cores (see the header).

constexpr int TC_MAX_ROWS = 32;  // decode rows a launch pair: two m16 tiles
constexpr int GU_WARPS = 8;      // consumer warps of gate/up, an eighth of H each
constexpr int GU_KPW = 10;       // k16 steps a warp keeps x for: H <= 16 * 8 * 10
constexpr int GU_STAGES = 4;
constexpr int DN_WARPS = 8;      // consumer warps of down, an eighth of I each
constexpr int DN_COLS = 16;      // H columns a down block: two n8 tiles

// A row's stride in shared memory (and act's in global memory), in
// elements: n rounded up to 16, its 16-byte units = 1 mod 8 (the 8 rows an
// ldmatrix reads on 8 distinct bank groups). ops/moe_decode.act_stride.
__host__ __device__ __forceinline__ int act_stride(int n) {
  const int u = (n + 15) / 16 * 2;
  return (u + (9 - u % 8) % 8) * 8;
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int MT>
struct GuLayout {
  int rs, stage_elems, red_off, bar_off;
  size_t smem;
  __host__ __device__ explicit GuLayout(int h_dim) {
    rs = act_stride(h_dim);
    stage_elems = 2 * 8 * rs;  // 8 gate rows, then 8 up rows
    red_off = GU_STAGES * stage_elems * 2;
    bar_off = red_off + 2 * GU_WARPS * MT * 2 * 32 * 16;  // [2][warp][m tile][gate, up][lane] float4
    smem = bar_off + 2 * GU_STAGES * 8;
  }
};

// Launch 1 (bf16). Items (valid visit v, 8 columns i0 = 8 c of I), v-major;
// block b takes items b, b + gridDim.x, ..., its j-th in ring slot j %
// GU_STAGES. x rows [0, nb) (nb <= 16 MT), act [E, nb, ap].
template <int MT>
__global__ void __launch_bounds__(32 * (GU_WARPS + 1), 1)
    gu_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
                 const __nv_bfloat16* __restrict__ wu, const int* __restrict__ ve, const int* __restrict__ valid,
                 __nv_bfloat16* __restrict__ act, int nb, int n_exp, int h_dim, int i_dim, int ap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GuLayout<MT> lay(h_dim);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + GU_STAGES;
  __shared__ int n_valid;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int v = 0; v < n_exp; ++v) n += valid[v];  // a prefix of the visits
    n_valid = n;
    for (int i = 0; i < GU_STAGES; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], GU_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_cols = i_dim / 8, n_items = n_valid * n_cols;

  if (warp == GU_WARPS) {  // the producer
    if (lane != 0) return;
    for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
      const int slot = j % GU_STAGES;
      sm90::mbar_wait(&empty[slot], ((j / GU_STAGES) & 1) ^ 1);  // a fresh slot passes at once
      const int v = it / n_cols, i0 = 8 * (it - v * n_cols);
      const size_t row0 = ((size_t)ve[v] * i_dim + i0) * h_dim;
      __nv_bfloat16* dst = ring + slot * lay.stage_elems;
      sm90::mbar_arrive_expect_tx(&full[slot], 2 * 8 * h_dim * 2);
      for (int r = 0; r < 8; ++r) {
        sm90::bulk_load(dst + r * lay.rs, wg + row0 + (size_t)r * h_dim, h_dim * 2, &full[slot]);
        sm90::bulk_load(dst + (8 + r) * lay.rs, wu + row0 + (size_t)r * h_dim, h_dim * 2, &full[slot]);
      }
    }
    return;
  }

  // Consumer warp `warp`: k16 steps [k_lo, k_hi) of H; its x fragments
  // (A of m16n8k16: rows 16 m + g, + 8; k 2t, 2t + 8) in registers.
  const int g = lane / 4, t = lane % 4;
  const int n_k = h_dim / 16, kpw = (n_k + GU_WARPS - 1) / GU_WARPS;
  const int k_lo = min(n_k, warp * kpw), k_hi = min(n_k, k_lo + kpw);
  uint32_t xa[MT][GU_KPW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int r0 = 16 * m + g, r1 = r0 + 8;
    const uint32_t* x0 = reinterpret_cast<const uint32_t*>(x + (size_t)r0 * h_dim) + t;
    const uint32_t* x1 = reinterpret_cast<const uint32_t*>(x + (size_t)r1 * h_dim) + t;
#pragma unroll
    for (int j = 0; j < GU_KPW; ++j) {
      const int kk = k_lo + j;
      const bool in = kk < k_hi;
      xa[m][j][0] = in && r0 < nb ? __ldg(x0 + 8 * kk) : 0u;
      xa[m][j][1] = in && r1 < nb ? __ldg(x1 + 8 * kk) : 0u;
      xa[m][j][2] = in && r0 < nb ? __ldg(x0 + 8 * kk + 4) : 0u;
      xa[m][j][3] = in && r1 < nb ? __ldg(x1 + 8 * kk + 4) : 0u;
    }
  }
  // ldmatrix: matrices (gate, k lo), (gate, k hi), (up, k lo), (up, k hi).
  const int lrow = (lane >> 4) * 8 + (lane & 7), lcol = 8 * ((lane >> 3) & 1);
  float4* red = reinterpret_cast<float4*>(smem + lay.red_off);
  for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
    const int slot = j % GU_STAGES;
    sm90::mbar_wait(&full[slot], (j / GU_STAGES) & 1);
    const __nv_bfloat16* wrow = ring + slot * lay.stage_elems + lrow * lay.rs + lcol;
    float cg[MT][4], cu[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) cg[m][c] = cu[m][c] = 0.f;
#pragma unroll
    for (int jj = 0; jj < GU_KPW; ++jj) {
      if (k_lo + jj < k_hi) {
        uint32_t b[4];
        sm90::ldsm_x4(b, wrow + 16 * (k_lo + jj));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          sm90::mma_bf16_16816(cg[m], xa[m][jj], b[0], b[1]);
          sm90::mma_bf16_16816(cu[m], xa[m][jj], b[2], b[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);  // the stage is read: refill it
    float4* rb = red + (j & 1) * GU_WARPS * MT * 2 * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      rb[((warp * MT + m) * 2 + 0) * 32 + lane] = make_float4(cg[m][0], cg[m][1], cg[m][2], cg[m][3]);
      rb[((warp * MT + m) * 2 + 1) * 32 + lane] = make_float4(cu[m][0], cu[m][1], cu[m][2], cu[m][3]);
    }
    sm90::bar_sync(1, 32 * GU_WARPS);
    // Outputs (m tile, lane l, half h): row 16 m + l / 4 + 8 h, columns
    // i0 + 2 (l % 4), + 1; the warps' partials summed in warp order.
    const int u = threadIdx.x;
    if (u < MT * 64) {
      const int m = u / 64, l = (u / 2) % 32, h = u % 2;
      const int row = 16 * m + l / 4 + 8 * h;
      const float2* r2 = reinterpret_cast<const float2*>(rb);
      float2 gs = make_float2(0.f, 0.f), us = gs;
#pragma unroll
      for (int w = 0; w < GU_WARPS; ++w) {
        const float2 a = r2[(((w * MT + m) * 2 + 0) * 32 + l) * 2 + h];
        const float2 b = r2[(((w * MT + m) * 2 + 1) * 32 + l) * 2 + h];
        gs.x += a.x, gs.y += a.y, us.x += b.x, us.y += b.y;
      }
      if (row < nb) {
        const int v = it / n_cols, col = 8 * (it - v * n_cols) + 2 * (l % 4);
        const float a0 = round_bf16(round_bf16(silu(round_bf16(gs.x))) * round_bf16(us.x));
        const float a1 = round_bf16(round_bf16(silu(round_bf16(gs.y))) * round_bf16(us.y));
        *reinterpret_cast<uint32_t*>(act + ((size_t)v * nb + row) * ap + col) = bf16_pair(a0, a1);
      }
    }
  }
}

template <int MT>
struct DnLayout {
  int stages, act_elems, stage_elems, red_off, bar_off;
  size_t smem;
  __host__ __device__ explicit DnLayout(int ap) {
    stages = MT == 1 ? 3 : 2;
    act_elems = 16 * MT * ap;  // rows past nb never written, their outputs never stored
    stage_elems = act_elems + DN_COLS * ap;
    red_off = stages * stage_elems * 2;
    bar_off = red_off + 2 * DN_WARPS * MT * 2 * 32 * 16;  // [2][warp][m tile][n tile][lane] float4
    smem = bar_off + 2 * stages * 8;
  }
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<uint32_t*>(p) = bf16_pair(v.x, v.y);
}

__device__ __forceinline__ void store_pair(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

// Launch 2 (bf16). Block b: output columns [16 b, 16 b + 16) of every row;
// its stage j holds visit j's act rows [nb][ap] and the tile's 16 down
// rows Wd[ve[j], h0 + r, :] at stride ap. w_visit rows ldw apart. OutT:
// out's type (bf16, or f32 with the sums not rounded).
template <int MT, typename OutT>
__global__ void __launch_bounds__(32 * (DN_WARPS + 1), 1)
    down_tc_kernel(const __nv_bfloat16* __restrict__ act, const __nv_bfloat16* __restrict__ wd,
                   const int* __restrict__ ve, const int* __restrict__ valid, const float* __restrict__ w_visit,
                   int ldw, OutT* __restrict__ out, int nb, int n_exp, int h_dim, int i_dim, int ap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DnLayout<MT> lay(ap);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + lay.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.x * DN_COLS, n_rows = min(DN_COLS, h_dim - h0);
  __shared__ int n_valid;
  if (threadIdx.x == 0) {
    // One thread counts (a loop of E loads): counted by the whole block in
    // one barrier (__syncthreads_count), this kernel took 10 us longer on
    // an H100 80GB HBM3 at 700 W (`scripts/torch_moe_decode_ablate.py
    // count_block`); the gate/up kernel's time did not move.
    int n = 0;
    for (int v = 0; v < n_exp; ++v) n += valid[v];
    n_valid = n;
    for (int i = 0; i < lay.stages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], DN_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int nv = n_valid;

  if (warp == DN_WARPS) {  // the producer
    if (lane != 0) return;
    for (int v = 0; v < nv; ++v) {
      const int slot = v % lay.stages;
      sm90::mbar_wait(&empty[slot], ((v / lay.stages) & 1) ^ 1);
      __nv_bfloat16* dst = ring + slot * lay.stage_elems;
      sm90::mbar_arrive_expect_tx(&full[slot], nb * ap * 2 + n_rows * i_dim * 2);
      sm90::bulk_load(dst, act + (size_t)v * nb * ap, nb * ap * 2, &full[slot]);
      const __nv_bfloat16* src = wd + ((size_t)ve[v] * h_dim + h0) * i_dim;
      for (int r = 0; r < n_rows; ++r)
        sm90::bulk_load(dst + lay.act_elems + r * ap, src + (size_t)r * i_dim, i_dim * 2, &full[slot]);
    }
    return;
  }

  const int n_k = i_dim / 16, kpw = (n_k + DN_WARPS - 1) / DN_WARPS;
  const int k_lo = min(n_k, warp * kpw), k_hi = min(n_k, k_lo + kpw);
  // ldmatrix: act (A) matrices (rows lo, k lo), (rows hi, k lo), (rows lo,
  // k hi), (rows hi, k hi); down (B) matrices (tile 0, k lo), (tile 0, k
  // hi), (tile 1, k lo), (tile 1, k hi).
  const int arow = 8 * ((lane >> 3) & 1) + (lane & 7), acol = 8 * (lane >> 4);
  const int brow = 8 * (lane >> 4) + (lane & 7), bcol = 8 * ((lane >> 3) & 1);
  // This thread's outputs, unit u = threadIdx.x < 128 MT: m tile u / 128,
  // n tile (u / 64) % 2, lane l = (u / 2) % 32, half h = u % 2: row 16 m +
  // l / 4 + 8 h, columns h0 + 8 n + 2 (l % 4), + 1.
  const int u = threadIdx.x, um = u / 128, un = (u / 64) % 2, ul = (u / 2) % 32, uh = u % 2;
  const int urow = 16 * um + ul / 4 + 8 * uh, ucol = h0 + 8 * un + 2 * (ul % 4);
  const bool owner = u < 128 * MT && urow < nb;
  float2 o_sum = make_float2(0.f, 0.f);
  float4* red = reinterpret_cast<float4*>(smem + lay.red_off);
  for (int v = 0; v < nv; ++v) {
    const int slot = v % lay.stages;
    sm90::mbar_wait(&full[slot], (v / lay.stages) & 1);
    const __nv_bfloat16* st = ring + slot * lay.stage_elems;
    float c[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[m][n][e] = 0.f;
#pragma unroll 4
    for (int kk = k_lo; kk < k_hi; ++kk) {
      uint32_t b[4];
      sm90::ldsm_x4(b, st + lay.act_elems + brow * ap + bcol + 16 * kk);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        sm90::ldsm_x4(a, st + (16 * m + arow) * ap + acol + 16 * kk);
        sm90::mma_bf16_16816(c[m][0], a, b[0], b[1]);
        sm90::mma_bf16_16816(c[m][1], a, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);
    float4* rb = red + (v & 1) * DN_WARPS * MT * 2 * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        rb[((warp * MT + m) * 2 + n) * 32 + lane] = make_float4(c[m][n][0], c[m][n][1], c[m][n][2], c[m][n][3]);
    sm90::bar_sync(1, 32 * DN_WARPS);
    if (owner) {  // y * w summed in visit order, as the f32 form's combine
      const float2* r2 = reinterpret_cast<const float2*>(rb);
      float2 y = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < DN_WARPS; ++w) {
        const float2 a = r2[(((w * MT + um) * 2 + un) * 32 + ul) * 2 + uh];
        y.x += a.x, y.y += a.y;
      }
      const float wv = w_visit[(size_t)v * ldw + urow];
      o_sum.x = __fadd_rn(o_sum.x, __fmul_rn(y.x, wv));
      o_sum.y = __fadd_rn(o_sum.y, __fmul_rn(y.y, wv));
    }
  }
  if (owner && ucol < h_dim) store_pair(out + (size_t)urow * h_dim + ucol, o_sum);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

template <int MT, typename OutT>
int launch_tc_rows(const __nv_bfloat16* x, const __nv_bfloat16* wg, const __nv_bfloat16* wu,
                   const __nv_bfloat16* wd, const int* ve, const int* valid, const float* w_visit, int ldw,
                   __nv_bfloat16* act, OutT* out, int nb, int n_exp, int h_dim, int i_dim, int ap,
                   cudaStream_t stream) {
  const GuLayout<MT> gl(h_dim);
  const DnLayout<MT> dl(ap);
  if (gl.smem > 232448 || dl.smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gu_tc_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gl.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(down_tc_kernel<MT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dl.smem);
  if (err != cudaSuccess) return (int)err;
  gu_tc_kernel<MT><<<sm_count(), 32 * (GU_WARPS + 1), gl.smem, stream>>>(x, wg, wu, ve, valid, act, nb, n_exp,
                                                                           h_dim, i_dim, ap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_tc_kernel<MT, OutT><<<(h_dim + DN_COLS - 1) / DN_COLS, 32 * (DN_WARPS + 1), dl.smem, stream>>>(
      act, wd, ve, valid, w_visit, ldw, out, nb, n_exp, h_dim, i_dim, ap);
  return (int)cudaGetLastError();
}

// bf16: groups of up to TC_MAX_ROWS rows, each its own launch pair on the
// same act workspace (stream order keeps them apart).
template <typename OutT>
int launch_tc(const void* x, const void* wg, const void* wu, const void* wd, const void* ve, const void* valid,
              const void* w_visit, void* act, void* out, int nb, int n_exp, int h_dim, int i_dim, int ap,
              cudaStream_t stream) {
  if (h_dim % 16 || i_dim % 16 || h_dim > 16 * GU_WARPS * GU_KPW)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  for (int b0 = 0; b0 < nb; b0 += TC_MAX_ROWS) {
    const int rows = min(TC_MAX_ROWS, nb - b0);
    const bf* xg = static_cast<const bf*>(x) + (size_t)b0 * h_dim;
    OutT* og = static_cast<OutT*>(out) + (size_t)b0 * h_dim;
    const float* wv = static_cast<const float*>(w_visit) + b0;
    const int err =
        rows <= 16 ? launch_tc_rows<1, OutT>(xg, static_cast<const bf*>(wg), static_cast<const bf*>(wu),
                                       static_cast<const bf*>(wd), static_cast<const int*>(ve),
                                       static_cast<const int*>(valid), wv, nb, static_cast<bf*>(act), og, rows,
                                       n_exp, h_dim, i_dim, ap, stream)
                   : launch_tc_rows<2, OutT>(xg, static_cast<const bf*>(wg), static_cast<const bf*>(wu),
                                       static_cast<const bf*>(wd), static_cast<const int*>(ve),
                                       static_cast<const int*>(valid), wv, nb, static_cast<bf*>(act), og, rows,
                                       n_exp, h_dim, i_dim, ap, stream);
    if (err != 0) return err;
  }
  return 0;
}

template <typename T, int RB>
int launch_rb(const void* x, const void* wg, const void* wu, const void* wd, const void* ve,
              const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb, int n_exp,
              int h_dim, int i_dim, cudaStream_t stream) {
  constexpr int COLS = 32 / RB;
  const int row_tiles = (nb + RB - 1) / RB;
  const dim3 g1(n_exp, (i_dim + WARPS * COLS - 1) / (WARPS * COLS), row_tiles);
  swiglu_kernel<T, RB><<<g1, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const int*>(ve), static_cast<const int*>(valid), static_cast<T*>(act), nb, h_dim, i_dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(n_exp, (h_dim + WARPS * COLS - 1) / (WARPS * COLS), row_tiles);
  down_kernel<T, RB><<<g2, NT, 0, stream>>>(
      static_cast<const T*>(act), static_cast<const T*>(wd), static_cast<const int*>(ve),
      static_cast<const int*>(valid), static_cast<const float*>(w_visit), static_cast<float*>(yw), nb, i_dim,
      h_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_out = nb * h_dim;
  combine_kernel<T><<<(n_out + NT - 1) / NT, NT, 0, stream>>>(
      static_cast<const float*>(yw), static_cast<const int*>(valid), static_cast<T*>(out), n_exp, n_out);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT = T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, const void* ve, const void* valid,
           const void* w_visit, void* act, void* yw, void* out, int nb, int n_exp, int h_dim, int i_dim,
           void* stream) {
  if (nb <= 0 || n_exp <= 0 || h_dim <= 0 || i_dim <= 0 || h_dim % 8 || i_dim % 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    return launch_tc<OutT>(x, wg, wu, wd, ve, valid, w_visit, act, out, nb, n_exp, h_dim, i_dim, act_stride(i_dim),
                           s);
  } else {
    if (nb <= 8) return launch_rb<T, 8>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, s);
    if (nb <= 16)
      return launch_rb<T, 16>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, s);
    return launch_rb<T, 32>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, s);
  }
}

}  // namespace

// x [B, H]; wg / wu [E, I, H]; wd [E, H, I]; ve / valid [E] int32; w_visit
// [E, B] f32; out [B, H]. Workspaces: f32 act [E, B, I] and yw [E, B, H];
// bf16 act [E, min(B, 32), act_stride(I)] and no yw (null). out is x's type,
// or f32 for moe_decode_bf16_out_f32 (bf16 x and experts).
extern "C" int moe_decode_f32(const void* x, const void* wg, const void* wu, const void* wd, const void* ve,
                              const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb,
                              int n_exp, int h_dim, int i_dim, void* stream) {
  return launch<float>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim, stream);
}

extern "C" int moe_decode_bf16(const void* x, const void* wg, const void* wu, const void* wd, const void* ve,
                               const void* valid, const void* w_visit, void* act, void* yw, void* out, int nb,
                               int n_exp, int h_dim, int i_dim, void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim,
                               stream);
}

extern "C" int moe_decode_bf16_out_f32(const void* x, const void* wg, const void* wu, const void* wd,
                                       const void* ve, const void* valid, const void* w_visit, void* act, void* yw,
                                       void* out, int nb, int n_exp, int h_dim, int i_dim, void* stream) {
  return launch<__nv_bfloat16, float>(x, wg, wu, wd, ve, valid, w_visit, act, yw, out, nb, n_exp, h_dim, i_dim,
                                      stream);
}

// The visit schedule of F and J in one launch (the semantics of
// ops/moe_decode.py's distinct_schedule and combine_table): one block of E
// threads; thread e flags whether any row selected expert e, its rank
// among the flagged gives its visit; visits past the n distinct ones repeat
// the last distinct id with valid 0; w_visit[v, b] is the sum of row b's
// routing weights for visit v's expert (0 for a pad visit). idx int64 and
// wts f32 [B, k], rows ld apart; ve / valid int32 [E]; w_visit f32 [E, B].
// The block first copies idx and wts to shared memory, all threads at once:
// every thread then scans all B k of them, and read from global memory one
// after another those scans took 14.6 us a call at B 16 (a 16-slot decode
// step's profile on an H100 80GB HBM3 at 700 W), 9 % of F.
namespace {

size_t schedule_smem(int nb, int k, int n_exp) {
  return (size_t)nb * k * (sizeof(long long) + sizeof(float)) + 2 * n_exp * sizeof(int);
}

__global__ void schedule_kernel(const long long* __restrict__ idx, const float* __restrict__ wts, int nb, int k,
                                int ld, int n_exp, int* __restrict__ ve, int* __restrict__ valid,
                                float* __restrict__ w_visit) {
  extern __shared__ __align__(8) unsigned char sh_raw[];
  const int nk = nb * k;
  long long* sidx = reinterpret_cast<long long*>(sh_raw);  // [B k], then their weights [B k]
  float* swts = reinterpret_cast<float*>(sidx + nk);
  int* present = reinterpret_cast<int*>(swts + nk);  // [E], then the distinct ids [E]
  int* ids = present + n_exp;
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int b = i / k;
    sidx[i] = idx[(size_t)b * ld + i - b * k];
    swts[i] = wts[(size_t)b * ld + i - b * k];
  }
  __syncthreads();
  const int e = threadIdx.x;
  int p = 0;
  for (int i = 0; i < nk; ++i) p |= sidx[i] == e;
  present[e] = p;
  __syncthreads();
  int rank = 0, n_distinct = 0;
  for (int j = 0; j < n_exp; ++j) {
    rank += j < e ? present[j] : 0;
    n_distinct += present[j];
  }
  if (p) ids[rank] = e;
  __syncthreads();
  const int v = e;  // thread e also writes visit v = e
  const bool ok = v < n_distinct;
  // An id outside [0, E) (another rank's expert under EP) matches no thread:
  // no visit. With no visit at all, every pad repeats expert 0.
  const int vid = n_distinct > 0 ? ids[ok ? v : n_distinct - 1] : 0;
  ve[v] = vid;
  valid[v] = ok;
  for (int b = 0; b < nb; ++b) {
    float w = 0.f;
    for (int j = 0; j < k; ++j) w += sidx[b * k + j] == vid ? swts[b * k + j] : 0.f;
    w_visit[(size_t)v * nb + b] = ok ? w : 0.f;
  }
}

}  // namespace

extern "C" int moe_decode_schedule(const void* idx, const void* wts, int nb, int k, int ld, int n_exp, void* ve,
                                   void* valid, void* w_visit, void* stream) {
  if (nb <= 0 || k <= 0 || ld < k || n_exp <= 0 || n_exp > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = schedule_smem(nb, k, n_exp);
  if (smem > 48 * 1024) {  // above the default: B k beyond about 3400
    const cudaError_t err = cudaFuncSetAttribute(schedule_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  schedule_kernel<<<1, n_exp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const float*>(wts), nb, k, ld, n_exp, static_cast<int*>(ve),
      static_cast<int*>(valid), static_cast<float*>(w_visit));
  return (int)cudaGetLastError();
}
