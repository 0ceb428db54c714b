// Fused ViT MLP for sm_90a, kernel C: out = gelu_erf(x W1^T + b1) W2^T + b2.
//
// Replaces the Pallas TPU kernel _mlp_kernel of
// deepseek_ocr2_tpu/ops/fused_mlp.py (every SAM block's MLP: 768 -> 3072 ->
// 768 over 4096 tokens a 1024^2 view, 2304 a 768^2 crop).
//
// Rounding points are those of the TPU kernel and of the XLA form it
// mirrors, for T = bf16 (identity for f32):
//   h = round_T(f32 dot) ; h = round_T(h + b1) ; g = round_T(gelu(h) in f32)
//   out = round_T(round_T(f32 sum over F of g * W2) + b2)
// GELU is the exact form 0.5 h (1 + erf(h / sqrt 2)) with CUDA's erff (at
// most 2 ulp); the TPU kernel had to use a 1.5e-7-accurate polynomial.
//
// What bounds it: operations. 2 * 2 * M * 768 * 3072 FLOP, 38.7 GFLOP at M =
// 4096: 0.039 ms on the bf16 tensor cores, 0.234 ms in f32 taken as three
// TF32 products (below), against 19 MB (bf16) of inputs and outputs.
//
// Design: two launches of one tensor-core GEMM with fused epilogues, both
// products in HF's [out, in] layout, so both operands are K-major:
//   up:   g [M, F] = epilogue_up(x [M, E] . W1 [F, E]^T)   (+ b1, GELU)
//   down: out [M, E] = epilogue_down(g . W2 [E, F]^T)        (+ b2)
// The intermediate g goes through device memory in T (25 MB in bf16 at M =
// 4096, within the 50 MB L2; under 0.01 ms of traffic). One fused launch
// would hold a 64-row tile's 768 f32 outputs in registers (384 a thread) or
// recompute the up product for each split of the output columns (1.5-2x the
// FLOPs); the TPU kernel's fusion was a VMEM choice.
//
// The GEMM (mlp_gemm_kernel) is the TMA + wgmma row-block kernel of E
// (moe_gmm.cu, gmm_rows_wgmma_kernel<0>) with one group: a persistent grid
// of at most one block an SM walks the items i = blockIdx.x, + gridDim.x, ...
// of (128-row block, BN-column block), the column blocks of a row block
// next to each other so that they read its rows from L2 together. A block
// is 288 threads: warp 8 produces (its lane 0 issues every TMA load into a
// ring of stages with "full" and "empty" mbarriers), warpgroups 0 and 1
// consume, rows 64 g .. 64 g + 63 of the item each, by all BN columns. A
// stage is one 128-byte row of K for every row: A [128 rows][128 B] and W
// [BN rows][128 B] (64 bf16 or 32 f32 of K), 128-byte swizzled; loads past
// M, N or K read zeros; as many stages as fit in 224 KB beside the f32 low
// parts and the bf16 output tile, at most 4.
// - bf16: wgmma m64n{BN}k16, four k16 steps a stage, each item's products
//   summed over its whole K in the wgmma accumulator. The up product takes
//   BN = 256 (F = 3072: 12 column blocks).
// - f32: 3xTF32. TF32 alone keeps 10 mantissa bits; each operand is split
//   in the stage, in place, into hi = rna_tf32(v) and lo = rna_tf32(v - hi)
//   (lo into a buffer of the stage's layout), and each k8 step runs wgmma
//   m64n{BN}k8.tf32 three times: lo(A) hi(W), hi(A) lo(W), hi(A) hi(W),
//   summed in f32 (the lo * lo term, 2^-22 relative, is dropped). wgmma
//   reads the upper 19 bits of each word, so storing rna-rounded values
//   makes its operands exact. The 256 consumer threads split stage t + 1
//   together while stage t's products run (two buffers of low parts, by
//   stage parity; a named barrier of the consumers after each stage keeps a
//   buffer from being rewritten before both warpgroups' products have read
//   it). The tensor cores' f32 sums drop what falls below the sum's last
//   bit instead of rounding it: over K = 3072 that reached 1e-4, the whole
//   f32 tolerance. So each stage's 12 products go into the wgmma
//   accumulator from zero, and the thread adds it to a second one, rounding
//   to nearest; the two hold 128 columns' registers at most (up: BN = 128).
// - The down product (E = 768 columns) takes the wider of two widths (bf16
//   192, f32 128) or the narrower (128, 96), whichever leaves fewer
//   item-waves times width (`narrow_down`): at M = 2304 the wider one's 72
//   (bf16) items leave 60 of 132 SMs idle.
// What bounds it, measured (`scripts/torch_mlp_ablate.py`, M = 4096): not
// the products alone. Without any wgmma, bf16 keeps three quarters of its
// time (the up product's epilogue, erff GELU and all, while the tensor
// cores wait; without the GELU 0.069 against 0.086 ms) and f32 about 75 %
// (each stage's split, 0.19 ms, and the L2-to-SM traffic: each 128-row
// block reads its W again, 1.1 GB at f32). Taking f32's A from registers
// (wgmma's register form, A split there) spilled at the 168 registers a
// thread that a 288-thread block gets and ran slower (0.62 ms).
// Epilogue: each thread finishes its accumulators (row 16 (warp % 4) +
// lane / 4 + 8 h of its warpgroup's 64, columns 8 j + 2 (lane % 4) + {0,
// 1}): bias, GELU (up), the rounding points. bf16 writes them into a
// swizzled smem tile that one thread stores by TMA, draining while the next
// item runs (pairs stored straight from the threads left each 32-byte
// sector half-written, and those stores took two fifths of the bf16 time
// at M = 4096; with TMA C takes 0.088 against 0.098 ms); f32 stores them
// as pairs straight to device memory, a quad of lanes writing 32
// contiguous bytes (5 % of its time). Meanwhile the producer already
// loads the next item's stages.
//
// Layout: x [M, E], w1 [F, E], b1 [F], w2 [E, F], b2 [E], g [M, F] (the
// wrapper's workspace), out [M, E], contiguous, 16-byte aligned; E and F
// multiples of 8. Any M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK = 288;       // two consumer warpgroups + the producer warp
constexpr int PRODUCER_WARP = 8;
constexpr int CONSUMER_WARPS = 8;
constexpr int BM = 128;          // rows an item, 64 a consumer warpgroup
constexpr int ROW_BYTES = 128;   // a stage's K extent a row: one swizzle span
constexpr int SPLIT_BAR = 3;     // named barrier of the 256 consumer threads (f32)
constexpr int UP = 0, DOWN = 1;  // epilogues

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int BK = 64, K_STEP = 16, UP_BN = 256, DOWN_BN = 192, DOWN_BN_SMALL = 128;
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct Cfg<float> {
  static constexpr int BK = 32, K_STEP = 8, UP_BN = 128, DOWN_BN = 128, DOWN_BN_SMALL = 96;
  static constexpr bool SPLIT = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T, int BN>
struct Smem {
  static constexpr int STAGE = (BM + BN) * ROW_BYTES;  // A rows, then W rows
  static constexpr int LO = Cfg<T>::SPLIT ? 2 * STAGE : 0;  // f32: the low parts of two stages
  static constexpr int OUT = Cfg<T>::SPLIT ? 0 : BM * BN * 2;  // bf16: the item's rounded outputs, for TMA
  static constexpr int FIT = (224 * 1024 - LO - OUT) / STAGE;  // stages in 224 KB beside LO and OUT
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int RING = STAGES * STAGE;
  // from a 1024-byte aligned base (the swizzle atom); the slack covers it
  static constexpr int BYTES = RING + LO + OUT + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int N>
  __device__ __forceinline__ void next() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// 0.5 h (1 + erf(h / sqrt 2)) with CUDA's erff (at most 2 ulp). The TPU
// kernel's 1.5e-7 polynomial (a correctly rounded reciprocal and an
// exponential) measured slower here: 0.0957 against 0.0858 ms for C in bf16
// at M = 4096 (`scripts/torch_mlp_ablate.py`, variant as_erf).
__device__ __forceinline__ float gelu_erf(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int BN>
__device__ __forceinline__ void mma(float (&acc)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (!Cfg<T>::SPLIT) {
    if constexpr (BN == 256) sm90::wgmma_m64n256k16<0, 0>(acc, da, db);
    else if constexpr (BN == 192) sm90::wgmma_m64n192k16(acc, da, db);
    else sm90::wgmma_m64n128k16(acc, da, db);
  } else if constexpr (BN == 128) {
    sm90::wgmma_m64n128k8_tf32(acc, da, db);
  } else {
    sm90::wgmma_m64n96k8_tf32(acc, da, db);
  }
}

// f32: a stage split in place into its tf32 high parts and, into lo (the
// stage's layout), its low parts, by the 256 consumer threads; the writes
// made visible to wgmma (the async proxy).
template <int STAGE>
__device__ __forceinline__ void split_stage(unsigned char* st, unsigned char* lo) {
  for (int i = threadIdx.x; i < STAGE / 16; i += CONSUMER_WARPS * 32) {
    float4* p = reinterpret_cast<float4*>(st) + i;
    const float4 v = *p;
    const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
    *p = h;
    reinterpret_cast<float4*>(lo)[i] =
        make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
  }
  sm90::fence_proxy_async();
}

// f32's epilogue: v[4 j + 2 h + c] is the sum of row r0 + 16 (warp % 4) +
// lane / 4 + 8 h and column n0 + 8 j + 2 (lane % 4) + c (r0: the
// warpgroup's first row); biased, (up) GELU'd and stored in pairs, a quad
// of lanes writing 32 contiguous bytes.
template <int BN, int EPI>
__device__ __forceinline__ void epilogue_f32(const float (&v)[BN / 2], const float* __restrict__ bias,
                                             float* __restrict__ out, int r0, int n0, int m, int n, int warp,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= n) continue;  // n is a multiple of 8: a pair is in or out
    const float2 b = load2(bias + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * (warp % 4) + lane / 4 + 8 * h;
      if (row >= m) continue;
      float v0 = v[4 * j + 2 * h] + b.x, v1 = v[4 * j + 2 * h + 1] + b.y;
      if constexpr (EPI == UP) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(v0, v1);
    }
  }
}

// bf16's epilogue, at the TPU kernel's rounding points: the warpgroup's 64
// rows (from r0) rounded into its smem tile and stored by TMA: whole
// 128-byte rows go out, where
// each thread's stores of pairs left every 32-byte sector half-written (the
// stores took two fifths of C's bf16 time at M = 4096). The tile is BN / 64
// boxes of [32 rows][64 columns] for each of the two 32-row halves, each
// 128-byte row swizzled as the loads' boxes (16-byte chunk c of row r at c
// ^ (r % 8)): row rl, column cl sit in box (rl / 32) * (BN / 64) + cl / 64,
// row rl % 32, chunk (cl % 64) / 8. The store clips rows past m and
// columns past n, and drains while the next item loads and multiplies; the
// tile is written again only once its last store has read it.
constexpr int OUT_BOX = 32 * 64 * 2;  // a [32 rows][64 columns] bf16 box

template <int BN, int EPI>
__device__ __forceinline__ void epilogue_tma(const float (&v)[BN / 2], const bf16* __restrict__ bias,
                                             const CUtensorMap* map_out, unsigned char* tile, int r0, int n0, int m,
                                             int n, int warp, int lane) {
  const int wg = warp / 4;
  if (threadIdx.x % 128 == 0) sm90::bulk_wait_read<0>();
  sm90::bar_sync(1 + wg, 128);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * (lane % 4);
    const float2 b = n0 + cl < n ? load2(bias + n0 + cl) : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 16 * (warp % 4) + lane / 4 + 8 * h, rr = rl % 32;
      float v0 = round_bf16(round_bf16(v[4 * j + 2 * h]) + b.x);
      float v1 = round_bf16(round_bf16(v[4 * j + 2 * h + 1]) + b.y);
      if constexpr (EPI == UP) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      const int off = ((rl / 32) * (BN / 64) + cl / 64) * OUT_BOX + rr * 128 + ((((cl % 64) / 8) ^ (rr % 8)) * 16) +
                      (cl % 8) * 2;
      *reinterpret_cast<__nv_bfloat162*>(tile + off) = __floats2bfloat162_rn(v0, v1);
    }
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      if (r0 + 32 * rt >= m) break;
#pragma unroll
      for (int jb = 0; jb < BN / 64; ++jb)
        if (n0 + 64 * jb < n) sm90::tma_store_2d(map_out, tile + (rt * (BN / 64) + jb) * OUT_BOX, n0 + 64 * jb, r0 + 32 * rt);
    }
    sm90::bulk_commit();
  }
}

// out [m, n] = epilogue(a [m, k] . w [n, k]^T): the up (+ b1, GELU) or down
// (+ b2) half of C. See the header.
template <typename T, int BN, int EPI>
__global__ void __launch_bounds__(BLOCK, 1) mlp_gemm_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_out, const T* __restrict__ bias, T* __restrict__ out, int m, int n,
    int k) {
  using C = Cfg<T>;
  using S = Smem<T, BN>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* lo = smem + S::RING;  // f32: two buffers of low parts, by stage parity
  unsigned char* tile = lo + S::LO;    // bf16: the item's outputs, 64 rows x BN a warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + S::OUT);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_cb = (n + BN - 1) / BN, n_k = (k + C::BK - 1) / C::BK;
  const int n_items = (m + BM - 1) / BM * n_cb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      Ring ring;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int r0 = item / n_cb * BM, n0 = item % n_cb * BN;
        for (int ks = 0; ks < n_k; ++ks, ring.next<STAGES>()) {
          sm90::mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * S::STAGE;
          sm90::mbar_arrive_expect_tx(bar, S::STAGE);
          sm90::tma_load_2d(st, &map_a, bar, ks * C::BK, r0);
          sm90::tma_load_2d(st + BM * ROW_BYTES, &map_w, bar, ks * C::BK, n0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[BN / 2];
  if constexpr (!C::SPLIT) {
    // bf16: each item's products accumulate over its whole K in acc.
    Ring ring;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int ks = 0; ks < n_k; ++ks, ring.next<STAGES>()) {
        sm90::mbar_wait(&full[ring.stage], ring.phase);
        unsigned char* st = smem + ring.stage * S::STAGE;
        const uint64_t da = sm90::desc_sw128(st + wg * 64 * ROW_BYTES, 16, 1024);
        const uint64_t db = sm90::desc_sw128(st + BM * ROW_BYTES, 16, 1024);
        sm90::fence_acc(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BK / C::K_STEP; ++kk)
          mma<T, BN>(acc, sm90::desc_add(da, 32 * kk), sm90::desc_add(db, 32 * kk));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(acc);
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&empty[ring.stage]);
      }
      epilogue_tma<BN, EPI>(acc, bias, &map_out, tile + wg * (S::OUT / 2), item / n_cb * BM + 64 * wg,
                            item % n_cb * BN, m, n, warp, lane);
    }
    if (threadIdx.x % 128 == 0) sm90::bulk_wait<0>();  // the last item's stores are done
  } else {
    // f32: the consumers walk their stages t = 0, 1, ... over all their
    // items (n_k an item). Each stage's products go into acc from zero and
    // are added to sum (round to nearest): the tensor cores' own f32 sums
    // drop what falls below the sum's last bit, an error that grows with K
    // (1e-4 at K = 3072 when summed over the whole K in acc). Stage t + 1
    // is split while stage t's products run (the two low-part buffers
    // alternate), and a barrier of the 256 consumers after each stage keeps
    // a buffer from being split again before both warpgroups' products
    // have read it.
    float sum[BN / 2];
    const int n_stages = blockIdx.x < n_items ? ((n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * n_k : 0;
    Ring ring;
    if (n_stages > 0) {
      sm90::mbar_wait(&full[0], 0);
      split_stage<S::STAGE>(smem, lo);
      sm90::bar_sync(SPLIT_BAR, CONSUMER_WARPS * 32);
    }
    for (int t = 0; t < n_stages; ++t) {
      const int ks = t % n_k, item = blockIdx.x + t / n_k * gridDim.x;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        acc[i] = 0.f;
        if (ks == 0) sum[i] = 0.f;
      }
      unsigned char* st = smem + ring.stage * S::STAGE;
      unsigned char* lo_t = lo + (t & 1) * S::STAGE;
      const uint64_t da = sm90::desc_sw128(st + wg * 64 * ROW_BYTES, 16, 1024);
      const uint64_t db = sm90::desc_sw128(st + BM * ROW_BYTES, 16, 1024);
      const uint64_t la = sm90::desc_sw128(lo_t + wg * 64 * ROW_BYTES, 16, 1024);
      const uint64_t lb = sm90::desc_sw128(lo_t + BM * ROW_BYTES, 16, 1024);
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / C::K_STEP; ++kk) {
        const uint32_t off = 32 * kk;  // a k step is 32 bytes along the swizzled row
        mma<T, BN>(acc, sm90::desc_add(la, off), sm90::desc_add(db, off));
        mma<T, BN>(acc, sm90::desc_add(da, off), sm90::desc_add(lb, off));
        mma<T, BN>(acc, sm90::desc_add(da, off), sm90::desc_add(db, off));
      }
      sm90::wgmma_commit();
      Ring nxt = ring;
      nxt.next<STAGES>();
      if (t + 1 < n_stages) {
        sm90::mbar_wait(&full[nxt.stage], nxt.phase);
        split_stage<S::STAGE>(smem + nxt.stage * S::STAGE, lo + ((t + 1) & 1) * S::STAGE);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[ring.stage]);
      sm90::bar_sync(SPLIT_BAR, CONSUMER_WARPS * 32);
      ring = nxt;
      if (ks + 1 == n_k)
        epilogue_f32<BN, EPI>(sum, bias, out, item / n_cb * BM + 64 * wg, item % n_cb * BN, m, n, warp, lane);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

// out [m, n] = epilogue(a [m, k] . w [n, k]^T) on mlp_gemm_kernel.
template <typename T, int BN, int EPI>
int launch_gemm(const void* a, const void* w, const void* bias, void* out, int m, int n, int k, int sms,
                cudaStream_t s) {
  using C = Cfg<T>;
  CUtensorMap map_a, map_w, map_out = {};
  const uint64_t dims_a[2] = {(uint64_t)k, (uint64_t)m}, dims_w[2] = {(uint64_t)k, (uint64_t)n};
  const uint64_t dims_out[2] = {(uint64_t)n, (uint64_t)m};
  const uint32_t box_a[2] = {C::BK, BM}, box_w[2] = {C::BK, BN}, box_out[2] = {64, 32};
  int err = sm90::make_map(&map_a, C::MAP, sizeof(T), 2, a, dims_a, box_a);
  if (!err) err = sm90::make_map(&map_w, C::MAP, sizeof(T), 2, w, dims_w, box_w);
  if (!err && !C::SPLIT) err = sm90::make_map(&map_out, C::MAP, sizeof(T), 2, out, dims_out, box_out);
  auto kernel = mlp_gemm_kernel<T, BN, EPI>;
  if (!err) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, BN>::BYTES);
  if (err) return err;
  const int items = (m + BM - 1) / BM * ((n + BN - 1) / BN);
  kernel<<<items < sms ? items : sms, BLOCK, Smem<T, BN>::BYTES, s>>>(
      map_a, map_w, map_out, static_cast<const T*>(bias), static_cast<T*>(out), m, n, k);
  return (int)cudaGetLastError();
}

// The down product's column width: of its two widths the one whose items
// take the fewer item-waves of the grid, times the width (an item's time
// grows with its width at a fixed K): at E = 768 the narrower one keeps
// more SMs busy where the wider one's items leave the last wave part-empty.
template <typename T>
bool narrow_down(int m, int e, int sms) {
  constexpr int W = Cfg<T>::DOWN_BN, NW = Cfg<T>::DOWN_BN_SMALL;
  const long rows = (m + BM - 1) / BM;
  const long waves_w = (rows * ((e + W - 1) / W) + sms - 1) / sms;
  const long waves_nw = (rows * ((e + NW - 1) / NW) + sms - 1) / sms;
  return waves_nw * NW < waves_w * W;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* g, void* out,
           int m, int e, int f, void* stream) {
  if (m <= 0 || e <= 0 || f <= 0 || e % 8 || f % 8) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_gemm<T, Cfg<T>::UP_BN, UP>(x, w1, b1, g, m, f, e, sms, s);
  if (err) return err;
  return narrow_down<T>(m, e, sms) ? launch_gemm<T, Cfg<T>::DOWN_BN_SMALL, DOWN>(g, w2, b2, out, m, e, f, sms, s)
                                   : launch_gemm<T, Cfg<T>::DOWN_BN, DOWN>(g, w2, b2, out, m, e, f, sms, s);
}

}  // namespace

// x [M, E], w1 [F, E], b1 [F], w2 [E, F], b2 [E]; g [M, F] the workspace
// of the intermediate (written, then read, on the stream); out [M, E].
extern "C" int mlp_gelu_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* g,
                            void* out, int m, int e, int f, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, g, out, m, e, f, stream);
}

extern "C" int mlp_gelu_bf16(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* g,
                             void* out, int m, int e, int f, void* stream) {
  return launch<bf16>(x, w1, b1, w2, b2, g, out, m, e, f, stream);
}
