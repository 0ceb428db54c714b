// Grouped-GEMM MoE for sm_90a: the expert-aligned prefill kernels D and E,
// the backward kernels S and T, and the boundary-visit forward W.
//
// Replaces the Pallas TPU kernels of deepseek_ocr2_tpu/ops/moe_gmm.py:
//   D  gmm_swiglu  <- _gmm_swiglu_kernel_al: act = round(round(silu(round(x Wg^T))) * round(x Wu^T))
//   E  gmm_down    <- _gmm_down_kernel_al:   y   = round(act Wd^T)
//                     and, in the backward, _gmm_down_kernel (the
//                     recompute of gate, up and y is E three times)
//   S  gmm_dx      <- _gmm_dx_kernel:        out = round(a W_e), W_e [O, C]
//                     contracted on its row dim (dact, dx_gate, dx_up)
//   T  gmm_dw      <- _gmm_dw_kernel:        dW_e = sum over e's tiles of
//                     dy_t^T x_t, [E, O, C] in f32
// Run one after the other D and E also replace _gmm_ffn_kernel_al, the fused
// visit the JAX package launches by default: it rounds act at the same
// point, so the pair gives the same bits. round() is to the working type T
// (identity for f32); every sum is accumulated in f32, silu is f32.
//
// Layout (built on the device by ops/moe_gmm.py, with no host sync): the
// token -> expert assignments are sorted by expert and each expert's group
// is padded to a multiple of BM = 32 rows, so row tile t of x [S, K] holds
// rows of one expert only, e_tile[t]; pad rows are zero. The grid is the
// static worst case, T = S / BM tiles. A tile past the last group has
// tile_valid[t] == 0 and its blocks return at once (the wrapper zeroes the
// output, so those rows read as zero); the bf16 kernels D, E and S zero
// those rows themselves.
//
// Weights keep HF's [out, in] layout, stacked over experts (Wg, Wu
// [E, I, H], Wd [E, H, I]), so both operands of each GEMM are contiguous
// along K: out = x W^T.
//
// What bounds it: each layer's expert weights from HBM once (440 MB in
// bf16 for the three matrices at H = 1280, I = 896, 64 experts: 0.13 ms at
// 3.35 TB/s), and the repeats of each weight slice from L2. A design that
// reads an expert's weights once per 32-row tile reuses each element for
// 32 rows: 32 FLOP per byte of L2 traffic, far below the ~295 FLOP per
// byte at which the H100's bf16 tensor cores would outrun HBM.
// - bf16 (the LM's dtype on the main path): D, E and S run one kernel,
//   gmm_rows_wgmma_kernel (below): wgmma fed by TMA through an mbarrier
//   ring (sm90.cuh) on a persistent walk of (row block of up to 128 rows of
//   one expert, column block) items, so each weight slice is read once per
//   128 rows. D takes 128 columns of I an item and both weights a stage
//   (gate and up, two m64n128k16 chains), with the SwiGLU epilogue. T:
//   wgmma on (expert, 128 x 256 outputs) items. D before this walk was a
//   32-row mma.sync kernel on a (tile, 64-column) grid fed by cp.async,
//   which re-read the expert's whole 4.6 MB of gate||up for every 32-row
//   tile (0.6 GB from L2 at N 550): 0.1880 ms in a CUDA graph, 49 % of its
//   bound at N 550 (PERF.md). D's bound at N 550 is its selected experts'
//   gate and up (294 MB, 0.088 ms) plus the rows; the walk reads the
//   weights about once per expert from L2 at that shape (most experts hold
//   one row block) and the block's rows once per 128 columns.
// - f32 (full f32, no TF32): FMAs on the CUDA cores, whose 67 TFLOP/s peak
//   makes it compute-bound. 8 row groups x 16 column groups of threads
//   each hold a 4 x TN tile of the sums, fed by float4 reads of x and the
//   weights, both staged transposed in shared memory; grid (T, ceil(N /
//   BN)), BN 64 for D (two weights), 128 for E and S.
// BM = 32 keeps the pad rows at ~16 per expert (they cost full FMAs in f32).
//
// Two launches, not one fused visit: at crop sizes a page has ~100-300
// valid tiles, fewer than one block per SM each if a tile were one block,
// as on the TPU's sequential grid; D's and E's walks spread each row
// block's columns over 7 (D, I = 896 by 128) or 5 (E, H = 1280 by 256)
// items. The [S, I] activation makes one round trip through HBM (13 MB in
// bf16 at S = 7424, a few microseconds).
//
// Shapes: N a multiple of 4, K a multiple of 4 (f32) or 8 (bf16: 16-byte
// copies), x and the weights 16-byte aligned (checked by the wrapper);
// ragged K and N edges are masked here.
//
// The backward (S, T) on the same layout and tiles. Both read every operand
// as it lies: the transposes are the wgmma operand modes in bf16 and the
// staging order in f32.
// - S replaces _gmm_dx_kernel (deepseek_ocr2_tpu/ops/moe_gmm.py:381):
//   out = round(a_t W_e), the weight [O, C] contracted on its rows. bf16: a
//   persistent grid walks work items of a row block of up to 4 tiles (128
//   rows) of one expert by 256 columns, so it reads each [O, 256] weight
//   slice once per 128 rows, not once per 32-row tile, and each item's
//   epilogue leaves by TMA stores that drain under the next item. Bound at
//   the dact shape (12 288 rows, O 1280, C 896, 64 experts): about 0.2 GB
//   of bytes (the real rows in and out, the experts' weights once), 0.060
//   ms at 3.35 TB/s. L2 traffic: weight reads about 0.96 GB with one block
//   per 32-row tile (the mma.sync design this replaced), about 0.3 GB with
//   128-row blocks; the rows about 0.29 GB read once per 128 columns, 0.17
//   GB once per 256. f32: D/E's f32 kernel reading the weight's [BK, BN]
//   slices as they lie (WKN), grid (T, ceil(C / 128)).
// - E in bf16 is the same kernel with the weight [N, K] read K-major (its
//   HF layout): out = round(act W_e^T); D in bf16 the same with two such
//   weights. The recompute's gate shape (12 288
//   rows, K 1280, N 896) is S's dact shape with the weight read the other
//   way, and the same L2 arithmetic holds: the 32-row mma.sync kernel it
//   replaced re-read each expert's weight slice for every tile.
// - T replaces _gmm_dw_kernel (moe_gmm.py:440): dW_e = sum over e's tiles
//   of dy_t^T x_t in f32, the tiles in order, no atomics; an expert with no
//   rows gets zeros. It contracts over rows, the slow dim of both operands.
//   bf16: a persistent grid walks (expert, 128 o x 256 c) work items,
//   expert slowest; the f32 sums leave through TMA stores that overlap the
//   next item. Bound at dW_gate (O 896, C 1280): the 293.6 MB f32 write
//   plus 53.5 MB of rows, 0.104 ms. L2 traffic of the rows: about 0.88 GB
//   with 64 x 64 blocks (the design this replaced: every (O, C) block pair
//   rereads its expert's rows), 0.46 GB with 128 x 128 items, 0.35 GB with
//   128 x 256. f32: one block per (64 c, 64 o, expert), 32 outer products
//   per thread per row.
//
// Kernel W replaces the boundary-visit forward of the same file, which the
// aligned D + E superseded and which no path of the JAX package calls:
//   swiglu mode  <- _gmm_swiglu_kernel: act = D's function
//   ffn mode     <- _gmm_ffn_kernel:    y = E(D(x)), the act rounded where
//                   the split pair rounds it
// on the boundary-visit schedule (ops/moe_gmm.visit_schedule, the port of
// _visit_schedule): x [m_pad, H] holds the expert-sorted rows unpadded, and
// visit v covers row tile vt[v] (bm = 32 or 64 rows, _pick_bm) against
// expert ve[v], writing only the rows in [lo[v], hi[v]) (an empty visit
// writes nothing). Visits that share a tile write disjoint rows: no atomics
// and no read-modify-write. Rows [m, m_pad) are written by no visit.
// A block is one BM = 32-row part of a visit (a 64-row tile is two parts),
// VisitRows below; a part with no row in [lo, hi) returns at once.
// - swiglu mode: D's kernel with VisitRows, grid (V bm / 32, ceil(I / BN)).
// - ffn mode: one block per part runs the whole FFN: phase 1 computes the
//   part's act for all I columns with D's sums into shared memory, phase 2
//   reads it back as the A operand of E's sums. The act never leaves the
//   SM. At bm = 64 and I = 896 a whole tile's f32 act (229 KB) would not fit
//   the 227 KB a block may use; the part's 32 rows (bf16 57 KB, f32 129 KB
//   transposed) do, so the block's rows are halved rather than staged
//   through global memory.
//   What bounds it: as D + E, streaming each visit's three expert matrices
//   (6.9 MB in bf16) from L2 / HBM; one block per part is V bm / 32 blocks
//   (232 at the (2, 1) crop page's 3288 rows), two waves at most, each
//   block walking 14 + 10 column blocks in turn. W runs on no path of
//   either package: the aligned D + E pair is the port's grouped GEMM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 32;    // rows per tile: one expert
constexpr int BK = 32;    // K slice staged per step
constexpr int TM = 4;     // rows per thread
constexpr int NTY = BM / TM;  // 8 row groups
constexpr int NTX = 16;   // column groups
constexpr int NT = NTY * NTX;  // 128 threads

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// ---------------------------------------------------------------------------
// Which rows a block computes and writes.
// AlignedRows (D, E, S in f32): block b is row tile b, all of one expert, e_tile[b];
// every row is written, or none when tile_valid[b] is 0.
// VisitRows (W): block b is the BM-row part b % sub of visit v = b / sub
// (sub = bm / BM): rows vt[v] bm + (b % sub) BM + [0, BM) of the
// expert-sorted x, expert ve[v]; only the rows in [lo[v], hi[v]) are
// written, and a part that holds none of them returns at once.
struct AlignedRows {
  const int* e_tile;
  const int* tile_valid;
  __device__ bool get(int b, int& row0, int& e, int& lo, int& hi) const {
    if (!tile_valid[b]) return false;
    row0 = b * BM;
    e = e_tile[b];
    lo = row0;
    hi = row0 + BM;
    return true;
  }
};

struct VisitRows {
  const int* vt;
  const int* ve;
  const int* v_lo;
  const int* v_hi;
  int bm;
  __device__ bool get(int b, int& row0, int& e, int& lo, int& hi) const {
    const int sub = bm / BM, v = b / sub;
    row0 = vt[v] * bm + (b % sub) * BM;
    e = ve[v];
    lo = max(v_lo[v], row0);
    hi = min(v_hi[v], row0 + BM);
    return lo < hi;
  }
};

// ---------------------------------------------------------------------------
// f32 on the CUDA cores.
//
// One (tile, column block) of out = f(x W0^T [, x W1^T]).
// NW = 2: kernel D (W0 = Wg, W1 = Wu, SwiGLU epilogue), TN = 4, BN = 64.
// NW = 1: kernel E (W0 = Wd), TN = 8, BN = 128.
// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the tile and the columns
// 4 tx + 64 j + {0..3}, j < TN / 4 (consecutive lanes read consecutive
// float4s of the staged weights: no bank conflicts).
// WKN (kernel S): the weight is [K, N] (rows along K) instead of [N, K];
// its slices are staged as they lie.

constexpr int XS = BM + 4;  // row stride of a transposed [K][XS] copy of a tile's rows

// The sums acc[w][i][j] = sum_k A[4 ty + i, k] W_w[col(j), k] (WKN:
// W_w[k, col(j)]) of thread (ty, tx), col(j) = n0 + 4 tx + 64 (j / 4) + j % 4.
// A is the tile's rows of x at xt (row stride k_dim), staged a BK slice at a
// time into xs [BK][XS], or (a_s not null) a transposed [K'][XS] copy that
// is already in shared memory, K' >= k_dim rounded up to BK, zero past
// k_dim. ws holds NW [BK][BN + 4] weight slices. Starts with a barrier, so
// the buffers of a previous call may be reused.
template <int NW, int TN, bool WKN>
__device__ __forceinline__ void f32_sums(const float* __restrict__ xt, const float* a_s,
                                         const float* const (&wp)[NW], int n0, int k_dim, int n_dim, float* xs,
                                         float* ws, float (&acc)[NW][TM][TN]) {
  constexpr int BN = NTX * TN;
  constexpr int WS = BN + 4;  // row stride of a transposed weight slice [BK][WS]
  const int tid = threadIdx.x;
  const int ty = tid / NTX, tx = tid % NTX;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[w][i][j] = 0.f;

  for (int k0 = 0; k0 < k_dim; k0 += BK) {
    __syncthreads();  // the previous slice is consumed
    if (a_s == nullptr) {
      for (int i = tid; i < BM * (BK / 4); i += NT) {
        // Lanes on consecutive rows: conflict-free transposed stores; the
        // rest of each 32-byte sector is read by the next warp, from L1.
        const int r = i % BM, kc = 4 * (i / BM);
        const float4 v = k0 + kc < k_dim ? *reinterpret_cast<const float4*>(xt + (size_t)r * k_dim + k0 + kc)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        xs[(kc + 0) * XS + r] = v.x;
        xs[(kc + 1) * XS + r] = v.y;
        xs[(kc + 2) * XS + r] = v.z;
        xs[(kc + 3) * XS + r] = v.w;
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float* wsw = ws + w * BK * WS;
      if (WKN) {
        for (int i = tid; i < BK * (BN / 4); i += NT) {
          const int kr = i / (BN / 4), nc = 4 * (i % (BN / 4));
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k0 + kr < k_dim && n0 + nc < n_dim)
            v = *reinterpret_cast<const float4*>(wp[w] + (size_t)(k0 + kr) * n_dim + n0 + nc);
          *reinterpret_cast<float4*>(wsw + kr * WS + nc) = v;
        }
        continue;
      }
      for (int i = tid; i < BN * (BK / 4); i += NT) {
        const int n = i % BN, kc = 4 * (i / BN);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 + n < n_dim && k0 + kc < k_dim)
          v = *reinterpret_cast<const float4*>(wp[w] + (size_t)(n0 + n) * k_dim + k0 + kc);
        wsw[(kc + 0) * WS + n] = v.x;
        wsw[(kc + 1) * WS + n] = v.y;
        wsw[(kc + 2) * WS + n] = v.z;
        wsw[(kc + 3) * WS + n] = v.w;
      }
    }
    __syncthreads();
    const float* ak = a_s == nullptr ? xs : a_s + (size_t)k0 * XS;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(ak + k * XS + ty * TM);
      const float av[TM] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int jj = 0; jj < TN / 4; ++jj) {
          const float4 b = *reinterpret_cast<const float4*>(ws + w * BK * WS + k * WS + tx * 4 + 64 * jj);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[w][i][4 * jj + 0] = fmaf(av[i], b.x, acc[w][i][4 * jj + 0]);
            acc[w][i][4 * jj + 1] = fmaf(av[i], b.y, acc[w][i][4 * jj + 1]);
            acc[w][i][4 * jj + 2] = fmaf(av[i], b.z, acc[w][i][4 * jj + 2]);
            acc[w][i][4 * jj + 3] = fmaf(av[i], b.w, acc[w][i][4 * jj + 3]);
          }
        }
      }
    }
  }
}

// Thread (ty, tx)'s outputs of f32_sums (NW = 2: silu(gate) up), to
// out[row rs + col cs] for tile rows row = row0 + 4 ty + i in [lo, hi) and
// columns col < n_dim (rs, cs: n_dim, 1 for a row-major output; 1, XS for
// a transposed copy in shared memory).
template <int NW, int TN>
__device__ __forceinline__ void f32_store(float* out, const float (&acc)[NW][TM][TN], int row0, int lo, int hi,
                                          int n0, int n_dim, int rs, int cs) {
  const int ty = threadIdx.x / NTX, tx = threadIdx.x % NTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row < lo || row >= hi) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * 4 + 64 * (j / 4) + j % 4;
      if (col < n_dim)
        out[(size_t)row * rs + (size_t)col * cs] = NW == 2 ? silu(acc[0][i][j]) * acc[NW - 1][i][j] : acc[0][i][j];
    }
  }
}

template <int NW, int TN, bool WKN, class Rows>
__global__ void __launch_bounds__(NT) gmm_kernel(
    const float* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ w1, Rows rows,
    float* __restrict__ out, int k_dim, int n_dim) {
  constexpr int BN = NTX * TN;
  __shared__ __align__(16) float xs[BK * XS];
  __shared__ __align__(16) float ws[NW * BK * (BN + 4)];

  int row0, e, lo, hi;
  if (!rows.get(blockIdx.x, row0, e, lo, hi)) return;
  const int n0 = blockIdx.y * BN;
  const float* wp[NW];
  wp[0] = w0 + (size_t)e * n_dim * k_dim;
  if (NW > 1) wp[NW - 1] = w1 + (size_t)e * n_dim * k_dim;
  float acc[NW][TM][TN];
  f32_sums<NW, TN, WKN>(x + (size_t)row0 * k_dim, nullptr, wp, n0, k_dim, n_dim, xs, ws, acc);
  f32_store<NW, TN>(out, acc, row0, lo, hi, n0, n_dim, n_dim, 1);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores for kernel W: mma.sync m16n8k16 (bf16 in, f32
// sums).
//
// The f32 kernels' (tile, column block) grid and epilogue. 4 warps: warp w takes
// rows 16 (w % 2) .. +15 of the tile and half of the BN columns, NJ = BN / 16
// n8 tiles. K is streamed in 64-wide slices, copied with cp.async into a
// double buffer (16-byte chunks, zero-filled past the K and N edges) while
// the previous slice is multiplied. x and the weights are both staged as
// they lie in memory, K fastest, with rows padded to 72 elements: a
// fragment word at (row g, k 2t) then sits in bank 4g + t, so the 32 lanes
// of a fragment load hit 32 banks.

constexpr int MK = 64;       // K slice
constexpr int MS = MK + 8;   // row stride of a staged slice, in bf16

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The sums of one (BM-row tile, BN column block) of x W0^T [, x W1^T] on the
// tensor cores, acc[w][j] the accumulators of the warp's n8 tile j. A is
// the tile's rows of x at xt (row stride k_dim), copied a MK slice at a time
// into xs [2][BM][MS], or (a_s not null) a [BM][as] copy already in shared
// memory, zero from k_dim to k_dim rounded up to MK (as: a multiple of 8
// and 4 mod 64 in 32-bit words, so fragment loads hit 32 banks). ws holds
// [2][NW][BN][MS] weight slices. Ends with a barrier, so the buffers may be
// reused by the next call.
template <int NW, int BN>
__device__ __forceinline__ void mma_sums(const __nv_bfloat16* __restrict__ xt, const __nv_bfloat16* a_s, int as,
                                         const __nv_bfloat16* const (&wp)[NW], int n0, int k_dim, int n_dim,
                                         __nv_bfloat16* xs, __nv_bfloat16* ws, float (&acc)[NW][BN / 16][4]) {
  constexpr int NJ = BN / 16;  // n8 tiles per warp
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;  // fragment row / column pair
  const int wm = 16 * (warp % 2), wn = (BN / 2) * (warp / 2);

  auto stage = [&](int buf, int k0) {
    if (a_s == nullptr) {
      for (int i = tid; i < BM * (MK / 8); i += NT) {
        const int r = i / (MK / 8), kc = 8 * (i % (MK / 8));
        const bool full = k0 + kc < k_dim;
        cp_async16(&xs[buf * BM * MS + r * MS + kc], full ? xt + (size_t)r * k_dim + k0 + kc : xt, full);
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      __nv_bfloat16* wsw = ws + (buf * NW + w) * BN * MS;
      for (int i = tid; i < BN * (MK / 8); i += NT) {
        const int n = i / (MK / 8), kc = 8 * (i % (MK / 8));
        const bool full = n0 + n < n_dim && k0 + kc < k_dim;
        cp_async16(&wsw[n * MS + kc], full ? wp[w] + (size_t)(n0 + n) * k_dim + k0 + kc : wp[w], full);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[w][j][c] = 0.f;

  const int n_slices = (k_dim + MK - 1) / MK;
  stage(0, 0);
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s % 2;
    if (s + 1 < n_slices) {
      stage(buf ^ 1, (s + 1) * MK);  // the buffer read in step s - 1, freed by its closing barrier
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* abase = a_s == nullptr ? xs + buf * BM * MS : a_s + s * MK;
    const int astr = a_s == nullptr ? MS : as;
#pragma unroll
    for (int kk = 0; kk < MK; kk += 16) {
      const __nv_bfloat16* xa = abase + (wm + g) * astr + kk + 2 * q;
      unsigned a[4];
      a[0] = *reinterpret_cast<const unsigned*>(xa);
      a[1] = *reinterpret_cast<const unsigned*>(xa + 8 * astr);
      a[2] = *reinterpret_cast<const unsigned*>(xa + 8);
      a[3] = *reinterpret_cast<const unsigned*>(xa + 8 * astr + 8);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const __nv_bfloat16* wb = ws + (buf * NW + w) * BN * MS + (wn + 8 * j + g) * MS + kk + 2 * q;
          mma_bf16(acc[w][j], a, *reinterpret_cast<const unsigned*>(wb),
                   *reinterpret_cast<const unsigned*>(wb + 8));
        }
      }
    }
    __syncthreads();  // everyone is done with buf before it is refilled
  }
}

// The warp's outputs of mma_sums (NW = 2: round(round(silu(round(gate)))
// round(up))), to out[row os + col] for tile rows row = row0 + r in
// [lo, hi) and columns col < n_dim (n_dim a multiple of 4).
template <int NW, int BN>
__device__ __forceinline__ void mma_store(__nv_bfloat16* out, const float (&acc)[NW][BN / 16][4], int row0, int lo,
                                          int hi, int n0, int n_dim, int os) {
  constexpr int NJ = BN / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int wm = 16 * (warp % 2), wn = (BN / 2) * (warp / 2);
  // Accumulator c of n8 tile j: row g (c < 2) or g + 8, column 2q + c % 2.
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn + 8 * j + 2 * q;
    if (col >= n_dim) continue;  // n_dim is a multiple of 4: col + 1 is in range too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm + g + 8 * h;
      if (row < lo || row >= hi) continue;
      float v[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (NW == 2) {
          const float gate = round_bf16(acc[0][j][2 * h + c]);
          const float up = round_bf16(acc[NW - 1][j][2 * h + c]);
          v[c] = round_bf16(silu(gate)) * up;
        } else {
          v[c] = acc[0][j][2 * h + c];
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * os + col) = __floats2bfloat162_rn(v[0], v[1]);
    }
  }
}

template <int NW, int BN, class Rows>
__global__ void __launch_bounds__(NT) gmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
    const __nv_bfloat16* __restrict__ w1, Rows rows, __nv_bfloat16* __restrict__ out, int k_dim, int n_dim) {
  __shared__ __align__(16) __nv_bfloat16 xs[2 * BM * MS];
  __shared__ __align__(16) __nv_bfloat16 ws[2 * NW * BN * MS];

  int row0, e, lo, hi;
  if (!rows.get(blockIdx.x, row0, e, lo, hi)) return;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* wp[NW];
  wp[0] = w0 + (size_t)e * n_dim * k_dim;
  if (NW > 1) wp[NW - 1] = w1 + (size_t)e * n_dim * k_dim;
  float acc[NW][BN / 16][4];
  mma_sums<NW, BN>(x + (size_t)row0 * k_dim, nullptr, 0, wp, n0, k_dim, n_dim, xs, ws, acc);
  mma_store<NW, BN>(out, acc, row0, lo, hi, n0, n_dim, n_dim);
}

// ---------------------------------------------------------------------------
// bf16 kernels D, S, E and T on Hopper: TMA loads into a ring of shared-memory
// stages (one producer warp, mbarriers "full" and "empty" per stage), two
// consumer warpgroups that run wgmma (m64n256k16; D two m64n128k16) on the stages that have
// arrived (sm90.cuh). A block is 288 threads: warpgroups 0 and 1 consume,
// warp 8 produces (its lane 0 issues every copy). Every operand is read as
// it lies in memory; the transposes are wgmma's operand modes, so no
// transposed copy and no ldmatrix.trans.

constexpr int WG_BLOCK = 288;         // two consumer warpgroups + the producer warp
constexpr int PRODUCER_WARP = 8;
constexpr int CONSUMER_WARPS = 8;     // each releases a stage: the "empty" barrier's count
constexpr int SX_TILES = 4;           // D, S, E: a work item's rows, up to 4 tiles (128 rows) of one expert
constexpr int SX_ROWS = SX_TILES * BM;
constexpr int SX_BN = 256;            // S, E: a work item's output columns
constexpr int SX_BK = 64;             // D, S, E: k per stage, one 128-byte row of bf16
constexpr int SX_STAGES = 3;
constexpr int SX_A_BYTES = SX_ROWS * SX_BK * 2;           // [128 rows][64 k]: 16 KB
constexpr int SX_B_BOX = SX_BK * 64 * 2;                  // a 64 k x 64 n weight box: 8 KB
constexpr int SX_STAGE_BYTES = SX_A_BYTES + SX_BN / 64 * SX_B_BOX;  // + 64 k x 256 n as four boxes: 48 KB
constexpr int SX_OUT_BOX = BM * 64 * 2;                   // an output box, [32 rows][64 n] bf16: 4 KB
constexpr int DW_TILE_O = 128;        // T: a work item's o extent (64 a warpgroup)
constexpr int DW_TILE_C = 256;        // T: a work item's c extent
constexpr int DW_STAGES = 4;
constexpr int DW_BOX_BYTES = BM * 64 * 2;                 // a [32 rows][64] bf16 box: 4 KB
constexpr int DW_STAGE_BYTES = (DW_TILE_O + DW_TILE_C) / 64 * DW_BOX_BYTES;  // dy 2 boxes, x 4: 24 KB
constexpr int DW_OUT_BYTES = 64 * DW_TILE_C * 4;          // a warpgroup's [64 o][256 c] f32: 64 KB

// Dynamic shared memory: the stages from a 1024-byte aligned base (the
// swizzle atom), then the output tiles, then the barriers; the slack
// covers the alignment. S and E take 214 064 bytes (below), T 230 464, within the
// 232 448 a block may use.
constexpr int DW_SMEM = DW_STAGES * DW_STAGE_BYTES + 2 * DW_OUT_BYTES + 2 * DW_STAGES * 8 + 1024;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// Stage ring position: the stage index and the phase parity of its barriers.
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

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int n_stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// A consumer warp is done with a stage: its wgmma reads have completed.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) sm90::mbar_arrive(empty);
}

// Kernels S, E and D in bf16, one kernel on the row tiles of the aligned
// layout, a [S, K], the weights [E, ...] read as they lie:
// - KIND ROWS_N_MAJOR (S): out [S, N] = round(a_t W_e), W [E, O, C]
//   contracted on its rows, K = O, N = C, each row of the weight along N;
// - KIND ROWS_K_MAJOR (E): out = round(a_t W_e^T), W [E, N, K] in HF's
//   [out, in] layout, each row along K;
// - KIND ROWS_SWIGLU (D): act [S, I] = round(round(silu(round(a_t Wg_e^T)))
//   * round(a_t Wu_e^T)), Wg and Wu [E, I, H] K-major as E's, K = H, N = I.
//
// A persistent grid of at most one block per SM walks the work items i =
// blockIdx.x, + gridDim.x, ...; item i is (row block b, column block) =
// (i / n_cb, i % n_cb) of BN columns (256 for S and E, 128 of I for D), the
// column blocks of one row block next to each other so that they run
// together and read the block's rows from L2. Row block b of expert e
// covers its tiles tile_lo[e] + 4 (b - blk_lo[e]) + [0, 4), clipped at
// tile_lo[e + 1]: blk_lo is the wrapper's prefix of ceil(tiles / 4) over
// the experts (`row_block_lo`), and the item finds its expert by a binary
// search on it (`dx_row_blocks` in ops/moe_gmm.py is the same map). Row
// blocks past blk_lo[E] zero the rows of the invalid tail tiles, 4 tiles
// each (the ceil(T / 4) + E + 1 rows of the walk cover every case); the
// rest are skipped. A warpgroup whose 64 rows hold no tile of the expert
// (a row block of one or two tiles) waits on and frees the stages but
// multiplies nothing.
//
// Each stage: A = a [128 rows][64 k] (K-major; warpgroup g multiplies rows
// 64 g .. 64 g + 63), B = four 8 KB weight boxes. S and E: the expert's
// [64 k] x [256 n] slice, m64n256k16: S [64 k][64 n] boxes (N-major:
// wgmma's transposed B; a k16 step is 16 rows, 2048 bytes on), E [64 n][64
// k] boxes (K-major, as A: the four boxes are one [256 n][64 k] operand
// with 1024 bytes between 8-row groups; a k16 step is 32 bytes on). D: two
// [64 n][64 k] boxes of gate, then two of up, each pair one [128 n][64 k]
// K-major operand, and two m64n128k16 chains a k16 step, gate into acc[0,
// 64) and up into acc[64, 128): the same 48 KB stage and the same 128
// accumulators a thread as E. The A box is the block's 128 rows whatever
// the clip (rows of the next expert, or zeros past the end). k past K and
// n past N read zeros (the weights' maps are 3-D with the expert outermost,
// so a box never reaches the next expert). S and E take 256 columns, not
// 128: a block's rows are read from L2 once per 256 columns (0.17 GB of row
// reads at the dact shape instead of 0.29).
//
// Epilogue: each warpgroup rounds its sums (D: the SwiGLU of gate and up at
// the rounding points above) to bf16 into its tile ([32 rows][64 n] boxes,
// 128-byte swizzled: no bank conflicts; eight for S and E, four for D) and
// one thread stores the boxes of the expert's row tiles with TMA (the next
// expert's rows in the block are not stored; columns past N are clipped).
// The store drains while the next item loads and multiplies; `wait_group.read
// 0` holds the tile until the store has read it.
constexpr int ROWS_K_MAJOR = 0, ROWS_N_MAJOR = 1, ROWS_SWIGLU = 2;

template <int KIND>
constexpr int ROWS_BN = KIND == ROWS_SWIGLU ? 128 : SX_BN;  // a work item's columns
// D's output tiles are half of S's and E's (128 columns), which leaves room
// for a fourth stage: 230 464 bytes of shared memory.
template <int KIND>
constexpr int ROWS_STAGES = KIND == ROWS_SWIGLU ? 4 : SX_STAGES;
template <int KIND>
constexpr int ROWS_OUT_BYTES = 2 * ROWS_BN<KIND> / 64 * SX_OUT_BOX;  // a warpgroup's [64 rows][BN]
template <int KIND>
constexpr int ROWS_SMEM = ROWS_STAGES<KIND> * SX_STAGE_BYTES + 2 * ROWS_OUT_BYTES<KIND> + 2 * ROWS_STAGES<KIND> * 8 + 1024;

// D's epilogue on the f32 sums. silu in f32 with the fast exponential and
// division (a few f32 ulps, far below the bf16 rounding after it): with
// expf and an IEEE division the epilogue took a fifth of D's time at N 550
// (scripts/torch_gmm_ablate.py d_no_swiglu, PERF.md).
__device__ __forceinline__ float swiglu(float gate, float up) {
  const float g = round_bf16(gate);
  return round_bf16(__fdividef(g, 1.f + __expf(-g))) * round_bf16(up);
}

template <int KIND>
__global__ void __launch_bounds__(WG_BLOCK, 1) gmm_rows_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_w2, const __grid_constant__ CUtensorMap map_out,
    const int* __restrict__ tile_lo, const int* __restrict__ blk_lo, __nv_bfloat16* __restrict__ out,
    int n_experts, int n_tiles, int k_dim, int n_dim) {
  constexpr int BN = ROWS_BN<KIND>, STAGES = ROWS_STAGES<KIND>, OUT_BYTES = ROWS_OUT_BYTES<KIND>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* out_smem = smem + STAGES * SX_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_smem + 2 * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty, STAGES);
  const int n_blocks = blk_lo[n_experts];
  const int n_cb = (n_dim + BN - 1) / BN, n_k = (k_dim + SX_BK - 1) / SX_BK;
  const int n_items = ((n_tiles + SX_TILES - 1) / SX_TILES + n_experts + 1) * n_cb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Row block b < n_blocks: its expert and first tile.
  auto row_block = [&](int b, int& e, int& t0) {
    int hi = n_experts;  // blk_lo[e] <= b < blk_lo[hi]
    e = 0;
    while (hi - e > 1) {
      const int mid = (e + hi) / 2;
      if (blk_lo[mid] <= b) e = mid; else hi = mid;
    }
    t0 = tile_lo[e] + SX_TILES * (b - blk_lo[e]);
  };

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      Ring ring;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int b = item / n_cb, n0 = item % n_cb * BN;
        if (b >= n_blocks) continue;
        int e, t0;
        row_block(b, e, t0);
        for (int ks = 0; ks < n_k; ++ks, ring.next<STAGES>()) {
          sm90::mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * SX_STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(bar, SX_STAGE_BYTES);
          sm90::tma_load_2d(st, &map_a, bar, ks * SX_BK, t0 * BM);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            unsigned char* dst = st + SX_A_BYTES + j * SX_B_BOX;
            if (KIND == ROWS_N_MAJOR)
              sm90::tma_load_3d(dst, &map_w, bar, n0 + 64 * j, ks * SX_BK, e);
            else if (KIND == ROWS_K_MAJOR)
              sm90::tma_load_3d(dst, &map_w, bar, ks * SX_BK, n0 + 64 * j, e);
            else  // gate's two boxes, then up's
              sm90::tma_load_3d(dst, j < 2 ? &map_w : &map_w2, bar, ks * SX_BK, n0 + 64 * (j % 2), e);
          }
        }
      }
    }
    return;
  }

  const int wg = warp / 4, tid = threadIdx.x % 128;
  unsigned char* ob = out_smem + wg * OUT_BYTES;
  Ring ring;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int b = item / n_cb, n0 = item % n_cb * BN;
    if (b >= n_blocks) {  // the invalid tail's rows read as zeros
      const int t0 = tile_lo[n_experts] + SX_TILES * (b - n_blocks);
      if (t0 >= n_tiles) continue;
      const int r0 = t0 * BM, r1 = min(t0 + SX_TILES, n_tiles) * BM;
      const int chunks = min(BN, n_dim - n0) / 8;  // n_dim is a multiple of 8
      for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += 256)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + i / chunks) * n_dim + n0 + 8 * (i % chunks)) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    int e, t0;
    row_block(b, e, t0);
    const int t_end = min(t0 + SX_TILES, tile_lo[e + 1]);
    const bool live = t0 + 2 * wg < t_end;  // this warpgroup's rows hold a tile of the expert

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int ks = 0; ks < n_k; ++ks, ring.next<STAGES>()) {
      sm90::mbar_wait(&full[ring.stage], ring.phase);
      if (live) {
        const unsigned char* st = smem + ring.stage * SX_STAGE_BYTES;
        const uint64_t da = sm90::desc_sw128(st + wg * 64 * 128, 16, 1024);
        const uint64_t db = sm90::desc_sw128(st + SX_A_BYTES, KIND == ROWS_N_MAJOR ? SX_B_BOX : 16, 1024);
        sm90::fence_acc(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SX_BK / 16; ++kk) {
          const uint64_t dak = sm90::desc_add(da, 32 * kk);
          if constexpr (KIND == ROWS_SWIGLU) {
            sm90::wgmma_m64n128k16<0>(acc, dak, sm90::desc_add(db, 32 * kk));
            sm90::wgmma_m64n128k16<64>(acc, dak, sm90::desc_add(db, 2 * SX_B_BOX + 32 * kk));
          } else {
            sm90::wgmma_m64n256k16<0, KIND>(acc, dak, sm90::desc_add(db, (KIND == ROWS_N_MAJOR ? 16 * 128 : 32) * kk));
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(acc);
      }
      release(&empty[ring.stage]);
    }
    if (!live) continue;

    // acc[4 j + 2 h + c] (D: gate, up acc[64 + ..]): row rl = 16 (warp % 4)
    // + lane / 4 + 8 h of the warpgroup's 64, column cl = 8 j + 2 (lane % 4)
    // + c of BN: box (rl / 32) (BN / 64) + cl / 64, row rl % 32, 16-byte
    // chunk (cl % 64) / 8 swizzled with rl % 8.
    if (tid == 0) sm90::bulk_wait_read<0>();
    sm90::bar_sync(1 + wg, 128);
    // Warps 2 and 3 of the warpgroup hold its second tile's rows: none to
    // round where that tile is not the expert's.
    const bool rows_live = t0 + 2 * wg + (warp % 4) / 2 < t_end;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (!rows_live) break;
      const int cl = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 16 * (warp % 4) + lane / 4 + 8 * h, rr = rl % 32;
        const int off = ((rl / 32) * (BN / 64) + cl / 64) * SX_OUT_BOX + rr * 128 +
                        ((((cl % 64) / 8) ^ (rr % 8)) * 16) + (cl % 8) * 2;
        const int a = 4 * j + 2 * h;
        __nv_bfloat162 v;
        if constexpr (KIND == ROWS_SWIGLU)
          v = __floats2bfloat162_rn(swiglu(acc[a], acc[64 + a]), swiglu(acc[a + 1], acc[65 + a]));
        else
          v = __floats2bfloat162_rn(acc[a], acc[a + 1]);
        *reinterpret_cast<__nv_bfloat162*>(ob + off) = v;
      }
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        const int t = t0 + 2 * wg + rt;
        if (t >= t_end) break;
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          if (n0 + 64 * j < n_dim) sm90::tma_store_2d(&map_out, ob + (rt * (BN / 64) + j) * SX_OUT_BOX, n0 + 64 * j, t * BM);
      }
      sm90::bulk_commit();
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();
}

// Kernel T in bf16: dW [E, O, C] f32, dW[e] = sum over e's tiles t of
// dy_t^T x_t (dy [S, O], x [S, C] on the aligned layout's row tiles).
//
// A persistent grid of at most one block per SM walks the work items i =
// blockIdx.x, + gridDim.x, ...; item i is (expert e, o block, c block) of
// 128 x 256 outputs, expert slowest (`dw_work_items` in ops/moe_gmm.py is
// the same order): the blocks in flight work on one or two experts at a
// time, whose rows stay in L2. The producer streams the expert's tiles
// tile_lo[e] .. tile_lo[e + 1] - 1 in order, a stage each: dy [32 rows][128
// o] and x [32 rows][256 c] as [32][64] boxes (loads past O or C read
// zeros). Warpgroup g sums o rows 64 g .. 64 g + 63 by all 256 c: A = dy^T
// from its box (M-major: wgmma's transposed A), B = x (N-major: transposed
// B), two k16 steps of m64n256k16 a stage. The tiles are summed in order,
// no atomics; an expert with no tiles gets zeros. 256 c, not 128: the
// kernel is bound by L2 traffic (the stage reads and the f32 stores), and
// wider items read the rows 25 % fewer times.
//
// Epilogue: each warpgroup writes its f32 sums into its 64 KB tile (eight
// [64 o][32 c] boxes, 128-byte swizzled like the loads: 2-way bank
// conflicts at most) and one thread stores them with TMA (3-D map: a store
// is clipped at the expert's O and at C). The store of item i drains while
// item i + 1 loads and multiplies; `wait_group.read 0` before the tile is
// written again holds it until the store has read it. (Storing the tile in
// two halves, each reused once its own store has been read, measured no
// faster: the write stream itself sets T's time.)
__global__ void __launch_bounds__(WG_BLOCK, 1) gmm_dw_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_dy, const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_dw, const int* __restrict__ tile_lo, int n_experts, int o_dim,
    int c_dim) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* out_smem = smem + DW_STAGES * DW_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_smem + 2 * DW_OUT_BYTES);
  uint64_t* empty = full + DW_STAGES;
  init_ring(full, empty, DW_STAGES);
  const int n_ot = (o_dim + DW_TILE_O - 1) / DW_TILE_O, n_ct = (c_dim + DW_TILE_C - 1) / DW_TILE_C;
  const int n_items = n_experts * n_ot * n_ct;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      Ring ring;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int e = item / (n_ot * n_ct), oc = item % (n_ot * n_ct);
        const int o0 = oc / n_ct * DW_TILE_O, c0 = oc % n_ct * DW_TILE_C;
        const int t1 = tile_lo[e + 1];
        for (int t = tile_lo[e]; t < t1; ++t, ring.next<DW_STAGES>()) {
          sm90::mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * DW_STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(bar, DW_STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < DW_TILE_O / 64; ++j)
            sm90::tma_load_2d(st + j * DW_BOX_BYTES, &map_dy, bar, o0 + 64 * j, t * BM);
#pragma unroll
          for (int j = 0; j < DW_TILE_C / 64; ++j)
            sm90::tma_load_2d(st + (DW_TILE_O / 64 + j) * DW_BOX_BYTES, &map_x, bar, c0 + 64 * j, t * BM);
        }
      }
    }
    return;
  }

  const int wg = warp / 4, tid = threadIdx.x % 128;
  unsigned char* ob = out_smem + wg * DW_OUT_BYTES;
  Ring ring;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int e = item / (n_ot * n_ct), oc = item % (n_ot * n_ct);
    const int o0 = oc / n_ct * DW_TILE_O, c0 = oc % n_ct * DW_TILE_C;
    const int t1 = tile_lo[e + 1];
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int t = tile_lo[e]; t < t1; ++t, ring.next<DW_STAGES>()) {
      sm90::mbar_wait(&full[ring.stage], ring.phase);
      const unsigned char* st = smem + ring.stage * DW_STAGE_BYTES;
      const uint64_t da = sm90::desc_sw128(st + wg * DW_BOX_BYTES, DW_BOX_BYTES, 1024);
      const uint64_t db = sm90::desc_sw128(st + DW_TILE_O / 64 * DW_BOX_BYTES, DW_BOX_BYTES, 1024);
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
      sm90::wgmma_m64n256k16<1, 1>(acc, da, db);
      sm90::wgmma_m64n256k16<1, 1>(acc, sm90::desc_add(da, 16 * 128), sm90::desc_add(db, 16 * 128));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
      release(&empty[ring.stage]);
    }

    // acc[4 j + 2 h + c]: o row ol = 16 (warp % 4) + lane / 4 + 8 h of the
    // warpgroup's 64, column cl = 8 j + 2 (lane % 4) + c of 256: box cl / 32,
    // row ol, 16-byte chunk (cl % 32) / 4 swizzled with ol % 8.
    if (tid == 0) sm90::bulk_wait_read<0>();
    sm90::bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < DW_TILE_C / 8; ++j) {
      const int cl = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ol = 16 * (warp % 4) + lane / 4 + 8 * h;
        const int off = (cl / 32) * (64 * 128) + ol * 128 + ((((cl % 32) / 4) ^ (ol % 8)) * 16) + (cl % 4) * 4;
        *reinterpret_cast<float2*>(ob + off) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int box = 0; box < DW_TILE_C / 32; ++box)
        if (c0 + 32 * box < c_dim && o0 + 64 * wg < o_dim)
          sm90::tma_store_3d(&map_dw, ob + box * (64 * 128), c0 + 32 * box, o0 + 64 * wg, e);
      sm90::bulk_commit();
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();
}

// Kernel T in f32 on the CUDA cores. Block (blockIdx.x, blockIdx.y,
// blockIdx.z) = (C block, O block, expert) of DB x DB outputs, the expert's
// tiles summed in order (see the header).
constexpr int DB = 64;

// Thread (ty, tx) of 16 x 8 holds o rows
// 4 ty .. 4 ty + 3 and c columns 4 tx + 32 j + {0..3}, j < 2; per staged
// row, one float4 of dy and two of x (a warp reads 4 distinct dy float4s,
// broadcast, and 8 consecutive x float4s: no bank conflicts).
__global__ void __launch_bounds__(NT) gmm_dw_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dy, const int* __restrict__ tile_lo,
    float* __restrict__ dw, int c_dim, int o_dim) {
  constexpr int FS = DB + 4;  // 16-byte aligned rows
  __shared__ __align__(16) float ys[BM * FS];
  __shared__ __align__(16) float xs[BM * FS];

  const int c0 = blockIdx.x * DB, o0 = blockIdx.y * DB, e = blockIdx.z;
  const int t0 = tile_lo[e], t1 = tile_lo[e + 1];
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BM * (DB / 4); i += NT) {
      const int r = i / (DB / 4), cc = 4 * (i % (DB / 4));
      const size_t row = (size_t)t * BM + r;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(ys + r * FS + cc) =
          o0 + cc < o_dim ? *reinterpret_cast<const float4*>(dy + row * o_dim + o0 + cc) : zero;
      *reinterpret_cast<float4*>(xs + r * FS + cc) =
          c0 + cc < c_dim ? *reinterpret_cast<const float4*>(x + row * c_dim + c0 + cc) : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(ys + r * FS + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(xs + r * FS + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(xs + r * FS + 4 * tx + 32);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + 4 * ty + i;
    if (o >= o_dim) continue;
    float* orow = dw + ((size_t)e * o_dim + o) * c_dim;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 4 * tx + 32 * (j / 4) + j % 4;
      if (col < c_dim) orow[col] = acc[i][j];
    }
  }
}

bool bad_shape(int n_tiles, int bm, int k_dim, int n_dim, int k_align) {
  return bm != BM || n_tiles <= 0 || k_dim <= 0 || k_dim % k_align || n_dim <= 0 || n_dim % 4;
}

bool bad_visits(int n_visits, int bm, int k_dim, int n_dim, int k_align) {
  return n_visits <= 0 || bm <= 0 || bm % BM || k_dim <= 0 || k_dim % k_align || n_dim <= 0 || n_dim % 4;
}

AlignedRows aligned(const void* e_tile, const void* tile_valid) {
  return AlignedRows{static_cast<const int*>(e_tile), static_cast<const int*>(tile_valid)};
}

VisitRows visits(const void* vt, const void* ve, const void* lo, const void* hi, int bm) {
  return VisitRows{static_cast<const int*>(vt), static_cast<const int*>(ve), static_cast<const int*>(lo),
                   static_cast<const int*>(hi), bm};
}

template <int NW, int TN, bool WKN, class Rows>
int launch_f32(const void* x, const void* w0, const void* w1, Rows rows, int n_blocks, void* out, int k_dim,
               int n_dim, void* stream) {
  constexpr int BN = NTX * TN;
  const dim3 grid(n_blocks, (n_dim + BN - 1) / BN);
  gmm_kernel<NW, TN, WKN, Rows><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0), static_cast<const float*>(w1), rows,
      static_cast<float*>(out), k_dim, n_dim);
  return (int)cudaGetLastError();
}

template <int NW, int BN, class Rows>
int launch_bf16(const void* x, const void* w0, const void* w1, Rows rows, int n_blocks, void* out, int k_dim,
                int n_dim, void* stream) {
  using B = __nv_bfloat16;
  const dim3 grid(n_blocks, (n_dim + BN - 1) / BN);
  gmm_mma_kernel<NW, BN, Rows><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const B*>(x), static_cast<const B*>(w0), static_cast<const B*>(w1), rows,
      static_cast<B*>(out), k_dim, n_dim);
  return (int)cudaGetLastError();
}

// Kernel W, ffn mode, f32: one block per visit part (VisitRows). Phase 1
// computes the part's act = silu(x Wg^T) (x Wu^T) for all I columns, 64 at
// a time, into act_t, a transposed [I'][XS] copy in dynamic shared memory
// (I' = I rounded up to BK, zero past I: 129 KB at I = 896); phase 2 runs
// y = act Wd^T from it, 128 columns at a time, and writes the part's rows
// in [lo, hi). The same f32_sums and f32_store as D and E, so the sums are
// taken in their order.
template <class Rows>
__global__ void __launch_bounds__(NT) gmm_ffn_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ wg, const float* __restrict__ wu,
    const float* __restrict__ wd, Rows rows, float* __restrict__ y, int h_dim, int i_dim) {
  extern __shared__ __align__(16) float act_t[];
  __shared__ __align__(16) float xs[BK * XS];
  __shared__ __align__(16) float ws[2 * BK * (64 + 4)];  // two [BK][68] slices, or one [BK][132]

  int row0, e, lo, hi;
  if (!rows.get(blockIdx.x, row0, e, lo, hi)) return;
  const int i_pad = (i_dim + BK - 1) / BK * BK;
  for (int idx = i_dim * XS + threadIdx.x; idx < i_pad * XS; idx += NT) act_t[idx] = 0.f;
  const float* wgu[2] = {wg + (size_t)e * i_dim * h_dim, wu + (size_t)e * i_dim * h_dim};
  for (int n0 = 0; n0 < i_dim; n0 += NTX * 4) {
    float acc[2][TM][4];
    f32_sums<2, 4, false>(x + (size_t)row0 * h_dim, nullptr, wgu, n0, h_dim, i_dim, xs, ws, acc);
    f32_store<2, 4>(act_t, acc, 0, 0, BM, n0, i_dim, 1, XS);
  }
  const float* wdp[1] = {wd + (size_t)e * h_dim * i_dim};
  for (int n0 = 0; n0 < h_dim; n0 += NTX * 8) {
    float acc[1][TM][8];
    f32_sums<1, 8, false>(nullptr, act_t, wdp, n0, i_dim, h_dim, xs, ws, acc);
    f32_store<1, 8>(y, acc, row0, lo, hi, n0, h_dim, h_dim, 1);
  }
}

// Kernel W, ffn mode, bf16: as the f32 form on the tensor cores (mma_sums
// and mma_store of D and E). The part's act, rounded to bf16 where D
// rounds it, stays in dynamic shared memory as [BM][I' + 8] (I' = I rounded
// up to MK, zero past I: 57 KB at I = 896), and phase 2 reads its mma A
// fragments straight from there.
template <class Rows>
__global__ void __launch_bounds__(NT) gmm_ffn_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wg,
    const __nv_bfloat16* __restrict__ wu, const __nv_bfloat16* __restrict__ wd, Rows rows,
    __nv_bfloat16* __restrict__ y, int h_dim, int i_dim) {
  extern __shared__ __align__(16) unsigned char act_raw[];
  __shared__ __align__(16) __nv_bfloat16 xs[2 * BM * MS];
  __shared__ __align__(16) __nv_bfloat16 ws[2 * 2 * 64 * MS];  // [2][2][64][MS], or [2][1][128][MS]

  int row0, e, lo, hi;
  if (!rows.get(blockIdx.x, row0, e, lo, hi)) return;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(act_raw);
  const int i_pad = (i_dim + MK - 1) / MK * MK, as = i_pad + 8;
  const int n_zero = i_pad - i_dim;
  for (int idx = threadIdx.x; idx < BM * n_zero; idx += NT)
    act[(idx / n_zero) * as + i_dim + idx % n_zero] = __float2bfloat16_rn(0.f);
  const __nv_bfloat16* wgu[2] = {wg + (size_t)e * i_dim * h_dim, wu + (size_t)e * i_dim * h_dim};
  for (int n0 = 0; n0 < i_dim; n0 += 64) {
    float acc[2][4][4];
    mma_sums<2, 64>(x + (size_t)row0 * h_dim, nullptr, 0, wgu, n0, h_dim, i_dim, xs, ws, acc);
    mma_store<2, 64>(act, acc, 0, 0, BM, n0, i_dim, as);
  }
  const __nv_bfloat16* wdp[1] = {wd + (size_t)e * h_dim * i_dim};
  for (int n0 = 0; n0 < h_dim; n0 += 128) {
    float acc[1][8][4];
    mma_sums<1, 128>(nullptr, act, as, wdp, n0, i_dim, h_dim, xs, ws, acc);
    mma_store<1, 128>(y, acc, row0, lo, hi, n0, h_dim, h_dim);
  }
}

template <typename T, class Rows>
int launch_ffn(const void* x, const void* wg, const void* wu, const void* wd, Rows rows, int n_blocks, void* y,
               int h_dim, int i_dim, void* stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t smem = F32 ? sizeof(float) * ((i_dim + BK - 1) / BK * BK) * XS
                          : sizeof(__nv_bfloat16) * BM * ((i_dim + MK - 1) / MK * MK + 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F32) {
    auto kernel = gmm_ffn_f32_kernel<Rows>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_blocks, NT, smem, s>>>(static_cast<const float*>(x), static_cast<const float*>(wg),
                                      static_cast<const float*>(wu), static_cast<const float*>(wd), rows,
                                      static_cast<float*>(y), h_dim, i_dim);
  } else {
    using B = __nv_bfloat16;
    auto kernel = gmm_ffn_mma_kernel<Rows>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_blocks, NT, smem, s>>>(static_cast<const B*>(x), static_cast<const B*>(wg),
                                      static_cast<const B*>(wu), static_cast<const B*>(wd), rows,
                                      static_cast<B*>(y), h_dim, i_dim);
  }
  return (int)cudaGetLastError();
}

// S (KIND ROWS_N_MAJOR: w [E, K, N]), E (ROWS_K_MAJOR: w [E, N, K]) or D
// (ROWS_SWIGLU: w, w2 = gate, up [E, N, K]) in bf16 on
// gmm_rows_wgmma_kernel: a [S, K] -> out [S, N]. The tensor maps: a and
// out 2-D over the n_tiles * BM rows; the weights 3-D with the expert
// outermost, their boxes 64 wide along their contiguous dim.
template <int KIND>
int launch_rows_wgmma(const void* a, const void* w, const void* w2, const void* tile_lo, const void* blk_lo,
                      void* out, int n_tiles, int bm, int k_dim, int n_dim, int n_experts, int n_blocks,
                      void* stream) {
  if (bad_shape(n_tiles, bm, k_dim, n_dim, 8) || n_dim % 8 || n_experts <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool N_MAJOR = KIND == ROWS_N_MAJOR;
  CUtensorMap map_a, map_w, map_w2, map_out;
  const uint64_t rows = (uint64_t)n_tiles * BM;
  const uint64_t dims_a[2] = {(uint64_t)k_dim, rows}, dims_out[2] = {(uint64_t)n_dim, rows};
  const uint64_t dims_w[3] = {(uint64_t)(N_MAJOR ? n_dim : k_dim), (uint64_t)(N_MAJOR ? k_dim : n_dim),
                              (uint64_t)n_experts};
  const uint32_t box_a[2] = {SX_BK, SX_ROWS}, box_w[3] = {64, 64, 1}, box_out[2] = {64, BM};
  auto kernel = gmm_rows_wgmma_kernel<KIND>;
  int err = sm90::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, a, dims_a, box_a);
  if (!err) err = sm90::make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, w, dims_w, box_w);
  if (!err) err = sm90::make_map(&map_w2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, w2, dims_w, box_w);
  if (!err) err = sm90::make_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, out, dims_out, box_out);
  if (!err) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM<KIND>);
  if (err) return err;
  kernel<<<n_blocks, WG_BLOCK, ROWS_SMEM<KIND>, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_w, map_w2, map_out, static_cast<const int*>(tile_lo), static_cast<const int*>(blk_lo),
      static_cast<__nv_bfloat16*>(out), n_experts, n_tiles, k_dim, n_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// D: x [S, H], wg / wu [E, I, H] -> act [S, I].
extern "C" int gmm_swiglu_f32(const void* x, const void* wg, const void* wu, const void* e_tile,
                              const void* tile_valid, void* act, int n_tiles, int bm, int h,
                              int i, void* stream) {
  if (bad_shape(n_tiles, bm, h, i, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<2, 4, false>(x, wg, wu, aligned(e_tile, tile_valid), n_tiles, act, h, i, stream);
}

// D in bf16: x [S, H], wg / wu [E, I, H] and S's schedule (tile_lo, blk_lo,
// n_blocks: ops/moe_gmm.swiglu_grid) -> act [S, I], every row written, those
// of the invalid tail tiles with zeros.
extern "C" int gmm_swiglu_bf16(const void* x, const void* wg, const void* wu, const void* tile_lo,
                               const void* blk_lo, void* act, int n_tiles, int bm, int h, int i, int n_experts,
                               int n_blocks, void* stream) {
  return launch_rows_wgmma<ROWS_SWIGLU>(x, wg, wu, tile_lo, blk_lo, act, n_tiles, bm, h, i, n_experts, n_blocks,
                                        stream);
}

// E: act [S, I], wd [E, H, I] -> y [S, H].
extern "C" int gmm_down_f32(const void* act, const void* wd, const void* e_tile,
                            const void* tile_valid, void* y, int n_tiles, int bm, int i, int h,
                            void* stream) {
  if (bad_shape(n_tiles, bm, i, h, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<1, 8, false>(act, wd, wd, aligned(e_tile, tile_valid), n_tiles, y, i, h, stream);
}

// E in bf16: act [S, I], wd [E, H, I] and S's schedule (tile_lo, blk_lo,
// n_blocks; see gmm_dx_bf16) -> y [S, H], every row written.
extern "C" int gmm_down_bf16(const void* act, const void* wd, const void* tile_lo, const void* blk_lo, void* y,
                             int n_tiles, int bm, int i, int h, int n_experts, int n_blocks, void* stream) {
  return launch_rows_wgmma<ROWS_K_MAJOR>(act, wd, wd, tile_lo, blk_lo, y, n_tiles, bm, i, h, n_experts, n_blocks,
                                         stream);
}

// S: a [S, O], w [E, O, C] (contracted on O, its row dim) -> out [S, C].
extern "C" int gmm_dx_f32(const void* a, const void* w, const void* e_tile, const void* tile_valid,
                          void* out, int n_tiles, int bm, int o, int c, void* stream) {
  if (bad_shape(n_tiles, bm, o, c, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<1, 8, true>(a, w, w, aligned(e_tile, tile_valid), n_tiles, out, o, c, stream);
}

// S in bf16: tile_lo [E + 1] (expert e owns tiles tile_lo[e] .. tile_lo[e + 1]
// - 1) and blk_lo [E + 1] (its row blocks blk_lo[e] .. blk_lo[e + 1] - 1,
// ops/moe_gmm.row_block_lo), n_blocks the persistent grid (ops/moe_gmm.dx_grid)
// -> out [S, C]; every row is written, those of the invalid tail tiles with
// zeros.
extern "C" int gmm_dx_bf16(const void* a, const void* w, const void* tile_lo, const void* blk_lo, void* out,
                           int n_tiles, int bm, int o, int c, int n_experts, int n_blocks, void* stream) {
  return launch_rows_wgmma<ROWS_N_MAJOR>(a, w, w, tile_lo, blk_lo, out, n_tiles, bm, o, c, n_experts, n_blocks,
                                         stream);
}

// T: x [S, C], dy [S, O], tile_lo [E + 1] (expert e owns tiles
// tile_lo[e] .. tile_lo[e + 1] - 1) -> dw [E, O, C] f32, every element
// written.
extern "C" int gmm_dw_f32(const void* x, const void* dy, const void* tile_lo, void* dw, int n_experts,
                          int c, int o, void* stream) {
  if (n_experts <= 0 || n_experts > 65535 || c <= 0 || o <= 0 || c % 4 || o % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((c + DB - 1) / DB, (o + DB - 1) / DB, n_experts);
  gmm_dw_f32_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const int*>(tile_lo),
      static_cast<float*>(dw), c, o);
  return (int)cudaGetLastError();
}

// T in bf16: as gmm_dw_f32, with the rows' count n_rows (the tensor maps'
// extent) and the persistent grid's n_blocks (ops/moe_gmm.dw_schedule).
extern "C" int gmm_dw_bf16(const void* x, const void* dy, const void* tile_lo, void* dw, int n_experts,
                           int c, int o, int n_rows, int n_blocks, void* stream) {
  if (n_experts <= 0 || c <= 0 || o <= 0 || c % 8 || o % 8 || n_rows <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_dy, map_x, map_dw;
  const uint64_t dims_dy[2] = {(uint64_t)o, (uint64_t)n_rows}, dims_x[2] = {(uint64_t)c, (uint64_t)n_rows};
  const uint64_t dims_dw[3] = {(uint64_t)c, (uint64_t)o, (uint64_t)n_experts};
  const uint32_t box_rows[2] = {64, BM}, box_dw[3] = {32, 64, 1};
  int err = sm90::make_map(&map_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, dy, dims_dy, box_rows);
  if (!err) err = sm90::make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, x, dims_x, box_rows);
  if (!err) err = sm90::make_map(&map_dw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 3, dw, dims_dw, box_dw);
  if (!err) err = (int)cudaFuncSetAttribute(gmm_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err) return err;
  gmm_dw_wgmma_kernel<<<n_blocks, WG_BLOCK, DW_SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_dy, map_x, map_dw, static_cast<const int*>(tile_lo), n_experts, o, c);
  return (int)cudaGetLastError();
}

// W, swiglu mode: x [m_pad, H] (expert-sorted rows), wg / wu [E, I, H] and
// the visit schedule vt / ve / lo / hi [V] int32 -> act [m_pad, I]; only
// the rows of a visit's [lo, hi) are written (bm a multiple of 32).
extern "C" int gmm_swiglu_visit_f32(const void* x, const void* wg, const void* wu, const void* vt, const void* ve,
                                    const void* lo, const void* hi, void* act, int n_visits, int bm, int h, int i,
                                    void* stream) {
  if (bad_visits(n_visits, bm, h, i, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<2, 4, false>(x, wg, wu, visits(vt, ve, lo, hi, bm), n_visits * (bm / BM), act, h, i, stream);
}

extern "C" int gmm_swiglu_visit_bf16(const void* x, const void* wg, const void* wu, const void* vt, const void* ve,
                                     const void* lo, const void* hi, void* act, int n_visits, int bm, int h, int i,
                                     void* stream) {
  if (bad_visits(n_visits, bm, h, i, 8)) return (int)cudaErrorInvalidValue;
  return launch_bf16<2, 64>(x, wg, wu, visits(vt, ve, lo, hi, bm), n_visits * (bm / BM), act, h, i, stream);
}

// W, ffn mode: as the swiglu mode, with wd [E, H, I] -> y [m_pad, H].
extern "C" int gmm_ffn_visit_f32(const void* x, const void* wg, const void* wu, const void* wd, const void* vt,
                                 const void* ve, const void* lo, const void* hi, void* y, int n_visits, int bm,
                                 int h, int i, void* stream) {
  if (bad_visits(n_visits, bm, h, i, 4) || i % 4) return (int)cudaErrorInvalidValue;
  return launch_ffn<float>(x, wg, wu, wd, visits(vt, ve, lo, hi, bm), n_visits * (bm / BM), y, h, i, stream);
}

extern "C" int gmm_ffn_visit_bf16(const void* x, const void* wg, const void* wu, const void* wd, const void* vt,
                                  const void* ve, const void* lo, const void* hi, void* y, int n_visits, int bm,
                                  int h, int i, void* stream) {
  if (bad_visits(n_visits, bm, h, i, 8) || i % 8) return (int)cudaErrorInvalidValue;
  return launch_ffn<__nv_bfloat16>(x, wg, wu, wd, visits(vt, ve, lo, hi, bm), n_visits * (bm / BM), y, h, i,
                                   stream);
}
