// Grouped-GEMM MoE for sm_90a: the prefill forward as one routed chain
// (the routing layout, kernels D and E on row maps, the k-combine), and the
// backward kernels S and T.
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
// and, as a chain of four launches, the whole forward that the JAX package
// runs as its glue around _gmm_ffn_kernel_al (its default fused visit,
// _moe_ffn_gmm_impl): route_layout (the stable sort by expert, the
// expert-aligned slots and D's and E's schedule), D reading x through the
// slot -> token map, E writing each slot's y to its token-major row, and
// moe_combine (the f32 weighted sum over the k selections). D then E round
// act where the fused visit does, so the pair gives its bits. The
// boundary-visit forward (_gmm_swiglu_kernel, _gmm_ffn_kernel) runs on the
// same D and E with the slot -> sorted-row map on D's loads and on D's or
// E's stores (ops/moe_gmm.py gmm_swiglu_visit / gmm_ffn_visit). round() is
// to the working type T (identity for f32); every sum is accumulated in
// f32, silu is f32.
//
// Layout (route_layout, below, or its plain twin in ops/moe_gmm.py): the
// token -> expert assignments are sorted by expert, stably, and each
// expert's group is padded to a multiple of BM = 32 slots, so row tile t
// of the slots holds rows of one expert only, e_tile[t]. Pad slots read
// zeros. The grid is the static worst case, S = m_pad + E BM slots, T = S /
// BM tiles. A tile past the last group has tile_valid[t] == 0; D, E and S
// on the aligned layout write zeros there, D and E through a row map write
// nothing there. Row maps: a_rows[s] is the row of x that slot s reads (-1:
// zeros), out_rows[s] the row of the output it writes (-1: none). With no
// map a slot reads and writes its own row.
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
// Why a chain of four launches and not the torch glue it replaced: at N 550
// (a 2-crop page's prompt) D and E took 0.18 ms of the layer's 0.42 in a
// CUDA graph, and the argsort, the layout's ~30 elementwise ops, the row
// gather into an [S, H] copy of x, the index_select of y and the combine's
// four ops the rest, in ~60 launches that the host issues one at a time
// (1.57 ms eager). The layout is one block (a few thousand assignments);
// the gather moves into D's loads and the unsort into E's stores, so
// neither [S, H] copy exists. Two launches (D, E), not one fused visit: at
// crop sizes a page has ~100-300 valid tiles, fewer than one block per SM
// each if a tile were one block, as on the TPU's sequential grid; D's and
// E's walks spread each row block's columns over 7 (D, I = 896 by 128) or 5
// (E, H = 1280 by 256) items. The [S, I] activation makes one round trip
// through HBM (13 MB in bf16 at S = 7424, a few microseconds).
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

// Which slots a block of the f32 kernels computes: block b is row tile b,
// all of one expert, e_tile[b], or nothing when tile_valid[b] is 0. Slot s
// reads row a_rows[s] of x (zeros where it is -1) and writes row
// out_rows[s] of out (nothing where it is -1); a null map is the identity.
struct TileRows {
  const int* e_tile;
  const int* tile_valid;
  const int* a_rows;
  const int* out_rows;
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
// A's row r is row src[r] of x (row stride k_dim; zeros where src[r] < 0),
// staged a BK slice at a time into xs [BK][XS]. ws holds NW [BK][BN + 4]
// weight slices. Starts with a barrier, so src may be written just before.
template <int NW, int TN, bool WKN>
__device__ __forceinline__ void f32_sums(const float* __restrict__ x, const int* src,
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
    for (int i = tid; i < BM * (BK / 4); i += NT) {
      // Lanes on consecutive rows: conflict-free transposed stores; the
      // rest of each 32-byte sector is read by the next warp, from L1.
      const int r = i % BM, kc = 4 * (i / BM), sr = src[r];
      const float4 v = sr >= 0 && k0 + kc < k_dim
                           ? *reinterpret_cast<const float4*>(x + (size_t)sr * k_dim + k0 + kc)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      xs[(kc + 0) * XS + r] = v.x;
      xs[(kc + 1) * XS + r] = v.y;
      xs[(kc + 2) * XS + r] = v.z;
      xs[(kc + 3) * XS + r] = v.w;
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
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(xs + k * XS + ty * TM);
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

template <int NW, int TN, bool WKN>
__global__ void __launch_bounds__(NT) gmm_kernel(
    const float* __restrict__ x, const float* __restrict__ w0, const float* __restrict__ w1, TileRows rows,
    float* __restrict__ out, int k_dim, int n_dim) {
  constexpr int BN = NTX * TN;
  __shared__ __align__(16) float xs[BK * XS];
  __shared__ __align__(16) float ws[NW * BK * (BN + 4)];
  __shared__ int src[BM];

  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (!rows.tile_valid[blockIdx.x]) {
    // An invalid tail tile: zeros on the aligned layout, nothing through a map.
    if (rows.out_rows == nullptr) {
      const int chunks = min(BN, n_dim - n0) / 4;  // n_dim is a multiple of 4
      for (int i = threadIdx.x; i < BM * chunks; i += NT)
        *reinterpret_cast<float4*>(out + (size_t)(row0 + i / chunks) * n_dim + n0 + 4 * (i % chunks)) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  if (threadIdx.x < BM) src[threadIdx.x] = rows.a_rows ? rows.a_rows[row0 + threadIdx.x] : row0 + threadIdx.x;
  const int e = rows.e_tile[blockIdx.x];
  const float* wp[NW];
  wp[0] = w0 + (size_t)e * n_dim * k_dim;
  if (NW > 1) wp[NW - 1] = w1 + (size_t)e * n_dim * k_dim;
  float acc[NW][TM][TN];
  f32_sums<NW, TN, WKN>(x, src, wp, n0, k_dim, n_dim, xs, ws, acc);

  // Thread (ty, tx)'s outputs (NW = 2: silu(gate) up), each slot's to its row.
  const int ty = threadIdx.x / NTX, tx = threadIdx.x % NTX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int slot = row0 + ty * TM + i;
    const int dst = rows.out_rows ? rows.out_rows[slot] : slot;
    if (dst < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * 4 + 64 * (j / 4) + j % 4;
      if (col < n_dim)
        out[(size_t)dst * n_dim + col] = NW == 2 ? silu(acc[0][i][j]) * acc[NW - 1][i][j] : acc[0][i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 kernels D, S, E and T on Hopper: TMA loads into a ring of shared-memory
// stages (one producer warp, mbarriers "full" and "empty" per stage), two
// consumer warpgroups that run wgmma (m64n256k16; D two m64n128k16) on the stages that have
// arrived (sm90.cuh). A block is 288 threads: warpgroups 0 and 1 consume,
// warp 8 produces (its lane 0 issues every TMA copy); with a row map on A,
// 384: a producer warpgroup whose 128 threads copy A's rows and whose first
// issues the TMA copies. Every operand is read as it lies in memory; the
// transposes are wgmma's operand modes, so no transposed copy and no
// ldmatrix.trans.

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
// covers the alignment. S and E take 214 576 bytes (below), D 230 976, T
// 230 464, within the 232 448 a block may use.
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

// The "full" barrier of a stage counts full_arrivals: the producer's
// arrive with the TMA bytes, and with a row map on A one more a producer
// lane, made when the lane's copies of the stage have landed.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int n_stages, int full_arrivals = 1) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      sm90::mbar_init(&full[s], full_arrivals);
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

// A 16-byte copy global -> shared; zeros where !full (the source is not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_u32(smem)), "l"(gmem),
               "r"(full ? 16 : 0)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed
// (counted in the barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(sm90::smem_u32(bar)) : "memory");
}

// Kernels S, E and D in bf16, one kernel on the row tiles of the aligned
// layout, a [S, K], the weights [E, ...] read as they lie:
// - KIND ROWS_N_MAJOR (S): out [S, N] = round(a_t W_e), W [E, O, C]
//   contracted on its rows, K = O, N = C, each row of the weight along N;
// - KIND ROWS_K_MAJOR (E): out = round(a_t W_e^T), W [E, N, K] in HF's
//   [out, in] layout, each row along K;
// - KIND ROWS_SWIGLU (D): act [S, I] = round(round(silu(round(a_t Wg_e^T)))
//   * round(a_t Wu_e^T)), Wg and Wu [E, I, H] K-major as E's, K = H, N = I.
// GATHER (D): slot s's row of A is row a_rows[s] of a [R, K] (zeros where
// -1), copied by the producer warp; SCATTER (D, E): slot s's output goes to
// row out_rows[s] of out (none where -1), by the consumers' stores.
//
// A persistent grid of at most one block per SM walks the work items i =
// blockIdx.x, + gridDim.x, ...; item i is (row block b, column block) =
// (i / n_cb, i % n_cb) of BN columns (256 for S and E, 128 of I for D), the
// column blocks of one row block next to each other so that they run
// together and read the block's rows from L2. Row block b of expert e
// covers its tiles tile_lo[e] + 4 (b - blk_lo[e]) + [0, 4), clipped at
// tile_lo[e + 1]: blk_lo is the prefix of ceil(tiles / 4) over the experts
// (`row_block_lo`, or route_layout's), and the item finds its expert by a
// binary search on it (`dx_row_blocks` in ops/moe_gmm.py is the same map).
// Row blocks past blk_lo[E] zero the rows of the invalid tail tiles, 4
// tiles each, on the aligned layout (the ceil(T / 4) + E + 1 rows of the
// walk cover every case); the rest are skipped, and all of them under
// SCATTER. A warpgroup whose 64 rows hold no tile of the expert (a row
// block of one or two tiles) waits on and frees the stages but multiplies
// nothing.
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
// accumulators a thread as E. Without GATHER the A box is the block's 128
// rows whatever the clip (rows of the next expert, or zeros past the end),
// by TMA. With GATHER there is no TMA gather on sm_90 (gather4 is sm_100's):
// the producer warpgroup's 128 threads copy each row's 128-byte k slice as
// eight 16-byte cp.async into the 128-byte-swizzled position TMA would have
// written (chunk j of row r at chunk j ^ (r % 8)), eight threads a row so a
// warp instruction reads four whole 128-byte lines; rows of tiles past the
// expert's and pad slots are zero-filled, not read. Each thread's copies
// arrive on the stage's "full" barrier when they land (cp.async.mbarrier
// .arrive.noinc), and the consumers fence the async proxy before wgmma
// reads what the generic proxy wrote. Measured at N 550 in a CUDA graph
// (scripts/torch_gmm_ablate.py, PERF.md): with the warpgroup 0.120 ms, as D
// on the aligned rows by TMA (0.119) and near D with no row copies at all
// (0.115); with one producer warp issuing all 1024 copies of a stage,
// 0.173-0.193. A 1-row TMA box a row (the swizzle follows the shared
// address, so the layout comes out right) was slower than one warp. k past K and n past N read zeros
// (the weights' maps are 3-D with the expert outermost, so a box never
// reaches the next expert). S and E take 256 columns, not 128: a block's
// rows are read from L2 once per 256 columns (0.17 GB of row reads at the
// dact shape instead of 0.29).
//
// Epilogue: each warpgroup rounds its sums (D: the SwiGLU of gate and up at
// the rounding points above) to bf16 into its tile ([32 rows][64 n] boxes,
// 128-byte swizzled: no bank conflicts; eight for S and E, four for D).
// Without SCATTER one thread stores the boxes of the expert's row tiles with
// TMA (the next expert's rows in the block are not stored; columns past N
// are clipped); the store drains while the next item loads and multiplies,
// and `wait_group.read 0` holds the tile until the store has read it. With
// SCATTER the warpgroup's threads copy the tile's rows out, a row's 16-byte
// chunks by consecutive threads (whole 512- or 256-byte rows a warp
// instruction), each to its row out_rows[s].
constexpr int ROWS_K_MAJOR = 0, ROWS_N_MAJOR = 1, ROWS_SWIGLU = 2;

template <int KIND>
constexpr int ROWS_BN = KIND == ROWS_SWIGLU ? 128 : SX_BN;  // a work item's columns
// D's output tiles are half of S's and E's (128 columns), which leaves room
// for a fourth stage.
template <int KIND>
constexpr int ROWS_STAGES = KIND == ROWS_SWIGLU ? 4 : SX_STAGES;
template <int KIND>
constexpr int ROWS_OUT_BYTES = 2 * ROWS_BN<KIND> / 64 * SX_OUT_BOX;  // a warpgroup's [64 rows][BN]
// + the producer's row map of an item (GATHER), SX_ROWS ints after the barriers.
template <int KIND>
constexpr int ROWS_SMEM = ROWS_STAGES<KIND> * SX_STAGE_BYTES + 2 * ROWS_OUT_BYTES<KIND> + 2 * ROWS_STAGES<KIND> * 8 +
                          SX_ROWS * 4 + 1024;

// D's epilogue on the f32 sums. silu in f32 with the fast exponential and
// division (a few f32 ulps, far below the bf16 rounding after it): with
// expf and an IEEE division the epilogue took a fifth of D's time at N 550
// (scripts/torch_gmm_ablate.py d_no_swiglu, PERF.md).
__device__ __forceinline__ float swiglu(float gate, float up) {
  const float g = round_bf16(gate);
  return round_bf16(__fdividef(g, 1.f + __expf(-g))) * round_bf16(up);
}

// GATHER's block: the two consumer warpgroups and a producer warpgroup,
// whose 128 threads share the row copies (eight cp.async a thread a stage).
constexpr int GATHER_BLOCK = 384;
constexpr int GATHER_PRODUCERS = GATHER_BLOCK - 256;

template <bool GATHER>
constexpr int ROWS_BLOCK = GATHER ? GATHER_BLOCK : WG_BLOCK;

template <int KIND, bool GATHER, bool SCATTER>
__global__ void __launch_bounds__(ROWS_BLOCK<GATHER>, 1) gmm_rows_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_w2, const __grid_constant__ CUtensorMap map_out,
    const __nv_bfloat16* __restrict__ a, const int* __restrict__ a_rows, const int* __restrict__ out_rows,
    const int* __restrict__ tile_lo, const int* __restrict__ blk_lo, __nv_bfloat16* __restrict__ out,
    int n_experts, int n_tiles, int k_dim, int n_dim) {
  constexpr int BN = ROWS_BN<KIND>, STAGES = ROWS_STAGES<KIND>, OUT_BYTES = ROWS_OUT_BYTES<KIND>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* out_smem = smem + STAGES * SX_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_smem + 2 * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  int* prow = reinterpret_cast<int*>(empty + STAGES);  // GATHER: the item's source rows
  init_ring(full, empty, STAGES, GATHER ? 1 + GATHER_PRODUCERS : 1);
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

  if (warp >= PRODUCER_WARP) {
    const int p = threadIdx.x - 32 * PRODUCER_WARP;  // the producer thread: 0, or 0 .. 127 under GATHER
    if (GATHER || lane == 0) {
      Ring ring;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int b = item / n_cb, n0 = item % n_cb * BN;
        if (b >= n_blocks) continue;
        int e, t0;
        row_block(b, e, t0);
        if constexpr (GATHER) {
          const int t_end = min(t0 + SX_TILES, tile_lo[e + 1]);
          sm90::bar_sync(3, GATHER_PRODUCERS);  // the previous item's reads of prow are done
          prow[p] = t0 + p / BM < t_end ? a_rows[(size_t)t0 * BM + p] : -1;  // SX_ROWS == GATHER_PRODUCERS
          sm90::bar_sync(3, GATHER_PRODUCERS);
        }
        for (int ks = 0; ks < n_k; ++ks, ring.next<STAGES>()) {
          sm90::mbar_wait(&empty[ring.stage], ring.phase ^ 1);
          uint64_t* bar = &full[ring.stage];
          unsigned char* st = smem + ring.stage * SX_STAGE_BYTES;
          if (p == 0) {
            sm90::mbar_arrive_expect_tx(bar, GATHER ? SX_STAGE_BYTES - SX_A_BYTES : SX_STAGE_BYTES);
            if (!GATHER) sm90::tma_load_2d(st, &map_a, bar, ks * SX_BK, t0 * BM);
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
          if constexpr (GATHER) {
            // Thread p: chunk c = p % 8 of rows 16 q + p / 8, q < 8 (a warp
            // instruction: four whole 128-byte row slices).
            const int c = p % 8, k0 = ks * SX_BK + 8 * c;
#pragma unroll
            for (int q = 0; q < SX_ROWS / 16; ++q) {
              const int r = 16 * q + p / 8, src = prow[r];
              const bool live = src >= 0 && k0 < k_dim;  // k_dim is a multiple of 8
              cp_async16(st + r * 128 + ((c ^ (r % 8)) * 16), live ? a + (size_t)src * k_dim + k0 : a, live);
            }
            cp_async_arrive(bar);
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
    if (b >= n_blocks) {  // the invalid tail's rows read as zeros (aligned output only)
      if (SCATTER) continue;
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
        if (GATHER) sm90::fence_proxy_async();  // A's rows were written by cp.async (the generic proxy)
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
    if constexpr (SCATTER) {
      sm90::bar_sync(1 + wg, 128);
      constexpr int CH = BN / 8, ROWS_AT_ONCE = 128 / CH;  // 16-byte chunks a row; rows a pass
      const int c = tid % CH, col = n0 + 8 * c;
      for (int r = tid / CH; r < 64; r += ROWS_AT_ONCE) {
        if (t0 + 2 * wg + r / BM >= t_end) break;  // the next expert's rows, and past them
        const int dst = out_rows[(size_t)(t0 + 2 * wg) * BM + r];
        if (dst < 0 || col >= n_dim) continue;  // n_dim is a multiple of 8
        const int rr = r % BM;
        const int off = ((r / BM) * (BN / 64) + c / 8) * SX_OUT_BOX + rr * 128 + (((c % 8) ^ (rr % 8)) * 16);
        *reinterpret_cast<uint4*>(out + (size_t)dst * n_dim + col) = *reinterpret_cast<const uint4*>(ob + off);
      }
      // The next item's first barrier orders these reads before ob is rewritten.
    } else {
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

// ---------------------------------------------------------------------------
// The routing layout: idx [N, k] -> the expert-aligned slots, in one block.
//
// Replaces the JAX package's glue before _gmm_ffn_kernel_al
// (_moe_ffn_gmm_impl: the stable argsort of the flat ids, bincount,
// _aligned_layout, the row gather's map) and the port's torch forms of it
// (ops/moe_gmm.py `aligned_assignments` and `row_schedule`, its plain
// twin): every integer equal to theirs. Assignment j = token * k +
// selection has bucket b = idx[token, selection], or E for an id outside
// [0, E) (another rank's expert under expert parallelism: no slot; it
// sorts last).
//
// A stable counting sort with 32 warps: warp w owns the contiguous segment
// w of the assignments and walks it 32 at a time in order. Pass 1 counts
// each warp's buckets (lanes of equal bucket found by __match_any_sync,
// the group's lowest lane adds the group's size: no atomics); one thread
// scans the bucket totals into the sorted starts and lays out the aligned
// groups (E is small: a loop over the experts); pass 2 places each
// assignment at its bucket's start + the counts of earlier warps + its
// rank among the equal lanes of its step, so equal ids keep index order,
// as jnp.argsort(stable=True). Pass 3 fills the slots from the sorted
// order. What bounds it: a few microseconds of latency (two passes over
// N k ids of a few kB, then ~S slots written), one block on one SM.
//
// Outputs (S = m_pad + E BM slots, T = S / BM tiles, m = N k):
//   assign [S] int64: the sorted assignment each slot's source row holds
//     (pad slots: that of the clamped source row, 0 past m, as the torch form)
//   slot_valid [S] bool, e_tile [T], tile_valid [T], rows [m] int64 (the
//     slot of each assignment; an id-E assignment's is the clamped one)
//   tile_lo [E + 1], blk_lo [E + 1]: D's, E's and S's schedule
//   x_rows [S]: assign / k where valid, else -1 (D's map onto x's tokens)
//   y_rows [S]: assign where valid, else -1 (E's map onto y's rows)
//   order [m]: scratch, the sorted order.
// Measured at N 550 in a CUDA graph: 0.019 ms, as much with the order and
// each assignment's bucket kept in shared memory (PERF.md).

constexpr int LAYOUT_WARPS = 32;

struct LayoutOut {
  long long* assign;
  bool* slot_valid;
  int* e_tile;
  int* tile_valid;
  long long* rows;
  int* tile_lo;
  int* blk_lo;
  int* x_rows;
  int* y_rows;
  int* order;
};

// The number of values in a[0, n) that are <= v (a ascending).
__device__ __forceinline__ int upper_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename I>
__global__ void __launch_bounds__(LAYOUT_WARPS * 32) route_layout_kernel(const I* __restrict__ idx, int ld,
                                                                          int n_tok, int k, int n_experts,
                                                                          LayoutOut o) {
  extern __shared__ int lsm[];
  const int E = n_experts, NB = E + 1;
  int* hist = lsm;                        // [LAYOUT_WARPS][NB]: counts, then each warp's running start
  int* start = hist + LAYOUT_WARPS * NB;  // [NB + 1]: sorted start of each bucket
  int* aend = start + NB + 1;             // [E]: aligned end of each expert's slots
  int* shift = aend + E;                  // [E]: slot = sorted row + shift[e]
  const int m = n_tok * k, m_pad = (m + BM - 1) / BM * BM, s_total = m_pad + E * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = ((m + LAYOUT_WARPS - 1) / LAYOUT_WARPS + 31) / 32 * 32;
  const int j_lo = min(warp * seg, m), j_hi = min(j_lo + seg, m);
  int* mine = hist + warp * NB;
  auto bucket = [&](int j) -> int {
    const int t = j / k;
    const long long v = idx[(size_t)t * ld + (j - t * k)];
    return v >= 0 && v < E ? (int)v : E;
  };

  for (int i = threadIdx.x; i < LAYOUT_WARPS * NB; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int j0 = j_lo; j0 < j_hi; j0 += 32) {
    const int j = j0 + lane, b = j < j_hi ? bucket(j) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(same) - 1) mine[b] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // Each bucket's count over the warps, and each warp's start within it.
  for (int b = threadIdx.x; b < NB; b += blockDim.x) {
    int run = 0;
    for (int w = 0; w < LAYOUT_WARPS; ++w) {
      const int c = hist[w * NB + b];
      hist[w * NB + b] = run;
      run += c;
    }
    start[b] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0, aligned = 0, blocks = 0;
    for (int b = 0; b < NB; ++b) {
      const int c = start[b];
      start[b] = run;
      if (b < E) {
        const int tiles = (c + BM - 1) / BM;
        o.tile_lo[b] = aligned / BM;
        o.blk_lo[b] = blocks;
        shift[b] = aligned - run;
        aligned += tiles * BM;
        aend[b] = aligned;
        blocks += (tiles + SX_TILES - 1) / SX_TILES;
      }
      run += c;
    }
    start[NB] = run;
    o.tile_lo[E] = aligned / BM;
    o.blk_lo[E] = blocks;
  }
  __syncthreads();
  for (int j0 = j_lo; j0 < j_hi; j0 += 32) {
    const int j = j0 + lane, b = j < j_hi ? bucket(j) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, b);
    if (b >= 0) {
      const int pos = start[b] + mine[b] + __popc(same & ((1u << lane) - 1));
      o.order[pos] = j;
      o.rows[j] = pos + shift[b < E ? b : E - 1];
    }
    __syncwarp();
    if (b >= 0 && lane == __ffs(same) - 1) mine[b] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  for (int s = threadIdx.x; s < s_total; s += blockDim.x) {
    const int e = min(upper_bound(aend, E, s), E - 1);
    const int src = s - shift[e];
    const bool valid = s < aend[e] && src < start[e + 1];
    const int sc = min(max(src, 0), m_pad - 1);
    const int j = sc < m ? o.order[sc] : 0;
    o.assign[s] = j;
    o.slot_valid[s] = valid;
    o.x_rows[s] = valid ? j / k : -1;
    o.y_rows[s] = valid ? j : -1;
  }
  const int total = aend[E - 1];
  for (int t = threadIdx.x; t < s_total / BM; t += blockDim.x) {
    const bool valid = t * BM < total;
    o.e_tile[t] = min(upper_bound(aend, E, valid ? t * BM : max(total - 1, 0)), E - 1);
    o.tile_valid[t] = valid;
  }
}

// ---------------------------------------------------------------------------
// The k-combine: out[t] = sum over the selections s = 0 .. k-1 of token t
// whose id is in [0, E) of float(y[t k + s]) * w[t, s], in f32, cast once
// to out's type (the rounding points of the torch combine it replaces,
// `(y.float() * w).sum(1)`; product and sum rounded apart, no FMA), and in
// that sum's order on the card: four running sums, selection s of each
// whole group of four into sum s % 4, the rest into sums 0, 1, 2, then
// the four added in order (measured bit-equal for k 1-12; a sum in
// selection order moved the LM's bf16 logits enough to flip a token of
// chip_smoke's phase 9c). So the chain gives the forward's bits before it.
// A selection of another rank's expert adds nothing (its row of y is never
// written, so it is not read). No atomics: each output is one thread's.
// Thread: 16 bytes of y a selection (8 bf16 or 4 f32 columns) of one token.
// Bound: y read once, out written once (8.4 MB + 1.4 MB at N 550 in bf16).

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[16 / sizeof(T)]);

template <>
__device__ __forceinline__ void load_vec<float>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, typename O, typename I>
__global__ void __launch_bounds__(256) moe_combine_kernel(const T* __restrict__ y, const float* __restrict__ w,
                                                         int ldw, const I* __restrict__ idx, int ldi,
                                                         O* __restrict__ out, int n_tok, int k, int h,
                                                         int n_experts) {
  constexpr int V = 16 / sizeof(T);
  const int per_tok = h / V;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)n_tok * per_tok) return;
  const int t = (int)(g / per_tok), c = (int)(g % per_tok) * V;
  float acc[4][V];  // the four running sums
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[a][i] = 0.f;
  // Selection s into sum a (a compile-time index: the sums stay in registers).
  auto add = [&](int a_sum, int s) {
    const long long id = idx[(size_t)t * ldi + s];
    if (id < 0 || id >= n_experts) return;
    const float ws = w[(size_t)t * ldw + s];
    float v[V];
    load_vec(y + ((size_t)t * k + s) * h + c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[a_sum][i] = __fadd_rn(acc[a_sum][i], __fmul_rn(v[i], ws));
  };
  const int full = k / 4 * 4;
  for (int s0 = 0; s0 < full; s0 += 4) {
#pragma unroll
    for (int a = 0; a < 4; ++a) add(a, s0 + a);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (full + a < k) add(a, full + a);
#pragma unroll
  for (int i = 0; i < V; ++i)
    store_out(out + (size_t)t * h + c + i, __fadd_rn(__fadd_rn(__fadd_rn(acc[0][i], acc[1][i]), acc[2][i]), acc[3][i]));
}

bool bad_shape(int n_tiles, int bm, int k_dim, int n_dim, int k_align) {
  return bm != BM || n_tiles <= 0 || k_dim <= 0 || k_dim % k_align || n_dim <= 0 || n_dim % 4;
}

template <int NW, int TN, bool WKN>
int launch_f32(const void* x, const void* w0, const void* w1, TileRows rows, int n_tiles, void* out, int k_dim,
               int n_dim, void* stream) {
  constexpr int BN = NTX * TN;
  const dim3 grid(n_tiles, (n_dim + BN - 1) / BN);
  gmm_kernel<NW, TN, WKN><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w0), static_cast<const float*>(w1), rows,
      static_cast<float*>(out), k_dim, n_dim);
  return (int)cudaGetLastError();
}

TileRows tile_rows(const void* e_tile, const void* tile_valid, const void* a_rows, const void* out_rows) {
  return TileRows{static_cast<const int*>(e_tile), static_cast<const int*>(tile_valid),
                  static_cast<const int*>(a_rows), static_cast<const int*>(out_rows)};
}

// S (KIND ROWS_N_MAJOR: w [E, K, N]), E (ROWS_K_MAJOR: w [E, N, K]) or D
// (ROWS_SWIGLU: w, w2 = gate, up [E, N, K]) in bf16 on
// gmm_rows_wgmma_kernel: a [S, K] (GATHER: a [R, K] through a_rows) -> out
// [S, N] (SCATTER: rows of out through out_rows). The tensor maps: a and
// out 2-D over the n_tiles * BM rows (not built under GATHER / SCATTER);
// the weights 3-D with the expert outermost, their boxes 64 wide along
// their contiguous dim.
template <int KIND, bool GATHER, bool SCATTER>
int launch_rows_wgmma(const void* a, const void* w, const void* w2, const void* tile_lo, const void* blk_lo,
                      const void* a_rows, const void* out_rows, void* out, int n_tiles, int bm, int k_dim,
                      int n_dim, int n_experts, int n_blocks, void* stream) {
  if (bad_shape(n_tiles, bm, k_dim, n_dim, 8) || n_dim % 8 || n_experts <= 0 || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr bool N_MAJOR = KIND == ROWS_N_MAJOR;
  CUtensorMap map_a{}, map_w{}, map_w2{}, map_out{};
  const uint64_t rows = (uint64_t)n_tiles * BM;
  const uint64_t dims_a[2] = {(uint64_t)k_dim, rows}, dims_out[2] = {(uint64_t)n_dim, rows};
  const uint64_t dims_w[3] = {(uint64_t)(N_MAJOR ? n_dim : k_dim), (uint64_t)(N_MAJOR ? k_dim : n_dim),
                              (uint64_t)n_experts};
  const uint32_t box_a[2] = {SX_BK, SX_ROWS}, box_w[3] = {64, 64, 1}, box_out[2] = {64, BM};
  auto kernel = gmm_rows_wgmma_kernel<KIND, GATHER, SCATTER>;
  int err = GATHER ? 0 : sm90::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, a, dims_a, box_a);
  if (!err) err = sm90::make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, w, dims_w, box_w);
  if (!err) err = sm90::make_map(&map_w2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, w2, dims_w, box_w);
  if (!err && !SCATTER)
    err = sm90::make_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, out, dims_out, box_out);
  if (!err) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM<KIND>);
  if (err) return err;
  kernel<<<n_blocks, ROWS_BLOCK<GATHER>, ROWS_SMEM<KIND>, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_w, map_w2, map_out, static_cast<const __nv_bfloat16*>(a), static_cast<const int*>(a_rows),
      static_cast<const int*>(out_rows), static_cast<const int*>(tile_lo), static_cast<const int*>(blk_lo),
      static_cast<__nv_bfloat16*>(out), n_experts, n_tiles, k_dim, n_dim);
  return (int)cudaGetLastError();
}

template <typename I>
int launch_layout(const void* idx, int ld, int n_tok, int k, int n_experts, LayoutOut o, void* stream) {
  const int smem = (LAYOUT_WARPS * (n_experts + 1) + n_experts + 2 + 2 * n_experts) * (int)sizeof(int);
  auto kernel = route_layout_kernel<I>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, LAYOUT_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(static_cast<const I*>(idx), ld, n_tok,
                                                                             k, n_experts, o);
  return (int)cudaGetLastError();
}

template <typename T, typename O, typename I>
int launch_combine(const void* y, const void* w, int ldw, const void* idx, int ldi, void* out, int n_tok, int k,
                   int h, int n_experts, void* stream) {
  const long long threads = (long long)n_tok * (h / (16 / (int)sizeof(T)));
  moe_combine_kernel<T, O, I><<<(unsigned)((threads + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const float*>(w), ldw, static_cast<const I*>(idx), ldi,
      static_cast<O*>(out), n_tok, k, h, n_experts);
  return (int)cudaGetLastError();
}

template <typename T, typename O>
int launch_combine_idx(const void* y, const void* w, int ldw, const void* idx, int idx64, int ldi, void* out,
                       int n_tok, int k, int h, int n_experts, void* stream) {
  return idx64 ? launch_combine<T, O, long long>(y, w, ldw, idx, ldi, out, n_tok, k, h, n_experts, stream)
               : launch_combine<T, O, int>(y, w, ldw, idx, ldi, out, n_tok, k, h, n_experts, stream);
}

}  // namespace

// The routing layout of idx [N, k] (int64 when idx64, else int32; row
// stride ld elements, selections contiguous) over n_experts experts into
// the buffers of LayoutOut (see route_layout_kernel), one block.
extern "C" int route_layout(const void* idx, int idx64, int ld, int n_tok, int k, int n_experts, void* assign,
                            void* slot_valid, void* e_tile, void* tile_valid, void* rows, void* tile_lo,
                            void* blk_lo, void* x_rows, void* y_rows, void* order, void* stream) {
  if (n_tok <= 0 || k <= 0 || n_experts <= 0 || n_experts > 1024 || ld < k || (long long)n_tok * k > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const LayoutOut o{static_cast<long long*>(assign), static_cast<bool*>(slot_valid), static_cast<int*>(e_tile),
                    static_cast<int*>(tile_valid), static_cast<long long*>(rows), static_cast<int*>(tile_lo),
                    static_cast<int*>(blk_lo), static_cast<int*>(x_rows), static_cast<int*>(y_rows),
                    static_cast<int*>(order)};
  return idx64 ? launch_layout<long long>(idx, ld, n_tok, k, n_experts, o, stream)
               : launch_layout<int>(idx, ld, n_tok, k, n_experts, o, stream);
}

// The k-combine: y [N k, H] (bf16 when y_bf16, else f32), w [N, k] f32 (row
// stride ldw), idx [N, k] (int64 when idx64, row stride ldi) -> out [N, H]
// (bf16 when out_bf16, else f32). H a multiple of 16 bytes of y.
extern "C" int moe_combine(const void* y, const void* w, int ldw, const void* idx, int idx64, int ldi, void* out,
                           int n_tok, int k, int h, int n_experts, int y_bf16, int out_bf16, void* stream) {
  if (n_tok <= 0 || k <= 0 || h <= 0 || h % (y_bf16 ? 8 : 4) || ldw < k || ldi < k)
    return (int)cudaErrorInvalidValue;
  using B = __nv_bfloat16;
  if (y_bf16)
    return out_bf16 ? launch_combine_idx<B, B>(y, w, ldw, idx, idx64, ldi, out, n_tok, k, h, n_experts, stream)
                    : launch_combine_idx<B, float>(y, w, ldw, idx, idx64, ldi, out, n_tok, k, h, n_experts, stream);
  return out_bf16 ? launch_combine_idx<float, B>(y, w, ldw, idx, idx64, ldi, out, n_tok, k, h, n_experts, stream)
                  : launch_combine_idx<float, float>(y, w, ldw, idx, idx64, ldi, out, n_tok, k, h, n_experts, stream);
}

// D: x [S, H] (or [R, H] through x_rows [S], -1 reading zeros), wg / wu
// [E, I, H] -> act [S, I], the invalid tail tiles' rows zero; or, with
// out_rows, slot s's act to row out_rows[s] of act (none where -1).
extern "C" int gmm_swiglu_f32(const void* x, const void* wg, const void* wu, const void* e_tile,
                              const void* tile_valid, const void* x_rows, const void* out_rows, void* act,
                              int n_tiles, int bm, int h, int i, void* stream) {
  if (bad_shape(n_tiles, bm, h, i, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<2, 4, false>(x, wg, wu, tile_rows(e_tile, tile_valid, x_rows, out_rows), n_tiles, act, h, i,
                                 stream);
}

// D in bf16: x [S, H] (or [R, H] through x_rows), wg / wu [E, I, H] and
// the schedule (tile_lo, blk_lo, n_blocks: ops/moe_gmm.swiglu_grid) -> act
// [S, I], every row written, those of the invalid tail tiles with zeros;
// or, with out_rows (x_rows then required), slot s's act to row
// out_rows[s] of act (none where -1).
extern "C" int gmm_swiglu_bf16(const void* x, const void* wg, const void* wu, const void* tile_lo,
                               const void* blk_lo, const void* x_rows, const void* out_rows, void* act,
                               int n_tiles, int bm, int h, int i, int n_experts, int n_blocks, void* stream) {
  if (out_rows)
    return x_rows ? launch_rows_wgmma<ROWS_SWIGLU, true, true>(x, wg, wu, tile_lo, blk_lo, x_rows, out_rows, act,
                                                               n_tiles, bm, h, i, n_experts, n_blocks, stream)
                  : (int)cudaErrorInvalidValue;
  if (x_rows)
    return launch_rows_wgmma<ROWS_SWIGLU, true, false>(x, wg, wu, tile_lo, blk_lo, x_rows, nullptr, act, n_tiles,
                                                       bm, h, i, n_experts, n_blocks, stream);
  return launch_rows_wgmma<ROWS_SWIGLU, false, false>(x, wg, wu, tile_lo, blk_lo, nullptr, nullptr, act, n_tiles,
                                                      bm, h, i, n_experts, n_blocks, stream);
}

// E: act [S, I], wd [E, H, I] -> y [S, H], or through y_rows [S] the row
// y_rows[s] of y (none where -1).
extern "C" int gmm_down_f32(const void* act, const void* wd, const void* e_tile, const void* tile_valid,
                            const void* y_rows, void* y, int n_tiles, int bm, int i, int h, void* stream) {
  if (bad_shape(n_tiles, bm, i, h, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<1, 8, false>(act, wd, wd, tile_rows(e_tile, tile_valid, nullptr, y_rows), n_tiles, y, i, h,
                                 stream);
}

// E in bf16: act [S, I], wd [E, H, I] and S's schedule (tile_lo, blk_lo,
// n_blocks; see gmm_dx_bf16) -> y [S, H], every row written; or through
// y_rows as gmm_down_f32.
extern "C" int gmm_down_bf16(const void* act, const void* wd, const void* tile_lo, const void* blk_lo,
                             const void* y_rows, void* y, int n_tiles, int bm, int i, int h, int n_experts,
                             int n_blocks, void* stream) {
  if (y_rows)
    return launch_rows_wgmma<ROWS_K_MAJOR, false, true>(act, wd, wd, tile_lo, blk_lo, nullptr, y_rows, y, n_tiles,
                                                        bm, i, h, n_experts, n_blocks, stream);
  return launch_rows_wgmma<ROWS_K_MAJOR, false, false>(act, wd, wd, tile_lo, blk_lo, nullptr, nullptr, y, n_tiles,
                                                       bm, i, h, n_experts, n_blocks, stream);
}

// S: a [S, O], w [E, O, C] (contracted on O, its row dim) -> out [S, C].
extern "C" int gmm_dx_f32(const void* a, const void* w, const void* e_tile, const void* tile_valid,
                          void* out, int n_tiles, int bm, int o, int c, void* stream) {
  if (bad_shape(n_tiles, bm, o, c, 4)) return (int)cudaErrorInvalidValue;
  return launch_f32<1, 8, true>(a, w, w, tile_rows(e_tile, tile_valid, nullptr, nullptr), n_tiles, out, o, c,
                                stream);
}

// S in bf16: tile_lo [E + 1] (expert e owns tiles tile_lo[e] .. tile_lo[e + 1]
// - 1) and blk_lo [E + 1] (its row blocks blk_lo[e] .. blk_lo[e + 1] - 1,
// ops/moe_gmm.row_block_lo), n_blocks the persistent grid (ops/moe_gmm.dx_grid)
// -> out [S, C]; every row is written, those of the invalid tail tiles with
// zeros.
extern "C" int gmm_dx_bf16(const void* a, const void* w, const void* tile_lo, const void* blk_lo, void* out,
                           int n_tiles, int bm, int o, int c, int n_experts, int n_blocks, void* stream) {
  return launch_rows_wgmma<ROWS_N_MAJOR, false, false>(a, w, w, tile_lo, blk_lo, nullptr, nullptr, out, n_tiles,
                                                       bm, o, c, n_experts, n_blocks, stream);
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
