// Int8-weight decode MoE for sm_90a: kernels I and J.
//
// I replaces deepseek_ocr2_tpu/ops/moe_q8.py: _q8_kernel and _q8_pe_kernel
// (via moe_ffn_decode_q8): one visit per (row, selection), plus the shared
// pseudo-experts at one row. J replaces deepseek_ocr2_tpu/ops/moe_decode.py:
// _decode_q8_kernel and _decode_q8_pe_kernel (via moe_ffn_decode_q8_fused):
// one visit per distinct selected expert, then the pseudo-experts. The
// layout and the rounding points are in moe_quant.cuh, shared with the int4
// kernels M and N (moe_q4.cu). I, and J with f32 x or with H above 1280 or
// H or I not a multiple of 64, run moe_quant.cuh's kernels on
// linear_q8.cuh's products; J with bf16 x otherwise runs the stream below.
//
// What bounds it: the int8 expert bytes, 3 * H * I = 3.44 MB an expert at
// H = 1280, I = 896. I at b = 1 with the pseudo-experts: 8 visits, 27.5 MB,
// 8.2 us at 3.35 TB/s per MoE layer. J at 16 rows: about 53 distinct
// experts + 2 pseudo-experts, 189 MB, 0.057 ms. I re-reads an expert for
// every row that selects it, hence J once B * k > E.
//
// J with bf16 x: kernel F's bf16 design (moe_decode.cu) over int8 codes,
// two launches after the schedule's (F's schedule_kernel: ve, valid,
// w_visit), with no yw and no combine launch. Its first form (moe_quant.cuh,
// kept for N) ran a grid of visits x column tiles, each warp loading two
// code rows straight from global memory, 40 KB a block, the warps' tiles
// met in shared memory in every block; its down launch wrote y * w to an
// f32 yw [V, B, H] that a third launch summed: 0.176 ms at 16 rows in a
// CUDA graph on an H100, 32 % of the bound (PERF.md).
// - The visits are the valid routed ones (a prefix of ve: ascending expert
//   id), then the n_sh pseudo-experts (rows of pgu / pdown), visit v of the
//   compact list writing act [v, B, I] (bf16).
// - Few, large copies. A first form of this stream copied each weight row
//   by its own 1-D bulk copy into a padded row of shared memory (F's way):
//   63 us for gate/up and 89 us for down at 16 rows on an H100 (34 copies
//   a 40 KB gate/up stage, 19 a down visit), its time following its copies
//   and not its bytes (scripts/torch_moe_q8_ablate.py, PERF.md). So each
//   stage is filled by a few copies of contiguous rows, unpadded, and a
//   lane reads 16 codes at once (one 16-byte load, 4 k16 steps: logical k
//   pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of step j at the physical 16 t
//   + 4 j + (0, 1) and (2, 3) of a 64-k chunk, as linear_q8.cuh's mma form,
//   the other operand's fragments loaded in the same k order, the dot being
//   a sum over k in any order): rows 1280 or 896 bytes apart then cost a
//   quarter-warp two bank wavefronts instead of one. Codes are widened to
//   bf16 pairs exactly (codes_bf16x2: a byte permute into the mantissa of
//   2^23, one FADD, the high halves; |c| <= 127 has 7 significant bits).
// - gate/up (gu_q8_kernel): a persistent grid, one block an SM, one
//   producer warp and 8 consumer warps, over items (visit, 16 columns i0 of
//   I). A stage holds the item's 16 gate code rows of gu [E, 2I, H] (one
//   bulk copy of 20 KB at H 1280), its 16 up rows (another) and their 32
//   scales: 4 copies for 40 KB, F's stage size; 4 stages. Each consumer
//   warp keeps its x fragments for its chunks of H (chunks w, w + 8, ...)
//   in registers for the whole launch and runs mma.sync m16n8k16 with the
//   decode rows as A and each n8 tile of code rows as B. The warps' partial
//   tiles meet in shared memory and are summed in warp order, one output a
//   thread; then J's rounding points: gate = dot * scale and up = dot *
//   scale in f32, act = bf16(silu(gate) * up).
// - down (down_q8_kernel): a block an H tile of 16 columns (80 blocks at H
//   1280) walks the visits in order. Its producer warp reads each visit's
//   weights a visit ahead (one lane a row, a ballot) and cuts the visit
//   into parts of at most 8 of the rows whose weight is not zero (a
//   pseudo-expert takes every row, weight 1; a visit no row of the group
//   selected is skipped): a stage a part (up to 7 of them), holding those
//   rows' act (one copy each), the tile's 16 code rows of down [E, H, I]
//   (one copy of 14 KB at I 896), their scales and the rows' list with
//   their weights. At 16 rows a routed expert is chosen by about 2 of
//   them, so a stage moves about 18 KB in 4 copies, where every row's act
//   would be 29 KB more; a row skipped would have added y * 0, so no bit
//   changes. The products take the tile's code rows as A (m16) and the
//   part's act rows as B (n8); the warps' partials meet in shared memory,
//   y = dot * scale, and the thread that owns an output adds y * w to its
//   row's f32 sum in shared memory, part after part in the visits'
//   ascending order (the valid visits, then the pseudo-experts); out [B, H]
//   is written once.
// - Where down's time goes is open (PERF.md): about 1.1 us a stage at 16
//   rows (58-68 us for 55), the same with 4 or 7 stages, tiles of 10 or 16
//   columns, a producer reading its weights from a cp.async ring 8 visits
//   ahead, or without products (52-55 us); without the act rows' copies 46
//   us; with every row's act 149 us (scripts/torch_moe_q8_ablate.py).
// - Rows: up to 32 a launch pair (two m16 tiles); B > 32 runs as groups of
//   32 rows, each streaming the weights again. A row's bits depend on its
//   own x row and routing alone: mma rows are independent, the warp order
//   and the visit order are fixed, and a visit the row did not select adds
//   nothing.
//
// Under expert parallelism (ops/moe.local_routing) the schedule lists only
// the rank's own experts, so a pad visit is neither read nor added, a batch
// with no local selection writes zeros, and out may be f32 (out_f32: the
// rank's partial unrounded, summed over the ranks before one rounding).
//
// Shapes of the stream: bf16 x, bf16 or f32 out, H and I multiples of 64, H <= 1536
// (x's fragments in registers: 3 chunks a warp), 16-byte aligned codes and
// scales (the wrapper checks them; ops/moe_decode.moe_ffn_decode_q8_fused
// dispatches by dtype and shape).

#include "moe_quant.cuh"
#include "sm90.cuh"

MOE_QUANT_ENTRY(moe_q8_f32, moe_quant::Q8, float)
MOE_QUANT_ENTRY(moe_q8_bf16, moe_quant::Q8, __nv_bfloat16)

namespace {

using bf16 = __nv_bfloat16;
using gemv::FULL;
using gemv::word;
using moe_quant::count_valid;
using moe_quant::silu;
using moe_quant::visit_expert;

constexpr int ROWS = 32;      // decode rows a launch pair: two m16 tiles
constexpr int KC = 64;        // a chunk of the contraction: 16 codes a lane (one 16-byte load), 4 k16 steps
constexpr int GU_WARPS = 8;   // consumer warps of gate/up, chunks w, w + 8, ... of H each
constexpr int GU_CPW = 3;     // chunks a warp keeps x for: H <= 64 * 8 * 3
constexpr int GU_NT = 2;      // n8 tiles an item: 16 columns of I, 16 gate and 16 up code rows a stage
constexpr int DN_WARPS = 8;   // consumer warps of down, chunks w, w + 8, ... of I each
constexpr int DN_COLS = 16;   // H columns a down block: the m16 tile of its products
constexpr int DN_ROWS = 8;    // decode rows a down stage: the n8 tile
constexpr int GU_MAX_STAGES = 4;
constexpr int DN_MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448 - 128;  // the opt-in limit, less the kernels' static shared memory

// Elements of an act row in a down stage: I rounded up to 64, plus 8 (its
// bytes 16 mod 128: the two rows a quarter-warp's 16-byte loads touch on
// distinct banks).
__host__ __device__ __forceinline__ int act_stride(int n) { return (n + 63) / 64 * 64 + 8; }

__host__ __device__ __forceinline__ int fit_stages(int fixed, int stage_bytes, int most) {
  const int fit = (SMEM_MAX - fixed - 2 * most * 8) / stage_bytes;  // the ring's mbarriers too
  return fit < most ? fit : most;
}

// Four int8 codes (one word, byte j = code j) as two bf16 pairs, exactly:
// b[0] = (c0, c1), b[1] = (c2, c3), the lower code in the low half. c ^ 0x80
// = c + 128 as a byte goes into the low mantissa byte of 2^23 (a byte
// permute), one FADD takes 2^23 + 128 off, and the f32 of an integer with
// |c| <= 128 has its low 16 bits zero, so its high half is its bf16. A
// convert instruction would run at a quarter of the FADD's rate.
__device__ __forceinline__ void codes_bf16x2(uint32_t w, uint32_t (&b)[2]) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) - 8388736.f);
  b[0] = __byte_perm(f[0], f[1], 0x7632);
  b[1] = __byte_perm(f[2], f[3], 0x7632);
}

// The A fragment of k16 step j of a chunk from 16 bf16 values of each of
// its two rows (lo: row g, hi: row g + 8; lane (g, t) holds the chunk's
// values 16 t .. 16 t + 15): logical k (2t, 2t + 1) is physical 16 t + 4 j
// + (0, 1), (2t + 8, 2t + 9) is 16 t + 4 j + (2, 3), as for the codes.
__device__ __forceinline__ void a_frag(const uint4 (&lo)[2], const uint4 (&hi)[2], int j, uint32_t (&a)[4]) {
  a[0] = word(lo[j / 2], 2 * (j % 2));
  a[1] = word(hi[j / 2], 2 * (j % 2));
  a[2] = word(lo[j / 2], 2 * (j % 2) + 1);
  a[3] = word(hi[j / 2], 2 * (j % 2) + 1);
}

struct Streams {
  const int8_t* gu;    // [E, 2I, H]
  const float* gus;    // [E, 2I]
  const int8_t* down;  // [E, H, I]
  const float* ds;     // [E, H]
  const int8_t* pgu;   // the n_sh pseudo-experts, the same layouts
  const float* pgus;
  const int8_t* pdown;
  const float* pds;
};

// A gate/up stage: the item's 16 gate code rows (one bulk copy of 16 H
// contiguous bytes), its 16 up rows (another), then their 32 scales.
template <int MT>
struct GuLayout {
  int scale_off, stage_bytes, stages, red_off, bar_off;
  size_t smem;
  __host__ __device__ explicit GuLayout(int h_dim) {
    scale_off = 2 * 8 * GU_NT * h_dim;
    stage_bytes = (scale_off + 2 * 8 * GU_NT * 4 + 127) / 128 * 128;
    const int red = 2 * GU_WARPS * MT * GU_NT * 2 * 32 * 16;  // [2][warp][m][n][gate, up][lane] float4
    stages = fit_stages(red, stage_bytes, GU_MAX_STAGES);
    red_off = stages * stage_bytes;
    bar_off = red_off + red;
    smem = bar_off + 2 * stages * 8;
  }
};

// Launch 1. Items (visit v, 16 columns i0 = 16 c of I), v-major over the nv
// valid visits and then the n_sh pseudo-experts; block b takes items b, b +
// gridDim.x, ..., its j-th in ring slot j % stages. x rows [0, nb) (nb <=
// 16 MT), act [nv + n_sh, nb, I].
template <int MT>
__global__ void __launch_bounds__(32 * (GU_WARPS + 1), 1)
    gu_q8_kernel(const bf16* __restrict__ x, Streams w, const int* __restrict__ ve, const int* __restrict__ valid,
                 bf16* __restrict__ act, int nb, int n_exp, int n_sh, int h_dim, int i_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GuLayout<MT> lay(h_dim);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + lay.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < lay.stages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], GU_WARPS);
    }
    sm90::mbar_fence_init();
  }
  constexpr int R = 8 * GU_NT;  // gate rows a stage, and as many up rows
  const int nv = count_valid(valid, n_exp, lane), n_visits = nv + n_sh, n_cols = i_dim / R;
  const int n_items = n_visits * n_cols;
  __syncthreads();

  if (warp == GU_WARPS) {  // the producer
    if (lane != 0) return;
    int e_next = visit_expert(ve, blockIdx.x / n_cols, nv, n_visits);
    for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
      const int v = it / n_cols, i0 = R * (it - v * n_cols);
      const size_t e = e_next;
      e_next = visit_expert(ve, (it + gridDim.x) / n_cols, nv, n_visits);  // the next item's, loaded early
      const int slot = j % lay.stages;
      sm90::mbar_wait(&empty[slot], ((j / lay.stages) & 1) ^ 1);  // a fresh slot passes at once
      const bool pe = v >= nv;
      const int8_t* codes = (pe ? w.pgu : w.gu) + e * 2 * i_dim * h_dim;
      const float* scales = (pe ? w.pgus : w.gus) + e * 2 * i_dim;
      unsigned char* dst = smem + slot * lay.stage_bytes;
      sm90::mbar_arrive_expect_tx(&full[slot], 2 * R * (h_dim + 4));
      sm90::bulk_load(dst, codes + (size_t)i0 * h_dim, R * h_dim, &full[slot]);
      sm90::bulk_load(dst + R * h_dim, codes + (size_t)(i_dim + i0) * h_dim, R * h_dim, &full[slot]);
      sm90::bulk_load(dst + lay.scale_off, scales + i0, R * 4, &full[slot]);
      sm90::bulk_load(dst + lay.scale_off + R * 4, scales + i_dim + i0, R * 4, &full[slot]);
    }
    return;
  }

  // Consumer warp `warp`: chunks warp, warp + 8, ... of H; its x fragments
  // (A of m16n8k16: rows 16 m + g, + 8; a_frag's k order) in registers.
  const int g = lane / 4, t = lane % 4;
  const int n_ch = h_dim / KC;
  uint4 xa[MT][GU_CPW][2][2];  // [m][chunk][row g, g + 8][16 values]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int cc = 0; cc < GU_CPW; ++cc) {
      const int ch = warp + GU_WARPS * cc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        const bool in = ch < n_ch && r < nb;
        const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)r * h_dim + KC * ch + 16 * t);
        xa[m][cc][h][0] = in ? __ldg(p) : make_uint4(0u, 0u, 0u, 0u);
        xa[m][cc][h][1] = in ? __ldg(p + 1) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  float4* red = reinterpret_cast<float4*>(smem + lay.red_off);
  // This thread's outputs o = threadIdx.x + 256 r (r < MT): element c = o %
  // 4 of lane l = (o / 4) % 32's C fragment of n tile (o / 128) % GU_NT, m
  // tile o / (128 GU_NT): row 16 m + l / 4 + 8 (c / 2), column i0 + 8 n + 2
  // (l % 4) + c % 2 (the same column for every r).
  constexpr int N_OUT = MT * 128 * GU_NT, PER = (N_OUT + 32 * GU_WARPS - 1) / (32 * GU_WARPS);
  const int u = threadIdx.x, uc = u % 4, ul = (u / 4) % 32, un = (u / 128) % GU_NT;
  const int ucol = 8 * un + 2 * (ul % 4) + uc % 2;
  for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
    const int slot = j % lay.stages;
    sm90::mbar_wait(&full[slot], (j / lay.stages) & 1);
    const unsigned char* st = smem + slot * lay.stage_bytes;
    float cg[MT][GU_NT][4], cu[MT][GU_NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < GU_NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) cg[m][n][c] = cu[m][n][c] = 0.f;
#pragma unroll
    for (int cc = 0; cc < GU_CPW; ++cc) {
      const int ch = warp + GU_WARPS * cc;
      if (ch < n_ch) {
#pragma unroll
        for (int n = 0; n < GU_NT; ++n) {
          const unsigned char* row = st + (size_t)(8 * n + g) * h_dim + KC * ch + 16 * t;
          const uint4 wg = *reinterpret_cast<const uint4*>(row);
          const uint4 wu = *reinterpret_cast<const uint4*>(row + R * h_dim);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t bg[2], bu[2];
            codes_bf16x2(word(wg, s), bg);
            codes_bf16x2(word(wu, s), bu);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              uint32_t a[4];
              a_frag(xa[m][cc][0], xa[m][cc][1], s, a);
              sm90::mma_bf16_16816(cg[m][n], a, bg[0], bg[1]);
              sm90::mma_bf16_16816(cu[m][n], a, bu[0], bu[1]);
            }
          }
        }
      }
    }
    // This thread's gate and up scales, read before the slot is freed.
    const float* sc = reinterpret_cast<const float*>(st + lay.scale_off);
    const float sg = sc[ucol], su = sc[R + ucol];
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);  // the stage is read: refill it
    float4* rb = red + (j & 1) * GU_WARPS * MT * GU_NT * 2 * 32;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < GU_NT; ++n) {
        const int base = (((warp * MT + m) * GU_NT + n) * 2) * 32 + lane;
        rb[base] = make_float4(cg[m][n][0], cg[m][n][1], cg[m][n][2], cg[m][n][3]);
        rb[base + 32] = make_float4(cu[m][n][0], cu[m][n][1], cu[m][n][2], cu[m][n][3]);
      }
    sm90::bar_sync(1, 32 * GU_WARPS);
    // The warps' partials summed in warp order; J's rounding points.
    const float* rf = reinterpret_cast<const float*>(rb);
    const int v = it / n_cols, i0 = R * (it - v * n_cols);
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int o = u + 32 * GU_WARPS * r;
      if (o < N_OUT) {
        const int m = o / (128 * GU_NT), row = 16 * m + ul / 4 + 8 * (uc / 2);
        float gs = 0.f, us = 0.f;
#pragma unroll
        for (int ww = 0; ww < GU_WARPS; ++ww) {
          const int base = ((((ww * MT + m) * GU_NT + un) * 2) * 32 + ul) * 4 + uc;
          gs += rf[base];
          us += rf[base + 128];
        }
        if (row < nb) act[((size_t)v * nb + row) * i_dim + i0 + ucol] = __float2bfloat16_rn(silu(gs * sg) * (us * su));
      }
    }
  }
}

// A down stage, a part of a visit: the act rows of up to 8 of the decode
// rows whose weight for the visit is not zero (compacted, at stride
// act_stride(I)), the tile's 16 code rows (one bulk copy of 16 I contiguous
// bytes), their 16 scales, then the rows' list: how many (-1: the walk's
// end), each one's batch row and weight.
struct DnLayout {
  int as, codes_off, scale_off, meta_off, stage_bytes, stages, red_off, out_off, bar_off;
  size_t smem;
  __host__ __device__ explicit DnLayout(int i_dim) {
    as = act_stride(i_dim);
    codes_off = DN_ROWS * as * 2;
    scale_off = codes_off + DN_COLS * i_dim;
    meta_off = scale_off + DN_COLS * 4;
    stage_bytes = (meta_off + 16 + 2 * DN_ROWS * 4 + 127) / 128 * 128;
    const int red = 2 * DN_WARPS * 32 * 16;  // [2][warp][lane] float4
    const int out = ROWS * DN_COLS * 4;      // the output tile's f32 sums
    stages = fit_stages(red + out, stage_bytes, DN_MAX_STAGES);
    red_off = stages * stage_bytes;
    out_off = red_off + red;
    bar_off = out_off + out;
    smem = bar_off + 2 * stages * 8;
  }
};

// Launch 2. Block b: output columns [16 b, 16 b + 16) of every row. The
// producer warp walks the visits in order and cuts each into parts of at
// most 8 of its rows with a nonzero weight (a row that did not select the
// visit's expert would add y * 0: skipping it changes no bit; a visit no
// row of the group selected is skipped whole; a pseudo-expert takes every
// row with weight 1), a stage a part; the consumers take the stages in
// order until the end mark. The products: the tile's 16 code rows as A
// (m16), the part's act rows as B (n8). w_visit rows ldw apart; act [nv +
// n_sh, nb, I]; out in TO (bf16, or f32 unrounded).
template <typename TO>
__global__ void __launch_bounds__(32 * (DN_WARPS + 1), 1)
    down_q8_kernel(const bf16* __restrict__ act, Streams w, const int* __restrict__ ve, const int* __restrict__ valid,
                   const float* __restrict__ w_visit, int ldw, TO* __restrict__ out, int nb, int n_exp, int n_sh,
                   int h_dim, int i_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DnLayout lay(i_dim);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + lay.stages;
  float* out_s = reinterpret_cast<float*>(smem + lay.out_off);  // [ROWS][DN_COLS]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h0 = blockIdx.x * DN_COLS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < lay.stages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], DN_WARPS);
    }
    sm90::mbar_fence_init();
  }
  for (int i = threadIdx.x; i < ROWS * DN_COLS; i += blockDim.x) out_s[i] = 0.f;
  __syncthreads();

  if (warp == DN_WARPS) {  // the producer warp: lane b reads row b's weight, lane 0 copies
    const int nv = count_valid(valid, n_exp, lane), n_visits = nv + n_sh;
    auto weight = [&](int v) {
      return lane >= nb || v >= n_visits ? 0.f : v < nv ? w_visit[(size_t)v * ldw + lane] : 1.f;
    };
    float w_next = weight(0);
    int e_next = visit_expert(ve, 0, nv, n_visits);
    int j = 0;  // stages filled
    for (int v = 0; v < n_visits; ++v) {
      const float wv = w_next;
      const size_t e = e_next;
      w_next = weight(v + 1);  // the next visit's, loaded early
      e_next = visit_expert(ve, v + 1, nv, n_visits);
      const unsigned mask = __ballot_sync(FULL, wv != 0.f);
      const int n_rows = __popc(mask), idx = __popc(mask & ((1u << lane) - 1));  // this row's place
      const bool pe = v >= nv;
      const int8_t* codes = (pe ? w.pdown : w.down) + (e * h_dim + h0) * i_dim;
      const float* scales = (pe ? w.pds : w.ds) + e * h_dim + h0;
      unsigned rest = mask;
      for (int p0 = 0; p0 < n_rows; p0 += DN_ROWS, ++j) {
        const int slot = j % lay.stages, cnt = min(DN_ROWS, n_rows - p0);
        if (lane == 0) sm90::mbar_wait(&empty[slot], ((j / lay.stages) & 1) ^ 1);
        __syncwarp();
        unsigned char* dst = smem + slot * lay.stage_bytes;
        int* meta = reinterpret_cast<int*>(dst + lay.meta_off);  // count, 3 unused, rows[8], weights[8]
        if (wv != 0.f && idx >= p0 && idx < p0 + DN_ROWS) {
          meta[4 + idx - p0] = lane;
          reinterpret_cast<float*>(meta)[4 + DN_ROWS + idx - p0] = wv;
        }
        if (lane == 0) meta[0] = cnt;
        __syncwarp();  // the list is written before lane 0's arrival publishes it
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&full[slot], cnt * i_dim * 2 + DN_COLS * (i_dim + 4));
          for (int r = 0; r < cnt; ++r, rest &= rest - 1)
            sm90::bulk_load(dst + r * lay.as * 2, act + ((size_t)v * nb + __ffs(rest) - 1) * i_dim, i_dim * 2,
                            &full[slot]);
          sm90::bulk_load(dst + lay.codes_off, codes, DN_COLS * i_dim, &full[slot]);
          sm90::bulk_load(dst + lay.scale_off, scales, DN_COLS * 4, &full[slot]);
        }
        __syncwarp();
      }
    }
    if (lane == 0) {  // the end mark: a stage with no bytes and count -1
      const int slot = j % lay.stages;
      sm90::mbar_wait(&empty[slot], ((j / lay.stages) & 1) ^ 1);
      reinterpret_cast<int*>(smem + slot * lay.stage_bytes + lay.meta_off)[0] = -1;
      sm90::mbar_arrive(&full[slot]);
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int n_ch = i_dim / KC;
  // This thread's output (threads u < 128): element c = u % 4 of lane l =
  // u / 4's C fragment: column h0 + l / 4 + 8 (c / 2), compact row 2 (l %
  // 4) + c % 2 of the part.
  const int u = threadIdx.x, uc = u % 4, ul = u / 4;
  const int ucol = ul / 4 + 8 * (uc / 2), urow = 2 * (ul % 4) + uc % 2;
  float4* red = reinterpret_cast<float4*>(smem + lay.red_off);
  for (int j = 0;; ++j) {
    const int slot = j % lay.stages;
    sm90::mbar_wait(&full[slot], (j / lay.stages) & 1);
    const unsigned char* st = smem + slot * lay.stage_bytes;
    const int* meta = reinterpret_cast<const int*>(st + lay.meta_off);
    const int cnt = meta[0];
    if (cnt < 0) break;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = warp; ch < n_ch; ch += DN_WARPS) {
      const unsigned char* crow = st + lay.codes_off + (size_t)g * i_dim + KC * ch + 16 * t;  // code rows g, g + 8
      const uint4 wlo = *reinterpret_cast<const uint4*>(crow);
      const uint4 whi = *reinterpret_cast<const uint4*>(crow + 8 * i_dim);
      const bf16* arow = reinterpret_cast<const bf16*>(st) + g * lay.as + KC * ch + 16 * t;  // act row g of the part
      const uint4 x0 = reinterpret_cast<const uint4*>(arow)[0], x1 = reinterpret_cast<const uint4*>(arow)[1];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t lo[2], hi[2];
        codes_bf16x2(word(wlo, s), lo);
        codes_bf16x2(word(whi, s), hi);
        const uint32_t a[4] = {lo[0], hi[0], lo[1], hi[1]};
        const uint4& xs = s < 2 ? x0 : x1;
        sm90::mma_bf16_16816(c, a, word(xs, 2 * (s % 2)), word(xs, 2 * (s % 2) + 1));
      }
    }
    // This thread's scale, batch row and weight (row -1: past the count or
    // no output), read before the slot is freed.
    float scale = 0.f, bw = 0.f;
    int brow = -1;
    if (u < 128 && urow < cnt) {
      scale = reinterpret_cast<const float*>(st + lay.scale_off)[ucol];
      brow = meta[4 + urow];
      bw = reinterpret_cast<const float*>(meta)[4 + DN_ROWS + urow];
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);
    float4* rb = red + (j & 1) * DN_WARPS * 32;
    rb[warp * 32 + lane] = make_float4(c[0], c[1], c[2], c[3]);
    sm90::bar_sync(1, 32 * DN_WARPS);
    // y = dot * scale; y * w added to the output's sum, part after part in
    // the visits' ascending order (a pseudo-expert's weight is 1: y * 1 = y).
    if (brow >= 0) {
      const float* rf = reinterpret_cast<const float*>(rb);
      float y = 0.f;
#pragma unroll
      for (int ww = 0; ww < DN_WARPS; ++ww) y += rf[(ww * 32 + ul) * 4 + uc];
      float* o = out_s + brow * DN_COLS + ucol;
      *o = __fadd_rn(*o, __fmul_rn(__fmul_rn(y, scale), bw));
    }
  }
  sm90::bar_sync(1, 32 * DN_WARPS);
  for (int i = u; i < nb * DN_COLS / 2; i += 32 * DN_WARPS) {
    const int row = i / (DN_COLS / 2), col = 2 * (i % (DN_COLS / 2));
    const float s0 = out_s[row * DN_COLS + col], s1 = out_s[row * DN_COLS + col + 1];
    if constexpr (sizeof(TO) == 4) {
      *reinterpret_cast<float2*>(out + (size_t)row * h_dim + h0 + col) = make_float2(s0, s1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * h_dim + h0 + col) = __floats2bfloat162_rn(s0, s1);
    }
  }
}

template <int MT, typename TO>
int launch_rows(const bf16* x, const Streams& w, const int* ve, const int* valid, const float* w_visit, int ldw,
                bf16* act, TO* out, int nb, int n_exp, int n_sh, int h_dim, int i_dim, cudaStream_t s) {
  const GuLayout<MT> gl(h_dim);
  const DnLayout dl(i_dim);
  if (gl.stages < 2 || dl.stages < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gu_q8_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gl.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(down_q8_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dl.smem);
  if (err != cudaSuccess) return (int)err;
  gu_q8_kernel<MT><<<q4::sm_count(), 32 * (GU_WARPS + 1), gl.smem, s>>>(x, w, ve, valid, act, nb, n_exp, n_sh, h_dim,
                                                                      i_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_q8_kernel<TO><<<h_dim / DN_COLS, 32 * (DN_WARPS + 1), dl.smem, s>>>(act, w, ve, valid, w_visit, ldw, out, nb,
                                                                            n_exp, n_sh, h_dim, i_dim);
  return (int)cudaGetLastError();
}

// Groups of up to 32 rows, each its own launch pair on the same act (stream
// order keeps them apart).
template <typename TO>
int launch_groups(const bf16* x, const Streams& w, const int* ve, const int* valid, const float* w_visit, bf16* act,
                  TO* out, int nb, int n_exp, int n_sh, int h_dim, int i_dim, cudaStream_t s) {
  for (int b0 = 0; b0 < nb; b0 += ROWS) {
    const int rows = min(ROWS, nb - b0);
    const auto launch = rows <= 16 ? launch_rows<1, TO> : launch_rows<2, TO>;
    const int err = launch(x + (size_t)b0 * h_dim, w, ve, valid, w_visit + b0, nb, act, out + (size_t)b0 * h_dim,
                           rows, n_exp, n_sh, h_dim, i_dim, s);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// Kernel J with bf16 x on the stream. x [B, H] bf16; gu / gus / down / ds
// the routed experts and pgu / pgus / pdown / pds the n_sh pseudo-experts
// (null when n_sh = 0) in moe_quant.cuh's layout; ve / valid int32 [E] and
// w_visit f32 [E, B] from the schedule; act: the workspace, [E + n_sh,
// min(B, 32), I] bf16; out [B, H] bf16, or f32 when out_f32. Groups of up
// to 32 rows, each its own launch pair on the same act (stream order keeps
// them apart).
extern "C" int moe_q8_stream_bf16(const void* x, const void* gu, const void* gus, const void* down, const void* ds,
                                  const void* pgu, const void* pgus, const void* pdown, const void* pds,
                                  const void* ve, const void* valid, const void* w_visit, void* act, void* out, int nb,
                                  int n_exp, int n_sh, int h_dim, int i_dim, int out_f32, void* stream) {
  if (nb <= 0 || n_exp <= 0 || n_sh < 0 || h_dim <= 0 || i_dim <= 0 || h_dim % KC || i_dim % KC ||
      h_dim > KC * GU_WARPS * GU_CPW || (n_sh > 0 && (!pgu || !pgus || !pdown || !pds))) {
    return (int)cudaErrorInvalidValue;
  }
  const Streams w{static_cast<const int8_t*>(gu),  static_cast<const float*>(gus), static_cast<const int8_t*>(down),
                  static_cast<const float*>(ds),   static_cast<const int8_t*>(pgu), static_cast<const float*>(pgus),
                  static_cast<const int8_t*>(pdown), static_cast<const float*>(pds)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const int* v = static_cast<const int*>(ve);
  const int* vd = static_cast<const int*>(valid);
  const float* wv = static_cast<const float*>(w_visit);
  bf16* a = static_cast<bf16*>(act);
  if (out_f32) return launch_groups(xb, w, v, vd, wv, a, static_cast<float*>(out), nb, n_exp, n_sh, h_dim, i_dim, s);
  return launch_groups(xb, w, v, vd, wv, a, static_cast<bf16*>(out), nb, n_exp, n_sh, h_dim, i_dim, s);
}
