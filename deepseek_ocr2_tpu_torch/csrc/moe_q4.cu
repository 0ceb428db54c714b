// Int4-weight decode MoE for sm_90a: kernels M and N.
//
// M replaces deepseek_ocr2_tpu/ops/moe_q4.py: _q4_kernel and _q4_pe_kernel
// (via moe_ffn_decode_q4): one visit per (row, selection), plus the shared
// pseudo-experts at one row. N replaces deepseek_ocr2_tpu/ops/moe_q4.py:
// _decode_q4_kernel and _decode_q4_pe_kernel (via moe_ffn_decode_q4_fused):
// one visit per distinct selected expert, then the pseudo-experts. M, and N
// with f32 x or a shape the stream below does not take, run moe_quant.cuh's
// kernels (kernels I's and J's first form) on linear_q4.cuh's int4 dots.
// N with bf16 x otherwise runs the stream below. The layout (codes [.., In /
// 2], group-128 scales [.., In / 128]) and the rounding points are
// moe_quant.cuh's:
//   gate = sum_g s_g (x_g . gate_g), up the same, each in f32;
//   act  = bf16(silu(gate) * up);
//   y    = sum_g s_g (act_g . down_g) in f32;
//   out  = bf16(sum over visits of y * w).
//
// What bounds it: the int4 expert bytes, 3 * H * I / 2 + scales = 1.83 MB
// an expert at H = 1280, I = 896. M at b = 1 with the pseudo-experts: 8
// visits, 14.6 MB, 0.0044 ms at 3.35 TB/s per MoE layer. N at 16 rows:
// about 53 distinct experts + 2 pseudo-experts, 100 MB, 0.030 ms: 67 MB of
// gate/up and 34 MB of down.
//
// N's first form (moe_quant.cuh) ran a grid of visits x column tiles, warps
// loading code rows straight from global memory, and an f32 yw [V, B, H]
// that a third launch summed: 0.151 ms at 16 rows in a CUDA graph on an
// H100, 19 % of the bound (PERF.md). The stream, after the schedule's
// launch (kernel F's schedule_kernel: ve, valid, w_visit, no host sync),
// is two launches:
// - The visits are the valid routed ones in ascending expert id, then the
//   n_sh pseudo-experts; visit v of that compact list writes act [v, B, I].
// - gate/up (gu_q4_kernel) is kernel J's design (moe_q8.cu) over int4
//   codes: a persistent grid, one block an SM, one producer warp, one
//   compute warp for each 128-level group of H (10 at H 1280) and 4
//   reducer warps, over items (visit, 32 columns of I). A stage holds the
//   item's 32 gate code rows (one bulk copy of 20 KB at H 1280), its 32 up
//   rows and their group scales (two more): four copies for 42.5 KB, 3 or
//   4 stages. Compute warp w keeps its x fragments for group w in registers
//   for the whole launch and runs mma.sync m16n8k16 with the decode rows as
//   A and each n8 tile of code rows as B. A lane reads 16 code bytes of a
//   row (32 levels, one load) and decodes them as kernel L does, two levels
//   a byte permute into bf16 pairs 128 + c and 136 off, exactly: word c of
//   the lane's 16 bytes gives the pairs (0, 2), (1, 3), (4, 6), (5, 7) of
//   its 8 levels, so k16 step (c, s) takes logical k (2t, 2t + 1) at the
//   physical 32 t + 8 c + 4 s + (0, 2) and (2t + 8, 2t + 9) at + (1, 3) of
//   the group; x's fragments are loaded in the same order (frag_order: bits
//   0 and 1 of a position swapped). Each compute warp's f32 tile is its
//   group's dot, times the group's scale before it leaves the warp, into
//   one of two shared buffers (one at 32 rows); the reducer warps sum the
//   tiles in warp order, the groups' order (outputs spread over their
//   lanes), then act = bf16(silu(gate) * up), written in the order down's
//   fragments read it. The hand-over goes through mbarriers, so the compute
//   warps go on to the next item while the last one is summed: summed by
//   the compute warps themselves between two block barriers an item, the
//   sums took a quarter of the launch (scripts/torch_moe_q4_ablate.py).
// - down (down_q4_kernel) is not J's walk of every visit by 80 blocks, one
//   visit a stage: that walk took about 1.1 us a stage at 16 rows whatever
//   its stages, tiles, products or weight loads (PERF.md). Here a block
//   takes 80 columns of H (one n8 tile a consumer warp) and one part of
//   the visits: the visits are cut at fixed expert ids into P parts (part p
//   the ids [NI p / P, NI (p + 1) / P) of the NI = E + n_sh ids, routed
//   expert e id e, pseudo-expert t id E + t), P = SMs / tiles (8 at H 1280:
//   128 blocks), so a block walks about 7 visits where J's walked 55. A
//   stage is one visit: the act rows of every decode row (one bulk copy of
//   30 KB at 16 rows, L2-resident), the tile's 80 code rows (one copy of 35
//   KB at I 896) and their scales (one more). The products take the act
//   rows as A (every row of the group: a row that did not select the visit
//   adds y * 0, which changes no bit) and the tile's code rows as B; a warp
//   owns its 8 columns over all of I, so its sums stay in registers: y =
//   sum_g s_g (act_g . down_g) in group order, then y * w added to the
//   row's f32 sum of the part, visit after visit in ascending id, with no
//   shared-memory reduction and no block barrier a stage. The blocks of a
//   tile write their parts' sums to a workspace [P, B, H] f32; the last of
//   them to arrive (an arrival counter a tile, shared with kernels G, K,
//   O, P, Q, R and X, set back to zero by that block for the next launch
//   or a graph's replay) adds the P sums in part order and writes out [B,
//   H] once.
// - What limits it (an H100, scripts/torch_moe_q4_ablate.py, PERF.md): at
//   16 rows 0.067 ms in a CUDA graph, 43 % of the bound. gate/up 31 us (2.1
//   TB/s) takes as long with no copies at all: its compute warps' decode
//   and products bound it, as the tile sums did (10 us) before they moved
//   to the reducer warps. down 26 us, about 25 with no copies: its
//   consumers, 7 to 9 stages a block (two chains of mma sums a group took
//   2 us off one; four groups at once, 6 us on). The schedule 7 us.
// - Rows: up to 32 a launch pair (two m16 tiles); B > 32 runs as groups of
//   32 rows, each streaming the weights again. A row's bits depend on its
//   own x row and routing alone: mma rows are independent, the warp, visit
//   and part orders are fixed by the shapes, the parts are cut at fixed ids
//   (not at places in the visit list), and a visit the row did not select
//   adds nothing.
//
// Shapes of the stream: bf16 x and out, H and I multiples of 128, H <= 1280
// (a gate/up compute warp for each group of H), 16-byte aligned codes and
// scales (the wrapper checks them; ops/moe_q4.moe_ffn_decode_q4_fused
// dispatches by dtype and shape).

#include "moe_quant.cuh"
#include "sm90.cuh"

MOE_QUANT_ENTRY(moe_q4_f32, moe_quant::Q4, float)
MOE_QUANT_ENTRY(moe_q4_bf16, moe_quant::Q4, __nv_bfloat16)

namespace {

using bf16 = __nv_bfloat16;
using gemv::FULL;
using gemv::word;
using moe_quant::count_valid;
using moe_quant::silu;
using moe_quant::visit_expert;
using q4::pair_perm_bf16;

constexpr int ROWS = 32;        // decode rows a launch pair: two m16 tiles
constexpr int GROUP = 128;      // levels a group: one scale
constexpr int GB = GROUP / 2;   // code bytes a group of a row
constexpr int GU_MAX_WARPS = 10;  // gate/up compute warps, one a group of H: H <= 1280
constexpr int GU_RED = 4;       // gate/up warps that sum the compute warps' tiles
constexpr int GU_NT = 4;        // n8 tiles an item: 32 columns of I
constexpr int GU_COLS = 8 * GU_NT;
constexpr int GU_MAX_STAGES = 4;
constexpr int DN_MAX_WARPS = 10;  // down consumer warps, one n8 tile of H a warp
constexpr int DN_MAX_STAGES = 4;
constexpr int SMEM_MAX = 232448 - 256;  // the opt-in limit, less the kernels' static shared memory
constexpr int ACT_PAD = 32;     // act row stride I + 32: 64 bytes past a multiple of 128

__host__ __device__ __forceinline__ int round128(int n) { return (n + 127) / 128 * 128; }

__host__ __device__ __forceinline__ int fit_stages(int fixed, int stage_bytes, int most) {
  const int fit = (SMEM_MAX - fixed - 2 * most * 8) / stage_bytes;  // the ring's mbarriers too
  return fit < most ? fit : most;
}

// 8 bf16 x or act values (one 16-byte chunk: physical positions 0 .. 7) in
// fragment order: bits 0 and 1 of a position swapped, p0 p2 p1 p3 p4 p6 p5
// p7, so that word j of the chunk is the pair decode_pairs gives as pair j.
__device__ __forceinline__ uint4 frag_order(uint4 v) {
  return make_uint4(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.x, v.y, 0x7632), __byte_perm(v.z, v.w, 0x5410),
                    __byte_perm(v.z, v.w, 0x7632));
}

// Where logical column i of an act row is stored: group i / 128, then the
// 16-byte chunk (c, t) that lane t reads as its word c (positions 32 t + 8 c
// .. + 7 of the group) at element 32 c + 8 t, in fragment order.
__host__ __device__ __forceinline__ int act_index(int i) {
  const int r = i % GROUP, t = r / 32, c = (r % 32) / 8, e = r % 8;
  return i - r + 32 * c + 8 * t + ((e & 4) | ((e & 1) << 1) | ((e >> 1) & 1));
}

// The 8 levels of a code word (positions 8 c .. 8 c + 7 of the lane's 32)
// as four bf16 pairs, exactly: p[0] = (n0, n2), p[1] = (n1, n3), p[2] = (n4,
// n6), p[3] = (n5, n7); k16 step (c, 0) takes p[0], p[1] as B's two
// registers, step (c, 1) p[2], p[3].
__device__ __forceinline__ void decode_pairs(uint32_t u, uint32_t (&p)[4]) {
  const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
  p[0] = pair_perm_bf16(lo, 0x4140);
  p[1] = pair_perm_bf16(hi, 0x4140);
  p[2] = pair_perm_bf16(lo, 0x4342);
  p[3] = pair_perm_bf16(hi, 0x4342);
}

struct Streams {
  const uint8_t* gu;    // [E, 2I, H / 2]
  const float* gus;     // [E, 2I, H / 128]
  const uint8_t* down;  // [E, H, I / 2]
  const float* ds;      // [E, H, I / 128]
  const uint8_t* pgu;   // the n_sh pseudo-experts, the same layouts
  const float* pgus;
  const uint8_t* pdown;
  const float* pds;
};

// A gate/up stage: the item's 32 gate code rows (one bulk copy of 32 H / 2
// contiguous bytes), its 32 up rows (another), then their scales (32 rows
// of H / 128 each, two more copies). The compute warps' tiles meet in
// `bufs` buffers: two where they leave room for three stages (up to 16
// rows), else one.
template <int MT>
struct GuLayout {
  int rb, ng, scale_off, stage_bytes, stages, red_off, red_bytes, bufs, bar_off, warps;
  size_t smem;
  __host__ __device__ explicit GuLayout(int h_dim) {
    rb = h_dim / 2;
    ng = h_dim / GROUP;
    warps = ng;
    scale_off = 2 * GU_COLS * rb;
    stage_bytes = round128(scale_off + 2 * GU_COLS * ng * 4);
    red_bytes = warps * MT * GU_NT * 2 * 32 * 16;  // [warp][m][n][gate, up][lane] float4
    bufs = fit_stages(2 * red_bytes, stage_bytes, GU_MAX_STAGES) >= 3 ? 2 : 1;
    stages = fit_stages(bufs * red_bytes, stage_bytes, GU_MAX_STAGES);
    red_off = stages * stage_bytes;
    bar_off = red_off + bufs * red_bytes;
    smem = bar_off + 2 * (stages + bufs) * 8;
  }
};

// Launch 1. Items (visit v, 32 columns i0 = 32 c of I), v-major over the nv
// valid visits and then the n_sh pseudo-experts; block b takes items b, b +
// gridDim.x, ..., its j-th in ring slot j % stages and tile buffer j % bufs.
// Warps 0 .. H / 128 - 1 compute (warp w: group w of H), the next GU_RED
// sum the tiles, the last one produces. x rows [0, nb) (nb <= 16 MT), act
// [nv + n_sh, ROWS, I + ACT_PAD] in act_index order.
template <int MT>
__global__ void __launch_bounds__(32 * (GU_MAX_WARPS + GU_RED + 1), 1)
    gu_q4_kernel(const bf16* __restrict__ x, Streams w, const int* __restrict__ ve, const int* __restrict__ valid,
                 bf16* __restrict__ act, int nb, int n_exp, int n_sh, int h_dim, int i_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GuLayout<MT> lay(h_dim);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + lay.stages;
  uint64_t* red_full = empty + lay.stages;  // a buffer's tiles are in
  uint64_t* red_empty = red_full + lay.bufs;  // a buffer's tiles are summed
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = lay.warps, rb = lay.rb, ng = lay.ng;
  if (threadIdx.x == 0) {
    for (int i = 0; i < lay.stages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], nw);
    }
    for (int i = 0; i < lay.bufs; ++i) {
      sm90::mbar_init(&red_full[i], 32 * nw);
      sm90::mbar_init(&red_empty[i], 32 * GU_RED);
    }
    sm90::mbar_fence_init();
  }
  const int nv = count_valid(valid, n_exp, lane), n_visits = nv + n_sh, n_cols = i_dim / GU_COLS;
  const int n_items = n_visits * n_cols;
  unsigned char* red = smem + lay.red_off;
  __syncthreads();

  if (warp == nw + GU_RED) {  // the producer
    if (lane != 0) return;
    int e_next = visit_expert(ve, blockIdx.x / n_cols, nv, n_visits);
    for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
      const int v = it / n_cols, i0 = GU_COLS * (it - v * n_cols);
      const size_t e = e_next;
      e_next = visit_expert(ve, (it + gridDim.x) / n_cols, nv, n_visits);  // the next item's, loaded early
      const int slot = j % lay.stages;
      sm90::mbar_wait(&empty[slot], ((j / lay.stages) & 1) ^ 1);  // a fresh slot passes at once
      const bool pe = v >= nv;
      const uint8_t* codes = (pe ? w.pgu : w.gu) + e * 2 * i_dim * rb;
      const float* scales = (pe ? w.pgus : w.gus) + e * 2 * i_dim * ng;
      unsigned char* dst = smem + slot * lay.stage_bytes;
      sm90::mbar_arrive_expect_tx(&full[slot], 2 * GU_COLS * (rb + ng * 4));
      sm90::bulk_load(dst, codes + (size_t)i0 * rb, GU_COLS * rb, &full[slot]);
      sm90::bulk_load(dst + GU_COLS * rb, codes + (size_t)(i_dim + i0) * rb, GU_COLS * rb, &full[slot]);
      sm90::bulk_load(dst + lay.scale_off, scales + (size_t)i0 * ng, GU_COLS * ng * 4, &full[slot]);
      sm90::bulk_load(dst + lay.scale_off + GU_COLS * ng * 4, scales + (size_t)(i_dim + i0) * ng,
                      GU_COLS * ng * 4, &full[slot]);
    }
    return;
  }

  if (warp >= nw) {  // the reducers: each item's tiles summed in warp order, J's rounding points
    // Reducer thread u takes the C fragments q = u, u + 32 GU_RED, ... of
    // the item: lane l = q % 32 of n tile (q / 32) % GU_NT, m tile q / (32
    // GU_NT), four outputs (one float4 of each warp's tile): rows 16 m + l
    // / 4 + (0, 8), columns 8 n + 2 (l % 4) + (0, 1).
    constexpr int N_FRAG = MT * 32 * GU_NT;
    const int u = threadIdx.x - 32 * nw;
    for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
      const int buf = j % lay.bufs;
      sm90::mbar_wait(&red_full[buf], (j / lay.bufs) & 1);
      const float4* rf = reinterpret_cast<const float4*>(red + buf * lay.red_bytes);
      const int v = it / n_cols, i0 = GU_COLS * (it - v * n_cols);
      for (int q = u; q < N_FRAG; q += 32 * GU_RED) {
        const int ul = q % 32, un = (q / 32) % GU_NT, m = q / (32 * GU_NT);
        float4 gs = make_float4(0.f, 0.f, 0.f, 0.f), us = gs;
#pragma unroll
        for (int ww = 0; ww < GU_MAX_WARPS; ++ww) {
          if (ww < nw) {
            const int base = (((ww * MT + m) * GU_NT + un) * 2) * 32 + ul;
            const float4 a = rf[base], b = rf[base + 32];
            gs.x += a.x, gs.y += a.y, gs.z += a.z, gs.w += a.w;
            us.x += b.x, us.y += b.y, us.z += b.z, us.w += b.w;
          }
        }
        const int r = 16 * m + ul / 4, col = i0 + 8 * un + 2 * (ul % 4);
        bf16* a0 = act + ((size_t)v * ROWS + r) * (i_dim + ACT_PAD);
        bf16* a8 = a0 + 8 * (i_dim + ACT_PAD);
        if (r < nb) {
          a0[act_index(col)] = __float2bfloat16_rn(silu(gs.x) * us.x);
          a0[act_index(col + 1)] = __float2bfloat16_rn(silu(gs.y) * us.y);
        }
        if (r + 8 < nb) {
          a8[act_index(col)] = __float2bfloat16_rn(silu(gs.z) * us.z);
          a8[act_index(col + 1)] = __float2bfloat16_rn(silu(gs.w) * us.w);
        }
      }
      sm90::mbar_arrive(&red_empty[buf]);  // this thread has read the buffer
    }
    return;
  }

  // Compute warp `warp`: group `warp` of H; its x fragments (A of
  // m16n8k16: rows 16 m + g, + 8; chunk c = this lane's positions 32 t + 8
  // c .. + 7 of the group, in fragment order) in registers.
  const int g = lane / 4, t = lane % 4;
  uint4 xa[MT][4][2];  // [m][chunk][row g, g + 8]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)r * h_dim + GROUP * warp + 32 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) xa[m][c][h] = r < nb ? frag_order(__ldg(p + c)) : make_uint4(0u, 0u, 0u, 0u);
    }
  for (int it = blockIdx.x, j = 0; it < n_items; it += gridDim.x, ++j) {
    const int slot = j % lay.stages, buf = j % lay.bufs;
    sm90::mbar_wait(&full[slot], (j / lay.stages) & 1);
    const unsigned char* st = smem + slot * lay.stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + lay.scale_off);
    float4* rbuf = reinterpret_cast<float4*>(red + buf * lay.red_bytes);
#pragma unroll
    for (int n = 0; n < GU_NT; ++n) {
      float cg[MT][4], cu[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) cg[m][c] = cu[m][c] = 0.f;
      const unsigned char* row = st + (size_t)(8 * n + g) * rb + GB * warp + 16 * t;
      const uint4 wg = *reinterpret_cast<const uint4*>(row);
      const uint4 wu = *reinterpret_cast<const uint4*>(row + GU_COLS * rb);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t bg[4], bu[4];
        decode_pairs(word(wg, c), bg);
        decode_pairs(word(wu, c), bu);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint4& lo = xa[m][c][0];
          const uint4& hi = xa[m][c][1];
          const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
          sm90::mma_bf16_16816(cg[m], a0, bg[0], bg[1]);
          sm90::mma_bf16_16816(cg[m], a1, bg[2], bg[3]);
          sm90::mma_bf16_16816(cu[m], a0, bu[0], bu[1]);
          sm90::mma_bf16_16816(cu[m], a1, bu[2], bu[3]);
        }
      }
      // The group's scales of this lane's two columns, before the tile
      // leaves the warp; the buffer is free once the reducers have summed
      // what it held (a fresh buffer passes at once).
      const int col = 8 * n + 2 * t;
      const float sg0 = sc[col * ng + warp], sg1 = sc[(col + 1) * ng + warp];
      const float su0 = sc[(GU_COLS + col) * ng + warp], su1 = sc[(GU_COLS + col + 1) * ng + warp];
      if (n == 0) sm90::mbar_wait(&red_empty[buf], ((j / lay.bufs) & 1) ^ 1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int base = (((warp * MT + m) * GU_NT + n) * 2) * 32 + lane;
        rbuf[base] = make_float4(cg[m][0] * sg0, cg[m][1] * sg1, cg[m][2] * sg0, cg[m][3] * sg1);
        rbuf[base + 32] = make_float4(cu[m][0] * su0, cu[m][1] * su1, cu[m][2] * su0, cu[m][3] * su1);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);  // the stage is read: refill it
    sm90::mbar_arrive(&red_full[buf]);  // this thread's part of the tiles is in
  }
}

// A down stage, one visit: the act rows of the group's nb decode rows (one
// bulk copy, rows I + ACT_PAD apart), the tile's 8 nw code rows (one copy of
// 8 nw I / 2 contiguous bytes) and their group scales (one more).
template <int MT>
struct DnLayout {
  int as, rb, ng, codes_off, scale_off, stage_bytes, stages, bar_off;
  size_t smem;
  __host__ __device__ DnLayout(int i_dim, int nw) {
    as = i_dim + ACT_PAD;
    rb = i_dim / 2;
    ng = i_dim / GROUP;
    codes_off = 16 * MT * as * 2;
    scale_off = codes_off + 8 * nw * rb;
    stage_bytes = round128(scale_off + 8 * nw * ng * 4);
    stages = fit_stages(0, stage_bytes, DN_MAX_STAGES);
    bar_off = stages * stage_bytes;
    smem = bar_off + 2 * stages * 8;
  }
};

// Launch 2. Block (tile, part): output columns [8 nw tile, 8 nw (tile + 1))
// of every row, over the visits whose ids lie in part `part` of the
// gridDim.y parts (see the header), one visit a stage; consumer warp w owns
// the columns' n8 tile w. The producer (the last warp) fills the stages;
// the consumers keep their sums in registers, write the part's sums to yw
// [P, nb, H] f32, and the last block of the tile to arrive (counters[tile])
// adds the P sums in part order into out [nb, H]. w_visit rows ldw apart;
// act [nv + n_sh, ROWS, I + ACT_PAD].
template <int MT>
__global__ void __launch_bounds__(32 * (DN_MAX_WARPS + 1), 1)
    down_q4_kernel(const bf16* __restrict__ act, Streams w, const int* __restrict__ ve, const int* __restrict__ valid,
                   const float* __restrict__ w_visit, int ldw, float* __restrict__ yw, int* __restrict__ counters,
                   bf16* __restrict__ out, int nb, int n_exp, int n_sh, int h_dim, int i_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int merger;
  const int nw = blockDim.x / 32 - 1;
  const DnLayout<MT> lay(i_dim, nw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + lay.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x, part = blockIdx.y, n_parts = gridDim.y;
  const int cols = 8 * nw, h0 = tile * cols;
  if (threadIdx.x == 0) {
    for (int i = 0; i < lay.stages; ++i) {
      sm90::mbar_init(&full[i], 1);
      sm90::mbar_init(&empty[i], nw);
    }
    sm90::mbar_fence_init();
  }
  // The part's visits: the valid ones with ve[v] in [lo, hi) (ve ascends:
  // v in [v_lo, v_lo + n_r)), then pseudo-experts t in [t_lo, t_lo + n_p).
  const int n_ids = n_exp + n_sh;
  const int lo = (int)((long long)n_ids * part / n_parts), hi = (int)((long long)n_ids * (part + 1) / n_parts);
  int nv = 0, v_lo = 0, v_hi = 0;  // valid and ve read in one round (the valid visits are a prefix)
  for (int v0 = 0; v0 < n_exp; v0 += 32) {
    const bool ok = v0 + lane < n_exp && valid[v0 + lane];
    const int e = v0 + lane < n_exp ? ve[v0 + lane] : n_ids;
    nv += __popc(__ballot_sync(FULL, ok));
    v_lo += __popc(__ballot_sync(FULL, ok && e < lo));
    v_hi += __popc(__ballot_sync(FULL, ok && e < hi));
  }
  const int n_r = v_hi - v_lo;
  const int t_lo = min(max(lo - n_exp, 0), n_sh), n_p = min(max(hi - n_exp, 0), n_sh) - t_lo;
  const int n_mine = n_r + n_p;
  __syncthreads();

  if (warp == nw) {  // the producer warp: lane 0 copies, lane j % 32 holds visit j's expert
    int e_l = 0;
    for (int j = 0; j < n_mine; ++j) {
      if (j % 32 == 0) e_l = j + lane < n_r ? ve[v_lo + j + lane] : t_lo + j + lane - n_r;
      const int e = __shfl_sync(FULL, e_l, j % 32);
      if (lane == 0) {
        const bool pe = j >= n_r;
        const int a = pe ? nv + e : v_lo + j;  // the visit's act rows
        const int slot = j % lay.stages;
        sm90::mbar_wait(&empty[slot], ((j / lay.stages) & 1) ^ 1);
        const size_t row0 = (size_t)e * h_dim + h0;
        unsigned char* dst = smem + slot * lay.stage_bytes;
        sm90::mbar_arrive_expect_tx(&full[slot], nb * lay.as * 2 + cols * (lay.rb + lay.ng * 4));
        sm90::bulk_load(dst, act + (size_t)a * ROWS * lay.as, nb * lay.as * 2, &full[slot]);
        sm90::bulk_load(dst + lay.codes_off, (pe ? w.pdown : w.down) + row0 * lay.rb, cols * lay.rb, &full[slot]);
        sm90::bulk_load(dst + lay.scale_off, (pe ? w.pds : w.ds) + row0 * lay.ng, cols * lay.ng * 4, &full[slot]);
      }
      __syncwarp();
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int c0 = 8 * warp + 2 * t;  // this lane's two columns of the tile (C fragment)
  float o[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[m][c] = 0.f;
  // Visit j's weights of this lane's rows 16 m + g, + 8 (0 past nb; a
  // pseudo-expert's are 1), loaded a visit ahead.
  auto weights = [&](int j, float (&wr)[MT][2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        wr[m][h] = r >= nb || j >= n_mine ? 0.f : j >= n_r ? 1.f : __ldcg(w_visit + (size_t)(v_lo + j) * ldw + r);
      }
  };
  float w_next[MT][2];
  weights(0, w_next);
  for (int j = 0; j < n_mine; ++j) {
    float wr[MT][2];
#pragma unroll
    for (int m = 0; m < MT; ++m) wr[m][0] = w_next[m][0], wr[m][1] = w_next[m][1];
    weights(j + 1, w_next);
    const int slot = j % lay.stages;
    sm90::mbar_wait(&full[slot], (j / lay.stages) & 1);
    const unsigned char* st = smem + slot * lay.stage_bytes;
    const bf16* ab = reinterpret_cast<const bf16*>(st);
    const unsigned char* cb = st + lay.codes_off + (size_t)(8 * warp + g) * lay.rb + 16 * t;
    const float* sc = reinterpret_cast<const float*>(st + lay.scale_off);
    float y[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[m][c] = 0.f;
    for (int grp = 0; grp < lay.ng; ++grp) {
      float d[2][MT][4];  // two chains of mma sums (words 0, 2 and 1, 3), added before the scale
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[k][m][c] = 0.f;
      const uint4 cw = *reinterpret_cast<const uint4*>(cb + GB * grp);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t b[4];
        decode_pairs(word(cw, c), b);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const bf16* arow = ab + (size_t)(16 * m + g) * lay.as + GROUP * grp + 32 * c + 8 * t;
          const uint4 lo = *reinterpret_cast<const uint4*>(arow);
          const uint4 hi = *reinterpret_cast<const uint4*>(arow + 8 * lay.as);
          const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
          sm90::mma_bf16_16816(d[c % 2][m], a0, b[0], b[1]);
          sm90::mma_bf16_16816(d[c % 2][m], a1, b[2], b[3]);
        }
      }
      const float s0 = sc[c0 * lay.ng + grp], s1 = sc[(c0 + 1) * lay.ng + grp];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        y[m][0] = __fadd_rn(y[m][0], __fmul_rn(__fadd_rn(d[0][m][0], d[1][m][0]), s0));
        y[m][1] = __fadd_rn(y[m][1], __fmul_rn(__fadd_rn(d[0][m][1], d[1][m][1]), s1));
        y[m][2] = __fadd_rn(y[m][2], __fmul_rn(__fadd_rn(d[0][m][2], d[1][m][2]), s0));
        y[m][3] = __fadd_rn(y[m][3], __fmul_rn(__fadd_rn(d[0][m][3], d[1][m][3]), s1));
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);  // the stage is read: refill it
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[m][c] = __fadd_rn(o[m][c], __fmul_rn(y[m][c], wr[m][c / 2]));
  }
  // The part's sums out; the last block of the tile adds the parts in order.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * m + g + 8 * h;
      if (r < nb)
        *reinterpret_cast<float2*>(yw + ((size_t)part * nb + r) * h_dim + h0 + c0) =
            make_float2(o[m][2 * h], o[m][2 * h + 1]);
    }
  __threadfence();
  sm90::bar_sync(1, 32 * nw);
  if (threadIdx.x == 0) merger = atomicAdd(counters + tile, 1) == n_parts - 1;
  sm90::bar_sync(1, 32 * nw);
  if (!merger) return;
  __threadfence();
  for (int i = threadIdx.x; i < nb * cols / 2; i += 32 * nw) {
    const int r = i / (cols / 2), col = h0 + 2 * (i % (cols / 2));
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 8
    for (int p = 0; p < n_parts; ++p) {  // unrolled: the loads go out together
      const float2 v = __ldcg(reinterpret_cast<const float2*>(yw + ((size_t)p * nb + r) * h_dim + col));
      s0 += v.x;
      s1 += v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * h_dim + col) = __floats2bfloat162_rn(s0, s1);
  }
  if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next launch (and a graph's next replay)
}

template <int MT>
int launch_rows(const bf16* x, const Streams& w, const int* ve, const int* valid, const float* w_visit, int ldw,
                bf16* act, float* yw, int* counters, bf16* out, int nb, int n_exp, int n_sh, int h_dim, int i_dim,
                int dn_warps, int parts, cudaStream_t s) {
  const GuLayout<MT> gl(h_dim);
  const DnLayout<MT> dl(i_dim, dn_warps);
  if (gl.stages < 2 || dl.stages < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gu_q4_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gl.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(down_q4_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dl.smem);
  if (err != cudaSuccess) return (int)err;
  gu_q4_kernel<MT><<<q4::sm_count(), 32 * (gl.warps + GU_RED + 1), gl.smem, s>>>(x, w, ve, valid, act, nb, n_exp, n_sh,
                                                                        h_dim, i_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  down_q4_kernel<MT><<<dim3(h_dim / (8 * dn_warps), parts), 32 * (dn_warps + 1), dl.smem, s>>>(
      act, w, ve, valid, w_visit, ldw, yw, counters, out, nb, n_exp, n_sh, h_dim, i_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel N with bf16 x on the stream. x [B, H] bf16; gu / gus / down / ds
// the routed experts and pgu / pgus / pdown / pds the n_sh pseudo-experts
// (null when n_sh = 0) in moe_quant.cuh's Q4 layout; ve / valid int32 [E]
// and w_visit f32 [E, B] from the schedule; act: a workspace [E + n_sh, 32,
// I + 32] bf16; yw: a workspace [parts, min(B, 32), H] f32; counters:
// [H / (8 dn_warps)] int32, zero before the call and left zero after it;
// out [B, H] bf16. down's tiles are 8 dn_warps columns of H (1 <= dn_warps
// <= 10, H a multiple of 8 dn_warps), its visits cut into `parts` parts at
// fixed ids. Groups of up to 32 rows, each its own launch pair on the same
// workspaces (stream order keeps them apart).
extern "C" int moe_q4_stream_bf16(const void* x, const void* gu, const void* gus, const void* down, const void* ds,
                                  const void* pgu, const void* pgus, const void* pdown, const void* pds,
                                  const void* ve, const void* valid, const void* w_visit, void* act, void* yw,
                                  void* counters, void* out, int nb, int n_exp, int n_sh, int h_dim, int i_dim,
                                  int dn_warps, int parts, void* stream) {
  if (nb <= 0 || n_exp <= 0 || n_sh < 0 || h_dim <= 0 || i_dim <= 0 || h_dim % GROUP || i_dim % GROUP ||
      h_dim > GROUP * GU_MAX_WARPS || dn_warps < 1 || dn_warps > DN_MAX_WARPS || h_dim % (8 * dn_warps) ||
      parts < 1 || parts > 65535 || (n_sh > 0 && (!pgu || !pgus || !pdown || !pds))) {
    return (int)cudaErrorInvalidValue;
  }
  const Streams w{static_cast<const uint8_t*>(gu),  static_cast<const float*>(gus), static_cast<const uint8_t*>(down),
                  static_cast<const float*>(ds),    static_cast<const uint8_t*>(pgu), static_cast<const float*>(pgus),
                  static_cast<const uint8_t*>(pdown), static_cast<const float*>(pds)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < nb; b0 += ROWS) {
    const int rows = min(ROWS, nb - b0);
    const bf16* xg = static_cast<const bf16*>(x) + (size_t)b0 * h_dim;
    bf16* og = static_cast<bf16*>(out) + (size_t)b0 * h_dim;
    const float* wv = static_cast<const float*>(w_visit) + b0;
    const auto launch = rows <= 16 ? launch_rows<1> : launch_rows<2>;
    const int err = launch(xg, w, static_cast<const int*>(ve), static_cast<const int*>(valid), wv, nb,
                           static_cast<bf16*>(act), static_cast<float*>(yw), static_cast<int*>(counters), og, rows,
                           n_exp, n_sh, h_dim, i_dim, dn_warps, parts, s);
    if (err != 0) return err;
  }
  return 0;
}
