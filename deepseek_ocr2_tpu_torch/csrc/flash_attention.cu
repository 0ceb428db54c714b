// Exact attention for sm_90a: kernels A and B in f32 on the tensor cores
// (3xTF32), and an online-softmax template on the CUDA cores for the rest.
//
// Replaces three Pallas TPU kernels of deepseek_ocr2_tpu/ops/flash_attention.py:
//   A: _attn_kernel        (modes none / causal / prefix; LM prefill uses causal)
//   B: _attn_kernel_relpos (SAM's decomposed relative-position bias)
//   V: _attn_kernel_relwin (SAM's windowed attention with the rel-pos bias
//      built inside the kernel from the flattened tables; the windowed
//      blocks under DEEPSEEK_SAM_WIN_KERNEL=1)
// The TPU kernels keep a whole score row in VMEM and take an exact softmax
// over it. A 64-query tile of f32 rows at SAM's 4096 global keys is 1 MB,
// far over the 227 KB of shared memory a block may use on Hopper, so both
// kernels here stream key tiles with an online softmax (running max and
// sum, rescaled per tile). Their results differ from the full-row form by
// f32 rounding only.
//
// Semantics, per score (all in f32):
//   s = (q . k) * scale
//   B: s = s + (rel_h[q, key / Kw] + rel_w[q, key % Kw]); the [L, L] bias is
//      never built, each block loads its 64 query rows of rel_h / rel_w.
//   A causal:  key > query                                   -> s = -1e4
//   A prefix:  (query < P and key >= P) or
//              (query >= P and key >= P and key > query)     -> s = -1e4
//   V: per query block, the win rel-h and win rel-w dot products of each
//      query with its own rows of the flattened tables rhf, rwf [D, T2] f32
//      (rhf[c, h win + kh] = rel_h_table[h, kh, c]) go into shared memory,
//      in f32 FMAs (no TF32): rel_h[q, kh] = q . rhf[:, (q / win) win + kh],
//      rel_w[q, kw] = q . rwf[:, (q % win) win + kw]. They are then folded in
//      as B's are, and keys of a padded window (key / win or key % win >=
//      valid) get s = s - 1e30. The TPU kernel builds the same bias with four
//      0/1 select dots over [T2, T2] tiles; its t2 % 128 == 0 assertion is
//      the TPU's lane rule: any win works here (SAM's true 14 x 14 windows,
//      T2 = 196, and the JAX package's 16 / 14 padded form).
//   key padding (key >= Lk, the ragged last tile)            -> s = -inf
//   o = softmax(s) @ v, written in the input type.
//
// Kernel A in f32 (attn_tc_kernel; modes none, causal and prefix, D 64 and
// 128). LM prefill runs it on f32 q, k, v after RoPE ([B, 10, L, 128]).
// - What bounds it: the two products, 4 L^2 D operations a head in mode
//   none and about half in the causal modes; at the LM's lengths the
//   chain of dependent steps of the heaviest block more than the rate. f32 FMAs on the CUDA cores
//   (67 TFLOP/s) made the template below lose to PyTorch's own f32
//   attention, which runs the tensor cores in 3xTF32 (mma.sync m16n8k8
//   on OpClassTensorOp with OpMultiplyAddFastF32). This kernel does the
//   same: each f32 operand x is split into a TF32 high part hi =
//   rna(x) and a low part lo = rna(x - hi) (cvt.rna.tf32.f32), and each
//   product is lo.hi + hi.lo + hi.hi with f32 sums; only lo.lo, about
//   2^-22 relative, is dropped. That is f32-accurate work at 495 / 3
//   TFLOP/s, the bound chip_smoke reckons for f32 products.
// - Layout (FA2 with the keys split): a block is 64 query rows in 4 row
//   groups of 16 and 8 warps; each step stages a 64-key tile of K and V by
//   cp.async into a double buffer, and the two warps of a row group take
//   32 keys each, each with its own online softmax over its keys (m, l
//   and the O sums in f32 registers), merged through shared memory at
//   the end: m = max(m0, m1), l = l0 e^(m0 - m) + l1 e^(m1 - m), O alike.
//   Halving each warp's walk halves the heaviest block's chain of
//   dependent steps, which sets the time at these lengths (10 heads: 180
//   blocks at 1125 tokens, 50 at 260).
// - Registers: each warp's O (64 at D 128), three score accumulators
//   (lo.hi, hi.lo and hi.hi: independent mma chains, summed small terms
//   first) and the fragments in flight; 174 a thread, no spills. Q is
//   split once into shared memory, [row group][k8 step][lane][hi, lo], and
//   read a k8 step at a time: held in registers (128 a thread at D 128)
//   it spilled and ran 1.24x slower at 1125 tokens. K, V and P are split
//   in registers as they are used. Rows are padded (K D + 8, V D + 4
//   floats) so that every fragment load hits 32 banks. The d order inside
//   a k8 step is permuted in Q and K alike (A's k t and t + 4 are d 2t and
//   2t + 1), and the key order inside a k8 step of P V likewise (keys 2t
//   and 2t + 1), so the score accumulators of q k^T are the A fragments of
//   P V as they lie, and K fragments load as float2.
// - Causal tile skip: a warp's 32 keys that lie wholly past the keys its
//   rows may see (keys_needed) are not multiplied, and a 64-key tile past
//   every row of the block is not staged. That is exact. Every causal or
//   prefix row has key 0 unmasked, so its running max m is a real score;
//   a masked score is -1e4 and adds exp(-1e4 - m) to the row's sum, which
//   is 0.0f in f32 for any m > -9896 (the result is below e^-104, the
//   least f32 denormal), and it leaves the max unchanged (-1e4 < m), so
//   the rescale is exp(0) = 1: visiting the tile changes no bit. The same
//   holds in the merge for a key half whose keys are all masked for a
//   row. Partly masked tiles keep the -1e4 fill and key padding keeps
//   -inf. At 1125 tokens the row groups multiply half of the key tiles a
//   walk of every key would (`ops/flash_attention.tc_key_tiles`).
// - Grid (B H, query blocks), the latest (heaviest) query blocks first.
//   One block of D 128 takes 202 752 bytes of shared memory: one block
//   (8 warps) an SM.
//
// Kernel B in f32 (mode RELPOS of the same kernel, D 64). SAM's global
// blocks ([1, 12, 4096, 64] a 1024^2 view, [6, 12, 2304, 64] six crops)
// carry 90 % of a page's B work, 4 L^2 D operations a head with no mask;
// at 3xTF32 the bound is 0.312 ms at 4096 keys. A's walk as it is (no
// tile is skipped: B masks no key), plus the bias:
// - At block start the block's 64 rows of rel_h [64, Kh] and rel_w [64,
//   Kw] go into shared memory (33 KB at Kh = Kw = 64, padded strides so the
//   fragment loads do not conflict), one block (8 warps) an SM: 139 KB.
// - Each score gets rel_h[row, key / Kw] + rel_w[row, key % Kw] in f32
//   after the scale, before the running max, as the twin adds the built
//   [L, L] bias; key is the score fragment's own (k0 + 8 n + 2 t + c % 2),
//   not P V's permuted k order. key / Kw is the high word of key times a
//   multiplier computed on the host (exact for key Kw < 2^32), and with Kw
//   even (every SAM shape) a key pair shares kh and reads kw, kw + 1 as a
//   float2: 16 shared loads a lane a step.
// - Keys past Lk (SAM's windows: 196 keys, the last 64-key tile partial)
//   are -inf as A's key padding; rows past Lq are zero and not written.
//
// The CUDA-core template (attn_kernel: A and B in bf16, V in both types)
// streams 64-key tiles with 256 threads a block, each owning a 4 x 4 score
// sub-tile, in f32 FMAs read from shared memory (K's padded row stride puts
// the 16 column lanes on 16 banks); every key tile is visited. bf16
// inputs are widened to f32 on load: products of bf16 values are exact in
// f32, which is what the TPU kernel's bf16 MXU pass with f32 accumulation
// computes. V adds 2 win D FMAs per query to B's 2 T2 D of the scores:
// at win 14, T2 196, 14 %; in exchange the [B H, T2, win] rel tensors are
// never written or read.
//
// Layout: q [BH, Lq, D], k/v [BH, Lk, D], o [BH, Lq, D], rel_h [BH, Lq, Kh],
// rel_w [BH, Lq, Kw] (f32), all contiguous (A in f32: 16-byte aligned);
// for V (mode 4, through the same entry points) rel_h / rel_w are the
// tables rhf / rwf [D, T2] f32 (shared by every window and head), Kh = Kw =
// win, Lq = Lk = T2, and the n_prefix argument carries `valid`. The
// template's grid is (ceil(Lq / 64), BH), 256 threads: thread (ty, tx) =
// (tid / 16, tid % 16) owns query rows 4*ty .. 4*ty+3 and key / output
// columns tx + 16*j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float MASK_VALUE = -1.0e4f;

enum Mode { NONE = 0, CAUSAL = 1, PREFIX = 2, RELPOS = 3, RELWIN = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// Kernel A in f32 on the tensor cores (see the header).

constexpr int TC_BQ = 64;      // query rows a block: 4 row groups of 16, two warps each
constexpr int TC_KW = 32;      // keys a warp multiplies a step
constexpr int TC_SPLIT = 2;    // key halves: warps w and w + 4 share rows, each takes one half of a step's keys
constexpr int TC_BKV = TC_SPLIT * TC_KW;  // keys a block stages a step
constexpr int TC_THREADS = 32 * (TC_BQ / 16) * TC_SPLIT;  // 8 warps

template <int D>
struct TcTile {
  static constexpr int KS = D + 8;  // K row stride: a float2 fragment load hits 32 banks
  static constexpr int VS = D + 4;  // V row stride: a scalar fragment load hits 32 banks
  static constexpr int KV_FLOATS = 2 * TC_BKV * (KS + VS);  // the double buffer
  // Q split once: [row group][k8 step][lane][hi a0..a3, lo a0..a3].
  static constexpr int Q_FLOATS = (TC_BQ / 16) * (D / 8) * 32 * 8;
  static constexpr size_t SMEM = sizeof(float) * (KV_FLOATS + Q_FLOATS);
};

// Keys [0, keys_needed) hold every key that a row <= q_max may attend to:
// the rest are masked for all of them (-1e4; see the header).
template <int MODE>
__device__ __forceinline__ int keys_needed(int q_max, int lk, int n_prefix) {
  if (MODE == CAUSAL) return min(lk, q_max + 1);
  if (MODE == PREFIX) return min(lk, q_max < n_prefix ? n_prefix : q_max + 1);
  return lk;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 22 bits: hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(full ? 16 : 0));
}

// B's staged rows: rel_h at an odd stride (the 8 rows of a fragment, one
// kh, on 8 banks), rel_w at a stride of 8 mod 32 (a half-warp's float2
// loads of 4 rows x 4 key pairs on 32 banks).
__host__ __device__ __forceinline__ int rel_stride_h(int kh) { return kh | 1; }
__host__ __device__ __forceinline__ int rel_stride_w(int kw) { return kw + (40 - kw % 32) % 32; }

// key / Kw for key * Kw < 2^32: the high word of key * ceil(2^32 / Kw)
// (magic 0 stands for Kw = 1).
__device__ __forceinline__ int div_kw(int key, uint32_t magic) {
  return magic ? (int)__umulhi((uint32_t)key, magic) : key;
}

// B: s[n][c] += rel_h[row, key / Kw] + rel_w[row, key % Kw] (the sum of
// the two first, as the twin adds the built bias), for the lane's scores:
// row g + 8 (c / 2) of the warp's 16 (rh, rw point at row g), key key0 + 8
// n + (c & 1) -- the score fragment's own key, the same order the mask
// uses (P V's permuted k order is the A fragment's, not the scores'). Keys
// at or past Lk are left alone (they become -inf). With Kw even a key pair
// (even, odd) shares kh and takes kw, kw + 1: one float2 load of rel_w.
template <int NK>
__device__ __forceinline__ void add_rel_bias(float (&s)[NK][4], const float* rh, const float* rw, int sh, int sw,
                                             int key0, int lk, int kw, uint32_t magic) {
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int key = key0 + 8 * n;  // even
    if (key >= lk) continue;
    const int h0 = div_kw(key, magic), w0 = key - h0 * kw;
    if ((kw & 1) == 0) {  // key + 1 < Lk = Kh Kw (even), same kh
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float bh = rh[8 * h * sh + h0];
        const float2 bw = *reinterpret_cast<const float2*>(rw + 8 * h * sw + w0);
        s[n][2 * h] += bh + bw.x;
        s[n][2 * h + 1] += bh + bw.y;
      }
    } else {
      int h1 = h0, w1 = w0 + 1;
      if (w1 == kw) {
        w1 = 0;
        ++h1;
      }
      const bool odd_ok = key + 1 < lk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[n][2 * h] += rh[8 * h * sh + h0] + rw[8 * h * sw + w0];
        if (odd_ok) s[n][2 * h + 1] += rh[8 * h * sh + h1] + rw[8 * h * sw + w1];
      }
    }
  }
}

// Fragments (m16n8k8, lane = 4 g + t): A a0 (row g, k t), a1 (row g + 8,
// k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4); B b0 (k t, n g), b1
// (k t + 4, n g); C c0, c1 (row g, n 2t, 2t + 1), c2, c3 (row g + 8, the
// same n). k t and t + 4 stand for d (or key) 2t and 2t + 1 of the step.
//
// Warp w: row group w % 4 (rows q0 + 16 (w % 4) + [0, 16)), key half w / 4
// (keys 32 (w / 4) + [0, 32) of each staged 64-key tile). The two warps of
// a row group each keep their own online softmax (m, l, O) over their
// keys; at the end the second half's state goes through shared memory and
// the first merges it: m = max(m0, m1), l = l0 e^(m0 - m) + l1 e^(m1 - m),
// O likewise. A half that saw no key has m1 = -inf and adds 0.
template <int D, int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
    const float* __restrict__ rel_h, const float* __restrict__ rel_w, int lq, int lk, int n_prefix, int kh, int kw,
    uint32_t kw_magic, float scale) {
  using Tile = TcTile<D>;
  constexpr int KS = Tile::KS, VS = Tile::VS;
  constexpr int NK = TC_KW / 8;  // the scores' n8 tiles; P V's k8 steps
  constexpr int ND = D / 8;      // q k^T's k8 steps; O's n8 tiles
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [2][TC_BKV][KS]
  float* vs = ks + 2 * TC_BKV * KS;   // [2][TC_BKV][VS]
  uint4* qs = reinterpret_cast<uint4*>(smem + Tile::KV_FLOATS);  // [row group][ND][lane][2]
  // B: the block's rows of rel_h [TC_BQ][sh] and rel_w [TC_BQ][sw] (zero
  // past Lq), at the strides rel_stride_h / rel_stride_w give.
  const int sh = rel_stride_h(kh), sw = rel_stride_w(kw);
  float* rhs = smem + Tile::KV_FLOATS + Tile::Q_FLOATS;
  float* rws = rhs + TC_BQ * sh;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;  // the latest query blocks first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % (TC_BQ / 16), half = warp / (TC_BQ / 16);
  const int r0 = q0 + 16 * rg;  // the warp's first row
  const float* kb = k + (size_t)bh * lk * D;
  const float* vb = v + (size_t)bh * lk * D;
  const int n_steps = (keys_needed<MODE>(min(q0 + TC_BQ, lq) - 1, lk, n_prefix) + TC_BKV - 1) / TC_BKV;
  const int warp_keys = r0 < lq ? keys_needed<MODE>(min(r0 + 16, lq) - 1, lk, n_prefix) : 0;

  // The row group's Q fragments (rows r0 + g, r0 + g + 8; zero past Lq),
  // split once by the key-half-0 warp into shared memory, where both warps
  // of the group read them a k8 step at a time (registers hold O and the
  // scores; the first step's barrier orders the writes before the reads).
  uint4* qg = qs + rg * ND * 32 * 2;
  if (half == 0) {
    const float* qr = q + ((size_t)bh * lq + r0 + g) * D;
    const bool ok0 = r0 + g < lq, ok1 = r0 + g + 8 < lq;
    for (int kk = 0; kk < ND; ++kk) {
      const float2 x0 = ok0 ? *reinterpret_cast<const float2*>(qr + 8 * kk + 2 * t) : make_float2(0.f, 0.f);
      const float2 x1 = ok1 ? *reinterpret_cast<const float2*>(qr + 8 * D + 8 * kk + 2 * t) : make_float2(0.f, 0.f);
      uint32_t hi[4], lo[4];
      split_tf32(x0.x, hi[0], lo[0]);
      split_tf32(x1.x, hi[1], lo[1]);
      split_tf32(x0.y, hi[2], lo[2]);
      split_tf32(x1.y, hi[3], lo[3]);
      qg[(kk * 32 + lane) * 2] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      qg[(kk * 32 + lane) * 2 + 1] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }

  if constexpr (MODE == RELPOS) {  // ordered before the reads by the first step's barrier
    const float* rhb = rel_h + ((size_t)bh * lq + q0) * kh;
    const float* rwb = rel_w + ((size_t)bh * lq + q0) * kw;
    for (int i = threadIdx.x; i < TC_BQ * kh; i += TC_THREADS) {
      const int r = i / kh;
      rhs[r * sh + i - r * kh] = q0 + r < lq ? rhb[i] : 0.f;
    }
    for (int i = threadIdx.x; i < TC_BQ * kw; i += TC_THREADS) {
      const int r = i / kw;
      rws[r * sw + i - r * kw] = q0 + r < lq ? rwb[i] : 0.f;
    }
  }

  auto stage = [&](int buf, int k0) {
    constexpr int CH = D / 4;  // 16-byte chunks a row
    float* kd = ks + buf * TC_BKV * KS;
    float* vd = vs + buf * TC_BKV * VS;
    for (int i = threadIdx.x; i < TC_BKV * CH; i += TC_THREADS) {
      const int r = i / CH, c = 4 * (i % CH);
      const bool ok = k0 + r < lk;  // rows past Lk are zero-filled
      const size_t off = (size_t)(ok ? k0 + r : 0) * D + c;
      cp_async16(kd + r * KS + c, kb + off, ok);
      cp_async16(vd + r * VS + c, vb + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8; l: this lane's columns

  stage(0, 0);
  for (int j = 0; j < n_steps; ++j) {
    const int buf = j & 1, k0 = j * TC_BKV + half * TC_KW;  // the warp's first key
    if (j + 1 < n_steps) {
      stage(buf ^ 1, (j + 1) * TC_BKV);  // the buffer read in step j - 1, freed by its closing barrier
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (k0 < warp_keys) {  // else every key of the warp's 32 is masked for its rows: skipped (exact)
      const float* kt = ks + (buf * TC_BKV + half * TC_KW) * KS;
      const float* vt = vs + (buf * TC_BKV + half * TC_KW) * VS;
      // Scores: lo.hi, hi.lo and hi.hi in three accumulators (three
      // independent mma chains), summed small terms first.
      float s_lh[NK][4], s_hl[NK][4], s_hh[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s_lh[n][c] = s_hl[n][c] = s_hh[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < ND; ++kk) {
        const uint4 h4 = qg[(kk * 32 + lane) * 2], l4 = qg[(kk * 32 + lane) * 2 + 1];
        const uint32_t qh[4] = {h4.x, h4.y, h4.z, h4.w}, ql[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(kt + (8 * n + g) * KS + 8 * kk + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kv.x, bh0, bl0);
          split_tf32(kv.y, bh1, bl1);
          mma_tf32(s_lh[n], ql, bh0, bh1);
          mma_tf32(s_hl[n], qh, bl0, bl1);
          mma_tf32(s_hh[n], qh, bh0, bh1);
        }
      }

      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = ((s_lh[n][c] + s_hl[n][c]) + s_hh[n][c]) * scale;
      if constexpr (MODE == RELPOS) add_rel_bias<NK>(s, rhs + (16 * rg + g) * sh, rws + (16 * rg + g) * sw, sh, sw,
                                                     k0 + 2 * t, lk, kw, kw_magic);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 8 * n + 2 * t + (c & 1), row = r0 + g + 8 * (c >> 1);
          float x = s[n][c];
          if (key >= lk) {
            x = -INFINITY;
          } else if (MODE == CAUSAL && key > row) {
            x = MASK_VALUE;
          } else if (MODE == PREFIX && key >= n_prefix && (row < n_prefix || key > row)) {
            x = MASK_VALUE;
          }
          s[n][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the 4 lanes of a quad share rows g and g + 8
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // Finite: a visited tile holds key k0 < Lk, whose score is real
        // or -1e4. (Half 0's tile 0 holds key 0, unmasked for every row;
        // a half-1 row that sees only -1e4 is weighed out by the merge.)
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[n][c] = expf(s[n][c] - m[c >> 1]);
          l[c >> 1] += s[n][c];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];

      // O += P V: the scores' n8 tile n is P's k8 step n as it lies.
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t ph[4], pl[4];
        split_tf32(s[n][0], ph[0], pl[0]);
        split_tf32(s[n][2], ph[1], pl[1]);
        split_tf32(s[n][1], ph[2], pl[2]);
        split_tf32(s[n][3], ph[3], pl[3]);
        const float* vr = vt + (8 * n + 2 * t) * VS + g;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[8 * dn], bh0, bl0);
          split_tf32(vr[VS + 8 * dn], bh1, bl1);
          mma_tf32(acc[dn], pl, bh0, bh1);
          mma_tf32(acc[dn], ph, bl0, bl1);
          mma_tf32(acc[dn], ph, bh0, bh1);
        }
      }
    }
    __syncthreads();  // everyone is done with buf before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // The second half's state through the (now free) K buffers: O as [row
  // group][dn][lane][4] (consecutive lanes, consecutive float4s), then m
  // and l as [row group][lane][4].
  float4* o_sh = reinterpret_cast<float4*>(ks);
  float4* ml_sh = o_sh + (TC_BQ / 16) * ND * 32;
  if (half == 1) {
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      o_sh[(rg * ND + dn) * 32 + lane] = make_float4(acc[dn][0], acc[dn][1], acc[dn][2], acc[dn][3]);
    ml_sh[rg * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (half == 1) return;
  const float4 ml = ml_sh[rg * 32 + lane];
  const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mm = fmaxf(m[h], m1[h]);  // finite: half 0 saw key 0
    a0[h] = expf(m[h] - mm);
    a1[h] = expf(m1[h] - mm);  // 0 where half 1 saw no key, or only -1e4 (exact, as the skip)
    inv[h] = 1.f / (l[h] * a0[h] + l1[h] * a1[h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= lq) continue;
    float* orow = o + ((size_t)bh * lq + row) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      const float4 o1 = o_sh[(rg * ND + dn) * 32 + lane];
      const float c0 = h ? o1.z : o1.x, c1 = h ? o1.w : o1.y;
      *reinterpret_cast<float2*>(orow + 8 * dn) =
          make_float2((acc[dn][2 * h] * a0[h] + c0 * a1[h]) * inv[h], (acc[dn][2 * h + 1] * a0[h] + c1 * a1[h]) * inv[h]);
    }
  }
}

template <int D, int MODE>
int launch_tc(const void* q, const void* k, const void* v, void* o, const void* rel_h, const void* rel_w, int bh,
              int lq, int lk, int n_prefix, int kh, int kw, float scale, cudaStream_t stream) {
  auto kernel = attn_tc_kernel<D, MODE>;
  size_t smem = TcTile<D>::SMEM;
  uint32_t magic = 0;
  if (MODE == RELPOS) {
    smem += sizeof(float) * TC_BQ * (rel_stride_h(kh) + rel_stride_w(kw));
    if ((long long)lk * kw >= (1LL << 32) || smem > 232448) return (int)cudaErrorInvalidValue;
    if (kw > 1) magic = (uint32_t)(((1ULL << 32) + kw - 1) / kw);
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (lq + TC_BQ - 1) / TC_BQ);
  kernel<<<grid, TC_THREADS, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                             static_cast<const float*>(v), static_cast<float*>(o),
                                             static_cast<const float*>(rel_h), static_cast<const float*>(rel_w), lq, lk,
                                             n_prefix, kh, kw, magic, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The CUDA-core template (see the header).

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(NT) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const float* __restrict__ rel_h, const float* __restrict__ rel_w,
    int lq, int lk, int n_prefix, int kh, int kw, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D + 1]
  float* ks = qs + BQ * (D + 1);     // [BK][D + 1]
  float* vs = ks + BK * (D + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK + 1] probabilities of the tile
  float* rhs = ps + BQ * (BK + 1);   // [BQ][kh]   (relpos / relwin only)
  float* rws = rhs + BQ * kh;        // [BQ][kw]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (size_t)bh * lq * D;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * (D + 1) + c] = (q0 + r < lq) ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  if (MODE == RELPOS) {
    const float* rhb = rel_h + (size_t)bh * lq * kh;
    const float* rwb = rel_w + (size_t)bh * lq * kw;
    for (int i = tid; i < BQ * kh; i += NT) {
      const int r = i / kh;
      rhs[i] = (q0 + r < lq) ? rhb[(size_t)(q0 + r) * kh + i % kh] : 0.f;
    }
    for (int i = tid; i < BQ * kw; i += NT) {
      const int r = i / kw;
      rws[i] = (q0 + r < lq) ? rwb[(size_t)(q0 + r) * kw + i % kw] : 0.f;
    }
  }
  if (MODE == RELWIN) {
    __syncthreads();  // the block's q rows are staged
    const int win = kh;
    for (int i = tid; i < BQ * win; i += NT) {
      const int r = i / win, kk = i % win, qp = q0 + r;
      float sh = 0.f, sw = 0.f;
      if (qp < lq) {
        const float* th = rel_h + (qp / win) * win + kk;  // rhf[:, (q / win) win + kk]
        const float* tw = rel_w + (qp % win) * win + kk;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          const float qv = qs[r * (D + 1) + c];
          sh = fmaf(qv, th[(size_t)c * lk], sh);
          sw = fmaf(qv, tw[(size_t)c * lk], sw);
        }
      }
      rhs[i] = sh;
      rws[i] = sw;
    }
  }

  constexpr int DC = D / 16;
  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();  // the previous tile's ks / vs / ps are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < lk;
      ks[r * (D + 1) + c] = ok ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kp >= lk) {
          x = -INFINITY;
        } else {
          if (MODE == RELPOS || MODE == RELWIN) x = x + (rhs[r * kh + kp / kw] + rws[r * kw + kp % kw]);
          if (MODE == RELWIN && (kp / kw >= n_prefix || kp % kw >= n_prefix)) x = x + -1.0e30f;
          if (MODE == CAUSAL && kp > qp) x = MASK_VALUE;
          if (MODE == PREFIX) {
            const bool query_col = kp >= n_prefix;
            if ((qp < n_prefix && query_col) || (qp >= n_prefix && query_col && kp > qp))
              x = MASK_VALUE;
          }
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The 16 lanes sharing these rows are one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every tile 0 row holds key 0
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)bh * lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= lq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) ob[(size_t)qp * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D, int MODE>
int launch(const void* q, const void* k, const void* v, void* o, const void* rel_h,
           const void* rel_w, int bh, int lq, int lk, int n_prefix, int kh, int kw,
           float scale, cudaStream_t stream) {
  const int rel = MODE == RELPOS || MODE == RELWIN ? BQ * (kh + kw) : 0;
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + rel);
  auto kernel = attn_kernel<T, D, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((lq + BQ - 1) / BQ, bh);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const float*>(rel_h), static_cast<const float*>(rel_w),
      lq, lk, n_prefix, kh, kw, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int by_mode(int mode, const void* q, const void* k, const void* v, void* o,
            const void* rel_h, const void* rel_w, int bh, int lq, int lk, int n_prefix,
            int kh, int kw, float scale, cudaStream_t s) {
  constexpr bool F32 = sizeof(T) == 4;  // A and B in f32: the tensor-core kernel (B at D 64)
#define TC(MODE) launch_tc<D, MODE>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s)
#define CORE(MODE) launch<T, D, MODE>(q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s)
  switch (mode) {
    case NONE:
      if constexpr (F32) return TC(NONE); else return CORE(NONE);
    case CAUSAL:
      if constexpr (F32) return TC(CAUSAL); else return CORE(CAUSAL);
    case PREFIX:
      if constexpr (F32) return TC(PREFIX); else return CORE(PREFIX);
    case RELPOS:
      if constexpr (!F32) return CORE(RELPOS);
      else if constexpr (D == 64) return TC(RELPOS);
      else return (int)cudaErrorInvalidValue;
    case RELWIN: return CORE(RELWIN);
  }
#undef TC
#undef CORE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const void* rel_h,
             const void* rel_w, int bh, int lq, int lk, int d, int mode, int n_prefix,
             int kh, int kw, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0 || (lq + TC_BQ - 1) / TC_BQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (mode == RELPOS && (kh <= 0 || kw <= 0 || kh * kw != lk)) return (int)cudaErrorInvalidValue;
  if (mode == RELWIN && (kh <= 0 || kw != kh || kh * kw != lk || lq != lk || n_prefix < 1 || n_prefix > kh))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return by_mode<T, 64>(mode, q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
    case 128: return by_mode<T, 128>(mode, q, k, v, o, rel_h, rel_w, bh, lq, lk, n_prefix, kh, kw, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int attn_f32(const void* q, const void* k, const void* v, void* o,
                        const void* rel_h, const void* rel_w, int bh, int lq, int lk, int d,
                        int mode, int n_prefix, int kh, int kw, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, rel_h, rel_w, bh, lq, lk, d, mode, n_prefix, kh, kw,
                         scale, stream);
}

extern "C" int attn_bf16(const void* q, const void* k, const void* v, void* o,
                         const void* rel_h, const void* rel_w, int bh, int lq, int lk, int d,
                         int mode, int n_prefix, int kh, int kw, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, rel_h, rel_w, bh, lq, lk, d, mode, n_prefix, kh,
                                 kw, scale, stream);
}
