// Int4-weight linear for decode (w4a16 skinny GEMM, group-128 scales) for
// sm_90a: kernel L.
//
// Replaces the Pallas TPU kernels deepseek_ocr2_tpu/ops/linear_q4.py:
// _q4_linear_kernel (output-column blocks) and _q4_linear_kernel_kblocked
// (contraction slabs), both via linear_q4. The TPU needs the second form
// only because column blocks of an [In, Out] matrix are strided DMA; the
// port stores the codes in HF's [Out, In] layout, so each output's codes
// are one contiguous row and one kernel covers both shapes. The TPU's
// split-half, offset-lo packing and its padding to 256 rows were shaped by
// its vector unit; here two adjacent rows share a byte, so a lane's 16-byte
// load is 32 consecutive levels of one group. The device code is in
// linear_q4.cuh (also used by kernels M, N and O).
//
// What bounds it: the weight bytes. lm_head is 129 280 x 1280 levels =
// 82.7 MB of codes + 5.2 MB of scales, 0.026 ms at 3.35 TB/s, whatever
// B <= 32. At 1-4 rows of x (a decode step) a persistent kernel streams
// whole code rows through shared memory by bulk async copies, so its loads
// are long and every lane has work at any In (the streaming form in
// linear_q4.cuh).

#include "linear_q4.cuh"

// x [B, In] (f32, or bf16 if x_bf16); q uint8 [Out, In_p / 2]; scale f32
// [Out, In_p / 128]; out [B, Out] (f32, or bf16 if out_bf16). Returns
// cudaGetLastError().
extern "C" int linear_q4(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim,
                         int out_dim, int x_bf16, int out_bf16, void* stream) {
  return q4::gemv_dispatch(x, q, scale, out, nb, in_dim, out_dim, x_bf16, out_bf16,
                           static_cast<cudaStream_t>(stream));
}
