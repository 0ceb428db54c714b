// Int8-weight linear for decode (w8a16 skinny GEMM) for sm_90a: kernel H.
//
// Replaces the Pallas TPU kernels deepseek_ocr2_tpu/ops/linear_q8.py:
// _q8_linear_kernel (output-column blocks) and _q8_linear_kernel_kblocked
// (contraction slabs), both via linear_q8. The TPU needs the second form
// only because column blocks of an [In, Out] int8 matrix are strided DMA;
// the port stores the codes in HF's [Out, In] layout, so each output's
// codes are one contiguous row and one kernel covers both shapes. The
// device code is in linear_q8.cuh (also used by kernel K).
//
// What bounds it: the weight bytes. lm_head is 129 280 x 1280 int8 =
// 165.5 MB, 0.049 ms at 3.35 TB/s, whatever B <= 32; at B = 16 the f32
// FMAs of this CUDA-core design (5.3 GFLOP, 0.079 ms at 67 TFLOP/s) bound
// it instead (see the header of linear_q8.cuh).

#include "linear_q8.cuh"

// x [B, In] (f32, or bf16 if x_bf16); q int8 [Out, In]; scale f32 [Out];
// out [B, Out] (f32, or bf16 if out_bf16). Returns cudaGetLastError().
extern "C" int linear_q8(const void* x, const void* q, const void* scale, void* out, int nb, int in_dim,
                         int out_dim, int x_bf16, int out_bf16, void* stream) {
  return q8::gemv_dispatch(x, q, scale, out, nb, in_dim, out_dim, x_bf16, out_bf16,
                           static_cast<cudaStream_t>(stream));
}
