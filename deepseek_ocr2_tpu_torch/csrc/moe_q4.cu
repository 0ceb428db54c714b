// Int4-weight decode MoE for sm_90a: kernels M and N.
//
// M replaces deepseek_ocr2_tpu/ops/moe_q4.py: _q4_kernel and _q4_pe_kernel
// (via moe_ffn_decode_q4): one visit per (row, selection), plus the shared
// pseudo-experts at one row. N replaces deepseek_ocr2_tpu/ops/moe_q4.py:
// _decode_q4_kernel and _decode_q4_pe_kernel (via moe_ffn_decode_q4_fused):
// one visit per distinct selected expert, then the pseudo-experts. These are
// kernels I's and J's launch structures (moe_quant.cuh, shared with
// moe_q8.cu) with linear_q4.cuh's int4 dots in place of the int8 ones: gate
// and up kept in f32 after their group scales (the TPU's _q4_swiglu), the
// distinct-expert plan on the tensor cores a 128-row group per warp chunk.
//
// What bounds it: the int4 expert bytes, 3 * H * I / 2 + scales = 1.83 MB an
// expert at H = 1280, I = 896. M at b = 1 with the pseudo-experts: 8 visits,
// 14.6 MB, 0.0044 ms at 3.35 TB/s per MoE layer. N at 16 rows: about 51
// distinct experts + 2 pseudo-experts, 97 MB, 0.029 ms.

#include "moe_quant.cuh"

MOE_QUANT_ENTRY(moe_q4_f32, moe_quant::Q4, float)
MOE_QUANT_ENTRY(moe_q4_bf16, moe_quant::Q4, __nv_bfloat16)
