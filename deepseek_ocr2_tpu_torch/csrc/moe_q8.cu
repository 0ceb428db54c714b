// Int8-weight decode MoE for sm_90a: kernels I and J.
//
// I replaces deepseek_ocr2_tpu/ops/moe_q8.py: _q8_kernel and _q8_pe_kernel
// (via moe_ffn_decode_q8): one visit per (row, selection), plus the shared
// pseudo-experts at one row. J replaces deepseek_ocr2_tpu/ops/moe_decode.py:
// _decode_q8_kernel and _decode_q8_pe_kernel (via moe_ffn_decode_q8_fused):
// one visit per distinct selected expert, then the pseudo-experts. The
// design, layout and rounding points are in moe_quant.cuh, shared with the
// int4 kernels M and N (moe_q4.cu); the products are linear_q8.cuh's.
//
// What bounds it: the int8 expert bytes, 3 * H * I = 3.44 MB an expert at
// H = 1280, I = 896. I at b = 1 with the pseudo-experts: 8 visits, 27.5 MB,
// 8.2 us at 3.35 TB/s per MoE layer. J at 16 rows: about 51 distinct
// experts + 2 pseudo-experts, 182 MB, 0.054 ms. I re-reads an expert for
// every row that selects it, hence J once B * k > E.

#include "moe_quant.cuh"

MOE_QUANT_ENTRY(moe_q8_f32, moe_quant::Q8, float)
MOE_QUANT_ENTRY(moe_q8_bf16, moe_quant::Q8, __nv_bfloat16)
