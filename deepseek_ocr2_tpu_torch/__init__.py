"""DeepSeek-OCR-2 in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of the JAX package `deepseek_ocr2_tpu`, which stays the numeric
reference. The layout mirrors it module for module:
- io:       safetensors reader/writer (BF16 native) with the dtype policy
- ops:      norms / rope / attention / moe / sampling (JAX's threefry
            stream in prng), plus the hand-written CUDA kernels (csrc/*.cu)
            and their plain twins
- models:   sam (ViT-B), qwen2 (compressor), deepseek_v2 (LM), deepseek_ocr2
- preprocess, utils: host image preprocessing, tokenizer and debug helpers
- runtime:  KV caches (contiguous; paged f32 / bf16 / int8 / int8tail),
            greedy or sampled generation, the OCR pipeline, the serving
            engines and the HTTP front end
- parallel: the (dp, mp) mesh over torch.distributed, the TP / EP / DP
            layout of the LM's weights, the collectives of the sharded
            forward and backward, and `launch`, which starts a world of
            ranks (gloo on the CPU and on a shared card, NCCL with a GPU
            a rank)
- cli:      `inspect`, `generate-text`, `generate-ocr`, `debug-rope`,
            `serve`, `convert`, `validate-hf` and `train` (`--mesh dp,mp`)

The port imports nothing of `deepseek_ocr2_tpu`, not even its modules that
import no jax: the config dataclasses, the dtype policy, the tokenizer and
debug helpers and the host preprocessing are the port's own copies.

Numeric defaults of CUDA that break the reference's parity policy are
switched off here, once, at import: no TF32 in matmuls or cuDNN convs (SAM's
neck / net_2 / net_3 would otherwise run in TF32), and no reduced-precision
bf16 reductions inside cuBLAS.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
