"""The hand-written Hopper kernels that replace the JAX package's Pallas
kernels, each beside its plain PyTorch version.

Nothing is compiled at import: ``build.library()`` builds the CUDA sources
under ``csrc/`` at the first launch on a CUDA tensor.
"""

from picotron_tpu_torch.ops.kernels import (
    decode_attention,
    flash_attention,
    lora_matmul,
    quant_matmul,
    rmsnorm,
)

# the kernels of each path, in the order the model reaches them
SERVING_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                   decode_attention.KERNEL)
TRAINING_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                    flash_attention.KERNEL_DQ, flash_attention.KERNEL_DKV,
                    rmsnorm.KERNEL_BWD)
# int8 weights and an int8 KV cache: every product of the model body and
# the LM head is G, every cache attend C's int8 variant
SERVING_INT8_KERNELS = (rmsnorm.KERNEL, quant_matmul.KERNEL,
                        flash_attention.KERNEL, decode_attention.KERNEL_INT8)
# the paged layout: every cache attend (decode and the chunked prefill
# that resumes over shared pages) through C's variant for the page
# storage; B runs the one-shot prefill of a prefix miss
SERVING_PAGED_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                         decode_attention.KERNEL_PAGED)
SERVING_PAGED_INT8_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                              decode_attention.KERNEL_PAGED_INT8)
SERVING_MIXED_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                         decode_attention.KERNEL_MIXED)
# several tenants in one batch over paged bf16 pages: every projection of
# the model body adds its rows' adapter residuals through H
SERVING_TENANT_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                          decode_attention.KERNEL_PAGED, lora_matmul.KERNEL)
# every kernel, in the order of the JAX package's Pallas kernels (A to H,
# C's variants beside C)
KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL,
           decode_attention.KERNEL_INT8, decode_attention.KERNEL_PAGED,
           decode_attention.KERNEL_PAGED_INT8, decode_attention.KERNEL_MIXED,
           rmsnorm.KERNEL_BWD, flash_attention.KERNEL_DQ,
           flash_attention.KERNEL_DKV, quant_matmul.KERNEL,
           lora_matmul.KERNEL)
