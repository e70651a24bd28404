"""The hand-written Hopper kernels that replace the JAX package's Pallas
kernels, each beside its plain PyTorch version.

Nothing is compiled at import: ``build.library()`` builds the CUDA sources
under ``csrc/`` at the first launch on a CUDA tensor.
"""

from picotron_tpu_torch.ops.kernels import (
    decode_attention,
    flash_attention,
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
# every kernel, in the order of the JAX package's Pallas kernels (A to G,
# C's int8 variant beside C)
KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL,
           decode_attention.KERNEL_INT8, rmsnorm.KERNEL_BWD,
           flash_attention.KERNEL_DQ, flash_attention.KERNEL_DKV,
           quant_matmul.KERNEL)
