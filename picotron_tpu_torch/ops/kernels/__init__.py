"""The hand-written Hopper kernels that replace the JAX package's Pallas
kernels, each beside its plain PyTorch version.

Nothing is compiled at import: ``build.library()`` builds the CUDA sources
under ``csrc/`` at the first launch on a CUDA tensor.
"""

from picotron_tpu_torch.ops.kernels import decode_attention, flash_attention, rmsnorm

# the kernels of each path, in the order the model reaches them
SERVING_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                   decode_attention.KERNEL)
TRAINING_KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL,
                    flash_attention.KERNEL_DQ, flash_attention.KERNEL_DKV,
                    rmsnorm.KERNEL_BWD)
# every kernel, in the order of the JAX package's Pallas kernels (A to F)
KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL,
           rmsnorm.KERNEL_BWD, flash_attention.KERNEL_DQ,
           flash_attention.KERNEL_DKV)
