"""The hand-written Hopper kernels that replace the JAX package's Pallas
kernels, each beside its plain PyTorch version.

Nothing is compiled at import: ``build.library()`` builds the CUDA sources
under ``csrc/`` at the first launch on a CUDA tensor.
"""

from picotron_tpu_torch.ops.kernels import decode_attention, flash_attention, rmsnorm

# every kernel of the serving path, in the order the model reaches them
KERNELS = (rmsnorm.KERNEL, flash_attention.KERNEL, decode_attention.KERNEL)
