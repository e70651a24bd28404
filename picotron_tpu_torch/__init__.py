"""picotron-tpu ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside ``picotron_tpu`` (the JAX reference, which it
never imports). It reads the same JSON configs, keeps the same parameter
layout and init laws, and serves the same Llama model through
hand-written CUDA kernels for RMSNorm, prefill flash attention and flash
decode. Importing it builds nothing: the kernels compile at their first
launch on a CUDA tensor (``ops/kernels/build.py``).
"""
