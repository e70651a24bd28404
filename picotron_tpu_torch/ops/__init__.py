"""Ported ops: plain PyTorch versions and the hand-written kernels."""
