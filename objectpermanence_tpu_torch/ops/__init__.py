"""Tensor ops of the port: plain PyTorch, and the hand-written kernels."""
