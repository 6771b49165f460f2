"""Attention op, its plain PyTorch versions and the CUDA kernels (``csrc/``)."""
