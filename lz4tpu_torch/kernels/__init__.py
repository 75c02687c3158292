"""CUDA kernels (``csrc/``), their plain PyTorch versions and host wrappers."""
