"""Hand-written CUDA kernels for Hopper beside their plain PyTorch versions."""
