"""Attention kernels: hand-written CUDA for Hopper beside their plain PyTorch versions."""
