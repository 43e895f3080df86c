"""ssd_scan: plain PyTorch versions (ref.py) and the CUDA kernel wrapper (kernel.py)."""
