"""paged_decode_attention: plain PyTorch version (ref.py) and the CUDA kernel wrapper (kernel.py)."""
