"""PyTorch/CUDA port of the EPD-Serve reproduction.

A second package beside the JAX reference ``repro``: the same serving
system (Encode -> Prefill -> Decode over shared weights, dense and paged
KV caches, prefix cache, chunked prefill, continuous batching, fault
arms) in PyTorch, with the reference's Pallas attention kernels
rewritten as hand-written CUDA for Hopper (``csrc/``). It imports
neither ``jax`` nor anything of ``repro``.
"""
