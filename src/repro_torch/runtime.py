"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Asking
for CUDA on a machine without it is an error, never a silent move to
the CPU: the CPU runs only where the caller asks for it (the tests).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
