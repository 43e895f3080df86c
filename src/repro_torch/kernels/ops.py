"""Attention dispatch used by the model layers.

Keeps the routing of ``repro/kernels/ops.py``: a single-token causal
query goes to the decode kernel, any other query to the flash kernel,
and decode against a paged pool to the paged kernel. Each wrapper runs
its CUDA kernel on CUDA tensors and its plain PyTorch version on CPU
tensors; there is no other switch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.decode_attention import kernel as _decode
from repro_torch.kernels.flash_attention import kernel as _flash
from repro_torch.kernels.paged_decode_attention import kernel as _paged

_WRAPPERS = {"flash_attention": _flash, "decode_attention": _decode,
             "paged_decode_attention": _paged}


def attention(q, k, v, q_pos, kv_pos, *, window: Optional[int] = None,
              causal: bool = True) -> torch.Tensor:
    """q: (b, s, nq, hd); k, v: (b, S, nkv, hd). See flash_attention/ref.py."""
    if q.shape[1] == 1 and causal:
        out = _decode.decode_attention(q[:, 0], k, v, q_pos[:, 0].contiguous(),
                                       kv_pos, window=window)
        return out[:, None]
    return _flash.flash_attention(q, k, v, q_pos, kv_pos, window=window,
                                  causal=causal)


def paged_attention(q, k_pool, v_pool, block_tbl, lengths, *,
                    window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a paged KV pool.

    q: (b, nq, hd); k_pool, v_pool: (P, page, nkv, hd);
    block_tbl: (b, max_pages) int32; lengths: (b,) valid tokens
    (including the current one). See paged_decode_attention/ref.py.
    """
    return _paged.paged_decode_attention(q, k_pool, v_pool, block_tbl,
                                         lengths, window=window)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {name: mod.LAUNCHES for name, mod in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS.values():
        mod.LAUNCHES = 0
