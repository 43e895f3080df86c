"""Wrapper of the hand-written flash-attention kernel
(``csrc/flash_attention.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``.

CPU tensors take the plain PyTorch version (``ref.attention_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = 0          # kernel launches since the last reset


def flash_attention(q, k, v, q_pos, kv_pos, *, window: Optional[int] = None,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, s, nq, hd); k, v: (b, S, nkv, hd); q_pos (b, s), kv_pos
    (b, S) int32 with -1 for padding. Returns (b, s, nq, hd) in q's dtype."""
    global LAUNCHES
    if B.is_plain(q, k, v, q_pos, kv_pos):
        return attention_ref(q, k, v, q_pos, kv_pos, window=window,
                             causal=causal)
    B.require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
              f"flash_attention: bad shapes q{tuple(q.shape)} "
              f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, s, nq, hd = q.shape
    _, S, nkv, _ = k.shape
    B.require(k.shape[0] == b and k.shape[3] == hd and nkv > 0
              and nq % nkv == 0,
              f"flash_attention: q{tuple(q.shape)} vs k{tuple(k.shape)}")
    B.require(tuple(q_pos.shape) == (b, s) and tuple(kv_pos.shape) == (b, S),
              "flash_attention: positions must be (b, s) and (b, S)")
    code = B.check_operands("flash_attention", (q, k, v), (q_pos, kv_pos), hd)
    win = B.check_window(window)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    B.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             out.data_ptr(), b, s, S, nq, nkv, hd, code, int(causal), win,
             hd ** -0.5)
    LAUNCHES += 1
    return out
