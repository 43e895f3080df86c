"""Wrapper of the hand-written dense decode-attention kernel
(``csrc/decode_attention.cu``), the Hopper replacement of the TPU kernel
``repro/kernels/decode_attention/kernel.py:decode_attention``.

CPU tensors take the plain PyTorch version (``ref.decode_attention_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

LAUNCHES = 0          # kernel launches since the last reset
SPLIT_LEN = 128       # kv tokens per block of the split-K first pass
MAX_GROUP = 8         # q heads per kv head the kernel handles


def split_partials(b: int, nkv: int, n_tokens: int, hd: int,
                   device) -> tuple:
    """Scratch for the split-K partials: (nsplit, m, l, acc) in f32."""
    nsplit = max(1, -(-n_tokens // SPLIT_LEN))
    m = torch.empty((b, nkv, nsplit, MAX_GROUP), dtype=torch.float32,
                    device=device)
    return (nsplit, m, torch.empty_like(m),
            torch.empty((b, nkv, nsplit, MAX_GROUP, hd), dtype=torch.float32,
                        device=device))


def decode_attention(q, k, v, q_pos, kv_pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (b, nq, hd); k, v: (b, S, nkv, hd); q_pos: (b,); kv_pos: (b, S)
    int32, -1 = empty slot. Returns (b, nq, hd) in q's dtype."""
    global LAUNCHES
    if B.is_plain(q, k, v, q_pos, kv_pos):
        return decode_attention_ref(q, k, v, q_pos, kv_pos, window=window)
    B.require(q.dim() == 3 and k.dim() == 4 and k.shape == v.shape,
              f"decode_attention: bad shapes q{tuple(q.shape)} "
              f"k{tuple(k.shape)}")
    b, nq, hd = q.shape
    _, S, nkv, _ = k.shape
    B.require(k.shape[0] == b and k.shape[3] == hd and nkv > 0
              and nq % nkv == 0 and nq // nkv <= MAX_GROUP,
              f"decode_attention: q{tuple(q.shape)} vs k{tuple(k.shape)} "
              f"(at most {MAX_GROUP} q heads per kv head)")
    B.require(tuple(q_pos.shape) == (b,) and tuple(kv_pos.shape) == (b, S),
              "decode_attention: positions must be (b,) and (b, S)")
    code = B.check_operands("decode_attention", (q, k, v), (q_pos, kv_pos),
                            hd)
    win = B.check_window(window)
    out = torch.empty_like(q)
    nsplit, m, l, acc = split_partials(b, nkv, S, hd, q.device)
    B.launch("decode_attention", q.device, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             out.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
             b, S, nq, nkv, hd, code, win, SPLIT_LEN, nsplit, hd ** -0.5)
    LAUNCHES += 1
    return out
