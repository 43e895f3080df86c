"""Wrapper of the hand-written paged decode-attention kernel
(``csrc/paged_decode_attention.cu``, device code shared with the dense
decode kernel), the Hopper replacement of the TPU kernel
``repro/kernels/paged_decode_attention/kernel.py:paged_decode_attention``.

CPU tensors take the plain PyTorch version
(``ref.paged_decode_attention_ref``); CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.decode_attention.kernel import (MAX_GROUP,
                                                         SPLIT_LEN,
                                                         split_partials)
from repro_torch.kernels.paged_decode_attention.ref import (
                                                            paged_decode_attention_ref)

LAUNCHES = 0          # kernel launches since the last reset


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (b, nq, hd); k_pool, v_pool: (P, page, nkv, hd); block_tbl:
    (b, max_pages) int32; lengths: (b,) int32 valid tokens including the
    current one. Returns (b, nq, hd) in q's dtype."""
    global LAUNCHES
    if B.is_plain(q, k_pool, v_pool, block_tbl, lengths):
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tbl,
                                          lengths, window=window)
    B.require(q.dim() == 3 and k_pool.dim() == 4
              and k_pool.shape == v_pool.shape,
              f"paged_decode_attention: bad shapes q{tuple(q.shape)} "
              f"pool{tuple(k_pool.shape)}")
    b, nq, hd = q.shape
    _, page, nkv, _ = k_pool.shape
    B.require(k_pool.shape[3] == hd and nkv > 0 and nq % nkv == 0
              and nq // nkv <= MAX_GROUP,
              f"paged_decode_attention: q{tuple(q.shape)} vs "
              f"pool{tuple(k_pool.shape)} (at most {MAX_GROUP} q heads "
              f"per kv head)")
    B.require(block_tbl.dim() == 2 and block_tbl.shape[0] == b
              and tuple(lengths.shape) == (b,),
              "paged_decode_attention: block_tbl (b, max_pages), lengths (b,)")
    code = B.check_operands("paged_decode_attention", (q, k_pool, v_pool),
                            (block_tbl, lengths), hd)
    win = B.check_window(window)
    max_pages = block_tbl.shape[1]
    out = torch.empty_like(q)
    nsplit, m, l, acc = split_partials(b, nkv, max_pages * page, hd,
                                       q.device)
    B.launch("paged_decode_attention", q.device, q.data_ptr(),
             k_pool.data_ptr(), v_pool.data_ptr(), block_tbl.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
             acc.data_ptr(), b, page, max_pages, nq, nkv, hd, code, win,
             SPLIT_LEN, nsplit, hd ** -0.5)
    LAUNCHES += 1
    return out
