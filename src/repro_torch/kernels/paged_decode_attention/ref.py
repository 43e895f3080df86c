"""Plain PyTorch version of the paged decode-attention kernel.

Same function as ``repro/kernels/paged_decode_attention/ref.py``: gather
each slot's pages into a dense view and defer to the dense decode
version, with positions rebuilt from the page geometry.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def paged_decode_attention_ref(q, k_pool, v_pool, block_tbl, lengths,
                               *, window: Optional[int] = None
                               ) -> torch.Tensor:
    """Single-token GQA attention over a paged KV pool.

    q:              (b, nq, hd) — the new token's queries.
    k_pool, v_pool: (n_pages, page, nkv, hd) — shared physical pages.
    block_tbl:      (b, max_pages) int32 — physical page of each logical
                    page; unmapped entries point at the trash page 0.
    lengths:        (b,) int32 — valid KV tokens per slot INCLUDING the
                    current one (the query sits at position lengths-1).
    Returns (b, nq, hd).
    """
    b = q.shape[0]
    nkv, hd = k_pool.shape[2:]
    tbl = block_tbl.long()
    k = k_pool[tbl].reshape(b, -1, nkv, hd).to(q.dtype)
    v = v_pool[tbl].reshape(b, -1, nkv, hd).to(q.dtype)
    S = k.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=q.device)[None]
    lengths = lengths.to(torch.int32)
    kv_pos = torch.where(pos < lengths[:, None], pos,
                         torch.full((), -1, dtype=torch.int32,
                                    device=q.device))
    q_pos = torch.clamp(lengths - 1, min=0)
    return decode_attention_ref(q, k, v, q_pos, kv_pos, window=window)
