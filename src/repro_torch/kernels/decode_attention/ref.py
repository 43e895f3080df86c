"""Plain PyTorch version of the decode-attention kernel.

Same function as ``repro/kernels/decode_attention/ref.py``, quirks kept:
masked scores are ``NEG_INF = -1e30``, and a row with no valid key is
NOT zeroed (the softmax over all-masked scores is uniform), unlike the
flash version.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, q_pos, kv_pos,
                         *, window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA attention over a (ring-buffer) KV cache.

    q: (b, nq, hd) — the one new token's queries.
    k, v: (b, S, nkv, hd); kv_pos: (b, S) absolute positions, -1 = empty.
    q_pos: (b,) the token's absolute position.
    Returns (b, nq, hd).
    """
    b, nq, hd = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, nkv, g, hd)
    scores = torch.einsum("bkgh,bTkh->bkgT", qg.float(),
                          k.float()) * (hd ** -0.5)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid &= kv_pos > (q_pos[:, None] - window)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgT,bTkh->bkgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, nq, hd).to(q.dtype)
