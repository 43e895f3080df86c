"""Plain PyTorch version of the flash-attention kernel (GQA, causal/window).

Same function as ``repro/kernels/flash_attention/ref.py``, quirks kept:
masked scores are ``NEG_INF = -1e30`` (not -inf), fully masked query
rows come out 0, and above 2048 queries the queries run in chunks of
1024 so the (s, S) score tensor never materialises in full.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _attention_dense(q, k, v, q_pos, kv_pos, window, causal):
    b, s, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, s, nkv, g, hd)
    scores = torch.einsum("bskgh,bTkh->bkgsT", qg.float(),
                          k.float()) * (hd ** -0.5)
    valid = (kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= 0)
    if causal:
        valid &= kv_pos[:, None, :] <= q_pos[:, :, None]
        if window is not None:
            valid &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    scores = torch.where(valid[:, None, None], scores,
                         torch.full((), NEG_INF, dtype=scores.dtype,
                                    device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (padding queries) produce uniform probs; zero them
    any_valid = valid.any(dim=-1)[:, None, None, :, None]
    probs = torch.where(any_valid, probs, torch.zeros((), dtype=probs.dtype,
                                                      device=probs.device))
    out = torch.einsum("bkgsT,bTkh->bskgh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, s, nq, hd).to(q.dtype)


_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 1024


def attention_ref(q, k, v, q_pos, kv_pos, *, window: Optional[int] = None,
                  causal: bool = True) -> torch.Tensor:
    """q: (b, s, nq, hd); k, v: (b, S, nkv, hd); q_pos: (b, s); kv_pos: (b, S).

    Positions < 0 mark padding / empty cache slots. GQA: nq = g * nkv.
    Returns (b, s, nq, hd) in q.dtype.
    """
    s = q.shape[1]
    if s <= _CHUNK_THRESHOLD:
        return _attention_dense(q, k, v, q_pos, kv_pos, window, causal)
    outs = [_attention_dense(q[:, i:i + _Q_CHUNK], k, v,
                             q_pos[:, i:i + _Q_CHUNK], kv_pos, window, causal)
            for i in range(0, s, _Q_CHUNK)]
    return torch.cat(outs, dim=1)
