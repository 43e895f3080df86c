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


def _valid(q_pos, kv_pos, window, causal):
    """(b, s, S): which (query, key) pairs the masks keep."""
    valid = (kv_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= 0)
    if causal:
        valid &= kv_pos[:, None, :] <= q_pos[:, :, None]
        if window is not None:
            valid &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    return valid


def _scores(q, k):
    """(b, nkv, g, s, S) f32: the scaled scores, q head h = kv head h // g."""
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    return torch.einsum("bskgh,bTkh->bkgsT", qg.float(),
                        k.float()) * (hd ** -0.5)


def _attention_dense(q, k, v, q_pos, kv_pos, window, causal):
    b, s, nq, hd = q.shape
    scores = _scores(q, k)
    valid = _valid(q_pos, kv_pos, window, causal)
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


def attention_bwd_ref(q, k, v, q_pos, kv_pos, dout, *,
                      window: Optional[int] = None, causal: bool = True):
    """The gradient of ``attention_ref``: (dq, dk, dv) for the output
    gradient ``dout``, by autograd of the plain ops above (what JAX
    derives from the reference's ``attention_ref``)."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention_ref(q, k, v, q_pos, kv_pos, window=window,
                            causal=causal)
        return torch.autograd.grad(out, (q, k, v), dout)


def attention_lse_ref(q, k, q_pos, kv_pos, *, window: Optional[int] = None,
                      causal: bool = True) -> torch.Tensor:
    """(b, nq, s) f32: each query row's log-sum-exp of its scaled, masked
    scores, natural units, what the forward kernel keeps for the gradient;
    +inf for a row without a valid key (so every exp(s - lse) of it is 0).
    Queries in chunks of ``_Q_CHUNK`` above ``_CHUNK_THRESHOLD``."""
    b, s, nq, _ = q.shape
    step = s if s <= _CHUNK_THRESHOLD else _Q_CHUNK
    out = []
    for i in range(0, s, step):
        sc = _scores(q[:, i:i + step], k)
        valid = _valid(q_pos[:, i:i + step], kv_pos, window, causal)
        sc = sc.masked_fill(~valid[:, None, None], float("-inf"))
        lse = torch.logsumexp(sc, dim=-1)
        out.append(torch.where(valid.any(-1)[:, None, None], lse,
                               float("inf")).reshape(b, nq, -1))
    return torch.cat(out, dim=-1)


def attention_bwd_from_lse(q, k, v, out, dout, lse, q_pos, kv_pos, *,
                           window: Optional[int] = None, causal: bool = True):
    """The gradient kernel's arithmetic in plain f32 ops: (dq, dk, dv) in
    the dtypes of q, k and v, from the forward's output ``out`` and
    log-sum-exp ``lse`` (b, nq, s). D = Σ dO·O a row; P = exp(scale s -
    lse) where the pair is valid, else 0; dP = dO Vᵀ; dS = P (dP - D);
    dV = Pᵀ dO and dK = scale dSᵀ Q, each summed over the GQA group of its
    kv head; dQ = scale dS K."""
    b, s, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = hd ** -0.5
    dog = dout.float().reshape(b, s, nkv, g, hd)
    delta = (dout.float() * out.float()).sum(-1)               # (b, s, nq)
    delta = delta.reshape(b, s, nkv, g).permute(0, 2, 3, 1)    # (b, k, g, s)
    valid = _valid(q_pos, kv_pos, window, causal)[:, None, None]
    lse = lse.reshape(b, nkv, g, s)
    p = torch.where(valid, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    dp = torch.einsum("bskgh,bTkh->bkgsT", dog, v.float())
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bkgsT,bskgh->bTkh", p, dog)
    dk = torch.einsum("bkgsT,bskgh->bTkh", ds,
                      q.float().reshape(b, s, nkv, g, hd)) * scale
    dq = torch.einsum("bkgsT,bTkh->bskgh", ds, k.float()) * scale
    return (dq.reshape(b, s, nq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
