"""Plain PyTorch versions of the Mamba2 SSD scan.

``ssd_chunked`` is the chunked algorithm of ``repro/models/ssm.py``
(arXiv:2405.21060 §6): the intra-chunk term from the lower-triangular
segment sums (``-inf`` above the diagonal before the exponential), the
chunk states, the inter-chunk recurrence (a Python loop in place of
``lax.scan``) and the off-diagonal term. ``ssd_sequential`` is the exact
token-by-token recurrence of ``repro/kernels/ssd_scan/ref.py``, the
ground truth for the tests.

Shapes: x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, N),
d_skip (H,), init_state (B, H, P, N) or None. Both return y in x's dtype
and the final state (B, H, P, N) in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _segsum(log_a):
    """(..., L) -> (..., L, L) lower-triangular cumulative log-decays."""
    L = log_a.shape[-1]
    cum = torch.cumsum(log_a, dim=-1)
    # decay from j (exclusive) to i (inclusive): cum_i - cum_j
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, torch.full((), float("-inf"),
                                              device=log_a.device))


def ssd_chunked(x, dt, a, b, c, d_skip, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, f"seq {S} not divisible by chunk {chunk}"

    f32 = torch.float32
    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    bc = b.reshape(B, nc, chunk, N).to(f32)
    cc = c.reshape(B, nc, chunk, N).to(f32)
    a = a.to(f32)

    log_dA = dtc * a                                  # (B,nc,L,H)  a<0
    log_dA_t = log_dA.movedim(-1, -2)                 # (B,nc,H,L)
    decay = torch.exp(_segsum(log_dA_t))              # (B,nc,H,L,L)

    # diagonal (intra-chunk) term
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)      # (B,nc,L,L)
    scores = cb[:, :, None] * decay                   # (B,nc,H,L,L)
    xdt = xc * dtc[..., None]                         # (B,nc,L,H,P)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    # chunk states: decay from j to the end of the chunk
    cum = torch.cumsum(log_dA_t, dim=-1)              # (B,nc,H,L)
    decay_to_end = torch.exp(cum[..., -1:] - cum)     # (B,nc,H,L)
    states = torch.einsum("bchj,bcjn,bcjhp->bchpn",
                          decay_to_end, bc, xdt)      # (B,nc,H,P,N)

    # inter-chunk recurrence; prev[k] is the state BEFORE chunk k
    chunk_decay = torch.exp(cum[..., -1])             # (B,nc,H)
    carry = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for k in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, k, :, None, None] + states[:, k]
    prev_states = torch.stack(prev, dim=1)            # (B,nc,H,P,N)

    # off-diagonal (inter-chunk) term: y_off[i] = C_i . (decay_in * prev)
    decay_in = torch.exp(cum)                         # (B,nc,H,L)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc, prev_states,
                         decay_in)

    y = (y_diag + y_off).reshape(B, S, H, P)
    y = y + x.to(f32) * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), carry


def ssd_sequential(x, dt, a, b, c, d_skip,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact token-by-token recurrence (slow; ground truth)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    f32 = torch.float32
    a = a.to(f32)
    state = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    ys = []
    for t in range(S):
        dtt = dt[:, t].to(f32)
        dA = torch.exp(dtt * a)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dtt, b[:, t].to(f32),
                           x[:, t].to(f32))
        state = state * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t].to(f32)))
    y = torch.stack(ys, dim=1)                        # (B,S,H,P)
    y = y + x.to(f32) * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), state
