"""Plain PyTorch versions of the Mamba2 SSD scan.

``ssd_chunked`` is the chunked algorithm of ``repro/models/ssm.py``
(arXiv:2405.21060 §6): the intra-chunk term from the lower-triangular
segment sums (``-inf`` above the diagonal before the exponential), the
chunk states, the inter-chunk recurrence (a Python loop in place of
``lax.scan``) and the off-diagonal term. ``ssd_sequential`` is the exact
token-by-token recurrence of ``repro/kernels/ssd_scan/ref.py``, the
ground truth for the tests. ``ssd_chunked_bwd`` is the gradient of
``ssd_chunked`` written out in the same chunked form (a reverse
recurrence over the chunks' state gradients, then each chunk's own
terms), the arithmetic of the gradient kernel ``csrc/ssd_scan_bwd.cu``.

Shapes: x (B, S, H, P), dt (B, S, H), a (H,), b and c (B, S, N),
d_skip (H,), init_state (B, H, P, N) or None. Both return y in x's dtype
and the final state (B, H, P, N) in f32. The chunked forms compute in f32,
or in f64 where x is f64 (the card's checks take that as the truth).
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
    return ssd_chunked_states(x, dt, a, b, c, d_skip, chunk, init_state)[:2]


def ssd_chunked_states(x, dt, a, b, c, d_skip, chunk: int,
                       init_state: Optional[torch.Tensor] = None):
    """``ssd_chunked``'s y and final state, and the state before each
    chunk (B, S / chunk, H, P, N) f32: what the gradient reads."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, f"seq {S} not divisible by chunk {chunk}"

    f32 = torch.promote_types(x.dtype, torch.float32)
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
    return y.to(x.dtype), carry, prev_states


def ssd_chunked_bwd(x, dt, a, b, c, d_skip, chunk: int,
                    init_state: Optional[torch.Tensor],
                    prev_states: Optional[torch.Tensor], dy,
                    dfinal: Optional[torch.Tensor]):
    """The gradient of ``ssd_chunked(x, dt, a, b, c, d_skip, chunk,
    init_state)`` for the output gradients ``dy`` (of y) and ``dfinal``
    (of the final state, None for zeros): (dx, ddt, da, db, dc, dd_skip,
    dinit), dx, db and dc in x's dtype, ddt, da and dd_skip in those of
    dt, a and d_skip, dinit in f32 (f64 for f64 x). ``prev_states``:
    the state before each chunk (``ssd_chunked_states``' third output),
    recomputed when None.

    Per batch row, head and chunk, with l_t = dt_t a, cum the prefix sum
    of l over the chunk, xdt_j = dt_j x_j, S the state before the chunk
    and G the gradient of the state after it:
      G before the chunk = exp(cum_last) G + sum_i exp(cum_i) dy_i (x) C_i
      dxdt_j = sum_{i>=j} (C_i.B_j) exp(cum_i - cum_j) dy_i
               + exp(cum_last - cum_j) G B_j
      dC_i = sum_{j<=i} exp(cum_i - cum_j) (dy_i.xdt_j) B_j
             + exp(cum_i) S^T dy_i
      dB_j = sum_{i>=j} exp(cum_i - cum_j) (dy_i.xdt_j) C_i
             + exp(cum_last - cum_j) G^T xdt_j
    summed over the heads for dB and dC (one group shared by every head);
    the pair weights w_ij = (C_i.B_j) exp(cum_i - cum_j) (dy_i.xdt_j) give
    dcum_i their row sum less their column sum, plus the off-diagonal and
    the chunk-end terms; dl is dcum's reverse cumulative sum over the
    chunk, from which ddt (with x.dxdt), da and dd_skip."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = S // chunk
    assert nc * chunk == S, f"seq {S} not divisible by chunk {chunk}"
    f32 = torch.promote_types(x.dtype, torch.float32)
    if prev_states is None:
        prev_states = ssd_chunked_states(x, dt, a, b, c, d_skip, chunk,
                                         init_state)[2]
    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(B, nc, chunk, H).to(f32)
    bc = b.reshape(B, nc, chunk, N).to(f32)
    cc = c.reshape(B, nc, chunk, N).to(f32)
    dyc = dy.reshape(B, nc, chunk, H, P).to(f32)
    a_dtype, a = a.dtype, a.to(f32)
    prev = prev_states.to(f32)                        # (B,nc,H,P,N)

    cum = torch.cumsum((dtc * a).movedim(-1, -2), dim=-1)   # (B,nc,H,L)
    decay = torch.exp(_segsum((dtc * a).movedim(-1, -2)))   # (B,nc,H,i,j)
    decay_in = torch.exp(cum)                         # exp(cum_i)
    decay_to_end = torch.exp(cum[..., -1:] - cum)     # exp(cum_last - cum_j)
    chunk_decay = torch.exp(cum[..., -1])             # (B,nc,H)
    xdt = xc * dtc[..., None]                         # (B,nc,L,H,P)

    # the state gradients, chunk by chunk in reverse: gnext[c] is the
    # gradient of the state after chunk c
    own = torch.einsum("bchi,bcihp,bcin->bchpn", decay_in, dyc, cc)
    g = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if dfinal is None else dfinal.to(f32))
    gnext = [None] * nc
    for k in reversed(range(nc)):
        gnext[k] = g
        g = g * chunk_decay[:, k, :, None, None] + own[:, k]
    gnext = torch.stack(gnext, dim=1)                 # (B,nc,H,P,N)

    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)      # (B,nc,i,j)
    scores = cb[:, :, None] * decay                   # (B,nc,H,i,j)
    dyx = torch.einsum("bcihp,bcjhp->bchij", dyc, xdt)
    m = decay * dyx                                   # (B,nc,H,i,j)
    gb = torch.einsum("bchpn,bcjn->bchjp", gnext, bc)  # G B_j
    dxdt = (torch.einsum("bchij,bcihp->bcjhp", scores, dyc)
            + (decay_to_end[..., None] * gb).movedim(2, 3))
    sdy = torch.einsum("bchpn,bcihp->bchin", prev, dyc)    # S^T dy_i
    dc = (torch.einsum("bchij,bcjn->bcin", m, bc)
          + torch.einsum("bchi,bchin->bcin", decay_in, sdy))
    gx = torch.einsum("bchpn,bcjhp->bchjn", gnext, xdt)    # G^T xdt_j
    db = (torch.einsum("bchij,bcin->bcjn", m, cc)
          + torch.einsum("bchj,bchjn->bcjn", decay_to_end, gx))

    w = cb[:, :, None] * m                            # (B,nc,H,i,j)
    dcum = w.sum(-1) - w.sum(-2)
    dcum = dcum + decay_in * torch.einsum("bchin,bcin->bchi", sdy, cc)
    u = decay_to_end * torch.einsum("bchjn,bcjn->bchj", gx, bc)
    dcum = dcum - u
    dcum[..., -1] += u.sum(-1) + chunk_decay * (gnext * prev).sum((-1, -2))
    dl = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    dl = dl.movedim(-1, -2)                           # (B,nc,L,H)

    ddt = (xc * dxdt).sum(-1) + a * dl
    da = (dtc * dl).sum((0, 1, 2))
    dx = dxdt * dtc[..., None] + dyc * d_skip.to(f32)[:, None]
    dd = (dyc * xc).sum((0, 1, 2, 4))
    return (dx.reshape(B, S, H, P).to(x.dtype),
            ddt.reshape(B, S, H).to(dt.dtype), da.to(a_dtype),
            db.reshape(B, S, N).to(b.dtype), dc.reshape(B, S, N).to(c.dtype),
            dd.to(d_skip.dtype), g)


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
