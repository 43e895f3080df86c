"""Mamba2 / SSD (state-space duality) layer: chunked matmul form.

Same functions as ``repro/models/ssm.py``. The prefill scan goes through
``repro_torch.kernels.ops.ssd`` (the ssd_scan kernel on the card, its
plain version ``kernels/ssd_scan/ref.py`` on the CPU); the single-token
decode update is plain tensor code, as in the reference. Where the
reference returns a new cache, ``ssm_block`` writes the state and conv
tail views it is given in place.

Under tensor parallelism across ranks (``partitioning.tensor_parallel``:
the baseline rules cut 'inner' and the heads over 'model') a rank holds
its contiguous block of the fused projection ``w_in``'s columns, of the
conv's channels and of the conv tail cache, which straddle the z / x /
B / C / dt boundaries, and its heads of ``a_log``, ``d_skip``,
``dt_bias``, the state cache, ``out_norm`` and ``w_out``'s rows. The
block runs on the rank's heads: the fused activation, the conv's
weights and its tail are gathered whole over the axis, the conv runs
whole, the scan (or the decode update) takes the rank's heads of x, dt
and z and all of B and C, ``out_norm``'s mean square is the sum over
the ranks of theirs (f32), ``w_out``'s row block is contracted and
summed over the ranks, and the rank writes back its block of the conv
tail and its heads of the state. Its transposes, for the train step:
the block's normed input enters the column-cut ``w_in`` through
``TensorParallel.enter`` (its gradient summed over the ranks); the fused
activation and the conv's weights are gathered by ``gather_zero``, since
each rank consumes its own heads and all of B and C (their gradient the
reduce-scatter of the ranks' partial sums); the summed squares feed each
rank's own heads, so their gradient is the sum of the ranks' too
(``tp_all_reduce`` then ``tp_enter``); ``w_out``'s partial products are
summed with a pass-through gradient (``TensorParallel.contract``). The
conv tail is gathered for serving only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.launch import collectives
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ssm_spec
from repro_torch.models.partitioning import refuse_cut, shard, tensor_parallel


class SSMCache(NamedTuple):
    """Stacked per-repeat recurrent state.

    state: (repeats, batch, heads, head_dim, state_dim) f32, the SSD state
    conv:  (repeats, batch, conv_width-1, conv_dim), the conv tail
    """

    state: torch.Tensor
    conv: torch.Tensor


def make_ssm_cache(cfg: ModelConfig, n_repeats: int, batch: int,
                   dtype=torch.float32, device="cpu") -> SSMCache:
    ssm = cfg.ssm
    inner = ssm.inner_dim(cfg.d_model)
    nh = ssm.n_heads(cfg.d_model)
    conv_dim = inner + 2 * ssm.state_dim
    return SSMCache(
        torch.zeros((n_repeats, batch, nh, ssm.head_dim, ssm.state_dim),
                    dtype=torch.float32, device=device),
        torch.zeros((n_repeats, batch, ssm.conv_width - 1, conv_dim),
                    dtype=dtype, device=device))


def ssd_decode_step(x, dt, a, b, c, d_skip, state):
    """Single-token SSD state update.

    x: (B,H,P), dt: (B,H), b,c: (B,N), state: (B,H,P,N) f32.
    Returns (y (B,H,P) in x's dtype, new state f32).
    """
    f32 = torch.float32
    x32, dt32 = x.to(f32), dt.to(f32)
    dA = torch.exp(dt32 * a)                          # (B,H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt32, b.to(f32), x32)
    new_state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", new_state, c.to(f32))
    y = y + x32 * d_skip[None, :, None]
    return y.to(x.dtype), new_state


def _causal_conv(xbc, w, bias, tail=None):
    """Depthwise causal conv, width W. xbc: (B,S,D), w: (W,D), tail:
    (B,W-1,D). The new tail is the last W-1 rows of the input as given,
    padding included, exactly as the reference takes it."""
    W = w.shape[0]
    if tail is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = tail.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)               # (B, S+W-1, D)
    out = sum(full[:, i:i + xbc.shape[1]] * w[i] for i in range(W))
    new_tail = full[:, -(W - 1):] if W > 1 else None
    return out + bias, new_tail


def _softplus(x):
    """Exact ``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``torch.nn.functional.softplus`` switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _heads_parallel(cfg: ModelConfig):
    """This rank's ``TensorParallel`` where it cuts the block's heads, or
    None where every leaf is whole on every rank. A cut of the block's
    leaves that leaves its heads whole raises ``NotImplementedError``."""
    tp = tensor_parallel()
    if tp is None:
        return None
    if not tp.cut("heads", cfg.ssm.n_heads(cfg.d_model)):
        refuse_cut("ssm_block", lambda: ssm_spec(cfg),
                   "the SSM block with heads that the axis does not "
                   "divide (item 4.1)")
        return None
    return tp


def _for_own_heads(tp, t, logical: str, dim: int):
    """``t`` whole along the axis, for each rank's own heads to consume:
    gathered where its last dim (``dim`` whole, named ``logical``) is cut,
    else as it is; either way its gradient is the sum of the ranks'
    (``gather_zero``'s reduce-scatter, or ``tp_enter``'s all-reduce)."""
    if not tp.cut(logical, dim):
        return tp.enter(t)
    return collectives.gather_zero(t, tp.mesh, tp.axis, dim=-1)


def ssm_block(p, x, cfg: ModelConfig, *,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              positions=None):
    """One Mamba2 block with residual.

    cache: per-repeat (state (B,H,P,N), conv_tail (B,W-1,D)) views, or
      None; written in place with the new state and tail.
    positions: (B,S) with -1 for padding: padded steps get dt=0 so they
      leave the recurrent state untouched.
    x: (B,S,d). Returns (out, cache).
    Across ranks ``p`` and ``cache`` are this rank's blocks (see the
    module's docstring); H is then this rank's heads.
    """
    ssm = cfg.ssm
    d = cfg.d_model
    inner = ssm.inner_dim(d)
    nh = ssm.n_heads(d)
    N = ssm.state_dim
    P = ssm.head_dim
    conv_dim = inner + 2 * N
    bsz, S = x.shape[:2]
    fused = 2 * inner + 2 * N + nh
    tp = _heads_parallel(cfg)
    h0, nh_loc = tp.block(nh) if tp is not None else (0, nh)

    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if tp is not None and tp.cut("inner", fused):
        h = tp.enter(h)
    zxbcdt = h @ p["w_in"]                            # (B,S, 2*inner+2N+nh)
    zxbcdt = shard(zxbcdt, "batch", None, "act_inner")
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    tail = cache[1] if cache is not None else None
    if tp is not None:
        zxbcdt = _for_own_heads(tp, zxbcdt, "inner", fused)
        conv_w, conv_b = (_for_own_heads(tp, t, "inner", conv_dim)
                          for t in (conv_w, conv_b))
        if tail is not None and tp.cut("act_inner", conv_dim):
            tail = collectives.all_gather(tail, tp.mesh, tp.axis, dim=-1)
    heads = slice(h0 * P, (h0 + nh_loc) * P)          # this rank's channels
    z = zxbcdt[..., heads]
    xbc = zxbcdt[..., inner: 2 * inner + 2 * N]
    dt0 = 2 * inner + 2 * N + h0
    dt = zxbcdt[..., dt0:dt0 + nh_loc]                # (B,S,H)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    if positions is not None:
        dt = dt * (positions >= 0).float()[..., None]

    a = -torch.exp(p["a_log"].float())                # (H,)
    dsk = p["d_skip"].float()

    decode = cache is not None and S == 1
    xbc, new_tail = _causal_conv(xbc, conv_w, conv_b, tail)
    xbc = F.silu(xbc)
    xs = xbc[..., heads].reshape(bsz, S, nh_loc, P)
    bm = xbc[..., inner: inner + N]
    cm = xbc[..., inner + N:]

    if decode:
        y, new_state = ssd_decode_step(
            xs[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], dsk, cache[0])
        y = y[:, None]
    else:
        init = cache[0] if cache is not None else None
        chunk = min(ssm.chunk_size, S)
        if S % chunk:
            chunk = S   # one chunk for odd small sequences
        y, new_state = K.ssd(xs.contiguous(), dt.contiguous(), a,
                             bm.contiguous(), cm.contiguous(), dsk, chunk,
                             init)
    if cache is not None:
        cache[0].copy_(new_state)
        if tp is not None and tp.cut("act_inner", conv_dim):
            start, n = tp.block(conv_dim)         # this rank's channels
            new_tail = new_tail[..., start:start + n]
        cache[1].copy_(new_tail)

    y = y.reshape(bsz, S, nh_loc * P)
    y = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y = rms_norm(y, p["out_norm"], cfg.norm_eps)
        return x + shard(y @ p["w_out"], "batch", None, "act_embed"), cache
    # out_norm's mean square over the whole of 'inner': the ranks' sums,
    # which each rank's own heads consume
    y32 = y.float()
    ss = tp.enter(collectives.tp_all_reduce(
        torch.sum(y32 * y32, dim=-1, keepdim=True), tp.mesh, tp.axis))
    y = (y32 * torch.rsqrt(ss / inner + cfg.norm_eps)
         * p["out_norm"].float()).to(y.dtype)
    out = tp.contract(y, p["w_out"], "inner", inner)
    return x + shard(out, "batch", None, "act_embed"), cache
