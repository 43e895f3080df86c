"""Core transformer layers: RMSNorm, RoPE, GQA attention (full / sliding
window, prefill / decode, dense and paged caches), gated MLP.

Same functions as ``repro/models/layers.py``. Where the reference returns
new cache arrays, the port writes the cache views it is given in place
(the engine's caches are preallocated and reused) and returns the same
views. Attention goes through ``repro_torch.kernels.ops``.

Under tensor parallelism across ranks (``partitioning.tensor_parallel``)
``attention_block`` and ``mlp_block`` run on a rank's blocks of their
weights and caches: q/k/v columns gathered where the heads are not cut,
attention over this rank's q heads and the kv heads they read (whatever
group those form), ``wo`` summed over the ranks. Their normed input
enters the products with cut weights through ``TensorParallel.enter``
(the all-reduce of its gradient), and each gather carries the transpose
its consumer asks for (``launch/collectives.py``), so a train step's
gradients are the reference's on every rank. A dense cache whose kv
heads the axis does not divide is cut over its sequence: a decode step
then attends every head over this rank's slots and combines the ranks'
results by their log-sum-exps (flash-decode, as the reference's GSPMD
program does); a paged pool is then whole on every rank, and the kv
heads a rank's q heads read are copied out of it where they are not all.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.launch import collectives
from repro_torch.models.params import attn_spec
from repro_torch.models.partitioning import (kv_heads_cut, refuse_cut, shard,
                                             tensor_parallel)

FP8 = K.FP8
# the largest magnitude that rounds into float8_e4m3fn (448 and the tie
# at 464 round to 448; 480 would be the NaN code)
_FP8_LIMIT = 464.0


def to_kv(x, dtype):
    """``x`` in the KV storage dtype ``dtype``: every value that enters a
    KV cache or pool goes through here. For float8_e4m3fn it is the
    reference's ``astype``: NaN (with x's sign) where |x| > 464 or x is
    infinite, round-to-nearest-even elsewhere; ``Tensor.to`` would
    saturate to +-448 instead. Any other dtype is a plain ``.to``. The
    cast goes through f32 (exact from bf16, so one rounding, as JAX's):
    CUDA's bf16 copysign or cast does not keep every NaN's sign."""
    if dtype == FP8 and x.dtype != FP8:
        x = x.float()
        x = torch.copysign(x.masked_fill(x.abs() > _FP8_LIMIT, float("nan")),
                           x)
    return x.to(dtype)


def rms_norm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope(x, positions, theta: float):
    """x: (b, s, heads, head_dim), positions: (b, s) int32."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)      # scalar base: no host->device copy
    ang = positions[..., None].float() * freqs          # (b, s, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class AttnCache(NamedTuple):
    """Per-pattern-position stacked KV cache.

    k, v:    (repeats, batch, S, n_kv, head_dim)
    kv_pos:  (repeats, batch, S) int32, -1 = empty slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    kv_pos: torch.Tensor


class CrossCache(NamedTuple):
    """Stacked cross-attention K/V of an encoder-decoder, slot-indexed.

    k, v:     (repeats, batch, n_ctx, n_kv, head_dim)
    enc_pos:  (repeats, batch, n_ctx) int32, -1 = empty slot.
    """

    k: torch.Tensor
    v: torch.Tensor
    enc_pos: torch.Tensor


def make_attn_cache(cfg: ModelConfig, n_repeats: int, batch: int,
                    max_len: int, window: Optional[int], dtype, device):
    """``window``: clamp the cache to it (a ring buffer), or None for
    ``max_len`` slots. ``dtype`` is the K/V storage dtype (fp8 included);
    kv_pos is int32."""
    s = min(max_len, window) if window else max_len
    kshape = (n_repeats, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return AttnCache(torch.zeros(kshape, dtype=dtype, device=device),
                     torch.zeros(kshape, dtype=dtype, device=device),
                     torch.full((n_repeats, batch, s), -1, dtype=torch.int32,
                                device=device))


class PagedAttnCache(NamedTuple):
    """Per-pattern-position paged KV pool, shared by all decode slots.

    k, v: (repeats, n_pages, page_size, n_kv, head_dim). Physical page 0
    is the trash page: unmapped block-table entries point there, so stray
    writes never touch live pages, and nothing reads it as data.
    """

    k: torch.Tensor
    v: torch.Tensor


def make_paged_attn_cache(cfg: ModelConfig, n_repeats: int, n_pages: int,
                          page_size: int, dtype, device):
    """``dtype`` is the K/V storage dtype (fp8 included)."""
    shape = (n_repeats, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return PagedAttnCache(torch.zeros(shape, dtype=dtype, device=device),
                          torch.zeros(shape, dtype=dtype, device=device))


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def compute_cross_kv(p, enc_out, enc_pos, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output (once per request):
    (k, v (b, T, nkv, hd), enc_pos (b, T))."""
    k = _split_heads(enc_out @ p["xwk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(enc_out @ p["xwv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v, enc_pos


def cross_attention_block(p, x, positions, enc_kv, cfg: ModelConfig):
    """Cross-attention over precomputed encoder K/V; residual included.
    Non-causal, so flash takes every query, the single decode token too."""
    refuse_cut("cross_attention_block",
               lambda: attn_spec(cfg, cross=True),
               "the encoder-decoder (whisper) under tensor parallelism "
               "(item 4.1)")
    k, v, enc_pos = enc_kv
    h = rms_norm(x, p["xnorm"], cfg.norm_eps)
    q = _split_heads(h @ p["xwq"], cfg.n_heads, cfg.head_dim)
    q = shard(q, "batch", None, "act_heads", None)
    out = K.attention(q, k.to(q.dtype), v.to(q.dtype), positions, enc_pos,
                      causal=False)
    out = out.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    return x + shard(out @ p["xwo"], "batch", None, "act_embed")


def attention_block(p, x, positions, cfg: ModelConfig, *, window=None,
                    cache: Optional[Tuple[torch.Tensor, ...]] = None,
                    cur_len: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    pages: Optional[torch.Tensor] = None,
                    prefix_len=None, pos_base=None):
    """One self-attention sub-block with residual.

    cache: per-repeat cache views. Dense: (k_cache, v_cache, kv_pos) —
      (b, S, nkv, hd) / (b, S); a single decode token is written at slot
      ``cur_len % S`` (ring buffer). A prefill fills the views from the
      start and clears the rest.
    pages: (b, max_pages) int32 block table — switches the cache to the
      PAGED layout: cache is (k_pool, v_pool) of shape (n_pages, page,
      nkv, hd). Decode writes one token into its slot's current page;
      prefill scatters the sequence's pages into the pool (pages past a
      slot's mapped ones land on the trash page 0).
    prefix_len / pos_base (ints): SUFFIX prefill against a cached prefix
      (batch 1). The first ``prefix_len`` tokens already sit in pool pages
      mapped by the block table; ``x`` holds the tokens from the
      page-aligned ``pos_base`` onward (entries below ``prefix_len`` are
      dummies with position -1). Queries attend to the gathered prefix
      plus the in-batch suffix; the scatter is masked per token so a
      copied-on-write partial page keeps its prefix tokens.
    The cache views are written in place. Returns (out, cache_views_or_None).
    """
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    tp = tensor_parallel()
    if tp is not None:
        hc = tp.enter(h)
        # the gathered K/V feed this rank's own q heads where those are cut
        own = tp.cut("act_heads", cfg.n_heads)

    def heads(w, n, w_logical, act_logical):
        """(h @ p[w] split into heads, its first head: 0 where whole)."""
        if tp is None:
            return _split_heads(h @ p[w], n, cfg.head_dim), 0
        src = hc if tp.cut(w_logical, n * cfg.head_dim) else h
        return tp.heads(src @ p[w], n, cfg.head_dim, w_logical, act_logical,
                        own)

    # q/k/v are constrained on their HEAD axes (shard() leaves a head
    # count that the model axis does not divide whole)
    q, q0 = heads("wq", cfg.n_heads, "q", "act_heads")
    q = shard(q, "batch", None, "act_heads", None)
    k, k0 = heads("wk", cfg.n_kv_heads, "kv", "act_kv_heads")
    v, _ = heads("wv", cfg.n_kv_heads, "kv", "act_kv_heads")
    k = shard(k, "batch", None, "act_kv_heads", None)
    v = shard(v, "batch", None, "act_kv_heads", None)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    def sel(kk, vv):
        """K/V of the kv heads this rank's q heads read."""
        if tp is None:
            return kk, vv
        return _kv_for(q, q0, kk, vv, k0, cfg.n_heads // cfg.n_kv_heads)

    b = x.shape[0]

    new_cache = None
    if cache is not None and pages is not None:
        # ---- paged KV pool: (n_pages, page, nkv, hd) shared by slots ----
        ck, cv = cache
        page = ck.shape[1]
        if x.shape[1] == 1:
            # decode: write one token into the slot's current page. Slots
            # whose row is unmapped all write the trash page 0, where the
            # last writer wins, as in the reference.
            pos = cur_len.to(torch.int32)                           # (b,)
            pidx = torch.clamp(pos // page, 0, pages.shape[1] - 1)
            phys = torch.gather(pages, 1, pidx[:, None].long())[:, 0].long()
            off = (pos % page).long()
            ck[phys, off] = to_kv(k[:, 0], ck.dtype)
            cv[phys, off] = to_kv(v[:, 0], cv.dtype)
            new_cache = (ck, cv)
            out = K.paged_attention(q[:, 0], *sel(ck, cv), pages, pos + 1,
                                    window=window)[:, None]
        elif prefix_len is None:
            # prefill: scatter the (padded) sequence's pages into the pool
            S = k.shape[1]
            if S % page:
                raise ValueError(
                    f"paged prefill length {S} not a multiple of page {page}")
            npg = S // page
            if npg > pages.shape[1]:
                raise ValueError("prefill longer than block table")
            flat = pages[:, :npg].reshape(-1).long()
            ck[flat] = to_kv(k.reshape(b * npg, page, *k.shape[2:]), ck.dtype)
            cv[flat] = to_kv(v.reshape(b * npg, page, *v.shape[2:]), cv.dtype)
            new_cache = (ck, cv)
            # attends over the unrounded k/v, as the reference does
            out = K.attention(q, *sel(k, v), positions, positions,
                              window=window)
        else:
            # ---- suffix prefill against a cached prefix (batch 1) ----
            S = k.shape[1]
            if S % page:
                raise ValueError(
                    f"paged prefill length {S} not a multiple of page {page}")
            if b != 1:
                raise ValueError("suffix prefill is batch-1 only")
            npg = S // page
            width = pages.shape[1]
            # jax.lax.dynamic_slice clamps its start so the slice stays in
            # bounds; reproduce that
            start = min(max(int(pos_base) // page, 0), width - npg)
            flat = pages[:, start:start + npg].reshape(-1).long()
            kp = to_kv(k.reshape(b * npg, page, *k.shape[2:]), ck.dtype)
            vp = to_kv(v.reshape(b * npg, page, *v.shape[2:]), cv.dtype)
            # token-masked scatter: dummy positions (the CoW page's copied
            # prefix tokens and the right padding) keep the pool's values
            keep = (positions >= 0).reshape(b * npg, page)[..., None, None]
            ck[flat] = torch.where(keep, kp, ck[flat])
            cv[flat] = torch.where(keep, vp, cv[flat])
            new_cache = (ck, cv)
            # gather the cached prefix through the whole block-table row
            # (in q's dtype: an fp8 pool is widened here, flash never
            # reads fp8); slots at/after prefix_len are masked out
            row = pages.reshape(-1).long()
            pk = ck[row].reshape(b, width * page, *k.shape[2:])
            pv = cv[row].reshape(b, width * page, *v.shape[2:])
            span = torch.arange(width * page, dtype=torch.int32,
                                device=x.device)[None]
            pfx_pos = torch.where(span < int(prefix_len), span,
                                  torch.full_like(span, -1))
            k_all = torch.cat([pk.to(q.dtype), k], dim=1)
            v_all = torch.cat([pv.to(q.dtype), v], dim=1)
            kv_pos = torch.cat([pfx_pos.expand(b, width * page), positions],
                               dim=1).contiguous()
            out = K.attention(q, *sel(k_all, v_all), positions, kv_pos,
                              window=window)
    elif cache is not None:
        ck, cv, cpos = cache
        S = ck.shape[1]
        # under TP a dense cache whose kv heads the axis does not divide
        # is cut over its sequence: this rank holds slots [base, base + S)
        # of a ring of S * ways (one process: base 0, the whole ring)
        seq_cut = tp is not None and not kv_heads_cut(tp.rules,
                                                      cfg.n_kv_heads)
        base, ring = (tp.coord * S, S * tp.ways) if seq_cut else (0, S)
        new_cache = (ck, cv, cpos)
        if x.shape[1] == 1:
            # ---- decode: write one token into the ring buffer ----
            _write_slot(new_cache, k, v, positions, cur_len, base, ring)
            if seq_cut:
                out = _decode_seq_cut(tp, cfg, q, q0, new_cache, positions,
                                      window)
            else:
                # the decode kernel reads an fp8 cache as it is (the
                # reference casts the whole cache to q's dtype first: the
                # same function)
                kv = (ck, cv) if ck.dtype == FP8 else (ck.to(q.dtype),
                                                       cv.to(q.dtype))
                out = K.attention(q, *sel(*kv), positions, cpos,
                                  window=window)
        else:
            # ---- prefill into cache (serving): seq fits the buffer ----
            _write_prefill(new_cache, k, v, positions, base, ring)
            out = K.attention(q, *sel(k, v), positions, positions,
                              window=window)
    else:
        # ---- training / encoder: no cache ----
        out = K.attention(q, *sel(k, v), positions, positions,
                          window=window, causal=causal)

    out = out.reshape(x.shape[0], x.shape[1], -1)
    out = out @ p["wo"] if tp is None else tp.contract(out, p["wo"], "q",
                                                       cfg.q_dim)
    return x + shard(out, "batch", None, "act_embed"), new_cache


def _kv_for(q, q0: int, k, v, k0: int, group: int):
    """K/V (dim 2 their heads, the first k0) of the kv heads that q's
    heads q0, q0 + 1, ... read (q head h reads kv head h // group): as
    they are where they hold exactly those, their slice where this rank's
    q heads form a group of their own over it, else one kv head a q
    head."""
    nq = q.shape[2]
    heads = [(q0 + i) // group - k0 for i in range(nq)]
    lo, n = heads[0], heads[-1] + 1 - heads[0]
    if nq % n == 0 and all(h - lo == i // (nq // n)
                           for i, h in enumerate(heads)):
        if (lo, n) == (0, k.shape[2]):
            return k, v
        return (k[:, :, lo:lo + n].contiguous(),
                v[:, :, lo:lo + n].contiguous())
    idx = torch.tensor(heads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _write_prefill(cache, k, v, positions, base: int, ring: int) -> None:
    """A prefill's K/V (b x s) into a dense cache that holds slots
    [base, base + S) of a ring of ``ring`` slots (one process: 0 and S);
    the slots past the prompt cleared."""
    ck, cv, cpos = cache
    S, s = ck.shape[1], k.shape[1]
    if ring < s:
        raise ValueError("prefill longer than cache")
    n = min(max(s - base, 0), S)
    ck[:, :n] = to_kv(k[:, base:base + n], ck.dtype)
    ck[:, n:] = 0
    cv[:, :n] = to_kv(v[:, base:base + n], cv.dtype)
    cv[:, n:] = 0
    cpos[:, :n] = positions[:, base:base + n]
    cpos[:, n:] = -1


def _write_slot(cache, k, v, positions, cur_len, base: int,
                ring: int) -> None:
    """One decode token (k, v whole) into its ring slot ``cur_len % ring``
    of a dense cache that holds slots [base, base + S) of the ring: where
    the ring is cut over ranks, only the rank holding the slot writes
    it."""
    ck, cv, cpos = cache
    b, S = ck.shape[:2]
    bidx = torch.arange(b, device=k.device)
    slot = (cur_len % ring).long()                             # (b,)
    kk, vv = to_kv(k[:, 0], ck.dtype), to_kv(v[:, 0], cv.dtype)
    pp = positions[:, 0].to(torch.int32)
    if ring > S:
        slot = slot - base
        mine = (slot >= 0) & (slot < S)
        slot = slot.clamp(0, S - 1)
        kk = torch.where(mine[:, None, None], kk, ck[bidx, slot])
        vv = torch.where(mine[:, None, None], vv, cv[bidx, slot])
        pp = torch.where(mine, pp, cpos[bidx, slot])
    ck[bidx, slot] = kk
    cv[bidx, slot] = vv
    cpos[bidx, slot] = pp


def _decode_seq_cut(tp, cfg: ModelConfig, q, q0: int, cache, positions,
                    window):
    """One decode token over a dense cache cut over its sequence (the
    token already written): this rank holds slots [c S, (c + 1) S) of
    every kv head. Each rank attends every q head (gathered where they
    are cut) over its slots through flash, in the cache's dtype (fp8
    widened to q's), which also gives each row's log-sum-exp; the ranks'
    partial outputs are summed in f32 weighted by exp(lse - the ranks'
    largest lse): the attention over all slots. Returns this rank's
    heads' output (b, 1, nq_loc, hd)."""
    ck, cv, cpos = cache
    nq = q.shape[2]
    q_all = q if nq == cfg.n_heads else collectives.serving_only(
        collectives.all_gather, q, tp.mesh, tp.axis, 2)
    out, lse = K.attention_with_lse(q_all, ck.to(q.dtype), cv.to(q.dtype),
                                    positions.contiguous(), cpos,
                                    window=window)
    lse = lse[..., 0]                          # (b, nq); +inf: no valid key
    lse = lse.masked_fill(torch.isinf(lse), float("-inf"))
    top = collectives.serving_only(collectives.all_reduce, lse, tp.mesh,
                                   tp.axis, "max")
    w = torch.exp(lse - top.masked_fill(torch.isinf(top), 0.0))
    part = torch.where(w[..., None] > 0, out[:, 0].float() * w[..., None],
                       0.0)
    part = collectives.serving_only(
        collectives.all_reduce, torch.cat([part, w[..., None]], dim=-1),
        tp.mesh, tp.axis)
    den = part[..., -1:]
    o = torch.where(den > 0, part[..., :-1] / den.clamp(min=1e-30), 0.0)
    return o[:, None, q0:q0 + nq].to(q.dtype)


def mlp_block(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    tp = tensor_parallel()
    if tp is not None and tp.cut("ff", cfg.d_ff):
        h = tp.enter(h)
    up = shard(h @ p["wi"], "batch", None, "act_ff")
    gate = shard(h @ p["wg"], "batch", None, "act_ff")
    act = F.silu(gate) * up
    out = act @ p["wo"] if tp is None else tp.contract(act, p["wo"], "ff",
                                                       cfg.d_ff)
    return x + shard(out, "batch", None, "act_embed")
